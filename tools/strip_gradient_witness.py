#!/usr/bin/env python3
"""Which of the card and the CPU is nearer the exact fp32 gradients of
`chip_smoke.py` phase 14 (the ViT recipe at a 2080×112 strip, batch 2,
dropout and drop-path on, identity RVSA sampling), of phase 17 (the ViT-L
change detector, one pair of 256², train-mode BatchNorm) or of phase 19
(the ViT-L or the InternImage-XL Faster R-CNN at 2 images of an 800×128
strip).

    python3 tools/strip_gradient_witness.py [--path rvsa_hr|cd_vit|det_vit|det_xl]  # one card, ~2 min

Runs the phase's loss.backward() three times on the same weights, batch and
masks: fp32 on the card (the kernels), fp32 on the CPU (the plain
versions), and a float64 copy of the model on the CPU, which evaluates the
same function in float64 (`mtp_tpu_torch/ops/precision.py`; `NoDowncast`
stops the run if any op rounds a float64 tensor to fp32).  Prints the
phase's card-vs-CPU reading, then the card's and the CPU's fp32 gradients
against the float64 ones, per parameter ‖g − g64‖/‖g64‖, and on how many
parameters the card is the nearer; and how many of the bilinear taps' fp32
coordinates lie across an integer from the float64 run's (where K6 and its
plain version take the other one-sided derivative) and how many ReLU
inputs lie across 0 from it.  For det_* every run takes the proposals and
the max-pool picks of the CPU's fp32 forward, as phase 19 does;
`--own-picks` lets each run pick its own and counts the max-pool windows
that pick another element than the float64 run's.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from unittest import mock  # noqa: E402

import chip_smoke  # noqa: E402
from mtp_tpu_torch.ops import dcnv3_sample  # noqa: E402
from mtp_tpu_torch.ops.precision import NoDowncast  # noqa: E402


SAMPLING = ".attn.sampling_"  # RVSA's sampling regressors


def _distances(path, got: dict, ref: dict) -> dict:
    """name → ‖got − ref‖/‖ref‖ of the backbone's parameters."""
    return {n: float((got[n].double() - r).norm() / r.norm().clamp(min=1e-300))
            for n, r in ref.items() if not n.startswith(path.head_prefixes)}


def _summary(d: dict) -> str:
    worst = max(d, key=d.get)
    return (f"{len(d)} parameters, min / median / max {min(d.values()):.3e} / "
            f"{statistics.median(d.values()):.3e} / {d[worst]:.3e} at {worst}")


def _groups(d: dict) -> dict:
    """The sampling regressors apart: their gradients sum the one-sided
    derivatives of bilinear taps on integer coordinates, and a float64
    coordinate may fall on the other side of an integer than the fp32 one,
    a jump rather than a rounding."""
    groups = {"regressors": {n: x for n, x in d.items() if SAMPLING in n},
              "the rest": {n: x for n, x in d.items() if SAMPLING not in n}}
    return {grp: x for grp, x in groups.items() if x}  # InternImage has no RVSA


@contextlib.contextmanager
def _recorded_taps(into: list):
    """Appends the (py, px) of every K3 call (their plain version's too),
    in float64 on the CPU, to `into`."""
    fwd = dcnv3_sample._sample_fwd

    def record(img, py, px, m, H, W):
        into.append(tuple(t.detach().double().cpu() for t in (py, px)))
        return fwd(img, py, px, m, H, W)

    with mock.patch.object(dcnv3_sample, "_sample_fwd", record):
        yield


@contextlib.contextmanager
def _recorded_relus(into: list):
    """Appends where every F.relu's input is positive (on the CPU) to
    `into`."""
    relu = torch.nn.functional.relu

    def record(x, *args, **kwargs):
        into.append((x > 0).cpu())
        return relu(x, *args, **kwargs)

    with mock.patch.object(torch.nn.functional, "relu", record):
        yield


def _flips(relus: list, ref: list) -> str:
    """How many ReLU inputs lie on the other side of 0 than `ref`'s (the
    gradient passes there on one side only)."""
    other = sum(int((a != b).sum()) for a, b in zip(relus, ref))
    return f"{other} of {sum(b.numel() for b in ref)} ReLU inputs across 0"


def _picks(pools: dict, ref: dict) -> str:
    """How many max-pool windows pick another element than `ref`'s (the
    gradient goes to another input there)."""
    other = sum(int((pools[k] != b).sum()) for k, b in ref.items())
    return f"{other} of {sum(b.numel() for b in ref.values())} max-pool windows pick another element"


def _sides(taps: list, ref: list) -> str:
    """How many taps lie across an integer from `ref`'s (another floor of
    py or px, so another one-sided derivative in K6), and the nearest
    integer's distance among them."""
    crossed, near = 0, []
    for got, want in zip(taps, ref):
        for a, b in zip(got, want):
            across = torch.floor(a) != torch.floor(b)
            crossed += int(across.sum())
            near += (b[across] - b[across].round()).abs().tolist()
    return (f"{crossed} of {sum(t[0].numel() for t in ref)} taps across an integer"
            + (f" (float64 coordinate at most {max(near):.2e} from it)" if near else ""))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=("rvsa_hr", "cd_vit", "det_vit", "det_xl"),
                    default="rvsa_hr")
    ap.add_argument("--own-picks", action="store_true",
                    help="det_vit, det_xl: every run takes its own max-pool picks (phase 19 "
                         "gives all the CPU's), and their differences are counted")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    chip_smoke._tf32(False)  # fp32 matmuls and convolutions, as the phases
    pools = {}
    fixed = lambda what: contextlib.nullcontext()
    if args.path in chip_smoke.DET_PATHS:
        path = chip_smoke.DET_PATHS[args.path]
        task_cls = chip_smoke.DetectionTask
        model = chip_smoke.build_det_model(path, chip_smoke.DET_STRIP)
        _, batch, props, picks = chip_smoke.det_grad_inputs(path, model)

        def fixed(what):  # phase 19's proposals, and its max-pool picks
            stack = contextlib.ExitStack()
            stack.enter_context(chip_smoke.fixed_proposals(props))
            stack.enter_context(chip_smoke.recorded_pool_picks(pools.setdefault(what, {}))
                                if args.own_picks else chip_smoke.fixed_pool_picks(picks))
            return stack
    elif args.path == "cd_vit":
        path = chip_smoke.TASK_PATHS["cd_vit"]
        task_cls = chip_smoke.ChangeDetectionTask
        batch = {k: torch.from_numpy(v) for k, v in chip_smoke.task_batch(
            path, 1, chip_smoke.SEED + 3).items()}
        model = chip_smoke.build_task_model(path)
    else:
        path = chip_smoke.PATHS["rvsa_hr"]
        task_cls = chip_smoke.SegmentationTask
        batch = {k: torch.from_numpy(v) for k, v in chip_smoke.synthetic_batch(
            path.grad_batch, path.cpu_hw, path.recipe.num_classes,
            chip_smoke.SEED + 3).items()}
        model = chip_smoke.build_model(path, path.cpu_hw)
        with torch.no_grad():  # identity sampling, as phase 14
            for name, p in model.named_parameters():
                if SAMPLING in name:
                    p.zero_()
    recipe = path.recipe
    cfg = dataclasses.replace(recipe, backbone=dataclasses.replace(
        recipe.backbone, dtype="float32"))
    model64 = copy.deepcopy(model).double()
    model_gpu = copy.deepcopy(model).cuda()
    batch64 = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    runs, taps, relus = {}, {}, {}
    for what, m, b, device in (
            ("card", model_gpu, batch, "cuda"), ("cpu", model, batch, "cpu"),
            ("float64", model64, batch64, "cpu")):
        t0 = time.perf_counter()
        mode = NoDowncast() if what == "float64" else None
        taps[what], relus[what] = [], []
        with fixed(what), _recorded_taps(taps[what]), _recorded_relus(relus[what]), \
                mode if mode is not None else contextlib.nullcontext():
            runs[what] = chip_smoke._loss_and_grads(cfg, m, b, device,
                                                    path.grad_stochastic, task_cls)
        print(f"[witness] {what}: loss {runs[what][0]:.9f} forward+backward "
              f"{time.perf_counter() - t0:.1f} s"
              + (f", {mode.calls} torch calls, none rounded float64" if mode else ""))
    if any(g.dtype != torch.float64 for g in runs["float64"][1].values()):
        raise AssertionError("the float64 run produced gradients of another dtype")
    _, summary = chip_smoke._grad_verdict(path, runs["cpu"], runs["card"])
    print(f"[witness] {args.path}: card vs CPU (the phase's reading): {summary}")
    g64 = runs["float64"][1]
    card, cpu = (_distances(path, runs[w][1], g64) for w in ("card", "cpu"))
    loss64 = runs["float64"][0]
    for what, d in (("card", card), ("cpu", cpu)):
        print(f"[witness] {what} fp32 vs float64: {_sides(taps[what], taps['float64'])}; "
              + (f"{_picks(pools[what], pools['float64'])}; " if pools else "")
              + f"{_flips(relus[what], relus['float64'])}; "
              f"loss rel {abs(runs[what][0] - loss64) / abs(loss64):.3e}; backbone "
              f"‖g − g64‖/‖g64‖: " + "; ".join(
                  f"{grp} {_summary(x)}" for grp, x in _groups(d).items()))
    for grp, names in _groups(card).items():
        nearer = sum(card[n] < cpu[n] for n in names)
        ratio = statistics.median(card[n] / cpu[n] for n in names if cpu[n] > 0)
        print(f"[witness] backbone {grp}: the card is nearer float64 on {nearer} of "
              f"{len(names)} parameters; median of card/CPU distances {ratio:.3f}")
    card_name = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    prec = (f"; fp32 matmul precision {torch.backends.cuda.matmul.fp32_precision!r}, "
            f"cuDNN {torch.backends.cudnn.conv.fp32_precision!r}"
            if hasattr(torch.backends.cuda.matmul, "fp32_precision") else "")
    print(f"[witness] card {card_name} | torch {torch.__version__}{prec}")


if __name__ == "__main__":
    main()
