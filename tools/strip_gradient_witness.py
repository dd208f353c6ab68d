#!/usr/bin/env python3
"""Which of the card and the CPU is nearer the exact fp32 gradients of
`chip_smoke.py` phase 14: the ViT recipe at a 2080×112 strip, batch 2,
dropout and drop-path on, identity RVSA sampling.

    python3 tools/strip_gradient_witness.py      # one card, ~2 min

Runs phase 14's loss.backward() three times on the same weights, batch and
masks: fp32 on the card (the kernels), fp32 on the CPU (the plain
versions), and a float64 copy of the model on the CPU, which evaluates the
same function in float64 (`mtp_tpu_torch/ops/precision.py`; `NoDowncast`
stops the run if any op rounds a float64 tensor to fp32).  Prints phase
14's card-vs-CPU reading, then the card's and the CPU's fp32 gradients
against the float64 ones, per parameter ‖g − g64‖/‖g64‖, and on how many
parameters the card is the nearer.
"""

from __future__ import annotations

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

import chip_smoke  # noqa: E402
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
    return {"regressors": {n: x for n, x in d.items() if SAMPLING in n},
            "the rest": {n: x for n, x in d.items() if SAMPLING not in n}}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    chip_smoke._tf32(False)  # fp32 matmuls and convolutions, as phase 14
    path = chip_smoke.PATHS["rvsa_hr"]
    recipe = path.recipe
    cfg = dataclasses.replace(recipe, backbone=dataclasses.replace(
        recipe.backbone, dtype="float32"))
    batch = {k: torch.from_numpy(v) for k, v in chip_smoke.synthetic_batch(
        path.grad_batch, path.cpu_hw, recipe.num_classes, chip_smoke.SEED + 3).items()}
    model = chip_smoke.build_model(path, path.cpu_hw)
    with torch.no_grad():  # identity sampling, as phase 14
        for name, p in model.named_parameters():
            if SAMPLING in name:
                p.zero_()
    model64 = copy.deepcopy(model).double()
    model_gpu = copy.deepcopy(model).cuda()
    runs = {}
    for what, m, b, device in (
            ("card", model_gpu, batch, "cuda"), ("cpu", model, batch, "cpu"),
            ("float64", model64, dict(batch, image=batch["image"].double()), "cpu")):
        t0 = time.perf_counter()
        mode = NoDowncast() if what == "float64" else None
        with mode if mode is not None else contextlib.nullcontext():
            runs[what] = chip_smoke._loss_and_grads(cfg, m, b, device,
                                                    path.grad_stochastic)
        print(f"[witness] {what}: loss {runs[what][0]:.9f} forward+backward "
              f"{time.perf_counter() - t0:.1f} s"
              + (f", {mode.calls} torch calls, none rounded float64" if mode else ""))
    if any(g.dtype != torch.float64 for g in runs["float64"][1].values()):
        raise AssertionError("the float64 run produced gradients of another dtype")
    _, summary = chip_smoke._grad_verdict(path, runs["cpu"], runs["card"])
    print(f"[witness] card vs CPU (phase 14's reading): {summary}")
    g64 = runs["float64"][1]
    card, cpu = (_distances(path, runs[w][1], g64) for w in ("card", "cpu"))
    loss64 = runs["float64"][0]
    for what, d in (("card", card), ("cpu", cpu)):
        print(f"[witness] {what} fp32 vs float64: loss rel "
              f"{abs(runs[what][0] - loss64) / abs(loss64):.3e}; backbone "
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
    print(f"[witness] card {card_name} | torch {torch.__version__}")


if __name__ == "__main__":
    main()
