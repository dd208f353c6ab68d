#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py        # from the repository root; needs one CUDA
                                 # card, nvcc, and writes nothing but
                                 # mtp_tpu_torch/_build/

Phases; any failure raises, so the exit code is non-zero:
1. device: the card's name and power limit; TF32 off for the fp32 phases.
2. build: compile the kernels from mtp_tpu_torch/csrc/ (nvcc, sm_90a).
3. kernels: K1 window attention, K2 flash full attention and K3 bilinear
   sampling against their plain PyTorch versions on the card, in fp32 and
   bf16, at the slice's shapes and at edge shapes; median times of both.
4. whole slice: full-width ViT-L+RVSA UperNet logits of one 384² crop on
   the card (kernels) against the same model on the CPU (plain versions).
5. bench geometry: 4 tiles of 512², 384² crops at stride 256, batch 4,
   bf16 autocast, through `SegmentationTask.predict_fn`; launch counts,
   tiles/s and peak memory.
The last lines are the kernels' JSON record, the card, and the result line.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

import torch

from mtp_tpu_torch.ckpt.from_jax import init_weights
from mtp_tpu_torch.config import SlideConfig, vit_l_rvsa
from mtp_tpu_torch.kernels import _build
from mtp_tpu_torch.models.segmentor import Segmentor
from mtp_tpu_torch.models.vit_rvsa import backbone_flops
from mtp_tpu_torch.ops import dcnv3_sample as dcn
from mtp_tpu_torch.ops import fused_attn
from mtp_tpu_torch.tasks.segmentation import SegmentationTask

SEED = 0
NUM_CLASSES = 2      # SpaceNet v1, recipe rvsa-l-upernet-384-mae-mtp-spacenetv1
CHANNELS = 512       # UperNet width
CROP, STRIDE, TILE, BATCH = 384, 256, 512, 4

# tolerances of kernel against plain version on the same inputs:
# fp32 — only the order of the fp32 sums (and expf) differs;
# bf16 — both compute in fp32 from the same bf16 inputs, the outputs may
#        differ by one bf16 rounding (relative 2^-8..2^-7)
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}
# whole slice, card vs CPU, fp32: max |diff| relative to max |logit|
# (24 blocks and the head of reordered fp32 sums)
SLICE_TOL = 2e-3

KERNELS = {
    "window": dict(name="window_attn_fwd", route="cuda",
                   source="mtp_tpu_torch/csrc/window_attn_fwd.cu",
                   replaces="mtp_tpu/ops/pallas_attn.py:662"),
    "flash": dict(name="flash_attn_fwd", route="cuda",
                  source="mtp_tpu_torch/csrc/flash_attn_fwd.cu",
                  replaces="mtp_tpu/ops/pallas_attn.py:421"),
    "bilinear_sample": dict(name="bilinear_sample_fwd", route="cuda",
                            source="mtp_tpu_torch/csrc/bilinear_sample_fwd.cu",
                            replaces="mtp_tpu/ops/dcnv3_pallas.py:635"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def counters() -> dict:
    return {"window": fused_attn.LAUNCHES["window"],
            "flash": fused_attn.LAUNCHES["flash"],
            "bilinear_sample": dcn.LAUNCHES["bilinear_sample"]}


def reset_counters() -> None:
    fused_attn.LAUNCHES.update(window=0, flash=0)
    dcn.LAUNCHES.update(bilinear_sample=0)


def median_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------ phase 1 + 2 --

def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script has no CPU path",
              file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"TF32 off for matmul and cuDNN")
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build(force=True)
    _build.lib()
    log(f"[build] {len(_build.sources())} sources from mtp_tpu_torch/csrc -> "
        f"{_build.LIB.relative_to(_build.PKG.parent)} with "
        f"{' '.join(_build.NVCC_FLAGS)} in {time.perf_counter() - t0:.1f} s")
    for line in _build.PTXAS_LOG:
        log(f"[build] {line}")


# ---------------------------------------------------------------- phase 3 --

def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _randn(shape, g, scale=1.0):
    return (torch.randn(shape, generator=g) * scale).cuda()


def window_case(W, nH, N, D, seed):
    g = _gen(seed)
    q, k, v = (_randn((W, nH, N, D), g) for _ in range(3))
    bias = _randn((W, nH, N, N), g, 0.5)
    scale = D ** -0.5
    return (fused_attn.fused_window_attention,
            fused_attn.fused_window_attention_ref, (q, k, v), (bias, scale))


def flash_case(BH, grid_hw, D, seed, scale=1.0):
    g = _gen(seed)
    N = grid_hw[0] * grid_hw[1]
    q, k, v = (_randn((BH, N, D), g) for _ in range(3))
    q = q * D ** -0.5 if scale == 1.0 else q
    rel_h = _randn((BH, N, grid_hw[0]), g, 0.5)
    rel_w = _randn((BH, N, grid_hw[1]), g, 0.5)
    return (fused_attn.flash_full_attention, fused_attn.flash_full_attention_ref,
            (q, k, v), (rel_h, rel_w, grid_hw, scale))


def sample_case(BG, H, W, C, HWo, P, seed, edge):
    g = _gen(seed)
    img = _randn((BG, H * W, C), g)
    lo, hi = (-2.5, 1.5) if edge else (-1.0, 0.0)  # edge: off every side
    py = (torch.rand((BG, HWo, P), generator=g) * (H - lo + hi) + lo).cuda()
    px = (torch.rand((BG, HWo, P), generator=g) * (W - lo + hi) + lo).cuda()
    if edge:  # a quarter exact integers, a random signed mask
        py[:, ::4] = py[:, ::4].round()
        px[:, ::4] = px[:, ::4].round()
        m = (torch.rand((BG, HWo, P), generator=g) * 2 - 1).cuda()
    else:
        m = torch.ones((BG, HWo, P)).cuda()
    return dcn.dcnv3_sample, dcn.dcnv3_sample_ref, (img,), (py, px, m, H, W)


def phase_kernels() -> dict:
    """Returns {kernel: {max_abs_err, ms, plain_ms}} at the slice shape in
    bf16, the main path's working type."""
    cases = {
        # slice shapes at bs4 384²: 64 windows × 16 heads of 49 tokens, D=64;
        # 4 × 16 heads over the 24×24 grid; K/V sampling of 64 maps of 28²
        "window": [("slice", window_case(64, 16, 49, 64, 1)),
                   ("edge N=25 W=7", window_case(7, 3, 25, 48, 2))],
        "flash": [("slice", flash_case(64, (24, 24), 64, 3)),
                  ("edge 20x33", flash_case(4, (20, 33), 64, 4, scale=0.125))],
        "bilinear_sample": [
            ("slice", sample_case(64, 28, 28, 64, 784, 1, 5, edge=False)),
            ("edge P=9", sample_case(6, 13, 17, 32, 200, 9, 6, edge=True))],
    }
    record = {}
    for kname, kcases in cases.items():
        for label, (kernel, plain, xs, rest) in kcases:
            for dtype in (torch.float32, torch.bfloat16):
                args = tuple(x.to(dtype) for x in xs) + rest
                got, ref = kernel(*args), plain(*args)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{kname} {label}: non-finite output")
                err = (got.float() - ref.float()).abs().max().item()
                atol, rtol = TOL[dtype]
                torch.testing.assert_close(got.float(), ref.float(),
                                           atol=atol, rtol=rtol)
                ms = median_ms(lambda: kernel(*args))
                plain_ms = median_ms(lambda: plain(*args))
                log(f"[kernel] {kname:15s} {label:14s} {str(dtype)[6:]:8s} "
                    f"shape {tuple(xs[0].shape)} max_abs_err {err:.3e} "
                    f"(atol {atol} rtol {rtol}) kernel {ms:.4f} ms  "
                    f"plain {plain_ms:.4f} ms")
                if label == "slice" and dtype == torch.bfloat16:
                    record[kname] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return record


# ---------------------------------------------------------------- phase 4 --

def build_model() -> Segmentor:
    """Full-width ViT-L+RVSA UperNet at 384² with seeded random weights."""
    cfg = vit_l_rvsa(CROP, drop_path_rate=0.3, out_indices=(7, 11, 15, 23))
    model = Segmentor(cfg, NUM_CLASSES, CHANNELS, input_hw=(CROP, CROP))
    return init_weights(model, _gen(SEED)).eval()


@torch.no_grad()
def phase_slice_numerics(model_cpu: Segmentor) -> None:
    x = torch.randn((1, CROP, CROP, 3), generator=_gen(SEED + 1))
    t0 = time.perf_counter()
    ref = model_cpu.predict(x)
    t_cpu = time.perf_counter() - t0
    model_gpu = copy.deepcopy(model_cpu).cuda()
    reset_counters()
    got = model_gpu.predict(x.cuda()).cpu()
    launched = counters()
    if not all(launched.values()):
        raise AssertionError(f"a kernel did not run in the fp32 slice: {launched}")
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite logits on the card")
    abs_err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    rel = abs_err / scale
    log(f"[slice] fp32 logits {tuple(got.shape)} card vs CPU: max_abs_err "
        f"{abs_err:.3e}, max |logit| {scale:.3e}, normalised {rel:.3e} "
        f"(tol {SLICE_TOL}); CPU forward {t_cpu:.1f} s; launches {launched}")
    if not rel <= SLICE_TOL:
        raise AssertionError(f"card logits disagree with the CPU: {rel:.3e}")


# ---------------------------------------------------------------- phase 5 --

@torch.no_grad()
def phase_bench(model_cpu: Segmentor, card: str) -> dict:
    model = copy.deepcopy(model_cpu).cuda()
    slide = SlideConfig(crop=CROP, stride=STRIDE)
    task = SegmentationTask(model, NUM_CLASSES, slide)
    images = torch.randn((BATCH, TILE, TILE, 3), generator=_gen(SEED + 2)).cuda()
    predict = task.predict_fn()
    n_crops = 4  # 512² tile, 384² crop, stride 256
    autocast = lambda: torch.autocast("cuda", dtype=torch.bfloat16)

    torch.cuda.synchronize()
    reset_counters()
    with autocast():
        pred = predict(images)
    torch.cuda.synchronize()
    launched = counters()
    want = {"window": 20 * n_crops, "flash": 4 * n_crops,
            "bilinear_sample": 40 * n_crops}
    log(f"[bench] launches in one predict ({n_crops} crops): {launched}, "
        f"expected {want} (per crop forward K1=20, K2=4, K3=40)")
    if launched != want:
        raise AssertionError(f"launch counts {launched} != {want}")
    if pred.shape != (BATCH, TILE, TILE) or not (
            (pred >= 0) & (pred < NUM_CLASSES)).all():
        raise AssertionError(f"bad predictions {tuple(pred.shape)}")

    with autocast():
        logits = task.slide_logits(images)
    if logits.shape != (BATCH, TILE, TILE, NUM_CLASSES) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"bad slide logits {tuple(logits.shape)}")
    agree = (logits.argmax(-1) == pred).float().mean().item()
    logits32 = task.slide_logits(images)
    drift = ((logits - logits32).abs().max() / logits32.abs().max()).item()
    log(f"[bench] bf16 slide logits {tuple(logits.shape)} finite; argmax "
        f"agreement with predict {agree:.6f}; bf16 vs fp32 normalised max "
        f"diff {drift:.3e}")
    if agree < 0.999 or drift > 0.1:
        raise AssertionError(f"bf16 slide path off: agree {agree}, drift {drift}")

    for _ in range(2):
        with autocast():
            predict(images)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters, times = 10, []
    for _ in range(iters):
        t0 = time.perf_counter()
        with autocast():
            predict(images)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    per = statistics.median(times)
    tiles_s = BATCH / per
    flops = backbone_flops(model.backbone.cfg, (CROP, CROP)) * BATCH * n_crops
    log(f"[bench] ViT-L+RVSA UperNet slide {TILE}² tiles, crop {CROP} stride "
        f"{STRIDE}, batch {BATCH}, bf16 autocast: median {per * 1e3:.2f} ms per "
        f"predict over {iters} (min {min(times) * 1e3:.2f}, max "
        f"{max(times) * 1e3:.2f}), {tiles_s:.3f} tiles/s, backbone "
        f"{flops / per / 1e12:.2f} TFLOP/s, peak memory "
        f"{peak / 2 ** 30:.3f} GiB | card {card}")
    return launched


def main() -> None:
    card = phase_device()
    phase_build()
    record = phase_kernels()
    model_cpu = build_model()
    phase_slice_numerics(model_cpu)
    launched = phase_bench(model_cpu, card)
    kernels = [dict(KERNELS[k], launches=launched[k], **record[k])
               for k in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
