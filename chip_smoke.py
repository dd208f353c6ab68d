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
3b. backward kernels: K4, K5 and K6 likewise, at the train step's shapes.
4. whole slice: full-width ViT-L+RVSA UperNet logits of one 384² crop on
   the card (kernels) against the same model on the CPU (plain versions).
5. serving path, bench geometry: 4 tiles of 512², 384² crops at stride
   256, batch 4, bf16 autocast, through `SegmentationTask.predict_fn`;
   launch counts, tiles/s and peak memory.
6. full-width gradients: one fp32 loss.backward() of the recipe's model
   (train-mode BatchNorm, no dropout or drop-path) at batch 2 of 384² on
   the card (kernels) against the CPU (plain versions).
7. training path, the recipe's train step (rvsa-l-upernet-384-mae-mtp-
   spacenetv1: batch 8 of 384², bf16 autocast, dropout and drop-path on)
   through `SegmentationTask.init_state` → `fit` → `evaluate`: launch counts
   per step, finite loss and grad norm, ms/step, images/s, data_time and
   peak memory, and a fixed-batch sanity run whose loss must fall.
The last lines are the kernels' JSON record, the card, and the result line.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from mtp_tpu_torch.ckpt.from_jax import init_weights
from mtp_tpu_torch.config import ScheduleConfig, rvsa_l_upernet_384_spacenetv1
from mtp_tpu_torch.kernels import _build
from mtp_tpu_torch.models.segmentor import Segmentor
from mtp_tpu_torch.models.vit_rvsa import backbone_flops
from mtp_tpu_torch.ops import dcnv3_sample as dcn
from mtp_tpu_torch.ops import fused_attn
from mtp_tpu_torch.tasks.segmentation import SegmentationTask

SEED = 0
# the recipe: ViT-L+RVSA → UperNet (512 channels), 2 classes (SpaceNet v1),
# 384² crops, slide eval at stride 256, batch 8, AdamW 6e-5
RECIPE = rvsa_l_upernet_384_spacenetv1()
NUM_CLASSES = RECIPE.num_classes
CROP = RECIPE.backbone.img_size
TILE, BATCH = 512, 4            # serving path: 4 tiles of 512², 4 crops each
TRAIN_BATCH = RECIPE.train.batch_size
GRAD_BATCH = 2                  # phase 6
TRAIN_STEPS, WARMUP_STEPS, SANITY_STEPS = 12, 2, 10

# tolerances of kernel against plain version on the same inputs:
# fp32 — only the order of the fp32 sums (and expf) differs, and for K6's
#        image gradient the order of its fp32 atomic adds;
# bf16 — both compute in fp32 from the same bf16 inputs, the bf16 outputs
#        may differ by one bf16 rounding (relative 2^-8..2^-7)
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}
# whole slice, card vs CPU, fp32: max |diff| relative to max |logit|
# (24 blocks and the head of reordered fp32 sums)
SLICE_TOL = 2e-3
# full-width gradients, card vs CPU, fp32: the loss to 1e-5 relative; each
# parameter's gradient g to ‖Δg‖ <= rtol·‖g‖ + GRAD_ATOL·‖g_all‖, with
# rtol GRAD_RTOL["blocks"] for the transformer (patch embed and the 24
# blocks, where the kernels' gradients flow) and GRAD_RTOL["convs"] for the
# simple-FPN deconvolutions and the UperNet head.  Those are convolutions,
# cuDNN on the card and oneDNN on the CPU, and their weight gradients sit
# behind train-mode BatchNorm, whose backward removes each channel's mean:
# a weight gradient is then a sum over 18432 positions in which the
# features' mean cancels, and the two libraries' orders of summation differ
# by ~1e-3 of the result.  The absolute floor, against the norm of all
# gradients, is for gradients that are zero or near zero in exact
# arithmetic and whose computed values are rounding residue: conv biases
# right before train-mode BatchNorm, and the PSP pool-1 branch, whose
# BatchNorm at batch 2 sees 2 values per channel.
LOSS_RTOL, GRAD_ATOL = 1e-5, 1e-5
GRAD_RTOL = {"blocks": 1e-3, "convs": 1e-2}


def grad_group(name: str) -> str:
    return "convs" if name.startswith(("backbone.fpn", "decode_head.")) else "blocks"


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
    "window_bwd": dict(name="window_attn_bwd", route="cuda",
                       source="mtp_tpu_torch/csrc/window_attn_bwd.cu",
                       replaces="mtp_tpu/ops/pallas_attn.py:327"),
    "flash_bwd": dict(name="flash_attn_bwd", route="cuda",
                      source="mtp_tpu_torch/csrc/flash_attn_bwd.cu",
                      replaces="mtp_tpu/ops/pallas_attn.py:594"),
    "bilinear_sample_bwd": dict(name="bilinear_sample_bwd", route="cuda",
                                source="mtp_tpu_torch/csrc/bilinear_sample_bwd.cu",
                                replaces="mtp_tpu/ops/dcnv3_pallas.py:678"),
}
# launches per forward of one crop batch (serving) and per train step
PER_FORWARD = {"window": 20, "flash": 4, "bilinear_sample": 40}
PER_STEP = dict(PER_FORWARD, window_bwd=20, flash_bwd=4, bilinear_sample_bwd=40)


def log(msg: str) -> None:
    print(msg, flush=True)


def counters() -> dict:
    return {**fused_attn.LAUNCHES, **dcn.LAUNCHES}


def reset_counters() -> None:
    for launches in (fused_attn.LAUNCHES, dcn.LAUNCHES):
        launches.update(dict.fromkeys(launches, 0))


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
    log(f"[build] {len(_build.sources())} sources from mtp_tpu_torch/csrc, one "
        f"nvcc each in parallel, linked -> "
        f"{_build.LIB.relative_to(_build.PKG.parent)}; flags "
        f"{' '.join(_build.NVCC_FLAGS)}; {time.perf_counter() - t0:.1f} s")
    for line in _build.PTXAS_LOG:
        log(f"[build] {line}")


# ---------------------------------------------------------------- phase 3 --

def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _randn(shape, g, scale=1.0):
    return (torch.randn(shape, generator=g) * scale).cuda()


def window_case(W, nH, N, D, seed, bwd=False):
    """K1 (or K4 with bwd) inputs; returns (kernel, plain, args(dtype))."""
    g = _gen(seed)
    q, k, v, dout = (_randn((W, nH, N, D), g) for _ in range(4))
    bias = _randn((W, nH, N, N), g, 0.5)
    scale = D ** -0.5
    if bwd:
        return (fused_attn.fused_window_attention_bwd,
                fused_attn.fused_window_attention_bwd_ref,
                lambda dt: (q.to(dt), k.to(dt), v.to(dt), bias, dout.to(dt), scale))
    return (fused_attn.fused_window_attention, fused_attn.fused_window_attention_ref,
            lambda dt: (q.to(dt), k.to(dt), v.to(dt), bias, scale))


def flash_case(BH, grid_hw, D, seed, scale=1.0, bwd=False):
    """K2 (or K5 with bwd) inputs; returns (kernel, plain, args(dtype))."""
    g = _gen(seed)
    N = grid_hw[0] * grid_hw[1]
    q, k, v, dout = (_randn((BH, N, D), g) for _ in range(4))
    q = q * D ** -0.5 if scale == 1.0 else q
    rel_h = _randn((BH, N, grid_hw[0]), g, 0.5)
    rel_w = _randn((BH, N, grid_hw[1]), g, 0.5)
    if bwd:
        return (fused_attn.flash_full_attention_bwd,
                fused_attn.flash_full_attention_bwd_ref,
                lambda dt: (q.to(dt), k.to(dt), v.to(dt), rel_h, rel_w, dout.to(dt),
                            grid_hw, scale))
    return (fused_attn.flash_full_attention, fused_attn.flash_full_attention_ref,
            lambda dt: (q.to(dt), k.to(dt), v.to(dt), rel_h, rel_w, grid_hw, scale))


def sample_case(BG, H, W, C, HWo, P, seed, edge, bwd=False):
    """K3 (or K6 with bwd) inputs; returns (kernel, plain, args(dtype))."""
    g = _gen(seed)
    img = _randn((BG, H * W, C), g)
    cot = _randn((BG, HWo, C), g)
    lo, hi = (-2.5, 1.5) if edge else (-1.0, 0.0)  # edge: off every side
    py = (torch.rand((BG, HWo, P), generator=g) * (H - lo + hi) + lo).cuda()
    px = (torch.rand((BG, HWo, P), generator=g) * (W - lo + hi) + lo).cuda()
    if edge:  # a quarter exact integers, a random signed mask
        py[:, ::4] = py[:, ::4].round()
        px[:, ::4] = px[:, ::4].round()
        m = (torch.rand((BG, HWo, P), generator=g) * 2 - 1).cuda()
    else:
        m = torch.ones((BG, HWo, P)).cuda()
    if bwd:
        return (dcn.dcnv3_sample_bwd, dcn.dcnv3_sample_bwd_ref,
                lambda dt: (img.to(dt), py, px, m, cot.to(dt), H, W))
    return (dcn.dcnv3_sample, dcn.dcnv3_sample_ref,
            lambda dt: (img.to(dt), py, px, m, H, W))


def check_kernels(cases: dict) -> dict:
    """Each case's kernel against its plain version on the same inputs, in
    fp32 and bf16, output by output; returns {kernel: {max_abs_err, ms,
    plain_ms}} at the slice shape in bf16, the main path's working type."""
    record = {}
    for kname, kcases in cases.items():
        for label, (kernel, plain, make_args) in kcases:
            for dtype in (torch.float32, torch.bfloat16):
                args = make_args(dtype)
                with torch.no_grad():
                    got, ref = kernel(*args), plain(*args)
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                atol, rtol = TOL[dtype]
                errs = []
                for i, (a, b) in enumerate(zip(got, ref)):
                    if a.dtype != b.dtype or a.shape != b.shape:
                        raise AssertionError(f"{kname} {label} output {i}: "
                                             f"{a.dtype}{tuple(a.shape)} vs "
                                             f"{b.dtype}{tuple(b.shape)}")
                    if not torch.isfinite(a).all():
                        raise AssertionError(f"{kname} {label}: non-finite output {i}")
                    errs.append((a.float() - b.float()).abs().max().item())
                    torch.testing.assert_close(a.float(), b.float(), atol=atol,
                                               rtol=rtol, msg=lambda m: f"{kname} "
                                               f"{label} {dtype} output {i}: {m}")
                with torch.no_grad():
                    ms = median_ms(lambda: kernel(*args))
                    plain_ms = median_ms(lambda: plain(*args))
                log(f"[kernel] {kname:19s} {label:14s} {str(dtype)[6:]:8s} "
                    f"shape {tuple(args[0].shape)} max_abs_err "
                    f"{' '.join(f'{e:.3e}' for e in errs)} (atol {atol} rtol "
                    f"{rtol}) kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
                if label == "slice" and dtype == torch.bfloat16:
                    record[kname] = dict(max_abs_err=max(errs), ms=ms,
                                         plain_ms=plain_ms)
    return record


def phase_kernels() -> dict:
    """Phase 3: the forward kernels K1-K3 (the shapes of the slide geometry,
    batch 4)."""
    return check_kernels({
        # slice shapes at bs4 384²: 64 windows × 16 heads of 49 tokens, D=64;
        # 4 × 16 heads over the 24×24 grid; K/V sampling of 64 maps of 28²
        "window": [("slice", window_case(64, 16, 49, 64, 1)),
                   ("edge N=25 W=7", window_case(7, 3, 25, 48, 2))],
        "flash": [("slice", flash_case(64, (24, 24), 64, 3)),
                  ("edge 20x33", flash_case(4, (20, 33), 64, 4, scale=0.125))],
        "bilinear_sample": [
            ("slice", sample_case(64, 28, 28, 64, 784, 1, 5, edge=False)),
            ("edge P=9", sample_case(6, 13, 17, 32, 200, 9, 6, edge=True))],
    })


def phase_backward_kernels() -> dict:
    """Phase 3b: the backward kernels K4-K6 at the train step's shapes
    (batch 8 of 384²: 128 windows × 16 heads, 8 × 16 heads over the 24×24
    grid, K/V sampling of 128 maps of 28²) and at edge shapes."""
    return check_kernels({
        "window_bwd": [("slice", window_case(128, 16, 49, 64, 11, bwd=True)),
                       ("edge N=25 W=7", window_case(7, 3, 25, 48, 12, bwd=True))],
        "flash_bwd": [("slice", flash_case(128, (24, 24), 64, 13, bwd=True)),
                      ("edge 20x33", flash_case(4, (20, 33), 64, 14, scale=0.125,
                                                bwd=True))],
        "bilinear_sample_bwd": [
            ("slice", sample_case(128, 28, 28, 64, 784, 1, 15, edge=False, bwd=True)),
            ("edge P=9", sample_case(6, 13, 17, 32, 200, 9, 16, edge=True, bwd=True))],
    })


# ---------------------------------------------------------------- phase 4 --

def build_model() -> Segmentor:
    """The recipe's full-width ViT-L+RVSA UperNet at 384², seeded random
    weights, on the CPU."""
    model = Segmentor(RECIPE.backbone, NUM_CLASSES, input_hw=(CROP, CROP))
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
    if not all(launched[k] for k in PER_FORWARD):
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
    task = SegmentationTask(RECIPE, model=model, device="cuda")
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
    want = {k: n * n_crops for k, n in PER_FORWARD.items()}
    want.update(window_bwd=0, flash_bwd=0, bilinear_sample_bwd=0)
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
        f"{RECIPE.slide.stride}, batch {BATCH}, bf16 autocast: median "
        f"{per * 1e3:.2f} ms per predict over {iters} (min {min(times) * 1e3:.2f}, "
        f"max {max(times) * 1e3:.2f}), {tiles_s:.3f} tiles/s, backbone "
        f"{flops / per / 1e12:.2f} TFLOP/s, peak memory "
        f"{peak / 2 ** 30:.3f} GiB | card {card}")
    return launched


# ---------------------------------------------------------------- phase 6 --

def synthetic_batch(n: int, seed: int) -> dict:
    """n seeded 384² images and labels {0, 1} that depend on the image (a
    smoothed channel's sign, so the sanity run has something to learn), with
    a band of ignored pixels (255)."""
    rng = np.random.default_rng(seed)
    image = rng.standard_normal((n, CROP, CROP, 3)).astype(np.float32)
    coarse = image[..., 0].reshape(n, CROP // 32, 32, CROP // 32, 32).mean((2, 4))
    label = np.repeat(np.repeat(coarse > 0, 32, 1), 32, 2).astype(np.int64)
    label[:, :, :16] = 255
    return {"image": image, "label": label}


def phase_gradients(model_cpu: Segmentor) -> None:
    """One fp32 loss.backward() of the recipe's model on the card and on the
    CPU, same weights and batch: train-mode BatchNorm, deterministic."""
    cfg = dataclasses.replace(RECIPE, backbone=dataclasses.replace(
        RECIPE.backbone, dtype="float32"))
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(GRAD_BATCH, SEED + 3).items()}
    model_gpu = copy.deepcopy(model_cpu).cuda()
    losses, grads = {}, {}
    for device, model in (("cpu", model_cpu), ("cuda", model_gpu)):
        task = SegmentationTask(cfg, model=model, device=device)
        reset_counters()
        t0 = time.perf_counter()
        loss, _ = task.loss_fn(model, {k: v.to(device) for k, v in batch.items()},
                               None, deterministic=True)
        loss.backward()
        if device == "cuda":
            torch.cuda.synchronize()
            launched = counters()
        losses[device] = loss.item()
        grads[device] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        log(f"[grads] {device}: loss {losses[device]:.6f} forward+backward "
            f"{time.perf_counter() - t0:.1f} s")
    if launched != PER_STEP:
        raise AssertionError(f"launch counts {launched} != {PER_STEP}")
    g_all = math.sqrt(sum(float(g.square().sum()) for g in grads["cpu"].values()))
    worst = {group: (0.0, "") for group in GRAD_RTOL}
    bad = []
    for name, ref in grads["cpu"].items():
        group = grad_group(name)
        diff, norm = float((grads["cuda"][name] - ref).norm()), float(ref.norm())
        worst[group] = max(worst[group], (diff / max(norm, 1e-30), name))
        if not diff <= GRAD_RTOL[group] * norm + GRAD_ATOL * g_all:
            bad.append((name, diff, norm))
    loss_rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    global_rel = math.sqrt(sum(float((grads["cuda"][n] - g).square().sum())
                               for n, g in grads["cpu"].items())) / g_all
    log(f"[grads] fp32 batch {GRAD_BATCH} of {CROP}², card vs CPU: loss rel "
        f"{loss_rel:.3e} (tol {LOSS_RTOL}); all {len(grads['cpu'])} gradients "
        f"‖Δ‖/‖g‖ {global_rel:.3e} (‖g_all‖ {g_all:.3e}); max over parameters "
        f"of ‖Δg‖/‖g‖: " + ", ".join(
            f"{group} {r:.3e} at {n}" for group, (r, n) in worst.items())
        + f"; tolerance per parameter rtol·‖g‖ + {GRAD_ATOL}·‖g_all‖, rtol "
        f"{GRAD_RTOL}; launches {launched}")
    if not loss_rel <= LOSS_RTOL or bad:
        raise AssertionError(f"card gradients disagree with the CPU: loss rel "
                             f"{loss_rel:.3e}, outside tolerance: {bad[:8]}")


# ---------------------------------------------------------------- phase 7 --

def cycle(batches):
    while True:
        yield from batches


def phase_train(card: str) -> dict:
    """The recipe's train step through the task's entry points."""
    task = SegmentationTask(RECIPE, device="cuda")
    t0 = time.perf_counter()
    state = task.init_state(_gen(SEED))
    log(f"[train] init_state (CPU init, copy to the card, optimizer) "
        f"{time.perf_counter() - t0:.1f} s; recipe lr {RECIPE.train.optimizer.lr} wd {RECIPE.train.optimizer.weight_decay} "
        f"layer decay {RECIPE.train.optimizer.layer_decay} clip "
        f"{RECIPE.train.optimizer.clip_norm}, schedule {RECIPE.train.schedule}")
    batches = [synthetic_batch(TRAIN_BATCH, SEED + 10 + i) for i in range(4)]
    logs = []
    log_fn = lambda i, m: logs.append(m)

    torch.cuda.synchronize()
    reset_counters()
    state, m = task.fit(state, cycle(batches), 1, log_every=1, log_fn=log_fn)
    torch.cuda.synchronize()
    launched = counters()
    log(f"[train] launches in one train step: {launched}, expected {PER_STEP}; "
        f"metrics {m}")
    if launched != PER_STEP:
        raise AssertionError(f"launch counts {launched} != {PER_STEP}")

    state, _ = task.fit(state, cycle(batches), WARMUP_STEPS, log_every=1,
                        log_fn=log_fn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logs.clear()
    state, _ = task.fit(state, cycle(batches), TRAIN_STEPS, log_every=1,
                        log_fn=log_fn)
    peak = torch.cuda.max_memory_allocated()
    for m in logs:
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"non-finite train metrics {m}")
    step_ms = [m["step_time"] * 1e3 for m in logs]
    per = statistics.median(step_ms)
    data_ms = statistics.median(m["data_time"] * 1e3 for m in logs)
    flops = 3 * backbone_flops(RECIPE.backbone, (CROP, CROP)) * TRAIN_BATCH
    log(f"[train] recipe train step, batch {TRAIN_BATCH} of {CROP}², bf16 "
        f"autocast, dropout + drop-path on: median {per:.2f} ms/step over "
        f"{len(step_ms)} (min {min(step_ms):.2f}, max {max(step_ms):.2f}), "
        f"{TRAIN_BATCH / per * 1e3:.3f} images/s, data_time median {data_ms:.3f} "
        f"ms, backbone ~{flops / per / 1e9:.2f} TFLOP/s (3× forward), peak "
        f"memory {peak / 2 ** 30:.3f} GiB; loss {logs[0]['loss']:.4f} → "
        f"{logs[-1]['loss']:.4f}, grad_norm {logs[-1]['grad_norm']:.4f}, "
        f"step {state.step}, lr {state.optimizer.schedule(state.optimizer.count - 1):.3e} "
        f"| card {card}")

    tiles = {"image": np.random.default_rng(SEED + 20).standard_normal(
        (2, TILE, TILE, 3)).astype(np.float32),
        "label": np.random.default_rng(SEED + 21).integers(0, 2, (2, TILE, TILE))}
    metrics = task.evaluate(state, iter([tiles]))
    log(f"[train] evaluate (slide {RECIPE.slide}, 2 tiles of {TILE}²): "
        f"mIoU {metrics['mIoU']:.3f} mAcc {metrics['mAcc']:.3f} aAcc "
        f"{metrics['aAcc']:.3f}")
    if not all(0.0 <= metrics[k] <= 100.0 for k in ("mIoU", "mAcc", "aAcc")):
        raise AssertionError(f"bad evaluate metrics {metrics}")

    # sanity check, not the recipe: the recipe's warmup starts at 6e-11, so
    # a fixed batch at a constant 1e-4 shows that the step learns
    sanity = dataclasses.replace(RECIPE, train=dataclasses.replace(
        RECIPE.train, optimizer=dataclasses.replace(RECIPE.train.optimizer, lr=1e-4),
        schedule=ScheduleConfig(kind="constant")))
    task = SegmentationTask(sanity, model=task.model, device="cuda")
    state = task.init_state(_gen(SEED))
    logs.clear()
    task.fit(state, cycle(batches[:1]), SANITY_STEPS, log_every=1, log_fn=log_fn)
    losses = [m["loss"] for m in logs]
    log(f"[train] sanity (not the recipe): fixed batch, constant lr 1e-4, "
        f"{SANITY_STEPS} steps, loss {' '.join(f'{x:.4f}' for x in losses)}")
    if not min(losses[-3:]) < losses[0]:
        raise AssertionError(f"the loss did not fall on a fixed batch: {losses}")
    return launched


def main() -> None:
    card = phase_device()
    phase_build()
    record = phase_kernels()
    record.update(phase_backward_kernels())
    model_cpu = build_model()
    phase_slice_numerics(model_cpu)
    served = phase_bench(model_cpu, card)
    phase_gradients(model_cpu)
    del model_cpu
    trained = phase_train(card)
    launches = {k: (served if k in PER_FORWARD else trained)[k] for k in KERNELS}
    kernels = [dict(KERNELS[k], launches=launches[k], **record[k]) for k in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
