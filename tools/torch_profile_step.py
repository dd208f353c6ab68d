#!/usr/bin/env python3
"""Device-time breakdown of one recipe train step of the PyTorch port on
one NVIDIA GPU.

    python3 tools/torch_profile_step.py [--recipe xl|rvsa|rvsa_hr] [--steps 2]

Runs the recipe's train step (`chip_smoke.PATHS`: batch, crop, bf16
autocast, remat and drop-path as the recipe sets them) through
`SegmentationTask`, with seeded random weights and synthetic batches, and
prints
- a CUDA-event split of the step, median of 5 steps: forward + loss,
  backward, optimizer, and the whole step on the host clock;
- a `torch.profiler` trace of `--steps` steps: device time per step by
  kernel group (ms and launches), the device busy share (device kernel
  time over the unprofiled step's CUDA-event time, and over the profiled
  steps' wall time, the profiler's own overhead included), and for DCNv3 the time of the K6 launches of each stage and
  the device time spent in `dcnv3_core` outside K3 (its coordinate
  arithmetic and the (N, H, W, G·gc) ↔ (N·G, H·W, gc) layout copies, in the
  forward and in remat's recompute).
Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import re
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from mtp_tpu_torch.ops import dcnv3 as dcnv3_mod  # noqa: E402
from mtp_tpu_torch.tasks._fit import _to_device  # noqa: E402
from mtp_tpu_torch.tasks.segmentation import SegmentationTask  # noqa: E402

# kernel name → group, first match wins
GROUPS = [
    ("K3 bilinear_sample_fwd", r"bilinear_sample_fwd_(vec_)?kernel"),
    ("K6 bilinear_sample_bwd", r"bilinear_sample_bwd_(vec_|tiled_)?kernel"),
    ("K1L window_attn_fwd_large", r"window_attn_fwd_large_(tc_)?kernel"),
    ("K7 window_bwd (both passes)", r"window_bwd_(dq|dkv)_(tc_)?kernel"),
    ("K5 flash_attn_bwd (both passes)", r"flash_bwd_"),
    ("K2 flash_attn_fwd", r"flash_(attn_)?fwd"),
    ("K1 window_attn_fwd", r"window_attn_fwd_(tc_)?kernel"),
    ("K4 window_attn_bwd", r"window_attn_bwd_(tc_)?kernel"),
    ("AdamW (foreach)", r"multi_tensor_apply|foreach|adam"),
    ("cuDNN convolutions", r"conv|cudnn|dgrad|wgrad|implicit_gemm|winograd|fft"),
    ("cuBLAS GEMMs", r"gemm|sm90_xmma|cutlass|ampere_|sm80_|gemv|splitK|nvjet"),
    ("LayerNorm", r"layer_norm|LayerNorm"),
    ("BatchNorm and reductions", r"batch_norm|reduce|Reduce|norm_kernel"),
    ("softmax", r"softmax"),
    ("copies, casts, cat", r"copy|Copy|cat|transpose|permute|contiguous"),
    ("elementwise", r"elementwise|vectorized|unrolled|Elementwise"),
    ("resize, pool, gather/scatter", r"upsample|interp|pool|gather|scatter|index"),
]


def group_of(name: str) -> str:
    for group, rx in GROUPS:
        if re.search(rx, name):
            return group
    return "other"


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--recipe", choices=sorted(chip_smoke.PATHS), default="xl")
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tools/torch_profile_step.py: no CUDA device")
    hw = card()
    path = chip_smoke.PATHS[args.recipe]
    recipe = path.recipe
    task = SegmentationTask(recipe)
    state = task.init_state(torch.Generator().manual_seed(0))
    crop = recipe.backbone.img_size
    batch = {k: _to_device(v, task.device) for k, v in chip_smoke.synthetic_batch(
        recipe.train.batch_size, (crop, crop), recipe.num_classes, 10).items()}
    step = task.train_step_fn()
    for _ in range(3):
        state, m = step(state, batch)
    float(m["loss"])

    # CUDA-event split of the step: the train step's body, timed in parts
    parts = defaultdict(list)
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        ev[0].record()
        state.optimizer.zero_grad()
        loss, _ = task.loss_fn(state.model, batch, state.generator)
        ev[1].record()
        loss.backward()
        ev[2].record()
        state.optimizer.step()
        ev[3].record()
        torch.cuda.synchronize()
        parts["host step"].append((time.perf_counter() - t0) * 1e3)
        for name, a, b in (("forward+loss", 0, 1), ("backward", 1, 2),
                           ("optimizer", 2, 3), ("device step", 0, 3)):
            parts[name].append(ev[a].elapsed_time(ev[b]))
    print(f"[profile {args.recipe}] CUDA-event split, median of 5 steps, batch "
          f"{recipe.train.batch_size} of {crop}²: " + ", ".join(
              f"{k} {statistics.median(v):.2f} ms" for k, v in parts.items())
          + f" | card {hw}", flush=True)

    # dcnv3_core's device time outside K3: its coordinates and layout copies
    core = dcnv3_mod.dcnv3_core

    def annotated(*a, **k):
        with torch.profiler.record_function("dcnv3_core"):
            return core(*a, **k)

    dcnv3_mod.dcnv3_core = annotated
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / args.steps
    dcnv3_mod.dcnv3_core = core

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    # device events without the annotations the profiler also lists there
    # (`Optimizer.step#...`, `dcnv3_core`), which span other kernels
    kernels = [e for e in prof.events() if e.device_type == cuda
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(("Optimizer.", "ProfilerStep", "dcnv3_core"))]
    by_group = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        g = by_group[group_of(e.name)]
        g[0] += e.device_time_total / 1e3 / args.steps
        g[1] += 1
    total = sum(v[0] for v in by_group.values())
    n_ops = sum(v[1] for v in by_group.values()) // args.steps
    step_ms = statistics.median(parts["device step"])
    print(f"[profile {args.recipe}] {total:.2f} ms of device kernels per step "
          f"({n_ops} launches): busy share {total / step_ms:.3f} of the "
          f"unprofiled step ({step_ms:.2f} ms), {total / wall:.3f} of the "
          f"{wall:.2f} ms per step under the profiler | card {hw}")
    for name, (ms, n) in sorted(by_group.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile {args.recipe}]   {name:30s} {ms:9.2f} ms  "
              f"{n // args.steps:6d} launches")
    top = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        top[e.name][0] += e.device_time_total / 1e3 / args.steps
        top[e.name][1] += 1
    for name, (ms, n) in sorted(top.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"[profile {args.recipe}]   top kernel {ms:8.2f} ms {n // args.steps:5d}x "
              f"{name[:110]}")

    k6 = sorted((e for e in kernels if group_of(e.name) == "K6 bilinear_sample_bwd"),
                key=lambda e: e.time_range.start)
    depths = list(reversed(chip_smoke.internimage_config(recipe.backbone).depths)) \
        if args.recipe == "xl" else []
    # kernels per K6 launch: 1, or 2 for the tiled body (coordinates, image)
    per_launch = len(k6) // (sum(depths) * args.steps) if depths else 0
    if per_launch and len(k6) == sum(depths) * args.steps * per_launch:
        # the backward runs the stages last to first
        per_step = k6[:sum(depths) * per_launch]
        i, out = 0, []
        for s, d in zip(range(len(depths) - 1, -1, -1), depths):
            n = d * per_launch
            out.append(f"stage {s} {sum(e.device_time_total for e in per_step[i:i + n]) / 1e3:.2f} ms "
                       f"({d} launches)")
            i += n
        print(f"[profile {args.recipe}] K6 by stage, first profiled step: "
              + ", ".join(reversed(out)) + f" | card {hw}")
    core_dev = sum(e.device_time_total for e in prof.events()
                   if e.name == "dcnv3_core" and e.device_type == cpu) / 1e3 / args.steps
    k3 = by_group["K3 bilinear_sample_fwd"][0]
    if core_dev:
        print(f"[profile {args.recipe}] dcnv3_core device time {core_dev:.2f} ms per "
              f"step (forward and remat's recompute), of which K3 {k3:.2f} ms and "
              f"{core_dev - k3:.2f} ms coordinates and layout copies | card {hw}")


if __name__ == "__main__":
    main()
