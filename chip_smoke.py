#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py        # from the repository root; needs one CUDA
                                 # card, nvcc, and writes nothing but
                                 # mtp_tpu_torch/_build/

Three paths, each through the entry points a user calls, at full width and
depth with seeded random weights: the recipe rvsa-l-upernet-384-mae-mtp-
spacenetv1 (ViT-L+RVSA → UperNet; kernels K1-K6), the recipe
intern-xl-upernet-512-imp-mtp-loveda (InternImage-XL → UperNet; kernel K8,
which is the K3/K6 sampling at P = 9 taps), and the ViT recipe at 2080²
crops with remat (its four full-attention blocks over the 130² token grid
run the window-attention function over one window of 16,900 tokens: K1L
forward, K7 backward).

Phases; any failure raises, so the exit code is non-zero:
1. device: the card's name and power limit; TF32 off for the fp32 phases.
2. build: compile the kernels from mtp_tpu_torch/csrc/ (nvcc, sm_90a); the
   registers and spills of every kernel (ptxas), and the HMMA/HGMMA count of
   the tensor-core kernels' SASS (cuobjdump); the bf16 K2/K5, K1L/K7 and
   K1/K4 kernels at the main path's head dim 64 must have tensor-core
   instructions and no spills.
3. kernels: K1 window attention, K2 flash full attention and K3 bilinear
   sampling against their plain PyTorch versions on the card, in fp32 and
   bf16, at the ViT slice's shapes and at edge shapes (K1: the slice, with
   controls that scale its output by 0.9 and must fail, N = 25 with D = 48,
   a full 64-token tile, D = 40 padded to 48, and N = 100 on the CUDA-core
   body in bf16 too;
   K2: the slice, a 20×33 grid, D = 40 padded to 48, and a 128×128 grid at
   BH = 2 whose plain version runs head by head; K2 returns (out, lse) and
   both are checked; K3: the slice (its vector body), with controls that
   scale its output by 0.9 and must fail, P = 9 off the map's grid, P = 9
   on a 13×37 map's own grid, and C = 12 (the scalar body), the edge cases
   with coordinates exactly at −1, 0, H − 1 and H; a `[halo]` line before
   each case names the body the wrapper picks and, for K6's tiled body,
   the share of its image-gradient adds past a block's region); times of
   the kernel, its plain version and one PyTorch library call computing
   the same function where there is one, each a run of back-to-back calls
   between one pair of CUDA events over their count (the bf16 rows of K1's
   and K3's slice cases and of every K2 case also as device time, kernel
   and library call alike: the calls captured in a CUDA graph and
   replayed); the bound of each (section BOUNDS).
3b. backward kernels: K4, K5 and K6 likewise, at the train step's shapes
   (K4 at K1's five cases, K5 at K2's four, given out and lse from the plain
   fp32 forward; K4 and K5 two launches on the same inputs bitwise equal;
   K6 at K3's four, the P = 9 map-grid case on its tiled body).
3c. K8: K3 and K6 at P = 9, gc = 16, at InternImage-XL's stage 0 and stage
   3 shapes at batch 8, with init-like integer coordinates and with random
   offsets, and at stage 0 with large offsets (N(0, 8²) pixels before the
   scale: a share of K6's adds past its blocks' regions), and at stage 3
   of the 224² and 256² paths (7×7 and 8×8 maps, smaller than one 16×16
   tile of K6's tiled body); every row also as device time, and controls
   at the stage-0 random record shape and at 7×7.
3d. K1L and K7, window attention over one window too large for K1 and K4,
   at 129×3, 130×7 and 130×32 grids (16 heads, D = 64) and at the 2080²
   path's shape (16 heads over N = 16,900: a bias of 4.57e9 fp32 elements,
   over 2^31; the plain version run head by head), in fp32 and bf16: K1L
   returns (out, lse) and both are checked; K7 is given out and lse from
   the plain fp32 forward and must give the same bits twice (a digest of
   each output's bits, so that two 18.3 GB dbias never coexist); at the
   path's shape, controls that the check must reject: each output of both
   kernels scaled by 0.9, and K7's dbias zeroed from element 2^31 on; and
   called directly at phases 3 and 3b's N = 49, where K1 and K4 run, with
   K1 and K4 timed beside them on the same inputs (`[fork]` lines).
   Every output of phases 3-3d is held elementwise (TOL) and as a whole,
   ‖kernel − plain‖ / ‖plain‖ (REL_TOL).
4. ViT logits: full-width ViT-L+RVSA UperNet logits of one 384² crop on the
   card (kernels) against the same model on the CPU (plain versions).
5. ViT serving, bench geometry: 4 tiles of 512², 384² crops at stride 256,
   bf16 autocast, through `SegmentationTask.predict_fn`; launch counts,
   tiles/s and peak memory.
6. ViT gradients: one fp32 loss.backward() of the recipe's model (train-mode
   BatchNorm, no dropout or drop-path) at batch 2 of 384² on the card
   (kernels) against the CPU (plain versions), and a control run with TF32
   on that the same tolerance must reject.
7. ViT training: the recipe's train step (batch 8 of 384², bf16 autocast,
   dropout and drop-path on) through `SegmentationTask.init_state` → `fit` →
   `evaluate`: launch counts per step, finite loss and grad norm, ms/step,
   images/s, data_time and peak memory, and a fixed-batch sanity run whose
   loss must fall.
8-11. The same four for InternImage-XL → UperNet: logits of one 256² crop
   card vs CPU; serving at LoveDA's geometry (2 tiles of 1024², 512² crops
   at stride 256, 9 crops a tile); fp32 gradients at batch 2 of 256² with
   remat; the recipe's train step (batch 8 of 512², remat, drop-path 0.1,
   bf16) and `evaluate` on one 1024² tile.
12-15. The same four for the ViT recipe at 2080² with remat (backbone
   img_size 2080, remat on, batch 1, slide crop 2080): logits and fp32
   gradients (remat, dropout and drop-path on, the masks drawn on the CPU
   for both runs) card vs CPU at a 2080×112 strip (grid 130×7, N = 910:
   K1L and K7 on the card); serving one 2080² tile (one crop); the train
   step, batch 1 of 2080², bf16 autocast, 1 warm-up and 3 timed steps.
16. Classification, ViT-L and InternImage-XL at 224²: fp32 logits of 2
   images card vs CPU; the recipe's train step (batch 8, bf16, drop-path,
   XL with remat) through `ClassificationTask.init_state` → `fit` →
   `evaluate` (top1, top5): launches, ms/step, images/s, data_time, peak
   memory, and a fixed-batch run whose loss must fall.
17. Change detection, ViT-L and InternImage-XL → UNet at 256²: fp32
   change logits of one pair card vs CPU, and the bf16 logits' distance
   from them (the whole model, and the UNet alone on fp32 features); for
   the ViT, fp32 gradients card vs CPU at one pair with the TF32 control;
   the train step at 4 pairs through `ChangeDetectionTask` (one backbone
   pass over the 8 stacked images), `predict_fn` and `evaluate`
   (F1_change), as phase 16.
18. Checkpointing on the XL classifier: `fit` 3 steps with a
   `CheckpointStore` (ckpt_every 2) and the encoder export; step 2 restored
   into a fresh task bit for bit; the next step from it against one from
   an in-process copy of step 2 (by their updates, RESUME_RTOL), with a
   control whose Adam moments are zeroed; the ViT-L classifier's encoder
   (224²) loaded into the 256² change detector and run.
The last lines are the kernels' JSON record, the card, and the result line.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import math
import re
import statistics
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path as FilePath
from typing import Callable, ClassVar, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mtp_tpu_torch.ckpt.from_jax import init_weights
from mtp_tpu_torch.ckpt.store import CheckpointStore, load_encoder, save_encoder
from mtp_tpu_torch.ckpt.torch_convert import backbone_state_dict
from mtp_tpu_torch.config import (ScheduleConfig, SlideConfig, TaskConfig,
                                  intern_xl_224_eurosat,
                                  intern_xl_unet_256_levir,
                                  intern_xl_upernet_512_loveda,
                                  internimage_config, is_internimage,
                                  rvsa_l_unet_256_levir,
                                  rvsa_l_upernet_384_spacenetv1,
                                  vit_rvsa_l_224_eurosat)
from mtp_tpu_torch.eval.slide import slide_origins
from mtp_tpu_torch.kernels import _build
from mtp_tpu_torch.models.internimage import internimage_flops
from mtp_tpu_torch.models.segmentor import Segmentor
from mtp_tpu_torch.models.vit_rvsa import backbone_flops
from mtp_tpu_torch.ops import dcnv3_sample as dcn
from mtp_tpu_torch.ops import fused_attn
from mtp_tpu_torch.ops.dcnv3 import sampling_points
from mtp_tpu_torch.tasks.change_detection import ChangeDetectionTask
from mtp_tpu_torch.tasks.classification import ClassificationTask
from mtp_tpu_torch.tasks.segmentation import SegmentationTask

SEED = 0

# tolerances of kernel against plain version on the same inputs, by the
# dtype of the output:
# fp32 — only the order of the fp32 sums (and expf) differs, and for K6's
#        image gradient the order of its fp32 atomic adds; this holds for
#        the fp32 outputs of bf16 inputs too (dbias, the coordinate and
#        rel-pos gradients), which both compute in fp32;
# bf16 — both compute in fp32 from the same bf16 inputs, the bf16 outputs
#        may differ by one bf16 rounding (relative 2^-8..2^-7)
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}
# and each output as a whole, by its own size: ‖kernel − plain‖ / ‖plain‖
# (2-norms over all its elements) at most REL_TOL of its dtype.  The
# elementwise rule alone is loose where an output's typical element is near
# atol, as K7's dbias at the 2080² path's shape is (~6e-5 against atol
# 1e-4): the norm rule reads 0.1 for an output wrong by 10% everywhere.
# fp32 — reordered fp32 sums: at most 2.4e-6, K1L's and K7's at the 2080²
#        path's N = 16,900 (sums of 16,900 terms), ~1e-7 elsewhere;
# bf16 — the flash and K1L/K7 kernels round P (and dS) to bf16 for the
#        tensor cores, where the plain versions keep them fp32: ~2.6e-3
#        (the outputs' own bf16 rounding alone, ~1e-5).
# Readings: NVIDIA H100 80GB HBM3, every case of phases 3-3d.
REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
CONTROL_SCALE = 0.9  # the controls' kernel outputs wrong by 10% everywhere
# logits, card vs CPU, fp32: max |diff| relative to max |logit| (the
# backbone's layers and the head of reordered fp32 sums)
SLICE_TOL = 2e-3
# gradients, card vs CPU, fp32: the loss to 1e-5 relative; each parameter's
# gradient g to ‖Δg‖ <= rtol·‖g‖ + GRAD_ATOL·‖g_all‖.  rtol 1e-3 where the
# kernels' gradients flow (the ViT's patch embed and 24 blocks; InternImage's
# stem, 39 DCNv3 layers and downsamples) and 1e-2 for the convolutions
# behind train-mode BatchNorm (the ViT's simple-FPN deconvolutions and the
# UperNet head): cuDNN on the card and oneDNN on the CPU sum their weight
# gradients, ~18k positions in which the features' mean cancels (the
# BatchNorm backward removes each channel's mean), in other orders, which
# differ by ~1e-3 of the result.  The absolute floor, against the norm of
# all gradients, is for gradients that are zero or near zero in exact
# arithmetic and whose computed values are rounding residue: conv biases
# right before train-mode BatchNorm, and the PSP pool-1 branch, whose
# BatchNorm at batch 2 sees 2 values per channel.  Every path's check is
# followed by a control run on the card with TF32 on, which the same rule
# must reject (`phase_gradients`).
LOSS_RTOL, GRAD_ATOL = 1e-5, 1e-5
GRAD_RTOL = {"backbone": 1e-3, "convs": 1e-2}
# phase 14, the ViT at a 2080×112 strip with drop-path and identity RVSA
# sampling: backbone rtol 5e-3.  There the backbone's ‖Δg‖/‖g‖ runs from
# 5.2e-4 to 2.22e-3 (median 9.9e-4), the ten largest all the RVSA sampling
# regressors' output layers, whose gradients sum the one-sided coordinate
# derivatives of every tap (K6 on the card); at 1e-3 four parameters fail.
# The TF32 control's smallest backbone reading is 3.2e-2 (median 5.6e-2).
# 5e-3 is 2.3× the sound run's largest and 1/6 of the control's smallest.
GRAD_RTOL_STOCHASTIC = {"backbone": 5e-3, "convs": 1e-2}
# phase 17, the ViT-L change detector at one pair: the backbone is held as
# the convolutions behind train-mode BatchNorm are, rtol 1e-2.  Its only
# gradient is the UNet's input gradient, through the backward of the
# decoder's train-mode BatchNorms, which see one pair's statistics (1,024
# values a channel at the first block).  Against a float64 run of the same
# model (tools/strip_gradient_witness.py --path cd_vit, NVIDIA H100 80GB
# HBM3, 700.00 W) both fp32 runs are that far off: the backbone's
# ‖g − g64‖/‖g64‖ median 2.3e-3 on the card and 2.9e-3 on the CPU, up to
# 5.6e-3 in the RVSA sampling regressors, the card the nearer on 473 of 479
# parameters.  Card vs CPU: median 3.1e-3, largest 5.08e-3 (a regressor);
# the TF32 control: smallest 1.82e-2, median 4.53e-2.
GRAD_RTOL_CD = {"backbone": 1e-2, "convs": 1e-2}

# steps of the fixed-batch sanity run that follows each recipe's train step
SANITY_STEPS = 6
# phases 16-17: steps after the counted one, then the timed steps
TASK_WARM_STEPS, TASK_TRAIN_STEPS = 2, 8
# phase 18: a step from a restored checkpoint against one from an in-process
# copy of the same state, by their parameter updates u: ‖Δu‖ <= RESUME_RTOL·‖u‖.
# Not bitwise: K6 adds its image gradient with fp32 atomics, whose order
# varies between launches (phase 3b's digests cover the deterministic
# kernels only).
RESUME_RTOL = 1e-3

# BOUNDS: the least time the card could take for a kernel's work, the
# larger of its bytes over the memory rate (each input read once, each
# output written once) and its operations over the peak rate of its input
# type.  NVIDIA H100 SXM data sheet, dense, at 700 W.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

COUNTERS = ("window", "flash", "bilinear_sample", "window_bwd", "flash_bwd",
            "bilinear_sample_bwd", "window_large", "window_bwd_qblk")


def launches(**nonzero) -> Dict[str, int]:
    """Every launch counter, 0 unless named."""
    return {**dict.fromkeys(COUNTERS, 0), **nonzero}


@dataclasses.dataclass(frozen=True)
class Path:
    """One recipe's model at full width and depth, and the geometry each
    phase drives it at."""

    name: str
    recipe: TaskConfig
    flops: Callable[[int], float]        # backbone forward FLOPs of one crop
    per_forward: Dict[str, int]          # launches per crop forward
    per_step: Dict[str, int]             # launches per train step
    cpu_hw: Tuple[int, int]              # phases 4, 6 / 8, 10 / 12, 14: the
                                         # image of the card-vs-CPU checks
    tile: int                            # phases 5 / 9 / 13: `tiles` tiles of tile²
    tiles: int
    serve_iters: int                     # timed predicts
    grad_batch: int                      # phases 6 / 10 / 14
    grad_stochastic: bool                # dropout + drop-path on, identity RVSA
                                         # sampling, GRAD_RTOL_STOCHASTIC
    head_prefixes: Tuple[str, ...]       # the "convs" group
    warm_steps: int                      # phases 7 / 11 / 15: after the counted step
    train_steps: int                     # timed steps
    eval_tiles: Tuple[int, int]          # (count, size) for `evaluate`

    @property
    def grad_rtol(self) -> Dict[str, float]:
        return GRAD_RTOL_STOCHASTIC if self.grad_stochastic else GRAD_RTOL


RVSA = rvsa_l_upernet_384_spacenetv1()
XL = intern_xl_upernet_512_loveda()
# the ViT recipe at 2080² crops (2080 = 16·130: a 130² token grid, over the
# 128-per-axis gate of K2) with the JAX field remat on, batch 1, one crop a
# tile: no new recipe, the JAX configs express all of it
HR_CROP = 2080
RVSA_HR = dataclasses.replace(
    RVSA, backbone=dataclasses.replace(RVSA.backbone, img_size=HR_CROP, remat=True),
    train=dataclasses.replace(RVSA.train, batch_size=1),
    slide=SlideConfig(crop=HR_CROP, stride=HR_CROP // 2))
PATHS = {
    # ViT-L+RVSA → UperNet (512 channels), 2 classes (SpaceNet v1), 384²
    # crops, slide eval at stride 256, batch 8, AdamW 6e-5; serving at
    # bench.py's default TPU workload (4 tiles of 512², 4 crops each)
    "rvsa": Path(
        name="rvsa", recipe=RVSA,
        flops=lambda crop: backbone_flops(RVSA.backbone, (crop, crop)),
        per_forward=launches(window=20, flash=4, bilinear_sample=40),
        per_step=launches(window=20, flash=4, bilinear_sample=40, window_bwd=20,
                          flash_bwd=4, bilinear_sample_bwd=40),
        cpu_hw=(384, 384), tile=512, tiles=4, serve_iters=8, grad_batch=2,
        grad_stochastic=False, head_prefixes=("backbone.fpn", "decode_head."),
        warm_steps=2, train_steps=12, eval_tiles=(2, 512)),
    # InternImage-XL (channels 192, depths 5/5/24/5, groups 12/24/48/96,
    # post-norm, layer scale 1e-5, offset_scale 2, remat, drop-path 0.1) →
    # UperNet, 7 classes (LoveDA), 512² crops, slide eval at stride 256,
    # batch 8, AdamW 2e-5 with layer decay 0.94; serving at LoveDA's tile
    # size (1024²: 9 crops a tile).  Logits and gradients card vs CPU at
    # 256², which keeps the CPU's full-depth fp32 forward and backward to
    # about a minute on the machine with the card.
    "xl": Path(
        name="xl", recipe=XL,
        flops=lambda crop: internimage_flops(internimage_config(XL.backbone), crop),
        per_forward=launches(bilinear_sample=39),
        per_step=launches(bilinear_sample=78, bilinear_sample_bwd=39),
        cpu_hw=(256, 256), tile=1024, tiles=2, serve_iters=8, grad_batch=2,
        grad_stochastic=False, head_prefixes=("decode_head.",), warm_steps=2,
        train_steps=8, eval_tiles=(1, 1024)),
    # the ViT recipe at 2080² with remat: per crop forward the 4 full blocks
    # run K1L; per train step each block runs forward and recompute (K1 40,
    # K1L 8, K3 80) and K4 20, K7 4, K6 40.  Card vs CPU at a 2080×112 strip
    # (the CPU's full-depth fp32 forward and backward of a 2080² crop would
    # take far too long), with dropout and drop-path on, at batch 2 as the
    # other paths (at batch 1 the PSP pooling branches' BatchNorm sees 1-9
    # values of one image per channel, which makes the gradients more
    # sensitive to rounding), and the gradients at identity sampling (see
    # `phase_gradients`) and GRAD_RTOL_STOCHASTIC.  1 warm-up step (the
    # counted one) and 3 timed steps.
    "rvsa_hr": Path(
        name="rvsa_hr", recipe=RVSA_HR,
        flops=lambda crop: backbone_flops(RVSA_HR.backbone, (crop, crop)),
        per_forward=launches(window=20, window_large=4, bilinear_sample=40),
        per_step=launches(window=40, window_large=8, bilinear_sample=80,
                          window_bwd=20, window_bwd_qblk=4, bilinear_sample_bwd=40),
        cpu_hw=(HR_CROP, 112), tile=HR_CROP, tiles=1, serve_iters=3, grad_batch=2,
        grad_stochastic=True, head_prefixes=("backbone.fpn", "decode_head."),
        warm_steps=0, train_steps=3, eval_tiles=(1, HR_CROP)),
}

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
    # K8: the same two kernels at P = 9, on the InternImage path
    "dcnv3_fwd": dict(name="dcnv3_sample_fwd", route="cuda",
                      source="mtp_tpu_torch/csrc/bilinear_sample_fwd.cu",
                      replaces="mtp_tpu/ops/dcnv3_pallas.py:635"),
    "dcnv3_bwd": dict(name="dcnv3_sample_bwd", route="cuda",
                      source="mtp_tpu_torch/csrc/bilinear_sample_bwd.cu",
                      replaces="mtp_tpu/ops/dcnv3_pallas.py:678"),
    # K1L: `_fused_forward` at pack 1 for windows over K1's shared memory
    "window_large": dict(name="window_attn_fwd_large", route="cuda",
                         source="mtp_tpu_torch/csrc/window_attn_fwd_large.cu",
                         replaces="mtp_tpu/ops/pallas_attn.py:662"),
    "window_bwd_qblk": dict(name="window_attn_bwd_qblk", route="cuda",
                            source="mtp_tpu_torch/csrc/window_attn_bwd_qblk.cu",
                            replaces="mtp_tpu/ops/pallas_attn.py:271"),
}
# where each kernel's `launches` is read: (path, phase kind, counter)
LAUNCHED_IN = {
    "window": ("rvsa", "serve", "window"),
    "flash": ("rvsa", "serve", "flash"),
    "bilinear_sample": ("rvsa", "serve", "bilinear_sample"),
    "window_bwd": ("rvsa", "train", "window_bwd"),
    "flash_bwd": ("rvsa", "train", "flash_bwd"),
    "bilinear_sample_bwd": ("rvsa", "train", "bilinear_sample_bwd"),
    "dcnv3_fwd": ("xl", "serve", "bilinear_sample"),
    "dcnv3_bwd": ("xl", "train", "bilinear_sample_bwd"),
    "window_large": ("rvsa_hr", "serve", "window_large"),
    "window_bwd_qblk": ("rvsa_hr", "train", "window_bwd_qblk"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def counters() -> dict:
    return {**fused_attn.LAUNCHES, **dcn.LAUNCHES}


def reset_counters() -> None:
    for launched in (fused_attn.LAUNCHES, dcn.LAUNCHES):
        launched.update(dict.fromkeys(launched, 0))


def loop_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """ms per call of fn: `reps` back-to-back calls between one pair of CUDA
    events, after `warmup` calls, so that a call's host work (the wrapper's
    checks and allocations) overlaps the previous call's device work as it
    does on the main path, and the events' own resolution is spread over
    the run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


_CAPTURE: List[torch.cuda.Stream] = []


def capture_stream() -> torch.cuda.Stream:
    """The side stream `graph_ms` captures on.  A library call whose
    autograd backward it times runs its forward here (`on_capture_stream`):
    autograd launches each backward op on its forward op's stream, and a
    capture records only its own stream."""
    if not _CAPTURE:
        _CAPTURE.append(torch.cuda.Stream())
    return _CAPTURE[0]


def on_capture_stream(fn):
    """fn() on `capture_stream`, after the work queued so far on the current
    stream and before whatever is queued on it next."""
    side, current = capture_stream(), torch.cuda.current_stream()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        result = fn()
    current.wait_stream(side)
    return result


def graph_ms(fn, reps: int = 20) -> float:
    """Device time per call of fn: `reps` calls captured in one CUDA graph
    on `capture_stream` (their outputs from the graph's own memory pool),
    replayed between one pair of CUDA events, over `reps`.  Unlike
    `loop_ms` it leaves out the host's work per call, which for K1 and K4
    at RVSA's 49-token windows takes longer than the kernel; unlike
    torch.profiler, which missed launches at that size, it counts every
    launch.  Kernels and library calls alike are timed by it."""
    on_capture_stream(fn)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=capture_stream()):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


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


def sass_tensor_core_counts() -> Dict[str, int]:
    """{kernel label: HMMA + HGMMA instructions} of every kernel in the built
    library, from `cuobjdump -sass`."""
    tool = FilePath(_build.find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(_build.LIB)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            name = _build.kernel_label(fn[1])
            counts.setdefault(name, 0)
        elif name and re.search(r"\bHG?MMA\.", line):
            counts[name] += 1
    return counts


# the bf16 tensor-core kernels at the main path's head dim (ViT-B and
# ViT-L: 64): K2, K5's two passes, K1L, K7's two passes, K1, K4
TC_MAIN = ("flash_fwd_tc_kernel<64>", "flash_bwd_dq_tc_kernel<64>",
           "flash_bwd_dkv_tc_kernel<64>", "window_attn_fwd_large_tc_kernel<64>",
           "window_bwd_dq_tc_kernel<64>", "window_bwd_dkv_tc_kernel<64>",
           "window_attn_fwd_tc_kernel<64>", "window_attn_bwd_tc_kernel<64>")


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
    counts = sass_tensor_core_counts()
    for name, n in sorted(counts.items()):
        if "_tc_kernel<" in name:
            log(f"[build] SASS {name}: {n} HMMA/HGMMA instructions")
    for name in TC_MAIN:
        ptxas = [line for line in _build.PTXAS_LOG if line.startswith(name + ":")]
        if not counts.get(name):
            raise AssertionError(f"{name}: no tensor-core instruction in its SASS")
        if len(ptxas) != 1 or "0 bytes spill stores, 0 bytes spill loads" not in ptxas[0]:
            raise AssertionError(f"{name}: ptxas reports spills or nothing: {ptxas}")


# -------------------------------------------------------- phase 3, 3b, 3c --

@dataclasses.dataclass
class Case:
    """A kernel, its plain version, their inputs in a given dtype, the
    operations the function does on those inputs, and optionally one
    PyTorch library call computing the same function (built outside the
    timed region; returns (call, description))."""

    kernel: Callable
    plain: Callable
    args: Callable[[torch.dtype], tuple]
    flops: Callable[[tuple], float]
    library: Optional[Callable[[tuple], Tuple[Callable, str]]] = None
    dtypes: Tuple[torch.dtype, ...] = (torch.float32, torch.bfloat16)
    reps: int = 20  # timed calls of each of kernel, plain and library
    deterministic: bool = False  # two launches on the same inputs must agree bit for bit
    device_time: bool = False  # bf16 rows: the kernel's and the library call's
                               # device time (`graph_ms`) too
    controls: bool = False  # `check_controls` must reject altered outputs
    describe: Optional[Callable[[tuple], str]] = None  # logged before the checks


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _randn(shape, g, scale=1.0):
    return (torch.randn(shape, generator=g) * scale).cuda()


def _sdpa_library(q, k, v, bias, scale, dout=None):
    """F.scaled_dot_product_attention on these inputs, the bias cast to q's
    dtype (SDPA takes no other) outside the timed call; with dout the
    autograd.grad of that call w.r.t. q, k, v and the bias, its forward run
    once outside the timed call, on `capture_stream` so that `graph_ms` can
    capture the backward.  The backend is the first of flash,
    efficient, cuDNN and math that takes the call."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if q.dim() == 3:  # (BH, N, D): one batch of BH heads, as SDPA's kernels take
        q, k, v, bias = (t[None] for t in (q, k, v, bias))
        dout = None if dout is None else dout[None]
    bias = bias.to(q.dtype)
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                if dout is None:
                    call = lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=bias, scale=scale)
                else:
                    leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
                    out = on_capture_stream(lambda: F.scaled_dot_product_attention(
                        *leaves[:3], attn_mask=leaves[3], scale=scale))
                    call = lambda: torch.autograd.grad(out, leaves, dout,
                                                       retain_graph=True)
                call()
                torch.cuda.synchronize()
        except RuntimeError:
            continue
        what = "grad of " if dout is not None else ""
        return (lambda: _under(sdpa_kernel, backend, call),
                f"{what}SDPA[{backend.name}]")
    raise RuntimeError("no SDPA backend takes the call")


def _under(ctx, arg, call):
    with ctx(arg):
        return call()


def _grid_sample_library(img, py, px, H, W, g=None):
    """F.grid_sample (bilinear, zeros, align_corners=True) of the NCHW map
    at the one-tap coordinates, converted to the normalised grid in img's
    dtype outside the timed call; with g the autograd.grad w.r.t. the map
    and the grid, its forward run once outside the timed call, on
    `capture_stream` so that `graph_ms` can capture the backward."""
    BG, _, C = img.shape
    nchw = img.reshape(BG, H, W, C).permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([px[..., 0] / (W - 1) * 2 - 1, py[..., 0] / (H - 1) * 2 - 1],
                       -1)[:, None].to(img.dtype).contiguous()
    run = lambda a, b: F.grid_sample(a, b, mode="bilinear", padding_mode="zeros",
                                     align_corners=True)
    if g is None:
        return (lambda: run(nchw, grid)), "grid_sample"
    leaves = [nchw.requires_grad_(), grid.requires_grad_()]
    out = on_capture_stream(lambda: run(*leaves))
    cot = g.permute(0, 2, 1)[:, :, None].contiguous()
    return (lambda: torch.autograd.grad(out, leaves, cot, retain_graph=True),
            "grad of grid_sample")


def _by_head(plain, dim: int = 1):
    """The plain version run one head at a time (one index of `dim` of
    every tensor argument) into preallocated outputs: the same function, in
    the memory of one head's (N, N) temporaries."""
    def run(*args):
        nH = args[0].shape[dim]
        head = lambda t, h: t.narrow(dim, h, 1) if isinstance(t, torch.Tensor) else t
        outs = None
        for h in range(nH):
            res = plain(*(head(a, h) for a in args))
            res = res if isinstance(res, tuple) else (res,)
            if outs is None:
                outs = [torch.empty(r.shape[:dim] + (nH,) + r.shape[dim + 1:],
                                    dtype=r.dtype, device=r.device) for r in res]
            for o, r in zip(outs, res):
                o.narrow(dim, h, 1).copy_(r)
            del res
        return outs[0] if len(outs) == 1 else tuple(outs)
    return run


def path_window_inputs(W, nH, N, D, seed) -> tuple:
    """q, k, v, dout, bias of a `large_window_case` at a main path's shape,
    drawn on the card (a host-side draw of a 4.57e9-element bias would take
    minutes) and shared by the forward and backward cases (one 18.3 GB
    bias, not two)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rand = lambda shape: torch.randn(shape, generator=g, device="cuda")
    q, k, v, dout = (rand((W, nH, N, D)) for _ in range(4))
    bias = rand((W, nH, N, N)).mul_(0.5)
    return q, k, v, dout, bias


def _window_inputs(W, nH, N, D, seed) -> tuple:
    g = _gen(seed)
    q, k, v, dout = (_randn((W, nH, N, D), g) for _ in range(4))
    return q, k, v, dout, _randn((W, nH, N, N), g, 0.5)


def window_case(W, nH, N, D, seed, bwd=False, controls=False,
                device_time=False) -> Case:
    """K1 (or K4 with bwd, which must give the same bits twice): QKᵀ and PV,
    4·N²·D FLOPs per (window, head); the backward recomputes S and forms
    dV, dP, dQ, dK: 10·N²·D."""
    q, k, v, dout, bias = _window_inputs(W, nH, N, D, seed)
    scale = D ** -0.5
    flops = lambda a: (10 if bwd else 4) * W * nH * N * N * D
    extra = dict(controls=controls, device_time=device_time)
    if bwd:
        return Case(fused_attn.fused_window_attention_bwd,
                    fused_attn.fused_window_attention_bwd_ref,
                    lambda dt: (q.to(dt), k.to(dt), v.to(dt), bias, dout.to(dt), scale),
                    flops, lambda a: _sdpa_library(a[0], a[1], a[2], a[3], a[5], a[4]),
                    deterministic=True, **extra)
    return Case(fused_attn._window_fwd, fused_attn.fused_window_attention_ref,
                lambda dt: (q.to(dt), k.to(dt), v.to(dt), bias, scale), flops,
                lambda a: _sdpa_library(*a), **extra)


def window_cases(W, seed, bwd=False) -> list:
    """K1 / K4 at the slice shape (W windows × 16 heads of RVSA's 49
    tokens, D = 64; controls; also timed as device time, `graph_ms`: a call
    of the wrapper at N = 49 takes longer on the host than the kernel on
    the card), a ragged edge (N = 25, D = 48), a full 64-token tile with
    nothing masked, D = 40 (the tensor-core wrapper pads it to 48), and
    N = 100, which runs the CUDA-core body in bf16 too."""
    return [("slice", window_case(W, 16, 49, 64, seed, bwd, controls=True,
                                  device_time=True)),
            ("edge N=25 W=7", window_case(7, 3, 25, 48, seed + 1, bwd)),
            ("full N=64", window_case(16, 16, 64, 64, seed + 2, bwd)),
            ("D=40 padded", window_case(16, 16, 49, 40, seed + 3, bwd)),
            ("N=100 cores", window_case(8, 16, 100, 64, seed + 4, bwd))]


def large_window_case(W, nH, N, D, seed, bwd=False, path_inputs=None,
                      library=True) -> Case:
    """K1L (or K7 with bwd), called directly at any N, with the FLOPs of K1
    (K4).  K1L returns (out, lse); K7 takes out and lse from the plain fp32
    forward on the case's inputs, so the kernel is held against statistics
    it did not make, and must give the same bits twice.  With `path_inputs`
    (`path_window_inputs`): 5 timed calls, the plain versions head by
    head, and the controls (`check_controls`)."""
    q, k, v, dout, bias = path_inputs or _window_inputs(W, nH, N, D, seed)
    scale = D ** -0.5
    flops = lambda a: (10 if bwd else 4) * W * nH * N * N * D
    path_shape = path_inputs is not None
    extra = dict(reps=5, controls=True) if path_shape else {}
    wrap = _by_head if path_shape else (lambda f: f)
    fwd_ref = wrap(fused_attn.fused_window_attention_large_ref)
    if bwd:
        def args(dt):
            qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
            with torch.no_grad():
                out, lse = fwd_ref(qd.float(), kd.float(), vd.float(), bias, scale)
            return (qd, kd, vd, bias, out.to(dt), lse, dout.to(dt), scale)
        lib = lambda a: _sdpa_library(a[0], a[1], a[2], a[3], a[7], a[6])
        return Case(fused_attn.fused_window_attention_large_bwd,
                    wrap(fused_attn.fused_window_attention_large_bwd_ref), args, flops,
                    lib if library else None, deterministic=True, **extra)
    return Case(fused_attn._window_large_fwd, fwd_ref,
                lambda dt: (q.to(dt), k.to(dt), v.to(dt), bias, scale), flops,
                (lambda a: _sdpa_library(*a)) if library else None, **extra)


def _expand_rel(rel_h, rel_w):
    """The bias K2 rebuilds in-kernel: rel_h[q, k // Wk] + rel_w[q, k % Wk]."""
    BH, N, _ = rel_h.shape
    return (rel_h[..., :, None] + rel_w[..., None, :]).reshape(BH, N, -1)


def flash_case(BH, grid_hw, D, seed, scale=1.0, bwd=False) -> Case:
    """K2 (or K5 with bwd): 4·N²·D FLOPs per row of BH (10·N²·D backward:
    the recomputed S, then dP, dQ, dK, dV).  K2 returns (out, lse); K5 takes
    out and lse from the plain fp32 forward on the case's inputs, so the
    kernel is held against statistics it did not make, and must give the
    same bits twice.  Grids over 64 per axis run the plain versions head by
    head (rows of BH) and 5 timed calls."""
    g = _gen(seed)
    N = grid_hw[0] * grid_hw[1]
    q, k, v, dout = (_randn((BH, N, D), g) for _ in range(4))
    q = q * D ** -0.5 if scale == 1.0 else q
    rel_h = _randn((BH, N, grid_hw[0]), g, 0.5)
    rel_w = _randn((BH, N, grid_hw[1]), g, 0.5)
    flops = lambda a: (10 if bwd else 4) * BH * N * N * D
    big = max(grid_hw) > 64
    wrap = (lambda f: _by_head(f, 0)) if big else (lambda f: f)
    extra = dict(reps=5) if big else {}
    fwd_ref = wrap(fused_attn.flash_full_attention_ref)
    if bwd:
        def args(dt):
            qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
            with torch.no_grad():
                out, lse = fwd_ref(qd.float(), kd.float(), vd.float(), rel_h, rel_w,
                                   grid_hw, scale)
            return (qd, kd, vd, rel_h, rel_w, out.to(dt), lse, dout.to(dt), grid_hw, scale)
        return Case(fused_attn.flash_full_attention_bwd,
                    wrap(fused_attn.flash_full_attention_bwd_ref), args, flops,
                    lambda a: _sdpa_library(a[0], a[1], a[2], _expand_rel(a[3], a[4]),
                                            a[9], a[7]),
                    deterministic=True, device_time=True, **extra)
    return Case(fused_attn._flash_fwd, fwd_ref,
                lambda dt: (q.to(dt), k.to(dt), v.to(dt), rel_h, rel_w, grid_hw, scale),
                flops, lambda a: _sdpa_library(a[0], a[1], a[2],
                                               _expand_rel(a[3], a[4]), a[6]),
                device_time=True, **extra)


def flash_cases(BH, seed, bwd=False) -> list:
    """K2 / K5 at the slice shape (BH heads over the 24×24 grid, D = 64),
    a ragged 20×33 grid (N = 660, a partial tile on both axes), D = 40 (the
    wrapper pads it to 48) and the largest grid that routes to flash,
    128×128 (2048² crops), at BH = 2."""
    return [("slice", flash_case(BH, (24, 24), 64, seed, bwd=bwd)),
            ("edge 20x33", flash_case(4, (20, 33), 64, seed + 1, scale=0.125, bwd=bwd)),
            ("D=40 padded", flash_case(8, (24, 24), 40, seed + 2, bwd=bwd)),
            ("grid 128x128", flash_case(2, (128, 128), 64, seed + 3, bwd=bwd))]


def in_map_corners(py, px, H, W) -> int:
    """Bilinear corners of all taps that lie on the map: the data-dependent
    work of K3 and K6."""
    y0, x0 = torch.floor(py), torch.floor(px)
    n = 0
    for dy in (0, 1):
        for dx in (0, 1):
            y, x = y0 + dy, x0 + dx
            n += int(((y >= 0) & (y <= H - 1) & (x >= 0) & (x <= W - 1)).sum())
    return n


def _sample_describe(bwd: bool) -> Callable[[tuple], str]:
    """The body the wrapper picks for a K3 (K6) case's inputs and, for the
    tiled body, the share of its image-gradient adds that fall outside the
    region a block owns (`dcn.out_of_halo_share`)."""
    def describe(a):
        img, py, px, m, H, W = *a[:4], *a[-2:]
        storage = (img, a[4]) if bwd else (img,)
        body = dcn.sample_body(img.shape[-1], py.shape[-1], img.dtype,
                               all(t.data_ptr() % dcn.VEC_BYTES == 0 for t in storage),
                               bwd=bwd, same_grid=py.shape[1] == H * W)
        if body != "tiled":
            share = "none: no owned region, every add goes to device memory" if bwd else "—"
        else:
            share = f"{dcn.out_of_halo_share(py, px, m, H, W):.4f}"
        return f"{'K6' if bwd else 'K3'} body {body}, out-of-halo share {share}"
    return describe


def _sample(img, py, px, m, cot, H, W, bwd, library, **extra) -> Case:
    """K3 (or K6 with bwd): a multiply-add per channel for each in-map
    corner (2·C FLOPs; the backward's dot product and scatter, 4·C)."""
    C = img.shape[-1]
    flops = lambda a: (4 if bwd else 2) * C * in_map_corners(a[1], a[2], H, W)
    extra = dict(describe=_sample_describe(bwd), **extra)
    if bwd:
        lib = lambda a: _grid_sample_library(*a[:3], H, W, a[4])
        return Case(dcn.dcnv3_sample_bwd, dcn.dcnv3_sample_bwd_ref,
                    lambda dt: (img.to(dt), py, px, m, cot.to(dt), H, W), flops,
                    lib if library else None, **extra)
    lib = lambda a: _grid_sample_library(*a[:3], H, W)
    return Case(dcn.dcnv3_sample, dcn.dcnv3_sample_ref,
                lambda dt: (img.to(dt), py, px, m, H, W), flops,
                lib if library else None, **extra)


def sample_case(BG, H, W, C, HWo, P, seed, edge, bwd=False) -> Case:
    """K3 / K6 as RVSA samples K and V (P = 1, a unit mask: one grid_sample
    call computes it; controls, and device time by `graph_ms`), or an edge
    case (a signed mask, coordinates off every side, a quarter of them
    exact integers, and on a quarter of the pixels coordinates exactly at
    −1, 0, H − 1 and H (−1, 0, W − 1, W), one value a tap)."""
    g = _gen(seed)
    img = _randn((BG, H * W, C), g)
    cot = _randn((BG, HWo, C), g)
    lo, hi = (-2.5, 1.5) if edge else (-1.0, 0.0)  # edge: off every side
    py = torch.rand((BG, HWo, P), generator=g) * (H - lo + hi) + lo
    px = torch.rand((BG, HWo, P), generator=g) * (W - lo + hi) + lo
    if edge:  # a quarter exact integers, a quarter at the map's edges, a signed mask
        py[:, ::4] = py[:, ::4].round()
        px[:, ::4] = px[:, ::4].round()
        t = torch.arange(P)
        rim = lambda n: torch.tensor([-1.0, 0.0, n - 1.0, float(n)])
        py[:, 2::4], px[:, 3::4] = rim(H)[t % 4], rim(W)[t % 4]
        py[:, 3::4] = rim(H)[t // 4 % 4]
        m = torch.rand((BG, HWo, P), generator=g) * 2 - 1
    else:
        m = torch.ones((BG, HWo, P))
    return _sample(img, py.cuda(), px.cuda(), m.cuda(), cot, H, W, bwd,
                   library=not edge and P == 1, controls=not edge,
                   device_time=not edge)


def sample_cases(BG, seed, bwd=False) -> list:
    """K3 / K6 at the slice shape (BG maps of RVSA's 28² K/V grid, C = 64,
    P = 1: the vector body), at P = 9 off the map's grid (the vector body
    at P = 9; the tiled one backward needs HWo = H·W), at P = 9 on a 13×37
    map's own grid (tiles cut by both edges: the tiled body backward), and
    at C = 12 (24 bf16 bytes, not whole 16-byte runs: the scalar body)."""
    return [("slice", sample_case(BG, 28, 28, 64, 784, 1, seed, edge=False, bwd=bwd)),
            ("edge P=9", sample_case(6, 13, 17, 32, 200, 9, seed + 1, edge=True, bwd=bwd)),
            ("edge P=9 tiled", sample_case(6, 13, 37, 16, 481, 9, seed + 2, edge=True,
                                           bwd=bwd)),
            ("edge C=12", sample_case(6, 13, 17, 12, 221, 9, seed + 3, edge=True,
                                      bwd=bwd))]


# K8's offsets before the scale: zero (every tap on an integer, as at
# init), N(0, 1) pixels, and N(0, 8²) pixels, which sends a share of the
# tiled backward's adds past its blocks' regions
OFFSETS = {"init": 0.0, "random": 1.0, "large": 8.0}


def dcnv3_case(batch, hw, groups, gc, seed, offsets, bwd=False, record=False) -> Case:
    """K8: the sampling of one XL DCNv3 layer at batch `batch` on an hw²
    map, its inputs made as the layer makes them (`sampling_points`,
    kernel 3, offset_scale 2) at the OFFSETS kind `offsets`: zero offsets
    put every tap on an integer, the border taps partly or wholly off the
    map (−1, −2).  A softmaxed mask.  Device time by `graph_ms`; a case
    with `record` has controls.  No single PyTorch call computes a 9-tap
    masked bilinear sum."""
    g = _gen(seed)
    G, P = groups, 9
    offset = torch.randn((batch, hw, hw, G * P * 2), generator=g) * OFFSETS[offsets]
    mask = torch.softmax(torch.randn((batch, hw, hw, G, P), generator=g), -1)
    py, px, m = sampling_points(offset.cuda(), mask.reshape(batch, hw, hw, G * P).cuda(),
                                group=G, offset_scale=2.0)
    img = _randn((batch * G, hw * hw, gc), g)
    cot = _randn((batch * G, hw * hw, gc), g)
    return _sample(img, py, px, m, cot, hw, hw, bwd, library=False, controls=record,
                   device_time=True)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def max_abs_err(a: torch.Tensor, b: torch.Tensor, what: str,
                alter: Optional[Callable] = None) -> Tuple[float, float, float]:
    """(max |a − b|, max |b|, ‖a − b‖/‖b‖) of two same-shaped outputs;
    raises unless a is finite, |a − b| <= atol + rtol·|b| everywhere
    (torch.testing.assert_close's rule, TOL) and ‖a − b‖ <= REL_TOL·‖b‖,
    all of a's dtype.  Taken in chunks, so that a 4.57e9-element output
    needs no full-size temporaries; `alter(x, i)` changes a copy of a's
    chunk from flat index i first (a control)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        raise AssertionError(f"{what}: {a.dtype}{tuple(a.shape)} vs "
                             f"{b.dtype}{tuple(b.shape)}")
    (atol, rtol), rel_tol = TOL[a.dtype], REL_TOL[a.dtype]
    a, b = a.reshape(-1), b.reshape(-1)
    err, scale, bad, d2, r2, step = 0.0, 0.0, 0, 0.0, 0.0, 1 << 27
    for i in range(0, a.numel(), step):
        x, y = a[i:i + step].float(), b[i:i + step].float()
        if alter is not None:
            x = alter(x.clone(), i)
        if not torch.isfinite(x).all():
            raise AssertionError(f"{what}: non-finite output")
        diff = (x - y).abs()
        bad += int((diff > atol + rtol * y.abs()).sum())
        err = max(err, diff.max().item())
        scale = max(scale, y.abs().max().item())
        d2 += float(diff.double().square().sum())
        r2 += float(y.double().square().sum())
    rel = math.sqrt(d2 / r2) if r2 > 0 else (0.0 if d2 == 0 else math.inf)
    if bad or not rel <= rel_tol:
        raise AssertionError(
            f"{what}: {bad} elements off (max abs err {err:.3e}, atol {atol}, "
            f"rtol {rtol}), ‖Δ‖/‖ref‖ {rel:.3e} (limit {rel_tol})")
    return err, scale, rel


def _scaled(x: torch.Tensor, i: int) -> torch.Tensor:
    return x.mul_(CONTROL_SCALE)


def _zeroed_from_2_31(x: torch.Tensor, i: int) -> torch.Tensor:
    x[max(0, (1 << 31) - i):] = 0
    return x


def check_controls(got: tuple, ref: tuple, what: str) -> None:
    """The controls of a case's outputs, each of which `max_abs_err` must
    reject: every output scaled by CONTROL_SCALE (a kernel wrong by 10%
    everywhere), and every output over 2^31 elements with its elements from
    flat index 2^31 on set to 0, as a kernel that wrote them at wrapped
    32-bit offsets (or not at all) would leave them.  The outputs are not
    changed."""
    for i, (a, b) in enumerate(zip(got, ref)):
        controls = [(f"scaled by {CONTROL_SCALE}", _scaled)]
        if a.numel() > 1 << 31:
            controls.append(("zeroed from element 2^31 on", _zeroed_from_2_31))
        for desc, alter in controls:
            try:
                max_abs_err(a, b, f"{what} output {i}", alter)
            except AssertionError as e:
                log(f"[kernel] control {what} output {i} {desc} -> rejected ({e})")
                continue
            raise AssertionError(f"{what} output {i}: the control {desc} passed "
                                 f"the tolerance")


def bits_digest(t: torch.Tensor) -> Tuple[int, ...]:
    """A digest of t's bits, taken on the card: per 2^27-element chunk, the
    sum of its elements' bit patterns as integers and their sum weighted by
    position (mod 2^64).  Two launches that agree bit for bit give equal
    digests; one that differs anywhere changes a sum unless its differences
    cancel in both, so that a second 18.3 GB output need not coexist with
    the first."""
    ints = t.reshape(-1).view({4: torch.int32, 2: torch.int16}[t.element_size()])
    sums, step = [], 1 << 27
    for i in range(0, ints.numel(), step):
        x = ints[i:i + step].long()
        w = torch.arange(i + 1, i + 1 + x.numel(), device=x.device) % 65521 + 1
        sums += [int(x.sum()), int((x * w).sum())]
    return tuple(sums)


def check_kernels(cases: dict, record_label: str = "slice") -> dict:
    """Each case's kernel against its plain version on the same inputs, in
    its dtypes (fp32 and bf16 unless it names others), output by output,
    after checking that the kernel call launched the kernel of its key;
    returns {kernel: {max_abs_err, ms, plain_ms, library_ms, bound_ms,
    bound_by}} of the `record_label` case in bf16, the main path's working
    type."""
    record = {}
    for kname, kcases in cases.items():
        counter = LAUNCHED_IN[kname][2]
        for label, case in kcases:
            for dtype in case.dtypes:
                args = case.args(dtype)
                if case.describe is not None:
                    log(f"[halo] {kname} {label} {dtype}: {case.describe(args)}")
                before = counters()
                with torch.no_grad():
                    got = case.kernel(*args)
                    moved = {k: n - before[k] for k, n in counters().items()
                             if n != before[k]}
                    if moved != {counter: 1}:
                        raise AssertionError(f"{kname} {label}: launched {moved}, "
                                             f"expected one {counter}")
                    got = got if isinstance(got, tuple) else (got,)
                    digests = [bits_digest(a) for a in got] if case.deterministic else None
                    free()  # the cache the last case's 18.3 GB outputs left
                    ref = case.plain(*args)
                torch.cuda.synchronize()
                ref = ref if isinstance(ref, tuple) else (ref,)
                errs, scales, rels = zip(*(max_abs_err(a, b, f"{kname} {label} "
                                                       f"{dtype} output {i}")
                                           for i, (a, b) in enumerate(zip(got, ref))))
                if case.controls:
                    check_controls(got, ref, f"{kname} {label} {dtype}")
                out_bytes = _nbytes(got)
                tols = " ".join(f"{TOL[o.dtype] + (REL_TOL[o.dtype],)}" for o in got)
                del got, ref  # the path shape's outputs hold 18.3 GB each
                free()
                if case.deterministic:  # a second launch, against the first's digests
                    with torch.no_grad():
                        again = case.kernel(*args)
                        same = [bits_digest(a) == d for a, d in zip(again, digests)]
                    del again
                    free()
                    if not all(same):
                        raise AssertionError(f"{kname} {label} {dtype}: two launches on "
                                             f"the same inputs differ: {same}")
                    log(f"[kernel] {kname} {label} {dtype}: two launches bitwise equal "
                        f"in all {len(same)} outputs (digest of the bits)")
                timed = lambda fn: loop_ms(fn, reps=case.reps,
                                           warmup=min(3, case.reps // 4))
                recorded = label == record_label and dtype == torch.bfloat16
                device = case.device_time and dtype == torch.bfloat16
                graph_note = lambda fn: (f" (CUDA graph: {graph_ms(fn, case.reps):.4f} ms "
                                         f"of device time a call)") if device else ""
                with torch.no_grad():
                    ms = timed(lambda: case.kernel(*args))
                    plain_ms = timed(lambda: case.plain(*args))
                    prof = graph_note(lambda: case.kernel(*args))
                library_ms, what, lib_prof = None, "none", ""
                if case.library is not None:
                    free()
                    call, what = case.library(args)
                    library_ms = timed(call)
                    lib_prof = graph_note(call)
                    del call
                    free()
                flops = case.flops(args)
                nbytes = _nbytes(args) + out_bytes
                t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
                bound_ms = max(t_ops, t_bytes) * 1e3
                bound_by = "operations" if t_ops > t_bytes else "bytes"
                lib = "—" if library_ms is None else f"{library_ms:.4f} ms{lib_prof}"
                log(f"[kernel] {kname:19s} {label:16s} {str(dtype)[6:]:8s} "
                    f"shape {tuple(args[0].shape)} max_abs_err "
                    f"{' '.join(f'{e:.3e}' for e in errs)} of max |ref| "
                    f"{' '.join(f'{m:.3e}' for m in scales)} ‖Δ‖/‖ref‖ "
                    f"{' '.join(f'{r:.3e}' for r in rels)} (atol, rtol, limit {tols}) "
                    f"kernel {ms:.4f} ms{prof}  plain {plain_ms:.4f} ms  "
                    f"library {lib} ({what})  bound {bound_ms:.4f} ms by "
                    f"{bound_by} ({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
                if recorded:
                    record[kname] = dict(max_abs_err=max(errs), ms=ms,
                                         plain_ms=plain_ms, library_ms=library_ms,
                                         bound_ms=bound_ms, bound_by=bound_by)
    return record


def phase_kernels() -> dict:
    """Phase 3: the forward kernels K1-K3 (the shapes of the slide geometry,
    batch 4)."""
    return check_kernels({
        # slice shapes at bs4 384²: 64 windows × 16 heads of 49 tokens, D=64;
        # 4 × 16 heads over the 24×24 grid; K/V sampling of 64 maps of 28²
        "window": window_cases(64, 1),
        "flash": flash_cases(64, 3),
        "bilinear_sample": sample_cases(64, 5),
    })


def phase_backward_kernels() -> dict:
    """Phase 3b: the backward kernels K4-K6 at the train step's shapes
    (batch 8 of 384²: 128 windows × 16 heads, 8 × 16 heads over the 24×24
    grid, K/V sampling of 128 maps of 28²) and at edge shapes."""
    return check_kernels({
        "window_bwd": window_cases(128, 11, bwd=True),
        "flash_bwd": flash_cases(128, 13, bwd=True),
        "bilinear_sample_bwd": sample_cases(128, 15, bwd=True),
    })


def phase_large_window_kernels() -> dict:
    """Phase 3d: K1L and K7 at single windows of 129×3, 130×7 and 130×32
    grids (16 heads, D = 64), and at the shape the 2080² path gives them
    (16 heads over the 130² grid, N = 16,900: the bias holds 4.57e9 > 2^31
    fp32 elements, 18.3 GB), which is the record; and, called directly, at
    the shapes and inputs of phases 3 and 3b's K1 and K4 (RVSA's windows of
    N = 49), which times the routing's fork: K1/K4 where they fit, K1L/K7
    only where the backward needs K7."""
    N = 130 * 130
    inputs = path_window_inputs(1, 16, N, 64, 50)
    cases = {}
    for key, bwd, W, seed in (("window_large", False, 64, 1),
                              ("window_bwd_qblk", True, 128, 11)):
        cases[key] = [(f"{h}x{w}", large_window_case(1, 16, h * w, 64, 40 + h + w, bwd))
                      for h, w in ((129, 3), (130, 7), (130, 32))]
        cases[key].append((f"W={W} N=49", large_window_case(W, 16, 49, 64, seed, bwd,
                                                            library=False)))
        cases[key].append(("path 130x130", large_window_case(1, 16, N, 64, None, bwd,
                                                             path_inputs=inputs)))
    del inputs
    record = check_kernels(cases, record_label="path 130x130")
    del cases
    free()
    time_fork()
    return record


def time_fork() -> None:
    """The routing's fork at RVSA's windows, in bf16: K1 against K1L at
    W = 64 and K4 against K7 at W = 128 (16 heads, N = 49, D = 64; the
    inputs of phases 3/3b's slice rows and of phase 3d's "W=… N=49" rows),
    each kernel timed twice in the order large, small, small, large, as
    back-to-back calls of its wrapper and as device time (`graph_ms`: a
    wrapper call at N = 49 takes longer on the host than the kernel)."""
    for W, seed, bwd, small, large in ((64, 1, False, "K1", "K1L"),
                                       (128, 11, True, "K4", "K7")):
        a = window_case(W, 16, 49, 64, seed, bwd)
        b = large_window_case(W, 16, 49, 64, seed, bwd, library=False)
        a_args, b_args = a.args(torch.bfloat16), b.args(torch.bfloat16)
        with torch.no_grad():
            run_a, run_b = (lambda: a.kernel(*a_args)), (lambda: b.kernel(*b_args))
            for what, timer in (("back-to-back calls", loop_ms),
                                ("CUDA-graph device time", graph_ms)):
                tb0, ta0, ta1, tb1 = (timer(f) for f in (run_b, run_a, run_a, run_b))
                ta, tb = (ta0 + ta1) / 2, (tb0 + tb1) / 2
                log(f"[fork] W={W} N=49 bf16, {what}: {small} {ta:.4f} ms ({ta0:.4f}, "
                    f"{ta1:.4f}), {large} {tb:.4f} ms ({tb0:.4f}, {tb1:.4f}): "
                    f"{large} / {small} {tb / ta:.2f}")


def phase_dcnv3_kernels() -> dict:
    """Phase 3c: K8, K3 and K6 at P = 9 and gc = 16 as InternImage-XL's
    train step at batch 8 of 512² runs them: stage 0 (12 groups → BG 96,
    128² maps) and stage 3 (96 groups → BG 768, 16² maps), each at
    init-like integer coordinates and at random offsets, and stage 0 at
    large offsets (past the tiled backward's regions); the record is
    stage 0 at random offsets, where a trained model samples.  And stage 3
    of the classification (224²: 7×7 maps) and change-detection (256²: 8×8)
    paths at batch 8, random offsets: maps smaller than one 16×16 tile of
    K6's tiled body, every region cut by the map's edges; controls at
    7×7."""
    cases = {}
    for key, bwd in (("dcnv3_fwd", False), ("dcnv3_bwd", True)):
        cases[key] = [
            (f"stage{s} {kind}", dcnv3_case(8, hw, G, 16, 30 + s + (kind == "init"), kind,
                                            bwd, record=(s, kind) == (0, "random")))
            for s, hw, G in ((0, 128, 12), (3, 16, 96))
            for kind in ("init", "random")]
        cases[key].append(("stage0 large", dcnv3_case(8, 128, 12, 16, 33, "large", bwd)))
        cases[key] += [(f"stage3 {hw}x{hw} random", dcnv3_case(8, hw, 96, 16, 34 + hw,
                                                               "random", bwd,
                                                               record=hw == 7))
                       for hw in (7, 8)]
    return check_kernels(cases, record_label="stage0 random")


# ----------------------------------------------------------- phase 4 / 8 --

def build_model(path: Path, hw: Tuple[int, int]) -> Segmentor:
    """The recipe's full-width model for hw images (the ViT's `pos_embed`
    and full-attention tables are sized by its token grid), seeded random
    weights, on the CPU."""
    model = Segmentor(path.recipe.backbone, path.recipe.num_classes, input_hw=hw)
    return init_weights(model, _gen(SEED)).eval()


@torch.no_grad()
def phase_logits(path: Path, model_cpu: Segmentor) -> None:
    hw = path.cpu_hw
    x = torch.randn((1, *hw, 3), generator=_gen(SEED + 1))
    t0 = time.perf_counter()
    ref = model_cpu.predict(x)
    t_cpu = time.perf_counter() - t0
    model_gpu = copy.deepcopy(model_cpu).cuda()
    reset_counters()
    got = model_gpu.predict(x.cuda()).cpu()
    launched = counters()
    if launched != path.per_forward:
        raise AssertionError(f"launch counts {launched} != {path.per_forward}")
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite logits on the card")
    abs_err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    rel = abs_err / scale
    log(f"[logits {path.name}] fp32 logits {tuple(got.shape)} of one {hw[0]}×{hw[1]} image, "
        f"card vs CPU: max_abs_err {abs_err:.3e}, max |logit| {scale:.3e}, "
        f"normalised {rel:.3e} (tol {SLICE_TOL}); CPU forward {t_cpu:.1f} s; "
        f"launches {launched}")
    if not rel <= SLICE_TOL:
        raise AssertionError(f"card logits disagree with the CPU: {rel:.3e}")


# ----------------------------------------------------------- phase 5 / 9 --

@torch.no_grad()
def phase_serving(path: Path, model_cpu: Segmentor, card: str) -> dict:
    recipe = path.recipe
    model = copy.deepcopy(model_cpu).cuda()
    task = SegmentationTask(recipe, model=model)
    images = torch.randn((path.tiles, path.tile, path.tile, 3),
                         generator=_gen(SEED + 2)).cuda()
    predict = task.predict_fn()
    n_crops = len(slide_origins(path.tile, path.tile, recipe.slide.crop,
                                recipe.slide.stride))
    autocast = lambda: torch.autocast("cuda", dtype=torch.bfloat16)
    tag = f"[serve {path.name}]"

    torch.cuda.synchronize()
    reset_counters()
    with autocast():
        pred = predict(images)
    torch.cuda.synchronize()
    launched = counters()
    want = {k: n * n_crops for k, n in path.per_forward.items()}
    log(f"{tag} launches in one predict ({n_crops} crops): {launched}, expected "
        f"{want} (per crop forward {path.per_forward})")
    if launched != want:
        raise AssertionError(f"launch counts {launched} != {want}")
    if pred.shape != (path.tiles, path.tile, path.tile) or not (
            (pred >= 0) & (pred < recipe.num_classes)).all():
        raise AssertionError(f"bad predictions {tuple(pred.shape)}")

    with autocast():
        logits = task.slide_logits(images)
    if logits.shape != (path.tiles, path.tile, path.tile, recipe.num_classes) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"bad slide logits {tuple(logits.shape)}")
    agree = (logits.argmax(-1) == pred).float().mean().item()
    logits32 = task.slide_logits(images)
    drift = ((logits - logits32).abs().max() / logits32.abs().max()).item()
    log(f"{tag} bf16 slide logits {tuple(logits.shape)} finite; argmax "
        f"agreement with predict {agree:.6f}; bf16 vs fp32 normalised max "
        f"diff {drift:.3e}")
    if agree < 0.999 or drift > 0.1:
        raise AssertionError(f"bf16 slide path off: agree {agree}, drift {drift}")
    del logits, logits32

    for _ in range(2):
        with autocast():
            predict(images)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters, times = path.serve_iters, []
    for _ in range(iters):
        t0 = time.perf_counter()
        with autocast():
            predict(images)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    per = statistics.median(times)
    flops = path.flops(recipe.slide.crop) * path.tiles * n_crops
    log(f"{tag} {recipe.backbone.name} UperNet slide: {path.tiles} tiles of "
        f"{path.tile}², crop {recipe.slide.crop} stride {recipe.slide.stride} "
        f"({n_crops} crops a tile, each crop forward at batch {path.tiles}), bf16 "
        f"autocast: median {per * 1e3:.2f} ms per predict over {iters} (min "
        f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), "
        f"{path.tiles / per:.3f} tiles/s, backbone {flops / per / 1e12:.2f} "
        f"TFLOP/s, peak memory {peak / 2 ** 30:.3f} GiB | card {card}")
    return launched


# ---------------------------------------------------------- phase 6 / 10 --

def synthetic_batch(n: int, hw: Tuple[int, int], num_classes: int, seed: int) -> dict:
    """n seeded images of hw and labels that depend on the image (a channel
    averaged over 32×32 blocks — 16×16 where 32 does not divide hw — cut
    into `num_classes` equally likely bins, so the sanity run has something
    to learn), with a band of ignored pixels (255)."""
    H, W = hw
    b = 32 if H % 32 == 0 and W % 32 == 0 else 16
    rng = np.random.default_rng(seed)
    image = rng.standard_normal((n, H, W, 3)).astype(np.float32)
    coarse = image[..., 0].reshape(n, H // b, b, W // b, b).mean((2, 4))
    bins = [statistics.NormalDist(0.0, 1 / b).inv_cdf(i / num_classes)
            for i in range(1, num_classes)]
    label = np.repeat(np.repeat(np.digitize(coarse, bins), b, 1), b, 2)
    label = label.astype(np.int64)
    label[:, :, :16] = 255
    return {"image": image, "label": label}


def _loss_and_grads(cfg: TaskConfig, model, batch: dict, device: str,
                    stochastic: bool, task_cls=SegmentationTask
                    ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """One loss.backward() of the task's loss on `device`: the loss and every
    parameter's gradient (on the CPU).  `stochastic` turns dropout and
    drop-path on, the masks drawn on the CPU from one seed for every run."""
    task = task_cls(cfg, model=model, device=device)
    masks = _gen(SEED + 4) if stochastic else None
    loss, _ = task.loss_fn(model, {k: v.to(device) for k, v in batch.items()},
                           masks, deterministic=not stochastic)
    loss.backward()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def _grad_verdict(path: Path, ref: tuple, got: tuple) -> Tuple[bool, str]:
    """(within the tolerance, summary) of a run's (loss, gradients) against
    the CPU's, by the rule above GRAD_RTOL."""
    (loss_ref, g_ref), (loss, g) = ref, got
    rtol = path.grad_rtol
    group = lambda n: "convs" if n.startswith(path.head_prefixes) else "backbone"
    g_all = math.sqrt(sum(float(x.square().sum()) for x in g_ref.values()))
    ratios = {k: [] for k in rtol}
    above = []  # the ratios of the gradients above the absolute floor
    bad = []
    for name, r in g_ref.items():
        grp = group(name)
        diff, norm = float((g[name] - r).norm()), float(r.norm())
        ratios[grp].append((diff / max(norm, 1e-30), name))
        if norm > GRAD_ATOL * g_all:
            above.append((diff / norm, grp, name))
        if not diff <= rtol[grp] * norm + GRAD_ATOL * g_all:
            bad.append((name, diff, norm))
    loss_rel = abs(loss - loss_ref) / abs(loss_ref)
    global_rel = math.sqrt(sum(float((g[n] - r).square().sum())
                               for n, r in g_ref.items())) / g_all
    ok = loss_rel <= LOSS_RTOL and not bad
    return ok, (
        f"loss rel {loss_rel:.3e} (tol {LOSS_RTOL}); all {len(g_ref)} gradients "
        f"‖Δ‖/‖g‖ {global_rel:.3e} (‖g_all‖ {g_all:.3e}); per parameter ‖Δg‖/‖g‖ "
        f"min / median / max: " + ", ".join(
            f"{grp} {min(x)[0]:.3e} / {statistics.median(r for r, _ in x):.3e} / "
            f"{max(x)[0]:.3e} at {max(x)[1]}" for grp, x in ratios.items())
        + "; largest where ‖g‖ > the floor: " + ", ".join(
            f"{grp} {r:.3e} at {n}" for r, grp, n in sorted(above, reverse=True)[:3])
        + f"; {len(bad)} of {len(g_ref)} parameters outside rtol·‖g‖ + "
        f"{GRAD_ATOL}·‖g_all‖, rtol {rtol} (convs: {path.head_prefixes})"
        + (f", e.g. {[(n, f'{d:.3e}', f'{m:.3e}') for n, d, m in bad[:4]]}" if bad else ""))


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def phase_gradients(path: Path, model_cpu: Segmentor) -> None:
    """One fp32 loss.backward() of the recipe's model on the card and on the
    CPU, same weights and batch: train-mode BatchNorm, the recipe's remat,
    if any, deterministic unless `grad_stochastic`.  Then the control: the
    card run again with TF32 matmuls and convolutions (10-bit mantissas
    where fp32 has 23), a run of lower precision, which the same rule must
    find outside the tolerance, or the tolerance could not tell."""
    recipe = path.recipe
    cfg = dataclasses.replace(recipe, backbone=dataclasses.replace(
        recipe.backbone, dtype="float32"))
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
        path.grad_batch, path.cpu_hw, recipe.num_classes, SEED + 3).items()}
    if path.grad_stochastic:
        # RVSA's K/V sampling is piecewise bilinear: its gradient w.r.t. a
        # tap's coordinates jumps where a coordinate crosses an integer, and
        # the card and the CPU compute the regressors' coordinates with
        # other rounding, so near an integer they take the two one-sided
        # derivatives, both valid.  At the strip's geometry (19 windows,
        # coordinates up to 132 px) enough taps do that to move the
        # gradients of the blocks below them past 1e-3.  Zeroed regressors
        # put every tap on the identity grid, whose coordinates both
        # devices compute bit for bit from the same constants, so both take
        # the same one-sided derivative; the regressors' own gradients are
        # still compared.
        with torch.no_grad():
            for name, p in model_cpu.named_parameters():
                if ".attn.sampling_" in name:
                    p.zero_()
    what = (f"fp32 batch {path.grad_batch} of {path.cpu_hw[0]}×{path.cpu_hw[1]}"
            + (", dropout + drop-path on, identity sampling" if path.grad_stochastic
               else ""))
    check_gradients(path, cfg, model_cpu, batch, SegmentationTask, what)


def check_gradients(path, cfg: TaskConfig, model_cpu, batch: dict, task_cls,
                    what: str) -> None:
    """The card-vs-CPU gradient check of `phase_gradients` for any task
    (`path` gives name, per_step, grad_stochastic and head_prefixes), and
    its TF32 control."""
    model_gpu = copy.deepcopy(model_cpu).cuda()
    tag = f"[grads {path.name}]"
    runs = {}
    for device, model in (("cpu", model_cpu), ("cuda", model_gpu)):
        reset_counters()
        t0 = time.perf_counter()
        runs[device] = _loss_and_grads(cfg, model, batch, device, path.grad_stochastic,
                                       task_cls)
        if device == "cuda":
            torch.cuda.synchronize()
            launched = counters()
        log(f"{tag} {device}: loss {runs[device][0]:.6f} forward+backward "
            f"{time.perf_counter() - t0:.1f} s")
    if launched != path.per_step:
        raise AssertionError(f"launch counts {launched} != {path.per_step}")
    ok, summary = _grad_verdict(path, runs["cpu"], runs["cuda"])
    log(f"{tag} {what}, card vs CPU: {summary}; launches {launched}")
    _tf32(True)
    try:
        control = _loss_and_grads(cfg, model_gpu, batch, "cuda", path.grad_stochastic,
                                  task_cls)
    finally:
        _tf32(False)
    control_ok, control_summary = _grad_verdict(path, runs["cpu"], control)
    log(f"{tag} control, the card with TF32 on, vs CPU: {control_summary}")
    if not ok:
        raise AssertionError(f"card gradients disagree with the CPU: {summary}")
    if control_ok:
        raise AssertionError("the TF32 control passed the gradient tolerance")


# ---------------------------------------------------------- phase 7 / 11 --

def cycle(batches):
    while True:
        yield from batches


def phase_train(path: Path, card: str) -> dict:
    """The recipe's train step through the task's entry points."""
    recipe = path.recipe
    crop, K = recipe.backbone.img_size, recipe.num_classes
    batch_size = recipe.train.batch_size
    tag = f"[train {path.name}]"
    task = SegmentationTask(recipe)
    t0 = time.perf_counter()
    state = task.init_state(_gen(SEED))
    opt = recipe.train.optimizer
    log(f"{tag} init_state (CPU init, copy to the card, optimizer) "
        f"{time.perf_counter() - t0:.1f} s; recipe lr {opt.lr} wd "
        f"{opt.weight_decay} layer decay {opt.layer_decay} clip {opt.clip_norm}, "
        f"schedule {recipe.train.schedule}, remat {recipe.backbone.remat}, "
        f"drop-path {recipe.backbone.drop_path_rate}")
    batches = [synthetic_batch(batch_size, (crop, crop), K, SEED + 10 + i)
               for i in range(4)]
    logs = []
    log_fn = lambda i, m: logs.append(m)

    torch.cuda.synchronize()
    reset_counters()
    state, m = task.fit(state, cycle(batches), 1, log_every=1, log_fn=log_fn)
    torch.cuda.synchronize()
    launched = counters()
    log(f"{tag} launches in one train step: {launched}, expected "
        f"{path.per_step}; metrics {m}")
    if launched != path.per_step:
        raise AssertionError(f"launch counts {launched} != {path.per_step}")

    if path.warm_steps:
        state, _ = task.fit(state, cycle(batches), path.warm_steps, log_every=1,
                            log_fn=log_fn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logs.clear()
    state, _ = task.fit(state, cycle(batches), path.train_steps, log_every=1,
                        log_fn=log_fn)
    peak = torch.cuda.max_memory_allocated()
    for m in logs:
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"non-finite train metrics {m}")
    step_ms = [m["step_time"] * 1e3 for m in logs]
    per = statistics.median(step_ms)
    data_ms = statistics.median(m["data_time"] * 1e3 for m in logs)
    flops = 3 * path.flops(crop) * batch_size
    log(f"{tag} recipe train step, batch {batch_size} of {crop}², bf16 "
        f"autocast, dropout + drop-path on: median {per:.2f} ms/step over "
        f"{len(step_ms)} (min {min(step_ms):.2f}, max {max(step_ms):.2f}), "
        f"{batch_size / per * 1e3:.3f} images/s, data_time median {data_ms:.3f} "
        f"ms, backbone ~{flops / per / 1e9:.2f} TFLOP/s (3× forward), peak "
        f"memory {peak / 2 ** 30:.3f} GiB; loss {logs[0]['loss']:.4f} → "
        f"{logs[-1]['loss']:.4f}, grad_norm {logs[-1]['grad_norm']:.4f}, "
        f"step {state.step}, lr {state.optimizer.schedule(state.optimizer.count - 1):.3e} "
        f"| card {card}")

    n, size = path.eval_tiles
    tiles = {"image": np.random.default_rng(SEED + 20).standard_normal(
        (n, size, size, 3)).astype(np.float32),
        "label": np.random.default_rng(SEED + 21).integers(0, K, (n, size, size))}
    metrics = task.evaluate(state, iter([tiles]))
    log(f"{tag} evaluate (slide {recipe.slide}, {n} tile(s) of {size}²): "
        f"mIoU {metrics['mIoU']:.3f} mAcc {metrics['mAcc']:.3f} aAcc "
        f"{metrics['aAcc']:.3f}")
    if not all(0.0 <= metrics[k] <= 100.0 for k in ("mIoU", "mAcc", "aAcc")):
        raise AssertionError(f"bad evaluate metrics {metrics}")

    # sanity check, not the recipe: the recipe's warmup starts at ~1e-11, so
    # a fixed batch at a constant 1e-4 shows that the step learns
    sanity_steps = SANITY_STEPS
    sanity = dataclasses.replace(recipe, train=dataclasses.replace(
        recipe.train, optimizer=dataclasses.replace(opt, lr=1e-4),
        schedule=ScheduleConfig(kind="constant")))
    task = SegmentationTask(sanity, model=task.model)
    state = task.init_state(_gen(SEED))
    logs.clear()
    task.fit(state, cycle(batches[:1]), sanity_steps, log_every=1, log_fn=log_fn)
    losses = [m["loss"] for m in logs]
    log(f"{tag} sanity (not the recipe): fixed batch, constant lr 1e-4, "
        f"{sanity_steps} steps, loss {' '.join(f'{x:.4f}' for x in losses)}")
    if not min(losses[-3:]) < losses[0]:
        raise AssertionError(f"the loss did not fall on a fixed batch: {losses}")
    return launched


# ------------------------------------------------------- phases 16-18 --

@dataclasses.dataclass(frozen=True)
class TaskPath:
    """A classification or change-detection recipe's model at full width
    and depth, and what phases 16-17 drive it at.  `batch` counts images
    (classification) or pairs (change detection); a pair's forward runs
    the backbone once over both epochs, so the launches per forward are
    those of one backbone pass whatever the batch."""

    name: str
    recipe: TaskConfig
    task: type                           # ClassificationTask / ChangeDetectionTask
    flops: Callable[[int], float]        # backbone forward FLOPs of one image
    per_forward: Dict[str, int]
    per_step: Dict[str, int]
    batch: int                           # the train step's
    grad_rtol: Dict[str, float] = dataclasses.field(default_factory=lambda: GRAD_RTOL)
    # what `check_gradients` reads, as it reads a `Path`'s
    head_prefixes: ClassVar[Tuple[str, ...]] = ("decode_head.",)  # the "convs" group
    grad_stochastic: ClassVar[bool] = False

    @property
    def crop(self) -> int:
        return self.recipe.backbone.img_size

    @property
    def cd(self) -> bool:
        return self.task is ChangeDetectionTask


VIT_FWD = launches(window=20, flash=4, bilinear_sample=40)
VIT_STEP = launches(window=20, flash=4, bilinear_sample=40, window_bwd=20, flash_bwd=4,
                    bilinear_sample_bwd=40)
XL_FWD = launches(bilinear_sample=39)
XL_STEP = launches(bilinear_sample=78, bilinear_sample_bwd=39)  # remat: K3 twice
CLS_VIT, CLS_XL = vit_rvsa_l_224_eurosat(), intern_xl_224_eurosat()
CD_VIT, CD_XL = rvsa_l_unet_256_levir(), intern_xl_unet_256_levir()
# batch 8 of 224²: the recipes' 8 a GPU × 8 ranks, on one rank (BASELINE.md's
# ViT-L datum is at this batch); batch 4 pairs of 256²: the recipes' 4 a GPU
# × 8 ranks, on one rank (data parallel is not ported)
TASK_PATHS = {
    "cls_vit": TaskPath("cls_vit", CLS_VIT, ClassificationTask,
                        lambda crop: backbone_flops(CLS_VIT.backbone, (crop, crop)),
                        VIT_FWD, VIT_STEP, batch=8),
    "cls_xl": TaskPath("cls_xl", CLS_XL, ClassificationTask,
                       lambda crop: internimage_flops(internimage_config(CLS_XL.backbone),
                                                      crop),
                       XL_FWD, XL_STEP, batch=8),
    "cd_vit": TaskPath("cd_vit", CD_VIT, ChangeDetectionTask,
                       lambda crop: backbone_flops(CD_VIT.backbone, (crop, crop)),
                       VIT_FWD, VIT_STEP, batch=4, grad_rtol=GRAD_RTOL_CD),
    "cd_xl": TaskPath("cd_xl", CD_XL, ChangeDetectionTask,
                      lambda crop: internimage_flops(internimage_config(CD_XL.backbone), crop),
                      XL_FWD, XL_STEP, batch=4),
}


def task_batch(path: TaskPath, n: int, seed: int) -> dict:
    """n seeded images (classification: labels from the image's mean of
    channel 0, cut into the recipe's equally likely classes) or n seeded
    pairs (change detection: change where epoch b's channel 0 exceeds
    epoch a's over 16×16 blocks, a band of ignored pixels), something to
    learn for the sanity runs."""
    rng = np.random.default_rng(seed)
    H = path.crop
    if not path.cd:
        image = rng.standard_normal((n, H, H, 3)).astype(np.float32)
        K = path.recipe.num_classes
        bins = [statistics.NormalDist(0.0, 1 / H).inv_cdf(i / K) for i in range(1, K)]
        return {"image": image, "label": np.digitize(image[..., 0].mean((1, 2)), bins)}
    a, b = (rng.standard_normal((n, H, H, 3)).astype(np.float32) for _ in range(2))
    d = (b[..., 0] - a[..., 0]).reshape(n, H // 16, 16, H // 16, 16).mean((2, 4))
    label = np.repeat(np.repeat((d > 0).astype(np.int64), 16, 1), 16, 2)
    label[:, :, :16] = 255
    return {"image_a": a, "image_b": b, "label": label}


def _forward(model, batch: dict, device: str):
    """The eval-mode forward of a task's model on a batch: logits."""
    t = {k: torch.as_tensor(v).to(device) for k, v in batch.items() if k != "label"}
    return model(t["image_a"], t["image_b"]) if "image_a" in t else model(t["image"])


def build_task_model(path: TaskPath):
    """The recipe's full-width model, seeded random weights, on the CPU."""
    return init_weights(path.task(path.recipe, device="cpu").model, _gen(SEED)).eval()


@torch.no_grad()
def phase_task_logits(path: TaskPath, model_cpu) -> None:
    """fp32 logits of 2 images (one pair) on the card against the CPU,
    and for change detection the bf16 logits' distance from the fp32 ones,
    of the whole model under autocast and of the UNet alone under autocast
    on the fp32 backbone's features (the head-precision reading)."""
    batch = task_batch(path, 1 if path.cd else 2, SEED + 1)
    t0 = time.perf_counter()
    ref = _forward(model_cpu, batch, "cpu")
    t_cpu = time.perf_counter() - t0
    model = copy.deepcopy(model_cpu).cuda()
    reset_counters()
    got = _forward(model, batch, "cuda").cpu()
    launched = counters()
    if launched != path.per_forward:
        raise AssertionError(f"launch counts {launched} != {path.per_forward}")
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite logits on the card")
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    log(f"[logits {path.name}] fp32 logits {tuple(got.shape)} card vs CPU: max_abs_err "
        f"{err:.3e}, max |logit| {scale:.3e}, normalised {err / scale:.3e} (tol "
        f"{SLICE_TOL}); CPU forward {t_cpu:.1f} s; launches {launched}")
    if not err / scale <= SLICE_TOL:
        raise AssertionError(f"card logits disagree with the CPU: {err / scale:.3e}")
    if not path.cd:
        return
    a, b = (torch.as_tensor(batch[k]).cuda() for k in ("image_a", "image_b"))
    bf16 = lambda: torch.autocast("cuda", dtype=torch.bfloat16)
    with bf16():
        whole16 = model(a, b).float()
    fused = [model._fuse(f[:1], f[1:]) for f in model.backbone(torch.cat([a, b]))]
    head32 = model.decode_head(fused)
    with bf16():
        head16 = model.decode_head(fused).float()
    for what, x, ref32 in (("whole model", whole16, got.cuda()),
                           ("UNet alone on the fp32 features", head16, head32)):
        gap = ((x - ref32).abs().max() / ref32.abs().max()).item()
        rel = ((x - ref32).norm() / ref32.norm()).item()
        agree = (x.argmax(-1) == ref32.argmax(-1)).float().mean().item()
        log(f"[logits {path.name}] bf16 autocast vs fp32, {what}: normalised max diff "
            f"{gap:.3e}, ‖Δ‖/‖fp32‖ {rel:.3e}, argmax agreement {agree:.6f}")


def phase_cd_gradients(path: TaskPath, model_cpu) -> None:
    """Phase 17's fp32 gradients, card vs CPU, of the change detector at one
    pair (train-mode BatchNorm, no dropout or drop-path), phase 6's rule,
    and its TF32 control."""
    cfg = dataclasses.replace(path.recipe, backbone=dataclasses.replace(
        path.recipe.backbone, dtype="float32"))
    batch = {k: torch.from_numpy(v) for k, v in task_batch(path, 1, SEED + 3).items()}
    check_gradients(path, cfg, model_cpu, batch, ChangeDetectionTask,
                    f"fp32 1 pair of {path.crop}²")


def phase_task_train(path: TaskPath, card: str):
    """The recipe's train step through the task's entry points: launches,
    ms/step, throughput, data_time and peak memory; evaluate on 2 batches;
    a fixed-batch sanity run whose loss must fall.  Returns the model (its
    weights the sanity run's)."""
    recipe, tag = path.recipe, f"[train {path.name}]"
    unit = "pairs" if path.cd else "images"
    task = path.task(recipe)
    t0 = time.perf_counter()
    state = task.init_state(_gen(SEED))
    opt = recipe.train.optimizer
    log(f"{tag} init_state {time.perf_counter() - t0:.1f} s; recipe lr {opt.lr} layer "
        f"decay {opt.layer_decay}, {recipe.train.schedule.total_steps} steps "
        f"({recipe.train.schedule.warmup_steps} warm-up), remat {recipe.backbone.remat}, "
        f"drop-path {recipe.backbone.drop_path_rate}")
    batches = [task_batch(path, path.batch, SEED + 10 + i) for i in range(4)]
    logs = []
    log_fn = lambda i, m: logs.append(m)
    torch.cuda.synchronize()
    reset_counters()
    state, m = task.fit(state, cycle(batches), 1, log_every=1, log_fn=log_fn)
    torch.cuda.synchronize()
    launched = counters()
    log(f"{tag} launches in one train step: {launched}, expected {path.per_step}; "
        f"metrics {m}")
    if launched != path.per_step:
        raise AssertionError(f"launch counts {launched} != {path.per_step}")
    state, _ = task.fit(state, cycle(batches), TASK_WARM_STEPS, log_every=1, log_fn=log_fn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logs.clear()
    state, _ = task.fit(state, cycle(batches), TASK_TRAIN_STEPS, log_every=1,
                        log_fn=log_fn)
    peak = torch.cuda.max_memory_allocated()
    for m in logs:
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"non-finite train metrics {m}")
    step_ms = [m["step_time"] * 1e3 for m in logs]
    per = statistics.median(step_ms)
    data_ms = statistics.median(m["data_time"] * 1e3 for m in logs)
    images = path.batch * (2 if path.cd else 1)
    log(f"{tag} recipe train step, batch {path.batch} {unit} of {path.crop}², bf16 "
        f"autocast, drop-path on: median {per:.2f} ms/step over {len(step_ms)} (min "
        f"{min(step_ms):.2f}, max {max(step_ms):.2f}), {path.batch / per * 1e3:.3f} "
        f"{unit}/s, data_time median {data_ms:.3f} ms, backbone "
        f"~{3 * path.flops(path.crop) * images / per / 1e9:.2f} TFLOP/s (3× forward), "
        f"peak memory {peak / 2 ** 30:.3f} GiB; loss {logs[0]['loss']:.4f} → "
        f"{logs[-1]['loss']:.4f}, grad_norm {logs[-1]['grad_norm']:.4f}, step "
        f"{state.step} | card {card}")

    evals = [task_batch(path, 1 if path.cd else path.batch, SEED + 20 + i)
             for i in range(2)]
    metrics = task.evaluate(state, iter(evals))
    if path.cd:
        pred = task.predict_fn()(*(torch.as_tensor(evals[0][k]).cuda()
                                   for k in ("image_a", "image_b")))
        if pred.shape != (1, path.crop, path.crop) or not ((pred >= 0) & (pred < 2)).all():
            raise AssertionError(f"bad change map {tuple(pred.shape)}")
        shown = ("F1_change", "mIoU", "aAcc")
    else:
        shown = ("top1", "top5")
    log(f"{tag} evaluate ({len(evals)} batches): "
        + " ".join(f"{k} {metrics[k]:.3f}" for k in shown))
    if not all(0.0 <= metrics[k] <= 100.0 for k in shown):
        raise AssertionError(f"bad evaluate metrics {metrics}")

    sanity = dataclasses.replace(recipe, train=dataclasses.replace(
        recipe.train, optimizer=dataclasses.replace(opt, lr=1e-4),
        schedule=ScheduleConfig(kind="constant")))
    sane = path.task(sanity, model=task.model)
    logs.clear()
    sane.fit(sane.init_state(_gen(SEED)), cycle(batches[:1]), SANITY_STEPS, log_every=1,
             log_fn=log_fn)
    losses = [m["loss"] for m in logs]
    log(f"{tag} sanity (not the recipe): fixed batch, constant lr 1e-4, "
        f"{SANITY_STEPS} steps, loss {' '.join(f'{x:.4f}' for x in losses)}")
    if not min(losses[-3:]) < losses[0]:
        raise AssertionError(f"the loss did not fall on a fixed batch: {losses}")
    return task.model


def run_task_path(path: TaskPath, card: str):
    """Phase 16 (classification) or 17 (change detection) for one recipe;
    returns the trained model."""
    free()
    with phase_time(f"{path.name} models"):
        model_cpu = build_task_model(path)
    with phase_time(f"{path.name} logits"):
        phase_task_logits(path, model_cpu)
    if path.name == "cd_vit":
        free()
        with phase_time(f"{path.name} gradients"):
            phase_cd_gradients(path, model_cpu)
    del model_cpu
    free()
    with phase_time(f"{path.name} train"):
        model = phase_task_train(path, card)
    return model


def _state_snapshot(state) -> dict:
    """Everything a checkpoint holds, copied to the host."""
    return {"step": state.step, "count": state.optimizer.count,
            "model": {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()},
            "moments": {n: tuple(t.detach().cpu().clone() for t in mv)
                        for n, mv in state.optimizer.moments().items()},
            "generator": state.generator.get_state().clone()}


def _load_snapshot(state, snap: dict, zero_moments: bool = False) -> None:
    state.model.load_state_dict(snap["model"])
    moments = snap["moments"]
    if zero_moments:
        moments = {n: tuple(torch.zeros_like(t) for t in mv) for n, mv in moments.items()}
    state.optimizer.load_moments(snap["count"], moments)
    state.generator.set_state(snap["generator"])
    state.step = snap["step"]


def _update(task, state, batch: dict) -> torch.Tensor:
    """One train step; its parameter update (after − before), flattened."""
    before = torch.cat([p.detach().reshape(-1).clone() for p in state.model.parameters()])
    state, _ = task.fit(state, iter([batch]), 1)
    after = torch.cat([p.detach().reshape(-1) for p in state.model.parameters()])
    return after - before


def phase_checkpoint(vit_cls_backbone, card: str) -> None:
    """Phase 18 on the XL classification path, whose step runs K6's fp32
    atomics: `fit` 3 steps with a CheckpointStore (ckpt_every 2) and an
    encoder path; step 2 restored into a fresh task equals, bit for bit,
    the state the run held at step 2 (the model's parameters and buffers,
    the Adam moments, count, step and generator); one step from the
    restored state against one from a second in-process copy of the step-2
    state, by their parameter updates (K6 is not deterministic in its last
    bits, so not bitwise); the control, the copy's moments zeroed, must
    fail.  Then the ViT-L classifier's encoder (224², phase 16) is exported
    and loaded into the 256² change detector (`load_encoder`,
    `backbone_state_dict`) and one change-detection forward runs."""
    path, tag = TASK_PATHS["cls_xl"], "[ckpt]"
    batches = [task_batch(path, path.batch, SEED + 30 + i) for i in range(4)]
    with tempfile.TemporaryDirectory(prefix="mtp_chip_smoke_") as tmp:
        store = CheckpointStore(os.path.join(tmp, "ckpt"))
        task = ClassificationTask(path.recipe)
        state = task.init_state(_gen(SEED))
        snap = {}
        keep = lambda i, m: snap.setdefault("s", _state_snapshot(state)) if i == 1 else None
        t0 = time.perf_counter()
        state, _ = task.fit(state, cycle(batches), 3, log_every=1, log_fn=keep, ckpt=store,
                            ckpt_every=2, encoder_path=os.path.join(tmp, "encoder.pth"))
        steps = store.steps()
        log(f"{tag} fit 3 steps with saves at {steps} and the encoder artifact "
            f"({os.path.getsize(os.path.join(tmp, 'encoder.pth')) / 2 ** 20:.1f} MiB): "
            f"{time.perf_counter() - t0:.1f} s")
        if steps != [2, 3]:
            raise AssertionError(f"checkpoints at {steps}, expected [2, 3]")
        snap = snap["s"]
        del task, state
        free()
        fresh = ClassificationTask(path.recipe)
        t0 = time.perf_counter()
        restored = store.restore(fresh.init_state(_gen(SEED + 99)), step=2)
        got = _state_snapshot(restored)
        bad = [k for k in snap["model"] if not torch.equal(got["model"][k], snap["model"][k])]
        bad += [n for n in snap["moments"] if not all(
            torch.equal(a, b) for a, b in zip(got["moments"][n], snap["moments"][n]))]
        same_gen = torch.equal(got["generator"], snap["generator"])
        log(f"{tag} restore of step 2 into a fresh task {time.perf_counter() - t0:.1f} s: "
            f"{len(snap['model'])} model tensors and {len(snap['moments'])} parameters' "
            f"moments, {len(bad)} differ; step {got['step']}, count {got['count']}, "
            f"generator state equal {same_gen}")
        if bad or not same_gen or (got["step"], got["count"]) != (2, 2):
            raise AssertionError(f"restored state differs: {bad[:4]}, step {got['step']}, "
                                 f"count {got['count']}, generator {same_gen}")
        batch = batches[2]
        u_restored = _update(fresh, restored, batch)
        _load_snapshot(restored, snap)
        u_copy = _update(fresh, restored, batch)
        rel = ((u_restored - u_copy).norm() / u_copy.norm()).item()
        bitwise = torch.equal(u_restored, u_copy)
        _load_snapshot(restored, snap, zero_moments=True)
        u_ctrl = _update(fresh, restored, batch)
        ctrl = ((u_ctrl - u_copy).norm() / u_copy.norm()).item()
        log(f"{tag} step 3 from the restored state vs from an in-process copy of step "
            f"2: ‖Δu‖/‖u‖ {rel:.3e} (tol {RESUME_RTOL}; bitwise {bitwise}); control, "
            f"the copy's Adam moments zeroed: {ctrl:.3e} (must exceed the tol)")
        if not rel <= RESUME_RTOL:
            raise AssertionError(f"the resumed step differs: {rel:.3e}")
        if ctrl <= RESUME_RTOL:
            raise AssertionError(f"the zeroed-moments control passed: {ctrl:.3e}")
        store.close()
        del fresh, restored, u_restored, u_copy, u_ctrl
        free()

        enc = os.path.join(tmp, "vit_l_224_encoder.pth")
        save_encoder(enc, vit_cls_backbone)
        sd = backbone_state_dict(load_encoder(enc, CLS_VIT.backbone), CD_VIT.backbone,
                                 features_only=True)
        cd = ChangeDetectionTask(CD_VIT)
        cd_state = cd.init_state(_gen(SEED), pretrained_backbone=sd)
        src = vit_cls_backbone.state_dict()
        same = torch.equal(cd_state.model.backbone.blocks[5].attn.qkv.weight.cpu(),
                           src["blocks.5.attn.qkv.weight"])
        pair = task_batch(TASK_PATHS["cd_vit"], 1, SEED + 40)
        with torch.no_grad(), cd.autocast():
            out = _forward(cd_state.model.eval(), pair, "cuda").float()
        grids = [cfg.backbone.img_size // 16 for cfg in (CLS_VIT, CD_VIT)]
        log(f"{tag} ViT-L classifier encoder (grid {grids[0]}) → rvsa-l-unet-256 "
            f"(grid {grids[1]}): "
            f"pos_embed {tuple(sd['pos_embed'].shape)}, full-block rel-pos "
            f"{tuple(sd['blocks.5.attn.full_attn_rel_pos_h'].shape)}, window tables "
            f"{tuple(sd['blocks.0.attn.rel_pos_h'].shape)}, {len(sd)} tensors (FPN "
            f"dropped); loaded weights equal {same}; one CD forward {tuple(out.shape)} "
            f"finite {bool(torch.isfinite(out).all())}")
        side = 2 * CD_VIT.backbone.img_size  # the UNet ends at twice the input
        if not same or out.shape != (1, side, side, 2) or not torch.isfinite(out).all():
            raise AssertionError("the exported encoder did not load into the detector")


@contextlib.contextmanager
def phase_time(what: str):
    """Logs the wall time the block took."""
    t0 = time.perf_counter()
    yield
    log(f"[time] {what} {time.perf_counter() - t0:.1f} s")


def free() -> None:
    """Release what earlier phases left, so that each phase's peak memory
    is its own."""
    gc.collect()
    torch.cuda.empty_cache()


def run_path(path: Path, card: str) -> dict:
    """Phases 4-7 (ViT), 8-11 (InternImage) or 12-15 (ViT at 2080²):
    {"serve": launches of one predict, "train": launches of one train
    step}."""
    free()
    crop = path.recipe.backbone.img_size
    with phase_time(f"{path.name} models"):
        model = build_model(path, (crop, crop))
        # the ViT's pos_embed and full-attention tables are sized by the token
        # grid: a card-vs-CPU image of another shape needs a model of its own
        sized = not is_internimage(path.recipe.backbone) and path.cpu_hw != (crop, crop)
        model_cpu = build_model(path, path.cpu_hw) if sized else model
    with phase_time(f"{path.name} logits"):
        phase_logits(path, model_cpu)
    with phase_time(f"{path.name} serve"):
        served = phase_serving(path, model, card)
    del model
    free()
    with phase_time(f"{path.name} gradients"):
        phase_gradients(path, model_cpu)
    del model_cpu
    free()
    with phase_time(f"{path.name} train"):
        trained = phase_train(path, card)
    return {"serve": served, "train": trained}


def main() -> None:
    card = phase_device()
    phase_build()
    record = {}
    for name, phase in (("3", phase_kernels), ("3b", phase_backward_kernels),
                        ("3c", phase_dcnv3_kernels), ("3d", phase_large_window_kernels)):
        with phase_time(f"kernels {name}"):
            record.update(phase())
    runs = {name: run_path(path, card) for name, path in PATHS.items()}
    for name, path in TASK_PATHS.items():
        trained = run_task_path(path, card)
        if name == "cls_vit":  # phase 18 exports its encoder
            vit_cls_backbone = trained.backbone.cpu()
        del trained
    with phase_time("checkpoint"):
        phase_checkpoint(vit_cls_backbone, card)
    kernels = []
    for key, meta in KERNELS.items():
        path, kind, counter = LAUNCHED_IN[key]
        kernels.append(dict(meta, launches=runs[path][kind][counter], **record[key]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
