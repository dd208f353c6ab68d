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
crops with remat, at its first 6 blocks (the full-attention block over the
130² token grid runs the window-attention function over one window of
16,900 tokens: K1L forward, K7 backward); then the classification, change-detection and
checkpoint phases, the two Faster R-CNN recipes at 800² (K1-K6 or K8,
and N1, the port's greedy-NMS kernel), the two Oriented R-CNN recipes
at 800² (the same, and R1, the port's rotated-IoU kernel), the two Mask
R-CNN recipes at 1024² and the two RetinaNet recipes at 416² (K1-K6 or
K8, and N1), and the two multitask pretraining recipes
mtp_vit_l_rvsa_448_samrs and mtp_internimage_xl_448_samrs (ViT-L+RVSA or
InternImage-XL at 448², 3 datasets × semantic segmentation, Mask R-CNN and
Oriented R-CNN: K1-K6 or K8, N1 and R1), and the ViT recipe again through the CLI, trained, resumed and
evaluated from PNG files on disk (K1-K6), and three recipes' serving
artifacts exported and served without model code (phase 27).

Phases; any failure raises, so the exit code is non-zero:
1. device: the card's name and power limit; TF32 off for the fp32 phases.
2. build: compile the kernels from mtp_tpu_torch/csrc/ (nvcc, sm_90a); the
   registers and spills of every kernel (ptxas), and the HMMA/HGMMA count of
   the tensor-core kernels' SASS (cuobjdump, dumped beside phases 3 and 3b
   and read after them); the bf16 K2/K5, K1L/K7 and
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
   the same function where there is one, in bf16 (the fp32 rows are held,
   not timed), each a run of back-to-back calls
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
3e. N1, greedy NMS: the keep indices and scores of `nms_batched` (or
   `batched_nms`) on the card must equal those of the plain version
   `nms_ref`, on the card and on the CPU, exactly, at the RPN's shape at
   800² (B = 2, N = 8,382 → 1,000 at IoU 0.7, the record) and the
   predict's (B = 2, N = 1,000 → 100 at 0.5, 20 classes), each with a
   control (the kernel at thr − 0.01 must give other keep sets), and at N
   = 130, every box invalid, equal scores, and a pair at IoU exactly 0.7
   (kept at 0.7, suppressed at 0.69); the pairs whose IoU lies within one
   fp32 ulp of the threshold are counted and named; the kernel timed back
   to back and as device time, beside its plain version and its bound;
   also timed at phase 23's RPN (B = 1, N = 6,735 at 448²), phase 21's
   (B = 2, N = 8,768 at 1024²) and the predicts of phases 21 and 22 (1,000
   candidates of 80 and of 60 classes).  At each timed shape the two halves
   are held on their own: the mask kernel's words equal `nms_mask_ref`'s
   bit for bit, and the scan's keep mask equals `nms_scan_ref`'s from the
   kernel's own words, with a control (the bit by which a kept row alone
   removes a box of a later tile, cleared, must make the check fail); the
   time is split into the mask kernel and the scan (torch.profiler).
3g. R1, rotated IoU (csrc/rotated_iou.cu), against its plain version
   `rbox_overlaps_ref` on the card in fp32 and float64 (R1_TOL), over the
   pairs of boxes of non-zero area: the edge cases (identical boxes, one
   inside another, a shared edge, half overlap, a 90°-rotated copy, a
   zero-width box, θ at ±π/2, a pair after class 19's offset, a disjoint
   pair); the dense form at the assigner's shape (100 padded gts × 1,100
   proposals); at the predict's (2 × 2,000 candidates of 20 classes after
   `class_offset_boxes`, centres up to ~4·10⁴ px) the dense IoUs, the mask
   form's bits against the plain IoU > 0.1 (any differing bit must lie
   within R1_TOL of 0.1), and the keep sets of `batched_nms` against
   `nms_ref` on the card (differing decisions counted, the
   first of each image traced to a pair within R1_TOL); controls: the
   IoUs × 0.9 must fail, and the mask form at 0.09 must keep other boxes;
   a built case whose every same-class pair lies ≥ 1e-3 from its
   threshold keeps, index for index, what `nms_ref` keeps on the card and
   the CPU; the pairs R1's early exit takes (`rbox_apart`, the kernel's
   test) counted at every dense case, their float64 plain IoU and the
   kernel's all exactly 0; the mask form's scan held to `nms_scan_ref` on
   its own words, with the control of phase 3e; times of both forms, their
   plain versions and bounds (the work the early exit leaves, beside the
   count without it), the mask form split into its kernel and the scan.
3f. K1-K6 and K8 at the 800² detection paths' shapes (batch 2: K1/K4 over
   128 windows of 49 tokens, K2/K5 over 32 heads of the 50×50 grid,
   K3/K6 over 32 maps of 56², K8 at XL's 200² stage 0 and 25² stage 3),
   held as phase 3's rows (K1-K6 there not timed, K8 timed); then K1-K6,
   held and timed, at phase 21's 1024² (the 64² grid padded to 70²: K1/K4
   over 200 windows, K2/K5 over N = 4,096, K3/K6 on 70² maps), phase 22's
   416² (26² padded to 28²: 32 windows, N = 676, 28² maps) and phase 23's
   448² (3 images of the 28² grid: 48 windows, 48 heads of N = 784, 48
   maps of 28²); and K8 forward and backward at the stage maps of the XL
   paths of phases 21-23 (random offsets): 1024² at batch 2 (256², 128²,
   64², 32²), timed, and 416² at batch 2 (104², 52², 26², 13²) and 448² at
   batch 3 (112², 56², 28², 14²), held, not timed.
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
   img_size 2080, remat on, batch 1, slide crop 2080), its ViT-L cut to
   the first 6 blocks, one of them full: logits and fp32
   gradients (remat, dropout and drop-path on, the masks drawn on the CPU
   for both runs) card vs CPU at a 2080×112 strip (grid 130×7, N = 910: K1L and K7 on the
   card); serving one 2080² tile (one crop); the train
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
18. Checkpointing on the XL classifier: `fit` 2 steps with a
   `CheckpointStore` (its final save) and the encoder export; step 2 restored
   into a fresh task bit for bit; the next step from it against one from
   an in-process copy of step 2 (by their updates, RESUME_RTOL), with a
   control whose Adam moments are zeroed; the ViT-L classifier's encoder
   (224²) loaded into the 256² change detector and run.
19. Detection, for faster_rcnn_rvsa_l_800_mae_mtp_dior (ViT-L+RVSA, the
   last block tapped 4 times) and faster_rcnn_intern_xl_800_imp_mtp_dior
   (InternImage-XL, remat) in turn: for XL (the ViT's are phase 21's, on
   the same modules) fp32 FPN levels, RPN scores and deltas
   of 2 images of an 800×128 strip card vs CPU, and the box head's
   outputs on the CPU's proposals (SLICE_TOL); fp32 gradients at the strip
   card vs CPU with the TF32 control (phase 6's rule, XL's backbone at
   rtol 5e-3; both sides take the CPU's proposals, its max-pool picks and
   one CPU generator's sampler draws); the train step
   at batch 2 of 800² (the recipe's 16 over 8 GPUs) through
   `DetectionTask.init_state` → `fit`: launches (N1 once), ms/step,
   images/s, data_time, peak memory, the busy share and device time by
   kernel group (torch.profiler); `predict_fn` on 2 images (N1 twice),
   ms/image; `evaluate`'s VOC AP50 on seeded synthetic boxes (finite); a
   fixed-batch sanity run whose loss must fall.
20. Rotated detection, oriented_rcnn_rvsa_l_800_mae_mtp_diorr (ViT-L+RVSA)
   and oriented_rcnn_intern_xl_800_imp_mtp_diorr (InternImage-XL): for
   each, fp32 FPN levels, RPN scores and deltas (6 an anchor) and the
   rotated box head's outputs card vs CPU at the strip, and its fp32
   gradients by phase 19's rule (XL's backbone at 5e-3; the CPU's
   proposals, max-pool picks and R-CNN assigner IoUs given to both; the
   TF32 control); for both, the
   train step at batch 1 of 800² (the recipes' 4 = 1 a GPU × 4 ranks):
   launches (N1 and R1's dense form once), ms/step, images/s, data_time,
   peak memory, busy share and kernel groups; `predict_fn` on 2 images
   (N1 and R1's mask form once), ms/image; `evaluate`'s rotated VOC AP50
   on seeded synthetic rotated boxes (finite); a fixed-batch sanity run.
21. Mask R-CNN, mask_rcnn_rvsa_l_1024_mae_mtp_coco (ViT-L+RVSA, the last
   block tapped 4 times → FPN → RPN → box head → FCN mask head, 80
   classes): fp32 FPN levels, RPN outputs, box head and mask logits card vs
   CPU at a 1024×128 strip, and fp32 gradients by phase 19's rule (the
   mask head in the 1e-2 group; box-aligned gt mask crops; the TF32
   control); the train step at batch 2 of 1024² (N1 once, K3 41 times:
   the mask targets' sampling), a predict of 2 images (N1 twice) with
   score_thr 0.001 (`det_overrides`: random weights clear no 0.05), the
   detections each image kept, `paste_masks_device` on the card against
   `paste_masks` on the host (pixels may differ only within 1e-6 of the
   threshold), `evaluate(coco=True)`'s 12 bbox and 12 segm stats (finite),
   and a fixed-batch sanity run.  Then mask_rcnn_intern_xl_1024_imp_mtp_coco
   (InternImage-XL, remat: K8 on maps of 256² to 32²; a step K3 79, K6 39,
   N1 1): the same, but for the strip's gradients (det_xl holds the XL
   trunk's, mask_vit the heads').
22. RetinaNet, retinanet_rvsa_l_416_mae_mtp_xview (ViT-L+RVSA → FPN from
   level 1 with two extra convolutions → the 4-conv RetinaHead, 60
   classes, 32,526 anchors an image): the FPN levels and the head's
   outputs card vs CPU at a 416×128 strip, and fp32 gradients on the CPU's
   anchor assignment (the head in the 1e-2 group; the TF32 control); the
   train step at batch 2 of 416² (no NMS), a predict (N1 once, score_thr
   0.001), VOC AP50, and a fixed-batch sanity run.  Then
   retinanet_intern_xl_416_imp_mtp_xview (InternImage-XL, remat: K8 on maps
   of 104² to 13²) likewise, but for the strip's gradients (det_xl and
   retina_vit hold them).
23. Multitask pretraining, mtp_vit_l_rvsa_448_samrs (ViT-L+RVSA at 448²,
   drop-path 0.1; SAMRS's 19, 21 and 38 classes; one encoder pass over one
   image a dataset, the UperNet trunk and a 1×1 head a dataset, Mask
   R-CNN and Oriented R-CNN with per-dataset final layers): fp32 encoder
   levels, ss logits, both FPNs' levels and RPN outputs, box heads and
   mask logits card vs CPU at a 448×128 strip (SLICE_TOL), and the 30
   named losses (LOSS_RTOL) and fp32 gradients by phase 6's rule (the
   decoders in the 1e-2 group; the CPU's proposals, max-pool picks,
   rotated assigner IoUs and draws given to both; the TF32 control); the
   train step at batch 3 (one image a dataset) through
   `MultiTaskPretrainTask.init_state` → `fit` (with a checkpoint and the
   encoder export): launches, ms/step, images/s, data_time, peak memory,
   busy share and kernel groups; the concatenated detection form
   (det_multi) against the sequential one in fp32 on the card (losses and
   gradients) and its steps timed A B B A beside the sequential form's;
   `evaluate`'s 9-way metrics and a predict's launches; the exported
   encoder loaded into the ViT-L segmentation recipe at 384² and run; a
   fixed-batch sanity run.  Then mtp_internimage_xl_448_samrs (InternImage-
   XL with remat, K8 on maps of 112² to 14²; a step K3 81, K6 39, N1 6, R1
   dense 3) through the same code: the backbone's gradients at 5e-3, as
   phase 19's XL, and its encoder loaded into the XL segmentation recipe
   intern-xl-upernet-512-imp-mtp-loveda at 512².
24. The CLI from disk (`phase_cli`): rvsa-l-upernet-384-mae-mtp-spacenetv1
   trained and evaluated from a SpaceNet-layout dataset this phase writes
   (16 train and 4 val RGB PNG tiles of 512², labels in {0, 1}) through
   `mtp_tpu_torch.cli.train` / `cli.test`'s `main(argv)` in this process:
   6 steps at batch 8 with 4 fork workers (forked after CUDA is up),
   checkpoints every 3 steps, the encoder export and --eval-after;
   --resume to 8 steps (exactly 2 trained); `cli.test --ckpt` on the
   step-6 checkpoint (its mIoU equal to --eval-after's) with --save-pred;
   the training again with 0 workers; the native host library built and
   loaded.  Launches exact in each run; step_time, data_time (4 and 0
   workers), the checkpoint saves' and each run's wall times.
25. Data parallel (`phase_ddp`, after phase 7, from its state): the DDP
   step (`parallel.mesh`) of rvsa-l-upernet-384-mae-mtp-spacenetv1, batch 8
   of 384²: (a) in this process, in an NCCL group of one rank over a
   FileStore, the bf16 step's ms with and without the process group, the
   all-reduce's ms and bytes, then 2 fp32 steps through the DDP step
   against 2 through the plain one (phase 6's rule; launches exact) at
   identity RVSA sampling without dropout; (b) two spawned processes on
   the card over gloo, 4 rows each of the same global batches, from a
   checkpoint this process writes as rank 0: the ranks' states bit for bit
   equal, rank 0's first gradients within phase 6's rule of (b)'s
   arithmetic emulated in one process (`split_grads`, whose distance from
   (a) is printed), within phase 6's stochastic rule of (a)'s
   (`two_ranks_rule`), and a control in which rank 1 keeps its own
   gradients, which must fail; every first compared step, in (a), (b), 26
   and both emulations, takes the max-pool picks of one forward of the
   whole batch (`compared_picks`).  25c
   (`phase_carafe`): `MaskHead(upsample="carafe")` at 512 RoIs × 256 × 14²,
   card vs CPU, logits and gradients.  25d (`phase_patch8`): the patch-8
   ViT-B+RVSA at a 384×128 strip, card vs CPU, levels and gradients, K1-K6
   launches exact.
26. The model axis (`phase_tp`; `parallel.tensor`): phase 25's two rank
   processes, after (b), as a data 1 × model 2 mesh over gloo on the card
   (8 of the 16 heads a rank, qkv 1,536 rows, MLP 2,048), the recipe's task
   built at `MeshConfig(data=1, model=2)` in fp32 while they sit idle and
   phase 7's state restored from its whole-layout checkpoint (after (b)):
   a gathered save of that state, before any step, bit for bit phase 7's
   checkpoint; DDP_STEPS fp32 steps, the first held by phase 6's rule (the
   gathered gradients and rank 1's partial ones) and grad_norm (1e-5) to
   the model axis's arithmetic emulated in this process
   (`emulated_model_axis`), and all against (a)'s one-rank steps from the
   same state (losses 1e-5; the gradients, grad_norm and the whole state
   after by `two_ranks_rule`, as 25(b): this state's gradients move ~1e-3
   under any change of summation order, the emulation's distance printed);
   launches a rank equal to one rank's; the loss on seeded row-parallel
   biases against one rank's; controls that must fail (rank 1's partial
   gradients before the model-group sum; the row-parallel bias added on
   both ranks);
   an fp32 sliding-window evaluate against one rank's (pixels may differ
   only where the top two logits lie within TIE_GAP); peak memory and the
   bf16 step's ms a rank beside (a)'s step without a group.  Gloo routes
   each all-reduce through the host: no NCCL time is measured.  Phase 3
   also holds K1 and K4 at this path's 128 windows × 8 heads.
27. The serving artifact (`phase_export`; `cli.export`, `serving`,
   `kernels/ops.py`): three recipes, each from the seeded weights of its
   earlier phase saved as a variables file, exported on the card by
   `python -m mtp_tpu_torch.cli.export` in three processes started once
   phase 3b has ended (`ExportJobs`: the traces, single-threaded host work
   that launches no kernel, run beside phases 3c-3f; the predict traced by
   `torch.export`, the forward kernels registered ops):
   rvsa-l-upernet-384-mae-mtp-spacenetv1 on one 384² crop (K1 20, K2 4, K3
   40; the 4-crop slide graph of a 512² tile traced in 56-75 s, so it is
   left to the CPU tests), oriented_rcnn_rvsa_l_800_mae_mtp_diorr on one
   800² image (K1-K3, N1 and R1's mask form once each) and
   intern-xl-224-imp-mtp_eurosat at batch 2 (K8 39).  At the end of the
   run, for each artifact a process that imports only
   `mtp_tpu_torch.serving` loads it on the card and serves once, the three
   at once, while this process builds the same seeded models; then the
   live predicts on seeded inputs (launches exact), and the served calls
   one process at a time: the outputs held to the live ones
   (`served_verdict`: bit for bit, else the rule named), the launches
   equal to the live call's, the modules free of model code, and a control
   (the backbone's first patch-embedding weight × 0.9) that must fail; the
   export s, artifact MB, load s and served ms beside live ms (median of
   5, each ended by a sync).
Every path runs its recipe's backbone at full depth but the 2080² path
(phases 12-15), which runs the ViT-L's first 6 blocks (5 RVSA, 1 full).
Registry recipes only: every path takes its recipe through
`mtp_tpu_torch.configs.get` under the JAX package's name.  Phase 3f also
holds the kernels at the shapes of the registry's OSCD 96² recipes
(`phase_oscd_kernels`: the ViT's 6² grid, one padded 7² window an image,
full attention over N = 36; XL's K8 on 24², 12², 6² and 3² stage maps),
not timed, with controls.
The last lines are the total time, the kernels' JSON record, the card, and
the result line.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import io
import json
import math
import queue
import re
import signal
import statistics
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path as FilePath
from unittest import mock
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, ClassVar, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from mtp_tpu_torch import configs
from mtp_tpu_torch.ckpt import from_jax
from mtp_tpu_torch.ckpt.store import CheckpointStore, load_encoder, save_encoder
from mtp_tpu_torch.ckpt.torch_convert import backbone_state_dict
from mtp_tpu_torch.cli import test as cli_test
from mtp_tpu_torch.cli import train as cli_train
from mtp_tpu_torch.core.optim import layer_id_fn_for, make_optimizer, make_schedule
from mtp_tpu_torch.core import train as core_train
from mtp_tpu_torch.core.train import create_state, make_train_step
from mtp_tpu_torch.config import (SAMRS_CLASSES, MeshConfig, ScheduleConfig, SlideConfig,
                                  TaskConfig, vit_b_rvsa,
                                  internimage_config, is_internimage)
from mtp_tpu_torch.data.parsers import mask_to_rle, rle_to_mask
from mtp_tpu_torch.eval import metrics as pmetrics
from mtp_tpu_torch.eval.masks import mask_probabilities, paste_masks, paste_masks_device
from mtp_tpu_torch.eval.slide import slide_origins
from mtp_tpu_torch.heads import upernet as pupernet
from mtp_tpu_torch.heads.roi_heads import MaskHead
from mtp_tpu_torch.heads.rpn import gen_proposals
from mtp_tpu_torch.kernels import _build
from mtp_tpu_torch.models import retinanet as pretina
from mtp_tpu_torch.models.internimage import internimage_flops
from mtp_tpu_torch.models.multitask import MultiTaskPretrainModel
from mtp_tpu_torch.models.segmentor import Segmentor
from mtp_tpu_torch.models.vit_rvsa import ViTRVSA, backbone_flops
from mtp_tpu_torch.ops import dcnv3_sample as dcn
from mtp_tpu_torch.ops import fused_attn
from mtp_tpu_torch.ops import nms as pnms
from mtp_tpu_torch.ops import rotated_boxes as prb
from mtp_tpu_torch.ops.assign import SampleResult
from mtp_tpu_torch.ops.boxes import bbox_overlaps
from mtp_tpu_torch.ops.dcnv3 import sampling_points
from mtp_tpu_torch.parallel import mesh as pmesh
from mtp_tpu_torch.parallel import tensor as ptensor
from mtp_tpu_torch.tasks.change_detection import ChangeDetectionTask
from mtp_tpu_torch.tasks import detection as det_core
from mtp_tpu_torch.tasks.classification import ClassificationTask
from mtp_tpu_torch.tasks import _fit
from mtp_tpu_torch.tasks._fit import to_device
from mtp_tpu_torch.tasks.detection_task import DetectionTask, build_detector, det_config
from mtp_tpu_torch.tasks.multitask import MultiTaskPretrainTask
from mtp_tpu_torch.tasks.segmentation import SegmentationTask
from mtp_tpu_torch.utils import native

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
TASK_WARM_STEPS, TASK_TRAIN_STEPS = 2, 5
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
            "bilinear_sample_bwd", "window_large", "window_bwd_qblk", "nms", "rbox_iou",
            "nms_rotated")


class SeededInit:
    """`from_jax.init_weights` with its last KEEP draws kept.  Its weights are
    a function of the model's modules and the generator's state alone (no
    global random state: every tensor of every recipe's model is drawn), so
    a model of modules already drawn from the same generator state takes the
    kept weights, and the generator moves on as the draw would have moved
    it.  A path's first model and its train state's, and the CLI's runs,
    draw the same weights: each such draw took 2-4 s of one host thread.
    InternImage trunks are drawn first (`from_jax._init_internimage`), from
    the generator's state at the draw's start: the last trunk drawn is kept
    too, so that every XL model drawn from the same seed (the segmentor,
    the classifier, the change detector, the four detectors, the multitask
    model) copies one drawn trunk and draws only its own heads."""

    KEEP = 3
    # PyTorch's random initialisers, which module constructors call
    RANDOM_INITS = ("uniform_", "normal_", "trunc_normal_", "kaiming_uniform_",
                    "kaiming_normal_", "xavier_uniform_", "xavier_normal_")

    def __init__(self):
        self.kept: Dict[tuple, Tuple[Dict[str, torch.Tensor], torch.Tensor]] = {}
        self.trunk: Tuple[tuple, Dict[str, torch.Tensor], torch.Tensor] = ((), {}, None)
        self.draw_trunk = from_jax._init_internimage
        self.lock = threading.Lock()  # phases 25c-d draw on a thread
        self.drawing = threading.local()

    def __call__(self, model: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
        with self.lock:
            self.drawing.on = True
            try:
                return self._draw(model, generator)
            finally:
                self.drawing.on = False

    @contextlib.contextmanager
    def constructions_undrawn(self):
        """Within the block PyTorch's random initialisers zero their tensor,
        but inside a draw of this object's: a module's constructor draws
        weights that the draw (or a checkpoint) then replaces, every one of
        them (held on the CPU for every model family the phases build), and
        those draws took ~1.5 s of a host thread a full-size model."""
        real = {n: getattr(torch.nn.init, n) for n in self.RANDOM_INITS}

        def stand_in(name: str):
            def init(tensor, *args, **kwargs):
                if getattr(self.drawing, "on", False):
                    return real[name](tensor, *args, **kwargs)
                with torch.no_grad():
                    return tensor.zero_()
            return init

        with contextlib.ExitStack() as stack:
            for name in self.RANDOM_INITS:
                stack.enter_context(mock.patch.object(torch.nn.init, name, stand_in(name)))
            yield

    @staticmethod
    def _key(model: torch.nn.Module, generator: torch.Generator) -> tuple:
        return (tuple((n, type(m).__name__) for n, m in model.named_modules()),
                tuple((k, tuple(v.shape), v.dtype) for k, v in model.state_dict().items()),
                getattr(getattr(model, "cfg", None), "layer_scale", None),
                generator.get_state().numpy().tobytes())

    def _draw_trunk(self, trunk: torch.nn.Module, generator: torch.Generator) -> None:
        """`from_jax._init_internimage`, or the kept trunk's copy."""
        key = self._key(trunk, generator)
        if self.trunk[0] == key:
            trunk.load_state_dict(self.trunk[1])
            generator.set_state(self.trunk[2])
            return
        self.trunk = ((), {}, None)  # one trunk's tensors at a time
        self.draw_trunk(trunk, generator)
        self.trunk = (key, {k: v.detach().clone() for k, v in trunk.state_dict().items()},
                      generator.get_state())

    def _draw(self, model: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
        if any(t.device.type != "cpu" for t in model.state_dict().values()):
            return from_jax.init_weights(model, generator)
        key = self._key(model, generator)
        drawn = self.kept.pop(key, None)
        if drawn is None:
            with mock.patch.object(from_jax, "_init_internimage", self._draw_trunk):
                from_jax.init_weights(model, generator)
            drawn = ({k: v.detach().clone() for k, v in model.state_dict().items()},
                     generator.get_state())
        else:
            model.load_state_dict(drawn[0])
            generator.set_state(drawn[1])
        self.kept[key] = drawn
        while len(self.kept) > self.KEEP:
            self.kept.pop(next(iter(self.kept)))
        return model


init_weights = SeededInit()


def launches(**nonzero) -> Dict[str, int]:
    """Every launch counter, 0 unless named."""
    return {**dict.fromkeys(COUNTERS, 0), **nonzero}


@dataclasses.dataclass(frozen=True)
class Path:
    """One recipe's model at full width and depth (the 2080² path at its
    first HR_DEPTH blocks), and the geometry each phase drives it at."""

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


def recipe(name: str) -> TaskConfig:
    """The registry's recipe `name` (`mtp_tpu_torch.configs`): every path
    here runs a recipe the registry holds, under the JAX package's name."""
    return configs.get(name).task


RVSA = recipe("rvsa-l-upernet-384-mae-mtp-spacenetv1")
XL = recipe("intern-xl-upernet-512-imp-mtp-loveda")
# the ViT recipe at 2080² crops (2080 = 16·130: a 130² token grid, over the
# 128-per-axis gate of K2) with the JAX field remat on, batch 1, one crop a
# tile: no new recipe, the JAX configs express all of it.  Its ViT-L is cut
# to the first HR_DEPTH blocks, 5 RVSA and 1 full (one window of 16,900
# tokens: K1L forward, K7 backward), the taps spread over them: every kernel
# and module of the path, at a quarter of the 24 blocks' time
HR_CROP, HR_DEPTH = 2080, 6
RVSA_HR = dataclasses.replace(
    RVSA, backbone=dataclasses.replace(
        RVSA.backbone, img_size=HR_CROP, remat=True, depth=HR_DEPTH,
        out_indices=(HR_DEPTH // 4, HR_DEPTH // 2, 3 * HR_DEPTH // 4, HR_DEPTH - 1)),
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
        cpu_hw=(384, 384), tile=512, tiles=4, serve_iters=5, grad_batch=2,
        grad_stochastic=False, head_prefixes=("backbone.fpn", "decode_head."),
        warm_steps=2, train_steps=6, eval_tiles=(2, 512)),
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
        cpu_hw=(256, 256), tile=1024, tiles=2, serve_iters=5, grad_batch=2,
        grad_stochastic=False, head_prefixes=("decode_head.",), warm_steps=2,
        train_steps=4, eval_tiles=(1, 1024)),
    # the ViT recipe at 2080² with remat, its first 6 blocks: per crop
    # forward the full block runs K1L; per train step each block runs
    # forward and recompute (K1 10, K1L 2, K3 20) and K4 5, K7 1, K6 10.
    # Card vs CPU at a 2080×112 strip (the CPU's fp32 forward and backward
    # of a 2080² crop would take far too long), with dropout and drop-path
    # on, at batch 2 as the other paths (at batch 1 the PSP pooling
    # branches' BatchNorm sees 1-9 values of one image per channel, which
    # makes the gradients more sensitive to rounding), and the gradients at
    # identity sampling (see `phase_gradients`) and GRAD_RTOL_STOCHASTIC.  1
    # warm-up step (the counted one) and 3 timed steps.
    "rvsa_hr": Path(
        name="rvsa_hr", recipe=RVSA_HR,
        flops=lambda crop: backbone_flops(RVSA_HR.backbone, (crop, crop)),
        per_forward=launches(window=5, window_large=1, bilinear_sample=10),
        per_step=launches(window=10, window_large=2, bilinear_sample=20,
                          window_bwd=5, window_bwd_qblk=1, bilinear_sample_bwd=10),
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
    # N1: the port's own kernel; JAX runs greedy NMS as lax loops, no pallas_call
    "nms": dict(name="nms", route="cuda", source="mtp_tpu_torch/csrc/nms.cu",
                replaces="mtp_tpu/ops/nms.py:122 (no pallas_call: the lax.fori_loop "
                         "scan of _nms_single_lane)"),
    # R1: the port's own kernel; JAX computes rotated IoU as jnp pair grids
    # and the rotated NMS as N1's lax loops; one record a launch form: the
    # mask form at the predict's shape, the dense form at the assigner's
    "rotated_iou": dict(name="rotated_iou", route="cuda",
                        source="mtp_tpu_torch/csrc/rotated_iou.cu",
                        replaces="mtp_tpu/ops/rotated_boxes.py:116 (no pallas_call: the "
                                 "jnp _intersection_area of rbox_overlaps, run by "
                                 "mtp_tpu/ops/nms.py:122 with iou_fn=rbox_overlaps)"),
    "rotated_iou_dense": dict(name="rotated_iou_dense", route="cuda",
                              source="mtp_tpu_torch/csrc/rotated_iou.cu",
                              replaces="mtp_tpu/ops/rotated_boxes.py:116 (no pallas_call: "
                                       "the jnp _intersection_area of rbox_overlaps, run "
                                       "by the R-CNN assigner, "
                                       "mtp_tpu/tasks/detection.py:235)"),
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
    "nms": ("det_vit", "train", "nms"),
    "rotated_iou": ("det_rot_vit", "predict", "nms_rotated"),
    "rotated_iou_dense": ("det_rot_vit", "train", "rbox_iou"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def counters() -> dict:
    return {**fused_attn.LAUNCHES, **dcn.LAUNCHES, **pnms.LAUNCHES, **prb.LAUNCHES}


def reset_counters() -> None:
    for launched in (fused_attn.LAUNCHES, dcn.LAUNCHES, pnms.LAUNCHES, prb.LAUNCHES):
        launched.update(dict.fromkeys(launched, 0))


@contextlib.contextmanager
def timed_window():
    """A window whose times are reported: the CPU reference worker
    (`References.running`), while one runs, is stopped for the window's
    length, so that its torch threads take no host core from the launches
    being timed.  Windows nest."""
    refs = References.running
    if refs is None or refs.stopped_at is not None:
        yield
        return
    refs.stop()
    try:
        yield
    finally:
        refs.resume()


def loop_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """ms per call of fn: `reps` back-to-back calls between one pair of CUDA
    events, after `warmup` calls, so that a call's host work (the wrapper's
    checks and allocations) overlaps the previous call's device work as it
    does on the main path, and the events' own resolution is spread over
    the run."""
    with timed_window():
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
    with timed_window():
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


def start_sass_dump() -> Tuple[subprocess.Popen, "tempfile._TemporaryFileWrapper"]:
    """`cuobjdump -sass` of the built library, running into a temporary file
    (it takes ~20 s of one host thread: `phase_build` leaves it to run
    beside phases 3 and 3b)."""
    tool = FilePath(_build.find_nvcc()).parent / "cuobjdump"
    out = tempfile.TemporaryFile(mode="w+")
    return subprocess.Popen([str(tool), "-sass", str(_build.LIB)], stdout=out,
                            stderr=subprocess.PIPE, text=True), out


def sass_tensor_core_counts(dump) -> Dict[str, int]:
    """{kernel label: HMMA + HGMMA instructions} of every kernel in the built
    library, from the dump `start_sass_dump` started."""
    proc, out = dump
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"cuobjdump -sass failed ({proc.returncode}): {err[-2000:]}")
    out.seek(0)
    counts, name = {}, None
    for line in out:
        if "Function : " in line:
            name = _build.kernel_label(re.search(r"Function : (\S+)", line)[1])
            counts.setdefault(name, 0)
        elif name and "MMA." in line and re.search(r"\bHG?MMA\.", line):
            counts[name] += 1
    out.close()
    return counts


# the bf16 tensor-core kernels at the main path's head dim (ViT-B and
# ViT-L: 64): K2, K5's two passes, K1L, K7's two passes, K1, K4
TC_MAIN = ("flash_fwd_tc_kernel<64>", "flash_bwd_dq_tc_kernel<64>",
           "flash_bwd_dkv_tc_kernel<64>", "window_attn_fwd_large_tc_kernel<64>",
           "window_bwd_dq_tc_kernel<64>", "window_bwd_dkv_tc_kernel<64>",
           "window_attn_fwd_tc_kernel<64>", "window_attn_bwd_tc_kernel<64>")


def phase_build():
    """Builds the kernels and holds ptxas's report; returns the SASS dump,
    which `check_sass` reads once phase 3b has ended."""
    t0 = time.perf_counter()
    _build.build(force=True)
    _build.lib()
    log(f"[build] {len(_build.sources())} sources from mtp_tpu_torch/csrc, one "
        f"nvcc each in parallel, linked -> "
        f"{_build.LIB.relative_to(_build.PKG.parent)}; flags "
        f"{' '.join(_build.NVCC_FLAGS)}; {time.perf_counter() - t0:.1f} s")
    for line in _build.PTXAS_LOG:
        log(f"[build] {line}")
    for name in TC_MAIN:
        ptxas = [line for line in _build.PTXAS_LOG if line.startswith(name + ":")]
        if len(ptxas) != 1 or "0 bytes spill stores, 0 bytes spill loads" not in ptxas[0]:
            raise AssertionError(f"{name}: ptxas reports spills or nothing: {ptxas}")
    return start_sass_dump()


def check_sass(dump) -> None:
    """Phase 2's SASS reading: every tensor-core kernel's HMMA/HGMMA count,
    and TC_MAIN's must not be 0."""
    counts = sass_tensor_core_counts(dump)
    for name, n in sorted(counts.items()):
        if "_tc_kernel<" in name:
            log(f"[build] SASS {name}: {n} HMMA/HGMMA instructions")
    for name in TC_MAIN:
        if not counts.get(name):
            raise AssertionError(f"{name}: no tensor-core instruction in its SASS")


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
    return Case(torch.ops.mtp.window_attn_fwd.default, fused_attn.fused_window_attention_ref,
                lambda dt: (q.to(dt), k.to(dt), v.to(dt), bias, scale), flops,
                lambda a: _sdpa_library(*a), **extra)


def window_cases(W, seed, bwd=False) -> list:
    """K1 / K4 at the slice shape (W windows × 16 heads of RVSA's 49
    tokens, D = 64; controls; also timed as device time, `graph_ms`: a call
    of the wrapper at N = 49 takes longer on the host than the kernel on
    the card), a ragged edge (N = 25, D = 48), a full 64-token tile with
    nothing masked, D = 40 (the tensor-core wrapper pads it to 48), and
    N = 100, which runs the CUDA-core body in bf16 too; and phase 26's shape,
    the train step's 128 windows at model 2 (8 of the 16 heads a rank)."""
    return [("slice", window_case(W, 16, 49, 64, seed, bwd, controls=True,
                                  device_time=True)),
            ("edge N=25 W=7", window_case(7, 3, 25, 48, seed + 1, bwd)),
            ("full N=64", window_case(16, 16, 64, 64, seed + 2, bwd)),
            ("D=40 padded", window_case(16, 16, 49, 40, seed + 3, bwd)),
            ("N=100 cores", window_case(8, 16, 100, 64, seed + 4, bwd)),
            ("model 2 nH=8", window_case(128, 8, 49, 64, seed + 5, bwd, device_time=True))]


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
    return Case(torch.ops.mtp.window_attn_fwd_large.default, fwd_ref,
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
    return Case(torch.ops.mtp.flash_attn_fwd.default, fwd_ref,
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


def check_kernels(cases: dict, record_label: str = "slice", timed: bool = True) -> dict:
    """Each case's kernel against its plain version on the same inputs, in
    its dtypes (fp32 and bf16 unless it names others), output by output,
    after checking that the kernel call launched the kernel of its key;
    the bf16 rows, the main path's working type, also timed (unless not
    `timed`); returns {kernel: {max_abs_err, ms, plain_ms, library_ms,
    bound_ms, bound_by}} of the `record_label` case in bf16."""
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
                    free(1)  # the cache the last case's 18.3 GB outputs left
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
                free(1)
                if case.deterministic:  # a second launch, against the first's digests
                    with torch.no_grad():
                        again = case.kernel(*args)
                        same = [bits_digest(a) == d for a, d in zip(again, digests)]
                    del again
                    free(1)
                    if not all(same):
                        raise AssertionError(f"{kname} {label} {dtype}: two launches on "
                                             f"the same inputs differ: {same}")
                    log(f"[kernel] {kname} {label} {dtype}: two launches bitwise equal "
                        f"in all {len(same)} outputs (digest of the bits)")
                flops = case.flops(args)
                nbytes = _nbytes(args) + out_bytes
                t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
                bound_ms = max(t_ops, t_bytes) * 1e3
                bound_by = "operations" if t_ops > t_bytes else "bytes"
                if dtype != torch.bfloat16 or not timed:
                    log(f"[kernel] {kname:19s} {label:16s} {str(dtype)[6:]:8s} "
                        f"shape {tuple(args[0].shape)} max_abs_err "
                        f"{' '.join(f'{e:.3e}' for e in errs)} of max |ref| "
                        f"{' '.join(f'{m:.3e}' for m in scales)} ‖Δ‖/‖ref‖ "
                        f"{' '.join(f'{r:.3e}' for r in rels)} (atol, rtol, limit {tols}); "
                        f"not timed; bound {bound_ms:.4f} ms by {bound_by}")
                    continue
                timed_ms = lambda fn: loop_ms(fn, reps=case.reps,
                                              warmup=min(3, case.reps // 4))
                recorded = label == record_label
                device = case.device_time
                graph_note = lambda fn: (f" (CUDA graph: {graph_ms(fn, case.reps):.4f} ms "
                                         f"of device time a call)") if device else ""
                with torch.no_grad():
                    ms = timed_ms(lambda: case.kernel(*args))
                    plain_ms = timed_ms(lambda: case.plain(*args))
                    prof = graph_note(lambda: case.kernel(*args))
                library_ms, what, lib_prof = None, "none", ""
                if case.library is not None:
                    free(1)
                    call, what = case.library(args)
                    library_ms = timed_ms(call)
                    lib_prof = graph_note(call)
                    del call
                    free(1)
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


# ------------------------------------------------------------ phase 3e --

# the RPN's NMS input at 800² and 1024²: min(2000, level size) anchors of
# each level
RPN_N = sum(min(2000, n) for n in det_core.anchor_level_sizes((800, 800)))
RPN_N_1024 = sum(min(2000, n) for n in det_core.anchor_level_sizes((1024, 1024)))
# and at 448², one image: each of phase 23's six RPNs runs on one dataset's
RPN_N_448 = sum(min(2000, n) for n in det_core.anchor_level_sizes((448, 448)))


def clustered_boxes(B: int, N: int, hw: Tuple[int, int], seed: int, copies: int = 3):
    """N boxes an image as an RPN or a box head leaves them, on the CPU: one
    in `copies` drawn over the hw image (sides 8-512 px log-uniform, aspect
    1/2-2), the rest jittered copies of those (centres by 10% of a side,
    sides by 10%), all clipped to the image; uniform scores.  Returns
    (boxes, scores, the index of each box's source box)."""
    g = _gen(seed)
    H, W = hw
    n0 = max(1, N // copies)
    rand = lambda *shape: torch.rand(shape, generator=g)
    side = torch.exp(rand(B, n0) * math.log(64) + math.log(8))
    ratio = torch.exp((rand(B, n0) * 2 - 1) * math.log(2))
    w, h = side * ratio.sqrt(), side / ratio.sqrt()
    cx, cy = rand(B, n0) * W, rand(B, n0) * H
    src = torch.randint(0, n0, (B, N - n0), generator=g)
    w, h, cx, cy = (torch.cat([t, t.gather(1, src)], 1) for t in (w, h, cx, cy))
    jitter = lambda: torch.randn((B, N), generator=g) * 0.1
    cx, cy = cx + w * jitter(), cy + h * jitter()
    w, h = w * (1 + jitter()), h * (1 + jitter())
    boxes = torch.stack([(cx - w / 2).clamp(0, W), (cy - h / 2).clamp(0, H),
                         (cx + w / 2).clamp(0, W), (cy + h / 2).clamp(0, H)], -1)
    return boxes, rand(B, N), torch.cat([torch.arange(n0).expand(B, n0), src], 1)


def nms_near_threshold(boxes_o: torch.Tensor, thr: float) -> Tuple[int, list]:
    """Pairs (i < j) of boxes in score order whose IoU (CPU, `bbox_overlaps`)
    lies within one fp32 ulp of thr: where a card and a CPU that rounded
    differently could decide otherwise.  (count, the first 3 pairs)."""
    ulp = float(np.spacing(np.float32(thr)))
    count, pairs = 0, []
    b = boxes_o.cpu()
    for img in range(b.shape[0]):
        for r0 in range(0, b.shape[1], 512):
            iou = bbox_overlaps(b[img, r0:r0 + 512], b[img])
            rows = torch.arange(r0, r0 + iou.shape[0])[:, None]
            near = ((iou - thr).abs() <= ulp) & (torch.arange(b.shape[1])[None] > rows)
            count += int(near.sum())
            for i, j in near.nonzero()[:3 - len(pairs)].tolist():
                pairs.append((img, r0 + i, j, float(iou[i, j])))
    return count, pairs


def launch_keep(launcher: str, boxes_o: torch.Tensor, scores_o: torch.Tensor,
                thr: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The suppression words (B, N, ⌈N/64⌉), zeroed before the launch, and
    the keep mask of N1 (`mtp_nms`) or R1's mask form (`mtp_nms_rotated`)
    launched directly: the wrapper keeps its mask to itself.  Not counted: a
    check, not the main path."""
    B, N, _ = boxes_o.shape
    scratch, lists_at, keep = pnms.keep_scratch(B, N, boxes_o.device)
    words = (N + pnms.NMS_TILE - 1) // pnms.NMS_TILE
    mask = scratch[:B * N * words].view(B, N, words)
    mask.zero_()
    at = scratch.data_ptr()
    _build.launch(launcher, boxes_o.data_ptr(), scores_o.data_ptr(), at, at + 8 * lists_at,
                  keep.data_ptr(), B, N, float(thr), _build.dtype_code(boxes_o))
    torch.cuda.synchronize()
    return mask, keep


def unpack_words(words: torch.Tensor, n: int) -> torch.Tensor:
    """(..., W) int64 suppression words → (..., n) bool bits."""
    shifts = torch.arange(64, device=words.device)
    return ((words[..., None] >> shifts) & 1).bool().flatten(-2)[..., :n]


def check_scan(label: str, mask: torch.Tensor, keep: torch.Tensor,
               scores_o: torch.Tensor) -> None:
    """The scan on its own, apart from IoU rounding: the keep mask a launch
    wrote equals `nms_scan_ref`'s from the words the same launch wrote.
    Control: the bit by which a kept row alone removes a row of a later
    tile, cleared, must give another keep mask, and the check must then
    fail."""
    want = pnms.nms_scan_ref(mask, scores_o)
    if not torch.equal(keep, want):
        raise AssertionError(f"scan {label}: the keep mask differs from nms_scan_ref's on the "
                             f"kernel's own words at {int((keep != want).sum())} boxes")
    N = mask.shape[1]
    col = torch.arange(N, device=mask.device)
    for b in range(mask.shape[0]):
        rows = keep[b].nonzero()[:, 0]
        if not len(rows):
            continue
        by_kept = unpack_words(mask[b, rows], N)                      # (kept, N)
        first = rows[by_kept.int().argmax(0)]                         # a kept suppressor of each box
        sole = ((by_kept.sum(0) == 1) & ~keep[b]
                & (first // pnms.NMS_TILE < col // pnms.NMS_TILE)).nonzero()[:, 0]
        if len(sole):
            break
    else:
        raise AssertionError(f"scan {label}: no box removed by one kept row of an earlier "
                             f"tile alone, no control")
    j = int(sole[0])
    i, w = int(first[j]), j // pnms.NMS_TILE
    cleared = mask.clone()
    cleared[b, i, w] &= ~(torch.ones((), dtype=torch.int64, device=mask.device)
                          << (j % pnms.NMS_TILE))
    other = pnms.nms_scan_ref(cleared, scores_o)
    if torch.equal(keep, other):
        raise AssertionError(f"scan {label}: the control (bit {j} of row {i} cleared) passed")
    log(f"[nms] scan {label}: the kernel's keep mask equals nms_scan_ref's on its own words "
        f"({int(keep.sum())} kept); control, image {b}: the bit by which kept row {i} alone "
        f"removes row {j} (tile {w}) cleared -> rejected ({int((other != keep).sum())} "
        f"decisions differ)")


def kernel_split_ms(fn, reps: int = 10, tries: int = 3) -> Dict[str, float]:
    """Device ms a call of each kernel group that fn launches (torch.profiler,
    the card's activity, over `reps` calls after one), as phases 19-23 read
    them (`kernel_group`); a window in which the profiler saw no kernel is
    taken again, up to `tries` times."""
    fn()
    torch.cuda.synchronize()
    cuda, out = torch.autograd.DeviceType.CUDA, {}
    for _ in range(tries):
        with timed_window(), \
                torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == cuda and not getattr(e, "is_user_annotation", False):
                group = kernel_group(e.name)
                out[group] = out.get(group, 0.0) + e.device_time_total / 1e3 / reps
        if out:
            break
    return out


def nms_case(label: str, boxes, scores, thr: float, max_out: int, labels=None,
             control: bool = False, timed: bool = False) -> Optional[dict]:
    """N1 through `nms_batched` (or `batched_nms` with labels) on the card
    against the plain version `nms_ref` on the card and on the CPU, same
    inputs: keep indices and scores equal.  `control`: the kernel's keep
    mask at thr - 0.01 must differ from the plain version's at thr (the
    top-`max_out` outputs may hide the difference when more boxes are kept
    than `max_out`).  `timed`: the kernel (`nms_keep`, both
    launches, on the boxes in score order) back to back and as device time,
    its plain version `nms_keep_ref` on the card, `nms_batched` whole, and
    the bound; returns the record."""
    cuda = lambda t: None if t is None else t.cuda()
    bc, sc, lc = cuda(boxes), cuda(scores), cuda(labels)
    shift = lambda b, l: b if l is None else pnms.class_offset_boxes(b, l)
    if labels is None:
        run = lambda t: pnms.nms_batched(bc, sc, t, max_out)
    else:
        run = lambda t: pnms.batched_nms(bc, sc, lc, t, max_out)
    before = counters()
    idx, out = run(thr)
    torch.cuda.synchronize()
    moved = {k: n - before[k] for k, n in counters().items() if n != before[k]}
    if moved != {"nms": 1}:
        raise AssertionError(f"N1 {label}: launched {moved}, expected one nms")
    ref_card = pnms.nms_ref(shift(bc, lc), sc, thr, max_out)
    ref_cpu = pnms.nms_ref(shift(boxes, labels), scores, thr, max_out)
    _, boxes_o, scores_o = pnms._score_order(shift(bc, lc), sc)
    near, pairs = nms_near_threshold(boxes_o, thr)
    kept = int((out > pnms.NEG_INF / 2).sum())
    same = {where: torch.equal(idx.cpu(), r[0].cpu()) and torch.equal(out.cpu(), r[1].cpu())
            for where, r in (("card", ref_card), ("CPU", ref_cpu))}
    log(f"[nms] {label}: B {bc.shape[0]} N {bc.shape[1]} thr {thr} max_out {max_out}: "
        f"{kept} kept; indices and scores equal to nms_ref on the card {same['card']}, "
        f"on the CPU {same['CPU']}; pairs within 1 ulp of thr {near} {pairs}")
    if not all(same.values()):
        raise AssertionError(f"N1 {label} differs from nms_ref: {same}; pairs within one "
                             f"ulp of the threshold: {near} {pairs}")
    boxes_o, scores_o = boxes_o.contiguous(), scores_o.contiguous()
    valid = scores_o > pnms.NEG_INF / 2
    keep_ref = pnms.nms_keep_ref(boxes_o, valid, thr)
    if control:
        keep_low = pnms.nms_keep(boxes_o, scores_o, thr - 0.01)
        if torch.equal(keep_low, keep_ref):
            raise AssertionError(f"N1 {label}: the control at thr {thr - 0.01} passed")
        log(f"[nms] control {label}, the kernel at thr {thr - 0.01:.2f} -> rejected "
            f"({int(keep_low.sum())} kept against {int(keep_ref.sum())} at {thr})")
    if not timed:
        return None
    keep = pnms.nms_keep(boxes_o, scores_o, thr)
    if not torch.equal(keep, keep_ref):
        raise AssertionError(f"N1 {label}: the keep mask differs from nms_keep_ref")
    # the two halves on their own: the mask words bit for bit, then the scan
    mask_k, keep_k = launch_keep("mtp_nms", boxes_o, scores_o, thr)
    mask_ref = pnms.nms_mask_ref(boxes_o, thr)
    if not torch.equal(mask_k, mask_ref):
        raise AssertionError(f"N1 {label}: {int((mask_k != mask_ref).sum())} mask words differ "
                             f"from nms_mask_ref's")
    log(f"[nms] mask {label}: {mask_k.numel()} words equal to nms_mask_ref's bit for bit "
        f"({int(unpack_words(mask_k, mask_k.shape[1]).sum())} bits set)")
    check_scan(f"N1 {label}", mask_k, keep_k, scores_o)
    del mask_k, mask_ref
    ms = loop_ms(lambda: pnms.nms_keep(boxes_o, scores_o, thr))
    dev = graph_ms(lambda: pnms.nms_keep(boxes_o, scores_o, thr))
    split = kernel_split_ms(lambda: pnms.nms_keep(boxes_o, scores_o, thr))
    plain_ms = loop_ms(lambda: pnms.nms_keep_ref(boxes_o, valid, thr), reps=3, warmup=1)
    whole = loop_ms(lambda: run(thr))
    B, N = scores_o.shape
    pos = torch.arange(N, device=keep.device)
    pairs_needed = int(((N - 1 - pos) * keep).sum())  # (kept i, every later j)
    flops = 14 * pairs_needed
    nbytes = B * N * (16 + 4) + B * N
    t_ops, t_bytes = flops / PEAK_FLOPS[torch.float32], nbytes / PEAK_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops > t_bytes else "bytes"
    log(f"[kernel] nms {label}: kernel {ms:.4f} ms (CUDA graph: {dev:.4f} ms of device "
        f"time a call; mask {B * N * ((N + 63) // 64) * 8 / 1e6:.1f} MB)  plain "
        f"(nms_keep_ref on the card) {plain_ms:.4f} ms  library none (torchvision is "
        f"absent)  bound {bound_ms:.4f} ms by {bound_by} ({pairs_needed} pairs with a "
        f"kept first box, {flops / 1e9:.4f} GFLOP fp32, {nbytes / 1e6:.3f} MB); "
        f"{'batched_nms' if labels is not None else 'nms_batched'} whole (sort, N1, "
        f"top {max_out}) {whole:.4f} ms; split (torch.profiler, device ms a call): mask "
        f"{split.get('N1 mask', 0.0):.4f}, scan {split.get('NMS scan (N1, R1)', 0.0):.4f}")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_nms_kernel() -> dict:
    """Phase 3e: N1 at the RPN's shape (B = 2, N = 8,382 → 1,000 at 0.7, the
    record) and the predict's (B = 2, N = 1,000 → 100 at 0.5, 20 classes
    through `batched_nms`), both with controls; N = 130 (not a multiple of
    the 64-box tile), every box invalid, equal scores, and a pair at IoU
    exactly 0.7."""
    B = 2
    boxes, scores, _ = clustered_boxes(B, RPN_N, (800, 800), 70)
    record = nms_case(f"rpn {B}x{RPN_N}", boxes, scores, 0.7, 1000, control=True,
                      timed=True)
    # the box head's candidates: ~10 boxes an object, each object's class
    boxes, scores, src = clustered_boxes(B, 1000, (800, 800), 71, copies=10)
    labels = torch.randint(0, 20, (B, 1000), generator=_gen(72)).gather(1, src)
    nms_case(f"predict {B}x1000 20 classes", boxes, scores, 0.5, 100, labels,
             control=True, timed=True)
    boxes, scores, _ = clustered_boxes(B, 130, (200, 200), 73)
    nms_case("N=130", boxes, scores, 0.7, 50)
    boxes, _, _ = clustered_boxes(B, 200, (200, 200), 74)
    nms_case("all invalid", boxes, torch.full((B, 200), pnms.NEG_INF), 0.7, 20)
    boxes, scores, _ = clustered_boxes(B, 500, (300, 300), 75)
    nms_case("equal scores", boxes, (scores * 8).round() / 8, 0.5, 100)
    boxes, scores, _ = clustered_boxes(B, 70, (300, 300), 76)
    boxes[:, :2] = torch.tensor([[0.0, 0.0, 10.0, 10.0], [0.0, 0.0, 10.0, 7.0]])
    scores[:, :2] = torch.tensor([2.0, 1.5])
    if float(bbox_overlaps(boxes[0, :1], boxes[0, 1:2])) != np.float32(0.7):
        raise AssertionError("the pair is not at IoU 0.7 in fp32")
    for thr, both in ((0.7, True), (0.69, False)):
        idx, _ = pnms.nms_batched(boxes.cuda(), scores.cuda(), thr, 20)
        if (1 in idx[:, :2].tolist()[0]) != both:
            raise AssertionError(f"the IoU-0.7 pair at thr {thr}: kept {idx[:, :2].tolist()}")
        nms_case(f"IoU 0.7 pair thr {thr}", boxes, scores, thr, 20)
    # phase 23: one dataset's RPN at 448²
    boxes, scores, _ = clustered_boxes(1, RPN_N_448, (448, 448), 79)
    nms_case(f"rpn 448² 1x{RPN_N_448}", boxes, scores, 0.7, 1000, timed=True)
    # phases 21-22: Mask R-CNN's RPN at 1024², its predict (80 classes) and
    # RetinaNet's (60 classes, 416² images)
    boxes, scores, _ = clustered_boxes(B, RPN_N_1024, (1024, 1024), 77)
    nms_case(f"rpn 1024² {B}x{RPN_N_1024}", boxes, scores, 0.7, 1000, timed=True)
    for classes, hw, seed in ((80, 1024, 78), (60, 416, 80)):
        boxes, scores, src = clustered_boxes(B, 1000, (hw, hw), seed, copies=10)
        labels = torch.randint(0, classes, (B, 1000), generator=_gen(seed + 1)).gather(1, src)
        nms_case(f"predict {hw}² {B}x1000 {classes} classes", boxes, scores, 0.5, 100,
                 labels, timed=True)
    return {"nms": record}


# ------------------------------------------------------------ phase 3f --

def phase_800_kernels() -> None:
    """Phase 3f: K1-K6 and K8 at the 800² detection paths' shapes, batch 2,
    each against its plain version (TOL and REL_TOL); nothing recorded (the
    JSON line keeps phases 3-3d's rows).  The ViT's 50² token grid: K1/K4
    over 128 windows (64 an image: the grid padded to 56²) of 16 heads × 49
    tokens; K2/K5 over 32 heads of the 50×50 grid (N = 2,500); K3/K6
    sampling 32 maps of 56² (C = 64): held, not timed (the 1024², 416² and
    448² rows below time the same kernels).  XL: K8 at stage 0 (200², 12
    groups) and stage 3 (25², 96 groups), gc 16, random offsets, timed."""
    check_kernels({
        "window": [("800² W=128", window_case(128, 16, 49, 64, 61, device_time=True))],
        "window_bwd": [("800² W=128", window_case(128, 16, 49, 64, 62, bwd=True,
                                                  device_time=True))],
        "flash": [("800² 50x50", flash_case(32, (50, 50), 64, 63))],
        "flash_bwd": [("800² 50x50", flash_case(32, (50, 50), 64, 64, bwd=True))],
        "bilinear_sample": [("800² 56x56", sample_case(32, 56, 56, 64, 56 * 56, 1, 65,
                                                       edge=False))],
        "bilinear_sample_bwd": [("800² 56x56", sample_case(32, 56, 56, 64, 56 * 56, 1,
                                                           66, edge=False, bwd=True))],
    }, record_label=None, timed=False)
    check_kernels({
        "dcnv3_fwd": [(f"800² stage{s} {hw}²", dcnv3_case(2, hw, G, 16, 67 + s, "random"))
                      for s, hw, G in ((0, 200, 12), (3, 25, 96))],
        "dcnv3_bwd": [(f"800² stage{s} {hw}²", dcnv3_case(2, hw, G, 16, 69 + s, "random",
                                                          bwd=True))
                      for s, hw, G in ((0, 200, 12), (3, 25, 96))],
    }, record_label=None)


def phase_path_kernels() -> None:
    """Phase 3f, continued: K1-K6 at the shapes of phases 21 and 22 (batch
    2) and 23 (batch 3), as above.  Mask R-CNN at 1024²: the ViT's 64²
    grid, padded to 70² for RVSA's windows (100 an image), K2/K5 over N =
    4,096 tokens, K3/K6 on 70² maps.  RetinaNet at 416²: the 26² grid,
    padded to 28² (16 windows an image), N = 676, 28² maps.  The multitask
    step at 448²: the 28² grid (16 windows an image, W = 48), K2/K5 over 48
    heads of N = 784, K3/K6 on 48 maps of 28².  Only the 1024² rows are
    timed (K5 there trails SDPA's gradient); the 416² and 448² rows are
    held, not timed (PERF.md §6 keeps their times)."""
    for shapes, timed in ((((1024, 64, 70, 81, 2),), True),
                          (((416, 26, 28, 91, 2), (448, 28, 28, 101, 3)), False)):
        check_kernels(path_cases(shapes), record_label=None, timed=timed)


def phase_xl_path_kernels() -> None:
    """Phase 3f, continued: K8 forward and backward at the stage maps that
    the InternImage-XL paths of phases 21-23 give it (12, 24, 48 and 96
    groups of 16 channels, random offsets): Mask R-CNN at 1024², batch 2
    (256², 128², 64², 32²: stage 0's BG 24 at 256² is the largest map K8
    runs), timed; RetinaNet at 416², batch 2 (104², 52², 26², 13²) and the
    multitask step at 448², batch 3 (112², 56², 28², 14²), held, not
    timed."""
    for size, n, timed, seed in ((1024, 2, True, 131), (416, 2, False, 141),
                                 (448, 3, False, 151)):
        maps = [(s, size // 4 >> s, 12 << s) for s in range(4)]
        check_kernels({
            "dcnv3_fwd": [(f"{size}² stage{s} {hw}²", dcnv3_case(n, hw, G, 16, seed + s,
                                                                 "random"))
                          for s, hw, G in maps],
            "dcnv3_bwd": [(f"{size}² stage{s} {hw}²", dcnv3_case(n, hw, G, 16, seed + 4 + s,
                                                                 "random", bwd=True))
                          for s, hw, G in maps],
        }, record_label=None, timed=timed)


def path_cases(shapes) -> dict:
    """K1-K6 cases at (hw, grid, padded grid, seed, images) shapes."""
    cases = {k: [] for k in ("window", "window_bwd", "flash", "flash_bwd",
                             "bilinear_sample", "bilinear_sample_bwd")}
    for hw, grid, padded, seed, n in shapes:
        W, BH = n * (padded // 7) ** 2, 16 * n
        cases["window"].append((f"{hw}² W={W}", window_case(W, 16, 49, 64, seed,
                                                            device_time=True)))
        cases["window_bwd"].append((f"{hw}² W={W}", window_case(
            W, 16, 49, 64, seed + 1, bwd=True, device_time=True)))
        cases["flash"].append((f"{hw}² {grid}x{grid}", flash_case(BH, (grid, grid), 64,
                                                                  seed + 2)))
        cases["flash_bwd"].append((f"{hw}² {grid}x{grid}", flash_case(
            BH, (grid, grid), 64, seed + 3, bwd=True)))
        cases["bilinear_sample"].append((f"{hw}² {padded}x{padded}", sample_case(
            BH, padded, padded, 64, padded ** 2, 1, seed + 4, edge=False)))
        cases["bilinear_sample_bwd"].append((f"{hw}² {padded}x{padded}", sample_case(
            BH, padded, padded, 64, padded ** 2, 1, seed + 5, edge=False, bwd=True)))
    return cases


# the OSCD recipes' batch on one card: the recipes' 4 pairs a GPU × 8 ranks,
# one rank's 4 pairs, 8 images through the backbone
OSCD_IMAGES = 8


def phase_oscd_kernels() -> None:
    """Phases 3c/3f, continued: the shapes the registry's OSCD recipes
    (`*-unet-96-*_oscd_rgb`, 96² pairs) give the kernels, held against the
    plain versions in fp32 and bf16 (not timed), each with the 0.9
    controls.  ViT-L: the 6² token grid, padded to one 7² window an image
    (K1/K4 over 8 windows × 16 heads of 49 tokens), full attention over N =
    36 (K2/K5 over 128 heads of the 6×6 grid), K3/K6 sampling K and V on
    128 maps of the padded 7² grid.  InternImage-XL: K8 forward and
    backward on its four stage maps, 24², 12², 6² and 3² (12, 24, 48 and 96
    groups of 16 channels), random offsets; 6² and 3² are smaller than one
    16×16 tile of K6's tiled body.  `tools/time_oscd.py` times these rows."""
    check_kernels(oscd_cases(), record_label=None, timed=False)


def oscd_cases() -> dict:
    """The cases of `phase_oscd_kernels`, by kernel."""
    W, BH = OSCD_IMAGES, OSCD_IMAGES * 16
    return {
        "window": [("96² W=8", window_case(W, 16, 49, 64, 111, controls=True))],
        "window_bwd": [("96² W=8", window_case(W, 16, 49, 64, 112, bwd=True,
                                               controls=True))],
        "flash": [("96² 6x6", dataclasses.replace(flash_case(BH, (6, 6), 64, 113),
                                                  controls=True))],
        "flash_bwd": [("96² 6x6", dataclasses.replace(
            flash_case(BH, (6, 6), 64, 114, bwd=True), controls=True))],
        "bilinear_sample": [("96² 7x7", sample_case(BH, 7, 7, 64, 49, 1, 115,
                                                    edge=False))],
        "bilinear_sample_bwd": [("96² 7x7", sample_case(BH, 7, 7, 64, 49, 1, 116,
                                                        edge=False, bwd=True))],
        "dcnv3_fwd": [(f"96² stage{s} {hw}²", dcnv3_case(OSCD_IMAGES, hw, G, 16, 117 + s,
                                                         "random", record=True))
                      for s, (hw, G) in enumerate(((24, 12), (12, 24), (6, 48), (3, 96)))],
        "dcnv3_bwd": [(f"96² stage{s} {hw}²", dcnv3_case(OSCD_IMAGES, hw, G, 16, 121 + s,
                                                         "random", bwd=True, record=True))
                      for s, (hw, G) in enumerate(((24, 12), (12, 24), (6, 48), (3, 96)))],
    }


# ------------------------------------------------------------ phase 3g --

# R1's bound: the fp32 operations that rotated IoU needs, counted from
# csrc/rotated_iou.cu's body (sincosf and atan2f as ~20 each), with what
# belongs to one box counted once a box, not once a pair as the kernel
# does it (`r1_ops`).  With the early exit, what this run's boxes need:
# - a box, 81: the sincos (20), the half sides (4), the corners (32), the
#   winding (17) and the 4 edge vectors (8); and for the exit, 10: its
#   half-diagonal (two squares, a sum, the square root as ~4, the half)
#   and the two positive-side tests;
# - every pair, its separation test, 15: dx and dy (2), |dx| + |dy| (3),
#   the two reaches' sum (1), the margin (3), dx² + dy² (3), the gap's
#   square (1), the compare and the positive-area test (2);
# - a pair the test lets through (`rbox_apart` false), 309: the 16
#   crossings (19 each: r×s 3, the offset 2, the guard 1, t and u 4 each
#   with its division, the 5 range tests) and the IoU (5); the kernel's
#   translation to a's centre is for rounding and not counted;
# - an edge test of such a pair, 6 (two offsets, two products, a
#   difference, a compare), as many as the body runs: each of a pair's 8
#   corners is tested against the other box's edges up to the first that
#   puts it outside, 1 to 4 (`r1_edge_tests`, from this run's boxes);
# - a pair whose polygon has 3 candidates or more, ~260 at the usual 8
#   vertices: its crossing points, the centroid, the atan2s, the sort and
#   the shoelace.
# Without the early exit every pair is charged the 309 and its edge tests,
# and a box no half-diagonal: `r1_ops`' second count, the bound that
# readings of the kernel without the exit were held to, printed beside the
# new one.
R1_OPS_BOX, R1_OPS_PAIR, R1_OPS_EDGE, R1_OPS_POLYGON = 81, 309, 6, 260
R1_OPS_REACH, R1_OPS_APART = 10, 15
# pairs of one chunk of `r1_edge_tests` (float64 crosses, ~128 bytes a pair)
R1_EDGE_CHUNK = 1 << 20
# R1 against its plain version: |kernel − plain| at most R1_TOL[dtype of
# the plain run].  Both translate each pair to its first box's centre; the
# rest is FMA contraction, sincosf and atan2f against PyTorch's rounding.
# Readings (NVIDIA H100 80GB HBM3, 700.00 W; phase 3g's cases, the
# predict's 8M pairs at class-offset centres up to 39,076 px included):
# 8.9e-7 against fp32, 7.2e-7 against float64.  The limits are 11× that;
# the 0.9-scaled control is 0.1 off.
R1_TOL = {torch.float32: 1e-5, torch.float64: 1e-5}
# the rotated test NMS: min(max_per_img · 10, P · C) candidates an image at
# IoU 0.1 (oriented_rcnn_cfg), 20 classes (DIOR-R); the assigner's 100
# padded gts against the 1,000 proposals and the gts themselves
ROT_CAND, ROT_THR, ROT_CLASSES = 2000, 0.1, 20
ASSIGN_GTS, ASSIGN_PROPS = 100, 1000


def rotated_scene(B: int, n_obj: int, copies: int, hw: Tuple[int, int], seed: int):
    """n_obj · copies rboxes an image as a box head leaves them, on the CPU:
    n_obj objects (sides log-uniform over 24-200 px, aspect 1-4, any angle,
    centres inside the hw image, le90), each seen `copies` times (the first
    as it is, the rest with centres jittered by 10% of a side, sides by 10%
    and angles by 0.1 rad), in random order; uniform scores; each object's
    label of ROT_CLASSES.  Returns (boxes (B, N, 5), scores, labels)."""
    g = _gen(seed)
    H, W = hw
    rand = lambda *shape: torch.rand(shape, generator=g)
    side = torch.exp(rand(B, n_obj) * math.log(200 / 24) + math.log(24))
    aspect = 1 + 3 * rand(B, n_obj)
    obj = torch.stack([rand(B, n_obj) * W, rand(B, n_obj) * H, side, side / aspect,
                       (rand(B, n_obj) * 2 - 1) * math.pi / 2], -1)
    labels = torch.randint(0, ROT_CLASSES, (B, n_obj), generator=g)
    boxes = obj.repeat_interleave(copies, 1)
    jitter = torch.randn(boxes.shape, generator=g)
    jitter[:, ::copies] = 0
    boxes = boxes + jitter * torch.stack([boxes[..., 2] * 0.1, boxes[..., 2] * 0.1,
                                          boxes[..., 2] * 0.1, boxes[..., 3] * 0.1,
                                          torch.full_like(boxes[..., 0], 0.1)], -1)
    perm = torch.argsort(rand(B, n_obj * copies), 1)
    take = lambda t: t.gather(1, perm[..., None].expand(-1, -1, t.shape[-1]))
    boxes = prb.regularize_le90(take(boxes))
    labels = labels.repeat_interleave(copies, 1).gather(1, perm)
    return boxes, rand(B, n_obj * copies), labels


def _edge_tests(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Edge tests of corners p (..., 4, 2) against the counter-clockwise
    quads q (..., 4, 2), summed over the 4 corners: a corner's tests stop
    at the first edge it lies outside of (cross product < 0), 4 if none."""
    e1, e2 = q[..., None, :, :], q.roll(-1, -2)[..., None, :, :]
    pc = p[..., :, None, :]
    cross = ((e2[..., 0] - e1[..., 0]) * (pc[..., 1] - e1[..., 1])
             - (e2[..., 1] - e1[..., 1]) * (pc[..., 0] - e1[..., 0]))  # (..., 4, 4)
    out = ~(cross >= 0)
    return torch.where(out.any(-1), out.int().argmax(-1) + 1, 4).sum(-1)


def r1_edge_tests(a: torch.Tensor, b: torch.Tensor, upper: bool,
                  through: torch.Tensor) -> Tuple[int, int]:
    """The inside tests' edge tests R1's body runs over the pairs of a
    (B, N, 5) × b (B, M, 5), both ways (a's corners in b, b's in a), in
    float64 on each pair translated to a's centre, as the kernel does;
    `upper`: only pairs j > i (the mask form, b = a).  (over every pair,
    over the pairs `through` (B, N, M) marks: those the early exit lets
    through)."""
    B, N, M = a.shape[0], a.shape[1], b.shape[1]
    a, b = a.double(), b.double()
    ca = prb._ccw(prb.rbox_to_corners(torch.cat([torch.zeros_like(a[..., :2]),
                                                 a[..., 2:]], -1)))      # (B, N, 4, 2)
    j = torch.arange(M, device=a.device)
    rows = max(1, R1_EDGE_CHUNK // (B * M))
    total, total_through = 0, 0
    for r0 in range(0, N, rows):
        r1 = min(N, r0 + rows)
        rel = b[:, None, :, :2] - a[:, r0:r1, None, :2]                  # (B, n, M, 2)
        cb = prb._ccw(prb.rbox_to_corners(torch.cat(
            [rel, b[:, None, :, 2:].expand(-1, r1 - r0, -1, -1)], -1)))   # (B, n, M, 4, 2)
        pa = ca[:, r0:r1, None].expand_as(cb)
        tests = _edge_tests(pa, cb) + _edge_tests(cb, pa)                # (B, n, M)
        if upper:
            tests = tests * (j[None, :] > torch.arange(r0, r1, device=a.device)[:, None])
        total += int(tests.sum())
        total_through += int((tests * through[:, r0:r1]).sum())
    return total, total_through


def r1_ops(a: torch.Tensor, b: torch.Tensor, ious: torch.Tensor,
           upper: bool) -> Tuple[float, float, int]:
    """The fp32 operations of rotated IoU over the pairs of a (B, N, 5) ×
    b (B, M, 5) (`upper`: b is a, pairs j > i): each box once, each pair's
    separation test, the crossings and edge tests of the pairs it lets
    through, and a polygon for each pair with IoU > 0 (`ious`, of the pairs
    that count).  (those operations, the count before the early exit, which
    charged every pair the crossings and its edge tests, the pairs the exit
    takes)."""
    B, N, M = a.shape[0], a.shape[1], b.shape[1]
    boxes, pairs = (B * N, B * N * (N - 1) // 2) if upper else (B * (N + M), B * N * M)
    polygons = R1_OPS_POLYGON * int((ious > 0).sum())
    through = ~prb.rbox_apart(a, b)
    if upper:
        through &= torch.ones(N, N, dtype=torch.bool, device=a.device).triu(1)
    n_through = int(through.sum())
    tests, tests_through = r1_edge_tests(a, b, upper, through)
    return ((R1_OPS_BOX + R1_OPS_REACH) * boxes + R1_OPS_APART * pairs
            + R1_OPS_PAIR * n_through + R1_OPS_EDGE * tests_through + polygons,
            R1_OPS_BOX * boxes + R1_OPS_PAIR * pairs + R1_OPS_EDGE * tests + polygons,
            pairs - n_through)


def r1_bound(flops: float, nbytes: int) -> Tuple[float, str]:
    """(bound ms, what bounds it) of R1's work."""
    t_ops, t_bytes = flops / PEAK_FLOPS[torch.float32], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def r1_dense_check(label: str, a: torch.Tensor, b: torch.Tensor,
                   controls: bool = False) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """R1's dense form on the card against the plain version on the card, in
    fp32 and float64 (R1_TOL), over the pairs of boxes of non-zero area (a
    box of zero area, as the padded gts are, 'contains' every point of its
    line, and its IoU divides by the eps 1e-6: there both are rounding
    noise times 1e6, and the assigner masks those rows); `controls`: the
    kernel's IoUs scaled by 0.9 must fail the fp32 rule.  Returns (the
    kernel's IoUs, the float64 plain IoUs, the fp32 error)."""
    a, b = a.cuda(), b.cuda()
    real = ((a[..., 2] * a[..., 3] > 0)[..., :, None]
            & (b[..., 2] * b[..., 3] > 0)[..., None, :])
    before = counters()
    got = prb.rbox_overlaps(a, b)
    torch.cuda.synchronize()
    moved = {k: n - before[k] for k, n in counters().items() if n != before[k]}
    if moved != {"rbox_iou": 1}:
        raise AssertionError(f"R1 {label}: launched {moved}, expected one rbox_iou")
    errs = {}
    for dtype in (torch.float32, torch.float64):
        ref = prb.rbox_overlaps_ref(a.to(dtype), b.to(dtype))
        if not torch.isfinite(got).all():
            raise AssertionError(f"R1 {label}: non-finite IoUs")
        errs[dtype] = ((got.double() - ref.double()) * real).abs().max().item()
    ref64 = ref * real
    ok = all(errs[d] <= R1_TOL[d] for d in errs)
    # the early exit's pairs (rbox_apart, the kernel's test operation for
    # operation): their float64 plain IoU and the kernel's must be 0 exactly
    apart = prb.rbox_apart(a, b)
    n_apart = int(apart.sum())
    apart_ok = not (ref[apart] != 0).any() and not (got[apart] != 0).any()
    log(f"[rotated] R1 dense {label}: {tuple(got.shape)}, {int(real.sum())} pairs of boxes "
        f"of non-zero area, {int((ref64 > 0).sum())} of them overlapping; max |kernel − "
        f"plain| fp32 {errs[torch.float32]:.3e} (tol "
        f"{R1_TOL[torch.float32]}), float64 {errs[torch.float64]:.3e} (tol "
        f"{R1_TOL[torch.float64]}); {n_apart} pairs taken by the early exit "
        f"({n_apart / got.numel():.4f} of all), their float64 plain IoU and the kernel's all "
        f"0: {apart_ok}")
    if not ok:
        raise AssertionError(f"R1 {label} disagrees with its plain version: {errs}")
    if not apart_ok:
        raise AssertionError(f"R1 {label}: a pair the early exit takes has IoU > 0")
    if controls:
        ref32 = prb.rbox_overlaps_ref(a, b)
        ctrl = ((got * CONTROL_SCALE - ref32) * real).abs().max().item()
        if ctrl <= R1_TOL[torch.float32]:
            raise AssertionError(f"R1 {label}: the control (IoUs × {CONTROL_SCALE}) passed")
        log(f"[rotated] control {label}, the kernel's IoUs × {CONTROL_SCALE} -> rejected "
            f"(max |Δ| {ctrl:.3e} > {R1_TOL[torch.float32]})")
    return got, ref64, errs[torch.float32]


def r1_edge_cases() -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairs of phase 3g's edge cases, a (1, 9, 5) against b (1, 9, 5):
    identical boxes, one inside another, a shared edge, half overlap, a
    90°-rotated copy, a zero-width box, θ at +π/2 against −π/2, a pair
    after class 19's offset, and a disjoint pair."""
    box = [40.0, 50.0, 30.0, 12.0, 0.3]
    shift = 19 * 1901.0
    pairs = [(box, box), (box, [41.0, 50.5, 10.0, 4.0, 0.5]),
             ([10.0, 10.0, 10.0, 10.0, 0.0], [20.0, 10.0, 10.0, 10.0, 0.0]),
             ([10.0, 10.0, 10.0, 10.0, 0.0], [15.0, 10.0, 10.0, 10.0, 0.0]),
             (box, [40.0, 50.0, 30.0, 12.0, 0.3 + math.pi / 2]),
             (box, [40.0, 50.0, 0.0, 12.0, 0.3]),
             ([40.0, 50.0, 30.0, 12.0, math.pi / 2], [42.0, 50.0, 30.0, 12.0, -math.pi / 2]),
             ([40.0 + shift, 50.0 + shift, 30.0, 12.0, 0.3],
              [44.0 + shift, 52.0 + shift, 26.0, 14.0, 0.1]),
             (box, [140.0, 50.0, 30.0, 12.0, 0.3])]
    a, b = zip(*pairs)
    return torch.tensor([a]), torch.tensor([b])


def r1_mask_bits(boxes_o: torch.Tensor, scores_o: torch.Tensor,
                 thr: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """R1's suppression bitmask (B, N, N) bools, bit (i, j) for j > i, from
    the mask form launched directly (`launch_keep`), with the words and the
    keep mask of that launch."""
    mask, keep = launch_keep("mtp_nms_rotated", boxes_o, scores_o, thr)
    N = boxes_o.shape[1]
    j = torch.arange(N, device=mask.device)
    return unpack_words(mask, N) & (j[None, :] > j[:, None]), mask, keep


def phase_rotated_iou_kernel() -> dict:
    """Phase 3g: R1 against its plain version on the card, on the edge cases,
    at the assigner's shape (dense) and at the predict's (2 × 2,000
    candidates of 20 classes after `class_offset_boxes`: the dense IoUs,
    the mask form's bits, and the keep sets of `batched_nms` against
    `nms_ref` on the card), with controls; a built case whose every pair
    lies at least 1e-3 from the threshold keeps, index for index, what
    `nms_ref` keeps on the card and the CPU; times and bounds."""
    # edge cases
    a, b = r1_edge_cases()
    got, ref64, _ = r1_dense_check("edge cases", a, b)
    diag = lambda t: [round(float(x), 6) for x in torch.diagonal(t[0])]
    log(f"[rotated] edge cases (identical, inside, shared edge, half, 90°, zero width, "
        f"±π/2, offset, disjoint): kernel {diag(got)}, float64 {diag(ref64)}")
    # the assigner: 100 padded gts (12 real) against 1,000 proposals + the gts
    gts, _, _ = rotated_scene(1, 12, 1, (800, 800), 80)
    gts = torch.cat([gts, torch.zeros(1, ASSIGN_GTS - 12, 5)], 1)
    props, _, _ = rotated_scene(1, 100, ASSIGN_PROPS // 100, (800, 800), 81)
    props = torch.cat([props, gts], 1)
    got, ref64, dense_err = r1_dense_check(f"assigner 1x{ASSIGN_GTS}x{props.shape[1]}", gts,
                                           props, controls=True)
    ga, pa = gts.cuda(), props.cuda()
    dense_ms = loop_ms(lambda: prb.rbox_overlaps(ga, pa))
    dense_dev = graph_ms(lambda: prb.rbox_overlaps(ga, pa))
    dense_plain = loop_ms(lambda: prb.rbox_overlaps_ref(ga, pa), reps=3, warmup=1)
    pairs = ga.shape[1] * pa.shape[1]
    flops, old_flops, exits = r1_ops(ga, pa, ref64, upper=False)
    nbytes = (ga.numel() + pa.numel()) * 4 + pairs * 4
    dense_bound, dense_by = r1_bound(flops, nbytes)
    old_bound, old_by = r1_bound(old_flops, nbytes)
    log(f"[kernel] rbox_iou assigner: kernel {dense_ms:.4f} ms (CUDA graph: {dense_dev:.4f} "
        f"ms of device time a call)  plain (rbox_overlaps_ref on the card) "
        f"{dense_plain:.4f} ms  library none  bound {dense_bound:.4f} ms by {dense_by} "
        f"({pairs} pairs, {exits} taken by the early exit, {int((ref64 > 0).sum())} "
        f"overlapping, {flops / 1e9:.4f} GFLOP fp32, {nbytes / 1e6:.3f} MB; counted "
        f"without the exit: {old_bound:.4f} ms by {old_by}, {old_flops / 1e9:.4f} GFLOP)")

    # the predict: 2 × 2,000 candidates of 20 classes, shifted by class
    B = 2
    boxes, scores, labels = rotated_scene(B, ROT_CAND // 10, 10, (800, 800), 82)
    shifted = pnms.class_offset_boxes(boxes, labels)
    order, boxes_o, scores_o = pnms._score_order(shifted.cuda(), scores.cuda())
    boxes_o, scores_o = boxes_o.contiguous(), scores_o.contiguous()
    got, ref64, err = r1_dense_check(f"predict {B}x{ROT_CAND}x{ROT_CAND} after the class "
                                     f"offset (max |centre| "
                                     f"{shifted[..., :2].abs().max():.0f} px)",
                                     boxes_o, boxes_o, controls=True)
    tol = R1_TOL[torch.float32]
    upper = torch.ones(ROT_CAND, ROT_CAND, dtype=torch.bool, device=boxes_o.device).triu(1)
    near = ((ref64 - ROT_THR).abs() <= tol) & upper
    bits, words, keep_k = r1_mask_bits(boxes_o, scores_o, ROT_THR)
    check_scan(f"R1 predict {B}x{ROT_CAND}", words, keep_k, scores_o)
    del words, keep_k
    plain_bits = (prb.rbox_overlaps_ref(boxes_o, boxes_o) > ROT_THR) & upper
    off_bits = bits != plain_bits
    if (off_bits & ~near).any():
        raise AssertionError(f"R1's mask differs from the plain version's IoU > {ROT_THR} "
                             f"at {int((off_bits & ~near).sum())} pairs off the threshold")
    log(f"[rotated] R1 mask {B}x{ROT_CAND} at {ROT_THR}: {int(bits.sum())} bits set, "
        f"{int(off_bits.sum())} differ from the plain version's, all among the "
        f"{int(near.sum())} pairs within {tol} of the threshold")
    del got, plain_bits, off_bits, bits

    # keep sets through batched_nms on the card against nms_ref (card, CPU)
    before = counters()
    idx, out = pnms.batched_nms(boxes.cuda(), scores.cuda(), labels.cuda(), ROT_THR, 200)
    keep = pnms.nms_keep(boxes_o, scores_o, ROT_THR)
    torch.cuda.synchronize()
    moved = {k: n - before[k] for k, n in counters().items() if n != before[k]}
    if moved != {"nms_rotated": 2}:
        raise AssertionError(f"R1 predict: launched {moved}, expected nms_rotated twice")
    valid = scores_o > pnms.NEG_INF / 2
    keep_ref = pnms.nms_keep_ref(boxes_o, valid, ROT_THR)
    differ = keep != keep_ref
    first = [int(d.nonzero()[0]) if d.any() else None for d in differ]
    for img, j in enumerate(first):
        if j is not None and not near[img, :j, j].any() and not near[img, j].any():
            raise AssertionError(f"R1 predict image {img}: the first differing decision "
                                 f"(box {j}) has no pair within {tol} of {ROT_THR}")
    ref_idx, ref_out = pnms.nms_ref(shifted.cuda(), scores.cuda(), ROT_THR, 200)
    log(f"[rotated] predict keep sets: {int(keep.sum())} kept by R1, {int(keep_ref.sum())} "
        f"by nms_ref on the card; "
        f"{int(differ.sum())} differing decisions, the first of each image at box "
        f"{first}, each tracing to one of the {int(near.sum())} pairs within {tol} of "
        f"{ROT_THR}; batched_nms top 200 equal to nms_ref's: "
        f"{torch.equal(idx, ref_idx) and torch.equal(out, ref_out)}")
    keep_low = pnms.nms_keep(boxes_o, scores_o, ROT_THR - 0.01)
    if torch.equal(keep_low, keep):
        raise AssertionError(f"R1: the control at thr {ROT_THR - 0.01} passed")
    log(f"[rotated] control, R1 at thr {ROT_THR - 0.01:.2f} -> rejected "
        f"({int(keep_low.sum())} kept against {int(keep.sum())} at {ROT_THR})")

    # the built case: every pair at least 1e-3 from the threshold
    boxes_m, scores_m, labels_m = rotated_scene(B, 60, 5, (800, 800), 83)
    labels_m = labels_m % 3
    ious = prb.rbox_overlaps_ref(boxes_m.double(), boxes_m.double())
    same = labels_m[:, :, None] == labels_m[:, None, :]
    vals = torch.sort(ious[same & (ious > 0.02) & (ious < 0.3)].flatten())[0]
    gap = int(torch.argmax(vals[1:] - vals[:-1]))
    thr_m = float((vals[gap] + vals[gap + 1]) / 2)
    margin = float(((ious - thr_m).abs() + (~same) * 1.0).min())
    if margin < 1e-3:
        raise AssertionError(f"the built case's margin is {margin:.2e} < 1e-3")
    got_idx, got_s = pnms.batched_nms(boxes_m.cuda(), scores_m.cuda(), labels_m.cuda(),
                                      thr_m, 100)
    shifted_m = pnms.class_offset_boxes(boxes_m, labels_m)
    same_idx = {where: torch.equal(got_idx.cpu(), r[0].cpu()) and torch.equal(got_s.cpu(),
                                                                              r[1].cpu())
                for where, r in (("card", pnms.nms_ref(shifted_m.cuda(), scores_m.cuda(),
                                                       thr_m, 100)),
                                 ("CPU", pnms.nms_ref(shifted_m, scores_m, thr_m, 100)))}
    log(f"[rotated] built case {B}x{boxes_m.shape[1]}, 3 classes, thr {thr_m:.4f} (every "
        f"same-class pair ≥ {margin:.2e} from it): {int((got_s > pnms.NEG_INF / 2).sum())} "
        f"kept; indices and scores equal to nms_ref's on the card {same_idx['card']}, on "
        f"the CPU {same_idx['CPU']}")
    if not all(same_idx.values()):
        raise AssertionError(f"R1's keep set differs from nms_ref's at the built case: "
                             f"{same_idx}")

    # times at the predict's shape
    ms = loop_ms(lambda: pnms.nms_keep(boxes_o, scores_o, ROT_THR))
    dev = graph_ms(lambda: pnms.nms_keep(boxes_o, scores_o, ROT_THR))
    plain_ms = loop_ms(lambda: pnms.nms_keep_ref(boxes_o, valid, ROT_THR), reps=3, warmup=1)
    whole = loop_ms(lambda: pnms.batched_nms(boxes.cuda(), scores.cuda(), labels.cuda(),
                                             ROT_THR, 200))
    split = kernel_split_ms(lambda: pnms.nms_keep(boxes_o, scores_o, ROT_THR))
    pairs = B * ROT_CAND * (ROT_CAND - 1) // 2
    flops, old_flops, exits = r1_ops(boxes_o, boxes_o, ref64 * upper, upper=True)
    nbytes = B * ROT_CAND * (20 + 4) + B * ROT_CAND
    bound_ms, bound_by = r1_bound(flops, nbytes)
    old_bound, old_by = r1_bound(old_flops, nbytes)
    log(f"[kernel] nms_rotated predict {B}x{ROT_CAND}: kernel {ms:.4f} ms (CUDA graph: "
        f"{dev:.4f} ms of device time a call; mask and N1's scan)  plain (nms_keep_ref "
        f"on the card) {plain_ms:.4f} ms  library none (mmcv's nms_rotated is absent)  "
        f"bound {bound_ms:.4f} ms by {bound_by} ({pairs} pairs, {exits} taken by the early "
        f"exit, {int(((ref64 > 0) & upper).sum())} overlapping, {flops / 1e9:.4f} GFLOP fp32, "
        f"{nbytes / 1e6:.3f} MB; counted without the exit: {old_bound:.4f} ms by {old_by}, "
        f"{old_flops / 1e9:.4f} GFLOP); batched_nms whole (offset, sort, R1, top 200) "
        f"{whole:.4f} ms; split (torch.profiler, device ms a call): mask "
        f"{split.get('R1 mask', 0.0):.4f}, scan {split.get('NMS scan (N1, R1)', 0.0):.4f}")
    return {"rotated_iou": dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                                bound_ms=bound_ms, bound_by=bound_by),
            "rotated_iou_dense": dict(max_abs_err=dense_err, ms=dense_ms,
                                      plain_ms=dense_plain, library_ms=None,
                                      bound_ms=dense_bound, bound_by=dense_by)}


# ----------------------------------------------------------- phase 4 / 8 --

def build_model(path: Path, hw: Tuple[int, int]) -> Segmentor:
    """The recipe's full-width model for hw images (the ViT's `pos_embed`
    and full-attention tables are sized by its token grid), seeded random
    weights, on the CPU."""
    model = Segmentor(path.recipe.backbone, path.recipe.num_classes, input_hw=hw)
    return init_weights(model, _gen(SEED)).eval()


@torch.no_grad()
def logits_reference(path: Path, model_cpu: Segmentor) -> dict:
    """Phase 4's CPU half: the logits of one seeded image of `cpu_hw`."""
    x = torch.randn((1, *path.cpu_hw, 3), generator=_gen(SEED + 1))
    t0 = time.perf_counter()
    out = model_cpu.predict(x)
    return {"out": out, "seconds": time.perf_counter() - t0}


@torch.no_grad()
def phase_logits(path: Path, model_cpu: Segmentor, ref: dict) -> None:
    """The card's logits against the CPU's (`logits_reference`)."""
    hw = path.cpu_hw
    x = torch.randn((1, *hw, 3), generator=_gen(SEED + 1))
    ref, t_cpu = ref["out"], ref["seconds"]
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
    with timed_window():
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
                    stochastic: bool, task_cls=SegmentationTask,
                    no_grad: Tuple[str, ...] = ()
                    ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """One loss.backward() of the task's loss on `device`: the loss and every
    parameter's gradient (on the CPU).  `stochastic` turns dropout and
    drop-path on.  The task's random draws (those masks, and detection's
    samplers) come from a CPU generator of one seed for every run, so that
    the card's run draws what the CPU's does.  The parameters named from
    `no_grad` (prefixes) must get no gradient, and every other one must."""
    task = task_cls(cfg, model=model, device=device)
    masks = _gen(SEED + 4)
    loss, _ = task.loss_fn(model, {k: v.to(device) for k, v in batch.items()},
                           masks, deterministic=not stochastic)
    loss.backward()
    params = dict(model.named_parameters())
    missing = {n for n, p in params.items() if p.grad is None}
    expected = {n for n in params if n.startswith(no_grad)}
    if missing != expected:
        raise AssertionError(f"on {device}, without a gradient against the expected "
                             f"{no_grad}: {sorted(missing ^ expected)[:6]}")
    grads = {n: p.grad.detach().cpu() for n, p in params.items() if p.grad is not None}
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
            f"{max(x)[0]:.3e} at {max(x)[1]}" for grp, x in ratios.items() if x)
        + "; largest where ‖g‖ > the floor: " + ", ".join(
            f"{grp} {r:.3e} at {n}" for r, grp, n in sorted(above, reverse=True)[:3])
        + f"; {len(bad)} of {len(g_ref)} parameters outside rtol·‖g‖ + "
        f"{GRAD_ATOL}·‖g_all‖, rtol {rtol} (convs: {path.head_prefixes})"
        + (f", e.g. {[(n, f'{d:.3e}', f'{m:.3e}') for n, d, m in bad[:4]]}" if bad else ""))


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def phase_gradients(path: Path, model_cpu: Segmentor, ref: tuple) -> None:
    """One fp32 loss.backward() of the recipe's model on the card and on the
    CPU (`ref`, `gradients_reference`'s), same
    weights and batch: train-mode BatchNorm, the recipe's remat, if any,
    deterministic unless `grad_stochastic`.  Then the control: the card run
    again with TF32 matmuls and convolutions (10-bit mantissas where fp32
    has 23), a run of lower precision, which the same rule must find
    outside the tolerance, or the tolerance could not tell."""
    cfg, batch, what = gradient_inputs(path, model_cpu)
    check_gradients(path, cfg, model_cpu, batch, SegmentationTask, what, cpu=ref)


def gradients_reference(path: Path, model_cpu: Segmentor) -> tuple:
    """Phase 6's CPU half: (loss, gradients, seconds)."""
    cfg, batch, _ = gradient_inputs(path, model_cpu)
    return cpu_run(path, cfg, model_cpu, batch, SegmentationTask)


def gradient_inputs(path: Path, model_cpu: Segmentor) -> Tuple[TaskConfig, dict, str]:
    """(the recipe in fp32, the seeded batch, what the check says it ran);
    with `grad_stochastic` the model's RVSA regressors zeroed."""
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
    return cfg, batch, what


def cpu_run(path, cfg: TaskConfig, model_cpu, batch: dict, task_cls,
            no_grad: Tuple[str, ...] = ()) -> tuple:
    """`check_gradients`' CPU run: (loss, gradients, seconds)."""
    t0 = time.perf_counter()
    loss, grads = _loss_and_grads(cfg, model_cpu, batch, "cpu", path.grad_stochastic,
                                  task_cls, no_grad)
    return loss, grads, time.perf_counter() - t0


def check_gradients(path, cfg: TaskConfig, model_cpu, batch: dict, task_cls,
                    what: str, no_grad: Tuple[str, ...] = (),
                    cpu: Optional[tuple] = None) -> None:
    """The card-vs-CPU gradient check of `phase_gradients` for any task
    (`path` gives name, per_step, grad_stochastic and head_prefixes), and
    its TF32 control; `no_grad` as `_loss_and_grads` takes it; `cpu` the
    CPU's run (`cpu_run`), made here unless given."""
    tag = f"[grads {path.name}]"
    cpu = cpu or cpu_run(path, cfg, model_cpu, batch, task_cls, no_grad)
    runs = {"cpu": cpu[:2]}
    log(f"{tag} cpu: loss {cpu[0]:.6f} forward+backward {cpu[2]:.1f} s")
    model_gpu = copy.deepcopy(model_cpu).cuda()
    reset_counters()
    t0 = time.perf_counter()
    runs["cuda"] = _loss_and_grads(cfg, model_gpu, batch, "cuda", path.grad_stochastic,
                                   task_cls, no_grad)
    torch.cuda.synchronize()
    launched = counters()
    log(f"{tag} cuda: loss {runs['cuda'][0]:.6f} forward+backward "
        f"{time.perf_counter() - t0:.1f} s")
    if launched != path.per_step:
        raise AssertionError(f"launch counts {launched} != {path.per_step}")
    ok, summary = _grad_verdict(path, runs["cpu"], runs["cuda"])
    log(f"{tag} {what}, card vs CPU: {summary}; launches {launched}")
    _tf32(True)
    try:
        control = _loss_and_grads(cfg, model_gpu, batch, "cuda", path.grad_stochastic,
                                  task_cls, no_grad)
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


def phase_train(path: Path, card: str, ranks: Optional["DdpRanks"] = None) -> dict:
    """The recipe's train step through the task's entry points; with `ranks`
    phase 25 from its state, then 25c and 25d."""
    recipe = path.recipe
    crop, K = recipe.backbone.img_size, recipe.num_classes
    batch_size = recipe.train.batch_size
    tag = f"[train {path.name}]"
    task = SegmentationTask(recipe)
    t0 = time.perf_counter()
    state = task.init_state(_gen(SEED))
    initial = host_copy(state.model)
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
    with timed_window():
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
    tiles = eval_tiles(path)
    metrics = task.evaluate(state, iter([tiles]))
    log(f"{tag} evaluate (slide {recipe.slide}, {n} tile(s) of {size}²): "
        f"mIoU {metrics['mIoU']:.3f} mAcc {metrics['mAcc']:.3f} aAcc "
        f"{metrics['aAcc']:.3f}")
    if not all(0.0 <= metrics[k] <= 100.0 for k in ("mIoU", "mAcc", "aAcc")):
        raise AssertionError(f"bad evaluate metrics {metrics}")

    if ranks is not None:  # phase 25 takes phase 7's state
        with phase_time("ddp (with 25c-d's CPU references on a thread)"):
            refs = phase_ddp(state, path, card, ranks,
                             lambda: (carafe_reference(), patch8_reference()))["extra"]
        free()
        with phase_time("carafe and patch 8 on the card"):
            phase_carafe(refs[0])
            phase_patch8(refs[1])
        del refs
        free()
    sanity_run(task, batches[0], tag, initial)
    return launched


def eval_tiles(path: Path) -> dict:
    """The seeded tiles `evaluate` takes in phases 7 and 26."""
    n, size = path.eval_tiles
    K = path.recipe.num_classes
    return {"image": np.random.default_rng(SEED + 20).standard_normal(
        (n, size, size, 3)).astype(np.float32),
        "label": np.random.default_rng(SEED + 21).integers(0, K, (n, size, size))}


def host_copy(model) -> Dict[str, torch.Tensor]:
    """The model's state dict, copied to the host."""
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}


def sanity_run(task, batch, tag: str, initial: Dict[str, torch.Tensor]) -> None:
    """The fixed-batch sanity run after a recipe's train step (not the
    recipe: its warm-up starts near 0, so a constant lr of 1e-4 shows that
    the step learns): the task's initial weights (`initial`, the recipe
    state's as `init_state` drew them from the seed, restored rather than
    drawn again), AdamW at a constant lr of 1e-4 with the recipe's layer
    decay and weight decay, SANITY_STEPS steps on one batch; the loss must
    fall."""
    task.model.load_state_dict(initial)
    cfg = task.cfg
    opt = dataclasses.replace(cfg.train.optimizer, lr=1e-4)
    tx = make_optimizer(opt, make_schedule(ScheduleConfig(kind="constant"), opt.lr),
                        task.model.named_parameters(), cfg.backbone.depth,
                        layer_id_fn=layer_id_fn_for(cfg.backbone, root=task.backbone_root))
    state = create_state(task.model, tx, torch.Generator(device=task.device).manual_seed(SEED))
    losses = []
    task.fit(state, cycle([batch]), SANITY_STEPS, log_every=1,
             log_fn=lambda i, m: losses.append(m["loss"]))
    log(f"{tag} sanity (not the recipe): fixed batch, constant lr 1e-4, {SANITY_STEPS} "
        f"steps, loss {' '.join(f'{x:.4f}' for x in losses)}")
    if not min(losses[-3:]) < losses[0]:
        raise AssertionError(f"the loss did not fall on a fixed batch: {losses}")


# --------------------------------------------------------------- phase 25 --

# the ViT recipe's DDP step (`parallel.mesh`) from phase 7's state.  The
# comparisons run in fp32, TF32 off: two worlds split the batch into GEMMs of
# other sizes, which bf16 would round apart; the times run in the recipe's
# bf16.
DDP_FP32 = dataclasses.replace(RVSA, backbone=dataclasses.replace(RVSA.backbone,
                                                                  dtype="float32"))
DDP_STEPS = 2          # steps compared, each on its own global batch of 8
DDP_TIMED = 4          # steps in each timed block (A B B A)
DDP_WAIT = 600.0       # s a rank waits for the go, the parent for the ranks
DDP_WAIT_CHECKPOINT = 1200.0  # s a rank, spawned before phase 6, waits for phase 7's state


def _ddp_batches(path: Path) -> List[dict]:
    """The compared steps' global batches of 8; row 0 (rank 0's) ignores a
    block of pixels more, so that the loss's normaliser counts over both
    ranks."""
    crop, K = path.recipe.backbone.img_size, path.recipe.num_classes
    out = []
    for i in range(DDP_STEPS):
        b = synthetic_batch(path.recipe.train.batch_size, (crop, crop), K, SEED + 60 + i)
        b["label"][0, 96:192, 64:320] = 255
        out.append(b)
    return out


def _ddp_steps(step_fn, state, batches, device, keep=lambda t: t.detach().cpu(),
               picks: Optional[Dict[tuple, torch.Tensor]] = None) -> dict:
    """`step_fn` over `batches`: each step's metrics, the gradients of the
    first step (as it applied them), and the model's state dict after, each
    tensor through `keep` (a copy on the host unless told otherwise).  With
    `picks` the first step's max-pools take them (`fixed_pool_picks`)."""
    out = {"metrics": [], "grads": None}
    for i, b in enumerate(batches):
        fixed = fixed_pool_picks(picks) if picks is not None and i == 0 \
            else contextlib.nullcontext()
        with fixed:
            state, m = step_fn(state, to_device(b, device))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if out["grads"] is None:
            out["grads"] = {n: keep(p.grad) for n, p in state.model.named_parameters()}
    out["state"] = {k: keep(v) for k, v in state.model.state_dict().items()}
    return out





def _ddp_verdict(path: Path, got: dict, ref: dict, start: Dict[str, torch.Tensor],
                 adam: Dict[str, float]) -> Tuple[bool, str]:
    """(within, summary) of a run of the compared steps against another from
    the same state `start`: the first step's loss and gradients by phase 6's
    rule (`_grad_verdict`); each step's loss (LOSS_RTOL) and grad_norm (the
    backbone's rtol); after the steps the BatchNorm running statistics and
    the parameters by phase 6's rule (each within rtol·‖x‖ + GRAD_ATOL·‖all‖,
    the "convs" rtol), and each parameter elementwise within `adam[name]`
    (2·Σ lr·scale over the steps: Adam moves a parameter whose gradient is
    rounding residue, as the conv biases before train-mode BatchNorm are,
    by ±lr·scale either way) plus two fp32 ulps of its largest element.
    The updates' ‖Δu‖/‖u‖ is reported: those biases' sign flips dominate
    it."""
    ok, summary = _grad_verdict(path, (ref["metrics"][0]["loss"], ref["grads"]),
                                (got["metrics"][0]["loss"], got["grads"]))
    bad = []
    for i, (m, r) in enumerate(zip(got["metrics"], ref["metrics"])):
        if not abs(m["loss"] - r["loss"]) <= LOSS_RTOL * abs(r["loss"]):
            bad.append(f"step {i + 1} loss {m['loss']} vs {r['loss']}")
        if not abs(m["grad_norm"] - r["grad_norm"]) <= GRAD_RTOL["backbone"] * r["grad_norm"]:
            bad.append(f"step {i + 1} grad_norm {m['grad_norm']} vs {r['grad_norm']}")
    rtol = path.grad_rtol["convs"]
    params = list(ref["grads"])
    for names in ([n for n in ref["state"] if "running_" in n], params):
        total = math.sqrt(sum(float(ref["state"][n].double().square().sum()) for n in names))
        bad += [n for n in names if not float((got["state"][n] - ref["state"][n]).norm())
                <= rtol * float(ref["state"][n].norm()) + GRAD_ATOL * total]
    u_ref = torch.cat([(ref["state"][n] - start[n]).reshape(-1) for n in params])
    u_got = torch.cat([(got["state"][n] - start[n]).reshape(-1) for n in params])
    u_rel = float((u_got - u_ref).norm() / u_ref.norm())
    eps = torch.finfo(torch.float32).eps
    worst = max(((float((got["state"][n] - ref["state"][n]).abs().max())
                  / (adam[n] + 2 * eps * float(ref["state"][n].abs().max())), n)
                 for n in params), default=(0.0, ""))
    if not worst[0] <= 1.0:
        bad.append(f"{worst[1]} at {worst[0]:.2f}× its Adam bound")
    losses = " ".join(f"{m['loss']:.6f}/{r['loss']:.6f}" for m, r in zip(got["metrics"],
                                                                      ref["metrics"]))
    norms = " ".join(f"{m['grad_norm']:.6f}/{r['grad_norm']:.6f}"
                     for m, r in zip(got["metrics"], ref["metrics"]))
    return ok and not bad, (f"losses {losses}; grad_norm {norms}; after "
                            f"{len(ref['metrics'])} steps the parameters' largest |Δ| "
                            f"{worst[0]:.3f} of their Adam bound at {worst[1]}, updates "
                            f"‖Δu‖/‖u‖ {u_rel:.3e}; first step's {summary}"
                            + (f"; outside: {bad[:6]}" if bad else ""))


def identity_sampling(model) -> None:
    """Zero the RVSA sampling regressors: every K/V tap on the identity grid,
    whose coordinates both sides compute bit for bit (phase 14's device)."""
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if ".attn.sampling_" in name:
                prm.zero_()


class _PairSum(torch.autograd.Function):
    """The all-reduce of two emulated ranks (`split_grads`): x0 + x1 for
    each (gloo's sum of two), and the gradient of either copy flows to both
    summands (the all-reduce's backward)."""

    @staticmethod
    def forward(ctx, x0: torch.Tensor, x1: torch.Tensor):
        s = x0 + x1
        return s, s.clone()

    @staticmethod
    def backward(ctx, g0: torch.Tensor, g1: torch.Tensor):
        g = g0 + g1
        return g, g.clone()


def split_grads(loss_fn, model, batch: dict, picks: Optional[Dict[tuple, torch.Tensor]] = None,
                record: Optional[Dict[tuple, torch.Tensor]] = None
                ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(the ranks' mean loss, the averaged gradients) of a world of two
    ranks emulated in this process, with no process group: rank r's copy of
    `model` takes rank r's half of `batch` on a thread of its own, the two
    taking turns; at each all-reduce of the loss (BatchNorm's sums, the loss
    normalizers) the second rank joins both halves' tensors in one
    `_PairSum`, so one backward over the two losses carries the gradient
    across as the all-reduce's backward does; each copy's gradients are the
    rank's, and their fp32 sum halved is `reduce_gradients`' average.  The
    same arithmetic as phase 25(b)'s two processes at the same shapes, in
    one process; against the whole batch's step it differs in the order of
    fp32 summation only (GEMMs, convolutions and reductions over 4 rows
    twice, not 8 once).  With `picks` (`recorded_pool_picks` of the whole
    batch) each rank's 2-D max-pools take its rows of those picks; with
    `record` each rank's own picks are kept there, under (rank, key)."""
    models = [copy.deepcopy(model) for _ in range(2)]
    halves = [{k: v[r * len(v) // 2:(r + 1) * len(v) // 2] for k, v in batch.items()}
              for r in range(2)]
    local = threading.local()
    cv = threading.Condition()
    st = {"turn": 0, "slots": [None, None], "out": None, "failed": False}
    losses: List[Optional[torch.Tensor]] = [None, None]
    errors: List[BaseException] = []

    def wait_turn(r: int) -> None:  # with cv held
        if not cv.wait_for(lambda: st["turn"] == r or st["failed"], timeout=DDP_WAIT):
            raise TimeoutError("the other emulated rank never reached the all-reduce")
        if st["failed"]:
            raise RuntimeError("the other emulated rank failed")

    def pair_sum(x: torch.Tensor) -> torch.Tensor:
        r = getattr(local, "rank", None)
        if r is None:  # another thread of this process (phase 25's background work)
            return real["sum"](x)
        with cv:
            st["slots"][r] = x
            if r == 1:
                st["out"] = _PairSum.apply(*st["slots"])
            st["turn"] = 1 - r
            cv.notify_all()
            wait_turn(r)
            return st["out"][r]

    def body(r: int) -> None:
        local.rank = r
        try:
            with cv:
                wait_turn(r)
            losses[r] = loss_fn(models[r], halves[r])
        except BaseException as e:  # noqa: BLE001 -- re-raised by the caller
            errors.append(e)
            with cv:
                st["failed"] = True
                cv.notify_all()
            return
        with cv:
            st["turn"] = 1 - r
            cv.notify_all()

    real = {"sum": pmesh.all_reduce_sum, "world_size": pmesh.world_size, "rank": pmesh.rank,
            "data_size": pmesh.data_size, "data_rank": pmesh.data_rank}
    emulated = lambda name, value: (lambda: value(local.rank) if hasattr(local, "rank")
                                    else real[name]())
    pool = F.max_pool2d

    def rank_pool(x, *args, **kwargs):
        r = getattr(local, "rank", None)
        if r is None:  # another thread of this process
            return pool(x, *args, **kwargs)
        kwargs.pop("return_indices", None)
        key, n = _pool_key(x, args, kwargs), len(x)
        if picks is None:
            out, idx = pool(x, *args, return_indices=True, **kwargs)
            record[(r,) + key] = idx.cpu()
            return out
        idx = picks[((2 * n,) + key[0][1:],) + key[1:]][r * n:(r + 1) * n].to(x.device)
        return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)

    with contextlib.ExitStack() as stack:
        if picks is not None or record is not None:
            stack.enter_context(mock.patch.object(F, "max_pool2d", rank_pool))
        stack.enter_context(mock.patch.object(pmesh, "all_reduce_sum", pair_sum))
        stack.enter_context(mock.patch.object(pupernet, "all_reduce_sum", pair_sum))
        for name in ("world_size", "data_size"):
            stack.enter_context(mock.patch.object(pmesh, name, emulated(name, lambda r: 2)))
        for name in ("rank", "data_rank"):
            stack.enter_context(mock.patch.object(pmesh, name, emulated(name, lambda r: r)))
        threads = [threading.Thread(target=body, args=(r,)) for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    torch.autograd.backward(losses)
    rank_grad = lambda p: torch.zeros_like(p) if p.grad is None else p.grad.float()
    grads = {n: (rank_grad(p0) + rank_grad(p1)) / 2 for (n, p0), p1 in
             zip(models[0].named_parameters(), models[1].parameters())}
    return float((losses[0].detach() + losses[1].detach()) / 2), grads


def compared_picks(task, state, snap: dict, batch: dict) -> Dict[tuple, torch.Tensor]:
    """The max-pool picks (`recorded_pool_picks`) of the first compared
    step's fp32 forward on the whole global `batch` in this process, from
    the compared state `snap` (restored after: the forward moves the
    BatchNorm statistics).  Every run of phases 25-26's first compared step
    takes them (`two_ranks_rule`)."""
    picks: Dict[tuple, torch.Tensor] = {}
    with torch.no_grad(), recorded_pool_picks(picks):
        task.loss_fn(state.model, to_device(batch, task.device), None, deterministic=True)
    _load_snapshot(state, snap)
    return picks


def rows_of(picks: Dict[tuple, torch.Tensor], lo: int, hi: int) -> Dict[tuple, torch.Tensor]:
    """The picks of rows lo:hi of the batch they were recorded on, keyed as
    a batch of those rows' max-pools."""
    return {((hi - lo,) + key[0][1:],) + key[1:]: idx[lo:hi] for key, idx in picks.items()}


def two_ranks_rule(path: Path) -> Path:
    """The rule (b) holds the two ranks' run to (a)'s by: phase 6's at
    GRAD_RTOL_STOCHASTIC, as phase 14 holds its identity-sampling strip.
    The compared steps run without dropout and drop-path (the CPU tests hold
    the global-row draws, world 2 against world 1 within 1e-5) and with the
    RVSA regressors zeroed (`identity_sampling`): a tap within rounding of
    an integer takes the other one-sided derivative and moves its
    regressor's gradient by percents (readings with the recipe's
    regressors and dropout on, backbone max: 6.1e-4 to 4.3e-2 over runs).
    Every first compared step (a)'s two runs, the ranks of (b) and 26, and
    their emulations `split_grads` and `emulated_model_axis` takes the
    max-pool picks of one forward of the whole batch (`compared_picks`):
    fpn4 pools 1,179,648 windows, of which a few lie within rounding of a
    tie in any state, and a window that two summation orders pick apart
    routes one element's gradient elsewhere, a discrete difference.  At a
    state trained 9 steps the two emulated ranks picked 1 window apart from
    the whole batch, which put the backbone's gradients 2.47e-3 (median)
    and 3.25e-3 (largest) from it; on the whole batch's picks 7.5e-4 and
    1.1e-3 (`tools/run_phase25.py --pick-witness`, NVIDIA H100 80GB HBM3,
    700.00 W); the RVSA regressors' output-bias gradients cancel by
    Σ|terms| / |Σ terms| 6-14 only.  Without the shared picks the check
    read up to 1.2e-2 at phase 7's state.  The rest is the order of fp32
    summation: (b) runs its GEMMs,
    convolutions and reductions over 4 rows, (a) over 8.  `split_grads`
    runs (b)'s arithmetic in (a)'s process, with no process group, and
    phase 25 prints its distance from (a) beside (b)'s, and holds (b) to it
    by phase 6's own rule.  (a)'s DDP and plain runs, one computation,
    agree within 1e-5."""
    return dataclasses.replace(path, grad_stochastic=True)


def _state_digest(model) -> List[tuple]:
    """Each tensor of the state dict, as `bits_digest` or its values."""
    return [bits_digest(v) if v.is_floating_point() else tuple(v.reshape(-1).tolist())
            for v in model.state_dict().values()]


def _skip_reduction(params, *args, **kwargs):
    """The control's gradient reduction on rank 1: it takes part in the
    all-reduce (rank 0 would wait for it otherwise) and keeps its own
    gradients."""
    local = [None if p.grad is None else p.grad.clone() for p in params]
    n = pmesh.reduce_gradients(params, *args, **kwargs)
    for p, g in zip(params, local):
        p.grad = torch.zeros_like(p) if g is None else g
    return n


def _wait_for(cond, what: str, limit: float = DDP_WAIT) -> None:
    deadline = time.monotonic() + limit
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"waited {limit} s for {what}")
        time.sleep(0.1)


class DdpRanks:
    """Phase 25(b)'s and phase 26's two rank processes (`_ddp_rank`), spawned
    before phase 6 so that their imports, model construction (both phases'
    tasks) and copy to the card run beside phase 6's CPU-bound reference and
    not on phase 25's path: they then wait, idle through phase 7's timed
    steps, for the checkpoint of phase 7's state.  `close()` stops them and
    removes their directory."""

    def __init__(self, path: Path):
        self._dir = tempfile.TemporaryDirectory(prefix="mtp_chip_smoke_ddp_")
        self.tmp = self._dir.name
        self.batches = _ddp_batches(path)
        np.savez(os.path.join(self.tmp, "batches.npz"),
                 **{f"{k}{i}": b[k] for i, b in enumerate(self.batches) for k in b})
        self.tiles = eval_tiles(path)
        np.savez(os.path.join(self.tmp, "tiles.npz"), **self.tiles)
        ctx = torch.multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=_ddp_rank, args=(r, self.tmp), daemon=True)
                      for r in range(2)]
        for p in self.procs:
            p.start()

    def kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()

    def close(self) -> None:
        try:
            self.kill()
        finally:
            self._dir.cleanup()


def _ddp_rank(rank: int, tmp: str) -> None:
    """Phase 25(b)'s rank `rank` of 2, a spawned process on the one card:
    the task in fp32 (`DDP_FP32`) in a gloo world of 2 (NCCL takes one rank
    a card), phase 7's state restored from the checkpoint rank 0 of the
    parent's world wrote (after the parent's timed steps) and its RVSA
    regressors zeroed (`two_ranks_rule`); after the parent's "go", the
    control (one step in
    which rank 1 keeps its own gradients), then the state again and the
    compared steps on this rank's 4 rows of each global batch.  Writes,
    on a thread beside phase 26 (`_tp_rank`, which follows on the same two
    processes), rank 0's rank0.pt (the first step's gradients and the state
    after) and then rank{r}.json (the digests of the state after the
    control and after the steps, the metrics, times).  A failure writes
    rank{r}.err."""
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "gloo"), 2),
                                rank=rank, world_size=2)
        task = SegmentationTask(DDP_FP32, device="cuda:0")
        # no random weights: the checkpoint overwrites every tensor of the state
        no_init = lambda: mock.patch("mtp_tpu_torch.tasks._fit.init_weights",
                                     lambda model, gen: model)
        with no_init():
            state = task.init_state(_gen(SEED))
        with no_init():  # phase 26's task, sharded over the model axis
            tp_task = SegmentationTask(TP_FP32, device="cuda:0")
            tp_state = tp_task.init_state(_gen(SEED))
        with np.load(os.path.join(tmp, "batches.npz")) as f:
            batches = [{k: f[f"{k}{i}"] for k in ("image", "label")} for i in range(DDP_STEPS)]
        local = [pmesh.shard_batch(task.mesh, b) for b in batches]
        store = CheckpointStore(os.path.join(tmp, "ckpt"))
        with open(os.path.join(tmp, f"idle{rank}"), "w"):  # set up; idle from here
            pass
        _wait_for(lambda: store.steps(), "the checkpoint", DDP_WAIT_CHECKPOINT)
        t0 = time.perf_counter()
        store.restore(state)
        identity_sampling(state.model)  # the compared steps' state, as (a)'s
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        start = _state_snapshot(state)
        _wait_for(lambda: os.path.exists(os.path.join(tmp, "go")), "the parent's go")
        n = len(local[0]["image"])
        picks = rows_of(torch.load(os.path.join(tmp, "picks.pt"), weights_only=True),
                        rank * n, (rank + 1) * n)
        step_fn = task.train_step_fn(deterministic=True)
        skip = (mock.patch.object(core_train, "reduce_gradients", _skip_reduction)
                if rank == 1 else contextlib.nullcontext())
        with skip:
            state, _ = step_fn(state, to_device(local[0], task.device))
        control = _state_digest(state.model)
        _load_snapshot(state, start)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = _ddp_steps(step_fn, state, local, task.device, picks=picks)
        steps_s = time.perf_counter() - t0
        result = {"control": control, "digest": _state_digest(state.model),
                  "metrics": out["metrics"], "rows": len(local[0]["image"]),
                  "restore_s": restore_s, "steps_s": steps_s}

        def write_result():  # beside phase 26: rank0.pt first, then the file the parent awaits
            if rank == 0:
                torch.save({"grads": out["grads"], "state": out["state"]},
                           os.path.join(tmp, "rank0.pt"))
            done = os.path.join(tmp, f"rank{rank}.json")
            with open(done + ".tmp", "w") as f:
                json.dump(result, f)
            os.replace(done + ".tmp", done)

        writer = ThreadPoolExecutor(max_workers=1)
        written = writer.submit(write_result)
        del state, start, task, step_fn
        free()
        _tp_rank(rank, tmp, tp_task, tp_state, batches, store)
        written.result()
        writer.shutdown()
        store.close()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _time_steps(task, state, snap: dict, batches: List[dict]) -> dict:
    """The recipe's bf16 step with the process group (the task's DDP step)
    and without (the plain step), A B B A blocks of DDP_TIMED steps after a
    warm-up step each, from `snap`: each step's ms."""
    fns = {"ddp": task.train_step_fn(),
           "plain": make_train_step(lambda m, b, g: task.loss_fn(m, b, g))}
    on_card = [to_device(b, task.device) for b in batches]
    _load_snapshot(state, snap)
    times = {"ddp": [], "plain": []}
    for name in ("plain", "ddp", "ddp", "plain"):
        fns[name](state, on_card[0])
        torch.cuda.synchronize()
        with timed_window():
            for i in range(DDP_TIMED):
                t0 = time.perf_counter()
                fns[name](state, on_card[i % DDP_STEPS])
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
    return times


def phase_ddp(state, path: Path, card: str, ranks: DdpRanks,
              background: Callable = lambda: None) -> dict:
    """Phase 25, the DDP step (`parallel.mesh`, `core.train.make_train_step`
    with a process group) of the ViT recipe at full width and depth, from
    phase 7's state (batch 8 of 384²: each compared step on its own global
    batch; drop-path and dropout on, drawn from the state's generator).
    (a) In this process, an NCCL group of one rank (a FileStore, no TCP):
    the recipe's bf16 step with and without the process group (A B B A
    blocks of DDP_TIMED steps), the all-reduce alone and the bytes it
    reduces a step; then, from the state at identity RVSA sampling and
    without dropout or drop-path (`two_ranks_rule`), DDP_STEPS fp32 steps
    through the DDP step and through the plain one, each from a copy of the
    state, held by `_ddp_verdict`, the DDP step's launches exact; and the
    witness `split_grads`, the first batch as two ranks of 4 rows emulated
    in this process, against the whole batch (printed).  (b) `ranks`, two
    processes on the card in a gloo group (NCCL refuses two ranks on one
    card), each on its 4 rows of the same global batches, from the
    checkpoint of phase 7's state that this process writes as rank 0
    after (a)'s timed steps (`CheckpointStore`; they restore it, zero its
    RVSA regressors, and run (b) while (a) compares,
    which is not timed): the ranks' states bit for bit equal after the
    steps, rank 0's first gradients against the witness's by phase 6's
    rule, rank 0's run against (a)'s DDP run by `_ddp_verdict` under
    `two_ranks_rule`; and a control, one step in which rank 1 keeps its own
    gradients, whose states must differ.
    A rank that fails fails the phase.  `background()` runs on a thread of
    this process from the end of (a)'s timed steps (CPU work beside the
    card's untimed fp32 steps and while this process waits for the ranks:
    phases 25c and 25d's CPU references); returns {"snap", "batches", "a",
    "b", "extra": what it returned}."""
    tag, tmp, batches = "[ddp]", ranks.tmp, ranks.batches
    snap = _state_snapshot(state, "cuda")
    start = snap["model"]
    opt = state.optimizer
    lr_sum = sum(opt.schedule(snap["count"] + i) for i in range(DDP_STEPS))
    adam = {opt.names[p]: 2 * lr_sum * g["lr_scale"]
            for g in opt.adamw.param_groups for p in g["params"]}
    per_step = {k: v * DDP_STEPS for k, v in path.per_step.items()}
    on_card = lambda t: t.detach().clone()
    try:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "nccl"), 1),
                                rank=0, world_size=1)
        # (a) times, the recipe's bf16 (the ranks wait, idle, for the checkpoint)
        t16 = SegmentationTask(path.recipe, model=state.model)
        if not t16.mesh.distributed:
            raise AssertionError("no process group under the task's mesh")
        times = _time_steps(t16, state, snap, batches)
        params = [p for p in state.model.parameters() if p in state.optimizer.names]
        nbytes = pmesh.reduce_gradients(params)
        reduce_ms = loop_ms(lambda: pmesh.reduce_gradients(params), reps=5, warmup=1)
        med = {k: statistics.median(v) for k, v in times.items()}
        log(f"{tag} (a) times, bf16 recipe step (batch 8 of 384²), A B B A blocks of "
            f"{DDP_TIMED}: with the process group (NCCL, one rank) median "
            f"{med['ddp']:.2f} ms (each {' '.join(f'{t:.1f}' for t in times['ddp'])}), "
            f"without {med['plain']:.2f} ms (each "
            f"{' '.join(f'{t:.1f}' for t in times['plain'])}), ratio "
            f"{med['ddp'] / med['plain']:.3f}; the gradient all-reduce alone "
            f"{reduce_ms:.3f} ms for {nbytes / 2 ** 20:.1f} MiB a step in "
            f"{-(-nbytes // (4 * pmesh.BUCKET_ELEMENTS))} fp32 buckets of "
            f"{pmesh.BUCKET_ELEMENTS * 4 / 2 ** 20:.0f} MiB ({len(params)} parameters) "
            f"| card {card}")
        del t16, params
        # phase 7's state for the ranks, which restore it (and zero its RVSA
        # regressors, as (a) does below) beside what follows, none of it timed;
        # saved as loaded from its snapshot, the moments in the parameters' order
        _load_snapshot(state, snap)
        store = CheckpointStore(os.path.join(tmp, "ckpt"))
        t0 = time.perf_counter()
        store.save(state.step, state)  # rank 0 writes; in the background
        save_s = time.perf_counter() - t0
        del snap
        identity_sampling(state.model)  # the compared steps' state (see two_ranks_rule)
        snap = _state_snapshot(state, "cuda")
        start = snap["model"]
        t32 = SegmentationTask(DDP_FP32, model=state.model)
        picks = compared_picks(t32, state, snap, batches[0])  # every first compared step's
        torch.save(picks, os.path.join(tmp, "picks.pt"))
        pool = ThreadPoolExecutor(max_workers=1)
        extra = pool.submit(background)  # from here on nothing of this phase is timed
        pool.shutdown(wait=False)
        # the ranks' (b) runs beside the rest of (a), which is not timed
        with open(os.path.join(tmp, "go"), "w"):
            pass
        t_go = time.perf_counter()

        # (a) one rank: the DDP step against the plain one, fp32
        runs = {}
        loss_fn = lambda m, b, g: t32.loss_fn(m, b, g, deterministic=True)
        for name, step_fn in (("ddp", t32.train_step_fn(deterministic=True)),
                              ("plain", make_train_step(loss_fn))):
            _load_snapshot(state, snap)
            torch.cuda.synchronize()
            reset_counters()
            runs[name] = _ddp_steps(step_fn, state, batches, t32.device, on_card, picks)
            if name == "ddp" and counters() != per_step:
                raise AssertionError(f"DDP step launches {counters()} != {per_step}")
        ok, summary = _ddp_verdict(path, runs["ddp"], runs.pop("plain"), start, adam)
        log(f"{tag} (a) NCCL, one rank: {DDP_STEPS} fp32 DDP steps vs the plain step from "
            f"phase 7's state (step {snap['step']}), batch {len(batches[0]['image'])} of "
            f"384², identity RVSA sampling, no dropout or drop-path: {summary}; "
            f"launches {per_step}")
        if not ok:
            raise AssertionError(f"the DDP step differs from the plain step: {summary}")
        # the witness: (b)'s arithmetic in this process against the whole batch's
        _load_snapshot(state, snap)
        split = split_grads(lambda m, b: t32.loss_fn(m, b, None, deterministic=True)[0],
                            state.model, to_device(batches[0], t32.device), picks)
        _, summary = _grad_verdict(path, (runs["ddp"]["metrics"][0]["loss"],
                                          runs["ddp"]["grads"]), split)
        log(f"{tag} (a) the same state's first compared batch as two emulated ranks of 4 "
            f"rows in this process (`split_grads`, no process group; each rank's max-pools "
            f"take its rows of the whole batch's {sum(i.numel() for i in picks.values())} "
            f"picks) against the whole batch of 8 (the DDP run above): {summary} | card {card}")
        store.close()
        del t32
    except BaseException:
        ranks.kill()
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    free()

    # (b) two ranks, gloo, on the one card; then phase 26 on the same processes
    procs = ranks.procs
    beside = time.perf_counter() - t_go
    try:
        _wait_for(lambda: all(os.path.exists(os.path.join(tmp, f"rank{r}.json"))
                              or not p.is_alive() for r, p in enumerate(procs)),
                  "the ranks' steps")
        t_join = time.perf_counter() - t_go
        _rank_errors(ranks, "phase 25(b)", lambda r: os.path.exists(
            os.path.join(tmp, f"rank{r}.json")))
        b_result = _ddp_b_verdict(path, ranks, runs, start, adam, split, save_s, beside,
                                  t_join, extra)
        # phase 26's references, in this process while the ranks run it
        t0 = time.perf_counter()
        tp_ref = tp_references(state, snap, batches, ranks, picks)
        t_ref = time.perf_counter() - t0
        deadline = time.monotonic() + DDP_WAIT
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        log(f"[tp] after (b)'s verdict: phase 26's references in this process {t_ref:.1f} s, "
            f"then the ranks' end {time.perf_counter() - t0 - t_ref:.1f} s more")
    finally:
        ranks.kill()
    _rank_errors(ranks, "phase 26", lambda r: procs[r].exitcode == 0)
    with phase_time("the model axis (phase 26's verdict)"):
        phase_tp(path, card, ranks, runs["ddp"], start, adam, tp_ref, med["plain"])
    _load_snapshot(state, snap)
    return {"snap": snap, "batches": batches, "a": runs["ddp"], "extra": b_result}


def _rank_errors(ranks: DdpRanks, what: str, done: Callable[[int], bool]) -> None:
    """Raise with each rank's traceback when a rank has not done its part."""
    tmp = ranks.tmp
    errors = [f"rank {r} exit {p.exitcode}: " + (
        open(os.path.join(tmp, f"rank{r}.err")).read()[-3000:]
        if os.path.exists(os.path.join(tmp, f"rank{r}.err")) else "no traceback")
        for r, p in enumerate(ranks.procs) if not done(r)]
    if errors:
        raise AssertionError(f"{what}: " + "\n".join(errors))


def _ddp_b_verdict(path: Path, ranks: DdpRanks, runs: dict, start, adam, split, save_s: float,
                   beside: float, t_join: float, extra):
    """Phase 25(b)'s verdict from the ranks' files (see `phase_ddp`); returns
    what the background work returned."""
    tmp, tag = ranks.tmp, "[ddp]"
    ranks_out = [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(2)]
    got = torch.load(os.path.join(tmp, "rank0.pt"), map_location="cuda", weights_only=True)
    got["metrics"] = ranks_out[0]["metrics"]
    equal = ranks_out[0]["digest"] == ranks_out[1]["digest"]
    control_equal = ranks_out[0]["control"] == ranks_out[1]["control"]
    ok, summary = _ddp_verdict(two_ranks_rule(path), got, runs["ddp"], start, adam)
    split_ok, split_summary = _grad_verdict(path, split, (got["metrics"][0]["loss"],
                                                          got["grads"]))
    t_extra = time.perf_counter()
    extra = extra.result()  # the background work's, or its error
    t_extra = time.perf_counter() - t_extra
    log(f"{tag} (b) gloo, 2 processes on the card, {ranks_out[0]['rows']} rows each of the "
        f"same global batches: ranks' states after {DDP_STEPS} steps bit for bit equal "
        f"{equal}; rank 0's first gradients vs the two ranks emulated in one process: "
        f"{split_summary}; rank 0 vs (a)'s one-process DDP step: {summary}; control, rank 1 keeping "
        f"its own gradients for one step: states equal {control_equal} (must differ); "
        f"checkpoint snapshot for the ranks {save_s:.1f} s, (a)'s untimed rest beside "
        f"their (b) {beside:.1f} s; restore {ranks_out[0]['restore_s']:.1f} / "
        f"{ranks_out[1]['restore_s']:.1f} s, {DDP_STEPS} fp32 steps "
        f"{ranks_out[0]['steps_s']:.1f} / {ranks_out[1]['steps_s']:.1f} s, the ranks' (b) after "
        f"the go {t_join:.1f} s; the background work waited for {t_extra:.1f} s more")
    if not equal:
        raise AssertionError("the two ranks' states differ after the DDP steps")
    if not split_ok:
        raise AssertionError(f"the two-rank step differs from its arithmetic in one "
                             f"process: {split_summary}")
    if not ok:
        raise AssertionError(f"the two-rank step differs from the one-rank step: {summary}")
    if control_equal:
        raise AssertionError("the control (rank 1 without the reduction) passed")
    return extra


# --------------------------------------------------------------- phase 26 --

# the model axis (`parallel.tensor`) of the ViT recipe on phase 25's two rank
# processes: data 1 × model 2 (8 of the 16 heads, qkv 1,536 rows and MLP
# 2,048 a rank), two gloo ranks on the one card (NCCL takes one rank a card,
# so no NCCL time is measured here), compared in fp32 as phase 25 compares
TP_MESH = MeshConfig(data=1, model=2)
TP_FP32 = dataclasses.replace(DDP_FP32, train=dataclasses.replace(DDP_FP32.train,
                                                                  mesh=TP_MESH))
TP_BF16 = dataclasses.replace(RVSA, train=dataclasses.replace(RVSA.train, mesh=TP_MESH))
TP_TIMED = 1       # bf16 steps timed at model 2, after one warm-up step
TIE_GAP = 1e-4     # pixels whose top two fp32 logits lie this close may differ


def _partial_grads(model) -> Dict[str, torch.Tensor]:
    """This rank's gradients of the whole parameters each model rank
    computes for its heads only (`parallel.tensor.PARTIAL`), on the host."""
    return {n: p.grad.detach().to("cpu", copy=True) for n, p in model.named_parameters()
            if ptensor.PARTIAL.search(n)}


def _bias_on_every_rank(self, x: torch.Tensor) -> torch.Tensor:
    """The control's row-parallel linear: the bias added on every rank
    before the sum (T times in all)."""
    y = F.linear(x, self.weight, self.bias)
    return ptensor.reduce_from_model_group(y.float(), self.tp).to(y.dtype)


ROW_BIAS = re.compile(r"(?:^|\.)(?:attn\.proj|mlp\.fc2)\.bias$")


# the seeded row-parallel biases' std (`bias_loss`).  At 0.02 the control
# (each bias counted on both ranks) moved the loss by 8.9e-6 to 1.9e-4 of it
# over states trained 9 to 16 steps (`tools/run_phase25.py --repeat 8`,
# NVIDIA H100 80GB HBM3, 700.00 W), once inside LOSS_RTOL; the check itself
# read 0 to 2.3e-7
ROW_BIAS_STD = 0.1


def bias_loss(task, state, batch: dict) -> float:
    """The fp32 loss of the first compared batch, deterministic, after the
    row-parallel layers' biases (attn.proj, mlp.fc2) are set to seeded
    N(0, ROW_BIAS_STD²) values (phase 7's are near 0: the recipe's warm-up
    has barely moved them, so a bias counted twice would hide in
    rounding); the state's tensors are left changed (BatchNorm's
    statistics too)."""
    g = _gen(SEED + 70)
    with torch.no_grad():
        for name, p in sorted(state.model.named_parameters()):
            if ROW_BIAS.search(name):
                p.copy_(torch.randn(p.shape, generator=g) * ROW_BIAS_STD)
        loss, _ = task.loss_fn(state.model, to_device(batch, task.device), None,
                               deterministic=True)
    return float(loss)


def _ckpt_equal(a: dict, b: dict) -> Tuple[bool, str]:
    """Whether two checkpoints hold the same step, update count, generator
    and tensors, bit for bit (the first difference named)."""
    if (a["step"], a["optimizer"]["count"]) != (b["step"], b["optimizer"]["count"]):
        return False, "step or count"
    if not torch.equal(a["generator"], b["generator"]):
        return False, "generator"
    for key in ("model", "moments"):
        x = a["model"] if key == "model" else a["optimizer"]["moments"]
        y = b["model"] if key == "model" else b["optimizer"]["moments"]
        if list(x) != list(y):
            return False, f"{key} keys"
        for name in x:
            pair = zip(x[name], y[name]) if key == "moments" else [(x[name], y[name])]
            if not all(torch.equal(u, v) for u, v in pair):
                return False, f"{key} {name}"
    return True, f"{len(a['model'])} tensors, {len(a['optimizer']['moments'])} moment pairs"


def same_bytes(a: str, b: str, block: int = 1 << 26) -> bool:
    """Whether two files hold the same bytes, read 64 MiB at a time
    (`filecmp` reads 8 KiB at a time)."""
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x = fa.read(block)
            if x != fb.read(block):
                return False
            if not x:
                return True


def tp_saved_equal(ranks: DdpRanks, step: int) -> Tuple[bool, str]:
    """Phase 26's gathered save of the restored state (`ckpt_tp`) against
    phase 7's checkpoint (`ckpt`): the same bytes, or else the same
    contents (`_ckpt_equal`)."""
    files = [os.path.join(ranks.tmp, d, f"{step}.pt") for d in ("ckpt_tp", "ckpt")]
    _wait_for(lambda: os.path.exists(files[0]), "phase 26's gathered save")
    if same_bytes(*files):
        return True, "the same bytes"
    return _ckpt_equal(*(torch.load(f, map_location="cpu", weights_only=True) for f in files))


def _tp_rank(rank: int, tmp: str, task, state, batches: List[dict],
             store: CheckpointStore) -> None:
    """Phase 26 on rank `rank` of the model group of 2 (data 1: both ranks
    take the whole global batch): phase 7's state restored from `store`'s
    whole-layout checkpoint into the sharded state; a gathered save of it
    (`ckpt_tp`; every rank gathers, rank 0 writes); the loss on seeded
    row-parallel biases (`bias_loss`), and control 2, the same with the
    bias added on both ranks; the DDP_STEPS compared fp32 steps (launches
    counted, peak memory); an fp32 `evaluate` of the snapshot on phase 7's
    tiles (the confusion counts and each pixel's class); TP_TIMED bf16
    steps of the recipe.  Writes tp{r}.json, tp{r}.npz (the classes) and
    tp{r}.pt (rank 0: the first step's gathered gradients and the whole
    state after; rank 1: its partial gradients of the first step after the
    model-group sum, and, control 1, before it: what rank 1 would keep
    without the sum)."""
    t_phase = time.perf_counter()
    store.restore(state)
    torch.cuda.synchronize()
    dev = task.device
    out = {"restore_s": time.perf_counter() - t_phase}
    # the gathered save of the restored state (every rank gathers, rank 0 writes)
    t0 = time.perf_counter()
    store = CheckpointStore(os.path.join(tmp, "ckpt_tp"))
    store.save(state.step, state)  # written on the store's thread while the steps run
    out["save_s"] = time.perf_counter() - t0
    identity_sampling(state.model)  # the compared steps' state, as (a)'s
    start = _state_snapshot(state, dev)
    on_card = [to_device(b, dev) for b in batches]
    step_fn = task.train_step_fn(deterministic=True)
    saved = {}
    # control 2: the row-parallel bias added on every rank, on seeded biases
    out["bias_loss"] = bias_loss(task, state, batches[0])
    _load_snapshot(state, start)
    with mock.patch.object(ptensor.RowParallelLinear, "forward", _bias_on_every_rank):
        out["control2_loss"] = bias_loss(task, state, batches[0])
    _load_snapshot(state, start)
    # the compared steps
    torch.cuda.synchronize()
    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    pre_sum, reduce = {}, core_train.reduce_partial_gradients

    def record(model):  # control 1: the first step's partial gradients before the sum
        if not pre_sum:
            pre_sum.update(_partial_grads(model))
        return reduce(model)

    picks = torch.load(os.path.join(tmp, "picks.pt"), weights_only=True)  # data 1: all rows
    t0 = time.perf_counter()
    with mock.patch.object(core_train, "reduce_partial_gradients", record):
        run = _ddp_steps(step_fn, state, on_card, dev, keep=lambda t: t.detach().clone(),
                         picks=picks)
    torch.cuda.synchronize()
    out["steps_s"] = time.perf_counter() - t0
    out["launches"] = counters()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["metrics"] = run["metrics"]
    grads = ptensor.gather_state_dict(task.mesh, run["grads"])
    whole = ptensor.full_state_dict(state.model)
    out["whole_digest"] = [bits_digest(v) for k, v in whole.items()
                           if ptensor.sharded_dim(k) is None and v.is_floating_point()]
    host = lambda t: t.detach().to("cpu", copy=True)  # the steps below change the state
    if rank == 0:
        saved.update(grads={k: host(v) for k, v in grads.items()},
                     state={k: host(v) for k, v in whole.items()})
    else:
        saved["partial"] = {n: host(g) for n, g in run["grads"].items()
                            if ptensor.PARTIAL.search(n)}
        saved["control1"] = pre_sum
    del run, grads, whole
    writer = ThreadPoolExecutor(max_workers=1)
    written = writer.submit(torch.save, saved, os.path.join(tmp, f"tp{rank}.pt"))
    # evaluate the snapshot, fp32, on phase 7's tiles
    _load_snapshot(state, start)
    with np.load(os.path.join(tmp, "tiles.npz")) as f:
        tiles = {k: f[k] for k in f.files}
    counts, classes = [], []
    add, reduce = pmetrics.SegAccumulator.add, pmetrics.SegAccumulator.all_reduce

    def record_add(acc, pred, label):
        classes.append(torch.as_tensor(pred).cpu().numpy().astype(np.uint8))
        return add(acc, pred, label)

    def record_reduce(acc):
        got = reduce(acc)
        counts.append(np.stack([acc.i, acc.u, acc.p, acc.l]).tolist())
        return got

    t0 = time.perf_counter()
    with mock.patch.object(pmetrics.SegAccumulator, "add", record_add), \
            mock.patch.object(pmetrics.SegAccumulator, "all_reduce", record_reduce):
        out["eval"] = task.evaluate(state, iter([tiles]))
    out["eval_s"] = time.perf_counter() - t0
    out["counts"] = counts
    np.savez(os.path.join(tmp, f"tp{rank}.npz"), *classes)
    # the recipe's bf16 step at model 2 (dropout and drop-path on)
    t16 = SegmentationTask(TP_BF16, model=state.model, device=dev)
    bf16 = t16.train_step_fn()
    times = []
    for i in range(TP_TIMED + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bf16(state, on_card[i % DDP_STEPS])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["bf16_ms"] = times[1:]
    written.result()
    writer.shutdown()
    store.close()  # waits for the gathered save's write
    out["wall_s"] = time.perf_counter() - t_phase
    with open(os.path.join(tmp, f"tp{rank}.json"), "w") as f:
        json.dump(out, f)


@contextlib.contextmanager
def emulated_model_axis(model, T: int = 2):
    """Within the block, the whole `model` computes as T model ranks do, in
    one process with no process group: each attention runs once a group of
    num_heads / T heads (its qkv rows, its K1-K6 calls at that head count,
    its proj columns), each MLP once a block of hidden / T, and the
    row-parallel products are summed in fp32 in rank order, the bias added
    once after (`parallel.tensor.RowParallelLinear`).  Autograd sums what
    the groups give each input and each whole parameter, as the copy's
    all-reduce and `reduce_partial_gradients` do.  Phase 26's witness: the
    model axis's arithmetic without the processes."""
    from mtp_tpu_torch.models.vit_rvsa import FullAttention, Mlp, RVSAAttention

    def reduced(parts, bias):
        y = parts[0].float()
        for p in parts[1:]:
            y = y + p.float()
        return (y + bias.float()).to(parts[0].dtype)

    def mlp(self, x):
        H = self.fc1.out_features // T
        blocks = [slice(t * H, (t + 1) * H) for t in range(T)]
        return reduced([F.linear(self.act(F.linear(x, self.fc1.weight[b], self.fc1.bias[b])),
                                 self.fc2.weight[:, b]) for b in blocks], self.fc2.bias)

    def attention(forward):
        def run(self, x):
            n, hd, C = self.total_heads // T, self.head_dim, self.qkv.in_features
            qkv, proj = self.qkv, self.proj
            parts = []
            try:
                for t in range(T):
                    rows = torch.cat([torch.arange(p * C + t * n * hd, p * C + (t + 1) * n * hd)
                                      for p in range(3)]).to(qkv.weight.device)
                    cols = slice(t * n * hd, (t + 1) * n * hd)
                    self.__dict__["qkv"] = lambda z, r=rows: F.linear(
                        z, qkv.weight[r], None if qkv.bias is None else qkv.bias[r])
                    self.__dict__["proj"] = lambda z, c=cols: F.linear(z, proj.weight[:, c])
                    self.num_heads, self.h0 = n, t * n
                    parts.append(forward(self, x))
            finally:
                del self.__dict__["qkv"], self.__dict__["proj"]
                self.num_heads, self.h0 = self.total_heads, 0
            return reduced(parts, proj.bias)
        return run

    with mock.patch.object(Mlp, "forward", mlp), \
            mock.patch.object(FullAttention, "forward", attention(FullAttention.forward)), \
            mock.patch.object(RVSAAttention, "forward", attention(RVSAAttention.forward)):
        yield


def tp_references(state, snap: dict, batches: List[dict], ranks: DdpRanks,
                  picks: Dict[tuple, torch.Tensor]) -> dict:
    """Phase 26's references, in the parent at one rank from phase 7's state
    (`snap`, identity sampling), while the ranks run the phase: the fp32
    `evaluate` on the tiles (its confusion counts, each pixel's class and
    the gap between its top two logits), the loss on seeded row-parallel
    biases (`bias_loss`), the first compared batch's loss and gradients
    under `emulated_model_axis` (with the compared picks), and whether the
    ranks' gathered save
    equals phase 7's checkpoint (`tp_saved_equal`)."""
    times = {}
    t0 = time.perf_counter()
    _load_snapshot(state, snap)
    task = SegmentationTask(DDP_FP32, model=state.model)
    counts, logits = [], []
    reduce, slide = pmetrics.SegAccumulator.all_reduce, task.slide_logits

    def record_reduce(acc):
        got = reduce(acc)
        counts.append(np.stack([acc.i, acc.u, acc.p, acc.l]).tolist())
        return got

    def record_logits(*args, **kwargs):
        logits.append(slide(*args, **kwargs))
        return logits[-1]

    with mock.patch.object(pmetrics.SegAccumulator, "all_reduce", record_reduce), \
            mock.patch.object(task, "slide_logits", record_logits):
        metrics = task.evaluate(state, iter([ranks.tiles]))
    top2 = logits[0].topk(2, -1).values
    out = {"metrics": metrics, "counts": counts,
           "classes": logits[0].argmax(-1).cpu().numpy().astype(np.uint8),
           "gap": (top2[..., 0] - top2[..., 1]).cpu().numpy()}
    del logits, top2
    times["evaluate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["bias_loss"] = bias_loss(task, state, batches[0])
    _load_snapshot(state, snap)
    state.model.zero_grad(set_to_none=True)
    with emulated_model_axis(state.model), fixed_pool_picks(picks):
        loss, _ = task.loss_fn(state.model, to_device(batches[0], task.device), None,
                               deterministic=True)
        loss.backward()
    out["emulated"] = (float(loss), {n: p.grad.detach().clone()
                                     for n, p in state.model.named_parameters()})
    state.model.zero_grad(set_to_none=True)
    _load_snapshot(state, snap)
    times["bias loss and emulation"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["saved_equal"] = tp_saved_equal(ranks, snap["step"])
    times["the gathered save's comparison"] = time.perf_counter() - t0
    log("[tp] phase 26's references in this process: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in times.items()))
    return out


def phase_tp(path: Path, card: str, ranks: DdpRanks, ref: dict, start: Dict[str, torch.Tensor],
             adam: Dict[str, float], tp_ref: dict, plain_ms: float) -> None:
    """Phase 26's verdict, after the rank processes end (data 1 × model 2,
    from phase 7's state at identity RVSA sampling, no dropout or
    drop-path).  Rank 0's first gathered gradients and loss against the
    model axis's arithmetic emulated in this process (`tp_ref["emulated"]`,
    `emulated_model_axis`) by phase 6's rule, and rank 1's partial gradients
    likewise, and the first grad_norm within 1e-5 of the emulation's;
    against phase 25(a)'s one-rank run from the same state (`ref`) each
    step's loss (LOSS_RTOL) and, by `two_ranks_rule` as phase 25(b), each
    grad_norm, the first step's gradients and the whole state after
    (`_ddp_verdict`): this state's gradients move by ~1e-3, and its norm
    by ~1e-5, under any change of fp32 summation order (the emulation's
    distance from (a), printed beside); the launches of a rank equal to
    the one-rank step's; the loss on seeded row-parallel biases within
    LOSS_RTOL of one rank's (`bias_loss`); the controls must fail: rank 1
    without the model-group sum (its partial gradients by phase 6's rule)
    and the row-parallel bias on both ranks (the loss on the seeded
    biases); the fp32 `evaluate` at model 2 equal to one rank's, each
    pixel's class but where the top two logits lie within TIE_GAP (the
    confusion counts too when no such pixel differs); the gathered save
    of the restored state equal to phase 7's checkpoint bit for bit."""
    tmp, tag = ranks.tmp, "[tp]"
    outs = [json.load(open(os.path.join(tmp, f"tp{r}.json"))) for r in range(2)]
    dev = next(iter(ref["grads"].values())).device
    saved = [torch.load(os.path.join(tmp, f"tp{r}.pt"), map_location=dev, weights_only=True)
             for r in range(2)]
    got = {"grads": saved[0]["grads"], "state": saved[0]["state"],
           "metrics": outs[0]["metrics"]}
    loss0, emulated = ref["metrics"][0]["loss"], tp_ref["emulated"]
    e_ok, e_summary = _grad_verdict(path, emulated, (got["metrics"][0]["loss"], got["grads"]))
    _, ea_summary = _grad_verdict(path, (loss0, ref["grads"]), emulated)
    ok, summary = _ddp_verdict(two_ranks_rule(path), got, ref, start, adam)
    e_norm = math.sqrt(sum(float(g.double().square().sum()) for g in emulated[1].values()))
    norm_rel = abs(got["metrics"][0]["grad_norm"] - e_norm) / e_norm
    names = list(saved[1]["partial"])
    part_ref = (emulated[0], {n: emulated[1][n] for n in names})
    part_ok, part_summary = _grad_verdict(path, part_ref, (emulated[0], saved[1]["partial"]))
    c1_ok, c1_summary = _grad_verdict(path, part_ref, (emulated[0], saved[1]["control1"]))
    b_ref = tp_ref["bias_loss"]
    b_rel = abs(outs[0]["bias_loss"] - b_ref) / abs(b_ref)
    c2_rel = abs(outs[0]["control2_loss"] - b_ref) / abs(b_ref)
    per_step = {k: v * DDP_STEPS for k, v in path.per_step.items()}
    launches = [o["launches"] for o in outs]
    # evaluate
    tie = tp_ref["gap"] < TIE_GAP
    with np.load(os.path.join(tmp, "tp0.npz")) as f:
        classes = np.concatenate([f[k] for k in f.files])
    differ = classes != tp_ref["classes"]
    counts_equal = outs[0]["counts"] == tp_ref["counts"]
    eval_ok = (not (differ & ~tie).any() and (differ.any() or counts_equal)
               and outs[0]["counts"] == outs[1]["counts"])
    saved_equal = tp_ref["saved_equal"]
    replicas = outs[0]["whole_digest"] == outs[1]["whole_digest"]
    rank_ms = [statistics.median(o["bf16_ms"]) for o in outs]
    log(f"{tag} data 1 × model 2, two gloo ranks on the card (8 heads, qkv 1,536 rows, MLP "
        f"2,048 a rank), first step from phase 7's state against the model axis's "
        f"arithmetic emulated in this process (`emulated_model_axis`): {e_summary}; rank 1's "
        f"partial gradients against it: {part_summary}")
    log(f"{tag} the emulation against phase 25(a)'s one-rank step (summation order alone): "
        f"{ea_summary}")
    log(f"{tag} rank 0 against phase 25(a)'s one-rank step, {DDP_STEPS} fp32 steps: "
        f"{summary}; the first grad_norm against the emulation's rel {norm_rel:.3e} (tol "
        f"1e-5); launches a rank {launches[0]} / {launches[1]}, one rank's {per_step}")
    log(f"{tag} on seeded row-parallel biases (N(0, {ROW_BIAS_STD}²)) the first batch's loss "
        f"at model "
        f"2 against one rank's: rel {b_rel:.3e} (LOSS_RTOL {LOSS_RTOL}); controls: rank 1 "
        f"without the model-group sum of the partial gradients: within {c1_ok} (must fail: "
        f"{c1_summary}); the row-parallel bias on both ranks: loss rel {c2_rel:.3e} (must "
        f"exceed LOSS_RTOL)")
    log(f"{tag} fp32 evaluate at model 2 on {len(classes)} tile(s) of "
        f"{classes.shape[1]}²: {outs[0]['eval']['mIoU']:.4f} mIoU, one rank "
        f"{tp_ref['metrics']['mIoU']:.4f}; pixels whose class differs {int(differ.sum())}, "
        f"pixels whose top two logits lie within {TIE_GAP} {int(tie.sum())}; confusion "
        f"counts equal {counts_equal}; gathered save of the restored state against phase 7's "
        f"checkpoint: {saved_equal}; the two ranks' whole parameters bit for bit equal after "
        f"the steps {replicas}")
    log(f"{tag} times, rank 0 / 1: restore {outs[0]['restore_s']:.1f} / "
        f"{outs[1]['restore_s']:.1f} s, gathered save {outs[0]['save_s']:.1f} / "
        f"{outs[1]['save_s']:.1f} s, {DDP_STEPS} fp32 steps "
        f"{outs[0]['steps_s']:.1f} / {outs[1]['steps_s']:.1f} s, evaluate "
        f"{outs[0]['eval_s']:.1f} / {outs[1]['eval_s']:.1f} s; peak "
        f"{outs[0]['peak_gib']:.2f} / {outs[1]['peak_gib']:.2f} GiB a rank; bf16 recipe step "
        f"(batch 8 of 384²) at model 2, gloo through the host: "
        f"{rank_ms[0]:.1f} / {rank_ms[1]:.1f} ms, the one-rank step without a group "
        f"(phase 25(a)) {plain_ms:.1f} ms; the phase after (b) {outs[0]['wall_s']:.1f} / "
        f"{outs[1]['wall_s']:.1f} s | card {card}")
    if not e_ok:
        raise AssertionError(f"phase 26: model 2 differs from its arithmetic in one "
                             f"process: {e_summary}")
    if not part_ok:
        raise AssertionError(f"phase 26: rank 1's partial gradients: {part_summary}")
    if not norm_rel <= 1e-5:
        raise AssertionError(f"phase 26: grad_norm {got['metrics'][0]['grad_norm']} against "
                             f"the emulation's {e_norm}")
    if not ok:
        raise AssertionError(f"phase 26: model 2 differs from model 1: {summary}")
    if launches[0] != per_step or launches[1] != per_step:
        raise AssertionError(f"phase 26: launches {launches} != {per_step}")
    if not b_rel <= LOSS_RTOL:
        raise AssertionError(f"phase 26: the loss on seeded biases differs: {b_rel:.3e}")
    if c1_ok:
        raise AssertionError("phase 26: the control without the model-group sum passed")
    if not c2_rel > LOSS_RTOL:
        raise AssertionError("phase 26: the control with the bias on both ranks passed")
    if not eval_ok:
        raise AssertionError("phase 26: evaluate at model 2 differs from one rank's")
    if not saved_equal[0]:
        raise AssertionError(f"phase 26: the gathered save differs: {saved_equal[1]}")


def _run_grads(model, x: torch.Tensor, cots, device: str):
    """(outputs on the host, (value, gradients on the host), seconds) of one
    forward on `device` and the backward of Σ output · cot over the outputs
    (random cotangents: every gradient a sum of terms of both signs, as a
    loss's are).  The value compared is ½ Σ output² in float64, whose terms
    are all positive: Σ output · cot itself is a sum whose terms cancel, so
    its relative rounding says nothing."""
    t0 = time.perf_counter()
    out = model(x.to(device))
    out = out if isinstance(out, tuple) else (out,)
    sum((o * c.to(o.device)).sum() for o, c in zip(out, cots)).backward()
    value = sum(0.5 * float(o.detach().double().square().sum()) for o in out)
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return [o.detach().cpu() for o in out], (value, grads), time.perf_counter() - t0


def _card_vs_cpu(tag: str, what: str, model_cpu, x, cots, ref, rule, expected=None) -> None:
    """The card's run of `model_cpu` against its CPU run `ref` (from
    `_run_grads`): each output within SLICE_TOL of its max |ref|, the
    gradients by phase 6's rule (`_grad_verdict`, `rule`), the TF32 control,
    and, with `expected`, the card's launches."""
    card_model = copy.deepcopy(model_cpu).cuda()
    torch.cuda.synchronize()
    reset_counters()
    got, got_g, t_gpu = _run_grads(card_model, x, cots, "cuda")
    torch.cuda.synchronize()
    launched = counters()
    rels = [((g - r).abs().max() / r.abs().max()).item() for g, r in zip(got, ref[0])]
    ok, summary = _grad_verdict(rule, ref[1], got_g)
    _tf32(True)
    try:
        control_ok, control = _grad_verdict(rule, ref[1],
                                            _run_grads(card_model, x, cots, "cuda")[1])
    finally:
        _tf32(False)
    log(f"{tag} {what}, fp32, card vs CPU: outputs {[tuple(g.shape) for g in got]} max |Δ| / "
        f"max |ref| {' '.join(f'{r:.3e}' for r in rels)} (tol {SLICE_TOL}); gradients of "
        f"Σ out·cot (the value compared ½Σout²): {summary}; launches {launched}, "
        f"expected {expected}; "
        f"forward+backward CPU {ref[2]:.1f} s, card {t_gpu:.1f} s; control, TF32: {control}")
    if expected is not None and launched != expected:
        raise AssertionError(f"launch counts {launched} != {expected}")
    if not max(rels) <= SLICE_TOL or not ok:
        raise AssertionError(f"{tag} card disagrees with the CPU: {rels}; {summary}")
    if control_ok:
        raise AssertionError(f"{tag} the TF32 control passed the gradient tolerance")


def carafe_reference():
    """Phase 25c's model, inputs and CPU run: `MaskHead(upsample="carafe")`
    (`ops/carafe.py`, plain PyTorch on both devices) at Mask R-CNN's shapes,
    512 RoIs × 256 channels × 14², 80 classes, fp32, cotangents 28²."""
    head = init_weights(MaskHead(80, 256, 256, upsample="carafe"), _gen(SEED + 70))
    x = torch.randn((512, 256, 14, 14), generator=_gen(SEED + 71))
    cots = [torch.randn((512, 80, 28, 28), generator=_gen(SEED + 72))]
    return head, x, cots, _run_grads(head, x, cots, "cpu")


def phase_carafe(reference) -> None:
    """Phase 25c: `carafe_reference()`'s mask head on the card against its
    CPU run: the logits (SLICE_TOL of max |ref|), the gradients by phase 6's
    rule (the mask head in the 1e-2 group, as phase 21 holds it) and the
    TF32 control."""
    head, x, cots, ref = reference
    rule = dataclasses.make_dataclass("Rule", ["grad_rtol", "head_prefixes"])(
        {"convs": GRAD_RTOL["convs"]}, ("",))
    _card_vs_cpu("[carafe]", "MaskHead(upsample='carafe'), 512 RoIs × 256 × 14²", head, x,
                 cots, ref, rule)


# the patch-8 ViT-B+RVSA (no registered recipe uses it): a 384×128 strip is a
# 48×16 token grid, 21 windows of 7×7 an image, full attention over 768
P8_CFG = vit_b_rvsa(384, patch_size=8, dtype="float32", drop_path_rate=0.0)
P8_STRIP = (384, 128)
P8_STEP = launches(window=8, flash=4, bilinear_sample=16, window_bwd=8, flash_bwd=4,
                   bilinear_sample_bwd=16)


def patch8_reference():
    """Phase 25d's model, inputs and CPU run: the patch-8 ViT-B+RVSA (embed
    768, 12 blocks; the simple FPN's patch-8 branch) at batch 2 of a
    384×128 strip, fp32, a cotangent for each of its four levels."""
    model = init_weights(ViTRVSA(P8_CFG, input_hw=P8_STRIP), _gen(SEED + 80))
    x = torch.randn((2, *P8_STRIP, 3), generator=_gen(SEED + 81))
    cots = [torch.randn((2, P8_STRIP[0] // s, P8_STRIP[1] // s, 768),
                        generator=_gen(SEED + 82 + i)) for i, s in enumerate((4, 8, 16, 32))]
    return model, x, cots, _run_grads(model, x, cots, "cpu")


def phase_patch8(reference) -> None:
    """Phase 25d: `patch8_reference()`'s backbone on the card against its CPU
    run: the four levels (SLICE_TOL of each one's max |ref|, phase 21's
    strip rule), the gradients by phase 6's rule (backbone rtol) with the
    TF32 control, and K1-K6's launches in the forward and backward exact."""
    model, x, cots, ref = reference
    rule = dataclasses.make_dataclass("Rule", ["grad_rtol", "head_prefixes"])(
        {"backbone": GRAD_RTOL["backbone"]}, ())
    _card_vs_cpu("[patch8]", f"ViT-B+RVSA at patch 8, 2 images of {P8_STRIP[0]}×"
                 f"{P8_STRIP[1]} (token grid {P8_STRIP[0] // 8}×{P8_STRIP[1] // 8})", model, x,
                 cots, ref, rule, expected=P8_STEP)


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
CLS_VIT = recipe("vit-rvsa-l-224-mae-mtp_eurosat")
CLS_XL = recipe("intern-xl-224-imp-mtp_eurosat")
CD_VIT = recipe("rvsa-l-unet-256-mae-mtp_levir")
CD_XL = recipe("intern-xl-unet-256-imp-mtp_levir")
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
    initial = host_copy(state.model)
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
    with timed_window():
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

    sanity_run(task, batches[0], tag, initial)
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


def _state_snapshot(state, device="cpu") -> dict:
    """Everything a checkpoint holds, copied to `device` (phase 25 keeps its
    copies on the card, which has room for them beside its steps)."""
    copy_ = lambda t: t.detach().to(device, copy=True)
    return {"step": state.step, "count": state.optimizer.count,
            "model": {k: copy_(v) for k, v in state.model.state_dict().items()},
            "moments": {n: tuple(copy_(t) for t in mv)
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
    atomics: `fit` 2 steps with a CheckpointStore (ckpt_every 2: the one,
    final save; phase 24 saves mid-run and resumes) and an encoder path;
    step 2 restored into a fresh task equals, bit for bit,
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
        with timed_window():
            state, _ = task.fit(state, cycle(batches), 2, log_every=1, log_fn=keep, ckpt=store,
                                ckpt_every=2, encoder_path=os.path.join(tmp, "encoder.pth"))
            steps = store.steps()
        log(f"{tag} fit 2 steps with saves at {steps} and the encoder artifact "
            f"({os.path.getsize(os.path.join(tmp, 'encoder.pth')) / 2 ** 20:.1f} MiB): "
            f"{time.perf_counter() - t0:.1f} s")
        if steps != [2]:
            raise AssertionError(f"checkpoints at {steps}, expected [2]")
        snap = snap["s"]
        del task, state
        free()
        fresh = ClassificationTask(path.recipe)
        t0 = time.perf_counter()
        # no random weights: the restore overwrites every tensor of the state
        with timed_window(), \
                mock.patch("mtp_tpu_torch.tasks._fit.init_weights", lambda model, gen: model):
            fresh_state = fresh.init_state(_gen(SEED + 99))
            restored = store.restore(fresh_state, step=2)
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


# ------------------------------------------------------------- phase 19 --

DET_BATCH = 2          # the recipes' 2 a GPU × 8, on one card
ROT_BATCH = 1          # phase 20: the oriented recipes' 4 = 1 a GPU × 4 ranks
DET_STRIP = (800, 128)  # card vs CPU: a 50×8 token grid (both FPNs need even grids)
DET_MAX_GTS = 100
MASK_CROP = 56         # the loader's box-aligned gt mask crops
# kernel launches and where detection spends device time by kernel group
# (first match wins), read from torch.profiler in phase 19
KERNEL_GROUPS = [
    ("N1 mask", r"nms_mask_kernel"),
    ("R1 mask", r"rbox_mask_kernel"),
    ("R1 dense", r"rbox_iou_dense_kernel"),
    ("NMS scan (N1, R1)", r"nms_scan_kernel"),
    ("K3 bilinear_sample_fwd", r"bilinear_sample_fwd_(vec_)?kernel"),
    ("K6 bilinear_sample_bwd", r"bilinear_sample_bwd_(vec_|tiled_)?kernel"),
    ("K5 flash_attn_bwd", r"flash_bwd_"),
    ("K2 flash_attn_fwd", r"flash_(attn_)?fwd"),
    ("K1 window_attn_fwd", r"window_attn_fwd_(tc_)?kernel"),
    ("K4 window_attn_bwd", r"window_attn_bwd_(tc_)?kernel"),
    ("AdamW (foreach)", r"multi_tensor_apply|foreach|adam"),
    ("sort", r"sort|Sort|radix"),
    ("cuDNN convolutions", r"conv|cudnn|dgrad|wgrad|implicit_gemm|winograd|fft"),
    ("cuBLAS GEMMs", r"gemm|sm90_xmma|cutlass|ampere_|sm80_|gemv|splitK|nvjet"),
    ("gather/scatter, index", r"gather|scatter|index|Index"),
    ("LayerNorm", r"layer_norm|LayerNorm"),
    ("reductions", r"reduce|Reduce|norm_kernel"),
    ("softmax", r"softmax"),
    ("copies, casts, cat", r"copy|Copy|cat|transpose|permute|contiguous"),
    ("elementwise", r"elementwise|vectorized|unrolled|Elementwise"),
]


def kernel_group(name: str) -> str:
    for group, rx in KERNEL_GROUPS:
        if re.search(rx, name):
            return group
    return "other"


@dataclasses.dataclass(frozen=True)
class DetPath:
    """A detection recipe's detector at full width and depth, and what phase
    19 (Faster R-CNN), 20 (Oriented R-CNN), 21 (Mask R-CNN) or 22
    (RetinaNet) drives it at."""

    name: str
    recipe: TaskConfig
    flops: Callable[[int], float]        # backbone forward FLOPs of one image
    per_forward: Dict[str, int]          # launches of one backbone forward
    per_step: Dict[str, int]             # of one train step
    per_predict: Dict[str, int]          # of one predict
    train_steps: int                     # timed steps
    grad_stochastic: ClassVar[bool] = False
    grad_rtol: Dict[str, float] = dataclasses.field(  # `phase_det_gradients`
        default_factory=lambda: GRAD_RTOL)
    head: str = "faster_rcnn"            # or "oriented_rcnn", "mask_rcnn", "retinanet"
    batch: int = DET_BATCH               # the train step's images
    gradients: bool = True               # the strip's gradient check, beside its forward's
    strip: Tuple[int, int] = DET_STRIP   # the card-vs-CPU image
    # DetConfig / RetinaConfig fields the path's task overrides
    overrides: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def rotated(self) -> bool:
        return self.head == "oriented_rcnn"

    @property
    def masks(self) -> bool:
        return self.head == "mask_rcnn"

    @property
    def head_prefixes(self) -> Tuple[str, ...]:
        """What `check_gradients` reads, as it reads a `Path`'s: the FPN and
        the heads are the "convs" group."""
        if self.head == "retinanet":
            return ("neck.", "bbox_head.")
        return ("neck.", "rpn_head.", "roi_head.")

    @property
    def no_grad(self) -> Tuple[str, ...]:
        """Parameters that get no gradient: RetinaNet does not run the ViT's
        fpn1 (its FPN starts at level 1)."""
        return ("backbone.fpn1.",) if self.head == "retinanet" else ()

    @property
    def det(self):
        return det_config(self.head, self.recipe.num_classes, self.overrides)

    def task(self, cfg: Optional[TaskConfig] = None, **kw) -> DetectionTask:
        """The recipe's (or `cfg`'s) DetectionTask with this path's head."""
        return DetectionTask(cfg or self.recipe, head=self.head,
                             det_overrides=self.overrides or None, **kw)


DET_VIT = recipe("faster_rcnn_rvsa_l_800_mae_mtp_dior")
DET_XL = recipe("faster_rcnn_intern_xl_800_imp_mtp_dior")
DET_PATHS = {
    # ViT-L+RVSA at 800², the last block tapped 4 times → simple FPN → FPN →
    # Faster R-CNN, 20 classes; no remat: K1-K6 as the segmentation ViT, N1
    # once a step (the RPN's proposals) and twice a predict (+ the per-class
    # NMS of the detections)
    "det_vit": DetPath("det_vit", DET_VIT,
                       lambda crop: backbone_flops(DET_VIT.backbone, (crop, crop)),
                       VIT_FWD, {**VIT_STEP, "nms": 1}, {**VIT_FWD, "nms": 2},
                       train_steps=5),
    # InternImage-XL at 800² with remat: K8 on maps of 200², 100², 50², 25²
    "det_xl": DetPath("det_xl", DET_XL,
                      lambda crop: internimage_flops(internimage_config(DET_XL.backbone),
                                                     crop),
                      XL_FWD, {**XL_STEP, "nms": 1}, {**XL_FWD, "nms": 2},
                      train_steps=3, grad_rtol=GRAD_RTOL_STOCHASTIC),
}


ROT_VIT = recipe("oriented_rcnn_rvsa_l_800_mae_mtp_diorr")
ROT_XL = recipe("oriented_rcnn_intern_xl_800_imp_mtp_diorr")
ROT_PATHS = {
    # phase 20: Oriented R-CNN on DIOR-R's 20 classes at 800², batch 1; a
    # step adds N1 once (the oriented RPN's horizontal NMS) and R1's dense
    # form once (the R-CNN assigner), a predict N1 once and R1's mask form
    # once (the class-aware rotated NMS of 2,000 candidates an image)
    "det_rot_vit": DetPath("det_rot_vit", ROT_VIT,
                           lambda crop: backbone_flops(ROT_VIT.backbone, (crop, crop)),
                           VIT_FWD, {**VIT_STEP, "nms": 1, "rbox_iou": 1},
                           {**VIT_FWD, "nms": 1, "nms_rotated": 1}, train_steps=5,
                           head="oriented_rcnn", batch=ROT_BATCH),
    # XL: its backbone's gradients at 5e-3, as phase 19's XL
    "det_rot_xl": DetPath("det_rot_xl", ROT_XL,
                          lambda crop: internimage_flops(internimage_config(ROT_XL.backbone),
                                                         crop),
                          XL_FWD, {**XL_STEP, "nms": 1, "rbox_iou": 1},
                          {**XL_FWD, "nms": 1, "nms_rotated": 1}, train_steps=3,
                          head="oriented_rcnn", batch=ROT_BATCH,
                          grad_rtol=GRAD_RTOL_STOCHASTIC),
}


# phases 21-22: random weights clear no score threshold (Mask R-CNN's
# softmax over 81 classes gives ~0.012 a class, RetinaNet's prior 0.01), so
# both tasks take score_thr 0.001 through `det_overrides`, as JAX's
# DetectionTask takes it; nothing else of the recipes changes
SCORE_THR = 0.001
MASK_VIT = recipe("mask_rcnn_rvsa_l_1024_mae_mtp_coco")
RETINA_VIT = recipe("retinanet_rvsa_l_416_mae_mtp_xview")
MASK_XL = recipe("mask_rcnn_intern_xl_1024_imp_mtp_coco")
RETINA_XL = recipe("retinanet_intern_xl_416_imp_mtp_xview")
INST_PATHS = {
    # phase 21: Mask R-CNN on COCO's 80 classes at 1024², batch 2 (the
    # recipe's 16 = 2 a GPU × 8): the ViT's 64² grid; a step adds N1 once
    # and K3 once more (the mask targets: `grid_sample` of the gt crops), a
    # predict N1 twice; card vs CPU at a 1024×128 strip (64×8 tokens)
    "mask_vit": DetPath("mask_vit", MASK_VIT,
                        lambda crop: backbone_flops(MASK_VIT.backbone, (crop, crop)),
                        VIT_FWD, {**VIT_STEP, "bilinear_sample": 41, "nms": 1},
                        {**VIT_FWD, "nms": 2}, train_steps=4, head="mask_rcnn",
                        strip=(1024, 128), overrides={"score_thr": SCORE_THR}),
    # phase 22: RetinaNet on xView's 60 classes at 416², batch 2: the 26²
    # grid, 32,526 anchors an image; no NMS in a step, N1 once a predict;
    # card vs CPU at a 416×128 strip (26×8 tokens)
    "retina_vit": DetPath("retina_vit", RETINA_VIT,
                          lambda crop: backbone_flops(RETINA_VIT.backbone, (crop, crop)),
                          VIT_FWD, VIT_STEP, {**VIT_FWD, "nms": 1}, train_steps=4,
                          head="retinanet", strip=(416, 128),
                          overrides={"score_thr": SCORE_THR}),
    # the same two with InternImage-XL (remat): K8 on maps of 256², 128²,
    # 64², 32² at 1024² and of 104², 52², 26², 13² at 416².  The strip's
    # forward card vs CPU; no gradient check: det_xl holds the XL trunk's
    # gradients, mask_vit and retina_vit the heads'
    "mask_xl": DetPath("mask_xl", MASK_XL,
                       lambda crop: internimage_flops(internimage_config(MASK_XL.backbone),
                                                      crop),
                       XL_FWD, {**XL_STEP, "bilinear_sample": 79, "nms": 1},
                       {**XL_FWD, "nms": 2}, train_steps=3, head="mask_rcnn",
                       strip=(1024, 128), overrides={"score_thr": SCORE_THR},
                       gradients=False),
    "retina_xl": DetPath("retina_xl", RETINA_XL,
                         lambda crop: internimage_flops(internimage_config(RETINA_XL.backbone),
                                                        crop),
                         XL_FWD, XL_STEP, {**XL_FWD, "nms": 1}, train_steps=3,
                         head="retinanet", strip=(416, 128),
                         overrides={"score_thr": SCORE_THR}, gradients=False),
}


def mask_crops(n: int, seed: int) -> np.ndarray:
    """(n, DET_MAX_GTS, 56, 56) box-aligned gt mask crops, as the loader
    makes them (`crop_masks_to_boxes`): each an ellipse inscribed in its
    box, its axes 60-100% of the box's, its centre moved by up to 10%."""
    rng = np.random.default_rng(seed)
    t = (np.arange(MASK_CROP) + 0.5) / MASK_CROP * 2 - 1
    ax = rng.uniform(0.6, 1.0, (n, DET_MAX_GTS, 2, 1, 1))
    c = rng.uniform(-0.1, 0.1, (n, DET_MAX_GTS, 2, 1, 1))
    inside = ((t[None, :] - c[:, :, 0]) / ax[:, :, 0]) ** 2 + \
        ((t[:, None] - c[:, :, 1]) / ax[:, :, 1]) ** 2 <= 1
    return inside.astype(np.float32)


def det_batch(n: int, hw: Tuple[int, int], num_classes: int, seed: int,
              rotated: bool = False, masks: bool = False) -> dict:
    """n seeded images of hw, each with 4-15 gt boxes padded to DET_MAX_GTS
    with gt_valid: x1y1x2y2 boxes of sides 24-200 px within the image, or
    with `rotated` (cx, cy, w, h, θ) boxes of sides 24-200 px, any angle,
    centres inside the image, le90-regularised; each box painted with a
    brightness its label sets ((c + 0.5) / num_classes · 4 − 2 over noise
    of std 0.5), so the sanity run has something to learn.  With `masks`,
    each gt's mask crop (`mask_crops`, zeros in the padded slots) as
    gt_mask_crops."""
    rng = np.random.default_rng(seed)
    H, W = hw
    image = (rng.standard_normal((n, H, W, 3)) * 0.5).astype(np.float32)
    boxes = np.zeros((n, DET_MAX_GTS, 5 if rotated else 4), np.float32)
    labels = np.zeros((n, DET_MAX_GTS), np.int64)
    valid = np.zeros((n, DET_MAX_GTS), bool)
    ys, xs = np.mgrid[0:H, 0:W] + 0.5
    for i in range(n):
        for j in range(rng.integers(4, 16)):
            # a box's draws: the label first for a rotated box, last for an
            # axis-aligned one
            if rotated:
                c = rng.integers(num_classes)
                cx, cy = rng.uniform(0, W), rng.uniform(0, H)
                bw, bh, t = rng.uniform(24, 200), rng.uniform(24, 200), rng.uniform(-1.5, 1.5)
                boxes[i, j] = prb.regularize_le90(torch.tensor([cx, cy, bw, bh, t])).numpy()
                u = (xs - cx) * math.cos(t) + (ys - cy) * math.sin(t)
                v = -(xs - cx) * math.sin(t) + (ys - cy) * math.cos(t)
                inside = (np.abs(u) <= bw / 2) & (np.abs(v) <= bh / 2)
            else:
                bw, bh = rng.uniform(24, min(200, W)), rng.uniform(24, min(200, H))
                x1, y1 = rng.uniform(0, W - bw), rng.uniform(0, H - bh)
                c = rng.integers(num_classes)
                boxes[i, j] = (x1, y1, x1 + bw, y1 + bh)
                inside = (slice(int(y1), int(y1 + bh)), slice(int(x1), int(x1 + bw)))
            labels[i, j], valid[i, j] = c, True
            image[i][inside] += (c + 0.5) / num_classes * 4 - 2
    batch = {"image": image, "gt_boxes": boxes, "gt_labels": labels, "gt_valid": valid}
    if masks:
        batch["gt_mask_crops"] = mask_crops(n, seed + 1000) * valid[..., None, None]
    return batch


def build_det_model(path: DetPath, hw: Tuple[int, int]):
    """The recipe's full-width detector (a TwoStageDetector or a RetinaNet)
    for hw images, seeded random weights, on the CPU."""
    model = build_detector(path.head, path.recipe.backbone, path.det, hw)
    return init_weights(model, _gen(SEED)).eval()


# phase 21's card-vs-CPU mask logits: on each image's first proposals
MASK_ROIS = 16


def _det_heads(model, images: torch.Tensor, props: Optional[torch.Tensor], task):
    """fp32 FPN levels, RPN scores and deltas, and, on `props` (B, P, 4 or
    5) (the model's own proposals if None), the box head's logits and
    deltas, and with a mask head its logits on each image's first
    MASK_ROIS proposals; RetinaNet: the FPN levels and the head's logits
    and deltas (props None)."""
    hw = tuple(images.shape[1:3])
    if task.head == "retinanet":
        feats = model.features(images)
        return list(feats) + list(model.bbox_head(feats)), None
    feats = model.features(images)
    rpn = model.rpn(feats)
    if props is None:
        props, _ = gen_proposals(rpn, task.anchors_on(hw, images.device), hw,
                                 task.det.nms_pre, task.det.max_proposals,
                                 task.det.rpn_nms_iou, task.det.rotated,
                                 level_sizes=det_core.anchor_level_sizes(hw))
    B, P, D = props.shape
    bidx = torch.arange(B, device=images.device).repeat_interleave(P)
    cls, reg = model.box_head(feats, props.reshape(B * P, D), bidx)
    out = list(feats) + [rpn.cls_scores, rpn.deltas, cls, reg]
    if task.det.with_mask:
        out.append(model.mask_head_logits(
            feats, props[:, :MASK_ROIS].reshape(-1, D),
            torch.arange(B, device=images.device).repeat_interleave(MASK_ROIS)))
    return out, props


def det_forward_inputs(path: DetPath) -> torch.Tensor:
    """The 2 seeded images of the strip that phase 19's forward check runs."""
    return torch.from_numpy(det_batch(DET_BATCH, path.strip, path.recipe.num_classes,
                                      SEED + 1, path.rotated)["image"])


@torch.no_grad()
def det_forward_reference(path: DetPath, model_cpu) -> dict:
    """`phase_det_forward`'s CPU half: the outputs, the CPU's proposals and
    seconds."""
    task = path.task(model=model_cpu, device="cpu")
    t0 = time.perf_counter()
    out, props = _det_heads(model_cpu, det_forward_inputs(path), None, task)
    return {"out": out, "props": props, "seconds": time.perf_counter() - t0}


@torch.no_grad()
def phase_det_forward(path: DetPath, model_cpu, ref: dict) -> None:
    """fp32 FPN levels, RPN scores and deltas of 2 images of the strip, card
    against CPU (`ref`, `det_forward_reference`'s), and the box head's logits and deltas (and the mask head's
    logits) on the proposals the CPU computed, given to both; RetinaNet's
    FPN levels and head outputs: each held to SLICE_TOL of its max |ref|."""
    x = det_forward_inputs(path)
    task = path.task(model=model_cpu, device="cpu")
    ref, props, t_cpu = ref["out"], ref["props"], ref["seconds"]
    model = copy.deepcopy(model_cpu).cuda()
    reset_counters()
    got, _ = _det_heads(model, x.cuda(), None if props is None else props.cuda(), task)
    launched = counters()
    if launched != path.per_forward:
        raise AssertionError(f"launch counts {launched} != {path.per_forward}")
    names = [f"FPN level {i}" for i in range(5)] + (
        ["cls logits", "deltas"] if path.head == "retinanet" else
        ["RPN scores", "RPN deltas", "box logits", "box deltas", "mask logits"])
    worst = 0.0
    parts = []
    for name, g, r in zip(names, got, ref):
        g = g.float().cpu()
        if g.shape != r.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{name}: {tuple(g.shape)} vs {tuple(r.shape)} or non-finite")
        rel = ((g - r).abs().max() / r.abs().max()).item()
        worst = max(worst, rel)
        parts.append(f"{name} {rel:.3e}")
    on = "" if props is None else f"; box head on the CPU's {tuple(props.shape)} proposals"
    log(f"[det {path.name}] fp32 {DET_BATCH} images of {path.strip[0]}×{path.strip[1]}, "
        f"card vs CPU, max |Δ| / max |ref| (tol {SLICE_TOL}): " + ", ".join(parts)
        + f"{on}; CPU forward {t_cpu:.1f} s; launches {launched}")
    if not worst <= SLICE_TOL:
        raise AssertionError(f"card detector disagrees with the CPU: {worst:.3e}")


def det_grad_batch(path: DetPath) -> Tuple[TaskConfig, dict]:
    """The recipe in fp32 and 2 seeded images of the strip (with their gt
    mask crops for Mask R-CNN): what the gradient check runs on."""
    recipe = path.recipe
    return fp32(recipe), {k: torch.from_numpy(v) for k, v in det_batch(
        DET_BATCH, path.strip, recipe.num_classes, SEED + 3, path.rotated,
        path.masks).items()}


def det_grad_inputs(path: DetPath, model_cpu):
    """`det_grad_batch`'s, the proposals the CPU's RPN gives for them (None
    for RetinaNet), and the CPU's max-pool picks (`recorded_pool_picks`)."""
    cfg, batch = det_grad_batch(path)
    task = path.task(cfg, model=model_cpu, device="cpu")
    picks: Dict[tuple, torch.Tensor] = {}
    with torch.no_grad():
        if path.head == "retinanet":
            with recorded_pool_picks(picks):
                model_cpu.features(batch["image"])
            return cfg, batch, None, picks
        with recorded_pool_picks(picks):
            rpn = model_cpu.rpn(model_cpu.features(batch["image"]))
        props = gen_proposals(rpn, task.anchors_on(path.strip, "cpu"), path.strip,
                              task.det.nms_pre, task.det.max_proposals,
                              task.det.rpn_nms_iou, task.det.rotated,
                              level_sizes=det_core.anchor_level_sizes(path.strip))
    return cfg, batch, props, picks


def fixed_proposals(props: Tuple[torch.Tensor, torch.Tensor]):
    """`det_loss_core` takes `props` (boxes, scores) for its proposals, on
    whatever device it runs, instead of generating them."""
    fixed = lambda rpn_out, *a, **k: tuple(t.to(rpn_out.cls_scores.device) for t in props)
    return mock.patch.object(det_core, "gen_proposals", fixed)


def _pool_key(x: torch.Tensor, args: tuple, kwargs: dict) -> tuple:
    return (tuple(x.shape), args, tuple(sorted(kwargs.items())))


@contextlib.contextmanager
def recorded_pool_picks(into: Dict[tuple, torch.Tensor]):
    """Records, by input shape and arguments, the input element each 2-D
    max-pool window of this thread picks (on the CPU)."""
    pool, owner = F.max_pool2d, threading.get_ident()

    def record(x, *args, **kwargs):
        if threading.get_ident() != owner:  # another thread's work
            return pool(x, *args, **kwargs)
        kwargs.pop("return_indices", None)
        out, idx = pool(x, *args, return_indices=True, **kwargs)
        key = _pool_key(x, args, kwargs)
        if key in into:
            raise AssertionError(f"two max-pools of one shape and arguments: {key}")
        into[key] = idx.cpu()
        return out

    with mock.patch.object(F, "max_pool2d", record):
        yield


@contextlib.contextmanager
def fixed_pool_picks(picks: Dict[tuple, torch.Tensor]):
    """Every 2-D max-pool takes the recorded picks (`recorded_pool_picks`)
    instead of its own: the value of the picked element, and the gradient
    to it.  Where two inputs of a window lie within rounding of each other,
    fp32 runs on two devices can pick either, and the gradient routed to
    the other input is a discrete difference, not a rounding one.  Other
    threads' max-pools pick their own."""
    pool, owner = F.max_pool2d, threading.get_ident()

    def take(x, *args, **kwargs):
        if threading.get_ident() != owner:
            return pool(x, *args, **kwargs)
        kwargs.pop("return_indices", None)
        idx = picks[_pool_key(x, args, kwargs)].to(x.device)
        return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)

    with mock.patch.object(F, "max_pool2d", take):
        yield


def det_gradients_reference(path: DetPath, model_cpu) -> dict:
    """`phase_det_gradients`' CPU half: the proposals, max-pool picks, what
    the CPU's assigners decided (`held`) and the CPU's run (`cpu_run`)."""
    cfg, batch, props, picks = det_grad_inputs(path, model_cpu)
    held: dict = {}
    with det_grad_choices(path, props, picks, held):
        cpu = cpu_run(det_grad_path(path), cfg, model_cpu, batch, path.task, path.no_grad)
    return {"props": props, "picks": picks, "held": held, "cpu": cpu}


def det_grad_path(path: DetPath) -> DetPath:
    """The path as the gradient check expects its launches: the CPU's
    proposals and assigner IoUs are replayed, so no NMS and no R1."""
    return dataclasses.replace(path, per_step={**path.per_step, "nms": 0, "rbox_iou": 0})


def det_grad_choices(path: DetPath, props, picks: dict, held: dict):
    """Both runs on what the CPU decides: its proposals, its max-pool picks,
    and the R-CNN assigner IoUs (oriented) or RetinaNet's anchor assignment,
    recorded into `held` where the CPU runs and replayed from it on the
    card."""
    fixed = contextlib.ExitStack()
    if path.head == "retinanet":
        fixed.enter_context(cpu_retina_assign(held))
    else:
        fixed.enter_context(fixed_proposals(props))
        if path.rotated:
            fixed.enter_context(cpu_replay(det_core, "rbox_overlaps",
                                           held.setdefault("rbox_overlaps", [])))
    fixed.enter_context(fixed_pool_picks(picks))
    return fixed


def phase_det_gradients(path: DetPath, model_cpu, ref: dict) -> None:
    """fp32 gradients of the detection loss at 2 images of the strip, card
    against CPU (phase 6's rule and TF32 control), the ViT with its random
    RVSA regressors.  Both sides take what the CPU's forward decides where
    fp32 rounding could tip a discrete choice: its proposals (NMS could keep
    another box where an IoU lies within rounding of 0.7), its max-pool
    picks (`fixed_pool_picks`) and its samplers' draws (one CPU generator,
    `_loss_and_grads`).  The picks matter: in one of the ViT's 204,800
    fpn4 windows the card picked another element than the CPU and a
    float64 run, and the gradient routed there put the card's backbone
    gradients up to 9.1e-3 from both (pos_embed; median 6.4e-4); with the
    CPU's picks the card is 6.7e-7 (median) and 6.1e-6 (largest) from the
    CPU, and the TF32 control 1.8e-3 to 4.7e-1 (`tools/strip_gradient_witness.py
    --path det_vit [--own-picks]`, NVIDIA H100 80GB HBM3, 700.00 W).  XL's
    backbone is held at 5e-3: 4 of the CPU's 6.5M ReLU inputs (RPN and
    box head) lie across 0 from float64's, which puts the CPU's backbone
    gradients 3.4e-4 (median) and up to 1.98e-3 from float64 while the
    card's are 3.2e-7 and 3.2e-6 (`--path det_xl`); its TF32 control
    leaves 11 parameters outside.  The oriented path (phase 20) also takes
    the CPU's R-CNN assigner IoUs (`cpu_replay`): an IoU within
    rounding of 0.5 would flip a sample.  RetinaNet (phase 22) takes the
    CPU's anchor assignment (`cpu_retina_assign`): an anchor's IoU within
    rounding of 0.4 or 0.5 would move it between negative, ignored and
    positive.  This holds the network; R1 is held by phase 3g.  `ref`:
    `det_gradients_reference`'s."""
    cfg, batch = det_grad_batch(path)
    what = ("max-pool picks and anchor assignment" if path.head == "retinanet" else
            "proposals, max-pool picks" + (" and assigner IoUs" if path.rotated else ""))
    with det_grad_choices(path, ref["props"], ref["picks"], ref["held"]):
        check_gradients(det_grad_path(path), cfg, model_cpu, batch, path.task,
                        f"fp32 {DET_BATCH} images of {path.strip[0]}×{path.strip[1]}, "
                        f"the CPU's {what}", path.no_grad, cpu=ref["cpu"])


@contextlib.contextmanager
def cpu_retina_assign(held: dict):
    """RetinaNet's anchor assignment: computed where the loss runs on the
    CPU (into `held`), and that CPU result given to every run on the card;
    logs how many anchors' best IoUs lie within 1e-6 of 0.4 or 0.5."""
    real = pretina.max_iou_assign

    def assign(anchors, gts, *args):
        if gts.device.type == "cpu":
            held["assign"] = real(anchors, gts, *args)
            m = held["assign"].max_ious
            near = int(sum(((m - t).abs() <= 1e-6).sum() for t in (0.4, 0.5)))
            log(f"[grads retina] anchors whose best IoU lies within 1e-6 of 0.4 or 0.5: "
                f"{near} of {m.numel()}")
            return held["assign"]
        return type(held["assign"])(*(t.to(gts.device) for t in held["assign"]))

    with mock.patch.object(pretina, "max_iou_assign", assign):
        yield


@contextlib.contextmanager
def cpu_replay(module, name: str, held: list):
    """`module.name`'s results, computed in call order where they run on
    the CPU (appended to `held`), and given back in the same order to each
    run on the card (`det_core.rbox_overlaps`: the rotated assigners' IoUs,
    in phases 20 and 23; `det_core.gen_proposals`: phase 23's six RPNs'
    proposals)."""
    real, at = getattr(module, name), [0]

    def call(first, *args, **kwargs):
        lead = first.cls_scores if hasattr(first, "cls_scores") else first
        if lead.device.type == "cpu":
            held.append(real(first, *args, **kwargs))
            return held[-1]
        out = held[at[0] % len(held)]
        at[0] += 1
        return tuple(t.to(lead.device) for t in out) if isinstance(out, tuple) \
            else out.to(lead.device)

    with mock.patch.object(module, name, call):
        yield


# steps of the train step under torch.profiler (`_busy`)
BUSY_STEPS = 1


def _busy(task, state, batch: dict, steps: int = BUSY_STEPS) -> Tuple[float, dict]:
    """Device kernel ms per train step (torch.profiler over `steps` steps,
    the card's activity only: the host's operators add nothing to the
    kernels' times and count, and building their events took longer than
    the steps) and the ms and launches a step of each kernel group."""
    step = task.train_step_fn()
    torch.cuda.synchronize()
    with timed_window(), \
            torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, m = step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    groups: Dict[str, list] = {}
    for e in prof.events():
        if e.device_type != cuda or getattr(e, "is_user_annotation", False) or \
                e.name.startswith(("Optimizer.", "ProfilerStep")):
            continue
        g = groups.setdefault(kernel_group(e.name), [0.0, 0])
        g[0] += e.device_time_total / 1e3 / steps
        g[1] += 1 / steps
    return sum(v[0] for v in groups.values()), groups


def phase_det_train(path: DetPath, card: str) -> dict:
    """The recipe's train step at `path.batch` images of its size (phase
    19: 2 of 800², phase 20: 1 of 800², 21: 2 of 1024², 22: 2 of 416²)
    through `DetectionTask` (`init_state` → `fit` → `predict_fn` →
    `evaluate`): launches, ms/step, images/s, data_time, peak memory, the
    device's busy share and its kernel groups; a predict of 2 images, with
    the detections each image kept (and for Mask R-CNN the device paste
    against the host paste, `check_paste`); VOC AP50 (rotated IoU on the
    oriented path), or for Mask R-CNN the 12 COCO bbox and 12 segm stats,
    on seeded synthetic boxes (finite; random weights); a fixed-batch
    sanity run whose loss must fall."""
    recipe, tag = path.recipe, f"[train {path.name}]"
    crop, K, B = recipe.backbone.img_size, recipe.num_classes, path.batch
    task = path.task()
    t0 = time.perf_counter()
    state = task.init_state(_gen(SEED))
    initial = host_copy(state.model)
    opt = recipe.train.optimizer
    log(f"{tag} init_state {time.perf_counter() - t0:.1f} s; recipe lr {opt.lr} layer "
        f"decay {opt.layer_decay}, schedule {recipe.train.schedule.kind} "
        f"({recipe.train.schedule.warmup_steps} warm-up), remat {recipe.backbone.remat}, "
        f"drop-path {recipe.backbone.drop_path_rate}; batch {B} (the recipe's "
        f"{recipe.train.batch_size} over {recipe.train.batch_size // B} GPUs)")
    batches = [det_batch(B, (crop, crop), K, SEED + 10 + i, path.rotated, path.masks)
               for i in range(3)]
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
    state, _ = task.fit(state, cycle(batches), 2, log_every=1, log_fn=log_fn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logs.clear()
    with timed_window():
        state, _ = task.fit(state, cycle(batches), path.train_steps, log_every=1,
                            log_fn=log_fn)
    peak = torch.cuda.max_memory_allocated()
    for m in logs:
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite train metrics {m}")
    step_ms = [m["step_time"] * 1e3 for m in logs]
    per = statistics.median(step_ms)
    data_ms = statistics.median(m["data_time"] * 1e3 for m in logs)
    dev_batch = {k: torch.as_tensor(v).cuda() for k, v in batches[0].items()}
    kernel_ms, groups = _busy(task, state, dev_batch)
    losses = ", ".join(f"{k[5:] if k != 'loss' else k} {v:.4f}"
                       for k, v in logs[-1].items() if k.startswith("loss") and k != "loss")
    log(f"{tag} recipe train step, batch {B} of {crop}², bf16 autocast, "
        f"drop-path on: median {per:.2f} ms/step over {len(step_ms)} (min "
        f"{min(step_ms):.2f}, max {max(step_ms):.2f}), {B / per * 1e3:.3f} "
        f"images/s, data_time median {data_ms:.3f} ms, backbone "
        f"~{3 * path.flops(crop) * B / per / 1e9:.2f} TFLOP/s (3× forward), peak "
        f"memory {peak / 2 ** 30:.3f} GiB; busy {kernel_ms / per:.3f} ({kernel_ms:.2f} ms "
        f"of device kernels a step, torch.profiler, {BUSY_STEPS} step, over the median step); loss "
        f"{logs[0]['loss']:.4f} → {logs[-1]['loss']:.4f} ({losses}), grad_norm "
        f"{logs[-1]['grad_norm']:.4f}, step {state.step} | card {card}")
    log(f"{tag} device ms a step by kernel group (launches): " + ", ".join(
        f"{g} {ms:.2f} ({n:.0f})" for g, (ms, n) in
        sorted(groups.items(), key=lambda kv: -kv[1][0])))

    # 2 images (phase 19: the second train batch's)
    images = torch.from_numpy(det_batch(DET_BATCH, (crop, crop), K, SEED + 11,
                                        path.rotated)["image"]).cuda()
    predict = task.predict_fn()
    with torch.no_grad(), task.autocast():
        reset_counters()
        dets = predict(images)
        torch.cuda.synchronize()
        p_launched = counters()
        if p_launched != path.per_predict:
            raise AssertionError(f"predict launch counts {p_launched} != {path.per_predict}")
        times = []
        with timed_window():
            for _ in range(5):
                t0 = time.perf_counter()
                predict(images)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
    kept = dets.valid.sum(1).tolist()
    ok = dets.boxes.shape == (DET_BATCH, task.det.max_per_img, 5 if path.rotated else 4) and \
        torch.isfinite(dets.boxes).all() and bool((dets.scores[dets.valid] > task.det.score_thr).all())
    if path.masks:
        ok = ok and dets.mask_logits.shape == (DET_BATCH, task.det.max_per_img,
                                               task.det.mask_size, task.det.mask_size) \
            and bool(torch.isfinite(dets.mask_logits).all())
    log(f"[predict {path.name}] {DET_BATCH} images of {crop}², bf16: launches {p_launched}; "
        f"median {statistics.median(times) * 1e3:.2f} ms a predict, "
        f"{statistics.median(times) * 1e3 / DET_BATCH:.2f} ms/image (min "
        f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}); detections kept an image "
        f"{kept} of {task.det.max_per_img} (score_thr {task.det.score_thr})")
    if not ok:
        raise AssertionError(f"bad detections {tuple(dets.boxes.shape)}")
    if path.head in ("mask_rcnn", "retinanet") and not all(kept):
        raise AssertionError(f"an image kept no detection: {kept}")
    if path.masks:
        check_paste(path, dets, crop)
    evals = [det_batch(DET_BATCH, (crop, crop), K, SEED + 20 + i, path.rotated, path.masks)
             for i in range(2)]
    if path.masks:
        t0 = time.perf_counter()
        res = task.evaluate(state, iter(evals), coco=True)
        log(f"[eval {path.name}] COCO bbox and segm on {2 * DET_BATCH} synthetic images "
            f"(random weights after {state.step} steps; {time.perf_counter() - t0:.1f} s): "
            + ", ".join(f"{k} {v:.3f}" for k, v in res.items()))
        if len(res) != 24 or not all(math.isfinite(v) for v in res.values()):
            raise AssertionError(f"bad COCO stats {res}")
    else:
        res = task.evaluate(state, iter(evals))
        log(f"[eval {path.name}] VOC AP50{' (rotated IoU)' if path.rotated else ''} on "
            f"{2 * DET_BATCH} synthetic images (random "
            f"weights after {state.step} steps): mAP {res['mAP']:.3f}")
        if not 0.0 <= res["mAP"] <= 100.0:
            raise AssertionError(f"bad mAP {res}")

    sanity_run(task, batches[0], tag, initial)
    return {"train": launched, "predict": p_launched}


def check_paste(path: DetPath, dets, hw: int) -> None:
    """`paste_masks_device` on the card against `paste_masks` on the host,
    for the valid detections' mask probabilities (sigmoid of the predict's
    fp32 logits, taken to the host as they are) and boxes: pixels may
    differ only where the card's probability lies within 1e-6 of the 0.5
    threshold; both timed (host clock, the card's ended by a sync), the
    card on its first call and on a second one."""
    v = dets.valid
    probs = torch.sigmoid(dets.mask_logits[v].float())
    boxes = dets.boxes[v].float()
    torch.cuda.synchronize()
    t_card = []
    with timed_window():
        t0 = time.perf_counter()
        host = paste_masks(probs.cpu().numpy(), boxes.cpu().numpy(), hw, hw)
        t_host = time.perf_counter() - t0
        for _ in range(2):
            reset_counters()
            t0 = time.perf_counter()
            card = paste_masks_device(probs, boxes, hw, hw)
            torch.cuda.synchronize()
            t_card.append(time.perf_counter() - t0)
    launched = counters()
    near = (mask_probabilities(probs, boxes, hw, hw) - 0.5).abs() <= 1e-6
    differ = card.cpu().numpy() != host
    outside = int((torch.from_numpy(differ) & ~near.cpu()).sum())
    log(f"[paste {path.name}] {int(v.sum())} masks of {hw}²: the card's paste against "
        f"the host's: {int(differ.sum())} of {differ.size} pixels differ, {int(near.sum())} "
        f"pixels within 1e-6 of the threshold, {outside} differing off it; {int(host.sum())} "
        f"mask pixels; host {t_host * 1e3:.1f} ms, card {t_card[0] * 1e3:.1f} ms on its "
        f"first call, {t_card[1] * 1e3:.1f} ms on a second (K3 launches "
        f"{launched['bilinear_sample']} a call)")
    if outside or launched["bilinear_sample"] != 1:
        raise AssertionError(f"the card's paste differs off the threshold at {outside} "
                             f"pixels, or launched {launched}")


def run_det_path(path: DetPath, card: str, refs: References) -> dict:
    """Phase 19, 20, 21 or 22 for one recipe: card vs CPU forward and
    gradients (unless not `gradients`) at the strip, then the train step,
    predict and evaluate at the recipe's size."""
    free()
    with phase_time(f"{path.name} models"):
        ref = refs.take("det", path.name)
        model_cpu = refs.model("det", path.name, ref)
    with phase_time(f"{path.name} logits"):
        phase_det_forward(path, model_cpu, ref.pop("forward"))
    free()
    if path.gradients:
        with phase_time(f"{path.name} gradients"):
            phase_det_gradients(path, model_cpu, ref.pop("grads"))
    del model_cpu, ref
    free()
    with phase_time(f"{path.name} train"):
        return phase_det_train(path, card)


# ------------------------------------------------------------- phase 23 --

MTP_VIT = recipe("mtp_vit_l_rvsa_448_samrs")
MTP_XL = recipe("mtp_internimage_xl_448_samrs")
MTP_STRIP = (448, 128)  # card vs CPU: a 28×8 token grid, one image a dataset
MTP_G, MTP_VALID = 24, 12  # bench.py's synthetic pretraining batch
MTP_STEPS = 6           # timed steps after 3
MTP_AB_STEPS = 3        # steps of each A/B block
# the ss trunk, both decoders and the nine final layers: the "convs" group
MTP_HEADS = ("encoder.fpn", "semsegdecoder.", "semseghead_", "inssegdecoder.",
             "inssegroi", "rotdetdecoder.", "rotdetroi")


@dataclasses.dataclass(frozen=True)
class MtpPath:
    """A multitask pretraining recipe's model at full width and depth, what
    phase 23 expects of it, and what `check_gradients`' helpers read."""

    name: str
    recipe: TaskConfig
    flops: Callable[[int], float]        # backbone forward FLOPs of one image
    per_forward: Dict[str, int]          # one encoder pass over the 3 images
    step: Dict[str, int]                 # a train step, sequential detection
    step_multi: Dict[str, int]           # a train step with det_multi
    per_predict: Dict[str, int]          # one dataset's predict
    seg: TaskConfig                      # the recipe the exported encoder loads into
    grad_rtol: Dict[str, float] = dataclasses.field(default_factory=lambda: GRAD_RTOL)
    head_prefixes: ClassVar[Tuple[str, ...]] = MTP_HEADS
    grad_stochastic: ClassVar[bool] = True

    @property
    def per_step(self) -> Dict[str, int]:
        """The gradient check's launches: the CPU's proposals and rotated
        IoUs are replayed, so no NMS and no R1."""
        return {**self.step, "nms": 0, "rbox_iou": 0}


def mtp_launches(fwd: Dict[str, int], step: Dict[str, int]) -> Tuple[dict, dict, dict]:
    """(a step, a det_multi step, one dataset's predict) over a backbone of
    `fwd` launches a forward and `step` a train step: the sequential
    detection losses run N1 once per RPN (3 Mask R-CNN, 3 Oriented R-CNN),
    R1's dense form once per Oriented R-CNN assigner and K3 once more per
    Mask R-CNN branch (the mask targets' sampling of the gt crops); the
    concatenated form (det_multi) each once a task; a predict N1 for each
    RPN and for Mask R-CNN's class-aware NMS, R1's mask form for Oriented
    R-CNN's."""
    k3 = step["bilinear_sample"]
    return ({**step, "bilinear_sample": k3 + 3, "nms": 6, "rbox_iou": 3},
            {**step, "bilinear_sample": k3 + 1, "nms": 2, "rbox_iou": 1},
            {**fwd, "nms": 3, "nms_rotated": 1})


MTP_PATHS = {
    # ViT-L+RVSA at 448²: phase 23 since PR 14
    "mtp_vit": MtpPath("mtp_vit", MTP_VIT,
                       lambda crop: backbone_flops(MTP_VIT.backbone, (crop, crop)),
                       VIT_FWD, *mtp_launches(VIT_FWD, VIT_STEP), seg=RVSA),
    # InternImage-XL at 448² with remat (K8 on maps of 112², 56², 28², 14²),
    # its backbone held at 5e-3 as phase 19's XL; its encoder loads into
    # the XL segmentation recipe at 512²
    "mtp_xl": MtpPath("mtp_xl", MTP_XL,
                      lambda crop: internimage_flops(internimage_config(MTP_XL.backbone), crop),
                      XL_FWD, *mtp_launches(XL_FWD, XL_STEP), seg=XL,
                      grad_rtol=GRAD_RTOL_STOCHASTIC),
}


def mtp_batch(hw: Tuple[int, int], seed: int) -> dict:
    """bench.py's synthetic pretraining batch at one image a SAMRS dataset
    ({"d0", "d1", "d2"}): seeded images and ss labels, MTP_G padded gts
    with MTP_VALID valid, horizontal boxes of sides 16-64 px and rotated
    ones 24-60 × 12-30 px at any angle (foreground labels), and each
    horizontal gt's box-aligned mask crop (`mask_crops`, the loader's
    default)."""
    rng = np.random.default_rng(seed)
    H, W = hw
    out = {}
    for d, c in enumerate(SAMRS_CLASSES):
        xy = rng.uniform(0, 1, (1, MTP_G, 2)) * [W - 80, H - 80] + 16
        valid = np.zeros((1, MTP_G), bool)
        valid[:, :MTP_VALID] = True
        centre = rng.uniform(0, 1, (1, MTP_G, 2)) * [W - 32, H - 32] + 16
        out[f"d{d}"] = {
            "image": rng.standard_normal((1, H, W, 3)).astype(np.float32),
            "ss_label": rng.integers(0, c, (1, H, W)).astype(np.int64),
            "gt_boxes": np.concatenate([xy, xy + rng.uniform(16, 64, (1, MTP_G, 2))],
                                       -1).astype(np.float32),
            "gt_labels": rng.integers(0, c - 1, (1, MTP_G)),
            "gt_valid": valid,
            "gt_mask_crops": mask_crops(1, seed + 100 + d)[:, :MTP_G] * valid[..., None, None],
            "r_gt_boxes": np.concatenate([centre, rng.uniform(24, 60, (1, MTP_G, 1)),
                                          rng.uniform(12, 30, (1, MTP_G, 1)),
                                          rng.uniform(-1.2, 1.2, (1, MTP_G, 1))],
                                         -1).astype(np.float32),
            "r_gt_labels": rng.integers(0, c - 1, (1, MTP_G)),
            "r_gt_valid": valid,
        }
    return out


def mtp_task(cfg: TaskConfig, **kw) -> MultiTaskPretrainTask:
    """The recipe's task (score_thr 0.001 through `det_overrides`, as
    phases 21-22 take it: random weights clear no 0.05)."""
    return MultiTaskPretrainTask(cfg, det_overrides={"score_thr": SCORE_THR}, **kw)


def fp32(cfg: TaskConfig) -> TaskConfig:
    """The recipe with its backbone in fp32."""
    return dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, dtype="float32"))


def _mtp_heads(model, images: torch.Tensor, props: Optional[dict]):
    """fp32 encoder levels, each dataset's ss logits (eval mode), both
    FPNs' levels and RPN outputs and, on `props` ({(task, d): (P, 4 or 5)},
    the CPU's; the model's own when None), each dataset's box head outputs
    and Mask R-CNN's mask logits on its first MASK_ROIS proposals.
    Returns ([(name, tensor)], props)."""
    enc = model.encode(images)
    out = [(f"encoder level {i}", t) for i, t in enumerate(enc)]
    out += [(f"ss logits d{d}", model.ss_logits([t[d:d + 1] for t in enc], d, False, True))
            for d in range(3)]
    hw = tuple(images.shape[1:3])
    anchors = torch.as_tensor(det_core.anchors_for(None, hw), device=images.device)
    own = props is None
    props = props or {}
    for task, fwd, dets in (("is", model.is_forward, model.det_h_cfgs),
                            ("rd", model.rd_forward, model.det_r_cfgs)):
        feats, rpn = fwd(enc)
        out += [(f"{task} FPN level {i}", t) for i, t in enumerate(feats)]
        out += [(f"{task} RPN scores", rpn.cls_scores), (f"{task} RPN deltas", rpn.deltas)]
        if own:
            det = dets[0]
            boxes, _ = gen_proposals(rpn, anchors, hw, det.nms_pre, det.max_proposals,
                                     det.rpn_nms_iou, det.rotated,
                                     level_sizes=det_core.anchor_level_sizes(hw))
            props.update({(task, d): boxes[d] for d in range(3)})
        for d in range(3):
            fd, p = [t[d:d + 1] for t in feats], props[task, d].to(images.device)
            bidx = torch.zeros(p.shape[0], dtype=torch.long, device=images.device)
            cls, reg = model.box_fn(task, fd, d)(p, bidx)
            out += [(f"{task} d{d} box logits", cls), (f"{task} d{d} box deltas", reg)]
            if task == "is":
                out.append((f"is d{d} mask logits",
                            model.mask_fn(fd, d)(p[:MASK_ROIS], bidx[:MASK_ROIS])))
    return out, props


def mtp_forward_inputs() -> torch.Tensor:
    """One seeded image of the strip a dataset."""
    return torch.from_numpy(np.concatenate([b["image"] for b in mtp_batch(
        MTP_STRIP, SEED + 1).values()]))


@torch.no_grad()
def mtp_forward_reference(path: MtpPath, model_cpu) -> dict:
    """`phase_mtp_forward`'s CPU half."""
    t0 = time.perf_counter()
    out, props = _mtp_heads(model_cpu, mtp_forward_inputs(), None)
    return {"out": out, "props": props, "seconds": time.perf_counter() - t0}


@torch.no_grad()
def phase_mtp_forward(path: MtpPath, model_cpu, ref: dict) -> None:
    """fp32, one image a dataset of the strip, card against CPU (`ref`,
    `mtp_forward_reference`'s): the encoder's
    levels, each dataset's ss logits, both FPNs' levels and RPN outputs,
    and on the CPU's proposals each dataset's box heads and mask logits;
    each within SLICE_TOL of its max |ref|."""
    x = mtp_forward_inputs()
    ref, props, t_cpu = ref["out"], ref["props"], ref["seconds"]
    model = copy.deepcopy(model_cpu).cuda()
    reset_counters()
    got, _ = _mtp_heads(model, x.cuda(), props)
    launched = counters()
    if launched != path.per_forward:
        raise AssertionError(f"launch counts {launched} != {path.per_forward}")
    parts, worst = [], 0.0
    for (name, g), (_, r) in zip(got, ref):
        g = g.float().cpu()
        if g.shape != r.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{name}: {tuple(g.shape)} vs {tuple(r.shape)} or non-finite")
        rel = ((g - r).abs().max() / r.abs().max()).item()
        worst = max(worst, rel)
        parts.append(f"{name} {rel:.2e}")
    log(f"[{path.name}] fp32 3 images of {MTP_STRIP[0]}×{MTP_STRIP[1]} (one a dataset), card vs "
        f"CPU, max |Δ| / max |ref| (tol {SLICE_TOL}), heads on the CPU's proposals: "
        + ", ".join(parts) + f"; worst {worst:.3e}; CPU forward {t_cpu:.1f} s; "
        f"launches {launched}")
    if not worst <= SLICE_TOL:
        raise AssertionError(f"the card's multitask model disagrees with the CPU: {worst:.3e}")


def _mtp_loss_and_grads(cfg: TaskConfig, model, batch, device: str):
    """One backward of the 9-way loss on `device`, train mode (BatchNorm
    on batch statistics, dropout and drop-path on, every draw from one CPU
    generator of one seed): (loss, {name: loss}, {parameter: gradient})."""
    task = mtp_task(cfg, model=model, device=device)
    model.zero_grad(set_to_none=True)
    loss, losses = task.loss_fn(model, to_device(batch, device), _gen(SEED + 4))
    loss.backward()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), {k: v.item() for k, v in losses.items()}, grads


def mtp_gradients_reference(path: MtpPath, model_cpu) -> dict:
    """`phase_mtp_gradients`' CPU half: the CPU's run (loss, named losses,
    gradients), its seconds, its max-pool picks and what its six RPNs and
    three rotated assigners gave (`held`, replayed on the card)."""
    cfg, batch = fp32(path.recipe), to_device(mtp_batch(MTP_STRIP, SEED + 3), "cpu")
    held: Dict[str, list] = {"gen_proposals": [], "rbox_overlaps": []}
    picks: Dict[tuple, torch.Tensor] = {}
    t0 = time.perf_counter()
    with mtp_replays(held), recorded_pool_picks(picks):
        run = _mtp_loss_and_grads(cfg, model_cpu, batch, "cpu")
    return {"cpu": run, "seconds": time.perf_counter() - t0, "picks": picks, "held": held}


def mtp_replays(held: Dict[str, list]):
    """The six RPNs' proposals and the rotated assigners' IoUs, recorded
    where the CPU runs and replayed on the card (`cpu_replay`)."""
    stack = contextlib.ExitStack()
    for name in ("gen_proposals", "rbox_overlaps"):
        stack.enter_context(cpu_replay(det_core, name, held[name]))
    return stack


def phase_mtp_gradients(path: MtpPath, model_cpu, ref: dict) -> None:
    """fp32 gradients of the 9-way loss at one image a dataset of the
    strip, card against CPU (`ref`, `mtp_gradients_reference`'s; phase 6's
    rule: backbone rtol 1e-3, XL's 5e-3 as
    phase 19's, the decoders and final layers 1e-2; the TF32 control must
    fail), and each named loss within LOSS_RTOL.  Both sides take what the
    CPU decides where rounding could tip a discrete choice (phases 19-21):
    the six RPNs' proposals and the rotated assigners' IoUs (`cpu_replay`),
    the fpn4 max-pool picks of the CPU's loss (`recorded_pool_picks`), and
    one CPU generator's dropout, drop-path and sampler draws.  The ss
    trunk's BatchNorm runs per dataset on one image: its PSP pool-1 branch
    normalises one value a channel, whose gradient is 0 in exact
    arithmetic (the absolute floor, GRAD_ATOL·‖g_all‖, holds it)."""
    tag, cfg = f"[grads {path.name}]", fp32(path.recipe)
    batch = to_device(mtp_batch(MTP_STRIP, SEED + 3), "cpu")
    runs, picks = {"cpu": ref["cpu"]}, ref["picks"]
    log(f"{tag} cpu: loss {runs['cpu'][0]:.6f} forward+backward {ref['seconds']:.1f} s")
    model_gpu = copy.deepcopy(model_cpu).cuda()
    with mtp_replays(ref["held"]), fixed_pool_picks(picks):
        reset_counters()
        t0 = time.perf_counter()
        runs["cuda"] = _mtp_loss_and_grads(cfg, model_gpu, batch, "cuda")
        torch.cuda.synchronize()
        launched = counters()
        log(f"{tag} cuda: loss {runs['cuda'][0]:.6f} forward+backward "
            f"{time.perf_counter() - t0:.1f} s")
        _tf32(True)
        try:
            control = _mtp_loss_and_grads(cfg, model_gpu, batch, "cuda")
        finally:
            _tf32(False)
    if launched != path.per_step:
        raise AssertionError(f"launch counts {launched} != {path.per_step}")
    (_, l_ref, g_ref), (_, l_got, g_got) = runs["cpu"], runs["cuda"]
    rel = {k: abs(l_got[k] - v) / max(abs(v), 1e-12) for k, v in l_ref.items()}
    bad_losses = [k for k, r in rel.items() if not (r <= LOSS_RTOL or l_ref[k] == l_got[k])]
    ok, summary = _grad_verdict(path, runs["cpu"][::2], runs["cuda"][::2])
    control_ok, control_summary = _grad_verdict(path, runs["cpu"][::2], control[::2])
    worst = max(rel, key=rel.get)
    log(f"{tag} fp32 3 images of {MTP_STRIP[0]}×{MTP_STRIP[1]}, dropout + drop-path on, the "
        f"CPU's proposals, max-pool picks and rotated assigner IoUs, card vs CPU: "
        f"{len(rel)} named losses, largest rel {rel[worst]:.3e} at {worst} (tol {LOSS_RTOL}); "
        f"{summary}; launches {launched}")
    log(f"{tag} control, the card with TF32 on, vs CPU: {control_summary}")
    if bad_losses or not ok:
        raise AssertionError(f"card disagrees with the CPU: losses {bad_losses}; {summary}")
    if control_ok:
        raise AssertionError("the TF32 control passed the gradient tolerance")


def ordered_sample(assign, generator, num: int, pos_fraction: float):
    """A sampler without draws, image by image the same whatever the batch:
    positives in index order up to int(num · pos_fraction), then negatives
    in index order (what both detection forms are compared under)."""
    gt = assign.gt_inds
    A = gt.shape[-1]
    pos, neg = gt > 0, gt == 0
    pos_sel = pos & (pos.long().cumsum(-1) <= int(num * pos_fraction))
    neg_sel = neg & (neg.long().cumsum(-1) <= num - pos_sel.sum(-1, keepdim=True))
    key = (2 * pos_sel.long() + neg_sel.long()) * A + (A - 1 - torch.arange(A, device=gt.device))
    inds = torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :num]
    take = lambda t: t.gather(-1, inds)
    return SampleResult(inds, take(pos_sel), take(pos_sel | neg_sel),
                        (take(gt) - 1).clamp(min=0), take(assign.labels))


def check_det_multi(path: MtpPath, model, batch: dict) -> None:
    """The concatenated detection form against the sequential one on the
    card, fp32, same weights and batch, train mode, one seed's draws for
    the encoder and the ss heads and `ordered_sample` for the samplers:
    every named loss within LOSS_RTOL and every gradient by the path's
    phase-6 rule."""
    cfg = fp32(path.recipe)
    runs = {}
    with mock.patch.object(det_core, "random_sample", ordered_sample):
        for multi in (False, True):
            model.det_multi = multi
            runs[multi] = _mtp_loss_and_grads(cfg, model, batch, "cuda")
    model.det_multi = False
    (l0, n0, g0), (l1, n1, g1) = runs[False], runs[True]
    rel = {k: abs(n1[k] - v) / max(abs(v), 1e-12) for k, v in n0.items()}
    ok, summary = _grad_verdict(path, (l0, g0), (l1, g1))
    worst = max(rel, key=rel.get)
    log(f"[det_multi {path.name}] fp32, the train batch, det_multi=True vs the sequential form on the "
        f"card: {len(rel)} named losses, largest rel {rel[worst]:.3e} at {worst}; {summary}")
    if max(rel.values()) > LOSS_RTOL or not ok:
        raise AssertionError(f"the concatenated form differs: {summary}")


def phase_mtp_train(path: MtpPath, card: str) -> dict:
    """The recipe's train step at batch 3 of 448² (one image a dataset, the
    recipe's 24 = 3 a GPU × 8) through `MultiTaskPretrainTask.init_state` →
    `fit` (checkpoint and encoder export) → `evaluate`: launches, ms/step,
    images/s, data_time, peak memory, busy share and kernel groups, the 30
    named losses; the concatenated detection form (det_multi) against the
    sequential one (`check_det_multi`), its launches and its steps timed in
    the order A B B A; the 9-way evaluation on one batch, with a predict's
    launches; the exported encoder loaded into the segmentation recipe of
    its backbone (`path.seg`) and run; a fixed-batch sanity run whose loss
    must fall."""
    cfg = path.recipe
    tag, hw = f"[train {path.name}]", (cfg.backbone.img_size,) * 2
    task = mtp_task(cfg)
    t0 = time.perf_counter()
    state = task.init_state(_gen(SEED))
    initial = host_copy(state.model)
    opt = cfg.train.optimizer
    log(f"{tag} init_state {time.perf_counter() - t0:.1f} s; recipe lr {opt.lr} wd "
        f"{opt.weight_decay} layer decay {opt.layer_decay} clip {opt.clip_norm}, schedule "
        f"{cfg.train.schedule.kind} ({cfg.train.schedule.warmup_steps} warm-up), remat "
        f"{cfg.backbone.remat}, drop-path {cfg.backbone.drop_path_rate}; batch 3 (one image a "
        f"dataset; the recipe's {cfg.train.batch_size} over {cfg.train.batch_size // 3} GPUs), "
        f"classes "
        f"{task.model.classes}")
    batches = [mtp_batch(hw, SEED + 10 + i) for i in range(3)]
    logs = []
    log_fn = lambda i, m: logs.append(m)
    torch.cuda.synchronize()
    reset_counters()
    state, m = task.fit(state, cycle(batches), 1, log_every=1, log_fn=log_fn)
    torch.cuda.synchronize()
    launched = counters()
    log(f"{tag} launches in one train step: {launched}, expected {path.step}")
    if launched != path.step:
        raise AssertionError(f"launch counts {launched} != {path.step}")
    with tempfile.TemporaryDirectory(prefix="mtp_chip_smoke_") as tmp:
        enc_path = os.path.join(tmp, "mtp_encoder.pth")
        t0 = time.perf_counter()
        state, _ = task.fit(state, cycle(batches), 2, log_every=1, log_fn=log_fn,
                            ckpt=CheckpointStore(os.path.join(tmp, "ckpt")),
                            encoder_path=enc_path)
        t_save = time.perf_counter() - t0
        export = load_encoder(enc_path, cfg.backbone)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logs.clear()
    with timed_window():
        state, _ = task.fit(state, cycle(batches), MTP_STEPS, log_every=1, log_fn=log_fn)
    peak = torch.cuda.max_memory_allocated()
    for m in logs:
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite train metrics {m}")
    step_ms = [m["step_time"] * 1e3 for m in logs]
    per = statistics.median(step_ms)
    data_ms = statistics.median(m["data_time"] * 1e3 for m in logs)
    dev_batch = to_device(batches[0], "cuda")
    kernel_ms, groups = _busy(task, state, dev_batch)
    named = {k: v for k, v in logs[-1].items() if k.startswith(("ss_", "is_", "rd_"))}
    if len(named) != 30:
        raise AssertionError(f"named losses {sorted(named)}")
    flops = 3 * path.flops(hw[0]) * 3
    log(f"{tag} recipe train step, batch 3 of {hw[0]}², bf16 autocast, drop-path and "
        f"dropout on, sequential detection: median {per:.2f} ms/step over {len(step_ms)} (min "
        f"{min(step_ms):.2f}, max {max(step_ms):.2f}), {3 / per * 1e3:.3f} images/s, "
        f"data_time median {data_ms:.3f} ms, backbone ~{flops / per / 1e9:.2f} TFLOP/s (3× "
        f"forward), peak memory {peak / 2 ** 30:.3f} GiB; busy {kernel_ms / per:.3f} "
        f"({kernel_ms:.2f} ms of device kernels a step, torch.profiler, {BUSY_STEPS} step, over the "
        f"median step); loss {logs[0]['loss']:.4f} → {logs[-1]['loss']:.4f}, grad_norm "
        f"{logs[-1]['grad_norm']:.4f}, step {state.step} | card {card}")
    log(f"{tag} the 9 losses (each the sum of its named ones) at the last step: " + ", ".join(
        f"{t}_d{d} {sum(v for k, v in named.items() if k.startswith(f'{t}_d{d}')):.4f}"
        for t in ("ss", "is", "rd") for d in range(3)))
    log(f"{tag} device ms a step by kernel group (launches): " + ", ".join(
        f"{g} {ms:.2f} ({n:.0f})" for g, (ms, n) in
        sorted(groups.items(), key=lambda kv: -kv[1][0])))
    log(f"{tag} checkpoint + encoder export after 2 more steps: {t_save:.1f} s with the steps; "
        f"encoder artifact {len(export)} tensors")

    # the concatenated detection form: the same function, then its step
    check_det_multi(path, state.model, dev_batch)
    model = state.model
    model.det_multi = True
    reset_counters()
    state, _ = task.fit(state, cycle(batches), 1)
    torch.cuda.synchronize()
    multi_launched = counters()
    if multi_launched != path.step_multi:
        raise AssertionError(f"det_multi launch counts {multi_launched} != {path.step_multi}")
    blocks = []
    for multi in (False, True, True, False):
        model.det_multi = multi
        logs.clear()
        with timed_window():
            state, _ = task.fit(state, cycle(batches), MTP_AB_STEPS, log_every=1,
                                log_fn=log_fn)
        blocks.append(statistics.median(m["step_time"] * 1e3 for m in logs))
    model.det_multi = False
    seq, multi = (blocks[0] + blocks[3]) / 2, (blocks[1] + blocks[2]) / 2
    log(f"[det_multi {path.name}] recipe step, batch 3 of {hw[0]}², bf16, A B B A blocks of "
        f"{MTP_AB_STEPS} steps (median each): sequential {blocks[0]:.2f} / {blocks[3]:.2f}, "
        f"det_multi {blocks[1]:.2f} / {blocks[2]:.2f} ms/step; det_multi / sequential "
        f"{multi / seq:.3f}; launches a step: sequential {path.step}, det_multi "
        f"{multi_launched} | card {card}")

    # the 9-way validation on one batch, and one dataset's predict
    t0 = time.perf_counter()
    res = task.evaluate(state, iter([mtp_batch(hw, SEED + 20)]))
    t_eval = time.perf_counter() - t0
    log(f"[eval {path.name}] 9-way on one batch (3 images of {hw[0]}², random weights after "
        f"{state.step} steps, score_thr {SCORE_THR}; {t_eval:.1f} s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in res.items()))
    if len(res) != 3 * 6 + 3 or not all(math.isfinite(v) for v in res.values()):
        raise AssertionError(f"bad 9-way metrics {res}")
    images = torch.from_numpy(batches[0]["d0"]["image"]).cuda()
    with torch.no_grad(), task.autocast():
        reset_counters()
        task.predict_fn()(images, 0)
        torch.cuda.synchronize()
    p_launched = counters()
    log(f"[predict {path.name}] one dataset's predict (ss, Mask R-CNN, Oriented R-CNN): "
        f"launches {p_launched}, expected {path.per_predict}")
    if p_launched != path.per_predict:
        raise AssertionError(f"predict launch counts {p_launched} != {path.per_predict}")

    # the exported encoder in its backbone's segmentation recipe
    seg_cfg = path.seg
    seg, crop = SegmentationTask(seg_cfg), seg_cfg.backbone.img_size
    sd = backbone_state_dict(export, seg_cfg.backbone)
    seg_state = seg.init_state(_gen(SEED), pretrained_backbone=sd)
    loaded = seg_state.model.backbone.state_dict()
    same = loaded.keys() == sd.keys() and all(torch.equal(v.cpu(), sd[k])
                                              for k, v in loaded.items())
    x = torch.from_numpy(synthetic_batch(1, (crop, crop), seg_cfg.num_classes,
                                         SEED + 41)["image"])
    with torch.no_grad(), seg.autocast():
        out = seg_state.model.predict(x.cuda()).float()
    resized = (f"pos_embed {tuple(sd['pos_embed'].shape)}, " if "pos_embed" in sd else "")
    log(f"[export {path.name}] the fit's encoder artifact ({hw[0]}²) → the {seg_cfg.backbone.name} "
        f"segmentation recipe at {crop}²: {resized}{len(sd)} tensors; loaded weights equal "
        f"{same}; one forward {tuple(out.shape)} finite {bool(torch.isfinite(out).all())}")
    if not same or out.shape != (1, crop, crop, seg_cfg.num_classes) or \
            not torch.isfinite(out).all():
        raise AssertionError("the exported encoder did not load into the segmentor")
    del seg, seg_state, export
    free()

    sanity_run(task, batches[0], tag, initial)
    return {"train": launched, "predict": p_launched}


def run_mtp_path(path: MtpPath, card: str, refs: References) -> dict:
    """Phase 23 for one recipe: card vs CPU at the strip, then the train
    step, the concatenated form, evaluate and the encoder export at 448²."""
    free()
    with phase_time(f"{path.name} models"):
        ref = refs.take("mtp", path.name)
        model_cpu = refs.model("mtp", path.name, ref)
    with phase_time(f"{path.name} logits"):
        phase_mtp_forward(path, model_cpu, ref.pop("forward"))
    free()
    with phase_time(f"{path.name} gradients"):
        phase_mtp_gradients(path, model_cpu, ref.pop("grads"))
    del model_cpu, ref
    free()
    with phase_time(f"{path.name} train"):
        return phase_mtp_train(path, card)


# ------------------------------------------------------------- phase 24 --

CLI_RECIPE = "rvsa-l-upernet-384-mae-mtp-spacenetv1"
CLI_TILE, CLI_TRAIN, CLI_VAL = 512, 16, 4  # bench.py's tile; tiles a split
CLI_BATCH, CLI_STEPS, CLI_RESUME_TO, CLI_CKPT_EVERY, CLI_WORKERS = 8, 6, 8, 3, 4
# --eval-after and cli.test slide over each 512² val tile in 4 crops of 384²
# at stride 256, one forward a crop; cli.test's --save-pred predicts the
# first tile once more
CLI_CROPS = len(slide_origins(CLI_TILE, CLI_TILE, 384, 256))
CLI_EVAL_FORWARDS = CLI_VAL * CLI_CROPS


def write_spacenet(root: str, seed: int) -> None:
    """SpaceNet v1's on-disk layout (`data/bindings.py`): img_dir/{train,val}
    RGB PNG tiles of 512² and ann_dir/{train,val} PNG labels in {0, 1}, made
    from `seed`: a dark noisy ground (class 0) with 25-39 brighter
    rectangles of 16-96 px a tile (class 1, buildings; ~30% of the pixels,
    a dense urban tile, so that most crops pass the recipe's cat_max_ratio
    of 0.75 at once)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for split, n in (("train", CLI_TRAIN), ("val", CLI_VAL)):
        for sub in ("img_dir", "ann_dir"):
            os.makedirs(os.path.join(root, sub, split))
        for i in range(n):
            img = rng.integers(0, 120, (CLI_TILE, CLI_TILE, 3), dtype=np.uint8)
            lab = np.zeros((CLI_TILE, CLI_TILE), np.uint8)
            for _ in range(int(rng.integers(25, 40))):
                y, x = (int(v) for v in rng.integers(0, CLI_TILE - 16, 2))
                h, w = (int(v) for v in rng.integers(16, 97, 2))
                lab[y:y + h, x:x + w] = 1
            img[lab == 1] += 100
            Image.fromarray(img).save(os.path.join(root, "img_dir", split, f"{i}.png"))
            Image.fromarray(lab).save(os.path.join(root, "ann_dir", split, f"{i}.png"))


def cli_run(main, argv, **kw):
    """`main(argv)` of a port CLI in this process (the kernels built earlier
    serve it): (its return value, the JSON result line it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(argv, **kw)
    lines = buf.getvalue().strip().splitlines()
    log(f"[cli] {' '.join(argv[:1] + [a for a in argv[1:] if a.startswith('--')])} → "
        f"{lines[-1] if lines else '(nothing printed)'}")
    return ret, json.loads(lines[-1])


def read_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


@contextlib.contextmanager
def timed_saves(saves: list, writes: list):
    """The wall time of each `CheckpointStore.save` call (the host snapshot,
    plus the write where the call waits for it) and of each background
    write (`_commit`: torch.save, fsync, rename)."""
    save, commit = CheckpointStore.save, CheckpointStore._commit

    def timed(fn, into):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                into.append(time.perf_counter() - t0)
        return run

    with mock.patch.object(CheckpointStore, "save", timed(save, saves)), \
            mock.patch.object(CheckpointStore, "_commit", timed(commit, writes)):
        yield


def expect_launches(what: str, steps: int, forwards: int) -> Dict[str, int]:
    """Read the launch counts of the run just driven (set to 0 before it)
    and hold them to `steps` ViT train steps and `forwards` ViT forwards."""
    torch.cuda.synchronize()
    launched = counters()
    want = {k: steps * VIT_STEP[k] + forwards * VIT_FWD[k] for k in COUNTERS}
    log(f"[cli] {what} launches: {launched}, expected {want} ({steps} train steps, "
        f"{forwards} forwards)")
    if launched != want:
        raise AssertionError(f"{what}: launch counts {launched} != {want}")
    return launched


def train_readings(path: str, steps: int, what: str) -> Tuple[float, float]:
    """The JSONL log's `steps` records, each loss and grad norm finite:
    (median step_time, median data_time) in ms."""
    recs = read_jsonl(path)
    if len(recs) != steps or not all(math.isfinite(r["loss"]) and
                                     math.isfinite(r["grad_norm"]) for r in recs):
        raise AssertionError(f"{what}: {len(recs)} records, expected {steps} with finite "
                             f"losses: {recs}")
    losses = " ".join(f"{r['loss']:.4f}" for r in recs)
    step_each = [r["step_time"] * 1e3 for r in recs]
    data_each = [r["data_time"] * 1e3 for r in recs]
    step_ms, data_ms = statistics.median(step_each), statistics.median(data_each)
    log(f"[cli] {what}: losses {losses}; step_time median {step_ms:.2f} ms (each "
        f"{' '.join(f'{t:.1f}' for t in step_each)}), data_time median {data_ms:.3f} ms "
        f"(each {' '.join(f'{t:.2f}' for t in data_each)})")
    return step_ms, data_ms


def phase_cli(card: str) -> dict:
    """Phase 24: the ViT-L recipe trained and evaluated from files on disk
    through the port's CLI, `main(argv)` in this process.  A SpaceNet-layout
    dataset (`write_spacenet`); `cli.train` for 6 steps at batch 8 with 4
    fork workers (forked after this process has initialised CUDA), a
    checkpoint every 3 steps, the encoder export and --eval-after; the
    step-6 checkpoint linked aside; `--resume` to 8, which must train
    exactly 2 steps; `cli.test --ckpt` on the step-6 checkpoint, whose mIoU
    must equal --eval-after's; the training again with 0 workers (the
    prefetch thread); the native host library built and loaded.  Launches
    exact in each run."""
    free()
    saves, writes = [], []
    common = [CLI_RECIPE, "--batch-size", str(CLI_BATCH), "--log-every", "1"]
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mtp_chip_smoke_cli_") as tmp, \
            timed_saves(saves, writes):
        root, ck, eval_ck = (os.path.join(tmp, d) for d in ("spacenet", "ckpt", "ckpt6"))
        enc = os.path.join(tmp, "encoder.pth")
        t0 = time.perf_counter()
        write_spacenet(root, SEED + 240)
        log(f"[cli] SpaceNet layout: {CLI_TRAIN} train + {CLI_VAL} val RGB PNG tiles of "
            f"{CLI_TILE}², labels in {{0, 1}}, written in {time.perf_counter() - t0:.1f} s")
        data = common + ["--data-root", root]

        wd = os.path.join(tmp, "wd")
        reset_counters()
        t0 = time.perf_counter()
        _, out = cli_run(cli_train.main, data + [
            "--steps", str(CLI_STEPS), "--num-workers", str(CLI_WORKERS), "--ckpt-dir", ck,
            "--ckpt-every", str(CLI_CKPT_EVERY), "--encoder-out", enc, "--eval-after",
            "--work-dir", wd])
        t_train = time.perf_counter() - t0
        launched = expect_launches("cli.train", CLI_STEPS, CLI_EVAL_FORWARDS)
        step_ms, data_ms = train_readings(os.path.join(wd, CLI_RECIPE + ".jsonl"),
                                          CLI_STEPS, f"cli.train {CLI_WORKERS} workers")
        eval_miou = out["eval"]["mIoU"]
        steps = CheckpointStore(ck).steps()
        if steps != [CLI_CKPT_EVERY, CLI_STEPS] or not os.path.isfile(enc) or \
                not math.isfinite(eval_miou):
            raise AssertionError(f"cli.train: checkpoints {steps}, encoder "
                                 f"{os.path.isfile(enc)}, eval {out.get('eval')}")
        os.makedirs(eval_ck)  # step 6 alone, for cli.test (a hard link, no copy)
        os.link(os.path.join(ck, f"{CLI_STEPS}.pt"), os.path.join(eval_ck, f"{CLI_STEPS}.pt"))
        log(f"[cli] train {t_train:.1f} s: checkpoints {steps}, encoder "
            f"{os.path.getsize(enc) / 2 ** 20:.1f} MiB, --eval-after mIoU {eval_miou!r} | "
            f"card {card}")
        free()

        wd_resume = os.path.join(tmp, "wd_resume")
        reset_counters()
        t0 = time.perf_counter()
        cli_run(cli_train.main, data + ["--steps", str(CLI_RESUME_TO), "--resume",
                                         "--ckpt-dir", ck, "--work-dir", wd_resume])
        t_resume = time.perf_counter() - t0
        expect_launches("cli.train --resume", CLI_RESUME_TO - CLI_STEPS, 0)
        train_readings(os.path.join(wd_resume, CLI_RECIPE + ".jsonl"),
                       CLI_RESUME_TO - CLI_STEPS, "cli.train --resume")
        if CheckpointStore(ck).latest_step() != CLI_RESUME_TO:
            raise AssertionError(f"resume: latest step {CheckpointStore(ck).latest_step()}")
        log(f"[cli] resume {t_resume:.1f} s: step {CLI_STEPS} → {CLI_RESUME_TO}")
        free()

        pred = os.path.join(tmp, "pred")
        reset_counters()
        t0 = time.perf_counter()
        res, _ = cli_run(cli_test.main, [CLI_RECIPE, "--ckpt", eval_ck, "--data-root", root,
                                         "--save-pred", pred], return_metrics=True)
        t_test = time.perf_counter() - t0
        expect_launches("cli.test", 0, CLI_EVAL_FORWARDS + CLI_CROPS)
        log(f"[cli] cli.test {t_test:.1f} s on the step-{CLI_STEPS} checkpoint: mIoU "
            f"{res['mIoU']!r} against --eval-after's {eval_miou!r}; predictions "
            f"{sorted(os.listdir(pred))}")
        if res["mIoU"] != eval_miou or not os.listdir(pred):
            raise AssertionError(f"cli.test mIoU {res['mIoU']!r} != --eval-after's "
                                 f"{eval_miou!r}, or no prediction saved")
        free()

        wd0 = os.path.join(tmp, "wd0")
        reset_counters()
        t0 = time.perf_counter()
        cli_run(cli_train.main, data + ["--steps", str(CLI_STEPS), "--num-workers", "0",
                                         "--work-dir", wd0])
        t_train0 = time.perf_counter() - t0
        expect_launches("cli.train 0 workers", CLI_STEPS, 0)
        step0_ms, data0_ms = train_readings(os.path.join(wd0, CLI_RECIPE + ".jsonl"),
                                            CLI_STEPS, "cli.train 0 workers")
        free()

    lib = native.get_lib()
    if lib is None or not native.LIB.is_file():
        raise AssertionError("the native host library did not build or load")
    m = (np.random.default_rng(SEED).uniform(size=(37, 41)) < 0.3).astype(np.uint8)
    if not np.array_equal(rle_to_mask(mask_to_rle(m)), m):
        raise AssertionError("native RLE round trip")
    wall = time.perf_counter() - t_phase
    log(f"[cli] native host library {native.LIB.name} loaded, RLE round trip equal")
    log(f"[cli] phase 24: {CLI_RECIPE} batch {CLI_BATCH} of 384² crops from {CLI_TILE}² "
        f"PNG tiles: step_time median {step_ms:.2f} ms with {CLI_WORKERS} workers, "
        f"{step0_ms:.2f} ms with 0; data_time median {data_ms:.3f} ms with {CLI_WORKERS} "
        f"workers, {data0_ms:.3f} ms with 0; checkpoint saves (call wall s) "
        f"{' '.join(f'{t:.2f}' for t in saves)}, background writes (s) "
        f"{' '.join(f'{t:.2f}' for t in writes)}; runs: train {t_train:.1f} s, resume "
        f"{t_resume:.1f} s, test {t_test:.1f} s, train with 0 workers {t_train0:.1f} s; "
        f"wall {wall:.1f} s | card {card}")
    return {"train": launched}


# ------------------------------------------------------------- phase 27 --

EXPORT_REPS = 5         # timed calls of the live and the served predict
EXPORT_TIMEOUT = 600.0  # s an export job, and a serving process, may take
EXPORT_THREADS = 1      # CPU threads of each export job and serving process

# An export job of phase 27 (`ExportJobs`), in its own process: `export_job`.
EXPORT_JOB = r"""
import json, sys
import chip_smoke
chip_smoke.export_job(json.loads(sys.argv[1]))
"""

# A serving process: it imports the port's serving module and nothing else of
# the port (`load_artifact` needs no model code), loads its artifact on the
# card, serves the inputs the parent wrote once (the warm-up), writes a
# `.warm` file and waits for its turn (a `.go` file: the parent lets the
# processes serve one at a time, after the live calls, so that nothing else
# runs beside the timed calls); then it serves them once more and prints its
# load time, the launches of that call, the median of `reps` calls each
# ended by a sync and the modules it imported; then the control, the
# backbone's first patch-embedding weight scaled by 0.9 in place.  Its
# outputs go to a file.
SERVE_WORKER = r"""
import json, os, statistics, sys, time
import torch
from mtp_tpu_torch import serving
from mtp_tpu_torch.ops import dcnv3_sample, fused_attn, nms, rotated_boxes

torch.backends.cuda.matmul.allow_tf32 = False  # phase 1's settings, as the live predict's
torch.backends.cudnn.allow_tf32 = False
counted = (fused_attn.LAUNCHES, dcnv3_sample.LAUNCHES, nms.LAUNCHES, rotated_boxes.LAUNCHES)
host = lambda out: ({k: v.cpu() for k, v in out.items()} if isinstance(out, dict)
                    else out.cpu())
job = json.loads(sys.argv[1])
torch.zeros(1, device="cuda")
deadline = time.monotonic() + job["timeout"]
t0 = time.perf_counter()
serve, meta = serving.load_artifact(job["dir"], "cuda")
torch.cuda.synchronize()
load_s = time.perf_counter() - t0
inputs = [t.cuda() for t in torch.load(job["inputs"], weights_only=True)]
serve(*inputs)
torch.cuda.synchronize()
open(job["warm"], "w").close()
while not os.path.exists(job["go"]):
    if time.monotonic() > deadline:
        sys.exit(f"no {job['go']} in time")
    time.sleep(0.05)
for c in counted:
    c.update(dict.fromkeys(c, 0))
out = serve(*inputs)
torch.cuda.synchronize()
launched = {k: v for c in counted for k, v in c.items()}
times = []
for _ in range(job["reps"]):
    t0 = time.perf_counter()
    serve(*inputs)
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t0)
control = next(k for k in serve.weights
               if k.startswith("backbone.patch_embed.") and k.endswith("weight"))
serve.weights[control].mul_(0.9)
scaled = serve(*inputs)
torch.save({"out": host(out), "control": host(scaled)}, job["result"])
print(json.dumps(dict(load_s=load_s, ms=statistics.median(times) * 1e3, launches=launched,
                      control=control, meta=meta,
                      modules=sorted(m for m in sys.modules if m.split(".")[0] in
                                     ("mtp_tpu_torch", "mtp_tpu", "jax", "flax")))))
"""
MODEL_CODE = ("mtp_tpu_torch.models", "mtp_tpu_torch.heads", "mtp_tpu_torch.tasks",
              "mtp_tpu_torch.configs", "mtp_tpu", "jax", "flax")


@dataclasses.dataclass
class ExportCase:
    """One artifact of phase 27: a registry recipe, its seeded model (built
    on the CPU as its earlier phase builds it), the live task on the card,
    cli.export's further flags, the seeded inputs and the launches of one
    predict."""

    name: str
    recipe: str
    build: Callable[[], torch.nn.Module]
    task: Callable[[torch.nn.Module], object]
    argv: List[str]
    inputs: Callable[[], List[torch.Tensor]]
    launches: Dict[str, int]


def export_cases() -> List[ExportCase]:
    """The ViT-L SpaceNet segmentor on one 384² crop (K1 20, K2 4, K3 40:
    a trace of the 4-crop 512² tile takes 56-75 s on the card's host, so
    the slide graph over several crops is left to the CPU tests), the ViT-L
    Oriented R-CNN on one 800² image (N1 and R1's mask form once each, with
    K1-K3) and the InternImage-XL EuroSAT classifier at batch 2 (K8's 39
    forward launches)."""
    images = lambda n, s, seed: [torch.randn((n, s, s, 3), generator=_gen(seed))]
    rot, cls = ROT_PATHS["det_rot_vit"], TASK_PATHS["cls_xl"]
    return [
        ExportCase("seg_vit", CLI_RECIPE, lambda: build_model(PATHS["rvsa"], (384, 384)),
                   lambda m: SegmentationTask(RVSA, model=m), [],
                   lambda: images(1, 384, SEED + 270), VIT_FWD),
        ExportCase("det_rot_vit", "oriented_rcnn_rvsa_l_800_mae_mtp_diorr",
                   lambda: build_det_model(rot, (800, 800)), lambda m: rot.task(model=m), [],
                   lambda: images(1, 800, SEED + 271), rot.per_predict),
        ExportCase("cls_xl", "intern-xl-224-imp-mtp_eurosat", lambda: build_task_model(cls),
                   lambda m: ClassificationTask(CLS_XL, model=m), ["--batch-size", "2"],
                   lambda: images(2, 224, SEED + 272), cls.per_forward)]


def export_job(job: dict) -> None:
    """One export of phase 27, in an `EXPORT_JOB` process: the case's seeded
    model, saved as a variables file (`save_variables`), then `python -m
    mtp_tpu_torch.cli.export` on the card with that --ckpt, whose output
    goes to this process's; the last line printed holds the seconds of
    each."""
    from mtp_tpu_torch.ckpt.store import save_variables

    torch.set_num_threads(EXPORT_THREADS)
    case = next(c for c in export_cases() if c.name == job["name"])
    t0 = time.perf_counter()
    save_variables(job["ckpt"], case.build())
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sys.stdout.flush()
    done = subprocess.run([sys.executable, "-m", "mtp_tpu_torch.cli.export", case.recipe,
                           "--out", job["dir"], "--ckpt", job["ckpt"], *case.argv])
    if done.returncode != 0:
        sys.exit(f"cli.export failed ({done.returncode})")
    print(json.dumps(dict(build_s=build_s, export_s=time.perf_counter() - t0)), flush=True)


class ExportJobs:
    """Phase 27's exports, started once phase 3b has ended so that they run
    beside phases 3c-3f (host work on one thread each; the traces take no
    kernel) and not on the run's path: one `EXPORT_JOB` process an
    `export_cases` entry, each in a session of its own, which `close()`
    kills whole.  `wait(name)` gives a job's seconds and artifact size once
    it has ended, and raises with its output if it failed."""

    def __init__(self):
        self._dir = tempfile.TemporaryDirectory(prefix="mtp_chip_smoke_export_")
        self.tmp = self._dir.name
        self.root = os.path.dirname(os.path.abspath(__file__))
        self.env = {**os.environ, "PYTHONPATH": self.root,
                    "OMP_NUM_THREADS": str(EXPORT_THREADS)}
        self.t0 = time.perf_counter()
        self.procs: Dict[str, subprocess.Popen] = {}
        for case in export_cases():
            job = dict(name=case.name, dir=self.at(case.name), ckpt=self.at(case.name, ".pt"))
            with open(self.at(case.name, ".export.log"), "w") as out:
                self.procs[case.name] = subprocess.Popen(
                    [sys.executable, "-c", EXPORT_JOB, json.dumps(job)], stdout=out,
                    stderr=subprocess.STDOUT, cwd=self.root, env=self.env,
                    start_new_session=True)

    def at(self, name: str, suffix: str = "") -> str:
        return os.path.join(self.tmp, name + suffix)

    def wait(self, name: str) -> dict:
        proc = self.procs[name]
        try:
            proc.wait(timeout=max(1.0, EXPORT_TIMEOUT - (time.perf_counter() - self.t0)))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"[export {name}] the export job took over "
                                 f"{EXPORT_TIMEOUT:.0f} s") from None
        with open(self.at(name, ".export.log")) as f:
            said = f.read()
        if proc.returncode != 0:
            raise AssertionError(f"[export {name}] the export job failed "
                                 f"({proc.returncode}):\n{said[-6000:]}")
        lines = said.strip().splitlines()
        row = json.loads(lines[-1])
        art = self.at(name)
        row.update(cli=next(x for x in reversed(lines) if x.startswith('{"out"')),
                   mb=sum(os.path.getsize(os.path.join(art, f))
                          for f in os.listdir(art)) / 1e6)
        return row

    def check(self) -> None:
        """Raises if a job has already failed."""
        for name, proc in self.procs.items():
            if proc.poll() not in (None, 0):
                self.wait(name)

    def close(self) -> None:
        try:
            for proc in self.procs.values():
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
        finally:
            self._dir.cleanup()


def _on_host(out):
    return {k: v.cpu() for k, v in out.items()} if isinstance(out, dict) else out.cpu()


def served_verdict(live, served, gap: Optional[torch.Tensor]) -> Tuple[bool, str]:
    """(held, the rule that held or the reading that failed): bit for bit;
    else class maps may differ only where the live top two fp32 logits lie
    within TIE_GAP (phase 26's rule), logits by phase 5's rule (argmax
    agreement ≥ 0.999, max |Δ| ≤ 0.1 of max |logit|), detections by their
    keep sets (valid, labels and scores equal) with boxes within 1e-3 of
    max |box|."""
    if isinstance(live, dict):
        if live.keys() == served.keys() and all(torch.equal(live[k], served[k]) for k in live):
            return True, "bit for bit"
        keep = all(torch.equal(live[k], served[k]) for k in ("valid", "labels", "scores"))
        scale = live["boxes"].abs().max().clamp(min=1e-12)
        off = ((live["boxes"] - served["boxes"]).abs().max() / scale).item()
        return keep and off <= 1e-3, f"keep sets equal {keep}, boxes {off:.3e} of max |box|"
    if torch.equal(live, served):
        return True, "bit for bit"
    if live.is_floating_point():
        agree = (live.argmax(-1) == served.argmax(-1)).float().mean().item()
        drift = ((live - served).abs().max() / live.abs().max()).item()
        return agree >= 0.999 and drift <= 0.1, \
            f"logits: argmax agreement {agree:.6f}, max |Δ| {drift:.3e} of max |logit|"
    diff = live != served
    away = int((diff & (gap >= TIE_GAP)).sum())
    return away == 0, f"class maps: {int(diff.sum())} pixels differ, {away} away from a near tie"


def _live_gap(task, images: torch.Tensor) -> torch.Tensor:
    """The gap between the top two live slide logits of each pixel, fp32."""
    with torch.no_grad(), task.autocast():
        top2 = task.slide_logits(images).float().topk(2, -1).values
    return (top2[..., 0] - top2[..., 1]).cpu()


def _run_live(case: ExportCase, model, inputs: List[torch.Tensor]):
    """The live predict of `model` (`build_export_fn`'s function, eager,
    under the task's autocast) on `inputs`: (its outputs on the host, the
    launches of one call, the median ms of EXPORT_REPS calls each ended by a
    sync, the per-pixel gap of the two top fp32 slide logits for a
    segmentor, else None)."""
    from mtp_tpu_torch.cli import export as cli_export

    task = case.task(model.cuda().eval())
    predict, _, _ = cli_export.build_export_fn(task, task.cfg)
    x = [t.cuda() for t in inputs]
    with torch.no_grad():
        torch.cuda.synchronize()
        reset_counters()
        out = predict(*x)
        torch.cuda.synchronize()
        launched = counters()
        times = []
        for _ in range(EXPORT_REPS):
            t0 = time.perf_counter()
            predict(*x)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    gap = _live_gap(task, x[0]) if task.cfg.task == "segmentation" else None
    return _on_host(out), launched, statistics.median(times) * 1e3, gap


def _wait_warm(serving: Dict[str, Tuple[dict, subprocess.Popen]]) -> None:
    """Until every serving process has loaded its artifact and served once;
    raises with the output of one that ended before."""
    deadline = time.monotonic() + EXPORT_TIMEOUT
    for name, (job, serve) in serving.items():
        while not os.path.exists(job["warm"]):
            if serve.poll() is not None or time.monotonic() > deadline:
                with open(job["log"]) as f:
                    said = f.read()
                raise AssertionError(f"[export {name}] the serving process ended or took "
                                     f"over {EXPORT_TIMEOUT:.0f} s before it served "
                                     f"({serve.returncode}):\n{said[-8000:]}")
            time.sleep(0.05)


def phase_export(card: str, exports: ExportJobs) -> None:
    """Phase 27: the serving artifact.  The exports (`ExportJobs`: each
    case's seeded model saved as a variables file, then `python -m
    mtp_tpu_torch.cli.export` on the card with that --ckpt) ran beside
    phases 3c-3f; here, for each `export_cases` entry, once its export has
    ended, a serving process (`SERVE_WORKER`: it imports only
    `mtp_tpu_torch.serving`) loads the artifact on the card and serves once,
    the three at once, while this process builds the same seeded models and
    moves them to the card.  Then the live predicts (`_run_live`: launches
    exact, median of EXPORT_REPS ms), then the served calls, one process at
    a time, nothing else running: the served launches equal to the live
    call's, the outputs held by `served_verdict`, the modules free of model
    code, and a control (the backbone's first patch-embedding weight scaled
    by 0.9 in the served process) that must fail the same verdict."""
    free()
    t_phase = time.perf_counter()
    cases = export_cases()
    rows: Dict[str, dict] = {}
    serving: Dict[str, Tuple[dict, subprocess.Popen]] = {}
    live, failed = {}, []
    try:
        for case in cases:
            rows[case.name] = exports.wait(case.name)
            at = lambda suffix: exports.at(case.name, suffix)
            torch.save(case.inputs(), at(".in.pt"))
            job = dict(dir=at(""), inputs=at(".in.pt"), result=at(".out.pt"),
                       warm=at(".warm"), go=at(".go"), log=at(".serve.log"),
                       reps=EXPORT_REPS, timeout=EXPORT_TIMEOUT)
            with open(job["log"], "w") as out:
                serving[case.name] = (job, subprocess.Popen(
                    [sys.executable, "-c", SERVE_WORKER, json.dumps(job)], stdout=out,
                    stderr=subprocess.STDOUT, cwd=exports.root, env=exports.env))
            log(f"[cli] cli.export {case.name}: {rows[case.name]['cli']}")
        models = {}
        for case in cases:  # beside the loads
            t0 = time.perf_counter()
            models[case.name] = case.build().cuda().eval()
            rows[case.name]["live_build_s"] = time.perf_counter() - t0
        _wait_warm(serving)
        t_ready = time.perf_counter() - t_phase
        for case in cases:
            out, launched, live_ms, gap = _run_live(case, models.pop(case.name),
                                                    case.inputs())
            if launched != case.launches:
                raise AssertionError(f"[export {case.name}] live launches {launched} != "
                                     f"{case.launches}")
            live[case.name] = (out, gap)
            rows[case.name].update(live_ms=live_ms, launches=launched)
        free()
        for case in cases:  # one at a time, nothing else running
            job, serve = serving[case.name]
            open(job["go"], "w").close()
            serve.wait(timeout=EXPORT_TIMEOUT)
            with open(job["log"]) as f:
                said = f.read()
            if serve.returncode != 0:
                raise AssertionError(f"[export {case.name}] the serving process failed "
                                     f"({serve.returncode}):\n{said[-8000:]}")
            rows[case.name]["served"] = json.loads(said.strip().splitlines()[-1])
    finally:
        for _, serve in serving.values():
            if serve.poll() is None:
                serve.kill()
                serve.wait()
    log(f"[export] the exports' wait, the loads and the live models {t_ready:.1f} s; the "
        f"live and served calls {time.perf_counter() - t_phase - t_ready:.1f} s")
    for case in cases:
        name, row = case.name, rows[case.name]
        job = serving[name][0]
        served = row["served"]
        leaked = [m for m in served["modules"]
                  if any(m == p or m.startswith(p + ".") for p in MODEL_CODE)]
        got = torch.load(job["result"], weights_only=True)
        held, rule = served_verdict(live[name][0], got["out"], live[name][1])
        control, why = served_verdict(live[name][0], got["control"], live[name][1])
        log(f"[export {name}] the seeded model and its variables file {row['build_s']:.1f} "
            f"s and cli.export {row['export_s']:.1f} s (the three jobs beside phases "
            f"3c-3f); artifact {row['mb']:.1f} MB; load {served['load_s']:.1f} s (the three "
            f"at once, beside the live models' build, {row['live_build_s']:.1f} s); served "
            f"{served['ms']:.2f} ms against live {row['live_ms']:.2f} ms (median of "
            f"{EXPORT_REPS}); launches served {served['launches']}, live {row['launches']}; "
            f"outputs: {rule}; control ({served['control']} × 0.9): {why}; the port's "
            f"modules it imported: {served['modules']} | card {card}")
        if leaked:
            failed.append(f"{name}: the serving process imported model code: {leaked}")
        if served["launches"] != row["launches"]:
            failed.append(f"{name}: served launches {served['launches']} != live "
                          f"{row['launches']}")
        if not held:
            failed.append(f"{name}: served outputs off the live ones: {rule}")
        if control:
            failed.append(f"{name}: the control passed: {why}")
    log(f"[export] phase 27 wall {time.perf_counter() - t_phase:.1f} s, the exports "
        f"{max(r['build_s'] + r['export_s'] for r in rows.values()):.1f} s before it")
    if failed:
        raise AssertionError("[export] " + "; ".join(failed))


# ------------------------------------------------------- CPU references --

# the card-vs-CPU checks' CPU halves run in one worker process beside this
# process's card work: its torch threads (the card's host has 8 cores; this
# process launches from one), and how many paths' references it computes
# ahead of the path that takes them (each result a file of up to ~3 GB)
REF_THREADS = 5
REF_AHEAD = 4


def reference_jobs() -> List[Tuple[str, str]]:
    """(kind, path name) of every path whose checks take a reference from
    the worker, in the order `main` runs them."""
    return ([("seg", n) for n in PATHS]
            + [("det", n) for n in {**DET_PATHS, **ROT_PATHS, **INST_PATHS}]
            + [("mtp", n) for n in MTP_PATHS])


def reference_model(kind: str, name: str):
    """The CPU model of a path's checks, undrawn (its weights come from the
    worker's draw, or from `init_weights`)."""
    if kind == "seg":
        path = PATHS[name]
        return Segmentor(path.recipe.backbone, path.recipe.num_classes, input_hw=path.cpu_hw)
    if kind == "det":
        path = {**DET_PATHS, **ROT_PATHS, **INST_PATHS}[name]
        return build_detector(path.head, path.recipe.backbone, path.det, path.strip)
    return MultiTaskPretrainModel(MTP_PATHS[name].recipe.backbone,
                                  det_overrides={"score_thr": SCORE_THR}, input_hw=MTP_STRIP)


def cpu_reference(kind: str, name: str, tmp: str) -> str:
    """In the worker: the path's CPU model, drawn from the seed as this
    process would draw it, its weights as drawn, and the CPU halves of its
    checks (`logits_reference` and `gradients_reference`,
    `det_forward_reference` and `det_gradients_reference`,
    `mtp_forward_reference` and `mtp_gradients_reference`), written to a
    file under `tmp`; returns the file."""
    t0 = time.perf_counter()
    model = init_weights(reference_model(kind, name), _gen(SEED)).eval()
    out = {"state": {k: v.detach().clone() for k, v in model.state_dict().items()}}
    if kind == "seg":
        path = PATHS[name]
        out["forward"] = logits_reference(path, model)
        out["grads"] = gradients_reference(path, model)
    elif kind == "det":
        path = {**DET_PATHS, **ROT_PATHS, **INST_PATHS}[name]
        out["forward"] = det_forward_reference(path, model)
        out["grads"] = det_gradients_reference(path, model) if path.gradients else None
    else:
        path = MTP_PATHS[name]
        out["forward"] = mtp_forward_reference(path, model)
        out["grads"] = mtp_gradients_reference(path, model)
    out["seconds"] = time.perf_counter() - t0
    file = os.path.join(tmp, f"{kind}_{name}.pt")
    torch.save(out, file + ".tmp")
    os.replace(file + ".tmp", file)
    return file


def _reference_worker(jobs, done, tmp: str) -> None:
    """The worker process: `cpu_reference` of each job from `jobs` in turn,
    (job, file, error) to `done`; None ends it."""
    torch.set_num_threads(REF_THREADS)
    with init_weights.constructions_undrawn():
        for job in iter(jobs.get, None):
            try:
                done.put((job, cpu_reference(*job, tmp), None))
            except Exception:  # noqa: BLE001 -- raised in the parent by `take`
                done.put((job, None, traceback.format_exc()))


class References:
    """The card-vs-CPU checks' CPU halves (the CPU model's draw, its fp32
    forward and backward, and what the CPU decides for both runs:
    proposals, max-pool picks, assigner IoUs and assignments), computed by
    one spawned worker process in the order the paths take them, REF_AHEAD
    paths ahead, beside this process's card work, but for the timed
    windows (`timed_window`), in which it is stopped; each result is a
    file that `take` reads and removes.  `close()` ends the worker."""

    running: ClassVar[Optional["References"]] = None  # the worker `timed_window` stops

    def __init__(self, jobs: List[Tuple[str, str]]):
        self._dir = tempfile.TemporaryDirectory(prefix="mtp_chip_smoke_refs_")
        ctx = torch.multiprocessing.get_context("spawn")
        self.jobs, self.done = ctx.Queue(), ctx.Queue()
        self.pending, self.arrived = list(jobs), {}
        self.proc = ctx.Process(target=_reference_worker,
                                args=(self.jobs, self.done, self._dir.name), daemon=True)
        self.proc.start()
        self.queued = 0
        self.stopped_at: Optional[float] = None
        self.stops, self.stopped_s = 0, 0.0
        References.running = self
        self._queue()

    def _signal(self, sig: int) -> None:
        with contextlib.suppress(ProcessLookupError):  # the worker has ended
            os.kill(self.proc.pid, sig)

    def stop(self) -> None:
        """Stops the worker (SIGSTOP) until `resume`."""
        self._signal(signal.SIGSTOP)
        self.stopped_at = time.perf_counter()

    def resume(self) -> None:
        self._signal(signal.SIGCONT)
        self.stops += 1
        self.stopped_s += time.perf_counter() - self.stopped_at
        self.stopped_at = None

    def _queue(self) -> None:
        while self.pending and self.queued < REF_AHEAD:
            self.jobs.put(self.pending.pop(0))
            self.queued += 1

    def take(self, kind: str, name: str) -> dict:
        """The path's reference: {"state": the drawn weights, "forward",
        "grads": its checks' CPU halves, "seconds"}."""
        t0 = time.perf_counter()
        while (kind, name) not in self.arrived:
            if not self.proc.is_alive() and self.done.empty():
                raise AssertionError(f"the reference worker ended (exit {self.proc.exitcode})")
            try:
                job, file, error = self.done.get(timeout=5.0)
            except queue.Empty:  # look at the worker again
                continue
            self.arrived[tuple(job)] = (file, error)
        file, error = self.arrived.pop((kind, name))
        self.queued -= 1
        self._queue()
        if error is not None:
            raise AssertionError(f"the CPU reference of {name} failed:\n{error}")
        waited = time.perf_counter() - t0
        ref = torch.load(file, weights_only=False)
        os.remove(file)
        log(f"[refs] {name}: the worker's CPU model and check halves ({ref['seconds']:.1f} s "
            f"in the worker, {REF_THREADS} threads, its stops included); this process waited "
            f"{waited:.1f} s for them, read them in {time.perf_counter() - t0 - waited:.1f} s")
        return ref

    def model(self, kind: str, name: str, ref: dict):
        """The path's CPU model with the worker's drawn weights."""
        model = reference_model(kind, name)
        model.load_state_dict(ref.pop("state"))
        return model.eval()

    def close(self) -> None:
        References.running = None
        log(f"[refs] the worker was stopped for {self.stops} timed windows, "
            f"{self.stopped_s:.1f} s in all")
        self.jobs.cancel_join_thread()  # jobs the killed worker never took
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join()
        self._dir.cleanup()


@contextlib.contextmanager
def phase_time(what: str):
    """Logs the wall time the block took."""
    t0 = time.perf_counter()
    yield
    log(f"[time] {what} {time.perf_counter() - t0:.1f} s")


def free(generation: int = 2) -> None:
    """Release what earlier phases left, so that each phase's peak memory
    is its own.  Between kernel cases, whose outputs no reference cycle
    holds, `generation` 1 collects only the young objects: a full
    collection walks this process's ~170,000 objects (~0.1 s a call on one
    x86 core after the imports), and phases 3-3f call this ~1,000 times."""
    gc.collect(generation)
    torch.cuda.empty_cache()


def run_path(path: Path, card: str, refs: References) -> dict:
    """Phases 4-7 (ViT), 8-11 (InternImage) or 12-15 (ViT at 2080²):
    {"serve": launches of one predict, "train": launches of one train
    step}."""
    free()
    crop = path.recipe.backbone.img_size
    with phase_time(f"{path.name} models"):
        ref = refs.take("seg", path.name)
        model_cpu = refs.model("seg", path.name, ref)
        # the ViT's pos_embed and full-attention tables are sized by the token
        # grid: a card-vs-CPU image of another shape needs a model of its own
        sized = not is_internimage(path.recipe.backbone) and path.cpu_hw != (crop, crop)
        model = build_model(path, (crop, crop)) if sized else model_cpu
    with phase_time(f"{path.name} logits"):
        phase_logits(path, model_cpu, ref["forward"])
    with phase_time(f"{path.name} serve"):
        served = phase_serving(path, model, card)
    del model
    free()
    # phase 25's ranks start beside phase 6's CPU-bound reference
    ranks = DdpRanks(path) if path.name == "rvsa" else None
    try:
        with phase_time(f"{path.name} gradients"):
            phase_gradients(path, model_cpu, ref.pop("grads"))
        del model_cpu, ref
        free()
        with phase_time(f"{path.name} train"):
            trained = phase_train(path, card, ranks)
    finally:
        if ranks is not None:
            ranks.close()
    return {"serve": served, "train": trained}


def main() -> None:
    start = time.perf_counter()
    card = phase_device()
    dump = phase_build()
    record = {}
    exports = refs = None
    seeded = mock.patch.object(_fit, "init_weights", init_weights)  # the tasks' draws too
    seeded.start()
    undrawn = init_weights.constructions_undrawn()
    undrawn.__enter__()
    try:
        refs = References(reference_jobs())  # beside phases 3-3f, then ahead of the paths
        for name, phase in (("3", phase_kernels), ("3b", phase_backward_kernels),
                            ("3c", phase_dcnv3_kernels), ("3d", phase_large_window_kernels),
                            ("3e", phase_nms_kernel), ("3g", phase_rotated_iou_kernel)):
            if name == "3c":  # phase 2's SASS, dumped beside phases 3 and 3b;
                check_sass(dump)  # phase 27's exports, beside phases 3c-3f
                exports = ExportJobs()
            with phase_time(f"kernels {name}"):
                record.update(phase())
        with phase_time("kernels 3f"):
            phase_800_kernels()
        with phase_time("kernels 3f, phases 21-23's shapes"):
            phase_path_kernels()
        with phase_time("kernels 3f, the XL paths' K8 shapes"):
            phase_xl_path_kernels()
        with phase_time("kernels 3c/3f, the OSCD 96² shapes"):
            phase_oscd_kernels()
        exports.check()
        runs = {}
        for name, path in PATHS.items():
            runs[name] = run_path(path, card, refs)  # phase 25 inside phase 7
        for name, path in TASK_PATHS.items():
            trained = run_task_path(path, card)
            if name == "cls_vit":  # phase 18 exports its encoder
                vit_cls_backbone = trained.backbone.cpu()
            del trained
        with phase_time("checkpoint"):
            phase_checkpoint(vit_cls_backbone, card)
        del vit_cls_backbone
        for name, path in {**DET_PATHS, **ROT_PATHS, **INST_PATHS}.items():
            runs[name] = run_det_path(path, card, refs)
        for name, path in MTP_PATHS.items():
            runs[name] = run_mtp_path(path, card, refs)
        with phase_time("cli"):
            runs["cli"] = phase_cli(card)
        with phase_time("export"):
            phase_export(card, exports)
    finally:
        undrawn.__exit__(None, None, None)
        seeded.stop()
        if refs is not None:
            refs.close()
        if dump[0].poll() is None:
            dump[0].kill()
            dump[0].wait()
        if exports is not None:
            exports.close()
    kernels = []
    for key, meta in KERNELS.items():
        path, kind, counter = LAUNCHED_IN[key]
        kernels.append(dict(meta, launches=runs[path][kind][counter], **record[key]))
    log(f"[time] total {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
