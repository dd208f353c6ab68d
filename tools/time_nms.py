#!/usr/bin/env python3
"""Device time of N1 (greedy NMS) and R1 (rotated IoU) at the main paths'
shapes on one NVIDIA GPU, for comparing two versions of the port on one card.

    python3 tools/time_nms.py [--root DIR] [--ptxas]

fp32, the inputs of `chip_smoke.py`'s phases 3e and 3g (made from their
seeds):
- N1 (`nms_keep` on boxes in score order: the mask kernel, then the scan)
  at the RPN's shape at 800² (B 2, N 8,382), 448² (B 1, N 6,735) and 1024²
  (B 2, N 8,768), and at the predicts' (B 2, 1,000 candidates after the
  class offset, 20, 80 and 60 classes); each keep mask held to
  `nms_keep_ref`'s first;
- R1's mask form (`nms_keep` on rotated boxes: R1's mask kernel, then N1's
  scan) at the rotated predict's shape (B 2, 2,000 candidates of 20
  classes after the class offset), and its dense form (`rbox_overlaps`) at
  the assigner's (100 padded gts × 1,100 proposals).
Each is timed as device time by `chip_smoke.graph_ms` (20 calls captured in
a CUDA graph and replayed), as back-to-back calls of the wrapper
(`chip_smoke.loop_ms`), and split by kernel (the mask kernel, the scan) from
torch.profiler's device times (`chip_smoke.kernel_split_ms`).  `--root DIR`
imports `mtp_tpu_torch` from DIR, a checkout of another commit (e.g. the
parent, unpacked with `git archive` into a gitignored directory), whose
kernels build into DIR's `_build/`: one call can then time both versions in
turns (parent, change, change, parent).  `--ptxas` builds the kernels anew
and prints ptxas's registers, stack frame and spills of the NMS and
rotated-IoU kernels.  Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
KERNELS = ("nms_mask_kernel", "nms_scan_kernel", "rbox_mask_kernel", "rbox_iou_dense_kernel")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def n1_cases(smoke) -> list:
    """(name, boxes, scores, labels or None, thr) of phase 3e's timed cases."""
    cases = []
    for hw, B, n, seed in ((800, 2, smoke.RPN_N, 70), (448, 1, smoke.RPN_N_448, 79),
                           (1024, 2, smoke.RPN_N_1024, 77)):
        boxes, scores, _ = smoke.clustered_boxes(B, n, (hw, hw), seed)
        cases.append((f"N1 rpn {hw}² {B}x{n}", boxes, scores, None, 0.7))
    for hw, classes, seed, label_seed in ((800, 20, 71, 72), (1024, 80, 78, 79),
                                          (416, 60, 80, 81)):
        boxes, scores, src = smoke.clustered_boxes(2, 1000, (hw, hw), seed, copies=10)
        labels = smoke.torch.randint(0, classes, (2, 1000),
                                     generator=smoke._gen(label_seed)).gather(1, src)
        cases.append((f"N1 predict {hw}² {classes} classes", boxes, scores, labels, 0.5))
    return cases


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=REPO,
                    help="the checkout whose mtp_tpu_torch is timed")
    ap.add_argument("--ptxas", action="store_true",
                    help="build anew and print the kernels' ptxas report")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("tools/time_nms.py: no CUDA device")
    # this checkout's chip_smoke (its inputs and timers) over root's package
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from mtp_tpu_torch.kernels import _build
    from mtp_tpu_torch.ops import nms as pnms
    from mtp_tpu_torch.ops import rotated_boxes as prb

    hw = card()
    tag = f"[nms {root.name}]"
    _build.build(force=args.ptxas)
    _build.lib()
    for line in _build.PTXAS_LOG:
        if any(k in line for k in KERNELS):
            print(f"{tag} ptxas {line} | {hw}", flush=True)

    runs = []
    for name, boxes, scores, labels, thr in n1_cases(smoke):
        bc = boxes.cuda() if labels is None else pnms.class_offset_boxes(boxes, labels).cuda()
        _, boxes_o, scores_o = pnms._score_order(bc, scores.cuda())
        boxes_o, scores_o = boxes_o.contiguous(), scores_o.contiguous()
        keep = pnms.nms_keep(boxes_o, scores_o, thr)
        if not torch.equal(keep, pnms.nms_keep_ref(boxes_o, scores_o > pnms.NEG_INF / 2, thr)):
            raise AssertionError(f"{name}: the keep mask differs from nms_keep_ref's")
        runs.append((name, "N1 mask",
                     lambda b=boxes_o, s=scores_o, t=thr: pnms.nms_keep(b, s, t)))

    boxes, scores, labels = smoke.rotated_scene(2, smoke.ROT_CAND // 10, 10, (800, 800), 82)
    _, boxes_o, scores_o = pnms._score_order(pnms.class_offset_boxes(boxes, labels).cuda(),
                                             scores.cuda())
    boxes_o, scores_o = boxes_o.contiguous(), scores_o.contiguous()
    runs.append((f"R1 mask predict 2x{smoke.ROT_CAND}", "R1 mask",
                 lambda: pnms.nms_keep(boxes_o, scores_o, smoke.ROT_THR)))
    gts, _, _ = smoke.rotated_scene(1, 12, 1, (800, 800), 80)
    gts = torch.cat([gts, torch.zeros(1, smoke.ASSIGN_GTS - 12, 5)], 1).cuda()
    props, _, _ = smoke.rotated_scene(1, 100, smoke.ASSIGN_PROPS // 100, (800, 800), 81)
    props = torch.cat([props.cuda(), gts], 1)
    runs.append((f"R1 dense assigner 1x{smoke.ASSIGN_GTS}x{props.shape[1]}", "R1 dense",
                 lambda: prb.rbox_overlaps(gts, props)))

    for name, group, fn in runs:
        graph = smoke.graph_ms(fn)
        loop = smoke.loop_ms(fn)
        split = smoke.kernel_split_ms(fn)
        parts = f"{group} {split.get(group, 0.0):.4f}"
        if group != "R1 dense":
            parts += f", scan {split.get('NMS scan (N1, R1)', 0.0):.4f}"
        print(f"{tag} {name:34s} device {graph:.4f} ms (CUDA graph), back-to-back "
              f"{loop:.4f} ms; by kernel (torch.profiler, ms a call): {parts} | {hw}",
              flush=True)


if __name__ == "__main__":
    main()
