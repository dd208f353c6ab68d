"""Fixed-shape greedy NMS of horizontal and rotated boxes (port of
`mtp_tpu/ops/nms.py` `nms`, `nms_batched` and `batched_nms`).

Semantics are JAX's: boxes are put in stable descending score order (equal
scores go to the lower index, `jnp.argsort(-scores)`); a box is valid when
its score is above NEG_INF / 2; in that order a kept box suppresses every
later box whose IoU with it (`bbox_overlaps` of x1y1x2y2 boxes,
`rbox_overlaps` of (cx, cy, w, h, θ) boxes) is strictly above `iou_thr`;
the kept boxes come out in score order, then padding (score NEG_INF, index
of the lowest-indexed box not kept), `max_out` in all.

On CPU tensors `nms_ref` runs: the blocked scan of `_nms_single_lane` in
PyTorch.  On CUDA tensors the wrapper launches a kernel, which raises on
what it cannot take and never falls back: N1 (csrc/nms.cu) for horizontal
boxes, R1's mask form (csrc/rotated_iou.cu) for rotated ones; both write
the suppression bitmask and run the same one-warp-per-image scan
(csrc/nms_scan.cuh).  The two halves have plain versions of their own,
`nms_mask_ref` (the bitmask, in the kernels' layout) and `nms_scan_ref`
(the keep mask from those words, in the scan's order), which together are
`nms_keep_ref`.  The sort and the top-`max_out` gather run in PyTorch on
either device.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from mtp_tpu_torch.kernels import _build
from mtp_tpu_torch.ops.boxes import bbox_overlaps
from mtp_tpu_torch.ops.rotated_boxes import rbox_overlaps_ref

NEG_INF = -1e10
# csrc/nms_scan.cuh, shared by N1 and R1: boxes per mask tile side (bits of
# a mask word) and the most boxes an image may hold (the scan keeps one
# removed bit per box in shared memory)
NMS_TILE = 64
NMS_MAX_BOXES = 1 << 16
# the later boxes a row's list holds (kListCap)
NMS_LIST_CAP = 32

LAUNCHES = {"nms": 0, "nms_rotated": 0}
# coordinates a box → (kernel, its launcher, its counter): N1 for x1y1x2y2
# boxes, R1's mask form for rotated ones
KEEP_KERNELS = {4: ("N1", "mtp_nms", "nms"), 5: ("R1", "mtp_nms_rotated", "nms_rotated")}


def _score_order(boxes: torch.Tensor, scores: torch.Tensor):
    """(order, boxes in that order, scores in that order), order the stable
    argsort of -scores along the box axis."""
    order = torch.argsort(-scores, dim=1, stable=True)
    boxes_o = boxes.gather(1, order[..., None].expand(-1, -1, boxes.shape[-1]))
    return order, boxes_o, scores.gather(1, order)


def _top(order: torch.Tensor, scores_o: torch.Tensor, keep_o: torch.Tensor,
         max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first `max_out` kept boxes in score order, then padding: a stable
    descending sort of the masked scores, which is `lax.top_k`'s order
    (ties to the lower index)."""
    if max_out > scores_o.shape[1]:
        raise ValueError(f"max_out {max_out} > {scores_o.shape[1]} boxes")
    kept = torch.where(keep_o, scores_o, NEG_INF)
    top, idx_o = torch.sort(kept, dim=1, descending=True, stable=True)
    return order.gather(1, idx_o[:, :max_out]).int(), top[:, :max_out]


def nms_keep_ref(boxes_o: torch.Tensor, valid: torch.Tensor, iou_thr: float,
                 block: int = 128) -> torch.Tensor:
    """The keep mask (B, N) of boxes (B, N, 4 or 5) already in score order:
    JAX's blocked scan.  Tiles of `block` boxes in order; within a tile the
    greedy rule row by row on the tile's (block, block) IoUs, then the
    tile's kept boxes suppress every later box at once.  Rotated boxes take
    the plain rotated IoU on either device."""
    B, n, D = boxes_o.shape
    iou = rbox_overlaps_ref if D == 5 else bbox_overlaps
    T = min(block, n)
    n_pad = (n + T - 1) // T * T
    if n_pad != n:
        boxes_o = torch.cat([boxes_o, boxes_o.new_zeros(B, n_pad - n, D)], 1)
        valid = torch.cat([valid, valid.new_zeros(B, n_pad - n)], 1)
    iota_T = torch.arange(T, device=boxes_o.device)
    iota_N = torch.arange(n_pad, device=boxes_o.device)
    later_in_tile = iota_T[None, :] > iota_T[:, None]             # [i, j]: j > i
    alive = valid.clone()
    for s in range(0, n_pad, T):
        rows = iou(boxes_o[:, s:s + T], boxes_o)                     # (B, T, N)
        sup = (rows[:, :, s:s + T] > iou_thr) & later_in_tile       # (B, T, T)
        a_blk = alive[:, s:s + T].clone()
        for i in range(T):
            a_blk &= ~(sup[:, i] & a_blk[:, i:i + 1])
        alive[:, s:s + T] = a_blk
        sup_later = ((rows > iou_thr) & a_blk[..., None]).any(1)     # (B, N)
        alive &= ~(sup_later & (iota_N >= s + T))
    return alive[:, :n] & valid[:, :n]


def nms_mask_ref(boxes_o: torch.Tensor, iou_thr: float, rows: int = 1024) -> torch.Tensor:
    """The suppression bitmask of boxes (B, N, 4 or 5) in score order, in the
    kernels' layout (csrc/nms_scan.cuh): (B, N, ⌈N/64⌉) int64 words, bit t
    of word w of row i set iff w·64 + t > i and IoU(i, w·64 + t) > iou_thr
    (`bbox_overlaps`, or `rbox_overlaps_ref` of rotated boxes); the words
    before a row's own tile, which the kernels neither write nor read, 0.
    `rows` rows of IoUs at a time."""
    B, N, D = boxes_o.shape
    iou = rbox_overlaps_ref if D == 5 else bbox_overlaps
    words = (N + NMS_TILE - 1) // NMS_TILE
    col = torch.arange(N, device=boxes_o.device)
    shifts = torch.arange(NMS_TILE, device=boxes_o.device)
    parts = []
    for r0 in range(0, N, rows):
        r1 = min(N, r0 + rows)
        over = (iou(boxes_o[:, r0:r1], boxes_o) > iou_thr) & (col > col[r0:r1, None])
        over = torch.cat([over, over.new_zeros(B, r1 - r0, words * NMS_TILE - N)], -1)
        # distinct powers of two add up to their OR; bit 63 is the sign
        parts.append((over.view(B, r1 - r0, words, NMS_TILE).long() << shifts).sum(-1))
    return torch.cat(parts, 1)


def nms_scan_ref(mask: torch.Tensor, scores_o: torch.Tensor) -> torch.Tensor:
    """The keep mask (B, N) bool from a suppression bitmask (B, N, ⌈N/64⌉)
    in the kernels' layout and the scores in score order (B, N), in
    csrc/nms_scan.cuh's order, on the host: tile by tile, the live rows
    (valid, score > NEG_INF / 2, and not removed) taken lowest first, each
    kept row removing the rows its diagonal word names; then the tile's
    kept rows' later words ORed into the removed bits of the later tiles
    (the kernel reads the same bits from the rows' lists).  Returned on
    `mask`'s device."""
    B, N, words = mask.shape
    m = mask.cpu().numpy().view(np.uint64)
    valid = (scores_o > NEG_INF / 2).cpu().numpy()
    keep = np.zeros((B, N), dtype=bool)
    for b in range(B):
        removed = np.zeros(words, dtype=np.uint64)
        for w in range(words):
            r0 = w * NMS_TILE
            rows = range(r0, min(N, r0 + NMS_TILE))
            live = sum(1 << (i - r0) for i in rows if valid[b, i]) & ~int(removed[w])
            kept = []
            while live:
                r = (live & -live).bit_length() - 1
                kept.append(r0 + r)
                live &= live - 1
                live &= ~int(m[b, r0 + r, w])
            keep[b, kept] = True
            if kept and w + 1 < words:
                removed[w + 1:] |= np.bitwise_or.reduce(m[b, kept, w + 1:], axis=0)
    return torch.from_numpy(keep).to(mask.device)


def nms_ref(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float,
            max_out: int, block: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of `nms_batched`: boxes (B, N, 4 or 5), scores
    (B, N) → (idx (B, max_out) int32, scores (B, max_out))."""
    order, boxes_o, scores_o = _score_order(boxes, scores)
    keep_o = nms_keep_ref(boxes_o, scores_o > NEG_INF / 2, iou_thr, block)
    return _top(order, scores_o, keep_o, max_out)


def keep_scratch(B: int, N: int, device) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """(scratch, lists_at, keep) of a launch of N1 or R1's mask form: one
    int64 allocation that holds the suppression words (B, N, ⌈N/64⌉) from
    its start and, from element `lists_at` (16-byte aligned, for the scan's
    cp.async), the scan's int32 lists of later boxes and their counts
    (csrc/nms_scan.cuh: NMS_LIST_CAP + 1 ints a box, the tiles' rows rounded
    up to 64); and the keep mask (B, N) bool."""
    words = (N + NMS_TILE - 1) // NMS_TILE
    n_mask = B * N * words
    lists_at = n_mask + n_mask % 2
    n_lists = B * words * NMS_TILE * (NMS_LIST_CAP + 1) // 2
    return (torch.empty(lists_at + n_lists, dtype=torch.int64, device=device), lists_at,
            torch.empty(B, N, dtype=torch.bool, device=device))


def nms_keep(boxes_o: torch.Tensor, scores_o: torch.Tensor,
             iou_thr: float) -> torch.Tensor:
    """The greedy keep mask (B, N) of fp32 boxes (B, N, 4 or 5) in score
    order with their scores (B, N), on the card: N1 (x1y1x2y2 boxes) or R1's
    mask form (rotated) writes the suppression bitmask (the layout of
    `nms_mask_ref`), bit (i, j) set iff j > i and IoU(i, j) > iou_thr, and
    N1's scan reads it (as `nms_scan_ref` does)."""
    B, N, D = boxes_o.shape
    kernel, launcher, counter = KEEP_KERNELS[D]
    _build.check_on_card(kernel, boxes_o, scores_o)
    if not 0 < N <= NMS_MAX_BOXES or not 0 < B <= 65535:
        raise ValueError(f"{kernel} takes 1 to {NMS_MAX_BOXES} boxes an image and 1 to "
                         f"65,535 images, got B {B}, N {N}")
    _build.check_launchable(boxes=boxes_o, scores=scores_o)
    if D == 4:  # N1 reads a box as one float4
        _build.check_aligned(boxes=boxes_o)
    scratch, lists_at, keep = keep_scratch(B, N, boxes_o.device)
    at = scratch.data_ptr()
    _build.launch(launcher, boxes_o.data_ptr(), scores_o.data_ptr(), at, at + 8 * lists_at,
                  keep.data_ptr(), B, N, float(iou_thr), _build.dtype_code(boxes_o))
    LAUNCHES[counter] += 1
    return keep


def check_keep_inputs(boxes_o: torch.Tensor, scores_o: torch.Tensor) -> None:
    """The keep mask takes boxes (B, N, 4 or 5) and their scores (B, N)."""
    if boxes_o.dim() != 3 or boxes_o.shape[-1] not in (4, 5) or \
            tuple(scores_o.shape) != tuple(boxes_o.shape[:2]):
        raise ValueError(f"boxes (B, N, 4 or 5) and scores (B, N) expected, got "
                         f"{tuple(boxes_o.shape)} and {tuple(scores_o.shape)}")


def keep_mask(boxes_o: torch.Tensor, scores_o: torch.Tensor, iou_thr: float) -> torch.Tensor:
    """The greedy keep mask (B, N) of boxes (B, N, 4 or 5) in score order
    with their scores (B, N), the body of the op mtp::nms_keep: CPU tensors
    run `nms_keep_ref`, CUDA tensors `nms_keep` (N1, or R1's mask form with
    N1's scan)."""
    check_keep_inputs(boxes_o, scores_o)
    if not _build.use_kernel(boxes_o, scores_o):
        return nms_keep_ref(boxes_o, scores_o > NEG_INF / 2, iou_thr)
    return nms_keep(boxes_o, scores_o, iou_thr)


def nms_batched(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float,
                max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched fixed-shape NMS: boxes (B, N, 4) x1y1x2y2 or (B, N, 5)
    rotated, scores (B, N) → (idx (B, max_out) int32 into the input, scores
    (B, max_out)).  The keep mask is the op mtp::nms_keep (`keep_mask`):
    on CPU tensors `nms_ref`'s, on CUDA tensors kernel N1 (horizontal) or
    R1's mask form with N1's scan (rotated)."""
    if boxes.shape[-1] not in (4, 5):
        raise ValueError(f"boxes of 4 or 5 coordinates, got {boxes.shape[-1]}")
    order, boxes_o, scores_o = _score_order(boxes, scores)
    keep_o = torch.ops.mtp.nms_keep.default(boxes_o.contiguous(), scores_o.contiguous(),
                                            iou_thr)
    return _top(order, scores_o, keep_o, max_out)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float,
        max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`nms_batched` on (N, D)/(N,) or (B, N, D)/(B, N) inputs."""
    if boxes.dim() == 2:
        idx, s = nms_batched(boxes[None], scores[None], iou_thr, max_out)
        return idx[0], s[0]
    return nms_batched(boxes, scores, iou_thr, max_out)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, idxs: torch.Tensor,
                iou_thr: float, max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Category-aware NMS by the coordinate-offset trick (mmcv batched_nms):
    every box moves by idx · extent (`class_offset_boxes`), so boxes of
    different classes never overlap.  (N, D)/(N,) or (B, N, D)/(B, N)
    inputs, D 4 or 5."""
    return nms(class_offset_boxes(boxes, idxs), scores, iou_thr, max_out)


def class_offset_boxes(boxes: torch.Tensor, idxs: torch.Tensor) -> torch.Tensor:
    """`batched_nms`' shifted boxes, with one extent over all the boxes:
    x1y1x2y2 boxes move all 4 coordinates by idx · (2·max|coord| + 1);
    rotated boxes move their centres only, by idx · (2·max|cx, cy| +
    √2·max|w, h| + 1): the centres span ±max|cx, cy| and a box reaches at
    most √2·max(w, h)/2 past its centre, on either of two neighbouring
    classes."""
    if boxes.shape[-1] == 4:
        extent = boxes.abs().max() * 2.0 + 1.0
        return boxes + idxs.to(boxes.dtype)[..., None] * extent
    extent = (boxes[..., :2].abs().max() * 2.0
              + math.sqrt(2.0) * boxes[..., 2:4].abs().max() + 1.0)
    off = idxs.to(boxes.dtype)[..., None] * extent
    return torch.cat([boxes[..., :2] + off, boxes[..., 2:]], -1)
