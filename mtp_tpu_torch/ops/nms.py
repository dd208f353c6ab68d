"""Fixed-shape greedy NMS of horizontal boxes (port of `mtp_tpu/ops/nms.py`
`nms`, `nms_batched` and `batched_nms`; rotated boxes follow with slice 3b).

Semantics are JAX's: boxes are put in stable descending score order (equal
scores go to the lower index, `jnp.argsort(-scores)`); a box is valid when
its score is above NEG_INF / 2; in that order a kept box suppresses every
later box whose IoU with it (`bbox_overlaps`) is strictly above `iou_thr`;
the kept boxes come out in score order, then padding (score NEG_INF, index
of the lowest-indexed box not kept), `max_out` in all.

On CPU tensors `nms_ref` runs: the blocked scan of `_nms_single_lane` in
PyTorch.  On CUDA tensors the wrapper launches kernel N1 (csrc/nms.cu: the
suppression bitmask, then a one-block-per-image scan), which raises on what
it cannot take and never falls back.  The sort and the top-`max_out`
gather run in PyTorch on either device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mtp_tpu_torch.kernels import _build
from mtp_tpu_torch.ops.boxes import bbox_overlaps

NEG_INF = -1e10
# csrc/nms.cu: boxes per tile side (bits of a mask word) and the most boxes
# an image may hold (the scan keeps one bit per box in shared memory)
NMS_TILE = 64
NMS_MAX_BOXES = 1 << 16

LAUNCHES = {"nms": 0}


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
    """The keep mask (B, N) of boxes already in score order: JAX's blocked
    scan.  Tiles of `block` boxes in order; within a tile the greedy rule
    row by row on the tile's (block, block) IoUs, then the tile's kept boxes
    suppress every later box at once."""
    B, n, _ = boxes_o.shape
    T = min(block, n)
    n_pad = (n + T - 1) // T * T
    if n_pad != n:
        boxes_o = torch.cat([boxes_o, boxes_o.new_zeros(B, n_pad - n, 4)], 1)
        valid = torch.cat([valid, valid.new_zeros(B, n_pad - n)], 1)
    iota_T = torch.arange(T, device=boxes_o.device)
    iota_N = torch.arange(n_pad, device=boxes_o.device)
    later_in_tile = iota_T[None, :] > iota_T[:, None]             # [i, j]: j > i
    alive = valid.clone()
    for s in range(0, n_pad, T):
        rows = bbox_overlaps(boxes_o[:, s:s + T], boxes_o)           # (B, T, N)
        sup = (rows[:, :, s:s + T] > iou_thr) & later_in_tile       # (B, T, T)
        a_blk = alive[:, s:s + T].clone()
        for i in range(T):
            a_blk &= ~(sup[:, i] & a_blk[:, i:i + 1])
        alive[:, s:s + T] = a_blk
        sup_later = ((rows > iou_thr) & a_blk[..., None]).any(1)     # (B, N)
        alive &= ~(sup_later & (iota_N >= s + T))
    return alive[:, :n] & valid[:, :n]


def nms_ref(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float,
            max_out: int, block: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of `nms_batched`: boxes (B, N, 4), scores (B, N) →
    (idx (B, max_out) int32, scores (B, max_out))."""
    order, boxes_o, scores_o = _score_order(boxes, scores)
    keep_o = nms_keep_ref(boxes_o, scores_o > NEG_INF / 2, iou_thr, block)
    return _top(order, scores_o, keep_o, max_out)


def nms_keep(boxes_o: torch.Tensor, scores_o: torch.Tensor,
             iou_thr: float) -> torch.Tensor:
    """Kernel N1: the keep mask (B, N) of fp32 boxes (B, N, 4) in score
    order with their scores (B, N), on the card."""
    B, N, _ = boxes_o.shape
    if boxes_o.device.type != "cuda" or scores_o.device != boxes_o.device:
        raise ValueError(f"N1 runs on one CUDA device, got {boxes_o.device}, "
                         f"{scores_o.device}")
    if boxes_o.dtype != torch.float32 or scores_o.dtype != torch.float32:
        raise TypeError(f"N1 takes fp32 boxes and scores, got {boxes_o.dtype}, "
                        f"{scores_o.dtype}")
    if not 0 < N <= NMS_MAX_BOXES:
        raise ValueError(f"N1 takes 1 to {NMS_MAX_BOXES} boxes an image, got {N}")
    _build.check_launchable(boxes=boxes_o, scores=scores_o)
    _build.check_aligned(boxes=boxes_o)
    words = (N + NMS_TILE - 1) // NMS_TILE
    mask = torch.empty(B, N, words, dtype=torch.int64, device=boxes_o.device)
    keep = torch.empty(B, N, dtype=torch.bool, device=boxes_o.device)
    _build.launch("mtp_nms", boxes_o.data_ptr(), scores_o.data_ptr(), mask.data_ptr(),
                  keep.data_ptr(), B, N, float(iou_thr), _build.dtype_code(boxes_o))
    LAUNCHES["nms"] += 1
    return keep


def nms_batched(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float,
                max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched fixed-shape NMS: boxes (B, N, 4), scores (B, N) →
    (idx (B, max_out) int32 into the input, scores (B, max_out)).  CPU
    tensors run `nms_ref`; CUDA tensors kernel N1."""
    if boxes.shape[-1] != 4:
        raise NotImplementedError("rotated NMS is slice 3b")
    if not _build.use_kernel(boxes, scores):
        return nms_ref(boxes, scores, iou_thr, max_out)
    order, boxes_o, scores_o = _score_order(boxes, scores)
    return _top(order, scores_o, nms_keep(boxes_o.contiguous(), scores_o.contiguous(),
                                          iou_thr), max_out)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float,
        max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`nms_batched` on (N, 4)/(N,) or (B, N, 4)/(B, N) inputs."""
    if boxes.dim() == 2:
        idx, s = nms_batched(boxes[None], scores[None], iou_thr, max_out)
        return idx[0], s[0]
    return nms_batched(boxes, scores, iou_thr, max_out)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, idxs: torch.Tensor,
                iou_thr: float, max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Category-aware NMS by the coordinate-offset trick (mmcv batched_nms):
    every box moves by idx · extent, extent = 2·max|coord| + 1 over all the
    boxes, so boxes of different classes never overlap.  (N, 4)/(N,) or
    (B, N, 4)/(B, N) inputs."""
    return nms(class_offset_boxes(boxes, idxs), scores, iou_thr, max_out)


def class_offset_boxes(boxes: torch.Tensor, idxs: torch.Tensor) -> torch.Tensor:
    """`batched_nms`' shifted boxes: boxes + idx · (2·max|coord| + 1)."""
    if boxes.shape[-1] != 4:
        raise NotImplementedError("rotated NMS is slice 3b")
    extent = boxes.abs().max() * 2.0 + 1.0
    return boxes + idxs.to(boxes.dtype)[..., None] * extent
