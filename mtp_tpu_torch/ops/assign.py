"""Fixed-shape assigner and sampler of detection training (port of
`mtp_tpu/ops/assign.py`: mmdet `MaxIoUAssigner` / `RandomSampler`
semantics with static shapes).  Ground truths arrive zero-padded with a
validity mask; the sampler returns exactly `num` slots, a validity mask
marking the unfilled ones.  Every function takes leading batch dimensions,
and nothing leaves the device: counts stay tensors, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mtp_tpu_torch.ops.boxes import bbox_overlaps
from mtp_tpu_torch.parallel.mesh import global_rand


class AssignResult(NamedTuple):
    gt_inds: torch.Tensor   # (..., A) int: -1 ignore, 0 negative, >0 = gt index + 1
    max_ious: torch.Tensor  # (..., A) best IoU per anchor
    labels: torch.Tensor    # (..., A) class label of the assigned gt, or -1


class SampleResult(NamedTuple):
    inds: torch.Tensor      # (..., num) int64 indices into the anchor/proposal set
    is_pos: torch.Tensor    # (..., num) bool
    valid: torch.Tensor     # (..., num) bool, False for unfilled slots
    gt_inds: torch.Tensor   # (..., num) assigned gt index (0-based, clipped at 0)
    labels: torch.Tensor    # (..., num) class labels (positive slots only)


def assign_from_ious(ious: torch.Tensor, gt_valid: Optional[torch.Tensor],
                     gt_labels: Optional[torch.Tensor], pos_iou_thr: float,
                     neg_iou_thr: float, min_pos_iou: float,
                     match_low_quality: bool, neg_needs_nonneg: bool) -> AssignResult:
    """The MaxIoUAssigner core on an IoU matrix (..., G, A) whose padded
    gts are already 0 and invalid anchors -1.  `neg_needs_nonneg`: a
    negative needs 0 <= max IoU (`_assign_from_ious`), else an anchor whose
    max IoU is below 0 is re-marked ignore (`max_iou_assign`); `gt_valid`,
    when given, gates the low-quality matches.  Low-quality matches go to
    the last gt in index order that reaches its best IoU at the anchor."""
    G = ious.shape[-2]
    max_ious = ious.amax(dim=-2)
    argmax_gt = ious.argmax(dim=-2)
    minus1 = torch.full_like(argmax_gt, -1)
    if neg_needs_nonneg:
        gt_inds = torch.where((max_ious < neg_iou_thr) & (max_ious >= 0), 0, minus1)
    else:
        gt_inds = torch.where(max_ious < neg_iou_thr, 0, minus1)
        gt_inds = torch.where(max_ious < 0, -1, gt_inds)
    gt_inds = torch.where(max_ious >= pos_iou_thr, argmax_gt + 1, gt_inds)
    if match_low_quality:
        gt_max = ious.amax(dim=-1, keepdim=True)                    # (..., G, 1)
        is_best = (ious == gt_max) & (gt_max >= min_pos_iou) & (ious > 0)
        if gt_valid is not None:
            is_best &= gt_valid[..., None]
        ids = torch.arange(1, G + 1, dtype=torch.int32, device=ious.device)
        # the largest id reaching its best is the last such gt (mmdet's loop)
        winner = torch.where(is_best, ids[:, None], 0).amax(dim=-2).long()
        gt_inds = torch.where(winner > 0, winner, gt_inds)
    if gt_labels is not None:
        safe = (gt_inds - 1).clamp(0, G - 1)
        labels = torch.where(gt_inds > 0, gt_labels.long().gather(-1, safe), -1)
    else:
        labels = torch.full_like(gt_inds, -1)
    return AssignResult(gt_inds, max_ious, labels)


def max_iou_assign(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_valid: torch.Tensor,
                   gt_labels: Optional[torch.Tensor] = None,
                   pos_iou_thr: float = 0.7, neg_iou_thr: float = 0.3,
                   min_pos_iou: float = 0.3, match_low_quality: bool = True
                   ) -> AssignResult:
    """anchors (..., A, 4), gt_boxes (..., G, 4) zero-padded, gt_valid
    (..., G) bool.  Padded gt rows overlap nothing (a no-gt image yields all
    negatives)."""
    ious = bbox_overlaps(gt_boxes, anchors)                          # (..., G, A)
    ious = torch.where(gt_valid[..., None], ious, 0.0)
    return assign_from_ious(ious, gt_valid, gt_labels, pos_iou_thr, neg_iou_thr,
                            min_pos_iou, match_low_quality, neg_needs_nonneg=False)


def _uniform(shape, generator: torch.Generator, device,
             batch_axis: int = 0) -> torch.Tensor:
    """U[0, 1) of `shape` drawn on the generator's device, placed on
    `device`; under data parallel this rank's rows (on `batch_axis`) of the
    global batch's draw (`parallel.mesh.global_rand`)."""
    return global_rand(shape, generator, batch_axis).to(device)


def _rank(key: torch.Tensor) -> torch.Tensor:
    """Each element's place in the stable descending order of its row."""
    order = torch.argsort(-key, dim=-1, stable=True)
    ar = torch.arange(key.shape[-1], device=key.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ar)


def random_sample(assign: AssignResult, generator: torch.Generator, num: int,
                  pos_fraction: float) -> SampleResult:
    """Exactly `num` slots: up to int(num·pos_fraction) positives drawn at
    random without replacement, the rest random negatives (mmdet
    RandomSampler with neg_pos_ub = -1), packed positives first, then
    negatives, then invalid padding, for each row of the (B, A) assignment.
    The draws come from `generator`, so they are not JAX's bits; the rule
    and its invariants are the same."""
    gt_inds = assign.gt_inds
    A = gt_inds.shape[-1]
    if num > A:
        raise ValueError(f"cannot sample {num} slots from {A}")
    expected_pos = int(num * pos_fraction)
    pos_mask, neg_mask = gt_inds > 0, gt_inds == 0
    u = _uniform((3,) + tuple(gt_inds.shape), generator, gt_inds.device, batch_axis=1)
    pos_sel = pos_mask & (_rank(torch.where(pos_mask, u[0], -1.0)) < expected_pos)
    n_neg = num - pos_sel.sum(-1, keepdim=True)
    neg_sel = neg_mask & (_rank(torch.where(neg_mask, u[1], -1.0)) < n_neg)
    prio = torch.where(pos_sel, 2.0, torch.where(neg_sel, 1.0, 0.0))
    key = prio + torch.where(prio > 0, u[2] * 0.5, 0.0)
    inds = torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :num]
    take = lambda t: t.gather(-1, inds)
    return SampleResult(inds, take(pos_sel), take(pos_sel | neg_sel),
                        (take(gt_inds) - 1).clamp(min=0), take(assign.labels))
