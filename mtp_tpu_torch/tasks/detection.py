"""Fixed-shape training loss and padded prediction of two-stage detection,
horizontal (Faster R-CNN, Mask R-CNN) and rotated (Oriented R-CNN) (port of
`mtp_tpu/tasks/detection.py` `anchors_for`, `anchor_level_sizes`,
`Detections`, `mask_targets_from_crops`, `_assign_from_ious`,
`det_loss_core` and `det_predict_core`, for one batch; the concatenated
multi-dataset form is decided with the multitask slice).

batch dict: image (B, H, W, 3); gt_boxes (B, G, 4) x1y1x2y2, or (B, G, 5)
(cx, cy, w, h, θ) le90 when rotated; gt_labels (B, G) int; gt_valid (B, G)
bool; with a mask head also gt_mask_crops (B, G, 56, 56), each gt's
binary mask resampled over its own box (the loader's default), or gt_masks
(B, G, H/4, W/4), the masks at stride 4 (the legacy mode).  Every list of
the reference flow is a padded tensor with a mask, and nothing leaves the
device during a step.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mtp_tpu_torch.heads.roi_heads import bbox_head_loss, mask_head_loss
from mtp_tpu_torch.heads.rpn import RPNOut, gen_proposals, rpn_loss
from mtp_tpu_torch.models.detector import DetConfig
from mtp_tpu_torch.ops.anchors import AnchorGenerator
from mtp_tpu_torch.ops.assign import (AssignResult, assign_from_ious,
                                      max_iou_assign, random_sample)
from mtp_tpu_torch.ops.boxes import bbox_overlaps, delta_decode, delta_encode
from mtp_tpu_torch.ops.grid_sample import grid_sample
from mtp_tpu_torch.ops.nms import NEG_INF, batched_nms
from mtp_tpu_torch.ops.precision import at_least_fp32
from mtp_tpu_torch.ops.roi_align import multilevel_roi_align_fused
from mtp_tpu_torch.ops.rotated_boxes import (delta_decode_rbox, delta_encode_rbox,
                                             midpoint_encode, rbox_overlaps,
                                             rbox_to_hbox)

FPN_STRIDES = (4, 8, 16, 32, 64)
# box_fn(flat_rois (R, 4 or 5), batch_idx (R,)) → (cls logits, deltas)
BoxFn = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
# mask_fn(flat_rois, batch_idx) → mask logits (R, num_classes, m, m)
MaskFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def anchors_for(det: Optional[DetConfig], img_hw: Tuple[int, int]) -> np.ndarray:
    """The RPN's anchors on the 5-level FPN of an img_hw image (det unused,
    as in JAX)."""
    gen = AnchorGenerator(strides=FPN_STRIDES)
    return gen.grid_flat([((img_hw[0] + s - 1) // s, (img_hw[1] + s - 1) // s)
                          for s in FPN_STRIDES])


def anchor_level_sizes(img_hw: Tuple[int, int]) -> Tuple[int, ...]:
    """Each level's flat anchor count on the same grid."""
    num_base = AnchorGenerator(strides=FPN_STRIDES).num_base
    return tuple(((img_hw[0] + s - 1) // s) * ((img_hw[1] + s - 1) // s) * num_base
                 for s in FPN_STRIDES)


class Detections(NamedTuple):
    boxes: torch.Tensor   # (B, N, 4 or 5)
    scores: torch.Tensor  # (B, N)
    labels: torch.Tensor  # (B, N)
    valid: torch.Tensor   # (B, N)
    mask_logits: Optional[torch.Tensor] = None  # (B, N, m, m), each box's class


def mask_targets_from_crops(crops: torch.Tensor, gt_boxes: torch.Tensor,
                            flat_rois: torch.Tensor, flat_gt: torch.Tensor,
                            m: int) -> torch.Tensor:
    """(N, m, m) mask targets, each RoI's from its gt's box-aligned crop:
    crops (B, G, C, C); gt_boxes (B, G, 4); flat_rois (N, 4) in image
    coordinates; flat_gt (N,) the gt's index b·G + g.  The m² bin centres
    of the RoI, put in the gt box's [-1, 1] frame, sample the crop
    bilinearly (align_corners=False, zero padding: an instance's mask is 0
    outside its own box)."""
    B, G, C, _ = crops.shape
    N = flat_rois.shape[0]
    src = at_least_fp32(crops).reshape(B * G, C, C, 1)[flat_gt]
    x1, y1, x2, y2 = gt_boxes.reshape(B * G, 4)[flat_gt].unbind(-1)
    t = (torch.arange(m, dtype=torch.float32, device=crops.device) + 0.5) / m
    sx = flat_rois[:, 0:1] + t[None, :] * (flat_rois[:, 2:3] - flat_rois[:, 0:1])
    sy = flat_rois[:, 1:2] + t[None, :] * (flat_rois[:, 3:4] - flat_rois[:, 1:2])
    gx = 2.0 * (sx - x1[:, None]) / (x2 - x1).clamp(min=1e-6)[:, None] - 1.0
    gy = 2.0 * (sy - y1[:, None]) / (y2 - y1).clamp(min=1e-6)[:, None] - 1.0
    grid = torch.stack([gx[:, None, :].expand(N, m, m), gy[:, :, None].expand(N, m, m)], -1)
    return grid_sample(src, grid, align_corners=False, padding_mode="zeros")[..., 0]


def _assign_from_ious(ious: torch.Tensor, gt_labels: torch.Tensor, pos_thr: float,
                      neg_thr: float, min_pos_iou: float,
                      match_low_quality: bool) -> AssignResult:
    """MaxIoUAssigner on a precomputed (..., G, P) IoU matrix whose invalid
    entries are already -1."""
    return assign_from_ious(ious, None, gt_labels, pos_thr, neg_thr, min_pos_iou,
                            match_low_quality, neg_needs_nonneg=True)


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (B, N, D)[b, idx[b]] → (B, K, D)."""
    return t.gather(1, idx[..., None].expand(-1, -1, t.shape[-1]))


def det_loss_core(det: DetConfig, anchors, img_hw: Tuple[int, int],
                  rpn_out: RPNOut, box_fn: BoxFn, batch: Dict[str, torch.Tensor],
                  generator: torch.Generator, mask_fn: Optional[MaskFn] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The detection training loss from the RPN's outputs and the box head
    `box_fn`: (total, {loss_rpn_cls, loss_rpn_bbox, loss_cls, loss_bbox,
    acc}, and loss_mask with a mask head).  The RPN losses are per image,
    then averaged; proposals carry no gradient; the gts join the proposals
    (add_gt_as_proposals); the R-CNN samples min(rcnn_num, proposals + gts)
    RoIs an image.  `anchors` (A, 4), numpy or a tensor; the samplers draw
    from `generator`.  Rotated: the RPN is assigned on the gts' bounding
    boxes and regresses the midpoint coder's 6 deltas; the R-CNN assigns by
    rotated IoU and regresses DeltaXYWHT's 5.  The mask head (`mask_fn`,
    when `det.with_mask`) runs on each image's first max(1, int(R ·
    rcnn_pos_fraction)) samples, which hold every positive (the sampler
    packs them first): targets from `gt_mask_crops` (horizontal) or by
    RoIAlign of `gt_masks` at scale 1/4."""
    H, W = img_hw
    scores = rpn_out.cls_scores
    B, dev = scores.shape[0], scores.device
    A = torch.as_tensor(anchors, dtype=torch.float32, device=dev)
    gt_boxes, gt_valid = at_least_fp32(batch["gt_boxes"]), batch["gt_valid"].bool()
    gt_labels = batch["gt_labels"].long()

    # ---------------- RPN ----------------
    gt_hbox = rbox_to_hbox(gt_boxes) if det.rotated else gt_boxes
    assign = max_iou_assign(A, gt_hbox, gt_valid, None, det.rpn_pos_iou,
                            det.rpn_neg_iou, det.rpn_min_pos_iou, True)
    sample = random_sample(assign, generator, det.rpn_num, det.rpn_pos_fraction)
    encode = midpoint_encode if det.rotated else delta_encode
    tgt = encode(A[sample.inds], _take(gt_boxes, sample.gt_inds))
    metrics = {k: v.mean() for k, v in rpn_loss(rpn_out, sample, tgt,
                                                det.rpn_smooth_l1_beta).items()}

    # ---------------- proposals (no gradient) ----------------
    props, prop_scores = gen_proposals(
        RPNOut(*(t.detach() for t in rpn_out)), A, (H, W), det.nms_pre,
        det.max_proposals, det.rpn_nms_iou, det.rotated,
        level_sizes=anchor_level_sizes((H, W)))
    props_all = torch.cat([props, gt_boxes], 1)
    prop_valid = torch.cat([prop_scores > NEG_INF / 2, gt_valid], 1)

    # ---------------- R-CNN assign / sample ----------------
    R = min(det.rcnn_num, props_all.shape[1])
    overlaps = rbox_overlaps if det.rotated else bbox_overlaps
    ious = overlaps(gt_boxes, props_all)                             # (B, G, P)
    ious = torch.where(gt_valid[..., None], ious, 0.0)
    ious = torch.where(prop_valid[:, None, :], ious, -1.0)
    assign = _assign_from_ious(ious, gt_labels, det.rcnn_pos_iou, det.rcnn_neg_iou,
                               det.rcnn_pos_iou, det.rcnn_match_low_quality)
    sample = random_sample(assign, generator, R, det.rcnn_pos_fraction)
    rois = _take(props_all, sample.inds)
    encode = delta_encode_rbox if det.rotated else delta_encode
    tgt = encode(rois, _take(gt_boxes, sample.gt_inds), stds=det.bbox_stds)

    flat = lambda t: t.reshape(B * R, *t.shape[2:])
    batch_idx = torch.arange(B, device=dev).repeat_interleave(R)
    cls_logits, reg_pred = box_fn(flat(rois), batch_idx)
    metrics.update(bbox_head_loss(
        cls_logits, reg_pred, type(sample)(*map(flat, sample)), flat(tgt),
        det.num_classes, det.reg_class_agnostic, det.rcnn_smooth_l1_beta))

    if det.with_mask and mask_fn is not None:
        P_m = max(1, int(R * det.rcnn_pos_fraction))
        m_sample = type(sample)(*(t[:, :P_m].reshape(B * P_m) for t in sample))
        m_rois = rois[:, :P_m].reshape(B * P_m, rois.shape[-1])
        m_bidx = torch.arange(B, device=dev).repeat_interleave(P_m)
        mask_logits = mask_fn(m_rois, m_bidx)
        G = gt_boxes.shape[1]
        flat_gt = m_sample.gt_inds + m_bidx * G
        if not det.rotated and "gt_mask_crops" in batch:
            tgt = mask_targets_from_crops(batch["gt_mask_crops"], gt_boxes, m_rois,
                                          flat_gt, det.mask_size)
        else:
            # JAX's single-level roi_align (rotated: clockwise) at scale 1/4
            gm = at_least_fp32(batch["gt_masks"])
            imgs = gm.reshape(B * G, 1, gm.shape[2], gm.shape[3])
            tgt = multilevel_roi_align_fused([imgs], m_rois, flat_gt, det.mask_size, (4,),
                                             rotated=det.rotated)[:, 0]
        metrics.update(mask_head_loss(mask_logits, tgt, m_sample))
    total = sum(v for k, v in metrics.items() if k.startswith("loss"))
    return total, metrics


def det_predict_core(det: DetConfig, anchors, img_hw: Tuple[int, int], B: int,
                     rpn_out: RPNOut, box_fn: BoxFn,
                     mask_fn: Optional[MaskFn] = None) -> Detections:
    """Detections (B, max_per_img) from the RPN's outputs and the box head:
    proposals, class probabilities (softmax, background dropped), each
    class's decoded box, scores at or under `score_thr` (and invalid
    proposals) set to NEG_INF, the top min(10·max_per_img, P·C) candidates,
    then class-aware NMS (rotated IoU when rotated).  With a mask head, the
    mask logits of each detection's class on its box."""
    H, W = img_hw
    dev = rpn_out.cls_scores.device
    A = torch.as_tensor(anchors, dtype=torch.float32, device=dev)
    props, prop_scores = gen_proposals(rpn_out, A, (H, W), det.nms_pre,
                                       det.max_proposals, det.rpn_nms_iou, det.rotated,
                                       level_sizes=anchor_level_sizes((H, W)))
    P, C, D = props.shape[1], det.num_classes, props.shape[-1]
    batch_idx = torch.arange(B, device=dev).repeat_interleave(P)
    cls_logits, reg_pred = box_fn(props.reshape(B * P, D), batch_idx)
    probs = F.softmax(cls_logits, -1)[:, :C].reshape(B, P, C)
    if det.reg_class_agnostic:
        reg = reg_pred.reshape(B, P, 1, D).expand(B, P, C, D)
    else:
        reg = reg_pred.reshape(B, P, C, D)
    ncand = min(det.max_per_img * 10, P * C)
    rois = props[:, :, None, :].expand(B, P, C, D)
    if det.rotated:
        boxes = delta_decode_rbox(rois, reg, stds=det.bbox_stds)
    else:
        boxes = delta_decode(rois, reg, stds=det.bbox_stds, max_shape=(H, W))
    boxes = boxes.reshape(B, P * C, D)
    pv = (prop_scores > NEG_INF / 2)[:, :, None]
    flat_scores = torch.where((probs > det.score_thr) & pv, probs,
                              NEG_INF).reshape(B, P * C)
    flat_labels = torch.arange(C, device=dev).repeat(P)
    top_s, top_i = torch.sort(flat_scores, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :ncand], top_i[:, :ncand]
    cand_b, cand_l = _take(boxes, top_i), flat_labels[top_i]
    keep_i, scores = batched_nms(cand_b, top_s, cand_l, det.test_nms_iou,
                                 det.max_per_img)
    keep_i = keep_i.long()
    boxes, labels = _take(cand_b, keep_i), cand_l.gather(1, keep_i)
    mask_logits = None
    if det.with_mask and mask_fn is not None:
        N = boxes.shape[1]
        ml = mask_fn(boxes.reshape(B * N, D),
                     torch.arange(B, device=dev).repeat_interleave(N))
        ml = ml[torch.arange(B * N, device=dev), labels.reshape(B * N).clamp(0, C - 1)]
        mask_logits = ml.reshape(B, N, *ml.shape[1:])
    return Detections(boxes, scores, labels, scores > NEG_INF / 2, mask_logits)
