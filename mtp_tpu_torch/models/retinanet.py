"""RetinaNet, the single-stage detector of the xView recipes (port of
`mtp_tpu/models/retinanet.py` `retina_anchors`, `RetinaNet`, `focal_loss`,
`retinanet_loss` and `retinanet_predict`; `RetinaConfig` is the copy in
`mtp_tpu_torch/config.py`).

backbone (4 NHWC levels) → FPN from level 1 with two extra convolutions on
the backbone's last level (strides 8-128) → RetinaHead: 4 stacked 3×3
convolutions with ReLU for classes and for boxes, shared over the levels,
then `retina_cls` (A·K logits a place, fp32, bias −log 99: prior 0.01)
and `retina_reg` (A·4 deltas, fp32).  The loss runs over every anchor
with validity masks (no sampling); the predict pads to `max_per_img`.
State-dict prefixes are mmdet's: `backbone.`, `neck.`,
`bbox_head.cls_convs.{i}.conv`, `bbox_head.reg_convs.{i}.conv`,
`bbox_head.retina_cls`, `bbox_head.retina_reg`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mtp_tpu_torch.config import RetinaConfig
from mtp_tpu_torch.heads.fpn import FPN, ConvBlock
from mtp_tpu_torch.heads.rpn import _stable_topk, fp32, optax_sigmoid_ce
from mtp_tpu_torch.models.backbones import build_backbone
from mtp_tpu_torch.models.vit_rvsa import ViTRVSA
from mtp_tpu_torch.ops.anchors import AnchorGenerator
from mtp_tpu_torch.ops.assign import max_iou_assign
from mtp_tpu_torch.ops.boxes import delta_decode, delta_encode
from mtp_tpu_torch.ops.nms import NEG_INF, batched_nms
from mtp_tpu_torch.ops.precision import at_least_fp32
from mtp_tpu_torch.tasks.detection import Detections, _take

__all__ = ["RetinaConfig", "retina_anchors", "RetinaNet", "focal_loss",
           "retinanet_loss", "retinanet_predict"]

PRIOR_PROB = 0.01


def retina_anchors(cfg: RetinaConfig, img_hw: Tuple[int, int]) -> np.ndarray:
    """(A_total, 4) anchors, level, y, x, anchor order: octave_base_scale ·
    2^(i / scales_per_octave) for each of the ratios, on ceil(H / s) ×
    ceil(W / s) grids."""
    scales = tuple(cfg.octave_base_scale * 2 ** (i / cfg.scales_per_octave)
                   for i in range(cfg.scales_per_octave))
    gen = AnchorGenerator(strides=cfg.strides, scales=scales, ratios=cfg.ratios)
    return gen.grid_flat([((img_hw[0] + s - 1) // s, (img_hw[1] + s - 1) // s)
                          for s in cfg.strides])


class RetinaHead(nn.Module):
    """The stacked convolutions and the final classifier and regressor,
    shared over the levels."""

    def __init__(self, cfg: RetinaConfig, in_channels: int):
        super().__init__()
        A, C = len(cfg.ratios) * cfg.scales_per_octave, cfg.feat_channels
        self.num_classes = cfg.num_classes
        self.cls_convs = nn.ModuleList(ConvBlock(in_channels if i == 0 else C, C, 3)
                                       for i in range(cfg.stacked_convs))
        self.reg_convs = nn.ModuleList(ConvBlock(in_channels if i == 0 else C, C, 3)
                                       for i in range(cfg.stacked_convs))
        self.retina_cls = nn.Conv2d(C, A * cfg.num_classes, 3, padding=1)
        self.retina_reg = nn.Conv2d(C, A * 4, 3, padding=1)
        # `init_weights` zeroes every bias, then sets this one
        self.retina_cls.bias_prior = -math.log((1 - PRIOR_PROB) / PRIOR_PROB)

    def forward(self, feats) -> Tuple[torch.Tensor, torch.Tensor]:
        """NCHW levels → (cls logits (B, A_total, K), deltas (B, A_total, 4)),
        fp32, in the anchors' order: each level's (B, A·K, H, W) goes
        channels-last before the reshape, so a place's A anchors sit
        together, each with its K classes."""
        cls_out, reg_out = [], []
        for f in feats:
            c, r = f, f
            for conv in self.cls_convs:
                c = F.relu(conv(c))
            for conv in self.reg_convs:
                r = F.relu(conv(r))
            B = f.shape[0]
            with fp32(f.device):
                cls_out.append(self.retina_cls(at_least_fp32(c)).permute(0, 2, 3, 1)
                               .reshape(B, -1, self.num_classes))
                reg_out.append(self.retina_reg(at_least_fp32(r)).permute(0, 2, 3, 1)
                               .reshape(B, -1, 4))
        return torch.cat(cls_out, 1), torch.cat(reg_out, 1)


class RetinaNet(nn.Module):
    """`backbone_cfg` a BackboneConfig (or an InternImageConfig); `input_hw`
    sizes the ViT's position embedding (default the config's img_size
    square)."""

    def __init__(self, backbone_cfg, det: RetinaConfig,
                 input_hw: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.det = det
        self.backbone = build_backbone(backbone_cfg, input_hw)
        self.neck = FPN(self.backbone.out_channels, det.feat_channels, num_outs=5,
                        start_level=1, add_extra_convs="on_input")
        self.bbox_head = RetinaHead(det, det.feat_channels)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) → (cls logits (B, A_total, K), deltas (B, A_total,
        4)); `deterministic=False` turns drop-path and dropout on, drawn
        from `generator`."""
        return self.bbox_head(self.features(x, deterministic, generator))

    def features(self, x: torch.Tensor, deterministic: bool = True,
                 generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        """The FPN's 5 NCHW levels.  The ViT's stride-4 level (fpn1) feeds
        none of them and is not run (JAX's jit drops it): its parameters
        get no gradient."""
        kw = {"first_level": 1} if isinstance(self.backbone, ViTRVSA) else {}
        return self.neck(self.backbone(x, deterministic, generator, **kw))


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
               num_classes: int, gamma: float, alpha: float) -> torch.Tensor:
    """Sigmoid focal loss over (..., A, K) logits, summed and divided by the
    number of positives (mmdet FocalLoss): labels (..., A) with num_classes
    for background (an all-zero target), -1 ignored; `valid` masks the
    anchors that count."""
    y = F.one_hot(labels.clamp(0, num_classes), num_classes + 1)[..., :num_classes] \
        .to(logits.dtype)
    p = torch.sigmoid(logits)
    ce = optax_sigmoid_ce(logits, y)
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    loss = torch.where(valid[..., None], a_t * (1 - p_t) ** gamma * ce, 0.0)
    fg = ((labels >= 0) & (labels < num_classes) & valid).sum()
    return loss.sum() / fg.clamp(min=1)


def retinanet_loss(det: RetinaConfig, anchors, cls_logits: torch.Tensor,
                   deltas: torch.Tensor, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, {loss_cls, loss_bbox}) from the head's outputs: per image,
    every anchor assigned by max IoU (positive at 0.5, negative under 0.4,
    each gt's best anchors positive at any IoU above 0); the focal loss
    over positives and negatives and L1 of the positives' deltas, each over
    the image's positives; then averaged over the images."""
    A = torch.as_tensor(anchors, dtype=torch.float32, device=cls_logits.device)
    gt_boxes = at_least_fp32(batch["gt_boxes"])
    assign = max_iou_assign(A, gt_boxes, batch["gt_valid"].bool(), batch["gt_labels"],
                            det.pos_iou, det.neg_iou, 0.0, True)
    labels = torch.where(assign.gt_inds > 0, assign.labels, det.num_classes)
    valid = assign.gt_inds >= 0
    loss_cls = torch.stack([focal_loss(cls_logits[b], labels[b], valid[b], det.num_classes,
                                       det.focal_gamma, det.focal_alpha)
                            for b in range(cls_logits.shape[0])])
    pos = assign.gt_inds > 0
    tgt = delta_encode(A.expand(gt_boxes.shape[0], -1, -1),
                       _take(gt_boxes, (assign.gt_inds - 1).clamp(min=0)))
    loss_bbox = torch.where(pos[..., None], (deltas - tgt).abs(), 0.0).sum((1, 2)) \
        / pos.sum(1).clamp(min=1)
    losses = {"loss_cls": loss_cls.mean(), "loss_bbox": loss_bbox.mean()}
    return losses["loss_cls"] + losses["loss_bbox"], losses


def retinanet_predict(det: RetinaConfig, anchors, img_hw: Tuple[int, int],
                      cls_logits: torch.Tensor, deltas: torch.Tensor) -> Detections:
    """Detections (B, max_per_img): sigmoid scores over every (anchor,
    class), those at or under `score_thr` set to NEG_INF, the top
    min(10·max_per_img, A·K) (a stable descending sort: `lax.top_k`'s
    ties), their anchors' boxes decoded and clipped, then class-aware NMS
    (N1 on a CUDA tensor)."""
    A = torch.as_tensor(anchors, dtype=torch.float32, device=cls_logits.device)
    K = det.num_classes
    probs = torch.sigmoid(cls_logits.float()).flatten(1)
    top_s, top_i = _stable_topk(torch.where(probs > det.score_thr, probs, NEG_INF),
                                min(det.max_per_img * 10, probs.shape[1]))
    a_i = top_i // K
    boxes = delta_decode(A[a_i], _take(deltas.float(), a_i), max_shape=img_hw)
    labels = top_i % K
    keep_i, scores = batched_nms(boxes, top_s, labels, det.nms_iou, det.max_per_img)
    keep_i = keep_i.long()
    return Detections(_take(boxes, keep_i), scores, labels.gather(1, keep_i),
                      scores > NEG_INF / 2)
