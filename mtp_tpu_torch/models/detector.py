"""Two-stage detectors, Faster R-CNN, Mask R-CNN and Oriented R-CNN (port
of `mtp_tpu/models/detector.py` `DetConfig`, `oriented_rcnn_cfg` and
`TwoStageDetector`).

backbone (ViT+RVSA or InternImage, 4 NHWC levels) → FPN (5 NCHW levels of
256 channels) → RPN head (4 deltas an anchor, or the oriented RPN's 6);
multilevel RoIAlign of the first 4 levels (of rotated RoIs when rotated) →
the shared-2FC box head with its inline fc_cls / fc_reg (5-d,
class-agnostic when rotated) and, `with_mask`, the FCN mask head on 14²
RoIs with its inline conv_logits.  State-dict prefixes are mmdet's:
`backbone.`, `neck.`, `rpn_head.`, `roi_head.bbox_head.`,
`roi_head.mask_head.`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from mtp_tpu_torch.heads.fpn import FPN
from mtp_tpu_torch.heads.roi_heads import BBoxHead, MaskHead
from mtp_tpu_torch.heads.rpn import RPNHead, RPNOut
from mtp_tpu_torch.models.backbones import build_backbone
from mtp_tpu_torch.ops.roi_align import multilevel_roi_align_fused


@dataclasses.dataclass(frozen=True)
class DetConfig:
    """Static detection hyper-params (values = reference config dicts);
    a copy of the JAX class, held equal to it by a test."""

    num_classes: int = 20
    rotated: bool = False
    with_mask: bool = False
    # rpn train
    rpn_pos_iou: float = 0.7
    rpn_neg_iou: float = 0.3
    rpn_min_pos_iou: float = 0.3
    rpn_num: int = 256
    rpn_pos_fraction: float = 0.5
    rpn_smooth_l1_beta: Optional[float] = None  # oriented: 1/9
    # proposals
    nms_pre: int = 2000
    max_proposals: int = 1000
    rpn_nms_iou: float = 0.7
    # rcnn train
    rcnn_pos_iou: float = 0.5
    rcnn_neg_iou: float = 0.5
    rcnn_num: int = 512
    rcnn_pos_fraction: float = 0.25
    rcnn_match_low_quality: bool = True  # rotated rcnn: False
    # rcnn bbox std
    bbox_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    reg_class_agnostic: bool = False    # rotated: True
    rcnn_smooth_l1_beta: Optional[float] = None  # rotated: 1.0
    # test
    score_thr: float = 0.05
    test_nms_iou: float = 0.5           # rotated: 0.1 (nms_rotated)
    max_per_img: int = 100              # rotated: 2000 in ref; padded here
    # roi
    roi_size: int = 7
    mask_roi_size: int = 14
    mask_size: int = 28
    mask_upsample: str = "deconv"  # deconv | carafe | nearest | bilinear
    fpn_strides: Tuple[int, ...] = (4, 8, 16, 32)
    # max gts per image after padding
    max_gts: int = 100


def oriented_rcnn_cfg(num_classes: int) -> DetConfig:
    """Oriented R-CNN's hyper-params (reference
    rotated_detection/oriented_rcnn.py:18-145), as JAX's."""
    return DetConfig(
        num_classes=num_classes, rotated=True,
        rpn_smooth_l1_beta=1.0 / 9.0, rpn_nms_iou=0.8,
        nms_pre=2000, max_proposals=1000,
        rcnn_match_low_quality=False, reg_class_agnostic=True,
        bbox_stds=(0.1, 0.1, 0.2, 0.2, 0.1), rcnn_smooth_l1_beta=1.0,
        test_nms_iou=0.1, max_per_img=200)


class TwoStageDetector(nn.Module):
    """`backbone_cfg` is a BackboneConfig (or an InternImageConfig);
    `input_hw` sizes the ViT's position embedding and full-attention tables
    (default the config's img_size square)."""

    def __init__(self, backbone_cfg, det: DetConfig, fpn_channels: int = 256,
                 input_hw: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.det = det
        self.backbone = build_backbone(backbone_cfg, input_hw)
        self.neck = FPN(self.backbone.out_channels, fpn_channels, num_outs=5)
        self.rpn_head = RPNHead(fpn_channels, fpn_channels, 3, 6 if det.rotated else 4)
        self.roi_head = nn.ModuleDict({"bbox_head": BBoxHead(
            fpn_channels * det.roi_size ** 2, det.num_classes, 5 if det.rotated else 4,
            det.reg_class_agnostic)})
        if det.with_mask:
            self.roi_head["mask_head"] = MaskHead(det.num_classes, fpn_channels,
                                                  upsample=det.mask_upsample)

    def features(self, x: torch.Tensor, deterministic: bool = True,
                 generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        """(B, H, W, 3) → the FPN's 5 NCHW levels; `deterministic=False`
        turns drop-path and dropout on, drawn from `generator`."""
        return self.neck(self.backbone(x, deterministic, generator))

    def rpn(self, feats: Sequence[torch.Tensor]) -> RPNOut:
        return self.rpn_head(feats)

    def roi_feats(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                  batch_idx: torch.Tensor, out_size: int) -> torch.Tensor:
        """Multilevel RoIAlign of the first 4 levels: rois (R, 4), or (R, 5)
        when rotated → (R, C, s, s)."""
        return multilevel_roi_align_fused(feats[:4], rois, batch_idx, out_size,
                                          self.det.fpn_strides, rotated=self.det.rotated)

    def box_head(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                 batch_idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cls logits (R, C + 1), deltas (R, 4·C), or (R, 5) when rotated),
        both fp32."""
        return self.roi_head["bbox_head"](
            self.roi_feats(feats, rois, batch_idx, self.det.roi_size))

    def mask_head_logits(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                         batch_idx: torch.Tensor) -> torch.Tensor:
        """The mask head on `mask_roi_size`² RoIs: (R, num_classes,
        mask_size, mask_size) fp32 logits."""
        return self.roi_head["mask_head"](
            self.roi_feats(feats, rois, batch_idx, self.det.mask_roi_size))
