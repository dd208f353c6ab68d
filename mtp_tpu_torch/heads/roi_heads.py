"""RoI heads of two-stage detection (port of `mtp_tpu/heads/roi_heads.py`
`Shared2FCTrunk`, `BBoxHead`, `bbox_head_loss`, `FCNMaskTrunk`, `MaskHead`
and `mask_head_loss`): class-specific 4-d deltas (Faster R-CNN) or
class-agnostic 5-d ones (Oriented R-CNN), and Mask R-CNN's FCN mask head.

RoI features are NCHW (R, C, s, s) and flatten in CHW order, as mmdet's
`Shared2FCBBoxHead` flattens them, so that a released `.pth` loads as it
is; JAX flattens HWC (`mtp_tpu/ckpt/full_convert.py` `_dense_hwc` permutes
between the two).  Names are mmdet's: `shared_fcs.{0,1}`, `fc_cls`,
`fc_reg`; the mask head's are mmdet `FCNMaskHead`'s: `convs.{0..3}.conv`,
`upsample`, `conv_logits`.  fc_cls, fc_reg and conv_logits compute in
fp32, as JAX declares them.  Mask logits are NCHW (R, K, m, m), where
JAX's are (R, m, m, K).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mtp_tpu_torch.heads.fpn import ConvBlock
from mtp_tpu_torch.heads.rpn import _l1, fp32
from mtp_tpu_torch.ops.carafe import CARAFEPack
from mtp_tpu_torch.ops.precision import at_least_fp32
from mtp_tpu_torch.parallel.mesh import global_count
from mtp_tpu_torch.parallel.tensor import column_parallel, row_parallel


class Shared2FCTrunk(nn.Module):
    """Flatten (CHW) → fc1 → ReLU → fc2 → ReLU, shared by cls and reg.  Under
    tensor parallelism fc1 is column-parallel and fc2 row-parallel
    (`parallel.tensor`): fc2's ReLU follows the sum and the bias."""

    def __init__(self, in_features: int, fc_out: int = 1024):
        super().__init__()
        self.shared_fcs = nn.ModuleList([nn.Linear(in_features, fc_out),
                                         nn.Linear(fc_out, fc_out)])

    def tp_widths(self):
        return {"the box trunk's width": self.shared_fcs[0].out_features}

    def tensor_parallel(self, tp) -> None:
        fc1, fc2 = self.shared_fcs
        self.shared_fcs = nn.ModuleList([column_parallel(fc1, tp), row_parallel(fc2, tp)])

    def trunk(self, roi_feats: torch.Tensor) -> torch.Tensor:
        """(R, C, s, s) → (R, fc_out)."""
        x = roi_feats.flatten(1)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return x

    forward = trunk


class BBoxHead(Shared2FCTrunk):
    """The trunk and the final cls/reg layers (single-task variant)."""

    def __init__(self, in_features: int, num_classes: int, reg_dim: int = 4,
                 reg_class_agnostic: bool = False, fc_out: int = 1024):
        super().__init__(in_features, fc_out)
        self.fc_cls = nn.Linear(fc_out, num_classes + 1)
        self.fc_reg = nn.Linear(fc_out, reg_dim if reg_class_agnostic
                                else reg_dim * num_classes)

    def forward(self, roi_feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.trunk(roi_feats)
        with fp32(x.device):
            x = at_least_fp32(x)
            return self.fc_cls(x), self.fc_reg(x)


def bbox_head_loss(cls_logits: torch.Tensor, reg_pred: torch.Tensor, sample,
                   target_deltas: torch.Tensor, num_classes: int,
                   reg_class_agnostic: bool = False,
                   smooth_l1_beta: Optional[float] = None) -> dict:
    """Softmax CE over the classes and background (index num_classes) over
    the valid slots; L1 (or SmoothL1) over the positive slots of the gt
    class's deltas (all classes share them if agnostic); both over the
    number of valid slots (over the global batch under data parallel,
    `parallel.mesh.global_count`).  sample: a flat SampleResult (R,)."""
    R = cls_logits.shape[0]
    rows = torch.arange(R, device=cls_logits.device)
    labels = torch.where(sample.is_pos, sample.labels, num_classes)
    ce = -F.log_softmax(cls_logits, -1)[rows, labels]
    n_valid = global_count(sample.valid.sum())
    loss_cls = torch.where(sample.valid, ce, 0.0).sum() / n_valid
    acc = (sample.valid & (cls_logits.argmax(-1) == labels)).sum() / n_valid
    if reg_class_agnostic:
        reg = reg_pred.reshape(R, -1)
    else:
        D = target_deltas.shape[-1]
        reg = reg_pred.reshape(R, num_classes, D)[
            rows, sample.labels.clamp(0, num_classes - 1)]
    l1 = _l1(reg - target_deltas, smooth_l1_beta)
    loss_reg = torch.where(sample.is_pos[:, None], l1, 0.0).sum() / n_valid
    return {"loss_cls": loss_cls, "loss_bbox": loss_reg, "acc": acc * 100.0}


class FCNMaskTrunk(nn.Module):
    """Four 3×3 convolutions with ReLU, then a 2× upsample: `deconv` (a 2×2
    ConvTranspose at stride 2 and ReLU, the reference default), `carafe`
    (mmcv's `CARAFEPack` and ReLU, `ops.carafe`; the reference
    FCNMaskHead's option), `nearest` or `bilinear` (half-pixel centres, as
    `jax.image.resize`).  (R, C, s, s) → (R, conv_out, 2s, 2s)."""

    def __init__(self, in_channels: int = 256, conv_out: int = 256,
                 upsample: str = "deconv"):
        super().__init__()
        if upsample not in ("deconv", "carafe", "nearest", "bilinear"):
            raise ValueError(f"unknown upsample {upsample!r}")
        self.upsample_mode = upsample
        self.convs = nn.ModuleList(ConvBlock(in_channels if i == 0 else conv_out,
                                             conv_out, 3) for i in range(4))
        if upsample == "deconv":
            self.upsample = nn.ConvTranspose2d(conv_out, conv_out, 2, stride=2)
        elif upsample == "carafe":
            self.upsample = CARAFEPack(conv_out, scale=2)

    def trunk(self, roi_feats: torch.Tensor) -> torch.Tensor:
        x = roi_feats
        for conv in self.convs:
            x = F.relu(conv(x))
        if self.upsample_mode in ("deconv", "carafe"):
            return F.relu(self.upsample(x))
        if self.upsample_mode == "nearest":
            return x.repeat_interleave(2, 2).repeat_interleave(2, 3)
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)

    forward = trunk


class MaskHead(FCNMaskTrunk):
    """The trunk and the 1×1 `conv_logits`, one channel a class, in fp32."""

    def __init__(self, num_classes: int, in_channels: int = 256, conv_out: int = 256,
                 upsample: str = "deconv"):
        super().__init__(in_channels, conv_out, upsample=upsample)
        self.conv_logits = nn.Conv2d(conv_out, num_classes, 1)

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        x = self.trunk(roi_feats)
        with fp32(x.device):
            return self.conv_logits(at_least_fp32(x))


def mask_head_loss(mask_logits: torch.Tensor, mask_targets: torch.Tensor,
                   sample) -> dict:
    """BCE of each slot's gt-class channel against its target, averaged
    over the mask's pixels, then over the positive slots (mmdet
    CrossEntropyLoss(use_mask=True)).  mask_logits (R, K, m, m), the class
    on axis 1; mask_targets (R, m, m) in [0, 1]; sample a flat
    SampleResult (R,)."""
    R, K = mask_logits.shape[:2]
    z = mask_logits[torch.arange(R, device=mask_logits.device),
                    sample.labels.clamp(0, K - 1)]
    bce = z.clamp(min=0) - z * mask_targets + torch.log1p(torch.exp(-z.abs()))
    n_pos = global_count(sample.is_pos.sum())
    return {"loss_mask": torch.where(sample.is_pos, bce.mean((1, 2)), 0.0).sum() / n_pos}
