"""RoI box head of two-stage detection (port of `mtp_tpu/heads/roi_heads.py`
`Shared2FCTrunk`, `BBoxHead` and `bbox_head_loss`): class-specific 4-d
deltas (Faster R-CNN) or class-agnostic 5-d ones (Oriented R-CNN); the
mask trunk follows with slice 3c.

RoI features are NCHW (R, C, s, s) and flatten in CHW order, as mmdet's
`Shared2FCBBoxHead` flattens them, so that a released `.pth` loads as it
is; JAX flattens HWC (`mtp_tpu/ckpt/full_convert.py` `_dense_hwc` permutes
between the two).  Names are mmdet's: `shared_fcs.{0,1}`, `fc_cls`,
`fc_reg`.  fc_cls and fc_reg compute in fp32, as JAX declares them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mtp_tpu_torch.heads.rpn import _l1, fp32
from mtp_tpu_torch.ops.precision import at_least_fp32


class Shared2FCTrunk(nn.Module):
    """Flatten (CHW) → fc1 → ReLU → fc2 → ReLU, shared by cls and reg."""

    def __init__(self, in_features: int, fc_out: int = 1024):
        super().__init__()
        self.shared_fcs = nn.ModuleList([nn.Linear(in_features, fc_out),
                                         nn.Linear(fc_out, fc_out)])

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
    number of valid slots.  sample: a flat SampleResult (R,)."""
    R = cls_logits.shape[0]
    rows = torch.arange(R, device=cls_logits.device)
    labels = torch.where(sample.is_pos, sample.labels, num_classes)
    ce = -F.log_softmax(cls_logits, -1)[rows, labels]
    n_valid = sample.valid.sum().clamp(min=1)
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
