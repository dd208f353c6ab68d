"""Backbone factory (port of `mtp_tpu/models/backbones.py`): `cfg.name`
selects the family, "vit_b_rvsa" / "vit_l_rvsa" → ViTRVSA (simple-FPN
pyramid, equal channels), "internimage_xl" / "internimage_t" → InternImage
(native pyramid, doubling channels).  An `InternImageConfig` builds an
InternImage of that exact shape.  Every backbone returns 4 NHWC levels at
strides 4/8/16/32 and names their widths in `out_channels`."""

from __future__ import annotations

from typing import Optional, Tuple

from torch import nn

from mtp_tpu_torch.config import internimage_config, is_internimage
from mtp_tpu_torch.models.internimage import InternImage
from mtp_tpu_torch.models.vit_rvsa import ViTRVSA


def build_backbone(cfg, input_hw: Optional[Tuple[int, int]] = None) -> nn.Module:
    """`input_hw` sizes the ViT's position embedding and full-attention
    tables; InternImage has no input-sized parameters."""
    if is_internimage(cfg):
        return InternImage(internimage_config(cfg))
    return ViTRVSA(cfg, input_hw)
