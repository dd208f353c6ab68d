"""Backbone factory (port of `mtp_tpu/models/backbones.py`, ViT branch)."""

from __future__ import annotations

from typing import Optional, Tuple

from torch import nn

from mtp_tpu_torch.config import BackboneConfig
from mtp_tpu_torch.models.vit_rvsa import ViTRVSA


def build_backbone(cfg: BackboneConfig,
                   input_hw: Optional[Tuple[int, int]] = None) -> nn.Module:
    """`cfg.name` selects the family; only ViT+RVSA is ported."""
    if cfg.name.startswith("internimage"):
        raise NotImplementedError(
            "InternImage/DCNv3 is not ported yet (ROADMAP queue 1 item 11)")
    return ViTRVSA(cfg, input_hw)
