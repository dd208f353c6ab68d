"""Encoder-decoder semantic segmentor: backbone (ViT+RVSA or InternImage) →
UperNet (port of `mtp_tpu/models/segmentor.py`).  Submodules `backbone` and
`decode_head` carry the mmseg `EncoderDecoder` key prefixes."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mtp_tpu_torch.heads.upernet import UperNetHead, resize_bilinear
from mtp_tpu_torch.models.backbones import build_backbone


class Segmentor(nn.Module):
    """`cfg` is a BackboneConfig (or an InternImageConfig, see
    `build_backbone`); the head takes the backbone's `out_channels`."""

    def __init__(self, cfg, num_classes: int, channels: int = 512,
                 input_hw: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.backbone = build_backbone(cfg, input_hw)
        self.decode_head = UperNetHead(list(self.backbone.out_channels),
                                       num_classes, channels)

    def forward(self, x: torch.Tensor, train: bool = False,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, 3) → stride-4 logits (B, H/4, W/4, num_classes).

        JAX meanings: `train` runs the head's BatchNorm on batch statistics
        and updates its running ones; `deterministic=False` turns on
        drop-path, dropout and the head's dropout, drawn from `generator`."""
        feats = self.backbone(x, deterministic, generator)
        return self.decode_head(feats, train, deterministic, generator)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """Full-resolution logits (B, H, W, num_classes)."""
        return resize_bilinear(self(x), tuple(x.shape[1:3]))
