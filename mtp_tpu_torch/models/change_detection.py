"""Siamese change detection: one shared backbone over both epochs → feature
fusion → UNet (port of `mtp_tpu/models/change_detection.py`; reference
SiamEncoderDecoder + FeatureFusionNeck + UNetHead, configs/mtp/levir/
rvsa-l-unet-256-mae-mtp_levir.py:167-213).

The backbone runs once over the two epochs stacked along the batch (2B
images, drop-path masks drawn per sample over all 2B), as the JAX module
does, never as two towers.  The ViT is built `features_only` (raw stride-16
maps: the reference CD backbone comments its FPN out,
opencd/models/backbones/vit_rvsa_mtp.py:859-861); InternImage gives its
native pyramid.  Submodules `backbone` and `decode_head` carry open-cd's
key prefixes."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mtp_tpu_torch.heads.unet import UNetHead
from mtp_tpu_torch.heads.upernet import resize_bilinear
from mtp_tpu_torch.models.backbones import build_backbone

FUSIONS = ("abs_diff", "sum", "concat")  # FeatureFusionNeck policies


class SiamChangeDetector(nn.Module):
    """`cfg` is a BackboneConfig (or an InternImageConfig); the ViT's
    input-sized parameters are sized for `cfg.img_size` square images."""

    def __init__(self, cfg, num_classes: int = 2, fusion: str = "abs_diff"):
        super().__init__()
        if fusion not in FUSIONS:
            raise ValueError(f"fusion {fusion!r} is not one of {FUSIONS}")
        self.fusion = fusion
        self.backbone = build_backbone(cfg, features_only=True)
        widths = [c * (2 if fusion == "concat" else 1)
                  for c in self.backbone.out_channels]
        self.decode_head = UNetHead(widths, num_classes)

    def _fuse(self, fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
        if self.fusion == "abs_diff":
            return (fa - fb).abs()
        if self.fusion == "sum":
            return fa + fb
        return torch.cat([fa, fb], -1)

    def forward(self, img_a: torch.Tensor, img_b: torch.Tensor,
                train: bool = False, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, 3) × 2 → change logits (B, h, w, num_classes): 2H × 2W
        on the ViT's maps, H × W on InternImage's (callers resize).  `train`
        and `deterministic` as in `Segmentor`."""
        B = img_a.shape[0]
        feats = self.backbone(torch.cat([img_a, img_b], 0), deterministic,
                              generator)
        fused = [self._fuse(f[:B], f[B:]) for f in feats]
        return self.decode_head(fused, train, deterministic, generator)

    def predict(self, img_a: torch.Tensor, img_b: torch.Tensor) -> torch.Tensor:
        """Logits at the input size (B, H, W, num_classes), eval mode."""
        return resize_bilinear(self(img_a, img_b), tuple(img_a.shape[1:3]))
