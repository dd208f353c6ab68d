"""Image classifier: backbone → GAP → linear head, on the last pyramid
level (port of `mtp_tpu/models/classifier.py`; reference
Scene_Classification/configs/mtp/eurosat/vit-rvsa-b-224-mae-mtp_eurosat.py:
185-213).  Submodules `backbone` and `head` carry the mmpretrain
`ImageClassifier` key prefixes."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mtp_tpu_torch.heads.linear_cls import LinearClsHead
from mtp_tpu_torch.models.backbones import build_backbone
from mtp_tpu_torch.models.vit_rvsa import ViTRVSA


class ImageClassifier(nn.Module):
    """`cfg` is a BackboneConfig (or an InternImageConfig); the ViT's
    input-sized parameters are sized for `cfg.img_size` square images."""

    def __init__(self, cfg, num_classes: int):
        super().__init__()
        self.backbone = build_backbone(cfg)
        self.head = LinearClsHead(self.backbone.out_channels[-1], num_classes)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, 3) → fp32 logits (B, num_classes); `deterministic=False`
        turns on the backbone's drop-path and dropout, drawn from
        `generator`.  The ViT runs only the pyramid level the head reads:
        fpn1-fpn3 keep their parameters, as JAX's tree does, and get no
        gradient."""
        if isinstance(self.backbone, ViTRVSA):
            return self.head(self.backbone.last_level(x, deterministic, generator))
        return self.head(self.backbone(x, deterministic, generator)[-1])
