"""Scene-classification head: global average pool + linear classifier
(port of `mtp_tpu/heads/linear_cls.py`; mmpretrain `GlobalAveragePooling` +
`LinearClsHead`, parameter names `fc.weight` / `fc.bias`)."""

from __future__ import annotations

import torch
from torch import nn

from mtp_tpu_torch.ops.precision import at_least_fp32


class LinearClsHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int):
        super().__init__()
        self.fc = nn.Linear(in_channels, num_classes)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) → logits (B, num_classes), fp32.  As in JAX, the
        mean is taken in the feature's dtype and cast to fp32, and `fc` runs
        in fp32 (with autocast off: under bf16 autocast an nn.Linear would
        run in bf16)."""
        x = at_least_fp32(feat.mean((1, 2)))
        with torch.autocast(x.device.type, enabled=False):
            return self.fc(x)
