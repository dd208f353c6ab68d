"""Feature-pyramid helpers (port of `mtp_tpu/heads/fpn.py`).  For now only
the nearest upsample that the UNet decoder uses; the detection stack's FPN
neck follows with it."""

from __future__ import annotations

from typing import Tuple

import torch


def upsample_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NHWC nearest upsample as the JAX package computes it: each pixel
    repeated by the integer ratios size // (H, W), then cropped to size."""
    _, H, W, _ = x.shape
    h, w = size
    x = x.repeat_interleave(h // H, dim=1).repeat_interleave(w // W, dim=2)
    return x[:, :h, :w]
