"""Sliding-window inference (port of `mtp_tpu/eval/slide.py`).

Crops of `crop` pixels on a `stride` grid, edge crops shifted inward so every
crop is full-size, overlapping logits averaged by a count map.  A Python loop
over the crops: PyTorch runs eagerly, so there is no scan to compile; the
fp32 accumulators are updated in place.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from mtp_tpu_torch.config import SlideConfig


def slide_origins(H: int, W: int, crop: int, stride: int) -> np.ndarray:
    """(n, 2) array of (y, x) crop origins (reference grid rule)."""
    hg = max(int(np.ceil((H - crop) / stride)) + 1, 1)
    wg = max(int(np.ceil((W - crop) / stride)) + 1, 1)
    out = []
    for i in range(hg):
        for j in range(wg):
            out.append((min(i * stride, max(H - crop, 0)),
                        min(j * stride, max(W - crop, 0))))
    return np.asarray(out, np.int32)


def slide_inference(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                    images: torch.Tensor, num_classes: int,
                    cfg: SlideConfig = SlideConfig()) -> torch.Tensor:
    """apply_fn: (B, crop, crop, 3) → full-res crop logits (B, crop, crop, K).

    images (B, H, W, 3) → averaged logits (B, H, W, K) fp32.  For H, W <=
    crop this is a single whole-image call."""
    B, H, W, _ = images.shape
    crop = min(cfg.crop, H, W)
    if H <= cfg.crop and W <= cfg.crop:
        return apply_fn(images).float()
    preds = torch.zeros(B, H, W, num_classes, dtype=torch.float32,
                        device=images.device)
    count = torch.zeros(1, H, W, 1, dtype=torch.float32, device=images.device)
    for y, x in slide_origins(H, W, crop, cfg.stride).tolist():
        logits = apply_fn(images[:, y:y + crop, x:x + crop])
        preds[:, y:y + crop, x:x + crop] += logits.float()
        count[:, y:y + crop, x:x + crop] += 1.0
    return preds / count
