"""Anchor generation (port of `mtp_tpu/ops/anchors.py`; mmdet
AnchorGenerator semantics as the reference RPN configures it: scale 8,
ratios 0.5, 1, 2, strides 4-64).  numpy, computed once per image size; the
flat order is level, then y, then x, then anchor."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def base_anchors(base_size: int, scales: Sequence[float],
                 ratios: Sequence[float], center_offset: float = 0.0) -> np.ndarray:
    """(len(ratios)*len(scales), 4) base anchors centred per mmdet."""
    scales = np.asarray(scales, np.float32)
    ratios = np.asarray(ratios, np.float32)
    h_ratios = np.sqrt(ratios)
    w_ratios = 1.0 / h_ratios
    ws = (base_size * w_ratios[:, None] * scales[None, :]).reshape(-1)
    hs = (base_size * h_ratios[:, None] * scales[None, :]).reshape(-1)
    c = center_offset * base_size
    return np.stack([c - 0.5 * ws, c - 0.5 * hs,
                     c + 0.5 * ws, c + 0.5 * hs], axis=-1).astype(np.float32)


def grid_anchors(featmap_size: Tuple[int, int], stride: int,
                 base: np.ndarray) -> np.ndarray:
    """(H*W*A, 4), location-major, anchor-minor (mmdet layout)."""
    H, W = featmap_size
    sx, sy = np.meshgrid(np.arange(W, dtype=np.float32) * stride,
                         np.arange(H, dtype=np.float32) * stride)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=-1)
    return (base[None, :, :] + shifts[:, None, :]).reshape(-1, 4)


class AnchorGenerator:
    def __init__(self, strides: Sequence[int] = (4, 8, 16, 32, 64),
                 scales: Sequence[float] = (8,),
                 ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 center_offset: float = 0.0):
        self.strides = tuple(strides)
        self.scales = tuple(scales)
        self.ratios = tuple(ratios)
        self.num_base = len(scales) * len(ratios)
        self.base = [base_anchors(s, scales, ratios, center_offset)
                     for s in strides]

    def grid(self, featmap_sizes: Sequence[Tuple[int, int]]) -> List[np.ndarray]:
        """Per-level anchors for the given feature map sizes."""
        if len(featmap_sizes) != len(self.strides):
            raise ValueError(f"{len(featmap_sizes)} maps for {len(self.strides)} strides")
        return [grid_anchors(fs, s, b)
                for fs, s, b in zip(featmap_sizes, self.strides, self.base)]

    def grid_flat(self, featmap_sizes) -> np.ndarray:
        """All levels concatenated: (sum_l H_l*W_l*A, 4)."""
        return np.concatenate(self.grid(featmap_sizes), axis=0)
