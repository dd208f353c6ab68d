"""RoIAlign of horizontal and rotated boxes (port of `mtp_tpu/ops/roi_align.py`
`map_roi_levels`, `map_rroi_levels` and `multilevel_roi_align_fused`, the
atlas form).  With one level it is also JAX's single-level `roi_align` and
`roi_align_rotated(clockwise=True)` (stride 1/spatial_scale), which Mask
R-CNN's legacy mask targets take.

Each RoI goes to one FPN level by mmdet's scale rule; its bins are sampled
at 2×2 points each (bilinear, torchvision aligned=True: the half-pixel
offset), clamped into the RoI's own level (border padding), and averaged.
The levels are packed into one (B·ΣHW, C) atlas, so the extraction is one
4-tap gather (`index_select`) and its backward one `index_add_`.  Plain
PyTorch: RoIAlign has no TPU kernel behind it (JAX's `grid_sample` takes
Pallas only for zeros padding).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _bin_grid(out_size: int, sampling: int, device) -> torch.Tensor:
    """Normalised sample offsets within a RoI: (out·sampling,) in (0, 1)."""
    n = out_size * sampling
    return (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n


def map_roi_levels(rois: torch.Tensor, num_levels: int,
                   finest_scale: int = 56) -> torch.Tensor:
    """mmdet SingleRoIExtractor: floor(log2(sqrt(area) / 56)), clipped."""
    scale = torch.sqrt(((rois[:, 2] - rois[:, 0]) * (rois[:, 3] - rois[:, 1]))
                       .clamp(min=1e-6))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).long()


def map_rroi_levels(rrois: torch.Tensor, num_levels: int,
                    finest_scale: int = 56) -> torch.Tensor:
    """mmrotate RotatedSingleRoIExtractor: the scale is sqrt(w·h) of the
    rotated box itself, not of its bounding box."""
    scale = torch.sqrt((rrois[:, 2] * rrois[:, 3]).clamp(min=1e-6))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).long()


def multilevel_roi_align_fused(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                               batch_idx: torch.Tensor, out_size: int,
                               strides: Sequence[int], sampling: int = 2,
                               rotated: bool = False) -> torch.Tensor:
    """feats: NCHW levels (B, C, H_l, W_l); rois (R, 4) x1y1x2y2, or with
    `rotated` (R, 5) (cx, cy, w, h, θ), in image coordinates; batch_idx (R,)
    → (R, C, out_size, out_size) in the features' dtype.  A rotated RoI's
    grid is turned by −θ about its centre: mmcv RoIAlignRotated with
    clockwise=True, as the oriented detector calls it."""
    B, C = feats[0].shape[:2]
    R = rois.shape[0]
    dev = rois.device
    hs = np.array([f.shape[2] for f in feats])
    ws = np.array([f.shape[3] for f in feats])
    offs = np.concatenate([[0], np.cumsum(hs * ws)])
    S = int(offs[-1])
    atlas = torch.cat([f.flatten(2) for f in feats], 2).transpose(1, 2).reshape(B * S, C)

    lvls = (map_rroi_levels if rotated else map_roi_levels)(rois, len(feats))
    table = lambda v, dt: torch.as_tensor(np.asarray(v), dtype=dt, device=dev)[lvls]
    inv_stride = table(1.0 / np.asarray(strides, np.float32), torch.float32)
    Hl, Wl = table(hs, torch.float32), table(ws, torch.float32)
    off = table(offs[:-1], torch.int64)
    Hl_i, Wl_i = table(hs, torch.int64), table(ws, torch.int64)

    g = _bin_grid(out_size, sampling, dev)
    if rotated:
        cx = rois[:, 0] * inv_stride - 0.5
        cy = rois[:, 1] * inv_stride - 0.5
        gc = g - 0.5
        lx = (rois[:, 2] * inv_stride)[:, None, None] * gc[None, None, :]  # (R, 1, n)
        ly = (rois[:, 3] * inv_stride)[:, None, None] * gc[None, :, None]  # (R, n, 1)
        cos, sin = torch.cos(-rois[:, 4])[:, None, None], torch.sin(-rois[:, 4])[:, None, None]
        sx = cx[:, None, None] + lx * cos - ly * sin                       # (R, n, n)
        sy = cy[:, None, None] + lx * sin + ly * cos
    else:
        x1 = rois[:, 0] * inv_stride - 0.5
        y1 = rois[:, 1] * inv_stride - 0.5
        w = (rois[:, 2] - rois[:, 0]) * inv_stride
        h = (rois[:, 3] - rois[:, 1]) * inv_stride
        sx = (x1[:, None] + w[:, None] * g[None, :])[:, None, :]      # (R, 1, n)
        sy = (y1[:, None] + h[:, None] * g[None, :])[:, :, None]      # (R, n, 1)
    # border padding: clamp into the RoI's own level
    ix = torch.minimum(sx.clamp(min=0.0), (Wl - 1.0)[:, None, None])
    iy = torch.minimum(sy.clamp(min=0.0), (Hl - 1.0)[:, None, None])
    x0, y0 = torch.floor(ix), torch.floor(iy)
    wx1, wy1 = ix - x0, iy - y0
    base = (batch_idx.long() * S + off)[:, None, None]
    xmax, ymax = (Wl_i - 1)[:, None, None], (Hl_i - 1)[:, None, None]
    n = out_size * sampling

    out = None
    for dx, dy, wx, wy in ((0, 0, 1 - wx1, 1 - wy1), (1, 0, wx1, 1 - wy1),
                           (0, 1, 1 - wx1, wy1), (1, 1, wx1, wy1)):
        xi = torch.minimum(x0.long() + dx, xmax)
        yi = torch.minimum(y0.long() + dy, ymax)
        lin = (base + yi * Wl_i[:, None, None] + xi).expand(R, n, n)
        vals = atlas.index_select(0, lin.reshape(-1)).reshape(R, n, n, C)
        tap = vals * (wx * wy).expand(R, n, n)[..., None].to(atlas.dtype)
        out = tap if out is None else out + tap
    out = out.reshape(R, out_size, sampling, out_size, sampling, C).mean((2, 4))
    return out.permute(0, 3, 1, 2)
