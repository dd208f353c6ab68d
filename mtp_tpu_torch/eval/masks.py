"""Instance-mask pasting: RoI mask grids → full-image binary masks (the
port's copy of `mtp_tpu/eval/masks.py`; reference `_do_paste_mask`,
instance_segmentation/mask_head.py:401).

`crop_masks_to_boxes` and `paste_masks` are numpy on the host, as in JAX;
`evaluate` pastes with them.  `paste_masks_device` is the same resample as
one batched bilinear sampling on the tensors' device, through the port's
`grid_sample` (zero padding: kernel K3 on a CUDA tensor).
"""

from __future__ import annotations

import numpy as np
import torch

from mtp_tpu_torch.ops.grid_sample import grid_sample


def crop_masks_to_boxes(masks: np.ndarray, boxes: np.ndarray,
                        size: int) -> np.ndarray:
    """The inverse of `paste_masks`: each full-resolution (H, W) instance
    mask resampled over its box onto a (size, size) grid (bilinear at the
    output pixels' centres, zeros outside the image).  An instance's mask
    is 0 outside its own box, so the crop loses only what the grid's
    resolution does: the source of the loader's mask targets."""
    N = len(masks)
    out = np.zeros((N, size, size), np.float32)
    for i in range(N):
        M = np.asarray(masks[i], np.float32)
        H, W = M.shape
        x1, y1, x2, y2 = [float(v) for v in boxes[i][:4]]
        xs = x1 + (np.arange(size) + 0.5) / size * (x2 - x1) - 0.5
        ys = y1 + (np.arange(size) + 0.5) / size * (y2 - y1) - 0.5
        x0 = np.floor(xs).astype(np.int64)
        y0 = np.floor(ys).astype(np.int64)
        fx = xs - x0
        fy = ys - y0

        def take(yy, xx):
            v = ((yy >= 0) & (yy < H))[:, None] & ((xx >= 0) & (xx < W))[None, :]
            return M[yy.clip(0, H - 1)[:, None], xx.clip(0, W - 1)[None, :]] * v

        top = take(y0, x0) * (1 - fx)[None, :] + take(y0, x0 + 1) * fx[None, :]
        bot = take(y0 + 1, x0) * (1 - fx)[None, :] + take(y0 + 1, x0 + 1) * fx[None, :]
        out[i] = top * (1 - fy)[:, None] + bot * fy[:, None]
    return out


def paste_masks(mask_probs: np.ndarray, boxes: np.ndarray, height: int,
                width: int, thr: float = 0.5) -> np.ndarray:
    """mask_probs (N, m, m) in [0, 1]; boxes (N, 4) x1y1x2y2 → (N, height,
    width) uint8: each grid resampled at the centres of the image pixels its
    box covers (align_corners=False, zero padding: the outer ring fades to
    0, detectron2's grid-sample rule), then `>= thr`."""
    N, m, _ = mask_probs.shape
    out = np.zeros((N, height, width), np.uint8)
    for i in range(N):
        x1, y1, x2, y2 = boxes[i]
        x1i, y1i = int(np.floor(x1)), int(np.floor(y1))
        x2i, y2i = int(np.ceil(x2)), int(np.ceil(y2))
        x1i, y1i = max(x1i, 0), max(y1i, 0)
        x2i, y2i = min(x2i, width), min(y2i, height)
        bw, bh = x2i - x1i, y2i - y1i
        if bw <= 0 or bh <= 0:
            continue
        ys = (np.arange(bh) + y1i + 0.5 - y1) / max(y2 - y1, 1e-6) * m - 0.5
        xs = (np.arange(bw) + x1i + 0.5 - x1) / max(x2 - x1, 1e-6) * m - 0.5
        y0 = np.floor(ys).astype(np.int64)
        x0 = np.floor(xs).astype(np.int64)
        y1f = ys - y0
        x1f = xs - x0
        g = mask_probs[i]

        def take(yy, xx):
            v = (((yy >= 0) & (yy < m))[:, None]
                 & ((xx >= 0) & (xx < m))[None, :])
            return g[yy.clip(0, m - 1)[:, None], xx.clip(0, m - 1)[None, :]] * v

        top = take(y0, x0) * (1 - x1f) + take(y0, x0 + 1) * x1f
        bot = take(y0 + 1, x0) * (1 - x1f) + take(y0 + 1, x0 + 1) * x1f
        patch = top * (1 - y1f)[:, None] + bot * y1f[:, None]
        out[i, y1i:y2i, x1i:x2i] = (patch >= thr).astype(np.uint8)
    return out


def mask_probabilities(mask_probs: torch.Tensor, boxes: torch.Tensor, height: int,
                       width: int) -> torch.Tensor:
    """`paste_masks_device`'s sampled probabilities before the threshold,
    (N, height, width) fp32."""
    N = mask_probs.shape[0]
    dev = mask_probs.device
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    gy = (torch.arange(height, dtype=torch.float32, device=dev)[None, :] + 0.5
          - y1[:, None]) / (y2 - y1).clamp(min=1e-6)[:, None] * 2.0 - 1.0
    gx = (torch.arange(width, dtype=torch.float32, device=dev)[None, :] + 0.5
          - x1[:, None]) / (x2 - x1).clamp(min=1e-6)[:, None] * 2.0 - 1.0
    grid = torch.stack([gx[:, None, :].expand(N, height, width),
                        gy[:, :, None].expand(N, height, width)], -1)
    return grid_sample(mask_probs.float()[..., None], grid, align_corners=False,
                       padding_mode="zeros")[..., 0]


def paste_masks_device(mask_probs: torch.Tensor, boxes: torch.Tensor, height: int,
                       width: int, thr: float = 0.5) -> torch.Tensor:
    """`paste_masks` on the tensors' device: mask_probs (N, m, m), boxes (N,
    4) → (N, height, width) uint8.  Every image pixel's centre goes into
    its box's [-1, 1] frame; pixels outside the box fall outside [-1, 1]
    and read 0, as the host version's zero padding gives."""
    if mask_probs.shape[0] == 0:
        return torch.zeros(0, height, width, dtype=torch.uint8, device=mask_probs.device)
    probs = mask_probabilities(mask_probs, boxes, height, width)
    return (probs >= thr).to(torch.uint8)
