"""Instance-mask pasting: RoI mask grids → full-image binary masks (the
port's copy of `mtp_tpu/eval/masks.py`; reference `_do_paste_mask`,
instance_segmentation/mask_head.py:401).

`crop_masks_to_boxes` and `paste_masks` are numpy on the host, as in JAX
(`eval/host_masks.py`, which imports no torch); `evaluate` pastes with
them.  `paste_masks_device` is the same resample as one batched bilinear
sampling on the tensors' device, through the port's `grid_sample` (zero
padding: kernel K3 on a CUDA tensor).
"""

from __future__ import annotations

import torch

from mtp_tpu_torch.eval.host_masks import crop_masks_to_boxes, paste_masks  # noqa: F401
from mtp_tpu_torch.ops.grid_sample import grid_sample


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
