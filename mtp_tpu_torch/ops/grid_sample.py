"""Bilinear grid sampling on NHWC maps (port of `mtp_tpu/ops/grid_sample.py`).

Semantics of torch's bilinear grid sampler (mode "bilinear") on NHWC data:
- grid last dim is (x, y) in [-1, 1]
- align_corners=True:  ix = (x+1)/2 * (W-1)
- align_corners=False: ix = ((x+1)*W - 1) / 2
- padding_mode "zeros": off-map corner taps contribute 0
- padding_mode "border": coordinates clamped to the edge

"zeros" goes through `dcnv3_sample` with one tap and a unit mask (the K3
kernel on CUDA tensors), as the JAX package's `_grid_sample_dcn` does.
"border" has no kernel in the JAX package either; it stays plain torch.
"""

from __future__ import annotations

import torch

from mtp_tpu_torch.ops.dcnv3_sample import dcnv3_sample
from mtp_tpu_torch.ops.precision import at_least_fp32


def _pixel_coords(grid: torch.Tensor, H: int, W: int, align_corners: bool):
    gx, gy = at_least_fp32(grid[..., 0]), at_least_fp32(grid[..., 1])
    if align_corners:
        return (gx + 1.0) * 0.5 * (W - 1), (gy + 1.0) * 0.5 * (H - 1)
    return ((gx + 1.0) * W - 1.0) * 0.5, ((gy + 1.0) * H - 1.0) * 0.5


def grid_sample(img: torch.Tensor, grid: torch.Tensor, *,
                align_corners: bool = True,
                padding_mode: str = "zeros") -> torch.Tensor:
    """Sample `img` (N, H, W, C) at `grid` (N, Hg, Wg, 2) → (N, Hg, Wg, C)."""
    N, H, W, C = img.shape
    if grid.shape[0] != N or grid.shape[-1] != 2:
        raise ValueError(f"grid {tuple(grid.shape)} does not match img "
                         f"{tuple(img.shape)}")
    with torch.autocast(img.device.type, enabled=False):
        ix, iy = _pixel_coords(grid, H, W, align_corners)
    if padding_mode == "zeros":
        px = ix.reshape(N, -1, 1).contiguous()
        py = iy.reshape(N, -1, 1).contiguous()
        out = dcnv3_sample(img.reshape(N, H * W, C).contiguous(), py, px,
                           torch.ones_like(px), H, W)
        return out.reshape(grid.shape[:-1] + (C,))
    if padding_mode != "border":
        raise ValueError(f"padding_mode must be 'zeros' or 'border', "
                         f"got {padding_mode!r}")
    ix = ix.clamp(0.0, W - 1)
    iy = iy.clamp(0.0, H - 1)
    x0, y0 = torch.floor(ix), torch.floor(iy)
    wx1, wy1 = ix - x0, iy - y0
    flat = img.reshape(N, H * W, C)
    out = 0
    for yc, wy in ((y0, 1.0 - wy1), (y0 + 1, wy1)):
        for xc, wx in ((x0, 1.0 - wx1), (x0 + 1, wx1)):
            lin = (yc.clamp(0, H - 1) * W + xc.clamp(0, W - 1)).long()
            vals = torch.gather(flat, 1, lin.reshape(N, -1, 1).expand(-1, -1, C))
            out = out + vals.reshape(grid.shape[:-1] + (C,)) \
                * (wx * wy)[..., None].to(img.dtype)
    return out.to(img.dtype)
