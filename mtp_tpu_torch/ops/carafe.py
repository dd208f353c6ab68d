"""CARAFE, content-aware reassembly of features (port of `mtp_tpu/ops/carafe.py`;
reference mask head's `upsample_cfg=dict(type='carafe')`, mmcv `CARAFEPack`).

A 1×1 channel compressor and a 3×3 content encoder predict σ²·k²
reassembly kernels a pixel; a pixel shuffle puts them on the σ× grid, a
softmax over the k² taps (fp32) normalises them, and each output pixel is
the kernel-weighted sum of its source pixel's k×k neighbourhood (zero
outside the map).  JAX computes this outside any Pallas kernel (patch
extraction and an einsum), and so does the port, in plain PyTorch: the
reassembly loops over the k² taps, each a shifted view of the padded map,
so that no k²-fold copy of the map is made.

Parameter names are mmcv's (`channel_compressor`, `content_encoder`); the
encoder's output channels are ordered as JAX's pixel shuffle reads them,
(sub-row i, sub-column j, tap), channel (i·σ + j)·k² + tap.  Maps are NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def carafe_reassemble(x: torch.Tensor, masks: torch.Tensor, kernel: int = 5,
                      scale: int = 2) -> torch.Tensor:
    """x (B, C, H, W); masks (B, k², σH, σW), already normalised →
    (B, C, σH, σW), in x's dtype, summed in fp32: output pixel (i, j) reads
    the k×k neighbourhood of its source pixel (i // σ, j // σ), tap t at
    offset (t // k − k // 2, t % k − k // 2), weighted by its mask."""
    B, C, H, W = x.shape
    k, s, p = kernel, scale, kernel // 2
    xp = F.pad(x, (p, p, p, p))
    # (B, k², H, W, σ, σ): each source pixel's σ×σ output kernels
    m = masks.float().reshape(B, k * k, H, s, W, s).permute(0, 1, 2, 4, 3, 5)
    out = x.new_zeros((B, C, H, W, s, s), dtype=torch.float32)
    for t in range(k * k):
        dy, dx = divmod(t, k)
        tap = xp[:, :, dy:dy + H, dx:dx + W].float()
        out = out + tap[..., None, None] * m[:, t, None]
    return out.permute(0, 1, 2, 4, 3, 5).reshape(B, C, H * s, W * s).to(x.dtype)


class CARAFEPack(nn.Module):
    """Kernel prediction + reassembly (mmcv `CARAFEPack` defaults: up_kernel
    5, encoder kernel 3, 64 compressed channels, one group)."""

    def __init__(self, channels: int, scale: int = 2, up_kernel: int = 5,
                 encoder_kernel: int = 3, compressed_channels: int = 64):
        super().__init__()
        self.scale, self.up_kernel = scale, up_kernel
        self.channel_compressor = nn.Conv2d(channels, compressed_channels, 1)
        self.content_encoder = nn.Conv2d(compressed_channels,
                                         scale * scale * up_kernel * up_kernel,
                                         encoder_kernel, padding=encoder_kernel // 2)

    def kernels(self, x: torch.Tensor) -> torch.Tensor:
        """The normalised reassembly kernels (B, k², σH, σW), fp32."""
        B, _, H, W = x.shape
        s, kk = self.scale, self.up_kernel ** 2
        m = self.content_encoder(self.channel_compressor(x))
        # pixel shuffle, channel (i·σ + j)·k² + tap → (B, k², σH, σW)
        m = m.reshape(B, s, s, kk, H, W).permute(0, 3, 4, 1, 5, 2).reshape(B, kk, H * s, W * s)
        return torch.softmax(m.float(), dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return carafe_reassemble(x, self.kernels(x), self.up_kernel, self.scale)
