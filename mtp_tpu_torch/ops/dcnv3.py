"""DCNv3 (deformable convolution v3): the sampling core and the module.

Port of `mtp_tpu/ops/dcnv3.py` (`dcnv3_core`, `DCNv3`) on the coordinate
algebra of `mtp_tpu/ops/dcnv3_pallas.py` `dcnv3_core_onehot`: sampling
points in unpadded absolute pixels,

    px = (dil·(K−1))//2 − pad + wo·stride + (tap_x + off_x)·offset_scale

(likewise py), which is the reference's normalise-then-denormalise round trip
(`dcnv3_core_pytorch`, align_corners=False on the zero-padded map) without
the rounding it adds.  Taps are x-major, p = ix·K + iy, and offsets come in
(x, y) pairs per tap.  The multi-tap bilinear sum is `ops/dcnv3_sample.py`
`dcnv3_sample` with P = K² taps per (image·group, output pixel): the K3
kernel forward and the K6 kernel backward on CUDA tensors (kernel K8 of the
JAX package), their plain versions on CPU tensors.

`DCNv3` keeps the reference parameter names (`input_proj`, `output_proj`,
`offset`, `mask`, `dw_conv.0` depthwise, `dw_conv.1.1` its LayerNorm), as
`mtp_tpu/ckpt/torch_convert.py` `convert_internimage` reads them.  The
offset and mask regressors and the softmax over each group's taps run in
fp32 under autocast, as the JAX module's `dtype=jnp.float32` Dense layers do.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mtp_tpu_torch.ops.dcnv3_sample import dcnv3_sample
from mtp_tpu_torch.ops.precision import at_least_fp32


def sampling_points(offset: torch.Tensor, mask: torch.Tensor, *,
                    kernel: int = 3, stride: int = 1, pad: int = 1,
                    dilation: int = 1, group: int = 4,
                    offset_scale: float = 1.0):
    """offset (N, Ho, Wo, G·K·K·2), mask (N, Ho, Wo, G·K·K) → py, px, m, each
    (N·G, Ho·Wo, K·K) fp32 and contiguous: the sampling inputs of
    `dcnv3_sample`, in pixels of the unpadded input map."""
    N, Ho, Wo, _ = offset.shape
    K = kernel
    P = K * K
    base = (dilation * (K - 1)) // 2 - pad
    ref_y = base + np.arange(Ho, dtype=np.float32) * stride
    ref_x = base + np.arange(Wo, dtype=np.float32) * stride
    start = -((dilation * (K - 1)) // 2)
    taps = start + np.arange(K, dtype=np.float32) * dilation
    tx, ty = np.meshgrid(taps, taps, indexing="ij")  # tap p = ix·K + iy
    tap_x = tx.reshape(-1) * np.float32(offset_scale)
    tap_y = ty.reshape(-1) * np.float32(offset_scale)
    # the fixed part of each coordinate, summed first as the JAX core does
    fix = lambda a: torch.as_tensor(a, device=offset.device)
    fix_x = fix(ref_x[None, None, :, None, None] + tap_x[None, None, None, None, :])
    fix_y = fix(ref_y[None, :, None, None, None] + tap_y[None, None, None, None, :])

    off = at_least_fp32(offset).reshape(N, Ho, Wo, group, P, 2)
    px = fix_x + off[..., 0] * offset_scale
    py = fix_y + off[..., 1] * offset_scale

    def grp(t):  # (N, Ho, Wo, G, P) → (N·G, Ho·Wo, P)
        return t.permute(0, 3, 1, 2, 4).reshape(N * group, Ho * Wo, P).contiguous()

    mask = at_least_fp32(mask).reshape(N, Ho, Wo, group, P)
    return grp(py), grp(px), grp(mask)


def dcnv3_core(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor, *,
               kernel: int = 3, stride: int = 1, pad: int = 1,
               dilation: int = 1, group: int = 4,
               offset_scale: float = 1.0) -> torch.Tensor:
    """x (N, H, W, G·gc); offset (N, Ho, Wo, G·K·K·2); mask (N, Ho, Wo, G·K·K),
    already softmaxed → (N, Ho, Wo, G·gc) in x's dtype.  Coordinates and
    mask are fp32."""
    N, H, W, C = x.shape
    gc = C // group
    Ho, Wo = offset.shape[1:3]
    py, px, m = sampling_points(offset, mask, kernel=kernel, stride=stride,
                                pad=pad, dilation=dilation, group=group,
                                offset_scale=offset_scale)
    xg = x.reshape(N, H * W, group, gc).transpose(1, 2)
    xg = xg.reshape(N * group, H * W, gc).contiguous()
    out = dcnv3_sample(xg, py, px, m, H, W)
    out = out.reshape(N, group, Ho, Wo, gc).permute(0, 2, 3, 1, 4)
    return out.reshape(N, Ho, Wo, group * gc)


class DCNv3(nn.Module):
    """The DCNv3 block, NHWC: input projection, depthwise conv → LayerNorm →
    GELU → offset / mask regressors (softmax over each group's K² taps),
    the sampling core, output projection."""

    def __init__(self, channels: int, kernel: int = 3, stride: int = 1,
                 pad: int = 1, dilation: int = 1, group: int = 4,
                 offset_scale: float = 1.0):
        super().__init__()
        self.kernel, self.stride, self.pad = kernel, stride, pad
        self.dilation, self.group, self.offset_scale = dilation, group, offset_scale
        P = kernel * kernel
        self.input_proj = nn.Linear(channels, channels)
        # reference: Sequential(conv, Sequential(to_channels_last, LN), GELU);
        # index 1.0 is the permute, which forward does itself
        self.dw_conv = nn.Sequential(
            nn.Conv2d(channels, channels, kernel, padding=(kernel - 1) // 2,
                      groups=channels),
            nn.Sequential(nn.Identity(), nn.LayerNorm(channels, eps=1e-6)),
            nn.GELU())
        self.offset = nn.Linear(channels, group * P * 2)
        self.mask = nn.Linear(channels, group * P)
        self.output_proj = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, H, W, _ = x.shape
        P = self.kernel * self.kernel
        proj = self.input_proj(x)
        conv, norm, act = self.dw_conv
        h = act(norm(conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)))
        with torch.autocast(x.device.type, enabled=False):
            h = at_least_fp32(h)
            offset = self.offset(h)
            mask = F.softmax(self.mask(h).reshape(N, H, W, self.group, P), -1)
        out = dcnv3_core(proj, offset, mask.reshape(N, H, W, self.group * P),
                         kernel=self.kernel, stride=self.stride, pad=self.pad,
                         dilation=self.dilation, group=self.group,
                         offset_scale=self.offset_scale)
        return self.output_proj(out)
