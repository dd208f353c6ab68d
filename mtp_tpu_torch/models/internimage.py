"""InternImage backbone (a DCNv3 CNN), NHWC.

Port of `mtp_tpu/models/internimage.py`: a stem (2× stride-2 conv + LN),
4 stages of DCNv3 layers with MLPs and layer scale, post-norm (XL) or
pre-norm (T) layers, stride-2 conv downsampling between stages; 4 pyramid
levels at strides 4/8/16/32 with channels C, 2C, 4C, 8C.  Parameter names
are the reference's (`patch_embed.conv1`, `patch_embed.norm1.1`,
`levels.{s}.blocks.{i}.{gamma1, norm1.0, dcn.*, mlp.*}`, `levels.{s}.norm.0`
for pre-norm, `levels.{s}.downsample.{conv, norm.1}`), as
`mtp_tpu/ckpt/torch_convert.py` `convert_internimage` reads them.

LayerNorm eps is 1e-6 and GELU exact.  With `deterministic=False` each
layer's two residual branches go through per-sample drop-path at the rates
linspace(0, drop_path_rate, Σdepths), the masks drawn from the generator
passed in.  With `remat` each layer runs under `torch.utils.checkpoint`
while gradients are recorded: its activations are recomputed in the
backward, and its drop-path masks are drawn before the checkpointed call and
passed in, so the recompute uses the forward's masks (checkpoint restores
the global RNGs, not an explicit generator).

Kernels: each layer's DCNv3 runs K3 once in the forward (twice per train
step with remat: the forward and the recompute) and K6 once in the backward.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mtp_tpu_torch.config import InternImageConfig
from mtp_tpu_torch.ops.dcnv3 import DCNv3
from mtp_tpu_torch.ops.dropout import apply_drop_path, drop_path_mask
from mtp_tpu_torch.parallel.tensor import column_parallel, row_parallel


def _norm(channels: int) -> nn.Sequential:
    """LayerNorm under the reference's `build_norm_layer` index: its index 0
    is the NCHW → NHWC permute, which the port's NHWC code does not need."""
    return nn.Sequential(nn.Identity(), nn.LayerNorm(channels, eps=1e-6))


def _conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class MLP(nn.Module):
    """fc1 → GELU → fc2; under tensor parallelism fc1 column-parallel and fc2
    row-parallel (`parallel.tensor`; the DCNv3 core stays whole, as JAX's
    rules leave it)."""

    def __init__(self, channels: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(channels, hidden)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, channels)

    def tp_widths(self):
        return {"the MLP's hidden size": self.fc1.out_features}

    def tensor_parallel(self, tp) -> None:
        self.fc1, self.fc2 = column_parallel(self.fc1, tp), row_parallel(self.fc2, tp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class InternImageLayer(nn.Module):
    def __init__(self, channels: int, groups: int, mlp_ratio: float,
                 drop_path_rate: float, layer_scale: Optional[float],
                 offset_scale: float, post_norm: bool):
        super().__init__()
        self.drop_path_rate, self.post_norm = drop_path_rate, post_norm
        self.norm1 = nn.Sequential(nn.LayerNorm(channels, eps=1e-6))
        self.dcn = DCNv3(channels, group=groups, offset_scale=offset_scale)
        self.norm2 = nn.Sequential(nn.LayerNorm(channels, eps=1e-6))
        self.mlp = MLP(channels, int(channels * mlp_ratio))
        if layer_scale is not None:
            self.gamma1 = nn.Parameter(torch.full((channels,), float(layer_scale)))
            self.gamma2 = nn.Parameter(torch.full((channels,), float(layer_scale)))
        else:
            self.gamma1 = self.gamma2 = None

    def drop_path_masks(self, x: torch.Tensor, deterministic: bool,
                        generator: Optional[torch.Generator]):
        """The keep masks of the two residual branches (None when off)."""
        return tuple(drop_path_mask(x, self.drop_path_rate, deterministic,
                                    generator) for _ in range(2))

    def forward(self, x: torch.Tensor, keep1: Optional[torch.Tensor] = None,
                keep2: Optional[torch.Tensor] = None) -> torch.Tensor:
        rate = self.drop_path_rate
        if self.post_norm:
            a = self.norm1(self.dcn(x))
        else:
            a = self.dcn(self.norm1(x))
        a = a if self.gamma1 is None else a * self.gamma1
        x = x + apply_drop_path(a, keep1, rate)
        if self.post_norm:
            b = self.norm2(self.mlp(x))
        else:
            b = self.mlp(self.norm2(x))
        b = b if self.gamma2 is None else b * self.gamma2
        return x + apply_drop_path(b, keep2, rate)


class StemLayer(nn.Module):
    """conv s2 → LN → GELU → conv s2 → LN (reference `StemLayer`)."""

    def __init__(self, in_chans: int, channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_chans, channels // 2, 3, stride=2, padding=1)
        self.norm1 = _norm(channels // 2)
        self.act = nn.GELU()
        self.conv2 = nn.Conv2d(channels // 2, channels, 3, stride=2, padding=1)
        self.norm2 = _norm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act(self.norm1(_conv_nhwc(self.conv1, x)))
        return self.norm2(_conv_nhwc(self.conv2, x))


class DownsampleLayer(nn.Module):
    """conv 3×3 s2 (no bias) → LN, doubling the channels."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, 2 * channels, 3, stride=2, padding=1,
                              bias=False)
        self.norm = _norm(2 * channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(_conv_nhwc(self.conv, x))


class InternImageBlock(nn.Module):
    """One stage: its layers, the stream norm (pre-norm variants only) and
    the downsample to the next stage (all stages but the last)."""

    def __init__(self, cfg: InternImageConfig, stage: int, dpr: np.ndarray):
        super().__init__()
        ch = cfg.channels * 2 ** stage
        self.blocks = nn.ModuleList(
            InternImageLayer(ch, cfg.groups[stage], cfg.mlp_ratio, float(rate),
                             cfg.layer_scale, cfg.offset_scale, cfg.post_norm)
            for rate in dpr)
        self.norm = None if cfg.post_norm else nn.Sequential(
            nn.LayerNorm(ch, eps=1e-6))
        self.downsample = (DownsampleLayer(ch) if stage < len(cfg.depths) - 1
                           else None)


class InternImage(nn.Module):
    """forward takes (B, H, W, 3) and returns the `out_indices` levels,
    NHWC, at strides 4/8/16/32."""

    def __init__(self, cfg: InternImageConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = StemLayer(3, cfg.channels)
        dpr = np.linspace(0, cfg.drop_path_rate, sum(cfg.depths))
        bounds = np.cumsum((0,) + tuple(cfg.depths))
        self.levels = nn.ModuleList(
            InternImageBlock(cfg, s, dpr[bounds[s]:bounds[s + 1]])
            for s in range(len(cfg.depths)))

    @property
    def out_channels(self) -> Tuple[int, ...]:
        return tuple(self.cfg.channels * 2 ** s for s in self.cfg.out_indices)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        remat = self.cfg.remat and torch.is_grad_enabled()
        x = self.patch_embed(x)
        outs = []
        for s, level in enumerate(self.levels):
            for layer in level.blocks:
                keep = layer.drop_path_masks(x, deterministic, generator)
                if remat:
                    # nothing inside the layer draws random numbers: its
                    # masks are passed in, so no RNG state is saved
                    x = checkpoint(layer, x, *keep, use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    x = layer(x, *keep)
            if level.norm is not None:
                x = level.norm(x)
            if s in self.cfg.out_indices:
                outs.append(x)
            if level.downsample is not None:
                x = level.downsample(x)
        return tuple(outs)


def internimage_flops(cfg: InternImageConfig, img_size: int) -> float:
    """Analytic forward-FLOPs estimate (same count as
    `mtp_tpu.models.internimage.internimage_flops`): stem convs, per layer
    the DCNv3 projections, depthwise conv, offset/mask regressors and
    bilinear sampling plus the MLP, and the downsample convs; a
    multiply-add is 2 FLOPs."""
    fl = 2.0 * (img_size // 2) ** 2 * (cfg.channels // 2) * 3 * 9
    fl += 2.0 * (img_size // 4) ** 2 * cfg.channels * (cfg.channels // 2) * 9
    for s, depth in enumerate(cfg.depths):
        ch = cfg.channels * 2 ** s
        n = (img_size // (4 * 2 ** s)) ** 2
        g = cfg.groups[s]
        per = (2 * n * ch * ch * 2                    # input + output proj
               + 2 * n * ch * 9                      # 3x3 depthwise conv
               + 2 * n * ch * g * 27                 # offset(18)+mask(9)
               + n * g * (ch // g) * 9 * 8           # 4-tap bilinear x K²
               + 2 * n * ch * int(ch * cfg.mlp_ratio) * 2)
        fl += float(per) * depth
        if s < len(cfg.depths) - 1:
            fl += 2.0 * (n // 4) * (ch * 2) * ch * 9
    return fl
