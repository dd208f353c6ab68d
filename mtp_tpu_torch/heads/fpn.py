"""Feature-pyramid neck (port of `mtp_tpu/heads/fpn.py`: mmdet FPN semantics,
lateral 1×1 and output 3×3 convolutions, top-down nearest upsampling, extra
levels by a 1×1 max-pool at stride 2), and the nearest upsample the UNet
decoder uses.  Parameter names are mmdet's: `lateral_convs.{i}.conv`,
`fpn_convs.{i}.conv`."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn


def upsample_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NHWC nearest upsample as the JAX package computes it: each pixel
    repeated by the integer ratios size // (H, W), then cropped to size."""
    _, H, W, _ = x.shape
    h, w = size
    x = x.repeat_interleave(h // H, dim=1).repeat_interleave(w // W, dim=2)
    return x[:, :h, :w]


class ConvBlock(nn.Module):
    """mmdet's ConvModule without norm or activation: the `.conv` key."""

    def __init__(self, cin: int, cout: int, kernel: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, padding=kernel // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class FPN(nn.Module):
    """Laterals over the backbone's levels (widths `in_channels`), summed
    top-down, then 3×3 output convolutions; levels past the laterals up to
    `num_outs` max-pool the last one (1×1 window, stride 2).  Takes the
    backbone's NHWC levels and returns NCHW ones.  RetinaNet's
    `add_extra_convs="on_input"` neck follows with slice 3c."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 5, start_level: int = 0,
                 add_extra_convs: str = ""):
        super().__init__()
        if add_extra_convs:
            raise NotImplementedError(
                f"add_extra_convs={add_extra_convs!r} (RetinaNet's neck) is slice 3c")
        used = list(in_channels[start_level:])
        self.start_level, self.num_outs = start_level, num_outs
        self.lateral_convs = nn.ModuleList(ConvBlock(c, out_channels, 1) for c in used)
        self.fpn_convs = nn.ModuleList(ConvBlock(out_channels, out_channels, 3)
                                       for _ in used)

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        used = feats[self.start_level:]
        laterals = [conv(f.permute(0, 3, 1, 2)) for conv, f in zip(self.lateral_convs, used)]
        for i in range(len(laterals) - 1, 0, -1):
            up = upsample_nearest(laterals[i].permute(0, 2, 3, 1),
                                  tuple(laterals[i - 1].shape[2:]))
            laterals[i - 1] = laterals[i - 1] + up.permute(0, 3, 1, 2)
        outs = [conv(x) for conv, x in zip(self.fpn_convs, laterals)]
        while len(outs) < self.num_outs:
            outs.append(outs[-1][:, :, ::2, ::2])
        return tuple(outs)
