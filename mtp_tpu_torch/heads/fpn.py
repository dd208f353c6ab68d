"""Feature-pyramid neck (port of `mtp_tpu/heads/fpn.py`: mmdet FPN semantics,
lateral 1×1 and output 3×3 convolutions, top-down nearest upsampling, extra
levels by a 1×1 max-pool at stride 2 or, RetinaNet's neck, by 3×3
convolutions at stride 2 on the backbone's last level), and the nearest
upsample the UNet decoder uses.  Parameter names are mmdet's:
`lateral_convs.{i}.conv`, `fpn_convs.{i}.conv`, the extra convolutions
continuing `fpn_convs`' index."""

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

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class FPN(nn.Module):
    """Laterals over the backbone's levels from `start_level` on (widths
    `in_channels`), summed top-down, then 3×3 output convolutions; levels
    past the laterals up to `num_outs` max-pool the last output (1×1
    window, stride 2), or with `add_extra_convs="on_input"` are 3×3
    convolutions at stride 2, the first on the backbone's last level, each
    next on the one before, with no ReLU between them.  Takes the
    backbone's NHWC levels and returns NCHW ones."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 5, start_level: int = 0,
                 add_extra_convs: str = ""):
        super().__init__()
        if add_extra_convs not in ("", "on_input"):
            raise ValueError(f"add_extra_convs must be '' or 'on_input', "
                             f"got {add_extra_convs!r}")
        used = list(in_channels[start_level:])
        self.start_level, self.num_outs = start_level, num_outs
        self.extra_convs = add_extra_convs == "on_input"
        self.lateral_convs = nn.ModuleList(ConvBlock(c, out_channels, 1) for c in used)
        self.fpn_convs = nn.ModuleList(ConvBlock(out_channels, out_channels, 3)
                                       for _ in used)
        if self.extra_convs:
            for i in range(len(used), num_outs):
                cin = in_channels[-1] if i == len(used) else out_channels
                self.fpn_convs.append(ConvBlock(cin, out_channels, 3, stride=2))

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        used = feats[self.start_level:]
        laterals = [conv(f.permute(0, 3, 1, 2)) for conv, f in zip(self.lateral_convs, used)]
        for i in range(len(laterals) - 1, 0, -1):
            up = upsample_nearest(laterals[i].permute(0, 2, 3, 1),
                                  tuple(laterals[i - 1].shape[2:]))
            laterals[i - 1] = laterals[i - 1] + up.permute(0, 3, 1, 2)
        outs = [conv(x) for conv, x in zip(self.fpn_convs, laterals)]
        if self.extra_convs:
            x = feats[-1].permute(0, 3, 1, 2)
            for conv in self.fpn_convs[len(laterals):]:
                x = conv(x)
                outs.append(x)
        while len(outs) < self.num_outs:
            outs.append(outs[-1][:, :, ::2, ::2])
        return tuple(outs)
