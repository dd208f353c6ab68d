"""UperNet decode head (PSP + FPN fusion).

Port of `mtp_tpu/heads/upernet.py` (mmseg `UPerHead` as the reference
configures it: pool scales (1, 2, 3, 6), BN + ReLU conv modules, bilinear
align_corners=False resizes, dropout 0.1 and a 1×1 classifier).  Features
are NHWC; parameter names are mmseg's (`psp_modules.{k}.1.conv`,
`bottleneck`, `lateral_convs`, `fpn_convs`, `fpn_bottleneck`, `conv_seg`),
as read by `mtp_tpu/ckpt/full_convert.py` `convert_upernet_head`.

`train` and `deterministic` keep their JAX meanings: `train` makes
BatchNorm normalise with the batch statistics and update its running ones
(flax semantics, `BatchNorm`), `deterministic=False` turns the dropout on
(drawn from an explicit generator).  `nn.Module.train()`/`eval()` change
neither.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mtp_tpu_torch.ops.dropout import dropout
from mtp_tpu_torch.ops.precision import at_least_fp32
from mtp_tpu_torch.parallel.mesh import all_reduce_sum


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """NHWC bilinear resize with F.interpolate semantics (no antialias)."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                      align_corners=align_corners, antialias=False)
    return y.permute(0, 2, 3, 1)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over NCHW with flax `nn.BatchNorm(momentum=0.9)` semantics
    (torch's parameter and buffer names, so state_dicts load as before).

    With `train`, it normalises with the batch statistics, computed in fp32
    with the biased variance, and updates the running statistics with the
    same biased variance: running = 0.9·running + 0.1·batch.  A batch of one
    1×1 map is allowed (variance 0).  (torch's own BatchNorm updates the
    running variance with the unbiased one and raises on one value per
    channel.)  Otherwise it normalises with the running statistics.  The
    output is fp32, as the JAX head's BatchNorm (dtype float32).

    Under data parallel (a data axis over 1, `parallel.mesh`) the batch
    statistics are the global batch's, as JAX's over the mesh: an
    all-reduce over the data group of the fp32 sums and the count gives the
    mean, a second one of the centred squares the biased variance, and the
    gradient flows back through both; every rank updates its running
    statistics with the same global values (the model ranks of a data group
    hold the same rows, and are not summed over).  (`torch.nn.SyncBatchNorm` raises on CPU tensors
    and updates the running variance with the unbiased estimate.)"""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        xf = at_least_fp32(x)
        count = xf.new_full((1,), xf.numel() // xf.shape[1])
        sums = all_reduce_sum(torch.cat([xf.sum((0, 2, 3)), count]))
        n = sums[-1]
        mean = sums[:-1] / n
        var = all_reduce_sum((xf - mean[:, None, None]).square().sum((0, 2, 3))) / n
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
            self.num_batches_tracked.add_(1)
        inv = self.weight * torch.rsqrt(var + self.eps)
        return (xf - mean[:, None, None]) * inv[:, None, None] \
            + self.bias[:, None, None]


class ConvModule(nn.Module):
    """Conv (no bias) + BatchNorm (eps 1e-5) + ReLU, NHWC in and out."""

    def __init__(self, cin: int, cout: int, kernel: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, padding=kernel // 2, bias=False)
        self.bn = BatchNorm(cout, eps=1e-5)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.bn(self.conv(x.permute(0, 3, 1, 2)), train)
        return F.relu(y).permute(0, 2, 3, 1)


class PoolTo(nn.Module):
    """Adaptive average pool to (s, s) as the JAX head computes it: a mean
    over equal bins when H and W divide by s, a bilinear resize otherwise
    (not `adaptive_avg_pool2d`)."""

    def __init__(self, s: int):
        super().__init__()
        self.s = s

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        s = self.s
        if H % s == 0 and W % s == 0:
            return x.reshape(B, s, H // s, s, W // s, C).mean((2, 4))
        return resize_bilinear(x, (s, s))


class PSPModule(nn.ModuleList):
    """Pyramid pooling branches over the coarsest map (mmseg `PPM`: each
    branch is Sequential(pool, ConvModule)).  Returns [x] + the upsampled
    branch outputs; the head's `bottleneck` fuses them."""

    def __init__(self, cin: int, channels: int,
                 pool_scales: Tuple[int, ...] = (1, 2, 3, 6)):
        super().__init__(nn.Sequential(PoolTo(s), ConvModule(cin, channels, 1))
                         for s in pool_scales)

    def forward(self, x: torch.Tensor, train: bool = False) -> list:
        H, W = x.shape[1:3]
        return [x] + [resize_bilinear(conv(pool(x), train), (H, W))
                      for pool, conv in self]


class UperNetHead(nn.Module):
    """PSP + top-down FPN fusion to a stride-4 map, then the 1×1 classifier.
    `in_channels` are the 4 pyramid levels' widths.  `with_classifier=False`
    (the multitask model's shared trunk) builds no `conv_seg` and returns
    the fused `channels`-wide map, before the dropout."""

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 channels: int = 512, pool_scales: Tuple[int, ...] = (1, 2, 3, 6),
                 dropout: float = 0.1, align_corners: bool = False,
                 with_classifier: bool = True):
        super().__init__()
        self.dropout_ratio, self.align_corners = dropout, align_corners
        self.with_classifier = with_classifier
        self.psp_modules = PSPModule(in_channels[-1], channels, pool_scales)
        self.bottleneck = ConvModule(in_channels[-1] + len(pool_scales) * channels,
                                     channels, 3)
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, channels, 1) for c in in_channels[:-1])
        self.fpn_convs = nn.ModuleList(
            ConvModule(channels, channels, 3) for _ in in_channels[:-1])
        self.fpn_bottleneck = ConvModule(len(in_channels) * channels, channels, 3)
        if with_classifier:
            self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, feats: Sequence[torch.Tensor], train: bool = False,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        laterals = [conv(f, train) for conv, f in zip(self.lateral_convs, feats)]
        laterals.append(self.bottleneck(
            torch.cat(self.psp_modules(feats[-1], train), -1), train))
        for i in range(len(laterals) - 1, 0, -1):
            h, w = laterals[i - 1].shape[1:3]
            laterals[i - 1] = laterals[i - 1] + resize_bilinear(
                laterals[i], (h, w), self.align_corners)
        outs = [conv(l, train) for conv, l in zip(self.fpn_convs, laterals)]
        outs.append(laterals[-1])
        h, w = outs[0].shape[1:3]
        outs = [resize_bilinear(o, (h, w), self.align_corners) for o in outs]
        x = self.fpn_bottleneck(torch.cat(outs, -1), train)
        if not self.with_classifier:
            return x
        x = dropout(x, self.dropout_ratio, deterministic, generator)
        return self.conv_seg(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
