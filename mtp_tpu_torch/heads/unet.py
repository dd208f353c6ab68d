"""UNet decode head for change detection (port of `mtp_tpu/heads/unet.py`;
reference open-cd `UNetHead`, Change_Detection/opencd/models/decode_heads/
unet_head.py).

The features are reversed (coarsest first); each `DecoderBlock` upsamples
×2 nearest, concatenates the next feature resized bilinearly to its size,
and runs two conv 3×3-BatchNorm-ReLU; after the blocks, a bilinear ×2, dropout
0.1 and a 1×1 `conv_seg`.  On the ViT's stride-16 maps the decoder ends at
twice the input size, as the reference does (callers resize the logits).
Parameter names are open-cd's (`blocks.{i}.conv{1,2}.0` the conv, `.1` the
BatchNorm; `conv_seg`), as `mtp_tpu/ckpt/full_convert.py`
`convert_unet_head` reads them.  `train` and `deterministic` keep their
JAX meanings, as in `heads/upernet.py`, whose flax-semantics `BatchNorm`
(fp32 output, biased running variance, momentum 0.9) this head shares; the
convolutions run in the caller's autocast, as UperNet's do.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mtp_tpu_torch.heads.fpn import upsample_nearest
from mtp_tpu_torch.heads.upernet import BatchNorm, resize_bilinear
from mtp_tpu_torch.ops.dropout import dropout


class ConvBNReLU(nn.Sequential):
    """Conv 3×3 (no bias) → BatchNorm (eps 1e-5) → ReLU, NHWC in and out
    (open-cd `Conv2dReLU`: index 0 the conv, 1 the norm)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.Conv2d(cin, cout, 3, padding=1, bias=False),
                         BatchNorm(cout, eps=1e-5))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self[1](self[0](x.permute(0, 3, 1, 2)), train)
        return F.relu(y).permute(0, 2, 3, 1)


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, skip_channels: int, cout: int):
        super().__init__()
        self.conv1 = ConvBNReLU(cin + skip_channels, cout)
        self.conv2 = ConvBNReLU(cout, cout)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        H, W = x.shape[1:3]
        x = upsample_nearest(x, (2 * H, 2 * W))
        if skip is not None:
            x = torch.cat([x, resize_bilinear(skip, (2 * H, 2 * W))], -1)
        return self.conv2(self.conv1(x, train), train)


class UNetHead(nn.Module):
    """`in_channels` are the widths of the features in backbone order
    (finest first)."""

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 decoder_channels: Tuple[int, ...] = (512, 256, 128, 64),
                 dropout: float = 0.1):
        super().__init__()
        self.dropout_ratio = dropout
        rev = list(in_channels)[::-1]
        cins = [rev[0]] + list(decoder_channels[:-1])
        skips = [rev[i + 1] if i + 1 < len(rev) else 0
                 for i in range(len(decoder_channels))]
        self.blocks = nn.ModuleList(DecoderBlock(c, s, o) for c, s, o in
                                    zip(cins, skips, decoder_channels))
        self.conv_seg = nn.Conv2d(decoder_channels[-1], num_classes, 1)

    def forward(self, feats: Sequence[torch.Tensor], train: bool = False,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feats = list(feats)[::-1]
        x, skips = feats[0], feats[1:]
        for i, block in enumerate(self.blocks):
            x = block(x, skips[i] if i < len(skips) else None, train)
        H, W = x.shape[1:3]
        x = resize_bilinear(x, (2 * H, 2 * W))
        x = dropout(x, self.dropout_ratio, deterministic, generator)
        return self.conv_seg(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
