"""Horizontal box ops: IoU/IoF overlaps and the DeltaXYWH box coder (port of
`mtp_tpu/ops/boxes.py`; mmdet's `bbox_overlaps` and `DeltaXYWHBBoxCoder`
semantics, eps 1e-6 and no +1).  Fixed shapes: padded boxes are handled by
masks, never by filtering.  Every function takes leading batch dimensions.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) x1y1x2y2 → area; degenerate boxes clamp to 0."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=0)
    return w * h


def bbox_overlaps(a: torch.Tensor, b: torch.Tensor, mode: str = "iou",
                  eps: float = 1e-6) -> torch.Tensor:
    """Pairwise overlaps of a (..., N, 4) and b (..., M, 4) → (..., N, M).
    mode 'iou': inter / union; 'iof': inter / area(a).  The NMS kernel
    (csrc/nms.cu) evaluates the same expression in the same order."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = box_area(a)[..., :, None]
    if mode == "iof":
        denom = area_a
    else:
        denom = area_a + box_area(b)[..., None, :] - inter
    return inter / denom.clamp(min=eps)


def delta_encode(proposals: torch.Tensor, gts: torch.Tensor,
                 means: Sequence[float] = (0., 0., 0., 0.),
                 stds: Sequence[float] = (1., 1., 1., 1.)) -> torch.Tensor:
    """(..., 4), (..., 4) → deltas (..., 4)."""
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = (proposals[..., 2] - proposals[..., 0]).clamp(min=1e-6)
    ph = (proposals[..., 3] - proposals[..., 1]).clamp(min=1e-6)
    gx = (gts[..., 0] + gts[..., 2]) * 0.5
    gy = (gts[..., 1] + gts[..., 3]) * 0.5
    gw = gts[..., 2] - gts[..., 0]
    gh = gts[..., 3] - gts[..., 1]
    d = torch.stack([(gx - px) / pw, (gy - py) / ph,
                     torch.log(gw.clamp(min=1e-6) / pw),
                     torch.log(gh.clamp(min=1e-6) / ph)], dim=-1)
    means = d.new_tensor(means)
    stds = d.new_tensor(stds)
    return (d - means) / stds


def delta_decode(rois: torch.Tensor, deltas: torch.Tensor,
                 means: Sequence[float] = (0., 0., 0., 0.),
                 stds: Sequence[float] = (1., 1., 1., 1.),
                 max_shape: Optional[Tuple[int, int]] = None,
                 wh_ratio_clip: float = 16 / 1000) -> torch.Tensor:
    """rois (..., 4), deltas (..., 4) → decoded boxes (..., 4); dw and dh
    clipped to ±|log(wh_ratio_clip)|, the boxes to max_shape (h, w) if
    given."""
    d = deltas * deltas.new_tensor(stds) + deltas.new_tensor(means)
    dx, dy, dw, dh = d.unbind(-1)
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    px = (rois[..., 0] + rois[..., 2]) * 0.5
    py = (rois[..., 1] + rois[..., 3]) * 0.5
    pw = rois[..., 2] - rois[..., 0]
    ph = rois[..., 3] - rois[..., 1]
    gx = px + pw * dx
    gy = py + ph * dy
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    x1, y1 = gx - gw * 0.5, gy - gh * 0.5
    x2, y2 = gx + gw * 0.5, gy + gh * 0.5
    if max_shape is not None:
        h, w = max_shape
        x1, x2 = x1.clamp(0, w), x2.clamp(0, w)
        y1, y2 = y1.clamp(0, h), y2.clamp(0, h)
    return torch.stack([x1, y1, x2, y2], dim=-1)
