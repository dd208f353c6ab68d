"""RPN head with fixed-shape proposal generation (port of
`mtp_tpu/heads/rpn.py`), horizontal (4 deltas an anchor) or oriented (6:
the midpoint-offset coder): a shared 3×3 conv, then 1×1 objectness and
regression per anchor; training samples 256 anchors (BCE + L1 / SmoothL1);
proposals take the top `nms_pre` anchors of each level, decode, clip, and
run NMS once over the per-level winners, padded to `max_per_img` with
NEG_INF scores.  The oriented RPN's NMS is horizontal, on the proposals'
bounding boxes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mtp_tpu_torch.ops.boxes import delta_decode
from mtp_tpu_torch.ops.nms import nms_batched
from mtp_tpu_torch.ops.precision import at_least_fp32
from mtp_tpu_torch.ops.rotated_boxes import midpoint_decode, rbox_to_hbox


class RPNOut(NamedTuple):
    cls_scores: torch.Tensor  # (B, A_total) fp32 objectness logits, over levels
    deltas: torch.Tensor      # (B, A_total, 4 or 6) fp32


def fp32(device: torch.device):
    """Autocast off: what runs under it computes in fp32, as the JAX layers
    declared `dtype=float32` do."""
    return torch.autocast(device.type, enabled=False)


class RPNHead(nn.Module):
    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 num_base_anchors: int = 3, delta_dim: int = 4):
        super().__init__()
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(feat_channels, num_base_anchors, 1)
        self.rpn_reg = nn.Conv2d(feat_channels, num_base_anchors * delta_dim, 1)
        self.delta_dim = delta_dim

    def forward(self, feats: Sequence[torch.Tensor]) -> RPNOut:
        """NCHW levels → scores and deltas flattened in (level, y, x,
        anchor) order, the anchors' order; rpn_cls and rpn_reg in fp32."""
        scores, deltas = [], []
        for f in feats:
            h = F.relu(self.rpn_conv(f))
            B = h.shape[0]
            with fp32(h.device):
                h = at_least_fp32(h)
                scores.append(self.rpn_cls(h).permute(0, 2, 3, 1).reshape(B, -1))
                deltas.append(self.rpn_reg(h).permute(0, 2, 3, 1)
                              .reshape(B, -1, self.delta_dim))
        return RPNOut(torch.cat(scores, 1), torch.cat(deltas, 1))


def _stable_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` along the last axis: ties to the lower index (a stable
    descending sort; torch.topk's tie order on the card is not JAX's)."""
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def gen_proposals(rpn_out: RPNOut, anchors: torch.Tensor,
                  img_shape: Tuple[int, int], nms_pre: int = 2000,
                  max_per_img: int = 1000, iou_thr: float = 0.7,
                  rotated: bool = False, *,
                  level_sizes: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """anchors (A_total, 4); `level_sizes` each level's flat anchor count.
    The top min(nms_pre, size) anchors of each level (the reference's
    rule), decoded, clipped and put through NMS.  `rotated`: midpoint
    decoding, the centres clipped into the image, NMS on the bounding
    boxes.  Returns (boxes (B, max_per_img, 4 or 5), scores (B,
    max_per_img) with NEG_INF padding)."""
    scores = rpn_out.cls_scores
    tops, idxs, off = [], [], 0
    for sz in level_sizes:
        s, i = _stable_topk(scores[:, off:off + sz], min(nms_pre, sz))
        tops.append(s)
        idxs.append(i + off)
        off += sz
    top_s, idx = torch.cat(tops, 1), torch.cat(idxs, 1)
    d = rpn_out.deltas.gather(1, idx[..., None].expand(-1, -1, rpn_out.deltas.shape[-1]))
    if rotated:
        boxes = midpoint_decode(anchors[idx], d)
        h, w = img_shape
        boxes = torch.cat([boxes[..., :1].clamp(0, w), boxes[..., 1:2].clamp(0, h),
                           boxes[..., 2:]], -1)
        nms_in = rbox_to_hbox(boxes)
    else:
        boxes = nms_in = delta_decode(anchors[idx], d, max_shape=img_shape)
    keep_idx, keep_s = nms_batched(nms_in, top_s, iou_thr, max_per_img)
    return boxes.gather(1, keep_idx.long()[..., None].expand(-1, -1, boxes.shape[-1])), keep_s


def optax_sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def _l1(diff: torch.Tensor, beta: Optional[float]) -> torch.Tensor:
    """L1, or SmoothL1 with `beta`."""
    ad = diff.abs()
    if not beta:
        return ad
    return torch.where(ad < beta, 0.5 * ad * ad / beta, ad - 0.5 * beta)


def rpn_loss(rpn_out: RPNOut, sample, target_deltas: torch.Tensor,
             smooth_l1_beta: Optional[float] = None) -> dict:
    """Per image (B,): BCE objectness over the valid sampled slots and L1
    (or SmoothL1) regression over the positive ones, both over the number
    of valid slots (mmdet avg_factor).  sample: a batched SampleResult
    (B, num); target_deltas (B, num, 4 or 6)."""
    logits = rpn_out.cls_scores.gather(1, sample.inds)
    bce = optax_sigmoid_ce(logits, sample.is_pos.float())
    n_valid = sample.valid.sum(-1).clamp(min=1)
    loss_cls = torch.where(sample.valid, bce, 0.0).sum(-1) / n_valid
    d = rpn_out.deltas.gather(1, sample.inds[..., None].expand(
        -1, -1, rpn_out.deltas.shape[-1]))
    l1 = _l1(d - target_deltas, smooth_l1_beta)
    loss_reg = torch.where(sample.is_pos[..., None], l1, 0.0).sum((-1, -2)) / n_valid
    return {"loss_rpn_cls": loss_cls, "loss_rpn_bbox": loss_reg}
