"""Multi-task pretraining model: one shared encoder, three task decoders,
nine per-dataset final layers (port of `mtp_tpu/models/multitask.py`,
reference `MutliTaskPretrnFramework`, Multi-Task_Pretrain/models.py:28-222).

- The three datasets' images run through the encoder as one batch; its
  levels are split by dataset afterwards.
- Semantic segmentation: the UperNet trunk (256 channels, no classifier)
  runs once per dataset, so its train-mode BatchNorm normalises and
  updates its statistics per dataset batch (three updates a step); then
  Dropout2d(0.1) and the dataset's fp32 1×1 head.
- Instance segmentation (Mask R-CNN) and rotated detection (Oriented
  R-CNN): each a shared FPN, RPN and RoI trunks, with per-dataset fc_cls /
  fc_reg (and mask conv_logits) in fp32.  The detection losses run per
  dataset (`det_multi=False`, the default) or as one concatenated pass
  (`tasks.detection.det_loss_multi`), which computes the same function.
- Class counts include the background: the ss heads predict `classes[d]`
  channels, the detection heads `classes[d] - 1` foreground classes.
- `tasks` gates which branches run; every parameter exists whatever the
  subset, so the checkpoint layout does not depend on it.

Parameter names are the reference torch model's (`mtp_tpu/ckpt/
full_convert.py` `convert_multitask_checkpoint`): `encoder.*`,
`semsegdecoder.decode_head.*`, `semseghead_{d+1}.1.*`, `inssegdecoder.{neck,
rpn_head, roi_head.bbox_head, roi_head.mask_head}.*`,
`inssegroiboxhead_fc_{cls,reg}{d+1}`, `inssegroimaskhead_conv{d+1}`,
`rotdetdecoder.{neck, rpn_head, roi_head.bbox_head}.*`,
`rotdetroiboxhead_fc_{cls,reg}{d+1}`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mtp_tpu_torch.config import SAMRS_CLASSES
from mtp_tpu_torch.core.train import seg_xent
from mtp_tpu_torch.heads.fpn import FPN
from mtp_tpu_torch.heads.roi_heads import FCNMaskTrunk, Shared2FCTrunk
from mtp_tpu_torch.heads.rpn import RPNHead, RPNOut, fp32
from mtp_tpu_torch.heads.upernet import UperNetHead, resize_bilinear
from mtp_tpu_torch.models.backbones import build_backbone
from mtp_tpu_torch.models.detector import DetConfig, oriented_rcnn_cfg
from mtp_tpu_torch.ops.dropout import dropout2d
from mtp_tpu_torch.parallel.mesh import batch_layout, concat_rows
from mtp_tpu_torch.ops.precision import at_least_fp32
from mtp_tpu_torch.ops.roi_align import multilevel_roi_align_fused
from mtp_tpu_torch.tasks.detection import (det_loss_core, det_loss_multi,
                                           det_predict_core)

TASKS = ("ss", "is", "rd")
ROI_STRIDES = (4, 8, 16, 32)
FPN_CHANNELS, FC_OUT = 256, 1024


def _decoder(in_channels: Sequence[int], delta_dim: int, with_mask: bool) -> nn.ModuleDict:
    """mmdet's two-stage decoder without its final layers: `neck`,
    `rpn_head`, `roi_head.bbox_head` (the shared 2-FC trunk) and, with
    masks, `roi_head.mask_head` (the FCN trunk)."""
    roi_head = nn.ModuleDict({"bbox_head": Shared2FCTrunk(FPN_CHANNELS * 7 * 7, FC_OUT)})
    if with_mask:
        roi_head["mask_head"] = FCNMaskTrunk(FPN_CHANNELS, FPN_CHANNELS)
    return nn.ModuleDict({"neck": FPN(in_channels, FPN_CHANNELS, num_outs=5),
                          "rpn_head": RPNHead(FPN_CHANNELS, FPN_CHANNELS, 3, delta_dim),
                          "roi_head": roi_head})


class MultiTaskPretrainModel(nn.Module):
    """`cfg` the encoder's BackboneConfig; `input_hw` sizes the ViT's
    position embedding and full-attention tables (default the config's
    img_size square); `det_overrides` replace DetConfig fields of every
    detection branch."""

    def __init__(self, cfg, classes: Tuple[int, int, int] = SAMRS_CLASSES,
                 det_overrides: Optional[dict] = None,
                 tasks: Sequence[str] = TASKS, det_multi: bool = False,
                 input_hw: Optional[Tuple[int, int]] = None):
        super().__init__()
        tasks = tuple(tasks)
        if not tasks or not set(tasks) <= set(TASKS):
            raise ValueError(f"tasks must be a non-empty subset of {TASKS}, got {tasks!r}")
        self.cfg, self.classes, self.tasks = cfg, tuple(classes), tasks
        self.det_overrides, self.det_multi = dict(det_overrides or {}), det_multi
        self.encoder = build_backbone(cfg, input_hw)
        chans = self.encoder.out_channels
        self.semsegdecoder = nn.ModuleDict({"decode_head": UperNetHead(
            chans, 0, channels=FPN_CHANNELS, with_classifier=False)})
        self.inssegdecoder = _decoder(chans, 4, with_mask=True)
        self.rotdetdecoder = _decoder(chans, 6, with_mask=False)
        for d, c in enumerate(self.classes):
            # index 0 stands for the reference's Dropout2d(0.1), which
            # `ss_logits` applies with the step's generator
            setattr(self, f"semseghead_{d + 1}",
                    nn.Sequential(nn.Identity(), nn.Conv2d(FPN_CHANNELS, c, 1)))
            setattr(self, f"inssegroiboxhead_fc_cls{d + 1}", nn.Linear(FC_OUT, c))
            setattr(self, f"inssegroiboxhead_fc_reg{d + 1}", nn.Linear(FC_OUT, (c - 1) * 4))
            setattr(self, f"inssegroimaskhead_conv{d + 1}",
                    nn.Conv2d(FPN_CHANNELS, c - 1, 1))
            setattr(self, f"rotdetroiboxhead_fc_cls{d + 1}", nn.Linear(FC_OUT, c))
            setattr(self, f"rotdetroiboxhead_fc_reg{d + 1}", nn.Linear(FC_OUT, 5))

    @property
    def det_h_cfgs(self) -> List[DetConfig]:
        """Mask R-CNN's config of each dataset (its foreground classes)."""
        return [dataclasses.replace(DetConfig(num_classes=c - 1, with_mask=True),
                                    **self.det_overrides) for c in self.classes]

    @property
    def det_r_cfgs(self) -> List[DetConfig]:
        """Oriented R-CNN's config of each dataset."""
        ov = {k: v for k, v in self.det_overrides.items() if k != "with_mask"}
        return [dataclasses.replace(oriented_rcnn_cfg(c - 1), **ov) for c in self.classes]

    def _final(self, name: str, d: int) -> nn.Module:
        return getattr(self, f"{name}{d + 1}")

    # -- shared pieces ------------------------------------------------------
    def encode(self, images: torch.Tensor, deterministic: bool = True,
               generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        """(B, H, W, 3) → the encoder's 4 NHWC levels."""
        return self.encoder(images, deterministic, generator)

    @staticmethod
    def _roi_feats(feats, rois: torch.Tensor, bidx: torch.Tensor, out_size: int,
                   rotated: bool) -> torch.Tensor:
        return multilevel_roi_align_fused(feats[:4], rois, bidx, out_size, ROI_STRIDES,
                                          rotated=rotated)

    # -- per-task heads ------------------------------------------------------
    def ss_logits(self, enc_feats, d: int, train: bool, deterministic: bool,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Dataset d's fp32 logits (B, H/4, W/4, classes[d]): the trunk
        (BatchNorm on batch statistics, updating them, with `train`), then
        Dropout2d(0.1) unless `deterministic`, then the 1×1 head."""
        x = self.semsegdecoder["decode_head"](enc_feats, train)
        x = dropout2d(x, 0.1, deterministic, generator)
        with fp32(x.device):
            x = self._final("semseghead_", d)[1](at_least_fp32(x).permute(0, 3, 1, 2))
        return x.permute(0, 2, 3, 1)

    def is_forward(self, enc_feats) -> Tuple[Tuple[torch.Tensor, ...], RPNOut]:
        """Mask R-CNN's FPN levels (NCHW) and RPN outputs."""
        feats = self.inssegdecoder["neck"](enc_feats)
        return feats, self.inssegdecoder["rpn_head"](feats)

    def rd_forward(self, enc_feats) -> Tuple[Tuple[torch.Tensor, ...], RPNOut]:
        """Oriented R-CNN's FPN levels and oriented RPN outputs (6 deltas)."""
        feats = self.rotdetdecoder["neck"](enc_feats)
        return feats, self.rotdetdecoder["rpn_head"](feats)

    def _box_finals(self, x: torch.Tensor, prefix: str, d: int):
        with fp32(x.device):
            x = at_least_fp32(x)
            return (self._final(f"{prefix}roiboxhead_fc_cls", d)(x),
                    self._final(f"{prefix}roiboxhead_fc_reg", d)(x))

    def _mask_final(self, x: torch.Tensor, d: int) -> torch.Tensor:
        with fp32(x.device):
            return self._final("inssegroimaskhead_conv", d)(at_least_fp32(x))

    def _box_trunk(self, task: str, feats, rois, bidx) -> torch.Tensor:
        decoder = self.rotdetdecoder if task == "rd" else self.inssegdecoder
        return decoder["roi_head"]["bbox_head"](
            self._roi_feats(feats, rois, bidx, 7, task == "rd"))

    def _mask_trunk(self, feats, rois, bidx) -> torch.Tensor:
        return self.inssegdecoder["roi_head"]["mask_head"](
            self._roi_feats(feats, rois, bidx, 14, False))

    def box_fn(self, task: str, feats, d: int):
        """Dataset d's box head of `task` ("is" or "rd") on `feats`:
        (rois, bidx) → (cls logits (R, classes[d]), deltas (R, 4·(classes[d]
        − 1)), or (R, 5) for "rd")."""
        prefix = "rotdet" if task == "rd" else "insseg"
        return lambda rois, bidx: self._box_finals(
            self._box_trunk(task, feats, rois, bidx), prefix, d)

    def mask_fn(self, feats, d: int):
        """Dataset d's mask head: (rois, bidx) → fp32 logits (R, classes[d]
        − 1, 28, 28)."""
        return lambda rois, bidx: self._mask_final(self._mask_trunk(feats, rois, bidx), d)

    def box_multi_fn(self, task: str, feats):
        """The concatenated form's box head: one RoIAlign and trunk pass
        over every dataset's RoIs, each dataset's final layers on its rows
        [s, e): (rois, bidx, segs) → [(cls logits, deltas)] a dataset."""
        prefix = "rotdet" if task == "rd" else "insseg"

        def fn(rois, bidx, segs):
            x = self._box_trunk(task, feats, rois, bidx)
            return [self._box_finals(x[s:e], prefix, d) for d, (s, e) in enumerate(segs)]
        return fn

    def mask_multi_fn(self, feats):
        def fn(rois, bidx, segs):
            x = self._mask_trunk(feats, rois, bidx)
            return [self._mask_final(x[s:e], d) for d, (s, e) in enumerate(segs)]
        return fn

    # -- joint loss ----------------------------------------------------------
    def loss(self, batches: Sequence[Dict[str, torch.Tensor]],
             generator: torch.Generator, anchors,
             deterministic: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The joint loss of the 3 datasets × the selected tasks (reference
        models.py:309-468 and utils.parse_losses): (total, {"ss_d{d}",
        "is_d{d}_loss_*", "rd_d{d}_loss_*"}).  Each batches[d]: image (B_d,
        H, W, 3), ss_label (B_d, H, W); gt_boxes / gt_labels / gt_valid and
        gt_mask_crops or gt_masks (horizontal, with masks); r_gt_boxes /
        r_gt_labels / r_gt_valid (rotated).  BatchNorm trains and dropout,
        drop-path and the samplers draw from `generator` unless
        `deterministic` (BatchNorm then normalises with its running
        statistics, as JAX's `train=not deterministic`).  Under data parallel
        each dataset's batch is the rank's rows of its global batch, and a
        draw over the concatenated images keeps the rank's rows of each
        dataset (`parallel.mesh.batch_layout`)."""
        with batch_layout(*concat_rows([b["image"].shape[0] for b in batches])):
            return self._loss(batches, generator, anchors, deterministic)

    def _loss(self, batches, generator, anchors, deterministic):
        offs = np.cumsum([0] + [b["image"].shape[0] for b in batches])
        images = torch.cat([b["image"] for b in batches], 0)
        hw = tuple(images.shape[1:3])
        enc = self.encode(images, deterministic, generator)
        split = lambda levels, d: [lvl[offs[d]:offs[d + 1]] for lvl in levels]
        losses: Dict[str, torch.Tensor] = {}

        if "ss" in self.tasks:
            for d in range(3):
                logits = self.ss_logits(split(enc, d), d, not deterministic,
                                        deterministic, generator)
                label = batches[d]["ss_label"]
                logits = resize_bilinear(logits, tuple(label.shape[1:3]))
                losses[f"ss_d{d}"] = seg_xent(logits, label, 255)

        for task in ("is", "rd"):
            if task not in self.tasks:
                continue
            feats, rpn = (self.is_forward if task == "is" else self.rd_forward)(enc)
            dets = self.det_h_cfgs if task == "is" else self.det_r_cfgs
            if task == "rd":
                tb = [{"image": b["image"], "gt_boxes": b["r_gt_boxes"],
                       "gt_labels": b["r_gt_labels"], "gt_valid": b["r_gt_valid"]}
                      for b in batches]
            else:
                tb = batches
            if self.det_multi:
                _, mets = det_loss_multi(
                    dets, anchors, hw, rpn, self.box_multi_fn(task, feats), tb, generator,
                    self.mask_multi_fn(feats) if task == "is" else None)
            else:
                mets = []
                for d in range(3):
                    fd = split(feats, d)
                    rpn_d = RPNOut(*(t[offs[d]:offs[d + 1]] for t in rpn))
                    mets.append(det_loss_core(
                        dets[d], anchors, hw, rpn_d, self.box_fn(task, fd, d), tb[d],
                        generator, self.mask_fn(fd, d) if task == "is" else None)[1])
            for d, m in enumerate(mets):
                losses.update({f"{task}_d{d}_{k}": v for k, v in m.items()
                               if k.startswith("loss")})
        return sum(losses.values()), losses

    # -- validation ----------------------------------------------------------
    def predict(self, images: torch.Tensor, d: int, anchors):
        """Dataset d's eval branch (reference models.py:470-725): the ss
        class map (B, H, W), Mask R-CNN's and Oriented R-CNN's padded
        `Detections` (None for a task not selected)."""
        B, H, W, _ = images.shape
        enc = self.encode(images)
        ss_pred = det_h = det_r = None
        if "ss" in self.tasks:
            ss = self.ss_logits(enc, d, train=False, deterministic=True)
            ss_pred = resize_bilinear(ss, (H, W)).argmax(-1)
        if "is" in self.tasks:
            feats, rpn = self.is_forward(enc)
            det_h = det_predict_core(self.det_h_cfgs[d], anchors, (H, W), B, rpn,
                                     self.box_fn("is", feats, d), self.mask_fn(feats, d))
        if "rd" in self.tasks:
            feats, rpn = self.rd_forward(enc)
            det_r = det_predict_core(self.det_r_cfgs[d], anchors, (H, W), B, rpn,
                                     self.box_fn("rd", feats, d))
        return ss_pred, det_h, det_r
