"""The detection task: Faster R-CNN and Mask R-CNN on horizontal boxes,
Oriented R-CNN on rotated ones, and RetinaNet (port of
`mtp_tpu/tasks/detection_task.py`, every head): `init_state` → `fit` (the
shared `fit_loop`, checkpoints included) → `predict_fn` → `evaluate` (VOC
AP50, the DIOR protocol and the rotated DIOR-R / DOTA one; with
`coco=True` the COCO protocol, bbox and, for Mask R-CNN, segm).

One device a process (the card unless the caller asks for another; data
parallel over processes, `parallel.mesh`) and the backbone's compute
precision, as every task driver (`tasks._fit.Task`);
`predict_fn` runs in the caller's precision, `evaluate` in the backbone's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mtp_tpu_torch.config import RetinaConfig, TaskConfig
from mtp_tpu_torch.core.train import TrainState, make_train_step
from mtp_tpu_torch.eval.coco_eval import evaluate_coco_bbox_segm
from mtp_tpu_torch.eval.det_map import eval_map
from mtp_tpu_torch.eval.masks import paste_masks
from mtp_tpu_torch.models.detector import DetConfig, TwoStageDetector, oriented_rcnn_cfg
from mtp_tpu_torch.models.retinanet import (RetinaNet, retina_anchors, retinanet_loss,
                                            retinanet_predict)
from mtp_tpu_torch.parallel.mesh import all_gather_objects, gather_in_order, is_main, shard_items
from mtp_tpu_torch.tasks._fit import Task
from mtp_tpu_torch.tasks.detection import (Detections, anchors_for,
                                           det_loss_core, det_predict_core)

HEADS = ("faster_rcnn", "mask_rcnn", "oriented_rcnn", "retinanet")


def det_config(head: str, num_classes: int, overrides: Optional[dict] = None):
    """The head's config: RetinaConfig for "retinanet", else DetConfig's
    defaults ("faster_rcnn"), with_mask ("mask_rcnn") or `oriented_rcnn_cfg`;
    `overrides` replace its fields."""
    ov = overrides or {}
    if head == "retinanet":
        return RetinaConfig(num_classes=num_classes, **ov)
    base = (oriented_rcnn_cfg(num_classes) if head == "oriented_rcnn"
            else DetConfig(num_classes=num_classes, with_mask=head == "mask_rcnn"))
    return dataclasses.replace(base, **ov)


def build_detector(head: str, backbone_cfg, det, input_hw: Tuple[int, int]) -> nn.Module:
    """The head's model for input_hw images, on the CPU: a RetinaNet or a
    TwoStageDetector."""
    model = RetinaNet if head == "retinanet" else TwoStageDetector
    return model(backbone_cfg, det, input_hw=input_hw)


def host_detections(dets: Detections, batch: dict, masks: bool = False) -> dict:
    """A batch's Detections on the host (fp32 numpy), one copy a field:
    "boxes", "scores", "labels", "valid" and, with `masks` when the model
    gave mask logits and the batch has gt masks ("gt_mask_crops" or
    "gt_masks"), "mask_logits"."""
    host = lambda t: t.float().cpu().numpy() if t.is_floating_point() else t.cpu().numpy()
    out = dict(zip(("boxes", "scores", "labels", "valid"), map(host, dets[:4])))
    if masks and dets.mask_logits is not None and \
            ("gt_masks" in batch or "gt_mask_crops" in batch):
        out["mask_logits"] = host(dets.mask_logits)
    return out


def image_record(dets: dict, i: int, batch: dict, hw: Tuple[int, int],
                 gt_prefix: str = "") -> dict:
    """Image i's record for the evaluators: its valid detections (from
    `host_detections`) and its valid gts (batch[gt_prefix + "gt_boxes"],
    ...); with mask logits, each detection's mask probabilities (sigmoid)
    pasted into the image at 0.5 (`paste_masks`) and the gt masks: the gt
    crops pasted back, or the stride-s masks repeated up to the image."""
    H, W = hw
    v = dets["valid"][i]
    gv = np.asarray(batch[gt_prefix + "gt_valid"][i]).astype(bool)
    rec = {"det_boxes": dets["boxes"][i][v], "det_scores": dets["scores"][i][v],
           "det_labels": dets["labels"][i][v],
           "gt_boxes": np.asarray(batch[gt_prefix + "gt_boxes"][i])[gv],
           "gt_labels": np.asarray(batch[gt_prefix + "gt_labels"][i])[gv]}
    if "mask_logits" in dets:
        probs = 1.0 / (1.0 + np.exp(-dets["mask_logits"][i][v]))
        rec["det_masks"] = paste_masks(probs, rec["det_boxes"], H, W)
        if "gt_mask_crops" in batch:
            gm = paste_masks(np.asarray(batch["gt_mask_crops"][i])[gv], rec["gt_boxes"], H, W)
        else:
            gm = np.asarray(batch["gt_masks"][i])[gv]
            if gm.ndim == 3 and gm.shape[1:] != (H, W):
                ry, rx = H // gm.shape[1], W // gm.shape[2]
                gm = np.repeat(np.repeat(gm, ry, 1), rx, 2)
        rec["gt_masks"] = (gm > 0.5).astype(np.uint8)
    return rec


class DetectionTask(Task):
    """head: "faster_rcnn" (DetConfig's defaults), "mask_rcnn" (with_mask),
    "oriented_rcnn" (`oriented_rcnn_cfg`) or "retinanet" (RetinaConfig).
    `model` defaults to the config's TwoStageDetector or RetinaNet for
    `cfg.backbone.img_size` images, built on the CPU; `init_state` draws its
    weights and moves it to `device`.  `det_overrides` replace DetConfig or
    RetinaConfig fields (diagnostic runs at small sizes, a lower
    `score_thr`)."""

    def __init__(self, cfg: TaskConfig, head: str = "faster_rcnn",
                 det_overrides: Optional[dict] = None,
                 model: Optional[nn.Module] = None, device="cuda"):
        if head not in HEADS:
            raise ValueError(f"head {head!r} is not one of {HEADS}")
        self.head = head
        self.det = det_config(head, cfg.num_classes, det_overrides)
        if model is None:
            s = cfg.backbone.img_size
            model = build_detector(head, cfg.backbone, self.det, (s, s))
        super().__init__(cfg, model, device)
        self._anchor_cache: Dict[tuple, torch.Tensor] = {}
        self._predict = None

    @property
    def rotated(self) -> bool:
        return self.head == "oriented_rcnn"

    def anchors_on(self, hw: Tuple[int, int], device) -> torch.Tensor:
        """The anchors for hw images (the RPN's, or RetinaNet's), as a tensor
        on `device` (kept from call to call)."""
        key = (tuple(hw), str(device))
        if key not in self._anchor_cache:
            anchors = (retina_anchors(self.det, hw) if self.head == "retinanet"
                       else anchors_for(self.det, hw))
            self._anchor_cache[key] = torch.as_tensor(anchors, device=device)
        return self._anchor_cache[key]

    # -- training -----------------------------------------------------------
    def loss_fn(self, model: nn.Module, batch: Dict[str, torch.Tensor],
                generator: torch.Generator, deterministic: bool = False):
        """The train step's loss and metrics (`det_loss_core`, or
        `retinanet_loss`); drop-path and dropout on unless `deterministic`;
        the samplers draw from `generator`."""
        images = batch["image"]
        hw = tuple(images.shape[1:3])
        anchors = self.anchors_on(hw, images.device)
        with self.autocast():
            if self.head == "retinanet":
                cls_logits, deltas = model(images, deterministic, generator)
                return retinanet_loss(self.det, anchors, cls_logits, deltas, batch)
            feats = model.features(images, deterministic, generator)
            box_fn = lambda rois, bidx: model.box_head(feats, rois, bidx)
            mask_fn = ((lambda rois, bidx: model.mask_head_logits(feats, rois, bidx))
                       if self.det.with_mask else None)
            return det_loss_core(self.det, anchors, hw, model.rpn(feats), box_fn, batch,
                                 generator, mask_fn)

    def train_step_fn(self, deterministic: bool = False):
        """(state, batch) → (state, metrics {the losses, acc (two-stage),
        loss, grad_norm}); batch {"image": (B, H, W, 3) float, "gt_boxes":
        (B, G, 4), or (B, G, 5) rotated, "gt_labels": (B, G) int,
        "gt_valid": (B, G) bool, and for Mask R-CNN "gt_mask_crops" (B, G,
        56, 56) or "gt_masks" (B, G, H/4, W/4)} on the task's device."""
        return make_train_step(
            lambda m, b, g: self.loss_fn(m, b, g, deterministic=deterministic), self.mesh)

    # -- inference ----------------------------------------------------------
    def predict_fn(self) -> Callable[[torch.Tensor], Detections]:
        """images (B, H, W, 3) → Detections (B, max_per_img), with Mask
        R-CNN's mask logits, eval mode, in the caller's precision.
        Memoized, as JAX's jitted predict is."""
        if self._predict is None:
            model, det = self.model, self.det

            @torch.no_grad()
            def predict(images: torch.Tensor) -> Detections:
                hw = tuple(images.shape[1:3])
                anchors = self.anchors_on(hw, images.device)
                if self.head == "retinanet":
                    return retinanet_predict(det, anchors, hw, *model(images))
                feats = model.features(images)
                mask_fn = ((lambda rois, bidx: model.mask_head_logits(feats, rois, bidx))
                           if det.with_mask else None)
                return det_predict_core(
                    det, anchors, hw, images.shape[0], model.rpn(feats),
                    lambda rois, bidx: model.box_head(feats, rois, bidx), mask_fn)

            self._predict = predict
        return self._predict

    def evaluate(self, state: TrainState, data: Iterator[Dict[str, np.ndarray]],
                 iou_thr: float = 0.5, coco: bool = False) -> Dict[str, float]:
        """VOC AP at `iou_thr` (AP50: the DIOR protocol, and with rotated
        IoU DIOR-R's): {"mAP", "AP"} in %, over batches of {"image",
        "gt_boxes", "gt_labels", "gt_valid"}.  `coco=True` (horizontal
        heads): the COCO protocol's 12 stats (`evaluate_coco_bbox_segm`);
        for Mask R-CNN with "gt_mask_crops" or "gt_masks" in the batches
        also the 12 segm stats (keys `segm_*`): each detection's mask
        probabilities (sigmoid) pasted into the image at 0.5
        (`paste_masks`), against the gt crops pasted back or the stride-s
        masks repeated up to the image.

        Under data parallel each rank predicts every W-th batch; the records
        are gathered in image order and scored once, on rank 0, and every
        rank returns that result: the world-1 result."""
        self._check_state(state)
        predict = self.predict_fn()
        records = []
        for bi, batch in shard_items(data):
            images = torch.as_tensor(batch["image"]).to(self.device)
            with self.autocast():
                dets = host_detections(predict(images), batch,
                                       coco and self.head == "mask_rcnn")
            records.append((bi, [image_record(dets, i, batch, tuple(images.shape[1:3]))
                                 for i in range(images.shape[0])]))
        per_image = gather_in_order(records)
        result = None
        if is_main():
            if coco and not self.rotated:
                result = evaluate_coco_bbox_segm(per_image, self.cfg.num_classes)
            else:
                result = eval_map(per_image, self.cfg.num_classes, iou_thr,
                                  rotated=self.rotated)
        return all_gather_objects(result)[0]
