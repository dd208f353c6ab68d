"""Detection task driver, Faster R-CNN on horizontal boxes and Oriented
R-CNN on rotated ones (port of `mtp_tpu/tasks/detection_task.py` with
head="faster_rcnn" or "oriented_rcnn"; Mask R-CNN, RetinaNet and COCO
evaluation follow with slice 3c): `init_state` → `fit` (the shared
`fit_loop`, checkpoints included) → `predict_fn` → `evaluate` (VOC AP50:
the DIOR protocol, and the rotated DIOR-R / DOTA one).

One device (the card unless the caller asks for another) and the
backbone's compute precision, as every task driver (`tasks._fit.Task`);
`predict_fn` runs in the caller's precision, `evaluate` in the backbone's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mtp_tpu_torch.config import TaskConfig
from mtp_tpu_torch.core.train import TrainState, make_train_step
from mtp_tpu_torch.eval.det_map import eval_map
from mtp_tpu_torch.models.detector import DetConfig, TwoStageDetector, oriented_rcnn_cfg
from mtp_tpu_torch.tasks._fit import Task
from mtp_tpu_torch.tasks.detection import (Detections, anchors_for,
                                           det_loss_core, det_predict_core)


class DetectionTask(Task):
    """head: "faster_rcnn" (DetConfig's defaults) or "oriented_rcnn"
    (`oriented_rcnn_cfg`).  `model` defaults to the config's
    TwoStageDetector for `cfg.backbone.img_size` images, built on the CPU;
    `init_state` draws its weights and moves it to `device`.
    `det_overrides` replace DetConfig fields (diagnostic runs at small
    sizes)."""

    def __init__(self, cfg: TaskConfig, head: str = "faster_rcnn",
                 det_overrides: Optional[dict] = None,
                 model: Optional[nn.Module] = None, device="cuda"):
        if head not in ("faster_rcnn", "oriented_rcnn"):
            raise NotImplementedError(f"head {head!r}: Mask R-CNN and RetinaNet are "
                                      f"slice 3c")
        self.head = head
        base = (oriented_rcnn_cfg(cfg.num_classes) if self.rotated
                else DetConfig(num_classes=cfg.num_classes))
        self.det = dataclasses.replace(base, **(det_overrides or {}))
        s = cfg.backbone.img_size
        super().__init__(cfg, model if model is not None else TwoStageDetector(
            cfg.backbone, self.det, input_hw=(s, s)), device)
        self._anchor_cache: Dict[tuple, torch.Tensor] = {}
        self._predict = None

    @property
    def rotated(self) -> bool:
        return self.head == "oriented_rcnn"

    def anchors_on(self, hw: Tuple[int, int], device) -> torch.Tensor:
        """The RPN's anchors for hw images, as a tensor on `device` (kept
        from call to call)."""
        key = (tuple(hw), str(device))
        if key not in self._anchor_cache:
            self._anchor_cache[key] = torch.as_tensor(anchors_for(self.det, hw),
                                                      device=device)
        return self._anchor_cache[key]

    # -- training -----------------------------------------------------------
    def loss_fn(self, model: nn.Module, batch: Dict[str, torch.Tensor],
                generator: torch.Generator, deterministic: bool = False):
        """The train step's loss and metrics (`det_loss_core`); drop-path
        and dropout on unless `deterministic`; the samplers draw from
        `generator`."""
        images = batch["image"]
        hw = tuple(images.shape[1:3])
        with self.autocast():
            feats = model.features(images, deterministic, generator)
            rpn_out = model.rpn(feats)
            box_fn = lambda rois, bidx: model.box_head(feats, rois, bidx)
            return det_loss_core(self.det, self.anchors_on(hw, images.device), hw,
                                 rpn_out, box_fn, batch, generator)

    def train_step_fn(self, deterministic: bool = False):
        """(state, batch) → (state, metrics {loss_rpn_cls, loss_rpn_bbox,
        loss_cls, loss_bbox, acc, loss, grad_norm}); batch {"image": (B, H,
        W, 3) float, "gt_boxes": (B, G, 4), or (B, G, 5) rotated, "gt_labels":
        (B, G) int, "gt_valid": (B, G) bool} on the task's device."""
        return make_train_step(
            lambda m, b, g: self.loss_fn(m, b, g, deterministic=deterministic))

    # -- inference ----------------------------------------------------------
    def predict_fn(self) -> Callable[[torch.Tensor], Detections]:
        """images (B, H, W, 3) → Detections (B, max_per_img), eval mode, in
        the caller's precision.  Memoized, as JAX's jitted predict is."""
        if self._predict is None:
            model = self.model

            @torch.no_grad()
            def predict(images: torch.Tensor) -> Detections:
                hw = tuple(images.shape[1:3])
                feats = model.features(images)
                return det_predict_core(
                    self.det, self.anchors_on(hw, images.device), hw, images.shape[0],
                    model.rpn(feats), lambda rois, bidx: model.box_head(feats, rois, bidx))

            self._predict = predict
        return self._predict

    def evaluate(self, state: TrainState, data: Iterator[Dict[str, np.ndarray]],
                 iou_thr: float = 0.5, coco: bool = False) -> Dict[str, float]:
        """VOC AP at `iou_thr` (AP50: the DIOR protocol, and with rotated
        IoU DIOR-R's): {"mAP", "AP"} in %, over batches of {"image",
        "gt_boxes", "gt_labels", "gt_valid"}."""
        if coco:
            raise NotImplementedError("COCO evaluation is slice 3c")
        self._check_state(state)
        predict = self.predict_fn()
        per_image = []
        for batch in data:
            images = torch.as_tensor(batch["image"]).to(self.device)
            with self.autocast():
                dets = predict(images)
            boxes, scores, labels, valid = (t.float().cpu().numpy() if t.is_floating_point()
                                            else t.cpu().numpy() for t in dets)
            for i in range(images.shape[0]):
                v = valid[i]
                gv = np.asarray(batch["gt_valid"][i]).astype(bool)
                per_image.append({
                    "det_boxes": boxes[i][v], "det_scores": scores[i][v],
                    "det_labels": labels[i][v],
                    "gt_boxes": np.asarray(batch["gt_boxes"][i])[gv],
                    "gt_labels": np.asarray(batch["gt_labels"][i])[gv]})
        return eval_map(per_image, self.cfg.num_classes, iou_thr, rotated=self.rotated)
