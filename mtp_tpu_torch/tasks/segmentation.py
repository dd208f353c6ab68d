"""Semantic-segmentation task driver (port of `mtp_tpu/tasks/segmentation.py`):
Segmentor (ViT+RVSA or InternImage → UperNet), pixel cross entropy with
ignore_index, AdamW with layer decay (the backbone's layer-id map and
depth), sliding-window evaluation with mIoU.

One device a process (data parallel over processes, `parallel.mesh`) and
the backbone's compute precision, as every task driver (`tasks._fit.Task`); `predict_fn`/`slide_logits` run in the caller's
precision.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch
from torch import nn

from mtp_tpu_torch.config import SlideConfig, TaskConfig
from mtp_tpu_torch.core.train import TrainState, make_train_step, seg_xent
from mtp_tpu_torch.eval.metrics import SegAccumulator
from mtp_tpu_torch.eval.slide import slide_inference
from mtp_tpu_torch.heads.upernet import resize_bilinear
from mtp_tpu_torch.models.segmentor import Segmentor
from mtp_tpu_torch.ops.precision import at_least_fp32
from mtp_tpu_torch.parallel.mesh import global_count, shard_items
from mtp_tpu_torch.tasks._fit import Task


class SegmentationTask(Task):
    """`model` defaults to the config's Segmentor (512 channels), sized for
    `cfg.backbone.img_size` crops and built on the CPU; `init_state` draws its
    weights and moves it to `device`, the card unless the caller asks for
    another."""

    def __init__(self, cfg: TaskConfig, model: Optional[nn.Module] = None,
                 device="cuda"):
        size = cfg.backbone.img_size
        super().__init__(cfg, model if model is not None else Segmentor(
            cfg.backbone, cfg.num_classes, input_hw=(size, size)), device)

    # -- training -----------------------------------------------------------
    def loss_fn(self, model: nn.Module, batch: Dict[str, torch.Tensor],
                generator: torch.Generator, deterministic: bool = False):
        """The train step's loss: BatchNorm on batch statistics, dropout and
        drop-path on (unless `deterministic`), logits resized to the labels,
        pixel cross entropy and pixel accuracy (%) over valid pixels."""
        images, labels = batch["image"], batch["label"].long()
        with self.autocast():
            out = model(images, train=True, deterministic=deterministic,
                        generator=generator)
        logits = resize_bilinear(at_least_fp32(out), tuple(labels.shape[1:3]))
        loss = seg_xent(logits, labels, self.cfg.ignore_index)
        valid = labels != self.cfg.ignore_index
        hit = (logits.argmax(-1) == labels) & valid
        acc = hit.sum() / global_count(valid.sum()) * 100.0
        return loss, {"acc": acc}

    def train_step_fn(self, deterministic: bool = False):
        """(state, batch) → (state, metrics {acc, loss, grad_norm}); batch
        {"image": (B, H, W, 3) float, "label": (B, H, W) int} on the task's
        device.  `deterministic=True` turns dropout and drop-path off (for
        comparisons with a deterministic reference)."""
        return make_train_step(
            lambda m, b, g: self.loss_fn(m, b, g, deterministic=deterministic), self.mesh)

    # -- inference ----------------------------------------------------------
    @torch.no_grad()
    def slide_logits(self, images: torch.Tensor,
                     slide: Optional[SlideConfig] = None) -> torch.Tensor:
        """(B, H, W, 3) → fp32 logits (B, H, W, num_classes), eval mode
        (BatchNorm on running statistics, no dropout)."""
        slide = slide or self.cfg.slide
        if slide is None:
            return self.model.predict(images).float()
        return slide_inference(self.model.predict, images, self.num_classes,
                               slide)

    def predict_fn(self, slide: Optional[SlideConfig] = None
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
        """images (B, H, W, 3) → per-pixel class ids (B, H, W)."""
        return lambda images: self.slide_logits(images, slide).argmax(-1)

    def evaluate(self, state: TrainState,
                 data: Iterator[Dict[str, np.ndarray]],
                 slide: Optional[SlideConfig] = None) -> Dict[str, float]:
        """mIoU/mAcc/aAcc/... (%) of the state's model over `data`, with the
        recipe's slide geometry (or `slide`).  Under data parallel each rank
        predicts every W-th batch and the ranks' counts are summed, so every
        rank returns the world-1 result."""
        self._check_state(state)
        predict = self.predict_fn(slide)
        acc = SegAccumulator(self.cfg.num_classes, self.cfg.ignore_index)
        for _, batch in shard_items(data):
            images = torch.as_tensor(batch["image"]).to(self.device)
            with self.autocast():
                pred = predict(images)
            acc.add(pred, batch["label"])
        return acc.all_reduce().evaluate()
