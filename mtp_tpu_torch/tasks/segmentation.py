"""Semantic-segmentation task driver (port of `mtp_tpu/tasks/segmentation.py`):
Segmentor (ViT+RVSA or InternImage → UperNet), pixel cross entropy with
ignore_index, AdamW with layer decay (the backbone's layer-id map and
depth), sliding-window evaluation with mIoU.

The task runs on one device (`device`).  Compute precision follows the
backbone config's `dtype`, as the JAX package's does: "bfloat16" runs the
train step and `evaluate` under bf16 autocast (parameters, optimizer state,
BatchNorm statistics and the loss stay fp32), "float32" runs them in fp32.
`predict_fn`/`slide_logits` run in the caller's precision.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mtp_tpu_torch.ckpt.from_jax import init_weights
from mtp_tpu_torch.config import SlideConfig, TaskConfig, check_single_device
from mtp_tpu_torch.core.optim import layer_id_fn_for, make_optimizer, make_schedule
from mtp_tpu_torch.core.train import (TrainState, create_state, make_train_step,
                                      seg_xent)
from mtp_tpu_torch.eval.metrics import SegAccumulator
from mtp_tpu_torch.eval.slide import slide_inference
from mtp_tpu_torch.heads.upernet import resize_bilinear
from mtp_tpu_torch.models.segmentor import Segmentor
from mtp_tpu_torch.ops.precision import at_least_fp32


class SegmentationTask:
    """`model` defaults to the config's Segmentor (512 channels), sized for
    `cfg.backbone.img_size` crops and built on the CPU; `init_state` draws its
    weights and moves it to `device`, the card unless the caller asks for
    another."""

    def __init__(self, cfg: TaskConfig, model: Optional[nn.Module] = None,
                 device="cuda"):
        check_single_device(cfg.train.mesh)
        self.cfg = cfg
        self.device = torch.device(device)
        size = cfg.backbone.img_size
        self.model = model if model is not None else Segmentor(
            cfg.backbone, cfg.num_classes, input_hw=(size, size))
        self.num_classes = cfg.num_classes

    def autocast(self):
        """bf16 autocast when the backbone config computes in bfloat16."""
        if self.cfg.backbone.dtype == "bfloat16":
            return torch.autocast(self.device.type, dtype=torch.bfloat16)
        return contextlib.nullcontext()

    # -- training -----------------------------------------------------------
    def init_state(self, generator: torch.Generator,
                   pretrained_backbone: Optional[dict] = None) -> TrainState:
        """Random weights from `generator` (a CPU generator: the weights are
        drawn on the CPU, then the model moves to the task's device), an
        optional backbone state_dict on top, the optimizer, and the state's
        own generator on the device, seeded from `generator`."""
        cfg = self.cfg
        model = init_weights(self.model.cpu(), generator)
        if pretrained_backbone is not None:
            model.backbone.load_state_dict(pretrained_backbone)
        model.to(self.device)
        schedule = make_schedule(cfg.train.schedule, cfg.train.optimizer.lr)
        layer_id = layer_id_fn_for(cfg.backbone, root="backbone.")
        tx = make_optimizer(cfg.train.optimizer, schedule,
                            model.named_parameters(), cfg.backbone.depth,
                            layer_id_fn=layer_id)
        seed = int(torch.randint(2 ** 62, (), generator=generator))
        rng = torch.Generator(device=self.device).manual_seed(seed)
        return create_state(model, tx, rng)

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
        acc = hit.sum() / valid.sum().clamp(min=1) * 100.0
        return loss, {"acc": acc}

    def train_step_fn(self, deterministic: bool = False):
        """(state, batch) → (state, metrics {acc, loss, grad_norm}); batch
        {"image": (B, H, W, 3) float, "label": (B, H, W) int} on the task's
        device.  `deterministic=True` turns dropout and drop-path off (for
        comparisons with a deterministic reference)."""
        return make_train_step(
            lambda m, b, g: self.loss_fn(m, b, g, deterministic=deterministic))

    def fit(self, state: TrainState, data: Iterator[Dict[str, np.ndarray]],
            steps: int, log_every: int = 50,
            log_fn: Callable[[int, dict], None] = None,
            **ckpt_kw) -> Tuple[TrainState, dict]:
        from mtp_tpu_torch.tasks._fit import fit_loop
        return fit_loop(self, state, data, steps, log_every=log_every,
                        log_fn=log_fn, **ckpt_kw)

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
        recipe's slide geometry (or `slide`)."""
        if state.model is not self.model:
            raise ValueError("the state does not hold this task's model")
        predict = self.predict_fn(slide)
        acc = SegAccumulator(self.cfg.num_classes, self.cfg.ignore_index)
        for batch in data:
            images = torch.as_tensor(batch["image"]).to(self.device)
            with self.autocast():
                pred = predict(images)
            acc.add(pred, batch["label"])
        return acc.evaluate()
