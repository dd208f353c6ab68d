"""Change-detection task driver (port of `mtp_tpu/tasks/change_detection.py`;
LEVIR / WHU / SVCD / OSCD recipe shape): SiamChangeDetector (one backbone
pass over both epochs → fusion → UNet), pixel cross entropy with
ignore_index, AdamW with layer decay (optionally a frozen backbone), and
the change class's F1 with the mIoU family.  One device a process and the backbone's
compute precision (`tasks._fit.Task`; data parallel over processes,
`parallel.mesh`).

Batches: {"image_a", "image_b": (B, H, W, 3) float, "label": (B, H, W) int
in {0, 1, ignore_index}}."""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch
from torch import nn

from mtp_tpu_torch.config import TaskConfig
from mtp_tpu_torch.core.train import TrainState, make_train_step, seg_xent
from mtp_tpu_torch.eval.metrics import SegAccumulator
from mtp_tpu_torch.heads.upernet import resize_bilinear
from mtp_tpu_torch.models.change_detection import SiamChangeDetector
from mtp_tpu_torch.ops.precision import at_least_fp32
from mtp_tpu_torch.parallel.mesh import global_count, shard_items
from mtp_tpu_torch.tasks._fit import Task


class ChangeDetectionTask(Task):
    """`model` defaults to the config's SiamChangeDetector (abs_diff fusion)
    for `cfg.backbone.img_size` pairs, built on the CPU; `init_state` draws
    its weights and moves it to `device`, the card unless the caller asks
    for another."""

    def __init__(self, cfg: TaskConfig, model: Optional[nn.Module] = None,
                 device="cuda"):
        super().__init__(cfg, model if model is not None else SiamChangeDetector(
            cfg.backbone, cfg.num_classes), device)

    def init_state(self, generator: torch.Generator,
                   pretrained_backbone: Optional[dict] = None,
                   frozen_backbone: bool = False) -> TrainState:
        """`frozen_backbone`: the whole encoder gets no update (reference
        `frozen_stages`, CD backbone vit_rvsa_mtp.py:820-836)."""
        return self._init_state(generator, pretrained_backbone, frozen_backbone)

    def loss_fn(self, model: nn.Module, batch: Dict[str, torch.Tensor],
                generator: torch.Generator, deterministic: bool = False):
        """Train-mode BatchNorm, dropout and drop-path on (unless
        `deterministic`), logits resized to the labels, pixel cross entropy
        and pixel accuracy (%) over valid pixels."""
        labels = batch["label"].long()
        with self.autocast():
            out = model(batch["image_a"], batch["image_b"], train=True,
                        deterministic=deterministic, generator=generator)
        logits = resize_bilinear(at_least_fp32(out), tuple(labels.shape[1:3]))
        loss = seg_xent(logits, labels, self.cfg.ignore_index)
        valid = labels != self.cfg.ignore_index
        hit = (logits.argmax(-1) == labels) & valid
        acc = hit.sum() / global_count(valid.sum()) * 100.0
        return loss, {"acc": acc}

    def train_step_fn(self, deterministic: bool = False):
        """(state, batch) → (state, metrics {acc, loss, grad_norm})."""
        return make_train_step(
            lambda m, b, g: self.loss_fn(m, b, g, deterministic=deterministic), self.mesh)

    def predict_fn(self) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
        """(image_a, image_b) → per-pixel change maps (B, H, W), eval mode, in
        the caller's precision."""
        return torch.no_grad()(lambda a, b: self.model.predict(a, b).argmax(-1))

    def evaluate(self, state: TrainState,
                 data: Iterator[Dict[str, np.ndarray]]) -> Dict[str, float]:
        """mIoU/mAcc/aAcc/... (%) of the state's model over `data`, plus
        `F1_change`, the change class's F1 (open-cd's headline metric).
        Under data parallel each rank predicts every W-th batch and the
        ranks' counts are summed."""
        self._check_state(state)
        predict = self.predict_fn()
        acc = SegAccumulator(self.cfg.num_classes, self.cfg.ignore_index)
        for _, batch in shard_items(data):
            a, b = (torch.as_tensor(batch[k]).to(self.device)
                    for k in ("image_a", "image_b"))
            with self.autocast():
                pred = predict(a, b)
            acc.add(pred, batch["label"])
        res = acc.all_reduce().evaluate()
        res["F1_change"] = res["Fscore"][1] if len(res["Fscore"]) > 1 else 0.0
        return res
