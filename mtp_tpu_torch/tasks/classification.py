"""Scene-classification task driver (port of `mtp_tpu/tasks/classification.py`;
reference mmpretrain flow, RS_Tasks_Finetune/Scene_Classification):
ImageClassifier (ViT+RVSA or InternImage → linear head), cross entropy,
AdamW with layer decay, top-1 / top-5 evaluation.  One device a process
(data parallel over processes, `parallel.mesh`) and the backbone's compute
precision (`tasks._fit.Task`)."""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch
from torch import nn

from mtp_tpu_torch.config import TaskConfig
from mtp_tpu_torch.core.train import TrainState, make_train_step, softmax_xent
from mtp_tpu_torch.eval.metrics import topk_accuracy
from mtp_tpu_torch.models.classifier import ImageClassifier
from mtp_tpu_torch.parallel.mesh import all_reduce_sum, shard_items, world_size
from mtp_tpu_torch.tasks._fit import Task


class ClassificationTask(Task):
    """`model` defaults to the config's ImageClassifier for
    `cfg.backbone.img_size` images, built on the CPU; `init_state` draws its
    weights and moves it to `device`, the card unless the caller asks for
    another."""

    def __init__(self, cfg: TaskConfig, model: Optional[nn.Module] = None,
                 device="cuda"):
        super().__init__(cfg, model if model is not None else ImageClassifier(
            cfg.backbone, cfg.num_classes), device)

    def loss_fn(self, model: nn.Module, batch: Dict[str, torch.Tensor],
                generator: torch.Generator, deterministic: bool = False):
        """Cross entropy of the fp32 logits and the batch accuracy (%);
        dropout and drop-path on unless `deterministic`."""
        labels = batch["label"].long()
        with self.autocast():
            logits = model(batch["image"], deterministic=deterministic,
                           generator=generator)
        loss = softmax_xent(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean() * 100.0
        return loss, {"acc": acc}

    def train_step_fn(self, deterministic: bool = False):
        """(state, batch) → (state, metrics {acc, loss, grad_norm}); batch
        {"image": (B, H, W, 3) float, "label": (B,) int} on the task's
        device."""
        return make_train_step(
            lambda m, b, g: self.loss_fn(m, b, g, deterministic=deterministic), self.mesh)

    @torch.no_grad()
    def evaluate(self, state: TrainState,
                 data: Iterator[Dict[str, np.ndarray]]) -> Dict[str, float]:
        """top1 and top5 (%) of the state's model over `data`, each batch
        weighted by its size.  Under data parallel each rank predicts every
        W-th batch and the ranks' counts are summed."""
        self._check_state(state)
        total, hits = 0, {"top1": 0.0, "top5": 0.0}
        for _, batch in shard_items(data):
            images = torch.as_tensor(batch["image"]).to(self.device)
            with self.autocast():
                logits = self.model(images)
            accs = topk_accuracy(logits, torch.as_tensor(batch["label"]))
            n = images.shape[0]
            total += n
            for k in hits:
                hits[k] += float(accs[k]) * n
        if world_size() > 1:
            sums = all_reduce_sum(torch.tensor([total, hits["top1"], hits["top5"]],
                                               dtype=torch.float64)).tolist()
            total, hits = sums[0], {"top1": sums[1], "top5": sums[2]}
        return {k: v / max(total, 1) for k, v in hits.items()}
