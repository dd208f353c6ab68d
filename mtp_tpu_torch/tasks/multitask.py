"""Multi-task pretraining task driver (port of `mtp_tpu/tasks/multitask.py`;
reference Multi-Task_Pretrain/main_pretrain.py): 3 SAMRS datasets × 3 tasks,
the joint loss, AdamW with layer decay and the recipe's schedule, periodic
checkpoints and the encoder-only export that every finetune recipe loads,
and the 9-way validation.

One device a process (the card unless the caller asks for another; data
parallel over processes, `parallel.mesh`) and the encoder's compute
precision, as every task driver (`tasks._fit.Task`).  A batch is
{"d0": {...}, "d1": {...}, "d2": {...}}, one dict a dataset as
`MultiTaskPretrainModel.loss` takes them.
"""

from __future__ import annotations

import collections
import itertools
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mtp_tpu_torch.config import SAMRS_CLASSES, TaskConfig
from mtp_tpu_torch.core.train import TrainState, make_train_step
from mtp_tpu_torch.eval.coco_eval import evaluate_coco_bbox_segm
from mtp_tpu_torch.eval.det_map import eval_map
from mtp_tpu_torch.eval.metrics import SegAccumulator
from mtp_tpu_torch.models.multitask import TASKS, MultiTaskPretrainModel
from mtp_tpu_torch.parallel.mesh import (all_gather_objects, gather_in_order, is_data_main,
                                         shard_items)
from mtp_tpu_torch.tasks._fit import Task
from mtp_tpu_torch.tasks.detection import anchors_for
from mtp_tpu_torch.tasks.detection_task import host_detections, image_record

# each task's decoder and final layers, by parameter-name prefix
TASK_PREFIXES = {"ss": ("semsegdecoder.", "semseghead_"),
                 "is": ("inssegdecoder.", "inssegroi"),
                 "rd": ("rotdetdecoder.", "rotdetroi")}


def allocate_batch_sizes(total: int, lengths: Sequence[int],
                         mode: str = "ratio") -> Tuple[int, ...]:
    """Split a global batch across the datasets (reference batch-size
    allocation in main_pretrain.py: "ratio" in proportion to each dataset's
    length, "avg" equally).  Every dataset gets at least 1 sample and the
    sizes sum to `total`; the rounding drift goes one sample at a time to
    the largest datasets first, never below 1 (ValueError when no split
    does)."""
    n = len(lengths)
    if mode == "avg":
        sizes = [total // n] * n
    else:
        tot_len = sum(lengths)
        sizes = [max(1, round(total * l / tot_len)) for l in lengths]
    drift = total - sum(sizes)
    order = [int(i) for i in np.argsort([-l for l in lengths])]
    i = 0
    while drift != 0 and i < 10 * n:
        j = order[i % n]
        i += 1
        if drift > 0:
            sizes[j] += 1
            drift -= 1
        elif sizes[j] > 1:
            sizes[j] -= 1
            drift += 1
    if min(sizes) < 1 or sum(sizes) != total:
        raise ValueError(f"batch {total} too small for {n} datasets")
    return tuple(sizes)


class MultiTaskPretrainTask(Task):
    """`classes` each dataset's class count with the background;
    `det_overrides` replace DetConfig fields of every detection branch;
    `tasks` a subset of ("ss", "is", "rd") (reference `--tasks`: every
    decoder exists, only the selected ones run and train); `det_multi` runs
    the detection losses as one concatenated pass.  `model` defaults to the
    config's MultiTaskPretrainModel for `cfg.backbone.img_size` images,
    built on the CPU; `init_state` draws its weights and moves it to
    `device`."""

    def __init__(self, cfg: TaskConfig, classes: Sequence[int] = SAMRS_CLASSES,
                 det_overrides: Optional[dict] = None,
                 tasks: Sequence[str] = TASKS, det_multi: bool = False,
                 model: Optional[nn.Module] = None, device="cuda"):
        if model is None:
            s = cfg.backbone.img_size
            model = MultiTaskPretrainModel(cfg.backbone, tuple(classes), det_overrides,
                                           tasks, det_multi, input_hw=(s, s))
        super().__init__(cfg, model, device)
        self._anchor_cache: Dict[tuple, torch.Tensor] = {}
        self._predict = None

    def anchors_on(self, hw: Tuple[int, int], device) -> torch.Tensor:
        """The RPN's anchors for hw images, a tensor on `device` (kept from
        call to call)."""
        key = (tuple(hw), str(device))
        if key not in self._anchor_cache:
            self._anchor_cache[key] = torch.as_tensor(anchors_for(None, hw), device=device)
        return self._anchor_cache[key]

    def init_state(self, generator: torch.Generator,
                   pretrained_backbone: Optional[dict] = None,
                   pretrained_encoder: Optional[dict] = None) -> TrainState:
        """Random weights (`tasks._fit.Task._init_state`: layer decay by the
        encoder's layer ids), an optional encoder state dict on top
        (`pretrained_backbone` and `pretrained_encoder` are aliases), and
        the decoders of tasks not selected frozen: they take no update and
        stay at their initial values (weight decay included), as torch AdamW
        leaves the reference's parameters without gradient."""
        pretrained = pretrained_backbone if pretrained_backbone is not None \
            else pretrained_encoder
        frozen = tuple(p for t in TASKS if t not in self.model.tasks
                       for p in TASK_PREFIXES[t])
        return self._init_state(generator, pretrained, frozen=frozen)

    # -- training -----------------------------------------------------------
    def loss_fn(self, model: nn.Module, batch: Dict[str, Dict[str, torch.Tensor]],
                generator: torch.Generator, deterministic: bool = False):
        """The train step's loss and its named losses, detached
        (`MultiTaskPretrainModel.loss`): BatchNorm on batch statistics,
        dropout, drop-path and the samplers on (unless `deterministic`),
        drawn from `generator`."""
        batches = [batch["d0"], batch["d1"], batch["d2"]]
        hw = tuple(batches[0]["image"].shape[1:3])
        with self.autocast():
            total, losses = model.loss(batches, generator, self.anchors_on(hw, self.device),
                                       deterministic)
        return total, {k: v.detach() for k, v in losses.items()}

    def train_step_fn(self, deterministic: bool = False):
        """(state, batch) → (state, metrics {the named losses, loss,
        grad_norm}); batch {"d0", "d1", "d2"} of tensors on the task's
        device."""
        return make_train_step(
            lambda m, b, g: self.loss_fn(m, b, g, deterministic=deterministic), self.mesh)

    # -- validation ----------------------------------------------------------
    def predict_fn(self):
        """(images (B, H, W, 3), d) → dataset d's (ss class map, Mask R-CNN
        Detections, Oriented R-CNN Detections), eval mode, in the caller's
        precision.  Memoized."""
        if self._predict is None:
            model = self.model

            @torch.no_grad()
            def predict(images: torch.Tensor, d: int):
                return model.predict(images, d,
                                     self.anchors_on(tuple(images.shape[1:3]), images.device))

            self._predict = predict
        return self._predict

    def evaluate(self, state: TrainState, data: Iterator[Dict],
                 max_batches: int = 0) -> Dict[str, float]:
        """The 9-way validation (reference validation(), main_pretrain.py:
        558-671) over batches shaped like the train batches: each dataset's
        mIoU ("ss_d{d}_mIoU"), COCO bbox and segm AP ("is_d{d}_mAP",
        "_mAP50", "_segm_mAP", "_segm_mAP50"; segm when the batches have gt
        masks), rotated VOC AP50 ("rd_d{d}_mAP50"), their mean
        "mtp_accuracy", and "eval_device_s" (predicts and their copies to
        the host) and "eval_host_s" (the host work not overlapped with
        them: each image's records, masks pasted, are built on a thread
        pool while the next predict runs).  Under data parallel each data
        rank predicts every D-th batch; the confusion counts are summed over
        the data group, the records gathered over it in image order and
        scored once, on data rank 0, and every rank returns that result
        (the times are data rank 0's)."""
        self._check_state(state)
        predict, tasks = self.predict_fn(), self.model.tasks
        classes = self.model.classes
        seg_acc = [SegAccumulator(c) for c in classes]
        h_futs, r_futs = [[] for _ in range(3)], [[] for _ in range(3)]
        pool = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 4))
        # every queued record pins its fetched batch: bound the queue
        pending, max_pending = collections.deque(), 8 * pool._max_workers
        t_dev = t_host = 0.0
        try:
            for bi, batch in shard_items(itertools.islice(data, max_batches or None)):
                for d in range(3):
                    bd = batch[f"d{d}"]
                    images = torch.as_tensor(bd["image"]).to(self.device)
                    H, W = images.shape[1:3]
                    t0 = time.perf_counter()
                    with self.autocast():
                        ss_pred, det_h, det_r = predict(images, d)
                    ss_pred = None if ss_pred is None else ss_pred.cpu()
                    dh = None if det_h is None else host_detections(det_h, bd, masks=True)
                    dr = None if det_r is None else host_detections(det_r, bd)
                    t_dev += time.perf_counter() - t0
                    t0 = time.perf_counter()
                    if ss_pred is not None:
                        seg_acc[d].add(ss_pred, bd["ss_label"])
                    for i in range(images.shape[0]):
                        if dh is not None:
                            h_futs[d].append((bi, pool.submit(image_record, dh, i, bd, (H, W))))
                            pending.append(h_futs[d][-1][1])
                        if dr is not None:
                            r_futs[d].append((bi, pool.submit(image_record, dr, i, bd, (H, W),
                                                              "r_")))
                            pending.append(r_futs[d][-1][1])
                    while len(pending) > max_pending:
                        pending.popleft().result()
                    t_host += time.perf_counter() - t0
            t0 = time.perf_counter()
            # each dataset's records in image order, gathered from every rank
            h_imgs = [gather_in_order((bi, [f.result()]) for bi, f in futs) for futs in h_futs]
            r_imgs = [gather_in_order((bi, [f.result()]) for bi, f in futs) for futs in r_futs]
            t_host += time.perf_counter() - t0
        finally:
            pool.shutdown(cancel_futures=True)
        for acc in seg_acc:
            acc.all_reduce()
        if not is_data_main():  # scored once, on data rank 0
            return all_gather_objects(None)[0]

        out: Dict[str, float] = {}
        accs = []
        for d in range(3):
            if "ss" in tasks:
                out[f"ss_d{d}_mIoU"] = seg_acc[d].evaluate()["mIoU"]
                accs.append(out[f"ss_d{d}_mIoU"])
            if "is" in tasks:
                coco = evaluate_coco_bbox_segm(h_imgs[d], classes[d] - 1)
                out[f"is_d{d}_mAP50"], out[f"is_d{d}_mAP"] = coco["AP50"], coco["mAP"]
                if "segm_mAP" in coco:
                    out[f"is_d{d}_segm_mAP"] = coco["segm_mAP"]
                    out[f"is_d{d}_segm_mAP50"] = coco["segm_AP50"]
                accs.append(coco["AP50"])
            if "rd" in tasks:
                out[f"rd_d{d}_mAP50"] = eval_map(r_imgs[d], classes[d] - 1,
                                                 rotated=True)["mAP"]
                accs.append(out[f"rd_d{d}_mAP50"])
        out["mtp_accuracy"] = float(np.mean(accs))
        out["eval_device_s"] = round(t_dev, 3)
        out["eval_host_s"] = round(t_host, 3)
        return all_gather_objects(out)[0]
