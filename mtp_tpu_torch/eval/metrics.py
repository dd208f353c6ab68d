"""Evaluation metrics (port of `mtp_tpu/eval/metrics.py`): top-k accuracy
(mmpretrain `Accuracy`), per-class intersect-and-union and the mIoU / mAcc /
aAcc / mFscore / mDice accumulator (reference `MTP_SS_Metric`,
Multi-Task_Pretrain/semantic_segmentation/metric.py:19-285), and the
change class's F1 (open-cd)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from mtp_tpu_torch.parallel.mesh import all_reduce_sum, data_size


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  ks: Tuple[int, ...] = (1, 5)) -> Dict[str, torch.Tensor]:
    """{"top{k}": % of rows whose label is among the k largest logits}, as
    device scalars.  Classes ordered by descending logit; where logits tie,
    the order among them may differ from JAX's (`argsort(...)[:, ::-1]`)."""
    order = torch.argsort(logits, dim=-1, descending=True)
    labels = labels.to(order.device).long()[:, None]
    return {f"top{k}": (order[:, :k] == labels).any(1).float().mean() * 100.0
            for k in ks}


def intersect_and_union(pred: torch.Tensor, label: torch.Tensor,
                        num_classes: int, ignore_index: int = 255):
    """Per-class (intersect, union, pred_area, label_area), each (K,) int64,
    on pred's device.  Ignored pixels go to an extra bin that is dropped."""
    pred, label = pred.long(), label.long()
    valid = label != ignore_index
    pred = torch.where(valid, pred, num_classes)
    label = torch.where(valid, label, num_classes)
    inter = torch.where(pred == label, pred, num_classes)

    def area(t):
        return torch.bincount(t.reshape(-1), minlength=num_classes + 1)[:num_classes]

    area_i, area_p, area_l = area(inter), area(pred), area(label)
    return area_i, area_p + area_l - area_i, area_p, area_l


class SegAccumulator:
    """Host-side accumulator over batches; evaluate() → mIoU/mAcc/aAcc (%)."""

    def __init__(self, num_classes: int, ignore_index: int = 255):
        self.k = num_classes
        self.ignore = ignore_index
        self.i = np.zeros(num_classes, np.float64)
        self.u = np.zeros(num_classes, np.float64)
        self.p = np.zeros(num_classes, np.float64)
        self.l = np.zeros(num_classes, np.float64)

    def add(self, pred, label):
        """pred, label: (B, H, W) class ids, numpy arrays or tensors."""
        pred = torch.as_tensor(pred)
        label = torch.as_tensor(label, device=pred.device)
        i, u, p, l = intersect_and_union(pred, label, self.k, self.ignore)
        self.i += i.cpu().numpy()
        self.u += u.cpu().numpy()
        self.p += p.cpu().numpy()
        self.l += l.cpu().numpy()

    def all_reduce(self) -> "SegAccumulator":
        """Sum the counts of every data rank's accumulator (data parallel,
        each data rank having evaluated its share; a no-op without a process
        group).  The counts are integers in float64, so the sums are
        exact."""
        if data_size() > 1:
            sums = all_reduce_sum(torch.from_numpy(np.stack([self.i, self.u, self.p, self.l])))
            self.i, self.u, self.p, self.l = sums.numpy()
        return self

    def evaluate(self) -> Dict[str, float]:
        eps = 1e-12
        iou = self.i / np.maximum(self.u, eps)
        acc = self.i / np.maximum(self.l, eps)
        seen = self.l > 0
        precision = self.i / np.maximum(self.p, eps)
        recall = acc
        f1 = 2 * precision * recall / np.maximum(precision + recall, eps)
        dice = 2 * self.i / np.maximum(self.p + self.l, eps)
        return {
            "mIoU": float(iou[seen].mean() * 100) if seen.any() else 0.0,
            "mAcc": float(acc[seen].mean() * 100) if seen.any() else 0.0,
            "aAcc": float(self.i.sum() / max(self.l.sum(), eps) * 100),
            "mFscore": float(f1[seen].mean() * 100) if seen.any() else 0.0,
            "mDice": float(dice[seen].mean() * 100) if seen.any() else 0.0,
            "IoU": (iou * 100).tolist(),
            "Fscore": (f1 * 100).tolist(),
        }


def binary_change_f1(area_intersect: np.ndarray, pred_area: np.ndarray,
                     label_area: np.ndarray) -> float:
    """F1 (%) of the change class (index 1), open-cd's LEVIR/WHU headline."""
    tp = area_intersect[1]
    precision = tp / max(pred_area[1], 1e-12)
    recall = tp / max(label_area[1], 1e-12)
    return float(2 * precision * recall / max(precision + recall, 1e-12) * 100)
