"""VOC-style detection mAP on the host (the port's numpy copy of
`mtp_tpu/eval/det_map.py` `np_bbox_iou`, `average_precision`, `tpfp` and
`eval_map` for horizontal boxes, without the JAX fallbacks; rotated IoU,
the DOTA merge and the submission writer follow with slice 3b)."""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np


def np_bbox_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(aa[:, None] + ab[None, :] - inter, 1e-9)


def average_precision(recall: np.ndarray, precision: np.ndarray,
                      mode: str = "area") -> float:
    """mmdet 'area' mode (all-point interpolation) or '11points'."""
    if mode == "area":
        mrec = np.concatenate([[0.0], recall, [1.0]])
        mpre = np.concatenate([[0.0], precision, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = np.nonzero(mrec[1:] != mrec[:-1])[0]
        return float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())
    ap = 0.0
    for t in np.arange(0.0, 1.1, 0.1):
        p = precision[recall >= t].max() if (recall >= t).any() else 0.0
        ap += p / 11
    return float(ap)


def tpfp(det_boxes: np.ndarray, det_scores: np.ndarray,
         gt_boxes: np.ndarray, gt_ignore: np.ndarray, iou_thr: float,
         iou_fn: Callable) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy score-sorted matching (the reference `tpfp_default`): each
    detection considers only its argmax-IoU gt — a TP if that gt clears the
    threshold and is not yet covered, an FP if covered or under the
    threshold; a detection whose argmax gt is ignored counts as neither."""
    nd = len(det_boxes)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    if len(gt_boxes) == 0:
        fp[:] = 1
        return tp, fp
    matched = np.zeros(len(gt_boxes), bool)
    order = np.argsort(-det_scores)
    ious = iou_fn(det_boxes, gt_boxes)
    ious_max = ious.max(axis=1) if nd else np.zeros(0)
    ious_argmax = ious.argmax(axis=1) if nd else np.zeros(0, np.int64)
    for di in order:
        if ious_max[di] >= iou_thr:
            g = ious_argmax[di]
            if gt_ignore[g]:
                continue
            if not matched[g]:
                matched[g] = True
                tp[di] = 1
            else:
                fp[di] = 1
        else:
            fp[di] = 1
    return tp, fp


def eval_map(per_image: Sequence[dict], num_classes: int, iou_thr: float = 0.5,
             rotated: bool = False, mode: str = "area") -> Dict[str, float]:
    """per_image: [{'det_boxes', 'det_scores', 'det_labels', 'gt_boxes',
    'gt_labels', 'gt_ignore'?}] (unpadded numpy) → {"mAP": %, "AP": [% per
    class, -1 for a class with no gt]}, VOC-style at one IoU threshold."""
    if rotated:
        raise NotImplementedError("rotated mAP is slice 3b")
    aps = []
    for c in range(num_classes):
        scores_all, tp_all, fp_all = [], [], []
        n_gt = 0
        for im in per_image:
            dm = im["det_labels"] == c
            gm = im["gt_labels"] == c
            gt_ign = im.get("gt_ignore")
            gt_ign = (gt_ign[gm] if gt_ign is not None
                      else np.zeros(gm.sum(), bool))
            n_gt += int((~gt_ign).sum())
            tp, fp = tpfp(im["det_boxes"][dm], im["det_scores"][dm],
                          im["gt_boxes"][gm], gt_ign, iou_thr, np_bbox_iou)
            scores_all.append(im["det_scores"][dm])
            tp_all.append(tp)
            fp_all.append(fp)
        scores = np.concatenate(scores_all) if scores_all else np.zeros(0)
        tp = np.concatenate(tp_all) if tp_all else np.zeros(0)
        fp = np.concatenate(fp_all) if fp_all else np.zeros(0)
        order = np.argsort(-scores)
        tp_c = np.cumsum(tp[order])
        fp_c = np.cumsum(fp[order])
        rec = tp_c / max(n_gt, 1)
        prec = tp_c / np.maximum(tp_c + fp_c, 1e-9)
        aps.append(average_precision(rec, prec, mode) if n_gt else np.nan)
    valid = [a for a in aps if not np.isnan(a)]
    return {"mAP": float(np.mean(valid) * 100) if valid else 0.0,
            "AP": [float(a * 100) if not np.isnan(a) else -1 for a in aps]}
