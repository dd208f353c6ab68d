"""Detection mAP on the host and the DOTA patch merge (the port's numpy
copy of `mtp_tpu/eval/det_map.py`: `np_bbox_iou`, `np_rbox_iou`,
`np_quad_iou`, `average_precision`, `tpfp`, `eval_map` (VOC-style, for
horizontal and rotated boxes), `parse_patch_id`, `merge_dota_patches`,
`rbox_to_quad_np` and the DOTA and FAIR1M submission writers).  Rotated
and quadrilateral IoU are the port's plain versions on CPU tensors; the
COCO protocol is `eval/coco_eval.py`."""

from __future__ import annotations

import os
import re
import zipfile
from collections import defaultdict
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from mtp_tpu_torch.ops.rotated_boxes import quad_overlaps, rbox_overlaps_ref


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


def _on_cpu(fn, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    return fn(t(a), t(b)).numpy()


def np_rbox_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotated IoU of (N, 5) and (M, 5) rboxes on the host, fp32 (the plain
    `rbox_overlaps`)."""
    return _on_cpu(rbox_overlaps_ref, a, b)


def np_quad_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of convex quadrilaterals (N, 8) and (M, 8) on the host, fp32 (the
    nms_quadri path of the reference merge, rotated_detection/metric.py:533)."""
    return _on_cpu(quad_overlaps, a, b)


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
    class, -1 for a class with no gt]}, VOC-style at one IoU threshold (the
    DIOR-R / DOTA protocol with rotated boxes)."""
    iou_fn = np_rbox_iou if rotated else np_bbox_iou
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
                          im["gt_boxes"][gm], gt_ign, iou_thr, iou_fn)
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


# ---------------------------------------------------------------------------
# DOTA patch merge + submission
# ---------------------------------------------------------------------------

_XY_RX = re.compile(r"__(\d+)___(\d+)")


def parse_patch_id(img_id: str) -> Tuple[str, int, int, float]:
    """mmrotate split ids 'P0006__1.0__0___512' → (base, x_off, y_off,
    rate): base is everything before the first '__', the offsets the first
    '__x___y' group (so every scale of an image merges under one base), the
    rate the second segment when there are four (else 1.0)."""
    base = img_id.split("__", 1)[0]
    m = _XY_RX.search(img_id)
    if not m:
        return img_id, 0, 0, 1.0
    rate = 1.0
    segs = img_id.split("__")
    if len(segs) >= 4:
        try:
            rate = float(segs[1])
        except ValueError:
            rate = 1.0
    return base, int(m.group(1)), int(m.group(2)), rate


def merge_dota_patches(per_patch: Dict[str, dict], num_classes: int,
                       nms_iou: float = 0.1, max_per_img: int = 2000,
                       rescale_by_rate: bool = False,
                       box_type: str = "rbox") -> Dict[str, dict]:
    """Patch detections moved to full-image coordinates, then per-class
    greedy NMS per image (`> nms_iou` suppresses) and the top `max_per_img`
    by score.  box_type 'rbox' ((cx, cy, w, h, θ), nms_rotated) or 'qbox'
    ((x1..y4) polygons, nms_quadri: FAIR1M's multi-scale protocol).
    `rescale_by_rate` also divides a `base__rate__x___y` patch's boxes by
    its rate (the reference merge adds offsets only)."""
    dim = 8 if box_type == "qbox" else 5
    iou_fn = np_quad_iou if box_type == "qbox" else np_rbox_iou
    merged: Dict[str, list] = defaultdict(list)
    for pid, det in per_patch.items():
        base, xo, yo, rate = parse_patch_id(pid)
        boxes = det["det_boxes"].copy()
        if len(boxes):
            if box_type == "qbox":
                boxes[:, 0::2] += xo
                boxes[:, 1::2] += yo
                if rescale_by_rate and rate != 1.0:
                    boxes /= rate
            else:
                boxes[:, 0] += xo
                boxes[:, 1] += yo
                if rescale_by_rate and rate != 1.0:
                    boxes[:, :4] /= rate
        merged[base].append((boxes, det["det_scores"], det["det_labels"]))

    out = {}
    for base, items in merged.items():
        boxes = np.concatenate([b for b, _, _ in items]) if items else np.zeros((0, dim))
        scores = np.concatenate([s for _, s, _ in items]) if items else np.zeros(0)
        labels = (np.concatenate([l for _, _, l in items]) if items
                  else np.zeros(0, np.int64))
        keep_b, keep_s, keep_l = [], [], []
        for c in range(num_classes):
            m = labels == c
            if not m.any():
                continue
            b, s = boxes[m], scores[m]
            order = np.argsort(-s)
            b, s = b[order], s[order]
            ious = iou_fn(b, b)
            alive = np.ones(len(b), bool)
            for i in range(len(b)):
                if not alive[i]:
                    continue
                sup = ious[i] > nms_iou
                sup[:i + 1] = False
                alive &= ~sup
            keep_b.append(b[alive])
            keep_s.append(s[alive])
            keep_l.append(np.full(alive.sum(), c))
        if keep_b:
            b = np.concatenate(keep_b)
            s = np.concatenate(keep_s)
            l = np.concatenate(keep_l)
            order = np.argsort(-s)[:max_per_img]
            out[base] = {"det_boxes": b[order], "det_scores": s[order],
                         "det_labels": l[order]}
        else:
            out[base] = {"det_boxes": np.zeros((0, dim)), "det_scores": np.zeros(0),
                         "det_labels": np.zeros(0, np.int64)}
    return out


def rbox_to_quad_np(rb: np.ndarray) -> np.ndarray:
    """(N, 5) → (N, 8) corner polygons.  numpy, as JAX's writer computes
    them: PyTorch's fp32 sin and cos (`rbox_to_corners`) differ from
    numpy's in the last bit of some corners, and the submission files are
    held to JAX's byte for byte."""
    cx, cy, w, h, t = rb.T
    cos, sin = np.cos(t), np.sin(t)
    dx = np.stack([-w, w, w, -w], -1) * 0.5
    dy = np.stack([-h, -h, h, h], -1) * 0.5
    x = cx[:, None] + dx * cos[:, None] - dy * sin[:, None]
    y = cy[:, None] + dx * sin[:, None] + dy * cos[:, None]
    return np.stack([x, y], -1).reshape(-1, 8)


def _quads(boxes: np.ndarray) -> np.ndarray:
    """Corner polygons of rboxes, or the boxes as they are if already (N, 8)."""
    if len(boxes) == 0:
        return np.zeros((0, 8))
    return boxes if boxes.shape[1] == 8 else rbox_to_quad_np(boxes)


def write_dota_submission(results: Dict[str, dict], class_names: Sequence[str],
                          out_dir: str, zip_path: Optional[str] = None) -> None:
    """DOTA Task1 (rotated) submission: one `Task1_<class>.txt` a class of
    lines 'imgid score x1 y1 ... x4 y4', and a zip of them if `zip_path`."""
    os.makedirs(out_dir, exist_ok=True)
    files = {c: open(os.path.join(out_dir, f"Task1_{name}.txt"), "w")
             for c, name in enumerate(class_names)}
    for img_id, det in results.items():
        for q, s, l in zip(_quads(det["det_boxes"]), det["det_scores"], det["det_labels"]):
            files[int(l)].write(f"{img_id} {s:.4f} " + " ".join(f"{v:.2f}" for v in q)
                                + "\n")
    for f in files.values():
        f.close()
    if zip_path:
        with zipfile.ZipFile(zip_path, "w") as z:
            for name in class_names:
                p = os.path.join(out_dir, f"Task1_{name}.txt")
                z.write(p, os.path.basename(p))


def write_fair1m_submission(results: Dict[str, dict], class_names: Sequence[str],
                            out_dir: str) -> None:
    """FAIR1M's submission, one xml file an image (the schema of the
    reference's scripts/dota_submit_txt_to_fair1m_xml.py)."""
    import xml.etree.ElementTree as ET
    os.makedirs(out_dir, exist_ok=True)
    for img_id, det in results.items():
        root = ET.Element("annotation")
        src = ET.SubElement(root, "source")
        ET.SubElement(src, "filename").text = img_id + ".tif"
        objs = ET.SubElement(root, "objects")
        for q, s, l in zip(_quads(det["det_boxes"]), det["det_scores"], det["det_labels"]):
            o = ET.SubElement(objs, "object")
            ET.SubElement(o, "coordinate").text = "pixel"
            ET.SubElement(o, "type").text = "rectangle"
            ET.SubElement(o, "description").text = "None"
            poss = ET.SubElement(o, "possibleresult")
            ET.SubElement(poss, "name").text = class_names[int(l)]
            ET.SubElement(poss, "probability").text = f"{float(s):.4f}"
            p = ET.SubElement(o, "points")
            pts = list(q) + [q[0], q[1]]  # a closed ring
            for i in range(0, 10, 2):
                ET.SubElement(p, "point").text = f"{pts[i]:.6f},{pts[i + 1]:.6f}"
        ET.ElementTree(root).write(os.path.join(out_dir, img_id + ".xml"))
