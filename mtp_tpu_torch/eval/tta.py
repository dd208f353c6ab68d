"""Test-time augmentation for detection: multi-scale + flip, merged with NMS
(the port's copy of `mtp_tpu/eval/tta.py`).

Capability parity with the reference's mmrotate-0.3.4 multi-scale DOTA
protocol (`MultiScaleFlipAug` in mmrotate0.3.4/configs/mtp/*: test over
several rescales and horizontal flip, merge detections in original
coordinates with rotated NMS).  Host-driven: each (scale, flip) combination
calls the one predictor; merging runs on host numpy.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from mtp_tpu_torch.eval.det_map import np_bbox_iou, np_rbox_iou


def _resize_batch(images: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    from PIL import Image
    out = np.zeros((len(images),) + size + (images.shape[-1],), np.float32)
    for i, im in enumerate(images):
        pil = Image.fromarray(im.astype(np.uint8) if im.dtype != np.uint8 else im)
        out[i] = np.asarray(pil.resize(size[::-1], Image.BILINEAR),
                            np.float32)
    return out


def _unmap_boxes(boxes: np.ndarray, sx: float, sy: float, flipped: bool,
                 Wr: int, rotated: bool) -> np.ndarray:
    """Map detections from the (resized-to-(Hr,Wr), maybe-flipped) view back
    to original coordinates.  `sx`/`sy` are the ACTUAL per-axis factors
    (Wr/W, Hr/H) — `int(W*scale)` truncation means the nominal scale is not
    exact.  Flip unmaps against the resized width Wr, not W*scale.
    Rotated w/h unscale by sqrt(sx·sy), angle kept (mmrotate RResize
    convention for anisotropic factors)."""
    b = boxes.copy()
    if rotated:
        if flipped:
            b[:, 0] = Wr - b[:, 0]
            b[:, 4] = -b[:, 4]
        b[:, 0] /= sx
        b[:, 1] /= sy
        b[:, 2:4] /= np.sqrt(sx * sy)
    else:
        if flipped:
            x1 = Wr - b[:, 2]
            x2 = Wr - b[:, 0]
            b[:, 0], b[:, 2] = x1, x2
        b[:, [0, 2]] /= sx
        b[:, [1, 3]] /= sy
    return b


def _nms_host(boxes: np.ndarray, scores: np.ndarray, iou_thr: float,
              rotated: bool, max_out: int) -> np.ndarray:
    order = np.argsort(-scores)
    boxes, idx = boxes[order], order
    iou = np_rbox_iou(boxes, boxes) if rotated else np_bbox_iou(boxes, boxes)
    alive = np.ones(len(boxes), bool)
    keep = []
    for i in range(len(boxes)):
        if not alive[i]:
            continue
        keep.append(idx[i])
        if len(keep) >= max_out:
            break
        sup = iou[i] > iou_thr
        sup[:i + 1] = False
        alive &= ~sup
    return np.asarray(keep, np.int64)


def tta_detect(predict: Callable[[np.ndarray], dict], images: np.ndarray,
               scales: Sequence[float] = (1.0,), flip: bool = True,
               rotated: bool = False, nms_iou: float = 0.1,
               max_per_img: int = 2000, num_classes: int = 1) -> List[dict]:
    """predict(images) → per-image unpadded dict {det_boxes, det_scores,
    det_labels} at the *augmented* resolution.  Returns merged per-image
    detections in original coordinates."""
    B, H, W, _ = images.shape
    per_image: List[Dict[str, list]] = [
        {"det_boxes": [], "det_scores": [], "det_labels": []}
        for _ in range(B)]
    variants = [(s, f) for s in scales for f in ((False, True) if flip
                                                 else (False,))]
    for scale, flipped in variants:
        imgs = images
        Hr, Wr = H, W
        if scale != 1.0:
            Hr, Wr = int(H * scale), int(W * scale)
            imgs = _resize_batch(images, (Hr, Wr))
        sx, sy = Wr / W, Hr / H
        if flipped:
            imgs = imgs[:, :, ::-1].copy()
        dets = predict(imgs)
        for i, d in enumerate(dets):
            if len(d["det_boxes"]) == 0:
                continue
            b = _unmap_boxes(d["det_boxes"], sx, sy, flipped, Wr, rotated)
            per_image[i]["det_boxes"].append(b)
            per_image[i]["det_scores"].append(d["det_scores"])
            per_image[i]["det_labels"].append(d["det_labels"])

    out = []
    for rec in per_image:
        if not rec["det_boxes"]:
            dim = 5 if rotated else 4
            out.append({"det_boxes": np.zeros((0, dim), np.float32),
                        "det_scores": np.zeros(0, np.float32),
                        "det_labels": np.zeros(0, np.int64)})
            continue
        boxes = np.concatenate(rec["det_boxes"])
        scores = np.concatenate(rec["det_scores"])
        labels = np.concatenate(rec["det_labels"])
        keep_b, keep_s, keep_l = [], [], []
        for c in range(num_classes):
            m = labels == c
            if not m.any():
                continue
            k = _nms_host(boxes[m], scores[m], nms_iou, rotated, max_per_img)
            keep_b.append(boxes[m][k])
            keep_s.append(scores[m][k])
            keep_l.append(np.full(len(k), c, np.int64))
        boxes = np.concatenate(keep_b) if keep_b else np.zeros((0, boxes.shape[1]))
        scores = np.concatenate(keep_s) if keep_s else np.zeros(0)
        labels = np.concatenate(keep_l) if keep_l else np.zeros(0, np.int64)
        order = np.argsort(-scores)[:max_per_img]
        out.append({"det_boxes": boxes[order].astype(np.float32),
                    "det_scores": scores[order].astype(np.float32),
                    "det_labels": labels[order]})
    return out
