"""Full COCO-protocol evaluation, bbox and segm, in numpy on the host (the
port's copy of `mtp_tpu/eval/coco_eval.py`).

It follows the pycocotools COCOeval semantics the reference IS metric uses
(instance_segmentation/metric.py:22 evaluates ['bbox','segm'] via
COCOeval; summarize :448-520): greedy per-category matching with crowd
re-matching and ignore propagation, area-range gt/det filtering, the
maxDets sweep, 101-point interpolated precision, and the standard 12-stat
summary (AP, AP50, AP75, AP_s/m/l, AR@1/10/100, AR_s/m/l).

Inputs are per-image dicts of unpadded numpy arrays (the framework's eval
interchange format) rather than COCO json.  Mask IoU is the dense float64
product; the JAX package's packed-popcount native fast path is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# pycocotools defaults
IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _bbox_iou_crowd(dt: np.ndarray, gt: np.ndarray,
                    crowd: np.ndarray) -> np.ndarray:
    """IoU (D, G); for crowd gts the denominator is the det area only
    (pycocotools maskUtils.iou iscrowd semantics)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)), np.float64)
    lt = np.maximum(dt[:, None, :2], gt[None, :, :2])
    rb = np.minimum(dt[:, None, 2:4], gt[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    ad = (dt[:, 2] - dt[:, 0]) * (dt[:, 3] - dt[:, 1])
    ag = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    union = np.where(crowd[None, :], ad[:, None],
                     ad[:, None] + ag[None, :] - inter)
    return inter / np.maximum(union, 1e-12)


def _mask_iou_crowd(dt: np.ndarray, gt: np.ndarray, crowd: np.ndarray):
    """(IoU (D, G), det areas (D,), gt areas (G,)) for binary masks
    dt (D, H, W), gt (G, H, W): intersections as one float64 product."""
    if len(dt) == 0 or len(gt) == 0:
        ad = dt.sum(axis=(1, 2)).astype(np.float64) \
            if dt.ndim == 3 else np.zeros(len(dt))
        ag = gt.sum(axis=(1, 2)).astype(np.float64) \
            if gt.ndim == 3 else np.zeros(len(gt))
        return np.zeros((len(dt), len(gt)), np.float64), ad, ag
    d = dt.reshape(len(dt), -1).astype(np.float64)
    g = gt.reshape(len(gt), -1).astype(np.float64)
    inter = d @ g.T
    ad = d.sum(1)
    ag = g.sum(1)
    union = np.where(crowd[None, :], ad[:, None],
                     ad[:, None] + ag[None, :] - inter)
    return inter / np.maximum(union, 1e-12), ad, ag


def _match_img(ious: np.ndarray, dt_scores: np.ndarray, dt_areas: np.ndarray,
               gt_ignore: np.ndarray, gt_crowd: np.ndarray,
               area_rng: Tuple[float, float],
               gt_areas: np.ndarray) -> dict:
    """pycocotools COCOeval.evaluateImg for one (image, category): greedy
    matching per IoU threshold, ignored gts sorted last, crowd gts
    re-matchable, unmatched out-of-area dets ignored.

    dts must arrive score-sorted (desc) and maxDet-truncated."""
    T = len(IOU_THRS)
    D, G = ious.shape
    gt_ig = gt_ignore | (gt_areas < area_rng[0]) | (gt_areas > area_rng[1])
    # ignored gts last, stable
    gorder = np.argsort(gt_ig, kind="stable")
    gt_ig = gt_ig[gorder]
    crowd = gt_crowd[gorder]
    ious = ious[:, gorder] if G else ious

    dtm = np.zeros((T, D), np.int64)  # 1 + matched gt index, 0 = unmatched
    dt_ig = np.zeros((T, D), bool)
    gtm = np.zeros((T, G), bool)
    for t in range(T):
        thr = min(IOU_THRS[t], 1.0 - 1e-10)
        for d in range(D):
            best, m = thr, -1
            for g in range(G):
                if gtm[t, g] and not crowd[g]:
                    continue
                # gts are sorted non-ignored first: once we hold a
                # non-ignored match, stop at the first ignored gt
                if m > -1 and not gt_ig[m] and gt_ig[g]:
                    break
                if ious[d, g] < best:
                    continue
                best, m = ious[d, g], g
            if m == -1:
                continue
            dt_ig[t, d] = gt_ig[m]
            dtm[t, d] = m + 1
            gtm[t, m] = True
    out_of_area = (dt_areas < area_rng[0]) | (dt_areas > area_rng[1])
    dt_ig |= (dtm == 0) & out_of_area[None, :]
    return {"dtm": dtm, "dt_ig": dt_ig, "scores": dt_scores,
            "npig": int((~gt_ig).sum())}


def evaluate_coco(per_image: Sequence[dict], num_classes: int,
                  iou_type: str = "bbox",
                  max_dets: Sequence[int] = (1, 10, 100)) -> Dict[str, float]:
    """per_image: {'det_boxes' (N,4 x1y1x2y2), 'det_scores', 'det_labels',
    'gt_boxes' (G,4), 'gt_labels', optional 'gt_crowd' (G,) bool,
    'gt_ignore' (G,) bool, 'gt_areas' (G,); for iou_type='segm' also
    'det_masks' (N,H,W) and 'gt_masks' (G,H,W) binary}.

    Returns the COCOeval 12-stat summary (percent scale) with 'mAP' as the
    headline AP@[.5:.95] alias."""
    max_dets = sorted(max_dets)
    max_det = max_dets[-1]
    area_names = list(AREA_RNGS)
    A, M, T, R = len(area_names), len(max_dets), len(IOU_THRS), len(REC_THRS)

    # -stats[t, r, k, a, m]
    precision = -np.ones((T, R, num_classes, A, M))
    recall = -np.ones((T, num_classes, A, M))

    # per (cat, area): list over images of match records (at maxDet trunc)
    for c in range(num_classes):
        # gather per-image, per-category det/gt slices once
        recs_per_area: List[List[dict]] = [[] for _ in range(A)]
        for im in per_image:
            dm = np.asarray(im["det_labels"]) == c
            gm = np.asarray(im["gt_labels"]) == c
            scores = np.asarray(im["det_scores"])[dm]
            order = np.argsort(-scores, kind="mergesort")[:max_det]
            scores = scores[order]
            boxes = np.asarray(im["det_boxes"])[dm][order]
            g_boxes = np.asarray(im["gt_boxes"])[gm]
            G = len(g_boxes)
            crowd = np.asarray(im["gt_crowd"])[gm] if "gt_crowd" in im \
                else np.zeros(G, bool)
            ignore = np.asarray(im["gt_ignore"])[gm] if "gt_ignore" in im \
                else np.zeros(G, bool)
            ignore = ignore | crowd  # crowd ⇒ ignore (COCOeval._prepare)
            if iou_type == "segm":
                d_masks = np.asarray(im["det_masks"])[dm][order]
                g_masks = np.asarray(im["gt_masks"])[gm]
                ious, d_areas, g_areas = _mask_iou_crowd(d_masks, g_masks,
                                                         crowd)
            else:
                ious = _bbox_iou_crowd(boxes, g_boxes, crowd)
                d_areas = ((boxes[:, 2] - boxes[:, 0])
                           * (boxes[:, 3] - boxes[:, 1])) if len(boxes) \
                    else np.zeros(0)
                g_areas = ((g_boxes[:, 2] - g_boxes[:, 0])
                           * (g_boxes[:, 3] - g_boxes[:, 1])) if G \
                    else np.zeros(0)
            if "gt_areas" in im:
                g_areas = np.asarray(im["gt_areas"])[gm].astype(np.float64)
            for a, name in enumerate(area_names):
                recs_per_area[a].append(_match_img(
                    ious, scores, d_areas, ignore, crowd,
                    AREA_RNGS[name], g_areas))

        for a in range(A):
            recs = recs_per_area[a]
            npig = sum(r["npig"] for r in recs)
            if npig == 0:
                continue
            for mi, md in enumerate(max_dets):
                scores = np.concatenate([r["scores"][:md] for r in recs])
                dtm = np.concatenate([r["dtm"][:, :md] for r in recs], 1)
                dt_ig = np.concatenate([r["dt_ig"][:, :md] for r in recs], 1)
                order = np.argsort(-scores, kind="mergesort")
                dtm, dt_ig = dtm[:, order], dt_ig[:, order]
                tps = (dtm > 0) & ~dt_ig
                fps = (dtm == 0) & ~dt_ig
                tp_c = np.cumsum(tps, 1).astype(np.float64)
                fp_c = np.cumsum(fps, 1).astype(np.float64)
                for t in range(T):
                    tp, fp = tp_c[t], fp_c[t]
                    rc = tp / npig
                    pr = tp / np.maximum(tp + fp, np.spacing(1))
                    recall[t, c, a, mi] = rc[-1] if len(rc) else 0.0
                    # precision envelope (monotone decreasing from the right)
                    q = np.zeros(R)
                    pr = pr.tolist()
                    for i in range(len(pr) - 1, 0, -1):
                        if pr[i] > pr[i - 1]:
                            pr[i - 1] = pr[i]
                    inds = np.searchsorted(rc, REC_THRS, side="left")
                    for ri, pi in enumerate(inds):
                        if pi < len(pr):
                            q[ri] = pr[pi]
                    precision[t, :, c, a, mi] = q

    def _ap(t=None, area="all", md=max_det):
        a = area_names.index(area)
        mi = max_dets.index(md)
        s = precision[:, :, :, a, mi] if t is None \
            else precision[[t], :, :, a, mi]
        s = s[s > -1]
        return float(s.mean() * 100) if s.size else -1.0

    def _ar(area="all", md=max_det):
        a = area_names.index(area)
        mi = max_dets.index(md)
        s = recall[:, :, a, mi]
        s = s[s > -1]
        return float(s.mean() * 100) if s.size else -1.0

    out = {
        "mAP": _ap(),
        "AP50": _ap(t=0),
        "AP75": _ap(t=5),
        "AP_s": _ap(area="small"),
        "AP_m": _ap(area="medium"),
        "AP_l": _ap(area="large"),
        "AR_s": _ar(area="small"),
        "AR_m": _ar(area="medium"),
        "AR_l": _ar(area="large"),
    }
    # the maxDets recall sweep (AR@1/AR@10/AR@100 with the default sweep)
    for md in max_dets:
        out[f"AR@{md}"] = _ar(md=md)
    return out


def evaluate_coco_bbox_segm(per_image: Sequence[dict], num_classes: int,
                            max_dets: Sequence[int] = (1, 10, 100)
                            ) -> Dict[str, float]:
    """Both metrics of the reference IS evaluation
    (instance_segmentation/metric.py:22: metric=['bbox','segm']); segm keys
    are prefixed 'segm_'."""
    out = evaluate_coco(per_image, num_classes, "bbox", max_dets)
    if per_image and "det_masks" in per_image[0]:
        segm = evaluate_coco(per_image, num_classes, "segm", max_dets)
        out.update({f"segm_{k}": v for k, v in segm.items()})
    return out
