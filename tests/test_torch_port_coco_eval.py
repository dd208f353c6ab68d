"""The port's COCO evaluation (`mtp_tpu_torch/eval/coco_eval.py`, a numpy
copy with the dense float64 mask IoU) against the JAX package's
`evaluate_coco` and `evaluate_coco_bbox_segm` on seeded scenes: several
classes and images, crowd and ignored gts, given gt areas, images with no
detections or no gts or neither, detections of one class only, and masks
for segm; the maxDets sweep of the default (1, 10, 100) and of others.
Every one of the 12 stats (and the 12 segm ones) within 1e-12: the same
float64 numpy arithmetic on both sides."""

import numpy as np
import pytest

from mtp_tpu.eval import coco_eval as jcoco
from mtp_tpu_torch.eval import coco_eval as pcoco
from mtp_tpu_torch.eval.masks import paste_masks

TOL = 1e-12
STATS = ["mAP", "AP50", "AP75", "AP_s", "AP_m", "AP_l", "AR_s", "AR_m", "AR_l",
         "AR@1", "AR@10", "AR@100"]


def _boxes(rng, n, hw, lo=4, hi=160):
    wh = np.exp(rng.uniform(np.log(lo), np.log(hi), (n, 2)))
    xy = rng.uniform(0, 1, (n, 2)) * (np.array(hw[::-1]) - wh).clip(1)
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def scene(seed: int, n_img: int = 6, K: int = 4, hw=(96, 128), masks: bool = False,
          crowd: bool = True, ignore: bool = False, areas: bool = False):
    """Per-image dicts: gts of K classes (some crowd, some ignored), and
    detections near them (jittered copies) plus false positives, with
    uniform scores; image 0 has no detections, image 1 no gts, image 2
    neither."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_img):
        G = 0 if i in (1, 2) else int(rng.integers(1, 9))
        gt = _boxes(rng, G, hw)
        gl = rng.integers(0, K, G)
        D = 0 if i in (0, 2) else int(rng.integers(3, 40))
        src = rng.integers(0, max(G, 1), D)
        jitter = rng.normal(0, 0.15, (D, 4)) * np.tile(
            (gt[src, 2:] - gt[src, :2]) if G else np.full((D, 2), 20.0), 2)
        dt = (gt[src] if G else _boxes(rng, D, hw)) + jitter
        fp = rng.uniform(size=D) < 0.3
        dt[fp] = _boxes(rng, int(fp.sum()), hw)
        dt[:, 2:] = np.maximum(dt[:, 2:], dt[:, :2] + 1)
        dl = np.where(rng.uniform(size=D) < 0.8, gl[src] if G else 0, rng.integers(0, K, D))
        rec = {"det_boxes": dt.astype(np.float32),
               "det_scores": rng.uniform(size=D).astype(np.float32),
               "det_labels": dl.astype(np.int64),
               "gt_boxes": gt, "gt_labels": gl.astype(np.int64)}
        if crowd:
            rec["gt_crowd"] = rng.uniform(size=G) < 0.2
        if ignore:
            rec["gt_ignore"] = rng.uniform(size=G) < 0.2
        if areas:
            rec["gt_areas"] = rng.uniform(10, 96 ** 2 * 1.5, G)
        if masks:  # a detection's mask: its source gt's, with noise
            crops = (rng.uniform(size=(G, 28, 28)) > 0.3).astype(np.float32)
            base = crops[src] if G else np.full((D, 28, 28), 0.5, np.float32)
            probs = (0.7 * base + 0.5 * rng.uniform(size=(D, 28, 28))).clip(0, 1)
            rec["det_masks"] = paste_masks(probs.astype(np.float32), rec["det_boxes"], *hw)
            rec["gt_masks"] = paste_masks(crops, gt, *hw)
        out.append(rec)
    return out


def _same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL, err_msg=k)


@pytest.mark.parametrize("kw", [dict(), dict(crowd=False), dict(ignore=True),
                                dict(areas=True), dict(K=1, n_img=3)],
                         ids=["crowd", "plain", "ignored", "gt_areas", "one_class"])
def test_bbox_stats_match_jax(kw):
    imgs = scene(1, **kw)
    K = kw.get("K", 4)
    got = pcoco.evaluate_coco(imgs, K)
    assert set(got) == set(STATS)
    _same(got, jcoco.evaluate_coco(imgs, K))


@pytest.mark.parametrize("max_dets", [(1, 10, 100), (100,), (1, 5, 20)])
def test_the_max_dets_sweep_matches_jax(max_dets):
    imgs = scene(2)
    _same(pcoco.evaluate_coco(imgs, 4, max_dets=max_dets),
          jcoco.evaluate_coco(imgs, 4, max_dets=max_dets))


def test_bbox_and_segm_stats_match_jax():
    """The 12 bbox and 12 segm stats (`segm_` keys), crowd gts included:
    the mask IoU's denominator is the detection's area for a crowd gt."""
    imgs = scene(3, masks=True)
    got = pcoco.evaluate_coco_bbox_segm(imgs, 4)
    assert set(got) == set(STATS) | {f"segm_{k}" for k in STATS}
    _same(got, jcoco.evaluate_coco_bbox_segm(imgs, 4))


def test_mask_iou_is_the_dense_product():
    rng = np.random.default_rng(4)
    dt = (rng.uniform(size=(5, 20, 24)) > 0.5).astype(np.uint8)
    gt = (rng.uniform(size=(3, 20, 24)) > 0.5).astype(np.uint8)
    crowd = np.array([False, True, False])
    iou, ad, ag = pcoco._mask_iou_crowd(dt, gt, crowd)
    inter = (dt[:, None] & gt[None]).sum((2, 3))
    union = np.where(crowd[None], dt.sum((1, 2))[:, None],
                     dt.sum((1, 2))[:, None] + gt.sum((1, 2))[None] - inter)
    np.testing.assert_array_equal(iou, inter / union)
    np.testing.assert_array_equal(ad, dt.sum((1, 2)))
    np.testing.assert_array_equal(ag, gt.sum((1, 2)))


def test_no_images_and_no_gts():
    """No gt of any class: every stat -1, as pycocotools reports."""
    for imgs in ([], [{**scene(5)[1]}]):
        got = pcoco.evaluate_coco(imgs, 3)
        _same(got, jcoco.evaluate_coco(imgs, 3))
        assert all(v == -1.0 for v in got.values())
