"""The port's VOC-style detection mAP (`mtp_tpu_torch/eval/det_map.py`, a
numpy copy) against `mtp_tpu.eval.det_map` on the same detections: equal
numbers, since both run the same numpy arithmetic."""

import numpy as np
import pytest

from mtp_tpu.eval import det_map as jmap
from mtp_tpu_torch.eval import det_map as pmap


def _per_image(seed, n_images=6, num_classes=5, ignore=False):
    """Detections near the gts (true positives at several IoUs), duplicates
    and strays, over images with and without gts of each class."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_images):
        n_gt = rng.integers(0, 7)
        xy = rng.uniform(0, 200, (n_gt, 2))
        gt = np.concatenate([xy, xy + rng.uniform(10, 60, (n_gt, 2))], -1)
        gl = rng.integers(0, num_classes, n_gt)
        jitter = rng.normal(0, 6, (n_gt, 4))
        strays_xy = rng.uniform(0, 200, (4, 2))
        strays = np.concatenate([strays_xy, strays_xy + 20], -1)
        det = np.concatenate([gt + jitter, gt[: n_gt // 2], strays]).astype(np.float32)
        dl = np.concatenate([gl, gl[: n_gt // 2], rng.integers(0, num_classes, 4)])
        rec = {"det_boxes": det, "det_scores": rng.uniform(0, 1, len(det)).astype(np.float32),
               "det_labels": dl, "gt_boxes": gt.astype(np.float32), "gt_labels": gl}
        if ignore:
            rec["gt_ignore"] = rng.uniform(size=n_gt) < 0.3
        out.append(rec)
    return out


@pytest.mark.parametrize("seed,ignore,mode,thr", [(0, False, "area", 0.5),
                                                  (1, True, "area", 0.5),
                                                  (2, False, "11points", 0.5),
                                                  (3, True, "area", 0.75)])
def test_eval_map_matches_jax(seed, ignore, mode, thr):
    per_image = _per_image(seed, ignore=ignore)
    got = pmap.eval_map(per_image, 5, thr, mode=mode)
    want = jmap.eval_map(per_image, 5, thr, mode=mode)
    assert got == want
    assert 0.0 < got["mAP"] <= 100.0


def test_iou_tpfp_and_ap_match_jax():
    rng = np.random.default_rng(7)
    a = _per_image(7)[0]["det_boxes"]
    b = _per_image(8)[1]["gt_boxes"]
    np.testing.assert_array_equal(pmap.np_bbox_iou(a, b), jmap.np_bbox_iou(a, b))
    assert pmap.np_bbox_iou(a[:0], b).shape == (0, len(b))
    ign = rng.uniform(size=len(b)) < 0.3
    scores = rng.uniform(size=len(a))
    for got, want in zip(pmap.tpfp(a, scores, b, ign, 0.5, pmap.np_bbox_iou),
                         jmap.tpfp(a, scores, b, ign, 0.5, jmap.np_bbox_iou)):
        np.testing.assert_array_equal(got, want)
    rec = np.sort(rng.uniform(size=20))
    prec = rng.uniform(size=20)
    for mode in ("area", "11points"):
        assert pmap.average_precision(rec, prec, mode) == \
            jmap.average_precision(rec, prec, mode)


def test_rotated_waits_for_slice_3b():
    with pytest.raises(NotImplementedError, match="3b"):
        pmap.eval_map([], 3, rotated=True)
