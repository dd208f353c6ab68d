"""The port's detection mAP and DOTA merge (`mtp_tpu_torch/eval/det_map.py`,
a numpy copy) against `mtp_tpu.eval.det_map` on the same detections: equal
numbers, since both run the same numpy arithmetic around their IoU, and
byte-for-byte equal submission files.  Rotated and quadrilateral IoU are
the port's plain PyTorch versions and JAX's (its C++ kernel where built,
else jnp), which differ in the last bits: the rotated inputs keep every
IoU that the AP matching or the merge's NMS compares at least 1e-4 from
its threshold (asserted), so that no decision rests on those bits."""

import os

import numpy as np
import pytest

from mtp_tpu.eval import det_map as jmap
from mtp_tpu_torch.eval import det_map as pmap

MARGIN = 1e-4


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


# ---------------------------------------------------------------- rotated --

def _rotated_per_image(seed, n_images=5, num_classes=4, ignore=False):
    """Rotated gts (le90 angles off ±π/2), detections near them (jittered
    centres, sides and angles), duplicates and strays."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_images):
        n_gt = rng.integers(1, 7)
        gt = np.concatenate([rng.uniform(30, 270, (n_gt, 2)), rng.uniform(12, 60, (n_gt, 2)),
                             rng.uniform(-1.4, 1.4, (n_gt, 1))], -1)
        gl = rng.integers(0, num_classes, n_gt)
        near = gt + np.concatenate([rng.normal(0, 4, (n_gt, 2)), rng.normal(0, 3, (n_gt, 2)),
                                    rng.normal(0, 0.08, (n_gt, 1))], -1)
        strays = np.concatenate([rng.uniform(0, 300, (3, 2)), rng.uniform(10, 40, (3, 2)),
                                 rng.uniform(-1.4, 1.4, (3, 1))], -1)
        det = np.concatenate([near, gt[: n_gt // 2], strays]).astype(np.float32)
        dl = np.concatenate([gl, gl[: n_gt // 2], rng.integers(0, num_classes, 3)])
        rec = {"det_boxes": det, "det_scores": rng.uniform(0, 1, len(det)).astype(np.float32),
               "det_labels": dl, "gt_boxes": gt.astype(np.float32), "gt_labels": gl}
        if ignore:
            rec["gt_ignore"] = rng.uniform(size=n_gt) < 0.3
        out.append(rec)
    return out


def _assert_margin(ious: np.ndarray, thr: float) -> None:
    assert np.abs(ious - thr).min() >= MARGIN, np.abs(ious - thr).min()


@pytest.mark.parametrize("seed,ignore,thr", [(10, False, 0.5), (11, True, 0.5),
                                             (12, False, 0.7)])
def test_rotated_eval_map_matches_jax(seed, ignore, thr):
    """The DIOR-R protocol (VOC AP at one IoU threshold with rotated IoU):
    equal mAP and per-class AP, every det-gt IoU off the threshold."""
    per_image = _rotated_per_image(seed, ignore=ignore)
    for im in per_image:
        ious = pmap.np_rbox_iou(im["det_boxes"], im["gt_boxes"])
        np.testing.assert_allclose(ious, jmap.np_rbox_iou(im["det_boxes"], im["gt_boxes"]),
                                   atol=2e-6)
        _assert_margin(ious, thr)
    got = pmap.eval_map(per_image, 4, thr, rotated=True)
    assert got == jmap.eval_map(per_image, 4, thr, rotated=True)
    assert 0.0 < got["mAP"] <= 100.0
    assert got != pmap.eval_map(per_image, 4, thr)   # not the horizontal protocol


def _patches(seed, box_type):
    """Detections of 4 patches of two images (ids in mmrotate's split form,
    one at another rate), near-duplicates across the patches' overlaps."""
    rng = np.random.default_rng(seed)
    per_patch = {}
    for pid, (xo, yo) in (("P0001__1.0__0___0", (0, 0)), ("P0001__1.0__512___0", (512, 0)),
                          ("P0001__0.5__0___512", (0, 512)), ("P0002__1.0__0___0", (0, 0))):
        n = 12
        rb = np.concatenate([rng.uniform(380, 620, (n, 2)) - (xo, yo),
                             rng.uniform(16, 80, (n, 2)), rng.uniform(-1.4, 1.4, (n, 1))], -1)
        rb[n // 2:] = rb[: n // 2] + np.concatenate([rng.normal(0, 3, (n // 2, 2)),
                                                     rng.normal(0, 2, (n // 2, 2)),
                                                     rng.normal(0, 0.05, (n // 2, 1))], -1)
        boxes = rb if box_type == "rbox" else pmap.rbox_to_quad_np(rb)
        per_patch[pid] = {"det_boxes": boxes.astype(np.float32),
                          "det_scores": rng.uniform(0, 1, n).astype(np.float32),
                          "det_labels": rng.integers(0, 3, n)}
    return per_patch


@pytest.mark.parametrize("box_type,rescale", [("rbox", False), ("rbox", True),
                                              ("qbox", False)])
def test_merge_dota_patches_matches_jax(box_type, rescale):
    """Offsets back to the full image, the rate's rescale, per-class greedy
    NMS at 0.1 with the IoU of the box type, the top max_per_img: the same
    arrays, with every NMS IoU off the threshold."""
    per_patch = _patches(20, box_type)
    iou = pmap.np_quad_iou if box_type == "qbox" else pmap.np_rbox_iou
    shifted = pmap.merge_dota_patches(per_patch, 3, nms_iou=1.1, max_per_img=10 ** 6,
                                      rescale_by_rate=rescale, box_type=box_type)
    for det in shifted.values():
        for c in range(3):
            b = det["det_boxes"][det["det_labels"] == c]
            _assert_margin(iou(b, b), 0.1)
    got = pmap.merge_dota_patches(per_patch, 3, rescale_by_rate=rescale, box_type=box_type,
                                  max_per_img=20)
    want = jmap.merge_dota_patches(per_patch, 3, rescale_by_rate=rescale, box_type=box_type,
                                   max_per_img=20)
    assert sorted(got) == sorted(want) == ["P0001", "P0002"]
    for k in want:
        for f in ("det_boxes", "det_scores", "det_labels"):
            np.testing.assert_array_equal(got[k][f], want[k][f], err_msg=f"{k} {f}")
    assert len(got["P0001"]["det_scores"]) < 36      # the merge suppressed some
    for pid in ("P0006__1.0__0___512", "P0006__0.5__1024___0", "plain_id"):
        assert pmap.parse_patch_id(pid) == jmap.parse_patch_id(pid)


def _tree(root):
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(root) for f in files}


@pytest.mark.parametrize("box_type", ["rbox", "qbox"])
def test_submission_writers_match_jax_byte_for_byte(tmp_path, box_type):
    """`write_dota_submission` (per-class txt files and their zip) and
    `write_fair1m_submission` (an xml an image) write the same bytes."""
    results = pmap.merge_dota_patches(_patches(21, box_type), 3, box_type=box_type)
    results["P0009"] = {"det_boxes": np.zeros((0, 5)), "det_scores": np.zeros(0),
                        "det_labels": np.zeros(0, np.int64)}
    names = ["plane", "ship", "storage-tank"]
    np.testing.assert_array_equal(pmap.rbox_to_quad_np(_patches(22, "rbox")["P0002__1.0__0___0"]
                                                       ["det_boxes"]),
                                  jmap.rbox_to_quad_np(_patches(22, "rbox")["P0002__1.0__0___0"]
                                                       ["det_boxes"]))
    trees = []
    for side, mod in (("port", pmap), ("jax", jmap)):
        root = tmp_path / side
        mod.write_dota_submission(results, names, str(root / "dota"), str(root / "dota.zip"))
        mod.write_fair1m_submission(results, names, str(root / "fair1m"))
        trees.append(_tree(str(root / "dota")) | _tree(str(root / "fair1m")))
        trees[-1]["zip names"] = __import__("zipfile").ZipFile(root / "dota.zip").namelist()
    assert trees[0] == trees[1]
    assert len([k for k in trees[0] if k.endswith(".xml")]) == 3
