"""The port's detection ops against the JAX package's: box overlaps and the
DeltaXYWH coder, anchors, the MaxIoU assigner (with the last-winner rule of
low-quality matches), NMS index for index (the plain version `nms_ref`,
which `chip_smoke.py` holds kernel N1 against on the card), multilevel
RoIAlign forward and its gradient with respect to the features, and the
sampler's invariants (its draws are the generator's, not JAX's bits).
Inputs are made with numpy from a seed and fed to both sides in fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.ops import assign as jassign
from mtp_tpu.ops import boxes as jboxes
from mtp_tpu.ops import nms as jnms
from mtp_tpu.ops import roi_align as jroi
from mtp_tpu.tasks import detection as jdet
from mtp_tpu_torch.ops import assign as passign
from mtp_tpu_torch.ops import boxes as pboxes
from mtp_tpu_torch.ops import nms as pnms
from mtp_tpu_torch.ops import roi_align as proi
from mtp_tpu_torch.tasks import detection as pdet

torch.set_num_threads(1)

# fp32 on both sides, the same operations in the same order; exp and log
# may differ in the last bit between XLA and PyTorch
ATOL, RTOL = 1e-6, 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def random_boxes(rng, shape, lo=0.0, hi=100.0, wh=(0.0, 40.0)):
    xy = rng.uniform(lo, hi, shape + (2,))
    size = rng.uniform(*wh, shape + (2,))
    return np.concatenate([xy, xy + size], -1).astype(np.float32)


# ------------------------------------------------------------------ boxes --

@pytest.mark.parametrize("mode", ["iou", "iof"])
def test_bbox_overlaps_matches_jax(mode):
    rng = np.random.default_rng(0)
    a, b = random_boxes(rng, (37,)), random_boxes(rng, (53,))
    a[:3, 2:] = a[:3, :2]          # zero-area boxes: the eps floor
    b[5] = b[4]
    b[6, 2:] = b[6, :2] - 1.0      # inverted: area clamps to 0
    got = pboxes.bbox_overlaps(_t(a), _t(b), mode).numpy()
    want = np.asarray(jboxes.bbox_overlaps(jnp.asarray(a), jnp.asarray(b), mode))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    batched = pboxes.bbox_overlaps(_t(np.stack([a, a])), _t(np.stack([b, b])), mode)
    np.testing.assert_array_equal(batched[1].numpy(), got)


def test_delta_coder_matches_jax():
    """encode, and decode with deltas past wh_ratio_clip (±4.135) and boxes
    past max_shape, at the RCNN's stds."""
    rng = np.random.default_rng(1)
    p, g = random_boxes(rng, (2, 64), wh=(1.0, 40.0)), random_boxes(rng, (2, 64))
    stds = (0.1, 0.1, 0.2, 0.2)
    for kw in ({}, {"stds": stds}):
        got = pboxes.delta_encode(_t(p), _t(g), **kw).numpy()
        want = np.asarray(jboxes.delta_encode(jnp.asarray(p), jnp.asarray(g), **kw))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    d = (rng.standard_normal((2, 64, 4)) * 3).astype(np.float32)
    d[0, :8, 2:] = 9.0             # clipped at log(1000 / 16)
    for kw in ({}, {"stds": stds, "max_shape": (90, 70)}):
        got = pboxes.delta_decode(_t(p), _t(d), **kw).numpy()
        want = np.asarray(jboxes.delta_decode(jnp.asarray(p), jnp.asarray(d), **kw))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=RTOL)


@pytest.mark.parametrize("hw", [(64, 64), (800, 800), (800, 112), (100, 60)])
def test_anchors_match_jax(hw):
    np.testing.assert_array_equal(pdet.anchors_for(None, hw), jdet.anchors_for(None, hw))
    assert pdet.anchor_level_sizes(hw) == jdet.anchor_level_sizes(hw)


# ----------------------------------------------------------------- assign --

def _assign_inputs(seed):
    rng = np.random.default_rng(seed)
    anchors = random_boxes(rng, (300,), wh=(4.0, 40.0))
    gts = random_boxes(rng, (2, 8), wh=(4.0, 40.0))
    valid = np.ones((2, 8), bool)
    valid[:, 5:] = False
    # image 1: gts 0 and 1 are the same box, a small one whose best anchor
    # overlaps it under pos_iou_thr: the low-quality match goes to the LAST
    # of the two (mmdet's loop order), the IoU argmax to the first
    gts[1, 0] = gts[1, 1] = [10.0, 10.0, 14.0, 13.0]
    anchors[7] = [9.0, 9.0, 15.0, 15.0]
    labels = rng.integers(0, 5, (2, 8)).astype(np.int32)
    return anchors, gts, valid, labels


@pytest.mark.parametrize("case", ["tied_gts", "no_gt_image"])
def test_max_iou_assign_matches_jax(case):
    anchors, gts, valid, labels = _assign_inputs(2)
    if case == "no_gt_image":   # image 0's gts all padding: every anchor negative
        valid[0] = False
    got = passign.max_iou_assign(_t(anchors), _t(gts), _t(valid), _t(labels))
    for b in range(2):
        want = jassign.max_iou_assign(jnp.asarray(anchors), jnp.asarray(gts[b]),
                                      jnp.asarray(valid[b]), jnp.asarray(labels[b]))
        np.testing.assert_array_equal(got.gt_inds[b].numpy(), np.asarray(want.gt_inds))
        np.testing.assert_array_equal(got.labels[b].numpy(), np.asarray(want.labels))
        np.testing.assert_allclose(got.max_ious[b].numpy(), np.asarray(want.max_ious),
                                   atol=ATOL, rtol=RTOL)
    assert int(got.gt_inds[1, 7]) == 2          # the last of the tied gts
    assert 0.3 <= float(got.max_ious[1, 7]) < 0.7
    if case == "no_gt_image":
        assert (got.gt_inds[0] == 0).all() and (got.labels[0] == -1).all()


def test_assign_from_ious_matches_jax():
    rng = np.random.default_rng(3)
    ious = rng.uniform(0, 1, (2, 6, 90)).astype(np.float32)
    ious[:, :, ::7] = -1.0                       # invalid proposals
    ious[:, 4:] = 0.0                            # padded gts
    ious[1, 0, 3] = ious[1, 1, 3] = 1.0          # a tie at the best
    labels = rng.integers(0, 3, (2, 6)).astype(np.int32)
    for low in (True, False):
        got = pdet._assign_from_ious(_t(ious), _t(labels), 0.5, 0.5, 0.5, low)
        for b in range(2):
            want = jdet._assign_from_ious(jnp.asarray(ious[b]), jnp.asarray(labels[b]),
                                          0.5, 0.5, 0.5, low)
            np.testing.assert_array_equal(got.gt_inds[b].numpy(), np.asarray(want.gt_inds))
            np.testing.assert_array_equal(got.labels[b].numpy(), np.asarray(want.labels))


@pytest.mark.parametrize("num,frac", [(64, 0.5), (32, 0.25)])
def test_random_sample_invariants(num, frac):
    """Over 40 seeds and assignments with few and with many positives:
    exactly `num` slots, at most int(num·frac) positives, positives then
    negatives then invalid padding, every slot's class matching the
    assignment, gt_inds clipped at 0, no slot twice, and as many as the
    pool allows."""
    cap = int(num * frac)
    for seed in range(40):
        rng = np.random.default_rng(seed)
        A = 120
        gt_inds = rng.choice([-1, 0, 1, 2, 3], size=(2, A),
                             p=[0.3, 0.6 if seed % 2 else 0.05, 0.05, 0.03,
                                0.02 if seed % 2 else 0.57])
        labels = np.where(gt_inds > 0, rng.integers(0, 4, (2, A)), -1)
        assign = passign.AssignResult(_t(gt_inds), torch.zeros(2, A), _t(labels))
        s = passign.random_sample(assign, torch.Generator().manual_seed(seed), num, frac)
        assert all(t.shape == (2, num) for t in s)
        for b in range(2):
            inds, pos, valid = s.inds[b].numpy(), s.is_pos[b].numpy(), s.valid[b].numpy()
            n_pos, n_valid = int(pos.sum()), int(valid.sum())
            n_avail_pos = int((gt_inds[b] > 0).sum())
            n_avail_neg = int((gt_inds[b] == 0).sum())
            assert n_pos == min(cap, n_avail_pos)
            assert n_valid == n_pos + min(num - n_pos, n_avail_neg)
            assert pos[:n_pos].all() and not pos[n_pos:].any()
            assert valid[:n_valid].all() and not valid[n_valid:].any()
            assert len(set(inds.tolist())) == num
            np.testing.assert_array_equal(gt_inds[b][inds][pos] > 0, True)
            np.testing.assert_array_equal(gt_inds[b][inds][valid & ~pos], 0)
            np.testing.assert_array_equal(s.gt_inds[b].numpy(),
                                          np.clip(gt_inds[b][inds] - 1, 0, None))
            np.testing.assert_array_equal(s.labels[b].numpy(), labels[b][inds])


def test_random_sample_draws_from_its_generator():
    gt_inds = torch.from_numpy(np.random.default_rng(0).choice([0, 1], 200))
    assign = passign.AssignResult(gt_inds, torch.zeros(200), gt_inds - 1)
    draw = lambda seed: passign.random_sample(assign, torch.Generator().manual_seed(seed),
                                              32, 0.25).inds
    assert torch.equal(draw(5), draw(5)) and not torch.equal(draw(5), draw(6))


# -------------------------------------------------------------------- nms --

def _nms_inputs(seed, B, N, kind):
    rng = np.random.default_rng(seed)
    boxes = random_boxes(rng, (B, N), hi=60.0, wh=(2.0, 30.0))
    scores = rng.uniform(0, 1, (B, N)).astype(np.float32)
    if kind == "ties":      # runs of equal scores: the lower index first
        scores = np.round(scores * 8) / 8
    if kind == "padding":   # invalid boxes among the valid ones, a whole image too
        scores[:, ::3] = jnms.NEG_INF
        scores[1] = jnms.NEG_INF
    return boxes, scores


@pytest.mark.parametrize("kind,N,thr", [("random", 300, 0.7), ("ties", 257, 0.5),
                                        ("padding", 200, 0.6), ("random", 64, 0.3)])
def test_nms_matches_jax(kind, N, thr):
    """Index for index and score for score, on N not a multiple of the
    128-box tile."""
    boxes, scores = _nms_inputs(N, 2, N, kind)
    before = dict(pnms.LAUNCHES)
    idx, s = pnms.nms_batched(_t(boxes), _t(scores), thr, 50)
    assert pnms.LAUNCHES == before  # CPU: the plain version
    jidx, js = jnms.nms_batched(jnp.asarray(boxes), jnp.asarray(scores), thr, 50)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert idx.dtype == torch.int32
    one, s1 = pnms.nms(_t(boxes[0]), _t(scores[0]), thr, 50)
    np.testing.assert_array_equal(one.numpy(), idx[0].numpy())


def test_batched_nms_class_offsets_match_jax():
    """The coordinate-offset trick, 20 classes: overlapping boxes of other
    classes survive."""
    boxes, scores = _nms_inputs(9, 2, 400, "random")
    labels = np.random.default_rng(9).integers(0, 20, (2, 400)).astype(np.int32)
    idx, s = pnms.batched_nms(_t(boxes), _t(scores), _t(labels), 0.5, 100)
    jidx, js = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                jnp.asarray(labels), 0.5, 100)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    agnostic, _ = pnms.nms_batched(_t(boxes), _t(scores), 0.5, 100)
    assert not torch.equal(agnostic, idx)


@pytest.mark.parametrize("block", [128, 64, 7])
def test_nms_keep_ref_is_the_sequential_greedy_scan(block):
    """The blocked scan keeps what the plain sequential greedy rule keeps,
    whatever the tile size: each box in order, kept unless a kept earlier
    box overlaps it above the threshold."""
    boxes, scores = _nms_inputs(11, 2, 150, "padding")
    order, boxes_o, scores_o = pnms._score_order(_t(boxes), _t(scores))
    valid = scores_o > pnms.NEG_INF / 2
    got = pnms.nms_keep_ref(boxes_o, valid, 0.6, block)
    iou = pboxes.bbox_overlaps(boxes_o, boxes_o)
    for b in range(2):
        kept = []
        for i in range(150):
            if valid[b, i] and not any(iou[b, j, i] > 0.6 for j in kept):
                kept.append(i)
        assert got[b].nonzero()[:, 0].tolist() == kept


def test_nms_suppresses_strictly_above_the_threshold():
    """A pair at IoU exactly 0.7 (70 / 100 in fp32) both stay at thr 0.7,
    and the lower one goes at 0.69; of two equal boxes with equal scores the
    lower index stays; padding takes the lowest indices not kept."""
    boxes = _t(np.array([[[0, 0, 10, 10], [0, 0, 10, 7], [50, 50, 60, 60],
                          [50, 50, 60, 60]]], np.float32))
    scores = _t(np.array([[0.9, 0.8, 0.5, 0.5]], np.float32))
    iou = pboxes.bbox_overlaps(boxes[0], boxes[0])
    assert float(iou[0, 1]) == np.float32(0.7)
    idx, s = pnms.nms_batched(boxes, scores, 0.7, 4)
    assert idx.tolist() == [[0, 1, 2, 3]] and s[0, 3] == pnms.NEG_INF
    idx, s = pnms.nms_batched(boxes, scores, 0.69, 4)
    assert idx.tolist() == [[0, 2, 1, 3]] and (s[0, 2:] == pnms.NEG_INF).all()


# -------------------------------------------------------------- roi align --

def test_multilevel_roi_align_matches_jax():
    """Forward, and the gradient with respect to every level, on NCHW levels
    (the port) and NHWC ones (JAX); RoIs on every level, some past the
    image's border (clamped into their level)."""
    rng = np.random.default_rng(4)
    B, C, strides = 2, 6, (4, 8, 16, 32)
    hw = [(16, 20), (8, 10), (4, 5), (2, 3)]
    feats = [rng.standard_normal((B, h, w, C)).astype(np.float32) for h, w in hw]
    small = random_boxes(rng, (20,), hi=70.0, wh=(4.0, 30.0))
    large = random_boxes(rng, (20,), lo=-20.0, hi=60.0, wh=(60.0, 700.0))
    rois = np.concatenate([small, large])
    bidx = rng.integers(0, B, 40).astype(np.int32)
    cot = rng.standard_normal((40, 7, 7, C)).astype(np.float32)
    levels = proi.map_roi_levels(_t(rois), 4).numpy()
    np.testing.assert_array_equal(levels, np.asarray(jroi.map_roi_levels(jnp.asarray(rois), 4)))
    assert len(set(levels.tolist())) == 4

    jfn = lambda fs: jroi.multilevel_roi_align_fused(fs, jnp.asarray(rois),
                                                     jnp.asarray(bidx), 7, strides)
    want, vjp = jax.vjp(jfn, [jnp.asarray(f) for f in feats])
    want_g = vjp(jnp.asarray(cot))[0]
    pf = [_t(f).permute(0, 3, 1, 2).contiguous().requires_grad_() for f in feats]
    got = proi.multilevel_roi_align_fused(pf, _t(rois), _t(bidx), 7, strides)
    assert got.shape == (40, C, 7, 7)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    got.backward(_t(cot).permute(0, 3, 1, 2))
    for p, w in zip(pf, want_g):
        np.testing.assert_allclose(p.grad.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   atol=1e-5, rtol=1e-5)
