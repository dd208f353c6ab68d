"""The port's rotated-box ops against the JAX package's: the le90
conversions, rotated IoU (and IoF) on random boxes and on the edge cases
that `chip_smoke.py` phase 3g gives kernel R1, quadrilateral IoU, the
DeltaXYWHT and midpoint coders, the rotated NMS index for index (the plain
version `nms_ref`, which phase 3g holds R1 against on the card) with its
class offsets, the rotated RoI level rule and the rotated atlas RoIAlign
with its gradient; and R1's wrapper, which takes the card only, with the
limits of its source.

Inputs are made with numpy from a seed and fed to both sides in fp32.
The port translates each pair to its first box's centre before the
polygon work (the same function); JAX works at the boxes' own coordinates,
where fp32 cancellation in its shoelace grows with them: 1.3e-6 from
float64 at 100 px, 4e-5 at 800, 7e-3 at 5,000 and 0.2 at 40,000, the
class-offset coordinates of the rotated test NMS, while the port stays
within 1.2e-7.  So the port is held to JAX at image coordinates and to its
own float64 run at offset ones, and the class-aware NMS to JAX's per-class
NMS without offsets (the function the offsets stand for).
Angles: random ones are kept inside (−π/2 + 0.01, π/2 − 0.01), so that no
le90 normalisation lands within rounding of ±π/2 (where the two sides may
come out π apart); the edge cases at exactly ±π/2 are compared modulo π.
Keep sets are compared on inputs whose every IoU lies at least 1e-4 from
the threshold (asserted), 100× the largest IoU difference between the two
sides seen here (6e-7): there a rounding of the last bit cannot decide."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.ops import nms as jnms
from mtp_tpu.ops import roi_align as jroi
from mtp_tpu.ops import rotated_boxes as jrb
from mtp_tpu_torch.kernels import _build
from mtp_tpu_torch.ops import nms as pnms
from mtp_tpu_torch.ops import roi_align as proi
from mtp_tpu_torch.ops import rotated_boxes as prb

torch.set_num_threads(1)

# fp32 on both sides, the same operations in the same order; cos, sin,
# atan2, exp and log may differ in the last bit between XLA and PyTorch
ATOL, RTOL = 1e-5, 1e-5
HALF_PI = np.pi / 2
MARGIN = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


# JAX's functions jitted once (run op by op they compile each operation)
j_rbox_overlaps = jax.jit(jrb.rbox_overlaps, static_argnames="mode")
j_rotated_nms = jax.jit(lambda boxes, scores, thr, max_out: jnms.nms_batched(
    boxes, scores, thr, max_out, iou_fn=lambda a, b: jrb.rbox_overlaps(a, b)),
    static_argnums=(2, 3))
# boxes (cx, cy, w, h, θ, label): rotated IoU within a class, 0 across
j_per_class_nms = jax.jit(lambda boxes, scores, thr, max_out: jnms.nms_batched(
    boxes, scores, thr, max_out, iou_fn=lambda a, b: jrb.rbox_overlaps(a[:, :5], b[:, :5])
    * (a[:, None, 5] == b[None, :, 5])), static_argnums=(2, 3))


def random_rboxes(rng, shape, lo=0.0, hi=100.0, wh=(2.0, 60.0)):
    """(cx, cy, w, h, θ) with θ off the le90 boundary by 0.01."""
    xy = rng.uniform(lo, hi, shape + (2,))
    size = rng.uniform(*wh, shape + (2,))
    t = rng.uniform(-HALF_PI + 0.01, HALF_PI - 0.01, shape + (1,))
    return np.concatenate([xy, size, t], -1).astype(np.float32)


def edge_case_pairs():
    """Pairs (a, b) of phase 3g's edge cases: identical boxes, one inside
    another, a shared edge, a 90°-rotated copy, a zero-width box, θ at ±π/2,
    and coordinates after a 20-class offset."""
    box = [40.0, 50.0, 30.0, 12.0, 0.3]
    shift = 19 * 1901.0  # class 19's offset at the predict's extent
    pairs = [
        (box, box),                                                  # identical
        (box, [41.0, 50.5, 10.0, 4.0, 0.5]),                        # inside
        ([10.0, 10.0, 10.0, 10.0, 0.0], [20.0, 10.0, 10.0, 10.0, 0.0]),  # shared edge
        ([10.0, 10.0, 10.0, 10.0, 0.0], [15.0, 10.0, 10.0, 10.0, 0.0]),  # half overlap
        (box, [40.0, 50.0, 30.0, 12.0, 0.3 + HALF_PI]),             # rotated 90°
        (box, [40.0, 50.0, 0.0, 12.0, 0.3]),                        # zero width
        ([40.0, 50.0, 30.0, 12.0, HALF_PI], [42.0, 50.0, 30.0, 12.0, -HALF_PI]),
        ([40.0 + shift, 50.0 + shift, 30.0, 12.0, 0.3],
         [44.0 + shift, 52.0 + shift, 26.0, 14.0, 0.1]),            # after the offset
        (box, [140.0, 50.0, 30.0, 12.0, 0.3]),                      # disjoint
    ]
    a, b = zip(*pairs)
    return np.array(a, np.float32), np.array(b, np.float32)


def _same_mod_pi(got, want, atol=ATOL):
    """Angles equal modulo π."""
    d = np.remainder(np.asarray(got, np.float64) - want + HALF_PI, np.pi) - HALF_PI
    np.testing.assert_allclose(d, 0.0, atol=atol)


# ------------------------------------------------------------ conversions --

def test_conversions_match_jax():
    rng = np.random.default_rng(0)
    rb = random_rboxes(rng, (2, 40))
    rb[0, :5, 2:4] = rb[0, :5, 3:1:-1]   # some h > w: the edge swap
    for name in ("rbox_to_corners", "rbox_to_hbox", "regularize_le90"):
        got = getattr(prb, name)(_t(rb)).numpy()
        want = np.asarray(getattr(jrb, name)(_j(rb)))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=name)
    theta = rng.uniform(-7, 7, 200).astype(np.float32)
    np.testing.assert_allclose(prb.norm_angle_le90(_t(theta)).numpy(),
                               np.asarray(jrb.norm_angle_le90(_j(theta))), atol=1e-6)
    hb = np.concatenate([rb[0, :, :2], rb[0, :, :2] + rb[0, :, 2:4]], -1)
    np.testing.assert_allclose(prb.hbox_to_rbox(_t(hb)).numpy(),
                               np.asarray(jrb.hbox_to_rbox(_j(hb))), atol=ATOL, rtol=RTOL)
    # _ccw: clockwise corners come back reversed, counter-clockwise ones as they are
    c = prb.rbox_to_corners(_t(rb[0]))
    np.testing.assert_array_equal(prb._ccw(c.flip(-2)).numpy(), c.numpy())
    np.testing.assert_array_equal(prb._ccw(c).numpy(), np.asarray(jrb._ccw(_j(c.numpy()))))


def test_qbox_to_rbox_matches_jax():
    """Near-rectangles (rbox corners jittered by up to 1 px), the best of the
    four edge orientations at least 1e-3 (relative) ahead of the next."""
    rng = np.random.default_rng(1)
    rb = random_rboxes(rng, (200,), wh=(10.0, 60.0))
    quad = (prb.rbox_to_corners(_t(rb)).numpy().reshape(-1, 8)
            + rng.uniform(-1, 1, (200, 8))).astype(np.float32)
    p = quad.reshape(-1, 4, 2)
    e = np.roll(p, -1, 1) - p
    areas = []
    for k in range(4):
        a = np.arctan2(e[:, k, 1], e[:, k, 0])
        c, s = np.cos(-a)[:, None], np.sin(-a)[:, None]
        qx, qy = p[..., 0] * c - p[..., 1] * s, p[..., 0] * s + p[..., 1] * c
        areas.append((qx.max(1) - qx.min(1)) * (qy.max(1) - qy.min(1)))
    areas = np.sort(np.stack(areas, 1), 1)
    keep = (areas[:, 1] - areas[:, 0]) > 1e-3 * areas[:, 0]
    assert keep.sum() >= 40
    quad = quad[keep]
    got = prb.qbox_to_rbox(_t(quad)).numpy()
    want = np.asarray(jrb.qbox_to_rbox(_j(quad)))
    np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1e-4, rtol=1e-5)
    _same_mod_pi(got[:, 4], want[:, 4], atol=1e-5)


# -------------------------------------------------------------- overlaps --

@pytest.mark.parametrize("mode", ["iou", "iof"])
def test_rbox_overlaps_matches_jax(mode):
    """Random boxes, a third of the pairs overlapping, and the edge cases
    pair by pair; a batched call equals the unbatched one."""
    rng = np.random.default_rng(2)
    a, b = random_rboxes(rng, (37,)), random_rboxes(rng, (53,))
    got = prb.rbox_overlaps(_t(a), _t(b), mode).numpy()
    want = np.asarray(j_rbox_overlaps(_j(a), _j(b), mode=mode))
    assert 0.1 < (want > 0).mean() < 0.9
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    batched = prb.rbox_overlaps(_t(np.stack([a, a])), _t(np.stack([b, b])), mode)
    np.testing.assert_array_equal(batched[1].numpy(), got)
    ea, eb = edge_case_pairs()
    got = np.diagonal(prb.rbox_overlaps(_t(ea), _t(eb), mode).numpy())
    want = np.diagonal(np.asarray(j_rbox_overlaps(_j(ea), _j(eb), mode=mode)))
    f64 = np.diagonal(prb.rbox_overlaps(_t(ea).double(), _t(eb).double(), mode).numpy())
    np.testing.assert_allclose(got, f64, atol=1e-6)
    # all but the pair after the class offset (index 7, at ~3.6e4 px)
    np.testing.assert_allclose(np.delete(got, 7), np.delete(want, 7), atol=ATOL, rtol=RTOL)
    if mode == "iou":
        np.testing.assert_allclose(got[[0, 2, 3, 4, 5, 8]], [1.0, 0.0, 1 / 3, 12 / 48, 0.0, 0.0],
                                   atol=1e-5)


def test_quad_and_rbox2hbox_overlaps_match_jax():
    rng = np.random.default_rng(3)
    a, b = random_rboxes(rng, (20,)), random_rboxes(rng, (25,))
    qa = prb.rbox_to_corners(_t(a)).reshape(-1, 8)
    qb = prb.rbox_to_corners(_t(b)).reshape(-1, 8)
    got = prb.quad_overlaps(qa, qb).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(jrb.quad_overlaps)(_j(qa.numpy()),
                                                                          _j(qb.numpy()))),
                               atol=ATOL, rtol=RTOL)
    # a rectangle's quad IoU is its rotated IoU
    np.testing.assert_allclose(got, prb.rbox_overlaps(_t(a), _t(b)).numpy(), atol=1e-5)
    hb = np.concatenate([b[:, :2], b[:, :2] + b[:, 2:4]], -1)
    np.testing.assert_allclose(prb.rbox2hbox_overlaps(_t(a), _t(hb)).numpy(),
                               np.asarray(jrb.rbox2hbox_overlaps(_j(a), _j(hb))),
                               atol=ATOL, rtol=RTOL)


def test_rbox_overlaps_chunks_the_pair_grid(monkeypatch):
    """The plain version over chunks of a few pairs equals it in one piece."""
    rng = np.random.default_rng(4)
    a, b = random_rboxes(rng, (2, 19)), random_rboxes(rng, (2, 23))
    whole = prb.rbox_overlaps(_t(a), _t(b))
    monkeypatch.setattr(prb, "PAIRS_PER_CHUNK", 50)
    np.testing.assert_array_equal(prb.rbox_overlaps(_t(a), _t(b)).numpy(), whole.numpy())


# ----------------------------------------------------------------- coders --

def test_delta_rbox_coder_matches_jax():
    """encode (with edge swaps both ways) and decode past wh_ratio_clip, at
    the recipe's stds and the defaults."""
    rng = np.random.default_rng(5)
    p, g = random_rboxes(rng, (2, 64), wh=(4.0, 60.0)), random_rboxes(rng, (2, 64))
    p = np.asarray(jrb.regularize_le90(_j(p)))
    g[0, :8, 4] = p[0, :8, 4] + 1.2      # past 45° from the proposal: swap
    g = np.asarray(jrb.regularize_le90(_j(g)))
    for kw in ({}, {"stds": (0.1, 0.1, 0.2, 0.2, 0.1)}):
        got = prb.delta_encode_rbox(_t(p), _t(g), **kw).numpy()
        want = np.asarray(jrb.delta_encode_rbox(_j(p), _j(g), **kw))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    d = (rng.standard_normal((2, 64, 5)) * 0.5).astype(np.float32)
    d[0, :8, 2:4] = 9.0
    for kw in ({}, {"stds": (0.1, 0.1, 0.2, 0.2, 0.1)}):
        got = prb.delta_decode_rbox(_t(p), _t(d), **kw).numpy()
        want = np.asarray(jrb.delta_decode_rbox(_j(p), _j(d), **kw))
        np.testing.assert_allclose(got[..., :4], want[..., :4], atol=1e-4, rtol=RTOL)
        _same_mod_pi(got[..., 4], want[..., 4])
    round_trip = prb.delta_decode_rbox(_t(p), prb.delta_encode_rbox(_t(p), _t(g)))
    np.testing.assert_allclose(round_trip[..., :4].numpy(), g[..., :4], atol=1e-3, rtol=1e-4)


def test_midpoint_coder_matches_jax():
    """encode of rotated and axis-aligned gts (ties in the top / right
    vertex: the first one) against hbox anchors; decode of random deltas,
    some past the clips, and of flat parallelograms (the longer diagonal)."""
    rng = np.random.default_rng(6)
    g = random_rboxes(rng, (2, 48))
    g[1, :10, 4] = 0.0
    xy = rng.uniform(0, 100, (2, 48, 2))
    anchors = np.concatenate([xy, xy + rng.uniform(8, 64, (2, 48, 2))], -1).astype(np.float32)
    for kw in ({}, {"stds": (1., 1., 1., 1., 0.5, 0.5)}):
        got = prb.midpoint_encode(_t(anchors), _t(g), **kw).numpy()
        want = np.asarray(jax.jit(lambda a, b: jrb.midpoint_encode(a, b, **kw))(
            _j(anchors), _j(g)))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    d = (rng.standard_normal((2, 48, 6)) * 0.6).astype(np.float32)
    d[0, :6, 2:4] = 8.0
    d[0, 6:12, 4:] = 3.0
    d[1, :6, 4] = 0.5
    d[1, :6, 5] = -0.5 + 1e-3          # near-degenerate parallelograms
    got = prb.midpoint_decode(_t(anchors), _t(d)).numpy()
    want = np.asarray(jax.jit(jrb.midpoint_decode)(_j(anchors), _j(d)))
    np.testing.assert_allclose(got[..., :4], want[..., :4], atol=1e-4, rtol=1e-5)
    _same_mod_pi(got[..., 4], want[..., 4], atol=1e-5)


# -------------------------------------------------------------------- nms --

def clustered_rboxes(rng, B, N, hi=120.0, copies=4):
    """N rboxes an image, one in `copies` drawn, the rest jittered copies."""
    n0 = N // copies
    base = random_rboxes(rng, (B, n0), hi=hi, wh=(6.0, 50.0))
    src = rng.integers(0, n0, (B, N - n0))
    jit = np.take_along_axis(base, src[..., None], 1)
    jit = jit + np.concatenate([rng.normal(0, 3, (B, N - n0, 2)), rng.normal(0, 2, (B, N - n0, 2)),
                                rng.normal(0, 0.1, (B, N - n0, 1))], -1)
    jit[..., 2:4] = np.abs(jit[..., 2:4]) + 1.0
    jit[..., 4] = np.clip(jit[..., 4], -HALF_PI + 0.01, HALF_PI - 0.01)
    return np.concatenate([base, jit], 1).astype(np.float32)


def thr_with_margin(boxes, near):
    """A threshold near `near` whose distance to every pair's IoU, JAX's and
    the port's, is at least MARGIN: the middle of the widest gap between the
    IoUs within 0.1 of `near`."""
    ious = np.concatenate([np.asarray(j_rbox_overlaps(_j(b), _j(b))).ravel() for b in boxes]
                          + [prb.rbox_overlaps(_t(b), _t(b)).numpy().ravel() for b in boxes])
    vals = np.sort(ious[(ious > near - 0.1) & (ious < near + 0.1)])
    vals = np.concatenate([[near - 0.1], vals, [near + 0.1]])
    k = np.argmax(np.diff(vals))
    thr = float((vals[k] + vals[k + 1]) / 2)
    assert np.abs(ious - thr).min() >= MARGIN, np.abs(ious - thr).min()
    return thr


@pytest.mark.parametrize("near,N,kind", [(0.1, 140, "random"), (0.5, 130, "padding"),
                                         (0.8, 64, "ties")])
def test_rotated_nms_matches_jax(near, N, kind):
    """`nms_batched` of rboxes on the CPU (`nms_ref`, the rotated plain IoU)
    against JAX's `nms_batched(iou_fn=rbox_overlaps)`, index for index and
    score for score, at N not a multiple of the 128-box tile; and the
    blocked scan against the sequential greedy rule."""
    rng = np.random.default_rng(int(near * 100) + N)
    boxes = clustered_rboxes(rng, 2, N)
    scores = rng.uniform(0, 1, (2, N)).astype(np.float32)
    if kind == "ties":
        scores = np.round(scores * 8) / 8
    if kind == "padding":
        scores[:, ::3] = jnms.NEG_INF
    thr = thr_with_margin(boxes, near)
    before = {**pnms.LAUNCHES, **prb.LAUNCHES}
    idx, s = pnms.nms_batched(_t(boxes), _t(scores), thr, 40)
    assert {**pnms.LAUNCHES, **prb.LAUNCHES} == before   # CPU: the plain version
    jidx, js = j_rotated_nms(_j(boxes), _j(scores), thr, 40)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert int((s > pnms.NEG_INF / 2).sum()) > 0
    order, boxes_o, scores_o = pnms._score_order(_t(boxes), _t(scores))
    valid = scores_o > pnms.NEG_INF / 2
    keep = pnms.nms_keep_ref(boxes_o, valid, thr, block=16)
    iou = prb.rbox_overlaps(boxes_o, boxes_o)
    for b in range(2):
        kept = []
        for i in range(N):
            if valid[b, i] and not any(iou[b, j, i] > thr for j in kept):
                kept.append(i)
        assert keep[b].nonzero()[:, 0].tolist() == kept


def test_rotated_batched_nms_class_offsets_match_jax():
    """20 classes at the predict's threshold 0.1 over an 800² image: the
    rotated extent (2·max|cx, cy| + √2·max|w, h| + 1, the centres shifted
    only), and `batched_nms`' keep sets against JAX's greedy NMS with the
    classes kept apart by the IoU itself (cross-class pairs 0, the boxes at
    their own coordinates): the function the offsets stand for."""
    rng = np.random.default_rng(7)
    boxes = clustered_rboxes(rng, 2, 300, hi=800.0)
    boxes[0, 0, :2] = -30.0                    # a centre past the image
    labels = rng.integers(0, 20, (2, 300)).astype(np.int32)
    scores = rng.uniform(0, 1, (2, 300)).astype(np.float32)
    shifted = pnms.class_offset_boxes(_t(boxes), _t(labels)).numpy()
    extent = (np.float32(np.abs(boxes[..., :2]).max()) * 2 + np.float32(np.sqrt(2))
              * np.abs(boxes[..., 2:4]).max() + 1)
    np.testing.assert_allclose(shifted[..., :2], boxes[..., :2] + labels[..., None] * extent,
                               rtol=1e-6)
    np.testing.assert_array_equal(shifted[..., 2:], boxes[..., 2:])
    thr = thr_with_margin(boxes, 0.1)
    idx, s = pnms.batched_nms(_t(boxes), _t(scores), _t(labels), thr, 100)
    labelled = np.concatenate([boxes, labels[..., None].astype(np.float32)], -1)
    jidx, js = j_per_class_nms(_j(labelled), _j(scores), thr, 100)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    agnostic, _ = pnms.nms_batched(_t(boxes), _t(scores), thr, 100)
    assert not torch.equal(agnostic, idx)


# -------------------------------------------------------------- roi align --

def test_rotated_roi_levels_and_align_match_jax():
    """`map_rroi_levels` (sqrt(w·h) of the box itself), and the atlas
    RoIAlign of rotated RoIs (clockwise, as the detector calls it) forward
    and its gradient with respect to every level, NCHW levels (the port)
    against NHWC (JAX); RoIs on every level, some past the border."""
    rng = np.random.default_rng(8)
    B, C, strides = 2, 6, (4, 8, 16, 32)
    hw = [(16, 20), (8, 10), (4, 5), (2, 3)]
    feats = [rng.standard_normal((B, h, w, C)).astype(np.float32) for h, w in hw]
    small = random_rboxes(rng, (20,), hi=70.0, wh=(4.0, 40.0))
    large = random_rboxes(rng, (20,), lo=-20.0, hi=90.0, wh=(60.0, 500.0))
    rois = np.concatenate([small, large])
    bidx = rng.integers(0, B, 40).astype(np.int32)
    cot = rng.standard_normal((40, 7, 7, C)).astype(np.float32)
    levels = proi.map_rroi_levels(_t(rois), 4).numpy()
    np.testing.assert_array_equal(levels, np.asarray(jroi.map_rroi_levels(_j(rois), 4)))
    assert len(set(levels.tolist())) == 4

    jfn = lambda fs: jroi.multilevel_roi_align_fused(fs, _j(rois), _j(bidx), 7, strides,
                                                     rotated=True, clockwise=True)
    want, want_g = jax.jit(lambda fs, c: (lambda out, vjp: (out, vjp(c)[0]))(
        *jax.vjp(jfn, fs)))([_j(f) for f in feats], _j(cot))
    pf = [_t(f).permute(0, 3, 1, 2).contiguous().requires_grad_() for f in feats]
    got = proi.multilevel_roi_align_fused(pf, _t(rois), _t(bidx), 7, strides, rotated=True)
    assert got.shape == (40, C, 7, 7)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    got.backward(_t(cot).permute(0, 3, 1, 2))
    for p, w in zip(pf, want_g):
        np.testing.assert_allclose(p.grad.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   atol=1e-5, rtol=1e-5)


# -------------------------------------------------------------------- R1 --

def test_r1_wrapper_takes_only_the_card():
    """R1's wrappers launch on fp32 CUDA tensors only: on CPU tensors
    `rbox_overlaps` and `nms_batched` run the plain versions, and called
    directly R1 raises on them, on other dtypes and past its limits; the
    limits are rotated_iou.cu's and nms_scan.cuh's constants, and its
    launchers are declared as the source defines them."""
    boxes, scores = torch.zeros(2, 70, 5), torch.zeros(2, 70)
    with pytest.raises(ValueError, match="CUDA"):
        prb.rbox_iou(boxes, boxes)
    with pytest.raises(ValueError, match="CUDA"):
        pnms.nms_keep(boxes, scores, 0.1)
    with pytest.raises(ValueError, match="device"):
        prb.rbox_overlaps(boxes.to("meta"), boxes.to("meta"))
    before = {**prb.LAUNCHES, **pnms.LAUNCHES}
    prb.rbox_overlaps(boxes, boxes)
    pnms.nms_batched(boxes, scores, 0.1, 10)
    assert {**prb.LAUNCHES, **pnms.LAUNCHES} == before
    assert prb.LAUNCHES["rbox_iou"] == pnms.LAUNCHES["nms_rotated"] == 0


def test_r1_refusals_on_the_card_side(monkeypatch):
    """With the device check passed (the card stood in for), R1 still
    refuses fp64 boxes, more than NMS_MAX_BOXES boxes and mismatched
    batches, and never launches for them; a legal call launches once and
    counts once.  The source: the shared scan and its constants, the mask
    form over the upper triangle's tiles, the pairs its early exit lets
    through queued for the block, and the exit's margin equal to
    `rbox_apart`'s."""
    launched = []

    def dtype_only(kernel, *tensors):
        """The card's check without its device test."""
        if any(t.dtype != torch.float32 for t in tensors):
            raise TypeError(f"{kernel} takes torch.float32")

    monkeypatch.setattr(_build, "check_on_card", dtype_only)
    monkeypatch.setattr(_build, "launch", lambda name, *a: launched.append(name))
    monkeypatch.setattr(prb, "LAUNCHES", dict.fromkeys(prb.LAUNCHES, 0))
    monkeypatch.setattr(pnms, "LAUNCHES", dict.fromkeys(pnms.LAUNCHES, 0))
    with pytest.raises(TypeError, match="float32"):
        prb.rbox_iou(torch.zeros(1, 3, 5, dtype=torch.float64), torch.zeros(1, 3, 5,
                                                                           dtype=torch.float64))
    big = torch.zeros(1, pnms.NMS_MAX_BOXES + 1, 5)
    with pytest.raises(ValueError, match="boxes"):
        pnms.nms_keep(big, torch.zeros(1, pnms.NMS_MAX_BOXES + 1), 0.1)
    with pytest.raises(ValueError, match="boxes"):
        prb.rbox_iou(torch.zeros(1, 2, 5), big)
    with pytest.raises(ValueError, match="B, N, 5"):
        prb.rbox_iou(torch.zeros(1, 2, 5), torch.zeros(2, 2, 5))
    assert launched == []
    prb.rbox_iou(torch.zeros(1, 2, 5), torch.zeros(1, 3, 5), "iof")
    pnms.nms_keep(torch.zeros(2, 5, 5), torch.zeros(2, 5), 0.1)
    assert launched == ["mtp_rbox_iou", "mtp_nms_rotated"]
    assert prb.LAUNCHES == {"rbox_iou": 1}
    assert pnms.LAUNCHES == {"nms": 0, "nms_rotated": 1}

    src = (_build.CSRC / "rotated_iou.cu").read_text()
    scan = (_build.CSRC / "nms_scan.cuh").read_text()
    const = lambda text, name: re.search(rf"constexpr \w+ {name} = ([^;]+);", text)[1]
    assert '#include "nms_scan.cuh"' in src and "nms::nms_scan_kernel<<<" in src
    assert const(scan, "kTile") == str(pnms.NMS_TILE)
    assert const(scan, "kMaxBoxes") == "1 << 16" and pnms.NMS_MAX_BOXES == 1 << 16
    assert float(const(scan, "kValidMin").rstrip("f")) == pnms.NEG_INF / 2
    assert float(const(src, "kApartMargin").rstrip("f")) == prb.APART_MARGIN
    assert "apart(sa, bj) ? 0.f :" in src and "!apart(rows[r], cols[c])" in src
    assert "<<<dim3(nms::upper_tiles(words), B), kMaskThreads" in src
    assert "atomicAdd(&queued, __popc(votes))" in src and "atomicOr(&bits[r]" in src
    assert _build.SIGNATURES["mtp_rbox_iou"] == [_build._P] * 3 + [_build._I] * 4
    assert _build.SIGNATURES["mtp_nms_rotated"] == _build.SIGNATURES["mtp_nms"]
    for name, args in (("mtp_rbox_iou", 7), ("mtp_nms_rotated", 8)):
        sig = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)[1]
        assert len(sig.split(",")) == args + 2, name   # + dtype and stream
