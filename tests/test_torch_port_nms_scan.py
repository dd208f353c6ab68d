"""The two halves of N1 and R1's rotated NMS on the CPU, and R1's early exit.

`nms_mask_ref` (the suppression bitmask in the kernels' layout) and
`nms_scan_ref` (the keep mask from those words, in csrc/nms_scan.cuh's
order) together against `nms_keep_ref` and, for horizontal boxes, against
JAX's `nms_batched` index for index: N = 1, 63, 64, 65 and 130, every box
invalid, equal scores, a tile whose every row is kept, suppression chains
within and across tiles, and rotated boxes.  `rbox_apart`, the plain version
of R1's separation test: every pair it marks has plain rotated IoU exactly
0 in fp32 and float64, at image coordinates, at class-offset centres up to
5·10⁴ px and at the margin, and no box of zero area is ever marked.  Last,
N1's division-free test of IoU > thr against the division, in fp32.  Inputs
are made with numpy from a seed."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.ops import nms as jnms
from mtp_tpu_torch.ops import nms as pnms
from mtp_tpu_torch.ops import rotated_boxes as prb

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def clustered(rng, B, N, hw=200.0, copies=3):
    """N x1y1x2y2 boxes an image as an RPN leaves them: one in `copies`
    drawn over the hw image (sides 4-60 px, aspect 1/2-2), the rest jittered
    copies of those (centres and sides by 10%), clipped; uniform scores."""
    n0 = max(1, N // copies)
    side = np.exp(rng.uniform(np.log(4), np.log(60), (B, n0)))
    ratio = np.exp(rng.uniform(-np.log(2), np.log(2), (B, n0)))
    w, h = side * np.sqrt(ratio), side / np.sqrt(ratio)
    cx, cy = rng.uniform(0, hw, (B, n0)), rng.uniform(0, hw, (B, n0))
    src = rng.integers(0, n0, (B, N - n0))
    w, h, cx, cy = (np.concatenate([t, np.take_along_axis(t, src, 1)], 1)
                    for t in (w, h, cx, cy))
    jitter = lambda: rng.normal(0.0, 0.1, (B, N))
    cx, cy = cx + w * jitter(), cy + h * jitter()
    w, h = w * (1 + jitter()), h * (1 + jitter())
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).clip(0, hw)
    return boxes.astype(np.float32), rng.uniform(size=(B, N)).astype(np.float32)


def rotated(rng, B, n_obj, copies, hw=400.0):
    """n_obj · copies le90 rboxes an image (sides 8-80 px, aspect 1-4, any
    angle, each object seen `copies` times with 10% jitter), uniform scores,
    each object's label of 5."""
    side = np.exp(rng.uniform(np.log(8), np.log(80), (B, n_obj)))
    obj = np.stack([rng.uniform(0, hw, (B, n_obj)), rng.uniform(0, hw, (B, n_obj)), side,
                    side / rng.uniform(1, 4, (B, n_obj)),
                    rng.uniform(-math.pi / 2, math.pi / 2, (B, n_obj))], -1)
    boxes = np.repeat(obj, copies, 1)
    scale = np.stack([boxes[..., 2]] * 3 + [boxes[..., 3], np.ones_like(boxes[..., 0])], -1)
    boxes = boxes + rng.normal(0.0, 0.1, boxes.shape) * scale
    boxes[..., 2:4] = np.abs(boxes[..., 2:4])
    labels = np.repeat(rng.integers(0, 5, (B, n_obj)), copies, 1)
    return (boxes.astype(np.float32), rng.uniform(size=boxes.shape[:2]).astype(np.float32),
            labels)


def halves(boxes, scores, thr):
    """(order, boxes and scores in score order, nms_mask_ref's words, the
    keep mask nms_scan_ref takes from them)."""
    order, boxes_o, scores_o = pnms._score_order(_t(boxes), _t(scores))
    mask = pnms.nms_mask_ref(boxes_o, thr)
    return order, boxes_o, scores_o, mask, pnms.nms_scan_ref(mask, scores_o)


def unpack(mask):
    """(B, N, words) int64 words → (B, N, words·64) bool bits."""
    shifts = torch.arange(64)
    return ((mask[..., None] >> shifts) & 1).bool().flatten(-2)


def greedy(mask, scores_o):
    """The greedy rule row by row from the bits: a valid box not suppressed
    by a kept earlier one is kept."""
    bits = unpack(mask)
    B, N = scores_o.shape
    keep = torch.zeros(B, N, dtype=torch.bool)
    for b in range(B):
        removed = torch.zeros(bits.shape[-1], dtype=torch.bool)
        for i in range(N):
            if scores_o[b, i] > pnms.NEG_INF / 2 and not removed[i]:
                keep[b, i] = True
                removed |= bits[b, i]
    return keep


def check_halves(boxes, scores, thr, jax_too=True, max_out=50):
    """The halves against nms_keep_ref, the row-by-row greedy rule and (for
    horizontal boxes) JAX's nms_batched; returns (boxes_o, mask, keep)."""
    order, boxes_o, scores_o, mask, keep = halves(boxes, scores, thr)
    valid = scores_o > pnms.NEG_INF / 2
    torch.testing.assert_close(keep, pnms.nms_keep_ref(boxes_o, valid, thr), rtol=0, atol=0)
    torch.testing.assert_close(keep, greedy(mask, scores_o), rtol=0, atol=0)
    if jax_too:
        max_out = min(max_out, boxes.shape[1])
        idx, s = pnms._top(order, scores_o, keep, max_out)
        jidx, js = jnms.nms_batched(jnp.asarray(boxes), jnp.asarray(scores), thr, max_out)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    return boxes_o, mask, keep


@pytest.mark.parametrize("N", [1, 63, 64, 65, 130])
def test_halves_equal_nms_keep_ref_and_jax(N):
    """N below, at and past one 64-row tile and across three tiles."""
    boxes, scores = clustered(np.random.default_rng(N), 2, N)
    _, mask, keep = check_halves(boxes, scores, 0.5)
    assert mask.shape == (2, N, (N + 63) // 64) and mask.dtype == torch.int64
    if N > 1:
        assert 0 < int(keep.sum()) < 2 * N


def test_mask_layout():
    """The words of `nms_mask_ref`: bit t of word w of row i is IoU(i, w·64
    + t) > thr for w·64 + t > i and nothing else (the words before a row's
    tile are 0), bit 63 included (the word's sign), whatever the row chunk."""
    rng = np.random.default_rng(7)
    boxes, scores = clustered(rng, 2, 150, hw=80.0)
    _, boxes_o, _ = pnms._score_order(_t(boxes), _t(scores))
    mask = pnms.nms_mask_ref(boxes_o, 0.3)
    torch.testing.assert_close(mask, pnms.nms_mask_ref(boxes_o, 0.3, rows=7), rtol=0, atol=0)
    bits = unpack(mask)
    N = boxes_o.shape[1]
    j = torch.arange(N)
    over = (pnms.bbox_overlaps(boxes_o, boxes_o) > 0.3) & (j > j[:, None])
    torch.testing.assert_close(bits[..., :N], over, rtol=0, atol=0)
    assert not bits[..., N:].any()
    for i in range(N):
        assert (mask[:, i, :i // 64] == 0).all()
    assert (mask < 0).any()  # some word has bit 63 set


def test_all_invalid():
    boxes, _ = clustered(np.random.default_rng(3), 2, 130)
    scores = np.full((2, 130), jnms.NEG_INF, np.float32)
    _, _, keep = check_halves(boxes, scores, 0.7)
    assert not keep.any()


def test_equal_scores():
    """Ties go to the lower index, as the stable score order puts them."""
    boxes, scores = clustered(np.random.default_rng(4), 2, 200)
    check_halves(boxes, (scores * 4).round() / 4, 0.5)


def test_a_tile_whose_every_row_is_kept():
    """Disjoint boxes on a grid: every row of every tile is kept, and the
    mask is all zeros; a few invalid rows in the second tile are not."""
    g = np.arange(150, dtype=np.float32)
    boxes = np.stack([g * 10, g * 0, g * 10 + 5, g * 0 + 5], -1)[None].repeat(2, 0)
    scores = np.random.default_rng(5).uniform(size=(2, 150)).astype(np.float32)
    scores[:, ::17] = jnms.NEG_INF
    boxes_o, mask, keep = check_halves(boxes, scores, 0.5)
    assert not mask.any()
    torch.testing.assert_close(keep, pnms._score_order(_t(boxes), _t(scores))[2]
                               > pnms.NEG_INF / 2, rtol=0, atol=0)
    assert keep[:, :64].all()


def chain_case():
    """Boxes in score order (by their scores) with two chains: A (row 10)
    removes B (row 80, the next tile), whose only overlap past it is C (row
    150, the tile after): C is kept; within tile 0, D (row 11) removes E
    (row 12), whose only later overlap is F (row 13): F is kept.  Every
    other box is far from all others."""
    N = 200
    g = np.arange(N, dtype=np.float32)
    boxes = np.stack([g * 100, g * 0 + 1000, g * 100 + 5, g * 0 + 1005], -1)
    a = np.array([0.0, 0.0, 10.0, 10.0], np.float32)
    boxes[10], boxes[80], boxes[150] = a, a + [4, 0, 4, 0], a + [8, 0, 8, 0]
    d = np.array([0.0, 50.0, 10.0, 60.0], np.float32)
    boxes[11], boxes[12], boxes[13] = d, d + [4, 0, 4, 0], d + [8, 0, 8, 0]
    scores = (1.0 - g / N).astype(np.float32)
    return boxes[None].repeat(2, 0), scores[None].repeat(2, 0)


def test_suppression_chains_within_and_across_tiles():
    boxes, scores = chain_case()
    iou = pnms.bbox_overlaps(_t(boxes[0]), _t(boxes[0]))
    assert iou[10, 80] > 0.4 and iou[80, 150] > 0.4 and iou[10, 150] < 0.4
    _, mask, keep = check_halves(boxes, scores, 0.4)
    assert keep[:, 10].all() and not keep[:, 80].any() and keep[:, 150].all()
    assert keep[:, 11].all() and not keep[:, 12].any() and keep[:, 13].all()
    # the far path: row 10's later word (tile 1) names row 80
    assert ((mask[:, 10, 1] >> 16) & 1 == 1).all()


def test_a_cleared_bit_in_a_kept_rows_later_word_changes_the_scan():
    """The control that chip_smoke.py runs on the card's words: the bit by
    which a kept row alone removes a row of a later tile, cleared, must
    give another keep mask."""
    boxes, scores = chain_case()
    _, _, scores_o, mask, keep = halves(boxes, scores, 0.4)
    cleared = mask.clone()
    cleared[:, 10, 1] &= ~(1 << 16)
    other = pnms.nms_scan_ref(cleared, scores_o)
    assert other[:, 80].all() and not other[:, 150].any()
    assert not torch.equal(other, keep)


@pytest.mark.parametrize("thr", [0.1, 0.5])
def test_rotated_halves_equal_nms_keep_ref(thr):
    """Rotated boxes (R1's mask form), of 5 classes through the class
    offset, as the rotated test NMS runs them; N = 150 (three tiles)."""
    boxes, scores, labels = rotated(np.random.default_rng(11), 2, 30, 5)
    shifted = pnms.class_offset_boxes(_t(boxes), _t(labels)).numpy()
    boxes_o, mask, keep = check_halves(shifted, scores, thr, jax_too=False)
    assert mask.shape == (2, 150, 3) and 0 < int(keep.sum()) < 300


# ------------------------------------------------------------ rbox_apart --

def apart_and_zero(a, b):
    """rbox_apart in fp32; the plain IoU of every marked pair must be 0 in
    fp32 and float64.  Returns (marked, plain fp32 IoUs)."""
    a32, b32 = _t(a).float(), _t(b).float()
    marked = prb.rbox_apart(a32, b32)
    iou32 = prb.rbox_overlaps_ref(a32, b32)
    iou64 = prb.rbox_overlaps_ref(a32.double(), b32.double())
    assert (iou32[marked] == 0).all() and (iou64[marked] == 0).all()
    return marked, iou32


def test_rbox_apart_marks_only_pairs_of_iou_zero():
    """Image coordinates: most pairs are marked, every marked one has IoU 0,
    and the test is conservative: some pairs of IoU 0 are left to the full
    computation, none of IoU > 0 is marked."""
    boxes, _, _ = rotated(np.random.default_rng(21), 1, 60, 4)
    marked, iou = apart_and_zero(boxes, boxes)
    assert marked.float().mean() > 0.5
    assert ((iou == 0) & ~marked).any()
    assert not (marked & (iou > 0)).any()


def test_rbox_apart_at_class_offset_centres():
    """After class offsets, centres up to ~5·10⁴ px: every pair of different
    classes is marked, and every marked pair has IoU 0 in both dtypes."""
    boxes, _, labels = rotated(np.random.default_rng(22), 1, 40, 5, hw=800.0)
    labels = np.random.default_rng(23).integers(0, 20, labels.shape)
    shifted = pnms.class_offset_boxes(_t(boxes), _t(labels))
    assert shifted[..., :2].abs().max() > 3e4
    marked, _ = apart_and_zero(shifted.numpy(), shifted.numpy())
    other = labels[0][:, None] != labels[0][None, :]
    assert marked[0][torch.from_numpy(other)].all()


@pytest.mark.parametrize("centre", [0.0, 1e4, 5e4])
def test_rbox_apart_at_the_margin(centre):
    """Pairs whose centres lie at (1 ± δ)·gap of each other, gap the test's
    own, any angle and aspect, around centres up to 5·10⁴ px, δ 1e-6 plus
    the fp32 rounding of the centres (2⁻²² of their coordinates, relative to
    the distance): those just past are marked (fp32 may round a few either
    way) and have IoU 0, those just inside are not marked."""
    rng = np.random.default_rng(int(centre) + 31)
    n = 400
    a = np.stack([centre + rng.uniform(-100, 100, n), centre + rng.uniform(-100, 100, n),
                  rng.uniform(2, 90, n), rng.uniform(2, 90, n),
                  rng.uniform(-math.pi / 2, math.pi / 2, n)], -1)
    b = a.copy()
    b[:, 2:4] = rng.uniform(2, 90, (n, 2))
    b[:, 4] = rng.uniform(-math.pi / 2, math.pi / 2, n)
    phi = rng.uniform(0, 2 * math.pi, n)
    reach = 0.5 * np.hypot(a[:, 2], a[:, 3]) + 0.5 * np.hypot(b[:, 2], b[:, 3])
    # the test's gap at the distance it will see: solve dist = gap for dist
    dist = reach * (1 + prb.APART_MARGIN) / (
        1 - prb.APART_MARGIN * (np.abs(np.cos(phi)) + np.abs(np.sin(phi))))
    delta = 1e-6 + 2.0 ** -22 * (centre + 200) / dist
    for side, want in ((1 + delta, True), (1 - delta, False)):
        b[:, 0] = a[:, 0] + dist * side * np.cos(phi)
        b[:, 1] = a[:, 1] + dist * side * np.sin(phi)
        a32, b32 = a.astype(np.float32)[:, None], b.astype(np.float32)[:, None]
        marked, _ = apart_and_zero(a32, b32)
        hits = marked[:, 0, 0]
        assert hits.float().mean() > 0.9 if want else not hits.any()


def test_rbox_apart_never_marks_a_box_of_zero_area():
    """Zero width, zero height or both, however far: never marked."""
    rng = np.random.default_rng(41)
    b = np.stack([rng.uniform(1e3, 5e4, 50), rng.uniform(1e3, 5e4, 50),
                  rng.uniform(1, 50, 50), rng.uniform(1, 50, 50), rng.uniform(-1, 1, 50)], -1)
    for w, h in ((0.0, 10.0), (10.0, 0.0), (0.0, 0.0)):
        a = np.array([[0.0, 0.0, w, h, 0.3]])
        assert not prb.rbox_apart(_t(a).float(), _t(b).float()).any()
        assert not prb.rbox_apart(_t(b).float(), _t(a).float()).any()


# ------------------------------------------------- N1's division-free test --

ABOVE = np.float32(1 + 2.0 ** -20)
BELOW = np.float32(1 - 2.0 ** -20)


def above_without_division(inter, denom, thr):
    """csrc/nms.cu's decision of fl(inter / denom) > thr, in fp32: at once
    outside thr·denom·(1 ± 2⁻²⁰), by the division inside the band."""
    thr = np.float32(thr)
    up, down = np.float32(thr * ABOVE) * denom, np.float32(thr * BELOW) * denom
    band = ~(inter > up) & ~(inter < down)
    return np.where(band, inter / denom > thr, inter > up), band


@pytest.mark.parametrize("thr", [0.1, 0.3, 0.5, 0.7, 0.123456789, 1e-3])
def test_division_free_decision_is_exact(thr):
    """Quotients within 64 ulps of thr and random ones: the decision equals
    the division's for every pair, and the band holds few of them."""
    rng = np.random.default_rng(int(thr * 1e6))
    denom = np.exp(rng.uniform(np.log(1e-6), np.log(1e8), 200_000)).astype(np.float32)
    k = rng.integers(-64, 65, denom.shape)
    inter = (np.float64(np.float32(thr)) * denom.astype(np.float64)
             * (1 + k * 2.0 ** -24)).astype(np.float32)
    inter[::2] = (denom[::2] * rng.uniform(0, 1, denom[::2].shape)).astype(np.float32)
    with np.errstate(over="ignore", under="ignore"):
        got, band = above_without_division(inter, denom, thr)
    np.testing.assert_array_equal(got, inter / denom > np.float32(thr))
    assert band.mean() < 0.25


def test_time_nms_imports_nothing_of_jax():
    """tools/time_nms.py runs on the machine with the card, which has no
    JAX: its imports (and chip_smoke's, which the hygiene test holds) name
    neither jax nor the JAX package."""
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).resolve().parents[1] / "tools" / "time_nms.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert "torch" in names and not names & {"jax", "flax", "mtp_tpu"}, names
