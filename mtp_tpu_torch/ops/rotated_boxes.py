"""Rotated-box geometry (port of `mtp_tpu/ops/rotated_boxes.py`): the le90
conversions, rotated IoU by the candidate-vertex method, and the two
rotated coders of Oriented R-CNN.

rboxes are (cx, cy, w, h, θ) with θ in radians; le90 keeps θ in
[−π/2, π/2) and, after `regularize_le90`, w the long side.

Rotated IoU (`rbox_overlaps`) follows JAX's algebra: a pair's intersection
polygon has its vertices among the 24 candidates {corners of A inside B}
∪ {corners of B inside A} ∪ {the 16 edge crossings}; the valid ones are
put in order of their angle about their centroid (ties to the lower
candidate index, as JAX's rank does) and reduced with the shoelace, area 0
below 3 candidates.  Unlike JAX, each pair is translated to its first
box's centre first (`rbox_overlaps_ref`): the same function, without the
fp32 cancellation that costs JAX whole IoU points at the class-offset
coordinates of the rotated test NMS.  On CPU tensors the plain version
runs, chunked over the pair grid; on CUDA tensors kernel R1
(csrc/rotated_iou.cu) launches, one thread a pair, in its dense form: the
(B, N, M) matrix (`rbox_iou`).  Its mask form, N1's suppression bitmask
with N1's scan, is the rotated NMS (`ops.nms.nms_keep`).  R1 raises on
what it cannot take and never falls back.  R1 gives IoU 0 at once to a
pair that `rbox_apart` (the plain version of its test) marks: both boxes
of positive area, their centres farther apart than their half-diagonals
reach plus a margin, so that the full computation would return 0 too.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from mtp_tpu_torch.kernels import _build
from mtp_tpu_torch.ops.boxes import bbox_overlaps

PI = math.pi
# pairs of one chunk of the plain version (~200 bytes of temporaries a pair)
PAIRS_PER_CHUNK = 1 << 16
# the floor of an IoU's denominator (JAX's default eps)
EPS = 1e-6
# R1's early exit: the gap past both half-diagonals that marks a pair apart,
# relative to |dx| + |dy| + the half-diagonals (csrc/rotated_iou.cu
# kApartMargin): ~1,700 fp32 ulps of the scale of the pair's coordinates
APART_MARGIN = 1e-4

LAUNCHES = {"rbox_iou": 0}


# ---------------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------------

def norm_angle_le90(theta: torch.Tensor) -> torch.Tensor:
    """θ into [−π/2, π/2): a floor mod, as JAX's `%`."""
    return torch.remainder(theta + PI / 2, PI) - PI / 2


def regularize_le90(rbox: torch.Tensor) -> torch.Tensor:
    """w >= h by swapping the sides (θ + π/2), then θ normalised."""
    cx, cy, w, h, t = rbox.unbind(-1)
    swap = w < h
    return torch.stack([cx, cy, torch.where(swap, h, w), torch.where(swap, w, h),
                        norm_angle_le90(torch.where(swap, t + PI / 2, t))], -1)


def rbox_to_corners(rbox: torch.Tensor) -> torch.Tensor:
    """(..., 5) → (..., 4, 2) corners, counter-clockwise in math axes."""
    cx, cy, w, h, t = rbox.unbind(-1)
    cos, sin = torch.cos(t)[..., None], torch.sin(t)[..., None]
    dx = torch.stack([-w, w, w, -w], -1) * 0.5
    dy = torch.stack([-h, -h, h, h], -1) * 0.5
    return torch.stack([cx[..., None] + dx * cos - dy * sin,
                        cy[..., None] + dx * sin + dy * cos], -1)


def rbox_to_hbox(rbox: torch.Tensor) -> torch.Tensor:
    """Axis-aligned bounding boxes (..., 4) x1y1x2y2 of rotated boxes."""
    c = rbox_to_corners(rbox)
    return torch.cat([c.amin(-2), c.amax(-2)], -1)


def hbox_to_rbox(hbox: torch.Tensor) -> torch.Tensor:
    """(..., 4) → (..., 5) at θ = 0, le90-regularised."""
    x1, y1, x2, y2 = hbox.unbind(-1)
    return regularize_le90(torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1,
                                        y2 - y1, torch.zeros_like(x1)], -1))


def qbox_to_rbox(quad: torch.Tensor) -> torch.Tensor:
    """Quadrilaterals (..., 8) → the minimum-area rectangles (..., 5), le90:
    each edge's direction tried as the orientation (the minimum-area
    rectangle of a convex hull is edge-aligned), the first of equal areas
    kept."""
    p = quad.reshape(quad.shape[:-1] + (1, 4, 2))                  # (..., 1, 4, 2)
    e = torch.roll(p, -1, -2) - p
    a = torch.atan2(e[..., 1], e[..., 0]).transpose(-1, -2)        # (..., 4, 1)
    c, s = torch.cos(-a), torch.sin(-a)
    px, py = p[..., 0], p[..., 1]                                   # (..., 1, 4)
    qx, qy = px * c - py * s, px * s + py * c                       # (..., 4, 4)
    mn = torch.stack([qx.amin(-1), qy.amin(-1)], -1)                # (..., 4, 2)
    mx = torch.stack([qx.amax(-1), qy.amax(-1)], -1)
    wh = mx - mn
    lx, ly = ((mn + mx) / 2).unbind(-1)
    c, s = c[..., 0], s[..., 0]
    rects = torch.stack([lx * c + ly * s, -lx * s + ly * c, wh[..., 0], wh[..., 1],
                         a[..., 0]], -1)                            # (..., 4, 5)
    best = torch.argmin(wh[..., 0] * wh[..., 1], -1)
    out = rects.gather(-2, best[..., None, None].expand(best.shape + (1, 5)))[..., 0, :]
    return regularize_le90(out)


# ---------------------------------------------------------------------------
# rotated IoU: the plain version
# ---------------------------------------------------------------------------

def _intersection_area(ca: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """Intersection areas of convex counter-clockwise quads ca, cb (P, 4, 2)
    → (P,), JAX's candidate-vertex method (its `_intersection_area`); the
    angle order is a stable sort, which is JAX's rank with its index
    tie-break."""
    P = ca.shape[0]
    a1, a2 = ca, torch.roll(ca, -1, -2)
    b1, b2 = cb, torch.roll(cb, -1, -2)

    def inside(p, v1, v2):
        """p (P, 4, 2) inside the quad of edges v1 → v2 (P, 4, 2): (P, 4)."""
        pc, e1, e2 = p[:, :, None, :], v1[:, None, :, :], v2[:, None, :, :]
        s = ((e2[..., 0] - e1[..., 0]) * (pc[..., 1] - e1[..., 1])
             - (e2[..., 1] - e1[..., 1]) * (pc[..., 0] - e1[..., 0]))
        return (s >= 0.0).all(-1)

    # 16 crossings of A's edge p + t·r with B's edge q + u·s
    p, r = a1[:, :, None, :], (a2 - a1)[:, :, None, :]
    q, s = b1[:, None, :, :], (b2 - b1)[:, None, :, :]
    rxs = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    qp = q - p
    safe = torch.where(rxs.abs() < 1e-12, 1e-12, rxs)
    t = (qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]) / safe
    u = (qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]) / safe
    x_ok = (rxs.abs() > 1e-12) & (t >= 0.0) & (t <= 1.0) & (u >= 0.0) & (u <= 1.0)
    xpts = p + t[..., None] * r                                     # (P, 4, 4, 2)

    pts = torch.cat([ca, cb, xpts.reshape(P, 16, 2)], 1)            # (P, 24, 2)
    val = torch.cat([inside(ca, b1, b2), inside(cb, a1, a2), x_ok.reshape(P, 16)], 1)
    pts = torch.where(val[..., None], pts, 0.0)
    cnt = val.sum(-1)
    ctr = pts.sum(1) / cnt.clamp(min=1)[:, None]
    ang = torch.where(val, torch.atan2(pts[..., 1] - ctr[:, None, 1],
                                       pts[..., 0] - ctr[:, None, 0]), math.inf)
    order = torch.argsort(ang, dim=-1, stable=True)
    x, y = pts[..., 0].gather(1, order), pts[..., 1].gather(1, order)
    # the ring closes at the last valid vertex; the invalid tail adds 0
    k = torch.arange(24, device=ca.device)
    nxt = torch.where(k[None] + 1 < cnt[:, None], k[None] + 1, 0)
    live = k[None] < cnt[:, None]
    xn = torch.where(live, x.gather(1, nxt), 0.0)
    yn = torch.where(live, y.gather(1, nxt), 0.0)
    area = 0.5 * (x * yn - xn * y).sum(-1).abs()
    return torch.where(cnt >= 3, area, 0.0)


def _ccw(c: torch.Tensor) -> torch.Tensor:
    """(..., 4, 2) corners in counter-clockwise order (reversed where the
    signed shoelace area is negative)."""
    x, y = c[..., 0], c[..., 1]
    area2 = (x * torch.roll(y, -1, -1) - torch.roll(x, -1, -1) * y).sum(-1)
    return torch.where(area2[..., None, None] < 0, c.flip(-2), c)


def _pairwise_inter(n: int, M: int, lead: tuple, pair_corners) -> torch.Tensor:
    """Intersection areas of every pair of an (..., n, ·) × (..., M, ·)
    grid → (..., n, M), over chunks of about PAIRS_PER_CHUNK pairs:
    `pair_corners(r0, r1)` gives the counter-clockwise corners (..., r1 −
    r0, M, 4, 2) of both boxes of the pairs of rows r0..r1."""
    batch = max(1, math.prod(lead))
    rows = max(1, PAIRS_PER_CHUNK // max(1, M * batch))
    parts = []
    for r0 in range(0, n, rows):
        ca, cb = pair_corners(r0, min(n, r0 + rows))
        parts.append(_intersection_area(ca.reshape(-1, 4, 2), cb.reshape(-1, 4, 2))
                     .reshape(ca.shape[:-2]))
    return torch.cat(parts, -2) if parts else torch.zeros(lead + (n, M))


def _centred(rbox: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """rbox with its centre moved by −origin (..., 2), broadcast."""
    centre = rbox[..., :2] - origin
    return torch.cat([centre, rbox[..., 2:].expand(centre.shape[:-1] + (3,))], -1)


def rbox_overlaps_ref(a: torch.Tensor, b: torch.Tensor, mode: str = "iou") -> torch.Tensor:
    """The plain version of `rbox_overlaps`: JAX's algebra on each pair
    translated to a's centre, as R1 computes it.  JAX forms the corners and
    the shoelace at the boxes' own coordinates, which after
    `class_offset_boxes` (centres up to ~5·10⁴ px) costs whole IoU points:
    the shoelace's products reach ~10⁹ px², whose fp32 spacing is ~10² px²."""
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a, b = a.expand(lead + a.shape[-2:]), b.expand(lead + b.shape[-2:])
    N, M = a.shape[-2], b.shape[-2]
    ca = _ccw(rbox_to_corners(_centred(a, a[..., :2])))                 # (..., N, 4, 2)

    def pair_corners(r0, r1):
        ar = a[..., r0:r1, None, :]
        cb = _ccw(rbox_to_corners(_centred(b[..., None, :, :], ar[..., :2])))
        return ca[..., r0:r1, None, :, :].expand(cb.shape), cb

    inter = _pairwise_inter(N, M, lead, pair_corners).to(a.dtype)
    area_a = (a[..., 2] * a[..., 3])[..., :, None]
    if mode == "iof":
        denom = area_a
    else:
        denom = area_a + (b[..., 2] * b[..., 3])[..., None, :] - inter
    return inter / denom.clamp(min=EPS)


def rbox_apart(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The pairs of a (..., N, 5) × b (..., M, 5) → (..., N, M) bool that R1
    gives IoU 0 without forming them (csrc/rotated_iou.cu `apart`, the same
    operations, each rounded in the inputs' dtype): both boxes of positive
    area (w > 0 and h > 0; a box of zero area passes the inside test all
    along its line), and dx² + dy² > gap², gap = reach + APART_MARGIN ·
    (|dx| + |dy| + reach), where (dx, dy) is b's centre less a's and reach
    the sum of their half-diagonals, ½·√(w² + h²).  The boxes are then
    disjoint by at least the margin, many times the rounding of their
    corners, and their rotated IoU is 0."""
    def reach(r):
        return 0.5 * torch.sqrt(r[..., 2] * r[..., 2] + r[..., 3] * r[..., 3])

    def positive(r):
        return (r[..., 2] > 0) & (r[..., 3] > 0)

    dx = b[..., None, :, 0] - a[..., :, None, 0]
    dy = b[..., None, :, 1] - a[..., :, None, 1]
    both = reach(a)[..., :, None] + reach(b)[..., None, :]
    gap = both + APART_MARGIN * (dx.abs() + dy.abs() + both)
    return (positive(a)[..., :, None] & positive(b)[..., None, :]
            & (dx * dx + dy * dy > gap * gap))


def quad_overlaps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of convex quadrilaterals a (N, 8) and b (M, 8) → (N, M) (mmcv
    `box_iou_quadri`), each pair translated to the mean of a's corners;
    plain PyTorch only (the host's DOTA/FAIR1M merge)."""
    ca, cb = _ccw(a.reshape(-1, 4, 2)), _ccw(b.reshape(-1, 4, 2))

    def shoelace(c):
        x, y = c[..., 0], c[..., 1]
        return 0.5 * (x * torch.roll(y, -1, -1) - torch.roll(x, -1, -1) * y).sum(-1).abs()

    origin = ca.mean(-2, keepdim=True)                                  # (N, 1, 2)
    ca0 = ca - origin

    def pair_corners(r0, r1):
        cbr = cb[None] - origin[r0:r1, None]                            # (n, M, 4, 2)
        return ca0[r0:r1, None].expand(cbr.shape), cbr

    inter = _pairwise_inter(ca.shape[0], cb.shape[0], (), pair_corners).to(a.dtype)
    area_a, area_b = shoelace(ca0), shoelace(cb - cb.mean(-2, keepdim=True))
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp(min=EPS)


def rbox2hbox_overlaps(rboxes: torch.Tensor, hboxes: torch.Tensor) -> torch.Tensor:
    """IoU of the rboxes' bounding boxes with hboxes (mmrotate
    RBbox2HBboxOverlaps2D)."""
    return bbox_overlaps(rbox_to_hbox(rboxes), hboxes)


# ---------------------------------------------------------------------------
# rotated IoU: kernel R1
# ---------------------------------------------------------------------------

def _check_r1(what: str, *tensors: torch.Tensor) -> None:
    """R1 takes fp32, contiguous tensors on one CUDA device."""
    _build.check_on_card(f"R1 ({what})", *tensors)
    _build.check_launchable(**{f"input {i}": t for i, t in enumerate(tensors)})


def rbox_iou(a: torch.Tensor, b: torch.Tensor, mode: str = "iou") -> torch.Tensor:
    """Kernel R1, dense form: a (B, N, 5) and b (B, M, 5) fp32 on the card →
    (B, N, M) fp32."""
    _check_r1("dense", a, b)
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or \
            a.shape[-1] != 5 or b.shape[-1] != 5:
        raise ValueError(f"R1 takes (B, N, 5) and (B, M, 5), got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    from mtp_tpu_torch.ops.nms import NMS_MAX_BOXES  # ops.nms imports this module
    B, N, M = a.shape[0], a.shape[1], b.shape[1]
    if not (0 < N <= NMS_MAX_BOXES and 0 < M <= NMS_MAX_BOXES and 0 < B <= 65535):
        raise ValueError(f"R1 takes 1 to {NMS_MAX_BOXES} boxes a side and 1 to 65,535 "
                         f"images, got B {B}, N {N}, M {M}")
    out = torch.empty(B, N, M, dtype=torch.float32, device=a.device)
    _build.launch("mtp_rbox_iou", a.data_ptr(), b.data_ptr(), out.data_ptr(), B, N, M,
                  int(mode == "iof"), _build.dtype_code(a))
    LAUNCHES["rbox_iou"] += 1
    return out


def check_mode(mode: str) -> None:
    if mode not in ("iou", "iof"):
        raise ValueError(f"mode {mode!r}")


def rbox_overlaps(a: torch.Tensor, b: torch.Tensor, mode: str = "iou") -> torch.Tensor:
    """Pairwise rotated IoU (or IoF, inter / area(a)) of a (..., N, 5) and b
    (..., M, 5) → (..., N, M), eps 1e-6, by the op mtp::rbox_overlaps
    (`_rbox_overlaps`): CPU tensors run the plain version; CUDA tensors
    kernel R1's dense form, with a and b given the same leading
    dimensions."""
    return torch.ops.mtp.rbox_overlaps.default(a, b, mode)


def _rbox_overlaps(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """The body of the op mtp::rbox_overlaps (`rbox_overlaps`)."""
    check_mode(mode)
    if not _build.use_kernel(a, b):
        return rbox_overlaps_ref(a, b, mode)
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(lead + a.shape[-2:]).reshape(-1, *a.shape[-2:]).contiguous()
    b3 = b.expand(lead + b.shape[-2:]).reshape(-1, *b.shape[-2:]).contiguous()
    return rbox_iou(a3, b3, mode).reshape(lead + (a.shape[-2], b.shape[-2]))


# ---------------------------------------------------------------------------
# DeltaXYWHT rbox coder (le90, proj_xy, edge_swap)
# ---------------------------------------------------------------------------

def delta_encode_rbox(proposals: torch.Tensor, gts: torch.Tensor,
                      means: Sequence[float] = (0., 0., 0., 0., 0.),
                      stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2, 0.1)) -> torch.Tensor:
    """proposals, gts (..., 5) → deltas (..., 5): the centre offset projected
    on the proposal's axes; of the gt's (w, h, θ) and (h, w, θ + π/2) the
    one whose normalised angle difference is strictly smaller in magnitude
    (edge swap), the angle over π."""
    px, py, pw, ph, pt = proposals.unbind(-1)
    gx, gy, gw, gh, gt_ = gts.unbind(-1)
    pw, ph = pw.clamp(min=1e-6), ph.clamp(min=1e-6)
    cos, sin = torch.cos(pt), torch.sin(pt)
    dx = (cos * (gx - px) + sin * (gy - py)) / pw
    dy = (-sin * (gx - px) + cos * (gy - py)) / ph
    dt1 = norm_angle_le90(gt_ - pt)
    dt2 = norm_angle_le90(gt_ - pt + PI / 2)
    swap = dt2.abs() < dt1.abs()
    dw = torch.log(torch.where(swap, gh, gw).clamp(min=1e-6) / pw)
    dh = torch.log(torch.where(swap, gw, gh).clamp(min=1e-6) / ph)
    d = torch.stack([dx, dy, dw, dh, torch.where(swap, dt2, dt1) / PI], -1)
    return (d - d.new_tensor(means)) / d.new_tensor(stds)


def delta_decode_rbox(rois: torch.Tensor, deltas: torch.Tensor,
                      means: Sequence[float] = (0., 0., 0., 0., 0.),
                      stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2, 0.1),
                      wh_ratio_clip: float = 16 / 1000) -> torch.Tensor:
    """rois (..., 5), deltas (..., 5) → boxes (..., 5), le90-regularised; dw
    and dh clipped to ±|log(wh_ratio_clip)|."""
    d = deltas * deltas.new_tensor(stds) + deltas.new_tensor(means)
    dx, dy, dw, dh, dt = d.unbind(-1)
    max_ratio = abs(math.log(wh_ratio_clip))
    dw, dh = dw.clamp(-max_ratio, max_ratio), dh.clamp(-max_ratio, max_ratio)
    px, py, pw, ph, pt = rois.unbind(-1)
    cos, sin = torch.cos(pt), torch.sin(pt)
    return regularize_le90(torch.stack([
        px + pw * dx * cos - ph * dy * sin, py + pw * dx * sin + ph * dy * cos,
        pw * torch.exp(dw), ph * torch.exp(dh), norm_angle_le90(dt * PI + pt)], -1))


# ---------------------------------------------------------------------------
# MidpointOffset coder (the oriented RPN: hbox anchor → oriented proposal)
# ---------------------------------------------------------------------------

def _hbox_centre_size(boxes: torch.Tensor):
    """(cx, cy, w, h) of x1y1x2y2 boxes, sides at least 1e-6."""
    return ((boxes[..., 0] + boxes[..., 2]) * 0.5, (boxes[..., 1] + boxes[..., 3]) * 0.5,
            (boxes[..., 2] - boxes[..., 0]).clamp(min=1e-6),
            (boxes[..., 3] - boxes[..., 1]).clamp(min=1e-6))


def midpoint_encode(anchors: torch.Tensor, gts_rbox: torch.Tensor,
                    means: Sequence[float] = (0.,) * 6,
                    stds: Sequence[float] = (1., 1., 1., 1., 0.5, 0.5)) -> torch.Tensor:
    """anchors (..., 4) hboxes, gts (..., 5) rboxes → deltas (..., 6): the
    gt's bounding box against the anchor (dx, dy, dw, dh), and the offsets
    (da, db) of its top vertex (the first of least y) along the top edge
    and of its right vertex (the first of most x) along the right edge."""
    corners = rbox_to_corners(gts_rbox)
    cx_, cy_ = corners[..., 0], corners[..., 1]
    xmin, xmax, ymin, ymax = cx_.amin(-1), cx_.amax(-1), cy_.amin(-1), cy_.amax(-1)
    gx, gy = (xmin + xmax) * 0.5, (ymin + ymax) * 0.5
    gw, gh = xmax - xmin, ymax - ymin
    x_top = cx_.gather(-1, cy_.argmin(-1, keepdim=True))[..., 0]
    y_right = cy_.gather(-1, cx_.argmax(-1, keepdim=True))[..., 0]
    da = (x_top - gx) / gw.clamp(min=1e-6)
    db = (y_right - gy) / gh.clamp(min=1e-6)
    px, py, pw, ph = _hbox_centre_size(anchors)
    d = torch.stack([(gx - px) / pw, (gy - py) / ph,
                     torch.log(gw.clamp(min=1e-6) / pw),
                     torch.log(gh.clamp(min=1e-6) / ph), da, db], -1)
    return (d - d.new_tensor(means)) / d.new_tensor(stds)


def midpoint_decode(anchors: torch.Tensor, deltas: torch.Tensor,
                    means: Sequence[float] = (0.,) * 6,
                    stds: Sequence[float] = (1., 1., 1., 1., 0.5, 0.5),
                    wh_ratio_clip: float = 16 / 1000) -> torch.Tensor:
    """anchors (..., 4) + deltas (..., 6) → oriented proposals (..., 5),
    le90: the midpoint parallelogram rectified as mmrotate's
    MidpointOffsetCoder does, each vertex scaled about the centre to the
    LONGER diagonal (not the minimum-area rectangle, which collapses as the
    parallelogram flattens)."""
    d = deltas * deltas.new_tensor(stds) + deltas.new_tensor(means)
    dx, dy, dw, dh, da, db = d.unbind(-1)
    max_ratio = abs(math.log(wh_ratio_clip))
    dw, dh = dw.clamp(-max_ratio, max_ratio), dh.clamp(-max_ratio, max_ratio)
    px, py, pw, ph = _hbox_centre_size(anchors)
    gx, gy = px + pw * dx, py + ph * dy
    gw, gh = pw * torch.exp(dw), ph * torch.exp(dh)
    da, db = da.clamp(-0.5, 0.5), db.clamp(-0.5, 0.5)
    u = torch.stack([da * gw, -gh / 2], -1)     # top vertex − centre
    v = torch.stack([gw / 2, db * gh], -1)      # right vertex − centre
    ru = torch.sqrt((u * u).sum(-1))
    rv = torch.sqrt((v * v).sum(-1))
    r = torch.maximum(ru, rv)
    u = u * (r / ru.clamp(min=1e-6))[..., None]
    v = v * (r / rv.clamp(min=1e-6))[..., None]
    e1, e2 = v - u, v + u
    return regularize_le90(torch.stack([
        gx, gy, torch.sqrt((e1 * e1).sum(-1)), torch.sqrt((e2 * e2).sum(-1)),
        torch.atan2(e1[..., 1], e1[..., 0])], -1))
