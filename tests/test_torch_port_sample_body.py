"""K3's and K6's bodies (bilinear multi-tap sampling, forward and backward):
the rule that picks the scalar, vector or tiled body, that its limits are
the kernels' (csrc/sample_body.cuh), what each wrapper asks of the card,
the tiled body's out-of-halo share, and the sampled function at offsets
that reach past the tiled body's regions, against the JAX Pallas
kernel in interpret mode.

The bodies themselves run only on the card (`chip_smoke.py` phases 3, 3b
and 3c hold every one against the plain versions there).  Here the wrappers
run with the kernel route forced and each launch stubbed, which shows the
body and shapes the card would be given.  Inputs are made with numpy from
a seed.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.ops.dcnv3_pallas import dcnv3_sample as jax_dcnv3_sample
from mtp_tpu_torch.kernels import _build
from mtp_tpu_torch.ops import dcnv3_sample as dcn
from mtp_tpu_torch.ops.dcnv3 import sampling_points

torch.set_num_threads(1)

BF16, FP32 = torch.bfloat16, torch.float32
CSRC = Path(dcn.__file__).parents[1] / "csrc"


@pytest.fixture
def launches(monkeypatch):
    """The kernel route forced on CPU tensors, each launch recorded as
    (launcher, its arguments after the data pointers: BG, H, W, C, HWo, P,
    body, dtype code) instead of run (outputs stay uninitialised); the
    counters start at 0."""
    requested = []
    pointers = {"mtp_bilinear_sample_fwd": 5, "mtp_bilinear_sample_bwd": 9}
    monkeypatch.setattr(_build, "use_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "launch", lambda name, *a: requested.append(
        (name, a[pointers[name]:])))
    monkeypatch.setattr(dcn, "LAUNCHES", dict.fromkeys(dcn.LAUNCHES, 0))
    return requested


# (what, C, P, dtype, aligned, same_grid) → (forward body, backward body)
PATH_SHAPES = [
    # RVSA's K/V sampling (ViT serving, training and the 2080² path): one
    # tap a pixel on a map of the window grid's own size
    ("rvsa bf16", 64, 1, BF16, True, True, "vector", "vector"),
    ("rvsa fp32", 64, 1, FP32, True, True, "vector", "vector"),
    # InternImage-XL: gc = 16 at every stage (192/12 … 1536/96)
    ("xl bf16", 16, 9, BF16, True, True, "vector", "tiled"),
    ("xl fp32", 16, 9, FP32, True, True, "vector", "tiled"),
    # chip_smoke's edge shapes
    ("edge P=9 HWo != H·W", 32, 9, BF16, True, False, "vector", "vector"),
    ("edge P=9 tile", 32, 9, BF16, True, True, "vector", "tiled"),
    ("edge C=12 bf16", 12, 9, BF16, True, True, "scalar", "scalar"),
    ("edge C=12 fp32", 12, 9, FP32, True, True, "scalar", "scalar"),
    # the rule's other limits
    ("unaligned", 16, 9, BF16, False, True, "scalar", "scalar"),
    ("6 runs", 48, 9, BF16, True, True, "scalar", "scalar"),
    ("one run", 8, 9, BF16, True, True, "vector", "tiled"),
    ("C=64 tiled", 64, 9, BF16, True, True, "vector", "tiled"),
    ("tile over the limit", 256, 9, BF16, True, True, "vector", "vector"),
    ("32 runs", 128, 1, FP32, True, False, "vector", "vector"),
    ("64 runs", 512, 1, BF16, True, False, "scalar", "scalar"),
    ("P=4 loops", 16, 4, BF16, True, True, "vector", "vector"),
    ("P over MAX_TAPS", 16, 33, BF16, True, True, "scalar", "scalar"),
]


@pytest.mark.parametrize("what,C,P,dtype,aligned,same_grid,fwd,bwd", PATH_SHAPES,
                         ids=[s[0] for s in PATH_SHAPES])
def test_sample_body_by_shape(what, C, P, dtype, aligned, same_grid, fwd, bwd):
    assert dcn.sample_body(C, P, dtype, aligned, same_grid=same_grid) == fwd
    assert dcn.sample_body(C, P, dtype, aligned, bwd=True, same_grid=same_grid) == bwd
    for body, is_bwd in ((fwd, False), (bwd, True)):
        assert dcn.sample_smem_bytes(body, C, P, dtype, is_bwd) <= dcn.SMEM_LIMIT


def test_sample_body_limits_match_the_kernels():
    """`sample_body`'s limits are the ones K3's and K6's C entry points
    check the requested body against (`smp::body` over the constants of
    csrc/sample_body.cuh), and its body codes theirs, so that no body the
    wrappers pick is refused; the tiled body's shared memory at XL's gc = 16
    is under the 227 KB one block may use."""
    src = (CSRC / "sample_body.cuh").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts == {"kVecBytes": dcn.VEC_BYTES, "kMaxRunThreads": dcn.MAX_RUN_THREADS,
                      "kMaxTaps": dcn.MAX_TAPS, "kFwdThreads": dcn.FWD_THREADS,
                      "kBwdThreads": dcn.BWD_THREADS, "kTiledThreads": dcn.TILED_THREADS,
                      "kTile": dcn.TILE,
                      "kHalo": dcn.HALO, "kSmemLimit": dcn.SMEM_LIMIT}
    enum = re.search(r"enum Body : int \{(.*?)\};", src).group(1)
    assert dict(re.findall(r"k(\w+) = (\d+)", enum)) == {
        name.capitalize(): str(code) for name, code in dcn.BODIES.items()}
    rule = re.search(r"inline Body body\(.*?\{(.*?)\n\}", src, re.S).group(1)
    assert "P > kMaxTaps" in rule and "bwd && P == 9 && same_grid" in rule
    assert "pixels * 9 * 3 + pixels * C + pixels * 9 * 4" in src
    assert "2 * cells + 1 + kTiledThreads / 32" in src
    for name in ("bilinear_sample_fwd.cu", "bilinear_sample_bwd.cu"):
        cases = re.findall(r"case (\d+):\s*\n\s*return launch_vec<T, (\d+)",
                           (CSRC / name).read_text())
        assert cases and all(a == b for a, b in cases)
        assert tuple(int(a) for a, _ in cases) == dcn.UNROLLED_TAPS
    assert dcn.SMEM_LIMIT == 227 * 1024
    tiled = dcn.sample_smem_bytes("tiled", 16, 9, BF16, True)
    assert tiled == 4 * (256 * 9 * 3 + 256 * 16 + 256 * 36) + 4 * (2 * 32 ** 2 + 1 + 16) \
        + 2 * 256 * 36
    assert 2 * tiled < 227 * 1024  # two blocks an SM
    assert dcn.sample_smem_bytes("vector", 64, 1, BF16, False) == 128 // 8 * 3 * 4


def _sample_inputs(BG, H, W, C, HWo, P, dtype, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    img = t(rng.standard_normal((BG, H * W, C))).to(dtype)
    py, px = (t(rng.uniform(-1, n, (BG, HWo, P))) for n in (H, W))
    return img, py, px, torch.ones(BG, HWo, P)


# (path, BG, H, W, C, P, dtype): one (image·group) batch of each path at its
# map size (BG cut to keep the CPU's buffers small; the body does not
# depend on it)
PATHS = [
    ("vit rvsa 28²", 2, 28, 28, 64, 1, BF16),
    ("vit 2080² rvsa 130²", 1, 130, 130, 64, 1, BF16),
    ("xl stage 0", 2, 128, 128, 16, 9, BF16),
    ("xl stage 1", 2, 64, 64, 16, 9, BF16),
    ("xl stage 2", 2, 32, 32, 16, 9, BF16),
    ("xl stage 3", 2, 16, 16, 16, 9, BF16),
    ("xl fp32 stage 3", 2, 16, 16, 16, 9, FP32),
]


@pytest.mark.parametrize("path,BG,H,W,C,P,dtype", PATHS, ids=[p[0] for p in PATHS])
def test_what_each_wrapper_asks_of_the_card(launches, path, BG, H, W, C, P, dtype):
    """Forward and backward through `dcnv3_sample` at a path's shape: one
    launch each, of the body `sample_body` picks, with the path's sizes,
    and the wrappers' outputs in the shapes and dtypes the paths take."""
    img, py, px, m = _sample_inputs(BG, H, W, C, H * W, P, dtype)
    img.requires_grad_()
    py.requires_grad_()
    out = dcn.dcnv3_sample(img, py, px, m, H, W)
    out.backward(torch.zeros_like(out))
    fwd = dcn.BODIES[dcn.sample_body(C, P, dtype, True)]
    bwd = dcn.BODIES[dcn.sample_body(C, P, dtype, True, bwd=True, same_grid=True)]
    code = _build.DTYPE_CODES[dtype]
    assert launches == [("mtp_bilinear_sample_fwd", (BG, H, W, C, H * W, P, fwd, code)),
                        ("mtp_bilinear_sample_bwd", (BG, H, W, C, H * W, P, bwd, code))]
    assert dcn.LAUNCHES == {"bilinear_sample": 1, "bilinear_sample_bwd": 1}
    assert fwd == dcn.BODIES["vector"]
    assert bwd == dcn.BODIES["tiled" if P == 9 else "vector"]
    assert out.shape == (BG, H * W, C) and out.dtype == dtype
    assert img.grad.shape == img.shape and img.grad.dtype == dtype
    assert py.grad.dtype == FP32


def test_unaligned_storage_and_odd_channels_ask_for_the_scalar_body(launches):
    """Storage off a 16-byte boundary, and C = 12 (24 bf16 bytes, not whole
    16-byte runs), go to the scalar body, which takes any alignment and C;
    the output grid off the map's sends the backward to the vector body."""
    img, py, px, m = _sample_inputs(2, 9, 10, 16, 90, 9, BF16)
    # contiguous, 2 bytes off a 16-byte boundary
    misaligned = torch.empty(img.numel() + 8, dtype=BF16)[1:1 + img.numel()]
    misaligned = misaligned.view(img.shape).copy_(img)
    assert misaligned.data_ptr() % 16 and misaligned.is_contiguous()
    g = torch.zeros(2, 90, 16, dtype=BF16)
    dcn.dcnv3_sample(misaligned, py, px, m, 9, 10)
    dcn.dcnv3_sample_bwd(misaligned, py, px, m, g, 9, 10)
    img12 = torch.zeros(2, 90, 12, dtype=BF16)
    dcn.dcnv3_sample(img12, py, px, m, 9, 10)
    dcn.dcnv3_sample_bwd(img12, py, px, m, torch.zeros(2, 90, 12, dtype=BF16), 9, 10)
    img16 = torch.zeros(2, 90, 16, dtype=BF16)
    dcn.dcnv3_sample_bwd(img16, py[:, :80].contiguous(), px[:, :80].contiguous(),
                         m[:, :80].contiguous(), g[:, :80].contiguous(), 9, 10)
    bodies = [a[-2] for _, a in launches]
    assert bodies == [dcn.BODIES[b] for b in
                      ("scalar", "scalar", "scalar", "scalar", "vector")]


def test_out_of_halo_share():
    """At init-like offsets (every tap within 2 pixels of its output pixel)
    no corner leaves its tile's region; a tap moved HALO + TILE pixels away
    does, and a zero-weight corner (a tap on an integer coordinate) is not
    an add."""
    H = W = 40
    zero = torch.zeros(1, H, W, 9 * 2)
    mask = torch.full((1, H, W, 9), 1 / 9)
    py, px, m = sampling_points(zero, mask, group=1, offset_scale=2.0)
    assert dcn.out_of_halo_share(py, px, m, H, W) == 0.0
    far = py.clone()
    far[0, 0, 4] += dcn.HALO + dcn.TILE  # the centre tap of pixel (0, 0)
    # that tap, on an integer coordinate, adds its one nonzero-weight corner
    added = sum(int(n) for n in _adds(py, px, m, H, W))
    assert dcn.out_of_halo_share(far, px, m, H, W) == pytest.approx(1 / added)
    with pytest.raises(ValueError, match="grid"):
        dcn.out_of_halo_share(py[:, :10], px[:, :10], m[:, :10], H, W)


def _adds(py, px, m, H, W):
    """The count of nonzero-weight in-map corners of each corner position."""
    y0, x0 = torch.floor(py), torch.floor(px)
    for dy, wy in ((0, 1 - (py - y0)), (1, py - y0)):
        for dx, wx in ((0, 1 - (px - x0)), (1, px - x0)):
            yy, xx = y0 + dy, x0 + dx
            yield ((yy >= 0) & (yy < H) & (xx >= 0) & (xx < W) & (m * wy * wx != 0)).sum()


def _far_inputs(seed, N, H, W, G, gc):
    """DCNv3's sampling inputs (`sampling_points`, kernel 3, offset_scale 2)
    at offsets N(0, 8²) pixels before the scale, so that taps land up to ~50
    pixels from their output pixel, far past a 16-pixel halo; a softmaxed
    mask, the map and an output cotangent."""
    rng = np.random.default_rng(seed)
    off = (rng.standard_normal((N, H, W, G * 18)) * 8).astype(np.float32)
    logits = rng.standard_normal((N, H, W, G, 9))
    mask = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    py, px, m = sampling_points(torch.from_numpy(off),
                                torch.from_numpy(mask.reshape(N, H, W, G * 9)),
                                group=G, offset_scale=2.0)
    img = rng.standard_normal((N * G, H * W, gc)).astype(np.float32)
    g = rng.standard_normal((N * G, H * W, gc)).astype(np.float32)
    return img, py.numpy(), px.numpy(), m.numpy(), g


def test_bilinear_sample_matches_pallas_beyond_the_halo():
    """P = 9, gc = 16 on the map's own grid (the tiled body's inputs on the
    card) with most taps beyond their tile's region: the port against the JAX
    Pallas forward in interpret mode, fp32 (sums of 36 weighted corners in
    another order)."""
    H, W = 40, 48
    img, py, px, m, _ = _far_inputs(3, 1, H, W, 2, 16)
    assert dcn.out_of_halo_share(*map(torch.from_numpy, (py, px, m)), H, W) > 0.3
    ref = jax_dcnv3_sample(*map(jnp.asarray, (img, py, px, m)), H, W, True)
    got = dcn.dcnv3_sample(*map(torch.from_numpy, (img, py, px, m)), H, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_bilinear_sample_backward_matches_pallas_beyond_the_halo():
    """The same inputs through the backward: dimg (a scatter past the
    halo), dpy, dpx and dm against the JAX Pallas VJP in interpret mode,
    fp32 (sums of up to 4·9·gc products in another order)."""
    H, W = 40, 48
    img, py, px, m, g = _far_inputs(4, 1, H, W, 2, 16)
    _, vjp = jax.vjp(lambda *a: jax_dcnv3_sample(*a, H, W, True),
                     *map(jnp.asarray, (img, py, px, m)))
    ref = vjp(jnp.asarray(g))
    got = dcn.dcnv3_sample_bwd(*map(torch.from_numpy, (img, py, px, m, g)), H, W)
    for name, a, b in zip(("dimg", "dpy", "dpx", "dm"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("mangled,label", [
    ("_ZN12_GLOBAL__N_121flash_fwd_tc_kernelILi64EEEvPK13__nv_bfloat16S3_",
     "flash_fwd_tc_kernel<64>"),
    ("_ZN12_GLOBAL__N_126bilinear_sample_fwd_kernelIfEEvPKT_PKfS5_",
     "bilinear_sample_fwd_kernel<f>"),
    ("_ZN12_GLOBAL__N_130bilinear_sample_fwd_vec_kernelI13__nv_bfloat16Li9EEEvPKT_",
     "bilinear_sample_fwd_vec_kernel<nv_bfloat16, 9>"),
    ("_ZN12_GLOBAL__N_130bilinear_sample_bwd_vec_kernelIfLi1ELb0EEEvPKT_",
     "bilinear_sample_bwd_vec_kernel<f, 1, false>"),
    ("_ZN12_GLOBAL__N_132bilinear_sample_bwd_tiled_kernelI13__nv_bfloat16EEvPKfS4_",
     "bilinear_sample_bwd_tiled_kernel<nv_bfloat16>"),
    ("cudaLaunch", "cudaLaunch"),
])
def test_kernel_labels_name_every_template_argument(mangled, label):
    """The ptxas report (`_build.PTXAS_LOG`, chip_smoke's build phase) names
    each instantiation of the sampling bodies apart: element type, unrolled
    taps and whether the vector body scatters."""
    assert _build.kernel_label(mangled) == label
