"""The port's backward functions (K4 window attention, K5 flash attention, K6
bilinear sampling, and the gradients of grid_sample and the rel-pos biases
built on them) against the JAX package.

On the CPU the port's wrappers run their plain versions, the explicit VJPs
`*_bwd_ref`, so these tests hold them — which `chip_smoke.py` holds the CUDA
kernels against on the card — to the Pallas backward kernels run in
interpret mode, and to torch autograd of the port's own plain forwards.
Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.ops import rel_pos as jrp
from mtp_tpu.ops.dcnv3_pallas import dcnv3_sample as jax_dcnv3_sample
from mtp_tpu.ops.grid_sample import grid_sample as jax_grid_sample
from mtp_tpu.ops.pallas_attn import _flash_backward, _fused_backward
from mtp_tpu_torch.kernels import _build
from mtp_tpu_torch.ops import dcnv3_sample as dcn
from mtp_tpu_torch.ops import fused_attn
from mtp_tpu_torch.ops import rel_pos as prp
from mtp_tpu_torch.ops.grid_sample import grid_sample

torch.set_num_threads(1)

# fp32 on both sides; only the summation order differs
ATOL, RTOL = 1e-5, 1e-5
# bf16 inputs on both sides, fp32 math: the bf16 outputs (dq, dk, dv) may
# differ by one bf16 rounding
BF16_ATOL, BF16_RTOL = 2e-2, 1e-2


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref, atol=ATOL, rtol=RTOL, what=""):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=atol, rtol=rtol, err_msg=what)


def _autograd(fn, inputs, cot):
    """torch.autograd.grad of fn(*inputs) against the cotangent `cot`."""
    leaves = [x.detach().requires_grad_() for x in inputs]
    return torch.autograd.grad(fn(*leaves), leaves, cot)


# ---------------------------------------------------------------------- K4 --

@pytest.mark.parametrize("W,nH,N,D", [
    (4, 2, 49, 16),   # 7×7 windows: the TPU kernel packs two per tile
    (3, 3, 25, 8),    # 5×5 windows
    (5, 2, 49, 16),   # an odd window count: the packed tier pads a window
])
def test_window_attention_backward_matches_pallas(W, nH, N, D):
    rng = np.random.default_rng(W * 100 + N)
    q, k, v, do = (rng.standard_normal((W, nH, N, D)).astype(np.float32)
                   for _ in range(4))
    bias = (rng.standard_normal((W, nH, N, N)) * 0.5).astype(np.float32)
    scale = D ** -0.5
    ref = _fused_backward(*map(jnp.asarray, (q, k, v, bias, do)), scale=scale,
                          interpret=True)
    before = dict(fused_attn.LAUNCHES)
    got = fused_attn.fused_window_attention_bwd(_t(q), _t(k), _t(v), _t(bias),
                                                _t(do), scale)
    assert fused_attn.LAUNCHES == before  # CPU: plain version
    assert got[3].dtype == torch.float32
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, ref):
        _close(a, b, what=name)
    auto = _autograd(lambda *x: fused_attn.fused_window_attention_ref(*x, scale),
                     [_t(q), _t(k), _t(v), _t(bias)], _t(do))
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, auto):
        _close(a, b.numpy(), what=name)


# ---------------------------------------------------------------------- K7 --

@pytest.mark.parametrize("N,D,bf16", [
    (130, 16, True),    # JAX's one-shot backward at pack 1; bf16 q/k/v/dO
    (600, 8, False),    # JAX's q-blocked backward, the kernel K7 replaces
])
def test_large_window_backward_matches_pallas(N, D, bf16):
    """The plain K7, given the plain K1L's out and lse, against the Pallas
    backward, which recomputes the row statistics from q, k and the bias."""
    rng = np.random.default_rng(N)
    q, k, v, do = (rng.standard_normal((1, 2, N, D)).astype(np.float32)
                   for _ in range(4))
    bias = (rng.standard_normal((1, 2, N, N)) * 0.5).astype(np.float32)
    scale = D ** -0.5
    if bf16:
        qkvd = [_t(x).bfloat16() for x in (q, k, v, do)]
        jax_in = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in qkvd]
        atol, rtol = BF16_ATOL, BF16_RTOL
    else:
        qkvd = [_t(x) for x in (q, k, v, do)]
        jax_in = [jnp.asarray(x) for x in (q, k, v, do)]
        atol, rtol = ATOL, RTOL
    jq, jk, jv, jdo = jax_in
    ref = _fused_backward(jq, jk, jv, jnp.asarray(bias), jdo, scale=scale,
                          interpret=True)
    pq, pk, pv, pdo = qkvd
    out, lse = fused_attn._window_large_fwd(pq, pk, pv, _t(bias), scale)
    before = dict(fused_attn.LAUNCHES)
    got = fused_attn.fused_window_attention_large_bwd(pq, pk, pv, _t(bias), out,
                                                      lse, pdo, scale)
    assert fused_attn.LAUNCHES == before  # CPU: plain version
    assert got[0].dtype == pq.dtype and got[3].dtype == torch.float32
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, ref):
        _close(a, np.asarray(b, np.float32), atol, rtol, what=name)


# ---------------------------------------------------------------------- K5 --

def _flash_inputs(seed, BH, grid_hw, D):
    rng = np.random.default_rng(seed)
    N = grid_hw[0] * grid_hw[1]
    q, k, v, do = (rng.standard_normal((BH, N, D)).astype(np.float32)
                   for _ in range(4))
    rel_h = (rng.standard_normal((BH, N, grid_hw[0])) * 0.5).astype(np.float32)
    rel_w = (rng.standard_normal((BH, N, grid_hw[1])) * 0.5).astype(np.float32)
    return q, k, v, rel_h, rel_w, do


@pytest.mark.parametrize("grid_hw,D,bf16", [
    ((8, 8), 16, False),
    ((5, 7), 8, False),    # unaligned: 35 keys, a partial q block
    ((6, 6), 16, True),    # bf16 q/k/v/dO: bf16 dq/dk/dv, fp32 drel
])
def test_flash_attention_backward_matches_pallas(grid_hw, D, bf16):
    """The plain K5, given the plain K2's out and lse, against the Pallas
    backward and against autograd through the plain forward (both recompute
    the row statistics from q, k and the bias)."""
    q, k, v, rel_h, rel_w, do = _flash_inputs(sum(grid_hw), 3, grid_hw, D)
    scale = 0.3
    if bf16:
        qkvd = [_t(x).bfloat16() for x in (q, k, v, do)]
        jq, jk, jv, jdo = (jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in qkvd)
        atol, rtol = BF16_ATOL, BF16_RTOL
    else:
        qkvd = [_t(x) for x in (q, k, v, do)]
        jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
        atol, rtol = ATOL, RTOL
    ref = _flash_backward(jq, jk, jv, jnp.asarray(rel_h), jnp.asarray(rel_w),
                          jdo, grid_hw=grid_hw, scale=scale, interpret=True)
    pq, pk, pv, pdo = qkvd
    out, lse = fused_attn._flash_fwd(pq, pk, pv, _t(rel_h), _t(rel_w), grid_hw,
                                     scale)
    before = dict(fused_attn.LAUNCHES)
    got = fused_attn.flash_full_attention_bwd(pq, pk, pv, _t(rel_h), _t(rel_w),
                                              out, lse, pdo, grid_hw, scale)
    assert fused_attn.LAUNCHES == before  # CPU: plain version
    assert got[0].dtype == pq.dtype and got[3].dtype == torch.float32
    names = ("dq", "dk", "dv", "drel_h", "drel_w")
    for name, a, b in zip(names, got, ref):
        _close(a, np.asarray(b, np.float32), atol, rtol, what=name)
    auto = _autograd(
        lambda *x: fused_attn.flash_full_attention_ref(*x, grid_hw, scale)[0],
        [pq, pk, pv, _t(rel_h), _t(rel_w)], pdo)
    for name, a, b in zip(names, got, auto):
        _close(a, b.float().numpy(), atol, rtol, what=name)


def _stub_flash_launches(monkeypatch, launched):
    """Force the kernel route on CPU tensors, with K2's and K5's launches
    replaced by their plain versions, recording the head dim each got."""
    def fwd(q, *rest):
        launched.append(("fwd", q.shape[-1]))
        return fused_attn.flash_full_attention_ref(q, *rest)

    def bwd(q, *rest):
        launched.append(("bwd", q.shape[-1]))
        return fused_attn.flash_full_attention_bwd_ref(q, *rest)

    monkeypatch.setattr(_build, "use_kernel", lambda *t: True)
    monkeypatch.setattr(fused_attn, "_launch_flash_fwd", fwd)
    monkeypatch.setattr(fused_attn, "_launch_flash_bwd", bwd)


@pytest.mark.parametrize("D,Dp", [(40, 48), (16, 16), (8, 16), (128, 128)])
def test_flash_head_dim_padding(monkeypatch, D, Dp):
    """On the kernel route K2 and K5 run at the head dim rounded up to a
    multiple of 16, on zero-padded q, k, v, out and dout, and give what the
    unpadded plain versions give, cut back to D."""
    assert fused_attn.flash_head_dim(D) == Dp
    grid_hw = (4, 5)
    q, k, v, rel_h, rel_w, do = (_t(x) for x in _flash_inputs(D, 2, grid_hw, D))
    out, lse = fused_attn.flash_full_attention_ref(q, k, v, rel_h, rel_w, grid_hw, 0.3)
    want = fused_attn.flash_full_attention_bwd_ref(q, k, v, rel_h, rel_w, out, lse,
                                                   do, grid_hw, 0.3)
    launched = []
    _stub_flash_launches(monkeypatch, launched)
    got_out, got_lse = fused_attn._flash_fwd(q, k, v, rel_h, rel_w, grid_hw, 0.3)
    got = fused_attn.flash_full_attention_bwd(q, k, v, rel_h, rel_w, got_out,
                                              got_lse, do, grid_hw, 0.3)
    assert launched == [("fwd", Dp), ("bwd", Dp)]
    _close(got_out, out.numpy(), what="out")
    _close(got_lse, lse.numpy(), what="lse")
    for name, a, b in zip(("dq", "dk", "dv", "drel_h", "drel_w"), got, want):
        assert a.shape == b.shape and a.is_contiguous(), name
        _close(a, b.numpy(), what=name)


def test_flash_rejects_head_dims_over_128_and_unaligned_storage(monkeypatch):
    """On the kernel route a head dim over 128 raises (no padding reaches
    the kernels' template range), and so does storage that the 16-byte
    asynchronous copies cannot read, before any launch."""
    launched = []
    _stub_flash_launches(monkeypatch, launched)
    monkeypatch.setattr(_build, "launch", lambda *a: launched.append(a))
    with pytest.raises(ValueError, match="head dims up to 128"):
        fused_attn.flash_head_dim(136)
    grid_hw = (3, 4)
    q, k, v, rel_h, rel_w, do = (_t(x) for x in _flash_inputs(1, 2, grid_hw, 136))
    with pytest.raises(ValueError, match="head dims up to 128"):
        fused_attn._flash_fwd(q, k, v, rel_h, rel_w, grid_hw, 0.3)
    lse = torch.zeros(2, 12)
    with pytest.raises(ValueError, match="head dims up to 128"):
        fused_attn.flash_full_attention_bwd(q, k, v, rel_h, rel_w, q, lse, do,
                                            grid_hw, 0.3)
    monkeypatch.undo()  # the real launchers, which check alignment first
    monkeypatch.setattr(_build, "use_kernel", lambda *t: True)
    monkeypatch.setattr(fused_attn, "LAUNCHES", dict.fromkeys(fused_attn.LAUNCHES, 0))
    monkeypatch.setattr(_build, "launch", lambda *a: launched.append(a))
    buf = torch.zeros(2 * 12 * 16 + 1, dtype=torch.bfloat16)
    shifted = buf[1:].view(2, 12, 16)  # contiguous, 2 bytes off alignment
    aligned = torch.zeros(2, 12, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_attn._flash_fwd(shifted, aligned, aligned, rel_h, rel_w, grid_hw, 0.3)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_attn.flash_full_attention_bwd(aligned, aligned, aligned, rel_h, rel_w,
                                            aligned, lse, shifted, grid_hw, 0.3)
    assert launched == []
    fused_attn._flash_fwd(aligned, aligned, aligned, rel_h, rel_w, grid_hw, 0.3)
    assert [a[0] for a in launched] == ["mtp_flash_attn_fwd"]
    assert fused_attn.LAUNCHES["flash"] == 1


# ---------------------------------------------------------------------- K6 --

def _sample_inputs(seed, BG, H, W, C, HWo, P, unit_mask):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((BG, H * W, C)).astype(np.float32)
    # coordinates run off the map on every side; a quarter are exact integers
    py = rng.uniform(-2.5, H + 1.5, (BG, HWo, P)).astype(np.float32)
    px = rng.uniform(-2.5, W + 1.5, (BG, HWo, P)).astype(np.float32)
    py[:, ::4] = np.round(py[:, ::4])
    px[:, ::4] = np.round(px[:, ::4])
    m = (np.ones((BG, HWo, P), np.float32) if unit_mask
         else rng.uniform(-1, 1, (BG, HWo, P)).astype(np.float32))
    g = rng.standard_normal((BG, HWo, C)).astype(np.float32)
    return img, py, px, m, g


@pytest.mark.parametrize("BG,H,W,C,HWo,P,unit", [
    (2, 7, 7, 16, 49, 1, True),    # RVSA K/V sampling: P=1, unit mask
    (3, 9, 11, 8, 40, 9, False),   # DCNv3-style: P=9, signed mask
])
def test_bilinear_sample_backward_matches_pallas(BG, H, W, C, HWo, P, unit):
    img, py, px, m, g = _sample_inputs(BG + P, BG, H, W, C, HWo, P, unit)
    _, vjp = jax.vjp(lambda *a: jax_dcnv3_sample(*a, H, W, True),
                     *map(jnp.asarray, (img, py, px, m)))
    ref = vjp(jnp.asarray(g))
    got = dcn.dcnv3_sample_bwd(_t(img), _t(py), _t(px), _t(m), _t(g), H, W)
    names = ("dimg", "dpy", "dpx", "dm")
    for name, a, b in zip(names, got, ref):
        _close(a, b, atol=1e-4, rtol=1e-4, what=name)  # sums of up to 4·P·C
    auto = _autograd(lambda *x: dcn.dcnv3_sample_ref(*x, H, W),
                     [_t(img), _t(py), _t(px), _t(m)], _t(g))
    for name, a, b in zip(names, got, auto):
        _close(a, b.numpy(), atol=1e-4, rtol=1e-4, what=name)


def test_sample_backward_at_the_map_edge():
    """A tap exactly at y = -1 or x = -1 has zero weight but, by the floor
    rule, a coordinate gradient from its in-map corner; taps further out
    have neither."""
    H = W = 4
    img = torch.arange(16, dtype=torch.float32).reshape(1, 16, 1)
    py = torch.tensor([[[-1.0], [-1.5], [1.0]]])
    px = torch.tensor([[[2.0], [2.0], [-1.0]]])
    m = torch.ones_like(py)
    g = torch.ones(1, 3, 1)
    _, dpy, dpx, _ = dcn.dcnv3_sample_bwd(img, py, px, m, g, H, W)
    # y = -1: d/dy = img[0, 2] - 0; x = -1 at y = 1: d/dx = img[1, 0] - 0
    assert dpy[0, :, 0].tolist() == [2.0, 0.0, 0.0]
    assert dpx[0, :, 0].tolist() == [0.0, 0.0, 4.0]


# ----------------------------------------------------- grid_sample, rel_pos --

@pytest.mark.parametrize("align_corners,padding_mode", [
    (True, "zeros"), (False, "zeros"), (True, "border")])
def test_grid_sample_gradients_match_jax(align_corners, padding_mode):
    """Gradients to the image and to the grid (through the pixel-coordinate
    affine, then K6's coordinate VJP for zeros padding)."""
    rng = np.random.default_rng(7)
    img = rng.standard_normal((2, 6, 9, 5)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 4, 7, 2)).astype(np.float32)
    g = rng.standard_normal((2, 4, 7, 5)).astype(np.float32)
    kw = dict(align_corners=align_corners, padding_mode=padding_mode)
    _, vjp = jax.vjp(lambda a, b: jax_grid_sample(a, b, **kw),
                     jnp.asarray(img), jnp.asarray(grid))
    ref = vjp(jnp.asarray(g))
    got = _autograd(lambda a, b: grid_sample(a, b, **kw), [_t(img), _t(grid)], _t(g))
    for name, a, b in zip(("dimg", "dgrid"), got, ref):
        _close(a, b, atol=1e-4, rtol=1e-4, what=name)


def test_rel_pos_gradients_match_jax():
    """The decomposed bias (through q and both tables) and the Swin bias
    (through its table) by autograd, against jax.vjp."""
    rng = np.random.default_rng(8)
    ws, C, nH = 7, 8, 3
    q = rng.standard_normal((2, nH, ws * ws, C)).astype(np.float32)
    rh, rw = (rng.standard_normal((2 * ws - 1, C)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((2, nH, ws * ws, ws * ws)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jrp.decomposed_rel_pos_bias(
        a, (ws, ws), (ws, ws), b, c), *map(jnp.asarray, (q, rh, rw)))
    ref = vjp(jnp.asarray(g))
    got = _autograd(lambda a, b, c: prp.decomposed_rel_pos_bias(
        a, (ws, ws), (ws, ws), b, c), [_t(q), _t(rh), _t(rw)], _t(g))
    for name, a, b in zip(("dq", "drel_h", "drel_w"), got, ref):
        _close(a, b, atol=1e-4, rtol=1e-5, what=name)

    table = rng.standard_normal(((2 * ws - 1) ** 2, nH)).astype(np.float32)
    idx = prp.swin_rel_pos_index(ws, ws)
    gs = rng.standard_normal((nH, ws * ws, ws * ws)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jrp.swin_rel_pos_bias(t, idx), jnp.asarray(table))
    (got,) = _autograd(lambda t: prp.swin_rel_pos_bias(t, idx), [_t(table)], _t(gs))
    _close(got, vjp(jnp.asarray(gs))[0], atol=1e-4, rtol=1e-5, what="dtable")


# --------------------------------------------------- autograd.Function wiring --

def test_autograd_functions_route_to_the_backward_wrappers(monkeypatch):
    """Each differentiable function's backward calls its backward wrapper
    with a contiguous cotangent in the primal's dtype."""
    seen = []

    def spy(name, fn):
        def wrapped(*args):
            seen.append((name, [a.is_contiguous() for a in args
                                if isinstance(a, torch.Tensor)]))
            return fn(*args)
        return wrapped

    monkeypatch.setattr(fused_attn, "fused_window_attention_bwd",
                        spy("window", fused_attn.fused_window_attention_bwd))
    monkeypatch.setattr(fused_attn, "flash_full_attention_bwd",
                        spy("flash", fused_attn.flash_full_attention_bwd))
    monkeypatch.setattr(dcn, "dcnv3_sample_bwd", spy("sample", dcn.dcnv3_sample_bwd))
    q = torch.randn(2, 2, 9, 4, requires_grad=True)
    bias = torch.zeros(2, 2, 9, 9, requires_grad=True)
    out = fused_attn.fused_window_attention(q, q, q, bias, 0.5)
    out.transpose(2, 3).sum().backward()  # a strided cotangent
    qf = torch.randn(2, 12, 4, requires_grad=True)
    rel_h = torch.zeros(2, 12, 3, requires_grad=True)
    rel_w = torch.zeros(2, 12, 4, requires_grad=True)
    fused_attn.flash_full_attention(qf, qf, qf, rel_h, rel_w, (3, 4), 1.0).sum().backward()
    img = torch.randn(1, 12, 2, requires_grad=True)
    c = torch.rand(1, 5, 1, requires_grad=True)
    dcn.dcnv3_sample(img, c, c, torch.ones(1, 5, 1), 3, 4).sum().backward()
    assert [name for name, _ in seen] == ["window", "flash", "sample"]
    assert all(all(flags) for _, flags in seen)
    assert q.grad is not None and bias.grad is not None and c.grad is not None
