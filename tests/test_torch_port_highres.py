"""The ViT's high-resolution path against the JAX package's: full attention
over token grids wider than 128 per axis, which both packages run as the
window-attention function over one window of all H·W tokens with a
materialised fp32 bias (the port's K1L forward and K7 backward on the card);
the routing of window attention by shape; the ViT with remat; and a train
step at a 2080×112 strip (grid 130×7, N = 910 — what the card's 2080² crops
run at N = 16,900).

The JAX side runs its Pallas kernels as `pallas_call(interpret=True)`, the
package's own `MTP_PALLAS_INTERPRET` switch: the callbacks of
`force_tpu_interpret_mode` cannot be differentiated under `nn.remat`.  The
port runs its plain versions on the CPU and, where launches are counted,
stubbed kernel launches.  Inputs are made with numpy from a seed; fp32 on
both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.ckpt.torch_convert import convert_backbone, to_scan_layout
from mtp_tpu.core import optim as jopt
from mtp_tpu.core.train import create_state as jax_create_state
from mtp_tpu.core.train import make_train_step as jax_make_train_step
from mtp_tpu.core.train import seg_xent as jax_seg_xent
from mtp_tpu.heads.upernet import resize_bilinear as jax_resize
from mtp_tpu.models import vit_rvsa as jv
from mtp_tpu.models.backbones import layer_id_fn_for as jax_layer_id_fn_for
from mtp_tpu.models.segmentor import Segmentor as JaxSegmentor
from mtp_tpu.ops import pallas_attn
from mtp_tpu.utils.config import (BackboneConfig, OptimizerConfig,
                                  ScheduleConfig, TaskConfig, TrainConfig)
from mtp_tpu_torch.ckpt.from_jax import (attention_from_jax, backbone_from_jax,
                                         opt_state_from_jax, segmentor_from_jax)
from mtp_tpu_torch.core import optim as popt
from mtp_tpu_torch.kernels import _build
from mtp_tpu_torch.models import vit_rvsa as pv
from mtp_tpu_torch.models.segmentor import Segmentor
from mtp_tpu_torch.ops import dcnv3_sample as dcn
from mtp_tpu_torch.ops import fused_attn
from mtp_tpu_torch.tasks.segmentation import SegmentationTask

torch.set_num_threads(1)

# fp32 on both sides; only the summation order differs
ATOL, RTOL = 1e-5, 1e-5
MOD_ATOL, MOD_RTOL = 1e-4, 1e-4  # whole modules, as the backbone tests
HW = (2080, 112)  # a strip of the 2080² crops: grid 130×7, N = 910
CFG = BackboneConfig(img_size=2080, embed_dim=32, depth=2, num_heads=2,
                     interval=2, out_indices=(0, 1, 1, 1), dtype="float32",
                     remat=True, drop_path_rate=0.0)
K, CHANNELS = 3, 16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref, atol=ATOL, rtol=RTOL, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


@pytest.fixture
def jax_interpret(monkeypatch):
    """The JAX package's Pallas kernels as pallas_call(interpret=True); jit
    caches are cleared so that no trace made without the switch is reused."""
    monkeypatch.setenv("MTP_PALLAS_INTERPRET", "1")
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture
def stubbed_launches(monkeypatch):
    """The kernel route forced on CPU tensors, each launch recorded instead
    of run (its outputs stay uninitialised), every launch's inputs checked
    for the contiguity the kernels require; the counters start at 0."""
    requested = []
    monkeypatch.setattr(_build, "use_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "launch", lambda name, *a: requested.append(name))
    monkeypatch.setattr(fused_attn, "LAUNCHES", dict.fromkeys(fused_attn.LAUNCHES, 0))
    monkeypatch.setattr(dcn, "LAUNCHES", dict.fromkeys(dcn.LAUNCHES, 0))
    return requested


def _window_inputs(seed, W, nH, N, D):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((W, nH, N, D)).astype(np.float32)
                   for _ in range(4))
    bias = (rng.standard_normal((W, nH, N, N)) * 0.5).astype(np.float32)
    return q, k, v, bias, do


# ------------------------------------------------------------- (a) K1L, K7 --

@pytest.mark.parametrize("N", [387, 910])
def test_large_window_attention_matches_pallas(monkeypatch, N):
    """Forward and backward of one large window (129×3 and 130×7 grids)
    against `_fused_forward` and `_fused_backward(interpret=True)`: the plain
    K1L's out, and its lse against the log-sum-exp of the scores in float64;
    the plain K7 from that out and lse.  JAX takes its q-blocked backward
    (the kernel K7 replaces) at N = 910 and its one-shot backward at
    N = 387; both recompute the row statistics."""
    W, nH, D = 1, 2, 16
    q, k, v, bias, do = _window_inputs(N, W, nH, N, D)
    scale = D ** -0.5
    qblocked = []
    real = pallas_attn._win_backward_qblocked
    monkeypatch.setattr(pallas_attn, "_win_backward_qblocked",
                        lambda *a: qblocked.append(a[0].shape) or real(*a))
    jq, jk, jv_, jb, jdo = map(jnp.asarray, (q, k, v, bias, do))
    ref = pallas_attn._fused_forward(jq, jk, jv_, jb, scale=scale, interpret=True)
    # unjitted, so that the branch is taken in Python where the spy sees it
    ref_b = pallas_attn._fused_backward.__wrapped__(jq, jk, jv_, jb, jdo, scale,
                                                    True)
    assert qblocked == ([(W, nH, N, D)] if N > 512 else [])
    assert fused_attn.window_bwd_route(N, D) == "window_bwd_qblk"
    assert fused_attn.window_fwd_route(N, D) == "window_large"
    scores = np.einsum("whqd,whkd->whqk", q.astype(np.float64),
                       k.astype(np.float64)) * scale + bias
    want_lse = torch.logsumexp(torch.from_numpy(scores), dim=-1)

    before = dict(fused_attn.LAUNCHES)
    out, lse = fused_attn._window_large_fwd(_t(q), _t(k), _t(v), _t(bias), scale)
    got_b = fused_attn.fused_window_attention_large_bwd(
        _t(q), _t(k), _t(v), _t(bias), out, lse, _t(do), scale)
    assert fused_attn.LAUNCHES == before  # CPU: plain versions
    assert lse.shape == (W, nH, N) and lse.dtype == torch.float32
    _close(out, ref, what="out")
    _close(lse, want_lse.numpy(), what="lse")
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got_b, ref_b):
        _close(a, b, what=name)


@pytest.mark.parametrize("N,D,bf16", [(387, 16, False), (910, 8, False),
                                      (130, 16, True)])
def test_large_window_backward_matches_autograd(N, D, bf16):
    """The plain K7, given the plain K1L's out and lse, against torch
    autograd through the plain forward `fused_window_attention_ref`, which
    recomputes the statistics; bf16 q/k/v/dO give bf16 dq/dk/dv and an
    fp32 dbias, held to one bf16 rounding."""
    q, k, v, bias, do = (_t(x) for x in _window_inputs(N + D, 1, 2, N, D))
    if bf16:
        q, k, v, do = (x.bfloat16() for x in (q, k, v, do))
    atol, rtol = (2e-2, 1e-2) if bf16 else (ATOL, RTOL)
    scale = D ** -0.5
    out, lse = fused_attn.fused_window_attention_large_ref(q, k, v, bias, scale)
    got = fused_attn.fused_window_attention_large_bwd(q, k, v, bias, out, lse, do,
                                                      scale)
    leaves = [x.detach().requires_grad_() for x in (q, k, v, bias)]
    auto = torch.autograd.grad(
        fused_attn.fused_window_attention_ref(*leaves, scale), leaves, do)
    assert [a.dtype for a in got] == [q.dtype] * 3 + [torch.float32]
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, auto):
        _close(a, b.float().numpy(), atol, rtol, what=name)


# ------------------------------------------------------------- (b) routing --

@pytest.mark.parametrize("N,D,fwd,bwd", [
    (49, 64, "window", "window_bwd"),               # RVSA's 7×7 windows
    (130, 64, "window_large", "window_bwd_qblk"),   # K1 fits, K4 does not: the pair
    (387, 64, "window_large", "window_bwd_qblk"),   # 129×3: JAX one-shot, K4 too big
    (910, 64, "window_large", "window_bwd_qblk"),   # 130×7: JAX's K7
    (387, 16, "window_large", "window_bwd_qblk"),
])
def test_window_attention_routes_by_shape(stubbed_launches, N, D, fwd, bwd):
    """With the kernel route forced and launches stubbed: one forward and
    its backward request exactly the routed kernels, with contiguous
    inputs, and raise nowhere (before this port, N = 387 raised in both
    directions)."""
    launcher = {"window": "mtp_window_attn_fwd",
                "window_large": "mtp_window_attn_fwd_large",
                "window_bwd": "mtp_window_attn_bwd",
                "window_bwd_qblk": "mtp_window_attn_bwd_qblk"}
    q = torch.zeros(1, 2, N, D, requires_grad=True)
    bias = torch.zeros(1, 2, N, N, requires_grad=True)
    out = fused_attn.fused_window_attention(q, q, q, bias, 0.5)
    out.backward(torch.ones_like(out))
    assert stubbed_launches == [launcher[fwd], launcher[bwd]]
    assert {k: n for k, n in fused_attn.LAUNCHES.items() if n} == {fwd: 1, bwd: 1}


def test_routing_follows_the_jax_rule_and_shared_memory():
    """Backward: K7 at every N where JAX's `_fused_backward` takes its
    q-blocked kernel (pack 1 and round_up(N, 8) > 512), K4 only where JAX
    takes its one-shot kernel and K4's block fits shared memory.  Forward,
    paired with it: K1L exactly where the backward is K7, so K1 only where
    its block fits and K4 is the backward (at D = 64 that moves N = 118…162
    from K1 to K1L).  The main path's N = 16,900 routes without raising;
    head dims over 128 beyond K1's reach raise."""
    for D in (64, 16):
        for N in range(1, 1100):
            jax_qblocked = N > 64 and pallas_attn._round_up(N, 8) > \
                pallas_attn._WIN_BWD_ONE_SHOT_MAX
            k4_fits = fused_attn.window_bwd_smem_bytes(N, D) <= fused_attn.SMEM_LIMIT
            want = "window_bwd" if k4_fits and not jax_qblocked else "window_bwd_qblk"
            assert fused_attn.window_bwd_route(N, D) == want, (N, D)
            k1_fits = fused_attn.window_smem_bytes(N, D) <= fused_attn.SMEM_LIMIT
            assert fused_attn.window_fwd_route(N, D) == (
                "window" if k1_fits and want == "window_bwd" else "window_large"), (N, D)
    assert fused_attn.window_bwd_route(117, 64) == "window_bwd"
    assert fused_attn.window_bwd_route(118, 64) == "window_bwd_qblk"
    assert fused_attn.window_fwd_route(117, 64) == "window"
    assert fused_attn.window_fwd_route(118, 64) == "window_large"
    assert fused_attn.window_smem_bytes(162, 64) <= fused_attn.SMEM_LIMIT
    assert fused_attn.window_fwd_route(16900, 64) == "window_large"
    assert fused_attn.window_bwd_route(16900, 64) == "window_bwd_qblk"
    with pytest.raises(ValueError, match="head dims"):
        fused_attn.window_fwd_route(16900, 256)
    with pytest.raises(ValueError, match="head dims"):
        fused_attn.window_bwd_route(910, 256)


def test_k7_takes_the_out_and_lse_k1l_wrote(monkeypatch):
    """With the kernel route forced and launches stubbed: the K7 launch of a
    large window's backward gets the very out and lse storage that the K1L
    launch of the same forward wrote (and q, k, v, bias as the forward
    had them); a K1/K4 window saves neither."""
    launches = []
    monkeypatch.setattr(_build, "use_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "launch", lambda name, *a: launches.append((name, a)))
    monkeypatch.setattr(fused_attn, "LAUNCHES", dict.fromkeys(fused_attn.LAUNCHES, 0))
    q = torch.zeros(1, 2, 387, 16, requires_grad=True)
    bias = torch.zeros(1, 2, 387, 387, requires_grad=True)
    out = fused_attn.fused_window_attention(q, q, q, bias, 0.5)
    out.backward(torch.ones_like(out))
    (fwd, fa), (bwd, ba) = launches
    assert (fwd, bwd) == ("mtp_window_attn_fwd_large", "mtp_window_attn_bwd_qblk")
    # K1L: q, k, v, bias, out, lse, ...; K7: q, k, v, bias, out, lse, dout, ...
    assert fa[4] == out.data_ptr() and ba[:6] == fa[:6]
    assert fa[-5:] == ba[-5:] == (2, 387, 16, 0.5, 0)  # W·nH, N, D, scale, fp32
    launches.clear()
    small = torch.zeros(1, 2, 49, 16, requires_grad=True)
    out = fused_attn.fused_window_attention(small, small, small,
                                            torch.zeros(1, 2, 49, 49), 0.5)
    assert len(out.grad_fn.saved_tensors) == 4  # q, k, v, bias
    assert [name for name, _ in launches] == ["mtp_window_attn_fwd"]


@pytest.mark.parametrize("D,Dp", [(40, 48), (64, 64), (8, 16)])
def test_large_window_head_dim_padding(stubbed_launches, monkeypatch, D, Dp):
    """On the kernel route K1L and K7 run at the head dim rounded up to a
    multiple of 16 (zero-padded q, k, v, out and dout) and hand back outputs
    cut to D, contiguous; over 128 they raise before any launch."""
    dims = []
    monkeypatch.setattr(_build, "launch",
                        lambda name, *a: dims.append((name, a[-3])))
    q = torch.zeros(1, 2, 200, D, requires_grad=True)
    bias = torch.zeros(1, 2, 200, 200, requires_grad=True)
    out = fused_attn.fused_window_attention(q, q, q, bias, 0.5)
    out.backward(torch.ones_like(out))
    assert dims == [("mtp_window_attn_fwd_large", Dp), ("mtp_window_attn_bwd_qblk", Dp)]
    assert out.shape == q.shape and out.is_contiguous()
    assert q.grad.shape == q.shape and bias.grad.shape == bias.shape
    wide = torch.zeros(1, 2, 200, 136)
    with pytest.raises(ValueError, match="head dims"):
        fused_attn._window_large_fwd(wide, wide, wide, bias.detach(), 0.5)
    with pytest.raises(ValueError, match="head dims"):
        fused_attn.fused_window_attention_large_bwd(
            wide, wide, wide, bias.detach(), wide, torch.zeros(1, 2, 200), wide, 0.5)
    assert len(dims) == 2


def test_full_attention_fallback_at_129x3(stubbed_launches):
    """`FullAttention` keeps JAX's gate, max(H, W) <= 128 → K2, else the
    window function: a 129×3 grid (N = 387) runs K1L and K7 and never K2,
    under bf16 autocast too, where q/k/v are bf16 and the bias stays fp32
    (the wrappers raise on any other bias dtype)."""
    mod = pv.FullAttention(32, 2, (129, 3))
    out = mod(torch.zeros(1, 129, 3, 32))
    out.sum().backward()
    assert stubbed_launches == ["mtp_window_attn_fwd_large",
                                "mtp_window_attn_bwd_qblk"]
    stubbed_launches.clear()
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = mod(torch.zeros(1, 129, 3, 32))
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert stubbed_launches == ["mtp_window_attn_fwd_large",
                                "mtp_window_attn_bwd_qblk"]
    stubbed_launches.clear()
    pv.FullAttention(32, 2, (128, 3))(torch.zeros(1, 128, 3, 32))
    assert stubbed_launches == ["mtp_flash_attn_fwd"]


@pytest.mark.parametrize("hw", [(129, 3), (130, 7)])
def test_full_attention_fallback_matches_jax(jax_interpret, hw):
    """The port's `FullAttention` (plain versions) against the JAX module
    with `pallas=True` on grids just over the gate, output and gradients."""
    C, nH = 32, 2
    rng = np.random.default_rng(hw[0] * hw[1])
    x = rng.standard_normal((1,) + hw + (C,)).astype(np.float32)
    cot = rng.standard_normal((1,) + hw + (C,)).astype(np.float32)
    mod = jv.FullAttention(C, nH, hw, pallas=True)
    params = jax.jit(mod.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = dict(params, **{n: jnp.asarray(rng.standard_normal(
        params[n].shape).astype(np.float32) * 0.3) for n in ("rel_pos_h", "rel_pos_w")})
    ref, vjp = jax.vjp(lambda p, a: mod.apply({"params": p}, a), params,
                       jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(cot))
    port = pv.FullAttention(C, nH, hw)
    port.load_state_dict(attention_from_jax(params, full=True))
    xt = _t(x).requires_grad_()
    out = port(xt)
    out.backward(_t(cot))
    _close(out, ref, MOD_ATOL, MOD_RTOL, "out")
    _close(xt.grad, gx, MOD_ATOL, MOD_RTOL, "dx")
    grads = attention_from_jax(gp, full=True)
    for name, p in port.named_parameters():
        _close(p.grad, grads[name].numpy(), MOD_ATOL, MOD_RTOL, name)


# --------------------------------------------------------- ViT with remat --

def _jitter(tree, rng):
    """Randomise the zero-init rel-pos tables and widen the regressors, so
    that the rel-pos biases and far, rotated sampling are exercised."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k in ("rel_pos_h", "rel_pos_w"):
            out[k] = jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.3)
        elif k.startswith("sampling_"):
            out[k] = {"kernel": v["kernel"] * 30.0,
                      "bias": jnp.asarray(rng.standard_normal(v["bias"].shape)
                                          .astype(np.float32) * 0.3)}
        else:
            out[k] = _jitter(v, rng)
    return out


def _vit_params(cfg, seed):
    init = jax.jit(lambda k: jv.ViTRVSA(cfg).init(k, jnp.zeros((1,) + HW + (3,))))
    params = jv.rescale_block_init(init(jax.random.PRNGKey(seed))["params"],
                                   cfg.depth)
    return _jitter(params, np.random.default_rng(seed))


def test_vit_with_remat_matches_jax(jax_interpret):
    """(c) The toy ViT+RVSA at the 2080×112 strip, remat on both sides
    (`nn.remat` / `torch.utils.checkpoint`), JAX with `pallas_attn=True`:
    all four pyramid levels and every gradient of a random projection of
    them."""
    cfg = dataclasses.replace(CFG, pallas_attn=True)
    params = _vit_params(cfg, 3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1,) + HW + (3,)).astype(np.float32)
    mod = jv.ViTRVSA(cfg)
    apply = lambda p: mod.apply({"params": p}, jnp.asarray(x))
    cots = tuple(rng.standard_normal(o.shape).astype(np.float32)
                 for o in jax.eval_shape(apply, params))

    def outputs_and_grads(p):
        outs, vjp = jax.vjp(apply, p)
        return outs, vjp(tuple(map(jnp.asarray, cots)))[0]

    refs, jgrads = jax.jit(outputs_and_grads)(params)
    jgrads = backbone_from_jax(jgrads, cfg)

    port = pv.ViTRVSA(cfg, HW)
    port.load_state_dict(backbone_from_jax(params, cfg))
    outs = port(_t(x))
    for got, ref in zip(outs, refs):
        _close(got, ref, MOD_ATOL, MOD_RTOL)
    sum((o * _t(c)).sum() for o, c in zip(outs, cots)).backward()
    g_all = float(torch.sqrt(sum((g ** 2).sum() for g in jgrads.values())))
    for name, p in port.named_parameters():
        diff = float((p.grad - jgrads[name]).norm())
        assert diff <= 1e-4 * float(jgrads[name].norm()) + 1e-6 * g_all, name


def test_vit_remat_equals_no_remat_with_drop_path():
    """(d) With drop-path and dropout on, the same generator seed gives
    bitwise the same outputs and gradients with and without remat: the
    masks are drawn before each checkpointed block."""
    cfg = dataclasses.replace(CFG, drop_path_rate=0.3, drop_rate=0.1)
    x = torch.randn((2,) + HW + (3,), generator=torch.Generator().manual_seed(5))
    results = []
    for remat in (False, True):
        torch.manual_seed(0)
        model = pv.ViTRVSA(dataclasses.replace(cfg, remat=remat), HW)
        outs = model(x, deterministic=False,
                     generator=torch.Generator().manual_seed(6))
        loss = sum((o * (i + 1)).sum() for i, o in enumerate(outs))
        loss.backward()
        results.append((outs, {n: p.grad for n, p in model.named_parameters()}))
    (outs0, g0), (outs1, g1) = results
    assert all(torch.equal(a, b) for a, b in zip(outs0, outs1))
    assert g0.keys() == g1.keys()
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    # the masks did act: the deterministic forward of the same weights differs
    torch.manual_seed(0)
    with torch.no_grad():
        plain = pv.ViTRVSA(cfg, HW)(x)
    assert not torch.allclose(plain[0], outs0[0])


def test_highres_tables_convert_in_both_layouts():
    """A 2080² model's parameters: `pos_embed` over the 130² grid and the
    full blocks' 259-row rel-pos tables, from the unrolled JAX layout and
    from the scanned one of `scan=True, remat=True`, load into the port and
    round-trip through the JAX package's own converter."""
    cfg = dataclasses.replace(CFG, depth=4, out_indices=(0, 1, 2, 3))
    shapes = jax.eval_shape(lambda: jv.ViTRVSA(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2080, 2080, 3))))["params"]
    rng = np.random.default_rng(7)
    params = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                          shapes)
    assert params["pos_embed"].shape == (1, 130, 130, 32)
    assert params["blocks_1"]["attn"]["rel_pos_h"].shape == (259, 16)
    scan_cfg = dataclasses.replace(cfg, scan=True)
    scanned = to_scan_layout(params, cfg.depth, cfg.interval)
    scan_shapes = jax.eval_shape(lambda: jv.ViTRVSA(scan_cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2080, 2080, 3))))["params"]
    assert jax.tree.map(np.shape, scanned) == jax.tree.map(lambda s: s.shape,
                                                           scan_shapes)
    unrolled_sd = backbone_from_jax(params, cfg)
    scanned_sd = backbone_from_jax(scanned, scan_cfg)
    assert unrolled_sd.keys() == scanned_sd.keys()
    for name in unrolled_sd:
        assert torch.equal(unrolled_sd[name], scanned_sd[name]), name
    port = pv.ViTRVSA(cfg, (2080, 2080))
    port.load_state_dict(unrolled_sd)
    assert port.pos_embed.shape == (1, 130 * 130, 32)
    assert port.blocks[1].attn.full_attn_rel_pos_w.shape == (259, 16)
    back = convert_backbone({k: v.numpy() for k, v in port.state_dict().items()},
                            cfg)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(np.asarray(flat[path]), leaf)


# ------------------------------------------------------ (e) train step --

OPT = OptimizerConfig(lr=1e-3, weight_decay=0.05, layer_decay=0.9, clip_norm=0.0)
SCHED = ScheduleConfig(kind="cosine", total_steps=10, warmup_steps=2,
                       warmup_ratio=0.1)


def _batch(seed):
    rng = np.random.default_rng(seed)
    image = rng.standard_normal((1,) + HW + (3,)).astype(np.float32)
    label = rng.integers(0, K, (1,) + HW).astype(np.int32)
    label[:, :5] = 255
    return {"image": image, "label": label}


def test_train_step_at_the_strip_matches_jax(jax_interpret):
    """(e) One `train_step_fn` step of a toy Segmentor (the ViT above →
    UperNet, remat, batch 1 of 2080×112: the PSP pool-1 BatchNorm sees one
    value per channel) against JAX `make_train_step` with `pallas_attn=True`:
    loss, grad norm, every gradient (as Adam's first moment after one step,
    (1 − β1)·g on both sides, through `opt_state_from_jax`), the BatchNorm
    running statistics and the updated parameters."""
    cfg = dataclasses.replace(CFG, pallas_attn=True)
    model = JaxSegmentor(cfg, K, channels=CHANNELS)
    variables = jax.jit(lambda k: model.init(k, jnp.zeros((1,) + HW + (3,)),
                                             train=False))(jax.random.PRNGKey(0))
    params = dict(variables["params"])
    params["backbone"] = _jitter(jv.rescale_block_init(params["backbone"],
                                                       cfg.depth),
                                 np.random.default_rng(8))
    stats = variables["batch_stats"]
    tx = jopt.make_optimizer(OPT, jopt.make_schedule(SCHED, OPT.lr), params,
                             cfg.depth, jax_layer_id_fn_for(cfg, root="backbone/"))

    def loss_fn(p, bs, batch, rng):
        out, upd = model.apply({"params": p, "batch_stats": bs}, batch["image"],
                               train=True, deterministic=True,
                               mutable=["batch_stats"])
        logits = jax_resize(out, batch["label"].shape[1:3])
        return jax_seg_xent(logits, batch["label"]), ({}, upd["batch_stats"])

    batch = _batch(9)
    state = jax_create_state(params, tx, jax.random.PRNGKey(1), batch_stats=stats)
    after, metrics = jax_make_train_step(loss_fn, tx, donate=False)(
        state, jax.tree.map(jnp.asarray, batch))

    task_cfg = TaskConfig(task="segmentation", num_classes=K, backbone=cfg,
                          train=TrainConfig(batch_size=1, optimizer=OPT,
                                            schedule=SCHED))
    task = SegmentationTask(task_cfg, model=Segmentor(cfg, K, channels=CHANNELS,
                                                      input_hw=HW), device="cpu")
    pstate = task.init_state(torch.Generator().manual_seed(0))
    pstate.model.load_state_dict(segmentor_from_jax(
        {"params": params, "batch_stats": stats}, cfg))
    pstate, pm = task.train_step_fn(deterministic=True)(
        pstate, {k: _t(v) for k, v in batch.items()})

    np.testing.assert_allclose(float(pm["loss"]), float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(metrics["grad_norm"]),
                               rtol=1e-5)
    named = dict(pstate.model.named_parameters())
    count, moments = opt_state_from_jax(after.opt_state, after.batch_stats, cfg)
    assert count == pstate.optimizer.count == 1
    # first moments: fp32 sums in other orders, with a floor for gradients
    # that are 0 in exact arithmetic (conv biases before train-mode BatchNorm)
    m_all = float(torch.sqrt(sum((m ** 2).sum() for m, _ in moments.values())))
    for name, p in named.items():
        got, want = pstate.optimizer.adamw.state[p]["exp_avg"], moments[name][0]
        diff = float((got - want).norm())
        assert diff <= 1e-4 * float(want.norm()) + 1e-6 * m_all, name
    want = segmentor_from_jax({"params": after.params,
                               "batch_stats": after.batch_stats}, cfg)
    got = pstate.model.state_dict()
    for name in want:
        if "running_" in name:
            _close(got[name], want[name].numpy(), 1e-5, 1e-5, name)
    # where |g| is at noise level Adam's first step is ±lr·scale either way
    lr = popt.make_schedule(SCHED, OPT.lr)(0)
    scales = {pstate.optimizer.names[p]: g["lr_scale"]
              for g in pstate.optimizer.adamw.param_groups for p in g["params"]}
    for name, p in named.items():
        _close(p, want[name].numpy(), 2 * lr * scales[name] + 1e-7, 0, name)


# ------------------------------------------------------- (f) launch counts --

def _strip_task(drop_path_rate):
    cfg = dataclasses.replace(CFG, drop_path_rate=drop_path_rate)
    task_cfg = TaskConfig(task="segmentation", num_classes=K, backbone=cfg,
                          train=TrainConfig(batch_size=1))
    return SegmentationTask(task_cfg, model=Segmentor(cfg, K, channels=CHANNELS,
                                                      input_hw=HW), device="cpu")


def test_kernel_launches_per_forward_and_train_step(stubbed_launches):
    """(f) At the strip, with the kernel route forced and launches stubbed:
    a crop forward runs K1 and K3 ×2 per RVSA block and K1L per full block;
    a train step with remat and drop-path runs each forward twice (forward
    and recompute) plus K4 and K6 ×2 per RVSA block and K7 per full block —
    the counts `chip_smoke.py` expects at 2080² of its first 6 blocks (K1
    10, K1L 2, K3 20, K4 5, K7 1, K6 10)."""
    n_full = CFG.depth // CFG.interval
    n_rvsa = CFG.depth - n_full
    task = _strip_task(0.3)
    state = task.init_state(torch.Generator().manual_seed(0))
    with torch.no_grad():
        state.model.predict(torch.zeros((1,) + HW + (3,)))
    assert {**fused_attn.LAUNCHES, **dcn.LAUNCHES} == {
        **dict.fromkeys(fused_attn.LAUNCHES, 0), **dict.fromkeys(dcn.LAUNCHES, 0),
        "window": n_rvsa, "window_large": n_full, "bilinear_sample": 2 * n_rvsa}
    for launched in (fused_attn.LAUNCHES, dcn.LAUNCHES):
        launched.update(dict.fromkeys(launched, 0))
    stubbed_launches.clear()
    batch = {"image": torch.zeros((1,) + HW + (3,)),
             "label": torch.zeros((1,) + HW, dtype=torch.long)}
    task.train_step_fn()(state, batch)
    want = {"window": 2 * n_rvsa, "window_large": 2 * n_full, "flash": 0,
            "bilinear_sample": 4 * n_rvsa, "window_bwd": n_rvsa,
            "window_bwd_qblk": n_full, "flash_bwd": 0,
            "bilinear_sample_bwd": 2 * n_rvsa}
    assert {**fused_attn.LAUNCHES, **dcn.LAUNCHES} == want
    assert len(stubbed_launches) == sum(want.values())
