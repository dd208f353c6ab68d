"""K1's and K4's two bodies (window attention, forward and backward): the
choice between the tensor-core body (bf16 windows of at most 64 tokens,
RVSA's 7×7) and the CUDA-core body, the head-dim padding of the
tensor-core body, and that zero padding is exact.

The bodies themselves run only on the card (`chip_smoke.py` phases 3 and
3b hold both against the plain versions there).  Here the wrappers run
with the kernel route forced and each launch stubbed, which shows what the
card would be asked to do; the plain versions, which the tests in
`test_torch_port_kernels.py` and `test_torch_port_backward.py` hold to the
JAX Pallas kernels, show that the padding changes nothing.  Inputs are made
with numpy from a seed.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.ops.pallas_attn import fused_window_attention as jax_window
from mtp_tpu_torch.kernels import _build
from mtp_tpu_torch.ops import fused_attn

torch.set_num_threads(1)

BF16, FP32 = torch.bfloat16, torch.float32


@pytest.fixture
def launches(monkeypatch):
    """The kernel route forced on CPU tensors, each launch recorded as
    (launcher, head dim it was given) instead of run (outputs stay
    uninitialised); the counters start at 0."""
    requested = []
    monkeypatch.setattr(_build, "use_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "launch",
                        lambda name, *a: requested.append((name, a[-3])))
    monkeypatch.setattr(fused_attn, "LAUNCHES", dict.fromkeys(fused_attn.LAUNCHES, 0))
    return requested


def _inputs(seed, W, nH, N, D):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((W, nH, N, D)).astype(np.float32)
                   for _ in range(4))
    bias = (rng.standard_normal((W, nH, N, N)) * 0.5).astype(np.float32)
    return q, k, v, bias, do


@pytest.mark.parametrize("N,D,dtype,body", [
    (49, 64, BF16, "mma"),     # RVSA's 7×7 windows, ViT-B/L's head dim
    (64, 64, BF16, "mma"),     # a full tile
    (1, 16, BF16, "mma"),
    (25, 48, BF16, "mma"),
    (49, 40, BF16, "mma"),     # padded to 48 by the wrapper
    (49, 128, BF16, "mma"),
    (65, 64, BF16, "simt"),    # one token over the tile
    (100, 64, BF16, "simt"),
    (117, 64, BF16, "simt"),   # the largest window K4's block takes at D = 64
    (49, 144, BF16, "simt"),   # over the tensor-core head dims
    (49, 64, FP32, "simt"),    # fp32 stays on the CUDA cores everywhere
    (64, 16, FP32, "simt"),
    (117, 64, FP32, "simt"),
])
def test_window_body_by_dtype_and_shape(N, D, dtype, body):
    assert fused_attn.window_body(N, D, dtype) == body


def test_window_body_limits_match_the_kernels():
    """`window_body`'s limits are the ones K1's and K4's C entry points
    choose their body by (`win::body` over kRows and kMaxD in
    csrc/window_tile.cuh), so a window the wrapper sends to the tensor cores
    unguarded by `_smem_guard` is one the kernels run there."""
    src = (Path(fused_attn.__file__).parents[1] / "csrc" / "window_tile.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kRows"]) == fused_attn.WINDOW_TILE
    assert int(consts["kMaxD"]) == fused_attn.FLASH_MAX_D
    rule = re.search(r"inline Body body\(int N, int D, int dtype\) \{(.*?)\n\}", src, re.S)
    assert rule and "N > kRows || D > kMaxD" in rule.group(1)


def test_every_small_bf16_window_runs_k1_k4_on_the_tensor_cores():
    """Every bf16 window of at most 64 tokens at every head dim up to 128 is
    routed to K1 and K4 (not to K1L/K7) and runs their tensor-core body; the
    first token over the tile and the first head dim over 128 do not."""
    for N in range(1, fused_attn.WINDOW_TILE + 1):
        for D in range(1, fused_attn.FLASH_MAX_D + 1):
            assert fused_attn.window_fwd_route(N, D) == "window", (N, D)
            assert fused_attn.window_bwd_route(N, D) == "window_bwd", (N, D)
            assert fused_attn.window_body(N, D, BF16) == "mma", (N, D)
            assert fused_attn.window_body(N, D, FP32) == "simt", (N, D)
    assert fused_attn.window_body(fused_attn.WINDOW_TILE + 1, 64, BF16) == "simt"
    assert fused_attn.window_body(49, fused_attn.FLASH_MAX_D + 1, BF16) == "simt"


@pytest.mark.parametrize("N,D,dtype,launched", [
    (49, 40, BF16, 48),    # tensor cores: padded up to a multiple of 16
    (25, 8, BF16, 16),
    (49, 64, BF16, 64),    # already a multiple of 16
    (49, 40, FP32, 40),    # CUDA cores take any head dim
    (100, 40, BF16, 40),
])
def test_window_head_dim_padding(launches, N, D, dtype, launched):
    """On the kernel route K1 and K4 get the head dim their body runs at
    (the tensor-core body's zero-padded q, k, v and dout) and hand back
    outputs of the caller's head dim, contiguous, with one launch each."""
    q = torch.zeros(2, 3, N, D, dtype=dtype, requires_grad=True)
    bias = torch.zeros(2, 3, N, N, requires_grad=True)
    out = fused_attn.fused_window_attention(q, q, q, bias, 0.5)
    out.backward(torch.ones_like(out))
    assert launches == [("mtp_window_attn_fwd", launched),
                        ("mtp_window_attn_bwd", launched)]
    assert {k: n for k, n in fused_attn.LAUNCHES.items() if n} == {"window": 1,
                                                                  "window_bwd": 1}
    assert out.shape == q.shape and out.dtype == dtype and out.is_contiguous()
    assert q.grad.shape == q.shape and bias.grad.shape == bias.shape
    grads = fused_attn.fused_window_attention_bwd(
        q.detach(), q.detach(), q.detach(), bias.detach(), out.detach(), 0.5)
    assert [tuple(g.shape) for g in grads] == [tuple(q.shape)] * 3 + [tuple(bias.shape)]
    assert all(g.is_contiguous() for g in grads)


@pytest.mark.parametrize("N,D", [(49, 40), (25, 8), (49, 64)])
def test_head_dim_zero_padding_is_exact(N, D):
    """What the tensor-core body computes at the padded head dim, cut back
    to D, is K1's and K4's function at D: the plain versions at the padded
    head dim (scale of the original D) against JAX's fused window attention
    and its VJP at D, fp32."""
    q, k, v, bias, do = _inputs(N * D, 2, 3, N, D)
    scale = D ** -0.5
    Dp = fused_attn.flash_head_dim(D)
    pad = lambda a: torch.nn.functional.pad(torch.from_numpy(a), (0, Dp - D))
    out = fused_attn.fused_window_attention_ref(pad(q), pad(k), pad(v),
                                                torch.from_numpy(bias), scale)
    grads = fused_attn.fused_window_attention_bwd_ref(
        pad(q), pad(k), pad(v), torch.from_numpy(bias), pad(do), scale)

    jq, jk, jv, jb = (jnp.asarray(a) for a in (q, k, v, bias))
    ref, vjp = jax.vjp(lambda *a: jax_window(*a, scale, interpret=True), jq, jk, jv, jb)
    ref_grads = vjp(jnp.asarray(do))
    np.testing.assert_allclose(out[..., :D].numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    assert not out[..., D:].any()
    for got, want in zip(grads[:3], ref_grads[:3]):
        np.testing.assert_allclose(got[..., :D].numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
        assert not got[..., D:].any()
    np.testing.assert_allclose(grads[3].numpy(), np.asarray(ref_grads[3]), atol=1e-5,
                               rtol=1e-5)
