"""The port's DCNv3 (`mtp_tpu_torch/ops/dcnv3.py`: `dcnv3_core` and the
`DCNv3` module, the JAX package's kernel K8 through the K3/K6 sampling
functions) against the JAX package, fp32 on both sides, inputs made with
numpy from a seed.

On the CPU the sampling runs its plain versions (`dcnv3_sample_ref`,
`dcnv3_sample_bwd_ref`), which `chip_smoke.py` holds the CUDA kernels
against on the card.  Two JAX references:
- `dcnv3_core_onehot(interpret=True)`, the Pallas path, computes the
  coordinates with the same algebra as the port, so forward values and
  gradients agree everywhere, integer coordinates included;
- `dcnv3_core`, the default path, goes through normalised coordinates of
  the padded map (grid_sample, align_corners=False): at an integer
  coordinate it can land a rounding away (2.9999998 for 3) and take the
  other one-sided subgradient, so gradients are held to it at random,
  non-integer offsets only; forward values agree at both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.ops.dcnv3 import DCNv3 as JaxDCNv3
from mtp_tpu.ops.dcnv3 import dcnv3_core as jax_core
from mtp_tpu.ops.dcnv3_pallas import dcnv3_core_onehot as jax_onehot
from mtp_tpu_torch.ckpt.from_jax import dcnv3_from_jax
from mtp_tpu_torch.ops import dcnv3_sample as dcn
from mtp_tpu_torch.ops.dcnv3 import DCNv3, dcnv3_core

torch.set_num_threads(1)

# forward: fp32 sums of 4·9 weighted corners in another order, and for
# `dcnv3_core` coordinates a rounding apart
FWD_ATOL, FWD_RTOL = 3e-5, 1e-4
# gradients: fp32 sums of up to 4·9·gc products (dx: a scatter of every
# tap's corners) in another order
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed, N, H, W, G, gc, zero_offsets):
    """x, offsets (zero: every tap on an integer coordinate, the border ones
    partly or wholly off the map; else N(0, 1.5²)), a softmaxed mask, and an
    output cotangent."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, H, W, G * gc)).astype(np.float32)
    off = np.zeros((N, H, W, G * 18), np.float32) if zero_offsets else \
        (rng.standard_normal((N, H, W, G * 18)) * 1.5).astype(np.float32)
    logits = rng.standard_normal((N, H, W, G, 9))
    m = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    m = m.reshape(N, H, W, G * 9).astype(np.float32)
    g = rng.standard_normal((N, H, W, G * gc)).astype(np.float32)
    return x, off, m, g


CASES = {
    "random 9x11 s1": ((2, 9, 11, 3, 4), 1.0, False),
    "random 8x8 s2": ((2, 8, 8, 2, 8), 2.0, False),
    "zero b1 7x10 s2": ((1, 7, 10, 2, 4), 2.0, True),
    "zero 6x6 s1": ((2, 6, 6, 4, 4), 1.0, True),
}


def _close(got, ref, atol, rtol, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=atol,
                               rtol=rtol, err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=list(CASES))
def test_core_forward_matches_both_jax_paths(case):
    (N, H, W, G, gc), scale, zero = CASES[case]
    x, off, m, _ = _inputs(list(CASES).index(case), N, H, W, G, gc, zero)
    kw = dict(group=G, offset_scale=scale)
    before = dict(dcn.LAUNCHES)
    got = dcnv3_core(_t(x), _t(off), _t(m), **kw)
    assert dcn.LAUNCHES == before  # CPU: the plain version
    assert got.shape == x.shape and got.dtype == torch.float32
    args = tuple(map(jnp.asarray, (x, off, m)))
    _close(got, jax_onehot(*args, **kw, interpret=True), 1e-5, 1e-5, "onehot")
    _close(got, jax.jit(lambda *a: jax_core(*a, **kw))(*args), FWD_ATOL,
           FWD_RTOL, "dcnv3_core")


def _grads(fn, x, off, m, g):
    """d<fn(x, off, m), g>/d(x, off, m)."""
    leaves = [_t(a).requires_grad_() for a in (x, off, m)]
    return torch.autograd.grad(fn(*leaves), leaves, _t(g))


@pytest.mark.parametrize("case", CASES, ids=list(CASES))
def test_core_gradients_match_onehot(case):
    """x, offset and mask gradients against jax.vjp of the Pallas path: at
    zero offsets every coordinate is an integer and the floor/frac
    subgradient decides the offset gradient (taps at −1 and −2 included)."""
    (N, H, W, G, gc), scale, zero = CASES[case]
    x, off, m, g = _inputs(10 + list(CASES).index(case), N, H, W, G, gc, zero)
    kw = dict(group=G, offset_scale=scale)
    _, vjp = jax.vjp(lambda *a: jax_onehot(*a, **kw, interpret=True),
                     *map(jnp.asarray, (x, off, m)))
    ref = vjp(jnp.asarray(g))
    got = _grads(lambda *a: dcnv3_core(*a, **kw), x, off, m, g)
    for name, a, b in zip(("dx", "doffset", "dmask"), got, ref):
        _close(a, b, GRAD_ATOL, GRAD_RTOL, name)
    if zero:  # the offset gradient is not trivially zero at the integers
        assert got[1].abs().max() > 0.1


@pytest.mark.parametrize("case", [c for c in CASES if not CASES[c][2]])
def test_core_gradients_match_dcnv3_core_at_random_offsets(case):
    (N, H, W, G, gc), scale, _ = CASES[case]
    x, off, m, g = _inputs(20 + list(CASES).index(case), N, H, W, G, gc, False)
    kw = dict(group=G, offset_scale=scale)
    ref = jax.jit(lambda cot, *a: jax.vjp(lambda *b: jax_core(*b, **kw), *a)[1](cot))(
        jnp.asarray(g), *map(jnp.asarray, (x, off, m)))
    got = _grads(lambda *a: dcnv3_core(*a, **kw), x, off, m, g)
    for name, a, b in zip(("dx", "doffset", "dmask"), got, ref):
        _close(a, b, GRAD_ATOL, GRAD_RTOL, name)


@pytest.mark.parametrize("group,scale,hw", [(2, 2.0, (6, 9)), (4, 1.0, (8, 8))])
def test_dcnv3_module_matches_jax(group, scale, hw):
    """The whole block: input projection, depthwise conv + LN + GELU, the
    offset / mask regressors (their zero-init kernels replaced by random
    ones, so offsets are non-zero and masks not uniform) and the output
    projection; forward and the input gradient."""
    C = 8 * group
    rng = np.random.default_rng(group)
    x = rng.standard_normal((2,) + hw + (C,)).astype(np.float32)
    mod = JaxDCNv3(C, group=group, offset_scale=scale)
    params = jax.jit(mod.init)(jax.random.PRNGKey(group), jnp.asarray(x))["params"]
    params = dict(params)
    for name, std in (("offset", 0.5), ("mask", 1.0)):
        params[name] = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32)
                                       * std) for k, v in params[name].items()}
    g = rng.standard_normal(x.shape).astype(np.float32)

    @jax.jit
    def ref_fn(a, cot):
        out, vjp = jax.vjp(lambda b: mod.apply({"params": params}, b), a)
        return out, vjp(cot)[0]

    ref, ref_dx = ref_fn(jnp.asarray(x), jnp.asarray(g))
    port = DCNv3(C, group=group, offset_scale=scale)
    sd = dcnv3_from_jax(params)
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd)
    xt = _t(x).requires_grad_()
    got = port(xt)
    _close(got, ref, 1e-4, 1e-4, "out")
    (dx,) = torch.autograd.grad(got, xt, _t(g))
    _close(dx, ref_dx, 1e-4, 1e-4, "dx")
