"""The port's ViT+RVSA modules against the JAX package's, same weights.

Flax-initialised parameters (rel-pos tables randomised and regressors
scaled up, so the bias paths and off-window sampling are exercised) are
converted with `backbone_from_jax` / `block_from_jax` and both sides run
fp32 on the same numpy input.  The JAX side runs its jnp path
(pallas_attn=False), which the JAX tests hold equal to its Pallas path; the
port runs its kernels' plain versions on the CPU.  The round trip through
the JAX package's own converter (`convert_backbone`) is an independent check
of the port's parameter names and layouts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.ckpt.torch_convert import convert_backbone, to_scan_layout
from mtp_tpu.models import vit_rvsa as jv
from mtp_tpu.utils.config import BackboneConfig
from mtp_tpu_torch.ckpt.from_jax import (attention_from_jax, backbone_from_jax,
                                         block_from_jax)
from mtp_tpu_torch.models import vit_rvsa as pv

torch.set_num_threads(1)

ATOL, RTOL = 1e-4, 1e-4  # modules, fp32 both sides

CFG = BackboneConfig(img_size=128, embed_dim=32, depth=4, num_heads=2,
                     interval=2, out_indices=(0, 1, 2, 3), dtype="float32")


def _jitter(tree, rng):
    """Randomise the zero-init rel-pos tables and widen the regressors, so
    that the rel-pos bias and far, rotated sampling are exercised."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k in ("rel_pos_h", "rel_pos_w"):
            shape = v.shape
            out[k] = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.3)
        elif k.startswith("sampling_"):
            out[k] = {"kernel": v["kernel"] * 30.0,
                      "bias": jnp.asarray(rng.standard_normal(v["bias"].shape)
                                          .astype(np.float32) * 0.3)}
        else:
            out[k] = _jitter(v, rng)
    return out


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _init_backbone(cfg, hw, seed):
    """`jv.init_backbone` under jit (eager flax init is ~4x slower)."""
    init = jax.jit(lambda k: jv.ViTRVSA(cfg).init(k, jnp.zeros((1,) + hw + (3,))))
    return jv.rescale_block_init(init(jax.random.PRNGKey(seed))["params"],
                                 cfg.depth)


def _apply(mod, params, x):
    return jax.jit(mod.apply)({"params": params}, jnp.asarray(x))


def _init(mod, x, seed):
    return jax.jit(mod.init)(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]


def _close(got, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("hw", [(14, 14), (10, 12), (9, 16)])
def test_rvsa_attention(hw):
    C, nH = 32, 2
    x = _x((2,) + hw + (C,), hw[0] * hw[1])
    mod = jv.RVSAAttention(C, nH)
    params = _jitter(_init(mod, x, 0), np.random.default_rng(1))
    ref = _apply(mod, params, x)
    port = pv.RVSAAttention(C, nH)
    port.load_state_dict(attention_from_jax(params, full=False))
    _close(port(torch.from_numpy(x)), ref)


@pytest.mark.parametrize("hw", [(7, 7), (6, 9)])
def test_full_attention(hw):
    C, nH = 32, 4
    x = _x((2,) + hw + (C,), 7 * hw[1])
    mod = jv.FullAttention(C, nH, hw)
    params = _jitter(_init(mod, x, 1), np.random.default_rng(2))
    ref = _apply(mod, params, x)
    port = pv.FullAttention(C, nH, hw)
    port.load_state_dict(attention_from_jax(params, full=True))
    _close(port(torch.from_numpy(x)), ref)


@pytest.mark.parametrize("full", [False, True])
def test_block(full):
    C, nH, hw = 32, 2, (10, 11)
    x = _x((2,) + hw + (C,), 3 + full)
    mod = jv.Block(C, nH, 4.0, full, hw, init_values=0.5)
    params = _jitter(_init(mod, x, 2), np.random.default_rng(3))
    ref = _apply(mod, params, x)
    port = pv.Block(C, nH, 4.0, full, hw, init_values=0.5)
    port.load_state_dict(block_from_jax(params, full))
    _close(port(torch.from_numpy(x)), ref)


def _backbone_pair(cfg, hw, seed):
    x = _x((2,) + hw + (3,), seed)
    params = _jitter(_init_backbone(cfg, hw, seed), np.random.default_rng(seed))
    return x, params


@pytest.mark.parametrize("hw,scan", [((128, 128), False), ((112, 144), True)])
def test_vit_rvsa_all_levels(hw, scan):
    """All 4 pyramid levels, from the unrolled and the scanned JAX layouts
    (8×8 and 7×9 token grids: padded RVSA windows, a rectangular full
    block)."""
    x, params = _backbone_pair(CFG, hw, 11 + scan)
    cfg = dataclasses.replace(CFG, scan=scan)
    jparams = to_scan_layout(params, CFG.depth, CFG.interval) if scan else params
    refs = _apply(jv.ViTRVSA(cfg), jparams, x)
    port = pv.ViTRVSA(cfg, hw).eval()
    port.load_state_dict(backbone_from_jax(jparams, cfg))
    with torch.no_grad():
        outs = port(torch.from_numpy(x))
    assert len(outs) == 4
    for got, ref in zip(outs, refs):
        assert got.shape == ref.shape
        _close(got, ref)


def test_backbone_round_trip_through_reference_converter():
    """convert_backbone(backbone_from_jax(p)) == p, and the port's
    state_dict holds exactly the reference torch keys the converter reads."""
    cfg = dataclasses.replace(CFG, img_size=160)
    params = _init_backbone(cfg, (160, 160), 5)
    sd = backbone_from_jax(params, cfg)
    port = pv.ViTRVSA(cfg)
    assert set(port.state_dict()) == set(sd)
    port.load_state_dict(sd)
    back = convert_backbone({k: v.numpy() for k, v in port.state_dict().items()},
                            cfg)
    flat_p = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_p) == len(flat_b)
    for path, leaf in flat_p:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf))


def test_backbone_flops_matches_reference():
    from mtp_tpu.utils.config import vit_l_rvsa
    for cfg, hw in ((vit_l_rvsa(384), None), (CFG, (112, 144))):
        assert pv.backbone_flops(cfg, hw) == jv.backbone_flops(cfg, hw)


def test_init_weights_mirrors_jax_init():
    """`init_weights` draws each parameter from the distribution the JAX
    init draws it from: per tensor, zeros where JAX has zeros, and a
    standard deviation within 15% of the JAX tensor's (tensors of at least
    1000 entries; the estimate's own noise is under 3% there)."""
    from mtp_tpu_torch.ckpt.from_jax import init_weights

    hw = (128, 128)
    ref = backbone_from_jax(_init_backbone(CFG, hw, 0), CFG)
    port = init_weights(pv.ViTRVSA(CFG, hw), torch.Generator().manual_seed(0))
    again = init_weights(pv.ViTRVSA(CFG, hw), torch.Generator().manual_seed(0))
    sd = port.state_dict()
    assert set(sd) == set(ref)
    compared = 0
    for name, want in ref.items():
        got = sd[name]
        torch.testing.assert_close(got, again.state_dict()[name])  # seeded
        if not want.any():
            assert not got.any(), name
        elif want.numel() >= 1000:
            ratio = (got.std() / want.std()).item()
            assert 0.85 < ratio < 1.15, (name, ratio)
            compared += 1
    assert compared >= 4 * CFG.depth
