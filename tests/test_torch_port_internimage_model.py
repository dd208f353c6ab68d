"""The port's InternImage (`mtp_tpu_torch/models/internimage.py`) against
the JAX package's: config and recipe copies, both layer branches (post-norm
as XL, pre-norm as T), the whole backbone from the unrolled and the scanned
JAX layouts, the round trip through the JAX package's `convert_internimage`,
the random init, the FLOP count and the layer-decay ids.

Small configs (channels 16, depths (1, 1, 2, 1)), fp32 on both sides, inputs
made with numpy from a seed.  The zero-init offset and mask regressors are
replaced by random ones so that the sampling is off the integer grid and
the masks are not uniform.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu import configs as jrecipes
from mtp_tpu.ckpt.torch_convert import convert_internimage, to_stage_scan_layout
from mtp_tpu.core import optim as jopt
from mtp_tpu.models import backbones as jb
from mtp_tpu.models import internimage as ji
from mtp_tpu_torch import config as pc
from mtp_tpu_torch.ckpt.from_jax import (init_weights, internimage_from_jax,
                                         internimage_layer_from_jax)
from mtp_tpu_torch.core import optim as popt
from mtp_tpu_torch.models import internimage as pi

torch.set_num_threads(1)

ATOL, RTOL = 1e-4, 1e-4  # modules, fp32 both sides

TINY = dataclasses.replace(ji.internimage_t(), channels=16, depths=(1, 1, 2, 1),
                           groups=(2, 4, 8, 16), dtype="float32",
                           drop_path_rate=0.0)
# the XL layer: post-norm, layer scale, offset_scale 2 (the scale is raised
# from 1e-5 so that the branches show in the output)
TINY_XL = dataclasses.replace(TINY, post_norm=True, layer_scale=0.5,
                              offset_scale=2.0)


def _port_cfg(cfg) -> pc.InternImageConfig:
    return pc.InternImageConfig(**dataclasses.asdict(cfg))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jitter(tree, rng):
    """Random offset / mask regressors in every DCNv3 of the tree: offsets
    of about half a pixel (before offset_scale) and masks of about unit
    logits, whatever the width."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k in ("offset", "mask"):
            std = (0.5 if k == "offset" else 1.0) / np.sqrt(v["kernel"].shape[0])
            out[k] = {n: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)
                                     * std) for n, a in v.items()}
        else:
            out[k] = _jitter(v, rng)
    return out


def _init(mod, x, seed):
    return jax.jit(mod.init)(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]


def _close(got, ref):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_config_and_recipe_copies_match_the_jax_package():
    want = [(f.name, f.type, f.default) for f in dataclasses.fields(ji.InternImageConfig)]
    got = [(f.name, f.type, f.default) for f in dataclasses.fields(pc.InternImageConfig)]
    assert got == want
    for factory in ("internimage_xl", "internimage_t"):
        assert dataclasses.asdict(getattr(pc, factory)()) == \
            dataclasses.asdict(getattr(ji, factory)())
    for variant in ("internimage_xl", "internimage_t"):
        for kw in ({}, {"remat": True, "scan": True, "drop_path_rate": 0.3,
                        "dtype": "float32", "pallas_attn": True}):
            shell = pc.internimage_backbone_config(variant, 448, **kw)
            assert dataclasses.asdict(shell) == dataclasses.asdict(
                jb.internimage_backbone_config(variant, 448, **kw))
            # the InternImage config the JAX factory builds from the shell
            assert dataclasses.asdict(pc.internimage_config(shell)) == \
                dataclasses.asdict(jb.build_backbone(shell).cfg)
    from mtp_tpu_torch import configs as precipes

    recipe = precipes.get("intern-xl-upernet-512-imp-mtp-loveda").task
    for name in ("intern-xl-upernet-512-imp-mtp-loveda",
                 "intern-xl-upernet-512-imp-loveda"):
        assert dataclasses.asdict(recipe) == \
            dataclasses.asdict(jrecipes.get(name).task), name
    assert pc.internimage_config(recipe.backbone).drop_path_rate == 0.1
    assert pc.internimage_config(recipe.backbone).remat


@pytest.mark.parametrize("post_norm", [True, False], ids=["post-norm", "pre-norm"])
def test_layer_matches_jax(post_norm):
    cfg = TINY_XL if post_norm else TINY
    C, G = 16, 2
    x = _x((2, 6, 7, C), 3)
    mod = ji.InternImageLayer(C, G, 4.0, 0.0, cfg.layer_scale, cfg.offset_scale,
                              post_norm)
    params = _jitter(_init(mod, x, 1), np.random.default_rng(2))
    ref = jax.jit(mod.apply)({"params": params}, jnp.asarray(x))
    port = pi.InternImageLayer(C, G, 4.0, 0.0, cfg.layer_scale, cfg.offset_scale,
                               post_norm)
    port.load_state_dict(internimage_layer_from_jax(params))
    _close(port(torch.from_numpy(x)), ref)


def _backbone_params(cfg, hw, seed):
    mod = ji.InternImage(cfg)
    params = _init(mod, _x((1,) + hw + (3,), 0), seed)
    return _jitter(jax.tree.map(np.asarray, params), np.random.default_rng(seed))


@pytest.mark.parametrize("cfg,scan", [(TINY_XL, False), (TINY, True)],
                         ids=["post-norm-unrolled", "pre-norm-scanned"])
def test_internimage_all_levels(cfg, scan):
    """All 4 pyramid levels (C, 2C, 4C, 8C at strides 4..32) on a 40×56
    input, from the unrolled and the scanned (`stage{s}_layers`) JAX
    layouts; the pre-norm variant has the stage norms."""
    hw = (40, 56)
    x = _x((2,) + hw + (3,), 5)
    params = _backbone_params(cfg, hw, 7)
    jcfg = dataclasses.replace(cfg, scan=scan)
    jparams = to_stage_scan_layout(params, cfg.depths) if scan else params
    refs = jax.jit(ji.InternImage(jcfg).apply)({"params": jparams}, jnp.asarray(x))
    port = pi.InternImage(_port_cfg(jcfg))
    assert port.out_channels == (16, 32, 64, 128)
    port.load_state_dict(internimage_from_jax(jparams, _port_cfg(jcfg)))
    with torch.no_grad():
        outs = port(torch.from_numpy(x))
    assert len(outs) == 4
    for got, ref in zip(outs, refs):
        assert got.shape == ref.shape
        _close(got, ref)


@pytest.mark.parametrize("cfg", [TINY_XL, TINY], ids=["post-norm", "pre-norm"])
def test_round_trip_through_reference_converter(cfg):
    """convert_internimage(port.state_dict()) gives back the JAX tree, and
    the port's state_dict holds exactly the reference keys it reads."""
    params = _backbone_params(cfg, (32, 32), 9)
    sd = internimage_from_jax(params, _port_cfg(cfg))
    port = pi.InternImage(_port_cfg(cfg))
    assert set(port.state_dict()) == set(sd)
    port.load_state_dict(sd)
    back = convert_internimage({k: v.numpy() for k, v in port.state_dict().items()},
                               cfg.depths)
    flat_p = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_p) == len(flat_b)
    for path, leaf in flat_p:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf))


def test_init_weights_mirrors_jax_init():
    """Per tensor: zeros where JAX has zeros (the offset and mask
    regressors, biases), the layer scale on the gammas, and a standard
    deviation within 15% of the JAX tensor's for tensors of at least 1000
    entries (xavier-uniform projections, lecun-normal MLP and convs with the
    depthwise fan_in of 9)."""
    cfg = dataclasses.replace(TINY_XL, channels=32, layer_scale=1e-5)
    ref = internimage_from_jax(jax.tree.map(np.asarray, _init(
        ji.InternImage(cfg), _x((1, 32, 32, 3), 0), 0)), _port_cfg(cfg))
    make = lambda: init_weights(pi.InternImage(_port_cfg(cfg)),
                                torch.Generator().manual_seed(0)).state_dict()
    sd, again = make(), make()
    assert set(sd) == set(ref)
    compared = 0
    for name, want in ref.items():
        got = sd[name]
        torch.testing.assert_close(got, again[name])  # seeded
        if not want.any():
            assert not got.any(), name
        elif name.endswith(("gamma1", "gamma2")):
            torch.testing.assert_close(got, want)
        elif want.numel() >= 1000:
            ratio = (got.std() / want.std()).item()
            assert 0.85 < ratio < 1.15, (name, ratio)
            compared += 1
    assert compared >= 20


def test_internimage_flops_matches_reference():
    for cfg, size in ((ji.internimage_xl(), 512), (ji.internimage_t(), 224),
                      (TINY, 64)):
        assert pi.internimage_flops(_port_cfg(cfg), size) == \
            ji.internimage_flops(cfg, size)


def _flax_name(name: str) -> str:
    """A port InternImage parameter name in the flax tree's terms, enough
    for the JAX layer-id rules (stem, stage{s}_layer{i}, down{s}_, the
    stage norms)."""
    parts = name.split(".")
    if parts[0] == "patch_embed":
        return "stem_" + parts[1]
    s = parts[1]
    if parts[2] == "blocks":
        return f"stage{s}_layer{parts[3]}/" + "/".join(parts[4:])
    if parts[2] == "downsample":
        return f"down{s}_{parts[3]}"
    return f"stage{s}_norm"


def test_layer_ids_of_xl_match_jax():
    """Every parameter of the full XL (built on the meta device): the port's
    id against the JAX `internimage_layer_id` on the flax name, and the
    scanned layout's ids (from the stacked stage axes) against the port's
    for the layers."""
    shell = pc.internimage_backbone_config("internimage_xl", 512)
    num_layers = shell.depth + 2
    assert num_layers == 41
    with torch.device("meta"):
        port = pi.InternImage(pc.internimage_config(shell))
    fn = popt.layer_id_fn_for(shell, "backbone.")
    jfn = jb.layer_id_fn_for(shell, root="backbone/")
    ids = {}
    for name, _ in port.named_parameters():
        ids[name] = fn("backbone." + name, num_layers)
        assert ids[name] == jfn("backbone/" + _flax_name(name), num_layers), name
    assert fn("decode_head.conv_seg.weight", num_layers) == num_layers - 1
    assert ids["patch_embed.conv1.weight"] == 0
    assert ids["levels.3.blocks.4.mlp.fc2.bias"] == 39
    assert ids["levels.2.downsample.conv.weight"] == 34
    # scanned JAX layout: per-slice scales from the stacked layer axes
    tree = {"backbone": {f"stage{s}_layers": {"l": {"w": np.zeros((d, 1), np.float32)}}
                         for s, d in enumerate((5, 5, 24, 5))}}
    scales = jopt.layer_decay_scales(tree, shell.depth, 0.94, jfn)
    for s, d in enumerate((5, 5, 24, 5)):
        got = np.asarray(scales["backbone"][f"stage{s}_layers"]["l"]["w"])[:, 0]
        want = [0.94 ** (num_layers - ids[f"levels.{s}.blocks.{i}.gamma1"] - 1)
                for i in range(d)]
        np.testing.assert_allclose(got, want, rtol=1e-6)
