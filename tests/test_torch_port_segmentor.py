"""The port's UperNet head, segmentor, sliding-window inference and
segmentation predict path against the JAX package's, same weights (converted
with `upernet_from_jax` / `segmentor_from_jax`), fp32 on both sides."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.ckpt.full_convert import convert_upernet_head
from mtp_tpu.eval.slide import slide_inference as jax_slide_inference
from mtp_tpu.heads.upernet import UperNetHead as JaxUperNetHead
from mtp_tpu.heads.upernet import resize_bilinear as jax_resize
from mtp_tpu.models.segmentor import Segmentor as JaxSegmentor
from mtp_tpu.models.vit_rvsa import rescale_block_init
from mtp_tpu.utils.config import (BackboneConfig, SlideConfig, TaskConfig,
                                  TrainConfig)
from mtp_tpu_torch.ckpt.from_jax import segmentor_from_jax, upernet_from_jax
from mtp_tpu_torch.eval.slide import slide_inference
from mtp_tpu_torch.heads.upernet import UperNetHead
from mtp_tpu_torch.models.segmentor import Segmentor
from mtp_tpu_torch.tasks.segmentation import SegmentationTask

torch.set_num_threads(1)

ATOL, RTOL = 5e-4, 1e-3  # whole segmentor, as tests/test_full_chain_parity.py

CFG = BackboneConfig(img_size=128, embed_dim=32, depth=4, num_heads=2,
                     interval=2, out_indices=(0, 1, 2, 3), dtype="float32")


def _randomise_bn(params, stats, rng):
    """Non-trivial BatchNorm affine parameters and running statistics."""
    def walk(p, s):
        for k in p:
            if k == "bn":
                n = p[k]["scale"].shape
                p[k] = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, n), jnp.float32),
                        "bias": jnp.asarray(rng.normal(0, 0.2, n), jnp.float32)}
                s[k] = {"mean": jnp.asarray(rng.normal(0, 0.3, n), jnp.float32),
                        "var": jnp.asarray(rng.uniform(0.5, 2.0, n), jnp.float32)}
            elif isinstance(p[k], dict) and k in s:
                walk(p[k], s[k])
    params = jax.tree_util.tree_map(lambda x: x, params)
    stats = jax.tree_util.tree_map(lambda x: x, stats)
    walk(params, stats)
    return params, stats


@pytest.mark.parametrize("base_hw", [(24, 24), (20, 28)])
def test_upernet_head(base_hw):
    rng = np.random.default_rng(base_hw[1])
    H, W = base_hw
    feats = [rng.standard_normal((2, -(-H // s), -(-W // s), 32)).astype(np.float32)
             for s in (1, 2, 4, 8)]
    head = JaxUperNetHead(5, channels=16)
    variables = jax.jit(lambda k: head.init(k, [jnp.asarray(f) for f in feats])
                        )(jax.random.PRNGKey(0))
    params, stats = _randomise_bn(variables["params"],
                                  variables["batch_stats"], rng)
    ref = jax.jit(lambda v, f: head.apply(v, f))(
        {"params": params, "batch_stats": stats}, [jnp.asarray(f) for f in feats])
    port = UperNetHead([32] * 4, 5, channels=16).eval()
    sd = upernet_from_jax(params, stats)
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port([torch.from_numpy(f) for f in feats])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)

    # round trip through the JAX package's mmseg converter
    back_p, back_s = convert_upernet_head(
        {k: v.numpy() for k, v in port.state_dict().items()}, prefix="")
    for tree, back in ((params, back_p), (stats, back_s)):
        leaves = jax.tree_util.tree_leaves_with_path(tree)
        got_leaves = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(leaves) == len(got_leaves)
        for path, leaf in leaves:
            np.testing.assert_array_equal(got_leaves[path], np.asarray(leaf))


def _segmentor_pair(num_classes, crop, seed):
    model = JaxSegmentor(CFG, num_classes, channels=16)
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, crop, crop, 3)), train=False))(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = dict(variables["params"])
    params["backbone"] = rescale_block_init(params["backbone"], CFG.depth)
    params, stats = _randomise_bn(params, variables["batch_stats"], rng)
    jvars = {"params": params, "batch_stats": stats}
    port = Segmentor(CFG, num_classes, channels=16, input_hw=(crop, crop)).eval()
    port.load_state_dict(segmentor_from_jax(jvars, CFG))
    return model, jvars, port


def test_segmentor_slide_inference_and_predict():
    """Slide inference at a 176×192 tile over 128² crops (an 8×8 token
    grid, padded to 14×14 in the RVSA blocks), stride 64: 4 overlapping
    crops, edge crops shifted inward, logits resized to the crop as
    `SegmentationTask.predict_fn` does."""
    K, crop = 3, 128
    slide = SlideConfig(crop=crop, stride=64)
    model, jvars, port = _segmentor_pair(K, crop, 3)
    images = np.random.default_rng(4).standard_normal((2, 176, 192, 3)
                                                      ).astype(np.float32)

    def jax_crop(t):
        return jax_resize(model.apply(jvars, t, train=False), t.shape[1:3])

    ref = jax.jit(lambda im: jax_slide_inference(jax_crop, im, K, slide))(
        jnp.asarray(images))
    task = SegmentationTask(TaskConfig(task="segmentation", num_classes=K,
                                       backbone=CFG, slide=slide), model=port,
                            device="cpu")
    got = task.slide_logits(torch.from_numpy(images))
    assert got.shape == (2, 176, 192, K) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)

    pred = task.predict_fn()(torch.from_numpy(images))
    assert pred.shape == (2, 176, 192)
    np.testing.assert_array_equal(pred.numpy(), got.argmax(-1).numpy())


def test_slide_inference_averages_overlaps_and_whole_image():
    """Averaging rule with a known apply_fn: crop logits equal to the crop's
    own pixels reproduce the image exactly; an image no larger than the crop
    is one call."""
    images = torch.arange(2 * 9 * 13, dtype=torch.float32).reshape(2, 9, 13, 1)
    out = slide_inference(lambda t: t * 1.0, images, 1, SlideConfig(crop=5, stride=3))
    torch.testing.assert_close(out, images)
    calls = []
    small = torch.ones(1, 4, 4, 1)
    slide_inference(lambda t: calls.append(t.shape) or t, small, 1,
                    SlideConfig(crop=5, stride=3))
    assert calls == [small.shape]


@pytest.mark.parametrize("batch", [1, 2])
def test_kernel_launches_per_forward(monkeypatch, batch):
    """With the device dispatch forced to the kernel route and each launch
    stubbed out, one segmentor forward requests K1 once per RVSA block, K2
    once per full block and K3 twice per RVSA block, every time with the
    contiguous inputs the CUDA kernels require (batch 1 included, where a
    reshape of a permuted tensor can stay a strided view)."""
    from mtp_tpu_torch.kernels import _build
    from mtp_tpu_torch.ops import dcnv3_sample as dcn
    from mtp_tpu_torch.ops import fused_attn

    requested = []
    checked = []
    real_check = _build.check_launchable

    def check(**tensors):
        checked.append(sorted(tensors))
        real_check(**tensors)

    monkeypatch.setattr(_build, "use_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "check_launchable", check)
    monkeypatch.setattr(_build, "launch", lambda name, *a: requested.append(name))
    monkeypatch.setattr(fused_attn, "LAUNCHES", {"window": 0, "flash": 0})
    monkeypatch.setattr(dcn, "LAUNCHES", {"bilinear_sample": 0})
    port = Segmentor(CFG, 3, channels=16).eval()
    with torch.no_grad():
        port(torch.zeros(batch, 128, 128, 3))
    n_full = CFG.depth // CFG.interval
    n_rvsa = CFG.depth - n_full
    assert fused_attn.LAUNCHES == {"window": n_rvsa, "flash": n_full}
    assert dcn.LAUNCHES == {"bilinear_sample": 2 * n_rvsa}
    assert requested.count("mtp_window_attn_fwd") == n_rvsa
    assert requested.count("mtp_flash_attn_fwd") == n_full
    assert requested.count("mtp_bilinear_sample_fwd") == 2 * n_rvsa
    assert len(checked) == len(requested)


@pytest.mark.parametrize("batch", [1, 2])
def test_kernel_launches_per_train_step(monkeypatch, batch):
    """One `train_step_fn` step (train-mode BatchNorm, dropout and drop-path
    on) with the kernel route forced and each launch stubbed out: per RVSA
    block K1 and K4 once and K3 and K6 twice, per full block K2 and K5 once,
    and every forward and backward launch given contiguous inputs (batch 1
    included, where a permuted reshape can stay a strided view)."""
    from mtp_tpu_torch.kernels import _build
    from mtp_tpu_torch.ops import dcnv3_sample as dcn
    from mtp_tpu_torch.ops import fused_attn

    requested = []
    checked = []
    real_check = _build.check_launchable

    def check(**tensors):
        checked.append(sorted(tensors))
        real_check(**tensors)

    monkeypatch.setattr(_build, "use_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "check_launchable", check)
    monkeypatch.setattr(_build, "launch", lambda name, *a: requested.append(name))
    monkeypatch.setattr(fused_attn, "LAUNCHES", dict.fromkeys(fused_attn.LAUNCHES, 0))
    monkeypatch.setattr(dcn, "LAUNCHES", dict.fromkeys(dcn.LAUNCHES, 0))
    cfg = TaskConfig(task="segmentation", num_classes=3,
                     backbone=dataclasses.replace(CFG, drop_path_rate=0.3),
                     train=TrainConfig(batch_size=batch))
    task = SegmentationTask(cfg, model=Segmentor(cfg.backbone, 3, channels=16,
                                                 input_hw=(128, 128)),
                            device="cpu")
    state = task.init_state(torch.Generator().manual_seed(0))
    batch_ = {"image": torch.zeros(batch, 128, 128, 3),
              "label": torch.zeros(batch, 128, 128, dtype=torch.long)}
    state, _ = task.train_step_fn()(state, batch_)
    n_full = CFG.depth // CFG.interval
    n_rvsa = CFG.depth - n_full
    want = {"window": n_rvsa, "flash": n_full, "window_bwd": n_rvsa,
            "flash_bwd": n_full, "bilinear_sample": 2 * n_rvsa,
            "bilinear_sample_bwd": 2 * n_rvsa, "window_large": 0,
            "window_bwd_qblk": 0}
    assert {**fused_attn.LAUNCHES, **dcn.LAUNCHES} == want
    for name, n in (("mtp_window_attn_fwd", n_rvsa), ("mtp_flash_attn_fwd", n_full),
                    ("mtp_bilinear_sample_fwd", 2 * n_rvsa),
                    ("mtp_window_attn_bwd", n_rvsa), ("mtp_flash_attn_bwd", n_full),
                    ("mtp_bilinear_sample_bwd", 2 * n_rvsa)):
        assert requested.count(name) == n, name
    assert len(checked) == len(requested) == sum(want.values())
    assert checked.count(["bias", "dout", "k", "q", "v"]) == n_rvsa
    assert checked.count(["g", "img", "m", "px", "py"]) == 2 * n_rvsa
