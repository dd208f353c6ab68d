"""The port's InternImage → UperNet segmentor against the JAX package's
(logits and sliding-window inference, same weights), and the port's own
train-mode machinery on InternImage: kernel launches per forward and per
train step with stubbed launches, and remat against no remat with drop-path
on.

The JAX package builds its Segmentor backbone from the recipe's name (XL or
T); at the small size of these tests the JAX side composes `InternImage`
and `UperNetHead` under the same submodule names, and the port's Segmentor
takes the small `InternImageConfig` directly.  fp32 on both sides, inputs
made with numpy from a seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from mtp_tpu.eval.slide import slide_inference as jax_slide_inference
from mtp_tpu.heads.upernet import UperNetHead as JaxUperNetHead
from mtp_tpu.heads.upernet import resize_bilinear as jax_resize
from mtp_tpu.models import internimage as ji
from mtp_tpu_torch import config as pc
from mtp_tpu_torch.ckpt.from_jax import init_weights, segmentor_from_jax
from mtp_tpu_torch.models.segmentor import Segmentor
from mtp_tpu_torch.tasks.segmentation import SegmentationTask

torch.set_num_threads(1)

ATOL, RTOL = 5e-4, 1e-3  # whole segmentor, as tests/test_full_chain_parity.py

JAX_TINY = dataclasses.replace(ji.internimage_xl(), channels=16, depths=(1, 1, 2, 1),
                               groups=(2, 4, 8, 16), layer_scale=0.5,
                               dtype="float32", drop_path_rate=0.0)
TINY = pc.InternImageConfig(**dataclasses.asdict(JAX_TINY))
N_LAYERS = sum(TINY.depths)
K, CHANNELS = 3, 16


class JaxSegmentor(fnn.Module):
    """`mtp_tpu.models.segmentor.Segmentor` with the backbone built from an
    InternImageConfig."""

    cfg: ji.InternImageConfig
    num_classes: int
    channels: int

    @fnn.compact
    def __call__(self, x, train=False, deterministic=True):
        feats = ji.InternImage(self.cfg, name="backbone")(x, deterministic)
        return JaxUperNetHead(self.num_classes, channels=self.channels,
                              name="decode_head")(feats, train, deterministic)


def _jitter(tree, rng):
    """Random offset / mask regressors (about half a pixel of offset before
    offset_scale, unit mask logits) and non-trivial BatchNorm parameters."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k in ("offset", "mask"):
            std = (0.5 if k == "offset" else 1.0) / np.sqrt(v["kernel"].shape[0])
            out[k] = {n: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)
                                     * std) for n, a in v.items()}
        elif k == "bn":
            n = v["scale"].shape
            out[k] = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, n), jnp.float32),
                      "bias": jnp.asarray(rng.normal(0, 0.2, n), jnp.float32)}
        else:
            out[k] = _jitter(v, rng)
    return out


def test_segmentor_logits_and_slide_inference():
    """Stride-4 logits of one 64² crop, then slide inference over a 96×112
    tile with 64² crops at stride 32 (6 overlapping crops, edge crops
    shifted inward), and `predict_fn`'s argmax."""
    crop = 64
    model = JaxSegmentor(JAX_TINY, K, CHANNELS)
    variables = jax.jit(lambda k: model.init(k, jnp.zeros((1, crop, crop, 3))))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    stats = jax.tree.map(lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape),
                                               jnp.float32), variables["batch_stats"])
    jvars = {"params": _jitter(variables["params"], rng), "batch_stats": stats}
    port = Segmentor(TINY, K, channels=CHANNELS).eval()
    port.load_state_dict(segmentor_from_jax(jvars, TINY))

    x = rng.standard_normal((2, crop, crop, 3)).astype(np.float32)
    ref = jax.jit(lambda v, t: model.apply(v, t))(jvars, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)

    slide = pc.SlideConfig(crop=crop, stride=32)
    images = rng.standard_normal((2, 96, 112, 3)).astype(np.float32)
    ref = jax.jit(lambda im: jax_slide_inference(
        lambda t: jax_resize(model.apply(jvars, t), t.shape[1:3]), im, K, slide))(
        jnp.asarray(images))
    cfg = pc.TaskConfig(task="segmentation", num_classes=K,
                        backbone=pc.internimage_backbone_config(
                            "internimage_xl", crop, dtype="float32"), slide=slide)
    task = SegmentationTask(cfg, model=port, device="cpu")
    logits = task.slide_logits(torch.from_numpy(images))
    assert logits.shape == (2, 96, 112, K) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    pred = task.predict_fn()(torch.from_numpy(images))
    np.testing.assert_array_equal(pred.numpy(), logits.argmax(-1).numpy())


@pytest.fixture
def stubbed_launches(monkeypatch):
    """The device dispatch forced to the kernel route, every launch stubbed
    out and recorded, every launch's inputs checked for the contiguous
    storage the CUDA kernels require."""
    from mtp_tpu_torch.kernels import _build
    from mtp_tpu_torch.ops import dcnv3_sample as dcn
    from mtp_tpu_torch.ops import fused_attn

    requested, checked = [], []
    real_check = _build.check_launchable

    def check(**tensors):
        checked.append(sorted(tensors))
        real_check(**tensors)

    monkeypatch.setattr(_build, "use_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "check_launchable", check)
    monkeypatch.setattr(_build, "launch", lambda name, *a: requested.append(name))
    monkeypatch.setattr(fused_attn, "LAUNCHES", dict.fromkeys(fused_attn.LAUNCHES, 0))
    monkeypatch.setattr(dcn, "LAUNCHES", dict.fromkeys(dcn.LAUNCHES, 0))
    return lambda: ({**fused_attn.LAUNCHES, **dcn.LAUNCHES}, requested, checked)


@pytest.mark.parametrize("batch", [1, 2])
def test_kernel_launches_per_forward(stubbed_launches, batch):
    """One forward launches K3 once per layer and nothing else, every time
    with contiguous inputs (batch 1 included, where a reshape of a permuted
    tensor can stay a strided view)."""
    port = Segmentor(TINY, K, channels=CHANNELS).eval()
    with torch.no_grad():
        port(torch.zeros(batch, 64, 64, 3))
    counts, requested, checked = stubbed_launches()
    assert counts == {"window": 0, "flash": 0, "window_bwd": 0, "flash_bwd": 0,
                      "window_large": 0, "window_bwd_qblk": 0,
                      "bilinear_sample": N_LAYERS, "bilinear_sample_bwd": 0}
    assert requested == ["mtp_bilinear_sample_fwd"] * N_LAYERS
    assert checked == [["img", "m", "px", "py"]] * N_LAYERS


@pytest.mark.parametrize("batch,remat", [(1, True), (2, True), (2, False)])
def test_kernel_launches_per_train_step(stubbed_launches, batch, remat):
    """One `train_step_fn` step (train-mode BatchNorm, dropout and drop-path
    on): K6 once per layer; K3 once per layer, twice with remat (the
    forward, then the recompute in the backward); contiguous inputs to every
    launch."""
    backbone = pc.internimage_backbone_config("internimage_xl", 64,
                                              drop_path_rate=0.3, remat=remat)
    cfg = pc.TaskConfig(task="segmentation", num_classes=K, backbone=backbone,
                        train=pc.TrainConfig(batch_size=batch))
    task = SegmentationTask(cfg, model=Segmentor(
        dataclasses.replace(TINY, drop_path_rate=0.3, remat=remat), K,
        channels=CHANNELS), device="cpu")
    state = task.init_state(torch.Generator().manual_seed(0))
    batch_ = {"image": torch.zeros(batch, 64, 64, 3),
              "label": torch.zeros(batch, 64, 64, dtype=torch.long)}
    state, _ = task.train_step_fn()(state, batch_)
    counts, requested, checked = stubbed_launches()
    fwd = N_LAYERS * (2 if remat else 1)
    assert counts == {"window": 0, "flash": 0, "window_bwd": 0, "flash_bwd": 0,
                      "window_large": 0, "window_bwd_qblk": 0,
                      "bilinear_sample": fwd, "bilinear_sample_bwd": N_LAYERS}
    assert requested.count("mtp_bilinear_sample_fwd") == fwd
    assert requested.count("mtp_bilinear_sample_bwd") == N_LAYERS
    assert len(checked) == len(requested) == fwd + N_LAYERS
    assert checked.count(["g", "img", "m", "px", "py"]) == N_LAYERS


def test_remat_matches_no_remat_with_drop_path():
    """With drop-path on, the same generator seed gives the same loss and
    the same gradients with each layer recomputed under
    torch.utils.checkpoint as without: the masks are drawn once, before the
    checkpointed call.  Drop-path is seen to act (the loss differs from the
    deterministic one)."""
    def run(remat, deterministic=False):
        model = Segmentor(dataclasses.replace(TINY, drop_path_rate=0.5, remat=remat),
                          K, channels=CHANNELS)
        gen = torch.Generator().manual_seed(3)
        init_weights(model, gen)
        with torch.no_grad():  # non-zero offset and mask regressors
            for p in model.parameters():
                p.add_(0.01 * torch.randn(p.shape, generator=gen))
        cfg = pc.TaskConfig(task="segmentation", num_classes=K, backbone=pc.
                            internimage_backbone_config("internimage_xl", 64,
                                                        dtype="float32"))
        task = SegmentationTask(cfg, model=model, device="cpu")
        rng = np.random.default_rng(4)
        batch = {"image": torch.from_numpy(rng.standard_normal(
            (4, 64, 64, 3)).astype(np.float32)),
            "label": torch.from_numpy(rng.integers(0, K, (4, 64, 64)))}
        loss, _ = task.loss_fn(model, batch, torch.Generator().manual_seed(5),
                               deterministic=deterministic)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in model.named_parameters()}

    (loss_r, grads_r), (loss_p, grads_p) = run(True), run(False)
    assert torch.equal(loss_r, loss_p)
    assert grads_r.keys() == grads_p.keys()
    for name in grads_p:
        torch.testing.assert_close(grads_r[name], grads_p[name], rtol=0, atol=0,
                                   msg=name)
    assert not torch.equal(run(False, deterministic=True)[0], loss_p)
