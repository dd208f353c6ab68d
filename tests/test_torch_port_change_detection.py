"""The port's change detection against the JAX package's: the nearest
upsample, the UNet head (train and eval mode, running statistics, the
parameter names `convert_unet_head` reads, the random init), the Siamese
detector on the ViT (`features_only`) and on InternImage with each fusion,
`predict`, one train step with and without a frozen backbone, `evaluate`'s
change-class F1, and the kernel launches of one backbone pass per pair
(stubbed launches).

JAX weights are carried to the port by `ckpt.from_jax`; fp32 on both
sides; inputs made with numpy from a seed.  The JAX modules build
InternImage-XL or -T at full size from a config name, so a small
InternImage (XL's layer: post-norm, layer scale) is put in place of JAX's
`build_backbone` for the JAX side.  The JAX task's own train step draws
the head's dropout from its key, so the step is compared through a loss
function that is the JAX task's with `deterministic=True`."""

import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.ckpt.full_convert import convert_unet_head
from mtp_tpu.core.train import make_train_step as jax_make_train_step
from mtp_tpu.core.train import seg_xent as jax_seg_xent
from mtp_tpu.eval.metrics import binary_change_f1 as jax_binary_change_f1
from mtp_tpu.heads.fpn import upsample_nearest as jax_upsample_nearest
from mtp_tpu.heads.unet import UNetHead as JaxUNetHead
from mtp_tpu.heads.upernet import resize_bilinear as jax_resize
from mtp_tpu.models import change_detection as jcd
from mtp_tpu.models import internimage as ji
from mtp_tpu.models.backbones import internimage_backbone_config
from mtp_tpu.parallel.mesh import make_mesh
from mtp_tpu.tasks.change_detection import ChangeDetectionTask as JaxCDTask
from mtp_tpu.utils.config import (BackboneConfig, MeshConfig, OptimizerConfig,
                                  ScheduleConfig, TaskConfig, TrainConfig)
from mtp_tpu_torch import config as pc
from mtp_tpu_torch.ckpt.from_jax import (change_detector_from_jax, init_weights,
                                         unet_from_jax)
from mtp_tpu_torch.core import optim as popt
from mtp_tpu_torch.eval.metrics import SegAccumulator, binary_change_f1
from mtp_tpu_torch.heads.fpn import upsample_nearest
from mtp_tpu_torch.heads.unet import UNetHead
from mtp_tpu_torch.models.change_detection import SiamChangeDetector
from mtp_tpu_torch.models.vit_rvsa import ViTRVSA
from mtp_tpu_torch.tasks.change_detection import ChangeDetectionTask

torch.set_num_threads(1)

ATOL, RTOL = 1e-4, 1e-4  # logits, fp32 both sides
CROP = 64
VIT = BackboneConfig(img_size=CROP, embed_dim=32, depth=4, num_heads=2, interval=2,
                     out_indices=(0, 1, 2, 3), dtype="float32", drop_path_rate=0.0)
TINY_XL = dataclasses.replace(ji.internimage_xl(), channels=16, depths=(1, 1, 2, 1),
                              groups=(2, 4, 8, 16), layer_scale=0.5,
                              dtype="float32", drop_path_rate=0.0)
PORT_XL = pc.InternImageConfig(**dataclasses.asdict(TINY_XL))
XL_SHELL = internimage_backbone_config("internimage_xl", CROP, dtype="float32",
                                       drop_path_rate=0.0)
OPT = OptimizerConfig(lr=1e-3, weight_decay=0.05, layer_decay=0.9, clip_norm=0.0)
SCHED = ScheduleConfig(kind="cosine", total_steps=10, warmup_steps=2,
                       warmup_ratio=0.1)
FAMILIES = {"vit": (VIT, VIT), "internimage": (XL_SHELL, PORT_XL)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def jax_backbone(family):
    if family == "vit":
        return contextlib.nullcontext()
    return mock.patch.object(jcd, "build_backbone",
                             lambda cfg, name="backbone": ji.InternImage(TINY_XL, name=name))


def _randomise(params, stats, rng):
    """Random BatchNorm affines and running statistics, and random DCNv3
    offset and mask regressors (zero at init)."""
    def walk(p, s):
        for k in list(p):
            if k == "bn":
                n = p[k]["scale"].shape
                p[k] = {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                        "bias": rng.normal(0, 0.2, n).astype(np.float32)}
                s[k] = {"mean": rng.normal(0, 0.3, n).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
            elif k in ("offset", "mask"):
                std = (0.5 if k == "offset" else 1.0) / np.sqrt(p[k]["kernel"].shape[0])
                p[k] = {n: (rng.standard_normal(a.shape) * std).astype(np.float32)
                        for n, a in p[k].items()}
            elif isinstance(p[k], dict):
                walk(p[k], s.get(k, {}))
    params = jax.tree.map(np.array, params)
    stats = jax.tree.map(np.array, stats)
    walk(params, stats)
    return params, stats


def _pair(n, seed, hw=CROP):
    rng = np.random.default_rng(seed)
    a, b = (rng.standard_normal((n, hw, hw, 3)).astype(np.float32) for _ in range(2))
    label = rng.integers(0, 2, (n, hw, hw)).astype(np.int32)
    label[:, :3] = 255
    return {"image_a": a, "image_b": b, "label": label}


# -------------------------------------------------------------- upsample --

@pytest.mark.parametrize("hw,size", [((3, 5), (6, 10)), ((3, 5), (7, 11)),
                                     ((2, 3), (6, 9)), ((4, 4), (4, 4))])
def test_upsample_nearest_matches_jax(hw, size):
    x = np.random.default_rng(0).standard_normal((2,) + hw + (3,)).astype(np.float32)
    np.testing.assert_array_equal(upsample_nearest(_t(x), size).numpy(),
                                  np.asarray(jax_upsample_nearest(jnp.asarray(x), size)))


# ------------------------------------------------------------------ head --

UNET_FEATS = {  # the ViT's four stride-16 maps, and a pyramid (InternImage)
    "equal": [(4, 4, 24)] * 4,
    "pyramid": [(16, 16, 8), (8, 8, 16), (4, 4, 32), (2, 2, 64)],
}


@pytest.mark.parametrize("kind", sorted(UNET_FEATS))
def test_unet_head_matches_jax(kind):
    """Eval mode (running statistics) and train mode (batch statistics, the
    running ones updated), and the port's names as `convert_unet_head`
    reads them back to JAX's tree."""
    rng = np.random.default_rng(1)
    feats = [rng.standard_normal((2,) + s).astype(np.float32) for s in UNET_FEATS[kind]]
    jfeats = [jnp.asarray(f) for f in feats]
    jm = JaxUNetHead(3)
    v = jax.jit(lambda k: jm.init(k, jfeats, train=False))(jax.random.PRNGKey(0))
    params, stats = _randomise(v["params"], v["batch_stats"], rng)
    port = UNetHead([s[-1] for s in UNET_FEATS[kind]], 3)
    port.load_state_dict(unet_from_jax(params, stats))
    back_p, back_s = convert_unet_head({k: v.numpy() for k, v in port.state_dict().items()},
                                       prefix="")
    for a, b in zip(jax.tree.leaves((back_p, back_s)), jax.tree.leaves((params, stats))):
        np.testing.assert_array_equal(a, b)
    variables = {"params": params, "batch_stats": stats}
    want = jm.apply(variables, jfeats, train=False)
    with torch.no_grad():
        got = port([_t(f) for f in feats], train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    want, upd = jm.apply(variables, jfeats, train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = port([_t(f) for f in feats], train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    new = unet_from_jax(params, upd["batch_stats"])
    for name, buf in port.state_dict().items():
        if "running_" in name:
            np.testing.assert_allclose(buf.numpy(), new[name].numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=name)


def test_unet_init_draws_as_jax():
    """Convolutions lecun-normal (flax's default: variance 1/fan_in, a unit
    normal truncated at ±2), no conv bias but `conv_seg`'s (zero), unit
    BatchNorm scales."""
    widths = [64, 64, 64, 64]
    port = init_weights(UNetHead(widths, 2), torch.Generator().manual_seed(0))
    feats = [jnp.zeros((1, 2, 2, c)) for c in widths]
    params = JaxUNetHead(2).init(jax.random.PRNGKey(0), feats)["params"]
    for i in range(4):
        for c in ("conv1", "conv2"):
            w = getattr(port.blocks[i], c)[0].weight.detach().numpy()
            ref = np.asarray(params[f"block_{i}"][c]["conv"]["kernel"])
            assert w.size == ref.size and getattr(port.blocks[i], c)[0].bias is None
            fan_in = w[0].size
            for a in (w, ref):
                assert np.abs(a).max() <= 2 / np.sqrt(fan_in) / 0.8796 + 1e-7
            np.testing.assert_allclose(w.std(), ref.std(), rtol=0.05)
            np.testing.assert_allclose(w.std(), np.sqrt(1 / fan_in), rtol=0.05)
            assert (getattr(port.blocks[i], c)[1].weight == 1).all()
    assert not port.conv_seg.bias.any()


# -------------------------------------------------------------- detector --

def _jax_detector(family, fusion, seed=0):
    jcfg, _ = FAMILIES[family]
    model = jcd.SiamChangeDetector(jcfg, 2, fusion)
    zeros = jnp.zeros((1, CROP, CROP, 3))
    with jax_backbone(family):
        v = jax.jit(lambda k: model.init(k, zeros, zeros, train=True))(jax.random.PRNGKey(seed))
    params, stats = _randomise(v["params"], v["batch_stats"], np.random.default_rng(seed))
    return model, {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("fusion", ["abs_diff", "sum", "concat"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_detector_and_predict_match_jax(family, fusion):
    """Eval-mode change logits (2H×2W on the ViT's maps, H×W on
    InternImage's) and `predict`'s logits at the input size."""
    _, pcfg = FAMILIES[family]
    model, variables = _jax_detector(family, fusion)
    p = _pair(2, 3)
    a, b = jnp.asarray(p["image_a"]), jnp.asarray(p["image_b"])
    with jax_backbone(family):
        want = jax.jit(lambda v, a, b: model.apply(v, a, b))(variables, a, b)
        want_pred = jax.jit(lambda v, a, b: model.apply(v, a, b, method="predict"))(
            variables, a, b)
    port = SiamChangeDetector(pcfg, 2, fusion)
    port.load_state_dict(change_detector_from_jax(variables, pcfg))
    with torch.no_grad():
        got = port(_t(p["image_a"]), _t(p["image_b"]))
        got_pred = port.predict(_t(p["image_a"]), _t(p["image_b"]))
    side = 2 * CROP if family == "vit" else CROP
    assert got.shape == (2, side, side, 2) and got_pred.shape == (2, CROP, CROP, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_pred.numpy(), np.asarray(want_pred), atol=ATOL,
                               rtol=RTOL)


def test_vit_features_only_has_no_fpn():
    """A ViT built `features_only` has no FPN modules, so its state dict is
    JAX's `features_only` tree and the optimizer holds no parameter JAX has
    not got."""
    assert not [n for n, _ in ViTRVSA(VIT, features_only=True).named_parameters()
                if "fpn" in n]
    assert [n for n, _ in ViTRVSA(VIT).named_parameters() if n.startswith("fpn")]
    model = SiamChangeDetector(VIT)
    assert not [n for n in model.state_dict() if "fpn" in n]
    _, variables = _jax_detector("vit", "abs_diff")
    assert "fpn" not in variables["params"]["backbone"]
    assert set(change_detector_from_jax(variables, VIT)) == set(model.state_dict())
    with pytest.raises(ValueError, match="fusion"):
        SiamChangeDetector(VIT, fusion="max")


# ------------------------------------------------------------ train step --

def _task_cfg(family, crop=CROP):
    jcfg, _ = FAMILIES[family]
    return TaskConfig(task="change_detection", num_classes=2,
                      backbone=dataclasses.replace(jcfg, img_size=crop),
                      train=TrainConfig(batch_size=2, mesh=MeshConfig(data=1),
                                        optimizer=OPT, schedule=SCHED))


# The train step's crop.  The UNet's last block runs at twice the input on
# the ViT's stride-16 maps (H on InternImage's pyramid): at a 64² crop the
# ViT's holds 786k ReLU inputs, of which a few lie within fp32 rounding of
# 0 and fall on the other side in the port than in JAX (4 of them against
# a float64 run of the port), each carrying its whole gradient across: the
# gradient norm moved by 8.6e-5.  At 32² the block is InternImage's size.
STEP_CROP = {"vit": 32, "internimage": CROP}


@pytest.fixture(scope="module", params=[(f, z) for f in sorted(FAMILIES)
                                        for z in (False, True)],
                ids=lambda p: f"{p[0]}-{'frozen' if p[1] else 'all'}")
def jax_step(request):
    """One step of the JAX task's train step with `deterministic=True`, on a
    one-device mesh, from the JAX task's `init_state` (frozen or not) with
    random BatchNorm statistics and DCNv3 regressors."""
    family, frozen = request.param
    with jax_backbone(family):
        task = JaxCDTask(_task_cfg(family, STEP_CROP[family]),
                         mesh=make_mesh(MeshConfig(data=1)))
        state = task.init_state(jax.random.PRNGKey(0), frozen_backbone=frozen)
        params, stats = _randomise(state.params, state.batch_stats,
                                   np.random.default_rng(4))
        state = state.replace(params=jax.tree.map(jnp.asarray, params),
                              batch_stats=jax.tree.map(jnp.asarray, stats))
        model = task.model

        def loss_fn(p, bs, batch, rng):
            out, updates = model.apply(
                {"params": p, "batch_stats": bs}, batch["image_a"], batch["image_b"],
                train=True, deterministic=True, mutable=["batch_stats"])
            labels = batch["label"]
            logits = jax_resize(out, labels.shape[1:3])
            return jax_seg_xent(logits, labels, 255), ({}, updates["batch_stats"])

        step = jax_make_train_step(loss_fn, task._tx, task.mesh, donate=False)
        new, metrics = step(state, jax.tree.map(jnp.asarray,
                                                _pair(3, 5, STEP_CROP[family])))
    return family, frozen, {"params": params, "batch_stats": stats}, \
        jax.tree.map(np.asarray, {"params": new.params, "batch_stats": new.batch_stats}), \
        {k: float(v) for k, v in metrics.items()}


def test_train_step_matches_jax(jax_step):
    """Loss and grad norm to 1e-5, the BatchNorm running statistics, and
    every parameter to 2·lr·scale; with `frozen_backbone` the backbone stays
    the same bit for bit and the head still learns."""
    family, frozen, before, after, ref = jax_step
    cfg = _task_cfg(family, STEP_CROP[family])
    pcfg = cfg.backbone if family == "vit" else PORT_XL
    task = ChangeDetectionTask(cfg, model=SiamChangeDetector(pcfg), device="cpu")
    state = task.init_state(torch.Generator().manual_seed(0), frozen_backbone=frozen)
    start = change_detector_from_jax(before, pcfg)
    state.model.load_state_dict(start)
    state, metrics = task.train_step_fn(deterministic=True)(
        state, {k: _t(v) for k, v in _pair(3, 5, STEP_CROP[family]).items()})
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), ref[k], rtol=1e-5, err_msg=k)
    lr = popt.make_schedule(SCHED, OPT.lr)(0)
    scales = {state.optimizer.names[p]: g["lr_scale"]
              for g in state.optimizer.adamw.param_groups for p in g["params"]}
    want = change_detector_from_jax(after, pcfg)
    got = state.model.state_dict()
    for name in want:
        if "running_" in name:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=name)
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=2 * lr * scales[name] + 1e-7, rtol=0,
                                   err_msg=name)
        if frozen and name.startswith("backbone."):
            assert torch.equal(p.detach(), start[name]), name
        elif p.dim() > 1:
            assert not torch.equal(p.detach(), start[name]), name


# ------------------------------------------------------------ evaluation --

def test_evaluate_matches_jax():
    """`evaluate`'s mIoU family and F1_change against the JAX task's, same
    weights.  Where a pixel's two logits lie within rounding of each other
    the two argmaxes may differ: each such pixel moves the metrics by
    ~0.01 (%)."""
    data = [_pair(2, 6), _pair(1, 7)]
    cfg = _task_cfg("vit")
    jtask = JaxCDTask(cfg, mesh=make_mesh(MeshConfig(data=1)))
    jstate = jtask.init_state(jax.random.PRNGKey(2))
    rng = np.random.default_rng(8)
    params, stats = _randomise(jstate.params, jstate.batch_stats, rng)
    seg = params["decode_head"]["conv_seg"]  # both classes predicted
    seg["kernel"] = rng.standard_normal(seg["kernel"].shape).astype(np.float32)
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, params),
                            batch_stats=jax.tree.map(jnp.asarray, stats))
    want = jtask.evaluate(jstate, iter(data))
    task = ChangeDetectionTask(cfg, model=SiamChangeDetector(VIT), device="cpu")
    state = task.init_state(torch.Generator().manual_seed(0))
    state.model.load_state_dict(change_detector_from_jax(
        {"params": params, "batch_stats": stats}, VIT))
    got = task.evaluate(state, iter(data))
    assert got.keys() == want.keys() and 0 < want["F1_change"] < 100
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=0.05, err_msg=k)
    pred = task.predict_fn()(_t(data[0]["image_a"]), _t(data[0]["image_b"]))
    assert pred.shape == (2, CROP, CROP) and pred.dtype == torch.int64


def test_binary_change_f1_matches_jax():
    """The change class's F1 from intersect / prediction / label areas, and
    the same number as the accumulator's Fscore[1]; 0 where nothing is
    predicted or labelled changed."""
    rng = np.random.default_rng(9)
    pred, label = rng.integers(0, 2, (2, 17, 19)), rng.integers(0, 2, (2, 17, 19))
    label[:, 0] = 255
    acc = SegAccumulator(2)
    acc.add(pred, label)
    got = binary_change_f1(acc.i, acc.p, acc.l)
    assert got == pytest.approx(jax_binary_change_f1(acc.i, acc.p, acc.l), rel=1e-12)
    assert got == pytest.approx(acc.evaluate()["Fscore"][1], rel=1e-12)
    zeros = np.zeros(2)
    assert binary_change_f1(zeros, zeros, zeros) == 0.0 == \
        jax_binary_change_f1(zeros, zeros, zeros)


# -------------------------------------------------------------- launches --

def _stub_launches(monkeypatch):
    from mtp_tpu_torch.kernels import _build
    from mtp_tpu_torch.ops import dcnv3_sample as dcn
    from mtp_tpu_torch.ops import fused_attn

    monkeypatch.setattr(_build, "use_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "launch", lambda name, *a: None)
    monkeypatch.setattr(fused_attn, "LAUNCHES", dict.fromkeys(fused_attn.LAUNCHES, 0))
    monkeypatch.setattr(dcn, "LAUNCHES", dict.fromkeys(dcn.LAUNCHES, 0))
    return lambda: {k: n for k, n in {**fused_attn.LAUNCHES, **dcn.LAUNCHES}.items() if n}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_one_backbone_pass_per_pair(monkeypatch, family):
    """With the kernel route forced and each launch stubbed out, a forward
    of 2 pairs launches each kernel as one backbone forward over the 4
    stacked images does (ViT: K1 per RVSA block, K2 per full block, K3
    twice per RVSA block; InternImage: K3 per layer), not twice that; a
    train step adds the backward kernels once."""
    launched = _stub_launches(monkeypatch)
    jcfg, pcfg = FAMILIES[family]
    if family == "vit":
        n_full = VIT.depth // VIT.interval
        n_rvsa = VIT.depth - n_full
        fwd = {"window": n_rvsa, "flash": n_full, "bilinear_sample": 2 * n_rvsa}
        step = dict(fwd, window_bwd=n_rvsa, flash_bwd=n_full,
                    bilinear_sample_bwd=2 * n_rvsa)
    else:
        n = sum(PORT_XL.depths)
        fwd = {"bilinear_sample": n}
        step = dict(fwd, bilinear_sample_bwd=n)
    model = SiamChangeDetector(pcfg)
    p = {k: _t(v) for k, v in _pair(2, 9).items()}
    with torch.no_grad():
        model(p["image_a"], p["image_b"])
    assert launched() == fwd
    task = ChangeDetectionTask(pc.TaskConfig(task="change_detection", num_classes=2,
                                             backbone=jcfg),
                               model=model, device="cpu")
    state = task.init_state(torch.Generator().manual_seed(0))
    _stub_launches(monkeypatch)
    task.train_step_fn()(state, p)
    assert launched() == step
