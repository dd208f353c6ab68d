"""The port's scene classification against the JAX package's: the linear
head, the classifier on the ViT and on InternImage-T (small widths), one
train step of `ClassificationTask` against JAX `ClassificationTask`'s (drop
rates 0), top-k accuracy and `evaluate`, the head's random init, and the
kernel launches of a forward and a train step (stubbed launches).

JAX weights are carried to the port by `ckpt.from_jax.classifier_from_jax`;
fp32 on both sides; inputs made with numpy from a seed.  The JAX modules
build InternImage-XL or -T at full size from a config name, so the small
InternImage is put in place of JAX's `build_backbone` for the JAX side."""

import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.eval.metrics import topk_accuracy as jax_topk
from mtp_tpu.heads.linear_cls import LinearClsHead as JaxLinearClsHead
from mtp_tpu.models import classifier as jcls
from mtp_tpu.models import internimage as ji
from mtp_tpu.models.backbones import internimage_backbone_config
from mtp_tpu.parallel.mesh import make_mesh
from mtp_tpu.tasks.classification import ClassificationTask as JaxClassificationTask
from mtp_tpu.utils.config import (BackboneConfig, MeshConfig, OptimizerConfig,
                                  ScheduleConfig, TaskConfig, TrainConfig)
from mtp_tpu_torch import config as pc
from mtp_tpu_torch.ckpt.from_jax import (classifier_from_jax, init_weights,
                                         linear_head_from_jax)
from mtp_tpu_torch.core import optim as popt
from mtp_tpu_torch.eval.metrics import topk_accuracy
from mtp_tpu_torch.heads.linear_cls import LinearClsHead
from mtp_tpu_torch.models.classifier import ImageClassifier
from mtp_tpu_torch.tasks.classification import ClassificationTask

torch.set_num_threads(1)

ATOL, RTOL = 1e-4, 1e-4  # logits, fp32 both sides
K, CROP = 10, 64
VIT = BackboneConfig(img_size=CROP, embed_dim=32, depth=4, num_heads=2, interval=2,
                     out_indices=(0, 1, 2, 3), dtype="float32", drop_path_rate=0.0)
# InternImage-T's layer (pre-norm, no layer scale, offset_scale 1) at small
# widths; the task's config is the T shell, whose name sets the layer ids
TINY_T = dataclasses.replace(ji.internimage_t(), channels=16, depths=(1, 1, 2, 1),
                             groups=(2, 4, 8, 16), dtype="float32",
                             drop_path_rate=0.0)
PORT_T = pc.InternImageConfig(**dataclasses.asdict(TINY_T))
T_SHELL = internimage_backbone_config("internimage_t", CROP, dtype="float32",
                                      drop_path_rate=0.0)
OPT = OptimizerConfig(lr=1e-3, weight_decay=0.05, layer_decay=0.9, clip_norm=0.0)
SCHED = ScheduleConfig(kind="cosine", total_steps=10, warmup_steps=2,
                       warmup_ratio=0.1)
FAMILIES = {"vit": (VIT, VIT), "internimage_t": (T_SHELL, PORT_T)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def jax_backbone(family):
    """The JAX modules' `build_backbone` for this family: as it is for the
    ViT, the small InternImage-T for InternImage."""
    if family == "vit":
        return contextlib.nullcontext()
    return mock.patch.object(jcls, "build_backbone",
                             lambda cfg, name="backbone": ji.InternImage(TINY_T, name=name))


def _jitter(tree, rng):
    """Random DCNv3 offset and mask regressors (zero at init): sampling off
    the integer grid, masks not uniform."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k in ("offset", "mask"):
            std = (0.5 if k == "offset" else 1.0) / np.sqrt(v["kernel"].shape[0])
            out[k] = {n: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * std)
                      for n, a in v.items()}
        else:
            out[k] = _jitter(v, rng)
    return out


def _images(n, seed):
    return np.random.default_rng(seed).standard_normal((n, CROP, CROP, 3)).astype(np.float32)


# ------------------------------------------------------------------ head --

def test_linear_head_matches_jax():
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((3, 5, 7, 24)).astype(np.float32)
    jm = JaxLinearClsHead(K)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(feat))["params"]
    params = jax.tree.map(lambda a: a + 0.1, params)  # a non-zero bias
    port = LinearClsHead(24, K)
    port.load_state_dict(linear_head_from_jax(params))
    np.testing.assert_allclose(port(_t(feat)).detach().numpy(),
                               np.asarray(jm.apply({"params": params}, jnp.asarray(feat))),
                               atol=1e-6, rtol=1e-6)


def test_linear_head_runs_fc_in_fp32_under_autocast():
    port = LinearClsHead(24, K)
    feat = torch.randn(2, 3, 3, 24, generator=torch.Generator().manual_seed(0))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = port(feat.bfloat16())
    assert out.dtype == torch.float32
    want = port(feat.bfloat16().mean((1, 2)).float()[:, None, None])
    assert torch.equal(out, want)


def test_linear_head_init_draws_as_jax():
    """`init_weights` draws `fc` as flax's truncated_normal(0.02) does: a
    unit normal truncated at ±2 scaled by 0.02 (std 0.0176), bias 0."""
    port = init_weights(LinearClsHead(512, 1000), torch.Generator().manual_seed(0))
    w = port.fc.weight.detach().numpy().ravel()
    params = JaxLinearClsHead(1000).init(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 1, 1, 512)))["params"]
    ref = np.asarray(params["fc"]["kernel"]).ravel()
    assert np.abs(w).max() <= 0.04 and np.abs(ref).max() <= 0.04
    np.testing.assert_allclose(w.std(), ref.std(), rtol=5e-3)
    np.testing.assert_allclose(np.quantile(np.abs(w), [0.5, 0.9, 0.99]),
                               np.quantile(np.abs(ref), [0.5, 0.9, 0.99]), rtol=1e-2)
    assert abs(w.mean()) < 1e-4 and not port.fc.bias.any()


# ------------------------------------------------------------ classifier --

@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    return request.param


def _jax_classifier_params(family, seed=0):
    jcfg, _ = FAMILIES[family]
    with jax_backbone(family):
        model = jcls.ImageClassifier(jcfg, K)
        params = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                     jnp.zeros((1, CROP, CROP, 3)))["params"]
    params = _jitter(jax.tree.map(np.asarray, params), np.random.default_rng(seed))
    return model, {"params": params}


def test_classifier_logits_match_jax(family):
    jcfg, pcfg = FAMILIES[family]
    model, variables = _jax_classifier_params(family)
    x = _images(2, 1)
    with jax_backbone(family):
        want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    port = ImageClassifier(pcfg, K).eval()
    port.load_state_dict(classifier_from_jax(variables, pcfg))
    with torch.no_grad():
        got = port(_t(x))
    assert got.dtype == torch.float32 and got.shape == (2, K)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------ train step --

def _task_cfg(family):
    jcfg, _ = FAMILIES[family]
    return TaskConfig(task="classification", num_classes=K, backbone=jcfg,
                      train=TrainConfig(batch_size=3, mesh=MeshConfig(data=1),
                                        optimizer=OPT, schedule=SCHED))


def _batch(n, seed):
    return {"image": _images(n, seed),
            "label": np.random.default_rng(seed + 1).integers(0, K, (n,)).astype(np.int32)}


@pytest.fixture(scope="module")
def jax_step(family):
    """One step of JAX `ClassificationTask.train_step_fn` on a one-device
    mesh (drop rates 0), from jittered initial parameters."""
    cfg = _task_cfg(family)
    with jax_backbone(family):
        task = JaxClassificationTask(cfg, mesh=make_mesh(MeshConfig(data=1)))
        state = task.init_state(jax.random.PRNGKey(0))
        params = _jitter(jax.tree.map(np.asarray, state.params), np.random.default_rng(0))
        state = state.replace(params=jax.tree.map(jnp.asarray, params))
        before = jax.tree.map(np.asarray, state.params)
        new, metrics = task.train_step_fn()(state, jax.tree.map(jnp.asarray, _batch(3, 2)))
        after = jax.tree.map(np.asarray, new.params)
    return before, after, {k: float(v) for k, v in metrics.items()}


def test_train_step_matches_jax(family, jax_step):
    """Loss, accuracy and grad norm to 1e-5, and every updated parameter to
    2·lr·scale (Adam's first step moves a parameter whose gradient is at
    rounding level by ±lr·scale), the ViT's unused FPN levels included:
    optax decays them and the port updates them from zero gradients."""
    before, after, ref = jax_step
    _, pcfg = FAMILIES[family]
    cfg = _task_cfg(family)
    task = ClassificationTask(cfg, model=ImageClassifier(pcfg, K), device="cpu")
    state = task.init_state(torch.Generator().manual_seed(0))
    state.model.load_state_dict(classifier_from_jax({"params": before}, pcfg))
    state, metrics = task.train_step_fn(deterministic=True)(
        state, {k: _t(v) for k, v in _batch(3, 2).items()})
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), ref[k], rtol=1e-5, err_msg=k)
    assert float(metrics["acc"]) == pytest.approx(ref["acc"])
    lr = popt.make_schedule(SCHED, OPT.lr)(0)
    scales = {state.optimizer.names[p]: g["lr_scale"]
              for g in state.optimizer.adamw.param_groups for p in g["params"]}
    want = classifier_from_jax({"params": after}, pcfg)
    start = classifier_from_jax({"params": before}, pcfg)
    unused = 0
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=2 * lr * scales[name] + 1e-7, rtol=0,
                                   err_msg=name)
        if name.startswith("backbone.fpn"):
            # no gradient reaches them: the update is weight decay alone,
            # -lr·scale·wd·p (0 for the LayerNorm's 1-dim parameters)
            unused += 1
            got, ref = p.detach() - start[name], want[name] - start[name]
            ulps = 4 * np.finfo(np.float32).eps * float(start[name].abs().max())
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                                       atol=ulps, err_msg=name)
            assert bool(ref.any()) == (p.dim() > 1), name
    assert unused == (8 if family == "vit" else 0)


# ------------------------------------------------------------ evaluation --

def test_topk_accuracy_matches_jax():
    """Random float logits have no ties, where the two orders could differ."""
    rng = np.random.default_rng(3)
    for n, k in ((7, 10), (5, 3)):
        logits = rng.standard_normal((n, k)).astype(np.float32)
        labels = rng.integers(0, k, (n,))
        got = topk_accuracy(_t(logits), _t(labels))
        want = jax_topk(jnp.asarray(logits), jnp.asarray(labels))
        assert got.keys() == want.keys() == {"top1", "top5"}
        for key in got:
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-6)


def test_evaluate_matches_jax(family):
    """top1 and top5 over batches of 3 and 2 images (weighted by size)."""
    cfg = _task_cfg(family)
    _, pcfg = FAMILIES[family]
    data = [_batch(3, 5), _batch(2, 7)]
    with jax_backbone(family):
        jtask = JaxClassificationTask(cfg, mesh=make_mesh(MeshConfig(data=1)))
        jstate = jtask.init_state(jax.random.PRNGKey(1))
        want = jtask.evaluate(jstate, iter(data))
        params = jax.tree.map(np.asarray, jstate.params)
    task = ClassificationTask(cfg, model=ImageClassifier(pcfg, K), device="cpu")
    state = task.init_state(torch.Generator().manual_seed(0))
    state.model.load_state_dict(classifier_from_jax({"params": params}, pcfg))
    got = task.evaluate(state, iter(data))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


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


@pytest.mark.parametrize("kind", ["vit", "internimage_remat"])
def test_kernel_launches_per_forward_and_step(monkeypatch, kind):
    """With the kernel route forced and each launch stubbed out: the ViT
    classifier launches K1 per RVSA block, K2 per full block and K3 twice
    per RVSA block a forward, plus K4, K5 and K6 likewise a step;
    InternImage with remat K3 once per layer a forward, twice a step (the
    recompute), and K6 once per layer."""
    launched = _stub_launches(monkeypatch)
    if kind == "vit":
        backbone, pcfg = VIT, dataclasses.replace(VIT, drop_path_rate=0.2)
        n_full = VIT.depth // VIT.interval
        n_rvsa = VIT.depth - n_full
        fwd = {"window": n_rvsa, "flash": n_full, "bilinear_sample": 2 * n_rvsa}
        step = dict(fwd, window_bwd=n_rvsa, flash_bwd=n_full,
                    bilinear_sample_bwd=2 * n_rvsa)
    else:
        backbone = T_SHELL
        pcfg = dataclasses.replace(PORT_T, remat=True, drop_path_rate=0.2)
        n = sum(PORT_T.depths)
        fwd = {"bilinear_sample": n}
        step = {"bilinear_sample": 2 * n, "bilinear_sample_bwd": n}
    model = ImageClassifier(pcfg, K)
    with torch.no_grad():
        model(torch.zeros(2, CROP, CROP, 3))
    assert launched() == fwd
    cfg = pc.TaskConfig(task="classification", num_classes=K, backbone=backbone)
    task = ClassificationTask(cfg, model=model, device="cpu")
    state = task.init_state(torch.Generator().manual_seed(0))
    _stub_launches(monkeypatch)
    task.train_step_fn()(state, {"image": torch.zeros(2, CROP, CROP, 3),
                                 "label": torch.zeros(2, dtype=torch.long)})
    assert launched() == step
