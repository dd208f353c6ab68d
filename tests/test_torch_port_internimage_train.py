"""The port's InternImage train step against the JAX package's: one
`train_step_fn` step and a second one from the converted optax state
against JAX `make_train_step`, with the InternImage layer-decay map; and the
task's default device.

A small InternImage (channels 16, depths (1, 1, 2, 1), post-norm, layer
scale) → UperNet, composed on the JAX side as `mtp_tpu.models.segmentor`
composes it.  The layer-decay ids follow the recipe's backbone name
(`internimage_xl`: XL's stage depths, depth 39, on both sides), as the JAX
package maps them.  fp32 on both sides, the deterministic loss (drop-path
and dropout off), train-mode BatchNorm, inputs made with numpy from a seed;
the offset and mask regressors are random, so that the sampling points are
off the integer grid, where the JAX default DCNv3 core and the port agree on
the offset gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from mtp_tpu.core import optim as jopt
from mtp_tpu.core.train import create_state as jax_create_state
from mtp_tpu.core.train import make_train_step as jax_make_train_step
from mtp_tpu.core.train import seg_xent as jax_seg_xent
from mtp_tpu.heads.upernet import UperNetHead as JaxUperNetHead
from mtp_tpu.heads.upernet import resize_bilinear as jax_resize
from mtp_tpu.models import internimage as ji
from mtp_tpu.models.backbones import layer_id_fn_for as jax_layer_id_fn_for
from mtp_tpu_torch import config as pc
from mtp_tpu_torch.ckpt.from_jax import (opt_state_from_jax, params_from_jax,
                                         segmentor_from_jax)
from mtp_tpu_torch.core import optim as popt
from mtp_tpu_torch.models.segmentor import Segmentor
from mtp_tpu_torch.tasks.segmentation import SegmentationTask

torch.set_num_threads(1)

JAX_TINY = dataclasses.replace(ji.internimage_xl(), channels=16, depths=(1, 1, 2, 1),
                               groups=(2, 4, 8, 16), layer_scale=0.5,
                               dtype="float32", drop_path_rate=0.0)
TINY = pc.InternImageConfig(**dataclasses.asdict(JAX_TINY))
# batch 3: at batch 2 the PSP pool-1 branch's train-mode BatchNorm sees two
# values per channel, and after one update its gradients are
# ill-conditioned enough to spread fp32 rounding to 1e-3 of several
# gradients
K, CROP, BATCH, CHANNELS = 3, 64, 3, 16
SHELL = pc.internimage_backbone_config("internimage_xl", CROP, dtype="float32")
OPT = pc.OptimizerConfig(lr=1e-3, weight_decay=0.05, layer_decay=0.94,
                         clip_norm=0.0)
SCHED = pc.ScheduleConfig(kind="cosine", total_steps=10, warmup_steps=2,
                          warmup_ratio=0.1)


class JaxSegmentor(fnn.Module):
    cfg: ji.InternImageConfig
    num_classes: int
    channels: int

    @fnn.compact
    def __call__(self, x, train=False, deterministic=True):
        feats = ji.InternImage(self.cfg, name="backbone")(x, deterministic)
        return JaxUperNetHead(self.num_classes, channels=self.channels,
                              name="decode_head")(feats, train, deterministic)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jitter(tree, rng):
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


def _batch(seed):
    rng = np.random.default_rng(seed)
    image = rng.standard_normal((BATCH, CROP, CROP, 3)).astype(np.float32)
    label = rng.integers(0, K, (BATCH, CROP, CROP)).astype(np.int32)
    label[:, :5] = 255
    return {"image": image, "label": label}


@pytest.fixture(scope="module")
def jax_two_steps():
    """Two JAX `make_train_step` steps with the recipe's optimizer shape
    (layer decay 0.94 over the InternImage ids), and each step's gradients."""
    model = JaxSegmentor(JAX_TINY, K, CHANNELS)
    variables = jax.jit(lambda k: model.init(k, jnp.zeros((1, CROP, CROP, 3))))(
        jax.random.PRNGKey(0))
    params = _jitter(variables["params"], np.random.default_rng(1))
    stats = variables["batch_stats"]
    layer_id = jax_layer_id_fn_for(SHELL, root="backbone/")
    tx = jopt.make_optimizer(OPT, jopt.make_schedule(SCHED, OPT.lr), params,
                             SHELL.depth, layer_id)

    def loss_fn(p, bs, batch, rng):
        out, upd = model.apply({"params": p, "batch_stats": bs}, batch["image"],
                               train=True, deterministic=True,
                               mutable=["batch_stats"])
        logits = jax_resize(out, batch["label"].shape[1:3])
        return jax_seg_xent(logits, batch["label"]), ({}, upd["batch_stats"])

    step = jax_make_train_step(loss_fn, tx, donate=False)
    grad = jax.jit(jax.grad(lambda p, bs, b: loss_fn(p, bs, b, None)[0]))
    state = jax_create_state(params, tx, jax.random.PRNGKey(1), batch_stats=stats)
    out = []
    for seed in (1, 2):
        batch = jax.tree.map(jnp.asarray, _batch(seed))
        g = grad(state.params, state.batch_stats, batch)
        new, metrics = step(state, batch)
        out.append(dict(before=state, grads=g, after=new,
                        metrics={k: float(v) for k, v in metrics.items()}))
        state = new
    return out


def _task():
    cfg = pc.TaskConfig(task="segmentation", num_classes=K, backbone=SHELL,
                        train=pc.TrainConfig(batch_size=BATCH, optimizer=OPT,
                                             schedule=SCHED))
    return SegmentationTask(cfg, model=Segmentor(TINY, K, channels=CHANNELS),
                            device="cpu")


def _load(state, ref_state):
    state.model.load_state_dict(segmentor_from_jax(
        {"params": ref_state.params, "batch_stats": ref_state.batch_stats}, TINY))


def _check_step(port_state, metrics, ref, lr):
    """Loss and grad norm to 1e-5; every gradient g to ‖Δg‖ ≤ 1e-4·‖g‖ +
    1e-6·‖g_all‖ (fp32 sums in other orders; the floor is for the conv
    biases right before train-mode BatchNorm, whose gradient is 0 in exact
    arithmetic); the BatchNorm running statistics; each parameter to
    2·lr·scale (where |g| is at noise level, Adam's first step is ±lr·scale
    either way)."""
    np.testing.assert_allclose(float(metrics["loss"]), ref["metrics"]["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               ref["metrics"]["grad_norm"], rtol=1e-5)
    after = ref["after"]
    grads = params_from_jax(jax.tree.map(np.asarray, ref["grads"]),
                            after.batch_stats, TINY)
    g_all = float(torch.sqrt(sum((g ** 2).sum() for g in grads.values())))
    model = port_state.model
    for name, p in model.named_parameters():
        diff = float((p.grad - grads[name]).norm())
        assert diff <= 1e-4 * float(grads[name].norm()) + 1e-6 * g_all, name
    want = segmentor_from_jax({"params": after.params,
                               "batch_stats": after.batch_stats}, TINY)
    got = model.state_dict()
    for name in want:
        if "running_" in name:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=name)
    scales = {port_state.optimizer.names[p]: g["lr_scale"]
              for g in port_state.optimizer.adamw.param_groups for p in g["params"]}
    assert scales["backbone.levels.3.blocks.0.dcn.offset.weight"] == \
        pytest.approx(0.94 ** (41 - 35 - 1))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=2 * lr * scales[name] + 1e-7, rtol=0,
                                   err_msg=name)


def test_train_step_matches_jax(jax_two_steps):
    ref = jax_two_steps[0]
    task = _task()
    state = task.init_state(torch.Generator().manual_seed(0))
    _load(state, ref["before"])
    state, metrics = task.train_step_fn(deterministic=True)(
        state, {k: _t(v) for k, v in _batch(1).items()})
    assert state.step == 1 and state.optimizer.count == 1
    _check_step(state, metrics, ref, popt.make_schedule(SCHED, OPT.lr)(0))


def test_second_step_from_converted_optax_state(jax_two_steps):
    ref = jax_two_steps[1]
    task = _task()
    state = task.init_state(torch.Generator().manual_seed(0))
    before = ref["before"]
    _load(state, before)
    state.optimizer.load_moments(*opt_state_from_jax(
        before.opt_state, before.batch_stats, TINY))
    state, metrics = task.train_step_fn(deterministic=True)(
        state, {k: _t(v) for k, v in _batch(2).items()})
    assert state.optimizer.count == 2
    _check_step(state, metrics, ref, popt.make_schedule(SCHED, OPT.lr)(1))


def test_task_defaults_to_the_card():
    """`SegmentationTask` runs on the card unless the caller asks for the
    CPU (the attribute only: nothing is moved, no card is needed)."""
    from mtp_tpu_torch import configs

    cfg = configs.get("intern-xl-upernet-512-imp-mtp-loveda").task
    model = torch.nn.Linear(1, 1)  # the task only holds it here
    assert SegmentationTask(cfg, model=model).device == torch.device("cuda")
    assert SegmentationTask(cfg, model=model, device="cpu").device.type == "cpu"
