"""The port's training path against the JAX package's: flax-semantics
BatchNorm, the schedules, layer decay and weight-decay mask, the AdamW
update, one full train step and a second one from the converted optax state,
the losses and the mIoU accumulator; then the port's own train-mode
machinery (dropout and drop-path rates, fit/evaluate, remat, one device).

Both sides run fp32 on the same numpy inputs; JAX parameters and optax
states are carried to the port by `ckpt.from_jax` (`segmentor_from_jax`,
`params_from_jax`, `opt_state_from_jax`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mtp_tpu.core import optim as jopt
from mtp_tpu.core.train import create_state as jax_create_state
from mtp_tpu.core.train import make_train_step as jax_make_train_step
from mtp_tpu.core.train import seg_xent as jax_seg_xent
from mtp_tpu.core.train import softmax_xent as jax_softmax_xent
from mtp_tpu.eval.metrics import SegAccumulator as JaxSegAccumulator
from mtp_tpu.eval.metrics import intersect_and_union as jax_iou
from mtp_tpu.heads.upernet import ConvModule as JaxConvModule
from mtp_tpu.heads.upernet import resize_bilinear as jax_resize
from mtp_tpu.models.backbones import layer_id_fn_for as jax_layer_id_fn_for
from mtp_tpu.models.segmentor import Segmentor as JaxSegmentor
from mtp_tpu.models.vit_rvsa import rescale_block_init
from mtp_tpu.utils.config import (BackboneConfig, MeshConfig, OptimizerConfig,
                                  ScheduleConfig, SlideConfig, TaskConfig,
                                  TrainConfig)
from mtp_tpu_torch.ckpt.from_jax import (opt_state_from_jax, params_from_jax,
                                         segmentor_from_jax)
from mtp_tpu_torch.core import optim as popt
from mtp_tpu_torch.core.train import seg_xent, softmax_xent
from mtp_tpu_torch.eval.metrics import SegAccumulator, intersect_and_union
from mtp_tpu_torch.heads.upernet import ConvModule
from mtp_tpu_torch.models.segmentor import Segmentor
from mtp_tpu_torch.models.vit_rvsa import ViTRVSA
from mtp_tpu_torch.ops.dropout import apply_drop_path, drop_path_mask, dropout
from mtp_tpu_torch.tasks.segmentation import SegmentationTask

torch.set_num_threads(1)

CFG = BackboneConfig(img_size=128, embed_dim=32, depth=4, num_heads=2,
                     interval=2, out_indices=(0, 1, 2, 3), dtype="float32")
K, CROP, BATCH, CHANNELS = 3, 64, 3, 16
OPT = OptimizerConfig(lr=1e-3, weight_decay=0.05, layer_decay=0.9, clip_norm=0.0)
SCHED = ScheduleConfig(kind="cosine", total_steps=10, warmup_steps=2,
                       warmup_ratio=0.1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------- BatchNorm --

@pytest.mark.parametrize("batch,hw", [(1, (1, 1)), (1, (5, 7)), (3, (1, 1)),
                                      (3, (5, 7))])
def test_batchnorm_train_matches_flax(batch, hw):
    """ConvModule in train mode: batch statistics with the biased variance
    for the normalisation and the running update (momentum 0.9), batch 1 on a
    1×1 map allowed.  torch's own BatchNorm2d updates the running variance
    with the unbiased variance, off by n/(n-1), and raises at one value per
    channel."""
    rng = np.random.default_rng(batch * 10 + hw[1])
    cin, cout = 6, 4
    x = rng.standard_normal((batch,) + hw + (cin,)).astype(np.float32) + 0.5
    jm = JaxConvModule(cout, kernel=1)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    bias = rng.normal(0, 0.2, cout).astype(np.float32)
    mean = rng.normal(0, 0.3, cout).astype(np.float32)
    var = rng.uniform(0.5, 2.0, cout).astype(np.float32)
    params = {"conv": v["params"]["conv"], "bn": {"scale": scale, "bias": bias}}
    stats = {"bn": {"mean": mean, "var": var}}
    ref, upd = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                        train=True, mutable=["batch_stats"])

    port = ConvModule(cin, cout, 1)
    port.load_state_dict({
        "conv.weight": _t(np.asarray(params["conv"]["kernel"]).transpose(3, 2, 0, 1)),
        "bn.weight": _t(scale), "bn.bias": _t(bias), "bn.running_mean": _t(mean),
        "bn.running_var": _t(var), "bn.num_batches_tracked": torch.tensor(0)})
    got = port(_t(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    for buf, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(port.bn, buf).numpy(),
                                   np.asarray(upd["batch_stats"]["bn"][key]),
                                   atol=1e-6, rtol=1e-5)
    # eval mode: the running statistics, untouched
    before = port.bn.running_var.clone()
    port(_t(x), train=False)
    assert torch.equal(port.bn.running_var, before)

    n = batch * hw[0] * hw[1]
    plain = torch.nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1)
    plain.load_state_dict({k: v for k, v in port.bn.state_dict().items()})
    plain.running_var.copy_(_t(var))
    plain.running_mean.copy_(_t(mean))
    y = port.conv(_t(x).permute(0, 3, 1, 2)).detach()
    if n == 1:
        with pytest.raises(ValueError):
            plain.train()(y)
    else:
        plain.train()(y)
        assert not np.allclose(plain.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["bn"]["var"]),
                               rtol=1e-4)


# ------------------------------------------------------------- optimizer --

@pytest.mark.parametrize("cfg", [
    ScheduleConfig(kind="cosine", total_steps=50, warmup_steps=10,
                   min_lr_ratio=0.1),
    ScheduleConfig(kind="cosine", total_steps=40),
    ScheduleConfig(kind="poly", total_steps=50, warmup_steps=5, poly_power=0.9,
                   min_lr_ratio=0.01),
    ScheduleConfig(kind="constant", total_steps=50, warmup_steps=7),
    ScheduleConfig(kind="step", total_steps=62, warmup_steps=2),
], ids=["cosine-warmup", "cosine", "poly", "constant", "step"])
def test_schedules_match_optax(cfg):
    """The port evaluates the schedule in float64; optax in float32, where
    the warmup's (init − end)·frac + end loses up to a float32 ulp of the
    base LR (at step 0 of the recipe: 5.82e-11 for the exact 6e-11)."""
    base = 6e-5
    ref = jopt.make_schedule(cfg, base)
    got = popt.make_schedule(cfg, base)
    for step in range(0, 70):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6,
                                   atol=np.finfo(np.float32).eps * base,
                                   err_msg=f"step {step}")


@pytest.fixture(scope="module")
def jax_segmentor():
    """The toy JAX Segmentor's variables (rescaled as the JAX task does)."""
    model = JaxSegmentor(CFG, K, channels=CHANNELS)
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, CROP, CROP, 3)), train=False))(jax.random.PRNGKey(0))
    params = dict(variables["params"])
    params["backbone"] = rescale_block_init(params["backbone"], CFG.depth)
    return model, params, variables["batch_stats"]


def _port_model(params, stats):
    port = Segmentor(CFG, K, channels=CHANNELS, input_hw=(CROP, CROP))
    port.load_state_dict(segmentor_from_jax({"params": params, "batch_stats": stats}, CFG))
    return port


def _as_leaf_arrays(tree, params):
    """Broadcast a per-leaf scalar tree to the leaves' shapes, so the port's
    converter (transposes, flips) can carry it to parameter names."""
    return jax.tree.map(lambda s, p: np.full(p.shape, float(s), np.float32),
                        tree, params)


def test_layer_decay_and_wd_mask_match_jax(jax_segmentor):
    _, params, stats = jax_segmentor
    port = _port_model(params, stats)
    named = list(port.named_parameters())
    want_scale = params_from_jax(_as_leaf_arrays(jopt.layer_decay_scales(
        params, CFG.depth, 0.9, jax_layer_id_fn_for(CFG, root="backbone/")),
        params), stats, CFG)
    want_decay = params_from_jax(_as_leaf_arrays(jopt.wd_mask(params), params),
                                 stats, CFG)
    got_scale = popt.layer_decay_scales(named, CFG.depth, 0.9,
                                        popt.layer_id_fn_for(CFG, "backbone."))
    got_decay = popt.wd_mask(named)
    assert set(got_scale) == set(want_scale) == set(got_decay)
    for name in got_scale:
        np.testing.assert_allclose(want_scale[name].numpy(), got_scale[name],
                                   rtol=1e-6, err_msg=name)
        assert bool(want_decay[name].all()) == got_decay[name] == bool(
            want_decay[name].any()), name
    # the decomposed rel-pos and Swin tables are decayed, pos_embed is not
    assert got_decay["backbone.blocks.0.attn.rel_pos_h"]
    assert got_decay["backbone.blocks.0.attn.relative_position_bias_table"]
    assert not got_decay["backbone.pos_embed"]


@pytest.mark.parametrize("frozen", [False, True], ids=["clip", "clip-frozen"])
def test_optimizer_update_matches_optax(jax_segmentor, frozen):
    """Three updates with gradient clipping on, from the same gradients: the
    parameters, the raw global norm and the Adam moments (through
    `opt_state_from_jax`); with `frozen`, the patch embedding and the head
    get no update (`frozen_mask`)."""
    _, params, stats = jax_segmentor
    opt = dataclasses.replace(OPT, lr=1e-2, clip_norm=1.0)
    port = _port_model(params, stats)
    jax_frozen = port_frozen = None
    if frozen:
        jax_frozen = jax.tree_util.tree_map_with_path(
            lambda path, _: path[0].key == "decode_head" or (
                path[0].key == "backbone" and path[1].key == "patch_embed"), params)
        port_frozen = {n: n.startswith(("decode_head.", "backbone.patch_embed."))
                       for n, _ in port.named_parameters()}
    tx = jopt.make_optimizer(opt, jopt.make_schedule(SCHED, opt.lr), params,
                             CFG.depth, jax_layer_id_fn_for(CFG, root="backbone/"),
                             frozen_mask=jax_frozen)
    px = popt.make_optimizer(opt, popt.make_schedule(SCHED, opt.lr),
                             port.named_parameters(), CFG.depth,
                             popt.layer_id_fn_for(CFG, "backbone."),
                             frozen_mask=port_frozen)
    initial = {n: p.detach().clone() for n, p in port.named_parameters()}
    state, jp = tx.init(params), params
    update = jax.jit(tx.update)
    rng = np.random.default_rng(3)
    named = dict(port.named_parameters())
    for _ in range(3):
        grads = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32) * 0.1), jp)
        updates, state = update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        for name, g in params_from_jax(grads, stats, CFG).items():
            named[name].grad = g
        norm = px.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)),
                                   rtol=1e-5)
    want = params_from_jax(jp, stats, CFG)
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=name)
        if frozen:
            assert torch.equal(p.detach(), initial[name]) == port_frozen[name], name
    count, moments = opt_state_from_jax(state, stats, CFG)
    assert count == px.count == 3
    for name, p in named.items():
        st = px.adamw.state[p]
        for got, ref in zip((st["exp_avg"], st["exp_avg_sq"]), moments[name]):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-9,
                                       rtol=1e-5, err_msg=name)


# ------------------------------------------------------------ train step --

def _batch(seed):
    rng = np.random.default_rng(seed)
    image = rng.standard_normal((BATCH, CROP, CROP, 3)).astype(np.float32)
    label = rng.integers(0, K, (BATCH, CROP, CROP)).astype(np.int32)
    label[:, :5] = 255
    return {"image": image, "label": label}


@pytest.fixture(scope="module")
def jax_two_steps(jax_segmentor):
    """Two JAX `make_train_step` steps (deterministic loss, train-mode
    BatchNorm) with the recipe's optimizer shape, and the gradients of each."""
    model, params, stats = jax_segmentor
    tx = jopt.make_optimizer(OPT, jopt.make_schedule(SCHED, OPT.lr), params,
                             CFG.depth, jax_layer_id_fn_for(CFG, root="backbone/"))

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


def _check_step(port_state, metrics, ref, lr):
    np.testing.assert_allclose(float(metrics["loss"]), ref["metrics"]["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               ref["metrics"]["grad_norm"], rtol=1e-5)
    after = ref["after"]
    # gradients: fp32 sums in other orders; the floor is for the conv biases
    # right before train-mode BatchNorm, whose gradient is 0 in exact
    # arithmetic and rounding residue here
    grads = params_from_jax(jax.tree.map(np.asarray, ref["grads"]),
                            after.batch_stats, CFG)
    g_all = float(torch.sqrt(sum((g ** 2).sum() for g in grads.values())))
    model = port_state.model
    for name, p in model.named_parameters():
        diff = float((p.grad - grads[name]).norm())
        assert diff <= 1e-4 * float(grads[name].norm()) + 1e-6 * g_all, name
    want = segmentor_from_jax({"params": after.params,
                               "batch_stats": after.batch_stats}, CFG)
    got = model.state_dict()
    for name in want:
        if "running_" in name:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=name)
    # parameters: where |g| is at noise level, Adam's first step is ±lr·scale
    # on either side, so each parameter is held to 2·lr·scale
    scales = {port_state.optimizer.names[p]: g["lr_scale"]
              for g in port_state.optimizer.adamw.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=2 * lr * scales[name] + 1e-7, rtol=0,
                                   err_msg=name)


def _task():
    cfg = TaskConfig(task="segmentation", num_classes=K, backbone=CFG,
                     train=TrainConfig(batch_size=BATCH, optimizer=OPT,
                                       schedule=SCHED))
    return SegmentationTask(cfg, model=Segmentor(CFG, K, channels=CHANNELS,
                                                 input_hw=(CROP, CROP)),
                            device="cpu")


def test_train_step_matches_jax(jax_two_steps):
    """One `train_step_fn` step against JAX `make_train_step` with the same
    `make_optimizer`: loss, grad norm, every gradient, the BatchNorm running
    statistics and the updated parameters."""
    ref = jax_two_steps[0]
    task = _task()
    state = task.init_state(torch.Generator().manual_seed(0))
    before = ref["before"]
    state.model.load_state_dict(segmentor_from_jax(
        {"params": before.params, "batch_stats": before.batch_stats}, CFG))
    state, metrics = task.train_step_fn(deterministic=True)(
        state, {k: _t(v) for k, v in _batch(1).items()})
    assert state.step == 1 and state.optimizer.count == 1
    _check_step(state, metrics, ref, popt.make_schedule(SCHED, OPT.lr)(0))


def test_second_step_from_converted_optax_state(jax_two_steps):
    """The JAX state after one step (parameters, BatchNorm statistics and
    the optax state, through `opt_state_from_jax`) carried to the port, then
    a second step on both sides."""
    ref = jax_two_steps[1]
    task = _task()
    state = task.init_state(torch.Generator().manual_seed(0))
    before = ref["before"]
    state.model.load_state_dict(segmentor_from_jax(
        {"params": before.params, "batch_stats": before.batch_stats}, CFG))
    state.optimizer.load_moments(*opt_state_from_jax(
        before.opt_state, before.batch_stats, CFG))
    state, metrics = task.train_step_fn(deterministic=True)(
        state, {k: _t(v) for k, v in _batch(2).items()})
    assert state.optimizer.count == 2
    _check_step(state, metrics, ref, popt.make_schedule(SCHED, OPT.lr)(1))


# ---------------------------------------------------------- losses, mIoU --

def test_losses_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
    labels = rng.integers(0, 4, (2, 5, 6)).astype(np.int32)
    labels[0, :2] = 255
    np.testing.assert_allclose(float(seg_xent(_t(logits), _t(labels))),
                               float(jax_seg_xent(jnp.asarray(logits),
                                                  jnp.asarray(labels))), rtol=1e-6)
    # no valid pixel: 0, where the mean of F.cross_entropy is NaN
    none = np.full_like(labels, 255)
    assert float(seg_xent(_t(logits), _t(none))) == 0.0 == float(
        jax_seg_xent(jnp.asarray(logits), jnp.asarray(none)))
    flat, cls = logits[:, 0, 0], labels[1, 0, :2]
    np.testing.assert_allclose(float(softmax_xent(_t(flat), _t(cls))),
                               float(jax_softmax_xent(jnp.asarray(flat),
                                                      jnp.asarray(cls))), rtol=1e-6)


def test_seg_accumulator_matches_jax():
    rng = np.random.default_rng(5)
    ours, ref = SegAccumulator(4), JaxSegAccumulator(4)
    for _ in range(2):
        pred = rng.integers(0, 4, (2, 9, 7))
        label = rng.integers(0, 3, (2, 9, 7))  # class 3 never labelled
        label[:, 0] = 255
        ours.add(pred, label)
        ref.add(pred, label)
        for a, b in zip(intersect_and_union(_t(pred), _t(label), 4),
                        jax_iou(jnp.asarray(pred), jnp.asarray(label), 4)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got, want = ours.evaluate(), ref.evaluate()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)


# ------------------------------------------------------ train-mode layers --

def test_dropout_and_drop_path_rates_and_repeatability():
    """Elementwise dropout keeps 1 − rate of the elements, per-sample
    drop-path 1 − rate of the samples, kept values scaled by 1/(1 − rate);
    the same generator seed repeats the masks; deterministic is identity."""
    x = torch.ones(200, 50, 10)
    gen = lambda s: torch.Generator().manual_seed(s)
    drop_path = lambda x, rate, det, g: apply_drop_path(
        x, drop_path_mask(x, rate, det, g), rate)
    y = dropout(x, 0.1, False, gen(0))
    keep = float((y != 0).float().mean())
    assert abs(keep - 0.9) < 5 * (0.09 / x.numel()) ** 0.5
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))
    assert torch.equal(y, dropout(x, 0.1, False, gen(0)))
    assert not torch.equal(y, dropout(x, 0.1, False, gen(1)))
    z = drop_path(x, 0.3, False, gen(2))
    per_sample = (z != 0).flatten(1)
    assert bool((per_sample.all(1) | ~per_sample.any(1)).all())  # whole samples
    kept = float(per_sample.all(1).float().mean())
    assert abs(kept - 0.7) < 5 * (0.21 / x.shape[0]) ** 0.5
    assert torch.equal(z, drop_path(x, 0.3, False, gen(2)))
    assert dropout(x, 0.1, True, None) is x and drop_path(x, 0.3, True, None) is x
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.1, False, None)


def test_model_train_mode_is_stochastic_and_repeatable():
    """Drop-path rates linspace(0, rate, depth) over the blocks; with
    deterministic=False the segmentor's output changes with the generator's
    seed and repeats with the same seed."""
    cfg = dataclasses.replace(CFG, drop_path_rate=0.3, drop_rate=0.1)
    vit = ViTRVSA(cfg, (CROP, CROP))
    np.testing.assert_allclose([b.drop_path_rate for b in vit.blocks],
                               np.linspace(0, 0.3, cfg.depth))
    model = Segmentor(cfg, K, channels=CHANNELS, input_hw=(CROP, CROP))
    x = torch.randn(2, CROP, CROP, 3, generator=torch.Generator().manual_seed(0))
    run = lambda seed: model(x, train=True, deterministic=False,
                             generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        a, b, c = run(1), run(1), run(2)
        d = model(x, train=True, deterministic=True)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    assert not torch.allclose(a, d)


def test_fit_and_evaluate(tmp_path):
    """`fit` logs at step 0, every log_every-th and the last step with
    data_time and step_time; `evaluate` returns the mIoU family; with a
    CheckpointStore `fit` saves the state at the end and exports the
    encoder (tests/test_torch_port_ckpt.py holds what they hold)."""
    cfg = TaskConfig(task="segmentation", num_classes=K,
                     backbone=dataclasses.replace(CFG, drop_path_rate=0.2),
                     train=TrainConfig(optimizer=OPT, schedule=SCHED),
                     slide=SlideConfig(crop=CROP, stride=32))
    task = SegmentationTask(cfg, model=Segmentor(
        cfg.backbone, K, channels=CHANNELS, input_hw=(CROP, CROP)), device="cpu")
    state = task.init_state(torch.Generator().manual_seed(0))
    logs = []
    data = iter([_batch(s) for s in range(3)])
    state, last = task.fit(state, data, 3, log_every=2,
                           log_fn=lambda i, m: logs.append((i, m)))
    assert [i for i, _ in logs] == [0, 2] and state.step == 3
    assert {"loss", "grad_norm", "acc", "data_time", "step_time"} <= logs[0][1].keys()
    assert all(np.isfinite(v) for v in last.values())
    images = np.random.default_rng(9).standard_normal((2, 96, 80, 3)).astype(np.float32)
    labels = np.random.default_rng(9).integers(0, K, (2, 96, 80))
    metrics = task.evaluate(state, iter([{"image": images, "label": labels}]))
    assert 0.0 <= metrics["mIoU"] <= 100.0 and len(metrics["IoU"]) == K
    from mtp_tpu_torch.ckpt.store import CheckpointStore
    ckpt = CheckpointStore(str(tmp_path / "ckpt"))
    state, _ = task.fit(state, iter([_batch(0)]), 1, ckpt=ckpt,
                        encoder_path=str(tmp_path / "encoder.pth"))
    assert ckpt.latest_step() == state.step == 4
    assert (tmp_path / "encoder.pth").is_file()
    ckpt.close()


def test_remat_and_meshes_are_refused():
    """A mesh that does not fit the world is refused: data=2 in one process,
    and any model axis over 1 (tensor parallelism is not ported;
    tests/test_torch_port_ddp.py runs data=2 in two).  Remat is no longer
    refused (tests/test_torch_port_highres.py holds it against no remat and
    against the JAX module)."""
    with pytest.raises(ValueError, match="world"):
        SegmentationTask(TaskConfig(backbone=CFG, train=TrainConfig(
            mesh=MeshConfig(data=2))), device="cpu")
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        SegmentationTask(TaskConfig(backbone=CFG, train=TrainConfig(
            mesh=MeshConfig(model=2))), device="cpu")
