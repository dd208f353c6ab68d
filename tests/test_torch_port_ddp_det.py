"""The port's data-parallel detection and multitask steps against JAX on a
data-2 mesh: two gloo ranks in spawned processes (`tests/torch_ddp_workers.py`),
each on its rows of the global batch, against JAX's step over the global
batch sharded on the `data` axis of 2 of its virtual CPU devices (the loss's
value and gradient jitted with that sharding, then the optimizer's update:
`mtp_tpu.core.train.make_train_step`'s body).

- the toy Faster R-CNN of `test_torch_port_detection.py` (img 64, embed 32,
  depth 2), 4 images with 3, 1, 3 and 2 gts, so that the ranks' positive
  counts differ and the R-CNN normalisers must count over the world;
- the toy 9-way multitask step of `test_torch_port_multitask.py`, two images
  a dataset (one a rank), sequential and concatenated (`det_multi`).

Both packages' samplers take the deterministic rule, both sides the same
numpy Dropout2d masks and JAX's proposals, as the single-device tests give
them.  fp32; tolerances as those tests' (losses 1e-5; each gradient within
1e-4 of its own norm plus 1e-6 of all gradients' norm, the multitask mask
trunk's within 2e-3), the parameters after the step within 2·lr·scale
(Adam's first step moves a parameter whose gradient is rounding noise by
±lr·scale either way)."""

import dataclasses
from unittest import mock

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from mtp_tpu.core import optim as jopt
from mtp_tpu.models import multitask as jmt
from mtp_tpu.models.backbones import layer_id_fn_for as jax_layer_id_fn_for
from mtp_tpu.models.detector import DetConfig as JDetConfig
from mtp_tpu.models.detector import TwoStageDetector as JDetector
from mtp_tpu.parallel import mesh as jmesh
from mtp_tpu.tasks import detection as jdet
from mtp_tpu.utils.config import MeshConfig as JMeshConfig
from mtp_tpu_torch import config as pc
from mtp_tpu_torch.ckpt.from_jax import detector_from_jax, multitask_from_jax
from test_torch_port_ddp import _jcfg, det_batch
from test_torch_port_detection import BB, SMALL, _randomise, jax_rule
from test_torch_port_multitask import (CLASSES, KEEP, MASK_TRUNK, OVERRIDES, SIZE,
                                       TWO_PASS_BATCHNORM, XL_MASK_TRUNK_RTOL, _jax_loss_fn,
                                       _without, drop_masks, make_batches, port_rbox_to_hbox,
                                       port_rpn_assign)
from torch_ddp_workers import _multitask_step, det_task, run

torch.set_num_threads(1)

PBB = pc.BackboneConfig(**dataclasses.asdict(BB))
OPT = pc.OptimizerConfig(lr=1e-3, clip_norm=0.0)
LR = 1e-3


def _mesh_data():
    mesh = jmesh.make_mesh(JMeshConfig(data=2))
    return NamedSharding(mesh, PartitionSpec(jmesh.DATA_AXIS))


def _jax_step(loss, params, stats, batch, root):
    """JAX's step on the data-2 mesh: (loss, aux, grads, grad_norm, params
    after one AdamW update with the recipe's layer decay)."""
    (total, aux), grads = jax.jit(jax.value_and_grad(loss, has_aux=True),
                                  in_shardings=(None, None, _mesh_data()))(params, stats, batch)
    tx = jopt.make_optimizer(_jcfg(OPT), jopt.make_schedule(_jcfg(pc.ScheduleConfig(
        kind="constant")), LR), params, BB.depth, jax_layer_id_fn_for(BB, root=root))
    updates, _ = jax.jit(tx.update)(grads, tx.init(params), params)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return (float(total), to_np(aux), to_np(grads), float(optax.global_norm(grads)),
            to_np(optax.apply_updates(params, updates)))


def _check(got, want_grads, want_params, scales, rtol=lambda name: 1e-4):
    """The first step's gradients (each within rtol(name) of its norm plus
    1e-6 of all gradients') and the parameters after it."""
    g_all = float(torch.sqrt(sum((g.double() ** 2).sum() for g in want_grads.values())))
    assert g_all > 0
    for name, g in want_grads.items():
        diff = float((got["grads"][name] - g).norm())
        assert diff <= rtol(name) * float(g.norm()) + 1e-6 * g_all, (name, diff, float(g.norm()))
    for name, w in want_params.items():
        if name in scales:
            np.testing.assert_allclose(got["state"][0][name].numpy(), w.numpy(), rtol=0,
                                       atol=2 * LR * scales[name] + 1e-7, err_msg=name)


def _scales(task, state):
    return {state.optimizer.names[p]: g["lr_scale"]
            for g in state.optimizer.adamw.param_groups for p in g["params"]}


def test_faster_rcnn_step_matches_jax_on_a_data_2_mesh(tmp_path):
    """2 ranks × 2 images against JAX on the 4: the named losses, acc and
    the loss, grad_norm, every gradient and the parameters after the step;
    the ranks' positive counts differ, their states are equal bit for bit."""
    det = JDetConfig(**SMALL)
    model = JDetector(BB, det)
    batch = det_batch(11)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(batch["image"][:1]))["params"]
    params = _randomise(params, np.random.default_rng(1))
    anchors = jdet.anchors_for(det, (SIZE, SIZE))

    def loss(p, stats, b):
        return jdet.detection_loss(model, {"params": p}, b, jax.random.PRNGKey(3), anchors)

    with mock.patch.object(jdet, "random_sample", jax_rule):
        total, mets, grads, norm, after = _jax_step(loss, params, {},
                                                    jax.tree.map(jnp.asarray, batch), "backbone/")

    sd = detector_from_jax({"params": jax.tree.map(np.asarray, params)}, BB)
    cfg = pc.TaskConfig(task="detection_h", num_classes=3, backbone=PBB,
                        train=pc.TrainConfig(batch_size=4, optimizer=OPT,
                                             schedule=pc.ScheduleConfig(kind="constant")))
    payload = dict(cfg=cfg, det_overrides={k: v for k, v in SMALL.items()
                                           if k != "num_classes"},
                   state_dict=sd, batches=[batch], deterministic=True, rule=True)
    ranks = run("det_step", 2, tmp_path, payload)
    assert [c[0] for c in ranks[0]["counts"]] != [c[0] for c in ranks[1]["counts"]]
    assert all(torch.equal(ranks[0]["state"][0][k], v) for k, v in ranks[1]["state"][0].items())
    got = ranks[0]
    m = got["metrics"][0]
    for k, w in mets.items():
        np.testing.assert_allclose(m[k], float(w), rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(m["loss"], total, rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"], norm, rtol=1e-5)
    task, state = det_task(dict(payload, state_dict=None))
    _check(got, detector_from_jax({"params": grads}, BB),
           detector_from_jax({"params": after}, BB), _scales(task, state))


SIZES = (2, 2, 2)


@pytest.fixture(scope="module")
def multitask_oracle():
    """JAX's 9-way loss, gradients and update on the data-2 mesh (sizes 2, 2,
    2: one image a dataset a rank), under the rule, the numpy Dropout2d
    masks, the port's RPN assignment and two-pass BatchNorm; and JAX's
    proposals of every image, which both sides take."""
    batches = _without(make_batches(SIZES, seed=4), "gt_masks")
    masks = drop_masks(SIZES, seed=51)
    model = jmt.MultiTaskPretrainModel(BB, CLASSES, dict(OVERRIDES))
    anchors = jdet.anchors_for(None, (SIZE, SIZE))
    with mock.patch.object(jdet, "random_sample", jax_rule), \
            mock.patch.object(jdet, "max_iou_assign", port_rpn_assign), \
            mock.patch.object(jdet, "rbox_to_hbox", port_rbox_to_hbox), \
            mock.patch.object(flax.linen, "BatchNorm", TWO_PASS_BATCHNORM):
        variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                        jnp.zeros((2, SIZE, SIZE, 3), jnp.float32))
        params = _randomise(variables["params"], np.random.default_rng(1))
        stats = variables["batch_stats"]

        def proposals(m, images):
            enc = m.encode(images)
            return [jdet.gen_proposals(
                fwd(enc)[1], jnp.asarray(anchors), (SIZE, SIZE), d.nms_pre, d.max_proposals,
                d.rpn_nms_iou, d.rotated, level_sizes=jdet.anchor_level_sizes((SIZE, SIZE)))
                for fwd, d in ((m.is_forward, m.det_h_cfgs[0]), (m.rd_forward, m.det_r_cfgs[0]))]

        props = jax.jit(lambda p, s, bs: [model.apply({"params": p, "batch_stats": s},
                                                      b["image"], method=proposals)
                                          for b in bs])(params, stats,
                                                        jax.tree.map(jnp.asarray, batches))
        total, (losses, new_stats), grads, norm, after = _jax_step(
            _jax_loss_fn(model, masks), params, stats, jax.tree.map(jnp.asarray, batches),
            "encoder/")
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return dict(batches=batches, masks=masks, props=to_np(props), total=total,
                losses={k: float(v) for k, v in losses.items()}, stats=new_stats,
                grads=grads, norm=norm, after=after,
                variables=to_np({"params": params, "batch_stats": stats}))


@pytest.mark.parametrize("det_multi", [False, True])
def test_multitask_step_matches_jax_on_a_data_2_mesh(multitask_oracle, det_multi, tmp_path):
    """2 ranks × one image a dataset against JAX on the three pairs: the 30
    named losses, the loss and grad_norm, every gradient, the ss trunk's
    BatchNorm statistics (counted over both ranks' images) and the
    parameters after the step.  The mask trunk's gradients are held to JAX
    at `XL_MASK_TRUNK_RTOL` (2e-3): JAX's fp32 error there grows with the
    RoIs summed in them (`test_torch_port_multitask.py`), and over these 6
    images the port's world-1 run lies up to 7.4e-4 from JAX in them; every
    gradient of the world-2 step is also held to the port's world-1 step on
    the same batch at 1e-5."""
    ref = multitask_oracle
    cfg = pc.TaskConfig(task="multitask", num_classes=0, backbone=PBB,
                        train=pc.TrainConfig(batch_size=6, optimizer=OPT,
                                             schedule=pc.ScheduleConfig(kind="constant")))
    sd = multitask_from_jax(ref["variables"], BB)
    payload = dict(cfg=cfg, backbone=PBB, classes=CLASSES, overrides=OVERRIDES,
                   det_multi=det_multi, state_dict=sd, masks=ref["masks"], keep=KEEP,
                   props=ref["props"], deterministic=False,
                   batches=[{f"d{d}": b for d, b in enumerate(ref["batches"])}])
    ranks = run("multitask_step", 2, tmp_path, payload)
    assert all(torch.equal(ranks[0]["state"][0][k], v) for k, v in ranks[1]["state"][0].items())
    got = ranks[0]
    m = got["metrics"][0]
    assert len(ref["losses"]) == 3 + 3 * 5 + 3 * 4
    for k, w in ref["losses"].items():
        np.testing.assert_allclose(m[k], w, rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(m["loss"], ref["total"], rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"], ref["norm"], rtol=1e-5)
    want = multitask_from_jax({"params": ref["after"], "batch_stats": ref["stats"]}, BB)
    for name, w in want.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got["state"][0][name].numpy(), w.numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=name)
    grads = {k: v for k, v in multitask_from_jax(
        {"params": ref["grads"], "batch_stats": ref["stats"]}, BB).items()
        if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    from mtp_tpu_torch.models.multitask import MultiTaskPretrainModel
    from mtp_tpu_torch.tasks.multitask import MultiTaskPretrainTask
    task = MultiTaskPretrainTask(cfg, CLASSES, OVERRIDES,
                                 model=MultiTaskPretrainModel(PBB, CLASSES, OVERRIDES),
                                 device="cpu")
    _check(got, grads, want, _scales(task, task.init_state(torch.Generator().manual_seed(0))),
           lambda name: XL_MASK_TRUNK_RTOL if name.startswith(MASK_TRUNK) else 1e-4)
    one = _multitask_step(payload)
    g_all = float(torch.sqrt(sum((g.double() ** 2).sum() for g in one["grads"].values())))
    for name, g in one["grads"].items():
        diff = float((got["grads"][name] - g).norm())
        assert diff <= 1e-5 * float(g.norm()) + 1e-6 * g_all, (name, diff, float(g.norm()))
