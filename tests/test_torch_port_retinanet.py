"""The port's RetinaNet against the JAX package's at toy widths (the ViT+RVSA
of `test_torch_port_detection`: img_size 64, embed_dim 32, depth 2; and a
small InternImage for the XL variant): the anchors, the FPN with
start_level 1 and its two extra convolutions on the backbone's last level,
the head's outputs in the anchors' order, `focal_loss`, `retinanet_loss`
and every parameter gradient, `retinanet_predict` (through the task's
`predict_fn`), the state dict's round trip through the JAX package's
converters, the classifier's prior, and the task's `fit` and `evaluate`
(VOC and COCO bbox) on the CPU.

JAX weights are carried to the port by `ckpt.from_jax.retinanet_from_jax`;
fp32 on both sides; inputs made with numpy from a seed.  RetinaNet samples
nothing: every anchor is assigned and counts.  The JAX oracles are computed
once, in a module-scoped fixture.  Tolerances: outputs and losses 1e-5
(absolute and relative: fp32 sums in other orders); each gradient within
1e-4 of its own norm plus 1e-6 of all gradients' norm; boxes to 5e-4 px
(decoded through exp() of the deltas); keep sets index for index."""

import dataclasses
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.ckpt.full_convert import convert_fpn_neck, convert_retina_head
from mtp_tpu.models import internimage as ji
from mtp_tpu.models import retinanet as jretina
from mtp_tpu.models.retinanet import RetinaConfig as JRetinaConfig
from mtp_tpu.utils.config import (MeshConfig, OptimizerConfig, ScheduleConfig,
                                  TaskConfig, TrainConfig)
from mtp_tpu_torch import config as pc
from mtp_tpu_torch.ckpt.from_jax import init_weights, retinanet_from_jax
from mtp_tpu_torch.models import retinanet as pretina
from mtp_tpu_torch.tasks.detection_task import DetectionTask
from test_torch_port_detection import BB, _randomise, _t, make_batch

torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-5
SIZE = 64
SMALL = dict(num_classes=3, max_per_img=16, max_gts=8, score_thr=0.001)
TINY_XL = dataclasses.replace(ji.internimage_xl(), channels=16, depths=(1, 1, 2, 1),
                              groups=(2, 4, 8, 16), layer_scale=0.5, dtype="float32",
                              drop_path_rate=0.0)
PORT_XL = pc.InternImageConfig(**dataclasses.asdict(TINY_XL))


def _jax_oracle(backbone_patch=None, seed=0):
    det = JRetinaConfig(**SMALL)
    batch = make_batch(seed=seed)
    img = jnp.asarray(batch["image"])
    anchors = jretina.retina_anchors(det, (SIZE, SIZE))
    patch = (mock.patch.object(jretina, "build_backbone", backbone_patch)
             if backbone_patch else mock.patch.dict({}))
    with patch:
        model = jretina.RetinaNet(BB, det)
        params = jax.jit(model.init)(jax.random.PRNGKey(seed), img[:1])["params"]
        v = {"params": _randomise(params, np.random.default_rng(seed + 1))}

        @jax.jit
        def forward(v, img):
            neck = model.apply(v, img, method=lambda m, x: m.neck(m.backbone(x, True)))
            return neck, model.apply(v, img), jretina.retinanet_predict(model, v, img,
                                                                        anchors)

        neck, heads, dets = forward(v, img)
        (total, mets), grads = jax.jit(jax.value_and_grad(
            lambda p, b: jretina.retinanet_loss(model, {"params": p}, b, anchors),
            has_aux=True))(v["params"], jax.tree.map(jnp.asarray, batch))
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return dict(variables=to_np(v), batch=batch, anchors=anchors, neck=to_np(neck),
                heads=to_np(heads), dets=to_np(dets), total=float(total),
                metrics={k: float(x) for k, x in mets.items()}, grads=to_np(grads))


@pytest.fixture(scope="module")
def oracle():
    """The JAX RetinaNet (toy widths, non-zero biases) and what the tests
    compare: the FPN levels, the head's outputs, the detections, and the
    loss and its gradients."""
    return _jax_oracle()


def _task(backbone=BB, **kw):
    cfg = TaskConfig(task="detection_h", num_classes=3, backbone=BB,
                     train=TrainConfig(batch_size=2, mesh=MeshConfig(data=1),
                                       optimizer=OptimizerConfig(lr=1e-3, clip_norm=0.0),
                                       schedule=ScheduleConfig(kind="constant")))
    ov = {k: v for k, v in SMALL.items() if k != "num_classes"}
    model = pretina.RetinaNet(backbone, pc.RetinaConfig(**SMALL))
    return DetectionTask(cfg, head="retinanet", det_overrides={**ov, **kw}, model=model,
                         device="cpu")


def _loaded(oracle, backbone=BB):
    task = _task(backbone)
    task.model.load_state_dict(retinanet_from_jax(oracle["variables"], backbone))
    return task


def test_anchors_match_jax():
    """9 anchors a place on strides 8-128; 32,526 an image at the recipe's
    416² (52² + 26² + 13² + 7² + 4² places)."""
    for cfg, hw in ((SMALL, (SIZE, SIZE)), ({}, (416, 416)), ({}, (100, 60))):
        got = pretina.retina_anchors(pc.RetinaConfig(**cfg), hw)
        want = jretina.retina_anchors(JRetinaConfig(**cfg), hw)
        np.testing.assert_array_equal(got, want)
    assert pretina.retina_anchors(pc.RetinaConfig(), (416, 416)).shape == (32526, 4)


def test_neck_and_head_outputs_match_jax(oracle):
    """FPN levels at strides 8-128 (the extra convolutions on the
    backbone's last level), then (B, A_total, K) logits and (B, A_total, 4)
    deltas in the anchors' order."""
    model = _loaded(oracle).model
    x = _t(oracle["batch"]["image"])
    with torch.no_grad():
        neck = model.features(x)
        cls_logits, deltas = model(x)
    assert [tuple(f.shape[2:]) for f in neck] == [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]
    for got, want in zip(neck, oracle["neck"]):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=ATOL,
                                   rtol=RTOL)
    assert cls_logits.shape == (2, len(oracle["anchors"]), 3)
    for got, want in zip((cls_logits, deltas), oracle["heads"]):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_focal_loss_matches_jax():
    """Positives, background (label num_classes) and ignored anchors (-1,
    and masked by `valid`)."""
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((50, 4)) * 3).astype(np.float32)
    labels = rng.integers(-1, 5, 50).astype(np.int32)
    valid = labels >= 0
    want = jretina.focal_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(valid),
                              4, 2.0, 0.25)
    got = pretina.focal_loss(_t(logits), _t(labels).long(), _t(valid), 4, 2.0, 0.25)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_loss_and_gradients_match_jax(oracle):
    """`retinanet_loss` through the task's `loss_fn` (drop rates 0): both
    losses and every parameter's gradient."""
    task = _loaded(oracle)
    batch = {k: _t(v) for k, v in oracle["batch"].items()}
    total, metrics = task.loss_fn(task.model, batch, torch.Generator(), deterministic=True)
    for k, want in oracle["metrics"].items():
        np.testing.assert_allclose(float(metrics[k].detach()), want, rtol=RTOL, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(float(total.detach()), oracle["total"], rtol=RTOL)
    total.backward()
    want = retinanet_from_jax({"params": oracle["grads"]}, BB)
    g_all = np.sqrt(sum(float((w.double() ** 2).sum()) for w in want.values()))
    assert g_all > 0
    for name, p in task.model.named_parameters():
        # the ViT's stride-4 level (fpn1) feeds nothing from start_level 1 on:
        # it is not run, so no gradient in the port, zeros in JAX; every
        # other parameter has one
        if name.startswith("backbone.fpn1."):
            assert p.grad is None and float(want[name].abs().max()) == 0.0, name
            continue
        assert p.grad is not None, name
        diff = float((p.grad - want[name]).norm())
        assert diff <= 1e-4 * float(want[name].norm()) + 1e-6 * g_all, \
            (name, diff, float(want[name].norm()))


def test_predict_matches_jax(oracle):
    """Sigmoid scores over every (anchor, class), the stable top
    10·max_per_img, decode, clip, class-aware NMS: keep sets index for
    index (`score_thr` 0.001, under the prior's 0.01, so that detections
    exist; no score lies within 1e-4 of it)."""
    task = _loaded(oracle)
    with torch.no_grad():
        probs = torch.sigmoid(task.model(_t(oracle["batch"]["image"]))[0])
    assert float((probs - SMALL["score_thr"]).abs().min()) > 1e-4
    dets = task.predict_fn()(_t(oracle["batch"]["image"]))
    want = oracle["dets"]
    assert bool(dets.valid.all()) and dets.mask_logits is None
    np.testing.assert_array_equal(dets.valid.numpy(), want.valid)
    np.testing.assert_array_equal(dets.labels.numpy(), want.labels)
    np.testing.assert_allclose(dets.scores.numpy(), want.scores, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(dets.boxes.numpy(), want.boxes, atol=5e-4, rtol=RTOL)


def test_state_dict_round_trips_through_the_jax_converters(oracle):
    """The port's state dict through `convert_fpn_neck` (3 laterals, 5
    output convolutions: the extra two continue the index) and
    `convert_retina_head` gives back the JAX params."""
    sd = {k: v.numpy() for k, v in _loaded(oracle).model.state_dict().items()}
    p = oracle["variables"]["params"]
    same = lambda a, b: jax.tree.map(np.testing.assert_array_equal, a, b)
    same(convert_fpn_neck(sd, n_lateral=3, n_fpn=5), p["neck"])
    head = convert_retina_head(sd)
    same(head, {k: p[k] for k in head})
    assert set(retinanet_from_jax(oracle["variables"], BB)) == \
        set(_loaded(oracle).model.state_dict())


def test_init_draws_the_classifier_prior():
    """`init_weights`: retina_cls's bias −log((1 − 0.01) / 0.01), every
    other bias 0, as flax's initialisers give."""
    model = init_weights(pretina.RetinaNet(BB, pc.RetinaConfig(**SMALL)),
                         torch.Generator().manual_seed(0))
    head = model.bbox_head
    np.testing.assert_allclose(head.retina_cls.bias.detach().numpy(), -math.log(99.0),
                               rtol=1e-7)
    assert not head.retina_reg.bias.any() and not head.cls_convs[0].conv.bias.any()


def test_xl_retinanet_matches_jax_at_toy_size():
    """`retinanet_intern_xl_416_xview`'s model shape (InternImage's pyramid
    of doubling widths: the extra convolutions take its widest level) at
    toy size: the head's outputs and both losses; the JAX side builds this
    small InternImage in place of XL."""
    want = _jax_oracle(lambda cfg, name="backbone": ji.InternImage(TINY_XL, name=name), 2)
    task = _loaded(want, PORT_XL)
    batch = {k: _t(v) for k, v in want["batch"].items()}
    with torch.no_grad():
        heads = task.model(batch["image"])
        _, metrics = task.loss_fn(task.model, batch, torch.Generator(), deterministic=True)
    for got, w in zip(heads, want["heads"]):
        np.testing.assert_allclose(got.numpy(), w, atol=ATOL, rtol=RTOL)
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), w, rtol=RTOL, atol=1e-6, err_msg=k)


def test_task_fit_and_evaluate_on_the_cpu():
    """Two steps of `fit` from `init_state` (the default model), finite
    metrics that move the weights, then `evaluate`: VOC AP50 and, with
    `coco=True`, the 12 COCO bbox stats."""
    cfg = TaskConfig(task="detection_h", num_classes=3, backbone=BB,
                     train=TrainConfig(batch_size=2, mesh=MeshConfig(data=1),
                                       optimizer=OptimizerConfig(lr=1e-3, clip_norm=0.0),
                                       schedule=ScheduleConfig(kind="constant")))
    task = DetectionTask(cfg, head="retinanet",
                         det_overrides={k: v for k, v in SMALL.items() if k != "num_classes"},
                         device="cpu")
    state = task.init_state(torch.Generator().manual_seed(0))
    before = state.model.bbox_head.retina_cls.weight.detach().clone()
    logs = []
    state, _ = task.fit(state, iter([make_batch(seed=5), make_batch(seed=6)]), 2,
                        log_every=1, log_fn=lambda i, m: logs.append(m))
    assert len(logs) == 2 and state.step == 2
    for m in logs:
        assert {"loss", "grad_norm", "loss_cls", "loss_bbox"} <= set(m)
        assert all(np.isfinite(v) for v in m.values()), m
    assert not torch.equal(before, state.model.bbox_head.retina_cls.weight)
    voc = task.evaluate(state, iter([make_batch(seed=7)]))
    assert 0.0 <= voc["mAP"] <= 100.0 and len(voc["AP"]) == 3
    coco = task.evaluate(state, iter([make_batch(seed=7)]), coco=True)
    assert len(coco) == 12 and all(-1.0 <= x <= 100.0 for x in coco.values())
