"""The port's Oriented R-CNN against the JAX package's at toy widths
(ViT+RVSA of img_size 64, embed_dim 32, depth 2, `oriented_rcnn_cfg` cut
to small sample counts): the oriented RPN head (6 deltas an anchor) and
its midpoint-decoded proposals, the rotated box head (5-d, class-agnostic)
on rotated RoIs, `det_predict_core` (through the task's `predict_fn`),
`det_loss_core`'s losses and every parameter gradient, the state dict's
round trip through the JAX package's converters, the task on the CPU, and
the kernel launches of a forward, a train step and a predict.

JAX weights are carried to the port by `ckpt.from_jax.detector_from_jax`;
fp32 on both sides; inputs made with numpy from a seed.  As in the
horizontal tests, both modules' `random_sample` is replaced, in this test
only, by one deterministic rule written twice.  The predict's class-aware
rotated NMS is held against JAX's `det_predict_core` with its
`batched_nms` replaced, in the oracle only, by the per-class NMS that the
class offsets stand for (the rotated IoU of two boxes of one class, 0
across classes, at the boxes' own coordinates): at the offset coordinates
JAX's fp32 shoelace rounds IoUs by ~1e-4 and more (see
test_torch_port_rotated_ops.py), where the port's pair-translated IoU
rounds by 1e-7.  The JAX oracles are computed once, in a module-scoped
fixture."""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.ckpt.full_convert import (convert_bbox_head, convert_fpn_neck,
                                       convert_rpn_head)
from mtp_tpu.heads.rpn import gen_proposals as jgen_proposals
from mtp_tpu.models.detector import TwoStageDetector as JDetector
from mtp_tpu.models.detector import oriented_rcnn_cfg as j_oriented_rcnn_cfg
from mtp_tpu.ops import nms as jnms
from mtp_tpu.ops import rotated_boxes as jrb
from mtp_tpu.tasks import detection as jdet
from mtp_tpu.utils.config import (BackboneConfig, MeshConfig, OptimizerConfig,
                                  ScheduleConfig, TaskConfig, TrainConfig)
from mtp_tpu_torch.ckpt.from_jax import detector_from_jax
from mtp_tpu_torch.heads.rpn import RPNHead, RPNOut, gen_proposals
from mtp_tpu_torch.kernels import _build
from mtp_tpu_torch.models.detector import TwoStageDetector, oriented_rcnn_cfg
from mtp_tpu_torch.ops import dcnv3_sample as pdcn
from mtp_tpu_torch.ops import fused_attn
from mtp_tpu_torch.ops import nms as pnms
from mtp_tpu_torch.ops import rotated_boxes as prb
from mtp_tpu_torch.tasks import detection as pdet
from mtp_tpu_torch.tasks.detection_task import DetectionTask
from test_torch_port_detection import (BB, _randomise, _t, jax_rule, torch_rule)

torch.set_num_threads(1)

# fp32 on both sides; the sums of the convolutions and products run in
# other orders
ATOL, RTOL = 1e-5, 1e-5
SIZE, G = 64, 8
SMALL = dict(nms_pre=256, max_proposals=64, rpn_num=64, rcnn_num=32, max_per_img=16,
             max_gts=G)


def det_config(package_cfg):
    return dataclasses.replace(package_cfg(3), **SMALL)


def make_batch(B=2, seed=0):
    """Seeded images and 3 valid rotated gts an image among G slots: le90,
    sides 8-30 px, centres inside the image, θ off ±π/2."""
    rng = np.random.default_rng(seed)
    boxes = np.concatenate([rng.uniform(12, 52, (B, G, 2)), rng.uniform(8, 30, (B, G, 2)),
                            rng.uniform(-1.5, 1.5, (B, G, 1))], -1).astype(np.float32)
    boxes = np.asarray(jrb.regularize_le90(jnp.asarray(boxes)))
    valid = np.zeros((B, G), bool)
    valid[:, :3] = True
    return {"image": rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32),
            "gt_boxes": boxes, "gt_labels": rng.integers(0, 3, (B, G)).astype(np.int32),
            "gt_valid": valid}


def j_per_class_batched_nms(boxes, scores, idxs, iou_thr, max_out, iou_fn=None):
    """JAX's greedy NMS with classes kept apart by the IoU (0 across
    classes), the boxes at their own coordinates."""
    labelled = jnp.concatenate([boxes, idxs.astype(boxes.dtype)[..., None]], -1)
    return jnms.nms(labelled, scores, iou_thr, max_out,
                    iou_fn=lambda a, b: jrb.rbox_overlaps(a[:, :5], b[:, :5])
                    * (a[:, None, 5] == b[None, :, 5]))


ROIS = np.array([[20, 24, 28, 12, 0.3], [40, 30, 10, 6, -1.0], [32, 32, 60, 50, 0.0],
                 [50, 40, 20, 18, 1.2], [10, 50, 14, 9, -0.4], [30, 30, 36, 20, 0.7]],
                np.float32)
ROI_BIDX = np.array([0, 1, 1, 0, 1, 0], np.int32)


@pytest.fixture(scope="module")
def oracle():
    """The JAX oriented detector (toy widths, non-zero biases) and what every
    test compares: the FPN levels, the RPN's outputs, the box head on ROIS,
    the proposals, the detections, and the loss and its gradients under the
    deterministic sampler."""
    det = det_config(j_oriented_rcnn_cfg)
    model = JDetector(BB, det)
    batch = make_batch()
    img = jnp.asarray(batch["image"])
    params = jax.jit(model.init)(jax.random.PRNGKey(0), img[:1])["params"]
    v = {"params": _randomise(params, np.random.default_rng(1))}
    anchors = jdet.anchors_for(det, (SIZE, SIZE))

    @jax.jit
    def forward(v, img):
        feats = model.apply(v, img, method=JDetector.features)
        rpn_out = model.apply(v, feats, method=JDetector.rpn)
        box = model.apply(v, feats, jnp.asarray(ROIS), jnp.asarray(ROI_BIDX),
                          method=JDetector.box_head)
        props = jgen_proposals(rpn_out, jnp.asarray(anchors), (SIZE, SIZE), det.nms_pre,
                               det.max_proposals, det.rpn_nms_iou, rotated=True,
                               level_sizes=jdet.anchor_level_sizes((SIZE, SIZE)))
        return feats, rpn_out, box, props, jdet.detection_predict(model, v, img, anchors)

    with mock.patch.object(jdet, "batched_nms", j_per_class_batched_nms):
        feats, rpn_out, box, props, dets = forward(v, img)
    with mock.patch.object(jdet, "random_sample", jax_rule):
        (total, mets), grads = jax.jit(jax.value_and_grad(
            lambda p, b: jdet.detection_loss(model, {"params": p}, b,
                                             jax.random.PRNGKey(3), anchors),
            has_aux=True))(v["params"], jax.tree.map(jnp.asarray, batch))
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return dict(det=det, variables=to_np(v), batch=batch, feats=to_np(feats),
                rpn_out=to_np(rpn_out), box=to_np(box), props=to_np(props),
                dets=to_np(dets), total=float(total),
                metrics={k: float(x) for k, x in mets.items()}, grads=to_np(grads))


def _port(oracle):
    model = TwoStageDetector(BB, det_config(oriented_rcnn_cfg))
    model.load_state_dict(detector_from_jax(oracle["variables"], BB))
    return model


def _task(device="cpu"):
    cfg = TaskConfig(task="detection_r", num_classes=3, backbone=BB,
                     train=TrainConfig(batch_size=2, mesh=MeshConfig(data=1),
                                       optimizer=OptimizerConfig(lr=1e-3, clip_norm=0.0),
                                       schedule=ScheduleConfig(kind="constant")))
    return DetectionTask(cfg, head="oriented_rcnn", det_overrides=SMALL, device=device)


def test_config_matches_jax():
    assert dataclasses.asdict(oriented_rcnn_cfg(20)) == \
        dataclasses.asdict(j_oriented_rcnn_cfg(20))
    task = _task()
    assert task.rotated and task.det == det_config(oriented_rcnn_cfg)
    assert isinstance(task.model.rpn_head, RPNHead)
    assert task.model.rpn_head.rpn_reg.out_channels == 18      # 3 anchors × 6
    assert task.model.roi_head["bbox_head"].fc_reg.out_features == 5


def test_fpn_rpn_and_box_head_match_jax(oracle):
    model = _port(oracle)
    with torch.no_grad():
        feats = model.features(_t(oracle["batch"]["image"]))
        rpn_out = model.rpn(feats)
        cls, reg = model.box_head(feats, _t(ROIS), _t(ROI_BIDX))
    for got, want in zip(feats, oracle["feats"]):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   atol=ATOL, rtol=RTOL)
    assert rpn_out.deltas.shape[-1] == 6
    for got, want in zip(rpn_out, oracle["rpn_out"]):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    assert reg.shape == (6, 5)
    for got, want in zip((cls, reg), oracle["box"]):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_gen_proposals_matches_jax(oracle):
    """On JAX's RPN outputs: the per-level stable top-k, midpoint decoding,
    the centres clipped, horizontal NMS at 0.8 on the bounding boxes: the
    same proposals, index for index."""
    det = oracle["det"]
    rpn = RPNOut(*map(_t, oracle["rpn_out"]))
    boxes, scores = gen_proposals(rpn, _t(pdet.anchors_for(None, (SIZE, SIZE))),
                                  (SIZE, SIZE), det.nms_pre, det.max_proposals,
                                  det.rpn_nms_iou, True,
                                  level_sizes=pdet.anchor_level_sizes((SIZE, SIZE)))
    want_boxes, want_scores = oracle["props"]
    assert boxes.shape == (2, 64, 5)
    np.testing.assert_array_equal(scores.numpy(), want_scores)
    np.testing.assert_allclose(boxes[..., :4].numpy(), want_boxes[..., :4], atol=1e-4,
                               rtol=RTOL)
    d = np.remainder(boxes[..., 4].numpy() - want_boxes[..., 4] + np.pi / 2, np.pi) - np.pi / 2
    np.testing.assert_allclose(d, 0.0, atol=ATOL)
    assert (boxes[..., 0] >= 0).all() and (boxes[..., 0] <= SIZE).all()


def test_predict_matches_jax(oracle):
    """`predict_fn` (det_predict_core on the port's own forward): rotated
    boxes, scores, labels and valid."""
    task = _task()
    task.model.load_state_dict(_port(oracle).state_dict())
    dets = task.predict_fn()(_t(oracle["batch"]["image"]))
    want = oracle["dets"]
    assert dets.boxes.shape == (2, 16, 5) and bool(dets.valid.any())
    np.testing.assert_array_equal(dets.valid.numpy(), want.valid)
    np.testing.assert_array_equal(dets.labels.numpy(), want.labels)
    np.testing.assert_allclose(dets.scores.numpy(), want.scores, atol=ATOL, rtol=RTOL)
    v = want.valid
    # the port's own proposals (RPN outputs 1e-5 apart, through exp and the
    # midpoint rectification) decoded once more: up to 1.7e-5 relative
    np.testing.assert_allclose(dets.boxes.numpy()[v][:, :4], want.boxes[v][:, :4],
                               atol=1e-4, rtol=1e-4)
    d = np.remainder(dets.boxes.numpy()[v][:, 4] - want.boxes[v][:, 4] + np.pi / 2,
                     np.pi) - np.pi / 2
    np.testing.assert_allclose(d, 0.0, atol=1e-4)


def test_loss_and_gradients_match_jax(oracle, monkeypatch):
    """`det_loss_core` through the task's `loss_fn` (drop rates 0): each
    loss and the accuracy, and every parameter's gradient, against JAX's
    under the same deterministic sampler: the RPN assigned on the gts'
    bounding boxes with midpoint targets and SmoothL1 β = 1/9, the R-CNN by
    rotated IoU without low-quality matches, DeltaXYWHT targets and
    SmoothL1 β = 1.  The port takes JAX's proposals (its own are held by
    test_gen_proposals_matches_jax): on its own, from RPN outputs 1e-5
    apart, the long thin proposals of the random RPN differ by up to 9e-4
    px (a side of 276 px), which moves RoIAlign's bilinear weights, and
    with them the features' gradient (linear in the weights), by ~1e-3 of
    the classification loss's, while the losses agree to 1e-5."""
    monkeypatch.setattr(pdet, "random_sample", torch_rule)
    monkeypatch.setattr(pdet, "gen_proposals",
                        lambda *a, **k: tuple(_t(x) for x in oracle["props"]))
    task = _task()
    model = task.model
    model.load_state_dict(_port(oracle).state_dict())
    batch = {k: _t(v) for k, v in oracle["batch"].items()}
    total, metrics = task.loss_fn(model, batch, torch.Generator(), deterministic=True)
    assert set(metrics) == set(oracle["metrics"])
    for k, want in oracle["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), want, rtol=1e-5, atol=1e-6, err_msg=k)
    assert oracle["metrics"]["loss_bbox"] > 0 and oracle["metrics"]["loss_rpn_bbox"] > 0
    np.testing.assert_allclose(float(total), oracle["total"], rtol=1e-5)
    total.backward()
    want = detector_from_jax({"params": oracle["grads"]}, BB)
    g_all = np.sqrt(sum(float((w.double() ** 2).sum()) for w in want.values()))
    assert g_all > 0
    for name, p in model.named_parameters():
        diff = float((p.grad - want[name]).norm())
        assert diff <= 1e-4 * float(want[name].norm()) + 1e-6 * g_all, \
            (name, diff, float(want[name].norm()))


def test_state_dict_round_trips_through_the_jax_converters(oracle):
    """The rotated shapes (rpn_reg 6·3 outputs, fc_reg 5) through
    `convert_rpn_head` and `convert_bbox_head` give back the JAX params,
    the CHW ↔ HWC permutation of shared_fcs.0 included."""
    sd = {k: v.numpy() for k, v in _port(oracle).state_dict().items()}
    p = oracle["variables"]["params"]
    same = lambda a, b: jax.tree.map(np.testing.assert_array_equal, a, b)
    same(convert_fpn_neck(sd, n_lateral=4), p["neck"])
    same(convert_rpn_head(sd), p["rpn_head"])
    assert p["rpn_head"]["rpn_reg"]["kernel"].shape[-1] == 18
    trunk, cls, reg = convert_bbox_head(sd, roi_size=7)
    same((trunk, cls, reg), (p["bbox_trunk"], p["fc_cls"], p["fc_reg"]))
    assert p["fc_reg"]["kernel"].shape == (1024, 5)
    assert set(detector_from_jax(oracle["variables"], BB)) == set(_port(oracle).state_dict())


# ------------------------------------------------------------------- task --

def test_task_defaults_to_the_card_and_refuses_3c():
    """Every head defaults to the card; Mask R-CNN and RetinaNet, which
    slice 3c ported, build as the others do."""
    cfg = _task().cfg
    for head in ("oriented_rcnn", "mask_rcnn", "retinanet"):
        assert DetectionTask(cfg, head=head).device.type == "cuda"


def test_task_fit_and_evaluate_on_the_cpu():
    """Two steps of `fit` from `init_state` (the real sampler), finite
    metrics that move the weights, then `evaluate`'s rotated VOC AP50, with
    `coco=True` as well (JAX's COCO protocol is for horizontal boxes)."""
    task = _task()
    state = task.init_state(torch.Generator().manual_seed(0))
    before = state.model.roi_head["bbox_head"].fc_reg.weight.detach().clone()
    logs = []
    state, _ = task.fit(state, iter([make_batch(seed=5), make_batch(seed=6)]), 2,
                        log_every=1, log_fn=lambda i, m: logs.append(m))
    assert len(logs) == 2 and state.step == 2
    for m in logs:
        assert {"loss", "grad_norm", "loss_rpn_cls", "loss_rpn_bbox", "loss_cls",
                "loss_bbox", "acc", "data_time", "step_time"} <= set(m)
        assert all(np.isfinite(v) for v in m.values()), m
    assert not torch.equal(before, state.model.roi_head["bbox_head"].fc_reg.weight)
    with mock.patch("mtp_tpu_torch.tasks.detection_task.eval_map",
                    wraps=__import__("mtp_tpu_torch.eval.det_map",
                                     fromlist=["eval_map"]).eval_map) as spy:
        res = task.evaluate(state, iter([make_batch(seed=7)]))
    assert spy.call_args.kwargs["rotated"] is True
    assert spy.call_args.args[0][0]["det_boxes"].shape[-1] == 5
    assert 0.0 <= res["mAP"] <= 100.0 and len(res["AP"]) == 3
    # JAX's evaluate gives the rotated heads VOC AP with coco=True too
    res_coco = task.evaluate(state, iter([make_batch(seed=7)]), coco=True)
    assert res_coco.keys() == res.keys()


# --------------------------------------------------------------- launches --

@pytest.fixture
def stubbed_launches(monkeypatch):
    """Every kernel route taken on the CPU with its launch stubbed out and
    its outputs zeroed (`torch.empty` → `torch.zeros`, so that the path's
    arithmetic stays finite): returns the counters that moved."""
    monkeypatch.setattr(_build, "use_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "check_on_card", lambda *t, **k: None)
    monkeypatch.setattr(_build, "launch", lambda name, *a: None)
    monkeypatch.setattr(torch, "empty", torch.zeros)
    monkeypatch.setattr(torch, "empty_like", torch.zeros_like)
    counters = (fused_attn.LAUNCHES, pdcn.LAUNCHES, pnms.LAUNCHES, prb.LAUNCHES)
    for c in counters:
        for k in c:
            monkeypatch.setitem(c, k, c[k])   # restored after the test

    def moved():
        out = {k: n for c in counters for k, n in c.items() if n}
        for c in counters:
            c.update(dict.fromkeys(c, 0))
        return out

    return moved


def test_kernel_launches_per_step_and_predict(stubbed_launches):
    """The toy ViT (one RVSA block, one full block): a train step launches
    K1, K2, K3 ×2 and their backwards once per block, N1 once (the oriented
    RPN's horizontal NMS) and R1's dense form once (the R-CNN assigner); a
    predict the forward's kernels, N1 once and R1's mask form once (the
    class-aware rotated NMS)."""
    task = _task()
    state = task.init_state(torch.Generator().manual_seed(0))
    batch = {k: _t(v) for k, v in make_batch(seed=9).items()}
    fwd = {"window": 1, "flash": 1, "bilinear_sample": 2}
    stubbed_launches()
    task.train_step_fn()(state, batch)
    assert stubbed_launches() == {**fwd, "window_bwd": 1, "flash_bwd": 1,
                                  "bilinear_sample_bwd": 2, "nms": 1, "rbox_iou": 1}
    task.predict_fn()(batch["image"])
    assert stubbed_launches() == {**fwd, "nms": 1, "nms_rotated": 1}
