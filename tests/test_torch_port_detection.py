"""The port's Faster R-CNN against the JAX package's at toy widths (ViT+RVSA
of img_size 64, embed_dim 32, depth 2): the FPN, the RPN head and the box
head, proposal generation, `det_predict_core` (through the task's
`predict_fn`), `det_loss_core`'s losses and parameter gradients, the state
dict's round trip through the JAX package's converters, and the task's
`fit` and `evaluate` on the CPU.

JAX weights are carried to the port by `ckpt.from_jax.detector_from_jax`;
fp32 on both sides; inputs made with numpy from a seed.  The samplers draw
from JAX's PRNG and from a torch.Generator, which cannot give the same
bits, so for the loss both modules' `random_sample` is replaced, in this
test only, by one deterministic rule written twice (positives in index
order up to the cap, then negatives in index order).  The JAX oracles are
computed once, in a module-scoped fixture."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.ckpt.full_convert import (convert_bbox_head, convert_fpn_neck,
                                       convert_rpn_head)
from mtp_tpu.heads.rpn import gen_proposals as jgen_proposals
from mtp_tpu.models.detector import DetConfig as JDetConfig
from mtp_tpu.models.detector import TwoStageDetector as JDetector
from mtp_tpu.ops.assign import SampleResult as JSampleResult
from mtp_tpu.tasks import detection as jdet
from mtp_tpu.utils.config import (BackboneConfig, MeshConfig, OptimizerConfig,
                                  ScheduleConfig, TaskConfig, TrainConfig)
from mtp_tpu_torch.ckpt.from_jax import detector_from_jax, init_weights
from mtp_tpu_torch.heads.rpn import RPNOut, gen_proposals
from mtp_tpu_torch.models.detector import DetConfig, TwoStageDetector
from mtp_tpu_torch.ops import assign as passign
from mtp_tpu_torch.tasks import detection as pdet
from mtp_tpu_torch.tasks.detection_task import DetectionTask

torch.set_num_threads(1)

# fp32 on both sides; the sums of the convolutions and products run in
# other orders
ATOL, RTOL = 1e-5, 1e-5
SIZE, G = 64, 8
BB = BackboneConfig(img_size=SIZE, patch_size=16, embed_dim=32, depth=2, num_heads=2,
                    interval=2, out_indices=(0, 0, 1, 1), dtype="float32",
                    drop_path_rate=0.0)
SMALL = dict(num_classes=3, nms_pre=256, max_proposals=64, rpn_num=64, rcnn_num=32,
             max_per_img=16, max_gts=G)


def _t(a):
    return torch.from_numpy(np.array(a))


def make_batch(B=2, seed=0):
    """Seeded images and 3 valid gt boxes an image among G slots."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(4, 40, (B, G, 2))
    wh = rng.uniform(8, 24, (B, G, 2))
    valid = np.zeros((B, G), bool)
    valid[:, :3] = True
    return {"image": rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32),
            "gt_boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
            "gt_labels": rng.integers(0, 3, (B, G)).astype(np.int32),
            "gt_valid": valid}


# the deterministic sampler rule, once in jnp (one image, as JAX's vmap
# calls it) and once in torch (batched)
def _rule_keys(gt_inds, cumsum, arange, num, frac):
    pos, neg = gt_inds > 0, gt_inds == 0
    pos_sel = pos & (cumsum(pos) <= int(num * frac))
    neg_sel = neg & (cumsum(neg) <= num - pos_sel.sum(-1, keepdims=True))
    A = gt_inds.shape[-1]
    key = (2 * pos_sel + neg_sel) * A + (A - 1 - arange(A))
    return pos_sel, neg_sel, key


def jax_rule(assign, rng, num, frac):
    pos_sel, neg_sel, key = _rule_keys(assign.gt_inds, lambda m: jnp.cumsum(m, -1),
                                       jnp.arange, num, frac)
    inds = jax.lax.top_k(key, num)[1].astype(jnp.int32)
    return JSampleResult(inds, pos_sel[inds], (pos_sel | neg_sel)[inds],
                         jnp.clip(assign.gt_inds[inds] - 1, 0, None), assign.labels[inds])


def torch_rule(assign, generator, num, frac):
    pos_sel, neg_sel, key = _rule_keys(
        assign.gt_inds, lambda m: m.long().cumsum(-1),
        lambda n: torch.arange(n, device=assign.gt_inds.device), num, frac)
    inds = torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :num]
    take = lambda t: t.gather(-1, inds)
    return passign.SampleResult(inds, take(pos_sel), take(pos_sel | neg_sel),
                                (take(assign.gt_inds) - 1).clamp(min=0),
                                take(assign.labels))


def _randomise(params, rng):
    """Non-zero biases (flax initialises them to 0)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(a) + (rng.standard_normal(a.shape).astype(np.float32)
                                          * 0.1 if path[-1].key == "bias" else 0.0),
        params)


ROIS = np.array([[2, 3, 30, 40], [10, 10, 20, 18], [0, 0, 64, 64], [40, 5, 63, 60],
                 [5, 44, 60, 62], [16, 16, 48, 48]], np.float32)
ROI_BIDX = np.array([0, 1, 1, 0, 1, 0], np.int32)


@pytest.fixture(scope="module")
def oracle():
    """The JAX detector (toy widths, non-zero biases) and what every test
    compares: the FPN levels, the RPN's outputs, the box head on ROIS, the
    proposals, the detections, and the loss and its gradients under the
    deterministic sampler."""
    det = JDetConfig(**SMALL)
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
                               det.max_proposals, det.rpn_nms_iou,
                               level_sizes=jdet.anchor_level_sizes((SIZE, SIZE)))
        return feats, rpn_out, box, props, jdet.detection_predict(model, v, img, anchors)

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
    model = TwoStageDetector(BB, DetConfig(**SMALL))
    model.load_state_dict(detector_from_jax(oracle["variables"], BB))
    return model


def test_fpn_rpn_and_box_head_match_jax(oracle):
    model = _port(oracle)
    with torch.no_grad():
        feats = model.features(_t(oracle["batch"]["image"]))
        rpn_out = model.rpn(feats)
        cls, reg = model.box_head(feats, _t(ROIS), _t(ROI_BIDX))
    assert [tuple(f.shape) for f in feats] == [(2, 256, s, s) for s in (16, 8, 4, 2, 1)]
    for got, want in zip(feats, oracle["feats"]):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   atol=ATOL, rtol=RTOL)
    for got, want in zip(rpn_out, oracle["rpn_out"]):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    for got, want in zip((cls, reg), oracle["box"]):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_gen_proposals_matches_jax(oracle):
    """On JAX's RPN outputs: the per-level stable top-k, decode, clip and
    NMS give the same proposals, index for index."""
    det = oracle["det"]
    rpn = RPNOut(*map(_t, oracle["rpn_out"]))
    boxes, scores = gen_proposals(rpn, _t(pdet.anchors_for(None, (SIZE, SIZE))),
                                  (SIZE, SIZE), det.nms_pre, det.max_proposals,
                                  det.rpn_nms_iou,
                                  level_sizes=pdet.anchor_level_sizes((SIZE, SIZE)))
    want_boxes, want_scores = oracle["props"]
    np.testing.assert_array_equal(scores.numpy(), want_scores)
    np.testing.assert_allclose(boxes.numpy(), want_boxes, atol=ATOL, rtol=RTOL)


def test_predict_matches_jax(oracle):
    """`predict_fn` (det_predict_core on the port's own forward): boxes,
    scores, labels and valid."""
    task = DetectionTask(_task_cfg(), det_overrides=_overrides(), device="cpu")
    task.model.load_state_dict(_port(oracle).state_dict())
    dets = task.predict_fn()(_t(oracle["batch"]["image"]))
    assert task.predict_fn() is task.predict_fn()
    want = oracle["dets"]
    assert dets.boxes.shape == (2, 16, 4) and bool(dets.valid.any())
    np.testing.assert_array_equal(dets.valid.numpy(), want.valid)
    np.testing.assert_array_equal(dets.labels.numpy(), want.labels)
    np.testing.assert_allclose(dets.scores.numpy(), want.scores, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(dets.boxes.numpy(), want.boxes, atol=1e-4, rtol=RTOL)


def test_loss_and_gradients_match_jax(oracle, monkeypatch):
    """`det_loss_core` through the task's `loss_fn` (drop rates 0): each
    loss and the accuracy, and every parameter's gradient, against
    JAX's under the same deterministic sampler."""
    monkeypatch.setattr(pdet, "random_sample", torch_rule)
    task = DetectionTask(_task_cfg(), det_overrides=_overrides(), device="cpu")
    model = task.model
    model.load_state_dict(_port(oracle).state_dict())
    batch = {k: _t(v) for k, v in oracle["batch"].items()}
    total, metrics = task.loss_fn(model, batch, torch.Generator(), deterministic=True)
    for k, want in oracle["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), want, rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(total), oracle["total"], rtol=1e-5)
    total.backward()
    want = detector_from_jax({"params": oracle["grads"]}, BB)
    g_all = np.sqrt(sum(float((w.double() ** 2).sum()) for w in want.values()))
    assert g_all > 0
    for name, p in model.named_parameters():
        # each gradient to 1e-4 of its own norm, plus 1e-6 of all gradients'
        # for those that are zero up to rounding
        diff = float((p.grad - want[name]).norm())
        assert diff <= 1e-4 * float(want[name].norm()) + 1e-6 * g_all, \
            (name, diff, float(want[name].norm()))


def test_state_dict_round_trips_through_the_jax_converters(oracle):
    """The port's state dict through `convert_fpn_neck`, `convert_rpn_head`
    and `convert_bbox_head` gives back the JAX params: this pins the CHW
    (port) ↔ HWC (JAX) permutation of shared_fcs.0."""
    sd = {k: v.numpy() for k, v in _port(oracle).state_dict().items()}
    p = oracle["variables"]["params"]
    same = lambda a, b: jax.tree.map(np.testing.assert_array_equal, a, b)
    same(convert_fpn_neck(sd, n_lateral=4), p["neck"])
    same(convert_rpn_head(sd), p["rpn_head"])
    trunk, cls, reg = convert_bbox_head(sd, roi_size=7)
    same((trunk, cls, reg), (p["bbox_trunk"], p["fc_cls"], p["fc_reg"]))
    assert set(detector_from_jax(oracle["variables"], BB)) == set(_port(oracle).state_dict())


# ------------------------------------------------------------------- task --

def _overrides():
    return {k: v for k, v in SMALL.items() if k != "num_classes"}


def _task_cfg():
    return TaskConfig(task="detection_h", num_classes=3, backbone=BB,
                      train=TrainConfig(batch_size=2, mesh=MeshConfig(data=1),
                                        optimizer=OptimizerConfig(lr=1e-3, clip_norm=0.0),
                                        schedule=ScheduleConfig(kind="constant")))


def test_task_fit_and_evaluate_on_the_cpu():
    """Two steps of `fit` from `init_state` (the real sampler, drop rates
    0), finite metrics that move the weights, then `evaluate`'s VOC AP50
    and, with `coco=True`, the 12 COCO bbox stats; the task builds every
    head JAX's does and refuses others."""
    task = DetectionTask(_task_cfg(), det_overrides=_overrides(), device="cpu")
    state = task.init_state(torch.Generator().manual_seed(0))
    before = state.model.roi_head["bbox_head"].fc_cls.weight.detach().clone()
    logs = []
    batches = iter([make_batch(seed=5), make_batch(seed=6)])
    state, metrics = task.fit(state, batches, 2, log_every=1,
                              log_fn=lambda i, m: logs.append(m))
    assert len(logs) == 2 and state.step == 2
    for m in logs:
        assert {"loss", "grad_norm", "loss_rpn_cls", "loss_rpn_bbox", "loss_cls",
                "loss_bbox", "acc", "data_time", "step_time"} <= set(m)
        assert all(np.isfinite(v) for v in m.values()), m
    assert not torch.equal(before, state.model.roi_head["bbox_head"].fc_cls.weight)
    res = task.evaluate(state, iter([make_batch(seed=7)]))
    assert 0.0 <= res["mAP"] <= 100.0 and len(res["AP"]) == 3
    coco = task.evaluate(state, iter([make_batch(seed=7)]), coco=True)
    assert len(coco) == 12 and all(-1.0 <= v <= 100.0 for v in coco.values())
    assert DetectionTask(_task_cfg(), head="mask_rcnn", device="cpu").det.with_mask
    with pytest.raises(ValueError, match="head"):
        DetectionTask(_task_cfg(), head="cascade_rcnn", device="cpu")


def test_task_defaults_to_the_card():
    assert DetectionTask(_task_cfg(), det_overrides=_overrides()).device.type == "cuda"


def test_box_head_init_draws_as_flax():
    """`init_weights` draws the box head's Linear layers with flax's Dense
    default (lecun-normal: variance 1/fan_in), not the ViT's trunc-normal
    0.02; biases 0."""
    model = init_weights(TwoStageDetector(BB, DetConfig(**SMALL)),
                         torch.Generator().manual_seed(0))
    fc1 = model.roi_head["bbox_head"].shared_fcs[0]
    np.testing.assert_allclose(fc1.weight.std().item(), np.sqrt(1 / fc1.in_features),
                               rtol=0.05)
    assert not fc1.bias.any()
