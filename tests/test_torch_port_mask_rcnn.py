"""The port's Mask R-CNN against the JAX package's at toy widths (the ViT+RVSA
of `test_torch_port_detection`: img_size 64, embed_dim 32, depth 2; and a
small InternImage for the XL variant): the atlas RoIAlign at one level
against JAX's single-level `roi_align` and `roi_align_rotated`, with their
feature gradients, `mask_targets_from_crops`,
the FCN mask trunk (each upsample) and `mask_head_loss` with its gradient,
the detector's mask logits, `det_predict_core`'s detections and mask logits
(through the task's `predict_fn`), `det_loss_core`'s mask branch (the
losses and every parameter gradient with box-aligned crops; the losses with
stride-4 masks), the host and device mask pastes, and the task's `fit` and
`evaluate(coco=True)` on the CPU.

JAX weights are carried to the port by `ckpt.from_jax.detector_from_jax`;
fp32 on both sides; inputs made with numpy from a seed.  Both packages'
`random_sample` is replaced, in this test only, by the deterministic rule
of `test_torch_port_detection`.  The JAX oracles are computed once, in a
module-scoped fixture.  Tolerances: outputs and losses 1e-5 (absolute and
relative: fp32 sums in other orders); each gradient within 1e-4 of its own
norm plus 1e-6 of all gradients' norm; `paste_masks` and
`crop_masks_to_boxes` bitwise (the same numpy operations)."""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from mtp_tpu.ckpt.full_convert import convert_mask_trunk
from mtp_tpu.eval import masks as jmasks
from mtp_tpu.heads import roi_heads as jrh
from mtp_tpu.models import detector as jdetector
from mtp_tpu.models import internimage as ji
from mtp_tpu.models.detector import DetConfig as JDetConfig
from mtp_tpu.models.detector import TwoStageDetector as JDetector
from mtp_tpu.ops import roi_align as jra
from mtp_tpu.ops.assign import SampleResult as JSampleResult
from mtp_tpu.tasks import detection as jdet
from mtp_tpu.utils.config import (MeshConfig, OptimizerConfig, ScheduleConfig,
                                  TaskConfig, TrainConfig)
from mtp_tpu_torch import config as pc
from mtp_tpu_torch.ckpt.from_jax import _conv, _deconv, detector_from_jax
from mtp_tpu_torch.eval import masks as pmasks
from mtp_tpu_torch.heads.roi_heads import FCNMaskTrunk, MaskHead, mask_head_loss
from mtp_tpu_torch.models.detector import DetConfig, TwoStageDetector
from mtp_tpu_torch.ops import assign as passign
from mtp_tpu_torch.ops.roi_align import multilevel_roi_align_fused
from mtp_tpu_torch.tasks import detection as pdet
from mtp_tpu_torch.tasks.detection_task import DetectionTask
from test_torch_port_detection import (BB, ROI_BIDX, ROIS, _randomise, _t, jax_rule,
                                       make_batch, torch_rule)

torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-5
SIZE, G, CROP = 64, 8, 56
SMALL = dict(num_classes=3, nms_pre=256, max_proposals=64, rpn_num=64, rcnn_num=32,
             max_per_img=16, max_gts=G, with_mask=True)
TINY_XL = dataclasses.replace(ji.internimage_xl(), channels=16, depths=(1, 1, 2, 1),
                              groups=(2, 4, 8, 16), layer_scale=0.5, dtype="float32",
                              drop_path_rate=0.0)
PORT_XL = pc.InternImageConfig(**dataclasses.asdict(TINY_XL))


def mask_batch(B=2, seed=0):
    """`make_batch` with each gt's mask: a random blob inside its box, as
    box-aligned 56² crops (`crop_masks_to_boxes`) and at stride 4."""
    batch = make_batch(B, seed)
    rng = np.random.default_rng(seed + 100)
    full = np.zeros((B, G, SIZE, SIZE), np.float32)
    for b in range(B):
        for g in range(G):
            x1, y1, x2, y2 = np.round(batch["gt_boxes"][b, g]).astype(int)
            x2, y2 = min(x2, SIZE), min(y2, SIZE)
            full[b, g, y1:y2, x1:x2] = rng.uniform(size=(y2 - y1, x2 - x1)) > 0.35
    batch["gt_mask_crops"] = np.stack([jmasks.crop_masks_to_boxes(
        full[b], batch["gt_boxes"][b], CROP) for b in range(B)])
    batch["gt_masks"] = full[:, :, 2::4, 2::4]
    return batch


def _grads_close(model, want: dict) -> None:
    g_all = np.sqrt(sum(float((w.double() ** 2).sum()) for w in want.values()))
    assert g_all > 0
    for name, p in model.named_parameters():
        diff = float((p.grad - want[name]).norm())
        assert diff <= 1e-4 * float(want[name].norm()) + 1e-6 * g_all, \
            (name, diff, float(want[name].norm()))


def _with_mask_head(params: dict, rng_seed: int = 1) -> dict:
    """`test_torch_port_detection`'s weights (its draws of non-zero biases,
    from the same generator over the same leaves) with the mask trunk and
    conv_logits drawn after them.  Drawn over the whole tree instead, the
    biases put one of the box head's fc1 inputs to ReLU 9.5e-7 from 0,
    where fp32 sums in two orders can fall on either side: every gradient
    below it then moved ~5e-4 of its norm, on a discrete difference, not a
    rounding one."""
    mask_keys = ("mask_trunk", "conv_logits")
    rng = np.random.default_rng(rng_seed)
    out = dict(_randomise({k: v for k, v in params.items() if k not in mask_keys}, rng))
    out.update(_randomise({k: params[k] for k in mask_keys}, rng))
    return out


def _jax_loss(model, v, batch, anchors, grad: bool = True):
    """(total, metrics) and, with `grad`, the gradients, under the rule."""
    loss = lambda p, b: jdet.detection_loss(model, {"params": p}, b,
                                            jax.random.PRNGKey(3), anchors)
    with mock.patch.object(jdet, "random_sample", jax_rule):
        fn = jax.value_and_grad(loss, has_aux=True) if grad else loss
        return jax.jit(fn)(v["params"], jax.tree.map(jnp.asarray, batch))


@pytest.fixture(scope="module")
def oracle():
    """The JAX Mask R-CNN (toy widths, non-zero biases) and what the tests
    compare: the mask logits on ROIS, the detections with their mask
    logits, the loss and its gradients with crops, and the losses with
    stride-4 masks, under the deterministic sampler."""
    det = JDetConfig(**SMALL)
    model = JDetector(BB, det)
    batch = mask_batch()
    img = jnp.asarray(batch["image"])
    params = dict(jax.jit(model.init)(jax.random.PRNGKey(0), img[:1])["params"])
    v = {"params": _with_mask_head(params)}
    anchors = jdet.anchors_for(det, (SIZE, SIZE))

    @jax.jit
    def forward(v, img):
        feats = model.apply(v, img, method=JDetector.features)
        ml = model.apply(v, feats, jnp.asarray(ROIS), jnp.asarray(ROI_BIDX),
                         method=JDetector.mask_head_logits)
        return ml, jdet.detection_predict(model, v, img, anchors)

    mask_logits, dets = forward(v, img)
    (total, mets), grads = _jax_loss(model, v, batch, anchors)
    legacy = {k: x for k, x in batch.items() if k != "gt_mask_crops"}
    _, legacy_mets = _jax_loss(model, v, legacy, anchors, grad=False)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return dict(variables=to_np(v), batch=batch, mask_logits=np.asarray(mask_logits),
                dets=to_np(dets), total=float(total),
                metrics={k: float(x) for k, x in mets.items()}, grads=to_np(grads),
                legacy={k: float(x) for k, x in legacy_mets.items()})


def _port(oracle, backbone=BB, variables=None):
    model = TwoStageDetector(backbone, DetConfig(**SMALL))
    model.load_state_dict(detector_from_jax(variables or oracle["variables"], backbone))
    return model


# ------------------------------------------------------------------- ops --

def _feat_and_rois(rotated: bool, seed: int = 5):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((2, 13, 17, 5)).astype(np.float32)
    if rotated:
        rois = np.concatenate([rng.uniform(-4, 70, (9, 2)), rng.uniform(2, 40, (9, 2)),
                               rng.uniform(-1.6, 1.6, (9, 1))], 1).astype(np.float32)
    else:
        xy = rng.uniform(-6, 60, (9, 2))
        rois = np.concatenate([xy, xy + rng.uniform(0.5, 40, (9, 2))], 1).astype(np.float32)
    return feat, rois, rng.integers(0, 2, 9).astype(np.int32), \
        rng.standard_normal((9, 7, 7, 5)).astype(np.float32)


@pytest.mark.parametrize("kind", ["horizontal", "rotated", "horizontal, 1 sample a bin",
                                  "rotated, 1 sample a bin"])
def test_single_level_roi_align_and_its_feature_gradient_match_jax(kind):
    """The atlas form at one level of stride 4 against JAX's single-level
    roi_align at scale 0.25: border padding, align_corners over (W-1), 2×2
    (or 1) samples a bin, RoIs partly off the map; the rotated form about
    the box centre, clockwise, as the legacy mask targets call it."""
    rotated = kind.startswith("rotated")
    sampling = 1 if kind.endswith("bin") else 2
    feat, rois, bidx, cot = _feat_and_rois(rotated)
    if rotated:
        jfn = lambda f: jra.roi_align_rotated(f, jnp.asarray(rois), jnp.asarray(bidx), 7,
                                              0.25, sampling, clockwise=True)
    else:
        jfn = lambda f: jra.roi_align(f, jnp.asarray(rois), jnp.asarray(bidx), 7, 0.25,
                                      sampling)
    pfn = lambda f: multilevel_roi_align_fused(
        [f.permute(0, 3, 1, 2)], _t(rois), _t(bidx), 7, (4,), sampling,
        rotated=rotated).permute(0, 2, 3, 1)
    want, vjp = jax.vjp(jfn, jnp.asarray(feat))
    (want_g,) = vjp(jnp.asarray(cot))
    f = _t(feat).requires_grad_()
    got = pfn(f)
    (got * _t(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(want_g), atol=ATOL, rtol=RTOL)


def test_mask_targets_from_crops_match_jax():
    """Zero padding and align_corners=False over 56² crops; RoIs larger and
    smaller than their gt box, and off it."""
    rng = np.random.default_rng(7)
    crops = (rng.uniform(size=(2, 4, CROP, CROP)) > 0.5).astype(np.float32)
    xy = rng.uniform(0, 40, (2, 4, 2))
    gt_boxes = np.concatenate([xy, xy + rng.uniform(4, 30, (2, 4, 2))], -1).astype(np.float32)
    flat_gt = rng.integers(0, 8, 12).astype(np.int32)
    gb = gt_boxes.reshape(8, 4)[flat_gt]
    rois = (gb + rng.normal(0, 6, gb.shape)).astype(np.float32)
    rois[:, 2:] = np.maximum(rois[:, 2:], rois[:, :2] + 1)
    want = jdet.mask_targets_from_crops(jnp.asarray(crops), jnp.asarray(gt_boxes),
                                        jnp.asarray(rois), jnp.asarray(flat_gt), 28)
    got = pdet.mask_targets_from_crops(_t(crops), _t(gt_boxes), _t(rois),
                                       _t(flat_gt).long(), 28)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


class _JaxMaskHead(nn.Module):
    upsample: str

    @nn.compact
    def __call__(self, x):
        x = jrh.FCNMaskTrunk(8, upsample=self.upsample, name="trunk")(x)
        return nn.Conv(3, (1, 1), dtype=jnp.float32, name="conv_logits")(x)


@pytest.mark.parametrize("upsample", ["deconv", "nearest", "bilinear"])
def test_mask_trunk_matches_jax(upsample):
    """The four 3×3 convolutions and each upsample, then conv_logits; the
    port's NCHW (R, K, m, m) against JAX's (R, m, m, K)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((5, 14, 14, 6)).astype(np.float32)
    params = _randomise(_JaxMaskHead(upsample).init(jax.random.PRNGKey(2), x)["params"], rng)
    want = _JaxMaskHead(upsample).apply({"params": params}, x)
    sd = {}
    for i in range(4):
        _conv(sd, f"convs.{i}.conv", jax.tree.map(np.asarray, params["trunk"][f"conv_{i}"]))
    if upsample == "deconv":
        _deconv(sd, "upsample", jax.tree.map(np.asarray, params["trunk"]["upsample"]))
    _conv(sd, "conv_logits", jax.tree.map(np.asarray, params["conv_logits"]))
    head = MaskHead(3, 6, 8, upsample=upsample)
    head.load_state_dict(sd)
    with torch.no_grad():
        got = head(_t(x).permute(0, 3, 1, 2))
    assert got.shape == (5, 3, 28, 28)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def test_carafe_upsample_names_its_roadmap_item():
    """CARAFE, once a ROADMAP item, is ported (`ops/carafe.py`;
    tests/test_torch_port_carafe_patch8.py holds it against JAX): the trunk
    builds mmcv's `CARAFEPack` as its `upsample`, and an unknown upsample
    raises."""
    from mtp_tpu_torch.ops.carafe import CARAFEPack
    trunk = FCNMaskTrunk(upsample="carafe")
    assert isinstance(trunk.upsample, CARAFEPack)
    assert trunk(torch.zeros(2, 256, 14, 14)).shape == (2, 256, 28, 28)
    with pytest.raises(ValueError, match="unknown upsample"):
        FCNMaskTrunk(upsample="pixel_shuffle")


def test_mask_head_loss_and_its_gradient_match_jax():
    """BCE on the gt class's channel (axis 1 in the port, the last in JAX),
    averaged over the positive slots; labels of negative slots are -1."""
    rng = np.random.default_rng(13)
    R, K, m = 10, 4, 28
    logits = (rng.standard_normal((R, K, m, m)) * 3).astype(np.float32)
    targets = rng.uniform(size=(R, m, m)).astype(np.float32)
    is_pos = np.arange(R) < 6
    labels = np.where(is_pos, rng.integers(0, K, R), -1).astype(np.int32)
    gt = np.zeros(R, np.int32)
    jsample = JSampleResult(jnp.arange(R), jnp.asarray(is_pos), jnp.ones(R, bool),
                            jnp.asarray(gt), jnp.asarray(labels))
    loss_fn = lambda z: jrh.mask_head_loss(z, jnp.asarray(targets), jsample)["loss_mask"]
    want, want_g = jax.value_and_grad(loss_fn)(jnp.asarray(logits.transpose(0, 2, 3, 1)))
    z = _t(logits).requires_grad_()
    psample = passign.SampleResult(torch.arange(R), _t(is_pos), torch.ones(R, dtype=bool),
                                   _t(gt).long(), _t(labels).long())
    got = mask_head_loss(z, _t(targets), psample)["loss_mask"]
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(z.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_g),
                               atol=1e-7, rtol=RTOL)


# ----------------------------------------------------------------- model --

def test_mask_logits_match_jax(oracle):
    model = _port(oracle)
    with torch.no_grad():
        feats = model.features(_t(oracle["batch"]["image"]))
        got = model.mask_head_logits(feats, _t(ROIS), _t(ROI_BIDX))
    assert got.dtype == torch.float32 and got.shape == (6, 3, 28, 28)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), oracle["mask_logits"],
                               atol=ATOL, rtol=RTOL)


def _task(**kw):
    cfg = TaskConfig(task="instseg", num_classes=3, backbone=BB,
                     train=TrainConfig(batch_size=2, mesh=MeshConfig(data=1),
                                       optimizer=OptimizerConfig(lr=1e-3, clip_norm=0.0),
                                       schedule=ScheduleConfig(kind="constant")))
    ov = {k: v for k, v in SMALL.items() if k not in ("num_classes", "with_mask")}
    return DetectionTask(cfg, head="mask_rcnn", det_overrides={**ov, **kw}, device="cpu")


def test_predict_with_masks_matches_jax(oracle):
    """Keep sets index for index, and each detection's mask logits of its
    class."""
    task = _task()
    task.model.load_state_dict(_port(oracle).state_dict())
    dets = task.predict_fn()(_t(oracle["batch"]["image"]))
    want = oracle["dets"]
    assert bool(dets.valid.any()) and dets.mask_logits.shape == (2, 16, 28, 28)
    np.testing.assert_array_equal(dets.valid.numpy(), want.valid)
    np.testing.assert_array_equal(dets.labels.numpy(), want.labels)
    np.testing.assert_allclose(dets.scores.numpy(), want.scores, atol=ATOL, rtol=RTOL)
    # boxes decoded through exp() of deltas from 1024-wide fp32 sums: to
    # 5e-4 px of a 64 px image
    np.testing.assert_allclose(dets.boxes.numpy(), want.boxes, atol=5e-4, rtol=RTOL)
    np.testing.assert_allclose(dets.mask_logits.numpy(), want.mask_logits, atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("mode", ["crops", "stride-4 masks"])
def test_loss_and_gradients_match_jax(oracle, mode, monkeypatch):
    """`det_loss_core` with the mask branch through the task's `loss_fn`:
    every loss (loss_mask included) and, with crops, every parameter's
    gradient (the mask trunk's and conv_logits' included)."""
    monkeypatch.setattr(pdet, "random_sample", torch_rule)
    task = _task()
    model = task.model
    model.load_state_dict(_port(oracle).state_dict())
    batch = {k: _t(v) for k, v in oracle["batch"].items()
             if not (mode != "crops" and k == "gt_mask_crops")}
    total, metrics = task.loss_fn(model, batch, torch.Generator(), deterministic=True)
    want = oracle["metrics"] if mode == "crops" else oracle["legacy"]
    assert "loss_mask" in metrics
    for k, w in want.items():
        np.testing.assert_allclose(float(metrics[k]), w, rtol=1e-5, atol=1e-6, err_msg=k)
    if mode != "crops":
        return
    np.testing.assert_allclose(float(total), oracle["total"], rtol=1e-5)
    total.backward()
    _grads_close(model, detector_from_jax({"params": oracle["grads"]}, BB))


def test_state_dict_round_trips_through_the_jax_mask_converter(oracle):
    """The port's mask head through `convert_mask_trunk` gives back the JAX
    convolutions; the ConvTranspose kernel comes back flipped in both
    spatial axes, because `convert_mask_trunk` does not flip it as
    `convert_backbone` does the simple FPN's (the port's `_deconv` does)."""
    sd = {k: v.numpy() for k, v in _port(oracle).state_dict().items()}
    want = oracle["variables"]["params"]["mask_trunk"]
    got = convert_mask_trunk(sd)
    for i in range(4):
        jax.tree.map(np.testing.assert_array_equal, got[f"conv_{i}"], want[f"conv_{i}"])
    np.testing.assert_array_equal(got["upsample"]["kernel"][::-1, ::-1],
                                  want["upsample"]["kernel"])
    np.testing.assert_array_equal(got["upsample"]["bias"], want["upsample"]["bias"])
    assert set(detector_from_jax(oracle["variables"], BB)) == set(_port(oracle).state_dict())


def test_xl_mask_rcnn_matches_jax_at_toy_size(monkeypatch):
    """`mask_rcnn_intern_xl_1024_coco`'s model shape (InternImage's
    pyramid of doubling widths) at toy size: FPN levels, mask logits and
    the losses; the JAX side builds this small InternImage in place of
    XL."""
    det = JDetConfig(**SMALL)
    batch = mask_batch(seed=3)
    img = jnp.asarray(batch["image"])
    with mock.patch.object(jdetector, "build_backbone",
                           lambda cfg, name="backbone": ji.InternImage(TINY_XL, name=name)):
        model = JDetector(BB, det)
        params = dict(jax.jit(model.init)(jax.random.PRNGKey(4), img[:1])["params"])
        v = {"params": _with_mask_head(params, 5)}
        want_ml = jax.jit(lambda v, x: model.apply(
            v, model.apply(v, x, method=JDetector.features), jnp.asarray(ROIS),
            jnp.asarray(ROI_BIDX), method=JDetector.mask_head_logits))(v, img)
        _, want = _jax_loss(model, v, batch, jdet.anchors_for(det, (SIZE, SIZE)),
                            grad=False)
    variables = jax.tree.map(np.asarray, v)
    monkeypatch.setattr(pdet, "random_sample", torch_rule)
    task = _task()
    task.model = _port(None, PORT_XL, variables)
    with torch.no_grad():
        feats = task.model.features(_t(batch["image"]))
        got_ml = task.model.mask_head_logits(feats, _t(ROIS), _t(ROI_BIDX))
        _, metrics = task.loss_fn(task.model, {k: _t(x) for k, x in batch.items()},
                                  torch.Generator(), deterministic=True)
    np.testing.assert_allclose(got_ml.permute(0, 2, 3, 1).numpy(), np.asarray(want_ml),
                               atol=ATOL, rtol=RTOL)
    for k, w in want.items():
        np.testing.assert_allclose(float(metrics[k]), float(w), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


# ----------------------------------------------------------------- masks --

def _paste_inputs(seed=17):
    rng = np.random.default_rng(seed)
    probs = rng.uniform(size=(7, 28, 28)).astype(np.float32)
    xy = rng.uniform(-10, 50, (7, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.4, 40, (7, 2))], 1).astype(np.float32)
    boxes[0] = (5, 5, 5.5, 30)                      # narrower than a pixel
    boxes[1] = (70, 70, 90, 90)                     # outside the image
    return probs, boxes


def test_paste_and_crop_are_bitwise_jax_s():
    probs, boxes = _paste_inputs()
    np.testing.assert_array_equal(pmasks.paste_masks(probs, boxes, 48, 56),
                                  jmasks.paste_masks(probs, boxes, 48, 56))
    full = (np.random.default_rng(19).uniform(size=(7, 48, 56)) > 0.5).astype(np.uint8)
    np.testing.assert_array_equal(pmasks.crop_masks_to_boxes(full, boxes, 56),
                                  jmasks.crop_masks_to_boxes(full, boxes, 56))


def test_device_paste_matches_the_host_paste_off_the_threshold():
    """`paste_masks_device` (here on CPU tensors) gives the host paste's
    pixels wherever its probability lies more than 1e-6 from 0.5."""
    probs, boxes = _paste_inputs(23)
    got = pmasks.paste_masks_device(_t(probs), _t(boxes), 48, 56).numpy()
    want = pmasks.paste_masks(probs, boxes, 48, 56)
    near = np.abs(pmasks.mask_probabilities(_t(probs), _t(boxes), 48, 56).numpy()
                  - 0.5) <= 1e-6
    assert got.dtype == np.uint8 and want.sum() > 0
    np.testing.assert_array_equal(got[~near], want[~near])


def test_task_fit_and_coco_evaluate_on_the_cpu():
    """Two steps of `fit` from `init_state` (the real sampler) with
    loss_mask finite, then `evaluate(coco=True)`: the 12 bbox stats and
    the 12 segm stats, from the pasted masks against the crops pasted
    back; the VOC protocol without `coco`."""
    task = _task(score_thr=0.0)
    state = task.init_state(torch.Generator().manual_seed(0))
    before = state.model.roi_head["mask_head"].conv_logits.weight.detach().clone()
    logs = []
    state, _ = task.fit(state, iter([mask_batch(seed=5), mask_batch(seed=6)]), 2,
                        log_every=1, log_fn=lambda i, m: logs.append(m))
    assert all(np.isfinite(m["loss_mask"]) for m in logs)
    assert not torch.equal(before, state.model.roi_head["mask_head"].conv_logits.weight)
    with mock.patch("mtp_tpu_torch.tasks.detection_task.paste_masks",
                    wraps=pmasks.paste_masks) as spy:
        res = task.evaluate(state, iter([mask_batch(seed=7)]), coco=True)
    assert spy.call_count == 4  # detections and gts of 2 images
    keys = ["mAP", "AP50", "AP75", "AP_s", "AP_m", "AP_l", "AR_s", "AR_m", "AR_l",
            "AR@1", "AR@10", "AR@100"]
    assert set(res) == set(keys) | {f"segm_{k}" for k in keys}
    assert all(-1.0 <= x <= 100.0 for x in res.values())
    voc = task.evaluate(state, iter([mask_batch(seed=7)]))
    assert 0.0 <= voc["mAP"] <= 100.0 and len(voc["AP"]) == 3
