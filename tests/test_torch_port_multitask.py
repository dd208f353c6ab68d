"""The port's multitask pretraining against the JAX package's at toy widths
(the ViT+RVSA of `test_torch_port_detection`: img_size 64, embed_dim 32,
depth 2; and `TINY_XL` of `test_torch_port_mask_rcnn` for the InternImage
variant), classes (4, 5, 6) and small `det_overrides`: the 9-way loss,
every named loss and every parameter gradient of
`MultiTaskPretrainModel.loss` (the sequential detection branches and
`det_multi=True`, box-aligned gt mask crops and stride-4 gt masks), the ss
trunk's BatchNorm statistics after the three per-dataset passes, `predict`
for each dataset, the 9-way `evaluate` on given detections, the task
subsets, `allocate_batch_sizes`, the state dict through JAX's
`convert_multitask_checkpoint`, both JAX encoder layouts through
`multitask_from_jax`, and the encoder export loading into a finetune task.

JAX weights are carried to the port by `ckpt.from_jax.multitask_from_jax`;
fp32 on both sides; inputs made with numpy from a seed.  Both packages'
`random_sample` is replaced, in this test only, by the deterministic rule
of `test_torch_port_detection`, and both sides take one numpy-made
Dropout2d channel mask a dataset (JAX's `jax.random.bernoulli` and the
port's `dropout2d` patched), the port's RPN assignment
(`port_rpn_assign`) and JAX's proposals (`jax_proposals`); JAX's
BatchNorm computes its variance in two passes (`TWO_PASS_BATCHNORM`).  The concatenated detection form computes the
sequential form's function, so JAX's sequential run is its oracle too.  The
JAX oracles are computed once, in module-scoped fixtures, one jitted
program a configuration.  Tolerances as `test_torch_port_mask_rcnn`'s:
losses 1e-5 absolute and relative; each gradient within 1e-4 of its own
norm plus 1e-6 of all gradients' norm."""

import dataclasses
import functools
from unittest import mock

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.ckpt.full_convert import convert_multitask_checkpoint
from mtp_tpu.ckpt.torch_convert import to_scan_layout, to_stage_scan_layout
from mtp_tpu.models import internimage as ji
from mtp_tpu.models import multitask as jmt
from mtp_tpu.tasks import detection as jdet
from mtp_tpu.tasks import multitask as jtask
from mtp_tpu.utils.config import (MeshConfig, OptimizerConfig, ScheduleConfig,
                                  TaskConfig, TrainConfig)
from mtp_tpu_torch.ckpt.from_jax import multitask_from_jax
from mtp_tpu_torch.ckpt.store import load_encoder
from mtp_tpu_torch.ckpt.torch_convert import (UNUSED_MULTITASK_KEYS, backbone_state_dict,
                                              load_torch_checkpoint, multitask_state_dict)
from mtp_tpu_torch.models import multitask as pmt
from mtp_tpu_torch.models.multitask import MultiTaskPretrainModel
from mtp_tpu_torch.ops import assign as passign
from mtp_tpu_torch.ops.rotated_boxes import rbox_to_hbox
from mtp_tpu_torch.tasks import detection as pdet
from mtp_tpu_torch.tasks import multitask as ptask
from mtp_tpu_torch.tasks.multitask import MultiTaskPretrainTask, allocate_batch_sizes
from mtp_tpu_torch.tasks.segmentation import SegmentationTask
from test_torch_port_detection import BB, _randomise, _t, jax_rule, torch_rule
from test_torch_port_mask_rcnn import PORT_XL, TINY_XL
from test_torch_port_oriented import stubbed_launches  # noqa: F401 (a fixture)

torch.set_num_threads(1)

SIZE, G, CROP = 64, 6, 56
CLASSES = (4, 5, 6)
OVERRIDES = dict(nms_pre=128, max_proposals=32, rpn_num=32, rcnn_num=16, max_per_img=8)
SIZES = {"vit": (1, 2, 1), "xl": (1, 1, 1)}   # images a dataset
KEEP = 0.9                                     # Dropout2d(0.1)


def _cfg(backbone=BB, **opt) -> TaskConfig:
    return TaskConfig(task="multitask", num_classes=0, backbone=backbone,
                      train=TrainConfig(batch_size=3, mesh=MeshConfig(data=1),
                                        optimizer=OptimizerConfig(lr=1e-3, **opt),
                                        schedule=ScheduleConfig(kind="constant")))


def make_batches(sizes, seed=0):
    """One dict a dataset: images, ss labels with an ignored band, 3 valid
    horizontal and rotated gts among G, each horizontal gt's mask (an
    ellipse in its box) as 56² box-aligned crops and at stride 4."""
    from mtp_tpu_torch.eval.masks import crop_masks_to_boxes
    rng = np.random.default_rng(seed)
    out = []
    for d, B in enumerate(sizes):
        xy = rng.uniform(4, 40, (B, G, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(8, 24, (B, G, 2))], -1)
        valid = np.zeros((B, G), bool)
        valid[:, :3] = True
        label = rng.integers(0, CLASSES[d], (B, SIZE, SIZE))
        label[:, :, :6] = 255
        # each mask an ellipse in its box, axes 60-100% of the box's
        ys, xs = np.mgrid[0:SIZE, 0:SIZE] + 0.5
        c = (boxes[..., :2] + boxes[..., 2:]) / 2
        ax = (boxes[..., 2:] - boxes[..., :2]) / 2 * rng.uniform(0.6, 1.0, (B, G, 2))
        full = (((xs - c[..., 0, None, None]) / ax[..., 0, None, None]) ** 2
                + ((ys - c[..., 1, None, None]) / ax[..., 1, None, None]) ** 2
                <= 1).astype(np.float32)
        out.append({
            "image": rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32),
            "ss_label": label.astype(np.int32),
            "gt_boxes": boxes.astype(np.float32),
            "gt_labels": rng.integers(0, CLASSES[d] - 1, (B, G)).astype(np.int32),
            "gt_valid": valid,
            "gt_mask_crops": np.stack([crop_masks_to_boxes(full[b], boxes[b], CROP)
                                       for b in range(B)]),
            "gt_masks": full[:, :, 2::4, 2::4],
            "r_gt_boxes": np.stack([rng.uniform(16, 48, (B, G)), rng.uniform(16, 48, (B, G)),
                                    rng.uniform(10, 24, (B, G)), rng.uniform(5, 12, (B, G)),
                                    rng.uniform(-1.2, 1.2, (B, G))], -1).astype(np.float32),
            "r_gt_labels": rng.integers(0, CLASSES[d] - 1, (B, G)).astype(np.int32),
            "r_gt_valid": valid,
        })
    return out


def drop_masks(sizes, seed=50):
    """Each dataset's Dropout2d keep mask (B_d, 1, 1, 256)."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=(B, 1, 1, 256)) < KEEP for B in sizes]


def _without(batches, key):
    return [{k: v for k, v in b.items() if k != key} for b in batches]


def port_rpn_assign(anchors, gt_boxes, gt_valid, gt_labels, *thresholds):
    """JAX's RPN assigner replaced by the port's, run on the host: a gt
    inside several anchors of one shape has the same IoU with each in exact
    arithmetic, and the low-quality rule (`ious == gt_max`) takes whichever
    the fp32 rounding puts at the top.  JAX's jitted program rounds those
    IoUs otherwise than its eager ops (in one rotated gt of these batches,
    six anchors flip between ignored and positive), and the port rounds as
    the eager ops; `test_rpn_assignment_matches_jax_eager` holds the
    assigner itself, ties included."""
    A = anchors.shape[0]
    shapes = (jax.ShapeDtypeStruct((A,), jnp.int32), jax.ShapeDtypeStruct((A,), jnp.float32),
              jax.ShapeDtypeStruct((A,), jnp.int32))

    def host(a, g, v):
        r = passign.max_iou_assign(_t(a), _t(g), _t(v), None, *thresholds)
        return (r.gt_inds.numpy().astype(np.int32), r.max_ious.numpy(),
                r.labels.numpy().astype(np.int32))
    return jdet.AssignResult(*jax.pure_callback(host, shapes, anchors, gt_boxes, gt_valid,
                                                vmap_method="sequential"))


# flax's BatchNorm computes the batch variance as E[x²] − E[x]² by default
# (`use_fast_variance`), which cancels where a channel's mean is large
# against its spread: the ss trunk's BatchNorms see one or two images here
# (the recipe's one a dataset), and the JAX decode head's gradients then lie
# up to 2.1e-3 (the PSP pool-1 branch's 6.6e-3, pos_embed's 2.3e-4) from a
# float64 run of the port, where the port's fp32 ones (two passes: the mean,
# then the mean of squared deviations) lie within 1.2e-4 (3e-6 but for the
# pool-1 branch).  The oracle's BatchNorm computes the same function in two
# passes.
TWO_PASS_BATCHNORM = functools.partial(flax.linen.BatchNorm, use_fast_variance=False)


def port_rbox_to_hbox(rboxes):
    """JAX's rbox_to_hbox of the gts replaced by the port's, run on the host:
    the assigner's ties above follow the last bit of the bounding boxes,
    whose cos and sin JAX and torch round apart."""
    return jax.pure_callback(
        lambda r: rbox_to_hbox(_t(r)).numpy(),
        jax.ShapeDtypeStruct(rboxes.shape[:-1] + (4,), jnp.float32), rboxes,
        vmap_method="sequential")


def _jax_loss_fn(model, masks):
    """(params, batch_stats, batches) → ((total, losses), new batch_stats)
    under the rule and the given Dropout2d masks."""
    anchors = jdet.anchors_for(None, (SIZE, SIZE))

    def fn(params, stats, batches):
        it = iter(masks)

        def bernoulli(key, p, shape):
            m = next(it)
            assert p == KEEP and shape == m.shape, (p, shape)
            return jnp.asarray(m)

        with mock.patch.object(jax.random, "bernoulli", bernoulli):
            (total, losses), upd = model.apply(
                {"params": params, "batch_stats": stats}, batches,
                jax.random.PRNGKey(1), anchors, False, method=jmt.MultiTaskPretrainModel.loss,
                rngs={"dropout": jax.random.PRNGKey(2)}, mutable=["batch_stats"])
        return total, (losses, upd["batch_stats"])
    return fn


def _jax_model(kind):
    model = jmt.MultiTaskPretrainModel(BB, CLASSES, dict(OVERRIDES))
    if kind == "xl":
        return model, mock.patch.object(
            jmt, "build_backbone", lambda cfg, name="encoder": ji.InternImage(TINY_XL, name=name))
    return model, mock.patch.object(jmt, "build_backbone", jmt.build_backbone)


def _oracle(kind):
    """The JAX model (non-zero biases), its loss, named losses, new batch
    statistics and gradients on box-aligned crops and, for the ViT, the
    losses on stride-4 masks and the predicts of each dataset."""
    sizes = SIZES[kind]
    batches, masks = make_batches(sizes, seed=3 if kind == "xl" else 0), drop_masks(sizes)
    model, patch = _jax_model(kind)
    with patch, mock.patch.object(jdet, "random_sample", jax_rule), \
            mock.patch.object(jdet, "max_iou_assign", port_rpn_assign), \
            mock.patch.object(jdet, "rbox_to_hbox", port_rbox_to_hbox), \
            mock.patch.object(flax.linen, "BatchNorm", TWO_PASS_BATCHNORM):
        variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                        jnp.zeros((2, SIZE, SIZE, 3), jnp.float32))
        params = _randomise(variables["params"], np.random.default_rng(1))
        stats = variables["batch_stats"]
        loss = _jax_loss_fn(model, masks)
        anchors = jdet.anchors_for(None, (SIZE, SIZE))

        @jax.jit
        def run(params, stats, crops, legacy):
            (total, (losses, new_stats)), grads = jax.value_and_grad(
                loss, has_aux=True)(params, stats, crops)
            props = [model.apply({"params": params, "batch_stats": stats}, b["image"],
                                 method=proposals) for b in crops]
            if legacy is None:
                return total, losses, new_stats, grads, props
            legacy_losses = loss(params, stats, legacy)[1][0]
            v = {"params": params, "batch_stats": stats}
            preds = [model.apply(v, crops[d]["image"], d, anchors,
                                 method=jmt.MultiTaskPretrainModel.predict)
                     for d in range(3)]
            return total, losses, new_stats, grads, props, legacy_losses, preds

        def proposals(m, images):
            """Each branch's proposals of `images`, as the loss and the
            predict make them (no drop rate, no BatchNorm before them)."""
            enc = m.encode(images)
            out = []
            for fwd, det in ((m.is_forward, m.det_h_cfgs[0]), (m.rd_forward, m.det_r_cfgs[0])):
                out.append(jdet.gen_proposals(
                    fwd(enc)[1], jnp.asarray(anchors), (SIZE, SIZE), det.nms_pre,
                    det.max_proposals, det.rpn_nms_iou, det.rotated,
                    level_sizes=jdet.anchor_level_sizes((SIZE, SIZE))))
            return out

        as_j = lambda bs: jax.tree.map(jnp.asarray, bs)
        out = run(params, stats, as_j(_without(batches, "gt_masks")),
                  None if kind == "xl" else as_j(_without(batches, "gt_mask_crops")))
    to_np = lambda t: jax.tree.map(np.asarray, t)
    res = dict(batches=batches, masks=masks,
               variables=to_np({"params": params, "batch_stats": stats}),
               total=float(out[0]), losses={k: float(x) for k, x in out[1].items()},
               stats=to_np(out[2]), grads=to_np(out[3]), props=to_np(out[4]))
    if kind == "vit":
        res["legacy"] = {k: float(x) for k, x in out[5].items()}
        res["preds"] = to_np(out[6])
    return res


def jax_proposals(oracle):
    """`gen_proposals` returning JAX's proposals, image by image in call
    order for each branch (Mask R-CNN's, Oriented R-CNN's), datasets 0-2,
    sequential or concatenated alike, and again for the next run.  From RPN outputs
    1e-5 apart, the random RPN's long thin rotated proposals differ by up to
    ~1e-3 px (`test_torch_port_oriented`), which moves RoIAlign's weights
    and the gradients through them by ~1e-3, and can put a degenerate
    (zero-height) proposal on the other side of an NMS decision; the port's
    own proposals are held by `test_torch_port_oriented` and
    `test_torch_port_detection`."""
    images = [(d, i) for d, b in enumerate(oracle["batches"]) for i in range(b["image"].shape[0])]
    taken = [0, 0]

    def fake(rpn_out, anchors, hw, nms_pre, max_props, iou, rotated, **kw):
        B, t = rpn_out.cls_scores.shape[0], int(rotated)
        take = [images[(taken[t] + j) % len(images)] for j in range(B)]
        taken[t] += B
        return tuple(torch.stack([_t(oracle["props"][d][t][k][i]) for d, i in take])
                     for k in (0, 1))
    return mock.patch.object(pdet, "gen_proposals", fake)


@pytest.fixture(scope="module")
def oracles():
    return {}


def _get(oracles, kind):
    if kind not in oracles:
        oracles[kind] = _oracle(kind)
    return oracles[kind]


def _backbone(kind):
    return PORT_XL if kind == "xl" else BB


def _port(oracle, kind, **kw):
    model = MultiTaskPretrainModel(_backbone(kind), CLASSES, OVERRIDES, **kw)
    model.load_state_dict(multitask_from_jax(oracle["variables"], _backbone(kind)))
    return model


def _task(model, **opt):
    return MultiTaskPretrainTask(_cfg(**opt), CLASSES, OVERRIDES, model=model, device="cpu")


def _port_dropout(masks):
    """`dropout2d` taking the given masks in call order."""
    it = iter(masks)

    def drop(x, rate, deterministic, generator):
        assert rate == pytest.approx(1 - KEEP) and not deterministic
        return torch.where(_t(next(it)), x / KEEP, 0.0)
    return mock.patch.object(pmt, "dropout2d", drop)


def _port_loss(oracle, kind, batches, **kw):
    model = _port(oracle, kind, **kw)
    task = _task(model)
    batch = {f"d{d}": {k: _t(v) for k, v in b.items()} for d, b in enumerate(batches)}
    with _port_dropout(oracle["masks"]), mock.patch.object(pdet, "random_sample", torch_rule), \
            jax_proposals(oracle):
        total, losses = task.loss_fn(model, batch, torch.Generator())
    return model, total, losses


def _losses_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), w, rtol=1e-5, atol=1e-5, err_msg=k)


# ----------------------------------------------------------------- loss --

# The small InternImage's mask trunk: against a float64 run of the port, the
# fp32 gradients of its first two convolutions lie 1.3e-3 to 1.6e-3 off in
# JAX and 1.2e-4 to 1.5e-4 in the port (14² RoIs of 4 images summed in the
# weight gradients, ReLU behind each): they are held at 2e-3, every other
# gradient at 1e-4.
MASK_TRUNK, XL_MASK_TRUNK_RTOL = "inssegdecoder.roi_head.mask_head.", 2e-3


@pytest.mark.parametrize("kind,det_multi", [("vit", False), ("vit", True), ("xl", False),
                                            ("xl", True)])
def test_loss_and_gradients_match_jax(oracles, kind, det_multi):
    """The 9-way loss, its 30 named losses (ss_d*, is_d*_loss_*, rd_d*_loss_*)
    and every parameter's gradient, with box-aligned gt mask crops, in the
    sequential form and the concatenated one (`det_multi`)."""
    oracle = _get(oracles, kind)
    model, total, losses = _port_loss(oracle, kind, _without(oracle["batches"], "gt_masks"),
                                      det_multi=det_multi)
    assert len(losses) == 3 + 3 * 5 + 3 * 4
    _losses_close(losses, oracle["losses"])
    np.testing.assert_allclose(float(total), oracle["total"], rtol=1e-5)
    total.backward()
    want = {k: v for k, v in multitask_from_jax(
        {"params": oracle["grads"], "batch_stats": oracle["stats"]},
        _backbone(kind)).items() if not k.endswith(("running_mean", "running_var",
                                                    "num_batches_tracked"))}
    assert set(want) == {n for n, _ in model.named_parameters()}
    g_all = np.sqrt(sum(float((w.double() ** 2).sum()) for w in want.values()))
    for name, p in model.named_parameters():
        rtol = XL_MASK_TRUNK_RTOL if kind == "xl" and name.startswith(MASK_TRUNK) else 1e-4
        diff = float((p.grad - want[name]).norm())
        assert diff <= rtol * float(want[name].norm()) + 1e-6 * g_all, \
            (name, diff, float(want[name].norm()))


def test_losses_with_stride_4_masks_match_jax(oracles):
    """The legacy mask targets (RoIAlign of the stride-4 gt masks)."""
    oracle = _get(oracles, "vit")
    _, _, losses = _port_loss(oracle, "vit", _without(oracle["batches"], "gt_mask_crops"))
    _losses_close(losses, oracle["legacy"])


def test_ss_batchnorm_statistics_after_a_step_match_jax(oracles):
    """The ss trunk runs once a dataset in train mode: its running
    statistics take three updates (0.9·running + 0.1·batch, the biased
    variance), as flax's do."""
    oracle = _get(oracles, "vit")
    model, _, _ = _port_loss(oracle, "vit", _without(oracle["batches"], "gt_masks"))
    want = multitask_from_jax({"params": oracle["variables"]["params"],
                               "batch_stats": oracle["stats"]}, BB)
    got = model.state_dict()
    stat_keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stat_keys) == 2 * 12
    for k in stat_keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=k)
        assert int(got[k.rsplit(".", 1)[0] + ".num_batches_tracked"]) == 3


# -------------------------------------------------------------- predict --

def _up_to_degenerate(a: np.ndarray, b: np.ndarray) -> int:
    """How many leading detections to compare: all of them for horizontal
    boxes; rotated ones up to the first of zero area (below 1e-3 px²) in
    either list.  The random RPN decodes some rotated proposals to zero
    height, whose rotated IoU with another such box is 0/0; the class-aware
    NMS's keep decision there is rounding on both sides (JAX's at its
    class-offset coordinates, ROADMAP queue 3), and every decision after
    it can follow from it."""
    if a.shape[-1] == 4:
        return len(a)
    small = (a[:, 2] * a[:, 3] < 1e-3) | (b[:, 2] * b[:, 3] < 1e-3)
    return int(np.argmax(small)) if small.any() else len(a)


@pytest.mark.parametrize("d", [0, 1, 2])
def test_predict_matches_jax(oracles, d):
    """Each dataset's ss class map and both detection heads' padded
    detections (with Mask R-CNN's mask logits) on JAX's proposals, index
    for index (the rotated ones up to a zero-area box, `_up_to_degenerate`)."""
    oracle = _get(oracles, "vit")
    task = _task(_port(oracle, "vit"))
    props = iter([tuple(map(_t, p)) for p in oracle["props"][d]])   # JAX's (`jax_proposals`)
    with torch.no_grad(), mock.patch.object(pdet, "gen_proposals", lambda *a, **k: next(props)):
        ss, det_h, det_r = task.predict_fn()(_t(oracle["batches"][d]["image"]), d)
    want_ss, want_h, want_r = oracle["preds"][d]
    np.testing.assert_array_equal(ss.numpy(), want_ss)
    for i in range(ss.shape[0]):
        for got, want in ((det_h, want_h), (det_r, want_r)):
            n = _up_to_degenerate(got.boxes[i].numpy(), want.boxes[i])
            assert n >= 1
            np.testing.assert_array_equal(got.valid[i, :n].numpy(), want.valid[i, :n])
            np.testing.assert_array_equal(got.labels[i, :n].numpy(), want.labels[i, :n])
            np.testing.assert_allclose(got.scores[i, :n].numpy(), want.scores[i, :n],
                                       atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(got.boxes[i, :n].numpy(), want.boxes[i, :n],
                                       atol=5e-4, rtol=1e-5)
    assert det_r.mask_logits is None
    np.testing.assert_allclose(det_h.mask_logits.numpy(), want_h.mask_logits, atol=1e-4,
                               rtol=1e-4)


def test_rpn_assignment_matches_jax_eager(oracles):
    """The port's RPN assigner on every dataset's gts (rotated ones through
    their bounding boxes) against JAX's op-by-op run, index for index: the
    rotated gts of dataset 1 tie at their best anchors (`port_rpn_assign`)."""
    from mtp_tpu.ops.assign import max_iou_assign as jassign
    from mtp_tpu.ops.rotated_boxes import rbox_to_hbox as jhbox
    oracle = _get(oracles, "vit")
    anchors = jdet.anchors_for(None, (SIZE, SIZE))
    for b in oracle["batches"]:
        for key in ("gt_boxes", "r_gt_boxes"):
            boxes, valid = b[key], b["gt_valid"]
            jb = jnp.asarray(boxes) if key == "gt_boxes" else jhbox(jnp.asarray(boxes))
            pb = _t(boxes) if key == "gt_boxes" else rbox_to_hbox(_t(boxes))
            for i in range(boxes.shape[0]):
                want = jassign(jnp.asarray(anchors), jb[i], jnp.asarray(valid[i]), None,
                               0.7, 0.3, 0.3, True)
                got = passign.max_iou_assign(_t(anchors), pb[i], _t(valid[i]), None,
                                             0.7, 0.3, 0.3, True)
                np.testing.assert_array_equal(got.gt_inds.numpy(), np.asarray(want.gt_inds))


@pytest.mark.parametrize("det_multi", [False, True])
def test_kernel_launches_per_step_and_predict(stubbed_launches, det_multi):
    """The toy ViT (one RVSA block, one full block) in one encoder pass over
    the 3 datasets' images: a train step launches K1, K2, K3 ×2 and their
    backwards once per block; the sequential detection losses N1 once per
    RPN (3 Mask R-CNN, 3 Oriented R-CNN), R1's dense form once per rotated
    assigner and K3 once per mask-target sampling of the gt crops, the
    concatenated form each once a task; a predict of one dataset the
    forward's kernels, N1 three times (two RPNs, Mask R-CNN's NMS) and R1's
    mask form once."""
    task = MultiTaskPretrainTask(_cfg(), CLASSES, OVERRIDES, det_multi=det_multi,
                                 device="cpu")
    state = task.init_state(torch.Generator().manual_seed(0))
    batch = {f"d{d}": {k: _t(v) for k, v in b.items()}
             for d, b in enumerate(make_batches((1, 1, 1), seed=9))}
    fwd = {"window": 1, "flash": 1, "bilinear_sample": 2}
    n = 1 if det_multi else 3
    stubbed_launches()
    task.train_step_fn()(state, batch)
    assert stubbed_launches() == {**fwd, "bilinear_sample": 2 + n, "window_bwd": 1,
                                  "flash_bwd": 1, "bilinear_sample_bwd": 2, "nms": 2 * n,
                                  "rbox_iou": n}
    task.predict_fn()(batch["d1"]["image"], 1)
    assert stubbed_launches() == {**fwd, "nms": 3, "nms_rotated": 1}


# ------------------------------------------------------------- evaluate --

def _detections(batch, rotated, rng, n=8):
    """n padded detections an image near its 3 valid gts (jittered copies,
    mostly of the gt's label, random scores, a third of the slots invalid)
    and, for the horizontal ones, mask logits from the gt's crop (or noise
    without crops): (JAX Detections, the port's)."""
    pre = "r_" if rotated else ""
    gts, gl = batch[pre + "gt_boxes"], batch[pre + "gt_labels"]
    B, D = gts.shape[0], gts.shape[-1]
    idx = rng.integers(0, 3, n)
    boxes = (gts[:, idx] + rng.normal(0, 1.5, (B, n, D)) * (
        [1, 1, 1, 1, 0.05] if rotated else 1)).astype(np.float32)
    scores = rng.uniform(0.05, 1, (B, n)).astype(np.float32)
    labels = np.where(rng.uniform(size=(B, n)) < 0.75, gl[:, idx],
                      rng.integers(0, 3, (B, n))).astype(np.int32)
    valid = rng.uniform(size=(B, n)) < 0.67
    logits = None
    if not rotated:
        logits = rng.normal(0, 1, (B, n, 28, 28))
        if "gt_mask_crops" in batch:
            logits += batch["gt_mask_crops"][:, idx, ::2, ::2] * 8 - 4
        logits = logits.astype(np.float32)
    j = jdet.Detections(*map(jnp.asarray, (boxes, scores, labels, valid)),
                        None if logits is None else jnp.asarray(logits))
    p = pdet.Detections(*map(_t, (boxes, scores, labels, valid)),
                        None if logits is None else _t(logits))
    return j, p


@pytest.mark.parametrize("masks", ["gt_mask_crops", "gt_masks"])
def test_evaluate_matches_jax_on_the_same_detections(masks):
    """`evaluate`'s 9-way metrics (mIoU, COCO bbox and segm AP, rotated VOC
    AP50, mtp_accuracy) against JAX's `MultiTaskPretrainTask.evaluate`,
    both given the same class maps and detections for 2 batches; the COCO
    stats within 1e-12."""
    rng = np.random.default_rng(21)
    other = "gt_masks" if masks == "gt_mask_crops" else "gt_mask_crops"
    data = [{f"d{d}": b for d, b in enumerate(_without(make_batches((2, 1, 2), seed), other))}
            for seed in (7, 8)]
    preds = {}
    for bi, batch in enumerate(data):
        for d in range(3):
            bd = batch[f"d{d}"]
            ss = rng.integers(0, CLASSES[d], bd["ss_label"].shape).astype(np.int32)
            jh, ph = _detections(bd, False, rng)
            jr, pr = _detections(bd, True, rng)
            preds[bi, d] = ((jnp.asarray(ss), jh, jr), (_t(ss), ph, pr))
    calls = {"jax": iter(sorted(preds)), "port": iter(sorted(preds))}

    jtask_ = jtask.MultiTaskPretrainTask(_cfg(), CLASSES, OVERRIDES)
    jtask_._predict = lambda v, images, d: preds[next(calls["jax"])][0]
    want = jtask_.evaluate(mock.Mock(params={}, batch_stats={}), iter(data))
    task = _task(MultiTaskPretrainModel(BB, CLASSES, OVERRIDES))
    task._predict = lambda images, d: preds[next(calls["port"])][1]
    state = mock.Mock(model=task.model)
    got = task.evaluate(state, iter(data))
    assert set(got) == set(want) and len(want) == 3 * 6 + 3
    assert got["is_d0_mAP50"] > 0 and got["rd_d2_mAP50"] > 0
    assert got["is_d0_segm_mAP50"] > 0 or masks == "gt_masks"
    for k, w in want.items():
        if k.startswith("eval_"):
            assert got[k] >= 0
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-12, atol=1e-12, err_msg=k)


# -------------------------------------------------------------- subsets --

@pytest.mark.parametrize("tasks", [("ss",), ("ss", "is"), ("ss", "rd")])
def test_task_subsets(oracles, tasks):
    """A subset runs and trains only its branches: its losses are the full
    model's of those tasks, no gradient reaches a gated-off decoder, and
    after a train step every parameter of one is bit for bit at its
    initial value (weight decay 0.5 included), while the encoder and the
    selected decoders moved."""
    oracle = _get(oracles, "vit")
    crops = _without(oracle["batches"], "gt_masks")
    model, total, losses = _port_loss(oracle, "vit", crops, tasks=tasks)
    assert set(losses) == {k for k in oracle["losses"] if k.split("_")[0] in tasks}
    _losses_close(losses, {k: v for k, v in oracle["losses"].items() if k in losses})
    inactive = tuple(p for t in ("ss", "is", "rd") if t not in tasks
                     for p in ptask.TASK_PREFIXES[t])
    total.backward()
    for name, p in model.named_parameters():
        assert (p.grad is None) == name.startswith(inactive), name

    task = MultiTaskPretrainTask(_cfg(weight_decay=0.5), CLASSES, OVERRIDES, tasks=tasks,
                                 device="cpu")
    state = task.init_state(torch.Generator().manual_seed(0))
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    batch = {f"d{d}": {k: _t(v) for k, v in b.items()} for d, b in enumerate(crops)}
    with _port_dropout(oracle["masks"]):
        state, _ = task.train_step_fn()(state, batch)
    for name, p in state.model.named_parameters():
        if name.startswith(inactive):
            assert torch.equal(p, before[name]), name
    moved = {n.split(".")[0] for n, p in state.model.named_parameters()
             if not torch.equal(p, before[n])}
    assert "encoder" in moved and "semsegdecoder" in moved
    assert ("inssegdecoder" in moved) == ("is" in tasks)
    assert ("rotdetdecoder" in moved) == ("rd" in tasks)


@pytest.mark.parametrize("tasks", [(), ("ss", "cls")])
def test_tasks_must_be_a_non_empty_subset(tasks):
    with pytest.raises(ValueError, match="subset"):
        MultiTaskPretrainModel(BB, CLASSES, OVERRIDES, tasks=tasks)


@pytest.mark.parametrize("mode", ["ratio", "avg"])
def test_allocate_batch_sizes_matches_jax(mode):
    """Over totals 1-40 and dataset lengths of SAMRS's shape and others,
    the same sizes, and a ValueError where JAX raises one."""
    for lengths in ((17000, 8000, 64000), (1, 1, 1), (5, 900, 3), (10, 20)):
        for total in range(1, 41):
            try:
                want = jtask.allocate_batch_sizes(total, lengths, mode)
            except ValueError:
                with pytest.raises(ValueError):
                    allocate_batch_sizes(total, lengths, mode)
                continue
            assert allocate_batch_sizes(total, lengths, mode) == want, (total, lengths)
    assert allocate_batch_sizes(3, (17000, 8000, 64000), "avg") == (1, 1, 1)


# ---------------------------------------------------------- checkpoints --

def test_state_dict_round_trips_through_the_jax_multitask_converter(oracles, tmp_path):
    """`torch.save(model.state_dict())`, with the 1-class conv_seg that the
    reference's UPerHead carries, read by JAX's
    `convert_multitask_checkpoint`, gives back JAX's parameters and batch
    statistics, except the mask trunk's ConvTranspose kernel, which comes
    back flipped in both spatial axes (`convert_mask_trunk` does not flip
    it; the port's `_deconv` does); and `multitask_state_dict` drops
    exactly that conv_seg when the port loads the file."""
    oracle = _get(oracles, "vit")
    sd = _port(oracle, "vit").state_dict()
    sd["semsegdecoder.decode_head.conv_seg.weight"] = torch.zeros(1, 256, 1, 1)
    sd["semsegdecoder.decode_head.conv_seg.bias"] = torch.zeros(1)
    path = str(tmp_path / "mtp.pth")
    torch.save(sd, path)
    got = convert_multitask_checkpoint(path, BB)
    want = oracle["variables"]
    trunk = got["params"]["is_mask_trunk"]["upsample"]
    trunk["kernel"] = trunk["kernel"][::-1, ::-1]
    assert jax.tree_util.tree_structure(got["params"]) == \
        jax.tree_util.tree_structure(want["params"])
    jax.tree.map(np.testing.assert_array_equal, got["params"], want["params"])
    jax.tree.map(np.testing.assert_array_equal, got["batch_stats"], want["batch_stats"])
    loaded = multitask_state_dict(load_torch_checkpoint(path))
    assert set(sd) - set(loaded) == set(UNUSED_MULTITASK_KEYS)
    MultiTaskPretrainModel(BB, CLASSES, OVERRIDES).load_state_dict(loaded)


@pytest.mark.parametrize("kind", ["vit", "xl"])
def test_both_jax_encoder_layouts_convert_alike(oracles, kind):
    """The scanned encoder layout (the recipe's `scan=True`) gives the
    unrolled layout's state dict."""
    oracle = _get(oracles, kind)
    variables = oracle["variables"]
    enc = variables["params"]["encoder"]
    scanned = (to_stage_scan_layout(enc, TINY_XL.depths) if kind == "xl"
               else to_scan_layout(enc, BB.depth, BB.interval))
    want = multitask_from_jax(variables, _backbone(kind))
    got = multitask_from_jax({**variables, "params": {**variables["params"], "encoder": scanned}},
                             _backbone(kind))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)


def test_fit_exports_the_encoder_into_a_finetune_task(tmp_path):
    """`fit` (the real sampler and dropout) takes nested batches, saves a
    checkpoint and the encoder artifact, which loads into a ViT
    segmentation task through `load_encoder` / `backbone_state_dict` and
    gives that task the trained encoder's features."""
    from mtp_tpu_torch.ckpt.store import CheckpointStore
    task = MultiTaskPretrainTask(_cfg(), CLASSES, OVERRIDES, device="cpu")
    state = task.init_state(torch.Generator().manual_seed(0))
    logs, enc_path = [], str(tmp_path / "encoder.pth")
    data = iter([{f"d{d}": b for d, b in enumerate(make_batches((1, 1, 1), s))}
                 for s in (11, 12)])
    state, m = task.fit(state, data, 2, log_every=1, log_fn=lambda i, m: logs.append(m),
                        ckpt=CheckpointStore(str(tmp_path / "ckpt")), encoder_path=enc_path)
    assert len(logs) == 2 and all(np.isfinite(v) for v in m.values())
    assert len([k for k in m if k.startswith(("ss_", "is_", "rd_"))]) == 30
    seg_cfg = dataclasses.replace(_cfg(), task="segmentation", num_classes=3)
    seg = SegmentationTask(seg_cfg, device="cpu")
    seg.model.backbone.load_state_dict(backbone_state_dict(load_encoder(enc_path, BB), BB))
    x = _t(np.random.default_rng(0).standard_normal((1, SIZE, SIZE, 3)).astype(np.float32))
    with torch.no_grad():
        want = state.model.encode(x)
        got = seg.model.backbone(x)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_init_state_decays_by_the_encoder_layers_and_draws_flax_inits():
    """`Task._init_state` on the multitask model: layer decay by the
    `encoder.` layer ids (the patch embedding at rate^(depth + 1), block i
    at rate^(depth − i), every decoder at 1), and `init_weights` gives the
    detection heads' Linears flax's lecun-normal (std sqrt(1/fan_in)) where
    the encoder's take the ViT's trunc-normal(0.02)."""
    task = MultiTaskPretrainTask(_cfg(), CLASSES, OVERRIDES, device="cpu")
    state = task.init_state(torch.Generator().manual_seed(0))
    scale = {name: g["lr_scale"] for g in state.optimizer.adamw.param_groups
             for name in (state.optimizer.names[p] for p in g["params"])}
    rate, depth = task.cfg.train.optimizer.layer_decay, BB.depth
    assert scale["encoder.patch_embed.proj.weight"] == pytest.approx(rate ** (depth + 1))
    assert scale["encoder.blocks.1.mlp.fc1.weight"] == pytest.approx(rate ** (depth - 1))
    assert {scale[n] for n in scale if not n.startswith("encoder.")} == {1.0}
    std = lambda name: float(dict(state.model.named_parameters())[name].std())
    for name, fan_in in (("inssegroiboxhead_fc_cls1.weight", 1024),
                         ("rotdetroiboxhead_fc_reg3.weight", 1024),
                         ("inssegdecoder.roi_head.bbox_head.shared_fcs.0.weight", 256 * 49),
                         ("rotdetdecoder.roi_head.bbox_head.shared_fcs.1.weight", 1024)):
        assert std(name) == pytest.approx(np.sqrt(1 / fan_in), rel=0.1), name
    # trunc-normal(0.02) cut at ±2σ: std 0.02 × 0.8796
    assert std("encoder.blocks.1.mlp.fc1.weight") == pytest.approx(0.02 * 0.8796, rel=0.1)
