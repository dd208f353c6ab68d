"""The InternImage-XL paths of `chip_smoke.py` (phases 20-23: the oriented,
Mask R-CNN, RetinaNet and multitask recipes) on the CPU, before any card
run: the launch counts each path expects of a train step, a predict and
the strip's checks, against the same recipes' tasks built with a toy
InternImage (the recipe's heads, a small trunk of 5 layers, remat) and
every kernel launch stubbed out; and two of the script's time savers:
`chip_smoke.SeededInit`'s shared trunk draw, against a fresh draw of each
model, and the CPU reference worker, stopped in every timed window."""

import dataclasses
import time

import pytest
import torch

import chip_smoke as cs
from mtp_tpu_torch.ckpt import from_jax
from mtp_tpu_torch.config import SAMRS_CLASSES, internimage_xl
from mtp_tpu_torch.models.multitask import MultiTaskPretrainModel
from mtp_tpu_torch.tasks.detection_task import DetectionTask, build_detector
from mtp_tpu_torch.tasks.multitask import MultiTaskPretrainTask
from test_torch_port_oriented import stubbed_launches  # noqa: F401 (a fixture)

torch.set_num_threads(1)

XL_LAYERS = sum(internimage_xl().depths)
TOY = dataclasses.replace(internimage_xl(), channels=16, depths=(1, 1, 2, 1),
                          groups=(2, 4, 8, 16), dtype="float32", drop_path_rate=0.1,
                          remat=True)
TOY_LAYERS = sum(TOY.depths)
TOY_FWD = cs.launches(bilinear_sample=TOY_LAYERS)
TOY_STEP = cs.launches(bilinear_sample=2 * TOY_LAYERS, bilinear_sample_bwd=TOY_LAYERS)
SIZE = 128
# sample and proposal counts cut for the CPU; no launch count depends on them
SMALL = dict(nms_pre=128, max_proposals=32, rpn_num=32, rcnn_num=16, max_per_img=8)


def toy(counts: dict, xl: dict, small: dict) -> dict:
    """`counts` of an XL path with the XL trunk's share `xl` replaced by
    the toy trunk's `small`; the counters that are not 0."""
    out = {k: counts[k] - xl[k] + small[k] for k in counts}
    return {k: n for k, n in out.items() if n}


def _t(batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_the_xl_trunk_launches_what_the_paths_count():
    """`XL_FWD` / `XL_STEP`: K3 once a layer a forward, twice a step
    (remat), K6 once; 39 layers."""
    assert XL_LAYERS == 39
    assert cs.XL_FWD == cs.launches(bilinear_sample=XL_LAYERS)
    assert cs.XL_STEP == cs.launches(bilinear_sample=2 * XL_LAYERS,
                                     bilinear_sample_bwd=XL_LAYERS)


@pytest.mark.parametrize("name", ["det_rot_xl", "mask_xl", "retina_xl"])
def test_detection_path_launches(stubbed_launches, name):  # noqa: F811
    """A train step, a predict and the strip's forward each launch what the
    path expects, with the toy trunk's share in place of XL's; the strip's
    gradient check (det_rot_xl's alone) expects the trunk's step: the CPU's
    proposals and assigner IoUs are replayed, so no NMS and no R1."""
    path = {**cs.ROT_PATHS, **cs.INST_PATHS}[name]
    assert path.recipe.backbone.remat
    fields = {f.name for f in dataclasses.fields(type(path.det))}
    det = {k: v for k, v in {**path.overrides, **SMALL}.items() if k in fields}
    model = from_jax.init_weights(build_detector(
        path.head, TOY, cs.det_config(path.head, path.recipe.num_classes, det),
        (SIZE, SIZE)), torch.Generator())
    task = DetectionTask(path.recipe, head=path.head, det_overrides=det, model=model,
                         device="cpu")
    state = task.init_state(torch.Generator().manual_seed(0))
    batch = _t(cs.det_batch(path.batch, (SIZE, SIZE), path.recipe.num_classes, 3,
                            path.rotated, path.masks))
    stubbed_launches()
    task.train_step_fn()(state, batch)
    assert stubbed_launches() == toy(path.per_step, cs.XL_STEP, TOY_STEP)
    task.predict_fn()(batch["image"])
    assert stubbed_launches() == toy(path.per_predict, cs.XL_FWD, TOY_FWD)
    with torch.no_grad():  # the card's run takes the CPU's proposals
        _, props = cs._det_heads(state.model, batch["image"], None, task)
        stubbed_launches()
        cs._det_heads(state.model, batch["image"], props, task)
    assert stubbed_launches() == toy(path.per_forward, cs.XL_FWD, TOY_FWD)
    assert path.gradients == (name == "det_rot_xl")
    if path.gradients:
        assert path.grad_rtol == cs.GRAD_RTOL_STOCHASTIC
        assert {**path.per_step, "nms": 0, "rbox_iou": 0} == cs.XL_STEP


def test_multitask_xl_path_launches(stubbed_launches):  # noqa: F811
    """mtp_xl: a train step (sequential detection and det_multi), one
    dataset's predict and the strip's forward launch what the path
    expects, with the toy trunk's share in place of XL's; its gradient
    check expects the step's kernels without NMS and R1."""
    path = cs.MTP_PATHS["mtp_xl"]
    assert path.recipe.backbone.remat and path.grad_rtol == cs.GRAD_RTOL_STOCHASTIC
    det = {"score_thr": cs.SCORE_THR, **SMALL}
    model = MultiTaskPretrainModel(TOY, SAMRS_CLASSES, det, input_hw=(SIZE, SIZE))
    task = MultiTaskPretrainTask(path.recipe, det_overrides=det, model=model, device="cpu")
    state = task.init_state(torch.Generator().manual_seed(0))
    batch = {d: _t(b) for d, b in cs.mtp_batch((SIZE, SIZE), 5).items()}
    for multi, want in ((False, path.step), (True, path.step_multi)):
        model.det_multi = multi
        stubbed_launches()
        task.train_step_fn()(state, batch)
        assert stubbed_launches() == toy(want, cs.XL_STEP, TOY_STEP), multi
    model.det_multi = False
    assert path.per_step == {**path.step, "nms": 0, "rbox_iou": 0}
    task.predict_fn()(batch["d1"]["image"], 1)
    assert stubbed_launches() == toy(path.per_predict, cs.XL_FWD, TOY_FWD)
    images = torch.cat([b["image"] for b in batch.values()])
    with torch.no_grad():  # the card's run takes the CPU's proposals
        _, props = cs._mtp_heads(state.model, images, None)
        stubbed_launches()
        cs._mtp_heads(state.model, images, props)
    assert stubbed_launches() == toy(path.per_forward, cs.XL_FWD, TOY_FWD)


def test_seeded_init_copies_one_xl_trunk_into_every_model(monkeypatch):
    """Every XL model drawn from one seed takes the first draw's trunk: the
    whole model bit for bit a fresh `from_jax.init_weights` of it, the
    generator left where that draw leaves it, and the trunk drawn once."""
    drawn = []
    real = from_jax._init_internimage
    monkeypatch.setattr(from_jax, "_init_internimage",
                        lambda m, g: drawn.append(1) or real(m, g))
    seeded = cs.SeededInit()
    assert seeded.draw_trunk is not real  # the counting stand-in, taken at construction
    models = [lambda head=head: build_detector(head, TOY, cs.det_config(head, 5, {}), (64, 64))
              for head in ("faster_rcnn", "oriented_rcnn", "mask_rcnn", "retinanet")]
    models.append(lambda: MultiTaskPretrainModel(TOY, SAMRS_CLASSES, input_hw=(64, 64)))
    for make in models:
        g_seeded, g_fresh = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
        got = seeded(make(), g_seeded).state_dict()
        monkeypatch.setattr(from_jax, "_init_internimage", real)
        want = from_jax.init_weights(make(), g_fresh).state_dict()
        monkeypatch.setattr(from_jax, "_init_internimage",
                            lambda m, g: drawn.append(1) or real(m, g))
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], v) for k, v in want.items())
        assert torch.equal(g_seeded.get_state(), g_fresh.get_state())
    assert len(drawn) == 1
    # another seed draws its own trunk
    seeded(models[0](), torch.Generator().manual_seed(1))
    assert len(drawn) == 2
    assert len(seeded.kept) <= cs.SeededInit.KEEP


TOY_VIT = dataclasses.replace(cs.vit_b_rvsa(64, dtype="float32"), embed_dim=32, depth=4,
                              num_heads=2, interval=2, out_indices=(0, 1, 2, 3))


def _families():
    """A toy model of every family the phases build and draw: the segmentor,
    classifier and change detector of either backbone, the four detectors
    of either, the multitask model of either, the carafe mask head and the
    patch-8 ViT."""
    from mtp_tpu_torch.heads.roi_heads import MaskHead
    from mtp_tpu_torch.models.change_detection import SiamChangeDetector
    from mtp_tpu_torch.models.classifier import ImageClassifier
    from mtp_tpu_torch.models.segmentor import Segmentor
    from mtp_tpu_torch.models.vit_rvsa import ViTRVSA

    out = {"carafe": lambda: MaskHead(5, 16, 16, upsample="carafe"),
           "patch8": lambda: ViTRVSA(dataclasses.replace(
               cs.vit_b_rvsa(64, patch_size=8, dtype="float32"), embed_dim=32, depth=4,
               num_heads=2, interval=2, out_indices=(0, 1, 2, 3)), input_hw=(64, 32))}
    for tag, bb in (("vit", TOY_VIT), ("xl", TOY)):
        out[f"seg {tag}"] = lambda bb=bb: Segmentor(bb, 3, channels=16, input_hw=(64, 64))
        out[f"cls {tag}"] = lambda bb=bb: ImageClassifier(bb, 5)
        out[f"cd {tag}"] = lambda bb=bb: SiamChangeDetector(bb, 2)
        for head in ("faster_rcnn", "oriented_rcnn", "mask_rcnn", "retinanet"):
            out[f"{head} {tag}"] = lambda bb=bb, head=head: build_detector(
                head, bb, cs.det_config(head, 5, {}), (64, 64))
        out[f"multitask {tag}"] = lambda bb=bb: MultiTaskPretrainModel(bb, SAMRS_CLASSES,
                                                                      input_hw=(64, 64))
    return out


@pytest.mark.parametrize("family", sorted(_families()))
def test_undrawn_constructions_draw_every_tensor(family):
    """`SeededInit.constructions_undrawn`: a model built with PyTorch's
    random initialisers zeroing their tensors, then drawn, is bit for bit
    the model built as PyTorch builds it (from two global seeds) and drawn
    from the same generator: the draw replaces every tensor the
    constructor drew.  Inside a draw the initialisers draw (`from_jax`
    draws through them)."""
    make = _families()[family]
    seeded = cs.SeededInit()
    with seeded.constructions_undrawn():
        got = seeded(make(), torch.Generator().manual_seed(0)).state_dict()
    for seed in (1, 2):
        torch.manual_seed(seed)
        want = from_jax.init_weights(make(), torch.Generator().manual_seed(0)).state_dict()
        assert got.keys() == want.keys()
        differ = [k for k, v in want.items() if not torch.equal(got[k], v)]
        assert not differ, differ


def test_timed_windows_stop_the_reference_worker():
    """`chip_smoke.timed_window`: the CPU reference worker (`References`)
    is stopped for the window's length (state T) and runs again after it;
    windows nest; with no worker a window is a plain block."""
    with cs.timed_window():
        assert cs.References.running is None
    refs = cs.References([])
    stat = f"/proc/{refs.proc.pid}/stat"

    def state_becomes(want: bool) -> bool:
        for _ in range(200):
            if (open(stat).read().rsplit(")", 1)[1].split()[0] == "T") == want:
                return True
            time.sleep(0.05)
        return False

    try:
        with cs.timed_window():
            with cs.timed_window():
                assert state_becomes(True)
            assert refs.stopped_at is not None and state_becomes(True)
        assert state_becomes(False) and refs.stops == 1 and refs.stopped_s > 0
    finally:
        refs.close()
    assert cs.References.running is None and not refs.proc.is_alive()
