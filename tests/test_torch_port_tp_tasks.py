"""The port's tensor parallelism (`mtp_tpu_torch.parallel.tensor`) against
the port at model 1, on the CPU: two gloo ranks in spawned processes
(`tests/torch_ddp_workers.py`) on a data 1 × model 2 mesh, every case run
in one world (the `many` case), against the same cases in this process with
no process group.  Toy sizes: the ViT of `test_torch_port_ddp.py` (embed
32, 2 heads: one head a rank).

- the ViT+UperNet step with drop-path, dropout and clipping at 1.0 (below
  the toy's norm of ~1.8, so every gradient is scaled by the norm, which
  must count each whole parameter once and every shard); the same with
  remat, whose recompute runs the collectives again;
- the toy Faster R-CNN (the box trunk's shared_fcs) with its random
  sampler and drop-path, the toy InternImage classifier (its MLPs; the DCNv3 core
  whole), the toy 9-way multitask step (both box trunks, the ss heads;
  given proposals and Dropout2d masks, the deterministic sampler);
- checkpoints: written at model 2, restored at model 1 bit for bit, and
  the other way round;
- `evaluate` at model 2: segmentation's confusion counts and detection's
  VOC AP equal to model 1's, each record counted once;
- `cli.train --mesh-model 2` under torchrun.

The steps are held by phase 6's rule (each gradient within 1e-4 of its own
norm plus 1e-6 of all gradients' norm), the losses and `grad_norm` within
1e-5, the parameters after two steps within 2·Σ lr·scale (Adam moves a
parameter whose gradient is rounding noise by ±lr·scale either way); the
two ranks' whole states bit for bit equal."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mtp_tpu_torch import config as pc
from mtp_tpu_torch.parallel.tensor import PARTIAL, sharded_dim
from torch_ddp_workers import CASES, TOY, cls_task, det_task, run, seg_task

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TP = pc.MeshConfig(model=2)
CFG = pc.BackboneConfig(img_size=128, embed_dim=32, depth=4, num_heads=2, interval=2,
                        out_indices=(0, 1, 2, 3), dtype="float32")
K, CROP, BATCH, CHANNELS = 3, 64, 4, 16
SCHED = pc.ScheduleConfig(kind="cosine", total_steps=10, warmup_steps=2, warmup_ratio=0.1)


def _opt(clip):
    return pc.OptimizerConfig(lr=1e-3, weight_decay=0.05, layer_decay=0.9, clip_norm=clip)


def _at(cfg, mesh):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, mesh=mesh))


def _seg_batch(seed, n=BATCH, hw=(CROP, CROP)):
    rng = np.random.default_rng(seed)
    label = rng.integers(0, K, (n,) + hw).astype(np.int32)
    label[:, :5] = 255
    return {"image": rng.standard_normal((n,) + hw + (3,)).astype(np.float32), "label": label}


def _seg(backbone=CFG, clip=1.0, batches=(), **kw):
    cfg = pc.TaskConfig(task="segmentation", num_classes=K, backbone=backbone,
                        train=pc.TrainConfig(batch_size=BATCH, optimizer=_opt(clip),
                                             schedule=SCHED),
                        slide=pc.SlideConfig(crop=CROP, stride=32))
    return dict(cfg=cfg, channels=CHANNELS, crop=CROP, state_dict=None, batches=list(batches),
                deterministic=False, **kw)


# drop-path on, the token dropout off: with it this toy's step lies within
# reach of a kink (at model 1 alone, the image scaled by 1 + 1e-6 moves the
# FPN's gradients by 8e-4 of their norm), which the order of summation at
# model 2 crosses; the ViT+UperNet case holds the dropout under the model axis
DET_BB = pc.BackboneConfig(img_size=64, patch_size=16, embed_dim=32, depth=2, num_heads=2,
                           interval=2, out_indices=(0, 0, 1, 1), dtype="float32",
                           drop_path_rate=0.2)
DET_OVERRIDES = dict(nms_pre=256, max_proposals=64, rpn_num=64, rcnn_num=32, max_per_img=16,
                     max_gts=8)


def _det_batch(seed, n_gts=(3, 1, 3, 2), G=8, size=64):
    rng = np.random.default_rng(seed)
    B = len(n_gts)
    xy = rng.uniform(4, 40, (B, G, 2))
    wh = rng.uniform(8, 24, (B, G, 2))
    return {"image": rng.standard_normal((B, size, size, 3)).astype(np.float32),
            "gt_boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
            "gt_labels": rng.integers(0, 3, (B, G)).astype(np.int32),
            "gt_valid": np.arange(G)[None] < np.asarray(n_gts)[:, None]}


def _det(batches=(), **kw):
    cfg = pc.TaskConfig(task="detection_h", num_classes=3, backbone=DET_BB,
                        train=pc.TrainConfig(batch_size=4, optimizer=pc.OptimizerConfig(
                            lr=1e-3, clip_norm=1.0), schedule=pc.ScheduleConfig(kind="constant")))
    return dict(cfg=cfg, det_overrides=kw.pop("det_overrides", DET_OVERRIDES), state_dict=None,
                batches=list(batches), deterministic=False, **kw)


def _cls():
    """The InternImage-T layer at small widths (hidden 64: 32 a rank)."""
    model_cfg = dataclasses.replace(pc.internimage_t(), channels=16, depths=(1, 1, 2, 1),
                                    groups=(2, 4, 8, 16), dtype="float32", drop_path_rate=0.1)
    shell = pc.internimage_backbone_config("internimage_t", 64, dtype="float32",
                                           drop_path_rate=0.1)
    cfg = pc.TaskConfig(task="classification", num_classes=10, backbone=shell,
                        train=pc.TrainConfig(batch_size=4, optimizer=_opt(0.0),
                                             schedule=SCHED))
    rng = np.random.default_rng(11)
    batches = [{"image": rng.standard_normal((4, 64, 64, 3)).astype(np.float32),
                "label": rng.integers(0, 10, 4).astype(np.int64)} for _ in range(2)]
    return dict(cfg=cfg, model_cfg=model_cfg, state_dict=None, batches=batches,
                deterministic=False)


MT_SIZE, MT_G, MT_CLASSES, MT_B = 64, 6, (4, 5, 6), 2
MT_OVERRIDES = dict(nms_pre=128, max_proposals=32, rpn_num=32, rcnn_num=16, max_per_img=8)


def _multitask():
    """The toy 9-way step (two images a dataset): seeded batches and
    proposals (32 an image, horizontal and rotated), given to both meshes;
    the deterministic sampler (`torch_ddp_workers._multitask_step`);
    deterministic (BatchNorm on its running statistics, no Dropout2d): in
    train mode the ss heads' BatchNorm over these few pixels is
    ill-conditioned, and at model 1 alone an image scaled by 1 + 1e-7 moves
    the ss decoder's gradients by 1e-3 to 5e-2 of their norm."""
    from mtp_tpu_torch.eval.masks import crop_masks_to_boxes
    rng = np.random.default_rng(21)
    S, G, B, batches, props = MT_SIZE, MT_G, MT_B, {}, []
    for d, C in enumerate(MT_CLASSES):
        xy = rng.uniform(4, 40, (B, G, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(8, 24, (B, G, 2))], -1)
        valid = np.repeat(np.arange(G)[None] < 3, B, 0)
        ys, xs = np.mgrid[0:S, 0:S] + 0.5
        c = (boxes[..., :2] + boxes[..., 2:]) / 2
        ax = (boxes[..., 2:] - boxes[..., :2]) / 2 * 0.8
        full = (((xs - c[..., 0, None, None]) / ax[..., 0, None, None]) ** 2
                + ((ys - c[..., 1, None, None]) / ax[..., 1, None, None]) ** 2
                <= 1).astype(np.float32)
        label = rng.integers(0, C, (B, S, S)).astype(np.int32)
        label[:, :, :6] = 255
        batches[f"d{d}"] = {
            "image": rng.standard_normal((B, S, S, 3)).astype(np.float32),
            "ss_label": label, "gt_boxes": boxes.astype(np.float32),
            "gt_labels": rng.integers(0, C - 1, (B, G)).astype(np.int32), "gt_valid": valid,
            "gt_mask_crops": np.stack([crop_masks_to_boxes(full[b], boxes[b], 56)
                                       for b in range(B)]),
            "r_gt_boxes": np.stack([rng.uniform(16, 48, (B, G)), rng.uniform(16, 48, (B, G)),
                                    rng.uniform(10, 24, (B, G)), rng.uniform(5, 12, (B, G)),
                                    rng.uniform(-1.2, 1.2, (B, G))], -1).astype(np.float32),
            "r_gt_labels": rng.integers(0, C - 1, (B, G)).astype(np.int32),
            "r_gt_valid": valid}
        n = MT_OVERRIDES["max_proposals"]
        h_xy = rng.uniform(0, 44, (B, n, 2))
        hbox = np.concatenate([h_xy, h_xy + rng.uniform(6, 20, (B, n, 2))], -1)
        rbox = np.stack([rng.uniform(12, 52, (B, n)), rng.uniform(12, 52, (B, n)),
                         rng.uniform(6, 24, (B, n)), rng.uniform(4, 12, (B, n)),
                         rng.uniform(-0.8, 0.8, (B, n))], -1)
        scores = lambda: -np.sort(-rng.uniform(0.1, 1.0, (B, n)), -1)
        props.append([(hbox.astype(np.float32), scores().astype(np.float32)),
                      (rbox.astype(np.float32), scores().astype(np.float32))])
    bb = dataclasses.replace(DET_BB, drop_path_rate=0.0, drop_rate=0.0)
    cfg = pc.TaskConfig(task="multitask", num_classes=0, backbone=bb,
                        train=pc.TrainConfig(batch_size=3 * B, optimizer=_opt(0.0),
                                             schedule=pc.ScheduleConfig(kind="constant")))
    masks = [rng.uniform(size=(B, 1, 1, 256)) < 0.9 for _ in MT_CLASSES]
    return dict(cfg=cfg, backbone=bb, classes=MT_CLASSES, overrides=MT_OVERRIDES,
                det_multi=False, state_dict=None, masks=masks, keep=0.9, props=props,
                deterministic=True, batches=[batches])


def _eval():
    seg = _seg()
    rng = np.random.default_rng(7)
    seg["data"] = [{"image": rng.standard_normal((2, 96, 80, 3)).astype(np.float32),
                    "label": rng.integers(0, K, (2, 96, 80))} for _ in range(2)]
    det = _det(det_overrides=dict(DET_OVERRIDES, score_thr=0.0))
    det["data"] = [_det_batch(s, n_gts=(3, 2)) for s in (8, 9, 10)]
    return dict(seg=seg, det=det)


STEPS = {
    "vit_upernet_clip": ("seg_step", lambda: _seg(
        dataclasses.replace(CFG, drop_path_rate=0.3, drop_rate=0.1),
        batches=[_seg_batch(1), _seg_batch(2)])),
    "vit_upernet_remat": ("seg_step", lambda: _seg(
        dataclasses.replace(CFG, drop_path_rate=0.3, remat=True),
        batches=[_seg_batch(3), _seg_batch(4)])),
    "faster_rcnn": ("det_step", lambda: _det([_det_batch(5), _det_batch(6)])),
    "internimage_cls": ("cls_step", _cls),
    "multitask": ("multitask_step", _multitask),
}


def _tp(payload):
    """The payload with its task configs at data 1 × model 2."""
    out = dict(payload)
    for key in ("seg", "det"):
        if key in out:
            out[key] = _tp(out[key])
    if "cfg" in out:
        out["cfg"] = _at(out["cfg"], TP)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every case at model 1 in this process and at model 2 in one world of
    two ranks; the checkpoint written at model 1 here before the world
    starts (its restore is a case of the world)."""
    tmp = tmp_path_factory.mktemp("tp")
    payloads = {name: make() for name, (_, make) in STEPS.items()}
    payloads["eval"] = _eval()
    one = {name: CASES[case](payloads[name]) for name, (case, _) in STEPS.items()}
    one["eval"] = CASES["tp_eval"](payloads["eval"])
    one["ckpt_at_1"] = CASES["ckpt"](dict(_seg(batches=[_seg_batch(12)]),
                                          dir=str(tmp / "at1"), save=True))
    cases = [(case, _tp(payloads[name])) for name, (case, _) in STEPS.items()]
    cases += [("tp_eval", _tp(payloads["eval"])),
              ("ckpt", dict(_tp(_seg(batches=[_seg_batch(13)])), dir=str(tmp / "at2"),
                            save=True)),
              ("ckpt", dict(_tp(_seg()), dir=str(tmp / "at1"), save=False))]
    ranks = run("many", 2, tmp, {"cases": cases}, timeout=150)
    names = list(STEPS) + ["eval", "ckpt_at_2", "restored_at_2"]
    two = [dict(zip(names, r)) for r in ranks]
    return dict(one=one, two=two, tmp=tmp)


def _scales(state):
    return {state.optimizer.names[p]: g["lr_scale"]
            for g in state.optimizer.adamw.param_groups for p in g["params"]}


def _reference_state(name):
    """A model-1 state of the case's task, for its parameters' LR scales."""
    case, make = STEPS[name]
    payload = make()
    build = {"seg_step": seg_task, "det_step": det_task, "cls_step": cls_task}.get(case)
    if build is not None:
        return build(payload)[1]
    from mtp_tpu_torch.models.multitask import MultiTaskPretrainModel
    from mtp_tpu_torch.tasks.multitask import MultiTaskPretrainTask
    task = MultiTaskPretrainTask(payload["cfg"], MT_CLASSES, MT_OVERRIDES,
                                 model=MultiTaskPretrainModel(payload["backbone"], MT_CLASSES,
                                                              MT_OVERRIDES), device="cpu")
    return task.init_state(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("name", list(STEPS))
def test_model_2_step_equals_model_1_step(worlds, name):
    """Two steps (one for the multitask case) at data 1 × model 2 against
    model 1 on the same batches: the metrics (losses, grad_norm) within
    1e-5, every gradient by phase 6's rule at 1e-4, the state after each
    step (BatchNorm statistics 1e-5, parameters within their Adam bound);
    the ranks' whole states bit for bit equal.  The case's model has
    sharded parameters and, for the ViTs, the partial ones."""
    one, two = worlds["one"][name], [r[name] for r in worlds["two"]]
    for a, b in zip(two[0]["state"], two[1]["state"]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    got = two[0]
    assert set(got["grads"]) == set(one["grads"])
    assert any(sharded_dim(n) is not None for n in one["grads"])
    if name.startswith("vit"):
        assert any(PARTIAL.search(n) for n in one["grads"])
    for m, w in zip(got["metrics"], one["metrics"]):
        assert set(m) == set(w)
        for k in w:
            np.testing.assert_allclose(m[k], w[k], rtol=1e-5, atol=1e-6, err_msg=k)
    g_all = float(torch.sqrt(sum((g.double() ** 2).sum() for g in one["grads"].values())))
    for n, g in one["grads"].items():
        diff = float((got["grads"][n] - g).norm())
        assert diff <= 1e-4 * float(g.norm()) + 1e-6 * g_all, (n, diff, float(g.norm()))
    state = _reference_state(name)
    scales, sched = _scales(state), state.optimizer.schedule
    for i, (s, w) in enumerate(zip(got["state"], one["state"])):
        bound = 2 * sum(sched(j) for j in range(i + 1))
        for n, v in w.items():
            if n in scales:
                np.testing.assert_allclose(s[n].numpy(), v.numpy(), rtol=0,
                                           atol=bound * scales[n] + 1e-7,
                                           err_msg=f"step {i} {n}")
            elif v.is_floating_point():
                np.testing.assert_allclose(s[n].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                           err_msg=f"step {i} {n}")
            else:
                assert torch.equal(s[n], v), n


def test_the_clip_applies(worlds):
    """The clipped case's norm is over its clip, so its update is scaled by
    the norm that both meshes count alike."""
    for m in worlds["one"]["vit_upernet_clip"]["metrics"]:
        assert m["grad_norm"] > 1.0


def _equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("written_at", [1, 2])
def test_checkpoints_are_the_same_at_any_mesh(worlds, written_at, tmp_path):
    """A checkpoint written at model 2 (every rank gathers, rank 0 writes)
    restores at model 1 into the state the ranks gathered, bit for bit, Adam
    moments, update count and generator included; one written at model 1
    restores at model 2 into the model-1 state, bit for bit (each rank
    keeps its shard, gathered back here)."""
    if written_at == 2:
        want = worlds["two"][0]["ckpt_at_2"]
        got = CASES["ckpt"](dict(_seg(), dir=str(worlds["tmp"] / "at2"), save=False))
    else:
        want = worlds["one"]["ckpt_at_1"]
        got = worlds["two"][0]["restored_at_2"]
        _equal(got["model"], worlds["two"][1]["restored_at_2"]["model"])
    _equal(got["model"], want["model"])
    assert got["moments"].keys() == want["moments"].keys() and got["moments"]
    for k, (mu, nu) in want["moments"].items():
        assert torch.equal(got["moments"][k][0], mu) and torch.equal(got["moments"][k][1], nu)
    assert got["count"] == want["count"] == 1
    assert torch.equal(got["generator"], want["generator"])


def test_evaluate_at_model_2_equals_model_1(worlds):
    """Segmentation's slide evaluation and detection's VOC AP50 at model 2:
    the same numbers as model 1, the confusion counts summed once (not once
    a model rank) and the detection records scored once each (6 images).
    Only a near tie at model 1 (a pixel whose top two logits, or a
    detection whose score and the next, lie within 1e-5) may come out
    otherwise; a difference names them, and fails without one."""
    one, twos = worlds["one"]["eval"], [r["eval"] for r in worlds["two"]]
    top2 = [lg.topk(2, -1).values for lg in one["logits"]]
    ties = [(t[..., 0] - t[..., 1]) < 1e-5 for t in top2]
    score_ties = []
    for i, d in enumerate(one["dets"]):
        s = np.sort(d["scores"][d["valid"]])
        score_ties += [(i, float(a)) for a, b in zip(s, s[1:]) if b - a < 1e-5]
    named = f"near-tie pixels {[int(t.sum()) for t in ties]}, scores {score_ties}"
    for two in twos:
        assert two["records"] == one["records"] == [6]
        for a, b, tie in zip(two["logits"], one["logits"], ties):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
            assert torch.equal(a.argmax(-1)[~tie], b.argmax(-1)[~tie]), named
        if not any(bool(t.any()) for t in ties):
            np.testing.assert_array_equal(np.stack(two["counts"]), np.stack(one["counts"]))
            assert two["seg"] == one["seg"]
        for a, b in zip(two["dets"], one["dets"]):
            np.testing.assert_allclose(a["scores"], b["scores"], rtol=1e-5, atol=1e-6)
        assert two["det"] == one["det"] or score_ties, (two["det"], one["det"], named)


def test_cli_trains_at_mesh_model_2_under_torchrun(tmp_path):
    """`cli.train --mesh-model 2` on 2 gloo ranks (torchrun), the toy recipe
    of `test_torch_port_cli.py`: two steps, a checkpoint and the encoder
    artifact in the whole layout (rank 0 writes; the ranks gather)."""
    from mtp_tpu_torch.ckpt.store import CheckpointStore
    wd, ck, enc = tmp_path / "wd", tmp_path / "ckpt", tmp_path / "enc.pth"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
           str(ROOT / "tests" / "torch_ddp_workers.py"), "train", TOY, "--synthetic",
           "--steps", "2", "--batch-size", "2", "--device", "cpu", "--mesh-model", "2",
           "--ckpt-dir", str(ck), "--ckpt-every", "1", "--encoder-out", str(enc),
           "--work-dir", str(wd), "--log-every", "1"]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=240,
                         env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-3000:]
    assert "mesh data 1 × model 2" in res.stderr
    lines = [json.loads(x) for x in res.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 1 and np.isfinite(lines[0]["final"]["loss"])
    assert [r["iter"] for r in map(json.loads, open(wd / f"{TOY}.jsonl"))] == [0, 1]
    assert CheckpointStore(str(ck)).steps() == [1, 2]
    ckpt = torch.load(ck / "2.pt", weights_only=True)
    qkv = ckpt["model"]["backbone.blocks.0.attn.qkv.weight"]
    assert qkv.shape == (3 * 32, 32)   # the whole layout
    assert ckpt["optimizer"]["moments"]["backbone.blocks.0.mlp.fc1.weight"][0].shape == (128, 32)
    assert torch.load(enc, weights_only=True)["blocks.0.attn.qkv.weight"].shape == (96, 32)
