"""The port's train/test/convert CLI (`mtp_tpu_torch.cli`) on the CPU:

- the slice as a whole: a toy segmentation recipe (a 2-block ViT, narrow
  widths, no drop-path, 64² crops) registered in both registries, JAX's
  variables saved with `mtp_tpu.ckpt.store.save_variables`, then
  `mtp_tpu.cli.test` and the port's `cli.test --device cpu` on the same
  `.npz` and the same SpaceNet-layout files: per-pixel predictions equal
  but where the top two logits lie within 1e-4 (at most 0.1% of pixels),
  and the same mIoU over the agreeing pixels;
- `cli.train` from disk for 2 steps (fork workers, checkpoints, the encoder
  export, --eval-after), `--resume` to 3 (one step more), and `cli.test`
  on its checkpoint, its variables file and its encoder file;
- `synthetic_data` against JAX's, batch for batch, and the detection heads
  the recipes take (`test_torch_port_cli_paths.py` has the CLI's other
  paths)."""

from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from mtp_tpu import configs as jconfigs
from mtp_tpu.eval import metrics as jmetrics
from mtp_tpu_torch import configs as pconfigs
from mtp_tpu_torch.eval import metrics as pmetrics
from test_torch_port_data import same

torch.set_num_threads(2)

TOY = "toy-rvsa-upernet-64"
NEAR_TIE, MAX_DISAGREE = 1e-4, 1e-3


def _toy_task(C):
    """The toy recipe's TaskConfig from a config module (JAX's or the
    port's dataclasses): 2 ViT blocks (one windowed, one full), embed 32,
    2 heads, fp32, drop-path 0; UperNet as the recipe builds it; 2 classes;
    slide eval with 64² crops at stride 32."""
    bb = C.BackboneConfig(img_size=64, embed_dim=32, depth=2, num_heads=2, interval=2,
                          out_indices=(0, 1, 1, 1), drop_path_rate=0.0, dtype="float32")
    return C.TaskConfig(
        task="segmentation", num_classes=2, backbone=bb,
        train=C.TrainConfig(batch_size=2, optimizer=C.OptimizerConfig(
            lr=1e-3, layer_decay=0.9, clip_norm=0.0),
            schedule=C.ScheduleConfig(kind="cosine", total_steps=3, warmup_steps=1)),
        slide=C.SlideConfig(crop=64, stride=32))


@pytest.fixture
def toy(monkeypatch):
    """TOY registered in both registries (their dicts only)."""
    from mtp_tpu.utils import config as jc
    from mtp_tpu_torch import config as pc
    monkeypatch.setitem(jconfigs._REGISTRY, TOY, lambda: jconfigs.Recipe(
        TOY, _toy_task(jc), dataset="spacenetv1", init="mae-mtp"))
    monkeypatch.setitem(pconfigs._REGISTRY, TOY, lambda: pconfigs.Recipe(
        TOY, _toy_task(pc), dataset="spacenetv1", init="mae-mtp"))
    return TOY


def _spacenet(root, n_train=4, n_val=3, hw=(96, 80)):
    """SpaceNet layout: img_dir/{split}/*.png RGB, ann_dir/{split}/*.png in
    {0, 1}, from a seed."""
    rng = np.random.default_rng(0)
    for split, n in (("train", n_train), ("val", n_val)):
        os.makedirs(f"{root}/img_dir/{split}")
        os.makedirs(f"{root}/ann_dir/{split}")
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, hw + (3,), np.uint8)).save(
                f"{root}/img_dir/{split}/{i}.png")
            Image.fromarray(rng.integers(0, 2, hw).astype(np.uint8)).save(
                f"{root}/ann_dir/{split}/{i}.png")
    return str(root)


def _record_preds(monkeypatch, cls, into: list):
    """Every prediction a SegAccumulator of `cls` is given, as numpy."""
    orig = cls.add

    def add(self, pred, label):
        into.append((np.asarray(pred.cpu() if torch.is_tensor(pred) else pred),
                     np.asarray(label)))
        return orig(self, pred, label)

    monkeypatch.setattr(cls, "add", add)


def test_cli_test_matches_jax_on_the_same_files(toy, tmp_path, monkeypatch):
    import jax
    from mtp_tpu.ckpt.store import save_variables
    from mtp_tpu.cli.test import main as jax_test
    from mtp_tpu.tasks.segmentation import SegmentationTask as JaxSegmentationTask
    from mtp_tpu_torch.cli.test import main as port_test
    from mtp_tpu_torch.cli.train import build_task, init_or_restore
    from mtp_tpu_torch.data.bindings import build_eval_data

    root = _spacenet(tmp_path / "data")
    jtask = JaxSegmentationTask(jconfigs.get(toy).task)
    jstate = jtask.init_state(jax.random.PRNGKey(3))
    npz = str(tmp_path / "toy_variables.npz")
    save_variables(npz, jax.device_get({"params": jstate.params,
                                        "batch_stats": jstate.batch_stats}))
    preds = {"jax": [], "port": []}
    _record_preds(monkeypatch, jmetrics.SegAccumulator, preds["jax"])
    _record_preds(monkeypatch, pmetrics.SegAccumulator, preds["port"])
    common = [toy, "--ckpt", npz, "--data-root", root]
    want = jax_test(common + ["--mesh-data", "1"], return_metrics=True)
    got = port_test(common + ["--device", "cpu"], return_metrics=True)
    assert len(preds["jax"]) == len(preds["port"]) == 3

    # the port's logits on the same images, for the near-ties
    task, cfg = build_task(pconfigs.get(toy), -1, 1, device="cpu")
    state = init_or_restore(task, npz)
    assert state.model is task.model
    batches = list(build_eval_data(pconfigs.get(toy), cfg, root, 1))
    total = disagree = 0
    agree_acc = {k: cls(2) for k, cls in (("jax", jmetrics.SegAccumulator),
                                           ("port", pmetrics.SegAccumulator))}
    monkeypatch.undo()
    for batch, (jp, label), (pp, plabel) in zip(batches, preds["jax"], preds["port"]):
        np.testing.assert_array_equal(label, plabel)
        logits = task.slide_logits(torch.as_tensor(batch["image"])).numpy()
        top2 = np.sort(logits, -1)[..., -2:]
        near = (top2[..., 1] - top2[..., 0]) <= NEAR_TIE
        diff = jp != pp
        assert not (diff & ~near).any(), "predictions differ away from a near-tie"
        total += diff.size
        disagree += int(diff.sum())
        agree = ~diff
        for k, p in (("jax", jp), ("port", pp)):
            agree_acc[k].add(np.where(agree, p, 0), np.where(agree, label, 255))
    assert disagree <= MAX_DISAGREE * total, (disagree, total)
    assert agree_acc["jax"].evaluate()["mIoU"] == agree_acc["port"].evaluate()["mIoU"]
    if disagree == 0:
        assert got["mIoU"] == pytest.approx(want["mIoU"], rel=1e-12, abs=1e-12)
    assert math.isfinite(got["mIoU"]) and 0 < got["mIoU"] < 100

    # JAX's encoder .npz carries the same backbone weights across
    from mtp_tpu.ckpt.store import save_encoder
    enc = str(tmp_path / "toy_encoder.npz")
    save_encoder(enc, jax.device_get(jstate.params["backbone"]))
    want = {k: v.clone() for k, v in state.model.backbone.state_dict().items()}
    got = init_or_restore(task, enc).model.backbone.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_cli_train_resume_and_test_on_the_cpu(toy, tmp_path, capsys):
    from mtp_tpu_torch.ckpt.store import CheckpointStore
    from mtp_tpu_torch.cli.test import main as port_test
    from mtp_tpu_torch.cli.train import main as port_train

    root = _spacenet(tmp_path / "data", n_train=5, n_val=2)
    wd, ck, enc = tmp_path / "wd", tmp_path / "ckpt", tmp_path / "enc.pth"
    common = [toy, "--data-root", root, "--batch-size", "2", "--device", "cpu",
              "--ckpt-dir", str(ck), "--ckpt-every", "1", "--work-dir", str(wd),
              "--log-every", "1", "--encoder-out", str(enc)]
    assert port_train(common + ["--steps", "2", "--num-workers", "2", "--eval-after"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["recipe"] == toy and math.isfinite(out["final"]["loss"])
    assert math.isfinite(out["eval"]["mIoU"])
    recs = _jsonl(wd / f"{toy}.jsonl")
    assert len(recs) == 2 and all(math.isfinite(r["loss"]) and r["data_time"] >= 0
                                  for r in recs)
    assert CheckpointStore(str(ck)).steps() == [1, 2] and enc.exists()

    assert port_train(common + ["--steps", "3", "--resume"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert math.isfinite(out["final"]["loss"])
    assert len(_jsonl(wd / f"{toy}.jsonl")) == 3  # one step more
    assert CheckpointStore(str(ck)).latest_step() == 3

    res = port_test([toy, "--ckpt", str(ck), "--data-root", root, "--device", "cpu",
                     "--save-pred", str(tmp_path / "pred")], return_metrics=True)
    assert math.isfinite(res["mIoU"])
    assert os.listdir(tmp_path / "pred") == ["pred_0.png"]
    # the encoder file and a whole-model variables file load too
    from mtp_tpu_torch.ckpt.store import save_variables
    from mtp_tpu_torch.cli.train import build_task, init_or_restore
    task, _ = build_task(pconfigs.get(toy), -1, 1, device="cpu")
    state = init_or_restore(task, str(ck))
    assert state.step == 3
    save_variables(str(tmp_path / "vars.pth"), state.model)
    res_vars = port_test([toy, "--ckpt", str(tmp_path / "vars.pth"), "--data-root", root,
                          "--device", "cpu"], return_metrics=True)
    assert res_vars == res
    res_enc = port_test([toy, "--ckpt", str(enc), "--data-root", root, "--device", "cpu"],
                        return_metrics=True)
    assert math.isfinite(res_enc["mIoU"])
    assert port_test([toy, "--ckpt", str(ck), "--data-root", root, "--device", "cpu",
                      "--save-labels", str(tmp_path / "labels")]) == 0
    lab = np.asarray(Image.open(tmp_path / "labels" / "0.png"))
    assert lab.shape == (96, 80) and lab.dtype == np.uint8 and lab.max() <= 1


@pytest.mark.parametrize("name", [
    "vit-rvsa-b-224-mae-mtp_eurosat", "rvsa-b-upernet-384-mae-mtp-spacenetv1",
    "rvsa-b-unet-256-mae-mtp_levir", "faster_rcnn_rvsa_b_800_mae_mtp_dior",
    "oriented_rcnn_rvsa_b_800_mae_mtp_diorr", "mask_rcnn_rvsa_b_1024_mae_mtp_coco",
    "mtp_vit_b_rvsa_448_samrs"])
def test_synthetic_data_matches_jax(name):
    from mtp_tpu.cli.train import synthetic_data as jax_synthetic
    from mtp_tpu_torch.cli.train import shrink_recipe, synthetic_data
    jr = dataclasses.replace(jconfigs.get(name), task=dataclasses.replace(
        jconfigs.get(name).task, backbone=dataclasses.replace(
            jconfigs.get(name).task.backbone, img_size=32)))
    pr = shrink_recipe(pconfigs.get(name), 32)
    jg, pg = jax_synthetic(jr.task, 2), synthetic_data(pr.task, 2)
    for i in range(2):
        same(next(jg), next(pg), f"batch {i}")


def test_detection_heads_and_list(capsys):
    from mtp_tpu_torch.cli.train import detection_head, main as port_train
    heads = {n: detection_head(pconfigs.get(n)) for n in pconfigs.available()
             if pconfigs.get(n).task.task in ("detection_h", "detection_r", "instseg")}
    assert set(heads.values()) == {"faster_rcnn", "retinanet", "mask_rcnn", "oriented_rcnn"}
    assert heads["retinanet_rvsa_l_416_mae_mtp_xview"] == "retinanet"
    assert heads["mask_rcnn_intern_xl_1024_imp_coco"] == "mask_rcnn"
    assert port_train(["--list", "x"]) == 0
    assert capsys.readouterr().out.split() == pconfigs.available()
