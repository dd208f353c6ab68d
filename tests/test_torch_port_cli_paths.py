"""The port's CLI paths beyond training and evaluating a segmentation recipe
(`test_torch_port_cli.py`), on the CPU: the rotated submission path
(--format-only with --tta-flip, the patch merge, DOTA and FAIR1M files) and
--synthetic with box overlays; `cli.convert` on a released-style `.pth`;
the flags the port accepts without effect and the mesh it refuses; the
loggers of `utils/log.py`."""

from __future__ import annotations

import json
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_port_cli import _jsonl, toy  # noqa: F401  (toy: a fixture)

torch.set_num_threads(2)


def test_cli_flags_without_effect_and_mesh(toy, tmp_path, capsys):
    from mtp_tpu_torch.cli.train import main as port_train
    argv = [toy, "--synthetic", "--steps", "1", "--batch-size", "1", "--device", "cpu",
            "--work-dir", str(tmp_path), "--pallas", "--scan"]
    assert port_train(argv) == 0
    assert math.isfinite(json.loads(capsys.readouterr().out.strip().splitlines()[-1])
                         ["final"]["loss"])
    with pytest.raises(ValueError, match="world"):  # data parallel needs torchrun's 2
        port_train(argv + ["--mesh-data", "2"])
    with pytest.raises(SystemExit):
        port_train([toy, "--device", "cpu", "--work-dir", str(tmp_path)])


def test_cli_epochs(toy, tmp_path, capsys):
    """--epochs sets the run to ceil(len(train split) / batch) steps an
    epoch (5 tiles at batch 2: 3), as in JAX; with --steps, or without
    --data-root, it refuses."""
    from mtp_tpu_torch.cli.train import main as port_train
    from test_torch_port_cli import _spacenet

    root = _spacenet(tmp_path / "data", n_train=5, n_val=1)
    argv = [toy, "--data-root", root, "--epochs", "1", "--batch-size", "2",
            "--device", "cpu", "--log-every", "1", "--work-dir", str(tmp_path / "wd")]
    assert port_train(argv) == 0
    assert len(_jsonl(tmp_path / "wd" / f"{toy}.jsonl")) == 3
    with pytest.raises(SystemExit, match="not both"):
        port_train(argv + ["--steps", "2"])
    with pytest.raises(SystemExit, match="needs --data-root"):
        port_train([toy, "--epochs", "1", "--device", "cpu"])


def test_cli_convert_released_pth(tmp_path, capsys):
    """An MAE-style `.pth` (module. prefix, a cls token, pos_embed at grid
    14, no FPN) → the port's encoder file at 64² (grid 4), which the ViT-B
    backbone loads."""
    from mtp_tpu_torch.cli.convert import main as convert
    from mtp_tpu_torch.config import vit_b_rvsa
    from mtp_tpu_torch.models.backbones import build_backbone

    torch.manual_seed(0)
    model = build_backbone(vit_b_rvsa(224), features_only=True)
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    sd["module.cls_token"] = torch.zeros(1, 1, 768)
    sd["module.pos_embed"] = torch.cat([torch.zeros(1, 1, 768),
                                        sd["module.pos_embed"]], 1)
    torch.save({"model": sd}, tmp_path / "mae.pth")
    assert convert([str(tmp_path / "mae.pth"), str(tmp_path / "enc.pth"),
                    "--backbone", "vit_b_rvsa", "--img-size", "64", "--scan"]) == 0
    assert "without the FPN" in capsys.readouterr().out
    out = torch.load(tmp_path / "enc.pth", weights_only=True)
    assert out["pos_embed"].shape == (1, 16, 768)
    small = build_backbone(vit_b_rvsa(64), features_only=True)
    small.load_state_dict(out)
    torch.testing.assert_close(out["blocks.0.attn.qkv.weight"],
                               sd["module.blocks.0.attn.qkv.weight"])


def test_loggers(tmp_path):
    """`make_logger` writes its file, `JsonlLogger` one record a call with
    the metrics' own data_time, `Profiler` a Chrome trace of what ran
    between start and stop."""
    from mtp_tpu_torch.utils.log import JsonlLogger, Profiler, make_logger
    logger = make_logger(f"test_loggers_{os.getpid()}", log_file=str(tmp_path / "a.log"))
    logger.info("hello")
    assert "hello" in (tmp_path / "a.log").read_text()
    jl = JsonlLogger(str(tmp_path / "m" / "a.jsonl"))
    jl.log(0, {"loss": 1.5, "data_time": 0.25})
    jl.log(1, {"loss": 1.25}, note="x")
    jl.close()
    recs = _jsonl(tmp_path / "m" / "a.jsonl")
    assert [r["iter"] for r in recs] == [0, 1] and recs[0]["data_time"] == 0.25
    assert recs[1]["note"] == "x" and "memory" not in recs[1]
    prof = Profiler(str(tmp_path / "trace"))
    prof.start()
    torch.ones(64, 64) @ torch.ones(64, 64)
    prof.stop()
    prof.stop()  # a second stop is a no-op
    traces = os.listdir(tmp_path / "trace")
    assert len(traces) == 1 and json.loads((tmp_path / "trace" / traces[0]).read_text())


SMALL_DET = '{"nms_pre":64,"max_proposals":16,"rpn_num":16,"rcnn_num":8,"max_per_img":4}'


def test_cli_rotated_format_only_and_overlays(tmp_path, capsys):
    """The rotated submission path (--format-only with --tta-flip, the
    multi-scale patch merge, DOTA txts + zip and the FAIR1M xml tree, as
    JAX's test_cli_format_only_submission) and --synthetic with
    --save-pred's rotated box overlays, on the CPU at 64²."""
    from mtp_tpu_torch.cli.test import main as port_test
    from mtp_tpu_torch.data.datasets import DOTA10_CLASSES

    img_dir = tmp_path / "test" / "images"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for name in ("P0001__1.0__0___0", "P0001__0.5__0___32", "P0002__1.0__0___0"):
        Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8)).save(
            img_dir / f"{name}.png")
    recipe = "oriented_rcnn_rvsa_b_1024_mae_mtp_dota10"
    common = ["--img-size", "64", "--batch-size", "2", "--device", "cpu",
              "--det-overrides", SMALL_DET]
    assert port_test([recipe, "--data-root", str(tmp_path), "--split", "test",
                      "--format-only", "--fair1m", "--rescale-by-rate", "--tta-flip",
                      "--submission-dir", str(tmp_path / "submit")] + common) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["patches"] == 3 and out["images"] == 2  # P0001's patches merged
    txts = sorted(os.listdir(tmp_path / "submit"))
    assert txts == sorted(f"Task1_{c}.txt" for c in DOTA10_CLASSES)
    assert (tmp_path / "submit.zip").exists()
    assert sorted(x[:-4] for x in os.listdir(str(tmp_path / "submit") + "_xml")) == \
        ["P0001", "P0002"]
    for t in txts:
        for line in open(tmp_path / "submit" / t):
            assert line.split()[0] in ("P0001", "P0002")
    res = port_test([recipe, "--synthetic", "--batches", "1", "--save-pred",
                     str(tmp_path / "pred"), "--score-thr", "0"] + common,
                    return_metrics=True)
    assert math.isfinite(res["mAP"])
    assert sorted(os.listdir(tmp_path / "pred")) == ["pred_0.png", "pred_1.png"]
