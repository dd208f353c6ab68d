"""The serving artifact of the detection families on the CPU, with
`test_torch_port_export.py`'s helpers: toy Faster, Oriented and Mask R-CNN
and RetinaNet recipes (the 2-block ViT, embed 32, 64² images, small
proposal and detection counts by --det-overrides) exported by
`cli.export.main([..., "--platforms", "cpu"])` and served by a process that
imports only `mtp_tpu_torch.serving`: the three files, the dict of
fixed-shape padded detections (and Mask R-CNN's mask logits) bit for bit
equal to the live predict in fp32, the live predict's launches (N1 twice a
Faster or Mask R-CNN predict, N1 and R1's mask form once an Oriented R-CNN
one, N1 once a RetinaNet one), a weight scaled by 0.9 changing the output,
no model code in the serving process; and the served Faster R-CNN
artifact, exported from JAX's variables through `ckpt/from_jax.py`,
against `mtp_tpu`'s own predict on the same weights and images, by
`test_torch_port_detection.py`'s rules (valid and labels equal, scores
within 1e-5, boxes within 1e-4)."""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.ckpt.store import save_variables as jax_save_variables
from mtp_tpu.models.detector import DetConfig as JDetConfig
from mtp_tpu.models.detector import TwoStageDetector as JDetector
from mtp_tpu.tasks import detection as jdet
from mtp_tpu_torch import config as pc
from test_torch_port_detection import BB, SMALL, _randomise, make_batch
from test_torch_port_export import (MODEL_CODE, VIT_FWD, Family, _seg_cfg, check_artifact,
                                    export_and_serve, same)

torch.set_num_threads(1)

PORT_BB = pc.BackboneConfig(**dataclasses.asdict(BB))
SMALL_OV = {k: v for k, v in SMALL.items() if k != "num_classes"}


def _det_cfg(kind: str):
    return lambda: _seg_cfg(task=kind, num_classes=3, slide=None, backbone=PORT_BB)


@functools.cache
def _jax_faster():
    """JAX's toy Faster R-CNN (`test_torch_port_detection.py`'s oracle:
    seeded weights, non-zero biases) and its jitted predict."""
    det = JDetConfig(**SMALL)
    model = JDetector(BB, det)
    img = jnp.asarray(make_batch()["image"])
    params = jax.jit(model.init)(jax.random.PRNGKey(0), img[:1])["params"]
    variables = jax.device_get({"params": _randomise(params, np.random.default_rng(1))})
    anchors = jdet.anchors_for(det, (BB.img_size, BB.img_size))
    predict = jax.jit(lambda v, x: jdet.detection_predict(model, v, x, anchors))
    return variables, predict


def _jax_faster_npz(tmp: Path) -> str:
    path = str(tmp / "toy_faster_jax.npz")
    jax_save_variables(path, _jax_faster()[0])
    return path


FAMILIES = [
    Family("toy-faster", _det_cfg("detection_h"), [(2, 64, 64, 3)], {**VIT_FWD, "nms": 2},
           flags=["--batch-size", "2"], overrides=SMALL_OV, ckpt=_jax_faster_npz,
           data=lambda: [make_batch()["image"]]),
    Family("toy-oriented", _det_cfg("detection_r"), [(1, 64, 64, 3)],
           {**VIT_FWD, "nms": 1, "nms_rotated": 1},
           overrides=SMALL_OV),
    Family("toy-mask", _det_cfg("instseg"), [(1, 64, 64, 3)], {**VIT_FWD, "nms": 2},
           overrides=SMALL_OV),
    Family("toy-retinanet", _det_cfg("detection_h"), [(1, 64, 64, 3)], {**VIT_FWD, "nms": 1},
           overrides=dict(max_per_img=16, max_gts=8, score_thr=0.001)),
]
KINDS = {"toy-faster": "detection_h", "toy-oriented": "detection_r", "toy-mask": "instseg",
         "toy-retinanet": "detection_h"}
KEYS = {"toy-mask": {"boxes", "scores", "labels", "valid", "mask_logits"}}
NAMES = [f.name for f in FAMILIES]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return export_and_serve(FAMILIES, tmp_path_factory.mktemp("export_det"))


@pytest.mark.parametrize("name", NAMES)
def test_export_writes_the_artifact(served, name):
    check_artifact(served[name], FAMILIES[NAMES.index(name)], KINDS[name])


@pytest.mark.parametrize("name", NAMES)
def test_served_detections_equal_the_live_predict(served, name):
    r = served[name]
    assert same(r["served"], r["live"])
    assert set(r["served"]) == KEYS.get(name, {"boxes", "scores", "labels", "valid"})
    B = FAMILIES[NAMES.index(name)].inputs[0][0]
    assert r["served"]["boxes"].shape == (B, 16, 5 if name == "toy-oriented" else 4)


@pytest.mark.parametrize("name", NAMES)
def test_served_launches_equal_the_live_predict(served, name):
    r = served[name]
    assert r["served_launches"] == r["live_launches"] == FAMILIES[NAMES.index(name)].launches


@pytest.mark.parametrize("name", NAMES)
def test_a_scaled_weight_changes_the_served_detections(served, name):
    r = served[name]
    assert not same(r["control"], r["live"])


def test_the_serving_process_imports_no_model_code(served):
    leaked = [m for m in served["modules"]
              if any(m == p or m.startswith(p + ".") for p in MODEL_CODE)]
    assert "mtp_tpu_torch.serving" in served["modules"] and not leaked, leaked


def test_served_faster_rcnn_matches_jax(served):
    """The artifact exported from JAX's variables against `mtp_tpu`'s
    `detection_predict` on the same weights and images."""
    r = served["toy-faster"]
    variables, predict = _jax_faster()
    want = predict(variables, jnp.asarray(r["inputs"][0].numpy()))
    got = {k: v.numpy() for k, v in r["served"].items()}
    assert got["valid"].any()
    np.testing.assert_array_equal(got["valid"], np.asarray(want.valid))
    np.testing.assert_array_equal(got["labels"], np.asarray(want.labels))
    np.testing.assert_allclose(got["scores"], np.asarray(want.scores), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got["boxes"], np.asarray(want.boxes), atol=1e-4, rtol=1e-5)
