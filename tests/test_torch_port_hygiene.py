"""The port imports without jax, flax or the JAX package `mtp_tpu` (the
machine with the card has neither jax nor flax, and `chip_smoke.py` imports
nothing of the JAX package), keeps its config copies equal to mtp_tpu's,
builds its kernels only on demand, and never falls back: without nvcc the
build raises an error that names it."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from mtp_tpu_torch.kernels import _build

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

SLICE_MODULES = [
    "mtp_tpu_torch",
    "mtp_tpu_torch.config",
    "mtp_tpu_torch.kernels._build",
    "mtp_tpu_torch.ops.rel_pos",
    "mtp_tpu_torch.ops.dcnv3_sample",
    "mtp_tpu_torch.ops.grid_sample",
    "mtp_tpu_torch.ops.fused_attn",
    "mtp_tpu_torch.ops.dropout",
    "mtp_tpu_torch.ops.dcnv3",
    "mtp_tpu_torch.models.vit_rvsa",
    "mtp_tpu_torch.models.internimage",
    "mtp_tpu_torch.models.backbones",
    "mtp_tpu_torch.models.segmentor",
    "mtp_tpu_torch.heads.upernet",
    "mtp_tpu_torch.eval.slide",
    "mtp_tpu_torch.eval.metrics",
    "mtp_tpu_torch.core.optim",
    "mtp_tpu_torch.core.train",
    "mtp_tpu_torch.tasks._fit",
    "mtp_tpu_torch.tasks.segmentation",
    "mtp_tpu_torch.tasks.classification",
    "mtp_tpu_torch.tasks.change_detection",
    "mtp_tpu_torch.models.classifier",
    "mtp_tpu_torch.models.change_detection",
    "mtp_tpu_torch.heads.linear_cls",
    "mtp_tpu_torch.heads.unet",
    "mtp_tpu_torch.heads.fpn",
    "mtp_tpu_torch.ckpt.from_jax",
    "mtp_tpu_torch.ckpt.torch_convert",
    "mtp_tpu_torch.ckpt.store",
    "mtp_tpu_torch.ops.boxes",
    "mtp_tpu_torch.ops.anchors",
    "mtp_tpu_torch.ops.nms",
    "mtp_tpu_torch.ops.assign",
    "mtp_tpu_torch.ops.roi_align",
    "mtp_tpu_torch.ops.rotated_boxes",
    "mtp_tpu_torch.heads.rpn",
    "mtp_tpu_torch.heads.roi_heads",
    "mtp_tpu_torch.models.detector",
    "mtp_tpu_torch.tasks.detection",
    "mtp_tpu_torch.tasks.detection_task",
    "mtp_tpu_torch.eval.det_map",
    "mtp_tpu_torch.eval.masks",
    "mtp_tpu_torch.eval.coco_eval",
    "mtp_tpu_torch.models.retinanet",
    "mtp_tpu_torch.models.multitask",
    "mtp_tpu_torch.tasks.multitask",
    "mtp_tpu_torch.configs",
    "mtp_tpu_torch.utils.log",
    "mtp_tpu_torch.utils.native",
    "mtp_tpu_torch.data.transforms",
    "mtp_tpu_torch.data.parsers",
    "mtp_tpu_torch.data.pipelines",
    "mtp_tpu_torch.data.datasets",
    "mtp_tpu_torch.data.loader",
    "mtp_tpu_torch.data.bindings",
    "mtp_tpu_torch.eval.host_masks",
    "mtp_tpu_torch.eval.coco_results",
    "mtp_tpu_torch.eval.tta",
    "mtp_tpu_torch.cli.train",
    "mtp_tpu_torch.cli.test",
    "mtp_tpu_torch.cli.convert",
    "mtp_tpu_torch.parallel",
    "mtp_tpu_torch.parallel.mesh",
    "mtp_tpu_torch.parallel.tensor",
    "mtp_tpu_torch.ops.carafe",
    "mtp_tpu_torch.kernels.ops",
    "mtp_tpu_torch.serving",
    "mtp_tpu_torch.cli.export",
    "chip_smoke",
]

# the ten kernel sources of the serving, training and detection paths
KERNEL_SOURCES = {
    "window_attn_fwd.cu", "flash_attn_fwd.cu", "bilinear_sample_fwd.cu",
    "window_attn_bwd.cu", "flash_attn_bwd.cu", "bilinear_sample_bwd.cu",
    "window_attn_fwd_large.cu", "window_attn_bwd_qblk.cu", "nms.cu", "rotated_iou.cu"}


def test_imports_without_jax_flax_or_the_jax_package():
    code = textwrap.dedent(f"""
        import importlib, sys
        for blocked in ("jax", "flax", "mtp_tpu"):
            sys.modules[blocked] = None  # any import of them raises
        for name in {SLICE_MODULES!r}:
            importlib.import_module(name)
        from mtp_tpu_torch.kernels import _build
        from mtp_tpu_torch.utils import native
        assert _build._lib is None, "a kernel library was loaded at import"
        assert native._lib is None and not native._tried, \
            "the native host library was loaded at import"
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "flax", "mtp_tpu", "triton")
                     and sys.modules[m] is not None)
        assert not bad, bad
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_config_copies_match_the_jax_package():
    import dataclasses

    from mtp_tpu.utils import config as jc
    from mtp_tpu_torch import config as pc

    from mtp_tpu import configs as jrecipes

    for name in ("BackboneConfig", "SlideConfig", "OptimizerConfig",
                 "ScheduleConfig", "MeshConfig", "TrainConfig", "TaskConfig"):
        want = [(f.name, f.type, f.default) for f in dataclasses.fields(getattr(jc, name))]
        got = [(f.name, f.type, f.default) for f in dataclasses.fields(getattr(pc, name))]
        assert got == want, name
        # default_factory fields: the built defaults agree too
        assert dataclasses.asdict(getattr(pc, name)()) == \
            dataclasses.asdict(getattr(jc, name)()), name
    for factory in ("vit_b_rvsa", "vit_l_rvsa"):
        for kw in ({}, {"out_indices": (1, 2, 3, 4), "drop_path_rate": 0.3}):
            assert dataclasses.asdict(getattr(pc, factory)(384, **kw)) == \
                dataclasses.asdict(getattr(jc, factory)(384, **kw))
    # the recipes that chip_smoke.py runs, each with its other init tag
    from mtp_tpu_torch import configs as precipes
    for name in ("rvsa-l-upernet-384-mae-mtp-spacenetv1",
                 "rvsa-l-upernet-384-mae-spacenetv1",
                 "vit-rvsa-l-224-mae-mtp_eurosat", "vit-rvsa-l-224-mae_eurosat",
                 "intern-xl-224-imp-mtp_eurosat", "intern-xl-224-imp_eurosat",
                 "rvsa-l-unet-256-mae-mtp_levir", "rvsa-l-unet-256-mae_levir",
                 "intern-xl-unet-256-imp-mtp_levir", "intern-xl-unet-256-imp_levir",
                 "faster_rcnn_rvsa_l_800_mae_mtp_dior", "faster_rcnn_rvsa_l_800_mae_dior",
                 "faster_rcnn_intern_xl_800_imp_mtp_dior",
                 "faster_rcnn_intern_xl_800_imp_dior",
                 "oriented_rcnn_rvsa_l_800_mae_mtp_diorr",
                 "oriented_rcnn_rvsa_l_800_mae_diorr",
                 "oriented_rcnn_intern_xl_800_imp_mtp_diorr",
                 "oriented_rcnn_intern_xl_800_imp_diorr",
                 "mask_rcnn_rvsa_l_1024_mae_mtp_coco", "mask_rcnn_rvsa_l_1024_mae_coco",
                 "mask_rcnn_intern_xl_1024_imp_mtp_coco",
                 "mask_rcnn_intern_xl_1024_imp_coco",
                 "retinanet_rvsa_l_416_mae_mtp_xview", "retinanet_rvsa_l_416_mae_xview",
                 "retinanet_intern_xl_416_imp_mtp_xview",
                 "retinanet_intern_xl_416_imp_xview"):
        assert dataclasses.asdict(precipes.get(name).task) == \
            dataclasses.asdict(jrecipes.get(name).task), name
    from mtp_tpu.models.retinanet import RetinaConfig as JaxRetinaConfig
    assert [(f.name, f.type, f.default) for f in dataclasses.fields(pc.RetinaConfig)] == \
        [(f.name, f.type, f.default) for f in dataclasses.fields(JaxRetinaConfig)]
    for kw in ({}, {"num_classes": 5, "score_thr": 0.01, "max_per_img": 16}):
        assert dataclasses.asdict(pc.RetinaConfig(**kw)) == \
            dataclasses.asdict(JaxRetinaConfig(**kw))
    from mtp_tpu.models.detector import DetConfig as JaxDetConfig
    from mtp_tpu.models.detector import oriented_rcnn_cfg as jax_oriented_rcnn_cfg
    from mtp_tpu_torch.models.detector import DetConfig, oriented_rcnn_cfg
    assert [(f.name, f.type, f.default) for f in dataclasses.fields(DetConfig)] == \
        [(f.name, f.type, f.default) for f in dataclasses.fields(JaxDetConfig)]
    for num_classes in (15, 20, 37):
        assert dataclasses.asdict(oriented_rcnn_cfg(num_classes)) == \
            dataclasses.asdict(jax_oriented_rcnn_cfg(num_classes))
    masked = DetConfig(num_classes=80, with_mask=True)
    assert dataclasses.asdict(masked) == \
        dataclasses.asdict(JaxDetConfig(num_classes=80, with_mask=True))
    assert DetConfig(**dataclasses.asdict(masked)) == masked
    # the mesh check (`parallel.mesh.make_mesh`): one process here, so data
    # × model must be 1; a model axis that does not divide the heads is
    # refused too (`parallel.tensor.check_model`)
    from mtp_tpu_torch.models.vit_rvsa import ViTRVSA
    from mtp_tpu_torch.parallel.mesh import make_mesh
    from mtp_tpu_torch.parallel.tensor import check_model
    with pytest.raises(ValueError, match="world"):
        make_mesh(pc.MeshConfig(data=4))
    with pytest.raises(ValueError, match="model=2"):
        make_mesh(pc.MeshConfig(data=1, model=2))
    with pytest.raises(ValueError, match="num_heads"):
        check_model(ViTRVSA(pc.BackboneConfig(img_size=32, embed_dim=24, depth=1, num_heads=3,
                                              interval=1, out_indices=(0,) * 4)), 2)
    assert make_mesh(pc.MeshConfig(data=1, model=-1)).data == 1


@pytest.mark.parametrize("factory", ["mtp_vit_b_rvsa_448_samrs", "mtp_vit_l_rvsa_448_samrs",
                                     "mtp_internimage_xl_448_samrs"])
def test_multitask_recipes_match_the_jax_package(factory):
    """The multitask pretraining recipes field for field, and the SAMRS
    class counts."""
    import dataclasses

    from mtp_tpu import configs as jrecipes
    from mtp_tpu.models.multitask import SAMRS_CLASSES
    from mtp_tpu_torch import config as pc
    from mtp_tpu_torch import configs as precipes

    assert dataclasses.asdict(precipes.get(factory).task) == \
        dataclasses.asdict(jrecipes.get(factory).task)
    assert pc.SAMRS_CLASSES == SAMRS_CLASSES


def test_build_without_nvcc_raises_naming_it(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(force=True)


def test_build_runs_one_nvcc_per_source_then_links(monkeypatch, tmp_path):
    """With a stand-in nvcc that logs its arguments and writes its -o file:
    one `-c` compile per source, then one `-shared` link of all the objects
    into the library; no object file is left behind."""
    calls = tmp_path / "calls"
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys
        args = sys.argv[1:]
        with open({str(calls)!r}, "a") as f:
            f.write(" ".join(args) + "\\n")
        open(args[args.index("-o") + 1], "w").close()
    """))
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(fake.parent))
    build_dir = tmp_path / "_build"
    monkeypatch.setattr(_build, "BUILD", build_dir)
    monkeypatch.setattr(_build, "LIB", build_dir / "libmtp_kernels.so")
    assert _build.build(force=True) == build_dir / "libmtp_kernels.so"
    lines = [line.split() for line in calls.read_text().splitlines()]
    compiles, links = lines[:-1], lines[-1:]
    srcs = [str(p) for p in _build.sources()]
    assert len(srcs) == len(KERNEL_SOURCES)
    assert sorted(a[-1] for a in compiles) == srcs
    assert all("-c" in a and "arch=compute_90a,code=sm_90a" in a for a in compiles)
    assert "-shared" in links[0] and sorted(a[a.index("-o") + 1] for a in compiles) \
        == sorted(links[0][links[0].index("-o") + 2:])
    assert [p.name for p in build_dir.iterdir()] == ["libmtp_kernels.so"]


def test_library_is_stale_when_a_source_is_newer(tmp_path):
    lib = tmp_path / "libmtp_kernels.so"
    assert _build.stale(lib)
    lib.write_bytes(b"")
    newest = max(p.stat().st_mtime for p in _build.CSRC.iterdir())  # .cu, .cuh
    os.utime(lib, (newest + 10, newest + 10))
    assert not _build.stale(lib)
    os.utime(lib, (newest - 10, newest - 10))
    assert _build.stale(lib)


def test_every_kernel_source_has_a_launcher_and_note():
    """Each .cu defines one extern "C" launcher declared in SIGNATURES (R1's
    source two: its dense and mask forms) and says which TPU kernel it
    replaces, or, for a kernel of the port's own (N1, greedy NMS; R1,
    rotated IoU), which loops of the JAX package it takes the place of."""
    assert {p.name for p in _build.sources()} == KERNEL_SOURCES
    launchers = {}
    for src in _build.sources():
        text = src.read_text()
        names = [n for n in _build.SIGNATURES if f'extern "C" int {n}(' in text]
        assert len(names) == (2 if src.name == "rotated_iou.cu" else 1), (src.name, names)
        assert ("Replaces the TPU kernel mtp_tpu/" in text
                or "Port-only kernel: it replaces no pallas_call.  It takes the place "
                   "of the\n// lax loops of mtp_tpu/" in text), src.name
        launchers.update(dict.fromkeys(names, src.name))
    assert set(launchers) == set(_build.SIGNATURES)
