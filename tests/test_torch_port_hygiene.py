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
    "mtp_tpu_torch.models.vit_rvsa",
    "mtp_tpu_torch.models.backbones",
    "mtp_tpu_torch.models.segmentor",
    "mtp_tpu_torch.heads.upernet",
    "mtp_tpu_torch.eval.slide",
    "mtp_tpu_torch.tasks.segmentation",
    "mtp_tpu_torch.ckpt.from_jax",
    "chip_smoke",
]


def test_imports_without_jax_flax_or_the_jax_package():
    code = textwrap.dedent(f"""
        import importlib, sys
        for blocked in ("jax", "flax", "mtp_tpu"):
            sys.modules[blocked] = None  # any import of them raises
        for name in {SLICE_MODULES!r}:
            importlib.import_module(name)
        from mtp_tpu_torch.kernels import _build
        assert _build._lib is None, "a kernel library was loaded at import"
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

    for name in ("BackboneConfig", "SlideConfig"):
        want = [(f.name, f.type, f.default) for f in dataclasses.fields(getattr(jc, name))]
        got = [(f.name, f.type, f.default) for f in dataclasses.fields(getattr(pc, name))]
        assert got == want, name
    for factory in ("vit_b_rvsa", "vit_l_rvsa"):
        for kw in ({}, {"out_indices": (1, 2, 3, 4), "drop_path_rate": 0.3}):
            assert dataclasses.asdict(getattr(pc, factory)(384, **kw)) == \
                dataclasses.asdict(getattr(jc, factory)(384, **kw))


def test_build_without_nvcc_raises_naming_it(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(force=True)


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
    """Each .cu defines one extern "C" launcher declared in SIGNATURES and
    says which TPU kernel it replaces."""
    launchers = {}
    for src in _build.sources():
        text = src.read_text()
        names = [n for n in _build.SIGNATURES if f'extern "C" int {n}(' in text]
        assert len(names) == 1, (src.name, names)
        assert "Replaces the TPU kernel mtp_tpu/" in text, src.name
        launchers[names[0]] = src.name
    assert set(launchers) == set(_build.SIGNATURES)
