"""The serving artifact on the CPU: the forward kernels as registered ops
(`mtp_tpu_torch.kernels.ops`), `mtp_tpu_torch.serving` and
`mtp_tpu_torch.cli.export`.

- `torch.library.opcheck` on each `mtp::` op over its routes (K1 at N = 49,
  K1L at N = 387, K2, K3 at P = 1 and P = 9, `nms_keep` with 4 and 5
  coordinates, R1's dense form), and each op's fake shapes and dtypes equal
  to what its plain version returns, in fp32 and float64;
- toy recipes (the 2-block ViT, embed 32) of segmentation (one 64² crop,
  and a 96² tile the slide protocol covers with 4 crops), classification
  and change detection: `cli.export.main([..., "--platforms", "cpu"])`
  writes the three files, meta.json with JAX's keys; a process that imports
  only `mtp_tpu_torch.serving` (`torch_serve_worker.py`) serves each
  artifact, bit for bit equal to the live predict in fp32, with the live
  predict's launches (kernel routes forced on the CPU, as the launch-count
  tests force them), a weight scaled by 0.9 changing its output, and no
  model code, JAX or `mtp_tpu` among its modules;
- the served one-crop segmentation artifact, exported from a JAX `.npz`
  through `ckpt/from_jax.py`, against `mtp_tpu`'s own predict on the same
  weights (`test_torch_port_cli.py`'s near-tie rule);
- multitask, `--platforms tpu` and a misplaced `--tile-size` raise
  SystemExit, and `load_artifact` refuses a device the artifact has no
  program for.

`test_torch_port_export_det.py` does the detection families with this
module's helpers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from mtp_tpu.ckpt.store import save_variables as jax_save_variables
from mtp_tpu.tasks.segmentation import SegmentationTask as JaxSegmentationTask
from mtp_tpu.utils import config as jc
from mtp_tpu_torch import config as pc
from mtp_tpu_torch import configs as pconfigs
from mtp_tpu_torch.ckpt.store import save_variables
from mtp_tpu_torch.cli import export as cli_export
from mtp_tpu_torch.cli.train import build_task, init_or_restore
from mtp_tpu_torch.kernels import _build
from mtp_tpu_torch.ops import dcnv3_sample, fused_attn, nms, rotated_boxes
from mtp_tpu_torch.serving import load_artifact
from test_torch_port_cli import MAX_DISAGREE, NEAR_TIE, _toy_task

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# meta.json's keys: JAX's, with torch_version in place of jax_version
META_KEYS = {"recipe", "task", "num_classes", "img_size", "batch_size", "inputs", "outputs",
             "platforms", "torch_version"}
MODEL_CODE = ("mtp_tpu_torch.models", "mtp_tpu_torch.heads", "mtp_tpu_torch.tasks",
              "mtp_tpu_torch.configs", "mtp_tpu", "jax", "flax")
COUNTED = (fused_attn.LAUNCHES, dcnv3_sample.LAUNCHES, nms.LAUNCHES, rotated_boxes.LAUNCHES)
# a crop's forward of the toy ViT (an RVSA block, then a full-attention one)
VIT_FWD = {"window": 1, "flash": 1, "bilinear_sample": 2}


# ------------------------------------------------------------------ ops --

def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _rand(*shape, seed=0, dtype=torch.float32):
    return torch.randn(*shape, generator=_gen(seed), dtype=dtype)


def _boxes(B, N, D, seed):
    g = _gen(seed)
    xy = torch.rand(B, N, 2, generator=g) * 40
    wh = torch.rand(B, N, 2, generator=g) * 20 + 2
    if D == 4:
        return torch.cat([xy, xy + wh], -1)
    return torch.cat([xy, wh, torch.rand(B, N, 1, generator=g) * 3 - 1.5], -1)


def _op_cases(dtype) -> Dict[str, Tuple[str, tuple]]:
    """name → (op, CPU inputs in `dtype` where the op takes it; the box
    ops take fp32 or float64 boxes, their plain versions both)."""
    r = lambda *s, seed: _rand(*s, seed=seed, dtype=dtype)
    img, taps = r(2, 6 * 7, 8, seed=7), (2, 20, 9)
    py, px = (torch.rand(*taps, generator=_gen(s), dtype=dtype) * 9 - 1 for s in (8, 9))
    return {
        "K1 N=49": ("window_attn_fwd", (r(2, 2, 49, 8, seed=1), r(2, 2, 49, 8, seed=2),
                                        r(2, 2, 49, 8, seed=3), r(2, 2, 49, 49, seed=4), 0.3)),
        "K1L N=387": ("window_attn_fwd_large", (r(1, 1, 387, 8, seed=1), r(1, 1, 387, 8, seed=2),
                                                r(1, 1, 387, 8, seed=3),
                                                r(1, 1, 387, 387, seed=4), 0.3)),
        "K2": ("flash_attn_fwd", (r(2, 12, 8, seed=1), r(2, 12, 8, seed=2), r(2, 12, 8, seed=3),
                                  r(2, 12, 3, seed=4), r(2, 12, 4, seed=5), [3, 4], 0.3)),
        "K3 P=1": ("bilinear_sample_fwd", (img, py[..., :1].contiguous(),
                                           px[..., :1].contiguous(), r(2, 20, 1, seed=6), 6, 7)),
        "K3 P=9": ("bilinear_sample_fwd", (img, py, px, r(*taps, seed=6), 6, 7)),
        "nms_keep 4": ("nms_keep", (_boxes(2, 70, 4, 10).to(dtype), r(2, 70, seed=11), 0.5)),
        "nms_keep 5": ("nms_keep", (_boxes(2, 70, 5, 12).to(dtype), r(2, 70, seed=13), 0.1)),
        "R1 dense": ("rbox_overlaps", (_boxes(2, 6, 5, 14).to(dtype), _boxes(2, 9, 5, 15).to(dtype),
                                       "iou")),
    }


CASES = list(_op_cases(torch.float32))


@pytest.mark.parametrize("case", CASES)
def test_op_passes_opcheck(case):
    """Schema, autograd registration, fake tensor and AOT dispatch checks of
    each registered op on CPU inputs (its plain version's route)."""
    op, args = _op_cases(torch.float32)[case]
    result = torch.library.opcheck(getattr(torch.ops.mtp, op).default, args)
    assert set(result.values()) == {"SUCCESS"}, result


def _meta(x):
    return [(tuple(t.shape), t.dtype) for t in ((x,) if torch.is_tensor(x) else x)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["fp32", "float64"])
@pytest.mark.parametrize("case", CASES)
def test_fake_shapes_equal_the_plain_versions(case, dtype):
    """Each op's fake implementation gives the shapes and dtypes its plain
    version (the body on CPU tensors) returns, in fp32 and float64, and no
    launch is counted while either runs."""
    op, args = _op_cases(dtype)[case]
    fn = getattr(torch.ops.mtp, op).default
    before = [dict(c) for c in COUNTED]
    plain = fn(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = fn(*(mode.from_tensor(a) if torch.is_tensor(a) else a for a in args))
    assert _meta(fake) == _meta(plain)
    assert [dict(c) for c in COUNTED] == before


def test_ops_route_by_device_with_the_kernel_launch_inside_the_op(monkeypatch):
    """The wrappers' forwards go through the ops, and the ops' bodies are
    the wrappers' bodies: with the kernel route forced on the CPU, one call
    of each public wrapper launches its kernel once, by the launcher the
    body names."""
    launched = []
    monkeypatch.setattr(_build, "use_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "check_on_card", lambda *t, **k: None)
    monkeypatch.setattr(_build, "launch", lambda name, *a: launched.append(name))
    for c in COUNTED:
        for k in c:
            monkeypatch.setitem(c, k, c[k])  # restored after the test
    q = _rand(2, 2, 49, 64, seed=1)
    fused_attn.fused_window_attention(q, q, q, _rand(2, 2, 49, 49, seed=2), 0.1)
    fused_attn.flash_full_attention(_rand(2, 12, 16, seed=3), _rand(2, 12, 16, seed=4),
                                    _rand(2, 12, 16, seed=5), _rand(2, 12, 3, seed=6),
                                    _rand(2, 12, 4, seed=7), (3, 4), 0.1)
    dcnv3_sample.dcnv3_sample(_rand(2, 42, 8, seed=8), _rand(2, 20, 1, seed=9),
                              _rand(2, 20, 1, seed=10), _rand(2, 20, 1, seed=11), 6, 7)
    nms.nms_batched(_boxes(1, 8, 4, 12), _rand(1, 8, seed=13), 0.5, 4)
    nms.nms_batched(_boxes(1, 8, 5, 14), _rand(1, 8, seed=15), 0.5, 4)
    rotated_boxes.rbox_overlaps(_boxes(1, 3, 5, 16), _boxes(1, 4, 5, 17))
    assert launched == ["mtp_window_attn_fwd", "mtp_flash_attn_fwd", "mtp_bilinear_sample_fwd",
                        "mtp_nms", "mtp_nms_rotated", "mtp_rbox_iou"]


# ------------------------------------------------------------ artifacts --

@dataclasses.dataclass
class Family:
    """A toy recipe registered under `name` in the port's registry, its
    cli.export flags, the shapes of its inputs and the launches of one
    predict with the kernel routes forced; `ckpt` makes its --ckpt file
    (default: the port's variables of the task's seeded state)."""

    name: str
    cfg: Callable[[], object]
    inputs: List[Tuple[int, ...]]
    launches: Dict[str, int]
    flags: List[str] = dataclasses.field(default_factory=list)
    overrides: Optional[dict] = None
    ckpt: Optional[Callable[[Path], str]] = None
    data: Optional[Callable[[], List[np.ndarray]]] = None  # default: seeded N(0, 1)

    @property
    def tile(self) -> Optional[int]:
        return int(self.flags[self.flags.index("--tile-size") + 1]) \
            if "--tile-size" in self.flags else None


@contextlib.contextmanager
def stubbed_kernels():
    """Every kernel route taken on the CPU with its launch not run and its
    outputs zeroed (as `test_torch_port_oriented.py`'s launch counts); the
    counters start at 0 and are restored after."""
    saved = [dict(c) for c in COUNTED]
    for c in COUNTED:
        c.update(dict.fromkeys(c, 0))
    with mock.patch.object(_build, "use_kernel", lambda *t: True), \
            mock.patch.object(_build, "check_on_card", lambda *t, **k: None), \
            mock.patch.object(_build, "launch", lambda name, *a: None), \
            mock.patch.object(torch, "empty", torch.zeros), \
            mock.patch.object(torch, "empty_like", torch.zeros_like):
        try:
            yield
        finally:
            for c, s in zip(COUNTED, saved):
                c.clear()
                c.update(s)


def moved() -> Dict[str, int]:
    return {k: v for c in COUNTED for k, v in c.items() if v}


def register(mp: pytest.MonkeyPatch, name: str, cfg, dataset: str = "toy") -> None:
    mp.setitem(pconfigs._REGISTRY, name, lambda: pconfigs.Recipe(name, cfg, dataset=dataset,
                                                                 init="mae-mtp"))


def export_and_serve(families: List[Family], tmp: Path) -> dict:
    """Each family exported by `cli.export.main` from its --ckpt, its live
    predict (`build_export_fn`'s function, eager) on its inputs with and
    without the kernel routes forced, then one serving process for all:
    {name: dict(art, meta, live, live_launches, served, control,
    served_launches)}, "modules": the serving process's}."""
    out, jobs = {}, []
    with pytest.MonkeyPatch.context() as mp:
        for i, fam in enumerate(families):
            register(mp, fam.name, fam.cfg())
            task, cfg = build_task(pconfigs.get(fam.name), 1, 1, fam.overrides, device="cpu")
            if fam.ckpt is None:
                ckpt = str(tmp / f"{fam.name}.pt")
                state = init_or_restore(task, None, seed=i)
                save_variables(ckpt, state.model)
            else:
                ckpt = fam.ckpt(tmp)
                state = init_or_restore(task, ckpt)
            art = tmp / fam.name
            flags = fam.flags + (["--det-overrides", json.dumps(fam.overrides)]
                                 if fam.overrides else [])
            assert cli_export.main([fam.name, "--out", str(art), "--ckpt", ckpt,
                                    "--platforms", "cpu", *flags]) == 0
            predict, _, _ = cli_export.build_export_fn(task, cfg, fam.tile)
            rng = np.random.default_rng(100 + i)
            data = fam.data() if fam.data else [rng.standard_normal(s).astype(np.float32)
                                                for s in fam.inputs]
            inputs = [torch.from_numpy(np.ascontiguousarray(a)) for a in data]
            state.model.eval()
            with torch.no_grad():
                live = predict(*inputs)
                with stubbed_kernels():
                    predict(*inputs)
                    live_launches = moved()
            torch.save(inputs, tmp / f"{fam.name}.in.pt")
            control = next(k for k in state.model.state_dict()
                           if k.startswith("backbone.patch_embed.") and k.endswith("weight"))
            jobs.append(dict(name=fam.name, dir=str(art), inputs=str(tmp / f"{fam.name}.in.pt"),
                             result=str(tmp / f"{fam.name}.out.pt"), control=control))
            with open(art / "meta.json") as f:
                meta = json.load(f)
            out[fam.name] = dict(art=art, meta=meta, live=live, inputs=inputs, task=task,
                                 live_launches=live_launches)
    spec = tmp / "jobs.json"
    spec.write_text(json.dumps({"threads": torch.get_num_threads(), "jobs": jobs}))
    res = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_serve_worker.py"),
                          str(spec)], capture_output=True, text=True, timeout=600, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr[-6000:]
    report = json.loads(res.stdout.strip().splitlines()[-1])
    for job in jobs:
        got = torch.load(job["result"], weights_only=True)
        out[job["name"]].update(served=got["out"], control=got["control"],
                                served_launches=report[job["name"]]["launches"])
    out["modules"] = report["modules"]
    return out


def same(a, b) -> bool:
    """Bit for bit: equal tensors, or dicts of them with the same keys."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def check_artifact(r: dict, fam: Family, task_kind: str) -> None:
    """The three files, meta.json's keys and values."""
    assert sorted(os.listdir(r["art"])) == ["meta.json", "model.cpu.pt2", "weights.pt"]
    meta = r["meta"]
    assert set(meta) == META_KEYS
    assert meta["recipe"] == fam.name and meta["task"] == task_kind
    assert meta["platforms"] == ["cpu"] and meta["torch_version"] == torch.__version__
    assert [tuple(i["shape"]) for i in meta["inputs"]] == fam.inputs
    assert meta["batch_size"] == fam.inputs[0][0]
    assert {i["dtype"] for i in meta["inputs"]} == {"float32"}


def _seg_cfg(C=pc, **kw):
    return dataclasses.replace(_toy_task(C), **kw)


def _vit_task(kind: str, num_classes: int):
    return lambda: _seg_cfg(task=kind, num_classes=num_classes, slide=None)


@functools.cache
def _jax_seg() -> Tuple[JaxSegmentationTask, dict]:
    """JAX's toy segmentation task and its seeded variables."""
    jtask = JaxSegmentationTask(_toy_task(jc))
    init = jax.jit(lambda key: jtask.model.init(key, jnp.zeros((1, 64, 64, 3)), train=True))
    return jtask, jax.device_get(init(jax.random.PRNGKey(3)))


def _jax_seg_npz(tmp: Path) -> str:
    """JAX's toy segmentor's variables (`mtp_tpu.ckpt.store.save_variables`),
    which the port reads through `ckpt.from_jax.segmentor_from_jax`."""
    path = str(tmp / "toy_seg_jax.npz")
    jax_save_variables(path, _jax_seg()[1])
    return path


FAMILIES = [
    Family("toy-seg-crop", _seg_cfg, [(2, 64, 64, 3)], VIT_FWD, flags=["--batch-size", "2"],
           ckpt=_jax_seg_npz),
    Family("toy-seg-slide", _seg_cfg, [(1, 96, 96, 3)],
           {k: 4 * n for k, n in VIT_FWD.items()}, flags=["--tile-size", "96"]),
    Family("toy-cls", _vit_task("classification", 5), [(2, 64, 64, 3)], VIT_FWD,
           flags=["--batch-size", "2"]),
    Family("toy-cd", _vit_task("change_detection", 2), [(2, 64, 64, 3), (2, 64, 64, 3)],
           VIT_FWD, flags=["--batch-size", "2"]),
]
KINDS = {"toy-seg-crop": "segmentation", "toy-seg-slide": "segmentation",
         "toy-cls": "classification", "toy-cd": "change_detection"}
NAMES = [f.name for f in FAMILIES]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return export_and_serve(FAMILIES, tmp_path_factory.mktemp("export"))


@pytest.mark.parametrize("name", NAMES)
def test_export_writes_the_artifact(served, name):
    fam = FAMILIES[NAMES.index(name)]
    check_artifact(served[name], fam, KINDS[name])


@pytest.mark.parametrize("name", NAMES)
def test_served_outputs_equal_the_live_predict(served, name):
    r = served[name]
    assert same(r["served"], r["live"])
    want = {"toy-seg-crop": (2, 64, 64), "toy-seg-slide": (1, 96, 96), "toy-cls": (2, 5),
            "toy-cd": (2, 64, 64)}[name]
    assert tuple(r["served"].shape) == want


@pytest.mark.parametrize("name", NAMES)
def test_served_launches_equal_the_live_predict(served, name):
    """Per crop (the slide tile: 4) and per predict."""
    r = served[name]
    assert r["served_launches"] == r["live_launches"] == FAMILIES[NAMES.index(name)].launches


@pytest.mark.parametrize("name", NAMES)
def test_a_scaled_weight_changes_the_served_output(served, name):
    r = served[name]
    assert not same(r["control"], r["live"])


def test_the_serving_process_imports_no_model_code(served):
    modules = served["modules"]
    assert "mtp_tpu_torch.serving" in modules and "mtp_tpu_torch.kernels.ops" in modules
    leaked = [m for m in modules if any(m == p or m.startswith(p + ".") for p in MODEL_CODE)]
    assert not leaked, leaked


def test_served_segmentation_matches_jax(served, tmp_path):
    """The one-crop artifact, exported from JAX's variables, against
    `mtp_tpu`'s jitted predict on the same weights and images: per-pixel
    classes equal but where the port's top two logits lie within NEAR_TIE,
    at most MAX_DISAGREE of the pixels."""
    r = served["toy-seg-crop"]
    jtask, variables = _jax_seg()
    want = np.asarray(jtask.predict_fn()(variables, r["inputs"][0].numpy()))
    got = r["served"].numpy()
    logits = r["task"].slide_logits(r["inputs"][0]).numpy()
    top2 = np.sort(logits, -1)[..., -2:]
    near = (top2[..., 1] - top2[..., 0]) <= NEAR_TIE
    diff = got != want
    assert not (diff & ~near).any(), "classes differ away from a near tie"
    assert diff.sum() <= MAX_DISAGREE * diff.size


def test_refusals(served):
    """Multitask has no export path (JAX's SystemExit); the port serves on
    cuda and cpu only; --tile-size takes a slide segmentation recipe;
    `load_artifact` refuses a device the artifact has no program for."""
    with pytest.raises(SystemExit, match="multitask"):
        cli_export.build_export_fn(None, pconfigs.get("mtp_vit_l_rvsa_448_samrs").task)
    with pytest.raises(SystemExit, match="serves on"):
        cli_export.main(["toy-seg-crop", "--out", "unused", "--platforms", "tpu"])
    with pytest.raises(SystemExit, match="tile-size"):
        cli_export.build_export_fn(None, _vit_task("classification", 5)(), 96)
    with pytest.raises(FileNotFoundError, match="no program for cuda"):
        load_artifact(str(served["toy-cls"]["art"]), "cuda")
