"""The port's checkpointing against the JAX package's: the loading rules of
`mtp_tpu/ckpt/torch_convert.py` (prefixes, wrappers, the pos_embed and
rel-pos resizes) and a released-style backbone dict loaded at another grid
(`backbone_state_dict` against `convert_backbone` / `convert_internimage`,
through each side's backbone); a JAX `save_encoder` `.npz` in both layouts
through `load_encoder`; and the port's own store: `CheckpointStore`'s round
trip, `max_to_keep`, leftovers and the empty directory, `fit_loop`'s saves
and encoder export, and resume (save after step 2, restore into a fresh
task, step 3) bitwise equal to three uninterrupted steps, for a classifier
and a change detector (BatchNorm, dropout and drop-path included).

Small models, fp32 on both sides, inputs made with numpy from a seed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.ckpt import store as jstore
from mtp_tpu.ckpt import torch_convert as jtc
from mtp_tpu.models import internimage as ji
from mtp_tpu.models.vit_rvsa import ViTRVSA as JaxViTRVSA
from mtp_tpu.utils.config import BackboneConfig
from mtp_tpu_torch import config as pc
from mtp_tpu_torch.ckpt import store
from mtp_tpu_torch.ckpt import torch_convert as ptc
from mtp_tpu_torch.ckpt.from_jax import init_weights
from mtp_tpu_torch.models.change_detection import SiamChangeDetector
from mtp_tpu_torch.models.internimage import InternImage
from mtp_tpu_torch.models.vit_rvsa import ViTRVSA
from mtp_tpu_torch.tasks import _fit
from mtp_tpu_torch.tasks.change_detection import ChangeDetectionTask
from mtp_tpu_torch.tasks.classification import ClassificationTask

torch.set_num_threads(1)

# a ViT pretrained at 224² (grid 14, MAE cls token) finetuned at 256² (grid
# 16): blocks 1 and 3 are full attention, whose rel-pos tables go 27 → 31
VIT = BackboneConfig(img_size=256, embed_dim=32, depth=4, num_heads=2,
                     interval=2, out_indices=(0, 1, 2, 3), dtype="float32")
TINY_II = dataclasses.replace(ji.internimage_t(), channels=16, depths=(1, 1, 2, 1),
                              groups=(2, 4, 8, 16), dtype="float32",
                              drop_path_rate=0.0)
PORT_II = pc.InternImageConfig(**dataclasses.asdict(TINY_II))
FEAT_RTOL = 1e-5  # features, relative to each level's max |value|


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ----------------------------------------------------------- load rules --

_W = np.zeros(1, np.float32)


@pytest.mark.parametrize("keys", [
    ["module.encoder.a", "module.encoder.b"],
    ["encoder.blocks.0.w", "encoder.pos_embed"],
    ["encoder.blocks.0.w", "semsegdecoder.conv.w", "rotdetdecoder.x"],  # full pretrain
    ["module.blocks.0.w", "module.norm.weight"],
    ["blocks.0.w", "cls_token"],
    [],
], ids=["module+encoder", "encoder", "full-pretrain", "module", "raw", "empty"])
@pytest.mark.parametrize("wrap", [None, "state_dict", "model"])
def test_prefixes_and_wrappers_match_jax(keys, wrap):
    sd = {k: _W for k in keys}
    ckpt = sd if wrap is None else {wrap: sd, "meta": {"epoch": 3}}
    assert sorted(ptc.strip_prefixes(sd)) == sorted(jtc.strip_prefixes(sd))
    assert sorted(ptc.unwrap_checkpoint(ckpt)) == sorted(jtc.unwrap_checkpoint(ckpt))


@pytest.mark.parametrize("src,dst,cls", [(14, 16, True), (16, 14, False),
                                         (14, 14, True), (7, 12, False)])
def test_pos_embed_and_rel_pos_resize_match_jax(src, dst, cls):
    rng = np.random.default_rng(src * 100 + dst)
    pe = rng.standard_normal((1, src * src + cls, 8)).astype(np.float32)
    want = jtc.convert_pos_embed(pe, (dst, dst), cls)  # (1, H, W, D)
    got = ptc.convert_pos_embed(_t(pe), (dst, dst), cls)  # (1, H·W, D)
    np.testing.assert_allclose(got.numpy(), want.reshape(1, -1, 8), atol=1e-7, rtol=1e-6)
    tbl = rng.standard_normal((2 * src - 1, 8)).astype(np.float32)
    np.testing.assert_allclose(ptc.convert_rel_pos_table(_t(tbl), 2 * dst - 1).numpy(),
                               jtc.convert_rel_pos_table(tbl, 2 * dst - 1),
                               atol=1e-7, rtol=1e-6)


def _close_feats(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.detach().numpy(), w, atol=FEAT_RTOL * scale,
                                   rtol=FEAT_RTOL)


def _randomise(sd, rng, keys):
    """Random values for the tables a random init leaves zero (the rel-pos
    tables, the DCNv3 offset and mask regressors), so the resizes and the
    sampling are exercised."""
    for k in sd:
        if any(s in k for s in keys):
            sd[k] = _t(rng.standard_normal(sd[k].shape).astype(np.float32) * 0.3)
    return sd


@pytest.fixture(scope="module")
def released_vit():
    """A reference-name ViT state dict as a MAE-pretrained release holds it
    at 224²: grid-14 tables, a cls token in front of the pos_embed, the
    unused final norm, `module.encoder.` prefixes."""
    rng = np.random.default_rng(0)
    src = dataclasses.replace(VIT, img_size=224)
    sd = init_weights(ViTRVSA(src), _gen(0)).state_dict()
    sd = _randomise(sd, rng, ("rel_pos",))
    D = VIT.embed_dim
    sd["cls_token"] = _t(rng.standard_normal((1, 1, D)).astype(np.float32))
    sd["pos_embed"] = torch.cat([_t(rng.standard_normal((1, 1, D)).astype(np.float32)),
                                 sd["pos_embed"]], 1)
    sd["norm.weight"], sd["norm.bias"] = torch.ones(D), torch.zeros(D)
    return {"module.encoder." + k: v.numpy() for k, v in sd.items()}


def test_released_vit_loads_at_another_grid_as_convert_backbone(released_vit):
    """grid 14 → 16: the port's ViT from `backbone_state_dict` gives JAX's
    features from `convert_backbone` on the same dict (all four pyramid
    levels), and with `features_only` the raw maps of a model without FPN
    (the FPN keys dropped)."""
    x = np.random.default_rng(1).standard_normal((2, 256, 256, 3)).astype(np.float32)
    params = jtc.convert_backbone(jtc.unwrap_checkpoint(released_vit), VIT, grid=(16, 16))
    model = JaxViTRVSA(VIT)
    want = jax.jit(model.apply)({"params": params}, jnp.asarray(x))
    raw = jax.jit(lambda v, x: model.apply(v, x, features_only=True))(
        {"params": params}, jnp.asarray(x))
    sd = ptc.backbone_state_dict(released_vit, VIT)
    assert sd["blocks.1.attn.full_attn_rel_pos_h"].shape == (31, 16)
    assert sd["blocks.0.attn.rel_pos_h"].shape == (13, 16)  # windowed: unchanged
    port = ViTRVSA(VIT)
    port.load_state_dict(sd)
    with torch.no_grad():
        _close_feats(port(_t(x)), want)
        port_raw = ViTRVSA(VIT, features_only=True)
        port_raw.load_state_dict(ptc.backbone_state_dict(released_vit, VIT,
                                                         features_only=True))
        _close_feats(port_raw(_t(x)), raw)


def test_backbone_state_dict_raises_on_other_keys(released_vit):
    extra = dict(released_vit, **{"module.encoder.head.weight": _W})
    with pytest.raises(KeyError, match="head.weight"):
        ptc.backbone_state_dict(extra, VIT)
    missing = {k: v for k, v in released_vit.items() if "fpn2" not in k}
    with pytest.raises(KeyError, match="fpn2"):
        ptc.backbone_state_dict(missing, VIT)
    assert not [k for k in ptc.backbone_state_dict(missing, VIT, features_only=True)
                if k.startswith("fpn")]


def test_released_internimage_loads_as_convert_internimage():
    rng = np.random.default_rng(2)
    sd = init_weights(InternImage(PORT_II), _gen(2)).state_dict()
    sd = {"module." + k: v.numpy() for k, v in
          _randomise(sd, rng, (".offset.", ".mask.")).items()}
    x = np.random.default_rng(3).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(ji.InternImage(TINY_II).apply)(
        {"params": jtc.convert_internimage(sd, TINY_II.depths)}, jnp.asarray(x))
    port = InternImage(PORT_II)
    port.load_state_dict(ptc.backbone_state_dict(sd, PORT_II))
    with torch.no_grad():
        _close_feats(port(_t(x)), want)


@pytest.mark.parametrize("family", ["vit", "internimage"])
@pytest.mark.parametrize("scanned", [False, True], ids=["unrolled", "scanned"])
def test_jax_encoder_npz_loads_through_load_encoder(tmp_path, family, scanned):
    """A JAX `save_encoder` artifact, in the unrolled or the scanned layout:
    `load_encoder` → `backbone_state_dict` gives the JAX features."""
    x = np.random.default_rng(4).standard_normal((1, 64, 64, 3)).astype(np.float32)
    if family == "vit":
        cfg = dataclasses.replace(VIT, img_size=64)
        model = JaxViTRVSA(cfg)
        params = jax.jit(model.init)(jax.random.PRNGKey(5), jnp.asarray(x))["params"]
        params = jax.tree.map(lambda a: a + 0.01 * jax.random.normal(
            jax.random.PRNGKey(6), a.shape), params)  # non-zero rel-pos tables
        flat = jtc.to_scan_layout(params, cfg.depth, cfg.interval) if scanned else params
        port, port_cfg = ViTRVSA(cfg), cfg
    else:
        model = ji.InternImage(TINY_II)
        params = jax.jit(model.init)(jax.random.PRNGKey(5), jnp.asarray(x))["params"]
        params = jax.tree.map(lambda a: a + 0.05 * jax.random.normal(
            jax.random.PRNGKey(6), a.shape), params)  # off-grid sampling
        flat = jtc.to_stage_scan_layout(params, TINY_II.depths) if scanned else params
        port, port_cfg = InternImage(PORT_II), PORT_II
    path = str(tmp_path / "encoder.npz")
    jstore.save_encoder(path, jax.tree.map(np.asarray, flat))
    assert not store.npz_is_full_variables(path)
    want = jax.jit(model.apply)({"params": params}, jnp.asarray(x))
    port.load_state_dict(ptc.backbone_state_dict(store.load_encoder(path, port_cfg),
                                                 port_cfg))
    with torch.no_grad():
        _close_feats(port(_t(x)), want)


def test_variables_round_trip_and_jax_npz(tmp_path):
    model = init_weights(SiamChangeDetector(dataclasses.replace(VIT, img_size=64)), _gen(7))
    store.save_variables(str(tmp_path / "v.pt"), model)
    got = store.load_variables(str(tmp_path / "v.pt"))
    want = model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    jstore.save_variables(str(tmp_path / "j.npz"),
                          {"params": {"a": {"b": np.ones(2)}}, "batch_stats": {"c": np.zeros(1)}})
    assert store.npz_is_full_variables(str(tmp_path / "j.npz"))
    tree = store.load_variables(str(tmp_path / "j.npz"))
    assert tree["params"]["a"]["b"].tolist() == [1.0, 1.0]


# ----------------------------------------------------------------- store --

CLS_VIT = pc.BackboneConfig(img_size=64, embed_dim=32, depth=4, num_heads=2,
                            interval=2, out_indices=(0, 1, 2, 3), dtype="float32",
                            drop_path_rate=0.2, drop_rate=0.1)
TRAIN = pc.TrainConfig(
    optimizer=pc.OptimizerConfig(lr=1e-3, weight_decay=0.05, layer_decay=0.9,
                                 clip_norm=1.0),
    schedule=pc.ScheduleConfig(kind="cosine", total_steps=10, warmup_steps=2,
                               warmup_ratio=0.1))


def _cls_task():
    cfg = pc.TaskConfig(task="classification", num_classes=5, backbone=CLS_VIT,
                        train=TRAIN)
    return ClassificationTask(cfg, device="cpu")


def _cd_task():
    cfg = pc.TaskConfig(task="change_detection", num_classes=2, backbone=CLS_VIT,
                        train=TRAIN)
    return ChangeDetectionTask(cfg, device="cpu")


def _cls_batches(n, seed=10):
    rng = np.random.default_rng(seed)
    return [{"image": rng.standard_normal((2, 64, 64, 3)).astype(np.float32),
             "label": rng.integers(0, 5, (2,))} for _ in range(n)]


def _cd_batches(n, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        label = rng.integers(0, 2, (2, 64, 64))
        label[:, :3] = 255
        out.append({"image_a": rng.standard_normal((2, 64, 64, 3)).astype(np.float32),
                    "image_b": rng.standard_normal((2, 64, 64, 3)).astype(np.float32),
                    "label": label})
    return out


def _state_tensors(state):
    """Everything a resume must bring back, as {name: tensor}."""
    out = {"model." + k: v for k, v in state.model.state_dict().items()}
    for name, (mu, nu) in state.optimizer.moments().items():
        out["mu." + name], out["nu." + name] = mu, nu
    out["generator"] = state.generator.get_state()
    return out


def _assert_same_state(a, b):
    assert (a.step, a.optimizer.count) == (b.step, b.optimizer.count)
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k


def test_store_round_trip_is_bitwise(tmp_path):
    """After two steps (Adam moments, BatchNorm statistics, a used
    generator), save → restore into a fresh task's state gives every tensor
    back bit for bit, the count and the step too; `restore` picks the latest
    step by default."""
    task = _cd_task()
    state, _ = task.fit(task.init_state(_gen(0)), iter(_cd_batches(2)), 2)
    ckpt = store.CheckpointStore(str(tmp_path))
    ckpt.save(state.step, state, wait=True)
    fresh = _cd_task()
    restored = ckpt.restore(fresh.init_state(_gen(99)))
    assert restored is not None and restored.model is fresh.model
    _assert_same_state(restored, state)
    assert any(k.endswith("running_var") for k in _state_tensors(state))
    ckpt.close()


def test_store_keeps_max_to_keep_ignores_leftovers_and_empty(tmp_path):
    ckpt = store.CheckpointStore(str(tmp_path / "ck"), max_to_keep=2)
    assert ckpt.latest_step() is None
    task = _cls_task()
    state = task.init_state(_gen(0))
    assert ckpt.restore(task.init_state(_gen(1))) is None
    # a write cut short leaves a temporary file: never a checkpoint
    (tmp_path / "ck" / ".7.pt.abc.tmp").write_bytes(b"partial")
    (tmp_path / "ck" / "notes.txt").write_text("x")
    for step in (1, 2, 3, 5):
        state.step = step
        ckpt.save(step, state)
    assert ckpt.latest_step() == 5
    assert ckpt.steps() == [3, 5]
    assert ckpt.restore(task.init_state(_gen(2)), step=3).step == 3
    with pytest.raises(FileNotFoundError):
        ckpt.restore(task.init_state(_gen(2)), step=1)
    ckpt.close()


class _Recorder:
    def __init__(self):
        self.saves = []

    def save(self, step, state, wait=False):
        self.saves.append((step, wait))


@pytest.mark.parametrize("steps,every,want", [
    (5, 2, [(2, False), (4, False), (5, True)]),
    (4, 2, [(2, False), (4, True)]),
    (1, 1000, [(1, True)]),
])
def test_fit_saves_every_ckpt_every_and_at_the_end(tmp_path, steps, every, want):
    """`fit_loop` saves every `ckpt_every` steps except after the last, then
    once at the end waiting for the write, and writes the encoder artifact
    (the backbone's state dict in the reference names) with each save."""
    task = _cls_task()
    rec = _Recorder()
    enc = str(tmp_path / "out" / "encoder.pth")
    state, _ = task.fit(task.init_state(_gen(0)), iter(_cls_batches(steps)), steps,
                        ckpt=rec, ckpt_every=every, encoder_path=enc)
    assert rec.saves == want
    got = store.load_encoder(enc, CLS_VIT)
    want_sd = state.model.backbone.state_dict()
    assert got.keys() == want_sd.keys()
    assert all(torch.equal(got[k], want_sd[k]) for k in want_sd)
    # a model with an `encoder` exports that instead
    class WithEncoder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.encoder = torch.nn.Linear(2, 3)
            self.backbone = torch.nn.Linear(4, 5)
    state.model = WithEncoder()
    _fit._save(rec, state, enc)
    assert store.load_encoder(enc, CLS_VIT).keys() == {"weight", "bias"}
    assert store.load_encoder(enc, CLS_VIT)["weight"].shape == (3, 2)


@pytest.mark.parametrize("make_task,make_batches", [(_cls_task, _cls_batches),
                                                    (_cd_task, _cd_batches)],
                         ids=["classifier", "change-detector"])
def test_resume_is_bitwise_equal_to_an_unbroken_run(tmp_path, make_task, make_batches):
    """Run 1: `fit` 2 steps with a CheckpointStore, restore step 2 into a
    fresh task (another model object, other initial weights), `fit` step 3.
    Run 2: 3 steps without a break.  Dropout and drop-path on, drawn from
    the state's generator; train-mode BatchNorm in the change detector; the
    LR schedule reads the optimizer's count."""
    batches = make_batches(3)
    task = make_task()
    unbroken, _ = task.fit(task.init_state(_gen(0)), iter(batches), 3)

    first = make_task()
    ckpt = store.CheckpointStore(str(tmp_path))
    first.fit(first.init_state(_gen(0)), iter(batches[:2]), 2, ckpt=ckpt,
              ckpt_every=1000)
    assert ckpt.latest_step() == 2
    second = make_task()
    state = ckpt.restore(second.init_state(_gen(123)))
    assert state.step == 2 and state.optimizer.count == 2
    state, _ = second.fit(state, iter(batches[2:]), 1)
    _assert_same_state(state, unbroken)
    ckpt.close()
