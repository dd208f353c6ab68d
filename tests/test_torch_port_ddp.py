"""The port's data parallel (`mtp_tpu_torch.parallel.mesh`) on the CPU: two
gloo ranks in spawned processes (`tests/torch_ddp_workers.py`), each on its
rows of the global batch, against JAX on a data-2 mesh of its 8 virtual CPU
devices and against the port's own world-1 run:

- `process_batch_rows` against JAX's sharding of the batch, the Loader's
  rows over an epoch;
- cross-rank BatchNorm against flax's two-pass BatchNorm on the whole batch;
- the toy ViT+UperNet train step (2 ranks × 2 rows) against JAX
  `make_train_step(mesh=make_mesh(MeshConfig(data=2)))` on the batch of 4,
  one label map ignoring pixels in rank 0's rows only, so that `seg_xent`'s
  normaliser must count over the world;
- the world-2 step against the world-1 step on the same global batch with
  drop-path, dropout and the random sampler on (the global-row draws);
- `evaluate` at world 2 equal to world 1 exactly (the confusion counts, VOC
  AP).

`test_torch_port_ddp_det.py` holds the detection and multitask steps to
JAX's data-2 mesh, `test_torch_port_ddp_cli.py` the CLI under torchrun.

fp32 on both sides; tolerances as `test_torch_port_train.py`'s (the step)
and `test_batchnorm_train_matches_flax`'s (1e-5)."""

import dataclasses
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from mtp_tpu.core import optim as jopt
from mtp_tpu.core.train import create_state as jax_create_state
from mtp_tpu.core.train import make_train_step as jax_make_train_step
from mtp_tpu.core.train import seg_xent as jax_seg_xent
from mtp_tpu.heads.upernet import resize_bilinear as jax_resize
from mtp_tpu.models.backbones import layer_id_fn_for as jax_layer_id_fn_for
from mtp_tpu.models.segmentor import Segmentor as JaxSegmentor
from mtp_tpu.models.vit_rvsa import rescale_block_init
from mtp_tpu.parallel import mesh as jmesh
from mtp_tpu.utils.config import MeshConfig as JMeshConfig
from mtp_tpu_torch import config as pc
from mtp_tpu_torch.ckpt.from_jax import params_from_jax, segmentor_from_jax
from mtp_tpu_torch.core import optim as popt
from mtp_tpu_torch.data.loader import Loader
from mtp_tpu_torch.parallel import mesh as pmesh
from torch_ddp_workers import det_task, run, seg_task, train_steps

torch.set_num_threads(1)

CFG = pc.BackboneConfig(img_size=128, embed_dim=32, depth=4, num_heads=2, interval=2,
                        out_indices=(0, 1, 2, 3), dtype="float32")
K, CROP, BATCH, CHANNELS = 3, 64, 4, 16
OPT = pc.OptimizerConfig(lr=1e-3, weight_decay=0.05, layer_decay=0.9, clip_norm=0.0)
SCHED = pc.ScheduleConfig(kind="cosine", total_steps=10, warmup_steps=2, warmup_ratio=0.1)


def _jcfg(cfg):
    """The JAX package's copy of a port config dataclass."""
    from mtp_tpu.utils import config as jc
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return getattr(jc, type(cfg).__name__)(**kw)


def _seg_cfg(backbone=CFG):
    return pc.TaskConfig(task="segmentation", num_classes=K, backbone=backbone,
                         train=pc.TrainConfig(batch_size=BATCH, optimizer=OPT,
                                              schedule=SCHED))


def _seg_batch(seed):
    """A global batch of 4; ignored pixels: a band in every map, and a block
    in row 0 only (rank 0's rows)."""
    rng = np.random.default_rng(seed)
    label = rng.integers(0, K, (BATCH, CROP, CROP)).astype(np.int32)
    label[:, :5] = 255
    label[0, 20:40, 10:50] = 255
    return {"image": rng.standard_normal((BATCH, CROP, CROP, 3)).astype(np.float32),
            "label": label}


def _seg_payload(sd, batches, deterministic=True, backbone=CFG):
    return dict(cfg=_seg_cfg(backbone), channels=CHANNELS, crop=CROP, state_dict=sd,
                batches=batches, deterministic=deterministic)


# -------------------------------------------------------------- the rows --

@pytest.mark.parametrize("data", [1, 2, 4])
@pytest.mark.parametrize("batch", [4, 8, 12])
def test_process_batch_rows_match_jax(data, batch, monkeypatch):
    """Rank r's rows are the rows JAX's batch sharding gives the r-th device
    of the data axis; over the ranks they are the JAX process's rows."""
    mesh = jmesh.make_mesh(JMeshConfig(data=data), devices=jax.devices()[:data])
    imap = jmesh.batch_sharding(mesh).devices_indices_map((batch,))
    union = []
    for r, device in enumerate(mesh.devices[:, 0]):
        monkeypatch.setattr(pmesh, "rank", lambda r=r: r)
        got = pmesh.process_batch_rows(pmesh.Mesh(data=data), batch)
        want = np.arange(batch)[imap[device][0]]
        np.testing.assert_array_equal(got, want)
        union += list(got)
    np.testing.assert_array_equal(union, jmesh.process_batch_rows(mesh, batch))


def test_rows_of_a_batch_that_does_not_divide_raise():
    jm = jmesh.make_mesh(JMeshConfig(data=4), devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="divide"):
        jmesh.process_batch_rows(jm, 6)
    with pytest.raises(ValueError, match="divide"):
        pmesh.process_batch_rows(pmesh.Mesh(data=4), 6)


class _Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_rows_are_disjoint_and_complete(workers, monkeypatch):
    """Three ranks' Loaders of one seed load, batch by batch, disjoint rows
    whose union is the world-1 Loader's batch."""
    n, bs, world = 23, 6, 3
    collate = lambda samples: {"idx": np.asarray(samples)}
    whole = [b["idx"] for b in Loader(_Indices(n), bs, collate, seed=5).epoch(1)]
    parts = []
    for r in range(world):
        monkeypatch.setattr(pmesh, "rank", lambda r=r: r)
        rows = pmesh.process_batch_rows(pmesh.Mesh(data=world), bs)
        parts.append([b["idx"] for b in Loader(_Indices(n), bs, collate, seed=5,
                                               num_workers=workers,
                                               batch_rows=rows).epoch(1)])
    assert len(whole) == n // bs
    for i, want in enumerate(whole):
        got = np.concatenate([p[i] for p in parts])
        np.testing.assert_array_equal(got, want)   # disjoint, complete, in order


# ------------------------------------------------------------- BatchNorm --

def test_cross_rank_batchnorm_matches_flax_on_the_whole_batch(tmp_path):
    """2 ranks × 2 rows against flax's two-pass BatchNorm on the 4 rows:
    the outputs, the gradients of Σ out·cot (the input's, and the
    parameters' summed over the ranks), and the running statistics, equal
    on both ranks."""
    rng = np.random.default_rng(0)
    B, C, H, W = 4, 5, 3, 6
    x = (rng.standard_normal((B, C, H, W)) * rng.uniform(0.5, 3.0, (1, C, 1, 1))
         + rng.normal(0, 2, (1, C, 1, 1))).astype(np.float32)
    x[2:] += 1.5  # rank 1's rows off rank 0's
    cot = rng.standard_normal(x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(0, 0.2, C).astype(np.float32)
    mean = rng.normal(0, 0.3, C).astype(np.float32)
    var = rng.uniform(0.5, 2.0, C).astype(np.float32)
    state = {"weight": scale, "bias": bias, "running_mean": mean, "running_var": var,
             "num_batches_tracked": np.zeros((), np.int64)}
    ranks = run("batchnorm", 2, tmp_path, {"x": x, "cot": cot, "state": state})

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       use_fast_variance=False)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))
    ch = jnp.asarray(cot.transpose(0, 2, 3, 1))

    def loss(params, xh):
        y, upd = bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, xh,
                          mutable=["batch_stats"])
        return (y * ch).sum(), (y, upd["batch_stats"])

    (_, (y, stats)), (dp, dx) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
        variables["params"], xh)
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)
    close = lambda got, want: np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    close(np.concatenate([r["y"] for r in ranks]), nchw(y))
    close(np.concatenate([r["dx"] for r in ranks]), nchw(dx))
    close(sum(r["dw"] for r in ranks), np.asarray(dp["scale"]))
    close(sum(r["db"] for r in ranks), np.asarray(dp["bias"]))
    for r in ranks:
        close(r["mean"], np.asarray(stats["mean"]))
        close(r["var"], np.asarray(stats["var"]))
    for key in ("mean", "var"):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])


# ------------------------------------------------------- the train step --

@pytest.fixture(scope="module")
def jax_mesh_steps():
    """The toy segmentor's variables and two JAX steps on a data-2 mesh
    (deterministic loss, train-mode BatchNorm), with the first step's
    gradients on the same mesh."""
    jcfg = _jcfg(CFG)
    model = JaxSegmentor(jcfg, K, channels=CHANNELS)
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, CROP, CROP, 3)), train=False))(jax.random.PRNGKey(0))
    params = dict(variables["params"])
    params["backbone"] = rescale_block_init(params["backbone"], CFG.depth)
    stats = variables["batch_stats"]
    tx = jopt.make_optimizer(_jcfg(OPT), jopt.make_schedule(_jcfg(SCHED), OPT.lr), params,
                             CFG.depth, jax_layer_id_fn_for(jcfg, root="backbone/"))

    def loss_fn(p, bs, batch, rng):
        out, upd = model.apply({"params": p, "batch_stats": bs}, batch["image"],
                               train=True, deterministic=True, mutable=["batch_stats"])
        logits = jax_resize(out, batch["label"].shape[1:3])
        return jax_seg_xent(logits, batch["label"]), ({}, upd["batch_stats"])

    mesh = jmesh.make_mesh(JMeshConfig(data=2))
    data = NamedSharding(mesh, PartitionSpec(jmesh.DATA_AXIS))
    step = jax_make_train_step(loss_fn, tx, mesh=mesh, donate=False)
    grad = jax.jit(jax.grad(lambda p, bs, b: loss_fn(p, bs, b, None)[0]),
                   in_shardings=(None, None, data))
    state = jax_create_state(params, tx, jax.random.PRNGKey(1), batch_stats=stats)
    batches = [_seg_batch(1), _seg_batch(2)]
    out = []
    for batch in batches:
        b = jax.device_put(jax.tree.map(jnp.asarray, batch), data)
        g = grad(state.params, state.batch_stats, b) if not out else None
        new, metrics = step(state, b)
        out.append(dict(grads=g, after=new, metrics={k: float(v) for k, v in metrics.items()}))
        state = new
    return dict(params=params, stats=stats, batches=batches, steps=out)


def test_two_rank_step_matches_jax_on_a_data_2_mesh(jax_mesh_steps, tmp_path):
    """Two steps of the port's DDP step, 2 ranks × 2 rows, against JAX's
    step over the data-2 mesh on the batch of 4: loss and grad norm at each
    step, every gradient of the first, the BatchNorm running statistics
    and the parameters after each (Adam's first steps move a parameter
    whose gradient is at noise level by ±lr·scale either way: each is held
    to 2·Σ lr·scale); both ranks' states bit for bit equal."""
    ref = jax_mesh_steps
    sd = segmentor_from_jax({"params": ref["params"], "batch_stats": ref["stats"]}, CFG)
    ranks = run("seg_step", 2, tmp_path, _seg_payload(sd, ref["batches"]))
    for a, b in zip(ranks[0]["state"], ranks[1]["state"]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    got = ranks[0]
    sched = popt.make_schedule(SCHED, OPT.lr)
    task, state = seg_task(_seg_payload(sd, []))
    scales = {state.optimizer.names[p]: g["lr_scale"]
              for g in state.optimizer.adamw.param_groups for p in g["params"]}
    g_ref = params_from_jax(jax.tree.map(np.asarray, ref["steps"][0]["grads"]),
                            ref["stats"], CFG)
    g_all = float(torch.sqrt(sum((g ** 2).sum() for g in g_ref.values())))
    for name, g in got["grads"].items():
        diff = float((g - g_ref[name]).norm())
        assert diff <= 1e-4 * float(g_ref[name].norm()) + 1e-6 * g_all, name
    lr_sum = 0.0
    for i, step in enumerate(ref["steps"]):
        lr_sum += sched(i)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][i][key], step["metrics"][key],
                                       rtol=1e-5, err_msg=f"step {i} {key}")
        after = step["after"]
        want = segmentor_from_jax({"params": after.params, "batch_stats": after.batch_stats},
                                  CFG)
        for name, w in want.items():
            v = got["state"][i][name]
            if "running_" in name:
                np.testing.assert_allclose(v.numpy(), w.numpy(), atol=1e-5, rtol=1e-5,
                                           err_msg=name)
            elif name in scales:
                np.testing.assert_allclose(v.numpy(), w.numpy(),
                                           atol=2 * lr_sum * scales[name] + 1e-7, rtol=0,
                                           err_msg=f"step {i} {name}")


def _det_cfg():
    bb = pc.BackboneConfig(img_size=64, patch_size=16, embed_dim=32, depth=2, num_heads=2,
                           interval=2, out_indices=(0, 0, 1, 1), dtype="float32",
                           drop_path_rate=0.2, drop_rate=0.1)
    return pc.TaskConfig(task="detection_h", num_classes=3, backbone=bb,
                         train=pc.TrainConfig(batch_size=4, optimizer=pc.OptimizerConfig(
                             lr=1e-3, clip_norm=1.0), schedule=pc.ScheduleConfig(kind="constant")))


DET_OVERRIDES = dict(nms_pre=256, max_proposals=64, rpn_num=64, rcnn_num=32, max_per_img=16,
                     max_gts=8)


def det_batch(seed, n_gts=(3, 1, 3, 2), B=4, G=8, size=64):
    """Seeded images and n_gts[b] valid gt boxes in image b (the ranks'
    positives differ)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(4, 40, (B, G, 2))
    wh = rng.uniform(8, 24, (B, G, 2))
    valid = np.arange(G)[None] < np.asarray(n_gts)[:, None]
    return {"image": rng.standard_normal((B, size, size, 3)).astype(np.float32),
            "gt_boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
            "gt_labels": rng.integers(0, 3, (B, G)).astype(np.int32),
            "gt_valid": valid}


def _close_steps(got, want, state, lrs, rtol=1e-5):
    """Two runs of the same steps: the metrics within `rtol`; the first
    step's gradients within `rtol` of each one's norm plus 1e-6 of all
    gradients' norm (those zero up to rounding: the biases right before a
    train-mode BatchNorm); the BatchNorm statistics within 1e-5, as
    `test_torch_port_train.py` holds them, and the parameters after each
    step within 2·Σ lr·scale (Adam moves a parameter whose gradient is
    rounding noise by ±lr·scale either way)."""
    for m, w in zip(got["metrics"], want["metrics"]):
        assert set(m) == set(w)
        for k in w:
            np.testing.assert_allclose(m[k], w[k], rtol=rtol, atol=1e-6, err_msg=k)
    g_all = float(torch.sqrt(sum((g.double() ** 2).sum() for g in want["grads"].values())))
    for name, g in want["grads"].items():
        diff = float((got["grads"][name] - g).norm())
        assert diff <= rtol * float(g.norm()) + 1e-6 * g_all, name
    scales = {state.optimizer.names[p]: g["lr_scale"]
              for g in state.optimizer.adamw.param_groups for p in g["params"]}
    for i, (s, w) in enumerate(zip(got["state"], want["state"])):
        for name, v in w.items():
            if name in scales:
                np.testing.assert_allclose(s[name].numpy(), v.numpy(), rtol=0,
                                           atol=2 * sum(lrs[:i + 1]) * scales[name] + 1e-7,
                                           err_msg=f"step {i} {name}")
            elif v.is_floating_point():
                np.testing.assert_allclose(s[name].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                           err_msg=f"step {i} {name}")
            else:
                assert torch.equal(s[name], v), name


@pytest.mark.parametrize("path", ["segmentation", "faster_rcnn"])
def test_world_2_step_equals_world_1_step_with_every_draw(path, tmp_path):
    """The world-2 step (2 ranks × 2 rows) against the port's world-1 step on
    the same global batch, with drop-path, dropout and, for Faster R-CNN,
    the random sampler on: each rank draws the global batch's masks and
    samples from the shared generator and keeps its rows, so both worlds
    draw the same.  Two steps, held by `_close_steps`."""
    if path == "segmentation":
        bb = dataclasses.replace(CFG, drop_path_rate=0.3, drop_rate=0.1)
        payload = _seg_payload(None, [_seg_batch(3), _seg_batch(4)], deterministic=False,
                               backbone=bb)
        task, state = seg_task(payload)
        one = train_steps(task, state, payload)
        two = run("seg_step", 2, tmp_path, payload)
    else:
        payload = dict(cfg=_det_cfg(), det_overrides=DET_OVERRIDES, state_dict=None,
                       batches=[det_batch(5), det_batch(6)], deterministic=False)
        task, state = det_task(payload)
        one = train_steps(task, state, payload)
        two = run("det_step", 2, tmp_path, payload)
        pos = [[c[0] for c in r["counts"]] for r in two]
        assert pos[0] != pos[1], pos   # the ranks' positive counts differ
    for a, b in zip(two[0]["state"], two[1]["state"]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    sched = state.optimizer.schedule
    _close_steps(two[0], one, state, [sched(i) for i in range(2)])


# -------------------------------------------------------------- evaluate --

def test_evaluate_at_world_2_equals_world_1(tmp_path):
    """Segmentation's slide evaluation (the confusion counts summed over the
    ranks) and detection's VOC AP50 (records gathered in image order, scored
    once): the same numbers as one process, bit for bit, over batches that
    do not divide the world."""
    seg = _seg_payload(None, [])
    rng = np.random.default_rng(7)
    seg["data"] = [{"image": rng.standard_normal((2, 96, 80, 3)).astype(np.float32),
                    "label": rng.integers(0, K, (2, 96, 80))} for _ in range(3)]
    seg["cfg"] = dataclasses.replace(seg["cfg"], slide=pc.SlideConfig(crop=64, stride=32))
    task, state = seg_task(seg)
    one = task.evaluate(state, iter(seg["data"]))
    os.makedirs(tmp_path / "seg")
    for r in run("seg_eval", 2, tmp_path / "seg", seg):
        assert r == one

    det = dict(cfg=_det_cfg(), det_overrides=dict(DET_OVERRIDES, score_thr=0.0),
               state_dict=None, data=[det_batch(s, B=2, n_gts=(3, 2)) for s in (8, 9, 10)])
    task, state = det_task(det)
    one = task.evaluate(state, iter(det["data"]))
    assert one["mAP"] >= 0 and len(one["AP"]) == 3
    os.makedirs(tmp_path / "det")
    for r in run("det_eval", 2, tmp_path / "det", det):
        assert r == one
