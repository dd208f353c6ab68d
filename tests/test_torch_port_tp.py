"""The port's model axis (`mtp_tpu_torch.parallel.tensor`, the 2-D mesh of
`mtp_tpu_torch.parallel.mesh`) on the CPU, against JAX's Megatron rules
(`mtp_tpu.parallel.mesh._TP_RULES`, `shard_state`):

- the toy ViT+UperNet train step of `test_torch_port_ddp.py` (embed 32, 2
  heads: one head a rank) on 4 gloo ranks at data 2 × model 2 and on 2 at
  data 1 × model 2 (spawned, `tests/torch_ddp_workers.py`), each against
  JAX's `make_train_step` on `make_mesh(MeshConfig(data=2, model=2))` /
  `(data=1, model=2)` over its virtual CPU devices, the state placed by
  `shard_state` (the parameters and the Adam moments at the rules'
  layout), JAX's parameters carried across; the tolerances of
  `test_two_rank_step_matches_jax_on_a_data_2_mesh`;
- the rule table: the port's sharded tensors are JAX's, one for one, on
  the ViT, InternImage and box-head trees; `shard_state_dict` and
  `gather_state_dict`'s join are exact inverses; qkv splits by head;
- the mesh: rank r at data r // T and model r % T, as JAX's reshape of the
  device list.

`test_torch_port_tp_tasks.py` holds model 2 to model 1 in the port (every
task, remat, checkpoints, evaluate, the CLI)."""

import dataclasses

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
from mtp_tpu.core.train import shard_state as jax_shard_state
from mtp_tpu.heads.upernet import resize_bilinear as jax_resize
from mtp_tpu.models.backbones import layer_id_fn_for as jax_layer_id_fn_for
from mtp_tpu.models.segmentor import Segmentor as JaxSegmentor
from mtp_tpu.models.vit_rvsa import rescale_block_init
from mtp_tpu.parallel import mesh as jmesh
from mtp_tpu.utils.config import MeshConfig as JMeshConfig
from mtp_tpu_torch import config as pc
from mtp_tpu_torch.ckpt.from_jax import params_from_jax, segmentor_from_jax
from mtp_tpu_torch.core import optim as popt
from mtp_tpu_torch.parallel import mesh as pmesh
from mtp_tpu_torch.parallel import tensor as ptensor
from torch_ddp_workers import run, seg_task

torch.set_num_threads(1)

CFG = pc.BackboneConfig(img_size=128, embed_dim=32, depth=4, num_heads=2, interval=2,
                        out_indices=(0, 1, 2, 3), dtype="float32")
K, CROP, BATCH, CHANNELS = 3, 64, 4, 16
OPT = pc.OptimizerConfig(lr=1e-3, weight_decay=0.05, layer_decay=0.9, clip_norm=0.0)
SCHED = pc.ScheduleConfig(kind="cosine", total_steps=10, warmup_steps=2, warmup_ratio=0.1)
MESHES = {"data2_model2": (2, 2), "data1_model2": (1, 2)}


def _jcfg(cfg):
    """The JAX package's copy of a port config dataclass."""
    from mtp_tpu.utils import config as jc
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return getattr(jc, type(cfg).__name__)(**kw)


def _seg_batch(seed):
    """A global batch of 4; ignored pixels: a band in every map, and a block
    in row 0 only (data rank 0's rows at data 2)."""
    rng = np.random.default_rng(seed)
    label = rng.integers(0, K, (BATCH, CROP, CROP)).astype(np.int32)
    label[:, :5] = 255
    label[0, 20:40, 10:50] = 255
    return {"image": rng.standard_normal((BATCH, CROP, CROP, 3)).astype(np.float32),
            "label": label}


def _payload(sd, batches, data, model):
    cfg = pc.TaskConfig(task="segmentation", num_classes=K, backbone=CFG,
                        train=pc.TrainConfig(batch_size=BATCH, optimizer=OPT, schedule=SCHED,
                                             mesh=pc.MeshConfig(data=data, model=model)))
    return dict(cfg=cfg, channels=CHANNELS, crop=CROP, state_dict=sd, batches=batches,
                deterministic=True)


@pytest.fixture(scope="module")
def jax_tp_steps():
    """The toy segmentor's variables and, on each mesh, two JAX steps from
    the state `shard_state` lays out (deterministic loss, train-mode
    BatchNorm), with the first step's gradients on the same mesh."""
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

    batches = [_seg_batch(1), _seg_batch(2)]
    out = {}
    for key, (data, tp) in MESHES.items():
        mesh = jmesh.make_mesh(JMeshConfig(data=data, model=tp))
        state = jax_shard_state(mesh, jax_create_state(params, tx, jax.random.PRNGKey(1),
                                                       batch_stats=stats, init_opt=False), tx)
        qkv = state.params["backbone"]["blocks_0"]["attn"]["qkv"]["kernel"]
        assert "model" in str(qkv.sharding.spec)
        sharded = NamedSharding(mesh, PartitionSpec(jmesh.DATA_AXIS))
        step = jax_make_train_step(loss_fn, tx, mesh=mesh, donate=False)
        grad = jax.jit(jax.grad(lambda p, bs, b: loss_fn(p, bs, b, None)[0]))
        steps = []
        for batch in batches:
            b = jax.device_put(jax.tree.map(jnp.asarray, batch), sharded)
            g = grad(state.params, state.batch_stats, b) if not steps else None
            new, metrics = step(state, b)
            steps.append(dict(grads=g, after=new,
                              metrics={k: float(v) for k, v in metrics.items()}))
            state = new
        out[key] = steps
    return dict(params=params, stats=stats, batches=batches, steps=out)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_step_matches_jax_on_the_same_mesh(jax_tp_steps, mesh, tmp_path):
    """Two steps of the port at data × model = 2 × 2 (4 ranks, 2 rows each
    data rank) or 1 × 2 (2 ranks, the 4 rows each) against JAX's step on
    the same mesh: loss and grad norm at each step, every gradient of the
    first (gathered over the model group), the BatchNorm running statistics
    and the parameters after each (each held to 2·Σ lr·scale: Adam's first
    steps move a parameter whose gradient is at noise level by ±lr·scale
    either way); every rank's whole state bit for bit equal."""
    ref = jax_tp_steps
    data, tp = MESHES[mesh]
    sd = segmentor_from_jax({"params": ref["params"], "batch_stats": ref["stats"]}, CFG)
    ranks = run("seg_step", data * tp, tmp_path, _payload(sd, ref["batches"], data, tp))
    for other in ranks[1:]:
        for a, b in zip(ranks[0]["state"], other["state"]):
            assert all(torch.equal(a[k], b[k]) for k in a)
    got = ranks[0]
    sched = popt.make_schedule(SCHED, OPT.lr)
    _, state = seg_task(_payload(sd, [], -1, 1))
    scales = {state.optimizer.names[p]: g["lr_scale"]
              for g in state.optimizer.adamw.param_groups for p in g["params"]}
    steps = ref["steps"][mesh]
    g_ref = params_from_jax(jax.tree.map(np.asarray, steps[0]["grads"]), ref["stats"], CFG)
    g_all = float(torch.sqrt(sum((g ** 2).sum() for g in g_ref.values())))
    assert set(got["grads"]) == set(g_ref)
    for name, g in got["grads"].items():
        diff = float((g - g_ref[name]).norm())
        assert diff <= 1e-4 * float(g_ref[name].norm()) + 1e-6 * g_all, name
    lr_sum = 0.0
    for i, step in enumerate(steps):
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


# ------------------------------------------------------------ the rules --

def _jax_sharded_paths(params) -> set:
    """The "a/b/c" paths of JAX's parameters that its rules split over
    `model`."""
    out = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        if "model" in str(jmesh.param_pspec(path, leaf, tp=True)):
            out.add(jmesh._path_str(path))
    return out


def _tree(sd) -> dict:
    return {k: np.asarray(v) for k, v in sd.items()}


def _vit_tree():
    """A two-block ViT+UperNet's JAX variables (an RVSA block and a full
    one) and its config."""
    cfg = dataclasses.replace(CFG, depth=2, out_indices=(0, 0, 1, 1))
    model = JaxSegmentor(_jcfg(cfg), K, channels=CHANNELS)
    v = jax.jit(lambda k: model.init(k, jnp.zeros((1, CROP, CROP, 3)), train=False))(
        jax.random.PRNGKey(0))
    return v, cfg


def test_the_rules_split_what_jax_splits():
    """The toy ViT+UperNet, InternImage and box trunk: the port's names that
    `parallel.tensor` splits are, one for one, the JAX paths its
    `_TP_RULES` split (qkv and fc1 kernels and biases, attn/proj and fc2
    kernels), and each on the same feature axis (JAX's kernels are the
    port's weights transposed)."""
    from mtp_tpu.heads.roi_heads import Shared2FCTrunk as JTrunk
    from mtp_tpu.models import internimage as ji
    from mtp_tpu_torch.ckpt.from_jax import internimage_from_jax
    from mtp_tpu_torch.heads.roi_heads import Shared2FCTrunk
    from mtp_tpu_torch.models.internimage import InternImage

    variables, cfg = _vit_tree()
    port = segmentor_from_jax(jax.tree.map(np.asarray, variables), cfg)
    jax_split = _jax_sharded_paths(variables["params"])
    assert len(jax_split) == 2 * 6   # qkv kernel+bias, proj, fc1 kernel+bias, fc2 a block
    port_split = {n for n in port if ptensor.sharded_dim(n) is not None}
    assert len(port_split) == len(jax_split)
    for n in port_split:
        assert ptensor.sharded_dim(n) == (0 if n.endswith(("qkv.weight", "qkv.bias",
                                                           "fc1.weight", "fc1.bias")) else 1)

    tiny = dataclasses.replace(ji.internimage_t(), channels=16, depths=(1, 1, 2, 1),
                               groups=(2, 4, 8, 16), dtype="float32")
    jm = ji.InternImage(tiny)
    jv = jax.jit(lambda k: jm.init(k, jnp.zeros((1, 64, 64, 3))))(jax.random.PRNGKey(0))
    pcfg = pc.InternImageConfig(**dataclasses.asdict(tiny))
    port = internimage_from_jax(jax.tree.map(np.asarray, jv["params"]), pcfg)
    assert set(InternImage(pcfg).state_dict()) == set(port)
    j_split = _jax_sharded_paths(jv["params"])
    p_split = {n for n in port if ptensor.sharded_dim(n) is not None}
    assert len(j_split) == len(p_split) == 3 * sum(tiny.depths)

    jt = JTrunk(fc_out=64)
    tv = jt.init(jax.random.PRNGKey(0), jnp.zeros((2, 7, 7, 8)))
    assert _jax_sharded_paths(tv["params"]) == {"fc1/kernel", "fc1/bias", "fc2/kernel"}
    assert {n for n in Shared2FCTrunk(8 * 49, 64).state_dict()
            if ptensor.sharded_dim(n) is not None} == {
        "shared_fcs.0.weight", "shared_fcs.0.bias", "shared_fcs.1.weight"}


@pytest.mark.parametrize("tree", ["vit_upernet", "internimage", "box_head"])
@pytest.mark.parametrize("size", [2, 4])
def test_shard_and_gather_are_inverses(tree, size, monkeypatch):
    """Each rank's shard (`shard_state_dict` at model rank t of T), joined in
    rank order (what `gather_state_dict` does with the gathered shards),
    gives back every tensor bit for bit; whole tensors are not split, each
    sharded one is 1/T of the whole on its rule's axis."""
    from mtp_tpu_torch.heads.roi_heads import BBoxHead
    from mtp_tpu_torch.models.internimage import InternImage
    from mtp_tpu_torch.models.segmentor import Segmentor

    gen = torch.Generator().manual_seed(3)
    if tree == "vit_upernet":
        model = Segmentor(dataclasses.replace(CFG, num_heads=4), K, channels=CHANNELS,
                          input_hw=(CROP, CROP))
    elif tree == "internimage":
        model = InternImage(pc.InternImageConfig(channels=16, depths=(1, 1, 2, 1),
                                                 groups=(2, 4, 8, 16), dtype="float32"))
    else:
        model = BBoxHead(8 * 49, 5, fc_out=64)
    full = {k: torch.randn(v.shape, generator=gen) if v.is_floating_point() else v
            for k, v in model.state_dict().items()}
    shards = []
    for t in range(size):
        monkeypatch.setattr(pmesh, "rank", lambda t=t: t)
        shards.append(ptensor.shard_state_dict(pmesh.Mesh(data=1, model=size), full))
    n_split = 0
    for k, v in full.items():
        dim = ptensor.sharded_dim(k)
        if dim is None:
            assert all(s[k] is v for s in shards), k
            continue
        n_split += 1
        assert all(s[k].shape[dim] * size == v.shape[dim] for s in shards), k
        assert torch.equal(ptensor.join_shards(k, [s[k] for s in shards]), v), k
    assert n_split > 0


def test_qkv_splits_by_head():
    """A rank's qkv rows are its heads' q, k and v rows: with 4 heads of 8
    over 2 ranks, rank 1 holds rows [16:32), [48:64) and [80:96) of the
    [q; k; v] weight (JAX's contiguous split of the 3C axis would give it
    k's second half and v); its bias likewise."""
    C, T = 32, 2
    w = torch.arange(3 * C, dtype=torch.float32)[:, None].expand(3 * C, C).contiguous()
    b = torch.arange(3 * C, dtype=torch.float32)
    for t in range(T):
        rows = torch.cat([torch.arange(part * C + t * C // T, part * C + (t + 1) * C // T)
                          for part in range(3)]).float()
        got = ptensor.shard_tensor("backbone.blocks.0.attn.qkv.weight", w, T, t)
        assert torch.equal(got[:, 0], rows)
        assert torch.equal(ptensor.shard_tensor("blocks.3.attn.qkv.bias", b, T, t), rows)
    # the MLP, the trunk: contiguous blocks of the output (column) or input (row) axis
    fc1 = torch.arange(8.0)[:, None].expand(8, 3)
    assert torch.equal(ptensor.shard_tensor("mlp.fc1.weight", fc1, 2, 1)[:, 0],
                       torch.arange(4.0, 8.0))
    fc2 = torch.arange(8.0)[None].expand(3, 8)
    assert torch.equal(ptensor.shard_tensor("shared_fcs.1.weight", fc2, 2, 0)[0],
                       torch.arange(4.0))
    assert ptensor.shard_tensor("shared_fcs.1.bias", torch.ones(3), 2, 1).shape == (3,)


@pytest.mark.parametrize("data,model", [(4, 2), (2, 4), (1, 8)])
def test_mesh_layout_matches_jax(data, model, monkeypatch):
    """Rank r sits at data index r // T and model index r % T: the device
    at [d, t] of JAX's mesh is the (d·T + t)-th of its device list."""
    jm = jmesh.make_mesh(JMeshConfig(data=data, model=model))
    ids = [d.id for d in jax.devices()[:data * model]]
    for d in range(data):
        for t in range(model):
            r = ids.index(jm.devices[d, t].id)
            monkeypatch.setattr(pmesh, "rank", lambda r=r: r)
            m = pmesh.Mesh(data=data, model=model)
            assert (m.data_rank, m.model_rank) == (d, t)
