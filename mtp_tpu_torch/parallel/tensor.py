"""Tensor parallelism over the mesh's model axis (port of the Megatron rules
of `mtp_tpu/parallel/mesh.py` `_TP_RULES` / `shard_params` and of
`mtp_tpu/core/train.py` `shard_state`).

JAX shards the parameters over the `model` axis and lets XLA insert the
collectives.  The port runs T processes a model group (`parallel.mesh`),
each holding its shard of the rules' parameters and the rest whole, and
writes the collectives out as Megatron does:

- column-parallel (`ColumnParallelLinear`): the weight and bias split by
  output feature (ViT `attn.qkv` and `mlp.fc1`, InternImage's `mlp.fc1`,
  the box trunk's `shared_fcs.0`); its input enters through "copy to the
  model group" (identity forward, all-reduce of the gradient backward);
- row-parallel (`RowParallelLinear`): the weight split by input feature
  (`attn.proj`, `mlp.fc2`, `shared_fcs.1`); the local products leave
  through "reduce from the model group" (all-reduce forward, identity
  backward), and the whole bias is added once, after the sum.

qkv splits by head: a rank holds its heads' q, k and v rows (JAX splits
the 3C axis in contiguous blocks, which would give rank 0 q and half of k;
the layout on the device is no concern of a checkpoint, and
`gather_state_dict` restores the [q; k; v] order).  The attention modules
run num_heads / T heads a rank.  A few whole parameters get from each model
rank the gradient of its heads only (`PARTIAL`: RVSA's rel-pos tables, the
Swin bias table and the sampling regressors, the full blocks' rel-pos
tables); `reduce_partial_gradients` sums those over the model group after
the backward.  Every other whole parameter gets the same gradient on every
model rank (the copy's backward has summed what flows into it), and is not
summed.

A model is built and initialised whole and then sharded (`shard_model`), so
a model-T init equals the model-1 init; checkpoints and encoder artifacts
hold the whole layout (`full_state_dict`), so they are the same at any
mesh.  Without a model axis over 1 nothing here runs.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from mtp_tpu_torch.parallel.mesh import Mesh, sum_gradients

StateDict = Dict[str, torch.Tensor]

# JAX's `_TP_RULES` over the port's names (mmdet's `shared_fcs.{0,1}` for
# the box trunk's fc1/fc2); the row-parallel biases stay whole
COLUMN = re.compile(r"(?:^|\.)(?:attn\.qkv|mlp\.fc1|shared_fcs\.0)\.(?:weight|bias)$")
ROW = re.compile(r"(?:^|\.)(?:attn\.proj|mlp\.fc2|shared_fcs\.1)\.weight$")
QKV = re.compile(r"(?:^|\.)attn\.qkv\.(?:weight|bias)$")
# whole parameters whose gradient each model rank computes for its heads only
PARTIAL = re.compile(r"(?:^|\.)attn\.(?:rel_pos_[hw]|relative_position_bias_table"
                     r"|full_attn_rel_pos_[hw]"
                     r"|sampling_(?:offsets|scales|angles)\.2\.(?:weight|bias))$")


def sharded_dim(name: str) -> Optional[int]:
    """The dimension a rule splits the tensor `name` over (None: whole)."""
    if COLUMN.search(name):
        return 0
    if ROW.search(name):
        return 1
    return None


class ModelGroup:
    """A model rank's place in its model group: `size` T, `rank` t and the
    process group.  Modules hold it; a deep copy of a module keeps it."""

    def __init__(self, mesh: Mesh):
        self.mesh, self.size, self.rank = mesh, mesh.model, mesh.model_rank
        self.group = mesh.model_group

    def __deepcopy__(self, memo):
        return self

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Σ of `t` over the model group, a new tensor."""
        y = t.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=self.group)
        return y


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, tp: ModelGroup) -> torch.Tensor:
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return ctx.tp.all_reduce(g), None


class _ReduceFromModel(torch.autograd.Function):
    """Σ over the model group forward; the gradient passed through."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, tp: ModelGroup) -> torch.Tensor:
        return tp.all_reduce(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


def copy_to_model_group(x: torch.Tensor, tp: Optional[ModelGroup]) -> torch.Tensor:
    return x if tp is None else _CopyToModel.apply(x, tp)


def reduce_from_model_group(x: torch.Tensor, tp: ModelGroup) -> torch.Tensor:
    return _ReduceFromModel.apply(x, tp)


class ColumnParallelLinear(nn.Linear):
    """This rank's output features of a Linear (`weight` (out/T, in), `bias`
    (out/T)); with `copy_input` the input goes through the copy to the model
    group (off where the module has already copied it once for several
    consumers: the attention's qkv and regressors)."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 tp: ModelGroup, copy_input: bool = True):
        super().__init__(in_features, out_features // tp.size, bias=bias)
        self.tp, self.copy_input = tp, copy_input

    def reset_parameters(self) -> None:
        """No draw: the weights come from `shard_state_dict`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.copy_input:
            x = copy_to_model_group(x, self.tp)
        return F.linear(x, self.weight, self.bias)


class RowParallelLinear(nn.Linear):
    """This rank's input features of a Linear (`weight` (out, in/T)) and the
    whole bias: the local product, summed over the model group, plus the
    bias once.  Under bf16 autocast the local product (bf16) is summed in
    fp32, the bias added in fp32, and the result cast back to bf16 once: a
    bf16 sum of bf16 partial sums would round once more than the model-1
    GEMM's epilogue, which fp32 runs would not show."""

    def __init__(self, in_features: int, out_features: int, bias: bool, tp: ModelGroup):
        super().__init__(in_features // tp.size, out_features, bias=bias)
        self.tp = tp

    def reset_parameters(self) -> None:
        """No draw: the weights come from `shard_state_dict`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight)
        out = reduce_from_model_group(y.float(), self.tp)
        if self.bias is not None:
            out = out + self.bias.float()
        return out.to(y.dtype)


def column_parallel(linear: nn.Linear, tp: ModelGroup,
                    copy_input: bool = True) -> ColumnParallelLinear:
    """An empty column-parallel twin of `linear` (the weights come from
    `shard_state_dict`)."""
    return ColumnParallelLinear(linear.in_features, linear.out_features,
                                linear.bias is not None, tp, copy_input)


def row_parallel(linear: nn.Linear, tp: ModelGroup) -> RowParallelLinear:
    return RowParallelLinear(linear.in_features, linear.out_features,
                             linear.bias is not None, tp)


def check_divides(width: int, what: str, size: int) -> None:
    if width % size:
        raise ValueError(f"mesh model={size} does not divide {what} ({width})")


# ------------------------------------------------------------ the layout --

def shard_tensor(name: str, t: torch.Tensor, size: int, rank: int) -> torch.Tensor:
    """Rank `rank`'s shard of the whole tensor `name` (itself when whole):
    qkv by head (each of q, k and v split alike), the other rules' tensors
    in T contiguous blocks of their dimension."""
    dim = sharded_dim(name)
    if dim is None or size == 1:
        return t
    if t.shape[dim] % size:
        raise ValueError(f"mesh model={size} does not divide {name} {tuple(t.shape)}")
    if QKV.search(name):
        qkv = t.reshape((3, size, t.shape[0] // (3 * size)) + tuple(t.shape[1:]))
        return qkv[:, rank].reshape((-1,) + tuple(t.shape[1:]))
    return t.chunk(size, dim)[rank]


def join_shards(name: str, shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """The whole tensor `name` from every model rank's shard, in rank order
    (the inverse of `shard_tensor`)."""
    dim = sharded_dim(name)
    if dim is None:
        return shards[0]
    if QKV.search(name):
        parts = [s.reshape((3, s.shape[0] // 3) + tuple(s.shape[1:])) for s in shards]
        whole = torch.stack(parts, 1)
        return whole.reshape((-1,) + tuple(whole.shape[3:]))
    return torch.cat(list(shards), dim)


def shard_state_dict(mesh: Mesh, full: StateDict) -> StateDict:
    """This rank's state dict from the whole one (`shard_tensor` on every
    tensor)."""
    return {k: shard_tensor(k, v, mesh.model, mesh.model_rank) for k, v in full.items()}


def _gather(tp: ModelGroup, shards: List[torch.Tensor], device=None
            ) -> List[List[torch.Tensor]]:
    """Every model rank's tensors of `shards` (of the same shapes and order
    on every rank), each as the list of the ranks' in rank order, on
    `device` (default each tensor's own): one all-gather of a flat buffer a
    dtype (NCCL takes card tensors, gloo host ones)."""
    on = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend(tp.group) == "nccl" else torch.device("cpu")
    out: List[List[torch.Tensor]] = [[] for _ in shards]
    for dtype in dict.fromkeys(t.dtype for t in shards):
        idx = [i for i, t in enumerate(shards) if t.dtype == dtype]
        flat = torch.cat([shards[i].detach().reshape(-1).to(on) for i in idx])
        parts = [torch.empty_like(flat) for _ in range(tp.size)]
        dist.all_gather(parts, flat, group=tp.group)
        sizes = [shards[i].numel() for i in idx]
        for part in parts:
            for i, piece in zip(idx, part.split(sizes)):
                dev = shards[i].device if device is None else device
                out[i].append(piece.view(shards[i].shape).to(dev))
    return out


def _gather_named(tp: ModelGroup, named: Dict[str, torch.Tensor], device=None) -> StateDict:
    """The whole tensors of a dict of shards and whole tensors (the whole
    ones as they are), the sharded ones gathered in one `_gather`."""
    keys = [k for k in named if sharded_dim(k) is not None]
    joined = {k: join_shards(k, parts)
              for k, parts in zip(keys, _gather(tp, [named[k] for k in keys], device))}
    return {k: joined.get(k, v) for k, v in named.items()}


def gather_state_dict(mesh: Mesh, local: StateDict, device=None) -> StateDict:
    """The whole state dict from every model rank's (the inverse of
    `shard_state_dict`), its sharded tensors gathered over the model group
    (the dict's order must be the group's), joined on `device` (default each
    tensor's own).  The whole tensors are this rank's."""
    if mesh.model == 1:
        return dict(local)
    return _gather_named(ModelGroup(mesh), local, device)


# ------------------------------------------------------------- the model --

def model_group(module: nn.Module) -> Optional[ModelGroup]:
    """The model group a sharded module's layers hold (None: whole)."""
    return next((m.tp for m in module.modules() if getattr(m, "tp", None) is not None),
                None)


def check_model(module: nn.Module, size: int) -> None:
    """Raise ValueError when a model axis of `size` does not divide a width
    that the rules split (the heads, an MLP's hidden size, the box trunk's
    fc width); a module already sharded is not checked again."""
    if size == 1 or model_group(module) is not None:
        return
    for m in module.modules():
        if hasattr(m, "tp_widths"):
            for what, w in m.tp_widths().items():
                check_divides(w, what, size)


def shard_model(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Shard a whole (initialised) module in place for this rank of the
    mesh's model axis: each module that defines `tensor_parallel(tp)` swaps
    in its parallel layers, then the module takes its shard of the whole
    state dict.  At model 1, or when already sharded, the module as it is."""
    if mesh.model == 1:
        return module
    held = model_group(module)
    if held is not None:
        if held.size != mesh.model:
            raise ValueError(f"the model is sharded over {held.size} ranks, "
                             f"the mesh's model axis is {mesh.model}")
        return module
    check_model(module, mesh.model)
    full = module.state_dict()
    tp = ModelGroup(mesh)
    for m in list(module.modules()):
        if hasattr(m, "tensor_parallel"):
            m.tensor_parallel(tp)
    module.load_state_dict(shard_state_dict(mesh, full))
    return module


def full_state_dict(module: nn.Module, device=None) -> StateDict:
    """The module's whole state dict: `gather_state_dict` over its model
    group when it is sharded (every rank of the group calls it; the joined
    tensors on `device`), else its own."""
    tp = model_group(module)
    sd = module.state_dict()
    return sd if tp is None else gather_state_dict(tp.mesh, sd, device)


def load_full_state_dict(module: nn.Module, full: StateDict) -> None:
    """Load a whole state dict into a module, sharded or not."""
    tp = model_group(module)
    module.load_state_dict(full if tp is None else shard_state_dict(tp.mesh, full))


# ---------------------------------------------------------- the gradients --

def reduce_partial_gradients(module: nn.Module) -> int:
    """Sum over the model group the gradients of the whole parameters that
    each model rank computes for its heads only (`PARTIAL`): one bucketed
    all-reduce in parameter order (`parallel.mesh.sum_gradients`), no
    autograd hooks, so every rank runs the collectives in one order.
    Returns the bytes reduced (0 when the module is whole)."""
    tp = model_group(module)
    if tp is None:
        return 0
    params = [p for n, p in module.named_parameters() if PARTIAL.search(n)]
    return sum_gradients(params, tp.group) if params else 0


def grad_norm_fn(mesh: Mesh, names: Sequence[str]) -> Callable[[Sequence[torch.Tensor]],
                                                                torch.Tensor]:
    """The global norm of gradients given in the order of `names`: the
    squares of the sharded ones summed over the model group, each whole one
    counted once (`core.optim.global_norm` at model 1)."""
    from mtp_tpu_torch.core.optim import global_norm

    if mesh.model == 1:
        return global_norm
    tp = ModelGroup(mesh)
    sharded = [sharded_dim(n) is not None for n in names]

    def squares(gs: List[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
        return global_norm(gs).square().reshape(1) if gs else like.new_zeros(1, dtype=torch.float32)

    def norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
        whole = [g for g, s in zip(grads, sharded) if not s]
        parts = [g for g, s in zip(grads, sharded) if s]
        sq = tp.all_reduce(squares(parts, grads[0]))
        return torch.sqrt(squares(whole, grads[0]) + sq).reshape(())

    return norm


def shard_moments(mesh: Mesh, moments: Dict[str, tuple]) -> Dict[str, tuple]:
    """This rank's Adam moments (by parameter name) from the whole ones."""
    return {k: tuple(shard_tensor(k, t, mesh.model, mesh.model_rank) for t in mv)
            for k, mv in moments.items()}


def gather_moments(mesh: Mesh, moments: Dict[str, tuple], device=None) -> Dict[str, tuple]:
    """The whole Adam moments from every model rank's (in the dict's order,
    which the group shares: the optimizer's parameter order), joined on
    `device` (default each tensor's own)."""
    if mesh.model == 1:
        return dict(moments)
    # keyed "i.name": the rules match the parameter name at the key's end
    flat = _gather_named(ModelGroup(mesh), {f"{i}.{k}": t for k, mv in moments.items()
                                            for i, t in enumerate(mv)}, device)
    return {k: tuple(flat[f"{i}.{k}"] for i in range(len(mv))) for k, mv in moments.items()}
