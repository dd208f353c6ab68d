"""The process mesh (port of `mtp_tpu/parallel/mesh.py`): data parallel
across processes, and the groups of the model axis.

JAX lays its devices on a (data, model) mesh and jits one step over the
global batch, sharded over `data`, with the Megatron rules' parameters
sharded over `model`.  The port runs one process a card, the reference's
own design (DDP over NCCL, main_pretrain.py:508-524): torchrun starts
W = D·T processes on a `Mesh(data=D, model=T)`, rank r at data index r // T
and model index r % T (JAX's `reshape(data, model)` of the device list).
The T consecutive ranks of a model group hold one model between them
(`parallel.tensor`: each its shard of the rules' parameters, the rest
whole) and see the same rows; the D ranks of a data group (stride T) hold
the same shard.  Data rank d owns the rows [d·B/D, (d+1)·B/D) of every
global batch of B (`process_batch_rows`, JAX's rows), and the train step
averages the gradients over the data group (`reduce_gradients`, called by
`core.train.make_train_step`).  What JAX computes over the whole global
batch the port computes over the data group too:
- BatchNorm's batch statistics (`heads.upernet.BatchNorm`, two all-reduces
  through which the gradient flows);
- each loss normalizer that sums over the batch (`global_count`): a rank's
  loss is its local sum over the world's count times W, so the averaged
  gradients are the global batch's;
- every random draw (`global_rand`): each rank draws the global batch's
  shape from the shared generator and keeps its data rank's rows, so the
  generators of all ranks stay in step, the model ranks of a data group
  draw the same masks, and a world-W step equals the world-1 step.
Every helper here (the rows, the draws, `global_count`, `all_reduce_sum`,
`all_gather_objects`, `reduce_gradients`) works over the data group of the
process's mesh, the last `make_mesh` made (or the world's when none was);
the model group's collectives are `parallel.tensor`'s.  `is_main` is rank 0
of the world.

Without a process group every helper is the identity, and the port runs as
on one device.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

# the gradient buckets of `reduce_gradients`: 64 MiB of fp32 each
BUCKET_ELEMENTS = 1 << 24


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def is_main() -> bool:
    """Rank 0, or the only process."""
    return rank() == 0


def init_distributed(device="cuda", timeout: Optional[float] = None) -> torch.device:
    """Start the process group from torchrun's variables (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) and return the
    rank's device: `cuda:LOCAL_RANK` (NCCL) when `device` is the card, the
    CPU (gloo) when the caller asked for it.  Without the variables there
    is no process group and `device` comes back as it is.  A rendezvous
    that fails within `timeout` seconds (default torch's) raises: a rank
    never carries on alone."""
    device = torch.device(device)
    if "WORLD_SIZE" not in os.environ:
        return device
    if not initialized():
        kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
        backend = "nccl" if device.type == "cuda" else "gloo"
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]), **kw)
    return _rank_device(device)


def _rank_device(device: torch.device) -> torch.device:
    """`device` with the rank's card when it names the card without an index."""
    if device.type == "cuda" and device.index is None and initialized():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank())))
    return device


@dataclass(frozen=True)
class Mesh:
    """The port's mesh: `data` × `model` processes (the world); rank r at
    data index r // model and model index r % model.  `model_group` (the
    `model` consecutive ranks holding one model) and `data_group` (the
    `data` ranks at the rank's model index) are process groups, None where
    the world's default group serves (a model axis of 1) or no process group
    is up."""

    data: int = 1
    model: int = 1
    model_group: Any = field(default=None, compare=False, repr=False)
    data_group: Any = field(default=None, compare=False, repr=False)

    @property
    def rank(self) -> int:
        return rank()

    @property
    def data_rank(self) -> int:
        return rank() // self.model

    @property
    def model_rank(self) -> int:
        return rank() % self.model

    @property
    def distributed(self) -> bool:
        """Whether a process group is up (at world 1 too: the step then
        all-reduces over the one rank)."""
        return initialized()

    def device(self, device) -> torch.device:
        """The task's device: `cuda` becomes the rank's card."""
        return _rank_device(torch.device(device))


_CURRENT: List[Optional[Mesh]] = [None]  # the process's mesh (the last one made)


def current_mesh() -> Optional[Mesh]:
    return _CURRENT[0] if initialized() else None


def use_mesh(mesh: Mesh) -> None:
    """Make `mesh` the process's mesh, whose data group the helpers here
    work over (`make_mesh` does so for the mesh it makes)."""
    _CURRENT[0] = mesh


def data_size() -> int:
    """The data axis's size: the world's over the model axis."""
    m = current_mesh()
    return world_size() if m is None else m.data


def data_rank() -> int:
    """This rank's index on the data axis."""
    m = current_mesh()
    return rank() if m is None else m.data_rank


def data_group():
    """The process group of this rank's data axis (None: the world's)."""
    m = current_mesh()
    return None if m is None else m.data_group


def make_mesh(cfg=None) -> Mesh:
    """The mesh of a `config.MeshConfig` in this world, made the process's
    mesh: `model` −1 (or 0) is 1; `data` −1 (or 0) is the world size over
    `model`, any other `data` must make data × model the world size.  With a
    model axis over 1 every rank creates every model group (consecutive
    ranks) and then every data group (stride `model`) with `dist.new_group`,
    in that order."""
    data = -1 if cfg is None else cfg.data
    model = 1 if cfg is None or cfg.model <= 0 else cfg.model
    world = world_size()
    if data <= 0:
        if world % model:
            raise ValueError(f"mesh model={model}: the world has {world} process(es), "
                             f"which the model axis does not divide")
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh data={data} × model={model}: the world has {world} "
                         f"process(es); data × model must be the world size")
    model_group = data_group_ = None
    if model > 1:
        r = rank()
        for d in range(data):
            g = dist.new_group(list(range(d * model, (d + 1) * model)))
            if r // model == d:
                model_group = g
        for t in range(model):
            g = dist.new_group(list(range(t, world, model)))
            if r % model == t:
                data_group_ = g
    mesh = Mesh(data=data, model=model, model_group=model_group, data_group=data_group_)
    use_mesh(mesh)
    return mesh


def process_batch_rows(mesh: Mesh, global_batch: int) -> np.ndarray:
    """The rows of a global batch that this rank owns (JAX's
    `process_batch_rows`): [d·B/D, (d+1)·B/D) at data rank d, the same for
    every rank of a model group."""
    if global_batch % mesh.data:
        raise ValueError(f"global batch {global_batch} must divide the data axis "
                         f"({mesh.data})")
    b = global_batch // mesh.data
    d = mesh.data_rank
    return np.arange(d * b, (d + 1) * b, dtype=np.int64)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a global batch: a dict of arrays or tensors,
    nested per dataset (the multitask batch), each leaf sliced by the rows of
    its own leading size."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if mesh.data == 1:
        return batch
    rows = process_batch_rows(mesh, batch.shape[0])
    return batch[int(rows[0]):int(rows[-1]) + 1]


def shard_items(items: Iterable) -> Iterator[Tuple[int, Any]]:
    """(index, item) of every D-th item of `items`, starting at the data
    rank's own: the rank's share of an evaluation (the same items for every
    rank of a model group)."""
    W, r = data_size(), data_rank()
    for i, item in enumerate(items):
        if i % W == r:
            yield i, item


# ------------------------------------------------------------ collectives --

def _comm_device(t: torch.Tensor) -> torch.device:
    """Where the backend takes `t`: NCCL only on the card."""
    if t.device.type == "cpu" and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


class _AllReduceSum(torch.autograd.Function):
    """Σ over the ranks of `group`; the gradient of every rank's copy of the
    sum flows back to every rank's summand (an all-reduce of the
    gradients)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group=None) -> torch.Tensor:
        ctx.group = group
        y = x.detach().to(_comm_device(x), copy=True).contiguous()
        dist.all_reduce(y, group=group)
        return y.to(x.device)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _AllReduceSum.apply(g, ctx.group), None


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Σ of `t` over the data group (differentiable); `t` itself without a
    process group."""
    return _AllReduceSum.apply(t, data_group()) if initialized() else t


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The data group's mean of `t` (differentiable); `t` without a process
    group."""
    return all_reduce_sum(t) / data_size() if initialized() else t


def all_gather_objects(obj) -> List[Any]:
    """Every data rank's `obj` (picklable), in data-rank order."""
    if not initialized():
        return [obj]
    out: List[Any] = [None] * data_size()
    dist.all_gather_object(out, obj, group=data_group())
    return out


def is_data_main() -> bool:
    """Data rank 0: the rank of a data group that scores an evaluation."""
    return data_rank() == 0


def gather_in_order(records: Iterable[Tuple[int, list]]) -> list:
    """Every data rank's (item index, [records]) pairs, concatenated in item
    order: an evaluation's per-image records as one process makes them."""
    pairs = sorted((p for part in all_gather_objects(list(records)) for p in part),
                   key=lambda p: p[0])  # stable: a batch's records keep their order
    return [r for _, recs in pairs for r in recs]


def barrier() -> None:
    if initialized():
        dist.barrier()


def global_count(n: torch.Tensor) -> torch.Tensor:
    """A loss normalizer counted over the whole global batch, as the data
    ranks' mean: Σ_data ranks n floored at 1, over D.  A rank's local sum
    over it is D times its share of the global mean, so the data ranks'
    averaged gradients are the global batch's.  `n` floored at 1 without a
    process group."""
    return all_reduce_sum(n.detach().float()).clamp(min=1) / data_size()


def sum_gradients(params: Sequence[nn.Parameter], group=None, divisor: int = 1,
                  bucket_elements: int = BUCKET_ELEMENTS) -> int:
    """Sum the parameters' gradients over the ranks of `group` in place, then
    divide them by `divisor`: flattened into fp32 buckets in parameter order, one
    all-reduce a bucket.  A gradient that is None (the loss did not reach
    the parameter on this rank) goes in as zeros, so the buckets line up on
    every rank.  Returns the bytes reduced."""
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    total = 0
    start = 0
    while start < len(grads):
        end, n = start, 0
        while end < len(grads) and (n == 0 or n + grads[end].numel() <= bucket_elements):
            n += grads[end].numel()
            end += 1
        bucket = grads[start:end]
        flat = torch.cat([g.reshape(-1).float() for g in bucket])
        dist.all_reduce(flat, group=group)
        if divisor != 1:
            flat.div_(divisor)
        torch._foreach_copy_(bucket, [c.view_as(g) for c, g in
                                      zip(flat.split([g.numel() for g in bucket]), bucket)])
        total += flat.numel() * flat.element_size()
        start = end
    return total


def reduce_gradients(params: Sequence[nn.Parameter],
                     bucket_elements: int = BUCKET_ELEMENTS) -> int:
    """Average the parameters' gradients over the data group in place
    (`sum_gradients` over D): a missing gradient goes in as zeros and comes
    back as the average.  Returns the bytes reduced."""
    return sum_gradients(params, data_group(), data_size(), bucket_elements)


# ------------------------------------------------------ global-row draws --

_LAYOUTS = threading.local()  # each thread's stack of `batch_layout`s


def _layouts() -> List[Tuple[np.ndarray, int]]:
    if not hasattr(_LAYOUTS, "stack"):
        _LAYOUTS.stack = []
    return _LAYOUTS.stack


def concat_rows(local_sizes: Sequence[int]) -> Tuple[np.ndarray, int]:
    """(rows, global size) of a batch concatenated from segments of these
    local sizes, each one a global batch split over the ranks (the
    multitask encoder's datasets): the data rank's rows of each segment
    inside the concatenated global batch."""
    W, r = data_size(), data_rank()
    rows, off = [], 0
    for b in local_sizes:
        rows.append(off + r * b + np.arange(b))
        off += b * W
    return np.concatenate(rows).astype(np.int64), off


@contextlib.contextmanager
def batch_layout(rows: np.ndarray, global_size: int):
    """Within the block, a draw whose batch axis holds len(rows) entries
    keeps these rows of a draw of `global_size` (other draws keep the
    rank's contiguous block)."""
    _layouts().append((np.asarray(rows, np.int64), int(global_size)))
    try:
        yield
    finally:
        _layouts().pop()


def global_rand(shape, generator: torch.Generator, batch_axis: int = 0) -> torch.Tensor:
    """U[0, 1) of `shape` on the generator's device, drawn as this data
    rank's rows of the global batch's draw: the generator draws the global
    shape (the local batch axis times D, or a `batch_layout`'s global size)
    and the rank keeps its rows: at data 1 the whole draw."""
    W = data_size()
    shape = list(shape)
    n = shape[batch_axis]
    layout = next(((rows, g) for rows, g in reversed(_layouts()) if len(rows) == n), None)
    shape[batch_axis] = layout[1] if layout else n * W
    u = torch.rand(shape, generator=generator, device=generator.device)
    if layout is None:
        return u.narrow(batch_axis, data_rank() * n, n)
    return u.index_select(batch_axis, torch.as_tensor(layout[0], device=u.device))
