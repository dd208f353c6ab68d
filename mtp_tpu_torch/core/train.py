"""Train state, train-step factory and losses (port of `mtp_tpu/core/train.py`).

PyTorch runs eagerly, so there is no jit: the step is a function that runs
the loss, its backward and the optimizer update, mutating the state's model
and optimizer in place (JAX returns a new state).  With a mesh whose
process group is up (`parallel.mesh`), the step averages the gradients over
the data group before the norm and the update, as JAX's step over the
mesh's data axis computes them over the global batch.  JAX's `shard_state`
and `opt_state_shardings` (the parameters and the Adam moments at the
Megatron rules' layout over the model axis) are `parallel.tensor`'s
`shard_model` (called by `tasks._fit.Task` when it draws the state) and
the optimizer's moments, which live beside the shards they update; a
sharded model's step first sums over the model group the gradients each
model rank computed for its heads only
(`parallel.tensor.reduce_partial_gradients`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mtp_tpu_torch.core.optim import LayerDecayAdamW
from mtp_tpu_torch.ops.precision import at_least_fp32
from mtp_tpu_torch.parallel.mesh import (Mesh, all_reduce_mean, global_count, reduce_gradients,
                                         use_mesh)
from mtp_tpu_torch.parallel.tensor import reduce_partial_gradients


@dataclass
class TrainState:
    """`step` counts the updates taken; `generator` (on the model's device)
    draws every dropout and drop-path mask of the train steps."""

    step: int
    model: nn.Module
    optimizer: LayerDecayAdamW
    generator: torch.Generator


def create_state(model: nn.Module, optimizer: LayerDecayAdamW,
                 generator: torch.Generator) -> TrainState:
    return TrainState(step=0, model=model, optimizer=optimizer,
                      generator=generator)


# loss_fn(model, batch, generator) -> (loss, metrics); the model updates its
# BatchNorm running statistics itself during the forward
LossFn = Callable[[nn.Module, Any, torch.Generator],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def make_train_step(loss_fn: LossFn, mesh: Optional[Mesh] = None):
    """Build the train step: (state, batch) → (state, metrics), with metrics
    `loss` and `grad_norm` (the global norm of the raw gradients, before any
    clipping) added to the loss function's own.  Metrics stay device
    tensors: reading one waits for the step.

    With a `mesh` whose process group is up, `batch` holds the data rank's
    rows of the global batch.  After the backward, a model sharded over the
    mesh's model axis first sums over the model group the gradients of the
    whole parameters that each model rank computed for its heads only
    (`parallel.tensor.reduce_partial_gradients`); then the gradients are
    averaged over the data group (`parallel.mesh.reduce_gradients`: one
    all-reduce a bucket, in parameter order, a missing gradient as zeros),
    so `grad_norm` (over the shards and each whole parameter once), the
    clipping and the update are the global batch's on every rank, and the
    metrics are averaged too (the losses normalise by global counts,
    `parallel.mesh.global_count`, so their mean is the global value).  An
    explicit all-reduce rather than `DistributedDataParallel`, because the
    steps call the model's methods around `forward` (`loss`, `features`,
    the multitask trunks) and recompute under `torch.utils.checkpoint`."""
    ddp = mesh is not None and mesh.distributed

    def step(state: TrainState, batch: Any):
        if ddp:
            use_mesh(mesh)
        state.optimizer.zero_grad()
        loss, metrics = loss_fn(state.model, batch, state.generator)
        loss.backward()
        if ddp:
            reduce_partial_gradients(state.model)
            reduce_gradients([p for p in state.model.parameters()
                              if p in state.optimizer.names])
        grad_norm = state.optimizer.step()
        state.step += 1
        metrics = dict(metrics, loss=loss.detach())
        if ddp:
            keys = list(metrics)
            mean = all_reduce_mean(torch.stack([metrics[k].detach().float().reshape(())
                                                for k in keys]))
            metrics = dict(zip(keys, mean.unbind()))
        return state, dict(metrics, grad_norm=grad_norm)

    return step


# ---------------------------------------------------------------------------
# Losses (semantics of the reference heads' loss_decode configs)
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy, labels (B,) int — mmpretrain CrossEntropyLoss."""
    return F.cross_entropy(at_least_fp32(logits), labels.long())


def seg_xent(logits: torch.Tensor, labels: torch.Tensor,
             ignore_index: int = 255) -> torch.Tensor:
    """Pixel cross entropy with ignore_index, averaged over valid pixels
    (mmseg CrossEntropyLoss(avg_non_ignore) semantics), and 0 when no pixel
    is valid (where the mean of `F.cross_entropy` would be NaN).  Under
    data parallel the valid pixels are counted over the global batch
    (`parallel.mesh.global_count`).

    logits (B, H, W, K) at label resolution; labels (B, H, W) int."""
    labels = labels.long()
    ce = F.cross_entropy(at_least_fp32(logits).permute(0, 3, 1, 2), labels,
                         ignore_index=ignore_index, reduction="none")
    return ce.sum() / global_count((labels != ignore_index).sum())
