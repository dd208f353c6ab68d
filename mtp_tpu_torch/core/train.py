"""Train state, train-step factory and losses (port of `mtp_tpu/core/train.py`).

PyTorch runs eagerly, so there is no jit: the step is a function that runs
the loss, its backward and the optimizer update, mutating the state's model
and optimizer in place (JAX returns a new state).  The port runs on one
device; `shard_state` and `opt_state_shardings` are mesh-only and are not
ported (data-parallel training is ROADMAP queue 1 item 12).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mtp_tpu_torch.core.optim import LayerDecayAdamW
from mtp_tpu_torch.ops.precision import at_least_fp32


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


def make_train_step(loss_fn: LossFn):
    """Build the train step: (state, batch) → (state, metrics), with metrics
    `loss` and `grad_norm` (the global norm of the raw gradients, before any
    clipping) added to the loss function's own.  Metrics stay device
    tensors: reading one waits for the step."""

    def step(state: TrainState, batch: Any):
        state.optimizer.zero_grad()
        loss, metrics = loss_fn(state.model, batch, state.generator)
        loss.backward()
        grad_norm = state.optimizer.step()
        state.step += 1
        return state, dict(metrics, loss=loss.detach(), grad_norm=grad_norm)

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
    is valid (where the mean of `F.cross_entropy` would be NaN).

    logits (B, H, W, K) at label resolution; labels (B, H, W) int."""
    labels = labels.long()
    ce = F.cross_entropy(at_least_fp32(logits).permute(0, 3, 1, 2), labels,
                         ignore_index=ignore_index, reduction="none")
    return ce.sum() / (labels != ignore_index).sum().clamp(min=1)
