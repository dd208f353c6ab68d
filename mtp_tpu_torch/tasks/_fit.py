"""What the task drivers share (port of `mtp_tpu/tasks/_fit.py` and of the
drivers' common `init_state`): the training loop `fit_loop`, with periodic
checkpoints and the encoder export, and `Task`, the base of every task
driver.  Under data parallel (`parallel.mesh`: one process a card) each
rank trains on its rows of every global batch; rank 0 alone logs and
writes checkpoints."""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mtp_tpu_torch.ckpt.from_jax import init_weights
from mtp_tpu_torch.ckpt.store import save_encoder
from mtp_tpu_torch.config import TaskConfig
from mtp_tpu_torch.core.optim import layer_id_fn_for, make_optimizer, make_schedule
from mtp_tpu_torch.core.train import TrainState, create_state
from mtp_tpu_torch.parallel.mesh import is_main, make_mesh, shard_batch


def to_device(v, device):
    """A batch (numpy arrays or tensors, in dicts, which may nest: the
    multitask batch is {"d0": {...}, "d1": ..., "d2": ...}) on `device`."""
    if isinstance(v, dict):
        return {k: to_device(x, device) for k, x in v.items()}
    t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
    return t.to(device, non_blocking=True)


def _save(ckpt, state: TrainState, encoder_path: Optional[str],
          wait: bool = False) -> None:
    """A checkpoint of the state and, with `encoder_path`, the encoder
    artifact: the model's `encoder` if it has one, else its `backbone`
    (rank 0 writes both)."""
    ckpt.save(state.step, state, wait=wait)
    if encoder_path and is_main():
        encoder = getattr(state.model, "encoder", None)
        save_encoder(encoder_path,
                     state.model.backbone if encoder is None else encoder)


def fit_loop(task, state: TrainState, data: Iterator[Dict], steps: int, *,
             log_every: int = 50,
             log_fn: Optional[Callable[[int, dict], None]] = None,
             ckpt=None, ckpt_every: int = 1000,
             encoder_path: Optional[str] = None,
             global_batch: bool = False) -> Tuple[TrainState, dict]:
    """Run `steps` optimizer steps on batches from `data` (dicts of numpy
    arrays or tensors, nested or not, moved to `task.device`).  Under data
    parallel a batch is the rank's rows (`data.loader.Loader(batch_rows=
    parallel.mesh.process_batch_rows(...))`), or, with `global_batch`, the
    whole global batch, of which the loop keeps the rank's rows
    (`parallel.mesh.shard_batch`: each dataset's of the multitask batch).

    At step 0, every `log_every`-th step and the last one, `log_fn(i,
    metrics)` gets the step's metrics as floats plus `data_time` (host
    seconds per step spent taking the batch and starting its copy to the
    device) and `step_time` (wall seconds per step), both averaged over the
    steps since the last log.  Reading the metrics waits for the device, so
    the loop synchronises only at log steps.

    With a `ckpt.store.CheckpointStore`, the state is saved every
    `ckpt_every` steps except after the last, and once at the end, waiting
    for the write; each save also writes the encoder artifact to
    `encoder_path` when given (reference main_pretrain.py:821-829).  Rank 0
    alone calls `log_fn` and writes (`CheckpointStore.save` is a no-op on
    the other ranks)."""
    step_fn = task.train_step_fn()
    log_fn = log_fn if is_main() else None
    metrics: dict = {}
    t_data = 0.0
    t_mark = time.perf_counter()
    n_since = 0
    for i in range(steps):
        t0 = time.perf_counter()
        batch = next(data)
        if global_batch:
            batch = shard_batch(task.mesh, batch)
        batch = to_device(batch, task.device)
        t_data += time.perf_counter() - t0
        state, metrics = step_fn(state, batch)
        n_since += 1
        if log_fn and (i % log_every == 0 or i == steps - 1):
            m = {k: float(v) for k, v in metrics.items()}  # waits for the step
            wall = time.perf_counter() - t_mark
            m["data_time"] = t_data / n_since
            m["step_time"] = wall / n_since
            log_fn(i, m)
            t_data = 0.0
            n_since = 0
            t_mark = time.perf_counter()
        if ckpt is not None and (i + 1) % ckpt_every == 0 and i != steps - 1:
            _save(ckpt, state, encoder_path)
    if ckpt is not None:
        _save(ckpt, state, encoder_path, wait=True)
    return state, {k: float(v) for k, v in metrics.items()}


class Task:
    """A task driver on one device (`device`, the card unless the caller
    asks for another) for `model`, whose backbone is `model.encoder` (the
    multitask model) or else `model.backbone`.  `mesh` is the config's
    mesh in this world (`parallel.mesh.make_mesh`: `data` -1 or the world
    size, no model axis); under data parallel the card is the rank's
    (`cuda:LOCAL_RANK`).

    Compute precision follows the backbone config's `dtype`, as the JAX
    package's does: "bfloat16" runs the train step and evaluation under
    bf16 autocast (parameters, optimizer state, BatchNorm statistics and
    the loss stay fp32), "float32" runs them in fp32."""

    def __init__(self, cfg: TaskConfig, model: nn.Module, device="cuda"):
        self.mesh = make_mesh(cfg.train.mesh)
        self.cfg = cfg
        self.model = model
        self.device = self.mesh.device(device)
        self.num_classes = cfg.num_classes

    def autocast(self):
        """bf16 autocast when the backbone config computes in bfloat16."""
        if self.cfg.backbone.dtype == "bfloat16":
            return torch.autocast(self.device.type, dtype=torch.bfloat16)
        return contextlib.nullcontext()

    @property
    def backbone_root(self) -> str:
        """The prefix of the backbone's parameter names."""
        return "encoder." if hasattr(self.model, "encoder") else "backbone."

    def _init_state(self, generator: torch.Generator,
                    pretrained_backbone: Optional[dict] = None,
                    frozen_backbone: bool = False,
                    frozen: Tuple[str, ...] = ()) -> TrainState:
        """Random weights from `generator` (a CPU generator: the weights are
        drawn on the CPU, then the model moves to the task's device), an
        optional backbone state_dict on top (`ckpt.torch_convert.
        backbone_state_dict` makes one from a checkpoint), the optimizer
        (layer decay by the backbone's layer ids; no update of the
        parameters whose names start with one of `frozen`, nor, with
        `frozen_backbone`, of the backbone's), and the state's own generator
        on the device, seeded from `generator`."""
        cfg, root = self.cfg, self.backbone_root
        model = init_weights(self.model.cpu(), generator)
        if pretrained_backbone is not None:
            getattr(model, root[:-1]).load_state_dict(pretrained_backbone)
        model.to(self.device)
        frozen = tuple(frozen) + ((root,) if frozen_backbone else ())
        mask = ({n: n.startswith(frozen) for n, _ in model.named_parameters()}
                if frozen else None)
        tx = make_optimizer(cfg.train.optimizer,
                            make_schedule(cfg.train.schedule, cfg.train.optimizer.lr),
                            model.named_parameters(), cfg.backbone.depth,
                            layer_id_fn=layer_id_fn_for(cfg.backbone, root=root),
                            frozen_mask=mask)
        seed = int(torch.randint(2 ** 62, (), generator=generator))
        rng = torch.Generator(device=self.device).manual_seed(seed)
        return create_state(model, tx, rng)

    def init_state(self, generator: torch.Generator,
                   pretrained_backbone: Optional[dict] = None) -> TrainState:
        return self._init_state(generator, pretrained_backbone)

    def fit(self, state: TrainState, data: Iterator[Dict[str, np.ndarray]],
            steps: int, log_every: int = 50,
            log_fn: Callable[[int, dict], None] = None,
            **kw) -> Tuple[TrainState, dict]:
        """`fit_loop` over this task's train step; `kw`: `ckpt`,
        `ckpt_every`, `encoder_path`, `global_batch`."""
        return fit_loop(self, state, data, steps, log_every=log_every,
                        log_fn=log_fn, **kw)

    def _check_state(self, state: TrainState) -> None:
        if state.model is not self.model:
            raise ValueError("the state does not hold this task's model")
