"""The training loop of the task drivers (port of `mtp_tpu/tasks/_fit.py`
`fit_loop`).  Periodic checkpoints and the encoder export wait for the port
of `ckpt/store.py` (ROADMAP queue 1 item 12)."""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from mtp_tpu_torch.core.train import TrainState


def _to_device(v, device) -> torch.Tensor:
    t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
    return t.to(device, non_blocking=True)


def fit_loop(task, state: TrainState, data: Iterator[Dict], steps: int, *,
             log_every: int = 50,
             log_fn: Optional[Callable[[int, dict], None]] = None,
             ckpt=None, ckpt_every: int = 1000,
             encoder_path: Optional[str] = None) -> Tuple[TrainState, dict]:
    """Run `steps` optimizer steps on batches from `data` (dicts of numpy
    arrays or tensors, moved to `task.device`).

    At step 0, every `log_every`-th step and the last one, `log_fn(i,
    metrics)` gets the step's metrics as floats plus `data_time` (host
    seconds per step spent taking the batch and starting its copy to the
    device) and `step_time` (wall seconds per step), both averaged over the
    steps since the last log.  Reading the metrics waits for the device, so
    the loop synchronises only at log steps."""
    if ckpt is not None or encoder_path is not None:
        raise NotImplementedError(
            "checkpointing is not ported yet (ROADMAP queue 1 item 12)")
    step_fn = task.train_step_fn()
    metrics: dict = {}
    t_data = 0.0
    t_mark = time.perf_counter()
    n_since = 0
    for i in range(steps):
        t0 = time.perf_counter()
        batch = {k: _to_device(v, task.device) for k, v in next(data).items()}
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
    return state, {k: float(v) for k, v in metrics.items()}
