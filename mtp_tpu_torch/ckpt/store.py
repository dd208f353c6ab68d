"""Checkpoint store: save and restore the whole `TrainState`, and the
encoder-only export (port of `mtp_tpu/ckpt/store.py`; reference
main_pretrain.py:821-829 periodic checkpoints and the encoder artifact,
:478-505 resume).

A checkpoint is one `torch.save` file, `<directory>/<step>.pt`, holding
- `step`;
- `model`: the model's state dict, BatchNorm running statistics included;
- `optimizer`: the `LayerDecayAdamW` update count and each parameter's
  Adam moments, keyed by parameter name (`LayerDecayAdamW.moments`);
- `generator`: the state of the state's generator (`get_state`), which
  draws every dropout and drop-path mask.
Writes are atomic, as orbax's are: the file is written under a temporary
name in the same directory and then `os.replace`d, so a crash leaves either
the old set of checkpoints or the new one, plus at most a temporary file
that `latest_step` ignores.  The write itself runs on a background thread
after the tensors are copied to the host; `save(wait=True)`, the next
`save`, `latest_step`, `restore` and `close` wait for it and raise what it
raised.  Checkpoints hold tensors and plain values only and load with
`weights_only=True`.

Under data parallel (`parallel.mesh`) every rank holds the same state:
rank 0 alone writes, and every rank restores the same file after a
barrier, so the restored state, generator included, is the same on every
rank.
"""

from __future__ import annotations

import os
import re
import tempfile
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from mtp_tpu_torch.ckpt.torch_convert import load_torch_checkpoint
from mtp_tpu_torch.core.train import TrainState
from mtp_tpu_torch.parallel.mesh import barrier, is_main

_NAME = re.compile(r"^(\d+)\.pt$")


def _host(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of every tensor on the host (the snapshot a background write
    may read while training goes on)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}


def _write(obj, path: str) -> None:
    """torch.save to a temporary file beside `path`, then rename it: readers
    see the whole file or none."""
    directory = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(prefix="." + os.path.basename(path) + ".",
                               suffix=".tmp", dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


class CheckpointStore:
    """Numbered checkpoints of a `TrainState` in `directory` (created),
    the newest `max_to_keep` kept."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None

    def _wait(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def steps(self):
        """The steps of the complete checkpoints, ascending."""
        return sorted(int(m[1]) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    def save(self, step: int, state: TrainState, wait: bool = False) -> None:
        """Snapshot the state to the host and write it in the background
        (rank 0; the other ranks write nothing)."""
        if not is_main():
            return
        self._wait()
        snapshot = {
            "step": int(state.step),
            "model": _host(state.model.state_dict()),
            "optimizer": {"count": state.optimizer.count, "moments": {
                name: tuple(t.detach().to("cpu", copy=True) for t in mv)
                for name, mv in state.optimizer.moments().items()}},
            "generator": state.generator.get_state(),
        }
        self._pending = self._pool.submit(self._commit, step, snapshot)
        if wait:
            self._wait()

    def _commit(self, step: int, snapshot: dict) -> None:
        _write(snapshot, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.unlink(self._path(old))

    def latest_step(self) -> Optional[int]:
        self._wait()
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state_like: TrainState,
                step: Optional[int] = None) -> Optional[TrainState]:
        """Load checkpoint `step` (default the latest) into `state_like` (a
        state of the same model and optimizer, e.g. a fresh task's
        `init_state`) in place and return it; None when there is nothing to
        restore.  Every rank calls it: a barrier waits for rank 0's writes."""
        self._wait()
        barrier()
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        ckpt = torch.load(self._path(step), map_location="cpu", weights_only=True)
        state_like.model.load_state_dict(ckpt["model"])
        opt = ckpt["optimizer"]
        state_like.optimizer.load_moments(opt["count"], opt["moments"])
        state_like.generator.set_state(ckpt["generator"])
        state_like.step = ckpt["step"]
        return state_like

    def close(self) -> None:
        try:
            self._wait()
        finally:
            self._pool.shutdown()


# ------------------------------------------------------------ artifacts --

def save_encoder(path: str, encoder: nn.Module) -> None:
    """The encoder-only artifact (the analog of the reference's
    `last_*_pretrn_model_encoder.pth`): the backbone's state dict in the
    reference names, which `mtp_tpu.ckpt.torch_convert` reads as it reads a
    released `.pth`.  Written atomically."""
    save_state_dict(path, encoder.state_dict())


def save_state_dict(path: str, sd: Dict[str, torch.Tensor]) -> None:
    """A state dict, copied to the host, written atomically to `path`."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _write(_host(sd), os.path.abspath(path))


def _unflatten(path: str) -> dict:
    """A JAX `save_encoder` / `save_variables` `.npz` → its nested dict of
    arrays ("a/b/c" keys)."""
    tree: dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            node = tree
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = flat[key]
    return tree


def load_encoder(path: str, cfg) -> Dict[str, torch.Tensor]:
    """An encoder artifact → its reference-name state dict, for
    `ckpt.torch_convert.backbone_state_dict` (which resizes it to the
    model's grid): a torch file (the port's `save_encoder`, a released
    `.pth`) as it is, a JAX `save_encoder` `.npz` (unrolled or scanned
    layout) through `ckpt.from_jax.backbone_from_jax` for the backbone of
    `cfg`."""
    if path.endswith(".npz"):
        from mtp_tpu_torch.ckpt.from_jax import backbone_from_jax
        return backbone_from_jax(_unflatten(path), cfg)
    return load_torch_checkpoint(path)


def save_variables(path: str, model: nn.Module) -> None:
    """A whole model's state dict (parameters and BatchNorm statistics), the
    port's counterpart of the JAX full-variables `.npz`."""
    save_encoder(path, model)


def load_variables(path: str) -> dict:
    """Inverse of `save_variables` (a state dict); a JAX `.npz` gives its
    nested {"params", "batch_stats"} arrays, which the model's converter in
    `ckpt.from_jax` (`segmentor_from_jax`, `classifier_from_jax`,
    `change_detector_from_jax`) takes."""
    if path.endswith(".npz"):
        return _unflatten(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def npz_is_full_variables(path: str) -> bool:
    """Whether a JAX `.npz` holds full variables (keys under `params/`)
    rather than an encoder."""
    with np.load(path) as flat:
        return any(k.startswith("params/") for k in flat.files)
