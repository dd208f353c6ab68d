"""Stochastic regularisers of the train step, drawn from explicit
generators: elementwise dropout (flax `nn.Dropout`), channel dropout
(Dropout2d) and per-sample drop-path (`mtp_tpu/models/vit_rvsa.py`
`drop_path`).  Each draws its mask from the
`torch.Generator` it is given, on the generator's device, and uses it on the
tensor's: the train state's generator lives on the card with the model, and
a CPU generator drives a run on the card with the very masks it draws for a
run on the CPU.  Under data parallel each mask is this rank's rows of the
global batch's mask (`parallel.mesh.global_rand`)."""

from __future__ import annotations

from typing import Optional

import torch

from mtp_tpu_torch.parallel.mesh import global_rand


def _keep(x: torch.Tensor, mask: torch.Tensor, keep: float) -> torch.Tensor:
    return torch.where(mask, x / keep, torch.zeros_like(x))


def _uniform(shape, generator: Optional[torch.Generator],
             device: torch.device) -> torch.Tensor:
    """U[0, 1) numbers of `shape` (batch first) drawn by `generator`, placed
    on `device`."""
    if generator is None:
        raise ValueError("a stochastic layer needs a generator when "
                         "deterministic=False")
    return global_rand(shape, generator).to(device)


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Keep each element with probability 1 − rate, scaled by 1/(1 − rate)."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = _uniform(x.shape, generator, x.device) < keep
    return _keep(x, mask, keep)


def dropout2d(x: torch.Tensor, rate: float, deterministic: bool,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Dropout2d of an NHWC map: each sample's channels kept whole with
    probability 1 − rate, scaled by 1/(1 − rate) (the multitask ss heads'
    channel mask, `mtp_tpu/models/multitask.py` `ss_logits`)."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = _uniform((x.shape[0], 1, 1, x.shape[-1]), generator, x.device) < keep
    return _keep(x, mask, keep)


def drop_path_mask(x: torch.Tensor, rate: float, deterministic: bool,
                   generator: Optional[torch.Generator]) -> Optional[torch.Tensor]:
    """The per-sample keep mask of drop-path (stochastic depth) for a
    residual branch shaped like x: each sample's whole branch is kept with
    probability 1 − rate (None when nothing is dropped).  Drawn apart from
    its use (`apply_drop_path`) so that a layer recomputed under
    `torch.utils.checkpoint` reuses the forward's mask: checkpoint restores
    the global RNGs, not an explicit generator."""
    if deterministic or rate == 0.0:
        return None
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    return _uniform(shape, generator, x.device) < 1.0 - rate


def apply_drop_path(x: torch.Tensor, mask: Optional[torch.Tensor],
                    rate: float) -> torch.Tensor:
    """The branch x under a `drop_path_mask`, kept samples scaled by
    1/(1 − rate)."""
    return x if mask is None else _keep(x, mask, 1.0 - rate)

