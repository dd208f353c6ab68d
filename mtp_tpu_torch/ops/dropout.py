"""Stochastic regularisers of the train step, drawn from explicit
generators: elementwise dropout (flax `nn.Dropout`) and per-sample drop-path
(`mtp_tpu/models/vit_rvsa.py` `drop_path`).  Each draws its mask from the
`torch.Generator` it is given, which lives on the tensor's device."""

from __future__ import annotations

from typing import Optional

import torch


def _keep(x: torch.Tensor, mask: torch.Tensor, keep: float) -> torch.Tensor:
    return torch.where(mask, x / keep, torch.zeros_like(x))


def _need(generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is None:
        raise ValueError("a stochastic layer needs a generator when "
                         "deterministic=False")
    return generator


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Keep each element with probability 1 − rate, scaled by 1/(1 − rate)."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=_need(generator), device=x.device) < keep
    return _keep(x, mask, keep)


def drop_path_mask(x: torch.Tensor, rate: float, deterministic: bool,
                   generator: Optional[torch.Generator]) -> Optional[torch.Tensor]:
    """The per-sample keep mask of `drop_path` for a branch shaped like x
    (None when nothing is dropped).  Drawn apart from its use so that a
    layer recomputed under `torch.utils.checkpoint` reuses the forward's
    mask: checkpoint restores the global RNGs, not an explicit generator."""
    if deterministic or rate == 0.0:
        return None
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    return torch.rand(shape, generator=_need(generator), device=x.device) < 1.0 - rate


def apply_drop_path(x: torch.Tensor, mask: Optional[torch.Tensor],
                    rate: float) -> torch.Tensor:
    return x if mask is None else _keep(x, mask, 1.0 - rate)


def drop_path(x: torch.Tensor, rate: float, deterministic: bool,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Stochastic depth on a residual branch: keep each sample's whole
    branch with probability 1 − rate, scaled by 1/(1 − rate)."""
    return apply_drop_path(x, drop_path_mask(x, rate, deterministic, generator),
                           rate)
