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


def drop_path(x: torch.Tensor, rate: float, deterministic: bool,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Stochastic depth on a residual branch: keep each sample's whole
    branch with probability 1 − rate, scaled by 1/(1 − rate)."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = torch.rand(shape, generator=_need(generator), device=x.device) < keep
    return _keep(x, mask, keep)
