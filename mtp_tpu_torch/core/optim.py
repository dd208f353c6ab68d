"""Optimizer: AdamW with layer-wise LR decay, global-norm clipping and LR
schedules (port of `mtp_tpu/core/optim.py`).

- layer decay: pos_embed/patch_embed → layer 0, blocks.i → i+1, everything
  else → depth+1 (reference `get_num_layer_for_vit`; InternImage:
  `internimage_layer_id`), LR scale `rate^(num_layers - layer_id - 1)` with
  num_layers = depth + 2;
- no weight decay for 1-dim parameters, biases, pos_embed or layer-scale
  gammas; the 2-D rel-pos and Swin tables are decayed;
- the update is the JAX package's optax chain
  `clip → scale_by_adam → add_decayed_weights → ×scale → ×−lr(count)`,
  which is torch AdamW run with the group LR `lr(count)·scale`: the layer
  scale and the LR multiply the Adam step and the decay term alike.

Parameters are named by their port (reference torch) names, e.g.
`backbone.blocks.3.attn.qkv.weight`.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from mtp_tpu_torch.config import (OptimizerConfig, ScheduleConfig,
                                  internimage_config, is_internimage)

Schedule = Callable[[int], float]

# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def make_schedule(cfg: ScheduleConfig, base_lr: float) -> Schedule:
    """step → LR, with optax's arithmetic: linear warmup from
    `base_lr·warmup_ratio` over `warmup_steps`, then the main schedule over
    the remaining steps.  Evaluated at the optimizer's update count, which
    starts at 0 (as `optax.scale_by_learning_rate`)."""
    warm = cfg.warmup_steps
    rest = max(cfg.total_steps - warm, 1)
    min_lr = base_lr * cfg.min_lr_ratio

    if cfg.kind == "cosine":
        def main(step):
            t = min(step, rest)
            cos = 0.5 * (1.0 + math.cos(math.pi * t / rest))
            return base_lr * ((1.0 - cfg.min_lr_ratio) * cos + cfg.min_lr_ratio)
    elif cfg.kind == "poly":
        def main(step):
            frac = min(max(step / rest, 0.0), 1.0)
            return (base_lr - min_lr) * (1.0 - frac) ** cfg.poly_power + min_lr
    elif cfg.kind == "constant":
        def main(step):
            return base_lr
    elif cfg.kind == "step":
        # reference MultiStepLR as fractions of the post-warmup run: the
        # factor applies from its boundary on
        bounds = sorted({int(round(m * rest)): cfg.step_gamma
                         for m in cfg.step_milestones}.items())

        def main(step):
            lr = base_lr
            for boundary, gamma in bounds:
                if step >= boundary:
                    lr *= gamma
            return lr
    else:
        raise ValueError(cfg.kind)

    if warm == 0:
        return main
    start = base_lr * cfg.warmup_ratio

    def schedule(step):
        if step >= warm:
            return main(step - warm)
        return start + (base_lr - start) * max(step, 0) / warm

    return schedule


# ---------------------------------------------------------------------------
# Layer-decay scales and the weight-decay mask
# ---------------------------------------------------------------------------

_BLOCK_RX = re.compile(r"(?:^|\.)blocks\.(\d+)\.")


def vit_layer_id(name: str, num_layers: int) -> int:
    """Layer-decay id of a ViT parameter (reference `get_num_layer_for_vit`);
    num_layers = depth + 2."""
    if ("pos_embed" in name or "cls_token" in name or "mask_token" in name
            or "patch_embed" in name):
        return 0
    m = _BLOCK_RX.search(name)
    if m:
        return int(m.group(1)) + 1
    return num_layers - 1


_LEVEL_BLOCK_RX = re.compile(r"^levels\.(\d+)\.blocks\.(\d+)\.")
_DOWNSAMPLE_RX = re.compile(r"^levels\.(\d+)\.downsample\.")


def internimage_layer_id(name: str, num_layers: int,
                         depths: Tuple[int, ...] = (5, 5, 24, 5)) -> int:
    """Layer-decay id of an InternImage parameter (reference
    mmcv_custom/custom_layer_decay_optimizer_constructor.py:63, as
    `mtp_tpu/models/backbones.py` `internimage_layer_id` maps the flax
    names): the stem → 0, `levels.s.blocks.i` → Σdepths[:s] + i + 1, a
    downsample → the end of its stage Σdepths[:s+1], anything else (the
    pre-norm stage norms) → num_layers − 1."""
    if name.startswith("patch_embed."):
        return 0
    m = _LEVEL_BLOCK_RX.search(name)
    if m:
        return sum(depths[:int(m.group(1))]) + int(m.group(2)) + 1
    m = _DOWNSAMPLE_RX.search(name)
    if m:
        return sum(depths[:int(m.group(1)) + 1])
    return num_layers - 1


def layer_id_fn_for(cfg, root: str = "backbone.") -> Callable[[str, int], int]:
    """Layer-decay id function for a model whose backbone parameters sit
    under `root` (`mtp_tpu/models/backbones.py` `layer_id_fn_for`): the ViT
    or the InternImage mapping by `cfg.name`, with InternImage's stage
    depths those of the config it names (XL or T); names outside the
    backbone go to the last layer."""
    if is_internimage(cfg):
        depths = internimage_config(cfg).depths
        base = lambda name, n: internimage_layer_id(name, n, depths)
    else:
        base = vit_layer_id

    def fn(name: str, num_layers: int) -> int:
        if name.startswith(root):
            return base(name[len(root):], num_layers)
        return num_layers - 1

    return fn


NamedParams = Iterable[Tuple[str, torch.Tensor]]


def layer_decay_scales(named_params: NamedParams, depth: int, rate: float,
                       layer_id_fn: Callable[[str, int], int] = vit_layer_id
                       ) -> Dict[str, float]:
    """name → LR multiplier `rate^(num_layers - id - 1)` (the port has only
    the unrolled layout)."""
    num_layers = depth + 2
    return {name: rate ** (num_layers - layer_id_fn(name, num_layers) - 1)
            for name, _ in named_params}


def wd_mask(named_params: NamedParams) -> Dict[str, bool]:
    """name → whether weight decay applies: not for ndim <= 1 (norm scales,
    biases), biases, pos_embed or layer-scale gammas.  The rel-pos and Swin
    tables are 2-D lookup tables that the reference decays, so they are
    decayed here too."""
    out = {}
    for name, p in named_params:
        leaf = name.rsplit(".", 1)[-1]
        out[name] = not (p.ndim <= 1 or leaf == "bias" or "pos_embed" in name
                         or leaf in ("gamma_1", "gamma_2"))
    return out


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------


def _norm(t: torch.Tensor) -> torch.Tensor:
    """‖t‖ in fp32.  The card reduces in a tree; the CPU's fp32
    `vector_norm` accumulates sequentially (7e-5 relative error on a 2.4M-
    element gradient, a UNet conv's), so there the squares are summed by
    `torch.sum`, which sums in a cascade."""
    t = t.float()
    return torch.linalg.vector_norm(t) if t.is_cuda else t.square().sum().sqrt()


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ ‖t‖²) in fp32, on the tensors' device (no host sync)."""
    return torch.linalg.vector_norm(torch.stack([_norm(t) for t in tensors]))


class LayerDecayAdamW:
    """torch AdamW with one parameter group per (LR scale, decay flag); each
    step sets the group LR to `schedule(count)·scale` and, with
    `clip_norm > 0`, first scales the gradients to a global norm of at most
    `clip_norm` (`optax.clip_by_global_norm`).  `count` is the number of
    updates taken, the optax schedule's count."""

    def __init__(self, named_params: NamedParams, cfg: OptimizerConfig,
                 schedule: Schedule, scales: Dict[str, float],
                 decay: Dict[str, bool]):
        self.cfg, self.schedule = cfg, schedule
        self.count = 0
        groups: Dict[Tuple[float, bool], list] = {}
        self.names: Dict[torch.Tensor, str] = {}
        for name, p in named_params:
            groups.setdefault((scales[name], decay[name]), []).append(p)
            self.names[p] = name
        self.adamw = torch.optim.AdamW(
            [{"params": ps, "lr_scale": scale,
              "weight_decay": cfg.weight_decay if dec else 0.0}
             for (scale, dec), ps in groups.items()],
            lr=0.0, betas=tuple(cfg.betas), eps=cfg.eps)

    @property
    def params(self):
        return [p for g in self.adamw.param_groups for p in g["params"]]

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """One update from the parameters' `.grad`; returns the global norm
        of the raw gradients (before clipping) as a device scalar.  A
        parameter the loss did not reach (no `.grad`: the ViT classifier's
        unused FPN levels) is updated with a zero gradient, as optax updates
        every leaf: its moments decay and weight decay applies."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        if self.cfg.clip_norm > 0:
            coef = torch.clamp(self.cfg.clip_norm / norm, max=1.0)
            torch._foreach_mul_(grads, coef)
        lr = self.schedule(self.count)
        for g in self.adamw.param_groups:
            g["lr"] = lr * g["lr_scale"]
        self.adamw.step()
        self.count += 1
        return norm

    def moments(self) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """Each parameter's Adam moments (exp_avg, exp_avg_sq) by name
        (empty before the first update), the inverse of `load_moments`:
        every parameter takes every update, so torch's per-parameter `step`
        is `count` throughout."""
        return {self.names[p]: (st["exp_avg"], st["exp_avg_sq"])
                for p, st in self.adamw.state.items()}

    def load_moments(self, count: int,
                     moments: Dict[str, Tuple[torch.Tensor, torch.Tensor]]) -> None:
        """Set the update count and each parameter's Adam moments
        (exp_avg, exp_avg_sq) by name, e.g. from `ckpt.from_jax.opt_state_from_jax`
        or a checkpoint (`ckpt.store`); after no update, no moments."""
        unknown = set(moments) - set(self.names.values())
        if unknown or (count and len(moments) != len(self.names)):
            raise KeyError(f"moments for {len(moments)} parameters of "
                           f"{len(self.names)}; unknown {sorted(unknown)[:4]}")
        self.count = count
        self.adamw.state.clear()
        for p, name in self.names.items():
            if name not in moments:
                continue
            mu, nu = moments[name]
            self.adamw.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": mu.to(p.device, p.dtype).clone(),
                "exp_avg_sq": nu.to(p.device, p.dtype).clone()}


def make_optimizer(cfg: OptimizerConfig, schedule: Schedule,
                   named_params: NamedParams, depth: int,
                   layer_id_fn: Callable[[str, int], int] = vit_layer_id,
                   frozen_mask: Optional[Dict[str, bool]] = None
                   ) -> LayerDecayAdamW:
    """AdamW + layer decay, matching the JAX package's optax chain.
    frozen_mask: name → True for parameters that get no update (their LR
    scale is 0; reference `frozen_stages`)."""
    named_params = list(named_params)
    scales = layer_decay_scales(named_params, depth, cfg.layer_decay,
                                layer_id_fn)
    if frozen_mask is not None:
        scales = {n: 0.0 if frozen_mask.get(n, False) else s
                  for n, s in scales.items()}
    return LayerDecayAdamW(named_params, cfg, schedule, scales,
                           wd_mask(named_params))
