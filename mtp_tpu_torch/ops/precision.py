"""The precision of what runs outside the kernels: the plain versions and
the layers that compute in fp32 by design (the rel-pos tables, RVSA's
sampling grid, the head's train-mode BatchNorm, the loss) take fp32 or
wider.  float64 stays float64, so that a float64 copy of a model on the
CPU evaluates the same function as the fp32 one, in float64: a reference
for the rounding of fp32 runs on the card and on the CPU.  No kernel takes
float64; the wrappers accept it on the CPU only, where the plain versions
run."""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def at_least_fp32(t: torch.Tensor) -> torch.Tensor:
    """t in fp32, or unchanged if it is float64 (`Tensor.float()` would
    round it)."""
    return t if t.dtype == torch.float64 else t.float()


def plain_float64(*tensors: torch.Tensor) -> bool:
    """Whether the tensors are float64 on the CPU, which the plain versions
    (and only they) take."""
    return all(t.dtype == torch.float64 and t.device.type == "cpu" for t in tensors)


class NoDowncast(TorchDispatchMode):
    """Raises where an operator takes a float64 tensor and returns a float32
    or narrower one: under it, a float64 run of the model that completes
    computed in float64 throughout, forward and backward (a dispatch mode
    sees the operators autograd runs too).  `calls` counts the operators it
    saw, `backward_calls` those run while autograd's engine executed a
    backward."""

    def __init__(self):
        super().__init__()
        self.calls = self.backward_calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.calls += 1
        self.backward_calls += torch._C._current_graph_task_id() != -1
        if _any_float64((args, kwargs)) and _any_narrower(out):
            raise TypeError(f"{func} took float64 and returned a narrower float")
        return out


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _any_float64(x) -> bool:
    return any(t.dtype == torch.float64 for t in _tensors(x))


def _any_narrower(x) -> bool:
    return any(t.is_floating_point() and t.dtype != torch.float64
               for t in _tensors(x))
