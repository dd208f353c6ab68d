#!/usr/bin/env python3
"""What a registered op adds to a kernel's call on the host: K1, K2 and K3
at `chip_smoke.py` phase 3's slice shapes (bf16: K1 64 windows × 16 heads
of 49 tokens, D 64; K2 64 heads over the 24×24 grid; K3 64 maps of 28², C
64, P 1), each called three ways on the same inputs, on one NVIDIA GPU:

- "body": the wrapper's body called directly (`fused_attn._window_fwd`,
  `fused_attn._flash_fwd`, `dcnv3_sample._sample_fwd`), the call the
  wrappers made before the ops were registered;
- "op": the registered op (`torch.ops.mtp.window_attn_fwd.default`, ...),
  the call the main path makes now (`kernels/ops.py`: `torch.library.
  Library` with a CompositeExplicitAutograd implementation);
- "custom_op": the same body registered here by `torch.library.custom_op`
  (namespace `mtp_timing`), the registration `kernels/ops.py` does not use
  for its Python dispatch's cost.

    python3 tools/time_dispatch.py        # from the repository root

Each is timed as `chip_smoke.loop_ms` times it (REPS back-to-back calls
between one pair of CUDA events, over REPS: the host's work a call is
longer than these kernels' device time, so this is the host's time a
call), in the order body, op, custom_op, custom_op, op, body; then each
call's host time alone (perf_counter over REPS calls, no sync between
them), in the same order.  A registration's cost is its difference from
the body.  The first and last lines name the card and its power
limit.
"""

from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path
from typing import List, Tuple

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from mtp_tpu_torch.ops import dcnv3_sample, fused_attn  # noqa: E402

REPS = 200
ORDER = ("body", "op", "custom_op", "custom_op", "op", "body")


@torch.library.custom_op("mtp_timing::window_attn_fwd", mutates_args=())
def _k1(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
        scale: float) -> torch.Tensor:
    return fused_attn._window_fwd(q, k, v, bias, scale)


@torch.library.custom_op("mtp_timing::flash_attn_fwd", mutates_args=())
def _k2(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rel_h: torch.Tensor,
        rel_w: torch.Tensor, grid_hw: List[int], scale: float
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    return fused_attn._flash_fwd(q, k, v, rel_h, rel_w, grid_hw, scale)


@torch.library.custom_op("mtp_timing::bilinear_sample_fwd", mutates_args=())
def _k3(img: torch.Tensor, py: torch.Tensor, px: torch.Tensor, m: torch.Tensor, H: int,
        W: int) -> torch.Tensor:
    return dcnv3_sample._sample_fwd(img, py, px, m, H, W)


def host_us(fn) -> float:
    """µs of host time a call, over REPS calls not waited for (the card
    runs behind)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / REPS * 1e6


def main() -> None:
    card = cs.phase_device()
    cs.check_sass(cs.phase_build())
    bf16 = torch.bfloat16
    k1 = cs.window_case(64, 16, 49, 64, 1).args(bf16)
    k2 = cs.flash_case(64, (24, 24), 64, 3).args(bf16)
    k3 = cs.sample_case(64, 28, 28, 64, 784, 1, 5, edge=False).args(bf16)
    calls = {
        "K1": dict(body=lambda: fused_attn._window_fwd(*k1),
                   op=lambda: torch.ops.mtp.window_attn_fwd.default(*k1),
                   custom_op=lambda: _k1(*k1)),
        "K2": dict(body=lambda: fused_attn._flash_fwd(*k2),
                   op=lambda: torch.ops.mtp.flash_attn_fwd.default(*k2),
                   custom_op=lambda: _k2(*k2)),
        "K3": dict(body=lambda: dcnv3_sample._sample_fwd(*k3),
                   op=lambda: torch.ops.mtp.bilinear_sample_fwd.default(*k3),
                   custom_op=lambda: _k3(*k3)),
    }
    for name, fns in calls.items():
        outs = [fn() for fn in fns.values()]
        outs = [[t] if torch.is_tensor(t) else list(t) for t in outs]
        if not all(torch.equal(a, b) for other in outs[1:] for a, b in zip(outs[0], other)):
            raise AssertionError(f"{name}: a registration's output differs from the body's")
        loop = {k: [] for k in fns}
        for which in ORDER:
            loop[which].append(cs.loop_ms(fns[which], reps=REPS, warmup=20) * 1e3)
        host = {k: [] for k in fns}
        for which in ORDER:
            host[which].append(host_us(fns[which]))
        line = []
        for what, times in (("back to back", loop), ("host", host)):
            mean = {k: statistics.mean(v) for k, v in times.items()}
            each = ", ".join(f"{k} {' / '.join(f'{t:.2f}' for t in v)}"
                             for k, v in times.items())
            line.append(f"{what} µs a call: {each}; op +{mean['op'] - mean['body']:.2f}, "
                        f"custom_op +{mean['custom_op'] - mean['body']:.2f}")
        print(f"[dispatch {name}] {'; '.join(line)} | card {card}", flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
