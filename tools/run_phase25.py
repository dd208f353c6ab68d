#!/usr/bin/env python3
"""`chip_smoke.py`'s phase 25 alone on one NVIDIA GPU: the data-parallel
step of rvsa-l-upernet-384-mae-mtp-spacenetv1 from a state trained a few
steps (phase 7 trains 9; here `--steps`), and with `--carafe-patch8`
phases 25c and 25d (their CPU references while the ranks start, as in
`chip_smoke.py`).

    python3 tools/run_phase25.py [--steps 3] [--cpu-witness] [--carafe-patch8]
                                 [--idle-ab] [--profile]

`--cpu-witness` also runs the first compared step's fp32 loss and backward
on the CPU (the plain versions, the same state) and prints each gradient's
distance from it, for (a)'s one-rank DDP run and for (b)'s two-rank run:
how far two fp32 computations of the same step lie apart beside how far
the two worlds do (`chip_smoke.two_ranks_rule`).  `--idle-ab` times the
recipe's plain bf16 step (as phase 7 trains) before phase 25(b)'s two rank
processes start, while they sit set up and idle on the card (as they do
through `chip_smoke.py`'s phases 6 and 7), and after they are gone.
`--profile` times the step with the process group (one NCCL rank) and
without, interleaved, and traces one of each with torch.profiler (the
card's activity): device ms by kernel group, and the host's ms in the
gradient all-reduce.  Every result line names the card and its power
limit; the last line is the total time.
"""

from __future__ import annotations

import argparse
import copy
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List
from unittest import mock

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def cpu_witness(task, out: dict, card: str) -> None:
    """The first compared step's gradients on the CPU against (a)'s and
    (b)'s: each parameter's ‖g − g_cpu‖/‖g_cpu‖ (min / median / max, and
    the largest three)."""
    model = copy.deepcopy(task.model).cpu()
    model.load_state_dict(out["snap"]["model"])
    gen = torch.Generator(device="cuda")
    gen.set_state(out["snap"]["generator"])
    t32 = cs.SegmentationTask(cs.DDP_FP32, model=model, device="cpu")
    t0 = time.perf_counter()
    loss, _ = t32.loss_fn(model, cs.to_device(out["batches"][0], "cpu"), gen,
                          deterministic=True)
    loss.backward()
    g_cpu = {n: p.grad.detach() for n, p in model.named_parameters()}
    for who in ("a", "b"):
        g = out[who]["grads"]
        rel = sorted((float((g[n] - c).norm() / c.norm()), n) for n, c in g_cpu.items()
                     if float(c.norm()) > 0)
        cs.log(f"[ddp witness] {who} vs the CPU, fp32, the first step's gradients (CPU "
               f"{time.perf_counter() - t0:.1f} s, loss {loss.item():.6f} against "
               f"{out[who]['metrics'][0]['loss']:.6f}): ‖Δg‖/‖g‖ min {rel[0][0]:.3e} median "
               f"{statistics.median(r for r, _ in rel):.3e} max {rel[-1][0]:.3e}; largest "
               f"{[(n, f'{r:.2e}') for r, n in rel[-3:]]} | card {card}")


def plain_ms(task, state, batches: List[dict], n: int) -> List[float]:
    """ms of `n` of the task's bf16 steps (no process group: the plain
    step, as phase 7's), each ended by a sync, after one warm-up; the state
    is restored after."""
    snap = cs._state_snapshot(state, "cuda")
    step = task.train_step_fn()
    on_card = [cs.to_device(b, task.device) for b in batches]
    step(state, on_card[0])
    torch.cuda.synchronize()
    out = []
    for i in range(n):
        t0 = time.perf_counter()
        step(state, on_card[i % len(on_card)])
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    cs._load_snapshot(state, snap)
    return out


def _ms(xs: List[float]) -> str:
    return f"median {statistics.median(xs):.2f} ms ({' '.join(f'{x:.1f}' for x in xs)})"


def profile_ddp(path, state, batches: List[dict], card: str, n: int) -> None:
    """The recipe's bf16 step with the process group (an NCCL group of one
    rank, as phase 25(a)) and without: `n` of each, interleaved (A B, then
    B A, ...), ms each ended by a sync; then one of each under
    torch.profiler (the card's activity): device ms by kernel group, NCCL's
    kernels apart, and the host's ms inside `reduce_gradients`."""
    snap = cs._state_snapshot(state, "cuda")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "nccl"), 1),
                                rank=0, world_size=1)
        try:
            task = cs.SegmentationTask(path.recipe, model=state.model)
            fns = {"ddp": task.train_step_fn(),
                   "plain": cs.make_train_step(lambda m, b, g: task.loss_fn(m, b, g))}
            on_card = [cs.to_device(b, task.device) for b in batches]
            for fn in fns.values():
                fn(state, on_card[0])
            torch.cuda.synchronize()
            walls: Dict[str, List[float]] = {"ddp": [], "plain": []}
            for i in range(n):
                for name in (("plain", "ddp") if i % 2 == 0 else ("ddp", "plain")):
                    t0 = time.perf_counter()
                    fns[name](state, on_card[i % len(on_card)])
                    torch.cuda.synchronize()
                    walls[name].append((time.perf_counter() - t0) * 1e3)
            cs.log(f"[ddp profile] bf16 recipe step, batch 8 of 384², {n} each interleaved: "
                   f"with the process group {_ms(walls['ddp'])}; without {_ms(walls['plain'])}; "
                   f"ratio of medians {statistics.median(walls['ddp']) / statistics.median(walls['plain']):.3f} "
                   f"| card {card}")
            reduce = cs.core_train.reduce_gradients
            host: List[float] = []

            def timed_reduce(*a, **k):
                t0 = time.perf_counter()
                out = reduce(*a, **k)
                host.append((time.perf_counter() - t0) * 1e3)
                return out

            cuda = torch.autograd.DeviceType.CUDA
            for name in ("plain", "ddp"):
                host.clear()
                with mock.patch.object(cs.core_train, "reduce_gradients", timed_reduce):
                    torch.cuda.synchronize()
                    with torch.profiler.profile(
                            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                        t0 = time.perf_counter()
                        fns[name](state, on_card[0])
                        torch.cuda.synchronize()
                        wall = (time.perf_counter() - t0) * 1e3
                groups: Dict[str, list] = {}
                for e in prof.events():
                    if e.device_type != cuda or getattr(e, "is_user_annotation", False):
                        continue
                    g = groups.setdefault("nccl" if "nccl" in e.name.lower()
                                          else cs.kernel_group(e.name), [0.0, 0])
                    g[0] += e.device_time_total / 1e3
                    g[1] += 1
                busy = sum(v[0] for v in groups.values())
                cs.log(f"[ddp profile] {name}: one profiled step {wall:.2f} ms, device kernels "
                       f"{busy:.2f} ms ({sum(v[1] for v in groups.values())} launches), busy "
                       f"{busy / wall:.3f}; by group (ms, launches) "
                       f"{ {k: (round(v[0], 3), v[1]) for k, v in sorted(groups.items(), key=lambda kv: -kv[1][0])} }; "
                       f"host ms in reduce_gradients {[round(h, 3) for h in host]} | card {card}")
        finally:
            dist.destroy_process_group()
            cs._load_snapshot(state, snap)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--cpu-witness", action="store_true")
    p.add_argument("--carafe-patch8", action="store_true")
    p.add_argument("--idle-ab", action="store_true")
    p.add_argument("--profile", action="store_true")
    args = p.parse_args()
    t0 = time.perf_counter()
    card = cs.phase_device()
    cs.phase_build()
    path = cs.PATHS["rvsa"]
    if not args.idle_ab:
        ranks = cs.DdpRanks(path)  # they start while the state trains
    task = cs.SegmentationTask(path.recipe)
    state = task.init_state(cs._gen(cs.SEED))
    batches = [cs.synthetic_batch(8, (384, 384), path.recipe.num_classes, cs.SEED + 10 + i)
               for i in range(2)]
    state, _ = task.fit(state, cs.cycle(batches), args.steps)
    if args.idle_ab:
        idle = {"before the ranks": plain_ms(task, state, batches, 8)}
        ranks = cs.DdpRanks(path)
        cs._wait_for(lambda: all(os.path.exists(os.path.join(ranks.tmp, f"idle{r}"))
                                 for r in range(2)), "the ranks' set-up")
        idle["beside the idle ranks"] = plain_ms(task, state, batches, 8)
    if args.profile:
        profile_ddp(path, state, batches, card, 8)
    refs = ((lambda: (cs.carafe_reference(), cs.patch8_reference()))
            if args.carafe_patch8 else (lambda: None))
    try:
        with cs.phase_time("ddp"):
            out = cs.phase_ddp(state, path, card, ranks, refs)
    finally:
        ranks.close()
    if args.carafe_patch8:
        with cs.phase_time("carafe and patch 8 on the card"):
            cs.phase_carafe(out["extra"][0])
            cs.phase_patch8(out["extra"][1])
    if args.idle_ab:
        idle["after the ranks"] = plain_ms(task, state, batches, 8)
        cs.log(f"[ddp idle] the recipe's plain bf16 step (batch 8 of 384², phase 7's), 8 "
               f"after a warm-up each: " + "; ".join(f"{k} {_ms(v)}" for k, v in idle.items())
               + f" | card {card}")
    if args.cpu_witness:
        cpu_witness(task, out, card)
    cs.log(f"[time] total {time.perf_counter() - t0:.1f} s | {card}")


if __name__ == "__main__":
    main()
