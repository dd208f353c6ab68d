#!/usr/bin/env python3
"""`chip_smoke.py`'s phase 25 alone on one NVIDIA GPU: the data-parallel
step of rvsa-l-upernet-384-mae-mtp-spacenetv1 from a state trained a few
steps (phase 7 trains 9; here `--steps`), and with `--carafe-patch8`
phases 25c and 25d (their CPU references while the ranks start, as in
`chip_smoke.py`).

    python3 tools/run_phase25.py [--steps 3] [--cpu-witness] [--carafe-patch8]
                                 [--idle-ab] [--profile] [--pick-witness]
                                 [--repeat N]

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
gradient all-reduce.  `--pick-witness` runs no phase: at the state trained
`--steps` steps and at the seeded initial state, both at identity RVSA
sampling, it holds the first compared batch's fp32 gradients as two
emulated ranks (`split_grads`) against the whole batch by
`two_ranks_rule`, with each rank's own max-pool picks and with the whole
batch's, counts the picks that differ, reads the whole batch against a
second run of itself, and prints for each RVSA sampling regressor's output
bias Σ|terms| / |Σ terms| over the tokens (the cancellation that rounding
is amplified by).  `--repeat N` runs phases 25-26 N times, each from a
state trained one step more than the last (`--steps`, `--steps` + 1, ...)
with rank processes of its own, and prints each run's verdict: the
steadiness of phase 25(b)'s and 26's `two_ranks_rule`.  Every result line names the card and its power
limit; the last line is the total time.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import os
import re
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


def pick_witness(state, batches, card: str, label: str) -> None:
    """See `--pick-witness`; the state is restored after."""
    snap = cs._state_snapshot(state, "cuda")
    cs.identity_sampling(state.model)
    model = state.model
    t32 = cs.SegmentationTask(cs.DDP_FP32, model=model)
    loss_fn = lambda m, b: t32.loss_fn(m, b, None, deterministic=True)[0]
    batch = cs.to_device(batches[0], t32.device)
    rule = cs.two_ranks_rule(cs.PATHS["rvsa"])
    terms: Dict[str, torch.Tensor] = {}

    def keep(out, name):  # each regressor's output gradient (B, C, h, w)
        out.register_hook(lambda g: terms.__setitem__(name, g.detach()))

    hooks = [m.register_forward_hook(lambda mod, i, out, n=n: keep(out, n))
             for n, m in model.named_modules() if re.search(r"attn\.sampling_\w+\.2$", n)]

    def whole(record=None):
        model.zero_grad(set_to_none=True)
        ctx = cs.recorded_pool_picks(record) if record is not None else contextlib.nullcontext()
        with ctx:
            loss = loss_fn(model, batch)
        loss.backward()
        out = float(loss), {n: (torch.zeros_like(p) if p.grad is None else p.grad.detach().clone())
                            for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return out

    picks: Dict[tuple, torch.Tensor] = {}
    ref = whole(picks)
    for h in hooks:
        h.remove()
    ratios = []
    for n, g in terms.items():
        g = g.double().movedim(1, -1).reshape(-1, g.shape[1])
        ratios.append((float(g.abs().sum(0).norm() / g.sum(0).norm()), n))
    ratios.sort()
    again = whole()
    own: Dict[tuple, torch.Tensor] = {}
    split_own = cs.split_grads(loss_fn, model, batch, record=own)
    split_fixed = cs.split_grads(loss_fn, model, batch, picks=picks)
    differ, total = 0, 0
    for key, idx in picks.items():
        half = ((len(idx) // 2,) + key[0][1:],) + key[1:]
        both = torch.cat([own[(0,) + half], own[(1,) + half]])
        differ += int((both != idx).sum())
        total += idx.numel()
    for what, got in (("the whole batch again", again), ("two ranks, own picks", split_own),
                      ("two ranks, the whole batch's picks", split_fixed)):
        ok, summary = cs._grad_verdict(rule, ref, got)
        cs.log(f"[pick witness {label}] {what} vs the whole batch: within {ok}; {summary} "
               f"| card {card}")
    cs.log(f"[pick witness {label}] max-pool picks the two ranks take differently from the "
           f"whole batch: {differ} of {total}; Σ|terms| / |Σ terms| of the sampling "
           f"regressors' output biases over {len(ratios)}: min {ratios[0][0]:.1f} median "
           f"{statistics.median(r for r, _ in ratios):.1f} max {ratios[-1][0]:.1f} at "
           f"{ratios[-1][1]}; largest five {[(n, round(r, 1)) for r, n in ratios[-5:]]} "
           f"| card {card}")
    cs._load_snapshot(state, snap)


def steady(path, steps: int, repeat: int, card: str) -> None:
    """Phases 25-26 `repeat` times, each from the state trained `steps`,
    `steps` + 1, ... steps (fresh rank processes each time; the state moves
    as phase 7's moves from run to run): each run's pass or failure and its
    readings; stops after a failed first run; raises after the last run if
    any failed."""
    failed = []
    train = [cs.synthetic_batch(8, (384, 384), path.recipe.num_classes, cs.SEED + 10 + i)
             for i in range(4)]
    for i in range(repeat):
        t_run, task, state = time.perf_counter(), None, None
        ranks = cs.DdpRanks(path)  # they start while the state trains
        try:
            task = cs.SegmentationTask(path.recipe)
            state = task.init_state(cs._gen(cs.SEED))
            state, _ = task.fit(state, cs.cycle(train), steps + i)
            cs.phase_ddp(state, path, card, ranks)
            verdict = "passed"
        except Exception as e:  # noqa: BLE001 -- counted, raised after the last run
            failed.append(i)
            verdict = f"FAILED: {str(e)[:2000]}"
        finally:
            ranks.close()
        cs.log(f"[steady] run {i + 1} of {repeat} (state trained {steps + i} steps): "
               f"{verdict}; {time.perf_counter() - t_run:.1f} s | card {card}")
        del task, state
        cs.free()
        if failed == [0]:  # the first run failed: no use in the rest
            break
    cs.log(f"[steady] {i + 1 - len(failed)} of {i + 1} runs of phases 25-26 passed | card {card}")
    if failed:
        raise AssertionError(f"runs {failed} failed")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--cpu-witness", action="store_true")
    p.add_argument("--carafe-patch8", action="store_true")
    p.add_argument("--idle-ab", action="store_true")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--pick-witness", action="store_true")
    p.add_argument("--repeat", type=int, default=1)
    args = p.parse_args()
    t0 = time.perf_counter()
    card = cs.phase_device()
    cs.check_sass(cs.phase_build())
    path = cs.PATHS["rvsa"]
    if args.pick_witness:
        task = cs.SegmentationTask(path.recipe)
        state = task.init_state(cs._gen(cs.SEED))
        initial = cs.host_copy(state.model)
        batches = cs._ddp_batches(path)
        train = [cs.synthetic_batch(8, (384, 384), path.recipe.num_classes, cs.SEED + 10 + i)
                 for i in range(4)]
        state, _ = task.fit(state, cs.cycle(train), args.steps)
        pick_witness(state, batches, card, f"trained {args.steps} steps")
        state.model.load_state_dict(initial)
        pick_witness(state, batches, card, "seeded initial")
        cs.log(f"[time] total {time.perf_counter() - t0:.1f} s | {card}")
        return
    if args.repeat > 1:
        steady(path, args.steps, args.repeat, card)
        cs.log(f"[time] total {time.perf_counter() - t0:.1f} s | {card}")
        return
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
