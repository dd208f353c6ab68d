"""`chip_smoke.py` phases 25(b) and 26's two-rank check on the CPU, at toy
size: the first compared step of every run (the one-rank steps, the two
ranks, their emulation `split_grads`) takes the max-pool picks of the
whole global batch's forward (`compared_picks`).  Where a max-pool window's
top two inputs lie within rounding of each other, two summation orders can
pick either, and the gradient routed to the other input is a discrete
difference, not a rounding one: one such window moves the toy's gradients
by percents, where summation order alone moves them by ~1e-6.  Here, at the
compared state (identity RVSA sampling, no dropout or drop-path), for
several seeds: the compared picks are the whole batch's own, the two
emulated ranks on them stay within `two_ranks_rule` (in float64 within
1e-9 and the rule's absolute floor); each rank's own picks are its rows of the whole batch's
when no window ties (and then the emulation takes the same step), and a pick moved to another element of its window
puts the emulation outside the rule."""

import contextlib
import math
import types

import pytest
import torch

import chip_smoke as cs
from mtp_tpu_torch.config import BackboneConfig, TaskConfig, TrainConfig
from mtp_tpu_torch.models.segmentor import Segmentor

torch.set_num_threads(1)

CFG = BackboneConfig(img_size=64, embed_dim=32, depth=4, num_heads=2, interval=2,
                     out_indices=(0, 1, 2, 3), dtype="float32")
TASK = TaskConfig(task="segmentation", num_classes=3, backbone=CFG,
                  train=TrainConfig(batch_size=8))
RULE = cs.two_ranks_rule(cs.PATHS["rvsa"])


def compared(seed: int, dtype=torch.float32):
    """The task, its state at identity RVSA sampling, the state's snapshot
    and a global batch of 8 whose row 0 ignores a block of pixels more (as
    `chip_smoke._ddp_batches`)."""
    task = cs.SegmentationTask(TASK, model=Segmentor(CFG, 3, channels=16, input_hw=(64, 64)),
                               device="cpu")
    state = task.init_state(torch.Generator().manual_seed(seed))
    state.model.to(dtype)
    cs.identity_sampling(state.model)
    batch = cs.synthetic_batch(8, (64, 64), 3, cs.SEED + 60 + seed)
    batch["label"][0, 10:20, 5:40] = 255
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    batch["image"] = batch["image"].to(dtype)
    return task, state, cs._state_snapshot(state), batch


def loss_fn(task):
    return lambda m, b: task.loss_fn(m, b, None, deterministic=True)[0]


def whole(task, state, batch, picks=None):
    """(loss, gradients) of the whole batch's step, with `picks` fixed."""
    fixed = cs.fixed_pool_picks(picks) if picks is not None else contextlib.nullcontext()
    with fixed:
        loss = loss_fn(task)(state.model, batch)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
    state.model.zero_grad(set_to_none=True)
    return loss.item(), grads


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_two_emulated_ranks_on_the_compared_picks_stay_within_the_rule(seed):
    task, state, snap, batch = compared(seed)
    picks = cs.compared_picks(task, state, snap, batch)
    assert [k[0] for k in picks] == [(8, 32, 4, 4)]  # the ViT's fpn4
    assert all(torch.equal(v, snap["model"][k]) for k, v in state.model.state_dict().items())
    # the compared picks are the whole batch's own: fixing them moves the
    # step by rounding alone (the gathered maxima's layout)
    free, ref = whole(task, state, batch), whole(task, state, batch, picks)
    ok, summary = cs._grad_verdict(RULE, free, ref)
    assert ok and abs(free[0] - ref[0]) <= 1e-6 * abs(ref[0]), summary
    split = cs.split_grads(loss_fn(task), state.model, batch, picks)
    ok, summary = cs._grad_verdict(RULE, ref, split)
    assert ok, summary
    # in float64 the two ranks lie closer still (an identity tap's one-sided
    # derivative is not float64's at fp32's coordinates: no fp32-float64 rule)
    t64, s64, _, b64 = compared(seed, torch.float64)
    exact = whole(t64, s64, b64, picks)
    split64 = cs.split_grads(loss_fn(t64), s64.model, b64, picks)
    tight = types.SimpleNamespace(grad_rtol={"backbone": 1e-9, "convs": 1e-9},
                                  head_prefixes=RULE.head_prefixes)
    ok, summary = cs._grad_verdict(tight, exact, split64)
    assert ok, summary
    # each rank's own picks are its rows of the whole batch's (no window ties here)
    own = {}
    split_own = cs.split_grads(loss_fn(task), state.model, batch, record=own)
    for r in range(2):
        rows = cs.rows_of(picks, 4 * r, 4 * (r + 1))
        assert all(torch.equal(own[(r,) + k], v) for k, v in rows.items())
    ok, summary = cs._grad_verdict(RULE, split, split_own)
    assert ok, summary


def test_one_moved_pick_puts_the_emulation_outside_the_rule():
    """The control of the diagnosis: the same emulation with one window of
    one image and channel taking another element of its window (the
    discrete difference a near tie can make) fails the rule the compared
    picks pass."""
    task, state, snap, batch = compared(0)
    picks = cs.compared_picks(task, state, snap, batch)
    ref = whole(task, state, batch, picks)
    moved = {k: v.clone() for k, v in picks.items()}
    idx = next(iter(moved.values()))
    idx[0, 0, 0, 0] ^= 1  # the other column of the same 2×2 window
    ok, summary = cs._grad_verdict(RULE, ref, cs.split_grads(loss_fn(task), state.model,
                                                             batch, moved))
    assert not ok, summary


def test_the_sampling_regressors_gradients_cancel():
    """The regressors' output-bias gradients are sums over every token's
    tap of terms of both signs.  Σ|terms| / |Σ terms| (norms over the output
    channels) at the compared state, in float64, for seeds 0-3: 1.2-11.6
    over the toy's six regressors, and the largest of each seed 3.6-11.6
    (the full-size model's read 6-14 on the card): the largest stays above
    3, so the sums amplify their terms' rounding at least 3×."""
    for seed in range(4):
        task, state, snap, batch = compared(seed, torch.float64)
        terms = {}

        def keep(mod, inputs, out, name):  # each regressor's output gradient (B, C, h, w)
            out.register_hook(lambda g: terms.__setitem__(name, g))

        hooks = [m.register_forward_hook(lambda mod, i, out, n=n: keep(mod, i, out, n))
                 for n, m in state.model.named_modules()
                 if n.endswith(("sampling_offsets.2", "sampling_scales.2",
                                "sampling_angles.2"))]
        whole(task, state, batch)
        for h in hooks:
            h.remove()
        assert len(terms) == 3 * 2  # the toy's two RVSA blocks
        ratios = {}
        for n, g in terms.items():
            g = g.movedim(1, -1).reshape(-1, g.shape[1])
            ratios[n] = float(g.abs().sum(0).norm() / g.sum(0).norm())
        assert all(math.isfinite(r) for r in ratios.values()), ratios
        assert max(ratios.values()) >= 3.0, (seed, ratios)
