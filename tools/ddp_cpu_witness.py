#!/usr/bin/env python3
"""How far two fp32 computations of one train step of the full-width
segmentation model lie apart on the CPU: the data-parallel step at world 2
(two gloo ranks, `tests/torch_ddp_workers.py`) against world 1, and world 1
at 4 threads against world 1 at 1 (the same function in another order of
summation).  The model of rvsa-l-upernet-384-mae-mtp-spacenetv1 (ViT-L+RVSA,
UperNet of 512 channels) at 128² crops, a global batch of 4 with ignored
pixels in rank 0's rows, fp32, without dropout or drop-path.  Prints each
comparison's backbone-block gradients' ‖Δg‖/‖g‖ (min / median / max) and
the loss and grad norm of each run; `chip_smoke.two_ranks_rule` quotes it.

    python3 tools/ddp_cpu_witness.py       # ~2-3 min on 8 cores
"""

from __future__ import annotations

import dataclasses
import statistics
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from mtp_tpu_torch import configs  # noqa: E402
from torch_ddp_workers import run, seg_task, train_steps  # noqa: E402


def distances(a: dict, b: dict) -> str:
    rel = [float((b[n] - g).norm() / g.norm()) for n, g in a.items()
           if n.startswith("backbone.blocks") and float(g.norm()) > 0]
    return f"{min(rel):.2e} / {statistics.median(rel):.2e} / {max(rel):.2e}"


def main() -> None:
    cfg = configs.get("rvsa-l-upernet-384-mae-mtp-spacenetv1").task
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, img_size=128, dtype="float32"))
    rng = np.random.default_rng(0)
    label = rng.integers(0, 2, (4, 128, 128))
    label[0, 10:40, 10:60] = 255
    batch = {"image": rng.standard_normal((4, 128, 128, 3)).astype(np.float32), "label": label}
    payload = dict(cfg=cfg, channels=512, crop=128, state_dict=None, batches=[batch],
                   deterministic=True)
    runs = {}
    for threads in (4, 1):
        torch.set_num_threads(threads)
        runs[threads] = train_steps(*seg_task(payload), payload)
    with tempfile.TemporaryDirectory() as tmp:
        runs["world 2"] = run("seg_step", 2, tmp, payload, timeout=1800)[0]
    for name, r in runs.items():
        m = r["metrics"][0]
        print(f"{name}: loss {m['loss']:.7f} grad_norm {m['grad_norm']:.7f}")
    print("backbone blocks' ‖Δg‖/‖g‖ min / median / max: world 1 at 4 threads vs 1 "
          + distances(runs[4]["grads"], runs[1]["grads"]) + "; world 2 vs world 1 (4 threads) "
          + distances(runs[4]["grads"], runs["world 2"]["grads"]) + " (CPU)")


if __name__ == "__main__":
    main()
