#!/usr/bin/env python3
"""The detection train step, predict and evaluate of `chip_smoke.py`
(phase 19: Faster R-CNN; phase 20: Oriented R-CNN) alone, from a checkout
of this repo, on one NVIDIA GPU.

    python3 tools/time_det_step.py [--root DIR] [--path det_vit [det_rot_vit ...]]

Imports `chip_smoke` from DIR (default: this checkout), builds DIR's
kernels if they are stale, and runs its `phase_det_train` for each path:
launch counts, ms/step (median of the path's timed steps), images/s,
data_time, peak memory, the device's busy share and its kernel groups, a
predict of 2 images and evaluate, as the full script prints them.  The
card-vs-CPU checks of those phases are not run.  Each run also prints the
host's CPU model, its cores and its load average, since the step is bound
by the host.

To compare two commits on one card, unpack the other into a git-ignored
directory (`git archive <commit> | tar -x -C work_dirs/other`) and run both
in one call, in the order A, B, B, A.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path


def host() -> str:
    """The CPU model, the cores this process may use, the 1-minute load."""
    model = "unknown"
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                model = line.split(":", 1)[1].strip()
                break
    except OSError:
        pass
    return (f"{model}, {len(os.sched_getaffinity(0))} cores, load "
            f"{os.getloadavg()[0]:.2f}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--path", nargs="+", default=["det_vit"])
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    os.chdir(root)
    import chip_smoke as c  # the checkout's own script and package

    card = c.phase_device()
    c._build.lib()
    paths = {**c.DET_PATHS, **getattr(c, "ROT_PATHS", {})}
    for name in args.path:
        c.log(f"[host] {root.name}: {host()} before {name}")
        c.free()
        with c.phase_time(f"{root.name} {name} train"):
            c.phase_det_train(paths[name], card)
    c.log(f"[host] {root.name}: {host()} at the end")


if __name__ == "__main__":
    main()
