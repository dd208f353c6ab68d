#!/usr/bin/env python3
"""Times of K1-K6 and K8 at the shapes of the registry's OSCD 96² recipes
(`*-unet-96-*_oscd_rgb`), which `chip_smoke.py` holds against the plain
versions but does not time (`chip_smoke.phase_oscd_kernels`), on one NVIDIA
GPU.

    python3 tools/time_oscd.py        # from the repository root

bf16, the inputs of `chip_smoke.oscd_cases` (made from their seeds): the
ViT-L's 6² token grid padded to one 7² window an image (K1/K4, 8 windows
× 16 heads of 49 tokens), full attention over N = 36 (K2/K5, 128 heads of
the 6×6 grid), K3/K6 on 128 maps of the padded 7² grid; InternImage-XL's K8
forward and backward on its stage maps of 24², 12², 6² and 3².  Each row is
checked against its plain version as `chip_smoke.check_kernels` checks it,
then timed as back-to-back calls (`chip_smoke.loop_ms`) and as device time
(`chip_smoke.graph_ms`, calls captured in a CUDA graph and replayed), the
kernel and, where one PyTorch call computes the same function (SDPA and
its grad, `F.grid_sample` and its grad), that call alike; the plain
version back to back; the bound.  The first and last lines name the card
and its power limit.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    card = cs.phase_device()
    cs.check_sass(cs.phase_build())
    cases = {k: [(label, dataclasses.replace(case, dtypes=(torch.bfloat16,),
                                             device_time=True, controls=False,
                                             deterministic=False))
                 for label, case in v] for k, v in cs.oscd_cases().items()}
    cs.check_kernels(cases, record_label=None, timed=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
