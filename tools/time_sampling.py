#!/usr/bin/env python3
"""Device time of K3 and K6 (bilinear multi-tap sampling, forward and
backward) at the main paths' shapes on one NVIDIA GPU, for comparing two
versions of the port on one card.

    python3 tools/time_sampling.py [--root DIR] [--bodies]

bf16, the inputs of `chip_smoke.py`'s cases (made from their seeds):
- K3 and K6 at RVSA's slice (64 / 128 maps of 28², C = 64, P = 1), and
  F.grid_sample and its grad on the same inputs;
- K8, i.e. K3 and K6 at InternImage-XL's stage 0 (BG 96, 128², gc = 16,
  P = 9) at random offsets (the record shape) and at large ones.
Each is timed as device time by `chip_smoke.graph_ms` (20 calls captured in
a CUDA graph and replayed) and as back-to-back calls of the wrapper
(`chip_smoke.loop_ms`).  `--root DIR` imports `mtp_tpu_torch` from DIR, a
checkout of another commit (e.g. the parent, unpacked with `git archive`
into a gitignored directory), whose kernels build into DIR's `_build/`: one
call can then time both versions in turns (parent, change, change, parent).
`--bodies` also times each body the kernels may run at each shape (the
scalar body beside the one `sample_body` picks), calling the launchers
directly, after holding its outputs to the wrapper's (the version under
`--root` must have `sample_body`).  Every line carries the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def forced(bwd: bool, body: str, args: tuple):
    """The K3 (K6) wrapper's work with the body named, not the rule's."""
    import torch

    from mtp_tpu_torch.kernels import _build
    from mtp_tpu_torch.ops import dcnv3_sample as dcn

    img, py, px, m, H, W = *args[:4], *args[-2:]
    BG, HW, C = img.shape
    _, HWo, P = py.shape
    code, ptrs = _build.dtype_code(img), [t.data_ptr() for t in args[:4]]
    if not bwd:
        def run():
            out = torch.empty(BG, HWo, C, dtype=img.dtype, device=img.device)
            _build.launch("mtp_bilinear_sample_fwd", *ptrs, out.data_ptr(), BG, H, W, C,
                          HWo, P, dcn.BODIES[body], code)
            return out
        return run

    def run_bwd():
        dimg = torch.zeros(BG, HW, C, dtype=torch.float32, device=img.device)
        dpy, dpx, dm = (torch.empty_like(py) for _ in range(3))
        _build.launch("mtp_bilinear_sample_bwd", *ptrs, args[4].data_ptr(),
                      dimg.data_ptr(), dpy.data_ptr(), dpx.data_ptr(), dm.data_ptr(), BG,
                      H, W, C, HWo, P, dcn.BODIES[body], code)
        return dimg.to(img.dtype), dpy, dpx, dm
    return run_bwd


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=REPO,
                    help="the checkout whose mtp_tpu_torch is timed")
    ap.add_argument("--bodies", action="store_true",
                    help="also time each body the kernels may run")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("tools/time_sampling.py: no CUDA device")
    # this checkout's chip_smoke (its cases and timers) over root's package
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from mtp_tpu_torch.kernels import _build

    hw = card()
    tag = f"[sampling {root.name}]"
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(force=True)
    _build.lib()
    for line in _build.PTXAS_LOG:
        if "bilinear_sample" in line:
            print(f"{tag} ptxas {line}", flush=True)
    cases = [
        ("K3 slice", False, smoke.sample_case(64, 28, 28, 64, 784, 1, 5, edge=False)),
        ("K6 slice", True, smoke.sample_case(128, 28, 28, 64, 784, 1, 15, edge=False,
                                             bwd=True)),
        ("K8 fwd stage0 random", False, smoke.dcnv3_case(8, 128, 12, 16, 30, "random")),
        ("K8 bwd stage0 random", True, smoke.dcnv3_case(8, 128, 12, 16, 30, "random",
                                                        bwd=True)),
        ("K8 fwd stage0 large", False, smoke.dcnv3_case(8, 128, 12, 16, 33, "large")),
        ("K8 bwd stage0 large", True, smoke.dcnv3_case(8, 128, 12, 16, 33, "large",
                                                       bwd=True)),
    ]
    for name, bwd, case in cases:
        a = case.args(torch.bfloat16)
        runs = [("kernel", lambda: case.kernel(*a))]
        if case.library is not None:
            runs.append(case.library(a)[::-1])
        if args.bodies:
            from mtp_tpu_torch.ops import dcnv3_sample as dcn

            img, py, H, W = a[0], a[1], *a[-2:]
            rule = dcn.sample_body(img.shape[-1], py.shape[-1], img.dtype, True, bwd=bwd,
                                   same_grid=py.shape[1] == H * W)
            with torch.no_grad():
                want = case.kernel(*a)
                want = want if isinstance(want, tuple) else (want,)
                for body in dict.fromkeys(("scalar", rule)):
                    run = forced(bwd, body, a)
                    got = run()
                    got = got if isinstance(got, tuple) else (got,)
                    for i, (x, y) in enumerate(zip(got, want)):
                        smoke.max_abs_err(x, y, f"{name} body {body} output {i}")
                    runs.append((f"body {body}", run))
        for what, fn in runs:
            with torch.enable_grad() if "grad" in what else torch.no_grad():
                graph = smoke.graph_ms(fn)
                loop = smoke.loop_ms(fn)
            print(f"{tag} {name:22s} {what:22s} device {graph:.4f} ms (CUDA graph), "
                  f"back-to-back {loop:.4f} ms | {hw}", flush=True)
        del a, runs
        smoke.free()


if __name__ == "__main__":
    main()
