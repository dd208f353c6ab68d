"""The serving side of `tests/test_torch_port_export*.py`: a process that
imports `mtp_tpu_torch.serving` and nothing else of the port, and serves
artifacts on the CPU.  It imports no JAX.

    python tests/torch_serve_worker.py JOBS.json

JOBS.json: {"threads": n, "jobs": [{"name", "dir", "inputs" (a `torch.save`d
list of tensors), "result" (where the outputs go), "control" (a weight
name)}, ...]}.  For each job, `load_artifact(dir, "cpu")` and one call on
the inputs; then the same call with the `control` weight scaled by 0.9 in
place; then, with every kernel route forced on the CPU as the launch-count
tests force it (`_build.use_kernel` true, launches counted and not run,
outputs zeroed), the launches of one call.  Writes {"out", "control"} to
`result` and prints one JSON line: {name: {"launches": {...}}, ...,
"modules": the port's, JAX's and flax's modules the process imported}.
"""

import json
import sys

import torch

from mtp_tpu_torch import serving
from mtp_tpu_torch.kernels import _build
from mtp_tpu_torch.ops import dcnv3_sample, fused_attn, nms, rotated_boxes

COUNTED = (fused_attn.LAUNCHES, dcnv3_sample.LAUNCHES, nms.LAUNCHES, rotated_boxes.LAUNCHES)


def stub_kernels() -> None:
    """The kernel routes on CPU tensors, their launches not run and their
    outputs zeros (the process ends after)."""
    _build.use_kernel = lambda *t: True
    _build.check_on_card = lambda *t, **k: None
    _build.launch = lambda name, *a: None
    torch.empty, torch.empty_like = torch.zeros, torch.zeros_like


def main() -> None:
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    torch.set_num_threads(spec["threads"])
    report, served = {}, []
    for job in spec["jobs"]:
        serve, _ = serving.load_artifact(job["dir"], "cpu")
        inputs = torch.load(job["inputs"], weights_only=True)
        out = serve(*inputs)
        weight = serve.weights[job["control"]]
        original = weight.clone()
        weight.mul_(0.9)
        control = serve(*inputs)
        weight.copy_(original)
        torch.save({"out": out, "control": control}, job["result"])
        served.append((job["name"], serve, inputs))
    stub_kernels()
    for name, serve, inputs in served:
        for c in COUNTED:
            c.update(dict.fromkeys(c, 0))
        serve(*inputs)
        report[name] = {"launches": {k: v for c in COUNTED for k, v in c.items() if v}}
    report["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in
                               ("mtp_tpu_torch", "mtp_tpu", "jax", "flax"))
    print(json.dumps(report))


if __name__ == "__main__":
    main()
