"""Serving artifacts: `torch.export` programs of a recipe's predict, with the
weights apart (port of `mtp_tpu/serving.py`).

`cli/export.py` traces a recipe's predict function, weights as an input, into
one `ExportedProgram` a device; the port's forward kernels are registered
operators (`kernels/ops.py`), one node each in the program, so the served
program launches the same kernels as the live model.  This module rehydrates
an artifact with no model code: it imports the ops' registrations and the
store's reader, and nothing of `models/`, `heads/`, `tasks/` or `configs`.

Artifact layout (a directory):
    model.<device>.pt2  `torch.export.save` of predict(weights, *inputs), one
                        file a device the artifact serves on (`cuda`, `cpu`):
                        shape constructors in the predict paths fix the
                        device into the program
    weights.pt          the model's flat state dict, BatchNorm statistics
                        included (`ckpt/store.py` `save_state_dict`)
    meta.json           {recipe, task, num_classes, img_size, batch_size,
                         inputs [name, shape, dtype], outputs, platforms,
                         torch_version}
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Tuple

import torch

from mtp_tpu_torch.ckpt.store import load_variables, save_state_dict
from mtp_tpu_torch.kernels import ops as _registered  # noqa: F401  (torch.ops.mtp.*)


def program_path(art_dir: str, device: str) -> str:
    return os.path.join(art_dir, f"model.{torch.device(device).type}.pt2")


def save_artifact(out_dir: str, exported: Dict[str, torch.export.ExportedProgram],
                  weights: Dict[str, torch.Tensor], meta: Dict[str, Any]) -> None:
    """Write the artifact's files: `exported` maps each device type to its
    program, `weights` is the state dict the programs take first."""
    os.makedirs(out_dir, exist_ok=True)
    for device, program in exported.items():
        torch.export.save(program, program_path(out_dir, device))
    save_state_dict(os.path.join(out_dir, "weights.pt"), weights)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)


def load_artifact(art_dir: str, device: str = "cuda"
                  ) -> Tuple[Callable[..., Any], Dict[str, Any]]:
    """(serve_fn, meta): serve_fn(*inputs) runs the artifact's program for
    `device` (the card unless the caller asks for another) with the stored
    weights bound on it.  Inputs are tensors on `device` matching
    meta['inputs'] (batch and spatial dims are fixed at export time).
    `serve_fn.weights` is the bound state dict.  Raises FileNotFoundError
    when the artifact has no program for the device."""
    with open(os.path.join(art_dir, "meta.json")) as f:
        meta = json.load(f)
    path = program_path(art_dir, device)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{art_dir} has no program for {device}: it serves on "
                                f"{meta['platforms']}")
    program = torch.export.load(path).module()
    weights = {k: v.to(device) for k, v in
               load_variables(os.path.join(art_dir, "weights.pt")).items()}

    def serve(*inputs):
        return program(weights, *inputs)

    serve.weights = weights
    return serve, meta
