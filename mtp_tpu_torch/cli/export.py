"""Export CLI: `python -m mtp_tpu_torch.cli.export <recipe> --ckpt ... --out dir/`.

The port's copy of `mtp_tpu/cli/export.py`: traces the recipe's predict
function, the weights an input of it, by `torch.export` into a serving
artifact (see `mtp_tpu_torch/serving.py`) that
`mtp_tpu_torch.serving.load_artifact` rehydrates with no model code.  The
forward kernels are registered ops (`kernels/ops.py`), so the program runs
the same kernels as the live model.  `--platforms` names the devices the
artifact serves on, `cuda` (the default) and `cpu`: one program a device.

Per task family the exported signature is:
    classification     predict(weights, images)        → logits (B, C)
    segmentation       predict(weights, images)        → class map (B, H, W)
                       (slide protocol traced in when the recipe has one)
    change_detection   predict(weights, a, b)          → change map (B, H, W)
    detection_*        predict(weights, images)        → dict(boxes, scores,
                       labels, valid[, mask_logits])   (fixed-shape, padded)
Images are NHWC float32 (B, S, S, 3).  Each program computes what the task's
`evaluate` computes: eval mode, no gradient, the task's autocast (bf16 on the
card for the bf16 recipes).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch._C import DispatchKey

PLATFORMS = ("cuda", "cpu")


class Predict(nn.Module):
    """The traced function's body: `run` (the task's predict) over the
    task's model, under the task's autocast on the inputs' device.  Its
    state dict is the model's under the prefix `model.`."""

    def __init__(self, task, run: Callable):
        super().__init__()
        self.model = task.model
        self.run = run
        self.autocast = task.autocast

    def forward(self, *inputs):
        with self.autocast(inputs[0].device.type):
            return self.run(*inputs)


class Program(nn.Module):
    """predict(weights, *inputs): `Predict` called through
    `torch.func.functional_call` with `weights`, the model's state dict, so
    that the weights are an input of the exported program and not constants
    of it.  `Predict` is held in a closure, not as a submodule, so the
    program lifts none of its parameters."""

    def __init__(self, predict: Predict):
        super().__init__()
        self.call = lambda weights, inputs: torch.func.functional_call(
            predict, {f"model.{k}": w for k, w in weights.items()}, inputs)

    def forward(self, weights: Dict[str, torch.Tensor], *inputs):
        return self.call(weights, inputs)


def build_export_fn(task, cfg, tile_size: Optional[int] = None
                    ) -> Tuple[Predict, List[tuple], str]:
    """(Predict module, input specs [(name, (None, S, S, 3), dtype)], output
    note) of the task's family; S is `cfg.backbone.img_size`, or for a
    segmentation recipe with a slide protocol `tile_size`, the tiles its
    crops cover.  Detection outputs are a plain dict, so that loading needs
    no custom types."""
    S = cfg.backbone.img_size
    if tile_size is not None:
        if cfg.task != "segmentation" or cfg.slide is None or tile_size < cfg.slide.crop:
            raise SystemExit(f"--tile-size takes a segmentation recipe with a slide "
                             f"protocol and tiles of at least its crop; {cfg.task}, "
                             f"slide {cfg.slide}, tile {tile_size}")
        S = tile_size
    images = [("images", (None, S, S, 3), "float32")]
    if cfg.task == "classification":
        return Predict(task, lambda x: task.model(x)), images, "logits (B, num_classes)"
    if cfg.task == "segmentation":
        return (Predict(task, task.predict_fn()), images,
                "per-pixel class map (B, H, W) int64")
    if cfg.task == "change_detection":
        return (Predict(task, task.predict_fn()),
                [("image_a", (None, S, S, 3), "float32"),
                 ("image_b", (None, S, S, 3), "float32")],
                "per-pixel change map (B, H, W) int64")
    if cfg.task in ("detection_h", "detection_r", "instseg"):
        inner = task.predict_fn()

        def detections(images: torch.Tensor) -> Dict[str, torch.Tensor]:
            dets = inner(images)
            d = {"boxes": dets.boxes, "scores": dets.scores,
                 "labels": dets.labels, "valid": dets.valid}
            if dets.mask_logits is not None:
                d["mask_logits"] = dets.mask_logits
            return d

        return Predict(task, detections), images, "dict of fixed-shape padded detections"
    raise SystemExit(f"task {cfg.task} has no export path "
                     "(multitask: export the encoder + per-task heads "
                     "via the finetune recipes)")


def example_inputs(inputs: List[tuple], batch_size: int, device) -> List[torch.Tensor]:
    return [torch.zeros((batch_size,) + tuple(shape[1:]), dtype=getattr(torch, dtype),
                        device=device) for _, shape, dtype in inputs]


# ATen ops that the ATen-level trace would decompose but eager mode runs
# whole: PyTorch registers Python decompositions for them on the Autograd
# and CompositeImplicitAutograd keys, which only its tracers use.  Traced
# through those, F.interpolate's bilinear resize becomes index arithmetic
# (and misses CUDA autocast's fp32 rule for it) and cuDNN's batch norm the
# native one, each rounding otherwise than the live model's kernel; the bf16
# convolutions after them carry the difference to whole logits.  Kept whole,
# the program calls the live model's kernels.
KEPT_WHOLE = (("upsample_bilinear2d", "vec"), ("upsample_bilinear2d", "default"),
              ("cudnn_batch_norm", "default"))


@contextlib.contextmanager
def kernels_kept_whole():
    """Within: the ops of KEPT_WHOLE without their tracing decompositions."""
    keys = (DispatchKey.Autograd, DispatchKey.CompositeImplicitAutograd)
    ops = [getattr(getattr(torch.ops.aten, name), overload) for name, overload in KEPT_WHOLE]
    saved = [{k: op.py_kernels.pop(k) for k in keys if k in op.py_kernels} for op in ops]
    for op in ops:
        op._dispatch_cache.clear()
    try:
        yield
    finally:
        for op, kernels in zip(ops, saved):
            op.py_kernels.update(kernels)
            op._dispatch_cache.clear()


def export_program(task, predict: Predict, inputs: List[tuple], batch_size: int,
                   device: str) -> torch.export.ExportedProgram:
    """The program of `predict` for `device`, traced from the task's model
    (moved there) in eval mode under no_grad, at the ATen level: autocast
    applies its casts while the trace runs, so the program holds them as
    plain casts.  (`torch.export.export` traces before dispatch and keeps
    each autocast region as a `wrap_with_autocast` submodule, which
    PyTorch 2.11 refuses to load back, and whose passes take time that
    grows faster than the regions.)"""
    from torch.export._trace import _export

    model = task.model.to(device).eval()
    example = example_inputs(inputs, batch_size, device)
    if hasattr(task, "anchors_on"):
        # the anchor cache is filled outside the trace, whose tensors are fake,
        # under the key the inputs' device gives (cuda:0, not cuda)
        task.anchors_on(tuple(example[0].shape[1:3]), example[0].device)
    weights = dict(model.state_dict())
    with torch.no_grad(), kernels_kept_whole():
        program = _export(Program(predict), (weights, *example), strict=False,
                          pre_dispatch=False)
    program.example_inputs = None  # they hold the weights: a second copy in the file
    return program


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("recipe")
    p.add_argument("--out", required=True, help="artifact directory")
    p.add_argument("--ckpt", default=None,
                   help="the port's checkpoint dir, variables or encoder file, or a "
                        "JAX .npz (as cli.test)")
    p.add_argument("--batch-size", type=int, default=1,
                   help="serving batch size baked into the program")
    p.add_argument("--img-size", type=int, default=None)
    p.add_argument("--platforms", default="cuda",
                   help="comma list of the devices the artifact serves on: cuda, cpu "
                        "(one program each; the first builds the model)")
    p.add_argument("--det-overrides", default=None)
    p.add_argument("--tile-size", type=int, default=None,
                   help="segmentation with a slide protocol: the served tiles' size, "
                        "covered by the recipe's crops (default: img_size, one crop)")
    args = p.parse_args(argv)

    from mtp_tpu_torch import configs
    from mtp_tpu_torch.cli.train import build_task, init_or_restore, shrink_recipe
    from mtp_tpu_torch.serving import save_artifact

    platforms = [d.strip() for d in args.platforms.split(",")]
    unknown = sorted(set(platforms) - set(PLATFORMS))
    if unknown:
        raise SystemExit(f"--platforms {unknown}: the port serves on {list(PLATFORMS)}")
    recipe = shrink_recipe(configs.get(args.recipe), args.img_size)
    det_overrides = (json.loads(args.det_overrides)
                     if args.det_overrides else None)
    task, cfg = build_task(recipe, 1, 1, det_overrides, device=platforms[0])
    state = init_or_restore(task, args.ckpt)

    predict, inputs, out_desc = build_export_fn(task, cfg, args.tile_size)
    B = args.batch_size
    exported = {d: export_program(task, predict, inputs, B, d) for d in platforms}
    task.model.to(task.device)
    meta = {
        "recipe": recipe.name, "task": cfg.task,
        "num_classes": cfg.num_classes,
        "img_size": cfg.backbone.img_size, "batch_size": B,
        "inputs": [{"name": n, "shape": [B] + list(s[1:]), "dtype": d}
                   for n, s, d in inputs],
        "outputs": out_desc,
        "platforms": platforms,
        "torch_version": torch.__version__,
    }
    save_artifact(args.out, exported, state.model.state_dict(), meta)
    print(json.dumps({"out": args.out, "platforms": meta["platforms"],
                      "inputs": meta["inputs"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
