"""The forward kernels as registered operators, `torch.ops.mtp.*`.

Each op's implementation is its wrapper's body (`ops/fused_attn.py`,
`ops/dcnv3_sample.py`, `ops/nms.py`, `ops/rotated_boxes.py`), one
implementation for every device: the body itself picks the plain version on
CPU tensors and launches the kernel on CUDA tensors (`_build.use_kernel`),
and only the body counts launches, so a program traced through an op counts
none while tracing and counts every launch when it runs.  Each op also has a
fake implementation, which checks its inputs as the body does (their
devices too: `use_kernel` raises on any but one CPU or CUDA device) and
gives the output shapes and dtypes, so that `torch.export` traces an op as one node and
a loaded program needs this module and no model code:

    mtp::window_attn_fwd        K1   (W, nH, N, D) → out
    mtp::window_attn_fwd_large  K1L  → (out, lse (W, nH, N))
    mtp::flash_attn_fwd         K2   (BH, N, D), rel_h, rel_w → (out, lse (BH, N))
    mtp::bilinear_sample_fwd    K3, and K8 at P = 9 → (BG, HWo, C)
    mtp::nms_keep               N1 (4 coordinates), R1's mask form with N1's scan
                                (5): boxes and scores in score order → keep (B, N)
    mtp::rbox_overlaps          R1, dense form → (..., N, M)

The ops are defined with `torch.library.Library` and a
CompositeExplicitAutograd implementation rather than `custom_op`, whose
Python dispatch costs about three times as much a call on the host (the
port's steps are host-bound).  The backward kernels are not ops: no exported
program runs a backward, and the `autograd.Function`s call the forward ops.

Every implementation looks its body up on the module at each call, so that a
patched body (the tests' stubbed launches) is the one the op runs.  Outputs
never alias inputs.
"""

from __future__ import annotations

import torch

from mtp_tpu_torch.kernels import _build
from mtp_tpu_torch.ops import dcnv3_sample, fused_attn, nms, rotated_boxes

LIB = torch.library.Library("mtp", "DEF")


def _float_out(t: torch.Tensor) -> torch.dtype:
    """The statistics' dtype: fp32, or float64 with float64 inputs (the
    plain versions on the CPU)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _define(schema: str, module, body: str, fake) -> None:
    """Defines mtp::<name> by `schema`, implemented by `module.<body>` on
    every device, with the fake implementation `fake`."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, lambda *args, **kwargs: getattr(module, body)(*args, **kwargs),
             "CompositeExplicitAutograd")
    torch.library.register_fake(f"mtp::{name}", fake, lib=LIB)


def _window_fake(q, k, v, bias, scale):
    fused_attn._check_window(q, k, v, bias)
    _build.use_kernel(q, k, v, bias)
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def _window_large_fake(q, k, v, bias, scale):
    fused_attn._check_window(q, k, v, bias)
    _build.use_kernel(q, k, v, bias)
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty(q.shape[:3], dtype=_float_out(q)))


def _flash_fake(q, k, v, rel_h, rel_w, grid_hw, scale):
    fused_attn._check_flash(q, k, v, rel_h, rel_w, tuple(grid_hw))
    _build.use_kernel(q, k, v, rel_h, rel_w)
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty(q.shape[:2], dtype=_float_out(q)))


def _sample_fake(img, py, px, m, H, W):
    dcnv3_sample._check(img, py, px, m, H, W)
    _build.use_kernel(img, py, px, m)
    return img.new_empty((img.shape[0], py.shape[1], img.shape[2]))


def _nms_keep_fake(boxes_o, scores_o, iou_thr):
    nms.check_keep_inputs(boxes_o, scores_o)
    _build.use_kernel(boxes_o, scores_o)
    return boxes_o.new_empty(boxes_o.shape[:2], dtype=torch.bool)


def _rbox_overlaps_fake(a, b, mode):
    rotated_boxes.check_mode(mode)
    _build.use_kernel(a, b)
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    return a.new_empty(lead + (a.shape[-2], b.shape[-2]))


_define("window_attn_fwd(Tensor q, Tensor k, Tensor v, Tensor bias, float scale) -> Tensor",
        fused_attn, "_window_fwd", _window_fake)
_define("window_attn_fwd_large(Tensor q, Tensor k, Tensor v, Tensor bias, float scale)"
        " -> (Tensor, Tensor)", fused_attn, "_window_large_fwd", _window_large_fake)
_define("flash_attn_fwd(Tensor q, Tensor k, Tensor v, Tensor rel_h, Tensor rel_w,"
        " int[] grid_hw, float scale) -> (Tensor, Tensor)",
        fused_attn, "_flash_fwd", _flash_fake)
_define("bilinear_sample_fwd(Tensor img, Tensor py, Tensor px, Tensor m, int H, int W)"
        " -> Tensor", dcnv3_sample, "_sample_fwd", _sample_fake)
_define("nms_keep(Tensor boxes, Tensor scores, float iou_thr) -> Tensor",
        nms, "keep_mask", _nms_keep_fake)
_define("rbox_overlaps(Tensor a, Tensor b, str mode) -> Tensor",
        rotated_boxes, "_rbox_overlaps", _rbox_overlaps_fake)
