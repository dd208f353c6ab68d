"""Bilinear multi-tap sampling with zero padding: forward (kernel K3) and
backward (kernel K6).

Port of `mtp_tpu/ops/dcnv3_pallas.py` `dcnv3_sample`: per (image·group,
output pixel) the sum over P taps of mask × bilinear sample of the map at
absolute pixel coordinates, corners off the map contributing zero.  On the
TPU this was a one-hot matrix product built in VMEM; here it is one gather
kernel (`csrc/bilinear_sample_fwd.cu`) and one scatter/reduce kernel for the
gradients (`csrc/bilinear_sample_bwd.cu`).  `dcnv3_sample` is a
`torch.autograd.Function`, differentiable in img, py, px and m, with the
JAX package's subgradient at integer coordinates (`_coord_grads`).  The
plain versions also take float64 and compute in it (`ops/precision.py`).
"""

from __future__ import annotations

import torch

from mtp_tpu_torch.kernels import _build
from mtp_tpu_torch.ops.precision import at_least_fp32, plain_float64

LAUNCHES = {"bilinear_sample": 0, "bilinear_sample_bwd": 0}


def _check(img, py, px, m, H, W):
    if img.dim() != 3 or py.dim() != 3:
        raise ValueError(f"img (BG, H*W, C) and py/px/m (BG, HWo, P) expected, "
                         f"got {tuple(img.shape)} and {tuple(py.shape)}")
    BG, HW, _ = img.shape
    if HW != H * W:
        raise ValueError(f"img has {HW} pixels, H*W = {H * W}")
    if px.shape != py.shape or m.shape != py.shape or py.shape[0] != BG:
        raise ValueError(f"py/px/m must share shape (BG={BG}, HWo, P): "
                         f"{tuple(py.shape)} {tuple(px.shape)} {tuple(m.shape)}")
    if not (img.dtype in _build.DTYPE_CODES or plain_float64(img)):
        raise TypeError(f"img must be float32 or bfloat16 (or float64 on the "
                        f"CPU), got {img.dtype}")
    want = torch.float64 if img.dtype == torch.float64 else torch.float32
    for name, t in (("py", py), ("px", px), ("m", m)):
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")


def _corners(py, px, H, W):
    """The 4 bilinear corners of every tap: (flat pixel index, in-map flag,
    row weight, column weight, d(row weight)/dpy, d(col weight)/dpx).  The
    weight derivatives are grid_sample's floor/frac rule, which is the JAX
    package's subgradient at integer coordinates."""
    y0, x0 = torch.floor(py), torch.floor(px)
    fy, fx = py - y0, px - x0
    for dy, wy, dwy in ((0, 1.0 - fy, -1.0), (1, fy, 1.0)):
        for dx, wx, dwx in ((0, 1.0 - fx, -1.0), (1, fx, 1.0)):
            yc, xc = y0 + dy, x0 + dx
            valid = (yc >= 0) & (yc <= H - 1) & (xc >= 0) & (xc <= W - 1)
            lin = (yc.clamp(0, H - 1) * W + xc.clamp(0, W - 1)).long()
            yield lin, valid, wy, wx, dwy, dwx


def _gather(flat, lin):
    """flat (BG, HW, C), lin (BG, HWo, P) → (BG, HWo, P, C)."""
    BG, HWo, P = lin.shape
    C = flat.shape[-1]
    idx = lin.reshape(BG, HWo * P, 1).expand(BG, HWo * P, C)
    return torch.gather(flat, 1, idx).reshape(BG, HWo, P, C)


def dcnv3_sample_ref(img: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
                     m: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Plain version of K3: 4 corner gathers per tap, zero weight off the
    map, times m, summed over P; fp32 math, output in img's dtype."""
    BG, _, C = img.shape
    _, HWo, P = py.shape
    flat = at_least_fp32(img)
    out = torch.zeros(BG, HWo, C, dtype=flat.dtype, device=img.device)
    for lin, valid, wy, wx, _, _ in _corners(py, px, H, W):
        w = torch.where(valid, wy * wx * m, torch.zeros_like(m))
        out += (_gather(flat, lin) * w[..., None]).sum(2)
    return out.to(img.dtype)


def dcnv3_sample_bwd_ref(img: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
                         m: torch.Tensor, g: torch.Tensor, H: int, W: int):
    """Plain version of K6, the explicit VJP of `dcnv3_sample_ref` for the
    output cotangent g (BG, HWo, C).  With a = <g[p], img[corner]> per tap
    and in-map corner:
        dimg[corner] += m·wy·wx·g[p],   dm = Σ wy·wx·a,
        dpy = m·Σ dwy·wx·a,              dpx = m·Σ wy·dwx·a,
    corners off the map contributing nothing.  Returns dimg in img's dtype
    and dpy, dpx, dm fp32."""
    BG, HW, C = img.shape
    _, HWo, P = py.shape
    flat, gf = at_least_fp32(img), at_least_fp32(g)[:, :, None, :]
    dimg = torch.zeros(BG, HW, C, dtype=flat.dtype, device=img.device)
    dpy, dpx, dm = (torch.zeros_like(py) for _ in range(3))
    zero = torch.zeros_like(m)
    for lin, valid, wy, wx, dwy, dwx in _corners(py, px, H, W):
        a = torch.where(valid, (_gather(flat, lin) * gf).sum(-1), zero)
        dm += wy * wx * a
        dpy += m * dwy * wx * a
        dpx += m * wy * dwx * a
        w = torch.where(valid, m * wy * wx, zero)
        dimg.scatter_add_(1, lin.reshape(BG, HWo * P, 1).expand(BG, HWo * P, C),
                          (w[..., None] * gf).reshape(BG, HWo * P, C))
    return dimg.to(img.dtype), dpy, dpx, dm


def _sample_fwd(img, py, px, m, H, W):
    _check(img, py, px, m, H, W)
    if not _build.use_kernel(img, py, px, m):
        return dcnv3_sample_ref(img, py, px, m, H, W)
    _build.check_launchable(img=img, py=py, px=px, m=m)
    BG, _, C = img.shape
    _, HWo, P = py.shape
    out = torch.empty(BG, HWo, C, dtype=img.dtype, device=img.device)
    _build.launch("mtp_bilinear_sample_fwd", img.data_ptr(), py.data_ptr(),
                  px.data_ptr(), m.data_ptr(), out.data_ptr(), BG, H, W, C,
                  HWo, P, _build.dtype_code(img))
    LAUNCHES["bilinear_sample"] += 1
    return out


def dcnv3_sample_bwd(img: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
                     m: torch.Tensor, g: torch.Tensor, H: int, W: int):
    """Gradients of `dcnv3_sample` for the output cotangent g (BG, HWo, C)
    in img's dtype → (dimg in img's dtype, dpy, dpx, dm fp32).

    CPU tensors run `dcnv3_sample_bwd_ref`; CUDA tensors launch the K6
    kernel, which adds into dimg with fp32 atomics (order-dependent in the
    last bits of fp32, then rounded to img's dtype)."""
    _check(img, py, px, m, H, W)
    BG, HW, C = img.shape
    _, HWo, P = py.shape
    if g.shape != (BG, HWo, C) or g.dtype != img.dtype:
        raise ValueError(f"g must be {(BG, HWo, C)} {img.dtype}, got "
                         f"{tuple(g.shape)} {g.dtype}")
    if not _build.use_kernel(img, py, px, m, g):
        return dcnv3_sample_bwd_ref(img, py, px, m, g, H, W)
    _build.check_launchable(img=img, py=py, px=px, m=m, g=g)
    dimg = torch.zeros(BG, HW, C, dtype=torch.float32, device=img.device)
    dpy, dpx, dm = (torch.empty_like(py) for _ in range(3))
    _build.launch("mtp_bilinear_sample_bwd", img.data_ptr(), py.data_ptr(),
                  px.data_ptr(), m.data_ptr(), g.data_ptr(), dimg.data_ptr(),
                  dpy.data_ptr(), dpx.data_ptr(), dm.data_ptr(), BG, H, W, C,
                  HWo, P, _build.dtype_code(img))
    LAUNCHES["bilinear_sample_bwd"] += 1
    return dimg.to(img.dtype), dpy, dpx, dm


class _Sample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, py, px, m, H, W):
        ctx.hw = (H, W)
        ctx.save_for_backward(img, py, px, m)
        return _sample_fwd(img, py, px, m, H, W)

    @staticmethod
    def backward(ctx, g):
        img, py, px, m = ctx.saved_tensors
        grads = dcnv3_sample_bwd(img, py, px, m, g.to(img.dtype).contiguous(),
                                 *ctx.hw)
        return (*grads, None, None)


def dcnv3_sample(img: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
                 m: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """img (BG, H*W, C); py/px/m (BG, HWo, P) fp32, with py/px absolute pixel
    coordinates on the unpadded map → (BG, HWo, C) in img's dtype.

    CPU tensors run `dcnv3_sample_ref`; CUDA tensors launch the K3 kernel
    (and K6 in the backward)."""
    return _Sample.apply(img, py, px, m, H, W)
