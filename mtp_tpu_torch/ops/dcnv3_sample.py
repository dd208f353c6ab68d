"""Bilinear multi-tap sampling with zero padding, forward (kernel K3).

Port of `mtp_tpu/ops/dcnv3_pallas.py` `dcnv3_sample`: per (image·group,
output pixel) the sum over P taps of mask × bilinear sample of the map at
absolute pixel coordinates, corners off the map contributing zero.  On the
TPU this was a one-hot matrix product built in VMEM; here it is one gather
kernel (`csrc/bilinear_sample_fwd.cu`).  Inference only: no backward yet.
"""

from __future__ import annotations

import torch

from mtp_tpu_torch.kernels import _build

LAUNCHES = {"bilinear_sample": 0}


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
    if img.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"img must be float32 or bfloat16, got {img.dtype}")
    for name, t in (("py", py), ("px", px), ("m", m)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def dcnv3_sample_ref(img: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
                     m: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Plain version: 4 corner gathers per tap, zero weight off the map,
    times m, summed over P; fp32 math, output in img's dtype."""
    BG, _, C = img.shape
    _, HWo, P = py.shape
    flat = img.float()
    y0, x0 = torch.floor(py), torch.floor(px)
    fy, fx = py - y0, px - x0
    out = torch.zeros(BG, HWo, C, dtype=torch.float32, device=img.device)
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            yc, xc = y0 + dy, x0 + dx
            valid = (yc >= 0) & (yc <= H - 1) & (xc >= 0) & (xc <= W - 1)
            w = torch.where(valid, wy * wx * m, torch.zeros_like(m))
            lin = (yc.clamp(0, H - 1) * W + xc.clamp(0, W - 1)).long()
            vals = torch.gather(flat, 1, lin.reshape(BG, HWo * P, 1)
                                .expand(BG, HWo * P, C))
            out += (vals.reshape(BG, HWo, P, C) * w[..., None]).sum(2)
    return out.to(img.dtype)


def dcnv3_sample(img: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
                 m: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """img (BG, H*W, C); py/px/m (BG, HWo, P) fp32, with py/px absolute pixel
    coordinates on the unpadded map → (BG, HWo, C) in img's dtype.

    CPU tensors run `dcnv3_sample_ref`; CUDA tensors launch the K3 kernel."""
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
