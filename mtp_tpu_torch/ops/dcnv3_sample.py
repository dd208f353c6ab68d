"""Bilinear multi-tap sampling with zero padding: forward (kernel K3) and
backward (kernel K6).

Port of `mtp_tpu/ops/dcnv3_pallas.py` `dcnv3_sample`: per (image·group,
output pixel) the sum over P taps of mask × bilinear sample of the map at
absolute pixel coordinates, corners off the map contributing zero.  On the
TPU this was a one-hot matrix product built in VMEM; here it is one gather
kernel (`csrc/bilinear_sample_fwd.cu`) and one scatter/reduce kernel for the
gradients (`csrc/bilinear_sample_bwd.cu`), each with the bodies that
`sample_body` picks between (`csrc/sample_body.cuh`).  `dcnv3_sample` is a
`torch.autograd.Function` whose forward calls the registered op
`torch.ops.mtp.bilinear_sample_fwd` (`kernels/ops.py`: `_sample_fwd`, one
node in an exported program), differentiable in img, py, px and m, with the
JAX package's subgradient at integer coordinates (`_coord_grads`).  The
plain versions also take float64 and compute in it (`ops/precision.py`).
"""

from __future__ import annotations

import torch

from mtp_tpu_torch.kernels import _build
from mtp_tpu_torch.ops.precision import at_least_fp32, plain_float64

LAUNCHES = {"bilinear_sample": 0, "bilinear_sample_bwd": 0}

# The limits of the kernels' bodies, those of csrc/sample_body.cuh (a CPU
# test holds them equal): a vector thread owns VEC_BYTES of one pixel's
# channels, a pixel at most MAX_RUN_THREADS such threads (a power of two),
# a vector body at most MAX_TAPS taps; FWD_THREADS / BWD_THREADS threads a
# vector block, TILED_THREADS a tiled backward's image-gradient block; the tiled backward's TILE² output pixels, whose block owns the
# image gradient of the map pixels within HALO of them, within SMEM_LIMIT
# bytes of shared memory.
VEC_BYTES = 16
MAX_RUN_THREADS = 32
MAX_TAPS = 32
FWD_THREADS = 128
BWD_THREADS = 256
TILED_THREADS = 512
TILE = 16
HALO = 8
SMEM_LIMIT = 232448
# the C entry points' body codes (csrc/sample_body.cuh Body)
BODIES = {"scalar": 0, "vector": 1, "tiled": 2}
# tap counts the vector bodies unroll (others loop)
UNROLLED_TAPS = (1, 9)


def run_threads(C: int, dtype: torch.dtype) -> int:
    """Threads per pixel of the vector bodies, each one VEC_BYTES run of the
    pixel's channels (8 bf16 or 4 fp32); 0 unless C·itemsize is VEC_BYTES
    times a power of two up to MAX_RUN_THREADS."""
    nbytes = C * (2 if dtype == torch.bfloat16 else 4)
    if C <= 0 or nbytes % VEC_BYTES:
        return 0
    runs = nbytes // VEC_BYTES
    return runs if runs & (runs - 1) == 0 and runs <= MAX_RUN_THREADS else 0


def sample_smem_bytes(body: str, C: int, P: int, dtype: torch.dtype,
                      bwd: bool) -> int:
    """Shared memory of a block of `body`.  Vector: the staged py, px, m
    (and, in the backward, dpy, dpx, dm) of its pixels, fp32.  Tiled (P =
    9): those of its TILE² pixels, g's rows as fp32, its lists (an fp32
    weight and a 2-byte pixel per tap corner), and the list offsets and
    cursors of its (TILE + 2·HALO)² region pixels and the scan's warp
    totals (int32)."""
    runs = run_threads(C, dtype)
    if body == "scalar" or not runs:
        return 0
    if body == "tiled":
        pixels, cells = TILE * TILE, (TILE + 2 * HALO) ** 2
        return (4 * (pixels * 9 * 3 + pixels * C + pixels * 9 * 4)
                + 4 * (2 * cells + 1 + TILED_THREADS // 32) + 2 * pixels * 9 * 4)
    threads = BWD_THREADS if bwd else FWD_THREADS
    return threads // runs * P * (6 if bwd else 3) * 4


def sample_body(C: int, P: int, dtype: torch.dtype, aligned: bool, *,
                bwd: bool = False, same_grid: bool = False) -> str:
    """The body K3 (or K6, with bwd) runs for C channels of `dtype`, P taps
    and storage `aligned` to 16 bytes, where `same_grid` says that the
    output pixels are the map's (HWo = H·W):
    - "scalar" unless the storage is aligned, C is whole 16-byte runs of a
      power-of-two count (`run_threads`) and P <= MAX_TAPS;
    - "tiled" for the backward at P = 9 on the map's own grid (every DCNv3
      layer) when its block fits SMEM_LIMIT;
    - "vector" otherwise.
    The C entry points apply the same rule (`smp::body`) and run the body
    the wrapper names only if it is this one or "scalar"."""
    if not aligned or not run_threads(C, dtype) or not 1 <= P <= MAX_TAPS:
        return "scalar"
    if (bwd and P == 9 and same_grid
            and sample_smem_bytes("tiled", C, P, dtype, True) <= SMEM_LIMIT):
        return "tiled"
    return "vector"


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % VEC_BYTES == 0 for t in tensors)


def out_of_halo_share(py: torch.Tensor, px: torch.Tensor, m: torch.Tensor,
                      H: int, W: int) -> float:
    """The share of K6's image-gradient adds that the tiled body sends to
    device memory directly, on these inputs (output grid = the H×W map):
    of the corners it adds (a counted tap's in-map corners of nonzero
    weight m·wy·wx), those outside the region of their output pixel's
    TILE² tile, the map pixels within HALO of it."""
    HWo = py.shape[1]
    if HWo != H * W:
        raise ValueError(f"the tiled body takes the map's own grid, got HWo "
                         f"{HWo} for a {H}×{W} map")
    pix = torch.arange(HWo, device=py.device)[None, :, None]
    ty0 = pix // W // TILE * TILE - HALO
    tx0 = pix % W // TILE * TILE - HALO
    tap = (py >= -1) & (py < H) & (px >= -1) & (px < W)
    y0, x0 = torch.floor(py), torch.floor(px)
    fy, fx = py - y0, px - x0
    added = outside = 0
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            yy, xx = y0 + dy, x0 + dx
            adds = (tap & (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
                    & (m * wy * wx != 0))
            inside = ((yy - ty0 >= 0) & (yy - ty0 < TILE + 2 * HALO)
                      & (xx - tx0 >= 0) & (xx - tx0 < TILE + 2 * HALO))
            added += int(adds.sum())
            outside += int((adds & ~inside).sum())
    return outside / added if added else 0.0


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
    """K3, the body of the op mtp::bilinear_sample_fwd: CPU tensors run
    `dcnv3_sample_ref`, CUDA tensors launch the kernel in the body
    `sample_body` picks."""
    _check(img, py, px, m, H, W)
    if not _build.use_kernel(img, py, px, m):
        return dcnv3_sample_ref(img, py, px, m, H, W)
    _build.check_launchable(img=img, py=py, px=px, m=m)
    BG, _, C = img.shape
    _, HWo, P = py.shape
    out = torch.empty(BG, HWo, C, dtype=img.dtype, device=img.device)
    body = sample_body(C, P, img.dtype, _aligned(img, out))
    _build.launch("mtp_bilinear_sample_fwd", img.data_ptr(), py.data_ptr(),
                  px.data_ptr(), m.data_ptr(), out.data_ptr(), BG, H, W, C,
                  HWo, P, BODIES[body], _build.dtype_code(img))
    LAUNCHES["bilinear_sample"] += 1
    return out


def dcnv3_sample_bwd(img: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
                     m: torch.Tensor, g: torch.Tensor, H: int, W: int):
    """Gradients of `dcnv3_sample` for the output cotangent g (BG, HWo, C)
    in img's dtype → (dimg in img's dtype, dpy, dpx, dm fp32).

    CPU tensors run `dcnv3_sample_bwd_ref`; CUDA tensors launch the K6
    kernel in the body `sample_body` picks.  K6 adds the image gradient
    with fp32 atomics (into shared memory, then device memory, in the tiled
    body), so the wrapper zeroes an fp32 dimg buffer for it and casts the
    sums to img's dtype after (for bf16 a second pass over dimg); the sums
    depend on the order the adds land in, in the last bits of fp32."""
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
    body = sample_body(C, P, img.dtype, _aligned(img, g, dimg), bwd=True,
                       same_grid=HWo == H * W)
    _build.launch("mtp_bilinear_sample_bwd", img.data_ptr(), py.data_ptr(),
                  px.data_ptr(), m.data_ptr(), g.data_ptr(), dimg.data_ptr(),
                  dpy.data_ptr(), dpx.data_ptr(), dm.data_ptr(), BG, H, W, C,
                  HWo, P, BODIES[body], _build.dtype_code(img))
    LAUNCHES["bilinear_sample_bwd"] += 1
    return dimg.to(img.dtype), dpy, dpx, dm


class _Sample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, py, px, m, H, W):
        ctx.hw = (H, W)
        ctx.save_for_backward(img, py, px, m)
        return torch.ops.mtp.bilinear_sample_fwd.default(img, py, px, m, H, W)

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
