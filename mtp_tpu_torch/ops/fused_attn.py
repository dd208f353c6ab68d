"""Fused attention forwards: window attention (K1) and flash full attention
with the decomposed rel-pos bias (K2).

Port of the forward functions of `mtp_tpu/ops/pallas_attn.py`, with the JAX
signatures minus `interpret`.  Each public function runs its plain version
(`*_ref`, einsum + fp32 softmax) on CPU tensors and launches its CUDA kernel
(`csrc/window_attn_fwd.cu`, `csrc/flash_attn_fwd.cu`) on CUDA tensors.
Inference only: no backward yet.
"""

from __future__ import annotations

import torch

from mtp_tpu_torch.kernels import _build

LAUNCHES = {"window": 0, "flash": 0}

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
_FLASH_BQ = _FLASH_BK = 64  # query / key tile of csrc/flash_attn_fwd.cu


def window_smem_bytes(N: int, D: int) -> int:
    """Shared memory of one K1 block: fp32 q, k, v rows of D+1, N×N scores."""
    return (3 * N * (D + 1) + N * N) * 4


def flash_smem_bytes(D: int, Hk: int, Wk: int) -> int:
    """Shared memory of one K2 block (see csrc/flash_attn_fwd.cu)."""
    return ((2 * _FLASH_BQ + 2 * _FLASH_BK) * (D + 1)
            + _FLASH_BQ * (_FLASH_BK + 1) + _FLASH_BQ * (Hk + Wk)
            + 3 * _FLASH_BQ) * 4


def _check_qkv(q, k, v, ndim):
    if q.dim() != ndim or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share a {ndim}-d shape: "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"q, k, v must all be float32 or all bfloat16: "
                        f"{q.dtype} {k.dtype} {v.dtype}")


def _check_f32(**tensors):
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


# --------------------------------------------------------------------- K1 --

def fused_window_attention_ref(q, k, v, bias, scale: float) -> torch.Tensor:
    """Plain version of K1: fp32 einsum + softmax, output in q's dtype."""
    with torch.autocast(q.device.type, enabled=False):
        s = torch.einsum("whqd,whkd->whqk", q.float(), k.float()) * scale
        p = torch.softmax(s + bias, dim=-1)
        return torch.einsum("whqk,whkd->whqd", p, v.float()).to(q.dtype)


def fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(q·kᵀ·scale + bias)·v per (window, head).

    q/k/v (W, nH, N, D) fp32 or bf16; bias (W, nH, N, N) fp32 → (W, nH, N, D)
    in q's dtype."""
    _check_qkv(q, k, v, 4)
    W, nH, N, D = q.shape
    if bias.shape != (W, nH, N, N):
        raise ValueError(f"bias must be {(W, nH, N, N)}, got {tuple(bias.shape)}")
    _check_f32(bias=bias)
    if not _build.use_kernel(q, k, v, bias):
        return fused_window_attention_ref(q, k, v, bias, scale)
    if window_smem_bytes(N, D) > SMEM_LIMIT:
        raise ValueError(
            f"window attention with N={N}, D={D} needs "
            f"{window_smem_bytes(N, D)} B of shared memory, over the "
            f"{SMEM_LIMIT} B of one block (the q-blocked path for such "
            f"windows is not ported yet)")
    _build.check_launchable(q=q, k=k, v=v, bias=bias)
    out = torch.empty_like(q)
    _build.launch("mtp_window_attn_fwd", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), bias.data_ptr(), out.data_ptr(), W * nH, N, D,
                  float(scale), _build.dtype_code(q))
    LAUNCHES["window"] += 1
    return out


# --------------------------------------------------------------------- K2 --

def flash_full_attention_ref(q, k, v, rel_h, rel_w, grid_hw,
                             scale: float) -> torch.Tensor:
    """Plain version of K2: materialises the (BH, N, N) scores and bias."""
    BH, N, _ = q.shape
    Hk, Wk = grid_hw
    with torch.autocast(q.device.type, enabled=False):
        s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
        s = s.reshape(BH, N, Hk, Wk) + rel_h[..., :, None] + rel_w[..., None, :]
        p = torch.softmax(s.reshape(BH, N, N), dim=-1)
        return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         rel_h: torch.Tensor, rel_w: torch.Tensor,
                         grid_hw: tuple, scale: float) -> torch.Tensor:
    """Full attention with the decomposed rel-pos bias
    bias[q, k] = rel_h[q, k // Wk] + rel_w[q, k % Wk], never forming the
    (N, N) scores on the card.

    q/k/v (BH, N, D) fp32 or bf16; rel_h (BH, N, Hk), rel_w (BH, N, Wk) fp32;
    N = Hk·Wk → (BH, N, D) in q's dtype."""
    _check_qkv(q, k, v, 3)
    BH, N, D = q.shape
    Hk, Wk = grid_hw
    if Hk * Wk != N:
        raise ValueError(f"grid {grid_hw} does not hold N={N} keys")
    if rel_h.shape != (BH, N, Hk) or rel_w.shape != (BH, N, Wk):
        raise ValueError(f"rel_h/rel_w must be {(BH, N, Hk)}/{(BH, N, Wk)}, "
                         f"got {tuple(rel_h.shape)}/{tuple(rel_w.shape)}")
    _check_f32(rel_h=rel_h, rel_w=rel_w)
    if not _build.use_kernel(q, k, v, rel_h, rel_w):
        return flash_full_attention_ref(q, k, v, rel_h, rel_w, grid_hw, scale)
    if flash_smem_bytes(D, Hk, Wk) > SMEM_LIMIT:
        raise ValueError(f"flash attention with D={D}, grid {grid_hw} needs "
                         f"{flash_smem_bytes(D, Hk, Wk)} B of shared memory, "
                         f"over the {SMEM_LIMIT} B of one block")
    _build.check_launchable(q=q, k=k, v=v, rel_h=rel_h, rel_w=rel_w)
    out = torch.empty_like(q)
    _build.launch("mtp_flash_attn_fwd", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
                  out.data_ptr(), BH, N, D, Hk, Wk, float(scale),
                  _build.dtype_code(q))
    LAUNCHES["flash"] += 1
    return out
