"""Relative position biases for attention (port of `mtp_tpu/ops/rel_pos.py`).

Two schemes, both used by the reference backbone:

1. Decomposed spatial relative position (MViT-style): per-axis tables
   indexed by coordinate distance, contracted against q.
2. Swin-style pairwise bias table indexed by a relative-position index.

Index arrays are computed with numpy (shapes are static).  Every bias is
built in fp32 with autocast off, as the JAX package builds it in fp32.
"""

from __future__ import annotations

import numpy as np
import torch

from mtp_tpu_torch.ops.precision import at_least_fp32


def _index(idx, device) -> torch.Tensor:
    """numpy index array or long tensor → long tensor on `device` (no copy
    when it is already there)."""
    return torch.as_tensor(idx, dtype=torch.long, device=device)


def rel_pos_indices(q_size: int, k_size: int) -> np.ndarray:
    """Distance index matrix (q_size, k_size) into a (q_size+k_size-1, C) table.

    Handles q/k resolution mismatch by the reference's ratio scaling (only
    hit when q_size != k_size)."""
    q_ratio = max(k_size / q_size, 1.0)
    k_ratio = max(q_size / k_size, 1.0)
    dist = (np.arange(q_size)[:, None] * q_ratio
            - np.arange(k_size)[None, :] * k_ratio)
    dist += (k_size - 1) * k_ratio
    return dist.astype(np.int64)


def decomposed_rel_pos_factors(q: torch.Tensor, q_shape: tuple[int, int],
                               k_shape: tuple[int, int],
                               rel_pos_h: torch.Tensor,
                               rel_pos_w: torch.Tensor):
    """The two per-axis factors of the decomposed bias, without forming the
    (N, N) bias: rel_h (..., q_h*q_w, k_h), rel_w (..., q_h*q_w, k_w), fp32.
    bias[q, k] = rel_h[q, ky] + rel_w[q, kx] with k = ky*k_w + kx — the
    contract consumed by `fused_attn.flash_full_attention`."""
    q_h, q_w = q_shape
    k_h, k_w = k_shape
    with torch.autocast(q.device.type, enabled=False):
        Rh = at_least_fp32(rel_pos_h)[_index(rel_pos_indices(q_h, k_h), q.device)]
        Rw = at_least_fp32(rel_pos_w)[_index(rel_pos_indices(q_w, k_w), q.device)]
        lead = q.shape[:-2]
        r_q = at_least_fp32(q).reshape(lead + (q_h, q_w, q.shape[-1]))
        rel_h = torch.einsum("...hwc,hkc->...hwk", r_q, Rh)
        rel_w = torch.einsum("...hwc,wkc->...hwk", r_q, Rw)
    n = q_h * q_w
    return rel_h.reshape(lead + (n, k_h)), rel_w.reshape(lead + (n, k_w))


def decomposed_rel_pos_bias(q: torch.Tensor, q_shape: tuple[int, int],
                            k_shape: tuple[int, int], rel_pos_h: torch.Tensor,
                            rel_pos_w: torch.Tensor) -> torch.Tensor:
    """The decomposed bias alone: (..., q_h*q_w, k_h*k_w) fp32, for kernels
    that take a precomputed bias."""
    q_h, q_w = q_shape
    k_h, k_w = k_shape
    rel_h, rel_w = decomposed_rel_pos_factors(q, q_shape, k_shape,
                                              rel_pos_h, rel_pos_w)
    lead = q.shape[:-2]
    rel_h = rel_h.reshape(lead + (q_h, q_w, k_h))
    rel_w = rel_w.reshape(lead + (q_h, q_w, k_w))
    bias = rel_h[..., :, :, :, None] + rel_w[..., :, :, None, :]
    return bias.reshape(lead + (q_h * q_w, k_h * k_w))


def add_decomposed_rel_pos(attn: torch.Tensor, q: torch.Tensor,
                           q_shape: tuple[int, int], k_shape: tuple[int, int],
                           rel_pos_h: torch.Tensor,
                           rel_pos_w: torch.Tensor) -> torch.Tensor:
    """attn (..., q_h*q_w, k_h*k_w) + the decomposed bias computed from q
    (..., q_h*q_w, head_dim), in fp32."""
    bias = decomposed_rel_pos_bias(q, q_shape, k_shape, rel_pos_h, rel_pos_w)
    return at_least_fp32(attn) + bias


def swin_rel_pos_index(q_ws: int, k_ws: int) -> np.ndarray:
    """Pairwise relative-position index (k_ws², k_ws²) into a
    ((2*k_ws-1)², nH) bias table (the reference builds it with attn_ws for
    both sides; q_ws == k_ws == 7 in all shipped configs)."""
    coords = np.stack(np.meshgrid(np.arange(k_ws), np.arange(k_ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += k_ws - 1
    rel[:, :, 1] += k_ws - 1
    rel[:, :, 0] *= 2 * k_ws - 1
    return rel.sum(-1)


def swin_rel_pos_bias(table: torch.Tensor, index) -> torch.Tensor:
    """table ((2ws-1)², nH), index (N, N) (numpy or long tensor) → bias
    (nH, N, N)."""
    n, _ = index.shape
    bias = table[_index(index.reshape(-1), table.device)].reshape(n, n, -1)
    return bias.permute(2, 0, 1)
