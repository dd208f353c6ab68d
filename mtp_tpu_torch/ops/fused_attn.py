"""Fused attention: window attention (K1 forward, K4 backward; K1L and K7
for windows too large for them) and flash full attention with the
decomposed rel-pos bias (K2 forward, K5 backward).

Port of `mtp_tpu/ops/pallas_attn.py`, with the JAX signatures minus
`interpret`.  `fused_window_attention` and `flash_full_attention` are
`torch.autograd.Function`s, as the JAX functions are `custom_vjp`s, whose
forwards call the registered ops `torch.ops.mtp.window_attn_fwd`,
`window_attn_fwd_large` and `flash_attn_fwd` (`kernels/ops.py`: the bodies
below, one node each in an exported program).  Every
kernel wrapper runs its plain version (`*_ref`: einsum + fp32 softmax, and
the explicit VJPs `*_bwd_ref`) on CPU tensors and launches a CUDA kernel on
CUDA tensors.  The plain versions also take float64 and compute in it
(`ops/precision.py`).

Window attention routes by shape alone (`window_fwd_route`,
`window_bwd_route`), never by a caught error, and in pairs:
- backward: K7 (`csrc/window_attn_bwd_qblk.cu`) wherever JAX takes its
  q-blocked kernel (`_fused_backward`: pack 1 and round_up(N, 8) > 512),
  and also in JAX's one-shot range wherever K4's one-block layout does not
  fit shared memory (117 < N <= 512 at D = 64); K4
  (`csrc/window_attn_bwd.cu`) everywhere else.
- forward: K1L (`csrc/window_attn_fwd_large.cu`, q-blocks streaming key
  tiles) wherever the backward is K7, since K7 takes the output and the
  per-row log-sum-exp that K1L writes; K1 (`csrc/window_attn_fwd.cu`) only
  where its CUDA-core block fits shared memory and K4 is the backward
  (K4's block is the larger, so that is wherever K4 is the backward).
  Both replace `_fused_forward`'s pallas_call at pack 1 or 2.
So every window size JAX accepts runs on the card, up to head dim 128, and
`_WindowAttention` saves out and lse only for the K1L/K7 pair.

K1 and K4 each have two bodies in one source, under one launch counter,
chosen by `window_body` from dtype and shape: bf16 windows of at most 64
tokens (RVSA's 7×7) run a tensor-core body, one 64-row tile a window,
several windows a block through a cp.async ring, at the head dim
`flash_head_dim` gives; fp32, larger windows and head dims over 128 run
the CUDA-core body (one block per window and head, fp32 in shared memory).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mtp_tpu_torch.kernels import _build
from mtp_tpu_torch.ops.precision import at_least_fp32, plain_float64

LAUNCHES = {"window": 0, "flash": 0, "window_bwd": 0, "flash_bwd": 0,
            "window_large": 0, "window_bwd_qblk": 0}

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
_FLASH_BQ = _FLASH_BK = 64  # query / key tile of K2, and K5's bf16 row block
_FLASH_BWD_BQ = 32  # query tile of K5's fp32 kernels (their key tile is 64)
_FLASH_BWD_STREAM = 32  # rows of the tiles K5's bf16 kernels stream
_FLASH_BWD_STAGES = 3  # depth of the q-major pass's ring of them
_FLASH_BWD_STAGES_Q = 4  # and of the k-major pass's
# the bf16 flash kernels take head dims that are multiples of 16 up to 128
# (a template parameter); the wrappers zero-pad other head dims up to one
FLASH_MAX_D = 128
# K1L and K7 hold a thread's accumulator columns in registers: head dims up
# to 128 (their bf16 kernels are templates over multiples of 16 up to it, as
# the flash kernels; their shared memory, at most 173,568 B there, then fits
# a block)
LARGE_MAX_D = 128
# JAX's `_WIN_BWD_ONE_SHOT_MAX`: above this padded N its backward is K7
WIN_BWD_ONE_SHOT_MAX = 512
# K1/K4's tensor-core tile: one window of at most this many tokens (queries
# and keys), head dims up to FLASH_MAX_D
WINDOW_TILE = 64


def window_smem_bytes(N: int, D: int) -> int:
    """Shared memory of one block of K1's CUDA-core body: fp32 q, k, v rows
    of D+1, N×N scores.  (Its tensor-core body, `window_body` "mma", needs
    less wherever it runs.)"""
    return (3 * N * (D + 1) + N * N) * 4


def window_bwd_smem_bytes(N: int, D: int) -> int:
    """Shared memory of one block of K4's CUDA-core body: fp32 q, k, v, dO
    rows of D+1, the N×N probabilities and dP/dS."""
    return (4 * N * (D + 1) + 2 * N * N) * 4


def window_body(N: int, D: int, dtype: torch.dtype) -> str:
    """The body K1 and K4 run for (N, D) windows of `dtype`: "mma" (the
    tensor cores, at the head dim `flash_head_dim` gives) for bf16 windows
    of at most WINDOW_TILE tokens and head dims up to FLASH_MAX_D, else
    "simt" (the CUDA cores: fp32, larger windows, wider heads).  The
    kernels' C entry points apply the same rule (`win::body` in
    csrc/window_tile.cuh, over kRows = WINDOW_TILE and kMaxD = FLASH_MAX_D)
    and refuse a tensor-core window whose head dim was not padded, so the
    two cannot pick different bodies without a launch error."""
    if dtype == torch.bfloat16 and N <= WINDOW_TILE and D <= FLASH_MAX_D:
        return "mma"
    return "simt"


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _check_large(N: int, D: int) -> None:
    if D > LARGE_MAX_D:
        raise ValueError(f"window attention with N={N} needs the q-blocked "
                         f"kernels, which take head dims up to {LARGE_MAX_D}, "
                         f"got D={D}")


def _k7_backward(N: int, D: int) -> bool:
    """Whether (N, D) windows take K7 for their backward: where JAX's
    `_fused_backward` takes its q-blocked kernel (pack 1, i.e. N > 64, and
    round_up(N, 8) > 512) or where K4's one-block layout does not fit
    shared memory."""
    jax_qblocked = N > 64 and _round_up(N, 8) > WIN_BWD_ONE_SHOT_MAX
    return jax_qblocked or window_bwd_smem_bytes(N, D) > SMEM_LIMIT


def _large_pair(N: int, D: int) -> bool:
    """Whether (N, D) windows run the K1L/K7 pair: wherever the backward is
    K7 and K1L/K7 take the head dim."""
    return D <= LARGE_MAX_D and _k7_backward(N, D)


def window_fwd_route(N: int, D: int) -> str:
    """The `LAUNCHES` key of the forward kernel for (N, D) windows, paired
    with `window_bwd_route`: "window_large" (K1L) wherever the backward is
    K7, which takes the output and log-sum-exp K1L writes; "window" (K1)
    only where its one-block layout fits shared memory and K4 is the
    backward.  Head dims over 128, which K1L and K7 do not take, run K1
    where it fits (their backward, K4, only where K4 fits too); beyond K1's
    reach they raise."""
    if window_smem_bytes(N, D) <= SMEM_LIMIT and not _large_pair(N, D):
        return "window"
    _check_large(N, D)
    return "window_large"


def window_bwd_route(N: int, D: int) -> str:
    """The `LAUNCHES` key of the backward kernel for (N, D) windows:
    "window_bwd_qblk" (K7) where JAX's `_fused_backward` takes its q-blocked
    kernel (pack 1, i.e. N > 64, and round_up(N, 8) > 512) or where K4's
    one-block layout does not fit shared memory, else "window_bwd" (K4).
    Raises where K7 would be needed at a head dim over 128."""
    if not _k7_backward(N, D):
        return "window_bwd"
    _check_large(N, D)
    return "window_bwd_qblk"


def flash_head_dim(D: int) -> int:
    """The head dim the flash kernels (K2, K5) and K1L/K7 run at for head
    dim D: D rounded up to a multiple of 16, at most FLASH_MAX_D.  The
    wrappers zero-pad q, k, v (and out, dout) up to it, which is exact: zero
    columns add nothing to q·kᵀ or to rowsum(dO ∘ O), and the padded output
    columns are dropped."""
    if D > FLASH_MAX_D:
        raise ValueError(f"flash attention takes head dims up to "
                         f"{FLASH_MAX_D}, got D={D}")
    return _round_up(D, 16)


def flash_smem_bytes(D: int, Hk: int, Wk: int,
                     dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory of one K2 block (csrc/flash_attn_fwd.cu) at the
    kernel's head dim D.  bf16: two stages of 64-key K and V tiles as bf16
    rows of D + 8 (the 64-query q tile passes through the second one), and
    the query tile's rel_h | rel_w rows (fp32, an odd row stride).  fp32:
    q, k, v and the output accumulator as fp32 rows of D + 1, a 64×65 score
    tile, the rel rows and 3 row statistics."""
    if dtype == torch.bfloat16:
        return 4 * _FLASH_BK * (D + 8) * 2 + _FLASH_BQ * ((Hk + Wk) | 1) * 4
    return ((2 * _FLASH_BQ + 2 * _FLASH_BK) * (D + 1)
            + _FLASH_BQ * (_FLASH_BK + 1) + _FLASH_BQ * (Hk + Wk)
            + 3 * _FLASH_BQ) * 4


def flash_bwd_smem_bytes(D: int, Hk: int, Wk: int,
                         dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory of the larger of K5's two blocks
    (csrc/flash_attn_bwd.cu) at the kernel's head dim D.

    bf16, with B = 32 streamed rows and bf16 rows of D + 8: the q-major
    pass holds 3 stages of B-key K and V tiles, the 64-row q and dO tiles
    (later, in the same memory, the fp32 64 × (2B + 1) dS of two key
    tiles), the rows' rel_h | rel_w values and their gradient sums (fp32,
    odd row stride) and their delta; the k-major pass holds its 64-key K
    and V tiles and 4 stages of a B-query tile's q and dO, lse, delta, the
    rel_h columns of the at most min(Hk, 63 // Wk + 2) key rows 64 keys
    span, and its whole rel_w rows.

    fp32: the q-major pass holds q, dO, dQ of a 32-row tile, k, v of a
    64-key tile, two 32×65 score tiles, the tile's rel_h/rel_w rows and 2
    row statistics; the k-major pass holds k, v, dK, dV of a 64-key tile,
    q, dO and two score tiles of 32 rows, the rel rows and 2 statistics."""
    if dtype == torch.bfloat16:
        B, S, ld = _FLASH_BWD_STREAM, _FLASH_BWD_STAGES, D + 8
        dq_pass = (2 * S * B * ld * 2 + max(2 * 64 * ld * 2, 64 * (2 * B + 1) * 4)
                   + (2 * 64 * ((Hk + Wk) | 1) + 64) * 4)
        nky_max = min(Hk, 63 // Wk + 2)
        Sq = _FLASH_BWD_STAGES_Q
        dkv_pass = (2 * 64 + 2 * Sq * B) * ld * 2 + Sq * B * (2 + nky_max + Wk) * 4
        return max(dq_pass, dkv_pass)
    q, k, sp = _FLASH_BWD_BQ, _FLASH_BK, _FLASH_BK + 1
    dq_pass = (3 * q + 2 * k) * (D + 1) + 2 * q * sp + q * (Hk + Wk) + 2 * q
    dkv_pass = (4 * k + 2 * q) * (D + 1) + 2 * q * sp + q * (Hk + Wk) + 2 * q
    return max(dq_pass, dkv_pass) * 4


def _check_qkv(q, k, v, ndim):
    if q.dim() != ndim or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share a {ndim}-d shape: "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or not (
            q.dtype in _build.DTYPE_CODES or plain_float64(q)):
        raise TypeError(f"q, k, v must all be float32 or all bfloat16 (or "
                        f"float64 on the CPU): {q.dtype} {k.dtype} {v.dtype}")


def _check_f32(q, **tensors):
    """The fp32 inputs (float64 with float64 q, on the CPU)."""
    want = torch.float64 if q.dtype == torch.float64 else torch.float32
    for name, t in tensors.items():
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")


def _check_dout(q, dout):
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout must match q {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(dout.shape)} {dout.dtype}")


def _smem_guard(what: str, need: int) -> None:
    if need > SMEM_LIMIT:
        raise ValueError(f"{what} needs {need} B of shared memory, over the "
                         f"{SMEM_LIMIT} B of one block")


# ------------------------------------------------------- K1, K4, K1L, K7 --

def _window_scores(q, k, bias, scale):
    s = torch.einsum("whqd,whkd->whqk", at_least_fp32(q), at_least_fp32(k)) * scale
    return s + bias


def fused_window_attention_ref(q, k, v, bias, scale: float) -> torch.Tensor:
    """Plain version of K1: fp32 einsum + softmax, output in q's dtype."""
    with torch.autocast(q.device.type, enabled=False):
        p = torch.softmax(_window_scores(q, k, bias, scale), dim=-1)
        return torch.einsum("whqk,whkd->whqd", p, at_least_fp32(v)).to(q.dtype)


def fused_window_attention_bwd_ref(q, k, v, bias, dout, scale: float):
    """Plain version of K4, the explicit VJP of K1 (mtp_tpu
    `_win_bwd_kernel`): with P the recomputed probabilities,
        dV = Pᵀ dO,  dP = dO Vᵀ,  dS = P ∘ (dP − rowsum(P ∘ dP)),
        dQ = dS K · scale,  dK = dSᵀ Q · scale,  dbias = dS.
    Returns (dq, dk, dv) in q's dtype and dbias fp32."""
    with torch.autocast(q.device.type, enabled=False):
        qf, kf, vf, do = (at_least_fp32(t) for t in (q, k, v, dout))
        p = torch.softmax(_window_scores(q, k, bias, scale), dim=-1)
        dv = torch.einsum("whqk,whqd->whkd", p, do)
        dp = torch.einsum("whqd,whkd->whqk", do, vf)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        dq = torch.einsum("whqk,whkd->whqd", ds, kf) * scale
        dk = torch.einsum("whqk,whqd->whkd", ds, qf) * scale
        return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), ds


def fused_window_attention_large_ref(q, k, v, bias, scale: float):
    """Plain version of K1L: (out in q's dtype, lse fp32 (W, nH, N)), lse
    the log-sum-exp of each query row's scores, which K7 takes."""
    with torch.autocast(q.device.type, enabled=False):
        s = _window_scores(q, k, bias, scale)
        lse = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse[..., None])
        return torch.einsum("whqk,whkd->whqd", p, at_least_fp32(v)).to(q.dtype), lse


def fused_window_attention_large_bwd_ref(q, k, v, bias, out, lse, dout,
                                         scale: float):
    """Plain version of K7, from K1L's out and lse: with P = exp(s − lse),
    delta = rowsum(dO ∘ O) (= rowsum(P ∘ dP), since O = P·V) and
    dS = P ∘ (dP − delta),
        dV = Pᵀ dO,  dQ = dS K · scale,  dK = dSᵀ Q · scale,  dbias = dS.
    Returns (dq, dk, dv) in q's dtype and dbias fp32.  (The tests hold it to
    autograd through `fused_window_attention_ref` and to the JAX kernels,
    which recompute the statistics.)"""
    with torch.autocast(q.device.type, enabled=False):
        qf, kf, vf, do = (at_least_fp32(t) for t in (q, k, v, dout))
        p = torch.exp(_window_scores(q, k, bias, scale) - lse[..., None])
        delta = (do * at_least_fp32(out)).sum(-1, keepdim=True)
        dv = torch.einsum("whqk,whqd->whkd", p, do)
        dp = torch.einsum("whqd,whkd->whqk", do, vf)
        ds = p * (dp - delta)
        dq = torch.einsum("whqk,whkd->whqd", ds, kf) * scale
        dk = torch.einsum("whqk,whqd->whkd", ds, qf) * scale
        return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), ds


def _check_window(q, k, v, bias):
    _check_qkv(q, k, v, 4)
    W, nH, N, _ = q.shape
    if bias.shape != (W, nH, N, N):
        raise ValueError(f"bias must be {(W, nH, N, N)}, got {tuple(bias.shape)}")
    _check_f32(q, bias=bias)


def _check_window_saved(q, out, lse):
    W, nH, N, _ = q.shape
    if out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError(f"out must match q {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(out.shape)} {out.dtype}")
    if lse.shape != (W, nH, N):
        raise ValueError(f"lse must be {(W, nH, N)}, got {tuple(lse.shape)}")
    _check_f32(q, lse=lse)


def _window_fwd(q, k, v, bias, scale):
    """K1, the body of the op mtp::window_attn_fwd.  CPU tensors run
    `fused_window_attention_ref`; CUDA tensors launch the kernel, whose body
    `window_body` names: "mma" at the head dim `flash_head_dim` gives (q, k,
    v zero-padded up to it, out cut back)."""
    _check_window(q, k, v, bias)
    if not _build.use_kernel(q, k, v, bias):
        return fused_window_attention_ref(q, k, v, bias, scale)
    W, nH, N, D = q.shape
    if window_body(N, D, q.dtype) == "mma":
        q, k, v = (_pad_head(t, flash_head_dim(D)) for t in (q, k, v))
        _build.check_aligned(q=q, k=k, v=v)
    else:
        _smem_guard(f"window attention (K1) with N={N}, D={D}", window_smem_bytes(N, D))
    _build.check_launchable(q=q, k=k, v=v, bias=bias)
    out = torch.empty_like(q)
    _build.launch("mtp_window_attn_fwd", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), bias.data_ptr(), out.data_ptr(), W * nH, N,
                  q.shape[-1], float(scale), _build.dtype_code(q))
    LAUNCHES["window"] += 1
    return out if out.shape[-1] == D else out[..., :D].contiguous()


def _window_large_fwd(q, k, v, bias, scale):
    """K1L, the body of the op mtp::window_attn_fwd_large: (out in q's
    dtype, lse fp32 (W, nH, N)).  CPU tensors run
    `fused_window_attention_large_ref`; CUDA tensors launch the kernel, at
    the head dim `flash_head_dim` gives (q, k, v zero-padded up to it, out
    cut back), at any N."""
    _check_window(q, k, v, bias)
    if not _build.use_kernel(q, k, v, bias):
        return fused_window_attention_large_ref(q, k, v, bias, scale)
    W, nH, N, D = q.shape
    _check_large(N, D)
    q, k, v = (_pad_head(t, flash_head_dim(D)) for t in (q, k, v))
    _build.check_launchable(q=q, k=k, v=v, bias=bias)
    _build.check_aligned(q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = torch.empty((W, nH, N), dtype=torch.float32, device=q.device)
    _build.launch("mtp_window_attn_fwd_large", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), bias.data_ptr(), out.data_ptr(), lse.data_ptr(),
                  W * nH, N, q.shape[-1], float(scale), _build.dtype_code(q))
    LAUNCHES["window_large"] += 1
    return (out if out.shape[-1] == D else out[..., :D].contiguous()), lse


def fused_window_attention_bwd(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, bias: torch.Tensor,
                               dout: torch.Tensor, scale: float):
    """Gradients of `fused_window_attention` for the output cotangent dout
    (q's shape and dtype) → (dq, dk, dv) in q's dtype and dbias fp32, by K4,
    which recomputes the probabilities.

    CPU tensors run `fused_window_attention_bwd_ref`; CUDA tensors launch
    K4, whose body `window_body` names ("mma" at the head dim
    `flash_head_dim` gives: q, k, v, dout zero-padded, dq, dk, dv cut back),
    and raise where the CUDA-core block does not fit shared memory (there
    the backward is K7, `fused_window_attention_large_bwd`)."""
    _check_window(q, k, v, bias)
    _check_dout(q, dout)
    if not _build.use_kernel(q, k, v, bias, dout):
        return fused_window_attention_bwd_ref(q, k, v, bias, dout, scale)
    W, nH, N, D = q.shape
    if window_body(N, D, q.dtype) == "mma":
        q, k, v, dout = (_pad_head(t, flash_head_dim(D)) for t in (q, k, v, dout))
        _build.check_aligned(q=q, k=k, v=v, dout=dout)
    else:
        _smem_guard(f"the window attention backward (K4) with N={N}, D={D}",
                    window_bwd_smem_bytes(N, D))
    _build.check_launchable(q=q, k=k, v=v, bias=bias, dout=dout)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dbias = torch.empty_like(bias)
    _build.launch("mtp_window_attn_bwd", *(t.data_ptr() for t in (
        q, k, v, bias, dout, dq, dk, dv, dbias)), W * nH, N, q.shape[-1],
        float(scale), _build.dtype_code(q))
    LAUNCHES["window_bwd"] += 1
    if q.shape[-1] != D:
        dq, dk, dv = (t[..., :D].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv, dbias


def fused_window_attention_large_bwd(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, bias: torch.Tensor,
                                     out: torch.Tensor, lse: torch.Tensor,
                                     dout: torch.Tensor, scale: float):
    """Gradients of `fused_window_attention` for the output cotangent dout,
    from K1L's out and lse (`_window_large_fwd`) → (dq, dk, dv) in q's
    dtype and dbias fp32, by K7.

    CPU tensors run `fused_window_attention_large_bwd_ref`; CUDA tensors
    launch the K7 kernels, at the head dim `flash_head_dim` gives, at any
    N."""
    _check_window(q, k, v, bias)
    _check_dout(q, dout)
    _check_window_saved(q, out, lse)
    if not _build.use_kernel(q, k, v, bias, out, lse, dout):
        return fused_window_attention_large_bwd_ref(q, k, v, bias, out, lse,
                                                    dout, scale)
    W, nH, N, D = q.shape
    _check_large(N, D)
    q, k, v, out, dout = (_pad_head(t, flash_head_dim(D)) for t in (q, k, v, out, dout))
    _build.check_launchable(q=q, k=k, v=v, bias=bias, out=out, lse=lse, dout=dout)
    _build.check_aligned(q=q, k=k, v=v, out=out, dout=dout)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dbias = torch.empty_like(bias)
    # rowsum(dO ∘ O) per query row, from K7's q-major pass to its k-major pass
    delta = torch.empty((W * nH, N), dtype=torch.float32, device=q.device)
    _build.launch("mtp_window_attn_bwd_qblk", *(t.data_ptr() for t in (
        q, k, v, bias, out, lse, dout, dq, dk, dv, dbias, delta)), W * nH, N,
        q.shape[-1], float(scale), _build.dtype_code(q))
    LAUNCHES["window_bwd_qblk"] += 1
    if q.shape[-1] != D:
        dq, dk, dv = (t[..., :D].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv, dbias


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.scale = scale
        _check_window(q, k, v, bias)
        W, nH, N, D = q.shape
        if _large_pair(N, D):  # K1L now, K7 in the backward
            out, lse = torch.ops.mtp.window_attn_fwd_large.default(q, k, v, bias, scale)
            ctx.save_for_backward(q, k, v, bias, out, lse)
        else:  # K1, K4
            out = torch.ops.mtp.window_attn_fwd.default(q, k, v, bias, scale)
            ctx.save_for_backward(q, k, v, bias)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, *saved = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        if saved:
            grads = fused_window_attention_large_bwd(q, k, v, bias, *saved, dout,
                                                     ctx.scale)
        else:
            grads = fused_window_attention_bwd(q, k, v, bias, dout, ctx.scale)
        return (*grads, None)


def fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(q·kᵀ·scale + bias)·v per (window, head), differentiable in q,
    k, v and bias; K1 and K4, or K1L and K7, as `window_fwd_route` and
    `window_bwd_route` pair them.

    q/k/v (W, nH, N, D) fp32 or bf16; bias (W, nH, N, N) fp32 → (W, nH, N, D)
    in q's dtype."""
    return _WindowAttention.apply(q, k, v, bias, scale)

# ------------------------------------------------------------------ K2, K5 --

def _flash_scores(q, k, rel_h, rel_w, grid_hw, scale):
    """The (BH, N, N) fp32 scores q·kᵀ·scale + rel_h[q, k // Wk] + rel_w[q, k % Wk]."""
    BH, N, _ = q.shape
    Hk, Wk = grid_hw
    s = torch.einsum("bqd,bkd->bqk", at_least_fp32(q), at_least_fp32(k)) * scale
    s = s.reshape(BH, N, Hk, Wk) + rel_h[..., :, None] + rel_w[..., None, :]
    return s.reshape(BH, N, N)


def flash_full_attention_ref(q, k, v, rel_h, rel_w, grid_hw, scale: float):
    """Plain version of K2: materialises the (BH, N, N) scores and bias.
    Returns (out in q's dtype, lse fp32 (BH, N)), lse the log-sum-exp of
    each query row's scores, which the backward takes."""
    with torch.autocast(q.device.type, enabled=False):
        s = _flash_scores(q, k, rel_h, rel_w, grid_hw, scale)
        lse = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse[..., None])
        return torch.einsum("bqk,bkd->bqd", p, at_least_fp32(v)).to(q.dtype), lse


def flash_full_attention_bwd_ref(q, k, v, rel_h, rel_w, out, lse, dout,
                                 grid_hw, scale: float):
    """Plain version of K5, from K2's out and lse: with P = exp(s − lse),
    delta = rowsum(dO ∘ O) (= rowsum(P ∘ dP), since O = P·V) and
    dS = P ∘ (dP − delta),
        dV = Pᵀ dO,  dQ = dS K · scale,  dK = dSᵀ Q · scale,
    and since bias[q, ky·Wk + kx] = rel_h[q, ky] + rel_w[q, kx], d(rel_h)
    is dS summed over each key row and d(rel_w) over each key column.
    Returns (dq, dk, dv) in q's dtype and (drel_h, drel_w) fp32.  (The tests
    hold it to autograd through `flash_full_attention_ref` and to the JAX
    kernel, which recompute the statistics.)"""
    BH, N, _ = q.shape
    Hk, Wk = grid_hw
    with torch.autocast(q.device.type, enabled=False):
        qf, kf, vf, do = (at_least_fp32(t) for t in (q, k, v, dout))
        p = torch.exp(_flash_scores(q, k, rel_h, rel_w, grid_hw, scale)
                      - lse[..., None])
        delta = (do * at_least_fp32(out)).sum(-1, keepdim=True)
        dv = torch.einsum("bqk,bqd->bkd", p, do)
        dp = torch.einsum("bqd,bkd->bqk", do, vf)
        ds = p * (dp - delta)
        dq = torch.einsum("bqk,bkd->bqd", ds, kf) * scale
        dk = torch.einsum("bqk,bqd->bkd", ds, qf) * scale
        ds = ds.reshape(BH, N, Hk, Wk)
        return (dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype),
                ds.sum(-1), ds.sum(-2))


def _check_flash(q, k, v, rel_h, rel_w, grid_hw):
    _check_qkv(q, k, v, 3)
    BH, N, _ = q.shape
    Hk, Wk = grid_hw
    if Hk * Wk != N:
        raise ValueError(f"grid {grid_hw} does not hold N={N} keys")
    if rel_h.shape != (BH, N, Hk) or rel_w.shape != (BH, N, Wk):
        raise ValueError(f"rel_h/rel_w must be {(BH, N, Hk)}/{(BH, N, Wk)}, "
                         f"got {tuple(rel_h.shape)}/{tuple(rel_w.shape)}")
    _check_f32(q, rel_h=rel_h, rel_w=rel_w)


def _check_saved(q, out, lse):
    BH, N, _ = q.shape
    if out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError(f"out must match q {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(out.shape)} {out.dtype}")
    if lse.shape != (BH, N):
        raise ValueError(f"lse must be {(BH, N)}, got {tuple(lse.shape)}")
    _check_f32(q, lse=lse)


def _pad_head(t: torch.Tensor, Dp: int) -> torch.Tensor:
    """t with its last dim zero-padded to Dp."""
    return t if t.shape[-1] == Dp else F.pad(t, (0, Dp - t.shape[-1]))


def _launch_flash_fwd(q, k, v, rel_h, rel_w, grid_hw, scale):
    """K2 on CUDA tensors whose head dim the kernels take: (out, lse)."""
    BH, N, D = q.shape
    Hk, Wk = grid_hw
    _smem_guard(f"flash attention with D={D}, grid {grid_hw}",
                flash_smem_bytes(D, Hk, Wk, q.dtype))
    _build.check_launchable(q=q, k=k, v=v, rel_h=rel_h, rel_w=rel_w)
    _build.check_aligned(q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = torch.empty((BH, N), dtype=torch.float32, device=q.device)
    _build.launch("mtp_flash_attn_fwd", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
                  out.data_ptr(), lse.data_ptr(), BH, N, D, Hk, Wk,
                  float(scale), _build.dtype_code(q))
    LAUNCHES["flash"] += 1
    return out, lse


def _flash_fwd(q, k, v, rel_h, rel_w, grid_hw, scale):
    """K2, the body of the op mtp::flash_attn_fwd: (out in q's dtype, lse
    fp32 (BH, N)).  CPU tensors run `flash_full_attention_ref`; CUDA tensors
    launch the kernel, at the head dim `flash_head_dim` gives (q, k, v
    zero-padded up to it, out cut back)."""
    _check_flash(q, k, v, rel_h, rel_w, grid_hw)
    if not _build.use_kernel(q, k, v, rel_h, rel_w):
        return flash_full_attention_ref(q, k, v, rel_h, rel_w, grid_hw, scale)
    D = q.shape[-1]
    Dp = flash_head_dim(D)
    out, lse = _launch_flash_fwd(*(_pad_head(t, Dp) for t in (q, k, v)),
                                 rel_h, rel_w, grid_hw, scale)
    return (out if Dp == D else out[..., :D].contiguous()), lse


def _launch_flash_bwd(q, k, v, rel_h, rel_w, out, lse, dout, grid_hw, scale):
    """K5 on CUDA tensors whose head dim the kernels take."""
    BH, N, D = q.shape
    Hk, Wk = grid_hw
    _smem_guard(f"the flash attention backward with D={D}, grid {grid_hw}",
                flash_bwd_smem_bytes(D, Hk, Wk, q.dtype))
    _build.check_launchable(q=q, k=k, v=v, rel_h=rel_h, rel_w=rel_w, out=out,
                            lse=lse, dout=dout)
    _build.check_aligned(q=q, k=k, v=v, out=out, dout=dout)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    drel_h, drel_w = torch.empty_like(rel_h), torch.empty_like(rel_w)
    # rowsum(dO ∘ O) per query row, from K5's q-major pass to its k-major pass
    delta = torch.empty((BH, N), dtype=torch.float32, device=q.device)
    _build.launch("mtp_flash_attn_bwd", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
                  out.data_ptr(), lse.data_ptr(), dout.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  drel_h.data_ptr(), drel_w.data_ptr(), delta.data_ptr(),
                  BH, N, D, Hk, Wk, float(scale), _build.dtype_code(q))
    LAUNCHES["flash_bwd"] += 1
    return dq, dk, dv, drel_h, drel_w


def flash_full_attention_bwd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, rel_h: torch.Tensor,
                             rel_w: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor,
                             grid_hw: tuple, scale: float):
    """Gradients of `flash_full_attention` for the output cotangent dout,
    from the forward's out and lse (`_flash_fwd`) → (dq, dk, dv) in q's
    dtype and (drel_h, drel_w) fp32.

    CPU tensors run `flash_full_attention_bwd_ref`; CUDA tensors launch the
    K5 kernels, at the head dim `flash_head_dim` gives."""
    _check_flash(q, k, v, rel_h, rel_w, grid_hw)
    _check_dout(q, dout)
    _check_saved(q, out, lse)
    if not _build.use_kernel(q, k, v, rel_h, rel_w, out, lse, dout):
        return flash_full_attention_bwd_ref(q, k, v, rel_h, rel_w, out, lse,
                                            dout, grid_hw, scale)
    D = q.shape[-1]
    Dp = flash_head_dim(D)
    q, k, v, out, dout = (_pad_head(t, Dp) for t in (q, k, v, out, dout))
    dq, dk, dv, drel_h, drel_w = _launch_flash_bwd(
        q, k, v, rel_h, rel_w, out, lse, dout, grid_hw, scale)
    if Dp != D:
        dq, dk, dv = (t[..., :D].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv, drel_h, drel_w


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w, grid_hw, scale):
        ctx.grid_hw, ctx.scale = grid_hw, scale
        out, lse = torch.ops.mtp.flash_attn_fwd.default(q, k, v, rel_h, rel_w, grid_hw,
                                                        scale)
        ctx.save_for_backward(q, k, v, rel_h, rel_w, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, rel_h, rel_w, out, lse = ctx.saved_tensors
        grads = flash_full_attention_bwd(
            q, k, v, rel_h, rel_w, out, lse, dout.to(q.dtype).contiguous(),
            ctx.grid_hw, ctx.scale)
        return (*grads, None, None)


def flash_full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         rel_h: torch.Tensor, rel_w: torch.Tensor,
                         grid_hw: tuple, scale: float) -> torch.Tensor:
    """Full attention with the decomposed rel-pos bias
    bias[q, k] = rel_h[q, k // Wk] + rel_w[q, k % Wk], never forming the
    (N, N) scores on the card; differentiable in q, k, v, rel_h and rel_w.

    q/k/v (BH, N, D) fp32 or bf16; rel_h (BH, N, Hk), rel_w (BH, N, Wk) fp32;
    N = Hk·Wk → (BH, N, D) in q's dtype."""
    return _FlashAttention.apply(q, k, v, rel_h, rel_w, tuple(grid_hw), scale)
