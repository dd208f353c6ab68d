"""ViT + RVSA (Rotated Varied-Size Window Attention) backbone.

Port of `mtp_tpu/models/vit_rvsa.py` (itself a re-design of the reference
`ViT_Win_RVSA_V3_WSZ7`).  Features are NHWC; modules permute to NCHW only
around `nn.Conv2d`-family layers.  Parameter names are the reference torch
names read by `mtp_tpu/ckpt/torch_convert.py` `convert_backbone`.

Numeric semantics kept from the reference, quirks included:
- blocks are RVSA except every `interval`-th (1-indexed), which is full
  attention over the whole token grid,
- full attention applies `scale` to q before the rel-pos contraction and
  hands the kernel scale 1.0; RVSA builds its rel-pos bias from unscaled q
  and the kernel applies `scale` to q·k,
- RVSA x-offsets are divided by the vertical window count and y-offsets by
  the horizontal one, of the unpadded map,
- qkv is computed on unpadded tokens and then zero-padded (centred), while
  the offset/scale/angle regressors pool the zero-padded features; the
  regressors and the sampling-grid build run in fp32 (autocast off),
- sampling grids use align_corners=True with zero padding,
- windows are ordered (B, nh, nw) with heads next, LayerNorm eps is 1e-6
  and GELU is exact.

Kernels: RVSA blocks run K1 (window attention) and K3 twice (K and V
sampling); full blocks run K2 when max(H, W) <= 128, else, as the JAX
package routes them, the window-attention function over one window of all
H·W tokens with a materialised fp32 bias (K1L forward, K7 backward at every
grid over 128 per axis).  Their backwards run K4, K6 (twice) and K5.

Patch 8 (the reference's patch-8 variant, `mtp_tpu/models/vit_rvsa.py:402-407`)
doubles the token grid per axis and takes the simple FPN's patch-8 branch:
one deconvolution (`fpn1.0`), identity, 2×2 and 4×4 max-pools, no norm.

Train mode follows the JAX meaning of `deterministic`: when False, each
block's residual branches go through per-sample drop-path at the rates
linspace(0, drop_path_rate, depth), and the patch tokens through dropout at
drop_rate, every mask drawn from the generator passed in.  With `remat`
each block runs under `torch.utils.checkpoint` when a backward can follow,
so only its input is kept and the block is recomputed in the backward (the
JAX module's `nn.remat`); its two drop-path masks are drawn before the
checkpointed call and passed in, so the recompute uses the forward's masks
(checkpoint restores the global RNGs, not the explicit generator).  The
full blocks' (B, nH, N, N) bias then lives one block at a time.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mtp_tpu_torch.config import BackboneConfig
from mtp_tpu_torch.ops.dropout import apply_drop_path, drop_path_mask, dropout
from mtp_tpu_torch.ops.fused_attn import (flash_full_attention,
                                          fused_window_attention)
from mtp_tpu_torch.ops.grid_sample import grid_sample
from mtp_tpu_torch.ops.precision import at_least_fp32
from mtp_tpu_torch.ops.rel_pos import (decomposed_rel_pos_bias,
                                       decomposed_rel_pos_factors,
                                       swin_rel_pos_bias, swin_rel_pos_index)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class FullAttention(nn.Module):
    """Global attention over the whole (H, W) token grid with the decomposed
    relative position bias; `grid_size` is the rel-pos table extent."""

    def __init__(self, dim: int, num_heads: int, grid_size: Tuple[int, int],
                 qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.scale = hd ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.full_attn_rel_pos_h = nn.Parameter(torch.zeros(2 * grid_size[0] - 1, hd))
        self.full_attn_rel_pos_w = nn.Parameter(torch.zeros(2 * grid_size[1] - 1, hd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        nH = self.num_heads
        hd = C // nH
        qkv = self.qkv(x).reshape(B, H * W, 3, nH, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]  # (B, nH, N, hd)
        if max(H, W) <= 128:
            rel_h, rel_w = decomposed_rel_pos_factors(
                q, (H, W), (H, W), self.full_attn_rel_pos_h,
                self.full_attn_rel_pos_w)
            f = lambda t: t.reshape((B * nH,) + t.shape[2:]).contiguous()
            out = flash_full_attention(f(q), f(k), f(v), f(rel_h), f(rel_w),
                                       (H, W), 1.0)
        else:
            # >128-per-axis grids: one window of all H·W tokens with the
            # materialised fp32 bias (contiguous as built: no copy of its
            # B·nH·N² floats)
            bias = decomposed_rel_pos_bias(q, (H, W), (H, W),
                                           self.full_attn_rel_pos_h,
                                           self.full_attn_rel_pos_w)
            out = fused_window_attention(q.contiguous(), k.contiguous(),
                                         v.contiguous(), bias, 1.0)
        out = out.reshape(B, nH, H * W, hd).transpose(1, 2).reshape(B, H, W, C)
        return self.proj(out)


def _regressor(dim: int, out: int, ws: int) -> nn.Sequential:
    """Reference layout: avg-pool over the window, LeakyReLU, 1×1 conv (the
    conv at index 2 carries the weights)."""
    return nn.Sequential(nn.AvgPool2d(ws, stride=ws), nn.LeakyReLU(0.01),
                         nn.Conv2d(dim, out, 1))


class RVSAAttention(nn.Module):
    """Rotated varied-size window attention: each ws×ws query window attends
    to ws×ws K/V taps bilinearly sampled on a per-window learned grid (the
    identity window grid scaled by 1+s, rotated by theta, shifted by an
    offset)."""

    def __init__(self, dim: int, num_heads: int, ws: int = 7,
                 qkv_bias: bool = True):
        super().__init__()
        self.num_heads, self.ws = num_heads, ws
        hd = dim // num_heads
        self.scale = hd ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * ws - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * ws - 1, hd))
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, num_heads))
        self.sampling_offsets = _regressor(dim, num_heads * 2, ws)
        self.sampling_scales = _regressor(dim, num_heads * 2, ws)
        self.sampling_angles = _regressor(dim, num_heads, ws)
        self.register_buffer("relative_position_index",
                             torch.as_tensor(swin_rel_pos_index(ws, ws)),
                             persistent=False)

    def _sampling_grid(self, x_pad: torch.Tensor, H: int, W: int):
        """(B*nH, nh*ws, nw*ws, 2) sampling grid in [-1, 1] (x, y), fp32."""
        B, Hp, Wp, _ = x_pad.shape
        nH, ws = self.num_heads, self.ws
        nh, nw = Hp // ws, Wp // ws
        dev = x_pad.device
        # pool + LeakyReLU once, shared by the three regressors
        pooled = self.sampling_offsets[1](self.sampling_offsets[0](_nchw(x_pad)))
        off = _nhwc(self.sampling_offsets[2](pooled)).reshape(B, nh, nw, nH, 2)
        scl = _nhwc(self.sampling_scales[2](pooled)).reshape(B, nh, nw, nH, 2)
        ang = _nhwc(self.sampling_angles[2](pooled))  # (B, nh, nw, nH)

        off_x = off[..., 0] / max(H // ws, 1)
        off_y = off[..., 1] / max(W // ws, 1)

        ref_x = np.linspace(-1.0, 1.0, Wp, dtype=np.float32)
        ref_y = np.linspace(-1.0, 1.0, Hp, dtype=np.float32)
        bc = np.arange(ws, dtype=np.float32) * 2.0 * ws / ws
        bc_x, bc_y = bc / (Wp - 1), bc / (Hp - 1)
        t = lambda a: torch.as_tensor(a, device=dev)
        wc_x = t(ref_x.reshape(nw, ws).mean(-1))  # window centres
        wc_y = t(ref_y.reshape(nh, ws).mean(-1))
        bc_x = t(bc_x - bc_x.mean())  # in-window offsets
        bc_y = t(bc_y - bc_y.mean())

        sx = scl[..., 0] + 1.0  # (B, nh, nw, nH)
        sy = scl[..., 1] + 1.0
        ox = (bc_x * sx[..., None])[..., None, :]  # (B, nh, nw, nH, 1, ws)
        oy = (bc_y * sy[..., None])[..., :, None]  # (B, nh, nw, nH, ws, 1)
        sin, cos = torch.sin(ang)[..., None, None], torch.cos(ang)[..., None, None]
        rx = -oy * sin + ox * cos
        ry = oy * cos + ox * sin
        gx = wc_x[None, None, :, None, None, None] + rx + off_x[..., None, None]
        gy = wc_y[None, :, None, None, None, None] + ry + off_y[..., None, None]
        grid = torch.stack([gx, gy], dim=-1)  # (B, nh, nw, nH, ws, ws, 2)
        return grid.permute(0, 3, 1, 4, 2, 5, 6).reshape(B * nH, nh * ws, nw * ws, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        nH, ws = self.num_heads, self.ws
        hd = C // nH

        # qkv on unpadded tokens, then centred zero padding (reference order)
        qkv = self.qkv(x)
        ph, pw = (ws - H % ws) % ws, (ws - W % ws) % ws
        pt, pl = ph // 2, pw // 2
        Hp, Wp = H + ph, W + pw
        nh, nw = Hp // ws, Wp // ws
        pad = (0, 0, pl, pw - pl, pt, ph - pt)
        qkv = F.pad(qkv, pad)
        qkv = qkv.reshape(B, Hp, Wp, 3, nH, hd).permute(3, 0, 4, 1, 2, 5)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B, nH, Hp, Wp, hd)

        with torch.autocast(x.device.type, enabled=False):
            grid = self._sampling_grid(F.pad(at_least_fp32(x), pad), H, W)

        k_sel = grid_sample(k.reshape(B * nH, Hp, Wp, hd), grid,
                            align_corners=True, padding_mode="zeros")
        v_sel = grid_sample(v.reshape(B * nH, Hp, Wp, hd), grid,
                            align_corners=True, padding_mode="zeros")

        def to_windows(t):
            # (B*nH, nh*ws, nw*ws, hd) → (B*nh*nw, nH, ws*ws, hd)
            t = t.reshape(B, nH, nh, ws, nw, ws, hd)
            return t.permute(0, 2, 4, 1, 3, 5, 6).reshape(
                B * nh * nw, nH, ws * ws, hd).contiguous()

        qw = to_windows(q.reshape(B * nH, Hp, Wp, hd))
        kw, vw = to_windows(k_sel), to_windows(v_sel)
        bias = decomposed_rel_pos_bias(qw, (ws, ws), (ws, ws),
                                       self.rel_pos_h, self.rel_pos_w)
        table = at_least_fp32(self.relative_position_bias_table)
        bias = bias + swin_rel_pos_bias(table, self.relative_position_index)
        out = fused_window_attention(qw, kw, vw, bias.contiguous(), self.scale)

        out = out.reshape(B, nh, nw, nH, ws, ws, hd)
        out = out.permute(0, 1, 4, 2, 5, 3, 6).reshape(B, Hp, Wp, C)
        out = out[:, pt:pt + H, pl:pl + W]
        return self.proj(out)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 full_attn: bool, grid_size: Tuple[int, int],
                 window_size: int = 7, qkv_bias: bool = True,
                 init_values: Optional[float] = None,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        if full_attn:
            self.attn = FullAttention(dim, num_heads, grid_size, qkv_bias)
        else:
            self.attn = RVSAAttention(dim, num_heads, window_size, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        if init_values is not None:
            self.gamma_1 = nn.Parameter(torch.full((dim,), float(init_values)))
            self.gamma_2 = nn.Parameter(torch.full((dim,), float(init_values)))
        else:
            self.gamma_1 = self.gamma_2 = None

    def drop_path_masks(self, x: torch.Tensor, deterministic: bool,
                        generator: Optional[torch.Generator]):
        """The keep masks of the two residual branches (None when off)."""
        return tuple(drop_path_mask(x, self.drop_path_rate, deterministic,
                                    generator) for _ in range(2))

    def forward(self, x: torch.Tensor, keep1: Optional[torch.Tensor] = None,
                keep2: Optional[torch.Tensor] = None) -> torch.Tensor:
        rate = self.drop_path_rate
        a = self.attn(self.norm1(x))
        a = a if self.gamma_1 is None else a * self.gamma_1
        x = x + apply_drop_path(a, keep1, rate)
        m = self.mlp(self.norm2(x))
        m = m if self.gamma_2 is None else m * self.gamma_2
        return x + apply_drop_path(m, keep2, rate)


class Norm2d(nn.Module):
    """Channels-last LayerNorm inside the simple-FPN deconv stack (applied
    to NCHW input, as the reference's Norm2d)."""

    def __init__(self, dim: int):
        super().__init__()
        self.ln = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nchw(self.ln(_nhwc(x)))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, in_chans: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, dim, patch, stride=patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nhwc(self.proj(_nchw(x)))


class ViTRVSA(nn.Module):
    """Patch embed → interleaved RVSA/full blocks → simple FPN.

    `input_hw` fixes the token grid that sizes `pos_embed` and the full
    blocks' rel-pos tables (default `cfg.img_size` square), as the JAX
    module's parameters are sized by its init input.  forward takes
    (B, H, W, in_chans) and returns 4 NHWC levels (strides 4/8/16/32).

    `features_only` builds no FPN: forward returns the raw stride-16 maps
    at `out_indices` (the JAX call's `features_only=True`, whose parameter
    tree has no `fpn`; the change-detection backbone)."""

    def __init__(self, cfg: BackboneConfig,
                 input_hw: Optional[Tuple[int, int]] = None,
                 features_only: bool = False):
        super().__init__()
        self.features_only = features_only
        if cfg.patch_size not in (8, 16):
            raise ValueError(f"patch size {cfg.patch_size}: the simple FPN has "
                             f"variants for 16 and 8")
        self.cfg = cfg
        H, W = input_hw or (cfg.img_size, cfg.img_size)
        p, D = cfg.patch_size, cfg.embed_dim
        grid = (H // p, W // p)
        self.patch_embed = PatchEmbed(p, cfg.in_chans, D)
        self.pos_embed = (nn.Parameter(torch.zeros(1, grid[0] * grid[1], D))
                          if cfg.use_abs_pos_emb else None)
        dpr = np.linspace(0.0, cfg.drop_path_rate, cfg.depth)
        self.blocks = nn.ModuleList(
            Block(D, cfg.num_heads, cfg.mlp_ratio,
                  full_attn=((i + 1) % cfg.interval == 0), grid_size=grid,
                  window_size=cfg.window_size, qkv_bias=cfg.qkv_bias,
                  init_values=cfg.init_values, drop_path_rate=float(dpr[i]))
            for i in range(cfg.depth))
        if features_only:
            return
        # the simple feature pyramid (ViTDet-style, reference fpn1..fpn4):
        # strides 4, 8, 16, 32 from the token grid, all D channels
        up = lambda: nn.ConvTranspose2d(D, D, 2, stride=2)
        if p == 8:  # reference :655-668: one deconv, identity, two pools, no norm
            self.fpn1 = nn.Sequential(up())
            self.fpn2 = nn.Identity()
            self.fpn3 = nn.MaxPool2d(2, stride=2)
            self.fpn4 = nn.MaxPool2d(4, stride=4)
            return
        self.fpn1 = nn.Sequential(up(), Norm2d(D), nn.GELU(), up())
        self.fpn2 = nn.Sequential(up())
        self.fpn3 = nn.Identity()
        self.fpn4 = nn.MaxPool2d(2, stride=2)

    @property
    def out_channels(self) -> Tuple[int, ...]:
        return (self.cfg.embed_dim,) * len(self.cfg.out_indices)

    def taps(self, x: torch.Tensor, deterministic: bool = True,
             generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        """The raw stride-16 maps (B, Hp, Wp, D) at `out_indices`."""
        remat = self.cfg.remat and torch.is_grad_enabled()
        x = self.patch_embed(x)  # (B, Hp, Wp, D)
        B, Hp, Wp, D = x.shape
        if self.pos_embed is not None:
            x = x + self.pos_embed.reshape(1, Hp, Wp, D)
        x = dropout(x, self.cfg.drop_rate, deterministic, generator)
        taps = {}
        for i, blk in enumerate(self.blocks):
            keep = blk.drop_path_masks(x, deterministic, generator)
            if remat:
                # nothing inside the block draws random numbers: its masks
                # are passed in, so no RNG state is saved
                x = checkpoint(blk, x, *keep, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = blk(x, *keep)
            if i in self.cfg.out_indices:
                taps[i] = x
        return tuple(taps[i] for i in self.cfg.out_indices)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None, first_level: int = 0):
        """The 4 levels; those below `first_level` come back None, not run
        (an FPN from level 1 reads no fpn1)."""
        taps = self.taps(x, deterministic, generator)
        if self.features_only:
            return taps
        ops = (self.fpn1, self.fpn2, self.fpn3, self.fpn4)
        return tuple(None if i < first_level else _nhwc(op(_nchw(t)))
                     for i, (op, t) in enumerate(zip(ops, taps)))

    def last_level(self, x: torch.Tensor, deterministic: bool = True,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`forward(...)[-1]` without running fpn1-fpn3."""
        return _nhwc(self.fpn4(_nchw(self.taps(x, deterministic, generator)[-1])))


def backbone_flops(cfg: BackboneConfig,
                   input_hw: Optional[Tuple[int, int]] = None) -> float:
    """Analytic forward-FLOPs estimate for the RVSA backbone (same count as
    `mtp_tpu.models.vit_rvsa.backbone_flops`): patch embed, per-block
    qkv/proj/mlp, window-attention products, RVSA sampling, the quadratic
    full-attention blocks, and one 2×2 deconv level for the FPN."""
    H, W = input_hw or (cfg.img_size, cfg.img_size)
    ph = pw = cfg.patch_size
    h, w = H // ph, W // pw
    D, nH = cfg.embed_dim, cfg.num_heads
    ws = cfg.window_size
    hp = (h + ws - 1) // ws * ws
    wp = (w + ws - 1) // ws * ws
    n_tok, n_pad = h * w, hp * wp
    N = ws * ws

    patch_embed = H * W * cfg.in_chans * D * ph * pw // (ph * pw)
    per_tok_dense = (3 * D * D) + (D * D) + 2 * D * int(D * cfg.mlp_ratio)
    flops = float(patch_embed)
    n_windows = (hp // ws) * (wp // ws)
    for i in range(cfg.depth):
        full = (i + 1) % cfg.interval == 0
        flops += n_tok * per_tok_dense
        if full:
            flops += 2 * nH * n_tok * n_tok * (D // nH)
        else:
            flops += n_windows * (2 * nH * N * N * (D // nH))
            flops += n_pad * D                       # pooling
            flops += n_windows * (3 * 2 * nH) * D    # regressors
            flops += n_pad * 2                       # coords
            flops += 2 * n_pad * D * 4               # bilinear gather K+V
    flops += n_tok * D * D * 4
    return flops
