"""The port's kernel functions (K1 window attention, K2 flash full attention,
K3 bilinear sampling) against the JAX Pallas kernels run in interpret mode.

On the CPU the port's wrappers run their plain PyTorch versions, so these
tests hold the plain versions — which `chip_smoke.py` holds the CUDA kernels
against on the card — to the TPU kernels' semantics.  Inputs are made with
numpy from a seed and fed to both sides in fp32.
"""

import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mtp_tpu.ops.dcnv3_pallas import dcnv3_sample as jax_dcnv3_sample
from mtp_tpu.ops.pallas_attn import _flash_forward as jax_flash_forward
from mtp_tpu.ops.pallas_attn import fused_window_attention as jax_window
from mtp_tpu_torch.kernels import _build
from mtp_tpu_torch.ops import dcnv3_sample as port_dcn
from mtp_tpu_torch.ops import fused_attn
from mtp_tpu_torch.ops import nms as port_nms

torch.set_num_threads(1)

# fp32 on both sides; only the summation order differs
ATOL, RTOL = 1e-5, 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("W,nH,N,D", [(5, 2, 49, 16), (3, 3, 25, 8)])
def test_window_attention_matches_pallas(W, nH, N, D):
    rng = np.random.default_rng(W * 100 + N)
    q, k, v = (rng.standard_normal((W, nH, N, D)).astype(np.float32)
               for _ in range(3))
    bias = (rng.standard_normal((W, nH, N, N)) * 0.5).astype(np.float32)
    scale = D ** -0.5
    ref = jax_window(*map(jnp.asarray, (q, k, v, bias)), scale, interpret=True)
    before = fused_attn.LAUNCHES["window"]
    got = fused_attn.fused_window_attention(_t(q), _t(k), _t(v), _t(bias), scale)
    assert fused_attn.LAUNCHES["window"] == before  # CPU: plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("grid_hw,D", [((5, 7), 16), ((4, 4), 8)])
def test_flash_attention_matches_pallas(grid_hw, D):
    """The plain K2 returns (out, lse): out against the Pallas forward, lse
    against a numpy log-sum-exp of the same scores; the differentiable
    function returns the same out."""
    Hk, Wk = grid_hw
    BH, N = 3, Hk * Wk
    rng = np.random.default_rng(N)
    q, k, v = (rng.standard_normal((BH, N, D)).astype(np.float32)
               for _ in range(3))
    rel_h = rng.standard_normal((BH, N, Hk)).astype(np.float32)
    rel_w = rng.standard_normal((BH, N, Wk)).astype(np.float32)
    ref = jax_flash_forward(*map(jnp.asarray, (q, k, v, rel_h, rel_w)), grid_hw,
                            0.3, interpret=True)
    before = dict(fused_attn.LAUNCHES)
    out, lse = fused_attn._flash_fwd(_t(q), _t(k), _t(v), _t(rel_h), _t(rel_w),
                                     grid_hw, 0.3)
    assert fused_attn.LAUNCHES == before  # CPU: plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    s = (np.einsum("bqd,bkd->bqk", q.astype(np.float64), k) * 0.3
         + (rel_h[..., :, None] + rel_w[..., None, :]).reshape(BH, N, N))
    m = s.max(-1)
    want = m + np.log(np.exp(s - m[..., None]).sum(-1))
    assert lse.shape == (BH, N) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, atol=ATOL, rtol=RTOL)
    got = fused_attn.flash_full_attention(_t(q), _t(k), _t(v), _t(rel_h),
                                          _t(rel_w), grid_hw, 0.3)
    np.testing.assert_array_equal(got.numpy(), out.numpy())


def _sample_inputs(seed, BG, H, W, C, HWo, P, unit_mask=False):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((BG, H * W, C)).astype(np.float32)
    # coordinates run off the map on every side; a quarter are exact integers
    py = rng.uniform(-2.5, H + 1.5, (BG, HWo, P)).astype(np.float32)
    px = rng.uniform(-2.5, W + 1.5, (BG, HWo, P)).astype(np.float32)
    py[:, ::4] = np.round(py[:, ::4])
    px[:, ::4] = np.round(px[:, ::4])
    m = (np.ones((BG, HWo, P), np.float32) if unit_mask
         else rng.uniform(-1, 1, (BG, HWo, P)).astype(np.float32))
    return img, py, px, m


@pytest.mark.parametrize("BG,H,W,C,HWo,P,unit", [
    (3, 9, 11, 8, 40, 9, False),   # DCNv3-style: P=9, random mask
    (2, 7, 7, 16, 49, 1, True),    # RVSA K/V sampling: P=1, unit mask
    (16, 8, 8, 4, 64, 1, True),    # tiny map: the TPU's bg-packed tier
])
def test_bilinear_sample_matches_pallas(BG, H, W, C, HWo, P, unit):
    img, py, px, m = _sample_inputs(BG + P, BG, H, W, C, HWo, P, unit)
    ref = jax_dcnv3_sample(*map(jnp.asarray, (img, py, px, m)), H, W, True)
    got = port_dcn.dcnv3_sample(_t(img), _t(py), _t(px), _t(m), H, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_bf16_plain_versions_keep_dtype():
    rng = np.random.default_rng(5)
    q = _t(rng.standard_normal((2, 2, 25, 8)).astype(np.float32))
    bias = torch.zeros(2, 2, 25, 25)
    qb = q.bfloat16()
    out = fused_attn.fused_window_attention(qb, qb, qb, bias, 0.3)
    ref = fused_attn.fused_window_attention(qb.float(), qb.float(), qb.float(),
                                            bias, 0.3)
    assert out.dtype == torch.bfloat16
    # one bf16 rounding of the output (8 bits of mantissa)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=2e-2, rtol=1e-2)


def test_wrappers_reject_what_no_kernel_takes():
    q = torch.zeros(2, 2, 25, 8)
    bias = torch.zeros(2, 2, 25, 25)
    with pytest.raises(ValueError, match="device"):
        fused_attn.fused_window_attention(q.to("meta"), q.to("meta"),
                                          q.to("meta"), bias.to("meta"), 1.0)
    with pytest.raises(TypeError):
        fused_attn.fused_window_attention(q.half(), q.half(), q.half(), bias, 1.0)
    with pytest.raises(ValueError, match="bias"):
        fused_attn.fused_window_attention(q, q, q, bias[:, :1], 1.0)
    with pytest.raises(ValueError, match="grid"):
        fused_attn.flash_full_attention(q[0], q[0], q[0], q[0, :, :, :5],
                                        q[0, :, :, :5], (5, 6), 1.0)
    img = torch.zeros(2, 12, 4)
    coord = torch.zeros(2, 6, 1)
    with pytest.raises(ValueError, match="pixels"):
        port_dcn.dcnv3_sample(img, coord, coord, coord, 3, 5)
    with pytest.raises(TypeError):
        port_dcn.dcnv3_sample(img, coord.double(), coord, coord, 3, 4)


def test_shared_memory_budget_of_the_slice_shapes():
    """The slice's K1 (N=49, D=64) and K2/K5 (24×24 grid, D=64) blocks fit
    the 227 KB a Hopper block may use, in both dtypes; 2048² full attention
    (128×128 grid) still fits K2 and K5 at every head dim the bf16 kernels
    take, while a 1024-token window overflows K1."""
    assert fused_attn.window_smem_bytes(49, 64) <= 48 * 1024
    for dtype in (torch.bfloat16, torch.float32):
        for grid in (24, 128):
            assert fused_attn.flash_smem_bytes(64, grid, grid, dtype) <= fused_attn.SMEM_LIMIT
            assert fused_attn.flash_bwd_smem_bytes(64, grid, grid, dtype) <= fused_attn.SMEM_LIMIT
    for D in range(16, fused_attn.FLASH_MAX_D + 1, 16):
        for grid_hw in ((128, 128), (1, 128), (128, 1), (20, 33)):
            assert fused_attn.flash_smem_bytes(D, *grid_hw) <= fused_attn.SMEM_LIMIT
            assert fused_attn.flash_bwd_smem_bytes(D, *grid_hw) <= fused_attn.SMEM_LIMIT
    assert fused_attn.window_smem_bytes(1024, 64) > fused_attn.SMEM_LIMIT


def test_nms_kernel_wrapper_takes_only_the_card():
    """N1's wrapper launches on CUDA tensors only: CPU tensors go to `nms_ref`
    through `nms_batched`, and called directly on them it raises, as it
    does on boxes that are not fp32 or past its limit; its limits are
    csrc/nms.cu's and the shared scan's (csrc/nms_scan.cuh) constants; the
    mask kernel launches only the upper triangle's tiles, and the scan one
    warp an image with no block barrier in its walk."""
    boxes, scores = torch.zeros(2, 70, 4), torch.zeros(2, 70)
    with pytest.raises(ValueError, match="CUDA"):
        port_nms.nms_keep(boxes, scores, 0.7)
    with pytest.raises(ValueError, match="device"):
        port_nms.nms_batched(boxes.to("meta"), scores.to("meta"), 0.7, 10)
    before = dict(port_nms.LAUNCHES)
    port_nms.nms_batched(boxes, scores, 0.7, 10)
    assert port_nms.LAUNCHES == before
    src = (_build.CSRC / "nms.cu").read_text() + (_build.CSRC / "nms_scan.cuh").read_text()
    const = lambda name: re.search(rf"constexpr \w+ {name} = ([^;]+);", src)[1]
    assert const("kTile") == str(port_nms.NMS_TILE)
    assert const("kMaxBoxes") == "1 << 16" and port_nms.NMS_MAX_BOXES == 1 << 16
    assert float(const("kValidMin").rstrip("f")) == port_nms.NEG_INF / 2
    assert const("kListCap") == str(port_nms.NMS_LIST_CAP)
    assert _build.SIGNATURES["mtp_nms"] == [_build._P] * 5 + [_build._I, _build._I, _build._F]
    assert "<<<dim3(nms::upper_tiles(words), B), kTile" in src
    assert "nms::nms_scan_kernel<<<B, nms::kWarp," in src
    scan = src[src.index("nms_scan_kernel(const u64*"):]
    assert "__syncthreads" not in scan and "__syncwarp" in scan
