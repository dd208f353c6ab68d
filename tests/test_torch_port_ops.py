"""The port's plain ops (rel-pos biases, grid_sample, resize_bilinear, slide
origins) against the JAX package, fp32 on both sides, inputs from numpy."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mtp_tpu.eval.slide import slide_origins as jax_slide_origins
from mtp_tpu.heads.upernet import resize_bilinear as jax_resize
from mtp_tpu.ops import rel_pos as jrp
from mtp_tpu.ops.grid_sample import grid_sample as jax_grid_sample
from mtp_tpu_torch.eval.slide import slide_origins
from mtp_tpu_torch.heads.upernet import resize_bilinear
from mtp_tpu_torch.ops import rel_pos as prp
from mtp_tpu_torch.ops.grid_sample import grid_sample

torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-5  # fp32 both sides, summation order only


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("q_shape,k_shape", [((7, 7), (7, 7)), ((4, 6), (8, 3))])
def test_decomposed_rel_pos(q_shape, k_shape):
    rng = np.random.default_rng(sum(q_shape) + sum(k_shape))
    C = 8
    q = rng.standard_normal((2, 3, q_shape[0] * q_shape[1], C)).astype(np.float32)
    rh = rng.standard_normal((2 * max(q_shape[0], k_shape[0]) - 1, C)).astype(np.float32)
    rw = rng.standard_normal((2 * max(q_shape[1], k_shape[1]) - 1, C)).astype(np.float32)
    attn = rng.standard_normal((2, 3, q.shape[2], k_shape[0] * k_shape[1])
                               ).astype(np.float32)
    for a, b in ((jrp.rel_pos_indices(q_shape[0], k_shape[0]),
                  prp.rel_pos_indices(q_shape[0], k_shape[0])),
                 (jrp.rel_pos_indices(q_shape[1], k_shape[1]),
                  prp.rel_pos_indices(q_shape[1], k_shape[1]))):
        np.testing.assert_array_equal(a, b)
    args_j = (jnp.asarray(q), q_shape, k_shape, jnp.asarray(rh), jnp.asarray(rw))
    args_p = (_t(q), q_shape, k_shape, _t(rh), _t(rw))
    np.testing.assert_allclose(prp.decomposed_rel_pos_bias(*args_p).numpy(),
                               np.asarray(jrp.decomposed_rel_pos_bias(*args_j)),
                               atol=ATOL, rtol=RTOL)
    for got, ref in zip(prp.decomposed_rel_pos_factors(*args_p),
                        jrp.decomposed_rel_pos_factors(*args_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    got = prp.add_decomposed_rel_pos(_t(attn), *args_p)
    ref = jrp.add_decomposed_rel_pos(jnp.asarray(attn), *args_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_swin_rel_pos():
    idx = prp.swin_rel_pos_index(7, 7)
    np.testing.assert_array_equal(idx, jrp.swin_rel_pos_index(7, 7))
    table = np.random.default_rng(0).standard_normal((169, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        prp.swin_rel_pos_bias(_t(table), idx).numpy(),
        np.asarray(jrp.swin_rel_pos_bias(jnp.asarray(table), idx)))
    # a long-tensor index gives the same bias
    np.testing.assert_array_equal(
        prp.swin_rel_pos_bias(_t(table), torch.as_tensor(idx)).numpy(),
        prp.swin_rel_pos_bias(_t(table), idx).numpy())


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample(align_corners, padding_mode):
    rng = np.random.default_rng(int(align_corners) + 2 * (padding_mode == "zeros"))
    img = rng.standard_normal((3, 9, 11, 5)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (3, 6, 7, 2)).astype(np.float32)
    grid[:, 0, 0] = (-1.0, 1.0)  # exact corners
    ref = jax_grid_sample(jnp.asarray(img), jnp.asarray(grid),
                          align_corners=align_corners, padding_mode=padding_mode)
    got = grid_sample(_t(img), _t(grid), align_corners=align_corners,
                      padding_mode=padding_mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_grid_sample_rejects_unknown_padding():
    with pytest.raises(ValueError, match="padding_mode"):
        grid_sample(torch.zeros(1, 4, 4, 2), torch.zeros(1, 2, 2, 2),
                    padding_mode="reflection")


@pytest.mark.parametrize("size", [(23, 17), (5, 3), (12, 12)])
@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_bilinear(size, align_corners):
    x = np.random.default_rng(size[0]).standard_normal((2, 12, 12, 3)
                                                       ).astype(np.float32)
    ref = jax_resize(jnp.asarray(x), size, align_corners)
    got = resize_bilinear(_t(x), size, align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("H,W,crop,stride", [(512, 512, 384, 256),
                                             (300, 700, 256, 128),
                                             (200, 200, 256, 128)])
def test_slide_origins(H, W, crop, stride):
    np.testing.assert_array_equal(slide_origins(H, W, crop, stride),
                                  jax_slide_origins(H, W, crop, stride))
