"""The port's CARAFE mask upsample (`ops/carafe.py`, `MaskHead(upsample=
"carafe")`) and the patch-8 ViT+RVSA (`ViTRVSA` at `patch_size=8`, the simple
FPN's patch-8 branch) against the JAX package's on the CPU, same weights
(carried by `ckpt.from_jax`), fp32 on both sides, inputs made with numpy
from a seed:

- `CARAFEPack`: the upsampled map and the gradients of Σ out·cot (the
  input's and every parameter's);
- `MaskHead(upsample="carafe")` inside the toy Mask R-CNN (the detector's
  `mask_trunk.upsample_carafe` through `detector_from_jax`): mask logits on
  given RoIs and their gradients;
- the patch-8 backbone: its four levels (strides 4, 8, 16, 32 of a token
  grid at stride 8) and their gradients, the parameter round trip through
  `backbone_from_jax`, and a released-style `.pth` with `fpn1.0` names
  (prefixed, a cls token, `pos_embed` at another grid) loading through
  `backbone_state_dict`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtp_tpu.models import vit_rvsa as jv
from mtp_tpu.models.detector import DetConfig as JDetConfig
from mtp_tpu.models.detector import TwoStageDetector as JDetector
from mtp_tpu.ops import carafe as jcarafe
from mtp_tpu.utils.config import BackboneConfig
from mtp_tpu_torch.ckpt.from_jax import _conv, backbone_from_jax, detector_from_jax
from mtp_tpu_torch.ckpt.torch_convert import backbone_state_dict, load_torch_checkpoint
from mtp_tpu_torch.models.detector import DetConfig, TwoStageDetector
from mtp_tpu_torch.models.vit_rvsa import ViTRVSA
from mtp_tpu_torch.ops.carafe import CARAFEPack
from test_torch_port_mask_rcnn import _with_mask_head

torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-5


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _grads_close(got: dict, want: dict, rtol=1e-4):
    """Each gradient within rtol of its own norm plus 1e-6 of all of them."""
    g_all = np.sqrt(sum(float((w.double() ** 2).sum()) for w in want.values()))
    assert g_all > 0
    for name, w in want.items():
        diff = float((got[name] - w).norm())
        assert diff <= rtol * float(w.norm()) + 1e-6 * g_all, (name, diff, float(w.norm()))


# ----------------------------------------------------------------- CARAFE --

@pytest.mark.parametrize("hw", [(7, 7), (5, 9)])
def test_carafe_pack_matches_jax(hw):
    B, C = 3, 12
    x = _x((B,) + hw + (C,), 0)
    cot = _x((B, 2 * hw[0], 2 * hw[1], C), 1)
    mod = jcarafe.CARAFEPack(scale=2)
    params = jax.jit(mod.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    # flax initialises biases at 0: give the encoder's some spread
    params = jax.tree.map(jnp.asarray, params)
    params["content_encoder"]["bias"] = jnp.asarray(_x((100,), 2) * 0.5)

    def loss(p, x):
        y = mod.apply({"params": p}, x)
        return (y * cot).sum(), y

    (_, ref), (gp, gx) = jax.value_and_grad(loss, (0, 1), has_aux=True)(params, jnp.asarray(x))

    port = CARAFEPack(C, scale=2)
    sd = {}
    for name in ("channel_compressor", "content_encoder"):
        _conv(sd, name, params[name])
    port.load_state_dict(sd)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2)).requires_grad_()
    y = port(xt)
    np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 3, 1), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)
    (y * torch.from_numpy(cot.transpose(0, 3, 1, 2))).sum().backward()
    want = {}
    for name in ("channel_compressor", "content_encoder"):
        _conv(want, name, gp[name])
    want["x"] = torch.from_numpy(np.asarray(gx).transpose(0, 3, 1, 2))
    got = {n: p.grad for n, p in port.named_parameters()}
    got["x"] = xt.grad
    _grads_close(got, want)


def test_carafe_reassembly_is_the_box_mean_under_uniform_kernels():
    """Uniform kernels: each output pixel is the k×k box mean (zeros outside
    the map) of its source pixel, as JAX's `test_carafe_reassembly` holds."""
    from mtp_tpu_torch.ops.carafe import carafe_reassemble
    x = torch.from_numpy(_x((2, 3, 6, 5), 3))
    m = torch.full((2, 25, 12, 10), 1 / 25)
    out = carafe_reassemble(x, m, kernel=5, scale=2)
    box = torch.nn.functional.avg_pool2d(x, 5, stride=1, padding=2, count_include_pad=True)
    want = box.repeat_interleave(2, 2).repeat_interleave(2, 3)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6)


BB = BackboneConfig(img_size=64, patch_size=16, embed_dim=32, depth=2, num_heads=2,
                    interval=2, out_indices=(0, 0, 1, 1), dtype="float32",
                    drop_path_rate=0.0)
SMALL = dict(num_classes=3, nms_pre=256, max_proposals=64, rpn_num=64, rcnn_num=32,
             max_per_img=16, max_gts=8, with_mask=True, mask_upsample="carafe")
ROIS = np.array([[2, 3, 30, 40], [10, 10, 20, 18], [0, 0, 64, 64], [40, 5, 63, 60],
                 [16, 16, 48, 48]], np.float32)
ROI_BIDX = np.array([0, 1, 1, 0, 1], np.int32)


def test_mask_head_with_carafe_matches_jax():
    """The toy Mask R-CNN with `mask_upsample="carafe"`: the port's detector
    loads `detector_from_jax`'s state dict (strict, `roi_head.mask_head.
    upsample.{channel_compressor,content_encoder}` included), and its mask
    logits on given RoIs (28² from 14²) and their gradients equal JAX's.
    The weights are `test_torch_port_mask_rcnn`'s, non-zero biases
    included: with flax's zero biases, RoI features of zero put ReLU inputs
    at 0 up to rounding, where fp32 sums in two orders fall on either
    side."""
    det = JDetConfig(**SMALL)
    model = JDetector(BB, det)
    img = jnp.asarray(_x((2, 64, 64, 3), 4))
    params = _with_mask_head(jax.jit(model.init)(jax.random.PRNGKey(0), img[:1])["params"])
    assert "upsample_carafe" in params["mask_trunk"]
    cot = _x((len(ROIS), 28, 28, 3), 5)

    def loss(p):
        feats = model.apply({"params": p}, img, method=JDetector.features)
        logits = model.apply({"params": p}, feats, jnp.asarray(ROIS), jnp.asarray(ROI_BIDX),
                             method=JDetector.mask_head_logits)
        return (logits * cot).sum(), logits

    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    port = TwoStageDetector(BB, DetConfig(**SMALL))
    port.load_state_dict(detector_from_jax({"params": jax.tree.map(np.asarray, params)}, BB))
    feats = port.features(torch.from_numpy(np.asarray(img)))
    logits = port.mask_head_logits(feats, torch.from_numpy(ROIS), torch.from_numpy(ROI_BIDX))
    np.testing.assert_allclose(logits.detach().numpy().transpose(0, 2, 3, 1), np.asarray(ref),
                               atol=1e-4, rtol=1e-4)
    (logits * torch.from_numpy(cot.transpose(0, 3, 1, 2))).sum().backward()
    want = {k: v for k, v in detector_from_jax({"params": jax.tree.map(np.asarray, grads)},
                                               BB).items() if k.startswith("roi_head.mask_head.")}
    assert any(".upsample.content_encoder." in k for k in want)
    _grads_close({n: p.grad for n, p in port.named_parameters()}, want)


# -------------------------------------------------------------- patch 8 --

P8 = BackboneConfig(img_size=64, patch_size=8, embed_dim=32, depth=4, num_heads=2,
                    interval=2, out_indices=(0, 1, 2, 3), dtype="float32", drop_path_rate=0.0)


@pytest.fixture(scope="module")
def patch8():
    """JAX's patch-8 ViTRVSA (rel-pos tables randomised, non-zero FPN
    biases) and its levels and gradients on a 64×48 input."""
    x = _x((2, 64, 48, 3), 6)
    init = jax.jit(lambda k: jv.ViTRVSA(P8).init(k, jnp.zeros((1, 64, 48, 3))))
    params = jv.rescale_block_init(init(jax.random.PRNGKey(0))["params"], P8.depth)
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(a) + (rng.standard_normal(a.shape).astype(np.float32) * 0.1
                                          if path[-1].key in ("bias", "rel_pos_h", "rel_pos_w")
                                          else 0.0), params)
    cots = [_x((2, 64 // s, 48 // s, 32), 8 + i) for i, s in enumerate((4, 8, 16, 32))]

    def loss(p):
        levels = jv.ViTRVSA(P8).apply({"params": p}, jnp.asarray(x))
        return sum((lvl * c).sum() for lvl, c in zip(levels, cots)), levels

    (_, levels), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return dict(x=x, cots=cots, params=to_np(params), levels=to_np(levels), grads=to_np(grads))


def test_patch8_levels_and_gradients_match_jax(patch8):
    model = ViTRVSA(P8, input_hw=(64, 48))
    sd = backbone_from_jax(patch8["params"], P8)
    assert {k for k in sd if k.startswith("fpn")} == {"fpn1.0.weight", "fpn1.0.bias"}
    model.load_state_dict(sd)
    levels = model(torch.from_numpy(patch8["x"]))
    assert [tuple(lvl.shape[1:3]) for lvl in levels] == [(16, 12), (8, 6), (4, 3), (2, 1)]
    for got, want in zip(levels, patch8["levels"]):
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4, rtol=1e-4)
    sum((lvl * torch.from_numpy(c)).sum() for lvl, c in zip(levels, patch8["cots"])).backward()
    _grads_close({n: p.grad for n, p in model.named_parameters()},
                 backbone_from_jax(patch8["grads"], P8))


def test_patch8_state_dict_round_trips_and_a_pth_loads(patch8, tmp_path):
    """The port's state dict has exactly `backbone_from_jax`'s keys; a
    released-style `.pth` (`{"model": ...}`, keys prefixed `module.`, a
    cls token, `pos_embed` at a grid of 6²) loads through `backbone_state_dict` at the model's grid,
    `fpn1.0` as it is."""
    model = ViTRVSA(P8)
    sd = backbone_from_jax(patch8["params"], P8)
    assert set(sd) == set(model.state_dict())
    released = {"module." + k: v for k, v in sd.items()}
    released["module.cls_token"] = torch.zeros(1, 1, 32)
    released["module.pos_embed"] = torch.from_numpy(_x((1, 37, 32), 9))
    path = tmp_path / "patch8.pth"
    torch.save({"model": released}, path)
    loaded = backbone_state_dict(load_torch_checkpoint(str(path)), P8)
    model.load_state_dict(loaded)
    assert loaded["pos_embed"].shape == (1, 64, 32)
    for k in ("fpn1.0.weight", "fpn1.0.bias"):
        assert torch.equal(model.state_dict()[k], sd[k])
