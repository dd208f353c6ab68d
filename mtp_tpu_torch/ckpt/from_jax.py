"""JAX parameters → the port's state_dict, and the port's random init.

Pure numpy: the inverse of `mtp_tpu/ckpt/torch_convert.py` `convert_backbone`
and `convert_internimage` and of `mtp_tpu/ckpt/full_convert.py`
`convert_upernet_head`, `convert_unet_head` and `convert_linear_head`
(which import jax, so they cannot run where the port does).  The backbone
family follows the config (`backbone_from_jax`: a BackboneConfig by its
name, or an InternImageConfig).  Layout maps (flax → torch):
- Dense kernel (in, out)            → Linear weight (out, in)
- Conv kernel (kh, kw, in/groups, out) → Conv2d weight (out, in/groups, kh, kw)
- ConvTranspose kernel (kh, kw, in, out) → ConvTranspose2d weight
  (in, out, kh, kw) with the spatial dims flipped back
- LayerNorm / BatchNorm scale       → weight; batch_stats mean/var →
  running_mean / running_var
- Dense regressor (in, out)         → 1×1 Conv2d weight (out, in, 1, 1)

Every map is a permutation of elements (transposes, reshapes, flips), so
the same functions carry anything shaped like the parameters — gradients,
Adam moments — to the port's parameter names (`params_from_jax`,
`opt_state_from_jax`).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from mtp_tpu_torch.config import (BackboneConfig, InternImageConfig,
                                  internimage_config, is_internimage)
from mtp_tpu_torch.models.internimage import InternImage, InternImageLayer
from mtp_tpu_torch.models.vit_rvsa import ViTRVSA

StateDict = Dict[str, torch.Tensor]


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))  # a writable copy


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def unscan_blocks(params: dict, depth: int, interval: int) -> dict:
    """Inverse of `to_scan_layout`: block_groups/{rvsa_p, full}/... with a
    leading group axis → blocks_i."""
    out = {k: v for k, v in params.items() if k != "block_groups"}
    groups = params["block_groups"]
    for pos in range(interval):
        name = "full" if pos == interval - 1 else f"rvsa_{pos}"
        for g in range(depth // interval):
            out[f"blocks_{g * interval + pos}"] = _map_tree(
                groups[name], lambda leaf, g=g: _np(leaf)[g])
    return out


def _dense(sd: dict, dst: str, p: dict) -> None:
    sd[dst + ".weight"] = _tensor(_np(p["kernel"]).T)
    if "bias" in p:
        sd[dst + ".bias"] = _tensor(p["bias"])


def _norm(sd: dict, dst: str, p: dict) -> None:
    sd[dst + ".weight"] = _tensor(p["scale"])
    sd[dst + ".bias"] = _tensor(p["bias"])


def _conv(sd: dict, dst: str, p: dict) -> None:
    sd[dst + ".weight"] = _tensor(_np(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[dst + ".bias"] = _tensor(p["bias"])


def _deconv(sd: dict, dst: str, p: dict) -> None:
    w = _np(p["kernel"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    sd[dst + ".weight"] = _tensor(w)
    sd[dst + ".bias"] = _tensor(p["bias"])


def attention_from_jax(a: dict, full: bool) -> StateDict:
    """`FullAttention` / `RVSAAttention` params → the port module's
    state_dict."""
    sd: StateDict = {}
    _dense(sd, "qkv", a["qkv"])
    _dense(sd, "proj", a["proj"])
    if full:
        sd["full_attn_rel_pos_h"] = _tensor(a["rel_pos_h"])
        sd["full_attn_rel_pos_w"] = _tensor(a["rel_pos_w"])
        return sd
    sd["rel_pos_h"] = _tensor(a["rel_pos_h"])
    sd["rel_pos_w"] = _tensor(a["rel_pos_w"])
    sd["relative_position_bias_table"] = _tensor(a["relative_position_bias_table"])
    for name in ("sampling_offsets", "sampling_scales", "sampling_angles"):
        k = _np(a[name]["kernel"]).T  # (out, in)
        sd[name + ".2.weight"] = _tensor(k[:, :, None, None])
        sd[name + ".2.bias"] = _tensor(a[name]["bias"])
    return sd


def block_from_jax(blk: dict, full: bool) -> StateDict:
    """`Block` params → the port `Block`'s state_dict."""
    sd: StateDict = {}
    _norm(sd, "norm1", blk["norm1"])
    _norm(sd, "norm2", blk["norm2"])
    _dense(sd, "mlp.fc1", blk["mlp"]["fc1"])
    _dense(sd, "mlp.fc2", blk["mlp"]["fc2"])
    for g in ("gamma_1", "gamma_2"):
        if g in blk:
            sd[g] = _tensor(blk[g])
    sd.update({"attn." + k: v for k, v in attention_from_jax(blk["attn"], full).items()})
    return sd


def unscan_stages(params: dict, depths) -> dict:
    """Inverse of `to_stage_scan_layout`: stage{s}_layers/l/... with a
    leading layer axis → stage{s}_layer{i}."""
    out = {k: v for k, v in params.items() if not k.endswith("_layers")}
    for s, depth in enumerate(depths):
        stacked = params[f"stage{s}_layers"]["l"]
        for i in range(depth):
            out[f"stage{s}_layer{i}"] = _map_tree(stacked,
                                                  lambda leaf, i=i: _np(leaf)[i])
    return out


def dcnv3_from_jax(dcn: dict) -> StateDict:
    """`DCNv3` params → the port `DCNv3`'s state_dict."""
    sd: StateDict = {}
    _conv(sd, "dw_conv.0", dcn["dw_conv"])
    _norm(sd, "dw_conv.1.1", dcn["dw_norm"])
    for lin in ("offset", "mask", "input_proj", "output_proj"):
        _dense(sd, lin, dcn[lin])
    return sd


def internimage_layer_from_jax(layer: dict) -> StateDict:
    """`InternImageLayer` params → the port layer's state_dict."""
    sd: StateDict = {}
    for g in ("gamma1", "gamma2"):
        if g in layer:
            sd[g] = _tensor(layer[g])
    _norm(sd, "norm1.0", layer["norm1"])
    _norm(sd, "norm2.0", layer["norm2"])
    _dense(sd, "mlp.fc1", layer["mlp"]["fc1"])
    _dense(sd, "mlp.fc2", layer["mlp"]["fc2"])
    sd.update({"dcn." + k: v for k, v in dcnv3_from_jax(layer["dcn"]).items()})
    return sd


def internimage_from_jax(params: dict, cfg: InternImageConfig) -> StateDict:
    """`InternImage` params (unrolled `stage{s}_layer{i}` or scanned
    `stage{s}_layers/l`) → the port's `InternImage` state_dict, the inverse
    of `mtp_tpu/ckpt/torch_convert.py` `convert_internimage`."""
    p = params.get("params", params)
    if "stage0_layers" in p:
        p = unscan_stages(p, cfg.depths)
    sd: StateDict = {}
    _conv(sd, "patch_embed.conv1", p["stem_conv1"])
    _norm(sd, "patch_embed.norm1.1", p["stem_norm1"])
    _conv(sd, "patch_embed.conv2", p["stem_conv2"])
    _norm(sd, "patch_embed.norm2.1", p["stem_norm2"])
    for s, depth in enumerate(cfg.depths):
        for i in range(depth):
            layer = internimage_layer_from_jax(p[f"stage{s}_layer{i}"])
            sd.update({f"levels.{s}.blocks.{i}.{k}": v for k, v in layer.items()})
        if f"stage{s}_norm" in p:
            _norm(sd, f"levels.{s}.norm.0", p[f"stage{s}_norm"])
        if f"down{s}_conv" in p:
            _conv(sd, f"levels.{s}.downsample.conv", p[f"down{s}_conv"])
            _norm(sd, f"levels.{s}.downsample.norm.1", p[f"down{s}_norm"])
    return sd


def backbone_from_jax(params: dict, cfg: BackboneConfig) -> StateDict:
    """`ViTRVSA` params (unrolled `blocks_i` or scanned `block_groups`)
    → the port's `ViTRVSA` state_dict; InternImage configs go to
    `internimage_from_jax`."""
    if is_internimage(cfg):
        return internimage_from_jax(params, internimage_config(cfg))
    p = params.get("params", params)
    if "block_groups" in p:
        p = unscan_blocks(p, cfg.depth, cfg.interval)
    sd: StateDict = {}
    _conv(sd, "patch_embed.proj", p["patch_embed"])
    if "pos_embed" in p:
        pe = _np(p["pos_embed"])
        sd["pos_embed"] = _tensor(pe.reshape(1, -1, pe.shape[-1]))
    for i in range(cfg.depth):
        full = (i + 1) % cfg.interval == 0
        for k, v in block_from_jax(p[f"blocks_{i}"], full).items():
            sd[f"blocks.{i}.{k}"] = v
    if "fpn" in p:  # a ViT applied `features_only` has none
        fpn = p["fpn"]
        _deconv(sd, "fpn1.0", fpn["fpn1_deconv1"])
        _norm(sd, "fpn1.1.ln", fpn["fpn1_norm"]["ln"])
        _deconv(sd, "fpn1.3", fpn["fpn1_deconv2"])
        _deconv(sd, "fpn2.0", fpn["fpn2_deconv1"])
    return sd


def _batchnorm(sd: dict, dst: str, p: dict, s: dict) -> None:
    _norm(sd, dst, p)
    sd[dst + ".running_mean"] = _tensor(s["mean"])
    sd[dst + ".running_var"] = _tensor(s["var"])
    sd[dst + ".num_batches_tracked"] = torch.tensor(0)


def _convmodule(sd: dict, dst: str, p: dict, s: dict) -> None:
    _conv(sd, dst + ".conv", p["conv"])
    _batchnorm(sd, dst + ".bn", p["bn"], s["bn"])


def upernet_from_jax(params: dict, batch_stats: dict) -> StateDict:
    """`UperNetHead` params + batch_stats → the port's `UperNetHead`
    state_dict (mmseg names, no prefix)."""
    sd: StateDict = {}
    psp, psp_s = params["psp"], batch_stats["psp"]
    k = 0
    while f"pool_{k}" in psp:
        _convmodule(sd, f"psp_modules.{k}.1", psp[f"pool_{k}"], psp_s[f"pool_{k}"])
        k += 1
    _convmodule(sd, "bottleneck", psp["bottleneck"], psp_s["bottleneck"])
    i = 0
    while f"lateral_{i}" in params:
        _convmodule(sd, f"lateral_convs.{i}", params[f"lateral_{i}"],
                    batch_stats[f"lateral_{i}"])
        _convmodule(sd, f"fpn_convs.{i}", params[f"fpn_{i}"],
                    batch_stats[f"fpn_{i}"])
        i += 1
    _convmodule(sd, "fpn_bottleneck", params["fpn_bottleneck"],
                batch_stats["fpn_bottleneck"])
    _conv(sd, "conv_seg", params["conv_seg"])
    return sd


def segmentor_from_jax(variables: dict, cfg: BackboneConfig) -> StateDict:
    """JAX `Segmentor` variables {"params", "batch_stats"} → the port's
    `Segmentor` state_dict."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd = {"backbone." + k: v
          for k, v in backbone_from_jax(params["backbone"], cfg).items()}
    sd.update({"decode_head." + k: v for k, v in upernet_from_jax(
        params["decode_head"], stats["decode_head"]).items()})
    return sd


def linear_head_from_jax(params: dict) -> StateDict:
    """`LinearClsHead` params → the port's `LinearClsHead` state_dict."""
    sd: StateDict = {}
    _dense(sd, "fc", params["fc"])
    return sd


def classifier_from_jax(variables: dict, cfg: BackboneConfig) -> StateDict:
    """JAX `ImageClassifier` variables {"params"} → the port's
    `ImageClassifier` state_dict."""
    params = variables["params"]
    sd = {"backbone." + k: v
          for k, v in backbone_from_jax(params["backbone"], cfg).items()}
    sd.update({"head." + k: v for k, v in linear_head_from_jax(params["head"]).items()})
    return sd


def unet_from_jax(params: dict, batch_stats: dict) -> StateDict:
    """`UNetHead` params + batch_stats → the port's `UNetHead` state_dict
    (open-cd names, no prefix)."""
    sd: StateDict = {}
    i = 0
    while f"block_{i}" in params:
        for c in ("conv1", "conv2"):
            p, s = params[f"block_{i}"][c], batch_stats[f"block_{i}"][c]
            _conv(sd, f"blocks.{i}.{c}.0", p["conv"])
            _batchnorm(sd, f"blocks.{i}.{c}.1", p["bn"], s["bn"])
        i += 1
    _conv(sd, "conv_seg", params["conv_seg"])
    return sd


def change_detector_from_jax(variables: dict, cfg: BackboneConfig) -> StateDict:
    """JAX `SiamChangeDetector` variables {"params", "batch_stats"} → the
    port's `SiamChangeDetector` state_dict."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd = {"backbone." + k: v
          for k, v in backbone_from_jax(params["backbone"], cfg).items()}
    sd.update({"decode_head." + k: v for k, v in unet_from_jax(
        params["decode_head"], stats["decode_head"]).items()})
    return sd


def _dense_chw(sd: dict, dst: str, p: dict, spatial: int) -> None:
    """A Dense over HWC-flattened (s, s, C) RoI features → a Linear over
    CHW-flattened (C, s, s) ones: the inverse of `mtp_tpu/ckpt/full_convert.py`
    `_dense_hwc`."""
    k = _np(p["kernel"])                       # (s·s·C, out)
    out = k.shape[1]
    k = k.reshape(spatial, spatial, -1, out).transpose(3, 2, 0, 1)
    sd[dst + ".weight"] = _tensor(k.reshape(out, -1))
    sd[dst + ".bias"] = _tensor(p["bias"])


def _neck(sd: dict, neck: dict) -> None:
    """`FPN` params → `neck.lateral_convs.{i}.conv` and `neck.fpn_convs.{i}
    .conv`, the extra convolutions (`fpn_conv_i` past the laterals)
    included."""
    i = 0
    while f"fpn_conv_{i}" in neck:
        if f"lateral_{i}" in neck:
            _conv(sd, f"neck.lateral_convs.{i}.conv", neck[f"lateral_{i}"])
        _conv(sd, f"neck.fpn_convs.{i}.conv", neck[f"fpn_conv_{i}"])
        i += 1


def detector_from_jax(variables: dict, cfg, roi_size: int = 7) -> StateDict:
    """JAX `TwoStageDetector` variables {"params"} → the port's
    `TwoStageDetector` state_dict (mmdet names: `neck.lateral_convs.{i}.conv`,
    `neck.fpn_convs.{i}.conv`, `rpn_head.*`, `roi_head.bbox_head.*` and,
    with a mask head, `roi_head.mask_head.*`); `cfg` is the backbone's
    config."""
    params = variables.get("params", variables)
    sd = {"backbone." + k: v
          for k, v in backbone_from_jax(params["backbone"], cfg).items()}
    _neck(sd, params["neck"])
    for name in ("rpn_conv", "rpn_cls", "rpn_reg"):
        _conv(sd, f"rpn_head.{name}", params["rpn_head"][name])
    head = "roi_head.bbox_head."
    _dense_chw(sd, head + "shared_fcs.0", params["bbox_trunk"]["fc1"], roi_size)
    _dense(sd, head + "shared_fcs.1", params["bbox_trunk"]["fc2"])
    _dense(sd, head + "fc_cls", params["fc_cls"])
    _dense(sd, head + "fc_reg", params["fc_reg"])
    if "mask_trunk" in params:
        trunk, head = params["mask_trunk"], "roi_head.mask_head."
        i = 0
        while f"conv_{i}" in trunk:
            _conv(sd, f"{head}convs.{i}.conv", trunk[f"conv_{i}"])
            i += 1
        if "upsample" in trunk:
            _deconv(sd, head + "upsample", trunk["upsample"])
        _conv(sd, head + "conv_logits", params["conv_logits"])
    return sd


def retinanet_from_jax(variables: dict, cfg) -> StateDict:
    """JAX `RetinaNet` variables {"params"} → the port's `RetinaNet`
    state_dict (mmdet names: `neck.*` with the extra convolutions as
    `neck.fpn_convs.{3,4}.conv`, `bbox_head.cls_convs.{i}.conv`,
    `bbox_head.reg_convs.{i}.conv`, `bbox_head.retina_cls`,
    `bbox_head.retina_reg`); `cfg` is the backbone's config."""
    params = variables.get("params", variables)
    sd = {"backbone." + k: v
          for k, v in backbone_from_jax(params["backbone"], cfg).items()}
    _neck(sd, params["neck"])
    i = 0
    while f"cls_conv_{i}" in params:
        _conv(sd, f"bbox_head.cls_convs.{i}.conv", params[f"cls_conv_{i}"])
        _conv(sd, f"bbox_head.reg_convs.{i}.conv", params[f"reg_conv_{i}"])
        i += 1
    _conv(sd, "bbox_head.retina_cls", params["retina_cls"])
    _conv(sd, "bbox_head.retina_reg", params["retina_reg"])
    return sd


_BN_BUFFERS = (".running_mean", ".running_var", ".num_batches_tracked")


def params_from_jax(tree: dict, batch_stats: dict, cfg: BackboneConfig) -> StateDict:
    """A pytree shaped like the JAX `Segmentor`'s params (the params, their
    gradients, an Adam moment) → {port parameter name: tensor}, through
    `segmentor_from_jax` (batch_stats only fills the BatchNorm buffers,
    which are dropped)."""
    sd = segmentor_from_jax({"params": tree, "batch_stats": batch_stats}, cfg)
    return {k: v for k, v in sd.items() if not k.endswith(_BN_BUFFERS)}


def opt_state_from_jax(opt_state, batch_stats: dict, cfg: BackboneConfig):
    """The optax state of `mtp_tpu.core.optim.make_optimizer` (a chain whose
    second entry is `ScaleByAdamState(count, mu, nu)`) → (count, {port
    parameter name: (exp_avg, exp_avg_sq)}), the torch AdamW state that
    `LayerDecayAdamW.load_moments` takes."""
    adam = opt_state[1]
    mu = params_from_jax(adam.mu, batch_stats, cfg)
    nu = params_from_jax(adam.nu, batch_stats, cfg)
    return int(np.asarray(adam.count)), {k: (mu[k], nu[k]) for k in mu}


# ------------------------------------------------------------------ init --

_LECUN_STD = 0.87962566103423978  # std of the unit normal truncated at ±2


def _trunc_normal(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=gen)


def _lecun(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's default kernel init: truncated normal, variance 1/fan_in."""
    _trunc_normal(t, math.sqrt(1.0 / fan_in) / _LECUN_STD, gen)


def _init_internimage(model: InternImage, generator: torch.Generator) -> None:
    """InternImage's initialisers (`mtp_tpu/ops/dcnv3.py` DCNv3 and the flax
    defaults): xavier-uniform on the DCNv3 projections, zeros on the offset
    and mask regressors, lecun-normal on the MLP Dense layers and on every
    conv, zero biases, unit LayerNorms; the layer-scale gammas keep the
    config's value."""
    for name, mod in model.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(mod, nn.Linear):
            if leaf in ("input_proj", "output_proj"):
                nn.init.xavier_uniform_(mod.weight, generator=generator)
            elif leaf in ("offset", "mask"):
                mod.weight.zero_()
            else:
                _lecun(mod.weight, mod.in_features, generator)
        elif isinstance(mod, nn.Conv2d):  # fan_in kh·kw·in/groups: 9 depthwise
            _lecun(mod.weight, mod.weight[0].numel(), generator)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
        if isinstance(getattr(mod, "bias", None), torch.Tensor):
            mod.bias.zero_()
    for layer in (m for m in model.modules() if isinstance(m, InternImageLayer)):
        if layer.gamma1 is not None:
            layer.gamma1.fill_(model.cfg.layer_scale)
            layer.gamma2.fill_(model.cfg.layer_scale)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights drawn as the JAX modules draw them (not the same
    numbers).  ViT+RVSA and the head: trunc-normal(0.02) on every Dense-like
    weight (a detector's box head: flax's lecun-normal), the regressors, `pos_embed` and the Swin bias table
    (vit_rvsa.py:47-48); zeros on the decomposed rel-pos tables; flax's
    lecun-normal on convolutions; zero biases, except a module's
    `bias_prior` where it names one (RetinaNet's classifier); unit norms;
    then `rescale_block_init` (vit_rvsa.py:490-518).  BatchNorm keeps
    running mean 0 and variance 1.  InternImage: `_init_internimage`."""
    internimages = [m for m in model.modules() if isinstance(m, InternImage)]
    for ii in internimages:
        _init_internimage(ii, generator)
    inner = {id(m) for ii in internimages for m in ii.modules()}
    for name, mod in model.named_modules():
        if id(mod) in inner:
            continue
        if isinstance(mod, nn.Linear) and name.startswith("roi_head."):
            _lecun(mod.weight, mod.in_features, generator)  # flax's Dense default
        elif isinstance(mod, nn.Linear):
            _trunc_normal(mod.weight, 0.02, generator)
        elif isinstance(mod, nn.Conv2d) and ".sampling_" in name:
            _trunc_normal(mod.weight, 0.02, generator)
        elif isinstance(mod, nn.Conv2d):
            fan_in = mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
            _lecun(mod.weight, fan_in, generator)
        elif isinstance(mod, nn.ConvTranspose2d):
            # flax ConvTranspose: fan_in = kh·kw·in (kernel (kh, kw, in, out))
            _lecun(mod.weight, mod.in_channels * mod.kernel_size[0]
                   * mod.kernel_size[1], generator)
        elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
            mod.weight.fill_(1.0)
        if getattr(mod, "bias", None) is not None and \
                isinstance(mod.bias, torch.Tensor):
            mod.bias.fill_(getattr(mod, "bias_prior", 0.0))
    for name, prm in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("pos_embed", "relative_position_bias_table"):
            _trunc_normal(prm, 0.02, generator)
        elif "rel_pos_" in leaf:
            prm.zero_()
    for vit in (m for m in model.modules() if isinstance(m, ViTRVSA)):
        for i, blk in enumerate(vit.blocks):
            r = 1.0 / math.sqrt(2.0 * (i + 1))
            blk.attn.proj.weight.mul_(r)
            blk.mlp.fc2.weight.mul_(r)
    return model
