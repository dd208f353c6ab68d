"""Loading a released-style PyTorch backbone checkpoint into the port.

The port's copy of the loading rules of `mtp_tpu/ckpt/torch_convert.py`
(which imports jax), held equal to it by `tests/test_torch_port_ckpt.py`:
- prefix surgery: `module.`, then `encoder.` only when every key has it (a
  full pretrain state dict keeps its `encoder.*`/decoder split);
- `{state_dict}` / `{model}` / raw checkpoint dicts;
- the ViT's absolute `pos_embed`: the MAE cls token dropped when the dict
  has a `cls_token`, then a bicubic resize of the token table to the
  target grid;
- the full-attention blocks' `full_attn_rel_pos_h/w` tables: a bicubic
  resize to 2g − 1 rows (the windowed blocks' tables do not depend on the
  grid).
Both resizes are torch's own `F.interpolate`, as on the JAX side.  The port
uses the reference parameter names, so after these rules a dict loads into
`ViTRVSA` / `InternImage` as it is (`backbone_state_dict`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from mtp_tpu_torch.config import is_internimage
from mtp_tpu_torch.models.backbones import build_backbone

StateDict = Dict[str, torch.Tensor]


def strip_prefixes(sd: dict) -> dict:
    """`module.` then `encoder.` prefix surgery (reference loaders and
    scripts/change_ckpt.py): `encoder.` goes only when every key has it."""
    keys = sorted(sd)
    if keys and keys[0].startswith("module."):
        sd = {k[len("module."):]: v for k, v in sd.items()}
        keys = sorted(sd)
    if keys and all(k.startswith("encoder.") for k in keys):
        sd = {k[len("encoder."):]: v for k, v in sd.items()}
    return sd


def unwrap_checkpoint(ckpt: dict) -> dict:
    """A `{state_dict: ...}`, `{model: ...}` or raw checkpoint dict → its
    state dict, prefixes stripped."""
    if "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    elif "model" in ckpt:
        ckpt = ckpt["model"]
    return strip_prefixes(dict(ckpt))


def load_torch_checkpoint(path: str) -> StateDict:
    """A released `.pth` (or the port's encoder artifact) → its state dict.
    Released checkpoints carry pickled objects beside the tensors, so this
    unpickles: load only files from a source you trust."""
    return unwrap_checkpoint(torch.load(path, map_location="cpu",
                                        weights_only=False))


def _bicubic(t: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bicubic resize of a (1, C, h, w) tensor, in fp32."""
    return F.interpolate(t.float(), size=size, mode="bicubic",
                         align_corners=False)


def convert_pos_embed(pe: torch.Tensor, grid: Tuple[int, int],
                      has_cls_token: bool) -> torch.Tensor:
    """(1, N (+1), D) pos_embed of a square token grid → (1, H·W, D) for the
    target grid (H, W), fp32."""
    tokens = pe.detach().cpu().float()[:, 1 if has_cls_token else 0:]
    d = tokens.shape[-1]
    orig = int(round(tokens.shape[1] ** 0.5))
    if (orig, orig) != tuple(grid):
        tokens = _bicubic(tokens.reshape(1, orig, orig, d).permute(0, 3, 1, 2),
                          tuple(grid)).permute(0, 2, 3, 1)
    return tokens.reshape(1, -1, d).contiguous()


def convert_rel_pos_table(tbl: torch.Tensor, new_len: int) -> torch.Tensor:
    """(L, C) decomposed rel-pos table → (new_len, C), bicubic on both axes
    as the finetune loader does (a no-op on C), fp32."""
    tbl = tbl.detach().cpu().float()
    if tbl.shape[0] == new_len:
        return tbl
    return _bicubic(tbl[None, None], (new_len, tbl.shape[1]))[0, 0]


def _ignored(key: str, features_only: bool) -> bool:
    """Keys with no counterpart in the port's module, as JAX's
    `convert_backbone` ignores them: the MAE cls token, the final `norm.*`
    (defined but unused in the reference forward), and the simple FPN of a
    ViT built `features_only`."""
    return (key == "cls_token" or key.startswith("norm.")
            or (features_only and key.startswith("fpn")))


def backbone_state_dict(sd: dict, cfg, grid: Optional[Tuple[int, int]] = None,
                        features_only: bool = False) -> StateDict:
    """A reference-name backbone state dict (a released `.pth`'s, a port
    encoder artifact's, or `ckpt.store.load_encoder`'s) → the fp32 state
    dict that the backbone of `cfg`, built for the token `grid` (default
    img_size / patch_size; `features_only`: the ViT without its FPN), loads
    with strict=True.

    Prefixes are stripped; the ViT's `pos_embed` and full-attention tables
    are resized to the grid.  Exactly the keys `_ignored` names are dropped;
    a key the model has not got, or lacks, raises KeyError, and a tensor of
    another shape ValueError."""
    sd = strip_prefixes(dict(sd))
    has_cls = "cls_token" in sd
    sd = {k: torch.as_tensor(v).detach().cpu().float() for k, v in sd.items()
          if not _ignored(k, features_only)}
    hw = None
    if not is_internimage(cfg):
        p = cfg.patch_size
        g = tuple(grid or (cfg.img_size // p,) * 2)
        hw = (g[0] * p, g[1] * p)
        if "pos_embed" in sd:
            sd["pos_embed"] = convert_pos_embed(sd["pos_embed"], g, has_cls)
        for k in sd:
            for axis, n in (("h", g[0]), ("w", g[1])):
                if k.endswith("attn.full_attn_rel_pos_" + axis):
                    sd[k] = convert_rel_pos_table(sd[k], 2 * n - 1)
    with torch.device("meta"):  # names and shapes only: no memory, no init
        want = build_backbone(cfg, hw, features_only=features_only).state_dict()
    missing, unexpected = sorted(set(want) - set(sd)), sorted(set(sd) - set(want))
    if missing or unexpected:
        raise KeyError(f"backbone checkpoint: missing {missing[:8]} ({len(missing)}), "
                       f"unexpected {unexpected[:8]} ({len(unexpected)})")
    for k, v in sd.items():
        if v.shape != want[k].shape:
            raise ValueError(f"backbone checkpoint: {k} is {tuple(v.shape)}, the "
                             f"model's {tuple(want[k].shape)}")
    return sd


# the reference builds its multitask UPerHead with one class and never runs
# its conv_seg (the per-dataset `semseghead_*` replace it; mtp_tpu/ckpt/
# full_convert.py drops it as well)
UNUSED_MULTITASK_KEYS = ("semsegdecoder.decode_head.conv_seg.weight",
                         "semsegdecoder.decode_head.conv_seg.bias")


def multitask_state_dict(sd: dict) -> StateDict:
    """A released full MTP pretraining checkpoint's state dict (reference
    main_pretrain.py:823-829, `load_torch_checkpoint` of its `.pth`) → the
    port's `MultiTaskPretrainModel` state dict: the same names, less the
    UPerHead's unused 1-class conv_seg."""
    return {k: v for k, v in sd.items() if k not in UNUSED_MULTITASK_KEYS}
