"""Configuration dataclasses of the port.

The fields of `mtp_tpu/utils/config.py` that the ported slices read, copied
so that nothing in the port, `chip_smoke.py` included, imports the JAX
package.  `tests/test_torch_port_hygiene.py` holds each class and factory
field for field equal to its `mtp_tpu` counterpart; the port's modules read
only attributes, so they accept either.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class BackboneConfig:
    """ViT+RVSA backbone hyper-parameters (reference `vit_b_rvsa` /
    `vit_l_rvsa` factories)."""

    name: str = "vit_b_rvsa"
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    # every `interval`-th block (1-indexed) is full attention, rest are RVSA
    interval: int = 3
    window_size: int = 7
    out_indices: Tuple[int, ...] = (3, 5, 7, 11)
    drop_path_rate: float = 0.1
    drop_rate: float = 0.0
    use_abs_pos_emb: bool = True
    init_values: Optional[float] = None
    # the JAX package's training and layout switches; inference ignores them
    remat: bool = False
    scan: bool = False
    pallas_attn: bool = False
    dtype: str = "bfloat16"


def vit_b_rvsa(img_size: int = 224, **kw) -> BackboneConfig:
    kw.setdefault("out_indices", (3, 5, 7, 11))
    return BackboneConfig(
        name="vit_b_rvsa", img_size=img_size, embed_dim=768, depth=12,
        num_heads=12, interval=3, **kw)


def vit_l_rvsa(img_size: int = 224, **kw) -> BackboneConfig:
    kw.setdefault("out_indices", (7, 11, 15, 23))
    return BackboneConfig(
        name="vit_l_rvsa", img_size=img_size, embed_dim=1024, depth=24,
        num_heads=16, interval=6, **kw)


@dataclass(frozen=True)
class SlideConfig:
    """Sliding-window inference geometry (finetune configs use crop 384/512,
    stride 256)."""

    crop: int = 512
    stride: int = 256
