"""Configuration dataclasses of the port.

The fields of `mtp_tpu/utils/config.py` that the ported slices read, copied
so that nothing in the port, `chip_smoke.py` included, imports the JAX
package.  `tests/test_torch_port_hygiene.py` holds each class and factory
field for field equal to its `mtp_tpu` counterpart; the port's modules read
only attributes, so they accept either.  The named recipes built from these
are in `mtp_tpu_torch/configs`.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class BackboneConfig:
    """ViT+RVSA backbone hyper-parameters (reference `vit_b_rvsa` /
    `vit_l_rvsa` factories); names starting `internimage` select InternImage
    (`internimage_config`)."""

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
    # the JAX package's layout switches: the port has one (unrolled) layout;
    # remat: torch.utils.checkpoint around each ViT block / InternImage layer
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
class InternImageConfig:
    """InternImage hyper-parameters (`mtp_tpu/models/internimage.py`; XL is
    the default: reference models.py:92-104)."""

    channels: int = 192
    depths: Tuple[int, ...] = (5, 5, 24, 5)
    groups: Tuple[int, ...] = (12, 24, 48, 96)
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.2
    layer_scale: Optional[float] = 1e-5
    offset_scale: float = 2.0
    post_norm: bool = True
    out_indices: Tuple[int, ...] = (0, 1, 2, 3)
    dtype: str = "bfloat16"
    # `remat` checkpoints every layer (torch.utils.checkpoint); `scan` and
    # `pallas_dcn` are the JAX package's layout and kernel switches, carried
    # so the copies stay equal: the port has one layout and its kernels
    remat: bool = False
    scan: bool = False
    pallas_dcn: bool = False


def internimage_xl() -> InternImageConfig:
    return InternImageConfig()


def internimage_t() -> InternImageConfig:
    return InternImageConfig(channels=64, depths=(4, 4, 18, 4),
                             groups=(4, 8, 16, 32), layer_scale=None,
                             offset_scale=1.0, post_norm=False,
                             drop_path_rate=0.1)


def internimage_backbone_config(variant: str = "internimage_xl",
                                img_size: int = 224, **kw) -> BackboneConfig:
    """A BackboneConfig shell for InternImage (`mtp_tpu/models/backbones.py`:
    the ViT fields are unused; depth is the total layer count, for layer
    decay)."""
    depths = (5, 5, 24, 5) if variant.endswith("xl") else (4, 4, 18, 4)
    return BackboneConfig(name=variant, img_size=img_size,
                          embed_dim=192 if variant.endswith("xl") else 64,
                          depth=sum(depths), num_heads=1, interval=10 ** 9,
                          out_indices=(0, 1, 2, 3), **kw)


def is_internimage(cfg) -> bool:
    return isinstance(cfg, InternImageConfig) or cfg.name.startswith("internimage")


def internimage_config(cfg) -> InternImageConfig:
    """The InternImage config a backbone config selects, as the JAX
    `build_backbone` maps it: XL or T by name, with the shell's dtype,
    drop-path rate and switches.  An InternImageConfig is returned as it is
    (the port's modules also take one directly, at any size)."""
    if isinstance(cfg, InternImageConfig):
        return cfg
    base = internimage_xl() if cfg.name.endswith("xl") else internimage_t()
    return replace(base, dtype=cfg.dtype, drop_path_rate=cfg.drop_path_rate,
                   remat=cfg.remat, scan=cfg.scan, pallas_dcn=cfg.pallas_attn)


@dataclass(frozen=True)
class SlideConfig:
    """Sliding-window inference geometry (finetune configs use crop 384/512,
    stride 256)."""

    crop: int = 512
    stride: int = 256


@dataclass(frozen=True)
class OptimizerConfig:
    """AdamW + layer decay + grad clip (reference main_pretrain.py:424-457,
    layer_decay_optimizer_constructor_vit.py)."""

    lr: float = 1e-4
    weight_decay: float = 0.05
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    layer_decay: float = 0.9
    clip_norm: float = 5.0


@dataclass(frozen=True)
class ScheduleConfig:
    """LR schedule: linear warmup then cosine, poly, constant or step."""

    kind: str = "cosine"  # cosine | poly | constant | step
    total_steps: int = 1000
    warmup_steps: int = 0
    warmup_ratio: float = 1e-6
    min_lr_ratio: float = 0.0
    poly_power: float = 1.0
    # kind='step': LR multiplied by step_gamma at each fraction of the
    # post-warmup steps
    step_milestones: tuple = (8 / 12, 11 / 12)
    step_gamma: float = 0.1


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh shape: `data` × `model` devices, the model's Megatron
    layers sharded over `model`.  The port runs one process a card
    (`parallel.mesh.make_mesh`: data × model must be the world size; `data`
    -1 is the world size over `model`)."""

    data: int = -1  # -1: all remaining devices
    model: int = 1


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 64  # global
    seed: int = 2023
    log_every: int = 50
    ckpt_every: int = 1000
    eval_every: int = 1000
    mesh: MeshConfig = field(default_factory=MeshConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    schedule: ScheduleConfig = field(default_factory=ScheduleConfig)


@dataclass(frozen=True)
class TaskConfig:
    """One downstream task recipe."""

    task: str = "classification"  # classification|segmentation|detection_h|detection_r|instseg|change_detection
    num_classes: int = 10
    backbone: BackboneConfig = field(default_factory=vit_b_rvsa)
    train: TrainConfig = field(default_factory=TrainConfig)
    slide: Optional[SlideConfig] = None
    ignore_index: int = 255


# SAMRS's class counts with the background: SOTA 18 + 1, SIOR 20 + 1, FAST
# 37 + 1 (`mtp_tpu/models/multitask.py`; reference main_pretrain.py:150-157
# with --background True)
SAMRS_CLASSES = (19, 21, 38)


@dataclass(frozen=True)
class RetinaConfig:
    """RetinaNet's hyper-parameters (`mtp_tpu/models/retinanet.py`; reference
    retinanet_rvsa_l_416_mae_mtp_xview.py:227-268): the 4-conv RetinaHead,
    anchors of octave base scale 4, 3 scales an octave and ratios 0.5, 1, 2
    on strides 8-128, focal loss (γ 2, α 0.25) and L1, MaxIoUAssigner
    0.5 / 0.4, test NMS at 0.5 keeping 100."""

    num_classes: int = 60
    stacked_convs: int = 4
    feat_channels: int = 256
    octave_base_scale: float = 4.0
    scales_per_octave: int = 3
    ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    pos_iou: float = 0.5
    neg_iou: float = 0.4
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    score_thr: float = 0.05
    nms_pre: int = 1000
    nms_iou: float = 0.5
    max_per_img: int = 100
    max_gts: int = 100
