"""Configuration dataclasses of the port.

The fields of `mtp_tpu/utils/config.py` that the ported slices read, copied
so that nothing in the port, `chip_smoke.py` included, imports the JAX
package.  `tests/test_torch_port_hygiene.py` holds each class and factory
field for field equal to its `mtp_tpu` counterpart; the port's modules read
only attributes, so they accept either.
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
    """Device mesh shape of the JAX package.  The port runs on one device:
    it carries the field so the copies stay equal, and raises on any mesh
    other than data, model in {1, -1} (`check_single_device`)."""

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


def check_single_device(mesh: MeshConfig) -> None:
    """The port runs on one device (data-parallel training is not ported
    yet): any mesh axis other than 1 or -1 raises."""
    for axis in ("data", "model"):
        if getattr(mesh, axis) not in (1, -1):
            raise NotImplementedError(
                f"mesh {axis}={getattr(mesh, axis)}: the port runs on one "
                f"device (DDP is not ported yet)")


def _vit_l(img_size: int) -> BackboneConfig:
    """`mtp_tpu.configs._bb("rvsa_l", img_size)`."""
    return vit_l_rvsa(img_size, drop_path_rate=0.3, scan=True,
                      out_indices=(7, 11, 15, 23))


def _intern_xl(img_size: int) -> BackboneConfig:
    """`mtp_tpu.configs._internimage_xl(img_size)`: remat and scan on."""
    return internimage_backbone_config("internimage_xl", img_size, remat=True,
                                       scan=True)


def rvsa_l_upernet_384_spacenetv1() -> TaskConfig:
    """The recipe `rvsa-l-upernet-384-mae-mtp-spacenetv1` (and its `-mae-`
    twin, which differs only in the checkpoint it loads): ViT-L+RVSA at
    384² (`mtp_tpu.configs._bb("rvsa_l", 384)`) → UperNet, 2 classes, with
    the segmentation recipe shape (`mtp_tpu.configs._seg`; reference mmseg
    config spacenetv1/rvsa-l-upernet-384-...py:92-114: AdamW 6e-5, layer
    decay 0.9, no clipping, LinearLR 1500 iters + CosineAnnealingLR to 80k,
    batch 8, slide eval stride 256)."""
    return TaskConfig(
        task="segmentation", num_classes=2,
        backbone=_vit_l(384),
        train=TrainConfig(
            batch_size=8,
            optimizer=OptimizerConfig(lr=6e-5, weight_decay=0.05,
                                      layer_decay=0.9, clip_norm=0.0),
            schedule=ScheduleConfig(kind="cosine", total_steps=80000,
                                    warmup_steps=1500)),
        slide=SlideConfig(crop=384, stride=256))


def intern_xl_upernet_512_loveda() -> TaskConfig:
    """The recipe `intern-xl-upernet-512-imp-mtp-loveda` (and its `-imp-`
    twin): InternImage-XL at 512² (`mtp_tpu.configs._internimage_xl`: remat
    and scan on, drop-path 0.1, the BackboneConfig default) → UperNet, 7
    classes (LoveDA), with the segmentation recipe shape (`_seg`) and the
    InternImage optimizer point (`_ii_opt`: AdamW 2e-5, layer decay 0.94);
    batch 8, slide eval with 512² crops at stride 256."""
    return TaskConfig(
        task="segmentation", num_classes=7,
        backbone=_intern_xl(512),
        train=TrainConfig(
            batch_size=8,
            optimizer=OptimizerConfig(lr=2e-5, weight_decay=0.05,
                                      layer_decay=0.94, clip_norm=0.0),
            schedule=ScheduleConfig(kind="cosine", total_steps=80000,
                                    warmup_steps=1500)),
        slide=SlideConfig(crop=512, stride=256))


def _cls_recipe(backbone: BackboneConfig, lr: float = 6e-5,
                layer_decay: float = 0.9) -> TaskConfig:
    """The EuroSAT scene-classification recipe shape (`mtp_tpu.configs._cls`;
    reference mmpretrain eurosat/vit-rvsa-l-224-mae-mtp_eurosat.py:61-65):
    10 classes, global batch 8×8 ranks = 64, AdamW, no clipping, 10k steps
    of cosine after 500 of warm-up."""
    return TaskConfig(
        task="classification", num_classes=10, backbone=backbone,
        train=TrainConfig(
            batch_size=64,
            optimizer=OptimizerConfig(lr=lr, weight_decay=0.05,
                                      layer_decay=layer_decay, clip_norm=0.0),
            schedule=ScheduleConfig(kind="cosine", total_steps=10000,
                                    warmup_steps=500)))


def _cd_recipe(backbone: BackboneConfig, lr: float = 6e-5,
               layer_decay: float = 0.9) -> TaskConfig:
    """The LEVIR change-detection recipe shape (`mtp_tpu.configs._cd`;
    reference open-cd levir/rvsa-l-unet-256-...py:107-137): 2 classes,
    batch 4/GPU × 8 ranks = 32, AdamW, no clipping, 40k steps of cosine
    after 40000 // 30 of warm-up."""
    return TaskConfig(
        task="change_detection", num_classes=2, backbone=backbone,
        train=TrainConfig(
            batch_size=32,
            optimizer=OptimizerConfig(lr=lr, weight_decay=0.05,
                                      layer_decay=layer_decay, clip_norm=0.0),
            schedule=ScheduleConfig(kind="cosine", total_steps=40000,
                                    warmup_steps=40000 // 30)))


def vit_rvsa_l_224_eurosat() -> TaskConfig:
    """The recipe `vit-rvsa-l-224-mae-mtp_eurosat` (and its `-mae_` twin):
    ViT-L+RVSA at 224², drop-path 0.3 → linear head, AdamW 6e-5, layer decay
    0.9."""
    return _cls_recipe(_vit_l(224))


def intern_xl_224_eurosat() -> TaskConfig:
    """The recipe `intern-xl-224-imp-mtp_eurosat` (and its `-imp_` twin):
    InternImage-XL at 224² → linear head, with `_ii_opt`'s AdamW 2e-5 and
    layer decay 0.94."""
    return _cls_recipe(_intern_xl(224), lr=2e-5, layer_decay=0.94)


def rvsa_l_unet_256_levir() -> TaskConfig:
    """The recipe `rvsa-l-unet-256-mae-mtp_levir` (and its `-mae_` twin):
    ViT-L+RVSA at 256² (raw stride-16 maps, no FPN) → Siamese UNet."""
    return _cd_recipe(_vit_l(256))


def intern_xl_unet_256_levir() -> TaskConfig:
    """The recipe `intern-xl-unet-256-imp-mtp_levir` (and its `-imp_` twin):
    InternImage-XL at 256² → Siamese UNet, AdamW 2e-5, layer decay 0.94."""
    return _cd_recipe(_intern_xl(256), lr=2e-5, layer_decay=0.94)


def _det_recipe(backbone: BackboneConfig, layer_decay: float = 0.9,
                task: str = "detection_h", num_classes: int = 20) -> TaskConfig:
    """The detection recipe shape (`mtp_tpu.configs._det`; reference mmdet
    faster_rcnn_..._dior.py and mmrotate oriented_rcnn_..._dior-r.py): 20
    classes (DIOR, DIOR-R) unless given, AdamW 1e-4 with weight decay 0.05,
    no clipping, the `step` schedule (LinearLR warm-up of 500 iterations,
    then ×0.1 at 8/12 and 11/12 of 90k steps); global batch 2/GPU × 8 = 16,
    rotated ("detection_r") 1/GPU × 4 ranks = 4."""
    return TaskConfig(
        task=task, num_classes=num_classes, backbone=backbone,
        train=TrainConfig(
            batch_size=4 if task == "detection_r" else 16,
            optimizer=OptimizerConfig(lr=1e-4, weight_decay=0.05,
                                      layer_decay=layer_decay, clip_norm=0.0),
            schedule=ScheduleConfig(kind="step", total_steps=90000,
                                    warmup_steps=500)))


def _vit_l_det(img_size: int) -> BackboneConfig:
    """ViT-L+RVSA at img_size², drop-path 0.3, the last block tapped four
    times (`out_indices=(23,)*4`, `mtp_tpu.configs._bb("rvsa_l", img_size,
    det_last=True)`)."""
    return vit_l_rvsa(img_size, drop_path_rate=0.3, scan=True,
                      out_indices=(23, 23, 23, 23))


def faster_rcnn_rvsa_l_800_dior() -> TaskConfig:
    """The recipe `faster_rcnn_rvsa_l_800_mae_mtp_dior` (and its `_mae_`
    twin): `_vit_l_det(800)` → FPN → Faster R-CNN, layer decay 0.9."""
    return _det_recipe(_vit_l_det(800))


def faster_rcnn_intern_xl_800_dior() -> TaskConfig:
    """The recipe `faster_rcnn_intern_xl_800_imp_mtp_dior` (and its `_imp_`
    twin): InternImage-XL at 800² with remat → FPN → Faster R-CNN, with
    `_ii_opt`'s layer decay 0.94 (detection keeps lr 1e-4)."""
    return _det_recipe(_intern_xl(800), layer_decay=0.94)


def oriented_rcnn_rvsa_l_800_diorr() -> TaskConfig:
    """The recipe `oriented_rcnn_rvsa_l_800_mae_mtp_diorr` (and its `_mae_`
    twin): `_vit_l_det(800)` → FPN → Oriented R-CNN on DIOR-R, batch 4 (1
    a GPU × 4 ranks), layer decay 0.9."""
    return _det_recipe(_vit_l_det(800), task="detection_r")


def oriented_rcnn_intern_xl_800_diorr() -> TaskConfig:
    """The recipe `oriented_rcnn_intern_xl_800_imp_mtp_diorr` (and its
    `_imp_` twin): InternImage-XL at 800² with remat → FPN → Oriented R-CNN
    on DIOR-R, batch 4, layer decay 0.94."""
    return _det_recipe(_intern_xl(800), layer_decay=0.94, task="detection_r")


def mask_rcnn_rvsa_l_1024_coco() -> TaskConfig:
    """The recipe `mask_rcnn_rvsa_l_1024_mae_mtp_coco` (and its `_mae_`
    twin): `_vit_l_det(1024)` → FPN → Mask R-CNN, 80 classes (COCO layout),
    task "instseg", batch 16 (2 a GPU × 8), layer decay 0.9."""
    return _det_recipe(_vit_l_det(1024), task="instseg", num_classes=80)


def mask_rcnn_intern_xl_1024_coco() -> TaskConfig:
    """The recipe `mask_rcnn_intern_xl_1024_imp_mtp_coco` (and its `_imp_`
    twin): InternImage-XL at 1024² with remat → FPN → Mask R-CNN, 80
    classes, layer decay 0.94 (lr 1e-4)."""
    return _det_recipe(_intern_xl(1024), layer_decay=0.94, task="instseg",
                       num_classes=80)


def retinanet_rvsa_l_416_xview() -> TaskConfig:
    """The recipe `retinanet_rvsa_l_416_mae_mtp_xview` (and its `_mae_`
    twin): `_vit_l_det(416)` → FPN (start_level 1, extra convs on the
    input) → RetinaNet, 60 classes (xView), batch 16, layer decay 0.9."""
    return _det_recipe(_vit_l_det(416), num_classes=60)


def retinanet_intern_xl_416_xview() -> TaskConfig:
    """The recipe `retinanet_intern_xl_416_imp_mtp_xview` (and its `_imp_`
    twin): InternImage-XL at 416² with remat → RetinaNet, 60 classes, layer
    decay 0.94 (lr 1e-4)."""
    return _det_recipe(_intern_xl(416), layer_decay=0.94, num_classes=60)


# SAMRS's class counts with the background: SOTA 18 + 1, SIOR 20 + 1, FAST
# 37 + 1 (`mtp_tpu/models/multitask.py`; reference main_pretrain.py:150-157
# with --background True)
SAMRS_CLASSES = (19, 21, 38)


def _mtp_recipe(backbone: BackboneConfig, lr: float = 6e-5,
                layer_decay: float = 0.9) -> TaskConfig:
    """The multitask pretraining recipe shape (`mtp_tpu.configs`; reference
    main_pretrain.py:433-474): task "multitask" (the class counts are
    SAMRS_CLASSES, not `num_classes`), global batch 24 (3 a GPU × 8),
    AdamW with weight decay 0.05, the default clipping at 5.0, cosine over
    80k steps without warm-up."""
    return TaskConfig(
        task="multitask", num_classes=0, backbone=backbone,
        train=TrainConfig(
            batch_size=24,
            optimizer=OptimizerConfig(lr=lr, weight_decay=0.05,
                                      layer_decay=layer_decay),
            schedule=ScheduleConfig(kind="cosine", total_steps=80000,
                                    warmup_steps=0)))


def mtp_vit_b_rvsa_448_samrs() -> TaskConfig:
    """The recipe `mtp_vit_b_rvsa_448_samrs`: ViT-B+RVSA at 448², drop-path
    0.1, AdamW 6e-5, layer decay 0.9."""
    return _mtp_recipe(vit_b_rvsa(448, drop_path_rate=0.1))


def mtp_vit_l_rvsa_448_samrs() -> TaskConfig:
    """The flagship recipe `mtp_vit_l_rvsa_448_samrs`: ViT-L+RVSA at 448²
    (the 28² token grid), drop-path 0.1, AdamW 6e-5, layer decay 0.9."""
    return _mtp_recipe(vit_l_rvsa(448, drop_path_rate=0.1, scan=True))


def mtp_internimage_xl_448_samrs() -> TaskConfig:
    """The recipe `mtp_internimage_xl_448_samrs`: InternImage-XL at 448²
    with remat, AdamW 2e-5, layer decay 0.94."""
    return _mtp_recipe(_intern_xl(448), lr=2e-5, layer_decay=0.94)


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
