"""Config registry: named recipes mirroring the reference's mmengine config
matrix (RS_Tasks_Finetune/*/configs/mtp/, 83 configs) plus the pretraining
CLI (the port's copy of `mtp_tpu/configs/__init__.py`, over the dataclasses
of `mtp_tpu_torch/config.py`).

The matrix is {dataset} × {rvsa_b, rvsa_l, intern_xl} × {mae, mae+mtp |
imp, imp+mtp}: the init tag names WHICH pretrained checkpoint the reference
config loads — here the checkpoint is a runtime flag (`--pretrained`), so
init variants share one TaskConfig and the tag is recorded on the recipe.
Names follow the reference file names exactly.

Backbone feature taps follow the reference:
- classification/segmentation/CD use the 4 intermediate out_indices
  (RVSA_MTP with fpn ops / raw features),
- detection uses the LAST-layer feature through all 4 FPN ops (plain
  RVSA_MTP in mmdet/mmrotate, ViTDet-style;
  vit_rvsa_mtp_branches.py:833-842 is the diff),
- `_branches` variants (FAIR1M) restore the intermediate taps.

The `scan` field of a config is the JAX package's layout switch, set as it
sets it; the port has one layout and ignores it.  List recipes with
`available()`, build with `get(name)`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from mtp_tpu_torch.config import (BackboneConfig, OptimizerConfig,
                                  ScheduleConfig, SlideConfig, TaskConfig,
                                  TrainConfig, internimage_backbone_config,
                                  vit_b_rvsa, vit_l_rvsa)


@dataclasses.dataclass(frozen=True)
class Recipe:
    name: str
    task: TaskConfig
    # dataset construction hints (paths are user-supplied at runtime)
    dataset: str = ""
    init: str = ""  # which pretrained encoder the reference pairs with
    notes: str = ""


_REGISTRY: Dict[str, Callable[[], Recipe]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def available():
    return sorted(_REGISTRY)


def get(name: str) -> Recipe:
    return _REGISTRY[name]()


# --------------------------------------------------------------------------
# task-family config shapes (hyper-parameters from the reference configs)
# --------------------------------------------------------------------------

def _cls(backbone: BackboneConfig, num_classes: int, steps: int,
         lr: float = 6e-5, layer_decay: float = 0.9) -> TaskConfig:
    """Scene-classification recipe shape (reference mmpretrain configs,
    e.g. eurosat/vit-rvsa-l-224-mae-mtp_eurosat.py:61-65: AdamW lr 6e-5,
    layer decay 0.9, LinearLR 5 epochs + CosineAnnealingLR, global batch
    8×8 ranks = 64)."""
    return TaskConfig(
        task="classification", num_classes=num_classes, backbone=backbone,
        train=TrainConfig(
            batch_size=64,
            optimizer=OptimizerConfig(lr=lr, weight_decay=0.05,
                                      layer_decay=layer_decay,
                                      clip_norm=0.0),
            schedule=ScheduleConfig(kind="cosine", total_steps=steps,
                                    warmup_steps=steps // 20)))


def _seg(backbone: BackboneConfig, num_classes: int, steps: int = 80000,
         lr: float = 6e-5, crop: int = 512) -> TaskConfig:
    """Segmentation recipe shape (reference mmseg configs, e.g.
    spacenetv1/rvsa-l-upernet-384-...py:92-114: AdamW 6e-5, LinearLR 1500
    iters + CosineAnnealingLR to 80k, slide eval stride 256)."""
    return TaskConfig(
        task="segmentation", num_classes=num_classes, backbone=backbone,
        train=TrainConfig(
            batch_size=8,
            optimizer=OptimizerConfig(lr=lr, weight_decay=0.05,
                                      layer_decay=0.9, clip_norm=0.0),
            schedule=ScheduleConfig(kind="cosine", total_steps=steps,
                                    warmup_steps=1500)),
        slide=SlideConfig(crop=crop, stride=256))


def _cd(backbone: BackboneConfig, steps: int = 40000) -> TaskConfig:
    """Change-detection recipe shape (reference open-cd configs, e.g.
    levir/rvsa-l-unet-256-...py:107-137: AdamW 6e-5, LinearLR 5 epochs +
    CosineAnnealingLR to 150 epochs)."""
    return TaskConfig(
        task="change_detection", num_classes=2, backbone=backbone,
        train=TrainConfig(
            batch_size=32,  # 4/gpu × 8 ranks (README srun)
            optimizer=OptimizerConfig(lr=6e-5, weight_decay=0.05,
                                      layer_decay=0.9, clip_norm=0.0),
            schedule=ScheduleConfig(kind="cosine", total_steps=steps,
                                    warmup_steps=steps // 30)))


def _det(backbone: BackboneConfig, num_classes: int, steps: int = 90000,
         lr: float = 1e-4, task: str = "detection_h") -> TaskConfig:
    """Detection recipe shape.  Global batches follow the reference runs:
    horizontal 2/gpu × 8 (auto_scale_lr base_batch_size=16,
    faster_rcnn_..._dior.py:68), rotated 1/gpu × 4 ranks (README srun)."""
    return TaskConfig(
        task=task, num_classes=num_classes, backbone=backbone,
        train=TrainConfig(
            batch_size=4 if task == "detection_r" else 16,
            # reference detection finetunes run unclipped (no clip_grad in
            # any mmdet/mmrotate mtp config)
            optimizer=OptimizerConfig(lr=lr, weight_decay=0.05,
                                      layer_decay=0.9, clip_norm=0.0),
            # reference detection finetunes: LinearLR warmup 500 iters +
            # MultiStepLR milestones [8, 11] of 12 epochs, gamma 0.1
            schedule=ScheduleConfig(kind="step", total_steps=steps,
                                    warmup_steps=500)))


# --------------------------------------------------------------------------
# backbone configs
# --------------------------------------------------------------------------

def _internimage_xl(img_size: int, **kw):
    # the reference trains XL with checkpointing unconditionally
    # (Multi-Task_Pretrain/models.py:102 with_cp=True)
    kw.setdefault("remat", True)
    kw.setdefault("scan", True)
    return internimage_backbone_config("internimage_xl", img_size, **kw)


def _bb(kind: str, size: int, det_last: bool = False) -> BackboneConfig:
    """det_last: plain RVSA_MTP detection taps (last layer through all 4
    FPN ops) vs the intermediate out_indices of RVSA_MTP(_branches)."""
    if kind == "rvsa_b":
        oi = (11, 11, 11, 11) if det_last else (3, 5, 7, 11)
        return vit_b_rvsa(size, drop_path_rate=0.1, out_indices=oi)
    if kind == "rvsa_l":
        oi = (23, 23, 23, 23) if det_last else (7, 11, 15, 23)
        return vit_l_rvsa(size, drop_path_rate=0.3, scan=True,
                          out_indices=oi)
    if kind == "intern_xl":
        return _internimage_xl(size)
    raise KeyError(kind)


# per-backbone name fragments and init tags (reference file-name style)
_CLS_TAG = {"rvsa_b": "vit-rvsa-b", "rvsa_l": "vit-rvsa-l",
            "intern_xl": "intern-xl"}
_SEG_TAG = {"rvsa_b": "rvsa-b", "rvsa_l": "rvsa-l", "intern_xl": "intern-xl"}
_INITS = {"rvsa_b": ("mae", "mae-mtp"), "rvsa_l": ("mae", "mae-mtp"),
          "intern_xl": ("imp", "imp-mtp")}


def _ii_opt(task: TaskConfig) -> TaskConfig:
    """InternImage finetunes run a different optimizer point than ViT
    (reference intern-xl configs: layer_decay 0.94 everywhere; lr 2e-5 for
    cls/seg/CD, detection keeps 1e-4)."""
    if not task.backbone.name.startswith("internimage"):
        return task
    opt = task.train.optimizer
    lr = opt.lr if task.task in ("detection_h", "detection_r", "instseg") \
        else 2e-5
    return dataclasses.replace(task, train=dataclasses.replace(
        task.train, optimizer=dataclasses.replace(
            opt, lr=lr, layer_decay=0.94)))


def _register_recipe(name: str, task: TaskConfig, dataset: str, init: str,
                     notes: str = ""):
    task = _ii_opt(task)
    def fn(task=task, name=name, dataset=dataset, init=init, notes=notes):
        return Recipe(name, task, dataset=dataset, init=init, notes=notes)
    _REGISTRY[name] = fn


def _matrix():
    # --- scene classification (Scene_Classification/configs/mtp) ---------
    for ds, nc, steps, note in (("eurosat", 10, 10000, "OA 98.76 B / 98.78 L"),
                                ("nwpu28", 45, 12000, "RESISC-45, OA 95.57")):
        for bk in ("rvsa_b", "rvsa_l", "intern_xl"):
            for init in _INITS[bk]:
                name = f"{_CLS_TAG[bk]}-224-{init}_{ds}"
                _register_recipe(name, _cls(_bb(bk, 224), nc, steps),
                                 "resisc45" if ds == "nwpu28" else ds,
                                 init, note)

    # --- semantic segmentation (Semantic_Segmentation/configs/mtp) -------
    for ds, nc, size, note in (("spacenetv1", 2, 384, "mIoU 79.63 B"),
                               ("loveda", 7, 512, "mIoU 54.17 L")):
        for bk in ("rvsa_b", "rvsa_l", "intern_xl"):
            for init in _INITS[bk]:
                name = f"{_SEG_TAG[bk]}-upernet-{size}-{init}-{ds}"
                _register_recipe(name, _seg(_bb(bk, size), nc, crop=size),
                                 ds, init, note)

    # --- change detection (Change_Detection/configs/mtp) -----------------
    for ds, size, note in (("levir", 256, "F1 92.67 L"),
                           ("whu", 256, "F1 94.32 B"),
                           ("cdd", 256, "SVCD/CDD pairs"),
                           ("oscd_rgb", 96, "OSCD RGB")):
        for bk in ("rvsa_b", "rvsa_l", "intern_xl"):
            for init in _INITS[bk]:
                name = f"{_SEG_TAG[bk]}-unet-{size}-{init}_{ds}"
                _register_recipe(name, _cd(_bb(bk, size)),
                                 "svcd" if ds == "cdd" else
                                 ("oscd" if ds == "oscd_rgb" else ds),
                                 init, note)

    # --- horizontal detection (Horizontal_Detection/configs/mtp) ---------
    for bk in ("rvsa_b", "rvsa_l", "intern_xl"):
        for init in _INITS[bk]:
            it = init.replace("-", "_")
            _register_recipe(
                f"faster_rcnn_{bk}_800_{it}_dior",
                _det(_bb(bk, 800, det_last=True), 20),
                "dior", init, "AP50 81.70 L")
            _register_recipe(
                f"retinanet_{bk}_416_{it}_xview",
                _det(_bb(bk, 416, det_last=True), 60),
                "xview", init, "AP 19.40 L; RetinaNet head")
            # standalone Mask R-CNN on any COCO-with-masks layout (the
            # reference exercises IS only inside pretraining validation —
            # this exposes the same decoder as a finetune/eval recipe with
            # bbox+segm COCO mAP)
            _register_recipe(
                f"mask_rcnn_{bk}_1024_{it}_coco",
                _det(_bb(bk, 1024, det_last=True), 80, task="instseg"),
                "coco", init, "bbox+segm AP; SAMRS-style ins json works")

    # --- rotated detection (Rotated_Detection/configs/mtp) ---------------
    rot = [("diorr", "dior-r", 20, 800, "mAP 74.54 L", False),
           ("dota10", "dota10", 15, 1024, "mAP 81.66 L ms", False),
           ("dota20", "dota20", 18, 1024, "DOTA-v2.0", False),
           ("fair1m20", "fair1m", 37, 800, "FAIR1M-v2; branches taps", True)]
    for tag, ds, nc, size, note, branches in rot:
        for bk in ("rvsa_b", "rvsa_l", "intern_xl"):
            for init in _INITS[bk]:
                it = init.replace("-", "_")
                suffix = "_branches" if branches and bk != "intern_xl" else ""
                name = f"oriented_rcnn_{bk}_{size}_{it}_{tag}{suffix}"
                _register_recipe(
                    name,
                    _det(_bb(bk, size, det_last=not branches), nc,
                         task="detection_r"),
                    ds, init, note)


_matrix()


# --------------------------------------------------------------------------
# multi-task pretraining (reference Multi-Task_Pretrain CLI)
# --------------------------------------------------------------------------

def _mtp(backbone: BackboneConfig, lr: float = 6e-5,
         layer_decay: float = 0.9) -> TaskConfig:
    """The pretraining recipe shape (reference main_pretrain.py:433-474):
    AdamW with weight decay 0.05, the default clipping, cosine over 80k
    steps without warm-up, global batch 24 (3 a GPU × 8); the class counts
    are SAMRS's (`config.SAMRS_CLASSES`), not `num_classes`."""
    return TaskConfig(
        task="multitask", num_classes=0, backbone=backbone,
        train=TrainConfig(
            batch_size=24,
            optimizer=OptimizerConfig(lr=lr, weight_decay=0.05,
                                      layer_decay=layer_decay),
            schedule=ScheduleConfig(kind="cosine", total_steps=80000,
                                    warmup_steps=0)))


@register("mtp_vit_b_rvsa_448_samrs")
def _():
    # reference main_pretrain.py:433-457: AdamW 6e-5, layer decay 0.9
    return Recipe("mtp_vit_b_rvsa_448_samrs",
                  _mtp(vit_b_rvsa(448, drop_path_rate=0.1)),
                  dataset="samrs", init="mae",
                  notes="SOTA+SIOR+FAST joint pretraining")


@register("mtp_vit_l_rvsa_448_samrs")
def _():
    return Recipe("mtp_vit_l_rvsa_448_samrs",
                  _mtp(vit_l_rvsa(448, drop_path_rate=0.1, scan=True)),
                  dataset="samrs", init="mae",
                  notes="flagship pretraining recipe")


@register("mtp_internimage_xl_448_samrs")
def _():
    # reference main_pretrain.py:466-474: InternImage pretrains at AdamW
    # 2e-5, layer decay 0.94, no warmup
    return Recipe("mtp_internimage_xl_448_samrs",
                  _mtp(_internimage_xl(448), lr=2e-5, layer_decay=0.94),
                  dataset="samrs", init="imp",
                  notes="InternImage-XL pretraining (reference --backbone "
                        "internimage)")


# --------------------------------------------------------------------------
# legacy aliases (round-1 names kept for compatibility)
# --------------------------------------------------------------------------

_ALIASES = {
    "vit-rvsa-b-224-mae-mtp_eurosat": "vit-rvsa-b-224-mae-mtp_eurosat",
    "vit-rvsa-b-224-mae-mtp_resisc45": "vit-rvsa-b-224-mae-mtp_nwpu28",
    "vit-rvsa-l-224-mae-mtp_resisc45": "vit-rvsa-l-224-mae-mtp_nwpu28",
    "intern-xl-224-imp-mtp_resisc45": "intern-xl-224-imp-mtp_nwpu28",
    "rvsa-b-upernet-384-mae-mtp-spacenetv1":
        "rvsa-b-upernet-384-mae-mtp-spacenetv1",
    "oriented_rcnn_rvsa_l_1024_mae_mtp_dota":
        "oriented_rcnn_rvsa_l_1024_mae_mtp_dota10",
    "internimage-xl-224-imp-mtp_eurosat": "intern-xl-224-imp-mtp_eurosat",
    "internimage-xl-upernet-512-imp-mtp-loveda":
        "intern-xl-upernet-512-imp-mtp-loveda",
    "internimage-xl-unet-256-imp-mtp_levir":
        "intern-xl-unet-256-imp-mtp_levir",
}
for _alias, _target in _ALIASES.items():
    if _alias not in _REGISTRY and _target in _REGISTRY:
        _REGISTRY[_alias] = (lambda t=_target, a=_alias:
                             dataclasses.replace(_REGISTRY[t](), name=a))
