"""Composed transform pipelines for every recipe family (the port's copy of
`mtp_tpu/data/pipelines.py`).

Capability parity with the reference pipeline configs:
- MTP pretraining train/valid pipeline (Multi-Task_Pretrain/utils.py:15-71):
  flip p=0.75 over h/v/diagonal → random-resize (0.5-2.0, keep ratio) →
  random crop to size (resample on all-instances-lost, recompute boxes from
  masks) → min-size instance filter → photometric distortion → normalize →
  pad to size,
- classification / segmentation / CD train pipelines from the finetune
  configs (resize + flip + normalize [+ crop]).

A pipeline is `fn(sample, rng) -> sample`, pluggable into the datasets of
data/datasets.py and the Loader collators.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

from mtp_tpu_torch.data import transforms as T
from mtp_tpu_torch.data.transforms import Sample


def filter_small_instances(sample: Sample, min_wh: float = 1e-5,
                           by_mask: bool = True) -> Sample:
    """INS_FilterAnnotations (augmentations.py:1158)."""
    if "hboxes" not in sample or len(sample["hboxes"]) == 0:
        return sample
    b = sample["hboxes"]
    keep = (b[:, 2] - b[:, 0] > min_wh) & (b[:, 3] - b[:, 1] > min_wh)
    if by_mask and sample.get("masks") is not None and len(sample["masks"]):
        keep &= sample["masks"].reshape(len(sample["masks"]), -1).any(-1)
    out = dict(sample)
    out["hboxes"] = b[keep]
    if "labels" in sample:
        out["labels"] = sample["labels"][keep]
    if sample.get("masks") is not None and len(sample["masks"]):
        out["masks"] = sample["masks"][keep]
    return out


def mtp_train_pipeline(size: int = 448) -> Callable[[Sample, np.random.Generator], Sample]:
    """The SAMRS pretraining train pipeline."""

    def fn(sample: Sample, rng: np.random.Generator) -> Sample:
        s = T.random_flip(sample, rng, prob=0.75,
                          directions=("horizontal", "vertical", "diagonal"))
        s = T.random_resize(s, (size, size), (0.5, 2.0), rng, keep_ratio=True)
        s = T.random_crop(s, (size, size), rng, recompute_bbox=True,
                          allow_negative=True)
        s = filter_small_instances(s)
        s = T.photometric_distortion(s, rng)
        s = T.normalize(s)
        s = T.pad_to(s, (size, size))
        return s

    return fn


def mtp_valid_pipeline(size: int = 448):
    def fn(sample: Sample, rng: np.random.Generator) -> Sample:
        s = T.resize(sample, (size, size), keep_ratio=True)
        s = T.normalize(s)
        return T.pad_to(s, (size, size))

    return fn


def cls_train_pipeline(size: int = 224, randaugment: bool = True):
    """RandomResizedCrop-lite + flip + RandAugment + RandomErasing +
    normalize (the reference eurosat recipe shape)."""

    def fn(sample: Sample, rng: np.random.Generator) -> Sample:
        s = T.random_resize(sample, (size, size), (1.0, 1.3), rng,
                            keep_ratio=False)
        s = T.random_crop(s, (size, size), rng)
        s = T.random_flip(s, rng, prob=0.5)
        if randaugment:
            s = T.rand_augment(s, rng)
            s = T.random_erasing(s, rng)
        s = T.normalize(s)
        return T.pad_to(s, (size, size))

    return fn


def cls_test_pipeline(size: int = 224):
    def fn(sample: Sample, rng=None) -> Sample:
        s = T.resize(sample, (size, size), keep_ratio=False)
        return T.normalize(s)

    return fn


def seg_train_pipeline(crop: int = 512, ratio_range=(0.5, 2.0)):
    """mmseg recipe (e.g. spacenetv1 config :22-34): RandomResize
    scale=crop ratio (0.5, 2.0) + RandomCrop cat_max_ratio 0.75 + flip +
    PhotoMetric + normalize + pad (seg ignore pad 255)."""

    def fn(sample: Sample, rng: np.random.Generator) -> Sample:
        s = T.random_resize(sample, (crop, crop), ratio_range, rng)
        s = T.random_crop(s, (crop, crop), rng, cat_max_ratio=0.75)
        s = T.random_flip(s, rng, prob=0.5)
        s = T.photometric_distortion(s, rng)
        s = T.normalize(s)
        return T.pad_to(s, (crop, crop))

    return fn


def seg_test_pipeline(size: int = None):
    """Reference seg test protocol (spacenetv1 config :45-49): NO resize —
    original resolution, slide inference handles the size.  `size` forces
    a square resize only for smoke/synthetic runs."""
    def fn(sample: Sample, rng=None) -> Sample:
        s = T.resize(sample, (size, size)) if size else sample
        s = T.normalize(s)
        return T.pad_to_divisor(s, 32)

    return fn


def cd_test_pipeline():
    """Reference CD test protocol (levir config :50-56): original
    resolution, normalize only (pad to stride just like train's crops)."""
    def fn(sample, rng=None):
        sa = T.pad_to_divisor(T.normalize(
            {"image": sample["image_a"], "sem_seg": sample["label"]}), 32)
        sb = T.pad_to_divisor(T.normalize({"image": sample["image_b"]}), 32)
        return {"image_a": sa["image"], "image_b": sb["image"],
                "label": sa["sem_seg"]}

    return fn


def det_train_pipeline(size: int = 800, flip_prob: float = 0.5,
                       directions=("horizontal",)):
    """Detection finetune train pipeline (reference mmdet/mmrotate configs:
    Resize keep-ratio to (size, size) → RandomFlip → Normalize → Pad).
    Horizontal det flips 0.5 horizontal; rotated det 0.75 over
    horizontal/vertical/diagonal (oriented_rcnn_..._diorr.py:76-79).
    Joint on hboxes/rboxes/masks via the label-aware transforms."""

    def fn(sample: Sample, rng: np.random.Generator) -> Sample:
        s = T.resize(sample, (size, size), keep_ratio=True)
        s = T.random_flip(s, rng, prob=flip_prob, directions=directions)
        s = filter_small_instances(s)
        s = T.normalize(s)
        return T.pad_to(s, (size, size))

    return fn


def det_test_pipeline(size: int = 800):
    def fn(sample: Sample, rng=None) -> Sample:
        s = T.resize(sample, (size, size), keep_ratio=True)
        s = T.normalize(s)
        return T.pad_to(s, (size, size))

    return fn


def cd_train_pipeline(crop: int = 256):
    """Dual-image pipeline: identical geometry on A/B, photometric jitter
    applied independently (open-cd MultiImg* semantics; levir config
    :27-40: RandomRotFlip(rot 0.5, flip 0.5, ±20°) + RandomCrop
    cat_max_ratio 0.75 + ExchangeTime 0.5 + soft PhotoMetricDistortion)."""

    def fn(sample, rng: np.random.Generator):
        # treat as a joint sample with image=A and a mirror for B
        sa = {"image": sample["image_a"], "sem_seg": sample["label"]}
        sb = {"image": sample["image_b"], "sem_seg": sample["label"]}
        seed = int(rng.integers(0, 2 ** 31))

        def geom(s, r):
            s = T.random_rotate(s, r, (-20.0, 20.0), prob=0.5)
            s = T.random_flip(s, r, prob=0.5,
                              directions=("horizontal", "vertical"))
            return T.random_crop(s, (crop, crop), r, cat_max_ratio=0.75)

        sa = geom(sa, np.random.default_rng(seed))  # same geometric draws
        sb = geom(sb, np.random.default_rng(seed))
        if rng.uniform() < 0.5:  # MultiImgExchangeTime
            sa, sb = sb, sa
        pa = T.photometric_distortion(sa, rng, brightness_delta=10,
                                      contrast_range=(0.8, 1.2),
                                      saturation_range=(0.8, 1.2),
                                      hue_delta=10)
        pb = T.photometric_distortion(sb, rng, brightness_delta=10,
                                      contrast_range=(0.8, 1.2),
                                      saturation_range=(0.8, 1.2),
                                      hue_delta=10)
        pa = T.normalize(pa)
        pb = T.normalize(pb)
        return {"image_a": pa["image"], "image_b": pb["image"],
                "label": pa["sem_seg"]}

    return fn
