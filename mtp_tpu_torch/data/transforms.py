"""Joint label-aware augmentations (host-side numpy; the port's copy of
`mtp_tpu/data/transforms.py`, draw for draw).

Capability parity with the reference pipeline
(Multi-Task_Pretrain/augmentations.py): every transform keeps image,
semantic map, instance masks, horizontal boxes AND rotated boxes consistent.
A sample is a plain dict:

  image    (H, W, 3) float32 (RGB, 0-255 until Normalize)
  sem_seg  (H, W) int32           [optional]
  hboxes   (N, 4) float32 x1y1x2y2 [optional]
  labels   (N,) int32              [optional]
  masks    (N, H, W) uint8         [optional]
  rboxes   (M, 5) float32 cx cy w h theta [optional]
  rlabels  (M,) int32              [optional]

Transforms mirror the reference semantics (flip/resize/crop rules incl. the
joint validity filter, recompute-bbox-from-mask, and crop-resample):
MTP_RandomFlip :564, MTP_RandomResize/Resize :677/1621, MTP_RandomCrop :863,
INS_FilterAnnotations :1158, MTP_PhotoMetricDistortion :1252, MTP_Pad :1749.
All run on numpy on host; the device sees only fixed-shape batches.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

Sample = Dict[str, np.ndarray]


def _has(s: Sample, k: str) -> bool:
    return k in s and s[k] is not None and len(s[k]) > 0


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------

try:  # SIMD host path: the reference's mmcv pipeline is itself cv2-backed,
    import cv2 as _cv2  # so cv2 here is both faster AND closer to parity
except ImportError:  # pragma: no cover
    _cv2 = None


def _resize_image(img: np.ndarray, size: Tuple[int, int],
                  nearest: bool = False) -> np.ndarray:
    h, w = size
    if _cv2 is not None:
        if img.dtype == np.bool_:
            return _resize_image(img.view(np.uint8), size,
                                 nearest).astype(bool)
        if img.dtype in (np.int64, np.uint32, np.uint64):
            return _resize_image(img.astype(np.int32), size,
                                 nearest).astype(img.dtype)
        interp = _cv2.INTER_NEAREST if nearest else _cv2.INTER_LINEAR
        out = _cv2.resize(np.ascontiguousarray(img), (w, h),
                          interpolation=interp)
        return out.astype(img.dtype, copy=False)
    from PIL import Image
    mode = Image.NEAREST if nearest else Image.BILINEAR
    if img.ndim == 2:
        return np.asarray(Image.fromarray(img).resize((w, h), mode))
    arr = Image.fromarray(img.astype(np.uint8) if img.dtype != np.uint8
                          else img)
    return np.asarray(arr.resize((w, h), mode)).astype(img.dtype)


def resize(sample: Sample, scale: Tuple[int, int],
           keep_ratio: bool = True) -> Sample:
    """scale = (w, h) target (mmcv convention)."""
    H, W = sample["image"].shape[:2]
    tw, th = scale
    if keep_ratio:
        f = min(tw / W, th / H)
        nw, nh = int(W * f + 0.5), int(H * f + 0.5)
    else:
        nw, nh = tw, th
    fx, fy = nw / W, nh / H
    out = dict(sample)
    out["image"] = _resize_image(sample["image"], (nh, nw)).astype(np.float32)
    if "sem_seg" in sample:
        out["sem_seg"] = _resize_image(sample["sem_seg"].astype(np.int32),
                                       (nh, nw), nearest=True)
    if _has(sample, "hboxes"):
        out["hboxes"] = sample["hboxes"] * np.array([fx, fy, fx, fy],
                                                    np.float32)
    if _has(sample, "masks"):
        out["masks"] = np.stack([
            _resize_image(m, (nh, nw), nearest=True) for m in sample["masks"]])
    if _has(sample, "rboxes"):
        r = sample["rboxes"].copy()
        # mmrotate rbox rescale: centers scale, w/h scale along the rotated
        # axes via the project-rescale rule
        r[:, 0] *= fx
        r[:, 1] *= fy
        if abs(fx - fy) < 1e-6:
            r[:, 2] *= fx
            r[:, 3] *= fy
        else:
            # anisotropic: rescale via corner projection
            t = r[:, 4]
            cos, sin = np.cos(t), np.sin(t)
            w_vec = np.stack([r[:, 2] * cos * fx, r[:, 2] * sin * fy], -1)
            h_vec = np.stack([-r[:, 3] * sin * fx, r[:, 3] * cos * fy], -1)
            r[:, 2] = np.linalg.norm(w_vec, axis=-1)
            r[:, 3] = np.linalg.norm(h_vec, axis=-1)
            r[:, 4] = np.arctan2(w_vec[:, 1], w_vec[:, 0])
        out["rboxes"] = r
    return out


def random_resize(sample: Sample, scale: Tuple[int, int],
                  ratio_range: Tuple[float, float], rng: np.random.Generator,
                  keep_ratio: bool = True) -> Sample:
    r = rng.uniform(*ratio_range)
    return resize(sample, (int(scale[0] * r), int(scale[1] * r)), keep_ratio)


# ---------------------------------------------------------------------------
# flip
# ---------------------------------------------------------------------------

def flip(sample: Sample, direction: str) -> Sample:
    """direction in {'horizontal', 'vertical', 'diagonal'}."""
    H, W = sample["image"].shape[:2]
    out = dict(sample)

    def f_img(a):
        if direction == "horizontal":
            return a[:, ::-1].copy()
        if direction == "vertical":
            return a[::-1].copy()
        return a[::-1, ::-1].copy()

    out["image"] = f_img(sample["image"])
    if "sem_seg" in sample:
        out["sem_seg"] = f_img(sample["sem_seg"])
    if _has(sample, "masks"):
        out["masks"] = np.stack([f_img(m) for m in sample["masks"]])
    if _has(sample, "hboxes"):
        b = sample["hboxes"].copy()
        if direction in ("horizontal", "diagonal"):
            b[:, [0, 2]] = W - sample["hboxes"][:, [2, 0]]
        if direction in ("vertical", "diagonal"):
            b[:, [1, 3]] = H - (b if direction == "diagonal"
                                else sample["hboxes"])[:, [3, 1]]
        out["hboxes"] = b
    if _has(sample, "rboxes"):
        r = sample["rboxes"].copy()
        if direction in ("horizontal", "diagonal"):
            r[:, 0] = W - r[:, 0]
            r[:, 4] = -r[:, 4]
        if direction in ("vertical", "diagonal"):
            r[:, 1] = H - r[:, 1]
            r[:, 4] = -r[:, 4]
        # diagonal flips angle twice → back to original angle
        out["rboxes"] = r
    return out


def random_flip(sample: Sample, rng: np.random.Generator,
                prob: float = 0.5,
                directions: Sequence[str] = ("horizontal",)) -> Sample:
    if rng.uniform() < prob:
        return flip(sample, directions[rng.integers(len(directions))])
    return sample


# ---------------------------------------------------------------------------
# crop
# ---------------------------------------------------------------------------

def crop(sample: Sample, y0: int, x0: int, h: int, w: int,
         min_size: float = 1e-3, recompute_bbox_from_mask: bool = False
         ) -> Optional[Sample]:
    """Crop and filter annotations.  Returns None if all instances vanish and
    the sample had instances (reference allow_negative_crop=False →
    resample)."""
    out = dict(sample)
    out["image"] = sample["image"][y0:y0 + h, x0:x0 + w].copy()
    if "sem_seg" in sample:
        out["sem_seg"] = sample["sem_seg"][y0:y0 + h, x0:x0 + w].copy()

    had_instances = _has(sample, "hboxes") or _has(sample, "rboxes")

    if _has(sample, "hboxes"):
        b = sample["hboxes"] - np.array([x0, y0, x0, y0], np.float32)
        b[:, 0::2] = b[:, 0::2].clip(0, w)
        b[:, 1::2] = b[:, 1::2].clip(0, h)
        keep = (b[:, 2] - b[:, 0] > min_size) & (b[:, 3] - b[:, 1] > min_size)
        out["hboxes"] = b[keep]
        if _has(sample, "labels"):
            out["labels"] = sample["labels"][keep]
        if _has(sample, "masks"):
            m = sample["masks"][keep][:, y0:y0 + h, x0:x0 + w].copy()
            out["masks"] = m
            if recompute_bbox_from_mask and len(m):
                out["hboxes"] = masks_to_boxes(m)
    if _has(sample, "rboxes"):
        r = sample["rboxes"].copy()
        r[:, 0] -= x0
        r[:, 1] -= y0
        inside = (r[:, 0] >= 0) & (r[:, 0] < w) & (r[:, 1] >= 0) & (r[:, 1] < h)
        out["rboxes"] = r[inside]
        if _has(sample, "rlabels"):
            out["rlabels"] = sample["rlabels"][inside]

    if had_instances and not (_has(out, "hboxes") or _has(out, "rboxes")):
        return None
    return out


def random_crop(sample: Sample, size: Tuple[int, int],
                rng: np.random.Generator, cat_max_ratio: float = 1.0,
                max_tries: int = 10, recompute_bbox: bool = False,
                allow_negative: bool = False) -> Sample:
    """Random crop with resample-on-empty (reference data_augs loop
    utils.py:114-131 + MTP_RandomCrop).  cat_max_ratio < 1 additionally
    rejects crops where one semantic class covers more than that fraction
    (mmseg RandomCrop cat_max_ratio, e.g. 0.75 in the seg recipes).
    recompute_bbox/allow_negative mirror MTP_RandomCrop's flags in the
    pretraining pipeline (utils.py:48-51: recompute_bbox=True,
    allow_negative_crop=True)."""
    H, W = sample["image"].shape[:2]
    ch, cw = min(size[0], H), min(size[1], W)
    fallback = None
    for _ in range(max_tries):
        y0 = int(rng.integers(0, H - ch + 1))
        x0 = int(rng.integers(0, W - cw + 1))
        c = crop(sample, y0, x0, ch, cw,
                 recompute_bbox_from_mask=recompute_bbox)
        if c is None:
            if allow_negative:  # keep the crop with zero instances
                c = dict(sample,
                         image=sample["image"][y0:y0 + ch, x0:x0 + cw].copy())
                if "sem_seg" in sample:
                    c["sem_seg"] = \
                        sample["sem_seg"][y0:y0 + ch, x0:x0 + cw].copy()
                empty = {"hboxes": np.zeros((0, 4), np.float32),
                         "labels": np.zeros((0,), np.int64),
                         "masks": np.zeros((0, ch, cw), np.uint8),
                         "rboxes": np.zeros((0, 5), np.float32),
                         "rlabels": np.zeros((0,), np.int64)}
                for k, v in empty.items():
                    if k in sample and sample[k] is not None:
                        c[k] = v
                return c
            continue
        if cat_max_ratio < 1.0 and "sem_seg" in c:
            labels, counts = np.unique(c["sem_seg"], return_counts=True)
            counts = counts[labels != 255]
            # mmseg accepts only multi-class crops under the ratio; after
            # max_tries the last valid crop is kept (mmseg keeps its last)
            if not (len(counts) > 1
                    and counts.max() / counts.sum() <= cat_max_ratio):
                fallback = c
                continue
        return c
    if fallback is not None:
        return fallback
    # fall back to an unfiltered center crop
    c = crop(sample, (H - ch) // 2, (W - cw) // 2, ch, cw)
    return c if c is not None else dict(
        sample, image=sample["image"][:ch, :cw],
        **({"sem_seg": sample["sem_seg"][:ch, :cw]} if "sem_seg" in sample else {}))


def masks_to_boxes(masks: np.ndarray) -> np.ndarray:
    """(N, H, W) → (N, 4) tight boxes; empty masks give zero boxes."""
    out = np.zeros((len(masks), 4), np.float32)
    for i, m in enumerate(masks):
        ys, xs = np.nonzero(m)
        if len(ys):
            out[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
    return out


# ---------------------------------------------------------------------------
# photometric distortion (reference MTP_PhotoMetricDistortion :1252)
# ---------------------------------------------------------------------------

def random_rotate(sample: Sample, rng: np.random.Generator,
                  degree_range: Tuple[float, float] = (-20.0, 20.0),
                  prob: float = 0.5, seg_fill: int = 255) -> Sample:
    """Arbitrary-angle rotation of image (bilinear) + sem_seg (nearest,
    fill=ignore).  Reference: open-cd MultiImgRandomRotFlip degree=(-20,20)
    / mmseg RandomRotate.  Box/mask samples are not supported (the
    reference only rotates in seg-style pipelines)."""
    if _has(sample, "hboxes") or _has(sample, "rboxes") \
            or _has(sample, "masks"):
        raise ValueError("random_rotate only supports image+sem_seg "
                         "samples (box/mask geometry is not rotated)")
    if rng.uniform() >= prob:
        return sample
    from PIL import Image
    angle = float(rng.uniform(*degree_range))
    out = dict(sample)
    img = np.asarray(sample["image"], np.float32)
    out["image"] = np.stack(
        [np.asarray(Image.fromarray(img[..., c], mode="F").rotate(
            angle, resample=Image.BILINEAR, fillcolor=0.0))
         for c in range(img.shape[-1])], -1)
    if "sem_seg" in sample:
        seg = Image.fromarray(sample["sem_seg"].astype(np.int32), mode="I")
        out["sem_seg"] = np.asarray(
            seg.rotate(angle, resample=Image.NEAREST, fillcolor=seg_fill)
        ).astype(sample["sem_seg"].dtype)
    return out


def photometric_distortion(sample: Sample, rng: np.random.Generator,
                           brightness_delta: float = 32,
                           contrast_range: Tuple[float, float] = (0.5, 1.5),
                           saturation_range: Tuple[float, float] = (0.5, 1.5),
                           hue_delta: float = 18) -> Sample:
    img = sample["image"].astype(np.float32)
    if rng.integers(2):
        img = img + rng.uniform(-brightness_delta, brightness_delta)
    contrast_last = rng.integers(2)
    if not contrast_last and rng.integers(2):
        img = img * rng.uniform(*contrast_range)
    # saturation / hue in HSV
    if rng.integers(2) or rng.integers(2):
        hsv = _rgb_to_hsv(img.clip(0, 255))
        if rng.integers(2):
            hsv[..., 1] = hsv[..., 1] * rng.uniform(*saturation_range)
        if rng.integers(2):
            hsv[..., 0] = (hsv[..., 0] + rng.uniform(-hue_delta, hue_delta)) % 360
        img = _hsv_to_rgb(hsv)
    if contrast_last and rng.integers(2):
        img = img * rng.uniform(*contrast_range)
    return dict(sample, image=img.clip(0, 255).astype(np.float32))


def _rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """H in [0, 360], S/V in [0, 1] — the cv2 float32 convention (the
    reference's mmcv PhotoMetricDistortion is cv2-backed)."""
    if _cv2 is not None:
        return _cv2.cvtColor(
            np.ascontiguousarray(rgb * np.float32(1 / 255), np.float32),
            _cv2.COLOR_RGB2HSV)
    rgbn = rgb * np.float32(1 / 255)
    r, g, b = rgbn[..., 0], rgbn[..., 1], rgbn[..., 2]
    mx = np.max(rgbn, -1)
    mn = np.min(rgbn, -1)
    d = mx - mn + np.float32(1e-12)  # f32 literal: keep the whole chain f32
    dinv = np.float32(1.0) / d
    h = np.zeros_like(mx)
    h = np.where(mx == r, (g - b) * dinv % np.float32(6), h)
    h = np.where(mx == g, (b - r) * dinv + np.float32(2), h)
    h = np.where(mx == b, (r - g) * dinv + np.float32(4), h)
    h = h * np.float32(60)
    s = np.where(mx > 0, d / (mx + np.float32(1e-12)), np.float32(0))
    return np.stack([h, s, mx], -1)


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """Standard k-formula (same math as the 6-sector select, ~6× fewer
    full-array temporaries — this runs per TRAIN SAMPLE on the host):
    rgb_n = v − c·clip(min(k, 4−k), 0, 1), k = (n + h/60) mod 6."""
    if _cv2 is not None:
        hsv = hsv.copy()
        hsv[..., 1] = hsv[..., 1].clip(0, 1)  # sat scaling may exceed 1
        return _cv2.cvtColor(np.ascontiguousarray(hsv, np.float32),
                             _cv2.COLOR_HSV2RGB) * np.float32(255)
    h, s, v = hsv[..., 0], hsv[..., 1].clip(0, 1), hsv[..., 2]
    c = v * s
    h60 = h * np.float32(1 / 60)
    out = np.empty(hsv.shape, np.float32)
    for i, n in enumerate((5.0, 3.0, 1.0)):
        k = (h60 + n) % 6.0
        np.minimum(k, 4.0 - k, out=k)
        np.clip(k, 0.0, 1.0, out=k)
        out[..., i] = v - c * k
    return out * 255


# ---------------------------------------------------------------------------
# classification-only augments (reference eurosat config: RandAugment +
# RandomErasing, Scene_Classification/configs/mtp/.../*_eurosat.py:116-142)
# ---------------------------------------------------------------------------

def random_erasing(sample: Sample, rng: np.random.Generator,
                   prob: float = 0.25, area_range=(0.02, 0.33),
                   aspect_range=(0.3, 3.3)) -> Sample:
    if rng.uniform() >= prob:
        return sample
    img = sample["image"].copy()
    H, W = img.shape[:2]
    area = rng.uniform(*area_range) * H * W
    aspect = rng.uniform(*aspect_range)
    h = int(round(math.sqrt(area * aspect)))
    w = int(round(math.sqrt(area / aspect)))
    if h >= H or w >= W or h < 1 or w < 1:
        return sample
    y0 = int(rng.integers(0, H - h))
    x0 = int(rng.integers(0, W - w))
    img[y0:y0 + h, x0:x0 + w] = img.mean(axis=(0, 1))
    return dict(sample, image=img)


def rand_augment(sample: Sample, rng: np.random.Generator,
                 num_ops: int = 2, magnitude: float = 0.3) -> Sample:
    """A compact RandAugment over photometric+geometric ops (image-only —
    classification use)."""
    from PIL import Image, ImageEnhance

    img = sample["image"]
    pil = Image.fromarray(img.clip(0, 255).astype(np.uint8))
    ops = ["brightness", "contrast", "color", "sharpness", "rotate",
           "translate_x", "translate_y", "identity"]
    for _ in range(num_ops):
        op = ops[rng.integers(len(ops))]
        m = magnitude * rng.uniform(0.5, 1.5)
        if op == "brightness":
            pil = ImageEnhance.Brightness(pil).enhance(1 + m * rng.choice([-1, 1]))
        elif op == "contrast":
            pil = ImageEnhance.Contrast(pil).enhance(1 + m * rng.choice([-1, 1]))
        elif op == "color":
            pil = ImageEnhance.Color(pil).enhance(1 + m * rng.choice([-1, 1]))
        elif op == "sharpness":
            pil = ImageEnhance.Sharpness(pil).enhance(1 + m * rng.choice([-1, 1]))
        elif op == "rotate":
            pil = pil.rotate(m * 30 * rng.choice([-1, 1]), fillcolor=(128, 128, 128))
        elif op == "translate_x":
            pil = pil.transform(pil.size, Image.AFFINE,
                                (1, 0, m * pil.size[0] * rng.choice([-1, 1]), 0, 1, 0),
                                fillcolor=(128, 128, 128))
        elif op == "translate_y":
            pil = pil.transform(pil.size, Image.AFFINE,
                                (1, 0, 0, 0, 1, m * pil.size[1] * rng.choice([-1, 1])),
                                fillcolor=(128, 128, 128))
    return dict(sample, image=np.asarray(pil).astype(np.float32))


# ---------------------------------------------------------------------------
# normalize & pad
# ---------------------------------------------------------------------------

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


def normalize(sample: Sample, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> Sample:
    img = (sample["image"].astype(np.float32) - mean) / std
    return dict(sample, image=img)


def pad_to(sample: Sample, size: Tuple[int, int], pad_val: float = 0.0,
           seg_pad_val: int = 255) -> Sample:
    H, W = sample["image"].shape[:2]
    th, tw = size
    ph, pw = max(th - H, 0), max(tw - W, 0)
    if ph == 0 and pw == 0:
        return sample
    out = dict(sample)
    out["image"] = np.pad(sample["image"], ((0, ph), (0, pw), (0, 0)),
                          constant_values=pad_val)
    if "sem_seg" in sample:
        out["sem_seg"] = np.pad(sample["sem_seg"], ((0, ph), (0, pw)),
                                constant_values=seg_pad_val)
    if _has(sample, "masks"):
        out["masks"] = np.pad(sample["masks"], ((0, 0), (0, ph), (0, pw)))
    return out


def pad_to_divisor(sample: Sample, divisor: int = 32, **kw) -> Sample:
    H, W = sample["image"].shape[:2]
    th = (H + divisor - 1) // divisor * divisor
    tw = (W + divisor - 1) // divisor * divisor
    return pad_to(sample, (th, tw), **kw)
