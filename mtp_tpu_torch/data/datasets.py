"""Datasets: SAMRS multi-task pretraining + the finetune-suite datasets (the
port's copy of `mtp_tpu/data/datasets.py`, with its class tables).

Capability parity with the reference dataset classes:
- `SOTAMultiTaskDataset` / `SIORMultiTaskDataset` / `FASTMultiTaskDataset`
  (Multi-Task_Pretrain/datasets.py:1428/1458/1486): COCO instance JSON +
  per-image PNG semantic maps + DOTA-txt or VOC-xml rotated boxes,
- finetune datasets: folder classification (EuroSAT/RESISC-45), seg folders
  (SpaceNetV1 2-cls, LoveDA 7-cls), COCO detection (DIOR 20-cls, Xview
  60-cls), rotated detection (DIOR-R xml, DOTA txt), CD pairs (LEVIR/WHU/
  SVCD/OSCD: A/B/label dirs).

Every dataset returns the plain Sample dict of data/transforms.py; pipelines
are composed functions; file formats are parsed by data/parsers.py.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mtp_tpu_torch.data.parsers import (CocoImage, coco_masks, load_coco,
                                  parse_dota_txt, parse_voc_rotated_xml,
                                  quads_to_rboxes)
from mtp_tpu_torch.data.transforms import Sample

# class name tables (reference datasets.py METAINFO blocks)
SOTA_CLASSES = (
    "background", "large-vehicle", "swimming-pool", "helicopter", "bridge",
    "plane", "ship", "soccer-ball-field", "basketball-court",
    "ground-track-field", "small-vehicle", "baseball-diamond", "tennis-court",
    "roundabout", "storage-tank", "harbor", "container-crane", "airport",
    "helipad")
SIOR_CLASSES = (
    "background", "airplane", "airport", "baseballfield", "basketballcourt",
    "bridge", "chimney", "expressway-service-area", "expressway-toll-station",
    "dam", "golffield", "groundtrackfield", "harbor", "overpass", "ship",
    "stadium", "storagetank", "tenniscourt", "trainstation", "vehicle",
    "windmill")
# FAIR1M-v2 fine categories (reference FASTMultiTaskDataset /
# FAIR1Mv2Dataset METAINFO) — FAST is the SAMRS subset built from FAIR1M
FAIR1M_CLASSES = (
    "A220", "A321", "A330", "A350", "ARJ21", "Baseball-Field",
    "Basketball-Court", "Boeing737", "Boeing747", "Boeing777", "Boeing787",
    "Bridge", "Bus", "C919", "Cargo-Truck", "Dry-Cargo-Ship", "Dump-Truck",
    "Engineering-Ship", "Excavator", "Fishing-Boat", "Football-Field",
    "Intersection", "Liquid-Cargo-Ship", "Motorboat", "other-airplane",
    "other-ship", "other-vehicle", "Passenger-Ship", "Roundabout",
    "Small-Car", "Tennis-Court", "Tractor", "Trailer", "Truck-Tractor",
    "Tugboat", "Van", "Warship")
FAST_CLASSES = ("background",) + FAIR1M_CLASSES
FAST_NUM_CLASSES = len(FAST_CLASSES)  # 38 incl. background

# DOTA family (reference mmrotate DOTADataset/DOTAv15/DOTAv2 METAINFO)
DOTA10_CLASSES = (
    "plane", "baseball-diamond", "bridge", "ground-track-field",
    "small-vehicle", "large-vehicle", "ship", "tennis-court",
    "basketball-court", "storage-tank", "soccer-ball-field", "roundabout",
    "harbor", "swimming-pool", "helicopter")
DOTA15_CLASSES = DOTA10_CLASSES + ("container-crane",)
DOTA20_CLASSES = DOTA15_CLASSES + ("airport", "helipad")

# DIOR / DIOR-R 20 classes (reference mmrotate DIORDataset METAINFO)
DIOR_CLASSES = (
    "airplane", "airport", "baseballfield", "basketballcourt", "bridge",
    "chimney", "expressway-service-area", "expressway-toll-station", "dam",
    "golffield", "groundtrackfield", "harbor", "overpass", "ship", "stadium",
    "storagetank", "tenniscourt", "trainstation", "vehicle", "windmill")


def imread(path: str) -> np.ndarray:
    try:  # SIMD decode (the reference's mmcv imfrombytes is cv2 too)
        import cv2
        # IGNORE_ORIENTATION: mmcv's imfrombytes (cv2.imdecode) does not
        # apply EXIF rotation, and neither do the label/annotation files —
        # plain IMREAD_COLOR would rotate EXIF-tagged JPEGs out of
        # alignment with their boxes/masks.
        img = cv2.imread(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
        if img is not None:
            return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32)
    except ImportError:
        pass
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB")).astype(np.float32)


def imread_label(path: str) -> np.ndarray:
    try:
        import cv2
        lbl = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if lbl is not None:
            if lbl.ndim == 3:  # palettized PNGs decode to 3 channels in cv2
                from PIL import Image
                return np.asarray(Image.open(path)).astype(np.int32)
            return lbl.astype(np.int32)
    except ImportError:
        pass
    from PIL import Image
    return np.asarray(Image.open(path)).astype(np.int32)


class MultiTaskDataset:
    """One SAMRS split: images + COCO instance json + PNG seg dir + rotated
    annotations (DOTA txt dir or VOC xml dir)."""

    def __init__(self, img_dir: str, ins_json: str, seg_dir: str,
                 rot_dir: str, class_names: Sequence[str],
                 rot_format: str = "dota",
                 pipeline: Optional[Callable[[Sample, np.random.Generator], Sample]] = None,
                 seed: int = 0):
        self.img_dir = img_dir
        self.seg_dir = seg_dir
        self.rot_dir = rot_dir
        self.rot_format = rot_format
        # detection class names exclude background (reference parse uses the
        # full list minus bg for instances)
        self.class_names = list(class_names)
        self.det_names = [c for c in class_names if c != "background"]
        self.records, _ = load_coco(ins_json)
        # drop images without instances (reference filter_data :1387)
        self.records = [r for r in self.records if len(r.hboxes) > 0]
        self.pipeline = pipeline
        self.seed = seed

    def __len__(self):
        return len(self.records)

    def __getitem__(self, idx: int) -> Sample:
        rec = self.records[idx]
        stem = os.path.splitext(rec.file_name)[0]
        sample: Sample = {
            "image": imread(os.path.join(self.img_dir, rec.file_name)),
            "hboxes": rec.hboxes.copy(),
            "labels": rec.labels.copy(),
            "masks": coco_masks(rec),
        }
        seg_path = os.path.join(self.seg_dir, stem + ".png")
        if os.path.exists(seg_path):
            # reference shifts seg labels +1 so 0 = background
            # (augmentations.py:480-481) — SAMRS PNGs already store class+1
            sample["sem_seg"] = imread_label(seg_path)
        rot_path = os.path.join(
            self.rot_dir, stem + (".txt" if self.rot_format == "dota" else ".xml"))
        if os.path.exists(rot_path):
            if self.rot_format == "dota":
                quads, labels, diff = parse_dota_txt(rot_path, self.det_names)
                keep = diff < 2
                sample["rboxes"] = quads_to_rboxes(quads[keep])
                sample["rlabels"] = labels[keep]
            else:
                rb, lb = parse_voc_rotated_xml(rot_path, self.det_names)
                sample["rboxes"] = rb
                sample["rlabels"] = lb
        else:
            sample["rboxes"] = np.zeros((0, 5), np.float32)
            sample["rlabels"] = np.zeros((0,), np.int32)
        if self.pipeline is not None:
            rng = np.random.default_rng(self.seed * 1_000_003 + idx)
            sample = self.pipeline(sample, rng)
        return sample


class FolderClassification:
    """class-per-subfolder layout (EuroSAT / RESISC-45)."""

    def __init__(self, root: str, pipeline=None, seed: int = 0,
                 extensions=(".jpg", ".png", ".jpeg", ".tif")):
        self.items: List[Tuple[str, int]] = []
        self.classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        for ci, c in enumerate(self.classes):
            cdir = os.path.join(root, c)
            for f in sorted(os.listdir(cdir)):
                if f.lower().endswith(extensions):
                    self.items.append((os.path.join(cdir, f), ci))
        self.pipeline = pipeline
        self.seed = seed

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> Sample:
        path, label = self.items[idx]
        s: Sample = {"image": imread(path), "cls_label": np.int32(label)}
        if self.pipeline is not None:
            s = self.pipeline(s, np.random.default_rng(self.seed * 7 + idx))
        return s


class SegFolder:
    """img_dir + ann_dir parallel folders (SpaceNetV1 / LoveDA layout).
    label_map: optional value remap (e.g. LoveDA reduce_zero_label)."""

    def __init__(self, img_dir: str, ann_dir: str, img_suffix: str = ".png",
                 seg_suffix: str = ".png", pipeline=None,
                 reduce_zero_label: bool = False, seed: int = 0):
        self.img_dir = img_dir
        self.ann_dir = ann_dir
        self.seg_suffix = seg_suffix
        self.items = sorted(
            os.path.splitext(f)[0] for f in os.listdir(img_dir)
            if f.endswith(img_suffix))
        self.img_suffix = img_suffix
        self.pipeline = pipeline
        self.reduce_zero_label = reduce_zero_label
        self.seed = seed

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> Sample:
        stem = self.items[idx]
        seg = imread_label(os.path.join(self.ann_dir, stem + self.seg_suffix))
        if self.reduce_zero_label:
            seg = np.where(seg == 0, 255, seg - 1)
        s: Sample = {
            "image": imread(os.path.join(self.img_dir, stem + self.img_suffix)),
            "sem_seg": seg,
        }
        if self.pipeline is not None:
            s = self.pipeline(s, np.random.default_rng(self.seed * 13 + idx))
        return s


class CocoDetection:
    """COCO-json detection (DIOR horizontal / Xview)."""

    def __init__(self, img_dir: str, ann_json: str, pipeline=None,
                 with_masks: bool = False, seed: int = 0):
        self.img_dir = img_dir
        self.records, self.classes = load_coco(ann_json)
        self.records = [r for r in self.records if len(r.hboxes) > 0]
        self.pipeline = pipeline
        self.with_masks = with_masks
        self.seed = seed

    def __len__(self):
        return len(self.records)

    def __getitem__(self, idx: int) -> Sample:
        rec = self.records[idx]
        s: Sample = {
            "image": imread(os.path.join(self.img_dir, rec.file_name)),
            "hboxes": rec.hboxes.copy(),
            "labels": rec.labels.copy(),
        }
        if self.with_masks:
            s["masks"] = coco_masks(rec)
        if self.pipeline is not None:
            s = self.pipeline(s, np.random.default_rng(self.seed * 17 + idx))
        return s


class RotatedDetection:
    """DOTA-txt, DIOR-R VOC-xml, or raw-FAIR1M-xml rotated detection."""

    def __init__(self, img_dir: str, ann_dir: str, class_names: Sequence[str],
                 fmt: str = "dota", img_suffix: str = ".png", pipeline=None,
                 filter_difficulty: int = 2, seed: int = 0):
        self.img_dir = img_dir
        self.ann_dir = ann_dir
        self.classes = list(class_names)
        self.fmt = fmt
        self.img_suffix = img_suffix
        self.items = sorted(
            os.path.splitext(f)[0] for f in os.listdir(ann_dir)
            if f.endswith(".txt" if fmt == "dota" else ".xml"))
        self.pipeline = pipeline
        self.filter_difficulty = filter_difficulty
        self.seed = seed

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> Sample:
        stem = self.items[idx]
        if self.fmt == "dota":
            quads, labels, diff = parse_dota_txt(
                os.path.join(self.ann_dir, stem + ".txt"), self.classes)
            keep = diff < self.filter_difficulty
            rb, lb = quads_to_rboxes(quads[keep]), labels[keep]
        elif self.fmt == "fair1m":
            from mtp_tpu_torch.data.parsers import parse_fair1m_xml
            quads, lb = parse_fair1m_xml(
                os.path.join(self.ann_dir, stem + ".xml"), self.classes)
            rb = quads_to_rboxes(quads)
        else:
            rb, lb = parse_voc_rotated_xml(
                os.path.join(self.ann_dir, stem + ".xml"), self.classes)
        s: Sample = {
            "image": imread(os.path.join(self.img_dir, stem + self.img_suffix)),
            "rboxes": rb, "rlabels": lb,
        }
        if self.pipeline is not None:
            s = self.pipeline(s, np.random.default_rng(self.seed * 19 + idx))
        return s


class ChangeDetectionPairs:
    """A/B/label folder triplet (LEVIR / WHU / SVCD / OSCD layout)."""

    def __init__(self, a_dir: str, b_dir: str, label_dir: str,
                 suffix: str = ".png", pipeline=None,
                 binarize: bool = True, seed: int = 0):
        self.a_dir, self.b_dir, self.label_dir = a_dir, b_dir, label_dir
        self.suffix = suffix
        self.items = sorted(
            os.path.splitext(f)[0] for f in os.listdir(a_dir)
            if f.endswith(suffix))
        self.pipeline = pipeline
        self.binarize = binarize
        self.seed = seed

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        stem = self.items[idx]
        lab = imread_label(os.path.join(self.label_dir, stem + self.suffix))
        if self.binarize:
            lab = (lab > 0).astype(np.int32)
        s = {
            "image_a": imread(os.path.join(self.a_dir, stem + self.suffix)),
            "image_b": imread(os.path.join(self.b_dir, stem + self.suffix)),
            "label": lab,
        }
        if self.pipeline is not None:
            s = self.pipeline(s, np.random.default_rng(self.seed * 23 + idx))
        return s
