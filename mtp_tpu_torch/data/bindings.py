"""Recipe → real-dataset bindings for the CLI (the port's copy of
`mtp_tpu/data/bindings.py`).

Replaces the reference's per-config dataset wiring (each mmengine config
carries data_root + pipeline, e.g. Semantic_Segmentation/configs/mtp/
spacenetv1/rvsa-b-upernet-384-mae-mtp-spacenetv1.py): given a recipe and a
`--data-root`, build the train iterator (and val loader when a val split is
on disk) with the recipe-family default pipeline and collator.

On-disk layouts (documented in DATASETS.md):
- classification:    {root}/{split}/<class>/*.jpg     (or classes at {root}/)
- segmentation:      {root}/img_dir/{split}/ + {root}/ann_dir/{split}/
- change detection:  {root}/{split}/A|B|label/
- horizontal det:    {root}/images/ + {root}/{split}.json     (COCO)
- rotated det:       {root}/{split}/images/ + {root}/{split}/annfiles/
                     (mmrotate split layout; DOTA txt or VOC xml)
- multitask (SAMRS): {root}/{sota,sior,fast}/ each with images/,
                     ins_{split}.json, segs/, rots/
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np

from mtp_tpu_torch.data import pipelines as P
from mtp_tpu_torch.data.datasets import (ChangeDetectionPairs, CocoDetection,
                                   DIOR_CLASSES, DOTA10_CLASSES,
                                   DOTA15_CLASSES, DOTA20_CLASSES,
                                   FAIR1M_CLASSES, FAST_CLASSES,
                                   FolderClassification, MultiTaskDataset,
                                   RotatedDetection, SegFolder, SIOR_CLASSES,
                                   SOTA_CLASSES)
from mtp_tpu_torch.data.loader import (Loader, collate_detection, collate_multitask,
                                 collate_segmentation)

ROTATED_CLASS_TABLES = {
    "dota10": DOTA10_CLASSES,
    "dota15": DOTA15_CLASSES,
    "dota20": DOTA20_CLASSES,
    "dior-r": DIOR_CLASSES,
    "fair1m": FAIR1M_CLASSES,
}


def _first_existing(*paths: str) -> Optional[str]:
    for p in paths:
        if p and os.path.exists(p):
            return p
    return None


def collate_classification(samples) -> Dict[str, np.ndarray]:
    return {"image": np.stack([s["image"] for s in samples]).astype(np.float32),
            "label": np.asarray([s["cls_label"] for s in samples], np.int32)}


def collate_cd(samples) -> Dict[str, np.ndarray]:
    return {"image_a": np.stack([s["image_a"] for s in samples]).astype(np.float32),
            "image_b": np.stack([s["image_b"] for s in samples]).astype(np.float32),
            "label": np.stack([s["label"] for s in samples]).astype(np.int32)}


_DATASET_CACHE: Dict[tuple, object] = {}


def build_dataset(recipe_dataset: str, cfg, data_root: str,
                  split: str = "train", train: bool = True,
                  max_gts: int = 100):
    """(dataset, collate_fn) for one split, or None if the split is absent
    on disk.  Memoized — the CLI probes lengths (--epochs) before building
    the training loader and annotation parsing shouldn't run twice."""
    key = (recipe_dataset, cfg.task, cfg.backbone.img_size,
           os.path.abspath(data_root), split, train, max_gts)
    if key not in _DATASET_CACHE:
        _DATASET_CACHE[key] = _build_dataset(recipe_dataset, cfg, data_root,
                                             split, train, max_gts)
    return _DATASET_CACHE[key]


def _build_dataset(recipe_dataset: str, cfg, data_root: str,
                   split: str, train: bool, max_gts: int):
    s = cfg.backbone.img_size
    task = cfg.task
    name = recipe_dataset

    if task == "classification":
        root = os.path.join(data_root, split)
        if not os.path.isdir(root):
            if not train:
                return None  # no val/test split on disk
            root = data_root  # class folders directly at the root
        pipe = P.cls_train_pipeline(s) if train else P.cls_test_pipeline(s)
        ds = FolderClassification(root, pipeline=pipe)
        if not len(ds):
            return None
        return ds, collate_classification

    if task == "segmentation":
        img = _first_existing(os.path.join(data_root, "img_dir", split),
                              os.path.join(data_root, "images", split))
        ann = _first_existing(os.path.join(data_root, "ann_dir", split),
                              os.path.join(data_root, "annotations", split))
        if img is None or ann is None:
            return None
        # eval at ORIGINAL resolution (reference test pipelines do not
        # resize; slide inference covers large tiles)
        pipe = P.seg_train_pipeline(s) if train else P.seg_test_pipeline()
        suffix = ".png"
        for f in os.listdir(img):
            if "." in f:
                suffix = os.path.splitext(f)[1]
                break
        ds = SegFolder(img, ann, img_suffix=suffix, pipeline=pipe,
                       reduce_zero_label=(name == "loveda"))
        return ds, collate_segmentation

    if task == "change_detection":
        base = os.path.join(data_root, split)
        if not os.path.isdir(base):
            if not train:
                return None
            base = data_root
        a, b = os.path.join(base, "A"), os.path.join(base, "B")
        lab = _first_existing(os.path.join(base, "label"),
                              os.path.join(base, "OUT"))
        if not (os.path.isdir(a) and os.path.isdir(b) and lab):
            return None
        suffix = ".png"
        for f in os.listdir(a):
            if "." in f:
                suffix = os.path.splitext(f)[1]
                break
        pipe = P.cd_train_pipeline(s) if train else P.cd_test_pipeline()
        ds = ChangeDetectionPairs(a, b, lab, suffix=suffix, pipeline=pipe)
        return ds, collate_cd

    if task in ("detection_h", "instseg"):
        ann = _first_existing(os.path.join(data_root, f"{split}.json"),
                              os.path.join(data_root, "annotations",
                                           f"{split}.json"))
        img = _first_existing(os.path.join(data_root, "images"),
                              os.path.join(data_root, split, "images"),
                              data_root)
        if ann is None or img is None:
            return None
        pipe = P.det_train_pipeline(s) if train else P.det_test_pipeline(s)
        ds = CocoDetection(img, ann, pipeline=pipe,
                           with_masks=(task == "instseg"))
        def collate(samples):
            return collate_detection(samples, max_gts,
                                     with_masks=(task == "instseg"))
        return ds, collate

    if task == "detection_r":
        classes = ROTATED_CLASS_TABLES.get(name)
        if classes is None:
            raise SystemExit(f"no class table for rotated dataset {name!r}; "
                             f"known: {sorted(ROTATED_CLASS_TABLES)}")
        base = os.path.join(data_root, split)
        if not os.path.isdir(base):
            if not train:
                return None
            base = data_root
        img = _first_existing(os.path.join(base, "images"), base)
        ann = _first_existing(os.path.join(base, "annfiles"),
                              os.path.join(base, "labelTxt"),
                              os.path.join(base, "annotations"))
        if img is None or ann is None:
            return None
        fmt = "dota"
        xmls = [f for f in os.listdir(ann) if f.endswith(".xml")]
        if xmls:
            with open(os.path.join(ann, xmls[0])) as fh:
                head = fh.read(4096)
            # raw FAIR1M xml uses <points>; DIOR-R VOC uses <robndbox>
            fmt = "fair1m" if "<points>" in head else "xml"
        suffix = ".png"
        for f in os.listdir(img):
            if f.lower().endswith((".png", ".jpg", ".tif")):
                suffix = os.path.splitext(f)[1]
                break
        pipe = (P.det_train_pipeline(
                    s, flip_prob=0.75,
                    directions=("horizontal", "vertical", "diagonal"))
                if train else P.det_test_pipeline(s))
        ds = RotatedDetection(img, ann, classes, fmt=fmt, img_suffix=suffix,
                              pipeline=pipe)
        def collate(samples):
            return collate_detection(samples, max_gts, rotated=True)
        return ds, collate

    raise SystemExit(f"task {task} has no dataset binding")


_SAMRS = (("sota", SOTA_CLASSES), ("sior", SIOR_CLASSES),
          ("fast", FAST_CLASSES))


# annotation parsing is the expensive part of dataset construction; the CLI
# may need lengths (--epochs) before it builds the training loaders, so the
# built dataset objects are memoized per (root, img_size, split, train)
_SAMRS_CACHE: Dict[tuple, list] = {}


def _samrs_datasets(data_root: str, img_size: int, split: str, train: bool):
    key = (os.path.abspath(data_root), img_size, split, train)
    if key in _SAMRS_CACHE:
        return _SAMRS_CACHE[key]
    pipe = (P.mtp_train_pipeline(img_size) if train
            else P.mtp_valid_pipeline(img_size))
    datasets = []
    for sub, classes in _SAMRS:
        base = os.path.join(data_root, sub)
        ins = _first_existing(os.path.join(base, f"ins_{split}.json"),
                              os.path.join(base, "ins.json"))
        if ins is None:
            raise SystemExit(
                f"SAMRS layout: missing {base}/ins_{split}.json "
                "(build with tools/prepare_datasets.py samrs-pkl-to-coco)")
        rot = _first_existing(os.path.join(base, "rots"),
                              os.path.join(base, "annfiles"))
        fmt = "dota"
        if rot and any(f.endswith(".xml") for f in os.listdir(rot)):
            fmt = "xml"
        datasets.append(MultiTaskDataset(
            os.path.join(base, "images"), ins, os.path.join(base, "segs"),
            rot or os.path.join(base, "rots"), classes, rot_format=fmt,
            pipeline=pipe))
    _SAMRS_CACHE[key] = datasets
    return datasets


def _rows(mesh, batch_size: int):
    """The Loader's `batch_rows` under data parallel (`parallel.mesh`): this
    rank's rows of each global batch; None on one process."""
    if mesh is None or mesh.data == 1:
        return None
    from mtp_tpu_torch.parallel.mesh import process_batch_rows
    return process_batch_rows(mesh, batch_size)


def build_samrs_loaders(data_root: str, img_size: int, batch_size: int,
                        split: str = "train", train: bool = True,
                        max_gts: int = 100, alloc: str = "ratio",
                        num_workers: int = 0, mesh=None):
    """The 3 SAMRS per-dataset loaders + per-dataset batch sizes (reference
    main_pretrain.py batch allocation); with a data-parallel `mesh`, each
    loader loads this rank's rows of its dataset's global batch."""
    from mtp_tpu_torch.tasks.multitask import allocate_batch_sizes

    datasets = _samrs_datasets(data_root, img_size, split, train)
    sizes = allocate_batch_sizes(batch_size, [len(d) for d in datasets],
                                 mode=alloc)
    loaders = [Loader(d, bs, lambda ss: collate_multitask(ss, max_gts),
                      shuffle=train, num_workers=num_workers,
                      batch_rows=_rows(mesh, bs))
               for d, bs in zip(datasets, sizes)]
    return datasets, loaders, sizes


def samrs_iterator(loaders) -> Iterator[Dict[str, Dict[str, np.ndarray]]]:
    """Zip the 3 loaders into the multitask batch dict (reference zips the
    3 DataLoaders, main_pretrain.py:689-701)."""
    its = [l.forever() for l in loaders]
    while True:
        yield {f"d{d}": next(it) for d, it in enumerate(its)}


def dataset_lengths_and_batches(recipe, cfg, data_root: str,
                                batch_size: int, alloc: str = "ratio",
                                max_gts: int = 100):
    """([len(ds), ...], [per-dataset batch, ...]) for --epochs step sizing;
    multitask returns the 3 SAMRS entries under the SAME allocation the
    training loaders will use, single-task one entry.  Uses the memoized
    constructors, so the later build_train_data reuses the parsed datasets."""
    if cfg.task == "multitask":
        from mtp_tpu_torch.tasks.multitask import allocate_batch_sizes
        datasets = _samrs_datasets(data_root, cfg.backbone.img_size,
                                   "train", True)
        lengths = [len(d) for d in datasets]
        return lengths, list(allocate_batch_sizes(batch_size, lengths,
                                                  mode=alloc))
    built = build_dataset(recipe.dataset, cfg, data_root, "train",
                          train=True, max_gts=max_gts)
    if built is None:
        raise SystemExit(f"no train split under {data_root}")
    return [len(built[0])], [batch_size]


def build_train_data(recipe, cfg, data_root: str, batch_size: int,
                     max_gts: int = 100, num_workers: int = 0,
                     alloc: str = "ratio", mesh=None):
    """(forever-iterator, info dict) for the CLI train loop; `batch_size` is
    the global batch, of which a data-parallel `mesh`'s rank loads its rows
    (`Loader(batch_rows=...)`)."""
    if cfg.task == "multitask":
        datasets, loaders, sizes = build_samrs_loaders(
            data_root, cfg.backbone.img_size, batch_size, max_gts=max_gts,
            num_workers=num_workers, alloc=alloc, mesh=mesh)
        info = {"datasets": [len(d) for d in datasets],
                "batch_sizes": list(sizes)}
        return samrs_iterator(loaders), info
    built = build_dataset(recipe.dataset, cfg, data_root, "train",
                          train=True, max_gts=max_gts)
    if built is None:
        raise SystemExit(
            f"no train split for {recipe.dataset!r} under {data_root} "
            "(expected layout: see DATASETS.md / data/bindings.py)")
    ds, collate = built
    loader = Loader(ds, batch_size, collate, shuffle=True,
                    num_workers=num_workers, batch_rows=_rows(mesh, batch_size))
    return loader.forever(), {"dataset": len(ds)}


def build_eval_data(recipe, cfg, data_root: str, batch_size: int,
                    max_gts: int = 100, split: str = "val"):
    """Eval-split iterator (one epoch) or None when absent on disk."""
    if cfg.task == "multitask":
        try:
            _, loaders, _ = build_samrs_loaders(
                data_root, cfg.backbone.img_size, batch_size, split=split,
                train=False, max_gts=max_gts)
        except SystemExit:
            return None
        def epoch():
            for batch in zip(*(l.epoch(0) for l in loaders)):
                yield {f"d{d}": b for d, b in enumerate(batch)}
        return epoch()
    if cfg.task in ("segmentation", "change_detection"):
        # original-resolution eval: sizes can vary per image, and the
        # reference val/test loaders run batch_size=1 anyway
        batch_size = 1
    for sp in (split, "test"):
        built = build_dataset(recipe.dataset, cfg, data_root, sp,
                              train=False, max_gts=max_gts)
        if built is not None:
            ds, collate = built
            return Loader(ds, batch_size, collate, shuffle=False,
                          drop_last=False).epoch(0)
    return None
