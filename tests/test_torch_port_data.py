"""The port's host data path against mtp_tpu's, bit for bit: every pipeline
of `data/pipelines.py` from the same seeds, the parsers on fixtures written
here (COCO with polygons and RLE, DOTA txt, FAIR1M xml, VOC rotated xml,
`quads_to_rboxes`), `Loader` (the prefetch thread and fork workers,
shuffle, drop_last, batch_rows), `bindings.build_train_data` /
`build_eval_data`'s first batches for every task family from on-disk
fixtures, the TTA merge and the COCO results export; and the native host
library (`utils/native`): its five entry points against the numpy paths,
and the evaluators' numbers with and without it."""

from __future__ import annotations

import dataclasses
import json
import logging
import os

import numpy as np
import pytest
import torch
from PIL import Image

from mtp_tpu.data import bindings as jbind
from mtp_tpu.data import loader as jloader
from mtp_tpu.data import parsers as jparsers
from mtp_tpu.data import pipelines as jpipes
from mtp_tpu_torch.data import bindings as pbind
from mtp_tpu_torch.data import loader as ploader
from mtp_tpu_torch.data import parsers as pparsers
from mtp_tpu_torch.data import pipelines as ppipes
from mtp_tpu_torch.utils import native

torch.set_num_threads(1)


def same(a, b, where="") -> None:
    """a and b equal in structure, dtype, shape and every bit."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (where, sorted(a), sorted(b))
        for k in a:
            same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype,
                                                            a.shape, b.shape)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


# ------------------------------------------------------------- samples --

def _boxes(rng, n, H, W):
    xy = rng.uniform(0, [W * 0.7, H * 0.7], (n, 2))
    wh = rng.uniform(4, [W * 0.4, H * 0.4], (n, 2))
    return np.concatenate([xy, np.minimum(xy + wh, [W, H])], -1).astype(np.float32)


def _sample(seed, H=72, W=88, n=5, m=4, sem=True, masks=True, rot=True, hbox=True):
    """A joint sample of every annotation kind (transforms.py's layout).
    Odd seeds' semantic maps are one class but for a corner patch, so that
    most crops fail cat_max_ratio and the crop draws again."""
    rng = np.random.default_rng(seed)
    s = {"image": rng.uniform(0, 255, (H, W, 3)).astype(np.float32)}
    if sem:
        seg = rng.integers(0, 4, (H, W)).astype(np.int32)
        if seed % 2:
            seg[:] = 1
            seg[:H // 4, :W // 5] = 2
        seg[rng.uniform(size=(H, W)) < 0.05] = 255
        s["sem_seg"] = seg
    if hbox:
        b = _boxes(rng, n, H, W)
        s["hboxes"], s["labels"] = b, rng.integers(0, 3, n).astype(np.int32)
        if masks:
            mk = np.zeros((n, H, W), np.uint8)
            for i, (x1, y1, x2, y2) in enumerate(b.astype(int)):
                mk[i, y1:max(y2, y1 + 1), x1:max(x2, x1 + 1)] = 1
            s["masks"] = mk
    if rot:
        s["rboxes"] = np.concatenate([
            rng.uniform([8, 8], [W - 8, H - 8], (m, 2)), rng.uniform(4, 20, (m, 2)),
            rng.uniform(-1.5, 1.5, (m, 1))], -1).astype(np.float32)
        s["rlabels"] = rng.integers(0, 3, m).astype(np.int32)
    return s


def _cls_sample(seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(0, 255, (56, 60, 3)).astype(np.float32),
            "cls_label": np.int32(seed % 5)}


def _cd_sample(seed):
    rng = np.random.default_rng(seed)
    return {"image_a": rng.uniform(0, 255, (70, 66, 3)).astype(np.float32),
            "image_b": rng.uniform(0, 255, (70, 66, 3)).astype(np.float32),
            "label": rng.integers(0, 2, (70, 66)).astype(np.int32)}


# (pipeline factory name, its arguments, sample maker)
PIPELINES = {
    "mtp_train": ("mtp_train_pipeline", (48,), {}, _sample),
    "mtp_valid": ("mtp_valid_pipeline", (48,), {}, _sample),
    "cls_train": ("cls_train_pipeline", (40,), {}, _cls_sample),
    "cls_train_plain": ("cls_train_pipeline", (40,), {"randaugment": False}, _cls_sample),
    "cls_test": ("cls_test_pipeline", (40,), {}, _cls_sample),
    "seg_train": ("seg_train_pipeline", (48,), {},
                  lambda s: _sample(s, hbox=False, rot=False)),
    "seg_test": ("seg_test_pipeline", (), {}, lambda s: _sample(s, hbox=False, rot=False)),
    "seg_test_sized": ("seg_test_pipeline", (64,), {},
                       lambda s: _sample(s, hbox=False, rot=False)),
    "cd_train": ("cd_train_pipeline", (48,), {}, _cd_sample),
    "cd_test": ("cd_test_pipeline", (), {}, _cd_sample),
    "det_train": ("det_train_pipeline", (64,), {},
                  lambda s: _sample(s, sem=False, rot=False)),
    "det_train_rotated": ("det_train_pipeline", (64,),
                          {"flip_prob": 0.75,
                           "directions": ("horizontal", "vertical", "diagonal")},
                          lambda s: _sample(s, sem=False, hbox=False)),
    "det_test": ("det_test_pipeline", (64,), {}, lambda s: _sample(s, sem=False)),
}


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_pipeline_matches_jax(name):
    """Every draw in the same order: eight seeds cover the random branches
    (flips, crops with cat_max_ratio retries, photometric steps,
    RandAugment, rotation)."""
    fn, args, kw, make = PIPELINES[name]
    jfn, pfn = getattr(jpipes, fn)(*args, **kw), getattr(ppipes, fn)(*args, **kw)
    for seed in range(8):
        want = jfn(make(seed), np.random.default_rng(100 + seed))
        got = pfn(make(seed), np.random.default_rng(100 + seed))
        same(want, got, f"{name} seed {seed}")


def test_filter_small_instances_matches_jax():
    s = _sample(3, sem=False, rot=False)
    s["hboxes"][1, 2] = s["hboxes"][1, 0]  # zero width
    s["masks"][2] = 0  # empty mask
    same(jpipes.filter_small_instances(s), ppipes.filter_small_instances(s))
    same(jpipes.filter_small_instances(s, by_mask=False),
         ppipes.filter_small_instances(s, by_mask=False))


# ------------------------------------------------------------- parsers --

def _coco_fixture(path, H=40, W=48, n_imgs=3, seed=0):
    """COCO json: polygons, compressed RLE strings, RLE count lists, a null
    segmentation, crowd flags, non-contiguous category ids."""
    rng = np.random.default_rng(seed)
    images, anns, aid = [], [], 0
    for i in range(n_imgs):
        images.append({"id": 10 + i, "file_name": f"{i}.png", "height": H, "width": W})
        for k in range(4):
            x, y = (int(v) for v in rng.integers(2, 20, 2))
            w, h = (int(v) for v in rng.integers(6, 16, 2))
            mask = np.zeros((H, W), np.uint8)
            mask[y:y + h, x:x + w] = 1
            if k == 0:
                seg = [[x, y, x + w, y, x + w, y + h, x, y + h]]
            elif k == 1:
                seg = jparsers.mask_to_rle(mask)
            elif k == 2:
                flat = np.asfortranarray(mask).T.reshape(-1)
                idx = np.concatenate([[0], np.nonzero(np.diff(flat))[0] + 1, [flat.size]])
                seg = {"size": [H, W], "counts": np.diff(idx).tolist()}
            else:
                seg = None
            anns.append({"id": aid, "image_id": 10 + i, "iscrowd": int(k == 1),
                         "category_id": int(rng.choice([3, 7])),
                         "bbox": [x, y, w, h], "area": w * h, "segmentation": seg})
            aid += 1
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 7, "name": "ship"}, {"id": 3, "name": "plane"}]}, f)


def test_coco_parser_matches_jax(tmp_path):
    path = tmp_path / "ins.json"
    _coco_fixture(path)
    (jrecs, jnames), (precs, pnames) = jparsers.load_coco(str(path)), \
        pparsers.load_coco(str(path))
    assert jnames == pnames == ["plane", "ship"]
    assert len(jrecs) == len(precs) == 3
    for jr, pr in zip(jrecs, precs):
        same(jr, pr)
        same(jparsers.coco_masks(jr), pparsers.coco_masks(pr))
    assert pparsers.coco_masks(precs[0])[1:3].any()


def test_rle_codec_matches_jax():
    rng = np.random.default_rng(5)
    for h, w in ((1, 1), (7, 5), (33, 40)):
        for p in (0.0, 0.3, 1.0):
            m = (rng.uniform(size=(h, w)) < p).astype(np.uint8)
            rle = pparsers.mask_to_rle(m)
            same(jparsers.mask_to_rle(m), rle)
            same(jparsers.rle_to_mask(rle), pparsers.rle_to_mask(rle))
            np.testing.assert_array_equal(pparsers.rle_to_mask(rle), m)
            counts = pparsers.rle_decode_counts(rle["counts"])
            assert counts == jparsers.rle_decode_counts(rle["counts"])
            assert pparsers.rle_encode_counts(counts) == rle["counts"]


def _dota_txt(path, classes, rng, n=6):
    lines = ["imagesource:GoogleEarth", "gsd:0.5"]
    for i in range(n):
        cx, cy = rng.uniform(20, 80, 2)
        w, h, t = rng.uniform(6, 20), rng.uniform(4, 12), rng.uniform(-1.5, 1.5)
        c, s = np.cos(t), np.sin(t)
        pts = [(cx + c * dx - s * dy, cy + s * dx + c * dy)
               for dx, dy in ((-w, -h), (w, -h), (w, h), (-w, h))]
        name = classes[i % len(classes)] if i != 4 else "not-a-class"
        lines.append(" ".join(f"{v:.1f}" for p in pts for v in p)
                     + f" {name} {int(i % 3)}")
    lines.append("1 2 3 4 5 6 7 8")  # too short: skipped
    path.write_text("\n".join(lines) + "\n")


def test_dota_parser_and_quads_match_jax(tmp_path):
    from mtp_tpu_torch.data.datasets import DOTA10_CLASSES
    _dota_txt(tmp_path / "a.txt", DOTA10_CLASSES, np.random.default_rng(2))
    want = jparsers.parse_dota_txt(str(tmp_path / "a.txt"), DOTA10_CLASSES)
    got = pparsers.parse_dota_txt(str(tmp_path / "a.txt"), DOTA10_CLASSES)
    same(want, got)
    assert len(got[0]) == 5
    same(jparsers.quads_to_rboxes(want[0]), pparsers.quads_to_rboxes(got[0]))
    same(jparsers.quads_to_rboxes(np.zeros((0, 8), np.float32)),
         pparsers.quads_to_rboxes(np.zeros((0, 8), np.float32)))


def test_fair1m_and_voc_xml_parsers_match_jax(tmp_path):
    from mtp_tpu_torch.data.datasets import DIOR_CLASSES, FAIR1M_CLASSES
    objs = []
    for i, name in enumerate(("Boeing737", "Small-Car", "not-a-class", "Tugboat")):
        x, y = 10 + 7 * i, 12 + 5 * i
        pts = [(x, y), (x + 9, y + 1), (x + 8, y + 6), (x - 1, y + 5), (x, y)]
        objs.append("<object><possibleresult><name>%s</name></possibleresult><points>%s"
                    "</points></object>" % (name, "".join(
                        f"<point>{px:.1f},{py:.1f}</point>" for px, py in pts)))
    (tmp_path / "f.xml").write_text("<annotation><objects>" + "".join(objs)
                                    + "</objects></annotation>")
    same(jparsers.parse_fair1m_xml(str(tmp_path / "f.xml"), FAIR1M_CLASSES),
         pparsers.parse_fair1m_xml(str(tmp_path / "f.xml"), FAIR1M_CLASSES))
    voc = ("<annotation>"
           "<object><name>ship</name><robndbox><cx>20.5</cx><cy>30</cy><w>12</w>"
           "<h>5.5</h><angle>0.7</angle></robndbox></object>"
           "<object><name>vehicle</name><bndbox><xmin>3</xmin><ymin>4</ymin>"
           "<xmax>13</xmax><ymax>9</ymax></bndbox></object>"
           "<object><name>unknown</name><robndbox><cx>1</cx><cy>1</cy><w>1</w>"
           "<h>1</h><angle>0</angle></robndbox></object>"
           "<object><name>dam</name></object></annotation>")
    (tmp_path / "v.xml").write_text(voc)
    want = jparsers.parse_voc_rotated_xml(str(tmp_path / "v.xml"), DIOR_CLASSES)
    same(want, pparsers.parse_voc_rotated_xml(str(tmp_path / "v.xml"), DIOR_CLASSES))
    assert len(want[0]) == 2


# -------------------------------------------------------------- loader --

class _Toy:
    """A dataset of seeded samples; its pipeline draws from the index's rng
    as the real datasets do."""

    def __init__(self, n, pipes):
        self.n, self.pipe = n, pipes.seg_train_pipeline(32)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.pipe(_sample(i, H=40, W=44, hbox=False, rot=False),
                         np.random.default_rng(i))


@pytest.mark.parametrize("workers,shuffle,drop_last,rows", [
    (0, True, True, None), (0, False, False, None), (2, True, True, None),
    (2, True, False, None), (2, True, True, (1, 2)), (0, True, True, (0, 2))])
def test_loader_matches_jax(workers, shuffle, drop_last, rows):
    n, bs = 11, 3
    kw = dict(shuffle=shuffle, seed=4, drop_last=drop_last, num_workers=workers,
              batch_rows=rows)
    jl = jloader.Loader(_Toy(n, jpipes), bs, jloader.collate_segmentation, **kw)
    pl = ploader.Loader(_Toy(n, ppipes), bs, ploader.collate_segmentation, **kw)
    assert len(jl) == len(pl) == (n // bs if drop_last else -(-n // bs))
    for epoch in (0, 1):
        want, got = list(jl.epoch(epoch)), list(pl.epoch(epoch))
        assert len(got) == len(pl)
        same(want, got, f"epoch {epoch}")
    with pytest.raises(ValueError):
        ploader.Loader(_Toy(n, ppipes), bs, ploader.collate_segmentation, batch_rows=(3,))


def test_collates_match_jax():
    samples = [_sample(s, H=48, W=48) for s in range(3)]
    samples[1]["masks"] = samples[1]["masks"][:0]
    for kw in ({}, {"rotated": True}, {"with_masks": True},
               {"with_masks": True, "mask_mode": "stride"}):
        same(jloader.collate_detection(samples, 6, **kw),
             ploader.collate_detection(samples, 6, **kw), str(kw))
    samples[1]["masks"] = _sample(1, H=48, W=48)["masks"]
    same(jloader.collate_multitask(samples, 4), ploader.collate_multitask(samples, 4))
    same(jloader.collate_multitask(samples, 4, mask_mode="stride"),
         ploader.collate_multitask(samples, 4, mask_mode="stride"))


# ------------------------------------------------------------ bindings --

def _png(path, h, w, seed, k=None):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 255, (h, w, 3), np.uint8) if k is None else \
        rng.integers(0, k, (h, w)).astype(np.uint8)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _fixture(kind, root):
    """(recipe name, dataset on disk under root) for one task family."""
    rng = np.random.default_rng(11)
    if kind == "classification":
        for split in ("train", "val"):
            for ci, c in enumerate(("forest", "river", "sea")):
                for i in range(3):
                    _png(f"{root}/{split}/{c}/{i}.png", 50, 46, ci * 10 + i)
        return "vit-rvsa-b-224-mae-mtp_eurosat"
    if kind in ("segmentation", "loveda"):
        for split in ("train", "val"):
            for i in range(5):
                _png(f"{root}/img_dir/{split}/{i}.png", 80, 72, i)
                _png(f"{root}/ann_dir/{split}/{i}.png", 80, 72, 50 + i,
                     k=3 if kind == "segmentation" else 8)
        return ("rvsa-b-upernet-384-mae-mtp-spacenetv1" if kind == "segmentation"
                else "rvsa-b-upernet-512-mae-mtp-loveda")
    if kind == "change_detection":
        for split in ("train", "val"):
            for i in range(4):
                _png(f"{root}/{split}/A/{i}.png", 72, 72, i)
                _png(f"{root}/{split}/B/{i}.png", 72, 72, 20 + i)
                _png(f"{root}/{split}/label/{i}.png", 72, 72, 40 + i, k=2)
        return "rvsa-b-unet-256-mae-mtp_levir"
    if kind == "instseg":
        for i in range(3):
            _png(f"{root}/images/{i}.png", 40, 48, i)
        _coco_fixture(f"{root}/train.json")
        _coco_fixture(f"{root}/val.json", seed=1)
        return "mask_rcnn_rvsa_b_1024_mae_mtp_coco"
    if kind == "detection_r_xml":
        from mtp_tpu_torch.data.datasets import DIOR_CLASSES
        for split in ("train", "val"):
            for i in range(4):
                _png(f"{root}/{split}/images/{i}.png", 64, 64, i)
                objs = "".join(
                    f"<object><name>{DIOR_CLASSES[int(rng.integers(20))]}</name><robndbox>"
                    f"<cx>{rng.uniform(16, 48):.1f}</cx><cy>{rng.uniform(16, 48):.1f}</cy>"
                    f"<w>{rng.uniform(8, 16):.1f}</w><h>{rng.uniform(8, 16):.1f}</h>"
                    f"<angle>{rng.uniform(-1.2, 1.2):.3f}</angle></robndbox></object>"
                    for _ in range(3))
                os.makedirs(f"{root}/{split}/annfiles", exist_ok=True)
                with open(f"{root}/{split}/annfiles/{i}.xml", "w") as f:
                    f.write("<annotation>" + objs + "</annotation>")
        return "oriented_rcnn_rvsa_b_800_mae_mtp_diorr"
    if kind == "detection_r_dota":
        from mtp_tpu_torch.data.datasets import DOTA10_CLASSES
        for split in ("train", "val"):
            for i in range(4):
                _png(f"{root}/{split}/images/{i}.png", 100, 100, i)
                os.makedirs(f"{root}/{split}/annfiles", exist_ok=True)
                _dota_txt(__import__("pathlib").Path(f"{root}/{split}/annfiles/{i}.txt"),
                          DOTA10_CLASSES, rng)
        return "oriented_rcnn_rvsa_b_1024_mae_mtp_dota10"
    if kind == "multitask":
        for sub, cls in (("sota", ("plane", "ship")), ("sior", ("airplane", "dam")),
                         ("fast", ("Boeing737", "Tugboat"))):
            base = f"{root}/{sub}"
            for split, n in (("train", 4), ("val", 2)):
                images, anns = [], []
                for i in range(n):
                    name = f"{split}{i}.png"
                    _png(f"{base}/images/{name}", 48, 48, i)
                    mask = np.zeros((48, 48), np.uint8)
                    y0, x0 = (int(v) for v in rng.integers(4, 24, 2))
                    mask[y0:y0 + 12, x0:x0 + 16] = 1
                    images.append({"id": i, "file_name": name, "height": 48, "width": 48})
                    anns.append({"id": i, "image_id": i, "category_id": 1, "iscrowd": 0,
                                 "bbox": [x0, y0, 16, 12], "area": 192,
                                 "segmentation": pparsers.mask_to_rle(mask)})
                    os.makedirs(f"{base}/segs", exist_ok=True)
                    Image.fromarray(mask * 2).save(f"{base}/segs/{split}{i}.png")
                    os.makedirs(f"{base}/rots", exist_ok=True)
                    cx, cy = x0 + 8, y0 + 6
                    with open(f"{base}/rots/{split}{i}.txt", "w") as f:
                        f.write(f"{cx-8} {cy-4} {cx+8} {cy-4} {cx+8} {cy+4} {cx-8} "
                                f"{cy+4} {cls[1]} 0\n")
                with open(f"{base}/ins_{split}.json", "w") as f:
                    json.dump({"images": images, "annotations": anns,
                               "categories": [{"id": 0, "name": cls[0]},
                                              {"id": 1, "name": cls[1]}]}, f)
        return "mtp_vit_b_rvsa_448_samrs"
    raise KeyError(kind)


def _small(recipe, size):
    cfg = recipe.task
    return dataclasses.replace(recipe, task=dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, img_size=size)))


@pytest.mark.parametrize("kind", ["classification", "segmentation", "loveda",
                                  "change_detection", "instseg", "detection_r_xml",
                                  "detection_r_dota", "multitask"])
def test_bindings_batches_match_jax(kind, tmp_path):
    """The train iterator's and the eval split's first two batches, from
    the recipe family's pipeline, collate and loader."""
    from mtp_tpu import configs as jconfigs
    from mtp_tpu_torch import configs as pconfigs

    name = _fixture(kind, str(tmp_path))
    size = 48 if kind == "multitask" else 64
    jr, pr = _small(jconfigs.get(name), size), _small(pconfigs.get(name), size)
    bs = 3 if kind == "multitask" else 2
    root = str(tmp_path)
    jt, jinfo = jbind.build_train_data(jr, jr.task, root, bs, max_gts=8)
    pt, pinfo = pbind.build_train_data(pr, pr.task, root, bs, max_gts=8)
    assert jinfo == pinfo
    for i in range(2):
        same(next(jt), next(pt), f"train batch {i}")
    for alloc in ("ratio", "avg"):
        assert pbind.dataset_lengths_and_batches(pr, pr.task, root, bs, alloc=alloc,
                                                 max_gts=8) == \
            jbind.dataset_lengths_and_batches(jr, jr.task, root, bs, alloc=alloc, max_gts=8)
    je = jbind.build_eval_data(jr, jr.task, root, bs, max_gts=8)
    pe = pbind.build_eval_data(pr, pr.task, root, bs, max_gts=8)
    same(list(je)[:2], list(pe)[:2], "eval")
    if kind == "loveda":  # reduce_zero_label: 0 → 255, k → k - 1
        raw = np.asarray(Image.open(tmp_path / "ann_dir" / "val" / "0.png"))
        got = pbind.build_dataset(pr.dataset, pr.task, root, "val", train=False)[0][0]
        np.testing.assert_array_equal(got["sem_seg"][:80, :72],
                                      np.where(raw == 0, 255, raw.astype(np.int32) - 1))


# ---------------------------------------------------- tta, coco results --

def test_tta_matches_jax():
    from mtp_tpu.eval import tta as jtta
    from mtp_tpu_torch.eval import tta as ptta

    rng = np.random.default_rng(3)
    images = rng.uniform(0, 255, (2, 40, 48, 3)).astype(np.float32)

    def predict_for(rotated):
        def predict(imgs):
            r = np.random.default_rng(int(imgs.shape[1]) + int(imgs[0, 0, 0, 0]))
            out = []
            for _ in imgs:
                n = 7
                if rotated:
                    b = np.concatenate([r.uniform(8, 30, (n, 2)), r.uniform(4, 12, (n, 2)),
                                        r.uniform(-1, 1, (n, 1))], -1).astype(np.float32)
                else:
                    b = _boxes(r, n, 40, 48)
                out.append({"det_boxes": b, "det_scores": r.uniform(size=n).astype(np.float32),
                            "det_labels": r.integers(0, 3, n)})
            return out
        return predict

    for rotated in (False, True):
        kw = dict(scales=(1.0, 0.75), flip=True, rotated=rotated, nms_iou=0.3,
                  max_per_img=10, num_classes=3)
        same(jtta.tta_detect(predict_for(rotated), images, **kw),
             ptta.tta_detect(predict_for(rotated), images, **kw))


def test_coco_results_match_jax(tmp_path):
    from mtp_tpu.eval.coco_results import detections_to_coco_json as jexport
    from mtp_tpu_torch.eval.coco_results import detections_to_coco_json as pexport

    rng = np.random.default_rng(1)
    per_image = [{"det_boxes": _boxes(rng, 4, 32, 40), "det_scores": rng.uniform(size=4),
                  "det_labels": rng.integers(0, 2, 4),
                  "mask_probs": rng.uniform(size=(4, 14, 14)).astype(np.float32)}
                 for _ in range(2)]
    kw = dict(image_ids=[5, 9], cat_ids=[3, 7], with_masks=True,
              image_sizes=[(32, 40), (32, 40)])
    want = jexport(per_image, path=str(tmp_path / "j.json"), **kw)
    got = pexport(per_image, path=str(tmp_path / "p.json"), **kw)
    assert want == got and len(got) == 8 and "segmentation" in got[0]
    assert (tmp_path / "j.json").read_text() == (tmp_path / "p.json").read_text()


# -------------------------------------------------------------- native --

@pytest.fixture
def no_native(monkeypatch):
    """The library taken away: every entry point returns None."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)


def test_native_builds_into_the_package():
    assert native.get_lib() is not None
    assert native.LIB.parent.name == "_build" and native.LIB.parent.parent.name == \
        "mtp_tpu_torch"
    assert native.LIB.exists()


def test_native_entry_points_equal_the_numpy_paths(monkeypatch):
    from mtp_tpu_torch.eval.det_map import _on_cpu
    from mtp_tpu_torch.ops.rotated_boxes import quad_overlaps, rbox_overlaps_ref

    rng = np.random.default_rng(9)
    masks = (rng.uniform(size=(6, 23, 31)) < 0.4).astype(np.uint8)
    masks[0] = 0
    with_lib = [(pparsers.mask_to_rle(m), pparsers.rle_to_mask(pparsers.mask_to_rle(m)))
                for m in masks]
    assert native.rle_encode_native(masks[1]) is not None
    a = np.concatenate([rng.uniform(10, 60, (9, 2)), rng.uniform(3, 20, (9, 2)),
                        rng.uniform(-1.5, 1.5, (9, 1))], -1).astype(np.float32)
    b = np.concatenate([a[:4], a[4:] + rng.uniform(-3, 3, (5, 5)).astype(np.float32)])
    rb = native.rbox_iou_native(a, b)
    from mtp_tpu_torch.eval.det_map import rbox_to_quad_np
    qa, qb = rbox_to_quad_np(a), rbox_to_quad_np(b)
    qn = native.quad_iou_native(qa, qb)
    crowd = np.array([0, 1, 0], bool)
    mi = native.mask_iou_native(masks[:4], masks[3:], crowd)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    for m, (rle, dec) in zip(masks, with_lib):
        same(rle, pparsers.mask_to_rle(m))
        same(dec, pparsers.rle_to_mask(rle))
    np.testing.assert_allclose(rb, _on_cpu(rbox_overlaps_ref, a, b), rtol=0, atol=1e-5)
    np.testing.assert_allclose(qn, _on_cpu(quad_overlaps, qa, qb), rtol=0, atol=1e-5)
    from mtp_tpu_torch.eval.coco_eval import _mask_iou_crowd
    dense = _mask_iou_crowd(masks[:4], masks[3:], crowd)
    for x, y in zip(mi, dense):
        np.testing.assert_array_equal(x, y)


def _coco_records(rng, H=40, W=44, n_img=4):
    recs = []
    for _ in range(n_img):
        gb = _boxes(rng, 3, H, W)
        db = np.concatenate([gb + rng.uniform(-2, 2, gb.shape).astype(np.float32),
                             _boxes(rng, 2, H, W)]).clip(0, W - 1)
        labels = rng.integers(0, 2, 3)
        gm = np.zeros((3, H, W), np.uint8)
        dm = np.zeros((5, H, W), np.uint8)
        for i, (x1, y1, x2, y2) in enumerate(gb.astype(int)):
            gm[i, y1:y2 + 1, x1:x2 + 1] = 1
        for i, (x1, y1, x2, y2) in enumerate(db.astype(int)):
            dm[i, y1:y2 + 1, x1:x2 + 1] = 1
        recs.append({"det_boxes": db, "det_scores": rng.uniform(size=5),
                     "det_labels": np.concatenate([labels, rng.integers(0, 2, 2)]),
                     "det_masks": dm, "gt_boxes": gb, "gt_labels": labels, "gt_masks": gm,
                     "gt_crowd": np.array([False, True, False])})
    return recs


def test_evaluators_unchanged_without_native(monkeypatch):
    """coco_eval's segm stats and np_rbox_iou with the library and
    without it."""
    from mtp_tpu_torch.eval.coco_eval import evaluate_coco
    from mtp_tpu_torch.eval.det_map import np_rbox_iou

    rng = np.random.default_rng(4)
    recs = _coco_records(rng)
    a = np.concatenate([rng.uniform(10, 60, (7, 2)), rng.uniform(3, 20, (7, 2)),
                        rng.uniform(-1.5, 1.5, (7, 1))], -1).astype(np.float32)
    assert native.get_lib() is not None
    with_lib = evaluate_coco(recs, 2, iou_type="segm"), np_rbox_iou(a, a[::-1])
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    without = evaluate_coco(recs, 2, iou_type="segm"), np_rbox_iou(a, a[::-1])
    assert with_lib[0] == without[0]
    assert with_lib[0]["mAP"] > 0
    np.testing.assert_allclose(with_lib[1], without[1], rtol=0, atol=1e-5)


def test_native_absent_warns_once_and_falls_back(monkeypatch, tmp_path, caplog):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "SRC", tmp_path / "missing.cc")
    monkeypatch.setattr(native, "LIB", tmp_path / "libmissing.so")
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert native.get_lib() is None
        assert native.get_lib() is None
        m = np.eye(5, dtype=np.uint8)
        np.testing.assert_array_equal(pparsers.rle_to_mask(pparsers.mask_to_rle(m)), m)
    warned = [r for r in caplog.records if r.name == native.__name__]
    assert len(warned) == 1 and "numpy" in warned[0].getMessage()
