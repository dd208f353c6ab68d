"""Annotation parsers: COCO JSON (+RLE codec), DOTA txt, VOC rotated xml,
polygon rasterization (the port's copy of `mtp_tpu/data/parsers.py`).

Capability parity with the reference data layer (datasets.py COCO load
:1160-1183 / parse_data_info :1229-1385, scripts/convert_pkl_json.py RLE
encoding, DOTA txt rboxes :1302-1322, VOC xml rboxes :1324-1374) without
pycocotools — the COCO compressed-RLE codec is implemented here directly.
"""

from __future__ import annotations

import json
import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# COCO RLE codec (column-major, LEB128-ish char encoding — pycocotools
# compatible)
# ---------------------------------------------------------------------------

def rle_decode_counts(s: str) -> List[int]:
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            i += 1
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_encode_counts(counts: Sequence[int]) -> str:
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10)) or
                        (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def rle_to_mask(rle: Dict) -> np.ndarray:
    """{'size': [h, w], 'counts': str|list} → (h, w) uint8 mask.

    Uses the C++ host kernel (native/mtp_native.cc) when built, with a numpy
    fallback."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = rle_decode_counts(counts)
    from mtp_tpu_torch.utils.native import rle_decode_native
    native = rle_decode_native(np.asarray(counts, np.int64), h, w)
    if native is not None:
        return native
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape(w, h).T  # column-major


def mask_to_rle(mask: np.ndarray) -> Dict:
    """(h, w) binary mask → compressed RLE dict (C++ kernel when built)."""
    h, w = mask.shape
    from mtp_tpu_torch.utils.native import rle_encode_native
    counts = rle_encode_native(mask.astype(np.uint8))
    if counts is None:
        flat = np.asfortranarray(mask.astype(np.uint8)).T.reshape(-1)
        changes = np.nonzero(np.diff(flat))[0] + 1
        idx = np.concatenate([[0], changes, [len(flat)]])
        counts = np.diff(idx).tolist()
        if flat[0] == 1:
            counts = [0] + counts
    return {"size": [h, w], "counts": rle_encode_counts(counts)}


def polygons_to_mask(polys: Sequence[Sequence[float]], h: int, w: int) -> np.ndarray:
    """COCO polygon lists → (h, w) uint8 mask (PIL rasterization)."""
    from PIL import Image, ImageDraw
    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for p in polys:
        if len(p) >= 6:
            draw.polygon([(p[i], p[i + 1]) for i in range(0, len(p), 2)],
                         outline=1, fill=1)
    return np.asarray(img, np.uint8)


# ---------------------------------------------------------------------------
# COCO JSON
# ---------------------------------------------------------------------------

@dataclass
class CocoImage:
    id: int
    file_name: str
    height: int
    width: int
    hboxes: np.ndarray      # (N, 4) x1y1x2y2
    labels: np.ndarray      # (N,) contiguous 0-based
    iscrowd: np.ndarray     # (N,) bool
    segmentations: list     # raw seg entries (RLE dict or polygon list)


def load_coco(path: str) -> Tuple[List[CocoImage], List[str]]:
    """Parse a COCO instance file → per-image records + class names.
    Category ids are remapped to contiguous 0-based labels."""
    with open(path) as f:
        coco = json.load(f)
    cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
    cat_map = {c["id"]: i for i, c in enumerate(cats)}
    names = [c["name"] for c in cats]

    by_img: Dict[int, list] = {}
    for ann in coco.get("annotations", []):
        by_img.setdefault(ann["image_id"], []).append(ann)

    images = []
    for im in coco.get("images", []):
        anns = by_img.get(im["id"], [])
        boxes, labels, crowd, segs = [], [], [], []
        for a in anns:
            x, y, w, h = a["bbox"]
            boxes.append([x, y, x + w, y + h])
            labels.append(cat_map[a["category_id"]])
            crowd.append(bool(a.get("iscrowd", 0)))
            segs.append(a.get("segmentation"))
        images.append(CocoImage(
            id=im["id"], file_name=im["file_name"],
            height=im["height"], width=im["width"],
            hboxes=np.asarray(boxes, np.float32).reshape(-1, 4),
            labels=np.asarray(labels, np.int32),
            iscrowd=np.asarray(crowd, bool),
            segmentations=segs))
    return images, names


def coco_masks(rec: CocoImage) -> np.ndarray:
    """Decode all segmentations of an image → (N, H, W) uint8."""
    out = np.zeros((len(rec.segmentations), rec.height, rec.width), np.uint8)
    for i, seg in enumerate(rec.segmentations):
        if seg is None:
            continue
        if isinstance(seg, dict):
            out[i] = rle_to_mask(seg)
        else:
            out[i] = polygons_to_mask(seg, rec.height, rec.width)
    return out


# ---------------------------------------------------------------------------
# DOTA txt + VOC rotated xml
# ---------------------------------------------------------------------------

def parse_dota_txt(path: str, class_names: Sequence[str]
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """DOTA annotation txt → (quads (N, 8), labels (N,), difficulty (N,)).

    Lines: x1 y1 x2 y2 x3 y3 x4 y4 class difficulty.  Degenerate polygons
    (repeated points) are kept here; the dataset filter drops them like the
    reference (datasets.py:1311-1313)."""
    name_map = {n: i for i, n in enumerate(class_names)}
    quads, labels, diff = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) < 9 or parts[0].startswith(("imagesource", "gsd")):
                continue
            try:
                pts = [float(v) for v in parts[:8]]
            except ValueError:
                continue
            cls = parts[8]
            if cls not in name_map:
                continue
            quads.append(pts)
            labels.append(name_map[cls])
            diff.append(int(parts[9]) if len(parts) > 9 else 0)
    return (np.asarray(quads, np.float32).reshape(-1, 8),
            np.asarray(labels, np.int32), np.asarray(diff, np.int32))


def parse_fair1m_xml(path: str, class_names: Sequence[str]
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Raw FAIR1M label xml → (quads (N, 8), labels (N,)).

    Format: <objects><object><possibleresult><name>CLS</name></possibleresult>
    <points><point>x,y</point>×5</points></object>… (the 5th point repeats
    the 1st).  The reference consumes the DOTA-txt conversion of these
    files (mmrotate fair1m.py load_annotations); this parser reads the raw
    distribution directly."""
    name_map = {n: i for i, n in enumerate(class_names)}
    tree = ET.parse(path)
    quads, labels = [], []
    for obj in tree.findall(".//object"):
        name = obj.findtext(".//possibleresult/name") or obj.findtext("name")
        pts = [p.text for p in obj.findall(".//points/point")]
        if name is None or len(pts) < 4:
            continue
        xy = []
        for p in pts[:4]:
            x, y = p.split(",")
            xy += [float(x), float(y)]
        quads.append(xy)
        labels.append(name_map.get(name, -1))
    q = np.asarray(quads, np.float32).reshape(-1, 8)
    lb = np.asarray(labels, np.int32)
    keep = lb >= 0
    return q[keep], lb[keep]


def parse_voc_rotated_xml(path: str, class_names: Sequence[str]
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """VOC xml with robndbox (cx, cy, w, h, angle) → (rboxes (N, 5), labels)."""
    name_map = {n: i for i, n in enumerate(class_names)}
    tree = ET.parse(path)
    rboxes, labels = [], []
    for obj in tree.findall(".//object"):
        name_el = obj.find("name")
        rb = obj.find("robndbox")
        if rb is None:
            bnd = obj.find("bndbox")
            if bnd is None:
                continue
            x1 = float(bnd.findtext("xmin"))
            y1 = float(bnd.findtext("ymin"))
            x2 = float(bnd.findtext("xmax"))
            y2 = float(bnd.findtext("ymax"))
            rboxes.append([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1, 0.0])
        else:
            rboxes.append([float(rb.findtext("cx")), float(rb.findtext("cy")),
                           float(rb.findtext("w")), float(rb.findtext("h")),
                           float(rb.findtext("angle"))])
        name = name_el.text if name_el is not None else ""
        labels.append(name_map.get(name, -1))
    rb = np.asarray(rboxes, np.float32).reshape(-1, 5)
    lb = np.asarray(labels, np.int32)
    keep = lb >= 0
    return rb[keep], lb[keep]


def quads_to_rboxes(quads: np.ndarray) -> np.ndarray:
    """(N, 8) → (N, 5) minimum-area rboxes (numpy mirror of
    ops.rotated_boxes.qbox_to_rbox, host-side)."""
    if len(quads) == 0:
        return np.zeros((0, 5), np.float32)
    pts = quads.reshape(-1, 4, 2)
    out = np.zeros((len(pts), 5), np.float32)
    for i, p in enumerate(pts):
        e = np.roll(p, -1, axis=0) - p
        angles = np.arctan2(e[:, 1], e[:, 0])
        best_area, best = np.inf, None
        for a in angles:
            c, s = math.cos(-a), math.sin(-a)
            rot = np.array([[c, -s], [s, c]])
            q = p @ rot.T
            mn, mx = q.min(0), q.max(0)
            wh = mx - mn
            area = wh[0] * wh[1]
            if area < best_area:
                center = (mn + mx) / 2 @ np.array([[c, s], [-s, c]]).T
                best_area = area
                best = [center[0], center[1], wh[0], wh[1], a]
        out[i] = best
    # le90 regularization
    cx, cy, w, h, t = out.T
    swap = w < h
    w2 = np.where(swap, h, w)
    h2 = np.where(swap, w, h)
    t2 = np.where(swap, t + math.pi / 2, t)
    t2 = (t2 + math.pi / 2) % math.pi - math.pi / 2
    return np.stack([cx, cy, w2, h2, t2], -1).astype(np.float32)
