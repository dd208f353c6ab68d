"""COCO-format results export (bbox + segm), the reference IS metric's
`results2json` capability (instance_segmentation/metric.py): detections →
submission-ready JSON with xywh boxes and compressed-RLE masks (the port's
copy of `mtp_tpu/eval/coco_results.py`).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from mtp_tpu_torch.data.parsers import mask_to_rle
from mtp_tpu_torch.eval.host_masks import paste_masks


def detections_to_coco_json(per_image: Sequence[dict], image_ids: Sequence[int],
                            cat_ids: Optional[Sequence[int]] = None,
                            path: Optional[str] = None,
                            with_masks: bool = False,
                            image_sizes: Optional[Sequence] = None) -> List[dict]:
    """per_image: [{'det_boxes' (N,4 x1y1x2y2), 'det_scores', 'det_labels',
    optional 'mask_probs' (N, m, m)}] → COCO results list.

    cat_ids maps contiguous labels back to dataset category ids."""
    results = []
    for rec, img_id, hw in zip(per_image, image_ids,
                               image_sizes or [None] * len(per_image)):
        boxes = np.asarray(rec["det_boxes"])
        scores = np.asarray(rec["det_scores"])
        labels = np.asarray(rec["det_labels"])
        masks = None
        if with_masks and "mask_probs" in rec and hw is not None:
            masks = paste_masks(np.asarray(rec["mask_probs"]), boxes,
                                hw[0], hw[1])
        for i in range(len(boxes)):
            x1, y1, x2, y2 = [float(v) for v in boxes[i]]
            cat = int(labels[i])
            if cat_ids is not None:
                cat = int(cat_ids[cat])
            entry = {"image_id": int(img_id), "category_id": cat,
                     "bbox": [x1, y1, x2 - x1, y2 - y1],
                     "score": float(scores[i])}
            if masks is not None:
                rle = mask_to_rle(masks[i])
                entry["segmentation"] = rle
            results.append(entry)
    if path:
        with open(path, "w") as f:
            json.dump(results, f)
    return results
