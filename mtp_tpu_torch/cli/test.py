"""Evaluation CLI: `python -m mtp_tpu_torch.cli.test <recipe> --ckpt ... [--save-pred dir]`.

The port's copy of `mtp_tpu/cli/test.py`, in place of the reference's
per-suite `tools/test.py <config> <ckpt>` scripts: runs the recipe's eval
protocol (top-k / mIoU with slide / F1 / mAP, incl. segm mAP for mask
recipes) on a real dataset (--data-root) or synthetic smoke data,
optionally saving prediction visualizations — the reference's
SegVisualizationHook / DetVisualizationHook / CDVisualizationHook
capability (segmentation PNGs and box overlays).  `--ckpt` takes the port's
checkpoint directory, the port's variables or encoder file, or a JAX `.npz`
(full variables or an encoder), which carries weights across.  It runs on
the card unless `--device cpu` is given; under torchrun (one process a card,
as `cli.train`) each rank evaluates every W-th batch and rank 0 prints the
world's metrics.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _palette(n: int) -> np.ndarray:
    rng = np.random.default_rng(42)
    return rng.integers(0, 255, (max(n, 2), 3), dtype=np.uint8)


def save_seg_pred(path: str, pred: np.ndarray, num_classes: int):
    from PIL import Image
    palette = _palette(num_classes)
    Image.fromarray(palette[pred.astype(np.int64) % len(palette)]).save(path)


def save_det_pred(path: str, image: np.ndarray, boxes: np.ndarray,
                  scores: np.ndarray, labels: np.ndarray,
                  rotated: bool = False, score_thr: float = 0.3,
                  num_classes: int = 80):
    """Box-overlay visualization (reference DetVisualizationHook): draws
    horizontal rectangles or rotated polygons colored per class."""
    from PIL import Image, ImageDraw
    img = np.clip(image, 0, 255).astype(np.uint8) if image.max() > 2 else \
        np.clip((image - image.min()) / max(np.ptp(image), 1e-6) * 255,
                0, 255).astype(np.uint8)
    pil = Image.fromarray(img)
    draw = ImageDraw.Draw(pil)
    palette = _palette(num_classes)
    for b, s, l in zip(boxes, scores, labels):
        if s < score_thr:
            continue
        color = tuple(int(c) for c in palette[int(l) % len(palette)])
        if rotated:
            from mtp_tpu_torch.eval.det_map import rbox_to_quad_np
            q = rbox_to_quad_np(np.asarray(b, np.float32)[None])[0]
            draw.polygon([(q[0], q[1]), (q[2], q[3]), (q[4], q[5]),
                          (q[6], q[7])], outline=color, width=2)
            tx, ty = float(q[0]), float(q[1])
        else:
            draw.rectangle([float(b[0]), float(b[1]), float(b[2]),
                            float(b[3])], outline=color, width=2)
            tx, ty = float(b[0]), float(b[1])
        draw.text((tx, max(ty - 10, 0)), f"{int(l)}:{s:.2f}", fill=color)
    pil.save(path)


def _on_device(task, images: np.ndarray):
    import torch
    return torch.as_tensor(np.asarray(images, np.float32)).to(task.device)


def _host_dets(dets):
    """Detections → numpy (boxes, scores, labels, valid), fp32 floats."""
    from mtp_tpu_torch.tasks.detection_task import host_detections
    d = host_detections(dets, {})
    return d["boxes"], d["scores"], d["labels"], d["valid"]


def run_format_only(task, state, cfg, recipe, args):
    """Rotated-submission path (reference mmrotate-0.3.4 `tools/test.py
    --format-only` + `MTP_RD_Metric.merge_results`): predict every patch
    image, merge `base__rate__x___y` patches back to source images with
    per-class rotated NMS, write DOTA Task1 txts (+zip) and optionally the
    FAIR1M xml tree."""
    from mtp_tpu_torch.data import transforms as T
    from mtp_tpu_torch.data.bindings import ROTATED_CLASS_TABLES
    from mtp_tpu_torch.data.datasets import imread
    from mtp_tpu_torch.eval.det_map import (merge_dota_patches,
                                            write_dota_submission,
                                            write_fair1m_submission)

    classes = ROTATED_CLASS_TABLES.get(recipe.dataset)
    if classes is None:
        raise SystemExit(f"no class table for dataset {recipe.dataset!r}")
    img_dir = None
    for cand in (os.path.join(args.data_root, args.split, "images"),
                 os.path.join(args.data_root, "images"),
                 os.path.join(args.data_root, args.split)):
        if os.path.isdir(cand):
            img_dir = cand
            break
    if img_dir is None:
        raise SystemExit(f"no images dir under {args.data_root}")
    files = sorted(f for f in os.listdir(img_dir)
                   if f.lower().endswith((".png", ".jpg", ".jpeg", ".tif",
                                          ".bmp")))
    if not files:
        raise SystemExit(f"no images in {img_dir}")

    S = cfg.backbone.img_size
    B = args.batch_size or cfg.train.batch_size
    predict = task.predict_fn()
    per_patch = {}

    def add(stem, boxes, scores, labels):
        rec = per_patch.setdefault(
            stem, {"det_boxes": [], "det_scores": [], "det_labels": []})
        rec["det_boxes"].append(boxes)
        rec["det_scores"].append(scores)
        rec["det_labels"].append(labels)

    def flush(stack, metas):
        with task.autocast():
            boxes, scores, labels, valid = _host_dets(
                predict(_on_device(task, np.stack(stack))))
        for i in range(len(stack)):
            stem, scale, flipped, nw = metas[i]
            v = valid[i]
            b = boxes[i][v].astype(np.float64)
            if len(b):
                if flipped:  # un-mirror: content occupies [0, nw)
                    b[:, 0] = nw - b[:, 0]
                    b[:, 4] = -b[:, 4]
                b[:, :4] /= scale  # back to patch pixels
            add(stem, b, scores[i][v], labels[i][v])

    stack, metas = [], []
    for f in files:
        img = imread(os.path.join(img_dir, f))
        h, w = img.shape[:2]
        stem = os.path.splitext(f)[0]
        variants = [(img, False)]
        if args.tta_flip:  # reference MultiScaleFlipAug flip=True
            variants.append((img[:, ::-1].copy(), True))
        for im, flipped in variants:
            s = T.resize({"image": im}, (S, S), keep_ratio=True)
            # the factor T.resize actually applied (rounded dims), not the
            # ideal min(S/w, S/h) — keeps submission coords exact
            nw = s["image"].shape[1]
            scale = nw / w
            s = T.pad_to(T.normalize(s), (S, S))
            stack.append(s["image"])
            metas.append((stem, scale, flipped, nw))
            if len(stack) == B:
                flush(stack, metas)
                stack, metas = [], []
    if stack:
        flush(stack, metas)

    # collapse TTA variants before the cross-patch merge
    per_patch = {stem: {k: np.concatenate(v[k]) for k in v}
                 for stem, v in per_patch.items()}

    merged = merge_dota_patches(per_patch, len(classes),
                                nms_iou=args.merge_iou,
                                rescale_by_rate=args.rescale_by_rate)
    sub = args.submission_dir or "submit"
    write_dota_submission(merged, classes, sub, zip_path=sub + ".zip")
    if args.fair1m or "fair1m" in recipe.dataset:
        write_fair1m_submission(merged, classes, sub + "_xml")
    print(json.dumps({"recipe": recipe.name, "patches": len(per_patch),
                      "images": len(merged), "submission": sub}))
    return 0


def run_seg_labels(task, state, cfg, args):
    """Full-dataset raw label-PNG export for segmentation (the reference's
    `tools/test.py --out` path: LoveDA submission = these PNGs through
    `tools/prepare_datasets.py loveda-shift`).  One uint8 PNG per source
    image, named by its stem, at original resolution."""
    from PIL import Image
    from mtp_tpu_torch.data import transforms as T
    from mtp_tpu_torch.data.bindings import _first_existing
    from mtp_tpu_torch.data.datasets import imread

    img_dir = _first_existing(
        os.path.join(args.data_root, "img_dir", args.split),
        os.path.join(args.data_root, "images", args.split),
        os.path.join(args.data_root, args.split, "images"))
    if img_dir is None:
        raise SystemExit(f"no {args.split} image dir under {args.data_root}")
    files = sorted(f for f in os.listdir(img_dir)
                   if f.lower().endswith((".png", ".jpg", ".jpeg", ".tif")))
    os.makedirs(args.save_labels, exist_ok=True)

    S = cfg.backbone.img_size
    B = args.batch_size or cfg.train.batch_size
    predict = task.predict_fn()

    def flush(stack, metas):
        with task.autocast():
            pred = predict(_on_device(task, np.stack(stack))).cpu().numpy()
        for i in range(len(stack)):
            stem, (h, w), (nh, nw) = metas[i]
            p = pred[i, :nh, :nw].astype(np.uint8)
            if (nh, nw) != (h, w):
                p = np.asarray(Image.fromarray(p).resize((w, h),
                                                         Image.NEAREST))
            Image.fromarray(p).save(
                os.path.join(args.save_labels, stem + ".png"))

    stack, metas = [], []
    for f in files:
        img = imread(os.path.join(img_dir, f))
        h, w = img.shape[:2]
        s = T.resize({"image": img}, (S, S), keep_ratio=True)
        nh, nw = s["image"].shape[:2]
        s = T.pad_to(T.normalize(s), (S, S))
        stack.append(s["image"])
        metas.append((os.path.splitext(f)[0], (h, w), (nh, nw)))
        if len(stack) == B:
            flush(stack, metas)
            stack, metas = [], []
    if stack:
        flush(stack, metas)
    print(json.dumps({"images": len(files), "labels": args.save_labels}))
    return 0


def save_predictions(task, cfg, batch: dict, args) -> None:
    """Visualizations of the first (up to 4) images of `batch` in
    `args.save_pred`: class-map PNGs, or box overlays."""
    os.makedirs(args.save_pred, exist_ok=True)
    if cfg.task in ("segmentation", "change_detection"):
        fn = task.predict_fn()
        with task.autocast():
            if cfg.task == "change_detection":
                pred = fn(_on_device(task, batch["image_a"]),
                          _on_device(task, batch["image_b"]))
            else:
                pred = fn(_on_device(task, batch["image"]))
        pred = pred.cpu().numpy()
        for i in range(min(4, len(pred))):
            save_seg_pred(os.path.join(args.save_pred, f"pred_{i}.png"),
                          pred[i], cfg.num_classes)
    elif cfg.task in ("detection_h", "detection_r", "instseg"):
        fn = task.predict_fn()
        with task.autocast():
            boxes, scores, labels, valid = _host_dets(
                fn(_on_device(task, batch["image"])))
        rotated = cfg.task == "detection_r"
        for i in range(min(4, len(batch["image"]))):
            v = valid[i]
            save_det_pred(
                os.path.join(args.save_pred, f"pred_{i}.png"),
                np.asarray(batch["image"][i]), boxes[i][v], scores[i][v],
                labels[i][v], rotated=rotated, score_thr=args.score_thr,
                num_classes=cfg.num_classes)


def main(argv=None, return_metrics=False):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("recipe")
    p.add_argument("--ckpt", default=None,
                   help="the port's checkpoint dir, variables or encoder "
                        "file, or a JAX .npz (full variables or encoder)")
    p.add_argument("--mesh-data", type=int, default=-1,
                   help="-1 (the world size) or torchrun's world size")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--data-root", default=None,
                   help="evaluate the recipe's val/test split on disk "
                        "(layouts: DATASETS.md)")
    p.add_argument("--split", default="val")
    p.add_argument("--batches", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--img-size", type=int, default=None,
                   help="override backbone image size (smoke runs)")
    p.add_argument("--max-gts", type=int, default=100)
    p.add_argument("--det-overrides", default=None,
                   help="JSON DetConfig overrides (e.g. shrink nms_pre/"
                        "max_proposals for smoke runs), like cli.train")
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--save-pred", default=None,
                   help="directory for prediction visualizations")
    p.add_argument("--format-only", action="store_true",
                   help="rotated recipes: skip metrics, predict every "
                        "patch under <data-root>/<split>/images, merge "
                        "'base__rate__x___y' patches back to full images "
                        "and write a DOTA Task1 submission (reference "
                        "tools/test.py --format-only)")
    p.add_argument("--submission-dir", default=None,
                   help="output dir for the submission (default ./submit); "
                        "also zipped")
    p.add_argument("--tta-flip", action="store_true",
                   help="format-only: horizontal-flip TTA per patch "
                        "(reference MultiScaleFlipAug flip=True; the "
                        "multi-SCALE part comes from multi-rate tiling)")
    p.add_argument("--merge-iou", type=float, default=0.1,
                   help="per-class NMS IoU for the patch merge")
    p.add_argument("--rescale-by-rate", action="store_true",
                   help="divide multi-scale patch boxes by their rate "
                        "segment on merge")
    p.add_argument("--fair1m", action="store_true",
                   help="also write the FAIR1M per-image xml tree")
    p.add_argument("--save-labels", default=None,
                   help="segmentation: skip metrics, predict EVERY "
                        "<data-root> {split} image and write raw uint8 "
                        "label PNGs (reference tools/test.py --out; feed "
                        "LoveDA's through loveda-shift for submission)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default the card)")
    args = p.parse_args(argv)

    from mtp_tpu_torch.parallel.mesh import init_distributed, initialized

    started = not initialized()
    device = init_distributed(args.device)
    try:
        return _test(args, str(device), return_metrics)
    finally:
        if started and initialized():
            import torch.distributed as dist
            dist.destroy_process_group()


def _test(args, device: str, return_metrics: bool):
    """`main` after the process group: one rank's evaluation."""
    from mtp_tpu_torch import configs
    from mtp_tpu_torch.cli.train import (build_task, init_or_restore,
                                         shrink_recipe, synthetic_data)
    from mtp_tpu_torch.parallel.mesh import is_main

    recipe = shrink_recipe(configs.get(args.recipe), args.img_size)
    det_overrides = (json.loads(args.det_overrides)
                     if args.det_overrides else None)
    task, cfg = build_task(recipe, args.mesh_data, 1, det_overrides,
                           device=device)
    batch_size = args.batch_size or cfg.train.batch_size
    state = init_or_restore(task, args.ckpt)

    if args.format_only:
        if cfg.task != "detection_r":
            raise SystemExit("--format-only is the rotated-submission path "
                             "(detection_r recipes)")
        if not args.data_root:
            raise SystemExit("--format-only needs --data-root")
        return run_format_only(task, state, cfg, recipe, args)
    if args.save_labels:
        if cfg.task != "segmentation":
            raise SystemExit("--save-labels is the segmentation label-PNG "
                             "export path")
        if not args.data_root:
            raise SystemExit("--save-labels needs --data-root")
        return run_seg_labels(task, state, cfg, args)

    if args.synthetic:
        gen = synthetic_data(cfg, batch_size)
        batches = [next(gen) for _ in range(args.batches)]
    elif args.data_root:
        from mtp_tpu_torch.data.bindings import build_eval_data
        it = build_eval_data(recipe, cfg, args.data_root, batch_size,
                             max_gts=args.max_gts, split=args.split)
        if it is None:
            raise SystemExit(f"no {args.split}/test split under "
                             f"{args.data_root}")
        batches = list(it)
    else:
        raise SystemExit("pass --data-root <dir> or --synthetic")

    kw = {"coco": True} if cfg.task == "instseg" else {}
    res = task.evaluate(state, iter(batches), **kw)

    if args.save_pred and is_main():
        save_predictions(task, cfg, batches[0], args)

    if is_main():
        print(json.dumps({"recipe": recipe.name,
                          "results": {k: (round(v, 4) if isinstance(v, float) else v)
                                      for k, v in res.items()
                                      if not isinstance(v, list)}}))
    if return_metrics:
        return {k: v for k, v in res.items() if not isinstance(v, list)}
    return 0


if __name__ == "__main__":
    sys.exit(main())
