"""Training CLI: `python -m mtp_tpu_torch.cli.train <recipe> [options]`.

The port's copy of `mtp_tpu/cli/train.py`: one recipe-registry entry point in
place of the reference's per-suite `tools/train.py <config> --launcher
slurm` entry points and the pretraining `main_pretrain.py` argparse CLI.
It runs on the card unless `--device cpu` is given.  Data parallel runs it
under torchrun, one process a card (NCCL) or a CPU process each (gloo):

    torchrun --nproc_per_node=N -m mtp_tpu_torch.cli.train <recipe> ...

Each rank loads its data rank's rows of every global batch (`--batch-size`
is global); rank 0 writes the logs and the checkpoints.  `--mesh-model T`
shards the model's Megatron layers over T consecutive ranks (tensor
parallelism, `parallel.tensor`; T must divide the world, the heads, the MLP
and the box trunk), and `--mesh-data` is -1 (the world size over T) or that
number:

    torchrun --nproc_per_node=4 -m mtp_tpu_torch.cli.train <recipe> --mesh-model 2 ...

Without torchrun's variables it runs as one process; with them and a
failed rendezvous it raises.  `--pallas` and
`--scan` are accepted and have no effect: the port picks its kernels by the
tensors' device and has one layout.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np


def build_task(recipe, mesh_data: int, mesh_model: int,
               det_overrides: dict = None, tasks=("ss", "is", "rd"),
               device: str = "cuda"):
    """(task, cfg) for the recipe's task kind, on `device`."""
    from mtp_tpu_torch.config import MeshConfig

    cfg = recipe.task
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(
            cfg.train, mesh=MeshConfig(data=mesh_data, model=mesh_model)))

    if cfg.task == "classification":
        from mtp_tpu_torch.tasks.classification import ClassificationTask
        return ClassificationTask(cfg, device=device), cfg
    if cfg.task == "segmentation":
        from mtp_tpu_torch.tasks.segmentation import SegmentationTask
        return SegmentationTask(cfg, device=device), cfg
    if cfg.task == "change_detection":
        from mtp_tpu_torch.tasks.change_detection import ChangeDetectionTask
        return ChangeDetectionTask(cfg, device=device), cfg
    if cfg.task == "multitask":
        from mtp_tpu_torch.tasks.multitask import MultiTaskPretrainTask
        return MultiTaskPretrainTask(cfg, det_overrides=det_overrides,
                                     tasks=tasks, device=device), cfg
    if cfg.task in ("detection_h", "detection_r", "instseg"):
        from mtp_tpu_torch.tasks.detection_task import DetectionTask
        return DetectionTask(cfg, head=detection_head(recipe),
                             det_overrides=det_overrides, device=device), cfg
    raise SystemExit(f"task {cfg.task} has no generic CLI entry point yet; "
                     f"use the task API directly")


def detection_head(recipe) -> str:
    """The DetectionTask head a detection recipe runs."""
    if "retinanet" in recipe.name:
        return "retinanet"
    return {"detection_h": "faster_rcnn", "instseg": "mask_rcnn",
            "detection_r": "oriented_rcnn"}[recipe.task.task]


def shrink_recipe(recipe, img_size):
    """--img-size override for eval/export CLIs: smaller backbone input,
    slide crop clamped to fit."""
    if not img_size:
        return recipe
    cfg = recipe.task
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, img_size=img_size))
    if cfg.slide is not None and cfg.slide.crop > img_size:
        from mtp_tpu_torch.config import SlideConfig
        cfg = dataclasses.replace(cfg, slide=SlideConfig(
            crop=img_size, stride=max(img_size // 2, 1)))
    return dataclasses.replace(recipe, task=cfg)


def _backbone_module(task):
    return getattr(task.model, task.backbone_root[:-1])


def pretrained_backbone(task, cfg, path: str) -> dict:
    """An encoder file (a JAX `.npz` from `save_encoder`, the port's encoder
    artifact or a released `.pth`) → the state dict the task's backbone
    loads, resized to its grid (`ckpt.torch_convert.backbone_state_dict`)."""
    from mtp_tpu_torch.ckpt.store import load_encoder
    from mtp_tpu_torch.ckpt.torch_convert import backbone_state_dict

    features_only = getattr(_backbone_module(task), "features_only", False)
    return backbone_state_dict(load_encoder(path, cfg.backbone), cfg.backbone,
                               features_only=features_only)


def jax_variables_state_dict(task, cfg, variables: dict) -> dict:
    """A JAX full-variables tree (`mtp_tpu.ckpt.store.save_variables`) → the
    task's model state dict, through the task's `ckpt.from_jax` converter."""
    from mtp_tpu_torch.ckpt import from_jax

    if cfg.task == "segmentation":
        return from_jax.segmentor_from_jax(variables, cfg.backbone)
    if cfg.task == "classification":
        return from_jax.classifier_from_jax(variables, cfg.backbone)
    if cfg.task == "change_detection":
        return from_jax.change_detector_from_jax(variables, cfg.backbone)
    if cfg.task == "multitask":
        return from_jax.multitask_from_jax(variables, cfg.backbone)
    if getattr(task, "head", None) == "retinanet":
        return from_jax.retinanet_from_jax(variables, cfg.backbone)
    return from_jax.detector_from_jax(variables, cfg.backbone)


def init_or_restore(task, ckpt, seed: int = 0):
    """Fresh state from `seed`, optionally loaded from
    - the port's checkpoint directory (`ckpt.store.CheckpointStore`: the
      whole state, the newest step);
    - the port's variables file (`ckpt.store.save_variables`: the whole
      model's state dict) or encoder file (`save_encoder`, or a released
      `.pth`);
    - a JAX `.npz`: full variables (`mtp_tpu.ckpt.store.save_variables`,
      through the task's `ckpt.from_jax` converter) or an encoder
      (`save_encoder`, through `backbone_from_jax`)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    if not ckpt:
        return task.init_state(gen)
    cfg = task.cfg
    if os.path.isdir(ckpt):
        from mtp_tpu_torch.ckpt.store import CheckpointStore
        state = task.init_state(gen)
        store = CheckpointStore(ckpt)
        try:
            restored = store.restore(state)
        finally:
            store.close()
        return state if restored is None else restored
    from mtp_tpu_torch.ckpt.store import load_variables, npz_is_full_variables
    if ckpt.endswith(".npz"):
        if not npz_is_full_variables(ckpt):
            return task.init_state(gen, pretrained_backbone=pretrained_backbone(
                task, cfg, ckpt))
        sd = jax_variables_state_dict(task, cfg, load_variables(ckpt))
    else:
        sd = load_variables(ckpt)
        if not any(k.startswith(task.backbone_root) for k in sd):
            return task.init_state(gen, pretrained_backbone=pretrained_backbone(
                task, cfg, ckpt))
    state = task.init_state(gen)
    state.model.load_state_dict(sd)
    return state


def synthetic_data(cfg, batch_size: int):
    """Synthetic batches for --synthetic smoke runs (shape-compatible with
    the recipe): JAX's batches, draw for draw, from the same seed."""
    rng = np.random.default_rng(0)
    s = cfg.backbone.img_size

    def gen():
        while True:
            if cfg.task == "classification":
                yield {"image": rng.standard_normal(
                    (batch_size, s, s, 3)).astype(np.float32),
                    "label": rng.integers(0, cfg.num_classes, batch_size)}
            elif cfg.task == "segmentation":
                yield {"image": rng.standard_normal(
                    (batch_size, s, s, 3)).astype(np.float32),
                    "label": rng.integers(0, cfg.num_classes,
                                          (batch_size, s, s))}
            elif cfg.task == "change_detection":
                yield {"image_a": rng.standard_normal(
                    (batch_size, s, s, 3)).astype(np.float32),
                    "image_b": rng.standard_normal(
                        (batch_size, s, s, 3)).astype(np.float32),
                    "label": rng.integers(0, 2, (batch_size, s, s))}
            elif cfg.task in ("detection_h", "detection_r", "instseg"):
                G = 16
                rotated = cfg.task == "detection_r"
                xy = rng.uniform(s * 0.1, s * 0.6, (batch_size, G, 2))
                wh = rng.uniform(s * 0.05, s * 0.25, (batch_size, G, 2))
                if rotated:
                    boxes = np.concatenate(
                        [xy + wh / 2, wh,
                         rng.uniform(-1.2, 1.2, (batch_size, G, 1))],
                        -1).astype(np.float32)
                else:
                    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
                batch = {
                    "image": rng.standard_normal(
                        (batch_size, s, s, 3)).astype(np.float32),
                    "gt_boxes": boxes,
                    "gt_labels": rng.integers(0, cfg.num_classes,
                                              (batch_size, G)).astype(np.int32),
                    "gt_valid": np.ones((batch_size, G), bool)}
                if cfg.task == "instseg":
                    batch["gt_masks"] = np.ones(
                        (batch_size, G, s // 4, s // 4), np.float32)
                yield batch
            elif cfg.task == "multitask":
                out = {}
                G = 8
                from mtp_tpu_torch.config import SAMRS_CLASSES
                for d, nc in enumerate(SAMRS_CLASSES):
                    xy = rng.uniform(s * 0.1, s * 0.6, (batch_size, G, 2))
                    wh = rng.uniform(s * 0.05, s * 0.25, (batch_size, G, 2))
                    out[f"d{d}"] = {
                        "image": rng.standard_normal(
                            (batch_size, s, s, 3)).astype(np.float32),
                        "ss_label": rng.integers(0, nc, (batch_size, s, s)).astype(np.int32),
                        "gt_boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
                        "gt_labels": rng.integers(0, nc - 1, (batch_size, G)).astype(np.int32),
                        "gt_valid": np.ones((batch_size, G), bool),
                        "gt_masks": np.ones((batch_size, G, s // 4, s // 4), np.float32),
                        "r_gt_boxes": np.concatenate(
                            [xy + wh / 2, wh,
                             rng.uniform(-1.2, 1.2, (batch_size, G, 1))],
                            -1).astype(np.float32),
                        "r_gt_labels": rng.integers(0, nc - 1, (batch_size, G)).astype(np.int32),
                        "r_gt_valid": np.ones((batch_size, G), bool)}
                yield out
            else:
                raise SystemExit(f"--synthetic not supported for {cfg.task}")

    return gen()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("recipe", help="recipe name (see --list)")
    p.add_argument("--list", action="store_true")
    p.add_argument("--steps", type=int, default=None,
                   help="override total steps")
    p.add_argument("--epochs", type=int, default=None,
                   help="epoch-based run length (reference max_epochs, e.g. "
                        "12 for detection): total steps = "
                        "ceil(len(dataset)/batch) * epochs; needs "
                        "--data-root")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--img-size", type=int, default=None,
                   help="override backbone image size (smoke runs)")
    p.add_argument("--det-overrides", default=None,
                   help='JSON dict of DetConfig overrides, e.g. '
                        '\'{"nms_pre":128,"rcnn_num":32}\'')
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory (enables periodic saves)")
    p.add_argument("--ckpt-every", type=int, default=1000)
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint from --ckpt-dir "
                        "(reference --ft/--resume)")
    p.add_argument("--encoder-out", default=None,
                   help="also export the encoder-only file at each save "
                        "(the finetune artifact)")
    p.add_argument("--mesh-data", type=int, default=-1,
                   help="data-parallel width: -1 (the world size over "
                        "--mesh-model) or that number")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="tensor-parallel width: consecutive ranks that shard "
                        "the model's Megatron layers (divides the world, "
                        "the heads, the MLP and the box trunk)")
    p.add_argument("--pretrained", default=None,
                   help="encoder checkpoint (.npz from save_encoder, the "
                        "port's encoder file or a torch .pth)")
    p.add_argument("--work-dir", default="work_dirs")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic data (smoke/benchmark runs)")
    p.add_argument("--data-root", default=None,
                   help="dataset root for real-data training (per-recipe "
                        "layouts: DATASETS.md / mtp_tpu_torch/data/bindings.py)")
    p.add_argument("--max-gts", type=int, default=100,
                   help="fixed-shape padding cap for gt instances per image")
    p.add_argument("--num-workers", type=int, default=0,
                   help="fork-based decode worker processes per loader")
    p.add_argument("--tasks", nargs="+", default=["ss", "is", "rd"],
                   choices=("ss", "is", "rd"),
                   help="multitask pretrain task subset (reference "
                        "main_pretrain.py --tasks); ignored by other tasks")
    p.add_argument("--alloc", choices=("ratio", "avg"), default="ratio",
                   help="multitask per-dataset batch allocation (reference "
                        "--batch_mode)")
    p.add_argument("--eval-after", action="store_true",
                   help="run validation on the val/test split after training")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--scan", action="store_true",
                   help="accepted for the JAX CLI's sake; no effect (the "
                        "port has one block layout)")
    p.add_argument("--remat", action="store_true",
                   help="activation checkpointing per block (reference "
                        "use_ckpt/with_cp)")
    p.add_argument("--pallas", action="store_true",
                   help="accepted for the JAX CLI's sake; no effect (the "
                        "port runs its CUDA kernels on the card and their "
                        "plain versions on the CPU)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default the card)")
    args = p.parse_args(argv)

    from mtp_tpu_torch import configs
    if args.list or args.recipe == "list":
        print("\n".join(configs.available()))
        return 0

    from mtp_tpu_torch.parallel.mesh import init_distributed, initialized

    started = not initialized()
    device = init_distributed(args.device)
    try:
        return _train(args, device)
    finally:
        if started and initialized():
            import torch.distributed as dist
            dist.destroy_process_group()


def _train(args, device) -> int:
    """`main` after the process group: one rank's run."""
    import logging

    import torch

    from mtp_tpu_torch import configs
    from mtp_tpu_torch.parallel.mesh import is_main
    from mtp_tpu_torch.utils.log import JsonlLogger, make_logger

    recipe = configs.get(args.recipe)
    cfg = recipe.task
    if args.steps:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, schedule=dataclasses.replace(
                cfg.train.schedule, total_steps=args.steps)))
    if args.batch_size:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, batch_size=args.batch_size))
    if args.scan or args.remat or args.pallas:
        cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
            cfg.backbone, scan=args.scan or cfg.backbone.scan,
            remat=args.remat or cfg.backbone.remat,
            pallas_attn=args.pallas or cfg.backbone.pallas_attn))
    if args.img_size:
        cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
            cfg.backbone, img_size=args.img_size))
        if cfg.slide is not None and cfg.slide.crop > args.img_size:
            from mtp_tpu_torch.config import SlideConfig
            cfg = dataclasses.replace(cfg, slide=SlideConfig(
                crop=args.img_size, stride=max(args.img_size // 2, 1)))
    if args.epochs:
        if not args.data_root:
            raise SystemExit("--epochs needs --data-root (steps are "
                             "computed from the dataset length)")
        if args.steps:
            raise SystemExit("pass --steps or --epochs, not both")
        from mtp_tpu_torch.data.bindings import dataset_lengths_and_batches
        bs = cfg.train.batch_size
        lengths, sizes = dataset_lengths_and_batches(
            recipe, cfg, args.data_root, bs, alloc=args.alloc,
            max_gts=args.max_gts)
        # multitask: zip of the 3 loaders ends at the shortest (reference
        # main_pretrain.py:689 epoch semantics); min() is a no-op for the
        # single-dataset tasks
        spe = min(-(-n // s) for n, s in zip(lengths, sizes))
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, schedule=dataclasses.replace(
                cfg.train.schedule, total_steps=spe * args.epochs)))
    recipe = dataclasses.replace(recipe, task=cfg)

    det_overrides = json.loads(args.det_overrides) if args.det_overrides else None
    task, cfg = build_task(recipe, args.mesh_data, args.mesh_model,
                           det_overrides, tasks=tuple(args.tasks),
                           device=str(device))
    main_rank = is_main()  # rank 0 logs and prints
    logger = make_logger(log_file=f"{args.work_dir}/{recipe.name}.log"
                         if main_rank else None)
    logger.setLevel(logging.INFO if main_rank else logging.WARNING)
    jsonl = JsonlLogger(f"{args.work_dir}/{recipe.name}.jsonl") if main_rank else None
    logger.info("recipe %s on %s, mesh data %d × model %d", recipe.name, task.device,
                task.mesh.data, task.mesh.model)

    pretrained = None
    if args.pretrained:
        pretrained = pretrained_backbone(task, cfg, args.pretrained)
        logger.info("loaded pretrained encoder from %s", args.pretrained)

    state = task.init_state(torch.Generator().manual_seed(cfg.train.seed),
                            pretrained_backbone=pretrained)

    store = None
    if args.ckpt_dir:
        from mtp_tpu_torch.ckpt.store import CheckpointStore
        store = CheckpointStore(args.ckpt_dir)
        if args.resume:
            restored = store.restore(state)
            if restored is not None:
                state = restored
                logger.info("resumed from step %d", int(state.step))

    # Resume trains only the REMAINDER of the schedule (reference --resume
    # restores start_epoch and continues, main_pretrain.py:486,679) — not
    # total_steps extra iterations past schedule end.
    total_steps = cfg.train.schedule.total_steps
    steps = max(0, total_steps - int(state.step))
    if steps < total_steps:
        logger.info("resume: %d/%d steps already done, %d remaining",
                    int(state.step), total_steps, steps)

    batch_size = args.batch_size or cfg.train.batch_size
    fit_kw = {}
    if args.synthetic:  # the global batch on every rank: fit keeps the rank's rows
        data = synthetic_data(cfg, batch_size)
        fit_kw["global_batch"] = True
    elif args.data_root:
        from mtp_tpu_torch.data.bindings import build_train_data
        data, info = build_train_data(recipe, cfg, args.data_root,
                                      batch_size, max_gts=args.max_gts,
                                      num_workers=args.num_workers,
                                      alloc=args.alloc, mesh=task.mesh)
        logger.info("real data from %s: %s", args.data_root, info)
    else:
        raise SystemExit(
            "pass --data-root <dir> (layouts: DATASETS.md) for real-data "
            "training or --synthetic for smoke runs")

    def log_fn(i, m):
        logger.info("iter %d %s", i, {k: round(v, 4) for k, v in m.items()})
        jsonl.log(i, m)

    if store is not None:
        fit_kw.update(ckpt=store, ckpt_every=args.ckpt_every,
                      encoder_path=args.encoder_out)
    try:
        state, metrics = task.fit(state, data, steps,
                                  log_every=args.log_every, log_fn=log_fn,
                                  **fit_kw)
    finally:
        if store is not None:
            store.close()
        close = getattr(data, "close", None)
        if close is not None:  # stops a loader's workers
            close()
        if jsonl is not None:
            jsonl.close()
    if store is None and args.encoder_out:  # every rank: a sharded encoder is gathered
        from mtp_tpu_torch.ckpt.store import save_encoder
        save_encoder(args.encoder_out, _backbone_module(task))
    logger.info("final %s", metrics)

    eval_metrics = None
    if args.eval_after:
        if not args.data_root:
            raise SystemExit("--eval-after needs --data-root")
        from mtp_tpu_torch.data.bindings import build_eval_data
        eval_iter = build_eval_data(recipe, cfg, args.data_root, batch_size,
                                    max_gts=args.max_gts)
        if eval_iter is None:
            logger.warning("no val/test split under %s — skipping eval",
                           args.data_root)
        else:
            kw = {"coco": True} if cfg.task == "instseg" else {}
            eval_metrics = task.evaluate(state, eval_iter, **kw)
            eval_metrics = {k: v for k, v in eval_metrics.items()
                            if isinstance(v, (int, float))}
            logger.info("eval %s", eval_metrics)

    out = {"recipe": recipe.name, "final": metrics}
    if eval_metrics is not None:
        out["eval"] = eval_metrics
    if main_rank:
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
