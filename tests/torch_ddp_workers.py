"""The rank processes of the port's data- and tensor-parallel tests
(`tests/test_torch_port_ddp.py`, `tests/test_torch_port_ddp_det.py`,
`tests/test_torch_port_tp.py`, `tests/test_torch_port_tp_tasks.py`).

`run(case, world, tmp, payload)` spawns `world` processes
(`torch.multiprocessing`, start method spawn), each of which joins a gloo
process group through a `FileStore` under `tmp` (no TCP), runs
`CASES[case](payload)` and pickles what it returns to `tmp/rank{r}.pkl`; a
rank that fails writes its traceback to `tmp/rank{r}.err`, and `run`
raises with it.  The case functions also run in the test's own process
with no process group, as the world-1 reference; `many` runs several cases
in one world, one after the other.  A sharded model's gradients and state
come back gathered in the whole layout (`parallel.tensor`).  This module imports
torch and the port only, so that the ranks start without JAX.

Run as a script under torchrun it is the CLI's entry point with the toy
segmentation recipe of `tests/test_torch_port_cli.py` registered:

    python -m torch.distributed.run --standalone --nproc_per_node=2 \\
        tests/torch_ddp_workers.py train <cli.train arguments>
"""

from __future__ import annotations

import os
import pickle
import sys
import time
import traceback
from contextlib import ExitStack
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

TOY = "toy-rvsa-upernet-64"


def run(case: str, world: int, tmp, payload: dict, timeout: float = 240.0) -> list:
    """Each rank's result of `case` in a gloo world of `world` processes."""
    tmp = str(tmp)
    with open(os.path.join(tmp, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(case, r, world, tmp), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errors = []
    for r, p in enumerate(procs):
        if p.exitcode != 0:
            err = os.path.join(tmp, f"rank{r}.err")
            errors.append(f"rank {r} exit {p.exitcode}:\n"
                          + (open(err).read() if os.path.exists(err) else "(no traceback)"))
    if errors:
        raise AssertionError("\n".join(errors))
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _entry(case: str, rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    try:
        with open(os.path.join(tmp, "payload.pkl"), "rb") as f:
            payload = pickle.load(f)
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                                rank=rank, world_size=world)
        try:
            out = CASES[case](payload)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def tensors(batch):
    """A (nested) dict of numpy arrays as tensors."""
    if isinstance(batch, dict):
        return {k: tensors(v) for k, v in batch.items()}
    return torch.from_numpy(np.ascontiguousarray(batch))


# the deterministic sampler rule of tests/test_torch_port_detection.py (its
# torch half): positives in index order up to the cap, then negatives
def torch_rule(assign, generator, num, frac):
    from mtp_tpu_torch.ops import assign as passign
    gt_inds = assign.gt_inds
    pos, neg = gt_inds > 0, gt_inds == 0
    pos_sel = pos & (pos.long().cumsum(-1) <= int(num * frac))
    neg_sel = neg & (neg.long().cumsum(-1) <= num - pos_sel.sum(-1, keepdims=True))
    A = gt_inds.shape[-1]
    key = (2 * pos_sel + neg_sel) * A + (A - 1 - torch.arange(A, device=gt_inds.device))
    inds = torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :num]
    take = lambda t: t.gather(-1, inds)
    return passign.SampleResult(inds, take(pos_sel), take(pos_sel | neg_sel),
                                (take(gt_inds) - 1).clamp(min=0), take(assign.labels))


# ------------------------------------------------------------------ tasks --

def _load(state, payload):
    """The payload's whole state dict, if any, into the (maybe sharded)
    model."""
    from mtp_tpu_torch.parallel.tensor import load_full_state_dict

    if payload.get("state_dict") is not None:
        load_full_state_dict(state.model, payload["state_dict"])
    return state


def seg_task(payload):
    """(task, state) of the toy segmentor in `payload`: cfg, channels, crop,
    state_dict (None: init_state's weights from seed 0)."""
    from mtp_tpu_torch.models.segmentor import Segmentor
    from mtp_tpu_torch.tasks.segmentation import SegmentationTask

    cfg, crop = payload["cfg"], payload["crop"]
    task = SegmentationTask(cfg, model=Segmentor(cfg.backbone, cfg.num_classes,
                                                 channels=payload["channels"],
                                                 input_hw=(crop, crop)), device="cpu")
    return task, _load(task.init_state(torch.Generator().manual_seed(0)), payload)


def det_task(payload):
    """(task, state) of the toy detector in `payload`: cfg, det_overrides,
    state_dict."""
    from mtp_tpu_torch.tasks.detection_task import DetectionTask

    task = DetectionTask(payload["cfg"], det_overrides=payload["det_overrides"], device="cpu")
    return task, _load(task.init_state(torch.Generator().manual_seed(0)), payload)


def cls_task(payload):
    """(task, state) of the toy classifier in `payload`: cfg, model_cfg (a
    BackboneConfig or an InternImageConfig), state_dict."""
    from mtp_tpu_torch.models.classifier import ImageClassifier
    from mtp_tpu_torch.tasks.classification import ClassificationTask

    cfg = payload["cfg"]
    task = ClassificationTask(cfg, model=ImageClassifier(payload["model_cfg"], cfg.num_classes),
                              device="cpu")
    return task, _load(task.init_state(torch.Generator().manual_seed(0)), payload)


def train_steps(task, state, payload) -> dict:
    """The task's train steps on the rank's rows of each global batch in
    payload["batches"] (`deterministic` as payload's): each step's metrics,
    the gradients the first step applied and the state dict after each,
    whole (gathered over the model group when the model is sharded)."""
    from mtp_tpu_torch.parallel.mesh import shard_batch
    from mtp_tpu_torch.parallel.tensor import full_state_dict, gather_state_dict

    step = task.train_step_fn(deterministic=payload["deterministic"])
    out = {"metrics": [], "grads": None, "state": []}
    for batch in payload["batches"]:
        state, m = step(state, shard_batch(task.mesh, tensors(batch)))
        out["metrics"].append({k: float(v.detach()) for k, v in m.items()})
        if out["grads"] is None:
            out["grads"] = gather_state_dict(task.mesh, {
                n: p.grad.detach().clone() for n, p in state.model.named_parameters()})
        out["state"].append({k: v.detach().clone()
                             for k, v in full_state_dict(state.model).items()})
    return out


def _seg_step(payload):
    return train_steps(*seg_task(payload), payload)


def _cls_step(payload):
    return train_steps(*cls_task(payload), payload)


def _det_step(payload):
    """Detection steps; with payload["rule"] under the deterministic sampler.
    Also each R-CNN head loss's local positive and valid counts."""
    from mtp_tpu_torch.tasks import detection as pdet

    counts = []
    head_loss = pdet.bbox_head_loss

    def counting(cls_logits, reg_pred, sample, *a, **kw):
        counts.append((int(sample.is_pos.sum()), int(sample.valid.sum())))
        return head_loss(cls_logits, reg_pred, sample, *a, **kw)

    with ExitStack() as stack:
        stack.enter_context(mock.patch.object(pdet, "bbox_head_loss", counting))
        if payload.get("rule"):
            stack.enter_context(mock.patch.object(pdet, "random_sample", torch_rule))
        out = train_steps(*det_task(payload), payload)
    out["counts"] = counts
    return out


def _batchnorm(payload):
    """The port's BatchNorm in train mode on the rank's rows of payload's x
    (B, C, H, W): the output, the gradients of sum(out · cot) and the
    running statistics after."""
    from mtp_tpu_torch.heads.upernet import BatchNorm
    from mtp_tpu_torch.parallel.mesh import make_mesh, process_batch_rows

    x, cot = payload["x"], payload["cot"]
    bn = BatchNorm(x.shape[1], eps=1e-5)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in payload["state"].items()})
    rows = process_batch_rows(make_mesh(), x.shape[0])
    xr = torch.from_numpy(x[rows]).requires_grad_()
    y = bn(xr, train=True)
    (y * torch.from_numpy(cot[rows])).sum().backward()
    return {"y": y.detach().numpy(), "dx": xr.grad.numpy(), "dw": bn.weight.grad.numpy(),
            "db": bn.bias.grad.numpy(), "mean": bn.running_mean.numpy(),
            "var": bn.running_var.numpy()}


def _seg_eval(payload):
    task, state = seg_task(payload)
    return task.evaluate(state, iter(payload["data"]))


def _det_eval(payload):
    task, state = det_task(payload)
    return task.evaluate(state, iter(payload["data"]), **payload.get("eval_kw", {}))


def _tp_eval(payload):
    """Segmentation's `evaluate` of payload["seg"] with the confusion counts
    it summed and each batch's slide logits, and detection's of
    payload["det"] with the number of image records it scored and each
    batch's detections (tests/test_torch_port_tp_tasks.py)."""
    from mtp_tpu_torch.eval import metrics
    from mtp_tpu_torch.tasks import detection_task as pdt

    seg, det = payload["seg"], payload["det"]
    task, state = seg_task(seg)
    counts, records = [], []
    reduce, score = metrics.SegAccumulator.all_reduce, pdt.eval_map

    def all_reduce(acc):
        out = reduce(acc)
        counts.append(np.stack([acc.i, acc.u, acc.p, acc.l]))
        return out

    def eval_map(per_image, *a, **kw):
        records.append(len(per_image))
        return score(per_image, *a, **kw)

    with mock.patch.object(metrics.SegAccumulator, "all_reduce", all_reduce):
        out = {"seg": task.evaluate(state, iter(seg["data"]))}
    out["counts"] = counts
    out["logits"] = [task.slide_logits(torch.as_tensor(b["image"])) for b in seg["data"]]
    task, state = det_task(det)
    with mock.patch.object(pdt, "eval_map", eval_map):
        out["det"] = task.evaluate(state, iter(det["data"]))
    out["records"] = records
    predict = task.predict_fn()
    out["dets"] = [pdt.host_detections(predict(torch.as_tensor(b["image"])), b)
                   for b in det["data"]]
    return out


def _ckpt(payload):
    """The toy segmentor's state at payload's mesh, whole: with
    payload["save"], after one step, saved to payload["dir"] (every rank
    calls the save); else restored from payload["dir"].  Returns the model's
    state dict, the Adam moments, the update count and the generator's
    state."""
    from mtp_tpu_torch.ckpt.store import CheckpointStore
    from mtp_tpu_torch.parallel.tensor import full_state_dict, gather_moments

    task, state = seg_task(payload)
    store = CheckpointStore(payload["dir"])
    if payload["save"]:
        train_steps(task, state, payload)
        store.save(state.step, state, wait=True)
    else:
        store.restore(state)
    store.close()
    return {"model": full_state_dict(state.model),
            "moments": gather_moments(task.mesh, state.optimizer.moments()),
            "count": state.optimizer.count, "generator": state.generator.get_state()}


def _multitask_step(payload):
    """The toy 9-way step of tests/test_torch_port_ddp_det.py: the
    deterministic sampler, the given Dropout2d masks (this rank's rows of
    each dataset's) and the given proposals (this rank's images', in call
    order), as tests/test_torch_port_multitask.py gives them."""
    from mtp_tpu_torch.models import multitask as pmt
    from mtp_tpu_torch.models.multitask import MultiTaskPretrainModel
    from mtp_tpu_torch.parallel.mesh import make_mesh, process_batch_rows
    from mtp_tpu_torch.tasks import detection as pdet
    from mtp_tpu_torch.tasks.multitask import MultiTaskPretrainTask

    mesh = make_mesh(payload["cfg"].train.mesh)
    rows = lambda n: process_batch_rows(mesh, n)
    masks = [m[rows(m.shape[0])] for m in payload["masks"]]
    # this rank's images, in the order the branches make their proposals
    images = [(d, int(i)) for d, b in enumerate(payload["batches"][0].values())
              for i in rows(b["image"].shape[0])]
    props, taken = payload["props"], [0, 0]

    def drop(x, rate, deterministic, generator, _it=iter(masks)):
        return torch.where(torch.from_numpy(next(_it)), x / payload["keep"], 0.0)

    def proposals(rpn_out, anchors, hw, nms_pre, max_props, iou, rotated, **kw):
        B, t = rpn_out.cls_scores.shape[0], int(rotated)
        take = [images[(taken[t] + j) % len(images)] for j in range(B)]
        taken[t] += B
        return tuple(torch.stack([torch.as_tensor(np.array(props[d][t][k][i])) for d, i in take])
                     for k in (0, 1))

    model = MultiTaskPretrainModel(payload["backbone"], payload["classes"],
                                   payload["overrides"], det_multi=payload["det_multi"])
    task = MultiTaskPretrainTask(payload["cfg"], payload["classes"], payload["overrides"],
                                 model=model, device="cpu")
    state = _load(task.init_state(torch.Generator().manual_seed(0)), payload)
    with mock.patch.object(pmt, "dropout2d", drop), \
            mock.patch.object(pdet, "random_sample", torch_rule), \
            mock.patch.object(pdet, "gen_proposals", proposals):
        return train_steps(task, state, payload)


def _many(payload):
    """Each (case, payload) of payload["cases"] in turn, in this world."""
    return [CASES[case](p) for case, p in payload["cases"]]


CASES = {"seg_step": _seg_step, "det_step": _det_step, "batchnorm": _batchnorm,
         "seg_eval": _seg_eval, "det_eval": _det_eval, "multitask_step": _multitask_step,
         "cls_step": _cls_step, "tp_eval": _tp_eval, "ckpt": _ckpt, "many": _many}


# -------------------------------------------------------- the CLI entry --

def toy_task(C):
    """The toy recipe of tests/test_torch_port_cli.py from a config module."""
    bb = C.BackboneConfig(img_size=64, embed_dim=32, depth=2, num_heads=2, interval=2,
                          out_indices=(0, 1, 1, 1), drop_path_rate=0.0, dtype="float32")
    return C.TaskConfig(
        task="segmentation", num_classes=2, backbone=bb,
        train=C.TrainConfig(batch_size=2, optimizer=C.OptimizerConfig(
            lr=1e-3, layer_decay=0.9, clip_norm=0.0),
            schedule=C.ScheduleConfig(kind="cosine", total_steps=3, warmup_steps=1)),
        slide=C.SlideConfig(crop=64, stride=32))


def cli_main(argv) -> int:
    """`cli.train` / `cli.test` (argv[0]) with TOY registered.  A leading
    `--rendezvous-timeout S` gives the process group's start S seconds
    instead of torch's default."""
    from mtp_tpu_torch import config as pc
    from mtp_tpu_torch import configs as pconfigs
    from mtp_tpu_torch.parallel import mesh

    if argv[0] == "--rendezvous-timeout":
        init, seconds = mesh.init_distributed, float(argv[1])
        mesh.init_distributed = lambda device="cuda", timeout=seconds: init(device, timeout)
        argv = argv[2:]

    pconfigs._REGISTRY[TOY] = lambda: pconfigs.Recipe(TOY, toy_task(pc), dataset="spacenetv1",
                                                      init="mae-mtp")
    torch.set_num_threads(1)
    if argv[0] == "train":
        from mtp_tpu_torch.cli.train import main
    else:
        from mtp_tpu_torch.cli.test import main
    return main(argv[1:])


if __name__ == "__main__":
    sys.exit(cli_main(sys.argv[1:]))
