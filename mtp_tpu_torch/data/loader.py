"""Host data pipeline: fixed-shape collation + background prefetch (the
port's copy of `mtp_tpu/data/loader.py`).

Replaces the reference's DataLoader + in-loop `parse_datainfos`/`data_augs`
(a known CPU bottleneck — annotation parsing ran in the training process,
SURVEY.md §3.5): here samples are transformed in worker threads and collated
into the fixed-shape padded batches the train step consumes, with a
double-buffered prefetch so host work overlaps device steps.

The fork workers run numpy and PIL only: the process that forks them may
have initialised CUDA, which a forked child must not touch, so nothing here
reaches torch (the mask crops come from `eval/host_masks.py`, numpy).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from mtp_tpu_torch.data.transforms import Sample


def pad_instances(boxes: np.ndarray, labels: np.ndarray, max_n: int,
                  dim: int) -> Dict[str, np.ndarray]:
    """Zero-pad instance arrays to max_n with a validity mask."""
    n = min(len(boxes), max_n)
    out_b = np.zeros((max_n, dim), np.float32)
    out_l = np.zeros((max_n,), np.int32)
    out_v = np.zeros((max_n,), bool)
    if n:
        out_b[:n] = boxes[:n]
        out_l[:n] = labels[:n]
        out_v[:n] = True
    return {"boxes": out_b, "labels": out_l, "valid": out_v}


def collate_detection(samples: Sequence[Sample], max_gts: int,
                      rotated: bool = False, with_masks: bool = False,
                      mask_mode: str = "crop", mask_stride: int = 4,
                      mask_crop_size: int = 56) -> Dict[str, np.ndarray]:
    """Stack samples into the fixed-shape batch dict of tasks/detection.py.

    mask_mode='crop' (default) stores per-gt BOX-ALIGNED full-resolution
    crops ('gt_mask_crops', (B, G, C, C)) — full fidelity at any object
    size and ~4× less memory than a stride-4 map; 'stride' keeps the legacy
    decimated full map ('gt_masks', (B, G, H/s, W/s))."""
    images = np.stack([s["image"] for s in samples]).astype(np.float32)
    B, H, W, _ = images.shape
    key = "rboxes" if rotated else "hboxes"
    lkey = "rlabels" if rotated else "labels"
    dim = 5 if rotated else 4
    packed = [pad_instances(s.get(key, np.zeros((0, dim))),
                            s.get(lkey, np.zeros((0,), np.int32)),
                            max_gts, dim) for s in samples]
    batch = {
        "image": images,
        "gt_boxes": np.stack([p["boxes"] for p in packed]),
        "gt_labels": np.stack([p["labels"] for p in packed]),
        "gt_valid": np.stack([p["valid"] for p in packed]),
    }
    if with_masks and mask_mode == "crop" and not rotated:
        from mtp_tpu_torch.eval.host_masks import crop_masks_to_boxes
        C = mask_crop_size
        gm = np.zeros((B, max_gts, C, C), np.float32)
        for b, s in enumerate(samples):
            masks = s.get("masks")
            if masks is None or len(masks) == 0:
                continue
            n = min(len(masks), max_gts)
            gm[b, :n] = crop_masks_to_boxes(masks[:n],
                                            batch["gt_boxes"][b, :n], C)
        batch["gt_mask_crops"] = gm
    elif with_masks:
        hs, ws = H // mask_stride, W // mask_stride
        gm = np.zeros((B, max_gts, hs, ws), np.float32)
        for b, s in enumerate(samples):
            masks = s.get("masks")
            if masks is None:
                continue
            n = min(len(masks), max_gts)
            if n:
                gm[b, :n] = masks[:n, ::mask_stride, ::mask_stride]
        batch["gt_masks"] = gm
    return batch


def collate_segmentation(samples: Sequence[Sample]) -> Dict[str, np.ndarray]:
    return {
        "image": np.stack([s["image"] for s in samples]).astype(np.float32),
        "label": np.stack([s["sem_seg"] for s in samples]).astype(np.int32),
    }


def collate_multitask(samples: Sequence[Sample], max_gts: int,
                      mask_mode: str = "crop",
                      mask_stride: int = 4) -> Dict[str, np.ndarray]:
    """One dataset's joint batch for the multi-task pretrainer."""
    det_h = collate_detection(samples, max_gts, rotated=False,
                              with_masks=True, mask_mode=mask_mode,
                              mask_stride=mask_stride)
    det_r = collate_detection(samples, max_gts, rotated=True)
    mask_key = "gt_mask_crops" if "gt_mask_crops" in det_h else "gt_masks"
    return {
        "image": det_h["image"],
        "ss_label": np.stack([s["sem_seg"] for s in samples]).astype(np.int32),
        "gt_boxes": det_h["gt_boxes"], "gt_labels": det_h["gt_labels"],
        "gt_valid": det_h["gt_valid"], mask_key: det_h[mask_key],
        "r_gt_boxes": det_r["gt_boxes"], "r_gt_labels": det_r["gt_labels"],
        "r_gt_valid": det_r["gt_valid"],
    }


def _mp_worker(dataset, collate, order, batch_size, nb, wid, nw, q,
               batch_rows=None):
    """One fork worker: builds every nw-th batch and ships it pickled.
    A trailing None marks end-of-stream; errors ship as a tagged tuple."""
    try:
        for b in range(wid, nb, nw):
            idxs = order[b * batch_size:(b + 1) * batch_size]
            if batch_rows is not None:
                idxs = idxs[batch_rows]
            q.put(collate([dataset[int(i)] for i in idxs]))
        q.put(None)
    except Exception as e:  # surface worker crashes to the consumer
        q.put(("__loader_error__", repr(e)))


class Loader:
    """Epoch loader: dataset with __len__/__getitem__ returning a Sample
    (already transformed), collated to fixed shapes.

    num_workers=0 (default): one background prefetch thread — enough for
    bench/tests.  num_workers>0: fork-based worker PROCESSES, each decoding
    + augmenting + collating every num_workers-th batch, consumed
    round-robin so batch order stays deterministic — the multi-process
    decode-ahead path for real multi-dataset pretraining (the reference ran
    parsing/augmentation in the training process, its known CPU bottleneck,
    SURVEY §3.5)."""

    def __init__(self, dataset, batch_size: int, collate: Callable,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 2, num_workers: int = 0,
                 batch_rows: Optional[Sequence[int]] = None):
        """batch_rows: multi-process feeding (reference DistributedSampler
        over SLURM ranks, main_pretrain.py:236-251) — `batch_size` is the
        GLOBAL batch; this process materializes only these row offsets of
        each batch (one rank's rows, `parallel.mesh.process_batch_rows`).
        Every process must use the same seed so the epoch permutation
        agrees; coverage across processes is disjoint and complete by
        construction."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.batch_rows = (None if batch_rows is None
                           else np.asarray(batch_rows, np.int64))
        if self.batch_rows is not None and len(self.batch_rows) and \
                (self.batch_rows.min() < 0
                 or self.batch_rows.max() >= batch_size):
            raise ValueError(f"batch_rows out of range for batch "
                             f"{batch_size}: {batch_rows}")

    def _batch_idxs(self, order: np.ndarray, b: int) -> np.ndarray:
        idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
        if self.batch_rows is not None:
            idxs = idxs[self.batch_rows]
        return idxs

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def _order(self, epoch_idx: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + epoch_idx)
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng.shuffle(order)
        return order

    def epoch(self, epoch_idx: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        if self.num_workers > 0:
            yield from self._epoch_mp(epoch_idx)
            return
        order = self._order(epoch_idx)
        nb = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            try:
                for b in range(nb):
                    if stop.is_set():
                        return
                    idxs = self._batch_idxs(order, b)
                    samples = [self.dataset[int(i)] for i in idxs]
                    q.put(self.collate(samples))
            finally:
                q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()

    def _epoch_mp(self, epoch_idx: int) -> Iterator[Dict[str, np.ndarray]]:
        import multiprocessing as mp

        ctx = mp.get_context("fork")
        order = self._order(epoch_idx)
        nb = len(self)
        nw = min(self.num_workers, max(nb, 1))
        queues = [ctx.Queue(maxsize=max(self.prefetch, 1)) for _ in range(nw)]
        procs = [
            ctx.Process(target=_mp_worker,
                        args=(self.dataset, self.collate, order,
                              self.batch_size, nb, w, nw, queues[w],
                              self.batch_rows),
                        daemon=True)
            for w in range(nw)]
        for p in procs:
            p.start()
        try:
            for b in range(nb):
                item = queues[b % nw].get()
                if isinstance(item, tuple) and len(item) == 2 \
                        and item[0] == "__loader_error__":
                    raise RuntimeError(f"loader worker failed: {item[1]}")
                yield item
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=5)

    def forever(self) -> Iterator[Dict[str, np.ndarray]]:
        e = 0
        while True:
            yield from self.epoch(e)
            e += 1
