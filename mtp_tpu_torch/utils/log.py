"""Training logger: stream + file + JSONL per-iteration records (the port's
copy of `mtp_tpu/utils/log.py`).

Capability parity with the reference observability (SURVEY.md §5): the bare
python logger of main_pretrain.py:91-102 and mmengine's LoggerHook JSONL
(time/data_time/memory per iteration, the source of all published timing
baselines), plus a trace capture on torch.profiler.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional


def make_logger(name: str = "mtp_tpu_torch", log_file: Optional[str] = None
                ) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if log_file:
            os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


class JsonlLogger:
    """Per-iteration JSONL records: {iter, time, data_time, memory?,
    **metrics}; `data_time` and `step_time` in the metrics (what
    `tasks._fit.fit_loop` passes) are written as they are."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.f = open(path, "a")
        self._last = time.perf_counter()
        self._data_time = 0.0

    def data_tick(self):
        """Call after fetching a batch (accumulates host data time)."""
        now = time.perf_counter()
        self._data_time = now - self._last

    @staticmethod
    def device_memory_mb():
        """Device bytes allocated on the current CUDA device, in MB (the
        reference logs 'memory' MB per iter); None without an initialised
        card (this never initialises one)."""
        import torch
        if not torch.cuda.is_initialized():
            return None
        return round(torch.cuda.memory_allocated() / 2**20)

    def log(self, step: int, metrics: Dict[str, float], **extra):
        now = time.perf_counter()
        rec = {"iter": step, "time": round(now - self._last, 4),
               "data_time": round(self._data_time, 4)}
        mem = self.device_memory_mb()
        if mem is not None:
            rec["memory"] = mem
        rec.update({k: (round(float(v), 6) if isinstance(v, (int, float)) else v)
                    for k, v in metrics.items()})
        rec.update(extra)
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()
        self._last = now

    def close(self):
        self.f.close()


class Profiler:
    """torch.profiler wrapper: capture a trace (CPU and, with a card, CUDA
    activity) between `start` and `stop` and write it to `logdir` as a
    Chrome trace (the reference has no profiler at all)."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.active = False
        self._prof = None

    def start(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self.active = True

    def stop(self):
        if self.active:
            self._prof.__exit__(None, None, None)
            os.makedirs(self.logdir, exist_ok=True)
            self._prof.export_chrome_trace(
                os.path.join(self.logdir, f"trace_{os.getpid()}.json"))
            self.active = False
