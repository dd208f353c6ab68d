"""The port's CLI under data parallel (`mtp_tpu_torch.cli.train`,
`cli.test`) on the CPU: `torch.distributed.run --standalone
--nproc_per_node=2` over gloo, with the toy segmentation recipe of
`test_torch_port_cli.py` registered by `tests/torch_ddp_workers.py`:
2 steps on synthetic batches with a checkpoint each step, written by rank 0
alone, a resume, `cli.test` at world 2 against one process, the mesh flags
whose data × model is not the world, and a rendezvous that cannot happen."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mtp_tpu_torch import config as pc
from mtp_tpu_torch import configs as pconfigs
from torch_ddp_workers import TOY, toy_task

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun(args, nproc=2, timeout=240, env=None):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", str(ROOT / "tests" / "torch_ddp_workers.py")] + args
    return subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout,
                          env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
                               **(env or {})})


def test_cli_under_torchrun(tmp_path, monkeypatch):
    """`cli.train` on 2 gloo ranks, synthetic batches of 2 (one row a
    rank): 2 steps with a checkpoint each step, written by rank 0 alone (one
    JSONL log, one result line), then `--resume` to 3, then `cli.test` on
    the checkpoint, 2 ranks against 1 process: the same metrics."""
    from mtp_tpu_torch.ckpt.store import CheckpointStore

    wd, ck = tmp_path / "wd", tmp_path / "ckpt"
    common = ["train", TOY, "--synthetic", "--batch-size", "2", "--device", "cpu",
              "--ckpt-dir", str(ck), "--ckpt-every", "1", "--work-dir", str(wd),
              "--log-every", "1"]
    res = _torchrun(common + ["--steps", "2"])
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(x) for x in res.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 1 and np.isfinite(lines[0]["final"]["loss"])
    recs = [json.loads(x) for x in open(wd / f"{TOY}.jsonl")]
    assert [r["iter"] for r in recs] == [0, 1]
    assert CheckpointStore(str(ck)).steps() == [1, 2]
    assert not [f for f in os.listdir(ck) if f.endswith(".tmp")]

    res = _torchrun(common + ["--steps", "3", "--resume"])
    assert res.returncode == 0, res.stderr[-3000:]
    assert "resumed from step 2" in res.stderr
    assert len(open(wd / f"{TOY}.jsonl").readlines()) == 3   # one step more
    assert CheckpointStore(str(ck)).latest_step() == 3

    test = ["test", TOY, "--ckpt", str(ck), "--synthetic", "--batches", "3",
            "--batch-size", "1", "--device", "cpu"]
    res = _torchrun(test)
    assert res.returncode == 0, res.stderr[-3000:]
    two = [json.loads(x) for x in res.stdout.splitlines() if x.startswith("{")]
    monkeypatch.setitem(pconfigs._REGISTRY, TOY, lambda: pconfigs.Recipe(
        TOY, toy_task(pc), dataset="spacenetv1", init="mae-mtp"))
    from mtp_tpu_torch.cli.test import main as port_test
    one = port_test(test[1:], return_metrics=True)
    assert len(two) == 1 and two[0]["results"] == {k: round(v, 4) for k, v in one.items()}


@pytest.mark.parametrize("flags,error", [
    (["--mesh-model", "2", "--mesh-data", "2"], "ValueError: mesh data=2 × model=2"),
    (["--mesh-data", "3"], "ValueError: mesh data=3"),
])
def test_cli_refuses_a_mesh_that_does_not_fit_the_world(flags, error, tmp_path):
    res = _torchrun(["train", TOY, "--synthetic", "--steps", "1", "--batch-size", "2",
                     "--device", "cpu", "--work-dir", str(tmp_path)] + flags)
    assert res.returncode != 0
    assert error in res.stderr, res.stderr[-3000:]


def test_a_failed_rendezvous_raises(tmp_path):
    """torchrun's variables, and no rank 0 at the address: the rank raises
    once the timeout passes, and does not train alone."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "RANK": "1", "LOCAL_RANK": "1",
           "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    res = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_ddp_workers.py"),
                          "--rendezvous-timeout", "3",
                          "train", TOY, "--synthetic", "--steps", "1", "--batch-size", "2",
                          "--device", "cpu", "--work-dir", str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode != 0
    assert "Traceback" in res.stderr and '"final"' not in res.stdout
    assert not (tmp_path / f"{TOY}.jsonl").exists()
