"""Two real processes of the PyTorch port, joined over gloo on the CPU.

Each process runs the port's CLI with four CPU devices, joined by
``torch.distributed`` through the reference's env contract
(``LRGE_COORDINATOR``, ``LRGE_NUM_PROCESSES``, ``LRGE_PROCESS_ID``):

* the forward two-set path shards the index over both processes' eight
  devices (data = 2 processes, index = 4 devices each) and counts in
  lockstep, the query blocks riding a ring over the processes through
  each process's shard programs, every block triaged after the last
  dispatch;
* the all-vs-all path runs replicated, each process sharding over its
  own four devices.

Rank 0's ``-o`` file must equal what ``python -m lrge_tpu --engine
host`` prints, byte for byte, and rank 1 writes nothing.  The corpus and
shape knobs are the reference's ``tests/test_distributed.py``.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from test_distributed import _write_corpus
from test_torch_engine import reference_stdout

REPO = Path(__file__).resolve().parent.parent
# each rank: join the group (gloo on a CPU-only machine), then the CLI on
# four CPU devices
_RANK = """
import sys, torch
from lrge_tpu_torch.cli import main
sys.exit(main(sys.argv[1:], device=[torch.device("cpu")] * 4))
"""
TIMEOUT = 240  # seconds a process may take


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("LRGE_")}
    env.update(
        PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", LRGE_DEVICE_BATCH="16", LRGE_DEVICE_ANCHORS="1024",
        LRGE_DEVICE_WINDOW="64", LRGE_DEVICE_BUCKET="1024", LRGE_DEVICE_MIN_ROWS="0", **extra,
    )
    return env


def _two_ranks(tmp_path, args):
    """Run the port's CLI in two processes; returns each rank's ``-o`` path."""
    port = _free_port()
    procs, outs = [], []
    for pid in range(2):
        out = tmp_path / f"out{pid}.txt"
        outs.append(out)
        env = _env({"LRGE_COORDINATOR": f"localhost:{port}", "LRGE_NUM_PROCESSES": "2",
                    "LRGE_PROCESS_ID": str(pid)})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK, *args, "--engine", "device", "-D", str(tmp_path / f"d{pid}"),
             "-o", str(out), "-v"],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    logs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err[-3000:]
            logs.append(err)
    finally:
        for p in procs:
            p.kill()
    return outs, logs


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    fq = tmp_path_factory.mktemp("dist") / "reads.fq"
    _write_corpus(fq)
    return fq


def test_two_process_cli_equals_host(reads, tmp_path):
    args = [str(reads), "-T", "48", "-Q", "16", "-s", "5"]
    (out0, out1), logs = _two_ranks(tmp_path, args)
    want = reference_stdout([*args, "--engine", "host"])
    assert want.strip() and out0.read_text() == want
    assert not out1.exists()
    for log in logs:
        assert "sharded over 8 devices (2x4)" in log and "lockstep count: process" in log
        # every block stays in flight until the last dispatch, then is triaged
        assert "blocks in flight, triaged after the last dispatch" in log


def test_two_process_ava_replicated_equals_host(reads, tmp_path):
    args = [str(reads), "-n", "48", "-s", "5"]
    (out0, out1), logs = _two_ranks(tmp_path, args)
    want = reference_stdout([*args, "--engine", "host"])
    assert want.strip() and out0.read_text() == want
    assert not out1.exists()
    for log in logs:
        assert "sharded over 4 devices (1x4)" in log and "lockstep count" not in log
