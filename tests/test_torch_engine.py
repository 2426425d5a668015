"""The PyTorch port's engine, strategy and CLI vs the JAX reference (exact).

* ``DeviceOverlapEngine.count_batch`` counts, ``had_mapping`` and
  ``fallback_triggers`` equal those of ``lrge_tpu``'s device engine and
  of the exact host engine (same length buckets on both).
* ``python -m lrge_tpu_torch`` on the device engine (here on the CPU)
  prints what ``python -m lrge_tpu --engine host`` prints, byte for
  byte, and never loads JAX.
* Modes outside the slice raise; nothing falls back to another engine.
"""

import gzip
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny per-op work: intra-op threads only contend with the other workers
torch.set_num_threads(1)
from test_device_engine import make_reads

from lrge_tpu import cli as ref_cli
from lrge_tpu.device_engine import DeviceOverlapEngine as RefEngine
from lrge_tpu.engine import OverlapEngine
from lrge_tpu.ops.index import build_index
from lrge_tpu.platform import Platform, preset_for
from lrge_tpu_torch import cli
from lrge_tpu_torch.device_engine import DeviceOverlapEngine, resolve_engine

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(31337)
    genome = bytearray(rng.choice(list(b"ACGT"), size=150_000).tolist())
    unit = bytes(rng.choice(list(b"ACGT"), size=400).tolist())
    genome[60_000 : 60_000 + 5 * 400] = unit * 5
    genome = bytes(genome)
    targets = make_reads(rng, genome, 120, 2000, err=0.08)
    tnames = [f"t{i}".encode() for i in range(len(targets))]
    queries = make_reads(rng, genome, 40, 2500, err=0.08)
    queries[3] = queries[3][:900] + b"N" + queries[3][901:]  # sketch-quirk row
    qnames = [f"q{i}".encode() for i in range(len(queries))]
    return targets, tnames, queries, qnames


@pytest.fixture(scope="module")
def index(corpus):
    targets, tnames, _, _ = corpus
    return build_index(targets, tnames, preset_for(Platform.NANOPORE, dual=True))


@pytest.fixture(scope="module")
def verify_reads(tmp_path_factory):
    """The verify-skill corpus: 500 reads of a 120 kb genome, 6% errors."""
    rng = np.random.default_rng(99)
    G = 120_000
    genome = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=G, dtype=np.uint8)].tobytes()
    g = np.frombuffer(genome, np.uint8)
    bases = np.frombuffer(b"ACGT", np.uint8)
    rc = bytes.maketrans(b"ACGT", b"TGCA")
    out = []
    for i in range(500):
        L = int(np.clip(rng.gamma(3, 600), 300, 5000))
        pos = int(rng.integers(0, G - L))
        arr = g[pos : pos + L].copy()
        ne = rng.binomial(L, 0.06)
        arr[rng.integers(0, L, size=ne)] = bases[rng.integers(0, 4, size=ne)]
        s = arr.tobytes()
        s = s.translate(rc)[::-1] if rng.integers(0, 2) else s
        out.append(b"@read%d ch=1\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))
    path = tmp_path_factory.mktemp("verify") / "reads.fq.gz"
    with gzip.open(path, "wb") as fh:
        fh.write(b"".join(out))
    return path


@pytest.mark.parametrize(
    "window,num_anchors,buckets", [(32, 1024, (1024, 4096)), (128, 4096, (4096,))]
)
def test_count_batch_matches_reference_and_host(corpus, index, monkeypatch, window, num_anchors, buckets):
    _, _, queries, qnames = corpus
    monkeypatch.setenv("LRGE_SHARDS", "1")  # the reference's single-device path
    # the reference's CPU backend keeps one bucket unless told otherwise
    monkeypatch.setenv("LRGE_DEVICE_BUCKET", ",".join(map(str, buckets)))
    kw = dict(batch_size=16, num_anchors=num_anchors, window=window, length_buckets=buckets)
    ref = RefEngine(index, **kw)
    assert ref.sharded is None and ref.gdev.n_sub == 1
    want = ref.count_batch(qnames, queries)
    dev = DeviceOverlapEngine(index, device=CPU, **kw)
    got = dev.count_batch(qnames, queries)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.had_mapping, want.had_mapping)
    assert got.fallback_rows == want.fallback_rows
    assert dev.fallback_triggers == ref.fallback_triggers
    assert dev.fallback_triggers["sketch_quirk"] == 1
    if num_anchors == 1024:
        assert dev.fallback_triggers["anchor_overflow"] > 0, dev.fallback_triggers
    host = OverlapEngine(index).count_overlaps_many(list(zip(qnames, queries)))
    np.testing.assert_array_equal(got.counts, [c for c, _ in host])
    np.testing.assert_array_equal(got.had_mapping, [bool(h) for _, h in host])


def test_host_share_split_matches_host(corpus, index, monkeypatch):
    # the host share is scheduling: counts stay exact and the share rows
    # are tallied under their own trigger, not as fallbacks
    _, _, queries, qnames = corpus
    monkeypatch.setenv("LRGE_HOST_SHARE", "0.5")
    dev = DeviceOverlapEngine(index, device=CPU, batch_size=8, length_buckets=(4096,))
    res = dev.count_batch(qnames, queries)
    assert dev.fallback_triggers["host_share"] == len(queries) // 2
    assert res.fallback_rows == dev.fallback_triggers.total() - len(queries) // 2
    host = OverlapEngine(index).count_overlaps_many(list(zip(qnames, queries)))
    np.testing.assert_array_equal(res.counts, [c for c, _ in host])
    np.testing.assert_array_equal(res.had_mapping, [bool(h) for _, h in host])


_PORT_RUN = """
import sys, torch
from lrge_tpu_torch.cli import main
torch.set_num_threads(1)
rc = main(sys.argv[1:], device=torch.device("cpu"))
print("JAX_MODULES=" + ",".join(m for m in sys.modules if m == "jax" or m.startswith("jax.")))
sys.exit(rc)
"""

ARGS = ["-T", "300", "-Q", "80", "-s", "42"]


@pytest.fixture(scope="module")
def port_cli_run(verify_reads):
    """One fresh interpreter runs the port's CLI on the device engine."""
    env = dict(os.environ, PYTHONPATH=str(REPO), LRGE_DEVICE_MIN_ROWS="0")
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run(
        [sys.executable, "-c", _PORT_RUN, str(verify_reads), *ARGS, "--engine", "device", "-qqq"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=600,
    )


def reference_stdout(args):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-m", "lrge_tpu", *args, "-qqq"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=600,
    )
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_cli_device_stdout_equals_reference_host(port_cli_run, verify_reads):
    assert port_cli_run.returncode == 0, port_cli_run.stderr
    want = reference_stdout([str(verify_reads), *ARGS, "--engine", "host"])
    assert port_cli_run.stdout.splitlines()[0] + "\n" == want


def test_port_never_loads_jax(port_cli_run):
    assert port_cli_run.returncode == 0, port_cli_run.stderr
    assert port_cli_run.stdout.splitlines()[-1] == "JAX_MODULES="


@pytest.mark.parametrize("extra", [["-F"], ["-P", "pb"], ["-t", "2"]])
def test_cli_host_engine_equals_reference(verify_reads, capsys, extra):
    # the host engine's branches (-F, PacBio) run the reference's exact path
    args = [str(verify_reads), *ARGS, "--engine", "host", *extra]
    want = reference_stdout(args)
    assert cli.main(args + ["-qqq"]) == 0
    assert capsys.readouterr().out == want


def test_cli_paf_side_output_matches_host(tmp_path, capsys):
    rng = np.random.default_rng(5150)
    genome = bytes(rng.choice(list(b"ACGT"), size=60_000).tolist())
    fq = tmp_path / "reads.fq"
    with open(fq, "wb") as fh:
        for i in range(120):
            pos = int(rng.integers(0, len(genome) - 1500))
            seq = genome[pos : pos + 1500]
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"I" * len(seq)))
    base = [str(fq), "-T", "60", "-Q", "30", "-s", "3", "-t", "2", "-C", "-qqq"]
    assert cli.main(base + ["-D", str(tmp_path / "dev"), "--engine", "device"], device=CPU) == 0
    assert ref_cli.main(base + ["-D", str(tmp_path / "host"), "--engine", "host"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1]
    (dev_paf,) = (tmp_path / "dev").glob("lrge-*/overlaps.paf")
    (host_paf,) = (tmp_path / "host").glob("lrge-*/overlaps.paf")
    assert dev_paf.read_text() == host_paf.read_text() != ""


def test_device_engine_without_cuda_raises(verify_reads):
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only machine")
    assert resolve_engine("auto", 10**6) == "host"
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([str(verify_reads), *ARGS, "--engine", "device", "-qqq"])


@pytest.mark.parametrize(
    "extra,env,item",
    [
        (["-n", "100"], {}, "item 9"),
        (["--use-min-ref"], {}, "item 9"),
        (["-F", "--engine", "device"], {}, "item 10"),
        (["-P", "pb", "--engine", "device"], {}, "item 11"),
        ([], {"LRGE_COORDINATOR": "localhost:1234"}, "item 13"),
    ],
)
def test_modes_outside_the_slice_raise(verify_reads, monkeypatch, extra, env, item):
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    sizes = [] if extra[:1] == ["-n"] else ["-T", "300", "-Q", "80"]
    args = [str(verify_reads), *sizes, *extra, "-qqq"]
    with pytest.raises(NotImplementedError, match=item):
        cli.main(args, device=CPU)
