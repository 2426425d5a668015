"""The port's benchmark (``python -m lrge_tpu_torch.bench``) against ``bench.py``.

* Its genome and reads equal ``bench.py``'s byte for byte.
* ``main(["--device", "cpu"])`` prints one JSON line with every key of
  ``bench.py``'s (its fused/unfused A/B keys renamed programmed/eager;
  the real-read section's too, on a FASTQ standing in for its BAM)
  and the port's own; its counts equal the exact host engine's on
  every row and the JAX engine's, and its estimate equals the one of
  the JAX engine's counts.
* Without CUDA and without ``--device cpu`` it exits non-zero.
* The host share's default ratio and its overrides.
* On a card (``gpu``): programmed and eager counts are equal.

The CPU run is small (300 targets, 120 queries, a 150 kb genome, one
pass a measurement) and keeps one length bucket (``LRGE_DEVICE_BUCKET=
4096``, on both engines): on the CPU the chain DP is its plain version,
which steps every anchor slot of a super-batch, so each bucket costs
seconds.
"""

import ast
import contextlib
import io
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny per-op work: intra-op threads only contend with the other workers
torch.set_num_threads(1)
import bench as ref_bench

from lrge_tpu_torch import bench
from lrge_tpu_torch import device_engine as port_engine

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
SMALL = {"BENCH_TARGETS": "300", "BENCH_QUERIES": "120", "BENCH_GENOME": "150000", "BENCH_REPS": "1"}
BUCKET = {"LRGE_DEVICE_BUCKET": "4096", "LRGE_DEVICE_MIN_ROWS": "0"}
# the keys of bench.py's "extra" (bench.py:306-365, the real-read ones
# apart), and the two that the port renames
BENCH_PY_KEYS = [
    "estimate_bp", "estimate_err_pct", "index_build_s", "warmup_s", "total_wall_s", "map_s",
    "device_only_qps", "map_s_passes", "map_s_median", "device_only_passes", "device_only_qps_median",
    "ab_unfused_passes", "ab_unfused_qps", "anchors_per_s", "anchor_slot_occupancy", "hbm_gbps_est",
    "host_fallback_rows", "host_share_rows", "compile_cache",
]
RENAMED = {"ab_unfused_passes": "ab_eager_passes", "ab_unfused_qps": "ab_eager_qps"}
# and of its real-read section's
REALREAD_KEYS = [
    "realread_qps", "realread_queries", "realread_map_s", "realread_index_s", "realread_warmup_s",
    "realread_fallback_rows",
]
NEW_KEYS = [
    "planes_s", "host_share_ratio", "fallback_triggers", "last_phases", "chain_dp_launches", "device",
    "hbm_gbps_peak", "device_only_chain_dp_launches", "ab_eager_chain_dp_launches",
]


def _set_env(mp, env):
    for k in ("LRGE_HOST_SHARE", "LRGE_HOST_RATE_RATIO", "BENCH_AB", "BENCH_REALREAD", "BENCH_TOY_BAM"):
        mp.delenv(k, raising=False)
    for k, v in env.items():
        mp.setenv(k, v)


@pytest.fixture(scope="module")
def bench_run(tmp_path_factory):
    """``main(["--device", "cpu"])`` once, with 60 reads standing in for
    the real-read section's BAM (a FASTQ: the reader sniffs the format):
    its stdout and the run it printed."""
    rng = np.random.default_rng(5)
    genome = bytes(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=60_000)])
    reads = bench.make_reads(rng, genome, 60, 1500, 0.03)
    toy = tmp_path_factory.mktemp("realread") / "reads.fq"
    toy.write_bytes(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, r, b"I" * len(r)) for i, r in enumerate(reads)))
    runs = []
    real = bench.run

    def spy(device):
        runs.append(real(device))
        return runs[-1]

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        _set_env(mp, {**SMALL, **BUCKET, "BENCH_TOY_BAM": str(toy)})
        mp.setattr(bench, "run", spy)
        with contextlib.redirect_stdout(out):
            rc = bench.main(["--device", "cpu"])
    assert rc == 0 and len(runs) == 1
    return out.getvalue(), runs[0]


class _Stop(Exception):
    pass


def test_corpus_equals_bench_py(monkeypatch):
    # bench.py's genome and reads, taken from its own main as it draws
    # them (its make_reads calls), then stopped before the JAX engine
    import lrge_tpu.utils.jaxcache as jaxcache

    _set_env(monkeypatch, SMALL)
    monkeypatch.setattr(jaxcache, "enable_cache", lambda: None)
    drawn = []
    real = ref_bench.make_reads

    def spy(rng, genome, n, mean_len, err):
        drawn.append((genome, real(rng, genome, n, mean_len, err)))
        if len(drawn) == 2:
            raise _Stop
        return drawn[-1][1]

    monkeypatch.setattr(ref_bench, "make_reads", spy)
    with pytest.raises(_Stop):
        ref_bench.main()
    (genome, targets), (genome_q, queries) = drawn
    c = bench.make_corpus()
    assert c.genome == genome == genome_q
    assert c.targets == targets and c.queries == queries
    assert (len(c.targets), len(c.queries), c.genome_size) == (300, 120, 150_000)
    assert c.tnames[7] == b"t7" and c.qnames[7] == b"q7"


def test_key_lists_are_bench_py_s():
    # the literal lists above are every key of bench.py's "extra" dict
    # and of its real-read dict
    tree = ast.parse((REPO / "bench.py").read_text())
    dicts = [n for n in ast.walk(tree) if isinstance(n, ast.Dict)]
    extra = [
        n.values[i] for n in dicts for i, k in enumerate(n.keys) if isinstance(k, ast.Constant) and k.value == "extra"
    ]
    assert len(extra) == 1
    assert [k.value for k in extra[0].keys if k is not None] == BENCH_PY_KEYS
    real = [n for n in dicts if any(isinstance(k, ast.Constant) and k.value == "realread_qps" for k in n.keys)]
    assert len(real) == 1 and [k.value for k in real[0].keys] == REALREAD_KEYS


def test_main_prints_bench_json(bench_run):
    stdout, run = bench_run
    lines = stdout.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec == json.loads(json.dumps(run.record))
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert (rec["metric"], rec["unit"]) == ("query_reads_per_sec_per_chip", "reads/s")
    assert rec["vs_baseline"] == round(rec["value"] / bench.BASELINE_QPS, 2)
    extra = rec["extra"]
    assert set(extra) == {RENAMED.get(k, k) for k in BENCH_PY_KEYS} | set(NEW_KEYS) | set(REALREAD_KEYS)
    # the real reads resampled 4x as targets (at most the synthetic
    # run's 300) and 2x as queries (at most 120)
    assert extra["realread_queries"] == 120 and extra["realread_qps"] > 0
    # one pass a measurement; the eager A/B discards its first pass
    assert len(extra["map_s_passes"]) == len(extra["device_only_passes"]) == len(extra["ab_eager_passes"]) == 1
    assert extra["total_wall_s"] == pytest.approx(
        extra["index_build_s"] + extra["planes_s"] + extra["warmup_s"] + extra["map_s"], abs=0.1
    )
    assert extra["device"] == {"name": "cpu", "power_limit": None} and extra["hbm_gbps_peak"] is None
    assert extra["host_share_ratio"] == port_engine.HOST_RATE_RATIO
    assert extra["host_share_rows"] == extra["fallback_triggers"].get("host_share", 0)
    assert extra["host_fallback_rows"] == sum(v for k, v in extra["fallback_triggers"].items() if k != "host_share")
    assert {"prep", "enqueue", "collect", "retry"} <= set(extra["last_phases"])
    assert extra["compile_cache"] == {"kernel_library_cached": None, "graph_captures": 0, "graph_capture_s": 0.0}
    # no kernel launches on the CPU: the wrapper runs the plain version
    assert extra["chain_dp_launches"] == extra["device_only_chain_dp_launches"] == 0
    assert 0 < extra["anchor_slot_occupancy"] <= 1


def test_counts_equal_host_and_jax_engine(bench_run, monkeypatch):
    from lrge_tpu.device_engine import DeviceOverlapEngine as RefEngine
    from lrge_tpu.estimate import median, per_read_estimate_batch
    from lrge_tpu.ops.index import build_index
    from lrge_tpu.platform import Platform, preset_for

    stdout, run = bench_run
    c = run.corpus
    items = list(zip(c.qnames, c.queries))
    host = run.engine.host.count_overlaps_many(items)
    np.testing.assert_array_equal(run.counts, [n for n, _ in host])
    # the JAX engine at the bench's shape, device-only
    _set_env(monkeypatch, {**BUCKET, "LRGE_HOST_SHARE": "0", "LRGE_SHARDS": "1"})
    index = build_index(c.targets, c.tnames, preset_for(Platform.NANOPORE, dual=True))
    ref = RefEngine(index, batch_size=128, num_anchors=4096, window=32).count_batch(c.qnames, c.queries)
    np.testing.assert_array_equal(run.counts, ref.counts)
    avg_t = np.float32(sum(len(s) for s in c.targets)) / np.float32(len(c.targets))
    ests = per_read_estimate_batch(np.array([len(q) for q in c.queries]), float(avg_t), len(c.targets), ref.counts, 100)
    _, est, _ = median(ests[np.isfinite(ests)])
    assert json.loads(stdout)["extra"]["estimate_bp"] == int(est)


@pytest.mark.parametrize("argv", [[], ["--device", "cuda"], ["--device", "cuda:0"]])
def test_without_cuda_exits_nonzero(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(bench, "run", lambda device: ran.append(device))
    with pytest.raises(SystemExit) as exc:
        bench.main(argv)
    assert exc.value.code not in (0, None) and "CUDA" in str(exc.value.code)
    assert ran == []


@pytest.fixture(scope="module")
def tiny_engine():
    from lrge_tpu_torch.ops.index import build_index
    from lrge_tpu_torch.platform import Platform, preset_for

    rng = np.random.default_rng(12)
    genome = bytes(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=20_000)])
    reads = bench.make_reads(rng, genome, 20, 1500, 0.02)
    index = build_index(reads, [b"t%d" % i for i in range(20)], preset_for(Platform.NANOPORE, dual=True))
    return port_engine.DeviceOverlapEngine(index, device=CPU)


@pytest.mark.parametrize("cores", [2, 8, 32])
def test_host_share_default_and_overrides(tiny_engine, monkeypatch, cores):
    if not port_engine._has_native_count():
        pytest.skip("the host share needs the native count kernel")
    _set_env(monkeypatch, {})
    monkeypatch.setattr(os, "cpu_count", lambda: cores)
    n = 100 * tiny_engine.batch_size
    r = port_engine.HOST_RATE_RATIO
    assert port_engine.host_rate_ratio() == r
    assert tiny_engine._host_share_fraction(n) == pytest.approx(min(0.9, cores * r / (cores * r + 1)))
    monkeypatch.setenv("LRGE_HOST_RATE_RATIO", "0.05")
    assert port_engine.host_rate_ratio() == 0.05
    assert tiny_engine._host_share_fraction(n) == pytest.approx(cores * 0.05 / (cores * 0.05 + 1))
    monkeypatch.setenv("LRGE_HOST_SHARE", "0.25")
    assert tiny_engine._host_share_fraction(n) == 0.25
    # too few device rows for a share
    assert tiny_engine._host_share_fraction(4 * tiny_engine.batch_size - 1) == 0.0


@pytest.mark.gpu
def test_programmed_and_eager_counts_equal_on_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chain DP has no CPU mode there")
    from lrge_tpu_torch.ops.cuda_lib import LAUNCHES
    from lrge_tpu_torch.ops.index import build_index
    from lrge_tpu_torch.platform import Platform, preset_for

    _set_env(monkeypatch, {**SMALL, "LRGE_HOST_SHARE": "0"})
    c = bench.make_corpus()
    index = build_index(c.targets, c.tnames, preset_for(Platform.NANOPORE, dual=True))
    dev = torch.device("cuda", 0)
    out = {}
    for graphs in (True, False):
        engine = port_engine.DeviceOverlapEngine(index, device=dev, batch_size=128, num_anchors=4096,
                                                 graphs=graphs)
        engine.warmup([len(q) for q in c.queries])
        before = LAUNCHES.launches
        res = engine.count_batch(c.qnames, c.queries)
        assert LAUNCHES.launches > before
        assert all((p.graph is not None) == graphs for p in engine.programs.values()) and engine.programs
        out[graphs] = res
    np.testing.assert_array_equal(out[True].counts, out[False].counts)
    np.testing.assert_array_equal(out[True].had_mapping, out[False].had_mapping)
