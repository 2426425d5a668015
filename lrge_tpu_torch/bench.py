"""Benchmark of the port: query-reads/s through the device overlap pipeline.

    python -m lrge_tpu_torch.bench [--device cpu]

The counterpart of the repo's ``bench.py``, which measures the JAX
package; this one measures ``lrge_tpu_torch`` on a CUDA card, in the
same order of work and on the same corpus, and prints the same JSON
line: ``{"metric", "value", "unit", "vs_baseline", "extra"}``.

The corpus is ``bench.py``'s, byte for byte: a random genome (seed 6)
with a dispersed 2 kb family of five copies and a tandem 400 bp x 5
block, targets and queries drawn from it at mean 2.5 kb with
substitutions.  The sizes are read from the same environment variables
with the same defaults: ``BENCH_TARGETS`` (10,000), ``BENCH_QUERIES``
(5,000), ``BENCH_GENOME`` (4,400,000 bp), ``BENCH_ERR`` (0.05),
``BENCH_REPS`` (3 passes a measurement), ``BENCH_WINDOW`` (32) and
``BENCH_AB`` (1: run the A/B).  The engine is ``bench.py``'s shape:
batches of 128 rows, A = 4096 anchors, W = 32, the ONT preset with
``dual=True``.

Timed steps: the index build (``index_build_s``), the engine's
construction, where the index planes are built on the card
(``planes_s``; ``bench.py`` leaves it out of its wall), the warm-up
over the query lengths, which captures the pass's CUDA graphs
(``warmup_s``), ``BENCH_REPS`` device-only passes
(``LRGE_HOST_SHARE=0``), the A/B, and ``BENCH_REPS`` heterogeneous
passes at the engine's default host share, whose best is the headline
``value``.  ``total_wall_s`` is index + planes + warm-up + one pass.

The A/B is programmed against eager: the same device-only passes on an
engine built ``graphs=False``, which runs each super-batch's function
eagerly instead of replaying its CUDA graph (the counterpart of the
reference's fused/unfused A/B); the eager route still launches the
CUDA chain DP.  Tripwires, each a non-zero exit: eager counts differ
from programmed ones; the heterogeneous counts differ from the
device-only ones; 200 sampled rows (rng 0) differ from the exact host
engine's.

The real-read section of ``bench.py`` resamples a BAM of real ONT
reads; here it runs only when ``BENCH_TOY_BAM`` names such a file
(``BENCH_REALREAD=0`` skips it).

It runs on the card unless ``--device cpu`` is passed (the tests: the
chain DP then runs its plain PyTorch version); without CUDA and
without ``--device cpu`` it exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

# the reference's published run, doubled for 16 CPU threads: a
# documented estimate, not a measurement (bench.py's BASELINE_QPS)
BASELINE_QPS = 600.0
# bench.py's byte model: each executed [B, A] anchor slot moves ~220 B
SLOT_BYTES = 220
H100_HBM_GBPS = 3350.0  # H100 SXM HBM3, 3.35 TB/s
SAMPLE = 200  # rows held against the host engine (all of a smaller query set)


def make_reads(rng, genome, n, mean_len, err):
    lens = np.clip(rng.gamma(3.0, mean_len / 3.0, size=n).astype(int), 500, 30_000)
    rc = bytes.maketrans(b"ACGT", b"TGCA")
    reads = []
    g = np.frombuffer(genome, dtype=np.uint8)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    for L in lens:
        L = int(min(L, len(genome) - 1))
        pos = int(rng.integers(0, len(genome) - L))
        arr = g[pos : pos + L].copy()
        nerr = rng.binomial(L, err)
        if nerr:
            sites = rng.integers(0, L, size=nerr)
            arr[sites] = bases[rng.integers(0, 4, size=nerr)]
        seq = arr.tobytes()
        if rng.integers(0, 2):
            seq = seq.translate(rc)[::-1]
        reads.append(seq)
    return reads


@dataclass
class Corpus:
    genome_size: int  # the requested size (the estimate's truth)
    genome: bytes
    targets: list
    queries: list
    tnames: list
    qnames: list


def make_corpus() -> Corpus:
    """``bench.py``'s genome and reads, from its environment variables."""
    n_targets = int(os.environ.get("BENCH_TARGETS", 10_000))
    n_queries = int(os.environ.get("BENCH_QUERIES", 5_000))
    genome_size = int(os.environ.get("BENCH_GENOME", 4_400_000))
    err = float(os.environ.get("BENCH_ERR", 0.05))
    rng = np.random.default_rng(6)
    genome = np.frombuffer(rng.integers(0, 4, size=genome_size, dtype=np.uint8), dtype=np.uint8)
    genome = bytearray(np.frombuffer(b"ACGT", dtype=np.uint8)[genome].tobytes())
    # a dispersed 2 kb family (5 copies) and a tandem 400 bp x 5 block
    fam = bytes(genome[100_000:102_000])
    for c in range(5):
        pos = 500_000 + c * 700_000
        genome[pos : pos + 2_000] = fam
    unit = bytes(genome[200_000:200_400])
    genome[300_000:302_000] = unit * 5
    genome = bytes(genome)
    targets = make_reads(rng, genome, n_targets, 2500, err)
    queries = make_reads(rng, genome, n_queries, 2500, err)
    tnames = [b"t%d" % i for i in range(n_targets)]
    qnames = [b"q%d" % i for i in range(n_queries)]
    return Corpus(genome_size, genome, targets, queries, tnames, qnames)


@contextlib.contextmanager
def host_share(value: str | None):
    """``LRGE_HOST_SHARE`` set to ``value`` (None: unset) inside the block."""
    old = os.environ.pop("LRGE_HOST_SHARE", None)
    if value is not None:
        os.environ["LRGE_HOST_SHARE"] = value
    try:
        yield
    finally:
        os.environ.pop("LRGE_HOST_SHARE", None)
        if old is not None:
            os.environ["LRGE_HOST_SHARE"] = old


def card(device: torch.device) -> dict:
    """The card's name and power limit as ``nvidia-smi`` gives them (on
    the CPU: ``{"name": "cpu", "power_limit": None}``)."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[device.index or 0]
    name, power = (x.strip() for x in line.rsplit(",", 1))
    return {"name": name, "power_limit": power}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Pass:
    """One timed ``count_batch`` pass and the engine's record of it."""

    seconds: float
    result: object  # BatchCounts
    triggers: dict
    launches: int  # the chain DP's BASE launches in the pass
    phases: dict
    anchors_valid: int
    anchor_slots: int
    host_s: float


def timed_pass(engine, names, seqs) -> Pass:
    from .ops.cuda_lib import LAUNCHES

    engine.fallback_triggers.clear()
    before = LAUNCHES.launches
    t0 = time.perf_counter()
    res = engine.count_batch(names, seqs)
    dt = time.perf_counter() - t0
    return Pass(dt, res, dict(engine.fallback_triggers), LAUNCHES.launches - before,
                dict(engine.last_phases), engine.last_anchors_valid, engine.last_anchor_slots, engine.last_host_s)


def measure(engine, names, seqs, reps, discard_first=False) -> tuple[list, Pass]:
    """``reps`` passes (after one discarded pass with ``discard_first``):
    every pass's seconds and the fastest pass."""
    passes = [timed_pass(engine, names, seqs) for _ in range(reps + int(discard_first))]
    passes = passes[int(discard_first):]
    return [p.seconds for p in passes], min(passes, key=lambda p: p.seconds)


@dataclass
class BenchRun:
    record: dict  # the JSON line
    counts: np.ndarray  # the measured (heterogeneous) pass's counts
    corpus: Corpus
    engine: object  # the programmed engine, warm


def run(device: torch.device) -> BenchRun:
    """The benchmark on ``device``; raises ``SystemExit`` when a tripwire
    fires."""
    from .device_engine import DeviceOverlapEngine, host_rate_ratio
    from .estimate import median, per_read_estimate_batch
    from .ops import cuda_lib
    from .ops.index import build_index
    from .ops.program import SuperBatchProgram
    from .platform import Platform, preset_for

    dev_info = card(device)  # before the timed window
    corpus = make_corpus()
    names, seqs = corpus.qnames, corpus.queries
    n_queries, n_targets = len(seqs), len(corpus.targets)
    print(f"[bench] genome={corpus.genome_size} targets={n_targets} queries={n_queries} on "
          f"{dev_info['name']}", file=sys.stderr)
    reps = int(os.environ.get("BENCH_REPS", 3))
    window = int(os.environ.get("BENCH_WINDOW", 32))
    shape = dict(device=device, batch_size=128, num_anchors=4096, window=window)
    params = preset_for(Platform.NANOPORE, dual=True)

    t0 = time.perf_counter()
    index = build_index(corpus.targets, corpus.tnames, params)
    t_index = time.perf_counter() - t0
    print(f"[bench] index build: {t_index:.2f}s ({len(index.keys)} postings)", file=sys.stderr)

    kernel_cached = cuda_lib.library_path().exists() if device.type == "cuda" else None
    t0 = time.perf_counter()
    engine = DeviceOverlapEngine(index, **shape)
    sync(device)
    t_planes = time.perf_counter() - t0
    captures = SuperBatchProgram.captures
    t0 = time.perf_counter()
    # the buckets of the device-only passes, a superset of the
    # heterogeneous passes' buckets
    with host_share("0"):
        engine.warmup([len(q) for q in seqs])
    sync(device)
    t_warm = time.perf_counter() - t0
    compile_cache = {
        "kernel_library_cached": kernel_cached,
        "graph_captures": SuperBatchProgram.captures - captures,
        "graph_capture_s": round(sum(p.capture_s for p in engine.programs.values()), 3),
    }
    print(f"[bench] planes: {t_planes:.2f}s, warmup/capture: {t_warm:.1f}s {compile_cache}", file=sys.stderr)

    # device-only throughput first (host share off)
    with host_share("0"):
        dev_times, dev = measure(engine, names, seqs, reps)
    t_dev = min(dev_times)
    dev_qps = n_queries / t_dev
    # bench.py's utilization model: valid anchors chained per second, and
    # ~220 B of device-memory traffic per executed anchor slot, an
    # order-of-magnitude check against the card's peak, not a measurement
    anchors_per_s = dev.anchors_valid / t_dev
    hbm_gbps_est = dev.anchor_slots * SLOT_BYTES * 1e-9 / t_dev
    print(f"[bench] device-only map: {t_dev:.2f}s ({dev_qps:.0f} q/s), median {np.median(dev_times):.2f}s, "
          f"fallback={dev.result.fallback_rows}, anchors/s={anchors_per_s / 1e6:.1f}M "
          f"occ={dev.anchors_valid / max(dev.anchor_slots, 1):.2f} ~HBM={hbm_gbps_est:.0f}GB/s", file=sys.stderr)

    # programmed-vs-eager A/B (device-only): the same passes with every
    # super-batch's function run eagerly; the first eager pass is discarded
    ab_times, ab = [], None
    if os.environ.get("BENCH_AB", "1") == "1":
        eager = DeviceOverlapEngine(index, graphs=False, **shape)
        with host_share("0"):
            ab_times, ab = measure(eager, names, seqs, reps, discard_first=True)
        del eager
        if not np.array_equal(ab.result.counts, dev.result.counts):
            raise SystemExit("[bench] FATAL: eager counts != programmed counts")
        print(f"[bench] eager A/B: best {min(ab_times):.2f}s ({n_queries / min(ab_times):.0f} q/s), "
              f"median {np.median(ab_times):.2f}s", file=sys.stderr)

    # heterogeneous passes at the engine's default host share
    with host_share(None):
        map_times, res = measure(engine, names, seqs, reps)
    t_map = min(map_times)
    qps = n_queries / t_map
    # the wall to a first result: index + planes + warm-up + one pass
    t_total = t_index + t_planes + t_warm + t_map

    # tripwires: the heterogeneous run, the device-only run and the exact
    # host engine must agree on counts (sampled)
    counts = res.result.counts
    if not np.array_equal(counts, dev.result.counts):
        raise SystemExit("[bench] FATAL: host-share run counts != device-only counts")
    sample = np.random.default_rng(0).choice(n_queries, size=min(SAMPLE, n_queries), replace=False)
    host_counts = [c for c, _ in engine.host.count_overlaps_many([(names[i], seqs[i]) for i in sample])]
    if not np.array_equal(counts[sample], host_counts):
        raise SystemExit("[bench] FATAL: device counts != host counts on sample")

    # the estimate; its ~6% overestimate on this corpus is the
    # estimator's substitution-rate bias, which the reference shares
    avg_t = np.float32(sum(len(s) for s in corpus.targets)) / np.float32(n_targets)
    ests = per_read_estimate_batch(np.array([len(q) for q in seqs]), float(avg_t), n_targets, counts, 100)
    _, est, _ = median(ests[np.isfinite(ests)])
    err_pct = abs(est - corpus.genome_size) / corpus.genome_size * 100.0
    print(f"[bench] map: {t_map:.2f}s ({qps:.0f} q/s), fallback={res.result.fallback_rows} {res.triggers}, "
          f"estimate={est:.0f} ({err_pct:.2f}% err)", file=sys.stderr)
    print(f"[bench] phases: { {k: round(v, 2) for k, v in res.phases.items()} }", file=sys.stderr)

    real = real_reads(params, shape, reps, len(corpus.targets), n_queries)
    record = {
        "metric": "query_reads_per_sec_per_chip",
        "value": round(qps, 1),
        "unit": "reads/s",
        "vs_baseline": round(qps / BASELINE_QPS, 2),
        "extra": {
            "estimate_bp": int(est),
            "estimate_err_pct": round(err_pct, 3),
            "index_build_s": round(t_index, 2),
            "planes_s": round(t_planes, 2),
            "warmup_s": round(t_warm, 1),
            "total_wall_s": round(t_total, 2),
            "map_s": round(t_map, 2),
            "device_only_qps": round(dev_qps, 1),
            "map_s_passes": [round(x, 3) for x in map_times],
            "map_s_median": round(float(np.median(map_times)), 3),
            "device_only_passes": [round(x, 3) for x in dev_times],
            "device_only_qps_median": round(n_queries / float(np.median(dev_times)), 1),
            "ab_eager_passes": [round(x, 3) for x in ab_times],
            "ab_eager_qps": round(n_queries / min(ab_times), 1) if ab_times else None,
            "anchors_per_s": round(anchors_per_s, 0),
            "anchor_slot_occupancy": round(dev.anchors_valid / max(dev.anchor_slots, 1), 3),
            "hbm_gbps_est": round(hbm_gbps_est, 1),
            "hbm_gbps_peak": H100_HBM_GBPS if device.type == "cuda" else None,
            "host_fallback_rows": int(res.result.fallback_rows),
            "host_share_rows": int(res.triggers.get("host_share", 0)),
            "host_share_ratio": host_rate_ratio(),
            "fallback_triggers": res.triggers,
            "last_phases": {k: round(v, 6) for k, v in res.phases.items()},
            "chain_dp_launches": res.launches,
            "device_only_chain_dp_launches": dev.launches,
            "ab_eager_chain_dp_launches": ab.launches if ab is not None else None,
            "compile_cache": compile_cache,
            "device": dev_info,
            **real,
        },
    }
    return BenchRun(record, counts, corpus, engine)


def real_reads(params, shape, reps, n_targets, n_queries) -> dict:
    """``bench.py``'s real-read section on the BAM that ``BENCH_TOY_BAM``
    names: its reads resampled 4x as targets and 2x as queries (at most
    the synthetic run's counts) with 1.5% fresh substitutions a copy, an
    engine at A = 6144, 100 rows held against the host; {} when skipped."""
    from .device_engine import DeviceOverlapEngine
    from .io import iter_records
    from .ops.index import build_index

    toy = os.environ.get("BENCH_TOY_BAM")
    if os.environ.get("BENCH_REALREAD", "1") != "1" or not toy or not os.path.exists(toy):
        return {}
    reads = [sq for _, sq in iter_records(toy)]
    rrng = np.random.default_rng(6)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    n_rt = min(n_targets, 4 * len(reads))
    n_rq = min(n_queries, 2 * len(reads))

    def resample(n):
        out = []
        for i in rrng.permutation(n * 2)[:n] % len(reads):
            arr = np.frombuffer(reads[i], dtype=np.uint8).copy()
            ne = rrng.binomial(len(arr), 0.015)
            if ne:
                arr[rrng.integers(0, len(arr), size=ne)] = bases[rrng.integers(0, 4, size=ne)]
            out.append(arr.tobytes())
        return out

    r_targets, r_queries = resample(n_rt), resample(n_rq)
    rt_names = [b"rt%d" % i for i in range(n_rt)]
    rq_names = [b"rq%d" % i for i in range(n_rq)]
    t0 = time.perf_counter()
    r_index = build_index(r_targets, rt_names, params)
    r_tindex = time.perf_counter() - t0
    r_engine = DeviceOverlapEngine(r_index, **dict(shape, num_anchors=6144))
    t0 = time.perf_counter()
    r_engine.warmup([len(q) for q in r_queries])
    r_twarm = time.perf_counter() - t0
    r_times, r_best = measure(r_engine, rq_names, r_queries, reps)
    sample = np.random.default_rng(1).choice(n_rq, size=100, replace=False)
    r_host = [c for c, _ in r_engine.host.count_overlaps_many([(rq_names[i], r_queries[i]) for i in sample])]
    if not np.array_equal(r_best.result.counts[sample], r_host):
        raise SystemExit("[bench] FATAL: real-read device counts != host")
    r_tmap = min(r_times)
    print(f"[bench] real reads ({toy} resample): {r_tmap:.2f}s ({n_rq / r_tmap:.0f} q/s), "
          f"fallback={r_best.result.fallback_rows}", file=sys.stderr)
    return {
        "realread_qps": round(n_rq / r_tmap, 1),
        "realread_queries": n_rq,
        "realread_map_s": round(r_tmap, 3),
        "realread_index_s": round(r_tindex, 2),
        "realread_warmup_s": round(r_twarm, 1),
        "realread_fallback_rows": int(r_best.result.fallback_rows),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default %(default)s; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("[bench] no CUDA card is available (torch.cuda.is_available() is False); "
                         "pass --device cpu to run on the CPU")
    print(json.dumps(run(device).record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
