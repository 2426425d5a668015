"""One run of one benchmark cell of ``lrge_tpu_torch`` on the card.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  The cell (``BENCHMARK.json``) names a
configuration (``benchmark/configs/``) and a traffic mix
(``benchmark/traffic/``).

Set-up: the genome, targets and queries from ``--seed``
(``benchmark/corpus.py``); the target index
(``lrge_tpu_torch.ops.index.build_index``); the engine
(``DeviceOverlapEngine``, which builds the index planes on the card);
``warmup`` on the queries' own lengths, which captures the super-batch
programs; one untimed pass.  Then the window: pass after pass until
``--seconds`` have gone by, ending with the pass that crosses the
deadline.  A pass is ``count_batch`` over every query at the engine's
default host share (the CLI's schedule), then the port's estimator over
its counts.  With ``--trace 1`` the first passes of the window run under
``torch.profiler`` (``benchmark/trace.py``) and the run reports the
cell's per-layer metrics instead of its end-to-end ones.

After the window the program's state is freed and the plain reference
judges the window's counts and estimate (``benchmark/check.py``).  The
last line on standard output is one JSON object; the numbers compared
and their limits are the last lines on standard error and the last key
of that object.  Without a CUDA card, with fewer cards than the cell
asks for, or with ``jax``, ``jaxlib``, ``flax`` or ``lrge_tpu`` loaded
in this process, the run prints no result and exits non-zero.
"""

from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "lrge_tpu")
CACHE = Path(__file__).resolve().parent / "_cache"


def process_age() -> float:
    """Seconds since this process started (from ``/proc``; else since
    this module was imported)."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of ``FORBIDDEN``, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def set_environment() -> None:
    """Kernel caches at fixed paths inside the checkout, and the engine's
    own defaults: no ``LRGE_*`` override reaches the program."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    for key in [k for k in os.environ if k.startswith("LRGE_")]:
        del os.environ[key]


def card(device) -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()
        return out[device.index or 0].strip()
    except (OSError, IndexError, subprocess.SubprocessError):
        import torch

        return f"{torch.cuda.get_device_name(device)}, power limit unknown"


@dataclass
class Pass:
    wall: float
    counts: np.ndarray
    estimate: tuple
    fallback_rows: int
    triggers: dict
    phases: dict
    anchors_valid: int
    anchor_slots: int


@dataclass
class Record:
    """What a run read, for the metric readers (``benchmark/metrics``)."""

    config: dict
    n_queries: int
    card: str
    setup_s: float = 0.0
    spans: dict = field(default_factory=dict)
    passes: list = field(default_factory=list)
    window_s: float = 0.0
    trace: dict | None = None
    traced_passes: int = 0
    reference: object = None
    device_plan: dict = field(default_factory=dict)
    notes: list = field(default_factory=list)


def run_cell(cell, seed: int, seconds: float, trace_on: bool, device, *, fault=None, workers=None) -> dict:
    """Set-up, window and check of ``cell`` on ``device``; returns the
    result object and the lines for standard error (without the import
    check).  ``fault`` (``benchmark/faults.py``: the control and the
    tests' faults) wraps the pass's two steps: ``fault(count, estimate,
    ctx)`` returns the pair to run instead."""
    import torch

    from lrge_tpu_torch.device_engine import DeviceOverlapEngine
    from lrge_tpu_torch.estimate import LOWER_QUANTILE, UPPER_QUANTILE, median, per_read_estimate_batch
    from lrge_tpu_torch.ops.index import build_index
    from lrge_tpu_torch.platform import Platform, preset_for

    from . import check, roofline, spec, trace
    from .corpus import make_corpus
    from .reference.params import Params
    from .workers import Workers

    cfg = cell.config
    rec = Record(cfg, cfg["query_reads"], card(device))
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)

    t0 = time.perf_counter()
    corpus = make_corpus(cell.traffic, cfg["target_reads"], cfg["query_reads"], seed)
    rec.spans["corpus_s"] = time.perf_counter() - t0
    params = preset_for(Platform.from_str(cfg["platform"]), dual=cfg["dual"])
    t0 = time.perf_counter()
    index = build_index(corpus.targets, corpus.tnames, params)
    rec.spans["index_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = DeviceOverlapEngine(
        index, device=device, batch_size=cfg["batch_size"], num_anchors=cfg["num_anchors"], window=cfg["window"]
    )
    sync()
    rec.spans["planes_s"] = time.perf_counter() - t0
    qlens = np.array([len(q) for q in corpus.queries])
    t0 = time.perf_counter()
    engine.warmup(qlens.tolist())
    sync()
    rec.spans["warmup_s"] = time.perf_counter() - t0
    rec.spans["capture_s"] = sum(p.capture_s for p in engine.programs.values())

    n_t = len(corpus.targets)
    avg_t = float(np.float32(sum(len(t) for t in corpus.targets)) / np.float32(n_t))

    def count(names, seqs):
        res = engine.count_batch(names, seqs)
        return res.counts, res.fallback_rows

    def estimate(counts, lens):
        ests = per_read_estimate_batch(lens, avg_t, n_t, counts, params.min_chain_score)
        return median(ests[np.isfinite(ests)], LOWER_QUANTILE, UPPER_QUANTILE)

    if fault is not None:
        ctx = {"avg_target_len": avg_t, "n_targets": n_t, "threshold": params.min_chain_score}
        count, estimate = fault(count, estimate, ctx)

    def one_pass() -> Pass:
        engine.fallback_triggers.clear()
        t = time.perf_counter()
        with torch.profiler.record_function(trace.SPAN_PREFIX + "count_batch"):
            counts, fallback = count(corpus.qnames, corpus.queries)
        with torch.profiler.record_function(trace.SPAN_PREFIX + "estimate"):
            est = estimate(counts, qlens)
        wall = time.perf_counter() - t
        return Pass(
            wall, np.array(counts, copy=True), tuple(est), int(fallback), dict(engine.fallback_triggers),
            dict(engine.last_phases), int(engine.last_anchors_valid), int(engine.last_anchor_slots),
        )

    t0 = time.perf_counter()
    warm = one_pass()
    rec.spans["warm_pass_s"] = time.perf_counter() - t0
    rec.setup_s = process_age()

    handle = trace.start() if trace_on else None
    prof = None
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        rec.passes.append(one_pass())
        now = time.perf_counter()
        if handle is not None and now - t_start >= trace.TRACE_SECONDS:
            prof, handle = trace.stop(handle), None
            rec.traced_passes = len(rec.passes)
        if now >= deadline:
            break
    rec.window_s = time.perf_counter() - t_start
    if handle is not None:
        prof = trace.stop(handle)
        rec.traced_passes = len(rec.passes)

    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    programs = len(engine.programs)
    t0 = time.perf_counter()
    rec.device_plan = roofline.device_plan(engine, corpus.queries)
    t_plan = time.perf_counter() - t0
    del engine, index
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if prof is not None:
        rec.trace = trace.reduce(prof)
        del prof
    t_reduce = time.perf_counter() - t0

    last = rec.passes[-1]
    t0 = time.perf_counter()
    rec.reference = check.Reference(corpus, Params.from_config(cfg), Workers(workers))
    t_index = time.perf_counter() - t0
    t0 = time.perf_counter()
    numbers = check.judge(rec.reference, seed, [p.counts for p in rec.passes], last.estimate)
    t_counts = time.perf_counter() - t0

    metrics = {}
    t0 = time.perf_counter()
    for m in cell.per_layer if trace_on else cell.end_to_end:
        value = spec.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    t_readers = time.perf_counter() - t0
    device_rec = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind, "count": 1,
                  "memory_peak_bytes": peak}
    phases = {k: float(np.mean([p.phases.get(k, 0.0) for p in rec.passes])) for k in last.phases}
    triggers = {}
    for p in rec.passes:
        for k, v in p.triggers.items():
            triggers[k] = triggers.get(k, 0) + v
    rec.notes[:0] = [
        f"card: {rec.card}",
        f"seed {seed}: {n_t} targets, {len(corpus.queries)} queries, genome {corpus.genome_size} bp",
        f"set-up {rec.setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in rec.spans.items())
        + f"; {programs} programs; warm pass {warm.wall:.4f} s",
        f"passes {len(rec.passes)} in {rec.window_s:.3f} s; wall min {min(p.wall for p in rec.passes):.4f} "
        f"median {float(np.median([p.wall for p in rec.passes])):.4f} max {max(p.wall for p in rec.passes):.4f} s",
        "pass walls (ms): " + " ".join(f"{1e3 * p.wall:.0f}" for p in rec.passes),
        "phase seconds a pass (mean): " + ", ".join(f"{k} {v:.6f}" for k, v in phases.items()),
        f"host rows by trigger over the window: {triggers} ({last.fallback_rows} in the last pass)",
        f"max_memory_allocated {peak} B",
        "estimate (lower, median, upper) bp: " + ", ".join(f"{x:.1f}" if x is not None else "None" for x in last.estimate),
    ]
    if rec.trace is not None:
        rec.notes.append(
            f"traced {rec.traced_passes} passes: window {rec.trace['window_s']:.6f} s, device busy "
            f"{rec.trace['busy_s']:.6f} s, chain DP kernels {trace.chain_seconds(rec.trace):.6f} s"
        )
        device_rec["busy_s"] = rec.trace["busy_s"]
        device_rec["window_s"] = rec.trace["window_s"]
    checks = {k: {"value": numbers[k], "limit": v} for k, v in check.LIMITS.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {
        "correct": bool(correct),
        "attempted": len(rec.passes) * len(corpus.queries),
        "failed": int(numbers["rows_wrong"] + sum(int((p.counts != last.counts).sum()) for p in rec.passes)),
        "metrics": metrics,
        "device": device_rec,
    }
    if rec.trace is not None:
        result["breakdown"] = trace.breakdown(rec.trace)
    rec.notes.append(f"checked {numbers['rows_checked']} sampled rows against the reference: its index "
                     f"{t_index:.3f} s, its counts {t_counts:.3f} s")
    rec.notes.append(f"after the window: device plan {t_plan:.3f} s, trace reduced {t_reduce:.3f} s, reference "
                     f"{t_index + t_counts:.3f} s, readers {t_readers:.3f} s; process age {process_age():.3f} s")
    result["checks"] = checks
    return result, rec.notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()
    from . import spec

    try:
        cell = spec.cell(spec.load(), args.workload)
    except (OSError, KeyError, ValueError) as err:
        print(f"[bench] no such cell or its files are missing: {args.workload}: {err!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[bench] {args.workload} needs {cell.chips} CUDA card(s); {have} available", file=sys.stderr)
        return 2
    result, notes = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"[bench] modules of {', '.join(FORBIDDEN)} are loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for line in notes:
        print(f"[bench] {line}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
