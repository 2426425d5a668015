"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; the first failure ends the run with a non-zero exit:

1. the card's name and power limit (``nvidia-smi``);
2. build the chain DP kernel from ``lrge_tpu_torch/csrc/chain_dp.cu``;
3. the kernel against its plain PyTorch version on the card, at the
   main path's shapes ([512, 4096] and [1024, 2048] anchors, W = 32)
   and on a colinear skip-break corpus (W = 64): ``f`` and ``broke`` must be
   bit-equal (tolerance 0, integer outputs);
4. the main path: ``lrge_tpu_torch.cli.main`` on a synthetic 4.4 Mbp
   genome (15,000 reads, mean 2.5 kb, 5% errors, seed 6) at the
   published run shape ``-T 10000 -Q 5000``, with ``--engine auto``,
   which must resolve to the device and launch the kernel; then the
   device engine alone on the same index, timed, with 300 sampled query
   counts held against the exact host engine.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits 1 and prints
no result.
"""

from __future__ import annotations

import json
import logging
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SEED = 6
KW = dict(span=15, max_gap=5000, bw=500, max_skip=25)
PEN_GAP = 0.01 * 15  # ONT preset chn_pen_gap
IMAX = np.iinfo(np.int32).max


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def anchor_rows(rng, B, A, *, colinear=False, n_rids=40):
    """Rows of anchors sorted by (rid*2+strand, rpos), valid prefix per row."""
    key2 = np.full((B, A), IMAX, np.int32)
    rpos = np.zeros((B, A), np.int32)
    qpos = np.zeros((B, A), np.int32)
    valid = np.zeros((B, A), np.int32)
    for b in range(B):
        n = int(rng.integers(A // 4, A))
        if colinear:
            base = np.arange(n) * 3
            rp = base + rng.integers(0, 40, n)
            qp = base + rng.integers(0, 40, n)
            o = np.argsort(rp, kind="stable")
            k, rp, qp = np.zeros(n, np.int64), rp[o], qp[o]
        else:
            rid = np.sort(rng.integers(0, n_rids, n))
            st = rng.integers(0, 2, n)
            rp = rng.integers(0, 3 * A, n)
            qp = rng.integers(0, 3 * A, n)
            o = np.lexsort((rp, st, rid))
            k, rp, qp = (rid * 2 + st)[o], rp[o], qp[o]
        key2[b, :n], rpos[b, :n], qpos[b, :n], valid[b, :n] = k, rp, qp, 1
    return key2, rpos, qpos, valid


def kernel_vs_plain(ck, dev):
    """Phase 3: bit-equality and times; returns the main-shape record."""
    # the break needs more than max_skip marked predecessors in view, so
    # the colinear corpus runs at W = 64
    cases = [("main_4096", 512, 4096, 32, False), ("main_2048", 1024, 2048, 32, False),
             ("colinear", 256, 1024, 64, True)]
    rec = {}
    max_err = 0
    for name, B, A, W, colinear in cases:
        rng = np.random.default_rng(SEED + B)
        arrs = [torch.from_numpy(a).to(dev) for a in anchor_rows(rng, B, A, colinear=colinear)]
        nvalid = arrs[3].sum(dim=1).to(torch.int32)
        for _ in range(3):  # warm-up
            f_k, b_k = ck.chain_dp_skip(*arrs, nvalid, PEN_GAP, window=W, **KW)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        reps = 20
        start.record()
        for _ in range(reps):
            f_k, b_k = ck.chain_dp_skip(*arrs, nvalid, PEN_GAP, window=W, **KW)
        end.record()
        torch.cuda.synchronize()
        k_ms = start.elapsed_time(end) / reps
        t0 = time.perf_counter()
        f_p, b_p = ck.chain_dp_skip_plain(*arrs, nvalid, PEN_GAP, window=W, **KW)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        err = max(int((f_k.long() - f_p.long()).abs().max()), int((b_k != b_p).sum()))
        n_broke = int(b_p.sum())
        print(f"[kernel] {name} [{B}, {A}] W={W}: kernel {k_ms:.4f} ms, plain {p_ms:.1f} ms, "
              f"max_abs_err {err}, broke rows {n_broke}", flush=True)
        if err:
            fail(f"chain kernel != plain version on {name}")
        if colinear and not n_broke:
            fail("the colinear corpus must fire the skip break")
        max_err = max(max_err, err)
        rec.setdefault("ms", k_ms)
        rec.setdefault("plain_ms", p_ms)
    rec["max_abs_err"] = max_err
    return rec


def make_reads(rng, genome, n, mean_len, err):
    lens = np.clip(rng.gamma(3.0, mean_len / 3.0, size=n).astype(int), 500, 30_000)
    rc = bytes.maketrans(b"ACGT", b"TGCA")
    g = np.frombuffer(genome, dtype=np.uint8)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = []
    for L in lens:
        L = int(min(L, len(genome) - 1))
        pos = int(rng.integers(0, len(genome) - L))
        arr = g[pos : pos + L].copy()
        nerr = rng.binomial(L, err)
        if nerr:
            arr[rng.integers(0, L, size=nerr)] = bases[rng.integers(0, 4, size=nerr)]
        seq = arr.tobytes()
        if rng.integers(0, 2):
            seq = seq.translate(rc)[::-1]
        reads.append(seq)
    return reads


def write_corpus(path: Path, n_reads: int, genome_size: int = 4_400_000) -> None:
    """A genome with a dispersed 2 kb five-copy family and a 400 bp x 5
    tandem block; reads at mean 2.5 kb and 5% substitutions."""
    rng = np.random.default_rng(SEED)
    genome = bytearray(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=genome_size, dtype=np.uint8)].tobytes())
    fam = bytes(genome[100_000:102_000])
    for c in range(5):
        pos = 500_000 + c * 700_000
        genome[pos : pos + 2_000] = fam
    unit = bytes(genome[200_000:200_400])
    genome[300_000:302_000] = unit * 5
    reads = make_reads(rng, bytes(genome), n_reads, 2500, 0.05)
    with open(path, "wb") as fh:
        for i, s in enumerate(reads):
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def main_path(ck, dev, gpu_line):
    """Phase 4: the CLI at the published run shape, then the engine alone."""
    from lrge_tpu_torch import cli, device_engine
    from lrge_tpu_torch.strategy import TwoSetStrategy

    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        tmp = Path(tmp)
        fq = tmp / "reads.fq"
        t0 = time.perf_counter()
        write_corpus(fq, 15_000)
        print(f"[main] corpus: {time.perf_counter() - t0:.1f} s", flush=True)
        records = _Records()
        lg = logging.getLogger("lrge")
        lg.addHandler(records)
        lg.setLevel(logging.INFO)
        ck.chain_dp_skip.launches = 0
        t0 = time.perf_counter()
        rc = cli.main([str(fq), "-T", "10000", "-Q", "5000", "-s", str(SEED), "-o", str(tmp / "est.txt")])
        wall = time.perf_counter() - t0
        launches = ck.chain_dp_skip.launches
        lg.removeHandler(records)
        if rc != 0:
            fail(f"cli.main returned {rc}")
        if not any(m.startswith("Using device overlap engine on cuda") for m in records.messages):
            fail("--engine auto did not resolve to the device")
        if launches <= 0:
            fail("the main path never launched the chain kernel")
        est = float((tmp / "est.txt").read_text())
        if not np.isfinite(est) or abs(est - 4.4e6) / 4.4e6 > 0.25:
            fail(f"estimate {est} is not within 25% of the 4.4 Mbp genome")
        print(f"[main] cli: estimate {est:.0f} bp, wall {wall:.1f} s, kernel launches {launches} "
              f"({gpu_line})", flush=True)

        # the same index and queries as the CLI run (same seed and split)
        strat = TwoSetStrategy(fq, target_num_reads=10_000, query_num_reads=5_000, seed=SEED, tmpdir=tmp)
        targets, queries, _ = strat.split_fastq()
        index = strat._build_engine(targets).index
        engine = device_engine.DeviceOverlapEngine(index, device=dev)
        planes = [v for v in vars(engine.gdev).values() if isinstance(v, torch.Tensor)]
        if not planes or any(p.device.type != "cuda" for p in planes):
            fail("index planes are not on the card")
        names = [n for n, _ in queries]
        seqs = [s for _, s in queries]
        engine.warmup([len(s) for s in seqs])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = engine.count_batch(names, seqs)
        t_map = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        sample = np.random.default_rng(0).choice(len(queries), size=300, replace=False)
        host = engine.host.count_overlaps_many([(names[i], seqs[i]) for i in sample])
        h_counts = np.array([c for c, _ in host])
        h_had = np.array([bool(h) for _, h in host])
        if not np.array_equal(res.counts[sample], h_counts):
            fail("device counts != host counts on the 300-query sample")
        if not np.array_equal(res.had_mapping[sample], h_had):
            fail("device had_mapping != host on the 300-query sample")
        print(f"[main] engine: {len(queries) / t_map:.1f} q/s ({t_map:.3f} s for {len(queries)} "
              f"queries), fallback_rows {res.fallback_rows}, fallback_triggers "
              f"{dict(engine.fallback_triggers)}, peak device memory {peak / 2**20:.1f} MiB, "
              f"HAVE_NATIVE {device_engine.native is not None} ({gpu_line})", flush=True)
        print("[main] 300 sampled query counts equal the host engine's", flush=True)
        return launches


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    from lrge_tpu_torch.ops import chain_kernel as ck

    gpu_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(gpu_line, flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    so = ck.build_library()
    ck._lib()
    print(f"[build] {so.name}: {time.perf_counter() - t0:.2f} s", flush=True)

    rec = kernel_vs_plain(ck, dev)
    launches = main_path(ck, dev, gpu_line)
    kernels = [{
        "name": "chain_dp_skip",
        "route": "cuda",
        "source": "lrge_tpu_torch/csrc/chain_dp.cu",
        "replaces": "lrge_tpu/ops/chain_pallas.py:274",
        "launches": launches,
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
