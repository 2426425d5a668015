"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--pb-ava-reads N]

Phases, in order; the first failure ends the run with a non-zero exit:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels (the chain DP's three variants from
   ``lrge_tpu_torch/csrc/chain_dp.cu`` and the PacBio/HPC query sketch
   from ``csrc/sketch_hpc.cu``, one library) and print each instance's
   registers, stack and spill (``-Xptxas -v``);
3. each variant against its plain PyTorch version on the card, at the
   main path's shapes ([512, 4096] and [1024, 2048] anchors, W = 32),
   on a colinear skip-break corpus (W = 64) and, once phase 4 (phase 8
   for the span variant) has built its index, on that path's own
   anchors (one super-batch of its fullest bucket through the port's
   sketch or host planes, lookup, expansion and sort; the main variant
   also on phase 9's, the first sub of its multi-sub index): ``f`` and
   ``broke``, for the extent variant also ``cnt``, ``start`` and
   ``rmf``, for the span variant (anchors with spans of 19-60, packed
   into ``qpos``) also ``cnt``, must be bit-equal (tolerance 0, integer
   outputs).  Each case prints its run-length distribution, the time of
   ``chain_dp_skip`` as the path calls it, the plain version's time and
   the bound; one run of 4,096 anchors alone gives the per-anchor step
   latency.  Then the sketch kernel against its plain version: a
   super-batch of the 16,384 bucket as the PacBio path runs it (128
   HiFi-like reads, the preset's k = 19, w = 5, HPC) and edge reads (N and
   IUPAC bytes, runs of N, homopolymer runs that span 256 bases, ``AT``
   repeats at even k, reads shorter than ``w + k - 1``, empty rows, more
   minimizers than the capacity) under six parameter sets; all four
   planes bit-equal, with the kernel's time, the plain version's and the
   bytes bound;
4. the main path: ``lrge_tpu_torch.cli.main`` on a synthetic 4.4 Mbp
   genome (15,000 reads, mean 2.5 kb, 5% errors, seed 6) at the
   published run shape ``-T 10000 -Q 5000``, with ``--engine auto``,
   which must resolve to the device and launch the kernel; then the
   device engine alone on the same index, timed, with 300 sampled query
   counts held against the exact host engine;
5. ``-F`` through the CLI on the same corpus and run shape (the extent
   variant must launch), then a timed ``-F`` pass of the phase-4 engine
   with 300 rows held against the host ``-F`` count;
6. ``--use-min-ref`` through the CLI on the same corpus (the inverse
   direction must engage), then the inverse engine alone: a timed
   pair-list pass and a ``-F`` pass (``"overhang"`` mode), 300 rows
   each held against the host;
7. ``-n 25000`` (all-vs-all at the reference's default) through the CLI
   on 26,000 reads from the same genome, then the all-vs-all engine
   alone: a timed pair-list pass, and a ``-F`` pass over the first
   5,000 reads of the subsample (its host recompute is ``map_read``),
   300 rows each held against the host;
8. the PacBio/HPC preset (``-P pb``) on phase 4's corpus and run shape
   through the CLI (its estimate must equal the host engine's), then a
   timed pass of its engine, a ``--use-min-ref`` pair-list pass, and an
   all-vs-all pair-list pass on the first 5,000 reads of phase 7's
   subsample (``--pb-ava-reads`` sets the count), 300 rows each held
   against the host; each pass must launch the sketch kernel once a
   super-batch (its graph replays);
9. accurate reads: 15,000 reads of phase 4's genome at mean 10 kb and
   1% substitutions (current ONT R10.4.1 or PacBio data), ``-T 10000
   -Q 5000`` through the CLI, then for ONT and for ``-P pb`` the index,
   whose expected anchors split it into sub-indexes (``n_sub`` must be
   2 or more), its planes' build time and size, and a timed engine
   pass whose variant must launch ``n_sub`` times a super-batch.  The
   ONT pass's rows must all equal the exact host engine's, and the
   estimate of those host counts must be the CLI's (``--engine host``
   through the CLI maps every query with ``map_read`` on threads, which
   takes minutes on these reads); the PacBio pass holds 300 rows to the
   host.  No ``-F`` pass: on a multi-sub index ``-F`` runs on the host,
   as in the reference;
10. the sharded engine and a multi-process run, on the one card: (a) an
   engine whose index is sharded in two by target, both shards on the
   card (``device=[cuda:0, cuda:0]``), over phase 4's index, phase 8's
   PacBio index and an all-vs-all index of the first 5,000 reads of
   phase 7's subsample, each pass through the engine's query and shard
   programs (one CUDA graph a shard, bucket and mode, captured by the
   pass's warm-up): every row's counts, had-mapping flags and pair
   sets must equal the single-device engine's, 300 rows the host's, and
   the variant must launch once a shard and super-batch (replays); then
   a same-call A/B of each pass, programmed against eager (the plain
   ``sharded_count``, in turns P E E P, every row equal), with the
   programs' capture seconds and one super-batch's ms both ways; (b) the CLI at
   phase 4's run shape in two processes joined over gloo (two ranks on
   one card: NCCL refuses a duplicate GPU), each holding one shard, the
   forward two-set path counting in lockstep: rank 0's estimate must be
   phase 4's, rank 1 must write nothing.  No NCCL collective runs: the
   machine has one card;
11. the library surface (``lrge_tpu_torch.twoset``/``ava``): the two-set
   doc example at phase 4's run shape with ``.engine("auto")`` must give
   phase 4's CLI estimate with as many ``BASE`` launches; the all-vs-all
   doc example on the first 5,000 reads of phase 7's corpus must give
   its ``.engine("host")`` result; phase 4's warm pass's per-pass record
   (``last_phases``, ``anchor_slot_occupancy`` = ``last_anchors_valid /
   last_anchor_slots``, the slots every super-batch's ``SUP x B x A``);
   and ``build_index(device="device")`` over phase 4's 10,000 targets
   must equal the native sketch's index (both walls printed, and the
   rows the device sketch left to the host);
12. the super-batch programs (``lrge_tpu_torch/ops/program.py``: one
   CUDA graph a bucket and mode, which every single-device pass above
   replays), on fresh engines over the indexes of phases 4, 8 and 9,
   one at a time: (a) for ONT plain, pairs and ``-F`` on phase 4's index,
   phase 9's multi-sub index and phase 8's PacBio index, the first two
   super-batches of the fullest bucket replayed one after the other,
   then each output held bit for bit to the eager function on the same
   inputs; (b) phase 4's stage 1 (every bucket's dispatch) under
   ``torch.cuda.set_sync_debug_mode("error")``: nothing may block the
   host; (c) each program's capture seconds, a replay's ms against the
   eager call's (CUDA events, mean of 20), the aten ops an eager call
   dispatches, ``super_batches`` host seconds alone, and phase 4's warm
   pass's ``last_phases``, q/s and peak MiB; (d) the sharded programs on
   fresh two-shard engines (both shards on the card) over phase 4's and
   phase 8's indexes: the first two super-batches of the fullest bucket
   through the query program and each shard's, each merged plane held
   bit for bit to the eager ``sharded_count``, each program's replay ms,
   and phase 10's ONT stage 1 under ``set_sync_debug_mode("error")``;
13. the port's benchmark (``lrge_tpu_torch/bench.py``, bench.py's
   corpus and engine shape at their defaults): its JSON line, with its
   tripwires (eager counts equal programmed ones, the heterogeneous
   counts the device-only ones, 200 sampled rows the host engine's) and
   ``BASE`` launched once a super-batch in each of its programmed,
   eager and heterogeneous passes; then the host-share sweep on its
   engine: ``LRGE_HOST_SHARE`` at 0, 0.1, 0.2, 0.3 and 0.5 in turns,
   three rounds, every pass's counts equal, with each share's median
   q/s and spread, host-share rows and host thread against device
   seconds, and ``r = s / (c (1 - s))`` for the best share ``s`` on
   ``c`` host cores.

Each CLI run runs with ``--engine auto``, must log the device engine,
and must launch the kernel variant of its path, and each engine pass
too (counts reset just before it, read just after).  A single-device
pass must launch its variant ``n_sub`` times a super-batch (its graph
replays), plus the eager run before each capture of a program first
used inside the pass; a run prints that split.  Each phase prints
its wall time.  The line before the last is the kernels' JSON record
(the main variant's also carries phase 9's case and CLI launches under
``multi_sub_path``, phase 11's library runs' under ``library_path``,
phase 13's under ``bench_path``, and
it and the span variant phase 10's engine launches under
``sharded_path``); the last line is ``{"ok": true,
"device": {...}}``.  Without CUDA it exits 1 and prints no result.

``python3 chip_smoke.py --rank-cli ARGS`` is one rank of phase 10's
multi-process run (the env contract names the rank).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SEED = 6
GENOME = 4_400_000  # bp of the synthetic genome
READS, T, Q = 15_000, 10_000, 5_000  # two-set corpus and run shape
AVA_READS, AVA_N = 26_000, 25_000  # all-vs-all corpus and -n
PB_AVA_READS = 5_000  # phase 8's all-vs-all rows (the first of phase 7's subsample)
AVA_FILTER_READS = 5_000  # phase 7's all-vs-all -F rows (the first of its subsample)
ACC_MEAN_LEN, ACC_ERR = 10_000, 0.01  # phase 9's reads: mean 10 kb, 1% substitutions
SHARDS = 2  # phase 10's shards, all on the one card
SHARD_AVA_READS = 5_000  # phase 10's all-vs-all rows (the first of phase 7's subsample)
AVA_LIB_READS = 5_000  # phase 11's all-vs-all library run: the first reads of phase 7's corpus
RANK_TIMEOUT = 600  # seconds a rank of phase 10's two-process run may take
SAMPLE = 300  # rows held against the host per pass
SHARES = (0.0, 0.1, 0.2, 0.3, 0.5)  # phase 13's host shares
SWEEP_ROUNDS = 3  # phase 13's passes a share
KW = dict(span=15, max_gap=5000, bw=500, max_skip=25)
PEN_GAP = 0.01 * 15  # the synthetic cases' gap penalty (the main path's is the preset's)
IMAX = np.iinfo(np.int32).max
# the chain DP's bound: integer/f32 operations per (anchor, in-run
# predecessor) pair, counted from the loop body of csrc/chain_dp.cu:
# deltas 5, the ok test 12, the score 25 (mg_log2 11), the marked vote 8,
# running max, improving and the skip step 11, the skip counter and cut
# 9, the best score and its position 5
OPS_PER_CANDIDATE = 75
PEAK_OPS = 67e12  # H100 SXM, float32 outside the tensor cores (op/s)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (B/s)
# each kernel variant's launch counter in ops/cuda_lib.py::LAUNCHES
COUNTERS = {"main": "launches", "ext": "ext_launches", "span": "span_launches", "sketch": "sketch_launches"}
# and its tag in the printed lines
TAGS = {"main": "kernel", "ext": "kernel ext", "span": "kernel span"}


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def anchor_rows(rng, B, A, *, colinear=False, n_rids=40, n_min=None, spans=False):
    """Rows of anchors sorted by (rid*2+strand, rpos), valid prefix per
    row of ``n_min`` (default ``A // 4``) to ``A - 1`` anchors; with
    ``spans``, ``qpos`` packs a span of 19-60 per anchor (``qpos << 8 |
    span``, the PacBio/HPC range)."""
    key2 = np.full((B, A), IMAX, np.int32)
    rpos = np.zeros((B, A), np.int32)
    qpos = np.zeros((B, A), np.int32)
    valid = np.zeros((B, A), np.int32)
    for b in range(B):
        n = int(rng.integers(A // 4 if n_min is None else n_min, A))
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
        if spans:
            qp = (qp << 8) | rng.integers(19, 61, n)
        key2[b, :n], rpos[b, :n], qpos[b, :n], valid[b, :n] = k, rp, qp, 1
    return key2, rpos, qpos, valid


def chain_bound(lens, B, A, W, n_out):
    """Least time (ms) the card could take for the chain DP on these
    inputs, and what binds it: operations (each anchor against its
    min(depth, W) in-run predecessors) at ``PEAK_OPS``, or bytes (four
    input planes over the valid anchors and ``nvalid`` read once,
    ``n_out`` [B, A] output planes written once) at ``PEAK_BYTES``."""
    n = lens.astype(np.int64)
    cand = np.where(n <= W + 1, n * (n - 1) // 2, W * (W + 1) // 2 + (n - 1 - W) * W).sum()
    t_ops = OPS_PER_CANDIDATE * cand / PEAK_OPS * 1e3
    t_bytes = (16 * n.sum() + 4 * B + 4 * n_out * B * A) / PEAK_BYTES * 1e3
    return (float(t_ops), "operations") if t_ops >= t_bytes else (float(t_bytes), "bytes")


def run_lengths(key2, nvalid):
    """The lengths of the kernel's runs, row-major: maximal slices of
    equal ``key2`` within each row's ``[0, nvalid)``."""
    k = key2.cpu().numpy()
    n = np.clip(nvalid.cpu().numpy(), 0, k.shape[1])
    starts = np.arange(k.shape[1])[None, :] < n[:, None]
    starts[:, 1:] &= k[:, 1:] != k[:, :-1]
    row, col = np.nonzero(starts)
    same_row = np.append(row[1:] == row[:-1], False)
    return np.where(same_row, np.append(col[1:], 0), n[row]) - col


def cuda_ms(fn, reps=20):
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events, after
    three warm-up calls)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_case(ck, tag, name, arrs, W, kw, pen_gap=PEN_GAP):
    """One phase-3 case: ``chain_dp_skip`` against its plain version on
    the same [B, A] inputs, bit for bit, with times, the run-length
    distribution and the bound.  Returns the case's record."""
    key2, rpos, qpos, valid = arrs
    B, A = key2.shape
    nvalid = valid.sum(dim=1).to(torch.int32)
    args = (key2, rpos, qpos, valid, nvalid, pen_gap)
    k_ms = cuda_ms(lambda: ck.chain_dp_skip(*args, window=W, **kw))
    got = ck.chain_dp_skip(*args, window=W, **kw)
    t0 = time.perf_counter()
    want = ck.chain_dp_skip_plain(*args, window=W, **kw)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3
    if len(got) != len(want):
        fail(f"chain kernel ({tag}) returned {len(got)} planes, its plain version {len(want)}")
    err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
    lens = run_lengths(key2, nvalid)
    bound_ms, bound_by = chain_bound(lens, B, A, W, len(got))
    extra = f", chains of > 1 anchor {int((want[2] > 1).sum())}" if len(want) > 2 else ""
    print(f"[{tag}] {name} [{B}, {A}] W={W}: runs {len(lens)} ({len(lens) / B:.1f} a row), run length "
          f"max {lens.max()} p99 {np.percentile(lens, 99):.0f} median {np.median(lens):.0f}; kernel "
          f"{k_ms:.4f} ms, plain {p_ms:.1f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}); max_abs_err {err}, broke anchors {int(want[1].sum())}{extra}", flush=True)
    if err:
        fail(f"chain kernel ({tag}) != plain version on {name}")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=err, max_run=int(lens.max()), broke=int(want[1].sum()))


def variant_of(mode) -> str:
    """The kernel variant that ``chain_dp_skip(**mode)`` launches."""
    return "ext" if mode.get("extents") else "span" if mode.get("spans") else "main"


def kernel_vs_plain(ck, dev, **mode):
    """Phase 3's synthetic cases for one variant (``mode``: ``extents`` or
    ``spans``, else the main one), and the per-anchor step latency (one
    run of 4,096 anchors alone, W = 32); returns ``{case: record}``."""
    # the break needs more than max_skip marked predecessors in view, so
    # the colinear corpus runs at W = 64
    cases = [("main_4096", 512, 4096, 32, False), ("main_2048", 1024, 2048, 32, False),
             ("colinear", 256, 1024, 64, True)]
    tag = TAGS[variant_of(mode)]
    kw = dict(KW, **mode)
    spans = bool(mode.get("spans"))
    recs = {}
    for name, B, A, W, colinear in cases:
        rng = np.random.default_rng(SEED + B)
        arrs = [torch.from_numpy(a).to(dev) for a in anchor_rows(rng, B, A, colinear=colinear, spans=spans)]
        recs[name] = kernel_case(ck, tag, name, arrs, W, kw)
        if colinear and not recs[name]["broke"]:
            fail("the colinear corpus must fire the skip break")
    rng = np.random.default_rng(SEED)
    arrs = [torch.from_numpy(a[:1]).to(dev)
            for a in anchor_rows(rng, 1, 4097, colinear=True, n_min=4096, spans=spans)]
    nvalid = arrs[3].sum(dim=1).to(torch.int32)
    step_ms = cuda_ms(lambda: ck.chain_dp_skip(*arrs, nvalid, PEN_GAP, window=32, **kw))
    recs["step_us"] = step_ms * 1e3 / int(nvalid[0])
    print(f"[{tag}] one run of {int(nvalid[0])} anchors alone, W=32: {step_ms:.4f} ms, "
          f"{recs['step_us']:.4f} us an anchor", flush=True)
    return recs


def sketch_case(tag, codes, lengths, params, M):
    """The sketch kernel against its plain version on the same ``[R, L]``
    codes on the card, all four planes bit for bit; the kernel's time
    (CUDA events, mean of 20), the plain version's (one call) and the
    bytes bound (codes and lengths read once, the planes written once).
    Returns the case's record."""
    from lrge_tpu_torch.ops.sketch_torch import sketch_hpc, sketch_hpc_plain

    R, L = codes.shape
    kw = dict(k=params[0], w=params[1], hpc=params[2], max_minimizers=M)
    k_ms = cuda_ms(lambda: sketch_hpc(codes, lengths, **kw))
    got = sketch_hpc(codes, lengths, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = sketch_hpc_plain(codes, lengths, **kw)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3
    bad = [name for name, g, w in zip(("qhi", "qlo", "mps", "mcount"), got, want) if not torch.equal(g, w)]
    bound_ms = (R * L + 4 * R + 3 * 4 * R * M + 4 * R) / PEAK_BYTES * 1e3
    mcount = want[3].cpu().numpy()
    print(f"[kernel sketch] {tag} [{R}, {L}] k={params[0]} w={params[1]} hpc={params[2]} M={M}: minimizers a row "
          f"median {np.median(mcount):.0f} max {mcount.max()} (rows above M {(mcount > M).sum()}); kernel "
          f"{k_ms:.4f} ms, plain {p_ms:.1f} ms, bound {bound_ms:.4f} ms (bytes); planes unequal {bad or 'none'}",
          flush=True)
    if bad:
        fail(f"sketch kernel != plain version on {tag}: {bad}")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by="bytes", max_abs_err=0)


def sketch_vs_plain(dev):
    """Phase 3's sketch cases (``ops/sketch_cases.py``): a super-batch of
    the 16,384 bucket (128 HiFi-like rows, the preset's parameters), then
    the edge reads under every parameter set at two capacities; returns
    ``{case: record}``."""
    from lrge_tpu_torch.ops.overlap import minimizer_cap
    from lrge_tpu_torch.ops.sketch_cases import HPC_PARAMS, hifi_reads, hpc_edge_reads, padded_codes

    put = lambda a: torch.from_numpy(a).to(dev)
    codes, lengths = padded_codes(hifi_reads(np.random.default_rng(SEED), 128, 16384 // 2 + 1, 16384 + 1), 16384)
    recs = {"main_path": sketch_case("hifi_16384", put(codes), put(lengths), HPC_PARAMS["pb"],
                                     minimizer_cap(16384))}
    codes, lengths = padded_codes(hpc_edge_reads(np.random.default_rng(SEED)), 2048)
    for name, params in HPC_PARAMS.items():
        for M in (64, minimizer_cap(2048)):
            recs[f"edge_{name}_{M}"] = sketch_case(f"edge {name}", put(codes), put(lengths), params, M)
    return recs


def main_path_case(ck, engine, names, seqs, recs, key="main_path", **mode):
    """Phase 3's fourth case: the chain DP's inputs of one super-batch of
    ``engine``'s path (the first of the bucket with most rows; on a
    multi-sub index its first sub) as the path builds them (the device
    sketch, ONT's or PacBio's), through the variant that
    ``mode`` names; adds ``key`` to ``recs`` and prints the
    critical-path floor (longest run x the step latency)."""
    from lrge_tpu_torch.ops.overlap import minimizer_cap, pb_anchors, sketch_anchors
    from lrge_tpu_torch.ops.sketch_torch import sketch_hpc

    _, _, bucket_rows = engine.plan_rows(seqs, range(len(seqs)))
    L = max(bucket_rows, key=lambda x: len(bucket_rows[x]))
    dual, selfr = engine.query_ranks(names)
    _, A, codes, lengths, ids, dual_b, selfr_b = next(engine.super_batches(L, bucket_rows[L], seqs, dual, selfr))
    put = lambda a: torch.from_numpy(a).to(engine.device)
    if engine.pb_mode:
        p = engine.params
        planes = sketch_hpc(put(codes).reshape(-1, L), put(lengths).reshape(-1), k=p.k, w=p.w, hpc=p.hpc,
                            max_minimizers=minimizer_cap(L))
        qhi, qlo, mps = (x.reshape(*ids.shape, -1) for x in planes[:3])
        key2, rpos, qpos, valid = pb_anchors(
            qhi, qlo, mps, put(lengths), put(dual_b), put(selfr_b), engine.gdev, engine.params, num_anchors=A,
        )
        name = "pacbio "
    else:
        key2, rpos, qpos, valid = sketch_anchors(
            put(codes), put(lengths), put(dual_b), put(selfr_b), engine.gdev, engine.params, num_anchors=A,
        )
        name = ""
    subs = f", sub 0 of {engine.gdev.n_sub}" if engine.gdev.n_sub > 1 else ""
    name += f"{key} (bucket L={L}{subs})"
    i32 = lambda x: x.to(torch.int32).contiguous()
    tag = TAGS[variant_of(mode)]
    p = engine.params
    kw = dict(span=p.k, max_gap=p.max_gap, bw=p.bw, max_skip=p.max_chain_skip, **mode)
    rec = kernel_case(ck, tag, name, [i32(x) for x in (key2, rpos, qpos, valid)], engine.window, kw,
                      pen_gap=p.chn_pen_gap())
    print(f"[{tag}] {key} critical-path floor: longest run {rec['max_run']} x "
          f"{recs['step_us']:.4f} us = {rec['max_run'] * recs['step_us'] / 1e3:.4f} ms", flush=True)
    recs[key] = rec


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


def write_corpus(path: Path, n_reads: int, genome_size: int = GENOME, mean_len: int = 2500,
                 err: float = 0.05) -> None:
    """A genome with a dispersed 2 kb five-copy family and a 400 bp x 5
    tandem block; reads at mean ``mean_len`` (gamma(3), clipped to 500 bp
    - 30 kb) and ``err`` substitutions."""
    rng = np.random.default_rng(SEED)
    genome = bytearray(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=genome_size, dtype=np.uint8)].tobytes())
    fam = bytes(genome[100_000:102_000])
    for c in range(5):
        pos = 500_000 + c * 700_000
        genome[pos : pos + 2_000] = fam
    unit = bytes(genome[200_000:200_400])
    genome[300_000:302_000] = unit * 5
    reads = make_reads(rng, bytes(genome), n_reads, mean_len, err)
    with open(path, "wb") as fh:
        for i, s in enumerate(reads):
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))


class _Records(logging.Handler):
    """Every record of a logger at ``level`` and above."""

    def __init__(self, level=logging.INFO):
        super().__init__(level)
        self.records = []

    def emit(self, record):
        self.records.append(record)

    @property
    def messages(self) -> list:
        return [r.getMessage() for r in self.records]


LOGGED = "Using device overlap engine on cuda"


def reset_counts():
    from lrge_tpu_torch.ops.cuda_lib import LAUNCHES
    from lrge_tpu_torch.ops.program import SuperBatchProgram

    for attr in COUNTERS.values():
        setattr(LAUNCHES, attr, 0)
    SuperBatchProgram.captures = 0
    SuperBatchProgram.warmup_launches = dict.fromkeys(COUNTERS.values(), 0)


def read_counts() -> dict:
    from lrge_tpu_torch.ops.cuda_lib import LAUNCHES

    return {v: getattr(LAUNCHES, attr) for v, attr in COUNTERS.items()}


def warmup_counts() -> tuple[int, dict]:
    """Programs captured since the counts were reset, and the launches by
    variant of the eager run before each capture (in :func:`read_counts`
    too: they ran on the card)."""
    from lrge_tpu_torch.ops.program import SuperBatchProgram

    warm = SuperBatchProgram.warmup_launches
    return SuperBatchProgram.captures, {v: warm[attr] for v, attr in COUNTERS.items()}


def launch_split(counts) -> str:
    captures, warm = warmup_counts()
    replays = {v: counts[v] - warm[v] for v in counts}
    return f"replays {replays} + eager runs before {captures} captures {warm}"


def run_cli(tag, args, out, gpu_line, *, needle="", variant="main", host_equal=False):
    """One CLI path with ``--engine auto``: every kernel count is set to 0
    just before it and read just after.  It must log the device engine
    (a line starting with ``LOGGED`` and holding ``needle``), launch its
    kernel ``variant``, and print a finite estimate within 25% of the
    genome, or with ``host_equal`` the estimate that the same command
    prints on the exact host engine (``-F``: the reference's filter
    drops most true overlaps, so its estimate is not the genome size).
    Returns the launches by variant."""
    from lrge_tpu_torch import cli

    records = _Records()
    lg = logging.getLogger("lrge")
    lg.addHandler(records)
    lg.setLevel(logging.INFO)
    reset_counts()
    t0 = time.perf_counter()
    try:
        rc = cli.main([*args, "-s", str(SEED), "-o", str(out)])
    finally:
        wall = time.perf_counter() - t0
        counts = read_counts()
        lg.removeHandler(records)
    if rc != 0:
        fail(f"[{tag}] cli.main returned {rc}")
    if not any(m.startswith(LOGGED) and needle in m for m in records.messages):
        fail(f"[{tag}] --engine auto did not resolve to the device engine")
    if counts[variant] <= 0:
        fail(f"[{tag}] the path never launched the chain kernel's {variant} variant")
    est = float(out.read_text())
    print(f"[{tag}] cli: estimate {est:.0f} bp, wall {wall:.1f} s, kernel launches by variant {counts} = "
          f"{launch_split(counts)} ({gpu_line})", flush=True)
    if not np.isfinite(est):
        fail(f"[{tag}] estimate {est} is not finite")
    if host_equal:
        host_out = out.with_suffix(".host")
        t0 = time.perf_counter()
        rc = cli.main([*args, "-s", str(SEED), "-o", str(host_out), "--engine", "host",
                       "-t", str(os.cpu_count() or 1), "-qqq"])
        if rc != 0 or host_out.read_text() != out.read_text():
            fail(f"[{tag}] device estimate {est} != the host engine's ({host_out.read_text().strip()})")
        print(f"[{tag}] the host engine prints the same estimate (host wall "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)
    elif abs(est - GENOME) / GENOME > 0.25:
        fail(f"[{tag}] estimate {est} is not within 25% of the {GENOME:,} bp genome")
    return counts


def timed_pass(tag, engine, names, seqs, pairs=False, **kw):
    """One warm ``count_batch`` pass, timed, with fresh fallback tallies;
    it must launch its path's kernel variant (extent under ``-F``, span
    under PacBio; every count set to 0 just before the pass, read just
    after).  Returns ``(result, pair dict or None, report, {"qps", "peak_mib"})``."""
    variant = "ext" if kw.get("filter_ratio") is not None else "span" if engine.pb_mode else "main"
    engine.fallback_triggers.clear()
    collected = {} if pairs else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = engine.count_batch(names, seqs, collect_pairs=collected, **kw)
    t = time.perf_counter() - t0
    counts = read_counts()
    if counts[variant] <= 0:
        fail(f"[{tag}] the pass never launched the chain kernel's {variant} variant")
    # one replay a super-batch, n_sub launches each (a sharded index: one
    # a shard), beside the eager runs before any capture inside the pass
    per = engine.gdev.n_sub if engine.sharded is None else len(engine.shards)
    want = per * super_batch_count(engine, seqs)
    if counts[variant] - warmup_counts()[1][variant] != want:
        fail(f"[{tag}] {counts} launches: {launch_split(counts)}, not {per} x super-batches = {want}")
    # the PacBio/HPC sketch: once a super-batch (a sharded index: in its query program)
    want = super_batch_count(engine, seqs) if engine.pb_mode else 0
    if counts["sketch"] - warmup_counts()[1]["sketch"] != want:
        fail(f"[{tag}] {counts} launches: {launch_split(counts)}, not {want} sketch launches")
    peak = torch.cuda.max_memory_allocated()
    # the graphs' private pools are reserved, not allocated, between replays
    reserved = torch.cuda.max_memory_reserved()
    report = (f"{len(seqs) / t:.1f} q/s ({t:.3f} s for {len(seqs)} rows), fallback_rows "
              f"{res.fallback_rows}, fallback_triggers {dict(engine.fallback_triggers)}, peak device "
              f"memory {peak / 2**20:.1f} MiB (reserved {reserved / 2**20:.1f} MiB), kernel launches by "
              f"variant {counts} = {launch_split(counts)}")
    return res, collected, report, dict(qps=len(seqs) / t, peak_mib=peak / 2**20, reserved_mib=reserved / 2**20)


def check_sample(tag, engine, names, seqs, res, pairs, filter_ratio=None, filter_mode="internal"):
    """``SAMPLE`` rows against the exact host engine: counts and
    had-mapping flags, and pair lists as rid sets (the host ``-F``
    count under ``filter_ratio``)."""
    sample = np.random.default_rng(0).choice(len(seqs), size=SAMPLE, replace=False)
    items = [(names[i], seqs[i]) for i in sample]
    if filter_ratio is not None:
        host = engine._host_count_filtered(items, filter_ratio, mode=filter_mode, want_pairs=pairs is not None)
    else:
        host = engine.host.count_overlaps_many(items, want_pairs=pairs is not None)
    for i, h in zip(sample, host):
        if res.counts[i] != h[0] or bool(res.had_mapping[i]) != bool(h[1]):
            fail(f"[{tag}] row {i}: device ({res.counts[i]}, {res.had_mapping[i]}) != host {h[:2]}")
        if pairs is not None:
            got, want = pairs.get(i), h[2]
            if (got is None) != (want is None) or (
                got is not None and set(got.tolist()) != set(want.tolist())
            ):
                fail(f"[{tag}] row {i}: device pair list != host")
    print(f"[{tag}] {SAMPLE} sampled rows equal the host engine's", flush=True)


def device_engine_on_card(index, dev):
    """The port's device engine over ``index``; fails unless its planes
    were built (``from_host`` logs why not) and all lie on the card."""
    from lrge_tpu_torch.device_engine import DeviceOverlapEngine

    engine = DeviceOverlapEngine(index, device=dev)
    if not engine.device_ok:
        fail("the device engine has no index planes (see the log)")
    planes = [v for v in vars(engine.gdev).values() if isinstance(v, torch.Tensor)]
    if not planes or any(p.device.type != "cuda" for p in planes):
        fail("index planes are not on the card")
    return engine


def twoset_paths(ck, dev, gpu_line, fq, recs, recs_ext):
    """Phases 4-6 on the 15,000-read corpus ``fq`` at ``-T 10000 -Q
    5000``, with phase 3's main-path case of both constant-span variants
    (into ``recs`` and ``recs_ext``) once the index is built; returns the
    CLI launch counts of the main path and of the ``-F`` path, and phase
    4's engine pass (index, queries, result) for phase 10."""
    from lrge_tpu_torch import device_engine
    from lrge_tpu_torch.strategy import TwoSetStrategy

    tmp = fq.parent
    shape = [str(fq), "-T", str(T), "-Q", str(Q)]
    launches = run_cli("main", shape, tmp / "est.txt", gpu_line)

    # the same index and queries as the CLI run (same seed and split)
    strat = TwoSetStrategy(fq, target_num_reads=T, query_num_reads=Q, seed=SEED, tmpdir=tmp / "ont")
    targets, queries, _ = strat.split_fastq()
    engine = device_engine_on_card(strat._build_engine(targets).index, dev)
    names = [n for n, _ in queries]
    seqs = [s for _, s in queries]
    main_path_case(ck, engine, names, seqs, recs)
    main_path_case(ck, engine, names, seqs, recs_ext, extents=True)
    engine.warmup([len(s) for s in seqs])
    res, _, report, stats = timed_pass("main", engine, names, seqs)
    record = dict(valid=engine.last_anchors_valid, slots=engine.last_anchor_slots,
                  phases=dict(engine.last_phases), want_slots=slot_count(engine, seqs), **stats)
    check_sample("main", engine, names, seqs, res, None)
    print(f"[main] engine: {report}, HAVE_NATIVE {device_engine.native is not None} ({gpu_line})", flush=True)
    single = dict(index=engine.index, names=names, seqs=seqs, res=res, record=record)

    # phase 5: -F on the same run shape
    ext_launches = run_cli(
        "filter", [*shape, "-F"], tmp / "est_f.txt", gpu_line, needle="with -F filtering", variant="ext",
        host_equal=True,
    )
    engine.warmup([len(s) for s in seqs], filter_ratio=0.2)
    res, _, report, _ = timed_pass("filter", engine, names, seqs, filter_ratio=0.2)
    check_sample("filter", engine, names, seqs, res, None, filter_ratio=0.2)
    print(f"[filter] engine: {report} ({gpu_line})", flush=True)

    # phase 6: --use-min-ref (index the queries, stream the targets)
    run_cli("inverse", [*shape, "--use-min-ref"], tmp / "est_i.txt", gpu_line, needle="for --use-min-ref")
    if not strat.target_num_bases > strat.query_num_bases:
        fail("the inverse direction must engage: target bases <= query bases")
    inv = device_engine_on_card(strat._build_engine(queries).index, dev)
    tnames = [n for n, _ in targets]
    tseqs = [s for _, s in targets]
    inv.warmup([len(s) for s in tseqs], want_pairs=True)
    res, pairs, report, _ = timed_pass("inverse", inv, tnames, tseqs, pairs=True)
    check_sample("inverse", inv, tnames, tseqs, res, pairs)
    print(f"[inverse] engine: {report} ({gpu_line})", flush=True)
    mode = dict(filter_ratio=0.2, filter_mode="overhang")
    inv.warmup([len(s) for s in tseqs], want_pairs=True, **mode)
    res, pairs, report, _ = timed_pass("inverse -F", inv, tnames, tseqs, pairs=True, **mode)
    check_sample("inverse -F", inv, tnames, tseqs, res, pairs, **mode)
    print(f"[inverse -F] engine: {report} ({gpu_line})", flush=True)
    return launches["main"], ext_launches["ext"], single


def ava_path(dev, gpu_line, fq):
    """Phase 7: ``-n 25000`` on the 26,000 reads of ``fq``, then the
    all-vs-all engine alone (pairs over the whole subsample, and pairs
    under ``-F`` over its first ``AVA_FILTER_READS`` reads, against the
    same index); returns the subsample."""
    from lrge_tpu_torch.strategy import AvaStrategy

    tmp = fq.parent
    run_cli("ava", [str(fq), "-n", str(AVA_N)], tmp / "est_ava.txt", gpu_line)
    strat = AvaStrategy(fq, num_reads=AVA_N, seed=SEED, tmpdir=tmp / "ava")
    reads, _ = strat.subsample_reads()
    names = [n for n, _ in reads]
    seqs = [s for _, s in reads]
    engine = device_engine_on_card(strat._build_engine(reads).index, dev)
    lens = [len(s) for s in seqs]
    engine.warmup(lens, want_pairs=True)
    res, pairs, report, _ = timed_pass("ava", engine, names, seqs, pairs=True)
    check_sample("ava", engine, names, seqs, res, pairs)
    print(f"[ava] engine: {report} ({gpu_line})", flush=True)
    # the -F host recompute is map_read in Python over every overflow
    # row (~70% of them): the pass streams the first AVA_FILTER_READS
    names, seqs = names[:AVA_FILTER_READS], seqs[:AVA_FILTER_READS]
    engine.warmup(lens[:AVA_FILTER_READS], filter_ratio=0.2, want_pairs=True)
    res, pairs, report, _ = timed_pass("ava -F", engine, names, seqs, pairs=True, filter_ratio=0.2)
    check_sample("ava -F", engine, names, seqs, res, pairs, filter_ratio=0.2)
    print(f"[ava -F] engine, first {len(seqs)} reads: {report} ({gpu_line})", flush=True)
    return reads


def pacbio_paths(ck, dev, gpu_line, fq, ava_reads, recs_span):
    """Phase 8: ``-P pb`` on phase 4's corpus ``fq`` and run shape through
    the CLI (estimate equal to the host engine's: with k = 19 and HPC,
    5% substitutions need not land within 25% of the genome), phase 3's
    main-path case of the span variant (into ``recs_span``), then the
    PacBio engine alone: a timed pass, a ``--use-min-ref`` pair-list
    pass, and an all-vs-all pair-list pass over ``ava_reads``; returns
    the CLI's span-variant and sketch launches and the two-set engine
    pass (index, queries, result) for phase 10."""
    from lrge_tpu_torch.platform import Platform, preset_for
    from lrge_tpu_torch.strategy import TwoSetStrategy
    from lrge_tpu_torch.strategy.twoset import build_engine_no_fork

    tmp = fq.parent
    shape = [str(fq), "-T", str(T), "-Q", str(Q), "-P", "pb"]
    launches = run_cli("pacbio", shape, tmp / "est_pb.txt", gpu_line, variant="span", host_equal=True)

    strat = TwoSetStrategy(
        fq, target_num_reads=T, query_num_reads=Q, seed=SEED, tmpdir=tmp / "pb", platform=Platform.PACBIO,
    )
    targets, queries, _ = strat.split_fastq()
    engine = device_engine_on_card(strat._build_engine(targets).index, dev)
    if not (engine.pb_mode and engine.gdev.wide):
        fail("-P pb must build the wide-key device index")
    names = [n for n, _ in queries]
    seqs = [s for _, s in queries]
    main_path_case(ck, engine, names, seqs, recs_span, spans=True)
    engine.warmup([len(s) for s in seqs])
    res, _, report, _ = timed_pass("pacbio", engine, names, seqs)
    check_sample("pacbio", engine, names, seqs, res, None)
    print(f"[pacbio] engine: {report} ({gpu_line})", flush=True)
    single = dict(index=engine.index, names=names, seqs=seqs, res=res)

    # --use-min-ref: index the queries, stream the targets with pair lists
    inv = device_engine_on_card(strat._build_engine(queries).index, dev)
    tnames = [n for n, _ in targets]
    tseqs = [s for _, s in targets]
    inv.warmup([len(s) for s in tseqs], want_pairs=True)
    res, pairs, report, _ = timed_pass("pacbio inverse", inv, tnames, tseqs, pairs=True)
    check_sample("pacbio inverse", inv, tnames, tseqs, res, pairs)
    print(f"[pacbio inverse] engine: {report} ({gpu_line})", flush=True)

    # all-vs-all on the first rows of phase 7's subsample
    names = [n for n, _ in ava_reads]
    seqs = [s for _, s in ava_reads]
    t0 = time.perf_counter()
    ava = device_engine_on_card(build_engine_no_fork(ava_reads, preset_for(Platform.PACBIO, dual=False)).index, dev)
    print(f"[pacbio ava] index and planes of {len(seqs)} reads: {time.perf_counter() - t0:.1f} s", flush=True)
    ava.warmup([len(s) for s in seqs], want_pairs=True)
    res, pairs, report, _ = timed_pass("pacbio ava", ava, names, seqs, pairs=True)
    check_sample("pacbio ava", ava, names, seqs, res, pairs)
    print(f"[pacbio ava] engine: {report} ({gpu_line})", flush=True)
    return launches["span"], launches["sketch"], single


def super_batch_count(engine, seqs) -> int:
    """The super-batches that one ``count_batch`` pass over ``seqs``
    dispatches (its row plan, batches of ``batch_size``, ``SUP`` batches
    a super-batch)."""
    _, _, bucket_rows = engine.plan_rows(seqs, range(len(seqs)))
    n = 0
    for L, rows in bucket_rows.items():
        batches = -(-len(rows) // engine.batch_size)
        n += -(-batches // engine.bucket_shape(L)[1])
    return n


def slot_count(engine, seqs) -> int:
    """The anchor slots that one ``count_batch`` pass over ``seqs``
    executes: each bucket's super-batches x ``SUP`` x ``B`` x ``A``."""
    _, _, bucket_rows = engine.plan_rows(seqs, range(len(seqs)))
    n = 0
    for L, rows in bucket_rows.items():
        A, SUP = engine.bucket_shape(L)
        batches = -(-len(rows) // engine.batch_size)
        n += -(-batches // SUP) * SUP * engine.batch_size * A
    return n


def check_all_and_estimate(tag, engine, names, seqs, res, avg_target_len, cli_out):
    """Every row against the exact host engine (native counts, threaded),
    then the estimate of those host counts (the two-set estimator: per-read
    estimates, finite ones, median) against the CLI's printed estimate.
    This stands in for ``--engine host`` through the CLI, whose
    ``map_read`` on threads (CUDA is live) takes minutes on these reads."""
    from lrge_tpu_torch.estimate import median, per_read_estimate_batch

    t0 = time.perf_counter()
    host = engine.host.count_overlaps_many(list(zip(names, seqs)))
    t_host = time.perf_counter() - t0
    counts = np.array([c for c, _ in host])
    bad = np.flatnonzero((res.counts != counts) | (res.had_mapping != np.array([bool(h) for _, h in host])))
    if len(bad):
        fail(f"[{tag}] {len(bad)} rows differ from the host engine, first {bad[0]}")
    est = per_read_estimate_batch(
        np.array([len(s) for s in seqs]), avg_target_len, T, counts, engine.params.min_chain_score,
    ).astype(np.float32)
    host_est = f"{median(est[np.isfinite(est)])[1]:.0f}\n"
    if cli_out.read_text() != host_est:
        fail(f"[{tag}] the CLI's estimate {cli_out.read_text().strip()} != the host counts' {host_est.strip()}")
    print(f"[{tag}] all {len(seqs)} rows equal the host engine's (native host counts {t_host:.1f} s); their "
          f"estimate {host_est.strip()} bp is the CLI's", flush=True)


def accurate_paths(ck, dev, gpu_line, fq, recs):
    """Phase 9 on the accurate-read corpus ``fq`` at ``-T 10000 -Q 5000``:
    the CLI with ``--engine auto``, then for ONT and for ``-P pb`` the
    index, its planes (timed; the index must need several sub-indexes),
    a timed engine pass whose variant must launch ``n_sub`` x the pass's
    super-batches, and the host check: under ONT every row, and the
    estimate of the host counts against the CLI's
    (:func:`check_all_and_estimate`), under ``-P pb`` 300 sampled rows.
    The ONT index also gives phase 3 its anchors (into ``recs``).
    Returns the CLI's launches of the main variant and the ONT index
    with its queries, for phase 12."""
    from lrge_tpu_torch.platform import Platform
    from lrge_tpu_torch.strategy import TwoSetStrategy

    tmp = fq.parent
    cli_out = tmp / "est.txt"
    launches = run_cli("accurate", [str(fq), "-T", str(T), "-Q", str(Q)], cli_out, gpu_line)
    for platform, tag, variant in ((Platform.NANOPORE, "accurate", "main"),
                                   (Platform.PACBIO, "accurate pacbio", "span")):
        strat = TwoSetStrategy(fq, target_num_reads=T, query_num_reads=Q, seed=SEED,
                               tmpdir=tmp / tag.replace(" ", "_"), platform=platform)
        targets, queries, avg_target_len = strat.split_fastq()
        t0 = time.perf_counter()
        index = strat._build_engine(targets).index
        t_index = time.perf_counter() - t0
        t0 = time.perf_counter()
        engine = device_engine_on_card(index, dev)
        torch.cuda.synchronize()
        t_planes = time.perf_counter() - t0
        n_sub = engine.gdev.n_sub
        mib = sum(v.nbytes for v in vars(engine.gdev).values() if isinstance(v, torch.Tensor)) / 2**20
        print(f"[{tag}] index of {len(targets)} targets ({len(index.keys):,} postings) {t_index:.1f} s; "
              f"n_sub {n_sub}; planes build {t_planes:.2f} s, {mib:.1f} MiB on the card ({gpu_line})", flush=True)
        if n_sub < 2:
            fail(f"[{tag}] the accurate-read index must need several sub-indexes, got n_sub {n_sub}")
        names = [n for n, _ in queries]
        seqs = [s for _, s in queries]
        if variant == "main":
            main_path_case(ck, engine, names, seqs, recs, key="accurate_path")
        engine.warmup([len(s) for s in seqs])
        res, _, report, _ = timed_pass(tag, engine, names, seqs)
        n = read_counts()[variant] - warmup_counts()[1][variant]
        sb = super_batch_count(engine, seqs)
        print(f"[{tag}] engine: {report} ({gpu_line})", flush=True)
        if n != n_sub * sb:
            fail(f"[{tag}] {n} {variant} replay launches, not n_sub {n_sub} x {sb} super-batches")
        print(f"[{tag}] {variant} replay launches {n} = n_sub {n_sub} x {sb} super-batches", flush=True)
        if variant == "main":
            check_all_and_estimate(tag, engine, names, seqs, res, avg_target_len, cli_out)
            multi = dict(index=index, names=names, seqs=seqs)
        else:
            check_sample(tag, engine, names, seqs, res, None)
    return launches["main"], multi


def sharded_engine_on_card(tag, index, dev, gpu_line):
    """The port's device engine over ``index`` sharded in ``SHARDS`` by
    target, every shard on the card ``dev``; prints its planes' build time
    and size a shard."""
    from lrge_tpu_torch.device_engine import DeviceOverlapEngine

    t0 = time.perf_counter()
    engine = DeviceOverlapEngine(index, device=[dev] * SHARDS)
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    if engine.sharded is None or len(engine.shards) != SHARDS:
        fail(f"[{tag}] the engine did not shard its index in {SHARDS}")
    mib = []
    for gi in engine.shards:
        planes = [v for v in vars(gi).values() if isinstance(v, torch.Tensor)]
        if any(p.device.type != "cuda" for p in planes):
            fail(f"[{tag}] shard planes are not on the card")
        mib.append(sum(p.nbytes for p in planes) / 2**20)
    print(f"[{tag}] {SHARDS} shards on {dev}: planes build {t:.2f} s, "
          f"{', '.join(f'{m:.1f}' for m in mib)} MiB a shard ({gpu_line})", flush=True)
    return engine


def check_rows_equal(tag, res, want, pairs=None, want_pairs=None):
    """Every row of a sharded pass against the single-device pass: counts,
    had-mapping flags and, with ``pairs``, pair sets (as rid sets: the two
    lay their pair planes out differently)."""
    bad = np.flatnonzero((res.counts != want.counts) | (res.had_mapping != want.had_mapping))
    if len(bad):
        fail(f"[{tag}] {len(bad)} rows differ from the single-device engine, first {bad[0]}")
    if pairs is not None:
        if pairs.keys() != want_pairs.keys():
            fail(f"[{tag}] the rows with pair lists differ from the single-device engine's")
        for i, rids in pairs.items():
            if set(rids.tolist()) != set(want_pairs[i].tolist()):
                fail(f"[{tag}] row {i}: pair set != the single-device engine's")
    print(f"[{tag}] all {len(res.counts)} rows equal the single-device engine's"
          f"{' (pair sets too)' if pairs is not None else ''}", flush=True)


def eager_sharded_run(engine):
    """The plain version of ``engine.sharded_run``: the query side as eager
    calls (the ONT ``sketch_core``, or the PacBio ``sketch_hpc``) and every
    shard through the eager ``sharded_count``, as the engine ran them
    before its programs."""
    from lrge_tpu_torch.ops.overlap import minimizer_cap
    from lrge_tpu_torch.ops.sketch_torch import sketch_core, sketch_hpc
    from lrge_tpu_torch.parallel import sharded_count

    def run(L, A, arrays, want_pairs=False):
        p = engine.params
        SUP, B = arrays[-1].shape
        R = SUP * B
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(engine.device).reshape(R, *a.shape[2:])
        lengths, dual, selfr = (put(a) for a in arrays[-3:])
        if engine.pb_mode:
            q0, q1, mps, mcount = sketch_hpc(put(arrays[0]), lengths, k=p.k, w=p.w, hpc=p.hpc,
                                             max_minimizers=minimizer_cap(L))
        else:
            mhash, mpos, mstrand, mcount = sketch_core(
                put(arrays[0]), lengths, k=p.k, w=p.w, max_minimizers=minimizer_cap(L)
            )
            q0, q1, mps = mhash, torch.zeros((R, 1), dtype=torch.int64, device=engine.device), mpos * 2 + mstrand
        counts, n_anchors, max_run, pairs = sharded_count(
            engine.shards, q0, q1, mps, lengths, dual, selfr, p, num_anchors=A, window=engine.window,
            want_pairs=want_pairs,
        )
        packed = torch.stack([counts, n_anchors, max_run, mcount.long()], dim=-1).reshape(SUP, B, 4)
        return packed.to(torch.int32), None if pairs is None else pairs.reshape(SUP, B, -1).to(torch.int32)

    return run


def first_super_batches(engine, names, seqs, n=2):
    """``(L, [(A, program arrays), ...])``: the first ``n`` super-batches of
    the fullest bucket of one pass over ``seqs``."""
    _, _, bucket_rows = engine.plan_rows(seqs, range(len(seqs)))
    L = max(bucket_rows, key=lambda x: len(bucket_rows[x]))
    dual, selfr = engine.query_ranks(names)
    out = []
    for _, A, codes, lengths, ids, d, sr in engine.super_batches(L, bucket_rows[L], seqs, dual, selfr):
        out.append((A, engine.program_arrays(codes, lengths, d, sr)))
        if len(out) == n:
            break
    return L, out


def sharded_pass(tag, engine, names, seqs, gpu_line, want, pairs=False, want_pairs=None):
    """One warm pass of a sharded engine through its programs: timed, its
    variant launched once a shard and super-batch (replays), every row
    held to the single-device pass ``want``, 300 rows to the host; then
    the same-call A/B against the plain version, in turns P E E P (the
    pass above is the first P), every row equal, with the programs'
    capture seconds and one super-batch's ms both ways (CUDA events, the
    first super-batch of the fullest bucket).  Returns the launches."""
    variant = "span" if engine.pb_mode else "main"
    engine.warmup([len(s) for s in seqs], want_pairs=pairs)
    captures = {f"{k.branch}{'' if k.shard is None else k.shard} L={k.L}": round(p.capture_s, 3)
                for k, p in engine.programs.items()}
    res, collected, report, rec = timed_pass(tag, engine, names, seqs, pairs=pairs)
    n, sb = read_counts()[variant], super_batch_count(engine, seqs)
    print(f"[{tag}] engine: {report} ({gpu_line})", flush=True)
    if n != SHARDS * sb or warmup_counts()[0]:
        fail(f"[{tag}] {n} {variant} launches, not {SHARDS} shards x {sb} super-batches of replays")
    print(f"[{tag}] {variant} launches {n} = {SHARDS} shards x {sb} super-batches", flush=True)
    check_rows_equal(tag, res, want, collected, want_pairs)
    check_sample(tag, engine, names, seqs, res, collected)
    qps = {"programmed": [rec["qps"]], "eager": []}
    for kind in ("eager", "eager", "programmed"):
        if kind == "eager":
            engine.sharded_run = eager_sharded_run(engine)
        try:
            r, got_pairs, _, rec = timed_pass(f"{tag} {kind}", engine, names, seqs, pairs=pairs)
        finally:
            vars(engine).pop("sharded_run", None)
        bad = np.flatnonzero((r.counts != res.counts) | (r.had_mapping != res.had_mapping))
        if len(bad) or (pairs and (got_pairs.keys() != collected.keys() or any(
                set(v.tolist()) != set(collected[i].tolist()) for i, v in got_pairs.items()))):
            fail(f"[{tag}] the {kind} A/B pass differs from the programmed pass")
        qps[kind].append(rec["qps"])
    L, ((A, arrays),) = first_super_batches(engine, names, seqs, n=1)
    prog_ms = cuda_ms(lambda: engine.sharded_run(L, A, arrays, want_pairs=pairs))
    eager_ms = cuda_ms(lambda: eager_sharded_run(engine)(L, A, arrays, want_pairs=pairs))
    print(f"[{tag}] A/B in one call, P E E P, every row equal: programmed (CUDA graphs) "
          f"{', '.join(f'{x:.1f}' for x in qps['programmed'])} q/s, eager (plain sharded_count) "
          f"{', '.join(f'{x:.1f}' for x in qps['eager'])} q/s; capture s {json.dumps(captures)}; one super-batch "
          f"of bucket L={L} (A={A}, {arrays[-1].size} rows): programmed {prog_ms:.4f} ms, eager {eager_ms:.4f} ms "
          f"({gpu_line})", flush=True)
    return n


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_cli(args) -> int:
    """One rank of phase 10's two-process run: join the process group that
    the env contract describes over gloo (two ranks on one card), run the
    CLI, print this rank's kernel launches on standard error, leave the
    group."""
    from lrge_tpu_torch import cli
    from lrge_tpu_torch.parallel.distributed import init_from_env

    init_from_env(backend="gloo")
    try:
        return cli.main(args)
    finally:
        print("rank launches " + json.dumps(read_counts()), file=sys.stderr, flush=True)
        torch.distributed.destroy_process_group()


def two_process_cli(fq, want_out, gpu_line):
    """Phase 10 (b): the CLI at phase 4's run shape in two processes on the
    card, joined over gloo; the forward two-set path must count in
    lockstep on a two-shard index, rank 0 must print phase 4's estimate
    (``want_out``) and rank 1 nothing."""
    tmp = fq.parent
    port = free_port()
    args = [str(fq), "-T", str(T), "-Q", str(Q), "-s", str(SEED), "-v"]
    procs, outs = [], []
    t0 = time.perf_counter()
    for pid in range(2):
        out = tmp / f"est_rank{pid}.txt"
        outs.append(out)
        env = dict(os.environ, LRGE_COORDINATOR=f"localhost:{port}", LRGE_NUM_PROCESSES="2",
                   LRGE_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank-cli", *args, "-o", str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    logs = []
    try:
        for pid, p in enumerate(procs):
            stdout, err = p.communicate(timeout=RANK_TIMEOUT)
            logs.append(err)
            if p.returncode != 0:
                fail(f"[ranks] rank {pid} exited {p.returncode}: {err[-2000:]}")
            if stdout.strip():
                fail(f"[ranks] rank {pid} printed to standard output: {stdout[-200:]}")
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    for pid, log in enumerate(logs):
        needles = ("sharded over 2 devices (2x1)", "lockstep count: process", "Using device overlap engine on cuda")
        for needle in needles:
            if needle not in log:
                fail(f"[ranks] rank {pid} did not log {needle!r}")
        lines = [ln for ln in log.splitlines() if "lockstep count" in ln or ln.startswith("rank launches")]
        print(f"[ranks] rank {pid}: " + "; ".join(ln.split("] ")[-1] for ln in lines), flush=True)
    if not outs[0].exists() or outs[0].read_text() != want_out.read_text():
        fail(f"[ranks] rank 0's estimate != phase 4's ({want_out.read_text().strip()})")
    if outs[1].exists():
        fail("[ranks] rank 1 wrote an estimate")
    print(f"[ranks] two processes over gloo on one card: rank 0's estimate {outs[0].read_text().strip()} bp "
          f"is phase 4's, rank 1 wrote nothing; wall {wall:.1f} s ({gpu_line})", flush=True)


def sharded_paths(dev, gpu_line, fq, ont, pb, ava_reads):
    """Phase 10: (a) the sharded engine on the card over phase 4's index
    (``ont``), phase 8's PacBio index (``pb``) and an all-vs-all index of
    ``ava_reads``, each pass held row for row to the single-device engine;
    (b) the two-process CLI (:func:`two_process_cli`).  Returns the
    sharded engine passes' launches by variant."""
    from lrge_tpu_torch.platform import Platform, preset_for
    from lrge_tpu_torch.strategy.twoset import build_engine_no_fork

    launches = {"main": 0, "span": 0}
    for tag, single in (("sharded", ont), ("sharded pacbio", pb)):
        engine = sharded_engine_on_card(tag, single["index"], dev, gpu_line)
        launches["span" if engine.pb_mode else "main"] += sharded_pass(
            tag, engine, single["names"], single["seqs"], gpu_line, single["res"]
        )
        del engine
    names = [n for n, _ in ava_reads]
    seqs = [s for _, s in ava_reads]
    index = build_engine_no_fork(ava_reads, preset_for(Platform.NANOPORE, dual=False)).index
    one = device_engine_on_card(index, dev)
    one.warmup([len(s) for s in seqs], want_pairs=True)
    want, want_pairs, report, _ = timed_pass("sharded ava, one device", one, names, seqs, pairs=True)
    print(f"[sharded ava] single-device engine, first {len(seqs)} reads: {report} ({gpu_line})", flush=True)
    engine = sharded_engine_on_card("sharded ava", index, dev, gpu_line)
    launches["main"] += sharded_pass("sharded ava", engine, names, seqs, gpu_line, want, True, want_pairs)
    del engine, one
    two_process_cli(fq, fq.parent / "est.txt", gpu_line)
    return launches


def library_run(tag, configured, fq, gpu_line, device=True):
    """One run of the library's doc example (``configured.build(fq).estimate(True,
    LOWER_QUANTILE, UPPER_QUANTILE)``), every kernel count set to 0 just
    before it and read just after; with ``device`` it must log the device
    engine and launch ``BASE``.  Returns ``(result, launches by variant)``."""
    from lrge_tpu_torch import LOWER_QUANTILE, UPPER_QUANTILE

    records = _Records()
    lg = logging.getLogger("lrge")
    lg.addHandler(records)
    lg.setLevel(logging.INFO)
    reset_counts()
    t0 = time.perf_counter()
    try:
        result = configured.build(fq).estimate(True, LOWER_QUANTILE, UPPER_QUANTILE)
    finally:
        wall = time.perf_counter() - t0
        counts = read_counts()
        lg.removeHandler(records)
    engaged = any(m.startswith(LOGGED) for m in records.messages)
    if device and not (engaged and counts["main"] > 0):
        fail(f"[{tag}] the library run did not run the device engine and launch BASE")
    if result.estimate is None or not np.isfinite(result.estimate):
        fail(f"[{tag}] no finite estimate: {result.estimate}")
    print(f"[{tag}] estimate {result.estimate:.0f} bp (IQR {result.lower:.0f} - {result.upper:.0f}), no mapping "
          f"{result.no_mapping_count}, wall {wall:.1f} s, kernel launches by variant {counts} ({gpu_line})",
          flush=True)
    return result, counts


def library_paths(dev, gpu_line, fq, fq_ava, cli_launches, record):
    """Phase 11, the library surface on the card: (a) the two-set doc
    example at phase 4's run shape must print phase 4's CLI estimate with
    as many ``BASE`` launches; (b) the all-vs-all doc example on the first
    ``AVA_LIB_READS`` reads of phase 7's corpus must give its host
    engine's result; (c) phase 4's warm pass's per-pass record
    (``record``); (d) ``build_index(device="device")`` over phase 4's
    targets on ``dev`` must equal the native (``"auto"``) index.  Returns the
    library runs' ``BASE`` launches."""
    from lrge_tpu_torch import ava, twoset
    from lrge_tpu_torch.ops.index import build_index
    from lrge_tpu_torch.platform import Platform, preset_for
    from lrge_tpu_torch.strategy import TwoSetStrategy

    tmp = fq.parent / "library"
    tmp.mkdir()
    # (a) two-set: the CLI's estimate and launches
    configured = (twoset.Builder().target_num_reads(T).query_num_reads(Q).seed(SEED).threads(8)
                  .engine("auto").tmpdir(tmp / "twoset"))
    result, counts = library_run("library twoset", configured, fq, gpu_line)
    cli_out = (fq.parent / "est.txt").read_text()
    if f"{result.estimate:.0f}\n" != cli_out:
        fail(f"[library twoset] estimate {result.estimate:.0f} != phase 4's CLI estimate {cli_out.strip()}")
    if counts["main"] != cli_launches:
        fail(f"[library twoset] {counts['main']} BASE launches, phase 4's CLI {cli_launches}")
    print(f"[library twoset] the estimate and the {counts['main']} BASE launches are phase 4's CLI's", flush=True)
    launches = {"twoset": counts["main"]}

    # (b) all-vs-all on the first reads of phase 7's corpus, then its host engine
    fq_lib = tmp / "ava_reads.fq"
    with open(fq_ava, "rb") as src, open(fq_lib, "wb") as dst:
        for _ in range(4 * AVA_LIB_READS):
            dst.write(src.readline())
    ava_run = lambda engine: (ava.Builder().num_reads(AVA_LIB_READS).seed(SEED).threads(8).engine(engine)
                               .tmpdir(tmp / f"ava_{engine}"))
    result, counts = library_run("library ava", ava_run("auto"), fq_lib, gpu_line)
    host, _ = library_run("library ava, host engine", ava_run("host"), fq_lib, gpu_line, device=False)
    fields = lambda r: (r.estimate, r.lower, r.upper, r.no_mapping_count)
    if fields(result) != fields(host):
        fail(f"[library ava] device result {fields(result)} != the host engine's {fields(host)}")
    print(f"[library ava] equals the host engine's result on {AVA_LIB_READS} reads", flush=True)
    launches["ava"] = counts["main"]

    # (c) the engine's per-pass record of phase 4's warm pass
    valid, slots = record["valid"], record["slots"]
    print(f"[record] phase 4's warm pass: last_phases "
          f"{json.dumps({k: round(v, 6) for k, v in record['phases'].items()})}, anchors valid {valid:,} of "
          f"{slots:,} slots, anchor_slot_occupancy {valid / slots:.6f} ({gpu_line})", flush=True)
    if not 0 < valid <= slots or slots != record["want_slots"]:
        fail(f"[record] anchors valid {valid}, slots {slots}: want 0 < valid <= slots = {record['want_slots']}")
    if not {"prep", "enqueue", "collect", "retry"} <= set(record["phases"]):
        fail(f"[record] last_phases lacks the reference's keys: {sorted(record['phases'])}")

    # (d) the device sketch of phase 4's targets against the native sketch
    strat = TwoSetStrategy(fq, target_num_reads=T, query_num_reads=Q, seed=SEED, tmpdir=tmp / "index")
    targets, _, _ = strat.split_fastq()
    seqs, names = [s for _, s in targets], [n for n, _ in targets]
    params = preset_for(Platform.NANOPORE, dual=True)
    walls, indexes = {}, {}
    messages = _Records(logging.DEBUG)
    lg = logging.getLogger("lrge")
    level = lg.level
    lg.addHandler(messages)
    lg.setLevel(logging.DEBUG)
    try:
        for device in ("auto", "device"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            indexes[device] = build_index(seqs, names, params, device=device, torch_device=dev)
            torch.cuda.synchronize()
            walls[device] = time.perf_counter() - t0
    finally:
        lg.removeHandler(messages)
        lg.setLevel(level)
    sketched = [r.args for r in messages.records if r.getMessage().startswith(f"device sketch on {dev}")]
    if len(sketched) != 1:
        fail("[device sketch] build_index(device='device') did not sketch on the card")
    for f in ("keys", "rid", "pos", "strand", "lengths", "name_rank"):
        if not np.array_equal(getattr(indexes["device"], f), getattr(indexes["auto"], f)):
            fail(f"[device sketch] the device index's {f} != the native index's")
    if indexes["device"].mid_occ != indexes["auto"].mid_occ:
        fail("[device sketch] the device index's mid_occ != the native index's")
    print(f"[device sketch] index of {len(seqs)} targets ({len(indexes['auto'].keys):,} postings) equals the "
          f"native one: device sketch {walls['device']:.3f} s ({sketched[0][1]} rows sketched on the host), "
          f"native 8-thread sketch {walls['auto']:.3f} s ({gpu_line})", flush=True)
    return launches


def aten_ops(fn) -> int:
    """The aten ops that ``fn()`` dispatches (the chain DP's ctypes
    launches are not among them)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as count:
        fn()
    return count.n


def replay_case(tag, engine, names, seqs, mode, dev, gpu_line):
    """Phase 12 (a), one program: the first two super-batches of the
    fullest bucket replayed one after the other, then each output held
    bit for bit to the eager function on the same inputs; prints capture
    seconds, replay against eager ms and the aten ops of an eager call."""
    L, batches = first_super_batches(engine, names, seqs)
    runs = []
    for A, arrays in batches:
        prog = engine.program(L, A, arrays[-1].shape[0], **mode)
        runs.append((arrays, prog.run(*arrays)))
    if len(runs) < 2 or prog.graph is None:
        fail(f"[graphs] {tag}: want two replayed super-batches of bucket {L}, got {len(runs)}")
    for i, (arrays, got) in enumerate(runs):
        inputs = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
        want = prog.fn(*inputs)
        for what, g, w in zip(("plane", "pair plane"), got, want):
            if (g is None) != (w is None) or (g is not None and not torch.equal(g, w)):
                fail(f"[graphs] {tag}: super-batch {i}'s replayed {what} != the eager function's")
    if torch.equal(runs[0][1][0], runs[1][1][0]):
        fail(f"[graphs] {tag}: the two super-batches gave equal planes")
    # the static inputs hold the second super-batch, as do ``inputs``
    replay_ms = cuda_ms(prog.graph.replay)
    eager_ms = cuda_ms(lambda: prog.fn(*inputs))
    pairs = " and pair planes" if mode.get("want_pairs") else ""
    print(f"[graphs] {tag}: bucket L={L}, {prog.key.SUP} x {prog.key.B} rows, A={prog.key.A}, n_sub "
          f"{engine.gdev.n_sub}: 2 super-batches replayed, planes{pairs} bit-equal to the eager function; "
          f"capture {prog.capture_s:.3f} s, replay {replay_ms:.4f} ms, eager {eager_ms:.4f} ms, "
          f"{aten_ops(lambda: prog.fn(*inputs))} aten ops an eager call ({gpu_line})", flush=True)


def program_tag(key) -> str:
    return f"{key.branch}{'' if key.shard is None else key.shard}"


def print_captures(tag, engine):
    caps = {f"{program_tag(k)} L={k.L} pairs={k.want_pairs} -F={k.filter_mode}": round(p.capture_s, 3)
            for k, p in engine.programs.items()}
    print(f"[graphs] {tag} engine: {len(caps)} programs, capture s {json.dumps(caps)}", flush=True)


def stage1_without_sync(tag, engine, names, seqs):
    """Phase 12 (b): stage 1 of a warm pass (every bucket's dispatch) under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing may block the
    host, and no program may be captured in it."""
    _, _, bucket_rows = engine.plan_rows(seqs, range(len(seqs)))
    bucket_rows = {L: rows for L, rows in bucket_rows.items() if rows}
    dual, selfr = engine.query_ranks(names)
    mode = dict(want_pairs=False, want_extents=False, overhang_ratio=0.2, filter_mode="internal")
    programs = dict(engine.programs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    try:
        inflight = [x for L, rows in bucket_rows.items() for x in engine._dispatch(L, rows, seqs, dual, selfr, **mode)]
    except RuntimeError as err:
        fail(f"[graphs] {tag}'s stage 1 blocked the host: {err}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    t_enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    if engine.programs != programs:
        fail(f"[graphs] {tag}'s stage 1 captured a program: its warm-up did not")
    print(f"[graphs] {tag}'s stage 1 under set_sync_debug_mode('error'): {len(inflight)} super-batches over "
          f"buckets {sorted(bucket_rows)}, no blocking call, enqueued in {t_enqueue:.6f} s", flush=True)
    return bucket_rows, dual, selfr


def sharded_replay_case(tag, single, dev, gpu_line, stage1=False):
    """Phase 12 (d): a fresh engine over ``single``'s index sharded in two,
    both shards on the card, warmed up; the first two super-batches of
    the fullest bucket through the query program and each shard's, one
    after the other, then each merged plane held bit for bit to the plain
    version (:func:`eager_sharded_run`) on the same arrays; each
    program's capture s and replay ms, and the ms and aten ops of an eager
    super-batch; with ``stage1`` the pass's stage 1 without a sync."""
    from lrge_tpu_torch.device_engine import DeviceOverlapEngine

    names, seqs = single["names"], single["seqs"]
    engine = DeviceOverlapEngine(single["index"], device=[dev] * SHARDS)
    engine.warmup([len(s) for s in seqs])
    L, batches = first_super_batches(engine, names, seqs)
    if len(batches) < 2:
        fail(f"[graphs] {tag}: want two super-batches of bucket {L}, got {len(batches)}")
    runs = [engine.sharded_run(L, A, arrays) for A, arrays in batches]
    plain = eager_sharded_run(engine)
    for i, ((A, arrays), (got, _)) in enumerate(zip(batches, runs)):
        if not torch.equal(got, plain(L, A, arrays)[0]):
            fail(f"[graphs] {tag}: super-batch {i}'s programmed plane != the eager sharded_count's")
    if torch.equal(runs[0][0], runs[1][0]):
        fail(f"[graphs] {tag}: the two super-batches gave equal planes")
    A, arrays = batches[1]
    query, shards = engine.shard_programs(L, A, *arrays[-1].shape)
    if any(p.graph is None for p in (query, *shards)):
        fail(f"[graphs] {tag}: a program is not a CUDA graph")
    # the static inputs hold the second super-batch
    replay = {program_tag(p.key): round(cuda_ms(p.graph.replay), 4) for p in (query, *shards)}
    capture = {program_tag(p.key): round(p.capture_s, 3) for p in (query, *shards)}
    prog_ms = cuda_ms(lambda: engine.sharded_run(L, A, arrays))
    eager_ms = cuda_ms(lambda: plain(L, A, arrays))
    print(f"[graphs] {tag}: bucket L={L}, {query.key.SUP} x {query.key.B} rows, A={A}, {SHARDS} shards on "
          f"{dev}: 2 super-batches through the query program and {len(shards)} shard programs, merged planes "
          f"bit-equal to the eager sharded_count; capture s {json.dumps(capture)}, replay ms {json.dumps(replay)}; "
          f"a super-batch (copies, replays, merge) {prog_ms:.4f} ms, eager {eager_ms:.4f} ms, "
          f"{aten_ops(lambda: plain(L, A, arrays))} aten ops an eager super-batch ({gpu_line})", flush=True)
    if stage1:
        stage1_without_sync(f"{tag} (phase 10's ONT pass)", engine, names, seqs)


def graph_paths(dev, gpu_line, ont, pb, multi):
    """Phase 12, the super-batch programs on the card, over fresh engines
    on the host indexes of phases 4 (``ont``), 8 (``pb``) and 9
    (``multi``, the multi-sub ONT index), one at a time: (a) five programs
    (:func:`replay_case`: ONT plain, pairs and ``-F`` on phase 4's index,
    multi-sub, PacBio); (b) phase 4's stage 1, after its warm-up, under
    ``torch.cuda.set_sync_debug_mode("error")``; (c) ``super_batches``
    host seconds, each program's capture seconds and phase 4's warm pass
    record; (d) the sharded programs over phases 4's and 8's indexes
    (:func:`sharded_replay_case`)."""
    t0 = time.perf_counter()
    engine = device_engine_on_card(ont["index"], dev)
    names, seqs = ont["names"], ont["seqs"]
    t_planes = time.perf_counter() - t0
    engine.warmup([len(s) for s in seqs])
    print(f"[graphs] phase 4's index: planes {t_planes:.2f} s, warm-up (capture of the pass's programs) "
          f"{time.perf_counter() - t0 - t_planes:.2f} s", flush=True)
    for tag, mode in (("ont", {}), ("ont pairs", dict(want_pairs=True)),
                      ("ont -F", dict(want_extents=True, overhang_ratio=0.2, filter_mode="internal"))):
        replay_case(tag, engine, names, seqs, mode, dev, gpu_line)

    # (b) stage 1 of phase 4's pass: every bucket's dispatch, no blocking call
    bucket_rows, dual, selfr = stage1_without_sync("phase 4", engine, names, seqs)

    # (c) host batching alone, the programs' capture seconds, phase 4's pass
    t0 = time.perf_counter()
    batches = [(L, sb) for L, rows in bucket_rows.items() for sb in engine.super_batches(L, rows, seqs, dual, selfr)]
    t_sb = time.perf_counter() - t0
    for L, (_, _, codes, lengths, ids, d, sr) in batches:
        engine.program_arrays(codes, lengths, d, sr)
    t_arrays = time.perf_counter() - t0 - t_sb
    print(f"[graphs] phase 4's host batching: super_batches {t_sb:.6f} s for {len(batches)} super-batches, "
          f"program_arrays (2-bit pack) {t_arrays:.6f} s", flush=True)
    print_captures("ont", engine)
    del engine
    for tag, single in (("multi-sub", multi), ("pacbio", pb)):
        engine = device_engine_on_card(single["index"], dev)
        replay_case(tag, engine, single["names"], single["seqs"], {}, dev, gpu_line)
        print_captures(tag, engine)
        del engine
    # (d) the sharded programs
    sharded_replay_case("sharded", ont, dev, gpu_line, stage1=True)
    sharded_replay_case("sharded pacbio", pb, dev, gpu_line)
    rec = ont["record"]
    print(f"[graphs] phase 4's warm pass: {rec['qps']:.1f} q/s, peak {rec['peak_mib']:.1f} MiB (reserved "
          f"{rec['reserved_mib']:.1f} MiB), last_phases "
          f"{json.dumps({k: round(v, 6) for k, v in rec['phases'].items()})} ({gpu_line})", flush=True)


def bench_paths(dev, gpu_line):
    """Phase 13: the port's benchmark (``lrge_tpu_torch/bench.py``) at its
    default size on the card, then the host-share sweep on its engine.
    The bench's tripwires hold (eager counts equal programmed ones, the
    heterogeneous counts the device-only ones, 200 sampled rows the host
    engine's); each of its three schedules (programmed device-only, eager
    device-only, heterogeneous) launches ``BASE`` once a super-batch (no
    capture inside a pass).  The sweep runs the heterogeneous pass at
    every share of ``SHARES``, in turns (forward, backward, forward), and
    prints per share the median q/s and its spread, the host-share rows,
    and the host thread's seconds against the device's (``enqueue`` +
    ``collect``); every pass's counts must equal the device-only ones.
    Returns the bench's ``BASE`` launches (counts set to 0 just before
    it, read just after) and by schedule."""
    from lrge_tpu_torch import bench

    reset_counts()
    t0 = time.perf_counter()
    run = bench.run(dev)
    wall = time.perf_counter() - t0
    counts = read_counts()
    rec, ex = run.record, run.record["extra"]
    print(f"[bench] {json.dumps(rec)}", flush=True)
    engine, names, seqs = run.engine, run.corpus.qnames, run.corpus.queries
    if engine.device != dev or not engine.graphs:
        fail("[bench] the bench did not run the programmed engine on the card")
    with bench.host_share("0"):
        want_dev = super_batch_count(engine, seqs)
    with bench.host_share(None):
        want_het = super_batch_count(engine, seqs)
    by_schedule = {"programmed": ex["device_only_chain_dp_launches"], "eager": ex["ab_eager_chain_dp_launches"],
                   "heterogeneous": ex["chain_dp_launches"]}
    want = {"programmed": want_dev, "eager": want_dev, "heterogeneous": want_het}
    if by_schedule != want or counts["main"] <= 0:
        fail(f"[bench] BASE launches by schedule {by_schedule}, want one a super-batch {want}; all {counts}")
    print(f"[bench] wall {wall:.1f} s; BASE launches {counts['main']} in all, one a super-batch in each pass "
          f"{json.dumps(by_schedule)} ({gpu_line})", flush=True)

    # the host-share sweep on the same engine
    passes = {s: [] for s in SHARES}
    for rnd in range(SWEEP_ROUNDS):
        for s in SHARES if rnd % 2 == 0 else SHARES[::-1]:
            with bench.host_share(str(s)):
                ps = bench.timed_pass(engine, names, seqs)
            if not np.array_equal(ps.result.counts, run.counts):
                fail(f"[sweep] share {s}: counts != the device-only counts")
            passes[s].append(ps)
    medians = {}
    for s, ps in passes.items():
        qps = [len(seqs) / p.seconds for p in ps]
        medians[s] = float(np.median(qps))
        host_s = [p.host_s for p in ps]
        dev_s = [p.phases["enqueue"] + p.phases["collect"] for p in ps]
        print(f"[sweep] LRGE_HOST_SHARE={s}: median {medians[s]:.1f} q/s, spread {max(qps) - min(qps):.1f} "
              f"(passes {', '.join(f'{q:.1f}' for q in qps)}), host-share rows "
              f"{ps[0].triggers.get('host_share', 0)}, host thread s {', '.join(f'{x:.4f}' for x in host_s)} "
              f"against device s {', '.join(f'{x:.4f}' for x in dev_s)} ({gpu_line})", flush=True)
    best = max(SHARES, key=medians.get)
    c = os.cpu_count() or 2
    print(f"[sweep] best share {best} on {c} host cores: r = s / (c (1 - s)) = {best / (c * (1 - best)):.6f}; "
          f"the engine's r {ex['host_share_ratio']} ({gpu_line})", flush=True)
    return dict(launches=counts["main"], **by_schedule)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pb-ava-reads", type=int, default=PB_AVA_READS,
                    help="phase 8's all-vs-all rows, the first of phase 7's subsample (default %(default)s)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    from lrge_tpu_torch.ops import chain_kernel as ck
    from lrge_tpu_torch.ops import cuda_lib

    gpu_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(gpu_line, flush=True)
    dev = torch.device("cuda", 0)
    t_run = t0 = time.perf_counter()

    def phase_done(what):
        nonlocal t0
        print(f"[wall] {what}: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()

    so = cuda_lib.build_library()
    cuda_lib.load()
    print(f"[build] {so.name}: {time.perf_counter() - t0:.2f} s", flush=True)
    for line in cuda_lib.ptxas_report(so):
        print(f"[build] {line}", flush=True)
    phase_done("phase 2, build")

    recs = kernel_vs_plain(ck, dev)
    recs_ext = kernel_vs_plain(ck, dev, extents=True)
    recs_span = kernel_vs_plain(ck, dev, spans=True)
    recs_sketch = sketch_vs_plain(dev)
    phase_done("phase 3, synthetic cases")
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        fq, fq_ava, fq_acc = (Path(tmp) / d / "reads.fq" for d in ("", "ava", "accurate"))
        fq_ava.parent.mkdir()
        fq_acc.parent.mkdir()
        write_corpus(fq, READS)
        write_corpus(fq_ava, AVA_READS)
        write_corpus(fq_acc, READS, mean_len=ACC_MEAN_LEN, err=ACC_ERR)
        phase_done("corpora")
        launches, ext_launches, ont_single = twoset_paths(ck, dev, gpu_line, fq, recs, recs_ext)
        phase_done("phases 4-6, two-set ONT")
        ava_reads = ava_path(dev, gpu_line, fq_ava)
        phase_done("phase 7, all-vs-all ONT")
        span_launches, pb_sketch_launches, pb_single = pacbio_paths(
            ck, dev, gpu_line, fq, ava_reads[: args.pb_ava_reads], recs_span
        )
        phase_done("phase 8, PacBio")
        acc_launches, acc_multi = accurate_paths(ck, dev, gpu_line, fq_acc, recs)
        phase_done("phase 9, accurate reads, multi-sub")
        sharded_launches = sharded_paths(dev, gpu_line, fq, ont_single, pb_single, ava_reads[:SHARD_AVA_READS])
        phase_done("phase 10, sharded engine and two processes")
        lib_launches = library_paths(dev, gpu_line, fq, fq_ava, launches, ont_single["record"])
        phase_done("phase 11, library surface")
        graph_paths(dev, gpu_line, ont_single, pb_single, acc_multi)
        phase_done("phase 12, super-batch programs")
        del ont_single, pb_single, acc_multi
        bench_launches = bench_paths(dev, gpu_line)
        phase_done("phase 13, bench and host-share sweep")
    print(f"[wall] whole run: {time.perf_counter() - t_run:.1f} s", flush=True)

    def timing(m):
        return {k: m[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}

    def record(name, r, n):
        # times and bound on the path's own anchors; the largest error
        # over every phase-3 case
        return {
            "name": name, "route": "cuda", "source": "lrge_tpu_torch/csrc/chain_dp.cu",
            "replaces": "lrge_tpu/ops/chain_pallas.py:274", "launches": n,
            "max_abs_err": max(c["max_abs_err"] for k, c in r.items() if k != "step_us"),
            **timing(r["main_path"]), "library_ms": None,
        }

    kernels = [dict(record("chain_dp_skip", recs, launches),
                    multi_sub_path=dict(launches=acc_launches, **timing(recs["accurate_path"])),
                    sharded_path=dict(launches=sharded_launches["main"], shards=SHARDS),
                    library_path=lib_launches, bench_path=bench_launches),
               dict(record("chain_dp_skip_ext", recs_ext, ext_launches),
                    also_replaces="lrge_tpu/ops/overlap_jax.py:661-788"),
               dict(record("chain_dp_skip_span", recs_span, span_launches),
                    also_replaces="lrge_tpu/ops/overlap_jax.py:624-788 (with_spans)",
                    sharded_path=dict(launches=sharded_launches["span"], shards=SHARDS)),
               dict(name="sketch_hpc", route="cuda", source="lrge_tpu_torch/csrc/sketch_hpc.cu",
                    replaces="none (lrge_tpu/device_engine.py:377-393 sketches on the host)",
                    launches=pb_sketch_launches, max_abs_err=0, **timing(recs_sketch["main_path"]),
                    library_ms=None)]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(rank_cli(sys.argv[2:]) if sys.argv[1:2] == ["--rank-cli"] else main())
