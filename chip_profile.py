"""Where the device time of the main path's ``count_batch`` goes, on one NVIDIA GPU.

    python3 chip_profile.py [-P {ont,pb}] [--accurate]

Builds ``chip_smoke.py``'s phase-4 configuration (the synthetic 4.4 Mbp
genome, 15,000 reads, seed 6, two-set ``-T 10000 -Q 5000``; with ``-P
pb`` its phase-8 PacBio/HPC run on the same corpus; with
``--accurate`` phase 9's reads, mean 10 kb at 1% substitutions, whose
index splits into sub-indexes), warms the device engine up, times three
warm ``count_batch`` passes over the 5,000 queries with the host clock,
then runs one more pass under ``torch.profiler`` and prints the wall of
that pass, the device time by kernel (the top 15, and the chain DP's
own kernels), the device's idle share (1 - summed kernel time / wall)
and the chain DP's launches in the pass.  Each super-batch is one
replay of its bucket's CUDA graph (``lrge_tpu_torch/ops/program.py``):
the script also times each bucket's replay with CUDA events (mean of
20) and prints the replays' device time over the pass; if the profiler
attributes no kernel inside the replays it says so, and the idle share
comes from those replay times instead.  Under ``-P pb`` the kernels
listed include the query sketch's (``sketch_hpc_kernel``, once a
super-batch inside the replays).  On a multi-sub index it also times, on the
first super-batch of the fullest bucket, the shared lookup and each
sub's map alone (host clock around a synchronised call, mean of 3).
Without CUDA it exits 1.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

import chip_smoke as cs


def device_us(evt) -> float:
    """An event's own device time (µs), across torch versions."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def sub_costs(engine, names, seqs) -> None:
    """The shared lookup and each sub's map alone, on the first
    super-batch of the fullest bucket: ms of a synchronised call, mean of
    3 after one warm-up."""
    from lrge_tpu_torch.ops.overlap import (
        map_found_many, minimizer_cap, pb_lookup_many, sketch_lookup_many,
    )
    from lrge_tpu_torch.ops.sketch_torch import sketch_hpc

    _, _, bucket_rows = engine.plan_rows(seqs, range(len(seqs)))
    L = max(bucket_rows, key=lambda x: len(bucket_rows[x]))
    dual, selfr = engine.query_ranks(names)
    _, A, codes, lengths, ids, dual_b, selfr_b = next(engine.super_batches(L, bucket_rows[L], seqs, dual, selfr))
    put = lambda a: torch.from_numpy(a).to(engine.device)
    gd, p = engine.gdev, engine.params
    if engine.pb_mode:
        planes = sketch_hpc(put(codes).reshape(-1, L), put(lengths).reshape(-1), k=p.k, w=p.w, hpc=p.hpc,
                            max_minimizers=minimizer_cap(L))
        qhi, qlo, mps = (x.reshape(*ids.shape, -1) for x in planes[:3])
        lookup = lambda: (pb_lookup_many(qhi, qlo, gd, hash_bits=2 * p.k, q_occ_frac=p.q_occ_frac), mps)
    else:
        codes_d, lengths_d = put(codes), put(lengths)
        lookup = lambda: sketch_lookup_many(codes_d, lengths_d, gd, p)[:2]

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 3 * 1e3, out

    t, (found, mps) = ms(lookup)
    live = put(ids >= 0)
    print(f"[profile] bucket L={L}, [{ids.size}, {A}] anchors a sub: shared lookup {t:.3f} ms", flush=True)
    args = [put(a) for a in (lengths, dual_b, selfr_b)]
    for s in range(gd.n_sub):
        t, out = ms(lambda: map_found_many(
            found, mps, *args, gd, p, num_anchors=A, window=engine.window, with_spans=engine.pb_mode, sub=s,
        ))
        over = int(((out[1] > A) & live).sum())
        print(f"[profile] sub {s} map: {t:.3f} ms, rows over A {over} of {int(live.sum())}", flush=True)


def replay_ms(engine, seqs) -> float:
    """Device time (ms) of one pass's graph replays: each bucket's replay
    timed with CUDA events (mean of 20), times its super-batches."""
    _, _, bucket_rows = engine.plan_rows(seqs, range(len(seqs)))
    total = 0.0
    for L, rows in bucket_rows.items():
        if not rows:
            continue
        A, SUP = engine.bucket_shape(L)
        prog = engine.program(L, A, SUP)
        n = -(-len(rows) // (engine.batch_size * SUP))
        ms = cs.cuda_ms(prog.graph.replay)
        total += n * ms
        print(f"[profile] bucket L={L}: {n} super-batches x replay {ms:.4f} ms (capture {prog.capture_s:.3f} s)",
              flush=True)
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-P", "--platform", choices=("ont", "pb"), default="ont",
                    help="the preset of the profiled run (default %(default)s)")
    ap.add_argument("--accurate", action="store_true",
                    help="phase 9's corpus: mean 10 kb, 1%% substitutions, a multi-sub index")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lrge_tpu_torch import device_engine
    from lrge_tpu_torch.ops.cuda_lib import LAUNCHES
    from lrge_tpu_torch.platform import Platform
    from lrge_tpu_torch.strategy import TwoSetStrategy

    platform = Platform.PACBIO if args.platform == "pb" else Platform.NANOPORE
    counter = cs.COUNTERS["span" if platform == Platform.PACBIO else "main"]

    gpu_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(gpu_line, flush=True)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="chip_profile-") as tmp:
        tmp = Path(tmp)
        fq = tmp / "reads.fq"
        if args.accurate:
            cs.write_corpus(fq, cs.READS, mean_len=cs.ACC_MEAN_LEN, err=cs.ACC_ERR)
        else:
            cs.write_corpus(fq, cs.READS)
        strat = TwoSetStrategy(fq, target_num_reads=cs.T, query_num_reads=cs.Q, seed=cs.SEED, tmpdir=tmp,
                               platform=platform)
        targets, queries, _ = strat.split_fastq()
        engine = device_engine.DeviceOverlapEngine(strat._build_engine(targets).index, device=dev)
        names = [n for n, _ in queries]
        seqs = [s for _, s in queries]
        print(f"[profile] n_sub {engine.gdev.n_sub}", flush=True)
        engine.warmup([len(s) for s in seqs])
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.count_batch(names, seqs)
            t = time.perf_counter() - t0
            phases = {k: round(v, 6) for k, v in engine.last_phases.items()}
            print(f"[profile] warm pass {i}: {t:.4f} s, {len(seqs) / t:.1f} q/s, last_phases {phases}", flush=True)
        if engine.gdev.n_sub > 1:
            sub_costs(engine, names, seqs)
        setattr(LAUNCHES, counter, 0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.count_batch(names, seqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = getattr(LAUNCHES, counter)
        replays = replay_ms(engine, seqs)
    # device-side events only (the kernels), so no time counts twice
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    kernels.sort(key=device_us, reverse=True)
    busy = sum(device_us(e) for e in kernels) / 1e3
    attributed = any("chain_dp_kernel" in e.key for e in kernels)
    if launches and not attributed:
        print("[profile] torch.profiler attributed no kernel inside the graph replays: the idle share below is "
              "from the replays' CUDA-event times", flush=True)
        busy = replays
    print(f"[profile] profiled pass: wall {wall * 1e3:.1f} ms, device kernels {busy:.1f} ms, "
          f"idle {100 * (1 - busy / (wall * 1e3)):.1f}%, chain kernel launches {launches}; graph replays by "
          f"CUDA events {replays:.1f} ms ({gpu_line})")
    # the top 15, and the hand-written kernels wherever they rank
    for i, e in enumerate(kernels):
        if i < 15 or any(k in e.key for k in ("chain_dp_kernel", "find_runs_kernel", "sketch_hpc_kernel")):
            ms = device_us(e) / 1e3
            print(f"[profile] {ms:9.3f} ms {100 * ms / busy:5.1f}% {e.count:6d}x  {e.key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
