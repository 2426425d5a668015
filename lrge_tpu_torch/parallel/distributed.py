"""Multi-process runtime: ``torch.distributed`` set-up and lockstep counting.

Port of ``lrge_tpu/parallel/distributed.py``.  Every process runs the
same CLI on the same input: subsampling is seeded, so every process
draws the same target/query split and builds the same host index; the
device copy of the index is sharded, with data = processes and index =
each process's local devices (one process per host), shard ``p * n +
i`` on process ``p``'s device ``i``.  Process ``p`` sketches,
dispatches and recomputes on the host only its contiguous slice of the
queries.  Every process runs the same number of dispatches (one small
all_gather agrees the per-bucket depth; short processes send empty
blocks), and in each dispatch the query block and its accumulators
ride a ring over the processes, one int32 plane a hop, replaying every
local shard's program (``ops/program.py``) at each hop, until they are
home again.  The ring's hops and the merge run outside the programs.
Every block's outputs stay on the card until the last dispatch, then
each block is triaged (the reference's distributed.py:244-255).  One
last all_gather of the packed ``[2, width]`` count/had plane gives
every process the global counts; rank 0 alone writes the result
(``cli.py``).

Env contract, all three or none (``init_from_env``):

* ``LRGE_COORDINATOR``: ``host:port`` of process 0
* ``LRGE_NUM_PROCESSES``: world size
* ``LRGE_PROCESS_ID``: this process's rank

Gloo's point-to-point ops and collectives take CPU tensors: on a gloo
group the planes go through host memory (pinned when they come from a
card), so every ring hop copies its plane to the host and waits for the
card there (:func:`_staged`); on NCCL a hop waits on the card's stream
alone.  Two ranks on one card must use gloo: NCCL refuses a duplicate
GPU.
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from ..ops.encode import encode_seq
from ..ops.overlap import minimizer_cap
from ..spans import pass_record, span
from .sharded import on_device, sharded_count_programs

logger = logging.getLogger("lrge")

_ENV = ("LRGE_COORDINATOR", "LRGE_NUM_PROCESSES", "LRGE_PROCESS_ID")


def init_from_env(backend: str | None = None) -> bool:
    """Join the process group that the env contract describes; True when
    this process is part of a multi-process run.  ``backend`` defaults
    to NCCL when CUDA is available, else gloo.  Initialises no CUDA
    context (the host index build may still fork)."""
    if not os.environ.get("LRGE_COORDINATOR"):
        return False
    if dist.is_initialized():
        return True
    missing = [v for v in _ENV if not os.environ.get(v)]
    if missing:
        raise ValueError(f"multi-process run: LRGE_COORDINATOR is set but {', '.join(missing)} is not")
    nproc = int(os.environ["LRGE_NUM_PROCESSES"])
    pid = int(os.environ["LRGE_PROCESS_ID"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{os.environ['LRGE_COORDINATOR']}", world_size=nproc, rank=pid
    )
    logger.info("distributed runtime: process %d/%d (%s)", pid, nproc, backend)
    return True


def is_multihost() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def process_slice(n: int, pid: int, nproc: int) -> tuple[int, int]:
    """Contiguous [start, end) of rows owned by process ``pid``."""
    base, rem = divmod(n, nproc)
    start = pid * base + min(pid, rem)
    return start, start + base + (1 if pid < rem else 0)


def _staged(x: torch.Tensor) -> torch.Tensor:
    """The tensor to communicate: on a gloo group a host copy (pinned when
    ``x`` lies on a card; the copy waits for the card), else ``x``
    itself."""
    if dist.get_backend() != "gloo" or x.device.type == "cpu":
        return x
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host


def all_gather(a: np.ndarray) -> np.ndarray:
    """Every process's ``a`` (same shape and dtype), stacked by rank."""
    if dist.get_backend() == "gloo":
        t = torch.from_numpy(np.ascontiguousarray(a))
    else:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(torch.device("cuda", torch.cuda.current_device()))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return np.stack([o.cpu().numpy() for o in out])


def ring_shift(x: torch.Tensor) -> torch.Tensor:
    """Send ``x`` to the next rank and return what the previous rank sent
    (the reference's ppermute ``i -> i + 1``), on ``x``'s device."""
    nproc, pid = dist.get_world_size(), dist.get_rank()
    send = _staged(x.contiguous())
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, (pid + 1) % nproc), dist.P2POp(dist.irecv, recv, (pid - 1) % nproc)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device, non_blocking=True)


def ring_count(programs, q0, q1, mps, keep, qlen, qdual, qself):
    """Counts of this process's block of ``[b]`` query rows against every
    shard of every process: the block and its accumulators ride the ring
    for one full turn, replaying this process's shard ``programs`` at
    each hop (:func:`~lrge_tpu_torch.parallel.sharded.
    sharded_count_programs`), and come home.  The block is the query
    program's int32 planes (``q1`` None under narrow keys); the riding
    state is one int32 plane a hop, ``[b, 3M + 6]`` (wide keys: ``[b,
    4M + 6]``), built and split outside the programs.  Returns ``(counts,
    n_anchors, max_run)`` on the block's device, without waiting for
    it."""
    wide = q1 is not None
    with on_device(q0.device):
        counts, n_anchors, max_run = (torch.zeros(q0.shape[0], dtype=torch.int64, device=q0.device) for _ in range(3))
        for _hop in range(dist.get_world_size()):
            c, a, r, _ = sharded_count_programs(programs, q0, q1, mps, keep, qlen, qdual, qself)
            counts, n_anchors, max_run = counts + c, torch.maximum(n_anchors, a), torch.maximum(max_run, r)
            planes = [q0, *([q1] if wide else []), mps, keep]
            cols = [*planes, *(x[:, None].to(torch.int32) for x in (qlen, qdual, qself, counts, n_anchors, max_run))]
            state = torch.split(ring_shift(torch.cat(cols, dim=1)), [x.shape[1] for x in cols], dim=1)
            planes, scalars = state[: len(planes)], [x[:, 0] for x in state[len(planes) :]]
            q0, q1, mps, keep = planes if wide else (planes[0], None, *planes[1:])
            qlen, qdual, qself = scalars[:3]
            counts, n_anchors, max_run = (x.long() for x in scalars[3:])
        return counts, n_anchors, max_run


def multihost_count_batch(dev, names: list, seqs: list):
    """Count overlaps for ALL queries across processes in lockstep.

    ``dev`` is a :class:`~lrge_tpu_torch.device_engine.DeviceOverlapEngine`
    whose shards span the processes (``dev.lockstep``).  Every process
    passes the full query list, identical on every process; each one
    sketches, dispatches and recomputes on the host only its own slice
    (:func:`process_slice`), planned as ``count_batch`` plans
    (``plan_rows``: long-tail and sparse rows and the host share to the
    host, the rest by length bucket), one block of ``batch_size /
    nproc`` rows a dispatch: the engine's query program, then the ring
    over its shard programs (:func:`ring_count`; every bucket's programs
    are captured before the first dispatch, so no capture, which waits
    for the card, stalls the ring).  Every block stays in flight on the
    card until the last dispatch; the triage follows.  Returns a
    ``BatchCounts`` with the global counts, the same on every process.
    The call is one pass record of ``lrge_tpu_torch.spans``, a
    ``count_batch`` span tagged ``lockstep``."""
    with pass_record(), span("count_batch", lockstep=True) as call:
        res = _lockstep_count(dev, names, seqs)
    logger.debug(
        "lockstep count: process %d/%d, %d rows in %.3f s, %d recounted on the host",
        dist.get_rank(), dist.get_world_size(), len(seqs), call.duration, res.fallback_rows,
    )
    return res


def _lockstep_count(dev, names: list, seqs: list):
    from ..device_engine import BatchCounts

    if not dev.lockstep:
        raise ValueError("multihost_count_batch needs an engine sharded across the processes")
    nproc, pid = dist.get_world_size(), dist.get_rank()
    n = len(seqs)
    counts = np.zeros(n, dtype=np.int32)
    had = np.zeros(n, dtype=bool)
    if dev.batch_size % nproc:
        raise ValueError(f"batch size {dev.batch_size} must divide by the {nproc} processes")
    b_loc = dev.batch_size // nproc
    slices = [process_slice(n, q, nproc) for q in range(nproc)]
    s, e = slices[pid]
    long_rows, host_share_rows, bucket_rows = dev.plan_rows(seqs, range(s, e))
    buckets = list(dev.length_buckets)
    # lockstep: one all_gather agrees each bucket's dispatch depth;
    # short processes pad with empty blocks
    my_disp = np.array([-(-len(bucket_rows.get(L, ())) // b_loc) for L in buckets], dtype=np.int64)
    n_disp = all_gather(my_disp).max(axis=0)
    logger.debug(
        "lockstep count: process %d/%d, rows [%d, %d), %d dispatches of %d rows, %d ring hops each",
        pid, nproc, s, e, int(n_disp.sum()), b_loc, nproc,
    )
    with span("programs") as ready:
        for bi, L in enumerate(buckets):
            if n_disp[bi]:
                dev.shard_programs(L, dev.bucket_shape(L)[0], 1, b_loc)
    logger.debug(
        "lockstep count: process %d/%d, every bucket's programs ready in %.3f s, before the first dispatch",
        pid, nproc, ready.duration,
    )
    # the long tail and the host share run on the host meanwhile
    host_rows_all = long_rows + host_share_rows
    pool = ThreadPoolExecutor(1) if host_rows_all else None
    host_future = (
        pool.submit(dev._host_count_many, [(names[i], seqs[i]) for i in host_rows_all]) if pool else None
    )
    try:
        qdualrank, qselfrid = dev.query_ranks(names)
        inflight = []
        for bi, L in enumerate(buckets):
            A = dev.bucket_shape(L)[0]
            rows_b = bucket_rows.get(L, [])
            for d in range(int(n_disp[bi])):
                block = rows_b[d * b_loc : (d + 1) * b_loc]
                ids = np.full((1, b_loc), -1, dtype=np.int64)
                ids[0, : len(block)] = block
                live = ids >= 0
                lengths = np.array([[len(seqs[i]) if i >= 0 else 0 for i in ids[0]]], dtype=np.int32)
                codes = None
                if not dev.pb_mode:
                    codes = np.full((1, b_loc, L), 4, dtype=np.uint8)
                    for r, i in enumerate(block):
                        codes[0, r, : lengths[0, r]] = encode_seq(seqs[i])
                dual = np.where(live, qdualrank[ids], 0).astype(np.int32)
                selfr = np.where(live, qselfrid[ids], -1).astype(np.int32)
                query, shards = dev.shard_programs(L, A, 1, b_loc)
                *planes, mcount = query.run(*dev.program_arrays(L, codes, lengths, ids, dual, selfr, seqs))
                inflight.append((ids[0], L, A, codes, lengths[0], mcount, ring_count(shards, *planes)))
        logger.debug(
            "lockstep count: process %d/%d, %d blocks in flight, triaged after the last dispatch",
            pid, nproc, len(inflight),
        )
        retry = []
        for ids, L, A, codes, lengths, mcount, outs in inflight:
            c, a, r, mc = (x.cpu().numpy() for x in (*outs, mcount))
            live = ids >= 0
            needs = dev.triage_flags(
                live, a, A, r, mc, minimizer_cap(L), None if codes is None else codes[0], lengths,
            )
            retry.extend(ids[needs].tolist())
            ok = live & ~needs
            counts[ids[ok]] = c[ok]
            had[ids[ok]] = c[ok] > 0
        # exact host recompute of this process's flagged rows
        for i, (cn, h) in zip(retry, dev._host_count_many([(names[i], seqs[i]) for i in retry])):
            counts[i], had[i] = cn, h
        fallback = len(retry)
        if host_future is not None:
            share_set = set(host_share_rows)
            for i, (cn, h) in zip(host_rows_all, host_future.result()):
                counts[i], had[i] = cn, h
                if i in share_set:
                    dev.fallback_triggers["host_share"] += 1
                else:
                    fallback += 1
    finally:
        if pool is not None:
            pool.shutdown()
    # every process's slice, on every process (one all_gather)
    width = max(en - st for st, en in slices)
    mine = np.zeros((2, width), dtype=np.int32)
    mine[0, : e - s] = counts[s:e]
    mine[1, : e - s] = had[s:e]
    packed = all_gather(mine)
    for q, (st, en) in enumerate(slices):
        counts[st:en] = packed[q, 0, : en - st]
        had[st:en] = packed[q, 1, : en - st].astype(bool)
    return BatchCounts(counts, had, fallback)
