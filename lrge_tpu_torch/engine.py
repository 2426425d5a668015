"""Overlap engine orchestration (host reference path).

``OverlapEngine`` plays the role of the reference's ``AlignerWrapper`` +
``mm_map`` (`liblrge/src/minimap2/aligner.rs:204-303`): given a target
index, map one query read to a list of :class:`PafRecord`.  The host
path runs the full backtracking pipeline (all chains, like minimap2's
AVA mode which keeps every chain); the batched device path (counts
only / best-chain-per-target) lives in ``ops.overlap`` and must
produce identical unique-target overlap counts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .ops.chain import Anchors, Chain, backtrack, chain_dp, collect_anchors
from .ops.encode import encode_seq
from .ops.index import TargetIndex, build_index
from .ops.sketch import sketch_read, sketch_seq
from .paf import PafRecord
from .platform import OverlapParams

MASK_LEVEL = 0.5  # minimap2 default -M (primary/secondary query-overlap)


@dataclass
class Mapping:
    """Internal chain record before PAF formatting."""

    rid: int
    strand: int
    qs: int
    qe: int
    rs: int
    re: int
    score: int
    cnt: int
    mlen: int
    blen: int
    tp: str = "P"
    n_sub: int = 0  # number of secondaries attached to this primary
    subsc: int = 0  # best secondary score
    n_match_pos: int = 0  # distinct query end positions in the chain


def _chain_to_mapping(chain: Chain, anchors: Anchors, qlen: int) -> Mapping:
    idx = chain.anchor_idx
    first, last = int(idx[0]), int(idx[-1])
    span_f = int(anchors.span[first])
    rs = int(anchors.rpos[first]) + 1 - span_f
    re = int(anchors.rpos[last]) + 1
    qs_c = int(anchors.qpos[first]) + 1 - span_f
    qe_c = int(anchors.qpos[last]) + 1
    if chain.strand:
        qs, qe = qlen - qe_c, qlen - qs_c
    else:
        qs, qe = qs_c, qe_c
    # mlen/blen from consecutive anchor gaps (mm_gen_regs accounting)
    mlen = blen = span_f
    qp = anchors.qpos[idx].astype(np.int64)
    rp = anchors.rpos[idx].astype(np.int64)
    sp = anchors.span[idx].astype(np.int64)
    if len(idx) > 1:
        dq = np.diff(qp)
        dr = np.diff(rp)
        minl = np.minimum(dq, dr)
        maxl = np.maximum(dq, dr)
        mlen += int(np.minimum(minl, sp[1:]).sum())
        blen += int(maxl.sum())
    n_match_pos = int(len(np.unique(qp)))
    return Mapping(
        n_match_pos=n_match_pos,
        rid=chain.rid,
        strand=chain.strand,
        qs=qs,
        qe=qe,
        rs=rs,
        re=re,
        score=chain.score,
        cnt=len(idx),
        mlen=mlen,
        blen=blen,
    )


def _set_parents(mappings: List[Mapping]) -> None:
    """Primary/secondary marking by query-interval overlap.

    Simplified ``mm_set_parent``: in score order, a mapping whose query
    interval overlaps an existing primary by >= MASK_LEVEL of the
    shorter interval becomes its secondary (``tp:A:S``); in minimap2's
    AVA mode nothing is dropped (`map.c` skips ``mm_select_sub`` when
    MM_F_AVA is set), so this only affects the tp tag.  Each primary
    accumulates its secondary count and best secondary score, the
    inputs of minimap2's mapq model.
    """
    primaries: List[Mapping] = []
    for m in sorted(mappings, key=lambda m: -m.score):
        parent = None
        for pm in primaries:
            lo = max(m.qs, pm.qs)
            hi = min(m.qe, pm.qe)
            if hi > lo:
                minlen = min(m.qe - m.qs, pm.qe - pm.qs)
                if minlen > 0 and (hi - lo) >= MASK_LEVEL * minlen:
                    parent = pm
                    break
        if parent is None:
            m.tp = "P"
            primaries.append(m)
        else:
            m.tp = "S"
            parent.n_sub += 1
            if m.score > parent.subsc:
                parent.subsc = m.score


def _mapq(m: Mapping, min_chain_score: int) -> int:
    """minimap2's chain-only mapq model (`mm_set_mapq`, map.c).

    For mappings without base-level alignment (no ``-c``, the lrge
    configuration): ``mapq = pen * 40 * (1 - subsc/score) * ln(score)``
    with ``pen = min(pen_cm, pen_s1)``, ``pen_cm = min(1, cnt/10)``,
    ``pen_s1 = min(1, score/100)``, minus a ``4.343*ln(n_sub+1)``
    secondary-count penalty, clamped to [0, 60]; secondaries get 0 and
    an unambiguous primary with mapq 0 is bumped to 1.  Reconstructed
    from a study of minimap2 2.30's map.c (the source is not available
    in this environment); numeric differences are possible in corner
    cases but the model matches on unambiguous chains.
    """
    import math

    if m.tp != "P":
        return 0
    subsc = max(m.subsc, min_chain_score)
    if m.score <= 0:
        return 0
    x = subsc / m.score
    pen_cm = 1.0 if m.cnt > 10 else 0.1 * m.cnt
    pen_s1 = 1.0 if m.score > 100 else 0.01 * m.score
    pen = min(pen_cm, pen_s1)
    mapq = int(pen * 40.0 * (1.0 - x) * math.log(m.score))
    mapq -= int(4.343 * math.log(m.n_sub + 1) + 0.499)
    mapq = max(mapq, 0)
    if m.score > subsc and mapq == 0:
        mapq = 1
    return min(mapq, 60)


class OverlapEngine:
    """Maps query reads against a :class:`TargetIndex`."""

    def __init__(self, index: TargetIndex):
        import threading

        self.index = index
        self.params: OverlapParams = index.params
        # name -> rid for the self mask; rank-in-target-order for no-dual
        self._name_to_rid = {n: i for i, n in enumerate(index.names)}
        self._sorted_names = sorted(index.names)
        self._bdict = None
        self._bdict_lock = threading.Lock()

    def _dual_rank(self, qname: bytes) -> int:
        """Number of target names lexicographically smaller than qname."""
        import bisect

        return bisect.bisect_left(self._sorted_names, qname)

    def _bucket_dict(self):
        """Bucketed unique-hash dictionary for the native batch kernel
        (same layout as the device lookup): built once per index.
        Contiguous bucket probes replace the ~2*log2(N) cache-missing
        binary-search steps over the postings keys.  Lock-protected:
        concurrent first callers (the device engine's host-share future
        and its retry path) must not both pay the multi-second build."""
        with self._bdict_lock:
            return self._bucket_dict_locked()

    def _bucket_dict_locked(self):
        if self._bdict is None:
            keys = self.index.keys
            hb = 2 * self.params.k
            uk, first = np.unique(keys, return_index=True)
            uoff = np.append(first, len(keys)).astype(np.int32)
            bits = int(np.ceil(np.log2(max(len(uk), 2)))) + 1
            bits = min(max(bits, 12), 24, hb - 1)
            ub = (uk >> np.uint64(hb - bits)).astype(np.int64)
            cnt = np.bincount(ub, minlength=1 << bits)
            boff = np.concatenate(([0], np.cumsum(cnt))).astype(np.int32)
            self._bdict = (
                np.ascontiguousarray(uk),
                np.ascontiguousarray(uoff),
                np.ascontiguousarray(boff),
                hb,
                bits,
            )
        return self._bdict

    def map_read(self, qname: bytes, seq: bytes) -> List[PafRecord]:
        """Map one query; returns all chains as PAF records (score desc)."""
        qlen = len(seq)
        mz = sketch_seq(seq, self.params.k, self.params.w, self.params.hpc)
        if len(mz.key) == 0:
            return []
        anchors, rep_len = collect_anchors(
            self.index,
            mz.key,
            mz.pos.astype(np.int32),
            mz.strand.astype(np.int8),
            qlen,
            qdualrank=self._dual_rank(qname) if self.params.no_dual else None,
            qselfrid=self._name_to_rid.get(qname, -1),
        )
        if len(anchors) == 0:
            return []
        f, p = chain_dp(anchors, self.params)
        chains = backtrack(f, p, anchors, self.params)
        if not chains:
            return []
        mappings = [_chain_to_mapping(c, anchors, qlen) for c in chains]
        _set_parents(mappings)
        # dv: sequence-divergence estimate from minimizer retention
        # (`mm_est_err`, map.c): n_tot = query minimizers whose end
        # position lies in the mapped window's interior (a full k-mer
        # fits), n_match = distinct query end positions among the
        # chain's anchors, dv = 1 - (n_match/n_tot)^(1/avg_span).
        # Reconstructed from a study of minimap2 2.30 (source not
        # available here); the tag format and zero/rounding rules are
        # golden-tested against `mapping.rs`.
        spans = (mz.key & np.uint64(0xFF)).astype(np.float64)
        avg_k = float(spans.mean()) if len(spans) else float(self.params.k)
        qpos_sorted = np.sort(mz.pos)
        records = []
        for m in mappings:
            lo = m.qs + int(avg_k + 0.499) - 1
            n_tot = int(
                np.searchsorted(qpos_sorted, m.qe, side="right")
                - np.searchsorted(qpos_sorted, lo, side="left")
            )
            if n_tot > 0 and m.n_match_pos < n_tot:
                dv = float(1.0 - (m.n_match_pos / n_tot) ** (1.0 / avg_k))
            else:
                dv = 0.0
            records.append(
                PafRecord(
                    query_name=qname,
                    query_len=qlen,
                    query_start=m.qs,
                    query_end=m.qe,
                    strand="-" if m.strand else "+",
                    target_name=self.index.names[m.rid],
                    target_len=int(self.index.lengths[m.rid]),
                    target_start=m.rs,
                    target_end=m.re,
                    match_len=m.mlen,
                    block_len=m.blen,
                    mapq=_mapq(m, self.params.min_chain_score),
                    tp=m.tp,
                    cm=m.cnt,
                    s1=m.score,
                    dv=dv,
                    rl=rep_len,
                )
            )
        records.sort(key=lambda r: -r.s1)
        return records

    def count_overlaps(self, qname: bytes, seq: bytes) -> tuple[int, int]:
        """(unique target overlaps, had_any_mapping) for one query.

        Fast path: unique-target existence only needs the best chain
        per target (backtracking peels chains best-first, so a target's
        best chain always survives intact), so the backtrack/PAF stages
        are skipped.  ``min_cnt`` is implied by ``min_chain_score`` for
        constant spans; with HPC spans the count is checked by walking
        the predecessor chain of each passing target's best anchor.
        """
        if self.params.hpc:
            # variable spans break the implied-min_cnt argument and a
            # same-target secondary chain can pass where the best chain
            # fails min_cnt; use the exact full path
            recs = self.map_read(qname, seq)
            return len({r.target_name for r in recs}), int(bool(recs))
        qlen = len(seq)
        mz = sketch_seq(seq, self.params.k, self.params.w, self.params.hpc)
        if len(mz.key) == 0:
            return 0, 0
        anchors, _ = collect_anchors(
            self.index,
            mz.key,
            mz.pos.astype(np.int32),
            mz.strand.astype(np.int8),
            qlen,
            qdualrank=self._dual_rank(qname) if self.params.no_dual else None,
            qselfrid=self._name_to_rid.get(qname, -1),
        )
        if len(anchors) == 0:
            return 0, 0
        f, p = chain_dp(anchors, self.params)
        rid = anchors.rid
        # per-rid best score (anchors sorted by rid)
        run_start = np.flatnonzero(np.concatenate([[True], rid[1:] != rid[:-1]]))
        best = np.maximum.reduceat(f, run_start)
        count = int((best >= self.params.min_chain_score).sum())
        return count, int(count > 0)

    def count_overlaps_many(
        self, items, threads: int | None = None, want_pairs: bool = False
    ):
        """Batch counting of ``[(name, seq), ...]`` -> ``[(count, had)]``.

        Uses the native whole-pipeline kernel (sketch -> lookup ->
        chain -> reduce, GIL-free and threaded over queries) when
        available; semantics identical to per-read
        :meth:`count_overlaps` (HPC presets reduce via the exact
        backtrack peel, constant-span presets via the per-rid best).
        The no-native build falls back to the Python loop.

        With ``want_pairs`` the return is ``[(count, had, rids)]`` where
        ``rids`` is the passing target-id array (None when truncated at
        the 1024-pair cap or on the fallback path — callers recover
        those rows with :meth:`map_read`).
        """
        from .native import native

        p = self.params
        if native is None or not hasattr(native, "count_many"):
            res = [self.count_overlaps(nm, sq) for nm, sq in items]
            if want_pairs:
                return [(c, h, None) for c, h in res]
            return res
        import os

        n = len(items)
        if n == 0:
            return []
        seqs = [bytes(sq) for _, sq in items]
        dualrank = np.array(
            [self._dual_rank(nm) if p.no_dual else 0 for nm, _ in items],
            dtype=np.int32,
        )
        selfrid = np.array(
            [self._name_to_rid.get(nm, -1) for nm, _ in items], dtype=np.int32
        )
        counts = np.zeros(n, dtype=np.int32)
        had = np.zeros(n, dtype=np.uint8)
        PMAX = 1024
        pairs = (
            np.empty((n, PMAX), dtype=np.int32)
            if want_pairs
            else np.empty(0, dtype=np.int32)
        )
        extra = (pairs, PMAX if want_pairs else 0, *self._bucket_dict())
        idx = self.index
        native.count_many(
            seqs,
            np.ascontiguousarray(dualrank),
            np.ascontiguousarray(selfrid),
            np.ascontiguousarray(idx.keys),
            np.ascontiguousarray(idx.rid.astype(np.int32, copy=False)),
            np.ascontiguousarray(idx.pos.astype(np.int32, copy=False)),
            np.ascontiguousarray(idx.strand.astype(np.int8, copy=False)),
            np.ascontiguousarray(idx.name_rank),
            int(idx.mid_occ),
            p.k,
            p.w,
            p.max_gap,
            p.bw,
            p.max_chain_iter,
            p.max_chain_skip,
            np.float32(p.chn_pen_gap()),
            np.float32(p.chn_pen_skip()),
            p.min_chain_score,
            np.float32(p.q_occ_frac),
            int(p.no_dual),
            int(p.no_diag),
            int(p.hpc),
            p.min_cnt,
            threads or os.cpu_count() or 1,
            counts,
            had,
            *extra,
        )  # noqa: the optional tail is (pairs, pmax, uhash, uoff, boff, hash_bits, bucket_bits)
        if want_pairs:
            out = []
            for i, (c, h) in enumerate(zip(counts, had)):
                r = pairs[i]
                r = r[r >= 0]
                out.append((int(c), int(h), r if len(r) == c else None))
            return out
        return [(int(c), int(h)) for c, h in zip(counts, had)]


def build_engine(seqs, names, params: OverlapParams) -> OverlapEngine:
    return OverlapEngine(build_index(seqs, names, params))


# ---------------------------------------------------------------------------
# Process-level host parallelism (the reference's rayon pool analogue,
# `twoset.rs:252-270`).  Forked numpy workers are the fastest path, but
# fork is only safe while the process is single-threaded and holds no
# CUDA context: a forked child inherits the context unusable, and
# inherits other threads' locked mutexes.  When fork is unsafe the pool
# degrades to a thread pool: the native chain DP (the dominant cost)
# releases the GIL, so threads still scale.
# ---------------------------------------------------------------------------


def fork_unsafe() -> bool:
    """True when os.fork would inherit live threads (any thread of the
    process, Python's or a native library's) or this process's CUDA
    context, making forked pools hazardous."""
    import os
    import threading

    import torch

    try:
        n_threads = len(os.listdir("/proc/self/task"))
    except OSError:  # no procfs: count Python's threads only
        n_threads = threading.active_count()
    return n_threads > 1 or torch.cuda.is_initialized()


_WORKER_ENGINE: Optional[OverlapEngine] = None


def _init_worker(index) -> None:
    global _WORKER_ENGINE
    _WORKER_ENGINE = OverlapEngine(index)


def _worker_map(item):
    name, seq = item
    return _WORKER_ENGINE.map_read(name, seq)


def _worker_count(item):
    name, seq = item
    return _WORKER_ENGINE.count_overlaps(name, seq)


class ParallelHostMapper:
    """Maps queries across forked worker processes, preserving order."""

    def __init__(self, index: TargetIndex, threads: int):
        self.index = index
        self.threads = max(1, threads)
        self._pool = None
        self._thread_pool = None
        if self.threads > 1:
            if fork_unsafe():
                # fork would inherit live threads or the CUDA context;
                # use a thread pool over the shared engine instead — the
                # native chain DP releases the GIL, so this still scales
                from concurrent.futures import ThreadPoolExecutor

                _init_worker(index)
                self._thread_pool = ThreadPoolExecutor(self.threads)
            else:
                import multiprocessing as mp
                from concurrent.futures import ProcessPoolExecutor

                ctx = mp.get_context("fork")
                self._pool = ProcessPoolExecutor(
                    self.threads, mp_context=ctx, initializer=_init_worker, initargs=(index,)
                )
        else:
            _init_worker(index)

    def map_reads(self, items, chunksize: int = 16):
        """Yield ``map_read`` results in input order."""
        if self._pool is not None:
            yield from self._pool.map(_worker_map, items, chunksize=chunksize)
        elif self._thread_pool is not None:
            yield from self._thread_pool.map(_worker_map, items)
        else:
            for it in items:
                yield _worker_map(it)

    def count_reads(self, items, chunksize: int = 16):
        if self._pool is not None:
            yield from self._pool.map(_worker_count, items, chunksize=chunksize)
        elif self._thread_pool is not None:
            yield from self._thread_pool.map(_worker_count, items)
        else:
            for it in items:
                yield _worker_count(it)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
        if self._thread_pool is not None:
            self._thread_pool.shutdown()
            self._thread_pool = None
