"""Colinear anchor chaining — host reference implementation.

Reproduces the semantics of minimap2 2.x's chaining stage
(`lchain.c` ``mm_chain_dp`` + ``mm_chain_backtrack``) as exercised by
the reference via ``mm_map`` (SURVEY.md C15):

* anchors sorted by (rid, strand, target pos), stable in seed order;
* DP: ``f[i] = max(span_i, max_j f[j] + sc(i,j))`` over predecessors
  within ``max_gap`` on both axes and ``bw`` band, gap penalty
  ``chn_pen_gap*dd + 0.5*log2(dd+1)`` evaluated in f32 and truncated;
* backtracking extracts chains in descending score order, each anchor
  used once; chains kept when ``score >= min_chain_score`` and
  ``cnt >= min_cnt``.

The ``max_chain_skip`` early-break heuristic is modelled exactly via a
reformulation that avoids sequential scan state: scanning predecessors
``j`` descending, minimap2 counts js that (a) are the stored
predecessor ``p[x]`` of an anchor ``x`` already examined in this scan
and (b) do not improve the running maximum; the count decrements
(floored at 0) on improving js, and the scan breaks when it exceeds
``max_chain_skip``.  Both inputs are scan-state-free: "already
examined" is simply ``x > j`` (descending order), and the floored
running count equals ``S_t - min(0, min_{s<=t} S_s)`` of the raw
+1/-1 step sums — so the break position is computable with suffix
cumulative ops (see ``_skip_cut``).  The backtrack models
``mg_chain_bk_end``'s peak-drop trimming (``max_drop = bw``): a score
valley deeper than the band truncates the chain at the peeled-score
argmax and frees the anchors beyond the break for a later peel (chain
split); see ``_bk_end`` and ``tests/test_max_drop.py``.  Unique-target
COUNTS are valley-invariant (each target's best chain is always peeled
intact and trimming only raises kept scores), so the count fast paths
and the device pipeline need no drop handling.

This host engine is the correctness oracle for the device pipeline and
the exactness-fallback path for every preset.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..platform import OverlapParams

NEG_INF = np.iinfo(np.int32).min


def mg_log2(x: np.ndarray) -> np.ndarray:
    """minimap2's fast approximate log2 (f32 bit trick), vectorised."""
    z = np.asarray(x, dtype=np.float32)
    bits = z.view(np.uint32).copy()
    log2 = ((bits >> 23) & 255).astype(np.float32) - 128.0
    bits = (bits & ~np.uint32(255 << 23)) + np.uint32(127 << 23)
    zf = bits.view(np.float32)
    return (
        log2 + (np.float32(-0.34484843) * zf + np.float32(2.02466578)) * zf
        - np.float32(0.67487759)
    ).astype(np.float32)


@dataclass
class Anchors:
    """Per-query anchor set, sorted by (rid, strand, rpos)."""

    rid: np.ndarray  # int32 target id
    rpos: np.ndarray  # int32 target k-mer end position
    qpos: np.ndarray  # int32 query k-mer end position (chaining coords)
    strand: np.ndarray  # int8 relative strand (0 fwd, 1 rev)
    span: np.ndarray  # int32 k-mer span (query minimizer span)

    def __len__(self) -> int:
        return len(self.rid)


def collect_anchors(
    index,
    qkey: np.ndarray,
    qpos: np.ndarray,
    qstrand: np.ndarray,
    qlen: int,
    *,
    qdualrank: Optional[int] = None,
    qselfrid: Optional[int] = None,
) -> tuple[Anchors, int]:
    """Look up query minimizers and build the sorted anchor array.

    Mirrors minimap2's seed collection: minimizers with target occurrence
    above ``mid_occ`` are dropped (``-e0`` presets) and contribute to
    ``rep_len``; the no-dual mask skips targets whose name sorts before
    the query's (`aligner.rs:89-103` semantics), and the no-diag mask
    skips exact self-diagonal hits.  Returns ``(anchors, rep_len)``.
    """
    params: OverlapParams = index.params
    hashes = qkey >> np.uint64(8)
    spans = (qkey & np.uint64(0xFF)).astype(np.int32)
    # mm_seed_mz_flt (q_occ_frac): drop query minimizers occurring more
    # than mid_occ times within the query itself AND more than
    # q_occ_frac of the query's minimizer count; filtered minimizers
    # are skipped entirely (they do not contribute to rep_len either).
    qflt = np.zeros(len(hashes), dtype=bool)
    if params.q_occ_frac > 0 and index.mid_occ > 0 and len(hashes) > index.mid_occ:
        _, inv, cnt = np.unique(hashes, return_inverse=True, return_counts=True)
        c = cnt[inv]
        qflt = (c > index.mid_occ) & (
            c.astype(np.float32) > np.float32(len(hashes)) * np.float32(params.q_occ_frac)
        )
    start, occ = index.occurrence(hashes)
    occ = np.where(qflt, 0, occ)
    dropped = (occ > index.mid_occ) & ~qflt
    keep = (~dropped) & (occ > 0)
    # rep_len: merged intervals of repetitive query seeds (rl:i tag)
    rep_len = 0
    if dropped.any():
        dstart = np.sort(qpos[dropped] - spans[dropped] + 1)
        dend = np.sort(qpos[dropped] + 1)
        # merged-interval total: gaps between consecutive intervals
        gap = np.maximum(dstart[1:] - dend[:-1], 0)
        rep_len = int((dend[-1] - dstart[0]) - gap.sum())

    idxs = np.flatnonzero(keep)
    occs = occ[idxs]
    total = int(occs.sum())
    # expand postings by rank (vectorised ragged expansion)
    midx = np.repeat(idxs, occs)  # minimizer id per anchor
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(occs) - occs, occs
    )
    posting = np.repeat(start[idxs], occs) + within
    rid = index.rid[posting].astype(np.int32)
    rpos = index.pos[posting].astype(np.int32)
    rel = index.strand[posting].astype(np.int8) ^ qstrand[midx].astype(np.int8)
    strand = rel
    span_arr = spans[midx].astype(np.int32)
    # chaining coords: forward keeps the query end position; reverse
    # flips to the end position on the reverse-complemented query
    fwd_q = qpos[midx]
    rev_q = qlen - (qpos[midx] + 1 - spans[midx]) - 1
    qp = np.where(rel == 0, fwd_q, rev_q).astype(np.int32)

    mask = np.ones(total, dtype=bool)
    if params.no_dual and qdualrank is not None:
        mask &= ~(index.name_rank[rid] < qdualrank)
    if params.no_diag and qselfrid is not None and qselfrid >= 0:
        mask &= ~((rid == qselfrid) & (strand == 0) & (rpos == qp))
    rid, rpos, qp, strand, span_arr = (
        rid[mask],
        rpos[mask],
        qp[mask],
        strand[mask],
        span_arr[mask],
    )
    order = np.lexsort((rpos, strand, rid))
    return (
        Anchors(
            rid=rid[order],
            rpos=rpos[order],
            qpos=qp[order],
            strand=strand[order],
            span=span_arr[order],
        ),
        rep_len,
    )


def chain_dp(anchors: Anchors, params: OverlapParams) -> tuple[np.ndarray, np.ndarray]:
    """The chaining DP; returns (f, p) score and predecessor arrays.

    Uses the native C++ kernel when available (identical f32 scoring
    semantics, see ``native/lrge_native.cpp``); falls back to the numpy
    loop below.
    """
    n = len(anchors)
    f = np.zeros(n, dtype=np.int64)
    p = np.full(n, -1, dtype=np.int64)
    if n == 0:
        return f, p
    from ..native import native

    if native is not None:
        key2 = (anchors.rid.astype(np.int32) * 2 + anchors.strand.astype(np.int32)).astype(
            np.int32
        )
        native.chain_dp(
            np.ascontiguousarray(key2),
            np.ascontiguousarray(anchors.rpos.astype(np.int32)),
            np.ascontiguousarray(anchors.qpos.astype(np.int32)),
            np.ascontiguousarray(anchors.span.astype(np.int32)),
            n,
            params.max_gap,
            params.bw,
            params.max_chain_iter,
            params.max_chain_skip,
            np.float32(params.chn_pen_gap()),
            np.float32(params.chn_pen_skip()),
            f,
            p,
        )
        return f, p
    rid = anchors.rid.astype(np.int64)
    st_key = rid * 2 + anchors.strand  # same (rid, strand) group
    rpos = anchors.rpos.astype(np.int64)
    qpos = anchors.qpos.astype(np.int64)
    span = anchors.span.astype(np.int64)
    pen_gap = np.float32(params.chn_pen_gap())
    pen_skip = np.float32(params.chn_pen_skip())
    max_gap = params.max_gap
    bw = params.bw
    max_skip = params.max_chain_skip
    st = 0
    for i in range(n):
        while st < i and (st_key[st] != st_key[i] or rpos[i] > rpos[st] + max_gap):
            st += 1
        lo = max(st, i - params.max_chain_iter)
        best = span[i]
        bestj = -1
        if lo < i:
            j = np.arange(lo, i)
            dq = qpos[i] - qpos[j]
            dr = rpos[i] - rpos[j]
            dd = np.abs(dr - dq)
            dg = np.minimum(dq, dr)
            sc = np.minimum(dg, span[j])
            pen_mask = (dd != 0) | (dg > span[j])
            lin = pen_gap * dd.astype(np.float32) + pen_skip * dg.astype(np.float32)
            logp = np.where(dd >= 1, mg_log2((dd + 1).astype(np.float32)), np.float32(0.0))
            pen = (lin + np.float32(0.5) * logp).astype(np.float32).astype(np.int64)
            sc = np.where(pen_mask, sc - pen, sc)
            ok = (dq > 0) & (dq <= max_gap) & (dr != 0) & (dd <= bw)
            cand = np.where(ok, sc + f[j], NEG_INF)
            # marked[j]: j is the predecessor of a valid anchor x > j in
            # the window (x is always examined before j when scanning
            # descending, so no scan state is needed)
            marked = np.zeros(i - lo, dtype=bool)
            px = p[lo:i][ok]
            px = px[px >= lo]
            marked[(px - lo).astype(np.int64)] = True
            examined = _skip_cut(cand[::-1], marked[::-1], int(span[i]), max_skip)[::-1]
            cand = np.where(examined, cand, NEG_INF)
            # ties keep the largest j (minimap2 scans j descending, first hit)
            k = len(cand) - 1 - int(np.argmax(cand[::-1]))
            if cand[k] > best:
                best = cand[k]
                bestj = lo + k
        f[i] = best
        p[i] = bestj
    return f, p


def _skip_cut(
    cand_desc: np.ndarray, marked_desc: np.ndarray, span_i: int, max_skip: int
) -> np.ndarray:
    """Examined-mask of the descending predecessor scan under max_chain_skip.

    Inputs are in DESCENDING-j order (scan order).  ``n_skip`` is the
    floored running sum of +1 (valid, marked, non-improving) / -1
    (improving) steps: ``n_t = S_t - min(0, min_{s<=t} S_s)``.  The scan
    breaks at the first step where ``n_t > max_skip``; that step itself
    was examined (its increment branch ran), every later one was not.
    """
    valid = cand_desc != NEG_INF
    # running max BEFORE each step (exclusive), seeded with span_i
    prev = np.concatenate(([np.int64(NEG_INF)], np.maximum.accumulate(cand_desc)[:-1]))
    runmax_excl = np.maximum(prev, span_i)
    improving = valid & (cand_desc > runmax_excl)
    inc = valid & marked_desc & ~improving
    a = inc.astype(np.int64) - improving.astype(np.int64)
    s = np.cumsum(a)
    runmin = np.minimum(np.minimum.accumulate(s), 0)
    n_skip = s - runmin
    over = n_skip > max_skip
    if not over.any():
        return np.ones(len(cand_desc), dtype=bool)
    cut = int(np.argmax(over))  # first step whose increment broke the scan
    out = np.zeros(len(cand_desc), dtype=bool)
    out[: cut + 1] = True
    return out


@dataclass
class Chain:
    """One backtracked chain (a future PAF row)."""

    score: int
    anchor_idx: np.ndarray  # ascending anchor indices
    rid: int
    strand: int


def _bk_end(
    end: int, fe: int, f: np.ndarray, p: np.ndarray, used: np.ndarray, max_drop: int
) -> int:
    """``mg_chain_bk_end``: where the backtrack walk from ``end`` stops.

    Walks predecessors computing the peeled score ``s = fe - f[i]``
    (``fe`` when the walk exits at -1); keeps the argmax ``max_i`` and
    breaks once the score falls more than ``max_drop`` below the running
    max (a valley deeper than the band).  Every probed anchor is marked
    used (minimap2 sets ``t[i] = 2``): anchors between the returned end
    and the break can never seed another chain, while anchors BEYOND the
    break stay free — a deep valley therefore splits the chain and the
    leading peak may be peeled later as its own chain.
    """
    i = int(end)
    max_s = 0
    max_i = i
    while True:
        used[i] = True
        i = int(p[i])
        s = fe if i < 0 else fe - int(f[i])
        if s > max_s:
            max_s, max_i = s, i
        elif max_s - s > max_drop:
            break
        if i < 0 or used[i]:
            break
    return max_i


def backtrack(
    f: np.ndarray, p: np.ndarray, anchors: Anchors, params: OverlapParams
) -> List[Chain]:
    """``mm_chain_backtrack``: peel chains in descending score order,
    trimming each walk at a score valley deeper than ``max_drop = bw``
    (`mm_chain_dp` passes the chaining bandwidth; reference call site
    `liblrge/src/minimap2/aligner.rs:230-241` via mm_map)."""
    min_sc = params.min_chain_score
    min_cnt = params.min_cnt
    max_drop = params.bw
    cand = np.flatnonzero(f >= min_sc)
    if len(cand) == 0:
        return []
    # sort by f ascending then iterate descending (stable → larger index
    # first among equal scores, matching the radix sort + reverse walk)
    order = cand[np.argsort(f[cand], kind="stable")][::-1]
    used = np.zeros(len(f), dtype=bool)
    chains: List[Chain] = []
    for end in order:
        if used[end]:
            continue
        fe = int(f[end])
        end_i = _bk_end(int(end), fe, f, p, used, max_drop)
        path = []
        i = int(end)
        while i != end_i:
            path.append(i)
            used[i] = True
            i = int(p[i])
        sc = fe if end_i < 0 else fe - int(f[end_i])
        if sc >= min_sc and len(path) >= min_cnt:
            idx = np.array(path[::-1], dtype=np.int64)
            chains.append(
                Chain(
                    score=sc,
                    anchor_idx=idx,
                    rid=int(anchors.rid[idx[0]]),
                    strand=int(anchors.strand[idx[0]]),
                )
            )
        # NOTE: anchors of discarded/probed chains stay marked, matching
        # the C loop (t[i] is never reverted) — they cannot seed later
        # chains.
    return chains
