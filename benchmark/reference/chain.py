"""Anchors, minimap2's chaining DP (``mm_chain_dp``) and backtrack
(``mm_chain_backtrack`` with ``mg_chain_bk_end``), and a query's
overlap count, as the port's plain host path computes them."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .params import Params

NEG_INF = np.iinfo(np.int32).min


def mg_log2(x: np.ndarray) -> np.ndarray:
    """minimap2's fast f32 log2 (bit trick)."""
    z = np.asarray(x, dtype=np.float32)
    bits = z.view(np.uint32).copy()
    log2 = ((bits >> 23) & 255).astype(np.float32) - 128.0
    bits = (bits & ~np.uint32(255 << 23)) + np.uint32(127 << 23)
    zf = bits.view(np.float32)
    return (log2 + (np.float32(-0.34484843) * zf + np.float32(2.02466578)) * zf - np.float32(0.67487759)).astype(
        np.float32
    )


@dataclass
class Anchors:
    """One query's anchors, sorted by (rid, strand, rpos)."""

    rid: np.ndarray
    rpos: np.ndarray
    qpos: np.ndarray
    strand: np.ndarray
    span: np.ndarray

    def __len__(self) -> int:
        return len(self.rid)


def collect_anchors(index, mz, qlen: int, p: Params, qdualrank=None, qselfrid=-1) -> Anchors:
    """minimap2's seed collection: the query's own repeat filter
    (``q_occ_frac``), the occurrence cut, the no-dual and no-diag masks."""
    hashes = mz.key >> np.uint64(8)
    spans = (mz.key & np.uint64(0xFF)).astype(np.int32)
    qpos, qstrand = mz.pos.astype(np.int32), mz.strand.astype(np.int8)
    qflt = np.zeros(len(hashes), dtype=bool)
    if p.q_occ_frac > 0 and index.mid_occ > 0 and len(hashes) > index.mid_occ:
        _, inv, cnt = np.unique(hashes, return_inverse=True, return_counts=True)
        c = cnt[inv]
        qflt = (c > index.mid_occ) & (c.astype(np.float32) > np.float32(len(hashes)) * np.float32(p.q_occ_frac))
    start, occ = index.occurrence(hashes)
    occ = np.where(qflt, 0, occ)
    keep = ~((occ > index.mid_occ) & ~qflt) & (occ > 0)
    idxs = np.flatnonzero(keep)
    occs = occ[idxs]
    total = int(occs.sum())
    midx = np.repeat(idxs, occs)
    within = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(occs) - occs, occs)
    posting = np.repeat(start[idxs], occs) + within
    rid = index.rid[posting].astype(np.int32)
    rpos = index.pos[posting].astype(np.int32)
    strand = index.strand[posting].astype(np.int8) ^ qstrand[midx]
    span = spans[midx].astype(np.int32)
    # reverse anchors take the end position on the reverse-complemented query
    qp = np.where(strand == 0, qpos[midx], qlen - (qpos[midx] + 1 - spans[midx]) - 1).astype(np.int32)
    mask = np.ones(total, dtype=bool)
    if not p.dual and qdualrank is not None:
        mask &= ~(index.name_rank[rid] < qdualrank)
    if p.no_diag and qselfrid is not None and qselfrid >= 0:
        mask &= ~((rid == qselfrid) & (strand == 0) & (rpos == qp))
    rid, rpos, qp, strand, span = rid[mask], rpos[mask], qp[mask], strand[mask], span[mask]
    order = np.lexsort((rpos, strand, rid))
    return Anchors(rid[order], rpos[order], qp[order], strand[order], span[order])


def chain_dp(a: Anchors, p: Params) -> tuple[np.ndarray, np.ndarray]:
    """``(f, p)``: each anchor's best chain score and predecessor, over
    every predecessor within ``max_gap`` and ``max_chain_iter``, with
    minimap2's ``max_chain_skip`` break."""
    n = len(a)
    f = np.zeros(n, dtype=np.int64)
    pred = np.full(n, -1, dtype=np.int64)
    st_key = a.rid.astype(np.int64) * 2 + a.strand
    rpos = a.rpos.astype(np.int64)
    qpos = a.qpos.astype(np.int64)
    span = a.span.astype(np.int64)
    pen_gap = np.float32(p.chn_pen_gap())
    pen_skip = np.float32(p.chn_pen_skip())
    st = 0
    for i in range(n):
        while st < i and (st_key[st] != st_key[i] or rpos[i] > rpos[st] + p.max_gap):
            st += 1
        lo = max(st, i - p.max_chain_iter)
        best, bestj = span[i], -1
        if lo < i:
            j = np.arange(lo, i)
            dq = qpos[i] - qpos[j]
            dr = rpos[i] - rpos[j]
            dd = np.abs(dr - dq)
            dg = np.minimum(dq, dr)
            sc = np.minimum(dg, span[j])
            lin = pen_gap * dd.astype(np.float32) + pen_skip * dg.astype(np.float32)
            logp = np.where(dd >= 1, mg_log2((dd + 1).astype(np.float32)), np.float32(0.0))
            pen = (lin + np.float32(0.5) * logp).astype(np.float32).astype(np.int64)
            sc = np.where((dd != 0) | (dg > span[j]), sc - pen, sc)
            ok = (dq > 0) & (dq <= p.max_gap) & (dr != 0) & (dd <= p.bw)
            cand = np.where(ok, sc + f[j], NEG_INF)
            marked = np.zeros(i - lo, dtype=bool)
            px = pred[lo:i][ok]
            px = px[px >= lo]
            marked[(px - lo).astype(np.int64)] = True
            examined = _skip_cut(cand[::-1], marked[::-1], int(span[i]), p.max_chain_skip)[::-1]
            cand = np.where(examined, cand, NEG_INF)
            # ties keep the largest j: minimap2 scans j descending
            k = len(cand) - 1 - int(np.argmax(cand[::-1]))
            if cand[k] > best:
                best, bestj = cand[k], lo + k
        f[i] = best
        pred[i] = bestj
    return f, pred


def _skip_cut(cand_desc, marked_desc, span_i: int, max_skip: int) -> np.ndarray:
    """The examined mask of the descending predecessor scan under
    ``max_chain_skip``: the floored running count of non-improving marked
    steps is ``S_t - min(0, min S_s)``; the scan stops after the first
    step where it exceeds ``max_skip``."""
    valid = cand_desc != NEG_INF
    prev = np.concatenate(([np.int64(NEG_INF)], np.maximum.accumulate(cand_desc)[:-1]))
    improving = valid & (cand_desc > np.maximum(prev, span_i))
    inc = valid & marked_desc & ~improving
    s = np.cumsum(inc.astype(np.int64) - improving.astype(np.int64))
    over = (s - np.minimum(np.minimum.accumulate(s), 0)) > max_skip
    if not over.any():
        return np.ones(len(cand_desc), dtype=bool)
    out = np.zeros(len(cand_desc), dtype=bool)
    out[: int(np.argmax(over)) + 1] = True
    return out


def _bk_end(end: int, fe: int, f, pred, used, max_drop: int) -> int:
    """``mg_chain_bk_end``: where the walk back from ``end`` stops (a
    score valley deeper than ``max_drop`` ends it); marks what it probed."""
    i, max_s, max_i = int(end), 0, int(end)
    while True:
        used[i] = True
        i = int(pred[i])
        s = fe if i < 0 else fe - int(f[i])
        if s > max_s:
            max_s, max_i = s, i
        elif max_s - s > max_drop:
            break
        if i < 0 or used[i]:
            break
    return max_i


def backtrack_targets(f, pred, a: Anchors, p: Params) -> set:
    """The targets of the chains that ``mm_chain_backtrack`` keeps
    (score >= ``min_chain_score``, >= ``min_cnt`` anchors), peeled in
    descending score order, each anchor used once."""
    cand = np.flatnonzero(f >= p.min_chain_score)
    if len(cand) == 0:
        return set()
    order = cand[np.argsort(f[cand], kind="stable")][::-1]
    used = np.zeros(len(f), dtype=bool)
    targets = set()
    for end in order:
        if used[end]:
            continue
        fe = int(f[end])
        end_i = _bk_end(int(end), fe, f, pred, used, p.bw)
        n, i = 0, int(end)
        while i != end_i:
            n += 1
            used[i] = True
            i = int(pred[i])
        sc = fe if end_i < 0 else fe - int(f[end_i])
        if sc >= p.min_chain_score and n >= p.min_cnt:
            targets.add(int(a.rid[end]))
    return targets


def count(a: Anchors, p: Params) -> int:
    """The query's overlap count: targets with a kept chain.  With a
    constant span (no HPC) a target's best score decides, since
    ``min_cnt`` follows from ``min_chain_score``; with HPC spans the
    backtrack decides."""
    if len(a) == 0:
        return 0
    f, pred = chain_dp(a, p)
    if p.hpc:
        return len(backtrack_targets(f, pred, a, p))
    run_start = np.flatnonzero(np.concatenate([[True], a.rid[1:] != a.rid[:-1]]))
    return int((np.maximum.reduceat(f, run_start) >= p.min_chain_score).sum())
