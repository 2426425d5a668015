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


# the descending steps that ``chain_dp_many`` evaluates at once: for
# every anchor, then for those that the first width does not settle
# (on rows of 30,000-80,000 anchors, 20-40% faster than one width of 64)
WIDTHS = (32, 64, 256)


@dataclass
class _Columns:
    """Anchors as int64 columns."""

    rpos: np.ndarray
    qpos: np.ndarray
    span: np.ndarray


def _links(c: _Columns, i, j, p: Params) -> tuple:
    """``(sc, ok)`` of the links from anchors ``j`` to anchors ``i``
    (broadcast): minimap2's ``comp_sc`` score, without ``f[j]``, and
    whether the gap allows the link."""
    dq = c.qpos[i] - c.qpos[j]
    dr = c.rpos[i] - c.rpos[j]
    dd = np.abs(dr - dq)
    dg = np.minimum(dq, dr)
    sc = np.minimum(dg, c.span[j])
    lin = np.float32(p.chn_pen_gap()) * dd.astype(np.float32) + np.float32(p.chn_pen_skip()) * dg.astype(np.float32)
    logp = np.where(dd >= 1, mg_log2((dd + 1).astype(np.float32)), np.float32(0.0))
    pen = (lin + np.float32(0.5) * logp).astype(np.float32).astype(np.int64)
    sc = np.where((dd != 0) | (dg > c.span[j]), sc - pen, sc)
    ok = (dq > 0) & (dq <= p.max_gap) & (dr != 0) & (dd <= p.bw)
    return sc, ok


def _scan_one(i: int, lo: int, c: _Columns, f, pred, p: Params) -> tuple:
    """Anchor ``i``'s best score and predecessor over the window ``[lo,
    i)``, scanned as minimap2 does: j descending, cut by
    ``max_chain_skip``, ties to the largest j."""
    best, bestj = c.span[i], -1
    if lo < i:
        j = np.arange(lo, i)
        sc, ok = _links(c, i, j, p)
        cand = np.where(ok, sc + f[j], NEG_INF)
        marked = np.zeros(i - lo, dtype=bool)
        px = pred[lo:i][ok]
        px = px[px >= lo]
        marked[(px - lo).astype(np.int64)] = True
        examined = _skip_cut(cand[::-1], marked[::-1], int(c.span[i]), p.max_chain_skip)[::-1]
        cand = np.where(examined, cand, NEG_INF)
        # ties keep the largest j: minimap2 scans j descending
        k = len(cand) - 1 - int(np.argmax(cand[::-1]))
        if cand[k] > best:
            best, bestj = cand[k], lo + k
    return best, bestj


def chain_dp_scan(a: Anchors, p: Params) -> tuple[np.ndarray, np.ndarray]:
    """``(f, p)``: each anchor's best chain score and predecessor, over
    every predecessor within ``max_gap`` and ``max_chain_iter``, with
    minimap2's ``max_chain_skip`` break; one anchor at a time, in
    minimap2's order.  ``chain_dp_many`` is held to it."""
    n = len(a)
    f = np.zeros(n, dtype=np.int64)
    pred = np.full(n, -1, dtype=np.int64)
    st_key = a.rid.astype(np.int64) * 2 + a.strand
    c = _Columns(a.rpos.astype(np.int64), a.qpos.astype(np.int64), a.span.astype(np.int64))
    st = 0
    for i in range(n):
        while st < i and (st_key[st] != st_key[i] or c.rpos[i] > c.rpos[st] + p.max_gap):
            st += 1
        f[i], pred[i] = _scan_one(i, max(st, i - p.max_chain_iter), c, f, pred, p)
    return f, pred


def chain_dp_many(sets: list, p: Params) -> list:
    """``chain_dp_scan``'s ``(f, p)`` of each anchor set, in lockstep.

    A window never leaves its ``(rid, strand)`` group, so every group of
    every set is a lane, and step t settles each lane's t-th anchor at
    once.  A step evaluates the first ``WIDTHS[0]`` predecessors of the
    descending scan; the skip cut's running sums over them depend on
    those anchors alone (a predecessor lies below its anchor), so where
    the cut falls among them, or the window is no longer, the result is
    the scan's.  Other anchors take the next width, then the scan."""
    sizes = [len(a) for a in sets]
    n = int(sum(sizes))
    col = {k: np.concatenate([getattr(a, k) for a in sets] + [np.empty(0)]).astype(np.int64)
           for k in ("rid", "rpos", "qpos", "strand", "span")}
    row = np.repeat(np.arange(len(sets)), sizes)
    new = np.ones(n, dtype=bool)
    new[1:] = (col["rid"][1:] != col["rid"][:-1]) | (col["strand"][1:] != col["strand"][:-1]) | (row[1:] != row[:-1])
    gstart = np.flatnonzero(new)
    glen = np.diff(np.append(gstart, n))
    # a window starts at the group's first anchor within max_gap of rpos
    comp = ((np.cumsum(new) - 1) << 32) + col["rpos"]
    st = np.searchsorted(comp, comp - p.max_gap, side="left")
    lo = np.maximum(st, np.arange(n) - p.max_chain_iter)
    c = _Columns(col["rpos"], col["qpos"], col["span"])
    f = np.zeros(n, dtype=np.int64)
    pred = np.full(n, -1, dtype=np.int64)
    by_len = np.argsort(-glen, kind="stable")
    lane_start, lane_len = gstart[by_len], glen[by_len]
    for t in range(int(lane_len[0]) if n else 0):
        rest = lane_start[: int(np.searchsorted(-lane_len, -t, side="left"))] + t
        for width in WIDTHS:
            if len(rest):
                rest = _settle(rest, width, lo, c, f, pred, p)
        for i in rest:
            f[i], pred[i] = _scan_one(int(i), int(lo[i]), c, f, pred, p)
    out, off = [], 0
    for size in sizes:
        pr = pred[off : off + size]
        out.append((f[off : off + size], np.where(pr >= 0, pr - off, -1)))
        off += size
    return out


def _settle(i: np.ndarray, width: int, lo_all: np.ndarray, c: _Columns, f, pred, p: Params) -> np.ndarray:
    """Settle the anchors ``i`` (one a lane), whose windows start at
    ``lo_all[i]``, from their first ``width`` predecessors; returns those
    that these do not decide."""
    steps = np.arange(width)
    lo = lo_all[i]
    j = i[:, None] - 1 - steps
    jc = np.maximum(j, 0)
    sc, ok = _links(c, i[:, None], jc, p)
    ok &= j >= lo[:, None]
    cand = np.where(ok, sc + f[jc], NEG_INF)
    # the step of each predecessor that an ok anchor of the window names
    pj = pred[jc]
    at = np.where(ok & (pj >= lo[:, None]), np.minimum(i[:, None] - 1 - pj, width), width)
    marked = np.zeros((len(i), width + 1), dtype=bool)
    marked[np.arange(len(i))[:, None], at] = True
    over = _skip_over(cand, marked[:, :width], c.span[i][:, None], p.max_chain_skip)
    cut = over.any(axis=1)
    examined = steps <= np.where(cut, np.argmax(over, axis=1), width)[:, None]
    cand = np.where(examined, cand, NEG_INF)
    # ties keep the largest j: the first in descending order
    k = np.argmax(cand, axis=1)
    best = cand[np.arange(len(i)), k]
    take = best > c.span[i]
    settled = cut | (i - lo <= width)
    f[i[settled]] = np.where(take, best, c.span[i])[settled]
    pred[i[settled]] = np.where(take, i - 1 - k, -1)[settled]
    return i[~settled]


def _skip_over(cand_desc, marked_desc, span_i, max_skip: int) -> np.ndarray:
    """Along the last axis, the descending predecessor scan: where the
    floored running count of non-improving marked steps, ``S_t - min(0,
    min S_s)``, exceeds ``max_skip``."""
    valid = cand_desc != NEG_INF
    run = np.maximum.accumulate(cand_desc, axis=-1)
    prev = np.concatenate((np.full(run.shape[:-1] + (1,), NEG_INF, dtype=run.dtype), run[..., :-1]), axis=-1)
    improving = valid & (cand_desc > np.maximum(prev, span_i))
    inc = valid & marked_desc & ~improving
    s = np.cumsum(inc.astype(np.int64) - improving.astype(np.int64), axis=-1)
    return (s - np.minimum(np.minimum.accumulate(s, axis=-1), 0)) > max_skip


def _skip_cut(cand_desc, marked_desc, span_i: int, max_skip: int) -> np.ndarray:
    """The examined mask of the descending predecessor scan under
    ``max_chain_skip``: the scan stops after the first step where the
    count exceeds ``max_skip``."""
    over = _skip_over(cand_desc, marked_desc, span_i, max_skip)
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


def counts(sets: list, p: Params) -> list:
    """The overlap count of each anchor set: targets with a kept chain.
    With a constant span (no HPC) a target's best score decides, since
    ``min_cnt`` follows from ``min_chain_score``; with HPC spans the
    backtrack decides."""
    out = []
    for a, (f, pred) in zip(sets, chain_dp_many(sets, p)):
        if len(a) == 0:
            out.append(0)
        elif p.hpc:
            out.append(len(backtrack_targets(f, pred, a, p)))
        else:
            run_start = np.flatnonzero(np.concatenate([[True], a.rid[1:] != a.rid[:-1]]))
            out.append(int((np.maximum.reduceat(f, run_start) >= p.min_chain_score).sum()))
    return out
