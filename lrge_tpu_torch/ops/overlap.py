"""Batched overlap counting on the device (PyTorch): the fused single-sub ONT pipeline.

Port of the flatten branch of ``lrge_tpu/ops/overlap_jax.py::
sketch_map_many_core`` (:1895-1933) and what it runs: 2-bit unpack,
sketch, cuckoo (or bucketed) dictionary probe with the occurrence gate
and the q_occ filter, anchor expansion, the (rid, strand, rpos) sort,
the chain DP (a hand-written CUDA kernel on the card, see
``chain_kernel.py``), and the per-target reduce with the window-miss
and score-clip guards.  Every tensor lives on the device of the index
planes; integers ride in int64 except where a plane or a kernel takes
int32.

The index planes (:class:`GroupedDeviceIndex`) are built from the host
index with numpy builders copied from the reference, because the
reference module imports JAX when it loads.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .chain_kernel import IMAX, chain_dp_skip
from .sketch import INF, sketch_core

# ---------------------------------------------------------------------------
# numpy builders, copied from lrge_tpu/ops/overlap_jax.py
# ---------------------------------------------------------------------------


def pack2bit_host(codes: np.ndarray) -> np.ndarray:
    """Host-side packer matching :func:`_unpack2bit` (numpy, code&3;
    the length axis must be a multiple of 4)."""
    c = codes & 3
    return (
        c[..., 0::4]
        | (c[..., 1::4] << 2)
        | (c[..., 2::4] << 4)
        | (c[..., 3::4] << 6)
    ).astype(np.uint8)


def minimizer_cap(L: int) -> int:
    """Minimizer-slot capacity for padded read length ``L``.

    Expected density is 2/(w+1) (~L/3 at w=5); 2L/5 leaves ~20%% slack
    for tie emission.  Reads that exceed the cap are detected exactly
    (``mcount`` > cap) and recomputed on the host, so this is a
    performance knob, not a correctness bound.  Rounded to 128.
    """
    return max(128, ((2 * L // 5) + 127) // 128 * 128)


def _rank_order(index) -> np.ndarray:
    """Target lengths reordered into name-rank space (postings carry
    ranks — see GroupedDeviceIndex.from_host)."""
    rank_of = index.name_rank.astype(np.int64)
    out = np.zeros(len(rank_of), dtype=np.int32)
    out[rank_of] = np.asarray(index.lengths, dtype=np.int32)
    return out


def _pruned_postings(index):
    """Global postings minus minimizers above the occurrence cutoff.

    The mid_occ filter depends only on index-side occurrences, so it is
    applied once at build time (exact; minimap2 applies the same test
    per query seed).  Keys are sorted, so per-key counts come from run
    boundaries (no hashing pass)."""
    keys_all = index.keys
    if len(keys_all):
        starts = np.flatnonzero(np.concatenate(([True], keys_all[1:] != keys_all[:-1])))
        run_counts = np.diff(np.concatenate((starts, [len(keys_all)])))
        keep = np.repeat(run_counts <= index.mid_occ, run_counts)
    else:
        keep = np.ones(0, dtype=bool)
    return keys_all[keep], index.rid[keep], index.pos[keep], index.strand[keep]


_CUCKOO_A1 = 0x9E3779B1  # odd multiply-shift constants (h1 / h2)
_CUCKOO_A2 = 0x85EBCA77


def _cuckoo_slots(mhash, cbits):
    """The two candidate cuckoo slots of a (raw uint32) minimizer hash
    (numpy build side; :func:`_cuckoo_slots_t` is the lookup side and
    must agree bit for bit)."""
    sh = 32 - cbits
    h1 = (mhash * np.uint32(_CUCKOO_A1)) >> np.uint32(sh)
    h2 = ((mhash ^ (mhash >> np.uint32(16))) * np.uint32(_CUCKOO_A2)) >> np.uint32(sh)
    return h1.astype(np.int32), h2.astype(np.int32)


def _build_cuckoo(keys_u32, *, load=0.45, max_rounds=500):
    """Place unique uint32 keys into a 2-choice cuckoo table.

    Parallel random-walk insertion: every pending key claims its current
    candidate slot with a random per-round priority; losers and evicted
    previous owners flip to their other candidate.  Deterministic (fixed
    seed).  The table is the power of two holding the keys at <= ``load``
    occupancy; a non-convergent walk retries once with a doubled table,
    and tables beyond 2^26 slots are refused.

    Returns ``(pos, cbits)`` or ``None`` (the caller keeps the bucketed
    dictionary)."""
    U = len(keys_u32)
    if U == 0:
        return None
    cbits = max(10, int(np.ceil(np.log2(max(U, 2) / load))))
    for cb in (cbits, cbits + 1):
        if cb > 26:
            return None
        built = _try_build_cuckoo(keys_u32, cb, max_rounds)
        if built is not None:
            return built
    return None


def _try_build_cuckoo(keys_u32, cbits, max_rounds):
    U = len(keys_u32)
    keys_u32 = keys_u32.astype(np.uint32)
    h1, h2 = _cuckoo_slots(keys_u32, cbits)
    h1 = h1.astype(np.int64)
    h2 = h2.astype(np.int64)
    idx = np.arange(U, dtype=np.int64)
    choice = np.zeros(U, dtype=bool)
    pos = h1.copy()
    owner = np.full(1 << cbits, -1, dtype=np.int64)
    pending = idx
    rng = np.random.default_rng(6)
    for _ in range(max_rounds):
        p_all = pos[pending]
        prev = owner[p_all].copy()
        perm = rng.permutation(len(pending))
        owner[p_all[perm]] = pending[perm]
        now = owner[p_all]
        won = now == pending
        evicted = np.unique(prev[(prev >= 0) & (prev != now)])
        movers = np.concatenate([pending[~won], evicted])
        if movers.size == 0:
            return pos, cbits
        choice[movers] ^= True
        pos[movers] = np.where(choice[movers], h2[movers], h1[movers])
        pending = movers
    return None


# ---------------------------------------------------------------------------
# device index planes
# ---------------------------------------------------------------------------

_INT_FIELDS = (
    "mid_occ", "bucket_bits", "bucket_kmax", "packed_rid_bits",
    "packed_dict_bits", "cuckoo_bits",
)


@dataclass
class GroupedDeviceIndex:
    """Single-sub, narrow-key device index (``GroupedDeviceIndex`` of
    the reference at ``n_sub == 1``).

    Postings carry the target's name rank.  ``rps`` packs ``rank <<
    (1 + pos_bits) | pos << 1 | strand`` when the widths fit
    (``packed_rid_bits`` = pos_bits), else ``rid``/``pos`` hold the two
    planes.  ``loocc`` packs each unique hash's posting-range start and
    width (``packed_dict_bits`` = width bits).  With ``cuckoo_bits`` >
    0, ``uhash``/``uoff``/``loocc`` live in cuckoo-slot space and
    ``boff`` is a dummy; otherwise ``uhash``/``uoff``/``boff`` form the
    bucketed dictionary.  Packed layouts keep ``[1]`` zero dummies in
    ``rid``/``pos``, as the reference does.  The per-sub range planes
    ``lo``/``hi`` of the reference are not kept: the lookup's own
    ranges feed the map (the ``pre_ranges`` form)."""

    rid: torch.Tensor
    pos: torch.Tensor
    rank: torch.Tensor
    mid_occ: int
    uhash: torch.Tensor
    uoff: torch.Tensor
    boff: torch.Tensor
    bucket_bits: int
    bucket_kmax: int
    packed_rid_bits: int
    rps: torch.Tensor | None
    packed_dict_bits: int
    loocc: torch.Tensor | None
    tlen: torch.Tensor
    cuckoo_bits: int

    @classmethod
    def from_host(cls, index, device: torch.device, bucket_bits: int = 22):
        """Build the planes from a host ``TargetIndex`` (numpy) and move
        them to ``device``; ``None`` when every posting was pruned."""
        keys, rid, pos, strand = _pruned_postings(index)
        N = len(keys)
        if N == 0:
            return None
        hash_bits = 2 * index.params.k
        if hash_bits > 31:
            raise NotImplementedError(
                "wide (PacBio/HPC) keys on the device: ROADMAP.md item 11"
            )
        keys32 = (keys.astype(np.uint32) ^ np.uint32(0x80000000)).view(np.int32)
        ustart = np.flatnonzero(np.concatenate(([True], keys32[1:] != keys32[:-1])))
        U = len(ustart)
        uoff = np.concatenate([ustart, [N]]).astype(np.int32)
        # the posting plane carries name ranks (the no-dual gate compares
        # ranks); one sub-index keeps the (key, rid, pos) order as it is
        rank_of = index.name_rank.astype(np.int32)
        rid_g = rank_of[rid]
        pos_g = (pos.astype(np.int32) << 1) | strand.astype(np.int32)
        occ = np.diff(uoff)
        uh = keys32[ustart]
        uh_u = (uh.view(np.uint32) ^ np.uint32(0x80000000)).astype(np.uint64)
        uh_plane = uh
        kmax = 8
        if bucket_bits > 0 and hash_bits > bucket_bits:
            ub = (uh_u >> np.uint64(hash_bits - bucket_bits)).astype(np.int64)
            boff = np.zeros((1 << bucket_bits) + 1, dtype=np.int32)
            np.add.at(boff, ub + 1, 1)
            np.cumsum(boff, out=boff)
            kmax = max(4, (int(np.max(np.diff(boff))) + 3) // 4 * 4)
            if kmax > 16:
                bucket_bits = 0
                boff = np.zeros(1, dtype=np.int32)
        else:
            bucket_bits = 0
            boff = np.zeros(1, dtype=np.int32)
        no_pack = os.environ.get("LRGE_NO_PACK") == "1"
        T = len(index.name_rank)
        rid_bits = max(1, int(T - 1).bit_length()) if T else 1
        pos_bits = max(1, int(pos_g.max() >> 1).bit_length())
        packed_rid_bits = 0
        rps = None
        if not no_pack and rid_bits + pos_bits + 1 <= 31:
            packed_rid_bits = pos_bits
            rps = (rid_g << (1 + pos_bits)) | pos_g
        occ_bits = max(1, int(occ.max()).bit_length())
        lo_bits = max(1, int(N).bit_length())
        packed_dict_bits = 0
        loocc = None
        if not no_pack and lo_bits + occ_bits <= 31:
            packed_dict_bits = occ_bits
            loocc = (uoff[:-1] << occ_bits) | occ.astype(np.int32)
        # 2-probe cuckoo dictionary; a non-convergent walk keeps the
        # bucketed planes
        cuckoo_bits = 0
        if packed_dict_bits and hash_bits <= 30 and os.environ.get("LRGE_NO_CUCKOO") != "1":
            built = _build_cuckoo(uh_u.astype(np.uint32))
            if built is not None:
                cpos, cuckoo_bits = built
                C = 1 << cuckoo_bits
                ckey_raw = np.full(C, np.uint32(1 << hash_bits), dtype=np.uint32)
                ckey_raw[cpos] = uh_u.astype(np.uint32)
                uh_plane = (ckey_raw ^ np.uint32(0x80000000)).view(np.int32)
                lc = np.zeros(C, dtype=np.int32)  # empty slots: occ 0
                lc[cpos] = loocc
                loocc = lc
                uoff = lc  # the lookup's occurrence-gate plane
                bucket_bits = 0
                boff = np.zeros(1, dtype=np.int32)
        dummy = np.zeros(1, dtype=np.int32)
        put = lambda a: None if a is None else torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.int32)
        ).to(device)
        return cls(
            rid=put(dummy if packed_rid_bits else rid_g),
            pos=put(dummy if packed_rid_bits else pos_g),
            rank=put(rank_of),
            mid_occ=int(index.mid_occ),
            uhash=put(uh_plane),
            uoff=put(uoff),
            boff=put(boff),
            bucket_bits=bucket_bits,
            bucket_kmax=kmax,
            packed_rid_bits=packed_rid_bits,
            rps=put(rps),
            packed_dict_bits=packed_dict_bits,
            loocc=put(loocc),
            tlen=put(_rank_order(index)),
            cuckoo_bits=cuckoo_bits,
        )

    @classmethod
    def from_jax_planes(cls, planes: dict, device: torch.device):
        """Carry a reference index across: ``planes`` maps the reference
        ``GroupedDeviceIndex`` field names to numpy arrays (0-d for the
        integer fields; the single sub-index's array for ``loocc``;
        ``rps``/``loocc`` absent or None when unpacked)."""
        if int(planes.get("n_sub", 1)) != 1 or bool(planes.get("wide", False)):
            raise NotImplementedError("multi-sub or wide indexes: ROADMAP.md items 11-12")
        kw = {name: int(planes[name]) for name in _INT_FIELDS}
        for name in ("rid", "pos", "rank", "uhash", "uoff", "boff", "rps", "loocc", "tlen"):
            a = planes.get(name)
            kw[name] = None if a is None else torch.tensor(
                np.asarray(a), dtype=torch.int32, device=device
            )
        return cls(**kw)


# ---------------------------------------------------------------------------
# lookup
# ---------------------------------------------------------------------------


def _unpack2bit(codes_p: torch.Tensor, L: int) -> torch.Tensor:
    """Expand 2-bit-packed base codes ``[..., L//4] uint8`` to
    ``[..., L] uint8`` (4 bases per byte, little-endian within the
    byte).  Ambiguous bases are not representable: the host recomputes
    their rows (sketch-quirk triage)."""
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=codes_p.device)
    u = (codes_p[..., :, None] >> shifts) & 3
    return u.reshape(*codes_p.shape[:-1], codes_p.shape[-1] * 4)[..., :L]


def _gather1(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` with out-of-range indices clamped (XLA's gather rule)."""
    return table[idx.clamp(0, table.shape[0] - 1)].long()


def _gatherw(table: torch.Tensor, idx: torch.Tensor, w: int) -> torch.Tensor:
    """``[..., w]`` consecutive entries starting at ``idx``; starts are
    clamped to ``[0, len(table)-w]``."""
    start = idx.clamp(0, max(table.shape[0] - w, 0))
    return torch.stack([_gather1(table, start + j) for j in range(w)], dim=-1)


def _as_key32(mhash: torch.Tensor) -> torch.Tensor:
    """The int32 value of ``mhash ^ 0x80000000`` (the planes' key form), in int64."""
    v = mhash ^ 0x80000000
    return v - ((v >> 31) << 32)


def _mul32(h: torch.Tensor, a: int) -> torch.Tensor:
    """``(h * a) mod 2^32`` for ``h`` < 2^32, without int64 overflow."""
    lo = (h & 0xFFFF) * a
    hi = (((h >> 16) * a) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def _cuckoo_slots_t(mhash: torch.Tensor, cbits: int):
    sh = 32 - cbits
    h1 = _mul32(mhash, _CUCKOO_A1) >> sh
    h2 = _mul32(mhash ^ (mhash >> 16), _CUCKOO_A2) >> sh
    return h1, h2


def _cuckoo_lookup(mhash, ckey, *, cuckoo_bits):
    """2-probe cuckoo lookup: the unique-hash slot per minimizer (-1 miss).
    Empty slots hold a sentinel above the ``2k``-bit hash range."""
    qk = _as_key32(mhash)
    h1, h2 = _cuckoo_slots_t(mhash, cuckoo_bits)
    k1 = _gather1(ckey, h1)
    k2 = _gather1(ckey, h2)
    return torch.where(k1 == qk, h1, torch.where(k2 == qk, h2, -1))


def _dict_lookup(mhash, uhash, boff, *, k, bucket_bits, bucket_kmax):
    """Bucketed dictionary probe: unique-hash slot per minimizer (-1 miss)."""
    qk = _as_key32(mhash)
    ub = (mhash >> (2 * k - bucket_bits)).clamp(max=(1 << bucket_bits) - 1)
    bo = _gatherw(boff, ub, 2)
    b0, b1 = bo[..., 0], bo[..., 1]
    K = bucket_kmax
    cstart = b0.clamp(0, max(uhash.shape[0] - K, 0))
    win = _gatherw(uhash, cstart, K)  # [B, M, K]
    pos = cstart[..., None] + torch.arange(K, device=mhash.device)
    hit = (pos >= b0[..., None]) & (pos < b1[..., None]) & (win == qk[..., None])
    # unique hashes are distinct: at most one probe slot hits
    return torch.where(hit, pos, -1).max(dim=-1).values


def _q_occ_drop_narrow(mhash, mid_occ, q_occ_frac):
    """mm_seed_mz_flt: drop query minimizers occurring > mid_occ times
    within the query AND > q_occ_frac of its minimizer count; inactive
    unless the query has > mid_occ minimizers."""
    B, M = mhash.shape
    dev = mhash.device
    sh, sslot = torch.sort(mhash, dim=1, stable=True)
    pos = torch.arange(M, device=dev).expand(B, M)
    ones = torch.ones((B, 1), dtype=torch.bool, device=dev)
    change = sh[:, 1:] != sh[:, :-1]
    run_start = torch.cummax(torch.where(torch.cat([ones, change], 1), pos, -1), 1).values
    run_end_at = torch.where(torch.cat([change, ones], 1), pos, IMAX)
    run_end = torch.cummin(run_end_at.flip(1), 1).values.flip(1)
    run_cnt = run_end - run_start + 1
    cnt_by_slot = torch.empty_like(run_cnt).scatter_(1, sslot, run_cnt)
    n_mini = (mhash != INF).sum(dim=1)[:, None]
    frac = torch.tensor(np.float32(q_occ_frac), device=dev)
    return (
        (n_mini > mid_occ)
        & (cnt_by_slot > mid_occ)
        & (cnt_by_slot.to(torch.float32) > n_mini.to(torch.float32) * frac)
    )


def sketch_lookup_core(codes, lengths, gi: GroupedDeviceIndex, *, k, w, q_occ_frac):
    """Sketch + index lookup + seed filters (``want_ranges=True`` form).

    Returns ``(found, mps, mcount, lo, occ)``: the unique-hash slot of
    each minimizer with every seed filter applied (-1 = no anchors),
    the packed query end position and strand, the raw minimizer count,
    and each minimizer's posting range (occ 0 on gated slots)."""
    M = minimizer_cap(codes.shape[1])
    mhash, mpos, mstrand, mcount = sketch_core(codes, lengths, k=k, w=w, max_minimizers=M)
    if gi.cuckoo_bits:
        found = _cuckoo_lookup(mhash, gi.uhash, cuckoo_bits=gi.cuckoo_bits)
        loocc = _gather1(gi.uoff, found.clamp(min=0))  # empty slots hold occ 0
        occg = torch.where(found >= 0, loocc & ((1 << gi.packed_dict_bits) - 1), 0)
        lo = loocc >> gi.packed_dict_bits
    else:
        found = _dict_lookup(
            mhash, gi.uhash, gi.boff, k=k, bucket_bits=gi.bucket_bits,
            bucket_kmax=gi.bucket_kmax,
        )
        uo = _gatherw(gi.uoff, found.clamp(min=0), 2)
        occg = torch.where(found >= 0, uo[..., 1] - uo[..., 0], 0)
        lo = uo[..., 0]
    gate = (found >= 0) & (occg > 0) & (occg <= gi.mid_occ) & (mhash != INF)
    if q_occ_frac > 0:
        gate = gate & ~_q_occ_drop_narrow(mhash, gi.mid_occ, q_occ_frac)
    found = torch.where(gate, found, -1)
    mps = mpos * 2 + mstrand
    return found, mps, mcount, lo, torch.where(gate, occg, 0)


# ---------------------------------------------------------------------------
# map: expansion, sort, chain DP, reduce
# ---------------------------------------------------------------------------


def _fill_forward(x: torch.Tensor) -> torch.Tensor:
    """Nearest earlier nonzero of each slot (0 before the first)."""
    slots = torch.arange(x.shape[1], device=x.device)
    last = torch.cummax(torch.where(x != 0, slots, -1), dim=1).values
    return torch.where(last >= 0, x.gather(1, last.clamp(min=0)), 0)


def _seg_best(f, boundary):
    """Segmented best score over rid runs: a monotone run id packed above
    the score (clipped at 2^15-2) turns the segmented max into one cummax."""
    FB = 15
    if f.shape[1] > (1 << FB):
        raise ValueError("packed segmented reduce needs A <= 32768")
    runid = torch.cumsum(boundary.long(), dim=1)
    fq = f.clamp(-1, (1 << FB) - 2) + 1  # NEG/invalid -> 0
    seg = torch.cummax((runid << FB) | fq, dim=1).values
    return (seg & ((1 << FB) - 1)) - 1


def _reduce_counts(f, broke, rid_s, key2_s, valid_s, W, min_score):
    """Per-row unique-target counts and the exactness flag (``W+1`` when
    some anchor's DP may have missed a predecessor outside the window,
    or a score reached the reduce's clip)."""
    B, A = f.shape
    dev = f.device
    ones = torch.ones((B, 1), dtype=torch.bool, device=dev)
    change = rid_s[:, 1:] != rid_s[:, :-1]
    seg_f = _seg_best(f, torch.cat([ones, change], 1))
    passing = torch.cat([change, ones], 1) & valid_s & (seg_f >= min_score)
    counts = passing.sum(dim=1)
    # window-miss detector: exact when the (rid, strand) run fits the
    # ring or the skip break fired inside the visible window
    idxs = torch.arange(A, device=dev).expand(B, A)
    boundary2 = torch.cat([ones, key2_s[:, 1:] != key2_s[:, :-1]], 1)
    run_start = torch.cummax(torch.where(boundary2, idxs, -1), dim=1).values
    run_depth = torch.where(valid_s, idxs - run_start, 0)
    missed = valid_s & (run_depth > W) & (broke == 0)
    inexact = missed.any(dim=1) | (f >= (1 << 15) - 2).any(dim=1)
    return counts, torch.where(inexact, W + 1, 0)


def map_found_core(
    lo, occ, mps, qlen, qdualrank, qselfrid, gi: GroupedDeviceIndex, pen_gap, *,
    k, max_gap, bw, min_score, num_anchors, window, no_dual, no_diag, max_chain_skip,
):
    """Map rows whose posting ranges ``(lo, occ)`` the lookup already
    fetched (the reference's ``pre_ranges`` form, packed_pos, rank
    postings).  Returns ``(counts, n_anchors, max_run)``; ``n_anchors`` >
    ``num_anchors`` flags overflow."""
    B, M = occ.shape
    A = num_anchors
    dev = occ.device
    # ---- anchor expansion: each live minimizer drops its posting offset
    # and query pos/strand at its first anchor slot; fill forward
    cum = torch.cumsum(occ, dim=1)
    total = cum[:, -1]
    prev_cum = cum - occ
    live = (occ > 0) & (prev_cum < A)
    tgt = torch.where(live, prev_cum, 0)
    OFF = A + 1
    zeros = torch.zeros((B, A), dtype=torch.int64, device=dev)
    s_adj = zeros.scatter_reduce(1, tgt, torch.where(live, lo - prev_cum + OFF, 0), "amax")
    s_mps = zeros.scatter_reduce(1, tgt, torch.where(live, mps + 1, 0), "amax")
    adj_f = _fill_forward(s_adj) - OFF
    mps_f = _fill_forward(s_mps) - 1
    slots = torch.arange(A, device=dev)[None, :]
    valid = slots < total.clamp(max=A)[:, None]
    p_idx = slots + adj_f
    if gi.packed_rid_bits:
        pr = _gather1(gi.rps, p_idx)
        rid = torch.where(valid, pr >> (1 + gi.packed_rid_bits), IMAX)
        rpos = torch.where(valid, (pr >> 1) & ((1 << gi.packed_rid_bits) - 1), 0)
        tstrand = pr & 1
    else:
        rid = torch.where(valid, _gather1(gi.rid, p_idx), IMAX)
        pp = _gather1(gi.pos, p_idx)
        rpos = torch.where(valid, pp >> 1, 0)
        tstrand = pp & 1
    strand = torch.where(valid, tstrand ^ (mps_f & 1), 0)
    mq = mps_f >> 1
    qpos = torch.where(strand == 0, mq, qlen[:, None] - mq + (k - 2))
    # ---- masks (MM_F_NO_DUAL in rank space / no-diag)
    drop = torch.zeros_like(valid)
    if no_dual:
        drop = drop | (valid & (rid < qdualrank[:, None]))
    if no_diag:
        drop = drop | (valid & (rid == qselfrid[:, None]) & (strand == 0) & (rpos == qpos))
    valid = valid & ~drop
    key2 = torch.where(valid, rid * 2 + strand, IMAX)
    # ---- stable sort by (key2, rpos): one int64 key (rpos >= 0)
    _, order = torch.sort((key2 << 32) | rpos, dim=1, stable=True)
    key2_s = key2.gather(1, order)
    rpos_s = rpos.gather(1, order)
    qpos_s = qpos.gather(1, order)
    valid_s = key2_s != IMAX
    rid_s = torch.where(valid_s, key2_s >> 1, IMAX)
    # ---- chain DP (the CUDA kernel on the card)
    i32 = lambda x: x.to(torch.int32).contiguous()
    f, broke = chain_dp_skip(
        i32(key2_s), i32(rpos_s), i32(qpos_s), i32(valid_s), i32(valid_s.sum(dim=1)),
        pen_gap, span=k, max_gap=max_gap, bw=bw, max_skip=max_chain_skip, window=window,
    )
    counts, max_run = _reduce_counts(f.long(), broke, rid_s, key2_s, valid_s, window, min_score)
    return counts, total, max_run


def sketch_map_many(codes_p, lengths, qdualrank, qselfrid, gi: GroupedDeviceIndex, params, *, num_anchors, window):
    """Whole ONT pipeline over a super-batch flattened to one row axis.

    ``codes_p`` is 2-bit packed (``[NB, B, L//4]`` uint8).  Returns the
    ``[NB, B, 4]`` int32 plane (counts, n_anchors, max_run, mcount)."""
    NB, B, Lq = codes_p.shape
    L = Lq * 4
    R = NB * B
    codes = _unpack2bit(codes_p, L).reshape(R, L)
    qlen = lengths.reshape(R).long()
    p = params
    _, mps, mcount, lo, occ = sketch_lookup_core(
        codes, qlen, gi, k=p.k, w=p.w, q_occ_frac=p.q_occ_frac
    )
    counts, n_anchors, max_run = map_found_core(
        lo, occ, mps, qlen, qdualrank.reshape(R).long(), qselfrid.reshape(R).long(), gi,
        p.chn_pen_gap(), k=p.k, max_gap=p.max_gap, bw=p.bw, min_score=p.min_chain_score,
        num_anchors=num_anchors, window=window, no_dual=p.no_dual, no_diag=p.no_diag,
        max_chain_skip=p.max_chain_skip,
    )
    return torch.stack([counts, n_anchors, max_run, mcount], dim=-1).reshape(NB, B, 4).to(torch.int32)
