"""Batched overlap counting on the device (PyTorch): the ONT and PacBio pipelines, one or more sub-indexes.

Port of the flatten branch of ``lrge_tpu/ops/overlap_jax.py::
sketch_map_many_core`` (:1895-1933) and what it runs: 2-bit unpack,
sketch, cuckoo (or bucketed) dictionary probe with the occurrence gate
and the q_occ filter, anchor expansion, the (rid, strand, rpos) sort,
the chain DP (a hand-written CUDA kernel on the card, see
``chain_kernel.py``), and the per-target reduce with the window-miss
and score-clip guards.  Optionally the reduce also compacts each row's
passing targets into a pair plane (ava and ``--use-min-ref``) and
applies the ``-F`` overhang filter from the chain extents that the
kernel's extent variant carries.  That fused pipeline
(``sketch_map_many``) runs on a single-sub index only.

Every other pipeline takes the reference's split form: one lookup that
returns each minimizer's unique-hash slot (``found``), then one map per
sub-index that reads the sub's posting range from ``found``
(``map_found_many``, overlap_jax.py:1647-1664); ``map_subs`` runs the
maps and merges them.  An index whose expected anchors per query
exceed the anchor buffer is split into ``n_sub`` sub-indexes by target
(lrge_tpu/device_engine.py:324-353); its ONT lookup is
``sketch_lookup_many``.  The PacBio/HPC preset (2k = 38-bit keys,
per-minimizer spans) always takes the split form: queries are sketched
on the host, their hashes arrive as two int32 planes and go through the
wide-key bucketed lookup (``pb_lookup_many``, overlap_jax.py:196-255,
:2233-2295); its map chains with spans through the kernel's span
variant and gates targets on ``min_cnt`` (overlap_jax.py:514-552,
:624-744, :928-942); ``pb_map_many`` runs both.  Every tensor lives on
the device of the index planes; integers ride in int64 except where a
plane or a kernel takes int32.

The index planes (:class:`GroupedDeviceIndex`) are built from the host
index with numpy builders copied from the reference, because the
reference module imports JAX when it loads.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..spans import span
from .chain_kernel import IMAX, chain_dp_skip
from .sketch_torch import INF, PB_LOMASK, PB_SPLIT, sketch_core

logger = logging.getLogger("lrge")

# passing-target slots per row in the pair plane (overlap_jax.py:48);
# rows with more passing targets are recomputed on the host
PAIR_CAP = 512
# under -F the count plane carries the pre-filter "had any mapping" bit here
HAD_BIT = 24

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
    "mid_occ", "bucket_bits", "bucket_kmax", "n_sub", "packed_rid_bits",
    "packed_dict_bits", "cuckoo_bits",
)
# the per-sub range planes: [n_sub, U] here, a list of n_sub [U] arrays
# in the reference
_SUB_FIELDS = ("lo", "hi", "loocc")


@dataclass
class GroupedDeviceIndex:
    """Device index of ``n_sub`` sub-indexes sharing one dictionary
    (``GroupedDeviceIndex`` of the reference), narrow or wide keys.

    Sub ``s`` holds the postings of the targets with ``rid % n_sub ==
    s``; each unique hash's postings are grouped by sub, in (rid, pos)
    order inside a group, so each sub's postings of a hash form one
    range.  Postings carry the target's name rank.  ``rps`` packs
    ``rank << (1 + pos_bits) | pos << 1 | strand`` when the widths fit
    (``packed_rid_bits`` = pos_bits; never for wide keys), else
    ``rid``/``pos`` hold the two planes.  ``loocc[s]`` packs each
    unique hash's sub-``s`` range start and width (``packed_dict_bits``
    = width bits); otherwise ``lo[s]``/``hi[s]`` hold the range planes
    (all three ``[n_sub, U]``).  ``uoff`` holds the global ranges, for
    the lookup's occurrence gate.  With ``cuckoo_bits`` > 0 (one sub,
    narrow keys, packed ranges), ``uhash``/``uoff``/``loocc`` live in
    cuckoo-slot space and ``boff`` is a dummy; otherwise
    ``uhash``/``uoff``/``boff`` form the bucketed dictionary.  Wide
    (PacBio/HPC, 2k = 38-bit) keys split into ``uhash`` = hash >> 19 and
    ``uhash_lo`` = hash & 0x7FFFF and always take the bucketed
    dictionary.  Packed layouts keep zero dummies (``[1]``, or ``[n_sub,
    1]`` for the range planes) in the planes they replace, as the
    reference does.  The fused single-sub ONT pipeline feeds the map the
    lookup's own ranges (the ``pre_ranges`` form); every other pipeline
    reads each sub's ranges from ``found`` (:func:`found_ranges`)."""

    rid: torch.Tensor
    pos: torch.Tensor
    rank: torch.Tensor
    mid_occ: int
    uhash: torch.Tensor
    uoff: torch.Tensor
    boff: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    bucket_bits: int
    bucket_kmax: int
    n_sub: int
    uhash_lo: torch.Tensor | None
    wide: bool
    packed_rid_bits: int
    rps: torch.Tensor | None
    packed_dict_bits: int
    loocc: torch.Tensor | None
    tlen: torch.Tensor
    cuckoo_bits: int

    @classmethod
    def from_host(cls, index, device: torch.device, n_sub: int = 1, bucket_bits: int = 22):
        """Build the planes of ``n_sub`` sub-indexes from a host
        ``TargetIndex`` (numpy) and move them to ``device``; ``None``
        (logged at INFO) when every posting was pruned or a wide index's
        bucketed dictionary cannot be built."""
        with span("planes.host"):
            keys, rid, pos, strand = _pruned_postings(index)
            N = len(keys)
            if N == 0:
                logger.info("no device index: every posting is above the occurrence cutoff")
                return None
            hash_bits = 2 * index.params.k
            wide = hash_bits > 31
            if wide:
                keys32 = None
                ustart = np.flatnonzero(np.concatenate(([True], keys[1:] != keys[:-1])))
            else:
                keys32 = (keys.astype(np.uint32) ^ np.uint32(0x80000000)).view(np.int32)
                ustart = np.flatnonzero(np.concatenate(([True], keys32[1:] != keys32[:-1])))
            U = len(ustart)
            uoff = np.concatenate([ustart, [N]]).astype(np.int32)
            occ = np.diff(uoff)
            # group each key run's postings by sub (stable: (rid, pos) order
            # kept inside a group); one sub keeps the order as it is
            if n_sub > 1:
                sub = (rid % n_sub).astype(np.int64)
                run_u = np.repeat(np.arange(U, dtype=np.int64), occ)
                order = np.lexsort((sub, run_u))
                rid, pos, strand = rid[order], pos[order], strand[order]
                # per-(unique, sub) posting counts: the reference's np.add.at
                # as one bincount
                counts = np.bincount(run_u * n_sub + sub[order], minlength=U * n_sub).reshape(U, n_sub)
            else:
                counts = occ[:, None]
            # each (unique, sub) range's absolute start, [U, n_sub + 1]
            soff = np.concatenate(
                [np.zeros((U, 1), np.int64), np.cumsum(counts, axis=1, dtype=np.int64)], axis=1
            ) + ustart[:, None]
            # the posting plane carries name ranks (the no-dual gate compares ranks)
            rank_of = index.name_rank.astype(np.int32)
            rid_g = rank_of[rid]
            pos_g = (pos.astype(np.int32) << 1) | strand.astype(np.int32)
            uh_lo = None
            if wide:
                uh_u = keys[ustart].astype(np.uint64)
                uh_plane = (uh_u >> np.uint64(PB_SPLIT)).astype(np.int32)
                uh_lo = (uh_u & np.uint64(PB_LOMASK)).astype(np.int32)
            else:
                uh_plane = keys32[ustart]
                uh_u = (uh_plane.view(np.uint32) ^ np.uint32(0x80000000)).astype(np.uint64)
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
            if wide and bucket_bits == 0:
                # the wide lookup has no other dictionary
                logger.info(
                    "no device index: the wide-key bucketed dictionary has a bucket of more than 16 keys"
                )
                return None
            no_pack = os.environ.get("LRGE_NO_PACK") == "1"
            T = len(index.name_rank)
            rid_bits = max(1, int(T - 1).bit_length()) if T else 1
            pos_bits = max(1, int(pos_g.max() >> 1).bit_length())
            packed_rid_bits = 0
            rps = None
            if not no_pack and not wide and rid_bits + pos_bits + 1 <= 31:
                packed_rid_bits = pos_bits
                rps = (rid_g << (1 + pos_bits)) | pos_g
            # the widest (unique, sub) range sets the packed width field
            occ_bits = max(1, int(counts.max()).bit_length())
            lo_bits = max(1, int(N).bit_length())
            packed_dict_bits = 0
            loocc = None
            if not no_pack and lo_bits + occ_bits <= 31:
                packed_dict_bits = occ_bits
                loocc = (soff[:, :-1].T << occ_bits) | counts.T  # [n_sub, U]
            # 2-probe cuckoo dictionary (one sub, narrow keys); a
            # non-convergent walk keeps the bucketed planes
            cuckoo_bits = 0
            if (
                n_sub == 1 and packed_dict_bits and not wide and hash_bits <= 30
                and os.environ.get("LRGE_NO_CUCKOO") != "1"
            ):
                built = _build_cuckoo(uh_u.astype(np.uint32))
                if built is not None:
                    cpos, cuckoo_bits = built
                    C = 1 << cuckoo_bits
                    ckey_raw = np.full(C, np.uint32(1 << hash_bits), dtype=np.uint32)
                    ckey_raw[cpos] = uh_u.astype(np.uint32)
                    uh_plane = (ckey_raw ^ np.uint32(0x80000000)).view(np.int32)
                    lc = np.zeros(C, dtype=np.int32)  # empty slots: occ 0
                    lc[cpos] = loocc[0]
                    loocc = lc[None]
                    uoff = lc  # the lookup's occurrence-gate plane
                    bucket_bits = 0
                    boff = np.zeros(1, dtype=np.int32)
            dummy = np.zeros(1, dtype=np.int32)
            sub_dummy = np.zeros((n_sub, 1), dtype=np.int32)
            tlen = _rank_order(index)
        with span("planes.copy"):
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
                lo=put(sub_dummy if packed_dict_bits else soff[:, :-1].T),
                hi=put(sub_dummy if packed_dict_bits else soff[:, 1:].T),
                bucket_bits=bucket_bits,
                bucket_kmax=kmax,
                n_sub=n_sub,
                uhash_lo=put(uh_lo),
                wide=wide,
                packed_rid_bits=packed_rid_bits,
                rps=put(rps),
                packed_dict_bits=packed_dict_bits,
                loocc=put(loocc),
                tlen=put(tlen),
                cuckoo_bits=cuckoo_bits,
            )

    @classmethod
    def from_jax_planes(cls, planes: dict, device: torch.device):
        """Carry a reference index across: ``planes`` maps the reference
        ``GroupedDeviceIndex`` field names to numpy arrays (0-d for the
        integer fields; for ``lo``, ``hi`` and ``loocc`` the reference's
        list of ``n_sub`` per-sub arrays, or their ``[n_sub, U]`` stack;
        ``rps``/``loocc``/``uhash_lo`` absent or None when unused)."""
        kw = {name: int(planes[name]) for name in _INT_FIELDS}
        kw["wide"] = bool(planes.get("wide", False))
        for name in (
            "rid", "pos", "rank", "uhash", "uoff", "boff", "lo", "hi", "uhash_lo", "rps", "loocc", "tlen",
        ):
            a = planes.get(name)
            if a is not None and name in _SUB_FIELDS:
                a = np.stack([np.asarray(x) for x in a]).reshape(kw["n_sub"], -1)
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
    # built on the device: a host-built constant would be a blocking copy
    # that no CUDA graph can capture (ops/program.py)
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=codes_p.device)
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


def _f32_scalar(value: float, device: torch.device) -> torch.Tensor:
    """A 0-d float32 tensor of ``np.float32(value)``, filled on ``device``
    (no host copy, so capturable; the comparisons stay float32)."""
    return torch.full((), float(np.float32(value)), dtype=torch.float32, device=device)


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
    frac = _f32_scalar(q_occ_frac, dev)
    return (
        (n_mini > mid_occ)
        & (cnt_by_slot > mid_occ)
        & (cnt_by_slot.to(torch.float32) > n_mini.to(torch.float32) * frac)
    )


def _q_occ_drop_wide(qhi, qlo, pad, mid_occ, q_occ_frac):
    """:func:`_q_occ_drop_narrow` over two-plane (wide) query hashes.  The
    reference's stable two-key sort becomes one stable sort of ``hi <<
    32 | lo`` (both planes < 2^19), padding folded above every real key."""
    B, M = qhi.shape
    dev = qhi.device
    key = torch.where(pad, (IMAX << 32) | IMAX, (qhi << 32) | qlo)
    sh, sslot = torch.sort(key, dim=1, stable=True)
    pos = torch.arange(M, device=dev).expand(B, M)
    ones = torch.ones((B, 1), dtype=torch.bool, device=dev)
    change = sh[:, 1:] != sh[:, :-1]
    run_start = torch.cummax(torch.where(torch.cat([ones, change], 1), pos, -1), 1).values
    run_end_at = torch.where(torch.cat([change, ones], 1), pos, IMAX)
    run_end = torch.cummin(run_end_at.flip(1), 1).values.flip(1)
    run_cnt = run_end - run_start + 1
    cnt_by_slot = torch.empty_like(run_cnt).scatter_(1, sslot, run_cnt)
    n_mini = (~pad).sum(dim=1)[:, None]
    frac = _f32_scalar(q_occ_frac, dev)
    return (
        (n_mini > mid_occ)
        & (cnt_by_slot > mid_occ)
        & (cnt_by_slot.to(torch.float32) > n_mini.to(torch.float32) * frac)
    )


def _pb_probe(qhi, qlo, uh_hi, uh_lo, boff, *, hash_bits, bucket_bits, bucket_kmax):
    """Bucketed dictionary probe for two-plane (wide) hashes: the
    unique-hash slot per minimizer (-1 miss).  The bucket is the hash's
    top ``bucket_bits``, taken from ``qhi`` alone or from both planes;
    padding (``qhi`` = -1) clips to bucket 0.  Gates are the caller's."""
    shift = hash_bits - bucket_bits
    if shift >= PB_SPLIT:
        ub = qhi >> (shift - PB_SPLIT)
    else:
        ub = (qhi << (PB_SPLIT - shift)) | (qlo >> shift)
    ub = ub.clamp(0, (1 << bucket_bits) - 1)
    bo = _gatherw(boff, ub, 2)
    b0, b1 = bo[..., 0], bo[..., 1]
    K = bucket_kmax
    cstart = b0.clamp(0, max(uh_hi.shape[0] - K, 0))
    win_hi = _gatherw(uh_hi, cstart, K)  # [B, M, K]
    win_lo = _gatherw(uh_lo, cstart, K)
    pos = cstart[..., None] + torch.arange(K, device=qhi.device)
    hit = (
        (pos >= b0[..., None]) & (pos < b1[..., None])
        & (win_hi == qhi[..., None]) & (win_lo == qlo[..., None])
    )
    return torch.where(hit, pos, -1).max(dim=-1).values


def pb_lookup_core(qhi, qlo, gi: GroupedDeviceIndex, *, hash_bits, q_occ_frac):
    """Wide-key lookup of host-sketched query hashes (``[B, M]``, ``qhi``
    -1 on padding): the unique-hash slot of each minimizer with the
    occurrence gate, the padding gate and the q_occ filter applied (-1 =
    no anchors)."""
    qhi, qlo = qhi.long(), qlo.long()
    pad = qhi < 0
    found = _pb_probe(
        qhi, qlo, gi.uhash, gi.uhash_lo, gi.boff, hash_bits=hash_bits,
        bucket_bits=gi.bucket_bits, bucket_kmax=gi.bucket_kmax,
    )
    uo = _gatherw(gi.uoff, found.clamp(min=0), 2)
    occg = torch.where(found >= 0, uo[..., 1] - uo[..., 0], 0)
    gate = (found >= 0) & ~pad & (occg > 0) & (occg <= gi.mid_occ)
    if q_occ_frac > 0:
        gate = gate & ~_q_occ_drop_wide(qhi, qlo, pad, gi.mid_occ, q_occ_frac)
    return torch.where(gate, found, -1)


def pb_lookup_many(qhi, qlo, gi: GroupedDeviceIndex, *, hash_bits, q_occ_frac):
    """:func:`pb_lookup_core` over a super-batch ``[NB, B, M]``, in one
    pass over the flattened rows."""
    NB, B, M = qhi.shape
    return pb_lookup_core(
        qhi.reshape(NB * B, M), qlo.reshape(NB * B, M), gi, hash_bits=hash_bits,
        q_occ_frac=q_occ_frac,
    ).reshape(NB, B, M)


def found_ranges(found, gi: GroupedDeviceIndex, sub: int = 0):
    """Each minimizer's posting range ``(lo, occ)`` in sub-index ``sub``
    from its unique-hash slot (``found``, -1 = none: occ 0), through
    ``loocc[sub]`` or ``lo[sub]``/``hi[sub]`` (``map_found_core``'s own
    gather, overlap_jax.py:1647-1664)."""
    fc = found.clamp(min=0)
    if gi.packed_dict_bits:
        lo_occ = _gather1(gi.loocc[sub], fc)
        lo = lo_occ >> gi.packed_dict_bits
        occ = torch.where(found >= 0, lo_occ & ((1 << gi.packed_dict_bits) - 1), 0)
    else:
        lo = _gather1(gi.lo[sub], fc)
        occ = torch.where(found >= 0, _gather1(gi.hi[sub], fc) - lo, 0)
    return lo, occ


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


def _seg_best(f, boundary, want_slot=False):
    """Segmented best score over rid runs: a monotone run id packed above
    the score (clipped at 2^15-2) turns the segmented max into one cummax.
    With ``want_slot``, also each run's slot of its best score, the
    LARGEST slot among ties (the backtrack's peel order): a second
    run-id-packed cummax over the positions that equal their running max.
    Returns ``(best_f, best_slot or None)``."""
    FB = 15
    if f.shape[1] > (1 << FB):
        raise ValueError("packed segmented reduce needs A <= 32768")
    runid = torch.cumsum(boundary.long(), dim=1)
    fq = f.clamp(-1, (1 << FB) - 2) + 1  # NEG/invalid -> 0
    pk = (runid << FB) | fq
    seg = torch.cummax(pk, dim=1).values
    best_f = (seg & ((1 << FB) - 1)) - 1
    if not want_slot:
        return best_f, None
    slots = torch.arange(f.shape[1], device=f.device).expand_as(f)
    # every run's first slot is a record, so the cummax never leaks across runs
    rec = torch.cummax(torch.where(pk == seg, (runid << FB) | slots, -1), dim=1).values
    return best_f, rec & ((1 << FB) - 1)


def _extent_filter(f, rid_s, key2_s, valid_s, boundary, run_end, min_score, ext):
    """``-F`` per rid run, decided from its best chain (which the backtrack
    peels intact): ``(passing, had_any, suspicious)``.  ``filter_mode``
    ``"internal"`` drops internal matches (``mapping.rs:59-77``);
    ``"overhang"`` drops overhang-heavy ones (the ``--use-min-ref``
    comparison, ``twoset.rs:493-517``).  A row is suspicious when a best
    chain holds a valley the backtrack would trim, or was dropped while a
    same-target secondary chain could still pass: only the host decides
    those (overlap_jax.py:943-1008)."""
    B, A = f.shape
    best_f, best_slot = _seg_best(f, boundary, want_slot=True)
    score_ok = run_end & valid_s & (best_f >= min_score)
    at_best = lambda x: x.gather(1, best_slot)
    span = ext["span"]
    s_best = at_best(ext["starts"])
    cnt_best = at_best(ext["cnt"])
    rs = (s_best >> 16) + 1 - span
    re_ = at_best(ext["rpos"]) + 1
    qs_c = (s_best & 0xFFFF) + 1 - span
    qe_c = at_best(ext["qpos"]) + 1
    qlen = ext["qlen"][:, None]
    rev = (at_best(key2_s) & 1) == 1
    qs = torch.where(rev, qlen - qe_c, qs_c)
    qe = torch.where(rev, qlen - qs_c, qe_c)
    tlen = _gather1(ext["tlen"], rid_s)
    ov = torch.where(
        rev,
        torch.minimum(qs, tlen - re_) + torch.minimum(qlen - qe, rs),
        torch.minimum(qs, rs) + torch.minimum(qlen - qe, tlen - re_),
    )
    maplen = torch.maximum(qe - qs, re_ - rs).clamp(min=1)
    # float32 as in the reference: float64 would flip boundary rows
    ratio = _f32_scalar(ext["ratio"], f.device)
    if ext["mode"] == "internal":
        dropped = (ov.to(torch.float32) / maplen.to(torch.float32)) < ratio
    else:
        dropped = ov > (maplen.to(torch.float32) * ratio).long()  # truncation, as int32()
    idxs = torch.arange(A, device=f.device).expand(B, A)
    run_len = idxs - torch.cummax(torch.where(boundary, idxs, -1), dim=1).values + 1
    sec_possible = (run_len - cnt_best) * span >= min_score
    valley = (at_best(ext["rmf"]) & 1) == 1
    suspicious = (score_ok & (valley | (dropped & sec_possible))).any(dim=1)
    return score_ok & ~dropped, score_ok.any(dim=1), suspicious


def _reduce_counts(
    f, broke, rid_s, key2_s, valid_s, W, min_score, *, want_pairs=False, extents=None, cnt=None,
    min_cnt=3,
):
    """Per-row unique-target counts, the exactness flag (``W+1`` when
    some anchor's DP may have missed a predecessor outside the window,
    a score reached the reduce's clip, or an ``-F`` or ``min_cnt``
    decision is the host's) and, with ``want_pairs``, the ``[B, min(A,
    PAIR_CAP)]`` plane of passing target ranks (-1 padded; ``None``
    otherwise).  With ``extents`` the counts are filtered and carry the
    pre-filter had-mapping bit at ``HAD_BIT``.  With ``cnt`` (the span
    DP's chain anchor counts) a target also needs its best chain to hold
    ``min_cnt`` anchors; a run whose best chain passes the score but not
    ``min_cnt`` makes the row inexact, since a lower secondary chain
    might pass (overlap_jax.py:928-942)."""
    if extents is not None and cnt is not None:
        raise ValueError("the -F extent filter is constant-span only")
    B, A = f.shape
    dev = f.device
    ones = torch.ones((B, 1), dtype=torch.bool, device=dev)
    change = rid_s[:, 1:] != rid_s[:, :-1]
    boundary = torch.cat([ones, change], 1)
    run_end = torch.cat([change, ones], 1)
    suspicious = None
    if extents is None and cnt is None:
        seg_f, _ = _seg_best(f, boundary)
        passing = run_end & valid_s & (seg_f >= min_score)
        counts = passing.sum(dim=1)
    elif cnt is not None:
        # the chain that survives intact ends at the run's best-f anchor
        # (largest slot among ties): read its anchor count there
        best_f, best_slot = _seg_best(f, boundary, want_slot=True)
        cnt_best = cnt.gather(1, best_slot)
        score_ok = run_end & valid_s & (best_f >= min_score)
        passing = score_ok & (cnt_best >= min_cnt)
        suspicious = (score_ok & (cnt_best < min_cnt)).any(dim=1)
        counts = passing.sum(dim=1)
    else:
        passing, had_any, suspicious = _extent_filter(
            f, rid_s, key2_s, valid_s, boundary, run_end, min_score, extents
        )
        counts = passing.sum(dim=1) | (had_any.long() << HAD_BIT)  # count <= A < 2^24
    pairs = None
    if want_pairs:
        # passing run-end rids to the front, in slot order (stable sort)
        PMAX = min(A, PAIR_CAP)
        idxs = torch.arange(A, device=dev).expand(B, A)
        pk_s, order = torch.sort(torch.where(passing, idxs, IMAX), dim=1, stable=True)
        pairs = torch.where(pk_s[:, :PMAX] != IMAX, rid_s.gather(1, order[:, :PMAX]), -1)
    # window-miss detector: exact when the (rid, strand) run fits the
    # ring or the skip break fired inside the visible window
    idxs = torch.arange(A, device=dev).expand(B, A)
    boundary2 = torch.cat([ones, key2_s[:, 1:] != key2_s[:, :-1]], 1)
    run_start = torch.cummax(torch.where(boundary2, idxs, -1), dim=1).values
    run_depth = torch.where(valid_s, idxs - run_start, 0)
    missed = valid_s & (run_depth > W) & (broke == 0)
    inexact = missed.any(dim=1) | (f >= (1 << 15) - 2).any(dim=1)
    if suspicious is not None:
        inexact = inexact | suspicious
    return counts, torch.where(inexact, W + 1, 0), pairs


def expand_sort(
    lo, occ, mps, qlen, qdualrank, qselfrid, gi: GroupedDeviceIndex, *, k, num_anchors, no_dual,
    no_diag, with_spans=False,
):
    """Anchor expansion of rows whose posting ranges ``(lo, occ)`` the
    lookup already fetched (packed_pos, rank postings), the dual/diag
    masks, and the stable (key2, rpos) sort: the chain DP's ``[B, A]``
    inputs.  Returns ``(key2_s, rpos_s, qpos_s, valid_s, total)``
    (int64, bool; ``total`` is each row's anchor count before the cap
    ``A = num_anchors``).  With ``with_spans`` (the PacBio/HPC planes)
    ``mps`` packs ``pos << 9 | span << 1 | strand``, a reverse anchor's
    query position takes its own span, and ``qpos_s`` carries ``qpos <<
    8 | span`` (packed after the no-diag mask, which compares the plain
    position; overlap_jax.py:514-552)."""
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
    if with_spans:
        span_a = (mps_f >> 1) & 255
        mq = mps_f >> 9
        qpos = torch.where(strand == 0, mq, qlen[:, None] - mq + span_a - 2)
    else:
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
    if with_spans:
        qpos = (qpos << 8) | span_a
    # ---- stable sort by (key2, rpos): one int64 key (rpos >= 0)
    _, order = torch.sort((key2 << 32) | rpos, dim=1, stable=True)
    key2_s = key2.gather(1, order)
    return key2_s, rpos.gather(1, order), qpos.gather(1, order), key2_s != IMAX, total


def map_found_core(
    lo, occ, mps, qlen, qdualrank, qselfrid, gi: GroupedDeviceIndex, pen_gap, *,
    k, max_gap, bw, min_score, num_anchors, window, no_dual, no_diag, max_chain_skip,
    want_pairs=False, want_extents=False, overhang_ratio=0.2, filter_mode="internal",
    with_spans=False, min_cnt=3,
):
    """Map rows whose posting ranges ``(lo, occ)`` are known (the ONT
    lookup's own, or :func:`found_ranges`): :func:`expand_sort`, the
    chain DP, :func:`_reduce_counts`.  Returns ``(counts, n_anchors,
    max_run, pairs)``; ``n_anchors`` > ``num_anchors`` flags overflow.
    ``want_pairs`` and ``want_extents`` (the ``-F`` filter, with
    ``overhang_ratio`` and ``filter_mode``) are as in
    :func:`_reduce_counts`.  ``with_spans`` (PacBio/HPC planes) chains
    with per-anchor spans and gates targets on ``min_cnt``.
    ``want_extents`` launches the kernel's extent variant,
    ``with_spans`` its span variant."""
    if want_extents and with_spans:
        raise ValueError("the -F extent filter is constant-span only")
    key2_s, rpos_s, qpos_s, valid_s, total = expand_sort(
        lo, occ, mps, qlen, qdualrank, qselfrid, gi, k=k, num_anchors=num_anchors,
        no_dual=no_dual, no_diag=no_diag, with_spans=with_spans,
    )
    rid_s = torch.where(valid_s, key2_s >> 1, IMAX)
    # ---- chain DP (the CUDA kernel on the card)
    i32 = lambda x: x.to(torch.int32).contiguous()
    dp = chain_dp_skip(
        i32(key2_s), i32(rpos_s), i32(qpos_s), i32(valid_s), i32(valid_s.sum(dim=1)),
        pen_gap, span=k, max_gap=max_gap, bw=bw, max_skip=max_chain_skip, window=window,
        extents=want_extents, spans=with_spans,
    )
    f, broke = dp[0].long(), dp[1]
    extents = None
    if want_extents:
        cnt, starts, rmf = (x.long() for x in dp[2:])
        extents = dict(
            starts=starts, rmf=rmf, cnt=cnt, rpos=rpos_s, qpos=qpos_s, qlen=qlen, tlen=gi.tlen,
            ratio=overhang_ratio, span=k, mode=filter_mode,
        )
    counts, max_run, pairs = _reduce_counts(
        f, broke, rid_s, key2_s, valid_s, window, min_score, want_pairs=want_pairs, extents=extents,
        cnt=dp[2].long() if with_spans else None, min_cnt=min_cnt,
    )
    return counts, total, max_run, pairs


def _sketch_lookup_rows(codes, lengths, gi: GroupedDeviceIndex, p):
    """Sketch and lookup over a super-batch of codes (``[NB, B, L]`` uint8,
    4 = ambiguous) flattened to one row axis: ``(qlen, found, mps,
    mcount, lo, occ)``."""
    NB, B, L = codes.shape
    codes = codes.reshape(NB * B, L)
    qlen = lengths.reshape(NB * B).long()
    return (qlen, *sketch_lookup_core(codes, qlen, gi, k=p.k, w=p.w, q_occ_frac=p.q_occ_frac))


def sketch_lookup_many(codes, lengths, gi: GroupedDeviceIndex, params):
    """The ONT lookup alone over a super-batch of codes (``[NB, B, L]``
    uint8, 4 = ambiguous, as the reference's multi-sub path takes them),
    in one pass over the flattened rows (the flatten branch of
    ``sketch_lookup_many_core``, overlap_jax.py:1544-1571): ``(found, mps,
    mcount)``, ``[NB, B, M]``, ``[NB, B, M]`` and ``[NB, B]``.  Every
    sub-index maps from this one lookup."""
    NB, B, _ = codes.shape
    _, found, mps, mcount, _, _ = _sketch_lookup_rows(codes, lengths, gi, params)
    return found.reshape(NB, B, -1), mps.reshape(NB, B, -1), mcount.reshape(NB, B)


def sketch_anchors(codes, lengths, qdualrank, qselfrid, gi: GroupedDeviceIndex, params, *, num_anchors):
    """The chain DP's inputs over a super-batch of codes (``[NB, B, L]``
    uint8), as the ONT path builds them (:func:`sketch_map_many`, whose
    2-bit packed codes read an ambiguous base as ``A``; on a multi-sub
    index :func:`sketch_lookup_many` and the first sub's
    :func:`map_found_many`, up to the chain DP): ``(key2_s, rpos_s,
    qpos_s, valid_s)``, each ``[NB * B, num_anchors]``."""
    p = params
    if gi.n_sub == 1:
        codes = codes & 3
    qlen, found, mps, _, lo, occ = _sketch_lookup_rows(codes, lengths, gi, p)
    if gi.n_sub > 1:
        lo, occ = found_ranges(found, gi)
    return expand_sort(
        lo, occ, mps, qlen, qdualrank.reshape(-1).long(), qselfrid.reshape(-1).long(), gi, k=p.k,
        num_anchors=num_anchors, no_dual=p.no_dual, no_diag=p.no_diag,
    )[:4]


def sketch_map_many(
    codes_p, lengths, qdualrank, qselfrid, gi: GroupedDeviceIndex, params, *, num_anchors, window,
    want_pairs=False, want_extents=False, overhang_ratio=0.2, filter_mode="internal",
):
    """Whole ONT pipeline over a super-batch flattened to one row axis,
    on a single-sub index (the map takes the lookup's own ranges).

    ``codes_p`` is 2-bit packed (``[NB, B, L//4]`` uint8).  Returns the
    ``[NB, B, 4]`` int32 plane (counts, n_anchors, max_run, mcount) and
    the ``[NB, B, min(A, PAIR_CAP)]`` int32 plane of passing target
    ranks with ``want_pairs`` (else ``None``).  ``want_extents`` applies
    the ``-F`` filter (:func:`map_found_core`)."""
    if gi.n_sub != 1:
        raise ValueError("the fused pipeline maps one sub-index: use sketch_lookup_many and map_subs")
    NB, B, _ = codes_p.shape
    p = params
    qlen, _, mps, mcount, lo, occ = _sketch_lookup_rows(
        _unpack2bit(codes_p, codes_p.shape[-1] * 4), lengths, gi, p
    )
    counts, n_anchors, max_run, pairs = map_found_core(
        lo, occ, mps, qlen, qdualrank.reshape(-1).long(), qselfrid.reshape(-1).long(), gi,
        p.chn_pen_gap(), k=p.k, max_gap=p.max_gap, bw=p.bw, min_score=p.min_chain_score,
        num_anchors=num_anchors, window=window, no_dual=p.no_dual, no_diag=p.no_diag,
        max_chain_skip=p.max_chain_skip, want_pairs=want_pairs, want_extents=want_extents,
        overhang_ratio=overhang_ratio, filter_mode=filter_mode,
    )
    plane = torch.stack([counts, n_anchors, max_run, mcount], dim=-1).reshape(NB, B, 4).to(torch.int32)
    if pairs is not None:
        pairs = pairs.reshape(NB, B, -1).to(torch.int32)
    return plane, pairs


# ---------------------------------------------------------------------------
# split form: one shared lookup, then a map from ``found`` per sub-index
# ---------------------------------------------------------------------------


def map_found_many(
    found, mps, qlen, qdualrank, qselfrid, gi: GroupedDeviceIndex, params, *, num_anchors, window,
    want_pairs=False, with_spans=False, sub=0,
):
    """:func:`map_found_core` of sub-index ``sub`` over a super-batch
    ``[NB, B, M]`` of lookup results (:func:`sketch_lookup_many`, or
    :func:`pb_lookup_many` with ``with_spans``: spans in ``mps``, the
    ``min_cnt`` gate), flattened to one row axis, with the ranges read
    from ``found``.  Returns ``(counts, n_anchors, max_run, pairs)``,
    each ``[NB, B]`` (pairs ``[NB, B, min(A, PAIR_CAP)]``, or ``None``)."""
    NB, B, M = found.shape
    p = params
    lo, occ = found_ranges(found.reshape(NB * B, M), gi, sub)
    out = map_found_core(
        lo, occ, mps.reshape(NB * B, M).long(), qlen.reshape(-1).long(), qdualrank.reshape(-1).long(),
        qselfrid.reshape(-1).long(), gi, p.chn_pen_gap(), k=p.k, max_gap=p.max_gap, bw=p.bw,
        min_score=p.min_chain_score, num_anchors=num_anchors, window=window, no_dual=p.no_dual,
        no_diag=p.no_diag, max_chain_skip=p.max_chain_skip, want_pairs=want_pairs,
        with_spans=with_spans, min_cnt=p.min_cnt,
    )
    return tuple(None if x is None else x.reshape(NB, B, *x.shape[1:]) for x in out)


def map_subs(
    found, mps, mcount, qlen, qdualrank, qselfrid, gi: GroupedDeviceIndex, params, *, num_anchors,
    window, want_pairs=False, with_spans=False,
):
    """:func:`map_found_many` once per sub-index, merged as the
    reference's collect merges them (device_engine.py:1143-1156): counts
    summed (a target lives in one sub), ``n_anchors`` and ``max_run``
    maxed, ``mcount`` ``[NB, B]`` the lookup's, the per-sub pair planes
    concatenated along the last axis.  Returns the ``[NB, B, 4]`` int32
    plane (counts, n_anchors, max_run, mcount) and the ``[NB, B, n_sub *
    min(A, PAIR_CAP)]`` int32 pair plane with ``want_pairs`` (else
    ``None``), as :func:`sketch_map_many` does."""
    outs = [
        map_found_many(
            found, mps, qlen, qdualrank, qselfrid, gi, params, num_anchors=num_anchors, window=window,
            want_pairs=want_pairs, with_spans=with_spans, sub=s,
        )
        for s in range(gi.n_sub)
    ]
    counts, n_anchors, max_run = (torch.stack([o[j] for o in outs]) for j in range(3))
    plane = torch.stack(
        [counts.sum(0), n_anchors.amax(0), max_run.amax(0), mcount.long()], dim=-1
    ).to(torch.int32)
    pairs = torch.cat([o[3] for o in outs], dim=-1).to(torch.int32) if want_pairs else None
    return plane, pairs


# ---------------------------------------------------------------------------
# PacBio/HPC: host-sketched planes and the wide-key lookup
# ---------------------------------------------------------------------------


def pb_anchors(qhi, qlo, mps, lengths, qdualrank, qselfrid, gi: GroupedDeviceIndex, params, *, num_anchors):
    """The span chain DP's inputs over a PacBio super-batch, as
    :func:`pb_map_many` builds them for its first sub-index: ``(key2_s,
    rpos_s, qpos_s, valid_s)``, each ``[NB * B, num_anchors]``."""
    NB, B, M = qhi.shape
    p = params
    found = pb_lookup_many(qhi, qlo, gi, hash_bits=2 * p.k, q_occ_frac=p.q_occ_frac)
    lo, occ = found_ranges(found.reshape(NB * B, M), gi)
    return expand_sort(
        lo, occ, mps.reshape(NB * B, M).long(), lengths.reshape(-1).long(), qdualrank.reshape(-1).long(),
        qselfrid.reshape(-1).long(), gi, k=p.k, num_anchors=num_anchors, no_dual=p.no_dual,
        no_diag=p.no_diag, with_spans=True,
    )[:4]


def pb_map_many(
    qhi, qlo, mps, mcount, lengths, qdualrank, qselfrid, gi: GroupedDeviceIndex, params, *,
    num_anchors, window, want_pairs=False,
):
    """Whole PacBio/HPC pipeline over a super-batch of host-sketched
    planes (``[NB, B, M]`` int32: ``qhi``/``qlo`` the 38-bit hash split
    at bit 19, -1 padding; ``mps`` = ``pos << 9 | span << 1 | strand``;
    ``mcount`` ``[NB, B]`` the true minimizer counts): the wide-key
    lookup (:func:`pb_lookup_many`), then :func:`map_subs` with spans,
    one map per sub-index.  Returns the ``[NB, B, 4]`` int32 plane
    (counts, n_anchors, max_run, mcount) and, with ``want_pairs``, the
    pair plane (else ``None``), as :func:`map_subs` does."""
    p = params
    found = pb_lookup_many(qhi, qlo, gi, hash_bits=2 * p.k, q_occ_frac=p.q_occ_frac)
    return map_subs(
        found, mps, mcount, lengths, qdualrank, qselfrid, gi, p, num_anchors=num_anchors, window=window,
        want_pairs=want_pairs, with_spans=True,
    )
