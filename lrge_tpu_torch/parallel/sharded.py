"""Sharded target index and counting across devices (PyTorch).

Port of ``lrge_tpu/parallel/sharded.py``.  The target read set is
partitioned by read: shard ``s`` of ``S`` holds the targets with
``rid % S == s``, each as a complete grouped index of its own (its own
bucketed dictionary over its own keys, its own posting planes), so
chaining a (query, target) pair always stays on one device and a card
holds only its shard.  The occurrence cutoff (``mid_occ``) and every
packing decision come from the global index, before the split, so the
per-shard counts add up to the single-device engine's exactly.

Every query visits every shard: the query-side filters are computed
once, then each shard, on its own device, looks its keys up, expands,
sorts, runs the CUDA chain DP (``BASE`` on narrow ONT shards, ``SPAN``
on wide PacBio ones, through ``ops/chain_kernel.py::chain_dp_skip``) and
reduces (:func:`shard_count`).  The merge is the reference's all_gather
reduce (sharded.py:406-415): counts summed (a target lives on one
shard), ``n_anchors`` and ``max_run`` maxed, pair planes concatenated
(:func:`merge_shards`).  The engine runs each shard's work as a
program, a CUDA graph a (shard, bucket, mode) on the shard's device
(``ops/program.py``, :func:`sharded_count_programs`), the counterpart of
the reference's jitted ``sharded_count_fn``; :func:`sharded_count`, the
same work as eager calls, is its plain version.  Across processes the
query block rides a ring instead (``parallel/distributed.py``).

The reference pads every shard to common shapes so one compiled program
serves them all; here each shard keeps its own lengths (at least one
slot, with the reference's padding values).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.overlap import (
    PB_LOMASK, PB_SPLIT, GroupedDeviceIndex, _dict_lookup, _pb_probe, _pruned_postings, _q_occ_drop_narrow,
    _q_occ_drop_wide, found_ranges, map_found_core,
)
from ..ops.sketch_torch import INF
from ..spans import span

IMAX = np.iinfo(np.int32).max
# the per-shard planes, each a list of S int32 arrays
PLANES = ("post0", "post1", "uhash", "uhash_lo", "dict0", "dict1", "boff")


@dataclass
class ShardedGroupedIndex:
    """Host (numpy) planes of ``n_shards`` shards, as the reference's
    ``ShardedGroupedIndex`` lays them out, one list entry a shard.

    ``post0[s]`` packs ``rank << (1 + packed_rid_bits) | pos << 1 |
    strand`` when ``packed_rid_bits`` (else the rank, with ``post1[s]``
    = ``pos << 1 | strand``); ``uhash[s]`` is the shard's unique keys
    (narrow: the int32 key ``hash ^ 0x80000000``; wide: ``hash >> 19``,
    with ``uhash_lo[s]`` = ``hash & 0x7FFFF``); ``dict0[s]`` packs each
    unique key's range start and width when ``packed_dict_bits`` (else
    the start, with ``dict1[s]`` the end); ``boff[s]`` the bucket
    offsets over the top ``bucket_bits`` of the hash.  Planes that a
    packed layout replaces are one-slot zero dummies."""

    post0: list
    post1: list
    uhash: list
    uhash_lo: list
    dict0: list
    dict1: list
    boff: list
    rank: np.ndarray  # [T] int32 global name ranks (every shard's)
    mid_occ: int
    n_shards: int
    bucket_bits: int
    bucket_kmax: int
    packed_rid_bits: int
    packed_dict_bits: int
    wide: bool

    @classmethod
    def from_host(cls, index, n_shards: int):
        """Build from a host ``TargetIndex`` (the reference's :92-213);
        ``None`` when a shard's dictionary has a bucket of more than 24
        keys (the caller then runs the single-device grouped path)."""
        with span("planes.host"):
            pkeys, prid, ppos, pstrand = _pruned_postings(index)
            N = len(pkeys)
            S = n_shards
            hash_bits = 2 * index.params.k
            wide = hash_bits > 31
            shard_of = prid % S if N else np.zeros(0, np.int64)
            # global packing decisions
            T = len(index.name_rank)
            rid_bits = max(1, int(T - 1).bit_length()) if T else 1
            pos_bits = max(1, (int(ppos.max()) if N else 0).bit_length())
            packed_rid_bits = pos_bits if (not wide and rid_bits + pos_bits + 1 <= 31) else 0
            rank_of = index.name_rank.astype(np.int32)
            per_shard = []
            for s in range(S):
                sel = np.flatnonzero(shard_of == s)
                skeys = pkeys[sel]  # sorted: the global order is kept
                # postings carry name ranks; the partition keys on the rid
                srid = rank_of[prid[sel]]
                spos = (ppos[sel].astype(np.int32) << 1) | pstrand[sel].astype(np.int32)
                ustart = np.flatnonzero(np.concatenate(([True], skeys[1:] != skeys[:-1]))) if len(skeys) else (
                    np.zeros(0, np.int64)
                )
                uoff = np.concatenate([ustart, [len(skeys)]]).astype(np.int32)
                per_shard.append((skeys, srid, spos, ustart, uoff))
            max_n = max([1] + [len(x[0]) for x in per_shard])
            max_u = max([1] + [len(x[3]) for x in per_shard])
            # one bucket width for every shard, from the largest shard's uniques
            bucket_bits = min(max(int(np.ceil(np.log2(max(max_u, 2)))) + 2, 12), 26, hash_bits - 1)
            nb = 1 << bucket_bits
            max_occ = max([1] + [int(np.max(np.diff(x[4]))) for x in per_shard if len(x[3])])
            occ_bits = max(1, max_occ.bit_length())
            packed_dict_bits = occ_bits if max_n.bit_length() + occ_bits <= 31 else 0
            planes = {name: [] for name in PLANES}
            kmax = 4
            for skeys, srid, spos, ustart, uoff in per_shard:
                n, u = len(skeys), len(ustart)
                post0 = np.full(max(n, 1), IMAX, np.int32)
                post1 = np.zeros(1 if packed_rid_bits else max(n, 1), np.int32)
                if packed_rid_bits:
                    post0[:n] = (srid << (1 + packed_rid_bits)) | spos
                else:
                    post0[:n] = srid
                    post1[:n] = spos
                uhash = np.full(max(u, 1), IMAX, np.int32)
                uhash_lo = np.zeros(max(u, 1), np.int32)
                dict0 = np.zeros(max(u, 1), np.int32)
                dict1 = np.zeros(1 if packed_dict_bits else max(u, 1), np.int32)
                boff = np.zeros(nb + 1, np.int32)
                if u:
                    uh_u = skeys[ustart].astype(np.uint64)
                    if wide:
                        uhash[:u] = (uh_u >> np.uint64(PB_SPLIT)).astype(np.int32)
                        uhash_lo[:u] = (uh_u & np.uint64(PB_LOMASK)).astype(np.int32)
                    else:
                        uhash[:u] = (skeys[ustart].astype(np.uint32) ^ np.uint32(0x80000000)).view(np.int32)
                    if packed_dict_bits:
                        dict0[:u] = (uoff[:-1] << packed_dict_bits) | np.diff(uoff)
                    else:
                        dict0[:u] = uoff[:-1]
                        dict1[:u] = uoff[1:]
                    np.add.at(boff, (uh_u >> np.uint64(hash_bits - bucket_bits)).astype(np.int64) + 1, 1)
                    np.cumsum(boff, out=boff)
                    kmax = max(kmax, int(np.max(np.diff(boff))))
                for name, arr in zip(PLANES, (post0, post1, uhash, uhash_lo, dict0, dict1, boff)):
                    planes[name].append(arr)
            if kmax > 24:
                return None
            return cls(
                **planes, rank=rank_of, mid_occ=int(index.mid_occ), n_shards=S, bucket_bits=bucket_bits,
                bucket_kmax=(kmax + 3) // 4 * 4, packed_rid_bits=packed_rid_bits,
                packed_dict_bits=packed_dict_bits, wide=wide,
            )

    def place(self, devices, first: int = 0) -> list:
        """Shards ``first .. first + len(devices) - 1``, shard ``first + i``
        on ``devices[i]`` (the counterpart of ``device_put``), each a
        one-sub :class:`~lrge_tpu_torch.ops.overlap.GroupedDeviceIndex`
        whose bucketed dictionary and postings are the shard's own.  Its
        ``uoff`` and ``tlen`` are dummies: the sharded lookup reads
        occurrences from the ranges, and ``-F`` never runs sharded."""
        with span("planes.copy"):
            out = []
            for i, dev in enumerate(devices):
                s = first + i
                put = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
                dummy = put(np.zeros(1))
                p0, p1, d0, d1 = self.post0[s], self.post1[s], self.dict0[s], self.dict1[s]
                out.append(GroupedDeviceIndex(
                    rid=dummy if self.packed_rid_bits else put(p0),
                    pos=dummy if self.packed_rid_bits else put(p1),
                    rank=put(self.rank), mid_occ=self.mid_occ, uhash=put(self.uhash[s]), uoff=dummy,
                    boff=put(self.boff[s]),
                    lo=put(np.zeros((1, 1)) if self.packed_dict_bits else d0[None]),
                    hi=put(np.zeros((1, 1)) if self.packed_dict_bits else d1[None]),
                    bucket_bits=self.bucket_bits, bucket_kmax=self.bucket_kmax, n_sub=1,
                    uhash_lo=put(self.uhash_lo[s]) if self.wide else None, wide=self.wide,
                    packed_rid_bits=self.packed_rid_bits, rps=put(p0) if self.packed_rid_bits else None,
                    packed_dict_bits=self.packed_dict_bits, loocc=put(d0[None]) if self.packed_dict_bits else None,
                    tlen=dummy, cuckoo_bits=0,
                ))
            return out


def on_device(dev: torch.device):
    """``torch.cuda.device(dev)`` for a CUDA device (the chain kernel
    launches on ``dev``'s current stream), else a no-op."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def query_keep(q0, q1, mid_occ: int, q_occ_frac: float, wide: bool) -> torch.Tensor:
    """The query-side seed filters, once per block (the reference's
    :300-309): not padding and not dropped by the q_occ filter.  ``q0``
    is the narrow ``mhash`` (``0xFFFFFFFF`` padding) or the wide ``qhi``
    (-1 padding), ``q1`` the wide ``qlo``."""
    pad = q0 < 0 if wide else q0 == INF
    if q_occ_frac <= 0:
        return ~pad
    drop = _q_occ_drop_wide(q0, q1, pad, mid_occ, q_occ_frac) if wide else _q_occ_drop_narrow(q0, mid_occ, q_occ_frac)
    return ~(pad | drop)


def shard_count(gi: GroupedDeviceIndex, q0, q1, mps, qlen, qdual, qself, keep, params, *, num_anchors, window,
                want_pairs=False):
    """One shard's work on its own device (the reference's :312-349): the
    dictionary probe (two-plane under wide keys), the ranges and the
    ``occ <= mid_occ`` gate, then :func:`~lrge_tpu_torch.ops.overlap.
    map_found_core` (expansion, sort, the chain DP, the reduce).  Returns
    ``(counts, n_anchors, max_run, pairs)`` over the ``[R]`` rows."""
    p = params
    if gi.wide:
        found = _pb_probe(
            q0, q1, gi.uhash, gi.uhash_lo, gi.boff, hash_bits=2 * p.k, bucket_bits=gi.bucket_bits,
            bucket_kmax=gi.bucket_kmax,
        )
    else:
        found = _dict_lookup(q0, gi.uhash, gi.boff, k=p.k, bucket_bits=gi.bucket_bits, bucket_kmax=gi.bucket_kmax)
    lo, occ = found_ranges(found, gi)
    occ = torch.where(keep & (found >= 0) & (occ <= gi.mid_occ), occ, 0)
    return map_found_core(
        lo, occ, mps, qlen, qdual, qself, gi, p.chn_pen_gap(), k=p.k, max_gap=p.max_gap, bw=p.bw,
        min_score=p.min_chain_score, num_anchors=num_anchors, window=window, no_dual=p.no_dual,
        no_diag=p.no_diag, max_chain_skip=p.max_chain_skip, want_pairs=want_pairs, with_spans=gi.wide,
        min_cnt=p.min_cnt,
    )


def sharded_count(shards, q0, q1, mps, qlen, qdual, qself, params, *, num_anchors, window, want_pairs=False,
                  keep=None):
    """Count ``[R]`` query rows against every shard of ``shards`` and merge
    (the counterpart of ``sharded_count_fn``'s per-device body and its
    all_gather reduce).

    ``q0``/``q1`` are the query hash planes (``[R, M]``: the narrow
    ``mhash`` and a dummy, or the wide ``qhi``/``qlo``), ``mps`` the
    packed position plane (``pos << 1 | strand``, or ``pos << 9 | span <<
    1 | strand`` under wide keys), ``qlen``/``qdual``/``qself`` ``[R]``;
    all on one home device.  ``keep`` (:func:`query_keep`) is computed
    here unless given.  Every shard's work is enqueued, on its own
    device, before any result moves back.  Returns ``(counts, n_anchors,
    max_run, pairs)`` on the home device: counts summed, ``n_anchors``
    and ``max_run`` maxed, the ``[R, min(A, PAIR_CAP)]`` pair planes of
    the shards side by side (``None`` without ``want_pairs``)."""
    p = params
    wide = shards[0].wide
    q0, q1, mps, qlen, qdual, qself = (x.long() for x in (q0, q1, mps, qlen, qdual, qself))
    if keep is None:
        keep = query_keep(q0, q1, shards[0].mid_occ, p.q_occ_frac, wide)
    outs = []
    for gi in shards:
        dev = gi.uhash.device
        with on_device(dev):
            args = (x.to(dev, non_blocking=True) for x in (q0, q1, mps, qlen, qdual, qself, keep))
            outs.append(shard_count(gi, *args, p, num_anchors=num_anchors, window=window, want_pairs=want_pairs))
    return merge_shards(outs, q0.device)


def merge_shards(outs, home: torch.device):
    """The shards' ``(counts, n_anchors, max_run, pairs)`` merged on
    ``home`` (the reference's all_gather reduce): counts summed,
    ``n_anchors`` and ``max_run`` maxed, the pair planes side by side
    (None when the shards returned none)."""
    counts, n_anchors, max_run = (torch.stack([o[j].to(home) for o in outs]) for j in range(3))
    pairs = None if outs[0][3] is None else torch.cat([o[3].to(home) for o in outs], dim=-1)
    return counts.sum(0), n_anchors.amax(0), max_run.amax(0), pairs


def sharded_count_programs(programs, q0, q1, mps, keep, qlen, qdual, qself):
    """:func:`sharded_count` through the shards' programs (``ops/program.py``,
    branch ``"shard"``, one a shard, each on its shard's device): the
    int32 query planes (the ``"query"`` program's outputs, or a ring hop's
    plane; ``q1`` None under narrow keys) are copied into each program's
    static inputs without blocking and every program runs before any
    result moves back; the merge (:func:`merge_shards`) runs on ``q0``'s
    device, outside the graphs."""
    planes = [x for x in (q0, q1, mps, keep, qlen, qdual, qself) if x is not None]
    return merge_shards([prog.run(*planes) for prog in programs], q0.device)
