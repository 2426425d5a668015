"""The target index: minimizer hashes sorted with their (rid, pos,
strand), and minimap2's occurrence cut (``mm_idx_cal_max_occ`` with the
``mm_mapopt_update`` clamps)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .params import Params


@dataclass
class Index:
    keys: np.ndarray  # [N] uint64 hash, ascending
    rid: np.ndarray  # [N] int32
    pos: np.ndarray  # [N] int32
    strand: np.ndarray  # [N] int8
    name_rank: np.ndarray  # [T] rank of each target's name
    mid_occ: int

    def occurrence(self, hashes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        start = np.searchsorted(self.keys, hashes, side="left")
        return start, np.searchsorted(self.keys, hashes, side="right") - start


def mid_occ(counts_per_distinct: np.ndarray, p: Params) -> int:
    n = len(counts_per_distinct)
    if p.mid_occ_frac <= 0 or n == 0:
        return np.iinfo(np.int32).max
    kth = min(int((1.0 - p.mid_occ_frac) * n), n - 1)
    occ = max(int(np.partition(counts_per_distinct, kth)[kth]) + 1, p.min_mid_occ)
    if p.max_mid_occ > p.min_mid_occ:
        occ = min(occ, p.max_mid_occ)
    return occ


def build(sketches: list, names: list, p: Params) -> Index:
    """The index of the targets' sketches (one ``Minimizers`` a target,
    in target order)."""
    keys, rid, pos, strand = [], [], [], []
    for r, mz in enumerate(sketches):
        if len(mz.key):
            keys.append(mz.key >> np.uint64(8))
            rid.append(np.full(len(mz.key), r, dtype=np.int32))
            pos.append(mz.pos.astype(np.int32))
            strand.append(mz.strand.astype(np.int8))
    if keys:
        keys, rid, pos, strand = (np.concatenate(a) for a in (keys, rid, pos, strand))
    else:
        keys, rid, pos, strand = (np.empty(0, dt) for dt in (np.uint64, np.int32, np.int32, np.int8))
    # one stable sort on the hash keeps (rid, pos) order within a hash
    order = np.argsort(keys, kind="stable")
    keys, rid, pos, strand = keys[order], rid[order], pos[order], strand[order]
    if len(keys):
        starts = np.flatnonzero(np.concatenate(([True], keys[1:] != keys[:-1])))
        counts = np.diff(np.concatenate((starts, [len(keys)])))
    else:
        counts = np.empty(0, dtype=np.int64)
    name_rank = np.argsort(np.argsort(np.array(names, dtype=object), kind="stable"), kind="stable")
    return Index(keys, rid, pos, strand, name_rank.astype(np.int32), mid_occ(counts, p))
