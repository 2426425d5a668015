"""Target minimizer index: an array-relational design.

Where minimap2 builds a bucketed hash table (`index.c`), the TPU-native
design is a *sorted postings array*: minimizer hashes sorted ascending
with parallel (rid, pos, strand) arrays.  Lookup is a batched binary
search (``searchsorted``) — branch-free, fully vectorisable, and
shardable across devices by hash range or by target shard.

The occurrence cutoff reproduces ``mm_idx_cal_max_occ`` +
``mm_mapopt_update`` (SURVEY.md C15): ``thres`` is the
``floor((1-f)*n_distinct)``-th smallest per-distinct-minimizer count
plus one, clamped to ``[min_mid_occ, max_mid_occ]``; query seeds whose
target occurrence exceeds ``mid_occ`` are dropped (the ava presets use
``-e0``, so no high-frequency sampling).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from ..platform import OverlapParams
from .encode import encode_seq
from .sketch import sketch_read


@dataclass
class TargetIndex:
    """Device-friendly sorted minimizer index over the target read set."""

    keys: np.ndarray  # [N] uint64 minimizer hash, sorted ascending
    rid: np.ndarray  # [N] int32 target read id
    pos: np.ndarray  # [N] int32 position of k-mer end on target
    strand: np.ndarray  # [N] int8
    names: list  # [T] target read names (bytes)
    lengths: np.ndarray  # [T] int32 target read lengths
    mid_occ: int
    params: OverlapParams
    # lexicographic order of names, used for the dual/self masks
    name_rank: np.ndarray = field(default=None)  # [T] int32

    @property
    def n_targets(self) -> int:
        return len(self.names)

    def occurrence(self, hashes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(start, count) of each query hash in the postings array."""
        start = np.searchsorted(self.keys, hashes, side="left")
        end = np.searchsorted(self.keys, hashes, side="right")
        return start, end - start


def calc_mid_occ(counts_per_distinct: np.ndarray, params: OverlapParams) -> int:
    """``mm_idx_cal_max_occ`` + the ``mm_mapopt_update`` clamps."""
    n = len(counts_per_distinct)
    if params.mid_occ_frac <= 0 or n == 0:
        return np.iinfo(np.int32).max
    kth = int((1.0 - params.mid_occ_frac) * n)
    kth = min(kth, n - 1)
    thres = int(np.partition(counts_per_distinct, kth)[kth]) + 1
    mid_occ = max(thres, params.min_mid_occ)
    if params.max_mid_occ > params.min_mid_occ:
        mid_occ = min(mid_occ, params.max_mid_occ)
    return mid_occ


# the device sketch's blocking, the reference's (ops/index.py:86-87):
# super-batches of SUPER batches of B reads padded to L, M minimizer slots
SKETCH_SUPER, SKETCH_B, SKETCH_L = 8, 128, 4096
SKETCH_M = SKETCH_L // 2


def _host_sketch(codes: np.ndarray, params: OverlapParams):
    """One read's exact host sketch as index arrays ``(hash, pos, strand)``."""
    mz = sketch_read(codes, params.k, params.w, params.hpc)
    return (mz.key >> np.uint64(8)).astype(np.uint64), mz.pos.astype(np.int32), mz.strand.astype(np.int8)


def _sketch_reads_device(seqs, params: OverlapParams, lengths, torch_device=None):
    """Sketch many reads with the batched torch sketch (``sketch_core``)
    on ``torch_device``, the reference's ``_sketch_reads_device``
    (ops/index.py:69-148).

    Returns per-read ``(hash, pos, strand)`` arrays equal to the host
    sketch's: rows longer than ``SKETCH_L``, rows with more than
    ``SKETCH_M`` minimizers and rows that :func:`needs_scalar_sketch`
    flags (ambiguous bases) are sketched on the host by
    :func:`sketch_read`, the reference's exactness rule.  The 32-bit
    sketch cannot take the PacBio/HPC parameters: those raise
    ``ValueError``, where the reference stops on an assertion.
    ``torch_device`` defaults to ``cuda:0`` and raises without CUDA.
    """
    import logging

    import torch

    from .encode import make_batches
    from .sketch import needs_scalar_sketch
    from .sketch_torch import sketch_core

    if 2 * params.k > 32 or params.hpc:
        raise ValueError(
            f"the device sketch takes 2k <= 32 without HPC (k={params.k}, hpc={params.hpc})"
        )
    if torch_device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the device sketch needs CUDA: no CUDA device is available")
        torch_device = torch.device("cuda", 0)
    torch_device = torch.device(torch_device)
    per_read = [None] * len(seqs)
    short_rows = [i for i, s in enumerate(seqs) if len(s) <= SKETCH_L]
    host_rows = [i for i, s in enumerate(seqs) if len(s) > SKETCH_L]
    for i in host_rows:
        per_read[i] = _host_sketch(encode_seq(seqs[i]), params)
    batches = make_batches(
        [seqs[i] for i in short_rows], ids=short_rows, batch_size=SKETCH_B, pad_to=SKETCH_L,
        pow2_lengths=False, pad_batch=True,
    )
    for off in range(0, len(batches), SKETCH_SUPER):
        group = batches[off : off + SKETCH_SUPER]
        codes = np.concatenate([b.codes for b in group])
        lens = np.concatenate([b.lengths for b in group])
        ids = np.concatenate([b.ids for b in group])
        mhash, mpos, mstrand, mcount = (
            t.cpu().numpy()
            for t in sketch_core(
                torch.from_numpy(codes).to(torch_device), torch.from_numpy(lens).to(torch_device),
                k=params.k, w=params.w, max_minimizers=SKETCH_M,
            )
        )
        for row in np.flatnonzero(ids >= 0):
            rid, row_codes, cnt = ids[row], codes[row, : lens[row]], mcount[row]
            if cnt > SKETCH_M or needs_scalar_sketch(row_codes, params.k, params.w, False):
                per_read[rid] = _host_sketch(row_codes, params)
                host_rows.append(rid)
            else:
                per_read[rid] = (
                    mhash[row, :cnt].astype(np.uint64),
                    mpos[row, :cnt].astype(np.int32),
                    mstrand[row, :cnt].astype(np.int8),
                )
    logging.getLogger("lrge").debug(
        "device sketch on %s: %d of %d rows sketched on the host", torch_device, len(host_rows), len(seqs)
    )
    return per_read


_SKETCH_PARAMS = None


def _sketch_worker_init(params):
    global _SKETCH_PARAMS
    _SKETCH_PARAMS = params


def _sketch_worker(seq: bytes):
    return _host_sketch(encode_seq(seq), _SKETCH_PARAMS)


def _sketch_reads_parallel(seqs, params, workers: int = None):
    """Sketch reads across forked worker processes (exact host sketch).

    Index sketching is embarrassingly parallel; forked numpy workers
    beat a serial sketch.
    """
    import multiprocessing as mp
    import os
    from concurrent.futures import ProcessPoolExecutor

    from ..engine import fork_unsafe

    workers = workers or os.cpu_count() or 2
    if fork_unsafe():
        # fork after CUDA (or any thread) is live hands the child an
        # unusable context or locked mutexes; sketch serially (the
        # per-read numpy sketch does not release the GIL long enough
        # for a thread pool to pay off)
        _sketch_worker_init(params)
        return [_sketch_worker(s) for s in seqs]
    ctx = mp.get_context("fork")
    try:
        with ProcessPoolExecutor(
            workers, mp_context=ctx, initializer=_sketch_worker_init, initargs=(params,)
        ) as pool:
            return list(pool.map(_sketch_worker, seqs, chunksize=64))
    except Exception as e:  # keep correctness if the pool misbehaves
        import logging

        logging.getLogger("lrge").warning(
            "parallel index sketching failed (%s); falling back to serial", e
        )
        _sketch_worker_init(params)
        return [_sketch_worker(s) for s in seqs]


def build_index(
    seqs: Sequence[bytes],
    names: Sequence[bytes],
    params: OverlapParams,
    device: str = "auto",
    threads: int = 8,
    torch_device=None,
) -> TargetIndex:
    """Sketch all target reads and build the sorted postings index.

    ``device="auto"`` sketches with the native sketcher, or across
    forked workers for large read sets without it; ``"device"`` with
    the torch sketch on ``torch_device`` (default ``cuda:0``; raises
    without CUDA; :func:`_sketch_reads_device`); any other value
    sketches serially.  All paths produce identical indexes (quirk rows
    use the exact scalar oracle everywhere).
    """
    all_keys = []
    all_rid = []
    all_pos = []
    all_strand = []
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    per_read = None
    if device == "device":
        per_read = _sketch_reads_device(seqs, params, lengths, torch_device)
    elif device == "auto":
        from .sketch import sketch_seqs_native

        res = sketch_seqs_native(seqs, params.k, params.w, params.hpc, threads)
        if res is not None:
            per_read = [
                (
                    (mz.key >> np.uint64(8)).astype(np.uint64),
                    mz.pos.astype(np.int32),
                    mz.strand.astype(np.int8),
                )
                for mz in res
            ]
        elif len(seqs) >= 2000 and threads > 1:
            per_read = _sketch_reads_parallel(seqs, params, workers=threads)
    if per_read is not None:
        for rid, entry in enumerate(per_read):
            key, pos, strand = entry
            if len(key) == 0:
                continue
            all_keys.append(key)
            all_rid.append(np.full(len(key), rid, dtype=np.int32))
            all_pos.append(pos)
            all_strand.append(strand)
        return _assemble_index(all_keys, all_rid, all_pos, all_strand, names, lengths, params)
    for rid, seq in enumerate(seqs):
        codes = encode_seq(seq)
        mz = sketch_read(codes, params.k, params.w, params.hpc)
        if len(mz.key) == 0:
            continue
        all_keys.append(mz.key >> np.uint64(8))  # index matches on hash only
        all_rid.append(np.full(len(mz.key), rid, dtype=np.int32))
        all_pos.append(mz.pos.astype(np.int32))
        all_strand.append(mz.strand.astype(np.int8))
    return _assemble_index(all_keys, all_rid, all_pos, all_strand, names, lengths, params)


def _assemble_index(all_keys, all_rid, all_pos, all_strand, names, lengths, params):
    if all_keys:
        keys = np.concatenate(all_keys)
        rid = np.concatenate(all_rid)
        pos = np.concatenate(all_pos)
        strand = np.concatenate(all_strand)
    else:
        keys = np.empty(0, dtype=np.uint64)
        rid = np.empty(0, dtype=np.int32)
        pos = np.empty(0, dtype=np.int32)
        strand = np.empty(0, dtype=np.int8)
    # sort by (hash, rid, pos): the per-read arrays are concatenated in
    # rid order with positions ascending, so ONE stable sort on the hash
    # preserves (rid, pos) within ties — much faster than lexsort on
    # multi-million-posting indices
    order = np.argsort(keys, kind="stable")
    keys, rid, pos, strand = keys[order], rid[order], pos[order], strand[order]
    # per-distinct counts for the occurrence cutoff, from run boundaries
    # of the sorted key array (no np.unique hashing pass)
    if len(keys):
        starts = np.flatnonzero(np.concatenate(([True], keys[1:] != keys[:-1])))
        counts = np.diff(np.concatenate((starts, [len(keys)])))
    else:
        counts = np.empty(0, dtype=np.int64)
    mid_occ = calc_mid_occ(counts, params)
    name_rank = np.argsort(np.argsort(np.array(names, dtype=object), kind="stable"), kind="stable")
    return TargetIndex(
        keys=keys,
        rid=rid,
        pos=pos,
        strand=strand,
        names=list(names),
        lengths=lengths,
        mid_occ=mid_occ,
        params=params,
        name_rank=name_rank.astype(np.int32),
    )
