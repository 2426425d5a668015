"""Batched device overlap engine with exact host recompute (PyTorch).

Port of the single-device, fused single-sub ONT path of
``lrge_tpu/device_engine.py``: queries are partitioned into length
buckets, padded into super-batches, and each super-batch runs the whole
pipeline (``ops.overlap.sketch_map_many``) on ``device``.  Rows the
device cannot guarantee exactly (anchor-buffer overflow, a (rid,
strand) run longer than the DP window, minimizer-capacity truncation,
ambiguous bases) are recomputed by the exact host engine, so counts
equal the host engine's; every such row is tallied in
``fallback_triggers``.
"""

from __future__ import annotations

import logging
import os
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from lrge_tpu.engine import OverlapEngine
from lrge_tpu.native import native
from lrge_tpu.ops.encode import make_batches
from lrge_tpu.ops.index import TargetIndex

from .ops.overlap import GroupedDeviceIndex, minimizer_cap, pack2bit_host, sketch_map_many

logger = logging.getLogger("lrge")

# padded read lengths with their own pipeline shapes; longer reads take
# the exact host path
LENGTH_BUCKETS = (2048, 4096, 8192, 16384, 32768)


@dataclass
class BatchCounts:
    counts: np.ndarray  # [n] unique-target overlap counts
    had_mapping: np.ndarray  # [n] bool
    fallback_rows: int  # rows recomputed on host


def resolve_engine(engine: str, n_work_rows: int) -> str:
    """Resolve ``"auto"`` once the workload size is known: the device
    when CUDA is available and the run has at least
    ``LRGE_AUTO_MIN_ROWS`` (default 1000) work rows, else the host."""
    if engine != "auto":
        return engine
    if not torch.cuda.is_available():
        return "host"
    min_rows = int(os.environ.get("LRGE_AUTO_MIN_ROWS", "1000"))
    return "device" if n_work_rows >= min_rows else "host"


def default_device() -> torch.device:
    """The one CUDA device the engine runs on; raises without CUDA or
    with several cards (multi-GPU is ROADMAP.md item 13)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the device engine needs CUDA: no CUDA device is available")
    if torch.cuda.device_count() > 1:
        raise NotImplementedError(
            "more than one GPU: multi-GPU counting is ROADMAP.md item 13; "
            "pass an explicit device"
        )
    return torch.device("cuda", 0)


def _has_native_count() -> bool:
    return native is not None and hasattr(native, "count_many")


class DeviceOverlapEngine:
    def __init__(
        self,
        index: TargetIndex,
        *,
        device: torch.device,
        batch_size: int = 128,
        num_anchors: int = 4096,
        window: int = 32,
        length_buckets: tuple = LENGTH_BUCKETS,
        super_batch: int = 4,
    ):
        self.device = torch.device(device)
        self.index = index
        self.params = index.params
        self.host = OverlapEngine(index)
        self.batch_size = batch_size
        self.num_anchors = num_anchors
        self.window = window
        self.length_buckets = tuple(sorted(length_buckets))
        self.super_batch = super_batch
        self.fallback_triggers = Counter()  # why rows went to the host
        if self.params.hpc or 2 * self.params.k > 32:
            raise NotImplementedError("PacBio/HPC on the device: ROADMAP.md item 11")
        self.device_ok = len(index.keys) > 0
        self.gdev = None
        if not self.device_ok:
            return
        # the reference splits large indexes into sub-indexes to bound
        # per-query anchors; this port runs a single sub-index
        n_post = len(index.keys)
        n_uniq = max(1, len(np.unique(index.keys)))
        exp_anchors = (self.length_buckets[0] / 3.0) * (n_post / n_uniq)
        n_sub = max(1, int(np.ceil(exp_anchors / (0.6 * num_anchors))))
        if n_sub > 1:
            raise NotImplementedError(
                f"an index needing {n_sub} sub-indexes: ROADMAP.md item 12"
            )
        # ~4 buckets per unique key, capped so the offsets stay <= 256 MB
        bucket_bits = min(max(int(np.ceil(np.log2(max(n_uniq, 2)))) + 2, 12), 26)
        self.gdev = GroupedDeviceIndex.from_host(index, self.device, bucket_bits=bucket_bits)
        if self.gdev is None:
            self.device_ok = False  # every posting pruned by the occurrence cutoff

    def _self_ranks(self, names) -> np.ndarray:
        """Query self-ids in name-rank space (the posting planes carry ranks)."""
        rank_of = self.index.name_rank
        out = np.empty(len(names), dtype=np.int32)
        for i, nm in enumerate(names):
            r = self.host._name_to_rid.get(nm, -1)
            out[i] = int(rank_of[r]) if r >= 0 else -1
        return out

    def _host_count_many(self, items):
        """Exact host counting (the native whole-pipeline kernel when built)."""
        if _has_native_count():
            return self.host.count_overlaps_many(items)
        return [self.host.count_overlaps(nm, sq) for nm, sq in items]

    def triage_flags(self, live, n_anchors, cap, max_run, mcount, mcap, codes, lengths):
        """Flag rows whose device result cannot be guaranteed exact and
        tally ``fallback_triggers``; returns the "needs host recompute" mask."""
        t_over = (n_anchors > cap) & live
        t_miss = (max_run > self.window) & live & ~t_over
        t_mini = (mcount > mcap) & live & ~t_over & ~t_miss
        prior = t_over | t_miss | t_mini
        # ambiguous bases force the scalar sketch oracle; the padding
        # tail is code 4 too, so subtract it out
        n_amb = (codes >= 4).sum(axis=-1, dtype=np.int64)
        t_quirk = ((n_amb - (codes.shape[-1] - lengths)) > 0) & live & ~prior
        for key, trig in (
            ("anchor_overflow", t_over),
            ("window_miss", t_miss),
            ("minimizer_overflow", t_mini),
            ("sketch_quirk", t_quirk),
        ):
            c_t = int(trig.sum())
            if c_t:
                self.fallback_triggers[key] += c_t
        return prior | t_quirk

    def _host_share_fraction(self, n_dev_rows: int) -> float:
        """Fraction of device-eligible rows handed to the concurrent host
        engine, ``c*r / (c*r + 1)`` for ``c`` host cores and ``r`` the
        per-core host rate over the device rate.  ``r`` defaults to 0
        until it is calibrated on the card (``LRGE_HOST_RATE_RATIO``;
        ``LRGE_HOST_SHARE`` sets the share directly)."""
        if "LRGE_HOST_SHARE" in os.environ:
            share = float(os.environ["LRGE_HOST_SHARE"])
        elif not _has_native_count():
            share = 0.0
        else:
            c = os.cpu_count() or 2
            r = float(os.environ.get("LRGE_HOST_RATE_RATIO", "0"))
            share = min(0.9, c * r / (c * r + 1.0))
        if share <= 0 or native is None or n_dev_rows < 4 * self.batch_size:
            return 0.0
        return share

    def plan_rows(self, seqs, rows, *, warming=False):
        """Partition ``rows`` into ``(host_rows, host_share_rows, {L:
        bucket_rows})``: reads longer than the last bucket or in a sparse
        bucket (<= ``LRGE_DEVICE_MIN_ROWS``) go to the host, the shortest
        device-eligible rows form the host share, the rest fill buckets."""
        max_bucket = self.length_buckets[-1]
        long_rows = [i for i in rows if len(seqs[i]) > max_bucket]
        dev_rows = [i for i in rows if len(seqs[i]) <= max_bucket]
        min_rows = 0 if warming else int(os.environ.get("LRGE_DEVICE_MIN_ROWS", 32))
        host_share_rows = []
        if not warming:
            k = int(len(dev_rows) * self._host_share_fraction(len(dev_rows)))
            if k:
                by_len = sorted(dev_rows, key=lambda i: len(seqs[i]))
                host_share_rows = by_len[:k]
                dev_rows = by_len[k:]
        bucket_rows = {}
        lo = 0
        for L in self.length_buckets:
            rows_b = [i for i in dev_rows if lo < len(seqs[i]) <= L]
            lo = L
            if 0 < len(rows_b) <= min_rows:
                long_rows.extend(rows_b)
            else:
                bucket_rows[L] = rows_b
        return long_rows, host_share_rows, bucket_rows

    def warmup(self, lengths=None) -> None:
        """Run each bucket that the mapping pass will use once on two
        dummy reads (builds the chain kernel and primes the allocator)."""
        if not self.device_ok:
            return
        if _has_native_count():
            # build the host bucket dictionary off the hot path
            self.host._bucket_dict()
        min_rows = int(os.environ.get("LRGE_DEVICE_MIN_ROWS", 32))
        if lengths is not None:
            max_bucket = self.length_buckets[-1]
            dev_lens = sorted(x for x in lengths if x <= max_bucket)
            k = int(len(dev_lens) * self._host_share_fraction(len(dev_lens)))
            lengths = dev_lens[k:]
        lo = 0
        for L in self.length_buckets:
            if lengths is None or sum(lo < x <= L for x in lengths) > min_rows:
                fake = [b"ACGT" * (max(lo + 4, L // 2) // 4)] * 2
                self.count_batch([b"__warm0", b"__warm1"], fake, warming=True)
            lo = L

    def _dispatch(self, L, rows_b, seqs, qdualrank, qselfrid):
        """Enqueue the super-batches of one length bucket; yields
        ``(nb, A, codes, lengths, ids, packed_device_plane)``."""
        B = self.batch_size
        # anchor capacity scales with the padded length (A = L at the
        # default), dispatch depth shrinks to keep group work constant
        A = min(1 << 15, max(512, (self.num_anchors * L) // 4096))
        SUP = max(1, (self.super_batch * 4096) // L)
        batches = make_batches(
            [seqs[i] for i in rows_b], ids=rows_b, batch_size=B, pad_to=L,
            pow2_lengths=False, pad_batch=True,
        )
        p = self.params
        for off in range(0, len(batches), SUP):
            group = batches[off : off + SUP]
            codes = np.full((SUP, B, L), 4, dtype=np.uint8)
            lengths = np.zeros((SUP, B), dtype=np.int32)
            ids = np.full((SUP, B), -1, dtype=np.int32)
            for g, batch in enumerate(group):
                codes[g, :, : batch.codes.shape[1]] = batch.codes
                lengths[g] = batch.lengths
                ids[g] = batch.ids
            dual = np.where(ids >= 0, qdualrank[ids], 0).astype(np.int32)
            selfr = np.where(ids >= 0, qselfrid[ids], -1).astype(np.int32)
            put = lambda a: torch.from_numpy(a).to(self.device)
            packed = sketch_map_many(
                put(pack2bit_host(codes)), put(lengths), put(dual), put(selfr),
                self.gdev, p, num_anchors=A, window=self.window,
            )
            yield len(group), A, codes, lengths, ids, packed

    def count_batch(self, names: list, seqs: list, *, warming: bool = False) -> BatchCounts:
        """Count overlaps per query (exact: flagged rows are recomputed on the host)."""
        n = len(seqs)
        counts = np.zeros(n, dtype=np.int32)
        had = np.zeros(n, dtype=bool)
        if not self.device_ok:
            for i, (c, h) in enumerate(self._host_count_many(list(zip(names, seqs)))):
                counts[i], had[i] = c, h
            return BatchCounts(counts, had, n)

        p = self.params
        max_bucket = self.length_buckets[-1]
        long_rows, host_share_rows, bucket_rows = self.plan_rows(seqs, range(n), warming=warming)
        # long-tail and host-share reads run on the host concurrently with
        # the device (the native kernel releases the GIL)
        host_rows_all = long_rows + host_share_rows
        pool = ThreadPoolExecutor(1) if host_rows_all else None
        host_future = (
            pool.submit(self._host_count_many, [(names[i], seqs[i]) for i in host_rows_all])
            if pool is not None
            else None
        )
        try:
            qdualrank = np.array(
                [self.host._dual_rank(nm) if p.no_dual else 0 for nm in names], dtype=np.int32
            )
            qselfrid = self._self_ranks(names)
            # stage 1: enqueue every super-batch (the device runs behind)
            inflight = []
            for L in self.length_buckets:
                if bucket_rows.get(L):
                    inflight.extend(self._dispatch(L, bucket_rows[L], seqs, qdualrank, qselfrid))
            # stage 2: collect and triage
            retry = []
            for nb, A, codes, lengths, ids, packed in inflight:
                arr = packed.cpu().numpy().astype(np.int64)
                bcounts, n_anchors, max_run, mcount = (arr[..., j][:nb] for j in range(4))
                live = ids[:nb] >= 0
                needs = self.triage_flags(
                    live, n_anchors, A, max_run, mcount, minimizer_cap(codes.shape[2]),
                    codes[:nb], lengths[:nb],
                )
                retry.extend(ids[:nb][needs].tolist())
                ok = live & ~needs
                counts[ids[:nb][ok]] = bcounts[ok]
                had[ids[:nb][ok]] = bcounts[ok] > 0
            # stage 3: exact host recompute of the flagged rows
            fallback = 0
            for qid, (c, h) in zip(retry, self._host_count_many([(names[i], seqs[i]) for i in retry])):
                counts[qid], had[qid] = c, h
                fallback += 1
            if host_future is not None:
                share_set = set(host_share_rows)
                for i, (c, h) in zip(host_rows_all, host_future.result()):
                    counts[i], had[i] = c, h
                    if i in share_set:
                        # deliberate heterogeneous scheduling, not a fallback
                        self.fallback_triggers["host_share"] += 1
                        continue
                    fallback += 1
                    self.fallback_triggers[
                        "long_read" if len(seqs[i]) > max_bucket else "sparse_bucket"
                    ] += 1
        finally:
            if pool is not None:
                pool.shutdown()
        if fallback:
            logger.debug(
                "device path: %d/%d rows fell back to host (%s)", fallback, n,
                dict(self.fallback_triggers),
            )
        return BatchCounts(counts, had, fallback)
