"""Batched device overlap engine with exact host recompute (PyTorch).

Port of the single-device path of ``lrge_tpu/device_engine.py``: the
index is split into sub-indexes by target when its expected anchors per
query exceed the anchor buffer (``n_sub``, the reference's rule);
queries are partitioned into length buckets, padded into super-batches,
and each super-batch runs the whole pipeline on ``device`` as one
program (``ops/program.py``: a CUDA graph a bucket and mode, captured
by :meth:`DeviceOverlapEngine.warmup` or at first use, the reference's
``jax.jit``): for ONT on one sub-index the fused
``ops.overlap.sketch_map_many``, on several
``ops.overlap.sketch_lookup_many`` once and a map per sub
(``ops.overlap.map_subs``); for the PacBio/HPC preset (``pb_mode``)
host-sketched hash planes through ``ops.overlap.pb_map_many`` (wide-key
lookup, then per sub the span chain DP with the ``min_cnt`` gate).
Rows the device cannot guarantee exactly
(anchor-buffer overflow, a (rid, strand) run longer than the DP window
or a chain short of ``min_cnt``, minimizer-capacity truncation,
ambiguous bases under ONT) are recomputed by the exact host engine, so
counts equal the host engine's; every such row is tallied in
``fallback_triggers``.  ``count_batch`` can also collect each row's
passing target ids (ava, ``--use-min-ref``) and apply the ``-F``
overhang filter on the device (``supports_device_filter``; never under
``pb_mode``, on a multi-sub index or on a sharded one, where the
strategies filter on the host, as the reference does).

With several devices (every visible CUDA device by default, or the
caller's list, cut to ``LRGE_SHARDS``) the engine shards the index by
target instead (``parallel/sharded.py``, the reference's set-up at
device_engine.py:253-323): each super-batch is sketched once by a
``"query"`` program on the home device and counted against every shard
by a ``"shard"`` program on the shard's device (:meth:`shard_programs`,
the reference's jitted ``sharded_count_fn``), the merge between them.
Under a multi-process launch the shards span every process's devices,
and the forward two-set path counts in lockstep
(``parallel/distributed.py``), replaying the same programs at every
ring hop; engines built ``local_only`` shard over this process's
devices alone.

Shape knobs, as the reference reads them: ``LRGE_DEVICE_BATCH``,
``LRGE_DEVICE_ANCHORS``, ``LRGE_DEVICE_WINDOW``, ``LRGE_DEVICE_SUPER``,
``LRGE_DEVICE_BUCKET`` (a comma list), ``LRGE_BUCKET_BITS`` (the
single-device dictionary), ``LRGE_SHARDS`` and ``LRGE_MESH_DATA``.
"""

from __future__ import annotations

import logging
import os
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from .engine import OverlapEngine
from .native import native
from .ops.encode import make_batches
from .ops.index import TargetIndex
from .ops.overlap import HAD_BIT, PB_LOMASK, PB_SPLIT, GroupedDeviceIndex, minimizer_cap, pack2bit_host
from .ops.program import ProgramKey, SuperBatchProgram, program_function
from .ops.sketch import sketch_seqs_native
from .parallel.distributed import is_multihost
from .parallel.sharded import ShardedGroupedIndex, sharded_count_programs
from .spans import carry, count, current, pass_record, span

logger = logging.getLogger("lrge")

# padded read lengths with their own pipeline shapes; longer reads take
# the exact host path
LENGTH_BUCKETS = (2048, 4096, 8192, 16384, 32768)
# the stages of a pass, ``count_batch``'s children, as ``last_phases`` keys
STAGES = ("prep", "enqueue", "collect", "retry")


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


def default_devices() -> list[torch.device]:
    """Every visible CUDA device; raises without CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError("the device engine needs CUDA: no CUDA device is available")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def shard_plan(device=None, nproc: int = 1) -> tuple[list[torch.device], int]:
    """``(this process's devices, shards over all processes)``, the
    reference's rule (device_engine.py:253-262): ``device`` is one device
    or a list (repeats allowed, as tests and one-card runs use), default
    every visible CUDA device; ``nproc`` processes each bring as many.
    ``LRGE_SHARDS`` cuts the shard count; at one shard the engine runs on
    the first device alone."""
    if device is None:
        devices = default_devices()
    elif isinstance(device, (str, torch.device)):
        devices = [torch.device(device)]
    else:
        devices = [torch.device(d) for d in device]
    total = nproc * len(devices)
    n = min(int(os.environ.get("LRGE_SHARDS", "0")) or total, total)
    if n <= 1:
        return devices[:1], 1
    if n % nproc:
        raise ValueError(f"LRGE_SHARDS={n} is not a multiple of the {nproc} processes")
    return devices[: n // nproc], n


def strategy_engine(index: TargetIndex, **kw) -> "DeviceOverlapEngine":
    """The engine of a path whose schedule is not lockstep (all-vs-all,
    ``-F``, ``--use-min-ref``): under a multi-process launch it shards
    over this process's devices alone and runs replicated, rank 0
    printing (the reference's device_engine.py:132-141)."""
    return DeviceOverlapEngine(index, local_only=is_multihost(), **kw)


# the per-core host rate over the device rate, as calibrated on the card
# (``LRGE_HOST_RATE_RATIO`` overrides it); see
# :meth:`DeviceOverlapEngine._host_share_fraction`
HOST_RATE_RATIO = 0.0


def host_rate_ratio() -> float:
    """``r`` of the host share: ``LRGE_HOST_RATE_RATIO``, else
    :data:`HOST_RATE_RATIO`."""
    return float(os.environ.get("LRGE_HOST_RATE_RATIO", HOST_RATE_RATIO))


def _has_native_count() -> bool:
    return native is not None and hasattr(native, "count_many")


def overhang_heavy(m, ratio) -> bool:
    """The ``--use-min-ref -F`` drop test (``twoset.rs:493-517``): the
    reference drops overhang-HEAVY mappings, the opposite of
    ``is_internal`` (f32 product truncated to an integer)."""
    if m.strand == "+":
        overhang = min(m.query_start, m.target_start) + min(
            m.query_len - m.query_end, m.target_len - m.target_end
        )
    else:
        overhang = min(m.query_start, m.target_len - m.target_end) + min(
            m.query_len - m.query_end, m.target_start
        )
    maplen = max(m.query_end - m.query_start, m.target_end - m.target_start)
    return overhang > int(np.float32(maplen) * np.float32(ratio))


class DeviceOverlapEngine:
    def __init__(
        self,
        index: TargetIndex,
        *,
        device=None,
        batch_size: int = 128,
        num_anchors: int = 4096,
        window: int = 32,
        length_buckets: tuple = LENGTH_BUCKETS,
        super_batch: int = 4,
        local_only: bool = False,
        graphs: bool = True,
    ):
        """``device``: one ``torch.device`` or a list to shard the index
        over (:func:`shard_plan`; default every visible CUDA device).
        ``local_only``: under a multi-process launch, shard over this
        process's devices alone and run replicated (the ava, ``-F`` and
        ``--use-min-ref`` paths, whose schedules are not lockstep).
        ``graphs=False`` runs every super-batch program as an eager call
        on the card instead of a CUDA graph replay (the benchmark's A/B,
        the counterpart of the reference's ``LRGE_NO_FUSED``)."""
        # shape knobs, read as the reference reads them (device_engine.py:167-174)
        batch_size = int(os.environ.get("LRGE_DEVICE_BATCH", batch_size))
        num_anchors = int(os.environ.get("LRGE_DEVICE_ANCHORS", num_anchors))
        window = int(os.environ.get("LRGE_DEVICE_WINDOW", window))
        super_batch = int(os.environ.get("LRGE_DEVICE_SUPER", super_batch))
        if "LRGE_DEVICE_BUCKET" in os.environ:
            length_buckets = tuple(int(t) for t in os.environ["LRGE_DEVICE_BUCKET"].split(","))
        nproc = 1 if local_only or not is_multihost() else torch.distributed.get_world_size()
        self.devices, n_shards = shard_plan(device, nproc)
        self.device = self.devices[0]
        self.index = index
        self.params = index.params
        self.host = OverlapEngine(index)
        self.batch_size = batch_size
        self.num_anchors = num_anchors
        self.window = window
        self.length_buckets = tuple(sorted(length_buckets))
        self.super_batch = super_batch
        self.graphs = graphs
        self.fallback_triggers = Counter()  # why rows went to the host
        # (record, count_batch span) of the last call, and of the last call
        # that ran the device path: last_host_s and last_phases read them
        self._call = self._device_call = None
        # PacBio/HPC preset: 2k = 38-bit keys (two int32 planes on the
        # device) and per-minimizer spans; queries are sketched on the
        # host by the native kernel (exact, HPC quirks included)
        self.pb_mode = self.params.hpc or 2 * self.params.k > 32
        if self.pb_mode and native is None:
            raise RuntimeError(
                "the PacBio/HPC device path sketches queries with the native extension "
                "(lrge_tpu_torch.native), which did not build"
            )
        self.device_ok = len(index.keys) > 0
        self.gdev = None
        # the super-batch programs by ProgramKey, for the planes they were
        # captured over (``gdev`` and ``shards``: a graph holds the planes'
        # addresses), and their graph memory pools, one a device
        self.programs = {}
        self._programs_planes = ()
        self._graph_pools = {}
        self.sharded = None  # ShardedGroupedIndex (host planes) when sharded
        self.shards = []  # this process's shards, a GroupedDeviceIndex each
        self.first_shard = 0  # the global number of shards[0]
        self.lockstep = False  # the shards span processes
        if not self.device_ok:
            return
        if n_shards > 1:
            # the data axis is the process axis; the index axis each
            # process's devices
            n_data = int(os.environ.get("LRGE_MESH_DATA", "0")) or nproc
            if n_data != nproc:
                raise ValueError(f"LRGE_MESH_DATA={n_data}: the data axis is the {nproc} process(es)")
            sgi = ShardedGroupedIndex.from_host(index, n_shards)
            if sgi is not None:
                self.first_shard = (torch.distributed.get_rank() if nproc > 1 else 0) * len(self.devices)
                self.sharded = sgi
                self.shards = sgi.place(self.devices, self.first_shard)
                self.lockstep = nproc > 1
                logger.debug(
                    "device engine: sharded over %d devices (%dx%d)", n_shards, nproc, len(self.devices)
                )
                return
            logger.warning(
                "sharded index build failed (bucket collisions); falling back to single-device grouped path"
            )
            self.devices = self.devices[:1]
        # bound per-query anchors by splitting a large index into
        # sub-indexes by target (counts are disjoint per sub and summed);
        # the minimizer lookup is shared across subs.  Keyed to the base
        # bucket: larger buckets scale their anchor capacity with length
        with span("planes.host"):
            n_post = len(index.keys)
            n_uniq = max(1, len(np.unique(index.keys)))
            exp_anchors = (self.length_buckets[0] / 3.0) * (n_post / n_uniq)
            n_sub = max(1, int(np.ceil(exp_anchors / (0.6 * num_anchors))))
            # ~4 buckets per unique key, capped so the offsets stay <= 256 MB
            if "LRGE_BUCKET_BITS" in os.environ:
                bucket_bits = int(os.environ["LRGE_BUCKET_BITS"])
            else:
                bucket_bits = min(max(int(np.ceil(np.log2(max(n_uniq, 2)))) + 2, 12), 26)
        self.gdev = GroupedDeviceIndex.from_host(index, self.device, n_sub=n_sub, bucket_bits=bucket_bits)
        if self.gdev is None:
            # from_host logged why: every posting pruned, or a wide index
            # without a bucketed dictionary; every row goes to the host
            self.device_ok = False
        logger.debug("device engine: %d sub-indexes (shared lookup)", n_sub)

    def query_ranks(self, names) -> tuple[np.ndarray, np.ndarray]:
        """Each query's dual-mask rank (0 without ``no_dual``) and self-id,
        in name-rank space (the posting planes carry ranks)."""
        no_dual = self.params.no_dual
        dual = np.array([self.host._dual_rank(nm) if no_dual else 0 for nm in names], dtype=np.int32)
        rank_of = self.index.name_rank
        selfr = np.empty(len(names), dtype=np.int32)
        for i, nm in enumerate(names):
            r = self.host._name_to_rid.get(nm, -1)
            selfr[i] = int(rank_of[r]) if r >= 0 else -1
        return dual, selfr

    def _ranks_to_rids(self, ranks: np.ndarray) -> np.ndarray:
        """Device pair planes carry name ranks; the pair contract is rid-based."""
        if not hasattr(self, "_rank_inv"):
            rank_of = np.asarray(self.index.name_rank, dtype=np.int64)
            self._rank_inv = np.zeros(len(rank_of), dtype=np.int32)
            self._rank_inv[rank_of] = np.arange(len(rank_of), dtype=np.int32)
        return self._rank_inv[ranks]

    def _host_count_many(self, items):
        """Exact host counting (the native whole-pipeline kernel when built)."""
        if _has_native_count():
            return self.host.count_overlaps_many(items)
        return [self.host.count_overlaps(nm, sq) for nm, sq in items]

    def _host_count_pairs(self, items):
        """``(count, had, rids|None)`` triples; rids is None without the
        native pairs kernel or when a row truncated (the strategies
        recover those rows with ``map_read``)."""
        if _has_native_count():
            return self.host.count_overlaps_many(items, want_pairs=True)
        return [(c, h, None) for c, h in self._host_count_many(items)]

    def _host_count_filtered(self, items, ratio, mode="internal", want_pairs=False):
        """Exact host ``-F`` counting: unique targets with a mapping that
        passes the overhang filter (``mode="internal"``: ``is_internal``,
        ``twoset.rs:286-301``; ``"overhang"``: the inverted
        ``--use-min-ref`` comparison, ``twoset.rs:493-517``; ``ratio``
        None: every mapping passes), and the pre-filter had-mapping flag;
        with ``want_pairs`` the passing rids too.  ``map_read``-based, on
        threads (its chain DP releases the GIL)."""
        if ratio is None:
            dropped = lambda m: False
        elif mode == "internal":
            dropped = lambda m: m.is_internal(ratio)
        else:
            dropped = lambda m: overhang_heavy(m, ratio)

        def one(item):
            recs = self.host.map_read(*item)
            uniq = {}
            for m in recs:
                if m.target_name not in uniq and not dropped(m):
                    uniq[m.target_name] = None
            if want_pairs:
                rids = np.array([self.host._name_to_rid[t] for t in uniq], dtype=np.int32)
                return len(uniq), int(bool(recs)), rids
            return len(uniq), int(bool(recs))

        if len(items) <= 1:
            return [one(it) for it in items]
        with ThreadPoolExecutor(min(os.cpu_count() or 2, 8)) as ex:
            return list(ex.map(one, items))

    def supports_device_filter(self) -> bool:
        """Whether ``-F`` can run on the device: only in the fused
        single-sub ONT pipeline on one device (the extent carries are constant-span
        only, and the extent reduce runs on the lookup's own ranges);
        chain starts pack as ``(rpos << 16) | qpos`` in int32, so every
        target must be shorter than 2^15 and every padded query (plus k)
        shorter than 2^16."""
        return (
            self.device_ok
            and not self.pb_mode
            and self.sharded is None
            and self.gdev is not None
            and self.gdev.n_sub == 1
            and int(np.max(self.index.lengths)) < (1 << 15)
            and self.length_buckets[-1] + self.params.k < (1 << 16)
        )

    def triage_flags(self, live, n_anchors, cap, max_run, mcount, mcap, codes, lengths):
        """Flag rows whose device result cannot be guaranteed exact and
        tally ``fallback_triggers``; returns the "needs host recompute"
        mask.  Under ``pb_mode`` the host sketched the rows exactly, so
        no row is a sketch quirk."""
        t_over = (n_anchors > cap) & live
        t_miss = (max_run > self.window) & live & ~t_over
        t_mini = (mcount > mcap) & live & ~t_over & ~t_miss
        prior = t_over | t_miss | t_mini
        if self.pb_mode:
            t_quirk = np.zeros_like(prior)
        else:
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

    def _host_share_fraction(self, n_dev_rows: int, pairs_wanted: bool = False) -> float:
        """Fraction of device-eligible rows handed to the concurrent host
        engine, ``c*r / (c*r + 1)`` for ``c`` host cores and ``r`` the
        per-core host rate over the device rate (:func:`host_rate_ratio`;
        ``LRGE_HOST_SHARE`` sets the share directly).  Pair collection
        without the native pairs kernel takes no share: its rows would
        fall to the slow ``map_read`` recovery.

        ``r`` is 0 by default, as calibrated on an NVIDIA H100 80GB HBM3
        at a 700.00 W power limit with 8 host cores (``chip_smoke.py``
        phase 13: the benchmark's corpus, 5,000 queries against 10,000
        targets, three passes a share in turns; three runs): the median
        q/s at share 0 were 38,403.2, 42,936.3 and 41,383.9; at 0.1
        33,197.7, 38,921.8 and 36,279.5; at 0.2 31,661.4, 35,239.2 and
        31,517.1; at 0.3 25,645.3, 30,411.0 and 27,896.2; at 0.5
        20,091.0, 23,085.5 and 20,311.2.  Share 0 wins every run: the
        host rows run on the cores that batch the super-batches, and
        the device side slows more than the host rows save.  (The
        reference's 0.30 was calibrated on a TPU v5e.)"""
        if "LRGE_HOST_SHARE" in os.environ:
            share = float(os.environ["LRGE_HOST_SHARE"])
        elif not _has_native_count():
            share = 0.0
        else:
            c = os.cpu_count() or 2
            r = host_rate_ratio()
            share = min(0.9, c * r / (c * r + 1.0))
        if pairs_wanted and not _has_native_count():
            share = 0.0
        if share <= 0 or native is None or n_dev_rows < 4 * self.batch_size:
            return 0.0
        return share

    def plan_rows(self, seqs, rows, *, pairs_wanted=False, filter_active=False, warming=False):
        """Partition ``rows`` into ``(host_rows, host_share_rows, {L:
        bucket_rows})``: reads longer than the last bucket or in a sparse
        bucket (<= ``LRGE_DEVICE_MIN_ROWS``) go to the host, the shortest
        device-eligible rows form the host share (none under ``-F``,
        whose host counting is ``map_read``-based and slow), the rest
        fill buckets."""
        max_bucket = self.length_buckets[-1]
        long_rows = [i for i in rows if len(seqs[i]) > max_bucket]
        dev_rows = [i for i in rows if len(seqs[i]) <= max_bucket]
        min_rows = 0 if warming else int(os.environ.get("LRGE_DEVICE_MIN_ROWS", 32))
        host_share_rows = []
        if not warming and not filter_active:
            k = int(len(dev_rows) * self._host_share_fraction(len(dev_rows), pairs_wanted))
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

    def warmup(self, lengths=None, filter_ratio=None, filter_mode="internal", want_pairs=False) -> None:
        """Run each bucket that the mapping pass will use once on two
        dummy reads, in the pass's own mode: this captures the bucket's
        super-batch program (:meth:`program`; on a sharded index its query
        and shard programs, :meth:`shard_programs`; the reference's
        ``warmup`` compiles its programs here), which builds the chain
        kernel and primes the allocator."""
        if not self.device_ok:
            return
        if _has_native_count():
            # build the host bucket dictionary off the hot path
            self.host._bucket_dict()
        min_rows = int(os.environ.get("LRGE_DEVICE_MIN_ROWS", 32))
        if lengths is not None:
            max_bucket = self.length_buckets[-1]
            dev_lens = sorted(x for x in lengths if x <= max_bucket)
            share = 0.0 if filter_ratio is not None else self._host_share_fraction(len(dev_lens), want_pairs)
            lengths = dev_lens[int(len(dev_lens) * share):]
        lo = 0
        for L in self.length_buckets:
            if lengths is None or sum(lo < x <= L for x in lengths) > min_rows:
                fake = [b"ACGT" * (max(lo + 4, L // 2) // 4)] * 2
                self.count_batch(
                    [b"__warm0", b"__warm1"], fake, collect_pairs={} if want_pairs else None,
                    filter_ratio=filter_ratio, filter_mode=filter_mode, warming=True,
                )
            lo = L

    def bucket_shape(self, L) -> tuple[int, int]:
        """``(A, SUP)`` of length bucket ``L``: the anchor capacity scales
        with the padded length (A = L at the default), the dispatch depth
        (batches a super-batch) shrinks to keep group work constant."""
        A = min(1 << 15, max(512, (self.num_anchors * L) // 4096))
        return A, max(1, (self.super_batch * 4096) // L)

    def batch_groups(self, L, rows_b, seqs) -> list:
        """The batches of one length bucket (``make_batches``), ``SUP`` to
        a group: one group a super-batch."""
        _, SUP = self.bucket_shape(L)
        batches = make_batches(
            [seqs[i] for i in rows_b], ids=rows_b, batch_size=self.batch_size, pad_to=L,
            pow2_lengths=False, pad_batch=True,
        )
        return [batches[off : off + SUP] for off in range(0, len(batches), SUP)]

    def pad_group(self, L, group, qdualrank, qselfrid):
        """One super-batch's host arrays from its group of batches:
        ``(nb, A, codes, lengths, ids, dual, selfr)``, padded to ``SUP``
        batches."""
        B = self.batch_size
        A, SUP = self.bucket_shape(L)
        codes = np.full((SUP, B, L), 4, dtype=np.uint8)
        lengths = np.zeros((SUP, B), dtype=np.int32)
        ids = np.full((SUP, B), -1, dtype=np.int32)
        for g, batch in enumerate(group):
            codes[g, :, : batch.codes.shape[1]] = batch.codes
            lengths[g] = batch.lengths
            ids[g] = batch.ids
        dual = np.where(ids >= 0, qdualrank[ids], 0).astype(np.int32)
        selfr = np.where(ids >= 0, qselfrid[ids], -1).astype(np.int32)
        return len(group), A, codes, lengths, ids, dual, selfr

    def super_batches(self, L, rows_b, seqs, qdualrank, qselfrid):
        """The super-batches of one length bucket, as host arrays; yields
        ``(nb, A, codes, lengths, ids, dual, selfr)``."""
        for group in self.batch_groups(L, rows_b, seqs):
            yield self.pad_group(L, group, qdualrank, qselfrid)

    def _pb_planes(self, row_seqs, M):
        """Host-sketch a batch of PacBio reads into the device lookup planes
        (numpy): ``(qhi, qlo, mps, mcount)``, the 38-bit hash split at bit
        19 (``qhi`` -1 on padding), ``pos << 9 | span << 1 | strand``, and
        the true minimizer counts (rows above ``M`` go to the host)."""
        p = self.params
        with span("enqueue.pb_sketch"):
            mzs = sketch_seqs_native(row_seqs, p.k, p.w, p.hpc)
        with span("enqueue.pb_fill"):
            n = len(row_seqs)
            qhi = np.full((n, M), -1, dtype=np.int32)
            qlo = np.zeros((n, M), dtype=np.int32)
            mps = np.zeros((n, M), dtype=np.int32)
            mcount = np.zeros(n, dtype=np.int32)
            for i, mz in enumerate(mzs):
                h38 = mz.key >> np.uint64(8)
                c = min(len(h38), M)
                mcount[i] = len(h38)
                qhi[i, :c] = (h38 >> np.uint64(PB_SPLIT)).astype(np.int32)[:c]
                qlo[i, :c] = (h38 & np.uint64(PB_LOMASK)).astype(np.int32)[:c]
                mspan = (mz.key & np.uint64(0xFF)).astype(np.int32)
                mps[i, :c] = (mz.pos.astype(np.int32)[:c] << 9) | (mspan[:c] << 1) | mz.strand.astype(np.int32)[:c]
        return qhi, qlo, mps, mcount

    def program(self, L, A, SUP, *, want_pairs=False, want_extents=False, overhang_ratio=0.2,
                filter_mode="internal") -> SuperBatchProgram:
        """The super-batch program of bucket ``L`` (``A`` anchors, ``SUP``
        batches) in this mode on the single-device planes (:meth:`_program`)."""
        gd = self.gdev
        branch = "pacbio" if self.pb_mode else "ont" if gd.n_sub == 1 else "ont_multi"
        filt = (float(overhang_ratio), filter_mode) if want_extents else (None, None)
        key = ProgramKey(branch, L, A, SUP, self.batch_size, bool(want_pairs), bool(want_extents), *filt)
        return self._program(key, gd, self.device)

    def shard_programs(self, L, A, SUP, B, want_pairs=False) -> tuple:
        """``(query, shards)``: the programs of one sharded super-batch of
        ``SUP`` x ``B`` rows in bucket ``L`` (``A`` anchors), the query
        side on the home device and one program a local shard on its
        shard's device, keyed by its global number (:meth:`_program`).  The
        query program serves every mode."""
        query = self._program(ProgramKey("query", L, A, SUP, B), self.shards[0], self.device)
        shards = [
            self._program(
                ProgramKey("shard", L, A, SUP, B, bool(want_pairs), shard=self.first_shard + i), gi, gi.uhash.device
            )
            for i, gi in enumerate(self.shards)
        ]
        return query, shards

    def _program(self, key: ProgramKey, gi, device: torch.device) -> SuperBatchProgram:
        """The program of ``key`` over the planes ``gi`` on ``device``,
        captured at first use (on the card into the device's graph pool;
        an eager call there when the engine was built ``graphs=False``)
        and cached.  The cache and the pools are dropped when ``gdev`` or
        ``shards`` change: a graph holds the planes' addresses."""
        planes = (self.gdev, *self.shards)
        if tuple(map(id, planes)) != tuple(map(id, self._programs_planes)):
            self.programs, self._programs_planes, self._graph_pools = {}, planes, {}
        prog = self.programs.get(key)
        if prog is None:
            pool = None
            if device.type == "cuda" and self.graphs:
                pool = self._graph_pools.get(device)
                if pool is None:
                    pool = self._graph_pools[device] = torch.cuda.graph_pool_handle()
            fn, inputs = program_function(key, gi, self.params, window=self.window)
            prog = self.programs[key] = SuperBatchProgram(key, fn, inputs, device, pool=pool, graph=self.graphs)
        return prog

    def program_arrays(self, L, codes, lengths, ids, dual, selfr, seqs) -> tuple:
        """One super-batch's host arrays in the order its program takes
        them: ONT on one sub the 2-bit packed codes, on several or on a
        sharded index the codes; PacBio the host-sketched planes
        (:meth:`_pb_planes`) and the true minimizer counts; then lengths,
        dual and self ranks."""
        if self.pb_mode:
            planes = self._pb_planes([seqs[i] if i >= 0 else b"" for i in ids.ravel()], minimizer_cap(L))
            qhi, qlo, mps = (a.reshape(*ids.shape, -1) for a in planes[:3])
            return qhi, qlo, mps, planes[3].reshape(ids.shape), lengths, dual, selfr
        if self.sharded is None and self.gdev.n_sub == 1:
            with span("enqueue.pack"):
                return pack2bit_host(codes), lengths, dual, selfr
        return codes, lengths, dual, selfr

    def sharded_run(self, L, A, arrays, want_pairs=False) -> tuple:
        """One sharded super-batch of :meth:`program_arrays`' host arrays:
        the query program's run on the home device, each shard program's
        run fed from its outputs, the merge on the home device
        (:func:`~lrge_tpu_torch.parallel.sharded.sharded_count_programs`).
        Returns the ``[SUP, B, 4]`` int32 plane and the pair plane (or
        None), as a single-device program run does; no call waits for the
        card."""
        SUP, B = arrays[-1].shape
        query, shards = self.shard_programs(L, A, SUP, B, want_pairs)
        *planes, mcount = query.run(*arrays)
        counts, n_anchors, max_run, pairs = sharded_count_programs(shards, *planes)
        packed = torch.stack([counts, n_anchors, max_run, mcount.long()], dim=-1).reshape(SUP, B, 4).to(torch.int32)
        return packed, None if pairs is None else pairs.reshape(SUP, B, -1).to(torch.int32)

    def _dispatch(self, L, rows_b, seqs, qdualrank, qselfrid, **mode):
        """Enqueue the super-batches of one length bucket; yields
        ``(nb, A, codes, lengths, ids, packed_device_plane,
        pair_device_plane_or_None)``.  ``mode`` holds the pair and ``-F``
        arguments of :func:`~lrge_tpu_torch.ops.overlap.sketch_map_many`.
        On one device each super-batch is one run of the bucket's
        program (:meth:`program`, :meth:`program_arrays`); on a sharded
        index one run of the query program and of each shard's
        (:meth:`sharded_run`).  Each super-batch's host work is one
        ``super_batch`` span.  The batching is ``enqueue.batch`` spans:
        the bucket's (:meth:`batch_groups`) under ``enqueue``, each
        super-batch's padding (:meth:`pad_group`) under its
        ``super_batch``."""
        with span("enqueue.batch"):
            groups = self.batch_groups(L, rows_b, seqs)
        for i, group in enumerate(groups):
            with span("super_batch", L=L, i=i):
                with span("enqueue.batch"):
                    nb, A, codes, lengths, ids, dual, selfr = self.pad_group(L, group, qdualrank, qselfrid)
                count("pad_rows", int((ids < 0).sum()))
                count("row_slots", ids.size)
                arrays = self.program_arrays(L, codes, lengths, ids, dual, selfr, seqs)
                if self.sharded is not None:
                    packed, pairs = self.sharded_run(L, A, arrays, want_pairs=mode["want_pairs"])
                else:
                    packed, pairs = self.program(L, A, ids.shape[0], **mode).run(*arrays)
            yield nb, A, codes, lengths, ids, packed, pairs


    def count_batch(
        self, names: list, seqs: list, collect_pairs=None, filter_ratio=None,
        filter_mode="internal", *, warming: bool = False,
    ) -> BatchCounts:
        """Count overlaps per query (exact: flagged rows are recomputed on the host).

        ``collect_pairs`` (a dict) receives each query's passing target
        rids, ``qid -> int32 array`` (the ava and ``--use-min-ref``
        accumulation); rows whose host recompute yields no id list are
        left out, for the caller to recover.  ``filter_ratio`` applies
        ``-F`` on the device (check :meth:`supports_device_filter`
        first): counts and pair lists then hold only targets that pass
        it (``filter_mode`` ``"internal"`` or ``"overhang"``), and
        ``had_mapping`` stays the pre-filter flag.

        Each call is one pass record of ``lrge_tpu_torch.spans`` (the
        set-up record when ``warming``), a ``count_batch`` span over the
        stages ``prep`` (row plan, ranks), ``enqueue`` (stage 1),
        ``collect`` (stage 2) and ``retry`` (stage 3 and the host rows),
        with the host thread's ``host_thread`` span beside them.  It also
        leaves the reference's per-pass record (device_engine.py:810-812,
        :1160-1163, :1206-1241): ``last_anchors_valid`` (anchors chained,
        ``min(n_anchors, A)`` over live rows) and ``last_anchor_slots``
        (``SUP * B * A`` a super-batch), reset at the start of every call,
        and :attr:`last_phases` and :attr:`last_host_s`, read from the
        spans."""
        with pass_record(warming), span("count_batch") as call:
            self._call = (current(), call)
            return self._count_batch(call, names, seqs, collect_pairs, filter_ratio, filter_mode, warming)

    @property
    def last_phases(self) -> dict:
        """Seconds by stage of the last call that ran the device path (a
        call without device planes leaves it as it was): ``prep``,
        ``enqueue``, ``collect`` and ``retry``, its ``count_batch`` span's
        children, and one ``collect_L{L}`` a bucket, the ``collect.wait``
        and ``collect.triage`` spans of that bucket's super-batches."""
        if self._device_call is None:
            raise AttributeError("last_phases: no call has run the device path")
        rec, call = self._device_call
        phases = dict.fromkeys(STAGES, 0.0)
        for s in rec.children(call):
            if s.name in phases:
                phases[s.name] = s.duration
            if s.name == "collect":
                for c in rec.children(s):
                    key = f"collect_L{c.tags['L']}"
                    phases[key] = phases.get(key, 0.0) + c.duration
        return phases

    @property
    def last_host_s(self) -> float:
        """Seconds that the host thread of the last call spent counting the
        long-read and host-share rows beside the device (its
        ``host_thread`` span; 0 when it had none)."""
        if self._call is None:
            raise AttributeError("last_host_s: count_batch has not run")
        rec, call = self._call
        return sum(s.duration for s in rec.children(call) if s.name == "host_thread")

    def _count_batch(self, call, names, seqs, collect_pairs, filter_ratio, filter_mode, warming) -> BatchCounts:
        n = len(seqs)
        counts = np.zeros(n, dtype=np.int32)
        had = np.zeros(n, dtype=bool)
        self.last_anchors_valid = 0
        self.last_anchor_slots = 0
        if filter_ratio is not None:
            if self.device_ok and not self.supports_device_filter():
                raise ValueError("-F cannot run on the device for this index (supports_device_filter)")
            host_fn = lambda items: self._host_count_filtered(
                items, filter_ratio, mode=filter_mode, want_pairs=collect_pairs is not None
            )
        elif collect_pairs is not None:
            host_fn = self._host_count_pairs
        else:
            host_fn = self._host_count_many

        def take_host(rows, results):
            for i, res in zip(rows, results):
                counts[i], had[i] = res[0], res[1]
                if collect_pairs is not None and res[2] is not None:
                    collect_pairs[i] = res[2]

        if not self.device_ok:
            take_host(range(n), host_fn(list(zip(names, seqs))))
            return BatchCounts(counts, had, n)

        def host_thread(items):
            with span("host_thread"):
                return host_fn(items)

        max_bucket = self.length_buckets[-1]
        pool = host_future = None
        try:
            with span("prep"):
                long_rows, host_share_rows, bucket_rows = self.plan_rows(
                    seqs, range(n), pairs_wanted=collect_pairs is not None,
                    filter_active=filter_ratio is not None, warming=warming,
                )
                mode = dict(
                    want_pairs=collect_pairs is not None, want_extents=filter_ratio is not None,
                    overhang_ratio=float(filter_ratio or 0.2), filter_mode=filter_mode,
                )
                # long-tail and host-share reads run on the host concurrently
                # with the device (the native kernel releases the GIL)
                host_rows_all = long_rows + host_share_rows
                if host_rows_all:
                    pool = ThreadPoolExecutor(1)
                    host_future = pool.submit(
                        carry(host_thread, call), [(names[i], seqs[i]) for i in host_rows_all]
                    )
                qdualrank, qselfrid = self.query_ranks(names)
            # stage 1: enqueue every super-batch, one program replay each (on
            # a sharded index the query program's and each shard's) fed by
            # asynchronous copies; nothing waits for the card until stage
            # 2, so the host prepares the next super-batch while the card
            # runs this one (the reference's device_engine.py:900-901, :961)
            with span("enqueue"):
                inflight = []
                for L in self.length_buckets:
                    if bucket_rows.get(L):
                        inflight.extend(self._dispatch(L, bucket_rows[L], seqs, qdualrank, qselfrid, **mode))
            # stage 2: collect and triage
            with span("collect"):
                retry = []
                for nb, A, codes, lengths, ids, packed, pairs in inflight:
                    SUP, B, L = codes.shape
                    with span("collect.wait", L=L):
                        packed = packed.cpu()
                        if collect_pairs is not None:
                            pairs = pairs.cpu()
                    with span("collect.triage", L=L):
                        arr = packed.numpy().astype(np.int64)
                        bcounts, n_anchors, max_run, mcount = (arr[..., j][:nb] for j in range(4))
                        live = ids[:nb] >= 0
                        self.last_anchors_valid += int(np.minimum(n_anchors, A)[live].sum())
                        self.last_anchor_slots += SUP * B * A
                        needs = self.triage_flags(
                            live, n_anchors, A, max_run, mcount, minimizer_cap(L), codes[:nb], lengths[:nb],
                        )
                        if filter_ratio is not None:
                            raw_had = (bcounts >> HAD_BIT) > 0
                            bcounts = bcounts & ((1 << HAD_BIT) - 1)
                        else:
                            raw_had = bcounts > 0
                        if collect_pairs is not None:
                            pair_ranks = pairs.numpy()[:nb]
                            # more passing targets than the pair plane holds
                            t_pair = ((pair_ranks >= 0).sum(axis=2) < bcounts) & live & ~needs
                            if t_pair.any():
                                self.fallback_triggers["pair_truncation"] += int(t_pair.sum())
                            needs = needs | t_pair
                        retry.extend(ids[:nb][needs].tolist())
                        ok = live & ~needs
                        ok_ids = ids[:nb][ok]
                        counts[ok_ids] = bcounts[ok]
                        had[ok_ids] = raw_had[ok]
                        if collect_pairs is not None:
                            for qid, pr in zip(ok_ids, pair_ranks[ok]):
                                collect_pairs[qid] = self._ranks_to_rids(pr[pr >= 0])
            # stage 3: exact host recompute of the flagged rows
            with span("retry"):
                with span("retry.recount"):
                    take_host(retry, host_fn([(names[i], seqs[i]) for i in retry]))
                fallback = len(retry)
                if host_future is not None:
                    with span("retry.join"):
                        take_host(host_rows_all, host_future.result())
                        share_set = set(host_share_rows)
                        for i in host_rows_all:
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
        self._device_call = self._call
        if fallback:
            logger.debug(
                "device path: %d/%d rows fell back to host (%s)", fallback, n,
                dict(self.fallback_triggers),
            )
        if logger.isEnabledFor(logging.DEBUG):
            rec, _ = self._call
            logger.debug("device path phases: %s", {s.name: round(s.duration, 2) for s in rec.children(call)})
        return BatchCounts(counts, had, fallback)
