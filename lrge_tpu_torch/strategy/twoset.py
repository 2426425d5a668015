"""Two-set estimation strategy on the PyTorch port.

The port's own copy of ``lrge_tpu/strategy/twoset.py`` (which reproduces
`liblrge/src/twoset.rs`): subsample disjoint target and query read sets,
build an index over the targets, count per-query unique target overlaps
on the device engine (``device_engine.DeviceOverlapEngine``) or the
exact host engine, and convert each count to a genome-size estimate.

Orchestration parity notes (file:line refer to the reference):

* read counting + u32 limit + too-few-reads shrink: `twoset.rs:122-151`
* one-draw-then-split sampling: `twoset.rs:153-155` (target set = the
  *last* ``target_num_reads`` sampled indices, `twoset.rs:632-652`)
* intermediate artifacts ``target.fa``/``query.fa``/``overlaps.paf`` in
  the temp dir: `twoset.rs:157-200,244`
* per-read estimate inline with unique-target counting and optional
  internal-overlap filtering: `twoset.rs:286-317`
* ``--use-min-ref``: index the smaller set by base count and stream the
  other (`twoset.rs:370-584`), including its inverted overhang filter
  (`twoset.rs:493-517` drops overhang-heavy overlaps, the opposite of
  `mapping.rs:59-77` — a reference asymmetry preserved deliberately).
"""

from __future__ import annotations

import logging
import os
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from .. import io as lio
from ..compat.rust_rand import split_into_sets, unique_random_set
from ..device_engine import DeviceOverlapEngine, overhang_heavy, resolve_engine, strategy_engine
from ..engine import OverlapEngine, ParallelHostMapper
from ..errors import DuplicateReadIdentifierError, TooFewReadsError, TooManyReadsError
from ..estimate import Estimate, per_read_estimate, per_read_estimate_batch
from ..ops.index import build_index
from ..parallel.distributed import multihost_count_batch
from ..platform import Platform, preset_for

logger = logging.getLogger("lrge")
TRACE = 5  # below DEBUG, like the reference's TRACE level
logging.addLevelName(TRACE, "TRACE")

DEFAULT_TARGET_NUM_READS = 10_000
DEFAULT_QUERY_NUM_READS = 5_000

U32_MAX = 0xFFFFFFFF

_FILTER_ON_HOST = (
    "-F/--filter-contained: this configuration needs mapping "
    "coordinates on the host; using the host engine"
)


def build_engine_no_fork(reads, params) -> OverlapEngine:
    """The strategies' index build over ``(name, seq)`` reads: raises on
    a duplicate name, then indexes the reads.  The build forks no sketch
    workers once this process holds a CUDA context (``engine.fork_unsafe``)."""
    seen = set()
    for n, _ in reads:
        if n in seen:
            raise DuplicateReadIdentifierError(n.decode("utf-8", "replace"))
        seen.add(n)
    return OverlapEngine(build_index([s for _, s in reads], [n for n, _ in reads], params))


class TwoSetStrategy(Estimate):
    """Two-set strategy (forward and ``--use-min-ref``, with or without
    ``-F``); ``engine`` is ``"host"``, ``"device"`` or ``"auto"``
    (:func:`~lrge_tpu_torch.device_engine.resolve_engine`), and
    ``device`` pins the device engine's ``torch.device``, or a list of
    devices to shard the index over (default: every visible CUDA card)."""

    def __init__(
        self,
        input_path: os.PathLike | str,
        *,
        target_num_reads: int = DEFAULT_TARGET_NUM_READS,
        query_num_reads: int = DEFAULT_QUERY_NUM_READS,
        remove_internal: bool = False,
        max_overhang_ratio: float = 0.2,
        use_min_ref: bool = False,
        tmpdir: Optional[os.PathLike | str] = None,
        threads: int = 1,
        seed: Optional[int] = None,
        platform: Platform = Platform.NANOPORE,
        engine: str = "host",
        device_paf: bool = False,
        device=None,
    ):
        self.input = Path(input_path)
        self.engine = engine
        self.device_paf = device_paf
        self.device = device
        self.target_num_reads = target_num_reads
        self.query_num_reads = query_num_reads
        self.target_num_bases = 0
        self.query_num_bases = 0
        self.remove_internal = remove_internal
        self.max_overhang_ratio = max_overhang_ratio
        self.use_min_ref = use_min_ref
        self.tmpdir = Path(tmpdir) if tmpdir is not None else Path(tempfile.gettempdir())
        self.threads = threads
        self.seed = seed
        self.platform = platform

    # -- subsampling ---------------------------------------------------

    def split_fastq(self):
        """Select target/query reads in a single streaming pass.

        Returns ``(targets, queries, avg_target_len)`` where each element
        is a list of ``(name, seq)``; also writes ``target.fa`` and
        ``query.fa`` to the temp dir like the reference.
        """
        logger.debug("Counting records in input file...")
        n_reads = lio.count_records(self.input)
        logger.debug("Found %d reads in input file", n_reads)
        if n_reads > U32_MAX:
            raise TooManyReadsError(
                f"Number of reads in input file ({n_reads}) exceeds maximum "
                f"allowed value ({U32_MAX})"
            )
        n_req = self.target_num_reads + self.query_num_reads
        if n_reads <= self.query_num_reads:
            raise TooFewReadsError(
                f"Number of reads in input file ({n_reads}) is <= query "
                f"number of reads ({self.query_num_reads})"
            )
        elif n_reads < n_req:
            logger.warning(
                "Number of reads in input file (%d) is less than the sum of "
                "target and query reads (%d)",
                n_reads,
                n_req,
            )
            self.target_num_reads = n_reads - self.query_num_reads
            n_req = n_reads
            logger.warning("Using %d target reads", self.target_num_reads)

        indices = unique_random_set(n_req, n_reads, self.seed)
        target_idx, query_idx = split_into_sets(indices, self.target_num_reads)

        targets: list[tuple[bytes, bytes]] = []
        queries: list[tuple[bytes, bytes]] = []
        sum_target = 0
        sum_query = 0
        target_path = self.tmpdir / "target.fa"
        query_path = self.tmpdir / "query.fa"
        self.tmpdir.mkdir(parents=True, exist_ok=True)
        with open(target_path, "wb") as tf, open(query_path, "wb") as qf:
            for idx, (name, seq) in enumerate(lio.iter_records(self.input)):
                if idx in target_idx:
                    target_idx.discard(idx)
                    tf.write(b">" + name + b"\n" + seq + b"\n")
                    targets.append((name, seq))
                    sum_target += len(seq)
                elif idx in query_idx:
                    query_idx.discard(idx)
                    qf.write(b">" + name + b"\n" + seq + b"\n")
                    queries.append((name, seq))
                    sum_query += len(seq)
        self.target_num_bases = sum_target
        self.query_num_bases = sum_query
        avg_target_len = np.float32(sum_target) / np.float32(self.target_num_reads)
        logger.debug("Total target bases: %d", sum_target)
        logger.debug("Total query bases: %d", sum_query)
        return targets, queries, float(avg_target_len)

    # -- alignment + estimation ---------------------------------------

    def generate_estimates(self):
        targets, queries, avg_target_len = self.split_fastq()
        if self.use_min_ref and self.target_num_bases > self.query_num_bases:
            return self._align_reads_inverse(targets, queries, avg_target_len)
        return self._align_reads(targets, queries, avg_target_len)

    def _device_paf_note(self) -> str:
        return (
            "overlaps.paf via host re-map of mapped rows"
            if self.device_paf
            else "overlaps.paf not written; pass -C/-D to produce it"
        )

    def _build_engine(self, reads):
        return build_engine_no_fork(reads, preset_for(self.platform, dual=True))

    def _write_paf_host(self, index, rows):
        """Exact ``overlaps.paf`` side output for device runs (host re-map)."""
        mapper = ParallelHostMapper(index, self.threads)
        paf_path = self.tmpdir / "overlaps.paf"
        with open(paf_path, "w") as paf:
            for recs in mapper.map_reads(rows):
                for m in recs:
                    paf.write(m.to_line() + "\n")
        mapper.close()
        logger.debug("Wrote %s from the host mapper (device run)", paf_path)

    def _align_reads(self, targets, queries, avg_target_len):
        """Index targets, stream queries (`twoset.rs:204-367`), on the
        device engine or, as in the reference, the exact host engine."""
        engine = self._build_engine(targets)
        if resolve_engine(self.engine, len(queries)) == "device":
            if not self.remove_internal:
                # the one lockstep path: under a multi-process launch its
                # engine shards over every process's devices
                return self._align_reads_device(
                    DeviceOverlapEngine(engine.index, device=self.device), queries, avg_target_len
                )
            dev = strategy_engine(engine.index, device=self.device)
            if dev.supports_device_filter():
                return self._align_reads_device(
                    dev, queries, avg_target_len, filter_ratio=self.max_overhang_ratio
                )
            # the reference's own routing (strategy/twoset.py:209-224)
            logger.info(_FILTER_ON_HOST)
        # the reference's host branch (strategy/twoset.py:225-257)
        mapper = ParallelHostMapper(engine.index, self.threads)
        overlap_threshold = engine.params.min_chain_score
        estimates = np.empty(len(queries), dtype=np.float32)
        no_mapping_count = 0
        paf_path = self.tmpdir / "overlaps.paf"
        with open(paf_path, "w") as paf:
            for qi, ((qname, seq), mappings) in enumerate(
                zip(queries, mapper.map_reads(queries))
            ):
                unique = set()
                if mappings:
                    for m in mappings:
                        paf.write(m.to_line() + "\n")
                        if self.remove_internal and m.is_internal(self.max_overhang_ratio):
                            continue
                        unique.add(m.target_name)
                else:
                    logger.debug("No overlaps found for read: %s", qname)
                    no_mapping_count += 1
                est = per_read_estimate(
                    len(seq), avg_target_len, self.target_num_reads, len(unique),
                    overlap_threshold,
                )
                logger.log(TRACE, "Estimate for %s: %s", qname.decode("utf-8", "replace"), est)
                estimates[qi] = est
        mapper.close()
        self._log_no_mapping(no_mapping_count, len(queries))
        return estimates, no_mapping_count

    def _align_reads_device(self, dev, queries, avg_target_len, filter_ratio=None):
        """Device counting path, with the ``-F`` filter applied on the
        device when ``filter_ratio`` is set (PAF side output only under
        -C/-D).  An engine sharded across processes counts in lockstep
        (:func:`~lrge_tpu_torch.parallel.distributed.multihost_count_batch`),
        every process getting the global counts."""
        logger.info(
            "Using device overlap engine on %s%s (%s)", dev.device,
            "" if filter_ratio is None else " with -F filtering", self._device_paf_note(),
        )
        names = [n for n, _ in queries]
        seqs = [s for _, s in queries]
        if dev.lockstep:
            res = multihost_count_batch(dev, names, seqs)
        else:
            dev.warmup([len(s) for s in seqs], filter_ratio=filter_ratio)
            res = dev.count_batch(names, seqs, filter_ratio=filter_ratio)
        if self.device_paf:
            self._write_paf_host(dev.index, [q for q, h in zip(queries, res.had_mapping) if h])
        no_mapping_count = int((~res.had_mapping).sum())
        estimates = per_read_estimate_batch(
            np.array([len(s) for s in seqs]), avg_target_len, self.target_num_reads,
            res.counts, dev.params.min_chain_score,
        )
        if logger.isEnabledFor(TRACE):
            for (qname, _), est in zip(queries, estimates):
                logger.log(TRACE, "Estimate for %s: %s", qname.decode("utf-8", "replace"), est)
        self._log_no_mapping(no_mapping_count, len(queries))
        return estimates.astype(np.float32), no_mapping_count

    def _align_reads_inverse(self, targets, queries, avg_target_len):
        """``--use-min-ref``: index the queries, stream the targets
        (`twoset.rs:370-584`), on the device engine or, as in the
        reference (strategy/twoset.py:338-432), the exact host engine."""
        engine = self._build_engine(queries)  # raises on duplicate query names
        # the work rows are the streamed target reads
        if resolve_engine(self.engine, len(targets)) == "device":
            dev = strategy_engine(engine.index, device=self.device)
            if not self.remove_internal:
                return self._align_reads_inverse_device(dev, targets, queries, avg_target_len)
            if dev.supports_device_filter():
                return self._align_reads_inverse_device(
                    dev, targets, queries, avg_target_len, filter_ratio=self.max_overhang_ratio
                )
            logger.info(_FILTER_ON_HOST)
        ovlap_counter = {qname: 0 for qname, _ in queries}
        mapper = ParallelHostMapper(engine.index, self.threads)
        with open(self.tmpdir / "overlaps.paf", "w") as paf:
            for mappings in mapper.map_reads(targets):
                unique = set()
                for m in mappings:
                    paf.write(m.to_line() + "\n")
                    if m.target_name in unique:
                        continue
                    if self.remove_internal and overhang_heavy(m, self.max_overhang_ratio):
                        continue
                    ovlap_counter[m.target_name] += 1
                    unique.add(m.target_name)
        mapper.close()
        counts = [ovlap_counter[qname] for qname, _ in queries]
        return self._query_estimates(queries, counts, avg_target_len, engine.params.min_chain_score)

    def _align_reads_inverse_device(self, dev, targets, queries, avg_target_len, filter_ratio=None):
        """Device ``--use-min-ref``: map the targets against the query
        index and add one to every query in a target row's passing-id
        list (the row-level dedup is the reference's per-target unique
        set, `twoset.rs:481-523`); with ``filter_ratio`` the lists hold
        only mappings passing the inverted overhang test."""
        logger.info(
            "Using device overlap engine on %s for --use-min-ref%s (%s)", dev.device,
            "" if filter_ratio is None else " with -F filtering", self._device_paf_note(),
        )
        tnames = [n for n, _ in targets]
        tseqs = [s for _, s in targets]
        dev.warmup([len(s) for s in tseqs], filter_ratio=filter_ratio, filter_mode="overhang", want_pairs=True)
        collect: dict = {}
        res = dev.count_batch(
            tnames, tseqs, collect_pairs=collect, filter_ratio=filter_ratio, filter_mode="overhang"
        )
        if self.device_paf:
            self._write_paf_host(dev.index, [t for t, h in zip(targets, res.had_mapping) if h])
        counts = np.zeros(len(queries), dtype=np.int64)
        for qid, target in enumerate(targets):
            rids = collect.get(qid)
            if rids is None:
                # a host-recomputed row without an id list: map it again
                (_, _, rids), = dev._host_count_filtered([target], filter_ratio, "overhang", want_pairs=True)
            counts[rids] += 1
        return self._query_estimates(queries, counts, avg_target_len, dev.params.min_chain_score)

    def _query_estimates(self, queries, counts, avg_target_len, overlap_threshold):
        """Per-query estimates from per-query overlap counts (inf for 0)."""
        no_mapping_count = 0
        estimates = np.empty(len(queries), dtype=np.float32)
        for i, ((qname, seq), n_ovlaps) in enumerate(zip(queries, counts)):
            if n_ovlaps == 0:
                no_mapping_count += 1
                est = float("inf")
            else:
                est = per_read_estimate(
                    len(seq), avg_target_len, self.target_num_reads, int(n_ovlaps), overlap_threshold
                )
            logger.log(TRACE, "Estimate for %s: %s", qname.decode("utf-8", "replace"), est)
            estimates[i] = est
        self._log_no_mapping(no_mapping_count, len(queries))
        return estimates, no_mapping_count

    def _log_no_mapping(self, count, total):
        if count > 0:
            pct = count / total * 100.0
            logger.info(
                "%d (%.2f%%) query read(s) did not overlap any target reads", count, pct
            )
        else:
            logger.debug("All query reads overlapped with target reads")


class TwoSetBuilder:
    """Builder mirroring `liblrge/src/twoset/builder.rs`."""

    def __init__(self):
        self._kw = {}

    def target_num_reads(self, n: int) -> "TwoSetBuilder":
        self._kw["target_num_reads"] = n
        return self

    def query_num_reads(self, n: int) -> "TwoSetBuilder":
        self._kw["query_num_reads"] = n
        return self

    def remove_internal(self, yes: bool, max_overhang_ratio: float = 0.2) -> "TwoSetBuilder":
        self._kw["remove_internal"] = yes
        self._kw["max_overhang_ratio"] = max_overhang_ratio
        return self

    def use_min_ref(self, yes: bool) -> "TwoSetBuilder":
        self._kw["use_min_ref"] = yes
        return self

    def threads(self, n: int) -> "TwoSetBuilder":
        self._kw["threads"] = n
        return self

    def tmpdir(self, path) -> "TwoSetBuilder":
        self._kw["tmpdir"] = path
        return self

    def seed(self, seed: Optional[int]) -> "TwoSetBuilder":
        self._kw["seed"] = seed
        return self

    def platform(self, platform: Platform | str) -> "TwoSetBuilder":
        if isinstance(platform, str):
            platform = Platform.from_str(platform)
        self._kw["platform"] = platform
        return self

    def engine(self, engine: str) -> "TwoSetBuilder":
        """"host" (default; writes overlaps.paf), "device" (the CUDA
        counting pipeline; PAF side output only with device_paf) or
        "auto"."""
        self._kw["engine"] = engine
        return self

    def device_paf(self, yes: bool) -> "TwoSetBuilder":
        """Write overlaps.paf on device runs (host re-map of mapped
        rows; the CLI sets this for -C/-D)."""
        self._kw["device_paf"] = yes
        return self

    def device(self, device) -> "TwoSetBuilder":
        """The device engine's ``torch.device``, or a list to shard over
        (default: every visible CUDA card)."""
        self._kw["device"] = device
        return self

    def build(self, input_path) -> TwoSetStrategy:
        return TwoSetStrategy(input_path, **self._kw)
