"""Two-set strategy on the PyTorch device engine.

Subclasses ``lrge_tpu.strategy.twoset.TwoSetStrategy`` and overrides the
methods that choose and run an engine: the reference versions import its
JAX device engine even when the host engine is chosen.  Subsampling,
the host engine and the estimator are the reference's own; the index
build is too, minus forked sketch workers once CUDA is live.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from lrge_tpu.engine import OverlapEngine, ParallelHostMapper
from lrge_tpu.errors import DuplicateReadIdentifierError
from lrge_tpu.estimate import per_read_estimate, per_read_estimate_batch
from lrge_tpu.ops.index import build_index
from lrge_tpu.platform import preset_for
from lrge_tpu.strategy.twoset import TRACE
from lrge_tpu.strategy.twoset import TwoSetBuilder as _RefTwoSetBuilder
from lrge_tpu.strategy.twoset import TwoSetStrategy as _RefTwoSetStrategy

from ..device_engine import DeviceOverlapEngine, default_device, overhang_heavy, resolve_engine

logger = logging.getLogger("lrge")

_FILTER_ON_HOST = (
    "-F/--filter-contained: this configuration needs mapping "
    "coordinates on the host; using the host engine"
)


def build_engine_no_fork(reads, params) -> OverlapEngine:
    """The reference strategies' index build over ``(name, seq)`` reads:
    raises on a duplicate name, then indexes the reads.  It forks no
    sketch workers once this process holds a CUDA context (a forked
    child inherits it unusable; the reference's guard only knows JAX):
    without the native sketcher it then sketches serially.  The index
    is the same either way."""
    from lrge_tpu.native import native

    names = [n for n, _ in reads]
    seen = set()
    for n in names:
        if n in seen:
            raise DuplicateReadIdentifierError(n.decode("utf-8", "replace"))
        seen.add(n)
    threads = 1 if native is None and torch.cuda.is_initialized() else 8
    return OverlapEngine(build_index([s for _, s in reads], names, params, threads=threads))


class _HostMapper(ParallelHostMapper):
    """``ParallelHostMapper`` that maps on threads, never on forked
    workers, once this process holds a CUDA context (a forked child
    inherits it in an unusable state; the reference's fork guard only
    knows about JAX)."""

    def __init__(self, index, threads: int):
        if threads > 1 and torch.cuda.is_initialized():
            super().__init__(index, 1)  # sets up the shared engine, no pool
            self.threads = threads
            self._thread_pool = ThreadPoolExecutor(threads)
        else:
            super().__init__(index, threads)


class TwoSetStrategy(_RefTwoSetStrategy):
    """Two-set strategy (forward and ``--use-min-ref``, with or without
    ``-F``); ``device`` pins the device engine's ``torch.device``
    (default: the one CUDA card)."""

    def __init__(self, input_path, *, device: torch.device | None = None, **kw):
        super().__init__(input_path, **kw)
        self.device = device

    def _build_engine(self, reads):
        return build_engine_no_fork(reads, preset_for(self.platform, dual=True))

    def _device_engine(self, index) -> DeviceOverlapEngine:
        device = self.device if self.device is not None else default_device()
        return DeviceOverlapEngine(index, device=device)

    def _write_paf_host(self, index, rows):
        """Exact ``overlaps.paf`` side output for device runs (host re-map)."""
        mapper = _HostMapper(index, self.threads)
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
            dev = self._device_engine(engine.index)
            if not self.remove_internal:
                return self._align_reads_device(dev, queries, avg_target_len)
            if dev.supports_device_filter():
                return self._align_reads_device(
                    dev, queries, avg_target_len, filter_ratio=self.max_overhang_ratio
                )
            # the reference's own routing (strategy/twoset.py:209-224)
            logger.info(_FILTER_ON_HOST)
        # the reference's host branch (strategy/twoset.py:225-257)
        mapper = _HostMapper(engine.index, self.threads)
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
        -C/-D)."""
        logger.info(
            "Using device overlap engine on %s%s (%s)", dev.device,
            "" if filter_ratio is None else " with -F filtering", self._device_paf_note(),
        )
        names = [n for n, _ in queries]
        seqs = [s for _, s in queries]
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
            dev = self._device_engine(engine.index)
            if not self.remove_internal:
                return self._align_reads_inverse_device(dev, targets, queries, avg_target_len)
            if dev.supports_device_filter():
                return self._align_reads_inverse_device(
                    dev, targets, queries, avg_target_len, filter_ratio=self.max_overhang_ratio
                )
            logger.info(_FILTER_ON_HOST)
        ovlap_counter = {qname: 0 for qname, _ in queries}
        mapper = _HostMapper(engine.index, self.threads)
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


class TwoSetBuilder(_RefTwoSetBuilder):
    """The reference builder, building the port's strategy."""

    def device(self, device: torch.device | None) -> "TwoSetBuilder":
        self._kw["device"] = device
        return self

    def build(self, input_path) -> TwoSetStrategy:
        return TwoSetStrategy(input_path, **self._kw)
