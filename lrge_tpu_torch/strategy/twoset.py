"""Two-set strategy on the PyTorch device engine.

Subclasses ``lrge_tpu.strategy.twoset.TwoSetStrategy`` and overrides the
methods that choose and run an engine: the reference versions import its
JAX device engine even when the host engine is chosen.  Subsampling,
index build, the host engine and the estimator are the reference's own.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from lrge_tpu.engine import ParallelHostMapper
from lrge_tpu.estimate import per_read_estimate, per_read_estimate_batch
from lrge_tpu.strategy.twoset import TRACE
from lrge_tpu.strategy.twoset import TwoSetBuilder as _RefTwoSetBuilder
from lrge_tpu.strategy.twoset import TwoSetStrategy as _RefTwoSetStrategy

from ..device_engine import DeviceOverlapEngine, default_device, resolve_engine

logger = logging.getLogger("lrge")


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
    """Forward two-set strategy; ``device`` pins the device engine's
    ``torch.device`` (default: the one CUDA card)."""

    def __init__(self, input_path, *, device: torch.device | None = None, **kw):
        if kw.get("use_min_ref"):
            raise NotImplementedError("--use-min-ref: ROADMAP.md item 9")
        super().__init__(input_path, **kw)
        self.device = device

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
            if self.remove_internal:
                raise NotImplementedError(
                    "-F/--filter-contained on the device engine: ROADMAP.md item 10"
                )
            return self._align_reads_device(engine, queries, avg_target_len)
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

    def _align_reads_device(self, engine, queries, avg_target_len):
        """Device counting path (PAF side output only under -C/-D)."""
        device = self.device if self.device is not None else default_device()
        logger.info("Using device overlap engine on %s (%s)", device, self._device_paf_note())
        dev = DeviceOverlapEngine(engine.index, device=device)
        names = [n for n, _ in queries]
        seqs = [s for _, s in queries]
        dev.warmup([len(s) for s in seqs])
        res = dev.count_batch(names, seqs)
        if self.device_paf:
            self._write_paf_host(engine.index, [q for q, h in zip(queries, res.had_mapping) if h])
        no_mapping_count = int((~res.had_mapping).sum())
        estimates = per_read_estimate_batch(
            np.array([len(s) for s in seqs]), avg_target_len, self.target_num_reads,
            res.counts, engine.params.min_chain_score,
        )
        if logger.isEnabledFor(TRACE):
            for (qname, _), est in zip(queries, estimates):
                logger.log(TRACE, "Estimate for %s: %s", qname.decode("utf-8", "replace"), est)
        self._log_no_mapping(no_mapping_count, len(queries))
        return estimates.astype(np.float32), no_mapping_count


class TwoSetBuilder(_RefTwoSetBuilder):
    """The reference builder, building the port's strategy."""

    def device(self, device: torch.device | None) -> "TwoSetBuilder":
        self._kw["device"] = device
        return self

    def build(self, input_path) -> TwoSetStrategy:
        return TwoSetStrategy(input_path, **self._kw)
