"""All-vs-all estimation strategy on the PyTorch port.

The port's own copy of ``lrge_tpu/strategy/ava.py`` (which reproduces
`liblrge/src/ava.rs`): subsample one read set, overlap it against
itself with the no-dual mask set (each unordered pair found once, from
the lexicographically smaller query), count symmetrically with
unordered-pair dedup, and estimate with n-1 averaging.

Parity notes: self-overlap skip `ava.rs:277-281`; seen-pairs dedup
`ava.rs:289-298`; symmetric increments `ava.rs:300-301`; zero-overlap
reads get infinite estimates `ava.rs:329-335`; ``avg_read_len =
sum_len/(n-1)`` and ``n_target = n-1`` (`ava.rs:339-345`).
"""

from __future__ import annotations

import logging
import os
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from .. import io as lio
from ..compat.rust_rand import unique_random_set
from ..device_engine import resolve_engine, strategy_engine
from ..engine import ParallelHostMapper
from ..errors import TooManyReadsError
from ..estimate import Estimate, per_read_estimate
from ..platform import Platform, preset_for
from .twoset import _FILTER_ON_HOST, TRACE, U32_MAX, build_engine_no_fork

logger = logging.getLogger("lrge")

DEFAULT_AVA_NUM_READS = 25_000


class AvaStrategy(Estimate):
    """All-vs-all strategy (``-n``, with or without ``-F``); ``device``
    pins the device engine's ``torch.device``, or a list to shard over
    (default: every visible CUDA card).  Under a multi-process launch it
    runs replicated on each process's devices, rank 0 printing."""

    def __init__(
        self,
        input_path: os.PathLike | str,
        *,
        num_reads: int = DEFAULT_AVA_NUM_READS,
        remove_internal: bool = False,
        max_overhang_ratio: float = 0.2,
        tmpdir: Optional[os.PathLike | str] = None,
        threads: int = 1,
        seed: Optional[int] = None,
        platform: Platform = Platform.NANOPORE,
        engine: str = "host",
        device_paf: bool = False,
        device=None,
    ):
        self.engine = engine
        self.device_paf = device_paf
        self.device = device
        self.input = Path(input_path)
        self.num_reads = num_reads
        self.num_bases = 0
        self.remove_internal = remove_internal
        self.max_overhang_ratio = max_overhang_ratio
        self.tmpdir = Path(tmpdir) if tmpdir is not None else Path(tempfile.gettempdir())
        self.threads = threads
        self.seed = seed
        self.platform = platform

    def subsample_reads(self):
        logger.debug("Counting records in input file...")
        n_reads = lio.count_records(self.input)
        logger.debug("Found %d reads in input file", n_reads)
        if n_reads > U32_MAX:
            raise TooManyReadsError(
                f"Number of reads in input file ({n_reads}) exceeds maximum "
                f"allowed value ({U32_MAX})"
            )
        if n_reads < self.num_reads:
            logger.warning(
                "Number of reads in input file (%d) is less than the number "
                "requested (%d)",
                n_reads,
                self.num_reads,
            )
            self.num_reads = n_reads
        indices = set(unique_random_set(self.num_reads, n_reads, self.seed))
        reads = []
        sum_len = 0
        self.tmpdir.mkdir(parents=True, exist_ok=True)
        out_path = self.tmpdir / "reads.fa"
        with open(out_path, "wb") as fh:
            for idx, (name, seq) in enumerate(lio.iter_records(self.input)):
                if idx in indices:
                    indices.discard(idx)
                    fh.write(b">" + name + b"\n" + seq + b"\n")
                    reads.append((name, seq))
                    sum_len += len(seq)
        self.num_bases = sum_len
        return reads, sum_len

    def generate_estimates(self):
        """The reference's `ava.rs` flow (strategy/ava.py:100-190): one
        index over the subsample, each read mapped against it with the
        no-dual mask, symmetric unordered-pair counting."""
        reads, sum_len = self.subsample_reads()
        engine = self._build_engine(reads)
        read_lengths = {n: len(s) for n, s in reads}
        if resolve_engine(self.engine, len(reads)) == "device":
            dev = strategy_engine(engine.index, device=self.device)
            if not self.remove_internal:
                return self._count_device(engine, reads, sum_len, read_lengths, dev=dev)
            if dev.supports_device_filter():
                return self._count_device(
                    engine, reads, sum_len, read_lengths, dev=dev,
                    filter_ratio=self.max_overhang_ratio,
                )
            logger.info(_FILTER_ON_HOST)
        mapper = ParallelHostMapper(engine.index, self.threads)
        ovlap_counter: dict[bytes, int] = {}
        seen_pairs: set[tuple[bytes, bytes]] = set()
        with open(self.tmpdir / "overlaps.paf", "w") as paf:
            for (qname, _), mappings in zip(reads, mapper.map_reads(reads)):
                for m in mappings:
                    paf.write(m.to_line() + "\n")
                    tname = m.target_name
                    if qname == tname:
                        continue
                    if self.remove_internal and m.is_internal(self.max_overhang_ratio):
                        continue
                    pair = (qname, tname) if qname < tname else (tname, qname)
                    if pair in seen_pairs:
                        continue
                    seen_pairs.add(pair)
                    ovlap_counter[tname] = ovlap_counter.get(tname, 0) + 1
                    ovlap_counter[qname] = ovlap_counter.get(qname, 0) + 1
        mapper.close()
        return self._estimates(ovlap_counter, read_lengths, sum_len, engine.params.min_chain_score)

    def _build_engine(self, reads):
        """Index the subsample with the no-dual preset (raises on a
        duplicate name)."""
        return build_engine_no_fork(reads, preset_for(self.platform, dual=False))

    def _count_device(self, engine, reads, sum_len, read_lengths, dev=None, filter_ratio=None):
        """Device counting with symmetric pair accumulation: the no-dual
        mask finds each unordered pair once, from the smaller name, and
        the pair increments both reads (`ava.rs:289-301`).  With
        ``filter_ratio`` the pair lists hold only non-internal targets
        (`ava.rs:283-287`).  PAF side output only under -C/-D."""
        logger.info(
            "Using device overlap engine on %s%s (%s)", dev.device,
            "" if filter_ratio is None else " with -F filtering",
            "overlaps.paf via host re-map of mapped rows"
            if self.device_paf
            else "overlaps.paf not written; pass -C/-D to produce it",
        )
        names = [n for n, _ in reads]
        seqs = [s for _, s in reads]
        dev.warmup([len(s) for s in seqs], filter_ratio=filter_ratio, want_pairs=True)
        pairs: dict[int, np.ndarray] = {}
        res = dev.count_batch(names, seqs, collect_pairs=pairs, filter_ratio=filter_ratio)
        if self.device_paf:
            mapper = ParallelHostMapper(engine.index, self.threads)
            rows = [r for r, h in zip(reads, res.had_mapping) if h]
            with open(self.tmpdir / "overlaps.paf", "w") as paf:
                for recs in mapper.map_reads(rows):
                    for m in recs:
                        paf.write(m.to_line() + "\n")
            mapper.close()
        ovlap_counter = {nm: 0 for nm in names}
        for qid, read in enumerate(reads):
            rids = pairs.get(qid)
            if rids is None:
                # a host-recomputed row without an id list: map it again
                (_, _, rids), = dev._host_count_filtered([read], filter_ratio, want_pairs=True)
            for t in rids:
                tname = engine.index.names[int(t)]
                if tname != read[0]:
                    ovlap_counter[tname] += 1
                    ovlap_counter[read[0]] += 1
        return self._estimates(ovlap_counter, read_lengths, sum_len, engine.params.min_chain_score)

    def _estimates(self, ovlap_counter, read_lengths, sum_len, overlap_threshold):
        """Per-read estimates in subsample order (inf for reads with no
        overlap), with the reference's n-1 averaging (`ava.rs:329-345`)."""
        no_mapping_count = 0
        estimates = np.empty(len(read_lengths), dtype=np.float32)
        avg_read_len = float(np.float32(sum_len) / np.float32(self.num_reads - 1))
        for i, rid_name in enumerate(read_lengths):
            n_ovlaps = ovlap_counter.get(rid_name, 0)
            if n_ovlaps == 0:
                no_mapping_count += 1
                logger.debug("No overlaps found for read: %s", rid_name)
                est = float("inf")
            else:
                est = per_read_estimate(
                    read_lengths[rid_name], avg_read_len, self.num_reads - 1, n_ovlaps,
                    overlap_threshold,
                )
            logger.log(TRACE, "Estimate for %s: %s", rid_name.decode("utf-8", "replace"), est)
            estimates[i] = est
        if no_mapping_count > 0:
            pct = no_mapping_count / self.num_reads * 100.0
            logger.info("%d (%.2f%%) read(s) did not overlap any other reads", no_mapping_count, pct)
        else:
            logger.debug("All reads had at least one overlap")
        return estimates, no_mapping_count


class AvaBuilder:
    """Builder mirroring `liblrge/src/ava/builder.rs`."""

    def __init__(self):
        self._kw = {}

    def num_reads(self, n: int) -> "AvaBuilder":
        self._kw["num_reads"] = n
        return self

    def remove_internal(self, yes: bool, max_overhang_ratio: float = 0.2) -> "AvaBuilder":
        self._kw["remove_internal"] = yes
        self._kw["max_overhang_ratio"] = max_overhang_ratio
        return self

    def threads(self, n: int) -> "AvaBuilder":
        self._kw["threads"] = n
        return self

    def tmpdir(self, path) -> "AvaBuilder":
        self._kw["tmpdir"] = path
        return self

    def seed(self, seed: Optional[int]) -> "AvaBuilder":
        self._kw["seed"] = seed
        return self

    def platform(self, platform: Platform | str) -> "AvaBuilder":
        if isinstance(platform, str):
            platform = Platform.from_str(platform)
        self._kw["platform"] = platform
        return self

    def engine(self, engine: str) -> "AvaBuilder":
        self._kw["engine"] = engine
        return self

    def device_paf(self, yes: bool) -> "AvaBuilder":
        """Write overlaps.paf on device runs (host re-map of mapped
        rows; the CLI sets this for -C/-D)."""
        self._kw["device_paf"] = yes
        return self

    def device(self, device) -> "AvaBuilder":
        """The device engine's ``torch.device``, or a list to shard over
        (default: every visible CUDA card)."""
        self._kw["device"] = device
        return self

    def build(self, input_path) -> AvaStrategy:
        return AvaStrategy(input_path, **self._kw)
