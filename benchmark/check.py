"""How ``correct`` is decided: the program's counts and estimate held to
the plain reference (``benchmark/reference``), worked out again from the
same reads.

Three numbers, each exact (limit 0):

* ``rows_wrong``: rows of a sample drawn from the seed (``SAMPLE_RANDOM``
  rows, plus the ``SAMPLE_LONGEST`` longest queries, which are the ones
  most likely to overflow the anchor buffer and go to the host) whose
  count in the window's last pass differs from the reference's count;
* ``passes_unequal``: passes of the window whose counts differ from the
  last pass's anywhere;
* ``estimate_gap_bp``: the largest gap between the program's estimate,
  lower and upper quantile of the last pass and the reference
  estimator's over the same counts.

The reference runs after the window, once the program's state is freed,
in worker processes (``benchmark/workers.py``, NumPy only): the
targets' and queries' sketches, then the sampled rows' chaining (the
rows' anchors are collected in threads here, against the index).
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .corpus import rng_for
from .reference import chain, estimate, index
from .reference.params import Params

SAMPLE_RANDOM = 256
SAMPLE_LONGEST = 16
LIMITS = {"rows_wrong": 0, "passes_unequal": 0, "estimate_gap_bp": 0}


def _chunks(items: list, n: int) -> list:
    step = max(1, -(-len(items) // n))
    return [items[i : i + step] for i in range(0, len(items), step)]


class Reference:
    """The reference's index of one corpus, and its queries' sketches as
    they are asked for (the check needs only its sample's)."""

    def __init__(self, corpus, p: Params, pool):
        self.p = p
        self.corpus = corpus
        self.pool = pool
        self.query_sketches = {}
        self.index = index.build(self._sketch(corpus.targets), corpus.tnames, p)

    def _sketch(self, seqs: list) -> list:
        jobs = [(c, self.p.k, self.p.w, self.p.hpc) for c in _chunks(seqs, self.pool.n_workers * 4)]
        return [mz for part in self.pool.map("sketch", jobs) for mz in part]

    def sketch_queries(self, rows) -> None:
        """Sketch the queries of ``rows`` not sketched yet."""
        todo = [int(r) for r in rows if int(r) not in self.query_sketches]
        if todo:
            self.query_sketches.update(zip(todo, self._sketch([self.corpus.queries[r] for r in todo])))

    def anchors(self, row: int) -> chain.Anchors:
        self.sketch_queries([row])
        q = self.corpus.queries[row]
        return chain.collect_anchors(self.index, self.query_sketches[int(row)], len(q), self.p)

    def map_anchors(self, fn, rows) -> list:
        """``fn`` of the anchors of each of ``rows``, in threads: NumPy
        lets go of the interpreter lock in the lookups, gathers and
        sorts."""
        self.sketch_queries(rows)
        with ThreadPoolExecutor(self.pool.n_workers) as threads:
            return list(threads.map(lambda r: fn(self.anchors(r)), rows))

    def counts(self, rows) -> np.ndarray:
        """The reference counts of ``rows``."""
        anchors = self.map_anchors(lambda a: a, rows)
        jobs = [(c, self.p) for c in _chunks(anchors, self.pool.n_workers * 4)]
        return np.array([c for part in self.pool.map("count", jobs) for c in part], dtype=np.int64)

    def estimate(self, counts, rounding=estimate.f32) -> tuple:
        c = self.corpus
        n_t = len(c.targets)
        avg = np.float32(sum(len(t) for t in c.targets)) / np.float32(n_t)
        qlens = np.array([len(q) for q in c.queries])
        return estimate.estimate(qlens, float(avg), n_t, counts, self.p.min_chain_score, rounding)


def sample_rows(seed: int, qlens) -> np.ndarray:
    """``SAMPLE_RANDOM`` rows drawn from the seed and the
    ``SAMPLE_LONGEST`` longest, sorted."""
    qlens = np.asarray(qlens)
    n = len(qlens)
    rng = rng_for(seed + 1)
    rand = rng.choice(n, size=min(SAMPLE_RANDOM, n), replace=False)
    longest = np.argsort(-qlens, kind="stable")[:SAMPLE_LONGEST]
    return np.unique(np.concatenate([rand, longest]))


def estimate_gap(a: tuple, b: tuple) -> float:
    """The largest gap between two ``(lower, median, upper)`` triples; a
    value that only one side has counts as the whole of it, and a gap
    that is not finite as the largest float."""
    gap = 0.0
    for x, y in zip(a, b):
        if x is None and y is None:
            continue
        d = abs(float(x if x is not None else 0.0) - float(y if y is not None else 0.0)) if x != y else 0.0
        gap = max(gap, d if np.isfinite(d) else sys.float_info.max)
    return gap


def judge(ref: Reference, seed: int, pass_counts: list, last_estimate: tuple) -> dict:
    """The three numbers of the window's passes (``pass_counts``: one
    count array a pass) and the last pass's estimate."""
    last = np.asarray(pass_counts[-1])
    rows = sample_rows(seed, [len(q) for q in ref.corpus.queries])
    want = ref.counts(rows)
    return {
        "rows_wrong": int((last[rows] != want).sum()),
        "passes_unequal": int(sum(not np.array_equal(c, last) for c in pass_counts)),
        "estimate_gap_bp": estimate_gap(tuple(last_estimate), ref.estimate(last)),
        "rows_checked": int(len(rows)),
    }
