"""The control and the faults that ``correct`` has to catch, each a
wrapper of a pass's two steps (``run.run_cell``'s ``fault``):
``count(names, seqs) -> (counts, host rows)`` and ``estimate(counts,
lengths) -> (lower, median, upper)``.

* ``control_bf16``: the reference's estimator put in the program's
  place in bfloat16, the precision below the float32 the configuration
  states; the counts stay the program's.
* ``zeros``: the pass returns counts it never filled.
* ``half``: the second half of the queries left out, the estimate taken
  over the rest.
* ``altered``: every twentieth query's count one higher where it is
  produced.
"""

from __future__ import annotations

import numpy as np

from .reference import estimate as ref_estimate


def control_bf16(count, estimate, ctx):
    def est(counts, lens):
        return ref_estimate.estimate(
            lens, ctx["avg_target_len"], ctx["n_targets"], counts, ctx["threshold"], ref_estimate.bf16
        )

    return count, est


def zeros(count, estimate, ctx):
    def cnt(names, seqs):
        return np.zeros(len(seqs), dtype=np.int32), 0

    return cnt, estimate


def half(count, estimate, ctx):
    def cnt(names, seqs):
        h = len(seqs) // 2
        counts, host = count(names[:h], seqs[:h])
        return np.concatenate([counts, np.zeros(len(seqs) - h, dtype=counts.dtype)]), host

    def est(counts, lens):
        h = len(lens) // 2
        return estimate(counts[:h], lens[:h])

    return cnt, est


def altered(count, estimate, ctx):
    def cnt(names, seqs):
        counts, host = count(names, seqs)
        counts = np.array(counts, copy=True)
        counts[::20] += 1
        return counts, host

    return cnt, estimate


FAULTS = {"zeros": zeros, "half": half, "altered": altered}
