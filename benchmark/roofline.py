"""The chain DP's work, counted from the reference's anchors, and its
least time on the card.

Work.  The device chains each row's anchors run by run, a run being one
(target, strand) of the row, sorted by target position.  Anchor ``i`` of
a run (from 0) needs ``min(i, W)`` predecessor evaluations within the DP
window ``W``.  The rows counted are those the engine sends to the
device, as it plans a pass (read off the engine before it is freed),
less those whose anchors overflow their bucket's buffer: the device does
not finish those (the host recounts them), so what is counted is never
more than the kernel did.

Operations a predecessor evaluation, minimap2's ``comp_sc`` and the
``mm_chain_dp`` loop around it (``lchain.c``):
  dq = yi - yj; its two range tests                          3
  dr = xi - xj; dr == 0 and the dq > max_dist_y test         3
  dd = |dr - dq| (sub, abs); dd > bw                         3
  dg = min(dr, dq); q_span = yj >> 32 & 0xff; sc = min       4
  the penalty gate dd || dg > q_span                         2
  lin_pen = pen_gap*(float)dd + pen_skip*(float)dg           5
  dd >= 1 ? mg_log2(dd + 1): test, add, convert              3
  mg_log2 (bit trick): shift, and, convert, sub, and-not,
    add, then (-a*z + b)*z - c and its add: 11               11
  sc -= (int)(lin_pen + .5f*log_pen): mul, add, cvt, sub     4
  the loop: same run, sc + f[j], > max_f, the skip counter   5
                                                       total 43
Bytes: each anchor's four int32 inputs read once and the DP's int32
outputs written once (``f`` and ``broke``; with spans also ``cnt``),
and each row's anchor count.

Peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): 67 TFLOP/s in
float32 outside the tensor cores, counting every operation above as
one, and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

import numpy as np

PEAK_OPS = 67e12
PEAK_BYTES = 3.35e12
OPS_PER_EVAL = 43
IN_BYTES = 16
OUT_BYTES = {False: 8, True: 12}
ROW_BYTES = 4


def run_evals(n: np.ndarray, W: int) -> np.ndarray:
    """``sum(min(i, W) for i in range(n))`` for each run length ``n``."""
    n = np.asarray(n, dtype=np.int64)
    return np.where(n <= W, n * (n - 1) // 2, W * (W - 1) // 2 + (n - W) * W)


def device_plan(engine, queries) -> dict:
    """``{row: A}`` of the rows that the engine sends to a length bucket
    on the device, each with its bucket's anchor capacity, as the engine
    plans a pass over ``queries`` (``plan_rows``, ``bucket_shape``)."""
    _, _, bucket_rows = engine.plan_rows(queries, range(len(queries)))
    return {i: engine.bucket_shape(L)[0] for L, rows in bucket_rows.items() for i in rows}


def _runs(a) -> np.ndarray:
    """The lengths of the runs of anchors ``a`` (one run of 0 where there are none)."""
    key2 = a.rid.astype(np.int64) * 2 + a.strand
    starts = np.flatnonzero(np.concatenate(([True], key2[1:] != key2[:-1])))
    return np.diff(np.concatenate((starts, [len(a)])))


def pass_work(ref, plan: dict, W: int) -> dict:
    """One pass's counted chain DP work over the reference's anchors of
    the rows of ``plan`` (``device_plan``) whose anchors fit."""
    evals = anchors = runs = rows = 0
    for (row, A), lens in zip(plan.items(), ref.map_anchors(_runs, list(plan))):
        n = int(lens.sum())
        if n == 0 or n > A:
            continue
        evals += int(run_evals(lens, W).sum())
        anchors += n
        runs += len(lens)
        rows += 1
    return {"evals": evals, "anchors": anchors, "runs": runs, "rows": rows}


def least_time(work: dict, spans: bool) -> tuple[float, str]:
    """``(seconds, the bound that binds)`` of one pass's work."""
    ops = work["evals"] * OPS_PER_EVAL
    nbytes = work["anchors"] * (IN_BYTES + OUT_BYTES[spans]) + work["rows"] * ROW_BYTES
    t_ops, t_bytes = ops / PEAK_OPS, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
