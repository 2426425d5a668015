"""lrge's estimator (``liblrge/src/estimate.rs``): the per-read estimate
(Equation 3 of the LRGE paper) in float32, in the reference's operation
order, then the median and two quantiles by f32 linear interpolation.

``rounding`` is applied after every operation: float32 rounding by
default; :func:`bf16` gives the control, the same arithmetic in
bfloat16."""

from __future__ import annotations

import numpy as np

LOWER_QUANTILE = 0.15
UPPER_QUANTILE = 0.65


def f32(x):
    return np.asarray(x, dtype=np.float32)


def bf16(x):
    """Round float32 values to bfloat16 (nearest, ties to even), kept in
    float32 storage."""
    b = np.atleast_1d(np.asarray(x, dtype=np.float32)).view(np.uint32).astype(np.uint64)
    b = ((b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return b.view(np.float32).reshape(np.shape(x))


def per_read(read_lens, avg_target_len: float, n_targets: int, n_ovlaps, thresh: int, rounding=f32):
    r = rounding
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        ratio = r(r(n_targets) / r(np.asarray(n_ovlaps)))
        rl = r(np.asarray(read_lens))
        inner = r(r(r(rl + r(avg_target_len)) - r(r(2.0) * r(thresh))) + r(1.0))
        est = r(rl + r(ratio * inner))
    return np.where(np.asarray(n_ovlaps) == 0, np.float32(np.inf), est)


def quantile(data, q: float, rounding=f32):
    """Linear-interpolation quantile of sorted data, position in f32."""
    r = rounding
    n = len(data)
    if n == 0:
        return None
    pos = r(r(q) * r(n - 1))
    idx = int(np.floor(pos))
    frac = r(pos - r(idx))
    if idx + 1 < n:
        with np.errstate(invalid="ignore"):
            return float(r(r(data[idx] * r(r(1.0) - frac)) + r(data[idx + 1] * frac)))
    return float(data[idx])


def estimate(read_lens, avg_target_len, n_targets, n_ovlaps, thresh, rounding=f32):
    """``(lower, median, upper)`` over the finite per-read estimates."""
    est = per_read(read_lens, avg_target_len, n_targets, n_ovlaps, thresh, rounding)
    arr = np.sort(est[np.isfinite(est)].astype(np.float32))
    return tuple(quantile(arr, q, rounding) for q in (LOWER_QUANTILE, 0.5, UPPER_QUANTILE))
