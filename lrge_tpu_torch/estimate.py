"""Per-read genome-size estimator and median/quantile math.

This module reproduces the reference's estimator numerics *exactly* in
IEEE binary32, because the final genome-size integer must be
bit-identical to `lrge`:

* ``per_read_estimate`` — Equation 3 of the LRGE paper, evaluated in the
  same f32 operation order as `liblrge/src/estimate.rs:142-157`.
* ``median`` / ``calculate_quantile`` — sort + linear interpolation with
  f32 position arithmetic, `liblrge/src/estimate.rs:80-132`.

Large vectors of per-read estimates are produced on-device by the
overlap engine; the final reduction here is tiny and runs on host where
exact scalar f32 semantics are easy to guarantee.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

# Quantiles found to give the highest confidence (~92% CI) in the LRGE
# paper (`estimate.rs:4-6`).
LOWER_QUANTILE = 0.15
UPPER_QUANTILE = 0.65

_f32 = np.float32


@dataclass
class EstimateResult:
    """Result of an estimate (reference: `estimate.rs:8-17`)."""

    lower: Optional[float]
    estimate: Optional[float]
    upper: Optional[float]
    no_mapping_count: int


def per_read_estimate(
    read_len: int,
    avg_target_len: float,
    n_target_reads: int,
    n_ovlaps: int,
    ovlap_thresh: int,
) -> float:
    """Per-read genome size estimate (f32), `estimate.rs:142-157`.

    Returns ``inf`` when the read has no overlaps.
    """
    if n_ovlaps == 0:
        return float("inf")
    with np.errstate(over="ignore"):
        ovlap_ratio = _f32(_f32(n_target_reads) / _f32(n_ovlaps))
        # Rust evaluates: read_len + ratio * (read_len + avg - 2*thresh + 1)
        # left-to-right; keep the same association.
        inner = _f32(
            _f32(_f32(_f32(read_len) + _f32(avg_target_len)) - _f32(_f32(2.0) * _f32(ovlap_thresh)))
            + _f32(1.0)
        )
        return float(_f32(_f32(read_len) + _f32(ovlap_ratio * inner)))


def per_read_estimate_batch(
    read_lens: np.ndarray,
    avg_target_len: float,
    n_target_reads: int,
    n_ovlaps: np.ndarray,
    ovlap_thresh: int,
) -> np.ndarray:
    """Vectorised f32 version of :func:`per_read_estimate`.

    Matches the scalar function bit-for-bit (same operation order, all
    intermediates f32); reads with zero overlaps get ``+inf``
    (`estimate.rs:149-151`).
    """
    read_lens = np.asarray(read_lens)
    n_ovlaps = np.asarray(n_ovlaps)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        ratio = (_f32(n_target_reads) / n_ovlaps.astype(np.float32)).astype(np.float32)
        rl = read_lens.astype(np.float32)
        inner = ((rl + _f32(avg_target_len)) - _f32(_f32(2.0) * _f32(ovlap_thresh))).astype(
            np.float32
        ) + _f32(1.0)
        est = (rl + (ratio * inner.astype(np.float32)).astype(np.float32)).astype(np.float32)
    return np.where(n_ovlaps == 0, np.float32(np.inf), est)


def calculate_quantile(data: np.ndarray, quantile: float) -> Optional[float]:
    """Linear-interpolation quantile of *sorted* f32 data.

    Reproduces `estimate.rs:114-132`: the fractional position is computed
    in f32 (``quantile * (n - 1) as f32``), and interpolation is
    ``data[idx]*(1-frac) + data[idx+1]*frac`` in f32.
    """
    n = len(data)
    if n == 0:
        return None
    if not (0.0 <= quantile <= 1.0):
        raise ValueError("Quantile must be between 0.0 and 1.0")
    pos = _f32(_f32(quantile) * _f32(n - 1))
    idx = int(np.floor(pos))
    frac = _f32(pos - _f32(idx))
    if idx + 1 < n:
        with np.errstate(invalid="ignore"):
            lo = _f32(data[idx] * _f32(_f32(1.0) - frac))
            hi = _f32(data[idx + 1] * frac)
            return float(_f32(lo + hi))
    return float(data[idx])


def median(
    values: Sequence[float] | np.ndarray,
    lower_quant: Optional[float] = None,
    upper_quant: Optional[float] = None,
) -> tuple[Optional[float], Optional[float], Optional[float]]:
    """(lower, median, upper) quantiles, `estimate.rs:80-112`.

    Infinities participate in the sort exactly as Rust's ``partial_cmp``
    order does (ascending, ``-inf < finite < +inf``); NaNs are not
    expected, mirroring the reference's unwrap.
    """
    arr = np.asarray(values, dtype=np.float32)
    if arr.size == 0:
        return (None, None, None)
    if np.isnan(arr).any():
        raise ValueError("NaN values are not supported in estimates")
    arr = np.sort(arr)  # ascending; IEEE total order for non-NaN matches Rust
    med = calculate_quantile(arr, 0.5)
    lo = calculate_quantile(arr, lower_quant) if lower_quant is not None else None
    hi = calculate_quantile(arr, upper_quant) if upper_quant is not None else None
    return (lo, med, hi)


class Estimate:
    """Base strategy interface (reference trait `estimate.rs:21-78`).

    Subclasses implement :meth:`generate_estimates`; :meth:`estimate`
    provides the default median/quantile reduction with optional
    filtering of infinite per-read estimates.
    """

    def generate_estimates(self) -> tuple[np.ndarray, int]:
        raise NotImplementedError

    def estimate(
        self,
        finite: bool = True,
        lower_quant: Optional[float] = LOWER_QUANTILE,
        upper_quant: Optional[float] = UPPER_QUANTILE,
    ) -> EstimateResult:
        estimates, no_mapping_count = self.generate_estimates()
        arr = np.asarray(estimates, dtype=np.float32)
        if finite:
            arr = arr[np.isfinite(arr)]
        lo, med, hi = median(arr, lower_quant, upper_quant)
        return EstimateResult(
            lower=lo, estimate=med, upper=hi, no_mapping_count=int(no_mapping_count)
        )
