"""lrge_tpu_torch — the PyTorch/CUDA port of lrge_tpu.

The same CLI, library surface and estimates as ``lrge_tpu``, with the
device overlap engine written in PyTorch and its chain DP as a
hand-written CUDA kernel for Hopper.  The host layers (I/O,
subsampling, index build, the exact host engine and its native C++
extension, the estimator) are this package's own copies of
``lrge_tpu``'s, at the same relative paths.  This package imports
neither JAX nor ``lrge_tpu``.

    python -m lrge_tpu_torch reads.fq

Public API, the reference library surface (`liblrge/src/lib.rs`):

    from lrge_tpu_torch import twoset, Estimate
    est = (twoset.Builder()
           .target_num_reads(10_000)
           .query_num_reads(5_000)
           .seed(42)
           .engine("auto")              # the CUDA engine on a card
           .build("reads.fq")
           .estimate(finite=True))

``.device(torch.device("cpu"))`` with ``.engine("device")`` runs the
device pipeline on the CPU (the chain DP's plain version).
"""

from . import errors
from .estimate import (
    Estimate,
    EstimateResult,
    LOWER_QUANTILE,
    UPPER_QUANTILE,
    per_read_estimate,
)
from .platform import AVA_ONT, AVA_PB, OverlapParams, Platform
from .strategy import (
    AvaBuilder,
    AvaStrategy,
    DEFAULT_AVA_NUM_READS,
    DEFAULT_QUERY_NUM_READS,
    DEFAULT_TARGET_NUM_READS,
    TwoSetBuilder,
    TwoSetStrategy,
)

__version__ = "0.5.0"

# namespace mirrors of liblrge::twoset / liblrge::ava
from . import ava, twoset  # noqa: E402

__all__ = [
    "errors",
    "Estimate",
    "EstimateResult",
    "LOWER_QUANTILE",
    "UPPER_QUANTILE",
    "per_read_estimate",
    "Platform",
    "OverlapParams",
    "AVA_ONT",
    "AVA_PB",
    "TwoSetStrategy",
    "TwoSetBuilder",
    "AvaStrategy",
    "AvaBuilder",
    "twoset",
    "ava",
    "DEFAULT_TARGET_NUM_READS",
    "DEFAULT_QUERY_NUM_READS",
    "DEFAULT_AVA_NUM_READS",
]
