"""lrge_tpu_torch — the PyTorch/CUDA port of lrge_tpu.

The same CLI and estimates as ``lrge_tpu``, with the device overlap
engine written in PyTorch and its chain DP as a hand-written CUDA
kernel for Hopper.  The host layers (I/O, subsampling, index build,
the exact host engine and its native C++ extension, the estimator) are
this package's own copies of ``lrge_tpu``'s, at the same relative paths.
This package imports neither JAX nor ``lrge_tpu``.

    python -m lrge_tpu_torch reads.fq
"""

__version__ = "0.5.0"
