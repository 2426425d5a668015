"""lrge_tpu_torch — the PyTorch/CUDA port of lrge_tpu.

The same CLI and estimates as ``lrge_tpu``, with the device overlap
engine written in PyTorch and its chain DP as a hand-written CUDA
kernel for Hopper.  Host layers (I/O, subsampling, index build, the
exact host engine, the estimator) are imported from ``lrge_tpu``.
This package never imports JAX.

    python -m lrge_tpu_torch reads.fq
"""
