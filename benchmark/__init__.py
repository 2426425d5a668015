"""The benchmark of ``lrge_tpu_torch`` on one NVIDIA H100: ``python3 -m
benchmark.run``.  It imports nothing of ``lrge_tpu``, of JAX or of the
repository's top-level ``bench.py``."""
