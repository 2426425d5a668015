"""The benchmark's plain reference: the overlap counts and the estimate
worked out again from the reads, in NumPy.

A frozen copy of the port's plain host path (``ops/encode.py``,
``ops/sketch.py``, ``ops/index.py``, ``ops/chain.py`` and the loop of
``engine.py``, without the native extension) and of its estimator
(``estimate.py``), which reproduce minimap2's sketch, occurrence cut,
chaining DP and backtrack and lrge's float32 estimate.  The chaining DP
runs in lockstep over anchor groups (``chain.chain_dp_many``), held bit
for bit to the per-anchor scan it was copied as (``chain.chain_dp_scan``).  It imports
nothing of the program and takes nothing the program made: the index,
the anchors and the counts are worked out here from the same reads and
the configuration file's parameters.
"""
