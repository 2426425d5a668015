"""One program per super-batch: the port's counterpart of the reference's ``jax.jit``.

The reference compiles each super-batch pipeline once per bucket shape
and mode (``jax.jit`` around ``sketch_map_many_core`` with static
argnames, ``lrge_tpu/ops/overlap_jax.py:2001``), compiles the programs
of a pass ahead of it (``warmup``, ``lrge_tpu/device_engine.py:709``)
and dispatches each super-batch as one asynchronous call (:900-901).
Here a :class:`SuperBatchProgram` is one such pipeline, a function of
static device input buffers over the engine's index planes and
parameters, captured once as a CUDA graph: every super-batch is then
one replay, fed by asynchronous copies from pinned host memory, with
the hand-written chain DP (``chain_kernel.py``) inside the graph.
Nothing in a run waits for the card.

The pipelines are the three single-device branches of the engine's
dispatch (:func:`program_function`, keyed by :class:`ProgramKey`):

* ``"ont"``, one sub-index: ``sketch_map_many`` over 2-bit packed
  codes, in every mode the engine passes (plain, pairs, ``-F`` in
  either filter mode);
* ``"ont_multi"``, several sub-indexes: ``sketch_lookup_many`` over
  the unpacked codes, then ``map_subs``;
* ``"pacbio"``: ``pb_map_many`` over the host-sketched planes.

A capture first runs the function once eagerly on a side stream (the
chain DP's library is built and loaded, the allocator primed), then
records it with ``capture_error_mode="thread_local"``, because the
engine's host thread may be running native code meanwhile.  A failed
capture raises, naming the key; there is no eager fallback on the card.
On a CPU device (the tests) the program keeps the same discipline of
static inputs and outputs, with an eager call in place of the replay.

Every run returns clones of the static outputs: the engine keeps each
super-batch's outputs until it collects them, and the next run
overwrites the static ones.  The programs of one engine may share one
graph memory pool, because their replays run one at a time on one
stream, their static inputs lie outside the pool and every output is
cloned right after its replay.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import numpy as np
import torch

from .chain_kernel import COUNTERS, add_launches, launch_counts, recorded_launches
from .overlap import map_subs, minimizer_cap, pb_map_many, sketch_lookup_many, sketch_map_many

BRANCHES = ("ont", "ont_multi", "pacbio")


class ProgramKey(NamedTuple):
    """What one program is compiled for: the branch, the bucket's padded
    length ``L``, anchor capacity ``A``, batches ``SUP`` and rows ``B`` a
    batch, and the mode.  ``overhang_ratio`` and ``filter_mode`` are None
    unless ``want_extents`` (``-F``) is set."""

    branch: str
    L: int
    A: int
    SUP: int
    B: int
    want_pairs: bool = False
    want_extents: bool = False
    overhang_ratio: float | None = None
    filter_mode: str | None = None


def program_function(key: ProgramKey, gi, params, *, window: int):
    """``(fn, inputs)``: the super-batch function of ``key`` over the index
    planes ``gi``, which returns the ``[SUP, B, 4]`` int32 plane and the
    pair plane (or None), and its static inputs as ``(shape, dtype, fill)``
    in argument order.  The fills are the padding of an empty row."""
    if key.branch not in BRANCHES:
        raise ValueError(f"unknown branch {key.branch!r}: expected one of {BRANCHES}")
    if key.want_extents and key.branch != "ont":
        raise ValueError("the -F extent filter runs in the single-sub ONT program only")
    A, W, pairs = key.A, window, key.want_pairs
    rows = (key.SUP, key.B)
    # lengths, dual ranks, self ranks
    row_inputs = [(rows, torch.int32, 0), (rows, torch.int32, 0), (rows, torch.int32, -1)]
    if key.branch == "ont":
        filt = dict(overhang_ratio=key.overhang_ratio, filter_mode=key.filter_mode) if key.want_extents else {}

        def fn(codes_p, lengths, dual, selfr):
            return sketch_map_many(
                codes_p, lengths, dual, selfr, gi, params, num_anchors=A, window=W, want_pairs=pairs,
                want_extents=key.want_extents, **filt,
            )

        return fn, [((*rows, key.L // 4), torch.uint8, 0), *row_inputs]
    if key.branch == "ont_multi":

        def fn(codes, lengths, dual, selfr):
            found, mps, mcount = sketch_lookup_many(codes, lengths, gi, params)
            return map_subs(
                found, mps, mcount, lengths, dual, selfr, gi, params, num_anchors=A, window=W, want_pairs=pairs,
            )

        return fn, [((*rows, key.L), torch.uint8, 4), *row_inputs]

    def fn(qhi, qlo, mps, mcount, lengths, dual, selfr):
        return pb_map_many(
            qhi, qlo, mps, mcount, lengths, dual, selfr, gi, params, num_anchors=A, window=W, want_pairs=pairs,
        )

    planes = (*rows, minimizer_cap(key.L))
    return fn, [(planes, torch.int32, -1), (planes, torch.int32, 0), (planes, torch.int32, 0),
                (rows, torch.int32, 0), *row_inputs]


class SuperBatchProgram:
    """One super-batch pipeline (:func:`program_function`) with static
    inputs on ``device``: a CUDA graph there, captured at construction
    into ``pool`` (None: a pool of its own), or an eager call on a CPU
    device.  :meth:`run` feeds it one super-batch."""

    # chain DP launches of the eager runs before each capture, by counter:
    # real launches, already in the wrapper's counters; with ``captures``
    # they tell those runs from replays in a pass's count
    captures = 0
    warmup_launches = dict.fromkeys(COUNTERS, 0)

    def __init__(self, key: ProgramKey, fn, inputs, device: torch.device, pool=None):
        self.key = key
        self.fn = fn
        self.device = device
        self.inputs = tuple(torch.full(shape, fill, dtype=dtype, device=device) for shape, dtype, fill in inputs)
        self.graph = None
        self.outputs = None  # the static outputs, a tuple (None where fn has no such output)
        self.launches = dict.fromkeys(COUNTERS, 0)  # the chain DP launches a replay makes
        self.capture_s = 0.0
        if device.type == "cuda":
            t0 = time.perf_counter()
            self._capture(pool)
            self.capture_s = time.perf_counter() - t0
        elif device.type != "cpu":
            raise ValueError(f"unsupported device {device}")

    def _capture(self, pool) -> None:
        cls = type(self)
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            before = launch_counts()
            with torch.cuda.stream(side):
                self.fn(*self.inputs)
            torch.cuda.current_stream().wait_stream(side)
            for c, n in launch_counts().items():
                cls.warmup_launches[c] += n - before[c]
            graph = torch.cuda.CUDAGraph()

            def capture():
                with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                    return self.fn(*self.inputs)

            try:
                self.outputs, self.launches = recorded_launches(capture)
            except RuntimeError as err:
                raise RuntimeError(f"CUDA graph capture of the super-batch program {self.key} failed") from err
        self.graph = graph
        cls.captures += 1

    def run(self, *arrays: np.ndarray) -> tuple:
        """Copy one super-batch's host arrays (the inputs' shapes and
        dtypes, in order) into the static inputs, run the program, and
        return clones of its outputs.  On the card the copies go through
        pinned memory without blocking and the replay is enqueued: no call
        here waits for the card."""
        if len(arrays) != len(self.inputs):
            raise ValueError(f"program {self.key} takes {len(self.inputs)} arrays, got {len(arrays)}")
        on_card = self.graph is not None
        with torch.cuda.device(self.device) if on_card else contextlib.nullcontext():
            for dst, a in zip(self.inputs, arrays):
                src = torch.from_numpy(np.ascontiguousarray(a))
                if src.shape != dst.shape or src.dtype != dst.dtype:
                    raise ValueError(
                        f"program {self.key}: got {src.dtype} {tuple(src.shape)}, "
                        f"expected {dst.dtype} {tuple(dst.shape)}"
                    )
                if on_card:
                    # the pinned block is not reused before this copy has run
                    dst.copy_(src.pin_memory(), non_blocking=True)
                else:
                    dst.copy_(src)
            if on_card:
                self.graph.replay()
                add_launches(self.launches)
            else:
                outs = self.fn(*self.inputs)
                if self.outputs is None:
                    self.outputs = outs
                else:
                    for dst, o in zip(self.outputs, outs):
                        if dst is not None:
                            dst.copy_(o)
            return tuple(None if o is None else o.clone() for o in self.outputs)
