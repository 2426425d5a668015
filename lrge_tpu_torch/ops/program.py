"""One program per super-batch: the port's counterpart of the reference's ``jax.jit``.

The reference compiles each super-batch pipeline once per bucket shape
and mode (``jax.jit`` around ``sketch_map_many_core`` with static
argnames, ``lrge_tpu/ops/overlap_jax.py:2001``; on a sharded index one
``shard_map`` program a capacity, ``sharded_count_fn``,
``lrge_tpu/parallel/sharded.py:237-455``), compiles the programs of a
pass ahead of it (``warmup``, ``lrge_tpu/device_engine.py:709``) and
dispatches each super-batch as one asynchronous call (:900-901, :961).
Here a :class:`SuperBatchProgram` is one such pipeline, a function of
static device input buffers over the engine's index planes and
parameters, captured once as a CUDA graph: every super-batch is then
one replay, fed by asynchronous copies, with the hand-written chain DP
(``chain_kernel.py``) inside the graph.  Nothing in a run waits for the
card.

The pipelines are the branches of the engine's dispatch
(:func:`program_function`, keyed by :class:`ProgramKey`).  On one
device:

* ``"ont"``, one sub-index: ``sketch_map_many`` over 2-bit packed
  codes, in every mode the engine passes (plain, pairs, ``-F`` in
  either filter mode);
* ``"ont_multi"``, several sub-indexes: ``sketch_lookup_many`` over
  the unpacked codes, then ``map_subs``;
* ``"pacbio"``: ``pb_map_many`` over the host-sketched planes.

On a sharded index (``parallel/sharded.py``) a super-batch is one
``"query"`` program on the home device and one ``"shard"`` program a
shard, each on its shard's device (the key carries the shard's number,
so two shards on one card get two programs):

* ``"query"``: the query side, once a super-batch: under ONT the
  sketch of the unpacked codes (the reference's ``sketch_many`` ahead
  of ``_sharded_group``, ``lrge_tpu/device_engine.py:954-956``), then
  ``query_keep``; under PacBio ``query_keep`` over the host planes.  It
  returns the shard programs' int32 inputs over the flattened rows and
  the minimizer counts;
* ``"shard"``: one shard's work, ``shard_count`` (probe, ranges, the
  ``occ <= mid_occ`` gate, ``map_found_core``), narrow or wide by the
  shard's planes; its inputs are filled from the query program's
  outputs (or a ring hop's plane) by copies outside the graph, since a
  graph holds no copy between devices, and the merge of the shards'
  results runs outside the graphs too (``sharded_count_programs``).

A capture first runs the function once eagerly on a side stream (the
chain DP's library is built and loaded, the allocator primed), then
records it with ``capture_error_mode="thread_local"``, because the
engine's host thread may be running native code meanwhile.  A failed
capture raises, naming the key; there is no eager fallback on the card.
On a CPU device (the tests), and on the card when built with
``graph=False`` (the benchmark's eager side of its A/B, the counterpart
of the reference's ``LRGE_NO_FUSED``), the program keeps the same
discipline of static inputs and outputs, with an eager call in place of
the replay; on the card that call still launches the CUDA chain DP.

Every run returns clones of the static outputs: the engine keeps each
super-batch's outputs until it collects them, and the next run
overwrites the static ones.  The programs of one engine on one device
may share one graph memory pool, because their replays run one at a
time on that device's stream, their static inputs lie outside the pool
and every output is cloned right after its replay; shards on different
cards cannot share one.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from ..parallel.sharded import query_keep, shard_count
from ..spans import span
from .chain_kernel import COUNTERS, add_launches, launch_counts, recorded_launches
from .overlap import map_subs, minimizer_cap, pb_map_many, sketch_lookup_many, sketch_map_many
from .sketch_torch import sketch_core

BRANCHES = ("ont", "ont_multi", "pacbio", "query", "shard")


class ProgramKey(NamedTuple):
    """What one program is compiled for: the branch, the bucket's padded
    length ``L``, anchor capacity ``A``, batches ``SUP`` and rows ``B`` a
    batch, and the mode.  ``overhang_ratio`` and ``filter_mode`` are None
    unless ``want_extents`` (``-F``) is set; ``shard`` is the shard's
    number on the ``"shard"`` branch, else None."""

    branch: str
    L: int
    A: int
    SUP: int
    B: int
    want_pairs: bool = False
    want_extents: bool = False
    overhang_ratio: float | None = None
    filter_mode: str | None = None
    shard: int | None = None


def program_function(key: ProgramKey, gi, params, *, window: int):
    """``(fn, inputs)``: the super-batch function of ``key`` over the index
    planes ``gi`` (on the sharded branches a placed shard), and its static
    inputs as ``(shape, dtype, fill)`` in argument order; the fills are
    the padding of an empty row.  A single-device function returns the
    ``[SUP, B, 4]`` int32 plane and the pair plane (or None); the
    ``"query"`` and ``"shard"`` functions are :func:`_query_function`'s
    and :func:`_shard_function`'s."""
    if key.branch not in BRANCHES:
        raise ValueError(f"unknown branch {key.branch!r}: expected one of {BRANCHES}")
    if key.want_extents and key.branch != "ont":
        raise ValueError("the -F extent filter runs in the single-sub ONT program only")
    if key.branch == "query":
        return _query_function(key, gi, params)
    if key.branch == "shard":
        return _shard_function(key, gi, params, window)
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


def _query_function(key: ProgramKey, gi, params):
    """The query side of a sharded super-batch over ``R = SUP * B`` rows,
    on the home device.  It takes what the single-device ``"ont_multi"``
    (unpacked codes) or ``"pacbio"`` (host planes) program takes and
    returns the shard programs' inputs, int32: ``(q0, q1, mps, keep, qlen,
    qdual, qself)`` (``q0`` the narrow hash, its ``0xFFFFFFFF`` padding
    wrapped to -1, and ``q1`` None; or the wide ``qhi``/``qlo``), then the
    ``[R]`` minimizer counts.  ``gi`` gives ``mid_occ`` and ``wide``."""
    p = params
    R, M = key.SUP * key.B, minimizer_cap(key.L)
    rows = (key.SUP, key.B)
    row_inputs = [(rows, torch.int32, 0), (rows, torch.int32, 0), (rows, torch.int32, -1)]

    def flat(*xs):
        return tuple(x.reshape(R) for x in xs)

    if not gi.wide:

        def fn(codes, lengths, dual, selfr):
            mhash, mpos, mstrand, mcount = sketch_core(
                codes.reshape(R, key.L), lengths.reshape(R), k=p.k, w=p.w, max_minimizers=M
            )
            keep = query_keep(mhash, None, gi.mid_occ, p.q_occ_frac, False)
            i32 = lambda x: x.to(torch.int32)
            return i32(mhash), None, i32(mpos * 2 + mstrand), i32(keep), *flat(lengths, dual, selfr), i32(mcount)

        return fn, [((*rows, key.L), torch.uint8, 4), *row_inputs]

    def fn(qhi, qlo, mps, mcount, lengths, dual, selfr):
        qhi, qlo, mps = (x.reshape(R, M) for x in (qhi, qlo, mps))
        keep = query_keep(qhi.long(), qlo.long(), gi.mid_occ, p.q_occ_frac, True)
        return qhi, qlo, mps, keep.to(torch.int32), *flat(lengths, dual, selfr, mcount)

    planes = (*rows, M)
    return fn, [(planes, torch.int32, -1), (planes, torch.int32, 0), (planes, torch.int32, 0),
                (rows, torch.int32, 0), *row_inputs]


def _shard_function(key: ProgramKey, gi, params, window: int):
    """One shard's work over ``R = SUP * B`` rows on its own device
    (``parallel/sharded.py::shard_count`` over the shard's planes ``gi``,
    narrow or wide as they are).  It takes the int32 inputs that the query
    program returns (``q1`` only under wide keys) and casts them here, in
    the graph; it returns ``(counts, n_anchors, max_run)`` ``[R]`` int64
    and the ``[R, min(A, PAIR_CAP)]`` int32 pair plane (or None)."""
    R, M = key.SUP * key.B, minimizer_cap(key.L)
    wide = gi.wide

    def fn(q0, *rest):
        q1, mps, keep, qlen, qdual, qself = rest if wide else (None, *rest)
        # the narrow hash rides as int32: undo the wrap of its padding
        q0 = q0.long() if wide else q0.long() & 0xFFFFFFFF
        counts, n_anchors, max_run, pairs = shard_count(
            gi, q0, None if q1 is None else q1.long(), mps.long(), qlen.long(), qdual.long(), qself.long(),
            keep != 0, params, num_anchors=key.A, window=window, want_pairs=key.want_pairs,
        )
        return counts, n_anchors, max_run, None if pairs is None else pairs.to(torch.int32)

    plane = lambda fill: ((R, M), torch.int32, fill)
    return fn, [plane(-1), *([plane(0)] if wide else []), plane(0), plane(0),
                ((R,), torch.int32, 0), ((R,), torch.int32, 0), ((R,), torch.int32, -1)]


class SuperBatchProgram:
    """One super-batch pipeline (:func:`program_function`) with static
    inputs on ``device``: on the card a CUDA graph, captured at
    construction into ``pool`` (None: a pool of its own), unless
    ``graph`` is False; else an eager call.  :meth:`run` feeds it one
    super-batch."""

    # chain DP launches of the eager runs before each capture, by counter:
    # real launches, already in the wrapper's counters; with ``captures``
    # they tell those runs from replays in a pass's count
    captures = 0
    warmup_launches = dict.fromkeys(COUNTERS, 0)

    def __init__(self, key: ProgramKey, fn, inputs, device: torch.device, pool=None, graph: bool = True):
        self.key = key
        self.fn = fn
        self.device = device
        self.inputs = tuple(torch.full(shape, fill, dtype=dtype, device=device) for shape, dtype, fill in inputs)
        self.graph = None
        self.outputs = None  # the static outputs, a tuple (None where fn has no such output)
        self.launches = dict.fromkeys(COUNTERS, 0)  # the chain DP launches a replay makes
        self._capture_span = None
        if device.type == "cuda" and graph:
            with span("capture", key=key) as self._capture_span:
                self._capture(pool)
        elif device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {device}")

    @property
    def capture_s(self) -> float:
        """Seconds of the capture (its ``capture`` span: the eager run and
        the recording); 0 without a graph."""
        return 0.0 if self._capture_span is None else self._capture_span.duration

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

    def run(self, *arrays) -> tuple:
        """Copy one super-batch's inputs (host arrays or tensors on any
        device, of the inputs' shapes and dtypes, in order) into the static
        inputs, run the program, and return clones of its outputs.  On the
        card host arrays go through pinned memory without blocking, tensors
        by device copies, and the replay (or the eager call) is enqueued:
        no call here waits for the card.  One ``enqueue.submit`` span."""
        if len(arrays) != len(self.inputs):
            raise ValueError(f"program {self.key} takes {len(self.inputs)} arrays, got {len(arrays)}")
        on_card = self.device.type == "cuda"
        with span("enqueue.submit"), torch.cuda.device(self.device) if on_card else contextlib.nullcontext():
            for dst, a in zip(self.inputs, arrays):
                src = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
                if src.shape != dst.shape or src.dtype != dst.dtype:
                    raise ValueError(
                        f"program {self.key}: got {src.dtype} {tuple(src.shape)}, "
                        f"expected {dst.dtype} {tuple(dst.shape)}"
                    )
                if on_card and src.device.type == "cpu":
                    # the pinned block is not reused before this copy has run
                    dst.copy_(src.pin_memory(), non_blocking=True)
                else:
                    dst.copy_(src, non_blocking=on_card)
            if self.graph is not None:
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
