"""Spans and counters of the port's stages, one record a pass.

``with span(name, **tags):`` times a stage with two ``time.perf_counter``
reads and, on exit, appends itself to the current record as ``(name,
start, end, parent, tags)``: ``parent`` is the enclosing span on the same
thread (or the one a :func:`carry` hands over), None at the top.  While a
``torch.profiler`` session records on this thread, the span also enters
``torch.profiler.record_function("lrge." + name)``, so that it lies on
the profiler's clock beside the device's kernels; otherwise it costs one
check of the profiler's flag and the two clock reads.  ``count(name, n)``
adds to the current record's counters.

A pass (:func:`pass_record`: one ``DeviceOverlapEngine.count_batch`` that
is not warming up) is one :class:`Record`, numbered from 1; the last
:data:`HISTORY` of them are kept in :data:`passes`.  Every span and
counter outside a pass (the native builds and loads, the index, the
planes, the warm-up calls and their graph captures) goes into the
process's one set-up record, :data:`setup`, numbered 0.  A record keeps
its newest :data:`MAX_SPANS` spans.  A span's self time is its duration
less its children's (:meth:`Record.self_time`).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque

import torch

PREFIX = "lrge."
# the passes a benchmark window reads (~340 in a 51 s ONT window), twice
# over; a span holds ~250 bytes, so a full history of 295-span passes
# holds ~71 MiB
HISTORY = 1024
MAX_SPANS = 1 << 16

_clock = time.perf_counter
_profiling = torch.autograd._profiler_enabled  # this thread's profiler flag


class Record:
    """The spans (in the order they ended) and counters of one pass, or
    of the set-up (``number`` 0)."""

    __slots__ = ("number", "spans", "counters")

    def __init__(self, number: int):
        self.number = number
        self.spans = deque(maxlen=MAX_SPANS)
        self.counters = {}

    @property
    def wall(self) -> float:
        """Seconds of the top-level spans: a pass's ``count_batch``."""
        return sum(s.end - s.start for s in self.spans if s.parent is None)

    def children(self, parent) -> list:
        return [s for s in self.spans if s.parent is parent]

    def self_time(self, s) -> float:
        return s.duration - sum(c.duration for c in self.children(s))


setup = Record(0)
passes: deque = deque(maxlen=HISTORY)
_numbers = itertools.count(1)


class _State(threading.local):
    record = setup  # where this thread's spans go
    top = None  # this thread's innermost open span


_state = _State()


class span:
    """One stage: a context manager that times its body and appends
    itself to the current record (module docstring)."""

    __slots__ = ("name", "start", "end", "parent", "tags", "_rf")

    def __init__(self, name: str, **tags):
        self.name = name
        self.tags = tags

    def __enter__(self):
        st = _state
        self.parent = st.top
        st.top = self
        if _profiling():
            self._rf = torch.profiler.record_function(PREFIX + self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        self.end = _clock()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        st = _state
        st.top = self.parent
        st.record.spans.append(self)
        return False

    @property
    def duration(self) -> float:
        return self.end - self.start

    def __repr__(self) -> str:
        return f"span({self.name!r}, {self.start!r}, {self.end!r}, {self.tags!r})"


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the current record's counter ``name``."""
    counters = _state.record.counters
    counters[name] = counters.get(name, 0) + n


def current() -> Record:
    """This thread's current record."""
    return _state.record


@contextlib.contextmanager
def pass_record(warming: bool = False):
    """Make this thread's spans and counters one new pass record, kept in
    :data:`passes` on exit; ``warming`` keeps them in the set-up record."""
    st = _state
    prev, rec = st.record, setup if warming else Record(next(_numbers))
    st.record = rec
    try:
        yield rec
    finally:
        st.record = prev
        if rec is not setup:
            passes.append(rec)


def carry(fn, parent=None):
    """``fn`` to run on another thread with its spans in this thread's
    current record, under ``parent`` (default: this thread's innermost
    open span)."""
    rec, top = _state.record, parent if parent is not None else _state.top

    def run(*args, **kw):
        st = _state
        saved = st.record, st.top
        st.record, st.top = rec, top
        try:
            return fn(*args, **kw)
        finally:
            st.record, st.top = saved

    return run
