"""The traced window: ``torch.profiler`` over the first passes of the
window, reduced to device busy time, time by kernel and idle time by
what the host was doing."""

from __future__ import annotations

from collections import defaultdict

import numpy as np

# the traced part of the window: passes until this many seconds have
# gone by (at least one pass), so that the trace stays small enough to
# read within the run's time
TRACE_SECONDS = 2.0
SPAN_PREFIX = "bench."
WINDOW_SPAN = SPAN_PREFIX + "traced_window"
CHAIN_KERNELS = ("chain_dp_kernel", "find_runs_kernel")
LABELLED = 5000


def start():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    span = record_function(WINDOW_SPAN)
    span.__enter__()
    return prof, span, torch


def stop(handle) -> object:
    prof, span, torch = handle
    torch.cuda.synchronize()
    span.__exit__(None, None, None)
    prof.__exit__(None, None, None)
    return prof


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof) -> dict:
    """``busy_s`` (the union of device operations' intervals in the
    window), ``window_s``, device seconds by kernel name and idle seconds
    by the innermost host span or op under each idle gap (``"host"``
    where the harness's window span alone covers it)."""
    from torch.autograd import DeviceType

    events = prof.events()
    win = [e for e in events if e.name == WINDOW_SPAN and e.device_type != DeviceType.CUDA]
    if not win:
        raise RuntimeError("the profiler recorded no window span")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev, host = [], []
    by_kernel = defaultdict(float)
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN_PREFIX):
                continue  # a host span's shadow on the device timeline, not an operation
            s, t = max(s, w0), min(t, w1)
            if t > s:
                dev.append((s, t))
                by_kernel[e.name] += (t - s) / 1e6
        elif e.name != WINDOW_SPAN and t > w0 and s < w1:
            host.append((s, t, e.name))
    busy = _union(dev)
    busy_us = sum(t - s for s, t in busy)
    # idle gaps, named by the shortest host event covering the gap's
    # middle: the ``LABELLED`` longest gaps one by one, the rest together
    gaps, prev = [], w0
    for s, t in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    gaps.sort(key=lambda g: g[0] - g[1])
    h0 = np.array([h[0] for h in host], dtype=np.float64)
    h1 = np.array([h[1] for h in host], dtype=np.float64)
    names = [h[2] for h in host]
    idle = defaultdict(float)
    for g0, g1 in gaps[:LABELLED]:
        mid = (g0 + g1) / 2
        cover = np.flatnonzero((h0 <= mid) & (h1 >= mid))
        name = names[cover[np.argmin(h1[cover] - h0[cover])]] if len(cover) else "host"
        idle[name] += (g1 - g0) / 1e6
    rest = gaps[LABELLED:]
    if rest:
        idle[f"gaps under {rest[0][1] - rest[0][0]:.0f} us"] += sum(g1 - g0 for g0, g1 in rest) / 1e6
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "kernels": dict(by_kernel),
        "idle": dict(idle),
    }


def chain_seconds(reduced: dict) -> float:
    return sum(v for k, v in reduced["kernels"].items() if any(c in k for c in CHAIN_KERNELS))


def breakdown(reduced: dict) -> dict:
    top = lambda d: [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(reduced["kernels"]), "idle_gaps": top(reduced["idle"])}
