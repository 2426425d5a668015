"""Chain DP with minimap2's ``max_chain_skip`` break: CUDA kernel and plain version.

Replaces the Pallas TPU kernel ``lrge_tpu/ops/chain_pallas.py::chain_dp_skip``
(body ``_chain_kernel``), which computes the same recurrence as the XLA
scan of ``lrge_tpu/ops/overlap_jax.py::_expand_sort_chain`` for constant
spans:

    f[i] = max(span, max_j f[j] + sc(i, j))

over the ``W`` newest predecessors ``j`` with the same ``key2``
(rid*2+strand), ``0 < dq, dr <= max_gap`` and ``|dr - dq| <= bw``;
``sc = min(dq, dr, span) - int(pen_gap*dd + 0.5*mg_log2(dd+1))``.  The
skip break is a Lindley counter over the "marked" predecessors (those
that are the stored predecessor of an examined anchor); ties go to the
nearest predecessor.  Outputs are ``f`` (NEG where invalid) and
``broke`` (the break fired inside the window).

With ``extents=True`` (the ``-F`` path) the DP also carries the chain
state that the XLA scan keeps for its extent reduce
(``overlap_jax.py:661-788``), taken from each anchor's chosen
predecessor: ``cnt`` (chain anchor count), ``start`` (``rpos << 16 |
qpos`` of the chain's first anchor, int32) and ``rmf`` (running max of
``f`` shifted left one, with a valley bit set once ``f`` fell more than
``bw`` below it).  The card runs a second compiled variant of the
kernel for it (``EXT`` in ``csrc/chain_dp.cu``) with its own launch
counter, ``LAUNCHES.ext_launches`` (``ops/cuda_lib.py``).

With ``spans=True`` (the PacBio/HPC preset) each anchor carries its own
span, packed into ``qpos`` as ``qpos << 8 | span``, and the DP is the
XLA scan's ``with_spans`` step (``overlap_jax.py:624-744``), which the
reference never ran in Pallas: the score takes the predecessor's span,
``min(dg, psp)``, with the ``(dd != 0) | (dg > psp)`` test, while the
running max's seed, the floor of ``f`` and ``has_pred`` take the
current anchor's span.  Outputs are ``f``, ``broke`` and ``cnt`` (the
chain's anchor count, for the ``min_cnt`` gate).  The card runs a
third variant (``SPAN``) with the counter ``LAUNCHES.span_launches``;
it unpacks each predecessor's span from its ring ``qpos`` and keeps the
``cnt`` ring that ``EXT`` keeps.

How the card walks it (``csrc/chain_dp.cu``, whose header note says
more): an anchor's outputs depend only on the earlier anchors of its
own (rid, strand) run, because a predecessor with another ``key2`` is
never ``ok`` (``chain_pallas.py:149``) and both the marked set
(:164) and ``improving`` need ``ok``.  Rows are sorted by (key2, rpos),
so each run is a contiguous slice and an independent DP.  Each call
launches two kernels: one warp per 32-slot chunk of a row finds the
chunk's run starts with one ballot over ``key2``, writes the padding
and lists the chunk as holding a long run (one that reaches the
chunk's end) and/or short runs; then a persistent grid of warps walks
every long run, then every short-run chunk, each run from an empty ring
in registers with absolute slot indices.  The lists stay on the card:
no host sync and no sort.

What bounds it on an H100: the bytes are tiny (four int32 inputs and
two outputs per anchor, five with ``extents``, three with ``spans``) and the roofline bound
is a few hundredths of a millisecond at the main shapes, but each
anchor is a chain of ~25 dependent warp-shuffle rounds (three prefix
scans, three reductions, the marked-set OR, the ring push).  A launch
therefore lasts about the longer of the longest run's walk and all
anchors' steps spread over the card's resident warps.  The row-per-warp
kernel this replaces lasted as long as its longest row with 512-1,024
warps in flight; splitting rows at runs shortens the critical path to
the longest run and fills the card.

On a CPU tensor the wrapper runs :func:`chain_dp_skip_plain`; on a CUDA
tensor it launches the kernel or raises.  The kernel is built into the
port's one CUDA library (``ops/cuda_lib.py``), which also keeps the
launch counters right under CUDA graphs' replays.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .cuda_lib import LAUNCHES, check_int32, load

NEG = int(np.iinfo(np.int32).min // 2)
IMAX = int(np.iinfo(np.int32).max)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load()
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # key2, rpos, qpos, valid, nvalid, work, B, A, pen_gap, span,
    # max_gap, bw, max_skip, window, outputs..., stream
    head = [P, P, P, P, P, P, I, I, F, I, I, I, I, I]
    lib.chain_dp_skip_launch.argtypes = head + [P, P, P]
    lib.chain_dp_skip_ext_launch.argtypes = head + [P, P, P, P, P, P]
    lib.chain_dp_skip_span_launch.argtypes = head + [P, P, P, P]
    for fn in (lib.chain_dp_skip_launch, lib.chain_dp_skip_ext_launch, lib.chain_dp_skip_span_launch):
        fn.restype = I
    return lib


def chain_dp_skip(
    key2: torch.Tensor,  # [B, A] int32, sorted by (key2, rpos); IMAX invalid
    rpos: torch.Tensor,  # [B, A] int32
    qpos: torch.Tensor,  # [B, A] int32
    valid: torch.Tensor,  # [B, A] int32 (0/1)
    nvalid: torch.Tensor,  # [B] int32: rows stop here
    pen_gap: float,
    *,
    span: int,
    max_gap: int,
    bw: int,
    max_skip: int = 25,
    window: int = 32,
    extents: bool = False,
    spans: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Chain scores ``f`` and ``broke`` flags, both ``[B, A]`` int32;
    with ``extents``, also ``cnt``, ``start`` and ``rmf``; with ``spans``
    (``qpos`` packed as ``qpos << 8 | span``; ``span`` unused), also
    ``cnt`` (``[B, A]`` int32 each)."""
    B, A = key2.shape
    dev = key2.device
    check_int32("key2", key2, (B, A), dev)
    for name, x in (("rpos", rpos), ("qpos", qpos), ("valid", valid)):
        check_int32(name, x, (B, A), dev)
    check_int32("nvalid", nvalid, (B,), dev)
    if window not in (16, 32, 64, 128):
        raise ValueError(f"window must be 16, 32, 64 or 128, got {window}")
    if extents and spans:
        raise ValueError("the -F extent carries are constant-span only")
    kw = dict(span=span, max_gap=max_gap, bw=bw, max_skip=max_skip, window=window)
    if dev.type == "cpu":
        return chain_dp_skip_plain(key2, rpos, qpos, valid, nvalid, pen_gap, extents=extents, spans=spans, **kw)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n_out = 5 if extents else 3 if spans else 2
    if B == 0 or A == 0:
        return tuple(torch.empty((B, A), dtype=torch.int32, device=dev) for _ in range(n_out))
    chunks = B * -(-A // 32)
    if 32 * chunks >= 2**31:
        raise ValueError(f"[{B}, {A}] rows exceed the kernel's int32 chunk lists")
    outs = [torch.empty((B, A), dtype=torch.int32, device=dev) for _ in range(n_out)]
    with torch.cuda.device(dev):
        # the chunk lists and their counters (the launch zeroes these)
        work = torch.empty(4 + 2 * chunks, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib = _lib()
        launch = (
            lib.chain_dp_skip_ext_launch if extents
            else lib.chain_dp_skip_span_launch if spans
            else lib.chain_dp_skip_launch
        )
        err = launch(
            key2.data_ptr(), rpos.data_ptr(), qpos.data_ptr(), valid.data_ptr(), nvalid.data_ptr(),
            work.data_ptr(), B, A, float(np.float32(pen_gap)), span, max_gap, bw, max_skip, window,
            *(o.data_ptr() for o in outs), stream,
        )
    if err != 0:
        raise RuntimeError(f"chain_dp_skip launch failed: CUDA error {err}")
    if extents:
        LAUNCHES.ext_launches += 1
    elif spans:
        LAUNCHES.span_launches += 1
    else:
        LAUNCHES.launches += 1
    return tuple(outs)


def _mg_log2(x: torch.Tensor) -> torch.Tensor:
    """minimap2's fast f32 log2 (bit trick), op for op as the reference."""
    bits = x.to(torch.float32).view(torch.int32)
    log2 = ((bits >> 23) & 255).to(torch.float32) - 128.0
    bits = (bits & ~(255 << 23)) + (127 << 23)
    zf = bits.view(torch.float32)
    return log2 + (-0.34484843 * zf + 2.02466578) * zf - 0.67487759


def chain_dp_skip_plain(
    key2, rpos, qpos, valid, nvalid, pen_gap, *, span, max_gap, bw, max_skip=25, window=32,
    extents=False, spans=False,
):
    """Plain PyTorch version: one step per anchor slot over ``[B, W]``
    predecessor rings (newest first), mirroring the scan step of
    ``_expand_sort_chain`` (overlap_jax.py:663-788), its extent carries
    included when ``extents`` is set and its ``with_spans`` form (packed
    ``qpos << 8 | span``, the ``cnt`` carry) when ``spans`` is set."""
    if extents and spans:
        raise ValueError("the -F extent carries are constant-span only")
    B, A = key2.shape
    live = nvalid > 0
    if B and not bool(live.all()):
        # a row without anchors keeps the initial outputs (f NEG, the rest
        # 0): step the other rows alone
        rows = live.nonzero()[:, 0]
        sub = chain_dp_skip_plain(
            key2[rows], rpos[rows], qpos[rows], valid[rows], nvalid[rows], pen_gap, span=span,
            max_gap=max_gap, bw=bw, max_skip=max_skip, window=window, extents=extents, spans=spans,
        )
        outs = []
        for j, x in enumerate(sub):
            full = torch.full((B, A), NEG if j == 0 else 0, dtype=torch.int32, device=key2.device)
            full[rows] = x
            outs.append(full)
        return tuple(outs)
    W = window
    dev = key2.device
    i64 = dict(dtype=torch.int64, device=dev)
    key2, rpos, qpos = key2.long(), rpos.long(), qpos.long()
    valid = valid != 0
    nvalid = nvalid.long()
    pen = torch.tensor(np.float32(pen_gap), dtype=torch.float32, device=dev)
    f = torch.full((B, A), NEG, **i64)
    broke = torch.zeros((B, A), **i64)
    ring_key = torch.full((B, W), IMAX, **i64)
    ring_rpos = torch.zeros((B, W), **i64)
    ring_qpos = torch.zeros((B, W), **i64)
    ring_f = torch.full((B, W), NEG, **i64)
    ring_ok = torch.zeros((B, W), dtype=torch.bool, device=dev)
    ring_p = torch.full((B, W), -1, **i64)
    track_cnt = extents or spans
    if track_cnt:
        cnt = torch.zeros((B, A), **i64)
        ring_cnt = torch.zeros((B, W), **i64)
    if extents:
        start, rmf = (torch.zeros((B, A), **i64) for _ in range(2))
        ring_sq, ring_rmf = (torch.zeros((B, W), **i64) for _ in range(2))
    dpos = torch.arange(W, **i64)[None, :]
    neg_col = torch.full((B, 1), NEG, **i64)
    span_col = torch.full((B, 1), span, **i64)
    false_col = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    n = min(int(nvalid.max()) if B else 0, A)
    for i in range(n):
        ck, cr, cq = key2[:, i : i + 1], rpos[:, i : i + 1], qpos[:, i : i + 1]
        cv = valid[:, i] & (i < nvalid)
        if spans:
            # the score takes the PREDECESSOR's span; the seed, the floor
            # of f and has_pred take the current anchor's (cspan)
            dq = (cq >> 8) - (ring_qpos >> 8)
            psp, cspan = ring_qpos & 255, cq & 255
        else:
            dq = cq - ring_qpos
            psp = cspan = span_col
        dr = cr - ring_rpos
        dd = (dr - dq).abs()
        dg = torch.minimum(dq, dr)
        sc = torch.minimum(dg, psp)
        lin = pen * dd.to(torch.float32)
        logp = torch.where(dd >= 1, _mg_log2((dd + 1).to(torch.float32)), 0.0)
        pen_i = (lin + 0.5 * logp).to(torch.int64)
        sc = torch.where((dd != 0) | (dg > psp), sc - pen_i, sc)
        ok = (
            ring_ok & (ring_key == ck) & (dq > 0) & (dq <= max_gap)
            & (dr > 0) & (dr <= max_gap) & (dd <= bw)
        )
        cand = torch.where(ok, sc + ring_f, NEG)
        # marked[d]: some ok position d' stores the slot at position d as
        # its predecessor (p_rel[d'] == d).  The reference OR-reduces
        # bit-packed one-hot votes; a scatter of True into column p_rel
        # (out-of-window links into a spill column) sets the same bits.
        p_rel = (i - 1) - ring_p
        tgt = torch.where(ok & (p_rel >= 0) & (p_rel < W), p_rel, W)
        marked = torch.zeros((B, W + 1), dtype=torch.bool, device=dev)
        marked.scatter_(1, tgt, True)
        marked = marked[:, :W]
        cmax = torch.cummax(cand, dim=1).values
        runmax_excl = torch.maximum(torch.cat([neg_col, cmax[:, :-1]], dim=1), cspan)
        improving = ok & (cand > runmax_excl)
        a_step = (ok & marked & ~improving).long() - improving.long()
        s_cum = torch.cumsum(a_step, dim=1)
        runmin = torch.cummin(s_cum, dim=1).values.clamp(max=0)
        over = (s_cum - runmin) > max_skip
        overed = torch.cummax(over.long(), dim=1).values != 0
        broken_before = torch.cat([false_col, overed[:, :-1]], dim=1)
        cand = torch.where(broken_before, NEG, cand)
        best = cand.max(dim=1).values
        bestd = torch.where(cand == best[:, None], dpos, W).min(dim=1).values
        has_pred = best > cspan[:, 0]
        p_t = torch.where(cv & has_pred, i - 1 - bestd, -1)
        f_t = torch.where(cv, torch.maximum(best, cspan[:, 0]), NEG)
        f[:, i] = f_t
        broke[:, i] = (overed[:, -1] & cv).long()
        push = lambda new, ring: torch.cat([new[:, None], ring[:, : W - 1]], dim=1)
        # the chosen predecessor's carries (bestd < W always)
        at_best = lambda ring: ring.gather(1, bestd[:, None])[:, 0]
        if track_cnt:
            c_t = torch.where(cv, torch.where(has_pred, at_best(ring_cnt) + 1, 1), 0)
            cnt[:, i] = c_t
            ring_cnt = push(c_t, ring_cnt)
        if extents:
            sq_prev, rmf_prev = at_best(ring_sq), at_best(ring_rmf)
            prevmax = rmf_prev >> 1
            vflag = (rmf_prev & 1) | ((prevmax - f_t) > bw).long()
            s_t = torch.where(cv, torch.where(has_pred, sq_prev, (cr[:, 0] << 16) | cq[:, 0]), 0)
            r_t = torch.where(
                cv, torch.where(has_pred, (torch.maximum(prevmax, f_t) << 1) | vflag, f_t << 1), 0
            )
            start[:, i], rmf[:, i] = s_t, r_t
            ring_sq, ring_rmf = push(s_t, ring_sq), push(r_t, ring_rmf)
        ring_key = push(ck[:, 0], ring_key)
        ring_rpos = push(cr[:, 0], ring_rpos)
        ring_qpos = push(cq[:, 0], ring_qpos)
        ring_f = push(f_t, ring_f)
        ring_ok = push(cv, ring_ok)
        ring_p = push(p_t, ring_p)
    outs = (f, broke, cnt, start, rmf) if extents else (f, broke, cnt) if spans else (f, broke)
    return tuple(x.to(torch.int32) for x in outs)
