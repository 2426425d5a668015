"""Batched minimizer sketches (PyTorch): the ONT preset's and the PacBio/HPC preset's.

Port of ``lrge_tpu/ops/sketch_jax.py``: ``hash32`` (:31) and
``sketch_core`` (:44), the same window-min cover rule with the
first-window amendment and the final-window push, vectorised over a
padded ``[B, L]`` batch.  Hashes ride in int64 (masked to ``2k`` bits)
because PyTorch's uint32 lacks shifts, adds and comparisons on the CPU;
``0xFFFFFFFF`` stays the padding value.  ``sketch_core`` is exact for
reads without ambiguous bases; the engine sends the others to the host.

:func:`sketch_hpc` sketches the PacBio/HPC preset's queries (``hpc``
on, or ``2k > 32``) straight into the device lookup planes, exactly as
minimap2's ``mm_sketch`` loop does (the native ``sketch_one``) for every
input: homopolymer runs, ambiguous bases, spans of 256 and more and
symmetric k-mers included.  The reference sketches these queries on the
host (``lrge_tpu/device_engine.py:377-393``) and has no device
counterpart; on the card the sketch is the CUDA kernel
``csrc/sketch_hpc.cu``, on the CPU :func:`sketch_hpc_plain`.  Both
compute the loop's result from per-slot quantities instead of stepping
it:

* a *slot* is one step of the loop: a run of one base under HPC (its
  position the run's last base), every base without it, and every
  ambiguous base; a valid slot's k-mer is made of the last ``k`` valid
  slots' bases (ambiguous slots do not shift it, the start fills with
  0), its span is its end less the later of the end ``k`` valid slots
  back and the last ambiguous base;
* a symmetric k-mer's slot is skipped; the others and the ambiguous
  slots form the *window slots*; ``l`` at a window slot counts the
  non-symmetric valid slots since the last ambiguous one, and its key is
  ``hash << 8 | span`` when ``l >= k`` and the span is under 256, else
  the loop's invalid value;
* ``M[s]``, the loop's held minimum after window slot ``s``, is the
  newest slot of least key among ``s - w + 1 .. s``; slot ``t`` is
  emitted when a later slot ``s <= t + w`` displaces it
  (``key[s] <= key[t]`` at ``l >= w + k``) or evicts it (``s = t + w``,
  ``l >= w + k - 1``), when it ties the minimum that an eviction's
  rescan finds (``l >= w + k - 1``) or that a first full window holds
  (``l == w + k - 1``), and when it is the last minimum (the final
  push).  Emitted slots are in position order, one a position, as the
  loop's sorted, de-duplicated output is.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .cuda_lib import LAUNCHES, check_int32, load

INF = 0xFFFFFFFF
# wide (PacBio/HPC, 2k = 38-bit) hashes ride in two int32 planes: hi =
# hash >> PB_SPLIT, lo = hash & PB_LOMASK (overlap_jax.py:2229-2230)
PB_SPLIT = 19
PB_LOMASK = (1 << PB_SPLIT) - 1
# above every HPC sketch key (hash << 8 | span < 2^58 at k <= 25): the
# loop's invalid entry; a power of two, since F.pad's fill passes through
# a double
KEY_INF = 1 << 62
# the planes hold the hash's high part in int32: 2k - PB_SPLIT <= 31
MAX_K = 25


def hash32(key: torch.Tensor, mask: int) -> torch.Tensor:
    """minimap2 hash64 restricted to ``mask``, on int64: exact for any mask
    below 2^63 (shifts wrap modulo 2^64 and every right shift follows a
    mask), so the PacBio sketch's 38-bit keys take it too."""
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & mask  # * 265
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & mask  # * 21
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def _shift_right(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """``x[:, i - d]`` with ``fill`` for ``i < d`` (the reference's jnp.pad)."""
    if d == 0:
        return x
    d = min(d, x.shape[1])
    return F.pad(x[:, : x.shape[1] - d], (d, 0), value=fill)


def _shift_left(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """``x[:, i + d]`` with ``fill`` past the end."""
    if d == 0:
        return x
    d = min(d, x.shape[1])
    return F.pad(x[:, d:], (0, d), value=fill)


def _first_argmin(x: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum along dim 1 (jnp.argmin's tie rule)."""
    cols = torch.arange(x.shape[1], device=x.device)
    hit = x == x.min(dim=1, keepdim=True).values
    return torch.where(hit, cols, x.shape[1]).min(dim=1).values


def sketch_core(codes: torch.Tensor, lengths: torch.Tensor, *, k: int, w: int, max_minimizers: int):
    """Sketch a padded batch (``codes`` [B, L] uint8, 4 = ambiguous/padding).

    Returns ``(mhash [B,M] int64, mpos [B,M] int64, mstrand [B,M] int64,
    mcount [B] int64)`` with ``0xFFFFFFFF`` hash padding; ``mcount`` is
    the raw (uncapped) minimizer count.
    """
    if 2 * k > 32:
        raise ValueError("the 32-bit sketch needs 2k <= 32")
    B, L = codes.shape
    dev = codes.device
    mask = (1 << (2 * k)) - 1
    c = codes.long()
    ambig = c >= 4
    csafe = torch.where(ambig, 0, c)
    lengths = lengths.long()

    fwd = torch.zeros((B, L), dtype=torch.int64, device=dev)
    rev = torch.zeros((B, L), dtype=torch.int64, device=dev)
    for j in range(k):
        shifted = _shift_right(csafe, j, 0)
        fwd = fwd | (shifted << (2 * j))
        rev = rev | ((3 ^ shifted) << (2 * (k - 1 - j)))
    fwd = fwd & mask
    rev = rev & mask

    cols = torch.arange(L, device=dev)
    okc = torch.cumsum((~ambig).long(), dim=1)
    valid = (okc - _shift_right(okc, k, 0)) == k
    valid = valid & (cols >= k - 1) & (fwd != rev)
    valid = valid & (cols[None, :] < lengths[:, None])

    strand = (fwd >= rev).long()
    x = hash32(torch.minimum(fwd, rev), mask)
    xm = torch.where(valid, x, INF)

    wmin = xm
    for d in range(1, w):
        wmin = torch.minimum(wmin, _shift_right(xm, d, INF))
    vcum = torch.cumsum(valid.long(), dim=1)
    gated = ((vcum - _shift_right(vcum, w, 0)) == w) & (cols >= w + k - 2)

    sel = torch.zeros((B, L), dtype=torch.bool, device=dev)
    for d in range(w):
        g = _shift_left(gated, d, False)
        m = _shift_left(wmin, d, 0)
        sel = sel | (g & (m == xm) & valid)

    # first-window amendment: ties of the prefix minimum are pushed and
    # the held minimum drops when the window-closing k-mer ties it
    e0 = w + k - 2
    if L > e0 and w >= 2:
        prefix = xm[:, k - 1 : e0]  # [B, w-1]
        pmin = prefix.min(dim=1).values
        held_rel = (w - 2) - _first_argmin(prefix.flip(1))
        ok = (pmin != INF) & (lengths >= w + k - 1)
        win = xm[:, k - 1 : e0 + 1]  # [B, w]
        wcols = torch.arange(w, device=dev)
        add = (win == pmin[:, None]) & ok[:, None] & (wcols[None, :] != held_rel[:, None])
        sel[:, k - 1 : e0 + 1] |= add
        closing_tie = (xm[:, e0] == pmin) & ok
        held_mask = cols[None, :] == (k - 1 + held_rel)[:, None]
        sel = sel & ~(held_mask & closing_tie[:, None])

    # final-window push: latest minimum over positions [n-w, n-1]
    tail_idx = (lengths[:, None] - w + torch.arange(w, device=dev)[None, :]).clamp(min=0)
    tail_x = xm.gather(1, tail_idx)
    arg_rev = _first_argmin(tail_x.flip(1))
    tie_pos = tail_idx.gather(1, (w - 1 - arg_rev)[:, None])[:, 0]
    tie_val = xm.gather(1, tie_pos[:, None])[:, 0]
    sel = sel | ((cols[None, :] == tie_pos[:, None]) & (tie_val != INF)[:, None])

    # compact selected positions to the front; the keys are distinct, so
    # the stable sort is a permutation
    M = max_minimizers
    mcount = sel.sum(dim=1)
    ckey = torch.where(sel, cols, cols + L)
    ckey_s, order = torch.sort(ckey, dim=1, stable=True)
    xs = torch.where(sel, (x << 1) | strand, INF).gather(1, order)
    ckey_s = ckey_s[:, :M]
    keep = ckey_s < L
    mhash = torch.where(keep, xs[:, :M] >> 1, INF)
    mpos = torch.where(keep, ckey_s, 0)
    mstrand = torch.where(keep, xs[:, :M] & 1, 0)
    return mhash, mpos, mstrand, mcount


def _compact(flag: torch.Tensor, *values) -> tuple:
    """Each row's flagged entries of each ``(tensor, fill)`` in ``values``
    moved to the front in order, the rest ``fill``; then each entry's rank
    among the flagged (-1 where unflagged) and the flagged counts."""
    R, L = flag.shape
    rank = torch.cumsum(flag.long(), dim=1) - 1
    dest = torch.where(flag, rank, L)  # unflagged entries land in a spill column
    outs = []
    for v, fill in values:
        out = torch.full((R, L + 1), fill, dtype=torch.int64, device=flag.device)
        outs.append(out.scatter_(1, dest, v.expand(R, L))[:, :L])
    return outs, torch.where(flag, rank, -1), flag.sum(dim=1)


def sketch_hpc_plain(codes: torch.Tensor, lengths: torch.Tensor, *, k: int, w: int, hpc: bool,
                     max_minimizers: int):
    """Plain PyTorch version of :func:`sketch_hpc` (int64, vectorised over
    the rows; the module's note says how): the same planes, bit for bit."""
    R, L = codes.shape
    dev = codes.device
    i64 = dict(dtype=torch.int64, device=dev)
    c = codes.long()
    n = lengths.long()[:, None]
    col = torch.arange(L, **i64)[None, :]
    inrow = col < n
    amb = (c >= 4) & inrow
    end = inrow & (amb | (col + 1 >= n) | (_shift_left(c, 1, 4) != c)) if hpc else inrow
    vslot = end & ~amb
    # the valid slots, compacted: each one's base and end position
    (vcode, vend), vrank, _ = _compact(vslot, (c, 0), (col, 0))
    mask = (1 << (2 * k)) - 1
    kmer0 = torch.zeros((R, L), **i64)
    kmer1 = torch.zeros((R, L), **i64)
    for d in range(k):
        cd = _shift_right(vcode, d, 0)
        kmer0 |= cd << (2 * d)
        kmer1 |= torch.where(col >= d, 3 ^ cd, 0) << (2 * (k - 1 - d))
    lastamb = torch.cummax(torch.where(amb, col, -1), dim=1).values
    vspan = vend - torch.maximum(_shift_right(vend, k, -1), lastamb.gather(1, vend))
    # back to positions: each valid slot's values at its end
    at = lambda x: x.gather(1, vrank.clamp(min=0))
    nsv = vslot & (at(kmer0) != at(kmer1))
    nsum = torch.cumsum(nsv.long(), dim=1)
    l = nsum - torch.where(lastamb >= 0, nsum.gather(1, lastamb.clamp(min=0)), 0)
    span = at(vspan)
    canon = at(torch.minimum(kmer0, kmer1))
    key = torch.where(nsv & (l >= k) & (span < 256), (hash32(canon, mask) << 8) | span, KEY_INF)
    z = (at(kmer0) > at(kmer1)).long()
    # the window slots, compacted
    (wkey, wl, wpos, wz), _, nw = _compact(amb | nsv, (key, KEY_INF), (l, 0), (col, 0), (z, 0))
    s = col
    live = s < nw[:, None]
    held = s.expand(R, L)  # M[s]: the newest least key of s - w + 1 .. s
    hkey = wkey
    for d in range(1, w):
        kd = _shift_right(wkey, d, KEY_INF)
        newer = kd < hkey
        hkey = torch.where(newer, kd, hkey)
        held = torch.where(newer, s - d, held)
    prev = _shift_right(held, 1, -1)  # M[s - 1]
    pkey = _shift_right(hkey, 1, KEY_INF)
    real = live & (pkey != KEY_INF)
    displace = real & (wkey <= pkey) & (wl >= w + k)
    evict = live & (prev >= 0) & (prev == s - w) & (wkey > pkey) & (wl >= w + k - 1)
    evict_held = evict & real
    rescan = evict & (hkey != KEY_INF)
    first = real & (wl == w + k - 1)
    emit = torch.zeros((R, L), dtype=torch.bool, device=dev)
    for d in range(w + 1):
        sh = lambda x, fill: _shift_left(x, d, fill)
        if d >= 1:
            # the minimum held at t leaves at s = t + d: displaced or evicted
            emit |= (sh(prev, -1) == s) & sh(displace | evict_held, False)
        if 1 <= d < w:
            # the first full window's ties of the minimum it held
            emit |= sh(first, False) & (sh(pkey, KEY_INF) == wkey) & (sh(prev, -1) != s)
        if d < w:
            # the ties of the minimum an eviction's rescan finds
            emit |= sh(rescan, False) & (sh(hkey, KEY_INF) == wkey) & (sh(held, -1) != s)
    # the final push: the minimum held after the last window slot
    last = (nw - 1).clamp(min=0)[:, None]
    emit |= (s == held.gather(1, last)) & (hkey.gather(1, last) != KEY_INF)
    emit &= live
    (okey, opos, oz), _, mcount = _compact(emit, (wkey, KEY_INF), (wpos, 0), (wz, 0))
    M = max_minimizers
    okey, opos, oz = (F.pad(x[:, :M], (0, max(0, M - L))) for x in (okey, opos, oz))
    keep = torch.arange(M, **i64)[None, :] < mcount[:, None]
    h = okey >> 8
    qhi = torch.where(keep, h >> PB_SPLIT, -1)
    qlo = torch.where(keep, h & PB_LOMASK, 0)
    mps = torch.where(keep, (opos << 9) | ((okey & 255) << 1) | oz, 0)
    return tuple(x.to(torch.int32) for x in (qhi, qlo, mps, mcount))


@functools.cache
def _launch():
    """The kernel's entry point in the port's CUDA library (``ops/cuda_lib.py``)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = load().sketch_hpc_launch
    # codes, lengths, R, L, k, w, hpc, M, qhi, qlo, mps, mcount, stream
    fn.argtypes = [P, P, I, I, I, I, I, I, P, P, P, P, P]
    fn.restype = I
    return fn


def sketch_hpc(codes: torch.Tensor, lengths: torch.Tensor, *, k: int, w: int, hpc: bool, max_minimizers: int):
    """Sketch a padded batch of PacBio/HPC reads into the device lookup
    planes: ``codes`` ``[R, L]`` uint8 (4 = ambiguous or padding),
    ``lengths`` ``[R]`` int32.  Returns ``(qhi, qlo, mps, mcount)``,
    int32: the first ``max_minimizers`` minimizers by position, ``qhi``
    ``[R, M]`` the ``2k``-bit hash >> 19 (-1 on padding), ``qlo`` its low
    19 bits, ``mps`` = ``pos << 9 | span << 1 | strand``, and ``[R]`` the
    true (uncapped) counts.  On a CPU tensor :func:`sketch_hpc_plain`
    runs; on a CUDA tensor the kernel launches on the current stream
    (``LAUNCHES.sketch_launches`` counts it) or this raises."""
    R, L = codes.shape
    dev = codes.device
    if not 0 < k <= MAX_K:
        raise ValueError(f"k must be in 1..{MAX_K} (the hash's high part rides in int32), got {k}")
    if not 0 < w < 256:
        raise ValueError(f"w must be in 1..255, got {w}")
    if codes.dtype != torch.uint8:
        raise TypeError(f"codes: expected uint8, got {codes.dtype}")
    if L >= 1 << 22:
        raise ValueError(f"rows of {L} bases: positions ride in 22 bits of mps")
    check_int32("lengths", lengths, (R,), dev)
    kw = dict(k=k, w=w, hpc=hpc, max_minimizers=max_minimizers)
    if dev.type == "cpu":
        return sketch_hpc_plain(codes, lengths, **kw)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not codes.is_contiguous():
        raise ValueError("codes: must be contiguous")
    M = max_minimizers
    outs = [torch.empty((R, M), dtype=torch.int32, device=dev) for _ in range(3)]
    outs.append(torch.empty(R, dtype=torch.int32, device=dev))
    if R == 0:
        return tuple(outs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launch()(
            codes.data_ptr(), lengths.data_ptr(), R, L, k, w, int(bool(hpc)), M,
            *(o.data_ptr() for o in outs), stream,
        )
    if err != 0:
        raise RuntimeError(f"sketch_hpc launch failed: CUDA error {err}")
    LAUNCHES.sketch_launches += 1
    return tuple(outs)
