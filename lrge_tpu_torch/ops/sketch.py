"""Minimizer sketching (minimap2 ``mm_sketch``-equivalent).

Three implementations with identical semantics:

* :func:`sketch_scalar` — a direct Python port of the classic (k,w)
  robust-winnowing loop used by minimap2 2.x (`sketch.c` semantics:
  invertible ``hash64`` over the canonical strand, all window-tie
  minimizers emitted, HPC spans, final-window push).  This is the
  *oracle* the fast paths are tested against.
* :func:`minimizers_numpy` — vectorised host implementation (uint64),
  used for index building and the PacBio/HPC path.
* :func:`sketch_batch` (JAX) — batched on-device path for the ONT preset
  (``2k <= 32`` so the hash fits uint32 exactly; see
  :func:`hash32_jax`).

The equivalence between the loop formulation and the vectorised
"window-min cover" formulation: a k-mer at position ``p`` is emitted iff
its key equals the minimum of some *fully-valid* window of ``w``
consecutive k-mers containing ``p``, plus the final-window push which
emits the latest minimum of the last ``w`` positions unconditionally.
Both fast paths implement that rule; ``tests/test_sketch.py`` checks it
against the scalar oracle on random reads with and without ambiguous
bases.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

from .encode import hpc_compress

_U64 = np.uint64


def hash64(key: np.ndarray, mask: int) -> np.ndarray:
    """minimap2's invertible 64-bit hash, vectorised (numpy uint64)."""
    key = np.asarray(key, dtype=np.uint64)
    m = _U64(mask)
    with np.errstate(over="ignore"):
        key = (~key + (key << _U64(21))) & m
        key = key ^ (key >> _U64(24))
        key = (key + (key << _U64(3)) + (key << _U64(8))) & m  # * 265
        key = key ^ (key >> _U64(14))
        key = (key + (key << _U64(2)) + (key << _U64(4))) & m  # * 21
        key = key ^ (key >> _U64(28))
        key = (key + (key << _U64(31))) & m
    return key


class Minimizers(NamedTuple):
    """Sketch of one sequence.

    ``key``: uint64 ``hash<<8 | span``; ``pos``: 0-based position of the
    k-mer's last base in the *original* sequence; ``strand``: 0 forward,
    1 reverse-canonical.
    """

    key: np.ndarray
    pos: np.ndarray
    strand: np.ndarray


def sketch_scalar(codes: np.ndarray, k: int, w: int, hpc: bool = False) -> Minimizers:
    """Oracle: direct port of the minimap2 sketching loop."""
    n = len(codes)
    mask = (1 << (2 * k)) - 1
    shift1 = 2 * (k - 1)
    kmer = [0, 0]
    INF = (1 << 72) - 1  # larger than any key
    buf: list[tuple[int, int, int]] = [(INF, -1, 0)] * w  # (key, pos, strand)
    out: list[tuple[int, int, int]] = []
    tq: list[int] = []  # last <=k run lengths (HPC span queue)
    kmer_span = 0
    mn = (INF, -1, 0)
    min_pos = 0
    l = 0
    buf_pos = 0
    i = 0
    while i < n:
        c = int(codes[i])
        info = (INF, -1, 0)
        if c < 4:
            if hpc:
                skip_len = 1
                if i + 1 < n and int(codes[i + 1]) == c:
                    skip_len = 2
                    while i + skip_len < n and int(codes[i + skip_len]) == c:
                        skip_len += 1
                    i += skip_len - 1
                tq.append(skip_len)
                kmer_span += skip_len
                if len(tq) > k:
                    kmer_span -= tq.pop(0)
            else:
                kmer_span = l + 1 if l + 1 < k else k
            kmer[0] = ((kmer[0] << 2) | c) & mask
            kmer[1] = (kmer[1] >> 2) | ((3 ^ c) << shift1)
            if kmer[0] == kmer[1]:
                i += 1
                continue  # symmetric k-mer: strand ambiguous, skip slot
            z = 0 if kmer[0] < kmer[1] else 1
            l += 1
            if l >= k and kmer_span < 256:
                key = (int(hash64(kmer[z], mask)) << 8) | kmer_span
                info = (key, i, z)
        else:
            l = 0
            tq.clear()
            kmer_span = 0
        buf[buf_pos] = info
        if l == w + k - 1 and mn[0] != INF:
            # first full window: emit ties of the current minimum
            for j in list(range(buf_pos + 1, w)) + list(range(buf_pos)):
                if mn[0] == buf[j][0] and buf[j][1:] != mn[1:]:
                    out.append(buf[j])
        if info[0] <= mn[0]:
            if l >= w + k and mn[0] != INF:
                out.append(mn)
            mn, min_pos = info, buf_pos
        elif buf_pos == min_pos:
            if l >= w + k - 1 and mn[0] != INF:
                out.append(mn)
            mn = (INF, -1, 0)
            for j in list(range(buf_pos + 1, w)) + list(range(buf_pos + 1)):
                if mn[0] >= buf[j][0]:
                    mn, min_pos = buf[j], j
            if l >= w + k - 1 and mn[0] != INF:
                for j in list(range(buf_pos + 1, w)) + list(range(buf_pos + 1)):
                    if mn[0] == buf[j][0] and buf[j][1:] != mn[1:]:
                        out.append(buf[j])
        buf_pos += 1
        if buf_pos == w:
            buf_pos = 0
        i += 1
    if mn[0] != INF:
        out.append(mn)
    if not out:
        z = np.zeros(0, dtype=np.uint64)
        return Minimizers(z, np.zeros(0, np.int64), np.zeros(0, np.int64))
    # de-duplicate (the loop can emit an entry twice) and sort by position
    uniq = sorted(set(out), key=lambda t: (t[1], t[0]))
    keys = np.array([t[0] for t in uniq], dtype=np.uint64)
    poss = np.array([t[1] for t in uniq], dtype=np.int64)
    strands = np.array([t[2] for t in uniq], dtype=np.int64)
    return Minimizers(keys, poss, strands)


# ---------------------------------------------------------------------------
# Vectorised host implementation (uint64; handles both presets incl. HPC)
# ---------------------------------------------------------------------------


def _kmer_keys_numpy(
    ccodes: np.ndarray, k: int, spans: np.ndarray | None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-position (key, strand, valid) over a (compressed) code vector."""
    n = len(ccodes)
    mask = (1 << (2 * k)) - 1
    c = ccodes.astype(np.uint64)
    ambig = ccodes >= 4
    csafe = np.where(ambig, 0, c)
    fwd = np.zeros(n, dtype=np.uint64)
    rev = np.zeros(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for j in range(k):
            # base at position i-j contributes bits 2j (fwd) / 2(k-1-j) (rev)
            shifted = np.empty(n, dtype=np.uint64)
            if j == 0:
                shifted[:] = csafe
            else:
                shifted[j:] = csafe[:-j]
                shifted[:j] = 0
            fwd |= shifted << _U64(2 * j)
            rev |= (_U64(3) ^ shifted) << _U64(2 * (k - 1 - j))
        fwd &= _U64(mask)
        rev &= _U64(mask)
    # validity: k consecutive non-ambiguous codes ending at i
    run = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(~ambig, out=run[1:])
    valid = np.zeros(n, dtype=bool)
    if n >= k:
        valid[k - 1 :] = (run[k:] - run[:-k]) == k
    strand = (fwd >= rev).astype(np.int64)  # z: 0 if fwd < rev
    canon = np.minimum(fwd, rev)
    key = hash64(canon, mask) << _U64(8)
    if spans is None:
        key |= _U64(k)
        span_ok = np.ones(n, dtype=bool)
    else:
        span_ok = spans < 256
        key |= np.minimum(spans, 255).astype(np.uint64)
    valid &= span_ok
    # palindromes (fwd == rev) are skipped by minimap2; impossible for odd k
    valid &= fwd != rev
    return key, strand, valid


def _select_minimizers(
    key: np.ndarray, valid: np.ndarray, w: int, k: int
) -> np.ndarray:
    """Window-min cover selection; returns a bool mask over positions.

    Exact for "clean" inputs (every k-mer from position k-1 on valid —
    guaranteed by the ``needs_scalar_sketch`` dispatch).  On top of the
    cover rule this reproduces the loop's *first-window* behavior: at
    ``l == w+k-1`` the loop pushes all buffer entries tied with the
    held (prefix) minimum, and the held entry itself is dropped when the
    window-closing k-mer ties it (displacement gate ``l >= w+k`` fails).
    """
    n = len(key)
    INF = np.uint64(0xFFFFFFFFFFFFFFFF)
    x = np.where(valid, key, INF)
    if n == 0:
        return np.zeros(0, dtype=bool)
    # window minimum ending at e over [e-w+1, e]
    wmin = x.copy()
    for d in range(1, w):
        shifted = np.full(n, INF)
        shifted[d:] = x[:-d]
        np.minimum(wmin, shifted, out=wmin)
    # gate: all w k-mers in the window valid (l >= w+k-1)
    vcum = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(valid, out=vcum[1:])
    gated = np.zeros(n, dtype=bool)
    if n >= w:
        gated[w - 1 :] = (vcum[w:] - vcum[:-w]) == w
    gated &= np.arange(n) >= w + k - 2
    sel = np.zeros(n, dtype=bool)
    for d in range(w):
        # window ending at p+d contains p
        g = np.zeros(n, dtype=bool)
        m = np.zeros(n, dtype=np.uint64)
        if d == 0:
            g, m = gated, wmin
        else:
            g[:-d] = gated[d:]
            m[:-d] = wmin[d:]
        sel |= g & (m == x) & valid
    # first-window amendment (see docstring): prefix = k-mers before the
    # first full window closes at e0 = w+k-2
    e0 = w + k - 2
    if n > e0 and w >= 2:
        prefix = x[k - 1 : e0]
        pmin = prefix.min() if prefix.size else INF
        if pmin != INF:
            held = k - 1 + (len(prefix) - 1 - int(np.argmin(prefix[::-1])))
            win = slice(k - 1, e0 + 1)
            add = (x[win] == pmin) & valid[win]
            add[held - (k - 1)] = False
            sel[win] |= add
            if x[e0] == pmin:
                sel[held] = False
    # final-window push: latest minimum of the last w positions
    lo = max(0, n - w)
    tail = x[lo:]
    if tail.size and valid[lo:].any():
        rel = len(tail) - 1 - int(np.argmin(tail[::-1]))
        if valid[lo + rel]:
            sel[lo + rel] = True
    return sel


def needs_scalar_sketch(codes: np.ndarray, k: int, w: int, hpc: bool = False) -> bool:
    """Whether a read requires the scalar oracle for exactness.

    The vectorised cover rule (plus its first-window amendment) is exact
    for "clean" reads.  Two conditions escape it:

    * ambiguous bases: the loop's emission gate consults the run length
      at *push* time, so N-resets can suppress minima the cover rule
      would keep;
    * HPC k-mer spans >= 256: the loop marks such k-mers invalid while
      still counting them toward the window gate, which the all-valid
      window formulation cannot express.
    """
    if (codes >= 4).any():
        return True
    if hpc:
        _, _, run_len = hpc_compress(codes)
        cs = np.concatenate([[0], np.cumsum(run_len)])
        idx = np.arange(len(run_len))
        spans = cs[idx + 1] - cs[np.maximum(idx - k + 1, 0)]
        if (spans >= 256).any():
            return True
    return False


def sketch_read(codes: np.ndarray, k: int, w: int, hpc: bool = False) -> Minimizers:
    """Sketch one read with exact minimap2 semantics.

    Clean reads take the vectorised path; reads hitting a loop quirk
    (see :func:`needs_scalar_sketch`) fall back to the scalar oracle.
    """
    if needs_scalar_sketch(codes, k, w, hpc):
        return sketch_scalar(codes, k, w, hpc)
    return minimizers_numpy(codes, k, w, hpc)


def sketch_seqs_native(seqs, k: int, w: int, hpc: bool, threads: int = 0):
    """Sketch raw-ASCII reads with the multithreaded native kernel.

    Returns ``list[Minimizers]`` or ``None`` when the native extension
    is unavailable.  The C kernel is a port of :func:`sketch_scalar`
    (the oracle), so it is exact for every input, quirks included.
    """
    from ..native import native

    if native is None:
        return None
    if threads <= 0:
        import os

        threads = os.cpu_count() or 2
    out = []
    for kb, pb, sb in native.sketch_many(list(seqs), k, w, int(hpc), threads):
        out.append(
            Minimizers(
                np.frombuffer(kb, dtype="<u8"),
                np.frombuffer(pb, dtype="<i4").astype(np.int64),
                np.frombuffer(sb, dtype=np.uint8).astype(np.int64),
            )
        )
    return out


def sketch_seq(seq: bytes, k: int, w: int, hpc: bool = False) -> Minimizers:
    """Sketch one raw-ASCII read: native kernel when available, else the
    encode + dispatch path."""
    res = sketch_seqs_native([seq], k, w, hpc, threads=1)
    if res is not None:
        return res[0]
    from .encode import encode_seq

    return sketch_read(encode_seq(seq), k, w, hpc)


def minimizers_numpy(codes: np.ndarray, k: int, w: int, hpc: bool = False) -> Minimizers:
    """Vectorised sketch of one read (host, exact uint64 keys).

    Only exact for reads without ambiguous bases — use
    :func:`sketch_read` for the dispatching entry point.
    """
    if hpc:
        ccodes, end_pos, run_len = hpc_compress(codes)
        # HPC k-mer span: sum of the last k run lengths
        rl = run_len.astype(np.int64)
        cs = np.concatenate([[0], np.cumsum(rl)])
        n = len(ccodes)
        spans = np.empty(n, dtype=np.int64)
        idx = np.arange(n)
        lo = np.maximum(idx - k + 1, 0)
        spans = cs[idx + 1] - cs[lo]
        key, strand, valid = _kmer_keys_numpy(ccodes, k, spans)
        sel = _select_minimizers(key, valid, w, k)
        pos = end_pos
    else:
        key, strand, valid = _kmer_keys_numpy(codes, k, None)
        sel = _select_minimizers(key, valid, w, k)
        pos = np.arange(len(codes), dtype=np.int64)
    m = np.flatnonzero(sel)
    return Minimizers(key[m], pos[m], strand[m])
