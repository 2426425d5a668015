"""minimap2's minimizer sketch (``mm_sketch``): the scalar loop and the
vectorised cover rule, dispatched per read as the port's plain path does."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

_U64 = np.uint64

# byte -> 2-bit code; 4 marks ambiguous bases (minimap2 seq_nt4_table)
NT4 = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    NT4[_b] = _i
for _i, _b in enumerate(b"acgt"):
    NT4[_b] = _i


def encode_seq(seq: bytes) -> np.ndarray:
    return NT4[np.frombuffer(seq, dtype=np.uint8)]


def hpc_compress(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(codes of the runs, last position of each run, run lengths)``;
    ambiguous bases never merge."""
    n = len(codes)
    if n == 0:
        empty = np.empty(0, dtype=np.int64)
        return codes.copy(), empty, empty
    prev = np.empty(n, dtype=bool)
    prev[0] = True
    prev[1:] = ~((codes[1:] == codes[:-1]) & (codes[1:] != 4))
    starts = np.flatnonzero(prev)
    ends = np.empty_like(starts)
    ends[:-1] = starts[1:] - 1
    ends[-1] = n - 1
    return codes[starts], ends, (ends - starts + 1)


def hash64(key: np.ndarray, mask: int) -> np.ndarray:
    """minimap2's invertible 64-bit hash."""
    key = np.asarray(key, dtype=np.uint64)
    m = _U64(mask)
    with np.errstate(over="ignore"):
        key = (~key + (key << _U64(21))) & m
        key = key ^ (key >> _U64(24))
        key = (key + (key << _U64(3)) + (key << _U64(8))) & m
        key = key ^ (key >> _U64(14))
        key = (key + (key << _U64(2)) + (key << _U64(4))) & m
        key = key ^ (key >> _U64(28))
        key = (key + (key << _U64(31))) & m
    return key


class Minimizers(NamedTuple):
    key: np.ndarray  # uint64 hash << 8 | span
    pos: np.ndarray  # last base of the k-mer in the original read
    strand: np.ndarray  # 0 forward, 1 reverse


def sketch_scalar(codes: np.ndarray, k: int, w: int, hpc: bool = False) -> Minimizers:
    """minimap2's sketch loop, statement for statement."""
    n = len(codes)
    mask = (1 << (2 * k)) - 1
    shift1 = 2 * (k - 1)
    kmer = [0, 0]
    INF = (1 << 72) - 1
    buf = [(INF, -1, 0)] * w
    out = []
    tq = []
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
                continue
            z = 0 if kmer[0] < kmer[1] else 1
            l += 1
            if l >= k and kmer_span < 256:
                info = ((int(hash64(kmer[z], mask)) << 8) | kmer_span, i, z)
        else:
            l = 0
            tq.clear()
            kmer_span = 0
        buf[buf_pos] = info
        if l == w + k - 1 and mn[0] != INF:
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
        return Minimizers(np.zeros(0, np.uint64), np.zeros(0, np.int64), np.zeros(0, np.int64))
    uniq = sorted(set(out), key=lambda t: (t[1], t[0]))
    return Minimizers(
        np.array([t[0] for t in uniq], dtype=np.uint64),
        np.array([t[1] for t in uniq], dtype=np.int64),
        np.array([t[2] for t in uniq], dtype=np.int64),
    )


def _kmer_keys(ccodes: np.ndarray, k: int, spans) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per position: (hash << 8 | span, strand, valid)."""
    n = len(ccodes)
    mask = (1 << (2 * k)) - 1
    ambig = ccodes >= 4
    csafe = np.where(ambig, 0, ccodes.astype(np.uint64))
    fwd = np.zeros(n, dtype=np.uint64)
    rev = np.zeros(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for j in range(k):
            shifted = np.zeros(n, dtype=np.uint64)
            shifted[j:] = csafe[: n - j]
            fwd |= shifted << _U64(2 * j)
            rev |= (_U64(3) ^ shifted) << _U64(2 * (k - 1 - j))
        fwd &= _U64(mask)
        rev &= _U64(mask)
    run = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(~ambig, out=run[1:])
    valid = np.zeros(n, dtype=bool)
    if n >= k:
        valid[k - 1 :] = (run[k:] - run[:-k]) == k
    strand = (fwd >= rev).astype(np.int64)
    key = hash64(np.minimum(fwd, rev), mask) << _U64(8)
    if spans is None:
        key |= _U64(k)
    else:
        valid &= spans < 256
        key |= np.minimum(spans, 255).astype(np.uint64)
    valid &= fwd != rev
    return key, strand, valid


def _select(key: np.ndarray, valid: np.ndarray, w: int, k: int) -> np.ndarray:
    """The window-min cover rule with the loop's first-window behaviour
    and its final-window push; a mask over positions."""
    n = len(key)
    INF = np.uint64(0xFFFFFFFFFFFFFFFF)
    if n == 0:
        return np.zeros(0, dtype=bool)
    x = np.where(valid, key, INF)
    wmin = x.copy()
    for d in range(1, w):
        shifted = np.full(n, INF)
        shifted[d:] = x[:-d]
        np.minimum(wmin, shifted, out=wmin)
    vcum = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(valid, out=vcum[1:])
    gated = np.zeros(n, dtype=bool)
    if n >= w:
        gated[w - 1 :] = (vcum[w:] - vcum[:-w]) == w
    gated &= np.arange(n) >= w + k - 2
    sel = np.zeros(n, dtype=bool)
    for d in range(w):
        if d == 0:
            g, m = gated, wmin
        else:
            g = np.zeros(n, dtype=bool)
            m = np.zeros(n, dtype=np.uint64)
            g[:-d] = gated[d:]
            m[:-d] = wmin[d:]
        sel |= g & (m == x) & valid
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
    lo = max(0, n - w)
    tail = x[lo:]
    if tail.size and valid[lo:].any():
        rel = len(tail) - 1 - int(np.argmin(tail[::-1]))
        if valid[lo + rel]:
            sel[lo + rel] = True
    return sel


def _needs_scalar(codes: np.ndarray, k: int, hpc: bool) -> bool:
    """Reads the cover rule is not exact for: ambiguous bases, and HPC
    k-mer spans of 256 or more."""
    if (codes >= 4).any():
        return True
    if hpc:
        _, _, run_len = hpc_compress(codes)
        cs = np.concatenate([[0], np.cumsum(run_len)])
        idx = np.arange(len(run_len))
        if ((cs[idx + 1] - cs[np.maximum(idx - k + 1, 0)]) >= 256).any():
            return True
    return False


def sketch(seq: bytes, k: int, w: int, hpc: bool) -> Minimizers:
    """One read's minimizers, exact for every input."""
    codes = encode_seq(seq)
    if _needs_scalar(codes, k, hpc):
        return sketch_scalar(codes, k, w, hpc)
    if hpc:
        ccodes, end_pos, run_len = hpc_compress(codes)
        cs = np.concatenate([[0], np.cumsum(run_len.astype(np.int64))])
        idx = np.arange(len(ccodes))
        spans = cs[idx + 1] - cs[np.maximum(idx - k + 1, 0)]
        key, strand, valid = _kmer_keys(ccodes, k, spans)
        pos = end_pos
    else:
        key, strand, valid = _kmer_keys(codes, k, None)
        pos = np.arange(len(codes), dtype=np.int64)
    m = np.flatnonzero(_select(key, valid, w, k))
    return Minimizers(key[m], pos[m], strand[m])
