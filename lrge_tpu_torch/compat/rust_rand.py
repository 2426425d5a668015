"""Reproduction of the Rust ``rand`` 0.9 sampling pipeline used by lrge.

The reference subsamples reads with
``StdRng::seed_from_u64(seed)`` + ``rand::seq::index::sample``
(`liblrge/src/lib.rs:189-204`).  For a seeded run to produce a
bit-identical genome-size estimate, we must select the *same* read
indices in the *same order* (order matters: the target set is the last
``target_num_reads`` elements of the sampled vector,
`liblrge/src/twoset.rs:632-652`).

Versions pinned by the reference's ``Cargo.lock``: rand 0.9.4,
rand_chacha 0.9.0, rand_core 0.9.5.  rand documents a value-stability
policy (seeded output is frozen within a minor version), so any 0.9.x
source is an equally valid oracle.

Components reproduced here, each from the crate source semantics:

* ``rand_core`` 0.9's default ``SeedableRng::seed_from_u64``: a
  SplitMix64 stream keyed by the u64 seed; the 32-byte ChaCha seed is
  filled in 4-byte little-endian chunks, each chunk the low 4 bytes of
  a fresh SplitMix64 output.  (rand_core 0.6 used a PCG32/XSH-RR
  stream here; 0.9 switched to SplitMix64 — a value-breaking change.
  Empirically cross-checked on the reference's own integration fixture:
  with SplitMix64 seeding the seed-6 toy.bam subset contains a strong
  query-target overlap (chain score 527 >= the 100 threshold), matching
  `lrge/tests/alignment.rs:52-68` asserting success; with PCG32 seeding
  the best chain in the subset scores 44 and the run could not succeed.)
* ``ChaCha12Rng`` (rand 0.9's ``StdRng``): standard ChaCha block
  function with 12 rounds, 64-bit block counter in words 12-13, stream
  id 0 in words 14-15; ``next_u32`` yields each block's 16 output words
  in order, ``next_u64`` combines two consecutive words (lo, hi).
* ``UniformInt::<u32>::sample_single_inclusive`` — **Canon's method**:
  one full u64 draw, 64x64->128 widening multiply by the range; the
  high 64 bits are the result and a second u64 draw refines the result
  only when the low 64 bits exceed ``range.wrapping_neg()`` (probability
  ~range/2^64; the doc comment's bias table "96 (i32)" pins the sample
  type for 32-bit ranges to u64).
* ``UniformInt::<u32>::sample`` (the *distribution* form used by
  ``sample_rejection``) — Lemire with precomputed threshold
  ``(-range as u64) % range``, rejecting while ``lo < thresh``.
* ``rand::seq::index::sample``'s algorithm selection between Floyd's
  algorithm, partial Fisher-Yates ("inplace"), and rejection sampling,
  including the quadratic cost model ``(C1[j] + C0[j]*amount)*amount``
  and the ``amount > 11`` Floyd shortcut.  The constant layout is
  cross-checked by continuity at amount==163:
  ``1.6*163 + 10 == 270.8 ~= 270`` and
  ``(8/45)*163 + 70/9 == 36.76 ~= 330/9``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF

def _splitmix64_stream(state: int, n_words: int) -> List[int]:
    """SplitMix64 outputs (rand_core 0.9 ``seed_from_u64`` helper)."""
    out = []
    s = state & _MASK64
    for _ in range(n_words):
        s = (s + 0x9E3779B97F4A7C15) & _MASK64
        z = s
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        z = z ^ (z >> 31)
        out.append(z)
    return out


def seed_from_u64(seed: int) -> bytes:
    """rand_core 0.9's default ``seed_from_u64``: 32 bytes, 4-byte LE
    chunks, each chunk the low 32 bits of a fresh SplitMix64 output."""
    words = _splitmix64_stream(seed, 8)
    return b"".join(int(w & _MASK32).to_bytes(4, "little") for w in words)


def _chacha_rounds(state: np.ndarray, n_rounds: int) -> np.ndarray:
    """Run the ChaCha double-rounds on a (16,) uint32 state copy."""
    x = state.copy()

    def qr(a, b, c, d):
        x[a] = x[a] + x[b]
        x[d] = np.bitwise_xor(x[d], x[a])
        x[d] = (x[d] << np.uint32(16)) | (x[d] >> np.uint32(16))
        x[c] = x[c] + x[d]
        x[b] = np.bitwise_xor(x[b], x[c])
        x[b] = (x[b] << np.uint32(12)) | (x[b] >> np.uint32(20))
        x[a] = x[a] + x[b]
        x[d] = np.bitwise_xor(x[d], x[a])
        x[d] = (x[d] << np.uint32(8)) | (x[d] >> np.uint32(24))
        x[c] = x[c] + x[d]
        x[b] = np.bitwise_xor(x[b], x[c])
        x[b] = (x[b] << np.uint32(7)) | (x[b] >> np.uint32(25))

    for _ in range(n_rounds // 2):
        # column round
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        # diagonal round
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    return x + state


class ChaCha12Rng:
    """``rand_chacha::ChaCha12Rng`` equivalent (rand 0.9's StdRng core)."""

    ROUNDS = 12

    def __init__(self, seed32: bytes):
        if len(seed32) != 32:
            raise ValueError("ChaCha12Rng seed must be 32 bytes")
        consts = np.frombuffer(b"expand 32-byte k", dtype="<u4").astype(np.uint32)
        key = np.frombuffer(seed32, dtype="<u4").astype(np.uint32)
        self._key = key
        self._consts = consts
        self._counter = 0  # 64-bit block counter
        self._buf: np.ndarray = np.empty(0, dtype=np.uint32)
        self._buf_pos = 0

    @classmethod
    def seed_from_u64(cls, seed: int) -> "ChaCha12Rng":
        return cls(seed_from_u64(seed))

    def _refill(self, n_blocks: int = 16) -> None:
        with np.errstate(over="ignore"):
            blocks = []
            for _ in range(n_blocks):
                state = np.empty(16, dtype=np.uint32)
                state[0:4] = self._consts
                state[4:12] = self._key
                state[12] = np.uint32(self._counter & _MASK32)
                state[13] = np.uint32((self._counter >> 32) & _MASK32)
                state[14] = np.uint32(0)  # stream id (64-bit, words 14-15)
                state[15] = np.uint32(0)
                blocks.append(_chacha_rounds(state, self.ROUNDS))
                self._counter += 1
            leftover = self._buf[self._buf_pos :]
            self._buf = np.concatenate([leftover] + blocks)
            self._buf_pos = 0

    def next_u32(self) -> int:
        if self._buf_pos >= len(self._buf):
            self._refill()
        v = int(self._buf[self._buf_pos])
        self._buf_pos += 1
        return v

    def next_u64(self) -> int:
        # BlockRng::next_u64: low word first, then high word.  All our
        # draw sites consume u64s exclusively, so the word index stays
        # even and the BlockRng block-boundary special cases never fire.
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)

    # ---- rand::distr::uniform (integers, 32-bit value type) ----
    #
    # rand 0.9's `uniform_int_impl! { u32, u32, u64 }`: all sampling for
    # u32-valued ranges is done with u64 draws and 64x64->128 widening
    # multiplies.

    def gen_range_u32_inclusive(self, low: int, high: int) -> int:
        """``UniformInt::<u32>::sample_single_inclusive`` — Canon's method.

        One u64 draw; ``result = (draw * range) >> 64``.  When the low
        64 bits of the product exceed ``range.wrapping_neg()`` (the only
        situation in which extra bits could carry into the result), draw
        a second u64 and add the carry of ``lo_order + (draw2*range >> 64)``.
        """
        assert low <= high
        rng_span = (high - low + 1) & _MASK32
        if rng_span == 0:  # full u32 range: plain draw
            return self.next_u32()
        m = self.next_u64() * rng_span  # 128-bit product
        result = m >> 64
        lo_order = m & _MASK64
        if lo_order > ((-rng_span) & _MASK64):
            new_hi_order = (self.next_u64() * rng_span) >> 64
            if lo_order + new_hi_order > _MASK64:
                result += 1
        return (low + result) & _MASK32

    def gen_range_u32(self, low: int, high_exclusive: int) -> int:
        """``sample_single``: half-open range delegates to inclusive."""
        assert low < high_exclusive
        return self.gen_range_u32_inclusive(low, high_exclusive - 1)


class UniformU32:
    """``Uniform::<u32>::new(0, length)`` distribution (Lemire, unbiased).

    Used by ``sample_rejection``, which constructs a ``Uniform``
    distribution once and samples it repeatedly — a *different* draw
    pattern from ``sample_single_inclusive``.
    """

    def __init__(self, low: int, high_exclusive: int):
        if not low < high_exclusive:
            raise ValueError("Uniform::new requires low < high")
        self.low = low
        self.range = (high_exclusive - low) & _MASK32
        if self.range > 0:
            self.thresh = ((-self.range) & _MASK64) % self.range
        else:
            self.thresh = 0

    def sample(self, rng: ChaCha12Rng) -> int:
        if self.range == 0:
            return rng.next_u32()
        while True:
            m = rng.next_u64() * self.range
            hi, lo = m >> 64, m & _MASK64
            if lo >= self.thresh:
                return (self.low + hi) & _MASK32


# ---- rand::seq::index::sample ----


def _sample_floyd(rng: ChaCha12Rng, length: int, amount: int) -> List[int]:
    """Floyd's combination algorithm with the order-randomising amendment.

    Matches rand's ``sample_floyd``: for ``j in length-amount..length``
    draw ``t in 0..=j``; on collision, replace the earlier ``t`` with
    ``j`` and push ``t`` (this yields a uniformly shuffled result).
    """
    indices: List[int] = []
    for j in range(length - amount, length):
        t = rng.gen_range_u32_inclusive(0, j)
        pos = None
        for idx, x in enumerate(indices):
            if x == t:
                pos = idx
                break
        if pos is not None:
            indices[pos] = j
            indices.append(t)
        else:
            indices.append(t)
    return indices


def _sample_inplace(rng: ChaCha12Rng, length: int, amount: int) -> List[int]:
    """Partial Fisher-Yates ("inplace"): swap prefix with random tail.

    ``indices.swap(i, gen_range(i..length))`` then truncate to amount.
    """
    indices = np.arange(length, dtype=np.uint32)
    for i in range(amount):
        j = rng.gen_range_u32(i, length)
        indices[i], indices[j] = indices[j], indices[i]
    return [int(x) for x in indices[:amount]]


def _sample_rejection(rng: ChaCha12Rng, length: int, amount: int) -> List[int]:
    """Rejection sampling against a hash set, preserving draw order.

    Uses the ``Uniform`` *distribution* sampler (Lemire threshold), not
    ``sample_single`` — matching rand's ``sample_rejection``.
    """
    distr = UniformU32(0, length)
    cache = set()
    indices: List[int] = []
    for _ in range(amount):
        pos = distr.sample(rng)
        while pos in cache:
            pos = distr.sample(rng)
        cache.add(pos)
        indices.append(pos)
    return indices


def sample_indices(rng: ChaCha12Rng, length: int, amount: int) -> List[int]:
    """``rand::seq::index::sample`` algorithm selection (u32 branch).

    Cost-model selection from rand's seq/index.rs (rust-random/rand#479).
    All threshold arithmetic is done in f32, as in the source ("We do
    some calculations with f32. Accuracy is not very important") —
    toy.bam's (length=500, amount=15) sits 10 away from the boundary
    (threshold 510), so f32 vs f64 could matter on other inputs.
    """
    if amount > length:
        raise ValueError("Cannot sample more than the total number of items")
    f32 = np.float32
    if amount < 163:
        c = [[f32(1.6), f32(8.0) / f32(45.0)], [f32(10.0), f32(70.0) / f32(9.0)]]
        j = 0 if length < 500_000 else 1
        amount_fp = f32(amount)
        m4 = c[0][j] * amount_fp
        # Short-cut: when amount < 12, Floyd's is always faster.
        if amount > 11 and f32(length) < (c[1][j] + m4) * amount_fp:
            return _sample_inplace(rng, length, amount)
        return _sample_floyd(rng, length, amount)
    else:
        c = [f32(270.0), f32(330.0) / f32(9.0)]
        j = 0 if length < 500_000 else 1
        if f32(length) < c[j] * f32(amount):
            return _sample_inplace(rng, length, amount)
        return _sample_rejection(rng, length, amount)


def unique_random_set(k: int, n: int, seed: Optional[int]) -> List[int]:
    """`liblrge/src/lib.rs:189-204`: k unique indices in [0, n).

    With a seed, uses the reproduced StdRng; without, uses OS entropy
    (order/selection then need not match any particular reference run).
    """
    if k > n:
        raise ValueError(f"Cannot generate {k} unique values from a range of 0 to {n}")
    if seed is not None:
        rng = ChaCha12Rng.seed_from_u64(seed)
    else:
        import secrets

        rng = ChaCha12Rng(secrets.token_bytes(32))
    return sample_indices(rng, n, k)


def split_into_sets(indices: List[int], size_first: int) -> Tuple[set, set]:
    """`twoset.rs:632-652`: pop from the END into set1, rest into set2.

    set1 (the target set) gets the *last* ``size_first`` elements of the
    sampled vector; set2 (the query set) gets the remainder.
    """
    n1 = min(size_first, len(indices))
    first = set(indices[len(indices) - n1 :])
    second = set(indices[: len(indices) - n1])
    return first, second
