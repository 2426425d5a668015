"""Reads and parameter sets that reach each quirk of the PacBio/HPC query sketch.

The tests and ``chip_smoke.py`` hold the CUDA sketch kernel
(``csrc/sketch_hpc.cu``) to its plain version, and the plain version to
the native sketcher, on these cases.
"""

from __future__ import annotations

import numpy as np

from .encode import encode_seq

# the sketch's parameter sets, (k, w, hpc): the preset's, without HPC at
# k = 19 (a user's k >= 17), even k with and without HPC (symmetric
# k-mers), a long k and window, and w = 1
HPC_PARAMS = {
    "pb": (19, 5, True), "no_hpc_k19": (19, 5, False), "even_k18": (18, 5, True),
    "even_k20_no_hpc": (20, 3, False), "k25_w10": (25, 10, True), "k17_w1": (17, 1, True),
}


def hpc_edge_reads(rng):
    """Reads that reach each quirk of minimap2's sketch loop: plain and
    homopolymer-rich reads, lowercase, scattered N and IUPAC bytes, runs
    of N, runs long enough that a k-mer spans 256 bases or more, ``AT``
    and ``ACGT`` repeats (every even-k window of ``AT`` repeats is its
    own reverse complement), reads shorter than ``w + k - 1``, empty
    and all-N rows, and long reads with more minimizers than a small
    capacity holds."""
    acgt = lambda n: bytes(rng.choice(list(b"ACGT"), size=n).tolist())
    runs = lambda n: b"".join(bytes([rng.choice(list(b"ACGT"))]) * int(rng.integers(1, 9)) for _ in range(n))
    iupac = bytearray(acgt(1200))
    for i in np.flatnonzero(rng.random(len(iupac)) < 0.03):
        iupac[i] = rng.choice(list(b"NRYKMSWBDHVn-."))
    return [
        acgt(1800), runs(350), acgt(600) + acgt(600).lower(), bytes(iupac),
        acgt(300) + b"N" * 40 + acgt(300) + b"NNNN" + acgt(10) + b"N" + acgt(400),
        acgt(200) + b"A" * 300 + acgt(100) + b"C" * 260 + b"G" * 10 + acgt(200),
        b"AT" * 300 + acgt(50) + b"GC" * 200 + b"ACGT" * 100,
        acgt(5), acgt(19), acgt(22), acgt(23), acgt(24), b"", b"N" * 30, acgt(2000),
    ]


def hifi_reads(rng, n, lo, hi, genome_len=400_000):
    """``n`` reads of ``lo`` to ``hi - 1`` bases at 0.2% errors from one
    random genome with homopolymer runs of 1-6 bases (HiFi-like)."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    run = rng.integers(1, 7, genome_len // 3)
    genome = np.repeat(bases[rng.integers(0, 4, len(run))], run)
    out = []
    for length in rng.integers(lo, hi, n):
        pos = int(rng.integers(0, len(genome) - length))
        s = genome[pos : pos + length].copy()
        hit = rng.random(length) < 0.002
        s[hit] = bases[rng.integers(0, 4, int(hit.sum()))]
        out.append(s.tobytes())
    return out


def padded_codes(seqs, L=None):
    """``seqs`` encoded into ``[len(seqs), L]`` uint8 codes padded with 4
    (``L`` the longest read, at least 1, when None), and their int32
    lengths (numpy both)."""
    L = max([1, *map(len, seqs)]) if L is None else L
    codes = np.full((len(seqs), L), 4, np.uint8)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = encode_seq(s)
    return codes, np.array([len(s) for s in seqs], np.int32)
