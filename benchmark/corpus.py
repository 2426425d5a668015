"""The benchmark's read generator, frozen.

A copy of ``lrge_tpu_torch/bench.py``'s ``make_reads`` and
``make_corpus``, widened so that a traffic file
(``benchmark/traffic/<name>.json``) states the organism and the read
profile, and with the seed from the command line.  The program may
change its own generator; this one stays, so that a cell means the same
reads in every check.

A genome (the traffic file's ``genome``) is ``size`` random bases from
the seed, uniform or at the GC share ``gc`` (as are the repeats'
consensuses).  Repeats are then written over it:

* ``family`` and ``tandem`` (the bench's): one segment copied over
  ``copies`` places ``stride`` apart, and a unit repeated ``copies``
  times in place;
* each entry of ``repeats``: ``families`` families, each a random
  consensus of ``length`` bases (or a tandem array of ``copies`` units
  of ``unit`` bases, where ``tandem`` is true) placed ``copies`` times
  (arrays: ``families`` times) at random places on a random strand, each
  copy (each unit) with its own substitutions at the rate
  ``divergence`` from the consensus.  Later copies overwrite earlier
  ones where they meet.

Targets and then queries are drawn straight from the genome (the
traffic file's ``reads``): gamma(``shape``) lengths of mean ``mean``,
clipped to [``min``, ``max``], a random place and strand, and errors at
per-base rates: ``substitution`` (another base), ``deletion`` and
``insertion`` (a random base).  The bench's own profile gives ``error``
instead, a rate of bases redrawn uniformly (a quarter of them keep
their base); with it and the bench's genome, seed 6 with 10,000 targets
and 5,000 queries is the bench corpus byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
CODE = np.zeros(256, dtype=np.uint8)
CODE[BASES] = np.arange(4, dtype=np.uint8)
RC = bytes.maketrans(b"ACGT", b"TGCA")


def substitute(arr: np.ndarray, sites: np.ndarray, rng) -> None:
    """Each base of ``arr`` at ``sites`` replaced by another base."""
    arr[sites] = BASES[(CODE[arr[sites]] + rng.integers(1, 4, size=len(sites))) % 4]


def make_reads(rng, genome: bytes, n: int, reads: dict) -> list:
    """``n`` reads of the profile ``reads`` drawn from ``genome``."""
    shape, mean = float(reads["shape"]), float(reads["mean"])
    lens = np.clip(rng.gamma(shape, mean / shape, size=n).astype(int), int(reads["min"]), int(reads["max"]))
    redraw = float(reads.get("error", 0.0))
    sub, dele, ins = (float(reads.get(k, 0.0)) for k in ("substitution", "deletion", "insertion"))
    out = []
    g = np.frombuffer(genome, dtype=np.uint8)
    for L in lens:
        L = int(min(L, len(genome) - 1))
        pos = int(rng.integers(0, len(genome) - L))
        arr = g[pos : pos + L].copy()
        nerr = rng.binomial(L, redraw)
        if nerr:
            sites = rng.integers(0, L, size=nerr)
            arr[sites] = BASES[rng.integers(0, 4, size=nerr)]
        if sub:
            substitute(arr, rng.integers(0, L, size=rng.binomial(L, sub)), rng)
        if dele:
            keep = np.ones(L, dtype=bool)
            keep[rng.integers(0, L, size=rng.binomial(L, dele))] = False
            arr = arr[keep]
        if ins:
            m = rng.binomial(len(arr), ins)
            arr = np.insert(arr, rng.integers(0, len(arr) + 1, size=m), BASES[rng.integers(0, 4, size=m)])
        seq = arr.tobytes()
        if rng.integers(0, 2):
            seq = seq.translate(RC)[::-1]
        out.append(seq)
    return out


def _copy(rng, consensus: np.ndarray, divergence: float) -> np.ndarray:
    """A copy of ``consensus`` with substitutions at ``divergence``."""
    arr = consensus.copy()
    if divergence:
        substitute(arr, rng.integers(0, len(arr), size=rng.binomial(len(arr), divergence)), rng)
    return arr


def _place(rng, seq: np.ndarray, piece: np.ndarray) -> None:
    """``piece`` written over ``seq`` at a random place on a random strand."""
    if rng.integers(0, 2):
        piece = np.frombuffer(piece.tobytes().translate(RC)[::-1], dtype=np.uint8)
    at = int(rng.integers(0, len(seq) - len(piece)))
    seq[at : at + len(piece)] = piece


def random_bases(rng, n: int, gc: float | None) -> np.ndarray:
    """``n`` random base codes (0-3 for ACGT), uniform or at the GC share ``gc``."""
    if gc is None:
        return np.frombuffer(rng.integers(0, 4, size=n, dtype=np.uint8), dtype=np.uint8)
    u = rng.integers(0, 1 << 16, size=n, dtype=np.uint16)
    return sum((u >= round(e * (1 << 16))).view(np.uint8) for e in ((1 - gc) / 2, 0.5, (1 + gc) / 2))


def make_genome(rng, genome: dict) -> bytes:
    """A random genome with the traffic file's repeats."""
    gc = genome.get("gc")
    codes = random_bases(rng, int(genome["size"]), gc)
    seq = bytearray(BASES[codes].tobytes())
    if "family" in genome:
        fam = genome["family"]
        src, flen = int(fam["source"]), int(fam["length"])
        unit_seq = bytes(seq[src : src + flen])
        for c in range(int(fam["copies"])):
            pos = int(fam["first"]) + c * int(fam["stride"])
            seq[pos : pos + flen] = unit_seq
    if "tandem" in genome:
        tan = genome["tandem"]
        src, ulen, copies = int(tan["source"]), int(tan["unit"]), int(tan["copies"])
        unit = bytes(seq[src : src + ulen])
        dst = int(tan["at"])
        seq[dst : dst + ulen * copies] = unit * copies
    arr = np.frombuffer(seq, dtype=np.uint8).copy()
    for rep in genome.get("repeats", []):
        div = float(rep["divergence"])
        for _ in range(int(rep["families"])):
            if rep.get("tandem"):
                unit = BASES[random_bases(rng, int(rep["unit"]), gc)]
                _place(rng, arr, np.concatenate([_copy(rng, unit, div) for _ in range(int(rep["copies"]))]))
            else:
                consensus = BASES[random_bases(rng, int(rep["length"]), gc)]
                for _ in range(int(rep["copies"])):
                    _place(rng, arr, _copy(rng, consensus, div))
    return arr.tobytes()


@dataclass
class Corpus:
    genome_size: int
    targets: list
    queries: list
    tnames: list
    qnames: list


def rng_for(seed: int) -> np.random.Generator:
    """The generator of ``seed``: any whole number; a non-negative one
    below 2**64 is used as it is (seed 6 is the bench's)."""
    return np.random.default_rng(int(seed) % (1 << 64))


def make_corpus(traffic: dict, n_targets: int, n_queries: int, seed: int) -> Corpus:
    """The genome, then ``n_targets`` targets and ``n_queries`` queries,
    all from ``seed``."""
    rng = rng_for(seed)
    genome = make_genome(rng, traffic["genome"])
    targets = make_reads(rng, genome, n_targets, traffic["reads"])
    queries = make_reads(rng, genome, n_queries, traffic["reads"])
    tnames = [b"t%d" % i for i in range(n_targets)]
    qnames = [b"q%d" % i for i in range(n_queries)]
    return Corpus(len(genome), targets, queries, tnames, qnames)
