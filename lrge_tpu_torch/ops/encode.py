"""Base encoding and read batching.

Reads are 2-bit encoded (A=0, C=1, G=2, T=3; anything else = 4) on the
host and padded into fixed-shape ``[B, L]`` batches for the TPU kernels.
The code table matches minimap2's ``seq_nt4_table`` so k-mer values (and
therefore minimizer hashes) are identical.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

# byte -> 2-bit code; 4 marks ambiguous bases (minimap2 seq_nt4_table)
NT4 = np.full(256, 4, dtype=np.uint8)
for i, base in enumerate(b"ACGT"):
    NT4[base] = i
for i, base in enumerate(b"acgt"):
    NT4[base] = i


def encode_seq(seq: bytes) -> np.ndarray:
    """Encode one sequence to 2-bit codes (4 = ambiguous)."""
    try:
        from ..native import native
    except Exception:
        native = None
    if native is not None:
        return np.frombuffer(native.encode_seq(seq), dtype=np.uint8)
    return NT4[np.frombuffer(seq, dtype=np.uint8)]


def hpc_compress(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Homopolymer-compress a code vector (minimap2 ``-H``).

    Returns ``(ccodes, end_pos, run_len)`` where ``ccodes[j]`` is the
    code of the j-th run, ``end_pos[j]`` the 0-based position of the
    run's LAST base in the original sequence (minimap2 stores minimizer
    positions in original coordinates after skipping the run), and
    ``run_len[j]`` the run length (used for the HPC k-mer span).

    Ambiguous bases (code 4) break runs and are kept as singleton runs so
    the sketcher can reset on them exactly like the uncompressed path.
    """
    n = len(codes)
    if n == 0:
        empty = np.empty(0, dtype=np.int64)
        return codes.copy(), empty, empty
    # run starts: first position or differs from previous; ambiguous bases
    # never merge (a run of Ns is n singleton runs)
    prev = np.empty(n, dtype=bool)
    prev[0] = True
    same = codes[1:] == codes[:-1]
    merge = same & (codes[1:] != 4)
    prev[1:] = ~merge
    starts = np.flatnonzero(prev)
    ends = np.empty_like(starts)
    ends[:-1] = starts[1:] - 1
    ends[-1] = n - 1
    return codes[starts], ends, (ends - starts + 1)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class ReadBatch:
    """A padded batch of encoded reads.

    ``codes`` is ``[B, L]`` uint8 with 4 in the padding; ``lengths`` the
    true lengths.  ``ids`` are indices into the owning read set.
    """

    codes: np.ndarray  # [B, L] uint8
    lengths: np.ndarray  # [B] int32
    ids: np.ndarray  # [B] int32


def next_pow2(x: int) -> int:
    return 1 << (max(x, 1) - 1).bit_length()


def make_batches(
    seqs: Sequence[bytes],
    ids: Sequence[int] | None = None,
    batch_size: int = 128,
    pad_to: int = 256,
    length_sorted: bool = True,
    pow2_lengths: bool = False,
    pad_batch: bool = False,
) -> list[ReadBatch]:
    """Bucket reads into padded batches.

    Sorting by length before batching keeps padding waste low (long and
    short reads don't share a batch); the ``ids`` let callers scatter
    per-read results back to the original order.

    ``pow2_lengths`` pads each batch's length to the next power of two
    (>= ``pad_to``) and ``pad_batch`` pads the row count to a full
    ``batch_size`` (padding rows have id -1 and length 0) — together
    they bound the number of distinct compiled shapes, which matters
    when compilation is remote/expensive.
    """
    n = len(seqs)
    if ids is None:
        ids = np.arange(n, dtype=np.int32)
    else:
        ids = np.asarray(ids, dtype=np.int32)
    order = np.argsort([len(s) for s in seqs], kind="stable") if length_sorted else np.arange(n)
    batches = []
    for off in range(0, n, batch_size):
        sel = order[off : off + batch_size]
        maxlen = max(len(seqs[i]) for i in sel)
        if pow2_lengths:
            pad = next_pow2(max(maxlen, pad_to))
        else:
            pad = round_up(max(maxlen, pad_to), pad_to)
        rows = batch_size if pad_batch else len(sel)
        codes = np.full((rows, pad), 4, dtype=np.uint8)
        lengths = np.zeros(rows, dtype=np.int32)
        out_ids = np.full(rows, -1, dtype=np.int32)
        for row, i in enumerate(sel):
            c = encode_seq(seqs[i])
            codes[row, : len(c)] = c
            lengths[row] = len(c)
            out_ids[row] = ids[i]
        batches.append(ReadBatch(codes=codes, lengths=lengths, ids=out_ids))
    return batches
