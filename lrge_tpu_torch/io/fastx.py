"""FASTA/FASTQ parsing.

Yields ``(header, seq)`` byte pairs.  Matches the needletail behavior the
reference relies on (`liblrge/src/io.rs:121-184`): format auto-detection
by leading ``>``/``@``, multi-line FASTA, 4-line FASTQ, and parse errors
for malformed input.
"""

from __future__ import annotations

from typing import BinaryIO, Iterator, Tuple

from ..errors import FastqParseError

Record = Tuple[bytes, bytes]


def parse_fastx(stream: BinaryIO) -> Iterator[Record]:
    """Parse a decompressed FASTA or FASTQ stream."""
    first = stream.read(1)
    if not first:
        return
    if first == b">":
        yield from _parse_fasta(stream)
    elif first == b"@":
        yield from _parse_fastq(stream)
    else:
        raise FastqParseError(
            f"Unknown sequence format: file does not start with '>' or '@' (got {first!r})"
        )


def _parse_fasta(stream: BinaryIO) -> Iterator[Record]:
    # The leading '>' has been consumed by the caller.
    header = stream.readline().rstrip(b"\r\n")
    chunks: list[bytes] = []
    for line in stream:
        if line.startswith(b">"):
            yield header, b"".join(chunks)
            header = line[1:].rstrip(b"\r\n")
            chunks = []
        else:
            chunks.append(line.rstrip(b"\r\n"))
    yield header, b"".join(chunks)


def _parse_fastq(stream: BinaryIO) -> Iterator[Record]:
    # The leading '@' has been consumed by the caller.
    header = stream.readline().rstrip(b"\r\n")
    recno = 0
    while True:
        seq = stream.readline()
        if not seq:
            raise FastqParseError(f"Truncated FASTQ record {recno}: missing sequence line")
        plus = stream.readline()
        if not plus.startswith(b"+"):
            raise FastqParseError(
                f"Malformed FASTQ record {recno}: expected '+' separator, got {plus[:20]!r}"
            )
        qual = stream.readline()
        if not qual:
            raise FastqParseError(f"Truncated FASTQ record {recno}: missing quality line")
        seq = seq.rstrip(b"\r\n")
        if len(qual.rstrip(b"\r\n")) != len(seq):
            raise FastqParseError(
                f"Malformed FASTQ record {recno}: sequence/quality length mismatch"
            )
        yield header, seq
        recno += 1
        nxt = stream.readline()
        if not nxt:
            return
        if not nxt.startswith(b"@"):
            raise FastqParseError(
                f"Malformed FASTQ record {recno}: expected '@' header, got {nxt[:20]!r}"
            )
        header = nxt[1:].rstrip(b"\r\n")


_ASCII_WS = b" \t\n\x0c\r"  # Rust u8::is_ascii_whitespace set


def read_id_from_header(header: bytes) -> bytes:
    """Truncate a FASTX header at the first ASCII whitespace.

    Mirrors ``FastqRecordExt::read_id`` (`io.rs:196-205`), which splits on
    Rust's ``is_ascii_whitespace`` (space, tab, LF, FF, CR) — notably
    including tabs inside ONT headers.
    """
    cut = len(header)
    for ws in _ASCII_WS:
        idx = header.find(ws)
        if idx != -1 and idx < cut:
            cut = idx
    return header[:cut]
