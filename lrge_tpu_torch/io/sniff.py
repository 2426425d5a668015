"""Compression and content sniffing for sequence files.

Behavior mirrors `liblrge/src/io.rs:35-117`:

1. magic-byte compression detection on the raw file
   (gzip ``1f 8b``, bzip2 ``42 5a``, zstd ``28 b5 2f fd``,
   xz ``fd 37 7a 58 5a``);
2. content sniffing on the *decompressed* stream
   (``BAM\\x01``, ``CRAM``, ``@HD``/``@SQ``/``@RG`` -> alignment
   formats; anything else -> FASTA/FASTQ).
"""

from __future__ import annotations

import bz2
import enum
import gzip
import io as _pyio
import lzma
import os
from typing import BinaryIO

try:  # zstandard is optional, mirroring the reference's cargo feature gate
    import zstandard as _zstd
except Exception:  # pragma: no cover
    _zstd = None


class CompressionFormat(enum.Enum):
    NONE = "none"
    GZIP = "gzip"
    BZIP2 = "bzip2"
    ZSTD = "zstd"
    XZ = "xz"


def detect_compression_format(reader: BinaryIO) -> CompressionFormat:
    """Detect compression from the first bytes; restores stream position."""
    pos = reader.tell()
    reader.seek(0)
    magic = reader.read(5)
    reader.seek(pos)
    if magic[:2] == b"\x1f\x8b":
        return CompressionFormat.GZIP
    if magic[:2] == b"BZ":
        return CompressionFormat.BZIP2
    if magic[:4] == b"\x28\xb5\x2f\xfd":
        return CompressionFormat.ZSTD
    if magic[:5] == b"\xfd7zXZ":
        return CompressionFormat.XZ
    return CompressionFormat.NONE


class ContentFormat(enum.Enum):
    FASTX = "fastx"
    BAM = "bam"
    CRAM = "cram"
    SAM = "sam"


def sniff_content(head: bytes) -> ContentFormat:
    """Classify the decompressed stream (`io.rs:92-96`)."""
    if head.startswith(b"BAM\x01"):
        return ContentFormat.BAM
    if head.startswith(b"CRAM"):
        return ContentFormat.CRAM
    if head.startswith(b"@HD") or head.startswith(b"@SQ") or head.startswith(b"@RG"):
        return ContentFormat.SAM
    return ContentFormat.FASTX


def open_decompressed(path: os.PathLike | str) -> BinaryIO:
    """Open ``path``, transparently decompressing by magic bytes.

    gzip handles multi-member streams (BGZF-compressed BAM included).
    """
    raw = open(path, "rb")
    fmt = detect_compression_format(raw)
    if fmt is CompressionFormat.GZIP:
        return _pyio.BufferedReader(gzip.GzipFile(fileobj=raw), 1 << 20)
    if fmt is CompressionFormat.BZIP2:
        return _pyio.BufferedReader(bz2.BZ2File(raw), 1 << 20)
    if fmt is CompressionFormat.XZ:
        return _pyio.BufferedReader(lzma.LZMAFile(raw), 1 << 20)
    if fmt is CompressionFormat.ZSTD:
        if _zstd is None:  # pragma: no cover
            raise ImportError("zstandard module not available for .zst input")
        return _pyio.BufferedReader(_zstd.ZstdDecompressor().stream_reader(raw), 1 << 20)
    return _pyio.BufferedReader(raw, 1 << 20) if not isinstance(raw, _pyio.BufferedReader) else raw
