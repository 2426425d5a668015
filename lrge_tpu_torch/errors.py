"""Error types for lrge_tpu.

Mirrors the error surface of the reference implementation
(`liblrge/src/error.rs:6-33`): every error condition a library user can
observe there has a counterpart here, so code ported from the reference's
API can catch equivalent exceptions.
"""

from __future__ import annotations


class LrgeError(Exception):
    """Base class for all lrge_tpu errors."""


class IoError(LrgeError):
    """An IO error occurred."""


class FastqParseError(LrgeError):
    """A FASTA/FASTQ parsing error occurred."""


class TooManyReadsError(LrgeError):
    """More reads present than supported (> u32::MAX in the reference)."""


class TooFewReadsError(LrgeError):
    """Fewer reads present than required for the requested strategy."""


class InvalidPlatformError(LrgeError):
    """Invalid platform string (reference: `InvalidPlatform`)."""


class ThreadError(LrgeError):
    """Error relating to worker management."""


class PafWriteError(LrgeError):
    """Error writing PAF file."""


class MapError(LrgeError):
    """Error mapping a read."""


class DuplicateReadIdentifierError(LrgeError):
    """Duplicate read identifiers found (reference: `DuplicateReadIdentifier`)."""
