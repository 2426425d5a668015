"""Human formatting and temp-dir helpers (reference: `lrge/src/utils.rs`)."""

from __future__ import annotations

import math
import os
import tempfile
from pathlib import Path
from typing import Optional


def format_estimate(estimate: float) -> str:
    """Format a base-pair count with metric units, `utils.rs:19-49`.

    Uses f32-style thresholds (>= 10^(3p)) and two decimal places;
    infinity renders as ``∞ bp``.
    """
    if math.isinf(estimate):
        return "∞ bp"
    import numpy as np

    est = np.float32(estimate)  # the reference estimate is f32 end-to-end
    units = [("bp", 0), ("kbp", 1), ("Mbp", 2), ("Gbp", 3), ("Tbp", 4), ("Pbp", 5)]
    value = est
    suffix = "bp"
    for unit, power in units:
        threshold = np.float32(10.0 ** (power * 3))
        if est >= threshold:
            value = np.float32(est / threshold)
            suffix = unit
        else:
            break
    return f"{float(value):.2f} {suffix}"


class TempDir:
    """A temp dir that is removed on close unless ``keep`` was set.

    Mirrors `utils.rs:4-17` (prefix ``lrge-``, ``disable_cleanup(keep)``).
    """

    def __init__(self, path: Path, keep: bool):
        self.path = path
        self.keep = keep
        self._closed = False

    def cleanup(self) -> None:
        if self._closed:
            return
        self._closed = True
        if not self.keep:
            import shutil

            shutil.rmtree(self.path, ignore_errors=True)

    def __enter__(self) -> "TempDir":
        return self

    def __exit__(self, *exc) -> None:
        self.cleanup()


def create_temp_dir(temp_dir: Optional[os.PathLike | str] = None, keep: bool = False) -> TempDir:
    """Create a ``lrge-`` prefixed temporary directory, `utils.rs:4-17`."""
    if temp_dir is not None:
        base = Path(temp_dir)
        base.mkdir(parents=True, exist_ok=True)
        path = Path(tempfile.mkdtemp(prefix="lrge-", dir=base))
    else:
        path = Path(tempfile.mkdtemp(prefix="lrge-"))
    return TempDir(path, keep)
