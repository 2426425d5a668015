"""Native host runtime loader.

Builds (once per source hash, into ``lrge_tpu_torch/_build/``) and loads
the ``_lrge_torch_native`` C++ extension, a copy of ``lrge_tpu``'s
``_lrge_native`` under its own module name.  It is loaded by path and
never through ``sys.path``, so a process that also holds ``lrge_tpu``'s
extension gets each package its own build.  Import is best-effort:
everything has a pure-Python fallback, so a missing compiler only costs
speed (``LRGE_NO_NATIVE=1`` disables the extension).
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.util
import logging
import os
import subprocess
import sysconfig
from pathlib import Path

from ..spans import span

logger = logging.getLogger("lrge")

MODULE = "_lrge_torch_native"
_SRC = Path(__file__).resolve().parent / "lrge_native.cpp"
_BUILD = Path(__file__).resolve().parent.parent / "_build"


def _command(out: Path) -> list:
    inc = sysconfig.get_paths()["include"]
    return [
        os.environ.get("CXX", "g++"), "-O3", "-std=c++17", "-shared", "-fPIC",
        f"-I{inc}", str(_SRC), "-o", str(out),
    ]


def library_path() -> Path:
    """The extension's path in the build directory (named by the hash of
    its source and build command)."""
    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(_command(Path(MODULE))).encode()
    ).hexdigest()[:16]
    return _BUILD / f"{MODULE}-{digest}.so"


def _build(so: Path) -> bool:
    """Compile into ``so`` under a file lock (concurrent importers wait
    for one build); False when the compiler fails."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    with open(_BUILD / f"{MODULE}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return True
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        try:
            res = subprocess.run(_command(tmp), capture_output=True, text=True, timeout=240)
        except (OSError, subprocess.TimeoutExpired) as e:
            logger.debug("native build failed to launch: %s", e)
            return False
        if res.returncode != 0:
            logger.debug("native build failed: %s", res.stderr[-2000:])
            return False
        os.replace(tmp, so)
        return True


def _load():
    so = library_path()
    if not so.exists() and not _build(so):
        return None
    spec = importlib.util.spec_from_file_location(MODULE, so)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


native = None
if os.environ.get("LRGE_NO_NATIVE") != "1":
    try:
        with span("load", lib="native"):
            native = _load()
    except (OSError, ImportError) as e:  # pragma: no cover
        logger.debug("native extension unavailable: %s", e)
        native = None

HAVE_NATIVE = native is not None
