"""The port's one library of hand-written CUDA kernels: build, load, checks and launch counters.

``csrc/chain_dp.cu`` (the chain DP, ``ops/chain_kernel.py``) and
``csrc/sketch_hpc.cu`` (the PacBio/HPC query sketch,
``ops/sketch_torch.py::sketch_hpc``) compile in one ``nvcc`` invocation
into ``_build/kernels-<hash>.so``, once per hash of the sources and
flags, and load once with ``ctypes`` (:func:`load`).  Each wrapper module
binds the argument types of its own entry points.

:data:`LAUNCHES` counts the kernels launched on the card, one counter a
kernel variant (:data:`COUNTERS`).  Inside a CUDA graph
(``ops/program.py``) a wrapper runs once, at capture, and the graph's
replays launch its kernels: :func:`recorded_launches` and
:func:`add_launches` keep the counters meaning launches on the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import torch

from ..spans import span

_PKG = Path(__file__).resolve().parent.parent
_SRCS = (_PKG / "csrc" / "chain_dp.cu", _PKG / "csrc" / "sketch_hpc.cu")
_BUILD = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    # the chain score's f32 products and sums must round exactly like the
    # reference's unfused ops
    "-fmad=false",
    # registers, stack and spill of each instance, kept beside the library
    "-Xptxas", "-v",
)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path() -> Path:
    """Where :func:`build_library` puts the library of these sources and flags."""
    digest = hashlib.sha256(b"".join(src.read_bytes() for src in _SRCS) + " ".join(NVCC_FLAGS).encode())
    return _BUILD / f"kernels-{digest.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile ``csrc/chain_dp.cu`` and ``csrc/sketch_hpc.cu`` into one
    library (once per sources' hash) and return the .so path."""
    so = library_path()
    if so.exists():
        return so
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _SRCS)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
    so.with_suffix(".ptxas.txt").write_text(res.stdout + res.stderr)
    os.replace(tmp, so)
    return so


# the chain DP's variants, by their template index in csrc/chain_dp.cu
VARIANTS = ("base", "ext", "span")


def ptxas_report(so: Path) -> list[str]:
    """One line per kernel instance from the build's ``-Xptxas -v``
    output: ``W=32 span: 40 registers, 0 B stack, 0 B spill stores,
    0 B spill loads`` (``find_runs span: ...`` for the chain DP's run
    finder, ``sketch_hpc: ...`` for the PacBio/HPC sketch)."""
    text = so.with_suffix(".ptxas.txt").read_text()
    out, name, frame = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '\S*chain_dp_kernelILi(\d+)ELi(\d)E", line)
        if m:
            name = f"W={m.group(1)} {VARIANTS[int(m.group(2))]}"
        m = re.search(r"Compiling entry function '\S*find_runs_kernelILi(\d)E", line)
        if m:
            name = f"find_runs {VARIANTS[int(m.group(1))]}"
        if re.search(r"Compiling entry function '\S*sketch_hpc_kernel", line):
            name = "sketch_hpc"
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            frame = f"{m.group(1)} B stack, {m.group(2)} B spill stores, {m.group(3)} B spill loads"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {frame}")
            name, frame = None, ""
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The library, built if need be and loaded once (the ``load`` span)."""
    with span("load", lib="kernels"):
        return ctypes.CDLL(str(build_library()))


def check_int32(name: str, x: torch.Tensor, shape: tuple, device: torch.device) -> None:
    """Raise unless ``x`` is a contiguous int32 tensor of ``shape`` on ``device``."""
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: expected device {device}, got {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


# kernel launches on the card, by variant: the chain DP's main path, its
# extent (-F) and span (PacBio/HPC) variants, and the PacBio/HPC sketch
LAUNCHES = SimpleNamespace(launches=0, ext_launches=0, span_launches=0, sketch_launches=0)
COUNTERS = tuple(vars(LAUNCHES))


def launch_counts(counters=LAUNCHES) -> dict:
    """The launch counters' values, by name."""
    return {c: getattr(counters, c) for c in COUNTERS}


def recorded_launches(capture, counters=LAUNCHES):
    """Call ``capture()``, a CUDA graph capture, and return ``(its result,
    the launches it recorded by counter)``.  The wrappers counted those
    launches, but a capture records kernels into the graph and runs none,
    so the counters are put back as they were; each replay adds them
    (:func:`add_launches`), because a replay does not run the wrappers."""
    before = launch_counts(counters)
    try:
        out = capture()
        recorded = {c: n - before[c] for c, n in launch_counts(counters).items()}
    finally:
        for c, n in before.items():
            setattr(counters, c, n)
    return out, recorded


def add_launches(recorded: dict, counters=LAUNCHES) -> None:
    """Add one replay's launches (:func:`recorded_launches`) to the counters."""
    for c, n in recorded.items():
        setattr(counters, c, getattr(counters, c) + n)
