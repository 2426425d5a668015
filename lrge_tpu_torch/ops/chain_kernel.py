"""Chain DP with minimap2's ``max_chain_skip`` break: CUDA kernel and plain version.

Replaces the Pallas TPU kernel ``lrge_tpu/ops/chain_pallas.py::chain_dp_skip``
(body ``_chain_kernel``), which computes the same recurrence as the XLA
scan of ``lrge_tpu/ops/overlap_jax.py::_expand_sort_chain`` for constant
spans:

    f[i] = max(span, max_j f[j] + sc(i, j))

over the ``W`` newest predecessors ``j`` with the same ``key2``
(rid*2+strand), ``0 < dq, dr <= max_gap`` and ``|dr - dq| <= bw``;
``sc = min(dq, dr, span) - int(pen_gap*dd + 0.5*mg_log2(dd+1))``.  The
skip break is a Lindley counter over the "marked" predecessors (those
that are the stored predecessor of an examined anchor); ties go to the
nearest predecessor.  Outputs are ``f`` (NEG where invalid) and
``broke`` (the break fired inside the window).

What bounds it on an H100: the DP is a serial walk over a row's anchors
with tiny bytes per row (four int32 inputs and two outputs per anchor),
so it is latency bound: about 30 warp-shuffle rounds per anchor (three
dependent prefix scans, three reductions, the marked-set OR and the
ring push).  The design (``csrc/chain_dp.cu``) keeps the whole
predecessor ring in registers with one warp per row, so no anchor state
touches shared or device memory; each row stops at its own valid-anchor
count; anchors are loaded and results stored 32 at a time, coalesced,
and broadcast to the lanes with one shuffle.

On a CPU tensor the wrapper runs :func:`chain_dp_skip_plain`; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

NEG = int(np.iinfo(np.int32).min // 2)
IMAX = int(np.iinfo(np.int32).max)

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "chain_dp.cu"
_BUILD = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    # the score's f32 products and sums must round exactly like the
    # reference's unfused ops
    "-fmad=false",
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


def build_library() -> Path:
    """Compile ``csrc/chain_dp.cu`` (once per source hash) and return the .so path."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD / f"chain_dp-{digest}.so"
    if so.exists():
        return so
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    fn = lib.chain_dp_skip_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, I, I, ctypes.c_float, I, I, I, I, I, P, P, P]
    fn.restype = I
    return lib


def _check(name: str, x: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: expected device {device}, got {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def chain_dp_skip(
    key2: torch.Tensor,  # [B, A] int32, sorted by (key2, rpos); IMAX invalid
    rpos: torch.Tensor,  # [B, A] int32
    qpos: torch.Tensor,  # [B, A] int32
    valid: torch.Tensor,  # [B, A] int32 (0/1)
    nvalid: torch.Tensor,  # [B] int32: rows stop here
    pen_gap: float,
    *,
    span: int,
    max_gap: int,
    bw: int,
    max_skip: int = 25,
    window: int = 32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chain scores ``f`` and ``broke`` flags, both ``[B, A]`` int32."""
    B, A = key2.shape
    dev = key2.device
    _check("key2", key2, (B, A), dev)
    for name, x in (("rpos", rpos), ("qpos", qpos), ("valid", valid)):
        _check(name, x, (B, A), dev)
    _check("nvalid", nvalid, (B,), dev)
    if window not in (16, 32, 64, 128):
        raise ValueError(f"window must be 16, 32, 64 or 128, got {window}")
    kw = dict(span=span, max_gap=max_gap, bw=bw, max_skip=max_skip, window=window)
    if dev.type == "cpu":
        return chain_dp_skip_plain(key2, rpos, qpos, valid, nvalid, pen_gap, **kw)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    f = torch.empty((B, A), dtype=torch.int32, device=dev)
    broke = torch.empty((B, A), dtype=torch.int32, device=dev)
    if B == 0 or A == 0:
        return f, broke
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().chain_dp_skip_launch(
            key2.data_ptr(), rpos.data_ptr(), qpos.data_ptr(), valid.data_ptr(),
            nvalid.data_ptr(), B, A, float(np.float32(pen_gap)), span, max_gap, bw,
            max_skip, window, f.data_ptr(), broke.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"chain_dp_skip launch failed: CUDA error {err}")
    chain_dp_skip.launches += 1
    return f, broke


chain_dp_skip.launches = 0


def _mg_log2(x: torch.Tensor) -> torch.Tensor:
    """minimap2's fast f32 log2 (bit trick), op for op as the reference."""
    bits = x.to(torch.float32).view(torch.int32)
    log2 = ((bits >> 23) & 255).to(torch.float32) - 128.0
    bits = (bits & ~(255 << 23)) + (127 << 23)
    zf = bits.view(torch.float32)
    return log2 + (-0.34484843 * zf + 2.02466578) * zf - 0.67487759


def chain_dp_skip_plain(
    key2, rpos, qpos, valid, nvalid, pen_gap, *, span, max_gap, bw, max_skip=25, window=32,
):
    """Plain PyTorch version: one step per anchor slot over ``[B, W]``
    predecessor rings (newest first), mirroring the scan step of
    ``_expand_sort_chain`` (overlap_jax.py:663-788)."""
    B, A = key2.shape
    W = window
    dev = key2.device
    i64 = dict(dtype=torch.int64, device=dev)
    key2, rpos, qpos = key2.long(), rpos.long(), qpos.long()
    valid = valid != 0
    nvalid = nvalid.long()
    pen = torch.tensor(np.float32(pen_gap), dtype=torch.float32, device=dev)
    f = torch.full((B, A), NEG, **i64)
    broke = torch.zeros((B, A), **i64)
    ring_key = torch.full((B, W), IMAX, **i64)
    ring_rpos = torch.zeros((B, W), **i64)
    ring_qpos = torch.zeros((B, W), **i64)
    ring_f = torch.full((B, W), NEG, **i64)
    ring_ok = torch.zeros((B, W), dtype=torch.bool, device=dev)
    ring_p = torch.full((B, W), -1, **i64)
    dpos = torch.arange(W, **i64)[None, :]
    neg_col = torch.full((B, 1), NEG, **i64)
    false_col = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    n = min(int(nvalid.max()) if B else 0, A)
    for i in range(n):
        ck, cr, cq = key2[:, i : i + 1], rpos[:, i : i + 1], qpos[:, i : i + 1]
        cv = valid[:, i] & (i < nvalid)
        dq = cq - ring_qpos
        dr = cr - ring_rpos
        dd = (dr - dq).abs()
        dg = torch.minimum(dq, dr)
        sc = dg.clamp(max=span)
        lin = pen * dd.to(torch.float32)
        logp = torch.where(dd >= 1, _mg_log2((dd + 1).to(torch.float32)), 0.0)
        pen_i = (lin + 0.5 * logp).to(torch.int64)
        sc = torch.where((dd != 0) | (dg > span), sc - pen_i, sc)
        ok = (
            ring_ok & (ring_key == ck) & (dq > 0) & (dq <= max_gap)
            & (dr > 0) & (dr <= max_gap) & (dd <= bw)
        )
        cand = torch.where(ok, sc + ring_f, NEG)
        # marked[d]: some ok position d' stores the slot at position d as
        # its predecessor (p_rel[d'] == d).  The reference OR-reduces
        # bit-packed one-hot votes; a scatter of True into column p_rel
        # (out-of-window links into a spill column) sets the same bits.
        p_rel = (i - 1) - ring_p
        tgt = torch.where(ok & (p_rel >= 0) & (p_rel < W), p_rel, W)
        marked = torch.zeros((B, W + 1), dtype=torch.bool, device=dev)
        marked.scatter_(1, tgt, True)
        marked = marked[:, :W]
        cmax = torch.cummax(cand, dim=1).values
        runmax_excl = torch.cat([neg_col, cmax[:, :-1]], dim=1).clamp(min=span)
        improving = ok & (cand > runmax_excl)
        a_step = (ok & marked & ~improving).long() - improving.long()
        s_cum = torch.cumsum(a_step, dim=1)
        runmin = torch.cummin(s_cum, dim=1).values.clamp(max=0)
        over = (s_cum - runmin) > max_skip
        overed = torch.cummax(over.long(), dim=1).values != 0
        broken_before = torch.cat([false_col, overed[:, :-1]], dim=1)
        cand = torch.where(broken_before, NEG, cand)
        best = cand.max(dim=1).values
        bestd = torch.where(cand == best[:, None], dpos, W).min(dim=1).values
        has_pred = best > span
        p_t = torch.where(cv & has_pred, i - 1 - bestd, -1)
        f_t = torch.where(cv, best.clamp(min=span), NEG)
        f[:, i] = f_t
        broke[:, i] = (overed[:, -1] & cv).long()
        push = lambda new, ring: torch.cat([new[:, None], ring[:, : W - 1]], dim=1)
        ring_key = push(ck[:, 0], ring_key)
        ring_rpos = push(cr[:, 0], ring_rpos)
        ring_qpos = push(cq[:, 0], ring_qpos)
        ring_f = push(f_t, ring_f)
        ring_ok = push(cv, ring_ok)
        ring_p = push(p_t, ring_p)
    return f.to(torch.int32), broke.to(torch.int32)
