"""Batched minimizer sketch (ONT preset, PyTorch).

Port of ``lrge_tpu/ops/sketch_jax.py``: ``hash32`` (:31) and
``sketch_core`` (:44), the same window-min cover rule with the
first-window amendment and the final-window push, vectorised over a
padded ``[B, L]`` batch.  Hashes ride in int64 (masked to ``2k`` bits)
because PyTorch's uint32 lacks shifts, adds and comparisons on the CPU;
``0xFFFFFFFF`` stays the padding value.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

INF = 0xFFFFFFFF


def hash32(key: torch.Tensor, mask: int) -> torch.Tensor:
    """minimap2 hash64 restricted to a <=32-bit mask (exact), on int64."""
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & mask  # * 265
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & mask  # * 21
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def _shift_right(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """``x[:, i - d]`` with ``fill`` for ``i < d`` (the reference's jnp.pad)."""
    if d == 0:
        return x
    return F.pad(x[:, : x.shape[1] - d], (d, 0), value=fill)


def _shift_left(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """``x[:, i + d]`` with ``fill`` past the end."""
    if d == 0:
        return x
    return F.pad(x[:, d:], (0, d), value=fill)


def _first_argmin(x: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum along dim 1 (jnp.argmin's tie rule)."""
    cols = torch.arange(x.shape[1], device=x.device)
    hit = x == x.min(dim=1, keepdim=True).values
    return torch.where(hit, cols, x.shape[1]).min(dim=1).values


def sketch_core(codes: torch.Tensor, lengths: torch.Tensor, *, k: int, w: int, max_minimizers: int):
    """Sketch a padded batch (``codes`` [B, L] uint8, 4 = ambiguous/padding).

    Returns ``(mhash [B,M] int64, mpos [B,M] int64, mstrand [B,M] int64,
    mcount [B] int64)`` with ``0xFFFFFFFF`` hash padding; ``mcount`` is
    the raw (uncapped) minimizer count.
    """
    if 2 * k > 32:
        raise ValueError("the 32-bit sketch needs 2k <= 32")
    B, L = codes.shape
    dev = codes.device
    mask = (1 << (2 * k)) - 1
    c = codes.long()
    ambig = c >= 4
    csafe = torch.where(ambig, 0, c)
    lengths = lengths.long()

    fwd = torch.zeros((B, L), dtype=torch.int64, device=dev)
    rev = torch.zeros((B, L), dtype=torch.int64, device=dev)
    for j in range(k):
        shifted = _shift_right(csafe, j, 0)
        fwd = fwd | (shifted << (2 * j))
        rev = rev | ((3 ^ shifted) << (2 * (k - 1 - j)))
    fwd = fwd & mask
    rev = rev & mask

    cols = torch.arange(L, device=dev)
    okc = torch.cumsum((~ambig).long(), dim=1)
    valid = (okc - _shift_right(okc, k, 0)) == k
    valid = valid & (cols >= k - 1) & (fwd != rev)
    valid = valid & (cols[None, :] < lengths[:, None])

    strand = (fwd >= rev).long()
    x = hash32(torch.minimum(fwd, rev), mask)
    xm = torch.where(valid, x, INF)

    wmin = xm
    for d in range(1, w):
        wmin = torch.minimum(wmin, _shift_right(xm, d, INF))
    vcum = torch.cumsum(valid.long(), dim=1)
    gated = ((vcum - _shift_right(vcum, w, 0)) == w) & (cols >= w + k - 2)

    sel = torch.zeros((B, L), dtype=torch.bool, device=dev)
    for d in range(w):
        g = _shift_left(gated, d, False)
        m = _shift_left(wmin, d, 0)
        sel = sel | (g & (m == xm) & valid)

    # first-window amendment: ties of the prefix minimum are pushed and
    # the held minimum drops when the window-closing k-mer ties it
    e0 = w + k - 2
    if L > e0 and w >= 2:
        prefix = xm[:, k - 1 : e0]  # [B, w-1]
        pmin = prefix.min(dim=1).values
        held_rel = (w - 2) - _first_argmin(prefix.flip(1))
        ok = (pmin != INF) & (lengths >= w + k - 1)
        win = xm[:, k - 1 : e0 + 1]  # [B, w]
        wcols = torch.arange(w, device=dev)
        add = (win == pmin[:, None]) & ok[:, None] & (wcols[None, :] != held_rel[:, None])
        sel[:, k - 1 : e0 + 1] |= add
        closing_tie = (xm[:, e0] == pmin) & ok
        held_mask = cols[None, :] == (k - 1 + held_rel)[:, None]
        sel = sel & ~(held_mask & closing_tie[:, None])

    # final-window push: latest minimum over positions [n-w, n-1]
    tail_idx = (lengths[:, None] - w + torch.arange(w, device=dev)[None, :]).clamp(min=0)
    tail_x = xm.gather(1, tail_idx)
    arg_rev = _first_argmin(tail_x.flip(1))
    tie_pos = tail_idx.gather(1, (w - 1 - arg_rev)[:, None])[:, 0]
    tie_val = xm.gather(1, tie_pos[:, None])[:, 0]
    sel = sel | ((cols[None, :] == tie_pos[:, None]) & (tie_val != INF)[:, None])

    # compact selected positions to the front; the keys are distinct, so
    # the stable sort is a permutation
    M = max_minimizers
    mcount = sel.sum(dim=1)
    ckey = torch.where(sel, cols, cols + L)
    ckey_s, order = torch.sort(ckey, dim=1, stable=True)
    xs = torch.where(sel, (x << 1) | strand, INF).gather(1, order)
    ckey_s = ckey_s[:, :M]
    keep = ckey_s < L
    mhash = torch.where(keep, xs[:, :M] >> 1, INF)
    mpos = torch.where(keep, ckey_s, 0)
    mstrand = torch.where(keep, xs[:, :M] & 1, 0)
    return mhash, mpos, mstrand, mcount
