"""The chain DP splits at (rid, strand) runs: the premise of the run-per-warp kernel.

* Run independence: each run of a row, walked alone by
  ``chain_dp_skip_plain`` left-aligned in a row of its own and scattered
  back, gives what the whole-row walk gives, bit for bit, for ``f``,
  ``broke``, ``cnt``, ``start`` and ``rmf`` at W = 16, 32, 64 and 128,
  on a random corpus, on a colinear corpus whose runs fire the skip
  break, and on the edges of the kernel's 32-slot chunks (one run as
  long as the row, one-anchor runs, runs of 31, 32 and 33 anchors that
  start on and just before a chunk's edge, an empty row); and the span
  variant (``spans=True``: ``f``, ``broke``, ``cnt``) on colinear runs
  whose anchors carry spans of 19-60, packed into ``qpos``.  (The
  outputs are shift-invariant: the marked set uses only ``(i - 1) -
  ring_p``.)

Integer outputs throughout: tolerance 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny per-op work: intra-op threads only contend with the other workers
torch.set_num_threads(1)

from lrge_tpu_torch.ops.chain_kernel import NEG, chain_dp_skip_plain
from lrge_tpu_torch.platform import AVA_ONT

KW = dict(span=15, max_gap=AVA_ONT.max_gap, bw=AVA_ONT.bw, max_skip=25)
IMAX = np.iinfo(np.int32).max
OUTS = ("f", "broke", "cnt", "start", "rmf")


def runs_of(key2, nvalid):
    """``(row, start, length)`` of every key2 run over ``[0, nvalid)``,
    row-major, by a plain loop."""
    out = []
    B, A = key2.shape
    for b in range(B):
        n = min(max(int(nvalid[b]), 0), A)
        s = 0
        for i in range(1, n + 1):
            if i == n or key2[b, i] != key2[b, i - 1]:
                out.append((b, s, i - s))
                s = i
    return out


def random_rows(rng, B, A):
    """Rows of 1-12 rids x 2 strands, sorted by (key2, rpos), a few
    anchors invalid inside the valid prefix."""
    key2 = np.full((B, A), IMAX, np.int32)
    rpos, qpos, valid = (np.zeros((B, A), np.int32) for _ in range(3))
    for b in range(B):
        n = int(rng.integers(1, A + 1))
        rid = np.sort(rng.integers(0, int(rng.integers(1, 13)), n))
        st, rp, qp = rng.integers(0, 2, n), rng.integers(0, 3000, n), rng.integers(0, 3000, n)
        o = np.lexsort((rp, st, rid))
        key2[b, :n], rpos[b, :n], qpos[b, :n] = (rid * 2 + st)[o], rp[o], qp[o]
        valid[b, :n] = rng.random(n) > 0.05
    return key2, rpos, qpos, valid


def colinear_rows(rng, B, A):
    """Rows of colinear runs (one chain each, 3-bp steps with jitter),
    some long enough to fire the skip break at W >= 64, with lone
    anchors between them."""
    key2 = np.full((B, A), IMAX, np.int32)
    rpos, qpos, valid = (np.zeros((B, A), np.int32) for _ in range(3))
    for b in range(B):
        at, k = 0, int(rng.integers(0, 4))
        while at < A:
            n = min(A - at, int(rng.choice([1, 1, 5, 40, 150])))
            base = np.arange(n) * 3
            rp = np.sort(base + rng.integers(0, 40, n))
            key2[b, at : at + n], rpos[b, at : at + n] = k, rp
            qpos[b, at : at + n] = base + rng.integers(0, 40, n)
            valid[b, at : at + n] = 1
            at, k = at + n, k + int(rng.integers(1, 3))
        cut = int(rng.integers(A // 2, A + 1))
        key2[b, cut:], valid[b, cut:] = IMAX, 0
    return key2, rpos, qpos, valid


def chunk_edge_rows(rng, B, A):
    """Row 0 is one colinear run as long as the row; row 1 is one-anchor
    runs; rows 2.. hold colinear runs of 31, 32, 33 and 1 anchors in
    turn, so runs start on a 32-slot chunk's edge, just before it and
    inside it; the last row is empty."""
    key2 = np.full((B, A), IMAX, np.int32)
    base = np.arange(A) * 3
    rpos = (base + rng.integers(0, 40, (B, A))).astype(np.int32)
    qpos = (base + rng.integers(0, 40, (B, A))).astype(np.int32)
    rpos.sort(axis=1)
    valid = np.ones((B, A), np.int32)
    key2[0] = 0
    key2[1] = np.arange(A)
    lens = np.tile([31, 32, 33, 1], A)
    for b in range(2, B - 1):
        key2[b] = np.repeat(np.arange(len(lens)), lens)[b - 2 : b - 2 + A]
    valid[-1] = 0
    return key2, rpos, qpos, valid


def span_rows(rng, B, A):
    """:func:`colinear_rows` whose anchors carry their own span (19-60,
    the PacBio/HPC range), packed as ``qpos << 8 | span``."""
    key2, rpos, qpos, valid = colinear_rows(rng, B, A)
    return key2, rpos, (qpos << 8) | rng.integers(19, 61, (B, A)).astype(np.int32), valid


CORPORA = {"random": random_rows, "colinear": colinear_rows, "chunk_edges": chunk_edge_rows, "spans": span_rows}


def variant(corpus):
    """The chain DP's keywords and outputs for a corpus: the span variant
    for the span corpus, the extent variant (which holds the main one's
    f and broke) for the others."""
    if corpus == "spans":
        return dict(spans=True), OUTS[:3]
    return dict(extents=True), OUTS


@pytest.mark.parametrize("corpus", list(CORPORA))
@pytest.mark.parametrize("window", [16, 32, 64, 128])
def test_runs_walked_alone_equal_the_row_walk(corpus, window):
    rng = np.random.default_rng(window + 1000 * list(CORPORA).index(corpus))
    B, A = 10, 240
    key2, rpos, qpos, valid = CORPORA[corpus](rng, B, A)
    nvalid = (key2 != IMAX).sum(axis=1).astype(np.int32)
    t = torch.from_numpy
    mode, outs = variant(corpus)
    kw = dict(KW, window=window, **mode)
    whole = chain_dp_skip_plain(t(key2), t(rpos), t(qpos), t(valid), t(nvalid), AVA_ONT.chn_pen_gap(), **kw)

    runs = runs_of(key2, nvalid)
    Lmax = max(n for _, _, n in runs)
    R = len(runs)
    cut = [np.full((R, Lmax), IMAX, np.int32)] + [np.zeros((R, Lmax), np.int32) for _ in range(3)]
    for r, (b, s, n) in enumerate(runs):
        for dst, src in zip(cut, (key2, rpos, qpos, valid)):
            dst[r, :n] = src[b, s : s + n]
    lens = np.array([n for _, _, n in runs], np.int32)
    alone = chain_dp_skip_plain(*map(t, cut), t(lens), AVA_ONT.chn_pen_gap(), **kw)

    assert len(whole) == len(outs)
    for name, w, a in zip(outs, whole, alone):
        back = np.full((B, A), NEG if name == "f" else 0, np.int32)
        for r, (b, s, n) in enumerate(runs):
            back[b, s : s + n] = a[r, :n].numpy()
        np.testing.assert_array_equal(back, w.numpy(), err_msg=name)
    # the corpus reaches what the test is about: lone anchors, and runs
    # deeper than the ring (colinear) or than one warp's lanes
    assert sum(n == 1 for *_, n in runs) > 0
    assert Lmax > (32 if corpus == "random" else window)
    assert (whole[2] > 1).any()
    if corpus != "random" and window >= 64:
        assert whole[1].any(), "the colinear runs must fire the skip break"


@pytest.mark.gpu
@pytest.mark.parametrize("corpus", list(CORPORA))
@pytest.mark.parametrize("window", [16, 32, 64, 128])
def test_cuda_kernel_on_these_runs_matches_plain(corpus, window):
    # the kernel finds the runs itself, in 32-slot chunks: each variant
    # against the plain row walk on the corpora above (the span variant
    # on the span corpus)
    from lrge_tpu_torch.ops.chain_kernel import chain_dp_skip
    from lrge_tpu_torch.ops.cuda_lib import LAUNCHES

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(window + 1000 * list(CORPORA).index(corpus))
    rows = CORPORA[corpus](rng, 10, 240)
    nvalid = (rows[0] != IMAX).sum(axis=1).astype(np.int32)
    args = [torch.from_numpy(a) for a in (*rows, nvalid)]
    modes = [variant(corpus)[0]] if corpus == "spans" else [{}, dict(extents=True)]
    for mode in modes:
        kw = dict(KW, window=window, **mode)
        before = LAUNCHES.span_launches
        got = chain_dp_skip(*[a.cuda() for a in args], AVA_ONT.chn_pen_gap(), **kw)
        torch.cuda.synchronize()
        assert LAUNCHES.span_launches == before + bool(mode.get("spans"))
        want = chain_dp_skip_plain(*args, AVA_ONT.chn_pen_gap(), **kw)
        assert len(got) == len(want)
        for name, g, w in zip(OUTS, got, want):
            assert torch.equal(g.cpu(), w), (name, mode)
