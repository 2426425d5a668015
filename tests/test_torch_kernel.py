"""The chain DP wrapper and the CUDA kernel (no JAX: runs on the card too).

On the CPU: the wrapper's input checks and its per-row stop.  On a CUDA
card (marker ``gpu``; skipped without one): the kernel equals the plain
version bit for bit at every window, and the device engine's counts
equal the exact host engine's.  On the card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernel.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny per-op work: intra-op threads only contend with the other workers
torch.set_num_threads(1)

from lrge_tpu.engine import OverlapEngine
from lrge_tpu.ops.index import build_index
from lrge_tpu.platform import AVA_ONT, Platform, preset_for
from lrge_tpu_torch.device_engine import DeviceOverlapEngine
from lrge_tpu_torch.ops.chain_kernel import NEG, chain_dp_skip, chain_dp_skip_plain

KW = dict(span=15, max_gap=AVA_ONT.max_gap, bw=AVA_ONT.bw, max_skip=25)
IMAX = np.iinfo(np.int32).max


def anchor_rows(rng, B, A, *, colinear=False):
    """[B, A] int32 rows sorted by (key2, rpos) with a valid prefix."""
    key2 = np.full((B, A), IMAX, np.int32)
    rpos, qpos, valid = (np.zeros((B, A), np.int32) for _ in range(3))
    for b in range(B):
        n = int(rng.integers(A // 4, A))
        if colinear:
            base = np.arange(n) * 3
            rp = np.sort(base + rng.integers(0, 40, n))
            qp = base + rng.integers(0, 40, n)
            k = np.zeros(n, np.int64)
        else:
            rid = np.sort(rng.integers(0, 6, n))
            st, rp, qp = rng.integers(0, 2, n), rng.integers(0, 6000, n), rng.integers(0, 6000, n)
            o = np.lexsort((rp, st, rid))
            k, rp, qp = (rid * 2 + st)[o], rp[o], qp[o]
        key2[b, :n], rpos[b, :n], qpos[b, :n], valid[b, :n] = k, rp, qp, 1
    return [torch.from_numpy(a) for a in (key2, rpos, qpos, valid)]


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def test_rows_stop_at_their_own_count():
    # slots at or past a row's nvalid get (NEG, 0) even when marked valid
    args = anchor_rows(np.random.default_rng(3), 4, 64)
    full = args[3].sum(dim=1).to(torch.int32)
    f, broke = chain_dp_skip_plain(*args, full // 2, AVA_ONT.chn_pen_gap(), window=32, **KW)
    f_full, _ = chain_dp_skip_plain(*args, full, AVA_ONT.chn_pen_gap(), window=32, **KW)
    for b in range(4):
        n = int(full[b]) // 2
        assert (f[b, n:] == NEG).all() and (broke[b, n:] == 0).all()
        assert torch.equal(f[b, :n], f_full[b, :n])


@pytest.mark.parametrize(
    "bad,match",
    [
        (lambda a: a.__setitem__(0, a[0].long()), "int32"),
        (lambda a: a.__setitem__(1, a[1][:, :-1].contiguous()), "shape"),
        (lambda a: a.__setitem__(2, a[2].t().contiguous().t()), "contiguous"),
        (lambda a: a.__setitem__(4, a[4][:-1]), "shape"),
    ],
)
def test_wrapper_rejects_bad_inputs(bad, match):
    args = anchor_rows(np.random.default_rng(0), 8, 128)
    args.append(args[3].sum(dim=1).to(torch.int32))
    good = list(args)
    bad(args)
    with pytest.raises((TypeError, ValueError), match=match):
        chain_dp_skip(*args, AVA_ONT.chn_pen_gap(), window=32, **KW)
    with pytest.raises(ValueError, match="window"):
        chain_dp_skip(*good, AVA_ONT.chn_pen_gap(), window=48, **KW)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [16, 32, 64, 128])
def test_cuda_kernel_matches_plain(window):
    need_cuda()
    for seed, colinear in ((0, False), (7, True)):
        args = anchor_rows(np.random.default_rng(seed), 37, 300, colinear=colinear)
        args.append(args[3].sum(dim=1).to(torch.int32))
        before = chain_dp_skip.launches
        f, broke = chain_dp_skip(*[a.cuda() for a in args], AVA_ONT.chn_pen_gap(), window=window, **KW)
        torch.cuda.synchronize()
        assert chain_dp_skip.launches == before + 1
        f_ref, broke_ref = chain_dp_skip(*args, AVA_ONT.chn_pen_gap(), window=window, **KW)
        assert torch.equal(f.cpu(), f_ref) and torch.equal(broke.cpu(), broke_ref)
        if colinear and window >= 64:
            assert broke_ref.any(), "corpus must exercise the skip break"


@pytest.mark.gpu
def test_engine_on_card_matches_host():
    need_cuda()
    rng = np.random.default_rng(31337)
    genome = rng.choice(list(b"ACGT"), size=150_000).astype(np.uint8).tobytes()

    def reads(n, length):
        out = []
        for _ in range(n):
            pos = int(rng.integers(0, len(genome) - length))
            s = np.frombuffer(genome[pos : pos + length], np.uint8).copy()
            hit = rng.random(length) < 0.08
            s[hit] = rng.choice(list(b"ACGT"), size=int(hit.sum()))
            out.append(s.tobytes())
        return out

    targets, queries = reads(120, 2000), reads(40, 2500)
    tnames = [b"t%d" % i for i in range(120)]
    qnames = [b"q%d" % i for i in range(40)]
    index = build_index(targets, tnames, preset_for(Platform.NANOPORE, dual=True))
    dev = DeviceOverlapEngine(index, device=torch.device("cuda"), batch_size=16, length_buckets=(4096,))
    before = chain_dp_skip.launches
    res = dev.count_batch(qnames, queries)
    assert chain_dp_skip.launches > before
    host = OverlapEngine(index).count_overlaps_many(list(zip(qnames, queries)))
    np.testing.assert_array_equal(res.counts, [c for c, _ in host])
    np.testing.assert_array_equal(res.had_mapping, [bool(h) for _, h in host])
