"""The CUDA kernels' wrappers (imports only the port: runs on the card too).

On the CPU: the chain DP wrapper's input checks and its per-row stop,
the span variant's plain version at a constant span (it must be the
main one's, with the extent variant's ``cnt``), the PacBio/HPC sketch
wrapper's input checks, and the build report's parse of every kernel
instance.  On a CUDA card (marker ``gpu``; skipped without one): each
chain DP variant equals its plain version bit for bit at every window
and on rows of the largest bucket's length; the sketch kernel equals
its plain version on the edge reads and under every parameter set of
``ops/sketch_cases.py`` and on a super-batch of HiFi-like
reads filling the 16,384 bucket; the device engine's counts equal the
exact host engine's (ONT and PacBio, one sub-index and several, a
sharded index on the card twice, and a PacBio engine over
homopolymer-rich reads with ambiguous bases, its queries sketched on
the card once a super-batch); and the super-batch programs,
single-device and sharded, replay what their eager functions compute; a
capture that fails raises, naming its program.  On the card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernel.py
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny per-op work: intra-op threads only contend with the other workers
torch.set_num_threads(1)

from lrge_tpu_torch.device_engine import DeviceOverlapEngine
from lrge_tpu_torch.engine import OverlapEngine
from lrge_tpu_torch.ops.chain_kernel import NEG, chain_dp_skip, chain_dp_skip_plain
from lrge_tpu_torch.ops.cuda_lib import LAUNCHES, ptxas_report
from lrge_tpu_torch.ops.index import build_index
from lrge_tpu_torch.ops.overlap import minimizer_cap
from lrge_tpu_torch.ops.sketch_cases import HPC_PARAMS, hifi_reads, hpc_edge_reads, padded_codes
from lrge_tpu_torch.ops.sketch_torch import sketch_hpc, sketch_hpc_plain
from lrge_tpu_torch.platform import AVA_ONT, Platform, preset_for

KW = dict(span=15, max_gap=AVA_ONT.max_gap, bw=AVA_ONT.bw, max_skip=25)
IMAX = np.iinfo(np.int32).max
def hpc_planes(seqs, params, M, device=torch.device("cpu"), sketch=sketch_hpc):
    """``(qhi, qlo, mps, mcount)`` (numpy) of ``sketch`` over ``seqs``,
    padded to the longest read (code 4), on ``device``."""
    codes, lengths = padded_codes(seqs)
    out = sketch(torch.from_numpy(codes).to(device), torch.from_numpy(lengths).to(device), k=params.k,
                 w=params.w, hpc=params.hpc, max_minimizers=M)
    return tuple(x.cpu().numpy() for x in out)


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


def put_valley_row(args):
    """Row 0 becomes one chain that climbs for 200 anchors, then steps
    off the diagonal (dd = 400, score -42 a step) until f sits more than
    ``bw`` below its running max: the extent carries' valley bit."""
    n0, n1 = 200, 60
    rp = np.concatenate([15 * np.arange(n0), 15 * (n0 - 1) + 410 * np.arange(1, n1 + 1)]) + 7
    qp = np.concatenate([15 * np.arange(n0), 15 * (n0 - 1) + 10 * np.arange(1, n1 + 1)]) + 3
    key2, rpos, qpos, valid = args[:4]
    key2[0], rpos[0], qpos[0], valid[0] = IMAX, 0, 0, 0
    key2[0, : n0 + n1] = 0
    rpos[0, : n0 + n1] = torch.from_numpy(rp)
    qpos[0, : n0 + n1] = torch.from_numpy(qp)
    valid[0, : n0 + n1] = 1


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


def with_spans(args, rng, lo=19, hi=61):
    """The rows' ``qpos`` packed with per-anchor spans in ``[lo, hi)``."""
    out = list(args)
    out[2] = (args[2] << 8) | torch.from_numpy(rng.integers(lo, hi, tuple(args[2].shape)).astype(np.int32))
    return out


def test_plain_span_variant_at_constant_span_is_the_main_one():
    # every anchor at span k: f and broke of the main variant, cnt of the
    # extent variant
    for seed, colinear in ((0, False), (7, True)):
        args = anchor_rows(np.random.default_rng(seed), 12, 300, colinear=colinear)
        args.append(args[3].sum(dim=1).to(torch.int32))
        packed = with_spans(args, np.random.default_rng(0), KW["span"], KW["span"] + 1)
        f, broke, cnt = chain_dp_skip(*packed, AVA_ONT.chn_pen_gap(), window=64, spans=True, **KW)
        ext = chain_dp_skip(*args, AVA_ONT.chn_pen_gap(), window=64, extents=True, **KW)
        assert torch.equal(f, ext[0]) and torch.equal(broke, ext[1]) and torch.equal(cnt, ext[2])
        # spans that vary give other scores
        varied = chain_dp_skip(*with_spans(args, np.random.default_rng(1)), AVA_ONT.chn_pen_gap(), window=64,
                               spans=True, **KW)
        assert not torch.equal(varied[0], f)


def test_ptxas_report_names_every_instance(tmp_path):
    # the build's -Xptxas -v log, one instance of each kernel and variant
    lines = []
    for name in ("chain_dp_kernelILi32ELi0EEEvNS_4ArgsEPKyPKiS5_Pi", "chain_dp_kernelILi64ELi2EEEvNS_4ArgsE",
                 "find_runs_kernelILi1EEEvNS_4ArgsEPyPiS3_", "sketch_hpc_kernelEPKhPKiiiiiiPiS4_S4_S4_"):
        lines += [
            f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115{name}' for 'sm_90a'",
            "ptxas info    : Function properties for _ZN12_GLOBAL__N_1",
            "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads",
            "ptxas info    : Used 40 registers, used 0 barriers, 456 bytes cmem[0]",
        ]
    so = tmp_path / "kernels-x.so"
    so.with_suffix(".ptxas.txt").write_text("\n".join(lines))
    frame = "40 registers, 8 B stack, 4 B spill stores, 12 B spill loads"
    assert ptxas_report(so) == [f"W=32 base: {frame}", f"W=64 span: {frame}", f"find_runs ext: {frame}",
                                f"sketch_hpc: {frame}"]


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
    with pytest.raises(ValueError, match="constant-span"):
        chain_dp_skip(*good, AVA_ONT.chn_pen_gap(), window=32, extents=True, spans=True, **KW)


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(k=26), "k must be"), (dict(w=256), "w must be"), (dict(w=0), "w must be"),
        (dict(codes=torch.zeros((2, 8), dtype=torch.int32)), "uint8"),
        (dict(lengths=torch.zeros(2, dtype=torch.int64)), "int32"),
        (dict(lengths=torch.zeros(3, dtype=torch.int32)), "shape"),
    ],
)
def test_sketch_wrapper_rejects_bad_inputs(kw, match):
    args = dict(codes=torch.zeros((2, 8), dtype=torch.uint8), lengths=torch.full((2,), 8, dtype=torch.int32),
                k=19, w=5, hpc=True, max_minimizers=128)
    args.update(kw)
    with pytest.raises((TypeError, ValueError), match=match):
        sketch_hpc(**args)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(HPC_PARAMS))
def test_cuda_sketch_kernel_matches_plain(case):
    # the edge reads, at a capacity that the long reads overflow (their
    # true counts kept) and at the 2,048 bucket's
    need_cuda()
    k, w, hpc = HPC_PARAMS[case]
    params = SimpleNamespace(k=k, w=w, hpc=hpc)
    seqs = hpc_edge_reads(np.random.default_rng(7))
    for M in (64, minimizer_cap(2048)):
        before = LAUNCHES.sketch_launches
        got = hpc_planes(seqs, params, M, torch.device("cuda"))
        assert LAUNCHES.sketch_launches == before + 1
        want = hpc_planes(seqs, params, M)
        for g, w_, what in zip(got, want, ("qhi", "qlo", "mps", "mcount")):
            np.testing.assert_array_equal(g, w_, err_msg=f"{case} M={M} {what}")
    assert (want[3] > 64).any() and (want[3] == 0).any()


@pytest.mark.gpu
def test_cuda_sketch_kernel_full_bucket_matches_plain():
    # a super-batch of the 16,384 bucket as the PacBio path runs it: 128
    # HiFi-like rows, the preset's parameters
    need_cuda()
    params = preset_for(Platform.PACBIO, dual=True)
    seqs = hifi_reads(np.random.default_rng(16384), 128, 8193, 16384)
    M = minimizer_cap(16384)
    got = hpc_planes(seqs, params, M, torch.device("cuda"))
    want = hpc_planes(seqs, params, M, torch.device("cuda"), sketch=sketch_hpc_plain)
    for g, w_, what in zip(got, want, ("qhi", "qlo", "mps", "mcount")):
        np.testing.assert_array_equal(g, w_, err_msg=what)
    assert want[3].min() > 500 and (want[3] <= M).all()


@pytest.mark.gpu
def test_pacbio_engine_sketches_on_card_and_matches_host():
    # homopolymer-rich reads with ambiguous bases through a PacBio engine
    # on the card (CUDA graphs): the counts are the host engine's, the
    # sketch kernel runs once a super-batch, every live device row is a
    # pb_card_rows row, and no row goes to the host for its sketch
    need_cuda()
    from lrge_tpu_torch import spans

    rng = np.random.default_rng(4096)
    reads = hifi_reads(rng, 150, 1500, 3500, genome_len=120_000)
    for i in range(0, 150, 7):
        s = bytearray(reads[i])
        s[int(rng.integers(0, len(s)))] = ord("N")
        reads[i] = bytes(s)
    targets, queries = reads[:100], reads[100:]
    tnames = [b"t%d" % i for i in range(100)]
    qnames = [b"q%d" % i for i in range(50)]
    index = build_index(targets, tnames, preset_for(Platform.PACBIO, dual=True))
    dev = DeviceOverlapEngine(index, device=torch.device("cuda"), batch_size=8, length_buckets=(2048, 4096))
    assert dev.pb_mode and dev.graphs
    dev.warmup([len(q) for q in queries])
    before = LAUNCHES.sketch_launches
    res = dev.count_batch(qnames, queries)
    _, _, bucket_rows = dev.plan_rows(queries, range(len(queries)))
    n_super = sum(-(-len(r) // (8 * dev.bucket_shape(L)[1])) for L, r in bucket_rows.items() if r)
    assert LAUNCHES.sketch_launches - before == n_super
    assert spans.passes[-1].counters["pb_card_rows"] == sum(len(r) for r in bucket_rows.values())
    assert "sketch_quirk" not in dev.fallback_triggers
    host = OverlapEngine(index).count_overlaps_many(list(zip(qnames, queries)))
    np.testing.assert_array_equal(res.counts, [c for c, _ in host])
    np.testing.assert_array_equal(res.had_mapping, [bool(h) for _, h in host])
    assert (res.counts > 0).sum() > 25


@pytest.mark.gpu
@pytest.mark.parametrize("window", [16, 32, 64, 128])
def test_cuda_kernel_matches_plain(window):
    need_cuda()
    for seed, colinear in ((0, False), (7, True)):
        args = anchor_rows(np.random.default_rng(seed), 37, 300, colinear=colinear)
        args.append(args[3].sum(dim=1).to(torch.int32))
        before = LAUNCHES.launches
        f, broke = chain_dp_skip(*[a.cuda() for a in args], AVA_ONT.chn_pen_gap(), window=window, **KW)
        torch.cuda.synchronize()
        assert LAUNCHES.launches == before + 1
        f_ref, broke_ref = chain_dp_skip(*args, AVA_ONT.chn_pen_gap(), window=window, **KW)
        assert torch.equal(f.cpu(), f_ref) and torch.equal(broke.cpu(), broke_ref)
        if colinear and window >= 64:
            assert broke_ref.any(), "corpus must exercise the skip break"


@pytest.mark.gpu
@pytest.mark.parametrize("window", [16, 32, 64, 128])
def test_cuda_extent_kernel_matches_plain(window):
    need_cuda()
    for seed, colinear in ((0, False), (7, True)):
        args = anchor_rows(np.random.default_rng(seed), 37, 300, colinear=colinear)
        put_valley_row(args)
        args.append(args[3].sum(dim=1).to(torch.int32))
        before, before_main = LAUNCHES.ext_launches, LAUNCHES.launches
        got = chain_dp_skip(*[a.cuda() for a in args], AVA_ONT.chn_pen_gap(), window=window, extents=True, **KW)
        torch.cuda.synchronize()
        assert LAUNCHES.ext_launches == before + 1 and LAUNCHES.launches == before_main
        want = chain_dp_skip(*args, AVA_ONT.chn_pen_gap(), window=window, extents=True, **KW)
        for name, g, w in zip(("f", "broke", "cnt", "start", "rmf"), got, want):
            assert torch.equal(g.cpu(), w), name
        # the extent variant's f and broke are the main variant's
        f, broke = chain_dp_skip(*args, AVA_ONT.chn_pen_gap(), window=window, **KW)
        assert torch.equal(want[0], f) and torch.equal(want[1], broke)
        assert (want[2][1:] > 1).any(), "chains must grow past one anchor"
        assert (want[4][0] & 1).any(), "row 0 must carry a valley"


@pytest.mark.gpu
@pytest.mark.parametrize("window", [16, 32, 64, 128])
def test_cuda_span_kernel_matches_plain(window):
    need_cuda()
    for seed, colinear in ((0, False), (7, True)):
        args = anchor_rows(np.random.default_rng(seed), 37, 300, colinear=colinear)
        args.append(args[3].sum(dim=1).to(torch.int32))
        args = with_spans(args, np.random.default_rng(seed + 1))
        before = (LAUNCHES.span_launches, LAUNCHES.launches, LAUNCHES.ext_launches)
        got = chain_dp_skip(*[a.cuda() for a in args], AVA_ONT.chn_pen_gap(), window=window, spans=True, **KW)
        torch.cuda.synchronize()
        after = (LAUNCHES.span_launches, LAUNCHES.launches, LAUNCHES.ext_launches)
        assert after == (before[0] + 1, *before[1:])
        want = chain_dp_skip(*args, AVA_ONT.chn_pen_gap(), window=window, spans=True, **KW)
        for name, g, w in zip(("f", "broke", "cnt"), got, want):
            assert torch.equal(g.cpu(), w), name
        assert (want[2] > 1).any(), "chains must grow past one anchor"


def edge_run_rows(rng, B, A):
    """Row 0 is one run of length A (colinear, so the chain and the skip
    break reach deep); rows 1.. are runs of one anchor each (every key2
    distinct), with a short valid prefix on the last row."""
    base = np.arange(A) * 3
    key2 = np.zeros((B, A), np.int32)
    key2[1:] = np.arange(1, A + 1)
    rpos = (base + rng.integers(0, 40, (B, A))).astype(np.int32)
    rpos[0] = np.sort(rpos[0])
    qpos = (base + rng.integers(0, 40, (B, A))).astype(np.int32)
    valid = np.ones((B, A), np.int32)
    nvalid = np.full(B, A, np.int32)
    nvalid[-1] = 5
    return [torch.from_numpy(a) for a in (key2, rpos, qpos, valid, nvalid)]


@pytest.mark.gpu
@pytest.mark.parametrize("window", [16, 32, 64, 128])
def test_cuda_kernel_edge_runs_match_plain(window):
    # one run as long as the row, and rows of one-anchor runs, every
    # variant (the span one at spans of 19-60)
    need_cuda()
    args = edge_run_rows(np.random.default_rng(window), 9, 512)
    spanned = with_spans(args, np.random.default_rng(window + 1))
    for mode, rows in ((dict(), args), (dict(extents=True), args), (dict(spans=True), spanned)):
        got = chain_dp_skip(*[a.cuda() for a in rows], AVA_ONT.chn_pen_gap(), window=window, **mode, **KW)
        torch.cuda.synchronize()
        want = chain_dp_skip(*rows, AVA_ONT.chn_pen_gap(), window=window, **mode, **KW)
        for name, g, w in zip(("f", "broke", "cnt", "start", "rmf"), got, want):
            assert torch.equal(g.cpu(), w), (name, mode)
        one = want[0][1:-1] == (rows[2][1:-1] & 255 if mode.get("spans") else KW["span"])
        assert one.all(), "one-anchor runs score their span"
        if window >= 64:
            assert want[1][0].any(), "the long run must fire the skip break"


@pytest.mark.gpu
def test_cuda_kernel_full_length_rows_match_plain():
    # rows as long as the largest length bucket gives (A = 2^15): one run
    # of length A, then one-anchor runs; the main and the span variant
    need_cuda()
    args = edge_run_rows(np.random.default_rng(15), 3, 1 << 15)
    spanned = with_spans(args, np.random.default_rng(16))
    for mode, rows in ((dict(), args), (dict(spans=True), spanned)):
        got = chain_dp_skip(*[a.cuda() for a in rows], AVA_ONT.chn_pen_gap(), window=32, **mode, **KW)
        torch.cuda.synchronize()
        want = chain_dp_skip(*rows, AVA_ONT.chn_pen_gap(), window=32, **mode, **KW)
        for name, g, w in zip(("f", "broke", "cnt"), got, want):
            assert torch.equal(g.cpu(), w), (name, mode)
        assert (want[0][0, -100:] > want[0][0, :100].max()).all(), "the long run's chain climbs to its end"


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
    before = LAUNCHES.launches
    res = dev.count_batch(qnames, queries)
    assert LAUNCHES.launches > before
    host = OverlapEngine(index).count_overlaps_many(list(zip(qnames, queries)))
    np.testing.assert_array_equal(res.counts, [c for c, _ in host])
    np.testing.assert_array_equal(res.had_mapping, [bool(h) for _, h in host])
    # the PacBio/HPC preset on the same reads: the span variant
    index = build_index(targets, tnames, preset_for(Platform.PACBIO, dual=True))
    dev = DeviceOverlapEngine(index, device=torch.device("cuda"), batch_size=16, length_buckets=(4096,))
    before = LAUNCHES.span_launches
    res = dev.count_batch(qnames, queries)
    assert LAUNCHES.span_launches > before
    host = OverlapEngine(index).count_overlaps_many(list(zip(qnames, queries)))
    np.testing.assert_array_equal(res.counts, [c for c, _ in host])
    np.testing.assert_array_equal(res.had_mapping, [bool(h) for _, h in host])


@pytest.mark.gpu
def test_multisub_engine_on_card_matches_host():
    # a small anchor buffer splits the index into sub-indexes: one lookup
    # and one chain DP launch per sub a super-batch, counts equal the host's
    need_cuda()
    rng = np.random.default_rng(4242)
    genome = rng.choice(list(b"ACGT"), size=100_000).astype(np.uint8).tobytes()

    def reads(n, length):
        out = []
        for _ in range(n):
            pos = int(rng.integers(0, len(genome) - length))
            s = np.frombuffer(genome[pos : pos + length], np.uint8).copy()
            hit = rng.random(length) < 0.02
            s[hit] = rng.choice(list(b"ACGT"), size=int(hit.sum()))
            out.append(s.tobytes())
        return out

    targets, queries = reads(80, 2000), reads(40, 2500)
    tnames = [b"t%d" % i for i in range(80)]
    qnames = [b"q%d" % i for i in range(40)]
    for platform, counter in ((Platform.NANOPORE, "launches"), (Platform.PACBIO, "span_launches")):
        index = build_index(targets, tnames, preset_for(platform, dual=True))
        dev = DeviceOverlapEngine(
            index, device=torch.device("cuda"), batch_size=16, num_anchors=1536, length_buckets=(4096,)
        )
        assert dev.gdev.n_sub >= 2
        # the pass's program is captured here, so the pass's launches are
        # its replay's alone
        dev.warmup([len(q) for q in queries])
        before = getattr(LAUNCHES, counter)
        res = dev.count_batch(qnames, queries)
        # 40 rows: 3 batches of 16, one super-batch
        assert getattr(LAUNCHES, counter) == before + dev.gdev.n_sub
        host = OverlapEngine(index).count_overlaps_many(list(zip(qnames, queries)))
        np.testing.assert_array_equal(res.counts, [c for c, _ in host])
        np.testing.assert_array_equal(res.had_mapping, [bool(h) for _, h in host])
        assert res.fallback_rows < len(queries) // 2


@pytest.mark.gpu
def test_sharded_engine_on_card_matches_single_device():
    # two shards on the one card: each launches its own chain DP a
    # super-batch, and the merged counts equal the single-device engine's
    # and the host's, row for row
    need_cuda()
    rng = np.random.default_rng(5150)
    genome = rng.choice(list(b"ACGT"), size=100_000).astype(np.uint8).tobytes()

    def reads(n, length):
        out = []
        for _ in range(n):
            pos = int(rng.integers(0, len(genome) - length))
            s = np.frombuffer(genome[pos : pos + length], np.uint8).copy()
            hit = rng.random(length) < 0.04
            s[hit] = rng.choice(list(b"ACGT"), size=int(hit.sum()))
            out.append(s.tobytes())
        return out

    targets, queries = reads(80, 2000), reads(40, 2500)
    tnames = [b"t%d" % i for i in range(80)]
    qnames = [b"q%d" % i for i in range(40)]
    card = torch.device("cuda", 0)
    kw = dict(batch_size=16, length_buckets=(4096,))
    for platform, counter in ((Platform.NANOPORE, "launches"), (Platform.PACBIO, "span_launches")):
        index = build_index(targets, tnames, preset_for(platform, dual=True))
        one = DeviceOverlapEngine(index, device=card, **kw).count_batch(qnames, queries)
        dev = DeviceOverlapEngine(index, device=[card, card], **kw)
        assert len(dev.shards) == 2 and all(gi.uhash.device.type == "cuda" for gi in dev.shards)
        # capture the pass's programs first: the pass then launches by replay alone
        dev.warmup([len(q) for q in queries])
        before = getattr(LAUNCHES, counter)
        res = dev.count_batch(qnames, queries)
        # 40 rows: 3 batches of 16, one super-batch, one launch a shard
        assert getattr(LAUNCHES, counter) == before + 2
        np.testing.assert_array_equal(res.counts, one.counts)
        np.testing.assert_array_equal(res.had_mapping, one.had_mapping)
        host = OverlapEngine(index).count_overlaps_many(list(zip(qnames, queries)))
        np.testing.assert_array_equal(res.counts, [c for c, _ in host])


@pytest.mark.gpu
def test_programs_on_card_match_eager():
    # every branch's super-batch program (ONT on one sub-index, plain,
    # pairs and -F; ONT on several; PacBio) as a CUDA graph: two replays
    # run before either output is read, each bit-equal to the eager
    # function on the same inputs; a replay adds its graph's launches to
    # the counters; a warm pass enqueues without syncing the host
    need_cuda()
    from lrge_tpu_torch.ops.cuda_lib import launch_counts

    rng = np.random.default_rng(2024)
    genome = rng.choice(list(b"ACGT"), size=100_000).astype(np.uint8).tobytes()

    def reads(n, lo, hi):
        out = []
        for length in rng.integers(lo, hi, n):
            pos = int(rng.integers(0, len(genome) - length))
            s = np.frombuffer(genome[pos : pos + length], np.uint8).copy()
            hit = rng.random(length) < 0.03
            s[hit] = rng.choice(list(b"ACGT"), size=int(hit.sum()))
            out.append(s.tobytes())
        return out

    targets, queries = reads(80, 1500, 2500), reads(48, 600, 2000)
    tnames = [b"t%d" % i for i in range(80)]
    qnames = [b"q%d" % i for i in range(48)]
    card = torch.device("cuda", 0)
    cases = [
        (Platform.NANOPORE, 4096, dict()), (Platform.NANOPORE, 4096, dict(want_pairs=True)),
        (Platform.NANOPORE, 4096, dict(want_extents=True, filter_mode="overhang")),
        (Platform.NANOPORE, 1024, dict()), (Platform.PACBIO, 4096, dict(want_pairs=True)),
    ]
    for platform, anchors, mode in cases:
        index = build_index(targets, tnames, preset_for(platform, dual=True))
        dev = DeviceOverlapEngine(
            index, device=card, batch_size=8, num_anchors=anchors, length_buckets=(2048,), super_batch=1
        )
        assert (dev.gdev.n_sub >= 2) == (anchors == 1024)
        _, _, bucket_rows = dev.plan_rows(queries, range(48))
        dual, selfr = dev.query_ranks(qnames)
        batches = list(dev.super_batches(2048, bucket_rows[2048], queries, dual, selfr))
        assert len(batches) >= 2
        runs = []
        for _, A, codes, lengths, ids, d, s in batches[:2]:
            prog = dev.program(2048, A, ids.shape[0], **mode)
            arrays = dev.program_arrays(codes, lengths, d, s)
            before = launch_counts()
            runs.append((prog, arrays, prog.run(*arrays)))
            after = launch_counts()
            assert prog.graph is not None and prog.launches["sketch_launches"] == dev.pb_mode
            assert sum(prog.launches.values()) - dev.pb_mode == dev.gdev.n_sub
            assert {c: after[c] - before[c] for c in after} == prog.launches
        for prog, arrays, got in runs:
            want = prog.fn(*(torch.from_numpy(a).to(card) for a in arrays))
            for g, w in zip(got, want):
                assert (g is None) == (w is None) and (g is None or torch.equal(g, w)), (platform, mode)
        assert not torch.equal(runs[0][2][0], runs[1][2][0])
        # the warm pass: stage 1 makes no blocking call
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            full = dict(dict(want_pairs=False, want_extents=False, overhang_ratio=0.2, filter_mode="internal"), **mode)
            inflight = list(dev._dispatch(2048, bucket_rows[2048], queries, dual, selfr, **full))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert len(inflight) == len(batches)


def sharded_reads():
    """48 queries of 600-2,000 bp and 80 targets of 1.5-2.5 kb at 3%
    substitutions, from one 100 kb genome (seeded)."""
    rng = np.random.default_rng(2024)
    genome = rng.choice(list(b"ACGT"), size=100_000).astype(np.uint8).tobytes()

    def reads(n, lo, hi):
        out = []
        for length in rng.integers(lo, hi, n):
            pos = int(rng.integers(0, len(genome) - length))
            s = np.frombuffer(genome[pos : pos + length], np.uint8).copy()
            hit = rng.random(length) < 0.03
            s[hit] = rng.choice(list(b"ACGT"), size=int(hit.sum()))
            out.append(s.tobytes())
        return out

    return reads(80, 1500, 2500), [b"t%d" % i for i in range(80)], reads(48, 600, 2000), [b"q%d" % i for i in range(48)]


@pytest.mark.gpu
def test_shard_programs_on_card_match_eager():
    # two shards on the one card, ONT and PacBio: the query program and one
    # shard program a shard (CUDA graphs) on two super-batches, run before
    # either output is read, each merged plane and pair plane bit-equal to
    # the eager sharded_count on the query function's planes; a super-batch
    # adds one launch a shard; a warm pass's stage 1 enqueues without
    # syncing the host
    need_cuda()
    from lrge_tpu_torch.ops.cuda_lib import launch_counts
    from lrge_tpu_torch.parallel import sharded_count

    targets, tnames, queries, qnames = sharded_reads()
    card = torch.device("cuda", 0)
    for platform, counter in ((Platform.NANOPORE, "launches"), (Platform.PACBIO, "span_launches")):
        index = build_index(targets, tnames, preset_for(platform, dual=True))
        dev = DeviceOverlapEngine(index, device=[card, card], batch_size=8, length_buckets=(2048,), super_batch=1)
        _, _, bucket_rows = dev.plan_rows(queries, range(48))
        dual, selfr = dev.query_ranks(qnames)
        batches = list(dev.super_batches(2048, bucket_rows[2048], queries, dual, selfr))
        assert len(batches) >= 2
        runs = []
        for _, A, codes, lengths, ids, d, s in batches[:2]:
            query, shards = dev.shard_programs(2048, A, *ids.shape, want_pairs=True)
            assert query.graph is not None and all(p.graph is not None for p in shards)
            assert [p.key.shard for p in shards] == [0, 1] and all(p.launches[counter] == 1 for p in shards)
            arrays = dev.program_arrays(codes, lengths, d, s)
            before = launch_counts()
            runs.append((A, arrays, dev.sharded_run(2048, A, arrays, want_pairs=True)))
            assert launch_counts()[counter] == before[counter] + 2
        for A, arrays, (packed, pairs) in runs:
            q0, q1, mps, keep, qlen, qdual, qself, mcount = query.fn(*(torch.from_numpy(a).to(card) for a in arrays))
            q0 = q0.long() if dev.sharded.wide else q0.long() & 0xFFFFFFFF
            q1 = torch.zeros_like(q0[:, :1]) if q1 is None else q1
            counts, n_anchors, max_run, want_pairs = sharded_count(
                dev.shards, q0, q1, mps, qlen, qdual, qself, dev.params, num_anchors=A, window=dev.window,
                want_pairs=True, keep=keep != 0,
            )
            want = torch.stack([counts, n_anchors, max_run, mcount.long()], dim=-1).to(torch.int32)
            assert torch.equal(packed.reshape(-1, 4), want), platform
            assert torch.equal(pairs.reshape(want_pairs.shape).long(), want_pairs), platform
        assert not torch.equal(runs[0][2][0], runs[1][2][0])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            mode = dict(want_pairs=True, want_extents=False, overhang_ratio=0.2, filter_mode="internal")
            inflight = list(dev._dispatch(2048, bucket_rows[2048], queries, dual, selfr, **mode))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert len(inflight) == len(batches)


@pytest.mark.gpu
def test_failed_capture_raises_naming_its_program():
    # a function that syncs the host (a boolean mask's nonzero) cannot be
    # captured: the program raises, naming its key, and nothing runs eagerly
    # in its place
    need_cuda()
    from lrge_tpu_torch.ops.program import ProgramKey, SuperBatchProgram

    key = ProgramKey("shard", 8, 8, 1, 2, shard=1)
    with pytest.raises(RuntimeError, match=r"capture of the super-batch program ProgramKey\(branch='shard'.*shard=1"):
        SuperBatchProgram(key, lambda x: (x[x > 0].sum(),), [((1, 2), torch.int32, 1)], torch.device("cuda", 0))
