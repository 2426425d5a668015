"""The plain reference against the port on a tiny corpus on the CPU:
the index, every row's count (the device engine with its plain chain
DP, and the port's host engine) and the estimator; and the reference's
lockstep chain DP against its per-anchor scan, bit for bit."""

import numpy as np
import pytest
import torch

from benchmark import check
from benchmark.corpus import make_corpus
from benchmark.reference import chain
from benchmark.reference import estimate as ref_estimate
from benchmark.reference.params import Params
from benchmark.tests.cells import TINY_TRAFFIC, tiny_cell
from benchmark.workers import Workers


@pytest.fixture(scope="module")
def pool():
    return Workers(2)


@pytest.mark.parametrize("config", ["ont_twoset", "pb_twoset"])
def test_reference_equals_the_port_on_every_row(config, pool, monkeypatch):
    from lrge_tpu_torch.device_engine import DeviceOverlapEngine
    from lrge_tpu_torch.ops.index import build_index
    from lrge_tpu_torch.platform import Platform, preset_for

    cfg = tiny_cell(config, monkeypatch).config
    corpus = make_corpus(TINY_TRAFFIC, cfg["target_reads"], cfg["query_reads"], 2024)
    params = preset_for(Platform.from_str(cfg["platform"]), dual=cfg["dual"])
    index = build_index(corpus.targets, corpus.tnames, params)
    ref = check.Reference(corpus, Params.from_config(cfg), pool)
    assert ref.index.mid_occ == index.mid_occ
    for a, b in ((ref.index.keys, index.keys), (ref.index.rid, index.rid), (ref.index.pos, index.pos),
                 (ref.index.strand, index.strand)):
        np.testing.assert_array_equal(a, b)
    engine = DeviceOverlapEngine(index, device=torch.device("cpu"), batch_size=cfg["batch_size"],
                                 num_anchors=cfg["num_anchors"], window=cfg["window"])
    got = engine.count_batch(corpus.qnames, corpus.queries).counts
    rows = np.arange(len(corpus.queries))
    want = ref.counts(rows)
    assert want.sum() > 0
    np.testing.assert_array_equal(got, want)
    host = [c for c, _ in engine.host.count_overlaps_many(list(zip(corpus.qnames, corpus.queries)))]
    np.testing.assert_array_equal(host, want)


def test_reference_estimator_equals_the_port_and_its_bf16_control_does_not():
    from lrge_tpu_torch.estimate import LOWER_QUANTILE, UPPER_QUANTILE, median, per_read_estimate_batch

    rng = np.random.default_rng(3)
    lens = rng.integers(500, 30_000, size=5_000)
    counts = rng.integers(0, 12, size=5_000)
    avg = float(np.float32(25_123_456) / np.float32(10_000))
    ests = per_read_estimate_batch(lens, avg, 10_000, counts, 100)
    want = median(ests[np.isfinite(ests)], LOWER_QUANTILE, UPPER_QUANTILE)
    assert ref_estimate.estimate(lens, avg, 10_000, counts, 100) == want
    low = ref_estimate.estimate(lens, avg, 10_000, counts, 100, ref_estimate.bf16)
    assert check.estimate_gap(low, want) > 0


def test_workers_return_results_in_order_and_raise_for_a_failed_worker():
    from benchmark.reference.sketch import sketch

    seqs = [b"ACGTTGCAAGGCTTACGATCGATCGGATCCA" * 5, b"TTGACCGATAGCTAGCTTAGGCATCGAT" * 7]
    got = Workers(2).map("sketch", [([s], 15, 5, False) for s in seqs])
    for (mz,), s in zip(got, seqs):
        want = sketch(s, 15, 5, False)
        assert len(want.key) > 0 and all(np.array_equal(a, b) for a, b in zip(mz, want))
    with pytest.raises(RuntimeError, match="reference worker nope"):
        Workers(1).map("nope", [()])


# The lockstep chain DP against the per-anchor scan, bit for bit.

def config_params(config: str) -> Params:
    return Params.from_config(tiny_cell(config).config)


def assert_lockstep_is_the_scan(sets: list, p: Params, monkeypatch) -> list:
    """``chain_dp_many`` of ``sets`` equals ``chain_dp_scan`` of each, and
    so do their counts; returns the counts."""
    for a, (f, pred) in zip(sets, chain.chain_dp_many(sets, p)):
        want_f, want_pred = chain.chain_dp_scan(a, p)
        np.testing.assert_array_equal(f, want_f)
        np.testing.assert_array_equal(pred, want_pred)
    got = chain.counts(sets, p)
    with monkeypatch.context() as m:
        m.setattr(chain, "chain_dp_many", lambda s, q: [chain.chain_dp_scan(a, q) for a in s])
        assert chain.counts(sets, p) == got
    return got


def corpus_anchors(traffic: dict, config: str, n_targets: int, n_queries: int, seed: int, pool) -> tuple:
    p = config_params(config)
    corpus = make_corpus(traffic, n_targets, n_queries, seed)
    ref = check.Reference(corpus, p, pool)
    ref.sketch_queries(range(n_queries))
    return corpus, p, [ref.anchors(r) for r in range(n_queries)]


@pytest.mark.parametrize("config", ["ont_twoset", "pb_twoset"])
def test_lockstep_dp_is_the_scan_on_the_tiny_corpus(config, pool, monkeypatch):
    _, p, sets = corpus_anchors(TINY_TRAFFIC, config, 150, 48, 7, pool)
    assert p.hpc == (config == "pb_twoset")
    assert sum(assert_lockstep_is_the_scan(sets, p, monkeypatch)) > 0


Q20_LIKE = dict(TINY_TRAFFIC, name="q20_like", reads={"shape": 3.0, "mean": 1_500, "min": 500, "max": 4_000,
                                                     "substitution": 0.003, "insertion": 0.003, "deletion": 0.004})


# the shipped widths; one so narrow that many anchors take the scan; one
# that holds every window here, so the skip cut alone decides
@pytest.mark.parametrize("widths", ["shipped", "narrow", "wide"])
@pytest.mark.parametrize("config", ["ont_twoset", "pb_twoset"])
def test_lockstep_dp_is_the_scan_on_accurate_reads_at_high_coverage(config, widths, pool, monkeypatch):
    if widths != "shipped":
        monkeypatch.setattr(chain, "WIDTHS", {"narrow": (8,), "wide": (512,)}[widths])
    corpus, p, sets = corpus_anchors(Q20_LIKE, config, 900, 4, 17, pool)
    assert sum(len(t) for t in corpus.targets) > 20 * corpus.genome_size
    assert min(len(a) for a in sets) > 1_000
    scans, scan_one = [], chain._scan_one
    with monkeypatch.context() as m:
        m.setattr(chain, "_scan_one", lambda *a: scans.append(a[0]) or scan_one(*a))
        chain.chain_dp_many(sets, p)
    if widths != "shipped":
        assert bool(scans) == (widths == "narrow")
    assert sum(assert_lockstep_is_the_scan(sets, p, monkeypatch)) > 0


def anchors(rid, rpos, qpos, strand=None, span=None) -> chain.Anchors:
    """Anchors sorted by (rid, strand, rpos), as ``collect_anchors`` gives them."""
    rid, rpos, qpos = (np.asarray(x, dtype=np.int32) for x in (rid, rpos, qpos))
    strand = np.zeros(len(rid), np.int8) if strand is None else np.asarray(strand, dtype=np.int8)
    span = np.full(len(rid), 15, np.int32) if span is None else np.asarray(span, dtype=np.int32)
    o = np.lexsort((rpos, strand, rid))
    return chain.Anchors(rid[o], rpos[o], qpos[o], strand[o], span[o])


def test_lockstep_dp_of_empty_and_one_anchor_groups(monkeypatch):
    p = config_params("ont_twoset")
    empty = anchors([], [], [])
    single = anchors([0, 1, 1, 2, 3], [5, 40, 40, 7, 9], [5, 40, 41, 7, 9], strand=[0, 0, 1, 0, 1])
    chain_of_two = anchors([4, 4], [100, 200], [100, 200], span=[90, 90])
    assert assert_lockstep_is_the_scan([empty, single, empty, chain_of_two], p, monkeypatch) == [0, 0, 0, 1]
    assert chain.counts([empty], p) == [0] and chain.chain_dp_many([empty], p)[0][0].shape == (0,)
    np.testing.assert_array_equal(chain.chain_dp_many([single], p)[0][1], -1)


def test_lockstep_dp_where_no_width_holds_the_skip_cut(monkeypatch):
    """A chain with an anchor every ``gap`` steps among anchors that
    step back along the query, which no predecessor can take: the skip
    cut falls past each width in turn, so each width and the scan settle
    some anchors."""
    p = config_params("ont_twoset")
    rng = np.random.default_rng(5)
    sets = []
    for gap in (2, 4, 12):
        n = 1_200
        rpos = np.arange(n) * 3
        on = np.arange(n) % gap == 0
        qpos = np.where(on, rpos, 12_000 - rpos + rng.integers(0, 3, n))
        sets.append(anchors(np.zeros(n), rpos, qpos))
    widths, scans = [], []
    settle, scan_one = chain._settle, chain._scan_one
    with monkeypatch.context() as m:
        m.setattr(chain, "_settle", lambda i, width, *a: widths.append(width) or settle(i, width, *a))
        m.setattr(chain, "_scan_one", lambda *a: scans.append(a[0]) or scan_one(*a))
        chain.chain_dp_many(sets, p)
    assert set(widths) == set(chain.WIDTHS) and scans
    assert assert_lockstep_is_the_scan(sets, p, monkeypatch) == [1, 1, 1]


def test_lockstep_dp_stops_where_the_skip_cut_falls(monkeypatch):
    """An anchor meets a weak chain first and a strong one behind it,
    neither able to join the other: 26 marked steps of the weak chain
    that do not improve (``max_chain_skip`` 25) stop the scan before the
    strong chain, 25 do not."""
    p = config_params("ont_twoset")
    strong = np.arange(40) * 10
    for n_weak, takes_strong in ((27, False), (26, True)):
        weak = 2_000 + np.arange(n_weak) * 10
        a = anchors(np.zeros(40 + n_weak + 1), np.concatenate([strong, weak, [5_000]]),
                    np.concatenate([strong, weak + 3_000, [6_500]]))
        assert_lockstep_is_the_scan([a], p, monkeypatch)
        f, pred = chain.chain_dp_many([a], p)[0]
        assert pred[-1] == (39 if takes_strong else 40 + n_weak - 1)


def test_lockstep_dp_of_a_tandem_repeat_and_of_ties(monkeypatch):
    """A unit repeated on the query and the target gives every anchor
    many predecessors of equal score; ties go to the largest j."""
    p = config_params("ont_twoset")
    copies, unit = 40, 25
    a, b = np.meshgrid(np.arange(copies), np.arange(copies), indexing="ij")
    tandem = anchors(np.zeros(copies * copies), 1_000 + unit * a.ravel(), 500 + unit * b.ravel())
    # two first anchors that reach the third at one score: the later one is its predecessor
    tie = anchors([0, 0, 0], [0, 10, 100], [10, 0, 100])
    assert assert_lockstep_is_the_scan([tandem, tie], p, monkeypatch) == [1, 0]
    f, pred = chain.chain_dp_many([tie], p)[0]
    assert pred[2] == 1 and f[2] > f[1] == f[0]


def test_lockstep_dp_of_hpc_spans_through_the_backtrack(monkeypatch):
    """HPC spans (``-P pb``): two chains on one target and one on
    another, peeled by ``backtrack_targets``."""
    p = config_params("pb_twoset")
    assert p.hpc
    rng = np.random.default_rng(9)
    rid, rpos, qpos, span = [], [], [], []
    for r, start, n in ((0, 0, 60), (0, 40_000, 45), (1, 500, 70), (2, 0, 2)):
        pos = start + np.cumsum(rng.integers(8, 30, n))
        rid += [r] * n
        rpos += pos.tolist()
        qpos += (pos - start + rng.integers(0, 3, n)).tolist()
        span += rng.integers(19, 40, n).tolist()
    sets = [anchors(rid, rpos, qpos, span=span)]
    assert assert_lockstep_is_the_scan(sets, p, monkeypatch) == [2]
    f, pred = chain.chain_dp_many(sets, p)[0]
    assert chain.backtrack_targets(f, pred, sets[0], p) == {0, 1}
