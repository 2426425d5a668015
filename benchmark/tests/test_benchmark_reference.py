"""The plain reference against the port on a tiny corpus on the CPU:
the index, every row's count (the device engine with its plain chain
DP, and the port's host engine) and the estimator."""

import numpy as np
import pytest
import torch

from benchmark import check
from benchmark.corpus import make_corpus
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
