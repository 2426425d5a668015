"""The chain DP's work count and least time against counts made by hand."""

import numpy as np
import pytest

from benchmark import roofline
from benchmark.reference.chain import Anchors


def test_run_evals_is_the_sum_of_min_i_w():
    for n in range(0, 80):
        assert roofline.run_evals(np.array([n]), 32)[0] == sum(min(i, 32) for i in range(n))
    # runs of 1, 3 and 40 anchors at W = 32: 0 + (0+1+2) + (0+1+...+31 + 8*32)
    assert roofline.run_evals(np.array([1, 3, 40]), 32).sum() == 0 + 3 + (496 + 256)


class FakeRef:
    """Queries of the given lengths whose anchors are given by hand."""

    def __init__(self, lengths, anchors):
        self.corpus = type("C", (), {"queries": [b"A" * n for n in lengths]})()
        self._anchors = anchors

    def map_anchors(self, fn, rows):
        return [fn(self._anchors[r]) for r in rows]


def row(runs):
    """Anchors of (rid, strand, length) runs."""
    rid = np.concatenate([np.full(n, r) for r, s, n in runs]).astype(np.int32)
    strand = np.concatenate([np.full(n, s) for r, s, n in runs]).astype(np.int8)
    z = np.zeros(len(rid), dtype=np.int32)
    return Anchors(rid, z, z, strand, z)


class FakeEngine:
    """An engine's plan: rows of up to 2048 bases to the 2048 bucket
    (A = 2048), of up to 4096 to the 4096 bucket (A = 4096), the rest and
    the 4096 bucket's one row (a sparse bucket) to the host."""

    def plan_rows(self, seqs, rows):
        small = [i for i in rows if len(seqs[i]) <= 2048]
        return [i for i in rows if i not in small], [], {2048: small}

    def bucket_shape(self, L):
        return L, 8


def test_pass_work_counts_by_hand():
    anchors = [
        row([(0, 0, 3), (0, 1, 6)]),  # 0+1+2, 0+1+2+3+4+4 at W = 4
        row([(5, 0, 2)]),  # 0+1
        row([(1, 0, 2100)]),  # over bucket 2048's A of 2048: left out
        row([(2, 0, 7)]),  # a row the engine sends to the host: left out
        row([(3, 0, 5)]),  # longer than the last bucket: left out
    ]
    ref = FakeRef([1000, 1500, 2000, 3000, 5000], anchors)
    plan = roofline.device_plan(FakeEngine(), ref.corpus.queries)
    assert plan == {0: 2048, 1: 2048, 2: 2048}
    work = roofline.pass_work(ref, plan, 4)
    assert work == {"evals": 3 + 14 + 1, "anchors": 9 + 2, "runs": 3, "rows": 2}
    t, binds = roofline.least_time(work, spans=False)
    ops = 18 * roofline.OPS_PER_EVAL / roofline.PEAK_OPS
    nbytes = (11 * (16 + 8) + 2 * 4) / roofline.PEAK_BYTES
    assert binds == "bytes" and t == pytest.approx(nbytes) and nbytes > ops


def test_least_time_takes_the_larger_bound_and_spans_write_three_planes():
    work = {"evals": 10**9, "anchors": 10**6, "runs": 10, "rows": 10}
    t, binds = roofline.least_time(work, spans=True)
    assert binds == "operations" and t == pytest.approx(10**9 * 43 / 67e12)
    _, b = roofline.least_time({"evals": 0, "anchors": 10, "runs": 1, "rows": 1}, spans=True)
    assert b == "bytes"
    assert roofline.least_time({"evals": 0, "anchors": 10, "runs": 1, "rows": 0}, spans=True)[0] == pytest.approx(
        10 * 28 / 3.35e12
    )


def test_device_plan_is_the_engines_plan_and_capacity():
    """On a real engine (CPU) the plan's capacities are those of the
    programs its warm-up captured, and its rows those of its buckets."""
    import torch

    from benchmark.corpus import make_corpus
    from benchmark.tests.cells import TINY_TRAFFIC
    from lrge_tpu_torch.device_engine import DeviceOverlapEngine
    from lrge_tpu_torch.ops.index import build_index
    from lrge_tpu_torch.platform import Platform, preset_for

    corpus = make_corpus(TINY_TRAFFIC, 60, 40, 5)
    index = build_index(corpus.targets, corpus.tnames, preset_for(Platform.NANOPORE, dual=True))
    engine = DeviceOverlapEngine(index, device=torch.device("cpu"), batch_size=8, num_anchors=4096, window=32)
    engine.warmup([len(q) for q in corpus.queries])
    plan = roofline.device_plan(engine, corpus.queries)
    assert plan and set(plan.values()) == {k.A for k in engine.programs}
    long_rows, share, bucket_rows = engine.plan_rows(corpus.queries, range(len(corpus.queries)))
    assert set(plan) == {i for rows in bucket_rows.values() for i in rows}
    assert not set(plan) & set(long_rows + share)
