"""``count_batch`` with pair lists and ``-F`` on the PyTorch port vs the JAX engine (exact).

The port's ``DeviceOverlapEngine.count_batch(collect_pairs, filter_ratio,
filter_mode)`` (here on the CPU) must give the JAX package's
``DeviceOverlapEngine`` (CPU backend, one shard) the same counts,
had-mapping flags, pair dicts, ``fallback_rows`` and
``fallback_triggers``, on a containment-rich corpus: all-vs-all pairs,
two-set ``-F`` with and without pairs, ``--use-min-ref -F`` pairs, and
a pair plane cut to a few slots so that rows overflow it
(``pair_truncation``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny per-op work: intra-op threads only contend with the other workers
torch.set_num_threads(1)
from test_device_engine import _contained_corpus

from lrge_tpu.device_engine import DeviceOverlapEngine as RefEngine
from lrge_tpu.engine import OverlapEngine
from lrge_tpu.io import iter_records
from lrge_tpu.ops import overlap_jax as ref_overlap
from lrge_tpu.ops.index import build_index
from lrge_tpu.platform import Platform, preset_for
from lrge_tpu_torch.device_engine import DeviceOverlapEngine
from lrge_tpu_torch.ops import overlap as port_overlap

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    recs = list(iter_records(_contained_corpus(tmp_path_factory.mktemp("pairs"))))
    for i in (5, 85):  # sketch-quirk rows, one streamed by each strategy
        recs[i] = (recs[i][0], recs[i][1][:200] + b"N" + recs[i][1][201:])
    return [n for n, _ in recs], [s for _, s in recs]


def indexes(names, seqs):
    """The three strategies' (index, streamed names, streamed reads)."""
    two = preset_for(Platform.NANOPORE, dual=True)
    return {
        "ava": (build_index(seqs, names, preset_for(Platform.NANOPORE, dual=False)), names, seqs),
        "twoset": (build_index(seqs[:80], names[:80], two), names[80:], seqs[80:]),
        "inverse": (build_index(seqs[80:], names[80:], two), names[:80], seqs[:80]),
    }


def run_both(index, names, seqs, monkeypatch, *, num_anchors, pairs, **filt):
    monkeypatch.setenv("LRGE_SHARDS", "1")  # the reference's single-device path
    monkeypatch.setenv("LRGE_DEVICE_BUCKET", "4096")
    monkeypatch.setenv("LRGE_DEVICE_MIN_ROWS", "0")
    # the reference defaults to r = 0.30 (a TPU v5e calibration), the port to r = 0
    # (its H100 sweep, chip_smoke.py phase 13): one schedule for both
    monkeypatch.setenv("LRGE_HOST_SHARE", "0")
    kw = dict(batch_size=16, num_anchors=num_anchors, window=32, length_buckets=(4096,))
    out = []
    for eng in (RefEngine(index, **kw), DeviceOverlapEngine(index, device=CPU, **kw)):
        if filt:
            assert eng.supports_device_filter()
        collected = {} if pairs else None
        res = eng.count_batch(names, seqs, collect_pairs=collected, **filt)
        out.append((res, collected, eng.fallback_triggers))
    return out


def assert_same(want, got):
    (w, w_pairs, w_trig), (g, g_pairs, g_trig) = want, got
    np.testing.assert_array_equal(g.counts, w.counts)
    np.testing.assert_array_equal(g.had_mapping, w.had_mapping)
    assert g.fallback_rows == w.fallback_rows
    assert g_trig == w_trig
    if w_pairs is not None:
        assert g_pairs.keys() == w_pairs.keys()
        for qid, rids in w_pairs.items():
            np.testing.assert_array_equal(g_pairs[qid], rids, err_msg=f"row {qid}")


@pytest.mark.parametrize(
    "strategy,pairs,filt",
    [
        ("ava", True, {}),
        ("twoset", True, dict(filter_ratio=0.2, filter_mode="internal")),
        ("twoset", False, dict(filter_ratio=0.2, filter_mode="internal")),
        ("inverse", True, dict(filter_ratio=0.2, filter_mode="overhang")),
    ],
)
def test_count_batch_modes_match_reference(reads, monkeypatch, strategy, pairs, filt):
    index, names, seqs = indexes(*reads)[strategy]
    want, got = run_both(index, names, seqs, monkeypatch, num_anchors=4096, pairs=pairs, **filt)
    assert_same(want, got)
    res, collected, triggers = got
    assert triggers.total() > 0, "some rows must go to the host"
    assert res.fallback_rows < len(seqs), "most rows stay on the device"
    if filt:
        # the had-mapping flag is the pre-filter one: some mapped rows count 0
        assert (res.had_mapping & (res.counts == 0)).any() or strategy == "inverse"
    if pairs:
        assert sum(len(r) for r in collected.values()) > 0
        for qid, rids in collected.items():
            assert len(rids) == res.counts[qid] and len(set(rids.tolist())) == len(rids)
    if strategy == "ava":
        host = OverlapEngine(index).count_overlaps_many(list(zip(names, seqs)), want_pairs=True)
        for qid, (c, _, rids) in enumerate(host):
            assert c == res.counts[qid]
            if rids is not None and qid in collected:
                assert set(rids.tolist()) == set(collected[qid].tolist())


def test_pair_plane_overflow_goes_to_host(reads, monkeypatch):
    # a 2-slot pair plane (on shapes no other test traces, so the
    # reference recompiles with it): rows with more passing targets
    # are recomputed on the host, in both packages
    monkeypatch.setattr(ref_overlap, "PAIR_CAP", 2)
    monkeypatch.setattr(port_overlap, "PAIR_CAP", 2)
    index, names, seqs = indexes(*reads)["ava"]
    want, got = run_both(index, names, seqs, monkeypatch, num_anchors=3072, pairs=True)
    assert_same(want, got)
    assert got[2]["pair_truncation"] > 0
