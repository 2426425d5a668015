"""The reference engine's shape knobs in the PyTorch port (exact).

The JAX engine reads ``LRGE_DEVICE_BATCH``, ``LRGE_DEVICE_ANCHORS``,
``LRGE_DEVICE_WINDOW``, ``LRGE_DEVICE_SUPER``, ``LRGE_DEVICE_BUCKET``
(lrge_tpu/device_engine.py:167-174) and ``LRGE_BUCKET_BITS`` (:342-346);
the port's engine reads them the same way.  Under each knob both
engines, built with their defaults, give the same counts, the same
per-row planes (``n_anchors``, ``max_run``, ``mcount`` of every
super-batch, as each engine's triage sees them) and the same
``fallback_triggers``, and equal the exact host engine.  ``LRGE_SHARDS``
picks the devices: with two CUDA cards visible the engine shards over
both, and ``LRGE_SHARDS=1`` keeps it on one (no raise).

Integer outputs throughout: tolerance 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny per-op work: intra-op threads only contend with the other workers
torch.set_num_threads(1)
from test_device_engine import make_reads

from lrge_tpu.device_engine import DeviceOverlapEngine as RefEngine
from lrge_tpu.engine import OverlapEngine
from lrge_tpu.ops.index import build_index
from lrge_tpu.platform import Platform, preset_for
from lrge_tpu_torch import device_engine
from lrge_tpu_torch.device_engine import DeviceOverlapEngine

CPU = torch.device("cpu")
# every case: the reference's single-device path, every bucket on the
# device, no host share (the port's ratio is uncalibrated), and the one
# bucket that the reference's CPU backend keeps unless told otherwise
BASE = {"LRGE_SHARDS": "1", "LRGE_DEVICE_MIN_ROWS": "0", "LRGE_HOST_SHARE": "0", "LRGE_DEVICE_BUCKET": "4096"}
# (knobs, preset, {engine attribute: value the knobs must give})
CASES = {
    "window": ({"LRGE_DEVICE_WINDOW": "16"}, Platform.NANOPORE, {"window": 16}),
    "anchors": ({"LRGE_DEVICE_ANCHORS": "1024"}, Platform.NANOPORE, {"num_anchors": 1024}),
    "batch": ({"LRGE_DEVICE_BATCH": "16"}, Platform.NANOPORE, {"batch_size": 16}),
    # two super-batches of two and one batch
    "super": ({"LRGE_DEVICE_SUPER": "2", "LRGE_DEVICE_BATCH": "16"}, Platform.NANOPORE,
              {"super_batch": 2, "batch_size": 16}),
    "bucket": ({"LRGE_DEVICE_BUCKET": "1024"}, Platform.NANOPORE, {"length_buckets": (1024,)}),
    # the wide (PacBio) index always takes the bucketed dictionary
    "bucket_bits": ({"LRGE_BUCKET_BITS": "19"}, Platform.PACBIO, {}),
}


@pytest.fixture(scope="module")
def corpus():
    """A 100 kb genome with a 5 x 400 bp tandem block; 96 targets of 2 kb
    and 48 queries of 600-3,000 bp at 6% substitutions, one with an N."""
    rng = np.random.default_rng(6006)
    genome = bytearray(rng.choice(list(b"ACGT"), size=100_000).tolist())
    unit = bytes(rng.choice(list(b"ACGT"), size=400).tolist())
    genome[30_000 : 30_000 + 5 * 400] = unit * 5
    genome = bytes(genome)
    targets = make_reads(rng, genome, 96, 2000, err=0.06)
    queries = [make_reads(rng, genome, 1, int(L), err=0.06)[0] for L in rng.integers(600, 3000, 48)]
    queries[5] = queries[5][:300] + b"N" + queries[5][301:]  # a sketch-quirk row
    return targets, [b"t%d" % i for i in range(96)], queries, [b"q%d" % i for i in range(48)]


def spy_triage(monkeypatch, cls, log):
    """Record the per-row planes every ``triage_flags`` call of ``cls`` sees."""
    real = cls.triage_flags

    def triage(self, live, n_anchors, cap, max_run, mcount, mcap, codes, lengths):
        log.append((cap, mcap, *(np.asarray(x, dtype=np.int64).copy() for x in (n_anchors, max_run, mcount))))
        return real(self, live, n_anchors, cap, max_run, mcount, mcap, codes, lengths)

    monkeypatch.setattr(cls, "triage_flags", triage)


@pytest.mark.parametrize("case", list(CASES))
def test_knob_planes_and_triggers_match_reference(corpus, monkeypatch, case):
    knobs, platform, want_attrs = CASES[case]
    targets, tnames, queries, qnames = corpus
    for key, val in {**BASE, **knobs}.items():
        monkeypatch.setenv(key, val)
    index = build_index(targets, tnames, preset_for(platform, dual=True))
    ref_log, port_log = [], []
    spy_triage(monkeypatch, RefEngine, ref_log)
    spy_triage(monkeypatch, DeviceOverlapEngine, port_log)
    refe = RefEngine(index)
    dev = DeviceOverlapEngine(index, device=CPU)
    assert refe.sharded is None and dev.sharded is None
    for attr, val in want_attrs.items():
        assert getattr(dev, attr) == getattr(refe, attr) == val, attr
    if case == "bucket_bits":
        assert dev.gdev.bucket_bits == refe.gdev.bucket_bits == 19
    want = refe.count_batch(qnames, queries)
    got = dev.count_batch(qnames, queries)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.had_mapping, want.had_mapping)
    assert got.fallback_rows == want.fallback_rows
    assert dev.fallback_triggers == refe.fallback_triggers
    assert len(port_log) == len(ref_log) > 0
    for (cap, mcap, *planes), (rcap, rmcap, *rplanes) in zip(port_log, ref_log):
        assert (cap, mcap) == (rcap, rmcap)
        for g, w_, what in zip(planes, rplanes, ("n_anchors", "max_run", "mcount")):
            np.testing.assert_array_equal(g, w_, err_msg=what)
    host = OverlapEngine(index).count_overlaps_many(list(zip(qnames, queries)))
    np.testing.assert_array_equal(got.counts, [c for c, _ in host])
    np.testing.assert_array_equal(got.had_mapping, [bool(h) for _, h in host])


def test_two_cards_visible_no_raise(corpus, monkeypatch):
    """The default run with two CUDA cards visible: the engine shards over
    both, or, under ``LRGE_SHARDS=1``, runs on the first (the reference's
    device_engine.py:259-262); nothing raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda = [torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.delenv("LRGE_SHARDS", raising=False)
    assert device_engine.default_devices() == cuda
    assert device_engine.shard_plan() == (cuda, 2)
    assert device_engine.resolve_engine("auto", 10**6) == "device"
    monkeypatch.setenv("LRGE_SHARDS", "1")
    assert device_engine.shard_plan() == (cuda[:1], 1)
    # the engine takes its devices from that rule (two CPU devices stand
    # in for the cards here)
    monkeypatch.setattr(device_engine, "default_devices", lambda: [CPU, CPU])
    monkeypatch.setenv("LRGE_DEVICE_BUCKET", "4096")
    monkeypatch.setenv("LRGE_DEVICE_MIN_ROWS", "0")
    targets, tnames, queries, qnames = corpus
    index = build_index(targets, tnames, preset_for(Platform.NANOPORE, dual=True))
    one = DeviceOverlapEngine(index)
    assert one.devices == [CPU] and one.sharded is None and one.gdev is not None
    monkeypatch.delenv("LRGE_SHARDS")
    two = DeviceOverlapEngine(index)
    assert two.devices == [CPU, CPU] and two.sharded.n_shards == 2 and len(two.shards) == 2
    res_one, res_two = (e.count_batch(qnames, queries) for e in (one, two))
    np.testing.assert_array_equal(res_one.counts, res_two.counts)
