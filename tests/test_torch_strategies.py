"""The PyTorch port's all-vs-all and two-set strategies on the device path vs the JAX reference's host engine.

* The port's strategies on the device path (``device=cpu``) give the
  reference host strategies' estimates on containment-rich corpora
  (``-F`` in every direction, and ``--use-min-ref`` with host rows
  recovered by ``map_read``); the ``-F`` runs go through the extent
  variant of the chain DP.
* An all-vs-all ``-C`` device run writes the host's ``overlaps.paf``.
* The index build and the host mapper fork no workers once CUDA is
  live (``lrge_tpu_torch.engine.fork_unsafe``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny per-op work: intra-op threads only contend with the other workers
torch.set_num_threads(1)
from test_device_engine import _contained_corpus

import multiprocessing

from lrge_tpu import cli as ref_cli
from lrge_tpu.ops.index import build_index
from lrge_tpu.platform import Platform, preset_for
from lrge_tpu.strategy.ava import AvaStrategy as RefAva
from lrge_tpu.strategy.twoset import TwoSetStrategy as RefTwoSet
from lrge_tpu_torch import cli, device_engine
from lrge_tpu_torch import native as port_native
from lrge_tpu_torch.engine import ParallelHostMapper
from lrge_tpu_torch.errors import DuplicateReadIdentifierError
from lrge_tpu_torch.ops import overlap
from lrge_tpu_torch.strategy import AvaStrategy, TwoSetStrategy
from lrge_tpu_torch.strategy.twoset import build_engine_no_fork

CPU = torch.device("cpu")


def spy_chain_variants(monkeypatch):
    """Record the ``extents`` flag of every chain DP call of the fused pipeline."""
    calls = []
    real = overlap.chain_dp_skip

    def spy(*args, extents=False, **kw):
        calls.append(extents)
        return real(*args, extents=extents, **kw)

    monkeypatch.setattr(overlap, "chain_dp_skip", spy)
    return calls


# (reference strategy, port strategy, corpus seed, arguments), after
# tests/test_device_engine.py's -F device tests
STRATEGIES = {
    "twoset_filter": (RefTwoSet, TwoSetStrategy, 31, dict(
        target_num_reads=80, query_num_reads=30, seed=7, remove_internal=True,
    )),
    "ava_filter": (RefAva, AvaStrategy, 31, dict(num_reads=90, seed=11, remove_internal=True)),
    "inverse_filter": (RefTwoSet, TwoSetStrategy, 47, dict(
        target_num_reads=80, query_num_reads=30, seed=13, remove_internal=True, use_min_ref=True,
    )),
    "inverse": (RefTwoSet, TwoSetStrategy, 47, dict(
        target_num_reads=80, query_num_reads=30, seed=13, use_min_ref=True,
    )),
}


@pytest.mark.parametrize("case", list(STRATEGIES))
def test_strategy_on_device_matches_host(tmp_path, monkeypatch, case):
    ref_cls, port_cls, rng_seed, kw = STRATEGIES[case]
    fq = _contained_corpus(tmp_path, rng_seed=rng_seed)
    monkeypatch.setenv("LRGE_DEVICE_MIN_ROWS", "0")
    calls = spy_chain_variants(monkeypatch)
    if case == "inverse":
        # without the native pairs kernel, host-recomputed rows carry no
        # id list and are recovered with map_read (a 16-deep window sends
        # rows to the host)
        monkeypatch.setattr(device_engine, "_has_native_count", lambda: False)
        real_init = device_engine.DeviceOverlapEngine.__init__
        monkeypatch.setattr(
            device_engine.DeviceOverlapEngine, "__init__",
            lambda self, index, **k: real_init(self, index, **dict(k, window=16)),
        )
        recovered = []
        real_filtered = device_engine.DeviceOverlapEngine._host_count_filtered
        monkeypatch.setattr(
            device_engine.DeviceOverlapEngine, "_host_count_filtered",
            lambda self, items, *a, **k: recovered.extend(items) or real_filtered(self, items, *a, **k),
        )
    port = port_cls(fq, tmpdir=tmp_path / "d", engine="device", device=CPU, max_overhang_ratio=0.2, **kw)
    est_dev, nm_dev = port.generate_estimates()
    if kw.get("use_min_ref"):
        assert port.target_num_bases > port.query_num_bases, "inverse direction must engage"
    est_host, nm_host = ref_cls(fq, tmpdir=tmp_path / "h", engine="host", max_overhang_ratio=0.2, **kw).generate_estimates()
    assert nm_dev == nm_host
    np.testing.assert_array_equal(np.asarray(est_dev), np.asarray(est_host))
    assert calls and all(calls) == ("filter" in case), calls
    if case == "inverse":
        assert recovered, "some rows must be recovered on the host"


def test_cli_ava_paf_side_output_matches_host(tmp_path, capsys, monkeypatch):
    rng = np.random.default_rng(5150)
    genome = bytes(rng.choice(list(b"ACGT"), size=60_000).tolist())
    fq = tmp_path / "reads.fq"
    with open(fq, "wb") as fh:
        for i in range(120):
            pos = int(rng.integers(0, len(genome) - 1500))
            seq = genome[pos : pos + 1500]
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"I" * len(seq)))
    monkeypatch.setenv("LRGE_DEVICE_MIN_ROWS", "0")
    base = [str(fq), "-n", "90", "-s", "3", "-t", "2", "-C", "-qqq"]
    assert cli.main(base + ["-D", str(tmp_path / "dev"), "--engine", "device"], device=CPU) == 0
    assert ref_cli.main(base + ["-D", str(tmp_path / "host"), "--engine", "host"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1]
    (dev_paf,) = (tmp_path / "dev").glob("lrge-*/overlaps.paf")
    (host_paf,) = (tmp_path / "host").glob("lrge-*/overlaps.paf")
    assert dev_paf.read_text() == host_paf.read_text() != ""


def no_fork_after_cuda(monkeypatch):
    """A live CUDA context, and a ``multiprocessing`` that fails any
    attempt to set up forked workers."""

    def forked(*args, **kw):
        raise AssertionError("forked workers after CUDA started")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(multiprocessing, "get_context", forked)


def test_index_build_never_forks_after_cuda(monkeypatch):
    # without the native sketcher, build_index forks sketch workers for
    # >= 2000 reads; with a live CUDA context the port sketches serially
    rng = np.random.default_rng(8)
    genome = rng.choice(list(b"ACGT"), size=20_000).astype(np.uint8).tobytes()
    starts = rng.integers(0, len(genome) - 120, size=2000)
    seqs = [genome[s : s + 120] for s in starts]
    names = [b"f%d" % i for i in range(len(seqs))]
    params = preset_for(Platform.NANOPORE, dual=True)
    want = build_index(seqs, names, params)
    want_ava = build_index(seqs, names, preset_for(Platform.NANOPORE, dual=False))
    no_fork_after_cuda(monkeypatch)
    monkeypatch.setattr(port_native, "native", None)
    reads = list(zip(names, seqs))
    got = build_engine_no_fork(reads, params).index
    for field in ("keys", "rid", "pos", "strand", "lengths", "name_rank"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert got.mid_occ == want.mid_occ
    engine = TwoSetStrategy("unused.fq")._build_engine(reads)
    np.testing.assert_array_equal(engine.index.keys, want.keys)
    ava = AvaStrategy("unused.fq")._build_engine(reads).index
    np.testing.assert_array_equal(ava.keys, want_ava.keys)
    np.testing.assert_array_equal(ava.rid, want_ava.rid)


def test_host_mapper_maps_on_threads_after_cuda(monkeypatch):
    # the host mapper's forked pool becomes a thread pool once CUDA is
    # live, with the same mappings in the same order
    rng = np.random.default_rng(12)
    genome = rng.choice(list(b"ACGT"), size=30_000).astype(np.uint8).tobytes()
    starts = rng.integers(0, len(genome) - 1500, size=40)
    reads = [(b"m%d" % i, genome[s : s + 1500]) for i, s in enumerate(starts)]
    index = build_engine_no_fork(reads, preset_for(Platform.NANOPORE, dual=True)).index
    serial = ParallelHostMapper(index, 1)
    want = [[m.to_line() for m in recs] for recs in serial.map_reads(reads[:10])]
    serial.close()
    no_fork_after_cuda(monkeypatch)
    mapper = ParallelHostMapper(index, 3)
    try:
        assert mapper._pool is None and mapper._thread_pool is not None
        got = [[m.to_line() for m in recs] for recs in mapper.map_reads(reads[:10])]
    finally:
        mapper.close()
    assert got == want and any(want)


@pytest.mark.parametrize("strategy", [TwoSetStrategy, AvaStrategy])
def test_build_engine_rejects_duplicate_names(strategy):
    reads = [(b"a", b"ACGT" * 40), (b"b", b"TTGCA" * 30), (b"a", b"GGCAT" * 30)]
    with pytest.raises(DuplicateReadIdentifierError, match="a"):
        strategy("unused.fq")._build_engine(reads)
