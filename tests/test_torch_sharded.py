"""The sharded index and counting in the PyTorch port vs the JAX reference (exact).

The twin of ``tests/test_sharded.py``, on the CPU: the reference shards
over the 8-device virtual CPU mesh that ``tests/conftest.py`` gives,
the port over eight CPU devices (``devices=[cpu] * S``).

* ``ShardedGroupedIndex.from_host`` planes equal the reference's shard
  by shard at S = 2, 4 and 8, narrow (ONT) and wide (PacBio); the
  reference pads every shard to common shapes, the port keeps each
  shard's own length.
* ``sharded_count`` gives the counts, ``n_anchors`` and ``max_run`` of
  ``sharded_count_fn`` on the 1x8, 2x4 and 4x2 meshes (and PacBio on
  2x4), and the same pair sets.
* The occurrence cutoff is applied before the split.
* ``DeviceOverlapEngine.count_batch`` on eight shards equals the
  reference engine under ``LRGE_SHARDS=8``: counts, fallback triggers and
  pair sets; and the exact host engine.
* The two-set strategy on eight shards gives the host engine's
  estimates, and ``-F`` on a sharded index runs on the host.

Integer outputs throughout: tolerance 0.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny per-op work: intra-op threads only contend with the other workers
torch.set_num_threads(1)
import jax.numpy as jnp
from test_distributed import _write_corpus
from test_sharded import corpus  # noqa: F401  (the reference's fixture)

from lrge_tpu.device_engine import DeviceOverlapEngine as RefEngine
from lrge_tpu.engine import OverlapEngine
from lrge_tpu.ops.encode import make_batches
from lrge_tpu.ops.index import build_index
from lrge_tpu.ops.sketch_jax import sketch_batch_exact
from lrge_tpu.parallel import sharded as ref
from lrge_tpu.platform import Platform, preset_for
from lrge_tpu.strategy.ava import AvaStrategy as RefAva
from lrge_tpu.strategy.twoset import TwoSetStrategy as RefTwoSet
from lrge_tpu_torch.device_engine import DeviceOverlapEngine
from lrge_tpu_torch.ops.index import TargetIndex
from lrge_tpu_torch.parallel import ShardedGroupedIndex, sharded_count
from lrge_tpu_torch.platform import AVA_ONT
from lrge_tpu_torch.strategy import AvaStrategy, TwoSetStrategy

CPU = torch.device("cpu")
PLATFORMS = {"narrow": Platform.NANOPORE, "wide": Platform.PACBIO}
IMAX = np.iinfo(np.int32).max
# the reference's padding value of each plane
PAD = {"post0": IMAX, "post1": 0, "uhash": IMAX, "uhash_lo": 0, "dict0": 0, "dict1": 0, "boff": None}
SCALARS = ("mid_occ", "n_shards", "bucket_bits", "bucket_kmax", "packed_rid_bits", "packed_dict_bits", "wide")


def target_index(corpus, layout):
    targets, tnames, _, _ = corpus
    return build_index(targets, tnames, preset_for(PLATFORMS[layout], dual=True))


@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("layout", list(PLATFORMS))
def test_sharded_planes_match(corpus, layout, S):
    index = target_index(corpus, layout)
    want = ref.ShardedGroupedIndex.from_host(index, S)
    got = ShardedGroupedIndex.from_host(index, S)
    for name in SCALARS:
        assert getattr(got, name) == getattr(want, name), name
    assert got.wide == (layout == "wide") and got.bucket_kmax <= 24
    np.testing.assert_array_equal(got.rank, want.rank)
    for name, pad in PAD.items():
        for s in range(S):
            mine, theirs = getattr(got, name)[s], getattr(want, name)[s]
            np.testing.assert_array_equal(mine, theirs[: len(mine)], err_msg=f"{name}[{s}]")
            if pad is not None:
                assert (theirs[len(mine) :] == pad).all(), f"{name}[{s}] padding"
    # every posting of the pruned index lands on exactly one shard
    assert sum(int((p != IMAX).sum()) for p in got.post0) == int((want.post0 != IMAX).sum())
    # placed shards carry the same planes
    for s, gi in enumerate(got.place([CPU] * S)):
        assert gi.n_sub == 1 and gi.cuckoo_bits == 0 and gi.wide == got.wide
        np.testing.assert_array_equal(gi.uhash.numpy(), got.uhash[s])
        np.testing.assert_array_equal(gi.boff.numpy(), got.boff[s])
        np.testing.assert_array_equal((gi.rps if got.packed_rid_bits else gi.rid).numpy(), got.post0[s])
        np.testing.assert_array_equal((gi.loocc if got.packed_dict_bits else gi.lo)[0].numpy(), got.dict0[s])


def query_planes(corpus, params, wide):
    """The reference test's query planes (numpy): ``(q0, q1, mps, qlen)``."""
    _, _, queries, _ = corpus
    B = len(queries)
    if wide:
        from lrge_tpu.ops.sketch import sketch_seqs_native

        M = 1024
        qhi = np.full((B, M), -1, np.int32)
        qlo = np.zeros((B, M), np.int32)
        mps = np.zeros((B, M), np.int32)
        for i, mz in enumerate(sketch_seqs_native(queries, params.k, params.w, params.hpc)):
            h38 = mz.key >> np.uint64(8)
            c = min(len(h38), M)
            qhi[i, :c] = (h38 >> np.uint64(19)).astype(np.int32)[:c]
            qlo[i, :c] = (h38 & np.uint64((1 << 19) - 1)).astype(np.int32)[:c]
            span = (mz.key & np.uint64(0xFF)).astype(np.int32)
            mps[i, :c] = (mz.pos.astype(np.int32)[:c] << 9) | (span[:c] << 1) | mz.strand.astype(np.int32)[:c]
        return qhi, qlo, mps, np.array([len(q) for q in queries], np.int32)
    (batch,) = make_batches(queries, batch_size=B, pad_to=2048, length_sorted=False)
    assert (batch.ids == np.arange(B)).all()
    mhash, mpos, mstrand, _ = sketch_batch_exact(batch.codes, batch.lengths, k=params.k, w=params.w,
                                                 max_minimizers=1024)
    return mhash, np.zeros((B, 1), np.int32), (mpos * 2 + mstrand).astype(np.int32), batch.lengths


# (n_data, n_index, layout)
MESHES = {"1x8": (1, 8, "narrow"), "2x4": (2, 4, "narrow"), "4x2": (4, 2, "narrow"), "2x4_pacbio": (2, 4, "wide")}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_count_matches_reference(corpus, mesh):
    n_data, n_index, layout = MESHES[mesh]
    if layout == "wide":
        from lrge_tpu_torch.native import native

        if native is None:
            pytest.skip("native sketcher unavailable")
    index = target_index(corpus, layout)
    p = index.params
    S = n_data * n_index
    sgi = ref.ShardedGroupedIndex.from_host(index, S)
    fn = ref.sharded_count_fn(
        ref.make_mesh(n_data, n_index), k=p.k, max_gap=p.max_gap, bw=p.bw, min_score=p.min_chain_score,
        num_anchors=2048, window=128, no_dual=p.no_dual, no_diag=p.no_diag, q_occ_frac=p.q_occ_frac,
        min_cnt=p.min_cnt, wide=sgi.wide, bucket_bits=sgi.bucket_bits, bucket_kmax=sgi.bucket_kmax,
        packed_rid_bits=sgi.packed_rid_bits, packed_dict_bits=sgi.packed_dict_bits,
    )
    q0, q1, mps, qlen = query_planes(corpus, p, sgi.wide)
    B = len(qlen)
    qdual, qself = np.zeros(B, np.int32), np.full(B, -1, np.int32)
    want = [np.asarray(x) for x in fn(
        sgi.device_put(ref.make_mesh(n_data, n_index)), jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(mps),
        jnp.asarray(qlen), jnp.asarray(qdual), jnp.asarray(qself), jnp.int32(sgi.mid_occ),
        jnp.float32(p.chn_pen_gap()),
    )]
    shards = ShardedGroupedIndex.from_host(index, S).place([CPU] * S)
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))
    got = sharded_count(
        shards, t(q0), t(q1), t(mps), t(qlen), t(qdual), t(qself), p, num_anchors=2048, window=128,
        want_pairs=True,
    )
    for g, w_, what in zip(got[:3], want[:3], ("counts", "n_anchors", "max_run")):
        np.testing.assert_array_equal(g.numpy(), w_, err_msg=what)
    # pair planes: another layout, the same rid sets
    for g, w_ in zip(got[3].numpy(), want[3]):
        assert sorted(g[g >= 0].tolist()) == sorted(w_[w_ >= 0].tolist())
    assert (got[0] > 0).sum() > B // 2
    host = OverlapEngine(index)
    _, _, queries, qnames = corpus
    np.testing.assert_array_equal(got[0].numpy(), [host.count_overlaps(n, q)[0] for n, q in zip(qnames, queries)])


def test_global_pruning_applied_before_sharding():
    """A minimizer above mid_occ globally is absent from every shard, even
    where its per-shard occurrence is below the cutoff (the reference's
    test of the same name, on the port's copy of the build)."""
    rep = np.uint64(500)
    uniq = np.arange(1000, 1040, dtype=np.uint64)
    keys = np.concatenate([np.full(12, rep), uniq])
    rid = np.concatenate([np.arange(12, dtype=np.int32), np.arange(40, dtype=np.int32) % 16])
    order = np.lexsort((rid, keys))
    index = TargetIndex(
        keys=keys[order], rid=rid[order], pos=np.zeros(52, np.int32), strand=np.zeros(52, np.int8),
        names=[f"t{i}".encode() for i in range(16)], lengths=np.full(16, 1000, np.int32), mid_occ=10,
        params=AVA_ONT, name_rank=np.arange(16, dtype=np.int32),
    )
    sharded = ShardedGroupedIndex.from_host(index, 4)
    allu = np.concatenate(sharded.uhash)
    rep32 = int((np.uint32(500) ^ np.uint32(0x80000000)).view(np.int32))
    assert not (allu == rep32).any(), "over-occurring key leaked into shards"
    u32 = (uniq.astype(np.uint32) ^ np.uint32(0x80000000)).view(np.int32)
    assert np.isin(u32, allu).all()


# (preset, stream, pairs) as in tests/test_torch_multisub.py
ENGINES = {
    "ont_twoset": (Platform.NANOPORE, "twoset"),
    "ont_ava": (Platform.NANOPORE, "ava"),
    "pb_ava": (Platform.PACBIO, "ava"),
}
KNOBS = {"LRGE_DEVICE_BATCH": "16", "LRGE_DEVICE_ANCHORS": "1024", "LRGE_DEVICE_BUCKET": "2048",
         "LRGE_DEVICE_MIN_ROWS": "0", "LRGE_HOST_SHARE": "0"}


@pytest.mark.parametrize("case", list(ENGINES))
def test_count_batch_sharded_matches_reference(corpus, monkeypatch, case):
    platform, stream = ENGINES[case]
    targets, tnames, queries, qnames = corpus
    ava = stream == "ava"
    index = build_index(targets, tnames, preset_for(platform, dual=not ava))
    names, seqs = (tnames, targets) if ava else (qnames, queries)
    for key, val in {**KNOBS, "LRGE_SHARDS": "8"}.items():
        monkeypatch.setenv(key, val)
    refe = RefEngine(index)
    dev = DeviceOverlapEngine(index, device=[CPU] * 8)
    assert refe.sharded is not None and dev.sharded.n_shards == 8 and len(dev.shards) == 8
    assert not dev.supports_device_filter() and not dev.lockstep
    want_pairs, got_pairs = ({}, {}) if ava else (None, None)
    want = refe.count_batch(names, seqs, collect_pairs=want_pairs)
    got = dev.count_batch(names, seqs, collect_pairs=got_pairs)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.had_mapping, want.had_mapping)
    assert got.fallback_rows == want.fallback_rows
    assert dev.fallback_triggers == refe.fallback_triggers
    host = OverlapEngine(index).count_overlaps_many(list(zip(names, seqs)), want_pairs=ava)
    np.testing.assert_array_equal(got.counts, [h[0] for h in host])
    # the corpus's 8% errors leave the PacBio preset (k = 19) fewer overlaps
    assert (got.counts > 0).sum() > len(seqs) // 4
    if ava:
        assert got_pairs.keys() == want_pairs.keys() and len(got_pairs) > len(seqs) // 2
        for i, rids in got_pairs.items():
            assert sorted(rids.tolist()) == sorted(want_pairs[i].tolist()) == sorted(host[i][2].tolist())


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """The reference's multi-process corpus: 72 reads of 600-1,400 bp."""
    fq = tmp_path_factory.mktemp("sharded") / "reads.fq"
    _write_corpus(fq)
    return fq


def test_sharded_strategy_e2e_equals_host(reads, tmp_path, monkeypatch):
    """The two-set strategy with ``engine="device"`` on eight CPU shards
    gives the exact host engine's per-read estimates (the twin of the
    reference's test of the same name)."""
    for key, val in {"LRGE_SHARDS": "8", "LRGE_DEVICE_BATCH": "16", "LRGE_DEVICE_ANCHORS": "1024",
                     "LRGE_DEVICE_WINDOW": "64", "LRGE_DEVICE_SUPER": "2", "LRGE_DEVICE_BUCKET": "1024"}.items():
        monkeypatch.setenv(key, val)
    seen = []
    real_init = DeviceOverlapEngine.__init__

    def init(self, index, **kw):
        real_init(self, index, **kw)
        seen.append(len(self.shards))

    monkeypatch.setattr(DeviceOverlapEngine, "__init__", init)
    kw = dict(target_num_reads=48, query_num_reads=16, seed=5)
    est_dev, nm_dev = TwoSetStrategy(
        reads, tmpdir=tmp_path / "a", engine="device", device=[CPU] * 8, **kw
    ).generate_estimates()
    assert seen == [8]
    est_host, nm_host = RefTwoSet(reads, tmpdir=tmp_path / "b", engine="host", **kw).generate_estimates()
    assert nm_dev == nm_host
    np.testing.assert_array_equal(np.asarray(est_dev), np.asarray(est_host))


# (reference strategy, port strategy, arguments)
FILTERS = {
    "twoset": (RefTwoSet, TwoSetStrategy, dict(target_num_reads=48, query_num_reads=16, seed=3)),
    "ava": (RefAva, AvaStrategy, dict(num_reads=48, seed=5)),
    "inverse": (RefTwoSet, TwoSetStrategy, dict(target_num_reads=40, query_num_reads=24, seed=9,
                                                use_min_ref=True)),
}


@pytest.mark.parametrize("case", list(FILTERS))
def test_filter_on_sharded_goes_to_host(reads, tmp_path, monkeypatch, caplog, case):
    ref_cls, port_cls, kw = FILTERS[case]
    monkeypatch.setenv("LRGE_DEVICE_MIN_ROWS", "0")
    monkeypatch.setenv("LRGE_DEVICE_BUCKET", "2048")
    seen = []
    real_init = DeviceOverlapEngine.__init__

    def init(self, index, **kw):
        real_init(self, index, **kw)
        seen.append(len(self.shards))

    monkeypatch.setattr(DeviceOverlapEngine, "__init__", init)
    est_host, nm_host = ref_cls(reads, engine="host", remove_internal=True, tmpdir=tmp_path / "h", **kw
                                ).generate_estimates()
    with caplog.at_level(logging.INFO, logger="lrge"):
        est_dev, nm_dev = port_cls(
            reads, engine="device", device=[CPU] * 2, remove_internal=True, tmpdir=tmp_path / "d", **kw
        ).generate_estimates()
    assert seen == [2]
    assert "-F" in caplog.text and "host engine" in caplog.text
    assert nm_dev == nm_host
    np.testing.assert_array_equal(np.asarray(est_dev), np.asarray(est_host))
