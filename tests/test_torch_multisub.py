"""Multi-sub device indexes in the PyTorch port vs the JAX reference (exact).

An index whose expected anchors per query exceed 60% of the anchor
buffer is split into ``n_sub`` sub-indexes by target (``rid % n_sub``;
``lrge_tpu/device_engine.py:324-353``), which share one dictionary
lookup and are mapped one at a time.  On seeded corpora of accurate
reads (2% and 0.1% substitutions), every port piece equals its reference
counterpart, run on the CPU (the chain DP through the XLA scan):

* the planes of ``GroupedDeviceIndex.from_host(index, n_sub)`` field by
  field at ``n_sub`` 2 and 3, narrow packed, narrow with
  ``LRGE_NO_PACK=1`` and wide (``-P pb``), and ``from_jax_planes`` taking
  the reference's per-sub lists;
* ``sketch_lookup_many`` (``found``, ``mps``, ``mcount``), ``found_ranges``
  of each sub, and ``map_found_many`` of each sub (ONT and PacBio, with
  and without pair planes);
* ``DeviceOverlapEngine.count_batch``: counts, ``had_mapping``, fallback
  rows and triggers equal the reference engine's and the host engine's,
  for ONT and PacBio, two-set and with pair lists (all-vs-all and
  ``--use-min-ref``), both engines picking ``n_sub`` >= 2 by the rule;
* ``-F`` on a multi-sub index goes to the host (``supports_device_filter``
  is False), and the strategies' ``-F`` results equal the host's;
* the port's CLI on the device path prints what ``python -m lrge_tpu
  --engine host`` prints on a low-error corpus where the default rule
  picks two sub-indexes.

Integer outputs throughout: tolerance 0.
"""

import dataclasses
import gzip
import logging
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny per-op work: intra-op threads only contend with the other workers
torch.set_num_threads(1)
import jax.numpy as jnp
from test_device_engine import make_reads
from test_torch_engine import reference_stdout
from test_torch_index import assert_planes_equal, bucket_bits_for, jax_planes
from test_torch_overlap import plane_inputs

from lrge_tpu.device_engine import DeviceOverlapEngine as RefEngine
from lrge_tpu.engine import OverlapEngine
from lrge_tpu.ops import overlap_jax as ref
from lrge_tpu.ops.encode import make_batches
from lrge_tpu.ops.index import build_index
from lrge_tpu.platform import Platform, preset_for
from lrge_tpu.strategy.ava import AvaStrategy as RefAva
from lrge_tpu.strategy.twoset import TwoSetStrategy as RefTwoSet
from lrge_tpu_torch import cli
from lrge_tpu_torch.device_engine import DeviceOverlapEngine
from lrge_tpu_torch.ops import overlap as port
from lrge_tpu_torch.strategy import AvaStrategy, TwoSetStrategy

CPU = torch.device("cpu")
PRESETS = {
    "ont": preset_for(Platform.NANOPORE, dual=True),
    "ont_ava": preset_for(Platform.NANOPORE, dual=False),
    "pb": preset_for(Platform.PACBIO, dual=True),
    "pb_ava": preset_for(Platform.PACBIO, dual=False),
}


@pytest.fixture(scope="module")
def corpus():
    """A 100 kb genome with a 5 x 400 bp tandem block; 80 targets of 2 kb
    and 24 queries of 2.5 kb at 2% substitutions (1.6x coverage in the
    index, 1.5 postings a key)."""
    rng = np.random.default_rng(4242)
    genome = bytearray(rng.choice(list(b"ACGT"), size=100_000).tolist())
    unit = bytes(rng.choice(list(b"ACGT"), size=400).tolist())
    genome[40_000 : 40_000 + 5 * 400] = unit * 5
    genome = bytes(genome)
    targets = make_reads(rng, genome, 80, 2000, err=0.02)
    queries = make_reads(rng, genome, 24, 2500, err=0.02)
    return SimpleNamespace(
        targets=targets, tnames=[f"t{i}".encode() for i in range(80)],
        queries=queries, qnames=[f"q{i}".encode() for i in range(24)],
    )


@pytest.fixture(scope="module")
def indexes(corpus):
    """The reference's host index of the targets under each preset."""
    return {name: build_index(corpus.targets, corpus.tnames, p) for name, p in PRESETS.items()}


def both_indexes(index, monkeypatch, n_sub, no_pack=False):
    monkeypatch.delenv("LRGE_NO_PACK", raising=False)
    if no_pack:
        monkeypatch.setenv("LRGE_NO_PACK", "1")
    bb = bucket_bits_for(index)
    return (
        ref.GroupedDeviceIndex.from_host(index, n_sub, bucket_bits=bb),
        port.GroupedDeviceIndex.from_host(index, CPU, n_sub=n_sub, bucket_bits=bb),
    )


# (preset, LRGE_NO_PACK)
LAYOUTS = {"narrow_packed": ("ont", False), "narrow_unpacked": ("ont", True), "wide": ("pb", False)}


@pytest.mark.parametrize("n_sub", [2, 3])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_multisub_planes_match(indexes, monkeypatch, layout, n_sub):
    preset, no_pack = LAYOUTS[layout]
    index = indexes[preset]
    jg, gi = both_indexes(index, monkeypatch, n_sub, no_pack)
    assert gi.n_sub == n_sub and gi.cuckoo_bits == 0, "no cuckoo dictionary on several subs"
    assert gi.wide == (preset == "pb") and bool(gi.packed_dict_bits) == (not no_pack)
    planes = jax_planes(jg)
    assert_planes_equal(gi, planes)
    # the reference's own per-sub lists carry across as they are
    lists = {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)}
    lists = {k: ([np.asarray(x) for x in v] if isinstance(v, list) else None if v is None else np.asarray(v))
             for k, v in lists.items()}
    assert_planes_equal(port.GroupedDeviceIndex.from_jax_planes(lists, CPU), planes)
    # each hash's sub ranges tile its global range
    U = len(gi.uoff) - 1
    fu = torch.arange(U)
    spans = [port.found_ranges(fu, gi, s) for s in range(n_sub)]
    np.testing.assert_array_equal(spans[0][0].numpy(), gi.uoff[:-1].numpy())
    for (lo, occ), (lo_next, _) in zip(spans, spans[1:]):
        np.testing.assert_array_equal((lo + occ).numpy(), lo_next.numpy())
    np.testing.assert_array_equal(sum(o for _, o in spans).numpy(), torch.diff(gi.uoff).numpy())
    assert all(int(o.sum()) > 0 for _, o in spans)


def lookup_inputs(corpus, index, *, ava, NB=2, B=8, L=2560):
    """The first super-batch's codes, lengths, dual and self ranks, ids."""
    names, seqs = (corpus.tnames, corpus.targets) if ava else (corpus.qnames, corpus.queries)
    names, seqs = names[: NB * B], seqs[: NB * B]
    codes, lengths, dual, selfr = plane_inputs(index, names, seqs, NB=NB, B=B, L=L)
    ids = np.full((NB, B), -1)
    for g, batch in enumerate(make_batches(seqs, batch_size=B, pad_to=L, pad_batch=True)):
        ids[g] = batch.ids
    return SimpleNamespace(codes=codes, lengths=lengths, dual=dual, selfr=selfr, ids=ids,
                           rows=[seqs[i] if i >= 0 else b"" for i in ids.ravel()])


def ref_lookup(x, jg, p):
    """The reference's shared lookup of the super-batch: ``(found, mps,
    mcount)`` as numpy (ONT: device sketch; PacBio: the host planes)."""
    if jg.wide:
        qhi, qlo, mps, mcount = RefEngine._pb_planes(
            SimpleNamespace(params=p), x.rows, ref.minimizer_cap(x.codes.shape[-1])
        )
        shape = x.ids.shape
        found = ref.pb_lookup_many(
            jnp.asarray(qhi.reshape(*shape, -1)), jnp.asarray(qlo.reshape(*shape, -1)), jg.uhash, jg.uhash_lo,
            jg.uoff, jg.boff, jnp.int32(jg.mid_occ), hash_bits=2 * p.k, bucket_bits=jg.bucket_bits,
            bucket_kmax=jg.bucket_kmax, q_occ_frac=p.q_occ_frac, flatten=True,
        )
        return np.array(found), mps.reshape(*shape, -1), mcount.reshape(shape)
    out = ref.sketch_lookup_many(
        jnp.asarray(x.codes), jnp.asarray(x.lengths), jg.uhash, jg.uoff, jg.boff, jnp.int32(jg.mid_occ),
        k=p.k, w=p.w, bucket_bits=jg.bucket_bits, bucket_kmax=jg.bucket_kmax, q_occ_frac=p.q_occ_frac,
        cuckoo_bits=jg.cuckoo_bits, dict_occ_bits=jg.packed_dict_bits, flatten=True,
    )
    return tuple(np.array(a) for a in out)


@pytest.mark.parametrize("n_sub", [2, 3])
@pytest.mark.parametrize("no_pack", [False, True])
def test_sketch_lookup_many_and_found_ranges_match_jax(corpus, indexes, monkeypatch, no_pack, n_sub):
    index = indexes["ont"]
    p = index.params
    jg, gi = both_indexes(index, monkeypatch, n_sub, no_pack)
    x = lookup_inputs(corpus, index, ava=False)
    want = ref_lookup(x, jg, p)
    got = port.sketch_lookup_many(torch.from_numpy(x.codes), torch.from_numpy(x.lengths), gi, p)
    for g, w, what in zip(got, want, ("found", "mps", "mcount")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=what)
    found = want[0]
    assert (found >= 0).sum() > 1000
    # each sub's ranges: the reference map's own gather of its planes
    fc = np.maximum(found, 0)
    for s in range(n_sub):
        lo, occ = port.found_ranges(got[0], gi, s)
        if jg.packed_dict_bits:
            lo_occ = np.asarray(jg.loocc[s])[fc]
            want_lo, want_occ = lo_occ >> jg.packed_dict_bits, lo_occ & ((1 << jg.packed_dict_bits) - 1)
        else:
            want_lo = np.asarray(jg.lo[s])[fc]
            want_occ = np.asarray(jg.hi[s])[fc] - want_lo
        np.testing.assert_array_equal(lo.numpy(), want_lo)
        np.testing.assert_array_equal(occ.numpy(), np.where(found >= 0, want_occ, 0))


def ref_map_sub(x, found, mps, jg, p, s, *, A, W, want_pairs):
    return ref.map_found_many(
        jnp.asarray(found), jnp.asarray(mps), jnp.asarray(x.lengths), jnp.asarray(x.dual),
        jnp.asarray(x.selfr), jg.loocc[s] if jg.packed_dict_bits else jg.lo[s], jg.hi[s],
        jg.rps if jg.packed_rid_bits else jg.rid, jg.pos, jg.pos, jg.rank, jnp.float32(p.chn_pen_gap()),
        k=p.k, max_gap=p.max_gap, bw=p.bw, min_score=p.min_chain_score, num_anchors=A, window=W,
        no_dual=p.no_dual, no_diag=p.no_diag, max_chain_skip=p.max_chain_skip, packed_pos=True,
        use_pallas=False, pallas_block=8, pallas_interpret=False, with_spans=jg.wide, min_cnt=p.min_cnt,
        want_pairs=want_pairs, packed_rid_bits=jg.packed_rid_bits, packed_dict_bits=jg.packed_dict_bits,
        flatten=True,
    )


# (preset, n_sub, want_pairs, LRGE_NO_PACK)
MAPS = {
    "ont_twoset": ("ont", 2, False, False),
    "ont_ava_pairs": ("ont_ava", 3, True, False),
    "ont_unpacked_pairs": ("ont", 3, True, True),
    "pb_twoset": ("pb", 2, False, False),
    "pb_ava_pairs": ("pb_ava", 3, True, False),
}


@pytest.mark.parametrize("case", list(MAPS))
def test_map_found_many_per_sub_matches_jax(corpus, indexes, monkeypatch, case):
    preset, n_sub, want_pairs, no_pack = MAPS[case]
    index = indexes[preset]
    p = index.params
    jg, gi = both_indexes(index, monkeypatch, n_sub, no_pack)
    x = lookup_inputs(corpus, index, ava=preset.endswith("ava"))
    found, mps, mcount = ref_lookup(x, jg, p)
    A, W = 2560, 32
    t = torch.from_numpy
    totals = 0
    for s in range(n_sub):
        want = ref_map_sub(x, found, mps, jg, p, s, A=A, W=W, want_pairs=want_pairs)
        got = port.map_found_many(
            t(found), t(mps), t(x.lengths), t(x.dual), t(x.selfr), gi, p, num_anchors=A, window=W,
            want_pairs=want_pairs, with_spans=gi.wide, sub=s,
        )
        for g, w_, what in zip(got[:3], want[:3], ("counts", "n_anchors", "max_run")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_), err_msg=f"sub {s} {what}")
        if want_pairs:
            np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]), err_msg=f"sub {s} pairs")
        else:
            assert got[3] is None
        assert (got[0] > 0).sum() >= 3, f"sub {s} maps"
        totals = totals + got[1]
    # the subs split the anchors: their totals add up to the one-sub index's
    one = port.GroupedDeviceIndex.from_host(index, CPU, n_sub=1, bucket_bits=bucket_bits_for(index))
    if not one.cuckoo_bits:  # found is a bucketed slot on both
        whole = port.map_found_many(
            t(found), t(mps), t(x.lengths), t(x.dual), t(x.selfr), one, p, num_anchors=A, window=W,
            with_spans=gi.wide,
        )
        np.testing.assert_array_equal(totals.numpy(), whole[1].numpy())
    # the merged planes: counts summed, n_anchors and max_run maxed, pair planes side by side
    plane, pairs = port.map_subs(
        t(found), t(mps), t(mcount), t(x.lengths), t(x.dual), t(x.selfr), gi, p, num_anchors=A, window=W,
        want_pairs=want_pairs, with_spans=gi.wide,
    )
    subs = [ref_map_sub(x, found, mps, jg, p, s, A=A, W=W, want_pairs=want_pairs) for s in range(n_sub)]
    np.testing.assert_array_equal(plane[..., 0].numpy(), sum(np.asarray(o[0]) for o in subs))
    np.testing.assert_array_equal(plane[..., 1].numpy(), np.max([np.asarray(o[1]) for o in subs], axis=0))
    np.testing.assert_array_equal(plane[..., 3].numpy(), mcount)
    if want_pairs:
        np.testing.assert_array_equal(pairs.numpy(), np.concatenate([np.asarray(o[3]) for o in subs], axis=-1))


# (preset, stream, pairs): "twoset" streams the queries against the
# targets' index; "ava" the targets against their own; "inverse" the
# targets against the queries' index (--use-min-ref)
ENGINES = {
    "ont_twoset": ("ont", "twoset", False),
    "ont_ava": ("ont_ava", "ava", True),
    "ont_inverse": ("ont", "inverse", True),
    "pb_twoset": ("pb", "twoset", False),
    "pb_ava": ("pb_ava", "ava", True),
    "pb_inverse": ("pb", "inverse", True),
}


@pytest.mark.parametrize("case", list(ENGINES))
def test_count_batch_multisub_matches_reference_and_host(corpus, indexes, monkeypatch, case):
    preset, stream, pairs = ENGINES[case]
    c = corpus
    if stream == "inverse":
        index = build_index(c.queries, c.qnames, PRESETS[preset])
        names, seqs = c.tnames, c.targets
    else:
        index = indexes[preset]
        names, seqs = (c.tnames, c.targets) if stream == "ava" else (c.qnames, c.queries)
    monkeypatch.setenv("LRGE_SHARDS", "1")  # the reference's single-device path
    monkeypatch.setenv("LRGE_DEVICE_MIN_ROWS", "0")  # every bucket on the device
    # the reference defaults to r = 0.30 (a TPU v5e calibration), the port to r = 0
    # (its H100 sweep, chip_smoke.py phase 13): one schedule for both
    monkeypatch.setenv("LRGE_HOST_SHARE", "0")
    # one bucket (the reference's CPU backend keeps one unless told
    # otherwise): A = num_anchors; the rule picks 3 subs for the
    # targets' index and 2 for the queries'
    buckets = (4096,)
    monkeypatch.setenv("LRGE_DEVICE_BUCKET", "4096")
    kw = dict(batch_size=8, num_anchors=1536, window=32, length_buckets=buckets)
    refe = RefEngine(index, **kw)
    dev = DeviceOverlapEngine(index, device=CPU, **kw)
    assert refe.sharded is None and refe.gdev.n_sub == (2 if stream == "inverse" else 3)
    assert dev.gdev.n_sub == refe.gdev.n_sub and dev.pb_mode == preset.startswith("pb")
    assert not dev.supports_device_filter()
    want_pairs, got_pairs = ({}, {}) if pairs else (None, None)
    want = refe.count_batch(names, seqs, collect_pairs=want_pairs)
    got = dev.count_batch(names, seqs, collect_pairs=got_pairs)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.had_mapping, want.had_mapping)
    assert got.fallback_rows == want.fallback_rows
    assert dev.fallback_triggers == refe.fallback_triggers
    assert dev.fallback_triggers.total() < len(seqs) // 2, "most rows stay on the device"
    host = OverlapEngine(index).count_overlaps_many(list(zip(names, seqs)), want_pairs=pairs)
    np.testing.assert_array_equal(got.counts, [h[0] for h in host])
    np.testing.assert_array_equal(got.had_mapping, [bool(h[1]) for h in host])
    assert (got.counts > 0).sum() > len(seqs) // 2
    if pairs:
        assert got_pairs.keys() == want_pairs.keys()
        for i, rids in got_pairs.items():
            assert sorted(rids.tolist()) == sorted(want_pairs[i].tolist()) == sorted(host[i][2].tolist())


def write_fastq(path, reads):
    with gzip.open(path, "wb") as fh:
        for i, s in enumerate(reads):
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))


# (reference strategy, port strategy, arguments)
FILTERS = {
    "twoset": (RefTwoSet, TwoSetStrategy, dict(target_num_reads=60, query_num_reads=20, seed=3)),
    "ava": (RefAva, AvaStrategy, dict(num_reads=70, seed=5)),
    "inverse": (RefTwoSet, TwoSetStrategy, dict(target_num_reads=60, query_num_reads=20, seed=9,
                                                use_min_ref=True)),
}


@pytest.mark.parametrize("case", list(FILTERS))
def test_filter_on_multisub_goes_to_host(corpus, tmp_path, monkeypatch, caplog, case):
    ref_cls, port_cls, kw = FILTERS[case]
    fq = tmp_path / "reads.fq.gz"
    write_fastq(fq, corpus.targets + corpus.queries)
    monkeypatch.setenv("LRGE_DEVICE_MIN_ROWS", "0")
    # a small anchor buffer makes the rule split these indexes; record
    # the n_sub of every device engine the strategies build
    seen = []
    real_init = DeviceOverlapEngine.__init__

    def init(self, index, **kw):
        real_init(self, index, num_anchors=512, **kw)
        seen.append(self.gdev.n_sub)

    monkeypatch.setattr(DeviceOverlapEngine, "__init__", init)
    est_host, nm_host = ref_cls(
        fq, engine="host", remove_internal=True, tmpdir=tmp_path / "h", **kw
    ).generate_estimates()
    with caplog.at_level(logging.INFO, logger="lrge"):
        est_dev, nm_dev = port_cls(
            fq, engine="device", device=CPU, remove_internal=True, tmpdir=tmp_path / "d", **kw
        ).generate_estimates()
    assert seen and min(seen) >= 2
    assert "-F" in caplog.text and "host" in caplog.text
    assert nm_dev == nm_host
    np.testing.assert_array_equal(np.asarray(est_dev), np.asarray(est_host))
    # asked directly, the engine refuses a device -F it cannot run
    index = build_index(corpus.targets, corpus.tnames, PRESETS["ont"])
    dev = DeviceOverlapEngine(index, device=CPU)
    assert dev.gdev.n_sub >= 2 and not dev.supports_device_filter()
    with pytest.raises(ValueError, match="supports_device_filter"):
        dev.count_batch(corpus.qnames[:2], corpus.queries[:2], filter_ratio=0.2)


@pytest.fixture(scope="module")
def accurate_reads(tmp_path_factory):
    """The verify-skill corpus at 0.1% substitutions: 500 reads of a
    120 kb genome (~4.5x coverage in a 300-read index, ~4.2 postings a
    key, so the default rule picks two sub-indexes)."""
    rng = np.random.default_rng(99)
    G = 120_000
    genome = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=G, dtype=np.uint8)].tobytes()
    g = np.frombuffer(genome, np.uint8)
    bases = np.frombuffer(b"ACGT", np.uint8)
    rc = bytes.maketrans(b"ACGT", b"TGCA")
    reads = []
    for _ in range(500):
        L = int(np.clip(rng.gamma(3, 600), 300, 5000))
        pos = int(rng.integers(0, G - L))
        arr = g[pos : pos + L].copy()
        ne = rng.binomial(L, 0.001)
        arr[rng.integers(0, L, size=ne)] = bases[rng.integers(0, 4, size=ne)]
        s = arr.tobytes()
        reads.append(s.translate(rc)[::-1] if rng.integers(0, 2) else s)
    path = tmp_path_factory.mktemp("accurate") / "reads.fq.gz"
    write_fastq(path, reads)
    return path


def test_cli_multisub_stdout_equals_reference_host(accurate_reads, monkeypatch, capsys, caplog):
    args = [str(accurate_reads), "-T", "300", "-Q", "80", "-s", "42"]
    monkeypatch.setenv("LRGE_DEVICE_MIN_ROWS", "0")
    with caplog.at_level(logging.DEBUG, logger="lrge"):
        assert cli.main([*args, "--engine", "device", "-qqq"], device=CPU) == 0
    assert "Using device overlap engine on cpu" in caplog.text
    assert "device engine: 2 sub-indexes" in caplog.text
    assert capsys.readouterr().out == reference_stdout([*args, "--engine", "host"])
