"""The PacBio/HPC preset on the PyTorch port's device path vs the JAX reference (exact).

Every port function of the wide-key path equals its JAX counterpart,
run on the CPU, on inputs made from a seed with numpy or from the
reference's ``build_index(..., preset_for(Platform.PACBIO, dual=...))``:

* the wide ``GroupedDeviceIndex`` planes, field by field, packed and
  unpacked, and ``None`` where the bucketed dictionary cannot be built;
* the query sketch's planes (``sketch_hpc``, the plain version on the
  CPU, which the programs run) against the reference engine's host
  planes (``_pb_planes``), on the homopolymer and mixed corpora;
* ``_q_occ_drop_wide`` on rows where the filter is active;
* ``_pb_probe`` in both bucket-index branches, and ``pb_lookup_many``;
* the span chain DP (``chain_dp_skip_plain(spans=True)``) against the
  XLA scan's ``f``, ``broke`` and ``cnt``, captured from the reference's
  reduce on the same rows;
* ``map_found_many`` (spans) with and without pairs (no-dual
  and no-diag masks live in the all-vs-all case), and the reduce's
  ``min_cnt`` gate on rows built to hit it;
* the engine's ``count_batch``: counts, ``had_mapping``, fallback rows
  and triggers equal the reference engine's and the host engine's, on
  the mixed corpus and the homopolymer corpus of
  ``tests/test_device_engine.py``, with pair lists in the all-vs-all case.

Integer outputs throughout: tolerance 0.
"""

import fcntl
import importlib
import logging
import os
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny per-op work: intra-op threads only contend with the other workers
torch.set_num_threads(1)
import jax
import jax.numpy as jnp
from test_device_engine import make_reads
from test_torch_index import assert_planes_equal, jax_planes
from test_torch_kernel import hpc_planes
from test_torch_overlap import plane_inputs

import lrge_tpu.native as ref_native_module
from lrge_tpu.device_engine import DeviceOverlapEngine as RefEngine
from lrge_tpu.engine import OverlapEngine
from lrge_tpu.ops import overlap_jax as ref
from lrge_tpu.ops.encode import make_batches
from lrge_tpu.ops.index import build_index
from lrge_tpu.platform import Platform, preset_for
from lrge_tpu_torch.device_engine import DeviceOverlapEngine
from lrge_tpu_torch.ops import overlap as port
from lrge_tpu_torch.ops.chain_kernel import chain_dp_skip_plain

CPU = torch.device("cpu")
PB = preset_for(Platform.PACBIO, dual=True)
PB_AVA = preset_for(Platform.PACBIO, dual=False)


def mixed_corpus():
    """``tests/test_device_engine.py``'s corpus: a 150 kb genome with a
    5 x 400 bp tandem block, 2 kb targets and 2.5 kb queries, 8% errors."""
    rng = np.random.default_rng(31337)
    genome = bytearray(rng.choice(list(b"ACGT"), size=150_000).tolist())
    unit = bytes(rng.choice(list(b"ACGT"), size=400).tolist())
    genome[60_000 : 60_000 + 5 * 400] = unit * 5
    genome = bytes(genome)
    targets = make_reads(rng, genome, 120, 2000, err=0.08)
    queries = make_reads(rng, genome, 40, 2500, err=0.08)
    return targets[:60], queries


def homopolymer_corpus():
    """Its homopolymer-rich corpus: runs of 1-7 bases, 5% errors (HPC
    compression and per-minimizer spans do real work)."""
    rng = np.random.default_rng(97)
    genome = b"".join(bytes([rng.choice(list(b"ACGT"))]) * int(rng.integers(1, 8)) for _ in range(3000))
    targets = make_reads(rng, genome, 50, 1800, err=0.05)
    queries = make_reads(rng, genome, 12, 2000, err=0.05)
    return targets, queries


CORPORA = {"mixed": mixed_corpus, "homopolymer": homopolymer_corpus}


@pytest.fixture(scope="module")
def ref_native():
    """The reference's native extension, which its PacBio planes and
    device engine need.  The reference builds it at its first import,
    with an unlocked g++ into its package directory, so parallel test
    workers in a fresh checkout race that build, and a worker that
    imported a half-written library runs without it.  Such a worker
    loads it again here, one worker at a time, until the build is whole."""
    if ref_native_module.native is None and os.environ.get("LRGE_NO_NATIVE") != "1":
        with open(os.path.join(tempfile.gettempdir(), "lrge_tpu_native_build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            deadline = time.monotonic() + 240  # the reference's own build timeout
            while importlib.reload(ref_native_module).native is None and time.monotonic() < deadline:
                time.sleep(2)
    assert ref_native_module.native is not None, "the reference's native extension did not load"
    return ref_native_module.native


@pytest.fixture(scope="module")
def corpora():
    out = {}
    for name, make in CORPORA.items():
        targets, queries = make()
        tnames = [f"{name[0]}t{i}".encode() for i in range(len(targets))]
        qnames = [f"{name[0]}q{i}".encode() for i in range(len(queries))]
        out[name] = SimpleNamespace(
            targets=targets, tnames=tnames, queries=queries, qnames=qnames,
            index=build_index(targets, tnames, PB),
        )
    return out


def bucket_bits_for(index):
    n_uniq = max(1, len(np.unique(index.keys)))
    return min(max(int(np.ceil(np.log2(n_uniq))) + 2, 12), 26)


def both_indexes(index, monkeypatch, bucket_bits, no_pack=False):
    monkeypatch.delenv("LRGE_NO_PACK", raising=False)
    if no_pack:
        monkeypatch.setenv("LRGE_NO_PACK", "1")
    return (
        ref.GroupedDeviceIndex.from_host(index, 1, bucket_bits=bucket_bits),
        port.GroupedDeviceIndex.from_host(index, CPU, bucket_bits=bucket_bits),
    )


def host_planes(params, seqs, M):
    """``(qhi, qlo, mps, mcount)`` of the port's query sketch for ``seqs``
    (``sketch_hpc`` on the CPU: its plain version)."""
    return hpc_planes(seqs, params, M)


@pytest.mark.parametrize("no_pack", [False, True])
def test_wide_index_planes_match(corpora, monkeypatch, no_pack):
    index = corpora["mixed"].index
    jg, gi = both_indexes(index, monkeypatch, bucket_bits_for(index), no_pack)
    assert gi.wide and gi.cuckoo_bits == 0 and gi.packed_rid_bits == 0
    assert bool(gi.packed_dict_bits) == (not no_pack)
    assert_planes_equal(gi, jax_planes(jg))
    carried = port.GroupedDeviceIndex.from_jax_planes(jax_planes(jg), CPU)
    assert_planes_equal(carried, jax_planes(jg))


def test_wide_index_without_a_dictionary_is_none(corpora, monkeypatch, caplog):
    # 2^8 buckets overflow the 16-key probe: neither side builds the planes
    with caplog.at_level(logging.INFO, logger="lrge"):
        jg, gi = both_indexes(corpora["mixed"].index, monkeypatch, 8)
    assert jg is None and gi is None
    assert "wide-key bucketed dictionary" in caplog.text


def test_pb_planes_match_reference(corpora, ref_native):
    for name in ("homopolymer", "mixed"):
        c = corpora[name]
        seqs = c.queries + [b"", c.queries[0][:30]]
        for M in (128, 768):  # rows above M keep only their first M minimizers
            want = RefEngine._pb_planes(SimpleNamespace(params=PB), seqs, M)
            got = host_planes(PB, seqs, M)
            for g, w, what in zip(got, want, ("qhi", "qlo", "mps", "mcount")):
                assert g.dtype == np.int32, what
                np.testing.assert_array_equal(g, w, err_msg=f"{name} {what}")
        assert (got[3] > 128).any() and len(np.unique((got[2] >> 1) & 255)) > 3


def q_occ_rows(rng):
    """Row 0: one hash 150 times among 50 distinct; row 1: the same low
    plane under 40 distinct high planes (only full hashes count); row 2:
    too few minimizers for the filter; row 3: 40 hashes at random."""
    M = 256
    qhi = np.full((4, M), -1, np.int64)
    qlo = np.zeros((4, M), np.int64)
    qhi[0, :200] = np.concatenate([np.full(150, 4321), np.arange(1000, 1050)])
    qlo[0, :200] = np.concatenate([np.full(150, 77), np.arange(50)])
    qhi[1, :200] = rng.integers(0, 40, 200)
    qlo[1, :200] = 5
    qhi[2, :15], qlo[2, :15] = 9, 9
    qhi[3], qlo[3] = rng.integers(0, 6, M), rng.integers(0, 7, M)
    return qhi, qlo


@pytest.mark.parametrize("mid_occ", [20, 5])
def test_q_occ_drop_wide_matches_jax(mid_occ):
    qhi, qlo = q_occ_rows(np.random.default_rng(mid_occ))
    pad = qhi < 0
    want = np.asarray(ref._q_occ_drop_wide(
        jnp.asarray(qhi, jnp.int32), jnp.asarray(qlo, jnp.int32), jnp.asarray(pad), mid_occ, PB.q_occ_frac,
    ))
    got = port._q_occ_drop_wide(torch.from_numpy(qhi), torch.from_numpy(qlo), torch.from_numpy(pad), mid_occ,
                                PB.q_occ_frac)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, :150].all() and not want[0, 150:200].any()
    assert want[2].any() == (mid_occ < 15), "row 2's 15 minimizers engage the filter at mid_occ 5 only"


def lookup_queries(c):
    """The corpus's queries, a tandem repeat of a target's 60 bp (its
    minimizers hit the index and trip the q_occ filter), and a random
    read (misses), host-sketched."""
    rng = np.random.default_rng(5)
    unit = c.targets[0][100:160]
    noise = bytes(rng.choice(list(b"ACGT"), size=2000).tolist())
    seqs = c.queries[:14] + [unit * 40, noise]
    return host_planes(PB, seqs, 768)


@pytest.mark.parametrize("bucket_bits", [17, 22])
def test_pb_probe_matches_jax(corpora, monkeypatch, bucket_bits):
    # 38 - 17 = 21 >= 19: the bucket comes from qhi alone; 38 - 22 = 16
    # < 19: from both planes
    c = corpora["mixed"]
    jg, gi = both_indexes(c.index, monkeypatch, bucket_bits)
    assert gi.bucket_bits == bucket_bits
    qhi, qlo, _, _ = lookup_queries(c)
    kw = dict(hash_bits=2 * PB.k, bucket_bits=gi.bucket_bits, bucket_kmax=gi.bucket_kmax)
    want = np.asarray(ref._pb_probe(jnp.asarray(qhi), jnp.asarray(qlo), jg.uhash, jg.uhash_lo, jg.boff, **kw))
    got = port._pb_probe(torch.from_numpy(qhi).long(), torch.from_numpy(qlo).long(), gi.uhash, gi.uhash_lo,
                         gi.boff, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 100 and (want[qhi >= 0] < 0).sum() > 100


def test_pb_lookup_many_matches_jax(corpora, monkeypatch):
    c = corpora["mixed"]
    jg, gi = both_indexes(c.index, monkeypatch, bucket_bits_for(c.index))
    qhi, qlo, _, _ = lookup_queries(c)
    qhi, qlo = qhi.reshape(2, 8, -1), qlo.reshape(2, 8, -1)
    want = np.asarray(ref.pb_lookup_many(
        jnp.asarray(qhi), jnp.asarray(qlo), jg.uhash, jg.uhash_lo, jg.uoff, jg.boff, jnp.int32(jg.mid_occ),
        hash_bits=2 * PB.k, bucket_bits=jg.bucket_bits, bucket_kmax=jg.bucket_kmax,
        q_occ_frac=PB.q_occ_frac, flatten=True,
    ))
    got = port.pb_lookup_many(torch.from_numpy(qhi), torch.from_numpy(qlo), gi, hash_bits=2 * PB.k,
                              q_occ_frac=PB.q_occ_frac)
    np.testing.assert_array_equal(got.numpy(), want)
    # the tandem row hits the index but its repeated minimizer is dropped
    raw = port._pb_probe(torch.from_numpy(qhi[1, 6]).long()[None], torch.from_numpy(qlo[1, 6]).long()[None],
                         gi.uhash, gi.uhash_lo, gi.boff, hash_bits=2 * PB.k, bucket_bits=gi.bucket_bits,
                         bucket_kmax=gi.bucket_kmax)
    assert (want >= 0).sum() > 100 and ((raw[0].numpy() >= 0) & (want[1, 6] < 0)).any()


def map_inputs(c, params, monkeypatch, *, ava, no_pack=False, NB=2, B=8, L=2560):
    """The map's inputs for the first super-batch of the corpus: both
    indexes, the reference's lookup result and the host planes, as numpy."""
    index = build_index(c.targets, c.tnames, params) if ava else c.index
    names, seqs = (c.tnames, c.targets) if ava else (c.qnames, c.queries)
    names, seqs = names[: NB * B], seqs[: NB * B]
    jg, gi = both_indexes(index, monkeypatch, bucket_bits_for(index), no_pack)
    _, lengths, dual, selfr = plane_inputs(index, names, seqs, NB=NB, B=B, L=L)
    ids = np.full((NB, B), -1)
    for g, batch in enumerate(make_batches(seqs, batch_size=B, pad_to=L, pad_batch=True)):
        ids[g] = batch.ids
    rows = [seqs[i] if i >= 0 else b"" for i in ids.ravel()]
    qhi, qlo, mps, mcount = host_planes(params, rows, port.minimizer_cap(L))
    qhi, qlo, mps = (a.reshape(NB, B, -1) for a in (qhi, qlo, mps))
    found = np.array(ref.pb_lookup_many(
        jnp.asarray(qhi), jnp.asarray(qlo), jg.uhash, jg.uhash_lo, jg.uoff, jg.boff, jnp.int32(jg.mid_occ),
        hash_bits=2 * params.k, bucket_bits=jg.bucket_bits, bucket_kmax=jg.bucket_kmax,
        q_occ_frac=params.q_occ_frac, flatten=True,
    ))
    return SimpleNamespace(jg=jg, gi=gi, found=found, mps=mps, mcount=mcount.reshape(NB, B), lengths=lengths,
                           dual=dual, selfr=selfr, qhi=qhi, qlo=qlo)


def ref_map(x, params, *, A, W, want_pairs):
    jg = x.jg
    return ref.map_found_many(
        jnp.asarray(x.found), jnp.asarray(x.mps), jnp.asarray(x.lengths), jnp.asarray(x.dual),
        jnp.asarray(x.selfr), jg.loocc[0] if jg.packed_dict_bits else jg.lo[0], jg.hi[0], jg.rid, jg.pos,
        jg.pos, jg.rank, jnp.float32(params.chn_pen_gap()), k=params.k, max_gap=params.max_gap,
        bw=params.bw, min_score=params.min_chain_score, num_anchors=A, window=W, no_dual=params.no_dual,
        no_diag=params.no_diag, max_chain_skip=params.max_chain_skip, packed_pos=True, use_pallas=False,
        pallas_block=8, pallas_interpret=False, with_spans=True, min_cnt=params.min_cnt,
        want_pairs=want_pairs, packed_rid_bits=jg.packed_rid_bits, packed_dict_bits=jg.packed_dict_bits,
        flatten=True,
    )


@pytest.mark.parametrize("case", ["twoset", "twoset_pairs", "ava_pairs", "homopolymer_unpacked"])
def test_map_found_with_spans_matches_jax(corpora, monkeypatch, case):
    ava = case.startswith("ava")
    want_pairs = case.endswith("pairs")
    params = PB_AVA if ava else PB
    c = corpora["homopolymer" if case.startswith("homopolymer") else "mixed"]
    x = map_inputs(c, params, monkeypatch, ava=ava, no_pack=case.endswith("unpacked"))
    assert bool(x.gi.packed_dict_bits) != case.endswith("unpacked")
    A, W = 2560, 32
    want = ref_map(x, params, A=A, W=W, want_pairs=want_pairs)
    t = torch.from_numpy
    got = port.map_found_many(
        t(x.found), t(x.mps), t(x.lengths), t(x.dual), t(x.selfr), x.gi, params, num_anchors=A, window=W,
        want_pairs=want_pairs, with_spans=True,
    )
    for g, w_, what in zip(got[:3], want[:3], ("counts", "n_anchors", "max_run")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_), err_msg=what)
    if want_pairs:
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    else:
        assert got[3] is None
    assert (got[0] > 0).sum() >= 3
    # the whole pipeline entry returns the same counts beside the host mcount
    plane, pairs = port.pb_map_many(
        t(x.qhi), t(x.qlo), t(x.mps), t(x.mcount), t(x.lengths), t(x.dual), t(x.selfr), x.gi, params,
        num_anchors=A, window=W, want_pairs=want_pairs,
    )
    np.testing.assert_array_equal(plane[..., 0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(plane[..., 3].numpy(), x.mcount)


def capture_span_scan(monkeypatch, x, params, *, A, W):
    """What the reference's span scan hands its reduce (``f``, ``broke``,
    ``cnt``, ``key2_s``, ``valid_s``), from a spy on ``_reduce_counts``
    inside the traced program."""
    seen = {}
    reduce = ref._reduce_counts

    def spy(f, broke, rid_s, key2_s, valid_s, *args, cnt=None, **kw):
        seen.update(f=f, broke=broke, cnt=cnt, key2_s=key2_s, valid_s=valid_s)
        return reduce(f, broke, rid_s, key2_s, valid_s, *args, cnt=cnt, **kw)

    monkeypatch.setattr(ref, "_reduce_counts", spy)
    jg = x.jg

    def run(found, mps, lengths, dual, selfr):
        ref.map_found_many_core(
            found, mps, lengths, dual, selfr, jg.loocc[0] if jg.packed_dict_bits else jg.lo[0], jg.hi[0],
            jg.rid, jg.pos, jg.pos, jg.rank, jnp.float32(params.chn_pen_gap()), k=params.k,
            max_gap=params.max_gap, bw=params.bw, min_score=params.min_chain_score, num_anchors=A,
            window=W, no_dual=params.no_dual, no_diag=params.no_diag, max_chain_skip=params.max_chain_skip,
            packed_pos=True, use_pallas=False, pallas_block=8, pallas_interpret=False, with_spans=True,
            min_cnt=params.min_cnt, want_pairs=False, packed_rid_bits=jg.packed_rid_bits,
            packed_dict_bits=jg.packed_dict_bits, flatten=True,
        )
        return dict(seen)

    args = (x.found, x.mps, x.lengths, x.dual, x.selfr)
    return {k: np.asarray(v) for k, v in jax.jit(run)(*map(jnp.asarray, args)).items()}


@pytest.mark.parametrize("corpus", list(CORPORA))
@pytest.mark.parametrize("window", [16, 32, 64])
def test_plain_span_dp_matches_xla_scan(corpora, monkeypatch, corpus, window):
    c = corpora[corpus]
    x = map_inputs(c, PB, monkeypatch, ava=False)
    A = 2560
    scan = capture_span_scan(monkeypatch, x, PB, A=A, W=window)
    t = torch.from_numpy
    key2_s, rpos_s, qpos_s, valid_s = port.pb_anchors(
        t(x.qhi), t(x.qlo), t(x.mps), t(x.lengths), t(x.dual), t(x.selfr), x.gi, PB, num_anchors=A,
    )
    np.testing.assert_array_equal(key2_s.numpy(), scan["key2_s"])
    np.testing.assert_array_equal(valid_s.numpy(), scan["valid_s"])
    i32 = lambda v: v.to(torch.int32).contiguous()
    got = chain_dp_skip_plain(
        i32(key2_s), i32(rpos_s), i32(qpos_s), i32(valid_s), i32(valid_s.sum(dim=1)), PB.chn_pen_gap(),
        span=PB.k, max_gap=PB.max_gap, bw=PB.bw, max_skip=PB.max_chain_skip, window=window, spans=True,
    )
    for name, g in zip(("f", "broke", "cnt"), got):
        np.testing.assert_array_equal(g.numpy(), scan[name].astype(np.int32), err_msg=name)
    # spans vary inside chains, and chains grow
    sp = (qpos_s & 255)[valid_s]
    assert len(torch.unique(sp)) > 3 and (scan["cnt"] > 5).any()


def min_cnt_rows():
    """Two rows of three (rid, strand) runs; each run's best chain scores
    150 (>= min_score 100).  Row 0: chain counts 5, 3 and 4, all pass.
    Row 1: the middle run's best chain holds 2 anchors (< min_cnt 3), so
    the target fails and the row goes to the host."""
    B, A = 2, 24
    x = {k: np.zeros((B, A), np.int64) for k in ("f", "broke", "cnt")}
    x["key2_s"] = np.full((B, A), np.iinfo(np.int32).max, np.int64)
    for b in range(B):
        for r, (lo, hi) in enumerate(((0, 6), (6, 12), (12, 18))):
            x["key2_s"][b, lo:hi] = 4 * r + 2
            x["f"][b, lo:hi] = np.arange(hi - lo) * 20 + 40
            x["f"][b, lo + 4] = 150
            x["cnt"][b, lo:hi] = 5 + r
    x["f"][:, 18:] = -(1 << 30)
    x["cnt"][0, [4, 10, 16]] = (5, 3, 4)
    x["cnt"][1, [4, 10, 16]] = (5, 2, 4)
    x["valid_s"] = x["key2_s"] != np.iinfo(np.int32).max
    x["rid_s"] = np.where(x["valid_s"], x["key2_s"] >> 1, np.iinfo(np.int32).max)
    return x


def test_reduce_min_cnt_gate_matches_jax():
    x = min_cnt_rows()
    B, A = x["f"].shape
    W, min_score = 32, PB.min_chain_score
    J = lambda k, dt=jnp.int32: jnp.asarray(x[k], dt)
    want = ref._reduce_counts(
        J("f"), J("broke", bool), J("rid_s"), J("key2_s"), J("valid_s", bool), jnp.zeros(B, jnp.int32),
        B, A, W, min_score, cnt=J("cnt"), min_cnt=PB.min_cnt, want_pairs=True,
    )
    T = lambda k: torch.from_numpy(x[k])
    counts, max_run, pairs = port._reduce_counts(
        T("f"), T("broke"), T("rid_s"), T("key2_s"), T("valid_s"), W, min_score, want_pairs=True,
        cnt=T("cnt"), min_cnt=PB.min_cnt,
    )
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(max_run.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(pairs.numpy(), np.asarray(want[3]))
    assert counts.tolist() == [3, 2] and max_run.tolist() == [0, W + 1]


@pytest.mark.parametrize("corpus,ava", [("mixed", False), ("homopolymer", False), ("mixed", True)])
def test_count_batch_matches_reference_and_host(corpora, ref_native, monkeypatch, corpus, ava):
    c = corpora[corpus]
    monkeypatch.setenv("LRGE_SHARDS", "1")  # the reference's single-device path
    monkeypatch.setenv("LRGE_DEVICE_MIN_ROWS", "0")  # every bucket on the device
    # the reference defaults to r = 0.30 (a TPU v5e calibration), the port to r = 0
    # (its H100 sweep, chip_smoke.py phase 13): one schedule for both
    monkeypatch.setenv("LRGE_HOST_SHARE", "0")
    buckets = (2048, 4096)
    # the reference's CPU backend keeps one bucket unless told otherwise
    monkeypatch.setenv("LRGE_DEVICE_BUCKET", ",".join(map(str, buckets)))
    if ava:
        index = build_index(c.targets, c.tnames, PB_AVA)
        names, seqs = c.tnames, c.targets
    else:
        index, names, seqs = c.index, c.qnames, c.queries
    kw = dict(batch_size=8, num_anchors=2048, window=32, length_buckets=buckets)
    refe = RefEngine(index, **kw)
    assert refe.pb_mode and refe.device_ok and refe.sharded is None and refe.gdev.n_sub == 1
    want_pairs, got_pairs = ({}, {}) if ava else (None, None)
    want = refe.count_batch(names, seqs, collect_pairs=want_pairs)
    dev = DeviceOverlapEngine(index, device=CPU, **kw)
    assert dev.pb_mode and dev.device_ok and dev.gdev.wide and not dev.supports_device_filter()
    got = dev.count_batch(names, seqs, collect_pairs=got_pairs)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.had_mapping, want.had_mapping)
    assert got.fallback_rows == want.fallback_rows
    assert dev.fallback_triggers == refe.fallback_triggers
    assert dev.fallback_triggers.total() < len(seqs) // 2, "most rows stay on the device"
    host = OverlapEngine(index).count_overlaps_many(list(zip(names, seqs)), want_pairs=ava)
    np.testing.assert_array_equal(got.counts, [h[0] for h in host])
    np.testing.assert_array_equal(got.had_mapping, [bool(h[1]) for h in host])
    if ava:
        assert got_pairs.keys() == want_pairs.keys()
        for i, rids in got_pairs.items():
            assert sorted(rids.tolist()) == sorted(want_pairs[i].tolist()) == sorted(host[i][2].tolist())
