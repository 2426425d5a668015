"""The sharded super-batch programs of the PyTorch port (``ops/program.py``) on the CPU.

On a sharded index the engine runs each super-batch as one ``"query"``
program on the home device (the ONT or the PacBio/HPC sketch of the
codes, then ``query_keep``) and one ``"shard"`` program a shard on its own
device (``shard_count``), the merge outside them
(``parallel/sharded.py::sharded_count_programs``); on the card each is a
CUDA graph, here an eager call with the same static inputs and outputs.
On ``tests/test_sharded.py``'s corpus, over eight CPU devices:

(a) capture safety: the query and shard functions, narrow (ONT) and
    wide (PacBio), dispatch no op that blocks the host or copies host
    data into a graph (``tests/test_torch_graphs.py``'s ``HostBound``),
    the chain DP excluded;
(b) the query program and the shard programs, through
    ``sharded_count_programs``, give the counts, ``n_anchors``,
    ``max_run`` and pair sets of the reference's ``sharded_count_fn`` on
    the 1x8, 2x4 and 4x2 meshes and PacBio on 2x4, and equal the eager
    ``sharded_count`` (the plain version); the query program's planes
    equal the reference's sketch;
(c) ``count_batch`` on eight shards runs every super-batch through one
    query and eight shard program runs, never the eager
    ``sharded_count``, and equals the reference engine under
    ``LRGE_SHARDS=8`` (counts, triggers, pair sets) and the host engine;
(d) the program cache per (shard, bucket, mode): ``warmup`` makes every
    program a pass needs, a second pass makes none, pairs get their own
    shard programs but share the query program, new shard planes drop
    the cache; a program that fails to build raises and nothing falls
    back to the eager count.

Integer outputs throughout: tolerance 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny per-op work: intra-op threads only contend with the other workers
torch.set_num_threads(1)
import jax.numpy as jnp
from test_sharded import corpus  # noqa: F401  (the reference's fixture)
from test_torch_graphs import HostBound
from test_torch_sharded import KNOBS, MESHES, PLATFORMS, target_index

from lrge_tpu.device_engine import DeviceOverlapEngine as RefEngine
from lrge_tpu.engine import OverlapEngine
from lrge_tpu.ops.encode import make_batches
from lrge_tpu.ops.sketch_jax import sketch_batch_exact
from lrge_tpu.parallel import sharded as ref
from lrge_tpu.platform import Platform, preset_for
from lrge_tpu_torch import device_engine
from lrge_tpu_torch.device_engine import DeviceOverlapEngine
from lrge_tpu_torch.ops import overlap as port
from lrge_tpu_torch.ops.overlap import minimizer_cap
from lrge_tpu_torch.ops.program import ProgramKey, SuperBatchProgram, program_function
from lrge_tpu_torch.parallel import ShardedGroupedIndex, sharded_count, sharded_count_programs
from lrge_tpu_torch.parallel import sharded as port_sharded

CPU = torch.device("cpu")
L, A, W = 2048, 2048, 128  # the reference test's bucket, anchors and window
M = minimizer_cap(L)


def programs(index, S, B):
    """The query program and the ``S`` shard programs (pairs on) of one
    super-batch of ``B`` rows in bucket ``L``, over ``index`` sharded in
    ``S`` on ``[cpu] * S``; and the placed shards."""
    p = index.params
    shards = ShardedGroupedIndex.from_host(index, S).place([CPU] * S)

    def make(key, gi):
        return SuperBatchProgram(key, *program_function(key, gi, p, window=W), CPU)

    query = make(ProgramKey("query", L, A, 1, B), shards[0])
    return query, [make(ProgramKey("shard", L, A, 1, B, True, shard=s), gi) for s, gi in enumerate(shards)], shards


def host_planes(corpus, params, wide):  # noqa: F811
    """The reference's query planes of the corpus's queries at ``M``
    minimizer slots (numpy): ``(q0, q1, mps, mcount, codes, lengths)``;
    narrow ``q0`` is the ``mhash`` of ``sketch_batch_exact`` and ``q1`` a
    dummy, wide the native sketch's ``qhi``/``qlo``; ``codes`` are the
    query program's input under both."""
    _, _, queries, _ = corpus
    B = len(queries)
    (batch,) = make_batches(queries, batch_size=B, pad_to=L, length_sorted=False)
    if wide:
        from lrge_tpu.ops.sketch import sketch_seqs_native

        qhi = np.full((B, M), -1, np.int32)
        qlo, mps = (np.zeros((B, M), np.int32) for _ in range(2))
        mcount = np.zeros(B, np.int32)
        for i, mz in enumerate(sketch_seqs_native(queries, params.k, params.w, params.hpc)):
            h38 = mz.key >> np.uint64(8)
            c = min(len(h38), M)
            mcount[i] = len(h38)
            qhi[i, :c] = (h38 >> np.uint64(19)).astype(np.int32)[:c]
            qlo[i, :c] = (h38 & np.uint64((1 << 19) - 1)).astype(np.int32)[:c]
            span = (mz.key & np.uint64(0xFF)).astype(np.int32)
            mps[i, :c] = (mz.pos.astype(np.int32)[:c] << 9) | (span[:c] << 1) | mz.strand.astype(np.int32)[:c]
        return qhi, qlo, mps, mcount, batch.codes, batch.lengths
    mhash, mpos, mstrand, mcount = (np.asarray(x) for x in sketch_batch_exact(
        batch.codes, batch.lengths, k=params.k, w=params.w, max_minimizers=M))
    return (mhash, np.zeros((B, 1), np.int32), (mpos * 2 + mstrand).astype(np.int32), mcount, batch.codes,
            batch.lengths)


def need_native(layout):
    if layout == "wide":
        from lrge_tpu_torch.native import native

        if native is None:
            pytest.skip("native sketcher unavailable")


def pause_chain_dp(monkeypatch, mode):
    """The chain DP runs outside ``mode``'s watch (on the card it is one
    launch of the CUDA kernel; its plain version here loops on the host)."""
    real = port.chain_dp_skip

    def chain(*args, **kw):
        mode.paused = True
        try:
            return real(*args, **kw)
        finally:
            mode.paused = False

    monkeypatch.setattr(port, "chain_dp_skip", chain)


@pytest.mark.parametrize("branch", ["query", "shard"])
@pytest.mark.parametrize("layout", list(PLATFORMS))
def test_sharded_program_functions_are_capture_safe(corpus, monkeypatch, layout, branch):  # noqa: F811
    need_native(layout)
    index = target_index(corpus, layout)
    q0, q1, mps, mcount, codes, lengths = host_planes(corpus, index.params, layout == "wide")
    B = len(lengths)
    query, shard_progs, _ = programs(index, 2, B)
    rows = [lengths[None], np.zeros((1, B), np.int32), np.full((1, B), -1, np.int32)]
    arrays = [codes[None], *rows]
    prog = query if branch == "query" else shard_progs[1]
    if branch == "query":
        for dst, a in zip(query.inputs, arrays):
            dst.copy_(torch.from_numpy(a))
    else:
        planes = [x for x in query.run(*arrays)[:-1] if x is not None]
        for dst, x in zip(prog.inputs, planes):
            dst.copy_(x)
    mode = HostBound()
    pause_chain_dp(monkeypatch, mode)
    with mode:
        out = prog.fn(*prog.inputs)
    assert mode.ops > (20 if branch == "query" else 100) and len(out) == (8 if branch == "query" else 4)
    assert not mode.hits, mode.hits


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_programs_match_reference(corpus, mesh):  # noqa: F811
    n_data, n_index, layout = MESHES[mesh]
    need_native(layout)
    index = target_index(corpus, layout)
    p = index.params
    S = n_data * n_index
    sgi = ref.ShardedGroupedIndex.from_host(index, S)
    fn = ref.sharded_count_fn(
        ref.make_mesh(n_data, n_index), k=p.k, max_gap=p.max_gap, bw=p.bw, min_score=p.min_chain_score,
        num_anchors=A, window=W, no_dual=p.no_dual, no_diag=p.no_diag, q_occ_frac=p.q_occ_frac,
        min_cnt=p.min_cnt, wide=sgi.wide, bucket_bits=sgi.bucket_bits, bucket_kmax=sgi.bucket_kmax,
        packed_rid_bits=sgi.packed_rid_bits, packed_dict_bits=sgi.packed_dict_bits,
    )
    q0, q1, mps, mcount, codes, qlen = host_planes(corpus, p, sgi.wide)
    B = len(qlen)
    qdual, qself = np.zeros(B, np.int32), np.full(B, -1, np.int32)
    want = [np.asarray(x) for x in fn(
        sgi.device_put(ref.make_mesh(n_data, n_index)), jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(mps),
        jnp.asarray(qlen), jnp.asarray(qdual), jnp.asarray(qself), jnp.int32(sgi.mid_occ),
        jnp.float32(p.chn_pen_gap()),
    )]
    query, shard_progs, shards = programs(index, S, B)
    rows = [qlen[None], qdual[None], qself[None]]
    *planes, got_mcount = query.run(codes[None], *rows)
    # the query program's planes are the reference's sketch (the narrow
    # hash as int32, its 0xFFFFFFFF padding wrapped to -1)
    np.testing.assert_array_equal(planes[0].numpy(), q0.astype(np.uint32).view(np.int32))
    assert (planes[1] is None) == (not sgi.wide)
    if sgi.wide:
        np.testing.assert_array_equal(planes[1].numpy(), q1)
    np.testing.assert_array_equal(planes[2].numpy(), mps)
    np.testing.assert_array_equal(got_mcount.numpy(), mcount)
    np.testing.assert_array_equal(planes[4].numpy(), qlen)
    got = sharded_count_programs(shard_progs, *planes)
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))
    plain = sharded_count(
        shards, t(q0), t(q1), t(mps), t(qlen), t(qdual), t(qself), p, num_anchors=A, window=W, want_pairs=True,
    )
    for g, e, w_, what in zip(got[:3], plain[:3], want[:3], ("counts", "n_anchors", "max_run")):
        np.testing.assert_array_equal(g.numpy(), w_, err_msg=what)
        np.testing.assert_array_equal(g.numpy(), e.numpy(), err_msg=what)
    # pair planes: the reference's layout differs, the rid sets agree
    assert got[3].shape == plain[3].shape and got[3].dtype == torch.int32
    np.testing.assert_array_equal(got[3].numpy(), plain[3].numpy())
    for g, w_ in zip(got[3].numpy(), want[3]):
        assert sorted(g[g >= 0].tolist()) == sorted(w_[w_ >= 0].tolist())
    assert (got[0] > 0).sum() > B // 2


def count_runs(monkeypatch):
    """Count :meth:`SuperBatchProgram.run` calls by branch."""
    runs = {}
    real = SuperBatchProgram.run

    def run(self, *arrays):
        runs[self.key.branch] = runs.get(self.key.branch, 0) + 1
        return real(self, *arrays)

    monkeypatch.setattr(SuperBatchProgram, "run", run)
    return runs


def no_plain_count(monkeypatch):
    def plain(*args, **kw):
        raise AssertionError("the engine ran the eager sharded_count")

    monkeypatch.setattr(port_sharded, "sharded_count", plain)


def build_index_for(corpus, platform, dual):  # noqa: F811
    from lrge_tpu.ops.index import build_index

    targets, tnames, _, _ = corpus
    return build_index(targets, tnames, preset_for(platform, dual=dual))


def super_batch_total(engine, seqs) -> int:
    """The super-batches that ``count_batch`` dispatches for ``seqs``."""
    _, _, bucket_rows = engine.plan_rows(seqs, range(len(seqs)))
    return sum(-(-len(rows) // (engine.batch_size * engine.bucket_shape(Lb)[1]))
               for Lb, rows in bucket_rows.items() if rows)


# (preset, stream) as in tests/test_torch_sharded.py
ENGINES = {
    "ont_twoset": (Platform.NANOPORE, "twoset"),
    "ont_ava": (Platform.NANOPORE, "ava"),
    "pb_ava": (Platform.PACBIO, "ava"),
}


@pytest.mark.parametrize("case", list(ENGINES))
def test_count_batch_through_programs_matches_reference(corpus, monkeypatch, case):  # noqa: F811
    platform, stream = ENGINES[case]
    targets, tnames, queries, qnames = corpus
    ava = stream == "ava"
    index = build_index_for(corpus, platform, dual=not ava)
    names, seqs = (tnames, targets) if ava else (qnames, queries)
    for key, val in {**KNOBS, "LRGE_SHARDS": "8"}.items():
        monkeypatch.setenv(key, val)
    refe = RefEngine(index)
    dev = DeviceOverlapEngine(index, device=[CPU] * 8)
    assert dev.sharded is not None and len(dev.shards) == 8
    want_pairs, got_pairs = ({}, {}) if ava else (None, None)
    want = refe.count_batch(names, seqs, collect_pairs=want_pairs)
    no_plain_count(monkeypatch)
    runs = count_runs(monkeypatch)
    got = dev.count_batch(names, seqs, collect_pairs=got_pairs)
    n_super = super_batch_total(dev, seqs)
    assert runs == {"query": n_super, "shard": 8 * n_super} and n_super >= 1
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.had_mapping, want.had_mapping)
    assert got.fallback_rows == want.fallback_rows
    assert dev.fallback_triggers == refe.fallback_triggers
    host = OverlapEngine(index).count_overlaps_many(list(zip(names, seqs)), want_pairs=ava)
    np.testing.assert_array_equal(got.counts, [h[0] for h in host])
    assert (got.counts > 0).sum() > len(seqs) // 4
    if ava:
        assert got_pairs.keys() == want_pairs.keys() and len(got_pairs) > len(seqs) // 2
        for i, rids in got_pairs.items():
            assert sorted(rids.tolist()) == sorted(want_pairs[i].tolist()) == sorted(host[i][2].tolist())


def test_sharded_program_cache(corpus, monkeypatch):  # noqa: F811
    targets, tnames, queries, qnames = corpus
    index = build_index_for(corpus, Platform.NANOPORE, dual=True)
    for key, val in KNOBS.items():
        monkeypatch.setenv(key, val)
    dev = DeviceOverlapEngine(index, device=[CPU] * 4)
    assert len(dev.shards) == 4 and dev.first_shard == 0
    # warmup makes the pass's programs: one query program and four shard
    # programs a bucket that the queries fill
    dev.warmup([len(q) for q in queries])
    made = dict(dev.programs)
    buckets = {k.L for k in made}
    assert buckets == {2048} and len(made) == 5
    assert sorted(k.shard for k in made if k.branch == "shard") == [0, 1, 2, 3]
    assert all(k.shard is None for k in made if k.branch == "query")
    (qkey,) = [k for k in made if k.branch == "query"]
    assert qkey == ProgramKey("query", 2048, *dev.bucket_shape(2048), dev.batch_size)
    no_plain_count(monkeypatch)
    first = dev.count_batch(qnames, queries)
    again = dev.count_batch(qnames, queries)
    assert dev.programs == made and all(dev.programs[k] is p for k, p in made.items())
    np.testing.assert_array_equal(first.counts, again.counts)
    # pairs: four shard programs of their own, the same query program
    dev.count_batch(qnames, queries, collect_pairs={})
    pairs = [k for k in dev.programs if k not in made]
    assert len(pairs) == 4 and all(k.branch == "shard" and k.want_pairs for k in pairs)
    # new shard planes: the graphs held the old ones' addresses
    dev.shards = dev.sharded.place([CPU] * 4)
    query, shard_progs = dev.shard_programs(2048, *dev.bucket_shape(2048), dev.batch_size)
    assert query is not made[qkey] and len(dev.programs) == 5
    assert [p.key.shard for p in shard_progs] == [0, 1, 2, 3]


def test_failed_program_raises_without_fallback(corpus, monkeypatch):  # noqa: F811
    _, _, queries, qnames = corpus
    index = build_index_for(corpus, Platform.NANOPORE, dual=True)
    for key, val in KNOBS.items():
        monkeypatch.setenv(key, val)
    dev = DeviceOverlapEngine(index, device=[CPU] * 2)

    class Broken(SuperBatchProgram):
        def __init__(self, key, *args, **kw):
            if key.branch == "shard":
                raise RuntimeError(f"CUDA graph capture of the super-batch program {key} failed")
            super().__init__(key, *args, **kw)

    monkeypatch.setattr(device_engine, "SuperBatchProgram", Broken)
    no_plain_count(monkeypatch)
    with pytest.raises(RuntimeError, match=r"capture of the super-batch program ProgramKey\(branch='shard'"):
        dev.count_batch(qnames, queries)
    assert not any(k.branch == "shard" for k in dev.programs)
