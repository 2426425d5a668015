"""The fused device pipeline of the PyTorch port vs the JAX reference (exact).

The packed ``[NB, B, 4]`` plane (counts, n_anchors, max_run, mcount) of
``sketch_map_many`` must equal ``lrge_tpu.ops.overlap_jax.
sketch_map_many(flatten=True, packed_codes=True)`` on the
``tests/test_device_engine.py`` corpora: two-set queries, all-vs-all
rows (no-dual and no-diag masks live), and dense error-free runs at
window 16, which must produce window-miss rows.  With pair lists and
the ``-F`` extent filter (both modes), the planes and the pair planes
must equal the reference's on a containment-rich corpus.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny per-op work: intra-op threads only contend with the other workers
torch.set_num_threads(1)
import jax.numpy as jnp
from test_device_engine import _contained_corpus, make_reads

from lrge_tpu.ops import overlap_jax as ref
from lrge_tpu.io import iter_records
from lrge_tpu.ops.encode import make_batches
from lrge_tpu.ops.index import build_index
from lrge_tpu.platform import Platform, preset_for
from lrge_tpu_torch.ops import overlap as port


def plane_inputs(index, names, seqs, *, NB, B, L):
    """Codes, lengths, dual ranks and self ranks as the engine builds them."""
    codes = np.full((NB, B, L), 4, dtype=np.uint8)
    lengths = np.zeros((NB, B), dtype=np.int32)
    ids = np.full((NB, B), -1, dtype=np.int32)
    for g, batch in enumerate(make_batches(seqs, batch_size=B, pad_to=L, pad_batch=True)):
        codes[g, :, : batch.codes.shape[1]] = batch.codes
        lengths[g] = batch.lengths
        ids[g] = batch.ids
    sorted_names = sorted(index.names)
    rid_of = {n: i for i, n in enumerate(index.names)}
    dual = np.array([np.searchsorted(np.array(sorted_names, dtype=object), n) for n in names])
    selfr = np.array([index.name_rank[rid_of[n]] if n in rid_of else -1 for n in names])
    dual = np.where(ids >= 0, dual[ids], 0).astype(np.int32) if index.params.no_dual else np.zeros_like(ids)
    selfr = np.where(ids >= 0, selfr[ids], -1).astype(np.int32)
    return codes, lengths, dual, selfr


def run_both(index, names, seqs, *, NB, B, L, A, W, **mode):
    """The port's and the reference's planes; with ``mode`` (pair and
    ``-F`` arguments) also their pair planes: ``(got, want)`` pairs of
    ``(plane, pairs)``."""
    p = index.params
    n_uniq = len(np.unique(index.keys))
    bb = min(max(int(np.ceil(np.log2(n_uniq))) + 2, 12), 26)
    jg = ref.GroupedDeviceIndex.from_host(index, 1, bucket_bits=bb)
    gi = port.GroupedDeviceIndex.from_host(index, torch.device("cpu"), bucket_bits=bb)
    codes, lengths, dual, selfr = plane_inputs(index, names, seqs, NB=NB, B=B, L=L)
    packed_codes = ref.pack2bit_host(codes)
    want = ref.sketch_map_many(
        jnp.asarray(packed_codes), jnp.asarray(lengths), jnp.asarray(dual), jnp.asarray(selfr),
        jg.uhash, jg.uoff, jg.boff, jg.loocc[0] if jg.packed_dict_bits else jg.lo[0], jg.hi[0],
        jg.rps if jg.packed_rid_bits else jg.rid, jg.pos, jg.rank, jnp.int32(jg.mid_occ),
        jnp.float32(p.chn_pen_gap()), k=p.k, w=p.w, bucket_bits=jg.bucket_bits,
        bucket_kmax=jg.bucket_kmax, q_occ_frac=p.q_occ_frac, max_gap=p.max_gap, bw=p.bw,
        min_score=p.min_chain_score, num_anchors=A, window=W, no_dual=p.no_dual,
        no_diag=p.no_diag, max_chain_skip=p.max_chain_skip, packed_pos=True, min_cnt=p.min_cnt,
        packed_rid_bits=jg.packed_rid_bits, packed_dict_bits=jg.packed_dict_bits, sort_rows=False,
        flatten=True, cuckoo_bits=jg.cuckoo_bits, packed_codes=True, idx_tlen=jg.tlen, **mode,
    )
    t = torch.from_numpy
    got = port.sketch_map_many(
        t(packed_codes), t(lengths), t(dual), t(selfr), gi, p, num_anchors=A, window=W, **mode
    )
    if mode:
        return (got[0].numpy(), got[1].numpy()), (np.asarray(want[0]), np.asarray(want[1]))
    assert got[1] is None
    return got[0].numpy(), np.asarray(want[0])


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(31337)
    genome = bytearray(rng.choice(list(b"ACGT"), size=150_000).tolist())
    unit = bytes(rng.choice(list(b"ACGT"), size=400).tolist())
    genome[60_000 : 60_000 + 5 * 400] = unit * 5
    genome = bytes(genome)
    targets = make_reads(rng, genome, 120, 2000, err=0.08)
    tnames = [f"t{i}".encode() for i in range(len(targets))]
    queries = make_reads(rng, genome, 40, 2500, err=0.08)
    qnames = [f"q{i}".encode() for i in range(len(queries))]
    return targets, tnames, queries, qnames


def test_twoset_plane_matches_jax(corpus):
    targets, tnames, queries, qnames = corpus
    index = build_index(targets, tnames, preset_for(Platform.NANOPORE, dual=True))
    got, want = run_both(index, qnames, queries, NB=2, B=32, L=2560, A=2560, W=32)
    np.testing.assert_array_equal(got, want)
    assert (got[..., 0] > 0).sum() > 30, "most queries must overlap"


def test_ava_plane_matches_jax(corpus):
    # targets mapped against their own index: the no-dual and no-diag
    # masks drop anchors
    targets, tnames, _, _ = corpus
    index = build_index(targets[:48], tnames[:48], preset_for(Platform.NANOPORE, dual=False))
    assert index.params.no_dual and index.params.no_diag
    got, want = run_both(index, tnames[:48], targets[:48], NB=1, B=48, L=2048, A=2048, W=64)
    np.testing.assert_array_equal(got, want)


def test_dense_runs_flag_window_misses():
    rng = np.random.default_rng(5)
    genome = bytes(rng.choice(list(b"ACGT"), size=30_000).tolist())
    targets = make_reads(rng, genome, 30, 1500, err=0.0)
    tnames = [f"d{i}".encode() for i in range(30)]
    queries = make_reads(rng, genome, 8, 1500, err=0.0)
    qnames = [f"qq{i}".encode() for i in range(8)]
    index = build_index(targets, tnames, preset_for(Platform.NANOPORE, dual=True))
    got, want = run_both(index, qnames, queries, NB=1, B=8, L=2048, A=2048, W=16)
    np.testing.assert_array_equal(got, want)
    assert (got[..., 2] > 16).any(), "corpus must produce window-miss rows"


@pytest.mark.parametrize("filter_mode", ["internal", "overhang"])
def test_pairs_and_extent_filter_match_jax(tmp_path, filter_mode):
    # short reads contained in long ones: internal and overhang-heavy
    # mappings on both sides of the filter
    reads = list(iter_records(_contained_corpus(tmp_path)))
    names, seqs = [n for n, _ in reads], [s for _, s in reads]
    index = build_index(seqs[:80], names[:80], preset_for(Platform.NANOPORE, dual=True))
    mode = dict(want_pairs=True, want_extents=True, overhang_ratio=0.2, filter_mode=filter_mode)
    (plane, pairs), (want_plane, want_pairs) = run_both(
        index, names[80:], seqs[80:], NB=1, B=40, L=2816, A=2816, W=32, **mode
    )
    np.testing.assert_array_equal(plane, want_plane)
    np.testing.assert_array_equal(pairs, want_pairs)
    counts = plane[..., 0] & 0xFFFFFF
    assert ((plane[..., 0] >> 24) > counts).any(), "the filter must drop some rows' targets"
    assert ((pairs >= 0).sum(axis=-1) == counts).all()
