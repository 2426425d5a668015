"""Lookup stage of the PyTorch port vs the JAX reference (exact).

``sketch_lookup_core`` returns ``(found, mps, mcount, lo, occ)``; each
must equal ``lrge_tpu.ops.overlap_jax.sketch_lookup_core(want_ranges=
True)`` for the cuckoo and the bucketed dictionary, including queries
whose repeated minimizers trip the q_occ filter, and the filter itself
must equal the reference on the ``tests/test_chain_skip.py`` corpus.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny per-op work: intra-op threads only contend with the other workers
torch.set_num_threads(1)
import jax.numpy as jnp
from test_device_engine import make_reads
from test_torch_index import BRANCHES, build_both, small_index

from lrge_tpu.ops import overlap_jax as ref
from lrge_tpu.ops.encode import make_batches
from lrge_tpu.platform import AVA_ONT
from lrge_tpu_torch.ops import overlap as port


@pytest.fixture(scope="module")
def setup():
    index, genome, rng = small_index()
    queries = make_reads(rng, genome, 12, 1800, err=0.08)
    # tandem repeats: one minimizer repeats past mid_occ within the query
    unit = bytes(rng.choice(list(b"ACGT"), size=20).tolist())
    queries += [unit * 90, unit * 40 + genome[1000:2000]]
    queries += [genome[5000:5030], b"ACGTN" * 200]  # short / ambiguous
    (batch,) = make_batches(queries, batch_size=len(queries), pad_to=2048)
    return index, batch


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_sketch_lookup_matches_jax(setup, monkeypatch, branch):
    index, batch = setup
    jg, gi = build_both(index, monkeypatch, BRANCHES[branch][0])
    p = index.params
    want = ref.sketch_lookup_core(
        jnp.asarray(batch.codes), jnp.asarray(batch.lengths), jg.uhash, jg.uoff, jg.boff,
        jnp.int32(jg.mid_occ), k=p.k, w=p.w, bucket_bits=jg.bucket_bits,
        bucket_kmax=jg.bucket_kmax, q_occ_frac=p.q_occ_frac, cuckoo_bits=jg.cuckoo_bits,
        dict_occ_bits=jg.packed_dict_bits, want_ranges=True,
    )
    got = port.sketch_lookup_core(
        torch.from_numpy(batch.codes), torch.from_numpy(batch.lengths), gi, k=p.k, w=p.w,
        q_occ_frac=p.q_occ_frac,
    )
    for g, w_, what in zip(got, want, ("found", "mps", "mcount", "lo", "occ")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_).astype(np.int64), err_msg=what)
    assert (got[0] >= 0).any(), "corpus must hit the index"


def q_occ_corpus():
    """tests/test_chain_skip.py:213: one hash 150 times + 50 distinct
    (dropped), and a query too small for the filter (kept)."""
    M = 256
    mhash = np.full((3, M), 0xFFFFFFFF, dtype=np.uint32)
    mhash[0, :200] = np.concatenate([np.full(150, 12345), np.arange(100000, 100050)])
    mhash[1, :15] = 777
    rng = np.random.default_rng(4)
    mhash[2, :M] = rng.integers(0, 40, size=M)
    return mhash


@pytest.mark.parametrize("mid_occ", [20, 5])
def test_q_occ_filter_matches_jax(mid_occ):
    mhash = q_occ_corpus()
    want = np.asarray(ref._q_occ_drop_narrow(jnp.asarray(mhash), mid_occ, AVA_ONT.q_occ_frac))
    got = port._q_occ_drop_narrow(torch.from_numpy(mhash.astype(np.int64)), mid_occ, AVA_ONT.q_occ_frac)
    np.testing.assert_array_equal(got.numpy(), want)
    if mid_occ == 20:
        assert want[0, :150].all() and not want[0, 150:200].any() and not want[1].any()
