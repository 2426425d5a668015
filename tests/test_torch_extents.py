"""The ``-F`` extent path and the pair plane of the PyTorch port vs the JAX reference (exact).

* ``chain_dp_skip_plain(extents=True)`` (the CPU path, and the CUDA
  kernel's reference on the card) equals the XLA scan's ``f, broke,
  cnt, starts, rmf``, captured from the reference's reduce on the same
  sorted anchors, at W = 16, 32 and 64.
* ``_reduce_counts`` with pair lists and the extent filter in both
  modes equals the reference's on identical inputs: the captured scan
  outputs, and rows built to force score ties and a valley.
* ``_seg_best(want_slot=True)`` takes the largest slot among tied best
  scores.

Integer outputs throughout: tolerance 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny per-op work: intra-op threads only contend with the other workers
torch.set_num_threads(1)
import jax
import jax.numpy as jnp
from test_device_engine import _contained_corpus
from test_torch_overlap import plane_inputs

from lrge_tpu.io import iter_records
from lrge_tpu.ops import overlap_jax as ref
from lrge_tpu.ops.index import build_index
from lrge_tpu.platform import Platform, preset_for
from lrge_tpu_torch.ops import overlap as port
from lrge_tpu_torch.ops.chain_kernel import IMAX, NEG, chain_dp_skip_plain

PARAMS = preset_for(Platform.NANOPORE, dual=True)
MODES = ["internal", "overhang"]


@pytest.fixture(scope="module")
def contained(tmp_path_factory):
    """80 targets and 40 queries of the containment-rich corpus."""
    reads = list(iter_records(_contained_corpus(tmp_path_factory.mktemp("contained"))))
    names, seqs = [n for n, _ in reads], [s for _, s in reads]
    index = build_index(seqs[:80], names[:80], PARAMS)
    return index, names[80:], seqs[80:]


def capture_scan(monkeypatch, index, names, seqs, W):
    """Run the reference's fused pipeline (``-F``, pairs) and return what
    its XLA scan hands the reduce (a spy on ``_reduce_counts`` returns
    those values from the traced program)."""
    jg = ref.GroupedDeviceIndex.from_host(index, 1)
    codes, lengths, dual, selfr = plane_inputs(index, names, seqs, NB=1, B=len(seqs), L=2816)
    seen = {}
    reduce = ref._reduce_counts

    def spy(f, broke, rid_s, key2_s, valid_s, *args, extents=None, **kw):
        seen.update(
            f=f, broke=broke, rid_s=rid_s, key2_s=key2_s, valid_s=valid_s,
            **{k: v for k, v in extents.items() if k in ("starts", "rmf", "cnt", "rpos", "qpos", "qlen")},
        )
        return reduce(f, broke, rid_s, key2_s, valid_s, *args, extents=extents, **kw)

    monkeypatch.setattr(ref, "_reduce_counts", spy)
    p = PARAMS

    def run(codes_p, lengths, dual, selfr):
        ref.sketch_map_many_core(
            codes_p, lengths, dual, selfr, jg.uhash, jg.uoff, jg.boff,
            jg.loocc[0] if jg.packed_dict_bits else jg.lo[0], jg.hi[0],
            jg.rps if jg.packed_rid_bits else jg.rid, jg.pos, jg.rank, jnp.int32(jg.mid_occ),
            jnp.float32(p.chn_pen_gap()), k=p.k, w=p.w, bucket_bits=jg.bucket_bits,
            bucket_kmax=jg.bucket_kmax, q_occ_frac=p.q_occ_frac, max_gap=p.max_gap, bw=p.bw,
            min_score=p.min_chain_score, num_anchors=2816, window=W, no_dual=p.no_dual,
            no_diag=p.no_diag, max_chain_skip=p.max_chain_skip, packed_pos=True,
            want_pairs=True, packed_rid_bits=jg.packed_rid_bits,
            packed_dict_bits=jg.packed_dict_bits, sort_rows=False, flatten=True,
            want_extents=True, idx_tlen=jg.tlen, cuckoo_bits=jg.cuckoo_bits, packed_codes=True,
        )
        return dict(seen)

    args = (ref.pack2bit_host(codes), lengths, dual, selfr)
    out = {k: np.asarray(v) for k, v in jax.jit(run)(*map(jnp.asarray, args)).items()}
    out["tlen"] = np.asarray(jg.tlen)
    return out


@pytest.mark.parametrize("window", [16, 32, 64])
def test_plain_extents_match_xla_scan(contained, monkeypatch, window):
    index, names, seqs = contained
    scan = capture_scan(monkeypatch, index, names, seqs, window)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x.astype(np.int32)))
    valid = scan["valid_s"]
    got = chain_dp_skip_plain(
        t(scan["key2_s"]), t(scan["rpos"]), t(scan["qpos"]), t(valid), t(valid.sum(axis=1)),
        PARAMS.chn_pen_gap(), span=PARAMS.k, max_gap=PARAMS.max_gap, bw=PARAMS.bw,
        max_skip=PARAMS.max_chain_skip, window=window, extents=True,
    )
    for name, g in zip(("f", "broke", "cnt", "starts", "rmf"), got):
        np.testing.assert_array_equal(g.numpy(), scan[name].astype(np.int32), err_msg=name)
    assert (scan["cnt"] > 20).any() and (scan["starts"] != 0).any()
    # the reduce on these inputs, both modes, pairs on
    for mode in MODES:
        assert_reduce_matches(scan, window, mode)


def assert_reduce_matches(x, W, mode):
    """Port and reference ``_reduce_counts`` on the same numpy inputs."""
    B, A = x["f"].shape
    min_score = PARAMS.min_chain_score
    ext = dict(span=PARAMS.k, ratio=0.2, mode=mode)
    want = ref._reduce_counts(
        jnp.asarray(x["f"], jnp.int32), jnp.asarray(x["broke"], bool), jnp.asarray(x["rid_s"], jnp.int32),
        jnp.asarray(x["key2_s"], jnp.int32), jnp.asarray(x["valid_s"], bool), jnp.zeros(B, jnp.int32),
        B, A, W, min_score, want_pairs=True,
        extents=dict(
            ext, starts=jnp.asarray(x["starts"], jnp.int32), rmf=jnp.asarray(x["rmf"], jnp.int32),
            cnt=jnp.asarray(x["cnt"], jnp.int32), rpos=jnp.asarray(x["rpos"], jnp.int32),
            qpos=jnp.asarray(x["qpos"], jnp.int32), qlen=jnp.asarray(x["qlen"], jnp.int32),
            idx_tlen=jnp.asarray(x["tlen"], jnp.int32),
        ),
    )
    L = lambda k: torch.from_numpy(np.asarray(x[k]).astype(np.int64))
    counts, max_run, pairs = port._reduce_counts(
        L("f"), L("broke"), L("rid_s"), L("key2_s"), torch.from_numpy(np.array(x["valid_s"], bool)),
        W, min_score, want_pairs=True,
        extents=dict(
            ext, starts=L("starts"), rmf=L("rmf"), cnt=L("cnt"), rpos=L("rpos"), qpos=L("qpos"),
            qlen=L("qlen"), tlen=torch.from_numpy(np.array(x["tlen"], np.int32)),
        ),
    )
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want[0]), err_msg=f"counts {mode}")
    np.testing.assert_array_equal(max_run.numpy(), np.asarray(want[2]), err_msg=f"max_run {mode}")
    np.testing.assert_array_equal(pairs.numpy(), np.asarray(want[3]), err_msg=f"pairs {mode}")
    return counts.numpy(), max_run.numpy(), pairs.numpy()


def forced_rows():
    """Three rows of two (rid, strand) runs each; qlen = tlen = 1000, span 15.

    Row 0: run rid 3 ties its best score at slots 4 and 8.  The backtrack
    keeps slot 8, a near-full overlap (overhang 15 of 985: below the
    ratio, so dropped in "internal" mode and kept in "overhang" mode);
    slot 4 (overhang 300 of 415) would have given the opposite answers.
    Run rid 5 (overhang 305 of 215) passes in "internal" mode only.
    Row 1: the same, but the best chain of rid 5 holds a valley: the row
    is flagged for the host.
    Row 2: rid 3's best chain is dropped ("internal") while enough
    unclaimed anchors remain for a secondary chain: flagged too."""
    B, A = 3, 32
    x = {k: np.zeros((B, A), np.int64) for k in ("f", "broke", "starts", "rmf", "cnt", "rpos", "qpos")}
    x["f"][:] = NEG
    x["rid_s"] = np.full((B, A), IMAX, np.int64)
    x["key2_s"] = np.full((B, A), IMAX, np.int64)
    for b in range(B):
        x["rid_s"][b, :10], x["rid_s"][b, 10:20] = 3, 5
        x["key2_s"][b, :10], x["key2_s"][b, 10:20] = 6, 10
        x["f"][b, :20] = np.arange(20) + 120
        x["f"][b, [4, 8]] = 200  # the tie in rid 3's run
        x["cnt"][b, :20] = 9
        # rid 3, slot 8: start (15, 15), end (985, 985)
        x["starts"][b, 8], x["rpos"][b, 8], x["qpos"][b, 8] = (15 << 16) | 15, 985, 985
        # rid 3, slot 4: start (300, 15), end (700, 415)
        x["starts"][b, 4], x["rpos"][b, 4], x["qpos"][b, 4] = (300 << 16) | 15, 700, 415
        # rid 5 ends at slot 19: start (500, 20), end (700, 220)
        x["starts"][b, 19], x["rpos"][b, 19], x["qpos"][b, 19] = (500 << 16) | 20, 700, 220
        x["rmf"][b, :20] = 400 << 1
    x["rmf"][1, 19] |= 1  # the valley
    x["cnt"][2, 8] = 2  # rid 3's best chain claims 2 of its 10 anchors
    x["valid_s"] = x["key2_s"] != IMAX
    x["qlen"] = np.full(B, 1000, np.int64)
    x["tlen"] = np.full(8, 1000, np.int32)
    return x


@pytest.mark.parametrize("mode", MODES)
def test_reduce_forced_ties_and_flags_match_jax(mode):
    counts, max_run, pairs = assert_reduce_matches(forced_rows(), 32, mode)
    assert ((counts >> 24) == 1).all(), "the pre-filter had-mapping bit"
    assert ((counts & 0xFFFFFF) == 1).all()
    # slot 8 decides rid 3
    assert pairs[0].tolist()[:2] == ([5, -1] if mode == "internal" else [3, -1])
    assert max_run[1] == 33, "the valley row goes to the host"
    assert max_run[0] == 0
    assert max_run[2] == (33 if mode == "internal" else 0), "a secondary chain could pass"


def test_seg_best_takes_largest_tied_slot():
    rng = np.random.default_rng(4)
    B, A = 16, 96
    f = rng.choice([NEG, 40, 55, 55, 70], size=(B, A)).astype(np.int64)
    rid = np.sort(rng.integers(0, 9, size=(B, A)), axis=1)
    boundary = np.concatenate([np.ones((B, 1), bool), rid[:, 1:] != rid[:, :-1]], axis=1)
    best, slot = port._seg_best(torch.from_numpy(f), torch.from_numpy(boundary), want_slot=True)
    want_best, want_slot = ref._seg_best(
        jnp.asarray(f, jnp.int32), jnp.asarray(boundary), A, B, want_slot=True
    )
    np.testing.assert_array_equal(best.numpy(), np.asarray(want_best))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(want_slot))
    # at each run end: the last slot holding the run's best score
    run_end = np.concatenate([boundary[:, 1:], np.ones((B, 1), bool)], axis=1)
    for b, e in zip(*np.nonzero(run_end)):
        s = e
        while not boundary[b, s]:
            s -= 1
        run = f[b, s : e + 1].clip(-1)
        assert slot[b, e] == s + np.flatnonzero(run == run.max())[-1]
    assert (np.diff(np.sort(f, axis=1), axis=1) == 0).any()
