"""Device index planes of the PyTorch port vs the JAX reference (exact).

Every plane of ``GroupedDeviceIndex.from_host`` and of
``from_jax_planes`` must equal the reference ``GroupedDeviceIndex``
(``n_sub == 1``) for the cuckoo and the bucketed dictionary, with packed
and unpacked postings; the numpy cuckoo builders are copies and must
place keys identically.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny per-op work: intra-op threads only contend with the other workers
torch.set_num_threads(1)
from test_device_engine import make_reads

from lrge_tpu.ops import overlap_jax as ref
from lrge_tpu.ops.index import build_index
from lrge_tpu.platform import Platform, preset_for
from lrge_tpu_torch.ops import overlap as port

CPU = torch.device("cpu")

# (LRGE_NO_CUCKOO, LRGE_NO_PACK) -> expected (cuckoo, packed)
BRANCHES = {
    "cuckoo_packed": ({}, True, True),
    "bucketed_packed": ({"LRGE_NO_CUCKOO": "1"}, False, True),
    "bucketed_unpacked": ({"LRGE_NO_PACK": "1"}, False, False),
}


def small_index(n_targets=60, seed=31337):
    rng = np.random.default_rng(seed)
    genome = bytes(rng.choice(list(b"ACGT"), size=80_000).tolist())
    targets = make_reads(rng, genome, n_targets, 2000, err=0.08)
    names = [f"t{i}".encode() for i in range(n_targets)]
    return build_index(targets, names, preset_for(Platform.NANOPORE, dual=True)), genome, rng


def bucket_bits_for(index):
    n_uniq = max(1, len(np.unique(index.keys)))
    return min(max(int(np.ceil(np.log2(n_uniq))) + 2, 12), 26)


def jax_planes(g) -> dict:
    """The reference index's fields as numpy (single sub-index)."""
    out = {}
    for f in dataclasses.fields(g):
        v = getattr(g, f.name)
        if isinstance(v, list):
            (v,) = v
        out[f.name] = None if v is None else np.asarray(v)
    return out


def build_both(index, monkeypatch, env):
    for key in ("LRGE_NO_CUCKOO", "LRGE_NO_PACK"):
        monkeypatch.delenv(key, raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    bb = bucket_bits_for(index)
    return ref.GroupedDeviceIndex.from_host(index, 1, bucket_bits=bb), port.GroupedDeviceIndex.from_host(
        index, CPU, bucket_bits=bb
    )


def assert_planes_equal(gi, planes):
    for f in dataclasses.fields(gi):
        got, want = getattr(gi, f.name), planes[f.name]
        if got is None or want is None:
            assert got is None and want is None, f.name
        elif isinstance(got, torch.Tensor):
            assert got.dtype == torch.int32, f.name
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f.name)
        else:
            assert got == int(want), f.name


@pytest.fixture(scope="module")
def index():
    return small_index()[0]


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_from_host_planes_match(index, monkeypatch, branch):
    env, cuckoo, packed = BRANCHES[branch]
    jg, gi = build_both(index, monkeypatch, env)
    assert bool(gi.cuckoo_bits) == cuckoo
    assert bool(gi.packed_rid_bits) == packed and bool(gi.packed_dict_bits) == packed
    assert_planes_equal(gi, jax_planes(jg))


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_from_jax_planes_carries_the_index(index, monkeypatch, branch):
    jg, gi = build_both(index, monkeypatch, BRANCHES[branch][0])
    carried = port.GroupedDeviceIndex.from_jax_planes(jax_planes(jg), CPU)
    assert_planes_equal(carried, jax_planes(jg))
    for f in dataclasses.fields(gi):
        a, b = getattr(gi, f.name), getattr(carried, f.name)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b), f.name


def test_cuckoo_builders_match(index):
    keys = np.unique(port._pruned_postings(index)[0]).astype(np.uint32)
    got, want = port._build_cuckoo(keys), ref._build_cuckoo(keys)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])
    # a walk that cannot converge reports failure (the bucketed planes stay)
    assert port._build_cuckoo(keys, max_rounds=1) is None
    assert ref._build_cuckoo(keys, max_rounds=1) is None


@pytest.mark.parametrize("cbits", [10, 17, 26])
def test_cuckoo_slots_lookup_side_matches_build_side(cbits):
    rng = np.random.default_rng(cbits)
    h = np.concatenate(
        [rng.integers(0, 1 << 32, size=5000, dtype=np.uint64), [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]]
    ).astype(np.uint32)
    h1, h2 = port._cuckoo_slots_t(torch.from_numpy(h.astype(np.int64)), cbits)
    r1, r2 = ref._cuckoo_slots(h, cbits)
    np.testing.assert_array_equal(h1.numpy(), r1)
    np.testing.assert_array_equal(h2.numpy(), r2)
    assert int(h1.max()) < (1 << cbits) and int(h2.max()) < (1 << cbits)


def test_numpy_builders_match(index):
    for a, b in zip(port._pruned_postings(index), ref._pruned_postings(index)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port._rank_order(index), ref._rank_order(index))
    for L in (128, 2048, 4096, 32768):
        assert port.minimizer_cap(L) == ref.minimizer_cap(L)
