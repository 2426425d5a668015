"""Sketch stage of the PyTorch port vs the JAX reference (exact).

``hash32``, ``sketch_core`` and the 2-bit unpack must equal
``lrge_tpu.ops.sketch_jax`` / ``ops.overlap_jax`` bit for bit on the
``tests/test_sketch.py`` corpora: clean reads, N-bearing reads, reads
shorter than ``w + k``, homopolymers and repeat prefixes.  The
PacBio/HPC sketch (``sketch_hpc``, its plain version on the CPU) must
equal, plane for plane, both the reference engine's host planes
(``lrge_tpu.device_engine.DeviceOverlapEngine._pb_planes``) and the
port's native sketcher with the planes filled here, on the edge reads of
``tests/test_torch_kernel.py`` under each of its parameter sets and at
two capacities; ``ops/encode.py``'s code table must be the native one.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny per-op work: intra-op threads only contend with the other workers
torch.set_num_threads(1)
import jax.numpy as jnp
from test_sketch import random_read
from test_torch_kernel import hpc_planes
from test_torch_pacbio import ref_native  # noqa: F401 (fixture)

from lrge_tpu.device_engine import DeviceOverlapEngine as RefEngine
from lrge_tpu.ops.encode import make_batches
from lrge_tpu.ops.overlap_jax import _unpack2bit as ref_unpack2bit
from lrge_tpu.ops.overlap_jax import pack2bit_host as ref_pack2bit
from lrge_tpu.ops.sketch_jax import hash32 as ref_hash32
from lrge_tpu.ops.sketch_jax import sketch_batch as ref_sketch_batch
from lrge_tpu_torch.native import native
from lrge_tpu_torch.ops.encode import NT4
from lrge_tpu_torch.ops.overlap import _unpack2bit, minimizer_cap, pack2bit_host
from lrge_tpu_torch.ops.sketch_cases import HPC_PARAMS, hpc_edge_reads
from lrge_tpu_torch.ops.sketch import sketch_seqs_native
from lrge_tpu_torch.ops.sketch_torch import hash32, sketch_core


def corpus(name):
    rng = np.random.default_rng(123)
    if name == "clean":
        return [random_read(rng, int(n)) for n in rng.integers(20, 800, size=24)]
    if name == "with_n":
        return [random_read(rng, int(n), 0.02) for n in rng.integers(20, 800, size=24)]
    if name == "short":
        return [b"ACGT" * 3, b"A" * 40, b"ACGTACGTACGTACGTACGTACG", b"ACGTAC", b"G" * 19]
    if name == "repeats":
        return [random_read(rng, u) * 30 + random_read(rng, 100) for u in (1, 2, 7, 16)]
    raise KeyError(name)


@pytest.mark.parametrize("name", ["clean", "with_n", "short", "repeats"])
@pytest.mark.parametrize("w", [5, 2])
def test_sketch_core_matches_jax(name, w):
    k = 15
    for batch in make_batches(corpus(name), batch_size=16, pad_to=128):
        M = batch.codes.shape[1] // 2 + 8
        ref = ref_sketch_batch(
            jnp.asarray(batch.codes), jnp.asarray(batch.lengths), k=k, w=w, max_minimizers=M
        )
        got = sketch_core(
            torch.from_numpy(batch.codes), torch.from_numpy(batch.lengths), k=k, w=w,
            max_minimizers=M,
        )
        for r, g, what in zip(ref, got, ("mhash", "mpos", "mstrand", "mcount")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r).astype(np.int64), err_msg=what)


@pytest.mark.parametrize("k", [15, 16])
def test_hash32_matches_jax(k):
    mask = (1 << (2 * k)) - 1
    rng = np.random.default_rng(0)
    keys = np.concatenate(
        [rng.integers(0, mask + 1, size=4096, dtype=np.uint64), [0, 1, mask - 1, mask]]
    ).astype(np.uint32)
    ref = np.asarray(ref_hash32(jnp.asarray(keys), mask))
    got = hash32(torch.from_numpy(keys.astype(np.int64)), mask).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


def test_unpack2bit_matches_jax():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 5, size=(3, 5, 64), dtype=np.uint8)
    packed = pack2bit_host(codes)
    np.testing.assert_array_equal(packed, ref_pack2bit(codes))
    for L in (64, 61):
        ref = np.asarray(ref_unpack2bit(jnp.asarray(packed), L))
        got = _unpack2bit(torch.from_numpy(packed), L).numpy()
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, (codes & 3)[..., :L])


def native_planes(seqs, params, M):
    """The port's native sketch of ``seqs`` filled into the device planes
    (the 38-bit hash split at bit 19, ``pos << 9 | span << 1 | strand``,
    the true counts), row by row."""
    n = len(seqs)
    qhi = np.full((n, M), -1, np.int32)
    qlo, mps = np.zeros((n, M), np.int32), np.zeros((n, M), np.int32)
    mcount = np.zeros(n, np.int32)
    for i, mz in enumerate(sketch_seqs_native(seqs, params.k, params.w, params.hpc)):
        h = mz.key >> np.uint64(8)
        c = min(len(h), M)
        mcount[i] = len(h)
        qhi[i, :c] = (h >> np.uint64(19)).astype(np.int32)[:c]
        qlo[i, :c] = (h & np.uint64((1 << 19) - 1)).astype(np.int32)[:c]
        span = (mz.key & np.uint64(255)).astype(np.int32)[:c]
        mps[i, :c] = (mz.pos[:c].astype(np.int32) << 9) | (span << 1) | mz.strand[:c].astype(np.int32)
    return qhi, qlo, mps, mcount


@pytest.mark.parametrize("case", list(HPC_PARAMS))
def test_hpc_sketch_matches_native_and_reference(case, ref_native):
    k, w, hpc = HPC_PARAMS[case]
    params = SimpleNamespace(k=k, w=w, hpc=hpc)
    seqs = hpc_edge_reads(np.random.default_rng(7))
    for M in (64, minimizer_cap(2048)):
        got = hpc_planes(seqs, params, M)
        host = native_planes(seqs, params, M)
        ref = RefEngine._pb_planes(SimpleNamespace(params=params), seqs, M)
        for g, h, r, what in zip(got, host, ref, ("qhi", "qlo", "mps", "mcount")):
            assert g.dtype == np.int32, what
            np.testing.assert_array_equal(g, h, err_msg=f"{what}: the port's native sketch")
            np.testing.assert_array_equal(g, r, err_msg=f"{what}: the reference's planes")
    # rows above the small capacity keep their true counts; a 5-base, an
    # empty and an all-N row have none
    assert (got[3] > 64).any() and (got[3][[7, 12, 13]] == 0).all()
    if hpc:
        assert len(np.unique((got[2][got[0] >= 0] >> 1) & 255)) > 3, "HPC spans vary"


def test_nt4_matches_native():
    assert native is not None, "the port's native extension did not build"
    every = bytes(range(256))
    np.testing.assert_array_equal(NT4, np.frombuffer(native.encode_seq(every), np.uint8))
