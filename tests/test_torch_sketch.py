"""Sketch stage of the PyTorch port vs the JAX reference (exact).

``hash32``, ``sketch_core`` and the 2-bit unpack must equal
``lrge_tpu.ops.sketch_jax`` / ``ops.overlap_jax`` bit for bit on the
``tests/test_sketch.py`` corpora: clean reads, N-bearing reads, reads
shorter than ``w + k``, homopolymers and repeat prefixes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny per-op work: intra-op threads only contend with the other workers
torch.set_num_threads(1)
import jax.numpy as jnp
from test_sketch import random_read

from lrge_tpu.ops.encode import make_batches
from lrge_tpu.ops.overlap_jax import _unpack2bit as ref_unpack2bit
from lrge_tpu.ops.overlap_jax import pack2bit_host as ref_pack2bit
from lrge_tpu.ops.sketch_jax import hash32 as ref_hash32
from lrge_tpu.ops.sketch_jax import sketch_batch as ref_sketch_batch
from lrge_tpu_torch.ops.overlap import _unpack2bit, pack2bit_host
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
