"""Chain DP of the PyTorch port vs the Pallas kernel it replaces.

``chain_dp_skip_plain`` (the plain PyTorch version the CPU wrapper
runs) must equal ``lrge_tpu.ops.chain_pallas.chain_dp_skip`` in
interpret mode, bit for bit (integer outputs: tolerance 0), and the
host oracle ``ops.chain.chain_dp`` wherever the window covers every
predecessor.  (``test_torch_kernel.py`` holds the CUDA kernel to the
plain version on the card.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny per-op work: intra-op threads only contend with the other workers
torch.set_num_threads(1)

from test_chain_pallas import host_f, make_anchor_rows, make_colinear_rows, run_kernel

from lrge_tpu.platform import AVA_ONT
from lrge_tpu_torch.ops.chain_kernel import chain_dp_skip

KW = dict(span=15, max_gap=AVA_ONT.max_gap, bw=AVA_ONT.bw, max_skip=25)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).astype(np.int32)))


def run_port(key2, rpos, qpos, valid, *, window):
    args = [_t(a) for a in (key2, rpos, qpos, valid, valid.sum(axis=1))]
    f, broke = chain_dp_skip(*args, AVA_ONT.chn_pen_gap(), window=window, **KW)
    return f.numpy(), broke.numpy()


CORPORA = [
    ("anchors", make_anchor_rows, 0),
    ("anchors", make_anchor_rows, 1),
    ("colinear", make_colinear_rows, 7),
]


@pytest.mark.parametrize("window", [16, 32, 64, 128])
@pytest.mark.parametrize("name,maker,seed", CORPORA)
def test_plain_matches_pallas_kernel(name, maker, seed, window):
    rng = np.random.default_rng(seed)
    key2, rpos, qpos, valid, _ = maker(rng, 8, 128)
    f_ref, broke_ref = run_kernel(key2, rpos, qpos, valid, window=window)
    f, broke = run_port(key2, rpos, qpos, valid, window=window)
    np.testing.assert_array_equal(f, f_ref)
    np.testing.assert_array_equal(broke, broke_ref)
    if name == "colinear" and window >= 64:
        assert broke.any(), "corpus must exercise the skip break"


@pytest.mark.parametrize("name,maker,seed", CORPORA)
def test_plain_matches_host_dp(name, maker, seed):
    # W = A covers every predecessor, so scores equal the host oracle
    rng = np.random.default_rng(seed)
    key2, rpos, qpos, valid, rows = maker(rng, 8, 128)
    f, _ = run_port(key2, rpos, qpos, valid, window=128)
    for b in range(8):
        np.testing.assert_array_equal(f[b, : rows[b][4]], host_f(rows, b), err_msg=f"row {b}")
