"""The super-batch programs of the PyTorch port (``ops/program.py``) on the CPU.

On the card every super-batch of the single-device engine is one replay
of a CUDA graph a (bucket, mode); here, on a CPU device, the same
programs run eagerly with the same static inputs and outputs.  On a
seeded corpus (``tests/test_torch_knobs.py``'s) and small shapes:

(a) capture safety: the function of each program (ONT plain, pairs,
    ``-F`` in both filter modes, a multi-sub index, PacBio) dispatches
    no op that blocks the host or copies host data into the graph
    (``aten._local_scalar_dense``, ``aten.nonzero``, ``aten.lift_fresh``),
    the chain DP excluded (on the card it is one launch of the CUDA
    kernel; its plain version here loops on the host);
(b) every super-batch of two buckets runs through its program before
    any output is read, and each output equals, bit for bit: on one ONT
    sub-index, ``lrge_tpu.ops.overlap_jax.sketch_map_many`` (jitted, on
    the CPU), pair planes too; on a multi-sub index and under PacBio, the
    port's eager ``map_subs``/``pb_map_many`` (after ``sketch_hpc``) on
    the same inputs (which
    ``tests/test_torch_multisub.py`` and ``tests/test_torch_pacbio.py``
    hold to the reference);
(c) the engine's program cache: the same mode reuses its program, another
    mode or bucket gets its own, and new index planes drop the cache;
(d) the launch counters under replay (a stub stands for the wrapper's
    counters, which move only on the card);
and a program's own static-buffer discipline (outputs cloned, inputs
checked).  Integer outputs throughout: tolerance 0.
"""

import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny per-op work: intra-op threads only contend with the other workers
torch.set_num_threads(1)
import jax.numpy as jnp
from test_torch_knobs import corpus  # noqa: F401 (fixture)
from torch.utils._python_dispatch import TorchDispatchMode

from lrge_tpu.ops import overlap_jax as ref
from lrge_tpu.ops.index import build_index
from lrge_tpu.platform import Platform, preset_for
from lrge_tpu_torch.device_engine import DeviceOverlapEngine
from lrge_tpu_torch.ops import overlap as port
from lrge_tpu_torch.ops.cuda_lib import add_launches, launch_counts, recorded_launches
from lrge_tpu_torch.ops.program import ProgramKey, SuperBatchProgram, program_function
from lrge_tpu_torch.ops.sketch_torch import sketch_hpc

CPU = torch.device("cpu")
PKG = Path(port.__file__).resolve().parent.parent
# two buckets; SUP = 2 and 1 batches of 4 rows a super-batch
SHAPE = dict(batch_size=4, super_batch=1, length_buckets=(2048, 4096))
FILTERS = {
    "ont": {},
    "ont_pairs": dict(want_pairs=True),
    "ont_filter_internal": dict(want_extents=True, overhang_ratio=0.2, filter_mode="internal"),
    "ont_filter_overhang": dict(want_extents=True, overhang_ratio=0.2, filter_mode="overhang", want_pairs=True),
}
CASES = [*FILTERS, "ont_multi", "pacbio"]


@pytest.fixture(scope="module")
def engines(corpus):  # noqa: F811 (fixture)
    """One engine a branch on the CPU: ONT on one sub-index, ONT on
    several (a small anchor buffer splits it), PacBio."""
    targets, tnames, _, _ = corpus
    ont = build_index(targets, tnames, preset_for(Platform.NANOPORE, dual=True))
    pb = build_index(targets, tnames, preset_for(Platform.PACBIO, dual=True))
    out = {
        "ont": DeviceOverlapEngine(ont, device=CPU, num_anchors=4096, **SHAPE),
        "ont_multi": DeviceOverlapEngine(ont, device=CPU, num_anchors=1024, **SHAPE),
        "pacbio": DeviceOverlapEngine(pb, device=CPU, num_anchors=4096, **SHAPE),
    }
    assert out["ont"].gdev.n_sub == 1 and out["ont_multi"].gdev.n_sub >= 2
    assert out["pacbio"].pb_mode and out["pacbio"].gdev.wide
    return out


def engine_of(engines, case):
    return engines["ont" if case in FILTERS else case]


def super_batches(engine, names, seqs):
    """``{L: [(A, SUP, program arrays), ...]}`` of every bucket that the
    engine's row plan fills, as ``count_batch`` builds them."""
    _, _, bucket_rows = engine.plan_rows(seqs, range(len(seqs)))
    dual, selfr = engine.query_ranks(names)
    out = {}
    for L, rows in bucket_rows.items():
        out[L] = [
            (A, ids.shape[0], engine.program_arrays(codes, lengths, d, s))
            for _, A, codes, lengths, ids, d, s in engine.super_batches(L, rows, seqs, dual, selfr)
        ]
    return out


class HostBound(TorchDispatchMode):
    """Records each op that would sync the host or bake host data into a
    CUDA graph, with the port's innermost source line that dispatched it;
    ``paused`` skips the chain DP."""

    BANNED = {"aten._local_scalar_dense", "aten.nonzero", "aten.lift_fresh"}

    def __init__(self):
        super().__init__()
        self.paused = False
        self.ops = 0
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused:
            self.ops += 1
            name = str(func.overloadpacket)
            if name in self.BANNED:
                where = [f for f in traceback.extract_stack() if Path(f.filename).is_relative_to(PKG)]
                at = f"{Path(where[-1].filename).relative_to(PKG)}:{where[-1].lineno}" if where else "?"
                self.hits.append(f"{name} at {at}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", CASES)
def test_program_function_is_capture_safe(corpus, engines, monkeypatch, case):  # noqa: F811
    _, _, queries, qnames = corpus
    engine = engine_of(engines, case)
    L, batches = next(iter(super_batches(engine, qnames, queries).items()))
    A, SUP, arrays = batches[0]
    prog = engine.program(L, A, SUP, **FILTERS.get(case, {}))
    for dst, a in zip(prog.inputs, arrays):
        dst.copy_(torch.from_numpy(a))
    mode = HostBound()
    real = port.chain_dp_skip

    def chain(*args, **kw):
        mode.paused = True
        try:
            return real(*args, **kw)
        finally:
            mode.paused = False

    monkeypatch.setattr(port, "chain_dp_skip", chain)
    with mode:
        plane, pairs = prog.fn(*prog.inputs)
    assert mode.ops > 100 and plane.shape == (SUP, engine.batch_size, 4)
    assert not mode.hits, mode.hits


def jax_index(engine):
    """The reference's planes of the engine's one-sub index, with the
    engine's dictionary rule."""
    n_uniq = len(np.unique(engine.index.keys))
    bucket_bits = min(max(int(np.ceil(np.log2(n_uniq))) + 2, 12), 26)
    jg = ref.GroupedDeviceIndex.from_host(engine.index, 1, bucket_bits=bucket_bits)
    assert (jg.cuckoo_bits, jg.bucket_bits) == (engine.gdev.cuckoo_bits, engine.gdev.bucket_bits)
    return jg


def jax_sketch_map_many(engine, jg, codes_p, lengths, dual, selfr, *, A, **mode):
    """The reference's jitted ``sketch_map_many`` over ``jg``
    (``flatten`` and ``packed_codes``, the engine's single-sub call):
    ``(plane, pairs or None)`` as numpy."""
    p = engine.params
    filt = dict(overhang_ratio=mode["overhang_ratio"], filter_mode=mode["filter_mode"]) if mode.get(
        "want_extents") else {}
    plane, pairs = ref.sketch_map_many(
        jnp.asarray(codes_p), jnp.asarray(lengths), jnp.asarray(dual), jnp.asarray(selfr),
        jg.uhash, jg.uoff, jg.boff, jg.loocc[0] if jg.packed_dict_bits else jg.lo[0], jg.hi[0],
        jg.rps if jg.packed_rid_bits else jg.rid, jg.pos, jg.rank, jnp.int32(jg.mid_occ),
        jnp.float32(p.chn_pen_gap()), k=p.k, w=p.w, bucket_bits=jg.bucket_bits,
        bucket_kmax=jg.bucket_kmax, q_occ_frac=p.q_occ_frac, max_gap=p.max_gap, bw=p.bw,
        min_score=p.min_chain_score, num_anchors=A, window=engine.window, no_dual=p.no_dual,
        no_diag=p.no_diag, max_chain_skip=p.max_chain_skip, packed_pos=True, min_cnt=p.min_cnt,
        packed_rid_bits=jg.packed_rid_bits, packed_dict_bits=jg.packed_dict_bits, sort_rows=False,
        flatten=True, cuckoo_bits=jg.cuckoo_bits, packed_codes=True, idx_tlen=jg.tlen,
        want_pairs=mode.get("want_pairs", False), want_extents=mode.get("want_extents", False), **filt,
    )
    # without pairs the reference returns a dummy plane
    return np.asarray(plane), np.asarray(pairs) if mode.get("want_pairs") else None


def eager(engine, arrays, A, want_pairs=False):
    """The port's eager multi-sub or PacBio pipeline on the same arrays."""
    t = [torch.from_numpy(a) for a in arrays]
    kw = dict(num_anchors=A, window=engine.window, want_pairs=want_pairs)
    codes, lengths, dual, selfr = t
    if engine.pb_mode:
        p = engine.params
        SUP, B, L = codes.shape
        planes = sketch_hpc(codes.reshape(SUP * B, L), lengths.reshape(SUP * B), k=p.k, w=p.w, hpc=p.hpc,
                            max_minimizers=port.minimizer_cap(L))
        planes = [x.reshape(SUP, B, -1) for x in planes[:3]] + [planes[3].reshape(SUP, B)]
        return port.pb_map_many(*planes, lengths, dual, selfr, engine.gdev, p, **kw)
    found, mps, mcount = port.sketch_lookup_many(codes, lengths, engine.gdev, engine.params)
    return port.map_subs(found, mps, mcount, lengths, dual, selfr, engine.gdev, engine.params, **kw)


@pytest.mark.parametrize("case", [*FILTERS, "ont_multi", "ont_multi_pairs", "pacbio"])
def test_program_runs_equal_reference(corpus, engines, case):  # noqa: F811
    _, _, queries, qnames = corpus
    engine = engine_of(engines, case.replace("_pairs", "") if case.startswith("ont_multi") else case)
    mode = FILTERS.get(case, dict(want_pairs=case.endswith("_pairs")))
    buckets = super_batches(engine, qnames, queries)
    assert len(buckets) == 2 and all(len(b) >= 2 for b in buckets.values())
    # every super-batch (the first two of each bucket) runs before any
    # output is read: an output that aliases a later run would show
    runs = []
    for L, batches in buckets.items():
        for A, SUP, arrays in batches[:2]:
            runs.append((A, arrays, engine.program(L, A, SUP, **mode).run(*arrays)))
    jg = jax_index(engine) if case in FILTERS else None
    for A, arrays, (plane, pairs) in runs:
        if jg is not None:
            want_plane, want_pairs = jax_sketch_map_many(engine, jg, *arrays, A=A, **mode)
        else:
            want_plane, want_pairs = (None if x is None else x.numpy() for x in eager(engine, arrays, A, **mode))
        np.testing.assert_array_equal(plane.numpy(), want_plane)
        assert (pairs is None) == (want_pairs is None) == (not mode.get("want_pairs"))
        if pairs is not None:
            np.testing.assert_array_equal(pairs.numpy(), want_pairs)
    planes = [r[2][0] for r in runs]
    assert any(not torch.equal(planes[0], x) for x in planes[1:]), "the super-batches must differ"
    assert any((x[..., 0] > 0).any() for x in planes), "some row must overlap"


def test_program_cache(corpus):  # noqa: F811
    targets, tnames, queries, qnames = corpus
    index = build_index(targets, tnames, preset_for(Platform.NANOPORE, dual=True))
    engine = DeviceOverlapEngine(index, device=CPU, num_anchors=4096, **SHAPE)
    A, SUP = engine.bucket_shape(2048)
    plain = engine.program(2048, A, SUP)
    assert engine.program(2048, A, SUP) is plain
    # the -F arguments name no other program unless -F is on
    assert engine.program(2048, A, SUP, overhang_ratio=0.5, filter_mode="overhang") is plain
    others = [
        engine.program(2048, A, SUP, want_pairs=True),
        engine.program(2048, A, SUP, want_extents=True),
        engine.program(2048, A, SUP, want_extents=True, filter_mode="overhang"),
        engine.program(2048, A, SUP, want_extents=True, overhang_ratio=0.3),
        engine.program(4096, *engine.bucket_shape(4096)),
    ]
    assert len({id(p) for p in [plain, *others]}) == 6 == len(engine.programs)
    assert plain.key == ProgramKey("ont", 2048, A, SUP, 4)
    # a pass reuses the programs of its buckets and mode
    engine.count_batch(qnames, queries)
    assert len(engine.programs) == 6 and engine.program(2048, A, SUP) is plain
    # new planes: the graphs held the old ones' addresses
    engine.gdev = port.GroupedDeviceIndex.from_host(index, CPU)
    fresh = engine.program(2048, A, SUP)
    assert fresh is not plain and list(engine.programs.values()) == [fresh]


def test_launch_counters_under_replay():
    stub = SimpleNamespace(launches=5, ext_launches=0, span_launches=2, sketch_launches=2)

    def capture():
        # what the wrappers count while a capture records two BASE, one
        # SPAN and one sketch launch into the graph
        stub.launches += 2
        stub.span_launches += 1
        stub.sketch_launches += 1
        return "graph"

    out, recorded = recorded_launches(capture, stub)
    assert out == "graph" and recorded == {"launches": 2, "ext_launches": 0, "span_launches": 1, "sketch_launches": 1}
    # the capture ran nothing on the card
    assert launch_counts(stub) == {"launches": 5, "ext_launches": 0, "span_launches": 2, "sketch_launches": 2}
    for _ in range(3):
        add_launches(recorded, stub)
    assert launch_counts(stub) == {"launches": 11, "ext_launches": 0, "span_launches": 5, "sketch_launches": 5}

    def failed():
        stub.ext_launches += 1
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        recorded_launches(failed, stub)
    assert launch_counts(stub) == {"launches": 11, "ext_launches": 0, "span_launches": 5, "sketch_launches": 5}


def test_program_static_buffers():
    """Each run copies into the static inputs, writes the static outputs
    and returns clones of them; a wrong shape, dtype or count raises."""
    key = ProgramKey("ont", 8, 8, 1, 2)
    prog = SuperBatchProgram(key, lambda x, y: (x * 2 + y, None), [((1, 2), torch.int32, 0)] * 2, CPU)
    first = prog.run(np.array([[1, 2]], np.int32), np.array([[0, 1]], np.int32))
    second = prog.run(np.array([[3, 4]], np.int32), np.array([[0, 0]], np.int32))
    assert first[0].tolist() == [[2, 5]] and second[0].tolist() == [[6, 8]] and first[1] is None
    assert prog.inputs[0].tolist() == [[3, 4]] and prog.outputs[0].tolist() == [[6, 8]]
    assert prog.graph is None and prog.capture_s == 0
    for bad in ((np.zeros((1, 3), np.int32),) * 2, (np.zeros((1, 2), np.int64),) * 2, (np.zeros((1, 2), np.int32),)):
        with pytest.raises(ValueError, match="program"):
            prog.run(*bad)
    with pytest.raises(ValueError, match="branch"):
        program_function(key._replace(branch="sharded"), None, None, window=32)
    with pytest.raises(ValueError, match="-F"):
        program_function(key._replace(branch="pacbio", want_extents=True), None, None, window=32)
