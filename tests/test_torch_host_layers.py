"""The PyTorch port's own copies of the reference's host layers.

* No module of ``lrge_tpu_torch`` (``parallel/`` and the library
  namespace ``__init__``/``twoset``/``ava`` included) and no line
  of ``chip_smoke.py`` (its rank launcher included) or
  ``chip_profile.py`` imports ``lrge_tpu`` or ``jax`` (an AST scan, lazy
  imports included).
* The copies agree with the originals on small inputs made from a seed:
  the index build, the host engine's counts and pair lists (with the
  native extension and without it), the readers of every input format,
  and the subsampling draw.
* The port's native extension is its own build, not ``lrge_tpu``'s.
"""

import ast
import bz2
import gzip
import lzma
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny per-op work: intra-op threads only contend with the other workers
torch.set_num_threads(1)

import lrge_tpu.native as ref_native
from lrge_tpu.compat import rust_rand as ref_rand
from lrge_tpu.engine import OverlapEngine as RefEngine
from lrge_tpu.io import count_records as ref_count_records
from lrge_tpu.io import iter_records as ref_iter_records
from lrge_tpu.io.bam import write_unaligned_bam
from lrge_tpu.io.cram import write_unaligned_cram
from lrge_tpu.ops.index import build_index as ref_build_index
from lrge_tpu.platform import Platform as RefPlatform
from lrge_tpu.platform import preset_for as ref_preset_for
from lrge_tpu_torch import native as port_native
from lrge_tpu_torch.compat import rust_rand
from lrge_tpu_torch.engine import OverlapEngine
from lrge_tpu_torch.io import count_records, iter_records
from lrge_tpu_torch.ops.index import build_index
from lrge_tpu_torch.platform import Platform, preset_for

REPO = Path(__file__).resolve().parent.parent


def _reference_imports(path: Path, packages=("lrge_tpu",)) -> list:
    """``file:line`` of every import of one of ``packages`` (or a module
    of one) in one source file: import statements at any depth, and
    ``importlib.import_module``/``__import__`` calls on a literal name."""
    hits = []
    is_ref = lambda name: any(name == p or name.startswith(p + ".") for p in packages)
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            fn = node.func
            fname = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if fname in ("import_module", "__import__") and isinstance(node.args[0].value, str):
                names = [node.args[0].value]
        hits += [f"{path.relative_to(REPO)}:{node.lineno}" for n in names if is_ref(n)]
    return hits


def _port_files() -> list:
    return sorted((REPO / "lrge_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "chip_profile.py"]


def test_port_never_imports_reference():
    files = _port_files()
    assert len(files) > 20
    # the library namespace and the device target sketch among them
    surface = {REPO / "lrge_tpu_torch" / f for f in ("__init__.py", "twoset.py", "ava.py", "ops/index.py")}
    assert surface <= set(files)
    assert [h for f in files for h in _reference_imports(f)] == []
    # the scan does see an import of the reference
    probe = REPO / "tests" / "test_torch_host_layers.py"
    assert _reference_imports(probe)


def test_port_never_imports_jax():
    """The same scan for ``jax``, over the port's multi-device and
    multi-process modules as over every other."""
    files = _port_files()
    parallel = {REPO / "lrge_tpu_torch" / "parallel" / f for f in ("__init__.py", "sharded.py", "distributed.py")}
    assert parallel <= set(files)
    assert [h for f in files for h in _reference_imports(f, ("jax", "jaxlib"))] == []
    probe = REPO / "tests" / "test_torch_sharded.py"
    assert _reference_imports(probe, ("jax",))


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(2718)
    genome = rng.choice(list(b"ACGT"), size=40_000).astype(np.uint8).tobytes()
    rc = bytes.maketrans(b"ACGT", b"TGCA")

    def reads(prefix, n, length):
        out = []
        for i in range(n):
            pos = int(rng.integers(0, len(genome) - length))
            s = np.frombuffer(genome[pos : pos + length], np.uint8).copy()
            hit = rng.random(length) < 0.06
            s[hit] = rng.choice(list(b"ACGT"), size=int(hit.sum()))
            s = s.tobytes()
            out.append((b"%s%d" % (prefix, i), s.translate(rc)[::-1] if i % 2 else s))
        return out

    targets, queries = reads(b"t", 60, 1800), reads(b"q", 25, 2200)
    queries[4] = (queries[4][0], queries[4][1][:700] + b"N" + queries[4][1][701:])
    return targets, queries


@pytest.mark.parametrize("dual", [True, False])
def test_build_index_equals_reference(corpus, dual):
    targets, _ = corpus
    seqs, names = [s for _, s in targets], [n for n, _ in targets]
    want = ref_build_index(seqs, names, ref_preset_for(RefPlatform.NANOPORE, dual=dual))
    got = build_index(seqs, names, preset_for(Platform.NANOPORE, dual=dual))
    for field in ("keys", "rid", "pos", "strand", "lengths", "name_rank"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert got.mid_occ == want.mid_occ and got.names == want.names


@pytest.mark.parametrize("with_native", [True, False])
def test_host_engine_equals_reference(corpus, monkeypatch, with_native):
    targets, queries = corpus
    if with_native:
        assert port_native.native is not None and ref_native.native is not None
    else:  # what LRGE_NO_NATIVE=1 gives both packages
        monkeypatch.setattr(port_native, "native", None)
        monkeypatch.setattr(ref_native, "native", None)
    seqs, names = [s for _, s in targets], [n for n, _ in targets]
    ref = RefEngine(ref_build_index(seqs, names, ref_preset_for(RefPlatform.NANOPORE, dual=True)))
    port = OverlapEngine(build_index(seqs, names, preset_for(Platform.NANOPORE, dual=True)))
    assert port.count_overlaps_many(queries) == ref.count_overlaps_many(queries)
    want = ref.count_overlaps_many(queries, want_pairs=True)
    got = port.count_overlaps_many(queries, want_pairs=True)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert any(c > 0 for c, _, _ in want)
    for g, w in zip(got, want):
        assert (g[2] is None) == (w[2] is None)
        if w[2] is not None:
            np.testing.assert_array_equal(g[2], w[2])
    for name, seq in queries[:6]:
        lines = [m.to_line() for m in port.map_read(name, seq)]
        assert lines == [m.to_line() for m in ref.map_read(name, seq)]


FASTQ_RECORDS = [(b"r%d" % i, bytes(np.random.default_rng(i).choice(list(b"ACGTN"), 50 + 7 * i).tolist()))
                 for i in range(12)]


def _fastq(records):
    return b"".join(b"@%s some comment\n%s\n+\n%s\n" % (n, s, b"I" * len(s)) for n, s in records)


def _write(kind, path, records):
    if kind == "fastq":
        path.write_bytes(_fastq(records))
    elif kind == "fastq.gz":
        path.write_bytes(gzip.compress(_fastq(records)))
    elif kind == "fastq.bz2":
        path.write_bytes(bz2.compress(_fastq(records)))
    elif kind == "fastq.xz":
        path.write_bytes(lzma.compress(_fastq(records)))
    elif kind == "fastq.zst":
        import zstandard

        path.write_bytes(zstandard.ZstdCompressor().compress(_fastq(records)))
    elif kind == "fasta":
        # multi-line sequences
        path.write_bytes(b"".join(b">%s desc\n%s\n%s\n" % (n, s[:30], s[30:]) for n, s in records))
    elif kind == "bam":
        write_unaligned_bam(path, records)
    elif kind == "cram":
        write_unaligned_cram(path, records, compress=True)


@pytest.mark.parametrize(
    "kind", ["fastq", "fastq.gz", "fastq.bz2", "fastq.xz", "fastq.zst", "fasta", "bam", "cram"]
)
def test_readers_equal_reference(tmp_path, kind):
    path = tmp_path / f"reads.{kind}"
    _write(kind, path, FASTQ_RECORDS)
    want = list(ref_iter_records(path))
    assert want == FASTQ_RECORDS
    assert list(iter_records(path)) == want
    assert count_records(path) == ref_count_records(path) == len(want)


@pytest.mark.parametrize("seed", [0, 42, 2**40 + 3])
def test_subsample_draw_equals_reference(seed):
    for n_req, n_reads, n_target in ((30, 1000, 20), (15_000, 40_000, 10_000), (5, 5, 2)):
        want = ref_rand.unique_random_set(n_req, n_reads, seed)
        got = rust_rand.unique_random_set(n_req, n_reads, seed)
        assert list(got) == list(want)
        assert rust_rand.split_into_sets(got, n_target) == ref_rand.split_into_sets(want, n_target)


def test_native_extension_is_the_ports_own_build():
    mod = port_native.native
    assert mod is not None and mod is not ref_native.native
    path = Path(mod.__file__).resolve()
    assert path.parent == REPO / "lrge_tpu_torch" / "_build"
    assert path == port_native.library_path()
    assert mod.__name__ == "_lrge_torch_native"
    assert Path(ref_native.native.__file__).resolve().parent == REPO / "lrge_tpu" / "native"
