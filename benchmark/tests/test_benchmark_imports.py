"""The import check's whole-name comparison, and what the harness and
the reference import."""

import ast
import shutil
import subprocess
import sys

from benchmark import run, spec


def test_forbidden_modules_compares_whole_top_level_names():
    ok = {"lrge_tpu_torch": 1, "lrge_tpu_torch.ops.index": 1, "jaxtyping": 1, "flaxen": 1, "numpy": 1}
    assert run.forbidden_modules(ok) == []
    bad = dict(ok, **{"lrge_tpu.ops": 1, "jax.numpy": 1, "jaxlib": 1, "flax.linen": 1})
    assert run.forbidden_modules(bad) == ["flax.linen", "jax.numpy", "jaxlib", "lrge_tpu.ops"]


def imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_harness_imports_no_jax_and_the_reference_nothing_of_the_program():
    for path in spec.HERE.rglob("*.py"):
        tops = set(imports(path))
        assert not tops & {"jax", "jaxlib", "flax", "lrge_tpu", "bench"}, path
        if "reference" in path.parts or path.name in ("check.py", "corpus.py", "faults.py"):
            assert not tops & {"lrge_tpu_torch", "torch"}, path


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, benchmark.check, benchmark.faults, benchmark.roofline; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('lrge_tpu_torch', 'lrge_tpu', 'jax', 'torch')]; "
            "sys.exit(1 if bad else 0)")
    assert subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT).returncode == 0


def test_run_without_a_card_or_without_the_program_prints_nothing(tmp_path):
    cmd = [sys.executable, "-m", "benchmark.run", "--workload", "ont.r9_mtb", "--seed", "1", "--seconds", "1",
           "--trace", "0"]
    res = subprocess.run(cmd, cwd=spec.ROOT, capture_output=True, text=True)
    assert res.returncode != 0 and res.stdout == ""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    code = ("import torch; from benchmark import run, spec; "
            "run.run_cell(spec.cell(spec.load(), 'ont.r9_mtb'), 1, 1, False, torch.device('cpu'))")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True)
    assert res.returncode != 0 and "lrge_tpu_torch" in res.stderr and res.stdout == ""
