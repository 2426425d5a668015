"""The library surface of the PyTorch port vs the JAX reference.

The twin of ``tests/test_library_api.py`` (reference: `lib.rs:21-57` doc
examples) against ``lrge_tpu_torch``; the port's ``__all__`` equals the
reference's and every name is the port's own object; and the two-set
and all-vs-all doc examples, run on the port's device engine (here on
the CPU), give the reference host engine's result exactly (estimate,
quantiles and no-mapping count; tolerance 0).
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny per-op work: intra-op threads only contend with the other workers
torch.set_num_threads(1)
from test_library_api import reads_file  # noqa: F401 (fixture)

import lrge_tpu
import lrge_tpu_torch

CPU = torch.device("cpu")


def test_twoset_doc_example(reads_file, tmp_path):
    from lrge_tpu_torch import Estimate, twoset
    from lrge_tpu_torch.estimate import LOWER_QUANTILE, UPPER_QUANTILE

    strategy = (
        twoset.Builder()
        .target_num_reads(100)
        .query_num_reads(40)
        .threads(2)
        .seed(42)
        .tmpdir(tmp_path)
        .build(reads_file)
    )
    assert isinstance(strategy, Estimate)
    result = strategy.estimate(True, LOWER_QUANTILE, UPPER_QUANTILE)
    assert result.estimate is not None and result.estimate > 0
    assert result.no_mapping_count >= 0


def test_ava_doc_example(reads_file, tmp_path):
    from lrge_tpu_torch import ava
    from lrge_tpu_torch.ava import DEFAULT_AVA_NUM_READS

    assert DEFAULT_AVA_NUM_READS == 25_000
    strategy = (
        ava.Builder().num_reads(100).threads(2).seed(42).tmpdir(tmp_path).build(reads_file)
    )
    result = strategy.estimate(finite=True)
    assert result.estimate is not None and result.estimate > 0


def test_platform_from_str():
    from lrge_tpu_torch import Platform

    for s in ("pacbio", "pb", "PacBio"):
        assert Platform.from_str(s) is Platform.PACBIO
    for s in ("nanopore", "ont", "ONT"):
        assert Platform.from_str(s) is Platform.NANOPORE
    from lrge_tpu_torch.errors import InvalidPlatformError

    with pytest.raises(InvalidPlatformError):
        Platform.from_str("illumina")


def test_module_constants():
    assert lrge_tpu_torch.DEFAULT_TARGET_NUM_READS == 10_000
    assert lrge_tpu_torch.DEFAULT_QUERY_NUM_READS == 5_000
    assert lrge_tpu_torch.LOWER_QUANTILE == 0.15
    assert lrge_tpu_torch.UPPER_QUANTILE == 0.65
    assert lrge_tpu_torch.twoset.DEFAULT_TARGET_NUM_READS == 10_000


def _home(obj) -> str:
    """The module that defines ``obj`` (a module's own name; an instance's
    class's module)."""
    if isinstance(obj, types.ModuleType):
        return obj.__name__
    if isinstance(obj, type) or callable(obj):
        return obj.__module__
    return type(obj).__module__


def test_namespace_equals_reference():
    """The same ``__all__`` (package and both namespaces), every name an
    object of the port, never the reference's; constants and presets equal
    the reference's."""
    pairs = [(lrge_tpu_torch, lrge_tpu), (lrge_tpu_torch.twoset, lrge_tpu.twoset),
             (lrge_tpu_torch.ava, lrge_tpu.ava)]
    for mod, ref in pairs:
        assert mod.__all__ == ref.__all__, mod.__name__
        for name in mod.__all__:
            obj, want = getattr(mod, name), getattr(ref, name)
            if isinstance(obj, (int, float)):
                assert obj == want, name
            else:
                assert _home(obj).split(".")[0] == "lrge_tpu_torch", (mod.__name__, name)
                if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
                    assert dataclasses.asdict(obj) == dataclasses.asdict(want), name
    assert lrge_tpu_torch.__version__ == lrge_tpu.__version__
    assert lrge_tpu_torch.twoset.Builder is lrge_tpu_torch.TwoSetBuilder
    assert lrge_tpu_torch.ava.Builder is lrge_tpu_torch.AvaBuilder


def _result(r):
    return (r.estimate, r.lower, r.upper, r.no_mapping_count)


@pytest.mark.parametrize("strategy", ["twoset", "ava"])
def test_doc_example_on_device_equals_reference(reads_file, tmp_path, monkeypatch, strategy):
    """The doc example on the port's device engine over the CPU gives the
    reference host engine's result, same seed (every bucket on the device:
    ``LRGE_DEVICE_MIN_ROWS=0``, from ``tests/conftest.py``)."""
    from lrge_tpu_torch.device_engine import DeviceOverlapEngine

    passes = []
    real = DeviceOverlapEngine.count_batch
    monkeypatch.setattr(DeviceOverlapEngine, "count_batch",
                        lambda self, *a, **k: passes.append(self.device) or real(self, *a, **k))

    def builder(pkg):
        if strategy == "twoset":
            return pkg.twoset.Builder().target_num_reads(100).query_num_reads(40)
        return pkg.ava.Builder().num_reads(100)

    want = (
        builder(lrge_tpu).threads(2).seed(42).tmpdir(tmp_path / "ref").engine("host").build(reads_file)
        .estimate(True, lrge_tpu.LOWER_QUANTILE, lrge_tpu.UPPER_QUANTILE)
    )
    got = (
        builder(lrge_tpu_torch).threads(2).seed(42).tmpdir(tmp_path / "port").engine("device").device(CPU)
        .build(reads_file).estimate(True, lrge_tpu_torch.LOWER_QUANTILE, lrge_tpu_torch.UPPER_QUANTILE)
    )
    assert want.estimate is not None and np.isfinite(want.estimate)
    assert _result(got) == _result(want)
    assert passes and set(passes) == {CPU}
