"""All-vs-all, ``--use-min-ref``, ``-F`` and PacBio through the PyTorch port's CLI vs the JAX reference.

``python -m lrge_tpu_torch`` prints what ``python -m lrge_tpu --engine
host`` prints for ``-n``, ``--use-min-ref``, ``-F``, ``-n -F`` and
``--use-min-ref -F``, and with ``-P pb`` for two-set, ``-n``,
``--use-min-ref`` and ``-F`` (which the device engine routes to the
host, as the reference does), and for the output flags ``-8``, ``-f``,
``--q1``/``--q3`` and ``-F --max-overhang-ratio``, on the verify corpus,
both on the port's host engine and on its device path (here on the
CPU); each device run is a fresh interpreter that loads no ``jax`` and
no ``lrge_tpu`` module.  Two ``-8`` subsamples meet infinite estimates
at the median: one prints ``NaN`` (the median interpolates with weight
0 onto an infinite estimate: inf * 0), one ``inf``.
"""

import logging

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# tiny per-op work: intra-op threads only contend with the other workers
torch.set_num_threads(1)
from test_torch_engine import (  # noqa: F401 (fixture)
    _PORT_RUN, ARGS, NO_FOREIGN_MODULES, REPO, reference_stdout, verify_reads,
)

from lrge_tpu_torch import cli

SEED = ["-s", "42"]
MODES = {
    "ava": ["-n", "200", *SEED],
    "inverse": [*ARGS, "--use-min-ref"],
    "filter": [*ARGS, "-F"],
    "ava_filter": ["-n", "200", *SEED, "-F"],
    "inverse_filter": [*ARGS, "--use-min-ref", "-F"],
    "pacbio": [*ARGS, "-P", "pb"],
    "pacbio_ava": ["-n", "200", *SEED, "-P", "pb"],
    "pacbio_inverse": [*ARGS, "--use-min-ref", "-P", "pb"],
    "pacbio_filter": [*ARGS, "-P", "pb", "-F"],
    "with_infinity": [*ARGS, "-8"],
    "precise": [*ARGS, "-f"],
    "quantiles": [*ARGS, "--q1", "0.1", "--q3", "0.9"],
    "overhang_ratio": [*ARGS, "-F", "--max-overhang-ratio", "0.3"],
    # subsamples whose median meets infinite estimates (seeds scanned
    # against the reference)
    "infinite_nan": ["-T", "10", "-Q", "5", "-s", "1", "-8"],
    "infinite_inf": ["-T", "3", "-Q", "4", "-s", "1", "-8"],
}
# what the reference prints on the infinite subsamples
INFINITE = {"infinite_nan": "NaN\n", "infinite_inf": "inf\n"}


@pytest.fixture(scope="module")
def port_device_runs(verify_reads):
    """Each mode on the port's device path, in a fresh interpreter (all at
    once): ``{mode: (estimate line, JAX_MODULES line, LRGE_TPU_MODULES line)}``."""
    env = dict(os.environ, PYTHONPATH=str(REPO), LRGE_DEVICE_MIN_ROWS="0")
    env.pop("JAX_PLATFORMS", None)
    procs = {
        mode: subprocess.Popen(
            [sys.executable, "-c", _PORT_RUN, str(verify_reads), *args, "--engine", "device", "-qqq"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO, env=env,
        )
        for mode, args in MODES.items()
    }
    out = {}
    for mode, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr
        out[mode] = tuple(stdout.splitlines())
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_cli_mode_equals_reference_host(verify_reads, port_device_runs, capsys, mode):
    args = [str(verify_reads), *MODES[mode]]
    want = reference_stdout([*args, "--engine", "host"])
    assert port_device_runs[mode][0] + "\n" == want
    assert cli.main([*args, "--engine", "host", "-qqq"]) == 0
    assert capsys.readouterr().out == want
    assert INFINITE.get(mode, want) == want


def test_quantile_flags_set_the_reference_iqr(verify_reads, caplog, capsys):
    """``--q1``/``--q3`` move only the logged IQR: the port logs the
    reference's estimate line."""
    from lrge_tpu import cli as ref_cli

    args = [str(verify_reads), *MODES["quantiles"], "--engine", "host"]
    lines = []
    for main in (ref_cli.main, cli.main):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="lrge"):
            assert main(args) == 0
        lines.append([r.getMessage() for r in caplog.records if r.getMessage().startswith("Estimated genome size")])
    capsys.readouterr()
    assert len(lines[0]) == 1 and "(IQR: " in lines[0][0]
    assert lines[1] == lines[0]


def test_port_modes_never_load_jax(port_device_runs):
    # neither JAX nor the reference package, in any mode
    for mode, lines in port_device_runs.items():
        assert list(lines[-2:]) == NO_FOREIGN_MODULES, mode
