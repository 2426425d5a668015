"""All-vs-all, ``--use-min-ref``, ``-F`` and PacBio through the PyTorch port's CLI vs the JAX reference.

``python -m lrge_tpu_torch`` prints what ``python -m lrge_tpu --engine
host`` prints for ``-n``, ``--use-min-ref``, ``-F``, ``-n -F`` and
``--use-min-ref -F``, and with ``-P pb`` for two-set, ``-n``,
``--use-min-ref`` and ``-F`` (which the device engine routes to the
host, as the reference does), on the verify corpus, both on the port's
host engine and on its device path (here on the CPU); each device run
is a fresh interpreter that loads no ``jax`` and no ``lrge_tpu`` module.
"""

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
}


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


def test_port_modes_never_load_jax(port_device_runs):
    # neither JAX nor the reference package, in any mode
    for mode, lines in port_device_runs.items():
        assert list(lines[-2:]) == NO_FOREIGN_MODULES, mode
