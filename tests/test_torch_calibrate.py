"""The port's calibration (``repro_torch.provision.calibrate``) against the
JAX package's ``repro.provision.calibrate`` on the CPU: the engine runs on
a virtual clock and stops every request at its output length, so the
report does not depend on the weights and every field, floats included,
must be equal. The command line prints the same report."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.provision.calibrate import calibrate as jcalibrate  # noqa: E402
from repro_torch.provision.calibrate import (CalibrationReport,  # noqa: E402
                                             calibrate)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module")
def jax_report():
    return jcalibrate()


def test_calibrate_matches_jax_field_by_field(jax_report):
    got = calibrate(device="cpu")
    assert isinstance(got, CalibrationReport)
    assert [f.name for f in dataclasses.fields(got)] == [
        f.name for f in dataclasses.fields(jax_report)]
    assert got.to_obj() == jax_report.to_obj()
    assert got.windows == 4 and 0 < got.scale <= 1
    assert got.t_budget_effective == (got.t_budget_analytic
                                      * got.b_rank_utilization)


def test_cli_calibrate_cpu_prints_the_report(jax_report):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch", "calibrate", "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout) == jax_report.to_obj()


def test_calibrate_defaults_to_cuda():
    """device=None means the card; without one it raises rather than
    carrying on on the CPU."""
    if torch.cuda.is_available():
        assert calibrate().windows == 4
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            calibrate()
