"""The port's `compute` tasks over databases and frames (scatter,
percentile, dbnum, dbfstd, dedup) against the JAX package's, each one
parametrised case, as in test_torch_cli_compute.py.
"""
import numpy as np
import pytest

import chip_smoke
from test_torch_cli_compute import (  # noqa: F401 (the fixtures apply)
    DATA, SF, _argv, _db, check_case, float64_models)
from test_torch_cli_verbs import port_main
from tensoralloy_tpu_torch.io.sqlite import connect


@pytest.mark.parametrize("case", sorted(DATA))
def test_compute_as_jax(case, tmp_path):
    check_case(*DATA[case], tmp_path)


def test_scatter_reads_the_labels(tmp_path):
    """The scatter CSV's labels are the database's energies."""
    _db(tmp_path)
    rec = chip_smoke.run_verb(port_main, _argv(["compute", "scatter", SF,
                                                "db.db", "--output",
                                                "s.csv"]), tmp_path)
    rows = np.loadtxt(tmp_path / "s.csv", delimiter=",", skiprows=1)
    db = list(connect(str(tmp_path / "db.db")))
    np.testing.assert_array_equal(rows[:, 0], [len(s) for s in db])
    np.testing.assert_allclose(rows[:, 1], [s.energy for s in db],
                               rtol=1e-15)
    assert rec["stdout"].startswith("wrote s.csv; energy MAE/atom = ")
