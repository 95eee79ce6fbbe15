"""The port's dynamics and band tasks of `compute` (md, kappa, visc,
vdos, rdf, neb, diffusion, fe) against the JAX package's, each task and
option one parametrised case, as in test_torch_cli_compute.py.

The Langevin thermostat draws its noise from a torch.Generator in the
port and from a PRNGKey in JAX: `fe` is held to JAX in its deterministic
lines, and kappa and visc run their production without an NVT
equilibration (`--equil-steps 0`).
"""
import re

import numpy as np
import pytest

import chip_smoke
from test_torch_cli_compute import (  # noqa: F401 (the fixtures apply)
    DYNAMICS, EAM, _argv, _hop, check_case, float64_models)
from test_torch_cli_verbs import jax_main, port_main, run_both

REL = 1e-8


@pytest.mark.parametrize("case", sorted(DYNAMICS))
def test_compute_as_jax(case, tmp_path):
    check_case(*DYNAMICS[case], tmp_path)


def test_fe_as_jax_where_it_is_deterministic(tmp_path):
    """Frenkel-Ladd: the spring constant, the Einstein crystal's and the
    free centre of mass's terms equal JAX's; the sampled integrand (a
    Langevin run) is finite and printed in the same lines."""
    got, want = run_both(_argv(["compute", "fe", EAM, "Ni", "--supercell",
                                "2", "2", "2", "--k-spring", "2.5",
                                "--n-lambda", "2", "--equil-steps", "10",
                                "--steps", "20"]), tmp_path)
    assert got["rc"] == want["rc"] == 0
    (text, nums), (jtext, jnums) = (chip_smoke.split_numbers(r["stdout"])
                                    for r in (got, want))
    assert text == jtext
    assert all(np.isfinite(float(x)) for x in nums)
    for key in ("spring constant k = ", "F_Einstein(3N-3) = ",
                "F_COM(free) = "):
        pattern = re.escape(key) + r"(\S+)"
        a = re.search(pattern, got["stdout"]).group(1).rstrip(";")
        b = re.search(pattern, want["stdout"]).group(1).rstrip(";")
        assert not chip_smoke.printed_mismatches(a, b, REL), key


def test_neb_on_several_devices_raises_by_name(tmp_path):
    """--shards 2 asks for NEB over two devices: without a group of two
    ranks the ValueError of too few devices, and with 9 images (the
    default) JAX's uneven split. (On two ranks it runs:
    test_torch_parallel_analysis.py.)"""
    _hop(tmp_path)
    argv = ["compute", "neb", EAM, "initial.extxyz", "final.extxyz",
            "--shards", "2", "--max-steps", "1"]
    with pytest.raises(ValueError, match="n_shards=2 > 1 available devices"):
        chip_smoke.run_verb(port_main, _argv(argv + ["--n-images", "8"]),
                            tmp_path)
    for main in (port_main, jax_main):
        with pytest.raises(ValueError, match="not divisible by n_shards=2"):
            chip_smoke.run_verb(main, _argv(argv), tmp_path)
