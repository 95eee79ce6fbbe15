"""The port's molecular dynamics against the JAX package at float64:
Maxwell-Boltzmann velocities bit for bit; NVE trajectories through the
EAM family's fast and autograd routes on host and device lists; NPT
(Berendsen, isotropic and anisotropic) on both lists; a GRAP model's
NVE on the dense layout; the Langevin thermostat by its statistics (its
noise is a torch.Generator's, not JAX's PRNGKey); save/load resuming
exactly; and the constructor's refusals.

The JAX-reference MD fixtures that `chip_smoke.py` holds the card's
float64 NVE against are regenerated with

    python -m tests.test_torch_dynamics
"""
import json
from collections import Counter
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tensoralloy_tpu.atoms import Structure as JaxStructure
from tensoralloy_tpu.dynamics import VelocityVerlet as JaxVelocityVerlet
from tensoralloy_tpu.dynamics import \
    maxwell_boltzmann_velocities as jax_maxwell_boltzmann
from tensoralloy_tpu.io.model import load_model as jax_load_model
from tensoralloy_tpu.nn.atomic import AtomicNN as JaxAtomicNN
from tensoralloy_tpu.nn.eam import EamAlloyNN as JaxEamAlloyNN
from tensoralloy_tpu.nn.grap import GenericRadialAtomicPotential as JaxGrap
from tensoralloy_tpu.transform import Featurizer as JaxFeaturizer
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.dynamics import (FORCE_TO_ACC, KB,
                                            VelocityVerlet,
                                            maxwell_boltzmann_velocities)
from tensoralloy_tpu_torch.io.model import model_from_dict

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
POS_TOL = 1e-9
HIST_REL = 1e-10
# the chip's float64 NVE: the saved mleam_ni model on the 32-atom cell,
# 20 steps of 1 fs from 400 K in chunks of 5
MD_MODEL = "artifacts/mleam_ni/model/snap_Ni_mleam.npz"
MD_RUN = dict(timestep=1.0, chunk_size=5, temperature=400.0, seed=5)
MD_STEPS = 20


def _port_twin(model, params):
    twin = model_from_dict(json.loads(json.dumps(model.as_dict())),
                           device="cpu", dtype=torch.float64)
    twin.load_param_tree(jax.tree_util.tree_map(np.asarray, params))
    return twin


def _fcc(reps=2, a0=3.52, scale=1.0, cell=None):
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    frac = np.concatenate([base + [i, j, k] for i in range(reps)
                           for j in range(reps) for k in range(reps)]) / reps
    cell = np.eye(3) * reps * a0 * scale if cell is None else cell
    symbols = ["Ni"] * len(frac)
    return (JaxStructure.from_symbols(symbols, frac @ cell, cell,
                                      pbc=[True] * 3),
            Structure.from_symbols(symbols, frac @ cell, cell,
                                   pbc=[True] * 3))


def _eam(n, rcut=6.0):
    fz = JaxFeaturizer(["Ni"], rcut=rcut)
    model = JaxEamAlloyNN(fz, Counter({"Ni": n}), custom_potentials="zjw04")
    params = model.init_params(jax.random.PRNGKey(0))
    return model, params, _port_twin(model, params)


def _assert_runs_match(jax_md, jax_hist, md, hist, keys=("potential",
                                                          "kinetic",
                                                          "total")):
    np.testing.assert_allclose(md.structure.positions,
                               jax_md.structure.positions,
                               rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(md.velocities_vap,
                               np.asarray(jax_md.velocities_vap),
                               rtol=0, atol=POS_TOL)
    if "positions" in jax_hist:
        np.testing.assert_allclose(np.asarray(hist["positions"]),
                                   np.asarray(jax_hist["positions"]),
                                   rtol=0, atol=POS_TOL)
    for k in keys:
        np.testing.assert_allclose(hist[k], jax_hist[k], rtol=HIST_REL,
                                   atol=0, err_msg=k)


def test_maxwell_boltzmann_is_jax_bit_for_bit():
    masses = np.full(100, 58.6934)
    masses[::3] = 95.95
    np.testing.assert_array_equal(
        maxwell_boltzmann_velocities(masses, 300.0, seed=4),
        jax_maxwell_boltzmann(masses, 300.0, seed=4))
    v = maxwell_boltzmann_velocities(np.full(500, 58.69), 300.0, seed=1)
    np.testing.assert_allclose(v.mean(axis=0), 0.0, atol=1e-12)
    t = np.sum(58.69 * v ** 2) / FORCE_TO_ACC / (3 * 500 * KB)
    assert t == pytest.approx(300.0, rel=0.15)


@pytest.mark.parametrize("device_nl", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("fast", [True, False], ids=["fast", "autograd"])
def test_nve_matches_jax(fast, device_nl):
    """15 steps of NVE on the 32-atom cell (chunks of 5): positions,
    velocities and the recorded trajectory to 1e-9, the thermo history
    to 1e-10 relative."""
    js, s = _fcc()
    model, params, twin = _eam(32)
    kw = dict(timestep=1.0, chunk_size=5, temperature=400.0, seed=5,
              fast_efs=fast, device_nl=device_nl)
    jmd = JaxVelocityVerlet(model, params, js, **kw)
    md = VelocityVerlet(twin, s, **kw)
    assert md._use_fast_efs == fast == jmd._use_fast_efs
    jh = jmd.run(15, record_trajectory=True)
    h = md.run(15, record_trajectory=True)
    assert sorted(h) == sorted(jh)
    _assert_runs_match(jmd, jh, md, h)
    assert md.temperature == pytest.approx(jmd.temperature, rel=1e-10)
    drift = abs(h["total"][-1] - h["total"][0]) / 32 * 1000
    assert drift < 0.5      # meV/atom, tests/test_dynamics.py


@pytest.mark.parametrize("device_nl", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("anisotropic", [False, True],
                         ids=["isotropic", "anisotropic"])
def test_npt_matches_jax(anisotropic, device_nl):
    """Berendsen NPT without a thermostat (deterministic in both
    packages) on a cell compressed by 3 % and strained along x: cell,
    positions, pressure and volume against JAX's."""
    cell = np.diag([2 * 3.52 * 0.97 * 1.02, 2 * 3.52 * 0.97,
                    2 * 3.52 * 0.97])
    js, s = _fcc(cell=cell)
    model, params, twin = _eam(32, rcut=4.5)
    kw = dict(timestep=1.0, skin=1.0, chunk_size=5, temperature=300.0,
              seed=7, target_pressure=0.0, pressure_tau=100.0,
              anisotropic=anisotropic, device_nl=device_nl)
    jmd = JaxVelocityVerlet(model, params, js, **kw)
    md = VelocityVerlet(twin, s, **kw)
    jh, h = jmd.run(20), md.run(20)
    np.testing.assert_allclose(md.structure.cell, jmd.structure.cell,
                               rtol=0, atol=1e-10)
    _assert_runs_match(jmd, jh, md, h, keys=("potential", "kinetic",
                                             "pressure", "volume"))
    assert h["volume"][-1] > h["volume"][0]


def _grap_model(elements, occurs):
    fz = JaxFeaturizer(elements, rcut=4.5)
    desc = JaxGrap(elements, algorithm="pexp",
                   parameters={"rl": [1.0, 2.0, 3.0], "pl": [4.0, 3.0, 2.0]},
                   moment_tensors=[0, 1, 2, 3], backend="dense")
    model = JaxAtomicNN(fz, Counter(occurs), desc, hidden_sizes=[8],
                        minmax_scale=False)
    params = model.init_params(jax.random.PRNGKey(0))
    return model, params, _port_twin(model, params)


@pytest.mark.parametrize("device_nl", [False, True], ids=["host", "device"])
def test_grap_md_matches_jax(device_nl):
    """A dense GRAP model's NVE (autograd w.r.t. positions, the padding
    spread off row 0) against JAX's, as tests/test_device_nl.py's
    two-element cube."""
    rng = np.random.RandomState(7)
    pos, cell = rng.uniform(0, 12.0, (32, 3)), np.eye(3) * 12.0
    symbols = ["Ni"] * 20 + ["Mo"] * 12
    js = JaxStructure.from_symbols(symbols, pos, cell, pbc=[True] * 3)
    s = Structure.from_symbols(symbols, pos, cell, pbc=[True] * 3)
    model, params, twin = _grap_model(["Mo", "Ni"], Counter(symbols))
    kw = dict(timestep=0.5, skin=1.0, chunk_size=5, temperature=300.0,
              seed=11, device_nl=device_nl)
    jmd = JaxVelocityVerlet(model, params, js, **kw)
    md = VelocityVerlet(twin, s, **kw)
    _assert_runs_match(jmd, jmd.run(15), md, md.run(15))


def test_langevin_nvt_thermalizes():
    """BAOAB from rest: the temperature of the second half averages near
    the target (32 atoms fluctuate by ~0.15 T) and heat flowed in."""
    js, s = _fcc(scale=1.0)
    _, _, twin = _eam(32, rcut=4.5)
    md = VelocityVerlet(twin, s, timestep=2.0, skin=1.0, chunk_size=25,
                        seed=5, target_temperature=500.0, friction=0.1)
    hist = md.run(500)
    temps = np.asarray(hist["temperature"])
    assert 350.0 < temps[len(temps) // 2:].mean() < 650.0
    assert hist["kinetic"][-1] > hist["kinetic"][0] + 0.1


@pytest.mark.parametrize("device_nl", [False, True], ids=["host", "device"])
def test_save_load_resumes_exactly(tmp_path, device_nl):
    """run(10); save; a fresh integrator loads and runs 10 more: the
    same bits as run(20), Langevin noise included (the generator's state
    is part of the file)."""
    _, s = _fcc()
    _, _, twin = _eam(32, rcut=4.5)
    kw = dict(timestep=2.0, chunk_size=5, temperature=300.0, seed=7,
              target_temperature=300.0, friction=0.1, device_nl=device_nl)
    md_a = VelocityVerlet(twin, s, **kw)
    md_a.run(20)
    md_b = VelocityVerlet(twin, s, **kw)
    md_b.run(10)
    state = tmp_path / "md_state.npz"
    md_b.save_state(str(state))
    md_c = VelocityVerlet(twin, s, **kw)
    md_c.load_state(str(state))
    md_c.run(10)
    np.testing.assert_array_equal(md_c.structure.positions,
                                  md_a.structure.positions)
    np.testing.assert_array_equal(md_c.velocities_vap, md_a.velocities_vap)
    one = Structure.from_symbols(["Ni"], [[0, 0, 0]], np.eye(3) * 3.52,
                                 pbc=[True] * 3)
    with pytest.raises(ValueError, match="does not match"):
        VelocityVerlet(twin, one).load_state(str(state))


def test_a_jax_state_file_loads_without_its_key(tmp_path):
    """A JAX state file resumes NVE; its PRNG key cannot seed the
    Langevin noise, which refuses it."""
    js, s = _fcc()
    model, params, twin = _eam(32, rcut=4.5)
    jmd = JaxVelocityVerlet(model, params, js, chunk_size=5,
                            temperature=300.0, seed=3)
    jmd.run(5)
    path = tmp_path / "jax_state.npz"
    jmd.save_state(str(path))
    md = VelocityVerlet(twin, s, chunk_size=5)
    md.load_state(str(path))
    np.testing.assert_array_equal(md.velocities_vap,
                                  np.asarray(jmd.velocities_vap))
    nvt = VelocityVerlet(twin, s, target_temperature=300.0, friction=0.1)
    with pytest.raises(ValueError, match="PRNG key"):
        nvt.load_state(str(path))


def test_constructor_refusals_as_jax():
    """The refusals of tests/test_dynamics.py, with their messages."""
    _, _, twin = _eam(1, rcut=4.5)
    one = Structure.from_symbols(["Ni"], [[0, 0, 0]], np.eye(3) * 3.52,
                                 pbc=[True] * 3)
    slab = Structure.from_symbols(["Ni"], [[0, 0, 0]], np.eye(3) * 3.52,
                                  pbc=[True, True, False])
    with pytest.raises(ValueError, match="anisotropic"):
        VelocityVerlet(twin, one, anisotropic=True)
    with pytest.raises(ValueError, match="periodic"):
        VelocityVerlet(twin, slab, target_pressure=0.0)
    with pytest.raises(ValueError, match="both"):
        VelocityVerlet(twin, one, target_temperature=300.0)
    with pytest.raises(ValueError, match="both"):
        VelocityVerlet(twin, one, friction=0.1)


def test_zero_com_velocity_and_temperature():
    _, s = _fcc()
    _, _, twin = _eam(32, rcut=4.5)
    md = VelocityVerlet(twin, s, temperature=300.0, seed=2)
    md.velocities_vap[1:] += 0.01
    md.zero_com_velocity()
    m = md.masses_vap[:, None] * md.vap.atom_masks[:, None]
    np.testing.assert_allclose((m * md.velocities_vap).sum(0), 0.0,
                               atol=1e-12)
    assert md.temperature > 0.0


# ----------------------------------------------------------------------
# the chip's float64 MD fixtures
# ----------------------------------------------------------------------

def md_record(route, device_nl):
    """The JAX package's float64 NVE of the saved mleam_ni model on the
    32-atom cell: the positions at every chunk end and the totals."""
    js, _ = _fcc()
    model, params, _ = jax_load_model(str(ROOT / MD_MODEL))
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64),
                                    params)
    md = JaxVelocityVerlet(model, params, js, fast_efs=route == "fast",
                           device_nl=device_nl, **MD_RUN)
    h = md.run(MD_STEPS, record_trajectory=True)
    return {"model": MD_MODEL, "route": route, "device_nl": device_nl,
            "structure": "fcc Ni 2x2x2, a=3.52 A", "steps": MD_STEPS,
            "run": MD_RUN, "precision": "float64",
            "positions0": js.positions.tolist(), "cell": js.cell.tolist(),
            "positions": np.asarray(h["positions"]).tolist(),
            "total": list(map(float, h["total"])),
            "potential": list(map(float, h["potential"]))}


MD_FIXTURES = [(route, dnl) for route in ("fast", "autograd")
               for dnl in (False, True)]


def md_fixture_path(route, device_nl):
    return DATA / (f"torch_port_ref_md_{route}_"
                   f"{'device' if device_nl else 'host'}.json")


@pytest.mark.parametrize("route,device_nl", MD_FIXTURES)
def test_md_fixture_is_current(route, device_nl):
    """The fixture the card is held against is the JAX package's run
    today, and the port reproduces it on the CPU."""
    stored = json.loads(md_fixture_path(route, device_nl).read_text())
    fresh = md_record(route, device_nl)
    for key in ("positions0", "cell"):
        np.testing.assert_array_equal(stored[key], fresh[key])
    np.testing.assert_allclose(stored["positions"], fresh["positions"],
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(stored["total"], fresh["total"],
                               rtol=1e-12)
    from tensoralloy_tpu_torch.io.model import load_model
    model, _ = load_model(str(ROOT / MD_MODEL), device="cpu")
    _, s = _fcc()
    md = VelocityVerlet(model, s, fast_efs=route == "fast",
                        device_nl=device_nl, **MD_RUN)
    h = md.run(MD_STEPS, record_trajectory=True)
    np.testing.assert_allclose(np.asarray(h["positions"]),
                               stored["positions"], rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(h["total"], stored["total"], rtol=HIST_REL)


def main():
    for route, dnl in MD_FIXTURES:
        path = md_fixture_path(route, dnl)
        path.write_text(json.dumps(md_record(route, dnl)) + "\n")
        print(f"wrote {path.relative_to(ROOT)}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from tensoralloy_tpu import set_precision
    set_precision("high")
    main()
