"""The port's heat flux, Green-Kubo and trajectory analysis against the
JAX package at float64: the autograd flux and atomic virials on the flat
layout (the EAM family, and the SF and GRAP descriptor models on the
'segment' backend, triples included), the EAM family's analytic flux on
the dense layout (and against the autograd flux), the dense-backend
refusal, the flux and stress that MD records at each chunk end (an SF
model's too), `trajectory_heat_flux`, and the numpy estimators and
trajectory observables on seeded inputs.
"""
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoralloy_tpu.analysis import heatflux as jax_heatflux
from tensoralloy_tpu.analysis import trajectory as jax_trajectory
from tensoralloy_tpu.atoms import Structure as JaxStructure
from tensoralloy_tpu.dynamics import VelocityVerlet as JaxVelocityVerlet
from tensoralloy_tpu.io.model import load_model as jax_load_model
from tensoralloy_tpu.nn.eam.fast_efs import (
    make_fast_heat_flux_fn as jax_fast_flux)
from tensoralloy_tpu_torch.analysis import heatflux, trajectory
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.dynamics import VelocityVerlet
from tensoralloy_tpu_torch.io.model import load_model
from tensoralloy_tpu_torch.nn.eam.fast_efs import make_fast_heat_flux_fn

ROOT = Path(__file__).resolve().parent.parent
REL = 1e-10
MODELS = {"eam": "artifacts/mleam_ni/model/snap_Ni_mleam.npz",
          "adp": "artifacts/mladp_mo_v5/model/snap_Mo_mladp_gw.npz",
          # served from copies whose descriptor says 'segment'
          "sf": "artifacts/snap_ni_sfa/model/snap_Ni_sfa.npz",
          "grap": "artifacts/snap_ni_v5_readapt/model/snap_Ni.npz"}
_SEGMENT_COPIES = {}


def _model_file(name) -> str:
    if name not in ("sf", "grap"):
        return str(ROOT / MODELS[name])
    if name not in _SEGMENT_COPIES:
        import tempfile
        import chip_smoke
        _SEGMENT_COPIES[name] = chip_smoke.backend_copy(
            ROOT / MODELS[name], Path(tempfile.mkdtemp()) / f"{name}.npz",
            "segment")
    return _SEGMENT_COPIES[name]


def _rel(a, b) -> float:
    a, b = (np.asarray(x.detach() if isinstance(x, torch.Tensor) else x,
                       np.float64) for x in (a, b))
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _cell(name, seed=3):
    """A jittered 32-atom fcc Ni or 54-atom bcc Mo cell: (jax, port)
    structures."""
    rng = np.random.default_rng(seed)
    if name == "adp":
        base, a, element = np.array([[0, 0, 0], [.5, .5, .5]]), 3.16, "Mo"
        reps = 3
    else:
        base = np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
        a, element, reps = 3.52, "Ni", 2
    grid = np.array([(i, j, k) for i in range(reps) for j in range(reps)
                     for k in range(reps)], float)
    pos = ((grid[:, None] + base[None]) * a).reshape(-1, 3)
    pos = pos + rng.normal(0.0, 0.06, pos.shape)
    cell = np.eye(3) * a * reps
    symbols = [element] * len(pos)
    return (JaxStructure.from_symbols(symbols, pos, cell, pbc=[True] * 3),
            Structure.from_symbols(symbols, pos, cell, pbc=[True] * 3))


def _models(name):
    jmodel, jparams, _ = jax_load_model(_model_file(name))
    jparams = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.float64), jparams)
    model, _ = load_model(_model_file(name), device="cpu")
    return jmodel, jparams, model


def _inputs(name, layout, seed=0):
    """Both packages' models re-laid-out for the cell, its features in
    `layout`, and seeded velocities and masses in VAP order."""
    js, s = _cell(name)
    jmodel, jparams, model = _models(name)
    jmodel = jmodel.clone_for(Counter(js.symbols))
    model = model.clone_for(Counter(s.symbols))
    vap = jmodel.featurizer.make_vap(js)
    feats = jmodel.featurizer.featurize(js, vap, layout=layout)
    vel = vap.map_array(np.random.default_rng(seed).normal(
        0.0, 0.01, (len(js), 3)))
    masses = vap.map_array(js.masses)
    masses[0] = 1.0
    jax_in = ({k: jnp.asarray(v) for k, v in feats.items()},
              jnp.asarray(vel), jnp.asarray(masses))
    port_in = ({k: torch.as_tensor(v) for k, v in feats.items()},
               torch.as_tensor(vel), torch.as_tensor(masses))
    return jmodel, jparams, model, jax_in, port_in


FLUX_KEYS = ("J", "J_convective", "J_virial", "energy", "atomic_energies")


@pytest.mark.parametrize("name", ["eam", "adp", "sf", "grap"])
def test_autograd_heat_flux_matches_jax(name):
    jmodel, jparams, model, (jf, jv, jm), (tf, tv, tm) = _inputs(
        name, "segment")
    want = jax.jit(jax_heatflux.make_heat_flux_fn(jmodel))(jparams, jf,
                                                            jv, jm)
    got = heatflux.make_heat_flux_fn(model)(tf, tv, tm)
    for key in FLUX_KEYS:
        assert _rel(got[key], want[key]) <= REL, key


@pytest.mark.parametrize("name", ["eam", "adp", "sf", "grap"])
def test_atomic_virials_match_jax_and_sum_to_the_virial(name):
    jmodel, jparams, model, (jf, _, _), (tf, _, _) = _inputs(name,
                                                             "segment")
    want = jax.jit(jax_heatflux.make_atomic_virial_fn(jmodel))(jparams, jf)
    got = heatflux.make_atomic_virial_fn(model)(tf)
    for key in ("atomic_virials", "virial", "atomic_energies", "energy"):
        assert _rel(got[key], want[key]) <= REL, key
    from tensoralloy_tpu_torch.nn.fields import make_efs_fn
    efs = make_efs_fn(model.energy_and_aux)(tf)
    assert _rel(got["virial"], efs["virial"]) <= 1e-10


@pytest.mark.parametrize("name", ["eam", "adp"])
def test_fast_heat_flux_matches_jax_and_the_autograd_flux(name):
    jmodel, jparams, model, (jf, jv, jm), (tf, tv, tm) = _inputs(name,
                                                                 "dense")
    want = jax.jit(jax_fast_flux(jmodel))(jparams, jf, jv, jm)
    got = make_fast_heat_flux_fn(model)(tf, tv, tm)
    for key in FLUX_KEYS:
        assert _rel(got[key], want[key]) <= REL, key
    _, _, _, _, (sf, sv, sm) = _inputs(name, "segment")
    auto = heatflux.make_heat_flux_fn(model)(sf, sv, sm)
    for key in ("J", "J_virial", "energy"):
        assert _rel(got[key], auto[key]) <= REL, key


def test_dense_descriptor_backends_are_refused_as_in_jax():
    model, _ = load_model(str(ROOT / "artifacts/snap_ni_v5_readapt/model/"
                                     "snap_Ni.npz"), device="cpu")
    for fn in (heatflux.make_heat_flux_fn, heatflux.make_atomic_virial_fn):
        with pytest.raises(ValueError, match="segment descriptor backend"):
            fn(model)
    _, s = _cell("eam")
    with pytest.raises(ValueError, match="segment descriptor backend"):
        VelocityVerlet(model, s, record_heat_flux=True)


@pytest.mark.parametrize("device_nl", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("fast", [True, False], ids=["fast", "autograd"])
def test_md_records_flux_and_stress_as_jax(fast, device_nl):
    """The flux and the full stress recorded at each chunk end of an NVE
    run, against the JAX integrator's."""
    js, s = _cell("eam")
    jmodel, jparams, model = _models("eam")
    kw = dict(timestep=1.0, chunk_size=4, temperature=300.0, seed=2,
              record_heat_flux=True, record_stress=True, fast_efs=fast,
              device_nl=device_nl)
    jh = JaxVelocityVerlet(jmodel, jparams, js, **kw).run(12)
    h = VelocityVerlet(model, s, **kw).run(12)
    for key in ("heat_flux", "stress_tensor", "potential"):
        assert _rel(h[key], jh[key]) <= REL, key


def test_descriptor_md_records_flux_as_jax():
    """NVE of the segment copy of snap_ni_sfa (G2 and G4 on the flat
    pairs and triples) recording the flux at each chunk end, against
    the JAX integrator's (1e-9)."""
    js, s = _cell("sf")
    jmodel, jparams, model = _models("sf")
    kw = dict(timestep=1.0, chunk_size=3, temperature=300.0, seed=4,
              record_heat_flux=True)
    jh = JaxVelocityVerlet(jmodel, jparams, js, **kw).run(6)
    h = VelocityVerlet(model, s, **kw).run(6)
    for key in ("heat_flux", "potential", "total"):
        assert _rel(h[key], jh[key]) <= 1e-9, key


def test_trajectory_heat_flux_matches_jax():
    js, s = _cell("eam")
    jmodel, jparams, model = _models("eam")
    md = VelocityVerlet(model, s, chunk_size=3, temperature=300.0, seed=1)
    h = md.run(9, record_trajectory=True)
    want = jax_heatflux.trajectory_heat_flux(
        jmodel, jparams, js, h["positions"], h["velocities"])
    got = heatflux.trajectory_heat_flux(model, s, h["positions"],
                                        h["velocities"])
    assert got.shape == (3, 3)
    assert _rel(got, want) <= REL


def _series(seed, n=400):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    j = np.stack([np.cos(0.05 * t + p) * np.exp(-t / 80.0)
                  for p in (0.1, 0.7, 1.3)], axis=1)
    return j + 0.05 * rng.normal(size=(n, 3))


def _assert_dicts_equal(got, want, tol=1e-12):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], float),
                                   np.asarray(want[k], float), rtol=tol,
                                   atol=tol, err_msg=k)


def test_green_kubo_estimators_match_jax():
    j = _series(0)
    _assert_dicts_equal(heatflux.green_kubo(j, 2.0, 1000.0, 300.0),
                        jax_heatflux.green_kubo(j, 2.0, 1000.0, 300.0))
    _assert_dicts_equal(
        heatflux.green_kubo(j, 1.0, 500.0, 600.0, max_lag=50),
        jax_heatflux.green_kubo(j, 1.0, 500.0, 600.0, max_lag=50))
    stress = np.random.default_rng(1).normal(size=(300, 3, 3)) * 1e-3
    _assert_dicts_equal(
        heatflux.green_kubo_viscosity(stress, 5.0, 2000.0, 1200.0),
        jax_heatflux.green_kubo_viscosity(stress, 5.0, 2000.0, 1200.0))
    acf = np.exp(-np.arange(60) / 9.0) * np.cos(np.arange(60) / 4.0)
    running = np.cumsum(acf)
    assert heatflux.gk_plateau(acf, running) == \
        jax_heatflux.gk_plateau(acf, running)


def _frames(n_frames=4, seed=5):
    rng = np.random.default_rng(seed)
    a, reps = 3.52, 3
    base = np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
    grid = np.array([(i, j, k) for i in range(reps) for j in range(reps)
                     for k in range(reps)], float)
    pos0 = ((grid[:, None] + base[None]) * a).reshape(-1, 3)
    symbols = ["Ni", "Mo", "Ni", "Ni"] * (len(pos0) // 4)
    cell = np.eye(3) * a * reps
    out = []
    for _ in range(n_frames):
        pos = pos0 + rng.normal(0.0, 0.1, pos0.shape)
        out.append((JaxStructure.from_symbols(symbols, pos, cell,
                                              pbc=[True] * 3),
                    Structure.from_symbols(symbols, pos, cell,
                                           pbc=[True] * 3)))
    return [f[0] for f in out], [f[1] for f in out]


def test_radial_distribution_matches_jax():
    jframes, frames = _frames()
    want = jax_trajectory.radial_distribution(jframes, rmax=5.0, nbins=80)
    got = trajectory.radial_distribution(frames, rmax=5.0, nbins=80,
                                         device="cpu")
    _assert_dicts_equal(got, want)
    with pytest.raises(ValueError, match="minimum image"):
        trajectory.radial_distribution(frames, rmax=6.0, device="cpu")


def test_time_series_observables_match_jax():
    rng = np.random.default_rng(9)
    pos = np.cumsum(rng.normal(0, 0.05, (60, 16, 3)), axis=0)
    vel = rng.normal(0, 0.01, (60, 16, 3))
    masses = rng.uniform(20.0, 100.0, 16)
    for fn, args in (("mean_squared_displacement", (pos, 2.0)),
                     ("mean_squared_displacement", (pos, 2.0, 20)),
                     ("velocity_autocorrelation", (vel, 1.0)),
                     ("vibrational_dos", (vel, 1.0, masses)),
                     ("vibrational_dos", (vel, 2.0, None, 30))):
        _assert_dicts_equal(getattr(trajectory, fn)(*args),
                            getattr(jax_trajectory, fn)(*args))
    assert trajectory.diffusion_coefficient(pos, 2.0) == pytest.approx(
        jax_trajectory.diffusion_coefficient(pos, 2.0), rel=1e-12)


def _heat_flux_fixture_run(vv_cls, structure, model, params=None):
    """The NVE run of chip_smoke's descriptor heat-flux fixture."""
    import chip_smoke
    args = (model, structure) if params is None else (model, params,
                                                      structure)
    return vv_cls(*args, record_heat_flux=True,
                  **chip_smoke.HEAT_FLUX_RUN).run(chip_smoke.HEAT_FLUX_STEPS)


def heat_flux_record(workdir: Path) -> dict:
    """The JAX package's NVE of the 108-atom fixture cell with the segment
    copy of snap_ni_sfa (float64 weights), the flux at every chunk end."""
    import chip_smoke
    import json
    path = chip_smoke.segment_model_file(chip_smoke.PATHS["sf"][0],
                                         workdir, float64=True)
    jmodel, jparams, _ = jax_load_model(path)
    ref = json.loads(chip_smoke.PATHS["sf"][2][0].read_text())
    js = JaxStructure.from_symbols(["Ni"] * len(ref["positions"]),
                                   ref["positions"], ref["cell"],
                                   pbc=[True] * 3)
    h = _heat_flux_fixture_run(JaxVelocityVerlet, js, jmodel, jparams)
    return {"model": "artifacts/snap_ni_sfa/model/snap_Ni_sfa.npz with "
                     "backend 'segment', weights in float64",
            "structure": ref["structure"], "run": chip_smoke.HEAT_FLUX_RUN,
            "steps": chip_smoke.HEAT_FLUX_STEPS,
            **{k: np.asarray(h[k]).tolist()
               for k in ("heat_flux", "potential", "total")}}


def test_descriptor_heat_flux_fixture_is_current(tmp_path):
    """The port on the CPU reproduces `tests/data/
    torch_port_ref_heat_flux_sf.json` (1e-9), which the card is held
    against."""
    import chip_smoke
    import json
    want = json.loads(chip_smoke.HEAT_FLUX_FIXTURE.read_text())
    assert want["run"] == chip_smoke.HEAT_FLUX_RUN
    path = chip_smoke.segment_model_file(chip_smoke.PATHS["sf"][0],
                                         tmp_path, float64=True)
    model, _ = load_model(path, device="cpu")
    ref = json.loads(chip_smoke.PATHS["sf"][2][0].read_text())
    s = Structure.from_symbols(["Ni"] * len(ref["positions"]),
                               ref["positions"], ref["cell"], pbc=[True] * 3)
    h = _heat_flux_fixture_run(VelocityVerlet, s, model)
    for key in ("heat_flux", "potential", "total"):
        assert _rel(h[key], want[key]) <= chip_smoke.HEAT_FLUX_REL, key


if __name__ == "__main__":
    import json
    import sys
    import tempfile
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from tensoralloy_tpu import set_precision
    set_precision("high")
    import chip_smoke
    with tempfile.TemporaryDirectory() as tmp:
        record = heat_flux_record(Path(tmp))
    chip_smoke.HEAT_FLUX_FIXTURE.write_text(json.dumps(record, indent=1)
                                            + "\n")
    print(f"wrote {chip_smoke.HEAT_FLUX_FIXTURE}", file=sys.stderr)
