"""The port's nudged elastic band against the JAX package's at float64:
the minimum-image path, the band after FIRE steps on the JAX test's
31-atom zjw04 Ni vacancy hop (EAM: the analytic EFS image by image), a
GRAP band (the whole band one batched evaluation, autograd of the
stacked energies), a band whose replicas fall in different list widths,
and the refusals. The converged climbing-image run between relaxed
endpoints is held inside `vacancy_diffusivity`
(`tests/test_torch_kinetics.py`).
"""
import json
from collections import Counter

import jax
import numpy as np
import pytest
import torch

from tensoralloy_tpu.atoms import Structure as JaxStructure
from tensoralloy_tpu.neb import NEB as JaxNEB
from tensoralloy_tpu.neb import interpolate_band as jax_interpolate
from tensoralloy_tpu.nn.atomic import AtomicNN as JaxAtomicNN
from tensoralloy_tpu.nn.eam.models import EamAlloyNN as JaxEamAlloyNN
from tensoralloy_tpu.nn.grap import GenericRadialAtomicPotential as JaxGrap
from tensoralloy_tpu.transform import Featurizer as JaxFeaturizer
from tensoralloy_tpu_torch import neb as port_neb
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.io.model import model_from_dict
from tensoralloy_tpu_torch.neb import NEB, interpolate_band

POS_TOL = 1e-9
E_TOL = 1e-10


def _port_twin(model, params):
    twin = model_from_dict(json.loads(json.dumps(model.as_dict())),
                           device="cpu", dtype=torch.float64)
    twin.load_param_tree(jax.tree_util.tree_map(np.asarray, params))
    return twin


def fcc_vacancy_pair(a0=3.52, reps=2):
    """(initial, final) fcc Ni cells with one vacancy (the JAX test's):
    in the final frame the nearest neighbor has hopped into the vacancy.
    -> (JAX initial, JAX final, port initial, port final)."""
    base = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                     [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])
    frac = np.concatenate([base + np.array([i, j, k])
                           for i in range(reps) for j in range(reps)
                           for k in range(reps)]) / reps
    cell = np.eye(3) * a0 * reps
    pos = frac @ cell
    vac_site = pos[0].copy()
    pos = pos[1:]
    d = pos - vac_site
    f = d @ np.linalg.inv(cell)
    d = (f - np.round(f)) @ cell
    hop = int(np.argmin(np.linalg.norm(d, axis=1)))
    pos_final = pos.copy()
    pos_final[hop] = pos[hop] - d[hop]
    syms = ["Ni"] * len(pos)
    out = []
    for cls in (JaxStructure, Structure):
        out += [cls.from_symbols(syms, p, cell, pbc=[True] * 3)
                for p in (pos, pos_final)]
    return tuple(out)


def _zjw04(n, rcut=6.0):
    fz = JaxFeaturizer(["Ni"], rcut=rcut)
    model = JaxEamAlloyNN(fz, Counter({"Ni": n}), custom_potentials="zjw04")
    params = model.init_params(jax.random.PRNGKey(0))
    return model, params, _port_twin(model, params)


def _grap(n, rcut=4.5):
    fz = JaxFeaturizer(["Ni"], rcut=rcut)
    desc = JaxGrap(["Ni"], algorithm="pexp",
                   parameters={"rl": [1.0, 1.5, 2.0], "pl": [2.0, 2.5, 3.0]},
                   moment_tensors=[0, 1, 2], backend="dense")
    model = JaxAtomicNN(fz, Counter({"Ni": n}), desc, hidden_sizes=[8],
                        minmax_scale=False)
    params = model.init_params(jax.random.PRNGKey(1))
    twin = _port_twin(model, params)
    twin.descriptor.backend = "pallas"     # the kernel path's Function
    return model, params, twin


def _assert_bands_match(neb, jneb, res, jres):
    np.testing.assert_allclose(neb.positions, np.asarray(jneb.positions),
                               rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(res["energies"], jres["energies"], rtol=0,
                               atol=E_TOL)
    for k in ("barrier", "reverse_barrier", "delta_e"):
        assert res[k] == pytest.approx(jres[k], abs=E_TOL), k
    for k in ("n_steps", "converged", "saddle_index"):
        assert res[k] == jres[k], k
    assert res["fmax"] == pytest.approx(jres["fmax"], rel=1e-8, abs=1e-12)


def test_interpolate_band_matches_jax():
    ji, jf, si, sf = fcc_vacancy_pair()
    band = interpolate_band(si, sf, 5)
    np.testing.assert_array_equal(band, jax_interpolate(ji, jf, 5))
    assert np.linalg.norm(np.diff(band, axis=0), axis=-1).max() < 1.0
    bad = sf.copy()
    bad.numbers = bad.numbers.copy()
    bad.numbers[0] = 42
    with pytest.raises(ValueError, match="stoichiometry"):
        interpolate_band(si, bad, 5)


def test_eam_band_after_fire_steps_matches_jax():
    """20 FIRE steps in chunks of 5 of the climbing band on the
    31-atom cell: the band to 1e-9 A, the energies to 1e-10 eV, and one
    band evaluation per step and per chunk end."""
    ji, jf, si, sf = fcc_vacancy_pair()
    model, params, twin = _zjw04(len(ji))
    jneb = JaxNEB(model, params, ji, jf, n_images=7, chunk_size=5)
    neb = NEB(twin, si, sf, n_images=7, chunk_size=5)
    assert neb._use_fast_efs and jneb._use_fast_efs
    jres = jneb.run(fmax=1e-9, max_steps=20)
    res = neb.run(fmax=1e-9, max_steps=20)
    _assert_bands_match(neb, jneb, res, jres)
    # 4 chunks of 5 steps + their ends, and the final fresh evaluation
    assert neb.n_evaluations == 4 * 6 + 1


def test_grap_band_matches_jax():
    """A GRAP band: the stacked [M, A, ...] features through one
    evaluation a step (the kernels' Function, its twin on the CPU),
    without climbing, 10 steps: positions and energies."""
    ji, jf, si, sf = fcc_vacancy_pair()
    model, params, twin = _grap(len(ji))
    jneb = JaxNEB(model, params, ji, jf, n_images=5, climb=False,
                  chunk_size=5)
    neb = NEB(twin, si, sf, n_images=5, climb=False, chunk_size=5)
    assert not neb._use_fast_efs
    jres = jneb.run(fmax=1e-9, max_steps=10)
    res = neb.run(fmax=1e-9, max_steps=10)
    _assert_bands_match(neb, jneb, res, jres)


def test_ragged_band_is_refeaturized_at_the_band_maxima(monkeypatch):
    """Without the width buckets, and with one replica compressed so that
    its second shell comes inside the cutoff, the replicas' neighbor rows
    differ in width; the band is featurized again at the band-wide maxima
    and gives the JAX band all the same."""
    ji, jf, si, sf = fcc_vacancy_pair()
    model, params, twin = _grap(len(ji), rcut=2.9)
    monkeypatch.setattr(port_neb, "_wpad", lambda n: n)
    neb = NEB(twin, si, sf, n_images=5, climb=True, chunk_size=3)
    jneb = JaxNEB(model, params, ji, jf, n_images=5, climb=True,
                  chunk_size=3)
    for band in (neb, jneb):
        band.positions[2] = band.positions[2] * 0.9
    widths = set()
    featurize = neb.fz.featurize

    def spy(*args, **kwargs):
        out = featurize(*args, **kwargs)
        widths.add(out["pair_mask_d"].shape[1])
        return out

    monkeypatch.setattr(neb.fz, "featurize", spy)
    res = neb.run(fmax=1e-9, max_steps=6)
    assert len(widths) > 1, "the band never fell in two widths"
    jres = jneb.run(fmax=1e-9, max_steps=6)
    _assert_bands_match(neb, jneb, res, jres)


def test_neb_refusals():
    _, _, si, sf = fcc_vacancy_pair()
    _, _, twin = _zjw04(len(si))
    with pytest.raises(ValueError, match="at least 3"):
        NEB(twin, si, sf, n_images=2)
    # several ranks: the ValueError of too few devices outside a group of
    # them (tests/test_torch_parallel_analysis.py runs one), and the uneven
    # split JAX refuses
    with pytest.raises(ValueError, match="n_shards=2 > 1 available devices"):
        NEB(twin, si, sf, n_images=6, n_shards=2)
    with pytest.raises(ValueError, match="n_images=7 not divisible"):
        NEB(twin, si, sf, n_images=7, n_shards=2)
    with pytest.raises(RuntimeError, match="run"):
        NEB(twin, si, sf, n_images=3).saddle_structure()
