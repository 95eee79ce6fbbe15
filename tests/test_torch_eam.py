"""The EAM/ADP family in the port against the JAX package at float64:
safe_pow, the cubic spline, the flat pair layout and its geometry, every
analytic potential with its first and second derivatives in r, the
EamAlloyNN / EamFsNN / AdpNN energies, forces and stress (analytic and
MLP functions, one and two elements, both ADP conventions), the analytic
fast EFS against autograd, the setfl files, and the calculator's two
routes.

The JAX-reference fixtures that `chip_smoke.py` holds the card's float64
requests against are regenerated with

    python -m tests.test_torch_eam
"""
import dataclasses
import json
import os
import re
import sys
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoralloy_tpu.atoms import Structure as JaxStructure
from tensoralloy_tpu.calculator import (
    TensorAlloyCalculator as JaxCalculator)
from tensoralloy_tpu.io import lammps as jax_lammps
from tensoralloy_tpu.nn.eam import models as jax_models
from tensoralloy_tpu.nn.eam import potentials as jax_potentials
from tensoralloy_tpu.nn.eam.fast_efs import make_fast_efs_fn as jax_fast
from tensoralloy_tpu.nn.fields import make_efs_fn as jax_efs
from tensoralloy_tpu.ops import pairs as jax_pairs
from tensoralloy_tpu.ops.safe import safe_pow as jax_safe_pow
from tensoralloy_tpu.ops.spline import UniformCubicSpline as JaxSpline
from tensoralloy_tpu.transform import Featurizer as JaxFeaturizer
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.calculator import (TensorAlloyCalculator,
                                              model_feature_layout)
from tensoralloy_tpu_torch.io import lammps
from tensoralloy_tpu_torch.nn.eam import models, potentials
from tensoralloy_tpu_torch.nn.eam.fast_efs import make_fast_efs_fn
from tensoralloy_tpu_torch.nn.fields import make_efs_fn
from tensoralloy_tpu_torch.ops import pairs
from tensoralloy_tpu_torch.ops.safe import safe_pow
from tensoralloy_tpu_torch.ops.spline import UniformCubicSpline
from tensoralloy_tpu_torch.transform.featurizer import Featurizer
from tensoralloy_tpu_torch.utils import tree_flatten, tree_map

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
ADP_TABLE = "artifacts/mladp_mo_v5/model/snap_Mo_mladp_gw.adp"
REL = 1e-10
LATTICE = {"Ni": 3.52, "Mo": 3.16}


def _rel(a, b) -> float:
    a, b = (np.asarray(x.detach() if isinstance(x, torch.Tensor) else x,
                       np.float64) for x in (a, b))
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _t(x):
    return torch.as_tensor(np.asarray(x))


def lattice(kind: str, a: float, reps, symbols, sigma=0.05, seed=0):
    """-> (symbols, positions, cell) of a jittered fcc or bcc supercell;
    `symbols` cycles over the sites."""
    basis = (np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
             if kind == "fcc" else np.array([[0, 0, 0], [.5, .5, .5]]))
    grid = np.array([(i, j, k) for i in range(reps) for j in range(reps)
                     for k in range(reps)], float)
    pos = ((grid[:, None] + basis[None]) * a).reshape(-1, 3)
    pos = pos + np.random.default_rng(seed).normal(0.0, sigma, pos.shape)
    syms = [symbols[i % len(symbols)] for i in range(len(pos))]
    return syms, pos, np.eye(3) * a * reps


def both(symbols, pos, cell):
    return (JaxStructure.from_symbols(symbols, pos, cell, pbc=[True] * 3),
            Structure.from_symbols(symbols, pos, cell, pbc=[True] * 3))


# ----------------------------------------------------------------------
# ops
# ----------------------------------------------------------------------

@pytest.mark.parametrize("y", [0.5, 2.0, 3.7])
def test_safe_pow_and_its_derivatives_match_jax(y):
    """Values, first and second derivatives in x and y, finite at x = 0
    (where a plain power's are not)."""
    x = np.array([0.0, 1e-3, 0.3, 1.0, 2.5])

    def jf(xx, yy):
        return jnp.sum(jax_safe_pow(xx, yy))

    jx, jy = jnp.asarray(x), jnp.asarray(y)
    want = [jax_safe_pow(jx, jy), jax.grad(jf, 0)(jx, jy),
            jax.grad(jf, 1)(jx, jy),
            jax.vmap(jax.grad(jax.grad(lambda a: jax_safe_pow(a, jy))))(jx),
            jax.grad(jax.grad(jf, 1), 1)(jx, jy)]
    tx = _t(x).requires_grad_()
    ty = torch.tensor(y, dtype=torch.float64, requires_grad=True)
    val = safe_pow(tx, ty)
    gx, gy = torch.autograd.grad(val.sum(), (tx, ty), create_graph=True)
    gxx, = torch.autograd.grad(gx.sum(), tx, retain_graph=True)
    gyy, = torch.autograd.grad(gy, ty)
    for got, exp in zip((val, gx, gy, gxx, gyy), want):
        got = got.detach().numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, np.asarray(exp), rtol=1e-12,
                                   atol=1e-12)
    # a third derivative exists too (the elastic constraint's)
    g3, = torch.autograd.grad(safe_pow(tx, 3.5).sum(), tx,
                              create_graph=True)
    g3, = torch.autograd.grad(g3.sum(), tx, create_graph=True)
    g3, = torch.autograd.grad(g3.sum(), tx)
    assert torch.isfinite(g3).all()


def test_uniform_spline_matches_jax():
    rng = np.random.default_rng(3)
    y = np.cumsum(rng.normal(size=40))
    r = np.concatenate([rng.uniform(-0.5, 9.0, 64), [0.0, 3.9, 7.8, 8.0]])
    for zero in (True, False):
        got_s = UniformCubicSpline(y, 0.0, 0.2, extrapolate_zero=zero)
        want_s = JaxSpline(y, 0.0, 0.2, extrapolate_zero=zero)
        tr = _t(r).requires_grad_()
        val = got_s(tr)
        g1, = torch.autograd.grad(val.sum(), tr, create_graph=True)
        g2, = torch.autograd.grad(g1.sum(), tr)
        jr = jnp.asarray(r)
        d1 = jax.vmap(jax.grad(lambda x: want_s(x)))(jr)
        d2 = jax.vmap(jax.grad(jax.grad(lambda x: want_s(x))))(jr)
        for got, exp in ((val, want_s(jr)), (g1, d1), (g2, d2)):
            np.testing.assert_allclose(got.detach().numpy(), exp,
                                       rtol=1e-12, atol=1e-12)


def test_pair_geometry_matches_jax():
    """safe_norm, pair_vectors, pair_distances on one structure and on a
    batch of two (pair indices within each structure)."""
    syms, pos, cell = lattice("bcc", 3.16, 2, ["Mo", "Ni"])
    js, s = both(syms, pos, cell)
    fz = Featurizer(["Mo", "Ni"], rcut=5.0)
    feats = fz.featurize(s, layout="segment", nij_max=fz.neighbor_size(
        s).nij + 7)
    t = {k: _t(v) for k, v in feats.items()}
    j = {k: jnp.asarray(v) for k, v in feats.items()}
    np.testing.assert_allclose(pairs.pair_vectors(t).numpy(),
                               jax_pairs.pair_vectors(j), rtol=1e-12,
                               atol=1e-12)
    for a, b in zip(pairs.pair_distances(t), jax_pairs.pair_distances(j)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=1e-12)
    vec = _t(np.zeros((2, 3))).requires_grad_()
    g, = torch.autograd.grad(pairs.safe_norm(vec).sum(), vec)
    assert torch.isfinite(g).all()
    batch = {k: torch.stack([v, v]) for k, v in t.items()}
    batch["positions"] = batch["positions"].clone()
    batch["positions"][1] += 0.01
    got = pairs.pair_vectors(batch)
    np.testing.assert_allclose(got[0].numpy(), jax_pairs.pair_vectors(j),
                               rtol=1e-12, atol=1e-12)
    j2 = dict(j, positions=j["positions"] + 0.01)
    np.testing.assert_allclose(got[1].numpy(), jax_pairs.pair_vectors(j2),
                               rtol=1e-12, atol=1e-12)


# ----------------------------------------------------------------------
# potentials
# ----------------------------------------------------------------------

# potential -> {method: [(section, low, high)]}: r (or rho) drawn in
# [low, high], clear of the points where a form is not smooth
POTENTIALS = {
    "zjw04": {"phi": [("NiNi", 1.8, 6.0), ("MoNi", 1.8, 6.0)],
              "rho": [("Ni", 1.8, 6.0), ("MoNi", 1.8, 6.0)],
              "embed": [("Ni", 1.0, 40.0)]},
    "zjw04xc": {"phi": [("NiNi", 1.8, 6.0), ("MoNi", 1.8, 6.0)],
                "rho": [("Mo", 1.8, 6.0)],
                "embed": [("Ni", 0.0, 40.0), ("Mo", 1.0, 45.0)]},
    "zjw04uxc": {"phi": [("MoMo", 1.8, 6.0)], "rho": [("Mo", 1.8, 6.0)],
                 "embed": [("Mo", 1.0, 45.0)]},
    "zjw04xcp": {"phi": [("MoNi", 1.8, 6.0), ("NiNi", 1.8, 6.0)],
                 "rho": [("Ni", 1.8, 6.0)], "embed": [("Ni", 1.0, 40.0)]},
    "sutton90": {"phi": [("AgAg", 2.0, 6.0)], "rho": [("Ag", 2.0, 6.0)],
                 "embed": [("Ag", 0.5, 30.0)]},
    "morse": {"phi": [("NiNi", 1.8, 6.0)], "rho": [("Ni", 1.8, 6.0)],
              "embed": [("Ni", 0.5, 30.0)]},
    "buckingham": {"phi": [("NiNi", 1.8, 6.0)], "rho": [("Ni", 1.8, 6.0)]},
    "msah11": {"phi": [("AlAl", 1.0, 6.4), ("FeFe", 0.6, 5.2),
                       ("AlFe", 0.9, 6.1)],
               "rho": [("Al", 1.0, 6.4), ("Fe", 1.0, 4.1),
                       ("AlFe", 1.0, 6.1)],
               "embed": [("Al", 0.5, 30.0), ("Fe", 0.5, 30.0)]},
    "agrawal": {"phi": [("BeBe", 1.5, 5.0)], "rho": [("Be", 1.5, 5.0)],
                "embed": [("Be", 0.5, 30.0)]},
    "mishinh": {"embed": [("Mo", 0.1, 30.0)],
                "dipole": [("MoMo", 1.5, 5.1), ("MoNi", 1.5, 5.1)],
                "quadrupole": [("MoMo", 1.5, 5.1)]},
    "grimes": {"phi": [("PuPu", 1.8, 6.0)], "rho": [("Pu", 1.0, 6.0)],
               "embed": [("Pu", 0.5, 30.0)]},
    f"spline@{ADP_TABLE}": {"phi": [("MoMo", 1.5, 6.3)],
                            "rho": [("Mo", 1.5, 6.3)],
                            "embed": [("Mo", 0.5, 80.0)],
                            "dipole": [("MoMo", 1.5, 6.3)],
                            "quadrupole": [("MoMo", 1.5, 6.3)]},
}


def _jittered_params(pot, sections, seed):
    """The potential's initial parameters for `sections`, each moved by
    up to 2 % from a seeded numpy generator (numpy arrays)."""
    rng = np.random.default_rng(seed)
    tree = jax.device_get(jax_potentials.resolve_potential(
        pot).initial_params(sections))
    return tree_map(lambda v: np.asarray(v) * (1 + rng.uniform(
        -0.02, 0.02)), tree) if tree else {}


@pytest.mark.parametrize("name", sorted(POTENTIALS))
def test_potential_functions_and_derivatives_match_jax(name):
    """Every function of every potential `resolve_potential` knows, its
    first and second derivatives in r, with jittered parameters (and
    once detached as a fixed function), <= 1e-10."""
    want_pot = jax_potentials.resolve_potential(name)
    got_pot = potentials.resolve_potential(name)
    assert type(got_pot).__name__ == type(want_pot).__name__
    assert got_pot.name == want_pot.name
    assert got_pot.always_fixed == want_pot.always_fixed
    assert got_pot.defaults == want_pot.defaults
    sections = sorted({s for rows in POTENTIALS[name].values()
                       for s, _, _ in rows})
    wanted = [s for s in sections if s in want_pot.defaults] \
        if want_pot.defaults else sections
    raw = _jittered_params(name, wanted, seed=len(name))
    jparams = {want_pot.name: raw} if raw else {}
    tparams = {got_pot.name: tree_map(_t, raw)} if raw else {}
    rng = np.random.default_rng(7)
    for method, rows in POTENTIALS[name].items():
        for section, lo, hi in rows:
            x = np.sort(rng.uniform(lo, hi, 41))
            for fixed in (False, True):
                def jf(v):
                    return getattr(want_pot, method)(jparams, v, section,
                                                     fixed=fixed)
                jx = jnp.asarray(x)
                want = (jf(jx), jax.vmap(jax.grad(jf))(jx),
                        jax.vmap(jax.grad(jax.grad(jf)))(jx))
                tx = _t(x).requires_grad_()
                val = getattr(got_pot, method)(tparams, tx, section,
                                               fixed=fixed)
                d1, = torch.autograd.grad(val.sum(), tx, create_graph=True)
                d2, = torch.autograd.grad(d1.sum(), tx)
                for what, got, exp in zip(("value", "d1", "d2"),
                                          (val, d1, d2), want):
                    got = got.detach().numpy()
                    assert np.isfinite(got).all(), (method, section, what)
                    assert _rel(got, exp) <= REL, (method, section, what)
            # a fixed function passes no gradient to its parameters
            leaves = [v.requires_grad_() for v in
                      tree_flatten(tparams).values()]
            out = getattr(got_pot, method)(tparams, _t(x), section,
                                           fixed=True)
            assert not out.requires_grad or not leaves


# ----------------------------------------------------------------------
# the flat pair layout
# ----------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["segment", "both"])
def test_segment_features_match_jax(layout, monkeypatch):
    """The feature dict key by key (integers exactly, floats to 1e-12) on
    one- and two-element cells, padded to an explicit nij_max and by a
    bucket; `neighbor_size` as in JAX; the native and the numpy lists
    alike."""
    cases = [(["Ni"], lattice("fcc", 3.52, 2, ["Ni"])),
             (["Mo", "Ni"], lattice("bcc", 3.16, 2, ["Mo", "Ni", "Ni"]))]
    for native in (True, False):
        if native:
            monkeypatch.delenv("TENSORALLOY_TPU_NO_NATIVE", raising=False)
        else:
            monkeypatch.setenv("TENSORALLOY_TPU_NO_NATIVE", "1")
        for elements, (syms, pos, cell) in cases:
            js, s = both(syms, pos, cell)
            jfz, fz = JaxFeaturizer(elements, 5.0), Featurizer(elements, 5.0)
            size = fz.neighbor_size(s)
            assert dataclasses.asdict(size) == dataclasses.asdict(
                jfz.neighbor_size(js))
            for kw in (dict(nij_max=size.nij + 13),
                       dict(pair_bucket=lambda n: 1 << (n - 1).bit_length()),
                       dict()):
                want = jfz.featurize(js, layout=layout, **kw)
                got = fz.featurize(s, layout=layout, **kw)
                assert list(got) == list(want)
                for key in want:
                    w, g = np.asarray(want[key]), np.asarray(got[key])
                    assert g.dtype == w.dtype and g.shape == w.shape, key
                    if np.issubdtype(w.dtype, np.integer):
                        np.testing.assert_array_equal(g, w, err_msg=key)
                    else:
                        np.testing.assert_allclose(g, w, rtol=1e-12,
                                                   atol=1e-12, err_msg=key)
    with pytest.raises(ValueError, match="exceeds"):
        fz.featurize(s, layout="segment", nij_max=3)
    # an angular featurizer adds the flat triple arrays, padded as asked
    jangular = JaxFeaturizer(["Ni"], 5.0, angular=True, acut=4.0)
    angular = Featurizer(["Ni"], 5.0, angular=True, acut=4.0)
    js, s = both(*lattice("fcc", 3.52, 2, ["Ni"]))
    want = jangular.featurize(js, layout=layout, trip_bucket=lambda n: n + 5)
    got = angular.featurize(s, layout=layout, trip_bucket=lambda n: n + 5)
    assert list(got) == list(want) and "trip_i" in got
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key]),
                                   np.asarray(want[key]), rtol=1e-12,
                                   atol=1e-12, err_msg=key)
    with pytest.raises(ValueError, match="exceeds"):
        angular.featurize(s, layout=layout, nijk_max=3)


# ----------------------------------------------------------------------
# models
# ----------------------------------------------------------------------

ANALYTIC = {
    "EamAlloyNN": {"Mo": {"rho": "zjw04xc", "embed": "zjw04xc"},
                   "Ni": {"rho": "zjw04xc", "embed": "zjw04xc"},
                   "MoMo": {"phi": "zjw04xc"}, "MoNi": {"phi": "zjw04xc"},
                   "NiNi": {"phi": "zjw04xc"}},
    "EamFsNN": {"Mo": {"embed": "zjw04"}, "Ni": {"embed": "zjw04xc"},
                "MoMo": {"rho": "zjw04", "phi": "zjw04"},
                "MoNi": {"rho": "zjw04", "phi": "zjw04xcp"},
                "NiMo": {"rho": "zjw04xc"},
                "NiNi": {"rho": "zjw04", "phi": "morse"}},
    "AdpNN": {"Mo": {"rho": "zjw04xc", "embed": "zjw04xc"},
              "Ni": {"rho": "zjw04xc", "embed": "zjw04xc"},
              "MoMo": {"phi": "zjw04xc", "dipole": "mishinh",
                       "quadrupole": "mishinh"},
              "MoNi": {"phi": "zjw04xc", "dipole": "mishinh",
                       "quadrupole": "mishinh"},
              "NiNi": {"phi": "zjw04xc", "dipole": "mishinh",
                       "quadrupole": "mishinh"}},
}

MODEL_CASES = [(cls, fns, elements, per_term)
               for cls in ("EamAlloyNN", "EamFsNN", "AdpNN")
               for fns in ("analytic", "mlp")
               for elements in (("Ni",), ("Mo", "Ni"))
               for per_term in ((True, False) if cls == "AdpNN"
                                else (True,))]


def _model_pair(cls, fns, elements, per_term, occurs, rcut=5.0):
    """(JAX model, its init_params jittered, the port's model with those
    parameters) at float64."""
    custom = None
    if fns == "analytic":
        custom = {k: v for k, v in ANALYTIC[cls].items()
                  if set(re.findall(r"[A-Z][a-z]*", k)) <= set(elements)}
    kw = dict(custom_potentials=custom, hidden_sizes=[6, 5],
              fixed_functions=[f"{elements[0]}.embed"],
              adp_per_term=per_term)
    jm = getattr(jax_models, cls)(JaxFeaturizer(list(elements), rcut),
                                  occurs, **kw)
    rng = np.random.default_rng(11)
    params = tree_map(lambda v: np.asarray(v, np.float64) * (
        1 + rng.uniform(-0.02, 0.02)), jax.device_get(
        jm.init_params(jax.random.PRNGKey(5))))
    m = getattr(models, cls)(Featurizer(list(elements), rcut), occurs,
                             dtype=torch.float64, **kw)
    m.load_param_tree(params)
    return jm, params, m


def _cell(elements):
    if elements == ("Ni",):
        return lattice("fcc", 3.52, 2, ["Ni"], sigma=0.08)
    return lattice("bcc", 3.16, 2, ["Mo", "Ni", "Ni"], sigma=0.08)


@pytest.mark.parametrize("cls,fns,elements,per_term", MODEL_CASES)
def test_eam_models_match_jax(cls, fns, elements, per_term):
    """E/F/S and atomic energies of the port's model on the flat layout
    against the JAX model's, <= 1e-10; a batch of two is one
    evaluation that gives each structure's own energy."""
    syms, pos, cell = _cell(elements)
    js, s = both(syms, pos, cell)
    jm, params, m = _model_pair(cls, fns, elements, per_term,
                                Counter(syms))
    assert m.as_dict() == jm.as_dict()
    assert model_feature_layout(m) == "segment"
    feats = m.featurizer.featurize(
        s, layout="segment", nij_max=m.featurizer.neighbor_size(s).nij + 11)
    want = jax.jit(jax_efs(jm.variational_energy, lambda p, f: {
        "atomic_energies": jm.atomic_energies(p, f)}))(
        params, {k: jnp.asarray(v) for k, v in feats.items()})
    t = {k: _t(v) for k, v in feats.items()}
    got = make_efs_fn(m.energy_and_aux)(t)
    for key in ("energy", "forces", "stress_voigt", "atomic_energies"):
        assert _rel(got[key], want[key]) <= REL, key
    moved = dict(t, positions=t["positions"] + 0.02 * torch.sin(
        t["positions"]))
    batch = {k: torch.stack([a, b]) for k, a, b in
             ((k, t[k], moved[k]) for k in t)}
    energies = m.energy(batch)
    assert energies.shape == (2,)
    assert _rel(energies[0], got["energy"]) <= 1e-13
    assert _rel(energies[1], m.energy(moved)) <= 1e-13


@pytest.mark.parametrize("cls,fns,elements,per_term", MODEL_CASES)
def test_fast_efs_matches_autodiff_and_jax(cls, fns, elements, per_term):
    """The analytic EFS on the dense layout against autograd on the flat
    layout, and against the JAX fast EFS, <= 1e-10."""
    syms, pos, cell = _cell(elements)
    js, s = both(syms, pos, cell)
    jm, params, m = _model_pair(cls, fns, elements, per_term,
                                Counter(syms))
    feats = m.featurizer.featurize(s, layout="both", nnl_max=96)
    t = {k: _t(v) for k, v in feats.items()}
    auto = make_efs_fn(m.energy_and_aux)(t)
    fast = make_fast_efs_fn(m)(t)
    want = jax.jit(jax_fast(jm))(params, {k: jnp.asarray(v)
                                          for k, v in feats.items()})
    for key in ("energy", "forces", "stress_voigt", "total_pressure",
                "atomic_energies"):
        assert _rel(fast[key], auto[key]) <= REL, key
        assert _rel(fast[key], want[key]) <= REL, key


def test_fixed_parameters_get_zero_gradients_as_in_jax():
    """Parameters that JAX stops (`always_fixed`, `fixed_functions`) get
    no gradient from autograd; the trainer counts them as zero, so every
    leaf keeps its optimizer slot, as optax's."""
    from tensoralloy_tpu_torch.nn import losses as L
    from tensoralloy_tpu_torch.train.trainer import (OptParameters,
                                                     TrainParameters,
                                                     Trainer)
    syms, pos, cell = _cell(("Mo", "Ni"))
    js, s = both(syms, pos, cell)
    jm, params, m = _model_pair("AdpNN", "analytic", ("Mo", "Ni"), True,
                                Counter(syms))
    feats = m.featurizer.featurize(s, layout="segment")

    def jloss(p):
        out = jax_efs(jm.variational_energy)(p, {
            k: jnp.asarray(v) for k, v in feats.items()})
        return jnp.sum(out["forces"] ** 2) + out["energy"]

    want = tree_flatten(jax.device_get(jax.jit(jax.grad(jloss))(params)))
    trainer = Trainer(m, L.LossParameters(), OptParameters(),
                      TrainParameters(), minimize_properties=("forces",),
                      device="cpu", dtype="high")
    tree = tree_map(_t, params)
    leaves = {k: v.requires_grad_() for k, v in tree_flatten(tree).items()}
    from tensoralloy_tpu_torch.utils import tree_unflatten
    out = make_efs_fn(lambda f: m.energy_and_aux(
        f, tree_unflatten(leaves)), create_graph=True)(
        {k: _t(v) for k, v in feats.items()})
    loss = torch.sum(out["forces"] ** 2) + out["energy"]
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    got = dict(zip(leaves, grads))
    assert set(got) == set(want)
    zero = [k for k, v in want.items() if not np.any(np.asarray(v))]
    assert "zjw04xc/Mo/r_eq" in zero and "zjw04xc/Mo/F0" in zero
    for k in zero:
        assert got[k] is None or not torch.any(got[k]), k
    for k in set(want) - set(zero):
        assert _rel(got[k], want[k]) <= 1e-9, k
    # the trainer's gradient tree has every leaf, zeros where JAX stops
    labels = {"energy": torch.zeros(1, dtype=torch.float64),
              "n_atoms": torch.full((1,), float(len(s)), dtype=torch.float64),
              "forces": torch.zeros((1, m.n_atoms_vap, 3),
                                    dtype=torch.float64)}
    batch = {k: _t(v)[None] for k, v in feats.items()}
    (_, _), g = trainer.loss_and_grads(tree_map(_t, params), batch, labels,
                                       0)
    flat = tree_flatten(g)
    assert set(flat) == set(want)
    assert all(not torch.any(flat[k]) for k in zero)


# ----------------------------------------------------------------------
# setfl files
# ----------------------------------------------------------------------

def _assert_setfl_equal(got, want, rel=REL):
    for name in ("elements", "nrho", "nr", "mass", "lattice", "structure"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("drho", "dr", "cutoff"):
        assert abs(getattr(got, name) - getattr(want, name)) <= 1e-15 * abs(
            getattr(want, name)), name
    for name in ("frho", "rho", "phi", "dipole", "quadrupole"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if b is not None:
            assert set(a) == set(b), name
            for k in b:
                assert _rel(a[k], b[k]) <= rel, (name, k)


@pytest.mark.parametrize("cls", ["EamAlloyNN", "EamFsNN", "AdpNN"])
def test_setfl_export_reads_as_the_jax_file(cls, tmp_path):
    """The port's export and the JAX export of the same parameters: each
    package's reader reads either file to the same tables <= 1e-10."""
    jm, params, m = _model_pair(cls, "analytic", ("Mo", "Ni"), True,
                                Counter({"Mo": 2, "Ni": 2}))
    kw = dict(nr=300, nrho=200, rho_max=60.0)
    got = m.export_to_setfl(str(tmp_path / "port.eam"), tree_map(
        _t, params), **kw)
    want = jm.export_to_setfl(str(tmp_path / "jax.eam"), params, **kw)
    _assert_setfl_equal(got, want)
    style = "fs" if cls == "EamFsNN" else "alloy"
    read = {}
    for path in ("port.eam", "jax.eam"):
        read[path] = lammps.read_eam_alloy_setfl(
            str(tmp_path / path), is_adp=cls == "AdpNN", style=style)
        jread = jax_lammps.read_eam_alloy_setfl(
            str(tmp_path / path), is_adp=cls == "AdpNN", style=style)
        _assert_setfl_equal(read[path], jread, rel=0.0)
    _assert_setfl_equal(read["port.eam"], read["jax.eam"])
    reader = {"EamFsNN": lammps.read_eam_fs_setfl,
              "AdpNN": lammps.read_adp_setfl}.get(
        cls, lammps.read_eam_alloy_setfl)
    writer = {"EamFsNN": lammps.write_eam_fs_setfl,
              "AdpNN": lammps.write_adp_setfl}.get(
        cls, lammps.write_eam_alloy_setfl)
    writer(str(tmp_path / "again.eam"), read["port.eam"])
    _assert_setfl_equal(reader(str(tmp_path / "again.eam")),
                        read["port.eam"], rel=1e-13)


def test_spline_potential_reads_the_repo_tables_as_jax():
    """spline@ on the ADP table in the repo: the table's data and every
    function as in JAX (the function test above holds derivatives)."""
    got = potentials.resolve_potential(f"spline@{ADP_TABLE}")
    want = jax_potentials.resolve_potential(f"spline@{ADP_TABLE}")
    assert got.style == want.style == "adp"
    _assert_setfl_equal(got.data, want.data, rel=0.0)
    assert got.initial_params(["Mo"]) == {}
    with pytest.raises(ValueError, match="unknown potential"):
        potentials.resolve_potential("nope")


# ----------------------------------------------------------------------
# calculator routes and the fixtures
# ----------------------------------------------------------------------

SERVED = {"mleam_ni": ("artifacts/mleam_ni/model/snap_Ni_mleam.npz",
                       "fcc", "Ni", 3),
          "mladp_mo_v5": ("artifacts/mladp_mo_v5/model/"
                          "snap_Mo_mladp_gw.npz", "bcc", "Mo", 4)}


def fixture_structure(name):
    """The jittered cell of a served fixture (108 Ni, 128 Mo atoms)."""
    _, kind, el, reps = SERVED[name]
    return lattice(kind, LATTICE[el], reps, [el], sigma=0.05, seed=0)


def jax_reference(name) -> dict:
    """The JAX calculator on the fixture cell, float64 parameters, the
    default (fast) route."""
    from tensoralloy_tpu.io.model import load_model as jax_load
    path = SERVED[name][0]
    jm, jp, _ = jax_load(str(ROOT / path))
    jp = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), jp)
    syms, pos, cell = fixture_structure(name)
    res = JaxCalculator(jm, params=jp).calculate(
        JaxStructure.from_symbols(syms, pos, cell, pbc=[True] * 3))
    return {"model": path, "positions": pos.tolist(),
            "cell": cell.tolist(), "energy": float(res["energy"]),
            "forces": np.asarray(res["forces"]).tolist(),
            "stress": np.asarray(res["stress"]).tolist()}


@pytest.mark.parametrize("name", sorted(SERVED))
def test_reference_fixture_is_current(name):
    """tests/data/torch_port_ref_eam_<name>.json (chip_smoke.py's float64
    reference) equals the JAX calculator now, and both routes of the
    port's calculator give it to 1e-10."""
    ref = json.loads((DATA / f"torch_port_ref_eam_{name}.json").read_text())
    want = jax_reference(name)
    assert ref["positions"] == want["positions"]
    for key in ("energy", "forces", "stress"):
        assert _rel(ref[key], want[key]) <= 1e-13, key
    syms, pos, cell = fixture_structure(name)
    s = Structure.from_symbols(syms, pos, cell, pbc=[True] * 3)
    for fast in (True, False):
        calc = TensorAlloyCalculator(str(ROOT / ref["model"]), device="cpu",
                                     dtype="high", fast_efs=fast)
        assert calc.layout == ("dense" if fast else "segment")
        res = calc.calculate(s)
        for key in ("energy", "forces", "stress"):
            assert _rel(res[key], ref[key]) <= REL, (fast, key)


def main():
    for name in sorted(SERVED):
        path = DATA / f"torch_port_ref_eam_{name}.json"
        path.write_text(json.dumps(jax_reference(name)) + "\n")
        print(f"wrote {path}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from tensoralloy_tpu import set_precision
    set_precision("high")
    os.chdir(ROOT)
    main()
