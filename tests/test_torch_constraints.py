"""The constraint losses in the port against the JAX package at float64:
the crystal library, and each constraint's loss and its gradient w.r.t.
the model's parameters, on crystals built in the test, with the saved
EAM/ADP models of the repo (and a GRAP and a finite-temperature model
where a constraint serves those). The elastic loss's gradient is a
third derivative of the energy: 1e-8; the rest 1e-10."""
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoralloy_tpu.io.model import load_model as jax_load_model
from tensoralloy_tpu.io.sqlite import connect as jax_connect
from tensoralloy_tpu.nn import constraints as jax_constraints
from tensoralloy_tpu.nn.fields import make_hessian_fn as jax_hessian_fn
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.data import crystals
from tensoralloy_tpu_torch.io.model import load_model
from tensoralloy_tpu_torch.io.sqlite import connect
from tensoralloy_tpu_torch.nn import constraints
from tensoralloy_tpu_torch.nn.fields import make_hessian_fn
from tensoralloy_tpu_torch.utils import (tree_flatten, tree_map,
                                         tree_unflatten)

ROOT = Path(__file__).resolve().parent.parent
MODELS = {
    "eam": "artifacts/mleam_ni/model/snap_Ni_mleam.npz",
    "adp": "artifacts/mladp_mo_v5/model/snap_Mo_mladp_gw.npz",
    "grap": "artifacts/snap_ni_v5_readapt/model/snap_Ni.npz",
    "td": "artifacts/td_be/model/td_Be.npz",
}
REL = 1e-10
REL_THIRD = 1e-8


def _rel(a, b) -> float:
    a, b = (np.asarray(x.detach() if isinstance(x, torch.Tensor) else x,
                       np.float64) for x in (a, b))
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def models(name, jitter=0.01, seed=3):
    """(JAX model, float64 parameters moved by up to `jitter` from the
    saved ones, the port's model), both packages at float64."""
    path = str(ROOT / MODELS[name])
    jm, params, _ = jax_load_model(path)
    rng = np.random.default_rng(seed)
    params = tree_map(lambda v: np.asarray(v, np.float64) * (
        1 + rng.uniform(-jitter, jitter)), jax.device_get(params))
    m, _ = load_model(path, device="cpu", dtype="high")
    return jm, params, m


def loss_and_grads(constraint, params):
    """The port constraint's loss and its gradient tree (zeros where the
    loss does not reach), as the trainer computes them."""
    leaves = {k: torch.as_tensor(np.asarray(v)).requires_grad_()
              for k, v in tree_flatten(params).items()}
    with torch.enable_grad():
        loss = constraint.loss(tree_unflatten(leaves))
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(leaves.items(), grads)}


def jax_loss_and_grads(constraint, params):
    jp = tree_map(jnp.asarray, params)
    loss, grads = jax.jit(jax.value_and_grad(constraint.loss))(jp)
    return float(loss), tree_flatten(jax.device_get(grads))


def assert_same(got, want, rel=REL):
    (loss, grads), (jloss, jgrads) = got, want
    assert np.isfinite(float(loss)) and np.isfinite(jloss)
    assert _rel(loss, jloss) <= REL
    assert set(grads) == set(jgrads)
    top = max(float(np.max(np.abs(v))) for v in jgrads.values())
    for k, v in jgrads.items():
        assert torch.isfinite(grads[k]).all(), k
        err = float(np.max(np.abs(grads[k].numpy() - np.asarray(v))))
        assert err <= rel * max(top, 1e-300), (k, err, top)


# ----------------------------------------------------------------------
def test_crystal_library_matches_jax():
    """Every built-in crystal, and the bundled TOML with its flat cNM
    keys, resolve to the same structures and constants as in JAX; the
    port reads its own copy of the data files."""
    from tensoralloy_tpu.data.crystals import (built_in_crystals as
                                               jax_built_in)
    got, want = crystals.built_in_crystals(), jax_built_in()
    assert set(got) == set(want)
    toml = "Ni3Mo_elastic_tensor.toml"
    pairs = [(got[k], want[k]) for k in want] + [
        (constraints.get_crystal(toml, crystals.crystal_data_dir()),
         jax_constraints.get_crystal(
             str(ROOT / "tensoralloy_tpu/data/crystals" / toml)))]
    assert crystals.crystal_data_dir().startswith(
        str(ROOT / "tensoralloy_tpu_torch"))
    for a, b in pairs:
        assert (a.name, a.phase, a.bulk_modulus, a.temperature) == \
            (b.name, b.phase, b.bulk_modulus, b.temperature)
        assert [(c.vi, c.vj, c.value, c.weight)
                for c in a.elastic_constants] == \
            [(c.vi, c.vj, c.value, c.weight) for c in b.elastic_constants]
        assert a.structure.symbols == b.structure.symbols
        np.testing.assert_allclose(a.structure.positions,
                                   b.structure.positions, atol=1e-12)
        np.testing.assert_allclose(a.structure.cell, b.structure.cell,
                                   atol=1e-12)
    with pytest.raises(ValueError, match="cannot resolve"):
        constraints.get_crystal("Unobtainium")


@pytest.mark.parametrize("name,crystal", [("eam", "Ni"), ("adp", "Mo"),
                                          ("grap", "Ni")])
def test_elastic_constraint_matches_jax(name, crystal):
    """C_ij, the loss and its parameter gradient (a third derivative),
    <= 1e-8; the same constraint serves a GRAP model."""
    jm, params, m = models(name)
    want_c = jax_constraints.ElasticConstraint(jm, [crystal], weight=0.05)
    got_c = constraints.ElasticConstraint(m, [crystal], weight=0.05)
    (spec, jv, jf), (_, v, f) = want_c.entries[0], got_c.entries[0]
    want = jax.jit(lambda p: jax_constraints.elastic_tensor(jv, p, jf))(
        tree_map(jnp.asarray, params))
    got = constraints.elastic_tensor(v, tree_map(torch.as_tensor, params),
                                     f)
    assert _rel(got, want) <= REL_THIRD
    assert_same(loss_and_grads(got_c, params),
                jax_loss_and_grads(want_c, params), rel=REL_THIRD)


@pytest.mark.parametrize("name,crystal", [("eam", "Ni"), ("adp", "Mo")])
def test_rose_constraint_matches_jax(name, crystal):
    """At the perfect crystal (zero forces, the norms' eps guards) with
    the saved parameters, and with an embedding pushed up until the
    crystal is unbound (E0 >= 0: the clamps of E0 and a), the loss and
    its gradient are finite and equal JAX's."""
    options = dict(crystals=[crystal], weight=3.0, beta=[0.005])
    jm, params, m = models(name, jitter=0.0)
    pushed = tree_map(lambda v: v, params)
    section = pushed["zjw04xc"][crystal]
    for key in ("F0", "F2", "Fn0", "Fe"):
        section[key] = np.abs(section[key]) * 3.0
    section["A"] = section["A"] * 6.0
    for p in (params, pushed):
        want_c = jax_constraints.RoseConstraint(
            jm, jax_constraints.RoseConstraintOptions(**options))
        got_c = constraints.RoseConstraint(
            m, constraints.RoseConstraintOptions(**options))
        want = jax_loss_and_grads(want_c, p)
        assert_same(loss_and_grads(got_c, p), want)
    _, variant, eq, *_ = want_c.entries[0]
    assert float(variant.variational_energy(
        tree_map(jnp.asarray, pushed), eq)) > 0.0
    # E_target and p_target, both given
    options.update(E_target=[-20.0], p_target=[1.0])
    assert_same(loss_and_grads(constraints.RoseConstraint(
        m, constraints.RoseConstraintOptions(**options)), params),
        jax_loss_and_grads(jax_constraints.RoseConstraint(
            jm, jax_constraints.RoseConstraintOptions(**options)), params))


@pytest.mark.parametrize("method", ["mae", "logcosh"])
def test_energy_difference_constraint_matches_jax(method):
    from tensoralloy_tpu.data import crystals as jax_crystals
    jm, params, m = models("eam")

    def specs(lib, cls):
        return dict(references=[cls(name="fcc", structure=lib.fcc("Ni",
                                                                  3.52))],
                    crystals=[cls(name="bcc", structure=lib.bcc("Ni", 2.80))])

    kw = dict(diffs=[0.05], weight=2.0, method=method)
    want_c = jax_constraints.EnergyDifferenceConstraint(
        jm, **specs(jax_crystals, jax_constraints.CrystalSpec), **kw)
    got_c = constraints.EnergyDifferenceConstraint(
        m, **specs(crystals, constraints.CrystalSpec), **kw)
    assert_same(loss_and_grads(got_c, params),
                jax_loss_and_grads(want_c, params))


def test_entropy_constraint_matches_jax():
    """The electron entropy of a finite-temperature model at 0.1 eV."""
    from tensoralloy_tpu.data import crystals as jax_crystals
    jm, params, m = models("td")

    def spec(lib, cls):
        return cls(name="Be", structure=lib.hcp("Be", 2.29, 3.59),
                   temperature=0.1, eentropy=0.002)

    want_c = jax_constraints.EntropyConstraint(
        jm, [spec(jax_crystals, jax_constraints.CrystalSpec)], weight=2.0)
    got_c = constraints.EntropyConstraint(
        m, [spec(crystals, constraints.CrystalSpec)], weight=2.0)
    assert_same(loss_and_grads(got_c, params),
                jax_loss_and_grads(want_c, params))


def test_force_constants_constraint_matches_jax():
    """A 4-atom bcc Mo supercell against an fc2 reference taken from the
    JAX Hessian of the saved parameters (phonopy layout); the loss at
    moved parameters and its gradient. The port's Hessian equals JAX's."""
    from tensoralloy_tpu.data import crystals as jax_crystals
    jm, saved, m = models("adp", jitter=0.0)
    _, params, _ = models("adp", jitter=0.01)
    unit = jax_crystals.bcc("Mo", 3.16)
    sc = unit.repeat((2, 1, 1))
    sc.positions = sc.positions + np.random.default_rng(2).normal(
        0.0, 0.02, sc.positions.shape)
    variant = jm.clone_for(dict(Mo=len(sc)))
    vap = variant.featurizer.make_vap(sc)
    feats = {k: jnp.asarray(v) for k, v in
             variant.featurizer.featurize(sc, vap).items()}
    h = np.asarray(jax.jit(jax_hessian_fn(variant.variational_energy))(
        tree_map(jnp.asarray, saved), feats))
    idx = vap.local_to_vap
    fc2 = h[idx][:, :, idx, :].transpose(0, 2, 1, 3)

    port_sc = Structure(sc.numbers, sc.positions, sc.cell, sc.pbc)
    port_variant = m.clone_for(dict(Mo=len(sc)))
    port_feats = {k: torch.as_tensor(v) for k, v in
                  port_variant.featurizer.featurize(
                      port_sc, layout="segment").items()}
    got_h = make_hessian_fn(port_variant.energy_and_aux)(port_feats)
    assert _rel(got_h, h) <= REL

    def spec(cls, s):
        return cls(name="Mo", structure=s, supercell=s, fc2=fc2)

    want_c = jax_constraints.ForceConstantsConstraint(
        jm, [spec(jax_constraints.CrystalSpec, sc)], weight=0.5)
    got_c = constraints.ForceConstantsConstraint(
        m, [spec(constraints.CrystalSpec, port_sc)], weight=0.5)
    assert_same(loss_and_grads(got_c, params),
                jax_loss_and_grads(want_c, params))


def test_extra_database_constraint_matches_jax(tmp_path):
    """Energy and force terms on a small extra database (five structures
    of the Ni set, one without an energy label)."""
    source = ROOT / "artifacts/snap_ni_v5/snap-Ni.db"
    shutil.copy(source, tmp_path / "full.db")
    db = connect(str(tmp_path / "extra.db"))
    picked = 0
    for s in jax_connect(str(tmp_path / "full.db")):
        if len(s) > 32 or picked == 5:
            continue
        info = dict(s.info)
        if picked == 2:
            info.pop("energy", None)
        db.write(Structure(s.numbers, s.positions, s.cell, s.pbc,
                           info=info), commit=False)
        picked += 1
    db._con.commit()
    jm, params, m = models("eam")
    for minimize in (("energy",), ("energy", "forces")):
        kw = dict(weight=0.7, minimize=minimize)
        want_c = jax_constraints.ExtraDatabaseConstraint(
            jm, str(tmp_path / "extra.db"), **kw)
        got_c = constraints.ExtraDatabaseConstraint(
            m, str(tmp_path / "extra.db"), **kw)
        assert float(got_c.labels["has_energy"].sum()) == 4.0
        assert_same(loss_and_grads(got_c, params),
                    jax_loss_and_grads(want_c, params))


def test_constraints_follow_the_trainer_to_its_dtype():
    """`to` moves the constant features; a float32 trainer evaluates the
    constraint in float32."""
    from tensoralloy_tpu_torch.nn import losses as L
    from tensoralloy_tpu_torch.train.trainer import (OptParameters,
                                                     TrainParameters,
                                                     Trainer)
    _, params, m = models("eam")
    rose = constraints.RoseConstraint(
        m, constraints.RoseConstraintOptions(crystals=["Ni"]))
    trainer = Trainer(m, L.LossParameters(), OptParameters(),
                      TrainParameters(), constraints=[rose], device="cpu",
                      dtype="medium")
    assert trainer.constraints == [rose]
    feats = rose.entries[0][3]
    assert feats["positions"].dtype == torch.float32
    assert feats["pair_i"].dtype == torch.int32
    loss = rose.loss(tree_map(lambda v: torch.as_tensor(
        np.asarray(v, np.float32)), params))
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
