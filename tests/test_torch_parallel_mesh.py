"""The port's `parallel/` against the JAX package's on its virtual CPU
devices (tests/conftest.py), float64: `make_mesh`, `shard_batch`,
`pad_pair_axis` and `_pad_dense_columns` key by key (the transpose
remap included), the spatial shards, spatially sharded EFS at 2 and 4
gloo ranks (segment: EAM, ADP, angular SF and GRAP; fast dense: EAM and
ADP) and `dryrun_multichip(2)`, each against JAX's sharded function and
the port's one process to 1e-10.

The ranks are spawned by `parallel.mesh.launch` (gloo, one CPU thread
each): one launch a test, which runs all of its cases
(`parallel.ranks.run_all`).
"""
import json
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from tensoralloy_tpu.atoms import Structure as JaxStructure
from tensoralloy_tpu.ensemble import EnsembleCalculator as JaxEnsemble
from tensoralloy_tpu.neb import NEB as JaxNEB
from tensoralloy_tpu.nn.atomic import AtomicNN as JaxAtomicNN
from tensoralloy_tpu.nn.eam import AdpNN as JaxAdpNN
from tensoralloy_tpu.nn.eam import EamAlloyNN as JaxEamAlloyNN
from tensoralloy_tpu.nn.grap import GenericRadialAtomicPotential as JaxGrap
from tensoralloy_tpu.nn import losses as JL
from tensoralloy_tpu.parallel import mesh as jax_mesh
from tensoralloy_tpu.parallel import spatial as jax_spatial
from tensoralloy_tpu.train.trainer import (OptParameters as JaxOpt,
                                           TrainParameters as JaxTP,
                                           Trainer as JaxTrainer)
from tensoralloy_tpu.transform import Featurizer as JaxFeaturizer
from tensoralloy_tpu_torch.io.model import model_from_dict, save_model
from tensoralloy_tpu_torch.parallel import dryrun, ranks, spatial
from tensoralloy_tpu_torch.parallel.mesh import (Mesh, launch, make_mesh,
                                                 shard_batch)

REL = 1e-10
JOIN = 120.0      # seconds a launch may take before its ranks are killed


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))
                 / max(np.max(np.abs(want)), 1e-300))


def port_twin(model, params):
    """The port's model of a JAX model's config, with its parameters."""
    twin = model_from_dict(json.loads(json.dumps(model.as_dict())),
                           device="cpu", dtype=torch.float64)
    twin.load_param_tree(jax.tree_util.tree_map(np.asarray, params))
    return twin


def model_file(model, params, path) -> str:
    """A JAX model and its parameters saved by the port (both packages
    read the file); -> the path."""
    twin = port_twin(model, params)
    save_model(str(path), twin, twin.param_tree())
    return str(path)


def jittered(symbols, frac, cell, sigma, seed):
    pos = frac @ cell + np.random.RandomState(seed).normal(
        scale=sigma, size=(len(frac), 3))
    return JaxStructure.from_symbols(symbols, pos, cell, pbc=[True] * 3)


def ni32(seed):
    """The JAX spatial tests' rattled 32-atom fcc Ni cell."""
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    frac = np.concatenate([base + [i, j, k] for i in range(2)
                           for j in range(2) for k in range(2)]) / 2
    return jittered(["Ni"] * 32, frac, np.eye(3) * 7.04, 0.08, seed)


def moni16(seed=4):
    """A rattled 16-atom bcc Mo/Ni cell."""
    frac = np.concatenate([np.array([[0, 0, 0], [.5, .5, .5]]) + [i, j, k]
                           for i in range(2) for j in range(2)
                           for k in range(2)]) / 2
    symbols = ["Mo", "Ni"] * 8
    return jittered(symbols, frac, np.eye(3) * 6.3, 0.08, seed)


def _jax_params(model, seed):
    return model.init_params(jax.random.PRNGKey(seed))


def spatial_cases(tmp):
    """name -> (route, JAX model, JAX params, numpy features): the flat
    layout's EAM, ADP, angular SF and GRAP, the dense layout's EAM and
    ADP."""
    cases = {}
    s = ni32(7)
    fz = JaxFeaturizer(["Ni"], rcut=5.0)
    eam = JaxEamAlloyNN(fz, Counter(s.symbols), custom_potentials="zjw04")
    cases["eam"] = ("segment", eam, _jax_params(eam, 0), fz.featurize(
        s, fz.make_vap(s, eam.max_occurs), layout="segment"))
    s2 = moni16()
    fz2 = JaxFeaturizer(["Mo", "Ni"], rcut=4.5)
    adp = JaxAdpNN(fz2, Counter(s2.symbols), hidden_sizes=[8])
    adp_params = _jax_params(adp, 1)
    vap2 = fz2.make_vap(s2, adp.max_occurs)
    cases["adp"] = ("segment", adp, adp_params,
                    fz2.featurize(s2, vap2, layout="segment"))
    sf_model, sf_feats = __graft_entry__._make_model_and_features(
        n_atoms=8, angular=True)
    cases["sf"] = ("segment", sf_model, _jax_params(sf_model, 2),
                   {k: np.asarray(v) for k, v in sf_feats.items()})
    desc = JaxGrap(["Ni"], algorithm="pexp",
                   parameters={"rl": [1.0, 1.5, 2.0], "pl": [2.0, 2.5, 3.0]},
                   moment_tensors=[0, 1, 2], backend="segment")
    fz3 = JaxFeaturizer(["Ni"], rcut=4.5)
    grap = JaxAtomicNN(fz3, Counter(s.symbols), desc, hidden_sizes=[8],
                       minmax_scale=False)
    cases["grap"] = ("segment", grap, _jax_params(grap, 3), fz3.featurize(
        s, fz3.make_vap(s, grap.max_occurs), layout="segment"))
    s4 = ni32(9)
    cases["fast_eam"] = ("fast", eam, _jax_params(eam, 0), fz.featurize(
        s4, fz.make_vap(s4, eam.max_occurs), layout="dense"))
    cases["fast_adp"] = ("fast", adp, adp_params,
                         fz2.featurize(s2, vap2, layout="dense"))
    return cases


def jax_spatial_efs(route, model, params, feats, n):
    mesh = jax_mesh.make_mesh(n, axis_name="pairs")
    if route == "fast":
        fn = jax_spatial.make_spatial_fast_efs_fn(model, mesh)
        return fn(params, jax_spatial.shard_features_spatial_dense(
            feats, mesh))
    fn = jax_spatial.make_spatial_efs_fn(model.energy, mesh)
    return fn(params, jax_spatial.shard_features_spatial(feats, mesh))


# ----------------------------------------------------------------------
def test_mesh_and_batch_shards_match_jax():
    """One process is a mesh of one rank; more ranks than the group has
    raise JAX's ValueError; rank r's block of a batch is JAX's shard r;
    scalars stay whole."""
    mesh = make_mesh()
    assert (mesh.size, mesh.rank, mesh.shape) == (1, 0, {"data": 1})
    with pytest.raises(ValueError,
                       match="requested 2 devices but only 1 available"):
        make_mesh(2)
    with pytest.raises(ValueError,
                       match="requested 9 devices but only 8 available"):
        jax_mesh.make_mesh(9)
    rng = np.random.default_rng(0)
    batch = {"x": rng.normal(size=(8, 3, 2)), "i": np.arange(8),
             "s": np.float64(3.0)}
    for n in (2, 4):
        jax_sharded = jax_mesh.shard_batch(batch, jax_mesh.make_mesh(n))
        for r in range(n):
            got = shard_batch(batch, Mesh("data", n, r,
                                          torch.device("cpu")))
            for k in ("x", "i"):
                shards = sorted(jax_sharded[k].addressable_shards,
                                key=lambda sh: sh.device.id)
                np.testing.assert_array_equal(got[k], shards[r].data)
            assert got["s"] == batch["s"]
            t = shard_batch({k: torch.as_tensor(v) for k, v in batch.items()},
                            Mesh("data", n, r, torch.device("cpu")))
            np.testing.assert_array_equal(t["x"].numpy(), got["x"])
    with pytest.raises(ValueError, match="evenly"):
        shard_batch({"x": np.zeros(6)}, Mesh("data", 4, 0,
                                             torch.device("cpu")))


def test_padding_and_spatial_shards_match_jax():
    """`pad_pair_axis`, `_pad_dense_columns` (the transpose tables
    remapped to the padded width) and the per-rank shards of both
    layouts, key by key, numpy and tensors."""
    s = ni32(5)
    fz = JaxFeaturizer(["Ni"], rcut=4.5, angular=True, acut=3.5)
    feats = fz.featurize(s, fz.make_vap(s, Counter(s.symbols)),
                         layout="both", transpose=True)
    assert spatial.is_pairwise_key("trip_shift_j")
    assert not spatial.is_pairwise_key("pair_j_d")
    assert not spatial.is_pairwise_key("positions")
    for multiple in (3, 4, 8):
        want = jax_spatial.pad_pair_axis(feats, multiple)
        got = spatial.pad_pair_axis(feats, multiple)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        want = jax_spatial._pad_dense_columns(feats, multiple)
        for got in (spatial._pad_dense_columns(feats, multiple),
                    spatial._pad_dense_columns(
                        {k: torch.as_tensor(v) for k, v in feats.items()},
                        multiple)):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                              err_msg=k)
    # the remap is exercised: the widths were not multiples of 8
    assert feats["pair_j_d"].shape[1] % 8 and feats["trip_j_d"].shape[1] % 8
    for n in (2, 4):
        jmesh = jax_mesh.make_mesh(n, axis_name="pairs")
        for shard, jshard, axis in (
                (spatial.shard_features_spatial,
                 jax_spatial.shard_features_spatial, 0),
                (spatial.shard_features_spatial_dense,
                 jax_spatial.shard_features_spatial_dense, 1)):
            want = jshard(feats, jmesh)
            for r in range(n):
                got = shard(feats, Mesh("pairs", n, r, torch.device("cpu")))
                for k, v in want.items():
                    shards = sorted(v.addressable_shards,
                                    key=lambda sh: sh.device.id)
                    np.testing.assert_array_equal(got[k], shards[r].data,
                                                  err_msg=(k, axis))


def test_spatial_efs_matches_jax_and_one_rank(tmp_path):
    """E, forces and stress of each case with its pairs (or dense
    columns) split over 2 gloo ranks, and of the flat EAM and SF cases
    over 4: equal on every rank,
    and to 1e-10 of JAX's sharded function on as many virtual devices
    and of the port's one process."""
    cases = spatial_cases(tmp_path)
    specs = {name: {"model": model_file(m, p, tmp_path / f"{name}.npz"),
                    "route": route, "features": feats, "device": "cpu",
                    "dtype": "high"}
             for name, (route, m, p, feats) in cases.items()}
    one = {name: ranks.spatial_efs(spec) for name, spec in specs.items()}
    # every case at 2 ranks, the flat EAM and SF also at 4
    for n, names in ((2, list(cases)), (4, ["eam", "sf"])):
        got = launch(ranks.run_all, n, [(ranks.spatial_efs, specs[name])
                                        for name in names],
                     device="cpu", timeout=JOIN)
        for i, name in enumerate(names):
            route, m, p, feats = cases[name]
            want = jax_spatial_efs(route, m, p, feats, n)
            per_rank = [g[i] for g in got]
            assert all(r["ranks"] == n for r in per_rank)
            assert ranks.all_equal(per_rank, ("energy", "forces",
                                              "stress_voigt")), name
            res = per_rank[0]
            for key, jkey in (("energy", "energy"), ("forces", "forces"),
                              ("stress_voigt", "stress_voigt")):
                assert rel_err(res[key], want[jkey]) <= REL, (name, n, key)
                assert rel_err(res[key], one[name][key]) <= REL, (name, key)
    assert all(one[name]["ranks"] == 1 for name in one)


def test_dryrun_multichip_matches_one_rank_and_jax():
    """`dryrun_multichip(2)` on two gloo ranks against the same four
    modes in one process (1e-10) and against the JAX package's sharded
    functions on two virtual devices: the train step's loss and the
    spatial energy at the port's initial parameters, the fast EAM energy,
    the NEB band's energies and fmax, the committee's mean."""
    got = dryrun.dryrun_multichip(2, device="cpu", timeout=JOIN)
    model, _ = dryrun.make_model_and_features(n_atoms=8)
    params = model.init_params(torch.Generator().manual_seed(0))
    one = dryrun.dryrun_rank(2, "cpu", shards=1, params=params)
    for key in ("loss", "spatial_E", "spatial_forces", "fast_spatial_E",
                "neb_fmax", "neb_energies", "ensemble_E"):
        assert rel_err(got[key], one[key]) <= REL, key
    # the ideal 8-atom cell: forces zero by symmetry, rounding apart
    assert np.max(np.abs(got["fast_forces"])) <= 1e-12
    assert np.max(np.abs(np.asarray(one["fast_forces"]))) <= 1e-12
    assert got["ensemble_std"] == one["ensemble_std"] == 0.0

    # JAX: the dry run's modes on two virtual devices
    jparams = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x.numpy()), params)
    jmodel, jfeats = __graft_entry__._make_model_and_features(
        n_atoms=8, angular=True)
    trainer = JaxTrainer(jmodel, JL.LossParameters(),
                         JaxOpt(learning_rate=1e-3),
                         JaxTP(batch_size=4, train_steps=1),
                         minimize_properties=("energy", "forces", "stress"),
                         n_devices=2)
    n_vap = jmodel.n_atoms_vap
    bf = {k: jnp.stack([v] * 4) for k, v in jfeats.items()}
    bl = {"energy": jnp.zeros(4), "n_atoms": jnp.full(4, n_vap - 1.0),
          "forces": jnp.zeros((4, n_vap, 3)), "stress": jnp.zeros((4, 6)),
          "has_stress": jnp.ones(4), "weights": jnp.ones((4, 3))}
    state = jax_mesh.replicate(trainer.init_state(jparams), trainer.mesh)
    new_state, metrics = trainer._build_train_step()(
        state, jax_mesh.shard_batch(bf, trainer.mesh),
        jax_mesh.shard_batch(bl, trainer.mesh))
    assert rel_err(got["loss"], metrics["loss/total"]) <= REL
    want = jax_spatial_efs("segment", jmodel, new_state["params"],
                           {k: np.asarray(v) for k, v in jfeats.items()}, 2)
    assert rel_err(got["spatial_E"], want["energy"]) <= REL
    assert rel_err(got["spatial_forces"], want["forces"]) <= REL

    s = dryrun.eam_cell()
    js = JaxStructure.from_symbols(s.symbols, s.positions, s.cell,
                                   pbc=[True] * 3)
    fz = JaxFeaturizer(["Ni"], rcut=6.0)
    eam = JaxEamAlloyNN(fz, Counter({"Ni": 8}), custom_potentials="zjw04")
    want = jax_spatial_efs("fast", eam, _jax_params(eam, 0), fz.featurize(
        js, fz.make_vap(js, eam.max_occurs), layout="dense"), 2)
    assert rel_err(got["fast_spatial_E"], want["energy"]) <= REL
    assert np.max(np.abs(np.asarray(want["forces"]))) <= 1e-12

    si, sf = (JaxStructure.from_symbols(x.symbols, x.positions, x.cell,
                                        pbc=[True] * 3)
              for x in dryrun.vacancy_hop())
    neb_model = JaxEamAlloyNN(JaxFeaturizer(["Ni"], rcut=6.0),
                              Counter(si.symbols), custom_potentials="zjw04")
    neb_params = _jax_params(neb_model, 0)
    jneb = JaxNEB(neb_model, neb_params, si, sf, n_images=4, k=5.0,
                  chunk_size=4, n_shards=2)
    jres = jneb.run(fmax=1e-9, max_steps=2)
    assert rel_err(got["neb_energies"], jres["energies"]) <= REL
    assert rel_err(got["neb_fmax"], jres["fmax"]) <= REL
    ens = JaxEnsemble(neb_model, [neb_params] * 2, n_shards=2)
    assert rel_err(got["ensemble_E"], ens.get_potential_energy(si)) <= REL
