"""AtomicNN E/F/S in the port against the JAX package at float64, the
weights carried across with `params_from_jax`, and the `.npz` format
read and written by both packages."""
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoralloy_tpu.atoms import Structure as JaxStructure
from tensoralloy_tpu.calculator import (
    TensorAlloyCalculator as JaxCalculator)
from tensoralloy_tpu.io.model import load_model as jax_load_model
from tensoralloy_tpu.nn.atomic import AtomicNN as JaxAtomicNN
from tensoralloy_tpu.nn.sf import SymmetryFunction as JaxSF
from tensoralloy_tpu.ops.dense import make_dense_efs_fn as jax_dense_efs
from tensoralloy_tpu.transform import Featurizer as JaxFeaturizer
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
from tensoralloy_tpu_torch.io.model import (load_model, model_from_dict,
                                            params_from_jax, params_to_jax,
                                            save_model)
from tensoralloy_tpu_torch.nn.fields import make_efs_fn
from tensoralloy_tpu_torch.ops.dense import make_dense_efs_fn

from test_torch_host import fcc_ni, mo_ni

MODEL = "artifacts/snap_ni_sfa/model/snap_Ni_sfa.npz"
REL = 1e-10
# the saved symmetry-function models with other grids than MODEL's
# (10 eta x 2 omega, rcut 6.5, hidden [128, 64, 32]; Mo and Ni)
SF_FILES = {
    run: f"artifacts/{run}/model/{name}.npz" for run, name in (
        ("snap_mo_ref11", "snap_Mo_refsf"),
        ("snap_mo_refsf_cont", "snap_Mo_refsf"),
        ("snap_mo_refsf_cpu", "snap_Mo_refsf"),
        ("snap_mo_refsf_f15", "snap_Mo_refsf"),
        ("snap_mo_refsf_l2", "snap_Mo_refsf"),
        ("snap_mo_refsf_rrmse", "snap_Mo_refsf"),
        ("snap_mo_refsf_s30", "snap_Mo_refsf"),
        ("snap_mo_y15", "snap_Mo_y15"),
        ("snap_ni_refsf", "snap_Ni_refsf"),
        ("snap_ni_refsf_readapt", "snap_Ni_refsf"))}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _features(fz, symbols, pos, cell):
    s = JaxStructure.from_symbols(symbols, pos, cell, pbc=[True] * 3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TENSORALLOY_TPU_NO_NATIVE", "1")
        return fz.featurize(s, fz.make_vap(s), layout="dense",
                            transpose=True)


def _compare(jax_model, jax_params, model, feats):
    """E/F/S of the variational energy (the energy of an AtomicNN) in
    both packages, the port's atomic energies coming out of the same
    pass."""
    want = jax.jit(jax_dense_efs(jax_model.variational_energy))(
        jax_params, {k: jnp.asarray(v) for k, v in feats.items()})
    t_feats = {k: torch.as_tensor(v) for k, v in feats.items()}
    got = make_dense_efs_fn(model.energy_and_aux)(t_feats)
    for key in ("energy", "forces", "stress_voigt", "total_pressure"):
        assert _rel(got[key].numpy(), want[key]) <= REL, key
    # the autodiff-w.r.t.-positions path agrees with the dense assembly
    auto = make_efs_fn(model.energy_and_aux)(t_feats)
    for key in ("energy", "forces", "stress_voigt", "atomic_energies"):
        assert _rel(auto[key].numpy(), got[key].numpy()) <= REL, key
    return got


def test_snap_ni_sfa_matches_jax():
    """The served model, upcast to float64, backend 'pallas', 32 atoms."""
    jax_model, params, _ = jax_load_model(MODEL)
    jax_model.descriptor.backend = "pallas"
    params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                    params)
    model, config = load_model(MODEL, device="cpu", dtype="high",
                               backend="pallas")
    assert config["model"]["descriptor"]["backend"] == "dense"
    assert next(model.parameters()).dtype == torch.float64
    symbols, pos, cell = fcc_ni(2, seed=4)
    jax_model = jax_model.clone_for(Counter(symbols))
    model = model.clone_for(Counter(symbols))
    got = _compare(jax_model, params, model,
                   _features(jax_model.featurizer, symbols, pos, cell))
    assert got["forces"].shape == (33, 3)


def test_random_binary_model_matches_jax():
    """A random-init Mo/Ni model (hidden [8, 8], scaled inputs, static
    energies), carried into the port with params_from_jax."""
    symbols, pos, cell = mo_ni(seed=2)
    fz = JaxFeaturizer(["Mo", "Ni"], rcut=4.5, acut=3.5, angular=True)
    jax_model = JaxAtomicNN(
        fz, Counter(symbols), JaxSF(fz.elements, backend="pallas"),
        hidden_sizes=[8, 8],
        atomic_static_energy={"Mo": -10.9, "Ni": -5.6})
    params = jax_model.init_params(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    for e in ("Mo", "Ni"):   # non-trivial min-max scaling
        lo = rng.uniform(0.0, 0.5, jax_model.feature_dim)
        params[e]["norm"] = {"xlo": jnp.asarray(lo),
                             "xhi": jnp.asarray(lo + rng.uniform(
                                 1.0, 3.0, jax_model.feature_dim))}
    model = model_from_dict(jax_model.as_dict(), dtype=torch.float64)
    model.load_state_dict(params_from_jax(params))
    _compare(jax_model, params, model, _features(fz, symbols, pos, cell))


def test_params_and_npz_round_trip(tmp_path):
    """JAX tree -> port -> JAX tree is bit-identical, and a model the
    port saves loads in both packages with the same weights."""
    with np.load(MODEL) as z:
        flat = {k: z[k] for k in z.files if k != "__config__"}
    jax_model, params, _ = jax_load_model(MODEL)
    back = params_to_jax(params_from_jax(params))
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(jax.tree_util.tree_leaves(back)) == len(leaves) == len(flat)
    for (path, leaf), other in zip(leaves, jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(leaf), other)
        assert np.asarray(leaf).dtype == other.dtype

    model, _ = load_model(MODEL, device="cpu", dtype="medium")
    out = tmp_path / "resaved.npz"
    save_model(str(out), model)
    again, config = load_model(str(out), device="cpu", dtype="medium")
    for (k, a), (k2, b) in zip(model.state_dict().items(),
                               again.state_dict().items()):
        assert k == k2
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert config["model"] == model.as_dict()
    _, jax_params, _ = jax_load_model(str(out))
    with np.load(out) as z:
        for key, value in flat.items():
            np.testing.assert_array_equal(z[key], value)
    for a, b in zip(jax.tree_util.tree_leaves(jax_params),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("run", sorted(SF_FILES))
def test_saved_sf_models_load_and_serve_as_in_jax(run, monkeypatch):
    """Every other saved symmetry-function model: the JAX loader's
    weights bit for bit, and one E/F/S request of 32 jittered atoms
    against the JAX calculator at float64."""
    monkeypatch.setenv("TENSORALLOY_TPU_NO_NATIVE", "1")
    path = SF_FILES[run]
    _, params, config = jax_load_model(path)
    model, _ = load_model(path, device="cpu", dtype="medium")
    assert model.as_dict() == config["model"]
    state, want = model.state_dict(), params_from_jax(params)
    assert set(state) == set(want)
    for key, value in want.items():
        assert torch.equal(state[key], value), key

    element = config["model"]["featurizer"]["elements"][0]
    _, pos, cell = fcc_ni(2, seed=7)
    scale = 3.15 / 3.52 if element == "Mo" else 1.0
    args = ([element] * len(pos), pos * scale, cell * scale)
    res = TensorAlloyCalculator(path, device="cpu", dtype="high").calculate(
        Structure.from_symbols(*args, pbc=[True] * 3))
    jax_s = JaxStructure.from_symbols(*args, pbc=[True] * 3)
    calc = JaxCalculator(path)
    assert _rel(res["energy"], calc.get_potential_energy(jax_s)) <= REL
    assert _rel(res["forces"], calc.get_forces(jax_s)) <= REL
    assert _rel(res["stress"], calc.get_stress(jax_s)) <= REL


def test_segment_backend_serves_as_jax():
    """`load_model(..., backend="segment")` (the flat pair and triple
    arrays, `index_add` sums) serves what the JAX calculator serves from
    the same file, and a file saved without a 'backend' key (the JAX
    constructors' default, 'segment') loads and serves the same."""
    import json
    import tempfile
    _, pos, cell = fcc_ni(2, seed=5)
    args = (["Ni"] * len(pos), pos, cell)
    want = JaxCalculator(MODEL)
    jax_s = JaxStructure.from_symbols(*args, pbc=[True] * 3)
    model, _ = load_model(MODEL, device="cpu", backend="segment")
    assert model.descriptor.backend == "segment"
    with np.load(MODEL) as z:
        flat = {k: z[k] for k in z.files}
    config = json.loads(bytes(flat["__config__"]).decode())
    del config["model"]["descriptor"]["backend"]
    flat["__config__"] = np.frombuffer(json.dumps(config).encode(),
                                       dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        bare = f"{tmp}/bare.npz"
        np.savez(bare, **flat)
        calcs = [TensorAlloyCalculator(model, device="cpu"),
                 TensorAlloyCalculator(bare, device="cpu", dtype="high")]
        assert calcs[1].model.descriptor.backend == "segment"
        s = Structure.from_symbols(*args, pbc=[True] * 3)
        for calc in calcs:
            res = calc.calculate(s)
            assert calc.layout == "segment"
            assert _rel(res["energy"], want.get_potential_energy(jax_s)) \
                <= REL
            assert _rel(res["forces"], want.get_forces(jax_s)) <= REL
            assert _rel(res["stress"], want.get_stress(jax_s)) <= REL


# the six saved EAM-family models: an EamAlloyNN (Ni) and five AdpNNs (Mo)
EAM_FILES = {
    run: f"artifacts/{run}/model/{name}.npz" for run, name in (
        ("mleam_ni", "snap_Ni_mleam"), ("mladp_mo", "snap_Mo_mladp"),
        ("mladp_mo_v2", "snap_Mo_mladp"), ("mladp_mo_v3", "snap_Mo_mladp"),
        ("mladp_mo_v4", "snap_Mo_mladp"),
        ("mladp_mo_v5", "snap_Mo_mladp_gw"))}


@pytest.mark.parametrize("run", sorted(EAM_FILES))
def test_saved_eam_models_load_and_serve_as_in_jax(run, tmp_path):
    """Every saved EAM/ADP model: the file's weights bit for bit (and
    written back to the same keys and values), and one E/F/S request of
    a jittered cell against the JAX calculator at float64 (the JAX
    parameters upcast), through both routes of the port's calculator:
    the analytic EFS on the dense layout and autograd on the flat pair
    layout."""
    from tensoralloy_tpu_torch.utils import tree_flatten
    path = EAM_FILES[run]
    jax_model, params, config = jax_load_model(path)
    model, _ = load_model(path, device="cpu", dtype="medium")
    assert model.as_dict() == config["model"]
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if k != "__config__"}
    got = tree_flatten(model.param_tree(), "p")
    assert set(got) == set(flat)
    for key, value in flat.items():
        assert torch.equal(got[key], torch.from_numpy(value)), key
    out = tmp_path / "resaved.npz"
    save_model(str(out), model)
    with np.load(out) as z:
        assert set(z.files) == set(flat) | {"__config__"}
        for key, value in flat.items():
            np.testing.assert_array_equal(z[key], value)

    element = config["model"]["featurizer"]["elements"][0]
    _, pos, cell = fcc_ni(2, seed=7)
    if element == "Mo":   # bcc Mo, 54 atoms
        grid = np.array([(i, j, k) for i in range(3) for j in range(3)
                         for k in range(3)], float)
        pos = ((grid[:, None] + np.array([[0, 0, 0], [.5, .5, .5]])[None])
               * 3.16).reshape(-1, 3)
        pos = pos + np.random.default_rng(7).normal(0.0, 0.05, pos.shape)
        cell = np.eye(3) * 3 * 3.16
    args = ([element] * len(pos), pos, cell)
    jax_s = JaxStructure.from_symbols(*args, pbc=[True] * 3)
    params64 = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64),
                                      params)
    want = JaxCalculator(jax_model, params=params64).calculate(jax_s)
    for fast in (True, False):
        calc = TensorAlloyCalculator(path, device="cpu", dtype="high",
                                     fast_efs=fast)
        res = calc.calculate(Structure.from_symbols(*args, pbc=[True] * 3))
        for key in ("energy", "forces", "stress", "atomic_energies"):
            assert _rel(res[key], want[key]) <= REL, (fast, key)
