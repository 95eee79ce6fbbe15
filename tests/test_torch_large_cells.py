"""The port's large-cell and Hessian routes against the JAX package at
float64: the row-chunked energies of AtomicNN (SF, GRAP) and of the
finite-temperature model, the pair-chunked EamNN energy (alloy and ADP),
each against its monolithic energy and JAX's `energy_chunked`; the
calculator with chunked=True and "auto"; `get_hessian` (both formats);
`make_rij_efs_fn`; the ASE adapter where `ase` is installed.

The JAX-reference Hessian fixtures that `chip_smoke.py` holds the card's
float64 Hessians against are regenerated with

    python -m tests.test_torch_large_cells
"""
import json
import sys
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tensoralloy_tpu.atoms import Structure as JaxStructure
from tensoralloy_tpu.calculator import TensorAlloyCalculator as JaxCalculator
from tensoralloy_tpu.io.model import load_model as jax_load_model
from tensoralloy_tpu.nn.fields import make_efs_fn as jax_efs
from tensoralloy_tpu.nn.fields import make_rij_efs_fn as jax_rij_efs
from tensoralloy_tpu.ops.pairs import pair_vectors as jax_pair_vectors
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
from tensoralloy_tpu_torch.io.model import load_model
from tensoralloy_tpu_torch.nn.fields import make_efs_fn, make_rij_efs_fn

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
REL = 1e-10
MODELS = {
    "sf": "artifacts/snap_ni_sfa/model/snap_Ni_sfa.npz",
    "grap": "artifacts/snap_ni_v5_readapt/model/snap_Ni.npz",
    "td": "artifacts/td_be/model/td_Be.npz",
    "eam": "artifacts/mleam_ni/model/snap_Ni_mleam.npz",
    "adp": "artifacts/mladp_mo_v5/model/snap_Mo_mladp_gw.npz",
}
# the chip's float64 Hessians of the serve phase's 108-atom Ni cell: the
# fixture's name and the model
HESSIAN_MODELS = {"mleam_ni": "eam", "snap_ni_sfa": "sf",
                  "snap_ni_v5_readapt": "grap"}


def _rel(a, b) -> float:
    a, b = (np.asarray(x.detach() if isinstance(x, torch.Tensor) else x,
                       np.float64) for x in (a, b))
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _cell(name, seed=1):
    """A small jittered cell of the model's element: symbols, positions,
    cell."""
    if name == "td":
        pos, cell = chip_smoke.jittered_hcp(seed=seed)
        return ["Be"] * len(pos), pos, cell
    if name == "adp":
        pos, cell = chip_smoke.jittered_lattice("bcc", 3, 3.16, seed=seed)
        return ["Mo"] * len(pos), pos, cell
    pos, cell = chip_smoke.jittered_fcc(2, seed=seed)
    return ["Ni"] * len(pos), pos, cell


def _both(symbols, pos, cell, **info):
    return (JaxStructure.from_symbols(symbols, pos, cell, pbc=[True] * 3,
                                      **info),
            Structure.from_symbols(symbols, pos, cell, pbc=[True] * 3,
                                   **info))


def _models(name):
    jmodel, jparams, _ = jax_load_model(ROOT / MODELS[name])
    jparams = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.float64), jparams)
    model, _ = load_model(str(ROOT / MODELS[name]), device="cpu")
    return jmodel, jparams, model


def _features(fz, js, layout):
    feats = fz.featurize(js, fz.make_vap(js), layout=layout)
    return ({k: jnp.asarray(v) for k, v in feats.items()},
            {k: torch.as_tensor(v) for k, v in feats.items()})


@pytest.fixture(autouse=True)
def _numpy_neighbor_path(monkeypatch):
    # both packages on the numpy neighbor/triple builders
    monkeypatch.setenv("TENSORALLOY_TPU_NO_NATIVE", "1")


# ----------------------------------------------------------------------
# chunked energies
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sf", "grap", "td"])
def test_row_chunked_energy_matches_monolithic_and_jax(name):
    """Blocks of 12 rows (3 or more blocks): the chunked variational
    energy, its forces and stress against the monolithic model and JAX's
    `make_chunked_energy_fn`; the finite-temperature heads too."""
    info = {"etemperature": 0.1} if name == "td" else {}
    js, s = _both(*_cell(name), **info)
    jmodel, jparams, model = _models(name)
    jmodel = jmodel.clone_for(Counter(js.symbols))
    model = model.clone_for(Counter(s.symbols))
    jf, tf = _features(jmodel.featurizer, js, "dense")
    assert tf["pair_j_d"].shape[0] >= 25
    chunk = 12
    want = jax.jit(jax_efs(jmodel.make_chunked_energy_fn(chunk)))(
        jparams, jf)
    e_fn = model.make_chunked_energy_fn(chunk)
    got = make_efs_fn(lambda f: (e_fn(f), {}))(tf)
    mono = make_efs_fn(lambda f: (model.variational_energy(f), {}))(tf)
    for key in ("energy", "forces", "stress_voigt"):
        assert _rel(got[key], want[key]) <= REL, key
        assert _rel(got[key], mono[key]) <= REL, key
    if name == "td":
        heads = model.heads_chunked(tf, atom_chunk=chunk)
        jheads = jmodel.heads_chunked(jparams, jf, chunk)
        for key in ("energy", "eentropy", "free_energy"):
            assert _rel(heads[key], jheads[key]) <= REL, key
        assert _rel(model.energy_chunked(tf, atom_chunk=chunk),
                    jheads["energy"]) <= REL


@pytest.mark.parametrize("name", ["eam", "adp"])
def test_pair_chunked_eam_energy_matches_monolithic_and_jax(name):
    """Flat pair blocks of 500 pairs (3 or more blocks), including a
    short last block, against the monolithic energy and JAX's."""
    js, s = _both(*_cell(name))
    jmodel, jparams, model = _models(name)
    jmodel = jmodel.clone_for(Counter(js.symbols))
    model = model.clone_for(Counter(s.symbols))
    jf, tf = _features(jmodel.featurizer, js, "segment")
    nij = int(tf["pair_i"].shape[0])
    chunk = 500
    assert nij > 2 * chunk and nij % chunk
    want = jax.jit(jax_efs(jmodel.make_chunked_energy_fn(chunk)))(
        jparams, jf)
    e_fn = model.make_chunked_energy_fn(chunk)
    got = make_efs_fn(lambda f: (e_fn(f), {}))(tf)
    mono = make_efs_fn(model.energy_and_aux)(tf)
    for key in ("energy", "forces", "stress_voigt"):
        assert _rel(got[key], want[key]) <= REL, key
        assert _rel(got[key], mono[key]) <= REL, key


# ----------------------------------------------------------------------
# the calculator
# ----------------------------------------------------------------------

def _efs(calc, s):
    return {"energy": calc.get_potential_energy(s),
            "forces": calc.get_forces(s), "stress": calc.get_stress(s)}


def _assert_efs(got, want, rel=REL):
    for k in want:
        assert _rel(got[k], want[k]) <= rel, k


@pytest.mark.parametrize("name", ["sf", "td", "eam"])
def test_calculator_chunked_true_matches_jax(name):
    """chunked=True with a small chunk_size against the JAX calculator's
    chunked route; the per-atom energies are refused there, as in
    JAX."""
    info = {"etemperature": 0.1} if name == "td" else {}
    js, s = _both(*_cell(name), **info)
    chunk = 500 if name == "eam" else 12
    jmodel, jparams, _ = _models(name)
    jcalc = JaxCalculator(jmodel, jparams, chunked=True, chunk_size=chunk)
    calc = TensorAlloyCalculator(str(ROOT / MODELS[name]), device="cpu",
                                 chunked=True, chunk_size=chunk)
    assert calc.fast_efs is False
    _assert_efs(_efs(calc, s), _efs(jcalc, js))
    if name == "td":
        assert _rel(calc.get_free_energy(s), jcalc.get_free_energy(js)) \
            <= REL
        assert _rel(calc.get_electron_entropy(s),
                    jcalc.get_electron_entropy(js)) <= REL
    with pytest.raises(ValueError, match="chunked"):
        calc.get_atomic_energies(s)


@pytest.mark.parametrize("name", ["sf", "grap"])
def test_a_chunked_request_evaluates_each_block_twice(name):
    """Each row block's descriptors run in the forward and once more when
    the backward recomputes the block (on the card: two launches of each
    kernel a block), and no more."""
    from test_torch_calculator import count_descriptor_evaluations
    _, s = _both(*_cell(name))
    calc = TensorAlloyCalculator(MODELS[name], device="cpu", chunked=True,
                                 chunk_size=12, backend="pallas")
    blocks = -(-calc._get_vap(s).n_atoms_vap // 12)
    assert blocks >= 3
    assert count_descriptor_evaluations(calc, s) == 2 * blocks


def test_calculator_chunked_auto_switches_on_padded_pairs():
    """"auto" takes the chunked route once the padded pairs exceed
    chunk_auto_pairs (8x on the dense layout), as the JAX calculator."""
    js, s = _both(*_cell("sf"))
    kw = dict(chunk_size=12, chunk_auto_pairs=10)
    calc = TensorAlloyCalculator(MODELS["sf"], device="cpu", **kw)
    jcalc = JaxCalculator(*_models("sf")[:2], **kw)
    _assert_efs(_efs(calc, s), _efs(jcalc, js))
    assert "atomic_energies" not in calc.results
    big = TensorAlloyCalculator(MODELS["sf"], device="cpu",
                                chunk_auto_pairs=10 ** 9)
    _assert_efs(_efs(big, s), _efs(jcalc, js))
    assert "atomic_energies" in big.results


def _jax_hessian(name, js):
    """The JAX calculator's Hessian, the saved weights in float64."""
    return np.asarray(JaxCalculator(*_models(name)[:2]).get_hessian(js))


@pytest.mark.parametrize("name", ["eam", "sf", "grap"])
def test_hessian_matches_jax(name):
    """get_hessian on a 32-atom cell, flat and phonopy layouts, against
    the JAX calculator's; symmetric. GRAP on 'pallas': its 96 rows run
    through the second-order closed form (`GrapVjpFunction`)."""
    js, s = _both(*_cell(name))
    calc = TensorAlloyCalculator(MODELS[name], device="cpu",
                                 backend="pallas" if name == "grap" else None)
    h = calc.get_hessian(s)
    want = _jax_hessian(name, js)
    assert h.shape == (3 * len(s), 3 * len(s))
    assert _rel(h, want) <= REL
    np.testing.assert_allclose(h, h.T, rtol=0, atol=1e-10 * np.abs(h).max())
    ph = calc.get_hessian(s, phonopy_format=True)
    np.testing.assert_array_equal(
        ph, h.reshape(len(s), 3, len(s), 3).transpose(0, 2, 1, 3))


def test_rij_efs_matches_jax():
    """The rij-fed evaluation of an EAM model: pair forces, assembled
    forces and stress against JAX's, and the forces against the
    position-differentiated route."""
    js, s = _both(*_cell("eam"))
    jmodel, jparams, model = _models("eam")
    jmodel = jmodel.clone_for(Counter(js.symbols))
    model = model.clone_for(Counter(s.symbols))
    jf, tf = _features(jmodel.featurizer, js, "segment")
    jf["rij"] = jax_pair_vectors(jf)
    want = jax.jit(jax_rij_efs(jmodel.energy))(jparams, jf)
    from tensoralloy_tpu_torch.ops.pairs import pair_vectors
    tf["rij"] = pair_vectors(tf)
    got = make_rij_efs_fn(model.energy_and_aux)(tf)
    for key in ("energy", "pair_forces", "forces", "stress_voigt"):
        assert _rel(got[key], want[key]) <= REL, key
    mono = make_efs_fn(model.energy_and_aux)(
        {k: v for k, v in tf.items() if k != "rij"})
    assert _rel(got["forces"], mono["forces"]) <= REL


def test_routing_parameters_match_jax():
    import inspect
    ours = inspect.signature(TensorAlloyCalculator).parameters
    theirs = inspect.signature(JaxCalculator).parameters
    for name in ("chunked", "chunk_size", "chunk_auto_pairs", "device_nl",
                 "device_nl_auto_atoms", "fast_efs"):
        assert ours[name].default == theirs[name].default, name
    calc = TensorAlloyCalculator(MODELS["eam"], device="cpu", chunked=True)
    assert calc.fast_efs is False and calc.layout == "segment"
    calc = TensorAlloyCalculator(MODELS["eam"], device="cpu", chunked=True,
                                 fast_efs=True)
    assert calc.fast_efs and calc._get_variant(
        _both(*_cell("eam"))[1])[2] is None


def test_ase_adapter():
    ase = pytest.importorskip("ase")
    _, s = _both(*_cell("eam"))
    calc = TensorAlloyCalculator(MODELS["eam"], device="cpu")
    atoms = ase.Atoms(numbers=s.numbers, positions=s.positions,
                      cell=s.cell, pbc=True)
    atoms.calc = calc.as_ase_calculator()
    assert _rel(atoms.get_potential_energy(),
                calc.get_potential_energy(s)) <= 1e-12


# ----------------------------------------------------------------------
# the chip's Hessian fixtures
# ----------------------------------------------------------------------

def hessian_structure():
    """The serve phase's 108-atom Ni cell (`chip_smoke.jittered_fcc(3)`)."""
    pos, cell = chip_smoke.jittered_fcc(3)
    return ["Ni"] * len(pos), pos, cell


def hessian_record(name):
    """The JAX calculator's float64 Hessian of the 108-atom cell."""
    symbols, pos, cell = hessian_structure()
    js, _ = _both(symbols, pos, cell)
    h = _jax_hessian(HESSIAN_MODELS[name], js)
    return {"model": MODELS[HESSIAN_MODELS[name]],
            "structure": "fcc Ni 3x3x3, a=3.52 A, N(0, 0.05 A) jitter, "
                         "numpy default_rng(0)",
            "precision": "float64", "units": "eV/A^2",
            "positions": pos.tolist(), "cell": cell.tolist(),
            "hessian": h.tolist()}


@pytest.mark.parametrize("name", sorted(HESSIAN_MODELS))
def test_hessian_fixture_is_current(name):
    """The fixture's cell is the serve phase's, and its rows of the
    first two atoms are JAX's Hessian-vector products today."""
    stored = json.loads((DATA / f"torch_port_ref_hessian_{name}.json")
                        .read_text())
    symbols, pos, cell = hessian_structure()
    np.testing.assert_array_equal(np.asarray(stored["positions"]), pos)
    np.testing.assert_array_equal(np.asarray(stored["cell"]), cell)
    h = np.asarray(stored["hessian"])
    assert h.shape == (3 * len(pos),) * 2
    jmodel, jparams, _ = _models(HESSIAN_MODELS[name])
    js, _ = _both(symbols, pos, cell)
    jcalc = JaxCalculator(jmodel, jparams)
    vap = jcalc._get_vap(js)
    model = jcalc._get_variant(js)[0]
    from tensoralloy_tpu.calculator import model_feature_layout
    feats = jcalc._features(js, vap, layout=model_feature_layout(jmodel))

    def grad(p):
        return jax.grad(lambda q: model.variational_energy(
            jparams, dict(feats, positions=q)))(p)

    rows = vap.local_to_vap[:2]
    basis = np.zeros((6,) + feats["positions"].shape)
    for n, (row, c) in enumerate((r, c) for r in rows for c in range(3)):
        basis[n, row, c] = 1.0
    hvp = jax.jit(jax.vmap(lambda v: jax.jvp(
        grad, (feats["positions"],), (v,))[1]))(jnp.asarray(basis))
    want = np.asarray(hvp)[:, vap.local_to_vap].reshape(6, -1)
    assert _rel(h[:6], want) <= REL


def main(names):
    for name in names or sorted(HESSIAN_MODELS):
        path = DATA / f"torch_port_ref_hessian_{name}.json"
        path.write_text(json.dumps(hessian_record(name)) + "\n")
        print(f"wrote {path.relative_to(ROOT)}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from tensoralloy_tpu import set_precision
    set_precision("high")
    main(sys.argv[1:])
