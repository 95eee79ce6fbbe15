"""The port's GRAP descriptor against the JAX package at float64: the
monomial bases and multiplicity weights, the plain twin `grap_reference`
against JAX `_grap_ref_dense` over the algorithm x moment x cutoff grid
of tests/test_backends.py (two slots), the twin against the Pallas
kernel (interpret mode, float32), the position gradient through
`GrapFunction`, the trained GRAP models end to end, loading every saved
GRAP file, and the deferred options."""
import functools
import json
import subprocess
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
from tensoralloy_tpu.calculator import (
    TensorAlloyCalculator as JaxCalculator)
from tensoralloy_tpu.io.model import load_model as jax_load_model
from tensoralloy_tpu.nn import grap as jax_grap
from tensoralloy_tpu.ops import dense as jax_dense
from tensoralloy_tpu.ops import fused as jax_fused
from tensoralloy_tpu.transform import Featurizer as JaxFeaturizer
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
from tensoralloy_tpu_torch.io.model import load_model, params_from_jax
from tensoralloy_tpu_torch.nn import grap
from tensoralloy_tpu_torch.ops import fused

from test_torch_host import fcc_ni, mo_ni
from test_torch_model import _compare, _features

ROOT = Path(__file__).resolve().parent.parent
NI_MODEL = "artifacts/snap_ni_v5_readapt/model/snap_Ni.npz"
MONI_MODEL = "artifacts/snap_moni_ref11/model/snap_MoNi.npz"
FIXTURE = ROOT / "tests" / "data" / "torch_port_ref_grap_ni108.json"
GRAP_FILES = sorted(
    str(p.relative_to(ROOT))
    for p in ROOT.glob("artifacts/*/model/*.npz")
    if p.name.startswith(("snap_Ni.", "snap_Mo.", "snap_MoNi.", "moni_",
                          "td_")))
TOL = dict(rtol=1e-10, atol=1e-10)
F32 = dict(rtol=2e-5, atol=2e-5)     # tests/test_backends.py:38
REL = 1e-10

PARAMS = {   # tests/test_backends.py:73-78
    "pexp": {"rl": [1.0, 2.0, 3.0], "pl": [4.0, 3.0, 2.0]},
    "sf": {"eta": [0.5, 2.0, 8.0], "omega": [0.0, 0.0, 0.0]},
    "morse": {"D": [1.0, 1.0], "gamma": [0.5, 1.0], "r0": [2.0, 2.5]},
    "density": {"A": [1.0, 1.0], "beta": [2.0, 4.0], "re": [3.0, 3.0]},
}
GRID = [("pexp", [0, 1, 2, 3]), ("pexp", [0, 1, 2, 3, 4, 5]),
        ("pexp", [0, 2, 5]), ("sf", [0, 1, 2, 3]),
        ("morse", [0, 1, 2, 3]), ("density", [0, 1, 2, 3])]


@functools.lru_cache(maxsize=None)
def _moni_features():
    """Dense features (numpy, float64) of the Mo/Ni cell of
    tests/test_backends.py (two radial slots), rcut 4.5."""
    symbols, pos, cell = mo_ni()
    fz = JaxFeaturizer(["Mo", "Ni"], rcut=4.5)
    s = JaxStructure.from_symbols(symbols, pos, cell, pbc=[True] * 3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TENSORALLOY_TPU_NO_NATIVE", "1")
        return fz, fz.featurize(s, fz.make_vap(s), layout="dense",
                                transpose=True)


def _descriptors(algorithm, moments, **kw):
    kw = dict(algorithm=algorithm, parameters=PARAMS[algorithm],
              moment_tensors=moments, **{"backend": "dense", **kw})
    return (jax_grap.GenericRadialAtomicPotential(["Mo", "Ni"], **kw),
            grap.GenericRadialAtomicPotential(["Mo", "Ni"], **kw))


def _dense_inputs(dtype=np.float64):
    """(rij, ux, uy, uz, islotf, mask) [A, N] numpy arrays from the JAX
    dense geometry."""
    _, feats = _moni_features()
    rij, unit, islot, mask = jax_dense.dense_pair_geometry(
        {k: jnp.asarray(v) for k, v in feats.items()})
    return [np.array(x, dtype) for x in (rij, *unit, islot, mask)]


# ----------------------------------------------------------------------
@pytest.mark.parametrize("symmetric", [False, True])
def test_bases_and_weights_match_jax(symmetric):
    for max_moment in range(6):
        assert grap.moment_monomials(max_moment) == \
            jax_grap.moment_monomials(max_moment)
        np.testing.assert_array_equal(
            grap.multiplicity_tensor(max_moment, symmetric),
            jax_grap.multiplicity_tensor(max_moment, symmetric))
    rng = np.random.RandomState(0)
    u = rng.normal(size=(3, 7, 11))
    u /= np.linalg.norm(u, axis=0)
    want = jax_grap.moment_basis_c(tuple(jnp.asarray(c) for c in u), 5)
    got = grap.moment_basis_c(tuple(torch.as_tensor(c) for c in u), 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("cutoff", ["cosine", "polynomial"])
@pytest.mark.parametrize("algorithm,moments", GRID)
def test_twin_matches_jax_dense(algorithm, moments, cutoff):
    """grap_reference against JAX `_grap_ref_dense`, two slots."""
    fz, _ = _moni_features()
    jdesc, desc = _descriptors(algorithm, moments, cutoff_function=cutoff)
    args = _dense_inputs()
    want = jax_fused._grap_ref_dense(jdesc, fz.rcut, 2,
                                     *(jnp.asarray(x) for x in args))
    got = fused.grap_reference(*(torch.as_tensor(x) for x in args), desc,
                               fz.rcut, 2)
    assert got.shape == (args[0].shape[0], 2 * desc.n_filters *
                         len(moments))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_symmetric_twin_matches_jax_dense():
    fz, _ = _moni_features()
    jdesc, desc = _descriptors("pexp", [0, 1, 2, 3], symmetric=True)
    args = _dense_inputs()
    want = jax_fused._grap_ref_dense(jdesc, fz.rcut, 2,
                                     *(jnp.asarray(x) for x in args))
    got = fused.grap_reference(*(torch.as_tensor(x) for x in args), desc,
                               fz.rcut, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("algorithm,moments,cutoff", [
    ("pexp", [0, 2, 5], "cosine"), ("sf", [0, 1, 2, 3], "polynomial")])
def test_twin_matches_jax_pallas_float32(algorithm, moments, cutoff):
    """The twin against the Pallas kernel itself (interpret mode on the
    CPU) at float32, the tolerance of tests/test_backends.py."""
    fz, _ = _moni_features()
    jdesc, desc = _descriptors(algorithm, moments, cutoff_function=cutoff)
    args = _dense_inputs(np.float32)
    want = jax_fused._grap_pallas(jdesc, fz.rcut, 2,
                                  *(jnp.asarray(x) for x in args))
    got = fused.grap_kernel(*(torch.as_tensor(x) for x in args), desc,
                            fz.rcut, 2)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_position_gradient_matches_jax_pallas():
    """d(sum G^2)/d(positions) through GrapFunction against jax.grad
    through `fused_grap` (its custom VJP), as tests/test_backends.py
    holds the Pallas VJP against the segment path."""
    fz, feats = _moni_features()
    kw = dict(backend="pallas")
    jdesc = jax_grap.GenericRadialAtomicPotential(
        fz.elements, algorithm="pexp",
        parameters={"rl": [1.5, 2.5], "pl": [4.0, 2.0]},
        moment_tensors=[0, 1, 2], **kw)
    desc = grap.GenericRadialAtomicPotential.from_dict(jdesc.as_dict())
    args = (fz.rcut, fz.acut, fz.n_radial_slots, fz.n_angular_slots, False)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}

    def loss(pos):
        g = jdesc.compute(dict(jfeats, positions=pos), *args)
        return jnp.sum(jnp.square(g))

    want = jax.grad(loss)(jfeats["positions"])
    tfeats = {k: torch.as_tensor(v) for k, v in feats.items()}
    pos = tfeats["positions"].clone().requires_grad_()
    g = desc.compute(dict(tfeats, positions=pos), *args)
    (got,) = torch.autograd.grad(torch.sum(torch.square(g)), pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ----------------------------------------------------------------------
@pytest.mark.parametrize("path,cell", [(NI_MODEL, "ni"),
                                       (MONI_MODEL, "moni")])
def test_trained_grap_model_matches_jax(path, cell):
    """snap_Ni (v5_readapt, moments 0-5) and the binary snap_MoNi
    (ref11), upcast to float64, backend 'pallas' in both packages."""
    jax_model, params, _ = jax_load_model(path)
    jax_model.descriptor.backend = "pallas"
    params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                    params)
    model, _ = load_model(path, device="cpu", dtype="high",
                          backend="pallas")
    symbols, pos, box = fcc_ni(2, seed=5) if cell == "ni" else mo_ni(seed=4)
    jax_model = jax_model.clone_for(Counter(symbols))
    model = model.clone_for(Counter(symbols))
    got = _compare(jax_model, params, model,
                   _features(jax_model.featurizer, symbols, pos, box))
    assert got["forces"].shape == (len(symbols) + 1, 3)


def test_grap_request_evaluates_descriptors_once():
    """A served GRAP request is one pass over the descriptor (on the
    card: one launch of `grap_kernel`)."""
    from test_torch_calculator import count_descriptor_evaluations
    from tensoralloy_tpu_torch.atoms import Structure
    from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
    symbols, pos, box = fcc_ni(1, seed=5)
    s = Structure.from_symbols(symbols, pos, box, pbc=[True] * 3)
    calc = TensorAlloyCalculator(NI_MODEL, device="cpu", backend="pallas")
    assert count_descriptor_evaluations(calc, s) == 1
    np.testing.assert_allclose(calc.results["atomic_energies"].sum(),
                               calc.results["energy"], rtol=1e-12)


@pytest.mark.parametrize("path", GRAP_FILES)
def test_saved_grap_models_load(path):
    """Every saved GRAP and finite-temperature model loads with the JAX
    loader's weights, bit for bit."""
    assert len(GRAP_FILES) == 16
    _, params, config = jax_load_model(path)
    model, _ = load_model(path, device="cpu", dtype="medium",
                          backend="pallas")
    assert model.as_dict()["class"] == config["model"]["class"]
    state = model.state_dict()
    want = params_from_jax(params)
    assert set(state) == set(want)
    for key, value in want.items():
        assert value.dtype == torch.float32
        assert torch.equal(state[key], value), key


def test_once_deferred_options_match_jax():
    """The segment backend (the constructors' default, as in JAX),
    legacy mode and the 'nn' filter: the port's descriptors equal the
    JAX ones on the MoNi cell's flat features at float64, the choices
    JAX refuses are refused alike, and the saved Ni model on the segment
    backend serves what JAX serves."""
    from test_torch_grap_legacy_nn import descriptor_pair, flat_features
    jfeats, feats, vei = flat_features()
    cases = [dict(algorithm="pexp", parameters=PARAMS["pexp"],
                  moment_tensors=[0, 1, 2, 3]),
             dict(algorithm="pexp", parameters=PARAMS["pexp"],
                  moment_tensors=[0, 1, 2], legacy_mode=True),
             dict(algorithm="nn", moment_tensors=[0, 1, 2],
                  parameters={"num_filters": 4, "hidden_sizes": [8]})]
    for kw in cases:
        assert grap.GenericRadialAtomicPotential(
            ["Ni"], **kw).backend == "segment"
        (jdesc, jparams), (desc, params) = descriptor_pair(kw)
        want = jdesc.compute(jfeats, 4.5, 0.0, 2, 0, False,
                             params=jparams, vap_element_idx=vei)
        got = desc.compute(feats, 4.5, 0.0, 2, 0, False, params=params,
                           vap_element_idx=vei)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for kw in (dict(legacy_mode=True, backend="dense"),
               dict(legacy_mode=True, algorithm="nn"),
               dict(backend="flat")):
        kw = {"algorithm": "pexp", "parameters": PARAMS["pexp"], **kw}
        with pytest.raises(ValueError):
            jax_grap.GenericRadialAtomicPotential(["Ni"], **kw)
        with pytest.raises(ValueError):
            grap.GenericRadialAtomicPotential(["Ni"], **kw)
    _, pos, cell = fcc_ni(2, seed=9)
    args = (["Ni"] * len(pos), pos, cell)
    res = TensorAlloyCalculator(NI_MODEL, device="cpu",
                                backend="segment").calculate(
        Structure.from_symbols(*args, pbc=[True] * 3))
    jax_s = JaxStructure.from_symbols(*args, pbc=[True] * 3)
    want = JaxCalculator(NI_MODEL)
    np.testing.assert_allclose(res["energy"],
                               want.get_potential_energy(jax_s), **TOL)
    np.testing.assert_allclose(res["forces"], want.get_forces(jax_s),
                               **TOL)


def test_feature_dim_gap_quirk_matches_jax():
    """With gaps in the moment list the JAX package sizes the MLP input
    as K (max_moment + 1) per slot while the descriptor emits
    K len(moment_tensors) columns; the port reproduces both widths."""
    fz, feats = _moni_features()
    jdesc, desc = _descriptors("pexp", [0, 2, 5], backend="dense")
    assert desc.feature_dim(2, 0, False) == jdesc.feature_dim(2, 0, False)
    assert desc.feature_dim(2, 0, False) == 2 * 3 * 6
    g = desc.compute({k: torch.as_tensor(v) for k, v in feats.items()},
                     fz.rcut, fz.acut, 2, 0, False)
    assert g.shape[1] == 2 * 3 * 3


def test_kernel_wrapper_refuses_bad_inputs():
    """On CPU tensors the wrapper takes the twin; what the kernel cannot
    take is refused, never computed elsewhere."""
    _, desc = _descriptors("pexp", [0, 1])
    x = torch.ones(4, 8, dtype=torch.float64)
    assert fused.grap_kernel(x, x, x, x, 0 * x, x, desc, 4.5, 2).shape == (
        4, 2 * 3 * 2)
    meta = x.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused.grap_kernel(meta, meta, meta, meta, meta, meta, desc, 4.5, 2)
    wide = grap.GenericRadialAtomicPotential(
        ["Ni"], algorithm="pexp", moment_tensors=[0],
        parameters={"rl": np.linspace(1.0, 4.0, 65).tolist(),
                    "pl": [2.0] * 65}, backend="dense")
    with pytest.raises(ValueError, match="at most"):
        fused.grap_tables(wide)
    algorithm, cols, codes, weights, moments = fused.grap_tables(desc)
    assert algorithm == list(fused.GRAP_ALGORITHMS).index("pexp")
    np.testing.assert_array_equal(cols[0], [1.0, 2.0, 3.0])   # rl
    np.testing.assert_array_equal(cols[1], [4.0, 3.0, 2.0])   # pl
    # 1, ux, uy, uz: degree 0, then degree 1 with axis 0, 1, 2
    assert codes.dtype == np.uint16
    assert codes.tolist() == [0, 1, 1 | 1 << 3, 1 | 2 << 3]
    assert weights.shape == (4, 2) and moments.tolist() == [0, 1]


def _decode_monomials(codes, u):
    """The kernel's reading of the codes, in numpy: each monomial is 1
    times its factors, left to right. u [3, ...] -> [..., D]."""
    cols = []
    for code in codes.tolist():
        degree = code & 7
        assert code >> (3 + 2 * degree) == 0
        v = np.ones_like(u[0])
        for i in range(degree):
            v = v * u[(code >> (3 + 2 * i)) & 3]
        cols.append(v)
    return np.stack(cols, axis=-1)


@pytest.mark.parametrize("max_moment", range(6))
def test_monomial_codes_follow_the_basis(max_moment):
    """The kernel's monomial codes name `moment_monomials` in its order
    (degree, then the sorted axes), and decoded in numpy they give the
    values of `moment_basis_c` bit for bit (the same products in the
    same order)."""
    codes = fused.monomial_codes(max_moment)
    monos = grap.moment_monomials(max_moment)
    assert len(codes) == len(monos)
    for code, mono in zip(codes.tolist(), monos):
        degree = code & 7
        assert degree == len(mono)
        assert tuple((code >> (3 + 2 * i)) & 3 for i in range(degree)) == mono
    rng = np.random.default_rng(max_moment)
    u = rng.normal(size=(3, 5, 7))
    u /= np.linalg.norm(u, axis=0)
    want = grap.moment_basis_c(tuple(torch.as_tensor(c) for c in u),
                               max_moment).numpy()
    np.testing.assert_array_equal(_decode_monomials(codes, u), want)


# ----------------------------------------------------------------------
def reference_record():
    """The 108-atom GRAP request and the E/F/S the JAX package computes
    for it at float64 with the model as saved."""
    pos, cell = chip_smoke.jittered_fcc(3)
    s = JaxStructure.from_symbols(["Ni"] * len(pos), pos, cell,
                                  pbc=[True] * 3)
    calc = JaxCalculator(NI_MODEL)
    return {"model": NI_MODEL,
            "structure": "fcc Ni 3x3x3, a=3.52 A, N(0, 0.05 A) jitter, "
                         "numpy default_rng(0)",
            "precision": "float64",
            "units": "eV, eV/A, eV/A^3 (Voigt xx yy zz yz xz xy)",
            "positions": s.positions.tolist(), "cell": s.cell.tolist(),
            "energy": float(calc.get_potential_energy(s)),
            "forces": np.asarray(calc.get_forces(s)).tolist(),
            "stress": np.asarray(calc.get_stress(s)).tolist()}


def test_grap_fixture_is_current(monkeypatch):
    """The fixture `chip_smoke.py` checks the GRAP requests against is
    what the JAX package computes today, and the port reproduces it."""
    monkeypatch.setenv("TENSORALLOY_TPU_NO_NATIVE", "1")
    stored = json.loads(FIXTURE.read_text())
    fresh = reference_record()
    for key in ("positions", "cell"):
        np.testing.assert_array_equal(np.asarray(stored[key]),
                                      np.asarray(fresh[key]))
    assert max(chip_smoke.efs_errors(stored, fresh).values()) <= REL
    s = Structure.from_symbols(["Ni"] * 108, stored["positions"],
                               stored["cell"], pbc=[True] * 3)
    calc = TensorAlloyCalculator(str(ROOT / NI_MODEL), device="cpu",
                                 backend="pallas")
    errs = chip_smoke.efs_errors(calc.calculate(s), stored)
    assert max(errs.values()) <= REL, errs


def test_port_modules_import_without_jax():
    code = ("import sys; "
            "import tensoralloy_tpu_torch.calculator, "
            "tensoralloy_tpu_torch.nn.grap, "
            "tensoralloy_tpu_torch.nn.finite_temperature, "
            "tensoralloy_tpu_torch.nn.special; "
            "assert 'jax' not in sys.modules; print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.cuda
def test_grap_kernel_matches_twin_on_gpu():
    """The CUDA GRAP kernel against its twin: the algorithm x moment grid
    with gaps, two slots, float32 and float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    chip_smoke.build()
    chip_smoke.check_grap_kernel(rows=257)


@pytest.mark.parametrize("algorithm,moments", [
    ("pexp", [0, 1, 2]), ("pexp", [0, 1, 2, 3, 4, 5]), ("morse", [0, 1, 2])])
def test_second_order_matches_jax(algorithm, moments):
    """The double backward of GrapFunction against jax.grad of jax.grad
    through the JAX custom-VJP op, on seeded rows with masked tails of
    zero distances and an empty first row (P_0 = 0 exactly); with the
    morse filters, whose sign changes, one row's single pair sits where
    its P_0 is within 1e-7 of zero, where the moment-0 invariant
    sign(P_0) sqrt(P_0^2 + 1e-16) bends most."""
    from test_torch_ops import check_second_order, seeded_rows
    rng = np.random.RandomState(31)
    rows, n, n_slots, rc = 6, 9, 2, 4.5
    (rij,), slot, mask = seeded_rows(rng, rows, n, n_slots, rc)
    if algorithm == "morse":
        gamma, r0 = PARAMS["morse"]["gamma"][0], PARAMS["morse"]["r0"][0]
        mask[1] = 0.0
        mask[1, 0] = 1.0
        rij[1] = 0.0
        rij[1, 0] = r0 - np.log(2.0) / gamma + 1e-7
    unit = rng.normal(size=(3, rows, n))
    unit /= np.linalg.norm(unit, axis=0)
    unit *= mask
    jdesc, desc = _descriptors(algorithm, moments)
    if algorithm == "morse":
        p0 = fused.grap_reference(
            *(torch.as_tensor(x) for x in (rij, *unit, slot, mask)),
            grap.GenericRadialAtomicPotential(
                ["Mo", "Ni"], algorithm="morse", parameters=PARAMS["morse"],
                moment_tensors=[0], backend="dense"), rc, n_slots)
        near = p0[1].abs()
        assert ((near > 0) & (near < 1e-6)).any()
    ref = functools.partial(jax_fused._grap_ref_dense, jdesc, rc, n_slots)
    op = jax_fused._custom_vjp_op(
        functools.partial(jax_fused._grap_pallas, jdesc, rc, n_slots), ref,
        n_diff=4)
    check_second_order(op, ref, fused.GrapFunction, [rij, *unit],
                       [slot, mask],
                       (desc, rc, n_slots))
