"""The fused ADP pass (`nn/eam/fast_efs.py` `_make_fused_pass`: the two
kernels of `csrc/adp_pass.cu`) against the plain pass `_make_pass`, its
twin, and against the JAX package's fixture.

On the CPU: where `make_fast_efs_fn` takes the fused route
(`fused_route`: an ADP model with one element present, Zhou-Johnson-
Wadley rho and phi, zjw04xc's blended embedding, Mishin's u and w, no
column shard) and where it does not (functions by MLP, another
embedding, the alloy and fs tags, two elements present, a non-identity
`reduce`, the heat flux); on CPU tensors the fused route gives the plain
pass's numbers bit for bit and counts no fused pass and no launch.

On the card (marked `cuda`; `python -m pytest tests/test_torch_adp_fused.py
-m cuda`): on the device list of jittered bcc Mo 3^3 and 4^3 and the
strained 3^3 cell (`test_torch_adp_reference`'s cases), under the
trained parameters and two scaled sets, with padded rows (atom mask 0),
skin slots beyond rcut and slots beyond u and w's cutoff, the fused
pass's energy, atomic energies, forces and virial against the plain
pass on the same CUDA features: float64 to 1e-10, float32 each pass
against the float64 plain pass, the fused pass's error within
`F32_TIMES` the plain pass's plus `F32_FLOOR`; two fused passes bit for
bit; a model with another embedding (zjw04's branches) on the plain
pass; positions of another dtype refused; the calculator's fused route
in float64 against the JAX fixture
(tests/data/torch_port_ref_eam_mladp_mo_v5.json) to 1e-10; and over a
5-step chunk of `VelocityVerlet(device_nl=True)` one fused pass, and one
launch of each kernel, for every pass.
"""
from __future__ import annotations

import json
from collections import Counter

import numpy as np
import pytest
import torch

from test_torch_adp_reference import (CELLS, NPZ, PARAMS, RCUT,  # noqa: F401
                                      ROOT, _model, _structure, weights)
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
from tensoralloy_tpu_torch.dynamics import VelocityVerlet
from tensoralloy_tpu_torch.io.model import load_model
from tensoralloy_tpu_torch.nn.eam import fast_efs, models
from tensoralloy_tpu_torch.nn.fields import stress_outputs
from tensoralloy_tpu_torch.ops.dense import gather_vec, safe_norm_components
from tensoralloy_tpu_torch.transform.device_nl import DeviceNeighborList
from tensoralloy_tpu_torch.transform.featurizer import Featurizer

REL = 1e-10
# float32: each pass is held against the float64 plain pass on the same
# positions. The two round in other places (the kernels sum a lane's
# slots, then a shuffle tree, and scale the slopes by reciprocal lengths;
# the plain pass sums by PyTorch's reductions), and a small cell's virial
# is a sum of a few thousand pair terms of up to 30 eV that cancel to
# about 5 eV, so neither is exact to float32's epsilon (each is 2e-5 to
# 3e-5 of the virial off on bcc3 and bcc4). The fused pass's error may
# be at most F32_TIMES its plain twin's, plus F32_FLOOR for an output
# that the plain pass happens to hit closely.
F32_TIMES = 4.0
F32_FLOOR = 1e-6
SKIN = 1.0
PAD_ROWS = 7
ZJW_MISHIN = {"rho": "zjw04xc", "embed": "zjw04xc"}
PAIR_FORMS = {"phi": "zjw04xc", "dipole": "mishinh", "quadrupole": "mishinh"}
OUTPUTS = ("energy", "atomic_energies", "forces", "virial")
FIXTURE = ROOT / "tests" / "data" / "torch_port_ref_eam_mladp_mo_v5.json"


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / max(want.abs().max(), 1e-300))


def _two_element_adp(max_occurs: Counter):
    custom = {"Mo": ZJW_MISHIN, "Ni": ZJW_MISHIN,
              **{t: PAIR_FORMS for t in ("MoMo", "MoNi", "NiNi")}}
    return models.AdpNN(Featurizer(["Mo", "Ni"], RCUT), max_occurs,
                        custom_potentials=custom, dtype=torch.float64)


def _mixed_zhou_adp(device: str, dtype):
    """A one-element ADP whose rho (zjw04xcp's refitted Mo) and phi
    (zjw04xc's) hold different Zhou parameters: the kernels' unshared
    radial branch."""
    custom = {"Mo": {"rho": "zjw04xcp", "embed": "zjw04xc"},
              "MoMo": PAIR_FORMS}
    return models.AdpNN(Featurizer(["Mo"], RCUT), Counter(Mo=16),
                        custom_potentials=custom, device=device, dtype=dtype)


def _own_embedding_adp(device: str, dtype, embed: str = "zjw04"):
    """A one-element ADP whose embedding is not zjw04xc's blend (zjw04's
    branches, or an MLP): the plain pass's."""
    custom = {"Mo": {"rho": "zjw04xc", "embed": embed}, "MoMo": PAIR_FORMS}
    return models.AdpNN(Featurizer(["Mo"], RCUT), Counter(Mo=16),
                        custom_potentials=custom, device=device, dtype=dtype)


def _device_features(model, cell_name: str, device: str, dtype):
    """(model laid out with PAD_ROWS padded rows, the skinned device list's
    features of the cell) on `device`."""
    s = _structure(cell_name)
    occurs = Counter(Mo=len(s) + PAD_ROWS)
    model = model.clone_for(occurs)
    fz = model.featurizer
    vap = fz.make_vap(s, occurs)
    nl = DeviceNeighborList(fz, vap, s, cutoff=fz.rcut + SKIN,
                            layout="dense", census="mean")
    pos = torch.as_tensor(vap.map_positions(s.positions), dtype=dtype,
                          device=device)
    feats, diag = nl.build(pos, torch.as_tensor(s.cell, dtype=dtype,
                                                device=device))
    nl.check(diag)
    return model, feats


def _plain_efs(model):
    run = fast_efs._make_pass(model)

    def efs(features):
        o = run(features)
        return {"energy": o["energy"], "atomic_energies": o["atomic_energies"],
                "forces": o["forces"],
                **stress_outputs(o["virial"], features["cell"])}
    return efs


# ----------------------------------------------------------------------
# The route (CPU)
# ----------------------------------------------------------------------

@pytest.fixture
def fused_builds(monkeypatch):
    """The models `_make_fused_pass` is built for from here on."""
    built = []
    make = fast_efs._make_fused_pass

    def recorded(model):
        built.append(model)
        return make(model)
    monkeypatch.setattr(fast_efs, "_make_fused_pass", recorded)
    return built


@pytest.mark.parametrize("case", ("mladp_mo_v5", "two_elements_one_present"))
def test_the_route_engages(case, fused_builds):
    if case == "mladp_mo_v5":
        model = load_model(str(NPZ), device="cpu", dtype="high")[0]
    else:
        model = _two_element_adp(Counter(Mo=16))
    assert fast_efs.fused_route(model)
    fast_efs.make_fast_efs_fn(model)
    assert fused_builds == [model]


@pytest.mark.parametrize("case", ("nn_functions", "alloy", "fs",
                                  "two_elements", "reduce", "heat_flux"))
def test_the_route_is_refused(case, fused_builds):
    adp = load_model(str(NPZ), device="cpu", dtype="high")[0]
    if case == "nn_functions":
        model = models.AdpNN(Featurizer(["Mo"], RCUT), Counter(Mo=16),
                             dtype=torch.float64)
        assert not fast_efs.fused_route(model)
        fast_efs.make_fast_efs_fn(model)
    elif case in ("alloy", "fs"):
        model = _model(case)
        assert not fast_efs.fused_route(model)
        fast_efs.make_fast_efs_fn(model)
    elif case == "two_elements":
        model = _two_element_adp(Counter(Mo=8, Ni=8))
        assert not fast_efs.fused_route(model)
        fast_efs.make_fast_efs_fn(model)
    elif case == "reduce":
        def reduce(x):
            return x
        assert not fast_efs.fused_route(adp, reduce)
        fast_efs.make_fast_efs_fn(adp, reduce=reduce)
    else:
        assert fast_efs.fused_route(adp)
        fast_efs.make_fast_heat_flux_fn(adp)
    assert fused_builds == []


@pytest.mark.parametrize("case, share", (("mladp_mo_v5", 1),
                                         ("mixed_zhou", 0)))
def test_rho_and_phi_share_their_zhou_parameters(case, share):
    """The kernels take rho's and phi's second Zhou term from one
    exponential where their beta, lamda and r_eq are the same leaves."""
    model = (load_model(str(NPZ), device="cpu", dtype="high")[0]
             if case == "mladp_mo_v5"
             else _mixed_zhou_adp("cpu", torch.float64))
    assert fast_efs.fused_route(model)
    vector, got = fast_efs._CoefficientVector(model)(
        model._params(None), torch.float32, torch.device("cpu"))
    assert got == share and vector.shape == (34,)
    assert vector.dtype == torch.float32


@pytest.mark.parametrize("case, in_kernel", (("mladp_mo_v5", True),
                                             ("zjw04_embedding", False),
                                             ("nn_embedding", False)))
def test_the_kernels_evaluate_only_the_blended_embedding(case, in_kernel):
    """adp_accumulate evaluates zjw04xc's blended embedding, from the
    coefficient vector's last entries; a model with any other embedding
    keeps the plain pass."""
    if case == "mladp_mo_v5":
        model = load_model(str(NPZ), device="cpu", dtype="high")[0]
    else:
        model = _own_embedding_adp("cpu", torch.float64,
                                   case.split("_")[0])
    assert fast_efs.fused_route(model) is in_kernel
    if in_kernel:
        vector, _ = fast_efs._CoefficientVector(model)(
            model._params(None), torch.float64, torch.device("cpu"))
        embed = vector[-len(fast_efs._EMBED_KEYS):]
        assert embed.shape == (12,) and bool(torch.all(embed != 0))


@pytest.mark.parametrize("cell_name", ("bcc3", "bcc3_strained"))
def test_cpu_tensors_take_the_plain_pass(cell_name):
    """The fused route on CPU tensors: the plain pass's numbers bit for
    bit, a pass counted, no fused pass counted."""
    model = load_model(str(NPZ), device="cpu", dtype="high")[0]
    model, feats = _device_features(model, cell_name, "cpu", torch.float64)
    fast_efs.reset_pass_counts()
    fast_efs.reset_fused_pass_counts()
    fast_efs.reset_adp_launch_counts()
    got = fast_efs.make_fast_efs_fn(model)(feats)
    want = _plain_efs(model)(feats)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert fast_efs.pass_counts == {"alloy": 0, "fs": 0, "adp": 2}
    assert fast_efs.fused_pass_counts == {"alloy": 0, "fs": 0, "adp": 0}
    assert fast_efs.adp_launch_counts == {"adp_accumulate": 0,
                                          "adp_forces": 0}


# ----------------------------------------------------------------------
# The kernels (the card)
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return "cuda"


def _slot_census(model, feats) -> dict:
    """Real slots beyond rcut (the skin) and within rcut beyond u and w's
    cutoff, and rows with atom mask 0."""
    v = gather_vec(feats["positions"], feats["pair_j_d"].long(),
                   feats["pair_simg_d"], feats["cell"])
    r = safe_norm_components(v)
    real = feats["pair_mask_d"] > 0
    coef, _ = fast_efs._CoefficientVector(model)(model._params(None),
                                                 r.dtype, r.device)
    near = float(torch.maximum(coef[15], coef[20]))     # u's, w's rc
    return {"skin": int((real & (r >= RCUT)).sum()),
            "beyond_uw": int((real & (r < RCUT) & (r >= near)).sum()),
            "padded_rows": int((feats["atom_masks"] == 0).sum())}


def _check_float32(label, got, want, truth) -> None:
    """The float32 fused pass `got` against the float64 plain pass
    `truth`, to F32_TIMES the float32 plain pass's (`want`) error plus
    F32_FLOOR; the errors are printed (`pytest -s`)."""
    for key in OUTPUTS:
        fused_err, plain_err = _rel(got[key], truth[key]), \
            _rel(want[key], truth[key])
        print(f"{label} {key}: float32 against float64, fused "
              f"{fused_err:.3e}, plain {plain_err:.3e}")
        assert fused_err <= F32_TIMES * plain_err + F32_FLOOR, key


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("high", "medium"))
@pytest.mark.parametrize("cell_name", sorted(CELLS))
@pytest.mark.parametrize("params", PARAMS)
def test_the_fused_pass_matches_the_plain_pass(cuda, weights, params,
                                               cell_name, dtype):
    model, _ = load_model(weights[params], device=cuda, dtype=dtype)
    torch_dtype = torch.float64 if dtype == "high" else torch.float32
    model, feats = _device_features(model, cell_name, cuda, torch_dtype)
    census = _slot_census(model, feats)
    assert census["skin"] > 0 and census["beyond_uw"] > 0
    assert census["padded_rows"] == PAD_ROWS + 1     # and the virtual row
    fast_efs.reset_fused_pass_counts()
    run = fast_efs._make_fused_pass(model)
    got = run(feats)
    again = run(feats)
    want = fast_efs._make_pass(model)(feats)
    assert fast_efs.fused_pass_counts["adp"] == 2
    for key in OUTPUTS:
        assert got[key].dtype == torch_dtype and got[key].is_cuda
        assert torch.equal(got[key], again[key]), key
        if torch_dtype == torch.float64:
            assert _rel(got[key], want[key]) <= REL, key
    assert torch.all(got["atomic_energies"][feats["atom_masks"] == 0] == 0)
    if torch_dtype == torch.float32:
        truth, _ = load_model(weights[params], device=cuda, dtype="high")
        truth, feats64 = _device_features(truth, cell_name, cuda,
                                          torch.float64)
        _check_float32(f"{params} {cell_name}", got, want,
                       fast_efs._make_pass(truth)(feats64))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_the_unshared_radial_branch_matches_the_plain_pass(cuda, dtype):
    model, feats = _device_features(_mixed_zhou_adp(cuda, dtype), "bcc3",
                                    cuda, dtype)
    got = fast_efs._make_fused_pass(model)(feats)
    want = fast_efs._make_pass(model)(feats)
    if dtype == torch.float64:
        for key in OUTPUTS:
            assert _rel(got[key], want[key]) <= REL, key
    else:
        truth, feats64 = _device_features(
            _mixed_zhou_adp(cuda, torch.float64), "bcc3", cuda,
            torch.float64)
        _check_float32("mixed_zhou bcc3", got, want,
                       fast_efs._make_pass(truth)(feats64))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_the_model_s_own_embedding_matches_the_plain_pass(cuda, dtype):
    """An embedding the kernels do not evaluate (zjw04's branches): the
    EFS on the card is the plain pass's, bit for bit, and no fused pass
    runs."""
    model, feats = _device_features(_own_embedding_adp(cuda, dtype),
                                    "bcc3", cuda, dtype)
    assert not fast_efs.fused_route(model)
    fast_efs.reset_pass_counts()
    fast_efs.reset_fused_pass_counts()
    fast_efs.reset_adp_launch_counts()
    got = fast_efs.make_fast_efs_fn(model)(feats)
    want = _plain_efs(model)(feats)
    for key in want:
        assert got[key].is_cuda and torch.equal(got[key], want[key]), key
    assert fast_efs.pass_counts["adp"] == 2
    assert fast_efs.fused_pass_counts["adp"] == 0
    assert fast_efs.adp_launch_counts == {"adp_accumulate": 0,
                                          "adp_forces": 0}


@pytest.mark.cuda
def test_positions_of_another_dtype_are_refused(cuda):
    model, feats = _device_features(
        load_model(str(NPZ), device=cuda, dtype="medium")[0], "bcc3", cuda,
        torch.float32)
    feats = dict(feats, positions=feats["positions"].half())
    with pytest.raises(TypeError, match="float16"):
        fast_efs._make_fused_pass(model)(feats)


@pytest.mark.cuda
def test_the_fused_route_matches_the_jax_fixture(cuda):
    """The calculator's fused route in float64 on the fixture's cell (128
    atoms of jittered bcc Mo) against the JAX package's energy, forces
    and stress."""
    ref = json.loads(FIXTURE.read_text())
    s = Structure.from_symbols(["Mo"] * len(ref["positions"]),
                               np.asarray(ref["positions"]),
                               np.asarray(ref["cell"]), pbc=[True] * 3)
    calc = TensorAlloyCalculator(str(ROOT / ref["model"]), device=cuda,
                                 dtype="high", fast_efs=True)
    assert fast_efs.fused_route(calc.model)
    fast_efs.reset_fused_pass_counts()
    fast_efs.reset_adp_launch_counts()
    res = calc.calculate(s)
    assert fast_efs.fused_pass_counts["adp"] == 1
    assert fast_efs.adp_launch_counts == {"adp_accumulate": 1,
                                          "adp_forces": 1}
    for key in ("energy", "forces", "stress"):
        want = torch.as_tensor(np.asarray(ref[key], np.float64))
        got = torch.as_tensor(np.asarray(res[key], np.float64))
        assert _rel(got, want) <= REL, key


@pytest.mark.cuda
def test_every_pass_of_an_md_chunk_is_fused(cuda):
    model, _ = load_model(str(NPZ), device=cuda, dtype="medium")
    md = VelocityVerlet(model, _structure("bcc3_strained", seed=23),
                        timestep=1.0, skin=SKIN, chunk_size=5,
                        temperature=300.0, seed=9, target_temperature=300.0,
                        friction=0.01, device_nl=True)
    assert fast_efs.fused_route(md.model)
    fast_efs.reset_pass_counts()
    fast_efs.reset_fused_pass_counts()
    fast_efs.reset_adp_launch_counts()
    history = md.run(5)
    assert np.all(np.isfinite(history["total"]))
    assert fast_efs.pass_counts["adp"] == 5 + 2
    assert fast_efs.fused_pass_counts == fast_efs.pass_counts
    assert fast_efs.adp_launch_counts == {"adp_accumulate": 5 + 2,
                                          "adp_forces": 5 + 2}
