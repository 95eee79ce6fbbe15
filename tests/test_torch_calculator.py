"""The port's serving slice against the JAX package: the calculator end to
end, the JAX-reference fixture that `chip_smoke.py` checks on the GPU,
and the guards around the GPU-only parts.

Regenerate the fixtures (this file's, and the GRAP and finite-
temperature ones of tests/test_torch_grap.py and
tests/test_torch_finite_temperature.py) from the repository root with
`python -m tests.test_torch_calculator`.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from tensoralloy_tpu.atoms import Structure as JaxStructure
from tensoralloy_tpu.calculator import (
    TensorAlloyCalculator as JaxCalculator)
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator

ROOT = Path(__file__).resolve().parent.parent
MODEL = str(ROOT / "artifacts" / "snap_ni_sfa" / "model" / "snap_Ni_sfa.npz")
FIXTURE = ROOT / "tests" / "data" / "torch_port_ref_ni108.json"
REL_F64 = 1e-10


def _structures(reps, seed=0):
    pos, cell = chip_smoke.jittered_fcc(reps, seed=seed)
    symbols = ["Ni"] * len(pos)
    return (JaxStructure.from_symbols(symbols, pos, cell, pbc=[True] * 3),
            Structure.from_symbols(symbols, pos, cell, pbc=[True] * 3))


def _jax_efs(structure, backend=None):
    calc = JaxCalculator(MODEL)
    if backend is not None:
        calc.model.descriptor.backend = backend
    return {"energy": calc.get_potential_energy(structure),
            "forces": calc.get_forces(structure),
            "stress": calc.get_stress(structure)}


def _assert_efs_close(res, ref, rel):
    errs = chip_smoke.efs_errors(res, ref)
    assert max(errs.values()) <= rel, errs


def _reference_record():
    """The 108-atom request and the E/F/S the JAX package computes for
    it at float64 with the model as saved."""
    jax_s, _ = _structures(3)
    ref = _jax_efs(jax_s)
    return {"model": "artifacts/snap_ni_sfa/model/snap_Ni_sfa.npz",
            "structure": "fcc Ni 3x3x3, a=3.52 A, N(0, 0.05 A) jitter, "
                         "numpy default_rng(0)",
            "precision": "float64",
            "units": "eV, eV/A, eV/A^3 (Voigt xx yy zz yz xz xy)",
            "positions": jax_s.positions.tolist(),
            "cell": jax_s.cell.tolist(),
            "energy": float(ref["energy"]),
            "forces": np.asarray(ref["forces"]).tolist(),
            "stress": np.asarray(ref["stress"]).tolist()}


@pytest.fixture(autouse=True)
def _numpy_neighbor_path(monkeypatch):
    # both packages on the numpy neighbor/triple builders
    monkeypatch.setenv("TENSORALLOY_TPU_NO_NATIVE", "1")


def test_calculator_matches_jax_pallas():
    """32-atom jittered fcc Ni, backend 'pallas', float64: the port's
    calculator (kernel wrappers -> twins on the CPU) against the JAX
    calculator (Pallas in interpret mode)."""
    jax_s, s = _structures(2, seed=1)
    ref = _jax_efs(jax_s, backend="pallas")
    calc = TensorAlloyCalculator(MODEL, device="cpu", backend="pallas",
                                 dtype="high")
    res = {"energy": calc.get_potential_energy(s),
           "forces": calc.get_forces(s), "stress": calc.get_stress(s)}
    _assert_efs_close(res, ref, REL_F64)
    assert res["forces"].shape == (32, 3)
    # the getters serve the cached result until the structure changes
    assert calc.get_potential_energy(s) == res["energy"]
    moved = s.copy()
    moved.positions[0, 0] += 0.01
    assert calc.get_potential_energy(moved) != res["energy"]


def test_reference_fixture_is_current():
    """The fixture `chip_smoke.py` checks the GPU against is what the JAX
    package computes today, and the port on the CPU reproduces it."""
    stored = json.loads(FIXTURE.read_text())
    fresh = _reference_record()
    np.testing.assert_array_equal(np.asarray(stored["positions"]),
                                  np.asarray(fresh["positions"]))
    np.testing.assert_array_equal(np.asarray(stored["cell"]),
                                  np.asarray(fresh["cell"]))
    _assert_efs_close(stored, fresh, REL_F64)
    _, s = _structures(3)
    calc = TensorAlloyCalculator(MODEL, device="cpu", backend="pallas",
                                 dtype="high")
    r = calc.calculate(s)
    _assert_efs_close(r, stored, REL_F64)


def count_descriptor_evaluations(calc, structure) -> int:
    """Serve one request and count the passes over its descriptors."""
    desc = calc.model.descriptor
    compute, calls = desc.compute, []
    desc.compute = lambda *a, **kw: (calls.append(1), compute(*a, **kw))[1]
    try:
        calc.calculate(structure)
    finally:
        del desc.compute
    return len(calls)


def test_request_evaluates_descriptors_once():
    """Forces, stress and the atomic energies come out of one pass: a
    request is one evaluation of G2 and G4 (on the card: one launch of
    each kernel)."""
    _, s = _structures(1)
    calc = TensorAlloyCalculator(MODEL, device="cpu", backend="pallas")
    assert count_descriptor_evaluations(calc, s) == 1
    assert calc.results["atomic_energies"].shape == (len(s),)
    np.testing.assert_allclose(calc.results["atomic_energies"].sum(),
                               calc.results["energy"], rtol=1e-12)


def test_auto_and_false_take_the_host_list_path():
    """The reference's routing: a frame below device_nl_auto_atoms (and
    any frame with device_nl=False) takes the host lists, in one piece
    below chunk_auto_pairs; the defaults of the six routing parameters
    are the JAX calculator's."""
    import inspect
    _, s = _structures(1)
    want = TensorAlloyCalculator(MODEL, device="cpu").calculate(s)
    for value in ("auto", False):
        calc = TensorAlloyCalculator(MODEL, device="cpu", chunked=value,
                                     device_nl=value, fast_efs=value)
        assert calc.calculate(s)["energy"] == want["energy"]
        assert not calc._nl_cache and "atomic_energies" in calc.results
    defaults = inspect.signature(TensorAlloyCalculator).parameters
    jax_defaults = inspect.signature(JaxCalculator).parameters
    for name in ("chunked", "chunk_size", "chunk_auto_pairs", "device_nl",
                 "device_nl_auto_atoms", "fast_efs"):
        assert defaults[name].default == jax_defaults[name].default, name
    assert len(s) < defaults["device_nl_auto_atoms"].default
    with pytest.raises(ValueError, match="'auto'"):
        TensorAlloyCalculator(MODEL, device="cpu", chunked="always")


def test_chunked_routing_matches_jax(tmp_path):
    """Where the calculator builds a chunked route, for "auto" and True:
    a segment SF model, a dense SF model, an 'nn'-filter GRAP model and
    an EAM model, against the JAX calculator's choice (its variant's
    fourth element)."""
    from tensoralloy_tpu.io.model import save_model as jax_save_model
    from test_torch_grap_legacy_nn import model_pair, nn_kw
    jmodel, params, _ = model_pair(nn_kw(1, backend="dense"))
    nn_file = str(tmp_path / "nn.npz")
    jax_save_model(nn_file, jmodel, params)
    from tensoralloy_tpu_torch.atoms import Structure as S
    from test_torch_host import mo_ni
    moni = mo_ni()
    # -> (file, chunks under "auto", chunks under True); "auto" serves
    # the EAM family through the fast EFS, which never chunks
    files = {
        "sf_segment": (chip_smoke.backend_copy(
            MODEL, tmp_path / "sf_segment.npz", "segment"), False, False),
        "sf_dense": (MODEL, True, True),
        "grap_nn": (nn_file, False, False),
        "eam": (str(ROOT / "artifacts/mleam_ni/model/snap_Ni_mleam.npz"),
                False, True),
    }
    for name, (path, *expected) in files.items():
        symbols, pos, cell = (moni if name == "grap_nn" else
                              (["Ni"] * 32, *chip_smoke.jittered_fcc(2)))
        js = JaxStructure.from_symbols(symbols, pos, cell, pbc=[True] * 3)
        s = S.from_symbols(symbols, pos, cell, pbc=[True] * 3)
        for chunked, chunks in zip(("auto", True), expected):
            calc = TensorAlloyCalculator(path, device="cpu",
                                         chunked=chunked)
            jcalc = JaxCalculator(path, chunked=chunked)
            got = calc._get_variant(s)[2] is not None
            want = jcalc._get_variant(js)[3] is not None
            assert got == want == chunks, (name, chunked)
    # True always chunks a model that can: the JAX numbers
    calc = TensorAlloyCalculator(MODEL, device="cpu", chunked=True,
                                 chunk_size=12)
    js, s = _structures(2, seed=3)
    _assert_efs_close(calc.calculate(s), _jax_efs(js), REL_F64)
    assert "atomic_energies" not in calc.results


def test_deferred_modes_raise():
    _, s = _structures(1)
    # fast_efs=True asks for the EAM family's analytic route: another
    # model serves as without it, as in the JAX calculator
    calc = TensorAlloyCalculator(MODEL, device="cpu", fast_efs=True)
    assert calc.fast_efs is False and calc.layout == "dense"
    assert calc.calculate(s)["energy"] == TensorAlloyCalculator(
        MODEL, device="cpu").calculate(s)["energy"]
    calc = TensorAlloyCalculator(MODEL, device="cpu")
    with pytest.raises(ValueError, match="not supported"):
        calc.calculate(Structure.from_symbols(
            ["Mo"], [[0.0, 0.0, 0.0]], np.eye(3) * 4.0))


def test_entry_points_default_to_the_card(monkeypatch):
    """With no device named, the calculator and the loader ask for the
    card; without one they raise and do not carry on on the CPU."""
    from tensoralloy_tpu_torch.io.model import load_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TensorAlloyCalculator(MODEL)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        load_model(MODEL)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TensorAlloyCalculator(MODEL, device="cuda:0")
    calc = TensorAlloyCalculator(MODEL, device="cpu")
    assert calc.device.type == "cpu"
    assert next(calc.model.parameters()).device.type == "cpu"


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """No fallback: without a card chip_smoke.py fails and prints no
    result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_kernel_bounds_count_real_geometry():
    """chip_smoke's bound: slot and mask read in full, the geometry of
    the real entries only, the output once; GRAP's invariant FLOP from
    the nonzero weights (one a monomial at moments 0-5)."""
    from tensoralloy_tpu_torch.nn.grap import GenericRadialAtomicPotential
    mask = torch.zeros(2, 8, dtype=torch.float32)
    mask[1, :3] = 1.0
    geo = [torch.full_like(mask, 2.0) for _ in range(4)]
    slot = torch.zeros_like(mask)
    out = torch.zeros(2, 4)
    n_bytes, flop = chip_smoke.kernel_work(
        "g4", (*geo[:3], slot, mask, np.zeros((4, 3)), 4.0, "cosine", 1),
        out)
    assert n_bytes == 4 * (2 * 16 + 3 * 3 + 8)
    assert flop == 3 * (23 + 11 * 4)
    desc = GenericRadialAtomicPotential(
        ["Ni"], algorithm="pexp",
        parameters={"rl": [1.0, 2.0], "pl": [4.0, 3.0]},
        moment_tensors=[0, 1, 2, 3, 4, 5], backend="dense")
    out = torch.zeros(2, 2 * 6)
    n_bytes, flop = chip_smoke.kernel_work(
        "grap", (*geo, slot, mask, desc, 6.0, 1), out)
    assert n_bytes == 4 * (2 * 16 + 4 * 3 + 24)
    k, d = 2, 56
    assert flop == (3 * (4 + (d - 1) + 5 * k + 2 * k * d)
                    + 3 * 2 * 1 * k * d)


# modules that need a card to import; none so far
CARD_ONLY_MODULES = ()


def test_port_imports_without_jax():
    """Every module of the port imports with jax, optax and the JAX
    package blocked, and none of them pulls the JAX package in."""
    code = ("import importlib, pkgutil, sys\n"
            "for name in ('jax', 'optax', 'tensoralloy_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import tensoralloy_tpu_torch as pkg\n"
            f"skip = set({CARD_ONLY_MODULES!r})\n"
            "names = [m.name for m in pkgutil.walk_packages(\n"
            "    pkg.__path__, pkg.__name__ + '.')]\n"
            "for name in names:\n"
            "    if name not in skip:\n"
            "        importlib.import_module(name)\n"
            "assert not any(m == 'tensoralloy_tpu' or m.startswith(\n"
            "    'tensoralloy_tpu.') for m in sys.modules\n"
            "    if sys.modules[m] is not None)\n"
            "print(' '.join(names))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # the walk reaches every subpackage, the command lines among them
    walked = set(proc.stdout.split())
    for name in ("cli.entry", "cli.__main__", "tensordb.cli",
                 "tensordb.__main__", "test_utils", "ops.fused",
                 "train.manager", "nn.eam.fast_efs", "analysis.surface"):
        assert f"tensoralloy_tpu_torch.{name}" in walked, name
    sources = list((ROOT / "tensoralloy_tpu_torch").rglob("*.py"))
    assert sources
    for path in sources + [ROOT / "chip_smoke.py", ROOT / "kernel_times.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if len(words) > 1 and words[0] in ("import", "from"):
                top = words[1].split(".")[0]
                assert top not in ("jax", "tensoralloy_tpu"), \
                    f"{path}: {line}"


@pytest.mark.cuda
def test_kernels_match_twins_on_gpu():
    """Both CUDA kernels against their twins, float32 and float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    chip_smoke.build()
    chip_smoke.check_kernels(rows=257)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from tensoralloy_tpu import set_precision
    set_precision("high")
    os.environ["TENSORALLOY_TPU_NO_NATIVE"] = "1"
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_finite_temperature
    import test_torch_grap
    for path, record in (
            (FIXTURE, _reference_record),
            (test_torch_grap.FIXTURE, test_torch_grap.reference_record),
            (test_torch_finite_temperature.FIXTURE,
             test_torch_finite_temperature.reference_record)):
        path.write_text(json.dumps(record(), indent=1) + "\n")
        print(f"wrote {path}")
