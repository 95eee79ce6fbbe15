#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing its result; any
failure ends the run with a non-zero exit and no result line:

  1. card    require torch.cuda; print nvidia-smi's name and power limit
  2. build   compile the CUDA kernels (G2/G4, GRAP) from the checkout's
             sources
  3. kernels each kernel against its plain PyTorch twin on seeded random
             geometry with masked tails and an empty first row: float32
             values and gradients to 2e-5, float64 to 1e-12; G2 at 32 to
             256 entries and at widths that are no multiple of 4, 1 to 6
             slots, the served grid and one of 18 rows; G4 at 256
             and 384 entries with 1 and 3 slots; GRAP over the algorithm
             x moment grid with gaps, symmetric weights, 1-3 slots, rows
             of 256 entries (more than 128 real pairs) and 64 filters
  4. serve   the port's calculator in float32 with backend="pallas" on
             its default device, which must be cuda, one path after
             another, each with the launch counts reset before it and
             read after it:
               sf      snap_Ni_sfa.npz, jittered fcc Ni of 108, 864, 4000
                       and 32000 atoms (G2 and G4)
               grap    snap_Ni.npz (v5_readapt), the same four sizes
               moni    snap_MoNi.npz (ref11), 4000 atoms, 10 % Mo
               td      td_Be.npz, 36 atoms of hcp Be at 0.1 eV
             Each request must launch its path's kernels, agree with the
             same calculator on the twins, and have |sum F| ~ 0; the
             108-atom Ni requests and the Be request are also held
             against the JAX-reference fixtures (float32 and float64)
  5. time    median time per request and its device E/F/S part,
             kernels vs twins; each kernel vs its twin at the
             32000-atom request's shapes (`ms`: the median of single
             CUDA-event-timed launches, as since the first slice;
             `ms_queued`: the device time of calls queued behind a
             sleeping kernel, on the same buffers, and
             `ms_queued_rotated`: the same over 4 copies of the inputs
             in turn, more than the L2 cache holds), beside its bound:
             the larger of its
             bytes (mask and slot read once, the geometry of the real
             entries only, output written once) at 3.35 TB/s and its
             useful FLOP at the FP32 67 TFLOP/s

The line before the last is a JSON object of per-kernel results; the
last is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MODELS = ROOT / "artifacts"
DATA = ROOT / "tests" / "data"
SOURCES = {"g2": "tensoralloy_tpu_torch/csrc/sf_kernels.cu",
           "g4": "tensoralloy_tpu_torch/csrc/sf_kernels.cu",
           "grap": "tensoralloy_tpu_torch/csrc/grap_kernel.cu"}
REPLACES = {"g2": "tensoralloy_tpu/ops/fused.py:326",
            "g4": "tensoralloy_tpu/ops/fused.py:412",
            "grap": "tensoralloy_tpu/ops/fused.py:170"}
# the main path's paths: model, the kernels every request must launch,
# and the JAX-reference fixture of its first request with the fixture's
# element (or None)
PATHS = {
    "sf": (MODELS / "snap_ni_sfa" / "model" / "snap_Ni_sfa.npz",
           ("g2", "g4"), (DATA / "torch_port_ref_ni108.json", "Ni")),
    "grap": (MODELS / "snap_ni_v5_readapt" / "model" / "snap_Ni.npz",
             ("grap",), (DATA / "torch_port_ref_grap_ni108.json", "Ni")),
    "moni": (MODELS / "snap_moni_ref11" / "model" / "snap_MoNi.npz",
             ("grap",), None),
    "td": (MODELS / "td_be" / "model" / "td_Be.npz", ("grap",),
           (DATA / "torch_port_ref_td_be.json", "Be")),
}
MONI_REPS = 10      # 4000 atoms
MO_FRACTION = 0.1
# fcc repeats per axis -> 108, 864, 4000 and 32000 atoms
REQUEST_REPS = (3, 6, 10, 20)
LATTICE = 3.52      # Angstrom
SIGMA = 0.05        # Angstrom, Gaussian jitter of every coordinate
BE_A, BE_C = 2.2858, 3.5843   # hcp Be, Angstrom
SEED = 0
F32 = dict(rtol=2e-5, atol=2e-5)     # as tests/test_backends.py
F64 = dict(rtol=1e-12, atol=1e-12)
F32_REL = 1e-4      # E/F/S relative error, float32 serving
F64_REL = 1e-10     # E/F/S relative error, float64 serving
# H100 SXM peaks (NVIDIA's data sheet, 700 W): device memory and the
# float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
# copies of a kernel's inputs launched in turn: G2's 50 MB (the size of
# the L2 cache) become 200 MB
ROTATED_COPIES = 4


def jittered_fcc(reps: int, seed: int = SEED, a: float = LATTICE,
                 sigma: float = SIGMA):
    """Periodic fcc Ni supercell of 4 reps^3 atoms with every coordinate
    jittered by N(0, sigma) from a seeded numpy generator.
    -> (positions [n, 3], cell [3, 3])."""
    basis = np.array([[0.0, 0.0, 0.0], [0.0, 0.5, 0.5],
                      [0.5, 0.0, 0.5], [0.5, 0.5, 0.0]])
    grid = np.array([(i, j, k) for i in range(reps) for j in range(reps)
                     for k in range(reps)], dtype=np.float64)
    pos = ((grid[:, None, :] + basis[None]) * a).reshape(-1, 3)
    pos = pos + np.random.default_rng(seed).normal(0.0, sigma, pos.shape)
    return pos, np.eye(3) * a * reps


def jittered_hcp(reps=(3, 3, 2), seed: int = SEED, a: float = BE_A,
                 c: float = BE_C, sigma: float = SIGMA):
    """Periodic hcp Be supercell of 2 reps[0] reps[1] reps[2] atoms, every
    coordinate jittered by N(0, sigma) from a seeded numpy generator.
    -> (positions [n, 3], cell [3, 3])."""
    unit = np.array([[a, 0.0, 0.0], [-0.5 * a, 0.5 * np.sqrt(3.0) * a, 0.0],
                     [0.0, 0.0, c]])
    basis = np.array([[1 / 3, 2 / 3, 0.25], [2 / 3, 1 / 3, 0.75]])
    grid = np.array([(i, j, k) for i in range(reps[0])
                     for j in range(reps[1]) for k in range(reps[2])],
                    dtype=np.float64)
    frac = (grid[:, None, :] + basis[None]).reshape(-1, 3)
    pos = frac @ unit
    pos = pos + np.random.default_rng(seed).normal(0.0, sigma, pos.shape)
    return pos, unit * np.asarray(reps, np.float64)[:, None]


def rel_err(a, b) -> float:
    """max |a - b| / max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def efs_errors(res, ref) -> dict:
    """Relative errors of E/F/S, and of S and F where `ref` has the
    finite-temperature heads."""
    keys = ("energy", "forces", "stress", "eentropy", "free_energy")
    return {k: rel_err(res[k], ref[k]) for k in keys if k in ref}


def phase(name: str):
    print(f"== phase {name}", flush=True)


# ----------------------------------------------------------------------
def check_card() -> str:
    phase("card")
    if not torch.cuda.is_available():
        raise SystemExit("FAIL card: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return card


def build() -> None:
    phase("build")
    from tensoralloy_tpu_torch.ops import fused
    t0 = time.perf_counter()
    path = fused.build_kernels()
    fused._library()
    print(f"built {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in fused.build_log.splitlines():
        if line.startswith("== ") or "entry function" in line:
            print("  " + line.strip().replace("ptxas info    : ", ""))
        elif "Used" in line or "spill" in line:
            print("    " + line.strip().replace("ptxas info    : ", ""))


def _random_pairs(rng, rows, n, n_slots, rc, dtype, device):
    """Seeded [rows, n] pair rows: real entries first, then a masked
    tail of zero distances (finite garbage a kernel must not read). The
    first row has no real entry."""
    lengths = rng.integers(0, n + 1, size=rows)
    lengths[0] = 0
    real = np.arange(n)[None, :] < lengths[:, None]
    rij = np.where(real, rng.uniform(0.5, 1.1 * rc, (rows, n)), 0.0)
    slot = rng.integers(0, n_slots, (rows, n)).astype(np.float64)
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    return t(rij), t(slot), t(real.astype(np.float64))


def _random_triples(rng, rows, n, n_slots, rc, dtype, device):
    lengths = rng.integers(0, n + 1, size=rows)
    lengths[0] = 0
    real = np.arange(n)[None, :] < lengths[:, None]

    def vec():
        u = rng.normal(size=(rows, n, 3))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        return u * rng.uniform(1.0, 1.1 * rc, (rows, n, 1))

    vj, vk = vec(), vec()
    dists = [np.linalg.norm(v, axis=-1) for v in (vj, vk, vk - vj)]
    dists = [np.where(real, d, 0.0) for d in dists]
    slot = rng.integers(0, n_slots, (rows, n)).astype(np.float64)
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    return [t(d) for d in dists] + [t(slot), t(real.astype(np.float64))]


# G2 cases (N, slots, wide grid): the featurizer's bucket widths, widths
# that are no multiple of 4 (unaligned rows, a partial second span), 1-3
# slots and more than one pass holds (6), the served 5-row grid and a
# wide one of 18 rows (the 32-row instantiation)
G2_CASES = ((32, 1, False), (64, 2, False), (128, 1, False),
            (128, 2, False), (256, 3, False), (130, 3, False),
            (77, 1, True), (128, 2, True), (64, 6, False))


def check_kernels(device="cuda", rows=4001) -> None:
    """Kernel wrapper against twin; the autograd Function's gradient
    against the twin's own autograd."""
    phase("kernels")
    from tensoralloy_tpu_torch.ops import fused
    from tensoralloy_tpu_torch.nn.sf import SymmetryFunction
    sf = SymmetryFunction(["Ni"], eta=[0.01, 0.1, 0.5, 1.0, 4.0],
                          omega=[0.0], beta=[0.005], gamma=[1.0, -1.0],
                          zeta=[1.0, 4.0])
    wide = SymmetryFunction(["Ni"], eta=[0.01, 0.1, 0.5, 1.0, 4.0, 20.0],
                            omega=[0.0, 1.5, 3.0])
    rng = np.random.default_rng(SEED)
    for dtype, tol in ((torch.float32, F32), (torch.float64, F64)):
        for cutoff in ("cosine", "polynomial"):
            for n, n_slots, is_wide in G2_CASES:
                grid = (wide if is_wide else sf).radial_grid
                rij, slot, mask = _random_pairs(rng, rows, n, n_slots, 6.0,
                                                dtype, device)
                _compare("g2", f"{cutoff} N={n} S={n_slots} T2={len(grid)}",
                         fused.G2Function, fused.g2_reference, [rij],
                         [slot, mask], (grid, 6.0, cutoff, n_slots), dtype,
                         tol)
            for n, n_slots in ((256, 3), (384, 1), (384, 3)):
                g4_args = (sf.angular_grid, 4.0, cutoff, n_slots)
                *dists, slot, mask = _random_triples(rng, rows, n, n_slots,
                                                     4.0, dtype, device)
                _compare("g4", f"{cutoff} N={n} S={n_slots}",
                         fused.G4Function, fused.g4_reference, dists,
                         [slot, mask], g4_args, dtype, tol)
    check_grap_kernel(device, rows)


# GRAP cases: the served snap_Ni filter bank (16 pexp filters) and the
# small grids of tests/test_backends.py, moments with gaps, symmetric
# weights, then rows of 256 entries in one slot (more than 128 real
# pairs), 64 filters (two passes over a row at moment 5) and three
# slots; (algorithm, parameters, moments, symmetric, cutoff, N, slots)
_SNAP_PEXP = {"rl": np.linspace(1.0, 4.0, 16).tolist(),
              "pl": np.linspace(5.0, 1.25, 16).tolist()}
_WIDE_PEXP = {"rl": np.linspace(1.0, 4.0, 64).tolist(),
              "pl": np.linspace(5.0, 1.25, 64).tolist()}
_ALL = [0, 1, 2, 3, 4, 5]
GRAP_CASES = (
    ("pexp", _SNAP_PEXP, _ALL, False, "cosine", 128, 2),
    ("pexp", _SNAP_PEXP, [0, 2, 5], False, "polynomial", 128, 2),
    ("pexp", {"rl": [1.0, 2.0, 3.0], "pl": [4.0, 3.0, 2.0]}, [0, 1, 2, 3],
     True, "cosine", 128, 2),
    ("sf", {"eta": [0.5, 2.0, 8.0], "omega": [0.0, 0.0, 0.0]}, [0, 1, 2, 3],
     False, "polynomial", 128, 2),
    ("morse", {"D": [1.0, 1.0], "gamma": [0.5, 1.0], "r0": [2.0, 2.5]},
     [0, 1, 2, 3], False, "cosine", 128, 2),
    ("density", {"A": [1.0, 1.0], "beta": [2.0, 4.0], "re": [3.0, 3.0]},
     [0, 1, 2, 3], False, "polynomial", 128, 2),
    ("pexp", _SNAP_PEXP, _ALL, False, "cosine", 256, 1),
    ("pexp", _WIDE_PEXP, _ALL, False, "polynomial", 128, 2),
    ("pexp", _WIDE_PEXP, [0, 1, 2], False, "cosine", 128, 1),
    ("sf", {"eta": [0.5, 2.0, 8.0], "omega": [0.0, 0.0, 0.0]}, [0, 1, 2, 3],
     False, "cosine", 128, 3),
)


def _random_unit_pairs(rng, rows, n, n_slots, rc, dtype, device):
    """Seeded [rows, n] GRAP inputs (rij, ux, uy, uz, slot, mask): real
    entries first, then a masked tail of zero distances and zero unit
    vectors (finite garbage a kernel must not read)."""
    rij, slot, mask = _random_pairs(rng, rows, n, n_slots, rc, dtype,
                                    device)
    u = rng.normal(size=(3, rows, n))
    u /= np.linalg.norm(u, axis=0)
    u = torch.as_tensor(u, dtype=dtype, device=device) * mask
    return [rij, u[0].contiguous(), u[1].contiguous(), u[2].contiguous(),
            slot, mask]


def check_grap_kernel(device="cuda", rows=4001) -> None:
    from tensoralloy_tpu_torch.nn.grap import GenericRadialAtomicPotential
    from tensoralloy_tpu_torch.ops import fused
    rng = np.random.default_rng(SEED + 1)
    for dtype, tol in ((torch.float32, F32), (torch.float64, F64)):
        for (algorithm, params, moments, symmetric, cutoff, n,
             n_slots) in GRAP_CASES:
            desc = GenericRadialAtomicPotential(
                ["Mo", "Ni"], algorithm=algorithm, parameters=params,
                moment_tensors=moments, symmetric=symmetric,
                cutoff_function=cutoff)
            *diff, slot, mask = _random_unit_pairs(rng, rows, n, n_slots,
                                                   6.0, dtype, device)
            label = (f"{algorithm} K={desc.n_filters} moments={moments}"
                     f"{' symmetric' if symmetric else ''} {cutoff} N={n} "
                     f"S={n_slots}")
            _compare("grap", label, fused.GrapFunction,
                     fused.grap_reference, diff, [slot, mask],
                     (desc, 6.0, n_slots), dtype, tol)


def _compare(name, label, function, reference, diff, rest, spec, dtype,
             tol):
    """Values and gradients of `function` (kernel forward) against the
    plain `reference` on the same inputs."""
    x = [d.clone().requires_grad_() for d in diff]
    y = function.apply(*x, *rest, *spec)
    torch.cuda.synchronize()
    x_ref = [d.clone().requires_grad_() for d in diff]
    y_ref = reference(*x_ref, *rest, *spec)
    torch.testing.assert_close(y, y_ref, **tol)
    gen = torch.Generator(device=y.device).manual_seed(SEED)
    gbar = torch.randn(y.shape, generator=gen, dtype=dtype, device=y.device)
    grads = torch.autograd.grad(y, x, gbar)
    grads_ref = torch.autograd.grad(y_ref, x_ref, gbar)
    for g, gr in zip(grads, grads_ref):
        torch.testing.assert_close(g, gr, **tol)
    err = (y - y_ref).abs().max().item()
    print(f"  {name} {str(dtype)[6:]} {label} {tuple(y.shape)}: "
          f"max_abs_err {err:.3e} at max|value| "
          f"{y_ref.abs().max().item():.3e} (rtol/atol {tol['rtol']:g}) ok")


def _structure(reps, symbols=None):
    from tensoralloy_tpu_torch.atoms import Structure
    pos, cell = jittered_fcc(reps)
    symbols = symbols or ["Ni"] * len(pos)
    return Structure.from_symbols(symbols, pos, cell, pbc=[True] * 3)


def _moni_structure(reps=MONI_REPS):
    """Jittered fcc with MO_FRACTION of the sites Mo, drawn from a seeded
    numpy generator."""
    n = 4 * reps ** 3
    mo = np.random.default_rng(SEED).choice(n, int(MO_FRACTION * n),
                                            replace=False)
    symbols = np.full(n, "Ni", dtype=object)
    symbols[mo] = "Mo"
    return _structure(reps, symbols.tolist())


def _fixture(fixture):
    """-> (Structure, record) of a JAX-reference fixture (path, element)."""
    from tensoralloy_tpu_torch.atoms import Structure
    path, element = fixture
    ref = json.loads(path.read_text())
    info = ({"etemperature": ref["etemperature"]}
            if "etemperature" in ref else {})
    s = Structure.from_symbols([element] * len(ref["positions"]),
                               ref["positions"], ref["cell"],
                               pbc=[True] * 3, **info)
    return s, ref


def _requests(path_name, request_reps):
    model, _, fixture = PATHS[path_name]
    if path_name in ("sf", "grap"):
        return [_fixture(fixture)[0]] + [_structure(r)
                                         for r in request_reps[1:]]
    if path_name == "moni":
        return [_moni_structure()]
    return [_fixture(fixture)[0]]


def serve_path(path_name, request_reps=REQUEST_REPS):
    """One path of the main path: its requests through the kernels, with
    the launch counts reset just before and read just after. The
    calculators name no device: they must land on the card."""
    from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
    from tensoralloy_tpu_torch.ops import fused
    model, kernels, fixture = PATHS[path_name]
    print(f"  -- {path_name}: {model.relative_to(ROOT)}")
    calc = TensorAlloyCalculator(str(model), dtype="medium",
                                 backend="pallas")
    devices = {calc.device.type} | {p.device.type
                                    for p in calc.model.parameters()}
    if devices != {"cuda"}:
        raise AssertionError(f"the default device is {devices}, not cuda")
    structures = _requests(path_name, request_reps)
    results = []
    fused.reset_launch_counts()
    for s in structures:
        before = dict(fused.launch_counts)
        results.append(calc.calculate(s))
        after = dict(fused.launch_counts)
        if not all(after[k] > before[k] for k in kernels):
            raise AssertionError(f"{path_name} {len(s)} atoms: kernels "
                                 f"{kernels} not launched ({before} -> "
                                 f"{after})")
    launches = dict(fused.launch_counts)
    print(f"  launches over the {len(structures)} request(s): {launches}")

    twin = TensorAlloyCalculator(str(model), dtype="medium",
                                 backend="dense")
    for s, res in zip(structures, results):
        errs = efs_errors(res, twin.calculate(s))
        fsum = float(np.max(np.abs(res["forces"].sum(axis=0))))
        fmax = float(np.max(np.abs(res["forces"])))
        print(f"  {len(s)} atoms: E {res['energy']:.6f} eV, "
              f"max|F| {fmax:.4f} eV/A, |sum F| {fsum:.2e}; vs twins "
              f"{json.dumps(errs)}")
        if max(errs.values()) > F32_REL:
            raise AssertionError(f"kernel path disagrees with twins: {errs}")
        # float32 round-off of a few hundred terms per atom, summed over
        # atoms as a random walk
        if fsum > 1e-5 * fmax * np.sqrt(len(s)):
            raise AssertionError(f"|sum F| = {fsum} is not ~0")

    if fixture is not None:
        s, ref = _fixture(fixture)
        errs32 = efs_errors(results[0], ref)
        calc64 = TensorAlloyCalculator(str(model), dtype="high",
                                       backend="pallas")
        errs64 = efs_errors(calc64.calculate(s), ref)
        print(f"  {len(s)} atoms vs JAX fixture: float32 "
              f"{json.dumps(errs32)}; float64 {json.dumps(errs64)}")
        if max(errs32.values()) > F32_REL or max(errs64.values()) > F64_REL:
            raise AssertionError("port disagrees with the JAX fixture")
    return calc, twin, structures, {k: launches[k] for k in kernels}


def serve(request_reps=REQUEST_REPS):
    """The main path: every path in turn. -> {path: (calc, twin,
    structures)}, launches per kernel summed over the paths."""
    phase("serve")
    served, launches = {}, {}
    for name in PATHS:
        calc, twin, structures, counts = serve_path(name, request_reps)
        served[name] = (calc, twin, structures)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    return served, launches


def _median_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event times of single calls: the event pair
    also spans the host's enqueue when the device waits on it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _queued_ms(fn, reps: int, warmup: int = 3, runs: int = 5) -> float:
    """Device time of one call: `reps` calls queued behind a sleeping
    kernel, so the host has enqueued them all before the device starts;
    the median of `runs` such runs, over `reps`. It leaves out the host
    work of a call (the wrapper, the launch) that a single call pays."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)   # about 0.1 s of device clock
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def _rotated(args, copies: int):
    """Endless turns over `copies` copies of `args`, its tensors cloned:
    a launch then finds none of its inputs in the L2 cache, as a served
    request's launch does."""
    sets = [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args) for _ in range(copies - 1)]
    return itertools.cycle(sets)


def _median_host_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def kernel_cases(sf_calc, sf_structure, grap_calc, grap_structure):
    """{kernel: (args, kernel wrapper, twin)} at the shapes the SF and
    GRAP calculators give the kernels for these structures."""
    from tensoralloy_tpu_torch.ops import fused
    from tensoralloy_tpu_torch.ops.dense import (dense_pair_geometry,
                                                 dense_triple_geometry)
    s = sf_structure
    feats = sf_calc.featurize(s, sf_calc._get_vap(s))
    sf, fz = sf_calc.model.descriptor, sf_calc.featurizer
    rij, _, islot, mask = dense_pair_geometry(feats, with_unit=False)
    cases = {
        "g2": ((rij, islot, mask, sf.radial_grid, fz.rcut,
                sf.cutoff_function, fz.n_radial_slots), fused.g2_kernel,
               fused.g2_reference),
        "g4": ((*dense_triple_geometry(feats), sf.angular_grid, fz.acut,
                sf.cutoff_function, fz.n_angular_slots), fused.g4_kernel,
               fused.g4_reference)}
    s = grap_structure
    feats = grap_calc.featurize(s, grap_calc._get_vap(s))
    fz = grap_calc.featurizer
    rij, unit, islot, mask = dense_pair_geometry(feats)
    cases["grap"] = ((rij, *unit, islot, mask, grap_calc.model.descriptor,
                      fz.rcut, fz.n_radial_slots), fused.grap_kernel,
                     fused.grap_reference)
    return cases


def time_path(card, served, launches):
    phase("time")
    for name, (calc, twin, structures) in served.items():
        for s in structures:
            reps = 5 if len(s) < 10000 else 3
            vap = calc._get_vap(s)
            t_req = _median_host_ms(lambda: calc.calculate(s), reps)
            t_feat = _median_host_ms(lambda: calc.featurize(s, vap), reps)
            feats = calc.featurize(s, vap)
            t_k = _median_host_ms(lambda: calc._get_efs(s)(feats), reps)
            t_t = _median_host_ms(lambda: twin._get_efs(s)(feats), reps)
            print(f"  {name} request {len(s)} atoms: {t_req:.2f} ms, of "
                  f"which host featurize + copy {t_feat:.2f} ms; device "
                  f"E/F/S {t_k:.2f} ms through the kernels, {t_t:.2f} ms "
                  f"through the twins (medians of {reps}; {card})")

    # each kernel at the main path's shapes: its largest request
    cases = kernel_cases(served["sf"][0], served["sf"][2][-1],
                         served["grap"][0], served["grap"][2][-1])
    return time_kernels(cases, card, launches)


def time_kernels(cases, card, launches=None):
    """Each kernel of `kernel_cases` against its twin on the same inputs:
    -> one row of the kernels line a kernel (`launches` from the main
    path's run where given)."""
    rows = []
    for name, (args, kernel, reference) in cases.items():
        out = kernel(*args)
        err = (out - reference(*args)).abs().max().item()
        n_bytes, flop = kernel_work(name, args, out)
        bound = {"bytes": n_bytes / PEAK_BYTES_PER_S * 1e3,
                 "operations": flop / PEAK_FP32_FLOP_PER_S * 1e3}
        bound_by = max(bound, key=bound.get)
        ms = _median_ms(lambda: kernel(*args), 20)
        plain_ms = _median_ms(lambda: reference(*args), 20)
        ms2 = _median_ms(lambda: kernel(*args), 20)
        queued = _queued_ms(lambda: kernel(*args), 50)
        turns = _rotated(args, ROTATED_COPIES)
        rotated = _queued_ms(lambda: kernel(*next(turns)),
                             12 * ROTATED_COPIES)
        del turns
        print(f"  {name} {tuple(args[0].shape)} float32: kernel {ms:.4f} / "
              f"{ms2:.4f} ms median of single launches "
              f"({n_bytes / ms * 1e-6:.1f} GB/s, "
              f"{flop / ms * 1e-9:.2f} TFLOP/s), {queued:.4f} ms "
              f"queued ({n_bytes / queued * 1e-6:.1f} GB/s, "
              f"{flop / queued * 1e-9:.2f} TFLOP/s), {rotated:.4f} ms queued "
              f"over {ROTATED_COPIES} copies of the inputs in turn; twin "
              f"{plain_ms:.4f} ms; "
              f"bound {bound[bound_by]:.4f} ms by {bound_by} "
              f"({n_bytes / 1e6:.1f} MB, {flop / 1e9:.3f} GFLOP; single "
              f"launches at {100 * bound[bound_by] / ms:.1f} % of it, queued "
              f"at {100 * bound[bound_by] / queued:.1f} %), max_abs_err "
              f"{err:.3e} ({card})")
        row = {"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name]}
        if launches is not None:
            row["launches"] = launches[name]
        row.update({"max_abs_err": err, "ms": ms, "ms_queued": queued,
                    "ms_queued_rotated": rotated,
                    "plain_ms": plain_ms, "bound_ms": bound[bound_by],
                    "bound_by": bound_by,
                    # no single PyTorch call computes G2, G4 or GRAP
                    "library_ms": None})
        rows.append(row)
    return rows


def kernel_work(name, args, out):
    """-> (bytes, useful FLOP) of one kernel call on these inputs.
    Bytes: the slot and the mask read once in full, the geometry
    (distances, unit vectors) of the real entries (mask > 0) only, since
    a masked entry's geometry need not be read, and the output written
    once; the kernels' small host tables aside. FLOP for the real entries
    only, a transcendental as one:
      g2   per pair 4 (cutoff) + 7 per (eta, omega) row
      g4   per triple 23 (geometry, three cutoffs) + 11 per grid row
      grap per pair 4 (cutoff), D - 1 (monomials), 5 per filter (its
           value at 4 and the product with the cutoff) and 2 K D (the
           contraction); per (row, slot, filter) 3 per nonzero invariant
           weight (P^2, times the weight, added)"""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    *geometry, slot, mask = tensors
    size = mask.element_size()
    real = int((mask > 0).sum().item())
    n_bytes = ((slot.numel() + mask.numel() + len(geometry) * real) * size
               + out.numel() * out.element_size())
    if name == "g2":
        flop = real * (4 + 7 * len(args[3]))
    elif name == "g4":
        flop = real * (23 + 11 * len(args[5]))
    else:
        from tensoralloy_tpu_torch.nn.grap import multiplicity_tensor
        desc, n_slots = args[6], args[8]
        weights = multiplicity_tensor(desc.max_moment, desc.symmetric)[
            :, desc.moment_tensors]
        k, d = desc.n_filters, weights.shape[0]
        rows = args[0].shape[0]
        flop = (real * (4 + (d - 1) + 5 * k + 2 * k * d)
                + 3 * rows * n_slots * k * int(np.count_nonzero(weights)))
    return n_bytes, flop


def main() -> int:
    t0 = time.perf_counter()
    card = check_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build()
    check_kernels()
    served, launches = serve()
    rows = time_path(card, served, launches)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
