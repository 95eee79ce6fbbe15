#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, dynamics, analysis and
command-line paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing its result; any
failure ends the run with a non-zero exit and no result line:

  1. card    require torch.cuda; print nvidia-smi's name and power limit
  2. build   compile the CUDA kernels (G2/G4, GRAP) from the checkout's
             sources
  3. native  build the C++ host lists (neighbor list, triples) with g++
             and fail if they do not build; hold them against the numpy
             lists on the 4000-atom Ni cell, the 4000-atom MoNi cell and
             the 36-atom Be cell (feature dicts: integer arrays exactly,
             floats to 1e-12); print the featurize + copy time of the sf
             and grap requests at 4000 and 32000 atoms both ways
  4. kernels each kernel against its plain PyTorch twin on seeded random
             geometry with masked tails and an empty first row: float32
             values and gradients to 2e-5, float64 to 1e-12; G2 at 32 to
             256 entries and at widths that are no multiple of 4, 1 to 6
             slots, the served grid and one of 18 rows; G4 at 256
             and 384 entries with 1 and 3 slots; GRAP over the algorithm
             x moment grid with gaps, symmetric weights, 1-3 slots, rows
             of 256 entries (more than 128 real pairs) and 64 filters
  5. serve   the port's calculator in float32 with backend="pallas" on
             its default device, which must be cuda, one path after
             another, each with the launch counts reset before it and
             read after it:
               sf      snap_Ni_sfa.npz, jittered fcc Ni of 108 and 4000
                       atoms (G2 and G4)
               grap    snap_Ni.npz (v5_readapt), the same two sizes
               moni    snap_MoNi.npz (ref11), 4000 atoms, 10 % Mo
               td      td_Be.npz, 36 atoms of hcp Be at 0.1 eV
             Each request must launch each of its path's kernels once
             (forces, stress and the by-products come from one pass),
             agree with the
             same calculator on the twins, and have |sum F| ~ 0; the
             108-atom Ni requests and the Be request are also held
             against the JAX-reference fixtures (float32 and float64)
  6. train   the port's trainer on its default device, which must be
             cuda, each trainer built by `TrainingManager` from the
             run's input.toml (backend 'pallas', force_assembly 'dense',
             one step a block, the paths in a temporary directory), on
             artifacts/snap_ni/snap-Ni.db (400 training and 61 test
             structures), the dataset built by the port's host code:
               train_sf    the snap_ni_sfa configuration at full width
                           (5 G2 + 4 G4, 9-128-128-1, batch 25, adam
                           0.002, exponential 0.94/1000, energy per
                           atom x20 + forces)
               train_grap  the snap_ni_v5_readapt configuration (16 pexp
                           filters, moments 0-5, 96-128-128-1, batch 50,
                           adam 0.0005)
             (a) float64 steps from seeded (sf) or the saved (grap)
             parameters: every loss and the first gradient norm against
             the JAX trainer's fixture, 1e-8; (b) float32 steps from
             `init_params`: finite losses, a fixed batch's loss falls,
             one launch of each kernel per forward, and the same run on
             the twins agrees (1e-4 over 5 steps, 1e-3 after); the
             parameter gradient through the kernels against the twins';
             (c) sf: `evaluate` of the saved weights on the test set
             against the fixture; (d) sf: checkpoint, restore, two more
             steps bit for bit; export, and the calculator serves a test
             structure. Prints structures/s, the split of a step from
             CUDA events, peak memory and the dataset build time
  7. manager the experiment path at full width, for
             artifacts/snap_ni_sfa/input.toml and
             artifacts/snap_ni_v5_readapt/input.toml, each with backend
             'pallas', the paths moved to a temporary directory and the
             depth cut to 30 steps with one evaluation and one periodic
             checkpoint: TrainingManager -> train_and_evaluate -> export
             -> evaluate_run -> the exported file served by the
             calculator. The device must be cuda, the run's files must
             exist, every train step must launch each kernel once,
             evaluate_run's overall MAE must equal the trainer's own
             evaluation of the same checkpoint, and a second
             train_and_evaluate with more steps must resume from the
             newest checkpoint
  8. eam     the EAM/ADP family, on its default device (cuda): the
             saved mleam_ni (EamAlloyNN, jittered fcc Ni of 108, 4000
             and 32000 atoms) and mladp_mo_v5 (AdpNN, jittered bcc Mo of
             128, 4394 and 31250 atoms) models served in float32 through
             both routes of the calculator, the analytic EFS on the dense
             layout (fast_efs=True) and autograd on the flat pair layout
             (fast_efs=False), held against each other to 1e-4 in E, F
             and S; both routes in float64 on the small cells against
             the JAX fixtures (1e-10); each request's median time split
             into host featurize + copy and device E/F/S (map + copy,
             build and E/F/S where "auto" takes the device builder: the
             32000-atom cells). Then both runs'
             input.toml as they stand but for depth (30 steps, the
             'rose' and 'elastic' constraints on): TrainingManager ->
             train_and_evaluate -> export (.npz and setfl) ->
             evaluate_run -> the exported model served, and a second run
             that resumes at step 20 and ends bit for bit where a run of
             40 steps made in one go ends (deterministic algorithms on).
             Prints each constraint's loss at the first and last step,
             structures/s and the median step. No descriptor kernel may
             launch in this phase
  9. large   the device-list, chunked and Hessian routes, float32 on the
             default device (cuda): grap 32000 (snap_Ni.npz, kernels),
             EAM Ni 32000 and ADP Mo 31250 (fast EFS) and Ni 32000 on
             the flat route (fast_efs=False) through the default
             calculator, which must take the device builder (one cached
             builder; the flat route also the chunked variant), held
             against the same model on the host lists in one piece (E, F,
             S to 1e-4, |sum F| ~ 0), each request's median split into
             map + copy of the positions, build and E/F/S; SF 4000 with
             device_nl=True (triples on the card) with its peak memory;
             SF and GRAP 32000 with chunked=True, chunk_size=4096 against
             the monolithic route, two launches of each kernel a block;
             get_hessian of the 108-atom Ni cell (mleam_ni, snap_ni_sfa)
             in float64 against the JAX fixtures
             `tests/data/torch_port_ref_hessian_*.json` (1e-10),
             symmetric
 10. md      the dynamics on the default device (cuda): (a) float64 NVE
             of mleam_ni on the 32-atom cell, both EFS routes on host and
             device lists, against `tests/data/torch_port_ref_md_*.json`
             (positions 1e-9, totals 1e-10); (b) float32 NVE of EAM Ni
             4000 on device lists, 200 steps of 1 fs from 300 K with the
             heat flux: the drift of the total under 0.5 meV/atom, the
             analytic and autograd fluxes of the last state to 1e-4; (c)
             GRAP MD of Ni 4000 on device lists, 50 steps: grap_kernel
             once a step and twice a chunk; (d) BAOAB NVT and Berendsen
             NPT of ADP Mo 4394, 100 steps each. Each run prints steps/s,
             atom-steps/s, the chunk-end sync time and the regrows
 11. analysis the materials-analysis path on the default device (cuda),
             each part with the launch counts reset before it and read
             after it (the kernels it names must launch, no other):
             (a) relax_cell -> fit_elastic_tensor -> EOS over 7 volumes of
             snap_ni_sfa on the 4-atom fcc Ni cell (g2, g4): float64
             against `tests/data/torch_port_ref_analysis.json` (1e-6),
             float32 kernels against twins (1e-3); (b) phonons of
             mleam_ni (fcc primitive cell, 3x3x3 supercell): Gamma
             acoustic modes below 0.05 THz, X and L and the QHA's inputs
             over 5 scales against the fixture (1e-8), the QHA's fits to
             their solver's precision (`QHA_REL`); a snap_ni_sfa supercell
             Hessian through the kernels against the twins (1e-10); (c)
             `vacancy_diffusivity` of mleam_ni on fcc Ni 3x3x3 (relax ->
             NEB -> Vineyard, exactly one imaginary mode) against
             `torch_port_ref_kinetics.json` (1e-6); (d) the GRAP band of
             the 255-atom vacancy hop (snap_ni_v5_readapt, 7 images,
             float32): one evaluation against the twins (1e-4), then 100
             FIRE steps in chunks of 25 between relaxed endpoints,
             grap_kernel once per band evaluation; (e) the committees:
             5 MoNi GRAP members on the 4000-atom MoNi cell and 8 Mo SF
             members on bcc Mo 4394, the mean against the mean of single
             members (1e-4), one descriptor launch a request, the request
             beside the K single requests; `select_by_uncertainty` over
             8 jittered MoNi frames; (f) LinearTensorMD (pexp8, moments
             0-3) fitted in float64 on the first 50 structures of
             snap-Ni.db through grap_kernel and through the twins
             (coefficients 1e-8), exported and served; (g) Frenkel-Ladd of
             mleam_ni on Ni 108 at 300 K at cut depth, and the Einstein ->
             Einstein integration against its closed form (5 %); (h) the
             (111) and (100) surface energies and the intrinsic stacking
             fault of mleam_ni against `torch_port_ref_surface.json`
             (1e-8). Prints each part's wall time, the FIRE steps/s, the
             TI steps/s and the committees' request times
 12. cli     the command lines on the default device (cuda), each part
             with the launch counts reset before it and read after it:
             (a) `run` of artifacts/snap_ni_sfa/input.toml at full width
             with backend 'pallas', warm-started from the saved model and
             cut to 20 steps with one evaluation and one checkpoint, then
             `export --checkpoint`, `evaluate` and `print` of the run's
             metrics: one launch of g2 and g4 in each train step, the
             run's files, the exported file says 'pallas'; `python -m
             tensoralloy_tpu_torch.cli compute latt` of the exported model
             exits 0; (b) latt, eos, elastic, relax --cell, defect (3x3x3),
             phonon, scatter and percentile (20 structures of snap-Ni.db)
             on the exported model and on its twin copy ('dense'), float32:
             each launches g2 and g4, and its printed numbers and files
             agree with the twins' to 1e-4; (c) md --device-nl of GRAP Ni
             4000 (40 steps, chunks of 20; grap_kernel once a step and
             twice a chunk), neb of the 255-atom vacancy hop (20 FIRE
             steps; once a band evaluation) and uncertainty of the 5 MoNi
             members over 4 jittered frames (once a frame), each on
             'pallas' copies against the saved 'dense' files (1e-4); (d)
             latt, eos, elastic, defect and surface of snap_ni_sfa and
             mleam_ni (their weights stored in float64), float64, against
             `tests/data/torch_port_ref_cli.json` (1e-8 of the largest
             number of a line, 1e-6 for what an EOS fit prints, a printed
             number standing for its value to half a unit of its last
             digit); (e) kappa and fe of
             mleam_ni at cut depth: no descriptor kernel; (f) `python -m
             tensoralloy_tpu_torch.tensordb` through sampling aimd ->
             status -> postprocess -> create calc -> status calc -> gather
             on synthetic VASP outputs. Prints each verb's wall time, and
             for a `python -m` run its imports apart (`-X importtime`)
 13. descriptors the flat ('segment') layout, legacy GRAP, the learned
             'nn' filter, the descriptor heat flux and the chunked
             committee, on the default device (cuda), each part with the
             launch counts reset before it and read after it: (a)
             snap_Ni_sfa and snap_Ni (v5_readapt) with backend="segment"
             on jittered fcc Ni of 108 and 4000 atoms (host lists) and,
             GRAP, 32000 atoms (the device builder "auto" takes), each
             request against the same model on 'pallas' and 'dense'
             (float32, 1e-4; no kernel on the segment route), the float64
             108-atom requests against the JAX fixtures (1e-10), each
             request's split and peak memory beside the kernels'; (b)
             both training configurations at full width with backend
             'segment': float64 steps against the train fixtures (1e-8),
             5 float32 steps against the pallas run (1e-4); (c) the
             committed JAX-saved legacy (moments 0-2) and 'nn' (16
             filters, hidden [32, 32, 32]) models at the
             snap_ni_v5_readapt width: float64 E/F/S of the 108-atom cell
             against `tests/data/torch_port_ref_grap_legacy_nn.json`
             (1e-10) on each backend, the 'nn' model on 'pallas' launching
             no kernel and equal to its dense route, a float64 train step
             (loss, every leaf's gradient norm) against the JAX trainer's
             (1e-8); (d) the segment copy of snap_ni_sfa: a float64 NVE of
             the 108-atom cell with the flux against
             `tests/data/torch_port_ref_heat_flux_sf.json` (1e-9), atomic
             virials summing to the virial, `python -m
             tensoralloy_tpu_torch.cli compute kappa` exits 0; (e) the 5
             MoNi GRAP members at 4000 atoms with chunked=True against
             chunked=False (1e-4), grap_kernel once a row block
 14. parallel `parallel/` over `torch.distributed`, each part printing
             its backend and each time beside the card's name and power
             limit: (a) in this process a world of one rank on a
             HashStore with NCCL: a data-parallel float64 step of
             snap_ni_sfa (batch 50), spatial EFS, a replica-sharded band
             and a member-sharded committee through the NCCL
             communicator, each equal to its run without a group
             (1e-12); (b) two gloo ranks sharing the card through
             `parallel.mesh.launch`: data-parallel steps of snap_ni_sfa
             and snap_ni_v5_readapt at batch 50 on snap-Ni.db through the
             kernels (one float64 step against the one-rank step, 1e-10,
             and snap_ni_v5_readapt's against its train fixture, 1e-8;
             3 float32 steps against the one-rank run, 1e-5; the step
             times and the gradient all-reduce), spatial EFS of mleam_ni
             Ni 32000 on flat pairs (the device builder) and on the fast
             dense route, and of mladp_mo_v5 Mo 31250 on the fast route
             (1e-4), the 255-atom GRAP band of 8 images for 10 FIRE steps
             with 4 images a rank, and 4 MoNi members at 4000 atoms with 2
             a rank, each against one rank (1e-4); every rank's launches
             are counted; (c) `python -m torch.distributed.run
             --nproc_per_node 2 -m tensoralloy_tpu_torch.cli compute neb
             --shards 2` against the unsharded verb (1e-4 of a line)
 15. time    median time per request and its device E/F/S part,
             kernels vs twins (the grap 32000 request on device lists, as
             "auto" routes it); each kernel vs its twin at the
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

The line before the last is a JSON object of per-kernel results (the
launches of the serve, train, manager, large, md, analysis, cli,
descriptors and parallel phases, each counted from 0; "cli",
"descriptors" and "parallel" those phases' alone, "parallel" summed over
the ranks);
the last is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import tomllib
from collections import Counter
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
# fcc repeats per axis -> 108 and 4000 atoms served; the kernels are
# timed at the 32000-atom request's shapes
REQUEST_REPS = (3, 10)
TIMED_REPS = 20
LATTICE = 3.52      # Angstrom
SIGMA = 0.05        # Angstrom, Gaussian jitter of every coordinate
BE_A, BE_C = 2.2858, 3.5843   # hcp Be, Angstrom
SEED = 0
F32 = dict(rtol=2e-5, atol=2e-5)     # as tests/test_backends.py
F64 = dict(rtol=1e-12, atol=1e-12)
F32_REL = 1e-4      # E/F/S relative error, float32 serving
F64_REL = 1e-10     # E/F/S relative error, float64 serving
TRAIN_DB = MODELS / "snap_ni" / "snap-Ni.db"
# the training configurations at full width: the run whose input.toml
# the manager reads, the run's saved model (its weights are the warm
# start and what `evaluate` is held on), and the depth of each part
TRAIN_CONFIGS = {
    "sf": dict(
        run="snap_ni_sfa", descriptor="sf",
        model="artifacts/snap_ni_sfa/model/snap_Ni_sfa.npz",
        warm_start=False, fixture_steps=5, steps=30, evaluate=True,
        kernels=("g2", "g4")),
    "grap": dict(
        run="snap_ni_v5_readapt", descriptor="grap",
        model="artifacts/snap_ni_v5_readapt/model/snap_Ni.npz",
        warm_start=True, fixture_steps=3, steps=10, evaluate=False,
        kernels=("grap",)),
}
# the descriptors phase (c): snap_ni_v5_readapt's input.toml with legacy
# GRAP (moments 0-2) and with the learned filter (the file defaults:
# hidden [32, 32, 32], 16 filters), each model JAX-saved with its
# weights (`python -m tests.test_torch_grap_legacy_nn`)
LEGACY_NN_CONFIGS = {
    "legacy": {"nn.atomic.grap.legacy_mode": True,
               "nn.atomic.grap.moment_tensors": [0, 1, 2],
               "nn.atomic.grap.backend": "segment"},
    "nn": {"nn.atomic.grap.algorithm": "nn",
           "nn.atomic.grap.backend": "dense"},
}
LEGACY_NN_FILES = {name: f"tests/data/torch_port_grap_{name}_ni.npz"
                   for name in LEGACY_NN_CONFIGS}
# the eam phase: model, lattice, element, lattice constant (Angstrom),
# repeats of the cells served (the first is the JAX fixture's cell), and
# the fixture
EAM_PATHS = {
    "mleam_ni": (MODELS / "mleam_ni" / "model" / "snap_Ni_mleam.npz", "fcc",
                 "Ni", 3.52, (3, 10, 20),
                 DATA / "torch_port_ref_eam_mleam_ni.json"),
    "mladp_mo_v5": (MODELS / "mladp_mo_v5" / "model" / "snap_Mo_mladp_gw.npz",
                    "bcc", "Mo", 3.16, (4, 13, 25),
                    DATA / "torch_port_ref_eam_mladp_mo_v5.json"),
}
# the manager phase: steps of the first run (one evaluation and one
# periodic checkpoint at EVAL_STEPS) and of the run that resumes it
MANAGER_STEPS, MANAGER_EVAL_STEPS, MANAGER_RESUMED_STEPS = 30, 20, 40
TRAIN_F64_REL = 1e-8     # losses, gradient norm, metrics vs the fixture
# ... the gradient norm at a warm start: the converged model's energy
# error is 1e-6 of the energy, so a few ulps of the energy (another
# summation order) move the gradient by 1e-9 to 1e-8
TRAIN_F64_WARM_GRAD_REL = 1e-7
TRAIN_F32_REL = 1e-3     # float32 losses and metrics, kernels vs twins
TRAIN_F32_REL_FIRST = 1e-4   # ... over the first 5 steps
GRAD_F32_REL = 1e-4      # parameter gradient, kernel path vs twin path
GRAD_F64_REL = 1e-10
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
# experiment files
# ----------------------------------------------------------------------

def experiment_config(run: str, workdir, overrides=None, database=None
                      ) -> dict:
    """artifacts/<run>/input.toml, merged over the defaults, as a dict
    that writes nothing under artifacts/: the database (the run's own, or
    `database`) is copied into `workdir`, and the cache and `model_dir`
    lie there too. `overrides` maps dotted keys to values."""
    from tensoralloy_tpu_torch.io.input import InputReader
    from tensoralloy_tpu_torch.utils import nested_set
    workdir = Path(workdir)
    config = InputReader(str(MODELS / run / "input.toml")).as_dict()
    source = Path(database or config["dataset"]["sqlite3"])
    target = workdir / source.name
    if not target.exists():
        shutil.copy(source, target)
    for key, value in {"dataset.sqlite3": str(target),
                       "dataset.tfrecords_dir": str(workdir / "cache"),
                       "train.model_dir": str(workdir / "model"),
                       **(overrides or {})}.items():
        nested_set(config, key, value)
    return config


def dump_toml(config: dict, path) -> None:
    """Write a nested dict of strings, numbers, booleans and lists as a
    TOML file (what `evaluate_run` reads from a run's directory)."""
    def key(k):
        return k if re.fullmatch(r"[A-Za-z0-9_-]+", k) else json.dumps(k)

    def value(v):
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, (int, float)):
            return repr(v)
        if isinstance(v, str):
            return json.dumps(v)
        if isinstance(v, (list, tuple)):
            return "[" + ", ".join(value(x) for x in v) + "]"
        raise TypeError(f"no TOML form for {v!r}")

    lines = []

    def table(d, prefix):
        if prefix:
            lines.append(f"[{prefix}]")
        lines.extend(f"{key(k)} = {value(v)}" for k, v in d.items()
                     if not isinstance(v, dict))
        for k, v in d.items():
            if isinstance(v, dict):
                table(v, f"{prefix}.{key(k)}" if prefix else key(k))

    table(config, "")
    Path(path).write_text("\n".join(lines) + "\n")


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


def _numpy_lists(on: bool):
    """Switch the host lists to the numpy path (or back to native)."""
    if on:
        os.environ["TENSORALLOY_TPU_NO_NATIVE"] = "1"
    else:
        os.environ.pop("TENSORALLOY_TPU_NO_NATIVE", None)


def check_native(card) -> dict:
    """Build the C++ host lists, hold them against the numpy lists on the
    served cells, and time a request's featurization both ways. ->
    {request: {"native": [ms, ...], "numpy": [ms, ...]}}."""
    phase("native")
    from tensoralloy_tpu_torch import native
    from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise SystemExit("FAIL native: the C++ host lists did not build "
                         "(g++ -O3 on tensoralloy_tpu_torch/native/"
                         "neighbor.cpp)")
    print(f"built {native.library_path().name} in "
          f"{time.perf_counter() - t0:.1f} s")
    calcs = {name: TensorAlloyCalculator(str(PATHS[name][0]),
                                         dtype="medium", backend="pallas")
             for name in PATHS}

    def features(calc, s):
        feats = calc.featurize(s, calc._get_vap(s))
        torch.cuda.synchronize()
        return feats

    cells = (("sf", _structure(REQUEST_REPS[1])), ("moni", _moni_structure()),
             ("td", _fixture(PATHS["td"][2])[0]))
    for name, s in cells:
        got = features(calcs[name], s)
        _numpy_lists(True)
        try:
            want = features(calcs[name], s)
        finally:
            _numpy_lists(False)
        if sorted(got) != sorted(want):
            raise AssertionError(f"native {name}: keys differ")
        for k, w in want.items():
            if w.is_floating_point():
                torch.testing.assert_close(got[k], w, rtol=1e-12, atol=1e-12)
            elif not torch.equal(got[k], w):
                raise AssertionError(f"native {name}: {k} differs from the "
                                     "numpy lists")
        print(f"  {name} {len(s)} atoms: {len(want)} feature arrays equal "
              f"the numpy lists' (pair rows "
              f"{tuple(want['pair_j_d'].shape)}"
              + (f", triple rows {tuple(want['trip_j_d'].shape)}"
                 if "trip_j_d" in want else "") + ")")

    # the C++ calls' own share of a featurization with the native lists
    in_lists = [0.0]

    def clocked(fn):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            in_lists[0] += (time.perf_counter() - t0) * 1e3
            return out
        return call

    lists = native.native_neighbor_list, native.native_triple_list
    times = {}
    try:
        native.native_neighbor_list, native.native_triple_list = map(
            clocked, lists)
        for name in ("sf", "grap"):
            for reps in (REQUEST_REPS[1], TIMED_REPS):
                s = _structure(reps)
                row = times[f"{name} {len(s)}"] = {}
                for which in ("native", "numpy"):
                    _numpy_lists(which == "numpy")
                    try:
                        features(calcs[name], s)      # warm-up
                        n = 3 if len(s) < 10000 or which == "native" else 2
                        row[which] = []
                        in_lists[0] = 0.0
                        for _ in range(n):
                            t0 = time.perf_counter()
                            features(calcs[name], s)
                            row[which].append(
                                (time.perf_counter() - t0) * 1e3)
                        if which == "native":
                            row["cpp"] = in_lists[0] / n
                    finally:
                        _numpy_lists(False)
                print(f"  {name} {len(s)} atoms, host featurize + copy: "
                      + "; ".join(
                          f"{which} lists median {np.median(row[which]):.1f} "
                          f"ms (min {min(row[which]):.1f}, max "
                          f"{max(row[which]):.1f}, {len(row[which])} calls)"
                          for which in ("native", "numpy"))
                      + f"; inside the two C++ calls {row['cpp']:.1f} ms a "
                      f"native-list call ({card})")
    finally:
        native.native_neighbor_list, native.native_triple_list = lists
    return times


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
                          zeta=[1.0, 4.0], backend="dense")
    wide = SymmetryFunction(["Ni"], eta=[0.01, 0.1, 0.5, 1.0, 4.0, 20.0],
                            omega=[0.0, 1.5, 3.0], backend="dense")
    rng = np.random.default_rng(SEED)
    for dtype, tol in ((torch.float32, F32), (torch.float64, F64)):
        for cutoff in ("cosine", "polynomial"):
            for n, n_slots, is_wide in G2_CASES:
                grid = (wide if is_wide else sf).radial_grid
                rij, slot, mask = _random_pairs(rng, rows, n, n_slots, 6.0,
                                                dtype, device)
                g2_case = ("g2", f"{cutoff} N={n} S={n_slots} "
                           f"T2={len(grid)}", fused.G2Function,
                           fused.g2_reference, [rij], [slot, mask],
                           (grid, 6.0, cutoff, n_slots), dtype, tol)
                _compare(*g2_case)
            _compare_second_order(*g2_case)
            for n, n_slots in ((256, 3), (384, 1), (384, 3)):
                g4_args = (sf.angular_grid, 4.0, cutoff, n_slots)
                *dists, slot, mask = _random_triples(rng, rows, n, n_slots,
                                                     4.0, dtype, device)
                g4_case = ("g4", f"{cutoff} N={n} S={n_slots}",
                           fused.G4Function, fused.g4_reference, dists,
                           [slot, mask], g4_args, dtype, tol)
                _compare(*g4_case)
            _compare_second_order(*g4_case)
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
                cutoff_function=cutoff, backend="dense")
            *diff, slot, mask = _random_unit_pairs(rng, rows, n, n_slots,
                                                   6.0, dtype, device)
            label = (f"{algorithm} K={desc.n_filters} moments={moments}"
                     f"{' symmetric' if symmetric else ''} {cutoff} N={n} "
                     f"S={n_slots}")
            grap_case = ("grap", label, fused.GrapFunction,
                         fused.grap_reference, diff, [slot, mask],
                         (desc, 6.0, n_slots), dtype, tol)
            _compare(*grap_case)
            if desc.n_filters <= 16:
                _compare_second_order(*grap_case)


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


def _compare_second_order(name, label, function, reference, diff, rest,
                          spec, dtype, tol):
    """The scalar sum_i <u_i, dY/dx_i . gbar> of the first-order
    gradients (seeded u, gbar), differentiated w.r.t. gbar and the
    inputs: kernel forward against the all-twin path."""
    gen = torch.Generator(device=diff[0].device).manual_seed(SEED + 2)
    rand = lambda shape: torch.randn(shape, generator=gen, dtype=dtype,
                                     device=diff[0].device)
    us = [rand(d.shape) for d in diff]
    gbar0 = None
    results = []
    for fn in (function.apply, reference):
        x = [d.clone().requires_grad_() for d in diff]
        y = fn(*x, *rest, *spec)
        if gbar0 is None:
            gbar0 = rand(y.shape)
        gbar = gbar0.clone().requires_grad_()
        grads = torch.autograd.grad(y, x, gbar, create_graph=True)
        scalar = sum((u * g).sum() for u, g in zip(us, grads))
        results.append(torch.autograd.grad(scalar, [gbar] + x))
    for got, want in zip(*results):
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name} {label}: second-order gradient "
                                 "is not finite")
        torch.testing.assert_close(got, want, **tol)
    top = max(w.abs().max().item() for w in results[1])
    print(f"  {name} {str(dtype)[6:]} {label}: second-order gradients "
          f"w.r.t. gbar and {len(diff)} input(s) finite, max|value| "
          f"{top:.3e}, kernel forward vs twins ok")


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
        if not all(after[k] == before[k] + 1 for k in kernels):
            raise AssertionError(f"{path_name} {len(s)} atoms: kernels "
                                 f"{kernels} not launched once each "
                                 f"({before} -> {after})")
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


# ----------------------------------------------------------------------
# train
# ----------------------------------------------------------------------

def seeded_params(tree, seed: int):
    """Parameters in the shape of `tree` (nested dicts and lists of
    arrays, the JAX parameter tree), made with numpy from a seed: kernels
    N(0, 1/fan_in), biases the tree's own plus N(0, 0.1), dt 0.1 plus
    N(0, 0.02); the min/max statistics ('norm') are kept. Leaves are
    visited in sorted key order."""
    rng = np.random.default_rng(seed)

    def visit(node, path):
        if isinstance(node, dict):
            return {k: visit(node[k], path + [k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [visit(v, path + [str(i)]) for i, v in enumerate(node)]
        x = np.asarray(node, np.float64)
        if "norm" in path:
            return x
        if path[-1] == "w":
            return rng.normal(0.0, 1.0 / np.sqrt(x.shape[0]), x.shape)
        if path[-1] == "dt":
            return 0.1 + rng.normal(0.0, 0.02, x.shape)
        return x + rng.normal(0.0, 0.1, x.shape)

    return visit(tree, [])


def _tree_rel_err(got, want) -> float:
    """max over leaves of max|got - want| over the largest |want|."""
    from tensoralloy_tpu_torch.utils import tree_flatten
    got, want = tree_flatten(got), tree_flatten(want)
    top = max(float(w.abs().max()) for w in want.values())
    return max(float((got[k] - want[k]).abs().max())
               for k in want) / max(top, 1e-300)


def _manager(cfg, work, dtype, backend, steps):
    """The configuration's `TrainingManager`, built from the run's
    input.toml on the default device: loss, optimizer, batch size, seed
    and split are the file's. Changed for this phase: the precision, the
    descriptor backend, the depth, one step a block (every step's loss
    is read), the scatter-free force assembly where the backend reads
    the dense rows (the flat 'segment' layout has autograd's alone), and
    no periodic work."""
    from tensoralloy_tpu_torch.train.manager import TrainingManager
    config = experiment_config(cfg["run"], work, {
        "precision": dtype,
        f"nn.atomic.{cfg['descriptor']}.backend": backend,
        "train.train_steps": steps, "train.scan_steps": 1,
        "train.eval_steps": 10 ** 9, "train.log_steps": 10 ** 9,
        "train.force_assembly": "auto" if backend == "segment" else "dense",
        "train.final_f32_steps": 0}, database=TRAIN_DB)
    manager = TrainingManager(config)
    if manager.trainer.device.type != "cuda":
        raise AssertionError(f"the default device is "
                             f"{manager.trainer.device}, not cuda")
    return manager


def _fit_losses(trainer, arrays, params, timed=False):
    """fit -> (result, the loss of every step[, seconds of every step,
    the device waited for after each])."""
    losses, seconds = [], []
    last = [time.perf_counter()]

    def record(step, state, metrics):
        losses.append(metrics["loss/total"])
        if timed:
            torch.cuda.synchronize()
            now = time.perf_counter()
            seconds.append(now - last[0])
            last[0] = now

    out = trainer.fit(arrays[0], arrays[1], params=params, verbose=False,
                      callback=record)
    return out, [float(x) for x in losses], seconds


def _check_losses(what, got, want, rel):
    errs = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    print(f"  {what}: losses {[f'{x:.8g}' for x in got]}, max rel err "
          f"{max(errs):.2e} (limit {rel:g})")
    if len(got) != len(want) or not all(np.isfinite(got)) \
            or max(errs) > rel:
        raise AssertionError(f"{what}: losses {got} vs {want}")


def _step_split(trainer, state, dev_feats, dev_labels, batches_idx, card):
    """The split of one train step from CUDA events: batch gather,
    forward, first backward (forces), loss backward (double),
    optimizer + EMA; medians over the given batches."""
    names = ("gather", "forward", "first backward (forces)",
             "loss + loss backward (double)", "optimizer + EMA")
    marks = {}

    def mark(key):
        marks[key] = torch.cuda.Event(enable_timing=True)
        marks[key].record()

    model = trainer.model

    def predictions(params, feats, create_graph=False):
        def energy_fn(f):
            out = model.energy_and_aux(f, params)
            mark("forward")
            return out
        out = trainer._select_efs(feats)(energy_fn, create_graph)(feats)
        mark("first")
        return out

    update = trainer._opt_update

    def timed_update(*args):
        mark("loss")
        return update(*args)

    trainer.batched_predictions, trainer._opt_update = \
        predictions, timed_update
    rows = []
    try:
        for sel in batches_idx:
            mark("start")
            sel = torch.as_tensor(sel, device=trainer.device)
            bf = {k: v[sel] for k, v in dev_feats.items()}
            bl = {k: v[sel] for k, v in dev_labels.items()}
            mark("gather")
            state, _ = trainer.train_step(state, bf, bl)
            mark("end")
            torch.cuda.synchronize()
            order = ("start", "gather", "forward", "first", "loss", "end")
            rows.append([marks[a].elapsed_time(marks[b])
                         for a, b in zip(order, order[1:])])
    finally:
        del trainer.batched_predictions
        trainer._opt_update = update
    med = np.median(np.asarray(rows[2:]), axis=0)
    parts = ", ".join(f"{n} {t:.3f} ms" for n, t in zip(names, med))
    print(f"  step split (CUDA events, medians of {len(rows) - 2} steps "
          f"after 2): {parts}; sum {med.sum():.3f} ms ({card})")
    return dict(zip(names, med.tolist()))


def train_path(name, workdir, card):
    """One training configuration through the kernels; the launch counts
    are reset before each measured run and read after it."""
    from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
    from tensoralloy_tpu_torch.io.model import load_model, save_model
    from tensoralloy_tpu_torch.ops import fused
    from tensoralloy_tpu_torch.train.dataset import batch_index_stream
    from tensoralloy_tpu_torch.train.optim import global_norm
    from tensoralloy_tpu_torch.utils import tree_map
    cfg = TRAIN_CONFIGS[name]
    kernels = cfg["kernels"]
    fixture = json.loads(
        (DATA / f"torch_port_ref_train_{name}.json").read_text())
    work = Path(workdir) / name
    work.mkdir()

    def trainer_of(dtype, backend, steps):
        return _manager(cfg, work, dtype, backend, steps).trainer

    # the dataset, built once at float64 by the port's host code; the
    # float32 trainer casts it
    m64 = _manager(cfg, work, "high", "pallas", cfg["fixture_steps"])
    t64, ds, db = m64.trainer, m64.dataset, m64.db
    batch_size, seed = (t64.train_parameters.batch_size,
                        t64.train_parameters.seed)
    print(f"  -- train_{name}: artifacts/{cfg['run']}/input.toml, batch "
          f"{batch_size}, {m64.opt_parameters}")
    model_file, _ = load_model(str(ROOT / cfg["model"]), dtype="high")
    t0 = time.perf_counter()
    feats, labels = ds.build()
    build_s = time.perf_counter() - t0
    arrays = ds.split(feats, labels)
    n_train, n_test = len(arrays[1]["energy"]), len(arrays[3]["energy"])
    print(f"  dataset: {len(db)} structures featurized on the host "
          f"(native lists, one process) in "
          f"{build_s:.1f} s ({n_train} train, {n_test} test; pair rows "
          f"{feats['pair_j_d'].shape}"
          + (f", triple rows {feats['trip_j_d'].shape}"
             if "trip_j_d" in feats else "") + f") ({card})")
    if (n_train, n_test) != (fixture["n_train"], fixture["n_test"]) \
            or ds.max_occurs != model_file.max_occurs \
            or t64.model.as_dict()["descriptor"] != dict(
                model_file.as_dict()["descriptor"], backend="pallas"):
        raise AssertionError("the split, the layout or the descriptor "
                             "differs from the fixture's")

    # (a) float64 against the JAX trainer's fixture
    saved = model_file.param_tree()
    if cfg["warm_start"]:
        params0 = saved
    else:
        params0 = seeded_params(
            tree_map(lambda x: x.cpu().numpy(), saved), seed)
    first = next(batch_index_stream(n_train, batch_size,
                                    seed=seed, repeat=True))
    bf = t64._to_device({k: v[first] for k, v in arrays[0].items()})
    bl = t64._to_device({k: v[first] for k, v in arrays[1].items()})
    p64 = t64._tree_to_device(params0)
    (_, _), grads = t64.loss_and_grads(p64, bf, bl, 0)
    gnorm = float(global_norm(grads))
    gerr = abs(gnorm - fixture["grad_norm_first_step"]) \
        / fixture["grad_norm_first_step"]
    fused.reset_launch_counts()
    _, losses64, _ = _fit_losses(t64, arrays, params0)
    counts = dict(fused.launch_counts)
    _check_losses(f"train_{name} float64 vs the JAX fixture", losses64,
                  fixture["losses"], TRAIN_F64_REL)
    grad_rel = (TRAIN_F64_WARM_GRAD_REL if cfg["warm_start"]
                else TRAIN_F64_REL)
    print(f"  first-step gradient norm {gnorm:.10g} vs "
          f"{fixture['grad_norm_first_step']:.10g}: rel err {gerr:.2e} "
          f"(limit {grad_rel:g}); "
          f"launches over {len(losses64)} steps {counts}")
    if gerr > grad_rel or any(
            counts[k] != len(losses64) for k in kernels):
        raise AssertionError("float64 training disagrees with the fixture "
                             "or a step did not launch each kernel once")
    # kernel path against twin path at seeded parameters (away from a
    # converged model, whose gradient is ill-conditioned, see above)
    seeded64 = t64._tree_to_device(seeded_params(
        tree_map(lambda x: x.cpu().numpy(), saved), seed))
    twin64 = trainer_of("high", "dense", 1)
    (_, _), grads_kernel = t64.loss_and_grads(seeded64, bf, bl, 0)
    (_, _), grads_twin = twin64.loss_and_grads(seeded64, bf, bl, 0)
    gerr64 = _tree_rel_err(grads_kernel, grads_twin)

    # (b) float32 from init_params, kernels then twins
    steps = cfg["steps"]
    t32 = trainer_of("medium", "pallas", steps)
    twin32 = trainer_of("medium", "dense", steps)
    params_init = t32.init_params(arrays[0], verbose=False)
    fixed_f = t32._to_device({k: v[:batch_size]
                              for k, v in arrays[0].items()})
    fixed_l = t32._to_device({k: v[:batch_size]
                              for k, v in arrays[1].items()})
    (_, _), g32 = t32.loss_and_grads(params_init, fixed_f, fixed_l, 0)
    (_, _), g32_twin = twin32.loss_and_grads(params_init, fixed_f, fixed_l,
                                            0)
    gerr32 = _tree_rel_err(g32, g32_twin)
    print(f"  parameter gradient of the energy+force loss, kernel path "
          f"vs twin path: float64 rel err {gerr64:.2e} (limit "
          f"{GRAD_F64_REL:g}), float32 {gerr32:.2e} (limit "
          f"{GRAD_F32_REL:g})")
    if gerr64 > GRAD_F64_REL or gerr32 > GRAD_F32_REL:
        raise AssertionError("the kernel path's parameter gradient "
                             "disagrees with the twin path's")
    with torch.no_grad():
        before = float(t32.total_loss(params_init, fixed_f, fixed_l, 0)[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused.reset_launch_counts()
    out, losses32, seconds = _fit_losses(t32, arrays, params_init,
                                         timed=True)
    launches = dict(fused.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    state = out["state"]
    with torch.no_grad():
        after = float(t32.total_loss(state["params"], fixed_f, fixed_l,
                                     steps)[0])
    print(f"  float32, {steps} steps from init_params: loss on a fixed "
          f"batch {before:.6f} -> {after:.6f}; launches {launches}")
    if not all(np.isfinite(losses32)) or not after < before or any(
            launches[k] != steps for k in kernels):
        raise AssertionError("float32 training: a loss is not finite, the "
                             "fixed batch's loss did not fall, or a "
                             "forward did not launch each kernel once")
    _, losses_twin, _ = _fit_losses(twin32, arrays, params_init)
    _check_losses(f"train_{name} float32, kernels vs twins, steps 1-5",
                  losses32[:5], losses_twin[:5], TRAIN_F32_REL_FIRST)
    _check_losses(f"train_{name} float32, kernels vs twins, all steps",
                  losses32, losses_twin, TRAIN_F32_REL)
    warm = 3
    rates = batch_size / np.asarray(seconds[warm:])
    print(f"  train_{name} float32 throughput: median "
          f"{np.median(rates):.1f} structures/s over {len(rates)} steps "
          f"after {warm} (min {rates.min():.1f}, max {rates.max():.1f}; "
          f"each step waited for); peak memory allocated "
          f"{peak / 2 ** 20:.1f} MiB; dataset build {build_s:.1f} s on "
          f"the host ({card})")
    dev_f, dev_l = t32._to_device(arrays[0]), t32._to_device(arrays[1])
    idx = batch_index_stream(n_train, batch_size, seed=seed,
                             repeat=True)
    split = _step_split(t32, state, dev_f, dev_l,
                        [next(idx) for _ in range(8)], card)

    if cfg["evaluate"]:
        # (c) the saved weights on the test structures
        for trainer, rel in ((t64, TRAIN_F64_REL), (t32, TRAIN_F32_REL)):
            ev = trainer.evaluate(saved, arrays[2], arrays[3])
            errs = {k: abs(ev[k] - v) / max(abs(v), 1e-300)
                    for k, v in fixture["evaluate"].items()}
            worst = max(errs, key=errs.get)
            print(f"  evaluate {n_test} test structures at "
                  f"{str(trainer.dtype)[6:]}: energy/mae/atom "
                  f"{ev['energy/mae/atom']:.6f} eV, forces/mae "
                  f"{ev['forces/mae']:.6f} eV/A; worst rel err vs the JAX "
                  f"fixture {errs[worst]:.2e} ({worst}; limit {rel:g})")
            if set(ev) != set(errs) or errs[worst] > rel:
                raise AssertionError(f"evaluate disagrees: {errs}")
        _check_resume_and_export(cfg, t32, arrays, params_init, work, ds,
                                 db, TensorAlloyCalculator, save_model)
    return {"launches": launches, "steps": steps, "split": split,
            "structures_per_s": float(np.median(rates)),
            "peak_mib": peak / 2 ** 20, "build_s": build_s}


def _check_resume_and_export(cfg, trainer, arrays, params, work, ds, db,
                             calculator_cls, save_model):
    """(d) checkpoint, restore, two more steps equal two uninterrupted
    steps bit for bit (with deterministic algorithms on: the backward of
    an index gather otherwise adds in no fixed order); export, and the
    calculator serves a test structure with the exported model."""
    from tensoralloy_tpu_torch.train.trainer import TrainParameters
    tp = trainer.train_parameters
    trainer.train_parameters = TrainParameters(
        **{**tp.__dict__, "train_steps": 4})
    torch.use_deterministic_algorithms(True)
    try:
        kept = {}
        straight = trainer.fit(
            arrays[0], arrays[1], params=params, verbose=False,
            callback=lambda s, st, m: kept.update({s + 1: st}))
        path = str(work / "ckpt-2.npz")
        trainer.save_checkpoint(path, kept[2])
        resumed = trainer.fit(arrays[0], arrays[1], verbose=False,
                              initial_state=trainer.restore_state(path))
    finally:
        torch.use_deterministic_algorithms(False)
        trainer.train_parameters = tp
    worst = max(_tree_rel_err(resumed["state"][k], straight["state"][k])
                for k in ("params", "ema_params"))
    print(f"  checkpoint at step 2, restore, 2 more steps vs 4 "
          f"uninterrupted: max difference {worst:.1e}")
    if worst != 0.0 or resumed["state"]["step"] != 4:
        raise AssertionError("resume is not bit for bit")
    exported = str(work / "exported.npz")
    save_model(exported, trainer.model, resumed["state"]["ema_params"])
    calc = calculator_cls(exported, dtype="medium", backend="pallas")
    test_row = int(ds.split_indices(len(db))[1][0])
    structure = db.get(test_row + 1)
    res = calc.calculate(structure)
    bf = trainer._to_device({k: v[:1] for k, v in arrays[2].items()})
    want = trainer.batched_predictions(resumed["state"]["ema_params"], bf)
    err = abs(res["energy"] - float(want["energy"][0])) \
        / abs(float(want["energy"][0]))
    print(f"  exported model serves test structure {test_row + 1} "
          f"({len(structure)} atoms): E {res['energy']:.6f} eV, rel err vs "
          f"the trainer's prediction {err:.2e}")
    if res["forces"].shape != (len(structure), 3) \
            or not np.isfinite(res["forces"]).all() or err > F32_REL:
        raise AssertionError("the exported model is not served right")


def train(card):
    """The training half of the main path: both configurations. ->
    launches of each kernel per train step, and what was measured."""
    phase("train")
    measured, per_step = {}, {}
    with tempfile.TemporaryDirectory() as workdir:
        for name in TRAIN_CONFIGS:
            measured[name] = m = train_path(name, workdir, card)
            for k in TRAIN_CONFIGS[name]["kernels"]:
                per_step[k] = m["launches"][k] // m["steps"]
    return measured, per_step


# ----------------------------------------------------------------------
# manager
# ----------------------------------------------------------------------

def _count_step_launches(trainer, kernels, rows):
    """Have `trainer.train_step` append to `rows` the step it started
    from and the launches of each kernel it made."""
    from tensoralloy_tpu_torch.ops import fused
    step_fn = trainer.train_step

    def counted(state, feats, labels):
        before = dict(fused.launch_counts)
        out = step_fn(state, feats, labels)
        rows.append((int(state["step"]),
                     {k: fused.launch_counts[k] - before[k]
                      for k in kernels}))
        return out

    trainer.train_step = counted


def manager_path(name, workdir, card):
    """One experiment file through the port's experiment path at full
    width. -> launches of each kernel over the path, and what was
    measured."""
    from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
    from tensoralloy_tpu_torch.ops import fused
    from tensoralloy_tpu_torch.train.evaluation import evaluate_run
    from tensoralloy_tpu_torch.train.manager import TrainingManager
    cfg = TRAIN_CONFIGS[name]
    kernels = cfg["kernels"]
    work = Path(workdir) / f"manager_{name}"
    work.mkdir()
    config = experiment_config(cfg["run"], work, {
        f"nn.atomic.{cfg['descriptor']}.backend": "pallas",
        "train.train_steps": MANAGER_STEPS,
        "train.eval_steps": MANAGER_EVAL_STEPS,
        "train.log_steps": MANAGER_EVAL_STEPS,
        "train.summary_steps": 10}, database=TRAIN_DB)
    dump_toml(config, work / "input.toml")
    print(f"  -- manager_{name}: artifacts/{cfg['run']}/input.toml, "
          f"{MANAGER_STEPS} steps, blocks of "
          f"{config['train']['scan_steps']}")
    fused.reset_launch_counts()
    manager = TrainingManager(str(work / "input.toml"))
    trainer = manager.trainer
    devices = {trainer.device.type} | {p.device.type
                                       for p in manager.model.parameters()}
    if devices != {"cuda"} or trainer.dtype != torch.float32:
        raise AssertionError(f"the manager's device is {devices} and its "
                             f"dtype {trainer.dtype}: not cuda, float32")
    step_rows = []
    _count_step_launches(trainer, kernels, step_rows)
    t0 = time.perf_counter()
    feats, _ = manager.dataset.build()
    build_s = time.perf_counter() - t0
    print(f"  dataset: {len(manager.db)} structures featurized on the host "
          f"(native lists, one process, float32, no transpose tables) in "
          f"{build_s:.1f} s ({card})")
    t0 = time.perf_counter()
    result = manager.train_and_evaluate(verbose=False)
    fit_s = time.perf_counter() - t0
    exported = manager.export()
    model_dir = Path(manager.model_dir)
    wanted = ["input.json", "run.pid", f"ckpt-{MANAGER_EVAL_STEPS}.npz",
              "ckpt-best.npz", "best.json", "metrics.jsonl",
              "checkpoint.npz", "history.json", Path(exported).name]
    missing = [f for f in wanted if not (model_dir / f).exists()]
    history = json.loads((model_dir / "history.json").read_text())
    if missing or [h["step"] for h in history] != [MANAGER_EVAL_STEPS] \
            or int(result["state"]["step"]) != MANAGER_STEPS:
        raise AssertionError(f"manager_{name}: files missing {missing}, "
                             f"or history {history} is not one evaluation "
                             f"at step {MANAGER_EVAL_STEPS}")
    bad = [row for row in step_rows if set(row[1].values()) != {1}]
    if len(step_rows) != MANAGER_STEPS or bad:
        raise AssertionError(f"manager_{name}: {len(step_rows)} steps, "
                             f"not one launch of each kernel in {bad}")
    print(f"  train_and_evaluate: {MANAGER_STEPS} steps in {fit_s:.1f} s "
          f"(min/max sweep, one evaluation and the checkpoints included), "
          f"{result['throughput']:.1f} structures/s; one launch of "
          f"{kernels} in each step; files {wanted} ({card})")

    # evaluate_run reads the run's directory again: input.toml, the
    # cached dataset, the newest numbered checkpoint
    report = evaluate_run(str(work), per_group=True, verbose=False)
    overall = report["splits"]["test"]["overall"]
    want = history[0]
    errs = {"energy": abs(overall["energy_meV_per_atom"]
                          - 1000 * want["energy/mae/atom"])
            / (1000 * want["energy/mae/atom"]),
            "forces": abs(overall["force_eV_A"] - want["forces/mae"])
            / want["forces/mae"]}
    print(f"  evaluate_run at step {report['step']}: test overall "
          f"{overall['energy_meV_per_atom']:.3f} meV/atom, "
          f"{overall['force_eV_A']:.4f} eV/A over {overall['n']} structures "
          f"in {len(report['splits']['test']) - 1} groups; rel err vs the "
          f"trainer's evaluation of the same checkpoint "
          f"{json.dumps(errs)}")
    if report["step"] != MANAGER_EVAL_STEPS or overall["n"] != len(
            manager.dataset.split_indices(len(manager.db))[1]) \
            or max(errs.values()) > 1e-6 \
            or not (work / "group_maes.json").exists():
        raise AssertionError(f"manager_{name}: evaluate_run disagrees with "
                             "Trainer.evaluate")

    # the exported model, served
    calc = TensorAlloyCalculator(exported, dtype="medium", backend="pallas")
    test_row = int(manager.dataset.split_indices(len(manager.db))[1][0])
    structure = manager.db.get(test_row + 1)
    res = calc.calculate(structure)
    bf = trainer._to_device(
        {k: v[test_row:test_row + 1] for k, v in feats.items()})
    pred = trainer.batched_predictions(result["state"]["ema_params"], bf)
    err = abs(res["energy"] - float(pred["energy"][0])) \
        / abs(float(pred["energy"][0]))
    print(f"  exported {Path(exported).name} serves test structure "
          f"{test_row + 1} ({len(structure)} atoms): E {res['energy']:.6f} "
          f"eV, rel err vs the trainer's prediction {err:.2e}")
    if res["forces"].shape != (len(structure), 3) \
            or not np.isfinite(res["forces"]).all() or err > F32_REL:
        raise AssertionError("the exported model is not served right")

    # a run cut short: the same directory, more steps asked for
    config["train"]["train_steps"] = MANAGER_RESUMED_STEPS
    dump_toml(config, work / "input.toml")
    again = TrainingManager(str(work / "input.toml"))
    resumed_rows = []
    _count_step_launches(again.trainer, kernels, resumed_rows)
    out = again.train_and_evaluate(verbose=False)
    first = resumed_rows[0][0] if resumed_rows else None
    print(f"  a second train_and_evaluate asked for "
          f"{MANAGER_RESUMED_STEPS} steps: resumed at step {first}, took "
          f"{len(resumed_rows)} steps, ended at {out['state']['step']}")
    if first != MANAGER_EVAL_STEPS or int(out["state"]["step"]) \
            != MANAGER_RESUMED_STEPS or len(resumed_rows) \
            != MANAGER_RESUMED_STEPS - MANAGER_EVAL_STEPS:
        raise AssertionError(f"manager_{name}: the run did not resume "
                             "from its newest checkpoint")
    launches = dict(fused.launch_counts)
    return ({k: launches[k] for k in kernels},
            {"build_s": build_s, "fit_s": fit_s,
             "structures_per_s": result["throughput"]})


def manage(card):
    """The experiment path: both experiment files."""
    phase("manager")
    measured, launches = {}, {}
    with tempfile.TemporaryDirectory() as workdir:
        for name in TRAIN_CONFIGS:
            counts, measured[name] = manager_path(name, workdir, card)
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
    return measured, launches


# ----------------------------------------------------------------------
# eam
# ----------------------------------------------------------------------

def jittered_lattice(kind: str, reps: int, a: float, seed: int = SEED,
                     sigma: float = SIGMA):
    """Periodic fcc or bcc supercell of reps^3 cells, every coordinate
    jittered by N(0, sigma) from a seeded numpy generator.
    -> (positions [n, 3], cell [3, 3])."""
    if kind == "fcc":
        return jittered_fcc(reps, seed, a, sigma)
    grid = np.array([(i, j, k) for i in range(reps) for j in range(reps)
                     for k in range(reps)], dtype=np.float64)
    basis = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
    pos = ((grid[:, None, :] + basis[None]) * a).reshape(-1, 3)
    pos = pos + np.random.default_rng(seed).normal(0.0, sigma, pos.shape)
    return pos, np.eye(3) * a * reps


def _eam_requests(name):
    """The fixture's cell, then the jittered cells of the larger sizes."""
    from tensoralloy_tpu_torch.atoms import Structure
    path, kind, element, a, sizes, fixture = EAM_PATHS[name]
    s, _ = _fixture((fixture, element))
    out = [s]
    for reps in sizes[1:]:
        pos, cell = jittered_lattice(kind, reps, a)
        out.append(Structure.from_symbols([element] * len(pos), pos, cell,
                                          pbc=[True] * 3))
    return out


def _timed_request(calc, s, reps):
    """-> (median request ms, the split as text, median device E/F/S ms):
    host featurize + copy on the host lists, or map + copy and the build
    where the calculator routes the request to the device builder."""
    if calc._use_device_nl(s):
        t_req, t_copy, t_build, t_dev = _device_split(calc, s, reps)
        return (t_req, f"on device lists: map + copy {t_copy:.2f} ms, "
                f"build {t_build:.2f} ms", t_dev)
    vap = calc._get_vap(s)
    t_req = _median_host_ms(lambda: calc.calculate(s), reps)
    t_feat = _median_host_ms(lambda: calc.featurize(s, vap), reps)
    feats = calc.featurize(s, vap)
    efs = calc._get_variant(s)[1]
    t_dev = _median_host_ms(lambda: efs(feats), max(reps, 5))
    return t_req, f"of which host featurize + copy {t_feat:.2f} ms", t_dev


def serve_eam(name, card):
    """One saved EAM-family model through both routes of the calculator
    in float32 on its default device (which must be cuda): the analytic
    EFS on the dense layout (fast_efs=True) and autograd on the flat pair
    layout (fast_efs=False), held against each other on every request;
    both routes in float64 on the fixture's cell against the JAX
    fixture; then each request timed and split."""
    from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
    path, _, _, _, _, fixture = EAM_PATHS[name]
    print(f"  -- {name}: {path.relative_to(ROOT)}")
    routes = {"fast": True, "autograd": False}
    calcs = {r: TensorAlloyCalculator(str(path), dtype="medium",
                                      fast_efs=f) for r, f in routes.items()}
    for route, calc in calcs.items():
        devices = {calc.device.type} | {p.device.type
                                        for p in calc.model.parameters()}
        if devices != {"cuda"}:
            raise AssertionError(f"the default device is {devices}")
        print(f"  {route}: layout {calc.layout}")
    structures = _eam_requests(name)
    for s in structures:
        res = {r: c.calculate(s) for r, c in calcs.items()}
        errs = efs_errors(res["fast"], res["autograd"])
        fsum = float(np.max(np.abs(res["fast"]["forces"].sum(axis=0))))
        fmax = float(np.max(np.abs(res["fast"]["forces"])))
        print(f"  {len(s)} atoms: E {res['fast']['energy']:.6f} eV, "
              f"max|F| {fmax:.4f} eV/A, |sum F| {fsum:.2e}; fast vs "
              f"autograd {json.dumps(errs)}")
        if max(errs.values()) > F32_REL:
            raise AssertionError(f"{name}: the two routes disagree: {errs}")
        if fsum > 1e-5 * fmax * np.sqrt(len(s)):
            raise AssertionError(f"|sum F| = {fsum} is not ~0")
    s, ref = _fixture((fixture, EAM_PATHS[name][2]))
    for route, fast in routes.items():
        calc64 = TensorAlloyCalculator(str(path), dtype="high",
                                       fast_efs=fast)
        errs = efs_errors(calc64.calculate(s), ref)
        print(f"  {len(s)} atoms, float64, {route} vs the JAX fixture: "
              f"{json.dumps(errs)}")
        if max(errs.values()) > F64_REL:
            raise AssertionError(f"{name} {route} disagrees with the JAX "
                                 "fixture")
    times = {}
    for s in structures:
        reps = 5 if len(s) < 10000 else 3
        for route, calc in calcs.items():
            t_req, split, t_dev = _timed_request(calc, s, reps)
            times[(route, len(s))] = (t_req, t_dev)
            print(f"  {name} {route} request {len(s)} atoms: {t_req:.2f} ms, "
                  f"{split}, device E/F/S {t_dev:.2f} ms (medians of "
                  f"{reps}; {card})")
    return times


def _record_steps(trainer, rows):
    """Have `trainer.train_step` append (step, seconds with the device
    waited for, metrics) to `rows`."""
    step_fn = trainer.train_step

    def recorded(state, feats, labels):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(state, feats, labels)
        torch.cuda.synchronize()
        rows.append((int(state["step"]), time.perf_counter() - t0,
                     {k: float(v) for k, v in out[1].items()}))
        return out

    trainer.train_step = recorded


def _eam_step_split(manager, params, card):
    """The split of a train step's loss and gradient: the energy and
    force terms of one batch, then each constraint alone; medians of 3,
    the device waited for."""
    from tensoralloy_tpu_torch.utils import tree_flatten, tree_unflatten
    trainer = manager.trainer
    feats, labels = manager.dataset.build()
    bs = trainer.train_parameters.batch_size
    bf = trainer._to_device({k: v[:bs] for k, v in feats.items()})
    bl = trainer._to_device({k: v[:bs] for k, v in labels.items()})
    constraints, trainer.constraints = trainer.constraints, []
    try:
        parts = {"energy + forces": _median_host_ms(
            lambda: trainer.loss_and_grads(params, bf, bl, 0), 3)}
    finally:
        trainer.constraints = constraints
    flat = tree_flatten(params)
    for c in constraints:
        def loss_and_grad(c=c):
            leaves = {k: v.detach().requires_grad_() for k, v in flat.items()}
            with torch.enable_grad():
                torch.autograd.grad(c.loss(tree_unflatten(leaves)),
                                    list(leaves.values()), allow_unused=True)
        parts[c.name] = _median_host_ms(loss_and_grad, 3)
    print("  a step's loss + gradient, split: " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in parts.items())
        + f" (medians of 3, the device waited for; {card})")


def manager_eam(name, workdir, card):
    """An EAM/ADP experiment file at full width, cut to MANAGER_STEPS
    steps, with its 'rose' and 'elastic' constraints: TrainingManager ->
    train_and_evaluate -> export (.npz and setfl) -> evaluate_run -> the
    exported model served, then a second run that resumes at the newest
    checkpoint, held bit for bit against a run of as many steps made in
    one go (under torch.use_deterministic_algorithms)."""
    from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
    from tensoralloy_tpu_torch.io.lammps import read_eam_alloy_setfl
    from tensoralloy_tpu_torch.train.evaluation import evaluate_run
    from tensoralloy_tpu_torch.train.manager import TrainingManager
    from tensoralloy_tpu_torch.utils import tree_flatten
    work = Path(workdir) / f"eam_{name}"
    work.mkdir()
    overrides = {"train.train_steps": MANAGER_STEPS,
                 "train.eval_steps": MANAGER_EVAL_STEPS,
                 "train.log_steps": MANAGER_EVAL_STEPS,
                 "train.summary_steps": 10}
    config = experiment_config(name, work, overrides)
    dump_toml(config, work / "input.toml")
    manager = TrainingManager(str(work / "input.toml"))
    trainer = manager.trainer
    names = [c.name for c in manager.constraints]
    print(f"  -- manager {name}: artifacts/{name}/input.toml "
          f"({config['pair_style']}), {MANAGER_STEPS} steps, batch "
          f"{config['train']['batch_size']}, constraints {names}")
    if trainer.device.type != "cuda" or trainer.dtype != torch.float32 \
            or sorted(names) != ["elastic", "rose"]:
        raise AssertionError(f"{name}: device {trainer.device}, dtype "
                             f"{trainer.dtype}, constraints {names}")
    t0 = time.perf_counter()
    manager.dataset.build()
    build_s = time.perf_counter() - t0
    print(f"  dataset: {len(manager.db)} structures, flat pair layout "
          f"(nij_max {manager.dataset.nij_max}), featurized on the host in "
          f"{build_s:.1f} s ({card})")
    rows = []
    _record_steps(trainer, rows)
    t0 = time.perf_counter()
    result = manager.train_and_evaluate(verbose=False)
    fit_s = time.perf_counter() - t0
    exported = Path(manager.export())
    style = manager.pair_style.model
    setfl = exported.with_name(exported.stem + (
        ".adp" if style == "adp" else f".{style}.eam"))
    table = read_eam_alloy_setfl(str(setfl), is_adp=style == "adp")
    if len(rows) != MANAGER_STEPS or not exported.exists() \
            or not all(np.isfinite(r[2]["loss/total"]) for r in rows):
        raise AssertionError(f"{name}: {len(rows)} steps, exported "
                             f"{exported}")
    step_ms = float(np.median([r[1] for r in rows[2:]])) * 1e3
    first, last = rows[0][2], rows[-1][2]
    terms = ("loss/total", "loss/energy", "loss/forces", "loss/rose",
             "loss/elastic")
    print(f"  train_and_evaluate: {MANAGER_STEPS} steps in {fit_s:.1f} s "
          f"(one evaluation, the checkpoints included), "
          f"{result['throughput']:.1f} structures/s; a step {step_ms:.1f} "
          f"ms (median, the device waited for; {card})")
    print("  losses at the first and the last step: " + ", ".join(
        f"{k[5:]} {first[k]:.6g} -> {last[k]:.6g}" for k in terms))
    _eam_step_split(manager, result["state"]["params"], card)
    print(f"  exported {exported.name} and {setfl.name} "
          f"({table.nr} r x {table.nrho} rho points, elements "
          f"{table.elements})")

    report = evaluate_run(str(work), per_group=True, verbose=False)
    history = json.loads((Path(manager.model_dir)
                          / "history.json").read_text())
    overall = report["splits"]["test"]["overall"]
    err = abs(overall["energy_meV_per_atom"]
              - 1000 * history[0]["energy/mae/atom"]) \
        / (1000 * history[0]["energy/mae/atom"])
    print(f"  evaluate_run at step {report['step']}: test overall "
          f"{overall['energy_meV_per_atom']:.3f} meV/atom, "
          f"{overall['force_eV_A']:.4f} eV/A over {overall['n']} "
          f"structures; rel err vs the trainer's evaluation {err:.2e}")
    if report["step"] != MANAGER_EVAL_STEPS or err > 1e-6:
        raise AssertionError(f"{name}: evaluate_run disagrees")

    calc = TensorAlloyCalculator(str(exported), dtype="medium")
    feats, _ = manager.dataset.build()
    test_row = int(manager.dataset.split_indices(len(manager.db))[1][0])
    structure = manager.db.get(test_row + 1)
    res = calc.calculate(structure)
    pred = trainer.batched_predictions(
        result["state"]["ema_params"], trainer._to_device(
            {k: v[test_row:test_row + 1] for k, v in feats.items()}))
    err = abs(res["energy"] - float(pred["energy"][0])) \
        / abs(float(pred["energy"][0]))
    print(f"  the exported model serves test structure {test_row + 1} "
          f"({len(structure)} atoms, fast EFS): E {res['energy']:.6f} eV, "
          f"rel err vs the trainer's prediction {err:.2e}")
    if err > F32_REL or not np.isfinite(res["forces"]).all():
        raise AssertionError(f"{name}: the exported model is not served "
                             "right")

    # a run cut short resumes at its newest checkpoint and ends where a
    # run of as many steps made in one go ends
    config["train"]["train_steps"] = MANAGER_RESUMED_STEPS
    dump_toml(config, work / "input.toml")
    again = TrainingManager(str(work / "input.toml"))
    resumed = []
    _record_steps(again.trainer, resumed)
    out = again.train_and_evaluate(verbose=False)
    straight_cfg = experiment_config(name, work, {
        **overrides, "train.train_steps": MANAGER_RESUMED_STEPS,
        "train.model_dir": str(work / "straight")})
    straight = TrainingManager(straight_cfg).train_and_evaluate(
        verbose=False)
    a = tree_flatten(out["state"]["params"])
    b = tree_flatten(straight["state"]["params"])
    same = all(torch.equal(a[k], b[k]) for k in b)
    print(f"  resumed at step {resumed[0][0] if resumed else None}, "
          f"{len(resumed)} steps to {out['state']['step']}; bit for bit "
          f"the run made in one go: {same} (deterministic algorithms on)")
    if not resumed or resumed[0][0] != MANAGER_EVAL_STEPS or not same:
        raise AssertionError(f"{name}: the run did not resume exactly")
    return {"build_s": build_s, "fit_s": fit_s, "step_ms": step_ms,
            "structures_per_s": result["throughput"]}


def eam(card):
    """The EAM family: both saved models served through both routes, and
    both experiment files through the manager. No descriptor kernel lies
    on this path: the launch counts are reset before it and must read 0
    after it."""
    from tensoralloy_tpu_torch.ops import fused
    phase("eam")
    t0 = time.perf_counter()
    fused.reset_launch_counts()
    served = {name: serve_eam(name, card) for name in EAM_PATHS}
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as workdir:
            managed = {name: manager_eam(name, workdir, card)
                       for name in EAM_PATHS}
    finally:
        torch.use_deterministic_algorithms(deterministic)
    launches = {k: v for k, v in fused.launch_counts.items() if v}
    print(f"  descriptor kernel launches over the eam phase: "
          f"{launches or 0} (none on this path)")
    if launches:
        raise AssertionError("the EAM path launched a descriptor kernel")
    print(f"  eam phase {time.perf_counter() - t0:.1f} s")
    return served, managed


# ----------------------------------------------------------------------
# large: the device neighbor list, chunked requests and the Hessian
# ----------------------------------------------------------------------

# (name, model, lattice, element, a, repeats, calculator options, the
# kernel every request launches or None): requests that "auto" sends
# through the device builder
DEVICE_NL_REQUESTS = (
    ("grap 32000", PATHS["grap"][0], "fcc", "Ni", LATTICE, 20,
     dict(backend="pallas"), "grap"),
    ("eam Ni 32000 fast", EAM_PATHS["mleam_ni"][0], "fcc", "Ni", 3.52, 20,
     {}, None),
    ("adp Mo 31250 fast", EAM_PATHS["mladp_mo_v5"][0], "bcc", "Mo", 3.16,
     25, {}, None),
    ("eam Ni 32000 flat", EAM_PATHS["mleam_ni"][0], "fcc", "Ni", 3.52, 20,
     dict(fast_efs=False), None),
)
CHUNK_ROWS = 4096          # chunk_size of the chunked requests
HESSIAN_MODELS = {"mleam_ni": EAM_PATHS["mleam_ni"][0],
                  "snap_ni_sfa": PATHS["sf"][0]}


def _lattice_structure(kind, element, a, reps):
    from tensoralloy_tpu_torch.atoms import Structure
    pos, cell = jittered_lattice(kind, reps, a)
    return Structure.from_symbols([element] * len(pos), pos, cell,
                                  pbc=[True] * 3)


def _check_request(name, res, ref):
    """E/F/S of `res` against `ref` to F32_REL, and |sum F| ~ 0."""
    errs = efs_errors(res, ref)
    fsum = float(np.max(np.abs(res["forces"].sum(axis=0))))
    fmax = float(np.max(np.abs(res["forces"])))
    print(f"  {name}: E {res['energy']:.6f} eV, max|F| {fmax:.4f} eV/A, "
          f"|sum F| {fsum:.2e}; vs the host lists in one piece "
          f"{json.dumps(errs)}")
    if max(errs.values()) > F32_REL:
        raise AssertionError(f"{name}: disagrees with the host route: "
                             f"{errs}")
    if fsum > 1e-5 * fmax * np.sqrt(len(res["forces"])):
        raise AssertionError(f"{name}: |sum F| = {fsum} is not ~0")


def _device_split(calc, s, reps):
    """-> medians (ms) of the request, of mapping and copying the
    positions, of the build (diagnostics read) and of the E/F/S."""
    from tensoralloy_tpu_torch.transform.device_nl import diag_to_host
    vap = calc._get_vap(s)
    efs = calc._get_variant(s, True)[1]
    b = calc.device_builder(s, vap)

    def copy():
        return (torch.as_tensor(vap.map_positions(s.positions),
                                dtype=calc.dtype, device=calc.device),
                torch.as_tensor(s.cell, dtype=calc.dtype,
                                device=calc.device))

    pos, cell = copy()

    def build():
        feats, diag = b.build(pos, cell)
        b.check(diag_to_host(diag))
        return feats

    feats = build()
    return (_median_host_ms(lambda: calc.calculate(s), reps),
            _median_host_ms(copy, reps), _median_host_ms(build, reps),
            _median_host_ms(lambda: efs(feats), reps))


def device_nl_requests(card):
    """Each request through the default calculator ("auto"): it must take
    the device builder (one cached builder; the flat route also the
    chunked variant) and hold the same model on the host lists in one
    piece."""
    from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
    from tensoralloy_tpu_torch.ops import fused
    out = {}
    for name, path, kind, element, a, reps, opts, kernel \
            in DEVICE_NL_REQUESTS:
        s = _lattice_structure(kind, element, a, reps)
        calc = TensorAlloyCalculator(str(path), dtype="medium", **opts)
        host = TensorAlloyCalculator(str(path), dtype="medium",
                                     device_nl=False, chunked=False, **opts)
        before = dict(fused.launch_counts)
        res = calc.calculate(s)
        if kernel is not None and \
                fused.launch_counts[kernel] != before[kernel] + 1:
            raise AssertionError(f"{name}: {kernel} not launched once")
        if len(calc._nl_cache) != 1:
            raise AssertionError(f"{name}: 'auto' did not take the device "
                                 "builder")
        chunked = "atomic_energies" not in res
        if chunked != (calc.layout == "segment"):
            raise AssertionError(f"{name}: chunked route {chunked} "
                                 f"for layout {calc.layout}")
        _check_request(name, res, host.calculate(s))
        (b,) = calc._nl_cache.values()
        t = _device_split(calc, s, 3)
        if kernel is not None:
            print(f"  {name}: {kernel}_kernel launches a request: 1")
        print(f"  {name} ({len(s)} atoms, builder grid {b.grid}, "
              f"nnl_cap {b.nnl_cap}, cell_cap {b.cell_cap}, layout "
              f"{b.layout}{', chunked' if chunked else ''}): request "
              f"{t[0]:.2f} ms, of which map + copy {t[1]:.2f} ms, build "
              f"{t[2]:.2f} ms, E/F/S {t[3]:.2f} ms (medians of 3); host "
              f"lists: request {_median_host_ms(lambda: host.calculate(s), 3):.2f}"
              f" ms ({card})")
        out[name] = t
    # an angular model with device_nl=True: triples built on the card
    s = _structure(REQUEST_REPS[1])
    calc = TensorAlloyCalculator(str(PATHS["sf"][0]), dtype="medium",
                                 backend="pallas", device_nl=True)
    host = TensorAlloyCalculator(str(PATHS["sf"][0]), dtype="medium",
                                 backend="pallas", device_nl=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = dict(fused.launch_counts)
    res = calc.calculate(s)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    if any(fused.launch_counts[k] != before[k] + 1 for k in ("g2", "g4")):
        raise AssertionError("sf device_nl: g2/g4 not launched once")
    _check_request("sf 4000 device_nl=True", res, host.calculate(s))
    (b,) = calc._nl_cache.values()
    t = _device_split(calc, s, 3)
    print(f"  sf 4000 device_nl=True (exact census, nnl_cap {b.nnl_cap}, "
          f"ntl_cap {b.ntl_cap}): request {t[0]:.2f} ms, map + copy "
          f"{t[1]:.2f} ms, build {t[2]:.2f} ms, E/F/S {t[3]:.2f} ms; peak "
          f"memory allocated {peak:.1f} MiB ({card})")
    out["sf 4000 device_nl"] = t
    return out


def chunked_requests(card):
    """SF and GRAP 32000 with chunked=True, chunk_size=CHUNK_ROWS, against
    the monolithic route; each block launches its kernels twice (the
    forward, and the recomputation in the backward)."""
    from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
    from tensoralloy_tpu_torch.ops import fused
    s = _structure(TIMED_REPS)
    for name in ("sf", "grap"):
        model, kernels, _ = PATHS[name]
        calc = TensorAlloyCalculator(str(model), dtype="medium",
                                     backend="pallas", chunked=True,
                                     chunk_size=CHUNK_ROWS)
        mono = TensorAlloyCalculator(str(model), dtype="medium",
                                     backend="pallas", chunked=False)
        before = dict(fused.launch_counts)
        t0 = time.perf_counter()
        res = calc.calculate(s)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        blocks = -(-calc._get_vap(s).n_atoms_vap // CHUNK_ROWS)
        counts = {k: fused.launch_counts[k] - before[k] for k in kernels}
        print(f"  {name} 32000 chunked ({blocks} blocks of {CHUNK_ROWS} "
              f"rows, {'device' if calc._nl_cache else 'host'} lists): "
              f"launches a request {counts} (2 a block), request "
              f"{ms:.1f} ms ({card})")
        if any(v != 2 * blocks for v in counts.values()):
            raise AssertionError(f"{name} chunked: launches {counts}, "
                                 f"expected {2 * blocks} each")
        if "atomic_energies" in res:
            raise AssertionError(f"{name}: chunked=True served monolithic")
        _check_request(f"{name} 32000 chunked", res, mono.calculate(s))


def hessians(card):
    """get_hessian of the 108-atom Ni cell at float64 against the JAX
    fixtures (1e-10), and symmetric."""
    from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
    for name, path in HESSIAN_MODELS.items():
        ref = json.loads((DATA / f"torch_port_ref_hessian_{name}.json")
                         .read_text())
        s, _ = _fixture((DATA / f"torch_port_ref_hessian_{name}.json",
                         "Ni"))
        calc = TensorAlloyCalculator(str(path), dtype="high",
                                     backend="pallas" if name ==
                                     "snap_ni_sfa" else None)
        t0 = time.perf_counter()
        h = calc.get_hessian(s)
        ms = (time.perf_counter() - t0) * 1e3
        err = rel_err(h, ref["hessian"])
        asym = float(np.max(np.abs(h - h.T)) / np.max(np.abs(h)))
        print(f"  hessian {name} {h.shape}: vs the JAX fixture {err:.2e}, "
              f"asymmetry {asym:.2e}, {ms:.0f} ms ({card})")
        if err > F64_REL or asym > F64_REL:
            raise AssertionError(f"hessian {name}: {err}, {asym}")


def large(card):
    """The device-list, chunked and Hessian routes on the default device
    (cuda). -> their launches by kernel."""
    from tensoralloy_tpu_torch.ops import fused
    phase("large")
    t0 = time.perf_counter()
    fused.reset_launch_counts()
    times = device_nl_requests(card)
    chunked_requests(card)
    hessians(card)
    launches = dict(fused.launch_counts)
    print(f"  launches over the large phase: {launches}")
    for k in ("g2", "g4", "grap"):
        if not launches[k]:
            raise AssertionError(f"the large phase launched no {k}")
    print(f"  large phase {time.perf_counter() - t0:.1f} s")
    return times, launches


# ----------------------------------------------------------------------
# md: the dynamics
# ----------------------------------------------------------------------

MD_NVE_MODEL = EAM_PATHS["mleam_ni"][0]
MD_FIXTURE_RUN = dict(timestep=1.0, chunk_size=5, temperature=400.0, seed=5)
NVE_DRIFT_LIMIT = 0.5       # meV/atom, tests/test_dynamics.py
MD_MO_REPS = 13             # bcc Mo 13^3: 4394 atoms


def _timed_run(md, steps, label, card, **kw):
    """Run `md`, timing each chunk end's read-back; print steps/s,
    atom-steps/s, the sync time and the regrows. -> history."""
    syncs = []
    record = md._record

    def timed(*args):
        t0 = time.perf_counter()
        record(*args)
        syncs.append(time.perf_counter() - t0)

    md._record = timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = md.run(steps, **kw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    md._record = record
    n = len(md.structure)
    print(f"  {label}: {steps} steps of {n} atoms in {sec:.2f} s, "
          f"{steps / sec:.1f} steps/s, {steps * n / sec:.3e} atom-steps/s; "
          f"chunk-end sync {1e3 * sum(syncs):.1f} ms over {len(syncs)} "
          f"chunks; regrows {md.regrows} ({card})")
    return hist


def md_fixtures(card):
    """(a) float64 NVE of the saved mleam_ni model on the 32-atom cell,
    both EFS routes on both lists, against the JAX fixtures."""
    from tensoralloy_tpu_torch.atoms import Structure
    from tensoralloy_tpu_torch.dynamics import VelocityVerlet
    from tensoralloy_tpu_torch.io.model import load_model
    for route in ("fast", "autograd"):
        for device_nl in (False, True):
            path = DATA / (f"torch_port_ref_md_{route}_"
                           f"{'device' if device_nl else 'host'}.json")
            ref = json.loads(path.read_text())
            model, _ = load_model(str(MD_NVE_MODEL), dtype="high")
            s = Structure.from_symbols(
                ["Ni"] * len(ref["positions0"]), ref["positions0"],
                ref["cell"], pbc=[True] * 3)
            md = VelocityVerlet(model, s, fast_efs=route == "fast",
                                device_nl=device_nl, **MD_FIXTURE_RUN)
            hist = _timed_run(md, ref["steps"],
                              f"float64 NVE {route} "
                              f"{'device' if device_nl else 'host'} lists",
                              card, record_trajectory=True)
            dpos = float(np.max(np.abs(np.asarray(hist["positions"])
                                       - np.asarray(ref["positions"]))))
            dtot = rel_err(hist["total"], ref["total"])
            print(f"    vs the JAX fixture: positions {dpos:.2e} A, "
                  f"totals {dtot:.2e}")
            if dpos > 1e-9 or dtot > 1e-10:
                raise AssertionError(f"md {route} {device_nl}: {dpos}, "
                                     f"{dtot}")


def md_nve_flux(card):
    """(b) float32 NVE of EAM Ni 4000 on device lists with the heat flux
    recorded: the drift of the total, and the analytic flux against the
    autograd flux at the last state."""
    from tensoralloy_tpu_torch.analysis.heatflux import make_heat_flux_fn
    from tensoralloy_tpu_torch.dynamics import VelocityVerlet
    from tensoralloy_tpu_torch.io.model import load_model
    from tensoralloy_tpu_torch.nn.eam.fast_efs import make_fast_heat_flux_fn
    from tensoralloy_tpu_torch.transform.device_nl import DeviceNeighborList
    model, _ = load_model(str(MD_NVE_MODEL), dtype="medium")
    s = _structure(REQUEST_REPS[1])
    md = VelocityVerlet(model, s, timestep=1.0, temperature=300.0, seed=3,
                        device_nl=True, record_heat_flux=True)
    hist = _timed_run(md, 200, "float32 NVE eam Ni 4000, device lists, "
                      "heat flux", card)
    tot = np.asarray(hist["total"])
    drift = abs(tot[-1] - tot[0]) / len(s) * 1e3
    print(f"    drift of the total energy {drift:.4f} meV/atom over 200 fs "
          f"(limit {NVE_DRIFT_LIMIT}); T {hist['temperature'][-1]:.1f} K")
    if not drift < NVE_DRIFT_LIMIT:
        raise AssertionError(f"NVE drift {drift} meV/atom")
    if not np.all(np.isfinite(hist["heat_flux"])):
        raise AssertionError("non-finite heat flux")
    b = DeviceNeighborList(md.fz, md.vap, md.structure, layout="both")
    pos = md._tensor(md.vap.map_positions(md.structure.positions))
    feats, diag = b.build(pos, md._tensor(md.structure.cell))
    b.check(diag)
    vel = md._tensor(md.velocities_vap)
    fast = make_fast_heat_flux_fn(md.model)(feats, vel, md._masses[:, 0])
    auto = make_heat_flux_fn(md.model)(feats, vel, md._masses[:, 0])
    err = rel_err(fast["J"].cpu().numpy(), auto["J"].cpu().numpy())
    print(f"    flux at the last state: analytic {fast['J'].tolist()}, "
          f"autograd vs analytic {err:.2e}")
    if err > F32_REL:
        raise AssertionError(f"the two heat fluxes disagree: {err}")


def md_grap(card):
    """(c) GRAP MD at 4000 atoms on device lists: grap_kernel once a step
    and once at each chunk's start and end."""
    from tensoralloy_tpu_torch.dynamics import VelocityVerlet
    from tensoralloy_tpu_torch.io.model import load_model
    from tensoralloy_tpu_torch.ops import fused
    model, _ = load_model(str(PATHS["grap"][0]), dtype="medium",
                          backend="pallas")
    s = _structure(REQUEST_REPS[1])
    md = VelocityVerlet(model, s, timestep=1.0, temperature=300.0, seed=4,
                        chunk_size=25, device_nl=True)
    steps = 50
    before = fused.launch_counts["grap"]
    hist = _timed_run(md, steps, "float32 NVE grap Ni 4000, device lists",
                      card)
    launched = fused.launch_counts["grap"] - before
    # a chunk: the start's forces, one evaluation a step, the end's
    # observables; a chunk run again after a regrow counts again
    chunks = steps // md.chunk_size + md.regrows
    want = chunks * (md.chunk_size + 2)
    print(f"    grap_kernel launches {launched} ({chunks} chunks x "
          f"({md.chunk_size} steps + 2) = {want}); T "
          f"{hist['temperature'][-1]:.1f} K")
    if launched != want or not np.all(np.isfinite(hist["total"])):
        raise AssertionError(f"grap MD launched {launched}, expected {want}")


def md_thermostats(card):
    """(d) BAOAB NVT and Berendsen NPT, 100 steps each, of ADP Mo
    (MD_MO_REPS^3 cells) on device lists."""
    from tensoralloy_tpu_torch.dynamics import VelocityVerlet
    from tensoralloy_tpu_torch.io.model import load_model
    path = EAM_PATHS["mladp_mo_v5"][0]
    model, _ = load_model(str(path), dtype="medium")
    s = _lattice_structure("bcc", "Mo", 3.16, MD_MO_REPS)
    for label, kw in (("NVT", {}), ("NPT", dict(target_pressure=0.0,
                                                pressure_tau=200.0))):
        md = VelocityVerlet(model, s, timestep=1.0, temperature=300.0,
                            seed=6, target_temperature=300.0, friction=0.01,
                            device_nl=True, **kw)
        hist = _timed_run(md, 100, f"float32 {label} adp Mo {len(s)}",
                          card)
        extra = (f", P {hist['pressure'][-1]:.3f} GPa, V "
                 f"{hist['volume'][0]:.1f} -> {hist['volume'][-1]:.1f} A^3"
                 if "pressure" in hist else "")
        print(f"    T {hist['temperature'][0]:.1f} -> "
              f"{hist['temperature'][-1]:.1f} K{extra}")
        if not np.all(np.isfinite(hist["total"])):
            raise AssertionError(f"{label}: non-finite energies")


def md(card):
    """The dynamics on the default device (cuda). -> launches by kernel."""
    from tensoralloy_tpu_torch.ops import fused
    phase("md")
    t0 = time.perf_counter()
    fused.reset_launch_counts()
    md_fixtures(card)
    md_nve_flux(card)
    md_grap(card)
    md_thermostats(card)
    launches = dict(fused.launch_counts)
    print(f"  launches over the md phase: {launches}")
    if not launches["grap"]:
        raise AssertionError("the md phase launched no grap_kernel")
    print(f"  md phase {time.perf_counter() - t0:.1f} s")
    return launches


# ----------------------------------------------------------------------
# analysis
# ----------------------------------------------------------------------

# (a) elastic constants and EOS of the SF model: the relaxation's start
# (fcc Ni, 4 atoms), the EOS's linear scales of the relaxed cell
ELASTIC_A = 3.50
EOS_SCALES = np.linspace(0.97, 1.03, 7)
# (b) phonons and QHA of the EAM model on the fcc primitive cell
PHONON_A = 3.52
PHONON_SUPERCELL = (3, 3, 3)
QHA_SCALES = np.linspace(0.99, 1.02, 5)
QHA_TEMPERATURES = [0.0, 300.0, 600.0]
QHA_QMESH = (4, 4, 4)
Q_POINTS = {"X": [0.5, 0.0, 0.5], "L": [0.5, 0.5, 0.5]}
GAMMA_ACOUSTIC_THZ = 0.05
# The QHA's F(V) fits stop at scipy's least_squares tolerances (a step of
# 1e-8 of the parameters): fits of inputs equal to round-off may stop an
# iteration apart, so the fitted outputs are held to these limits and the
# fits' inputs, E(V) and F_vib(V, T), to ANALYSIS_F64_REL
QHA_REL = {"volume": 1e-6, "a_scale": 1e-6, "free_energy": 1e-6,
           "bulk_modulus": 1e-5, "alpha": 1e-4, "T": 0.0}
ANALYSIS_F64_REL = 1e-8
ELASTIC_F64_REL = 1e-6
ELASTIC_F32_REL = 1e-3
# (c) vacancy kinetics of the EAM model
KINETICS_RUN = dict(supercell=(3, 3, 3), temperatures=(600.0, 900.0, 1200.0))
KINETICS_KEYS = ("formation_energy", "migration_energy", "nu_star_thz",
                 "jump_distance", "jump_rate_hz", "d_vacancy_m2_s")
KINETICS_REL = 1e-6
# (d) the GRAP band: fcc Ni 4x4x4 less one site, images, FIRE depth
NEB_REPS, NEB_IMAGES, NEB_STEPS, NEB_CHUNK = 4, 7, 100, 25
NEB_F32_REL = 1e-4
# (e) the committees: members of one architecture, and their cells
MONI_MEMBERS = [MODELS / run / "model" / "snap_MoNi.npz" for run in (
    "snap_moni", "snap_moni_readapt", "snap_moni_ref11", "snap_moni_v2",
    "snap_moni_v3")]
MO_SF_MEMBERS = [MODELS / run / "model" / name for run, name in (
    ("snap_mo_ref11", "snap_Mo_refsf.npz"),
    ("snap_mo_refsf_cont", "snap_Mo_refsf.npz"),
    ("snap_mo_refsf_cpu", "snap_Mo_refsf.npz"),
    ("snap_mo_refsf_f15", "snap_Mo_refsf.npz"),
    ("snap_mo_refsf_l2", "snap_Mo_refsf.npz"),
    ("snap_mo_refsf_rrmse", "snap_Mo_refsf.npz"),
    ("snap_mo_refsf_s30", "snap_Mo_refsf.npz"),
    ("snap_mo_y15", "snap_Mo_y15.npz"))]
SELECT_FRAMES = 8
# (f) the linear model: its basis, the data, and the ridge strength whose
# normal matrix is well conditioned (4.9e6 on these rows; 4.9e12 at the
# default 1e-8, where rows equal to round-off give coefficients 1e-4 apart)
LINEAR_STRUCTURES = 50
LINEAR_ALPHA = 1e-2
LINEAR_REL = 1e-8
# (g) Frenkel-Ladd at cut depth, and the Einstein -> Einstein oracle
TI_RUN = dict(n_lambda=4, equil_steps=200, prod_steps=400, timestep=2.0,
              sample=10, seed=1)
# (108 atoms; BAOAB samples a harmonic crystal's positions exactly at
# any stable step, and a light friction decorrelates the samples, 100 fs
# apart: over ten seeds the integral lands within 2.5 % of its closed
# form, mean +0.9 %)
EINSTEIN_RUN = dict(n_lambda=4, equil_steps=50, prod_steps=250,
                    timestep=10.0, friction=0.05, sample=10, seed=3,
                    com_correction=False)
EINSTEIN_K = (1.5, 6.0)
# (h) surface energies and the intrinsic stacking fault
SURFACE_RUN = dict(layers=6, relax=True, steps=60)
EV_A3_TO_GPA = 160.21766208


def port_analysis():
    """The port's analysis modules, as the workflows below take them."""
    from types import SimpleNamespace
    from tensoralloy_tpu_torch.analysis import (elastic, eos, kinetics,
                                                phonon, surface)
    return SimpleNamespace(elastic=elastic, eos=eos, phonon=phonon,
                           surface=surface, kinetics=kinetics)


def fcc_conventional(cls, a: float):
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]]) * a
    return cls.from_symbols(["Ni"] * 4, base, np.eye(3) * a, pbc=[True] * 3)


def fcc_primitive(cls, a: float):
    cell = 0.5 * a * np.array([[0.0, 1.0, 1.0], [1.0, 0.0, 1.0],
                               [1.0, 1.0, 0.0]])
    return cls.from_symbols(["Ni"], [[0.0, 0.0, 0.0]], cell, pbc=[True] * 3)


def elastic_workflow(calc, analysis, structure):
    """relax_cell -> fit_elastic_tensor -> EOS over EOS_SCALES of the
    relaxed cell (with either package's modules in `analysis`)."""
    el = analysis.elastic
    relaxed = el.relax_cell(calc, structure, fmax=1e-4, smax=1e-4,
                            steps=400)
    c, info = el.fit_elastic_tensor(calc, relaxed)
    vols, ens = [], []
    for sc in EOS_SCALES:
        s = relaxed.copy()
        s.cell = s.cell * sc
        s.positions = s.positions * sc
        vols.append(s.volume)
        ens.append(float(calc.get_potential_energy(s)))
    v0, e0, b0 = analysis.eos.EquationOfState(vols, ens).fit()
    return {"a0": float(np.linalg.norm(relaxed.cell[0])),
            "cij": info["cij"], "bulk_modulus_voigt":
                el.bulk_modulus_voigt(c),
            "eos": {"v0": v0, "e0": e0, "b0": b0}, "eos_energies": ens}


def qha_inputs(calc, analysis, primitive, temperatures, supercell, qmesh):
    """[n_scales, 1 + n_T]: E(V) and F_vib(V, T) at each of QHA_SCALES,
    what `quasi_harmonic` fits (computed again by its own steps)."""
    rows = []
    for sc in QHA_SCALES:
        s = primitive.copy()
        s.cell = s.cell * sc
        s.positions = s.positions * sc
        th = analysis.phonon.PhononCalculator(
            calc, s, supercell=supercell).thermal_properties(
                temperatures, qmesh=qmesh)
        rows.append([float(calc.get_potential_energy(s))]
                    + list(th["free_energy"]))
    return np.asarray(rows)


def phonon_workflow(calc, analysis, primitive):
    """Frequencies at G, X and L of the PHONON_SUPERCELL, the QHA and its
    inputs."""
    ph = analysis.phonon.PhononCalculator(calc, primitive,
                                          supercell=PHONON_SUPERCELL)
    out = {"gamma": ph.gamma_frequencies().tolist()}
    for k, q in Q_POINTS.items():
        out[k] = ph.frequencies(np.array(q)).tolist()
    qha = analysis.phonon.quasi_harmonic(
        calc, primitive, QHA_TEMPERATURES, scales=QHA_SCALES,
        supercell=PHONON_SUPERCELL, qmesh=QHA_QMESH)
    out["qha"] = {k: np.asarray(v).tolist() for k, v in qha.items()}
    out["qha_inputs"] = qha_inputs(calc, analysis, primitive,
                                   QHA_TEMPERATURES, PHONON_SUPERCELL,
                                   QHA_QMESH).tolist()
    return out


def kinetics_workflow(calc, analysis, bulk):
    out = analysis.kinetics.vacancy_diffusivity(calc, bulk, **KINETICS_RUN)
    res = {k: np.asarray(out[k]).tolist() for k in KINETICS_KEYS}
    res["barrier"] = out["neb"]["barrier"]
    res["neb_steps"] = out["neb"]["n_steps"]
    return res


def surface_workflow(calc, analysis, bulk):
    """(111) and (100) surface energies and the (111) intrinsic stacking
    fault."""
    out = {}
    for hkl in ((1, 1, 1), (1, 0, 0)):
        r = analysis.surface.surface_energy(calc, bulk, hkl, **SURFACE_RUN)
        out["".join(map(str, hkl))] = {k: r[k] for k in (
            "gamma_j_m2", "relaxation_ev")}
    isf = analysis.surface.stacking_fault_energy(
        calc, bulk, (1, 1, 1), (1 / 3, 1 / 3), **SURFACE_RUN)
    out["isf_mj_m2"] = isf["gamma_mj_m2"]
    return out


def _analysis_fixture():
    return json.loads((DATA / "torch_port_ref_analysis.json").read_text())


def _flat_rel(got, want) -> float:
    """rel_err over the numbers of two equal-shaped JSON-like records."""
    def flat(x):
        if isinstance(x, dict):
            return [v for k in sorted(x) for v in flat(x[k])]
        return list(np.ravel(np.asarray(x, np.float64)))
    return rel_err(flat(got), flat(want))


def _launched(before, kernels=("g2", "g4", "grap")):
    from tensoralloy_tpu_torch.ops import fused
    return {k: fused.launch_counts[k] - before.get(k, 0) for k in kernels}


def analysis_elastic(card):
    """(a) relax_cell -> fit_elastic_tensor -> EOS of snap_ni_sfa on the
    4-atom fcc Ni cell through g2 and g4: float64 against the JAX
    fixture, float32 kernels against float32 twins."""
    from tensoralloy_tpu_torch.atoms import Structure
    from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
    from tensoralloy_tpu_torch.ops import fused
    ref = _analysis_fixture()["elastic"]
    s = fcc_conventional(Structure, ELASTIC_A)
    got = {}
    for dtype, backend in (("high", "pallas"), ("medium", "pallas"),
                           ("medium", "dense")):
        calc = TensorAlloyCalculator(str(PATHS["sf"][0]), dtype=dtype,
                                     backend=backend)
        before = dict(fused.launch_counts)
        t0 = time.perf_counter()
        got[dtype, backend] = elastic_workflow(calc, port_analysis(), s)
        sec = time.perf_counter() - t0
        r = got[dtype, backend]
        print(f"  ({dtype}, {backend}) a0 {r['a0']:.6f} A, "
              f"{ {k: round(v, 4) for k, v in r['cij'].items()} } GPa, "
              f"B_V {r['bulk_modulus_voigt']:.3f} GPa, EOS B "
              f"{r['eos']['b0'] * EV_A3_TO_GPA:.3f} GPa; {sec:.2f} s, "
              f"launches {_launched(before)} ({card})")
    err64 = _flat_rel(got["high", "pallas"], ref)
    err32 = _flat_rel(got["medium", "pallas"], got["medium", "dense"])
    print(f"    float64 vs the JAX fixture {err64:.2e} (limit "
          f"{ELASTIC_F64_REL}); float32 kernels vs twins {err32:.2e} "
          f"(limit {ELASTIC_F32_REL})")
    if not (err64 <= ELASTIC_F64_REL and err32 <= ELASTIC_F32_REL):
        raise AssertionError(f"elastic: {err64}, {err32}")


def analysis_phonons(card):
    """(b) phonons and the QHA of mleam_ni (fcc primitive cell, 3x3x3
    supercell) in float64 against the JAX fixture; one snap_ni_sfa
    supercell Hessian through the kernels against the twins."""
    from tensoralloy_tpu_torch.atoms import Structure
    from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
    from tensoralloy_tpu_torch.ops import fused
    ref = _analysis_fixture()["phonon"]
    prim = fcc_primitive(Structure, PHONON_A)
    calc = TensorAlloyCalculator(str(EAM_PATHS["mleam_ni"][0]),
                                 dtype="high")
    t0 = time.perf_counter()
    got = phonon_workflow(calc, port_analysis(), prim)
    sec = time.perf_counter() - t0
    gamma = float(np.max(np.abs(got["gamma"])))
    errs = {k: rel_err(got[k], ref[k]) for k in ("X", "L", "qha_inputs")}
    qha = {k: rel_err(got["qha"][k], v) for k, v in ref["qha"].items()}
    print(f"  mleam_ni: Gamma acoustic max |nu| {gamma:.2e} THz; X "
          f"{np.round(got['X'], 4).tolist()}, L "
          f"{np.round(got['L'], 4).tolist()} THz; QHA volume "
          f"{np.round(got['qha']['volume'], 5).tolist()} A^3, alpha(300 K) "
          f"{got['qha']['alpha'][1]:.3e} /K; {sec:.2f} s for "
          f"{1 + 2 * len(QHA_SCALES)} Hessians of "
          f"{int(np.prod(PHONON_SUPERCELL))} atoms and the fits ({card})")
    print(f"    vs the JAX fixture: {json.dumps(errs)}; QHA fits "
          f"{json.dumps(qha)}")
    if gamma > GAMMA_ACOUSTIC_THZ or max(errs.values()) > ANALYSIS_F64_REL \
            or any(qha[k] > QHA_REL[k] for k in qha):
        raise AssertionError(f"phonons: {gamma}, {errs}, {qha}")

    fcs = {}
    for backend in ("pallas", "dense"):
        sf = TensorAlloyCalculator(str(PATHS["sf"][0]), dtype="high",
                                   backend=backend)
        before = dict(fused.launch_counts)
        t0 = time.perf_counter()
        fcs[backend] = port_analysis().phonon.PhononCalculator(
            sf, prim, supercell=PHONON_SUPERCELL).fc
        launched = _launched(before)
        print(f"  snap_ni_sfa Hessian of {int(np.prod(PHONON_SUPERCELL))} "
              f"atoms, {backend}: {time.perf_counter() - t0:.2f} s, "
              f"launches {launched} ({card})")
        if backend == "pallas" and (launched["g2"] != 1
                                    or launched["g4"] != 1):
            raise AssertionError(f"the Hessian launched {launched}")
    err = rel_err(fcs["pallas"], fcs["dense"])
    print(f"    kernels vs twins {err:.2e} (limit {F64_REL})")
    if err > F64_REL:
        raise AssertionError(f"snap_ni_sfa Hessian: {err}")


def analysis_kinetics(card):
    """(c) vacancy_diffusivity of mleam_ni on fcc Ni 3x3x3 in float64
    against the JAX fixture; `vineyard_rate` raises unless the saddle has
    exactly one imaginary mode."""
    from tensoralloy_tpu_torch.atoms import Structure
    from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
    ref = json.loads((DATA / "torch_port_ref_kinetics.json").read_text())
    calc = TensorAlloyCalculator(str(EAM_PATHS["mleam_ni"][0]),
                                 dtype="high")
    t0 = time.perf_counter()
    got = kinetics_workflow(calc, port_analysis(),
                            fcc_conventional(Structure, PHONON_A))
    sec = time.perf_counter() - t0
    errs = {k: rel_err(got[k], ref[k]) for k in KINETICS_KEYS}
    print(f"  E_f {got['formation_energy']:.6f} eV, E_m "
          f"{got['migration_energy']:.6f} eV ({got['neb_steps']} NEB "
          f"steps), nu* {got['nu_star_thz']:.4f} THz, one imaginary mode "
          f"at the saddle, D(T) {got['d_vacancy_m2_s']} m^2/s; {sec:.2f} "
          f"s ({card})")
    print(f"    vs the JAX fixture {json.dumps(errs)}")
    if max(errs.values()) > KINETICS_REL:
        raise AssertionError(f"kinetics: {errs}")


def _vacancy_hop(reps: int, a: float = LATTICE):
    """(initial, final) jittered fcc Ni cells with site 0 vacant; in the
    final one its nearest neighbor sits on the vacant site. The jitter
    breaks the hop's mirror symmetry: on a perfect lattice mirror images
    of the band have equal energies, and round-off alone would pick their
    tangents."""
    from tensoralloy_tpu_torch.atoms import Structure, minimum_image
    pos, cell = jittered_fcc(reps, a=a)
    vac, pos = pos[0], pos[1:]
    d = minimum_image(pos - vac, cell)
    hop = int(np.argmin(np.linalg.norm(d, axis=1)))
    final = pos.copy()
    final[hop] = pos[hop] - d[hop]
    symbols = ["Ni"] * len(pos)
    return (Structure.from_symbols(symbols, pos, cell, pbc=[True] * 3),
            Structure.from_symbols(symbols, final, cell, pbc=[True] * 3))


def analysis_neb(card):
    """(d) the GRAP band of the 255-atom vacancy hop through grap_kernel:
    one evaluation of the jittered band against the twins; then, between
    endpoints relaxed through the kernels, NEB_STEPS FIRE steps with
    grap_kernel once per band evaluation."""
    from tensoralloy_tpu_torch.io.model import load_model
    from tensoralloy_tpu_torch.neb import NEB
    from tensoralloy_tpu_torch.ops import fused
    initial, final = _vacancy_hop(NEB_REPS)
    bands = {}
    for backend in ("pallas", "dense"):
        model, _ = load_model(str(PATHS["grap"][0]), dtype="medium",
                              backend=backend)
        bands[backend] = NEB(model, initial, final, n_images=NEB_IMAGES,
                             chunk_size=NEB_CHUNK)
    evals = {}
    for backend, neb in bands.items():
        e, f = neb._band_force(neb._featurize_band(), neb._positions_vap())
        evals[backend] = (e.cpu().numpy(), f.cpu().numpy())
    errs = {"energies": rel_err(evals["pallas"][0], evals["dense"][0]),
            "neb_forces": rel_err(evals["pallas"][1], evals["dense"][1])}
    print(f"  band of {NEB_IMAGES} x {len(initial)} atoms, one evaluation: "
          f"kernels vs twins {json.dumps(errs)}")
    if max(errs.values()) > NEB_F32_REL:
        raise AssertionError(f"GRAP band: {errs}")
    # the run: endpoints relaxed through the kernels, a fresh band
    from tensoralloy_tpu_torch.analysis.elastic import relax_positions
    from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
    calc = TensorAlloyCalculator(str(PATHS["grap"][0]), dtype="medium",
                                 backend="pallas")
    t0 = time.perf_counter()
    initial, final = (relax_positions(calc, s, fmax=0.05, steps=200)
                      for s in (initial, final))
    print(f"  endpoints relaxed to 0.05 eV/A: "
          f"{time.perf_counter() - t0:.2f} s ({card})")
    neb = NEB(bands["pallas"].model, initial, final, n_images=NEB_IMAGES,
              chunk_size=NEB_CHUNK)
    before = dict(fused.launch_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = neb.run(fmax=1e-6, max_steps=NEB_STEPS)
    sec = time.perf_counter() - t0
    launched = _launched(before)
    print(f"  {res['n_steps']} FIRE steps in chunks of {NEB_CHUNK}: "
          f"{sec:.2f} s, {res['n_steps'] / sec:.1f} steps/s; barrier "
          f"{res['barrier']:.4f} eV, fmax {res['fmax']:.4f} eV/A; "
          f"grap_kernel launches {launched['grap']} for "
          f"{neb.n_evaluations} band evaluations ({card})")
    if launched["grap"] != neb.n_evaluations or \
            not np.all(np.isfinite(res["energies"])):
        raise AssertionError(f"GRAP NEB launched {launched}, "
                             f"{neb.n_evaluations} evaluations")


def _committee(name, members, structure, kernel, card):
    """One committee request against the mean of its K single members:
    one launch of the descriptor kernel, mean E/F/S to F32_REL, a spread
    above zero; the request's time beside the K single requests'."""
    from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
    from tensoralloy_tpu_torch.ensemble import EnsembleCalculator
    from tensoralloy_tpu_torch.ops import fused
    paths = [str(p) for p in members]
    ens = EnsembleCalculator(paths, dtype="medium", backend="pallas")
    before = dict(fused.launch_counts)
    res = ens.calculate(structure)
    launched = _launched(before)
    singles = [TensorAlloyCalculator(p, dtype="medium", backend="pallas")
               for p in paths]
    results = [c.calculate(structure) for c in singles]
    mean = {k: np.mean([r[k] for r in results], axis=0)
            for k in ("energy", "forces", "stress")}
    errs = efs_errors(res, mean)
    t_ens = _median_host_ms(lambda: ens.calculate(structure), 3)
    t_one = [_median_host_ms(lambda c=c: c.calculate(structure), 3)
             for c in singles]
    # the device E/F/S of the committee and of one member, on features
    # made once
    t_dev = []
    for c in (ens, singles[0]):
        feats = c.featurize(structure, c._get_vap(structure))
        efs = c._get_variant(structure)[1]
        t_dev.append(_median_host_ms(lambda: efs(feats), 3))
    print(f"  {name}: {len(members)} members, {len(structure)} atoms: "
          f"{kernel} launches {launched[kernel]} a request; mean vs the "
          f"mean of single members {json.dumps(errs)}; energy std "
          f"{res['energy_std']:.3e} eV, max force std "
          f"{res['forces_std'].max():.3e} eV/A; request {t_ens:.1f} ms "
          f"(device E/F/S {t_dev[0]:.1f} ms: one descriptor pass, one "
          f"batched VJP over the members) against {sum(t_one):.1f} ms for "
          f"{len(members)} single requests (a member's device E/F/S "
          f"{t_dev[1]:.1f} ms) ({card})")
    if launched[kernel] != 1 or max(errs.values()) > F32_REL or \
            not res["forces_std"].max() > 0:
        raise AssertionError(f"committee {name}: {launched}, {errs}")
    return ens


def analysis_committees(card):
    """(e) the MoNi GRAP committee (5 members, 4000 atoms) and the Mo SF
    committee (8 members, bcc Mo 4394), and the selection by uncertainty
    over jittered MoNi frames."""
    from tensoralloy_tpu_torch.atoms import Structure
    from tensoralloy_tpu_torch.ensemble import select_by_uncertainty
    ens = _committee("moni grap", MONI_MEMBERS, _moni_structure(), "grap",
                     card)
    _committee("mo sf", MO_SF_MEMBERS,
               _lattice_structure("bcc", "Mo", 3.16, MD_MO_REPS), "g2", card)
    frames = []
    for i in range(SELECT_FRAMES):
        pos, cell = jittered_fcc(3, seed=SEED + i, sigma=0.02 + 0.02 * i)
        symbols = ["Mo" if j % 10 == 0 else "Ni" for j in range(len(pos))]
        frames.append(Structure.from_symbols(symbols, pos, cell,
                                             pbc=[True] * 3))
    t0 = time.perf_counter()
    order = select_by_uncertainty(ens, frames)
    scores = [ens.get_max_force_std(s) for s in frames]
    print(f"  select_by_uncertainty over {len(frames)} frames: {order}, "
          f"scores {np.round([scores[i] for i in order], 4).tolist()}; "
          f"{time.perf_counter() - t0:.2f} s ({card})")
    if sorted(order) != list(range(len(frames))) or \
            [scores[i] for i in order] != sorted(scores, reverse=True):
        raise AssertionError(f"selection order {order}, scores {scores}")


def analysis_linear(card):
    """(f) LinearTensorMD (pexp8, moments 0-3, Ni, rcut 6) fitted in
    float64 on the first LINEAR_STRUCTURES structures of snap-Ni.db
    (energy and force rows) through grap_kernel and through the twins;
    the fitted model exported and served."""
    from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
    from tensoralloy_tpu_torch.io.sqlite import connect
    from tensoralloy_tpu_torch.linear.model import (LinearTensorMD,
                                                    TensorMDPythonCalculator)
    from tensoralloy_tpu_torch.ops import fused
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copy(TRAIN_DB, Path(tmp) / TRAIN_DB.name)
        db = connect(str(Path(tmp) / TRAIN_DB.name))
        structures = [db.get(i) for i in range(1, LINEAR_STRUCTURES + 1)]
        fits, coefs = {}, {}
        for backend in ("pallas", "dense"):
            lm = LinearTensorMD(["Ni"], rcut=6.0, preset="pexp8",
                                max_moment=3, backend=backend)
            before = dict(fused.launch_counts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fits[backend] = lm.fit(structures, alpha=LINEAR_ALPHA)
            sec = time.perf_counter() - t0
            coefs[backend] = lm
            print(f"  {backend}: {fits[backend]['n_rows']} rows x "
                  f"{lm.n_coef} coefficients, RMSE "
                  f"{fits[backend]['rmse']:.6f}; {sec:.2f} s, launches "
                  f"{_launched(before)} ({card})")
        err = rel_err(coefs["pallas"].coef_, coefs["dense"].coef_)
        print(f"    coefficients, kernels vs twins {err:.2e} (limit "
              f"{LINEAR_REL})")
        if err > LINEAR_REL:
            raise AssertionError(f"linear coefficients: {err}")
        lm = coefs["pallas"]
        path = str(Path(tmp) / "linear.npz")
        lm.export(path)
        s = structures[-1]
        served = TensorAlloyCalculator(path, dtype="high",
                                       backend="pallas").calculate(s)
        direct = TensorMDPythonCalculator(lm).calculate(s)
        errs = efs_errors(served, direct)
        print(f"    exported and served: {len(s)} atoms, E "
              f"{served['energy']:.6f} eV (label {s.energy:.6f}); vs the "
              f"fitted model's calculator {json.dumps(errs)}")
        if max(errs.values()) > F64_REL:
            raise AssertionError(f"linear export: {errs}")


def analysis_ti(card):
    """(g) Frenkel-Ladd of mleam_ni on Ni 108 at 300 K at cut depth, and
    the Einstein -> Einstein integration against its closed form."""
    from tensoralloy_tpu_torch.analysis import ti
    from tensoralloy_tpu_torch.atoms import Structure
    from tensoralloy_tpu_torch.dynamics import KB
    from tensoralloy_tpu_torch.io.model import load_model
    model, _ = load_model(str(EAM_PATHS["mleam_ni"][0]), dtype="high")
    temp = 300.0
    s = fcc_conventional(Structure, PHONON_A).repeat((3, 3, 3))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ti.frenkel_ladd(model, s, temp, **TI_RUN)
    sec = time.perf_counter() - t0
    steps = (TI_RUN["equil_steps"] + max(TI_RUN["prod_steps"] // 2,
                                         10 * TI_RUN["sample"])
             + TI_RUN["n_lambda"] * (TI_RUN["equil_steps"]
                                     + TI_RUN["prod_steps"]))
    print(f"  Ni {len(s)} at {temp} K: F {res['free_energy_per_atom']:.6f} "
          f"eV/atom (k_spring {res['k_spring']:.3f} eV/A^2), {steps} MD "
          f"steps in {sec:.2f} s, {steps / sec:.1f} steps/s ({card})")
    if not np.isfinite(res["free_energy_per_atom"]):
        raise AssertionError("Frenkel-Ladd: non-finite free energy")

    clone = model.clone_for(s.count())
    vap = model.featurizer.make_vap(s, s.count())
    centers = np.zeros((clone.n_atoms_vap, 3))
    centers[vap.local_to_vap] = s.positions
    masks = np.zeros(clone.n_atoms_vap)
    masks[vap.local_to_vap] = 1.0
    k0, k1 = EINSTEIN_K
    fake = ti.LambdaMix(model, 0.0, centers, k1, masks)
    t0 = time.perf_counter()
    res = ti.frenkel_ladd(fake, s, temp, k_spring=k0, **EINSTEIN_RUN)
    df = 1.5 * len(s) * KB * temp * np.log(k1 / k0)
    f1 = ti.einstein_free_energy(len(s), s.masses, k1, temp)
    print(f"  Einstein -> Einstein, {len(s)} atoms: dF {res['delta_f']:.6f} "
          f"eV against {df:.6f} eV ({res['delta_f'] / df - 1:+.4f}); F "
          f"{res['free_energy']:.6f} against {f1:.6f} eV; "
          f"{time.perf_counter() - t0:.2f} s ({card})")
    if abs(res["delta_f"] / df - 1) > 0.05 or \
            abs(res["free_energy"] - f1) > 0.06 * abs(df):
        raise AssertionError("Einstein -> Einstein off its closed form")


def analysis_surfaces(card):
    """(h) surface energies and the intrinsic stacking fault of mleam_ni
    in float64 against the JAX fixture; (111) below (100)."""
    from tensoralloy_tpu_torch.atoms import Structure
    from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
    ref = json.loads((DATA / "torch_port_ref_surface.json").read_text())
    calc = TensorAlloyCalculator(str(EAM_PATHS["mleam_ni"][0]),
                                 dtype="high")
    t0 = time.perf_counter()
    got = surface_workflow(calc, port_analysis(),
                           fcc_conventional(Structure, PHONON_A))
    err = _flat_rel(got, ref)
    print(f"  gamma(111) {got['111']['gamma_j_m2']:.6f}, gamma(100) "
          f"{got['100']['gamma_j_m2']:.6f} J/m^2, ISF "
          f"{got['isf_mj_m2']:.4f} mJ/m^2; vs the JAX fixture {err:.2e}; "
          f"{time.perf_counter() - t0:.2f} s ({card})")
    if err > ANALYSIS_F64_REL or not \
            got["111"]["gamma_j_m2"] < got["100"]["gamma_j_m2"]:
        raise AssertionError(f"surfaces: {err}, {got}")


ANALYSIS_PARTS = (("a elastic + EOS", analysis_elastic, ("g2", "g4")),
                  ("b phonons + QHA", analysis_phonons, ("g2", "g4")),
                  ("c vacancy kinetics", analysis_kinetics, ()),
                  ("d GRAP NEB", analysis_neb, ("grap",)),
                  ("e committees", analysis_committees, ("g2", "grap")),
                  ("f linear TensorMD", analysis_linear, ("grap",)),
                  ("g Frenkel-Ladd", analysis_ti, ()),
                  ("h surfaces", analysis_surfaces, ()))


def analysis(card):
    """The materials-analysis path on the default device (cuda), each
    part with the launch counts reset before it and read after it: the
    kernels it names must have launched, the others not. -> launches by
    kernel over the phase."""
    from tensoralloy_tpu_torch.ops import fused
    phase("analysis")
    t0 = time.perf_counter()
    totals = {k: 0 for k in fused.launch_counts}
    for name, part, kernels in ANALYSIS_PARTS:
        print(f"  -- ({name})")
        t1 = time.perf_counter()
        fused.reset_launch_counts()
        part(card)
        launches = dict(fused.launch_counts)
        print(f"  ({name}) {time.perf_counter() - t1:.1f} s, launches "
              f"{launches}")
        if any(not launches[k] for k in kernels) or any(
                launches[k] for k in launches if k not in kernels):
            raise AssertionError(f"({name}) launched {launches}, expected "
                                 f"{kernels}")
        for k, v in launches.items():
            totals[k] += v
    print(f"  launches over the analysis phase: {totals}")
    print(f"  analysis phase {time.perf_counter() - t0:.1f} s")
    return totals


# ----------------------------------------------------------------------
# cli: the command lines
# ----------------------------------------------------------------------

# (a) the experiment through the verbs: the run's input.toml at full width
# with backend 'pallas', warm-started from the saved model, its depth cut
# to CLI_STEPS steps with one evaluation and one periodic checkpoint
CLI_RUN = "snap_ni_sfa"
CLI_STEPS = 20
CLI_F32_REL = 1e-4       # a verb through the kernels against the twins
CLI_F64_REL = 1e-8       # the float64 verbs against the JAX fixture
# ... what an equation-of-state fit prints (V0, E0, B, the lattice
# constants of `latt`): scipy's least squares stops at a relative change
# of 1.5e-8 in the sum of squares, so the fitted parameters move by up
# to 1e-7 with round-off of the energies (5e-8 seen between the packages
# on one input); its input energies (eos.csv) stay at CLI_F64_REL
CLI_FIT_REL = 1e-6
CLI_DB_STRUCTURES = 20   # scatter and percentile
# (c) GRAP: MD of Ni 4000 on device lists, a few FIRE steps of the
# 255-atom vacancy hop, the MoNi committee over jittered frames
CLI_MD_STEPS, CLI_MD_CHUNK = 40, 20
CLI_NEB_STEPS = 20
CLI_UNCERTAINTY_FRAMES = 4
# (d) the float64 verbs held against tests/data/torch_port_ref_cli.json:
# the saved models with their weights stored in float64 (the files hold
# float32, which the JAX package keeps, so that part of its arithmetic
# stays in float32 under its float64 policy), and the verbs' arguments
# ({model} is the copy's path)
CLI_F64_MODELS = {"snap_ni_sfa": PATHS["sf"][0],
                  "mleam_ni": EAM_PATHS["mleam_ni"][0]}
CLI_F64_VERBS = {
    "latt": ["compute", "latt", "{model}", "Ni"],
    "eos": ["compute", "eos", "{model}", "Ni", "--num", "9",
            "--output", "eos.csv"],
    "elastic": ["compute", "elastic", "{model}", "Ni"],
    "defect": ["compute", "defect", "{model}", "Ni",
               "--supercell", "2", "2", "2"],
    "surface": ["compute", "surface", "{model}", "Ni", "1", "1", "1",
                "--layers", "4"],
}
NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def split_numbers(text: str):
    """-> (the text with each number replaced by '#' and each run of
    spaces by one, the numbers as printed). A number's sign moves the
    padding of a fixed-width column."""
    return re.sub(r"[ \t]+", " ", NUMBER.sub("#", text)), \
        NUMBER.findall(text)


def half_unit(token: str) -> float:
    """Half a unit of the last digit of a printed number."""
    mantissa, _, exponent = token.lower().partition("e")
    decimals = len(mantissa.split(".")[1]) if "." in mantissa else 0
    return 0.5 * 10.0 ** (int(exponent or 0) - decimals)


def printed_mismatches(got: str, want: str, rel: float) -> list:
    """Where two printed texts differ: in their words, or in a number. A
    printed number stands for its value to half a unit of its last digit,
    so two agree where they differ by at most the two half units plus
    `rel` of the largest number on their line (a component that is zero
    up to round-off beside others is held to their scale).
    -> [(got, want), ...], empty where they agree."""
    g_lines, w_lines = got.splitlines(), want.splitlines()
    if len(g_lines) != len(w_lines):
        return [(got, want)]
    bad = []
    for g_line, w_line in zip(g_lines, w_lines):
        (g_text, g_nums), (w_text, w_nums) = split_numbers(g_line), \
            split_numbers(w_line)
        if g_text != w_text or len(g_nums) != len(w_nums):
            bad.append((g_line, w_line))
            continue
        scale = max((abs(float(b)) for b in w_nums), default=0.0)
        bad += [(a, b) for a, b in zip(g_nums, w_nums)
                if not abs(float(a) - float(b))
                <= rel * scale + half_unit(a) + half_unit(b)]
    return bad


def printed_rel_err(got: str, want: str, squared: bool = False) -> float:
    """`rel_err` over the numbers of two printed texts with the same
    words, each difference less the two half units of the numbers' last
    digits (what printing alone explains); inf where the words differ.
    `squared` compares x |x| in place of x: phonon frequencies through
    the Hessian's eigenvalues, where the square root would magnify the
    round-off of a near-zero acoustic mode."""
    (g_text, g_nums), (w_text, w_nums) = split_numbers(got), \
        split_numbers(want)
    if g_text != w_text or len(g_nums) != len(w_nums):
        return float("inf")
    if not w_nums:
        return 0.0
    g, w = (np.array([float(x) for x in nums]) for nums in (g_nums, w_nums))
    slack = np.array([half_unit(a) + half_unit(b)
                      for a, b in zip(g_nums, w_nums)])
    if squared:
        slack = slack * (np.abs(g) + np.abs(w))
        g, w = g * np.abs(g), w * np.abs(w)
    diff = np.maximum(np.abs(g - w) - slack, 0.0)
    return float(diff.max() / max(np.abs(w).max(), 1e-300))


def run_verb(main, argv, workdir, **kwargs) -> dict:
    """`main(argv, **kwargs)` of either package's command line with
    `workdir` as the working directory and stdout captured. -> {"rc",
    "stdout", "files": {name: text of each text file written}}."""
    import contextlib
    import io
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    before = {p for p in workdir.rglob("*") if p.is_file()}
    cwd = os.getcwd()
    out = io.StringIO()
    os.chdir(workdir)
    try:
        with contextlib.redirect_stdout(out):
            rc = main(argv, **kwargs)
    finally:
        os.chdir(cwd)
    files = {}
    for p in sorted(workdir.rglob("*")):
        if p.is_file() and p not in before and p.suffix in (
                ".csv", ".extxyz", ".json", ".lammps", ".txt", ""):
            files[str(p.relative_to(workdir))] = p.read_text()
    return {"rc": rc, "stdout": out.getvalue(), "files": files}


def cli_f64_rel(case: str, part: str) -> float:
    """The tolerance of a part ("stdout" or a file's name) of a case of
    `cli_f64_cases`: CLI_FIT_REL for what an EOS fit prints."""
    fitted = case.split()[0] in ("eos", "latt") and part == "stdout"
    return CLI_FIT_REL if fitted else CLI_F64_REL


def float64_copy(model_path, path) -> str:
    """A copy of a saved model with its weights stored in float64 (an
    exact cast). -> the copy's path."""
    with np.load(model_path) as z:
        flat = {k: (z[k].astype(np.float64) if k.startswith("p/") else z[k])
                for k in z.files}
    np.savez(path, **flat)
    return str(path)


def cli_f64_cases() -> dict:
    """{"<verb> <model>": (model name, argv)} of the float64 fixture."""
    return {f"{verb} {name}": (name, argv) for name in CLI_F64_MODELS
            for verb, argv in CLI_F64_VERBS.items()}


def cli_f64_run(main, case, workdir, **kwargs) -> dict:
    """One case of `cli_f64_cases` through `main` (either package's) in
    `workdir`, on a float64 copy of its model written there.
    -> {"stdout", "files"}."""
    name, argv = cli_f64_cases()[case]
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    model = float64_copy(CLI_F64_MODELS[name], workdir / f"{name}_f64.npz")
    rec = run_verb(main, [model if a == "{model}" else a for a in argv],
                   workdir / "run", **kwargs)
    if rec["rc"] != 0:
        raise AssertionError(f"{case}: exit code {rec['rc']}")
    return {"stdout": rec["stdout"], "files": rec["files"]}


# tensordb: a deployment's sampling and recompute pipeline on synthetic
# VASP outputs (fcc Cu 2x2x2, two AIMD temperatures)
TENSORDB_CONFIG = """\
species = ["Cu"]
phases = ["fcc"]
[fcc]
a = 3.6
supercell = [[2, 2, 2]]
[calc]
interval = 2
[aimd.sampling.nvt.fcc]
t0 = 300
t1 = 900
size = 2
[vasp.sampling]
encut = 400
[vasp.calc]
encut = 520
kpar = 2
nbands = "lambda a, n, v, t: n * 4 + 8"
magmom = 0.6
[neq]
nmax = 3
dmin = 1.2
interval = 3
[porosity]
porosity = [1.5, 3.0]
interval = 3
[aging]
interval = 3
[aging.transmutation]
Cu-Ni = {prob = 0.5, nmax = 2}
[aging.helium_bubble]
target = "Cu"
max_target_size = 2
max_bubble_size = 4
max_ratio = 3.0
"""
TENSORDB_FRAMES = 6      # AIMD frames of a sampling task
TENSORDB_A = 3.6


def _v(values) -> str:
    return "<v>" + " ".join(f"{x:.10f}" for x in values) + "</v>"


def write_vasprun_frames(path, frames, sigma: float = 0.1,
                         seed: int = SEED) -> None:
    """A vasprun.xml of the ionic steps `frames` ([(symbols, positions,
    cell)]), with the fields the readers read: per step two electronic
    steps, the cell, fractional positions, forces, stress and energies
    from a seeded generator."""
    rng = np.random.RandomState(seed)
    symbols = frames[0][0]
    lines = ['<?xml version="1.0" encoding="ISO-8859-1"?>', "<modeling>",
             '<parameters><separator name="electronic">'
             f'<i name="SIGMA">{sigma}</i></separator></parameters>',
             '<atominfo><array name="atoms"><set>']
    lines += [f"<rc><c>{s}</c><c>1</c></rc>" for s in symbols]
    lines.append("</set></array></atominfo>")
    for _, positions, cell in frames:
        n = len(positions)
        lines.append("<calculation>")
        for _ in range(2):
            e0, efr, ewo = rng.normal(-3.7 * n, 0.5, 3)
            lines.append(
                f'<scstep><energy><i name="e_fr_energy">{efr}</i>'
                f'<i name="e_wo_entrp">{ewo}</i>'
                f'<i name="e_0_energy">{e0}</i></energy></scstep>')
        lines.append('<structure><crystal><varray name="basis">')
        lines += [_v(row) for row in cell]
        lines.append('</varray></crystal><varray name="positions">')
        lines += [_v(row) for row in positions @ np.linalg.inv(cell)]
        lines.append('</varray></structure><varray name="forces">')
        lines += [_v(row) for row in rng.normal(scale=0.3, size=(n, 3))]
        lines.append('</varray><varray name="stress">')
        s = rng.normal(scale=10, size=(3, 3))
        lines += [_v(row) for row in s + s.T]
        lines.append(f'</varray><energy><i name="e_fr_energy">'
                     f'{rng.normal(-3.7 * n)}</i></energy></calculation>')
    lines.append("</modeling>")
    Path(path).write_text("\n".join(lines) + "\n")


def write_vasp_outputs(jobdir, nscf=(12, 9), nelm=None, ranks=(32, 2, 1),
                       loop_seconds=(41.5, 38.25)) -> None:
    """The INCAR line NELM (where given), an OSZICAR of one ionic step a
    `nscf` entry (that many SCF iterations each), and an OUTCAR with the
    MPI/thread layout and one LOOP+ time an ionic step."""
    jobdir = Path(jobdir)
    if nelm is not None:
        with open(jobdir / "INCAR", "a") as fh:
            fh.write(f" NELM = {nelm}\n")
    lines = []
    for step, n in enumerate(nscf, 1):
        lines.append("       N       E                     dE             d eps")
        lines += [f"DAV:  {k:2d}    -0.230645970000E+02   -0.1E-05   "
                  f"-0.2E-07  1600   0.2E-03" for k in range(1, n + 1)]
        lines.append(f"   {step} F= -.23064597E+02 E0= -.23064{step}97E+02 "
                     f" d E =-.230646E+02")
    (jobdir / "OSZICAR").write_text("\n".join(lines) + "\n")
    mpi, threads, nodes = ranks
    lines = [" vasp.6.3.2 18Jan22 (build Feb 10 2022) complex",
             f" running {mpi:4d} mpi-ranks, with {threads:4d} threads/rank, "
             f"on {nodes:4d} nodes"]
    lines += [f"      LOOP+:  cpu time {t * 0.98:10.4f}: real time "
              f"{t:10.4f}" for t in loop_seconds]
    (jobdir / "OUTCAR").write_text("\n".join(lines) + "\n")


def _cu_frame(seed: int, sigma: float = 0.05):
    pos, cell = jittered_fcc(2, seed=seed, a=TENSORDB_A, sigma=sigma)
    return ["Cu"] * len(pos), pos, cell


def tensordb_workflow(run, root, calculators=("calc", "neq", "porosity",
                                              "aging")) -> list:
    """The tensordb pipeline in `root` through `run(argv) -> exit code`
    (either package's `main`, or the module run as a program, with `root`
    as its working directory): sampling aimd -> the AIMD runs finish
    (synthetic vasprun.xml) -> status sampling -> postprocess -> create
    each of `calculators` -> their jobs finish (synthetic INCAR NELM,
    OSZICAR, OUTCAR, vasprun.xml; every third one unconverged) -> status
    of each -> gather. -> the exit codes."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.toml").write_text(TENSORDB_CONFIG)
    rcs = [run(["sampling", "aimd"])]
    tasks = sorted(p.parent for p in root.glob("*/status.json"))
    for i, task in enumerate(tasks):
        frames = [_cu_frame(100 * i + j) for j in range(TENSORDB_FRAMES)]
        write_vasprun_frames(task / "vasprun.xml", frames, seed=i)
    rcs += [run(["status", "sampling"]), run(["status", "unsubmitted"]),
            run(["postprocess"])]
    subdirs = {"calc": "calc", "neq": "neq", "porosity": "porous",
               "aging": "aging"}
    for calc in calculators:
        rcs.append(run(["create", calc]))
        jobs = sorted(root.glob(f"{subdirs[calc]}/*atoms/group*/task*"))
        for k, job in enumerate(jobs):
            write_vasp_outputs(job, nscf=(12, 60 if k % 3 == 2 else 9),
                               nelm=60)
            write_vasprun_frames(job / "vasprun.xml",
                                 [_cu_frame(1000 + k, sigma=0.02)],
                                 seed=1000 + k)
        rcs.append(run(["status", calc]))
    rcs.append(run(["gather", "-o", "gathered.extxyz"]))
    return rcs


def warm_start_checkpoint(model_path, path) -> None:
    """A training checkpoint (the JAX package's keys) whose raw and EMA
    parameters are a saved model's weights (in float64: a trainer casts
    them to its own dtype), at step 0."""
    with np.load(model_path) as z:
        tree = {k[2:]: z[k].astype(np.float64) for k in z.files
                if k.startswith("p/")}
    np.savez(path, step=np.asarray(0, np.int32),
             **{f"{prefix}/{k}": v for prefix in ("params", "ema")
                for k, v in tree.items()})


def backend_copy(model_path, path, backend: str) -> str:
    """A copy of a saved model file whose descriptor names `backend`, its
    weights as they are (either package loads it). -> `path`."""
    with np.load(str(model_path)) as z:
        flat = {k: z[k] for k in z.files}
    config = json.loads(bytes(flat["__config__"]).decode())
    config["model"]["descriptor"]["backend"] = backend
    flat["__config__"] = np.frombuffer(json.dumps(config).encode(),
                                       dtype=np.uint8)
    np.savez(str(path), **flat)
    return str(path)


def pallas_copy(model_path, path) -> None:
    """A copy of a saved model whose descriptor says backend 'pallas'."""
    from tensoralloy_tpu_torch.io.model import load_model, save_model
    model, _ = load_model(str(model_path), backend="pallas")
    save_model(str(path), model)


class _Recorded:
    """Swap `module.<name>` (a class) for a subclass that keeps each
    instance it makes in `made` (and hands it to `hook`), for as long as
    the block runs: the verbs build their trainers, integrators and bands
    inside, where the script cannot reach them otherwise."""

    def __init__(self, module, name, hook=None):
        self.module, self.name, self.hook = module, name, hook
        self.made = []

    def __enter__(self):
        cls, made, hook = getattr(self.module, self.name), self.made, \
            self.hook
        self.cls = cls

        class Recorded(cls):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                made.append(self)
                if hook is not None:
                    hook(self)

        setattr(self.module, self.name, Recorded)
        return self.made

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.cls)


def _timed_verb(label, main, argv, workdir, times, **kwargs) -> dict:
    """`run_verb` in this process; fails on a non-zero exit code. `times`
    gets (label, wall time, None: no process start)."""
    t0 = time.perf_counter()
    rec = run_verb(main, argv, workdir, **kwargs)
    times.append((label, time.perf_counter() - t0, None))
    if rec["rc"] != 0:
        raise AssertionError(f"{label}: exit code {rec['rc']}\n"
                             f"{rec['stdout']}")
    return rec


def _module_run(module: str, argv, cwd):
    """`python -m <module> <argv>` from `cwd` with the checkout
    importable, as a user runs it, with `-X importtime`. -> (the
    CompletedProcess, seconds the process spent importing modules: the
    sum of the top-level imports' cumulative times, the lazy imports of
    the verb included)."""
    proc = subprocess.run([sys.executable, "-X", "importtime", "-m", module,
                           *argv], cwd=cwd,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)),
                          capture_output=True, text=True, timeout=600)
    us = 0
    for line in proc.stderr.splitlines():
        fields = line.split("|")
        if line.startswith("import time:") and len(fields) == 3 \
                and fields[1].strip().isdigit() \
                and not fields[2].startswith("  "):
            us += int(fields[1])
    return proc, us * 1e-6


def _subprocess_verb(label, module, argv, cwd, times) -> str:
    """`_module_run`; fails on a non-zero exit code. -> its stdout. `times`
    gets (label, wall time, the imports' seconds)."""
    t0 = time.perf_counter()
    proc, imports = _module_run(module, argv, cwd)
    sec = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{label}: exit code {proc.returncode}\n"
                             f"{proc.stdout}\n{proc.stderr}")
    times.append((label, sec, imports))
    return proc.stdout


def _add_launches(totals: dict, launched: dict) -> None:
    for k, v in launched.items():
        totals[k] = totals.get(k, 0) + v


def _launch_check(label, launched, kernels):
    """The kernels that `label` names launched, the others not."""
    if any(not launched[k] for k in kernels) or any(
            launched[k] for k in launched if k not in kernels):
        raise AssertionError(f"{label} launched {launched}, expected "
                             f"{kernels}")


def cli_experiment(work, card, times) -> dict:
    """(a) run -> export -> evaluate -> print of the run's input.toml at
    full width with backend 'pallas', and the module entry on the
    exported model. -> {"exported": path, "launches": ...}."""
    from tensoralloy_tpu_torch.cli.entry import main
    from tensoralloy_tpu_torch.io.model import load_model
    from tensoralloy_tpu_torch.ops import fused
    from tensoralloy_tpu_torch.train import manager as manager_module
    run_dir = work / "run"
    run_dir.mkdir()
    warm_start_checkpoint(PATHS["sf"][0], run_dir / "warm.npz")
    config = experiment_config(CLI_RUN, run_dir, {
        "nn.atomic.sf.backend": "pallas",
        "train.train_steps": CLI_STEPS, "train.eval_steps": CLI_STEPS,
        "train.log_steps": CLI_STEPS, "train.summary_steps": 10,
        "train.ckpt.checkpoint_filename": str(run_dir / "warm.npz"),
        "train.ckpt.use_ema_variables": True,
        "train.ckpt.restore_optimizer_variables": False,
        "train.reset_global_step": True}, database=TRAIN_DB)
    toml = run_dir / "input.toml"
    dump_toml(config, toml)
    rows = []
    fused.reset_launch_counts()
    with _Recorded(manager_module, "Trainer", lambda tr: _count_step_launches(
            tr, ("g2", "g4"), rows)):
        _timed_verb("run", main, ["run", str(toml), "--quiet"], work / "a",
                    times)
    run_launches = _launched({})
    bad = [r for r in rows if set(r[1].values()) != {1}]
    if [r[0] for r in rows] != list(range(CLI_STEPS)) or bad:
        raise AssertionError(f"run: steps {[r[0] for r in rows]}, not one "
                             f"launch of g2 and g4 in each of {bad}")
    model_dir = Path(config["train"]["model_dir"])
    ckpt = model_dir / f"ckpt-{CLI_STEPS}.npz"
    rec = _timed_verb("export", main, ["export", str(toml), "--checkpoint",
                                       str(ckpt)], work / "a", times)
    exported = model_dir / f"{config['dataset']['name']}.npz"
    with np.load(exported) as z:
        saved = json.loads(bytes(z["__config__"]).decode())
    backend = saved["model"]["descriptor"]["backend"]
    fused.reset_launch_counts()
    rec_eval = _timed_verb("evaluate", main, ["evaluate", str(run_dir)],
                           work / "a", times)
    eval_launches = _launched({})
    report = json.loads((run_dir / "group_maes.json").read_text())
    rec_print = _timed_verb("print", main, ["print", str(
        model_dir / "metrics.jsonl"), "--output", "summary.csv"],
        work / "a", times)
    wanted = ["input.json", "run.pid", ckpt.name, "ckpt-best.npz",
              "best.json", "metrics.jsonl", "checkpoint.npz",
              "history.json", exported.name]
    missing = [f for f in wanted if not (model_dir / f).exists()]
    if missing or backend != "pallas" or report["step"] != CLI_STEPS \
            or f"(step {CLI_STEPS})" not in rec["stdout"] \
            or not (work / "a" / "summary.csv").exists() \
            or not eval_launches["g2"] or not eval_launches["g4"]:
        raise AssertionError(f"the experiment's files: missing {missing}, "
                             f"backend {backend!r}, evaluation at step "
                             f"{report['step']}, launches {eval_launches}")
    overall = report["splits"]["test"]["overall"]
    print(f"  (a) run: {CLI_STEPS} steps warm-started from the saved "
          f"model, one launch of g2 and g4 in each ({run_launches} with the "
          f"evaluation's); export -> "
          f"{exported.name} (backend {backend!r}); evaluate at step "
          f"{report['step']}: test {overall['energy_meV_per_atom']:.3f} "
          f"meV/atom, {overall['force_eV_A']:.4f} eV/A ({eval_launches}); "
          f"print: {rec_print['stdout'].splitlines()[-1]}")
    out = _subprocess_verb("python -m tensoralloy_tpu_torch.cli compute "
                           "latt", "tensoralloy_tpu_torch.cli",
                           ["compute", "latt", str(exported), "Ni"],
                           work / "a", times)
    print(f"  module entry, compute latt of the exported model: "
          f"{' / '.join(out.strip().splitlines())}")
    # the twin copy: the exported weights with backend 'dense'
    from tensoralloy_tpu_torch.io.model import save_model
    model, _ = load_model(str(exported), backend="dense")
    twin = work / "exported_dense.npz"
    save_model(str(twin), model)
    launches = {k: run_launches[k] + eval_launches[k] for k in run_launches}
    return {"exported": exported, "twin": twin, "launches": launches}


def _verb_pair(label, argv, model, twin, work, times, kernels,
               extra_files=()) -> dict:
    """`argv` ({model} in it) through the kernels' model and through its
    twin copy in float32 on the default device: the kernels named launch
    (only those), the printed numbers and the files written agree to
    CLI_F32_REL. -> launches."""
    from tensoralloy_tpu_torch.cli.entry import main
    from tensoralloy_tpu_torch.ops import fused
    recs = {}
    for name, path in (("kernels", model), ("twins", twin)):
        fused.reset_launch_counts()
        recs[name] = _timed_verb(
            f"{label} ({name})", main,
            [str(path) if a == "{model}" else a for a in argv],
            work / label.replace(" ", "_") / name, times)
        if name == "kernels":
            launched = _launched({})
    _launch_check(label, launched, kernels)
    errs = {"stdout": printed_rel_err(recs["kernels"]["stdout"],
                                      recs["twins"]["stdout"])}
    for f in recs["twins"]["files"]:
        errs[f] = printed_rel_err(recs["kernels"]["files"].get(f, ""),
                                  recs["twins"]["files"][f],
                                  squared=f == "bands.csv")
    for f in extra_files:
        if f not in errs:
            raise AssertionError(f"{label}: {f} was not written")
    last = recs["kernels"]["stdout"].strip().splitlines()[-1]
    print(f"  {label}: launches {launched}; kernels vs twins "
          f"{json.dumps(errs)}; {last}")
    if max(errs.values()) > CLI_F32_REL:
        raise AssertionError(f"{label}: kernels vs twins {errs}")
    return launched


def cli_sf_verbs(work, exported, twin, card, times) -> dict:
    """(b) the SF verbs on the exported model (kernels) and its twin copy
    in float32: each launches g2 and g4 and agrees with the twins."""
    from tensoralloy_tpu_torch.io.sqlite import connect
    db_path = work / "snap20.db"
    db = connect(str(db_path))
    for s in itertools.islice(connect(str(TRAIN_DB)), CLI_DB_STRUCTURES):
        db.write(s, commit=False)
    db._con.commit()
    verbs = {
        "latt": ["compute", "latt", "{model}", "Ni"],
        "eos": ["compute", "eos", "{model}", "Ni", "--output", "eos.csv"],
        "elastic": ["compute", "elastic", "{model}", "Ni"],
        "relax --cell": ["compute", "relax", "{model}", "Ni", "--cell",
                         "-o", "relaxed.extxyz"],
        "defect": ["compute", "defect", "{model}", "Ni", "--supercell",
                   "3", "3", "3"],
        "phonon": ["compute", "phonon", "{model}", "Ni", "--output",
                   "bands.csv"],
        "scatter": ["compute", "scatter", "{model}", str(db_path),
                    "--output", "scatter.csv"],
        "percentile": ["compute", "percentile", "{model}", str(db_path)],
    }
    files = {"eos": ("eos.csv",), "relax --cell": ("relaxed.extxyz",),
             "phonon": ("bands.csv",), "scatter": ("scatter.csv",)}
    totals = {}
    for label, argv in verbs.items():
        _add_launches(totals, _verb_pair(label, argv, exported, twin, work,
                                         times, ("g2", "g4"),
                                         files.get(label, ())))
    return totals


def cli_grap_verbs(work, card, times) -> dict:
    """(c) md, neb and uncertainty through grap_kernel: a 'pallas' copy of
    the saved GRAP model (and of the MoNi committee) against the saved
    files, which say 'dense'."""
    from tensoralloy_tpu_torch import dynamics, neb as neb_module
    from tensoralloy_tpu_torch.io.extxyz import write_extxyz
    grap = work / "snap_Ni_pallas.npz"
    pallas_copy(PATHS["grap"][0], grap)
    totals = {}
    reps = REQUEST_REPS[1]
    with _Recorded(dynamics, "VelocityVerlet") as made:
        got = _verb_pair(
            f"md --device-nl Ni {4 * reps ** 3}",
            ["compute", "md", "{model}", "Ni", "--supercell", str(reps),
             str(reps), str(reps), "--steps", str(CLI_MD_STEPS),
             "--chunk-size", str(CLI_MD_CHUNK), "--temp", "300",
             "--device-nl", "-o", "md_final.extxyz", "--thermo",
             "thermo.csv"], grap, PATHS["grap"][0], work, times, ("grap",),
            ("md_final.extxyz", "thermo.csv"))
    md = made[0]
    chunks = CLI_MD_STEPS // CLI_MD_CHUNK + md.regrows
    want = chunks * (CLI_MD_CHUNK + 2)
    if got["grap"] != want:
        raise AssertionError(f"md launched {got}, expected {want} "
                             f"({chunks} chunks)")
    _add_launches(totals, got)

    initial, final = _vacancy_hop(NEB_REPS)
    write_extxyz(str(work / "hop_initial.extxyz"), [initial])
    write_extxyz(str(work / "hop_final.extxyz"), [final])
    with _Recorded(neb_module, "NEB") as made:
        got = _verb_pair(
            f"neb {len(initial)} atoms",
            ["compute", "neb", "{model}", str(work / "hop_initial.extxyz"),
             str(work / "hop_final.extxyz"), "--n-images", str(NEB_IMAGES),
             "--max-steps", str(CLI_NEB_STEPS), "--fmax", "1e-6",
             "--output", "neb.csv"], grap, PATHS["grap"][0], work, times,
            ("grap",), ("neb.csv",))
    if got["grap"] != made[0].n_evaluations:
        raise AssertionError(f"neb launched {got}, "
                             f"{made[0].n_evaluations} band evaluations")
    _add_launches(totals, got)

    members = []
    for i, path in enumerate(MONI_MEMBERS):
        members.append(work / f"moni_{i}_pallas.npz")
        pallas_copy(path, members[-1])
    frames = []
    for i in range(CLI_UNCERTAINTY_FRAMES):
        s = _moni_structure()
        s.positions = s.positions + np.random.default_rng(SEED + i).normal(
            0.0, 0.02 * (i + 1), s.positions.shape)
        frames.append(s)
    write_extxyz(str(work / "moni_frames.extxyz"), frames)
    from tensoralloy_tpu_torch import ensemble
    from tensoralloy_tpu_torch.cli.entry import main
    from tensoralloy_tpu_torch.ops import fused
    requests = []

    def count_requests(calc):
        calculate = calc.calculate

        def counted(structure):
            requests.append(len(structure))
            return calculate(structure)
        calc.calculate = counted

    recs = {}
    for name, paths in (("kernels", members), ("twins", MONI_MEMBERS)):
        fused.reset_launch_counts()
        with _Recorded(ensemble, "EnsembleCalculator", count_requests):
            recs[name] = _timed_verb(
                f"uncertainty ({name})", main,
                ["compute", "uncertainty", str(work / "moni_frames.extxyz"),
                 *map(str, paths)], work / "uncertainty" / name, times)
        if name == "kernels":
            launched, n_requests = _launched({}), len(requests)
    err = printed_rel_err(recs["kernels"]["stdout"], recs["twins"]["stdout"])
    print(f"  uncertainty: {len(MONI_MEMBERS)} MoNi members, "
          f"{len(frames)} frames of {len(frames[0])} atoms: launches "
          f"{launched} for {n_requests} requests (the ranking, then the "
          f"printed scores but the one cached); kernels vs twins "
          f"{err:.2e}")
    _launch_check("uncertainty", launched, ("grap",))
    if launched["grap"] != n_requests or n_requests < len(frames) \
            or err > CLI_F32_REL:
        raise AssertionError(f"uncertainty: {launched}, {n_requests} "
                             f"requests, {err}")
    _add_launches(totals, launched)
    return totals


def cli_f64(work, card, times) -> None:
    """(d) the saved models as they stand at float64 against the JAX
    command line's fixture."""
    from tensoralloy_tpu_torch.cli.entry import main
    t0 = time.perf_counter()
    got = {case: cli_f64_run(main, case, work / "f64" / str(k),
                             dtype="high")
           for k, case in enumerate(cli_f64_cases())}
    times.append(("float64 verbs", time.perf_counter() - t0, None))
    want = json.loads((DATA / "torch_port_ref_cli.json").read_text())
    bad = {}
    for case, rec in want.items():
        for name, text in [("stdout", rec["stdout"])] + sorted(
                rec["files"].items()):
            have = got[case]["stdout"] if name == "stdout" else \
                got[case]["files"].get(name, "")
            miss = printed_mismatches(have, text, cli_f64_rel(case, name))
            if miss:
                bad[f"{case}: {name}"] = miss[:3]
    print(f"  (d) {len(want)} float64 verbs ({', '.join(want)}) against "
          f"torch_port_ref_cli.json: "
          f"{'agree' if not bad else bad} (to {CLI_F64_REL:g}, what an "
          f"EOS fit prints to {CLI_FIT_REL:g}, of the largest number of "
          f"a line, a printed number standing for its value to half a "
          f"unit of its last digit)")
    if bad:
        raise AssertionError(f"float64 verbs: {bad}")


def cli_eam(work, card, times) -> None:
    """(e) kappa and fe of mleam_ni at cut depth: no descriptor kernel."""
    from tensoralloy_tpu_torch.cli.entry import main
    from tensoralloy_tpu_torch.ops import fused
    model = str(EAM_PATHS["mleam_ni"][0])
    for label, argv in (
            ("kappa", ["compute", "kappa", model, "Ni", "--supercell", "3",
                       "3", "3", "--equil-steps", "100", "--steps", "200",
                       "--sample", "5", "-o", "kappa.csv"]),
            ("fe", ["compute", "fe", model, "Ni", "--supercell", "3", "3",
                    "3", "--n-lambda", "2", "--equil-steps", "50",
                    "--steps", "100"])):
        fused.reset_launch_counts()
        rec = _timed_verb(label, main, argv, work / label, times)
        launched = _launched({})
        numbers = [float(x) for x in split_numbers(rec["stdout"])[1]]
        print(f"  (e) {label} mleam_ni: launches {launched}; "
              f"{rec['stdout'].strip().splitlines()[-1]}")
        if any(launched.values()) or not np.all(np.isfinite(numbers)):
            raise AssertionError(f"{label}: launches {launched}, numbers "
                                 f"{numbers}")


def cli_tensordb(work, card, times) -> None:
    """(f) python -m tensoralloy_tpu_torch.tensordb through the pipeline
    on synthetic VASP outputs: host code only."""
    root = work / "tensordb"
    module = "tensoralloy_tpu_torch.tensordb"

    def run(argv):
        t0 = time.perf_counter()
        proc, imports = _module_run(module, argv, root)
        times.append((f"python -m {module} {' '.join(argv)}",
                      time.perf_counter() - t0, imports))
        return proc.returncode

    rcs = tensordb_workflow(run, root, calculators=("calc",))
    gathered = (root / "gathered.extxyz").read_text() \
        if (root / "gathered.extxyz").exists() else ""
    jobs = sorted(root.glob("calc/*atoms/group*/task*"))
    n_frames = gathered.count("Lattice=")
    print(f"  (f) tensordb: {len(rcs)} runs of python -m "
          f"tensoralloy_tpu_torch.tensordb, exit codes {rcs}; {len(jobs)} "
          f"recompute jobs, {n_frames} converged structures gathered")
    if any(rcs) or not jobs or n_frames != len(jobs) - len(jobs) // 3:
        raise AssertionError(f"tensordb: {rcs}, {len(jobs)} jobs, "
                             f"{n_frames} gathered")


def cli(card):
    """The command lines on the default device (cuda), each part with the
    launch counts reset before it and read after it. -> launches by
    kernel over the phase."""
    phase("cli")
    t0 = time.perf_counter()
    times = []
    totals = {"g2": 0, "g4": 0, "grap": 0}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        a = cli_experiment(work, card, times)
        _add_launches(totals, a["launches"])
        _add_launches(totals, cli_sf_verbs(work, a["exported"], a["twin"],
                                           card, times))
        _add_launches(totals, cli_grap_verbs(work, card, times))
        cli_f64(work, card, times)
        cli_eam(work, card, times)
        cli_tensordb(work, card, times)
    print(f"  wall time a verb ({card}):")
    for label, sec, imports in times:
        split = ("in this process" if imports is None else
                 f"imports {imports:.2f} s (-X importtime) + the rest "
                 f"(interpreter, CUDA and the verb) {sec - imports:.2f} s")
        print(f"    {label}: {sec:.2f} s, {split}")
    print(f"  launches over the cli phase: {totals}")
    print(f"  cli phase {time.perf_counter() - t0:.1f} s")
    return totals


# ----------------------------------------------------------------------
# descriptors: the flat ('segment') layout, legacy GRAP and the 'nn'
# filter, the descriptor heat flux, the chunked committee
# ----------------------------------------------------------------------

# fcc repeats of the segment requests: 108 and 4000 atoms on the host
# lists, 32000 atoms (GRAP only: "auto" sends an angular featurizer to
# the host lists) on the device builder
SEGMENT_REQUEST_REPS = {"sf": (3, 10), "grap": (3, 10, 20)}
SEGMENT_TRAIN_F32_STEPS = 5
LEGACY_NN_FIXTURE = DATA / "torch_port_ref_grap_legacy_nn.json"
# the float64 NVE of the 108-atom fixture cell with the flux, on the
# segment copy of snap_ni_sfa (`python -m tests.test_torch_heatflux`)
HEAT_FLUX_FIXTURE = DATA / "torch_port_ref_heat_flux_sf.json"
HEAT_FLUX_RUN = dict(timestep=1.0, chunk_size=5, temperature=300.0, seed=3)
HEAT_FLUX_STEPS = 10
HEAT_FLUX_REL = 1e-9
COMMITTEE_CHUNK_ROWS = 1024


def segment_model_file(model_path, workdir, float64=False) -> str:
    """A copy of a saved descriptor model whose descriptor says
    'segment' (its weights cast to float64 where asked)."""
    workdir = Path(workdir)
    source = str(model_path)
    if float64:
        source = float64_copy(model_path, workdir / "f64_source.npz")
    return backend_copy(source, workdir / f"segment_{Path(model_path).name}",
                        "segment")


def _peak_mib(fn) -> float:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2 ** 20


def descriptors_serving(card) -> dict:
    """(a) snap_Ni_sfa and snap_Ni (v5_readapt) loaded with
    backend="segment": every request against the same model on 'pallas'
    (the kernels) and 'dense' (the twins), float32 to 1e-4; the segment
    route launches no kernel; the float64 108-atom request against the
    JAX fixture (1e-10); each request's time split and peak memory beside
    the kernels' and the twins'. -> launches of the pallas requests."""
    from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
    from tensoralloy_tpu_torch.ops import fused
    totals = {}
    for name in ("sf", "grap"):
        model, kernels, fixture = PATHS[name]
        calcs = {b: TensorAlloyCalculator(str(model), dtype="medium",
                                          backend=b)
                 for b in ("segment", "pallas", "dense")}
        seg = calcs["segment"]
        if seg.device.type != "cuda" or seg.layout != "segment":
            raise AssertionError(f"{name}: {seg.device}, {seg.layout}")
        structures = [_fixture(fixture)[0]] + [
            _structure(r) for r in SEGMENT_REQUEST_REPS[name][1:]]
        for s in structures:
            device = seg._use_device_nl(s)
            before = dict(fused.launch_counts)
            res = seg.calculate(s)
            if any(_launched(before).values()):
                raise AssertionError(f"{name} segment launched a kernel")
            before = dict(fused.launch_counts)
            res_k = calcs["pallas"].calculate(s)
            launched = _launched(before)
            _add_launches(totals, launched)
            res_t = calcs["dense"].calculate(s)
            errs = {"kernels": efs_errors(res, res_k),
                    "twins": efs_errors(res, res_t)}
            fsum = float(np.max(np.abs(res["forces"].sum(axis=0))))
            fmax = float(np.max(np.abs(res["forces"])))
            print(f"  {name} segment {len(s)} atoms"
                  f"{' (device lists)' if device else ''}: E "
                  f"{res['energy']:.6f} eV, |sum F| {fsum:.2e}; vs "
                  f"{json.dumps(errs)}; pallas launches {launched}")
            if max(max(e.values()) for e in errs.values()) > F32_REL \
                    or any(launched[k] != 1 for k in kernels) \
                    or fsum > 1e-5 * fmax * np.sqrt(len(s)):
                raise AssertionError(f"{name} {len(s)}: {errs}, {launched}")
            if name == "grap" and len(s) > 10000 and not device:
                raise AssertionError("32000 atoms: auto did not take the "
                                     "device builder")
        s, ref = _fixture(fixture)
        calc64 = TensorAlloyCalculator(str(model), dtype="high",
                                       backend="segment")
        errs64 = efs_errors(calc64.calculate(s), ref)
        print(f"  {name} segment float64 {len(s)} atoms vs the JAX "
              f"fixture: {json.dumps(errs64)}")
        if max(errs64.values()) > F64_REL:
            raise AssertionError(f"{name} segment disagrees with JAX")
        for s in structures:
            reps = 3 if len(s) < 10000 else 2
            for backend in ("segment", "pallas", "dense"):
                calc = calcs[backend]
                t_req, split, t_dev = _timed_request(calc, s, reps)
                peak = _peak_mib(lambda: calc.calculate(s))
                print(f"  {name} {backend} request {len(s)} atoms: "
                      f"{t_req:.2f} ms, {split}, device E/F/S "
                      f"{t_dev:.2f} ms (medians of {reps}); peak memory "
                      f"allocated {peak:.1f} MiB ({card})")
    return totals


def _both_layouts(manager, workdir):
    """The manager's database featurized once at float64 in both layouts
    (the flat arrays and the dense rows with their transpose tables) ->
    (flat, dense) splits (train features, labels, test features,
    labels), each without the other layout's arrays, and the seconds."""
    from tensoralloy_tpu_torch.train.dataset import Dataset
    ds = manager.dataset
    both = Dataset(ds.db, ds.featurizer, name=ds.name,
                   test_size=ds.test_size, seed=ds.seed, dtype=np.float64,
                   cache_dir=str(workdir), layout="both", transpose=True)
    t0 = time.perf_counter()
    arrays = both.split(*both.build())
    seconds = time.perf_counter() - t0

    def keep(is_flat):
        return tuple({k: v for k, v in a.items()
                      if not (k.startswith(("pair_", "trip_"))
                              and k.endswith("_d") == is_flat)}
                     for a in arrays)

    return keep(True), keep(False), seconds


def descriptors_training(workdir, card) -> dict:
    """(b) both training configurations at full width with backend
    'segment' on snap-Ni.db: float64 steps against the JAX trainer's
    fixture (every loss and the first gradient norm, 1e-8: the same math
    as the dense layout's), then float32 steps against the pallas route
    of the same run (1e-4), and each step's time beside the kernels'
    and the twins'. -> launches of the pallas run."""
    from tensoralloy_tpu_torch.ops import fused
    from tensoralloy_tpu_torch.io.model import load_model
    from tensoralloy_tpu_torch.train.dataset import batch_index_stream
    from tensoralloy_tpu_torch.train.optim import global_norm
    from tensoralloy_tpu_torch.utils import tree_map
    totals = {}
    for name, cfg in TRAIN_CONFIGS.items():
        fixture = json.loads(
            (DATA / f"torch_port_ref_train_{name}.json").read_text())
        work = Path(workdir) / f"segment_{name}"
        work.mkdir()
        m64 = _manager(cfg, work, "high", "segment", cfg["fixture_steps"])
        t64 = m64.trainer
        if m64.dataset.layout != "segment":
            raise AssertionError(f"{name}: the manager's layout is "
                                 f"{m64.dataset.layout}")
        arrays, dense, build_s = _both_layouts(m64, work / "both")
        saved = load_model(str(ROOT / cfg["model"]), dtype="high")[0] \
            .param_tree()
        params0 = saved if cfg["warm_start"] else seeded_params(
            tree_map(lambda x: x.cpu().numpy(), saved),
            t64.train_parameters.seed)
        bs, seed = t64.train_parameters.batch_size, \
            t64.train_parameters.seed
        first = next(batch_index_stream(len(arrays[1]["energy"]), bs,
                                        seed=seed, repeat=True))
        (_, _), grads = t64.loss_and_grads(
            t64._tree_to_device(params0),
            t64._to_device({k: v[first] for k, v in arrays[0].items()}),
            t64._to_device({k: v[first] for k, v in arrays[1].items()}), 0)
        gnorm = float(global_norm(grads))
        gerr = abs(gnorm - fixture["grad_norm_first_step"]) \
            / fixture["grad_norm_first_step"]
        _, losses64, _ = _fit_losses(t64, arrays, params0)
        _check_losses(f"train_{name} segment float64 vs the JAX fixture",
                      losses64, fixture["losses"], TRAIN_F64_REL)
        grad_rel = (TRAIN_F64_WARM_GRAD_REL if cfg["warm_start"]
                    else TRAIN_F64_REL)
        print(f"  first-step gradient norm {gnorm:.10g}: rel err "
              f"{gerr:.2e} (limit {grad_rel:g}); both layouts of "
              f"{len(m64.db)} structures featurized in {build_s:.1f} s "
              f"(flat pairs {arrays[0]['pair_i'].shape[1]}"
              + (f", triples {arrays[0]['trip_i'].shape[1]}"
                 if "trip_i" in arrays[0] else "") + f") ({card})")
        if gerr > grad_rel:
            raise AssertionError(f"train_{name} segment gradient norm")
        steps = SEGMENT_TRAIN_F32_STEPS
        t32 = _manager(cfg, work, "medium", "segment", steps).trainer
        params_init = t32.init_params(arrays[0], verbose=False)
        before = dict(fused.launch_counts)
        _, losses, seconds = _fit_losses(t32, arrays, params_init,
                                         timed=True)
        if any(_launched(before).values()):
            raise AssertionError("the segment trainer launched a kernel")
        k32 = _manager(cfg, work, "medium", "pallas", steps).trainer
        before = dict(fused.launch_counts)
        _, losses_k, seconds_k = _fit_losses(k32, dense, params_init,
                                             timed=True)
        launched = _launched(before)
        _add_launches(totals, launched)
        _check_losses(f"train_{name} float32, segment vs pallas",
                      losses, losses_k, TRAIN_F32_REL_FIRST)
        twin = _manager(cfg, work, "medium", "dense", steps).trainer
        _, _, seconds_t = _fit_losses(twin, dense, params_init, timed=True)

        def spread(sec):
            ms = 1e3 * np.asarray(sec[1:])
            return (f"{np.median(ms):.2f} ms ({ms.min():.2f}–"
                    f"{ms.max():.2f})")

        print(f"  train_{name} float32 step, median (min–max) of "
              f"{steps - 1} after 1: segment {spread(seconds)}, pallas "
              f"{spread(seconds_k)}, dense {spread(seconds_t)}; pallas "
              f"launches {launched} ({card})")
        if any(launched[k] != steps for k in cfg["kernels"]):
            raise AssertionError(f"pallas launches {launched}")
    return totals


def _legacy_nn_batch(manager):
    """The first training batch of `manager`'s run, featurized alone
    with the dataset's padding (the rows its full build would give)."""
    from tensoralloy_tpu_torch.train.dataset import batch_index_stream
    from tensoralloy_tpu_torch.transform.featurizer import batch_features
    ds, tp = manager.dataset, manager.train_parameters
    train_idx, _ = ds.split_indices(len(ds.db))
    first = next(batch_index_stream(len(train_idx), tp.batch_size,
                                    seed=tp.seed, repeat=True))
    pairs = [ds._featurize_one(ds.db.get(int(i) + 1))
             for i in train_idx[first]]
    return (batch_features([p[0] for p in pairs]),
            batch_features([p[1] for p in pairs]))


def descriptors_legacy_nn(workdir, card) -> None:
    """(c) the committed JAX-saved legacy and 'nn' models at the
    snap_ni_v5_readapt width: float64 E/F/S of the 108-atom cell against
    the JAX fixture (1e-10) on every backend the model takes; the 'nn'
    model on 'pallas' launches no kernel and equals its dense route; a
    float64 train step (loss and every leaf's gradient norm, the
    filter's included) against the JAX trainer's (1e-8)."""
    from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
    from tensoralloy_tpu_torch.io.model import load_model
    from tensoralloy_tpu_torch.ops import fused
    from tensoralloy_tpu_torch.train.manager import TrainingManager
    from tensoralloy_tpu_torch.utils import tree_flatten
    record = json.loads(LEGACY_NN_FIXTURE.read_text())
    s, _ = _fixture(PATHS["grap"][2])
    for name, overrides in LEGACY_NN_CONFIGS.items():
        want = record[name]
        path = str(ROOT / LEGACY_NN_FILES[name])
        backends = ("segment",) if name == "legacy" else (
            "segment", "dense", "pallas")
        for backend in backends:
            calc = TensorAlloyCalculator(path, dtype="high", backend=backend)
            before = dict(fused.launch_counts)
            errs = efs_errors(calc.calculate(s), want)
            launched = _launched(before)
            print(f"  {name} {backend} float64 {len(s)} atoms vs the JAX "
                  f"fixture: {json.dumps(errs)}; launches {launched}")
            if max(errs.values()) > F64_REL or any(launched.values()):
                raise AssertionError(f"{name} {backend}: {errs}")
        if name == "nn":
            got = {b: TensorAlloyCalculator(path, dtype="medium",
                                            backend=b).calculate(s)
                   for b in ("pallas", "dense")}
            errs = efs_errors(got["pallas"], got["dense"])
            print(f"  nn float32 pallas vs dense: {json.dumps(errs)}")
            if max(errs.values()) > 1e-12:
                raise AssertionError("the 'nn' filter on 'pallas' is not "
                                     "its dense route")
        work = Path(workdir) / f"legacy_nn_{name}"
        work.mkdir()
        manager = TrainingManager(experiment_config(
            "snap_ni_v5_readapt", work, {
                "precision": "high", "train.train_steps": 1,
                "train.scan_steps": 1, "train.eval_steps": 10 ** 9,
                "train.log_steps": 10 ** 9, "train.final_f32_steps": 0,
                **overrides}, database=TRAIN_DB))
        model = load_model(path, dtype="high")[0]
        if manager.model.as_dict() != model.as_dict():
            raise AssertionError(f"{name}: the manager builds another model")
        t0 = time.perf_counter()
        feats, labels = _legacy_nn_batch(manager)
        t = manager.trainer
        (loss, _), grads = t.loss_and_grads(
            model.param_tree(), t._to_device(feats), t._to_device(labels), 0)
        norms = {k: float(torch.linalg.vector_norm(v))
                 for k, v in tree_flatten(grads).items()}
        top = max(want["grad_norms"].values())
        gerr = max(abs(norms[k] - v) for k, v in want["grad_norms"].items())
        lerr = abs(float(loss) - want["loss_first_step"]) \
            / abs(want["loss_first_step"])
        filt = {k: v for k, v in norms.items() if k.startswith("descriptor")}
        print(f"  {name} float64 train step on the first batch "
              f"({len(labels['energy'])} structures): loss "
              f"{float(loss):.10g}, rel err {lerr:.2e}; gradient norms "
              f"of {len(norms)} leaves, worst error {gerr / top:.2e} of "
              f"the largest ({len(filt)} of the filter's); "
              f"{time.perf_counter() - t0:.1f} s ({card})")
        if set(norms) != set(want["grad_norms"]) or lerr > TRAIN_F64_REL \
                or gerr > TRAIN_F64_REL * top \
                or (name == "nn" and not (filt and min(filt.values()) > 0)):
            raise AssertionError(f"{name} train step disagrees with JAX")


def descriptors_heat_flux(workdir, card, times) -> None:
    """(d) the segment copy of snap_ni_sfa (float64 weights): NVE of the
    108-atom fixture cell recording the flux, against the JAX fixture
    (1e-9); atomic virials that sum to the total virial; `python -m
    tensoralloy_tpu_torch.cli compute kappa` on it, exit 0."""
    from tensoralloy_tpu_torch.analysis.heatflux import (
        make_atomic_virial_fn)
    from tensoralloy_tpu_torch.dynamics import VelocityVerlet
    from tensoralloy_tpu_torch.io.model import load_model
    from tensoralloy_tpu_torch.nn.fields import make_efs_fn
    from tensoralloy_tpu_torch.ops import fused
    path = segment_model_file(PATHS["sf"][0], workdir, float64=True)
    model, _ = load_model(path, dtype="high")
    s, _ = _fixture(PATHS["sf"][2])
    ref = json.loads(HEAT_FLUX_FIXTURE.read_text())
    before = dict(fused.launch_counts)
    t0 = time.perf_counter()
    h = VelocityVerlet(model, s, record_heat_flux=True,
                       **HEAT_FLUX_RUN).run(HEAT_FLUX_STEPS)
    sec = time.perf_counter() - t0
    errs = {k: rel_err(h[k], ref[k]) for k in ("heat_flux", "potential",
                                               "total")}
    print(f"  NVE of {len(s)} atoms, {HEAT_FLUX_STEPS} steps, float64, "
          f"flux at every chunk end vs the JAX fixture: {json.dumps(errs)}"
          f" (limit {HEAT_FLUX_REL:g}); {sec:.2f} s ({card})")
    if max(errs.values()) > HEAT_FLUX_REL or any(_launched(before).values()):
        raise AssertionError("the descriptor heat flux disagrees")
    m = model.clone_for(Counter(s.symbols))
    feats = {k: torch.as_tensor(v, device="cuda") for k, v in
             m.featurizer.featurize(s, m.featurizer.make_vap(s),
                                    layout="segment").items()}
    w = make_atomic_virial_fn(m)(feats)
    total = make_efs_fn(m.energy_and_aux)(feats)["virial"]
    err = rel_err(w["atomic_virials"].sum(0).cpu(), total.cpu())
    print(f"  atomic virials: {tuple(w['atomic_virials'].shape)}, their "
          f"sum vs the total virial {err:.2e}")
    if err > 1e-10:
        raise AssertionError("the atomic virials do not sum to the virial")
    out = _subprocess_verb(
        "compute kappa (segment SF)", "tensoralloy_tpu_torch.cli",
        ["compute", "kappa", path, "Ni", "--supercell", "2", "2", "2",
         "--equil-steps", "10", "--steps", "20", "--sample", "5", "-o",
         str(Path(workdir) / "kappa.csv")], workdir, times)
    print("  " + out.strip().splitlines()[-1])


def descriptors_committee(card) -> dict:
    """(e) the 5 MoNi GRAP members (pallas) at 4000 atoms with
    chunked=True in blocks of COMMITTEE_CHUNK_ROWS rows against
    chunked=False (1e-4): grap_kernel once a row block."""
    from tensoralloy_tpu_torch.ensemble import EnsembleCalculator
    from tensoralloy_tpu_torch.ops import fused
    paths = [str(p) for p in MONI_MEMBERS]
    s = _moni_structure()
    mono = EnsembleCalculator(paths, dtype="medium", backend="pallas",
                              chunked=False)
    chunked = EnsembleCalculator(paths, dtype="medium", backend="pallas",
                                 chunked=True,
                                 chunk_size=COMMITTEE_CHUNK_ROWS)
    want = mono.calculate(s)
    before = dict(fused.launch_counts)
    got = chunked.calculate(s)
    launched = _launched(before)
    blocks = -(-chunked._get_vap(s).n_atoms_vap // COMMITTEE_CHUNK_ROWS)
    errs = efs_errors(got, want)
    errs["energy_std"] = rel_err(got["energy_std"], want["energy_std"])
    errs["forces_std"] = rel_err(got["forces_std"], want["forces_std"])
    t_c = _median_host_ms(lambda: chunked.calculate(s), 3)
    t_m = _median_host_ms(lambda: mono.calculate(s), 3)
    p_c = _peak_mib(lambda: chunked.calculate(s))
    p_m = _peak_mib(lambda: mono.calculate(s))
    print(f"  moni committee, {len(paths)} members, {len(s)} atoms, "
          f"chunked ({blocks} row blocks of {COMMITTEE_CHUNK_ROWS}) vs "
          f"monolithic: {json.dumps(errs)}; grap_kernel launches "
          f"{launched['grap']} ({launched['grap'] / blocks:g} a row "
          f"block); request {t_c:.1f} ms chunked, {t_m:.1f} ms monolithic; "
          f"peak memory {p_c:.1f} / {p_m:.1f} MiB ({card})")
    if max(errs.values()) > F32_REL or launched["grap"] != blocks \
            or launched["g2"] or launched["g4"]:
        raise AssertionError(f"chunked committee: {errs}, {launched}")
    return launched


def descriptors(card):
    """The descriptor paths of the flat layout, legacy GRAP and the 'nn'
    filter, the descriptor heat flux and the chunked committee, each
    part with the launch counts reset before it and read after it. ->
    launches by kernel over the phase."""
    phase("descriptors")
    from tensoralloy_tpu_torch.ops import fused
    t0 = time.perf_counter()
    totals = {"g2": 0, "g4": 0, "grap": 0}
    times = []
    with tempfile.TemporaryDirectory() as tmp:
        for label, part in (
                ("a serving", lambda: descriptors_serving(card)),
                ("b training", lambda: descriptors_training(tmp, card)),
                ("c legacy + nn", lambda: descriptors_legacy_nn(tmp, card)),
                ("d heat flux", lambda: descriptors_heat_flux(tmp, card,
                                                              times)),
                ("e committee", lambda: descriptors_committee(card))):
            print(f"  -- {label}")
            fused.reset_launch_counts()
            t1 = time.perf_counter()
            part()
            _add_launches(totals, dict(fused.launch_counts))
            print(f"  {label}: {time.perf_counter() - t1:.1f} s")
    for label, sec, imports in times:
        print(f"  {label}: {sec:.2f} s, imports {imports:.2f} s")
    print(f"  launches over the descriptors phase: {totals}")
    print(f"  descriptors phase {time.perf_counter() - t0:.1f} s")
    return totals


# ----------------------------------------------------------------------
# parallel
# ----------------------------------------------------------------------

PARALLEL_RANKS = 2
PARALLEL_BATCH = 50        # snap_ni_sfa's file says 25: no even split
PARALLEL_F32_STEPS = 3
PARALLEL_F64_REL = 1e-10   # two ranks against one, float64
PARALLEL_F32_REL = 1e-5    # float32 train losses, two ranks against one
PARALLEL_NCCL_REL = 1e-12  # a world of one NCCL rank against no group
PARALLEL_NEB = dict(n_images=8, steps=10, chunk_size=5)
PARALLEL_MEMBERS = 4
PARALLEL_SPATIAL = (("mleam_ni Ni 32000 flat (device builder)", "mleam_ni",
                     "segment", 20),
                    ("mleam_ni Ni 32000 fast dense", "mleam_ni", "fast", 20),
                    ("mladp_mo_v5 Mo 31250 fast dense", "mladp_mo_v5",
                     "fast", 25))


def _parallel_train_specs(work) -> dict:
    """name -> (float64 spec of one step, float32 spec of
    PARALLEL_F32_STEPS steps) of `parallel.ranks.train_steps` for each
    training configuration at batch PARALLEL_BATCH: the manager's model
    (saved with its starting parameters, as the train phase starts them)
    and loss on the run's dataset, the first batches of its seeded
    stream, through the kernels."""
    import dataclasses
    from tensoralloy_tpu_torch.io.model import load_model, save_model
    from tensoralloy_tpu_torch.train.dataset import batch_index_stream
    from tensoralloy_tpu_torch.utils import tree_map
    specs = {}
    for name, cfg in TRAIN_CONFIGS.items():
        (work / name).mkdir()
        m = _manager(cfg, work / name, "high", "pallas", 10)
        t0 = time.perf_counter()
        arrays = m.dataset.split(*m.dataset.build())
        tp = dataclasses.replace(m.train_parameters,
                                 batch_size=PARALLEL_BATCH)
        saved = tree_map(lambda x: x.cpu().numpy(), load_model(
            str(ROOT / cfg["model"]), dtype="high")[0].param_tree())
        params = saved if cfg["warm_start"] else seeded_params(saved,
                                                               tp.seed)
        path = str(work / f"{name}.npz")
        save_model(path, m.model, params)
        stream = batch_index_stream(len(arrays[1]["energy"]), tp.batch_size,
                                    seed=tp.seed, repeat=True)
        batches = [({k: v[i] for k, v in arrays[0].items()},
                    {k: v[i] for k, v in arrays[1].items()})
                   for i in (next(stream)
                             for _ in range(PARALLEL_F32_STEPS))]
        print(f"  train_{name}: dataset of {len(arrays[1]['energy'])} "
              f"structures built in {time.perf_counter() - t0:.1f} s; "
              f"batch {tp.batch_size}")
        base = {"model": path, "backend": "pallas", "params": params,
                "loss_parameters": m.loss_parameters,
                "opt_parameters": m.opt_parameters, "train_parameters": tp,
                "minimize_properties": m.trainer.minimize, "device": "cuda"}
        specs[name] = (dict(base, dtype="high", batches=batches[:1]),
                       dict(base, dtype="medium", batches=batches))
    return specs


def _parallel_specs(work) -> dict:
    """label -> (rank function, spec) of every sharded case of (b)."""
    from tensoralloy_tpu_torch.parallel import ranks
    specs = {}
    for name, (f64, f32) in _parallel_train_specs(work).items():
        specs[f"train_{name} float64"] = (ranks.train_steps, f64)
        specs[f"train_{name} float32"] = (ranks.train_steps, f32)
    for label, model, route, reps in PARALLEL_SPATIAL:
        path, kind, element, a = EAM_PATHS[model][:4]
        specs[label] = (ranks.spatial_efs, {
            "model": str(path), "route": route,
            "structure": _lattice_structure(kind, element, a, reps),
            "reps": 3, "device": "cuda", "dtype": "medium"})
    initial, final = _vacancy_hop(NEB_REPS)
    specs["grap band"] = (ranks.neb_band, {
        "model": str(PATHS["grap"][0]), "backend": "pallas",
        "initial": initial, "final": final, "n_shards": PARALLEL_RANKS,
        "device": "cuda", "dtype": "medium", **PARALLEL_NEB})
    specs["moni committee"] = (ranks.committee, {
        "members": MONI_MEMBERS[:PARALLEL_MEMBERS],
        "structure": _moni_structure(), "n_shards": PARALLEL_RANKS,
        "backend": "pallas", "reps": 3, "device": "cuda",
        "dtype": "medium"})
    return specs


def _one_rank(spec) -> dict:
    """`spec` on this process alone."""
    return dict(spec, n_shards=1, n_devices=None)


def _parallel_numbers(fn, out) -> dict:
    """The numbers of a rank function's result that two runs compare."""
    from tensoralloy_tpu_torch.parallel import ranks
    if fn is ranks.train_steps:
        return {"losses": out["losses"], "params": out["params"]}
    if fn is ranks.spatial_efs:
        return {k: out[k] for k in ("energy", "forces", "stress_voigt")}
    if fn is ranks.neb_band:
        return {"energies": out["result"]["energies"],
                "positions": out["positions"]}
    return {k: out["results"][k] for k in (
        "energy", "forces", "stress", "energy_std", "forces_std")}


def _parallel_err(fn, got, want) -> float:
    from tensoralloy_tpu_torch.utils import tree_flatten
    a, b = (tree_flatten(_parallel_numbers(fn, r)) for r in (got, want))
    return max(rel_err(np.asarray(a[k], np.float64),
                       np.asarray(b[k], np.float64)) for k in b)


def _parallel_limit(label) -> float:
    if "float64" in label:
        return PARALLEL_F64_REL
    return PARALLEL_F32_REL if "float32" in label else F32_REL


def parallel_nccl(specs, refs, card) -> dict:
    """(a) a world of one rank with NCCL on a HashStore, in this process:
    one case of each mode through the NCCL communicator, against its run
    without a group. -> launches."""
    import torch.distributed as dist
    from tensoralloy_tpu_torch.parallel.mesh import to_host
    labels = ("train_sf float64", PARALLEL_SPATIAL[1][0], "grap band",
              "moni committee")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    totals = {"g2": 0, "g4": 0, "grap": 0}
    try:
        print(f"  (a) backend {dist.get_backend()}, world "
              f"{dist.get_world_size()} ({card})")
        for label in labels:
            fn, spec = specs[label]
            t0 = time.perf_counter()
            got = to_host(fn(dict(spec, n_shards=1, n_devices=None)))
            _add_launches(totals, got["launches"])
            err = _parallel_err(fn, got, refs[label])
            print(f"    {label}: {time.perf_counter() - t0:.2f} s, vs no "
                  f"group rel err {err:.1e} (limit {PARALLEL_NCCL_REL:g}); "
                  f"launches {got['launches']}")
            if err > PARALLEL_NCCL_REL:
                raise AssertionError(f"NCCL {label}: {err}")
    finally:
        dist.destroy_process_group()
    return totals


def parallel_ranks(specs, refs, card) -> dict:
    """(b) every case on PARALLEL_RANKS gloo ranks sharing the card,
    against its one-rank run. -> launches summed over the ranks."""
    from tensoralloy_tpu_torch.parallel import ranks
    from tensoralloy_tpu_torch.parallel.mesh import launch
    labels = list(specs)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results = launch(ranks.run_all, PARALLEL_RANKS,
                     [specs[label] for label in labels], device="cuda",
                     timeout=900.0)
    print(f"  (b) {PARALLEL_RANKS} ranks: {time.perf_counter() - t0:.1f} s "
          f"from spawn to the last result ({card})")
    totals = {"g2": 0, "g4": 0, "grap": 0}
    for i, label in enumerate(labels):
        fn = specs[label][0]
        per_rank = [r[i] for r in results]
        for r in per_rank:
            _add_launches(totals, r["launches"])
        agree = max(_parallel_err(fn, r, per_rank[0]) for r in per_rank)
        err = _parallel_err(fn, per_rank[0], refs[label])
        limit = _parallel_limit(label)
        got, ref = per_rank[0], refs[label]
        if fn is ranks.train_steps:
            # the float32 runs' last two steps are warm; float64's one
            # step is not
            times = (f"steps {np.round(got['step_ms'], 2).tolist()} ms at "
                     f"{PARALLEL_RANKS} ranks against "
                     f"{np.round(ref['step_ms'], 2).tolist()} on one; "
                     f"gradient all-reduce {got['allreduce_ms']:.3f} ms")
        elif fn is ranks.neb_band:
            times = (f"{got['ms']:.0f} ms for {got['evaluations']} band "
                     f"evaluations against {ref['ms']:.0f} on one")
        else:
            times = (f"{np.median(got['ms']):.2f} ms a request against "
                     f"{np.median(ref['ms']):.2f} on one")
        print(f"    {label}: ranks agree {agree:.1e}; vs one rank rel err "
              f"{err:.1e} (limit {limit:g}); {times}; launches a rank "
              f"{[r['launches'] for r in per_rank]} ({card})")
        if err > limit or agree > limit:
            raise AssertionError(f"parallel {label}: {err}, {agree}")
    fixture = json.loads((DATA / "torch_port_ref_train_grap.json")
                         .read_text())
    i = labels.index("train_grap float64")
    got = results[0][i]["losses"][0]
    err = abs(got - fixture["losses"][0]) / abs(fixture["losses"][0])
    print(f"    train_grap float64 first loss {got:.12g} vs the JAX "
          f"fixture {fixture['losses'][0]:.12g}: rel err {err:.1e} "
          f"(limit {TRAIN_F64_REL:g}; train_sf's fixture is of batch 25)")
    if fixture["batch_size"] != PARALLEL_BATCH or err > TRAIN_F64_REL:
        raise AssertionError(f"train_grap vs its fixture: {err}")
    return totals


def parallel_verb(work, card) -> None:
    """(c) `compute neb --shards 2` under `python -m
    torch.distributed.run` against the unsharded verb in this process."""
    from tensoralloy_tpu_torch.cli.entry import main as port_main
    from tensoralloy_tpu_torch.io.extxyz import write_extxyz
    model = work / "grap_pallas.npz"
    pallas_copy(PATHS["grap"][0], model)
    initial, final = _vacancy_hop(NEB_REPS)
    argv = ["compute", "neb", str(model), "initial.extxyz", "final.extxyz",
            "--n-images", str(PARALLEL_NEB["n_images"]), "--max-steps",
            str(PARALLEL_NEB["steps"]), "--output", "neb.csv"]
    runs = {}
    for name in ("ranks", "one"):
        (work / name).mkdir()
        write_extxyz(str(work / name / "initial.extxyz"), [initial])
        write_extxyz(str(work / name / "final.extxyz"), [final])
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(PARALLEL_RANKS), "-m",
         "tensoralloy_tpu_torch.cli", *argv, "--shards",
         str(PARALLEL_RANKS)], cwd=work / "ranks",
        env={"GLOO_SOCKET_IFNAME": "lo", **os.environ,
             "PYTHONPATH": str(ROOT)},
        capture_output=True, text=True, timeout=600)
    sec = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"torch.distributed.run: exit code "
                             f"{proc.returncode}\n{proc.stdout}\n"
                             f"{proc.stderr}")
    backends = sorted({f"backend {b} on {d}" for b, d in re.findall(
        r"backend (gloo|nccl) on (cpu|cuda)", proc.stderr)})
    runs["ranks"] = {"stdout": proc.stdout,
                     "csv": (work / "ranks" / "neb.csv").read_text()}
    t1 = time.perf_counter()
    rec = run_verb(port_main, argv, work / "one")
    one_sec = time.perf_counter() - t1
    runs["one"] = {"stdout": rec["stdout"],
                   "csv": (work / "one" / "neb.csv").read_text()}
    miss = [m for key in ("stdout", "csv") for m in printed_mismatches(
        runs["ranks"][key], runs["one"][key], F32_REL)]
    print(f"  (c) python -m torch.distributed.run --nproc_per_node "
          f"{PARALLEL_RANKS} -m tensoralloy_tpu_torch.cli compute neb "
          f"--shards {PARALLEL_RANKS}: {backends}; {sec:.1f} s (the "
          f"unsharded verb in this process {one_sec:.1f} s); printed lines "
          f"and neb.csv vs the unsharded verb: {len(miss)} numbers beyond "
          f"{F32_REL:g} of a line ({card})")
    print("    " + runs["ranks"]["stdout"].strip().replace("\n", "\n    "))
    if miss or "forward barrier" not in runs["ranks"]["stdout"]:
        raise AssertionError(f"sharded neb verb: {miss[:5]}")


def parallel(card):
    """`parallel/`: (a) a world of one NCCL rank, (b) two gloo ranks on
    the card through `launch`, (c) the verb under `torch.distributed.run`.
    -> launches by kernel of (a) and of every rank of (b)."""
    phase("parallel")
    from tensoralloy_tpu_torch.parallel.mesh import to_host
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        specs = _parallel_specs(work)
        t1 = time.perf_counter()
        refs = {label: to_host(fn(_one_rank(spec)))
                for label, (fn, spec) in specs.items()}
        print(f"  one-rank references: {time.perf_counter() - t1:.1f} s "
              f"({card})")
        totals = parallel_nccl(specs, refs, card)
        _add_launches(totals, parallel_ranks(specs, refs, card))
        parallel_verb(work, card)
    for kernel, n in totals.items():
        if n == 0:
            raise AssertionError(f"parallel: {kernel} never launched")
    print(f"  launches over the parallel phase (a and every rank of b): "
          f"{totals}")
    print(f"  parallel phase {time.perf_counter() - t0:.1f} s ({card})")
    return totals


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
    largest = _structure(TIMED_REPS)
    for name, (calc, twin, structures) in served.items():
        if name in ("sf", "grap"):
            structures = structures + [largest]
        for s in structures:
            reps = 5 if len(s) < 10000 else 3
            vap = calc._get_vap(s)
            device = calc._use_device_nl(s)
            t_req, split, t_k = _timed_request(calc, s, reps)
            feats = (calc.featurize_device(s, vap) if device
                     else calc.featurize(s, vap))
            t_t = _median_host_ms(
                lambda: twin._get_variant(s, device)[1](feats), reps)
            print(f"  {name} request {len(s)} atoms: {t_req:.2f} ms, "
                  f"{split}; device E/F/S {t_k:.2f} ms through the "
                  f"kernels, {t_t:.2f} ms through the twins (medians of "
                  f"{reps}; {card})")

    # each kernel at the main path's shapes: its largest request
    cases = kernel_cases(served["sf"][0], largest,
                         served["grap"][0], largest)
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
    # cuBLAS needs this to run under torch.use_deterministic_algorithms
    # (the train phase's bit-for-bit resume check)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    card = check_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build()
    check_native(card)
    check_kernels()
    served, launches = serve()
    measured, per_step = train(card)
    managed, manager_launches = manage(card)
    eam(card)
    _, large_launches = large(card)
    md_launches = md(card)
    analysis_launches = analysis(card)
    cli_launches = cli(card)
    descriptor_launches = descriptors(card)
    parallel_launches = parallel(card)
    for counts in [m["launches"] for m in measured.values()] \
            + [manager_launches, large_launches, md_launches,
               analysis_launches, cli_launches, descriptor_launches,
               parallel_launches]:
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    rows = time_path(card, served, launches)
    for row in rows:
        row["launches_per_train_step"] = per_step[row["name"]]
        row["cli"] = cli_launches[row["name"]]
        row["descriptors"] = descriptor_launches[row["name"]]
        row["parallel"] = parallel_launches[row["name"]]
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
