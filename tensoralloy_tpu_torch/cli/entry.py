"""`tensoralloy_tpu_torch` command line: the port of
`tensoralloy_tpu/cli/entry.py` (reference `tensoralloy/cli/entry.py`:
subcommands build / run / export / stop / evaluate / print / compute /
vasp2lammps), with the same verbs, arguments, printed lines and written
files.

    python -m tensoralloy_tpu_torch.cli <verb> ...

Device and precision: the JAX command line runs at its global float
policy (default 'medium', float32) on the platform that
``TENSORALLOY_TPU_PLATFORM`` names. This package has no global policy,
so `main` gives every calculator, model, ensemble, training manager and
evaluation it builds an explicit device and dtype:

* `device`: the card ("cuda") unless ``TENSORALLOY_TPU_PLATFORM`` says
  ``cpu`` (``cuda`` and ``gpu`` also give the card; any other value
  raises). "cuda" without a card raises where a verb first reaches the
  device: nothing falls back to the CPU.
* `dtype`: 'medium' (float32), as the JAX default policy; `run`,
  `export` and `evaluate` take the input file's `precision`, as both
  training managers do.

Several ranks: `compute neb --shards n` and a `run` whose file sets
`distribute.num_devices` run under ``python -m torch.distributed.run
--nproc_per_node n -m tensoralloy_tpu_torch.cli ...``; `main` joins the
launcher's group (`parallel.mesh.initialize_distributed`: NCCL with a
card per rank, gloo where ranks share one or on the CPU) and only rank 0
prints. Without a group of n ranks they raise the ValueError of too few
devices.

The keywords `main(argv, device=..., dtype=...)` are the counterpart of
a JAX caller's `set_precision(...)` before its `main`. The descriptor
kernels are reached through the model file: a model whose descriptor
says ``backend: "pallas"`` runs G2/G4/GRAP in the CUDA kernels, one that
says "dense" in their plain PyTorch twins (as the JAX command line runs
it through XLA).
"""
from __future__ import annotations

import argparse
import json
import os
import sys


PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


def platform_device(device=None) -> str:
    """The device the verbs run on: `device` where given, else the one
    ``TENSORALLOY_TPU_PLATFORM`` names, else the card."""
    if device is not None:
        return device
    platform = os.environ.get("TENSORALLOY_TPU_PLATFORM", "").strip()
    if not platform:
        return "cuda"
    if platform.lower() not in PLATFORMS:
        raise ValueError(
            f"TENSORALLOY_TPU_PLATFORM={platform!r}: this package runs on "
            f"one of {sorted(PLATFORMS)}")
    return PLATFORMS[platform.lower()]


def _placement(args) -> dict:
    """The device and dtype every model a verb loads is built in."""
    return {"device": args.device, "dtype": args.dtype}


def main(argv=None, *, device=None, dtype=None):
    device = platform_device(device)
    parser = argparse.ArgumentParser(
        prog="tensoralloy_tpu_torch",
        description="Neural-network interatomic potentials in PyTorch "
                    "and CUDA")
    sub = parser.add_subparsers(dest="command", required=True)

    p_build = sub.add_parser(
        "build", help="build a sqlite database from xyz/extxyz")
    p_build.add_argument("filename")
    p_build.add_argument("--output", default=None,
                         help="output db path (default: alongside input)")
    p_build.add_argument("--energy-unit", default="eV",
                         choices=["eV", "Hartree", "kcal/mol"])
    p_build.add_argument("--fmax", type=float, default=None,
                         help="drop structures with |F|max above this")
    p_build.add_argument("--vacuum", type=float, default=20.0)

    p_run = sub.add_parser("run", help="train a model from a TOML file")
    p_run.add_argument("filename")
    p_run.add_argument("--quiet", action="store_true")
    p_run.add_argument("--no-export", action="store_true")

    p_exp = sub.add_parser(
        "export", help="export a deployable model from a checkpoint")
    p_exp.add_argument("filename", help="TOML input file")
    p_exp.add_argument("--checkpoint", default=None)
    p_exp.add_argument("--no-ema", action="store_true")

    p_stop = sub.add_parser(
        "stop", help="stop a running experiment (pid from model_dir)")
    p_stop.add_argument("model_dir")

    p_eval = sub.add_parser(
        "evaluate",
        help="deployment-grade (exact-f32) per-group train/test MAEs "
             "of a run dir — the accuracy numbers to quote")
    p_eval.add_argument("workdir", nargs="?", default=".",
                        help="run dir containing input.toml + model/")
    p_eval.add_argument("--ckpt", default=None,
                        help="checkpoint file (default: newest)")
    p_eval.add_argument("--overall-only", action="store_true",
                        help="skip the per-source-group breakdown")
    p_eval.add_argument("--no-ema", action="store_true",
                        help="evaluate raw instead of EMA parameters")
    p_eval.add_argument("--output", default="group_maes.json",
                        help="JSON output (relative to workdir; "
                             "'-' = don't write)")

    p_print = sub.add_parser(
        "print", help="summarize a training history.json to CSV")
    p_print.add_argument("filename")
    p_print.add_argument("--output", default=None)

    p_comp = sub.add_parser("compute", help="analysis computations")
    comp_sub = p_comp.add_subparsers(dest="task", required=True)

    c_scatter = comp_sub.add_parser(
        "scatter", help="predicted-vs-label scatter data over a db")
    c_scatter.add_argument("model", help="saved model .npz")
    c_scatter.add_argument("db", help="sqlite database")
    c_scatter.add_argument("--output", default="scatter.csv")

    c_dbnum = comp_sub.add_parser("dbnum", help="db composition metrics")
    c_dbnum.add_argument("db")

    c_dbfstd = comp_sub.add_parser("dbfstd", help="db force std")
    c_dbfstd.add_argument("db")

    c_eos = comp_sub.add_parser("eos", help="E-V curve + EOS fit")
    c_eos.add_argument("model")
    c_eos.add_argument("crystal", help="cif/extxyz file of the crystal")
    c_eos.add_argument("--xlo", type=float, default=0.90)
    c_eos.add_argument("--xhi", type=float, default=1.10)
    c_eos.add_argument("--num", type=int, default=21)
    c_eos.add_argument("--eos", default="birchmurnaghan")
    c_eos.add_argument("--output", default=None)

    c_latt = comp_sub.add_parser(
        "latt", help="equilibrium lattice constant + bulk modulus "
                     "(EOS fit, native)")
    c_latt.add_argument("model")
    c_latt.add_argument("crystal")
    c_latt.add_argument("--xlo", type=float, default=0.94)
    c_latt.add_argument("--xhi", type=float, default=1.06)
    c_latt.add_argument("--num", type=int, default=13)
    c_latt.add_argument("--eos", default="birchmurnaghan")

    c_rx = comp_sub.add_parser(
        "relax", help="relax internal coordinates with the model "
                      "(fixed cell, FIRE); --cell also relaxes the "
                      "cell against the stress")
    c_rx.add_argument("model")
    c_rx.add_argument("structure")
    c_rx.add_argument("--fmax", type=float, default=0.02)
    c_rx.add_argument("--steps", type=int, default=500)
    c_rx.add_argument("--cell", action="store_true",
                      help="variable-cell relaxation (positions + "
                           "symmetric strain, one FIRE loop; ref "
                           "analog: LAMMPS fix box/relax)")
    c_rx.add_argument("--smax", type=float, default=0.05,
                      help="stress convergence (GPa, with --cell)")
    c_rx.add_argument("--pressure", type=float, default=0.0,
                      help="external pressure (GPa, with --cell): "
                           "relaxes the enthalpy E + PV")
    c_rx.add_argument("--hydrostatic", action="store_true",
                      help="volume-only (shape-preserving) cell "
                           "motion")
    c_rx.add_argument("-o", "--output", default="relaxed.extxyz")

    c_pct = comp_sub.add_parser(
        "percentile", help="per-atom |error| percentiles over a db")
    c_pct.add_argument("model")
    c_pct.add_argument("db")
    c_pct.add_argument("--q", type=float, nargs="+",
                       default=[50, 90, 95, 99])

    c_elastic = comp_sub.add_parser(
        "elastic", help="elastic constants of a crystal with a model")
    c_elastic.add_argument("model")
    c_elastic.add_argument("crystal")
    c_elastic.add_argument("--method", choices=["fit", "cdiff"],
                           default="fit",
                           help="'fit': symmetry-reduced least-squares "
                                "(reference protocol); 'cdiff': full "
                                "6x6 central differences")
    c_elastic.add_argument("--relax-ions", action="store_true",
                           help="relax internal coordinates under "
                                "each strain (relaxed-ion constants)")
    c_elastic.add_argument("--lattice", default=None,
                           help="override lattice-family detection")

    c_neb = comp_sub.add_parser(
        "neb", help="migration barrier: native on-device NEB "
                    "(climbing image, FIRE)")
    c_neb.add_argument("model")
    c_neb.add_argument("initial", help="initial endpoint structure")
    c_neb.add_argument("final", help="final endpoint structure")
    c_neb.add_argument("--n-images", type=int, default=9)
    c_neb.add_argument("--spring", type=float, default=5.0,
                       help="inter-replica spring constant (eV/A^2)")
    c_neb.add_argument("--no-climb", action="store_true")
    c_neb.add_argument("--fmax", type=float, default=0.05)
    c_neb.add_argument("--max-steps", type=int, default=1000)
    c_neb.add_argument("--relax-endpoints", action="store_true",
                       help="pre-relax both endpoints (fixed cell)")
    c_neb.add_argument("--output", default=None,
                       help="write per-image path energies as CSV")
    c_neb.add_argument("--shards", type=int, default=1,
                       help="shard the replica axis over this many "
                            "devices (LAMMPS -partition analog)")

    c_def = comp_sub.add_parser(
        "defect", help="point-defect formation energy: vacancy "
                       "(default) or interstitial (native relaxation, "
                       "no LAMMPS)")
    c_def.add_argument("model")
    c_def.add_argument("crystal")
    c_def.add_argument("--supercell", type=int, nargs=3,
                       default=[3, 3, 3])
    c_def.add_argument("--site", type=int, default=0,
                       help="atom index removed from the supercell")
    c_def.add_argument("--dipole", action="store_true",
                       help="also report the elastic dipole tensor "
                            "P = -V (sigma_def - sigma_bulk) of the "
                            "relaxed defect (fixed cell) and its "
                            "trace/3 -- the defect-strain coupling; "
                            "relaxation volume = tr(P)/(3B)")
    c_def.add_argument("--interstitial", type=float, nargs=3,
                       default=None, metavar=("FX", "FY", "FZ"),
                       help="ADD one atom at this fractional position "
                            "of the supercell instead of removing one "
                            "(e.g. 1/6 1/6 1/6 of a 3x3x3 fcc "
                            "supercell = octahedral site)")
    c_def.add_argument("--element", default=None,
                       help="interstitial species (default: host; the "
                            "chemical potential is the bulk "
                            "energy/atom, i.e. self-interstitial)")
    c_def.add_argument("--fmax", type=float, default=0.02)

    c_unc = comp_sub.add_parser(
        "uncertainty",
        help="rank frames by deep-ensemble committee disagreement "
             "(max per-atom force std) for active-learning selection")
    c_unc.add_argument("frames", help="extxyz or ase.db of candidates")
    c_unc.add_argument("models", nargs="+",
                       help=">= 2 saved model .npz files of ONE "
                            "architecture (different training seeds)")
    c_unc.add_argument("--top", type=int, default=0,
                       help="print only the top-N frames (0 = all)")
    c_unc.add_argument("--threshold", type=float, default=0.0,
                       help="only frames with score >= threshold eV/A")

    c_md = comp_sub.add_parser(
        "md", help="device-resident MD with a saved model: NVE "
                   "(default), Langevin NVT (--nvt), or Berendsen NPT "
                   "(--nvt + --npt); the whole integrator runs on the "
                   "accelerator (ref analog: export to LAMMPS and run "
                   "externally)")
    c_md.add_argument("model")
    c_md.add_argument("structure", help="extxyz/CIF file or built-in "
                                        "crystal name")
    c_md.add_argument("--steps", type=int, default=1000)
    c_md.add_argument("--timestep", type=float, default=1.0,
                      help="fs (default 1.0)")
    c_md.add_argument("--temp", type=float, default=None,
                      help="Maxwell-Boltzmann initial temperature (K)")
    c_md.add_argument("--nvt", type=float, default=None, metavar="T",
                      help="Langevin thermostat target temperature (K)")
    c_md.add_argument("--friction", type=float, default=0.1,
                      help="Langevin friction (1/fs, default 0.1)")
    c_md.add_argument("--npt", type=float, default=None,
                      metavar="P_GPA",
                      help="Berendsen barostat target pressure (GPa); "
                           "combine with --nvt for NPT")
    c_md.add_argument("--npt-aniso", action="store_true",
                      help="full-tensor Berendsen barostat: each cell "
                           "axis/shear relaxes its own stress component "
                           "(non-cubic cells, interfaces)")
    c_md.add_argument("--pressure-tau", type=float, default=1000.0,
                      help="barostat time constant (fs)")
    c_md.add_argument("--supercell", type=int, nargs=3, default=None,
                      help="repeat the input cell before running")
    c_md.add_argument("--skin", type=float, default=1.0)
    c_md.add_argument("--chunk-size", type=int, default=20,
                      help="jitted steps per neighbor-list rebuild")
    c_md.add_argument("--seed", type=int, default=0)
    c_md.add_argument("--device-nl", action="store_true",
                      help="rebuild the neighbor list ON DEVICE "
                           "(positions never visit the host)")
    c_md.add_argument("-o", "--output", default="md_final.extxyz",
                      help="final structure (extxyz)")
    c_md.add_argument("--thermo", default=None,
                      help="write per-chunk thermo history as CSV")
    c_md.add_argument("--traj", default=None,
                      help="write one trajectory frame per chunk "
                           "(extxyz, unwrapped positions)")
    c_md.add_argument("--save-state", default=None,
                      help="checkpoint the integrator state "
                           "(positions/velocities/cell/RNG) to this "
                           "npz at the end of the run")
    c_md.add_argument("--restart", default=None,
                      help="resume from a --save-state checkpoint "
                           "(bit-exact when chunk boundaries align)")

    c_gk = comp_sub.add_parser(
        "kappa", help="Green-Kubo lattice thermal conductivity: NVT "
                      "equilibration -> NVE production -> exact "
                      "autodiff many-body heat flux -> HCACF "
                      "integral (no reference analog; LAMMPS' own "
                      "compute heat/flux is wrong for many-body "
                      "potentials)")
    c_gk.add_argument("model")
    c_gk.add_argument("structure", help="extxyz/CIF file or built-in "
                                        "crystal name")
    c_gk.add_argument("--temp", type=float, default=300.0)
    c_gk.add_argument("--equil-steps", type=int, default=2000)
    c_gk.add_argument("--steps", type=int, default=20000,
                      help="NVE production steps")
    c_gk.add_argument("--timestep", type=float, default=2.0)
    c_gk.add_argument("--sample", type=int, default=5,
                      help="record J every SAMPLE steps (= MD chunk)")
    c_gk.add_argument("--max-lag", type=int, default=None,
                      help="HCACF lag cutoff in frames (default n/2)")
    c_gk.add_argument("--supercell", type=int, nargs=3, default=None)
    c_gk.add_argument("--friction", type=float, default=0.05)
    c_gk.add_argument("--skin", type=float, default=1.0)
    c_gk.add_argument("--seed", type=int, default=0)
    c_gk.add_argument("--seeds", type=int, default=1,
                      help="independent replicas (seed, seed+1, ...); "
                           "kappa reported as mean +/- std")
    c_gk.add_argument("--device-nl", action="store_true",
                      help="rebuild neighbor lists ON DEVICE during "
                           "production (J is computed inside the "
                           "jitted chunk either way, so this makes "
                           "the whole production loop chip-resident)")
    c_gk.add_argument("-o", "--output", default="kappa.csv",
                      help="CSV: lag_fs, hcacf, kappa_running")
    c_gk.add_argument("--flush-every", type=int, default=50000,
                      help="rewrite the CSV from the accumulated "
                           "flux series every N production steps "
                           "(atomic tmp+rename, '# PARTIAL' comment "
                           "line) so a preempted run still leaves a "
                           "valid shorter-window result; 0 disables")

    c_vd = comp_sub.add_parser(
        "vdos", help="vibrational DOS from an MD trajectory "
                     "(mass-weighted VACF cosine transform; "
                     "`compute md --traj` output carries velocities)")
    c_vd.add_argument("trajectory")
    c_vd.add_argument("--dt", type=float, default=None,
                      help="fs between frames (default: the "
                           "frame_interval_fs header)")
    c_vd.add_argument("-o", "--output", default="vdos.csv")

    c_dif = comp_sub.add_parser(
        "diffusion", help="vacancy hop kinetics by harmonic TST: "
                          "CI-NEB saddle + Vineyard prefactor from "
                          "exact autodiff Hessians -> jump rates and "
                          "D_v(T)")
    c_dif.add_argument("model")
    c_dif.add_argument("crystal")
    c_dif.add_argument("--supercell", type=int, nargs=3,
                       default=[3, 3, 3])
    c_dif.add_argument("--temps", default="600,900,1200",
                       help="comma-separated temperatures (K)")
    c_dif.add_argument("--site", type=int, default=0)
    c_dif.add_argument("--n-images", type=int, default=7)

    c_dd = comp_sub.add_parser(
        "dedup", help="near-duplicate frames in a database by "
                      "Valle-Oganov fingerprint distance (the "
                      "reference's FingerprintsComparator use case, "
                      "as a CLI)")
    c_dd.add_argument("db", help="sqlite db or extxyz")
    c_dd.add_argument("--threshold", type=float, default=0.01,
                      help="cosine-distance threshold")
    c_dd.add_argument("--rmax", type=float, default=6.0)
    c_dd.add_argument("--keep", default=None,
                      help="write the de-duplicated frames here "
                           "(extxyz; first of each duplicate group "
                           "kept)")

    c_str = comp_sub.add_parser(
        "strength", help="ideal tensile strength: fixed axial strain "
                         "scan with positions + transverse strains "
                         "relaxed (uniaxial-stress protocol)")
    c_str.add_argument("model")
    c_str.add_argument("crystal")
    c_str.add_argument("--axis", type=int, default=2, choices=[0, 1, 2])
    c_str.add_argument("--max-strain", type=float, default=0.7)
    c_str.add_argument("--n-points", type=int, default=15)
    c_str.add_argument("--fmax", type=float, default=0.02)
    c_str.add_argument("--shear", type=int, default=None,
                       metavar="DIR",
                       help="ideal SHEAR strength instead: simple "
                            "shear of the --axis cell vector along "
                            "this direction (0/1/2), transverse "
                            "strains relaxed")
    c_str.add_argument("-o", "--output", default=None,
                       help="CSV: strain, stress_gpa, e_per_atom")

    c_fe = comp_sub.add_parser(
        "fe", help="ABSOLUTE Helmholtz free energy by Frenkel-Ladd "
                   "thermodynamic integration from an Einstein "
                   "crystal (device-resident lambda runs, exact COM "
                   "separation; no reference analog)")
    c_fe.add_argument("model")
    c_fe.add_argument("structure")
    c_fe.add_argument("--temp", type=float, default=300.0)
    c_fe.add_argument("--supercell", type=int, nargs=3, default=None)
    c_fe.add_argument("--k-spring", type=float, default=None,
                      help="eV/A^2 (default: matched to the thermal "
                           "cloud by a pilot run)")
    c_fe.add_argument("--n-lambda", type=int, default=8)
    c_fe.add_argument("--equil-steps", type=int, default=1500)
    c_fe.add_argument("--steps", type=int, default=3000,
                      help="production steps per lambda")
    c_fe.add_argument("--timestep", type=float, default=2.0)
    c_fe.add_argument("--seed", type=int, default=0)

    c_visc = comp_sub.add_parser(
        "visc", help="Green-Kubo shear viscosity: NVT equilibration "
                     "-> production with the full instantaneous "
                     "stress recorded inside the jitted MD chunk -> "
                     "stress-ACF integral (for liquids; no reference "
                     "analog)")
    c_visc.add_argument("model")
    c_visc.add_argument("structure", help="extxyz of the LIQUID (or "
                                          "built-in crystal to melt "
                                          "at high --temp)")
    c_visc.add_argument("--temp", type=float, default=2000.0)
    c_visc.add_argument("--equil-steps", type=int, default=4000)
    c_visc.add_argument("--steps", type=int, default=40000)
    c_visc.add_argument("--timestep", type=float, default=2.0)
    c_visc.add_argument("--sample", type=int, default=5)
    c_visc.add_argument("--max-lag", type=int, default=None)
    c_visc.add_argument("--supercell", type=int, nargs=3, default=None)
    c_visc.add_argument("--friction", type=float, default=0.05)
    c_visc.add_argument("--nvt-production", action="store_true",
                        help="keep the thermostat on during "
                             "production (default: NVE)")
    c_visc.add_argument("--skin", type=float, default=1.0)
    c_visc.add_argument("--seed", type=int, default=0)
    c_visc.add_argument("--device-nl", action="store_true")
    c_visc.add_argument("-o", "--output", default="visc.csv")
    c_visc.add_argument("--flush-every", type=int, default=50000,
                        help="rewrite the CSV from the accumulated "
                             "series every N production steps "
                             "(atomic, '# PARTIAL' marker) so a "
                             "preempted run keeps its shorter-window "
                             "result; 0 disables")

    c_surf = comp_sub.add_parser(
        "surface", help="surface energy gamma(hkl): Miller-index slab "
                        "built by integer lattice algebra, relaxed "
                        "with the model (ref analog: exported LAMMPS)")
    c_surf.add_argument("model")
    c_surf.add_argument("crystal", help="BULK cell (conventional for "
                                        "textbook indices)")
    c_surf.add_argument("miller", type=int, nargs=3)
    c_surf.add_argument("--layers", type=int, default=8)
    c_surf.add_argument("--vacuum", type=float, default=12.0)
    c_surf.add_argument("--no-relax", action="store_true")
    c_surf.add_argument("--fmax", type=float, default=0.02)

    c_gb = comp_sub.add_parser(
        "gb", help="symmetric tilt grain-boundary energy: mirror "
                   "bicrystal via integer lattice algebra, "
                   "microscopic-translation scan, positions + "
                   "GB excess volume relaxed")
    c_gb.add_argument("model")
    c_gb.add_argument("crystal")
    c_gb.add_argument("miller", type=int, nargs=3)
    c_gb.add_argument("--layers", type=int, default=8)
    c_gb.add_argument("--twist", type=float, default=None,
                      metavar="DEG",
                      help="TWIST boundary: rotate grain B by this "
                           "angle about the plane normal (CSL cell "
                           "found automatically) instead of the "
                           "mirror tilt")
    c_gb.add_argument("--mid-plane", action="store_true",
                      help="mirror BETWEEN atomic planes instead of "
                           "on one")
    c_gb.add_argument("--min-dist", type=float, default=1.8,
                      help="delete one of any cross-boundary atom "
                           "pair closer than this (A)")
    c_gb.add_argument("--no-relax", action="store_true")
    c_gb.add_argument("-o", "--output", default=None,
                      help="write the relaxed bicrystal (extxyz)")

    c_sfe = comp_sub.add_parser(
        "sfe", help="stacking-fault energy gamma(hkl, shift): "
                    "tilted-cell method, normal-constrained "
                    "relaxation (fcc (111) 1/3,1/3 = intrinsic SF)")
    c_sfe.add_argument("model")
    c_sfe.add_argument("crystal")
    c_sfe.add_argument("--miller", type=int, nargs=3,
                       default=[1, 1, 1])
    c_sfe.add_argument("--shift", type=float, nargs=2,
                       default=[1 / 3, 1 / 3],
                       help="in units of the acute in-plane basis")
    c_sfe.add_argument("--layers", type=int, default=8)
    c_sfe.add_argument("--no-relax", action="store_true")
    c_sfe.add_argument("--line", type=int, default=None, metavar="N",
                       help="scan gamma(t * direction) at N points "
                            "along --shift (as the direction; default "
                            "fcc <112>): prints gamma_us/gamma_isf, "
                            "writes CSV")
    c_sfe.add_argument("--grid", type=int, nargs=2, default=None,
                       metavar=("N1", "N2"),
                       help="full gamma-surface on an N1 x N2 shift "
                            "grid; writes CSV")
    c_sfe.add_argument("-o", "--output", default="gsf.csv",
                       help="CSV output for --line/--grid")

    c_qha = comp_sub.add_parser(
        "qha", help="quasi-harmonic thermal expansion: minimize "
                    "E(V) + F_vib(V,T) over scaled cells (one exact "
                    "Hessian per volume)")
    c_qha.add_argument("model")
    c_qha.add_argument("crystal")
    c_qha.add_argument("--temps", default="0,300,600,900",
                       help="comma-separated temperatures (K)")
    c_qha.add_argument("--supercell", type=int, nargs=3,
                       default=[3, 3, 3])
    c_qha.add_argument("--qmesh", type=int, nargs=3, default=[6, 6, 6])
    c_qha.add_argument("--scales", type=float, nargs=3,
                       default=[0.985, 1.04, 7],
                       metavar=("LO", "HI", "N"),
                       help="linear cell scale grid")
    c_qha.add_argument("--eos", default="birchmurnaghan")

    c_rdf = comp_sub.add_parser(
        "rdf", help="partial radial distribution functions g_ab(r) "
                    "from a trajectory (device pair histogram)")
    c_rdf.add_argument("trajectory",
                       help="extxyz trajectory (one stoichiometry; "
                            "e.g. `compute md --traj` output)")
    c_rdf.add_argument("--rmax", type=float, default=6.0)
    c_rdf.add_argument("--nbins", type=int, default=200)
    c_rdf.add_argument("-o", "--output", default="rdf.csv")

    c_ph = comp_sub.add_parser(
        "phonon", help="phonon band structure from the model Hessian")
    c_ph.add_argument("model")
    c_ph.add_argument("crystal")
    c_ph.add_argument("--supercell", type=int, nargs=3,
                      default=[2, 2, 2])
    c_ph.add_argument("--path", default="fcc",
                      choices=["fcc", "bcc", "gamma"])
    c_ph.add_argument("--npoints", type=int, default=20)
    c_ph.add_argument("--output", default="bands.csv")
    c_ph.add_argument("--temps", default=None,
                      help="comma-separated temperatures (K): also "
                           "print harmonic ZPE / F_vib / S_vib / C_v "
                           "per atom from exact q-mesh mode sums")
    c_ph.add_argument("--qmesh", type=int, nargs=3, default=[8, 8, 8],
                      help="Monkhorst-Pack mesh for --temps")

    v2l = sub.add_parser(
        "vasp2lammps",
        help="convert a POSCAR/CONTCAR to a LAMMPS data file "
             "(reference tools/vasp2lammps)")
    v2l.add_argument("poscar")
    v2l.add_argument("-o", "--output", default="data.lammps")
    v2l.add_argument("-s", "--specorder", nargs="+", default=None)

    args = parser.parse_args(argv)
    args.device, args.dtype = device, dtype or "medium"
    return _in_group({
        "stop": _cmd_stop,
        "evaluate": _cmd_evaluate,
        "build": _cmd_build,
        "run": _cmd_run,
        "export": _cmd_export,
        "print": _cmd_print,
        "compute": _cmd_compute,
        "vasp2lammps": _cmd_vasp2lammps,
    }[args.command], args)


def _in_group(verb, args):
    """Run `verb(args)`; under a launcher (``WORLD_SIZE`` > 1) first join
    its group, unless this process is in one already, and leave it after.
    Ranks other than 0 print nothing on stdout."""
    import contextlib
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return verb(args)
    import torch.distributed as dist
    joined = not dist.is_initialized()
    if joined:
        from ..parallel.mesh import initialize_distributed
        initialize_distributed(device=args.device)
    try:
        if dist.get_rank() == 0:
            return verb(args)
        with open(os.devnull, "w") as quiet, \
                contextlib.redirect_stdout(quiet):
            return verb(args)
    finally:
        if joined:
            dist.destroy_process_group()


# ----------------------------------------------------------------------
def _cmd_evaluate(args):
    from ..train.evaluation import evaluate_run
    evaluate_run(args.workdir, ckpt=args.ckpt,
                 per_group=not args.overall_only,
                 use_ema=not args.no_ema,
                 output=None if args.output == "-" else args.output,
                 verbose=True, device=args.device)
    return 0


def _cmd_stop(args):
    import signal
    pid_file = os.path.join(args.model_dir, "run.pid")
    if not os.path.exists(pid_file):
        print(f"no run.pid in {args.model_dir}")
        return 1
    pid = int(open(pid_file).read().strip())
    try:
        os.kill(pid, signal.SIGTERM)
        print(f"sent SIGTERM to {pid}")
        return 0
    except ProcessLookupError:
        print(f"process {pid} not running")
        return 1


def _cmd_build(args):
    from ..io.sqlite import read_file
    units = {"eV": 1.0, "Hartree": 27.211386024367243,
             "kcal/mol": 0.04336410390059322}
    db = read_file(args.filename, db_path=args.output,
                   unit_energy=units[args.energy_unit],
                   fmax_limit=args.fmax, vacuum=args.vacuum)
    print(f"built {db.filename}: {len(db)} structures, "
          f"elements {db.elements}")
    return 0


def _cmd_run(args):
    from ..train.manager import TrainingManager
    manager = TrainingManager(args.filename, device=args.device)
    manager.train_and_evaluate(verbose=not args.quiet)
    if not args.no_export:
        path = manager.export()
        print(f"exported model to {path}")
    return 0


def _cmd_export(args):
    from ..train.manager import TrainingManager
    manager = TrainingManager(args.filename, device=args.device)
    ckpt = args.checkpoint or os.path.join(manager.model_dir,
                                           "checkpoint.npz")
    params, ema, step = manager.trainer.load_checkpoint(ckpt)
    state = {"params": params, "ema_params": ema, "step": step}
    path = manager.export(state=state, use_ema=not args.no_ema)
    print(f"exported model (step {step}) to {path}")
    return 0


def _parse_tf_logfile(path):
    """Parse the reference's TF logfile into evaluation rows (reference
    `cli/entry.py:24-131`): 'Saving dict for global step N: k = v, ...'
    lines accumulate; a 'pid=' line starts a fresh experiment; Elastic
    keys are shortened and rounded to 0.1 GPa."""
    import re
    step_patt = re.compile(r".*tensorflow\s+INFO\s+Saving\sdict"
                           r"\sfor\sglobal\sstep\s(\d+):(.*)")
    kv_patt = re.compile(r"\s*(.*?)\s=\s([0-9.\-eE]+)")
    pid_patt = re.compile(r".*tensorflow\s+INFO\s+pid=(\d+)")
    results = {}
    with open(path) as fp:
        for line in fp:
            line = line.strip()
            if pid_patt.search(line):
                results.clear()
                continue
            m = step_patt.search(line)
            if not m:
                continue
            for s in m.group(2).split(","):
                kv = kv_patt.search(s)
                if not kv:
                    continue
                key, val = kv.group(1), kv.group(2)
                if key == "global_step":
                    val = int(val)
                elif key.startswith("Elastic"):
                    val = f"{round(float(val), 1):.1f}"
                    if "Constraints" in key:
                        key = key[8:].replace("/Constraints", "")
                    else:
                        key = key[8:].replace("/Cijkl", "")
                else:
                    val = float(val)
                results.setdefault(key, []).append(val)
    return results


def _cmd_print(args):
    base = os.path.basename(args.filename)
    rows = None
    if base.endswith("summary.csv"):
        with open(args.filename) as fh:
            print(fh.read().rstrip())
        return 0
    if base.endswith(".json"):
        with open(args.filename) as fh:
            history = json.load(fh)
        if not history:
            print("empty history")
            return 0
        rows = history
    elif base.endswith(".jsonl"):
        rows = [json.loads(ln) for ln in open(args.filename)
                if ln.strip()]
    else:  # reference TF logfile
        cols = _parse_tf_logfile(args.filename)
        if not cols or "global_step" not in cols:
            print("no evaluation records found")
            return 0
        n = len(cols["global_step"])
        rows = [{k: (v[i] if i < len(v) else "")
                 for k, v in cols.items()} for i in range(n)]
    if not rows:
        print("empty history")
        return 0
    keys = list(rows[0].keys())
    out = args.output or os.path.join(
        os.path.dirname(args.filename) or ".", "summary.csv")
    with open(out, "w") as fh:
        fh.write(",".join(keys) + "\n")
        for row in rows:
            fh.write(",".join(str(row.get(k, "")) for k in keys) + "\n")
    widths = {k: max(len(str(k)), *(len(str(r.get(k, ""))) for r in rows))
              for k in keys}
    print("  ".join(str(k).rjust(widths[k]) for k in keys))
    for row in rows:
        print("  ".join(str(row.get(k, "")).rjust(widths[k])
                        for k in keys))
    print(f"wrote {out} ({len(rows)} rows)")
    return 0


def _cmd_vasp2lammps(args):
    from ..io.vasp import read_poscar
    from ..analysis.lammps import write_lammps_data
    s = read_poscar(args.poscar)
    write_lammps_data(args.output, s, elements=args.specorder)
    print(f"wrote {args.output} ({len(s)} atoms)")
    return 0


def _cmd_compute(args):
    if args.task == "uncertainty":
        return _compute_uncertainty(args)
    if args.task == "dbnum":
        from ..io.sqlite import connect
        from collections import Counter
        db = connect(args.db)
        comp = Counter()
        for s in db:
            comp[s.formula] += 1
        print(f"{len(db)} structures, elements {db.elements}")
        for formula, count in comp.most_common():
            print(f"  {formula}: {count}")
        return 0
    if args.task == "dbfstd":
        import numpy as np
        from ..io.sqlite import connect
        db = connect(args.db)
        forces = [s.forces for s in db if s.forces is not None]
        if forces:
            allf = np.concatenate([f.reshape(-1) for f in forces])
            print(f"force std: {allf.std():.6f} eV/A over "
                  f"{len(forces)} structures")
        return 0
    if args.task == "scatter":
        import numpy as np
        from ..calculator import TensorAlloyCalculator
        from ..io.sqlite import connect
        calc = TensorAlloyCalculator(args.model, **_placement(args))
        db = connect(args.db)
        rows = []
        for s in db:
            e = calc.get_potential_energy(s)
            rows.append((len(s), s.energy, e))
        with open(args.output, "w") as fh:
            fh.write("natoms,label,predicted\n")
            for n, lbl, prd in rows:
                fh.write(f"{n},{lbl},{prd}\n")
        err = np.array([(lbl - prd) / n for n, lbl, prd in rows
                        if lbl is not None])
        print(f"wrote {args.output}; energy MAE/atom = "
              f"{np.abs(err).mean():.6f} eV")
        return 0
    if args.task == "percentile":
        import numpy as np
        from ..calculator import TensorAlloyCalculator
        from ..io.sqlite import connect
        calc = TensorAlloyCalculator(args.model, **_placement(args))
        db = connect(args.db)
        e_errors, f_errors = [], []
        for s in db:
            res = calc.calculate(s)
            if s.energy is not None:
                e_errors.append(abs(res["energy"] - s.energy) / len(s))
            if s.forces is not None:
                f_errors.extend(
                    np.abs(res["forces"] - s.forces).reshape(-1))
        for name, arr in (("energy/atom [eV]", e_errors),
                          ("forces [eV/A]", f_errors)):
            if arr:
                vals = np.percentile(np.asarray(arr), args.q)
                print(name + ": " + "  ".join(
                    f"p{int(q)}={v:.6f}" for q, v in zip(args.q, vals)))
        return 0
    if args.task == "eos":
        return _compute_eos(args)
    if args.task == "latt":
        return _compute_latt(args)
    if args.task == "relax":
        return _compute_relax(args)
    if args.task == "elastic":
        return _compute_elastic(args)
    if args.task == "phonon":
        return _compute_phonon(args)
    if args.task == "md":
        return _compute_md(args)
    if args.task == "kappa":
        return _compute_kappa(args)
    if args.task == "visc":
        return _compute_visc(args)
    if args.task == "fe":
        return _compute_fe(args)
    if args.task == "strength":
        return _compute_strength(args)
    if args.task == "dedup":
        return _compute_dedup(args)
    if args.task == "diffusion":
        return _compute_diffusion(args)
    if args.task == "vdos":
        return _compute_vdos(args)
    if args.task == "rdf":
        return _compute_rdf(args)
    if args.task == "qha":
        return _compute_qha(args)
    if args.task == "surface":
        return _compute_surface(args)
    if args.task == "sfe":
        return _compute_sfe(args)
    if args.task == "gb":
        return _compute_gb(args)
    if args.task == "neb":
        return _compute_neb(args)
    if args.task == "defect":
        return _compute_defect(args)
    raise ValueError(args.task)


def _compute_uncertainty(args):
    """Committee ranking (`ensemble.select_by_uncertainty`): one line
    per selected frame, highest disagreement first."""
    from ..ensemble import EnsembleCalculator, select_by_uncertainty
    if len(args.models) < 2:
        print("error: an ensemble needs at least 2 saved models")
        return 1
    if args.frames.endswith(".db"):
        from ..io.sqlite import connect
        frames = list(connect(args.frames))
    else:
        from ..io.extxyz import read_extxyz
        frames = read_extxyz(args.frames)
    calc = EnsembleCalculator(list(args.models), **_placement(args))
    picked = select_by_uncertainty(calc, frames, n_select=args.top,
                                   threshold=args.threshold)
    print(f"# {len(frames)} frames, {calc.n_members} members; "
          f"score = max per-atom force std (eV/A)")
    print("# rank  frame  natoms  formula            score")
    for rank, idx in enumerate(picked):
        s = frames[idx]
        print(f"{rank + 1:6d} {idx:6d} {len(s):7d}  {s.formula:<16s} "
              f"{calc.get_max_force_std(s):10.6f}")
    return 0



def _print_elastic_dipole(calc, bulk, defect):
    """Elastic dipole tensor of a relaxed defect at FIXED cell:
    P = -V (sigma_def - sigma_bulk) (eV). tr(P)/3 gives the
    relaxation volume via dV = tr(P) / (3 B)."""
    import numpy as np
    from ..atoms import voigt_to_full_3x3
    v = bulk.volume

    def full(s):
        s = np.asarray(s, dtype=np.float64)
        return voigt_to_full_3x3(s) if s.ndim == 1 else s

    dsig = full(calc.get_stress(defect)) - full(calc.get_stress(bulk))
    pdip = -v * dsig
    print("elastic dipole tensor P (eV):")
    for row in pdip:
        print("  [" + "  ".join(f"{x:9.4f}" for x in row) + "]")
    print(f"tr(P)/3 = {np.trace(pdip) / 3:.4f} eV "
          f"(relaxation volume = tr(P)/(3B))")


def _compute_defect(args):
    """Point-defect formation, internally relaxed with the model (ref
    analog: analysis/lammps DefectFormation, which needs an external
    LAMMPS). Vacancy: E_f = E_def - (N-1)/N * E_bulk. Interstitial:
    E_f = E_def - (N+1)/N * E_bulk (self-interstitial; for a foreign
    `--element` the host-energy chemical potential is still used and
    reported as such)."""
    import numpy as np
    from ..atoms import Structure
    from ..calculator import TensorAlloyCalculator
    from ..analysis.elastic import relax_positions
    calc = TensorAlloyCalculator(args.model, **_placement(args))
    bulk = _load_crystal(args.crystal).repeat(tuple(args.supercell))
    bulk = relax_positions(calc, bulk, fmax=args.fmax)
    e_bulk = calc.get_potential_energy(bulk)
    n = len(bulk)
    if getattr(args, "interstitial", None) is not None:
        from ..elements import atomic_numbers
        sym = args.element or bulk.symbols[0]
        pos_new = np.asarray(args.interstitial) @ bulk.cell
        defect = Structure(
            np.concatenate([bulk.numbers, [atomic_numbers[sym]]]),
            np.concatenate([bulk.positions, pos_new[None]]),
            bulk.cell.copy(), bulk.pbc)
        defect = relax_positions(calc, defect, fmax=args.fmax)
        e_def = calc.get_potential_energy(defect)
        e_f = e_def - (n + 1) / n * e_bulk
        print(f"supercell N = {n}; E_bulk = {e_bulk:.6f} eV; "
              f"E_defect = {e_def:.6f} eV ({sym} interstitial, "
              f"mu = bulk energy/atom)")
        print(f"interstitial formation energy = {e_f:.6f} eV")
        if getattr(args, "dipole", False):
            _print_elastic_dipole(calc, bulk, defect)
        return 0
    if not 0 <= args.site < n:
        raise SystemExit(f"--site {args.site} out of range (N={n})")
    keep = np.arange(n) != args.site
    defect = Structure(bulk.numbers[keep], bulk.positions[keep],
                       bulk.cell.copy(), bulk.pbc)
    defect = relax_positions(calc, defect, fmax=args.fmax)
    e_def = calc.get_potential_energy(defect)
    e_f = e_def - (n - 1) / n * e_bulk
    print(f"supercell N = {n}; E_bulk = {e_bulk:.6f} eV; "
          f"E_defect = {e_def:.6f} eV")
    print(f"vacancy formation energy = {e_f:.6f} eV")
    if getattr(args, "dipole", False):
        _print_elastic_dipole(calc, bulk, defect)
    return 0


def _compute_md(args):
    """Run the on-device integrator (`dynamics.VelocityVerlet`) from a
    saved model: chunked thermo lines to stdout, optional CSV history,
    final frame to extxyz."""
    import numpy as np
    from ..dynamics import VelocityVerlet
    from ..io.extxyz import write_extxyz
    from ..io.model import load_model
    model, _ = load_model(args.model, **_placement(args))
    s = _load_crystal(args.structure)
    if args.supercell:
        s = s.repeat(tuple(args.supercell))
    if args.npt is not None and args.nvt is None:
        raise SystemExit("--npt needs --nvt (Berendsen barostat is "
                         "composed with the Langevin thermostat)")
    md = VelocityVerlet(
        model, s, timestep=args.timestep, skin=args.skin,
        chunk_size=args.chunk_size, temperature=args.temp,
        seed=args.seed,
        target_temperature=args.nvt,
        friction=args.friction if args.nvt is not None else None,
        device_nl=args.device_nl,
        target_pressure=args.npt, pressure_tau=args.pressure_tau,
        anisotropic=getattr(args, "npt_aniso", False))
    if args.restart:
        md.load_state(args.restart)
        print(f"restarted from {args.restart}")
    regime = ("NPT" if args.npt is not None
              else "NVT" if args.nvt is not None else "NVE")
    print(f"{regime}: {len(s)} atoms, {args.steps} steps @ "
          f"{args.timestep} fs, chunk {args.chunk_size}"
          + (", device NL" if args.device_nl else ""))
    history = md.run(args.steps,
                     record_trajectory=args.traj is not None)
    n_chunks = len(history["potential"])
    stride = max(1, n_chunks // 20)
    for i in range(0, n_chunks, stride):
        line = (f"step {min((i + 1) * args.chunk_size, args.steps):>8d}"
                f"  E_pot {history['potential'][i]:.6f} eV"
                f"  T {history['temperature'][i]:8.1f} K")
        if "pressure" in history:
            line += (f"  P {history['pressure'][i]:8.3f} GPa"
                     f"  V {history['volume'][i]:10.2f} A^3")
        print(line)
    if args.traj:
        frames = []
        for p, c, v, pe in zip(history["positions"],
                               history["cells"],
                               history["velocities"],
                               history["potential"]):
            frame = s.copy()
            frame.positions, frame.cell = p, c
            frame.info["energy"] = float(pe)
            frame.info["velocities"] = v
            frame.info["frame_interval_fs"] = (args.chunk_size
                                               * args.timestep)
            frames.append(frame)
        write_extxyz(args.traj, frames)
        print(f"wrote {args.traj} ({len(frames)} frames)")
    if args.thermo:
        keys = [k for k in history
                if k not in ("positions", "velocities", "cells")]
        with open(args.thermo, "w") as fh:
            fh.write(",".join(keys) + "\n")
            for row in zip(*(history[k] for k in keys)):
                fh.write(",".join(f"{x:.8g}" for x in row) + "\n")
        print(f"wrote {args.thermo}")
    if args.save_state:
        md.save_state(args.save_state)
        print(f"saved integrator state to {args.save_state}")
    final = md.structure
    final.info["energy"] = float(history["potential"][-1])
    write_extxyz(args.output, [final])
    drift = abs(np.asarray(history["total"])[-1]
                - np.asarray(history["total"])[0]) / len(s) * 1000
    print(f"final T = {md.temperature:.1f} K"
          + (f", total-energy drift {drift:.4f} meV/atom"
             if regime == "NVE" else ""))
    print(f"wrote {args.output}")
    return 0


def _compute_kappa(args):
    """Green-Kubo kappa: Langevin-NVT equilibration, NVE production
    with the heat flux inside the jitted chunk, HCACF running
    integral; `--seeds N` averages independent replicas."""
    import numpy as np
    from ..dynamics import VelocityVerlet
    from ..io.model import load_model
    from ..analysis.heatflux import green_kubo
    model, _ = load_model(args.model, **_placement(args))
    s = _load_crystal(args.structure)
    if args.supercell:
        s = s.repeat(tuple(args.supercell))
    if args.seeds > 1:
        kappas, runnings, gk = [], [], None
        for k in range(args.seeds):
            sub = argparse.Namespace(**vars(args))
            sub.seeds, sub.seed = 1, args.seed + k
            sub.output = (args.output + f".s{sub.seed}"
                          if args.output else None)
            print(f"--- replica seed {sub.seed} ---")
            gk = _compute_kappa_single(sub, model, s)
            kappas.append(gk["kappa"])
            runnings.append(gk["kappa_running"])
        n = min(len(r) for r in runnings)
        mean_r = np.mean([r[:n] for r in runnings], axis=0)
        std_r = np.std([r[:n] for r in runnings], axis=0)
        with open(args.output, "w") as fh:
            fh.write("lag_fs,kappa_mean_W_mK,kappa_std_W_mK\n")
            for row in zip(gk["lags"][:n], mean_r, std_r):
                fh.write(",".join(f"{x:.8g}" for x in row) + "\n")
        print(f"kappa over {args.seeds} replicas: "
              f"{np.mean(kappas):.3f} +/- {np.std(kappas):.3f} W/m/K")
        print(f"wrote {args.output}")
        return 0
    _compute_kappa_single(args, model, s)
    return 0


def _write_gk_csv(path, header, cols, partial=None):
    """Atomically (tmp + os.replace) write a Green-Kubo CSV (`cols`
    zipped row-wise under `header`); `partial` adds a leading
    '# PARTIAL ...' comment line (np loaders skip '#' by default)
    marking a preempted production."""
    tmp = str(path) + ".tmp"
    with open(tmp, "w") as fh:
        if partial:
            fh.write(f"# PARTIAL {partial}\n")
        fh.write(header + "\n")
        for row in zip(*cols):
            fh.write(",".join(f"{x:.8g}" for x in row) + "\n")
    os.replace(tmp, str(path))


def _segmented_production(md, args, record_key):
    """Run NVE/NVT production in `--flush-every`-step segments
    (`run()` carries all integrator state across calls, so segments
    compose into one trajectory), yielding the accumulated
    (series, temperatures, steps_done) after each segment so the
    caller can flush a valid shorter-window GK result to disk —
    a run killed at a queue deadline or round end then leaves a
    usable partial instead of nothing.

    Segment lengths snap DOWN to a multiple of `--sample` (the MD
    chunk size): `run()` records one frame per chunk, so a ragged
    segment boundary would emit an off-cadence frame mid-series and
    the fixed-dt ACF integral would silently integrate non-uniform
    spacing. Only the FINAL segment may be ragged — exactly the one
    short trailing chunk a single `run(steps)` call always had."""
    flush = max(0, int(getattr(args, "flush_every", 0) or 0))
    sample = max(1, int(getattr(args, "sample", 1) or 1))
    if flush:
        flush = max(sample, flush - flush % sample)
    series, temps = [], []
    done = 0
    while done < args.steps:
        n = (args.steps - done if flush == 0
             else min(flush, args.steps - done))
        hist = md.run(n)
        series.extend(hist[record_key])
        temps.extend(hist["temperature"])
        done += n
        yield series, temps, done


def _compute_kappa_single(args, model=None, s=None):
    import numpy as np
    from ..dynamics import VelocityVerlet
    from ..io.model import load_model
    from ..analysis.heatflux import green_kubo
    if model is None:
        model, _ = load_model(args.model, **_placement(args))
        s = _load_crystal(args.structure)
        if args.supercell:
            s = s.repeat(tuple(args.supercell))
    print(f"equilibration: NVT {args.temp} K, {args.equil_steps} "
          f"steps @ {args.timestep} fs ({len(s)} atoms)")
    md_eq = VelocityVerlet(
        model, s, timestep=args.timestep, skin=args.skin,
        chunk_size=max(args.sample, 20), temperature=args.temp,
        seed=args.seed, target_temperature=args.temp,
        friction=args.friction)
    md_eq.run(args.equil_steps)
    print(f"  T after equilibration: {md_eq.temperature:.1f} K")

    md = VelocityVerlet(model, md_eq.structure,
                        timestep=args.timestep, skin=args.skin,
                        chunk_size=args.sample, seed=args.seed,
                        device_nl=args.device_nl,
                        record_heat_flux=True)
    md.velocities_vap = md_eq.velocities_vap.copy()
    md.zero_com_velocity()     # Langevin leaves a random COM drift
    print(f"production: NVE {args.steps} steps, J sampled every "
          f"{args.sample * args.timestep} fs (flux inside the "
          f"jitted chunk)")
    kappa_header = "lag_fs,hcacf_eVA_fs_sq,kappa_running_W_mK"
    for J_hist, T_hist, done in _segmented_production(
            md, args, "heat_flux"):
        if args.output and done < args.steps and len(J_hist) >= 4:
            gk_part = green_kubo(
                np.stack(J_hist), dt=args.sample * args.timestep,
                volume=md.structure.volume,
                temperature=float(np.mean(T_hist)),
                max_lag=args.max_lag)
            _write_gk_csv(
                args.output, kappa_header,
                (gk_part["lags"], gk_part["hcacf"],
                 gk_part["kappa_running"]),
                partial=f"production {done}/{args.steps} steps, "
                        f"{len(J_hist)} frames")
            print(f"  flushed partial GK at {done}/{args.steps} "
                  f"steps (kappa so far {gk_part['kappa']:.3f} "
                  f"W/m/K)", flush=True)
    t_mean = float(np.mean(T_hist))
    J = np.stack(J_hist)
    gk = green_kubo(J, dt=args.sample * args.timestep,
                    volume=md.structure.volume, temperature=t_mean,
                    max_lag=args.max_lag)
    if args.output:
        _write_gk_csv(args.output, kappa_header,
                      (gk["lags"], gk["hcacf"], gk["kappa_running"]))
    kr = gk["kappa_running"]
    plateau = float(np.mean(kr[len(kr) // 2:]))
    lo, hi = gk["plateau_window"]
    print(f"<T> = {t_mean:.1f} K over {len(J)} frames")
    print(f"kappa(max lag) = {gk['kappa']:.3f} W/m/K; "
          f"plateau mean (last half of lags) = {plateau:.3f} W/m/K")
    print(f"kappa(ACF-decay window, lags {lo}..{hi}) = "
          f"{gk['kappa_plateau']:.3f} +/- {gk['kappa_plateau_se']:.3f}"
          f" W/m/K  <- headline estimator")
    if args.output:
        print(f"wrote {args.output}")
    return gk








def _compute_vdos(args):
    import numpy as np
    from ..io.extxyz import read_extxyz
    from ..analysis.trajectory import vibrational_dos
    frames = read_extxyz(args.trajectory)
    if "velocities" not in frames[0].info:
        raise SystemExit("trajectory has no velocities column (write "
                         "it with `compute md --traj`)")
    vel = np.stack([np.asarray(f.info["velocities"]) for f in frames])
    dt = args.dt or float(frames[0].info.get("frame_interval_fs", 0))
    if not dt:
        raise SystemExit("frame interval unknown: pass --dt")
    out = vibrational_dos(vel, timestep=dt,
                          masses=frames[0].masses)
    with open(args.output, "w") as fh:
        fh.write("freq_thz,dos\n")
        for row in zip(out["freq_thz"], out["dos"]):
            fh.write(",".join(f"{x:.8g}" for x in row) + "\n")
    peak = out["freq_thz"][np.argmax(out["dos"])]
    print(f"{len(frames)} frames @ {dt} fs; VDOS peak at "
          f"{peak:.2f} THz (Nyquist {500.0 / dt:.1f} THz)")
    print(f"wrote {args.output}")
    return 0


def _compute_diffusion(args):
    from ..calculator import TensorAlloyCalculator
    from ..analysis.kinetics import vacancy_diffusivity
    calc = TensorAlloyCalculator(args.model, **_placement(args))
    bulk = _load_crystal(args.crystal)
    temps = tuple(float(x) for x in args.temps.split(","))
    out = vacancy_diffusivity(calc, bulk,
                              supercell=tuple(args.supercell),
                              temperatures=temps, site=args.site,
                              n_images=args.n_images)
    print(f"vacancy formation  E_f = {out['formation_energy']:.4f} eV")
    neb_state = ("converged" if out["neb"]["converged"]
                 else "NOT converged")
    print(f"migration barrier  E_m = {out['migration_energy']:.4f} eV"
          f"  (NEB {neb_state})")
    print(f"activation energy  Q   = "
          f"{out['activation_energy']:.4f} eV")
    print(f"Vineyard attempt frequency nu* = "
          f"{out['nu_star_thz']:.3f} THz; jump d = "
          f"{out['jump_distance']:.4f} A")
    print("   T (K)     k (1/s)       D_v (m^2/s)")
    for t_k, k, d in zip(out["temperatures"], out["jump_rate_hz"],
                         out["d_vacancy_m2_s"]):
        print(f"{t_k:8.0f}  {k:12.4e}  {d:12.4e}")
    return 0


def _compute_dedup(args):
    """Fingerprint near-duplicate report + optional pruned output."""
    from ..analysis.fingerprints import FingerprintsComparator
    if args.db.endswith(".db"):
        from ..io.sqlite import connect
        frames = list(connect(args.db))
    else:
        from ..io.extxyz import read_extxyz
        frames = read_extxyz(args.db)
    comp = FingerprintsComparator(frames, rmax=args.rmax)
    pairs = comp.find_duplicates(args.threshold)
    print(f"{len(frames)} frames; {len(pairs)} near-duplicate pairs "
          f"at cosine distance < {args.threshold}")
    drop = set()
    for i, j in pairs:
        if i not in drop:
            drop.add(j)
    for i, j in pairs[:20]:
        print(f"  {i:5d} ~ {j:5d}")
    if len(pairs) > 20:
        print(f"  ... {len(pairs) - 20} more")
    print(f"unique frames: {len(frames) - len(drop)}")
    if args.keep:
        from ..io.extxyz import write_extxyz
        kept = [f for k, f in enumerate(frames) if k not in drop]
        write_extxyz(args.keep, kept)
        print(f"wrote {args.keep} ({len(kept)} frames)")
    return 0


def _compute_strength(args):
    from ..calculator import TensorAlloyCalculator
    from ..analysis.elastic import (ideal_strength,
                                    ideal_shear_strength)
    calc = TensorAlloyCalculator(args.model, **_placement(args))
    s = _load_crystal(args.crystal)
    if args.shear is not None:
        res = ideal_shear_strength(
            calc, s, plane_axis=args.axis, shear_dir=args.shear,
            max_strain=args.max_strain, n_points=args.n_points,
            fmax=args.fmax)
        res["sigma_max_gpa"] = res["tau_max_gpa"]
        res["eps_at_max"] = res["gamma_at_max"]
        print("gamma    tau (GPa)")
        for e, st in zip(res["strain"], res["stress_gpa"]):
            print(f"{e:6.3f} {st:12.3f}")
        print(f"mu(small-strain secant) = "
              f"{res['shear_modulus_gpa']:.1f} GPa")
        print(f"ideal shear strength = {res['tau_max_gpa']:.2f} GPa "
              f"at gamma {res['gamma_at_max']:.3f}")
        if args.output:
            with open(args.output, "w") as fh:
                fh.write("strain,stress_gpa,e_per_atom\n")
                for row in zip(res["strain"], res["stress_gpa"],
                               res["energy_per_atom"]):
                    fh.write(",".join(f"{x:.8g}" for x in row)
                             + "\n")
            print(f"wrote {args.output}")
        return 0
    res = ideal_strength(calc, s, axis=args.axis,
                         max_strain=args.max_strain,
                         n_points=args.n_points, fmax=args.fmax)
    print("strain   sigma_axial (GPa)")
    for e, st in zip(res["strain"], res["stress_gpa"]):
        print(f"{e:6.3f} {st:12.3f}")
    print(f"E(small-strain secant) = "
          f"{res['youngs_modulus_gpa']:.1f} GPa")
    print(f"ideal strength = {res['sigma_max_gpa']:.2f} GPa at "
          f"strain {res['eps_at_max']:.3f}")
    if args.output:
        with open(args.output, "w") as fh:
            fh.write("strain,stress_gpa,e_per_atom\n")
            for row in zip(res["strain"], res["stress_gpa"],
                           res["energy_per_atom"]):
                fh.write(",".join(f"{x:.8g}" for x in row) + "\n")
        print(f"wrote {args.output}")
    return 0


def _compute_fe(args):
    """Frenkel-Ladd absolute free energy (analysis/ti.py)."""
    from ..io.model import load_model
    from ..analysis.ti import frenkel_ladd
    model, _ = load_model(args.model, **_placement(args))
    s = _load_crystal(args.structure)
    if args.supercell:
        s = s.repeat(tuple(args.supercell))
    print(f"Frenkel-Ladd TI: {len(s)} atoms at {args.temp} K, "
          f"{args.n_lambda} Gauss-Legendre lambdas x {args.steps} "
          f"production steps")
    res = frenkel_ladd(model, s, args.temp,
                       k_spring=args.k_spring,
                       n_lambda=args.n_lambda,
                       equil_steps=args.equil_steps,
                       prod_steps=args.steps,
                       timestep=args.timestep, seed=args.seed)
    print(f"spring constant k = {res['k_spring']:.4f} eV/A^2")
    print("lambda   <U_model - U_E> (eV)   stderr")
    for lam, du, se in zip(res["lambdas"], res["du_mean"],
                           res["du_stderr"]):
        print(f"{lam:7.4f} {du:18.6f} {se:12.6f}")
    print(f"F_Einstein(3N-3) = "
          f"{res['f_einstein'] - res['f_einstein_com']:.6f} eV; "
          f"dF_int = {res['delta_f']:.6f} eV; "
          f"F_COM(free) = {res['f_com_free']:.6f} eV")
    print(f"F = {res['free_energy']:.6f} eV "
          f"({res['free_energy_per_atom'] * 1000:.3f} meV/atom... "
          f"{res['free_energy_per_atom']:.6f} eV/atom)")
    return 0


def _compute_visc(args):
    """Green-Kubo shear viscosity: stress recorded inside the jitted
    chunk (`record_stress=True`), off-diagonal ACF integral."""
    import numpy as np
    from ..dynamics import VelocityVerlet
    from ..io.model import load_model
    from ..analysis.heatflux import green_kubo_viscosity
    model, _ = load_model(args.model, **_placement(args))
    s = _load_crystal(args.structure)
    if args.supercell:
        s = s.repeat(tuple(args.supercell))
    print(f"equilibration: NVT {args.temp} K, {args.equil_steps} "
          f"steps @ {args.timestep} fs ({len(s)} atoms)")
    md_eq = VelocityVerlet(
        model, s, timestep=args.timestep, skin=args.skin,
        chunk_size=max(args.sample, 20), temperature=args.temp,
        seed=args.seed, target_temperature=args.temp,
        friction=args.friction)
    md_eq.run(args.equil_steps)
    print(f"  T after equilibration: {md_eq.temperature:.1f} K")
    kw = {}
    if args.nvt_production:
        kw = dict(target_temperature=args.temp,
                  friction=args.friction)
    md = VelocityVerlet(model, md_eq.structure,
                        timestep=args.timestep, skin=args.skin,
                        chunk_size=args.sample, seed=args.seed,
                        device_nl=args.device_nl, record_stress=True,
                        **kw)
    md.velocities_vap = md_eq.velocities_vap.copy()
    md.zero_com_velocity()     # Langevin leaves a random COM drift
    regime = "NVT" if args.nvt_production else "NVE"
    print(f"production: {regime} {args.steps} steps, stress sampled "
          f"every {args.sample * args.timestep} fs")
    visc_header = "lag_fs,sacf_eVA3_sq,eta_running_Pa_s"
    for S_hist, T_hist, done in _segmented_production(
            md, args, "stress_tensor"):
        if args.output and done < args.steps and len(S_hist) >= 4:
            gk_part = green_kubo_viscosity(
                np.stack(S_hist), dt=args.sample * args.timestep,
                volume=md.structure.volume,
                temperature=float(np.mean(T_hist)),
                max_lag=args.max_lag)
            _write_gk_csv(
                args.output, visc_header,
                (gk_part["lags"], gk_part["sacf"],
                 gk_part["eta_running"]),
                partial=f"production {done}/{args.steps} steps, "
                        f"{len(S_hist)} frames")
            print(f"  flushed partial GK at {done}/{args.steps} "
                  f"steps (eta so far "
                  f"{gk_part['eta'] * 1e3:.4f} mPa s)", flush=True)
    t_mean = float(np.mean(T_hist))
    sig = np.stack(S_hist)
    gk = green_kubo_viscosity(sig, dt=args.sample * args.timestep,
                              volume=md.structure.volume,
                              temperature=t_mean,
                              max_lag=args.max_lag)
    _write_gk_csv(args.output, visc_header,
                  (gk["lags"], gk["sacf"], gk["eta_running"]))
    er = gk["eta_running"]
    plateau = float(np.mean(er[len(er) // 2:]))
    lo, hi = gk["plateau_window"]
    print(f"<T> = {t_mean:.1f} K over {len(sig)} frames")
    print(f"eta(max lag) = {gk['eta'] * 1e3:.4f} mPa s; plateau mean "
          f"(last half of lags) = {plateau * 1e3:.4f} mPa s")
    print(f"eta(ACF-decay window, lags {lo}..{hi}) = "
          f"{gk['eta_plateau'] * 1e3:.4f} +/- "
          f"{gk['eta_plateau_se'] * 1e3:.4f} mPa s  <- headline "
          f"estimator")
    print(f"wrote {args.output}")
    return 0


def _compute_surface(args):
    from ..calculator import TensorAlloyCalculator
    from ..analysis.surface import surface_energy
    calc = TensorAlloyCalculator(args.model, **_placement(args))
    bulk = _load_crystal(args.crystal)
    r = surface_energy(calc, bulk, tuple(args.miller),
                       layers=args.layers, vacuum=args.vacuum,
                       relax=not args.no_relax, fmax=args.fmax)
    h, k, l = args.miller
    print(f"slab ({h}{k}{l}): {r['n_atoms']} atoms, "
          f"area {r['area_a2']:.3f} A^2, "
          f"surface relaxation {r['relaxation_ev'] * 1000:.2f} meV")
    print(f"gamma({h}{k}{l}) = {r['gamma_j_m2']:.4f} J/m^2 "
          f"({r['gamma_ev_a2']:.6f} eV/A^2)")
    return 0



def _compute_gb(args):
    from ..calculator import TensorAlloyCalculator
    from ..analysis.surface import (grain_boundary_energy,
                                    twist_boundary_energy)
    calc = TensorAlloyCalculator(args.model, **_placement(args))
    bulk = _load_crystal(args.crystal)
    h, k, l = args.miller
    if args.twist is not None:
        r = twist_boundary_energy(
            calc, bulk, tuple(args.miller), args.twist,
            layers=args.layers, relax=not args.no_relax,
            min_dist=args.min_dist if args.min_dist > 0 else None)
        kind = f"{args.twist:.2f}-degree twist"
    else:
        r = grain_boundary_energy(
            calc, bulk, tuple(args.miller), layers=args.layers,
            plane_centered=not args.mid_plane,
            relax=not args.no_relax, min_dist=args.min_dist)
        kind = "symmetric tilt"
    print(f"({h}{k}{l}) {kind} bicrystal: {r['n_atoms']} "
          f"atoms, area {r['area_a2']:.2f} A^2, best translation "
          f"{r['translation']}")
    print(f"gamma_GB = {r['gamma_j_m2']:.4f} J/m^2 "
          f"({r['gamma_mj_m2']:.1f} mJ/m^2)")
    if args.output:
        from ..io.extxyz import write_extxyz
        write_extxyz(args.output, [r["structure"]])
        print(f"wrote {args.output}")
    return 0


def _compute_sfe(args):
    import numpy as np
    from ..calculator import TensorAlloyCalculator
    from ..analysis.surface import (stacking_fault_energy, gamma_line,
                                    gamma_surface)
    calc = TensorAlloyCalculator(args.model, **_placement(args))
    bulk = _load_crystal(args.crystal)
    h, k, l = args.miller
    relax = not args.no_relax
    if args.grid is not None:
        r = gamma_surface(calc, bulk, tuple(args.miller),
                          n_grid=tuple(args.grid), layers=args.layers,
                          relax=relax)
        with open(args.output, "w") as fh:
            fh.write("u,v,gamma_mj_m2\n")
            for i, uu in enumerate(r["u"]):
                for j, vv in enumerate(r["v"]):
                    fh.write(f"{uu:.6f},{vv:.6f},"
                             f"{r['gamma_mj_m2'][i, j]:.4f}\n")
        print(f"({h}{k}{l}) gamma-surface {args.grid[0]}x"
              f"{args.grid[1]}: {r['n_atoms']} atoms/cell, "
              f"max gamma = {r['gamma_max_mj_m2']:.2f} mJ/m^2")
        print(f"wrote {args.output}")
        return 0
    if args.line is not None:
        # --shift doubles as the path direction; (1/3,1/3) would be a
        # point, so the default direction is the full (1,1) path
        direction = tuple(args.shift)
        if np.allclose(direction, (1 / 3, 1 / 3)):
            direction = (1.0, 1.0)
        r = gamma_line(calc, bulk, tuple(args.miller),
                       direction=direction, n_points=args.line,
                       layers=args.layers, relax=relax)
        with open(args.output, "w") as fh:
            fh.write("t,gamma_mj_m2\n")
            for t, g in zip(r["t"], r["gamma_mj_m2"]):
                fh.write(f"{t:.6f},{g:.4f}\n")
        print(f"({h}{k}{l}) path along ({direction[0]:.3f}, "
              f"{direction[1]:.3f}): gamma_us = "
              f"{r['gamma_us_mj_m2']:.2f} mJ/m^2"
              + (f", gamma_isf = {r['gamma_isf_mj_m2']:.2f} mJ/m^2"
                 if "gamma_isf_mj_m2" in r else ""))
        print(f"wrote {args.output}")
        return 0
    r = stacking_fault_energy(calc, bulk, tuple(args.miller),
                              tuple(args.shift), layers=args.layers,
                              relax=relax)
    print(f"({h}{k}{l}) shift ({args.shift[0]:.4f}, "
          f"{args.shift[1]:.4f}): {r['n_atoms']} atoms, "
          f"area {r['area_a2']:.3f} A^2")
    print(f"gamma = {r['gamma_mj_m2']:.2f} mJ/m^2")
    return 0


def _compute_qha(args):
    import numpy as np
    from ..calculator import TensorAlloyCalculator
    from ..analysis.phonon import quasi_harmonic
    calc = TensorAlloyCalculator(args.model, **_placement(args))
    crystal = _load_crystal(args.crystal)
    temps = [float(t) for t in args.temps.split(",")]
    lo, hi, n = args.scales
    out = quasi_harmonic(calc, crystal, temps,
                         scales=np.linspace(lo, hi, int(n)),
                         supercell=tuple(args.supercell),
                         qmesh=tuple(args.qmesh), eos=args.eos)
    print("T (K)   V (A^3/cell)  a/a0      alpha (1e-6/K)  B (GPa)")
    for i, t in enumerate(out["T"]):
        print(f"{t:7.1f} {out['volume'][i]:12.4f} "
              f"{out['a_scale'][i]:9.5f} "
              f"{out['alpha'][i] * 1e6:14.2f} "
              f"{out['bulk_modulus'][i]:9.2f}")
    return 0


def _compute_rdf(args):
    import numpy as np
    from ..analysis.trajectory import radial_distribution
    from ..io.extxyz import read_extxyz
    frames = read_extxyz(args.trajectory)
    out = radial_distribution(frames, rmax=args.rmax,
                              nbins=args.nbins, device=args.device)
    keys = [k for k in out if k != "r"]
    with open(args.output, "w") as fh:
        fh.write("r," + ",".join(keys) + "\n")
        for i, r in enumerate(out["r"]):
            fh.write(f"{r:.6f}," + ",".join(
                f"{out[k][i]:.6f}" for k in keys) + "\n")
    for k in keys:
        peak = int(np.argmax(out[k]))
        print(f"g({k}): first-max at r = {out['r'][peak]:.3f} A "
              f"(g = {out[k][peak]:.2f})")
    print(f"wrote {args.output} ({len(frames)} frames averaged)")
    return 0


def _compute_neb(args):
    from ..calculator import TensorAlloyCalculator
    from ..neb import NEB
    calc = TensorAlloyCalculator(args.model, **_placement(args))
    s_i = _load_crystal(args.initial)
    s_f = _load_crystal(args.final)
    if args.relax_endpoints:
        from ..analysis.elastic import relax_positions
        s_i = relax_positions(calc, s_i, fmax=args.fmax)
        s_f = relax_positions(calc, s_f, fmax=args.fmax)
    neb = NEB(calc.model, s_i, s_f,
              n_images=args.n_images, k=args.spring,
              climb=not args.no_climb, n_shards=args.shards)
    res = neb.run(fmax=args.fmax, max_steps=args.max_steps)
    # every rank of a sharded band holds the same result: rank 0 writes
    writes = neb.mesh.is_main
    state = "converged" if res["converged"] else \
        f"NOT converged (fmax={res['fmax']:.4f})"
    print(f"{state} after {res['n_steps']} FIRE steps")
    print(f"forward barrier : {res['barrier']:.6f} eV")
    print(f"reverse barrier : {res['reverse_barrier']:.6f} eV")
    print(f"reaction dE     : {res['delta_e']:.6f} eV")
    if args.output and writes:
        with open(args.output, "w") as fh:
            fh.write("image,energy\n")
            for m, e in enumerate(res["energies"]):
                fh.write(f"{m},{e:.8f}\n")
        print(f"wrote {args.output}")
    return 0


def _compute_phonon(args):
    import numpy as np
    from ..calculator import TensorAlloyCalculator
    from ..analysis.phonon import PhononCalculator, FCC_PATH, BCC_PATH
    calc = TensorAlloyCalculator(args.model, **_placement(args))
    crystal = _load_crystal(args.crystal)
    ph = PhononCalculator(calc, crystal, supercell=tuple(args.supercell))
    if args.temps:
        temps = [float(t) for t in args.temps.split(",")]
        th = ph.thermal_properties(temps, qmesh=tuple(args.qmesh))
        n = len(crystal)
        print(f"ZPE = {th['zpe'] / n * 1000:.3f} meV/atom "
              f"({th['n_skipped']} modes skipped)")
        print("T (K)   F_vib (meV/at)  S_vib (kB/at)  C_v (kB/at)")
        for i, t in enumerate(temps):
            from ..analysis.phonon import KB_EV
            print(f"{t:7.1f} {th['free_energy'][i] / n * 1000:14.3f} "
                  f"{th['entropy'][i] / n / KB_EV:14.4f} "
                  f"{th['heat_capacity'][i] / n / KB_EV:12.4f}")
    if args.path == "gamma":
        freqs = ph.gamma_frequencies()
        print("Gamma frequencies (THz):",
              " ".join(f"{f:.3f}" for f in freqs))
        return 0
    qpath = FCC_PATH if args.path == "fcc" else BCC_PATH
    band = ph.band_structure(qpath, npoints=args.npoints)
    with open(args.output, "w") as fh:
        nb = band["frequencies"].shape[1]
        fh.write("distance," + ",".join(f"band{i}"
                                        for i in range(nb)) + "\n")
        for d, row in zip(band["distances"], band["frequencies"]):
            fh.write(f"{d}," + ",".join(f"{x:.6f}" for x in row) + "\n")
    labels = " ".join(f"{l}@{d:.3f}" for d, l in band["labels"])
    print(f"wrote {args.output}; ticks: {labels}")
    return 0


def _load_crystal(path):
    from ..io.extxyz import read_extxyz
    if path.endswith(".cif"):
        from ..io.cif import read_cif
        return read_cif(path)
    if not os.path.exists(path):
        # built-in crystal name ('Ni', 'Mo/dft', 'Ni3Mo', ...)
        from ..data.crystals import built_in_crystals
        lib = built_in_crystals()
        if path in lib:
            return lib[path].structure
        raise FileNotFoundError(
            f"{path!r} is neither a structure file nor a built-in "
            f"crystal (known: {sorted(lib)})")
    return read_extxyz(path)[0]


def _compute_eos(args):
    import numpy as np
    from ..calculator import TensorAlloyCalculator
    from ..analysis.eos import EquationOfState
    calc = TensorAlloyCalculator(args.model, **_placement(args))
    crystal = _load_crystal(args.crystal)
    volumes, energies = [], []
    for x in np.linspace(args.xlo, args.xhi, args.num):
        s = crystal.copy()
        scale = x ** (1.0 / 3.0)
        s.cell = s.cell * scale
        s.positions = s.positions * scale
        volumes.append(s.volume)
        energies.append(calc.get_potential_energy(s))
    eos = EquationOfState(volumes, energies, eos=args.eos)
    v0, e0, b = eos.fit()
    from ..nn.fields import EV_ANGSTROM3_TO_GPA
    print(f"E0 = {e0:.6f} eV, V0 = {v0:.6f} A^3, "
          f"B = {b * EV_ANGSTROM3_TO_GPA:.2f} GPa")
    if args.output:
        with open(args.output, "w") as fh:
            fh.write("volume,energy\n")
            for v, e in zip(volumes, energies):
                fh.write(f"{v},{e}\n")
    return 0


def _compute_relax(args):
    import numpy as np
    from ..calculator import TensorAlloyCalculator
    from ..analysis.elastic import relax_cell, relax_positions
    from ..io.extxyz import write_extxyz
    calc = TensorAlloyCalculator(args.model, **_placement(args))
    s = _load_crystal(args.structure)
    e_in = calc.get_potential_energy(s)
    if args.cell:
        v_in = s.volume
        s = relax_cell(calc, s, fmax=args.fmax, smax=args.smax,
                       steps=args.steps, pressure=args.pressure,
                       hydrostatic=args.hydrostatic)
    else:
        s = relax_positions(calc, s, fmax=args.fmax, steps=args.steps)
    e_out = calc.get_potential_energy(s)
    f = np.abs(np.asarray(calc.get_forces(s))).max()
    s.info["energy"] = float(e_out)
    write_extxyz(args.output, [s])
    converged = f < args.fmax
    if args.cell:
        from ..nn.fields import EV_ANGSTROM3_TO_GPA
        s_gpa = np.abs(np.asarray(calc.get_stress(s))
                       * EV_ANGSTROM3_TO_GPA
                       + args.pressure * np.array(
                           [1.0, 1, 1, 0, 0, 0])).max()
        converged = converged and s_gpa < args.smax
        a, b, c = np.linalg.norm(s.cell, axis=1)
        print(f"cell: V {v_in:.3f} -> {s.volume:.3f} A^3, "
              f"a/b/c = {a:.4f}/{b:.4f}/{c:.4f} A, "
              f"max|sigma + P| = {s_gpa:.4f} GPa")
    state = "converged" if converged else "NOT converged"
    print(f"{state}: E {e_in:.6f} -> {e_out:.6f} eV "
          f"(dE = {e_out - e_in:+.6f}), max|F| = {f:.4f} eV/A")
    print(f"wrote {args.output}")
    return 0


def _compute_latt(args):
    """Equilibrium lattice constant from the EOS minimum (ref analog:
    analysis/lammps LatticeConstant driver, which needs LAMMPS). The
    input cell is scaled isotropically; a0 = cbrt(V0 / V) * a_in per
    cell vector, exact for cubic conventional cells."""
    import numpy as np
    from ..calculator import TensorAlloyCalculator
    from ..analysis.eos import EquationOfState
    calc = TensorAlloyCalculator(args.model, **_placement(args))
    crystal = _load_crystal(args.crystal)
    volumes, energies = [], []
    for x in np.linspace(args.xlo, args.xhi, args.num):
        s = crystal.copy()
        scale = x ** (1.0 / 3.0)
        s.cell = s.cell * scale
        s.positions = s.positions * scale
        volumes.append(s.volume)
        energies.append(calc.get_potential_energy(s))
    eos = EquationOfState(volumes, energies, eos=args.eos)
    v0, e0, b = eos.fit()
    from ..nn.fields import EV_ANGSTROM3_TO_GPA
    scale = (v0 / crystal.volume) ** (1.0 / 3.0)
    a, bv, c = (np.linalg.norm(crystal.cell, axis=1) * scale)
    print(f"a = {a:.6f} A, b = {bv:.6f} A, c = {c:.6f} A")
    print(f"E0 = {e0 / len(crystal):.6f} eV/atom, "
          f"B = {b * EV_ANGSTROM3_TO_GPA:.2f} GPa")
    return 0


def _compute_elastic(args):
    from ..calculator import TensorAlloyCalculator
    from ..analysis.elastic import (compute_elastic_tensor,
                                    fit_elastic_tensor)
    calc = TensorAlloyCalculator(args.model, **_placement(args))
    crystal = _load_crystal(args.crystal)
    if getattr(args, "method", "fit") == "cdiff":
        c = compute_elastic_tensor(calc, crystal)
    else:
        c, info = fit_elastic_tensor(
            calc, crystal, lattice=getattr(args, "lattice", None),
            relax_ions=getattr(args, "relax_ions", False))
        print(f"lattice family: {info['lattice']}")
        for name, value in info["cij"].items():
            print(f"  {name} = {value:.2f} GPa")
    print("elastic tensor (GPa):")
    for row in c:
        print("  " + " ".join(f"{x:10.2f}" for x in row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
