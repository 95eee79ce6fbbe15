"""The port's `compute` tasks of materials properties (eos, latt, relax,
elastic, defect, surface, gb, sfe, strength, qha, phonon) against the
JAX package's, each task (and each option that takes another code path)
one parametrised case. The dynamics and band tasks are in
test_torch_cli_dynamics.py, the tasks over databases and frames in
test_torch_cli_data.py; both take their cases and helpers from here.

Each case runs the JAX `main` in this process (float64 under the
conftest's "high" policy) and the port's `main(..., device="cpu",
dtype="high")`, each in its own working directory with the same inputs,
and compares the exit codes, what they print and the text files they
write: each number to 1e-8 of the largest number of its line (what an
equation-of-state fit prints, to its solver's precision,
`chip_smoke.CLI_FIT_REL`), a printed number standing for its value to
half a unit of its last digit. The models are float64 copies of the
saved snap_ni_sfa (G2 + G4 descriptors) and mleam_ni (EAM) under
artifacts/; the structures are small seeded cells written here.
"""
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from test_torch_cli_verbs import (
    assert_same_output, jax_main, ni_frames, port_main, run_both)
from tensoralloy_tpu_torch.io.extxyz import write_extxyz

ROOT = Path(__file__).resolve().parent.parent
# the models, placeholders in the cases: float64 copies of the saved
# files (which hold float32 weights, which the JAX package keeps, so that
# part of its arithmetic would stay in float32)
SF, EAM = "{sf}", "{eam}"
SAVED = {SF: ROOT / "artifacts" / "snap_ni_sfa" / "model" / "snap_Ni_sfa.npz",
         EAM: ROOT / "artifacts" / "mleam_ni" / "model" / "snap_Ni_mleam.npz"}
MODELS = {}
REL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def float64_models(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("models")
    for key, path in SAVED.items():
        MODELS[key] = chip_smoke.float64_copy(path, tmp / path.name)
    yield
    MODELS.clear()


def _argv(argv):
    return [MODELS.get(a, a) for a in argv]


def _db(work):
    """A database of 4 structures of snap-Ni.db (at most 32 atoms each)."""
    from test_torch_manager import cut_database
    cut_database(str(ROOT / "artifacts" / "snap_ni" / "snap-Ni.db"),
                 work / "db.db", 4, 32)


def _cell(work):
    """A jittered 32-atom fcc Ni cell."""
    write_extxyz(str(work / "ni32.extxyz"), ni_frames(1, labels=False))


def _dups(work):
    """Frames with near duplicates, as extxyz."""
    frames = ni_frames(3, labels=False)
    frames += [f.copy() for f in frames[:2]]
    frames[3].positions = frames[3].positions + 1e-4
    write_extxyz(str(work / "frames.extxyz"), frames)


def _hop(work):
    """The vacancy hop of a 2x2x2 fcc Ni cell."""
    initial, final = chip_smoke._vacancy_hop(2)
    write_extxyz(str(work / "initial.extxyz"), [initial])
    write_extxyz(str(work / "final.extxyz"), [final])


def _trajectory(work):
    """An NVE trajectory with velocities, and its integrator state,
    written by the JAX command line (both packages read the same)."""
    rec = chip_smoke.run_verb(jax_main, _argv([
        "compute", "md", EAM, "Ni", "--supercell", "2", "2", "2",
        "--steps", "40", "--chunk-size", "2", "--temp", "500",
        "--traj", "traj.extxyz", "--save-state", "state.npz",
        "-o", "final.extxyz"]), work)
    assert rec["rc"] == 0
    for name in ("final.extxyz",):
        (work / name).unlink()


# task cases -> (argv, prepare or None), in three groups, a test file
# each: the materials properties (here), the dynamics and band tasks
# (test_torch_cli_dynamics.py) and the tasks over databases and frames
# (test_torch_cli_data.py)
PROPERTIES = {
    "eos": (["eos", SF, "Ni", "--num", "7", "--eos", "vinet",
             "--output", "eos.csv"], None),
    "eos murnaghan": (["eos", EAM, "Ni", "--xlo", "0.95", "--xhi", "1.05",
                       "--eos", "murnaghan"], None),
    "latt": (["latt", EAM, "Ni", "--num", "9"], None),
    "relax": (["relax", SF, "ni32.extxyz", "-o", "relaxed.extxyz"], _cell),
    "relax --cell": (["relax", SF, "ni32.extxyz", "--cell", "--steps",
                      "300", "-o", "relaxed.extxyz"], _cell),
    "relax --cell --pressure --hydrostatic": (
        ["relax", EAM, "Ni", "--cell", "--pressure", "2.0", "--hydrostatic",
         "-o", "relaxed.extxyz"], None),
    "elastic cdiff": (["elastic", SF, "Ni", "--method", "cdiff"], None),
    "elastic --relax-ions": (["elastic", EAM, "Ni", "--relax-ions",
                              "--lattice", "cubic"], None),
    "defect --dipole": (["defect", EAM, "Ni", "--supercell", "2", "2", "2",
                         "--dipole", "--site", "5"], None),
    "defect --interstitial": (["defect", SF, "Ni", "--supercell", "2", "2",
                               "2", "--interstitial", "0.25", "0.25",
                               "0.25", "--dipole"], None),
    "strength": (["strength", EAM, "Ni", "--max-strain", "0.2",
                  "--n-points", "4", "-o", "strength.csv"], None),
    "strength --shear": (["strength", EAM, "Ni", "--shear", "0", "--axis",
                          "2", "--max-strain", "0.2", "--n-points", "3",
                          "-o", "shear.csv"], None),
    "surface": (["surface", SF, "Ni", "1", "0", "0", "--layers", "4",
                 "--no-relax"], None),
    "surface relaxed": (["surface", EAM, "Ni", "1", "1", "0", "--layers",
                         "4", "--vacuum", "10"], None),
    "gb": (["gb", EAM, "Ni", "3", "1", "0", "--layers", "4", "--no-relax",
            "-o", "gb.extxyz"], None),
    "gb --twist": (["gb", EAM, "Ni", "0", "0", "1", "--twist", "90",
                    "--layers", "2", "--no-relax"], None),
    "sfe": (["sfe", EAM, "Ni", "--layers", "4", "--no-relax"], None),
    "sfe --line": (["sfe", EAM, "Ni", "--layers", "4", "--no-relax",
                    "--line", "4", "-o", "line.csv"], None),
    "sfe --grid": (["sfe", EAM, "Ni", "--layers", "4", "--no-relax",
                    "--grid", "2", "2", "-o", "grid.csv"], None),
    "qha": (["qha", EAM, "Ni", "--temps", "0,300", "--supercell", "2", "2",
             "2", "--qmesh", "2", "2", "2", "--scales", "0.99", "1.02",
             "5"], None),
    "phonon": (["phonon", EAM, "Ni", "--npoints", "5", "--output",
                "bands.csv", "--temps", "300,600", "--qmesh", "2", "2",
                "2"], None),
    "phonon gamma": (["phonon", SF, "Ni", "--supercell", "1", "1", "1",
                      "--path", "gamma"], None),
}

DYNAMICS = {
    "neb": (["neb", EAM, "initial.extxyz", "final.extxyz", "--n-images",
             "5", "--max-steps", "30", "--output", "neb.csv"], _hop),
    "neb --relax-endpoints --no-climb": (
        ["neb", EAM, "initial.extxyz", "final.extxyz", "--n-images", "4",
         "--max-steps", "10", "--relax-endpoints", "--no-climb",
         "--spring", "2.0"], _hop),
    "md": (["md", EAM, "Ni", "--supercell", "2", "2", "2", "--steps", "30",
            "--chunk-size", "5", "--temp", "400", "--thermo", "thermo.csv",
            "--traj", "traj.extxyz", "--save-state", "state.npz",
            "-o", "md.extxyz"], None),
    "md --device-nl": (["md", SF, "ni32.extxyz", "--steps", "10",
                        "--chunk-size", "5", "--temp", "300",
                        "--device-nl", "-o", "md.extxyz"], _cell),
    "md --restart": (["md", EAM, "Ni", "--supercell", "2", "2", "2",
                      "--steps", "10", "--chunk-size", "5", "--restart",
                      "state.npz", "-o", "md.extxyz"], _trajectory),
    "kappa": (["kappa", EAM, "Ni", "--supercell", "2", "2", "2",
               "--equil-steps", "0", "--steps", "60", "--sample", "5",
               "--flush-every", "30", "-o", "kappa.csv"], None),
    "kappa --seeds": (["kappa", EAM, "Ni", "--supercell", "2", "2", "2",
                       "--equil-steps", "0", "--steps", "30", "--sample",
                       "5", "--seeds", "2", "--max-lag", "3",
                       "-o", "kappa.csv"], None),
    "visc": (["visc", EAM, "Ni", "--supercell", "2", "2", "2", "--temp",
              "800", "--equil-steps", "0", "--steps", "60", "--sample", "5",
              "--flush-every", "30", "-o", "visc.csv"], None),
    "vdos": (["vdos", "traj.extxyz", "-o", "vdos.csv"], _trajectory),
    "rdf": (["rdf", "traj.extxyz", "--rmax", "3.5", "--nbins", "30",
             "-o", "rdf.csv"], _trajectory),
    "diffusion": (["diffusion", EAM, "Ni", "--supercell", "2", "2", "2",
                   "--temps", "600,900", "--n-images", "3"], None),
}

DATA = {
    "scatter": (["scatter", SF, "db.db", "--output", "scatter.csv"], _db),
    "dbnum": (["dbnum", "db.db"], _db),
    "dbfstd": (["dbfstd", "db.db"], _db),
    "percentile": (["percentile", SF, "db.db", "--q", "10", "50", "99"],
                   _db),
    "dedup": (["dedup", "frames.extxyz", "--threshold", "0.001",
               "--keep", "kept.extxyz"], _dups),
}


def check_case(argv, prepare, tmp_path):
    """One task case through both command lines: the exit codes, what
    they print and the files they write."""
    got, want = run_both(_argv(["compute", *argv]), tmp_path, prepare)
    assert got["rc"] == want["rc"] == 0, got["stdout"]
    fitted = argv[0] in ("eos", "latt", "qha")
    assert_same_output(got, want, REL,
                       stdout_rel=chip_smoke.CLI_FIT_REL if fitted else REL)
    if "--save-state" in argv:
        with np.load(tmp_path / "port" / "state.npz") as a, \
                np.load(tmp_path / "jax" / "state.npz") as b:
            for k in ("positions", "velocities_vap", "cell"):
                if k in b.files:
                    np.testing.assert_allclose(a[k], b[k], rtol=REL,
                                               atol=REL)


@pytest.mark.parametrize("case", sorted(PROPERTIES))
def test_compute_as_jax(case, tmp_path):
    check_case(*PROPERTIES[case], tmp_path)


def test_site_out_of_range_exits_as_jax(tmp_path):
    for main in (port_main, jax_main):
        with pytest.raises(SystemExit, match="out of range"):
            main(_argv(["compute", "defect", EAM, "Ni", "--supercell", "1",
                        "1", "1", "--site", "9"]))
