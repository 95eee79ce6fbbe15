"""The port's command line against the JAX package's: the verbs other
than `compute` (build, run, export, stop, evaluate, print, vasp2lammps),
the arguments of every verb and task, `uncertainty`, the segmented
production of the Green-Kubo tasks, what is refused, and the float64
fixture of chip_smoke.py's cli phase.

Each case runs the JAX `main` in this process (float64: the conftest's
policy is "high") and the port's `main(..., device="cpu", dtype="high")`
on the same inputs, each in its own working directory under tmp_path,
and compares what they print and the files they write: each number to
1e-8 of the largest number of its line, a printed number standing for
its value to half a unit of its last digit (`chip_smoke.
printed_mismatches`).

    python -m tests.test_torch_cli_verbs

rewrites tests/data/torch_port_ref_cli.json (the JAX command line at
float64 on the CPU; about a minute).
"""
import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from tensoralloy_tpu.cli.entry import (
    _segmented_production as jax_segmented, main as jax_main)
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.cli import entry
from tensoralloy_tpu_torch.cli.entry import main as torch_main
from tensoralloy_tpu_torch.io.extxyz import write_extxyz
from tensoralloy_tpu_torch.io.sqlite import connect

ROOT = Path(__file__).resolve().parent.parent
ARTIFACTS = ROOT / "artifacts"
FIXTURE = ROOT / "tests" / "data" / "torch_port_ref_cli.json"
REL = 1e-8


def port_main(argv):
    return torch_main(argv, device="cpu", dtype="high")


def run_both(argv, tmp_path, prepare=None):
    """`argv` through both command lines, each in tmp_path/<package>,
    `prepare(workdir)` first. -> (port's record, JAX's record) of
    `chip_smoke.run_verb`, the working directory named WORKDIR in what
    they print."""
    recs = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        work = tmp_path / name
        work.mkdir()
        if prepare is not None:
            prepare(work)
        rec = chip_smoke.run_verb(main, argv, work)
        rec["stdout"] = rec["stdout"].replace(str(work), "WORKDIR")
        recs[name] = rec
    return recs["port"], recs["jax"]


def assert_same_output(got, want, rel=REL, files=True, stdout_rel=None):
    """Exit code, printed text (to `stdout_rel` where given) and written
    text files agree."""
    assert got["rc"] == want["rc"]
    miss = chip_smoke.printed_mismatches(got["stdout"], want["stdout"],
                                         stdout_rel or rel)
    assert not miss, (miss[:5], got["stdout"], want["stdout"])
    if files:
        assert sorted(got["files"]) == sorted(want["files"])
        for name, text in want["files"].items():
            miss = chip_smoke.printed_mismatches(got["files"][name], text,
                                                 rel)
            assert not miss, (name, miss[:5])


def same_structures(a, b, rel=REL):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numbers, y.numbers)
        for got, want in ((x.positions, y.positions), (x.cell, y.cell)):
            np.testing.assert_allclose(got, want, rtol=rel, atol=rel)
        assert sorted(x.info) == sorted(y.info)
        for k in y.info:
            if isinstance(y.info[k], str):
                assert x.info[k] == y.info[k]
            else:
                np.testing.assert_allclose(x.info[k], y.info[k], rtol=rel,
                                           atol=rel, err_msg=k)


def ni_frames(n=4, seed=3, labels=True):
    """Jittered fcc Ni cells of 32 atoms with seeded energy and forces."""
    rng = np.random.RandomState(seed)
    frames = []
    for i in range(n):
        pos, cell = chip_smoke.jittered_fcc(2, seed=seed + i)
        s = Structure.from_symbols(["Ni"] * len(pos), pos, cell,
                                   pbc=[True] * 3)
        if labels:
            s.info["energy"] = float(rng.normal(-180.0, 1.0))
            s.info["forces"] = rng.normal(0.0, 0.4 + 0.4 * i, (len(pos), 3))
            s.info["source"] = f"Ni.{'Bulk' if i % 2 else 'Shear'}.{i}"
        frames.append(s)
    return frames


# ----------------------------------------------------------------------
# the arguments of every verb and task
# ----------------------------------------------------------------------

def _help(main, argv) -> str:
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        main(argv + ["--help"])
    assert e.value.code == 0
    text = out.getvalue().replace("tensoralloy_tpu_torch", "PROG")
    return " ".join(text.replace("tensoralloy_tpu", "PROG").split())


VERBS = ["build", "run", "export", "stop", "evaluate", "print", "compute",
         "vasp2lammps"]
TASKS = ["scatter", "dbnum", "dbfstd", "eos", "latt", "relax",
         "percentile", "elastic", "neb", "defect", "uncertainty", "md",
         "kappa", "vdos", "diffusion", "dedup", "strength", "fe", "visc",
         "surface", "gb", "sfe", "qha", "rdf", "phonon"]


def test_every_verb_and_task_is_ported():
    top = _help(jax_main, [])
    assert re.search(r"\{(.*?)\}", top).group(1).split(",") == VERBS
    tasks = _help(jax_main, ["compute"])
    assert re.search(r"\{(.*?)\}", tasks).group(1).split(",") == TASKS
    assert _help(torch_main, ["compute"]) == tasks


@pytest.mark.parametrize("argv", [[v] for v in VERBS]
                         + [["compute", t] for t in TASKS],
                         ids=lambda a: " ".join(a))
def test_arguments_as_jax(argv):
    """The same arguments, defaults and help under each verb and task
    (the program's name aside)."""
    assert _help(torch_main, argv) == _help(jax_main, argv)


# ----------------------------------------------------------------------
# build, print, vasp2lammps, stop
# ----------------------------------------------------------------------

BUILDS = {"eV": [], "hartree": ["--energy-unit", "Hartree"],
          "fmax": ["--fmax", "3.0"], "kcal": ["--energy-unit", "kcal/mol",
                                              "--vacuum", "15.0"]}


@pytest.mark.parametrize("case", sorted(BUILDS))
def test_build_as_jax(case, tmp_path):
    frames = ni_frames()
    frames[2].cell = np.zeros((3, 3))       # no cell: --vacuum applies
    frames[2].pbc = np.array([False] * 3)

    def prepare(work):
        write_extxyz(str(work / "ni.extxyz"), frames)

    got, want = run_both(["build", "ni.extxyz", "--output", "ni.db",
                          *BUILDS[case]], tmp_path, prepare)
    assert_same_output(got, want, files=False)
    assert "structures, elements ['Ni']" in got["stdout"]
    same_structures(list(connect(str(tmp_path / "port" / "ni.db"))),
                    list(connect(str(tmp_path / "jax" / "ni.db"))))


TF_LOG = """\
2019-01-01 tensorflow INFO pid=101
2019-01-01 tensorflow INFO Saving dict for global step 100: global_step = 100, loss = 9.5, Elastic/Al/fcc/C11/Cijkl = 100.04
2019-01-01 tensorflow INFO pid=202
2019-01-01 tensorflow INFO Saving dict for global step 500: global_step = 500, loss = 8.926156, Elastic/Al/fcc/C11/Cijkl = 109.63, Elastic/Al/fcc/kbar/Constraints = 0.25
2019-01-01 tensorflow INFO some other line
2019-01-01 tensorflow INFO Saving dict for global step 1000: global_step = 1000, loss = 7.1e-01, Elastic/Al/fcc/C11/Cijkl = 110.01, Elastic/Al/fcc/kbar/Constraints = -0.05
"""
PRINTS = {
    "history.json": json.dumps([{"step": 1, "energy/mae": 0.5},
                                {"step": 2, "energy/mae": 0.25}]),
    "metrics.jsonl": "\n".join(json.dumps({"step": s, "loss/total": 1.5 / s,
                                           "lr": 2e-3})
                               for s in (10, 20, 30)) + "\n",
    "empty.json": "[]",
    "logfile": TF_LOG,
    "empty_logfile": "nothing to see\n",
    "run/summary.csv": "step,loss\n1,0.5\n",
}


@pytest.mark.parametrize("name", sorted(PRINTS))
def test_print_as_jax(name, tmp_path):
    def prepare(work):
        (work / name).parent.mkdir(parents=True, exist_ok=True)
        (work / name).write_text(PRINTS[name])

    got, want = run_both(["print", name], tmp_path, prepare)
    assert_same_output(got, want)
    got, want = (chip_smoke.run_verb(m, ["print", name, "--output",
                                         "out.csv"], tmp_path / p)
                 for m, p in ((port_main, "port"), (jax_main, "jax")))
    assert_same_output(got, want)


@pytest.mark.parametrize("specorder", [[], ["-s", "Ni", "Cu"]])
def test_vasp2lammps_as_jax(specorder, tmp_path):
    from tensoralloy_tpu_torch.tensordb.sampler import (make_phase_structure,
                                                        write_poscar)
    s = make_phase_structure("Cu", "fcc", 3.6).repeat((2, 1, 1))
    s.numbers[[1, 4]] = 28
    s.positions = s.positions + np.random.RandomState(1).normal(
        0, 0.05, s.positions.shape)

    def prepare(work):
        write_poscar(work / "POSCAR", s)

    got, want = run_both(["vasp2lammps", "POSCAR", "-o", "data.lammps",
                          *specorder], tmp_path, prepare)
    assert_same_output(got, want)
    assert "8 atoms" in got["files"]["data.lammps"]


def test_stop_as_jax(tmp_path):
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait(timeout=60)

    def no_pid(work):
        (work / "model").mkdir()

    got, want = run_both(["stop", "model"], tmp_path, no_pid)
    assert_same_output(got, want)
    assert got["rc"] == 1 and "no run.pid" in got["stdout"]
    for name in ("jax", "port"):
        (tmp_path / name / "model" / "run.pid").write_text(f"{proc.pid}\n")
    got, want = (chip_smoke.run_verb(m, ["stop", "model"], tmp_path / p)
                 for m, p in ((port_main, "port"), (jax_main, "jax")))
    assert_same_output(got, want)
    assert got["rc"] == 1 and "not running" in got["stdout"]


# ----------------------------------------------------------------------
# run, export, evaluate
# ----------------------------------------------------------------------

def _relative_config(run, work, overrides, database):
    """The run's input.toml with every path relative to `work` (so that
    both packages print the same paths), its database copied there."""
    config = chip_smoke.experiment_config(run, work, overrides,
                                          database=database)
    config["dataset"]["sqlite3"] = Path(config["dataset"]["sqlite3"]).name
    config["dataset"]["tfrecords_dir"] = "cache"
    config["train"]["model_dir"] = "model"
    return config


def test_run_and_export_as_jax(tmp_path):
    """`run` of artifacts/snap_ni_sfa/input.toml (its database cut to 14
    structures) for 3 float64 steps from the saved model's weights, then
    `export --checkpoint`, in both packages: the exported weights to
    1e-8, what export prints."""
    from test_torch_manager import cut_database
    small = tmp_path / "snap-Ni.db"
    cut_database(str(ARTIFACTS / "snap_ni" / "snap-Ni.db"), small, 14, 32)
    chip_smoke.warm_start_checkpoint(
        ARTIFACTS / "snap_ni_sfa" / "model" / "snap_Ni_sfa.npz",
        tmp_path / "warm.npz")
    exported = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        work = tmp_path / name
        work.mkdir()
        config = _relative_config("snap_ni_sfa", work, {
            "precision": "high", "dataset.test_size": 3,
            "train.batch_size": 4, "train.train_steps": 3,
            "train.scan_steps": 1, "train.eval_steps": 3,
            "train.log_steps": 3,
            "train.ckpt.checkpoint_filename": str(tmp_path / "warm.npz"),
            "train.ckpt.use_ema_variables": True,
            "train.ckpt.restore_optimizer_variables": False,
            "train.reset_global_step": True}, small)
        chip_smoke.dump_toml(config, work / "input.toml")
        rec = chip_smoke.run_verb(main, ["run", "input.toml", "--quiet"],
                                  work)
        # the reader resolves the file's paths against its directory
        path = work / "model" / "snap_Ni_sfa.npz"
        assert rec["rc"] == 0
        assert rec["stdout"].splitlines()[-1] == f"exported model to {path}"
        exported[name] = chip_smoke.run_verb(
            main, ["export", "input.toml", "--checkpoint",
                   "model/ckpt-3.npz", "--no-ema"], work)
        assert exported[name]["stdout"] == \
            f"exported model (step 3) to {path}\n"
    with np.load(tmp_path / "port" / "model" / "snap_Ni_sfa.npz") as z:
        got = {k: z[k] for k in z.files}
    with np.load(tmp_path / "jax" / "model" / "snap_Ni_sfa.npz") as z:
        want = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want)
    top = max(float(np.abs(v).max()) for k, v in want.items()
              if k != "__config__")
    with np.load(tmp_path / "warm.npz") as z:
        moved = max(float(np.abs(want[f"p/{k[7:]}"] - z[k]).max())
                    for k in z.files if k.startswith("params/"))
    assert moved > 1e-6         # three steps moved the weights
    for k in want:
        if k != "__config__":
            assert float(np.abs(got[k] - want[k]).max()) <= REL * top, k


def test_evaluate_per_group_as_jax(tmp_path):
    """`evaluate` of a run directory (trained by the JAX command line)
    per source group, in both packages: group_maes.json and the printed
    table."""
    base = tmp_path / "base"
    base.mkdir()
    db = connect(str(base / "g.db"))
    for s in ni_frames(8, seed=5):
        db.write(s)
    (base / "input.toml").write_text("""
precision = "high"
pair_style = "atomic/sf"
rcut = 4.5
seed = 5
[dataset]
sqlite3 = "g.db"
name = "g"
test_size = 2
tfrecords_dir = "cache"
[nn]
minimize = ['energy', 'forces']
[train]
model_dir = "model"
train_steps = 4
eval_steps = 2
batch_size = 2
""")
    assert chip_smoke.run_verb(jax_main, ["run", "input.toml", "--quiet"],
                               base)["rc"] == 0
    shutil.rmtree(base / "cache")

    def prepare(work):
        shutil.copytree(base, work, dirs_exist_ok=True)

    for extra in ([], ["--overall-only", "--no-ema", "--ckpt",
                       "model/ckpt-2.npz", "--output", "overall.json"]):
        for name in ("port", "jax"):
            shutil.rmtree(tmp_path / name, ignore_errors=True)
        got, want = run_both(["evaluate", ".", *extra], tmp_path, prepare)
        assert_same_output(got, want, files=False)
        out = "overall.json" if extra else "group_maes.json"
        got_json, want_json = ((tmp_path / name / out).read_text().replace(
            str(tmp_path / name), "WORKDIR") for name in ("port", "jax"))
        assert not chip_smoke.printed_mismatches(got_json, want_json, REL)
        report = json.loads(got_json)
        assert report["step"] == (2 if extra else 4)
        assert sorted(report["splits"]["test"]) == (
            ["overall"] if extra else ["Ni.Bulk", "Ni.Shear", "overall"])


# ----------------------------------------------------------------------
# uncertainty
# ----------------------------------------------------------------------

def _small_committee(work):
    """Three members of one small GRAP model (the JAX ensemble tests'
    architecture), saved by the JAX package."""
    import jax
    from test_ensemble import _setup
    from tensoralloy_tpu.io.model import save_model
    s, model, plist = _setup()
    paths = []
    for k, params in enumerate(plist):
        paths.append(f"m{k}.npz")
        save_model(str(work / paths[-1]), model, jax.device_get(params))
    return s, paths


COMMITTEES = {
    "small": (["--top", "2"], "extxyz"),
    "moni": (["--threshold", "0.0"], "db"),
}


@pytest.mark.parametrize("case", sorted(COMMITTEES))
def test_uncertainty_as_jax(case, tmp_path):
    """Committee ranking: the small committee over 3 frames, and the five
    MoNi GRAP members saved under artifacts/ over 4 jittered MoNi cells
    (read from a database)."""
    extra, kind = COMMITTEES[case]
    paths = None

    def prepare(work):
        nonlocal paths
        if case == "small":
            s, paths = _small_committee(work)
            frames = [Structure(s.numbers, s.positions, s.cell, s.pbc)]
        else:
            paths = [str(p) for p in chip_smoke.MONI_MEMBERS]
            frames = []
        rng = np.random.RandomState(1)
        base = frames[0] if frames else None
        for k in range(3 if case == "small" else 4):
            if base is not None:
                f = Structure(base.numbers, base.positions + 0.2 * rng.normal(
                    size=base.positions.shape), base.cell, base.pbc)
            else:
                pos, cell = chip_smoke.jittered_fcc(2, seed=k,
                                                    sigma=0.03 * (k + 1))
                f = Structure.from_symbols(
                    ["Mo" if j % 5 == 0 else "Ni" for j in range(len(pos))],
                    pos, cell, pbc=[True] * 3)
            frames.append(f)
        if kind == "db":
            out = connect(str(work / "frames.db"))
            for f in frames:
                out.write(f)
        else:
            write_extxyz(str(work / "frames.extxyz"), frames)

    recs = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        work = tmp_path / name
        work.mkdir()
        prepare(work)
        recs[name] = chip_smoke.run_verb(
            main, ["compute", "uncertainty", f"frames.{kind}", *paths,
                   *extra], work)
    assert_same_output(recs["port"], recs["jax"], files=False)
    rows = [ln for ln in recs["port"]["stdout"].splitlines()
            if not ln.startswith("#")]
    assert len(rows) == (2 if case == "small" else 4)
    one = chip_smoke.run_verb(port_main, ["compute", "uncertainty",
                                          f"frames.{kind}", paths[0]],
                              tmp_path / "port")
    assert one["rc"] == 1 and "at least 2" in one["stdout"]


# ----------------------------------------------------------------------
# the Green-Kubo tasks' segments
# ----------------------------------------------------------------------

class FakeMD:
    """run(n) records n and returns one frame a chunk of `sample`."""

    def __init__(self, sample):
        self.sample, self.calls = sample, []

    def run(self, n):
        self.calls.append(n)
        frames = -(-n // self.sample)
        return {"heat_flux": [float(len(self.calls))] * frames,
                "temperature": [300.0 + n] * frames}


@pytest.mark.parametrize("steps,flush,sample", [
    (100, 10, 3), (100, 0, 5), (60, 30, 5), (7, 50000, 5), (50, 4, 5),
    (35, None, 5), (12, 7, None)])
def test_segmented_production_as_jax(steps, flush, sample):
    args = argparse.Namespace(steps=steps)
    if flush is not None:
        args.flush_every = flush
    if sample is not None:
        args.sample = sample
    got_md, want_md = FakeMD(sample or 1), FakeMD(sample or 1)
    got = [(list(s), list(t), d) for s, t, d in
           entry._segmented_production(got_md, args, "heat_flux")]
    want = [(list(s), list(t), d) for s, t, d in
            jax_segmented(want_md, args, "heat_flux")]
    assert got == want and got_md.calls == want_md.calls
    assert got[-1][2] == steps


# ----------------------------------------------------------------------
# device, precision and what is refused
# ----------------------------------------------------------------------

def test_platform_variable_names_the_device(monkeypatch):
    for value, device in (("cpu", "cpu"), ("CPU", "cpu"), ("cuda", "cuda"),
                          ("gpu", "cuda"), ("", "cuda")):
        monkeypatch.setenv("TENSORALLOY_TPU_PLATFORM", value)
        assert entry.platform_device() == device
        assert entry.platform_device("cpu") == "cpu"
    monkeypatch.setenv("TENSORALLOY_TPU_PLATFORM", "tpu")
    with pytest.raises(ValueError, match=r"'tpu'.*\['cpu', 'cuda', 'gpu'\]"):
        torch_main(["compute", "dbnum", "x.db"])
    monkeypatch.delenv("TENSORALLOY_TPU_PLATFORM")
    model = str(ARTIFACTS / "snap_ni_sfa" / "model" / "snap_Ni_sfa.npz")
    if not torch.cuda.is_available():
        # the card by default: without one the verb raises, no fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_main(["compute", "latt", model, "Ni"])


def test_platform_cpu_and_float32_by_default(tmp_path, monkeypatch):
    """TENSORALLOY_TPU_PLATFORM=cpu runs on the CPU at float32, the JAX
    command line's default policy: a module run as a program."""
    env = dict(os.environ, TENSORALLOY_TPU_PLATFORM="cpu",
               PYTHONPATH=str(ROOT))
    model = str(ARTIFACTS / "mleam_ni" / "model" / "snap_Ni_mleam.npz")
    proc = subprocess.run(
        [sys.executable, "-m", "tensoralloy_tpu_torch.cli", "compute",
         "latt", model, "Ni", "--num", "5"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("a = ")
    seen = []
    monkeypatch.setattr(
        "tensoralloy_tpu_torch.calculator.TensorAlloyCalculator.__init__",
        lambda self, path, **kw: seen.append(kw) or (_ for _ in ()).throw(
            KeyboardInterrupt))
    with pytest.raises(KeyboardInterrupt):
        torch_main(["compute", "latt", model, "Ni"], device="cpu")
    assert seen == [{"device": "cpu", "dtype": "medium"}]


# a file that once raised NotImplementedError (several devices, until the
# port of `parallel/`)
NOT_PORTED = {
    "devices": ("snap_ni_sfa", {"distribute.strategy": "mirrored",
                                "distribute.num_devices": 4},
                "requested 4 devices but only 1 available"),
}


@pytest.mark.parametrize("case", sorted(NOT_PORTED))
def test_run_of_what_is_not_ported_raises_by_name(case, tmp_path):
    """A file that asks for more devices than the process's group has
    ranks raises the ValueError that JAX raises with too few devices;
    `python -m` exits non-zero. (Under `python -m torch.distributed.run`
    with that many ranks it trains: test_torch_parallel_train.py.)"""
    from test_torch_manager import cut_config
    run, overrides, match = NOT_PORTED[case]
    config = cut_config(run, tmp_path, overrides)
    chip_smoke.dump_toml(config, tmp_path / "input.toml")
    with pytest.raises(ValueError, match=match):
        torch_main(["run", str(tmp_path / "input.toml")], device="cpu")
    if case == "devices":
        proc = subprocess.run(
            [sys.executable, "-m", "tensoralloy_tpu_torch.cli", "run",
             str(tmp_path / "input.toml")], cwd=tmp_path,
            env=dict(os.environ, TENSORALLOY_TPU_PLATFORM="cpu",
                     PYTHONPATH=str(ROOT)),
            capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert "ValueError: " + match in proc.stderr


# the files that once raised: the descriptors' flat layout and legacy GRAP
ONCE_NOT_PORTED = {
    "segment": ("snap_ni_sfa", {"nn.atomic.sf.backend": "segment"}),
    "legacy": ("snap_ni_v5_readapt", {"nn.atomic.grap.legacy_mode": True,
                                      "nn.atomic.grap.moment_tensors":
                                          [0, 1, 2],
                                      "nn.atomic.grap.backend": "segment"}),
}


@pytest.mark.parametrize("case", sorted(ONCE_NOT_PORTED))
def test_run_of_a_segment_or_legacy_file_exports_what_jax_loads(case,
                                                                tmp_path):
    """`run` of a cut file with the segment backend or legacy GRAP trains
    and exports (exit 0); the exported model is the JAX manager's model,
    loads in the JAX package, and the JAX calculator serves it as the
    port's does (float64)."""
    from tensoralloy_tpu.calculator import (
        TensorAlloyCalculator as JaxCalculator)
    from tensoralloy_tpu.io.model import load_model as jax_load_model
    from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
    from test_torch_manager import cut_config
    run, overrides = ONCE_NOT_PORTED[case]
    config = cut_config(run, tmp_path, {
        **overrides, "train.train_steps": 2, "train.eval_steps": 2})
    chip_smoke.dump_toml(config, tmp_path / "input.toml")
    assert torch_main(["run", str(tmp_path / "input.toml")],
                      device="cpu") == 0
    path = str(Path(config["train"]["model_dir"])
               / f"{config['dataset']['name']}.npz")
    jax_model, _, _ = jax_load_model(path)
    desc = jax_model.descriptor
    assert desc.backend == "segment" and getattr(
        desc, "legacy_mode", False) == (case == "legacy")
    from tensoralloy_tpu.atoms import Structure as JaxStructure
    frame = ni_frames(1, labels=False)[0]
    got = TensorAlloyCalculator(path, device="cpu").calculate(frame)
    want = JaxCalculator(path)
    js = JaxStructure(frame.numbers, frame.positions, frame.cell, frame.pbc)
    errs = chip_smoke.efs_errors(got, {
        "energy": want.get_potential_energy(js),
        "forces": want.get_forces(js), "stress": want.get_stress(js)})
    assert max(errs.values()) <= 1e-10, errs


# ----------------------------------------------------------------------
# the float64 fixture of the cli phase
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(chip_smoke.cli_f64_cases()))
def test_cli_fixture_is_current(case, tmp_path):
    """The JAX command line at float64 still prints and writes what the
    fixture holds (1e-8), and so does the port on the CPU."""
    want = json.loads(FIXTURE.read_text())[case]
    for name, main in (("jax", jax_main), ("port", port_main)):
        got = chip_smoke.cli_f64_run(main, case, tmp_path / name)
        assert sorted(got["files"]) == sorted(want["files"])
        for part, text in [("stdout", want["stdout"])] + sorted(
                want["files"].items()):
            have = got["stdout"] if part == "stdout" else got["files"][part]
            miss = chip_smoke.printed_mismatches(
                have, text, chip_smoke.cli_f64_rel(case, part))
            assert not miss, (name, part, miss[:5])


def write_fixture():
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        out = {case: chip_smoke.cli_f64_run(jax_main, case,
                                            Path(tmp) / str(k))
               for k, case in enumerate(sorted(chip_smoke.cli_f64_cases()))}
    FIXTURE.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    print(f"wrote {FIXTURE} ({len(out)} cases)")


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from tensoralloy_tpu import set_precision
    set_precision("high")
    write_fixture()
