"""The port's `tensordb` against the JAX package's: each module on the
same inputs, and the whole pipeline through `main`.

The VASP outputs are written here: INCAR, OSZICAR and OUTCAR from seeded
numbers, vasprun.xml by `test_torch_io_files.write_vasprun` and by
`chip_smoke.write_vasprun_frames` (the pipeline's AIMD runs). Each
package works in its own directory, entered as the working directory,
with relative paths, so that the trees they lay out can be compared file
by file, byte for byte.
"""
import os
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from test_torch_io_files import write_vasprun
import tensoralloy_tpu.tensordb as jdb
import tensoralloy_tpu_torch.tensordb as pdb
from tensoralloy_tpu.tensordb import calculator as jcalc
from tensoralloy_tpu.tensordb import cli as jcli
from tensoralloy_tpu.tensordb import microstructure as jms
from tensoralloy_tpu.tensordb import sampler as jsampler
from tensoralloy_tpu_torch.tensordb import calculator as pcalc
from tensoralloy_tpu_torch.tensordb import cli as pcli
from tensoralloy_tpu_torch.tensordb import microstructure as pms
from tensoralloy_tpu_torch.tensordb import sampler as psampler

PACKAGES = {"jax": (jdb, jsampler, jcalc, jms, jcli),
            "port": (pdb, psampler, pcalc, pms, pcli)}


def tree(root: Path) -> dict:
    """{relative path: (bytes, executable)} of every file under `root`."""
    return {str(p.relative_to(root)): (p.read_bytes(),
                                       os.access(p, os.X_OK))
            for p in sorted(root.rglob("*")) if p.is_file()}


def in_both(tmp_path, monkeypatch, fn) -> dict:
    """`fn(*modules)` of each package in its own working directory.
    -> {package: (result, tree of the directory)}."""
    out = {}
    for name, modules in PACKAGES.items():
        work = tmp_path / name
        work.mkdir()
        monkeypatch.chdir(work)
        out[name] = (fn(*modules), tree(work))
    return out


def same_structure(a, b):
    np.testing.assert_array_equal(a.numbers, b.numbers)
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.cell, b.cell)
    np.testing.assert_array_equal(a.pbc, b.pbc)
    assert sorted(a.info) == sorted(b.info)
    for k, v in b.info.items():
        np.testing.assert_array_equal(a.info[k], v, err_msg=k)


INCAR = """SYSTEM = synthetic Cu ; ENCUT = 500.000000   # cutoff
 ISMEAR = 1; SIGMA = 0.05
# a comment line
 nelmin = 4
{nelm}"""


# name -> (INCAR NELM line, SCF iterations of each ionic step, OUTCAR
# layout and LOOP+ times or None for no OUTCAR)
JOBS = {
    "converged": ("NELM = 40", (14, 9, 7), ((64, 1, 2), (120.5, 98.25))),
    "hit_nelm": ("NELM = 14", (14, 9), ((32, 4, 1), (61.0,))),
    "default_nelm": ("", (59,), ((16, 2, 1), (12.75, 3.5, 2.0))),
    "no_outcar": ("NELM = 60", (5,), None),
    "no_timing": ("NELM = 60", (5,), ((8, 1, 1), ())),
    "not_started": (None, (), None),
}


def write_job(jobdir: Path, case: str):
    nelm, nscf, outcar = JOBS[case]
    jobdir.mkdir(parents=True, exist_ok=True)
    if nelm is None:
        return
    (jobdir / "INCAR").write_text(INCAR.format(nelm=nelm))
    if outcar is None:
        chip_smoke.write_vasp_outputs(jobdir, nscf=nscf)
        (jobdir / "OUTCAR").unlink()
    else:
        chip_smoke.write_vasp_outputs(jobdir, nscf=nscf, ranks=outcar[0],
                                      loop_seconds=outcar[1])
    chip_smoke.write_vasprun_frames(jobdir / "vasprun.xml",
                                    [chip_smoke._cu_frame(len(nscf))])


@pytest.mark.parametrize("case", sorted(JOBS))
def test_vasp_job_parses_as_jax(case, tmp_path):
    """VaspJob on one job directory: INCAR, OSZICAR, OUTCAR, the service
    unit, the SCF convergence and the structures."""
    write_job(tmp_path, case)
    if JOBS[case][0] is not None:
        write_vasprun(tmp_path / "vasprun.xml")     # 2 Be + 1 W
    got, want = pdb.VaspJob(tmp_path), jdb.VaspJob(tmp_path)
    assert got.incar == want.incar
    for key in ("ENCUT", "nelmin", "sigma", "NELM", "missing"):
        assert got.get_incar_parameter(key) == want.get_incar_parameter(key)
    assert got.read_oszicar() == want.read_oszicar()
    assert got.get_vasp_mpi_omp_ranks() == want.get_vasp_mpi_omp_ranks()
    assert got.get_vasp_elapsed_time() == want.get_vasp_elapsed_time()
    su, jsu = (j.get_vasp_job_service_unit() for j in (got, want))
    assert (su is None) == (jsu is None)
    if jsu is not None:
        assert (su.ncores, su.elapsed_seconds, su.core_hours) == (
            jsu.ncores, jsu.elapsed_seconds, jsu.core_hours)
    assert got.check_vasp_job_scf_convergence() == \
        want.check_vasp_job_scf_convergence()
    if (tmp_path / "vasprun.xml").exists():
        for ft in (False, True):
            same_structure(got.get_atoms(-1, ft), want.get_atoms(-1, ft))
    if case == "converged":
        assert got.check_vasp_job_scf_convergence()
        assert su.ncores == 64 and su.core_hours > 0
    if case == "hit_nelm":
        assert not got.check_vasp_job_scf_convergence()


@pytest.mark.parametrize("args", [(1000.0, 63.5, 11.8), (300.0, 4.0, 8.2),
                                  (2500.0, 183.84, 15.9, 40.0)])
def test_md_timestep_as_jax(args):
    assert pdb.recommend_md_timestep(*args) == \
        jdb.recommend_md_timestep(*args)


@pytest.mark.parametrize("phase", ["fcc", "bcc", "hcp", "diamond", "sc"])
def test_phase_structures_as_jax(phase):
    same_structure(psampler.make_phase_structure("Cu", phase, 3.6),
                   jsampler.make_phase_structure("Cu", phase, 3.6))
    for method in ("linear", "log"):
        np.testing.assert_array_equal(
            psampler.temperature_ladder(300, 1500, 5, method),
            jsampler.temperature_ladder(300, 1500, 5, method))


def _connect(package, path):
    """The database of the package that `package` (its tensordb) is of."""
    top = package.__name__.split(".")[0]
    return __import__(f"{top}.io.sqlite", fromlist=["connect"]).connect(
        path)


def _cu(ms_module, sampler_module):
    return sampler_module.make_phase_structure("Cu", "fcc", 3.6).repeat(
        (2, 2, 2))


# generator -> call on (microstructure module, structure)
GENERATORS = {
    "transmute": lambda m, s: m.transmute(s, 0.25, "Ni", seed=1),
    "interstitials": lambda m, s: m.insert_interstitials(s, "He", 3,
                                                         seed=2),
    "rattle": lambda m, s: m.rattle(s, stdev=0.05, seed=3),
    "random_strain": lambda m, s: m.random_strain(s, 0.02, seed=5),
    "vacancy_cluster": lambda m, s: m.make_vacancy_cluster(s, 4, seed=4),
    "vacancy_cluster_centered": lambda m, s: m.make_vacancy_cluster(
        s, 3, center=[1.0, 2.0, 0.5], seed=0),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_microstructure_generators_bit_for_bit(name):
    got = GENERATORS[name](pms, _cu(pms, psampler))
    want = GENERATORS[name](jms, _cu(jms, jsampler))
    same_structure(got, want)


def test_structure_hash_and_edits_as_jax():
    rng = np.random.RandomState(7)
    s = _cu(pms, psampler)
    js = _cu(jms, jsampler)
    for _ in range(3):
        d = rng.normal(0, 0.1, s.positions.shape)
        s.positions = s.positions + d
        js.positions = js.positions + d
        assert pcalc.structure_hash(s) == jcalc.structure_hash(js)
    same_structure(pcalc.delete_atoms(s, [0, 5, 7]),
                   jcalc.delete_atoms(js, [0, 5, 7]))
    same_structure(pcalc.append_atoms(s, "He", [[1.0, 1.0, 1.0]]),
                   jcalc.append_atoms(js, "He", [[1.0, 1.0, 1.0]]))
    np.testing.assert_array_equal(pcalc.fibonacci_sphere(7, 2.0),
                                  jcalc.fibonacci_sphere(7, 2.0))
    assert pcalc.find_cluster(s, 3, 4) == jcalc.find_cluster(js, 3, 4)


def test_vasp_parameters_as_jax():
    """INCAR parameters: NBANDS rules (lambda string, per-size table),
    MAGMOM, finite-temperature smearing."""
    for nbands in ("lambda a, n, v, t: n * 4 + 8", {"32": 144}, 96):
        config = {"species": ["Cu"], "finite_temperature": True,
                  "vasp": {"calc": {"nbands": nbands, "magmom": 0.6,
                                    "lsorbit": True, "kpar": 4}}}
        s = _cu(pms, psampler)
        s.info["etemperature"] = 0.25
        js = _cu(jms, jsampler)
        js.info["etemperature"] = 0.25
        got = pcalc.VaspCalculator("unused", config).vasp_parameters(s)
        want = jcalc.VaspCalculator("unused", config).vasp_parameters(js)
        assert got == want


def test_sampler_lifecycle_as_jax(tmp_path, monkeypatch):
    """VaspAimdSampler: the tasks it lays out, their status through
    submitted and purge, and the extraction of a finished task."""
    config = {"species": ["Cu"], "phases": ["fcc", "bcc"],
              "fcc": {"a": 3.6, "supercell": [[2, 2, 2]]},
              "bcc": {"supercell": [[3, 3, 3]]},
              "slurm": {"partition": "gpu", "ntasks": 32},
              "aimd": {"sampling": {
                  "nvt": {"fcc": {"t0": 300, "t1": 600, "size": 2,
                                  "scales": [0.98, 1.0]}},
                  "npt": {"bcc": {"t0": 500, "t1": 1500, "size": 3,
                                  "vt_method": "log"}}}},
              "vasp": {"sampling": {"encut": 400}}}

    def lifecycle(db, sampler, *_):
        s = sampler.VaspAimdSampler("work", config)
        created = s.create_tasks()
        s.set_status(created[0], "submitted")
        s.set_status(created[1], "submitted")
        (created[1] / "vasprun.xml").write_text("")
        s.purge()
        chip_smoke.write_vasprun_frames(
            created[2] / "vasprun.xml",
            [chip_smoke._cu_frame(k) for k in range(4)])
        s.post_process()
        samples = s.get_samples(created[2], interval=2)
        return ([str(t) for t in created],
                [s.get_status(t) for t in s.task_iterator()],
                [str(t) for t in s.list_unsubmitted_tasks()], samples)

    out = in_both(tmp_path, monkeypatch, lifecycle)
    (created, status, unsubmitted, samples), files = out["port"]
    (jcreated, jstatus, junsubmitted, jsamples), jfiles = out["jax"]
    assert len(created) == 2 * 2 + 3
    assert (created, status, unsubmitted) == (jcreated, jstatus,
                                              junsubmitted)
    assert files == jfiles
    assert len(samples) == len(jsamples) == 2
    for a, b in zip(samples, jsamples):
        same_structure(a, b)


def test_recompute_calculator_as_jax(tmp_path, monkeypatch):
    def recompute(db, sampler, *_):
        s1 = sampler.make_phase_structure("Cu", "fcc", 3.6)
        s2 = sampler.make_phase_structure("Cu", "bcc", 2.9)
        s2.info["etemperature"] = 0.2
        calc = sampler.RecomputeCalculator(
            "recalc", {"vasp": {"calc": {"encut": 450, "kpar": 4,
                                         "npar": 2}},
                       "finite_temperature": True})
        tasks = calc.create_tasks([s1, s2])
        again = calc.create_tasks([s1, s2])
        write_job(tasks[0], "converged")
        write_job(tasks[1], "hit_nelm")
        out = _connect(db, "harvest.db")
        return [str(t) for t in tasks], again, calc.collect(out), len(out)

    out = in_both(tmp_path, monkeypatch, recompute)
    assert out["port"][0] == out["jax"][0]
    assert out["port"][0][2:] == (1, 1)
    # the databases are sqlite files: compare them through their rows
    files = {k: v for k, v in out["port"][1].items() if k != "harvest.db"}
    jfiles = {k: v for k, v in out["jax"][1].items() if k != "harvest.db"}
    assert files == jfiles


# calculator -> (class name, config block, whether the snapshots carry
# their forces: the JAX package cannot write a helium-bubble copy of a
# labelled snapshot, see test_edited_snapshots_lose_their_per_atom_labels)
CALCULATORS = {
    "calc": ("VaspCalculator", {}, True),
    "aging": ("VaspAgingCalculator", {"aging": {
        "interval": 4,
        "transmutation": {"Cu-Ni": {"prob": 0.6, "nmax": 3}},
        "helium_bubble": {"target": "Cu", "max_target_size": 2,
                          "max_bubble_size": 4, "max_ratio": 3.0}}},
        False),
    "neq": ("VaspNonEquilibriumCalculator",
            {"neq": {"nmax": 3, "dmin": 1.2, "interval": 2}}, True),
    "porous_fixed": ("VaspPorousCalculator",
                     {"porosity": {"porosity": 2.0, "interval": 2}},
                     False),
    "porous_range": ("VaspPorousCalculator",
                     {"porosity": {"porosity": [1.2, 3.0], "interval": 2}},
                     False),
}


class _Sampler:
    """Two finished AIMD tasks of 32-atom Cu frames; `labels=False` gives
    the snapshots without their forces."""

    def __init__(self, sampler_module, root: Path, labels: bool = True):
        self.sampler_module, self.labels = sampler_module, labels
        self.tasks = []
        for i in range(2):
            task = root / f"aimd{i}"
            task.mkdir(parents=True)
            chip_smoke.write_vasprun_frames(
                task / "vasprun.xml",
                [chip_smoke._cu_frame(10 * i + k) for k in range(5)],
                seed=i)
            self.tasks.append(task)

    def task_iterator(self):
        return self.tasks

    def get_samples(self, task, interval=1, **kw):
        frames = self.sampler_module.BaseSampler.get_samples(
            None, task, interval)
        if not self.labels:
            for s in frames:
                del s.info["forces"]
        return frames


def _lay_out(cls, config, labels):
    """create_tasks -> the jobs finish -> update_status -> get_atoms, with
    one package's modules."""
    def lay_out(db, sampler, calculator, *_):
        calc = getattr(calculator, cls)("root", config)
        structures = calc.create_tasks(
            {"aimd": _Sampler(sampler, Path("aimd"), labels)})
        again = calc.create_tasks(
            {"aimd": _Sampler(sampler, Path("aimd2"), labels)})
        tasks = list(calc.task_iterator())
        for k, task in enumerate(tasks):
            write_job(task, "hit_nelm" if k % 3 == 2 else "converged")
        status = calc.update_status()
        harvested = [calc.get_atoms(t, check) for t in tasks
                     for check in (False, True)]
        return structures, len(again), [str(t) for t in tasks], status, \
            harvested
    return lay_out


@pytest.mark.parametrize("name", sorted(CALCULATORS))
def test_calculator_task_tree_as_jax(name, tmp_path, monkeypatch):
    """The tree each calculator lays out, file by file, the structures it
    modifies (on its seeded generator), and what it harvests."""
    cls, block, labels = CALCULATORS[name]
    config = {"species": ["Cu"], "calc": {"interval": 2},
              "vasp": {"calc": {"encut": 520, "kpar": 2}}, **block}
    out = in_both(tmp_path, monkeypatch, _lay_out(cls, config, labels))
    (structures, again, tasks, status, harvested), files = out["port"]
    (jstructures, jagain, jtasks, jstatus, jharvested), jfiles = out["jax"]
    assert len(structures) == len(jstructures) > 0
    for a, b in zip(structures, jstructures):
        same_structure(a, b)
    assert (again, tasks, status) == (jagain, jtasks, jstatus)
    if name == "calc":
        assert again == len(structures)    # nothing new: hash dedup
    assert sorted(files) == sorted(jfiles)
    for f in jfiles:
        assert files[f] == jfiles[f], f
    assert [h is None for h in harvested] == [h is None for h in jharvested]
    for a, b in zip(harvested, jharvested):
        if b is not None:
            same_structure(a, b)
    if name == "aging":
        assert any("He" in s.symbols for s in structures)


@pytest.mark.parametrize("name", ["aging", "porous_fixed"])
def test_edited_snapshots_lose_their_per_atom_labels(name, tmp_path,
                                                     monkeypatch):
    """A copy with atoms removed or added drops the snapshot's forces in
    the port. The JAX package keeps them: a helium-bubble copy (more atoms
    than forces) fails to be written, a porous copy carries the forces of
    other atoms. Everything else of the tree is the JAX package's."""
    cls, block, _ = CALCULATORS[name]
    config = {"species": ["Cu"], "calc": {"interval": 2},
              "vasp": {"calc": {"encut": 520}}, **block}
    monkeypatch.chdir(tmp_path)
    structures = _lay_out(cls, config, True)(pdb, psampler, pcalc)[0]
    assert structures and all("forces" not in s.info for s in structures)
    assert all("energy" in s.info for s in structures)
    if name == "aging":
        assert any("He" in s.symbols for s in structures)
        monkeypatch.chdir(tmp_path / "root")
        with pytest.raises(IndexError):
            _lay_out(cls, config, True)(jdb, jsampler, jcalc)
    else:
        jax_dir = tmp_path / "jax"
        jax_dir.mkdir()
        monkeypatch.chdir(jax_dir)
        jstructures = _lay_out(cls, config, True)(jdb, jsampler, jcalc)[0]
        for a, b in zip(structures, jstructures):
            assert len(b.info["forces"]) == 32 != len(b)
            b.info.pop("forces")
            same_structure(a, b)


def test_porous_calculator_refuses_as_jax(tmp_path):
    for config in ({"species": ["Cu"], "porosity": {}},
                   {"species": ["Cu"], "porosity": {"porosity": 0.5}}):
        for module in (pcalc, jcalc):
            with pytest.raises(ValueError):
                module.VaspPorousCalculator(tmp_path, config)


def _pipeline(cli, root, monkeypatch, capsys, calculators):
    root.mkdir()
    monkeypatch.chdir(root)
    rcs = chip_smoke.tensordb_workflow(cli.main, root, calculators)
    return rcs, capsys.readouterr().out, tree(root)


def _gathered(files, subdirs) -> tuple:
    """(structures gathered, converged jobs: all but every third job of
    each calculator)."""
    n_converged = 0
    for sub in subdirs:
        jobs = [f for f in files if f.startswith(f"{sub}/")
                and f.endswith("/metadata.json") and "/task" in f]
        n_converged += len(jobs) - len(jobs) // 3
    return files["gathered.extxyz"][0].decode().count("Lattice="), \
        n_converged


def test_tensordb_pipeline_through_main_as_jax(tmp_path, monkeypatch,
                                               capsys):
    """sampling aimd -> status -> postprocess -> create calc and neq ->
    status of each -> gather, through each package's `main`: the exit
    codes, what each printed, and the tree."""
    rcs, printed, files = _pipeline(pcli, tmp_path / "port", monkeypatch,
                                    capsys, ("calc", "neq"))
    jrcs, jprinted, jfiles = _pipeline(jcli, tmp_path / "jax", monkeypatch,
                                       capsys, ("calc", "neq"))
    assert rcs == jrcs and not any(rcs)
    assert printed == jprinted
    assert sorted(files) == sorted(jfiles)
    for f in jfiles:
        assert files[f] == jfiles[f], f
    gathered, converged = _gathered(files, ("calc", "neq"))
    assert gathered == converged > 0
    assert "gathered" in printed
    # the config it reads, the calculator it refuses to guess
    monkeypatch.chdir(tmp_path / "port")
    with pytest.raises(FileNotFoundError):
        pcli.main(["-i", "missing.toml", "status", "calc"])
    db = pcli.TensorDB("config.toml")
    assert sorted(db.calculators) == ["aging", "calc", "neq", "porosity"]
    del db.calculators["aging"]
    with pytest.raises(ValueError, match="aging"):
        db.create_accurate_dft_tasks("aging")


def test_tensordb_pipeline_with_every_calculator(tmp_path, monkeypatch,
                                                 capsys):
    """The same pipeline with the porosity and aging calculators too, in
    the port (the JAX package fails at the aging step on labelled AIMD
    snapshots): every run exits 0, the converged jobs are gathered."""
    every = ("calc", "neq", "porosity", "aging")
    rcs, printed, files = _pipeline(pcli, tmp_path / "port", monkeypatch,
                                    capsys, every)
    assert not any(rcs)
    gathered, converged = _gathered(files, ("calc", "neq", "porous",
                                            "aging"))
    assert gathered == converged > 0
    for sub in ("porous", "aging"):
        assert f"{sub}/hash.json" in files
    assert "He" in files["aging/accurate_dft_calc.extxyz"][0].decode()


def test_plot_reaches_matplotlib_only_when_called():
    """The plot command imports matplotlib inside the call (the module
    imports, and the rest of the pipeline runs, where it is absent), and
    TensorDB has the JAX class's methods."""
    source = Path(pcli.__file__).read_text()
    assert "matplotlib" not in source[:source.index("def plot(")]

    def methods(cls):
        return sorted(n for n in vars(cls) if not n.startswith("__"))
    assert methods(pcli.TensorDB) == methods(jcli.TensorDB)


BLOCKED = ("torch", "jax", "optax", "tensoralloy_tpu", "matplotlib")
RUN_BLOCKED = f"""
import runpy, sys
class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BLOCKED!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Blocker())
sys.argv = ["tensordb"] + sys.argv[1:]
runpy.run_module("tensoralloy_tpu_torch.tensordb", run_name="__main__")
"""


def test_tensordb_runs_without_torch_jax_or_matplotlib(tmp_path):
    """The pipeline as programs that cannot import torch, jax, the JAX
    package or matplotlib: tensordb is host code, and the package's
    import pulls no torch in."""
    import subprocess
    import sys
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root))

    def run(argv):
        proc = subprocess.run([sys.executable, "-c", RUN_BLOCKED, *argv],
                              cwd=tmp_path / "db", env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        return proc.returncode

    rcs = chip_smoke.tensordb_workflow(run, tmp_path / "db", ("calc", "neq"))
    assert not any(rcs)
    files = tree(tmp_path / "db")
    gathered, converged = _gathered(files, ("calc", "neq"))
    assert gathered == converged > 0
