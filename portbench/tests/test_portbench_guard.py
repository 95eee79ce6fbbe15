"""The harness loads neither JAX nor the JAX package, the reference
loads nothing of the program, and a cell is found by name."""
from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
import types

from portbench import common
from portbench.tests.conftest import ROOT

RUN_IMPORTS = """
import sys
sys.path.insert(0, {root!r})
from portbench import common
common.block_forbidden()
import importlib
sys.argv = ["run.py"]
spec = importlib.util.spec_from_file_location("run", {run!r})
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
bench = common.load_json(run.ROOT / "BENCHMARK.json")
for cell in bench["workloads"]:
    found = run.resolve(run.ROOT, cell["name"])
    importlib.import_module("portbench.drivers." + found["traffic"]["driver"])
for entry in bench["end_to_end"] + bench["per_layer"]:
    run.reader(run.ROOT, entry["name"])
for name in ("dynamics", "io.model", "train.manager", "transform.device_nl",
             "io.input"):
    importlib.import_module("tensoralloy_tpu_torch." + name)
importlib.import_module("torch.profiler")
print(common.forbidden_modules())
"""


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name, bad in (("jax", True), ("jax.numpy", True), ("jaxlib", True),
                      ("flax.linen", True), ("tensoralloy_tpu", True),
                      ("tensoralloy_tpu.ops", True),
                      ("tensoralloy_tpu_torch", False),
                      ("tensoralloy_tpu_torch.ops", False),
                      ("jaxtyping", False)):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        assert (name in common.forbidden_modules()) == bad, name
        monkeypatch.delitem(sys.modules, name)


def test_the_run_loads_no_jax():
    """Everything a run imports, with imports of JAX and the JAX package
    refused: nothing fails, and no such module is loaded."""
    code = RUN_IMPORTS.format(root=str(ROOT),
                              run=str(ROOT / "portbench" / "run.py"))
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip().splitlines()[-1] == "[]"


def test_the_block_refuses_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import common\ncommon.block_forbidden()\n"
            "for name in ('jax', 'tensoralloy_tpu'):\n"
            "    try:\n        __import__(name)\n"
            "    except ImportError:\n        print('refused', name)\n"
            % str(ROOT))
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert done.stdout.split() == ["refused", "jax", "refused",
                                   "tensoralloy_tpu"], done.stderr


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    sources = sorted((ROOT / "portbench" / "reference").glob("*.py"))
    assert len(sources) >= 7
    for path in sources:
        for name in _imports(path):
            assert name.split(".")[0] in ("torch", "numpy", "math",
                                          "itertools", "json", "sqlite3",
                                          "contextlib", "importlib",
                                          "__future__"), \
                f"{path.name} imports {name}"
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.asedb, portbench.reference.md\n"
            "import portbench.reference.train, portbench.reference.sf\n"
            "import portbench.reference.grap\n"
            "print(sorted({m.split('.')[0] for m in sys.modules\n"
            "       if m.startswith(('tensoralloy', 'jax'))}))" % str(ROOT))
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert done.stdout.strip() == "[]", done.stderr


def test_a_cell_added_as_files_is_found_by_name(tmp_path):
    """A copy of the benchmark with a new traffic file, a new metric's
    reader and their entries in BENCHMARK.json, and no other file
    edited: the new cell resolves, its metric is read, and it runs (on
    the CPU, at 108 atoms)."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("_work", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads(
        (ROOT / "portbench" / "traffic" / "nvt_fcc30_300k.json").read_text())
    traffic.update(reps=3, warm_chunks=1)
    (root / "portbench" / "traffic" / "nvt_fcc3_test.json").write_text(
        json.dumps(traffic))
    (root / "portbench" / "metrics" / "md_steps_test.py").write_text(
        "def read(run):\n    return float(run.values['steps'])\n")
    bench["workloads"].append({"name": "md_grap_ni108", "chips": 1,
                               "config": "grap_ni_pexp16_m5",
                               "traffic": "nvt_fcc3_test", "why": "test"})
    for entry in bench["end_to_end"]:
        if "workloads" in entry and "md_grap_ni108k" in entry["workloads"]:
            entry["workloads"].append("md_grap_ni108")
    bench["end_to_end"].append({"name": "md_steps_test", "unit": "steps",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["md_grap_ni108"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "portbench_run_copy", root / "portbench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    found = run.resolve(root, "md_grap_ni108")
    assert found["traffic"]["reps"] == 3
    names = [m["name"] for m in run.metrics_of(found["bench"],
                                                "md_grap_ni108", False)]
    assert names == ["md_throughput", "setup_s", "md_steps_test"]
    result, _ = run.measure(root, "md_grap_ni108", 2 ** 31 + 5, 0.5, False,
                            device="cpu")
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == set(names)
    assert result["metrics"]["md_steps_test"]["value"] >= 40
    assert list(result)[-1] == "checks"


def test_a_config_of_another_family_added_as_files_runs(tmp_path, small_db,
                                                        monkeypatch):
    """A GRAP training cell, where the benchmark trains only symmetry
    functions, added to a copy as a configuration file, a traffic file
    and their entries in BENCHMARK.json, and no other file edited: the
    train driver, the reference and the work counts follow the
    configuration's family, and the run is correct (on the CPU, on a
    small database)."""
    from portbench.drivers import train
    monkeypatch.setattr(train, "WORK", tmp_path / "work")
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("_work", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    sf = json.loads((ROOT / "portbench" / "configs"
                     / "sf_ni_g2g4_acut4.json").read_text())
    grap = json.loads((ROOT / "portbench" / "configs"
                       / "grap_ni_pexp16_m5.json").read_text())
    config = dict(grap, name="grap_ni_train_test", batch_size=10,
                  input_toml="artifacts/snap_ni_v5_readapt/input.toml",
                  overrides={"nn.atomic.grap.backend": "pallas",
                             "train.force_assembly": "dense",
                             "train.batch_size": 10, "train.scan_steps": 2,
                             "train.final_f32_steps": 0},
                  loss=sf["loss"], ema_decay=sf["ema_decay"],
                  optimizer=dict(sf["optimizer"], learning_rate=0.0005,
                                 decay_rate=0.95, decay_steps=2500))
    (root / "portbench" / "configs" / "grap_ni_train_test.json").write_text(
        json.dumps(config))
    traffic = json.loads((ROOT / "portbench" / "traffic"
                          / "snapni_batches.json").read_text())
    traffic.update(database=str(small_db), test_size=10, warm_steps=4)
    (root / "portbench" / "traffic" / "snapni_test.json").write_text(
        json.dumps(traffic))
    bench["configs"].append({
        "name": "grap_ni_train_test", "source": grap["source"],
        "file": "portbench/configs/grap_ni_train_test.json", "reduced": [],
        "why": "test"})
    bench["workloads"].append({"name": "train_grap_test", "chips": 1,
                               "config": "grap_ni_train_test",
                               "traffic": "snapni_test", "why": "test"})
    for entry in bench["end_to_end"]:
        if "train_sf_snapni" in entry.get("workloads", []):
            entry["workloads"].append("train_grap_test")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "portbench_run_copy2", root / "portbench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    result, record = run.measure(root, "train_grap_test", 2 ** 31 + 41, 0.5,
                                 False, device="cpu")
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"train_throughput", "setup_s"}
    assert len(record.checks) == 7
