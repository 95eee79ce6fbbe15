"""The port's experiment path (input.toml -> TrainingManager -> train ->
export -> evaluate_run) against the JAX package's manager, on the CPU at
float64, from the experiment files under artifacts/.

Every run works on a database cut to a few structures and copied, with
its cache and model directory, into a temporary directory: nothing is
written under artifacts/. The files' `precision` is set to "high" so
that both packages compute in float64 (the JAX manager sets its global
policy from it; the conftest's is "high" too).
"""
import dataclasses
import json
import shutil
import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import dump_toml, experiment_config
from tensoralloy_tpu import set_precision
from tensoralloy_tpu.io.sqlite import connect as jax_connect
from tensoralloy_tpu.train.manager import (
    PairStyle as JaxPairStyle, TrainingManager as JaxTrainingManager)
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
from tensoralloy_tpu_torch.io.sqlite import connect
from tensoralloy_tpu_torch.train.evaluation import evaluate_run
from tensoralloy_tpu_torch.train.manager import PairStyle, TrainingManager
from tensoralloy_tpu_torch.utils import tree_flatten, tree_map

ROOT = Path(__file__).resolve().parent.parent
ARTIFACTS = ROOT / "artifacts"
# run -> (structures kept, most atoms of a kept structure)
RUNS = {"snap_ni_sfa": (14, 32), "snap_ni_v5_readapt": (14, 32),
        "snap_moni": (14, 32), "td_be": (10, 36)}
# the six EAM/ADP experiment files (pair_style eam/*, with the 'rose' and
# 'elastic' constraints)
EAM_RUNS = {"mleam_ni": (14, 32), "mladp_mo": (14, 54),
            "mladp_mo_v2": (14, 54), "mladp_mo_v3": (14, 54),
            "mladp_mo_v4": (14, 54), "mladp_mo_v5": (14, 54)}
CUT = {"precision": "high", "dataset.test_size": 3, "train.batch_size": 4}


@pytest.fixture(autouse=True)
def _jax_precision_stays_high():
    yield
    set_precision("high")


def cut_database(source: str, target: Path, n: int, max_atoms: int) -> str:
    """The first `n` structures of at most `max_atoms` atoms."""
    db = connect(str(target))
    picked = 0
    for s in jax_connect(source):
        if len(s) > max_atoms or picked == n:
            continue
        db.write(Structure(s.numbers, s.positions, s.cell, s.pbc,
                           info=dict(s.info)), commit=False)
        picked += 1
    db._con.commit()
    assert picked == n
    return str(target)


def cut_config(run: str, tmp: Path, overrides=None) -> dict:
    """The run's input.toml on a cut copy of its database under `tmp`."""
    from tensoralloy_tpu_torch.io.input import InputReader
    full = InputReader(str(ARTIFACTS / run / "input.toml"))[
        "dataset.sqlite3"]
    small = tmp / "cut" / Path(full).name
    small.parent.mkdir(parents=True, exist_ok=True)
    if not small.exists():
        cut_database(full, small, *{**RUNS, **EAM_RUNS}[run])
    return experiment_config(run, tmp, {**CUT, **(overrides or {})},
                             database=small)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_manager_builds_what_the_jax_manager_builds(run, tmp_path):
    config = cut_config(run, tmp_path)
    jconfig = dict(config, dataset=dict(
        config["dataset"], tfrecords_dir=str(tmp_path / "jax_cache")))
    want = JaxTrainingManager(jconfig)
    got = TrainingManager(config, device="cpu")
    assert dataclasses.asdict(got.pair_style) == dataclasses.asdict(
        want.pair_style)
    assert got.elements == want.elements
    assert got.model.as_dict() == want.model.as_dict()
    for name in ("loss_parameters", "opt_parameters", "train_parameters"):
        a = dataclasses.asdict(getattr(got, name))
        b = dataclasses.asdict(getattr(want, name))
        assert a == b, name
    assert got.trainer.minimize == want.trainer.minimize
    assert got.constraints == want.constraints == []
    assert got.model_dir == want.model_dir == str(tmp_path / "model")
    assert got.dataset.signature == want.dataset.signature
    assert got.dataset.transpose is want.dataset.transpose is False
    n = len(got.db)
    for a, b in zip(got.dataset.split_indices(n),
                    want.dataset.split_indices(n)):
        np.testing.assert_array_equal(a, b)
    assert got.trainer.device.type == "cpu"
    assert got.trainer.dtype == torch.float64
    assert {p.dtype for p in got.model.parameters()} == {torch.float64}
    # the backend comes from the merged file, not from a class default
    assert got.model.descriptor.backend == "dense"


def test_pair_style_parses_as_in_jax():
    for value in ("atomic/sf", "atomic/sf/angular", "atomic/grap",
                  "td/grap", "eam/adp", "eam/alloy", "eam/fs"):
        got, want = PairStyle.parse(value), JaxPairStyle.parse(value)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.finite_temperature == want.finite_temperature


def test_precision_becomes_the_explicit_dtype(tmp_path):
    config = cut_config("snap_ni_v5_readapt", tmp_path,
                        {"precision": "medium",
                         "nn.atomic.grap.backend": "pallas",
                         "train.force_assembly": "dense"})
    manager = TrainingManager(config, device="cpu")
    assert manager.trainer.dtype == torch.float32
    assert manager.dataset.dtype == np.float32
    assert manager.dataset.transpose is True
    assert manager.dataset.signature.endswith("-tr-fp32-14")
    assert manager.model.descriptor.backend == "pallas"
    assert torch.backends.cuda.matmul.allow_tf32 is False


def _jax_start(manager, feats):
    """The JAX manager's own initial parameters with the min/max sweep
    over the training features."""
    params = manager.model.init_params(
        jax.random.PRNGKey(manager.reader["seed"]))
    if manager.model.minmax_scale:
        params = manager.model.update_norm_stats(
            params, {k: jnp.asarray(v) for k, v in feats.items()})
    return params


@pytest.mark.parametrize("run", sorted(RUNS) + ["mladp_mo_v5", "mleam_ni"])
def test_three_steps_from_carried_over_parameters_match_jax(run, tmp_path):
    """Three optimizer steps at float64, each package on its own dataset
    build, from the JAX manager's initial parameters: the loss of every
    step and each of its terms (the constraint losses of the EAM files
    included) to 1e-8, the parameters after the last to 1e-8."""
    config = cut_config(run, tmp_path, {
        "train.train_steps": 3, "train.scan_steps": 1,
        "train.eval_steps": 100, "train.log_steps": 100})
    jconfig = dict(config, dataset=dict(
        config["dataset"], tfrecords_dir=str(tmp_path / "jax_cache")))
    want_mgr = JaxTrainingManager(jconfig)
    feats, labels = want_mgr.dataset.build()
    tf_, tl_, _, _ = want_mgr.dataset.split(feats, labels)
    params = _jax_start(want_mgr, tf_)
    want_losses = []
    want = want_mgr.trainer.fit(
        tf_, tl_, params=params, verbose=False,
        callback=lambda s, st, m: want_losses.append(
            {k: float(v) for k, v in m.items() if k.startswith("loss/")}))

    manager = TrainingManager(config, device="cpu")
    feats, labels = manager.dataset.build()
    tf_, tl_, _, _ = manager.dataset.split(feats, labels)
    losses = []
    got = manager.trainer.fit(
        tf_, tl_, verbose=False,
        params=tree_map(lambda x: torch.as_tensor(np.array(x)), params),
        callback=lambda s, st, m: losses.append(
            {k: float(v) for k, v in m.items() if k.startswith("loss/")}))
    assert len(losses) == 3
    if run in EAM_RUNS:
        assert {"loss/rose", "loss/elastic"} <= set(want_losses[0])
    for a, b in zip(losses, want_losses):
        assert set(a) == set(b)
        for k in b:
            assert np.isfinite(a[k])
            np.testing.assert_allclose(a[k], b[k], rtol=1e-8, err_msg=k)
    a = tree_flatten(got["state"]["params"])
    b = tree_flatten(jax.device_get(want["state"]["params"]))
    assert set(a) == set(b)
    top = max(float(np.max(np.abs(v))) for v in b.values())
    for key in b:
        assert float(np.max(np.abs(a[key].numpy() - np.asarray(b[key])))) \
            <= 1e-8 * top, key


RUN_FILES = ("input.json", "run.pid", "ckpt-4.npz", "ckpt-best.npz",
             "best.json", "metrics.jsonl", "checkpoint.npz",
             "history.json")


@pytest.mark.parametrize("run", ["snap_ni_sfa", "td_be", "mleam_ni"])
def test_experiment_from_a_file_to_a_served_model(run, tmp_path):
    """input.toml -> TrainingManager -> train_and_evaluate -> export ->
    evaluate_run -> calculator, then the auto-resume of a run cut
    short. An EAM file trains with its constraints and exports its setfl
    file too, which reads as the JAX export of the same parameters."""
    config = cut_config(run, tmp_path, {
        "train.train_steps": 6, "train.scan_steps": 2,
        "train.eval_steps": 4, "train.log_steps": 4,
        "train.summary_steps": 2})
    dump_toml(config, tmp_path / "input.toml")
    with open(tmp_path / "input.toml", "rb") as fh:
        assert tomllib.load(fh) == config
    manager = TrainingManager(str(tmp_path / "input.toml"), device="cpu")
    with pytest.raises(RuntimeError, match="nothing trained"):
        manager.export()
    result = manager.train_and_evaluate(verbose=False)
    model_dir = Path(manager.model_dir)
    assert model_dir == tmp_path / "model"
    for name in RUN_FILES:
        assert (model_dir / name).exists(), name
    assert not (model_dir / "ckpt-6.npz").exists()
    assert int(result["state"]["step"]) == 6
    history = json.loads((model_dir / "history.json").read_text())
    assert [h["step"] for h in history] == [4]
    rows = [json.loads(line) for line in
            (model_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [3, 5]
    assert all(np.isfinite(r["loss/total"]) for r in rows)
    saved = json.loads((model_dir / "input.json").read_text())
    assert saved["train"]["train_steps"] == 6
    with np.load(model_dir / "checkpoint.npz") as z:
        assert int(z["step"]) == 6

    exported = manager.export()
    assert exported == str(model_dir / f"{config['dataset']['name']}.npz")
    if run in EAM_RUNS:
        assert {c.name for c in manager.constraints} == {"rose", "elastic"}
        assert {"loss/rose", "loss/elastic"} <= set(rows[0])
        _assert_setfl_is_the_jax_export(manager, result["state"], tmp_path)
    calc = TensorAlloyCalculator(exported, device="cpu", dtype="high")
    structure = manager.db.get(1)
    if manager.pair_style.finite_temperature:
        assert "etemperature" in structure.info
    res = calc.calculate(structure)
    feats, _ = manager.dataset.build()
    pred = manager.trainer.batched_predictions(
        result["state"]["ema_params"],
        manager.trainer._to_device({k: v[:1] for k, v in feats.items()}))
    assert abs(res["energy"] - float(pred["energy"][0])) <= 1e-9 * abs(
        res["energy"])
    assert np.isfinite(res["forces"]).all()

    # evaluate_run reads the directory again and agrees with the
    # trainer's evaluation of the checkpoint it picked (step 4)
    report = evaluate_run(str(tmp_path), verbose=False, device="cpu")
    assert report["step"] == 4
    assert report["checkpoint"] == str(model_dir / "ckpt-4.npz")
    assert (tmp_path / "group_maes.json").exists()
    test = report["splits"]["test"]
    assert test["overall"]["n"] == 3
    assert report["splits"]["train"]["overall"]["n"] == len(manager.db) - 3
    assert sum(v["n"] for k, v in test.items() if k != "overall") == 3
    assert abs(test["overall"]["energy_meV_per_atom"]
               - 1000 * history[0]["energy/mae/atom"]) <= 1e-9 * abs(
        1000 * history[0]["energy/mae/atom"])
    assert abs(test["overall"]["force_eV_A"] - history[0]["forces/mae"]) \
        <= 1e-9 * history[0]["forces/mae"]
    by_ckpt = evaluate_run(str(tmp_path), verbose=False, device="cpu",
                           ckpt=str(model_dir / "ckpt-best.npz"),
                           per_group=False, use_ema=False, output=None)
    assert by_ckpt["step"] == 4 and list(by_ckpt["splits"]["test"]) == [
        "overall"]

    # a run cut short: 10 steps asked for, ckpt-4 is the newest
    longer = dict(config, train=dict(config["train"], train_steps=10))
    again = TrainingManager(longer, device="cpu")
    started = []
    step_fn = again.trainer.train_step
    again.trainer.train_step = lambda state, *a: (
        started.append(int(state["step"])), step_fn(state, *a))[1]
    out = again.train_and_evaluate(verbose=False)
    assert started == [4, 5, 6, 7, 8, 9]
    assert int(out["state"]["step"]) == 10
    assert (model_dir / "ckpt-8.npz").exists()
    # ... and equals the uninterrupted run bit for bit
    fresh = experiment_config(run, tmp_path, {
        **CUT, "train.train_steps": 10, "train.scan_steps": 2,
        "train.eval_steps": 4, "train.log_steps": 4,
        "train.model_dir": str(tmp_path / "straight")},
        database=config["dataset"]["sqlite3"])
    straight = TrainingManager(fresh, device="cpu").train_and_evaluate(
        verbose=False)
    a = tree_flatten(out["state"]["params"])
    b = tree_flatten(straight["state"]["params"])
    assert all(torch.equal(a[k], b[k]) for k in b)
    # a run whose newest checkpoint has reached train_steps starts fresh
    done = dict(config, train=dict(config["train"], train_steps=8))
    assert TrainingManager(done, device="cpu")._initial_state() is None


def _assert_setfl_is_the_jax_export(manager, state, tmp_path):
    """The setfl file beside the exported .npz, read by the port's
    reader, equals the JAX model's export of the same EMA parameters
    <= 1e-10."""
    from tensoralloy_tpu.nn.eam import model_from_dict as jax_eam_model
    from tensoralloy_tpu.transform import Featurizer as JaxFeaturizer
    from tensoralloy_tpu_torch.io.lammps import read_eam_alloy_setfl
    name = manager.reader["dataset.name"]
    style = manager.pair_style.model
    got_path = Path(manager.model_dir) / (
        f"{name}.adp" if style == "adp" else f"{name}.{style}.eam")
    d = manager.model.as_dict()
    jax_model = jax_eam_model(d, JaxFeaturizer.from_dict(d["featurizer"]),
                              manager.model.max_occurs)
    params = tree_map(lambda v: np.asarray(v.detach()),
                      state["ema_params"])
    want_path = tmp_path / "jax_export.eam"
    r = manager.reader
    nrho = r.get("nn.eam.setfl.nrho", 2000)
    jax_model.export_to_setfl(
        str(want_path), params, nr=r.get("nn.eam.setfl.nr", 2000),
        nrho=nrho, rho_max=nrho * r.get("nn.eam.setfl.drho", 0.05))
    got = read_eam_alloy_setfl(str(got_path), is_adp=style == "adp")
    want = read_eam_alloy_setfl(str(want_path), is_adp=style == "adp")
    assert (got.nr, got.nrho, got.elements) == (want.nr, want.nrho,
                                                want.elements)
    for table in ("frho", "rho", "phi"):
        for key, value in getattr(want, table).items():
            a = getattr(got, table)[key]
            assert np.max(np.abs(a - value)) <= 1e-10 * np.max(
                np.abs(value)), (table, key)


def test_warm_start_from_the_file_named_in_the_toml(tmp_path):
    """`train.ckpt.checkpoint_filename`: an existing file is restored
    with the file's switches (EMA weights, fresh optimizer, step kept or
    reset); a file that does not exist starts fresh."""
    base = {"train.train_steps": 2, "train.scan_steps": 1,
            "train.eval_steps": 2}
    config = cut_config("snap_ni_v5_readapt", tmp_path, base)
    assert not Path(config["train"]["ckpt"]["checkpoint_filename"]).exists()
    first = TrainingManager(config, device="cpu")
    assert first._initial_state() is None
    out = first.train_and_evaluate(verbose=False)
    ckpt = str(Path(first.model_dir) / "ckpt-2.npz")
    warm = cut_config("snap_ni_v5_readapt", tmp_path, {
        **base, "train.model_dir": str(tmp_path / "warm"),
        "train.ckpt.checkpoint_filename": ckpt})
    state = TrainingManager(warm, device="cpu")._initial_state()
    ema = tree_flatten(out["state"]["ema_params"])
    got = tree_flatten(state["params"])
    assert all(torch.equal(got[k], ema[k]) for k in ema)
    # the file says: use_ema_variables, no optimizer state, step kept
    assert state["step"] == 2 and state["opt_state"]["count"] == 0
    warm["train"]["reset_global_step"] = True
    assert TrainingManager(warm, device="cpu")._initial_state()["step"] == 0


# what once raised NotImplementedError (several devices, until the port
# of `parallel/`) and now raises what the JAX package raises with too few
# devices: the manager's files (run, overrides, match) and the other entry
# points (a callable and match). Inside a group of that many ranks they
# run: tests/test_torch_parallel_{train,analysis}.py.
NOT_PORTED = {
    "devices": ("snap_ni_sfa", {"distribute.strategy": "mirrored",
                                "distribute.num_devices": 4},
                "requested 4 devices but only 1 available"),
    "ensemble_shards": (lambda: __import__(
        "tensoralloy_tpu_torch.ensemble", fromlist=["x"]
    ).EnsembleCalculator(["a.npz", "b.npz"], n_shards=2),
        "n_shards=2 > available devices"),
}


@pytest.mark.parametrize("case", sorted(NOT_PORTED))
def test_what_is_not_ported_raises_by_name(case, tmp_path):
    if callable(NOT_PORTED[case][0]):
        fn, match = NOT_PORTED[case]
        with pytest.raises(ValueError, match=match):
            fn()
        return
    run, overrides, match = NOT_PORTED[case]
    if run in RUNS:
        config = cut_config(run, tmp_path, overrides)
    else:   # refused before the database is opened
        config = experiment_config(run, tmp_path, overrides)
    with pytest.raises(ValueError, match=match):
        TrainingManager(config, device="cpu")
    # the JAX manager on the conftest's 8 virtual devices: 9 are too many
    jconfig = dict(config, distribute=dict(config["distribute"],
                                           num_devices=9))
    with pytest.raises(ValueError, match="requested 9 devices but only 8"):
        JaxTrainingManager(jconfig)


def test_rose_and_elastic_files_in_the_repo_are_refused(tmp_path):
    """The six files that list 'rose' and 'elastic' are the EAM/ADP
    ones. Until the constraints were ported every one was refused; now
    none is, and none trains without its constraints (each builds both,
    `test_eam_files_build_their_constraints_as_in_jax`)."""
    asked = []
    for path in sorted(ARTIFACTS.glob("*/input.toml")):
        with open(path, "rb") as fh:
            cfg = tomllib.load(fh)
        if {"rose", "elastic"} & set(cfg.get("nn", {}).get("minimize", [])):
            asked.append(path.parent.name)
            assert cfg["pair_style"].startswith("eam/")
    assert sorted(asked) == sorted(EAM_RUNS)


@pytest.mark.parametrize("run", sorted(EAM_RUNS))
def test_eam_files_build_their_constraints_as_in_jax(run, tmp_path):
    """Each eam/* input.toml (on a cut copy of its database) builds the
    model, the flat-layout dataset and the 'rose' and 'elastic'
    constraints that the JAX manager builds."""
    config = cut_config(run, tmp_path)
    want = JaxTrainingManager(dict(config, dataset=dict(
        config["dataset"], tfrecords_dir=str(tmp_path / "jax_cache"))))
    got = TrainingManager(config, device="cpu")
    assert got.model.as_dict() == want.model.as_dict()
    assert type(got.model).__name__ == type(want.model).__name__
    assert got.dataset.layout == want.dataset.layout == "segment"
    assert got.dataset.signature == want.dataset.signature
    assert [c.name for c in got.constraints] == \
        [c.name for c in want.constraints] == ["elastic", "rose"]
    assert got.trainer.constraints == got.constraints
    elastic, rose = got.constraints
    j_elastic, j_rose = want.constraints
    assert elastic.weight == j_elastic.weight
    assert dataclasses.asdict(elastic.options) == dataclasses.asdict(
        j_elastic.options)
    assert dataclasses.asdict(rose.options) == dataclasses.asdict(
        j_rose.options)
    for (_, _, eq, batch, scales, *rest), (_, _, j_eq, j_batch, j_x,
                                           *j_rest) in zip(rose.entries,
                                                           j_rose.entries):
        np.testing.assert_allclose(scales["x"].numpy(), np.asarray(j_x),
                                   rtol=0, atol=0)
        assert rest == j_rest
        for key, value in batch.items():
            np.testing.assert_array_equal(value.numpy(), np.asarray(
                j_batch[key]), err_msg=key)


def test_manager_defaults_to_the_card(monkeypatch, tmp_path):
    config = cut_config("snap_ni_sfa", tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TrainingManager(config)
    dump_toml(config, tmp_path / "input.toml")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        evaluate_run(str(tmp_path), verbose=False)


# checkpoint -> its number of keys
CHECKPOINTS = {
    "dlite": ("snap_mo_refsf_dlite/model/ckpt-15000.npz", 43),
    "l2ft": ("snap_mo_refsf_l2ft/model/ckpt-15000.npz", 43),
    "rrmse": ("snap_mo_refsf_rrmse/model/ckpt-5000.npz", 43),
    "mleam": ("mleam_ni/model/ckpt-30000.npz", 83),
}


@pytest.mark.parametrize("name", sorted(CHECKPOINTS))
def test_jax_checkpoints_in_the_repo_restore_as_in_jax(name, tmp_path):
    """`restore_state` on a checkpoint that a JAX run wrote, with the
    model that the run's input.toml builds: every key is consumed, and
    parameters, EMA, adam moments, count and step equal what the JAX
    `Trainer.restore_state` returns, exactly (the EAM file's fixed r_eq
    and its zero moments included)."""
    path, n_keys = CHECKPOINTS[name]
    path = ARTIFACTS / path
    run = path.parent.parent.name
    config = experiment_config(run, tmp_path, {"precision": "high"})
    manager = TrainingManager(config, device="cpu")
    jax_manager = JaxTrainingManager(dict(config, dataset=dict(
        config["dataset"], tfrecords_dir=str(tmp_path / "jax_cache"))))
    template = jax_manager.model.init_params(jax.random.PRNGKey(0))
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    assert len(flat) == n_keys
    for kw in (dict(), dict(use_ema_variables=True,
                            restore_optimizer_variables=False,
                            reset_global_step=True)):
        got = manager.trainer.restore_state(str(path), **kw)
        want = jax.device_get(jax_manager.trainer.restore_state(
            str(path), template, **kw))
        assert got["step"] == int(want["step"])
        for key, jkey in (("params", "params"), ("ema_params",
                                                 "ema_params")):
            a, b = tree_flatten(got[key]), tree_flatten(want[jkey])
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_array_equal(a[k].numpy(),
                                              np.asarray(b[k], np.float64))
        adam = want["opt_state"][0]
        assert got["opt_state"]["count"] == int(adam.count)
        for slot in ("mu", "nu"):
            a = tree_flatten(got["opt_state"][slot])
            b = tree_flatten(getattr(adam, slot))
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_array_equal(a[k].numpy(),
                                              np.asarray(b[k], np.float64))
    # every key of the file is consumed: writing the restored state
    # gives the file's keys and values back
    state = manager.trainer.restore_state(str(path))
    assert state["step"] == int(flat["step"]) > 0
    back = str(tmp_path / "back.npz")
    manager.trainer.save_checkpoint(back, state)
    with np.load(back) as z:
        assert sorted(z.files) == sorted(flat)
        for k in flat:
            np.testing.assert_array_equal(
                z[k], np.asarray(flat[k], z[k].dtype), err_msg=k)
    params, ema, step = manager.trainer.load_checkpoint(str(path))
    assert step == int(flat["step"])
    assert not shutil.os.path.exists(str(ARTIFACTS / run / "cache"))
