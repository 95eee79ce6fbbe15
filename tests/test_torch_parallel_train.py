"""Data-parallel training in the port against the JAX package's on its
virtual CPU devices, float64: `Trainer(n_devices=2)` on two gloo ranks
(`parallel.mesh.launch`) with `rmse` losses and an L2 term, on the dense
rows and on the flat layout, and with microbatches: the loss of every
step, the parameters and the EMA after the steps, against JAX's SPMD
step and the port's one process (1e-10). Then the manager's
`distribute.num_devices` inside a group of two ranks against its run on
one, with only rank 0 writing files.

Small sizes: the first structures (at most 32 atoms) of
artifacts/snap_ni/snap-Ni.db, rcut 4.5 / acut 3.5, hidden [8].
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tensoralloy_tpu.io.sqlite import connect as jax_connect
from tensoralloy_tpu.nn import losses as JL
from tensoralloy_tpu.nn.atomic import AtomicNN as JaxAtomicNN
from tensoralloy_tpu.nn.sf import SymmetryFunction as JaxSF
from tensoralloy_tpu.parallel.mesh import replicate, shard_batch
from tensoralloy_tpu.train.dataset import Dataset as JaxDataset
from tensoralloy_tpu.train.trainer import (OptParameters as JaxOpt,
                                           TrainParameters as JaxTP,
                                           Trainer as JaxTrainer)
from tensoralloy_tpu.transform import Featurizer as JaxFeaturizer
from tensoralloy_tpu_torch.nn import losses as L
from tensoralloy_tpu_torch.parallel import ranks
from tensoralloy_tpu_torch.parallel.mesh import launch
from tensoralloy_tpu_torch.train.trainer import (OptParameters,
                                                 TrainParameters)
from tensoralloy_tpu_torch.utils import tree_flatten
from test_torch_manager import cut_config
from test_torch_parallel_mesh import JOIN, REL, model_file, rel_err
from test_torch_training import NI_DB, SF_KW, _seeded_params, small_db

BATCH = 4
STEPS = 2
LOSS = dict(energy=dict(weight=2.0, per_atom_loss=True),
            forces=dict(weight=1.0), stress=dict(weight=0.1))
L2 = dict(weight=1e-3, decayed=True, decay_rate=0.9, decay_steps=10)
OPT = dict(learning_rate=2e-3)
MINIMIZE = ("energy", "forces", "stress")


@pytest.fixture(autouse=True)
def _numpy_neighbor_path(monkeypatch):
    monkeypatch.setenv("TENSORALLOY_TPU_NO_NATIVE", "1")


def _trees_close(got, want, what):
    got, want = tree_flatten(got), tree_flatten(want)
    assert set(got) == set(want), what
    scale = max(float(np.max(np.abs(np.asarray(v)))) for v in want.values())
    for k in want:
        err = float(np.max(np.abs(np.asarray(got[k], np.float64)
                                  - np.asarray(want[k], np.float64))))
        assert err <= REL * scale, (what, k, err)


def _case(tmp, backend, microbatch):
    """(JAX model, JAX params, the batches, TrainParameters kwargs) of an
    angular SF model on a small Ni database."""
    tmp.mkdir(parents=True)
    db = small_db(NI_DB, tmp / "ni.db", 12, 32)
    jdb = jax_connect(db.filename)
    fz = JaxFeaturizer(jdb.elements, rcut=4.5, acut=3.5, angular=True)
    flat = backend == "segment"
    ds = JaxDataset(jdb, fz, name=f"ni_{backend}", test_size=2,
                    dtype=np.float64, cache_dir=str(tmp / "cache"),
                    layout="segment" if flat else "dense",
                    transpose=not flat)
    feats, labels = ds.build()
    model = JaxAtomicNN(fz, ds.max_occurs,
                        JaxSF(jdb.elements, backend=backend, **SF_KW),
                        hidden_sizes=[8],
                        atomic_static_energy=jdb.get_atomic_static_energy())
    params = _seeded_params(model, feats)
    batches = [({k: np.asarray(v[i:i + BATCH]) for k, v in feats.items()},
                {k: np.asarray(v[i:i + BATCH]) for k, v in labels.items()})
               for i in range(0, BATCH * STEPS, BATCH)]
    tp = dict(batch_size=BATCH, train_steps=10, microbatch_size=microbatch)
    return model, params, batches, tp


def _jax_run(model, params, batches, tp):
    """JAX's data-parallel steps on two virtual devices."""
    lp = JL.LossParameters(l2=JL.L2LossOptions(**L2),
                           **{k: JL.LossOptions(**v) for k, v in LOSS.items()})
    trainer = JaxTrainer(model, lp, JaxOpt(**OPT), JaxTP(**tp),
                         minimize_properties=MINIMIZE, n_devices=2)
    step = trainer._build_train_step()
    state = replicate(trainer.init_state(params), trainer.mesh)
    losses = []
    for f, lab in batches:
        state, metrics = step(state,
                              shard_batch({k: jnp.asarray(v)
                                           for k, v in f.items()},
                                          trainer.mesh),
                              shard_batch({k: jnp.asarray(v)
                                           for k, v in lab.items()},
                                          trainer.mesh))
        losses.append(float(metrics["loss/total"]))
    return losses, state


def test_data_parallel_steps_match_jax_and_one_rank(tmp_path):
    """Two steps of batch 4 over two ranks: the loss of the GLOBAL batch
    (an rmse of the whole batch, not a mean of per-rank rmses), the L2
    term counted once, the parameters and the EMA; every rank holds the
    same state."""
    cases = {}
    for name, backend, mb in (("dense", "dense", 0),
                              ("segment", "segment", 0),
                              ("microbatch", "dense", 2)):
        model, params, batches, tp = _case(tmp_path / name, backend, mb)
        spec = {"model": model_file(model, params, tmp_path / f"{name}.npz"),
                "params": jax.tree_util.tree_map(np.asarray, params),
                "batches": batches, "device": "cpu", "dtype": "high",
                "loss_parameters": L.LossParameters(
                    l2=L.L2LossOptions(**L2),
                    **{k: L.LossOptions(**v) for k, v in LOSS.items()}),
                "opt_parameters": OptParameters(**OPT),
                "train_parameters": TrainParameters(**tp),
                "minimize_properties": MINIMIZE}
        cases[name] = (spec, _jax_run(model, params, batches, tp))
    got = launch(ranks.run_all, 2, [(ranks.train_steps, spec)
                                    for spec, _ in cases.values()],
                 device="cpu", timeout=JOIN)
    for i, (name, (spec, (jlosses, jstate))) in enumerate(cases.items()):
        one = ranks.train_steps(spec)
        per_rank = [g[i] for g in got]
        assert [r["ranks"] for r in per_rank] == [2, 2] and one["ranks"] == 1
        for r in per_rank:
            assert rel_err(r["losses"], jlosses) <= REL, name
            assert rel_err(r["losses"], one["losses"]) <= REL, name
            assert r["metrics"]["loss/l2"] > 0
            _trees_close(r["params"], jstate["params"], (name, "params"))
            _trees_close(r["ema"], jstate["ema_params"], (name, "ema"))
            _trees_close(r["params"], one["params"], (name, "one rank"))
            _trees_close(r["ema"], one["ema"], (name, "one rank ema"))
        assert ranks.all_equal([tree_flatten(r["params"]) for r in per_rank],
                               list(tree_flatten(one["params"])))


def test_manager_trains_data_parallel_in_a_group(tmp_path):
    """`distribute.num_devices = 2` (strategy 'mirrored') under two ranks
    trains as the same file on one rank ('off'), and only rank 0 writes
    the checkpoints, the history and the export."""
    steps = {"train.train_steps": 3, "train.eval_steps": 3,
             "train.scan_steps": 1,
             "train.log_steps": 100, "train.summary_steps": 100}
    dp = cut_config("snap_ni_sfa", tmp_path / "dp", {
        **steps, "distribute.strategy": "mirrored",
        "distribute.num_devices": 2})
    one = cut_config("snap_ni_sfa", tmp_path / "one", {
        **steps, "distribute.strategy": "off"})
    got = launch(ranks.manager_run, 2,
                 {"config": dp, "device": "cpu"}, device="cpu", timeout=JOIN)
    want = ranks.manager_run({"config": one, "device": "cpu"})
    assert [g["ranks"] for g in got] == [2, 2] and want["ranks"] == 1
    for g in got:
        assert len(g["losses"]) == 3
        assert rel_err(g["losses"], want["losses"]) <= REL
        _trees_close(g["ema"], want["ema"], "ema")
        assert rel_err([h["energy/mae"] for h in g["history"]],
                       [h["energy/mae"] for h in want["history"]]) <= REL
    model_dir = tmp_path / "dp" / "model"
    assert got[0]["path"] == got[1]["path"] == str(
        model_dir / f"{dp['dataset']['name']}.npz")
    for name in ("checkpoint.npz", "ckpt-3.npz", "history.json",
                 "input.json", f"{dp['dataset']['name']}.npz"):
        assert (model_dir / name).exists(), name
    from tensoralloy_tpu_torch.io.model import load_model
    exported, _ = load_model(got[0]["path"], device="cpu", dtype="high")
    _trees_close(exported.param_tree(), want["ema"], "exported")
    with pytest.raises(ValueError,
                       match="requested 2 devices but only 1 available"):
        ranks.manager_run({"config": dp, "device": "cpu"})
