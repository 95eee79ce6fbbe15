"""The port's training slice against the JAX package: the same batches and
the same numpy-seeded parameters go through both `Trainer`s on the CPU at
float64 (the JAX side with Pallas in interpret mode where the backend is
'pallas'), on the dense rows and on the flat ('segment') layout, with
legacy GRAP and the learned 'nn' filter.

Small sizes: 12 structures of at most 32 atoms from
artifacts/snap_ni/snap-Ni.db and 8 frames of artifacts/td_be/td-Be.db,
rcut 4.5 / acut 3.5, hidden [16, 16].

`python -m tests.test_torch_training` (from the repository root) writes
the full-width fixtures tests/data/torch_port_ref_train_{sf,grap}.json
that `chip_smoke.py` holds the GPU trainer against; the JAX runs that
fill them take a few minutes on the CPU.
"""
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoralloy_tpu.calculator import (
    TensorAlloyCalculator as JaxCalculator)
from tensoralloy_tpu.io.model import load_model as jax_load_model
from tensoralloy_tpu.io.sqlite import connect as jax_connect
from tensoralloy_tpu.nn import losses as JL
from tensoralloy_tpu.nn.atomic import AtomicNN as JaxAtomicNN
from tensoralloy_tpu.nn.finite_temperature import (
    TemperatureDependentAtomicNN as JaxTDNN)
from tensoralloy_tpu.nn.grap import (
    GenericRadialAtomicPotential as JaxGRAP)
from tensoralloy_tpu.nn.sf import SymmetryFunction as JaxSF
from tensoralloy_tpu.train.dataset import Dataset as JaxDataset
from tensoralloy_tpu.train.trainer import (
    OptParameters as JaxOpt, TrainParameters as JaxTP,
    Trainer as JaxTrainer)
from tensoralloy_tpu.transform import Featurizer as JaxFeaturizer
from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
from tensoralloy_tpu_torch.io.model import load_model, save_model
from tensoralloy_tpu_torch.io.sqlite import connect
from tensoralloy_tpu_torch.nn import losses as L
from tensoralloy_tpu_torch.nn.atomic import AtomicNN
from tensoralloy_tpu_torch.nn.finite_temperature import (
    TemperatureDependentAtomicNN)
from tensoralloy_tpu_torch.nn.grap import GenericRadialAtomicPotential
from tensoralloy_tpu_torch.nn.sf import SymmetryFunction
from tensoralloy_tpu_torch.ops import dense
from tensoralloy_tpu_torch.train.trainer import (OptParameters,
                                                 TrainParameters, Trainer)
from tensoralloy_tpu_torch.transform.featurizer import Featurizer
from tensoralloy_tpu_torch.utils import tree_flatten, tree_map

ROOT = Path(__file__).resolve().parent.parent
NI_DB = ROOT / "artifacts" / "snap_ni" / "snap-Ni.db"
BE_DB = ROOT / "artifacts" / "td_be" / "td-Be.db"
MONI_DB = ROOT / "artifacts" / "snap_moni" / "snap-MoNi.db"
DATA = ROOT / "tests" / "data"
SF_KW = dict(eta=[0.1, 1.0, 4.0], omega=[0.0], beta=[0.005],
             gamma=[1.0, -1.0], zeta=[1.0, 4.0])
PEXP = {"rl": [1.0, 2.0, 3.0], "pl": [4.0, 3.0, 2.0]}
HIDDEN = [16, 16]


@pytest.fixture(autouse=True)
def _numpy_neighbor_path(monkeypatch):
    # both packages on the numpy neighbor and triple lists
    monkeypatch.setenv("TENSORALLOY_TPU_NO_NATIVE", "1")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def small_db(source: Path, target: Path, n: int, max_atoms: int):
    """The first `n` structures of at most `max_atoms` atoms of `source`,
    written to a fresh database (the port's writer) that both packages
    then open."""
    from tensoralloy_tpu_torch.atoms import Structure
    db = connect(str(target))
    picked = 0
    for s in jax_connect(str(source)):
        if len(s) > max_atoms or picked == n:
            continue
        db.write(Structure(s.numbers, s.positions, s.cell, s.pbc,
                           info=dict(s.info)), commit=False)
        picked += 1
    db._con.commit()
    assert picked == n
    return db


# kind -> (database, structures, atoms, descriptor factories, model kind)
CASES = {
    "sf_dense": ("ni", "sf", "dense", "auto"),
    "sf_pallas": ("ni", "sf", "pallas", "auto"),
    "sf_autodiff": ("ni", "sf", "dense", "autodiff"),
    "grap_012": ("ni", "grap012", "pallas", "auto"),
    "grap_05": ("ni", "grap05", "pallas", "auto"),
    "td": ("be", "td", "pallas", "auto"),
    # two elements, each absent from some structures (the database's
    # small cells are pure Mo or pure Ni)
    "moni_grap": ("moni", "grap012", "pallas", "auto"),
    # the flat pair and triple layout (autograd w.r.t. positions), legacy
    # GRAP and the learned filter (whose weights get gradients too)
    "sf_segment": ("ni", "sf", "segment", "auto"),
    "grap_segment": ("ni", "grap012", "segment", "auto"),
    "grap_legacy": ("ni", "grap_legacy", "segment", "auto"),
    "grap_nn": ("ni", "grap_nn", "segment", "auto"),
}


def _descriptors(kind, elements, backend):
    if kind == "sf":
        return (JaxSF(elements, backend=backend, **SF_KW),
                SymmetryFunction(elements, backend=backend, **SF_KW))
    moments = list(range(6)) if kind == "grap05" else [0, 1, 2]
    kw = dict(algorithm="pexp", parameters=PEXP, moment_tensors=moments,
              backend=backend)
    if kind == "grap_legacy":
        kw["legacy_mode"] = True
    elif kind == "grap_nn":
        kw.update(algorithm="nn", parameters={
            "num_filters": 4, "hidden_sizes": [8, 8], "h_abck_modifier": 1})
    return (JaxGRAP(elements, **kw),
            GenericRadialAtomicPotential(elements, **kw))


def _seeded_params(jax_model, feats, seed=0):
    """Parameters in the shape of the JAX tree, made with numpy from a
    seed; the min/max statistics are the JAX sweep's over `feats`."""
    params = jax_model.init_params(jax.random.PRNGKey(0))
    if jax_model.minmax_scale:
        params = jax_model.update_norm_stats(
            params, {k: jnp.asarray(v) for k, v in feats.items()})
    rng = np.random.default_rng(seed)

    def fill(path, x):
        names = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        x = np.asarray(x, np.float64)
        if "norm" in names:
            return x
        if names[-1] == "w":
            return rng.normal(0.0, 1.0 / np.sqrt(x.shape[0]), x.shape)
        if names[-1] == "dt":
            return 0.1 + rng.normal(0.0, 0.02, x.shape)
        return x + rng.normal(0.0, 0.1, x.shape)

    return jax.tree_util.tree_map_with_path(fill, params)


class Case:
    """One configuration built in both packages over one database."""

    def __init__(self, name, tmp: Path):
        which, kind, backend, assembly = CASES[name]
        tmp.mkdir(parents=True, exist_ok=True)
        if which == "ni":
            self.db = small_db(NI_DB, tmp / "ni.db", 12, 32)
        elif which == "moni":
            self.db = small_db(MONI_DB, tmp / "moni.db", 12, 32)
        else:
            self.db = small_db(BE_DB, tmp / "be.db", 8, 36)
        path = self.db.filename
        self.jax_db = jax_connect(path)
        elements = self.jax_db.elements
        angular = kind == "sf"
        fz_kw = dict(rcut=4.5, angular=angular)
        if angular:
            fz_kw["acut"] = 3.5
        jfz = JaxFeaturizer(elements, **fz_kw)
        fz = Featurizer(elements, **fz_kw)
        jdesc, desc = _descriptors(kind, elements, backend)
        flat = backend == "segment"
        ds = JaxDataset(self.jax_db, jfz, name=name, test_size=2,
                        dtype=np.float64, cache_dir=str(tmp / "jax"),
                        layout="segment" if flat else "dense",
                        transpose=not flat)
        feats, labels = ds.build()
        self.arrays = ds.split(feats, labels)      # tf, tl, ef, el
        static = self.jax_db.get_atomic_static_energy()
        common = dict(hidden_sizes=HIDDEN, atomic_static_energy=static)
        if kind == "td":
            td_kw = dict(layers=[16, 8], **common)
            self.jax_model = JaxTDNN(jfz, ds.max_occurs, jdesc, **td_kw)
            self.model = TemperatureDependentAtomicNN(
                fz, ds.max_occurs, desc, dtype=torch.float64, **td_kw)
            self.minimize = ("energy", "forces", "stress", "eentropy",
                             "free_energy")
            self.lp_kw = dict(
                energy=dict(weight=1.0, per_atom_loss=True),
                forces=dict(weight=2.0),
                stress=dict(weight=0.5, method="rrmse"),
                eentropy=dict(weight=3.0, method="rmse"),
                free_energy=dict(weight=1.5, per_atom_loss=True))
        else:
            self.jax_model = JaxAtomicNN(jfz, ds.max_occurs, jdesc, **common)
            self.model = AtomicNN(fz, ds.max_occurs, desc,
                                  dtype=torch.float64, **common)
            self.minimize = ("energy", "forces", "stress",
                             "total_pressure")
            self.lp_kw = dict(
                energy=dict(weight=20.0, per_atom_loss=True),
                forces=dict(weight=(1.0, 3.0)),
                stress=dict(weight=0.1),
                total_pressure=dict(weight=0.01, method="logcosh"))
        self.l2 = dict(weight=1e-3, decayed=True, decay_rate=0.9,
                       decay_steps=10)
        self.assembly = assembly
        self.params = _seeded_params(self.jax_model, self.arrays[0])

    def trainers(self, opt_kw=None, **tp_kw):
        tp = dict(batch_size=4, train_steps=20, eval_steps=1000,
                  log_steps=1000, seed=3, force_assembly=self.assembly)
        tp.update(tp_kw)
        opt_kw = opt_kw or dict(learning_rate=2e-3)
        jlp = JL.LossParameters(
            l2=JL.L2LossOptions(**self.l2),
            **{k: JL.LossOptions(**v) for k, v in self.lp_kw.items()})
        lp = L.LossParameters(
            l2=L.L2LossOptions(**self.l2),
            **{k: L.LossOptions(**v) for k, v in self.lp_kw.items()})
        jt = JaxTrainer(self.jax_model, jlp, JaxOpt(**opt_kw), JaxTP(**tp),
                        minimize_properties=self.minimize, n_devices=1)
        t = Trainer(self.model, lp, OptParameters(**opt_kw),
                    TrainParameters(**tp),
                    minimize_properties=self.minimize, device="cpu",
                    dtype="high")
        return jt, t

    def torch_params(self):
        return tree_map(lambda x: torch.as_tensor(np.array(x)),
                        self.params)


_cases = {}


@pytest.fixture
def case(request, tmp_path_factory):
    name = request.param
    if name not in _cases:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("TENSORALLOY_TPU_NO_NATIVE", "1")
            _cases[name] = Case(name, tmp_path_factory.mktemp(name))
    return _cases[name]


def _assert_trees_close(got, want, rel, what):
    got, want = tree_flatten(got), tree_flatten(want)
    assert set(got) == set(want)
    scale = max(float(np.max(np.abs(np.asarray(v)))) for v in want.values())
    for key in want:
        err = float(np.max(np.abs(np.asarray(got[key])
                                  - np.asarray(want[key]))))
        assert err <= rel * max(scale, 1e-300), (what, key, err, scale)


@pytest.mark.parametrize("case", list(CASES), indirect=True)
def test_loss_metrics_and_gradients_match_jax(case):
    """`total_loss`, every metric (1e-10) and the parameter gradients
    (1e-9 of the largest entry) at step 7 of 20 on the first 6 training
    structures, with dynamic weights, L2 decay and every loss term."""
    jt, t = case.trainers()
    tf_, tl_ = case.arrays[0], case.arrays[1]
    sel = slice(0, 6)
    jf = {k: jnp.asarray(v[sel]) for k, v in tf_.items()}
    jl = {k: jnp.asarray(v[sel]) for k, v in tl_.items()}
    (want_loss, want_metrics), want_grads = jax.jit(jax.value_and_grad(
        jt.total_loss, has_aux=True))(case.params, jf, jl, 7)
    f = t._to_device({k: v[sel] for k, v in tf_.items()})
    lab = t._to_device({k: v[sel] for k, v in tl_.items()})
    (loss, metrics), grads = t.loss_and_grads(case.torch_params(), f, lab, 7)
    assert _rel(loss, want_loss) <= 1e-10
    assert set(metrics) == set(want_metrics)
    for key, want in want_metrics.items():
        assert abs(float(metrics[key]) - float(want)) <= 1e-10 * max(
            abs(float(want)), 1.0), key
    _assert_trees_close(grads, want_grads, 1e-9, "gradient")
    # the force term reaches the parameters through the second backward
    assert float(metrics["loss/forces"]) > 0


@pytest.mark.parametrize("case", ["moni_grap"], indirect=True)
def test_two_element_batches_and_norm_stats_match_jax(case):
    """S = 2 with an element absent from some structures: the per-element
    row slices of the batched forward (predictions of a mixed batch), and
    `update_norm_stats` accumulated over chunks of which one holds no Mo
    atom at all, against the JAX sweep over the whole set."""
    tf_, tl_ = case.arrays[0], case.arrays[1]
    n_mo = case.jax_model.max_occurs["Mo"]
    mo_rows = slice(1, 1 + n_mo)        # the VAP puts Mo before Ni
    has_mo = tf_["atom_masks"][:, mo_rows].sum(axis=1) > 0
    assert has_mo.any() and (~has_mo).any()
    jt, t = case.trainers()
    jf = {k: jnp.asarray(v) for k, v in tf_.items()}
    want = jax.jit(jt.batched_predictions)(case.params, jf)
    got = t.batched_predictions(case.torch_params(), t._to_device(tf_))
    for key in ("energy", "forces", "stress_voigt"):
        assert _rel(got[key].numpy(), want[key]) <= 1e-10, key

    fresh = case.jax_model.init_params(jax.random.PRNGKey(1))
    want_norm = case.jax_model.update_norm_stats(fresh, jf)
    params = tree_map(lambda x: torch.as_tensor(np.array(x)), fresh)
    order = np.concatenate([np.nonzero(~has_mo)[0], np.nonzero(has_mo)[0]])
    n_first = int((~has_mo).sum())
    for rows in (order[:n_first], order[n_first:]):
        params = case.model.update_norm_stats(
            params, t._to_device({k: v[rows] for k, v in tf_.items()}))
    for element in ("Mo", "Ni"):
        for key in ("xlo", "xhi"):
            np.testing.assert_allclose(
                params[element]["norm"][key].numpy(),
                np.asarray(want_norm[element]["norm"][key]), rtol=1e-12,
                atol=1e-12, err_msg=f"{element} {key}")


@pytest.mark.parametrize("case", ["grap_012"], indirect=True)
def test_precision_annealing_switches_at_the_jax_block(case, capsys):
    """`final_f32_steps` with `scan_steps` > 1: both trainers switch at
    the first block that starts at or after train_steps - N (step 6 of
    7 in blocks of 3 with N = 3; a per-step rule would give 4), and the
    port runs exactly those steps with TF32 off."""
    import re
    from tensoralloy_tpu_torch.precision import set_tf32
    kw = dict(train_steps=7, scan_steps=3, final_f32_steps=3)
    jt, t = case.trainers(**kw)
    jt.fit(case.arrays[0], case.arrays[1], params=case.params, verbose=True)
    printed = capsys.readouterr().out
    jax_step = int(re.search(r"precision annealing at step (\d+)",
                             printed).group(1))
    flags = []
    step_fn = t.train_step
    t.train_step = lambda *a: (flags.append(
        torch.backends.cuda.matmul.allow_tf32), step_fn(*a))[1]
    set_tf32(True)
    try:
        t.fit(case.arrays[0], case.arrays[1], params=case.torch_params(),
              verbose=True)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        set_tf32(False)
    port_step = int(re.search(r"precision annealing at step (\d+)",
                              capsys.readouterr().out).group(1))
    assert jax_step == port_step == t.annealed_at == 6
    assert flags == [True] * 6 + [False]
    # no annealing asked for: no switch
    _, plain = case.trainers(train_steps=2)
    plain.fit(case.arrays[0], case.arrays[1], params=case.torch_params(),
              verbose=False)
    assert plain.annealed_at is None


def test_dataset_reads_the_jax_default_cache_and_upgrades_old_ones(
        tmp_path, monkeypatch):
    """With no `-dense` cache file the port reads the file that the JAX
    `Dataset` writes by default (layout 'both') and keeps its dense
    keys; a cache from before the packed images is converted and
    rewritten; `input_fn` and `next_batch` give the JAX batches."""
    from tensoralloy_tpu_torch.ops.dense import convert_legacy_shifts
    from tensoralloy_tpu_torch.train.dataset import Dataset
    from tensoralloy_tpu_torch.transform.featurizer import SIMG_BASE, SIMG_OFF
    monkeypatch.setenv("TENSORALLOY_TPU_NO_NATIVE", "1")
    db = small_db(NI_DB, tmp_path / "ni.db", 8, 32)
    jax_db = jax_connect(db.filename)
    kw = dict(rcut=4.5, acut=3.5, angular=True)
    shared = dict(name="ni", test_size=2, dtype=np.float64)
    jds = JaxDataset(jax_db, JaxFeaturizer(jax_db.elements, **kw),
                     cache_dir=str(tmp_path / "cache"), transpose=True,
                     **shared)
    assert jds.layout == "both" and "dense" not in jds.signature
    jfeats, jlabels = jds.build()
    ds = Dataset(db, Featurizer(db.elements, **kw), layout="dense",
                 cache_dir=str(tmp_path / "cache"), transpose=True, **shared)
    assert ds.signature == jds.signature.replace("-tr-", "-dense-tr-")
    assert not Path(ds.cache_path).exists()
    own = Dataset(db, Featurizer(db.elements, **kw), layout="dense",
                  cache_dir=str(tmp_path / "own"), transpose=True,
                  **shared).build()
    monkeypatch.setattr(Dataset, "_featurize_one", None)   # must not run
    feats, labels = ds.build()
    assert sorted(feats) == sorted(own[0]) and "pair_i" not in feats
    for key in feats:
        np.testing.assert_array_equal(feats[key], own[0][key], err_msg=key)
        np.testing.assert_array_equal(feats[key], jfeats[key], err_msg=key)
    for key in labels:
        np.testing.assert_array_equal(labels[key], own[1][key], err_msg=key)
    assert not Path(ds.cache_path).exists()      # nothing was written

    # a cache with float [B, A, N, 3] shift arrays in place of the codes
    def decode(simg):
        return np.stack([simg % SIMG_BASE - SIMG_OFF,
                         simg // SIMG_BASE % SIMG_BASE - SIMG_OFF,
                         simg // SIMG_BASE ** 2 - SIMG_OFF],
                        axis=-1).astype(np.float64)
    old = {f"l_{k}": v for k, v in own[1].items()}
    for k, v in own[0].items():
        if "simg" in k:
            old[f"f_{k.replace('simg', 'shift')}"] = decode(v)
        else:
            old[f"f_{k}"] = v
    legacy = Dataset(db, Featurizer(db.elements, **kw), layout="dense",
                     cache_dir=str(tmp_path / "legacy"), transpose=True,
                     **shared)
    Path(legacy.cache_path).parent.mkdir()
    np.savez_compressed(legacy.cache_path, **old)
    upgraded, _ = legacy.build()
    for key in own[0]:
        np.testing.assert_array_equal(upgraded[key], own[0][key],
                                      err_msg=key)
    with np.load(legacy.cache_path) as z:
        assert "f_pair_simg_d" in z.files and "f_trip_simg_k_d" in z.files
        assert not [k for k in z.files if "shift" in k]
    from tensoralloy_tpu.ops.dense import (
        convert_legacy_shifts as jax_convert)
    one = {"pair_shift_d": decode(own[0]["pair_simg_d"][0])}
    np.testing.assert_array_equal(
        convert_legacy_shifts(dict(one))["pair_simg_d"],
        jax_convert(dict(one))["pair_simg_d"])

    # input_fn / next_batch: the JAX package's batches
    for mode in ("train", "eval"):
        want_it = jds.input_fn(3, mode)()
        got_it = ds.input_fn(3, mode)()
        for _ in range(3):
            (wf, wl), (gf, gl) = next(want_it), next(got_it)
            for key in gf:
                np.testing.assert_array_equal(gf[key], wf[key])
            for key in gl:
                np.testing.assert_array_equal(gl[key], wl[key])
    bf, bl = ds.next_batch(4)
    wf, wl = jds.next_batch(4)
    assert bf["positions"].shape[0] == 4
    np.testing.assert_array_equal(bl["energy"], wl["energy"])


@pytest.mark.parametrize("case", ["sf_pallas"], indirect=True)
def test_dense_and_autodiff_force_assembly_agree(case):
    """force_assembly 'dense' (through the transpose tables) and
    'autodiff' (w.r.t. positions and cell) give one loss and gradient."""
    _, t = case.trainers()
    _, t_auto = case.trainers(force_assembly="autodiff")
    f = t._to_device(case.arrays[0])
    lab = t._to_device(case.arrays[1])
    (loss, _), grads = t.loss_and_grads(case.torch_params(), f, lab, 0)
    (loss_a, _), grads_a = t_auto.loss_and_grads(case.torch_params(), f,
                                                 lab, 0)
    assert _rel(loss_a, loss) <= 1e-10
    _assert_trees_close(grads_a, grads, 1e-9, "gradient")
    stripped = {k: v for k, v in f.items() if "trans" not in k}
    with pytest.raises(KeyError, match="transpose"):
        case.trainers(force_assembly="dense")[1].loss_and_grads(
            case.torch_params(), stripped, lab, 0)


@pytest.mark.parametrize("case,tables", [("sf_pallas", 3), ("grap_012", 1)],
                         indirect=["case"])
def test_dense_train_step_assembles_without_index_put(case, tables):
    """A dense-assembly train step differentiates each force assembly
    (pairs; an SF model's triples on their j and k sides too) once, by
    the gather through the forward table, so an SF step records no
    accumulating index_put. (On the CPU, GRAP's VJP runs its plain
    stand-in, which accumulates by index_put; the card runs its
    kernel.)"""
    _, t = case.trainers()
    state = t.init_state(case.torch_params())
    feats = t._to_device(case.arrays[0])
    labels = t._to_device(case.arrays[1])
    batch = {k: v[:4] for k, v in feats.items()}
    batch_labels = {k: v[:4] for k, v in labels.items()}
    dense.reset_assembly_counts()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t.train_step(state, batch, batch_labels)
    assert dense.assembly_counts["transpose_reduce_bwd"] == tables
    assert dense.assembly_counts["forward_gather"] == tables
    if tables == 3:
        ops = {e.key for e in prof.key_averages()}
        assert not ops & {"aten::index_put_", "aten::_index_put_impl_"}


def _fit(trainer, arrays, params, **kw):
    losses = []
    out = trainer.fit(arrays[0], arrays[1], params=params, verbose=False,
                      callback=lambda s, st, m: losses.append(
                          float(m["loss/total"])), **kw)
    return out, losses


@pytest.mark.parametrize("case", ["sf_pallas", "grap_012"], indirect=True)
def test_five_step_trajectory_matches_jax(case):
    """5 adam + EMA steps with an exponential schedule and a clip: the
    loss of every step (1e-8), the final parameters and the EMA. The
    schedule is a staircase of halvings: optax computes it in float32,
    where only an integer exponent gives the same bits everywhere."""
    opt = dict(learning_rate=5e-3, decay_function="exponential",
               decay_rate=0.5, decay_steps=2, staircase=True,
               clip_norm=5.0)
    jt, t = case.trainers(opt_kw=opt, train_steps=5)
    want, want_losses = _fit(jt, case.arrays, case.params)
    got, losses = _fit(t, case.arrays, case.torch_params())
    assert len(losses) == 5
    np.testing.assert_allclose(losses, want_losses, rtol=1e-8)
    assert got["state"]["step"] == 5 == int(want["state"]["step"])
    for key, jkey in (("params", "params"), ("ema_params", "ema_params")):
        _assert_trees_close(got["state"][key], want["state"][jkey], 1e-8,
                            key)


@pytest.mark.parametrize("case", ["td"], indirect=True)
def test_microbatch_equals_monolithic(case):
    """microbatch_size=2 of batch 4 gives the monolithic batch's
    parameters where the loss is linear in the batch mean (logcosh, and
    structures of one size: the Be frames), and `scan_steps` only groups
    the callbacks."""
    case.lp_kw, saved = dict(
        energy=dict(method="logcosh"),
        forces=dict(method="logcosh")), case.lp_kw
    try:
        results, calls = [], []
        for mb, scan in ((0, 1), (2, 2)):
            _, t = case.trainers(train_steps=4, microbatch_size=mb,
                                 scan_steps=scan)
            t.minimize = ("energy", "forces")
            out, losses = _fit(t, case.arrays, case.torch_params())
            results.append(out["state"]["params"])
            calls.append(len(losses))
    finally:
        case.lp_kw = saved
    assert calls == [4, 2]
    _assert_trees_close(results[1], results[0], 1e-9, "params")
    with pytest.raises(ValueError, match="microbatch_size"):
        TrainParameters(batch_size=4, microbatch_size=3)
    with pytest.raises(ValueError, match="force_assembly"):
        TrainParameters(force_assembly="scatter")
    with pytest.raises(ValueError, match="eval_matmul_precision"):
        TrainParameters(eval_matmul_precision="fp8")


@pytest.mark.parametrize("case", ["sf_dense", "td"], indirect=True)
def test_evaluate_matches_jax(case):
    """`evaluate` over all structures in batches of 4 and 3 (a short last
    batch): every metric with its own denominator."""
    jt, t = case.trainers()
    feats = {k: np.concatenate([case.arrays[0][k], case.arrays[2][k]])
             for k in case.arrays[0]}
    labels = {k: np.concatenate([case.arrays[1][k], case.arrays[3][k]])
              for k in case.arrays[1]}
    for bs in (4, 3):
        want = jt.evaluate(case.params, feats, labels, batch_size=bs)
        got = t.evaluate(case.torch_params(), feats, labels, batch_size=bs)
        assert set(got) == set(want)
        for key in want:
            assert abs(got[key] - want[key]) <= 1e-10 * max(
                abs(want[key]), 1.0), key
    assert t.evaluate(case.torch_params(),
                      {k: v[:0] for k, v in feats.items()},
                      {k: v[:0] for k, v in labels.items()}) == {}


@pytest.mark.parametrize("case", ["grap_012"], indirect=True)
def test_checkpoint_round_trip_and_restore_switches(case, tmp_path):
    """save -> load gives the same trees; the three `restore_state`
    switches; resume from a checkpoint equals the uninterrupted run bit
    for bit."""
    _, t = case.trainers(train_steps=5)
    kept = {}
    straight = t.fit(
        case.arrays[0], case.arrays[1], params=case.torch_params(),
        verbose=False, callback=lambda s, st, m: kept.update(
            {s + 1: st}))
    state = kept[3]
    path = str(tmp_path / "ckpt-3.npz")
    t.save_checkpoint(path, state, extra={"note": 1})
    assert json.loads(Path(path + ".json").read_text()) == {"note": 1}
    params, ema, step = t.load_checkpoint(path)
    assert step == 3
    _assert_trees_close(params, state["params"], 0.0, "params")
    _assert_trees_close(ema, state["ema_params"], 0.0, "ema")

    full = t.restore_state(path)
    assert full["step"] == 3 and full["opt_state"]["count"] == 3
    _assert_trees_close(full["opt_state"]["mu"], state["opt_state"]["mu"],
                        0.0, "mu")
    from_ema = t.restore_state(path, use_ema_variables=True,
                               restore_optimizer_variables=False)
    _assert_trees_close(from_ema["params"], state["ema_params"], 0.0, "ema")
    assert from_ema["opt_state"]["count"] == 0
    assert float(sum(v.abs().sum() for v in tree_flatten(
        from_ema["opt_state"]["nu"]).values())) == 0.0
    reset = t.restore_state(path, reset_global_step=True)
    assert reset["step"] == 0 and reset["opt_state"]["count"] == 0
    _assert_trees_close(reset["opt_state"]["nu"], state["opt_state"]["nu"],
                        0.0, "nu")

    resumed = t.fit(case.arrays[0], case.arrays[1], verbose=False,
                    initial_state=t.restore_state(path))
    assert resumed["state"]["step"] == 5
    _assert_trees_close(resumed["state"]["params"],
                        straight["state"]["params"], 0.0, "resumed params")
    _assert_trees_close(resumed["state"]["ema_params"],
                        straight["state"]["ema_params"], 0.0, "resumed ema")


@pytest.mark.parametrize("case", ["sf_dense"], indirect=True)
def test_checkpoints_and_models_cross_the_packages(case, tmp_path):
    """A JAX checkpoint warm-starts the port (weights, EMA, step and the
    adam moments: two more steps equal JAX's own), a port checkpoint is
    read by the JAX `restore_state`, and the model the port exports is
    served by both calculators."""
    jt5, t5 = case.trainers(train_steps=5)
    kept = {}
    want = jt5.fit(
        case.arrays[0], case.arrays[1], params=case.params, verbose=False,
        callback=lambda s, st, m: kept.update(
            {s + 1: jax.device_get(st)} if s == 2 else {}))
    jout = {"state": kept[3]}
    path = str(tmp_path / "jax-ckpt.npz")
    jt5.save_checkpoint(path, kept[3])
    state = t5.restore_state(path)
    assert state["step"] == 3 and state["opt_state"]["count"] == 3
    _assert_trees_close(state["params"], jout["state"]["params"], 0.0,
                        "params")
    _assert_trees_close(state["opt_state"]["nu"],
                        jout["state"]["opt_state"][0].nu, 0.0, "nu")
    got = t5.fit(case.arrays[0], case.arrays[1], verbose=False,
                 initial_state=state)
    _assert_trees_close(got["state"]["params"], want["state"]["params"],
                        1e-9, "params after resume")

    port_path = str(tmp_path / "port-ckpt.npz")
    t5.save_checkpoint(port_path, got["state"])
    back = jt5.restore_state(port_path, case.params)
    assert int(back["step"]) == 5
    _assert_trees_close(back["params"], got["state"]["params"], 0.0,
                        "port params in JAX")
    _assert_trees_close(back["opt_state"][0].mu,
                        got["state"]["opt_state"]["mu"], 0.0,
                        "port moments in JAX")

    exported = str(tmp_path / "exported.npz")
    save_model(exported, case.model, got["state"]["ema_params"])
    structure = case.db.get(1)
    calc = TensorAlloyCalculator(exported, device="cpu", dtype="high")
    res = calc.calculate(structure)
    jcalc = JaxCalculator(exported)
    js = case.jax_db.get(1)
    assert abs(res["energy"] - jcalc.get_potential_energy(js)) <= 1e-9 * abs(
        res["energy"])
    assert _rel(res["forces"], jcalc.get_forces(js)) <= 1e-9
    # and it is the EMA tree that was written
    model, _ = load_model(exported, device="cpu", dtype="high")
    _assert_trees_close(model.param_tree(), got["state"]["ema_params"], 0.0,
                        "exported weights")


def test_fit_from_init_params_trains(tmp_path):
    """`fit` with no parameters given: `init_params` from the seed, the
    min/max sweep over the training set, host streaming and the
    device-resident path give the same run, the loss on a fixed batch
    falls, and a periodic evaluation lands in the history."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TENSORALLOY_TPU_NO_NATIVE", "1")
        case = Case("sf_dense", tmp_path)
    case.lp_kw = dict(energy=dict(weight=1.0, per_atom_loss=True),
                      forces=dict(weight=1.0), stress=dict(weight=0.0),
                      total_pressure=dict(weight=0.0))
    tf_, tl_, ef_, el_ = case.arrays
    runs = []
    for on_device in (True, False):
        _, t = case.trainers(opt_kw=dict(learning_rate=0.01),
                             train_steps=30, eval_steps=15,
                             device_dataset=on_device)
        t.minimize = ("energy", "forces")
        evals = []
        out = t.fit(tf_, tl_, ef_, el_, verbose=False,
                    eval_callback=lambda s, st, ev: evals.append(s))
        runs.append(out["state"]["params"])
        assert [h["step"] for h in out["history"]] == [15, 30] == evals
        assert out["throughput"] > 0
    _assert_trees_close(runs[1], runs[0], 0.0, "host vs device batches")
    params0 = t.init_params(tf_, verbose=False)
    norm = params0["Ni"]["norm"]
    assert bool((norm["xhi"] >= norm["xlo"]).all())
    f, lab = t._to_device(tf_), t._to_device(tl_)
    before = float(t.total_loss(params0, f, lab, 0)[0])
    after = float(t.total_loss(runs[0], f, lab, 0)[0])
    assert np.isfinite(after) and after < before


@pytest.mark.parametrize("case", ["sf_dense"], indirect=True)
def test_hooks_drive_a_fit(case, tmp_path):
    """The hooks through `fit(callback=compose_hooks(...))`: periodic
    checkpoints with keep-N rotation that `restore_state` reads, the
    JSONL metric log, the NaN guard, a profiler trace, and the best-
    checkpoint hook on the periodic evaluations."""
    from tensoralloy_tpu_torch.train import hooks
    _, t = case.trainers(train_steps=6, eval_steps=3)
    model_dir = str(tmp_path / "model")
    log = tmp_path / "metrics.jsonl"
    profiler = hooks.ProfilerHook(str(tmp_path / "prof"), every_steps=2,
                                  trace_steps=1)
    logger = hooks.LoggingTensorHook(every_steps=2, jsonl_path=str(log))
    best = hooks.BestCheckpointHook(t, model_dir, metric="forces/mae")
    run = [hooks.CheckpointHook(t, model_dir, every_steps=2, keep=2),
           logger, hooks.NanTensorHook(every_steps=1),
           hooks.ExamplesPerSecondHook(4, every_steps=2), profiler]
    out = t.fit(*case.arrays, params=case.torch_params(), verbose=False,
                callback=hooks.compose_hooks(run),
                eval_callback=best.after_eval)
    for hook in run:
        hook.end()
    kept = sorted(p.name for p in Path(model_dir).glob("ckpt-[0-9]*.npz"))
    assert kept == ["ckpt-4.npz", "ckpt-6.npz"]
    latest = hooks.latest_checkpoint(model_dir)
    assert latest.endswith("ckpt-6.npz")
    state = t.restore_state(latest)
    assert state["step"] == 6
    _assert_trees_close(state["params"], out["state"]["params"], 0.0,
                        "checkpointed params")
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 3, 5]
    assert all(np.isfinite(r["loss/total"]) for r in rows)
    assert list((tmp_path / "prof").glob("trace-*.json"))
    record = json.loads((Path(model_dir) / "best.json").read_text())
    assert record["metric"] == "forces/mae" and record["step"] in (3, 6)
    assert (Path(model_dir) / "ckpt-best.npz").exists()
    guard = hooks.NanTensorHook(every_steps=1)
    guard.after_step(0, None, {"loss/total": torch.tensor(1.0)})
    with pytest.raises(FloatingPointError, match="loss/total"):
        guard.after_step(1, None, {"loss/total": torch.tensor(float("nan"))})


def test_trainer_defaults_to_the_card_and_names_what_waits(monkeypatch,
                                                          tmp_path):
    from tensoralloy_tpu_torch.train.dataset import to_tensors
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TENSORALLOY_TPU_NO_NATIVE", "1")
        case = Case("sf_dense", tmp_path)
    args = (case.model, L.LossParameters(), OptParameters(),
            TrainParameters())
    # several devices: the ValueError JAX raises with too few (a group of
    # four ranks trains, tests/test_torch_parallel_train.py)
    with pytest.raises(ValueError,
                       match="requested 4 devices but only 1 available"):
        Trainer(*args, n_devices=4, device="cpu")
    # a constraint is moved to the trainer's device and dtype, and its
    # loss joins the total under its name (nn/constraints.py)

    class Pin:
        name = "pin"

        def to(self, device, dtype):
            self.moved = (device, dtype)
            return self

    pin = Pin()
    assert Trainer(*args, constraints=[pin], device="cpu").constraints \
        == [pin]
    assert pin.moved == (torch.device("cpu"), torch.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Trainer(*args)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        to_tensors(case.arrays[0])
    assert to_tensors(case.arrays[0], device="cpu",
                      dtype="medium")["positions"].dtype == torch.float32


# ----------------------------------------------------------------------
# Full-width fixtures for chip_smoke.py's train phase
# ----------------------------------------------------------------------

def _full_width_record(name: str, workdir: Path) -> dict:
    """Run the JAX trainer on the CPU at float64 at the full width of one
    of chip_smoke's training configurations -> the numbers its train
    phase compares with."""
    import chip_smoke
    from tensoralloy_tpu.train.manager import (
        TrainingManager as JaxTrainingManager)
    cfg = chip_smoke.TRAIN_CONFIGS[name]
    workdir.mkdir(parents=True, exist_ok=True)
    steps = cfg["fixture_steps"]
    # the run's input.toml as chip_smoke's train phase changes it, read
    # by the JAX manager: loss, optimizer, batch size, seed and split
    # are the file's
    manager = JaxTrainingManager(chip_smoke.experiment_config(
        cfg["run"], workdir, {
            "precision": "high",
            f"nn.atomic.{cfg['descriptor']}.backend": "dense",
            "train.train_steps": steps, "train.scan_steps": 1,
            "train.eval_steps": 10 ** 6, "train.log_steps": 10 ** 6,
            "train.force_assembly": "dense", "train.final_f32_steps": 0},
        database=NI_DB))
    trainer, ds = manager.trainer, manager.dataset
    batch_size, seed = (manager.train_parameters.batch_size,
                        manager.train_parameters.seed)
    model, saved, _ = jax_load_model(str(ROOT / cfg["model"]))
    saved = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                   saved)
    feats, labels = ds.build()
    tf_, tl_, ef_, el_ = ds.split(feats, labels)
    assert ds.max_occurs == model.max_occurs
    assert manager.model.as_dict() == model.as_dict()
    if cfg["warm_start"]:
        params0 = saved
    else:
        params0 = chip_smoke.seeded_params(
            jax.tree_util.tree_map(np.asarray, saved), seed)
    from tensoralloy_tpu.train.dataset import batches as jax_batches
    first = next(jax_batches(tf_, tl_, batch_size, seed=seed, repeat=True))
    (_, _), grads = jax.jit(jax.value_and_grad(
        trainer.total_loss, has_aux=True))(
            params0, {k: jnp.asarray(v) for k, v in first[0].items()},
            {k: jnp.asarray(v) for k, v in first[1].items()}, 0)
    grad_norm = float(jnp.sqrt(sum(
        jnp.sum(jnp.square(g)) for g in jax.tree_util.tree_leaves(grads))))
    losses = []
    trainer.fit(tf_, tl_, params=params0, verbose=False,
                callback=lambda s, st, m: losses.append(
                    float(m["loss/total"])))
    record = {"config": name, "precision": "float64",
              "batch_size": batch_size, "steps": steps,
              "losses": losses, "grad_norm_first_step": grad_norm,
              "n_train": int(len(tl_["energy"])),
              "n_test": int(len(el_["energy"]))}
    if cfg.get("evaluate"):
        record["evaluate"] = trainer.evaluate(saved, ef_, el_)
    return record


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from tensoralloy_tpu import set_precision
    set_precision("high")
    os.environ["TENSORALLOY_TPU_NO_NATIVE"] = "1"
    import tempfile
    names = sys.argv[1:] or ["sf", "grap"]
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            record = _full_width_record(name, Path(tmp) / name)
            path = DATA / f"torch_port_ref_train_{name}.json"
            path.write_text(json.dumps(record, indent=1) + "\n")
            print(f"wrote {path}: {record['losses']}")
