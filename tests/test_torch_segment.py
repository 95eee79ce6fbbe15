"""The flat ('segment') descriptor layout in the port against the JAX
package at float64: the featurizer's flat pair and triple arrays key by
key on the six cells of tests/test_torch_native.py (integers exactly,
floats to 1e-12), `triple_distances` (one structure, a batch, the
rij-fed route), SF and GRAP E/F/S on the segment backend (1e-10), a
batch of two structures against two single calls, padding that is most
of the arrays, `Dataset` reading the JAX package's default ('both')
cache, the experiment file with `backend = 'segment'` and a float64 train
step (1e-8), the refusal of `force_assembly = 'dense'` with it, and
`compute kappa` of a segment model through both command lines. The
trainer's loss, metrics and gradients on the flat layout are cases of
tests/test_torch_training.py (`sf_segment`, `grap_segment`).
"""
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoralloy_tpu.atoms import Structure as JaxStructure
from tensoralloy_tpu.nn.atomic import AtomicNN as JaxAtomicNN
from tensoralloy_tpu.nn.fields import make_efs_fn as jax_efs
from tensoralloy_tpu.nn.grap import GenericRadialAtomicPotential as JaxGRAP
from tensoralloy_tpu.nn.sf import SymmetryFunction as JaxSF
from tensoralloy_tpu.ops.pairs import triple_distances as jax_triples
from tensoralloy_tpu.train.dataset import Dataset as JaxDataset
from tensoralloy_tpu.train.manager import (
    TrainingManager as JaxTrainingManager)
from tensoralloy_tpu.transform import Featurizer as JaxFeaturizer
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.nn.atomic import AtomicNN
from tensoralloy_tpu_torch.nn.fields import make_efs_fn
from tensoralloy_tpu_torch.nn.grap import GenericRadialAtomicPotential
from tensoralloy_tpu_torch.nn.sf import SymmetryFunction
from tensoralloy_tpu_torch.ops.pairs import triple_distances
from tensoralloy_tpu_torch.train.dataset import Dataset
from tensoralloy_tpu_torch.train.manager import TrainingManager
from tensoralloy_tpu_torch.transform import Featurizer
from tensoralloy_tpu_torch.transform.featurizer import batch_features

import test_torch_native as native_cells
from test_torch_host import mo_ni
from test_torch_training import NI_DB, _assert_trees_close, _rel, small_db

REL = 1e-10
SF_KW = dict(eta=[0.1, 1.0, 4.0], omega=[0.0], beta=[0.005],
             gamma=[1.0, -1.0], zeta=[1.0, 4.0])
PEXP = {"rl": [1.0, 2.0, 3.0], "pl": [4.0, 3.0, 2.0]}
ELEMENTS = ["Mo", "Ni"]


def _both(symbols, pos, cell, pbc=(True, True, True)):
    return (JaxStructure.from_symbols(symbols, pos, cell, pbc=list(pbc)),
            Structure.from_symbols(symbols, pos, cell, pbc=list(pbc)))


@pytest.mark.parametrize("layout", ["segment", "both"])
@pytest.mark.parametrize("cell", sorted(native_cells.CELLS))
def test_featurizer_layouts_match_jax(cell, layout):
    """Every key of the angular feature dict, in the JAX order, bucketed
    (the calculator's padding) and not."""
    build, elements, kw = native_cells.CELLS[cell]
    symbols, pos, box, pbc = build()
    js, s = _both(symbols, pos, box, pbc)
    jfz = JaxFeaturizer(elements, angular=True, **kw)
    fz = Featurizer(elements, angular=True, **kw)
    for opts in (dict(), dict(pair_bucket=lambda n: 1 << n.bit_length(),
                              trip_bucket=lambda n: 1 << n.bit_length(),
                              transpose=True)):
        want = jfz.featurize(js, layout=layout, **opts)
        got = fz.featurize(s, layout=layout, **opts)
        assert list(got) == list(want)
        assert "trip_i" in got and ("trip_j_d" in got) == (layout == "both")
        for key in want:
            w, g = np.asarray(want[key]), np.asarray(got[key])
            assert g.dtype == w.dtype and g.shape == w.shape, key
            if np.issubdtype(w.dtype, np.integer):
                np.testing.assert_array_equal(g, w, err_msg=key)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12,
                                           err_msg=key)


def _angular_features(structures, nijk_max=None, nij_max=None):
    """Both packages' segment features of the MoNi cells, padded alike."""
    jfz = JaxFeaturizer(ELEMENTS, 4.5, angular=True, acut=3.5)
    fz = Featurizer(ELEMENTS, 4.5, angular=True, acut=3.5)
    occurs = Counter()
    for symbols, _, _ in structures:
        for e, c in Counter(symbols).items():
            occurs[e] = max(occurs[e], c)
    out = []
    for symbols, pos, cell in structures:
        js, s = _both(symbols, pos, cell)
        kw = dict(layout="segment", nij_max=nij_max, nijk_max=nijk_max)
        out.append((jfz.featurize(js, jfz.make_vap(js, occurs), **kw),
                    fz.featurize(s, fz.make_vap(s, occurs), **kw)))
    return jfz, fz, occurs, out


def test_triple_distances_match_jax():
    """One structure, a batch of two (each structure's triples address
    its own rows), and the rij-fed route; padded triples read 1."""
    cells = [mo_ni(seed=1), mo_ni(seed=2)]
    _, _, _, feats = _angular_features(cells, nijk_max=4000, nij_max=900)
    singles = []
    for jf, f in feats:
        want = jax_triples({k: jnp.asarray(v) for k, v in jf.items()})
        got = triple_distances({k: torch.as_tensor(v)
                                for k, v in f.items()})
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=1e-12, atol=1e-12)
        pad = f["trip_mask"] == 0
        assert pad.any() and all((g.numpy()[pad] == 1.0).all() for g in got)
        singles.append(got)
    batch = {k: torch.as_tensor(v) for k, v in batch_features(
        [f for _, f in feats]).items()}
    for b, got in enumerate(triple_distances(batch)):
        for i in range(2):
            torch.testing.assert_close(got[i], singles[i][b], rtol=0, atol=0)
    jf, f = feats[0]
    pos, cell = jf["positions"], jf["cell"]
    rij = pos[jf["trip_j"]] + jf["trip_shift_j"] @ cell - pos[jf["trip_i"]]
    rik = pos[jf["trip_k"]] + jf["trip_shift_k"] @ cell - pos[jf["trip_i"]]
    fed = dict(f, trip_rij=torch.as_tensor(rij), trip_rik=torch.as_tensor(rik))
    want = jax_triples(dict(jf, trip_rij=rij, trip_rik=rik))
    for g, w in zip(triple_distances({k: torch.as_tensor(v)
                                      for k, v in fed.items()}), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12)


def _models(kind, fz, jfz, occurs, seed=2):
    if kind == "sf":
        jdesc, desc = JaxSF(ELEMENTS, **SF_KW), SymmetryFunction(ELEMENTS,
                                                                 **SF_KW)
    else:
        kw = dict(algorithm="pexp", parameters=PEXP,
                  moment_tensors=[0, 1, 2, 3])
        jdesc, desc = JaxGRAP(ELEMENTS, **kw), GenericRadialAtomicPotential(
            ELEMENTS, **kw)
    assert desc.backend == jdesc.backend == "segment"
    jmodel = JaxAtomicNN(jfz, occurs, jdesc, hidden_sizes=[8, 8])
    params = jax.tree_util.tree_map(
        lambda x: x + 0.05 if x.ndim == 1 else x,
        jmodel.init_params(jax.random.PRNGKey(seed)))
    model = AtomicNN(fz, occurs, desc, hidden_sizes=[8, 8],
                     dtype=torch.float64)
    model.load_param_tree(jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, model


@pytest.mark.parametrize("kind", ["sf", "grap"])
def test_segment_efs_match_jax_and_the_dense_route(kind):
    """E/F/S at float64 against JAX's segment backend (1e-10), and the
    same model on the dense backend (the same math, another layout)."""
    _, _, occurs, feats = _angular_features([mo_ni(seed=4)])
    jfz = JaxFeaturizer(ELEMENTS, 4.5, angular=kind == "sf", acut=3.5)
    fz = Featurizer(ELEMENTS, 4.5, angular=kind == "sf", acut=3.5)
    jmodel, params, model = _models(kind, fz, jfz, occurs)
    js, s = _both(*mo_ni(seed=4))
    jf = jfz.featurize(js, jfz.make_vap(js, occurs), layout="both",
                       pair_bucket=lambda n: n + 11,
                       trip_bucket=lambda n: n + 13)
    f = fz.featurize(s, fz.make_vap(s, occurs), layout="both",
                     pair_bucket=lambda n: n + 11,
                     trip_bucket=lambda n: n + 13)
    want = jax.jit(jax_efs(jmodel.energy))(
        params, {k: jnp.asarray(v) for k, v in jf.items()})
    tf = {k: torch.as_tensor(v) for k, v in f.items()}
    got = make_efs_fn(model.energy_and_aux)(tf)
    for key in ("energy", "forces", "stress"):
        assert _rel(got[key], want[key]) <= REL, key
    model.descriptor.backend = "dense"
    dense = make_efs_fn(model.energy_and_aux)(tf)
    for key in ("energy", "forces", "stress", "atomic_energies"):
        assert _rel(got[key], dense[key]) <= REL, key


@pytest.mark.parametrize("kind", ["sf", "grap"])
def test_a_batch_of_two_equals_two_single_calls(kind):
    """Structure b's pairs and triples sum into rows b * A of one
    accumulator: a [2, ...] batch of two different structures gives each
    one's E/F/S; and a structure whose padding is most of its arrays
    (forces and stress finite) equals it unpadded."""
    cells = [mo_ni(seed=5), mo_ni(seed=6, n=20)]
    jfz, fz, occurs, feats = _angular_features(cells, nijk_max=12000,
                                               nij_max=2000)
    if kind == "grap":
        jfz = JaxFeaturizer(ELEMENTS, 4.5)
        fz = Featurizer(ELEMENTS, 4.5)
    _, _, model = _models(kind, fz, jfz, occurs)
    efs = make_efs_fn(model.energy_and_aux)
    tensors = [{k: torch.as_tensor(v) for k, v in f.items()}
               for _, f in feats]
    for t in tensors:
        assert float((t["pair_mask"] == 0).float().mean()) > 0.5
        assert float((t["trip_mask"] == 0).float().mean()) > 0.5
    batch = efs({k: torch.as_tensor(v) for k, v in batch_features(
        [f for _, f in feats]).items()})
    for b, t in enumerate(tensors):
        one = efs(t)
        assert torch.isfinite(one["forces"]).all()
        for key in ("energy", "forces", "stress"):
            assert _rel(batch[key][b], one[key]) <= 1e-12, key
    _, _, _, tight = _angular_features(cells[:1])
    unpadded = efs({k: torch.as_tensor(v) for k, v in tight[0][1].items()})
    for key in ("energy", "forces", "stress"):
        assert _rel(efs(tensors[0])[key], unpadded[key]) <= 1e-12, key


def test_dataset_reads_the_jax_default_cache_in_full(tmp_path, monkeypatch):
    """The JAX `Dataset`'s default layout ('both') on an angular
    featurizer: the port's default is the same file, read without
    featurizing, every key (the flat triples included) equal; the
    port's 'segment' file is read by JAX."""
    monkeypatch.setenv("TENSORALLOY_TPU_NO_NATIVE", "1")
    db = small_db(NI_DB, tmp_path / "ni.db", 8, 32)
    from tensoralloy_tpu.io.sqlite import connect as jax_connect
    jax_db = jax_connect(db.filename)
    kw = dict(rcut=4.5, acut=3.5, angular=True)
    shared = dict(name="ni", test_size=2, dtype=np.float64)
    cache = str(tmp_path / "cache")
    jds = JaxDataset(jax_db, JaxFeaturizer(jax_db.elements, **kw),
                     cache_dir=cache, **shared)
    want, want_l = jds.build()
    ds = Dataset(db, Featurizer(db.elements, **kw), cache_dir=cache,
                 **shared)
    assert ds.layout == "both" and ds.signature == jds.signature
    monkeypatch.setattr(Dataset, "_featurize_one", None)   # must not run
    got, got_l = ds.build()
    assert sorted(got) == sorted(want) and "trip_i" in got
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in want_l:
        np.testing.assert_array_equal(got_l[key], want_l[key], err_msg=key)
    monkeypatch.undo()
    monkeypatch.setenv("TENSORALLOY_TPU_NO_NATIVE", "1")
    seg = Dataset(db, ds.featurizer, cache_dir=str(tmp_path / "port"),
                  layout="segment", **shared)
    feats, _ = seg.build()
    assert not any(k.endswith("_d") for k in feats)
    jseg = JaxDataset(jax_db, jds.featurizer, layout="segment",
                      cache_dir=str(tmp_path / "port"), **shared)
    assert jseg.signature == seg.signature
    jfeats, _ = jseg.build()
    for key in jfeats:
        np.testing.assert_array_equal(feats[key], jfeats[key], err_msg=key)


def test_experiment_file_with_the_segment_backend(tmp_path):
    """snap_ni_sfa's input.toml with `backend = 'segment'` on a cut
    database: the JAX manager's model and flat-layout dataset, a float64
    step's loss and gradients from the same parameters (1e-8), a short
    run and its export; `force_assembly = 'dense'` is refused as in
    JAX."""
    from test_torch_manager import cut_config
    config = cut_config("snap_ni_sfa", tmp_path, {
        "nn.atomic.sf.backend": "segment", "train.train_steps": 2,
        "train.eval_steps": 2})
    want = JaxTrainingManager(dict(config, dataset=dict(
        config["dataset"], tfrecords_dir=str(tmp_path / "jax_cache"))))
    got = TrainingManager(config, device="cpu")
    assert got.model.as_dict() == want.model.as_dict()
    assert got.model.descriptor.backend == "segment"
    assert got.dataset.layout == "segment"
    assert got.dataset.signature == want.dataset.signature
    feats, labels = got.dataset.build()
    assert "trip_i" in feats and "pair_j_d" not in feats
    params = want.model.init_params(jax.random.PRNGKey(5))
    jfeats, jlabels = want.dataset.build()
    sel = slice(0, 4)
    (want_loss, _), want_grads = jax.jit(jax.value_and_grad(
        want.trainer.total_loss, has_aux=True))(
            params, {k: jnp.asarray(v[sel]) for k, v in jfeats.items()},
            {k: jnp.asarray(v[sel]) for k, v in jlabels.items()}, 0)
    t = got.trainer
    (loss, _), grads = t.loss_and_grads(
        jax.tree_util.tree_map(lambda x: torch.as_tensor(np.array(x)),
                               params),
        t._to_device({k: v[sel] for k, v in feats.items()}),
        t._to_device({k: v[sel] for k, v in labels.items()}), 0)
    assert _rel(loss, want_loss) <= 1e-8
    _assert_trees_close(grads, want_grads, 1e-8, "gradient")
    out = got.train_and_evaluate(verbose=False)
    assert out["state"]["step"] == 2
    path = got.export()
    from tensoralloy_tpu_torch.io.model import load_model
    assert load_model(path, device="cpu")[0].descriptor.backend == "segment"
    refused = dict(config, train=dict(config["train"],
                                      force_assembly="dense"))
    for manager in (JaxTrainingManager, TrainingManager):
        with pytest.raises(ValueError, match="force_assembly"):
            manager(refused, **({} if manager is JaxTrainingManager
                                else {"device": "cpu"}))


def test_compute_kappa_on_a_segment_descriptor_model(tmp_path):
    """`compute kappa` of the float64 segment copy of snap_ni_sfa (the
    descriptor heat flux, triples included) through both command lines:
    the same exit code, printed numbers and CSV file (1e-8)."""
    import chip_smoke
    from test_torch_cli_compute import check_case
    models = tmp_path / "models"
    models.mkdir()
    model = chip_smoke.backend_copy(chip_smoke.float64_copy(
        chip_smoke.PATHS["sf"][0], models / "f64.npz"),
        models / "segment.npz", "segment")
    check_case(["kappa", model, "Ni", "--supercell", "2", "2", "2",
                "--equil-steps", "0", "--steps", "10", "--sample", "5",
                "-o", "kappa.csv"], None, tmp_path)
