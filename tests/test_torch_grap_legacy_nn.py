"""Legacy-mode GRAP and the learned 'nn' filter in the port against the
JAX package at float64: the legacy widths and descriptors (moments 0-2),
the E/F/S of models on both (the 'nn' filter with h_abck_modifier 0, 1
and 2, on the segment, dense and 'pallas' backends, where 'pallas' falls
back to the dense path as in JAX), the `.npz` round trip both ways with
the descriptor's weights under ``p/descriptor/...``, and the experiment
files with `legacy_mode = true` and `algorithm = 'nn'` (a step's loss and
gradients, the filter's included). A trainer step with every loss term,
`l2_loss` over the filter's stacks among them, is a case of
tests/test_torch_training.py (`grap_legacy`, `grap_nn`).

Small sizes: the 24-atom MoNi cell of tests/test_backends.py, rcut 4.5,
3 or 4 filters, hidden [8, 8].

`python -m tests.test_torch_grap_legacy_nn` (from the repository root,
a few minutes) writes the full-width fixtures that `chip_smoke.py`'s
descriptors phase holds the card against: the JAX-saved legacy and
'nn' models at the snap_ni_v5_readapt width,
`tests/data/torch_port_grap_{legacy,nn}_ni.npz`, and
`tests/data/torch_port_ref_grap_legacy_nn.json`, their float64 E/F/S on
the 108-atom fixture cell and the loss and gradient of a train step of
each on snap-Ni.db.
"""
import json
import sys
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoralloy_tpu.atoms import Structure as JaxStructure
from tensoralloy_tpu.calculator import (
    TensorAlloyCalculator as JaxCalculator)
from tensoralloy_tpu.io.model import (load_model as jax_load_model,
                                      save_model as jax_save_model)
from tensoralloy_tpu.nn.atomic import AtomicNN as JaxAtomicNN
from tensoralloy_tpu.nn.fields import make_efs_fn as jax_efs
from tensoralloy_tpu.nn.grap import (
    GenericRadialAtomicPotential as JaxGRAP)
from tensoralloy_tpu.train.manager import (
    TrainingManager as JaxTrainingManager)
from tensoralloy_tpu.transform import Featurizer as JaxFeaturizer
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
from tensoralloy_tpu_torch.io.model import load_model, save_model
from tensoralloy_tpu_torch.nn.atomic import AtomicNN
from tensoralloy_tpu_torch.nn.fields import make_efs_fn
from tensoralloy_tpu_torch.nn.grap import GenericRadialAtomicPotential
from tensoralloy_tpu_torch.train.manager import TrainingManager
from tensoralloy_tpu_torch.transform import Featurizer
from tensoralloy_tpu_torch.utils import tree_flatten

if __name__ == "__main__":      # as a module: its sibling test modules
    sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_host import mo_ni  # noqa: E402
from test_torch_training import _assert_trees_close, _rel  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
ELEMENTS = ["Mo", "Ni"]
RCUT = 4.5
REL = 1e-10
PEXP = {"rl": [1.0, 2.0, 3.0], "pl": [4.0, 3.0, 2.0]}
LEGACY = dict(algorithm="pexp", parameters=PEXP, legacy_mode=True)


def nn_kw(modifier=0, **kw):
    return dict(algorithm="nn", moment_tensors=[0, 1, 2], parameters={
        "num_filters": 4, "hidden_sizes": [8, 8],
        "h_abck_modifier": modifier}, **kw)


def _both(symbols, pos, cell):
    return (JaxStructure.from_symbols(symbols, pos, cell, pbc=[True] * 3),
            Structure.from_symbols(symbols, pos, cell, pbc=[True] * 3))


def flat_features(layout="segment"):
    """The MoNi cell featurized by both packages (padded flat arrays) ->
    (JAX features, port features, vap_element_idx)."""
    js, s = _both(*mo_ni())
    jfz, fz = JaxFeaturizer(ELEMENTS, RCUT), Featurizer(ELEMENTS, RCUT)
    kw = dict(layout=layout, pair_bucket=lambda n: n + 29)
    jfeats = jfz.featurize(js, jfz.make_vap(js), **kw)
    feats = fz.featurize(s, fz.make_vap(s), **kw)
    vei = jfz.vap_element_indices(jfz.make_vap(js))
    return ({k: jnp.asarray(v) for k, v in jfeats.items()},
            {k: torch.as_tensor(v) for k, v in feats.items()}, vei)


def descriptor_pair(kw, seed=0):
    """((JAX descriptor, its parameters), (port descriptor, the same
    parameters as tensors)) of one configuration."""
    jdesc, desc = JaxGRAP(ELEMENTS, **kw), GenericRadialAtomicPotential(
        ELEMENTS, **kw)
    jparams = jdesc.init_params(jax.random.PRNGKey(seed)) or None
    params = None if jparams is None else jax.tree_util.tree_map(
        lambda x: torch.as_tensor(np.array(x)), jparams)
    return (jdesc, jparams), (desc, params)


def model_pair(kw, seed=1, jfz=None, fz=None):
    """A JAX AtomicNN on the descriptor of `kw` with its init parameters
    (biases shifted off zero) and the port's model holding them."""
    jfz = jfz or JaxFeaturizer(ELEMENTS, RCUT)
    fz = fz or Featurizer(ELEMENTS, RCUT)
    occurs = Counter(mo_ni()[0])
    jmodel = JaxAtomicNN(jfz, occurs, JaxGRAP(ELEMENTS, **kw),
                         hidden_sizes=[8, 8])
    params = jmodel.init_params(jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(
        lambda x: x + 0.05 if x.ndim == 1 else x, params)
    model = AtomicNN(fz, occurs, GenericRadialAtomicPotential(ELEMENTS, **kw),
                     hidden_sizes=[8, 8], dtype=torch.float64)
    model.load_param_tree(jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, model


@pytest.mark.parametrize("moments", [[0], [0, 1, 2], [1, 2], [2]])
def test_legacy_widths_and_descriptors_match_jax(moments):
    jfeats, feats, vei = flat_features()
    (jdesc, _), (desc, _) = descriptor_pair(
        dict(LEGACY, moment_tensors=moments))
    width = desc.feature_dim(2, 0, False)
    assert width == jdesc.feature_dim(2, 0, False) == 2 * 3 * len(moments)
    want = jdesc.compute(jfeats, RCUT, 0.0, 2, 0, False,
                         vap_element_idx=vei)
    got = desc.compute(feats, RCUT, 0.0, 2, 0, False, vap_element_idx=vei)
    assert got.shape == (len(vei), width)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=REL,
                               atol=REL)
    beyond = GenericRadialAtomicPotential(
        ELEMENTS, **dict(LEGACY, moment_tensors=[0, 3]))
    with pytest.raises(ValueError, match="moments 0-2"):
        beyond.compute(feats, RCUT, 0.0, 2, 0, False)


MODELS = {
    "legacy": dict(LEGACY, moment_tensors=[0, 1, 2]),
    "nn0_segment": nn_kw(0),
    "nn1_segment": nn_kw(1),
    "nn2_segment": nn_kw(2),
    "nn1_dense": nn_kw(1, backend="dense"),
    "nn2_pallas": nn_kw(2, backend="pallas"),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_models_match_jax(name):
    """E/F/S (autograd w.r.t. positions and cell) of a model on each
    descriptor, at float64; the 'pallas' 'nn' model runs the dense path
    and equals the dense model bit for bit."""
    kw = MODELS[name]
    jfeats, feats, _ = flat_features("both")
    jmodel, params, model = model_pair(kw)
    want = jax.jit(jax_efs(jmodel.energy))(params, jfeats)
    got = make_efs_fn(model.energy_and_aux)(feats)
    for key in ("energy", "forces", "stress"):
        assert _rel(got[key], want[key]) <= REL, key
    assert torch.isfinite(got["forces"]).all()
    if kw.get("backend") == "pallas":
        dense = AtomicNN(model.featurizer, model.max_occurs,
                         GenericRadialAtomicPotential(
                             ELEMENTS, **dict(kw, backend="dense")),
                         hidden_sizes=[8, 8], dtype=torch.float64)
        dense.load_state_dict(model.state_dict())
        twin = make_efs_fn(dense.energy_and_aux)(feats)
        for key in ("energy", "forces", "stress"):
            assert torch.equal(got[key], twin[key]), key


def test_nn_model_file_round_trips_both_ways(tmp_path):
    """A JAX-saved 'nn' model loads in the port with its weights bit for
    bit (the filter under p/descriptor/filters/...) and serves what JAX
    serves; the port's file loads in JAX with the same weights."""
    jmodel, params, _ = model_pair(nn_kw(2))
    jax_file = str(tmp_path / "jax.npz")
    jax_save_model(jax_file, jmodel, params)
    with np.load(jax_file) as z:
        assert "p/descriptor/filters/layers/0/w" in z.files
    model, config = load_model(jax_file, device="cpu")
    got = tree_flatten(model.param_tree())
    want = tree_flatten(jax.tree_util.tree_map(np.asarray, params))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    js, s = _both(*mo_ni(seed=2))
    res = TensorAlloyCalculator(jax_file, device="cpu").calculate(s)
    jcalc = JaxCalculator(jax_file)
    assert _rel(res["energy"], jcalc.get_potential_energy(js)) <= REL
    assert _rel(res["forces"], jcalc.get_forces(js)) <= REL
    assert _rel(res["stress"], jcalc.get_stress(js)) <= REL

    port_file = str(tmp_path / "port.npz")
    save_model(port_file, model)
    _, back, _ = jax_load_model(port_file)
    for key, value in tree_flatten(back).items():
        np.testing.assert_array_equal(np.asarray(value), want[key])


@pytest.mark.parametrize("option", ["legacy", "nn"])
def test_experiment_files_build_and_train_as_in_jax(option, tmp_path):
    """snap_ni_v5_readapt's input.toml with `legacy_mode = true` (moments
    0-2) or `algorithm = 'nn'` (the file's defaults), on a cut database:
    the same model and dataset as the JAX manager, and the same loss and
    gradient norm of a float64 step from the same parameters."""
    from test_torch_manager import cut_config
    overrides = ({"nn.atomic.grap.legacy_mode": True,
                  "nn.atomic.grap.moment_tensors": [0, 1, 2],
                  "nn.atomic.grap.backend": "segment"}
                 if option == "legacy" else
                 {"nn.atomic.grap.algorithm": "nn"})
    config = cut_config("snap_ni_v5_readapt", tmp_path, overrides)
    want = JaxTrainingManager(dict(config, dataset=dict(
        config["dataset"], tfrecords_dir=str(tmp_path / "jax_cache"))))
    got = TrainingManager(config, device="cpu")
    assert got.model.as_dict() == want.model.as_dict()
    assert got.dataset.signature == want.dataset.signature
    desc = got.model.descriptor
    if option == "legacy":
        assert desc.legacy_mode and got.dataset.layout == "segment"
        assert got.model.feature_dim == 16 * 3
    else:
        assert desc.algorithm == "nn" and got.dataset.layout == "dense"
        assert "descriptor" in got.model.param_tree()
    params = want.model.init_params(jax.random.PRNGKey(4))
    feats, labels = got.dataset.build()
    jfeats, jlabels = want.dataset.build()
    sel = slice(0, 4)
    jf = {k: jnp.asarray(v[sel]) for k, v in jfeats.items()}
    jl = {k: jnp.asarray(v[sel]) for k, v in jlabels.items()}
    (want_loss, _), want_grads = jax.jit(jax.value_and_grad(
        want.trainer.total_loss, has_aux=True))(params, jf, jl, 0)
    t = got.trainer
    (loss, _), grads = t.loss_and_grads(
        jax.tree_util.tree_map(lambda x: torch.as_tensor(np.array(x)),
                               params),
        t._to_device({k: v[sel] for k, v in feats.items()}),
        t._to_device({k: v[sel] for k, v in labels.items()}), 0)
    assert _rel(loss, want_loss) <= 1e-8
    _assert_trees_close(grads, want_grads, 1e-8, "gradient")


@pytest.mark.parametrize("name", ["legacy", "nn"])
def test_full_width_fixtures_are_current(name):
    """The committed JAX-saved models at the snap_ni_v5_readapt width
    load in the port, are what the experiment file builds, and serve
    the fixture's float64 E/F/S on the CPU (1e-10) on every backend they
    take, which the card is held against."""
    import chip_smoke
    want = json.loads(chip_smoke.LEGACY_NN_FIXTURE.read_text())[name]
    path = str(ROOT / chip_smoke.LEGACY_NN_FILES[name])
    s, _ = chip_smoke._fixture(chip_smoke.PATHS["grap"][2])
    backends = ["segment"] if name == "legacy" else ["segment", "pallas"]
    for backend in backends:
        res = TensorAlloyCalculator(path, device="cpu",
                                    backend=backend).calculate(s)
        for key in ("energy", "forces", "stress"):
            assert _rel(res[key], want[key]) <= REL, (backend, key)
    model, _ = load_model(path, device="cpu")
    assert model.feature_dim == (16 * 3 if name == "legacy" else 16 * 6)


# ----------------------------------------------------------------------
# the full-width fixtures of chip_smoke's descriptors phase
# ----------------------------------------------------------------------

def _full_width_record(workdir: Path) -> dict:
    """The JAX package on the CPU at float64, at the snap_ni_v5_readapt
    width, for each of `chip_smoke.LEGACY_NN_CONFIGS`: the model with its
    initial weights from a PRNG key and the min/max statistics swept over
    the training set, saved as `chip_smoke.LEGACY_NN_FILES` names it, and
    the numbers the phase compares with (E/F/S of the 108-atom fixture
    cell, the loss and the gradient of the first batch)."""
    import chip_smoke
    from tensoralloy_tpu.train.dataset import batches as jax_batches
    record = {}
    fixture = json.loads((DATA / "torch_port_ref_grap_ni108.json")
                         .read_text())
    js = JaxStructure.from_symbols(["Ni"] * len(fixture["positions"]),
                                   fixture["positions"], fixture["cell"],
                                   pbc=[True] * 3)
    for name, overrides in chip_smoke.LEGACY_NN_CONFIGS.items():
        work = workdir / name
        work.mkdir(parents=True)
        manager = JaxTrainingManager(chip_smoke.experiment_config(
            "snap_ni_v5_readapt", work, {
                "precision": "high", "train.train_steps": 1,
                "train.scan_steps": 1, "train.eval_steps": 10 ** 6,
                "train.log_steps": 10 ** 6, "train.final_f32_steps": 0,
                **overrides}, database=chip_smoke.TRAIN_DB))
        model, trainer, ds = manager.model, manager.trainer, manager.dataset
        feats, labels = ds.build()
        tf_, tl_, _, _ = ds.split(feats, labels)
        params = model.init_params(jax.random.PRNGKey(chip_smoke.SEED))
        for lo in range(0, len(tl_["energy"]), 10):
            params = model.update_norm_stats(params, {
                k: jnp.asarray(v[lo:lo + 10]) for k, v in tf_.items()})
        jax_save_model(str(ROOT / chip_smoke.LEGACY_NN_FILES[name]), model,
                       jax.tree_util.tree_map(np.asarray, params))
        calc = JaxCalculator(model, params)
        tp = manager.train_parameters
        first = next(jax_batches(tf_, tl_, tp.batch_size, seed=tp.seed,
                                 repeat=True))
        (loss, _), grads = jax.jit(jax.value_and_grad(
            trainer.total_loss, has_aux=True))(
                params, {k: jnp.asarray(v) for k, v in first[0].items()},
                {k: jnp.asarray(v) for k, v in first[1].items()}, 0)
        record[name] = {
            "energy": float(calc.get_potential_energy(js)),
            "forces": np.asarray(calc.get_forces(js)).tolist(),
            "stress": np.asarray(calc.get_stress(js)).tolist(),
            "loss_first_step": float(loss),
            "grad_norms": {k: float(np.linalg.norm(np.asarray(v)))
                           for k, v in tree_flatten(grads).items()}}
    return record


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from tensoralloy_tpu import set_precision
    set_precision("high")
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        out = _full_width_record(Path(tmp))
    path = DATA / "torch_port_ref_grap_legacy_nn.json"
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {path}", file=sys.stderr)
