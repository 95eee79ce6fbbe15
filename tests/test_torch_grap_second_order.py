"""Second order of the port's GRAP kernel: the closed form of the VJP's
own VJP (`grap_vjp_bwd_reference`, the plain version of the second-order
kernel) against JAX's second derivatives of `_grap_ref_dense` (`jax.grad`
through `jax.vjp`) and of the interpret-mode custom-VJP op at float64, to
1e-10 of the largest value: here on holes, interleaved slots, a long row
of one slot and a P0 that changes sign across rows, and one
snap_ni_v5_readapt train step at full width against the JAX trainer's
fixture through that route; the four grid algorithms at every cutoff,
moments 0-5 and sets with gaps, masked tails of zero distances and an
empty row in tests/test_torch_grap_second_order_{pexp_sf,density_morse}.py
(files of their own, so that the test runner's workers share them).

On the CPU the wrappers take the closed forms:
`python -m pytest tests/test_torch_grap_second_order*.py -q`.
"""
import functools
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoralloy_tpu.nn.grap import GenericRadialAtomicPotential as JaxGRAP
from tensoralloy_tpu.ops import fused as jax_fused
from tensoralloy_tpu_torch.nn.grap import GenericRadialAtomicPotential
from tensoralloy_tpu_torch.ops import fused

from test_torch_grap import PARAMS
from test_torch_second_order import _close, _jax_second
from test_torch_vjp import LAYOUTS, _laid_out

DATA = Path(__file__).resolve().parent / "data"
# each algorithm's moments: all of 0-5, gaps with and without moment 0,
# symmetric weights
MOMENTS = {"pexp": ([0, 1, 2, 3, 4, 5], False), "sf": ([0, 2, 5], False),
           "morse": ([0, 1, 2, 3], True), "density": ([1, 3], True)}


def _descriptors(algorithm, moments, symmetric, cutoff, params=None):
    kw = dict(algorithm=algorithm, moment_tensors=moments,
              symmetric=symmetric, cutoff_function=cutoff,
              parameters=params or PARAMS[algorithm])
    return (JaxGRAP(["Mo", "Ni"], backend="pallas", **kw),
            GenericRadialAtomicPotential(["Mo", "Ni"], backend="dense", **kw))


def _unit(rng, rij, mask):
    unit = rng.normal(size=(3, *rij.shape))
    unit /= np.linalg.norm(unit, axis=0)
    return [rij, *(unit * mask)]


def _check(jdesc, desc, diff, slot, mask, n_slots=2, seed=7):
    """`grap_vjp_bwd_reference` against JAX (d/dgbar through the op and
    the reference, the geometry terms through the reference) and the
    twin's double autograd; masked entries exactly 0; gbar_bar alone the
    same without the geometry term."""
    ref = functools.partial(jax_fused._grap_ref_dense, jdesc, 4.5, n_slots)
    op = jax_fused._custom_vjp_op(
        functools.partial(jax_fused._grap_pallas, jdesc, 4.5, n_slots), ref,
        4)
    rest = [slot, mask]
    rng = np.random.RandomState(seed)
    shape = ref(*(jnp.asarray(d) for d in diff),
                *(jnp.asarray(r) for r in rest)).shape
    gbar = rng.normal(size=shape)
    vs = [rng.normal(size=d.shape) for d in diff]
    want_gbar, want_x = _jax_second(ref, op, diff, rest, gbar, vs)
    t = torch.as_tensor
    args = (tuple(t(v) for v in vs), t(gbar), *(t(d) for d in diff),
            t(slot), t(mask), desc, 4.5, n_slots)
    got = fused.grap_vjp_bwd_reference(*args)
    x = [t(d).requires_grad_() for d in (gbar, *diff)]
    first = fused._twin_vjp_of(fused.GrapFunction)(
        *x, t(slot), t(mask), desc, 4.5, n_slots)
    twin = torch.autograd.grad(first, x, tuple(t(v) for v in vs))
    assert np.abs(want_gbar).max() > 0 and len(got) == 5
    _close(got[0].numpy(), want_gbar, "gbar_bar")
    _close(got[0].numpy(), twin[0].numpy(), "gbar_bar vs the twin")
    for g, w, tw in zip(got[1:], want_x, twin[1:]):
        assert np.isfinite(w).all()
        assert (g.numpy()[mask <= 0] == 0).all()
        _close(g.numpy(), w, "geometry term")
        _close(g.numpy(), tw.numpy(), "geometry term vs the twin")
    flat = fused.grap_vjp_bwd_reference(*args, geometry=False)
    assert all(f is None for f in flat[1:])
    np.testing.assert_array_equal(flat[0].numpy(), got[0].numpy())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_grap_closed_form_second_order_on_row_layouts(layout):
    """Rows with holes (masked entries between real ones, their geometry
    left in place), interleaved slots, or a long row of one slot; the
    served pexp algorithm at moments with gaps up to 5."""
    rng = np.random.RandomState(47)
    (rij,), slot, mask = _laid_out(rng, layout, 4, 72, 2, 4.5)
    diff = [rij, *_unit(rng, rij, rij > 0)[1:]]
    _check(*_descriptors("pexp", [0, 2, 5], False, "polynomial"), diff,
           slot, mask, seed=8)


def test_grap_closed_form_second_order_where_p0_changes_sign():
    """Morse filters are negative past r0 and positive well inside it:
    rows of short pairs and rows of long ones give P0 of both signs (the
    moment-0 invariant sign(P0) sqrt(Q0), whose curvature goes through
    sign(P0) (Q0 + 1e-16)^(-3/2))."""
    rng = np.random.RandomState(48)
    rows, n = 8, 9
    mask = (rng.uniform(size=(rows, n)) < 0.8).astype(np.float64)
    mask[0] = 0.0
    short = (np.arange(rows) % 2 == 0)[:, None]
    rij = np.where(short, rng.uniform(0.6, 1.4, (rows, n)),
                   rng.uniform(2.8, 4.2, (rows, n))) * mask
    slot = rng.randint(0, 2, (rows, n)).astype(np.float64)
    params = {"D": [1.0, 0.5], "gamma": [1.0, 2.0], "r0": [2.5, 2.0]}
    jdesc, desc = _descriptors("morse", [0, 1, 2], False, "cosine", params)
    diff = _unit(rng, rij, mask)
    p = fused.grap_reference(*(torch.as_tensor(d) for d in diff),
                             torch.as_tensor(slot), torch.as_tensor(mask),
                             desc, 4.5, 2).numpy().reshape(rows, 2, 2, 3)
    p0 = p[..., 0]
    assert (p0 > 0).any() and (p0 < 0).any() and (p0 == 0).any()
    _check(jdesc, desc, diff, slot, mask, seed=9)


def test_snap_ni_v5_readapt_train_step_matches_the_jax_fixture(
        tmp_path, monkeypatch):
    """One float64 train step of snap_ni_v5_readapt at full width (the
    run's input.toml, backend 'pallas', the saved parameters, the first
    batch of 50 structures of snap-Ni.db): the parameter gradient's norm
    equals the JAX trainer's (`tests/data/torch_port_ref_train_grap.json`,
    1e-8), through GRAP's VJP wrapper once (B = 1) and its second-order
    wrapper once, without the geometry term."""
    import chip_smoke
    from tensoralloy_tpu_torch.io.model import load_model
    from tensoralloy_tpu_torch.train.dataset import batch_index_stream
    from tensoralloy_tpu_torch.train.manager import TrainingManager
    from tensoralloy_tpu_torch.train.optim import global_norm
    calls = {"vjp": [], "bwd": []}
    first_order = fused.GrapFunction.kernel_vjp
    second = fused.GrapVjpFunction.kernel_bwd

    def vjp(gbar, *args):
        calls["vjp"].append(gbar.shape[0])
        return first_order(gbar, *args)

    def bwd(*args, geometry=True):
        calls["bwd"].append(geometry)
        return second(*args, geometry=geometry)

    monkeypatch.setattr(fused.GrapFunction, "kernel_vjp", vjp)
    monkeypatch.setattr(fused.GrapVjpFunction, "kernel_bwd", bwd)
    cfg = chip_smoke.TRAIN_CONFIGS["grap"]
    fixture = json.loads((DATA / "torch_port_ref_train_grap.json")
                         .read_text())
    manager = TrainingManager(chip_smoke.experiment_config(
        cfg["run"], tmp_path, {
            "precision": "high", "nn.atomic.grap.backend": "pallas",
            "train.train_steps": 1, "train.scan_steps": 1,
            "train.eval_steps": 10 ** 9, "train.log_steps": 10 ** 9,
            "train.force_assembly": "dense", "train.final_f32_steps": 0},
        database=chip_smoke.TRAIN_DB), device="cpu")
    trainer, ds = manager.trainer, manager.dataset
    arrays = ds.split(*ds.build())
    tp = trainer.train_parameters
    saved, _ = load_model(str(chip_smoke.ROOT / cfg["model"]),
                          dtype="high", device="cpu")
    params = trainer._tree_to_device(saved.param_tree())
    first = next(batch_index_stream(len(arrays[1]["energy"]),
                                    tp.batch_size, seed=tp.seed,
                                    repeat=True))
    bf = trainer._to_device({k: v[first] for k, v in arrays[0].items()})
    bl = trainer._to_device({k: v[first] for k, v in arrays[1].items()})
    (_, _), grads = trainer.loss_and_grads(params, bf, bl, 0)
    norm = float(global_norm(grads))
    want = fixture["grad_norm_first_step"]
    assert fixture["batch_size"] == tp.batch_size == 50
    assert abs(norm - want) <= 1e-8 * want
    assert calls == {"vjp": [1], "bwd": [False]}
