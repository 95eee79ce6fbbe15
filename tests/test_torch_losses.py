"""The port's loss functions against `tensoralloy_tpu.nn.losses` on
seeded arrays at float64."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoralloy_tpu.nn import losses as JL
from tensoralloy_tpu_torch.nn import losses as L

B, A = 5, 7


@pytest.fixture
def data():
    rng = np.random.default_rng(0)
    masks = np.ones((B, A))
    masks[:, 0] = 0.0
    masks[1, 5:] = 0.0
    masks[3, 3:] = 0.0
    return {
        "scalar": (rng.normal(-50, 5, B), rng.normal(-50, 5, B)),
        "positive": (rng.uniform(0.1, 2, B), rng.uniform(0.1, 2, B)),
        "forces": (rng.normal(0, 2, (B, A, 3)), rng.normal(0, 2, (B, A, 3))),
        "stress": (rng.normal(0, 0.1, (B, 6)), rng.normal(0, 0.1, (B, 6))),
        "masks": masks, "n_atoms": masks.sum(1),
        "weights": rng.uniform(0.2, 2, B),
    }


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-12,
                                   atol=1e-14)


def _both(fn_name, arrays, *args, **kwargs):
    """Call the function of that name in both packages on the arrays
    (None passes through)."""
    conv = lambda f: [None if a is None else f(a) for a in arrays]
    got = getattr(L, fn_name)(*conv(torch.as_tensor), *args[0:1], **kwargs)
    want = getattr(JL, fn_name)(*conv(jnp.asarray), *args[1:2], **kwargs)
    return got, want


WEIGHT_MODES = [(False, False), (True, False), (True, True)]


@pytest.mark.parametrize("weighted,normalized", WEIGHT_MODES)
@pytest.mark.parametrize("per_atom", [False, True])
@pytest.mark.parametrize("method", ["rmse", "logcosh", "ylogy", "rrmse"])
def test_scalar_property_loss(data, method, per_atom, weighted, normalized):
    labels, preds = data["positive" if method == "ylogy" else "scalar"]
    kw = dict(method=method, per_atom_loss=per_atom)
    w = data["weights"] if weighted else None
    t = lambda x: None if x is None else torch.as_tensor(x)
    j = lambda x: None if x is None else jnp.asarray(x)
    got = L.scalar_property_loss(
        t(labels), t(preds), L.LossOptions(**kw), n_atoms=t(data["n_atoms"]),
        sample_weight=t(w), normalized=normalized)
    want = JL.scalar_property_loss(
        j(labels), j(preds), JL.LossOptions(**kw),
        n_atoms=j(data["n_atoms"]), sample_weight=j(w),
        normalized=normalized)
    _close(got, want)


@pytest.mark.parametrize("weighted,normalized", WEIGHT_MODES)
@pytest.mark.parametrize("method", ["rmse", "logcosh"])
def test_forces_loss(data, method, weighted, normalized):
    labels, preds = data["forces"]
    w = data["weights"] if weighted else None
    t = lambda x: None if x is None else torch.as_tensor(x)
    j = lambda x: None if x is None else jnp.asarray(x)
    got = L.forces_loss(t(labels), t(preds), t(data["masks"]),
                        L.LossOptions(method=method), sample_weight=t(w),
                        normalized=normalized)
    want = JL.forces_loss(j(labels), j(preds), j(data["masks"]),
                          JL.LossOptions(method=method), sample_weight=j(w),
                          normalized=normalized)
    _close(got, want)


@pytest.mark.parametrize("weighted,normalized", WEIGHT_MODES)
@pytest.mark.parametrize("method", ["rmse", "logcosh", "rrmse"])
def test_stress_loss(data, method, weighted, normalized):
    labels, preds = data["stress"]
    w = data["weights"] if weighted else None
    t = lambda x: None if x is None else torch.as_tensor(x)
    j = lambda x: None if x is None else jnp.asarray(x)
    got = L.stress_loss(t(labels), t(preds), L.LossOptions(method=method),
                        sample_weight=t(w), normalized=normalized)
    want = JL.stress_loss(j(labels), j(preds),
                          JL.LossOptions(method=method), sample_weight=j(w),
                          normalized=normalized)
    _close(got, want)


@pytest.mark.parametrize("metric", ["fmax", "norm"])
def test_adaptive_sample_weight(data, metric):
    opts = dict(enabled=True, metric=metric, params=(0.7, 3.0, 1.5, 0.05))
    got = L.adaptive_sample_weight(
        torch.as_tensor(data["forces"][0]), torch.as_tensor(data["masks"]),
        torch.as_tensor(data["n_atoms"]),
        L.AdaptiveSampleWeightOptions(**opts))
    want = JL.adaptive_sample_weight(
        jnp.asarray(data["forces"][0]), jnp.asarray(data["masks"]),
        jnp.asarray(data["n_atoms"]), JL.AdaptiveSampleWeightOptions(**opts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


@pytest.mark.parametrize("weight,logscale", [
    (2.5, False), ((1.0, 10.0), False), ((1.0, 10.0), True),
    ([0.5, 0.01], True)])
def test_resolve_weight(weight, logscale):
    for step, max_steps in ((0, 100), (37, 100), (100, 100), (250, 100),
                            (3, 0)):
        got = L.resolve_weight(weight, step, max_steps, logscale)
        want = JL.resolve_weight(weight, jnp.asarray(step, jnp.int32),
                                 max_steps, logscale)
        assert abs(got - float(want)) <= 1e-12 * abs(float(want))


def test_option_defaults_match():
    import dataclasses
    for name in ("LossOptions", "L2LossOptions",
                 "AdaptiveSampleWeightOptions", "LossParameters"):
        got = dataclasses.asdict(getattr(L, name)())
        want = dataclasses.asdict(getattr(JL, name)())
        assert got == want, name
    x = np.linspace(-30, 30, 13)
    np.testing.assert_allclose(L.logcosh(torch.as_tensor(x)).numpy(),
                               np.asarray(JL.logcosh(jnp.asarray(x))),
                               rtol=1e-13, atol=1e-15)
