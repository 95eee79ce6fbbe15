"""The port's update rules and learning-rate schedules against optax, as
the JAX package's trainer builds them (`make_optimizer`,
`make_lr_schedule`): 5 steps on seeded gradients at float64."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensoralloy_tpu.train.trainer import (
    OptParameters as JaxOpt, make_lr_schedule as jax_schedule,
    make_optimizer as jax_optimizer)
from tensoralloy_tpu_torch.train.optim import (
    OptParameters, clip_by_global_norm, global_norm, make_lr_schedule,
    make_optimizer, opt_state_from_flat, opt_state_to_flat)
from tensoralloy_tpu_torch.utils import tree_flatten, tree_map

METHODS = ("adam", "adamw", "nadam", "adadelta", "rmsprop", "sgd",
           "nesterov")
# a staircase of halvings: optax evaluates the exponential schedule in
# float32, where only an integer exponent gives the same bits everywhere
STAIRCASE = dict(decay_function="exponential", decay_rate=0.5,
                 decay_steps=2, staircase=True)


def _tree(rng, scale=1.0):
    return {"Ni": {"mlp": {"layers": [
        {"w": rng.normal(0, scale, (3, 4)), "b": rng.normal(0, scale, 4)},
        {"w": rng.normal(0, scale, (4, 1))}]},
        "norm": {"xlo": rng.normal(0, scale, 3)}}}


def _to_torch(tree):
    return tree_map(lambda x: torch.as_tensor(np.array(x)), tree)


@pytest.mark.parametrize("clip_norm", [0.0, 0.7])
@pytest.mark.parametrize("method", METHODS)
def test_update_rule_matches_optax(method, clip_norm):
    kw = dict(method=method, learning_rate=0.05, clip_norm=clip_norm,
              weight_decay=0.01, momentum=0.8, rho=0.9, beta1=0.85,
              beta2=0.97, use_nesterov=False, **STAIRCASE)
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng, scale=0.5 * (i + 1)) for i in range(5)]
    tx = jax_optimizer(JaxOpt(**kw))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jp)
    init, update = make_optimizer(OptParameters(**kw))
    tp = _to_torch(params)
    state = init(tp)
    for g in grads:
        updates, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                    jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tp, state = update(_to_torch(g), state, tp)
        want = tree_flatten(jp)
        for key, got in tree_flatten(tp).items():
            np.testing.assert_allclose(got.numpy(), np.asarray(want[key]),
                                       rtol=1e-12, atol=1e-12,
                                       err_msg=f"{method} {key}")
    assert state["count"] == 5
    # the state under the JAX trainer's checkpoint keys, and back
    from tensoralloy_tpu.train.trainer import Trainer as JaxTrainer
    jflat = {}
    JaxTrainer._flatten_tree("opt", jstate, jflat)
    flat = opt_state_to_flat(state, OptParameters(**kw))
    assert set(flat) == set(jflat)
    for key, value in jflat.items():
        np.testing.assert_allclose(flat[key], np.asarray(value),
                                   rtol=1e-12, atol=1e-12, err_msg=key)
    back = opt_state_from_flat(jflat, init(tp))
    assert back["count"] == 5
    for name in state:
        if name != "count":
            for key, leaf in tree_flatten(state[name]).items():
                np.testing.assert_allclose(
                    tree_flatten(back[name])[key].numpy(), leaf.numpy(),
                    rtol=1e-12, atol=1e-12)


def test_state_of_another_rule_leaves_the_optimizer_fresh():
    rng = np.random.default_rng(1)
    params = _to_torch(_tree(rng))
    init_sgd, _ = make_optimizer(OptParameters(method="sgd"))
    flat = opt_state_to_flat(init_sgd(params), OptParameters(method="sgd"))
    init_adam, _ = make_optimizer(OptParameters(method="adam"))
    assert opt_state_from_flat(flat, init_adam(params)) is None
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(OptParameters(method="lion"))


SCHEDULES = {
    "constant": (dict(decay_function=None), 1e-12),
    "exponential_staircase": (STAIRCASE, 1e-12),
    # float32 powers of a non-integer exponent: XLA's is not correctly
    # rounded, so the last bits of float32 differ
    "exponential": (dict(decay_function="exponential", decay_rate=0.94,
                         decay_steps=7), 3e-7),
    "natural_exp": (dict(decay_function="natural_exp", decay_rate=0.3,
                         decay_steps=5), 3e-7),
    "inverse_time": (dict(decay_function="inverse_time", decay_rate=0.5,
                          decay_steps=3), 1e-12),
    "cosine": (dict(decay_function="cosine", decay_steps=9), 1e-12),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_optax(name):
    kw, rel = SCHEDULES[name]
    want = jax_schedule(JaxOpt(learning_rate=0.002, **kw))
    got = make_lr_schedule(OptParameters(learning_rate=0.002, **kw))
    for count in list(range(13)) + [1000]:
        w = float(want(jnp.asarray(count, jnp.int32)))
        assert abs(got(count) - w) <= rel * abs(w), (name, count)
    with pytest.raises(ValueError, match="decay_function"):
        make_lr_schedule(OptParameters(decay_function="linear"))


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(2)
    tree = _tree(rng)
    flat = tree_flatten(_to_torch(tree))
    norm = float(global_norm(flat))
    for max_norm in (0.5 * norm, 2.0 * norm):
        want, _ = optax.clip_by_global_norm(max_norm).update(
            jax.tree_util.tree_map(jnp.asarray, tree), optax.EmptyState())
        got = clip_by_global_norm(flat, max_norm)
        for key, value in tree_flatten(want).items():
            np.testing.assert_allclose(got[key].numpy(), np.asarray(value),
                                       rtol=1e-14)
