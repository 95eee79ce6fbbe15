"""Learning-rate schedules and optimizer update rules (port of the optax
part of `tensoralloy_tpu/train/trainer.py`: `OptParameters`,
`make_lr_schedule`, `make_optimizer`).

The update rules are plain functions on parameter trees that reproduce
optax 0.2.6 step for step: adam, adamw, nadam, adadelta, rmsprop and
sgd / nesterov, optionally behind `clip_by_global_norm`. `torch.optim` is
not used: its NAdam and RMSprop are other algorithms than optax's.

An optimizer is a pair of functions:

    init(params) -> state
    update(grads, state, params) -> (new params, new state)

`state` is a dict: `count`, the number of updates taken (a host integer:
the schedule and the bias corrections read it without asking the
device), and one tree per slot of the rule (`mu`/`nu`, `trace`,
`e_g`/`e_x`), each shaped like the parameters.

`opt_state_to_flat` / `opt_state_from_flat` write and read the state
under the flat keys that the JAX trainer gives an optax state pytree
(`opt/0/.mu/Ni/mlp/...`, a named-tuple field keeps its dot), so
a checkpoint of either package warm-starts the other's optimizer. Every
slot of every rule is carried; a checkpoint written with another rule
has other slots and leaves the optimizer fresh.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils import tree_flatten, tree_map, tree_unflatten


@dataclasses.dataclass
class OptParameters:
    """The `[opt]` section of an input file."""
    method: str = "adam"
    learning_rate: float = 0.01
    decay_function: Optional[str] = None     # exponential | inverse_time | cosine
    decay_rate: float = 0.95
    decay_steps: int = 1000
    staircase: bool = False
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0
    rho: float = 0.95                         # adadelta
    momentum: float = 0.9                     # rmsprop / sgd
    use_nesterov: bool = True                 # sgd
    clip_norm: float = 0.0


def make_lr_schedule(opt: OptParameters) -> Callable[[int], float]:
    """-> schedule(count) -> learning rate of update number `count`
    (0-based), a host float."""
    lr = float(opt.learning_rate)
    if opt.decay_function in (None, "", "none", False):
        return lambda count: lr
    if opt.decay_function in ("exponential", "natural_exp"):
        # natural_exp: lr * exp(-rate * t / steps), an exponential decay
        # with per-period factor exp(-rate)
        rate = (float(opt.decay_rate) if opt.decay_function == "exponential"
                else float(np.exp(-opt.decay_rate)))
        steps, staircase = opt.decay_steps, opt.staircase
        if steps <= 0 or rate == 0:
            return lambda count: lr

        # float32 arithmetic, as optax computes it on an int32 count: the
        # exponent, the power and the product are rounded to float32.
        # XLA's float32 power is not correctly rounded, so against optax
        # the value can be off by an ulp or two of float32 where the
        # exponent is no integer.
        def exponential(count):
            f32 = np.float32
            if count <= 0:
                return float(f32(lr))
            p = f32(count) / f32(steps)
            if staircase:
                p = np.floor(p)
            power = f32(np.power(np.float64(f32(rate)), np.float64(p)))
            return float(f32(lr) * power)
        return exponential
    if opt.decay_function == "inverse_time":
        # float32 arithmetic, as the JAX package's schedule
        def inverse_time(count):
            t = np.float32(opt.decay_rate) * np.float32(count)
            return float(np.float32(lr) / (np.float32(1.0) + t
                                           / np.float32(opt.decay_steps)))
        return inverse_time
    if opt.decay_function == "cosine":
        steps = float(opt.decay_steps)
        if not steps > 0:
            raise ValueError("the cosine schedule requires positive "
                             f"decay_steps, got {opt.decay_steps}")
        return lambda count: lr * 0.5 * (
            1.0 + math.cos(math.pi * min(float(count), steps) / steps))
    raise ValueError(f"unknown decay_function {opt.decay_function}")


# ----------------------------------------------------------------------
# Update rules. Each takes the flat {path: tensor} gradients, slots and
# parameters and the update number, and returns the step direction `u`
# (the parameters then move by -lr * u) and the new slots. rmsprop is
# the exception: its momentum trace follows the learning rate.
# ----------------------------------------------------------------------

def _moment(g, m, decay: float, order: int):
    return (1.0 - decay) * (g ** order) + decay * m


def _adam(opt, nesterov=False, decoupled_decay=0.0):
    b1, b2, eps = opt.beta1, opt.beta2, 1e-8

    def rule(g, slots, p, count, lr):
        c = count + 1
        mu = {k: _moment(g[k], slots["mu"][k], b1, 1) for k in g}
        nu = {k: _moment(g[k], slots["nu"][k], b2, 2) for k in g}
        c1, c2 = 1.0 - b1 ** c, 1.0 - b2 ** c
        if nesterov:
            c1_next = 1.0 - b1 ** (c + 1)
            mu_hat = {k: b1 * (mu[k] / c1_next) + (1.0 - b1) * (g[k] / c1)
                      for k in g}
        else:
            mu_hat = {k: mu[k] / c1 for k in g}
        u = {k: mu_hat[k] / (torch.sqrt(nu[k] / c2) + eps) for k in g}
        if decoupled_decay:
            u = {k: u[k] + decoupled_decay * p[k] for k in g}
        return ({k: p[k] - lr * u[k] for k in g}, {"mu": mu, "nu": nu})
    return ("mu", "nu"), rule


def _adadelta(opt):
    rho, eps = opt.rho, 1e-6

    def rule(g, slots, p, count, lr):
        e_g = {k: _moment(g[k], slots["e_g"][k], rho, 2) for k in g}
        u = {k: torch.sqrt(slots["e_x"][k] + eps)
             / torch.sqrt(e_g[k] + eps) * g[k] for k in g}
        e_x = {k: _moment(u[k], slots["e_x"][k], rho, 2) for k in g}
        return ({k: p[k] - lr * u[k] for k in g}, {"e_g": e_g, "e_x": e_x})
    return ("e_g", "e_x"), rule


def _rmsprop(opt):
    decay, eps, momentum = 0.9, 1e-8, opt.momentum

    def rule(g, slots, p, count, lr):
        nu = {k: _moment(g[k], slots["nu"][k], decay, 2) for k in g}
        trace = {k: -lr * (torch.rsqrt(nu[k] + eps) * g[k])
                 + momentum * slots["trace"][k] for k in g}
        return ({k: p[k] + trace[k] for k in g}, {"nu": nu, "trace": trace})
    return ("nu", "trace"), rule


def _sgd(opt, nesterov: bool):
    momentum = opt.momentum

    def rule(g, slots, p, count, lr):
        trace = {k: g[k] + momentum * slots["trace"][k] for k in g}
        u = ({k: g[k] + momentum * trace[k] for k in g} if nesterov
             else trace)
        return ({k: p[k] - lr * u[k] for k in g}, {"trace": trace})
    return ("trace",), rule


def _rule(opt: OptParameters):
    method = opt.method.lower()
    if method == "adam":
        return _adam(opt)
    if method == "adamw":
        return _adam(opt, decoupled_decay=opt.weight_decay or 1e-4)
    if method == "nadam":
        return _adam(opt, nesterov=True)
    if method == "adadelta":
        return _adadelta(opt)
    if method == "rmsprop":
        return _rmsprop(opt)
    if method in ("sgd", "nesterov"):
        return _sgd(opt, True if method == "nesterov" else opt.use_nesterov)
    raise ValueError(f"unknown optimizer {opt.method}")


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf."""
    return torch.sqrt(sum(torch.sum(torch.square(x))
                          for x in tree_flatten(tree).values()))


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> Dict[str, torch.Tensor]:
    """Scale the flat gradients to a global norm of `max_norm` where
    theirs is not below it (no host read of the norm)."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return {k: torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm)
            for k, g in grads.items()}


def make_optimizer(opt: OptParameters) -> Tuple[Callable, Callable]:
    """-> (init, update) of the rule `opt.method` names, with its
    schedule and, where `opt.clip_norm` > 0, the global-norm clip in
    front."""
    schedule = make_lr_schedule(opt)
    slot_names, rule = _rule(opt)
    clip = float(opt.clip_norm or 0.0)

    def init(params) -> dict:
        state = {"count": 0}
        for name in slot_names:
            state[name] = tree_map(torch.zeros_like, params)
        return state

    @torch.no_grad()
    def update(grads, state, params):
        g, p = tree_flatten(grads), tree_flatten(params)
        if clip > 0:
            g = clip_by_global_norm(g, clip)
        slots = {name: tree_flatten(state[name]) for name in slot_names}
        count = int(state["count"])
        new_p, new_slots = rule(g, slots, p, count, schedule(count))
        new_state = {"count": count + 1}
        for name, flat in new_slots.items():
            new_state[name] = tree_unflatten(flat)
        return tree_unflatten(new_p), new_state

    return init, update


# ----------------------------------------------------------------------
# The state under an optax state's flat keys. An optax optimizer is a
# chain of transformations, each with its own entry in the state tuple;
# the table gives the entry of each slot and of the update counters. A
# clip in front shifts everything one level down ('opt/1/0/.mu/...').
# ----------------------------------------------------------------------

_OPTAX_ENTRIES = {
    "adam": ({"mu": 0, "nu": 0}, (0, 1)),
    "adamw": ({"mu": 0, "nu": 0}, (0, 2)),
    "adadelta": ({"e_g": 1, "e_x": 1}, (2,)),
    "rmsprop": ({"nu": 0, "trace": 2}, (1,)),
    "sgd": ({"trace": 0}, (1,)),
}


def _optax_family(opt: OptParameters) -> str:
    method = opt.method.lower()
    if method in ("adam", "nadam"):
        return "adam"
    return "sgd" if method == "nesterov" else method


def opt_state_to_flat(state: dict, opt: OptParameters
                      ) -> Dict[str, np.ndarray]:
    """The optimizer state as numpy arrays under the keys that
    flattening the optax state of the same `opt` gives."""
    slots, counters = _OPTAX_ENTRIES[_optax_family(opt)]
    lead = "opt/1/" if opt.clip_norm and opt.clip_norm > 0 else "opt/"
    flat = {f"{lead}{i}/.count": np.asarray(int(state["count"]), np.int32)
            for i in counters}
    for name, entry in slots.items():
        for key, leaf in tree_flatten(state[name]).items():
            flat[f"{lead}{entry}/.{name}/{key}"] = \
                leaf.detach().cpu().numpy()
    return flat


def opt_state_from_flat(flat: Dict[str, np.ndarray], template: dict
                        ) -> Optional[dict]:
    """Read an optimizer state shaped like `template` (a fresh `init`
    state) from a checkpoint's flat `opt/...` keys, whichever package
    wrote them -> the state, or None where the checkpoint lacks a slot
    or a leaf (it was written with another rule or another model)."""
    opt_keys = [k for k in flat if k.startswith("opt/")]
    state = {}
    for name, tree in template.items():
        if name == "count":
            counts = [k for k in opt_keys
                      if re.fullmatch(r"opt/(\d+/)*\.count", k)]
            if not counts:
                return None
            state["count"] = int(flat[counts[0]])
            continue
        leaves = {}
        for key, leaf in tree_flatten(tree).items():
            tail = f"/.{name}/{key}"
            found = [k for k in opt_keys if k.endswith(tail) and
                     re.fullmatch(r"opt/(\d+/)*", k[:len(k) - len(tail) + 1])]
            if not found or flat[found[0]].shape != tuple(leaf.shape):
                return None
            leaves[key] = torch.as_tensor(np.array(flat[found[0]]),
                                          dtype=leaf.dtype,
                                          device=leaf.device)
        state[name] = tree_unflatten(leaves)
    return state
