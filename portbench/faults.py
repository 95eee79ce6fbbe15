"""Faults planted in the program underneath a run, to show that the
comparison that decides `correct` catches them and to read the numbers
they give: a step that returns its state unchanged, half of the batch
left out with the mean taken over the rest, and an answer altered where
it is produced; and, for training, the optimizer's step count left
where it was after the first `checked_steps` steps (the rate's decay and
Adam's bias correction stop there), which the first steps' comparison
cannot see. One chip, so no exchange between chips to leave out.

`plant(kind, name)` patches the program's class for the life of the
process and returns a function that takes the patch out again. Neither
the benchmark's runs nor the program use this module; the tests and
`readings.py` do.
"""
from __future__ import annotations

FAULTS = {"md": ("state_unchanged", "answer_altered"),
          "train": ("state_unchanged", "half_batch", "answer_altered",
                    "count_stuck")}
# the count that `count_stuck` keeps: the traffic's checked steps (3)
LATE_STEP = 3


def _md_state_unchanged(orig):
    def chunk(self, feats, pos, vel, cell, n):
        out = orig(self, feats, pos, vel, cell, n)
        return (pos, vel, cell) + tuple(out[3:])
    return chunk


def _md_answer_altered(orig):
    """One atom's force pushed by 0.05 eV/A along x at every step."""
    def forces(self, feats, pos, cell):
        f, p_pot = orig(self, feats, pos, cell)
        push = f.new_zeros(f.shape)
        push[1, 0] = 0.05
        return f + push, p_pot
    return forces


def _train_state_unchanged(orig):
    def step(self, state, feats, labels):
        _, metrics = orig(self, state, feats, labels)
        return state, metrics
    return step


def _train_half_batch(orig):
    def loss_and_grads(self, params, feats, labels, step):
        h = labels["energy"].shape[0] // 2
        return orig(self, params, {k: v[:h] for k, v in feats.items()},
                    {k: v[:h] for k, v in labels.items()}, step)
    return loss_and_grads


def _train_answer_altered(orig):
    """The step's answer, the updated weights, altered in one entry."""
    def step(self, state, feats, labels):
        state, metrics = orig(self, state, feats, labels)
        element = next(iter(state["params"]))
        layer = state["params"][element]["mlp"]["layers"][1]
        layer["b"] = layer["b"].clone()
        layer["b"][0] += 0.01
        return state, metrics
    return step


def _train_count_stuck(orig):
    """The optimizer's count carried to the next step held at LATE_STEP:
    from then on every step takes the rate and the bias correction of
    step LATE_STEP."""
    def step(self, state, feats, labels):
        state, metrics = orig(self, state, feats, labels)
        opt = state["opt_state"]
        if int(opt["count"]) > LATE_STEP:
            state = dict(state, opt_state=dict(opt, count=LATE_STEP))
        return state, metrics
    return step


_PATCHES = {
    ("md", "state_unchanged"): ("_chunk", _md_state_unchanged),
    ("md", "answer_altered"): ("_forces", _md_answer_altered),
    ("train", "state_unchanged"): ("train_step", _train_state_unchanged),
    ("train", "half_batch"): ("loss_and_grads", _train_half_batch),
    ("train", "answer_altered"): ("train_step", _train_answer_altered),
    ("train", "count_stuck"): ("train_step", _train_count_stuck),
}


def plant(kind: str, name: str):
    """Break the program's class that the driver `kind` runs with the
    fault `name`. -> a function that mends it."""
    if kind == "md":
        from tensoralloy_tpu_torch.dynamics import VelocityVerlet as cls
    else:
        from tensoralloy_tpu_torch.train.trainer import Trainer as cls
    attr, wrap = _PATCHES[(kind, name)]
    orig = getattr(cls, attr)
    setattr(cls, attr, wrap(orig))

    def mend():
        setattr(cls, attr, orig)
    return mend
