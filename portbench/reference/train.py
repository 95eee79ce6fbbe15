"""Training steps of the plain reference for an atomistic model of one
element: the configuration's descriptors (`reference.family`), energies
and forces of a batch by autograd, the weighted energy-per-atom and
force RMSE loss, its parameter gradient through the forces, Adam with an
exponentially decaying rate, and the EMA of the weights with the ramped
decay min(d, (1 + t) / (10 + t)).

Parameters are a flat dict: "mlp/layers/<l>/{w,b,dt}" and the min-max
statistics "norm/xlo", "norm/xhi", which take no gradient.
"""
from __future__ import annotations

import numpy as np
import torch

from . import family, full_precision, mlp, neighbors


class Structures:
    """The database rows as tensors on `device`, with each row's pairs
    within the cutoff found once."""

    def __init__(self, rows: list, config: dict, device, dtype=torch.float32):
        self.rows, self.config = rows, config
        self.device, self.dtype = device, dtype
        self._pairs = {}

    def pairs(self, k: int):
        if k not in self._pairs:
            row = self.rows[k]
            pos = torch.as_tensor(np.array(row["positions"]),
                                  dtype=self.dtype, device=self.device)
            cell = torch.as_tensor(np.array(row["cell"]), dtype=self.dtype,
                                   device=self.device)
            with full_precision():
                self._pairs[k] = (pos, cell) + neighbors.pairs(
                    pos, cell, self.config["rcut"])
        return self._pairs[k]

    def batch(self, ids):
        """-> positions [n, 3] (a leaf that takes gradients), each atom's
        row of neighbour vectors [n, width, 3] with its mask, and the
        structure of every atom, over rows `ids`."""
        pos, vecs_of, centres, owner, off = [], [], [], [], 0
        for b, k in enumerate(ids):
            p, cell, i, j, shift = self.pairs(int(k))
            pos.append(p)
            vecs_of.append((off, cell, i, j, shift))
            centres.append(i + off)
            owner.append(torch.full((len(p),), b, device=self.device))
            off += len(p)
        positions = torch.cat(pos).requires_grad_(True)
        vec = torch.cat([
            neighbors.vectors(positions, cell, i + o, j + o, shift)
            for o, cell, i, j, shift in vecs_of])
        vec, mask = neighbors.rows(vec, torch.cat(centres), off)
        return positions, vec, mask, torch.cat(owner)

    def labels(self, ids):
        rows = [self.rows[int(k)] for k in ids]

        def t(x):
            return torch.as_tensor(np.array(x), dtype=self.dtype,
                                   device=self.device)
        return {"energy": t([r["energy"] for r in rows]),
                "n_atoms": t([len(r["numbers"]) for r in rows]),
                "forces": t(np.concatenate([r["forces"] for r in rows])),
                "weights": t([r["weights"] for r in rows])}


def layers_of(params: dict):
    layers, li = [], 0
    while f"mlp/layers/{li}/w" in params:
        layer = {k: params[f"mlp/layers/{li}/{k}"] for k in ("w", "b", "dt")
                 if f"mlp/layers/{li}/{k}" in params}
        layers.append(layer)
        li += 1
    return layers


def norm_stats(data: Structures, ids) -> tuple:
    """Min-max statistics over the rows `ids`: the columnwise min of the
    descriptors and 0, the max and 1."""
    lo = hi = None
    descriptors = family(data.config).descriptors
    with torch.no_grad(), full_precision():
        for start in range(0, len(ids), 50):
            chunk = ids[start:start + 50]
            _, vec, mask, _ = data.batch(chunk)
            g = descriptors(vec.detach(), mask, data.config)
            lo = g.amin(0) if lo is None else torch.minimum(lo, g.amin(0))
            hi = g.amax(0) if hi is None else torch.maximum(hi, g.amax(0))
    return torch.clamp(lo, max=0.0), torch.clamp(hi, min=1.0)


def loss_of(params: dict, data: Structures, ids, config: dict):
    """-> the loss of the batch `ids`, differentiable in the weights."""
    positions, vec, mask, owner = data.batch(ids)
    lab = data.labels(ids)
    g = family(data.config).descriptors(vec, mask, data.config)
    x = mlp.scale(g, params["norm/xlo"].detach(), params["norm/xhi"].detach())
    e_atom = mlp.energies(x, layers_of(params))
    energy = e_atom.new_zeros(len(ids)).index_add(0, owner, e_atom)
    (grad,) = torch.autograd.grad(energy.sum(), positions, create_graph=True)
    forces = -grad
    loss = config["loss"]
    de = (lab["energy"] - energy) / lab["n_atoms"]
    we = lab["weights"][:, 0]
    mse_e = torch.sum(we * de * de) / torch.clamp(we.sum(), min=1e-12)
    wf = lab["weights"][:, 1][owner]
    df = lab["forces"] - forces
    mse_f = torch.sum(wf[:, None] * df * df) / (
        torch.clamp(wf.sum(), min=1e-12) * 3.0)
    return (loss["energy_weight"] * torch.sqrt(mse_e + 1e-8)
            + loss["forces_weight"] * torch.sqrt(mse_f + 1e-8))


def learning_rate(opt: dict, count: int) -> float:
    return opt["learning_rate"] * opt["decay_rate"] ** (
        count / opt["decay_steps"])


def start_state(params: dict) -> dict:
    """The optimizer's state before its first step: moments 0, the EMA
    the weights, step 0."""
    return {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()},
            "ema": {k: v.detach().clone() for k, v in params.items()},
            "step": 0}


def steps(params0: dict, data: Structures, batches, config: dict,
          start: dict = None) -> dict:
    """Train from `params0` on the batches of row ids `batches`, one
    step each, from the optimizer state `start` ({"mu", "nu", "ema"} of
    flat dicts and the "step" count; `start_state` where None). -> {
    "losses": [...], "first_grad": {leaf: gradient of the first step},
    "params": the weights after the last step, "ema": their EMA}."""
    opt = config["optimizer"]
    b1, b2, eps = opt["beta1"], opt["beta2"], opt["eps"]
    params = {k: v.detach().clone() for k, v in params0.items()}
    start = start_state(params) if start is None else start
    mu = {k: v.clone() for k, v in start["mu"].items()}
    nu = {k: v.clone() for k, v in start["nu"].items()}
    ema = {k: v.clone() for k, v in start["ema"].items()}
    out = {"losses": []}
    with full_precision():
        for n, ids in enumerate(batches):
            t = int(start["step"]) + n
            leaves = {k: v.detach().requires_grad_(not k.startswith("norm/"))
                      for k, v in params.items()}
            with torch.enable_grad():
                loss = loss_of(leaves, data, ids, config)
                trainable = [k for k in leaves if leaves[k].requires_grad]
                grads = dict(zip(trainable, torch.autograd.grad(
                    loss, [leaves[k] for k in trainable])))
            grads = {k: grads.get(k, torch.zeros_like(v))
                     for k, v in params.items()}
            out["losses"].append(float(loss.detach()))
            if n == 0:
                out["first_grad"] = {k: g.clone() for k, g in grads.items()}
            lr = learning_rate(opt, t)
            for k in params:
                g = grads[k]
                mu[k] = b1 * mu[k] + (1.0 - b1) * g
                nu[k] = b2 * nu[k] + (1.0 - b2) * g * g
                m_hat = mu[k] / (1.0 - b1 ** (t + 1))
                v_hat = nu[k] / (1.0 - b2 ** (t + 1))
                params[k] = params[k] - lr * m_hat / (torch.sqrt(v_hat) + eps)
            decay = min(config["ema_decay"], (1.0 + t) / (10.0 + t))
            ema = {k: decay * ema[k] + (1.0 - decay) * params[k]
                   for k in params}
    out["params"], out["ema"] = params, ema
    return out
