"""Training losses (port of `tensoralloy_tpu/nn/losses.py`).

All functions are pure: ``loss(labels, predictions, ...) -> (loss, mae)``
with tensors; dynamic loss weights interpolate w0 -> w1 (linear or
log10) over `max_train_steps` given the current step.

Loss methods: rmse (sqrt of mse + eps), rrmse (mean row-norm ratio),
logcosh, ylogy (y (log y - log p)^2 — used for entropy heads).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple, Union

import math

import numpy as np

import torch

from .layers import softplus


Weight = Union[float, Tuple[float, float], Sequence[float]]


@dataclasses.dataclass(frozen=True)
class LossOptions:
    weight: Weight = 1.0
    method: str = "rmse"
    per_atom_loss: bool = False
    logscaled_dynamic_weight: bool = False


@dataclasses.dataclass(frozen=True)
class L2LossOptions:
    weight: float = 0.0
    decayed: bool = True
    decay_rate: float = 0.99
    decay_steps: int = 1000


@dataclasses.dataclass(frozen=True)
class AdaptiveSampleWeightOptions:
    enabled: bool = False
    metric: str = "fmax"          # 'fmax' | 'norm'
    method: str = "sigmoid"
    params: Sequence[float] = (1.0, 5.0, 1.0, 0.1)  # slope, center, wmax, wmin
    normalized: bool = True


@dataclasses.dataclass(frozen=True)
class LossParameters:
    energy: LossOptions = LossOptions(weight=1.0, per_atom_loss=False)
    forces: LossOptions = LossOptions(weight=1.0)
    stress: LossOptions = LossOptions(weight=1.0)
    total_pressure: LossOptions = LossOptions(weight=0.0)
    eentropy: LossOptions = LossOptions(weight=0.0, method="ylogy")
    free_energy: LossOptions = LossOptions(weight=0.0)
    l2: L2LossOptions = L2LossOptions()
    adaptive_sample_weight: AdaptiveSampleWeightOptions = \
        AdaptiveSampleWeightOptions()


def resolve_weight(weight: Weight, step, max_train_steps,
                   logscale: bool = False):
    """Static scalar or (w0, w1) interpolated over training."""
    if isinstance(weight, (int, float)):
        return float(weight)
    w0, w1 = float(weight[0]), float(weight[1])
    # the step is a host integer here. The arithmetic follows the JAX
    # package, where the step is a float32 scalar: the linear ramp stays
    # in float32, the log ramp is promoted by its float64 logarithms
    t = np.clip(np.float32(step) /
                np.float32(max(float(max_train_steps or 1), 1.0)),
                np.float32(0.0), np.float32(1.0))
    if logscale:
        l0, l1 = math.log10(w0), math.log10(w1)
        return float(10.0 ** (l0 + (l1 - l0) * float(t)))
    return float(np.float32(w0) + np.float32(w1 - w0) * t)


def _eps(x) -> float:
    return 1e-14 if x.dtype == torch.float64 else 1e-8


def _weighted_mean_sq(diff, sample_weight, normalized):
    if sample_weight is None:
        return torch.mean(torch.square(diff))
    w = sample_weight
    while w.dim() < diff.dim():
        w = w[..., None]
    if normalized:
        denom = torch.clamp(torch.sum(sample_weight), min=1e-12)
        scl = 1.0
        for d in diff.shape[1:]:
            scl *= d
        w = w / (denom * scl)
        return torch.sum(torch.square(diff) * w)
    return torch.mean(torch.square(diff) * w)


def logcosh(x):
    return x + softplus(-2.0 * x) - math.log(2.0)


def rmse_loss(labels, predictions, sample_weight=None, normalized=False):
    diff = labels - predictions
    mae = torch.mean(torch.abs(diff))
    mse = _weighted_mean_sq(diff, sample_weight, normalized)
    return torch.sqrt(mse + _eps(diff)), mae


def rrmse_loss(labels, predictions, sample_weight=None):
    """Mean per-structure relative row-norm error: the right objective
    when label magnitudes span
    decades (e.g. +-60 GPa strained frames next to ~0.5 GPa
    equilibrium ones — an absolute loss optimizes only the big rows).
    `sample_weight` masks structures out entirely (has_stress): a
    frame without labels must not contribute a |pred|/eps blow-up."""
    if labels.dim() == 1:
        labels = labels[:, None]
        predictions = predictions[:, None]
    # eps inside the sqrt keeps the gradient finite at diff == 0
    upper = torch.sqrt(torch.sum(torch.square(labels - predictions), dim=1)
                     + 1e-14)
    lower = torch.clamp(torch.linalg.norm(labels, dim=1), min=1e-12)
    ratio = upper / lower
    adiff = torch.abs(labels - predictions)
    if sample_weight is not None:
        w = sample_weight
        wsum = torch.clamp(torch.sum(w), min=1e-12)
        return (torch.sum(ratio * w) / wsum,
                torch.sum(adiff * w[:, None]) / (wsum * labels.shape[1]))
    return torch.mean(ratio), torch.mean(adiff)


def logcosh_loss(labels, predictions, sample_weight=None, normalized=False):
    diff = labels - predictions
    mae = torch.mean(torch.abs(diff))
    v = logcosh(diff)
    if sample_weight is not None:
        w = sample_weight
        while w.dim() < v.dim():
            w = w[..., None]
        if normalized:
            w = w / torch.clamp(torch.sum(sample_weight), min=1e-12)
        return torch.sum(v * w), mae
    return torch.mean(v), mae


def ylogy_loss(labels, predictions, sample_weight=None, normalized=False):
    eps = 1e-12
    logx = torch.log(torch.clamp(labels, min=eps))
    logy = torch.log(torch.clamp(predictions, min=eps))
    v = torch.square(logx - logy) * labels
    mae = torch.mean(torch.abs(labels - predictions))
    if sample_weight is not None:
        w = sample_weight
        while w.dim() < v.dim():
            w = w[..., None]
        if normalized:
            w = w / torch.clamp(torch.sum(sample_weight), min=1e-12)
        return torch.sum(v * w), mae
    return torch.mean(v), mae


_METHODS = {"rmse": rmse_loss, "logcosh": logcosh_loss, "ylogy": ylogy_loss}


def scalar_property_loss(labels, predictions, options: LossOptions,
                         n_atoms=None, sample_weight=None,
                         normalized=False):
    """Energy-style loss on [batch] scalars, optional per-atom scaling."""
    if options.per_atom_loss and n_atoms is not None:
        labels = labels / n_atoms
        predictions = predictions / n_atoms
    if options.method == "rrmse":
        return rrmse_loss(labels, predictions, sample_weight)
    return _METHODS[options.method](labels, predictions, sample_weight,
                                    normalized)


def forces_loss(labels, predictions, atom_masks, options: LossOptions,
                sample_weight=None, normalized=True):
    """Masked forces loss on [batch, n_vap, 3] arrays.

    The virtual-atom row is dropped, padding rows are zeroed and the
    mean runs over real entries only.
    """
    mask = atom_masks[:, 1:]                       # drop virtual atom
    diff = (labels[:, 1:] - predictions[:, 1:]) * mask[..., None]
    n_real = torch.clamp(torch.sum(mask) * 3.0, min=1.0)
    mae = torch.sum(torch.abs(diff)) / n_real
    if sample_weight is not None:
        w = sample_weight[:, None, None] * mask[..., None]
        if normalized:
            w = w / (torch.clamp(torch.sum(w), min=1e-12) * 3.0)
        val = torch.sum(torch.square(diff) * w)
    else:
        val = torch.sum(torch.square(diff)) / n_real
    if options.method == "logcosh":
        if sample_weight is not None:
            w = sample_weight[:, None, None] * mask[..., None]
            # w is per-atom but logcosh(diff) has 3 components per
            # atom: normalize by 3*sum(w) like the rmse branch, so
            # enabling sample weights does not rescale the loss 3x
            if normalized:
                w = w / (torch.clamp(torch.sum(w), min=1e-12) * 3.0)
            return torch.sum(logcosh(diff) * w), mae
        return torch.sum(logcosh(diff)) / n_real, mae
    return torch.sqrt(val + _eps(diff)), mae


def stress_loss(labels, predictions, options: LossOptions,
                sample_weight=None, normalized=False):
    if options.method == "rrmse":
        return rrmse_loss(labels, predictions, sample_weight)
    return _METHODS[options.method](labels, predictions, sample_weight,
                                    normalized)


def adaptive_sample_weight(true_forces, atom_masks, n_atoms,
                           options: AdaptiveSampleWeightOptions):
    """Sigmoid down-weighting of high-force structures."""
    f = true_forces[:, 1:] * atom_masks[:, 1:, None]
    if options.metric == "norm":
        v = torch.sqrt(torch.sum(torch.square(f), dim=(1, 2)) /
                       torch.clamp(n_atoms, min=1.0))
    else:  # fmax
        v = torch.amax(torch.abs(f), dim=(1, 2))
    slope, center, wmax, wmin = options.params
    return torch.sigmoid(slope * (center - v)) * wmax + wmin
