"""Smooth cutoff functions (port of `tensoralloy_tpu/ops/cutoffs.py`).

Plain functions of torch tensors; shapes broadcast. The CUDA kernels in
`csrc/sf_kernels.cu` carry the same five forms, selected by
`CUTOFF_IDS`.
"""
from __future__ import annotations

import math

import torch


def cosine_cutoff(r, rc):
    """Behler cosine cutoff: 0.5 (cos(pi min(r/rc, 1)) + 1)."""
    z = torch.clamp(r / rc, max=1.0)
    return 0.5 * (torch.cos(z * math.pi) + 1.0)


def polynomial_cutoff(r, rc, gamma: float = 5.0):
    """Peterson polynomial cutoff:
    1 + g (r/rc)^(g+1) - (g+1)(r/rc)^g, clamped at r = rc."""
    z = torch.clamp(r / rc, max=1.0)
    return 1.0 + gamma * z ** (gamma + 1.0) - (gamma + 1.0) * z ** gamma


def meam_cutoff(x):
    """MEAM cutoff of the *scaled* coordinate x in [0, 1]."""
    x = torch.clamp(x, 0.0, 1.0)
    return torch.square(1.0 - (1.0 - x) ** 4)


def deepmd_cutoff(r, rc, rcs):
    """DeePMD switching: 1/r inside rcs, smooth cosine decay to rc."""
    z = torch.clamp((r - rcs) / (rc - rcs), 0.0, 1.0)
    positive = r > 0
    recip = torch.where(positive, 1.0 / torch.where(positive, r, 1.0), 0.0)
    return recip * (0.5 * torch.cos(math.pi * z) + 0.5)


def tersoff_cutoff(r, R, D):
    """Tersoff cutoff: 1 for r<R-D, 0 for r>R+D, sine ramp between."""
    z = torch.clamp((r - R) / D, -1.0, 1.0)
    return 0.5 - 0.5 * torch.sin(0.5 * math.pi * z)


def meam_radial_cutoff(r, rc, delta=None):
    """MEAM cutoff as a radial function: fc((rc - r)/delta), with the
    smoothing window `delta` defaulting to the full range rc."""
    d = rc if delta is None else delta
    return meam_cutoff((rc - r) / d)


def deepmd_radial_cutoff(r, rc, rcs=None):
    """DeePMD switching with rcs defaulting to 2/3 rc."""
    return deepmd_cutoff(r, rc, (2.0 / 3.0) * rc if rcs is None else rcs)


def tersoff_radial_cutoff(r, rc, d_frac=0.1):
    """Tersoff cutoff pinned so f == 0 exactly at r = rc:
    R = rc - D with half-width D = d_frac * rc."""
    D = d_frac * rc
    return tersoff_cutoff(r, rc - D, D)


# Registry keyed by the `cutoff_function` option.
CUTOFFS = {
    "cosine": cosine_cutoff,
    "polynomial": polynomial_cutoff,
    "meam": meam_radial_cutoff,
    "deepmd": deepmd_radial_cutoff,
    "tersoff": tersoff_radial_cutoff,
}

# The id each cutoff has in the CUDA kernels (`cutoff_value` in
# csrc/sf_kernels.cu), with the default keyword values above.
CUTOFF_IDS = {name: i for i, name in enumerate(CUTOFFS)}


def apply_cutoff(name: str, r, rc, **kwargs):
    return CUTOFFS[name](r, rc, **kwargs)


def cutoff_and_slope(name: str, r, rc):
    """-> (fc(r), dfc/dr) of a registered cutoff with its default
    keywords, the slope written out (the closed-form VJPs of
    `ops.fused` and `cutoff_slope` in csrc/common.cuh). A clamped
    argument has slope 0 outside its open interval."""
    fc = apply_cutoff(name, r, rc)
    zero = torch.zeros_like(r)
    if name == "cosine":
        z = r / rc
        slope = -0.5 * math.pi / rc * torch.sin(math.pi * z)
        return fc, torch.where(z < 1.0, slope, zero)
    if name == "polynomial":
        z = r / rc
        slope = 30.0 / rc * (z ** 5 - z ** 4)
        return fc, torch.where(z < 1.0, slope, zero)
    if name == "meam":
        x = (rc - r) / rc
        w = (1.0 - x) ** 3
        slope = -8.0 / rc * (1.0 - w * (1.0 - x)) * w
        return fc, torch.where((x > 0.0) & (x < 1.0), slope, zero)
    if name == "deepmd":
        rcs = (2.0 / 3.0) * rc
        z = (r - rcs) / (rc - rcs)
        zc = torch.clamp(z, 0.0, 1.0)
        positive = r > 0
        recip = torch.where(positive, 1.0 / torch.where(positive, r, 1.0),
                            0.0)
        ramp = torch.where((z > 0.0) & (z < 1.0),
                           -0.5 * math.pi / (rc - rcs)
                           * torch.sin(math.pi * zc), zero)
        slope = (-recip * recip * (0.5 * torch.cos(math.pi * zc) + 0.5)
                 + recip * ramp)
        return fc, slope
    if name == "tersoff":
        d = 0.1 * rc
        z = (r - (rc - d)) / d
        slope = -0.25 * math.pi / d * torch.cos(0.5 * math.pi * z)
        return fc, torch.where((z > -1.0) & (z < 1.0), slope, zero)
    raise KeyError(name)


def clamp_weight(z, lo=None, hi=None):
    """JAX's derivative of the clamp of `z` to [lo, hi] (a bound None is
    no bound), as jnp.minimum / jnp.maximum give it: 1 inside the open
    interval, 1/2 at a bound (a tie passes half the gradient to each
    side), 0 outside. `z` must be formed as JAX forms it (r / rc, a
    division), so that it meets a bound where JAX's does."""
    inside = torch.ones_like(z, dtype=torch.bool)
    tie = torch.zeros_like(inside)
    if lo is not None:
        inside = inside & (z > lo)
        tie = tie | (z == lo)
    if hi is not None:
        inside = inside & (z < hi)
        tie = tie | (z == hi)
    return torch.where(inside, 1.0, torch.where(tie, 0.5, 0.0)).to(z.dtype)


def cutoff_slope_and_curvature(name: str, r, rc):
    """-> (fc(r), dfc/dr, d2fc/dr2) of a registered cutoff with its
    default keywords, written out (the second-order closed forms of
    `ops.fused` and `cutoff_curvature` in csrc/common.cuh). The value and
    slope are `cutoff_and_slope`'s. The curvature is JAX's
    `jax.grad(jax.grad(apply_cutoff))` also at the knots, where a clamped
    argument z meets a bound: a clamp's derivative w is 1 inside its
    open interval, 1/2 at the bound and 0 outside (`clamp_weight`), so
    the clamp's part of the curvature, the function's own second
    derivative times z'^2, takes w^2 (1/4 at a knot), its part through
    the slope (deepmd's ramp times 1/r') takes w, and a part outside the
    clamp (deepmd's 1/r) stays whole."""
    fc, slope = cutoff_and_slope(name, r, rc)
    if name == "cosine":
        z = r / rc
        w = clamp_weight(z, hi=1.0)
        curv = -0.5 * (math.pi / rc) ** 2 * torch.cos(
            math.pi * torch.clamp(z, max=1.0))
        return fc, slope, w * w * curv
    if name == "polynomial":
        z = r / rc
        w = clamp_weight(z, hi=1.0)
        zc = torch.clamp(z, max=1.0)
        curv = (150.0 * zc ** 4 - 120.0 * zc ** 3) / (rc * rc)
        return fc, slope, w * w * curv
    if name == "meam":
        x = (rc - r) / rc
        w = clamp_weight(x, 0.0, 1.0)
        u2 = (1.0 - torch.clamp(x, 0.0, 1.0)) ** 2
        curv = 8.0 / (rc * rc) * (7.0 * u2 * u2 * u2 - 3.0 * u2)
        return fc, slope, w * w * curv
    if name == "deepmd":
        rcs = (2.0 / 3.0) * rc
        om = math.pi / (rc - rcs)
        z = (r - rcs) / (rc - rcs)
        zc = torch.clamp(z, 0.0, 1.0)
        w = clamp_weight(z, 0.0, 1.0)
        positive = r > 0
        recip = torch.where(positive, 1.0 / torch.where(positive, r, 1.0),
                            0.0)
        s = 0.5 * torch.cos(math.pi * zc) + 0.5
        ramp = w * (-0.5 * om * torch.sin(math.pi * zc))
        bend = w * w * (-0.5 * om * om * torch.cos(math.pi * zc))
        curv = (2.0 * s * recip - 2.0 * ramp) * recip * recip + bend * recip
        return fc, slope, curv
    if name == "tersoff":
        d = 0.1 * rc
        z = (r - (rc - d)) / d
        w = clamp_weight(z, -1.0, 1.0)
        curv = 0.125 * (math.pi / d) ** 2 * torch.sin(
            0.5 * math.pi * torch.clamp(z, -1.0, 1.0))
        return fc, slope, w * w * curv
    raise KeyError(name)
