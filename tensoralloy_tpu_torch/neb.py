"""Nudged elastic band (NEB) on the model's device (port of
`tensoralloy_tpu/neb.py`).

The band's replicas are one batch: every image is featurized on the host
with a skin margin, the features are stacked along a leading replica
axis ([M, A, ...], the trainer's batch layout), and one evaluation of the
model gives every replica's energy and forces. A descriptor model thus
launches each of its descriptor kernels once per band evaluation, on
M * A rows. The FIRE damped-dynamics optimizer runs as a plain loop on
the device with its step size, mixing and counter held as device
scalars, so the host reads nothing inside a chunk; between chunks it
rebuilds the (skinned) neighbor lists.

With `n_shards` ranks of a `torch.distributed` group, each rank
evaluates its contiguous block of M / n_shards replicas and the band's
energies [M] and forces [M, A, 3] are gathered; the tangents, springs
and FIRE then run replicated and identical on every rank, so the
tangents across a block's edges need no halo.

Implements the improved tangent estimate and the climbing-image method
(Henkelman & Jonsson, J. Chem. Phys. 113, 9901/9978 (2000)).

Units follow the rest of the package: A, eV, eV/A.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

import numpy as np
import torch

from .atoms import Structure, minimum_image
from .dynamics import _model_factory

# FIRE (Bitzek et al., PRL 97, 170201): the JAX package's constants
F_INC, F_DEC, ALPHA0, F_ALPHA = 1.1, 0.5, 0.1, 0.99
N_MIN, DT_MAX, MAXSTEP = 5, 0.25, 0.2


def interpolate_band(initial: Structure, final: Structure,
                     n_images: int) -> np.ndarray:
    """[M, N, 3] linear path (minimum-image) incl. both endpoints."""
    if list(initial.symbols) != list(final.symbols):
        raise ValueError("initial/final stoichiometry-order mismatch")
    d = minimum_image(final.positions - initial.positions, initial.cell)
    s = np.linspace(0.0, 1.0, n_images)[:, None, None]
    return initial.positions[None] + s * d[None]


def _pad(n: int) -> int:
    return max(64, 1 << int(np.ceil(np.log2(max(n, 1)))))


def _wpad(n: int) -> int:
    return max(32, 1 << int(np.ceil(np.log2(max(n, 1)))))


class NEB:
    """Nudged-elastic-band barrier search with a trained model, on the
    model's device and in its dtype (the JAX class without `params`: the
    weights are the module's).

    Parameters
    ----------
    model : any model of the port (AtomicNN, the EAM family, the
        finite-temperature models, a wrapper such as `analysis.ti.
        LambdaMix`).
    initial, final : endpoint `Structure`s (same cell, same symbol
        order; pre-relax them first).
    n_images : total replicas including the two fixed endpoints.
    k : spring constant (eV/A^2) between adjacent replicas.
    climb : turn the highest interior replica into a climbing image
        (no spring; tangential true force inverted) so it converges
        onto the saddle point.
    skin : margin (A) added to the cutoff of the lists a chunk reuses.
    chunk_size : FIRE steps between two rebuilds of the lists.
    n_shards : the replicas split over this many ranks of the current
        `torch.distributed` group (the reference's LAMMPS `-partition`
        analog; module docstring). `n_images` must be divisible by it,
        and the group must have that many ranks (ValueError otherwise).
    """

    def __init__(self, model, initial: Structure, final: Structure,
                 n_images: int = 9, k: float = 5.0, climb: bool = True,
                 skin: float = 0.5, chunk_size: int = 25,
                 n_shards: int = 1):
        if n_images < 3:
            raise ValueError("need at least 3 images")
        from .parallel.mesh import group_size, make_mesh
        if n_shards > 1:
            if n_images % n_shards:
                raise ValueError(
                    f"n_images={n_images} not divisible by "
                    f"n_shards={n_shards}")
            if n_shards > group_size():
                raise ValueError(
                    f"n_shards={n_shards} > {group_size()} available "
                    "devices")
        self.mesh = make_mesh(n_shards, axis_name="rep")
        from .calculator import is_eam_family, model_feature_layout
        self.k = float(k)
        self.climb = bool(climb)
        self.skin = float(skin)
        self.chunk_size = int(chunk_size)
        self.cell = initial.cell.copy()
        self.template = initial.copy()

        # a band relaxes geometry only
        model.requires_grad_(False)
        self.model = model.clone_for(Counter(initial.symbols))
        self.device, self.dtype = _model_factory(self.model)
        # EAM-family bands evaluate through the analytic EFS
        # (`nn/eam/fast_efs.py`), one image at a time; everything else by
        # autograd of the batched variational energy
        self._use_fast_efs = is_eam_family(self.model)
        self._fast_fn = None
        if self._use_fast_efs:
            from .nn.eam.fast_efs import make_fast_efs_fn
            self._fast_fn = make_fast_efs_fn(self.model)
        self.layout = model_feature_layout(self.model,
                                           fast=self._use_fast_efs)
        self.fz = model.featurizer
        self.vap = self.fz.make_vap(initial, Counter(initial.symbols))

        # [M, N, 3] local-order path
        self.positions = interpolate_band(initial, final, n_images)
        self.n_images = n_images
        self.energies: Optional[np.ndarray] = None
        # band evaluations (FIRE steps and chunk-end / fresh-list
        # evaluations) over this object's runs
        self.n_evaluations = 0
        m = n_images
        move = np.ones((m, 1, 1))
        move[0] = move[-1] = 0.0
        self._move = self._tensor(move)
        self._cell = self._tensor(self.cell)
        self._inv_cell = self._tensor(np.linalg.inv(self.cell))

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                               device=self.device)

    # ------------------------------------------------------------------
    def _featurize_band(self):
        """Stack per-image features along a leading replica axis."""
        np_dtype = np.float64 if self.dtype == torch.float64 \
            else np.float32
        old_rcut = self.fz.rcut

        def featurize_all(**kwargs):
            out = []
            for m in range(self.n_images):
                s = self.template.copy()
                s.positions = self.positions[m]
                out.append(self.fz.featurize(s, self.vap, dtype=np_dtype,
                                             layout=self.layout, **kwargs))
            return out

        try:
            self.fz.rcut = old_rcut + self.skin
            per_image = featurize_all(pair_bucket=_pad, nnl_bucket=_wpad,
                                      ntl_bucket=_wpad)
            keys = per_image[0].keys()
            shapes = {k: tuple(np.maximum.reduce(
                [np.asarray(f[k]).shape for f in per_image]))
                for k in keys if np.asarray(per_image[0][k]).ndim}
            if any(np.asarray(f[k]).shape != shapes[k]
                   for f in per_image for k in shapes):
                # replicas fell in different buckets: refeaturize against
                # the band-wide maxima so that the stack is regular
                maxima = {}
                if "pair_mask" in shapes:
                    maxima["nij_max"] = shapes["pair_mask"][0]
                if "pair_mask_d" in shapes:
                    maxima["nnl_max"] = shapes["pair_mask_d"][1]
                if "trip_mask_d" in shapes:
                    maxima["ntl_max"] = shapes["trip_mask_d"][1]
                per_image = featurize_all(**maxima)
        finally:
            self.fz.rcut = old_rcut
        return {k: torch.as_tensor(np.stack([np.asarray(f[k])
                                             for f in per_image]),
                                   device=self.device)
                for k in per_image[0].keys()}

    # ------------------------------------------------------------------
    def _energy_forces(self, feats, pos):
        """-> (energies [M], forces [M, A, 3]) of every replica: this
        rank's block evaluated, the band gathered (the whole band on one
        rank)."""
        from .parallel.collectives import all_gather
        self.n_evaluations += 1
        block = self.mesh.block(self.n_images)
        e, f = self._evaluate({k: v[block] for k, v in feats.items()},
                              pos[block])
        return all_gather(e, self.mesh), all_gather(f, self.mesh)

    def _evaluate(self, feats, pos):
        """(energies, forces) of the replicas of `feats` and `pos`."""
        mask = feats["atom_masks"][..., None]
        if self._fast_fn is not None:
            outs = [self._fast_fn({k: v[m] for k, v in feats.items()}
                                  | {"positions": pos[m]})
                    for m in range(pos.shape[0])]
            e = torch.stack([o["energy"] for o in outs])
            f = torch.stack([o["forces"] for o in outs])
            return e, f * mask
        with torch.enable_grad():
            p = pos.detach().requires_grad_()
            e = self.model.variational_energy(dict(feats, positions=p))
            g, = torch.autograd.grad(e.sum(), p)
        return e.detach(), -g * mask

    def _mic(self, d):
        frac = d @ self._inv_cell
        return (frac - torch.round(frac)) @ self._cell

    def _band_force(self, feats, pos):
        """NEB effective force on every replica ([M, A, 3])."""
        e, f = self._energy_forces(feats, pos)
        mask = feats["atom_masks"][..., None]
        # displacements to the next/previous replica (real atoms)
        d_next = self._mic(pos[1:] - pos[:-1]) * mask[:-1]      # [M-1]

        def dot(a, b):
            return torch.sum(a * b, dim=(-2, -1))

        def norm(a):
            return torch.sqrt(dot(a, a) + 1e-32)

        # improved tangent (Henkelman-Jonsson): per interior image
        e_prev, e_mid, e_next = e[:-2], e[1:-1], e[2:]
        t_plus = d_next[1:]                                     # [M-2]
        t_minus = d_next[:-1]
        de_next = e_next - e_mid
        de_prev = e_mid - e_prev
        up = (e_next > e_mid) & (e_mid > e_prev)
        down = (e_next < e_mid) & (e_mid < e_prev)
        dmax = torch.maximum(torch.abs(de_next), torch.abs(de_prev))
        dmin = torch.minimum(torch.abs(de_next), torch.abs(de_prev))
        w_hi = torch.where(e_next > e_prev, dmax, dmin)[:, None, None]
        w_lo = torch.where(e_next > e_prev, dmin, dmax)[:, None, None]
        tau = torch.where(up[:, None, None], t_plus,
                          torch.where(down[:, None, None], t_minus,
                                      t_plus * w_hi + t_minus * w_lo))
        tau = tau / norm(tau)[:, None, None]

        f_mid = f[1:-1]
        f_par = dot(f_mid, tau)[:, None, None] * tau
        f_spring = (self.k * (norm(t_plus) - norm(t_minus))[:, None, None]
                    * tau)
        f_neb = f_mid - f_par + f_spring
        if self.climb:
            i_max = torch.argmax(e_mid)
            one_hot = (torch.arange(self.n_images - 2, device=e.device)
                       == i_max)[:, None, None]
            f_neb = torch.where(one_hot, f_mid - 2.0 * f_par, f_neb)
        full = torch.zeros_like(pos)
        full[1:-1] = f_neb
        return e, full * self._move * mask

    def _fire_step(self, feats, pos, vel, dt, alpha, n_up):
        """One FIRE step on the whole band; every decision is a
        `torch.where` on device scalars (no host read)."""
        _, force = self._band_force(feats, pos)
        p = torch.sum(force * vel)
        fn = torch.sqrt(torch.sum(force * force) + 1e-32)
        vn = torch.sqrt(torch.sum(vel * vel) + 1e-32)
        uphill = p > 0
        vel = torch.where(uphill, (1 - alpha) * vel + alpha * vn * force / fn,
                          torch.zeros_like(vel))
        grow = uphill & (n_up >= N_MIN)
        dt = torch.where(grow, torch.clamp(dt * F_INC, max=DT_MAX),
                         torch.where(uphill, dt, dt * F_DEC))
        alpha = torch.where(grow, alpha * F_ALPHA,
                            torch.where(uphill, alpha,
                                        torch.full_like(alpha, ALPHA0)))
        n_up = torch.where(uphill, n_up + 1, torch.zeros_like(n_up))
        vel = vel + dt * force
        dr = dt * vel
        steplen = torch.sqrt(torch.sum(dr * dr, dim=-1, keepdim=True)
                             + 1e-32)
        dr = dr * torch.clamp(MAXSTEP / steplen, max=1.0)
        return pos + dr, vel, dt, alpha, n_up

    def _chunk(self, feats, pos, vel, dt, alpha, n_up, n: int):
        """`n` FIRE steps on fixed lists, then the band's energies and
        max |F| there, all as device tensors."""
        for _ in range(n):
            pos, vel, dt, alpha, n_up = self._fire_step(
                feats, pos, vel, dt, alpha, n_up)
        e, force = self._band_force(feats, pos)
        fmax = torch.sqrt(torch.max(torch.sum(force * force, dim=-1)))
        return pos, vel, dt, alpha, n_up, e, fmax

    # ------------------------------------------------------------------
    def _positions_vap(self) -> torch.Tensor:
        """The band [M, n_vap, 3] in the VAP layout, on the device."""
        pos_vap = np.zeros((self.n_images, self.model.n_atoms_vap, 3))
        pos_vap[:, self.vap.local_to_vap] = self.positions
        return self._tensor(pos_vap)

    def _eval_chunk(self, vel, dt, alpha, n_up, n):
        """Featurize the CURRENT band, run `n` FIRE steps, return the
        end-of-chunk state. n=0 is a pure (fresh-list) band evaluation."""
        feats = self._featurize_band()
        pos, vel, dt, alpha, n_up, e, f = self._chunk(
            feats, self._positions_vap(), vel, dt, alpha, n_up, n)
        host = torch.cat([e, f[None]]).cpu().numpy().astype(np.float64)
        self.positions = pos.cpu().numpy().astype(np.float64)[
            :, self.vap.local_to_vap]
        return vel, dt, alpha, n_up, host[:-1], float(host[-1])

    def run(self, fmax: float = 0.05, max_steps: int = 1000) -> dict:
        """Relax the band; returns energies, barrier and convergence.

        The neighbor list is rebuilt between chunks; because replicas
        can drift within a chunk while the list is frozen, convergence
        is only declared after a re-evaluation on FRESH features (an
        n=0 chunk), and the reported energies always come from a fresh
        list."""
        vel = torch.zeros((self.n_images, self.model.n_atoms_vap, 3),
                          dtype=self.dtype, device=self.device)
        dt, alpha = self._tensor(0.1), self._tensor(0.1)
        n_up = torch.zeros((), dtype=torch.int64, device=self.device)
        steps_done, converged = 0, False
        while steps_done < max_steps and not converged:
            n = min(self.chunk_size, max_steps - steps_done)
            vel, dt, alpha, n_up, energies, cur_fmax = \
                self._eval_chunk(vel, dt, alpha, n_up, n)
            steps_done += n
            if cur_fmax < fmax:
                # chunk-end forces used the chunk-start neighbor list;
                # confirm against a freshly built one before accepting
                _, _, _, _, energies, cur_fmax = self._eval_chunk(
                    vel, dt, alpha, n_up, 0)
                converged = cur_fmax < fmax
        if not converged:
            # honest final report: fresh-list energies and fmax
            _, _, _, _, energies, cur_fmax = self._eval_chunk(
                vel, dt, alpha, n_up, 0)
        self.energies = energies
        i_top = 1 + int(np.argmax(energies[1:-1]))
        return {
            "energies": energies,
            "barrier": float(energies[i_top] - energies[0]),
            "reverse_barrier": float(energies[i_top] - energies[-1]),
            "delta_e": float(energies[-1] - energies[0]),
            "fmax": cur_fmax,
            "converged": bool(converged),
            "n_steps": steps_done,
            "saddle_index": i_top,
        }

    def saddle_structure(self) -> Structure:
        """The highest-energy replica as a Structure."""
        if self.energies is None:
            raise RuntimeError("run() first")
        i = 1 + int(np.argmax(self.energies[1:-1]))
        s = self.template.copy()
        s.positions = self.positions[i]
        return s
