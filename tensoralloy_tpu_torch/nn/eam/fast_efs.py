"""Analytic energy, forces and stress of the EAM family on the dense
layout (port of `tensoralloy_tpu/nn/eam/fast_efs.py`).

Every model of the family is

    E = sum_i F_i(A_i),   A_i = sum_{j in row i} a(v_ij; e_i, e_j)

with per-atom accumulators A (rho; and mu/lambda for ADP) and an
elementwise finalize F. Forces then have a closed form that reads only
row-local data and gathers of per-atom adjoints:

    dE/dpos_k = sum_{j in row k} [ ct_{jk}(-v_kj) - ct_{kj}(v_kj) ]

where ct_{ij} = (d a_{ij} / d v_ij)^T g_i is the per-pair cotangent
through the center's accumulators and g_i = dE/dA_i is the per-atom
adjoint (autograd of the finalize alone, no pair arrays). The reversed
cotangent ct_{jk} is evaluated again on row k from the same geometry
(a full directed list holds both (k, j) and (j, k)), so no scatter is
needed. The virial needs no reversal: W = sum_rows sum_cols ct_self (x)
v. The JAX package wrote this to avoid the TPU's slow scatter-adds;
on the GPU it is one of two routes, and the calculator's `fast_efs`
picks between them (`calculator.TensorAlloyCalculator`).

The only autograd here is elementwise: f'(r) of each function (one
`autograd.grad` against ones) and the adjoints of the finalize. The
results are detached: this is a serving path. The EFS and the heat flux
share one pass (`_make_pass`), which also returns the per-slot
cotangents ct_self and the vectors v that the flux contracts.

Where the dense neighbor columns are sharded over ranks
(`parallel.spatial.make_spatial_fast_efs_fn`), every row reduction of a
rank is a partial: `reduce` (the identity by default) sums rho, the pair
energy, ADP's moments, the forces and the virial across the ranks. The
reversed term reads the per-atom adjoints of the summed accumulators, so
it needs no exchange.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ...ops.dense import gather_vec, safe_norm_components
from ..fields import stress_outputs


def _val_and_deriv(f: Callable, r: torch.Tensor):
    """(f(r), f'(r)) of an elementwise scalar function: one autograd.grad
    of f(r) against ones."""
    with torch.enable_grad():
        x = r.detach().requires_grad_()
        val = f(x)
        der, = torch.autograd.grad(val, x, torch.ones_like(val))
    return val.detach(), der.detach()


def _adjoint(fn: Callable, inputs, cotangent: torch.Tensor):
    """(fn(*inputs), d<cotangent, fn>/d inputs): the pullback of a
    finalize."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in inputs]
        out = fn(*xs)
        grads = torch.autograd.grad(out, xs, cotangent)
    return out.detach(), [g.detach() for g in grads]


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _make_pass(model, reduce: Callable = _identity) -> Callable:
    """The analytic pass that the EFS and the heat flux share:
    fn(features, params=None) -> energy, atomic_energies, forces, virial,
    and the owner-anchored per-slot cotangents ct_self = dE/dv_kj through
    row k's accumulators (three [A, N] components) with the vectors v
    themselves. Reads the dense layout ('pair_j_d', 'pair_simg_d',
    'pair_mask_d') of one structure; raises KeyError otherwise. `reduce`
    completes each row reduction of a column shard (module docstring);
    ct_self and v stay the shard's own."""
    rcut = model.featurizer.rcut
    elements = model.elements
    is_adp = model.tag == "adp"
    is_fs = model.tag == "fs"

    @torch.no_grad()
    def run(features, params=None) -> Dict[str, torch.Tensor]:
        params = model._params(params)
        pos = features["positions"]            # [A, 3]
        cell = features["cell"]
        jd = features["pair_j_d"].long()       # [A, N]
        mask = features["pair_mask_d"]         # [A, N]
        am = features["atom_masks"]            # [A]
        elem, uterm = model._index_tables(pos.device)
        ei = elem[:, None]                     # [A, 1] broadcasts
        ej = elem[jd]                          # [A, N]
        ut = uterm[ei, ej]

        v = gather_vec(pos, jd, features["pair_simg_d"], cell)
        r = safe_norm_components(v)            # [A, N]
        r = torch.where(mask > 0, r, 1.0)
        mask = mask * (r < rcut).to(mask.dtype)
        u = tuple(vc / r for vc in v)

        # ---- per-pair function values + radial derivatives ----------
        # rho: 'self' = a_{kj} (center k), 'rev' = a_{jk} (center j)
        rho_p = torch.zeros_like(r)
        drho_self = torch.zeros_like(r)
        drho_rev = torch.zeros_like(r)
        if is_fs:
            for a_i, a in enumerate(elements):
                for b_i, b in enumerate(elements):
                    if model.max_occurs.get(a, 0) == 0 or \
                            model.max_occurs.get(b, 0) == 0:
                        continue
                    val, der = _val_and_deriv(
                        model._fn(params, a + b, "rho", "rho"), r)
                    sel_s = (ei == a_i) & (ej == b_i)
                    sel_r = (ej == a_i) & (ei == b_i)
                    rho_p = rho_p + torch.where(sel_s, val, 0.0)
                    drho_self = drho_self + torch.where(sel_s, der, 0.0)
                    drho_rev = drho_rev + torch.where(sel_r, der, 0.0)
        else:
            for e_i, e in enumerate(elements):
                if model.max_occurs.get(e, 0) == 0:
                    continue
                val, der = _val_and_deriv(
                    model._fn(params, e, "rho", "rho"), r)
                # alloy: rho depends on the NEIGHBOR element only
                rho_p = rho_p + torch.where(ej == e_i, val, 0.0)
                drho_self = drho_self + torch.where(ej == e_i, der, 0.0)
                drho_rev = drho_rev + torch.where(ei == e_i, der, 0.0)

        phi_p = torch.zeros_like(r)
        dphi = torch.zeros_like(r)
        for t, term in enumerate(model.unique_kbody_terms):
            if not model._term_possible(term):
                continue
            val, der = _val_and_deriv(
                model._fn(params, term, "phi", "phi"), r)
            sel = ut == t
            phi_p = phi_p + torch.where(sel, val, 0.0)
            dphi = dphi + torch.where(sel, der, 0.0)

        # ---- accumulators (dense row reductions) ---------------------
        rho_i = reduce(torch.sum(rho_p * mask, dim=1))
        phi_i = reduce(0.5 * torch.sum(phi_p * mask, dim=1))
        embed_i, (g_rho,) = _adjoint(
            lambda rho: model._embed_energy(params, rho), (rho_i,), am)
        atomic_e = (embed_i + phi_i) * am
        g_rho_j = g_rho[jd]
        am_j = am[jd]

        # ---- radial force/virial coefficients ------------------------
        w_self = (g_rho[:, None] * drho_self + 0.5 * am[:, None] * dphi) \
            * mask
        w_rev = (g_rho_j * drho_rev + 0.5 * am_j * dphi) * mask
        w_tot = w_self + w_rev
        forces_c = [torch.sum(w_tot * uc, dim=1) for uc in u]
        ct_self = [w_self * uc for uc in u]

        if is_adp:
            adp_e, ct_a_self, ct_a_rev = _adp_terms(
                model, params, v, r, u, mask, ut, am, jd, reduce)
            atomic_e = atomic_e + adp_e * am
            forces_c = [fc + torch.sum(cs - cr, dim=1)
                        for fc, cs, cr in zip(forces_c, ct_a_self,
                                              ct_a_rev)]
            ct_self = [c + cs for c, cs in zip(ct_self, ct_a_self)]

        # virial[a, b] = sum ct_self[a] v[b]
        virial = reduce(torch.stack(
            [torch.stack([torch.sum(ct_self[a] * v[b]) for b in range(3)])
             for a in range(3)]))
        return {"energy": torch.sum(atomic_e), "atomic_energies": atomic_e,
                "forces": reduce(torch.stack(forces_c, dim=-1)),
                "virial": virial,
                "ct_self": tuple(ct_self), "v": v}

    return run


def make_fast_efs_fn(model, reduce: Callable = _identity) -> Callable:
    """fn(features, params=None) -> energy, atomic_energies, forces,
    virial, stress, stress_voigt and total_pressure (the `make_efs_fn`
    contract), computed without autograd over pair arrays. Reads the
    dense layout ('pair_j_d', 'pair_simg_d', 'pair_mask_d') of one
    structure; raises KeyError otherwise. `reduce` sums a column shard's
    row reductions across ranks (the module docstring)."""
    run = _make_pass(model, reduce)

    def efs(features, params=None) -> Dict[str, torch.Tensor]:
        o = run(features, params)
        return {"energy": o["energy"], "atomic_energies": o["atomic_energies"],
                "forces": o["forces"],
                **stress_outputs(o["virial"], features["cell"])}

    return efs


def make_fast_heat_flux_fn(model) -> Callable:
    """The analytic many-body heat flux on the dense layout: the operator
    of `analysis.heatflux.make_heat_flux_fn`,

        J = sum_i (E_i + K_i) v_i - sum_q d_q (g_q . v_n(q)),

    with g_q = ct_self of the shared pass instead of autograd.

    fn(features, velocities [A, 3], masses [A], params=None) ->
    {"J", "J_convective", "J_virial" [3] (eV A/fs), "energy",
    "atomic_energies"}."""
    from ...dynamics import FORCE_TO_ACC
    run = _make_pass(model)

    def flux(features, velocities, masses, params=None):
        o = run(features, params)
        ae = o["atomic_energies"]
        am = features["atom_masks"]
        kin = 0.5 * masses * torch.sum(torch.square(velocities), dim=-1) \
            / FORCE_TO_ACC
        conv = torch.sum((ae + kin * am)[:, None] * velocities, dim=0)
        # neighbour velocities by one row gather; ct . vel first, then
        # dotted with v
        vg = velocities[features["pair_j_d"].long()]     # [A, N, 3]
        ct_dot_vel = sum(ct * vg[..., a]
                         for a, ct in enumerate(o["ct_self"]))
        jv = -torch.stack([torch.sum(o["v"][b] * ct_dot_vel)
                           for b in range(3)])
        return {"J": conv + jv, "J_convective": conv, "J_virial": jv,
                "energy": o["energy"], "atomic_energies": ae}

    return flux


def _adp_terms(model, params, v, r, u, mask, ut, am, jd,
               reduce: Callable = _identity):
    """ADP dipole/quadrupole energy + analytic forces/virial.

    a_mu = u_t(r) v  (per k-body term t),  a_lam = w_t(r) v (x) v.
    Cotangents through the center's moments (m = g_mu, L = g_lam):
      ct_mu(m)  = u'(r) (m . v) u + u_t(r) m
      ct_lam(L) = w'(r) (L : vv) u + 2 w_t(r) L v
    The reversed pair's cotangents evaluate at v_jk = -v with the
    gathered adjoints: the mu form is even under the flip, the lam form
    odd. `v`/`u` arrive as component tuples and are stacked to [A, N, 3]
    here; the returned cotangents are component tuples again."""
    n_ut = len(model.unique_kbody_terms)
    per_term = model.adp_per_term
    v = torch.stack(v, dim=-1)             # [A, N, 3]
    u = torch.stack(u, dim=-1)

    u_p = torch.zeros_like(r)
    du_p = torch.zeros_like(r)
    w_p = torch.zeros_like(r)
    dw_p = torch.zeros_like(r)
    for t, term in enumerate(model.unique_kbody_terms):
        if not model._term_possible(term):
            continue
        sel = ut == t
        val, der = _val_and_deriv(
            model._fn(params, term, "dipole", "dipole"), r)
        u_p = u_p + torch.where(sel, val, 0.0)
        du_p = du_p + torch.where(sel, der, 0.0)
        val, der = _val_and_deriv(
            model._fn(params, term, "quadrupole", "quadrupole"), r)
        w_p = w_p + torch.where(sel, val, 0.0)
        dw_p = dw_p + torch.where(sel, der, 0.0)
    u_p = u_p * mask
    w_p = w_p * mask

    # moments per (atom, term): [A, G, 3] / [A, G, 3, 3], G = n_ut or 1
    tsel = (torch.nn.functional.one_hot(ut, n_ut).to(r.dtype) if per_term
            else torch.ones(r.shape + (1,), dtype=r.dtype,
                            device=r.device))      # [A, N, G]
    mu = reduce(torch.einsum("knt,kn,kna->kta", tsel, u_p, v))
    dd = v[..., :, None] * v[..., None, :]          # [A, N, 3, 3]
    lam = reduce(torch.einsum("knt,kn,knab->ktab", tsel, w_p, dd))

    def quad_energy(mu_, lam_):
        e_mu = 0.5 * torch.sum(torch.square(mu_), dim=-1)
        e_lam = 0.5 * torch.sum(torch.square(lam_), dim=(-1, -2))
        nu = lam_.diagonal(dim1=-2, dim2=-1).sum(-1)
        return torch.sum(e_mu + e_lam - torch.square(nu) / 6.0, dim=-1)

    adp_e, (g_mu, g_lam) = _adjoint(quad_energy, (mu, lam), am)

    # adjoints at the center and at the neighbor, selected per pair's
    # k-body term by the same one-hot contraction
    m_self = torch.einsum("knt,kta->kna", tsel, g_mu)
    L_self = torch.einsum("knt,ktab->knab", tsel, g_lam)
    m_rev = torch.einsum("knt,knta->kna", tsel, g_mu[jd])
    L_rev = torch.einsum("knt,kntab->knab", tsel, g_lam[jd])

    def ct_mu(m):
        return (du_p * torch.sum(m * v, dim=-1))[..., None] * u \
            + u_p[..., None] * m

    def ct_lam(L):
        lvv = torch.einsum("knab,kna,knb->kn", L, v, v)
        return (dw_p * lvv)[..., None] * u \
            + 2.0 * w_p[..., None] * torch.einsum("knab,knb->kna", L, v)

    ct_self = (ct_mu(m_self) + ct_lam(L_self)) * mask[..., None]
    # reversed pair: the cotangent of pair (j, k) w.r.t. v_jk mapped
    # through dv_jk/dpos_k = +1, in row k's geometry; the caller
    # assembles forces[k] = sum_row (ct_self - ct_rev)
    ct_rev = (ct_mu(m_rev) - ct_lam(L_rev)) * mask[..., None]
    return (adp_e,
            tuple(ct_self[..., a] for a in range(3)),
            tuple(ct_rev[..., a] for a in range(3)))
