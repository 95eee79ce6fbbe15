"""Green-Kubo thermal conductivity and viscosity from an autograd heat
flux (port of `tensoralloy_tpu/analysis/heatflux.py`).

Every site energy is a function of the displacement vectors anchored at
its owner atom, E_i({d_q : o(q) = i}) with d_q = r_n(q) - r_o(q) (the
flat pairs `pair_i -> pair_j`, and the triples `trip_i -> trip_j/trip_k`
where a model reads them). With g_q = dE/dd_q (owner-only dependence),
the microscopic energy current reduces to

    J = sum_i (E_i + K_i) v_i  -  sum_q d_q (g_q . v_n(q))

(Hardy/Fan form, Fan et al., PRB 92, 094301 (2015), Eq. 24): one
autograd pass against the rij-fed energy of `nn.fields.make_rij_efs_fn`.
The flat layout is the only one with owner-anchored vectors: it serves
the EAM family and the descriptor models on the 'segment' backend (SF
and GRAP, their triples included); the EAM family's analytic flux on
the dense layout is `nn.eam.fast_efs.make_fast_heat_flux_fn`.

Green-Kubo: kappa = 1 / (V kB T^2) int_0^inf <J(0) . J(t)> / 3 dt, the
HCACF averaged over all time origins. Units follow `dynamics.py` (eV, A,
fs, amu): J in eV A/fs, kappa in W/(m K).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..dynamics import FORCE_TO_ACC, KB
from ..ops.pairs import pair_vectors, triple_vectors

__all__ = ["make_heat_flux_fn", "make_atomic_virial_fn",
           "trajectory_heat_flux", "gk_plateau", "green_kubo",
           "green_kubo_viscosity"]

# 1 eV/(A fs K) in W/(m K): eV->J, A->m, fs->s
EV_A_FS_TO_W_MK = 1.602176634e-19 / (1e-10 * 1e-15)
# 1 eV*fs/A^3 in Pa*s
EV_FS_A3_TO_PA_S = 1.602176634e-19 / 1e-30 * 1e-15


def _site_energy_fn(model):
    """Per-atom site energies consistent with the forces: a
    finite-temperature model differentiates the free energy F = U - TS,
    so its transported site energy is F_i."""
    if hasattr(model, "_atomic_heads"):
        return lambda feats, params: \
            model._atomic_heads(feats, params)["free_energy"]
    return model.atomic_energies


def _check_backend(model, what: str) -> None:
    backend = getattr(getattr(model, "descriptor", None), "backend",
                      "segment")
    if backend != "segment":
        raise ValueError(
            f"{what} the flat segment descriptor backend "
            f"(owner-anchored rij-fed gradients); got {backend!r}")


def _owner_gradients(model, features, params):
    """-> (energy, site energies, {key: vectors}, {key: dE/dvectors})."""
    site_energies = _site_energy_fn(model)
    keys = ["rij"]
    vecs = [pair_vectors(features)]
    if "trip_i" in features:
        keys += ["trip_rij", "trip_rik"]
        vecs += list(triple_vectors(features))
    vecs = [v.detach().requires_grad_() for v in vecs]
    with torch.enable_grad():
        ae = site_energies(dict(features, **dict(zip(keys, vecs))), params)
        energy = torch.sum(ae)
        grads = torch.autograd.grad(energy, vecs)
    return (energy.detach(), ae.detach(),
            {k: v.detach() for k, v in zip(keys, vecs)},
            dict(zip(keys, grads)))


def make_heat_flux_fn(model) -> Callable:
    """-> fn(features, velocities, masses, params=None) -> dict.

    `features`: one structure's flat ('segment') features; `velocities`
    [n_vap, 3] A/fs and `masses` [n_vap] amu in VAP order (the virtual
    row is masked out).

    Returns {"J", "J_convective", "J_virial" [3] eV A/fs, "energy",
    "atomic_energies" [n_vap]}."""
    _check_backend(model, "heat flux needs")

    def flux(features, velocities, masses, params=None
             ) -> Dict[str, torch.Tensor]:
        energy, ae, vecs, grads = _owner_gradients(model, features, params)
        amask = features["atom_masks"]
        kin = 0.5 * masses * torch.sum(torch.square(velocities), dim=-1) \
            / FORCE_TO_ACC
        conv = torch.sum((ae + kin * amask)[:, None] * velocities, dim=0)

        def virial_term(vec_key, neighbor_key):
            vn = velocities[features[neighbor_key].long()]
            return -torch.sum(vecs[vec_key] * torch.sum(
                grads[vec_key] * vn, dim=-1, keepdim=True), dim=0)

        jv = virial_term("rij", "pair_j")
        if "trip_rij" in grads:
            jv = jv + virial_term("trip_rij", "trip_j")
            jv = jv + virial_term("trip_rik", "trip_k")
        return {"J": conv + jv, "J_convective": conv, "J_virial": jv,
                "energy": energy, "atomic_energies": ae}

    return flux


def make_atomic_virial_fn(model) -> Callable:
    """-> fn(features, params=None) -> {"atomic_virials" [n_vap, 3, 3],
    "virial" [3, 3], "atomic_energies", "energy"}: the per-atom virials
    W_i = sum_{q: o(q) = i} g_q (x) d_q of the same owner-anchored
    gradients, which sum to the total potential virial."""
    _check_backend(model, "atomic virials need")

    def virials(features, params=None) -> Dict[str, torch.Tensor]:
        energy, ae, vecs, grads = _owner_gradients(model, features, params)
        n_vap = features["positions"].shape[0]

        def seg_outer(vec_key, owner_key):
            outer = grads[vec_key][:, :, None] * vecs[vec_key][:, None, :]
            return outer.new_zeros((n_vap, 3, 3)).index_add(
                0, features[owner_key].long(), outer)

        w = seg_outer("rij", "pair_i")
        if "trip_rij" in grads:
            w = w + seg_outer("trip_rij", "trip_i")
            w = w + seg_outer("trip_rik", "trip_i")
        return {"atomic_virials": w, "virial": torch.sum(w, dim=0),
                "atomic_energies": ae, "energy": energy}

    return virials


def trajectory_heat_flux(model, structure, positions, velocities,
                         cells=None, featurizer=None) -> np.ndarray:
    """J(t) [n_frames, 3] (eV A/fs) of a recorded trajectory, on the
    model's device (the JAX function without `params`).

    `positions` / `velocities` [n_frames, N, 3] in local atom order (as
    `dynamics.VelocityVerlet.run(record_trajectory=True)` records them);
    `cells` [n_frames, 3, 3] or None for the structure's cell. Each frame
    is featurized on the host with the widths of the whole trajectory;
    the EAM family takes the analytic flux on the dense layout."""
    from ..atoms import Structure
    from ..calculator import is_eam_family
    from ..dynamics import _model_factory

    fz = featurizer or model.featurizer
    vap = fz.make_vap(structure, model.max_occurs)
    fast = is_eam_family(model)
    if fast:
        from ..nn.eam.fast_efs import make_fast_heat_flux_fn
        flux = make_fast_heat_flux_fn(model)
    else:
        flux = make_heat_flux_fn(model)
    device, dtype = _model_factory(model)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32

    def put(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    masses = put(vap.map_array(structure.masses))
    frames = []
    nij_max = nnl_max = 0
    for t in range(len(positions)):
        s = Structure(structure.numbers, np.asarray(positions[t]),
                      structure.cell if cells is None
                      else np.asarray(cells[t]), structure.pbc)
        frames.append(s)
        ns = fz.neighbor_size(s)
        nij_max = max(nij_max, ns.nij)
        nnl_max = max(nnl_max, ns.nnl_tot)
    out = np.zeros((len(frames), 3))
    for t, s in enumerate(frames):
        if fast:
            feats = fz.featurize(s, vap, layout="dense", dtype=np_dtype,
                                 nnl_max=max(nnl_max, 1))
        else:
            feats = fz.featurize(s, vap, layout="segment", dtype=np_dtype,
                                 nij_max=nij_max)
        feats = {k: torch.as_tensor(v, device=device)
                 for k, v in feats.items()}
        res = flux(feats, put(vap.map_array(np.asarray(velocities[t]))),
                   masses)
        out[t] = res["J"].cpu().numpy()
    return out


def gk_plateau(acf: np.ndarray, running: np.ndarray) -> Dict[str, float]:
    """Plateau of a running Green-Kubo integral: the mean of `running`
    over [t0, 5 t0], t0 the first lag where the ACF has decayed (its
    first value <= 0 or below 1 % of ACF[0]), after decay and before the
    noise of the long-lag tail accumulates.

    Returns {"value", "stderr" (over the window, ddof=1), "lag_lo",
    "lag_hi" (indices)}."""
    acf = np.asarray(acf, np.float64)
    running = np.asarray(running, np.float64)
    a0 = abs(float(acf[0])) + 1e-300
    decayed = np.where((acf <= 0.0) | (np.abs(acf) < 0.01 * a0))[0]
    t0 = int(decayed[0]) if len(decayed) else max(len(running) // 4, 1)
    t0 = max(t0, 1)
    hi = int(min(len(running), max(5 * t0, t0 + 4)))
    win = running[t0:hi]
    se = float(win.std(ddof=1) / np.sqrt(len(win))) if len(win) > 1 \
        else 0.0
    return {"value": float(win.mean()), "stderr": se,
            "lag_lo": t0, "lag_hi": hi}


def green_kubo_viscosity(stress: np.ndarray, dt: float, volume: float,
                         temperature: float,
                         max_lag: Optional[int] = None
                         ) -> Dict[str, np.ndarray]:
    """Green-Kubo shear viscosity eta = V / (kB T) int <sigma_ab(0)
    sigma_ab(t)> dt, the ACF averaged over the three off-diagonal
    components and all time origins.

    `stress` [n_frames, 3, 3] eV/A^3 (the full stress with its kinetic
    part, e.g. `VelocityVerlet(record_stress=True)`), `dt` fs between
    frames, `volume` A^3, `temperature` K.

    Returns {"lags" fs, "sacf", "eta_running" Pa s, "eta", and the
    plateau's "eta_plateau", "eta_plateau_se", "plateau_window"}."""
    s = np.asarray(stress, dtype=np.float64)
    comps = np.stack([s[:, 0, 1], s[:, 0, 2], s[:, 1, 2]], axis=1)
    comps = comps - comps.mean(axis=0, keepdims=True)
    n = len(comps)
    if max_lag is None:
        max_lag = n // 2
    max_lag = int(min(max_lag, n - 1))
    acf = np.empty(max_lag + 1)
    for lag in range(max_lag + 1):
        acf[lag] = np.mean(comps[:n - lag] * comps[lag:])
    lags = np.arange(max_lag + 1) * dt
    integ = np.concatenate(
        [[0.0], np.cumsum(0.5 * (acf[1:] + acf[:-1]) * dt)])
    pref = EV_FS_A3_TO_PA_S * volume / (KB * temperature)
    eta_running = pref * integ
    pl = gk_plateau(acf, eta_running)
    return {"lags": lags, "sacf": acf, "eta_running": eta_running,
            "eta": float(eta_running[-1]),
            "eta_plateau": pl["value"], "eta_plateau_se": pl["stderr"],
            "plateau_window": (pl["lag_lo"], pl["lag_hi"])}


def green_kubo(J: np.ndarray, dt: float, volume: float,
               temperature: float, max_lag: Optional[int] = None
               ) -> Dict[str, np.ndarray]:
    """Green-Kubo running thermal conductivity of a heat-flux series.

    J [n_frames, 3] eV A/fs (the total flux, not per volume), `dt` fs
    between frames, `volume` A^3, `temperature` K. <J> is removed first:
    a residual centre-of-mass drift rides the convective term as a
    constant flux whose ACF offset would integrate to a spurious linear
    kappa(t).

    Returns {"lags" fs, "hcacf" (component-averaged, all origins),
    "kappa_running" W/(m K) (trapezoidal), "kappa", and the plateau's
    "kappa_plateau", "kappa_plateau_se", "plateau_window"}."""
    J = np.asarray(J, dtype=np.float64)
    J = J - J.mean(axis=0, keepdims=True)
    n = len(J)
    if max_lag is None:
        max_lag = n // 2
    max_lag = int(min(max_lag, n - 1))
    acf = np.empty(max_lag + 1)
    for lag in range(max_lag + 1):
        prods = np.sum(J[:n - lag] * J[lag:], axis=1)
        acf[lag] = prods.mean() / 3.0
    lags = np.arange(max_lag + 1) * dt
    integ = np.concatenate(
        [[0.0], np.cumsum(0.5 * (acf[1:] + acf[:-1]) * dt)])
    pref = EV_A_FS_TO_W_MK / (volume * KB * temperature ** 2)
    kappa_running = pref * integ
    pl = gk_plateau(acf, kappa_running)
    return {"lags": lags, "hcacf": acf,
            "kappa_running": kappa_running,
            "kappa": float(kappa_running[-1]),
            "kappa_plateau": pl["value"],
            "kappa_plateau_se": pl["stderr"],
            "plateau_window": (pl["lag_lo"], pl["lag_hi"])}
