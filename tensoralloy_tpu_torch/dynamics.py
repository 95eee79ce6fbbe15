"""Molecular dynamics on the model's device (port of
`tensoralloy_tpu/dynamics.py`).

Velocity-Verlet steps run as a plain loop on the device, the forces of a
step from one evaluation of the model (autograd of the variational
energy, or the EAM family's analytic EFS); the host reads the results
back once per chunk of steps, and rebuilds the neighbor list between
chunks (or the device does, with `device_nl=True`).

Units: positions A, velocities A/fs, masses amu, energies eV, time fs.
eV/A / amu = 9.64853e-3 A/fs^2.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Optional

import numpy as np
import torch

from .atoms import Structure

# (eV/A) / amu in A/fs^2
FORCE_TO_ACC = 9.648533290731905e-3
# Boltzmann constant in eV/K
KB = 8.617330337217213e-05
# eV/A^3 -> GPa
EV_A3_TO_GPA = 160.21766208
# consecutive regrows of the device neighbor list allowed for one chunk
MAX_REGROWS = 8


def maxwell_boltzmann_velocities(masses: np.ndarray, temperature: float,
                                 seed: int = 0) -> np.ndarray:
    """[N, 3] velocities (A/fs) at `temperature` K, COM removed (numpy's
    `RandomState`, so the same seed gives the JAX package's bits)."""
    rng = np.random.RandomState(seed)
    sigma = np.sqrt(KB * temperature / masses * FORCE_TO_ACC)
    v = rng.normal(size=(len(masses), 3)) * sigma[:, None]
    v -= np.average(v, axis=0, weights=masses)
    return v


def _volume(cell: torch.Tensor) -> torch.Tensor:
    """|det(cell)| of a 3x3 cell as a triple product (no host sync)."""
    return torch.clamp(torch.abs(torch.dot(
        cell[0], torch.linalg.cross(cell[1], cell[2]))), min=1e-12)


def _model_factory(model):
    """(device, dtype) of the model's weights."""
    for t in list(model.parameters()) + list(model.buffers()):
        if t.is_floating_point():
            return t.device, t.dtype
    raise ValueError("the model holds no floating-point tensor")


class VelocityVerlet:
    """Dynamics of one structure with a fixed stoichiometry, on the
    model's device and in its dtype (the JAX class without `params`: the
    weights are the module's).

    The neighbor list is built with a `skin` margin and reused for
    `chunk_size` steps; `run(n_steps)` handles the rebuild cadence.
    Choose `chunk_size * timestep * v_max < skin / 2`.

    `temperature` seeds Maxwell-Boltzmann initial velocities. Setting
    both `target_temperature` (K) and `friction` (1/fs) switches to the
    BAOAB Langevin splitting (NVT at one force evaluation per step); its
    noise comes from a `torch.Generator` on the model's device seeded
    with ``seed + 7919``, so it cannot reproduce the JAX package's
    `PRNGKey` stream, and a JAX state file's key cannot be carried over.

    `device_nl=True` rebuilds the skinned list on the device at every
    chunk (`transform/device_nl.py`); the host only reads the overflow
    diagnostics at the chunk end, and a chunk that overflowed is run
    again with a grown builder. The list's width is sized by the 'mean'
    census, so it follows the structure's density and not its most
    crowded atom.

    `record_heat_flux=True` records the many-body heat flux
    (`analysis.heatflux`, or the EAM family's analytic flux) at every
    chunk end; `record_stress=True` the full instantaneous stress tensor
    (potential virial and kinetic part, eV/A^3).

    `target_pressure` (GPa) switches on the Berendsen barostat (NPT with
    the Langevin thermostat): each step scales positions and cell by
    ``mu = (1 - dt/pressure_tau * compressibility * (P0 - P))^(1/3)``
    (isotropic) or by the full symmetric tensor (`anisotropic=True`).
    `pressure_tau` in fs, `compressibility` in 1/GPa.

    `fast_efs` ("auto", True, False): the EAM family's analytic EFS
    (`nn/eam/fast_efs.py`) on the dense layout; autograd otherwise.
    """

    def __init__(self, model, structure: Structure,
                 timestep: float = 1.0, skin: float = 1.0,
                 chunk_size: int = 20,
                 temperature: Optional[float] = None, seed: int = 0,
                 target_temperature: Optional[float] = None,
                 friction: Optional[float] = None,
                 device_nl: bool = False,
                 target_pressure: Optional[float] = None,
                 pressure_tau: float = 1000.0,
                 compressibility: float = 5e-3,
                 record_heat_flux: bool = False,
                 record_stress: bool = False,
                 fast_efs: "bool | str" = "auto",
                 anisotropic: bool = False):
        self.structure = structure.copy()
        self.timestep = float(timestep)
        self.skin = float(skin)
        self.chunk_size = int(chunk_size)
        self.target_temperature = target_temperature
        self.friction = friction
        if (target_temperature is None) != (friction is None):
            raise ValueError("Langevin NVT needs both "
                             "target_temperature and friction")
        self.target_pressure = target_pressure
        self.pressure_tau = float(pressure_tau)
        self.compressibility = float(compressibility)
        self.anisotropic = bool(anisotropic)
        if anisotropic and target_pressure is None:
            raise ValueError("anisotropic=True needs target_pressure")
        if target_pressure is not None and not structure.pbc.all():
            raise ValueError("the barostat needs a fully periodic cell")

        from .calculator import is_eam_family, model_feature_layout
        # dynamics differentiates w.r.t. geometry only
        model.requires_grad_(False)
        self.model = model.clone_for(Counter(structure.symbols))
        self.device, self.dtype = _model_factory(self.model)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed + 7919)
        self.record_heat_flux = bool(record_heat_flux)
        self.record_stress = bool(record_stress)
        if fast_efs == "auto":
            self._use_fast_efs = is_eam_family(self.model)
        else:
            self._use_fast_efs = bool(fast_efs) and \
                is_eam_family(self.model)
        self._flux_fn = None
        if self.record_heat_flux:
            if self._use_fast_efs:
                from .nn.eam.fast_efs import make_fast_heat_flux_fn
                self._flux_fn = make_fast_heat_flux_fn(self.model)
            else:
                from .analysis.heatflux import make_heat_flux_fn
                # raises for dense-backend descriptors up front
                self._flux_fn = make_heat_flux_fn(self.model)
        self._fast_fn = None
        if self._use_fast_efs:
            from .nn.eam.fast_efs import make_fast_efs_fn
            self._fast_fn = make_fast_efs_fn(self.model)
        self.fz = model.featurizer
        self.layout = model_feature_layout(self.model,
                                           fast=self._use_fast_efs)
        self.vap = self.fz.make_vap(structure, Counter(structure.symbols))
        self.masses_vap = np.zeros(self.model.n_atoms_vap)
        self.masses_vap[self.vap.local_to_vap] = structure.masses
        self.masses_vap[0] = 1.0     # virtual atom: inert unit mass
        velocities = (maxwell_boltzmann_velocities(
            structure.masses, temperature, seed)
            if temperature else np.zeros((len(structure), 3)))
        self.velocities_vap = np.zeros((self.model.n_atoms_vap, 3))
        self.velocities_vap[self.vap.local_to_vap] = velocities
        self._masses = self._tensor(self.masses_vap)[:, None]
        self._mask = self._tensor(self.vap.atom_masks)[:, None]
        # regrows of the device neighbor list over this integrator's runs
        self.regrows = 0
        self._nl = None
        if device_nl:
            from .transform.device_nl import DeviceNeighborList
            self._nl = DeviceNeighborList(
                self.fz, self.vap, structure,
                cutoff=self.fz.max_cutoff + self.skin, layout=self.layout,
                census="mean")

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                               device=self.device)

    # ------------------------------------------------------------------
    def _build_features(self, positions_local: np.ndarray) -> Dict:
        """Host featurization at the skinned cutoff, on the device."""
        s = self.structure.copy()
        s.positions = positions_local

        def pad(n):
            return max(256, 1 << int(np.ceil(np.log2(max(n, 1)))))

        def wpad(n):
            return max(32, 1 << int(np.ceil(np.log2(max(n, 1)))))
        old_rcut = self.fz.rcut
        try:
            self.fz.rcut += self.skin
            feats = self.fz.featurize(
                s, self.vap, pair_bucket=pad, nnl_bucket=wpad,
                ntl_bucket=wpad, layout=self.layout,
                dtype=np.float64 if self.dtype == torch.float64
                else np.float32)
        finally:
            self.fz.rcut = old_rcut
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in feats.items()}

    def _pot_pressure(self, virial, cell):
        """Potential pressure (GPa): the tensor -virial/V under the
        anisotropic barostat, its trace / 3 otherwise."""
        if self.anisotropic:
            return -virial / _volume(cell) * EV_A3_TO_GPA
        return -torch.trace(virial) / _volume(cell) / 3.0 * EV_A3_TO_GPA

    def _efs(self, feats, pos, cell, virial: bool):
        """-> (energy, forces, virial or None) at (pos, cell)."""
        f = dict(feats, positions=pos, cell=cell)
        if self._fast_fn is not None:
            out = self._fast_fn(f)
            return out["energy"], out["forces"], out["virial"]
        with torch.enable_grad():
            p = pos.detach().requires_grad_()
            h = cell.detach().requires_grad_(virial)
            energy = self.model.variational_energy(
                dict(f, positions=p, cell=h))
            grads = torch.autograd.grad(energy, (p, h) if virial else (p,))
        w = (grads[0].T @ pos + grads[1].T @ cell) if virial else None
        return energy.detach(), -grads[0], w

    def _forces(self, feats, pos, cell):
        """-> (forces, potential pressure): under NPT the pressure comes
        from the same evaluation (autograd over positions and cell)."""
        npt = self.target_pressure is not None
        _, forces, virial = self._efs(feats, pos, cell, npt)
        p_pot = (self._pot_pressure(virial, cell) if npt
                 else torch.zeros((), dtype=pos.dtype, device=pos.device))
        return forces * self._mask, p_pot

    def _kinetic(self, vel):
        return 0.5 * torch.sum(self._masses * torch.square(vel)
                               * self._mask) / FORCE_TO_ACC

    def _barostat(self, pos, vel, cell, p_pot):
        dt, masses, mask = self.timestep, self._masses, self._mask
        vol = _volume(cell)
        if self.anisotropic:
            # mu = I - dt beta / (3 tau) (P0 I - P_inst), each component
            # clipped to the scalar barostat's 1 % bound
            mvv = (vel * masses * mask).T @ vel / FORCE_TO_ACC
            p_inst = p_pot + mvv / vol * EV_A3_TO_GPA
            eye = torch.eye(3, dtype=pos.dtype, device=pos.device)
            delta = -dt / (3.0 * self.pressure_tau) * \
                self.compressibility * \
                (self.target_pressure * eye - p_inst)
            mu = eye + torch.clamp(delta, -0.01, 0.01)
            return pos @ mu.T, cell @ mu.T
        p_kin = (2.0 / 3.0) * self._kinetic(vel) / vol * EV_A3_TO_GPA
        p_inst = p_pot + p_kin
        mu = (1.0 - dt / self.pressure_tau * self.compressibility *
              (self.target_pressure - p_inst)) ** (1.0 / 3.0)
        mu = torch.clamp(mu, 0.99, 1.01)
        return pos * mu, cell * mu

    def _chunk(self, feats, pos, vel, cell, n: int):
        """`n` steps from (pos, vel, cell) on fixed lists, all on the
        device; -> the new state and the chunk-end observables as device
        tensors (potential, kinetic, P_inst, J, sigma)."""
        dt, masses = self.timestep, self._masses
        langevin = self.friction is not None
        if langevin:
            c1 = float(np.exp(-self.friction * dt))
            c2 = float(np.sqrt(1.0 - c1 * c1))
            sigma_v = torch.sqrt(KB * self.target_temperature / masses *
                                 FORCE_TO_ACC) * self._mask
        forces, p_pot = self._forces(feats, pos, cell)
        # the end-of-step acceleration is carried: one force evaluation
        # per step
        acc = forces / masses * FORCE_TO_ACC
        for _ in range(n):
            if langevin:
                # BAOAB: half kick, half drift, Ornstein-Uhlenbeck noise,
                # half drift, half kick
                vel = vel + 0.5 * dt * acc
                pos = pos + 0.5 * dt * vel
                xi = torch.randn(vel.shape, generator=self._gen,
                                 dtype=vel.dtype, device=vel.device)
                vel = c1 * vel + c2 * sigma_v * xi
                pos = pos + 0.5 * dt * vel
                forces, p_pot = self._forces(feats, pos, cell)
                acc = forces / masses * FORCE_TO_ACC
                vel = vel + 0.5 * dt * acc
            else:
                vel_half = vel + 0.5 * dt * acc
                pos = pos + dt * vel_half
                forces, p_pot = self._forces(feats, pos, cell)
                acc = forces / masses * FORCE_TO_ACC
                vel = vel_half + 0.5 * dt * acc
            if self.target_pressure is not None:
                pos, cell = self._barostat(pos, vel, cell, p_pot)
        return (pos, vel, cell) + self._finish(feats, pos, vel, cell, p_pot)

    def _finish(self, feats, pos, vel, cell, p_pot):
        """Chunk-end observables: (potential, kinetic, P_inst, J, sigma);
        the flux and the stress ride the chunk-end evaluation."""
        energy, _, virial = self._efs(feats, pos, cell,
                                      self.record_stress)
        ke = self._kinetic(vel)
        vol = _volume(cell)
        p_scalar = torch.trace(p_pot) / 3.0 if self.anisotropic else p_pot
        p_inst = p_scalar + (2.0 / 3.0) * ke / vol * EV_A3_TO_GPA
        zero = pos.new_zeros
        j = (self._flux_fn(dict(feats, positions=pos, cell=cell), vel,
                           self._masses[:, 0])["J"]
             if self._flux_fn is not None else zero(3))
        if self.record_stress:
            mv = vel * self._masses * self._mask
            sigma = (virial - mv.T @ vel / FORCE_TO_ACC) / vol
        else:
            sigma = zero((3, 3))
        return energy, ke, p_inst, j, sigma

    # ------------------------------------------------------------------
    def _history(self, record_trajectory=False):
        h = {"potential": [], "kinetic": [], "total": [],
             "temperature": []}
        if self.target_pressure is not None:
            h["pressure"], h["volume"] = [], []
        if record_trajectory:
            h["positions"], h["velocities"], h["cells"] = [], [], []
        if self.record_heat_flux:
            h["heat_flux"] = []
        if self.record_stress:
            h["stress_tensor"] = []
        return h

    def _record(self, history, pos, vel, cell, pe, ke, p_inst, jflux,
                sigma):
        """Append one chunk end, read back in one transfer."""
        flat = torch.cat([torch.stack([pe, ke, p_inst]).to(pos.dtype),
                          jflux.reshape(-1), sigma.reshape(-1),
                          cell.reshape(-1)]).cpu().numpy()
        pe, ke, p_inst = (float(x) for x in flat[:3])
        jflux, sigma, cell_h = (flat[3:6], flat[6:15].reshape(3, 3),
                                flat[15:24].reshape(3, 3))
        ndof = 3 * len(self.structure)
        if "heat_flux" in history:
            history["heat_flux"].append(jflux.copy())
        if "stress_tensor" in history:
            history["stress_tensor"].append(sigma.copy())
        history["potential"].append(pe)
        history["kinetic"].append(ke)
        history["total"].append(pe + ke)
        history["temperature"].append(2.0 * ke / (ndof * KB))
        if self.target_pressure is not None:
            history["pressure"].append(p_inst)
            history["volume"].append(float(abs(np.linalg.det(cell_h))))
        if "positions" in history:
            # local order, unwrapped (the integrator never wraps), as
            # `analysis.trajectory` expects
            l2v = self.vap.local_to_vap
            history["positions"].append(pos.cpu().numpy()[l2v].copy())
            history["velocities"].append(vel.cpu().numpy()[l2v].copy())
            history["cells"].append(cell_h.copy())

    def _run_device(self, n_steps: int, record_trajectory=False):
        pos = self._tensor(self.vap.map_positions(self.structure.positions))
        vel = self._tensor(self.velocities_vap)
        cell = self._tensor(self.structure.cell)
        etemp = float(self.structure.info.get("etemperature", 0.0) or 0.0)
        history = self._history(record_trajectory)
        remaining, regrows = n_steps, 0
        while remaining > 0:
            n = min(self.chunk_size, remaining)
            gen_state = self._gen.get_state()
            feats, diag = self._nl.build(pos, cell, etemp)
            out = self._chunk(feats, pos, vel, cell, n)
            try:
                self._nl.check(diag)
            except RuntimeError:
                # a capacity overflow: the chunk ran on a truncated list.
                # Grow the builder and run it again from the state before
                # it (the noise too); an image overflow cannot be grown
                from .transform.device_nl import diag_to_host
                host = diag_to_host(diag)
                if host["simg_overflow"] > 0 or regrows >= MAX_REGROWS:
                    raise
                self._nl = self._nl.grow(host)
                self._gen.set_state(gen_state)
                regrows += 1
                self.regrows += 1
                continue
            regrows = 0
            pos, vel, cell = out[:3]
            self._record(history, pos, vel, cell, *out[3:])
            remaining -= n
            if self.target_pressure is not None:
                # the grid is fixed in fractional space: a shrinking cell
                # narrows the bins until the stencil no longer spans the
                # skinned cutoff. The skin absorbs the drift inside a
                # chunk; re-grid once it is used up, and refuse when the
                # reach fell below the bare cutoff (the last chunk may
                # have run on a truncated list)
                cell_h = cell.cpu().numpy().astype(np.float64)
                if not self._nl.covers(cell_h, self.fz.max_cutoff):
                    raise RuntimeError(
                        "barostat shrank the cell past the neighbor "
                        "stencil within one chunk; use a smaller "
                        "chunk_size or a larger skin")
                if not self._nl.covers(cell_h):
                    tmpl = self.structure.copy()
                    tmpl.positions = pos.cpu().numpy()[
                        self.vap.local_to_vap]
                    tmpl.cell = cell_h
                    self._nl = self._nl.rebuilt_for(tmpl)
        self.structure.positions = pos.cpu().numpy().astype(
            np.float64)[self.vap.local_to_vap]
        self.structure.cell = cell.cpu().numpy().astype(np.float64)
        self.velocities_vap = vel.cpu().numpy().astype(np.float64)
        return history

    # ------------------------------------------------------------------
    def run(self, n_steps: int, record_trajectory: bool = False):
        """Integrate `n_steps`; -> the per-chunk history (potential,
        kinetic, total, temperature; pressure and volume under NPT;
        heat_flux / stress_tensor when recorded). `record_trajectory`
        also keeps each chunk end's unwrapped positions, velocities and
        cell, the inputs `analysis.trajectory` expects."""
        if self._nl is not None:
            return self._run_device(n_steps, record_trajectory)
        pos_local = self.structure.positions.copy()
        vel = self._tensor(self.velocities_vap)
        history = self._history(record_trajectory)
        remaining = n_steps
        while remaining > 0:
            n = min(self.chunk_size, remaining)
            # the skinned list on the host, at the current cell (the
            # barostat may have scaled it)
            feats = self._build_features(pos_local)
            pos = feats["positions"]
            cell = self._tensor(self.structure.cell)
            out = self._chunk(feats, pos, vel, cell, n)
            pos, vel, cell = out[:3]
            self._record(history, pos, vel, cell, *out[3:])
            pos_local = pos.cpu().numpy().astype(np.float64)[
                self.vap.local_to_vap]
            self.structure.cell = cell.cpu().numpy().astype(np.float64)
            remaining -= n
        self.structure.positions = pos_local
        self.velocities_vap = vel.cpu().numpy().astype(np.float64)
        return history

    # ------------------------------------------------------------------
    def zero_com_velocity(self) -> None:
        """Remove the centre-of-mass drift (mass-weighted); a Langevin
        thermostat random-walks the total momentum."""
        m = self.masses_vap[:, None] * self.vap.atom_masks[:, None]
        v_com = (m * self.velocities_vap).sum(0) / m.sum()
        self.velocities_vap = (self.velocities_vap - v_com[None]) \
            * self.vap.atom_masks[:, None]

    def save_state(self, path: str) -> None:
        """Checkpoint positions, velocities, cell and the noise
        generator's state in one npz (in place of the JAX file's `key`):
        `load_state` resumes exactly where the chunk boundaries line up
        (run(10) + run(10) == run(20) for a chunk_size dividing both)."""
        np.savez(path,
                 positions=self.structure.positions,
                 cell=self.structure.cell,
                 velocities_vap=self.velocities_vap,
                 generator_state=self._gen.get_state().numpy())

    def load_state(self, path: str) -> None:
        """Restore a `save_state` checkpoint (same structure and model).
        A JAX package's state file loads for NVE and NPT without a
        thermostat; its PRNG key cannot seed this generator, so a
        Langevin integrator refuses it."""
        d = np.load(path)
        if d["velocities_vap"].shape != self.velocities_vap.shape:
            raise ValueError(
                "state file does not match this system: velocities "
                f"{d['velocities_vap'].shape} vs "
                f"{self.velocities_vap.shape}")
        if "generator_state" in d:
            self._gen.set_state(torch.from_numpy(d["generator_state"]))
        elif self.friction is not None:
            raise ValueError(
                "the state file has no generator state (a JAX PRNG key "
                "cannot be carried over): the Langevin noise cannot "
                "resume from it")
        self.structure.positions = d["positions"].copy()
        self.structure.cell = d["cell"].copy()
        self.velocities_vap = d["velocities_vap"].copy()
        # a device builder is gridded for the cell it was made at
        if self._nl is not None and not self._nl.covers(
                self.structure.cell):
            self._nl = self._nl.rebuilt_for(self.structure.copy())

    @property
    def temperature(self) -> float:
        """Instantaneous temperature (K)."""
        ke = 0.5 * np.sum(self.masses_vap[:, None] * self.velocities_vap ** 2
                          * self.vap.atom_masks[:, None]) / FORCE_TO_ACC
        return 2.0 * ke / (3 * len(self.structure) * KB)
