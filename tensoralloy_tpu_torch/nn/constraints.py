"""Physics-constraint losses (port of `tensoralloy_tpu/nn/constraints.py`).

Every constraint featurizes its reference crystals once, at
construction, into constant feature arrays, and adds analytic residuals
of the model's outputs on them to the training loss: `loss(params)`
with `params` the trainer's parameter tree. The trainer moves the
constant features to its device and dtype (`to`).

Implemented: elastic constants (C_ij as the strain Hessian of the
energy: six `autograd.grad` calls with `create_graph`, so that the
parameter gradient, a third derivative, exists), the Rose equation of
state, energy differences (ediff), electron-entropy pinning, second-
order force constants (hessian/c against a phonopy fc2), and extra-
database energy/force terms. No `torch.func` transform is used: the
descriptor kernels' autograd Functions do not support them, and the same
constraints serve an SF or GRAP model.
"""
from __future__ import annotations

import dataclasses
import os
import tomllib
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..atoms import Structure
from ..precision import resolve_device, resolve_dtype
from ..transform.featurizer import batch_features
from .fields import EV_ANGSTROM3_TO_GPA, make_efs_fn, make_hessian_fn

GPa = 1.0 / EV_ANGSTROM3_TO_GPA


def _safe_norm(x: torch.Tensor, eps: float = 1e-14) -> torch.Tensor:
    """Norm with a finite gradient at 0 (an equilibrium crystal has
    exactly zero forces and pressure)."""
    return torch.sqrt(torch.sum(torch.square(x)) + eps)


# ----------------------------------------------------------------------
@dataclasses.dataclass
class ElasticConstant:
    vi: int            # Voigt index, 1-based
    vj: int
    value: float       # GPa
    weight: float = 1.0


@dataclasses.dataclass
class CrystalSpec:
    name: str
    structure: Structure
    phase: str = ""
    bulk_modulus: float = 0.0          # GPa
    elastic_constants: List[ElasticConstant] = \
        dataclasses.field(default_factory=list)
    temperature: float = 0.0           # eV
    supercell: Optional[Structure] = None
    fc2: Optional[np.ndarray] = None   # [N, N, 3, 3] phonopy format
    eentropy: float = 0.0


def get_crystal(obj, base_dir: str = ".") -> CrystalSpec:
    """Resolve a crystal from a built-in name / CrystalSpec / TOML path
    / cif path.

    Built-in names ('Ni', 'Mo/dft', 'Ni3Mo', ...) resolve from the
    bundled library. TOML files accept both [[elastic_constants]]
    entries {vi, vj, value, weight} and flat ``cNM = value`` /
    ``cNM = [value, weight]`` keys (`data/crystals/
    Ni3Mo_elastic_tensor.toml`).
    """
    if isinstance(obj, CrystalSpec):
        return obj
    if isinstance(obj, str):
        from ..data.crystals import built_in_crystals
        lib = built_in_crystals()
        if obj in lib:
            return lib[obj]
    path = obj if os.path.isabs(obj) else os.path.join(base_dir, obj)
    from ..io.cif import read_cif
    if path.endswith(".cif"):
        return CrystalSpec(name=os.path.basename(path)[:-4],
                           structure=read_cif(path))
    if path.endswith(".toml"):
        with open(path, "rb") as fh:
            d = tomllib.load(fh)
        ddir = os.path.dirname(os.path.abspath(path))
        spec = CrystalSpec(
            name=d.get("name", "crystal"),
            structure=read_cif(os.path.join(ddir, d["file"])),
            phase=d.get("phase", ""),
            bulk_modulus=float(d.get("bulk_modulus", 0.0)),
            temperature=float(d.get("temperature", 0.0)),
            eentropy=float(d.get("eentropy", 0.0)))
        if d.get("supercell"):
            spec.supercell = read_cif(os.path.join(ddir, d["supercell"]))
        if d.get("fc2"):
            spec.fc2 = np.load(os.path.join(ddir, d["fc2"]))
        for row in d.get("elastic_constants", []):
            spec.elastic_constants.append(ElasticConstant(
                vi=int(row["vi"]), vj=int(row["vj"]),
                value=float(row["value"]),
                weight=float(row.get("weight", 1.0))))
        # flat keys: c11 = 385 / c66 = [94.0, 0.0]
        for key, value in d.items():
            if len(key) == 3 and key[0] == "c" and key[1:].isdigit():
                if isinstance(value, (list, tuple)):
                    cij = float(value[0])
                    weight = float(value[1]) if len(value) > 1 else 1.0
                else:
                    cij, weight = float(value), 1.0
                spec.elastic_constants.append(ElasticConstant(
                    vi=int(key[1]), vj=int(key[2]), value=cij,
                    weight=weight))
        return spec
    raise ValueError(f"cannot resolve crystal from {obj!r}")


# ----------------------------------------------------------------------
def _layout(model) -> str:
    from ..calculator import model_feature_layout
    return model_feature_layout(model)


def _constant_features(model, structure: Structure,
                       temperature: float = 0.0) -> Dict[str, np.ndarray]:
    """Featurize a crystal with the model's own featurizer, in the
    layout the model reads."""
    fz = model.featurizer
    s = structure.copy()
    s.info["etemperature"] = temperature
    return fz.featurize(s, fz.make_vap(s), layout=_layout(model))


def _variant_for(model, structure: Structure):
    """Model clone laid out for this crystal's stoichiometry."""
    return model.clone_for(Counter(structure.symbols))


def _energy_fn(model, params):
    return lambda f: model.energy_and_aux(f, params)


def strained_energy_fn(model, params, feats):
    """E(eps6): energy under symmetric strain (Voigt 6-vector)."""
    pos0 = feats["positions"]
    cell0 = feats["cell"]

    def energy(eps6):
        e = torch.stack([
            torch.stack([eps6[0], eps6[5] / 2, eps6[4] / 2]),
            torch.stack([eps6[5] / 2, eps6[1], eps6[3] / 2]),
            torch.stack([eps6[4] / 2, eps6[3] / 2, eps6[2]])])
        m = torch.eye(3, dtype=pos0.dtype, device=pos0.device) + e
        f = dict(feats, positions=pos0 @ m.T, cell=cell0 @ m.T)
        return model.variational_energy(f, params)

    return energy


def elastic_tensor(model, params, feats) -> torch.Tensor:
    """Full 6x6 C_ij (GPa) = (1/V) d^2 E / d eps_i d eps_j: the gradient
    in the strain, then one more `autograd.grad` a row, all with
    `create_graph` while grad mode is on (a loss on C differentiates it
    w.r.t. the parameters)."""
    energy = strained_energy_fn(model, params, feats)
    create = torch.is_grad_enabled()
    cell = feats["cell"]
    eps = torch.zeros(6, dtype=cell.dtype, device=cell.device,
                      requires_grad=True)
    with torch.enable_grad():
        grad, = torch.autograd.grad(energy(eps), eps, create_graph=True)
        rows = [torch.autograd.grad(grad[i], eps, retain_graph=True,
                                    create_graph=create)[0]
                for i in range(6)]
    hess = torch.stack(rows)
    vol = torch.abs(torch.linalg.det(cell))
    return hess / vol * EV_ANGSTROM3_TO_GPA


class _Constraint:
    """Constant features held as tensors, moved by the trainer."""

    name = "constraint"

    def __init__(self):
        self.device = torch.device("cpu")
        self.dtype = torch.float64

    def _arrays(self):
        """-> the feature dicts that `to` moves (subclass-specific)."""
        return []

    def to(self, device=None, dtype=None) -> "_Constraint":
        """Move the constant features to `device` in `dtype`."""
        if device is not None:
            self.device = resolve_device(device)
        if dtype is not None:
            self.dtype = resolve_dtype(dtype)
        from ..train.dataset import to_tensors
        for arrays in self._arrays():
            arrays.update(to_tensors(arrays, self.device, self.dtype))
        return self

    def _zero(self) -> torch.Tensor:
        return torch.zeros((), dtype=self.dtype, device=self.device)


# ----------------------------------------------------------------------
@dataclasses.dataclass
class ElasticConstraintOptions:
    use_kbar: bool = True
    forces_weight: float = 1.0
    stress_weight: float = 0.1
    tau: float = 1.0


class ElasticConstraint(_Constraint):
    """RMSE (GPa) of chosen C_ij vs references, with ReLU(mae - tau)
    gating + equilibrium (forces/stress-norm) penalties."""

    name = "elastic"

    def __init__(self, model, crystals: Sequence, weight: float = 0.1,
                 options: Optional[ElasticConstraintOptions] = None,
                 base_dir: str = "."):
        super().__init__()
        self.weight = weight
        self.options = options or ElasticConstraintOptions()
        self.entries = []
        for c in crystals:
            spec = get_crystal(c, base_dir)
            variant = _variant_for(model, spec.structure)
            feats = _constant_features(variant, spec.structure,
                                       spec.temperature)
            self.entries.append((spec, variant, feats))
        self.to()

    def _arrays(self):
        return [feats for _, _, feats in self.entries]

    def loss(self, params) -> torch.Tensor:
        opt = self.options
        create = torch.is_grad_enabled()
        total = self._zero()
        for spec, model, feats in self.entries:
            efs = make_efs_fn(_energy_fn(model, params), create)(feats)
            c = elastic_tensor(model, params, feats)
            if spec.elastic_constants:
                preds = torch.stack([c[ec.vi - 1, ec.vj - 1]
                                     for ec in spec.elastic_constants])
                labels = preds.new_tensor(
                    [ec.value for ec in spec.elastic_constants])
                weights = preds.new_tensor(
                    [ec.weight for ec in spec.elastic_constants])
                diff = preds - labels
                mse = torch.mean(weights * torch.square(diff))
                mae = torch.mean(torch.abs(diff))
                gate = torch.relu(mae - opt.tau)
                total = total + torch.sqrt(mse * gate + 1e-14) * self.weight
            # equilibrium penalties
            f_norm = _safe_norm(
                efs["forces"] * feats["atom_masks"][:, None])
            unit = (10.0 / GPa) if opt.use_kbar else (1e4 / GPa)
            s_norm = _safe_norm(efs["stress_voigt"] * unit)
            total = total + opt.forces_weight * f_norm \
                + opt.stress_weight * s_norm
        return total


# ----------------------------------------------------------------------
@dataclasses.dataclass
class RoseConstraintOptions:
    crystals: Sequence = ()
    weight: float = 1.0
    beta: Sequence[float] = ()
    dx: float = 0.01
    xlo: float = 0.90
    xhi: float = 1.02
    p_target: Sequence[float] = ()
    E_target: Sequence[float] = ()


class RoseConstraint(_Constraint):
    """Rose universal EOS residual: energies of isotropically scaled
    cells must follow
    E(x) = E0 exp(-a x) [1 + a x + beta (a x)^3 (2x+3)/(x+1)^2],
    a = sqrt(-9 V0 B / E0). Fits the bulk modulus. The scaled cells are
    one batch of the model's batched forward."""

    name = "rose"

    def __init__(self, model, options: RoseConstraintOptions,
                 base_dir: str = "."):
        super().__init__()
        self.options = options
        self.entries = []
        for idx, c in enumerate(options.crystals):
            spec = get_crystal(c, base_dir)
            if spec.bulk_modulus == 0:
                continue
            variant = _variant_for(model, spec.structure)
            eq_feats = _constant_features(variant, spec.structure,
                                          spec.temperature)
            scales = np.arange(options.xlo - 1.0, options.xhi - 1.0,
                               options.dx)
            scaled = []
            for x in scales:
                s = spec.structure.copy()
                s.cell = spec.structure.cell * (1.0 + x)
                s.positions = spec.structure.positions * (1.0 + x)
                s.info["etemperature"] = spec.temperature
                scaled.append(s)
            fz = variant.featurizer
            sizes = [fz.neighbor_size(s) for s in scaled]
            vap = fz.make_vap(spec.structure)
            batch = batch_features([
                fz.featurize(s, vap, layout=_layout(variant),
                             nij_max=max(z.nij for z in sizes),
                             nnl_max=max(z.nnl_tot for z in sizes),
                             ntl_max=(max(z.ntl for z in sizes)
                                      if fz.angular else None))
                for s in scaled])
            beta = (options.beta[idx] if idx < len(options.beta) else 0.0)
            p_t = (options.p_target[idx]
                   if idx < len(options.p_target) else 0.0)
            e_t = (options.E_target[idx]
                   if idx < len(options.E_target) else None)
            self.entries.append(
                (spec, variant, eq_feats, batch, {"x": scales}, beta, p_t,
                 e_t))
        self.to()

    def _arrays(self):
        return [d for entry in self.entries for d in entry[2:5]]

    def loss(self, params) -> torch.Tensor:
        create = torch.is_grad_enabled()
        total = self._zero()
        for (spec, model, eq_feats, batch, scales, beta, p_t, e_t) in \
                self.entries:
            x = scales["x"]
            efs = make_efs_fn(_energy_fn(model, params), create)(eq_feats)
            e0 = efs["energy"]
            v0 = torch.abs(torch.linalg.det(eq_feats["cell"]))
            p0 = -efs["stress_voigt"][:3] / GPa
            b_ev = spec.bulk_modulus * GPa    # eV/A^3
            # a = sqrt(-9 V0 B / E0) is real only for a bound crystal
            # (E0 < 0); early in training the prediction can be >= 0,
            # which would make the loss NaN (or exp(-a x) inf): clamp E0
            # below zero and cap a far above its physical range (~3-10)
            a = torch.minimum(torch.sqrt(
                -9.0 * v0 * b_ev / torch.minimum(e0, e0.new_tensor(-1e-6))),
                e0.new_tensor(25.0))
            ax = a * x
            coef = torch.exp(-ax) * (
                1.0 + ax + beta * ax ** 3 * (2.0 * x + 3.0) /
                torch.square(x + 1.0))
            e_ref = e0 if e_t is None else e_t
            labels = e_ref * coef
            preds = model.variational_energy(batch, params)
            diff = preds - labels
            residual = torch.sqrt(torch.sum(torch.square(diff)) + 1e-14)
            ploss = _safe_norm(p0 - p_t)
            eloss = torch.abs(e0 - e_t) if e_t is not None else 0.0
            total = total + (residual + ploss + eloss) * \
                self.options.weight
        return total


# ----------------------------------------------------------------------
class EnergyDifferenceConstraint(_Constraint):
    """Pin energy differences between crystal pairs:
    | (E_t - E_r)/natoms - diff |."""

    name = "ediff"

    def __init__(self, model, references: Sequence, crystals: Sequence,
                 diffs: Sequence[float], weight: float = 1.0,
                 method: str = "mae", base_dir: str = "."):
        super().__init__()
        self.weight = weight
        self.method = method
        self.entries = []
        for ref, tgt, diff in zip(references, crystals, diffs):
            r = get_crystal(ref, base_dir)
            t = get_crystal(tgt, base_dir)
            vr = _variant_for(model, r.structure)
            vt = _variant_for(model, t.structure)
            self.entries.append(
                (vr, _constant_features(vr, r.structure, r.temperature),
                 len(r.structure),
                 vt, _constant_features(vt, t.structure, t.temperature),
                 len(t.structure), float(diff)))
        self.to()

    def _arrays(self):
        return [d for e in self.entries for d in (e[1], e[4])]

    def loss(self, params) -> torch.Tensor:
        from .losses import logcosh
        total = self._zero()
        for vr, fr, nr, vt, ft, nt, diff in self.entries:
            er = vr.variational_energy(fr, params) / nr
            et = vt.variational_energy(ft, params) / nt
            x = (et - er) - diff
            total = total + (torch.abs(x) if self.method == "mae"
                             else logcosh(x)) * self.weight
        return total


class EntropyConstraint(_Constraint):
    """Pin the electron entropies of crystals (finite-temperature
    models)."""

    name = "eentropy/c"

    def __init__(self, model, crystals: Sequence, weight: float = 1.0,
                 base_dir: str = "."):
        super().__init__()
        self.weight = weight
        self.entries = []
        for c in crystals:
            spec = get_crystal(c, base_dir)
            variant = _variant_for(model, spec.structure)
            feats = _constant_features(variant, spec.structure,
                                       spec.temperature)
            self.entries.append((variant, feats, spec.eentropy,
                                 len(spec.structure)))
        self.to()

    def _arrays(self):
        return [e[1] for e in self.entries]

    def loss(self, params) -> torch.Tensor:
        total = self._zero()
        for model, feats, s_ref, n in self.entries:
            _, aux = model.energy_and_aux(feats, params)
            total = total + torch.abs(aux["eentropy"] - s_ref) / n * \
                self.weight
        return total


class ForceConstantsConstraint(_Constraint):
    """Second-order force constants of a supercell vs a phonopy fc2
    reference."""

    name = "hessian/c"

    def __init__(self, model, crystals: Sequence, weight: float = 1.0,
                 forces_weight: float = 1.0, base_dir: str = "."):
        super().__init__()
        self.weight = weight
        self.forces_weight = forces_weight
        self.entries = []
        for c in crystals:
            spec = get_crystal(c, base_dir)
            if spec.fc2 is None or spec.supercell is None:
                continue
            sc = spec.supercell
            variant = _variant_for(model, sc)
            fz = variant.featurizer
            vap = fz.make_vap(sc)
            feats = fz.featurize(sc, vap, layout=_layout(variant))
            self.entries.append(
                (variant, feats, {"idx": vap.local_to_vap.astype(np.int64),
                                  "fc2": np.asarray(spec.fc2)}))
        self.to()

    def _arrays(self):
        return [d for e in self.entries for d in e[1:]]

    def loss(self, params) -> torch.Tensor:
        create = torch.is_grad_enabled()
        total = self._zero()
        for model, feats, ref in self.entries:
            energy_fn = _energy_fn(model, params)
            h = make_hessian_fn(energy_fn, create)(feats)
            idx = ref["idx"]
            # phonopy layout [N, N, 3, 3]
            hp = h[idx][:, :, idx, :].permute(0, 2, 1, 3)
            diff = hp - ref["fc2"]
            total = total + torch.sqrt(torch.mean(torch.square(diff))
                                       + 1e-14) * self.weight
            efs = make_efs_fn(energy_fn, create)(feats)
            total = total + self.forces_weight * _safe_norm(
                efs["forces"] * feats["atom_masks"][:, None])
        return total


class ExtraDatabaseConstraint(_Constraint):
    """An auxiliary database of structures contributing fixed-batch
    energy/forces losses."""

    name = "extra/c"

    def __init__(self, model, filename: str, weight: float = 1.0,
                 minimize: Sequence[str] = ("energy",)):
        from ..io.sqlite import connect
        super().__init__()
        self.weight = weight
        self.minimize = tuple(minimize)
        structures = list(connect(filename))
        fz = model.featurizer
        max_occurs = Counter()
        for s in structures:
            for e, c in s.count().items():
                max_occurs[e] = max(max_occurs[e], c)
        self.variant = model.clone_for(max_occurs)
        layout = _layout(self.variant)
        sizes = [fz.neighbor_size(s) for s in structures]
        nij_max = max(z.nij for z in sizes)
        nnl_max = max(z.nnl_tot for z in sizes)
        ntl_max = (max(z.ntl for z in sizes) if fz.angular else None)
        feats_list, e_list, f_list, w_list = [], [], [], []
        for s in structures:
            vap = fz.make_vap(s, max_occurs)
            feats_list.append(fz.featurize(s, vap, layout=layout,
                                           nij_max=nij_max,
                                           nnl_max=nnl_max,
                                           ntl_max=ntl_max))
            e_list.append(s.energy if s.energy is not None else 0.0)
            f = s.forces
            f_list.append(vap.map_forces(f) if f is not None else
                          np.zeros((vap.n_atoms_vap, 3)))
            w_list.append(float(np.atleast_1d(
                s.info.get("weights", [1.0]))[0]))
        self.feats = batch_features(feats_list)
        # label-presence masks: rows without a stored energy/forces do
        # not contribute (a missing energy is NOT 0 eV)
        self.labels = {
            "energies": np.asarray(e_list), "forces": np.stack(f_list),
            "sample_weights": np.asarray(w_list),
            "has_energy": np.asarray(
                [1.0 if s.energy is not None else 0.0 for s in structures]),
            "has_forces": np.asarray(
                [1.0 if s.forces is not None else 0.0 for s in structures]),
            "n_atoms": np.asarray([float(len(s)) for s in structures])}
        self.to()

    def _arrays(self):
        return [self.feats, self.labels]

    def loss(self, params) -> torch.Tensor:
        efs = make_efs_fn(_energy_fn(self.variant, params),
                          torch.is_grad_enabled())(self.feats)
        lab = self.labels
        total = self._zero()
        if "energy" in self.minimize:
            diff = (efs["energy"] - lab["energies"]) / lab["n_atoms"]
            w = lab["sample_weights"] * lab["has_energy"]
            total = total + torch.sqrt(
                torch.sum(w * torch.square(diff)) /
                torch.clamp(torch.sum(lab["has_energy"]), min=1.0) + 1e-14)
        if "forces" in self.minimize:
            mask = (self.feats["atom_masks"][:, 1:] *
                    lab["has_forces"][:, None])
            d = (efs["forces"][:, 1:] - lab["forces"][:, 1:]) * \
                mask[..., None]
            total = total + torch.sqrt(
                torch.sum(torch.square(d)) /
                torch.clamp(torch.sum(mask) * 3.0, min=1.0) + 1e-14)
        return total * self.weight
