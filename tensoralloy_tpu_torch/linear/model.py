"""Linear moment-tensor potentials (port of
`tensoralloy_tpu/linear/model.py`; reference `tensoralloy/linear/`).

The model is linear in its coefficients,
E = sum_e [ sum_{i in e} G_i . c_e + N_e b_e ], with G the GRAP
moment-tensor invariants. The design-matrix rows of the forces and the
virial are the derivatives of the per-element feature sums S [n_coef]
w.r.t. the positions and a homogeneous strain: one forward pass of the
descriptor for the energy and force rows (one launch of `grap_kernel` on
the card; its plain twin on CPU tensors; one more for the virial rows)
and one vector-Jacobian product batched over the n_coef one-hot
cotangents, split at the descriptors: the sums' cotangents give
[n_coef, A, F] descriptor cotangents, `grap_vjp_kernel` takes them in
one launch (B = n_coef, `ops.fused.descriptor_vjp`) and the geometry
carries them to the positions or the strain.

A fitted model is exported as a zero-hidden-layer `AtomicNN`, so the
whole calculator / saved-model stack applies unchanged.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..atoms import Structure
from ..nn.atomic import AtomicNN
from ..nn.grap import GenericRadialAtomicPotential
from ..ops.fused import descriptor_vjp, record_calls
from ..precision import resolve_device, resolve_dtype
from ..transform.featurizer import Featurizer

# named radial-filter presets (reference `linear/preset.py`)
PRESETS: Dict[str, dict] = {
    "pexp16": {"algorithm": "pexp",
               "parameters": {
                   "rl": [1.0, 1.2, 1.4, 1.6, 1.8, 2.0, 2.2, 2.4, 2.6,
                          2.8, 3.0, 3.2, 3.4, 3.6, 3.8, 4.0],
                   "pl": [5.0, 4.75, 4.5, 4.25, 4.0, 3.75, 3.5, 3.25,
                          3.0, 2.75, 2.5, 2.25, 2.0, 1.75, 1.5, 1.25]}},
    "pexp8": {"algorithm": "pexp",
              "parameters": {
                  "rl": [1.0, 1.4, 1.8, 2.2, 2.6, 3.0, 3.4, 3.8],
                  "pl": [4.0, 3.5, 3.0, 2.75, 2.5, 2.25, 2.0, 1.5]}},
    "sf4": {"algorithm": "sf",
            "parameters": {"eta": [0.5, 1.0, 4.0, 20.0],
                           "omega": [0.0, 0.0, 0.0, 0.0]}},
}


class LinearTensorMD:
    """Least-squares-fitted linear moment-tensor potential.

    `device` is the card unless the caller passes "cpu"; `dtype` 'high'
    (float64, the default, as the fit needs) or 'medium'. The descriptor
    takes the kernels ('pallas': the CUDA kernel on the card, its plain
    twin on CPU tensors); the JAX class uses its 'segment' backend, which
    equals it to round-off."""

    def __init__(self, elements: Sequence[str], rcut: float = 6.0,
                 preset: str = "pexp8", max_moment: int = 3,
                 symmetric: bool = False, *, device="cuda",
                 dtype="high", backend: str = "pallas"):
        self.elements = sorted(elements)
        self.rcut = float(rcut)
        self.preset = preset
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        if "@" in preset:  # reference-named bank, e.g. 'pexp@medium'
            from .preset import get_filter_preset
            cfg = dict(get_filter_preset(preset))
        else:
            cfg = dict(PRESETS[preset], param_space_method="pair")
        self.featurizer = Featurizer(self.elements, rcut=rcut)
        self.descriptor = GenericRadialAtomicPotential(
            self.elements, algorithm=cfg["algorithm"],
            parameters=cfg["parameters"],
            param_space_method=cfg["param_space_method"],
            moment_tensors=list(range(max_moment + 1)),
            symmetric=symmetric, backend=backend)
        self.max_moment = max_moment
        self.n_features = self.descriptor.feature_dim(
            self.featurizer.n_radial_slots, 0, False)
        # per element: n_features coefficients + 1 bias
        self.n_coef = len(self.elements) * (self.n_features + 1)
        self.coef_: Optional[np.ndarray] = None
        self._models: Dict[tuple, AtomicNN] = {}

    def _atomic_nn(self, max_occurs: Counter) -> AtomicNN:
        return AtomicNN(self.featurizer, max_occurs, self.descriptor,
                        hidden_sizes=[], minmax_scale=False,
                        device=self.device, dtype=self.dtype)

    # ------------------------------------------------------------------
    def _feature_sums(self, model: AtomicNN, feats, g=None
                      ) -> torch.Tensor:
        """[n_coef] per-element feature sums (+ atom counts for the bias
        columns) of the descriptors `g` [n_vap, D] (the model's on
        `feats` when None)."""
        if g is None:
            g = model.descriptors(feats)
        masks = feats["atom_masks"]
        cols = []
        for e in self.elements:
            lo, cnt = model.layout[e]
            me = masks[lo:lo + cnt]
            cols.append(torch.sum(g[lo:lo + cnt] * me[:, None], dim=0))
            cols.append(torch.sum(me)[None])
        return torch.cat(cols)

    def _sums_and_jacobian(self, model: AtomicNN, feats, x: torch.Tensor
                           ) -> tuple:
        """-> (S [n_coef], dS/dx [n_coef, *x.shape]) of the feature sums
        of `feats`, `x` what `feats` was computed from: one VJP per
        one-hot cotangent, batched and split at the descriptors (the bias
        columns' rows come back zero)."""
        with torch.enable_grad():
            with record_calls() as calls:
                g = model.descriptors(feats)
            g_leaf = g.detach().requires_grad_()
            s = self._feature_sums(model, feats, g_leaf)
            eye = torch.eye(s.shape[0], dtype=s.dtype, device=s.device)
            g_bar, = torch.autograd.grad(s, g_leaf, eye,
                                         is_grads_batched=True)
            jac, = descriptor_vjp(g, g_bar, calls, [x])
        return s.detach(), jac

    def _model_for(self, occurs: Counter) -> AtomicNN:
        key = tuple(sorted(occurs.items()))
        model = self._models.get(key)
        if model is None:
            model = self._atomic_nn(Counter(dict(key)))
            self._models[key] = model
        return model

    def design_rows(self, structure: Structure,
                    with_forces: bool = True, with_virial: bool = False
                    ) -> Dict[str, np.ndarray]:
        """Design-matrix rows and labels for one structure."""
        occurs = Counter(structure.symbols)
        model = self._model_for(occurs)
        fz = self.featurizer
        vap = fz.make_vap(structure, occurs)
        np_dtype = np.float64 if self.dtype == torch.float64 \
            else np.float32
        feats = {k: torch.as_tensor(v, device=self.device)
                 for k, v in fz.featurize(structure, vap, dtype=np_dtype,
                                          layout="dense").items()}
        forces = with_forces and structure.forces is not None
        # the energy row and the force rows from one forward pass
        if forces:
            pos = feats["positions"].detach().requires_grad_()
            s, jac = self._sums_and_jacobian(model,
                                             dict(feats, positions=pos), pos)
            jac = -jac                               # [n_coef, n_vap, 3]
        else:
            s = self._feature_sums(model, feats)
        out = {"energy_row": s.detach().cpu().numpy().astype(np.float64),
               "energy": structure.energy}
        if forces:
            local = jac.cpu().numpy().astype(np.float64)[
                :, vap.local_to_vap, :]               # [n_coef, N, 3]
            out["force_rows"] = local.reshape(self.n_coef, -1).T
            out["forces"] = structure.forces.reshape(-1)
        if with_virial and structure.stress is not None:
            pos0, cell0 = feats["positions"], feats["cell"]
            with torch.enable_grad():
                eps6 = torch.zeros(6, dtype=pos0.dtype, device=pos0.device,
                                   requires_grad=True)
                e = torch.stack([
                    torch.stack([eps6[0], eps6[5] / 2, eps6[4] / 2]),
                    torch.stack([eps6[5] / 2, eps6[1], eps6[3] / 2]),
                    torch.stack([eps6[4] / 2, eps6[3] / 2, eps6[2]])])
                m = torch.eye(3, dtype=pos0.dtype, device=pos0.device) + e
                _, vir = self._sums_and_jacobian(
                    model, dict(feats, positions=pos0 @ m.T,
                                cell=cell0 @ m.T), eps6)   # [n_coef, 6]
            out["virial_rows"] = (vir.cpu().numpy().astype(np.float64).T
                                  / structure.volume)
            out["stress"] = np.asarray(structure.stress)
        return out

    # ------------------------------------------------------------------
    def fit(self, structures: Sequence[Structure],
            energy_weight: float = 1.0, forces_weight: float = 1.0,
            stress_weight: float = 0.0, per_atom_energy: bool = True,
            method: str = "ridge", alpha: float = 1e-8) -> dict:
        rows, targets, weights = [], [], []
        for s in structures:
            d = self.design_rows(
                s, with_forces=forces_weight > 0,
                with_virial=stress_weight > 0)
            scale = 1.0 / len(s) if per_atom_energy else 1.0
            if d["energy"] is not None:
                rows.append(d["energy_row"] * scale)
                targets.append(d["energy"] * scale)
                weights.append(energy_weight)
            if forces_weight > 0 and "force_rows" in d:
                rows.extend(d["force_rows"])
                targets.extend(d["forces"])
                weights.extend([forces_weight] * len(d["forces"]))
            if stress_weight > 0 and "virial_rows" in d:
                rows.extend(d["virial_rows"])
                targets.extend(d["stress"])
                weights.extend([stress_weight] * 6)
        a = np.asarray(rows)
        b = np.asarray(targets)
        w = np.sqrt(np.asarray(weights))
        aw = a * w[:, None]
        bw = b * w
        if method == "lstsq":
            coef = np.linalg.lstsq(aw, bw, rcond=None)[0]
        elif method == "ridge":
            ata = aw.T @ aw + alpha * np.eye(self.n_coef)
            coef = np.linalg.solve(ata, aw.T @ bw)
        elif method == "elasticnet":
            from sklearn.linear_model import ElasticNet
            reg = ElasticNet(alpha=alpha, fit_intercept=False,
                             max_iter=50000)
            reg.fit(aw, bw)
            coef = reg.coef_
        else:
            raise ValueError(method)
        self.coef_ = coef
        resid = a @ coef - b
        return {"rmse": float(np.sqrt(np.mean(resid ** 2))),
                "n_rows": len(b), "n_coef": self.n_coef}

    # ------------------------------------------------------------------
    def to_atomic_nn(self, max_occurs: Counter) -> AtomicNN:
        """The fitted linear model as a 0-hidden-layer AtomicNN (weights
        = coefficients, bias = per-element constant) on this model's
        device, so the standard calculator / export stack applies (the
        JAX method returns (model, params); here the weights are the
        module's)."""
        if self.coef_ is None:
            raise RuntimeError("fit() first")
        model = self._atomic_nn(max_occurs)
        per = self.n_features + 1
        tree = {}
        for idx, e in enumerate(self.elements):
            block = self.coef_[idx * per:(idx + 1) * per]
            tree[e] = {"mlp": {"layers": [{"w": block[:-1][:, None],
                                           "b": block[-1:]}]}}
        model.load_param_tree(tree)
        return model

    def predict(self, structure: Structure) -> Dict[str, np.ndarray]:
        calc = TensorMDPythonCalculator(self)
        return calc.calculate(structure)

    def export(self, path: str):
        """Save in the standard saved-model format (the .npz saved
        model is this framework's deployable artifact; see
        `export_tensormd` for the external-engine blob)."""
        from ..io.model import save_model
        occurs = Counter({e: 1 for e in self.elements})
        save_model(path, self.to_atomic_nn(occurs),
                   extra_metadata={"linear_tensor_md": True,
                                   "preset": self.preset})

    def export_tensormd(self, path: str, precision: int = 64):
        """Export the fitted model for the external TensorMD engine
        (LAMMPS `pair_style tensoralloy/native`) using the reference's
        npz key contract (`linear/model.py:666-707`): rmax/nelt/masses/
        numbers + descriptor::rl/pl + per-element weights_i_0 (the
        n_features coefficients) and biases_i_0 (the static energy).
        Only pexp banks are representable (descriptor::type 0)."""
        if self.coef_ is None:
            raise RuntimeError("fit() first")
        if self.descriptor.algorithm != "pexp":
            raise ValueError(
                "TensorMD engine export supports pexp filter banks only")
        dtype = np.float64 if precision == 64 else np.float32
        from ..elements import atomic_masses, atomic_numbers
        params = self.descriptor.parameters
        chars = [ord(ch) for elt in self.elements for ch in elt]
        data = {
            "rmax": dtype(self.rcut),
            "nelt": np.int32(len(self.elements)),
            "masses": np.array(
                [atomic_masses[atomic_numbers[e]] for e in self.elements],
                dtype=dtype),
            "numbers": np.array(chars, dtype=np.int32),
            "tdnp": np.int32(0),
            "precision": precision,
            "use_fnn": np.int32(0),
            "descriptor::rl": np.array(params["rl"], dtype=dtype),
            "descriptor::pl": np.array(params["pl"], dtype=dtype),
            "descriptor::type": np.int32(0),
            "nlayers": np.int32(0),
            "max_moment": np.int32(self.max_moment),
            "actfn": np.int32(0),
            "fctype": np.int32(0),
            "layer_sizes": np.array([0], dtype=np.int32),
            "use_resnet_dt": np.int32(0),
            "apply_output_bias": np.int32(1),
        }
        per = self.n_features + 1
        for i, _ in enumerate(self.elements):
            block = self.coef_[i * per:(i + 1) * per]
            data[f"weights_{i}_0"] = np.asarray(block[:-1], dtype=dtype)
            data[f"biases_{i}_0"] = np.asarray(block[-1:], dtype=dtype)
        np.savez(path, **data)
        return data


class TensorMDPythonCalculator:
    """Calculator over a fitted `LinearTensorMD` (reference
    `linear/model.py:710-874`), on the linear model's device."""

    def __init__(self, model: LinearTensorMD):
        self.linear = model
        self._calc = None

    def calculate(self, structure: Structure) -> Dict[str, np.ndarray]:
        from ..calculator import TensorAlloyCalculator
        if self._calc is None:
            occurs = Counter({e: 1 for e in self.linear.elements})
            self._calc = TensorAlloyCalculator(
                self.linear.to_atomic_nn(occurs),
                device=self.linear.device, dtype=self.linear.dtype)
        return self._calc.calculate(structure)

    def get_potential_energy(self, structure: Structure) -> float:
        return self.calculate(structure)["energy"]

    def get_forces(self, structure: Structure) -> np.ndarray:
        return self.calculate(structure)["forces"]

    def get_stress(self, structure: Structure) -> np.ndarray:
        return self.calculate(structure)["stress"]
