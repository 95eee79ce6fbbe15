"""Inference calculator over a saved model (port of the host-neighbor-list
dense path of `tensoralloy_tpu/calculator.py`).

Structures are featurized on the host (numpy) into the dense per-atom
layout, moved to `device`, and energy, forces and stress come from the
scatter-free `ops.dense.make_dense_efs_fn`: forces and stress
differentiate the model's variational energy (the free energy F = U - TS
of a finite-temperature model, at the electron temperature the
featurizer reads from `structure.info["etemperature"]`), and the atomic
energies and finite-temperature heads come out of the same pass
(`model.energy_and_aux`): a request evaluates its descriptors once. Per-element
counts are rounded up to powers of two and the dense row widths are
bucketed (`nnl` from 32, `ntl` from 64), so a stream of structures
reuses a few layouts; each layout gets a re-laid-out model clone from a
cache.

Not ported yet: the on-device neighbor list (`device_nl`), the
row-chunked large-cell path (`chunked`), the analytic EAM EFS
(`fast_efs`) and `get_hessian`.
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .atoms import Structure
from .ops.dense import make_dense_efs_fn
from .precision import resolve_device, resolve_dtype
from .vap import VirtualAtomMap


def _bucket(n: int, minimum: int = 256) -> int:
    size = minimum
    while size < n:
        size *= 2
    return size


def _not_ported(mode: str, slice_name: str):
    return NotImplementedError(
        f"{mode} is not ported to tensoralloy_tpu_torch yet; it comes "
        f"with {slice_name}")


class TensorAlloyCalculator:
    """Evaluate energy/forces/stress of arbitrary structures.

    `model_or_path`: a saved `.npz` or an `AtomicNN` (or a
    finite-temperature subclass), already on `device` in `dtype`.
    `device` is the card unless the caller passes "cpu"; "cuda" without
    a card raises.
    `dtype` is 'high' (float64), 'medium' (float32) or a torch float
    dtype; `backend` overrides the saved descriptor backend ('dense' =
    plain PyTorch, 'pallas' = the CUDA kernels) when loading from a
    path. `chunked`, `device_nl` and `fast_efs` take the reference's
    values; "auto" and False evaluate on the host-built lists in one
    piece, True raises until those paths are ported."""

    implemented_properties = ("energy", "free_energy", "forces", "stress",
                              "pressure", "atomic_energies")

    def __init__(self, model_or_path, *, device="cuda", dtype="high",
                 backend: Optional[str] = None,
                 chunked: "bool | str" = "auto",
                 device_nl: "bool | str" = "auto",
                 fast_efs: "bool | str" = "auto"):
        # "auto" (the reference's default) and False take the monolithic
        # host-list path, the only one ported; True asks for a path that
        # is not there yet
        for mode, value, slice_name in (
                ("chunked evaluation", chunked, "the large-cell slice"),
                ("device_nl", device_nl, "the EAM/MD slice (slice 3)"),
                ("fast_efs", fast_efs, "the EAM/MD slice (slice 3)")):
            if value is True:
                raise _not_ported(mode, slice_name)
            if value is not False and value != "auto":
                raise ValueError(f"{mode}: expected True, False or "
                                 f"'auto', got {value!r}")
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        if isinstance(model_or_path, str):
            from .io.model import load_model
            self.model, self.config = load_model(
                model_or_path, device=self.device, dtype=self.dtype,
                backend=backend)
        elif backend is not None:
            raise ValueError("backend= applies to a saved model path; "
                             "set the descriptor's backend on a model")
        else:
            self.model, self.config = model_or_path, {}
        # serving differentiates w.r.t. geometry only
        self.model.requires_grad_(False)
        self.featurizer = self.model.featurizer
        self._efs_cache: Dict[tuple, Callable] = {}
        self._vap_cache: Dict[tuple, VirtualAtomMap] = {}
        self.results: Dict[str, np.ndarray] = {}
        self._last = None

    @property
    def elements(self):
        return self.featurizer.elements

    # ------------------------------------------------------------------
    def _bucketed_occurs(self, structure: Structure) -> Counter:
        """Round per-element counts up to powers of two: bounds the
        number of distinct layouts for MD/scan workloads."""
        unknown = set(structure.symbols) - set(self.elements)
        if unknown:
            raise ValueError(
                f"structure contains element(s) {sorted(unknown)} not "
                f"supported by this model (elements: {self.elements})")
        out = Counter()
        for e, c in Counter(structure.symbols).items():
            b = 1
            while b < c:
                b *= 2
            out[e] = b
        return out

    def _get_efs(self, structure: Structure) -> Callable:
        """E/F/S function of the model re-laid-out for this structure's
        bucketed stoichiometry (cached per layout)."""
        key = tuple(sorted(self._bucketed_occurs(structure).items()))
        efs = self._efs_cache.get(key)
        if efs is None:
            model = self.model.clone_for(Counter(dict(key)))
            efs = make_dense_efs_fn(model.energy_and_aux)
            self._efs_cache[key] = efs
        return efs

    def _get_vap(self, structure: Structure) -> VirtualAtomMap:
        # keyed by the exact symbol sequence: the local->VAP index map
        # depends on atom order, not just the reduced formula
        key = tuple(structure.symbols)
        vap = self._vap_cache.get(key)
        if vap is None:
            vap = VirtualAtomMap(self._bucketed_occurs(structure),
                                 structure.symbols)
            self._vap_cache[key] = vap
        return vap

    def featurize(self, structure: Structure, vap: VirtualAtomMap
                  ) -> Dict[str, torch.Tensor]:
        """Host featurization -> tensors on the calculator's device."""
        np_dtype = np.float64 if self.dtype == torch.float64 else np.float32
        feats = self.featurizer.featurize(
            structure, vap,
            # per-atom neighbor/triple WIDTHS are far smaller than flat
            # counts: a 256-minimum bucket would pad every row 2-8x
            nnl_bucket=lambda n: _bucket(max(n, 1), minimum=32),
            ntl_bucket=lambda n: _bucket(max(n, 1), minimum=64),
            dtype=np_dtype, transpose=True)
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in feats.items()}

    # ------------------------------------------------------------------
    def calculate(self, structure: Structure) -> Dict[str, np.ndarray]:
        vap = self._get_vap(structure)
        out = self._get_efs(structure)(self.featurize(structure, vap))
        self.results = self._assemble(
            {k: v.detach().cpu().numpy() for k, v in out.items()}, vap)
        self._last = self._fingerprint(structure)
        return self.results

    @staticmethod
    def _assemble(out, vap) -> Dict[str, np.ndarray]:
        results = {
            "energy": float(out["energy"]),
            "free_energy": float(out.get("free_energy", out["energy"])),
            "forces": vap.reverse_map(out["forces"]),
            "stress": np.asarray(out["stress_voigt"]),
            "pressure": float(out["total_pressure"]),
            "atomic_energies": vap.reverse_map(out["atomic_energies"]),
        }
        if "eentropy" in out:        # finite-temperature heads
            results["eentropy"] = float(out["eentropy"])
        return results

    @staticmethod
    def _fingerprint(structure: Structure):
        """Cheap content fingerprint: identity caching returns stale
        results when the same Structure instance is mutated in place
        (e.g. by an MD/relaxation driver) between calls."""
        etemp = structure.info.get("etemperature", 0.0)
        return (structure.numbers.tobytes(),
                structure.positions.tobytes(),
                structure.cell.tobytes(),
                structure.pbc.tobytes(), float(etemp or 0.0))

    def _maybe_calculate(self, structure: Optional[Structure]):
        if structure is not None:
            if self._fingerprint(structure) != self._last:
                self.calculate(structure)
        if not self.results:
            raise RuntimeError(
                "no structure has been calculated yet — pass a "
                "Structure to the getter or call calculate() first")
        return self.results

    # ------------------------------------------------------------------
    def get_potential_energy(self, structure: Optional[Structure] = None
                             ) -> float:
        return self._maybe_calculate(structure)["energy"]

    def get_forces(self, structure: Optional[Structure] = None
                   ) -> np.ndarray:
        return self._maybe_calculate(structure)["forces"]

    def get_stress(self, structure: Optional[Structure] = None
                   ) -> np.ndarray:
        return self._maybe_calculate(structure)["stress"]

    def get_total_pressure(self, structure: Optional[Structure] = None
                           ) -> float:
        return self._maybe_calculate(structure)["pressure"]

    def get_atomic_energies(self, structure: Optional[Structure] = None
                            ) -> np.ndarray:
        return self._maybe_calculate(structure)["atomic_energies"]

    def get_electron_entropy(self, structure: Optional[Structure] = None
                             ) -> float:
        results = self._maybe_calculate(structure)
        if "eentropy" not in results:
            raise ValueError(
                "this model has no electron-entropy head (the finite-"
                "temperature models provide one)")
        return results["eentropy"]

    def get_free_energy(self, structure: Optional[Structure] = None
                        ) -> float:
        return self._maybe_calculate(structure)["free_energy"]

    def get_hessian(self, structure: Structure,
                    phonopy_format: bool = False) -> np.ndarray:
        raise _not_ported("get_hessian", "the analysis slice (slice 4)")
