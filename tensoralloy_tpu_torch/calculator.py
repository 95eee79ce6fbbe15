"""Inference calculator over a saved model (port of the host-neighbor-list
path of `tensoralloy_tpu/calculator.py`).

Structures are featurized on the host (numpy), moved to `device`, and
energy, forces and stress come from one of three routes, by model:

  * descriptor models (SF, GRAP, finite temperature) read the dense
    per-atom layout through the scatter-free `ops.dense.make_dense_efs_fn`:
    forces and stress differentiate the variational energy (the free
    energy F = U - TS of a finite-temperature model, at the electron
    temperature the featurizer reads from `structure.info
    ["etemperature"]`), and the atomic energies and finite-temperature
    heads come out of the same pass (`model.energy_and_aux`);
  * the EAM family with `fast_efs` (the default, "auto"): the analytic
    energy, forces and stress of `nn.eam.fast_efs` on the dense layout;
  * the EAM family with `fast_efs=False`: autograd of the energy on the
    flat pair ('segment') layout (`nn.fields.make_efs_fn`), whose
    per-atom sums are `index_add`s.

Per-element counts are rounded up to powers of two and the widths are
bucketed (flat pairs from 256, `nnl` from 32, `ntl` from 64), so a
stream of structures reuses a few layouts; each layout gets a
re-laid-out model clone from a cache.

Not ported yet: the on-device neighbor list (`device_nl=True`), the
chunked large-cell path (`chunked=True`) and `get_hessian`.
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .atoms import Structure
from .nn.fields import make_efs_fn
from .ops.dense import make_dense_efs_fn
from .precision import resolve_device, resolve_dtype
from .vap import VirtualAtomMap


def is_eam_family(model) -> bool:
    """True only for CONCRETE EamNN models whose variational energy is
    the plain EAM energy, which the analytic fast path reimplements; a
    wrapper that changes the energy never takes that path."""
    from .nn.eam.models import EamNN
    if not isinstance(model, EamNN):
        return False
    return getattr(type(model), "variational_energy", None) \
        is EamNN.variational_energy


def model_feature_layout(model, fast: bool = False) -> str:
    """The feature layout a model reads: 'segment' for the EAM family,
    'dense' for the descriptor models; `fast=True` selects the dense
    layout for the EAM family too (the analytic fast EFS reads it)."""
    if fast and is_eam_family(model):
        return "dense"
    descriptor = getattr(model, "descriptor", None)
    backend = getattr(descriptor, "backend", "segment")
    return "segment" if backend == "segment" else "dense"


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

    `model_or_path`: a saved `.npz`, or an `AtomicNN` (or a
    finite-temperature subclass) or an EAM-family model already on
    `device` in `dtype`.
    `device` is the card unless the caller passes "cpu"; "cuda" without
    a card raises.
    `dtype` is 'high' (float64), 'medium' (float32) or a torch float
    dtype; `backend` overrides the saved descriptor backend ('dense' =
    plain PyTorch, 'pallas' = the CUDA kernels) when loading from a
    path. `chunked`, `device_nl` and `fast_efs` take the reference's
    values. `fast_efs`: "auto" (the default) and True serve the EAM
    family through the analytic EFS on the dense layout, False through
    autograd on the flat pair layout; other models ignore it. `chunked`
    and `device_nl`: "auto" and False evaluate on the host-built lists in
    one piece, True raises until those paths are ported."""

    implemented_properties = ("energy", "free_energy", "forces", "stress",
                              "pressure", "atomic_energies")

    def __init__(self, model_or_path, *, device="cuda", dtype="high",
                 backend: Optional[str] = None,
                 chunked: "bool | str" = "auto",
                 device_nl: "bool | str" = "auto",
                 fast_efs: "bool | str" = "auto"):
        for mode, value in (("chunked", chunked), ("device_nl", device_nl),
                            ("fast_efs", fast_efs)):
            if value is not True and value is not False and value != "auto":
                raise ValueError(f"{mode}: expected True, False or "
                                 f"'auto', got {value!r}")
        # "auto" (the reference's default) and False take the monolithic
        # host-list path; True asks for a path that is not there yet
        if chunked is True:
            raise _not_ported("chunked evaluation", "the large-cell slice")
        if device_nl is True:
            raise _not_ported("device_nl", "the MD slice (slice 3b)")
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
        # the analytic EFS where the model supports it: "auto" and True
        # alike (the reference's rule, with chunked=True never taken)
        self.fast_efs = fast_efs is not False and is_eam_family(self.model)
        self.layout = model_feature_layout(self.model, fast=self.fast_efs)
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
            if self.fast_efs:
                from .nn.eam.fast_efs import make_fast_efs_fn
                efs = make_fast_efs_fn(model)
            elif self.layout == "segment":
                efs = make_efs_fn(model.energy_and_aux)
            else:
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
            structure, vap, layout=self.layout,
            pair_bucket=lambda n: _bucket(max(n, 1)),
            # per-atom neighbor/triple WIDTHS are far smaller than flat
            # counts: a 256-minimum bucket would pad every row 2-8x
            nnl_bucket=lambda n: _bucket(max(n, 1), minimum=32),
            ntl_bucket=lambda n: _bucket(max(n, 1), minimum=64),
            dtype=np_dtype,
            # the transpose tables feed the dense descriptor EFS only
            transpose=self.layout == "dense" and not self.fast_efs)
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
        raise _not_ported("get_hessian", "the large-cell and Hessian "
                          "slice (ROADMAP queue 1, item 7)")
