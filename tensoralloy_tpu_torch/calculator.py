"""Inference calculator over a saved model (port of
`tensoralloy_tpu/calculator.py`).

Energy, forces and stress come from one of these routes, by model and
request, as in the reference:

  * descriptor models (SF, GRAP, finite temperature) on host-built lists
    read the dense per-atom layout through the scatter-free
    `ops.dense.make_dense_efs_fn`: forces and stress differentiate the
    variational energy (the free energy F = U - TS of a
    finite-temperature model, at the electron temperature of
    `structure.info["etemperature"]`), and the atomic energies and
    finite-temperature heads come out of the same pass
    (`model.energy_and_aux`);
  * the EAM family with `fast_efs` (the default, "auto", unless
    `chunked=True`): the analytic energy, forces and stress of
    `nn.eam.fast_efs` on the dense layout;
  * otherwise autograd w.r.t. positions and cell (`nn.fields.make_efs_fn`):
    the EAM family on the flat pair ('segment') layout, and a dense
    descriptor model on device-built lists (which carry no transpose
    tables);
  * descriptor models on the flat ('segment') layout: autograd w.r.t.
    positions and cell of the pair and triple arrays;
  * `chunked`: the energy in rematerialized blocks (`energy_chunked`:
    atom rows of a descriptor model, flat pair blocks of the EAM family),
    differentiated by autograd. "auto" takes it when a frame's padded
    pairs exceed `chunk_auto_pairs` (8 times that on the dense layout).
    As in the reference, a model chunks only where it can: never on the
    fast EFS, a descriptor model only on the dense layout and never with
    the learned 'nn' GRAP filter.

`device_nl`: the neighbor list is built on the device
(`transform.device_nl.DeviceNeighborList`) instead of the host. "auto"
does so for a frame of `device_nl_auto_atoms` atoms or more when the
featurizer is not angular, sizing the builder from the density census;
True for every frame, with the exact census. Builders are cached per
(symbols, pbc) and reused while their stencil covers the cell; an
overflow grows and rebuilds up to 8 times, then raises.

Per-element counts are rounded up to powers of two and the host lists'
widths are bucketed (flat pairs from 256, `nnl` from 32, `ntl` from 64),
so a stream of structures reuses a few layouts; each layout gets a
re-laid-out model clone from a cache.
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .atoms import Structure
from .nn.fields import make_efs_fn, make_hessian_fn
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


class TensorAlloyCalculator:
    """Evaluate energy/forces/stress/Hessian of arbitrary structures.

    `model_or_path`: a saved `.npz`, or an `AtomicNN` (or a
    finite-temperature subclass) or an EAM-family model already on
    `device` in `dtype`.
    `device` is the card unless the caller passes "cpu"; "cuda" without
    a card raises.
    `dtype` is 'high' (float64), 'medium' (float32) or a torch float
    dtype; `backend` overrides the saved descriptor backend ('dense' =
    plain PyTorch, 'pallas' = the CUDA kernels) when loading from a
    path. `chunked`, `chunk_size`, `chunk_auto_pairs`, `device_nl`,
    `device_nl_auto_atoms` and `fast_efs` are the reference's, with its
    defaults (see the module docstring). `chunk_size`: pairs (EAM
    family) or atom rows (descriptor models) per block, 0 for the
    default (2^20 pairs, 4096 rows)."""

    implemented_properties = ("energy", "free_energy", "forces", "stress",
                              "pressure", "hessian", "atomic_energies")

    def __init__(self, model_or_path, *, device="cuda", dtype="high",
                 backend: Optional[str] = None,
                 chunked: "bool | str" = "auto", chunk_size: int = 0,
                 chunk_auto_pairs: int = 3_000_000,
                 device_nl: "bool | str" = "auto",
                 device_nl_auto_atoms: int = 8192,
                 fast_efs: "bool | str" = "auto"):
        for mode, value in (("chunked", chunked), ("device_nl", device_nl),
                            ("fast_efs", fast_efs)):
            if value is not True and value is not False and value != "auto":
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
        self.chunked = chunked
        self.chunk_size = int(chunk_size)
        self.chunk_auto_pairs = int(chunk_auto_pairs)
        self.device_nl = device_nl
        self.device_nl_auto_atoms = int(device_nl_auto_atoms)
        # the analytic EFS where the model supports it; "auto" leaves it
        # to an explicit chunked=True (the rematerialized autograd path)
        if fast_efs == "auto":
            self.fast_efs = is_eam_family(self.model) and chunked is not True
        else:
            self.fast_efs = fast_efs and is_eam_family(self.model)
        self.layout = model_feature_layout(self.model, fast=self.fast_efs)
        self.featurizer = self.model.featurizer
        self._variant_cache: Dict[tuple, tuple] = {}
        self._vap_cache: Dict[tuple, VirtualAtomMap] = {}
        self._nl_cache: Dict[tuple, object] = {}
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

    def _use_device_nl(self, structure: Structure) -> bool:
        """Resolve the device_nl mode against this structure."""
        if self.device_nl == "auto":
            # dense-triple capacities need the exact (host) census, which
            # costs what the auto route exists to avoid
            return (len(structure) >= self.device_nl_auto_atoms
                    and not getattr(self.featurizer, "angular", False))
        return bool(self.device_nl)

    def _get_variant(self, structure: Structure, use_device: bool = False):
        """(model clone, E/F/S function, chunked E/F/S function or None)
        for this structure's bucketed stoichiometry and list route."""
        occurs = self._bucketed_occurs(structure)
        key = (tuple(sorted(occurs.items())), bool(use_device))
        hit = self._variant_cache.get(key)
        if hit is None:
            model = self.model.clone_for(Counter(dict(key[0])))
            if self.fast_efs:
                from .nn.eam.fast_efs import make_fast_efs_fn
                efs = make_fast_efs_fn(model)
            elif self.layout == "dense" and not use_device:
                # the host lists carry the transpose tables of the
                # scatter-free force assembly
                efs = make_dense_efs_fn(model.energy_and_aux)
            else:
                efs = make_efs_fn(model.energy_and_aux)
            efs_chunked = None
            if self.chunked and self.can_chunk(model):   # "auto" or True
                efs_chunked = make_efs_fn(self._chunked_energy(
                    model, self.chunk_rows()))
            hit = (model, efs, efs_chunked)
            self._variant_cache[key] = hit
        return hit

    def can_chunk(self, model) -> bool:
        """Whether `model` has a chunked route here (the reference's
        `can_chunk`): not on the fast EFS; the EAM family where it has
        `make_chunked_energy_fn`; a descriptor model on the dense layout
        without the learned 'nn' filter."""
        if self.fast_efs:
            return False
        desc = getattr(model, "descriptor", None)
        if desc is None:
            return hasattr(model, "make_chunked_energy_fn")
        return (self.layout == "dense"
                and getattr(desc, "algorithm", None) != "nn")

    def chunk_rows(self) -> int:
        """Pairs (the flat layout) or atom rows (dense) a block."""
        return self.chunk_size or (1 << 20 if self.layout == "segment"
                                   else 4096)

    @staticmethod
    def _chunked_energy(model, chunk: int) -> Callable:
        """features -> (chunked variational energy, by-products): the
        finite-temperature heads ride along; the atomic energies are
        monolithic-only."""
        if hasattr(model, "heads_chunked"):
            def energy_fn(features):
                heads = model.heads_chunked(features, atom_chunk=chunk)
                return heads["free_energy"], heads
            return energy_fn
        e_fn = model.make_chunked_energy_fn(chunk)
        return lambda features: (e_fn(features), {})

    @staticmethod
    def _padded_pairs(feats) -> int:
        if "pair_j_d" in feats:
            a, n = feats["pair_j_d"].shape
            t = (feats["trip_j_d"].shape[0] * feats["trip_j_d"].shape[1]
                 if "trip_j_d" in feats else 0)
            return a * n + t
        if "pair_i" in feats:
            t = feats["trip_i"].shape[0] if "trip_i" in feats else 0
            return int(feats["pair_i"].shape[0]) + t
        return 0

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

    def featurize(self, structure: Structure, vap: VirtualAtomMap,
                  layout: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """Host featurization -> tensors on the calculator's device.
        `layout` overrides the served layout (no transpose tables then)."""
        np_dtype = np.float64 if self.dtype == torch.float64 else np.float32
        feats = self.featurizer.featurize(
            structure, vap, layout=layout or self.layout,
            pair_bucket=lambda n: _bucket(max(n, 1)),
            trip_bucket=lambda n: _bucket(max(n, 1)),
            # per-atom neighbor/triple WIDTHS are far smaller than flat
            # counts: a 256-minimum bucket would pad every row 2-8x
            nnl_bucket=lambda n: _bucket(max(n, 1), minimum=32),
            ntl_bucket=lambda n: _bucket(max(n, 1), minimum=64),
            dtype=np_dtype,
            # the transpose tables feed the dense descriptor EFS only
            transpose=(layout is None and self.layout == "dense"
                       and not self.fast_efs))
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in feats.items()}

    @staticmethod
    def _nl_key(structure: Structure) -> tuple:
        return tuple(structure.symbols), np.asarray(structure.pbc).tobytes()

    def device_builder(self, structure: Structure, vap: VirtualAtomMap):
        """The cached `DeviceNeighborList` of this structure's (symbols,
        pbc), made anew when missing or when its stencil no longer
        covers the cell."""
        from .transform.device_nl import DeviceNeighborList
        key = self._nl_key(structure)
        b = self._nl_cache.get(key)
        if b is None or not b.covers(structure.cell):
            b = DeviceNeighborList(
                self.featurizer, vap, structure, layout=self.layout,
                # one-shot auto routing must not pay a host neighbor list
                # to size the capacities; device_nl=True (trajectories)
                # keeps the exact census that it amortizes
                census="density" if self.device_nl == "auto" else "exact")
            self._nl_cache[key] = b
        return b

    def featurize_device(self, structure: Structure, vap: VirtualAtomMap
                         ) -> Dict[str, torch.Tensor]:
        """Features built on the device: the positions are mapped and
        copied, the cached builder runs, and its diagnostics are read
        once; an overflow grows the builder (up to 8 times)."""
        from .transform.device_nl import diag_to_host
        b = self.device_builder(structure, vap)
        pos = torch.as_tensor(vap.map_positions(structure.positions),
                              dtype=self.dtype, device=self.device)
        cell = torch.as_tensor(structure.cell, dtype=self.dtype,
                               device=self.device)
        etemp = float(structure.info.get("etemperature", 0.0) or 0.0)
        for _ in range(8):
            feats, diag = b.build(pos, cell, etemp)
            diag = diag_to_host(diag)
            try:
                b.check(diag)
                return feats
            except RuntimeError:
                if diag["simg_overflow"] > 0:
                    raise
                b = b.grow(diag)
                self._nl_cache[self._nl_key(structure)] = b
        b.check(diag)
        return feats

    # ------------------------------------------------------------------
    def calculate(self, structure: Structure) -> Dict[str, np.ndarray]:
        vap = self._get_vap(structure)
        use_device = self._use_device_nl(structure)
        _, efs, efs_chunked = self._get_variant(structure, use_device)
        feats = (self.featurize_device(structure, vap) if use_device
                 else self.featurize(structure, vap))
        # chunk_auto_pairs is sized for the flat layout's backward; the
        # dense rows hold about 8x less a padded pair
        auto_pairs = self.chunk_auto_pairs * (
            8 if "pair_j_d" in feats else 1)
        use_chunked = efs_chunked is not None and (
            self.chunked is True or self._padded_pairs(feats) > auto_pairs)
        out = (efs_chunked if use_chunked else efs)(feats)
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
        }
        if "atomic_energies" in out:    # monolithic routes only
            results["atomic_energies"] = vap.reverse_map(
                out["atomic_energies"])
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
        results = self._maybe_calculate(structure)
        if "atomic_energies" not in results:
            raise ValueError(
                "per-atom energies are not computed on the chunked "
                "large-cell path; construct the calculator with "
                "chunked=False (needs the monolithic working set)")
        return results["atomic_energies"]

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
        """d^2E/dR^2 [3N, 3N] (or phonopy's [N, N, 3, 3]) by autograd of
        the variational energy, on host lists in the layout the model
        reads (the flat pairs for the EAM family, even where the fast EFS
        serves the first derivatives)."""
        vap = self._get_vap(structure)
        model = self._get_variant(structure)[0]
        feats = self.featurize(structure, vap,
                               layout=model_feature_layout(self.model))
        h = make_hessian_fn(model.energy_and_aux)(feats)
        return vap.reverse_map_hessian(h.cpu().numpy(),
                                       phonopy_format=phonopy_format)

    # ------------------------------------------------------------------
    def as_ase_calculator(self):
        """An ASE `Calculator` over this one (needs `ase`)."""
        from ase.calculators.calculator import Calculator, all_changes

        outer = self

        class _Adapter(Calculator):
            implemented_properties = ["energy", "free_energy", "forces",
                                      "stress"]

            def calculate(self, atoms=None, properties=("energy",),
                          system_changes=all_changes):
                super().calculate(atoms, properties, system_changes)
                s = Structure(atoms.numbers, atoms.positions,
                              np.asarray(atoms.cell), atoms.pbc)
                self.results = dict(outer.calculate(s))

        return _Adapter()
