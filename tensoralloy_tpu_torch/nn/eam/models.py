"""EAM-family potential models: EAM/alloy, EAM/Finnis-Sinclair, ADP
(port of `tensoralloy_tpu/nn/eam/models.py`).

  E_i = F_a(rho_i) + 1/2 sum_j phi_ab(r_ij)                    (alloy/fs)
  rho_i = sum_j rho_b(r_ij)            (alloy: neighbor element only)
  rho_i = sum_j rho_ab(r_ij)           (fs: ordered element pair)
  ADP adds per (merged symmetric) k-body term t:
    mu_t^a    = sum_{j in t} u_t(r_ij) d_ij^a
    lam_t^ab  = sum_{j in t} w_t(r_ij) d_ij^a d_ij^b
    E_i += 1/2 sum_a mu^2 + 1/2 sum_{a<=b} c_ab lam_ab^2 - 1/6 nu^2
  with c_ab = 1 (a==b) else 2 and nu = trace(lam). The dipole and
  quadrupole sums are grouped per k-body term before squaring;
  `adp_per_term=False` sums over all neighbors first (the LAMMPS
  convention).

Every phi / rho / embed / dipole / quadrupole function is independently
either an MLP ("nn") or an analytic form of `potentials`; analytic
parameters live in the parameter tree and are trainable unless listed in
`fixed_functions`.

The models read the flat pair layout ('segment'): each branch is an
elementwise f(r) over the pairs, a masked select by term, and one
`index_add` over the pairs' centers. A batch ([B, nij] pair arrays,
[B, A, 3] positions) is one evaluation: structure b's centers are rows
b * A of one flat accumulator.

The parameters are an `nn.ModuleDict` shaped like the JAX parameter tree
(``{"nn": {"Ni.rho": stack}, "zjw04xc": {"Ni": {"A": 0-d}}}``); module
keys cannot hold a '.', so the MLP keys are stored with ':' and
`param_tree` / `load_param_tree` speak the JAX names.
"""
from __future__ import annotations

import copy
from collections import Counter
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ...ops.pairs import pair_vectors, reduce_rows, safe_norm
from ...transform.featurizer import Featurizer
from ...utils import get_elements_from_kbody_term
from ..layers import apply_dense_stack, init_dense_stack, l2_of_stack
from .potentials import resolve_potential


def _escape(key: str) -> str:
    return key.replace(".", ":")


def _unescape(key: str) -> str:
    return key.replace(":", ".")


def _to_module(tree):
    """Nested dicts/lists of tensors -> ModuleDict / ParameterDict /
    ModuleList with the same leaves as Parameters."""
    if isinstance(tree, (list, tuple)):
        return nn.ModuleList([_to_module(v) for v in tree])
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({_escape(k): nn.Parameter(v)
                                 for k, v in tree.items()})
    return nn.ModuleDict({_escape(k): _to_module(v)
                          for k, v in tree.items()})


def _from_module(module):
    """The inverse of `_to_module`: the leaves are the Parameters
    themselves (in the autograd graph, not detached)."""
    if isinstance(module, nn.ModuleList):
        return [_from_module(m) for m in module]
    if isinstance(module, nn.ParameterDict):
        return {_unescape(k): v for k, v in module.items()}
    return {_unescape(k): _from_module(m) for k, m in module.items()}


def _segment_sum(values: torch.Tensor, segments: torch.Tensor,
                 n: int) -> torch.Tensor:
    """sum of `values` rows by segment id -> [n, ...] (over every rank's
    pairs where the pair axis is sharded, `ops.pairs.reduce_rows`)."""
    out = values.new_zeros((n,) + tuple(values.shape[1:]))
    return reduce_rows(out.index_add(0, segments, values))


class EamNN(nn.Module):
    """Shared machinery for the EAM family."""

    tag = "base"
    minmax_scale = False

    def __init__(self,
                 featurizer: Featurizer,
                 max_occurs: Counter,
                 custom_potentials: Union[str, dict, None] = None,
                 hidden_sizes: Union[dict, Sequence[int], None] = None,
                 activation: str = "softplus",
                 fixed_functions: Optional[List[str]] = None,
                 use_resnet_dt: bool = False,
                 adp_per_term: bool = True,
                 *, device=None, dtype=None):
        super().__init__()
        self.featurizer = featurizer
        self.elements: List[str] = featurizer.elements
        self.activation = activation
        self.use_resnet_dt = use_resnet_dt
        self.fixed_functions = list(fixed_functions or [])
        self.adp_per_term = adp_per_term
        self._custom_potentials = custom_potentials
        self._hidden_sizes_arg = hidden_sizes

        n = len(self.elements)
        # unique (unordered) pair terms, sorted for a deterministic order
        self.unique_kbody_terms = sorted(
            {"".join(sorted([a, b]))
             for a in self.elements for b in self.elements})
        # (center, neighbor) element idx -> unordered term index
        self._uterm_table = np.zeros((n, n), dtype=np.int64)
        for i, a in enumerate(self.elements):
            for j, b in enumerate(self.elements):
                self._uterm_table[i, j] = self.unique_kbody_terms.index(
                    "".join(sorted([a, b])))

        self.potentials = self._setup_potentials(custom_potentials)
        self.hidden_sizes = self._resolve_hidden_sizes(hidden_sizes)
        self._set_layout(max_occurs)
        factory = {"device": device,
                   "dtype": dtype or torch.get_default_dtype()}
        # carries the device and dtype through `.to()` for a model with
        # no parameters at all (every function a spline table)
        self.register_buffer("_anchor", torch.zeros((), **factory),
                             persistent=False)
        self.params = _to_module(self._initial_tree(None, factory))

    def _set_layout(self, max_occurs: Counter) -> None:
        """VAP layout (the AtomicNN contract): row 0 is the virtual
        atom, then one row slice of max_occurs[e] rows per element."""
        self.max_occurs = Counter(max_occurs)
        offset = 1
        self.layout: Dict[str, tuple] = {}
        for e in self.elements:
            cnt = int(self.max_occurs.get(e, 0))
            self.layout[e] = (offset, cnt)
            offset += cnt
        self.n_atoms_vap = offset
        vei = np.zeros(self.n_atoms_vap, dtype=np.int64)
        for e in self.elements:
            lo, cnt = self.layout[e]
            vei[lo:lo + cnt] = self.elements.index(e)
        self.vap_element_idx = vei
        self._tables: Dict[torch.device, tuple] = {}

    def clone_for(self, max_occurs: Counter) -> "EamNN":
        """The same weights (shared) under another VAP row layout."""
        clone = copy.copy(self)
        clone._set_layout(max_occurs)
        return clone

    def _index_tables(self, device) -> tuple:
        """(element index of each VAP row, unordered-term table) on
        `device`, made once per layout and device."""
        tables = self._tables.get(device)
        if tables is None:
            tables = (torch.as_tensor(self.vap_element_idx, device=device),
                      torch.as_tensor(self._uterm_table, device=device))
            self._tables[device] = tables
        return tables

    # ------------------------------------------------------------------
    @property
    def _sections(self) -> Dict[str, List[str]]:
        """{section: [function keys]} — subclass-specific."""
        raise NotImplementedError

    def _setup_potentials(self, custom) -> Dict[str, Dict[str, str]]:
        out = {}
        for section, keys in self._sections.items():
            out[section] = {}
            for key in keys:
                if custom is None:
                    name = "nn"
                elif isinstance(custom, str):
                    name = custom
                else:
                    name = custom.get(section, {}).get(key, "nn")
                if name != "nn":
                    resolve_potential(name)   # raises on unknown names
                out[section][key] = name
        return out

    def _resolve_hidden_sizes(self, hs) -> Dict[str, Dict[str, List[int]]]:
        default = [32, 32] if hs is None or isinstance(hs, dict) else list(hs)
        out = {}
        for section, keys in self._sections.items():
            out[section] = {}
            for key in keys:
                v = default
                if isinstance(hs, dict):
                    got = hs.get(section)
                    if isinstance(got, dict):
                        v = got.get(key, default)
                    elif got is not None:
                        v = got
                out[section][key] = list(v)
        return out

    # ------------------------------------------------------------------
    # Parameters as a tree, shaped like the JAX parameter pytree. Every
    # compute method takes `params`; None means the module's own.
    def _initial_tree(self, generator, factory) -> dict:
        """The JAX `init_params` tree: MLP stacks drawn from `generator`
        (zeros without one), analytic sections at their defaults."""
        params: dict = {"nn": {}}
        emp_sections: Dict[str, set] = {}
        for section, keys in self._sections.items():
            for fkey in keys:
                name = self.potentials[section][fkey]
                if name == "nn":
                    stack = init_dense_stack(
                        generator or torch.Generator(), 1,
                        self.hidden_sizes[section][fkey], out_dim=1,
                        output_bias=False, resnet_dt=self.use_resnet_dt,
                        kernel_init="he_normal" if generator else "zeros",
                        **factory)
                    params["nn"][f"{section}.{fkey}"] = stack
                else:
                    emp_sections.setdefault(name, set()).update(
                        self._empirical_sections_for(name, section, fkey))
        for name, sections in emp_sections.items():
            pot = resolve_potential(name)
            initial = pot.initial_params(sorted(sections), **factory)
            if initial:
                params[pot.name] = initial
        return params

    def _empirical_sections_for(self, name: str, section: str,
                                fkey: str) -> List[str]:
        """Sections of the analytic potential's parameter table needed to
        evaluate (section, fkey), e.g. zjw04 phi('MoNi') needs Mo and
        Ni."""
        pot = resolve_potential(name)
        if not pot.defaults:
            # generic potentials parameterize whatever section they are
            # assigned to; spline potentials have no parameters
            return [section]
        candidates = [section] + get_elements_from_kbody_term(section)
        wanted = {s for s in candidates if s in pot.defaults}
        return sorted(wanted) if wanted else sorted(pot.defaults)

    def _factory(self) -> dict:
        return {"device": self._anchor.device, "dtype": self._anchor.dtype}

    def init_params(self, generator: torch.Generator) -> dict:
        """A fresh parameter tree: MLP kernels drawn from `generator` (a
        CPU `torch.Generator`) with the JAX package's distribution, not
        its bits; analytic parameters at their defaults."""
        return self._initial_tree(generator, self._factory())

    def param_tree(self) -> dict:
        """The module's weights as a tree of detached tensors (shared
        storage), under the JAX names."""
        from ...utils import tree_map
        return tree_map(lambda v: v.detach(), _from_module(self.params))

    def load_param_tree(self, tree) -> None:
        """Copy a parameter tree (tensors or arrays, the JAX names) into
        the module; every leaf of the module must be given, and no
        other."""
        from ...utils import tree_flatten
        want = tree_flatten(_from_module(self.params))
        got = tree_flatten(tree)
        if set(got) != set(want):
            raise KeyError(
                f"parameter tree mismatch: missing "
                f"{sorted(set(want) - set(got))}, unexpected "
                f"{sorted(set(got) - set(want))}")
        with torch.no_grad():
            for key, param in want.items():
                value = got[key]
                if not isinstance(value, torch.Tensor):
                    value = torch.from_numpy(np.array(value))
                param.copy_(value.reshape(param.shape))

    def _params(self, params) -> dict:
        return _from_module(self.params) if params is None else params

    # ------------------------------------------------------------------
    def _fn(self, params, section: str, fkey: str, kind: str):
        """f(x) for (section, fkey); `kind` names the analytic method
        ('phi' / 'rho' / 'embed' / 'dipole' / 'quadrupole')."""
        name = self.potentials[section][fkey]
        fixed = f"{section}.{fkey}" in self.fixed_functions
        if name == "nn":
            layers = params["nn"][f"{section}.{fkey}"]["layers"]
            if fixed:
                layers = [{k: v.detach() for k, v in layer.items()}
                          for layer in layers]

            def f(x):
                return apply_dense_stack(layers, x[..., None],
                                         self.activation)[..., 0]
            return f
        pot = resolve_potential(name)
        method = getattr(pot, kind)
        return lambda x: method(params, x, section, fixed=fixed)

    # ------------------------------------------------------------------
    def _pair_geometry(self, features):
        """Flat pair geometry of one structure or a batch: -> (vec [P, 3],
        r [P], mask [P], ei [P], ej [P], center row [P] of the [R]
        flat accumulator, R, leading shape of the per-atom result)."""
        pos = features["positions"]
        mask = features["pair_mask"]
        pi = features["pair_i"].long()
        pj = features["pair_j"].long()
        # Padding entries all name row 0. Their values and gradients are
        # zero, but on CUDA the gradient of the position gather
        # accumulates a run of equal indices serially: spread them over
        # the rows (hundreds of thousands of padding pairs took 0.1-0.9 s
        # of a request on an H100, PERF.md §6).
        spread = torch.arange(pi.shape[-1], device=pi.device) \
            % pos.shape[-2]
        pi = torch.where(mask > 0, pi, spread)
        pj = torch.where(mask > 0, pj, spread)
        vec = pair_vectors(dict(features, pair_i=pi, pair_j=pj))
        lead = tuple(pos.shape[:-1])              # (A,) or (B, A)
        n_rows = int(np.prod(lead))
        if pos.dim() == 3:
            a = pos.shape[1]
            rows = pi + torch.arange(0, n_rows, a,
                                     device=pos.device).view(-1, 1)
        else:
            rows = pi
        vec, mask = vec.reshape(-1, 3), mask.reshape(-1)
        r = safe_norm(vec)
        r = torch.where(mask > 0, r, 1.0)
        # pairs beyond the model cutoff are masked on the device: a
        # skinned neighbor list and exact-rcut featurization give the
        # same energy, and the model agrees with its truncated setfl
        # export
        mask = mask * (r < self.featurizer.rcut).to(mask.dtype)
        elem, _ = self._index_tables(pos.device)
        ei = elem[pi].reshape(-1)
        ej = elem[pj].reshape(-1)
        return vec, r, mask, ei, ej, rows.reshape(-1), n_rows, lead

    def _phi_energy(self, params, r, mask, ei, ej, rows, n_rows):
        """1/2 sum phi over directed pairs -> [R]."""
        _, uterm = self._index_tables(r.device)
        ut = uterm[ei, ej]
        total = torch.zeros_like(r)
        for t, term in enumerate(self.unique_kbody_terms):
            if not self._term_possible(term):
                continue
            phi = self._fn(params, term, "phi", "phi")(r)
            total = total + torch.where(ut == t, phi, 0.0)
        return 0.5 * _segment_sum(total * mask, rows, n_rows)

    def _term_possible(self, term: str) -> bool:
        a, b = get_elements_from_kbody_term(term)
        return self.max_occurs.get(a, 0) > 0 and self.max_occurs.get(b, 0) > 0

    def _embed_energy(self, params, rho_i: torch.Tensor) -> torch.Tensor:
        """F_e(rho) on each element's static row block of [.., A]."""
        pieces = [torch.zeros_like(rho_i[..., :1])]
        for e in self.elements:
            lo, cnt = self.layout[e]
            if cnt == 0:
                continue
            pieces.append(self._fn(params, e, "embed", "embed")(
                rho_i[..., lo:lo + cnt]))
        rest = rho_i.shape[-1] - self.n_atoms_vap
        if rest > 0:
            pieces.append(torch.zeros_like(rho_i[..., :rest]))
        return torch.cat(pieces, dim=-1)

    # ------------------------------------------------------------------
    def atomic_energies(self, features, params=None) -> torch.Tensor:
        raise NotImplementedError

    def energy(self, features, params=None) -> torch.Tensor:
        """Total energy (a scalar, or [B] for a batch)."""
        return torch.sum(self.atomic_energies(features, params), dim=-1)

    variational_energy = energy

    def energy_and_aux(self, features, params=None):
        """-> (energy, {"atomic_energies"}) of one pass: what
        `nn.fields.make_efs_fn` differentiates."""
        atomic = self.atomic_energies(features, params)
        return torch.sum(atomic, dim=-1), {"atomic_energies": atomic}

    # -- pair-chunked evaluation of large cells ------------------------
    # Every pair adds linearly to per-atom accumulators (rho, phi and, for
    # ADP, the dipole and quadrupole moments before squaring); only the
    # finalize is nonlinear. Summing the accumulators of pair blocks, each
    # under `torch.utils.checkpoint`, gives the monolithic energy up to
    # summation order while the backward holds one block of per-pair
    # intermediates instead of all of them.
    def _pair_term_accumulators(self, params, features) -> dict:
        """One flat pair block of one structure -> its linear per-atom
        accumulators."""
        _, r, mask, ei, ej, rows, n_rows, _ = self._pair_geometry(features)
        return {"rho": self._rho_sum(params, r, mask, ei, ej, rows, n_rows),
                "phi": self._phi_energy(params, r, mask, ei, ej, rows,
                                        n_rows)}

    def _finalize_accumulators(self, params, acc: dict, features):
        embed = self._embed_energy(params, acc["rho"])
        return (embed + acc["phi"]) * features["atom_masks"]

    def energy_chunked(self, features, params=None,
                       pair_chunk: int = 1 << 20) -> torch.Tensor:
        """Total energy of one structure with the flat pair axis in blocks
        of `pair_chunk` pairs."""
        from torch.utils.checkpoint import checkpoint
        params = self._params(params)
        pair_keys = [k for k in features
                     if (k.startswith("pair_") and not k.endswith("_d"))
                     or k == "rij"]
        base = {k: v for k, v in features.items() if k not in pair_keys}
        nij = int(features["pair_i"].shape[0])
        chunk = max(1, int(min(pair_chunk, nij)))

        def block(lo: int, hi: int) -> dict:
            return self._pair_term_accumulators(params, dict(
                base, **{k: features[k][lo:hi] for k in pair_keys}))

        acc = None
        for lo in range(0, nij, chunk):
            part = checkpoint(block, lo, min(lo + chunk, nij),
                              use_reentrant=False)
            acc = part if acc is None else {k: acc[k] + part[k]
                                            for k in acc}
        return torch.sum(self._finalize_accumulators(params, acc, features))

    def make_chunked_energy_fn(self, pair_chunk: int = 1 << 20):
        """-> fn(features, params=None): the pair-chunked energy."""
        return lambda features, params=None: self.energy_chunked(
            features, params, pair_chunk)

    def l2_loss(self, params=None) -> torch.Tensor:
        params = self._params(params)
        vals = [l2_of_stack(p) for p in params.get("nn", {}).values()]
        if vals:
            return sum(vals)
        return torch.zeros((), **self._factory())

    # ------------------------------------------------------------------
    @torch.no_grad()
    def export_to_setfl(self, path: str, params=None, nr: int = 2000,
                        nrho: int = 2000, rho_max: float = 100.0,
                        lattice: Optional[Dict[str, float]] = None,
                        structure: Optional[Dict[str, str]] = None):
        """Tabulate rho/F/phi (+u/w for ADP) onto (nr, nrho) grids and
        write a LAMMPS setfl file; -> the `SetflData`."""
        from ...elements import atomic_masses, atomic_numbers
        from ...io.lammps import (SetflData, write_eam_alloy_setfl,
                                  write_eam_fs_setfl)
        params = self._params(params)
        factory = self._factory()
        cutoff = self.featurizer.rcut
        dr = cutoff / nr
        drho = rho_max / nrho
        r = torch.as_tensor(np.arange(nr) * dr, **factory)
        r_safe = torch.clamp(r, min=1e-8)
        rho_g = torch.as_tensor(np.arange(nrho) * drho, **factory)

        def table(section, fkey, x):
            return self._fn(params, section, fkey, fkey)(x).cpu().numpy()

        frho, rho_t, phi_t = {}, {}, {}
        dipole_t = quadrupole_t = None
        for e in self.elements:
            frho[e] = table(e, "embed", rho_g)
            if self.tag in ("alloy", "adp"):
                rho_t[e] = table(e, "rho", r_safe)
            else:  # fs: LAMMPS eam/fs wants rho_{a<-b} per ORDERED pair
                for other in self.elements:
                    rho_t[e + other] = table(e + other, "rho", r_safe)
        for term in self.unique_kbody_terms:
            phi_t[term] = table(term, "phi", r_safe)
        if self.tag == "adp":
            dipole_t = {t: table(t, "dipole", r_safe)
                        for t in self.unique_kbody_terms}
            quadrupole_t = {t: table(t, "quadrupole", r_safe)
                            for t in self.unique_kbody_terms}
        data = SetflData(
            elements=self.elements, nrho=nrho, drho=drho, nr=nr, dr=dr,
            cutoff=cutoff,
            mass={e: float(atomic_masses[atomic_numbers[e]])
                  for e in self.elements},
            lattice=lattice or {e: 0.0 for e in self.elements},
            structure=structure or {e: "fcc" for e in self.elements},
            frho=frho, rho=rho_t, phi=phi_t,
            dipole=dipole_t, quadrupole=quadrupole_t)
        writer = (write_eam_fs_setfl if self.tag == "fs"
                  else write_eam_alloy_setfl)
        writer(path, data, comments=[
            f"tensoralloy_tpu {type(self).__name__} export",
            f"elements: {' '.join(self.elements)}", ""])
        return data

    def as_dict(self) -> dict:
        return {"class": type(self).__name__,
                "featurizer": self.featurizer.as_dict(),
                "max_occurs": dict(self.max_occurs),
                "custom_potentials": self._custom_potentials,
                "hidden_sizes": self._hidden_sizes_arg,
                "activation": self.activation,
                "fixed_functions": self.fixed_functions,
                "use_resnet_dt": self.use_resnet_dt,
                "adp_per_term": self.adp_per_term}


# ----------------------------------------------------------------------
class EamAlloyNN(EamNN):
    """eam/alloy: rho depends on the neighbor element only."""

    tag = "alloy"

    @property
    def _sections(self):
        sections = {e: ["rho", "embed"] for e in self.elements}
        for term in self.unique_kbody_terms:
            sections[term] = ["phi"]
        return sections

    def _rho_sum(self, params, r, mask, ei, ej, rows, n_rows):
        total = torch.zeros_like(r)
        for idx, e in enumerate(self.elements):
            rho = self._fn(params, e, "rho", "rho")(r)
            total = total + torch.where(ej == idx, rho, 0.0)
        return _segment_sum(total * mask, rows, n_rows)

    def atomic_energies(self, features, params=None) -> torch.Tensor:
        """-> [.., A] atomic energies (zero at padding rows)."""
        params = self._params(params)
        _, r, mask, ei, ej, rows, n_rows, lead = \
            self._pair_geometry(features)
        rho_i = self._rho_sum(params, r, mask, ei, ej, rows, n_rows)
        embed = self._embed_energy(params, rho_i.reshape(lead))
        phi = self._phi_energy(params, r, mask, ei, ej, rows, n_rows)
        return (embed + phi.reshape(lead)) * features["atom_masks"]


class EamFsNN(EamNN):
    """eam/fs: rho indexed by the ordered (center, neighbor) pair; the
    rho section 'AB' is center A, neighbor B."""

    tag = "fs"

    @property
    def _sections(self):
        sections = {e: ["embed"] for e in self.elements}
        for a in self.elements:
            for b in self.elements:
                sections.setdefault(a + b, []).append("rho")
        for term in self.unique_kbody_terms:
            sections.setdefault(term, [])
            if "phi" not in sections[term]:
                sections[term].append("phi")
        return sections

    def _rho_sum(self, params, r, mask, ei, ej, rows, n_rows):
        total = torch.zeros_like(r)
        for i, a in enumerate(self.elements):
            for j, b in enumerate(self.elements):
                rho = self._fn(params, a + b, "rho", "rho")(r)
                total = total + torch.where((ei == i) & (ej == j), rho, 0.0)
        return _segment_sum(total * mask, rows, n_rows)

    atomic_energies = EamAlloyNN.atomic_energies


class AdpNN(EamAlloyNN):
    """Angular-dependent potential: EAM/alloy plus dipole u(r) and
    quadrupole w(r) branches."""

    tag = "adp"

    @property
    def _sections(self):
        sections = {e: ["rho", "embed"] for e in self.elements}
        for term in self.unique_kbody_terms:
            sections[term] = ["phi", "dipole", "quadrupole"]
        return sections

    def _adp_moments(self, params, vec, r, mask, ei, ej, rows, n_rows):
        """Linear dipole/quadrupole moments (mu [nseg, 3],
        lam [nseg, 3, 3]), accumulated before squaring."""
        n_ut = len(self.unique_kbody_terms)
        _, uterm = self._index_tables(r.device)
        ut = uterm[ei, ej]
        if self.adp_per_term:
            seg = rows * n_ut + ut
            nseg = n_rows * n_ut
        else:
            seg = rows
            nseg = n_rows

        u_tot = torch.zeros_like(r)
        w_tot = torch.zeros_like(r)
        for t, term in enumerate(self.unique_kbody_terms):
            if not self._term_possible(term):
                continue
            sel = ut == t
            u_tot = u_tot + torch.where(
                sel, self._fn(params, term, "dipole", "dipole")(r), 0.0)
            w_tot = w_tot + torch.where(
                sel, self._fn(params, term, "quadrupole", "quadrupole")(r),
                0.0)
        u_tot = u_tot * mask
        w_tot = w_tot * mask

        mu = _segment_sum(u_tot[:, None] * vec, seg, nseg)
        dd = vec[:, :, None] * vec[:, None, :]
        lam = _segment_sum(w_tot[:, None, None] * dd, seg, nseg)
        return mu, lam

    def _adp_quadratic(self, mu, lam, n_rows) -> torch.Tensor:
        e_mu = 0.5 * torch.sum(torch.square(mu), dim=-1)
        # 1/2 [sum_aa + 2 sum_{a<b}] = 1/2 sum over the full 3x3
        e_lam = 0.5 * torch.sum(torch.square(lam), dim=(-1, -2))
        nu = lam.diagonal(dim1=-2, dim2=-1).sum(-1)
        e = e_mu + e_lam - torch.square(nu) / 6.0
        if self.adp_per_term:
            e = e.reshape(n_rows, len(self.unique_kbody_terms)).sum(dim=1)
        return e

    def _pair_term_accumulators(self, params, features) -> dict:
        vec, r, mask, ei, ej, rows, n_rows, _ = self._pair_geometry(features)
        mu, lam = self._adp_moments(params, vec, r, mask, ei, ej, rows,
                                    n_rows)
        return {"rho": self._rho_sum(params, r, mask, ei, ej, rows, n_rows),
                "phi": self._phi_energy(params, r, mask, ei, ej, rows,
                                        n_rows),
                "mu": mu, "lam": lam}

    def _finalize_accumulators(self, params, acc: dict, features):
        embed = self._embed_energy(params, acc["rho"])
        adp = self._adp_quadratic(acc["mu"], acc["lam"], acc["rho"].shape[0])
        return (embed + acc["phi"] + adp) * features["atom_masks"]

    def atomic_energies(self, features, params=None) -> torch.Tensor:
        params = self._params(params)
        vec, r, mask, ei, ej, rows, n_rows, lead = \
            self._pair_geometry(features)
        rho_i = self._rho_sum(params, r, mask, ei, ej, rows, n_rows)
        embed = self._embed_energy(params, rho_i.reshape(lead))
        phi = self._phi_energy(params, r, mask, ei, ej, rows, n_rows)
        mu, lam = self._adp_moments(params, vec, r, mask, ei, ej, rows,
                                    n_rows)
        adp = self._adp_quadratic(mu, lam, n_rows)
        return (embed + (phi + adp).reshape(lead)) * features["atom_masks"]


# ----------------------------------------------------------------------
def model_from_dict(d: dict, featurizer=None, max_occurs=None, *,
                    device=None, dtype=None):
    if featurizer is None:
        featurizer = Featurizer.from_dict(d["featurizer"])
    if max_occurs is None:
        max_occurs = Counter(d["max_occurs"])
    cls = {"EamAlloyNN": EamAlloyNN, "EamFsNN": EamFsNN,
           "AdpNN": AdpNN}[d["class"]]
    return cls(featurizer, max_occurs,
               custom_potentials=d.get("custom_potentials"),
               hidden_sizes=d.get("hidden_sizes"),
               activation=d.get("activation", "softplus"),
               fixed_functions=d.get("fixed_functions"),
               use_resnet_dt=d.get("use_resnet_dt", False),
               adp_per_term=d.get("adp_per_term", True),
               device=device, dtype=dtype)
