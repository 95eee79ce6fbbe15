"""Analytic (empirical) EAM potential registry (port of
`tensoralloy_tpu/nn/eam/potentials.py`).

Each potential exposes plain functions phi / rho / embed (plus dipole /
quadrupole for the ADP forms) of torch tensors, with its parameters in
the model's parameter tree so that they are (optionally) trainable.
Parameters a potential never trains (`always_fixed`) and the functions a
model fixes (`fixed_functions`) are detached, so autograd gives them no
gradient; the trainer counts that as zero.

A parameter missing from the tree falls back to the potential's default,
a Python float.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ...ops.generic import (buckingham, density_exp, mishin_polar,
                            morse as morse_fn, zhou_exp)
from ...utils import get_elements_from_kbody_term


def _stop(value):
    """Detach a tensor parameter; a float default stays as it is."""
    return value.detach() if isinstance(value, torch.Tensor) else value


def _maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    """max(x, c) whose gradient at a tie is split in halves, as
    `jnp.maximum`'s."""
    return torch.maximum(x, x.new_tensor(c))


class EmpiricalPotential:
    """Base: parameter management + fixed-name bookkeeping."""

    name = "empirical"
    # parameter names that must never be trained
    always_fixed: Dict[str, List[str]] = {}
    defaults: Dict[str, Dict[str, float]] = {}

    def initial_params(self, sections: List[str], dtype=None,
                       device=None) -> dict:
        """Initial parameter tree (0-d tensors) for the needed sections."""
        out = {}
        for section in sections:
            if section in self.defaults:
                out[section] = {k: torch.tensor(float(v), dtype=dtype,
                                                device=device)
                                for k, v in self.defaults[section].items()}
        return out

    def resolve(self, params: dict, section: str, fixed: bool) -> dict:
        """Parameter dict for `section`, detaching fixed names."""
        p = dict(params.get(self.name, {}).get(section, {}))
        if not p:
            p = {k: float(v) for k, v in self.defaults[section].items()}
        hard = self.always_fixed.get(section, self.always_fixed.get("*", []))
        for k in list(p):
            if fixed or k in hard:
                p[k] = _stop(p[k])
        return p

    @staticmethod
    def _rho_element(element_or_term: str) -> str:
        """FS models pass the ordered pair 'AB' (center A, neighbor B)
        to rho; element-parameterized potentials evaluate the NEIGHBOR
        element's density, rho_ab := rho_b."""
        els = get_elements_from_kbody_term(element_or_term)
        return els[-1] if len(els) == 2 else element_or_term

    # subclasses implement (r is [nij]-shaped; all pure):
    def phi(self, params, r, kbody_term, fixed=False):
        raise NotImplementedError(f"{self.name} has no phi")

    def rho(self, params, r, element_or_term, fixed=False):
        raise NotImplementedError(f"{self.name} has no rho")

    def embed(self, params, rho, element, fixed=False):
        raise NotImplementedError(f"{self.name} has no embed")

    def dipole(self, params, r, kbody_term, fixed=False):
        raise NotImplementedError(f"{self.name} has no dipole")

    def quadrupole(self, params, r, kbody_term, fixed=False):
        raise NotImplementedError(f"{self.name} has no quadrupole")


# ----------------------------------------------------------------------
zjw04_defaults = {
    "Al": dict(r_eq=2.863924, f_eq=1.403115, rho_e=20.418205,
               rho_s=23.195740, alpha=6.613165, beta=3.527021, A=0.314873,
               B=0.365551, kappa=0.379846, lamda=0.759692, Fn0=-2.807602,
               Fn1=-0.301435, Fn2=1.258562, Fn3=-1.247604, F0=-2.83, F1=0.0,
               F2=0.622245, F3=-2.488244, eta=0.785902, Fe=-2.824528),
    "Cu": dict(r_eq=2.556162, f_eq=1.554485, rho_e=21.175871,
               rho_s=21.175395, alpha=8.127620, beta=4.334731, A=0.396620,
               B=0.548085, kappa=0.308782, lamda=0.756515, Fn0=-2.170269,
               Fn1=-0.263788, Fn2=1.088878, Fn3=-0.817603, F0=-2.19, F1=0.0,
               F2=0.561830, F3=-2.100595, eta=0.310490, Fe=-2.186568),
    "Ni": dict(r_eq=2.488746, f_eq=2.007018, rho_e=27.562015,
               rho_s=27.930410, alpha=8.383453, beta=4.471175, A=0.429046,
               B=0.633531, kappa=0.443599, lamda=0.820658, Fn0=-2.693513,
               Fn1=-0.076445, Fn2=0.241442, Fn3=-2.375626, F0=-2.70, F1=0.0,
               F2=0.265390, F3=-0.152856, eta=0.469000, Fe=-2.699486),
    "Ag": dict(r_eq=2.891814, f_eq=1.106232, rho_e=14.604100,
               rho_s=14.604144, alpha=9.132010, beta=4.870405, A=0.277758,
               B=0.419611, kappa=0.339710, lamda=0.750758, Fn0=-1.729364,
               Fn1=-0.255882, Fn2=0.912050, Fn3=-0.561432, F0=-1.75, F1=0.0,
               F2=0.744561, F3=-1.150650, eta=0.783924, Fe=-1.748423),
    "Mo": dict(r_eq=2.728100, f_eq=2.723710, rho_e=29.354065,
               rho_s=29.354065, alpha=8.393531, beta=4.476550, A=0.708787,
               B=1.120373, kappa=0.137640, lamda=0.275280, Fn0=-3.692913,
               Fn1=-0.178812, Fn2=0.380450, Fn3=-3.133650, F0=-3.71, F1=0.0,
               F2=0.875874, F3=0.776222, eta=0.790879, Fe=-3.712093),
    "Co": dict(r_eq=2.505979, f_eq=1.975299, rho_e=27.206789,
               rho_s=27.206789, alpha=8.679625, beta=4.629134, A=0.421378,
               B=0.640107, kappa=0.5, lamda=1.0, Fn0=-2.541799,
               Fn1=-0.219415, Fn2=0.733381, Fn3=-1.589003, F0=-2.56, F1=0.0,
               F2=0.705845, F3=-0.687140, eta=0.694608, Fe=-2.559307),
    "Mg": dict(r_eq=3.196291, f_eq=0.544323, rho_e=7.132600, rho_s=7.132600,
               alpha=10.228708, beta=5.455311, A=0.137518, B=0.225930,
               kappa=0.5, lamda=1.0, Fn0=-0.896473, Fn1=-0.044291,
               Fn2=0.162232, Fn3=-0.689950, F0=-0.90, F1=0.0, F2=0.122838,
               F3=-0.226010, eta=0.431425, Fe=-0.899702),
    "Fe": dict(r_eq=2.481987, f_eq=1.885957, rho_e=20.041463,
               rho_s=20.041463, alpha=9.818270, beta=5.236411, A=0.392811,
               B=0.646243, kappa=0.170306, lamda=0.340613, Fn0=-2.534992,
               Fn1=-0.059605, Fn2=0.193065, Fn3=-2.282322, F0=-2.54, F1=0.0,
               F2=0.200269, F3=-0.148770, eta=0.391750, Fe=-2.539945),
    "Pd": dict(r_eq=2.750897, f_eq=1.595417, rho_e=21.335246,
               rho_s=21.940073, alpha=8.697397, beta=4.638612, A=0.406763,
               B=0.598880, kappa=0.397263, lamda=0.754799, Fn0=-2.321006,
               Fn1=-0.473983, Fn2=1.615343, Fn3=-0.231681, F0=-2.36, F1=0.0,
               F2=1.481742, F3=-1.675615, eta=1.13, Fe=-2.352753),
    "W": dict(r_eq=2.740840, f_eq=3.487340, rho_e=37.234847,
              rho_s=37.234847, alpha=8.900114, beta=4.746728, A=0.882435,
              B=1.394592, kappa=0.139209, lamda=0.278417, Fn0=-4.946281,
              Fn1=-0.148818, Fn2=0.365057, Fn3=-4.432406, F0=-4.96, F1=0.0,
              F2=0.661935, F3=0.348147, eta=-0.582714, Fe=-4.961306),
    "Ta": dict(r_eq=2.860082, f_eq=3.086341, rho_e=33.787168,
               rho_s=33.787168, alpha=8.489528, beta=4.527748, A=0.611679,
               B=1.032101, kappa=0.176977, lamda=0.353954, Fn0=-5.103845,
               Fn1=-0.405524, Fn2=1.112997, Fn3=-3.585325, F0=-5.14, F1=0.0,
               F2=1.640098, F3=0.221375, eta=0.848843, Fe=-5.141526),
    "Zr": dict(r_eq=3.199978, f_eq=2.230909, rho_e=30.879991,
               rho_s=30.879991, alpha=8.559190, beta=4.564902, A=0.424667,
               B=0.640054, kappa=0.5, lamda=1.0, Fn0=-4.485793,
               Fn1=-0.293129, Fn2=0.990148, Fn3=-3.202516, F0=-4.51, F1=0.0,
               F2=0.928602, F3=-0.981870, eta=0.597133, Fe=-4.509025),
}


class Zjw04(EmpiricalPotential):
    """Zhou-Johnson-Wadley (2004) generalized EAM (PRB 69, 144113).

    phi_aa(r) = zhou_exp(A, alpha, kappa) - zhou_exp(B, beta, lamda)
    rho_a(r)  = zhou_exp(f_eq, beta, lamda)
    phi_ab    = 1/2 [ (rho_a/rho_b) phi_bb + (rho_b/rho_a) phi_aa ]
    F(rho)    = three-branch piecewise cubic / power form.
    The embedding's parameters are always fixed (the piecewise form
    breaks continuity if they are optimized directly).
    """

    name = "zjw04"
    defaults = zjw04_defaults
    always_fixed = {"*": ["F0", "F1", "F2", "F3", "Fn0", "Fn1", "Fn2",
                          "Fn3", "Fe", "eta", "rho_e", "rho_s", "r_eq"]}

    def _phi_elemental(self, p, r):
        return (zhou_exp(r, p["A"], p["alpha"], p["kappa"], p["r_eq"]) -
                zhou_exp(r, p["B"], p["beta"], p["lamda"], p["r_eq"]))

    def _rho_elemental(self, p, r):
        return zhou_exp(r, p["f_eq"], p["beta"], p["lamda"], p["r_eq"])

    def phi(self, params, r, kbody_term, fixed=False):
        el_a, el_b = get_elements_from_kbody_term(kbody_term)
        pa = self.resolve(params, el_a, fixed)
        if el_a == el_b:
            return self._phi_elemental(pa, r)
        pb = self.resolve(params, el_b, fixed)
        phi_a = self._phi_elemental(pa, r)
        phi_b = self._phi_elemental(pb, r)
        rho_a = self._rho_elemental(pa, r)
        rho_b = self._rho_elemental(pb, r)
        return 0.5 * (rho_a / rho_b * phi_b + rho_b / rho_a * phi_a)

    def rho(self, params, r, element, fixed=False):
        p = self.resolve(params, self._rho_element(element), fixed)
        return self._rho_elemental(p, r)

    def embed(self, params, rho, element, fixed=False):
        p = self.resolve(params, element, fixed)
        rho_n = 0.85 * p["rho_e"]
        rho_0 = 1.15 * p["rho_e"]

        x1 = rho / rho_n - 1.0
        e1 = p["Fn0"] + x1 * (p["Fn1"] + x1 * (p["Fn2"] + x1 * p["Fn3"]))
        x2 = rho / p["rho_e"] - 1.0
        e2 = p["F0"] + x2 * (p["F1"] + x2 * (p["F2"] + x2 * p["F3"]))
        # branch 3 only valid for rho >= rho_0 > 0; guard the pow/log
        z = torch.where(rho >= rho_0, rho / p["rho_s"], 1.0)
        e3 = p["Fe"] * (1.0 - p["eta"] * torch.log(z)) * z ** p["eta"]
        return torch.where(rho < rho_n, e1,
                           torch.where(rho < rho_0, e2, e3))


class AgSutton90(EmpiricalPotential):
    """Sutton-Chen Ag (Philos. Mag. Lett. 61 (1990) 139): phi = (b/r)^12,
    rho = (a/r)^6, F = -sqrt(rho)."""

    name = "sutton90"
    defaults = {"Ag": {"a": 2.928323832}, "AgAg": {"b": 2.485883762}}

    def phi(self, params, r, kbody_term, fixed=False):
        p = self.resolve(params, kbody_term, fixed)
        return (p["b"] / r) ** 12

    def rho(self, params, r, element, fixed=False):
        p = self.resolve(params, self._rho_element(element), fixed)
        return (p["a"] / r) ** 6

    def embed(self, params, rho, element, fixed=False):
        return -torch.sqrt(_maximum(rho, 0.0))


available_potentials: Dict[str, EmpiricalPotential] = {
    "zjw04": Zjw04(),
    "sutton90": AgSutton90(),
}


# ----------------------------------------------------------------------
class SplinePotential(EmpiricalPotential):
    """Tabulated potential backed by differentiable cubic splines
    (`spline@<file>`): any setfl / ADP table becomes a full
    rho/phi/F(/u/w) potential whose values are exactly the LAMMPS
    tables and whose derivatives are C2 splines. No trainable
    parameters."""

    def __init__(self, filename: str, style: str = "auto"):
        from ...io.lammps import read_eam_alloy_setfl
        from ...ops.spline import UniformCubicSpline
        if style == "auto":
            if filename.endswith(".adp"):
                style = "adp"
            elif ".fs." in filename or filename.endswith(".fs"):
                style = "fs"
            else:
                style = "alloy"
        self.style = style
        self.filename = filename
        data = read_eam_alloy_setfl(
            filename, is_adp=(style == "adp"),
            style="fs" if style == "fs" else "alloy")
        self.data = data
        self.name = f"spline@{filename}"
        self.defaults = {}

        def mk_r(y):
            return UniformCubicSpline(y, 0.0, data.dr)

        def mk_rho(y):
            return UniformCubicSpline(y, 0.0, data.drho,
                                      extrapolate_zero=False)

        self._rho = {k: mk_r(v) for k, v in data.rho.items()}
        self._frho = {k: mk_rho(v) for k, v in data.frho.items()}
        self._phi = {k: mk_r(v) for k, v in data.phi.items()}
        self._dipole = ({k: mk_r(v) for k, v in data.dipole.items()}
                        if data.dipole else {})
        self._quadrupole = ({k: mk_r(v)
                             for k, v in data.quadrupole.items()}
                            if data.quadrupole else {})

    def initial_params(self, sections, dtype=None, device=None):
        return {}

    @staticmethod
    def _pair(kbody_term: str) -> str:
        return "".join(sorted(get_elements_from_kbody_term(kbody_term)))

    def phi(self, params, r, kbody_term, fixed=False):
        return self._phi[self._pair(kbody_term)](r)

    def rho(self, params, r, element_or_term, fixed=False):
        return self._rho[element_or_term](r)

    def embed(self, params, rho, element, fixed=False):
        return self._frho[element](rho)

    def dipole(self, params, r, kbody_term, fixed=False):
        return self._dipole[self._pair(kbody_term)](r)

    def quadrupole(self, params, r, kbody_term, fixed=False):
        return self._quadrupole[self._pair(kbody_term)](r)


_spline_cache: Dict[str, SplinePotential] = {}


def resolve_potential(name: str) -> EmpiricalPotential:
    """A name of `available_potentials` or 'spline@/path/to/table[.fs|.adp]'."""
    if name in available_potentials:
        return available_potentials[name]
    if name.startswith("spline@"):
        path = name[len("spline@"):]
        if path not in _spline_cache:
            _spline_cache[path] = SplinePotential(path)
        return _spline_cache[path]
    raise ValueError(f"unknown potential '{name}'")


# ----------------------------------------------------------------------
class MorsePotential(EmpiricalPotential):
    """Trainable generic Morse pair potential + exponential density:
    usable for any element pair; parameters start at generic defaults
    and are trained."""

    name = "morse"
    generic_defaults = {"phi": dict(D=1.0, gamma=1.5, r0=2.5),
                        "rho": dict(A=1.0, beta=4.0, re=2.5)}

    def initial_params(self, sections, dtype=None, device=None):
        """Element sections hold density parameters (flat); a pair
        section can be assigned EITHER phi (eam/alloy pairs) or rho
        (eam/fs ordered pairs), whose names may collide, so a pair
        section nests one sub-dict per function kind."""
        def leaves(kind):
            return {k: torch.tensor(float(v), dtype=dtype, device=device)
                    for k, v in self.generic_defaults[kind].items()}

        out = {}
        for section in sections:
            if len(get_elements_from_kbody_term(section)) == 2:
                out[section] = {kind: leaves(kind)
                                for kind in ("phi", "rho")}
            else:
                out[section] = leaves("rho")
        return out

    def _resolve_kind(self, params, section, kind, fixed):
        raw = params.get(self.name, {}).get(section, {})
        p = raw.get(kind) if isinstance(raw.get(kind), dict) else None
        if p is not None:
            p = dict(p)
        else:
            # flat layout: element sections, or older checkpoints that
            # stored pair phi params directly in the section
            keys = set(self.generic_defaults[kind])
            if raw and keys <= set(raw):
                p = {k: raw[k] for k in keys}
            else:
                p = {k: float(v)
                     for k, v in self.generic_defaults[kind].items()}
        if fixed:
            p = {k: _stop(v) for k, v in p.items()}
        return p

    def resolve(self, params, section, fixed):
        # kept for API symmetry with the table-driven potentials
        return self._resolve_kind(params, section, "rho", fixed)

    def phi(self, params, r, kbody_term, fixed=False):
        p = self._resolve_kind(params, kbody_term, "phi", fixed)
        return morse_fn(r, p["D"], p["gamma"], p["r0"])

    def rho(self, params, r, element, fixed=False):
        p = self._resolve_kind(params, element, "rho", fixed)
        return density_exp(r, p["A"], p["beta"], p["re"])

    def embed(self, params, rho, element, fixed=False):
        return -torch.sqrt(_maximum(rho, 0.0))


class BuckinghamPotential(MorsePotential):
    """Trainable Buckingham phi: A exp(-r/rho) - C/r^6 (+ the Morse
    potential's density and sqrt embedding)."""

    name = "buckingham"
    generic_defaults = {"phi": dict(A=1000.0, rho=0.3, C=10.0),
                        "rho": dict(A=1.0, beta=4.0, re=2.5)}

    def phi(self, params, r, kbody_term, fixed=False):
        p = self._resolve_kind(params, kbody_term, "phi", fixed)
        return buckingham(r, p["A"], p["rho"], p["C"])


available_potentials["morse"] = MorsePotential()
available_potentials["buckingham"] = BuckinghamPotential()


# ----------------------------------------------------------------------
class Zjw04xc(Zjw04):
    """Zjw04 with a smooth (sigmoid-blended) embedding: no derivative
    discontinuities, so every parameter but r_eq can be trained. Adds
    Be (initialized from the Mo column)."""

    name = "zjw04xc"
    always_fixed = {"*": ["r_eq"]}

    def __init__(self):
        d = {k: dict(v) for k, v in zjw04_defaults.items()}
        d["Be"] = dict(d["Mo"])
        self.defaults = d

    def embed(self, params, rho, element, fixed=False):
        p = self.resolve(params, element, fixed)
        rho_n = 0.85 * p["rho_e"]
        rho_0 = 1.15 * p["rho_e"]
        x1 = rho / rho_n - 1.0
        e1 = p["Fn0"] + x1 * (p["Fn1"] + x1 * (p["Fn2"] + x1 * p["Fn3"]))
        x2 = rho / p["rho_e"] - 1.0
        e2 = p["F0"] + x2 * (p["F1"] + x2 * (p["F2"] + x2 * p["F3"]))
        z = rho / p["rho_s"] + 1e-8
        e3 = p["Fe"] * (1.0 - p["eta"] * torch.log(z)) * z ** p["eta"]
        c1 = torch.sigmoid(2.0 * (rho_n - rho))
        c3 = torch.sigmoid(2.0 * (rho - rho_0))
        c2 = 1.0 - c1 - c3
        return c1 * e1 + c2 * e2 + c3 * e3


class Zjw04uxc(Zjw04xc):
    """Unrestricted Zjw04xc: every parameter (r_eq too) trainable."""

    name = "zjw04uxc"
    always_fixed = {}


class Zjw04xcp(Zjw04xc):
    """Zjw04xc with re-fitted Ni/Mo tables and an explicit exponential
    pair function for the A-B cross term (its own parameter row) instead
    of the mixing rule."""

    name = "zjw04xcp"
    always_fixed = {"*": ["r_eq"]}

    def __init__(self):
        super().__init__()
        d = self.defaults
        d["Ni"] = dict(
            A=0.333956, B=0.576165, F0=-3.291077, F1=0.395187,
            F2=0.533360, F3=-2.154562, Fe=-3.206066, Fn0=-3.353943,
            Fn1=0.041024, Fn2=-2.098675, Fn3=-7.605803, alpha=8.401944,
            beta=3.288919, eta=1.182809, f_eq=1.543016, kappa=0.419188,
            lamda=0.857673, r_eq=2.488746, rho_e=25.423122,
            rho_s=26.498945)
        d["Mo"] = dict(
            A=1.070439, B=1.762964, F0=-6.613181, F1=2.160862,
            F2=0.587255, F3=-4.271510, Fe=-6.847272, Fn0=-6.931113,
            Fn1=1.532229, Fn2=0.354207, Fn3=-2.301498, alpha=7.639637,
            beta=5.295918, eta=0.642979, f_eq=3.321370, kappa=0.142495,
            lamda=0.211357, r_eq=2.728100, rho_e=32.766506,
            rho_s=21.342554)
        d["MoNi"] = dict(
            A=0.949134, B=1.360144, alpha=9.168006, beta=3.449561,
            kappa=0.478692, lamda=0.424937, r_eq=2.235219)

    def phi(self, params, r, kbody_term, fixed=False):
        el_a, el_b = get_elements_from_kbody_term(kbody_term)
        if el_a != el_b and kbody_term in self.defaults:
            p = self.resolve(params, kbody_term, fixed)
            return self._phi_elemental(p, r)
        return super().phi(params, r, kbody_term, fixed)


available_potentials["zjw04xc"] = Zjw04xc()
available_potentials["zjw04uxc"] = Zjw04uxc()
available_potentials["zjw04xcp"] = Zjw04xcp()


# ----------------------------------------------------------------------
class AlFeMsah11(EmpiricalPotential):
    """Mendelev et al. Al-Fe Finnis-Sinclair potential (J. Mater. Res. 20
    (2011) 208).

    phi(r) per pair class = screened-Coulomb core (first segment),
    exp-polynomial bridge (second segment), plus knot-polynomial tails
    sum_k a_k (r_k - r)^p. rho(r) = sum_k a_k max(r_k - r, 0)^p;
    F(rho) = -sqrt(rho) + small polynomial corrections. All parameters
    are published constants (not trainable).
    """

    name = "msah11"
    defaults = {"Al": {}, "Fe": {}}

    # screened-Coulomb cores: (scale, [(b, c), ...])
    _FIRST = {
        "AlAl": (2433.5591473227,
                 [(0.1818, -22.713109144730), (0.5099, -6.6883008584622),
                  (0.2802, -2.8597223982536), (0.02817, -1.4309258761180)]),
        "FeFe": (9734.2365892908,
                 [(0.1818, -28.616724320005), (0.5099, -8.4267310396064),
                  (0.2802, -3.6030244464156), (0.02817, -1.8028536321603)]),
        "AlFe": (4867.1182946454,
                 [(0.1818, -25.834107666296), (0.5099, -7.6073373918597),
                  (0.2802, -3.2526756183596), (0.02817, -1.6275487829767)]),
    }
    # exp-polynomial bridge exp(c0 + c1 r + c2 r^2 + c3 r^3)
    _SECOND = {
        "AlAl": (6.0801330531321, -2.3092752322555,
                 0.042696494305190, -0.07952189194038),
        "FeFe": (7.4122709384068, -0.64180690713367,
                 -2.6043547961722, 0.62625393931230),
        "AlFe": (6.6167846784367, -1.5208197629514,
                 -0.73055022396300, -0.03879272494264),
    }
    # segment boundaries: (first_hi, second_hi, knot tails start)
    _BOUNDS = {"AlAl": (1.6, 2.25, 2.25), "FeFe": (1.0, 2.05, 2.05),
               "AlFe": (1.2, 2.2, 2.2)}
    # knot tails: (knot r_k, [(factor, order), ...])
    _KNOTS = {
        "AlAl": [
            (3.2, [(17.222548257633, 4), (-13.838795389103, 5),
                   (26.724085544227, 6), (-4.8730831082596, 7),
                   (0.26111775221382, 8)]),
            (4.8, [(-1.8864362756631, 4), (2.4323070821980, 5),
                   (-4.0022263154653, 6), (1.3937173764119, 7),
                   (-0.31993486318965, 8)]),
            (6.5, [(0.30601966016455, 4), (-0.63945082587403, 5),
                   (0.54057725028875, 6), (-0.21210673993915, 7),
                   (0.03201431888287, 8)]),
        ],
        "FeFe": [
            (2.2, [(-27.444805994228, 3)]),
            (2.3, [(15.738054058489, 3)]),
            (2.4, [(2.2077118733936, 3)]),
            (2.5, [(-2.4989799053251, 3)]),
            (2.6, [(4.2099676494795, 3)]),
            (2.7, [(-0.77361294129713, 3)]),
            (2.8, [(0.80656414937789, 3)]),
            (3.0, [(-2.3194358924605, 3)]),
            (3.3, [(2.6577406128280, 3)]),
            (3.7, [(-1.0260416933564, 3)]),
            (4.2, [(0.35018615891957, 3)]),
            (4.7, [(-0.058531821042271, 3)]),
            (5.3, [(-0.0030458824556234, 3)]),
        ],
        "AlFe": [
            (3.2, [(-4.148701943924, 4), (5.6697481153271, 5),
                   (-1.7835153896441, 6), (-3.3886912738827, 7),
                   (1.9720627768230, 8)]),
            (6.2, [(0.094200713038410, 4), (-0.16163849208165, 5),
                   (0.10154590006100, 6), (-0.027624717063181, 7),
                   (0.0027505576632627, 8)]),
        ],
    }
    # densities: (order, [(factor, cutoff), ...]), keyed by the pair
    # class of the neighbor (FS style)
    _RHO = {
        "AlAl": (4, [(0.00019850823042883, 2.5), (0.10046665347629, 2.6),
                     (0.10054338881951, 2.7), (0.099104582963213, 2.8),
                     (0.090086286376778, 3.0), (0.0073022698419468, 3.4),
                     (0.014583614223199, 4.2), (-0.0010327381407070, 4.8),
                     (0.0073219994475288, 5.6), (0.0095726042919017, 6.5)]),
        "FeFe": (3, [(11.686859407970, 2.4), (-0.014710740098830, 3.2),
                     (0.47193527075943, 4.2)]),
        "AlFe": (4, [(0.010015421408039, 2.4), (0.0098878643929526, 2.5),
                     (0.0098070326434207, 2.6), (0.0084594444746494, 2.8),
                     (0.0038057610928282, 3.1), (-0.0014091094540309, 5.0),
                     (0.0074410802804324, 6.2)]),
    }

    @staticmethod
    def _pair_key(kbody_term: str) -> str:
        els = sorted(get_elements_from_kbody_term(kbody_term))
        return "".join(els) if els[0] != els[1] else els[0] * 2

    def initial_params(self, sections, dtype=None, device=None):
        return {}

    def phi(self, params, r, kbody_term, fixed=False):
        key = self._pair_key(kbody_term)
        lo1, hi2, knot_lo = self._BOUNDS[key]
        scale, terms = self._FIRST[key]
        c0, c1, c2, c3 = self._SECOND[key]

        r_safe = _maximum(r, 1e-8)
        y1 = scale / r_safe * sum(
            b * torch.exp(c * r_safe) for b, c in terms)
        y1 = torch.where(r < lo1, y1, 0.0)
        y2 = torch.exp(c0 + r * (c1 + r * (c2 + r * c3)))
        y2 = torch.where((r >= lo1) & (r < hi2), y2, 0.0)
        y = y1 + y2
        for r_k, factors in self._KNOTS[key]:
            base = _maximum(r_k - r, 0.0)
            tail = sum(a * base ** p for a, p in factors)
            y = y + torch.where(r >= knot_lo, tail, 0.0)
        return y

    def rho(self, params, r, element_or_term, fixed=False):
        # FS: the section is the ordered pair 'AB' = center A, neighbor
        # B; the density function depends on the pair class
        key = self._pair_key(element_or_term) \
            if len(get_elements_from_kbody_term(element_or_term)) == 2 \
            else element_or_term * 2
        order, rows = self._RHO[key]
        return sum(a * _maximum(r_c - r, 0.0) ** order for a, r_c in rows)

    def embed(self, params, rho, element, fixed=False):
        safe = _maximum(rho, 1e-12)
        if element == "Al":
            y = (-torch.sqrt(safe) + 0.000093283590195398 * safe ** 2 -
                 0.0023491751192724 * safe * torch.log(safe))
            return torch.where(rho >= 1e-12, y, 0.0)
        return (-torch.sqrt(safe) - 0.00067314115586063 * rho ** 2 +
                0.000000076514905604792 * rho ** 4)


available_potentials["msah11"] = AlFeMsah11()


# ----------------------------------------------------------------------
class AgrawalBe(EmpiricalPotential):
    """Agrawal et al. Be EAM (Modelling Simul. Mater. Sci. Eng. 2013):
    Morse pair + exponential density, both forced smoothly to zero at rc
    by the (rc/m)(1-(r/rc)^m) f' tail;
    F(rho) = F0 (1 - beta ln rho) rho^beta + F1 rho^gamma."""

    name = "agrawal"
    defaults = {"Be": {"A": 1.597, "B": 9.49713, "D": 0.41246,
                       "alpha": 0.36324, "re": 2.29, "F0": -2.0393,
                       "F1": 12.6178, "beta": 0.18752,
                       "gamma": -2.28827, "m": 10.0, "rc": 5.0}}
    always_fixed = {"*": ["m", "rc"]}

    @staticmethod
    def _morse(r, d, g, r0):
        x = g * (r - r0)
        return d * (torch.exp(-2.0 * x) - 2.0 * torch.exp(-x))

    @staticmethod
    def _morse_prime(r, d, g, r0):
        x = g * (r - r0)
        return 2.0 * d * g * (torch.exp(-x) - torch.exp(-2.0 * x))

    def phi(self, params, r, kbody_term, fixed=False):
        el = get_elements_from_kbody_term(kbody_term)[0]
        p = self.resolve(params, el, fixed)
        rc, m = p["rc"], p["m"]
        rc_t = torch.as_tensor(rc, dtype=r.dtype, device=r.device)
        phi0 = self._morse(r, p["D"], p["alpha"], p["re"])
        phi1 = -self._morse(rc_t, p["D"], p["alpha"], p["re"])
        dphi = self._morse_prime(rc_t, p["D"], p["alpha"], p["re"])
        phi2 = rc / m * (1.0 - (r / rc) ** m) * dphi
        return phi0 + phi1 + phi2

    def rho(self, params, r, element, fixed=False):
        p = self.resolve(params, self._rho_element(element), fixed)
        rc, m = p["rc"], p["m"]
        rc_t = torch.as_tensor(rc, dtype=r.dtype, device=r.device)
        rho0 = p["A"] * torch.exp(-p["B"] * (r - p["re"]))
        rho1 = p["A"] * torch.exp(-p["B"] * (rc_t - p["re"]))
        drho = -p["A"] * p["B"] * torch.exp(-p["B"] * (rc_t - p["re"]))
        return rho0 - rho1 + rc / m * (1.0 - (r / rc) ** m) * drho

    def embed(self, params, rho, element, fixed=False):
        p = self.resolve(params, element, fixed)
        safe = _maximum(rho, 1e-12)
        logrho = torch.log(safe)
        return (p["F0"] * (1.0 - p["beta"] * logrho) *
                safe ** p["beta"] + p["F1"] * safe ** p["gamma"])


available_potentials["agrawal"] = AgrawalBe()


# ----------------------------------------------------------------------
class MishinH(EmpiricalPotential):
    """Mishin-style hydrogen-in-metal potential: embedding
    F(rho) = [s1 rho + s2 rho^2 + s3 rho^3 - s4 rho^s5] * Omega(rho),
    Omega(rho) = 1 - (1 - s6 rho^2)/(1 + s7 rho^4), and ADP
    dipole/quadrupole terms u/w(r) = (p1 e^{-p2 r} + p3) psi((r-rc)/h).

    It has no phi or rho of its own: select 'nn' or a tabulated/spline
    form for those functions."""

    name = "mishinh"

    defaults = {
        "Mo": dict(s1=-2.00695289e-01, s2=-3.12178751e-04,
                   s3=7.86343222e-05, s4=5.29721645e+00,
                   s5=3.79481951e-02, s6=1.11800974e+02,
                   s7=4.05948858e+00),
        "Al": dict(s1=-3.72848864e-01, s2=6.52035828e-03,
                   s3=9.71742655e-05, s4=7.64264116e+00,
                   s5=6.88604789e-02, s6=1.55694016e+01,
                   s7=5.38646368e+00),
        "H": dict(s1=8.08612, s2=1.46294e-2, s3=-6.86143e-3, s4=3.19616,
                  s5=1.17247e-1, s6=50.0, s7=15e5),
        "NiNi": dict(d1=4.4657e-3, d2=-1.3702e0, d3=-0.9611e-1,
                     q1=6.4502e0, q2=0.2608e-1, q3=-6.0208e0,
                     h=3.323, rc=5.168),
        "FeFe": dict(d1=1.9135e-1, d2=-1.0796e0, d3=-0.8928e-1,
                     q1=-5.8954e-2, q2=-1.3872e0, q3=2.4790e0,
                     h=6.202, rc=5.055),
    }

    def __init__(self):
        d = {k: dict(v) for k, v in self.defaults.items()}
        d["MoMo"] = dict(d["NiNi"])
        d["MoNi"] = dict(d["NiNi"])
        d["BeBe"] = dict(d["MoMo"])
        self.defaults = d

    def embed(self, params, rho, element, fixed=False):
        p = self.resolve(params, element, fixed)
        rho2 = rho * rho
        rho3 = rho * rho2
        rho4 = rho2 * rho2
        rhos5 = (rho + 1e-12) ** p["s5"]
        omega = 1.0 - (1.0 - p["s6"] * rho2) / (1.0 + p["s7"] * rho4)
        core = (p["s1"] * rho + p["s2"] * rho2 + p["s3"] * rho3 -
                p["s4"] * rhos5)
        return core * omega

    def polar_params(self, params, kbody_term, which, fixed=False):
        """(p1, p2, p3, rc, h) of the dipole (`which` "d") or the
        quadrupole ("q") of a pair term."""
        key = "".join(sorted(get_elements_from_kbody_term(kbody_term)))
        key = key if key in self.defaults else kbody_term
        p = self.resolve(params, key, fixed)
        return (p[which + "1"], p[which + "2"], p[which + "3"], p["rc"],
                p["h"])

    def _polar(self, params, r, kbody_term, which, fixed):
        return mishin_polar(r, *self.polar_params(params, kbody_term, which,
                                                  fixed))

    def dipole(self, params, r, kbody_term, fixed=False):
        return self._polar(params, r, kbody_term, "d", fixed)

    def quadrupole(self, params, r, kbody_term, fixed=False):
        return self._polar(params, r, kbody_term, "q", fixed)


class RWGrimes(EmpiricalPotential):
    """Grimes Pu potential (J. Nucl. Mater. 461 (2015) 206):
    phi = Morse + Buckingham, rho = (n / r^8) [1/2 + 1/2 erf(20 (r -
    1.5))], F = -G sqrt(rho)."""

    name = "grimes"
    defaults = {"PuPu": dict(A=18600.0, rho=0.2637, C=0.0, D=0.70185,
                             gamma=1.98008, r0=2.34591),
                "Pu": dict(G=2.168, n=3980.058)}

    def phi(self, params, r, kbody_term, fixed=False):
        key = "".join(sorted(get_elements_from_kbody_term(kbody_term)))
        p = self.resolve(params, key, fixed)
        return (morse_fn(r, p["D"], p["gamma"], p["r0"]) +
                buckingham(r, p["A"], p["rho"], p["C"]))

    def rho(self, params, r, element, fixed=False):
        p = self.resolve(params, self._rho_element(element), fixed)
        left = p["n"] / _maximum(r, 1e-8) ** 8
        right = 0.5 + 0.5 * torch.erf(20.0 * (r - 1.5))
        return left * right

    def embed(self, params, rho, element, fixed=False):
        p = self.resolve(params, element, fixed)
        return -p["G"] * torch.sqrt(_maximum(rho, 0.0))


available_potentials["mishinh"] = MishinH()
available_potentials["grimes"] = RWGrimes()
