"""Descriptor kernels through hand-written CUDA kernels (port of
`tensoralloy_tpu/ops/fused.py`): Behler G2/G4 and GRAP.

Each descriptor has three pieces:
  * a plain PyTorch twin (`g2_reference`, `g4_reference`,
    `grap_reference`), the port of `_g2_ref_dense` / `_g4_ref_dense` /
    `_grap_ref_dense`: dense [A, N, ...] math, any device;
  * a kernel wrapper (`g2_kernel`, `g4_kernel`, `grap_kernel`): on a CPU
    tensor it returns the twin; on a CUDA tensor it launches the kernel
    from `csrc/` or raises — there is no fallback;
  * an autograd Function (`G2Function`, `G4Function`, `GrapFunction`),
    the port of `_custom_vjp_op`: forward is the kernel wrapper,
    backward recomputes the twin from the saved inputs and returns its
    VJP. When the backward runs with grad mode on (a caller asked for
    `create_graph=True`, as a force loss does) the VJP is built on the
    saved inputs themselves and stays in the graph, so it can be
    differentiated again w.r.t. the incoming gradient and the inputs;
    otherwise no graph is kept. There is no backward kernel, as in the
    JAX package: the second derivative is the twin's.

The CUDA sources `csrc/*.cu` are compiled with nvcc for sm_90a, one nvcc
per source (one per entry point for `sf_kernels.cu`), all started
together, and linked into one shared library with a plain C interface,
at first use, into `_build/` next to this package, and loaded with
ctypes. What a launch needs beyond its tensors (the host tables, the
bound C function and its constant arguments) is built once per
descriptor specification and kept; a call checks its inputs, allocates
the output and passes pointers, sizes and the stream.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .cutoffs import CUTOFF_IDS, apply_cutoff

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR / "_build"
MAX_PARAMS = 64          # kMaxParams in csrc/sf_kernels.cu
MAX_FILTERS = 64         # kMaxFilters in csrc/grap_kernel.cu
MAX_MOMENT = 5           # kMaxMonomials = 56 in csrc/grap_kernel.cu
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v", "-c")
LINK_FLAGS = ARCH_FLAGS + ("-shared",)
# A source whose entry points compile one per object (-D<macro>=<i>), so
# that its instantiations are shared between as many compilers
SPLIT_SOURCES = {"sf_kernels.cu": ("SF_ENTRY", 4)}

# Launches of each kernel since the last `reset_launch_counts()`; a
# wrapper adds one where it launches its kernel and nowhere else.
launch_counts: Dict[str, int] = {"g2": 0, "g4": 0, "grap": 0}

_lib: Optional[ctypes.CDLL] = None
build_log = ""

# What a launch needs beyond its tensors is built once and kept: the host
# tables by the content of the descriptor's specification, and the bound C
# function with its constant arguments by (specification, launch constants,
# dtype[, device]). A descriptor with another grid has another key.
_host_tables: Dict[tuple, tuple] = {}
_bound: Dict[tuple, tuple] = {}
_CACHE_LIMIT = 256
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def reset_launch_counts() -> None:
    for key in launch_counts:
        launch_counts[key] = 0


def _twin_vjp(twin, diff, rest, spec, gbar):
    """VJP of `twin(*diff, *rest, *spec)` w.r.t. `diff` along `gbar`, for
    the backward of a kernel's autograd Function. Under grad mode (the
    caller differentiates with `create_graph=True`) the twin is rebuilt
    on the saved inputs themselves and the result stays in the graph:
    it depends differentiably on `gbar` and on the inputs. Otherwise the
    inputs are detached and no graph outlives the call."""
    if torch.is_grad_enabled():
        # a view of each input: a node of its own, so that the VJP
        # w.r.t. one input does not run on through another input that
        # was computed from it (ux = vx / rij)
        x = [d.view_as(d) if d.requires_grad
             else d.detach().requires_grad_() for d in diff]
        y = twin(*x, *rest, *spec)
        return torch.autograd.grad(y, x, gbar, create_graph=True)
    with torch.enable_grad():
        x = [d.detach().requires_grad_() for d in diff]
        y = twin(*x, *rest, *spec)
        return torch.autograd.grad(y, x, gbar)


# ----------------------------------------------------------------------
# Build and bind
# ----------------------------------------------------------------------

def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for path in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                       "descriptor kernels are built from source at first "
                       "use")


def kernel_sources():
    """The `.cu` files compiled into the library."""
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    """Hash over every file under csrc/ (sources and headers) and the
    flags: a library is rebuilt when any of them changes."""
    h = hashlib.sha1(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode()
                     + repr(SPLIT_SOURCES).encode())
    for path in sorted(CSRC_DIR.iterdir()):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def _run_all(commands):
    """Run the commands concurrently -> [(returncode, output)]."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in commands]
    outputs = [p.communicate()[0] for p in procs]
    return [(p.returncode, out) for p, out in zip(procs, outputs)]


def build_kernels() -> Path:
    """Compile every `csrc/*.cu` (one nvcc each, or one per entry point
    for `SPLIT_SOURCES`, all started together), link
    them into one library (skipped when a library built from the same
    sources exists) and return its path. The compilers' output, with
    ptxas' register and spill report, is kept in `build_log`."""
    global build_log
    lib_path = BUILD_DIR / f"libtat_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        nvcc = _nvcc()
        units = []      # (source, extra flags)
        for src in kernel_sources():
            macro, parts = SPLIT_SOURCES.get(src.name, (None, 1))
            units += [(src, [f"-D{macro}={i}"] if macro else [])
                      for i in range(parts)]
        objects = [os.path.join(work, f"{i}.o") for i in range(len(units))]
        results = _run_all([[nvcc, *COMPILE_FLAGS, *define, "-o", obj,
                             str(src)]
                            for (src, define), obj in zip(units, objects)])
        tmp = os.path.join(work, lib_path.name)
        if all(code == 0 for code, _ in results):
            results += _run_all([[nvcc, *LINK_FLAGS, "-o", tmp, *objects]])
        names = [" ".join([src.name, *define])
                 for src, define in units] + ["link"]
        build_log = "".join(f"== {name}\n{out}"
                            for name, (_, out) in zip(names, results))
        if len(results) != len(names) or any(code for code, _ in results):
            raise RuntimeError(f"nvcc failed:\n{build_log}")
        os.replace(tmp, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_kernels()))
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for dt in ("f32", "f64"):
            g2 = getattr(lib, f"sf_g2_{dt}")
            g2.argtypes = [p, p, p, p, i, i, i, i, p, p, d, i, p]
            g2.restype = i
            g4 = getattr(lib, f"sf_g4_{dt}")
            g4.argtypes = [p, p, p, p, p, p, i, i, i, i, p, p, p, d, i, p]
            g4.restype = i
            grap = getattr(lib, f"grap_{dt}")
            grap.argtypes = [p] * 8 + [i] * 5 + [p] * 3 + [i, p, i, p, d,
                                                            i, p]
            grap.restype = i
        _lib = lib
    return _lib


def _check_cuda_inputs(name: str, *tensors: torch.Tensor) -> None:
    ref = tensors[0]
    dtype, device, shape = ref.dtype, ref.device, ref.shape
    if dtype not in _SUFFIX:
        raise TypeError(f"{name}: float32 or float64 inputs required, "
                        f"got {dtype}")
    if len(shape) != 2:
        raise ValueError(f"{name}: [rows, n] inputs required, got shape "
                         f"{tuple(shape)}")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: inputs on {t.device} and {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {dtype}")
        if t.shape != shape:
            raise ValueError(f"{name}: shapes {tuple(t.shape)} and "
                             f"{tuple(shape)} differ")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if shape[0] >= 2 ** 31 or shape[1] >= 2 ** 31:
        raise ValueError(f"{name}: shape {tuple(shape)} too large")


def _check_launch(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {code}")


def _grid_columns(grid: np.ndarray) -> Tuple[np.ndarray, ...]:
    if len(grid) > MAX_PARAMS:
        raise ValueError(f"at most {MAX_PARAMS} parameter rows, got "
                         f"{len(grid)}")
    return tuple(np.ascontiguousarray(grid[:, c], dtype=np.float64)
                 for c in range(grid.shape[1]))


def _keep(cache: dict, key, value):
    """Store `value` under `key` in a bounded cache -> value."""
    if len(cache) >= _CACHE_LIMIT:
        cache.clear()
    cache[key] = value
    return value


def _read_only(arrays):
    for a in arrays:
        a.setflags(write=False)
    return arrays


def grid_spec(grid: np.ndarray) -> tuple:
    """Immutable specification of a parameter grid: its content."""
    return grid.shape, grid.dtype.str, grid.tobytes()


def grid_tables(grid) -> Tuple[np.ndarray, ...]:
    """The float64 columns of a G2 / G4 parameter grid as the kernels
    take them, built once per grid content and kept, read-only."""
    grid = np.asarray(grid)
    key = grid_spec(grid)
    cols = _host_tables.get(key)
    if cols is None:
        cols = _keep(_host_tables, key, _read_only(_grid_columns(grid)))
    return cols


def _bound_sf(kind: str, grid, rc: float, cutoff: str, n_slots: int,
              dtype) -> tuple:
    """-> (the C entry point of G2 / G4 for `dtype`, its constant
    arguments (n_slots, n_params, the grid columns, rc, the cutoff id),
    n_params), bound once per (grid content, rc, cutoff, n_slots, dtype).
    The tuple holds the columns so that the pointers stay valid."""
    grid = np.asarray(grid)
    key = (kind, grid_spec(grid), rc, cutoff, n_slots, dtype)
    bound = _bound.get(key)
    if bound is None:
        cols = grid_tables(grid)
        fn = getattr(_library(), f"sf_{kind}_{_SUFFIX[dtype]}")
        tail = (n_slots, len(cols[0]), *(c.ctypes.data for c in cols),
                float(rc), CUTOFF_IDS[cutoff])
        bound = _keep(_bound, key, (fn, tail, len(cols[0]), cols))
    return bound


def _launch(name: str, fn, device, *args) -> None:
    """Call the C entry point `fn(*args, stream)` with `device` current,
    on its current stream; raise if the launch is refused. The stream's
    handle is read without building a `torch.cuda.Stream` (a quarter of
    a call's host time on an H100 host)."""
    if device.index == torch.cuda.current_device():
        code = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            code = fn(*args,
                      torch._C._cuda_getCurrentRawStream(device.index))
    _check_launch(name, code)
    launch_counts[name] += 1


# ----------------------------------------------------------------------
# Behler G2 (radial)
# ----------------------------------------------------------------------

def g2_reference(rij, islotf, mask, grid, rcut: float, cutoff: str,
                 n_slots: int):
    """Plain twin: [A, N] inputs -> [A, n_slots * T2], (slot, param)
    order. `grid` is the [T2, 2] (eta, omega) table."""
    a, _ = rij.shape
    r = torch.where(mask > 0, rij, 1.0)
    fc = apply_cutoff(cutoff, r, rcut) * mask
    grid = torch.as_tensor(np.asarray(grid), dtype=rij.dtype,
                           device=rij.device)
    eta, omega = grid[:, 0], grid[:, 1]
    z = torch.square(r[..., None] - omega) / (rcut * rcut)
    v = torch.exp(-eta * z) * fc[..., None]                # [A, N, T2]
    eye = torch.arange(n_slots, dtype=islotf.dtype, device=islotf.device)
    sel = (islotf[..., None] == eye) * mask[..., None]     # [A, N, S]
    g = torch.einsum("ans,ant->ast", sel, v)
    return g.reshape(a, n_slots * grid.shape[0])


def g2_kernel(rij, islotf, mask, grid, rcut: float, cutoff: str,
              n_slots: int):
    """G2 through the CUDA kernel `g2_kernel` (replaces the Pallas
    `_g2_kernel`, tensoralloy_tpu/ops/fused.py:326); the twin for CPU
    tensors. On the H100 it is bound by reading the three [A, N] inputs;
    one cutoff and T2 exp2 per pair must overlap the reads. One warp per
    atom row, persistent warps striding over the rows with the next
    span's loads in flight during this span's math, up to 4 slots
    accumulated in one pass, xor-shuffle reduction (see the source). The
    grid columns and the bound C function are kept per (grid, rcut,
    cutoff, n_slots, dtype); a call passes pointers, sizes and stream."""
    if rij.device.type == "cpu":
        return g2_reference(rij, islotf, mask, grid, rcut, cutoff, n_slots)
    if rij.device.type != "cuda":
        raise ValueError(f"g2_kernel: no kernel for device {rij.device}")
    _check_cuda_inputs("g2_kernel", rij, islotf, mask)
    fn, tail, n_params, _ = _bound_sf("g2", grid, rcut, cutoff, n_slots,
                                      rij.dtype)
    rows, n = rij.shape
    out = torch.empty((rows, n_slots * n_params), dtype=rij.dtype,
                      device=rij.device)
    if rows == 0:
        return out
    _launch("g2", fn, rij.device, rij.data_ptr(), islotf.data_ptr(),
            mask.data_ptr(), out.data_ptr(), rows, n, *tail)
    return out


class G2Function(torch.autograd.Function):
    """Differentiable G2 w.r.t. `rij`; no gradient for slots or mask."""

    @staticmethod
    def forward(ctx, rij, islotf, mask, grid, rcut, cutoff, n_slots):
        ctx.save_for_backward(rij, islotf, mask)
        ctx.spec = (grid, rcut, cutoff, n_slots)
        return g2_kernel(rij, islotf, mask, grid, rcut, cutoff, n_slots)

    @staticmethod
    def backward(ctx, gbar):
        rij, islotf, mask = ctx.saved_tensors
        (grad,) = _twin_vjp(g2_reference, [rij], [islotf, mask], ctx.spec,
                            gbar)
        return grad, None, None, None, None, None, None


# ----------------------------------------------------------------------
# Behler G4 (angular)
# ----------------------------------------------------------------------

def _g4_values(grid, cutoff: str, acut: float, rij, rik, rjk):
    """Per-triple G4 terms, one tensor per (beta, gamma, zeta) row."""
    rij2, rik2, rjk2 = rij * rij, rik * rik, rjk * rjk
    z = (rij2 + rik2 + rjk2) / (acut * acut)
    cos_theta = (rij2 + rik2 - rjk2) / (2.0 * rij * rik)
    fc3 = (apply_cutoff(cutoff, rij, acut) *
           apply_cutoff(cutoff, rik, acut) *
           apply_cutoff(cutoff, rjk, acut))
    out = []
    for beta, gamma, zeta in np.asarray(grid, dtype=np.float64).tolist():
        base = torch.clamp(1.0 + gamma * cos_theta, min=0.0)
        out.append(2.0 ** (1.0 - zeta) * base ** zeta *
                   torch.exp(-beta * z) * fc3)
    return out


def g4_reference(rij, rik, rjk, aslotf, mask, grid, acut: float,
                 cutoff: str, n_slots: int):
    """Plain twin: [A, Nt] inputs -> [A, n_slots * T4]. `grid` is the
    [T4, 3] (beta, gamma, zeta) table. Masked distances read 1.0 before
    cos(theta) divides by r_ij r_ik."""
    a, _ = rij.shape

    def safe(x):
        return torch.where(mask > 0, x, 1.0)

    vals = _g4_values(grid, cutoff, acut, safe(rij), safe(rik), safe(rjk))
    v = torch.stack(vals, dim=-1) * mask[..., None]        # [A, N, T4]
    eye = torch.arange(n_slots, dtype=aslotf.dtype, device=aslotf.device)
    sel = (aslotf[..., None] == eye) * mask[..., None]
    g = torch.einsum("ans,ant->ast", sel, v)
    return g.reshape(a, n_slots * len(vals))


def g4_kernel(rij, rik, rjk, aslotf, mask, grid, acut: float, cutoff: str,
              n_slots: int):
    """G4 through the CUDA kernel `g4_kernel` (replaces the Pallas
    `_g4_kernel`, tensoralloy_tpu/ops/fused.py:412); the twin for CPU
    tensors. On the H100 it is bound by reading the five [A, Nt] inputs
    plus three cutoffs and T4 pow/exp per triple; no matmul."""
    if rij.device.type == "cpu":
        return g4_reference(rij, rik, rjk, aslotf, mask, grid, acut,
                            cutoff, n_slots)
    if rij.device.type != "cuda":
        raise ValueError(f"g4_kernel: no kernel for device {rij.device}")
    _check_cuda_inputs("g4_kernel", rij, rik, rjk, aslotf, mask)
    fn, tail, n_params, _ = _bound_sf("g4", grid, acut, cutoff, n_slots,
                                      rij.dtype)
    rows, n = rij.shape
    out = torch.empty((rows, n_slots * n_params), dtype=rij.dtype,
                      device=rij.device)
    if rows == 0:
        return out
    _launch("g4", fn, rij.device, rij.data_ptr(), rik.data_ptr(),
            rjk.data_ptr(), aslotf.data_ptr(), mask.data_ptr(),
            out.data_ptr(), rows, n, *tail)
    return out


class G4Function(torch.autograd.Function):
    """Differentiable G4 w.r.t. `rij`, `rik`, `rjk`."""

    @staticmethod
    def forward(ctx, rij, rik, rjk, aslotf, mask, grid, acut, cutoff,
                n_slots):
        ctx.save_for_backward(rij, rik, rjk, aslotf, mask)
        ctx.spec = (grid, acut, cutoff, n_slots)
        return g4_kernel(rij, rik, rjk, aslotf, mask, grid, acut, cutoff,
                         n_slots)

    @staticmethod
    def backward(ctx, gbar):
        rij, rik, rjk, aslotf, mask = ctx.saved_tensors
        grads = _twin_vjp(g4_reference, [rij, rik, rjk], [aslotf, mask],
                          ctx.spec, gbar)
        return (*grads, None, None, None, None, None, None)


# ----------------------------------------------------------------------
# GRAP: filter bank x moment invariants
# ----------------------------------------------------------------------

# Each GRAP algorithm's parameter names, in the kernel's column order
# (GrapSpec c0, c1, c2 in csrc/grap_kernel.cu); the descriptor's grid
# (`nn.grap._param_grid`) orders them sorted.
GRAP_ALGORITHMS = {"sf": ("eta", "omega"), "density": ("A", "beta", "re"),
                   "morse": ("D", "gamma", "r0"), "pexp": ("rl", "pl")}


def grap_reference(rij, ux, uy, uz, islotf, mask, desc, rcut: float,
                   n_slots: int):
    """Plain twin: [A, N] inputs -> [A, n_slots * K * M], (slot, filter,
    moment) order. `desc` is the `nn.grap.GenericRadialAtomicPotential`
    (its filter bank `_filter_values`, where 'sf' scales eta by 1/rc^2,
    and its `invariants_from_p`). Masked distances read 1.0 and every
    term is multiplied by the mask, as in the JAX package."""
    from ..nn.grap import moment_basis_c
    a, n = rij.shape
    r = torch.where(mask > 0, rij, 1.0)
    fc = apply_cutoff(desc.cutoff_function, r, rcut) * mask
    h = desc._filter_values(r, rcut) * fc[..., None]       # [A, N, K]
    m = moment_basis_c((ux, uy, uz), desc.max_moment)      # [A, N, D]
    k = desc.n_filters
    eye = torch.arange(n_slots, dtype=islotf.dtype, device=islotf.device)
    sel = (islotf[..., None] == eye) * mask[..., None]     # [A, N, S]
    hs = (sel[..., None] * h[..., None, :]).reshape(a, n, n_slots * k)
    p = torch.einsum("anx,and->axd", hs, m)
    p = p.reshape(a * n_slots, k, m.shape[-1])
    return desc.invariants_from_p(p, a, n_slots)


def monomial_codes(max_moment: int) -> np.ndarray:
    """[D] uint16 code of each monomial of `nn.grap.moment_monomials`, in
    its order, for the GRAP kernel: bits 0-2 hold the degree, then two
    bits per factor hold its axis (0, 1, 2), in the tuple's sorted order.
    The kernel multiplies 1 by the factors left to right, the order in
    which `moment_basis_c` builds each monomial from its prefix."""
    from ..nn.grap import moment_monomials
    codes = []
    for mono in moment_monomials(max_moment):
        code = len(mono)
        for i, ax in enumerate(mono):
            code |= ax << (3 + 2 * i)
        codes.append(code)
    return np.asarray(codes, np.uint16)


def grap_tables(desc):
    """Host tables of the GRAP kernel: (algorithm id, the three grid
    columns [K] in kernel order, the monomial codes [D], the invariant
    weights [D, M] in float64, the moments [M])."""
    from ..nn.grap import multiplicity_tensor
    if desc.algorithm not in GRAP_ALGORITHMS:
        raise ValueError(f"grap_kernel: no kernel for algorithm "
                         f"{desc.algorithm!r}")
    if desc.n_filters > MAX_FILTERS or desc.max_moment > MAX_MOMENT:
        raise ValueError(
            f"grap_kernel: at most {MAX_FILTERS} filters and moment "
            f"{MAX_MOMENT}, got {desc.n_filters} and {desc.max_moment}")
    names = GRAP_ALGORITHMS[desc.algorithm]
    cols = [np.ascontiguousarray(desc._grid[:, desc._grid_keys.index(key)],
                                 dtype=np.float64) for key in names]
    cols += [np.zeros(desc.n_filters)] * (3 - len(cols))
    codes = monomial_codes(desc.max_moment)
    weights = np.ascontiguousarray(multiplicity_tensor(
        desc.max_moment, desc.symmetric)[:, desc.moment_tensors])
    moments = np.asarray(desc.moment_tensors, np.int32)
    algorithm = list(GRAP_ALGORITHMS).index(desc.algorithm)
    return algorithm, cols, codes, weights, moments


def grap_spec(desc) -> tuple:
    """Immutable specification of what `grap_tables(desc)` depends on."""
    return (desc.algorithm, tuple(desc._grid_keys), grid_spec(desc._grid),
            tuple(desc.moment_tensors), desc.max_moment,
            bool(desc.symmetric))


def kept_grap_tables(desc):
    """`grap_tables(desc)`, built once per specification and kept,
    read-only."""
    key = ("grap", grap_spec(desc))
    tables = _host_tables.get(key)
    if tables is None:
        tables = grap_tables(desc)
        _, cols, codes, weights, moments = tables
        _read_only([*cols, codes, weights, moments])
        _keep(_host_tables, key, tables)
    return tables


def _bound_grap(desc, rcut: float, n_slots: int, dtype, device) -> tuple:
    """-> (the C entry point of GRAP for `dtype`, the [D, M] weights on
    `device` (a copy from host memory at each call would wait for the
    work already queued on the stream), the constant arguments that
    follow (rows, n), the output columns), bound once per
    (specification, cutoff, rcut, n_slots, dtype, device). The tuple
    holds the host tables so that the pointers stay valid."""
    key = ("grap", grap_spec(desc), desc.cutoff_function, rcut, n_slots,
           dtype, device)
    bound = _bound.get(key)
    if bound is None:
        tables = kept_grap_tables(desc)
        algorithm, cols, codes, weights, moments = tables
        fn = getattr(_library(), f"grap_{_SUFFIX[dtype]}")
        w = torch.as_tensor(weights.copy(), dtype=dtype, device=device)
        k = len(cols[0])
        tail = (n_slots, algorithm, k, *(c.ctypes.data for c in cols),
                len(codes), codes.ctypes.data, len(moments),
                moments.ctypes.data, float(rcut),
                CUTOFF_IDS[desc.cutoff_function])
        bound = _keep(_bound, key, (fn, w, tail, n_slots * k * len(moments),
                                    tables))
    return bound


def grap_kernel(rij, ux, uy, uz, islotf, mask, desc, rcut: float,
                n_slots: int):
    """GRAP invariants through the CUDA kernel `grap_kernel` (replaces
    the Pallas `_grap_kernel`, tensoralloy_tpu/ops/fused.py:170); the
    twin for CPU tensors. On the H100 it is bound by the P contraction's
    FMAs (see the source)."""
    if rij.device.type == "cpu":
        return grap_reference(rij, ux, uy, uz, islotf, mask, desc, rcut,
                              n_slots)
    if rij.device.type != "cuda":
        raise ValueError(f"grap_kernel: no kernel for device {rij.device}")
    _check_cuda_inputs("grap_kernel", rij, ux, uy, uz, islotf, mask)
    fn, w, tail, n_out, _ = _bound_grap(desc, rcut, n_slots, rij.dtype,
                                        rij.device)
    rows, n = rij.shape
    out = torch.empty((rows, n_out), dtype=rij.dtype, device=rij.device)
    if rows == 0:
        return out
    _launch("grap", fn, rij.device, rij.data_ptr(), ux.data_ptr(),
            uy.data_ptr(), uz.data_ptr(), islotf.data_ptr(), mask.data_ptr(),
            w.data_ptr(), out.data_ptr(), rows, n, *tail)
    return out


class GrapFunction(torch.autograd.Function):
    """Differentiable GRAP w.r.t. `rij`, `ux`, `uy`, `uz` (the JAX op's
    `n_diff=4`); no gradient for slots or mask."""

    @staticmethod
    def forward(ctx, rij, ux, uy, uz, islotf, mask, desc, rcut, n_slots):
        ctx.save_for_backward(rij, ux, uy, uz, islotf, mask)
        ctx.spec = (desc, rcut, n_slots)
        return grap_kernel(rij, ux, uy, uz, islotf, mask, desc, rcut,
                           n_slots)

    @staticmethod
    def backward(ctx, gbar):
        rij, ux, uy, uz, islotf, mask = ctx.saved_tensors
        grads = _twin_vjp(grap_reference, [rij, ux, uy, uz],
                          [islotf, mask], ctx.spec, gbar)
        return (*grads, None, None, None, None, None)
