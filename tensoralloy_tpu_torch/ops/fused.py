"""Descriptor kernels through hand-written CUDA kernels (port of
`tensoralloy_tpu/ops/fused.py`): Behler G2/G4 and GRAP.

Each descriptor has five pieces:
  * a plain PyTorch twin (`g2_reference`, `g4_reference`,
    `grap_reference`), the port of `_g2_ref_dense` / `_g4_ref_dense` /
    `_grap_ref_dense`: dense [A, N, ...] math, any device;
  * a forward kernel wrapper (`g2_kernel`, `g4_kernel`, `grap_kernel`):
    on a CPU tensor it returns the twin; on a CUDA tensor it launches
    the kernel from `csrc/` or raises — there is no fallback;
  * the closed-form VJP (`g2_vjp_reference`, `g4_vjp_reference`,
    `grap_vjp_reference`): the derivative of the twin written out as
    tensor code, for a cotangent with a leading batch dimension
    [B, A, F], the same formulas as the VJP kernels;
  * a VJP kernel wrapper (`g2_vjp_kernel`, `g4_vjp_kernel`,
    `grap_vjp_kernel`): the closed form on CPU tensors, the kernel from
    `csrc/sf_vjp.cu` / `csrc/grap_vjp.cu` or an error on CUDA ones;
  * an autograd Function (`G2Function`, `G4Function`, `GrapFunction`),
    the port of `_custom_vjp_op`: forward is the kernel wrapper.
Each has a second order as well: the closed form of the VJP's own VJP
(`g2_vjp_bwd_reference`, `g4_vjp_bwd_reference`,
`grap_vjp_bwd_reference`), its kernel wrapper (`g2_vjp_bwd_kernel`,
`g4_vjp_bwd_kernel`, `csrc/sf_vjp_bwd.cu`; `grap_vjp_bwd_kernel`,
`csrc/grap_vjp_bwd.cu`) and an autograd Function of the VJP
(`G2VjpFunction`, `G4VjpFunction`, `GrapVjpFunction`: forward the VJP
kernel wrapper, backward the second-order one).

The Functions' backward takes one of three routes, chosen by the order
of the derivative the caller asked for, never by what failed:
  * grad mode off (`torch.autograd.grad` without `create_graph`: every
    calculator request, MD, FIRE and NEB step, committee and chunked
    block, and a Hessian row's term through the descriptors): the VJP
    kernel wrapper, one launch a backward, no graph;
  * grad mode on (`create_graph=True`: a force loss in training, the
    elastic constraint, a Hessian's forces): the VJP Function
    on the saved inputs, one VJP launch, in the graph; its backward
    (the loss backward of a train step, a Hessian row) is the
    second-order kernel wrapper, one launch, which skips the geometry
    term where the running backward does not use it
    (`torch._C._will_engine_execute_node`);
  * grad mode on in a backward of the VJP Function (third order: the
    elastic constraint's strain Hessian differentiated for the
    parameters, `make_hessian_fn(create_graph=True)`): the twin is
    rebuilt on the saved inputs and its autograd VJP (of the VJP) stays
    in the graph, differentiable to any order as the JAX op's `jax.vjp`
    of the reference is.
A cotangent batched by `is_grads_batched` (legacy vmap) has no storage
a kernel can be given: on the CPU the twin route takes it, on CUDA the
backward raises. The callers that
batch cotangents (`ensemble`, `linear.model`) record the Functions'
calls while the descriptors are computed (`record_calls`) and take the
batched VJP through the kernels with `descriptor_vjp`.

The CUDA sources `csrc/*.cu` are compiled with nvcc for sm_90a, one nvcc
per source (one per entry point for the sources in `SPLIT_SOURCES`),
all started together, and linked into one shared library with a plain C
interface, at first use, into `_build/` next to this package, and
loaded with ctypes. The library also holds the analytic ADP pass's two
kernels (`csrc/adp_pass.cu`), whose wrappers are in `nn/eam/fast_efs.py`
and counted there (`adp_launch_counts`), not in `launch_counts`.
What a launch needs beyond its tensors (the host tables, the bound C
function and its constant arguments) is built once per descriptor
specification and kept; a call checks its inputs, allocates the output
and passes pointers, sizes and the stream.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .cutoffs import (CUTOFF_IDS, apply_cutoff, cutoff_and_slope,
                      cutoff_slope_and_curvature)

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
SPLIT_SOURCES = {"sf_kernels.cu": ("SF_ENTRY", 4),
                 "sf_vjp.cu": ("SF_VJP_ENTRY", 4),
                 "sf_vjp_bwd.cu": ("SF_VJP_BWD_ENTRY", 4),
                 "grap_vjp.cu": ("GRAP_VJP_ENTRY", 2),
                 "grap_vjp_bwd.cu": ("GRAP_VJP_BWD_ENTRY", 4)}

# Launches of each kernel since the last `reset_launch_counts()`; a
# wrapper adds one where it launches its kernel and nowhere else.
launch_counts: Dict[str, int] = {"g2": 0, "g4": 0, "grap": 0, "g2_vjp": 0,
                                 "g4_vjp": 0, "grap_vjp": 0,
                                 "g2_vjp_bwd": 0, "g4_vjp_bwd": 0,
                                 "grap_vjp_bwd": 0}

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


def _is_vmapped(t: torch.Tensor) -> bool:
    """Whether `t` is batched by a vmap (`is_grads_batched` runs the
    backward under the legacy one): such a tensor has no storage."""
    functorch = torch._C._functorch
    return bool(functorch.is_legacy_batchedtensor(t)
                or functorch.is_batchedtensor(t))


def _refuse_vmapped(function, saved, cotangents) -> bool:
    """Whether a cotangent is batched by a vmap; raise if it is and the
    inputs are not on the CPU."""
    vmapped = any(_is_vmapped(g) for g in cotangents)
    if vmapped and saved[0].device.type != "cpu":
        raise RuntimeError(
            f"{function.__name__}: a cotangent batched by "
            "is_grads_batched cannot be given to the VJP kernel; record "
            "the calls (ops.fused.record_calls) and take the batched VJP "
            "with ops.fused.descriptor_vjp")
    return vmapped


def _backward(function, ctx, gbar):
    """The gradients of `function`'s differentiable inputs along `gbar`
    (module docstring): under grad mode the VJP Function, the VJP kernel
    wrapper otherwise."""
    saved = ctx.saved_tensors
    n = function.n_diff
    vmapped = _refuse_vmapped(function, saved, (gbar,))
    if vmapped:
        # vmap batches the twin's ops on CPU tensors (not the closed
        # form's einsums)
        return _twin_vjp(function.twin, saved[:n], saved[n:], ctx.spec,
                         gbar)
    if torch.is_grad_enabled():
        out = function.vjp_function.apply(gbar, *saved, *ctx.spec)
        return out if isinstance(out, tuple) else (out,)
    return tuple(g[0] for g in function.kernel_vjp(gbar[None], *saved,
                                                   *ctx.spec))


def _engine_uses(t: torch.Tensor) -> bool:
    """Whether the backward being run needs the gradient of `t`: false
    where `t`'s node leads to none of the inputs the caller asked for
    (the loss backward of a train step asks for the parameters, not the
    positions the distances come from). A leaf cannot be asked under
    `autograd.grad`: true."""
    if not t.requires_grad:
        return False
    if t.grad_fn is None:
        return True
    return bool(torch._C._will_engine_execute_node(t.grad_fn))


def _vjp_backward(function, ctx, vs):
    """The gradients of a VJP Function's inputs (gbar, the distances)
    along the cotangents `vs` of its outputs (module docstring): the
    second-order kernel wrapper with grad mode off, the twin's VJP of
    the VJP in the graph under grad mode (third order)."""
    saved = ctx.saved_tensors
    n = 1 + function.first.n_diff
    vmapped = _refuse_vmapped(function, saved[1:], vs)
    if vmapped or torch.is_grad_enabled():
        return _twin_vjp(function.twin, saved[:n], saved[n:], ctx.spec,
                         tuple(vs))
    geometry = any(need and _engine_uses(x) for need, x in
                   zip(ctx.needs_input_grad[1:n], saved[1:n]))
    gbar_bar, *grads = function.kernel_bwd(tuple(vs), *saved, *ctx.spec,
                                           geometry=geometry)
    return (gbar_bar if ctx.needs_input_grad[0] else None, *grads)


def _twin_vjp_of(function):
    """The first-order VJP of `function.twin` by its autograd, as a
    function (gbar, *diff, *rest, *spec) -> the gradients of `diff`,
    differentiable: the twin of `function`'s VJP Function."""
    n = function.n_diff

    def vjp(gbar, *args):
        with torch.enable_grad():
            y = function.twin(*args)
            return torch.autograd.grad(y, args[:n], gbar, create_graph=True)

    return vjp


class Call(NamedTuple):
    """One forward call of a kernel's Function: its inputs as given,
    its constant arguments and its output."""
    function: type
    inputs: tuple
    spec: tuple
    output: torch.Tensor


_tapes: List[List[Call]] = []


@contextlib.contextmanager
def record_calls():
    """Record every kernel Function call made inside the block into the
    list it yields (for `descriptor_vjp`)."""
    tape: List[Call] = []
    _tapes.append(tape)
    try:
        yield tape
    finally:
        _tapes.remove(tape)


def _record(function, inputs, spec, output) -> None:
    for tape in _tapes:
        tape.append(Call(function, inputs, spec, output))


def descriptor_vjp(g: torch.Tensor, g_bar: torch.Tensor, calls, leaves):
    """The VJPs [K, *leaf.shape] of `g` w.r.t. each of `leaves` along the
    K cotangents `g_bar` [K, *g.shape], where `g` was computed from the
    leaves by the kernel Function calls `calls` (recorded with
    `record_calls`) and plain tensor code: from `g` back to the calls'
    outputs and from their inputs back to the leaves by autograd with
    `is_grads_batched`, through each call by its VJP kernel wrapper once
    with B = K. Without calls (a twin or flat-layout descriptor), plain
    autograd throughout."""
    if not calls:
        return torch.autograd.grad(g, leaves, g_bar, is_grads_batched=True)
    outs_bar = torch.autograd.grad(g, [c.output for c in calls], g_bar,
                                   is_grads_batched=True)
    xs, xs_bar = [], []
    for call, y_bar in zip(calls, outs_bar):
        grads = call.function.kernel_vjp(y_bar, *call.inputs, *call.spec)
        for x, x_bar in zip(call.inputs, grads):
            if x.requires_grad:
                xs.append(x)
                xs_bar.append(x_bar)
    return torch.autograd.grad(xs, leaves, xs_bar, is_grads_batched=True)


def _twin_vjp(twin, diff, rest, spec, gbar):
    """VJP of `twin(*diff, *rest, *spec)` w.r.t. `diff` along `gbar` (a
    tuple where the twin has several outputs), for the backward of a
    kernel's autograd Function. Under grad mode (the
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
            g2v = getattr(lib, f"sf_g2_vjp_{dt}")
            g2v.argtypes = [p] * 5 + [i] * 5 + [p, p, d, i, p]
            g2v.restype = i
            g4v = getattr(lib, f"sf_g4_vjp_{dt}")
            g4v.argtypes = [p] * 9 + [i] * 5 + [p, p, p, d, i, p]
            g4v.restype = i
            grapv = getattr(lib, f"grap_vjp_{dt}")
            grapv.argtypes = [p] * 12 + [i] * 6 + [p] * 3 + [i, p, i, p,
                                                              d, i, p]
            grapv.restype = i
            g2b = getattr(lib, f"sf_g2_vjp_bwd_{dt}")
            g2b.argtypes = [p] * 7 + [i] * 4 + [p, p, d, i, p]
            g2b.restype = i
            g4b = getattr(lib, f"sf_g4_vjp_bwd_{dt}")
            g4b.argtypes = [p] * 13 + [i] * 4 + [p, p, p, d, i, p]
            g4b.restype = i
            grapb = getattr(lib, f"grap_vjp_bwd_{dt}")
            grapb.argtypes = [p] * 17 + [i] * 5 + [p] * 3 + [i, p, i, p,
                                                              d, i, p]
            grapb.restype = i
            # csrc/adp_pass.cu, taken by nn/eam/fast_efs.py
            acc = getattr(lib, f"adp_accumulate_{dt}")
            acc.argtypes = [p] * 9 + [i, i, d, i, p]
            acc.restype = i
            frc = getattr(lib, f"adp_forces_{dt}")
            frc.argtypes = [p] * 9 + [i, i, d, i, p]
            frc.restype = i
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


def _check_cotangent(name: str, gbar: torch.Tensor, rows: int, width: int,
                     like: torch.Tensor) -> torch.Tensor:
    """A VJP kernel's cotangent [B, rows, width], contiguous."""
    if gbar.dim() != 3 or tuple(gbar.shape[1:]) != (rows, width):
        raise ValueError(f"{name}: cotangent of shape [B, {rows}, "
                         f"{width}] required, got {tuple(gbar.shape)}")
    if gbar.dtype != like.dtype or gbar.device != like.device:
        raise TypeError(f"{name}: cotangent {gbar.dtype} on "
                        f"{gbar.device}, inputs {like.dtype} on "
                        f"{like.device}")
    if gbar.shape[0] * rows >= 2 ** 31:
        raise ValueError(f"{name}: {gbar.shape[0]} x {rows} rows too many")
    return gbar.contiguous()


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


def launch_on_stream(name: str, fn, device, *args) -> None:
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


def _launch(name: str, fn, device, *args) -> None:
    """`launch_on_stream`, counted in `launch_counts`."""
    launch_on_stream(name, fn, device, *args)
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


def _slot_cotangent(gbar, islotf, mask, n_slots: int):
    """[B, A, S * T] cotangent -> [B, A, N, T]: each entry's slot's row
    times the entry's selection weight [slot = s] mask (zero for a
    masked entry and for a slot outside [0, S))."""
    b, a = gbar.shape[:2]
    eye = torch.arange(n_slots, dtype=islotf.dtype, device=islotf.device)
    sel = (islotf[..., None] == eye) * mask[..., None]     # [A, N, S]
    return torch.einsum("ans,bast->bant", sel,
                        gbar.reshape(b, a, n_slots, -1))


def g2_vjp_reference(gbar, rij, islotf, mask, grid, rcut: float,
                     cutoff: str, n_slots: int):
    """Closed-form VJP of `g2_reference` w.r.t. `rij` along `gbar`
    [B, A, S * T2] -> (d/d rij [B, A, N],): per entry of slot s,
    sum_t gbar[s, t] e_t (fc'(r) - fc(r) 2 eta_t (r - omega_t) / rc^2)
    mask^2, e_t = exp(-eta_t (r - omega_t)^2 / rc^2); exactly 0 where
    the mask is 0."""
    real = mask > 0
    r = torch.where(real, rij, 1.0)
    fc, slope = cutoff_and_slope(cutoff, r, rcut)
    grid = torch.as_tensor(np.asarray(grid), dtype=rij.dtype,
                           device=rij.device)
    eta, omega = grid[:, 0], grid[:, 1]
    d = r[..., None] - omega                               # [A, N, T2]
    e = torch.exp(-eta * torch.square(d) / (rcut * rcut))
    dv = e * (slope[..., None] - fc[..., None] * 2.0 * eta * d
              / (rcut * rcut)) * mask[..., None]
    w = _slot_cotangent(gbar, islotf, mask, n_slots)       # [B, A, N, T2]
    return (torch.where(real, torch.sum(w * dv, dim=-1), 0.0),)


def g2_vjp_kernel(gbar, rij, islotf, mask, grid, rcut: float, cutoff: str,
                  n_slots: int):
    """`g2_vjp_reference` through the CUDA kernel `g2_vjp_kernel`
    (csrc/sf_vjp.cu, the backward of the Pallas `_g2_kernel`,
    tensoralloy_tpu/ops/fused.py:326, which JAX takes by `jax.vjp` of
    `_g2_ref_dense`); the closed form for CPU tensors. One warp per
    atom row, each entry's derivative written to its own place."""
    if rij.device.type == "cpu":
        return g2_vjp_reference(gbar, rij, islotf, mask, grid, rcut,
                                cutoff, n_slots)
    if rij.device.type != "cuda":
        raise ValueError(f"g2_vjp_kernel: no kernel for device "
                         f"{rij.device}")
    _check_cuda_inputs("g2_vjp_kernel", rij, islotf, mask)
    fn, tail, n_params, _ = _bound_sf("g2_vjp", grid, rcut, cutoff, n_slots,
                                      rij.dtype)
    rows, n = rij.shape
    gbar = _check_cotangent("g2_vjp_kernel", gbar, rows,
                            n_slots * n_params, rij)
    batch = gbar.shape[0]
    out = torch.empty((batch, rows, n), dtype=rij.dtype, device=rij.device)
    if rows == 0 or batch == 0:
        return (out,)
    _launch("g2_vjp", fn, rij.device, gbar.data_ptr(), rij.data_ptr(),
            islotf.data_ptr(), mask.data_ptr(), out.data_ptr(), batch, rows,
            n, *tail)
    return (out,)


def g2_vjp_bwd_reference(v, gbar, rij, islotf, mask, grid, rcut: float,
                         cutoff: str, n_slots: int, geometry: bool = True):
    """Closed-form VJP of `g2_vjp_reference` (B = 1) w.r.t. (gbar, rij)
    along `v` = (v [A, N],) -> (gbar_bar [A, S * T2], r_bar [A, N] or
    None where not `geometry`). With g_t = e_t fc,
    e_t = exp(-eta_t (r - omega_t)^2 / rc^2), k_t = 2 eta_t (r - omega_t)
    / rc^2:
      g_t'  = e_t (fc' - fc k_t),
      g_t'' = e_t (fc'' - 2 fc' k_t + fc (k_t^2 - 2 eta_t / rc^2)),
      gbar_bar[s, t] = sum_j [slot_j = s] mask_j^2 g_t'(r_j) v_j,
      r_bar[j] = mask_j^2 v_j sum_t gbar[s_j, t] g_t''(r_j);
    a masked entry gives exactly 0 and its distance is not read."""
    (v,) = v
    a = rij.shape[0]
    real = mask > 0
    r = torch.where(real, rij, 1.0)
    fc, slope, curv = (x[..., None] for x in
                       cutoff_slope_and_curvature(cutoff, r, rcut))
    grid = torch.as_tensor(np.asarray(grid), dtype=rij.dtype,
                           device=rij.device)
    eta, omega = grid[:, 0], grid[:, 1]
    d = r[..., None] - omega                               # [A, N, T2]
    e = torch.exp(-eta * torch.square(d) / (rcut * rcut))
    k = 2.0 * eta * d / (rcut * rcut)
    vm = torch.where(real, v, 0.0) * mask * mask
    eye = torch.arange(n_slots, dtype=islotf.dtype, device=islotf.device)
    sel = (islotf[..., None] == eye) * vm[..., None]       # [A, N, S]
    gbar_bar = torch.einsum("ans,ant->ast", sel, e * (slope - fc * k))
    gbar_bar = gbar_bar.reshape(a, -1)
    if not geometry:
        return gbar_bar, None
    d2g = e * (curv - 2.0 * slope * k
               + fc * (k * k - 2.0 * eta / (rcut * rcut)))
    w = _slot_cotangent(gbar[None], islotf, mask, n_slots)[0]
    return gbar_bar, torch.where(real, torch.sum(w * d2g, dim=-1)
                                 * mask * v, 0.0)


def g2_vjp_bwd_kernel(v, gbar, rij, islotf, mask, grid, rcut: float,
                      cutoff: str, n_slots: int, geometry: bool = True):
    """`g2_vjp_bwd_reference` through the CUDA kernel `g2_vjp_bwd_kernel`
    (csrc/sf_vjp_bwd.cu: the backward of `g2_vjp_kernel`, which JAX takes
    by `jax.grad` through `jax.vjp` of `_g2_ref_dense`,
    tensoralloy_tpu/ops/fused.py:310); the closed form for CPU tensors.
    G2's row walk: a warp a row, each entry's geometry once, its r_bar to
    its own place, gbar_bar summed in registers and reduced by xor
    shuffles; no atomic."""
    if rij.device.type == "cpu":
        return g2_vjp_bwd_reference(v, gbar, rij, islotf, mask, grid, rcut,
                                    cutoff, n_slots, geometry)
    if rij.device.type != "cuda":
        raise ValueError(f"g2_vjp_bwd_kernel: no kernel for device "
                         f"{rij.device}")
    (v,) = v
    _check_cuda_inputs("g2_vjp_bwd_kernel", rij, islotf, mask)
    fn, tail, n_params, _ = _bound_sf("g2_vjp_bwd", grid, rcut, cutoff,
                                      n_slots, rij.dtype)
    rows, n = rij.shape
    gbar = _check_cotangent("g2_vjp_bwd_kernel", gbar[None], rows,
                            n_slots * n_params, rij)
    v = _check_cotangent("g2_vjp_bwd_kernel", v[None], rows, n, rij)
    gbar_bar = torch.empty((rows, n_slots * n_params), dtype=rij.dtype,
                           device=rij.device)
    r_bar = torch.empty_like(rij) if geometry else None
    if rows == 0:
        return gbar_bar, r_bar
    _launch("g2_vjp_bwd", fn, rij.device, v.data_ptr(), gbar.data_ptr(),
            rij.data_ptr(), islotf.data_ptr(), mask.data_ptr(),
            gbar_bar.data_ptr(), 0 if r_bar is None else r_bar.data_ptr(),
            rows, n, *tail)
    return gbar_bar, r_bar


class G2Function(torch.autograd.Function):
    """Differentiable G2 w.r.t. `rij`; no gradient for slots or mask."""

    n_diff = 1
    twin = g2_reference
    kernel_vjp = g2_vjp_kernel
    vjp_function = None      # G2VjpFunction, below

    @staticmethod
    def forward(ctx, rij, islotf, mask, grid, rcut, cutoff, n_slots):
        ctx.save_for_backward(rij, islotf, mask)
        ctx.spec = (grid, rcut, cutoff, n_slots)
        out = g2_kernel(rij, islotf, mask, grid, rcut, cutoff, n_slots)
        _record(G2Function, (rij, islotf, mask), ctx.spec, out)
        return out

    @staticmethod
    def backward(ctx, gbar):
        (grad,) = _backward(G2Function, ctx, gbar)
        return grad, None, None, None, None, None, None


class G2VjpFunction(torch.autograd.Function):
    """G2's VJP (B = 1) as a differentiable op of (gbar, rij): forward
    `G2Function.kernel_vjp`, backward `kernel_bwd` (or the twin's VJP of
    the VJP under grad mode: module docstring)."""

    first = G2Function
    twin = _twin_vjp_of(G2Function)
    kernel_bwd = g2_vjp_bwd_kernel

    @staticmethod
    def forward(ctx, gbar, rij, islotf, mask, grid, rcut, cutoff, n_slots):
        ctx.save_for_backward(gbar, rij, islotf, mask)
        ctx.spec = (grid, rcut, cutoff, n_slots)
        (out,) = G2Function.kernel_vjp(gbar[None], rij, islotf, mask,
                                       *ctx.spec)
        return out[0]

    @staticmethod
    def backward(ctx, v):
        grads = _vjp_backward(G2VjpFunction, ctx, (v,))
        return (*grads, None, None, None, None, None, None)


G2Function.vjp_function = G2VjpFunction


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


def g4_vjp_reference(gbar, rij, rik, rjk, aslotf, mask, grid, acut: float,
                     cutoff: str, n_slots: int):
    """Closed-form VJP of `g4_reference` w.r.t. (rij, rik, rjk) along
    `gbar` [B, A, S * T4] -> three [B, A, Nt]. With a, b, c the three
    distances, per grid row t the term is P_t(cos) E_t(z) fc(a) fc(b)
    fc(c): P_t = 2^(1-zeta) max(1 + gamma cos, 0)^zeta, E_t =
    exp(-beta z), z = (a^2 + b^2 + c^2) / rc^2, and
      d/da = fc3 (C dcos/da + Z 2a / rc^2) + V fc'(a) fc(b) fc(c)
    with C = sum_t w_t P_t' E_t, Z = -sum_t w_t beta_t P_t E_t, V =
    sum_t w_t P_t E_t, w_t the entry's slot's cotangent times mask^2,
    dcos/da = (a^2 - b^2 + c^2) / (2 a^2 b), dcos/db likewise, dcos/dc =
    -c / (a b). The clamp has slope 0 where 1 + gamma cos <= 0.
    Exactly 0 where the mask is 0."""
    real = mask > 0

    def safe(x):
        return torch.where(real, x, 1.0)

    a, b, c = safe(rij), safe(rik), safe(rjk)
    a2, b2, c2 = a * a, b * b, c * c
    z = (a2 + b2 + c2) / (acut * acut)
    cos = (a2 + b2 - c2) / (2.0 * a * b)
    (fa, da), (fb, db), (fcc, dc) = (cutoff_and_slope(cutoff, x, acut)
                                     for x in (a, b, c))
    fc3 = fa * fb * fcc
    p, dp, pe = [], [], []
    for beta, gamma, zeta in np.asarray(grid, dtype=np.float64).tolist():
        arg = 1.0 + gamma * cos
        base = torch.clamp(arg, min=0.0)
        scale = 2.0 ** (1.0 - zeta)
        e = torch.exp(-beta * z)
        p.append(scale * base ** zeta * e)
        dp.append(torch.where(arg > 0, scale * zeta * gamma
                              * base ** (zeta - 1.0), 0.0) * e)
        pe.append(-beta * p[-1])
    w = _slot_cotangent(gbar, aslotf, mask, n_slots) * mask[..., None]
    coef_c, coef_z, coef_v = (torch.sum(w * torch.stack(t, dim=-1), dim=-1)
                              for t in (dp, pe, p))
    two_ab = 2.0 * a * b
    dcos = ((a2 - b2 + c2) / (two_ab * a), (b2 - a2 + c2) / (two_ab * b),
            -c / (a * b))
    slopes = (da * fb * fcc, fa * db * fcc, fa * fb * dc)
    return tuple(
        torch.where(real, fc3 * (coef_c * dc_x + coef_z * 2.0 * x
                                 / (acut * acut)) + coef_v * s_x, 0.0)
        for x, dc_x, s_x in zip((a, b, c), dcos, slopes))


def g4_vjp_kernel(gbar, rij, rik, rjk, aslotf, mask, grid, acut: float,
                  cutoff: str, n_slots: int):
    """`g4_vjp_reference` through the CUDA kernel `g4_vjp_kernel`
    (csrc/sf_vjp.cu, the backward of the Pallas `_g4_kernel`,
    tensoralloy_tpu/ops/fused.py:412); the closed form for CPU
    tensors."""
    if rij.device.type == "cpu":
        return g4_vjp_reference(gbar, rij, rik, rjk, aslotf, mask, grid,
                                acut, cutoff, n_slots)
    if rij.device.type != "cuda":
        raise ValueError(f"g4_vjp_kernel: no kernel for device "
                         f"{rij.device}")
    _check_cuda_inputs("g4_vjp_kernel", rij, rik, rjk, aslotf, mask)
    fn, tail, n_params, _ = _bound_sf("g4_vjp", grid, acut, cutoff, n_slots,
                                      rij.dtype)
    rows, n = rij.shape
    gbar = _check_cotangent("g4_vjp_kernel", gbar, rows,
                            n_slots * n_params, rij)
    batch = gbar.shape[0]
    outs = tuple(torch.empty((batch, rows, n), dtype=rij.dtype,
                             device=rij.device) for _ in range(3))
    if rows == 0 or batch == 0:
        return outs
    _launch("g4_vjp", fn, rij.device, gbar.data_ptr(), rij.data_ptr(),
            rik.data_ptr(), rjk.data_ptr(), aslotf.data_ptr(),
            mask.data_ptr(), *(o.data_ptr() for o in outs), batch, rows, n,
            *tail)
    return outs


def g4_vjp_bwd_reference(v, gbar, rij, rik, rjk, aslotf, mask, grid,
                         acut: float, cutoff: str, n_slots: int,
                         geometry: bool = True):
    """Closed-form VJP of `g4_vjp_reference` (B = 1) w.r.t. (gbar, rij,
    rik, rjk) along `v` = (v_a, v_b, v_c), three [A, Nt] -> (gbar_bar
    [A, S * T4], and the three geometry terms [A, Nt], or None each where
    not `geometry`). Per triple of distances x = (a, b, c) the terms are
    T_t = P_t(cos) E_t(z) F with F = fc(a) fc(b) fc(c), z = |x|^2 / rc^2,
    E_t = exp(-beta_t z), P_t = 2^(1-zeta) max(1 + gamma cos, 0)^zeta
    (P', P'' 0 where 1 + gamma cos <= 0). With w_t = gbar[s, t] mask^2:
      gbar_bar[s, t] = sum_triples [slot = s] mask^2 E_t
          (P_t' F grad(cos).v + P_t (grad(F).v - beta_t F grad(z).v)),
      x_bar = sum_t w_t Hess(T_t) v
            = S2 F gc (gc.v) + S1 (F Hc v + gc (gF.v) + gF (gc.v))
              - B1 F (gc (gz.v) + gz (gc.v)) + B2 F gz (gz.v)
              - B0 (F Hz v + gz (gF.v) + gF (gz.v)) + S0 HF v,
    gc, gz, gF the gradients of cos, z, F in (a, b, c) and Hc, Hz, HF
    their Hessians, S_k = sum_t w_t P_t^(k) E_t (k = 0, 1, 2), B0 =
    sum_t w_t beta_t P_t E_t, B1 = sum_t w_t beta_t P_t' E_t, B2 =
    sum_t w_t beta_t^2 P_t E_t. Exactly 0 where the mask is 0."""
    real = mask > 0

    def safe(x):
        return torch.where(real, x, 1.0)

    a, b, c = safe(rij), safe(rik), safe(rjk)
    a2, b2, c2 = a * a, b * b, c * c
    inv_rc2 = 1.0 / (acut * acut)
    z = (a2 + b2 + c2) * inv_rc2
    cos = (a2 + b2 - c2) / (2.0 * a * b)
    (fa, da, ka), (fb, db, kb), (fcc, dc, kc) = (
        cutoff_slope_and_curvature(cutoff, x, acut) for x in (a, b, c))
    f = fa * fb * fcc
    gf = (da * fb * fcc, fa * db * fcc, fa * fb * dc)
    gc = ((a2 - b2 + c2) / (2.0 * a2 * b), (b2 - a2 + c2) / (2.0 * a * b2),
          -c / (a * b))
    gz = (2.0 * a * inv_rc2, 2.0 * b * inv_rc2, 2.0 * c * inv_rc2)
    vs = [torch.where(real, x, 0.0) for x in v]
    dot = lambda g: g[0] * vs[0] + g[1] * vs[1] + g[2] * vs[2]  # noqa: E731
    gc_v, gz_v, gf_v = dot(gc), dot(gz), dot(gf)
    p, dp, ddp, e, beta = [], [], [], [], []
    for bt, gamma, zeta in np.asarray(grid, dtype=np.float64).tolist():
        arg = 1.0 + gamma * cos
        base = torch.clamp(arg, min=0.0)
        scale = 2.0 ** (1.0 - zeta)
        p.append(scale * base ** zeta)
        dp.append(torch.where(arg > 0, scale * zeta * gamma
                              * base ** (zeta - 1.0), 0.0))
        ddp.append(torch.where(arg > 0, scale * zeta * (zeta - 1.0)
                               * gamma * gamma * base ** (zeta - 2.0), 0.0))
        e.append(torch.exp(-bt * z))
        beta.append(bt)
    p, dp, ddp, e = (torch.stack(t, dim=-1) for t in (p, dp, ddp, e))
    beta = torch.as_tensor(beta, dtype=rij.dtype, device=rij.device)
    mm = mask * mask
    # gbar_bar: each triple's directional derivative of each T_t
    dt = e * (dp * (f * gc_v)[..., None]
              + p * (gf_v[..., None] - beta * (f * gz_v)[..., None]))
    eye = torch.arange(n_slots, dtype=aslotf.dtype, device=aslotf.device)
    sel = (aslotf[..., None] == eye) * (real * mm)[..., None]
    gbar_bar = torch.einsum("ans,ant->ast", sel, dt).reshape(rij.shape[0],
                                                             -1)
    if not geometry:
        return gbar_bar, None, None, None
    w = _slot_cotangent(gbar[None], aslotf, mask, n_slots)[0] \
        * mask[..., None]
    s0, s1, s2 = (torch.sum(w * t * e, dim=-1) for t in (p, dp, ddp))
    sb0, sb1 = (torch.sum(w * beta * t * e, dim=-1) for t in (p, dp))
    sb2 = torch.sum(w * beta * beta * p * e, dim=-1)
    # Hessians of cos and F in (a, b, c), each a symmetric 3 x 3
    hc = {(0, 0): (b2 - c2) / (a2 * a * b),
          (0, 1): -(a2 + b2 + c2) / (2.0 * a2 * b2),
          (0, 2): c / (a2 * b), (1, 1): (a2 - c2) / (a * b2 * b),
          (1, 2): c / (a * b2), (2, 2): -1.0 / (a * b)}
    hf = {(0, 0): ka * fb * fcc, (1, 1): fa * kb * fcc,
          (2, 2): fa * fb * kc, (0, 1): da * db * fcc,
          (0, 2): da * fb * dc, (1, 2): fa * db * dc}

    def hess_v(h, i):
        return sum(h[min(i, j), max(i, j)] * vs[j] for j in range(3))

    out = []
    for i in range(3):
        x_bar = (s2 * f * gc[i] * gc_v
                 + s1 * (f * hess_v(hc, i) + gc[i] * gf_v + gf[i] * gc_v)
                 - sb1 * f * (gc[i] * gz_v + gz[i] * gc_v)
                 + sb2 * f * gz[i] * gz_v
                 - sb0 * (f * 2.0 * inv_rc2 * vs[i] + gz[i] * gf_v
                          + gf[i] * gz_v)
                 + s0 * hess_v(hf, i))
        out.append(torch.where(real, x_bar, 0.0))
    return (gbar_bar, *out)


def g4_vjp_bwd_kernel(v, gbar, rij, rik, rjk, aslotf, mask, grid,
                      acut: float, cutoff: str, n_slots: int,
                      geometry: bool = True):
    """`g4_vjp_bwd_reference` through the CUDA kernel `g4_vjp_bwd_kernel`
    (csrc/sf_vjp_bwd.cu: the backward of `g4_vjp_kernel`, which JAX takes
    by `jax.grad` through `jax.vjp` of `_g4_ref_dense`,
    tensoralloy_tpu/ops/fused.py:397); the closed form for CPU tensors.
    G4's compacted span walk: one lane a real triple, its gradients and
    Hessians of cos, z and F once, six sums over the grid, its geometry
    terms to its own entries, gbar_bar in registers reduced by xor
    shuffles; no atomic."""
    if rij.device.type == "cpu":
        return g4_vjp_bwd_reference(v, gbar, rij, rik, rjk, aslotf, mask,
                                    grid, acut, cutoff, n_slots, geometry)
    if rij.device.type != "cuda":
        raise ValueError(f"g4_vjp_bwd_kernel: no kernel for device "
                         f"{rij.device}")
    _check_cuda_inputs("g4_vjp_bwd_kernel", rij, rik, rjk, aslotf, mask)
    fn, tail, n_params, _ = _bound_sf("g4_vjp_bwd", grid, acut, cutoff,
                                      n_slots, rij.dtype)
    rows, n = rij.shape
    gbar = _check_cotangent("g4_vjp_bwd_kernel", gbar[None], rows,
                            n_slots * n_params, rij)
    v = [_check_cotangent("g4_vjp_bwd_kernel", x[None], rows, n, rij)
         for x in v]
    gbar_bar = torch.empty((rows, n_slots * n_params), dtype=rij.dtype,
                           device=rij.device)
    outs = tuple(torch.empty_like(rij) if geometry else None
                 for _ in range(3))
    if rows == 0:
        return (gbar_bar, *outs)
    _launch("g4_vjp_bwd", fn, rij.device, *(x.data_ptr() for x in v),
            gbar.data_ptr(), rij.data_ptr(), rik.data_ptr(), rjk.data_ptr(),
            aslotf.data_ptr(), mask.data_ptr(), gbar_bar.data_ptr(),
            *(0 if o is None else o.data_ptr() for o in outs), rows, n,
            *tail)
    return (gbar_bar, *outs)


class G4Function(torch.autograd.Function):
    """Differentiable G4 w.r.t. `rij`, `rik`, `rjk`."""

    n_diff = 3
    twin = g4_reference
    kernel_vjp = g4_vjp_kernel
    vjp_function = None      # G4VjpFunction, below

    @staticmethod
    def forward(ctx, rij, rik, rjk, aslotf, mask, grid, acut, cutoff,
                n_slots):
        ctx.save_for_backward(rij, rik, rjk, aslotf, mask)
        ctx.spec = (grid, acut, cutoff, n_slots)
        out = g4_kernel(rij, rik, rjk, aslotf, mask, grid, acut, cutoff,
                        n_slots)
        _record(G4Function, (rij, rik, rjk, aslotf, mask), ctx.spec, out)
        return out

    @staticmethod
    def backward(ctx, gbar):
        grads = _backward(G4Function, ctx, gbar)
        return (*grads, None, None, None, None, None, None)


class G4VjpFunction(torch.autograd.Function):
    """G4's VJP (B = 1) as a differentiable op of (gbar, rij, rik, rjk):
    forward `G4Function.kernel_vjp`, backward `kernel_bwd` (or the twin's
    VJP of the VJP under grad mode: module docstring)."""

    first = G4Function
    twin = _twin_vjp_of(G4Function)
    kernel_bwd = g4_vjp_bwd_kernel

    @staticmethod
    def forward(ctx, gbar, rij, rik, rjk, aslotf, mask, grid, acut, cutoff,
                n_slots):
        ctx.save_for_backward(gbar, rij, rik, rjk, aslotf, mask)
        ctx.spec = (grid, acut, cutoff, n_slots)
        grads = G4Function.kernel_vjp(gbar[None], rij, rik, rjk, aslotf,
                                      mask, *ctx.spec)
        return tuple(g[0] for g in grads)

    @staticmethod
    def backward(ctx, va, vb, vc):
        grads = _vjp_backward(G4VjpFunction, ctx, (va, vb, vc))
        return (*grads, None, None, None, None, None, None)


G4Function.vjp_function = G4VjpFunction


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


def grap_filter_and_slope(desc, r, rcut: float):
    """-> (h [..., K], dh/dr [..., K]): the descriptor's filter bank
    before the cutoff (its own `_filter_values`) and its slope written
    out, for the grid algorithms."""
    h = desc._filter_values(r, rcut)
    cols = {k: torch.as_tensor(desc._grid[:, i], dtype=r.dtype,
                               device=r.device)
            for i, k in enumerate(desc._grid_keys)}
    r = r[..., None]
    if desc.algorithm == "sf":
        return h, -2.0 * cols["eta"] * (r - cols["omega"]) / (rcut * rcut) * h
    if desc.algorithm == "density":
        return h, -cols["beta"] / cols["re"] * h
    if desc.algorithm == "morse":
        x = cols["gamma"] * (r - cols["r0"])
        return h, 2.0 * cols["D"] * cols["gamma"] * (torch.exp(-x)
                                                     - torch.exp(-2.0 * x))
    if desc.algorithm == "pexp":
        x = (r / cols["rl"]) ** cols["pl"]
        return h, -cols["pl"] * x / r * h
    raise ValueError(f"no closed-form slope for algorithm "
                     f"{desc.algorithm!r}")


def grap_filter_slope_and_curvature(desc, r, rcut: float):
    """-> (h, dh/dr, d2h/dr2), each [..., K]: `grap_filter_and_slope`
    and the filters' curvature written out, for the grid algorithms:
      sf       h'' = (k^2 - 2 eta / rc^2) h, k = 2 eta (r - omega) / rc^2
      density  h'' = (beta / re)^2 h
      morse    h'' = 2 D gamma^2 (2 e^(-2x) - e^(-x)), x = gamma (r - r0)
      pexp     h'' = h ((pl x / r)^2 - pl (pl - 1) x / r^2),
               x = (r / rl)^pl."""
    h, dh = grap_filter_and_slope(desc, r, rcut)
    cols = {k: torch.as_tensor(desc._grid[:, i], dtype=r.dtype,
                               device=r.device)
            for i, k in enumerate(desc._grid_keys)}
    r = r[..., None]
    if desc.algorithm == "sf":
        k = 2.0 * cols["eta"] * (r - cols["omega"]) / (rcut * rcut)
        return h, dh, (k * k - 2.0 * cols["eta"] / (rcut * rcut)) * h
    if desc.algorithm == "density":
        return h, dh, torch.square(cols["beta"] / cols["re"]) * h
    if desc.algorithm == "morse":
        x = cols["gamma"] * (r - cols["r0"])
        return h, dh, 2.0 * cols["D"] * cols["gamma"] ** 2 * (
            2.0 * torch.exp(-2.0 * x) - torch.exp(-x))
    x = (r / cols["rl"]) ** cols["pl"]
    return h, dh, h * (torch.square(cols["pl"] * x / r)
                       - cols["pl"] * (cols["pl"] - 1.0) * x / (r * r))


def monomial_slopes(max_moment: int) -> Tuple[np.ndarray, np.ndarray]:
    """-> (index [3, D], count [3, D]): d m_d / d u_axis = count *
    m_index, the monomial with one factor `axis` less (count 0 where the
    monomial has none)."""
    from ..nn.grap import moment_monomials
    monos = moment_monomials(max_moment)
    where = {mono: d for d, mono in enumerate(monos)}
    index = np.zeros((3, len(monos)), np.int64)
    count = np.zeros((3, len(monos)))
    for d, mono in enumerate(monos):
        for ax in set(mono):
            rest = list(mono)
            rest.remove(ax)
            index[ax, d] = where[tuple(rest)]
            count[ax, d] = mono.count(ax)
    return index, count


def grap_vjp_reference(gbar, rij, ux, uy, uz, islotf, mask, desc,
                       rcut: float, n_slots: int):
    """Closed-form VJP of `grap_reference` w.r.t. (rij, ux, uy, uz) along
    `gbar` [B, A, S * K * M] -> four [B, A, N]. P[s, k, d] is recomputed
    as the twin forms it; with the invariants' weights w [D, M],
      Pbar[s, k, d] = P[s, k, d] sum_m c[s, k, m] w[d, m],
      c = 2 gbar for a moment above 0, and for moment 0
      gbar sign(P0) / sqrt(Q0 + 1e-16), Q0 = sum_d w[d, 0] P^2;
    then for an entry of slot s with h_k = filter_k(r) fc(r) mask and
    monomials m_d(u):
      d/dr   = sum_k h_k'(r) sum_d Pbar[s, k, d] m_d
      d/du_x = sum_d (d m_d / d u_x) sum_k Pbar[s, k, d] h_k,
    each times the entry's selection weight; exactly 0 where the mask
    is 0."""
    from ..nn.grap import moment_basis_c, multiplicity_tensor
    bsz, a = gbar.shape[:2]
    n = rij.shape[1]
    real = mask > 0
    r = torch.where(real, rij, 1.0)
    fc, slope = cutoff_and_slope(desc.cutoff_function, r, rcut)
    fc, slope = fc * mask, slope * mask
    f, df = grap_filter_and_slope(desc, r, rcut)
    h = f * fc[..., None]                                  # [A, N, K]
    dh = df * fc[..., None] + f * slope[..., None]
    m = moment_basis_c((ux, uy, uz), desc.max_moment)      # [A, N, D]
    k = desc.n_filters
    eye = torch.arange(n_slots, dtype=islotf.dtype, device=islotf.device)
    sel = (islotf[..., None] == eye) * mask[..., None]     # [A, N, S]
    hs = sel[..., None] * h[..., None, :]                  # [A, N, S, K]
    p = torch.einsum("ansk,and->askd", hs, m)
    t = torch.as_tensor(multiplicity_tensor(desc.max_moment, desc.symmetric),
                        dtype=rij.dtype, device=rij.device)   # [D, mm + 1]
    moments = list(desc.moment_tensors)
    full = gbar.new_zeros((bsz, a, n_slots, k, desc.max_moment + 1))
    full[..., moments] = gbar.reshape(bsz, a, n_slots, k, len(moments))
    coef = 2.0 * full
    if 0 in moments:
        q0 = torch.square(p) @ t[:, 0]                     # [A, S, K]
        c0 = torch.sign(p[..., 0]) / torch.sqrt(q0 + 1e-16)
        coef[..., 0] = full[..., 0] * c0
    pbar = p * (coef @ t.T)                                # [B, A, S, K, D]
    x = torch.einsum("bgskd,gnd->bgnsk", pbar, m)          # [B, A, N, S, K]
    dr = torch.einsum("bgnsk,gnsk->bgn", x, sel[..., None] * dh[..., None, :])
    dm = torch.einsum("gnsk,bgskd->bgnd", hs, pbar)        # [B, A, N, D]
    index, count = monomial_slopes(desc.max_moment)
    count = torch.as_tensor(count, dtype=rij.dtype, device=rij.device)
    index = torch.as_tensor(index, device=rij.device)
    grads = [dr] + [torch.sum(dm * m[..., index[ax]] * count[ax], dim=-1)
                    for ax in range(3)]
    return tuple(torch.where(real, g, 0.0) for g in grads)


def grap_vjp_bwd_reference(v, gbar, rij, ux, uy, uz, islotf, mask, desc,
                           rcut: float, n_slots: int,
                           geometry: bool = True):
    """Closed-form VJP of `grap_vjp_reference` (B = 1) w.r.t. (gbar, rij,
    ux, uy, uz) along `v` = (v_r, a_x, a_y, a_z), four [A, N] ->
    (gbar_bar [A, S * K * M], and r_bar, ux_bar, uy_bar, uz_bar [A, N],
    or None each where not `geometry`). In `grap_vjp_reference`'s
    notation, per (row, slot): H [p, K] the filters times the cutoff and
    the mask of the slot's p pairs, H', H'' their first two derivatives
    in r, M [p, D] the monomials, P = H^T M, Pbar = P o C with C[k, d] =
    sum_m c[k, m] w[d, m]; sigma_j the pair's selection weight, and with
    a_j = (a_x, a_y, a_z) the monomials' derivative along a_j,
    Mdot_j = a_j . grad_u M_j. The VJP is <v, VJP> = sum_kd Pbar Z with
      Z[k, d] = sum_j sigma_j (v_j H'_jk M_jd + H_jk Mdot_jd),
    so, with kappa[k, m] = 2 for a moment above 0 and sign(P0) /
    sqrt(Q0 + 1e-16) for moment 0 (only the requested moments; sign's
    derivative is 0), gbar_bar does not depend on gbar:
      gbar_bar[k, m] = kappa[k, m] sum_d Z[k, d] P[k, d] w[d, m];
    the geometry term through P,
      Pb2[k, d] = Z[k, d] C[k, d] - [moment 0] gbar[k, 0] sign(P0)
                  (Q0 + 1e-16)^(-3/2) (sum_d' Z[k, d'] P[k, d'] w[d', 0])
                  w[d, 0] P[k, d],
    goes back to the pairs as `grap_vjp_reference` sends Pbar back, and
    the direct terms add, per pair (X . Y)_d = sum_k X_jk Y[k, d]:
      r_bar_j = sigma_j [(H' . Pb2 + v_j H'' . Pbar) . M_j
                         + (H' . Pbar) . Mdot_j],
      u_bar_j = sigma_j [(d M_j)^T (H . Pb2 + v_j H' . Pbar)
                         + (d^2 M_j : a_j)^T (H . Pbar)],
    the last the adjoint of the monomial recurrence run on the dual
    numbers (M, Mdot). A masked entry, or one of no slot, gives exactly
    0; its geometry is not read."""
    from ..nn.grap import moment_basis_c, multiplicity_tensor
    a, n = rij.shape
    real = mask > 0
    vr, vx, vy, vz = (torch.where(real, x, 0.0) for x in v)
    r = torch.where(real, rij, 1.0)
    fc, slope, curv = (x * mask for x in cutoff_slope_and_curvature(
        desc.cutoff_function, r, rcut))
    f, df, d2f = grap_filter_slope_and_curvature(desc, r, rcut)
    fc, slope, curv = fc[..., None], slope[..., None], curv[..., None]
    h = f * fc                                             # [A, N, K]
    dh = df * fc + f * slope
    d2h = d2f * fc + 2.0 * df * slope + f * curv
    m = moment_basis_c((ux, uy, uz), desc.max_moment)      # [A, N, D]
    index, count = monomial_slopes(desc.max_moment)
    count = torch.as_tensor(count, dtype=rij.dtype, device=rij.device)
    index = torch.as_tensor(index, device=rij.device)
    dirs = (vx, vy, vz)
    # d m_d / d u_ax and the monomials' derivative along a
    dm = [m[..., index[ax]] * count[ax] for ax in range(3)]
    mdot = sum(dirs[ax][..., None] * dm[ax] for ax in range(3))
    k = desc.n_filters
    eye = torch.arange(n_slots, dtype=islotf.dtype, device=islotf.device)
    sel = (islotf[..., None] == eye) * mask[..., None]     # [A, N, S]

    def to_p(x, y):
        """sum_j sigma_j x_jk y_jd -> [A, S, K, D]."""
        return torch.einsum("ans,ank,and->askd", sel, x, y)

    def to_pairs(x, y):
        """sum_k sigma_j x_jk y[s_j, k, d] -> [A, N, D]."""
        return torch.einsum("ans,ank,askd->and", sel, x, y)

    p = to_p(h, m)
    t = torch.as_tensor(multiplicity_tensor(desc.max_moment, desc.symmetric),
                        dtype=rij.dtype, device=rij.device)   # [D, mm + 1]
    moments = list(desc.moment_tensors)
    full = gbar.new_zeros((a, n_slots, k, desc.max_moment + 1))
    full[..., moments] = gbar.reshape(a, n_slots, k, len(moments))
    kappa = torch.full_like(full, 2.0)
    if 0 in moments:
        q0 = torch.square(p) @ t[:, 0]                     # [A, S, K]
        kappa[..., 0] = torch.sign(p[..., 0]) / torch.sqrt(q0 + 1e-16)
    z = to_p(vr[..., None] * dh, m) + to_p(h, mdot)
    zpw = (z * p) @ t                                      # [A, S, K, mm + 1]
    gbar_bar = (kappa * zpw)[..., moments].reshape(a, -1)
    if not geometry:
        return gbar_bar, None, None, None, None
    c = (kappa * full) @ t.T                               # [A, S, K, D]
    pbar = p * c
    pb2 = z * c
    if 0 in moments:
        pb2 = pb2 - (full[..., 0] * torch.sign(p[..., 0])
                     * (q0 + 1e-16) ** -1.5 * zpw[..., 0])[..., None] \
            * t[:, 0] * p
    e1 = to_pairs(dh, pbar)                                # H' . Pbar
    e2 = to_pairs(vr[..., None] * d2h, pbar) + to_pairs(dh, pb2)
    e3 = to_pairs(h, pbar)                                 # H . Pbar
    e4 = to_pairs(h, pb2) + vr[..., None] * e1
    r_bar = torch.sum(e2 * m + e1 * mdot, dim=-1)
    grads = [r_bar]
    for ax in range(3):
        # d/du_ax of Mdot_d = sum_b a_b count[b, d] m[index[b, d]]
        d2m = sum(dirs[b][..., None] * count[b] * count[ax][index[b]]
                  * m[..., index[ax][index[b]]] for b in range(3))
        grads.append(torch.sum(dm[ax] * e4 + d2m * e3, dim=-1))
    return (gbar_bar, *(torch.where(real, g, 0.0) for g in grads))


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


def _bound_grap(desc, rcut: float, n_slots: int, dtype, device,
                kind: str = "grap") -> tuple:
    """-> (the C entry point of GRAP for `dtype`, the [D, M] weights on
    `device` (a copy from host memory at each call would wait for the
    work already queued on the stream), the constant arguments that
    follow (rows, n), the output columns), bound once per
    (specification, cutoff, rcut, n_slots, dtype, device). The tuple
    holds the host tables so that the pointers stay valid."""
    key = (kind, grap_spec(desc), desc.cutoff_function, rcut, n_slots,
           dtype, device)
    bound = _bound.get(key)
    if bound is None:
        tables = kept_grap_tables(desc)
        algorithm, cols, codes, weights, moments = tables
        fn = getattr(_library(), f"{kind}_{_SUFFIX[dtype]}")
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


def grap_vjp_kernel(gbar, rij, ux, uy, uz, islotf, mask, desc,
                    rcut: float, n_slots: int):
    """`grap_vjp_reference` through the CUDA kernel `grap_vjp_kernel`
    (csrc/grap_vjp.cu, the backward of the Pallas `_grap_kernel`,
    tensoralloy_tpu/ops/fused.py:170); the closed form for CPU tensors.
    A warp per atom row compacts the slot's pairs, recomputes P in
    register tiles as the forward does, forms Pbar in shared memory and
    walks the pairs again, each lane a 4-pair x 8-monomial tile of both
    products over the filters (see the source)."""
    if rij.device.type == "cpu":
        return grap_vjp_reference(gbar, rij, ux, uy, uz, islotf, mask,
                                  desc, rcut, n_slots)
    if rij.device.type != "cuda":
        raise ValueError(f"grap_vjp_kernel: no kernel for device "
                         f"{rij.device}")
    _check_cuda_inputs("grap_vjp_kernel", rij, ux, uy, uz, islotf, mask)
    fn, w, tail, n_out, _ = _bound_grap(desc, rcut, n_slots, rij.dtype,
                                        rij.device, kind="grap_vjp")
    rows, n = rij.shape
    gbar = _check_cotangent("grap_vjp_kernel", gbar, rows, n_out, rij)
    batch = gbar.shape[0]
    outs = tuple(torch.empty((batch, rows, n), dtype=rij.dtype,
                             device=rij.device) for _ in range(4))
    if rows == 0 or batch == 0:
        return outs
    _launch("grap_vjp", fn, rij.device, gbar.data_ptr(), rij.data_ptr(),
            ux.data_ptr(), uy.data_ptr(), uz.data_ptr(), islotf.data_ptr(),
            mask.data_ptr(), w.data_ptr(), *(o.data_ptr() for o in outs),
            batch, rows, n, *tail)
    return outs


def grap_vjp_bwd_kernel(v, gbar, rij, ux, uy, uz, islotf, mask, desc,
                        rcut: float, n_slots: int, geometry: bool = True):
    """`grap_vjp_bwd_reference` through the CUDA kernel
    `grap_vjp_bwd_kernel` (csrc/grap_vjp_bwd.cu: the backward of
    `grap_vjp_kernel`, which JAX takes by `jax.grad` through `jax.vjp` of
    `_grap_ref_dense`, tensoralloy_tpu/ops/fused.py:151); the closed form
    for CPU tensors. A build a mode: `geometry=False` (a train step's
    loss backward) launches the build of pass 1 alone, 8 pairs a batch
    staged with their cotangents, at 3 blocks an SM. A warp a row
    compacts the slot's pairs, recomputes P and accumulates Z in register
    tiles and finishes gbar_bar in registers; with the geometry term it
    forms Pbar and Pb2 and walks the pairs again, one lane a pair running
    the monomials' dual adjoint; no atomic."""
    if rij.device.type == "cpu":
        return grap_vjp_bwd_reference(v, gbar, rij, ux, uy, uz, islotf,
                                      mask, desc, rcut, n_slots, geometry)
    if rij.device.type != "cuda":
        raise ValueError(f"grap_vjp_bwd_kernel: no kernel for device "
                         f"{rij.device}")
    _check_cuda_inputs("grap_vjp_bwd_kernel", rij, ux, uy, uz, islotf, mask)
    fn, w, tail, n_out, _ = _bound_grap(desc, rcut, n_slots, rij.dtype,
                                        rij.device, kind="grap_vjp_bwd")
    rows, n = rij.shape
    gbar = _check_cotangent("grap_vjp_bwd_kernel", gbar[None], rows, n_out,
                            rij)
    v = [_check_cotangent("grap_vjp_bwd_kernel", x[None], rows, n, rij)
         for x in v]
    gbar_bar = torch.empty((rows, n_out), dtype=rij.dtype,
                           device=rij.device)
    outs = tuple(torch.empty_like(rij) if geometry else None
                 for _ in range(4))
    if rows == 0:
        return (gbar_bar, *outs)
    _launch("grap_vjp_bwd", fn, rij.device, *(x.data_ptr() for x in v),
            gbar.data_ptr(), rij.data_ptr(), ux.data_ptr(), uy.data_ptr(),
            uz.data_ptr(), islotf.data_ptr(), mask.data_ptr(), w.data_ptr(),
            gbar_bar.data_ptr(),
            *(0 if o is None else o.data_ptr() for o in outs), rows, n,
            *tail)
    return (gbar_bar, *outs)


class GrapFunction(torch.autograd.Function):
    """Differentiable GRAP w.r.t. `rij`, `ux`, `uy`, `uz` (the JAX op's
    `n_diff=4`); no gradient for slots or mask."""

    n_diff = 4
    twin = grap_reference
    kernel_vjp = grap_vjp_kernel
    vjp_function = None      # GrapVjpFunction, below

    @staticmethod
    def forward(ctx, rij, ux, uy, uz, islotf, mask, desc, rcut, n_slots):
        ctx.save_for_backward(rij, ux, uy, uz, islotf, mask)
        ctx.spec = (desc, rcut, n_slots)
        out = grap_kernel(rij, ux, uy, uz, islotf, mask, desc, rcut,
                          n_slots)
        _record(GrapFunction, (rij, ux, uy, uz, islotf, mask), ctx.spec,
                out)
        return out

    @staticmethod
    def backward(ctx, gbar):
        grads = _backward(GrapFunction, ctx, gbar)
        return (*grads, None, None, None, None, None)


class GrapVjpFunction(torch.autograd.Function):
    """GRAP's VJP (B = 1) as a differentiable op of (gbar, rij, ux, uy,
    uz): forward `GrapFunction.kernel_vjp`, backward `kernel_bwd` (or the
    twin's VJP of the VJP under grad mode: module docstring)."""

    first = GrapFunction
    twin = _twin_vjp_of(GrapFunction)
    kernel_bwd = grap_vjp_bwd_kernel

    @staticmethod
    def forward(ctx, gbar, rij, ux, uy, uz, islotf, mask, desc, rcut,
                n_slots):
        ctx.save_for_backward(gbar, rij, ux, uy, uz, islotf, mask)
        ctx.spec = (desc, rcut, n_slots)
        grads = GrapFunction.kernel_vjp(gbar[None], rij, ux, uy, uz, islotf,
                                        mask, *ctx.spec)
        return tuple(g[0] for g in grads)

    @staticmethod
    def backward(ctx, vr, vx, vy, vz):
        grads = _vjp_backward(GrapVjpFunction, ctx, (vr, vx, vy, vz))
        return (*grads, None, None, None, None, None)


GrapFunction.vjp_function = GrapVjpFunction
