"""Behler G2/G4 descriptors through hand-written CUDA kernels (port of
the G2/G4 half of `tensoralloy_tpu/ops/fused.py`).

Each descriptor has three pieces:
  * a plain PyTorch twin (`g2_reference`, `g4_reference`), the port of
    `_g2_ref_dense` / `_g4_ref_dense`: dense [A, N, T] math, any device;
  * a kernel wrapper (`g2_kernel`, `g4_kernel`): on a CPU tensor it
    returns the twin; on a CUDA tensor it launches the kernel from
    `csrc/sf_kernels.cu` or raises — there is no fallback;
  * an autograd Function (`G2Function`, `G4Function`), the port of
    `_custom_vjp_op`: forward is the kernel wrapper, backward
    recomputes the twin from the saved inputs and returns its VJP.
    First-order only: the backward is not itself differentiable.

The CUDA source is compiled with nvcc for sm_90a into a shared library
with a plain C interface, at first use, into `_build/` next to this
package, and loaded with ctypes.
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
KERNEL_SOURCE = _PACKAGE_DIR / "csrc" / "sf_kernels.cu"
BUILD_DIR = _PACKAGE_DIR / "_build"
MAX_PARAMS = 64          # kMaxParams in csrc/sf_kernels.cu
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launches of each kernel since the last `reset_launch_counts()`; a
# wrapper adds one where it launches its kernel and nowhere else.
launch_counts: Dict[str, int] = {"g2": 0, "g4": 0}

_lib: Optional[ctypes.CDLL] = None
build_log = ""


def reset_launch_counts() -> None:
    for key in launch_counts:
        launch_counts[key] = 0


# ----------------------------------------------------------------------
# Build and bind
# ----------------------------------------------------------------------

def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for path in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME): the G2/G4 CUDA "
                       "kernels are built from source at first use")


def build_kernels() -> Path:
    """Compile `csrc/sf_kernels.cu` (skipped when a library built from
    the same source exists) and return the library's path. The
    compiler's output, with ptxas' register and spill report, is kept
    in `build_log`."""
    global build_log
    digest = hashlib.sha1(KERNEL_SOURCE.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libsf_kernels_{digest}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(KERNEL_SOURCE)],
            capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{build_log}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
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
        _lib = lib
    return _lib


def _check_cuda_inputs(name: str, *tensors: torch.Tensor) -> None:
    ref = tensors[0]
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64 inputs required, "
                        f"got {ref.dtype}")
    if ref.dim() != 2:
        raise ValueError(f"{name}: [rows, n] inputs required, got shape "
                         f"{tuple(ref.shape)}")
    for t in tensors:
        if t.device != ref.device:
            raise ValueError(f"{name}: inputs on {t.device} and "
                             f"{ref.device}")
        if t.dtype != ref.dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and "
                            f"{ref.dtype}")
        if t.shape != ref.shape:
            raise ValueError(f"{name}: shapes {tuple(t.shape)} and "
                             f"{tuple(ref.shape)} differ")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if ref.shape[0] >= 2 ** 31 or ref.shape[1] >= 2 ** 31:
        raise ValueError(f"{name}: shape {tuple(ref.shape)} too large")


def _check_launch(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {code}")


def _grid_columns(grid: np.ndarray) -> Tuple[np.ndarray, ...]:
    if len(grid) > MAX_PARAMS:
        raise ValueError(f"at most {MAX_PARAMS} parameter rows, got "
                         f"{len(grid)}")
    return tuple(np.ascontiguousarray(grid[:, c], dtype=np.float64)
                 for c in range(grid.shape[1]))


def _ptr(a) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.data_ptr() if isinstance(a, torch.Tensor)
                           else a.ctypes.data)


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
    tensors. On the H100 it is bound by reading the three [A, N] inputs
    plus one cutoff and T2 exp per pair; no matmul (see the source)."""
    if rij.device.type == "cpu":
        return g2_reference(rij, islotf, mask, grid, rcut, cutoff, n_slots)
    if rij.device.type != "cuda":
        raise ValueError(f"g2_kernel: no kernel for device {rij.device}")
    _check_cuda_inputs("g2_kernel", rij, islotf, mask)
    eta, omega = _grid_columns(np.asarray(grid))
    rows, n = rij.shape
    out = torch.empty((rows, n_slots * len(eta)), dtype=rij.dtype,
                      device=rij.device)
    if rows == 0:
        return out
    lib = _library()
    fn = lib.sf_g2_f32 if rij.dtype == torch.float32 else lib.sf_g2_f64
    with torch.cuda.device(rij.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(_ptr(rij), _ptr(islotf), _ptr(mask), _ptr(out), rows, n,
                  n_slots, len(eta), _ptr(eta), _ptr(omega), float(rcut),
                  CUTOFF_IDS[cutoff], ctypes.c_void_p(stream))
    _check_launch("g2", code)
    launch_counts["g2"] += 1
    return out


class G2Function(torch.autograd.Function):
    """Differentiable G2 w.r.t. `rij`; no gradient for slots or mask."""

    @staticmethod
    def forward(ctx, rij, islotf, mask, grid, rcut, cutoff, n_slots):
        ctx.save_for_backward(rij, islotf, mask)
        ctx.spec = (grid, rcut, cutoff, n_slots)
        return g2_kernel(rij, islotf, mask, grid, rcut, cutoff, n_slots)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gbar):
        rij, islotf, mask = ctx.saved_tensors
        with torch.enable_grad():
            r = rij.detach().requires_grad_()
            y = g2_reference(r, islotf, mask, *ctx.spec)
            (grad,) = torch.autograd.grad(y, r, gbar)
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
    beta, gamma, zeta = _grid_columns(np.asarray(grid))
    rows, n = rij.shape
    out = torch.empty((rows, n_slots * len(beta)), dtype=rij.dtype,
                      device=rij.device)
    if rows == 0:
        return out
    lib = _library()
    fn = lib.sf_g4_f32 if rij.dtype == torch.float32 else lib.sf_g4_f64
    with torch.cuda.device(rij.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(_ptr(rij), _ptr(rik), _ptr(rjk), _ptr(aslotf), _ptr(mask),
                  _ptr(out), rows, n, n_slots, len(beta), _ptr(beta),
                  _ptr(gamma), _ptr(zeta), float(acut), CUTOFF_IDS[cutoff],
                  ctypes.c_void_p(stream))
    _check_launch("g4", code)
    launch_counts["g4"] += 1
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
    @torch.autograd.function.once_differentiable
    def backward(ctx, gbar):
        rij, rik, rjk, aslotf, mask = ctx.saved_tensors
        with torch.enable_grad():
            dists = [x.detach().requires_grad_() for x in (rij, rik, rjk)]
            y = g4_reference(*dists, aslotf, mask, *ctx.spec)
            grads = torch.autograd.grad(y, dists, gbar)
        return (*grads, None, None, None, None, None, None)
