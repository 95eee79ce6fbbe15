"""tensoralloy_tpu_torch — the PyTorch/CUDA port of `tensoralloy_tpu`.

The serving path: a saved `.npz` model is loaded into
`calculator.TensorAlloyCalculator`, structures are featurized on the
host (numpy and C++) or on the device (`transform/device_nl.py`), and
energy, forces, stress and the Hessian come back from PyTorch on the CPU
or an NVIDIA GPU; `dynamics.py` runs MD on the same models. Training
and experiments: `train/`. The command lines: `cli/` and `tensordb/`.
The G2, G4 and GRAP descriptors run in hand-written CUDA kernels on the
GPU (`ops/fused.py`, `csrc/`).

This package imports torch and never jax. Importing the package itself
imports no torch, so that the host-only parts (`tensordb`, the file
readers) start without it; `precision`, which every module that computes
in torch imports, keeps TF32 off.
"""

__version__ = "0.1.0"

from .atoms import Structure            # noqa: F401


def __getattr__(name):
    if name in ("resolve_dtype", "set_tf32"):
        from . import precision
        return getattr(precision, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
