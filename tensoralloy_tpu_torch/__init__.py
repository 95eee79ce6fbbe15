"""tensoralloy_tpu_torch — the PyTorch/CUDA port of `tensoralloy_tpu`.

The serving path: a saved `.npz` model is loaded into
`calculator.TensorAlloyCalculator`, structures are featurized on the
host (numpy), and energy, forces and stress come back from PyTorch on
the CPU or an NVIDIA GPU. Behler G2/G4 descriptors run in hand-written
CUDA kernels on the GPU (`ops/fused.py`, `csrc/sf_kernels.cu`).

This package imports torch and never jax.
"""

__version__ = "0.1.0"

from .atoms import Structure            # noqa: F401
from .precision import resolve_dtype, set_tf32  # noqa: F401

# TF32 stays off unless a caller asks for it (see precision.py).
set_tf32(False)
