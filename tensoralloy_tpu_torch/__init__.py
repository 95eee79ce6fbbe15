"""tensoralloy_tpu_torch — the PyTorch/CUDA port of `tensoralloy_tpu`.

The serving path: a saved `.npz` model is loaded into
`calculator.TensorAlloyCalculator`, structures are featurized on the
host (numpy and C++) or on the device (`transform/device_nl.py`), and
energy, forces, stress and the Hessian come back from PyTorch on the CPU
or an NVIDIA GPU; `dynamics.py` runs MD on the same models. Training
and experiments: `train/`. The G2, G4 and GRAP descriptors run in
hand-written CUDA kernels on the GPU (`ops/fused.py`, `csrc/`).

This package imports torch and never jax.
"""

__version__ = "0.1.0"

from .atoms import Structure            # noqa: F401
from .precision import resolve_dtype, set_tf32  # noqa: F401

# TF32 stays off unless a caller asks for it (see precision.py).
set_tf32(False)
