"""Linear models on the descriptor basis: the filter presets and the
least-squares-fitted linear TensorMD."""
from .model import LinearTensorMD, TensorMDPythonCalculator  # noqa: F401
