"""Float-precision policy (port of `tensoralloy_tpu/precision.py`) and
the entry points' device default.

Two named precisions:
  * ``high``   -> float64 (parity and physics checks)
  * ``medium`` -> float32 (serving on the GPU)

The JAX package keeps the policy in a global and reads
``jax_enable_x64``; here every entry point takes a ``dtype`` argument
instead, and `resolve_dtype` turns a policy name into a torch dtype.

The entry points (`TensorAlloyCalculator`, `io.model.load_model`) run on
the card unless the caller asks for the CPU: `resolve_device` turns
their `device` argument into a torch device and refuses "cuda" where
there is no card, rather than carrying on on the CPU.

TF32 keeps about three decimal digits. Reduced-precision matmuls were
found to distort evaluations of models trained at full precision, so
the port keeps TF32 off for both matmuls and cuDNN unless a caller
turns it on with `set_tf32(True)`.
"""
from __future__ import annotations

from typing import Union

import torch

POLICIES = {"high": torch.float64, "medium": torch.float32}


def resolve_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """'high' | 'medium' | torch.float64 | torch.float32 -> torch dtype."""
    if isinstance(dtype, str):
        if dtype not in POLICIES:
            raise ValueError(f"precision must be one of {list(POLICIES)}")
        return POLICIES[dtype]
    if dtype not in POLICIES.values():
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    return dtype


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """An entry point's `device` argument -> torch device. A CUDA device
    where torch finds no card raises: the caller asks for the CPU by
    name (`device="cpu"`)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is "
            "false); pass device=\"cpu\" to run on the CPU")
    return device


def set_tf32(enabled: bool) -> None:
    """Switch TF32 for float32 matmuls and cuDNN convolutions together."""
    torch.backends.cuda.matmul.allow_tf32 = bool(enabled)
    torch.backends.cudnn.allow_tf32 = bool(enabled)


# TF32 stays off unless a caller asks for it (see the module docstring)
set_tf32(False)
