"""Export AtomicNN/TD-GRAP models to the LAMMPS
`pair_style tensoralloy/native` flat-npz schema (port of
`tensoralloy_tpu/io/lammps_native.py`).

Key layout reproduces the reference contract exactly
(`tensoralloy/nn/atomic/atomic.py:304-480`,
`finite_temperature.py` export): global metadata (rmax, nelt, masses,
numbers, precision, max_moment, fctype, actfn, layer_sizes, ...),
descriptor parameters (`descriptor::*` of the analytic filter bank;
the port has no learned filters, so `use_fnn` is 0) and
per-(element, layer) weight/bias arrays `weights_{i}_{j}` /
`biases_{i}_{j}`.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..elements import atomic_masses, atomic_numbers

_FCTYPE = {"cosine": 0, "polynomial": 1}


def _fctype_of(name: str) -> int:
    if name not in _FCTYPE:
        raise ValueError(
            f"cutoff_function {name!r} cannot be exported: the LAMMPS "
            f"native plugin understands only {sorted(_FCTYPE)} "
            f"(training/inference in-framework supports it fine)")
    return _FCTYPE[name]
_ACTFN = {"relu": 0, "softplus": 1, "tanh": 2, "squareplus": 3}
_DESCRIPTOR_METHOD = {"pexp": 0, "morse": 1, "density": 2, "sf": 3}


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def export_to_lammps_native(model, model_path: str, dtype=np.float64
                            ) -> Dict[str, np.ndarray]:
    """Write the native npz for a (TD-)AtomicNN + GRAP model, its weights
    the module's own (the JAX function takes a parameter tree second)."""
    from ..nn.grap import GenericRadialAtomicPotential
    from ..nn.finite_temperature import TemperatureDependentAtomicNN

    params = model.param_tree()
    descriptor = model.descriptor
    if not isinstance(descriptor, GenericRadialAtomicPotential):
        raise ValueError("native export requires a GRAP descriptor")
    if descriptor.algorithm not in _DESCRIPTOR_METHOD:
        raise ValueError(f"unsupported algorithm "
                         f"'{descriptor.algorithm}' for native export")
    if model.activation not in _ACTFN:
        raise ValueError(f"activation '{model.activation}' not "
                         "supported by the native plugin")

    elements = model.elements
    layer_sizes = list(model.hidden_sizes[elements[0]])
    for e in elements[1:]:
        if list(model.hidden_sizes[e]) != layer_sizes:
            raise ValueError("all elements must share layer sizes for "
                             "native export")
    layer_sizes = np.append(np.asarray(layer_sizes, np.int32),
                            1).astype(np.int32)

    chars = []
    for e in elements:
        if len(e) == 1:
            chars.extend([ord(e[0]), 0])
        else:
            chars.extend(ord(c) for c in e)

    is_td = isinstance(model, TemperatureDependentAtomicNN)
    data: Dict[str, np.ndarray] = {
        "rmax": dtype(model.featurizer.rcut),
        "nelt": np.int32(len(elements)),
        "masses": np.asarray(
            [atomic_masses[atomic_numbers[e]] for e in elements], dtype),
        "numbers": np.asarray(chars, np.int32),
        "tdnp": np.int32(1 if is_td else 0),
        "precision": np.int32(64 if dtype == np.float64 else 32),
        "nlayers": np.int32(len(layer_sizes)),
        "max_moment": np.int32(descriptor.max_moment),
        "actfn": np.int32(_ACTFN[model.activation]),
        "fctype": np.int32(_fctype_of(descriptor.cutoff_function)),
        "layer_sizes": layer_sizes,
        "use_resnet_dt": np.int32(model.use_resnet_dt),
        "apply_output_bias": np.int32(bool(model.atomic_static_energy)),
        "is_T_symmetric": np.int32(descriptor.symmetric),
        "use_fnn": np.int32(0),
    }

    method = _DESCRIPTOR_METHOD[descriptor.algorithm]
    data["descriptor::method"] = np.int32(method)
    grid, keys = descriptor._grid, descriptor._grid_keys
    for col, key in enumerate(keys):
        data[f"descriptor::{key}"] = np.asarray(grid[:, col], dtype)

    for i, e in enumerate(elements):
        key = "head_u" if is_td else "mlp"
        layers = params[e][key]["layers"]
        for j, layer in enumerate(layers):
            data[f"weights_{i}_{j}"] = np.squeeze(
                _host(layer["w"]).astype(dtype))
            if "b" in layer:
                data[f"biases_{i}_{j}"] = np.squeeze(
                    _host(layer["b"]).astype(dtype))

    np.savez(model_path, **data)
    return data
