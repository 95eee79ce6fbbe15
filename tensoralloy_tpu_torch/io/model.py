"""Saved-model files (port of `tensoralloy_tpu/io/model.py`).

A saved model is one ``.npz``: the flat parameter arrays under keys
``p/<path>`` (``p/Ni/mlp/layers/0/w``) plus ``__config__``, a JSON
string with the model class, featurizer, descriptor and max_occurs.
The port reads and writes the same files as the JAX package. Loading
needs no init template: a flat key maps straight onto a state-dict key
(``params.Ni.mlp.layers.0.w``).
"""
from __future__ import annotations

import json
import time
from collections import Counter
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..precision import resolve_device, resolve_dtype

API_VERSION = "1.1"
_PREFIX = "p/"
_STATE_PREFIX = "params."


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX parameter pytree (nested dicts/lists of arrays or tensors) ->
    the port's state dict, e.g. tree["Ni"]["mlp"]["layers"][0]["w"] ->
    "params.Ni.mlp.layers.0.w". Arrays keep their dtype;
    `load_state_dict` casts them to the model's."""
    out = {}

    def visit(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(v, path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                visit(v, path + [str(i)])
        elif isinstance(node, torch.Tensor):
            out[_STATE_PREFIX + ".".join(path)] = node.detach()
        else:
            out[_STATE_PREFIX + ".".join(path)] = torch.from_numpy(
                np.array(node))

    visit(tree, [])
    return out


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """The port's state dict -> the JAX parameter pytree of numpy arrays
    (integer path components become list indices)."""
    root: dict = {}
    for key, value in state_dict.items():
        if not key.startswith(_STATE_PREFIX):
            continue
        parts = key[len(_STATE_PREFIX):].split(".")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value.detach().cpu().numpy()

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def save_model(path: str, model, params=None,
               extra_metadata: Optional[dict] = None):
    """Serialize a model and its weights to one `.npz` that the port's
    and the JAX package's calculators both load. `params` is a parameter
    tree to write in place of the module's own weights (the trainer's
    EMA parameters, as the JAX `save_model(path, model, params)`)."""
    state = (model.state_dict() if params is None
             else params_from_jax(params))
    first = next(iter(state.values()))
    config = {
        "model": model.as_dict(),
        "api_version": API_VERSION,
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
        "framework": "tensoralloy_tpu_torch",
        "precision": str(first.detach().cpu().numpy().dtype),
    }
    if extra_metadata:
        config.update(extra_metadata)
    flat = {_PREFIX + k[len(_STATE_PREFIX):].replace(".", "/"):
            v.detach().cpu().numpy() for k, v in state.items()}
    flat["__config__"] = np.frombuffer(
        json.dumps(config).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def load_model(path: str, *, device="cuda", dtype="high",
               backend: Optional[str] = None) -> Tuple[object, dict]:
    """-> (model, config). The model is built from its config on `device`
    (the card unless the caller passes "cpu"; "cuda" without a card
    raises) in `dtype` ('high' | 'medium' | a torch float dtype) and the
    saved weights are cast into it. `backend` overrides the descriptor
    backend named in the file ('dense' = plain PyTorch, 'pallas' = the
    CUDA kernels)."""
    device = resolve_device(device)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    config = json.loads(bytes(flat.pop("__config__")).decode())
    model_cfg = dict(config["model"])
    if backend is not None:
        model_cfg["descriptor"] = dict(model_cfg["descriptor"],
                                       backend=backend)
    model = model_from_dict(model_cfg, device=device,
                            dtype=resolve_dtype(dtype))
    state = {_STATE_PREFIX + k[len(_PREFIX):].replace("/", "."):
             torch.from_numpy(v) for k, v in flat.items()}
    model.load_state_dict(state)
    return model, config


def model_from_dict(d: dict, *, device=None, dtype=None):
    """Model factory: AtomicNN and the finite-temperature
    TemperatureDependentAtomicNN and BeNN, with SymmetryFunction or GRAP
    descriptors."""
    from ..transform.featurizer import Featurizer
    cls = d["class"]
    if cls not in ("AtomicNN", "TemperatureDependentAtomicNN", "BeNN"):
        raise NotImplementedError(
            f"model class {cls!r} is not ported yet (the serving slices "
            f"carry AtomicNN and the finite-temperature models; the "
            f"EAM/ADP family comes with slice 3)")
    kwargs = dict(
        hidden_sizes=d.get("hidden_sizes"),
        activation=d.get("activation", "softplus"),
        use_resnet_dt=d.get("use_resnet_dt", True),
        minmax_scale=d.get("minmax_scale", True),
        atomic_static_energy=d.get("atomic_static_energy"),
        fixed_static_energy=d.get("fixed_static_energy", False),
        device=device, dtype=dtype)
    args = (Featurizer.from_dict(d["featurizer"]), Counter(d["max_occurs"]),
            descriptor_from_dict(d["descriptor"]))
    if cls == "AtomicNN":
        from ..nn.atomic import AtomicNN
        return AtomicNN(*args, **kwargs)
    from ..nn.finite_temperature import TemperatureDependentAtomicNN
    from ..nn.special import BeNN
    td_cls = BeNN if cls == "BeNN" else TemperatureDependentAtomicNN
    return td_cls(*args, layers=d.get("layers", [128, 128]),
                  eentropy_algo=d.get("eentropy_algo", "default"),
                  ft_activation=d.get("ft_activation", "softplus"),
                  **kwargs)


def descriptor_from_dict(d: dict):
    cls = d["class"]
    if cls == "SymmetryFunction":
        from ..nn.sf import SymmetryFunction
        return SymmetryFunction(
            d["elements"], eta=d["eta"], omega=d["omega"], beta=d["beta"],
            gamma=d["gamma"], zeta=d["zeta"],
            cutoff_function=d.get("cutoff_function", "cosine"),
            backend=d.get("backend", "segment"))
    if cls == "GenericRadialAtomicPotential":
        from ..nn.grap import GenericRadialAtomicPotential
        return GenericRadialAtomicPotential.from_dict(d)
    raise ValueError(f"unknown descriptor class {cls}")
