"""Saved-model files (port of `tensoralloy_tpu/io/model.py`).

A saved model is one ``.npz``: the flat parameter arrays under keys
``p/<path>`` (``p/Ni/mlp/layers/0/w``, ``p/zjw04xc/Ni/A``,
``p/nn/Ni.rho/layers/0/w``) plus ``__config__``, a JSON string with the
model class, featurizer, descriptor (or analytic potentials) and
max_occurs. The port reads and writes the same files as the JAX
package. Loading needs no init template: the flat keys are the
parameter tree (`utils.tree_unflatten`), which the model takes with
`load_param_tree`.
"""
from __future__ import annotations

import json
import time
from collections import Counter
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..precision import resolve_device, resolve_dtype
from ..utils import tree_flatten, tree_unflatten

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
    tree = model.param_tree() if params is None else params
    flat = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))
            for k, v in tree_flatten(tree, _PREFIX[:-1]).items()}
    anchor = next(iter(flat.values()), None)
    if anchor is None:          # a model without parameters
        anchor = model._anchor.detach().cpu().numpy()
    config = {
        "model": model.as_dict(),
        "api_version": API_VERSION,
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
        "framework": "tensoralloy_tpu_torch",
        "precision": str(anchor.dtype),
    }
    if extra_metadata:
        config.update(extra_metadata)
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
        if "descriptor" not in model_cfg:
            raise ValueError(f"backend={backend!r}: a {model_cfg['class']} "
                             "has no descriptor")
        model_cfg["descriptor"] = dict(model_cfg["descriptor"],
                                       backend=backend)
    model = model_from_dict(model_cfg, device=device,
                            dtype=resolve_dtype(dtype))
    model.load_param_tree(tree_unflatten(flat, _PREFIX[:-1]))
    return model, config


EAM_CLASSES = ("EamAlloyNN", "EamFsNN", "AdpNN")


def model_from_dict(d: dict, *, device=None, dtype=None):
    """Model factory: AtomicNN and the finite-temperature
    TemperatureDependentAtomicNN and BeNN, with SymmetryFunction or GRAP
    descriptors, and the EAM family (EamAlloyNN, EamFsNN, AdpNN)."""
    from ..transform.featurizer import Featurizer
    cls = d["class"]
    if cls in EAM_CLASSES:
        from ..nn.eam.models import model_from_dict as eam_from_dict
        return eam_from_dict(d, device=device, dtype=dtype)
    if cls not in ("AtomicNN", "TemperatureDependentAtomicNN", "BeNN"):
        raise ValueError(f"unknown model class {cls!r}")
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
