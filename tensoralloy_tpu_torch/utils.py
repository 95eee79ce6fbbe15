"""Foundational helpers: k-body term algebra, integer pairing.

Parity targets: reference `tensoralloy/utils.py:69-290` (pairing functions,
`get_kbody_terms`, `get_elements_from_kbody_term`) — re-implemented here
with the same ordering semantics so descriptor feature layouts match.
"""
from __future__ import annotations

import re
from itertools import chain
from typing import Dict, List, Tuple

import numpy as np


class ModeKeys:
    TRAIN = "train"
    EVAL = "eval"
    PREDICT = "infer"

    @staticmethod
    def for_prediction(mode: str) -> bool:
        return mode == ModeKeys.PREDICT


class Defaults:
    """Default hyperparameters (reference `utils.py:393-420`)."""
    rc = 6.5
    seed = 611
    variable_moving_average_decay = 0.999
    activation = "softplus"
    hidden_sizes = [64, 32]
    learning_rate = 0.01


# ----------------------------------------------------------------------
# Integer pairing (triple/pair dedup during angular metadata build).
# ----------------------------------------------------------------------

def cantor_pairing(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Cantor pairing function z = (x+y)(x+y+1)/2 + y (N x N -> N)."""
    x = np.asarray(x, dtype=np.int64)
    y = np.asarray(y, dtype=np.int64)
    return (x + y) * (x + y + 1) // 2 + y


def szudzik_pairing(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Szudzik's elegant pairing of two (possibly negative) integers."""
    x = np.asarray(x, dtype=np.int64)
    y = np.asarray(y, dtype=np.int64)
    # Fold Z -> N
    a = np.where(x >= 0, 2 * x, -2 * x - 1)
    b = np.where(y >= 0, 2 * y, -2 * y - 1)
    return np.where(a >= b, a * a + a + b, b * b + a)


def szudzik_pairing_nd(*cols) -> np.ndarray:
    """Fold N integer columns into one unique id by chained Szudzik pairing."""
    out = np.asarray(cols[0], dtype=np.int64)
    for c in cols[1:]:
        out = szudzik_pairing(out, c)
    return out


# ----------------------------------------------------------------------
# K-body terms
# ----------------------------------------------------------------------

def get_elements_from_kbody_term(kbody_term: str) -> List[str]:
    """Split 'NiMo' -> ['Ni','Mo'], 'NiNiMo' -> ['Ni','Ni','Mo']."""
    return re.findall(r"[A-Z][a-z]*", kbody_term)


def get_kbody_terms(elements: List[str], angular: bool = False,
                    symmetric: bool = True
                    ) -> Tuple[List[str], Dict[str, List[str]], List[str]]:
    """Ordered k-body interaction classes.

    Matches the ordering contract of the reference (`utils.py:237-290`):
    elements sorted; for each center element e, radial terms are
    [ee, e<other1>, e<other2>, ...] (self first, others in sorted order);
    angular terms append e + sorted(jk) combinations (j<=k if symmetric).
    """
    elements = sorted(set(elements))
    n = len(elements)
    per_element: Dict[str, List[str]] = {e: [e + e] for e in elements}
    for i, e in enumerate(elements):
        for j, o in enumerate(elements):
            if i != j:
                per_element[e].append(e + o)
    if angular:
        for e in elements:
            for j in range(n):
                if symmetric:
                    for k in range(j, n):
                        suffix = "".join(sorted([elements[j], elements[k]]))
                        per_element[e].append(e + suffix)
                else:
                    for k in range(n):
                        per_element[e].append(e + elements[j] + elements[k])
    all_terms = list(chain(*[per_element[e] for e in elements]))
    return all_terms, per_element, elements


def nested_get(d: dict, keypath: str, default=None):
    """`nested_get(cfg, 'nn.atomic.sf.eta')` dotted access."""
    obj = d
    for key in keypath.split("."):
        if not isinstance(obj, dict) or key not in obj:
            return default
        obj = obj[key]
    return obj


def nested_set(d: dict, keypath: str, value):
    keys = keypath.split(".")
    obj = d
    for key in keys[:-1]:
        obj = obj.setdefault(key, {})
    obj[keys[-1]] = value


# ----------------------------------------------------------------------
# Parameter trees: nested mappings and sequences of tensors, shaped like
# the JAX package's parameter pytrees. A tree's flat form maps
# 'Ni/mlp/layers/0/w' to its leaf; mappings are walked in sorted key
# order, sequences in place (the order of `jax.tree_util`).
# ----------------------------------------------------------------------

def _children(node):
    """[(key, child)] of a mapping (dict, ModuleDict, ParameterDict) or a
    sequence (list, tuple, ModuleList); None for a leaf (an array or
    tensor: anything with a shape, or a scalar)."""
    if hasattr(node, "keys"):
        return [(str(k), node[k]) for k in sorted(node.keys(), key=str)]
    if hasattr(node, "__getitem__") and hasattr(node, "__len__") \
            and not hasattr(node, "shape"):
        return [(str(i), node[i]) for i in range(len(node))]
    return None


def tree_flatten(tree, prefix: str = "") -> Dict[str, object]:
    """Nested mapping/sequence -> {'a/b/0/w': leaf}; `prefix` is put
    before every key ('params' -> 'params/a/b/0/w')."""
    out: Dict[str, object] = {}

    def visit(node, path):
        kids = _children(node)
        if kids is None:
            out["/".join(path)] = node
            return
        for key, child in kids:
            visit(child, path + [key])

    visit(tree, [prefix] if prefix else [])
    return out


def tree_unflatten(flat: Dict[str, object], prefix: str = ""):
    """{'a/b/0/w': leaf} -> nested dicts, with lists where every key of a
    level is an index. Only the keys under `prefix` are read."""
    root: dict = {}
    lead = prefix + "/" if prefix else ""
    for key, value in flat.items():
        if not key.startswith(lead):
            continue
        parts = key[len(lead):].split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def tree_map(fn, tree, *rest):
    """Apply `fn(leaf, *leaves_of_rest)` leaf by leaf -> a tree of plain
    dicts and lists with the structure of `tree`."""
    flats = [tree_flatten(t) for t in (tree, *rest)]
    return tree_unflatten({k: fn(*(f[k] for f in flats))
                           for k in flats[0]})
