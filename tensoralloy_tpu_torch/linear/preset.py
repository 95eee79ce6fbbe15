"""Named radial filter-bank presets (reference `linear/preset.py:1-98`).

The reference resolves `"func@size"` keys (e.g. ``pexp@medium``,
``morse@large``) into lists of numpy filter closures for its Cython
kernels; here the same named banks resolve into GRAP descriptor
configurations (algorithm + parameter grid + grid mode), so they plug
into `GenericRadialAtomicPotential`, `LinearTensorMD`, and the TOML
``[nn.atomic.grap] preset = "pexp@medium"`` key alike.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

# exact grids of the reference's `filter_presets`
filter_presets: Dict[str, Dict[str, dict]] = {
    "pexp": {
        "small": {"rl": np.linspace(1.0, 4.0, num=8, endpoint=True),
                  "pl": np.linspace(3.0, 1.0, num=8, endpoint=True)},
        "medium": {"rl": np.linspace(1.0, 4.0, num=16, endpoint=True),
                   "pl": np.linspace(3.0, 1.0, num=16, endpoint=True)},
        "large": {"rl": np.linspace(1.0, 4.0, num=32, endpoint=True),
                  "pl": np.linspace(3.0, 1.0, num=32, endpoint=True)},
    },
    "morse": {
        "small": {"D": np.ones(1), "gamma": np.ones(1),
                  "r0": np.linspace(1.4, 3.2, num=10, endpoint=True)},
        "medium": {"D": np.ones(1), "gamma": np.array([1.0, 2.0]),
                   "r0": np.linspace(1.4, 3.2, num=10, endpoint=True)},
        "large": {"D": np.array([0.8, 1.2]), "gamma": np.array([1.0, 2.0]),
                  "r0": np.linspace(1.4, 3.2, num=10, endpoint=True)},
    },
}


def get_filter_preset(key: str) -> dict:
    """Resolve ``"func@size"`` into a GRAP descriptor config:
    {"algorithm", "parameters", "param_space_method"}.

    pexp banks pair rl[i] with pl[i] (aligned lists); morse banks span
    the full D x gamma x r0 grid (the reference iterates
    sklearn.ParameterGrid, which GRAP's 'cross' mode reproduces).
    """
    vals = key.split("@")
    if len(vals) != 2:
        raise KeyError(f"{key!r} is not a valid preset; use 'func@size'")
    func, size = vals
    try:
        params = filter_presets[func][size]
    except KeyError:
        raise KeyError(
            f"unknown preset {key!r}: func in {sorted(filter_presets)}, "
            f"size in {sorted(filter_presets.get(func, filter_presets['pexp']))}")
    if func == "pexp":
        method = "pair"
    else:
        method = "cross"
    return {"algorithm": func,
            "parameters": {k: np.asarray(v, dtype=np.float64).tolist()
                           for k, v in params.items()},
            "param_space_method": method}
