"""What every driver and reader of the benchmark shares: the run's
context and record, the numbers compared with their limits, and the
guard against the JAX package."""
from __future__ import annotations

import dataclasses
import importlib.abc
import sys
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
WORK = HERE / "_work"
# whole top-level module names that no run may load: the JAX stack and
# the JAX package that the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "tensoralloy_tpu")
# the work counts' names of the program's dense lists, by the prefix of
# their feature keys (`pair_mask_d`, `trip_mask_d`)
LISTS = {"pairs": "pair", "triples": "trip"}


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is a forbidden one."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".", 1)[0] in FORBIDDEN:
            raise ImportError(f"the benchmark does not load {name!r}")
        return None


def block_forbidden() -> None:
    """Make every later import of a forbidden module fail, so that an
    optional import of JAX in a library falls back."""
    if not any(isinstance(f, _Refuse) for f in sys.meta_path):
        sys.meta_path.insert(0, _Refuse())


@dataclasses.dataclass
class Context:
    """What a driver is given: the cell's configuration file and traffic
    file as dicts, the seed, the window's length, whether to trace, the
    device, and whether to run the control (the program's own TF32
    path) instead of the configuration as stated."""
    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    control: bool = False


@dataclasses.dataclass
class Check:
    """One number compared, with its limit: the run is correct only
    where value <= limit. `note` says where the number was read (the
    worst leaf of a leaf-by-leaf gap)."""
    name: str
    value: float
    limit: float
    note: str = ""

    @property
    def ok(self) -> bool:
        return self.value <= self.limit     # False for NaN


@dataclasses.dataclass
class Run:
    """A driver's record of one run, which the metric readers read."""
    setup_end: float = 0.0          # host clock when the window opened
    window_s: float = 0.0           # host seconds of the measured window
    attempted: int = 0
    failed: int = 0
    values: dict = dataclasses.field(default_factory=dict)
    checks: list = dataclasses.field(default_factory=list)
    memory_peak_bytes: int = 0
    trace: Optional[object] = None  # a trace.Profiled of the window
    launch_bound_s: dict = dataclasses.field(default_factory=dict)
    useful_flop: float = 0.0        # over the window

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


def load_json(path) -> dict:
    import json
    return json.loads(Path(path).read_text())
