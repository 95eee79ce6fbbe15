"""Frozen counts of the work that the benchmark's cells ask for: bytes
and useful floating-point operations of the descriptor kernels, the
MLP's products, and the published peaks of the card. They describe the
work from its sizes, whatever implements it, and read nothing of the
program."""

import importlib


def family(config: dict):
    """The counts of the configuration's descriptor family,
    `portbench/work/<family>.py`: its `launches(config, lists, kind)`."""
    return importlib.import_module(f"{__name__}.{config['family']}")
