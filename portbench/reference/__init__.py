"""The benchmark's plain reference: torch and numpy only, float32 with
TF32 off, no kernel, no cache and no batching beyond blocks of rows.

It imports nothing of the program under test. It reads the raw inputs
that the harness hands both sides (the saved weights, the structure
database, the seeded lattices and weights) and works out everything else
again: neighbour lists, descriptors, the heads, forces by autograd, the
loss, Adam and the EMA, and the integrator.
"""
import contextlib
import importlib

import torch


def family(config: dict):
    """The reference module of the configuration's descriptor family,
    `portbench/reference/<family>.py`: its `descriptors(vec [rows, width,
    3], mask [rows, width], config) -> G [rows, n_descriptors]` on each
    centre's row of neighbour vectors."""
    return importlib.import_module(f"{__name__}.{config['family']}")


@contextlib.contextmanager
def full_precision():
    """Run the block with TF32 off for matmuls and cuDNN, then restore
    the settings that were in force."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before
