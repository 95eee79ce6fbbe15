"""Pair and triple geometry from the flat ('segment') feature arrays
(port of `tensoralloy_tpu/ops/pairs.py`).

Every function takes one structure's features or a batch's: pair and
triple arrays [n] or [B, n] with positions [A, 3] or [B, A, 3]; a
batch's indices address their own structure's rows.

`reduce_rows` is the one hook of the spatially sharded evaluation
(`parallel.spatial`): every per-atom sum over the pair or triple axis
passes through it before any nonlinear stage. It is the identity unless
a `row_reduction` context names a reduction (the sum of the ranks'
partial sums there).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional

import torch

_ROW_REDUCE: contextvars.ContextVar[Optional[Callable]] = \
    contextvars.ContextVar("row_reduce", default=None)


def reduce_rows(partial: torch.Tensor) -> torch.Tensor:
    """A per-atom sum over this process's pairs -> the sum over every
    pair of the structure: `partial` itself outside a `row_reduction`."""
    reduce = _ROW_REDUCE.get()
    return partial if reduce is None else reduce(partial)


@contextlib.contextmanager
def row_reduction(reduce: Callable[[torch.Tensor], torch.Tensor]):
    """Evaluate a model with `reduce` applied at every `reduce_rows`."""
    token = _ROW_REDUCE.set(reduce)
    try:
        yield
    finally:
        _ROW_REDUCE.reset(token)


def safe_norm(vec: torch.Tensor, eps: float = 1e-14, dim: int = -1):
    """Norm with a smooth, NaN-free gradient at zero."""
    return torch.sqrt(torch.sum(torch.square(vec), dim=dim) + eps)


def _batch_rows(pos: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows `idx` of `pos`: [n] of [A, 3], or a batch's [B, n] of
    [B, A, 3], each structure's indices addressing its own rows."""
    if pos.dim() == 2:
        return pos[idx]
    b, a, _ = pos.shape
    offset = torch.arange(0, b * a, a, device=pos.device).view(b, 1)
    return pos.reshape(b * a, 3)[idx + offset]


def _shift_vectors(shift: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """Integer cell shifts [.., n, 3] -> Cartesian image vectors."""
    return shift @ cell if shift.dim() == 2 else torch.bmm(shift, cell)


def pair_vectors(features) -> torch.Tensor:
    """r_ij vectors [.., nij, 3]: R[j] + S @ cell - R[i].

    If the features carry an explicit "rij" array it is returned as it
    is: an external engine supplies the displacement vectors and
    differentiates the energy w.r.t. them instead of the positions."""
    if "rij" in features:
        return features["rij"]
    pos = features["positions"]
    return (_batch_rows(pos, features["pair_j"].long())
            + _shift_vectors(features["pair_shift"], features["cell"])
            - _batch_rows(pos, features["pair_i"].long()))


def pair_distances(features, eps: float = 1e-14):
    """(rij [.., nij], masked-safe rij): padding entries give 1."""
    rij = safe_norm(pair_vectors(features), eps=eps)
    rij_safe = torch.where(features["pair_mask"] > 0, rij, 1.0)
    return rij, rij_safe


def triple_vectors(features):
    """Owner-anchored triple displacement vectors (r_ij, r_ik)
    [.., nijk, 3] of the flat triple arrays; the caller's "trip_rij" /
    "trip_rik" where the features carry them (the rij-fed mode of an
    external engine or of the heat flux)."""
    if "trip_rij" in features:
        return features["trip_rij"], features["trip_rik"]
    pos, cell = features["positions"], features["cell"]
    ri = _batch_rows(pos, features["trip_i"].long())
    return tuple(_batch_rows(pos, features[f"trip_{s}"].long())
                 + _shift_vectors(features[f"trip_shift_{s}"], cell) - ri
                 for s in ("j", "k"))


def triple_distances(features, eps: float = 1e-14):
    """(rij, rik, rjk) [.., nijk] of every triple; padding entries read 1
    (before anything divides by them)."""
    mask = features["trip_mask"]

    def safe(v):
        return torch.where(mask > 0, safe_norm(v, eps=eps), 1.0)

    vj, vk = triple_vectors(features)
    return safe(vj), safe(vk), safe(vk - vj)
