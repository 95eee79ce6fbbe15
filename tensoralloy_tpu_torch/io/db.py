"""Database factory helpers (reference `tensoralloy/io/db.py:23-91`)."""
from __future__ import annotations

from .sqlite import CoreDatabase, connect  # noqa: F401


def qm7() -> CoreDatabase:
    """The bundled QM7 database (stripped from the reference snapshot;
    rebuild it from the published QM7 extxyz)."""
    raise FileNotFoundError(
        "the bundled qm7.db was stripped from the reference snapshot; "
        "build it from the published QM7 extxyz with "
        "the build CLI")


def snap() -> CoreDatabase:
    """The bundled SNAP Ni-Mo database (stripped upstream; same note
    as `qm7`)."""
    raise FileNotFoundError(
        "the bundled snap.db was stripped from the reference snapshot; "
        "build it from the published SNAP data with the build CLI")
