"""Fixtures of the benchmark's own tests: small traffic on the CPU (or
the card, for the tests marked `cuda`) and a small copy of the structure
database."""
from __future__ import annotations

import shutil
import sqlite3
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.common import Context, load_json  # noqa: E402

CONFIGS = ROOT / "portbench" / "configs"
TRAFFIC = ROOT / "portbench" / "traffic"


@pytest.fixture
def card():
    """The card, or a skip where torch sees none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return "cuda"


def md_context(device="cpu", reps=3, seed=2 ** 31 + 11, control=False):
    traffic = dict(load_json(TRAFFIC / "nvt_fcc30_300k.json"), reps=reps,
                   warm_chunks=1)
    return Context(cell="md_test", seed=seed, seconds=0.5, trace=False,
                   config=load_json(CONFIGS / "grap_ni_pexp16_m5.json"),
                   traffic=traffic, device=device, control=control)


@pytest.fixture
def small_db(tmp_path):
    """The first 80 rows of the snap-Ni database, its cached metadata
    dropped."""
    path = tmp_path / "snap-Ni-80.db"
    shutil.copy(ROOT / "artifacts" / "snap_ni" / "snap-Ni.db", path)
    con = sqlite3.connect(path)
    for table in ("species", "keys", "text_key_values",
                  "number_key_values"):
        con.execute(f"delete from {table} where id > 80")
    con.execute("delete from systems where id > 80")
    con.execute("delete from information")
    con.commit()
    con.close()
    return path


@pytest.fixture
def train_context(small_db, tmp_path, monkeypatch):
    """A train context on the small database, its work directory in the
    test's own temporary directory."""
    from portbench.drivers import train
    monkeypatch.setattr(train, "WORK", tmp_path / "work")

    def make(device="cpu", seed=2 ** 31 + 23, control=False):
        traffic = dict(load_json(TRAFFIC / "snapni_batches.json"),
                       database=str(small_db), test_size=10, warm_steps=4)
        return Context(cell="train_test", seed=seed, seconds=0.5,
                       trace=False, traffic=traffic, device=device,
                       control=control,
                       config=load_json(CONFIGS / "sf_ni_g2g4_acut4.json"))
    return make
