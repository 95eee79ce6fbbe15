"""Evaluation of a finished run directory (port of
`tensoralloy_tpu/train/evaluation.py`).

One overall MAE per property hides where the error lives. The SNAP-style
databases tag frames with a `source` like "Mo.Elastic.12"; grouping the
split by that prefix separates capacity problems (bad on train too) from
generalization problems (bad only on test). `Trainer.evaluate` runs with
full-precision matmuls (`TrainParameters.eval_matmul_precision`), so the
numbers are those of the deployed model.

The split is rebuilt through `Dataset.split_indices`, the split
contract, so rows can never be mis-tagged by a drifted permutation.
"""
import contextlib
import glob
import json
import os
import re
from typing import Optional

import numpy as np

from ..nn.fields import EV_ANGSTROM3_TO_GPA as GPA


@contextlib.contextmanager
def _chdir(path: str):
    prev = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(prev)


def _group_of(source: str) -> str:
    """'Mo.Elastic.12' -> 'Mo.Elastic' (strip the frame counter)."""
    return ".".join(str(source).split(".")[:-1]) or str(source)


def evaluate_run(workdir: str = ".", ckpt: Optional[str] = None,
                 per_group: bool = True, use_ema: bool = True,
                 output: Optional[str] = "group_maes.json",
                 verbose: bool = True, *, device="cuda") -> dict:
    """Evaluate a run dir (containing input.toml + model/) per group.

    Returns {"step", "checkpoint", "splits": {split: {tag: {n,
    energy_meV_per_atom, force_eV_A, stress_GPa}}}} for both splits,
    with an "overall" row per split; writes it to `output` (relative
    to workdir) unless None. `ckpt` picks a specific checkpoint file
    (relative to the CALLER's cwd); default = the newest `ckpt-*.npz`
    in the run's model_dir. `device` is the card unless the caller
    passes "cpu".
    """
    if ckpt is not None:
        ckpt = os.path.abspath(ckpt)
    with _chdir(workdir):
        from .manager import TrainingManager

        mgr = TrainingManager("input.toml", device=device)
        ds = mgr.dataset
        feats, labels = ds.build()
        tf_, tl_, ef_, el_ = ds.split(feats, labels)

        # group tag of every db row, in the same id order list(db) uses
        groups = np.asarray([_group_of(s.info.get("source", "ungrouped"))
                             for s in ds.db])
        # guard on TOTAL rows: a db changed after the cache was built
        # yields a different permutation entirely, and with an integer
        # test_size the test-row COUNT would still match
        if len(groups) != len(labels["energy"]):
            raise RuntimeError(
                f"split mismatch: db has {len(groups)} rows but the "
                f"feature cache has {len(labels['energy'])} — the db "
                "changed after the cache was built (rebuild with "
                "force=True)")
        train_idx, test_idx = ds.split_indices(len(groups))
        tags = {"test": groups[test_idx], "train": groups[train_idx]}

        if ckpt is None:
            # newest NUMBERED checkpoint; ckpt-best.npz (the eval-best
            # model kept by BestCheckpointHook) is selected explicitly
            # via `ckpt`, never implicitly
            cands = sorted(
                (p for p in glob.glob(
                    os.path.join(mgr.model_dir, "ckpt-*.npz"))
                 if re.search(r"ckpt-(\d+)\.npz$", p)),
                key=lambda p: int(p.split("-")[-1].split(".")[0]))
            if not cands:
                raise FileNotFoundError(
                    f"no ckpt-*.npz under {mgr.model_dir!r}")
            ckpt = cands[-1]
        ckpt = os.path.abspath(ckpt)
        params, ema, step = mgr.trainer.load_checkpoint(ckpt)
        eval_params = ema if use_ema else params
        if verbose:
            print(f"checkpoint step {step}: {ckpt}")

        out = {"step": int(step), "checkpoint": ckpt, "splits": {}}
        for split, (sf_all, sl_all) in (("test", (ef_, el_)),
                                        ("train", (tf_, tl_))):
            t = tags[split]
            row_tags = (sorted(set(t)) if per_group else []) + ["overall"]
            rows = {}
            for tag in row_tags:
                sel = (np.arange(len(t)) if tag == "overall"
                       else np.nonzero(t == tag)[0])
                sf = {k: v[sel] for k, v in sf_all.items()}
                sl = {k: v[sel] for k, v in sl_all.items()}
                ev = mgr.trainer.evaluate(eval_params, sf, sl)
                # None (json null), not NaN: bare NaN tokens make the
                # output unreadable by strict JSON parsers
                s_mae = ev.get("stress/mae")
                rows[tag] = {
                    "n": int(len(sel)),
                    "energy_meV_per_atom":
                        1000 * float(ev["energy/mae/atom"]),
                    "force_eV_A": float(ev["forces/mae"]),
                    "stress_GPa":
                        GPA * float(s_mae) if s_mae is not None else None,
                }
            out["splits"][split] = rows
            if verbose:
                print(f"-- {split} --")
                for tag, r in rows.items():
                    s = ("     — " if r["stress_GPa"] is None
                         else f"{r['stress_GPa']:6.3f}")
                    print(f"  {tag:18s} n={r['n']:3d} "
                          f"E {r['energy_meV_per_atom']:7.2f} meV/atom  "
                          f"F {r['force_eV_A']:6.3f} eV/A  "
                          f"S {s} GPa")
        if output:
            with open(output, "w") as f:
                json.dump(out, f, indent=1)
        return out
