"""Dataset pipeline: database -> featurized, padded, batched arrays (port
of `tensoralloy_tpu/train/dataset.py`; numpy only).

Structures are featurized once into fixed-shape numpy arrays and cached
as a compressed ``.npz`` in a directory the caller names (the file name
carries the signature: name, k_max, rc, layout, precision, count);
batches are index selections of those arrays. Labels are VAP-mapped on
the host so the device loss is pure array math. The layout is the one
the model reads: 'dense' (per-atom rows, the 'dense' and 'pallas'
descriptor backends), 'segment' (flat pair and triple arrays padded to
the database's largest counts, the EAM family and the 'segment'
descriptor backends) or 'both', the default, as in the JAX package.

The cache schema (``f_<feature>``, ``l_<label>``), the file names (the
layout is part of the name: ``...-dense-...``, ``...-segment-...``, and
no tag for 'both'), the split permutation (`RandomState(seed)`, test
rows first) and the batch order are shared with the JAX package, so
either package reads the other's cache. Where a ``-dense`` or
``-segment`` file is absent, `build` reads the ``both`` file and keeps
the keys of its own layout. A cache that predates the packed periodic
images is upgraded and rewritten on load
(`ops.dense.convert_legacy_shifts`).
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, Tuple

import numpy as np

from ..atoms import Structure
from ..io.sqlite import CoreDatabase
from ..neighbor import NeighborSize
from ..ops.dense import convert_legacy_shifts
from ..transform.featurizer import Featurizer, batch_features

Arrays = Dict[str, np.ndarray]


class Dataset:
    """Featurize-once dataset with train/test split."""

    def __init__(self, database: CoreDatabase, featurizer: Featurizer,
                 name: str = "dataset", test_size: float | int = 0.2,
                 seed: int = 611, dtype=np.float32, *,
                 cache_dir: str,
                 layout: str = "both", transpose: bool = False):
        self.db = database
        self.featurizer = featurizer
        self.name = name
        self.test_size = test_size
        self.seed = seed
        self.dtype = dtype
        # the cache is written where the caller says, never next to the
        # database by default
        self.cache_dir = str(cache_dir)
        if layout not in ("dense", "segment", "both"):
            raise ValueError(f"unknown layout {layout!r}")
        self.layout = layout
        # also emit the host-built transpose tables so the trainer can
        # assemble forces scatter-free (`force_assembly='dense'`)
        self.transpose = bool(transpose)
        self.max_occurs = database.max_occurs
        self.sizes: NeighborSize = database.get_neighbor_sizes(
            featurizer.rcut, angular=featurizer.angular,
            acut=featurizer.acut if featurizer.angular else None)
        self.nij_max = int(self.sizes.nij)
        self.nijk_max = int(self.sizes.nijk)
        self.nnl_max = int(self.sizes.nnl_tot)
        self.ntl_max = int(self.sizes.ntl)
        self.ttrans_max = int(getattr(self.sizes, "ttrans", 0))
        self.n_atoms_vap = int(sum(self.max_occurs.values()) + 1)

    # ------------------------------------------------------------------
    @property
    def signature(self) -> str:
        k = 3 if self.featurizer.angular else 2
        fp = {np.dtype(np.float32): "fp32",
              np.dtype(np.float64): "fp64"}[np.dtype(self.dtype)]
        # v2: dense-layout columns (pair_col/ncols) added to the schema
        sig = f"{self.name}-v2-k{k}-rc{self.featurizer.rcut:.2f}"
        if self.layout != "both":
            sig += f"-{self.layout}"
        if self.transpose:
            sig += "-tr"   # transpose tables change the cached schema
        if self.featurizer.angular:
            # acut and the symmetric flag change the triple features;
            # they must invalidate the cache
            sig += (f"-ac{self.featurizer.acut:.2f}"
                    f"-{'sym' if self.featurizer.symmetric else 'full'}")
        return f"{sig}-{fp}-{len(self.db)}"

    @property
    def cache_path(self) -> str:
        return os.path.join(self.cache_dir, self.signature + ".npz")

    # ------------------------------------------------------------------
    def _featurize_one(self, s: Structure) -> Tuple[Arrays, Arrays]:
        fz = self.featurizer
        vap = fz.make_vap(s, self.max_occurs)
        feats = fz.featurize(s, vap, nij_max=self.nij_max,
                             nijk_max=self.nijk_max or None,
                             nnl_max=self.nnl_max or None,
                             ntl_max=self.ntl_max or None,
                             dtype=self.dtype, layout=self.layout,
                             transpose=self.transpose,
                             ttrans_max=(self.ttrans_max or None)
                             if self.transpose else None)
        labels: Arrays = {
            "energy": np.asarray(s.energy if s.energy is not None else 0.0,
                                 dtype=self.dtype),
            "n_atoms": np.asarray(len(s), dtype=self.dtype),
        }
        forces = s.forces
        labels["forces"] = (vap.map_forces(forces).astype(self.dtype)
                            if forces is not None
                            else np.zeros((vap.n_atoms_vap, 3), self.dtype))
        stress = s.stress
        labels["stress"] = (np.asarray(stress, dtype=self.dtype)
                            if stress is not None
                            else np.zeros(6, self.dtype))
        labels["has_stress"] = np.asarray(
            0.0 if stress is None else 1.0, dtype=self.dtype)
        w = np.asarray(s.info.get("weights", [1.0, 1.0, 1.0]),
                       dtype=self.dtype)
        if w.size < 3:
            w = np.pad(w, (0, 3 - w.size), constant_values=1.0)
        labels["weights"] = w
        labels["eentropy"] = np.asarray(
            s.info.get("eentropy", 0.0), dtype=self.dtype)
        labels["free_energy"] = np.asarray(
            s.info.get("free_energy", s.energy or 0.0), dtype=self.dtype)
        return feats, labels

    # ------------------------------------------------------------------
    def build(self, force: bool = False, verbose: bool = False,
              serial: bool = True) -> Tuple[Arrays, Arrays]:
        """Featurize the whole database (cached to .npz); `serial=False`
        fans out over processes."""
        cached = None if force else self._existing_cache()
        if cached is not None:
            with np.load(cached) as z:
                data = {k: z[k] for k in z.files}
            if cached != self.cache_path:
                # a 'both' file: the other layout's arrays go unread
                drop = (lambda k: not k.endswith("_d")) \
                    if self.layout == "dense" else (lambda k: k.endswith("_d"))
                data = {k: v for k, v in data.items()
                        if not (k.startswith(("f_pair_", "f_trip_"))
                                and drop(k))}
        else:
            structures = list(self.db)
            n_jobs = 0 if serial else (os.cpu_count() or 1)
            if n_jobs > 1 and len(structures) >= 64:
                # fresh interpreters, not forks: the parent may hold a
                # CUDA context, which a forked child must not inherit
                import multiprocessing
                from concurrent.futures import ProcessPoolExecutor

                from ..native import get_lib
                get_lib()   # built here once, not raced by the workers
                with ProcessPoolExecutor(
                        max_workers=n_jobs,
                        mp_context=multiprocessing.get_context("spawn")
                        ) as ex:
                    pairs = list(ex.map(self._featurize_one, structures,
                                        chunksize=16))
            else:
                pairs = []
                for i, s in enumerate(structures):
                    pairs.append(self._featurize_one(s))
                    if verbose and (i + 1) % 500 == 0:
                        print(f"featurized {i + 1}/{len(structures)}")
            feats_list = [p[0] for p in pairs]
            labels_list = [p[1] for p in pairs]
            feats = batch_features(feats_list)
            labels = batch_features(labels_list)
            data = {**{f"f_{k}": v for k, v in feats.items()},
                    **{f"l_{k}": v for k, v in labels.items()}}
            os.makedirs(os.path.dirname(os.path.abspath(
                self.cache_path)), exist_ok=True)
            np.savez_compressed(self.cache_path, **data)
        feats = {k[2:]: v for k, v in data.items() if k.startswith("f_")}
        labels = {k[2:]: v for k, v in data.items() if k.startswith("l_")}
        # caches from before the packed images stored float [B, A, N, 3]
        # shift arrays; convert, then rewrite the file so that the
        # conversion and the larger arrays are paid for once
        legacy = [k for k in feats
                  if k in ("pair_shift_d", "trip_shift_j_d",
                           "trip_shift_k_d")]
        feats = convert_legacy_shifts(feats)
        if legacy:
            try:
                np.savez_compressed(
                    cached, **{f"f_{k}": v for k, v in feats.items()},
                    **{f"l_{k}": v for k, v in labels.items()})
            except OSError:
                pass        # read-only cache dir: converted copy stays
        return feats, labels

    def _existing_cache(self):
        """The cache file to read: this layout's, else the file that the
        JAX package's default layout ('both') writes; None if neither
        exists."""
        if os.path.exists(self.cache_path):
            return self.cache_path
        both = os.path.join(
            self.cache_dir,
            self.signature.replace(f"-{self.layout}", "", 1) + ".npz")
        return both if os.path.exists(both) else None

    def input_fn(self, batch_size: int, mode: str = "train",
                 repeat: bool = True):
        """-> a () -> iterator closure over (features, labels) batches of
        the train or the test split."""
        feats, labels = self.build()
        tf_, tl_, ef_, el_ = self.split(feats, labels)
        f, l = (tf_, tl_) if mode == "train" else (ef_, el_)

        def input_fn():
            return batches(f, l, batch_size, seed=self.seed, repeat=repeat,
                           shuffle=(mode == "train"))
        return input_fn

    def next_batch(self, batch_size: int, mode: str = "train"):
        return next(self.input_fn(batch_size, mode)())

    # ------------------------------------------------------------------
    def split_indices(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """(train_idx, test_idx) for an n-row dataset — THE split
        contract (seeded permutation, test rows first). External
        evaluators (e.g. per-group error breakdowns) must consume
        these instead of re-deriving the permutation, so any future
        change to the split logic cannot silently mis-tag rows."""
        rng = np.random.RandomState(self.seed)
        idx = rng.permutation(n)
        n_test = (int(self.test_size) if self.test_size >= 1
                  else max(1, int(round(self.test_size * n))))
        n_test = min(n_test, n - 1) if n > 1 else 0
        return idx[n_test:], idx[:n_test]

    def split(self, feats: Arrays, labels: Arrays
              ) -> Tuple[Arrays, Arrays, Arrays, Arrays]:
        train_idx, test_idx = self.split_indices(len(labels["energy"]))
        take = lambda d, i: {k: v[i] for k, v in d.items()}
        return (take(feats, train_idx), take(labels, train_idx),
                take(feats, test_idx), take(labels, test_idx))


def batch_index_stream(n: int, batch_size: int, seed: int = 0,
                       shuffle: bool = True, drop_remainder: bool = True,
                       repeat: bool = False, skip: int = 0
                       ) -> Iterator[np.ndarray]:
    """Stream of [batch_size] index arrays (the canonical batch order —
    `batches` and the device-resident fast path share it, so exact
    checkpoint resume sees the same data order either way).

    `skip` fast-forwards by that many batches without materializing.
    """
    rng = np.random.RandomState(seed)
    to_skip = int(skip)
    while True:
        idx = rng.permutation(n) if shuffle else np.arange(n)
        if n < batch_size:
            # tiny dataset: wrap-pad so one full batch is always emitted
            idx = np.resize(idx, batch_size)
        stop = len(idx) - batch_size + 1 if drop_remainder else len(idx)
        for lo in range(0, stop, batch_size):
            if to_skip > 0:
                to_skip -= 1
                continue
            sel = idx[lo:lo + batch_size]
            if len(sel) < batch_size:
                sel = np.resize(sel, batch_size)  # wrap-pad final batch
            yield sel
        if not repeat:
            return


def batches(feats: Arrays, labels: Arrays, batch_size: int, seed: int = 0,
            shuffle: bool = True, drop_remainder: bool = True,
            repeat: bool = False, skip: int = 0
            ) -> Iterator[Tuple[Arrays, Arrays]]:
    """Simple host-side batch iterator (device_put left to the caller)."""
    n = len(labels["energy"])
    for sel in batch_index_stream(n, batch_size, seed=seed,
                                  shuffle=shuffle,
                                  drop_remainder=drop_remainder,
                                  repeat=repeat, skip=skip):
        yield ({k: v[sel] for k, v in feats.items()},
               {k: v[sel] for k, v in labels.items()})


def to_tensors(arrays: Arrays, device="cuda", dtype=None
               ) -> Dict[str, "torch.Tensor"]:
    """Feature or label arrays -> tensors on `device`: the card unless
    the caller passes "cpu" ("cuda" without a card raises). Floating
    arrays are cast to `dtype` ('high' | 'medium' | a torch float dtype)
    when given; index arrays keep their integer type."""
    import torch

    from ..precision import resolve_device, resolve_dtype
    device = resolve_device(device)
    dtype = None if dtype is None else resolve_dtype(dtype)
    out = {}
    for key, value in arrays.items():
        t = torch.as_tensor(value, device=device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[key] = t
    return out
