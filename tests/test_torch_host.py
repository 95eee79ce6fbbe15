"""The port's numpy host layer against the JAX package's: the dense
featurizer output (with transpose tables and triples) must be identical,
integer arrays exactly and float arrays to 1e-12."""
from dataclasses import asdict

import numpy as np
import pytest

from tensoralloy_tpu.atoms import Structure as JaxStructure
from tensoralloy_tpu.neighbor import (
    find_neighbor_size_of_atoms as jax_neighbor_size)
from tensoralloy_tpu.transform import Featurizer as JaxFeaturizer
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.neighbor import find_neighbor_size_of_atoms
from tensoralloy_tpu_torch.transform import Featurizer
from tensoralloy_tpu_torch.utils import get_kbody_terms


def fcc_ni(reps=2, seed=0):
    """Jittered fcc Ni cell, a = 3.52 A."""
    basis = np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
    grid = np.array([(i, j, k) for i in range(reps) for j in range(reps)
                     for k in range(reps)])
    pos = ((grid[:, None, :] + basis[None]) * 3.52).reshape(-1, 3)
    pos = pos + np.random.RandomState(seed).normal(0, 0.05, pos.shape)
    return ["Ni"] * len(pos), pos, np.eye(3) * 3.52 * reps


def mo_ni(seed=0, n=24):
    """The binary random cell of tests/test_backends.py."""
    rng = np.random.RandomState(seed)
    symbols = ["Ni"] * (n // 2) + ["Mo"] * (n - n // 2)
    return symbols, rng.uniform(0, 7.0, (n, 3)), np.eye(3) * 7.0


# (transpose table, its mask, the forward table it inverts, that mask)
TABLES = [("pair_trans_d", "pair_trans_mask_d", "pair_j_d", "pair_mask_d"),
          ("trip_trans_j_d", "trip_trans_j_mask_d", "trip_j_d",
           "trip_mask_d"),
          ("trip_trans_k_d", "trip_trans_k_mask_d", "trip_k_d",
           "trip_mask_d")]
CASES = {
    # the served model's cutoffs: rcut 6, acut 4
    "ni_fcc": (fcc_ni, ["Ni"], dict(rcut=6.0, acut=4.0)),
    "moni": (mo_ni, ["Mo", "Ni"], dict(rcut=4.5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("bucketed", [False, True])
def test_featurizer_matches_jax(case, bucketed, monkeypatch):
    monkeypatch.setenv("TENSORALLOY_TPU_NO_NATIVE", "1")
    build, elements, kw = CASES[case]
    symbols, pos, cell = build()
    jax_fz = JaxFeaturizer(elements, angular=True, **kw)
    fz = Featurizer(elements, angular=True, **kw)
    opts = dict(transpose=True)
    if bucketed:   # the calculator's widths
        opts.update(nnl_bucket=lambda n: max(32, 1 << (n - 1).bit_length()),
                    ntl_bucket=lambda n: max(64, 1 << (n - 1).bit_length()),
                    dtype=np.float32)
    js = JaxStructure.from_symbols(symbols, pos, cell, pbc=[True] * 3)
    s = Structure.from_symbols(symbols, pos, cell, pbc=[True] * 3)
    ref = jax_fz.featurize(js, jax_fz.make_vap(js), layout="dense", **opts)
    out = fz.featurize(s, fz.make_vap(s), **opts)
    assert sorted(out) == sorted(ref)
    assert "trip_trans_k_d" in out and out["pair_islot_d"].max() >= (
        len(elements) - 1)
    for key, want in ref.items():
        got = out[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12,
                                       err_msg=key)


@pytest.mark.parametrize("case", sorted(CASES))
def test_neighbor_size_and_terms_match_jax(case, monkeypatch):
    monkeypatch.setenv("TENSORALLOY_TPU_NO_NATIVE", "1")
    from tensoralloy_tpu.utils import get_kbody_terms as jax_terms
    build, elements, kw = CASES[case]
    symbols, pos, cell = build()
    js = JaxStructure.from_symbols(symbols, pos, cell, pbc=[True] * 3)
    s = Structure.from_symbols(symbols, pos, cell, pbc=[True] * 3)
    acut = kw.get("acut")
    assert (asdict(find_neighbor_size_of_atoms(s, kw["rcut"], True, acut))
            == asdict(jax_neighbor_size(js, kw["rcut"], True, acut)))
    assert get_kbody_terms(elements, angular=True) == jax_terms(
        elements, angular=True)


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("widened", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_transpose_tables_invert_the_forward_tables(case, widened, native,
                                                    monkeypatch):
    """The contract `ops.dense.transpose_reduce`'s backward rests on: the
    masked entries of each transpose table are the forward table's real
    flat slots, each once, and each sits in the row of its neighbour."""
    if not native:
        monkeypatch.setenv("TENSORALLOY_TPU_NO_NATIVE", "1")
    build, elements, kw = CASES[case]
    s = Structure.from_symbols(*build(), pbc=[True] * 3)
    fz = Featurizer(elements, angular=True, **kw)
    opts = dict(transpose=True)
    if widened:
        out = fz.featurize(s, fz.make_vap(s), **opts)
        opts.update(nnl_max=out["pair_j_d"].shape[1] + 5,
                    ntl_max=out["trip_j_d"].shape[1] + 7,
                    ttrans_max=max(out[f"trip_trans_{k}_d"].shape[1]
                                   for k in "jk") + 9)
    out = fz.featurize(s, fz.make_vap(s), **opts)
    for tidx, tmask, jd, mask in TABLES:
        real = np.flatnonzero(out[mask].reshape(-1) > 0)
        rows, cols = np.nonzero(out[tmask] > 0)
        slots = out[tidx][rows, cols]
        assert len(real) > 0 and (out[tmask] == 0).any(), tidx
        np.testing.assert_array_equal(np.sort(slots), real, err_msg=tidx)
        np.testing.assert_array_equal(out[jd].reshape(-1)[slots], rows,
                                      err_msg=tidx)


# ----------------------------------------------------------------------
# Database, Dataset and batches
# ----------------------------------------------------------------------

def _assert_arrays_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12,
                                       err_msg=key)


@pytest.fixture(scope="module")
def small_databases(tmp_path_factory):
    """12 Ni structures of at most 32 atoms and 8 Be frames (with electron
    temperature and entropy), written by the port and opened by both
    packages."""
    from pathlib import Path
    from tensoralloy_tpu.io.sqlite import connect as jax_connect
    from test_torch_training import BE_DB, NI_DB, small_db
    tmp = tmp_path_factory.mktemp("host_db")
    out = {}
    for name, source, n, atoms in (("ni", NI_DB, 12, 32),
                                   ("be", BE_DB, 8, 36)):
        db = small_db(source, Path(tmp) / f"{name}.db", n, atoms)
        out[name] = (db, jax_connect(db.filename))
    return out


@pytest.mark.parametrize("name", ["ni", "be"])
def test_database_matches_jax(small_databases, name, monkeypatch):
    """Rows, labels and info, and the cached metadata: max_occurs,
    neighbor sizes, static energies."""
    monkeypatch.setenv("TENSORALLOY_TPU_NO_NATIVE", "1")
    db, jax_db = small_databases[name]
    assert len(db) == len(jax_db)
    for s, js in zip(db, jax_db):
        np.testing.assert_array_equal(s.numbers, js.numbers)
        np.testing.assert_array_equal(s.positions, js.positions)
        np.testing.assert_array_equal(s.cell, js.cell)
        np.testing.assert_array_equal(s.pbc, js.pbc)
        assert s.energy == js.energy
        np.testing.assert_array_equal(s.forces, js.forces)
        np.testing.assert_array_equal(s.stress, js.stress)
        assert sorted(s.info) == sorted(js.info)
        for key in ("eentropy", "etemperature", "free_energy", "source"):
            assert s.info.get(key) == js.info.get(key)
        np.testing.assert_array_equal(s.info.get("weights", []),
                                      js.info.get("weights", []))
    if name == "be":
        assert "eentropy" in db.get(1).info
    # the JAX package computes and caches first, the port reads the cache;
    # then the port computes what is not cached yet
    assert db.elements == jax_db.elements
    assert jax_db.max_occurs == db.max_occurs
    assert jax_db.get_atomic_static_energy() == db.get_atomic_static_energy()
    want = jax_db.get_neighbor_sizes(4.5, angular=True, acut=3.5)
    assert asdict(db.get_neighbor_sizes(4.5, angular=True, acut=3.5)) \
        == asdict(want)
    got = db.get_neighbor_sizes(4.0, angular=True, acut=3.0)
    sizes = [find_neighbor_size_of_atoms(s, 4.0, True, acut=3.0)
             for s in db]
    assert got.ntl == max(x.ntl for x in sizes) > 0
    assert asdict(jax_db.get_neighbor_sizes(4.0, angular=True, acut=3.0)) \
        == asdict(got)
    with pytest.raises(KeyError):
        db.get(10 ** 6)


@pytest.mark.parametrize("name,angular", [("ni", True), ("ni", False),
                                          ("be", False)])
def test_dataset_matches_jax(small_databases, name, angular, tmp_path,
                             monkeypatch):
    """The port's Dataset against the JAX Dataset over one database: the
    signature, the arrays (integers exactly), the cache file of either
    read by the other, the split and the batch order."""
    monkeypatch.setenv("TENSORALLOY_TPU_NO_NATIVE", "1")
    from tensoralloy_tpu.train import dataset as jax_dataset
    from tensoralloy_tpu_torch.train import dataset
    from tensoralloy_tpu_torch.transform.featurizer import batch_features
    db, jax_db = small_databases[name]
    kw = dict(rcut=4.5, angular=angular)
    if angular:
        kw["acut"] = 3.5
    common = dict(name=name, test_size=3, seed=7, dtype=np.float64,
                  transpose=True)
    jds = jax_dataset.Dataset(jax_db, JaxFeaturizer(jax_db.elements, **kw),
                              cache_dir=str(tmp_path / "jax"),
                              layout="dense", **common)
    ds = dataset.Dataset(db, Featurizer(db.elements, **kw),
                         cache_dir=str(tmp_path / "port"), layout="dense",
                         **common)
    assert ds.signature == jds.signature
    want_f, want_l = jds.build()
    got_f, got_l = ds.build()
    _assert_arrays_equal(got_f, want_f)
    _assert_arrays_equal(got_l, want_l)
    assert got_f["positions"].shape[:2] == (len(db), ds.n_atoms_vap)
    # each reads the other's cache
    cached = dataset.Dataset(db, ds.featurizer, layout="dense",
                             cache_dir=str(tmp_path / "jax"), **common)
    _assert_arrays_equal(cached.build()[0], want_f)
    for a, b in zip(ds.split_indices(len(db)), jds.split_indices(len(db))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ds.split(got_f, got_l), jds.split(want_f, want_l)):
        _assert_arrays_equal(a, b)
    for opts in (dict(repeat=True, skip=2), dict(shuffle=False),
                 dict(drop_remainder=False)):
        port = dataset.batch_index_stream(len(db), 5, seed=3, **opts)
        jax_ = jax_dataset.batch_index_stream(len(db), 5, seed=3, **opts)
        for _ in range(4):
            a, b = next(port, None), next(jax_, None)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    bf, bl = next(dataset.batches(got_f, got_l, 4, seed=1))
    jf, jl = next(jax_dataset.batches(want_f, want_l, 4, seed=1))
    _assert_arrays_equal(bf, jf)
    _assert_arrays_equal(bl, jl)
    one = [ds._featurize_one(s)[0] for s in list(db)[:2]]
    _assert_arrays_equal(batch_features(one),
                         {k: v[:2] for k, v in got_f.items()})
    # the flat pair (and, angular, triple) layout and 'both': the same
    # arrays, and each reads the other's cache
    jseg = jax_dataset.Dataset(jax_db, jds.featurizer,
                               cache_dir=str(tmp_path / "jax"),
                               layout="segment", **common)
    seg = dataset.Dataset(db, ds.featurizer, cache_dir=str(tmp_path / "p2"),
                          layout="segment", **common)
    assert seg.signature == jseg.signature
    want_f = jseg.build()[0]
    _assert_arrays_equal(seg.build()[0], want_f)
    _assert_arrays_equal(dataset.Dataset(
        db, ds.featurizer, cache_dir=str(tmp_path / "jax"),
        layout="segment", **common).build()[0], want_f)
    jboth = jax_dataset.Dataset(jax_db, jds.featurizer,
                                cache_dir=str(tmp_path / "jax"), **common)
    both = dataset.Dataset(db, ds.featurizer,
                           cache_dir=str(tmp_path / "jax"), **common)
    assert both.layout == "both" and both.signature == jboth.signature
    _assert_arrays_equal(both.build()[0], jboth.build()[0])
