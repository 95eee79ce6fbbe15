"""The port's input layer against the JAX package's: the TOML reader on
every experiment file under artifacts/, and the structure file readers
(extxyz, STEPMAX xyz, cif, `read_file`) on the same files, exact or to
1e-12."""
import glob
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from tensoralloy_tpu.io import cif as jax_cif
from tensoralloy_tpu.io import extxyz as jax_extxyz
from tensoralloy_tpu.io import sqlite as jax_sqlite
from tensoralloy_tpu.io import units as jax_units
from tensoralloy_tpu.io import xyz as jax_xyz
from tensoralloy_tpu.io.input import InputReader as JaxInputReader
from tensoralloy_tpu.linear.preset import (
    get_filter_preset as jax_filter_preset)
from tensoralloy_tpu_torch import utils
from tensoralloy_tpu_torch.atoms import Structure, voigt_to_full_3x3
from tensoralloy_tpu_torch.io import cif, extxyz, sqlite, units, xyz
from tensoralloy_tpu_torch.io.input import InputReader
from tensoralloy_tpu_torch.linear.preset import get_filter_preset

ROOT = Path(__file__).resolve().parent.parent
TOMLS = sorted(glob.glob(str(ROOT / "artifacts" / "*" / "input.toml")))
CIFS = sorted(glob.glob(str(
    ROOT / "tensoralloy_tpu" / "data" / "crystals" / "*.cif")))


def test_all_experiment_files_are_found():
    assert len(TOMLS) == 38


@pytest.mark.parametrize("path", TOMLS,
                         ids=[Path(p).parent.name for p in TOMLS])
def test_reader_matches_jax_on_every_experiment_file(path):
    want = JaxInputReader(path)
    got = InputReader(path)
    assert got.as_dict() == want.as_dict()
    # relative paths resolve against the file's directory
    assert os.path.isabs(got["dataset.sqlite3"])
    assert got["dataset.sqlite3"].startswith(str(ROOT / "artifacts"))
    assert got["train.model_dir"] == want["train.model_dir"]
    assert ("nn.atomic.grap.backend" in got) and "no.such.key" not in got
    assert got.get("no.such.key", 7) == 7
    with pytest.raises(KeyError):
        got["no.such.key"]


def test_the_ports_toml_files_are_copies():
    """The port reads its own defaults and choices, equal to the JAX
    package's."""
    import tensoralloy_tpu.io.input.reader as jax_reader
    import tensoralloy_tpu_torch.io.input.reader as reader
    here, there = Path(reader.__file__).parent, Path(
        jax_reader.__file__).parent
    assert here != there and "tensoralloy_tpu_torch" in str(here)
    for name in ("defaults.toml", "choices.toml"):
        assert (here / name).read_bytes() == (there / name).read_bytes()


def test_reader_takes_a_dict_and_validates():
    cfg = {"dataset": {"sqlite3": "some.db", "name": "x"},
           "pair_style": "atomic/grap"}
    got, want = InputReader(dict(cfg)), JaxInputReader(dict(cfg))
    assert got.as_dict() == want.as_dict()
    assert got["dataset.sqlite3"] == os.path.join(os.getcwd(), "some.db")
    with pytest.raises(ValueError, match="not a valid choice"):
        InputReader(dict(cfg, pair_style="atomic/nope"))
    with pytest.raises(ValueError, match="not a valid choice"):
        InputReader({**cfg, "opt": {"method": "lion"}})
    with pytest.raises(ValueError, match="dataset.sqlite3"):
        InputReader({"dataset": {"name": "x"}})
    with pytest.raises(ValueError, match="dataset.name"):
        InputReader({"dataset": {"sqlite3": "some.db"}})
    # a named preset bank of an allowed algorithm passes
    preset = {**cfg, "nn": {"atomic": {"grap": {
        "algorithm": "pexp@medium"}}}}
    assert InputReader(preset)["nn.atomic.grap.algorithm"] == "pexp@medium"
    # validation can be switched off, as in the reference
    InputReader(dict(cfg, pair_style="atomic/nope"), validate=False)


def test_nested_helpers_and_mode_keys():
    d = {}
    utils.nested_set(d, "a.b.c", 3)
    assert d == {"a": {"b": {"c": 3}}}
    assert utils.nested_get(d, "a.b.c") == 3
    assert utils.nested_get(d, "a.x.c", "dflt") == "dflt"
    assert utils.nested_get(d, "a.b.c.d") is None
    from tensoralloy_tpu.utils import ModeKeys as JaxModeKeys
    for name in ("TRAIN", "EVAL", "PREDICT"):
        assert getattr(utils.ModeKeys, name) == getattr(JaxModeKeys, name)
    assert utils.ModeKeys.for_prediction(utils.ModeKeys.PREDICT)
    assert not utils.ModeKeys.for_prediction(utils.ModeKeys.TRAIN)


@pytest.mark.parametrize("key", ["pexp@small", "pexp@medium", "pexp@large",
                                 "morse@small", "morse@medium",
                                 "morse@large"])
def test_filter_presets_match_jax(key):
    got, want = get_filter_preset(key), jax_filter_preset(key)
    assert got["algorithm"] == want["algorithm"]
    assert got["param_space_method"] == want["param_space_method"]
    assert sorted(got["parameters"]) == sorted(want["parameters"])
    for name, values in want["parameters"].items():
        np.testing.assert_array_equal(got["parameters"][name], values)
    with pytest.raises((KeyError, ValueError)):
        get_filter_preset("pexp@huge")


def test_units_match_jax():
    for expr in ("Hartree", "eV", "kcal/mol", "eV/Angstrom", "GPa", "kbar",
                 "Hartree/Bohr", "eV/Angstrom**3"):
        assert units.get_conversion_factor(expr) == \
            jax_units.get_conversion_factor(expr), expr
    spec = {"energy": "Hartree", "forces": "Hartree/Bohr", "stress": "GPa"}
    assert units.get_unit_conversions(spec) == \
        jax_units.get_unit_conversions(spec)
    with pytest.raises(Exception):
        units.get_conversion_factor("__import__('os')")


def _structures(seed=0, n=4):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        na = 3 + i
        cell = np.eye(3) * 6.0 + rng.normal(0, 0.3, (3, 3))
        info = {"energy": float(rng.normal()),
                "forces": rng.normal(size=(na, 3)),
                "stress": rng.normal(size=6),
                "source": f"Ni.Group.{i}"}
        if i % 2:
            info.update(etemperature=0.1 * i, eentropy=float(rng.rand()),
                        free_energy=float(rng.normal()))
        out.append(Structure.from_symbols(
            ["Ni", "Mo"][i % 2:] + ["Ni"] * (na - 2 + i % 2),
            rng.uniform(0, 6, (na, 3)), cell, pbc=[True, True, i != 2],
            **info))
    return out


def _assert_structures_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numbers, b.numbers)
        np.testing.assert_array_equal(a.pbc, b.pbc)
        np.testing.assert_array_equal(a.positions, b.positions)
        np.testing.assert_array_equal(a.cell, b.cell)
        assert sorted(a.info) == sorted(b.info)
        for key, value in b.info.items():
            if isinstance(value, str):
                assert a.info[key] == value
            else:
                np.testing.assert_array_equal(a.info[key], value, key)


def test_extxyz_round_trip_and_both_readers(tmp_path):
    structures = _structures()
    path = str(tmp_path / "frames.extxyz")
    extxyz.write_extxyz(path, structures)
    extxyz.write_extxyz(path, structures[:1], append=True)
    got = extxyz.read_extxyz(path)
    want = jax_extxyz.read_extxyz(path)
    assert len(got) == 5
    _assert_structures_equal(got, want)
    # what was written comes back, to the digits the text carries
    for s, back in zip(structures, got):
        np.testing.assert_allclose(back.positions, s.positions, atol=1e-7)
        np.testing.assert_allclose(back.forces, s.forces, atol=1e-7)
        np.testing.assert_allclose(back.stress, s.stress, atol=1e-7)
        assert back.info["source"] == s.info["source"]
    # the JAX writer's file is read the same by both
    jpath = str(tmp_path / "jax.extxyz")
    jax_extxyz.write_extxyz(jpath, want)
    _assert_structures_equal(extxyz.read_extxyz(jpath),
                             jax_extxyz.read_extxyz(jpath))
    assert Path(jpath).read_text() == Path(path).read_text()
    assert len(extxyz.read_extxyz(path, index=slice(1, 3))) == 2
    np.testing.assert_array_equal(
        voigt_to_full_3x3(np.arange(6.0)),
        [[0, 5, 4], [5, 1, 3], [4, 3, 2]])


def test_stepmax_xyz_round_trip_and_both_readers(tmp_path):
    s = _structures(seed=1, n=1)[0]
    path = str(tmp_path / "s.xyz")
    xyz.write_stepmax_xyz(path, s)
    got, want = xyz.read_stepmax_xyz(path), jax_xyz.read_stepmax_xyz(path)
    _assert_structures_equal([got], [want])
    np.testing.assert_allclose(got.positions, s.positions, atol=1e-6)
    np.testing.assert_allclose(got.energy, s.energy, rtol=1e-12)
    assert xyz.HARTREE == jax_xyz.HARTREE


@pytest.mark.parametrize("path", CIFS, ids=[Path(p).stem[:12] for p in CIFS])
def test_cif_reader_matches_jax(path):
    got, want = cif.read_cif(path), jax_cif.read_cif(path)
    _assert_structures_equal([got], [want])
    assert len(got) > 0
    np.testing.assert_array_equal(
        cif.cellpar_to_cell(3.0, 4.0, 5.0, 80.0, 95.0, 110.0),
        jax_cif.cellpar_to_cell(3.0, 4.0, 5.0, 80.0, 95.0, 110.0))


def test_cif_files_exist():
    assert len(CIFS) >= 4


def test_read_file_converts_every_energy_like_label(tmp_path):
    """`read_file` builds the same database as the JAX package's: rows,
    labels, metadata, and the energy unit on energy, free energy,
    entropy and electron temperature alike."""
    structures = _structures(seed=2, n=6)
    path = str(tmp_path / "frames.extxyz")
    extxyz.write_extxyz(path, structures)
    jdir = tmp_path / "jax"
    jdir.mkdir()
    shutil.copy(path, jdir / "frames.extxyz")
    kw = dict(unit_energy=27.2, unit_forces=51.4, unit_stress=0.1,
              fmax_limit=1e6)
    db = sqlite.read_file(path, **kw)
    jdb = jax_sqlite.read_file(str(jdir / "frames.extxyz"), **kw)
    assert db.filename == str(tmp_path / "frames.db")
    assert len(db) == len(jdb) == 6
    assert db.max_occurs == jdb.max_occurs
    _assert_structures_equal(list(db), list(jdb))
    raw = extxyz.read_extxyz(path)
    for row, s in zip(db, raw):
        np.testing.assert_allclose(row.energy, s.energy * 27.2, rtol=1e-12)
        np.testing.assert_allclose(row.forces, s.forces * 51.4, rtol=1e-12)
        np.testing.assert_allclose(row.stress, s.stress * 0.1, rtol=1e-12)
        for key in ("free_energy", "eentropy", "etemperature"):
            if key in s.info:
                np.testing.assert_allclose(row.info[key],
                                           s.info[key] * 27.2, rtol=1e-12)
    assert any("eentropy" in s.info for s in raw)
    # a database path is opened as it is; the force filter drops frames
    assert len(sqlite.read_file(db.filename)) == 6
    few = sqlite.read_file(path, db_path=str(tmp_path / "few.db"),
                           fmax_limit=1.0)
    assert 0 < len(few) < 6 or all(
        np.abs(s.forces).max() > 1.0 for s in raw)
