"""The port's file readers and writers against the JAX package's on the
same files: vasprun.xml (zero and finite electron temperature) and
POSCAR, the LAMMPS Tersoff (read and write), MEAM/spline (new and old
layout) and funcfl files, and the LAMMPS native-plugin export of saved
GRAP and finite-temperature models. The files are written here from
seeded numbers.
"""
import numpy as np
import pytest

from tensoralloy_tpu.io import lammps as jl
from tensoralloy_tpu.io import vasp as jv
from tensoralloy_tpu_torch.io import lammps as pl
from tensoralloy_tpu_torch.io import vasp as pv

RNG = np.random.RandomState(11)


def _v(values):
    return "<v>" + " ".join(f"{x:.10f}" for x in values) + "</v>"


def write_vasprun(path, n_steps=3, sigma=0.2):
    """A vasprun.xml with the fields the reader reads: 2 Be + 1 W, `n_steps`
    ionic steps of two electronic steps each."""
    basis = np.eye(3) * 4.1 + RNG.normal(scale=0.05, size=(3, 3))
    lines = ['<?xml version="1.0" encoding="ISO-8859-1"?>', "<modeling>",
             '<parameters><separator name="electronic">'
             f'<i name="SIGMA">{sigma}</i></separator></parameters>',
             '<atominfo><array name="atoms"><set>']
    for sym in ("Be", "Be", "W"):
        lines.append(f"<rc><c>{sym}</c><c>1</c></rc>")
    lines.append("</set></array></atominfo>")
    for _ in range(n_steps):
        lines.append("<calculation>")
        for _ in range(2):
            e0, efr, ewo = RNG.normal(-20, 1, 3)
            lines.append(
                f'<scstep><energy><i name="e_fr_energy">{efr}</i>'
                f'<i name="e_wo_entrp">{ewo}</i>'
                f'<i name="e_0_energy">{e0}</i></energy></scstep>')
        lines.append('<structure><crystal><varray name="basis">')
        lines += [_v(row) for row in basis]
        lines.append('</varray></crystal><varray name="positions">')
        lines += [_v(row) for row in RNG.uniform(size=(3, 3))]
        lines.append('</varray></structure><varray name="forces">')
        lines += [_v(row) for row in RNG.normal(size=(3, 3))]
        lines.append('</varray><varray name="stress">')
        s = RNG.normal(scale=10, size=(3, 3))
        lines += [_v(row) for row in s + s.T]
        lines.append(f'</varray><energy><i name="e_fr_energy">'
                     f'{RNG.normal(-20)}</i></energy></calculation>')
    lines.append("</modeling>")
    path.write_text("\n".join(lines))


def _same_structure(s, js):
    np.testing.assert_array_equal(s.numbers, js.numbers)
    np.testing.assert_array_equal(s.positions, js.positions)
    np.testing.assert_array_equal(s.cell, js.cell)
    assert sorted(s.info) == sorted(js.info)
    for k, v in js.info.items():
        np.testing.assert_array_equal(s.info[k], v, err_msg=k)


@pytest.mark.parametrize("finite_temperature", [False, True])
def test_vasprun_matches_jax(tmp_path, finite_temperature):
    path = tmp_path / "vasprun.xml"
    write_vasprun(path)
    for index in (-1, 0, slice(None)):
        got = pv.read_vasp_xml(str(path), index=index,
                               finite_temperature=finite_temperature)
        want = jv.read_vasp_xml(str(path), index=index,
                                finite_temperature=finite_temperature)
        for s, js in zip(np.atleast_1d(got), np.atleast_1d(want)):
            _same_structure(s, js)


def test_poscar_matches_jax(tmp_path):
    cell = np.eye(3) * 3.2 + RNG.normal(scale=0.1, size=(3, 3))
    frac = RNG.uniform(size=(3, 3))
    for mode, coords, scale in (("Direct", frac, 1.0),
                                ("Cartesian", frac @ cell, -40.0)):
        path = tmp_path / f"POSCAR_{mode}"
        rows = [" ".join(f"{x:.12f}" for x in r) for r in cell]
        body = [" ".join(f"{x:.12f}" for x in r) + " T T F" for r in coords]
        path.write_text("\n".join(["test", str(scale)] + rows
                                  + ["Mo Ni", "1 2", "Selective dynamics",
                                     mode] + body) + "\n")
        _same_structure(pv.read_poscar(str(path)),
                        jv.read_poscar(str(path)))


def test_tersoff_files_match_jax(tmp_path):
    path = tmp_path / "SiC.tersoff"
    rows = ["# Tersoff parameters, two lines an entry"]
    for e in ("Si Si Si", "Si C C", "C C C"):
        vals = RNG.uniform(0.1, 3.0, size=14)
        rows.append(e + " " + " ".join(f"{v:.6f}" for v in vals[:7]))
        rows.append("  " + " ".join(f"{v:.6f}" for v in vals[7:]))
    path.write_text("\n".join(rows) + "\n")
    got, want = pl.read_tersoff_file(str(path)), jl.read_tersoff_file(
        str(path))
    assert got.elements == want.elements and got.params == want.params
    for mod, name in ((pl, "p.tersoff"), (jl, "j.tersoff")):
        mod.write_tersoff_file(str(tmp_path / name), got)
    assert (tmp_path / "p.tersoff").read_text() == \
        (tmp_path / "j.tersoff").read_text()
    assert pl.read_tersoff_file(str(tmp_path / "p.tersoff")).params == \
        want.params


def _spline_block(n, new_format):
    x = np.linspace(1.5, 5.0, n)
    out = (["spline3eq"] if new_format else []) + [str(n), "-1.5 0.0"]
    if not new_format:
        out.append("1 0 1 0")
    return out + [f"{a:.8f} {b:.8f} 0.0" for a, b in
                  zip(x, RNG.normal(size=n))]


@pytest.mark.parametrize("new_format", [True, False])
def test_meam_spline_files_match_jax(tmp_path, new_format):
    elements = ["Ti", "O"] if new_format else ["Ti"]
    nel = len(elements)
    n_splines = nel * (nel + 1) + 3 * nel
    rows = ["# meam/spline"]
    if new_format:
        rows.append(f"meam/spline {nel} " + " ".join(elements))
    for i in range(n_splines):
        rows += _spline_block(6 + i % 3, new_format)
    path = tmp_path / "x.meam.spline"
    path.write_text("\n".join(rows) + "\n")
    kw = {} if new_format else {"element": "Ti"}
    got = pl.read_meam_spline_file(str(path), **kw)
    want = jl.read_meam_spline_file(str(path), **kw)
    assert got.elements == want.elements
    r = np.linspace(1.6, 4.9, 17)
    for table in ("rho", "phi", "embed", "fs", "gs"):
        g, w = getattr(got, table), getattr(want, table)
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k].x, w[k].x)
            np.testing.assert_array_equal(g[k](r), w[k](r))
    if not new_format:
        with pytest.raises(ValueError):
            pl.read_meam_spline_file(str(path))


def test_funcfl_files_match_jax(tmp_path):
    nrho, nr = 30, 40
    vals = RNG.uniform(0.0, 2.0, size=nrho + 2 * nr)
    body = [" ".join(f"{v:.10e}" for v in vals[i:i + 5])
            for i in range(0, len(vals), 5)]
    path = tmp_path / "Ni.funcfl"
    path.write_text("\n".join(["Ni funcfl", "28 58.6934 3.52 fcc",
                               f"{nrho} 0.05 {nr} 0.125 4.8"] + body) + "\n")
    got, want = pl.read_funcfl(str(path)), jl.read_funcfl(str(path))
    for k in ("element", "nrho", "drho", "nr", "dr", "cutoff", "mass"):
        assert getattr(got, k) == getattr(want, k), k
    for k in ("frho", "zr", "rho", "r_grid", "rho_grid"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    np.testing.assert_array_equal(got.phi(), want.phi())
    path.write_text("\n".join(path.read_text().splitlines()[:5]))
    with pytest.raises(ValueError, match="truncated"):
        pl.read_funcfl(str(path))


@pytest.mark.parametrize("run,name", [("snap_ni_v5", "snap_Ni.npz"),
                                      ("td_be", "td_Be.npz")])
def test_lammps_native_export_matches_jax(tmp_path, run, name):
    from tensoralloy_tpu.io.lammps_native import \
        export_to_lammps_native as jax_export
    from tensoralloy_tpu.io.model import load_model as jax_load_model
    from tensoralloy_tpu_torch.io.lammps_native import \
        export_to_lammps_native
    from tensoralloy_tpu_torch.io.model import load_model
    path = f"artifacts/{run}/model/{name}"
    model, _ = load_model(path, device="cpu")
    jmodel, jparams, _ = jax_load_model(path)
    for dtype in (np.float64, np.float32):
        got = export_to_lammps_native(model, str(tmp_path / "p.npz"), dtype)
        want = jax_export(jmodel, jparams, str(tmp_path / "j.npz"), dtype)
        assert sorted(got) == sorted(want)
        saved = np.load(tmp_path / "p.npz")
        for k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(saved[k], want[k], err_msg=k)
