"""The port's on-device neighbor list and the calculator's routing against
the JAX package at float64: the feature dict of `DeviceNeighborList` key
by key on four cells and three layouts, with and without triples, the
overflow, image and stencil guards, the density and mean censuses, and the
calculator's "auto" / True routes (GRAP, angular SF, the EAM fast route)
against the JAX calculator.

The JAX builder's reference for the feature dicts is compiled once per
cell (layout "both", with triples); the guard tests run its program
eagerly (`_build` without its jit), without compiling one per case.
"""
import json
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoralloy_tpu.atoms import Structure as JaxStructure
from tensoralloy_tpu.calculator import TensorAlloyCalculator as JaxCalculator
from tensoralloy_tpu.nn.atomic import AtomicNN as JaxAtomicNN
from tensoralloy_tpu.nn.eam import EamAlloyNN as JaxEamAlloyNN
from tensoralloy_tpu.nn.grap import GenericRadialAtomicPotential as JaxGrap
from tensoralloy_tpu.nn.sf import SymmetryFunction as JaxSF
from tensoralloy_tpu.transform import Featurizer as JaxFeaturizer
from tensoralloy_tpu.transform.device_nl import (
    DeviceNeighborList as JaxDeviceNeighborList)
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
from tensoralloy_tpu_torch.io.model import model_from_dict
from tensoralloy_tpu_torch.neighbor import neighbor_list
from tensoralloy_tpu_torch.ops.dense import decode_simg, spread_padding
from tensoralloy_tpu_torch.transform.device_nl import DeviceNeighborList
from tensoralloy_tpu_torch.transform.featurizer import (SIMG_BASE,
                                                        Featurizer)

REL = 1e-10


def _cells():
    """The cells of tests/test_device_nl.py: two elements in a cube, a
    box thinner than the cutoff, a 60-degree triclinic cell, a slab."""
    rng = np.random.RandomState(7)
    tric = np.array([[9.0, 0.0, 0.0], [4.5, 7.794, 0.0], [1.0, 2.0, 8.5]])
    slab_pos = rng.uniform(0, 8.0, (18, 3))
    cubic = (["Ni"] * 20 + ["Mo"] * 12, rng.uniform(0, 12.0, (32, 3)),
             np.eye(3) * 12.0, [True] * 3)
    tiny = (["Ni"] * 4, rng.uniform(0, 3.2, (4, 3)), np.eye(3) * 3.2,
            [True] * 3)
    triclinic = (["Mo"] * 24, rng.uniform(0, 1, (24, 3)) @ tric, tric,
                 [True] * 3)
    slab_pos[:, 2] = rng.uniform(10.0, 16.0, 18)
    slab = (["Ni"] * 18, slab_pos, np.diag([8.0, 8.0, 30.0]),
            [True, True, False])
    return {"cubic": cubic, "tiny": tiny, "triclinic": triclinic,
            "slab": slab}


def _both(symbols, pos, cell, pbc=(True, True, True)):
    return (JaxStructure.from_symbols(symbols, pos, cell, pbc=list(pbc)),
            Structure.from_symbols(symbols, pos, cell, pbc=list(pbc)))


def _featurizers(elements, angular, rcut=4.5):
    kw = dict(rcut=rcut, acut=3.5, angular=True) if angular else \
        dict(rcut=rcut)
    return JaxFeaturizer(elements, **kw), Featurizer(elements, **kw)


def _jax_build(builder, positions_vap, cell=None):
    """The JAX builder's program, run eagerly."""
    pos = jnp.asarray(positions_vap)
    cell = jnp.asarray(builder.cell0 if cell is None else cell,
                       dtype=pos.dtype)
    return builder._build(pos, cell, jnp.asarray(0.0, pos.dtype))


def _assert_same_features(jax_feats, feats, keys=None):
    keys = sorted(jax_feats) if keys is None else keys
    assert keys == sorted(k for k in feats if k in keys)
    for k in keys:
        want, got = np.asarray(jax_feats[k]), feats[k].cpu().numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12,
                                       err_msg=k)


def _host_diag(diag):
    return {k: int(v) for k, v in diag.items()}


_JAX_BUILDS = {}


def _jax_reference(cell):
    """The JAX builder of a cell with triples and layout 'both' (every
    key of the three layouts; the arrays do not depend on the layout,
    and the pair arrays not on the triples: acut < rcut), its features
    and diagnostics, made once per cell."""
    if cell not in _JAX_BUILDS:
        symbols, pos, box, pbc = _cells()[cell]
        js, _ = _both(symbols, pos, box, pbc)
        jfz, _ = _featurizers(sorted(set(symbols)), True)
        jvap = jfz.make_vap(js)
        jb = JaxDeviceNeighborList(jfz, jvap, js, layout="both")
        _JAX_BUILDS[cell] = (jb, *jb.build(jnp.asarray(
            jvap.map_positions(js.positions))))
    return _JAX_BUILDS[cell]


@pytest.mark.parametrize("layout", ["dense", "segment", "both"])
@pytest.mark.parametrize("angular", [False, True], ids=["pairs", "triples"])
@pytest.mark.parametrize("cell", ["cubic", "tiny", "triclinic", "slab"])
def test_feature_dict_matches_jax(cell, angular, layout):
    """Every key, dtype and value of the port's build equals the JAX
    builder's, and so do the capacities and the diagnostics."""
    symbols, pos, box, pbc = _cells()[cell]
    _, s = _both(symbols, pos, box, pbc)
    _, fz = _featurizers(sorted(set(symbols)), angular)
    vap = fz.make_vap(s)
    jb, jfeats, jdiag = _jax_reference(cell)
    b = DeviceNeighborList(fz, vap, s, layout=layout)
    assert (b.grid, b.stencil_extent, b.nnl_cap, b.cell_cap) \
        == (jb.grid, jb.stencil_extent, jb.nnl_cap, jb.cell_cap)
    assert b.ntl_cap == (jb.ntl_cap if angular else 0)
    feats, diag = b.build(torch.as_tensor(vap.map_positions(s.positions)))
    dense = {k for k in jfeats if k.endswith("_d")}
    flat = {k for k in jfeats if k.startswith(("pair_", "trip_"))} - dense
    drop = {"dense": flat, "segment": dense, "both": set()}[layout]
    if not angular:
        drop |= {k for k in jfeats if k.startswith("trip_")}
        jdiag = {k: v for k, v in jdiag.items() if k != "ntl_needed"}
        if "pair_term" in jfeats:
            # the global term ids count the angular terms too: read the
            # pairs-only JAX featurizer's table at the same pairs
            jfz, _ = _featurizers(sorted(set(symbols)), False)
            elem = np.array([jfz.elements.index(e) if e != "X" else 0
                             for e in vap.vap_symbols])
            pi, pj = (np.asarray(jfeats[k]) for k in ("pair_i", "pair_j"))
            jfeats = dict(jfeats, pair_term=np.where(
                np.asarray(jfeats["pair_mask"]) > 0,
                jfz._rterm[elem[pi], elem[pj]], 0).astype(np.int32))
    _assert_same_features(jfeats, feats, sorted(set(jfeats) - drop))
    assert not set(feats) & drop
    assert _host_diag(diag) == _host_diag(jdiag)
    b.check(diag)


def _pair_set(builder, feats):
    v2l = builder.vap.vap_to_local
    pjd = feats["pair_j_d"].numpy()
    psd = np.stack([c.numpy() for c in decode_simg(
        feats["pair_simg_d"], torch.float64)], axis=-1)
    rows, cols = np.nonzero(feats["pair_mask_d"].numpy() > 0)
    return {(int(v2l[a]), int(v2l[pjd[a, c]]))
            + tuple(int(round(x)) for x in psd[a, c])
            for a, c in zip(rows, cols)}


def _host_pair_set(structure, cutoff):
    ii, jj, ss, _, _ = neighbor_list(structure, cutoff)
    return {(int(i), int(j)) + tuple(int(round(x)) for x in sh)
            for i, j, sh in zip(ii, jj, ss)}


def test_unwrapped_positions_fold_back():
    """Raw coordinates several cells from home give the host list's
    pairs, with images that satisfy R_j + S @ cell - R_i for the RAW
    positions, and JAX's features."""
    symbols, pos, box, pbc = _cells()["cubic"]
    off = np.random.RandomState(3).randint(-2, 3, (len(pos), 3)) @ box
    js, s = _both(symbols, pos + off, box)
    jfz, fz = _featurizers(["Mo", "Ni"], False)
    vap = fz.make_vap(s)
    b = DeviceNeighborList(fz, vap, s)
    pos_vap = torch.as_tensor(vap.map_positions(s.positions))
    feats, diag = b.build(pos_vap)
    b.check(diag)
    assert _pair_set(b, feats) == _host_pair_set(s, 4.5)
    rows, cols = np.nonzero(feats["pair_mask_d"].numpy() > 0)
    shift = np.stack([c.numpy() for c in decode_simg(
        feats["pair_simg_d"], torch.float64)], axis=-1)[rows, cols]
    p = pos_vap.numpy()
    d = np.linalg.norm(p[feats["pair_j_d"].numpy()[rows, cols]]
                       + shift @ box - p[rows], axis=1)
    assert d.max() < 4.5 and d.min() > 1e-8
    jvap = jfz.make_vap(js)
    jfeats, _ = _jax_build(JaxDeviceNeighborList(jfz, jvap, js),
                           jvap.map_positions(js.positions))
    _assert_same_features(jfeats, feats)


def test_overflow_check_and_grow_as_in_jax():
    """Capacities too small: the diagnostics equal JAX's, `check` raises,
    and growing until it passes gives the host list's pairs."""
    symbols, pos, box, _ = _cells()["cubic"]
    js, s = _both(symbols, pos, box)
    jfz, fz = _featurizers(["Mo", "Ni"], False)
    jvap, vap = jfz.make_vap(js), fz.make_vap(s)
    small = DeviceNeighborList(fz, vap, s, nnl_cap=2, cell_cap=2)
    jsmall = JaxDeviceNeighborList(jfz, jvap, js, nnl_cap=2, cell_cap=2)
    pos_vap = torch.as_tensor(vap.map_positions(s.positions))
    feats, diag = small.build(pos_vap)
    jfeats, jdiag = _jax_build(jsmall, jvap.map_positions(js.positions))
    assert _host_diag(diag) == _host_diag(jdiag)
    _assert_same_features(jfeats, feats)
    with pytest.raises(RuntimeError, match="overflow"):
        small.check(diag)
    grown = small
    for _ in range(6):
        grown = grown.grow(diag)
        feats, diag = grown.build(pos_vap)
        try:
            grown.check(diag)
            break
        except RuntimeError:
            continue
    grown.check(diag)
    assert _pair_set(grown, feats) == _host_pair_set(s, 4.5)


def test_image_overflow_is_counted_and_refused():
    """Positions drifted more than 15 cells from home overflow the
    packed image code: the build counts it as JAX's does, `check`
    raises, and the clamped codes stay decodable."""
    symbols, pos, box, _ = _cells()["cubic"]
    rng = np.random.RandomState(5)
    off = rng.randint(16, 20, size=(len(pos), 3)).astype(float)
    off[::2] *= -1.0
    js, s = _both(symbols, pos + off @ box, box)
    jfz, fz = _featurizers(["Mo", "Ni"], False)
    jvap, vap = jfz.make_vap(js), fz.make_vap(s)
    b = DeviceNeighborList(fz, vap, s)
    feats, diag = b.build(torch.as_tensor(vap.map_positions(s.positions)))
    _, jdiag = _jax_build(JaxDeviceNeighborList(jfz, jvap, js),
                          jvap.map_positions(js.positions))
    assert int(diag["simg_overflow"]) == int(jdiag["simg_overflow"]) > 0
    with pytest.raises(RuntimeError, match="shift-image overflow"):
        b.check(diag)
    psd = feats["pair_simg_d"].numpy()
    assert psd.min() >= 0 and psd.max() < SIMG_BASE ** 3


def test_covers_and_rebuilt_for_after_shrink():
    """A shrunk cell falls out of the stencil's reach as in JAX; the
    re-gridded builder covers it and gives the host list's pairs."""
    rng = np.random.RandomState(3)
    box = np.eye(3) * 11.0
    js, s = _both(["Ni"] * 24, rng.uniform(0, 11.0, (24, 3)), box)
    jfz, fz = JaxFeaturizer(["Ni"], rcut=5.2), Featurizer(["Ni"], rcut=5.2)
    vap = fz.make_vap(s)
    b = DeviceNeighborList(fz, vap, s)
    jb = JaxDeviceNeighborList(jfz, jfz.make_vap(js), js)
    for scale in (1.0, 0.99, 0.97, 0.90, 1.05):
        assert b.covers(box * scale) == jb.covers(box * scale)
        np.testing.assert_allclose(b.stencil_reach(box * scale),
                                   jb.stencil_reach(box * scale),
                                   rtol=1e-15)
    assert b.covers(box) and not b.covers(box * 0.90)
    s2 = s.copy()
    s2.cell, s2.positions = box * 0.90, s.positions * 0.90
    b2 = b.rebuilt_for(s2)
    assert b2.covers(box * 0.90)
    feats, diag = b2.build(torch.as_tensor(vap.map_positions(s2.positions)),
                           cell=s2.cell)
    b2.check(diag)
    assert _pair_set(b2, feats) == _host_pair_set(s2, 5.2)


def test_density_census_as_in_jax():
    """The density census sizes the same capacities as JAX's without a
    host neighbor list, and they cover an fcc crystal."""
    a0 = 3.52
    base = np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
    frac = np.concatenate([base + [i, j, k] for i in range(3)
                           for j in range(3) for k in range(3)])
    js, s = _both(["Ni"] * len(frac), frac * a0, np.eye(3) * a0 * 3)
    jfz, fz = JaxFeaturizer(["Ni"], rcut=6.0), Featurizer(["Ni"], rcut=6.0)
    vap = fz.make_vap(s)
    b = DeviceNeighborList(fz, vap, s, census="density")
    jb = JaxDeviceNeighborList(jfz, jfz.make_vap(js), js, census="density")
    assert (b.nnl_cap, b.cell_cap) == (jb.nnl_cap, jb.cell_cap)
    feats, diag = b.build(torch.as_tensor(vap.map_positions(s.positions)))
    b.check(diag)
    assert _pair_set(b, feats) == _host_pair_set(s, 6.0)


def test_spread_padding_moves_only_masked_slots():
    jd = torch.tensor([[3, 0, 0], [1, 2, 0]], dtype=torch.int32)
    mask = torch.tensor([[1.0, 0.0, 0.0], [1.0, 1.0, 0.0]])
    out = spread_padding(jd, mask, 4)
    assert out.dtype == jd.dtype
    np.testing.assert_array_equal(out.numpy(), [[3, 1, 2], [1, 2, 1]])


def test_padding_spread_leaves_float64_results_unchanged(monkeypatch):
    """E/F/S of a GRAP model differentiated w.r.t. positions on device
    lists: the same to 1e-12 with the padding slots spread off row 0 and
    with all of them on row 0."""
    from tensoralloy_tpu_torch.nn.fields import make_efs_fn
    from tensoralloy_tpu_torch.ops import dense
    pos, box = _fcc(2)
    _, s = _both(["Ni"] * len(pos), pos, box)
    _, _, twin = _grap(["Ni"], {"Ni": len(pos)})
    calc = TensorAlloyCalculator(twin, device="cpu", device_nl=True)
    vap = calc._get_vap(s)
    feats = calc.featurize_device(s, vap)
    assert (feats["pair_mask_d"] <= 0).any()
    efs = make_efs_fn(calc._get_variant(s, True)[0].energy_and_aux)
    spread = efs(feats)
    monkeypatch.setattr(dense, "spread_padding",
                        lambda jd, mask, n_rows: jd)
    row0 = efs(feats)
    for key in ("energy", "forces", "stress_voigt"):
        np.testing.assert_allclose(spread[key].numpy(), row0[key].numpy(),
                                   rtol=1e-12, atol=1e-12)


# ----------------------------------------------------------------------
# the calculator's routes against the JAX calculator
# ----------------------------------------------------------------------

def _port_twin(model, params):
    """The port's model with the JAX model's configuration and weights."""
    twin = model_from_dict(json.loads(json.dumps(model.as_dict())),
                           device="cpu", dtype=torch.float64)
    twin.load_param_tree(jax.tree_util.tree_map(np.asarray, params))
    return twin


def _grap(elements, occurs, seed=0):
    fz = JaxFeaturizer(elements, rcut=4.5)
    desc = JaxGrap(elements, algorithm="pexp",
                   parameters={"rl": [1.0, 2.0, 3.0], "pl": [4.0, 3.0, 2.0]},
                   moment_tensors=[0, 1, 2, 3], backend="dense")
    model = JaxAtomicNN(fz, Counter(occurs), desc, hidden_sizes=[8],
                        minmax_scale=False)
    params = model.init_params(jax.random.PRNGKey(seed))
    return model, params, _port_twin(model, params)


def _fcc(reps, a0=3.52, sigma=0.04, seed=7):
    base = np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
    frac = np.concatenate([base + [i, j, k] for i in range(reps)
                           for j in range(reps) for k in range(reps)])
    pos = frac * a0 + sigma * np.random.RandomState(seed).normal(
        size=(len(frac), 3))
    return pos, np.eye(3) * a0 * reps


def _efs(calc, s):
    return {"energy": calc.get_potential_energy(s),
            "forces": calc.get_forces(s), "stress": calc.get_stress(s)}


def _assert_efs(got, want, rel=REL):
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        err = np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)
        assert err <= rel, (k, err)


def test_auto_routes_large_frames_to_the_device_builder_as_jax():
    """device_nl="auto": a frame of device_nl_auto_atoms atoms or more
    goes through the device builder (density census) and equals the JAX
    calculator's route; a smaller frame keeps the host lists."""
    pos, box = _fcc(2)
    js, s = _both(["Ni"] * len(pos), pos, box)
    model, params, twin = _grap(["Ni"], {"Ni": len(pos)})
    jax_calc = JaxCalculator(model, params, device_nl_auto_atoms=8)
    want = _efs(jax_calc, js)
    calc = TensorAlloyCalculator(twin, device="cpu", device_nl_auto_atoms=8)
    _assert_efs(_efs(calc, s), want)
    assert len(calc._nl_cache) == 1
    (builder,) = calc._nl_cache.values()
    (jax_builder,) = jax_calc._nl_cache.values()
    assert builder.nnl_cap == jax_builder.nnl_cap
    host = TensorAlloyCalculator(twin, device="cpu",
                                 device_nl_auto_atoms=1000)
    _assert_efs(_efs(host, s), want)
    assert len(host._nl_cache) == 0


def test_auto_keeps_angular_models_on_host_lists():
    js, s = _both(*_cells()["cubic"][:3])
    jfz = JaxFeaturizer(["Mo", "Ni"], rcut=4.5, acut=3.5, angular=True)
    model = JaxAtomicNN(jfz, Counter(js.symbols),
                        JaxSF(jfz.elements, backend="dense"),
                        hidden_sizes=[8], minmax_scale=False)
    params = model.init_params(jax.random.PRNGKey(1))
    twin = _port_twin(model, params)
    calc = TensorAlloyCalculator(twin, device="cpu", device_nl_auto_atoms=8)
    want = _efs(JaxCalculator(model, params, device_nl_auto_atoms=8), js)
    _assert_efs(_efs(calc, s), want)
    assert len(calc._nl_cache) == 0
    # device_nl=True builds the triples on the device (exact census)
    dev = TensorAlloyCalculator(twin, device="cpu", device_nl=True)
    _assert_efs(_efs(dev, s), _efs(JaxCalculator(model, params,
                                                 device_nl=True), js))
    assert len(dev._nl_cache) == 1


def test_device_nl_true_reuses_one_builder_over_cells_as_jax():
    """device_nl=True over a strain sweep: one builder while its stencil
    covers the cell, a re-gridded one past it, E/F/S equal to JAX's."""
    rng = np.random.RandomState(7)
    box0 = np.eye(3) * 9.0
    frac = rng.uniform(0, 9.0, (16, 3)) @ np.linalg.inv(box0)
    symbols = ["Ni"] * 8 + ["Mo"] * 8
    model, params, twin = _grap(["Mo", "Ni"], {"Ni": 8, "Mo": 8})
    jcalc = JaxCalculator(model, params, device_nl=True)
    calc = TensorAlloyCalculator(twin, device="cpu", device_nl=True)
    for eps in (0.0, 0.03):
        box = box0 * (1.0 + eps)
        js, s = _both(symbols, frac @ box, box)
        _assert_efs(_efs(calc, s), _efs(jcalc, js))
    assert len(calc._nl_cache) == 1
    (b0,) = calc._nl_cache.values()
    box = box0 * 0.45
    js, s = _both(symbols, frac @ box, box)
    assert not b0.covers(box)
    _assert_efs(_efs(calc, s), _efs(jcalc, js))
    assert len(calc._nl_cache) == 1
    assert next(iter(calc._nl_cache.values())) is not b0


def test_eam_fast_route_on_device_lists_as_jax():
    """device_nl=True with the EAM family: the dense device lists feed
    the analytic EFS; equal to the JAX calculator and to the port's
    autograd route on host lists."""
    pos, box = _fcc(2, sigma=0.06, seed=11)
    js, s = _both(["Ni"] * 32, pos, box)
    fz = JaxFeaturizer(["Ni"], rcut=6.0)
    model = JaxEamAlloyNN(fz, Counter({"Ni": 32}), custom_potentials="zjw04")
    params = model.init_params(jax.random.PRNGKey(0))
    twin = _port_twin(model, params)
    calc = TensorAlloyCalculator(twin, device="cpu", device_nl=True)
    assert calc.fast_efs and calc.layout == "dense"
    got = _efs(calc, s)
    _assert_efs(got, _efs(JaxCalculator(model, params, device_nl=True), js))
    _assert_efs(got, _efs(TensorAlloyCalculator(
        twin, device="cpu", fast_efs=False, device_nl=False), s))
    # the flat layout on device lists: autograd through pair_i / pair_j
    flat = TensorAlloyCalculator(twin, device="cpu", fast_efs=False,
                                 device_nl=True)
    assert flat.layout == "segment"
    _assert_efs(_efs(flat, s), got)


def test_calculator_growth_is_bounded():
    """A builder that cannot be grown out of an overflow raises rather
    than fall back to the host lists."""
    symbols, pos, box, _ = _cells()["cubic"]
    off = np.random.RandomState(5).randint(16, 20, (len(pos), 3))
    off[::2] *= -1
    _, s = _both(symbols, pos + off @ box, box)
    _, _, twin = _grap(["Mo", "Ni"], Counter(symbols))
    calc = TensorAlloyCalculator(twin, device="cpu", device_nl=True)
    with pytest.raises(RuntimeError, match="shift-image overflow"):
        calc.calculate(s)


def _jittered_bcc_mo(reps, sigma, seed):
    """Periodic bcc Mo (a = 3.1467 A), every coordinate moved by
    N(0, sigma) from numpy's generator on `seed`."""
    base = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
    frac = np.concatenate([base + [i, j, k] for i in range(reps)
                           for j in range(reps) for k in range(reps)])
    pos = frac * 3.1467 + np.random.default_rng(seed).normal(
        0.0, sigma, frac.shape)
    return Structure.from_symbols(["Mo"] * len(pos), pos,
                                  np.eye(3) * 3.1467 * reps)


def _census_counts(s, cutoff, acut):
    """Each atom's neighbours within `cutoff` and triples within `acut`,
    from the host list."""
    ii, _, _, dd, _ = neighbor_list(s, cutoff)
    cnt = np.bincount(ii, minlength=len(s))
    ca = np.bincount(ii[dd < acut], minlength=len(s))
    return cnt, ca * (ca - 1) // 2


def _width(counts, margin=1.3):
    mean, most = float(np.mean(counts)), int(np.max(counts))
    need = mean if margin * mean >= most else most
    return -(-int(np.ceil(need * margin)) // 8) * 8


@pytest.mark.parametrize("case", ["bcc", "bcc_triples", "slab",
                                  "cluster"])
def test_mean_census_sizes_widths_by_the_mean_count(case):
    """The 'mean' census: each width is the margin over an atom's mean
    count where that covers the most any atom has, else the exact
    census's; the cell occupancy is the exact census's, and the build
    lists every pair."""
    if case == "slab":
        symbols, pos, box, pbc = _cells()["slab"]
        _, s = _both(symbols, pos, box, pbc)
        fz, cutoff = Featurizer(["Ni"], rcut=4.5, acut=3.5,
                                angular=True), 4.5
    elif case == "cluster":
        # a 3^3 bcc block in vacuum: its centre has 1.86 times the mean
        block = _jittered_bcc_mo(3, 0.0, 0)
        s = Structure.from_symbols(block.symbols, block.positions + 10.0,
                                   np.eye(3) * 40.0, pbc=[False] * 3)
        fz, cutoff = Featurizer(["Mo"], rcut=4.5, acut=3.5,
                                angular=True), 4.5
    else:
        s = _jittered_bcc_mo(4, 0.08, 0)
        fz = Featurizer(["Mo"], rcut=6.5, acut=4.0,
                        angular=case == "bcc_triples")
        cutoff = 7.5
    vap = fz.make_vap(s)
    exact = DeviceNeighborList(fz, vap, s, cutoff=cutoff)
    b = DeviceNeighborList(fz, vap, s, cutoff=cutoff, census="mean")
    cnt, trip = _census_counts(s, cutoff, fz.acut)
    assert b.cell_cap == exact.cell_cap
    assert b.nnl_cap == _width(cnt) >= cnt.max()
    if fz.angular:
        assert b.ntl_cap == _width(trip) >= trip.max()
    if case == "cluster":
        # the most crowded atom has more than 1.3 times the mean: the
        # widths fall back to the exact census's
        assert 1.3 * cnt.mean() < cnt.max()
        assert 1.3 * trip.mean() < trip.max()
        assert (b.nnl_cap, b.ntl_cap) == (exact.nnl_cap, exact.ntl_cap)
    elif case != "slab":
        # this seed's most crowded atom takes the exact width to 160
        assert (b.nnl_cap, exact.nnl_cap) == (152, 160)
    feats, diag = b.build(torch.as_tensor(vap.map_positions(s.positions)))
    b.check(diag)
    assert _pair_set(b, feats) == _host_pair_set(s, cutoff)


def test_mean_census_width_holds_across_jitter_seeds():
    """A jittered crystal's exact width follows its most crowded atom,
    which moves with the seed; the 'mean' census gives one width."""
    fz = Featurizer(["Mo"], rcut=6.5)
    exact, mean = set(), set()
    for seed in range(8):
        s = _jittered_bcc_mo(4, 0.08, seed)
        vap = fz.make_vap(s)
        exact.add(DeviceNeighborList(fz, vap, s, cutoff=7.5).nnl_cap)
        mean.add(DeviceNeighborList(fz, vap, s, cutoff=7.5,
                                    census="mean").nnl_cap)
    assert exact == {152, 160}
    assert mean == {152}


def test_md_device_list_keeps_the_mean_census_when_regridded():
    """`VelocityVerlet(device_nl=True)` sizes its list by the 'mean'
    census (one width where the exact census gives the wider one), and
    a re-gridded or grown builder keeps it."""
    from pathlib import Path

    from tensoralloy_tpu_torch.dynamics import VelocityVerlet
    from tensoralloy_tpu_torch.io.model import load_model
    npz = (Path(__file__).resolve().parent.parent / "artifacts" /
           "mladp_mo_v5" / "model" / "snap_Mo_mladp_gw.npz")
    model, _ = load_model(str(npz), device="cpu", dtype="high")
    s = _jittered_bcc_mo(4, 0.08, 0)
    md = VelocityVerlet(model, s, skin=1.0, device_nl=True)
    exact = DeviceNeighborList(md.fz, md.vap, s, cutoff=md._nl.cutoff,
                               layout=md.layout)
    assert md._nl.census == "mean"
    assert (md._nl.nnl_cap, exact.nnl_cap) == (152, 160)
    assert md._nl.rebuilt_for(s).census == "mean"
    grown = md._nl.grow({"nnl_needed": 153, "cell_needed": 1})
    assert (grown.census, grown.nnl_cap) == ("mean", 200)
