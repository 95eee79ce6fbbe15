"""The port's device ops against the JAX package at float64: cutoffs,
dense geometry, the transpose reduction, and the G2/G4 twins and
autograd Functions against JAX `fused_g2`/`fused_g4` (Pallas in
interpret mode), values and VJPs to 1e-12; the host tables that the
kernel wrappers keep per descriptor."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoralloy_tpu.atoms import Structure as JaxStructure
from tensoralloy_tpu.nn.sf import SymmetryFunction as JaxSF
from tensoralloy_tpu.ops import cutoffs as jax_cutoffs
from tensoralloy_tpu.ops import dense as jax_dense
from tensoralloy_tpu.ops import fused as jax_fused
from tensoralloy_tpu.transform import Featurizer as JaxFeaturizer
from tensoralloy_tpu_torch.nn.grap import GenericRadialAtomicPotential
from tensoralloy_tpu_torch.ops import cutoffs, dense, fused

from test_torch_host import fcc_ni, mo_ni

TOL = dict(rtol=1e-12, atol=1e-12)
CELLS = {"ni_fcc": (fcc_ni, ["Ni"]), "moni": (mo_ni, ["Mo", "Ni"])}


@functools.lru_cache(maxsize=None)
def _features(cell_name):
    """Dense features (numpy, float64) of a test cell, rcut 4.5 and
    acut 3.5, from the JAX featurizer."""
    build, elements = CELLS[cell_name]
    symbols, pos, cell = build()
    s = JaxStructure.from_symbols(symbols, pos, cell, pbc=[True] * 3)
    fz = JaxFeaturizer(elements, rcut=4.5, acut=3.5, angular=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TENSORALLOY_TPU_NO_NATIVE", "1")
        return fz, fz.featurize(s, fz.make_vap(s), layout="dense",
                                transpose=True)


def _torch(feats):
    return {k: torch.as_tensor(v) for k, v in feats.items()}


def _jnp(feats):
    return {k: jnp.asarray(v) for k, v in feats.items()}


@pytest.mark.parametrize("name", sorted(cutoffs.CUTOFFS))
def test_cutoffs_match_jax(name):
    r = np.linspace(0.0, 7.0, 701)
    want = np.asarray(jax_cutoffs.apply_cutoff(name, jnp.asarray(r), 6.0))
    got = cutoffs.apply_cutoff(name, torch.as_tensor(r), 6.0).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_dense_geometry_matches_jax(cell):
    _, feats = _features(cell)
    rij, unit, islot, mask = dense.dense_pair_geometry(_torch(feats))
    j_rij, j_unit, _, _ = jax_dense.dense_pair_geometry(_jnp(feats))
    np.testing.assert_allclose(rij.numpy(), np.asarray(j_rij), **TOL)
    for u, ju in zip(unit, j_unit):
        np.testing.assert_allclose(u.numpy(), np.asarray(ju), **TOL)
    trip = dense.dense_triple_geometry(_torch(feats))
    j_trip = jax_dense.dense_triple_geometry(_jnp(feats))
    for t, jt in zip(trip, j_trip):
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), **TOL)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_transpose_reduce_matches_jax(cell):
    _, feats = _features(cell)
    rng = np.random.RandomState(3)
    g = [rng.normal(size=feats["pair_j_d"].shape) for _ in range(3)]
    for idx, msk in (("pair_trans_d", "pair_trans_mask_d"),
                     ("trip_trans_j_d", "trip_trans_j_mask_d")):
        gg = g if idx.startswith("pair") else [
            rng.normal(size=feats["trip_j_d"].shape) for _ in range(3)]
        got = dense.transpose_reduce([torch.as_tensor(x) for x in gg],
                                     torch.as_tensor(feats[idx]),
                                     torch.as_tensor(feats[msk]))
        want = jax_dense.transpose_reduce([jnp.asarray(x) for x in gg],
                                          jnp.asarray(feats[idx]),
                                          jnp.asarray(feats[msk]))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _jax_op(pallas_impl, ref_impl, n_diff):
    return jax_fused._custom_vjp_op(pallas_impl, ref_impl, n_diff=n_diff)


def _check(cell, kind, cutoff, zeta):
    """Twin, autograd Function and JAX custom-VJP op on the same inputs:
    values, and the VJP w.r.t. the distances for a seeded cotangent."""
    fz, feats = _features(cell)
    sf = JaxSF(fz.elements, eta=[0.05, 0.5, 4.0], omega=[0.0, 1.0],
               beta=[0.005, 0.05], gamma=[1.0, -1.0], zeta=zeta,
               cutoff_function=cutoff, backend="pallas")
    if kind == "g2":
        rij, _, slot, mask = jax_dense.dense_pair_geometry(_jnp(feats))
        diff, rest = [rij], [slot, mask]
        n_slots, rc, grid = fz.n_radial_slots, fz.rcut, sf.radial_grid
        op = _jax_op(functools.partial(jax_fused._g2_pallas, sf, rc, n_slots),
                     functools.partial(jax_fused._g2_ref_dense, sf, rc,
                                       n_slots), 1)
        function, twin = fused.G2Function, fused.g2_reference
        # the public entry point agrees with the op on the same features
        whole = jax_fused.fused_g2(sf, _jnp(feats), rc, n_slots)
    else:
        *diff, slot, mask = jax_dense.dense_triple_geometry(_jnp(feats))
        rest = [slot, mask]
        n_slots, rc, grid = fz.n_angular_slots, fz.acut, sf.angular_grid
        op = _jax_op(functools.partial(jax_fused._g4_pallas, sf, rc, n_slots),
                     functools.partial(jax_fused._g4_ref_dense, sf, rc,
                                       n_slots), 3)
        function, twin = fused.G4Function, fused.g4_reference
        whole = jax_fused.fused_g4(sf, _jnp(feats), rc, n_slots)
    want, vjp = jax.vjp(lambda *d: op(*d, *rest), *diff)
    gbar = np.random.RandomState(7).normal(size=want.shape)
    want_grads = vjp(jnp.asarray(gbar))[:len(diff)]
    np.testing.assert_allclose(np.asarray(whole), np.asarray(want), **TOL)
    assert n_slots > 1 or cell == "ni_fcc"

    spec = (grid, rc, cutoff, n_slots)
    t_rest = [torch.as_tensor(np.array(x)) for x in rest]
    for impl in (function.apply, twin):
        t_diff = [torch.as_tensor(np.array(x)).requires_grad_()
                  for x in diff]
        got = impl(*t_diff, *t_rest, *spec)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
        grads = torch.autograd.grad(got, t_diff, torch.as_tensor(gbar))
        for g, wg in zip(grads, want_grads):
            np.testing.assert_allclose(g.numpy(), np.asarray(wg), **TOL)


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("cutoff", ["cosine", "polynomial"])
def test_g2_matches_jax_fused(cell, cutoff):
    _check(cell, "g2", cutoff, [1.0])


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("cutoff", ["cosine", "polynomial"])
@pytest.mark.parametrize("zeta", [1.0, 4.0])
def test_g4_matches_jax_fused(cell, cutoff, zeta):
    _check(cell, "g4", cutoff, [zeta])


def test_kernel_wrappers_refuse_bad_inputs():
    """On CPU tensors the wrappers take the twins; anything the kernels
    cannot take is refused, never silently computed elsewhere."""
    x = torch.ones(4, 8, dtype=torch.float64)
    grid = np.array([[0.5, 0.0]])
    assert fused.g2_kernel(x, 0 * x, x, grid, 6.0, "cosine", 1).shape == (
        4, 1)
    with pytest.raises(ValueError, match="no kernel"):
        fused.g2_kernel(x.to("meta"), x.to("meta"), x.to("meta"), grid,
                        6.0, "cosine", 1)
    with pytest.raises(ValueError, match="at most"):
        fused._grid_columns(np.zeros((fused.MAX_PARAMS + 1, 2)))
    with pytest.raises(ValueError, match="contiguous"):
        fused._check_cuda_inputs("g2", x, x.t().contiguous().t(), x)
    with pytest.raises(TypeError, match="mixed dtypes"):
        fused._check_cuda_inputs("g2", x, x.float(), x)
    with pytest.raises(TypeError, match="float32 or float64"):
        fused._check_cuda_inputs("g2", x.half(), x.half(), x.half())


@pytest.mark.parametrize("cutoff", ["cosine", "polynomial"])
def test_g2_matches_jax_fused_two_slots_odd_width(cutoff):
    """Twin and autograd Function against JAX `fused_g2` (interpret
    mode) on seeded rows of 30 entries (no multiple of 4) in two slots,
    with masked tails and an empty first row: values, and the VJP
    through rij = |vec| for a seeded cotangent."""
    rng = np.random.RandomState(11)
    rows, n, n_slots, rc = 7, 30, 2, 4.5
    lengths = rng.randint(0, n + 1, size=rows)
    lengths[0] = 0
    mask = (np.arange(n)[None, :] < lengths[:, None]).astype(np.float64)
    vx = rng.uniform(0.5, 1.1 * rc, (rows, n))
    slot = rng.randint(0, n_slots, (rows, n)).astype(np.float64)
    sf = JaxSF(["Mo", "Ni"], eta=[0.05, 0.5, 4.0], omega=[0.0, 1.0],
               cutoff_function=cutoff, backend="pallas")
    zeros = jnp.zeros((rows, n))

    def jax_g2(x):
        feats = {"pair_j_d": None, "positions": None, "cell": None,
                 "pair_mask_d": jnp.asarray(mask),
                 "pair_islot_d": jnp.asarray(slot),
                 "pair_vec_d": (x, zeros, zeros)}
        return jax_fused.fused_g2(sf, feats, rc, n_slots)

    want, vjp = jax.vjp(jax_g2, jnp.asarray(vx))
    gbar = rng.normal(size=want.shape)
    (want_grad,) = vjp(jnp.asarray(gbar))
    assert want.shape == (rows, n_slots * 6)

    for impl in (fused.G2Function.apply, fused.g2_reference):
        x = torch.as_tensor(vx).requires_grad_()
        rij = torch.sqrt(x * x + 1e-14)
        rij = torch.where(torch.as_tensor(mask) > 0, rij, 1.0)
        got = impl(rij, torch.as_tensor(slot), torch.as_tensor(mask),
                   sf.radial_grid, rc, cutoff, n_slots)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
        (grad,) = torch.autograd.grad(got, x, torch.as_tensor(gbar))
        np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad),
                                   **TOL)


GRAP_PARAMETERS = {
    "sf": {"eta": [0.5, 2.0, 8.0], "omega": [0.0, 0.5, 1.0]},
    "density": {"A": [1.0, 1.0], "beta": [2.0, 4.0], "re": [3.0, 3.0]},
    "morse": {"D": [1.0, 1.0], "gamma": [0.5, 1.0], "r0": [2.0, 2.5]},
    "pexp": {"rl": [1.0, 2.0, 3.0], "pl": [4.0, 3.0, 2.0]},
}


def _assert_tables_equal(got, want):
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[2:], want[2:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("algorithm", sorted(fused.GRAP_ALGORITHMS))
def test_kept_grap_tables_equal_fresh_ones(algorithm):
    """The host tables a launch keeps per descriptor specification are
    the freshly built ones, the same objects at a second call, and
    read-only."""
    desc = GenericRadialAtomicPotential(
        ["Mo", "Ni"], algorithm=algorithm,
        parameters=GRAP_PARAMETERS[algorithm], moment_tensors=[0, 1, 3],
        symmetric=True)
    kept = fused.kept_grap_tables(desc)
    _assert_tables_equal(kept, fused.grap_tables(desc))
    again = fused.kept_grap_tables(GenericRadialAtomicPotential.from_dict(
        desc.as_dict()))
    assert all(a is b for a, b in zip(again[1:], kept[1:]))
    _assert_tables_equal(again, fused.grap_tables(desc))
    with pytest.raises(ValueError, match="read-only"):
        kept[3][0, 0] = 7.0


def test_descriptors_with_other_grids_get_other_tables():
    """A descriptor that differs in its grid, its moments or its
    symmetric flag never gets another's kept tables."""
    base = dict(algorithm="pexp", parameters=GRAP_PARAMETERS["pexp"],
                moment_tensors=[0, 1, 2], symmetric=False)
    variants = [base,
                {**base, "parameters": {"rl": [1.0, 2.0, 3.5],
                                        "pl": [4.0, 3.0, 2.0]}},
                {**base, "moment_tensors": [0, 2]},
                {**base, "symmetric": True},
                {**base, "algorithm": "sf",
                 "parameters": GRAP_PARAMETERS["sf"]}]
    descs = [GenericRadialAtomicPotential(["Ni"], **v) for v in variants]
    assert len({fused.grap_spec(d) for d in descs}) == len(descs)
    for d in descs:
        _assert_tables_equal(fused.kept_grap_tables(d), fused.grap_tables(d))
    first, second = (fused.kept_grap_tables(d) for d in descs[:2])
    assert not np.array_equal(first[1][0], second[1][0])


@pytest.mark.parametrize("kind", ["g2", "g4"])
def test_kept_grid_columns_survive_a_second_call(kind):
    """The G2 / G4 grid columns are built once per grid content, equal
    the freshly built ones after a call through the wrapper, cannot be
    written to, and differ for a grid that differs."""
    sf = JaxSF(["Ni"], eta=[0.05, 0.5, 4.0], omega=[0.0, 1.0],
               beta=[0.005, 0.05], gamma=[1.0, -1.0], zeta=[1.0, 4.0])
    grid = sf.radial_grid if kind == "g2" else sf.angular_grid
    cols = fused.grid_tables(grid)
    fresh = [c.copy() for c in fused._grid_columns(np.asarray(grid))]
    x = torch.ones(3, 8, dtype=torch.float64)
    if kind == "g2":
        fused.g2_kernel(x, 0 * x, x, grid, 6.0, "cosine", 1)
    else:
        fused.g4_kernel(x, x, x, 0 * x, x, grid, 6.0, "cosine", 1)
    again = fused.grid_tables(np.array(grid))
    assert len(again) == grid.shape[1]
    for a, b, c in zip(again, cols, fresh):
        assert a is b
        np.testing.assert_array_equal(a, c)
        with pytest.raises(ValueError, match="read-only"):
            a[0] = -1.0
    other = np.array(grid)
    other[0, 0] += 0.25
    assert fused.grid_tables(other)[0][0] == grid[0, 0] + 0.25
    assert fused.grid_tables(grid)[0][0] == grid[0, 0]
