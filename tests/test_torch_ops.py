"""The port's device ops against the JAX package at float64: cutoffs,
dense geometry, the transpose reduction, and the G2/G4 twins and
autograd Functions against JAX `fused_g2`/`fused_g4` (Pallas in
interpret mode), values and VJPs to 1e-12; the host tables that the
kernel wrappers keep per descriptor."""
import functools
from collections import Counter

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
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.nn.grap import GenericRadialAtomicPotential
from tensoralloy_tpu_torch.ops import cutoffs, dense, fused
from tensoralloy_tpu_torch.transform.featurizer import (Featurizer,
                                                        batch_features)

from test_torch_host import TABLES, fcc_ni, mo_ni

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
    for idx, msk, jd, fmsk in TABLES:
        gg = g if idx.startswith("pair") else [
            rng.normal(size=feats["trip_j_d"].shape) for _ in range(3)]
        got = dense.transpose_reduce(
            [torch.as_tensor(x) for x in gg],
            *(torch.as_tensor(feats[k]) for k in (idx, msk, jd, fmsk)))
        want = jax_dense.transpose_reduce([jnp.asarray(x) for x in gg],
                                          jnp.asarray(feats[idx]),
                                          jnp.asarray(feats[msk]))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@functools.lru_cache(maxsize=None)
def _mixed_batch():
    """A padded batch as the snap-Ni batches are: jittered fcc Ni of 4,
    32 and 4 atoms on one 33-row map, rc 6 / acut 4, every table wider
    than its largest structure needs (numpy, float64)."""
    fz = Featurizer(["Ni"], rcut=6.0, acut=4.0, angular=True)
    occurs = Counter({"Ni": 32})
    structures = [Structure.from_symbols(*fcc_ni(reps, seed),
                                         pbc=[True] * 3)
                  for reps, seed in ((1, 0), (2, 1), (1, 2))]

    def featurize(**widths):
        return [fz.featurize(s, fz.make_vap(s, occurs), transpose=True,
                             **widths) for s in structures]

    natural = featurize()
    widths = dict(
        nnl_max=max(f["pair_j_d"].shape[1] for f in natural) + 5,
        ntl_max=max(f["trip_j_d"].shape[1] for f in natural) + 7,
        ttrans_max=max(f[f"trip_trans_{s}_d"].shape[1]
                       for f in natural for s in "jk") + 9)
    return batch_features(featurize(**widths))


def _gather_and_sum(g, trans_idx, trans_mask):
    """The assembly as a plain gather and masked row sum, whose backward
    autograd derives (an accumulating `index_put`): the oracle."""
    b, a, n = g[0].shape
    tab = torch.stack([gc.reshape(-1) for gc in g], dim=-1)
    offset = torch.arange(0, b * a * n, a * n).view(b, 1, 1)
    gt = tab[trans_idx + offset]
    return tuple(torch.sum(gt[..., c] * trans_mask, dim=-1)
                 for c in range(3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("table", TABLES, ids=lambda t: t[0])
def test_transpose_reduce_backward_is_the_forward_gather(table, dtype):
    """On a padded batch of mixed sizes the Functions give autograd's
    values and gradient of the gather-and-sum, bit for bit, and each
    call is counted; in float64 the first and second orders pass
    gradcheck."""
    feats = _mixed_batch()
    idx, msk, jd, fmsk = (torch.as_tensor(feats[k]) for k in table)
    msk, fmsk = msk.to(dtype), fmsk.to(dtype)
    assert (fmsk == 0).any() and (msk == 0).any()
    gen = torch.Generator().manual_seed(11)
    g = [torch.randn(jd.shape, generator=gen, dtype=dtype,
                     requires_grad=True) for _ in range(3)]
    gout = [torch.randn(idx.shape[:2], generator=gen, dtype=dtype)
            for _ in range(3)]
    want = _gather_and_sum(g, idx, msk)
    want_grad = torch.autograd.grad(want, g, gout)
    dense.reset_assembly_counts()
    got = dense.transpose_reduce(g, idx, msk, jd, fmsk)
    got_grad = torch.autograd.grad(got, g, gout)
    assert dense.assembly_counts == {
        "transpose_reduce": 1, "transpose_reduce_bwd": 1,
        "forward_gather": 1, "forward_gather_bwd": 0}
    for a, b in zip(got + got_grad, want + want_grad):
        assert torch.equal(a, b)
    if dtype == torch.float64:
        def fn(*comps):
            return dense.transpose_reduce(comps, idx, msk, jd, fmsk)
        leaves = tuple(c.detach().requires_grad_() for c in g)
        assert torch.autograd.gradcheck(fn, leaves, fast_mode=True)
        assert torch.autograd.gradgradcheck(fn, leaves, fast_mode=True)


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
        symmetric=True, backend="dense")
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


# ----------------------------------------------------------------------
# Second order: the Functions' backwards are differentiable, as the JAX
# custom-VJP op (its backward is `jax.vjp` of the XLA reference).
# ----------------------------------------------------------------------

SECOND = dict(rtol=1e-10, atol=1e-10)


def check_second_order(op, ref, function, diff, rest, spec, seed=5):
    """s = sum_i <u_i, VJP_i(x; gbar)> with seeded u and gbar; ds/dgbar
    and ds/dx through the autograd Function (double backward) against
    `jax.grad` of the same scalar (jax.grad of jax.grad): ds/dgbar
    through the JAX custom-VJP op `op` (Pallas forward), which is what a
    force loss differentiates, and ds/dx through the XLA reference `ref`
    (JAX cannot linearize the Pallas forward w.r.t. its inputs). `diff`,
    `rest` are numpy arrays. Every result is finite."""
    rng = np.random.RandomState(seed)
    us = [rng.normal(size=d.shape) for d in diff]
    j_rest = [jnp.asarray(x) for x in rest]
    shape = op(*(jnp.asarray(d) for d in diff), *j_rest).shape
    gbar = rng.normal(size=shape)

    def scalar(fn, xs, gb):
        _, vjp = jax.vjp(lambda *d: fn(*d, *j_rest), *xs)
        grads = vjp(gb)[:len(xs)]
        return sum(jnp.vdot(jnp.asarray(u), g) for u, g in zip(us, grads))

    j_diff = tuple(jnp.asarray(d) for d in diff)
    want_gbar = jax.grad(functools.partial(scalar, op), argnums=1)(
        j_diff, jnp.asarray(gbar))
    want_x, ref_gbar = jax.grad(functools.partial(scalar, ref),
                                argnums=(0, 1))(j_diff, jnp.asarray(gbar))
    np.testing.assert_allclose(np.asarray(ref_gbar), np.asarray(want_gbar),
                               rtol=1e-9, atol=1e-9)

    x = [torch.as_tensor(np.array(d)).requires_grad_() for d in diff]
    gb = torch.as_tensor(gbar).requires_grad_()
    y = function.apply(*x, *(torch.as_tensor(np.array(r)) for r in rest),
                       *spec)
    grads = torch.autograd.grad(y, x, gb, create_graph=True)
    s = sum((torch.as_tensor(u) * g).sum() for u, g in zip(us, grads))
    got_gbar, *got_x = torch.autograd.grad(s, [gb] + x)
    assert np.abs(np.asarray(want_gbar)).max() > 0
    for got, want in zip([got_gbar] + got_x, [want_gbar] + list(want_x)):
        assert torch.isfinite(got).all()
        # JAX's second derivative of max(1 + gamma cos, 0)^1 where the
        # clamp is active is 0 * inf: those entries are left out here
        # (tests/test_torch_second_order.py holds them to the twin)
        want = np.asarray(want)
        finite = np.isfinite(want)
        assert finite.mean() > 0.5
        scale = max(np.abs(want[finite]).max(), 1.0)
        np.testing.assert_allclose(got.numpy()[finite] / scale,
                                   want[finite] / scale, **SECOND)
    # with grad mode off in the backward (serving) no graph is kept
    (first,) = torch.autograd.grad(function.apply(
        *x, *(torch.as_tensor(np.array(r)) for r in rest), *spec).sum(),
        x[:1])
    assert not first.requires_grad


def seeded_rows(rng, rows, n, n_slots, rc, triples=False):
    """[rows, n] distances with masked tails of ZERO distances and an
    empty first row -> (list of distance arrays, slot, mask)."""
    lengths = rng.randint(0, n + 1, size=rows)
    lengths[0] = 0
    mask = (np.arange(n)[None, :] < lengths[:, None]).astype(np.float64)
    slot = rng.randint(0, n_slots, (rows, n)).astype(np.float64)
    if not triples:
        return [rng.uniform(0.5, 1.1 * rc, (rows, n)) * mask], slot, mask
    vj, vk = (rng.normal(size=(rows, n, 3)) for _ in range(2))
    vj *= rng.uniform(1.0, 1.1 * rc, (rows, n, 1)) / np.linalg.norm(
        vj, axis=-1, keepdims=True)
    vk *= rng.uniform(1.0, 1.1 * rc, (rows, n, 1)) / np.linalg.norm(
        vk, axis=-1, keepdims=True)
    dists = [np.linalg.norm(v, axis=-1) * mask for v in (vj, vk, vk - vj)]
    return dists, slot, mask


@pytest.mark.parametrize("cutoff", ["cosine", "polynomial"])
def test_g2_second_order_matches_jax(cutoff):
    rng = np.random.RandomState(21)
    diff, slot, mask = seeded_rows(rng, 6, 13, 2, 4.5)
    sf = JaxSF(["Mo", "Ni"], eta=[0.05, 0.5, 4.0], omega=[0.0, 1.0],
               cutoff_function=cutoff, backend="pallas")
    ref = functools.partial(jax_fused._g2_ref_dense, sf, 4.5, 2)
    op = _jax_op(functools.partial(jax_fused._g2_pallas, sf, 4.5, 2), ref, 1)
    check_second_order(op, ref, fused.G2Function, diff, [slot, mask],
                       (sf.radial_grid, 4.5, cutoff, 2))


@pytest.mark.parametrize("gamma,zeta", [([1.0, -1.0], [1.0, 4.0]),
                                        ([2.0, -2.0], [1.0, 2.0, 4.0])])
@pytest.mark.parametrize("cutoff", ["cosine", "polynomial"])
def test_g4_second_order_matches_jax(cutoff, gamma, zeta):
    """Masked tails of zero distances, and with |gamma| = 2 the clamp of
    1 + gamma cos(theta) at 0 is active on many triples."""
    rng = np.random.RandomState(22)
    diff, slot, mask = seeded_rows(rng, 12, 11, 3, 3.5, triples=True)
    sf = JaxSF(["Mo", "Ni"], beta=[0.005, 0.05], gamma=gamma, zeta=zeta,
               cutoff_function=cutoff, backend="pallas")
    if gamma[0] == 2.0:
        cos = (diff[0] ** 2 + diff[1] ** 2 - diff[2] ** 2) / np.where(
            mask > 0, 2 * diff[0] * diff[1], 1.0)
        assert ((1.0 - 2.0 * cos < 0) & (mask > 0)).sum() > 5
    ref = functools.partial(jax_fused._g4_ref_dense, sf, 3.5, 3)
    op = _jax_op(functools.partial(jax_fused._g4_pallas, sf, 3.5, 3), ref, 3)
    check_second_order(op, ref, fused.G4Function, diff, [slot, mask],
                       (sf.angular_grid, 3.5, cutoff, 3))


def test_function_inputs_computed_from_each_other():
    """Inputs of one Function call that depend on each other in the
    graph (r_jk computed from r_ij and r_ik): the differentiable backward
    returns the partial derivative of each, not the total one, so first
    and second derivatives equal the plain twin's."""
    rng = np.random.RandomState(23)
    (rij, rik, _), slot, mask = seeded_rows(rng, 5, 7, 2, 3.5, triples=True)
    sf = JaxSF(["Mo", "Ni"], beta=[0.005, 0.05], gamma=[1.0, -1.0],
               zeta=[1.0, 4.0])
    spec = (sf.angular_grid, 3.5, "cosine", 2)
    rest = [torch.as_tensor(slot), torch.as_tensor(mask)]
    results = []
    for fn in (fused.G4Function.apply, fused.g4_reference):
        a = torch.as_tensor(rij).requires_grad_()
        b = torch.as_tensor(rik).requires_grad_()
        c = torch.sqrt(a * a + b * b - 0.7 * a * b + 1e-3)
        y = fn(a, b, c, *rest, *spec)
        ga, gb = torch.autograd.grad(y.sum(), (a, b), create_graph=True)
        second = torch.autograd.grad((ga * ga).sum() + gb.sum(), (a, b))
        results.append((ga.detach(), gb.detach(), *second))
    for got, want in zip(*results):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                                   atol=1e-12)
    # GRAP through its VJP Function: the unit vector computed from the
    # distance (ux = vx / rij)
    rng = np.random.RandomState(24)
    (r0,), slot, mask = seeded_rows(rng, 5, 9, 2, 4.5)
    vec = rng.normal(size=(3, *r0.shape)) * mask
    desc = GenericRadialAtomicPotential(
        ["Mo", "Ni"], algorithm="pexp", backend="dense",
        parameters={"rl": [1.0, 2.0, 3.0], "pl": [4.0, 3.0, 2.0]},
        moment_tensors=[0, 1, 2, 3])
    rest = [torch.as_tensor(slot), torch.as_tensor(mask)]
    results = []
    for fn in (fused.GrapFunction.apply, fused.grap_reference):
        vs = [torch.as_tensor(v).requires_grad_() for v in vec]
        r = torch.sqrt(sum(v * v for v in vs) + (1.0 - torch.as_tensor(
            mask)))
        y = fn(r, *(v / r for v in vs), *rest, desc, 4.5, 2)
        grads = torch.autograd.grad(y.sum(), vs, create_graph=True)
        second = torch.autograd.grad(sum((g * g).sum() for g in grads), vs)
        results.append((*(g.detach() for g in grads), *second))
    for got, want in zip(*results):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                                   atol=1e-12)
