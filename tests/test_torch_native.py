"""The port's native C++ host lists against its numpy path and against
the JAX package's featurizer: integer arrays exactly, floats to 1e-12,
the feature dict key by key (the dense columns, transpose tables and
image codes all depend on the order of the pairs and triples)."""
import numpy as np
import pytest

from tensoralloy_tpu.atoms import Structure as JaxStructure
from tensoralloy_tpu.neighbor import neighbor_list as jax_neighbor_list
from tensoralloy_tpu.transform import Featurizer as JaxFeaturizer
from tensoralloy_tpu_torch import native
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.neighbor import neighbor_list
from tensoralloy_tpu_torch.transform import Featurizer

A0 = 3.52


def _fcc(reps, jitter, seed=0):
    basis = np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
    grid = np.array([(i, j, k) for i in range(reps) for j in range(reps)
                     for k in range(reps)])
    pos = ((grid[:, None, :] + basis[None]) * A0).reshape(-1, 3)
    if jitter:
        pos = pos + np.random.RandomState(seed).normal(0, jitter, pos.shape)
    return pos, np.eye(3) * A0 * reps


def ni108():
    pos, cell = _fcc(3, 0.05)
    return ["Ni"] * len(pos), pos, cell, [True] * 3


def skewed():
    pos, cell = _fcc(2, 0.05, seed=1)
    skew = np.array([[1.0, 0.0, 0.0], [0.35, 1.0, 0.0], [-0.2, 0.3, 1.0]])
    return ["Ni"] * len(pos), pos @ skew, cell @ skew, [True] * 3


def fcc_on_shell():
    """Perfect lattice: with rcut = a the second shell lies on the cutoff
    and a * a is the exact square of both sides, so every path leaves it
    out."""
    pos, cell = _fcc(3, 0.0)
    return ["Ni"] * len(pos), pos, cell, [True] * 3


def slab():
    pos, cell = _fcc(2, 0.05, seed=2)
    cell = cell.copy()
    cell[2, 2] += 12.0
    return ["Ni"] * len(pos), pos, cell, [True, True, False]


def moni():
    rng = np.random.RandomState(3)
    pos, cell = _fcc(2, 0.05, seed=3)
    symbols = np.where(rng.rand(len(pos)) < 0.3, "Mo", "Ni").tolist()
    return symbols, pos, cell, [True] * 3


def unwrapped():
    """Positions that left the home cell, as an MD trajectory has them."""
    pos, cell = _fcc(2, 0.05, seed=4)
    rng = np.random.RandomState(4)
    pos = pos + rng.randint(-2, 3, pos.shape) @ cell
    return ["Ni"] * len(pos), pos, cell, [True] * 3


CELLS = {
    "ni108": (ni108, ["Ni"], dict(rcut=6.0, acut=4.0)),
    "skewed": (skewed, ["Ni"], dict(rcut=5.0, acut=4.0)),
    "fcc_on_shell": (fcc_on_shell, ["Ni"], dict(rcut=A0, acut=A0)),
    "slab": (slab, ["Ni"], dict(rcut=5.0, acut=4.0)),
    "moni": (moni, ["Mo", "Ni"], dict(rcut=4.5, acut=4.5)),
    "unwrapped": (unwrapped, ["Ni"], dict(rcut=5.0, acut=4.0)),
}


def _assert_same(out, ref, what):
    assert sorted(out) == sorted(ref)
    for key, want in ref.items():
        got = np.asarray(out[key])
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, (what,
                                                                     key)
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=f"{what} {key}")
        else:
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12,
                                       err_msg=f"{what} {key}")


def test_library_builds_under_the_ports_build_directory():
    lib = native.get_lib()
    assert lib is not None, "g++ is in this image: the library must build"
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "tensoralloy_tpu_torch"
    # the JAX package's library is another file
    assert "tensoralloy_tpu/native" not in lib._name


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_neighbor_lists_native_numpy_jax(cell, monkeypatch):
    build, _, kw = CELLS[cell]
    symbols, pos, box, pbc = build()
    s = Structure.from_symbols(symbols, pos, box, pbc=pbc)
    js = JaxStructure.from_symbols(symbols, pos, box, pbc=pbc)
    names = ("ilist", "jlist", "shift", "dist", "vec")
    nat = dict(zip(names, neighbor_list(s, kw["rcut"])))
    plain = dict(zip(names, neighbor_list(s, kw["rcut"],
                                          use_native=False)))
    ref = dict(zip(names, jax_neighbor_list(js, kw["rcut"])))
    assert len(nat["ilist"]) > 0
    _assert_same(nat, plain, "native vs numpy")
    _assert_same(nat, ref, "native vs jax")
    # sorted by (i, j, shift)
    order = np.lexsort((nat["shift"][:, 2], nat["shift"][:, 1],
                        nat["shift"][:, 0], nat["jlist"], nat["ilist"]))
    np.testing.assert_array_equal(order, np.arange(len(order)))
    # the environment switch selects the numpy path
    monkeypatch.setenv("TENSORALLOY_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "native_neighbor_list", None)
    _assert_same(dict(zip(names, neighbor_list(s, kw["rcut"]))), plain,
                 "switch")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_feature_dicts_native_numpy_jax(cell, monkeypatch):
    build, elements, kw = CELLS[cell]
    symbols, pos, box, pbc = build()
    s = Structure.from_symbols(symbols, pos, box, pbc=pbc)
    js = JaxStructure.from_symbols(symbols, pos, box, pbc=pbc)
    fz = Featurizer(elements, angular=True, **kw)
    jax_fz = JaxFeaturizer(elements, angular=True, **kw)
    nat = fz.featurize(s, fz.make_vap(s), transpose=True)
    ref = jax_fz.featurize(js, jax_fz.make_vap(js), layout="dense",
                           transpose=True)
    assert nat["trip_mask_d"].sum() > 0
    _assert_same(nat, ref, "native vs jax")
    monkeypatch.setenv("TENSORALLOY_TPU_NO_NATIVE", "1")
    # the switch must keep both native calls out
    monkeypatch.setattr(native, "native_neighbor_list", None)
    monkeypatch.setattr(native, "native_triple_list", None)
    plain = fz.featurize(s, fz.make_vap(s), transpose=True)
    _assert_same(nat, plain, "native vs numpy")


def test_pair_on_an_irrational_shell_may_fall_on_either_side():
    """rcut = a * sqrt(2) lies on the fourth shell, and its square is
    rounded: the C++ list compares squares and scipy compares roots, so
    the two paths may differ, as in the JAX package, but only by pairs
    at the cutoff itself (where every cutoff function is zero). Each
    path equals the JAX package's same path."""
    symbols, pos, box, pbc = fcc_on_shell()
    rcut = A0 * np.sqrt(2.0)
    s = Structure.from_symbols(symbols, pos, box, pbc=pbc)
    js = JaxStructure.from_symbols(symbols, pos, box, pbc=pbc)
    nat = neighbor_list(s, rcut)
    plain = neighbor_list(s, rcut, use_native=False)
    for got, want in ((nat, jax_neighbor_list(js, rcut)),
                      (plain, jax_neighbor_list(js, rcut,
                                                use_native=False))):
        assert len(got[0]) == len(want[0])
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(got[3], want[3], rtol=1e-12)

    def pairs(lst, inside):
        keep = lst[3] < rcut * (1 - 1e-12) if inside else np.ones(
            len(lst[3]), bool)
        return set(zip(lst[0][keep].tolist(), lst[1][keep].tolist(),
                       map(tuple, lst[2][keep].tolist())))

    assert pairs(nat, True) == pairs(plain, True)
    extra = pairs(nat, False) ^ pairs(plain, False)
    on_shell = np.concatenate([lst[3][lst[3] >= rcut * (1 - 1e-12)]
                               for lst in (nat, plain)])
    assert len(extra) <= len(on_shell)
    np.testing.assert_allclose(on_shell, rcut, rtol=1e-12)


def test_triples_keep_the_triu_order():
    """(p, q) per centre in the order of `np.triu_indices`."""
    ilist = np.repeat(np.arange(5), [3, 0, 1, 4, 2]).astype(np.int32)
    p, q = native.native_triple_list(ilist, 5)
    want_p, want_q = [], []
    lo = 0
    for m in (3, 0, 1, 4, 2):
        a, b = np.triu_indices(m, k=1)
        want_p.append(lo + a)
        want_q.append(lo + b)
        lo += m
    np.testing.assert_array_equal(p, np.concatenate(want_p))
    np.testing.assert_array_equal(q, np.concatenate(want_q))
