"""Second order of the port's G2 and G4 kernels: the closed forms of the
VJP's own VJP (`g2_vjp_bwd_reference`, `g4_vjp_bwd_reference`, the plain
versions of the second-order kernels) against JAX's second derivatives of
`_g2_ref_dense` / `_g4_ref_dense` and of the interpret-mode custom-VJP op
at float64, 1e-10 of the largest value, over every cutoff, zeta 1, 2, 4
and 2.5, |gamma| = 2 (the clamp active), masked tails of zero distances,
an empty row, holes and interleaved slots; the cutoffs' curvature
against double autograd, and at every knot against JAX's; the routing
of the Functions' backward by derivative order, for G2, G4 and GRAP (a
`create_graph` backward through the VJP Function, its backward through
the second-order wrapper with the geometry term only where the backward
uses it, third order through the twin, matching JAX's third
derivative). G4's closed form against JAX is in
tests/test_torch_second_order_g4.py and one snap_ni_sfa train step at
full width against the JAX trainer's fixture through that route in
tests/test_torch_second_order_train.py (files of their own, so that the
test runner's workers share them), GRAP's closed form against JAX in
tests/test_torch_grap_second_order*.py.

On the CPU the wrappers take the closed forms:
`python -m pytest tests/test_torch_second_order.py -q`.
"""
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoralloy_tpu.nn.grap import \
    GenericRadialAtomicPotential as JaxGRAP
from tensoralloy_tpu.nn.sf import SymmetryFunction as JaxSF
from tensoralloy_tpu.ops import cutoffs as jax_cutoffs
from tensoralloy_tpu.ops import fused as jax_fused
from tensoralloy_tpu_torch.nn.grap import GenericRadialAtomicPotential
from tensoralloy_tpu_torch.ops import cutoffs, fused

from test_torch_ops import seeded_rows

DATA = Path(__file__).resolve().parent / "data"
CUTOFFS = sorted(cutoffs.CUTOFFS)
# G4 grids (beta, gamma, zeta): |gamma| = 2 puts 1 + gamma cos(theta) at
# the clamp on many triples; zeta 1, 2, 4 by multiplies, 2.5 by pow
G4_GRIDS = {"clamp": dict(beta=[0.005, 0.05], gamma=[2.0, -2.0],
                          zeta=[1.0, 2.0, 4.0]),
            "zeta2.5": dict(beta=[0.01], gamma=[1.0, -2.0], zeta=[2.5])}


def _close(got, want, what=""):
    """`got` against `want` to 1e-10 of the largest |want|, both finite
    (`want`'s non-finite entries left out where it has any: JAX's second
    derivative of max(1 + gamma cos, 0)^1 at the clamp is 0 * inf)."""
    got, want = np.asarray(got), np.asarray(want)
    finite = np.isfinite(want)
    scale = max(np.abs(want[finite]).max(), 1e-300)
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-10,
                               atol=1e-10 * scale, err_msg=what)


def _rows(kind, holes, seed):
    """Seeded rows (masked tails of zero distances, row 0 empty); with
    `holes` each row's entries shuffled (interleaved slots) and about a
    third of the real ones masked, keeping their finite geometry. GRAP's
    rows are (rij, ux, uy, uz) with unit vectors on the real entries."""
    rng = np.random.RandomState(seed)
    if kind == "g2":
        diff, slot, mask = seeded_rows(rng, 7, 13, 3, 4.5)
    elif kind == "grap":
        (rij,), slot, mask = seeded_rows(rng, 6, 9, 2, 4.5)
        unit = rng.normal(size=(3, *rij.shape))
        unit /= np.linalg.norm(unit, axis=0)
        diff = [rij, *(unit * mask)]
    else:
        diff, slot, mask = seeded_rows(rng, 9, 11, 3, 3.5, triples=True)
    if holes:
        perm = np.argsort(rng.uniform(size=mask.shape), axis=1)
        diff, slot, mask = ([np.take_along_axis(d, perm, 1) for d in diff],
                            *(np.take_along_axis(x, perm, 1)
                              for x in (slot, mask)))
        mask = mask * (rng.uniform(size=mask.shape) < 0.65)
        assert ((mask == 0) & (diff[0] > 0)).any()
    return diff, slot, mask


def _case(kind, cutoff, grid="clamp"):
    """-> (JAX reference, JAX custom-VJP op, the port's spec)."""
    if kind == "grap":
        kw = dict(algorithm="pexp", cutoff_function=cutoff,
                  parameters={"rl": [1.0, 2.0, 3.0], "pl": [4.0, 3.0, 2.0]},
                  moment_tensors=[0, 1, 2, 3])
        jdesc = JaxGRAP(["Mo", "Ni"], backend="pallas", **kw)
        ref = functools.partial(jax_fused._grap_ref_dense, jdesc, 4.5, 2)
        op = jax_fused._custom_vjp_op(
            functools.partial(jax_fused._grap_pallas, jdesc, 4.5, 2), ref, 4)
        return ref, op, (GenericRadialAtomicPotential(
            ["Mo", "Ni"], backend="dense", **kw), 4.5, 2)
    if kind == "g2":
        sf = JaxSF(["Mo", "Ni"], eta=[0.05, 0.5, 4.0], omega=[0.0, 1.0],
                   cutoff_function=cutoff, backend="pallas")
        ref = functools.partial(jax_fused._g2_ref_dense, sf, 4.5, 3)
        op = jax_fused._custom_vjp_op(
            functools.partial(jax_fused._g2_pallas, sf, 4.5, 3), ref, 1)
        return ref, op, (sf.radial_grid, 4.5, cutoff, 3)
    sf = JaxSF(["Mo", "Ni"], cutoff_function=cutoff, backend="pallas",
               **G4_GRIDS[grid])
    ref = functools.partial(jax_fused._g4_ref_dense, sf, 3.5, 3)
    op = jax_fused._custom_vjp_op(
        functools.partial(jax_fused._g4_pallas, sf, 3.5, 3), ref, 3)
    return ref, op, (sf.angular_grid, 3.5, cutoff, 3)


def _jax_second(ref, op, diff, rest, gbar, vs):
    """JAX's (d s/d gbar, d s/d diff) of s = sum <v, VJP(diff; gbar)>:
    w.r.t. gbar through the custom-VJP op (what a force loss
    differentiates) and through the reference, which must agree, w.r.t.
    the distances through the reference; each derivative compiled by
    `jax.jit` (a tenth less CPU over the second-order files than op by
    op)."""
    j_rest = [jnp.asarray(x) for x in rest]

    def scalar(fn, xs, gb):
        _, vjp = jax.vjp(lambda *d: fn(*d, *j_rest), *xs)
        grads = vjp(gb)[:len(xs)]
        return sum(jnp.vdot(jnp.asarray(v), g) for v, g in zip(vs, grads))

    xs = tuple(jnp.asarray(d) for d in diff)
    via_op = jax.jit(jax.grad(functools.partial(scalar, op), argnums=1))(
        xs, jnp.asarray(gbar))
    want_x, want_gbar = jax.jit(jax.grad(functools.partial(scalar, ref),
                                         argnums=(0, 1)))(
        xs, jnp.asarray(gbar))
    _close(via_op, want_gbar, "the op's and the reference's d/dgbar")
    return np.asarray(want_gbar), [np.asarray(w) for w in want_x]


def _check_closed_form(kind, cutoff, holes, grid="clamp"):
    diff, slot, mask = _rows(kind, holes, seed=31 if kind == "g2" else 32)
    ref, op, spec = _case(kind, cutoff, grid)
    rest = [slot, mask]
    rng = np.random.RandomState(7)
    shape = ref(*(jnp.asarray(d) for d in diff),
                *(jnp.asarray(r) for r in rest)).shape
    gbar = rng.normal(size=shape)
    vs = [rng.normal(size=d.shape) for d in diff]
    want_gbar, want_x = _jax_second(ref, op, diff, rest, gbar, vs)
    t = torch.as_tensor
    got = getattr(fused, f"{kind}_vjp_bwd_reference")(
        tuple(t(v) for v in vs), t(gbar), *(t(d) for d in diff),
        *(t(r) for r in rest), *spec)
    # the port's twin by double autograd: finite where JAX's is not
    function = {"g2": fused.G2Function, "g4": fused.G4Function}[kind]
    x = [t(d).requires_grad_() for d in (gbar, *diff)]
    first = fused._twin_vjp_of(function)(*x, *(t(r) for r in rest), *spec)
    twin = torch.autograd.grad(first, x, tuple(t(v) for v in vs))
    assert np.abs(want_gbar).max() > 0
    assert len(got) == 1 + len(diff)
    assert np.isfinite(want_gbar).all()
    _close(got[0].numpy(), want_gbar, "gbar_bar")
    _close(got[0].numpy(), twin[0].numpy(), "gbar_bar vs the twin")
    for g, w, tw in zip(got[1:], want_x, twin[1:]):
        assert (g.numpy()[mask <= 0] == 0).all()
        _close(g.numpy(), w, "geometry term")
        _close(g.numpy(), tw.numpy(), "geometry term vs the twin")
        # JAX's non-finite entries: the clamp at zeta 1 only
        assert np.isfinite(w).all() or (kind, grid) == ("g4", "clamp")
    # the geometry term skipped: gbar_bar alone, the same
    flat = getattr(fused, f"{kind}_vjp_bwd_reference")(
        tuple(t(v) for v in vs), t(gbar), *(t(d) for d in diff),
        *(t(r) for r in rest), *spec, geometry=False)
    assert all(f is None for f in flat[1:])
    np.testing.assert_array_equal(flat[0].numpy(), got[0].numpy())
    return diff, mask


@pytest.mark.parametrize("holes", [False, True])
@pytest.mark.parametrize("cutoff", CUTOFFS)
def test_g2_closed_form_second_order_matches_jax(cutoff, holes):
    _check_closed_form("g2", cutoff, holes)


@pytest.mark.parametrize("name", CUTOFFS)
def test_cutoff_curvature_matches_double_autograd(name):
    """`cutoff_slope_and_curvature` against double autograd of the
    cutoff, past rc too (0 outside the open interval)."""
    r = torch.linspace(0.05, 7.0, 691, dtype=torch.float64,
                       requires_grad=True)
    f = cutoffs.apply_cutoff(name, r, 6.0)
    (slope,) = torch.autograd.grad(f.sum(), r, create_graph=True)
    (curv,) = torch.autograd.grad(slope.sum(), r)
    got = cutoffs.cutoff_slope_and_curvature(name, r.detach(), 6.0)
    np.testing.assert_array_equal(got[0].numpy(), f.detach().numpy())
    np.testing.assert_allclose(got[1].numpy(), slope.detach().numpy(),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got[2].numpy(), curv.numpy(), rtol=1e-12,
                               atol=1e-12)
    assert (got[2].numpy()[r.detach().numpy() > 6.0] == 0).all()


@pytest.mark.parametrize("name", CUTOFFS)
def test_cutoff_curvature_at_the_knots_matches_jax(name):
    """`cutoff_slope_and_curvature` at every knot of each cutoff (its
    ends: rc, 2/3 rc for deepmd, 0.8 rc for tersoff, 0 for meam), an ulp
    to each side and 1e-9 off, against JAX's `jax.grad(jax.grad(
    apply_cutoff))` in float64: a quarter of the clamp's curvature
    exactly at a knot (a tie of jnp.minimum / jnp.maximum passes half
    the gradient), deepmd's 1/r part whole. The slope, continuous at the
    knots, against JAX's too; the value exactly."""
    for rc in (3.5, 4.0, 4.5, 6.0):
        knots = {"deepmd": [2.0 / 3.0 * rc, rc], "meam": [0.0, rc],
                 "tersoff": [0.8 * rc, (rc - 0.1 * rc) - 0.1 * rc, rc]
                 }.get(name, [rc])
        r = np.array([x for k in knots for x in (
            np.nextafter(k, -np.inf), k, np.nextafter(k, np.inf),
            k - 1e-9, k + 1e-9)])
        f = lambda x: jax_cutoffs.apply_cutoff(name, x, rc)  # noqa: E731
        want_f = np.asarray(f(jnp.asarray(r)))
        want_s, want_c = (np.asarray(jax.vmap(g)(jnp.asarray(r))) for g in
                          (jax.grad(f), jax.grad(jax.grad(f))))
        got = [x.numpy() for x in cutoffs.cutoff_slope_and_curvature(
            name, torch.as_tensor(r), rc)]
        np.testing.assert_allclose(got[0], want_f, rtol=1e-15, atol=1e-15)
        np.testing.assert_allclose(got[1], want_s, rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(got[2], want_c, rtol=1e-12, atol=1e-12)
        exact = r == np.repeat(knots, 5)
        assert (got[2][exact] != 0).any() or name == "tersoff"


# ----------------------------------------------------------------------
# Routing by derivative order
# ----------------------------------------------------------------------

FUNCTIONS = {"g2": (fused.G2Function, fused.G2VjpFunction),
             "g4": (fused.G4Function, fused.G4VjpFunction),
             "grap": (fused.GrapFunction, fused.GrapVjpFunction)}


@pytest.fixture
def counted(monkeypatch):
    """The calls of each VJP wrapper (its cotangent batch) and of each
    second-order wrapper (whether it computed the geometry term)."""
    calls = {"vjp": [], "bwd": []}
    for function, vjp_function in FUNCTIONS.values():
        first, second = function.kernel_vjp, vjp_function.kernel_bwd

        def vjp(gbar, *args, _first=first):
            calls["vjp"].append(gbar.shape[0])
            return _first(gbar, *args)

        def bwd(*args, geometry=True, _second=second):
            calls["bwd"].append(geometry)
            return _second(*args, geometry=geometry)

        monkeypatch.setattr(function, "kernel_vjp", vjp)
        monkeypatch.setattr(vjp_function, "kernel_bwd", bwd)
    return calls


def _inputs(kind):
    _, _, spec = _case(kind, "cosine")
    diff, slot, mask = _rows(kind, False, seed=33)
    return ([torch.as_tensor(d) for d in diff],
            [torch.as_tensor(slot), torch.as_tensor(mask)], spec)


@pytest.mark.parametrize("kind", ["g2", "g4", "grap"])
def test_create_graph_backward_takes_the_vjp_function(kind, counted):
    """A `create_graph` backward of the kernel Function calls the VJP
    wrapper once and leaves the VJP Function in the graph; a backward
    through it calls the second-order wrapper once, with the geometry
    term (the distances are asked for); both equal the all-twin path."""
    function, vjp_function = FUNCTIONS[kind]
    diff, rest, spec = _inputs(kind)
    rng = np.random.RandomState(8)
    results = []
    for fn in (function.apply, function.twin):
        x = [d.clone().requires_grad_() for d in diff]
        y = fn(*x, *rest, *spec)
        gbar = torch.as_tensor(rng.normal(size=y.shape)).requires_grad_()
        grads = torch.autograd.grad(y, x, gbar, create_graph=True)
        if fn is function.twin:
            assert counted == {"vjp": [1], "bwd": [True]}
        else:
            assert counted == {"vjp": [1], "bwd": []}
            assert type(grads[0].grad_fn).__name__ == \
                f"{vjp_function.__name__}Backward"
        us = [torch.as_tensor(rng.normal(size=d.shape)) for d in diff]
        s = sum((u * g).sum() for u, g in zip(us, grads))
        results.append(torch.autograd.grad(s, [gbar] + x))
        rng = np.random.RandomState(8)
    for got, want in zip(*results):
        _close(got.numpy(), want.numpy())


@pytest.mark.parametrize("kind", ["g2", "g4", "grap"])
def test_loss_backward_skips_the_geometry(kind, counted):
    """A force-loss-like backward that asks for a parameter only skips
    the geometry term (the distances' node does not run); asking for the
    positions computes it. Both against the all-twin path."""
    function, _ = FUNCTIONS[kind]
    diff, rest, spec = _inputs(kind)
    got = {}
    for path, fn in (("kernels", function.apply), ("twins", function.twin)):
        w = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
        base = [d.clone().requires_grad_() for d in diff]
        x = [b * 1.0 for b in base]     # distances computed from "positions"
        y = fn(*x, *rest, *spec)
        energy = (w * torch.tanh(y)).sum() + (w * y * y).sum()
        forces = torch.autograd.grad(energy, base, create_graph=True)
        loss = sum((f * f).sum() for f in forces)
        before = list(counted["bwd"])
        (g_w,) = torch.autograd.grad(loss, w, retain_graph=True)
        g_base = torch.autograd.grad(loss, base)
        if path == "kernels":
            assert counted["bwd"][len(before):] == [False, True]
        got[path] = [g_w, *g_base]
    for a, b in zip(got["kernels"], got["twins"]):
        _close(a.numpy(), b.numpy())


@pytest.mark.parametrize("kind", ["g2", "g4", "grap"])
def test_third_order_takes_the_twin_and_matches_jax(kind, counted):
    """s = sum <u, VJP(x; gbar)>, q = <p, ds/dx> + <h, ds/dgbar>: dq/dx
    and dq/dgbar (third derivatives of the descriptor) through the
    Functions take the twin in the second-order backward (no second-order
    wrapper call) and equal JAX's `jax.grad` of `jax.grad` of `jax.vjp`
    of the reference, 1e-10."""
    diff, rest, spec = _inputs(kind)
    function, _ = FUNCTIONS[kind]
    ref, _, _ = _case(kind, "cosine")
    rng = np.random.RandomState(9)
    np_diff = [d.numpy() for d in diff]
    shape = function.twin(*diff, *rest, *spec).shape
    gbar = rng.normal(size=shape)
    us = [rng.normal(size=d.shape) for d in np_diff]
    ps = [rng.normal(size=d.shape) for d in np_diff]
    h = rng.normal(size=shape)
    j_rest = [jnp.asarray(r.numpy()) for r in rest]

    def s_of(xs, gb):
        _, vjp = jax.vjp(lambda *d: ref(*d, *j_rest), *xs)
        return sum(jnp.vdot(jnp.asarray(u), g)
                   for u, g in zip(us, vjp(gb)))

    def q_of(xs, gb):
        ds_dx, ds_dg = jax.grad(s_of, argnums=(0, 1))(xs, gb)
        return (sum(jnp.vdot(jnp.asarray(p), g) for p, g in zip(ps, ds_dx))
                + jnp.vdot(jnp.asarray(h), ds_dg))

    want_x, want_g = jax.grad(q_of, argnums=(0, 1))(
        tuple(jnp.asarray(d) for d in np_diff), jnp.asarray(gbar))

    x = [d.clone().requires_grad_() for d in diff]
    gb = torch.as_tensor(gbar).requires_grad_()
    y = function.apply(*x, *rest, *spec)
    grads = torch.autograd.grad(y, x, gb, create_graph=True)
    s = sum((torch.as_tensor(u) * g).sum() for u, g in zip(us, grads))
    ds_dg, *ds_dx = torch.autograd.grad(s, [gb] + x, create_graph=True)
    q = (sum((torch.as_tensor(p) * g).sum() for p, g in zip(ps, ds_dx))
         + (torch.as_tensor(h) * ds_dg).sum())
    got_g, *got_x = torch.autograd.grad(q, [gb] + x)
    assert counted == {"vjp": [1], "bwd": []}
    _close(got_g.numpy(), np.asarray(want_g), "d3/dgbar")
    for g, w in zip(got_x, want_x):
        _close(g.numpy(), np.asarray(w), "d3/dx")


@pytest.mark.parametrize("kind", ["g2", "g4", "grap"])
def test_batched_cotangent_of_the_vjp(kind):
    """A cotangent of the VJP Function batched by `is_grads_batched`: on
    the CPU the twin route takes it, row for row the unbatched
    backward; on a device tensor the backward raises."""
    function, vjp_function = FUNCTIONS[kind]
    diff, rest, spec = _inputs(kind)
    x = [d.clone().requires_grad_() for d in diff]
    y = function.twin(*diff, *rest, *spec)
    gbar = torch.as_tensor(np.random.RandomState(10).normal(size=y.shape))
    gbar.requires_grad_()
    out = vjp_function.apply(gbar, *x, *rest, *spec)
    out = out if isinstance(out, tuple) else (out,)
    eye = torch.eye(out[0].numel(), dtype=torch.float64)[:3].reshape(
        3, *out[0].shape)
    v = tuple(eye if i == 0 else torch.zeros_like(eye)
              for i in range(len(out)))
    batched = torch.autograd.grad(out, [gbar] + x, v, retain_graph=True,
                                  is_grads_batched=True)
    for b in range(3):
        one = torch.autograd.grad(out, [gbar] + x, [t[b] for t in v],
                                  retain_graph=True)
        for got, want in zip(batched, one):
            _close(got[b].numpy(), want.numpy())

    def fake_backward(g):
        fake = type("Ctx", (), {
            "saved_tensors": (gbar.detach().to("meta"),
                              *(d.to("meta") for d in diff),
                              *(r.to("meta") for r in rest)),
            "needs_input_grad": (True,) * (1 + len(diff)),
            "spec": spec})()
        return fused._vjp_backward(vjp_function, fake, (g,) * len(out))

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t * 1.0

        @staticmethod
        def backward(ctx, g):
            return fake_backward(g)[1]

    t = torch.zeros(out[0].shape, dtype=torch.float64, requires_grad=True)
    with pytest.raises(RuntimeError, match="is_grads_batched"):
        torch.autograd.grad(Probe.apply(t), t, eye, is_grads_batched=True)
