"""The closed-form VJPs of the port's descriptor kernels (`g2_vjp_reference`,
`g4_vjp_reference`, `grap_vjp_reference`, the plain versions of the VJP
kernels) against `jax.vjp` of the JAX custom-VJP ops (Pallas forward in
interpret mode) at float64, 1e-10 relative and 1e-12 absolute, on seeded
rows with masked tails of zero distances and an empty first row; the
routing of the Functions' backward by derivative order; the recorded
calls and the batched VJP split at the descriptors; and the committee's
two routes and the linear model's Jacobian rows through it against the
JAX package, 1e-10."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoralloy_tpu.ensemble import EnsembleCalculator as JaxEnsemble
from tensoralloy_tpu.linear.model import LinearTensorMD as JaxLinear
from tensoralloy_tpu.nn.grap import \
    GenericRadialAtomicPotential as JaxGRAP
from tensoralloy_tpu.nn.sf import SymmetryFunction as JaxSF
from tensoralloy_tpu.ops import fused as jax_fused
from tensoralloy_tpu_torch.ensemble import EnsembleCalculator
from tensoralloy_tpu_torch.linear.model import LinearTensorMD
from tensoralloy_tpu_torch.nn.grap import GenericRadialAtomicPotential
from tensoralloy_tpu_torch.ops import cutoffs, fused

from test_torch_ensemble import NI_MEMBERS, jittered_ni
from test_torch_grap import PARAMS
from test_torch_linear import labelled_structures
from test_torch_ops import seeded_rows

TOL = dict(rtol=1e-10, atol=1e-12)
BATCH = 3


def _jax_vjps(op, diff, rest, gbars):
    """[jax.vjp of `op` w.r.t. `diff` along each cotangent] stacked:
    a list of [B, ...] arrays, one a differentiable input."""
    j_rest = [jnp.asarray(x) for x in rest]
    _, vjp = jax.vjp(lambda *d: op(*d, *j_rest),
                     *(jnp.asarray(d) for d in diff))
    per_b = [vjp(jnp.asarray(g))[:len(diff)] for g in gbars]
    return [np.stack([np.asarray(p[i]) for p in per_b])
            for i in range(len(diff))]


def _check_closed_form(closed, op, diff, rest, spec, seed, batch=BATCH):
    """The closed form at B = `batch` against jax.vjp per cotangent,
    masked entries exactly 0, every value finite, and B = `batch` equal
    to as many B = 1 calls."""
    rng = np.random.RandomState(seed)
    shape = op(*(jnp.asarray(d) for d in diff),
               *(jnp.asarray(r) for r in rest)).shape
    gbars = rng.normal(size=(batch, *shape))
    want = _jax_vjps(op, diff, rest, gbars)
    t_args = [torch.as_tensor(x) for x in (*diff, *rest)]
    got = closed(torch.as_tensor(gbars), *t_args, *spec)
    mask = rest[-1]
    assert len(got) == len(diff)
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == (batch, *mask.shape)
        assert np.isfinite(g).all()
        assert (g[:, mask <= 0] == 0).all()
        np.testing.assert_allclose(g, w, **TOL)
    assert np.abs(want[0]).max() > 0
    for b in range(batch):
        one = closed(torch.as_tensor(gbars[b:b + 1]), *t_args, *spec)
        for g, o in zip(got, one):
            np.testing.assert_array_equal(o[0].numpy(), g[b].numpy())


@pytest.mark.parametrize("cutoff", ["cosine", "polynomial"])
def test_g2_closed_form_matches_jax_vjp(cutoff):
    rng = np.random.RandomState(41)
    diff, slot, mask = seeded_rows(rng, 7, 30, 2, 4.5)
    sf = JaxSF(["Mo", "Ni"], eta=[0.05, 0.5, 4.0], omega=[0.0, 1.0],
               cutoff_function=cutoff, backend="pallas")
    ref = functools.partial(jax_fused._g2_ref_dense, sf, 4.5, 2)
    op = jax_fused._custom_vjp_op(
        functools.partial(jax_fused._g2_pallas, sf, 4.5, 2), ref, 1)
    _check_closed_form(fused.g2_vjp_reference, op, diff, [slot, mask],
                       (sf.radial_grid, 4.5, cutoff, 2), seed=1)


@pytest.mark.parametrize("cutoff", ["cosine", "polynomial"])
@pytest.mark.parametrize("zeta", [[1.0], [2.0], [4.0], [1.0, 2.0, 4.0]])
def test_g4_closed_form_matches_jax_vjp(cutoff, zeta):
    """|gamma| = 2: the clamp of 1 + gamma cos(theta) at 0 is active on
    many triples."""
    rng = np.random.RandomState(42)
    diff, slot, mask = seeded_rows(rng, 12, 11, 3, 3.5, triples=True)
    cos = (diff[0] ** 2 + diff[1] ** 2 - diff[2] ** 2) / np.where(
        mask > 0, 2 * diff[0] * diff[1], 1.0)
    assert ((1.0 - 2.0 * cos < 0) & (mask > 0)).sum() > 5
    sf = JaxSF(["Mo", "Ni"], beta=[0.005, 0.05], gamma=[2.0, -2.0],
               zeta=zeta, cutoff_function=cutoff, backend="pallas")
    ref = functools.partial(jax_fused._g4_ref_dense, sf, 3.5, 3)
    op = jax_fused._custom_vjp_op(
        functools.partial(jax_fused._g4_pallas, sf, 3.5, 3), ref, 3)
    _check_closed_form(fused.g4_vjp_reference, op, diff, [slot, mask],
                       (sf.angular_grid, 3.5, cutoff, 3), seed=2)


def _unit_rows(rng, rows, n, n_slots, rc):
    (rij,), slot, mask = seeded_rows(rng, rows, n, n_slots, rc)
    unit = rng.normal(size=(3, rows, n))
    unit /= np.linalg.norm(unit, axis=0)
    return [rij, *(unit * mask)], slot, mask


@pytest.mark.parametrize("algorithm,moments,symmetric", [
    ("sf", [0, 1, 2, 3], False), ("density", [0, 1, 2, 3], True),
    ("morse", [0, 1, 2, 3], False), ("pexp", [0, 2, 5], False),
    ("pexp", [0, 1, 2, 3], True), ("morse", [1, 3], True)])
@pytest.mark.parametrize("cutoff", ["cosine", "polynomial"])
def test_grap_closed_form_matches_jax_vjp(algorithm, moments, symmetric,
                                          cutoff):
    """Every grid algorithm, moments with gaps and without moment 0,
    symmetric weights; the empty first row has P_0 = 0 exactly."""
    rng = np.random.RandomState(43)
    diff, slot, mask = _unit_rows(rng, 6, 9, 2, 4.5)
    kw = dict(algorithm=algorithm, parameters=PARAMS[algorithm],
              moment_tensors=moments, symmetric=symmetric,
              cutoff_function=cutoff)
    jdesc = JaxGRAP(["Mo", "Ni"], backend="pallas", **kw)
    desc = GenericRadialAtomicPotential(["Mo", "Ni"], backend="dense", **kw)
    ref = functools.partial(jax_fused._grap_ref_dense, jdesc, 4.5, 2)
    op = jax_fused._custom_vjp_op(
        functools.partial(jax_fused._grap_pallas, jdesc, 4.5, 2), ref, 4)
    _check_closed_form(fused.grap_vjp_reference, op, diff, [slot, mask],
                       (desc, 4.5, 2), seed=3)


LAYOUTS = ("holes", "interleaved", "long")


def _laid_out(rng, layout, rows, n, n_slots, rc, triples=False):
    """Seeded rows (`seeded_rows`) in a layout the compacting VJP kernels
    must meet, which fixes the semantics they are held to: 'holes' masks
    about a third of the real entries, so masked entries (with their
    distances left in place) lie between real ones; 'interleaved' gives
    entry j the slot j mod n_slots, so the slots alternate along each
    row; 'long' makes row 1 all real entries of slot 0, more than two
    batches of 32 pairs of one slot."""
    diff, slot, mask = seeded_rows(rng, rows, n, n_slots, rc,
                                   triples=triples)
    if layout == "holes":
        mask = mask * (rng.uniform(size=mask.shape) < 0.65)
        assert ((mask[:, :-1] == 0) & (mask[:, 1:] > 0)).any()
    elif layout == "interleaved":
        slot = np.broadcast_to(np.arange(n) % n_slots,
                               mask.shape).astype(np.float64)
    else:
        assert n > 64
        full, _, _ = seeded_rows(rng, 2, n, 1, rc, triples=triples)
        while not (full[0][1] > 0).all():   # a row of n real entries
            full, _, _ = seeded_rows(rng, 2, n, 1, rc, triples=triples)
        for d, f in zip(diff, full):
            d[1] = f[1]
        mask[1], slot[1] = 1.0, 0.0
    return diff, np.ascontiguousarray(slot), mask


@pytest.mark.parametrize("layout", LAYOUTS)
def test_g4_closed_form_on_row_layouts(layout):
    """`g4_vjp_reference` against jax.vjp at B = 8 on rows with holes,
    interleaved slots, or a long row of one slot; |gamma| = 2 (the
    clamp active), integer and non-integer zeta."""
    rng = np.random.RandomState(45)
    diff, slot, mask = _laid_out(rng, layout, 5, 72, 3, 3.5, triples=True)
    sf = JaxSF(["Mo", "Ni"], beta=[0.005, 0.05], gamma=[2.0, -1.0],
               zeta=[1.0, 2.5, 4.0], backend="pallas")
    ref = functools.partial(jax_fused._g4_ref_dense, sf, 3.5, 3)
    op = jax_fused._custom_vjp_op(
        functools.partial(jax_fused._g4_pallas, sf, 3.5, 3), ref, 3)
    _check_closed_form(fused.g4_vjp_reference, op, diff, [slot, mask],
                       (sf.angular_grid, 3.5, "cosine", 3), seed=6,
                       batch=8)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_grap_closed_form_on_row_layouts(layout):
    """`grap_vjp_reference` against jax.vjp at B = 8 on rows with holes,
    interleaved slots, or a long row of one slot, for the served
    pexp bank's algorithm at moments with gaps up to 5."""
    rng = np.random.RandomState(46)
    (rij,), slot, mask = _laid_out(rng, layout, 4, 72, 2, 4.5)
    unit = rng.normal(size=(3, *rij.shape))
    unit /= np.linalg.norm(unit, axis=0)
    diff = [rij, *(unit * (rij > 0))]
    kw = dict(algorithm="pexp", parameters=PARAMS["pexp"],
              moment_tensors=[0, 2, 5], cutoff_function="polynomial")
    jdesc = JaxGRAP(["Mo", "Ni"], backend="pallas", **kw)
    desc = GenericRadialAtomicPotential(["Mo", "Ni"], backend="dense", **kw)
    ref = functools.partial(jax_fused._grap_ref_dense, jdesc, 4.5, 2)
    op = jax_fused._custom_vjp_op(
        functools.partial(jax_fused._grap_pallas, jdesc, 4.5, 2), ref, 4)
    _check_closed_form(fused.grap_vjp_reference, op, diff, [slot, mask],
                       (desc, 4.5, 2), seed=7, batch=8)


@pytest.mark.parametrize("name", sorted(cutoffs.CUTOFFS))
def test_cutoff_slopes_match_autograd(name):
    """`cutoff_and_slope` against autograd of the cutoff, past rc too."""
    r = torch.linspace(0.05, 7.0, 691, dtype=torch.float64,
                       requires_grad=True)
    (want,) = torch.autograd.grad(cutoffs.apply_cutoff(name, r, 6.0).sum(),
                                  r)
    fc, slope = cutoffs.cutoff_and_slope(name, r.detach(), 6.0)
    np.testing.assert_array_equal(fc.numpy(),
                                  cutoffs.apply_cutoff(name, r, 6.0)
                                  .detach().numpy())
    np.testing.assert_allclose(slope.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-14)


# ----------------------------------------------------------------------
# Routing of the Functions' backward
# ----------------------------------------------------------------------

def _g2_case():
    rng = np.random.RandomState(44)
    (rij,), slot, mask = seeded_rows(rng, 6, 13, 2, 4.5)
    sf = JaxSF(["Mo", "Ni"], eta=[0.05, 0.5, 4.0], omega=[0.0, 1.0])
    spec = (sf.radial_grid, 4.5, "cosine", 2)
    return torch.as_tensor(rij), torch.as_tensor(slot), \
        torch.as_tensor(mask), spec


def test_first_order_backward_is_the_closed_form(monkeypatch):
    """With grad mode off the backward is the VJP wrapper (the closed
    form on CPU tensors), bit for bit, and keeps no graph; with
    `create_graph` it is the VJP wrapper again, inside the VJP Function
    (`G2VjpFunction`), which stays in the graph; the two agree bit for
    bit."""
    rij, slot, mask, spec = _g2_case()
    calls = []
    wrapper = fused.G2Function.kernel_vjp
    monkeypatch.setattr(fused.G2Function, "kernel_vjp",
                        lambda *a: calls.append(a[0].shape) or wrapper(*a))
    x = rij.clone().requires_grad_()
    y = fused.G2Function.apply(x, slot, mask, *spec)
    gbar = torch.as_tensor(np.random.RandomState(5).normal(size=y.shape))
    (first,) = torch.autograd.grad(y, x, gbar)
    assert calls == [(1, *y.shape)] and not first.requires_grad
    (want,) = fused.g2_vjp_reference(gbar[None], rij, slot, mask, *spec)
    np.testing.assert_array_equal(first.numpy(), want[0].numpy())
    (second,) = torch.autograd.grad(
        fused.G2Function.apply(x, slot, mask, *spec), x, gbar,
        create_graph=True)
    assert calls == [(1, *y.shape)] * 2 and second.requires_grad
    assert type(second.grad_fn).__name__ == "G2VjpFunctionBackward"
    np.testing.assert_array_equal(second.detach().numpy(), first.numpy())


def test_batched_cotangent_is_refused_off_the_cpu():
    """A cotangent batched by `is_grads_batched` is recognised; on the CPU
    the closed form takes it, on a device tensor the backward raises."""
    rij, slot, mask, spec = _g2_case()
    x = rij.clone().requires_grad_()
    y = fused.G2Function.apply(x, slot, mask, *spec)
    eye = torch.eye(y.numel(), dtype=y.dtype).reshape(-1, *y.shape)[:4]
    (batched,) = torch.autograd.grad(y, x, eye, retain_graph=True,
                                     is_grads_batched=True)
    for b in range(4):
        (one,) = torch.autograd.grad(y, x, eye[b], retain_graph=True)
        np.testing.assert_array_equal(batched[b].numpy(), one.numpy())

    seen = []

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t * 1.0

        @staticmethod
        def backward(ctx, g):
            seen.append(fused._is_vmapped(g))
            fake = type("Ctx", (), {
                "saved_tensors": (rij.to("meta"), slot.to("meta"),
                                  mask.to("meta")),
                "spec": spec})()
            return fused._backward(fused.G2Function, fake, g)[0]

    t = torch.zeros(y.shape, dtype=torch.float64, requires_grad=True)
    with pytest.raises(RuntimeError, match="is_grads_batched"):
        torch.autograd.grad(Probe.apply(t), t, eye, is_grads_batched=True)
    assert seen == [True]


def test_descriptor_vjp_equals_batched_autograd():
    """`descriptor_vjp` through the recorded G2 and G4 calls of an SF
    descriptor on the kernels' backend equals the plain batched autograd
    through the twin backend, from the pair vectors; without recorded
    calls it is plain autograd."""
    from test_torch_ops import _features, _torch
    from tensoralloy_tpu_torch.nn.sf import SymmetryFunction
    fz, feats = _features("moni")
    kw = dict(eta=[0.05, 0.5, 4.0], omega=[0.0, 1.0], beta=[0.005, 0.05],
              gamma=[1.0, -1.0], zeta=[1.0, 4.0])
    out = {}
    for backend in ("pallas", "dense"):
        sf = SymmetryFunction(fz.elements, backend=backend, **kw)
        f = _torch(feats)
        pos = f["positions"].clone().requires_grad_()
        f["positions"] = pos
        with fused.record_calls() as calls:
            g = sf.compute(f, fz.rcut, fz.acut, fz.n_radial_slots,
                           fz.n_angular_slots, True)
        assert [c.function for c in calls] == (
            [fused.G2Function, fused.G4Function] if backend == "pallas"
            else [])
        g_bar = torch.as_tensor(np.random.RandomState(6).normal(
            size=(BATCH, *g.shape)))
        (out[backend],) = fused.descriptor_vjp(g, g_bar, calls, [pos])
    assert out["pallas"].shape == (BATCH, *feats["positions"].shape)
    np.testing.assert_allclose(out["pallas"].numpy(), out["dense"].numpy(),
                               rtol=1e-12, atol=1e-12)


# ----------------------------------------------------------------------
# The callers that batch cotangents, split at the descriptors
# ----------------------------------------------------------------------

@pytest.fixture
def counted_grap_vjp(monkeypatch):
    """The cotangent batch of every `GrapFunction` VJP wrapper call."""
    batches = []
    wrapper = fused.GrapFunction.kernel_vjp
    monkeypatch.setattr(fused.GrapFunction, "kernel_vjp",
                        lambda *a: batches.append(a[0].shape[0])
                        or wrapper(*a))
    return batches


def _rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


@pytest.mark.parametrize("chunked", [False, True])
def test_committee_split_at_the_descriptors_matches_jax(chunked,
                                                        counted_grap_vjp):
    """The three Ni GRAP members on 'pallas' (32 atoms; row blocks of 12
    where chunked): one VJP call a request, or a row block, with B = 3;
    E/F/S, mean and spread equal to the JAX committee's to 1e-10."""
    js, s = jittered_ni(seed=5)
    kw = dict(chunked=True, chunk_size=12) if chunked else {}
    calc = EnsembleCalculator(NI_MEMBERS, device="cpu", backend="pallas",
                              **kw)
    got = calc.calculate(s)
    want = JaxEnsemble(NI_MEMBERS, **kw).calculate(js)
    assert counted_grap_vjp == [3] * (3 if chunked else 1)
    for key in ("energy", "forces", "stress", "energy_std", "forces_std"):
        assert _rel(got[key], want[key]) <= 1e-10, key


def test_linear_jacobian_rows_split_at_the_descriptors_match_jax(
        counted_grap_vjp):
    """LinearTensorMD's energy, force and virial rows through the split
    VJP (B = n_coef, one call for the force rows and one for the virial
    rows) against the JAX model's rows, 1e-10."""
    (js,), (s,) = labelled_structures(1, seed=2, reps=2)
    lm = LinearTensorMD(["Ni"], rcut=6.0, preset="pexp8", max_moment=3,
                        device="cpu")
    jlm = JaxLinear(["Ni"], rcut=6.0, preset="pexp8", max_moment=3)
    got = lm.design_rows(s, with_virial=True)
    want = jlm.design_rows(js, with_virial=True)
    assert counted_grap_vjp == [lm.n_coef, lm.n_coef]
    for key in ("energy_row", "force_rows", "virial_rows"):
        assert _rel(got[key], want[key]) <= 1e-10, key
