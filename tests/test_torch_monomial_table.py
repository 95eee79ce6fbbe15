"""The table of the GRAP monomials' neighbours that the plain versions of
the VJP kernels take their derivatives through (`ops.fused.monomial_slopes`:
for each monomial d and axis i the monomial d - e_i and the exponent
e_i(d)): its entries against the basis and the host's codes (the kernels'
`kCodes`), and the d/du it drives, of sum_d (s_d m_d + t_d mdot_d) with
mdot the monomials' derivative along the pair's cotangent a (the
second-order kernel's last term, `grap_vjp_bwd_reference`), against
autograd through the twin's monomial basis, float64, 1e-12 of the largest
value.

`python -m pytest tests/test_torch_monomial_table.py -q`.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tensoralloy_tpu_torch.nn.grap import moment_basis_c, moment_monomials
from tensoralloy_tpu_torch.ops import fused

CSRC = Path(fused.__file__).resolve().parent.parent / "csrc"


def _exponents(codes):
    """[D, 3] exponents decoded from the kernels' codes (bits 0-2 the
    degree, then two bits a factor's axis)."""
    out = []
    for code in codes:
        axes = [(int(code) >> (3 + 2 * i)) & 3 for i in range(code & 7)]
        out.append([axes.count(ax) for ax in range(3)])
    return np.asarray(out)


def table_grad(max_moment, u, a, s, t):
    """d/du of sum_d (s_d m_d + t_d mdot_d) [N, 3] through the table, as
    `grap_vjp_bwd_reference` takes it: d m_d / d u_i = e_i(d) m_{d - e_i},
    mdot_d = sum_j a_j d m_d / d u_j, and d mdot_d / d u_i = sum_j a_j
    e_j(d) e_i(d - e_j) m_{d - e_j - e_i}."""
    index, count = fused.monomial_slopes(max_moment)
    count = torch.as_tensor(count, dtype=u.dtype)
    index = torch.as_tensor(index)
    m = moment_basis_c(u.unbind(-1), max_moment)
    grads = []
    for ax in range(3):
        dm = m[:, index[ax]] * count[ax]
        d2m = sum(a[:, b, None] * count[b] * count[ax][index[b]]
                  * m[:, index[ax][index[b]]] for b in range(3))
        grads.append(torch.sum(s * dm + t * d2m, -1))
    return torch.stack(grads, -1)


def autograd_grad(max_moment, u, a, s, t):
    """The same through autograd: mdot as the derivative of m(u + eps a)
    at eps = 0."""
    u = u.clone().requires_grad_()
    eps = torch.zeros(u.shape[0], dtype=u.dtype, requires_grad=True)
    m_eps = moment_basis_c((u + eps[:, None] * a).unbind(-1), max_moment)
    mdot, = torch.autograd.grad((t * m_eps).sum(), eps, create_graph=True)
    m = moment_basis_c(u.unbind(-1), max_moment)
    return torch.autograd.grad((s * m).sum() + mdot.sum(), u)[0]


def _inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    a, s, t = (rng.normal(size=shape) for shape in ((n, 3), (n, d), (n, d)))
    return [torch.as_tensor(x, dtype=torch.float64) for x in (u, a, s, t)]


@pytest.mark.parametrize("max_moment", [5, 3, 0])
def test_table_matches_basis_and_codes(max_moment):
    """Each entry against `moment_monomials` and the exponents decoded
    from `monomial_codes`: d - e_i where e_i(d) > 0, exponent 0 (and
    index 0) where the axis is absent."""
    monos = moment_monomials(max_moment)
    index, count = fused.monomial_slopes(max_moment)
    exps = _exponents(fused.monomial_codes(max_moment))
    assert index.shape == count.shape == (3, len(monos))
    where = {mono: d for d, mono in enumerate(monos)}
    for d, mono in enumerate(monos):
        assert [mono.count(ax) for ax in range(3)] == list(exps[d])
        for ax in range(3):
            assert count[ax, d] == exps[d][ax]
            if exps[d][ax]:
                rest = list(mono)
                rest.remove(ax)
                assert index[ax, d] == where[tuple(rest)]
                assert list(exps[index[ax, d]]) == [
                    x - (i == ax) for i, x in enumerate(exps[d])]
            else:
                assert index[ax, d] == 0


def test_table_codes_are_the_kernels():
    """The host's codes at moment 5 are `kCodes` of grap_common.cuh, the
    basis whose recurrence (and its adjoint on dual numbers) the kernels
    hard-code; launchers refuse other codes."""
    text = (CSRC / "grap_common.cuh").read_text()
    body = re.search(r"kCodes\[kMaxMonomials\] = \{([^}]*)\}", text).group(1)
    codes = [int(x) for x in body.replace("\n", " ").split(",")]
    assert codes == [int(c) for c in fused.monomial_codes(5)]


@pytest.mark.parametrize("max_moment", [5, 3])
def test_table_gradient_matches_autograd(max_moment):
    """The table-driven d/du of sum_d (s_d m_d + t_d mdot_d) against
    autograd: all 56 monomials (moment 5) and a gapped set's D = 20
    (moments 0, 1, 3)."""
    d = len(moment_monomials(max_moment))
    u, a, s, t = _inputs(64, d, 11 + max_moment)
    got = table_grad(max_moment, u, a, s, t)
    want = autograd_grad(max_moment, u, a, s, t)
    assert (got - want).abs().max().item() <= \
        1e-12 * want.abs().max().item()
