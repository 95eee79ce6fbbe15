"""Gradient-safe power (port of `tensoralloy_tpu/ops/safe.py`): ``x**y``
whose derivatives are finite at x == 0 (a plain power gives NaN or Inf
in its first and second derivatives there, which poisons force-loss
gradients w.r.t. potential parameters).

The backward is made of differentiable operations that call `safe_pow`
again, as the JAX `custom_jvp` does, so it can be differentiated two and
three times (a force loss, the elastic constraint)."""
from __future__ import annotations

import torch


class _SafePow(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return torch.pow(x, y)

    @staticmethod
    def backward(ctx, grad):
        x, y = ctx.saved_tensors
        # d/dx x^y = y x^(y-1): finite unless x == 0 and y < 1
        nonzero = x != 0
        dfdx = torch.where(nonzero,
                           y * safe_pow(torch.where(nonzero, x, 1.0), y - 1.0),
                           0.0)
        # d/dy x^y = x^y ln x: defined 0 at x <= 0
        positive = x > 0
        safe_x = torch.where(positive, x, 1.0)
        dfdy = torch.where(positive, safe_pow(x, y) * torch.log(safe_x), 0.0)
        gx = (grad * dfdx).sum_to_size(x.shape) \
            if ctx.needs_input_grad[0] else None
        gy = (grad * dfdy).sum_to_size(y.shape) \
            if ctx.needs_input_grad[1] else None
        return gx, gy


def safe_pow(x: torch.Tensor, y) -> torch.Tensor:
    """x ** y with finite derivatives at x == 0; `y` a tensor or a
    number."""
    if not isinstance(y, torch.Tensor):
        y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    return _SafePow.apply(x, y)
