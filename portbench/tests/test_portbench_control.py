"""The control, the program with its own TF32 path switched on, comes
out not correct; on the card only (TF32 is a property of its matmuls), at
a size a test run holds: 4,000 atoms of MD, the small database's
training."""
from __future__ import annotations

import pytest
import torch

from portbench.drivers import md, train
from portbench.tests.conftest import md_context


@pytest.fixture(autouse=True)
def _tf32_back():
    yield
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("control", [False, True])
def test_md_control(card, control):
    run = md.run(md_context(device=card, reps=10, control=control))
    assert run.correct != control, run.checks


@pytest.mark.cuda
@pytest.mark.parametrize("control", [False, True])
def test_train_control(card, train_context, control):
    run = train.run(train_context(device=card, control=control))
    assert run.correct != control, run.checks
