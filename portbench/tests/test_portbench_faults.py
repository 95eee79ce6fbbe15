"""A run with its timed path broken underneath comes out not correct.

Each test drives the rest of a run (everything after the harness's look
for a card) on the CPU at a small size, once sound and once for each
fault the cell can have (`portbench.faults`): a step that returns its
state unchanged, half of the batch left out with the mean taken over the
rest, and an answer altered where it is produced. One chip, so no
exchange between chips to leave out."""
from __future__ import annotations

import pytest

from portbench import faults
from portbench.drivers import md, train
from portbench.tests.conftest import md_context


@pytest.fixture
def planted():
    mends = []

    def plant(kind, name):
        if name != "sound":
            mends.append(faults.plant(kind, name))
    yield plant
    for mend in mends:
        mend()


@pytest.mark.parametrize("fault", ("sound",) + faults.FAULTS["md"])
def test_md_fault(fault, planted):
    planted("md", fault)
    run = md.run(md_context())
    assert run.correct == (fault == "sound"), run.checks


@pytest.mark.parametrize("fault", ("sound",) + faults.FAULTS["train"])
def test_train_fault(fault, train_context, planted):
    planted("train", fault)
    run = train.run(train_context())
    assert run.correct == (fault == "sound"), run.checks
