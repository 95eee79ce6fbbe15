"""The MD driver of the EAM family (`drivers/md_eam.py`) on the CPU at
54 atoms: a sound run is correct and counts its analytic passes; each of
`portbench.faults`' MD faults planted under it fails a check; a program
without the pass counter still runs, without the count; the run loads
no JAX; the frozen counts of an ADP pass (`work/adp.py`); the slab
search against the brute force; and the reference in bfloat16 failing
the limits (`readings_md_eam.lower_reference`)."""
from __future__ import annotations

import subprocess
import sys

import pytest

from portbench import faults
from portbench.common import Context, Run, load_json
from portbench.drivers import md_eam
from portbench.tests.conftest import CONFIGS, ROOT, TRAFFIC
from portbench.work import adp as work_adp
from portbench.work import peaks


def eam_context(seed=2 ** 31 + 13):
    traffic = dict(load_json(TRAFFIC / "nvt_bcc60_mo_300k.json"), reps=3,
                   warm_chunks=1)
    return Context(cell="md_eam_test", seed=seed, seconds=0.5, trace=False,
                   config=load_json(CONFIGS / "adp_mo_mladp_v5.json"),
                   traffic=traffic, device="cpu")


@pytest.mark.parametrize("fault", ("sound",) + faults.FAULTS["md"])
def test_md_eam_fault(fault):
    mend = faults.plant("md", fault) if fault != "sound" else None
    try:
        run = md_eam.run(eam_context())
    finally:
        if mend is not None:
            mend()
    assert run.correct == (fault == "sound"), run.checks
    # a chunk of 20 steps runs 22 passes: its start, its steps, its end
    chunks = run.values["steps"] // 20
    assert run.values["pass_counts"] == {"alloy": 0, "fs": 0,
                                         "adp": 22 * chunks}
    assert run.values["descriptor_launches"] == 0


def test_a_program_without_the_pass_counter(monkeypatch):
    """A program from before the counter keeps no `pass_counts`:
    `md_eam` then records no count and raises nothing."""
    from tensoralloy_tpu_torch.nn.eam import fast_efs
    monkeypatch.delattr(fast_efs, "pass_counts")
    before = md_eam._counters()
    assert "pass_counts" not in before and "launch_counts" in before
    out = Run()
    md_eam._report(out, md_eam._delta(md_eam._counters(), before), 22,
                   "adp")
    assert "pass_counts" not in out.values
    assert out.values["descriptor_launches"] == 0


def test_the_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import common\ncommon.block_forbidden()\n"
        "from portbench.tests.test_portbench_md_eam import eam_context\n"
        "from portbench.drivers import md_eam\n"
        "run = md_eam.run(eam_context())\n"
        "print(run.correct, common.forbidden_modules())\n" % str(ROOT))
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip().splitlines()[-1] == "True []"


def test_adp_pass_counts_are_pinned():
    """10 atoms, 100 pairs within the cutoff, 20 within u and w's: bytes
    20 a pair and 24 an atom; FLOP 89 a pair, 172 a near pair and 110 an
    atom for the forces, 54, 48 and 62 for the energy alone."""
    assert work_adp.efs_pass(10, 100, 20) == (2240, 8900 + 3440 + 1100)
    assert work_adp.efs_pass(10, 100, 20, "energy") == (
        2240, 5400 + 960 + 620)


def test_the_adp_pass_at_the_cells_size_binds_on_bytes():
    """432,000 atoms of bcc Mo, 64 pairs an atom within 6.5 A and 14
    within u and w's 3.53 A: 563 MB and 3.55 GFLOP, 0.168 ms at the
    card's bandwidth."""
    n_bytes, flop = work_adp.efs_pass(432000, 64 * 432000, 14 * 432000)
    assert n_bytes == 563328000
    assert flop / 1e9 == pytest.approx(3.548, abs=5e-4)
    assert peaks.bound_s(n_bytes, flop) == pytest.approx(
        n_bytes / peaks.BYTES_PER_S)
    assert peaks.bound_s(n_bytes, flop) * 1e3 == pytest.approx(0.1682,
                                                               abs=1e-4)


@pytest.mark.parametrize("reps, strain", [
    (8, None), (9, ((1.02, 0.03, 0.0), (0.0, 0.99, 0.02), (0.01, 0.0, 1.01))),
    (4, None)], ids=("three_slabs", "triclinic", "brute_force"))
def test_the_slab_search_finds_the_brute_force_pairs(reps, strain):
    """The reference's slab search gives `neighbors.pairs`'s pairs in
    its order, in cells of three slabs and more, cubic and triclinic,
    and hands a cell too small for slabs to it."""
    import numpy as np
    import torch

    from portbench.lattice import jittered_bcc
    from portbench.reference import neighbors, slabs
    pos, cell = jittered_bcc(reps, 3.1467, 0.05, 3)
    if strain is not None:
        pos, cell = pos @ np.array(strain), cell @ np.array(strain)
    pos, cell = torch.as_tensor(pos), torch.as_tensor(cell)
    want = neighbors.pairs(pos, cell, 7.5)
    got = slabs.pairs(pos, cell, 7.5)
    assert len(want[0]) > 60 * len(pos)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_the_slab_search_refuses_positions_that_are_not_finite():
    import torch

    from portbench.lattice import jittered_bcc
    from portbench.reference import slabs
    pos, cell = jittered_bcc(8, 3.1467, 0.05, 3)
    pos[5, 1] = float("nan")
    with pytest.raises(ValueError, match="not finite"):
        slabs.pairs(torch.as_tensor(pos), torch.as_tensor(cell), 7.5)


def test_the_reference_in_bfloat16_fails_the_limits():
    """`readings_md_eam.lower_reference`: `md_eam._compare` against the
    reference run in bfloat16 is not correct, and the patch comes out
    again."""
    import torch

    from portbench import readings_md_eam
    from portbench.reference import md as ref_md
    chunk = ref_md.baoab_chunk
    mend = readings_md_eam.lower_reference(torch.bfloat16)
    try:
        run = md_eam.run(eam_context())
    finally:
        mend()
    assert ref_md.baoab_chunk is chunk
    gaps = {c.name: c for c in run.checks}
    assert not run.correct
    assert gaps["velocity_rms_gap"].value > 1e3 * gaps[
        "velocity_rms_gap"].limit
