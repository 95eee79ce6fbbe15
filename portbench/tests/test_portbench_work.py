"""The frozen work counts, pinned on small shapes counted by hand."""
import pytest

from portbench.work import grap, mlp, peaks, sf

# rows 2, width 4, real 5: the slot and mask arrays are 2 x 2 x 4 floats
CASES = [
    (sf.g2, (2, 4, 5, 3, 1), (108, 125)),
    (sf.g4, (2, 4, 5, 2, 1), (140, 225)),
    (sf.g2_vjp, (2, 4, 5, 3, 1, 2), (196, 340)),
    (sf.g4_vjp, (2, 4, 5, 2, 1), (236, 390)),
    (sf.g2_vjp_bwd, (2, 4, 5, 3, 1), (152, 400)),
    (sf.g2_vjp_bwd, (2, 4, 5, 3, 1, True), (184, 400)),
    (sf.g4_vjp_bwd, (2, 4, 5, 2, 1), (216, 970)),
    (sf.g4_vjp_bwd, (2, 4, 5, 2, 1, True), (312, 970)),
    (grap.grap, (2, 4, 5, 2, 4, 2, 1), (176, 213)),
    (grap.grap_vjp, (2, 4, 5, 2, 4, 2, 1), (304, 692)),
    (grap.grap_vjp_bwd, (2, 4, 5, 2, 4, 2, 1), (288, 589)),
    (grap.grap_vjp_bwd, (2, 4, 5, 2, 4, 2, 1, True), (416, 1793)),
]


@pytest.mark.parametrize("fn, args, want", CASES,
                         ids=[f"{c[0].__name__}-{i}"
                              for i, c in enumerate(CASES)])
def test_kernel_counts(fn, args, want):
    assert fn(*args) == want


def test_mlp_and_peaks():
    assert mlp.flop_per_atom([9, 128, 128, 1], mlp.FORCE_EVALUATION) \
        == 4 * (9 * 128 + 128 * 128 + 128)
    assert mlp.flop_per_atom([96, 128, 128, 1], mlp.TRAIN_STEP) \
        == 12 * (96 * 128 + 128 * 128 + 128)
    assert peaks.bound_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert peaks.bound_s(1.0, 67e12) == pytest.approx(1.0)


def test_grap_at_the_kernel_tables_size():
    """The GRAP bounds of the kernel table in PERF.md (32,000 atoms, rows
    of 128, about 78.7 real pairs an atom): grap 4.95 GFLOP and 0.0739
    ms, grap_vjp 15.53 GFLOP and 0.2318 ms."""
    for fn, gflop, ms in ((grap.grap, 4.95, 0.0739),
                          (grap.grap_vjp, 15.53, 0.2318)):
        n_bytes, flop = fn(32001, 128, 2519000, 16, 56, 6, 1)
        assert flop / 1e9 == pytest.approx(gflop, abs=0.005)
        assert peaks.bound_s(n_bytes, flop) * 1e3 == pytest.approx(
            ms, abs=1e-4)


def test_md_lists_count_the_pairs_within_the_cutoff():
    """The MD driver counts as real the pairs of the skinned device list
    that lie within the model's cutoff: as many as the reference's own
    search finds at the cutoff, fewer than the list holds."""
    import numpy as np
    import torch
    from tensoralloy_tpu_torch.atoms import Structure
    from tensoralloy_tpu_torch.dynamics import VelocityVerlet
    from tensoralloy_tpu_torch.io.model import load_model

    from portbench import generate
    from portbench.drivers.md import _list_sizes
    from portbench.reference import neighbors
    from portbench.tests.conftest import ROOT
    model, _ = load_model(str(ROOT / "artifacts" / "snap_ni_v5_readapt"
                              / "model" / "snap_Ni.npz"), device="cpu",
                          dtype="medium", backend="pallas")
    pos, cell = generate.jittered_fcc(4, 3.52, 0.1, 17)
    md = VelocityVerlet(model, Structure.from_symbols(
        ["Ni"] * len(pos), pos, cell, pbc=[True] * 3), skin=1.0,
        device_nl=True)
    feats, _ = md._nl.build(md._tensor(md.vap.map_positions(pos)))
    rows, width, real = _list_sizes(feats, 6.0)["pairs"]
    want = len(neighbors.pairs(torch.as_tensor(pos), torch.as_tensor(cell),
                               6.0)[0])
    listed = int((feats["pair_mask_d"] > 0).sum())
    assert int(real) == want
    assert listed > 1.4 * want
    assert rows * width >= listed
    assert np.isfinite(float(real))


@pytest.mark.parametrize("config_name, kind, keys", [
    ("grap_ni_pexp16_m5", "energy", {"grap"}),
    ("grap_ni_pexp16_m5", "force", {"grap", "grap_vjp"}),
    ("grap_ni_pexp16_m5", "train", {"grap", "grap_vjp", "grap_vjp_bwd"}),
    ("sf_ni_g2g4_acut4", "force", {"g2", "g4", "g2_vjp", "g4_vjp"}),
    ("sf_ni_g2g4_acut4", "train", {"g2", "g4", "g2_vjp", "g4_vjp",
                                   "g2_vjp_bwd", "g4_vjp_bwd"})])
def test_a_family_counts_its_launches_from_its_configuration(
        config_name, kind, keys):
    """The work module the configuration's family names gives each
    kernel of an evaluation, with the sizes its configuration states: 16
    filters, 56 monomials and 6 moments; 5 G2 and 4 G4 rows."""
    from portbench import work
    from portbench.common import load_json
    from portbench.tests.conftest import CONFIGS
    config = load_json(CONFIGS / f"{config_name}.json")
    lists = {"pairs": (2, 4, 5), "triples": (2, 4, 5)}
    got = work.family(config).launches(config, lists, kind)
    assert set(got) == keys
    if config["family"] == "grap":
        assert got["grap"] == grap.grap(2, 4, 5, 16, 56, 6, 1)
        if kind == "train":
            assert got["grap_vjp_bwd"] == grap.grap_vjp_bwd(
                2, 4, 5, 16, 56, 6, 1)
    else:
        assert got["g2_vjp"] == sf.g2_vjp(2, 4, 5, 5, 1)
        assert got["g4"] == sf.g4(2, 4, 5, 4, 1)
