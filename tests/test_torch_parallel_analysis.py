"""The port's replica-sharded NEB, member-sharded committee and
`compute neb --shards` against the JAX package's on its virtual CPU
devices, float64, with the ranks spawned by `parallel.mesh.launch`
(gloo): `NEB(n_shards=4)` with 8 images (the zjw04 EAM band through the
analytic EFS and a GRAP band through one batched evaluation of each
rank's block), `EnsembleCalculator(n_shards=2)` of two saved GRAP members
in one piece and chunked, and the `compute neb` verb on two ranks. Each
is held to 1e-10 (the printed verb to 1e-8 of a line, as the other
command-line tests) against JAX's sharded run and the port's one
process.
"""
import numpy as np
import pytest

import chip_smoke
from tensoralloy_tpu.ensemble import EnsembleCalculator as JaxEnsemble
from tensoralloy_tpu.neb import NEB as JaxNEB
from tensoralloy_tpu_torch.parallel import ranks
from tensoralloy_tpu_torch.parallel.mesh import launch
from test_torch_cli_compute import (  # noqa: F401 (the fixtures apply)
    EAM, REL as CLI_REL, _argv, _hop, float64_models)
from test_torch_cli_verbs import assert_same_output, jax_main, port_main
from test_torch_ensemble import NI_MEMBERS, jittered_ni
from test_torch_neb import _grap, _zjw04, fcc_vacancy_pair
from test_torch_parallel_mesh import JOIN, REL, model_file, rel_err


def test_sharded_neb_band_matches_jax_and_one_rank(tmp_path):
    """8 images over 4 ranks, 10 FIRE steps in chunks of 5: the band's
    positions and energies, the barrier and fmax; every rank holds the
    same band."""
    ji, jf, si, sf = fcc_vacancy_pair()
    cases = {"eam": (_zjw04(len(ji)), True, None),
             "grap": (_grap(len(ji)), False, "pallas")}
    specs, want = {}, {}
    for name, ((model, params, _), climb, backend) in cases.items():
        specs[name] = {"model": model_file(model, params,
                                           tmp_path / f"{name}.npz"),
                       "initial": si, "final": sf, "n_images": 8,
                       "n_shards": 4, "steps": 10, "chunk_size": 5,
                       "climb": climb, "backend": backend, "device": "cpu",
                       "dtype": "high"}
        jneb = JaxNEB(model, params, ji, jf, n_images=8, climb=climb,
                      chunk_size=5, n_shards=4)
        want[name] = (jneb.run(fmax=1e-9, max_steps=10),
                      np.asarray(jneb.positions))
    got = launch(ranks.run_all, 4, [(ranks.neb_band, specs[name])
                                    for name in specs],
                 device="cpu", timeout=JOIN)
    for i, name in enumerate(specs):
        one = ranks.neb_band(dict(specs[name], n_shards=1))
        jres, jpos = want[name]
        per_rank = [g[i] for g in got]
        assert ranks.all_equal(per_rank, ("positions",)), name
        for ref_res, ref_pos in ((jres, jpos),
                                 (one["result"], one["positions"])):
            res = per_rank[0]["result"]
            assert rel_err(per_rank[0]["positions"], ref_pos) <= REL, name
            assert rel_err(res["energies"], ref_res["energies"]) <= REL
            # differences of the band's energies, to 1e-10 of their scale
            scale = np.max(np.abs(ref_res["energies"]))
            for k in ("barrier", "reverse_barrier", "delta_e"):
                assert abs(res[k] - ref_res[k]) <= REL * scale, (name, k)
            assert rel_err(res["fmax"], ref_res["fmax"]) <= REL, name
            for k in ("n_steps", "converged"):
                assert res[k] == ref_res[k], (name, k)
            # the saddle is the highest image; the symmetric hop's two
            # middle images tie to rounding
            top = ref_res["energies"][1:-1].max()
            assert abs(ref_res["energies"][res["saddle_index"]] - top) \
                <= REL * scale, name
        assert per_rank[0]["evaluations"] == one["evaluations"]


def test_sharded_committee_matches_jax_and_one_rank():
    """Two members over two ranks, in one piece and chunked (row blocks
    of 12): the mean and the spread of E/F/S."""
    js, s = jittered_ni()
    members = NI_MEMBERS[:2]
    base = {"members": members, "structure": s, "n_shards": 2,
            "backend": "pallas", "device": "cpu", "dtype": "high"}
    specs = [base, dict(base, chunked=True, chunk_size=12)]
    want = [JaxEnsemble(members, n_shards=2).calculate(js),
            JaxEnsemble(members, n_shards=2, chunked=True,
                        chunk_size=12).calculate(js)]
    got = launch(ranks.run_all, 2, [(ranks.committee, spec)
                                    for spec in specs],
                 device="cpu", timeout=JOIN)
    for i, spec in enumerate(specs):
        one = ranks.committee(dict(spec, n_shards=1))["results"]
        per_rank = [g[i]["results"] for g in got]
        keys = [k for k in want[i] if k != "energy_U"]
        assert set(per_rank[0]) == set(one) == set(keys)
        assert ranks.all_equal(per_rank, keys)
        for k in keys:
            for ref in (want[i][k], one[k]):
                assert rel_err(per_rank[0][k], ref) <= REL, (i, k)
        assert per_rank[0]["energy_std"] > 0


def test_neb_verb_on_two_ranks_matches_jax_and_one_rank(tmp_path):
    """`compute neb --shards 2` in a group of two ranks prints (rank 0
    only) and writes what JAX's prints and writes with --shards 2 on two
    devices, and what the port's verb prints on one rank."""
    argv = _argv(["compute", "neb", EAM, "initial.extxyz", "final.extxyz",
                  "--n-images", "8", "--max-steps", "10", "--output",
                  "neb.csv"])
    work = {name: tmp_path / name for name in ("jax", "port", "ranks")}
    for path in work.values():
        path.mkdir()
        _hop(path)
    want = chip_smoke.run_verb(jax_main, argv + ["--shards", "2"],
                               work["jax"])
    one = chip_smoke.run_verb(port_main, argv, work["port"])
    got = launch(ranks.cli, 2, {"argv": argv + ["--shards", "2"],
                                "cwd": str(work["ranks"]), "device": "cpu",
                                "dtype": "high"},
                 device="cpu", timeout=JOIN)
    assert [g["rc"] for g in got] == [0, 0] and got[1]["stdout"] == ""
    rec = {"rc": got[0]["rc"], "stdout": got[0]["stdout"],
           "files": {"neb.csv": (work["ranks"] / "neb.csv").read_text()}}
    for ref in (want, one):
        assert_same_output(rec, ref, CLI_REL)
    assert "forward barrier" in rec["stdout"]
    with pytest.raises(ValueError, match="divisible"):
        chip_smoke.run_verb(port_main, argv + ["--shards", "3"],
                            work["port"])
