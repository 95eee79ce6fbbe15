"""One float64 snap_ni_sfa train step at full width through the port's
second-order route (the VJP wrappers of G2 and G4 once each, their
second-order wrappers without the geometry term) against the JAX
trainer's fixture; a file of its own, so that the test runner's workers
take it beside tests/test_torch_second_order.py.

`python -m pytest tests/test_torch_second_order_train.py -q`.
"""
import json

from test_torch_second_order import DATA, counted  # noqa: F401


def test_snap_ni_sfa_train_step_matches_the_jax_fixture(tmp_path, counted):
    """One float64 train step of snap_ni_sfa at full width (the run's
    input.toml, backend 'pallas', seeded parameters, the first batch of
    25 structures of snap-Ni.db): the parameter gradient's norm equals
    the JAX trainer's (`tests/data/torch_port_ref_train_sf.json`, 1e-8),
    through the VJP wrappers (G2, G4 once each, B = 1) and the
    second-order ones without the geometry term."""
    import chip_smoke
    from tensoralloy_tpu_torch.io.model import load_model
    from tensoralloy_tpu_torch.train.dataset import batch_index_stream
    from tensoralloy_tpu_torch.train.manager import TrainingManager
    from tensoralloy_tpu_torch.train.optim import global_norm
    from tensoralloy_tpu_torch.utils import tree_map
    cfg = chip_smoke.TRAIN_CONFIGS["sf"]
    fixture = json.loads((DATA / "torch_port_ref_train_sf.json")
                         .read_text())
    manager = TrainingManager(chip_smoke.experiment_config(
        cfg["run"], tmp_path, {
            "precision": "high", "nn.atomic.sf.backend": "pallas",
            "train.train_steps": 1, "train.scan_steps": 1,
            "train.eval_steps": 10 ** 9, "train.log_steps": 10 ** 9,
            "train.force_assembly": "dense", "train.final_f32_steps": 0},
        database=chip_smoke.TRAIN_DB), device="cpu")
    trainer, ds = manager.trainer, manager.dataset
    arrays = ds.split(*ds.build())
    tp = trainer.train_parameters
    saved, _ = load_model(str(chip_smoke.ROOT / cfg["model"]),
                          dtype="high", device="cpu")
    params = trainer._tree_to_device(chip_smoke.seeded_params(
        tree_map(lambda x: x.cpu().numpy(), saved.param_tree()), tp.seed))
    first = next(batch_index_stream(len(arrays[1]["energy"]),
                                    tp.batch_size, seed=tp.seed,
                                    repeat=True))
    bf = trainer._to_device({k: v[first] for k, v in arrays[0].items()})
    bl = trainer._to_device({k: v[first] for k, v in arrays[1].items()})
    (_, _), grads = trainer.loss_and_grads(params, bf, bl, 0)
    norm = float(global_norm(grads))
    want = fixture["grad_norm_first_step"]
    assert abs(norm - want) <= 1e-8 * want
    assert counted == {"vjp": [1, 1], "bwd": [False, False]}
