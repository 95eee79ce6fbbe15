"""Training cells: the program's own loop, `Trainer.fit`, on its
device-resident training set, with no evaluation and no logging: its
`train_step` on the batches it gathers, drawn from the run's seed, for
a model of any descriptor family the configuration names.

Set-up builds the experiment with `TrainingManager` from a copy of the
configuration's input file (its paths moved into the harness's work
directory), gives it initial weights made from the seed (the min-max
statistics from the program's own sweep), and drives that one trainer
through `warm_steps` steps of the same `fit` (one step a block, each
read back), on rows that all differ; their times size the window. The
window is one `fit` call over that many more steps, which resumes the
batch stream where set-up left it and ends with a synchronise. A traced
run profiles the window on the card alone, then `trace_steps` more
steps with the host's ops for the idle gaps.

`correct` compares two stretches with the plain reference, which sweeps
its own min-max statistics. The first `checked_steps` steps, run by the
reference from the same weights on the same rows: each step's loss, the
first gradient as the optimizer holds it after step 1, and the change
of the weights and of their EMA after the last checked step, at the
worst leaf. And the window's last block of `scan_steps` steps, run by
the reference from the program's state at its start (weights, Adam's
moments, EMA and step): the block's last loss, and the change of the
weights and of their EMA over the block at the median leaf (at the
worst leaf these read the rounding of the output bias, one float32
number the size of an atom's energy).
"""
from __future__ import annotations

import contextlib
import gc
import shutil
import time

import numpy as np

from .. import generate, work
from ..common import LISTS, ROOT, WORK, Check, Context, Run
from ..reference import asedb
from ..reference import train as ref_train
from ..trace import Profiled, host_range, idle_gaps_of
from ..work import mlp as work_mlp
from ..work.peaks import bound_s

PARTS = ("start", "forward", "first", "loss", "end")


def flatten(tree, prefix: str = "") -> dict:
    """Nested dicts and lists of tensors -> {"a/b/0/w": tensor}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for key, value in items:
        out.update(flatten(value, f"{prefix}/{key}" if prefix else str(key)))
    return out


def _experiment(ctx: Context):
    from tensoralloy_tpu_torch.io.input import InputReader
    from tensoralloy_tpu_torch.train.manager import TrainingManager
    from tensoralloy_tpu_torch.utils import nested_set
    cfg, tr = ctx.config, ctx.traffic
    work = WORK / ctx.cell
    work.mkdir(parents=True, exist_ok=True)
    source = ROOT / tr["database"]
    db = work / source.name
    if not db.exists():
        shutil.copy(source, db)
    config = InputReader(str(ROOT / cfg["input_toml"])).as_dict()
    for key, value in {"precision": "medium", "seed": tr["split_seed"],
                       "dataset.test_size": tr["test_size"],
                       "dataset.sqlite3": str(db),
                       "dataset.tfrecords_dir": str(work / "cache"),
                       "train.model_dir": str(work / "model"),
                       **cfg["overrides"]}.items():
        nested_set(config, key, value)
    return TrainingManager(config, device=ctx.device)


class _Marks:
    """CUDA events at the parts of every step of the window (traced
    runs): step started, forward done, first backward (the forces) done,
    loss backward done, step done; the step in a host range."""

    def __init__(self, trainer):
        import torch
        self.trainer, self.steps, self.marks = trainer, [], {}
        model, update = trainer.model, trainer._opt_update
        self._update = update
        train_step = trainer.train_step

        def step(state, feats, labels):
            mark("start")
            with host_range("train.step"):
                result = train_step(state, feats, labels)
            self.step_done()
            return result

        def mark(key):
            self.marks[key] = torch.cuda.Event(enable_timing=True)
            self.marks[key].record()

        def predictions(params, feats, create_graph=False):
            def energy_fn(f):
                result = model.energy_and_aux(f, params)
                mark("forward")
                return result
            result = trainer._select_efs(feats)(energy_fn, create_graph)(feats)
            mark("first")
            return result

        def timed_update(*args):
            mark("loss")
            return update(*args)

        self.mark = mark
        trainer.batched_predictions, trainer._opt_update = \
            predictions, timed_update
        trainer.train_step = step

    def step_done(self):
        self.mark("end")
        self.steps.append([self.marks[k] for k in PARTS])
        self.marks = {}

    def close(self):
        del self.trainer.batched_predictions, self.trainer.train_step
        self.trainer._opt_update = self._update

    def means_ms(self) -> dict:
        rows = np.array([[a.elapsed_time(b) for a, b in zip(s, s[1:])]
                         for s in self.steps])
        return dict(zip(PARTS[1:], rows.mean(axis=0).tolist()))


def run(ctx: Context) -> Run:
    import torch
    from tensoralloy_tpu_torch.precision import set_tf32
    cfg, tr, out = ctx.config, ctx.traffic, Run()
    if ctx.control:
        set_tf32(True)
    manager = _experiment(ctx)
    trainer = manager.trainer
    train_f, train_l, _, _ = manager.dataset.split(*manager.dataset.build())
    n_train, bs = len(train_l["energy"]), int(cfg["batch_size"])
    db_rows = asedb.read(str(ROOT / tr["database"]))
    train_rows, _ = generate.split(len(db_rows), tr["test_size"],
                                   tr["split_seed"])
    element = cfg["element"]
    sizes = [cfg["n_descriptors"]] + list(cfg["hidden_sizes"]) + [1]
    e0 = generate.static_energy([r["energy"] for r in db_rows],
                                [len(r["numbers"]) for r in db_rows])
    layers = generate.head_weights(sizes, ctx.seed, e0, trainer.device)
    norm = trainer.init_params(train_f, verbose=False)[element]["norm"]
    params0 = {element: {"mlp": {"layers": layers}, "norm": norm}}
    flat0 = {k: v.detach().clone() for k, v in flatten(params0).items()}
    # `fit` draws its batches from its parameters' seed: the run's; no
    # evaluation, no logging
    tp = trainer.train_parameters
    tp.seed = generate.legacy_seed(ctx.seed)
    tp.eval_steps = tp.log_steps = 2 ** 62
    stream = generate.batch_stream(n_train, bs, ctx.seed)
    sync = torch.cuda.synchronize if trainer.device.type == "cuda" \
        else (lambda: None)

    # the first steps one a block, each read back, through the window's
    # own call and feed
    warm, checked = int(tr["warm_steps"]), int(tr["checked_steps"])
    snap, clock = {"losses": []}, []

    def first_steps(step, state, metrics):
        sync()
        clock.append(time.perf_counter())
        if step < checked:
            snap["losses"].append(float(metrics["loss/total"]))
        if step == 0:
            snap["mu"] = {k: v.clone() for k, v in
                          flatten(state["opt_state"]["mu"]).items()}
        if step == checked - 1:
            snap["params"] = {k: v.clone() for k, v in
                              flatten(state["params"]).items()}
            snap["ema"] = {k: v.clone() for k, v in
                           flatten(state["ema_params"]).items()}

    scan, tp.scan_steps, tp.train_steps = tp.scan_steps, 1, warm
    state = trainer.fit(train_f, train_l, initial_state=trainer.init_state(
        params0), verbose=False, callback=first_steps)["state"]
    tp.scan_steps = scan
    snap["batches"] = [train_rows[next(stream)] for _ in range(checked)]
    for _ in range(warm - checked):
        next(stream)
    step_s = (clock[-1] - clock[1]) / (len(clock) - 2)
    steps = max(1, int(round(ctx.seconds / step_s)))
    tp.train_steps = warm + steps

    marks = _Marks(trainer) if ctx.trace else None
    # the state at the end of each block, the last two kept: the window's
    # last block runs from the first of them to the second
    losses, ends = [], [(warm - 1, state)]

    def window_blocks(step, st, metrics):
        losses.append(metrics["loss/total"])
        ends.append((step, st))
        del ends[:-2]

    try:
        with (Profiled() if ctx.trace else contextlib.nullcontext()) as prof:
            out.setup_end = time.perf_counter()
            state = trainer.fit(train_f, train_l, initial_state=state,
                                verbose=False, callback=window_blocks
                                )["state"]
            sync()
            out.window_s = time.perf_counter() - out.setup_end
        if marks:
            out.values.update({f"{k}_ms": v
                               for k, v in marks.means_ms().items()})
    finally:
        if marks:
            marks.close()
    drawn = [next(stream) for _ in range(steps)]
    (s0, st0), (s1, st1) = ends
    late = {"batches": [train_rows[b] for b in
                        drawn[s0 + 1 - warm:s1 + 1 - warm]],
            "loss": float(losses[-1]), "step": int(st0["step"]),
            **{k: {n: v.clone() for n, v in flatten(t).items()} for k, t in (
                ("params0", st0["params"]), ("mu", st0["opt_state"]["mu"]),
                ("nu", st0["opt_state"]["nu"]), ("ema0", st0["ema_params"]),
                ("params", st1["params"]), ("ema", st1["ema_params"]))}}
    del ends, st0, st1
    if ctx.trace:
        prof.window_s = out.window_s
        tp.train_steps += int(tr["trace_steps"])
        prof.idle_gaps = idle_gaps_of(lambda: trainer.fit(
            train_f, train_l, initial_state=state, verbose=False))
    out.trace = prof
    out.attempted = steps
    out.failed = min(steps, scan * int(
        (~torch.isfinite(torch.stack(losses))).sum()))
    out.values["train_throughput"] = bs * steps / out.window_s
    out.values["steps"] = steps
    if trainer.device.type == "cuda":
        out.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    if ctx.trace:
        _work(out, cfg, train_f, train_l, drawn)

    prog = {"losses": snap["losses"],
            "mu": {k: v for k, v in snap["mu"].items()},
            "params": snap["params"], "ema": snap["ema"], "p0": flat0,
            "late": late}
    del state, trainer, manager, losses
    gc.collect()
    if str(ctx.device).startswith("cuda"):
        torch.cuda.empty_cache()
    t = time.perf_counter()
    out.checks = _compare(ctx, prog, db_rows, train_rows, snap["batches"])
    out.values["reference_s"] = time.perf_counter() - t
    return out


def _work(out: Run, cfg: dict, train_f: dict, train_l: dict, drawn) -> None:
    """The frozen work of the window's descriptor kernels and MLP
    products from the real pairs, triples and atoms of its batches."""
    n_rows = len(train_l["energy"])
    masks = {name: train_f[f"{prefix}_mask_d"].reshape(n_rows, -1)
             for name, prefix in LISTS.items()
             if f"{prefix}_mask_d" in train_f}
    real = {name: (m > 0).sum(axis=1) for name, m in masks.items()}
    atoms = np.asarray(train_l["n_atoms"], np.float64)
    rows = len(drawn[0]) * train_f["pair_mask_d"].shape[1]
    widths = {name: train_f[f"{LISTS[name]}_mask_d"].shape[2]
              for name in masks}
    sizes = [cfg["n_descriptors"]] + list(cfg["hidden_sizes"]) + [1]
    mlp = work_mlp.flop_per_atom(sizes, work_mlp.TRAIN_STEP)
    counts = work.family(cfg)
    bounds, flop = {}, 0.0
    for sel in drawn:
        lists = {name: (rows, widths[name], float(real[name][sel].sum()))
                 for name in masks}
        for k, (n_bytes, f) in counts.launches(cfg, lists, "train").items():
            bounds[k] = bounds.get(k, 0.0) + bound_s(n_bytes, f)
            flop += f
        flop += mlp * float(atoms[sel].sum())
    out.launch_bound_s = {k: v / len(drawn) for k, v in bounds.items()}
    out.useful_flop = flop


def _leaf_gap(name: str, got: dict, want: dict, keys, limit: float,
              pick: str = "worst") -> Check:
    """The gap between two norms at the worst leaf, or at the median
    leaf (the lower median of the leaves' gaps), each leaf's over the
    larger of the reference's norm of that leaf and of the median
    leaf."""
    g = {k: float(got[k].double().norm()) for k in keys}
    w = {k: float(want[k].double().norm()) for k in keys}
    median = float(np.median(list(w.values())))
    gaps = {k: abs(g[k] - w[k]) / max(w[k], median) for k in keys}
    order = sorted(gaps, key=gaps.get)
    leaf = order[-1] if pick == "worst" else order[(len(order) - 1) // 2]
    return Check(name, gaps[leaf], limit, f"{pick} leaf {leaf}")


def _moved(grads: dict) -> list:
    """The weight leaves that the step moves: leaves whose reference
    gradient is nought to rounding (under a thousandth of the median
    leaf's) move under Adam by round-off alone."""
    weights = [k for k in grads if not k.startswith("norm/")]
    norms = {k: float(grads[k].double().norm()) for k in weights}
    median = float(np.median(list(norms.values())))
    return [k for k in weights if norms[k] >= 1e-3 * median]


def _compare(ctx: Context, prog: dict, db_rows, train_rows, batches) -> list:
    cfg, limits = ctx.config, ctx.traffic["limits"]
    element = cfg["element"]
    device = prog["p0"][f"{element}/mlp/layers/0/w"].device
    data = ref_train.Structures(db_rows, cfg, device)
    xlo, xhi = ref_train.norm_stats(data, train_rows)
    norm = {"norm/xlo": xlo, "norm/xhi": xhi}
    strip = len(element) + 1

    def own(tree):
        return {k[strip:]: v for k, v in tree.items()}

    def change_gap(name, got, want, start, moved, pick="worst"):
        return _leaf_gap(name, {k: got[k] - start[k] for k in moved},
                         {k: want[k] - start[k] for k in moved}, moved,
                         limits[name], pick)

    # the first steps, from the seed's weights
    p0 = own(prog["p0"])
    ref = ref_train.steps(dict(p0, **norm), data, batches, cfg)
    b1 = cfg["optimizer"]["beta1"]
    grads = {k: v / (1.0 - b1) for k, v in own(prog["mu"]).items()}
    ref_grad = ref["first_grad"]
    weights = [k for k in ref_grad if not k.startswith("norm/")]
    moved = _moved(ref_grad)
    checks = [
        Check("loss_gap", max(abs(a - b) / abs(b) for a, b in
                              zip(prog["losses"], ref["losses"])),
              limits["loss_gap"]),
        _leaf_gap("first_grad_gap", grads, ref_grad, weights,
                  limits["first_grad_gap"]),
        change_gap("weight_change_gap", own(prog["params"]), ref["params"],
                   p0, moved),
        change_gap("ema_change_gap", own(prog["ema"]), ref["ema"], p0,
                   moved)]

    # the window's last block, from the program's state at its start
    late = prog["late"]
    params0, ema0 = own(late["params0"]), own(late["ema0"])
    ref = ref_train.steps(dict(params0, **norm), data, late["batches"], cfg,
                          start={"mu": own(late["mu"]), "nu": own(late["nu"]),
                                 "ema": dict(ema0, **norm),
                                 "step": late["step"]})
    moved = _moved(ref["first_grad"])
    return checks + [
        Check("late_loss_gap", abs(late["loss"] - ref["losses"][-1])
              / abs(ref["losses"][-1]), limits["late_loss_gap"],
              f"{len(late['batches'])} steps from step {late['step']}"),
        change_gap("late_weight_change_median_gap", own(late["params"]),
                   ref["params"], params0, moved, "median"),
        change_gap("late_ema_change_median_gap", own(late["ema"]),
                   ref["ema"], ema0, moved, "median")]
