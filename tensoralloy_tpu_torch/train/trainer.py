"""Training orchestration (port of `tensoralloy_tpu/train/trainer.py`):
loss, eager train and eval steps with EMA, the fit loop, checkpoints.

The state is a dict of parameter trees shaped like the JAX package's:

    {"params": tree, "opt_state": dict, "ema_params": tree, "step": int}

A train step evaluates the batch in one pass ([B, A, ...] features: one
launch of each descriptor kernel; the EAM family's flat [B, nij] pair
arrays), takes forces and stress from
`torch.autograd.grad(..., create_graph=True)`, adds the loss of every
constraint (`nn.constraints`) under its name, and differentiates the
loss w.r.t. the parameters only (a second backward through the first).
Flat `.npz` checkpoints use the JAX package's keys (`params/...`,
`ema/...`, `opt/...`, `step`), so either package resumes from the
other's file.

Data parallelism (`n_devices`, a mesh of `torch.distributed` ranks):
every rank reads the same batch, predicts E/F/S of its own block of it,
and the predictions are gathered with their gradients
(`parallel.collectives.gather`). Every rank then computes the loss of
the GLOBAL batch, as JAX's SPMD step does: an `rmse` is the root of the
whole batch's mean, not a mean of per-shard roots (which averaging
per-shard gradients would give). Each rank's parameter gradient is the
share of its predictions plus 1/n of the terms on the parameters alone
(L2, constraints), and one all-reduce sums them. The optimizer and the
EMA run replicated on every rank from parameters broadcast by rank 0.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..nn import losses as loss_ops
from ..nn.fields import EV_ANGSTROM3_TO_GPA, make_efs_fn
from ..ops.dense import make_dense_efs_fn
from ..parallel.collectives import all_reduce_many, gather
from ..parallel.mesh import make_mesh, replicate
from ..precision import resolve_device, resolve_dtype, set_tf32
from ..utils import tree_flatten, tree_map, tree_unflatten
from .dataset import batch_index_stream, batches, to_tensors
from .optim import (OptParameters, make_optimizer, opt_state_from_flat,
                    opt_state_to_flat)

__all__ = ["OptParameters", "TrainParameters", "Trainer"]

# the loss terms read from the (gathered) predictions; every other term
# (L2, the constraints) is a function of the parameters alone
_PREDICTED = ("energy", "forces", "stress_voigt", "total_pressure",
              "eentropy", "free_energy")
_PREDICTED_TERMS = ("energy", "forces", "stress", "total_pressure",
                    "eentropy", "free_energy")

# jax's names for float32 matmuls at full precision, and for the reduced
# ones that map onto TF32 here
_FULL_PRECISION = {"highest", "float32", "high", "bfloat16_3x"}
_MATMUL_PRECISIONS = _FULL_PRECISION | {"default", "bfloat16",
                                        "tensorfloat32"}


@dataclasses.dataclass
class TrainParameters:
    batch_size: int = 32
    train_steps: int = 10000
    eval_steps: int = 1000
    summary_steps: int = 100
    log_steps: int = 100
    max_checkpoints_to_keep: int = 5
    ema_decay: float = 0.999
    seed: int = 611
    model_dir: str = "train"
    # >1: take this many optimizer steps per block; metrics are those of
    # the block's last step, read back (and callbacks called) once a
    # block, so the host waits for the device once a block
    scan_steps: int = 1
    # keep the WHOLE training set on the device and gather batches there
    # by index (one upload instead of a host->device copy per step)
    device_dataset: bool = True
    # upper bound (GiB) on the padded feature+label arrays eligible for
    # the device-resident path; larger sets stream batches from the host
    device_dataset_max_gb: float = 6.0
    # Matmul precision of the EVAL step only, under jax's names. Here it
    # maps onto `precision.set_tf32`: 'highest', 'float32', 'high' and
    # 'bfloat16_3x' evaluate with TF32 off (float32 matmuls at full
    # precision), 'default', 'bfloat16' and 'tensorfloat32' with TF32
    # on. It has no effect at float64.
    eval_matmul_precision: str = "highest"
    # Precision annealing: the LAST N optimizer steps run with TF32 off
    # (`set_tf32(False)`), whatever the global setting was until then,
    # so the exported weights are adapted to full-precision matmuls.
    # With scan_steps > 1 the switch comes at the first block that starts
    # at or after train_steps - N. 0 = off.
    final_f32_steps: int = 0
    # How a step assembles forces and stress from the energy:
    #   'autodiff' — differentiate w.r.t. positions and cell
    #       (`nn.fields.make_efs_fn`); the backward of every
    #       positions[pair_j_d] gather is a scatter-add. The EAM family's
    #       flat pair layout always takes this path.
    #   'dense'    — differentiate w.r.t. the dense pair/triple VECTORS
    #       and assemble forces through the featurizer's transpose
    #       tables (`ops.dense.make_dense_efs_fn`, gathers only). Needs
    #       features built with transpose=True.
    #   'auto'     — 'dense' where the features carry the tables,
    #       'autodiff' otherwise.
    force_assembly: str = "auto"
    # Gradient accumulation: split each optimizer batch into
    # batch_size/microbatch_size chunks and average the per-chunk
    # gradients before ONE optimizer update. 0 = off. The gradient is
    # the MEAN over chunks of per-chunk batch gradients: identical to
    # the whole batch's where the loss is linear in the batch mean, the
    # mean of per-chunk RMSEs for rmse-type losses. Requires
    # batch_size % microbatch_size == 0.
    microbatch_size: int = 0

    def __post_init__(self):
        if (self.eval_matmul_precision or "default") \
                not in _MATMUL_PRECISIONS:
            raise ValueError(
                f"eval_matmul_precision={self.eval_matmul_precision!r}"
                f" is not one of {sorted(_MATMUL_PRECISIONS)}")
        mb = int(self.microbatch_size or 0)
        if mb < 0 or (mb and self.batch_size % mb != 0):
            raise ValueError(
                f"microbatch_size={self.microbatch_size} must be 0 or a "
                f"positive divisor of batch_size={self.batch_size}")
        if self.force_assembly not in ("auto", "autodiff", "dense"):
            raise ValueError(
                f"force_assembly={self.force_assembly!r} is not one of "
                "['auto', 'autodiff', 'dense']")


def _norm_sweep_chunk(model, feats, budget_bytes: int = 2 * 1024 ** 3,
                      cap: int = 512) -> int:
    """Chunk size of the whole-set min/max descriptor sweep: a batched
    descriptor evaluation holds working arrays far larger than the raw
    padded features, so the chunk is sized by the model's
    `norm_sweep_bytes_per_structure` estimate."""
    per = 0
    est = getattr(model, "norm_sweep_bytes_per_structure", None)
    if est is not None:
        per = int(est(feats))
    if per <= 0:
        per = 64 * sum(int(np.asarray(v[0:1]).nbytes)
                       for v in feats.values())
    return max(1, min(cap, int(budget_bytes // max(per, 1))))


class _tf32:
    """Run a block with TF32 switched as asked, then put it back."""

    def __init__(self, enabled: Optional[bool]):
        self.enabled = enabled

    def __enter__(self):
        self.before = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        if self.enabled is not None:
            set_tf32(self.enabled)

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.before


# ----------------------------------------------------------------------
class Trainer:
    """Train a potential model on a featurized dataset.

    `device` is the card unless the caller passes "cpu" ("cuda" without
    a card raises); `dtype` is 'high' (float64), 'medium' (float32) or a
    torch float dtype. The model, and the constant features of the
    `constraints`, are moved there. `n_devices` is the data-parallel
    mesh (`parallel.mesh.make_mesh`): None is the whole current
    `torch.distributed` group (one rank without a group), and more ranks
    than the group has raise ValueError. The batch, and a microbatch,
    must split evenly over the ranks. Only rank 0 prints and writes
    checkpoints."""

    def __init__(self, model, loss_parameters: loss_ops.LossParameters,
                 opt_parameters: OptParameters,
                 train_parameters: TrainParameters,
                 minimize_properties=("energy", "forces", "stress"),
                 n_devices: Optional[int] = None,
                 constraints: Optional[list] = None, *,
                 device="cuda", dtype="medium"):
        self.device = resolve_device(device)
        self.mesh = make_mesh(n_devices)
        n = self.mesh.size
        mb = int(train_parameters.microbatch_size or 0)
        if train_parameters.batch_size % n or mb % n:
            raise ValueError(
                f"batch_size={train_parameters.batch_size} and "
                f"microbatch_size={mb} must split evenly over {n} devices")
        self.dtype = resolve_dtype(dtype)
        self.model = model.to(device=self.device, dtype=self.dtype)
        self.constraints = [c.to(self.device, self.dtype)
                            for c in constraints or []]
        self.loss_parameters = loss_parameters
        self.opt_parameters = opt_parameters
        self.train_parameters = train_parameters
        self.minimize = tuple(minimize_properties)
        self._opt_init, self._opt_update = make_optimizer(opt_parameters)
        self.state: Optional[dict] = None
        # step at which the last `fit` switched to full-precision matmuls
        self.annealed_at: Optional[int] = None

    # ------------------------------------------------------------------
    def _to_device(self, arrays) -> Dict[str, torch.Tensor]:
        return to_tensors(arrays, self.device, self.dtype)

    def _tree_to_device(self, tree):
        return tree_map(lambda x: torch.as_tensor(
            np.asarray(x) if not isinstance(x, torch.Tensor) else x,
            device=self.device).to(self.dtype).clone(), tree)

    def _select_efs(self, feats) -> Callable:
        """Resolve TrainParameters.force_assembly against this batch ->
        the EFS factory (`make_dense_efs_fn` or `make_efs_fn`)."""
        mode = self.train_parameters.force_assembly
        if mode == "autodiff":
            return make_efs_fn
        have = ("pair_trans_d" in feats and
                ("trip_j_d" not in feats or "trip_trans_j_d" in feats))
        if mode == "dense" and not have:
            raise KeyError(
                "force_assembly='dense' needs transpose tables — "
                "build the Dataset/featurize with transpose=True")
        return make_dense_efs_fn if have else make_efs_fn

    def batched_predictions(self, params, feats, create_graph: bool = False
                            ) -> Dict[str, torch.Tensor]:
        """One pass over the batch -> energy [B], forces [B, A, 3],
        stress_voigt [B, 6], total_pressure [B], and for the
        finite-temperature models energy = U, eentropy and free_energy
        (forces and stress then derive from the free energy)."""
        model = self.model

        def energy_fn(f):
            return model.energy_and_aux(f, params)

        return self._select_efs(feats)(energy_fn, create_graph)(feats)

    def total_loss(self, params, feats, labels, step: int
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        lp = self.loss_parameters
        mesh = self.mesh
        local = feats if mesh.group is None else {
            k: v[mesh.block(v.shape[0])] for k, v in feats.items()}
        preds = self.batched_predictions(
            params, local, create_graph=torch.is_grad_enabled())
        if mesh.group is not None:
            preds = {k: gather(v, mesh) for k, v in preds.items()
                     if k in _PREDICTED}
        n_atoms = labels["n_atoms"]
        atom_masks = feats["atom_masks"]
        max_steps = self.train_parameters.train_steps
        w_struct = labels.get("weights")  # [B, 3] energy/forces/stress

        if "forces" in self.minimize and lp.adaptive_sample_weight.enabled:
            asw = loss_ops.adaptive_sample_weight(
                labels["forces"], atom_masks, n_atoms,
                lp.adaptive_sample_weight)
            normalized = lp.adaptive_sample_weight.normalized
        else:
            asw, normalized = None, False

        def weights_for(i, base):
            """Combine adaptive and per-structure label weights."""
            w = base
            if w_struct is not None:
                col = w_struct[:, i]
                w = col if w is None else w * col
            return w

        def weight_of(opts):
            return loss_ops.resolve_weight(
                opts.weight, step, max_steps, opts.logscaled_dynamic_weight)

        out: Dict[str, torch.Tensor] = {}
        metrics: Dict[str, torch.Tensor] = {}

        w_e = weights_for(0, asw)
        loss_e, mae_e = loss_ops.scalar_property_loss(
            labels["energy"], preds["energy"], lp.energy, n_atoms=n_atoms,
            sample_weight=w_e, normalized=normalized or w_e is not None)
        out["energy"] = loss_e * weight_of(lp.energy)
        metrics["energy/mae"] = mae_e
        metrics["energy/mae/atom"] = torch.mean(
            torch.abs(labels["energy"] - preds["energy"]) / n_atoms)

        if "forces" in self.minimize:
            w_f = weights_for(1, asw)
            loss_f, mae_f = loss_ops.forces_loss(
                labels["forces"], preds["forces"], atom_masks, lp.forces,
                sample_weight=w_f, normalized=True)
            out["forces"] = loss_f * weight_of(lp.forces)
            metrics["forces/mae"] = mae_f

        has = labels.get("has_stress")
        if "stress" in self.minimize:
            w_s = weights_for(2, asw)
            if has is not None:
                w_s = has if w_s is None else w_s * has
            loss_s, mae_s = loss_ops.stress_loss(
                labels["stress"], preds["stress_voigt"], lp.stress,
                sample_weight=w_s, normalized=w_s is not None)
            out["stress"] = loss_s * weight_of(lp.stress)
            metrics["stress/mae"] = mae_s

        if "total_pressure" in self.minimize:
            # label derived from the Voigt stress (eV/A^3)
            lbl_p = labels.get("total_pressure")
            if lbl_p is None:
                lbl_p = -torch.mean(labels["stress"][:, :3], dim=1) \
                    * EV_ANGSTROM3_TO_GPA
            w_p = weights_for(2, None)
            if has is not None:
                w_p = has if w_p is None else w_p * has
            loss_p, mae_p = loss_ops.scalar_property_loss(
                lbl_p, preds["total_pressure"], lp.total_pressure,
                sample_weight=w_p, normalized=w_p is not None)
            out["total_pressure"] = loss_p * weight_of(lp.total_pressure)
            metrics["total_pressure/mae"] = mae_p

        for prop, opts in (("eentropy", lp.eentropy),
                           ("free_energy", lp.free_energy)):
            if prop in self.minimize and prop in preds:
                loss_p, mae_p = loss_ops.scalar_property_loss(
                    labels[prop], preds[prop], opts, n_atoms=n_atoms)
                out[prop] = loss_p * weight_of(opts)
                metrics[f"{prop}/mae"] = mae_p

        if lp.l2.weight > 0:
            w = lp.l2.weight
            if lp.l2.decayed:
                # float32 arithmetic on the step, as the JAX package
                w = float(np.float32(w) * np.float32(lp.l2.decay_rate) ** (
                    np.float32(step) / np.float32(lp.l2.decay_steps)))
            out["l2"] = self.model.l2_loss(params) * w

        for constraint in self.constraints:
            out[constraint.name] = constraint.loss(params)

        total = sum(out.values())
        metrics.update({f"loss/{k}": v for k, v in out.items()})
        metrics["loss/total"] = total
        return total, metrics

    # ------------------------------------------------------------------
    def init_state(self, params) -> dict:
        """Fresh state around copies of `params` (a tree of tensors or
        arrays), on the trainer's device in its dtype; rank 0's on every
        rank of the mesh."""
        params = replicate(self._tree_to_device(params), self.mesh)
        return {"params": params,
                "opt_state": self._opt_init(params),
                "ema_params": tree_map(torch.clone, params),
                "step": 0}

    def loss_and_grads(self, params, feats, labels, step: int):
        """-> ((loss, metrics), gradients w.r.t. every leaf of `params`),
        over microbatches where asked. Autograd is asked for the
        parameters only; a leaf the loss does not reach (the min-max
        statistics, a frozen bias) gets a zero gradient."""
        tp = self.train_parameters
        mb, bs = int(tp.microbatch_size or 0), int(tp.batch_size)
        if not (0 < mb < bs):
            out, grads = self._loss_and_grads(params, feats, labels, step)
            return out, self._sum_over_ranks(grads)
        n_chunks = bs // mb
        g_acc = m_acc = None
        for c in range(n_chunks):
            sel = slice(c * mb, (c + 1) * mb)
            (_, m), g = self._loss_and_grads(
                params, {k: v[sel] for k, v in feats.items()},
                {k: v[sel] for k, v in labels.items()}, step)
            g_acc = g if g_acc is None else tree_map(torch.add, g_acc, g)
            m_acc = m if m_acc is None else {k: m_acc[k] + m[k] for k in m}
        scale = 1.0 / n_chunks
        metrics = {k: v * scale for k, v in m_acc.items()}
        return ((metrics["loss/total"], metrics),
                self._sum_over_ranks(tree_map(lambda x: x * scale, g_acc)))

    def _sum_over_ranks(self, grads):
        """The ranks' gradient shares summed (one all-reduce)."""
        if self.mesh.group is None:
            return grads
        flat = tree_flatten(grads)
        return tree_unflatten(dict(zip(
            flat, all_reduce_many(list(flat.values()), self.mesh))))

    def _loss_and_grads(self, params, feats, labels, step):
        """This rank's share of the gradient (`_sum_over_ranks` completes
        it)."""
        flat = tree_flatten(params)
        leaves = {k: v.detach().requires_grad_() for k, v in flat.items()}
        n = self.mesh.size
        # Every backward of the step runs on this thread, not on the
        # device's worker thread: the nodes that a `create_graph` backward
        # makes are then numbered after the forward's from one counter, so
        # the engine runs them, and adds their gradients, in the same order
        # at every step, whatever the process ran before.
        with torch.enable_grad(), \
                torch.autograd.set_multithreading_enabled(False):
            loss, metrics = self.total_loss(tree_unflatten(leaves), feats,
                                            labels, step)
            target = loss if n == 1 else sum(
                v if k[5:] in _PREDICTED_TERMS else v / n
                for k, v in metrics.items()
                if k.startswith("loss/") and k != "loss/total")
            grads = torch.autograd.grad(target, list(leaves.values()),
                                        allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        metrics = {k: v.detach() if isinstance(v, torch.Tensor)
                   else torch.as_tensor(v, device=self.device)
                   for k, v in metrics.items()}
        return (metrics["loss/total"], metrics), tree_unflatten(grads)

    def train_step(self, state: dict, feats, labels
                   ) -> Tuple[dict, Dict[str, torch.Tensor]]:
        """One optimizer step: gradients -> update -> EMA with the
        ramped decay min(d, (1 + t) / (10 + t))."""
        step = int(state["step"])
        (_, metrics), grads = self.loss_and_grads(
            state["params"], feats, labels, step)
        params, opt_state = self._opt_update(
            grads, state["opt_state"], state["params"])
        # float32 arithmetic on the step, as the JAX package
        d32 = min(np.float32(self.train_parameters.ema_decay),
                  np.float32(1.0 + step) / np.float32(10.0 + step))
        d_t, rest = float(d32), float(np.float32(1.0) - d32)
        with torch.no_grad():
            ema = tree_map(lambda e, p: d_t * e + rest * p,
                           state["ema_params"], params)
        return ({"params": params, "opt_state": opt_state,
                 "ema_params": ema, "step": step + 1}, metrics)

    # ------------------------------------------------------------------
    def _eval_step(self, params, feats, labels):
        """-> (metrics of one batch, the denominator each is a mean
        over), so `evaluate` can combine batches exactly."""
        with torch.no_grad():
            preds = self.batched_predictions(params, feats)
            n_atoms = labels["n_atoms"]
            mask = feats["atom_masks"][:, 1:]
            diff_f = (labels["forces"][:, 1:] - preds["forces"][:, 1:]) \
                * mask[..., None]
            n_f = torch.clamp(torch.sum(mask) * 3.0, min=1.0)
            de = labels["energy"] - preds["energy"]
            ds = labels["stress"] - preds["stress_voigt"]
            s_norm = torch.linalg.norm(labels["stress"], dim=1)
            bsz = float(labels["energy"].shape[0])
            n_sl = torch.clamp(torch.sum(s_norm > 1e-8), min=1)
            out = {
                "energy/mae": torch.mean(torch.abs(de)),
                "energy/mse": torch.mean(torch.square(de)),
                "energy/mae/atom": torch.mean(torch.abs(de) / n_atoms),
                "energy/mse/atom": torch.mean(torch.square(de / n_atoms)),
                "forces/mae": torch.sum(torch.abs(diff_f)) / n_f,
                "forces/mse": torch.sum(torch.square(diff_f)) / n_f,
                "stress/mae": torch.mean(torch.abs(ds)),
                "stress/mse": torch.mean(torch.square(ds)),
                # relative stress RMSE, only over structures that carry
                # stress labels
                "stress/rel_rmse": torch.sum(torch.where(
                    s_norm > 1e-8,
                    torch.linalg.norm(ds, dim=1)
                    / torch.clamp(s_norm, min=1e-8),
                    torch.zeros_like(s_norm))) / n_sl,
            }
            # force metrics are per real force ENTRY, the relative
            # stress error per labeled structure, the rest per structure
            wts = {k: (n_f if k.startswith("forces/") else
                       n_sl.to(self.dtype) if k == "stress/rel_rmse"
                       else bsz) for k in out}
            if hasattr(self.model, "energy_ops"):
                if "eentropy" in labels and "eentropy" in preds:
                    out["eentropy/mae"] = torch.mean(torch.abs(
                        labels["eentropy"] - preds["eentropy"]))
                    wts["eentropy/mae"] = bsz
                if "free_energy" in labels and "free_energy" in preds:
                    out["free_energy/mae/atom"] = torch.mean(torch.abs(
                        labels["free_energy"] - preds["free_energy"])
                        / n_atoms)
                    wts["free_energy/mae/atom"] = bsz
        return out, wts

    def evaluate(self, params, feats, labels, batch_size: int = 0) -> dict:
        """Dataset-level metrics of `params` (a parameter tree): per-batch
        means combined by each metric's own denominator."""
        n = len(labels["energy"])
        if n == 0:
            return {}
        tp = self.train_parameters
        bs = batch_size or min(n, tp.batch_size)
        tf32 = (tp.eval_matmul_precision or "default") not in _FULL_PRECISION
        params = tree_map(lambda x: torch.as_tensor(
            x, device=self.device).to(self.dtype), params)
        sums, wsums = {}, {}
        with _tf32(tf32):
            for lo in range(0, n, bs):
                sel = slice(lo, min(lo + bs, n))
                out, wts = self._eval_step(
                    params,
                    self._to_device({k: v[sel] for k, v in feats.items()}),
                    self._to_device({k: v[sel] for k, v in labels.items()}))
                # one read of the batch's numbers
                keys = list(out)
                vals = torch.stack(
                    [out[k].to(torch.float64) for k in keys]
                    + [torch.as_tensor(wts[k], dtype=torch.float64,
                                       device=self.device) for k in keys]
                ).tolist()
                for i, k in enumerate(keys):
                    w = vals[len(keys) + i]
                    sums[k] = sums.get(k, 0.0) + vals[i] * w
                    wsums[k] = wsums.get(k, 0.0) + w
        return {k: sums[k] / max(wsums[k], 1e-12) for k in sums}

    # ------------------------------------------------------------------
    def init_params(self, train_feats, verbose: bool = True) -> dict:
        """Fresh parameters from `TrainParameters.seed`, with the min/max
        statistics swept over the WHOLE training set in chunks."""
        tp = self.train_parameters
        generator = torch.Generator().manual_seed(int(tp.seed))
        params = self.model.init_params(generator)
        if getattr(self.model, "minmax_scale", False):
            n_all = len(train_feats["atom_masks"])
            chunk = _norm_sweep_chunk(self.model, train_feats)
            if verbose:
                print(f"minmax sweep: {n_all} structures in chunks of "
                      f"{chunk}", flush=True)
            for lo in range(0, n_all, chunk):
                sample = self._to_device(
                    {k: v[lo:lo + chunk] for k, v in train_feats.items()})
                params = self.model.update_norm_stats(params, sample)
        return params

    def fit(self, train_feats, train_labels, test_feats=None,
            test_labels=None, params=None, verbose: bool = True,
            callback: Optional[Callable] = None,
            initial_state: Optional[dict] = None,
            eval_callback: Optional[Callable] = None) -> dict:
        """Run `train_steps` optimizer steps (from `initial_state`'s step
        on resume: the seeded batch stream is fast-forwarded, so the data
        order equals an uninterrupted run's). `callback(step, state,
        metrics)` is called once a block of `scan_steps` steps, and
        `eval_callback(step, state, metrics)` after each periodic
        evaluation of the EMA parameters on the test set."""
        tp = self.train_parameters
        verbose = verbose and self.mesh.is_main
        if params is None and initial_state is None:
            params = self.init_params(train_feats, verbose)
        bs = tp.batch_size
        start = 0
        if initial_state is not None:
            start = min(int(initial_state["step"]), tp.train_steps)
        state = initial_state or self.init_state(params)
        n_train = len(train_labels["energy"])
        k = max(int(tp.scan_steps or 1), 1)

        # the device-resident set serves one rank, as in the JAX package
        use_dev = bool(tp.device_dataset) and self.mesh.size == 1
        if use_dev:
            dev_bytes = sum(np.asarray(v).nbytes
                            for d in (train_feats, train_labels)
                            for v in d.values())
            if dev_bytes > float(tp.device_dataset_max_gb) * 1024 ** 3:
                if verbose:
                    print(f"device_dataset: padded set is "
                          f"{dev_bytes / 1024**3:.2f} GiB > "
                          f"{tp.device_dataset_max_gb:g} GiB cap "
                          f"(train.device_dataset_max_gb) — streaming "
                          f"batches from host instead")
                use_dev = False
        if use_dev:
            dev_feats = self._to_device(train_feats)
            dev_labels = self._to_device(train_labels)
            idx_it = batch_index_stream(n_train, bs, seed=tp.seed,
                                        repeat=True, skip=start)
        else:
            it = batches(train_feats, train_labels, bs, seed=tp.seed,
                         repeat=True, skip=start)

        def next_batch():
            if not use_dev:
                bf, bl = next(it)
                return self._to_device(bf), self._to_device(bl)
            sel = torch.as_tensor(next(idx_it), device=self.device)
            return ({key: v[sel] for key, v in dev_feats.items()},
                    {key: v[sel] for key, v in dev_labels.items()})

        history = []
        t0 = time.time()
        examples = 0
        # precision annealing switches by the block, as the JAX package:
        # at the first block whose start has reached the threshold
        f32_after = tp.train_steps - int(tp.final_f32_steps or 0)
        annealing = f32_after < tp.train_steps
        self.annealed_at = None
        for step in range(start, tp.train_steps, k):
            n_fused = min(k, tp.train_steps - step)
            anneal = annealing and step >= f32_after
            if anneal and self.annealed_at is None:
                self.annealed_at = step
                if verbose:
                    print(f"precision annealing at step {step}: "
                          "switching matmuls to f32", flush=True)
            with _tf32(False if anneal else None):
                for _ in range(n_fused):
                    state, metrics = self.train_step(state, *next_batch())
            examples += bs * n_fused
            step_now = step + n_fused - 1
            if verbose and (step_now + 1) % tp.log_steps < n_fused:
                m = {key: float(v) for key, v in metrics.items()}
                dt = time.time() - t0
                print(f"step {step_now + 1}: loss={m['loss/total']:.6f} "
                      f"e_mae/atom={m['energy/mae/atom']:.6f} "
                      f"f_mae={m.get('forces/mae', 0.0):.6f} "
                      f"({examples / dt:.1f} structures/s)")
            if callback is not None:
                callback(step_now, state, metrics)
            if test_feats is not None and len(test_labels["energy"]) and \
                    (step_now + 1) % tp.eval_steps < n_fused:
                ev = self.evaluate(state["ema_params"], test_feats,
                                   test_labels)
                history.append({"step": step_now + 1, **ev})
                if eval_callback is not None:
                    eval_callback(step_now + 1, state, ev)
                if verbose:
                    print(f"  eval@{step_now + 1}: " + " ".join(
                        f"{key}={v:.6f}" for key, v in ev.items()))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.state = state
        return {"state": state, "history": history,
                "throughput": examples / max(time.time() - t0, 1e-12)}

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str, state: dict, extra: dict = None):
        """Flat-npz checkpoint: params, EMA params, optimizer state and
        global step, under the JAX package's keys; written by rank 0
        only."""
        if not self.mesh.is_main:
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        flat = {}
        for prefix, key in (("params", "params"), ("ema", "ema_params")):
            flat.update({k: v.detach().cpu().numpy() for k, v in
                         tree_flatten(state[key], prefix).items()})
        if "opt_state" in state:
            flat.update(opt_state_to_flat(state["opt_state"],
                                          self.opt_parameters))
        flat["step"] = np.asarray(int(state["step"]), np.int32)
        np.savez(path, **flat)
        if extra:
            with open(path + ".json", "w") as fh:
                json.dump(extra, fh)

    @staticmethod
    def _read(path: str) -> Dict[str, np.ndarray]:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    def load_checkpoint(self, path: str) -> Tuple[dict, dict, int]:
        """-> (params, ema_params, step) of a checkpoint of either
        package, as trees on the trainer's device."""
        flat = self._read(path)
        return (self._tree_to_device(tree_unflatten(flat, "params")),
                self._tree_to_device(tree_unflatten(flat, "ema")),
                int(flat["step"]))

    def restore_state(self, path: str, use_ema_variables: bool = False,
                      restore_optimizer_variables: bool = True,
                      reset_global_step: bool = False) -> dict:
        """Warm start from a checkpoint of either package: pick raw or
        EMA weights, optionally restore the optimizer state (every slot
        of the rule in use, from the port's keys or an optax state's;
        a checkpoint written with another rule leaves it fresh),
        optionally reset the global step (which restarts the schedule
        and the bias corrections and keeps the restored moments)."""
        flat = self._read(path)
        params = tree_unflatten(
            flat, "ema" if use_ema_variables else "params")
        state = self.init_state(params)
        state["ema_params"] = self._tree_to_device(
            tree_unflatten(flat, "ema"))
        if restore_optimizer_variables:
            restored = opt_state_from_flat(flat, state["opt_state"])
            if restored is not None:
                state["opt_state"] = restored
        if not reset_global_step:
            state["step"] = int(flat["step"])
        elif restore_optimizer_variables:
            state["opt_state"]["count"] = 0
        return state

