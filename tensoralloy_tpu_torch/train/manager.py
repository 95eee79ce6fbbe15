"""TrainingManager: TOML experiment -> dataset -> model -> training ->
export (port of `tensoralloy_tpu/train/manager.py`).

The same attributes and methods, built from the same keys with the same
defaults. What differs follows from PyTorch: the file's `precision`
('high' | 'medium') becomes the explicit dtype of the dataset, the model
and the trainer (no global is set), the device is the `device` argument
(the card unless the caller passes "cpu"), and a fresh start draws its
parameters from a `torch.Generator` seeded with `seed`. As in the JAX
manager, the dataset emits the layout the model reads: the flat pair
and triple arrays for the EAM family and the descriptors' 'segment'
backend (the default), the dense rows for 'dense' and 'pallas'. The
constraint losses named under `nn.minimize` are built as the JAX manager
builds them, and `export` writes the EAM family's setfl file beside the
`.npz`. Several devices are not ported yet: `distribute.num_devices`
above 1 raises `NotImplementedError` when the manager is built.
"""
from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..io.input import InputReader
from ..io.sqlite import connect
from ..nn import losses as loss_ops
from ..transform.featurizer import Featurizer
from . import hooks as hook_ops
from .dataset import Dataset
from .trainer import OptParameters, TrainParameters, Trainer

def _not_ported(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to tensoralloy_tpu_torch yet; it comes "
        f"with {slice_name}")


@dataclass
class PairStyle:
    """Parsed `pair_style`."""
    category: str       # 'atomic' | 'td' | 'eam'
    model: str          # 'sf' | 'grap' | 'alloy' | 'fs' | 'adp'
    angular: bool = False

    @classmethod
    def parse(cls, value: str) -> "PairStyle":
        parts = value.split("/")
        category = parts[0]
        if category == "eam":
            return cls("eam", parts[1])
        angular = len(parts) > 2 and parts[2] == "angular"
        return cls(category, parts[1], angular)

    @property
    def finite_temperature(self) -> bool:
        return self.category == "td"


class TrainingManager:
    """End-to-end experiment orchestration."""

    def __init__(self, input_file, validate: bool = True, *,
                 device="cuda"):
        self.reader = (input_file if isinstance(input_file, InputReader)
                       else InputReader(input_file, validate=validate))
        r = self.reader
        self.precision = r["precision"]
        self.pair_style = PairStyle.parse(r["pair_style"])
        n_devices = r.get("distribute.num_devices", 0) or None
        if r.get("distribute.strategy", "off") in ("off", "one_device"):
            n_devices = 1
        if n_devices not in (None, 1):
            raise _not_ported(f"distribute.num_devices={n_devices}",
                              "the parallel/ slice")
        self.db = connect(r["dataset.sqlite3"])
        self.elements = self.db.elements

        angular = self.pair_style.angular
        self.featurizer = Featurizer(
            self.elements, rcut=r["rcut"],
            acut=r["acut"] if angular else None, angular=angular)

        dtype = np.float64 if self.precision == "high" else np.float32
        # emit only the layout the descriptor backend reads; the EAM
        # family computes its geometry from the flat pair arrays
        if self.pair_style.model in ("sf", "grap"):
            backend = r.get(f"nn.atomic.{self.pair_style.model}.backend",
                            "dense") or "dense"
            layout = "segment" if backend == "segment" else "dense"
        else:
            layout = "segment"
        # the transpose tables for the scatter-free force assembly are
        # emitted only when the file asks for `force_assembly = 'dense'`
        # (they change the cache schema); 'auto' then resolves to the
        # dense path in the trainer because the tables exist
        fa = str(r.get("train.force_assembly", "auto") or "auto")
        if fa == "dense" and layout != "dense":
            raise ValueError(
                "train.force_assembly='dense' requires a dense/pallas "
                f"descriptor backend (pair_style {r['pair_style']!r} "
                "uses the flat segment layout)")
        self.dataset = Dataset(
            self.db, self.featurizer, name=r["dataset.name"],
            test_size=r["dataset.test_size"], seed=r["seed"], dtype=dtype,
            cache_dir=r["dataset.tfrecords_dir"], layout=layout,
            transpose=(fa == "dense"))

        self.model = self._build_model()
        self.constraints = self._build_constraints()
        self.loss_parameters = self._build_loss_parameters()
        self.opt_parameters = self._build_opt_parameters()
        self.train_parameters = self._build_train_parameters()
        self.trainer = Trainer(
            self.model, self.loss_parameters, self.opt_parameters,
            self.train_parameters,
            minimize_properties=tuple(
                p for p in r["nn.minimize"]
                if p in ("energy", "forces", "stress", "total_pressure",
                         "eentropy", "free_energy")),
            n_devices=n_devices, constraints=self.constraints,
            device=device, dtype=self.precision)
        self._last_state: Optional[dict] = None

    def _build_constraints(self) -> list:
        """The constraint losses named in `nn.minimize`, each with its
        section's options; crystal files resolve against the database's
        directory."""
        from ..nn import constraints as C
        r = self.reader
        base_dir = os.path.dirname(os.path.abspath(r["dataset.sqlite3"]))
        minimize = r["nn.minimize"]
        out = []
        if "elastic" in minimize and r.get("nn.loss.elastic.crystals"):
            ec = r.get("nn.loss.elastic.constraint", {})
            out.append(C.ElasticConstraint(
                self.model, r["nn.loss.elastic.crystals"],
                weight=r.get("nn.loss.elastic.weight", 0.1),
                options=C.ElasticConstraintOptions(
                    use_kbar=ec.get("use_kbar", True),
                    forces_weight=ec.get("forces_weight", 1.0),
                    stress_weight=ec.get("stress_weight", 0.1),
                    tau=ec.get("tau", 1.0)),
                base_dir=base_dir))
        if "rose" in minimize and r.get("nn.loss.rose.crystals"):
            out.append(C.RoseConstraint(
                self.model, C.RoseConstraintOptions(
                    crystals=r["nn.loss.rose.crystals"],
                    weight=r.get("nn.loss.rose.weight", 1.0),
                    beta=r.get("nn.loss.rose.beta", []),
                    dx=r.get("nn.loss.rose.dx", 0.01),
                    xlo=r.get("nn.loss.rose.xlo", 0.90),
                    xhi=r.get("nn.loss.rose.xhi", 1.02),
                    p_target=r.get("nn.loss.rose.p_target", []),
                    E_target=r.get("nn.loss.rose.E_target", [])),
                base_dir=base_dir))
        if "ediff" in minimize and r.get("nn.loss.ediff.crystals"):
            out.append(C.EnergyDifferenceConstraint(
                self.model,
                references=r.get("nn.loss.ediff.references", []),
                crystals=r.get("nn.loss.ediff.crystals", []),
                diffs=r.get("nn.loss.ediff.diff", []),
                weight=r.get("nn.loss.ediff.weight", 1.0),
                method=r.get("nn.loss.ediff.method", "mae"),
                base_dir=base_dir))
        if "eentropy/c" in minimize and \
                r.get("nn.loss.eentropy_constraint.crystals"):
            out.append(C.EntropyConstraint(
                self.model, r["nn.loss.eentropy_constraint.crystals"],
                weight=r.get("nn.loss.eentropy_constraint.weight", 1.0),
                base_dir=base_dir))
        if "hessian/c" in minimize and \
                r.get("nn.loss.hessian_constraint.crystals"):
            out.append(C.ForceConstantsConstraint(
                self.model, r["nn.loss.hessian_constraint.crystals"],
                weight=r.get("nn.loss.hessian_constraint.weight", 1.0),
                forces_weight=r.get(
                    "nn.loss.hessian_constraint.forces_weight", 1.0),
                base_dir=base_dir))
        if "extra/c" in minimize and \
                r.get("nn.loss.extra_constraint.filename") and \
                os.path.exists(r["nn.loss.extra_constraint.filename"]):
            out.append(C.ExtraDatabaseConstraint(
                self.model, r["nn.loss.extra_constraint.filename"],
                weight=r.get("nn.loss.extra_constraint.weight", 1.0),
                minimize=r.get("nn.loss.extra_constraint.minimize",
                               ["energy"])))
        return out

    # ------------------------------------------------------------------
    def _build_model(self):
        r = self.reader
        ps = self.pair_style
        if ps.category == "eam":
            return self._build_eam_model()
        if ps.model == "sf":
            from ..nn.sf import SymmetryFunction
            sf = r.get("nn.atomic.sf", {})
            descriptor = SymmetryFunction(
                self.elements, eta=sf.get("eta"), omega=sf.get("omega"),
                beta=sf.get("beta"), gamma=sf.get("gamma"),
                zeta=sf.get("zeta"),
                cutoff_function=sf.get("cutoff_function", "cosine"),
                backend=sf.get("backend", "segment"))
        else:
            from ..nn.grap import GenericRadialAtomicPotential
            g = r.get("nn.atomic.grap", {})
            algo = g.get("algorithm", "pexp")
            if "@" in algo:  # named preset bank, e.g. 'pexp@medium'
                from ..linear.preset import get_filter_preset
                cfg = get_filter_preset(algo)
                algo = cfg["algorithm"]
                parameters = cfg["parameters"]
                g = dict(g, param_space_method=cfg["param_space_method"])
            else:
                parameters = r.get(f"nn.atomic.grap.{algo}", {})
            descriptor = GenericRadialAtomicPotential(
                self.elements, algorithm=algo, parameters=parameters,
                param_space_method=g.get("param_space_method", "pair"),
                moment_tensors=g.get("moment_tensors", 0),
                cutoff_function=g.get("cutoff_function", "cosine"),
                symmetric=g.get("symmetric", False),
                legacy_mode=g.get("legacy_mode", False),
                backend=g.get("backend", "segment"))

        layers = r.get("nn.atomic.layers", {}) or None
        static = (self.db.get_atomic_static_energy()
                  if r["nn.atomic.use_atomic_static_energy"] else None)
        kwargs = dict(
            hidden_sizes=layers,
            activation=r["nn.atomic.activation"],
            use_resnet_dt=r["nn.atomic.use_resnet_dt"],
            minmax_scale=r["nn.atomic.minmax_scale"],
            atomic_static_energy=static,
            fixed_static_energy=r["nn.atomic.fixed_atomic_static_energy"],
            kernel_initializer=r["nn.atomic.kernel_initializer"])
        if ps.finite_temperature:
            from ..nn.finite_temperature import TemperatureDependentAtomicNN
            ft = r.get("nn.atomic.finite_temperature", {})
            return TemperatureDependentAtomicNN(
                self.featurizer, self.dataset.max_occurs, descriptor,
                layers=ft.get("layers", [128, 128]),
                eentropy_algo=ft.get("algo", "default"),
                ft_activation=ft.get("activation", "softplus"),
                **kwargs)
        from ..nn.atomic import AtomicNN
        return AtomicNN(self.featurizer, self.dataset.max_occurs,
                        descriptor, **kwargs)

    def _build_eam_model(self):
        from ..nn.eam import AdpNN, EamAlloyNN, EamFsNN
        r = self.reader
        cls = {"alloy": EamAlloyNN, "fs": EamFsNN, "adp": AdpNN}[
            self.pair_style.model]
        custom, hidden = {}, {}
        for fkey in ("rho", "embed", "phi", "dipole", "quadrupole"):
            table = r.get(f"nn.eam.{fkey}", {}) or {}
            for section, value in table.items():
                if isinstance(value, list):
                    custom.setdefault(section, {})[fkey] = "nn"
                    hidden.setdefault(section, {})[fkey] = list(value)
                else:
                    custom.setdefault(section, {})[fkey] = value
        return cls(self.featurizer, self.dataset.max_occurs,
                   custom_potentials=custom or None,
                   hidden_sizes=hidden or None,
                   activation=r["nn.atomic.activation"],
                   fixed_functions=r.get("nn.eam.fixed_functions", []),
                   use_resnet_dt=False)

    # ------------------------------------------------------------------
    def _loss_options(self, section: str) -> loss_ops.LossOptions:
        r = self.reader
        return loss_ops.LossOptions(
            weight=r.get(f"nn.loss.{section}.weight", 1.0),
            method=r.get(f"nn.loss.{section}.method", "rmse"),
            per_atom_loss=r.get(f"nn.loss.{section}.per_atom_loss", False),
            logscaled_dynamic_weight=r.get(
                f"nn.loss.{section}.logscaled_dynamic_weight", False))

    def _build_loss_parameters(self) -> loss_ops.LossParameters:
        r = self.reader
        asw = r.get("nn.loss.adaptive_sample_weight", {})
        return loss_ops.LossParameters(
            energy=self._loss_options("energy"),
            forces=self._loss_options("forces"),
            stress=self._loss_options("stress"),
            total_pressure=self._loss_options("total_pressure"),
            eentropy=self._loss_options("eentropy"),
            free_energy=self._loss_options("free_energy"),
            l2=loss_ops.L2LossOptions(
                weight=r.get("nn.loss.l2.weight", 0.0),
                decayed=r.get("nn.loss.l2.decayed", False),
                decay_rate=r.get("nn.loss.l2.decay_rate", 0.99),
                decay_steps=r.get("nn.loss.l2.decay_steps", 10)),
            adaptive_sample_weight=loss_ops.AdaptiveSampleWeightOptions(
                enabled=asw.get("enabled", False),
                metric=asw.get("metric", "fmax"),
                method=asw.get("method", "sigmoid"),
                params=asw.get("params", [1.0, 1.0, 1.0, 1.0]),
                normalized=asw.get("normalized", True)))

    def _build_opt_parameters(self) -> OptParameters:
        r = self.reader
        method = r["opt.method"]
        decay_fn = r.get("opt.decay_function")
        if decay_fn in (False, "false"):
            decay_fn = None
        return OptParameters(
            method=method,
            learning_rate=r["opt.learning_rate"],
            decay_function=decay_fn,
            decay_rate=r.get("opt.decay_rate", 0.95),
            decay_steps=r.get("opt.decay_steps", 1000),
            staircase=r.get("opt.staircase", False),
            beta1=r.get(f"opt.{method}.beta1", 0.9),
            beta2=r.get(f"opt.{method}.beta2", 0.999),
            weight_decay=r.get("opt.adamw.decay", 0.0) or 0.0,
            rho=r.get("opt.adadelta.rho", 0.95),
            momentum=r.get(f"opt.{method}.momentum", 0.9),
            use_nesterov=r.get("opt.sgd.use_nesterov", True),
            clip_norm=r.get("opt.clip_norm", 0.0) or 0.0)

    def _build_train_parameters(self) -> TrainParameters:
        r = self.reader
        return TrainParameters(
            batch_size=r["train.batch_size"],
            train_steps=r["train.train_steps"],
            eval_steps=r["train.eval_steps"],
            summary_steps=r["train.summary_steps"],
            log_steps=r["train.log_steps"],
            max_checkpoints_to_keep=r["train.max_checkpoints_to_keep"],
            ema_decay=r.get("train.ema_decay", 0.999),
            scan_steps=int(r.get("train.scan_steps", 1) or 1),
            device_dataset=bool(r.get("train.device_dataset", True)),
            device_dataset_max_gb=float(
                r.get("train.device_dataset_max_gb", 6.0)),
            eval_matmul_precision=str(
                r.get("train.eval_matmul_precision", "highest")),
            final_f32_steps=int(r.get("train.final_f32_steps", 0) or 0),
            force_assembly=str(
                r.get("train.force_assembly", "auto") or "auto"),
            microbatch_size=int(
                r.get("train.microbatch_size", 0) or 0),
            seed=r["seed"],
            model_dir=r["train.model_dir"])

    # ------------------------------------------------------------------
    @property
    def model_dir(self) -> str:
        return self.train_parameters.model_dir

    def _initial_state(self) -> Optional[dict]:
        """The state to start from: the warm start that
        `train.ckpt.checkpoint_filename` names, if that file exists;
        else the newest periodic checkpoint of an unfinished run in
        `model_dir` (crash auto-resume, continued exactly: raw weights,
        optimizer state and step); else None, a fresh start. A finished
        run (checkpoint step >= train_steps) starts fresh; delete
        `model_dir` to force a restart of an unfinished one."""
        ckpt_cfg = self.reader.get("train.ckpt", {})
        ckpt_file = ckpt_cfg.get("checkpoint_filename")
        if ckpt_file and os.path.exists(str(ckpt_file)):
            return self.trainer.restore_state(
                str(ckpt_file),
                use_ema_variables=ckpt_cfg.get("use_ema_variables", True),
                restore_optimizer_variables=ckpt_cfg.get(
                    "restore_optimizer_variables", True),
                reset_global_step=self.reader.get(
                    "train.reset_global_step", True))
        latest = hook_ops.latest_checkpoint(self.model_dir)
        if latest:
            step = int(re.search(r"ckpt-(\d+)\.npz$", latest).group(1))
            if step < self.train_parameters.train_steps:
                return self.trainer.restore_state(
                    latest, use_ema_variables=False,
                    restore_optimizer_variables=True,
                    reset_global_step=False)
        return None

    def train_and_evaluate(self, verbose: bool = True) -> dict:
        """Featurize, split, fit; checkpoint + history into model_dir."""
        os.makedirs(self.model_dir, exist_ok=True)
        # back up the input config + record the pid for `stop`
        with open(os.path.join(self.model_dir, "input.json"), "w") as fh:
            json.dump(self.reader.as_dict(), fh, indent=2, default=str)
        with open(os.path.join(self.model_dir, "run.pid"), "w") as fh:
            fh.write(str(os.getpid()))

        feats, labels = self.dataset.build(verbose=verbose)
        tf_, tl_, ef_, el_ = self.dataset.split(feats, labels)
        initial_state = self._initial_state()

        r = self.reader
        tp = self.train_parameters
        hooks = [hook_ops.NanTensorHook()]
        hooks.append(hook_ops.CheckpointHook(
            self.trainer, self.model_dir, every_steps=tp.eval_steps,
            keep=tp.max_checkpoints_to_keep))
        if r.get("train.profile_steps", 0):
            hooks.append(hook_ops.ProfilerHook(
                self.model_dir + "-profile",
                every_steps=r["train.profile_steps"]))
        hooks.append(hook_ops.ExamplesPerSecondHook(
            tp.batch_size, every_steps=tp.log_steps))
        hooks.append(hook_ops.LoggingTensorHook(
            every_steps=tp.summary_steps,
            jsonl_path=os.path.join(self.model_dir, "metrics.jsonl")))
        callback = hook_ops.compose_hooks(hooks)
        eval_callback = None
        if r.get("train.keep_best_checkpoint", True):
            best_hook = hook_ops.BestCheckpointHook(
                self.trainer, self.model_dir,
                metric=str(r.get("train.best_metric", "energy/mae/atom")))
            eval_callback = best_hook.after_eval
        try:
            result = self.trainer.fit(tf_, tl_, ef_, el_, verbose=verbose,
                                      callback=callback,
                                      initial_state=initial_state,
                                      eval_callback=eval_callback)
        finally:
            for hook in hooks:
                hook.end()
        state = result["state"]
        self.trainer.save_checkpoint(
            os.path.join(self.model_dir, "checkpoint.npz"), state)
        with open(os.path.join(self.model_dir, "history.json"), "w") as fh:
            json.dump(result["history"], fh, indent=2)
        self._last_state = state
        return result

    def export(self, state: Optional[dict] = None,
               use_ema: bool = True) -> str:
        """Save the deployable model (and, for the EAM family, its LAMMPS
        setfl file beside it); -> the `.npz` path."""
        from ..io.model import save_model
        state = state or self._last_state
        if state is None:
            raise RuntimeError("nothing trained yet")
        params = state["ema_params"] if use_ema else state["params"]
        name = self.reader["dataset.name"]
        path = os.path.join(self.model_dir, f"{name}.npz")
        save_model(path, self.model, params)
        if self.pair_style.category == "eam":
            r = self.reader
            style = self.pair_style.model
            setfl = os.path.join(
                self.model_dir,
                f"{name}.adp" if style == "adp" else f"{name}.{style}.eam")
            nrho = r.get("nn.eam.setfl.nrho", 2000)
            self.model.export_to_setfl(
                setfl, params, nr=r.get("nn.eam.setfl.nr", 2000), nrho=nrho,
                rho_max=nrho * r.get("nn.eam.setfl.drho", 0.05))
        return path
