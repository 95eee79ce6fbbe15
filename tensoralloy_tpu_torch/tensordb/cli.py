"""tensordb CLI — automatic training-database generation
(reference `tools/tensordb`, the TensorDB orchestrator).

    python -m tensoralloy_tpu_torch.tensordb [-i config.toml] <command>

Commands: sampling aimd | create {calc,porosity,neq,aging} |
status {sampling,calc,neq,porosity,aging,unsubmitted} | postprocess |
gather [-o FILE] | plot FILE [--rcut R] | purge.
"""
from __future__ import annotations

import sys
import tomllib
from argparse import ArgumentParser
from datetime import datetime
from pathlib import Path

import numpy as np

from .calculator import (VaspAgingCalculator, VaspCalculator,
                         VaspNonEquilibriumCalculator,
                         VaspPorousCalculator)
from .sampler import ExistedTrajectorySampler, VaspAimdSampler


class TensorDB:
    """Database-generation kit: samplers produce AIMD snapshots, the
    recompute calculators turn them into high-precision DFT tasks, and
    `gather` collects converged results into one extxyz."""

    def __init__(self, input_file):
        self.input_file = Path(input_file)
        if not self.input_file.exists():
            raise FileNotFoundError(f"config file {input_file} missing")
        self.root = self.input_file.parent
        with open(self.input_file, "rb") as fp:
            self.config = dict(tomllib.load(fp))
        self.samplers = {}
        if "aimd" in self.config:
            self.samplers["aimd"] = VaspAimdSampler(self.root,
                                                    self.config)
        if "external" in self.config or "trajectories" in self.config:
            self.samplers["external"] = ExistedTrajectorySampler(
                self.root, self.config)
        self.calculators = {"calc": VaspCalculator(self.root,
                                                   self.config)}
        if "porosity" in self.config:
            self.calculators["porosity"] = VaspPorousCalculator(
                self.root, self.config)
        if "neq" in self.config:
            self.calculators["neq"] = VaspNonEquilibriumCalculator(
                self.root, self.config)
        if "aging" in self.config:
            self.calculators["aging"] = VaspAgingCalculator(
                self.root, self.config)

    # ------------------------------------------------------------------
    def purge(self):
        for sampler in self.samplers.values():
            sampler.purge()
        for calc in self.calculators.values():
            calc.purge()

    def create_sampling_tasks(self, override: bool = False):
        for sampler in self.samplers.values():
            if hasattr(sampler, "create_tasks"):
                sampler.create_tasks(override=override)

    def update_sampling_status(self):
        for sampler in self.samplers.values():
            sampler.update_status()

    def list_unsubmitted_sampling_tasks(self):
        for name, sampler in self.samplers.items():
            for task in sampler.list_unsubmitted_tasks():
                print(f"[{name}] {task}")

    def post_process(self):
        for sampler in self.samplers.values():
            sampler.post_process()

    def create_accurate_dft_tasks(self, task: str):
        calc = self.calculators.get(task)
        if calc is None:
            raise ValueError(
                f"calculator {task!r} not initialized — add the "
                f"[{task}] section to {self.input_file.name}")
        calc.create_tasks(self.samplers)

    def update_accurate_dft_tasks_status(self, task: str):
        calc = self.calculators.get(task)
        if calc is None:
            raise ValueError(f"calculator {task!r} not initialized")
        calc.update_status()

    # ------------------------------------------------------------------
    def gather(self, output_file=None, check_job_status: bool = False):
        """Collect every converged recompute into one extxyz."""
        from ..io.extxyz import write_extxyz
        collected = []
        for calc in self.calculators.values():
            got = [calc.get_atoms(t, check_job_status)
                   for t in calc.task_iterator()]
            got = [s for s in got if s is not None]
            if got:
                print(f"[{type(calc).__name__}/gather]: "
                      f"{len(got)} structures")
            collected.extend(got)
        if output_file is None:
            outdir = self.root / "database"
            outdir.mkdir(exist_ok=True)
            date = datetime.now().strftime("%Y%m%d")
            output_file = outdir / f"vasp_N{len(collected)}_{date}.extxyz"
        write_extxyz(str(output_file), collected)
        print(f"gathered {len(collected)} -> {output_file}")
        return output_file

    # ------------------------------------------------------------------
    def plot(self, filename, figname=None, rcut: float = 6.0):
        """Dataset diagnostics: E/V, |F|/V, densities, pair RDF
        (reference `tools/tensordb` plot)."""
        import matplotlib
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt
        from scipy.stats import gaussian_kde
        from ..io.extxyz import read_extxyz
        from ..neighbor import neighbor_list

        filename = Path(filename)
        if filename.suffix == ".db":
            from ..io.sqlite import connect
            db = connect(str(filename))
            trajectory = [db.get(i + 1) for i in range(len(db))]
        else:
            trajectory = read_extxyz(str(filename))
        # per-structure rows padded with NaN so the scatter plots
        # stay INDEX-ALIGNED when some structures lack a label (a
        # conditional append would pair volume i with energy i+1)
        volumes, energies, fnorms, pressures, temps = [], [], [], [], []
        rdf = {}
        k_b = 8.617333262e-5
        for s in trajectory:
            n = len(s)
            volumes.append(s.volume / n)
            energies.append(s.energy / n
                            if s.energy is not None else np.nan)
            fnorms.append(float(np.sqrt(np.sum(s.forces ** 2) / n))
                          if s.forces is not None else np.nan)
            pressures.append(
                float(-np.mean(s.stress[:3]) * 160.2176)
                if s.stress is not None else np.nan)
            if self.config.get("finite_temperature", False):
                et = s.info.get("etemperature")
                temps.append(float(et) / k_b
                             if et is not None else np.nan)
            syms = np.asarray(s.symbols)
            ii, jj, _, d, _ = neighbor_list(s, rcut)
            for a, b, dd in zip(syms[ii], syms[jj], d):
                rdf.setdefault(tuple(sorted((a, b))), []).append(dd)

        def density_plot(ax, data, label, xlabel):
            data = np.asarray(data)
            if len(data) > 2 and data.std() > 0:
                kde = gaussian_kde(data)
                x = np.linspace(data.min(), data.max(), 100)
                ax.plot(x, kde(x), label=label)
            ax.set_xlabel(xlabel)
            ax.set_ylabel("Scaled Density")

        _, axes = plt.subplots(2, 3, figsize=(12, 7))
        axes[0, 0].plot(volumes, energies, "o", markersize=2)
        axes[0, 0].set_xlabel(r"Volume ($\AA^3$)")
        axes[0, 0].set_ylabel("Energy (eV/atom)")
        axes[0, 1].plot(volumes, fnorms, "o", markersize=2)
        axes[0, 1].set_xlabel(r"Volume ($\AA^3$)")
        axes[0, 1].set_ylabel(r"Force norm (eV/$\AA$)")
        density_plot(axes[0, 2], volumes, "Volume", r"Volume ($\AA^3$)")
        have_p = bool(np.isfinite(pressures).any()) \
            if pressures else False
        if temps:
            axes[1, 0].plot(volumes, temps, "o", markersize=2)
            axes[1, 0].set_xlabel(r"Volume ($\AA^3$)")
            axes[1, 0].set_ylabel("Temperature (K)")
        elif have_p:
            axes[1, 0].plot(pressures, energies, "o", markersize=2)
            axes[1, 0].set_xlabel("Pressure (GPa)")
            axes[1, 0].set_ylabel("Energy (eV/atom)")
        if have_p:
            axes[1, 1].plot(pressures, fnorms, "o", markersize=2)
            axes[1, 1].set_xlabel("Pressure (GPa)")
            axes[1, 1].set_ylabel(r"Force norm (eV/$\AA$)")
        ax = axes[1, 2]
        for key, dists in rdf.items():
            dists = np.asarray(dists)
            if len(dists) > 2:
                kde = gaussian_kde(dists, weights=1.0 / dists)
                x = np.linspace(0, rcut, 100)
                ax.plot(x, kde(x), label=f"{key[0]}-{key[1]}")
        ax.legend()
        ax.set_xlabel(r"Distance ($\AA$)")
        ax.set_ylabel("Scaled Density")
        plt.tight_layout()
        if figname is None:
            figname = filename.with_suffix(".png")
        plt.savefig(figname, dpi=150)
        plt.close()
        print(f"wrote {figname}")
        return figname


def main(argv=None):
    parser = ArgumentParser(prog="tensoralloy_tpu_torch.tensordb",
                            description=__doc__)
    parser.add_argument("-i", "--input", default="config.toml")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("sampling")
    p.add_argument("--override", action="store_true",
                   help="reset existing task status/inputs (DANGER: "
                        "rewrites submitted/running tasks)")
    p.add_argument("type", choices=["aimd"])
    p = sub.add_parser("create")
    p.add_argument("task", choices=["calc", "porosity", "neq", "aging"])
    p = sub.add_parser("status")
    p.add_argument("type", choices=["sampling", "calc", "neq",
                                    "porosity", "aging", "unsubmitted"])
    sub.add_parser("postprocess")
    p = sub.add_parser("gather")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--check-job-status", action="store_true")
    p = sub.add_parser("plot")
    p.add_argument("filename", type=Path)
    p.add_argument("--rcut", type=float, default=6.0)
    sub.add_parser("purge")
    args = parser.parse_args(argv)

    db = TensorDB(args.input)
    if args.command == "sampling":
        db.create_sampling_tasks(override=args.override)
    elif args.command == "create":
        db.create_accurate_dft_tasks(args.task)
    elif args.command == "status":
        if args.type == "sampling":
            db.update_sampling_status()
        elif args.type == "unsubmitted":
            db.list_unsubmitted_sampling_tasks()
        else:
            db.update_accurate_dft_tasks_status(args.type)
    elif args.command == "postprocess":
        db.post_process()
    elif args.command == "gather":
        db.gather(args.output, check_job_status=args.check_job_status)
    elif args.command == "plot":
        db.plot(args.filename, rcut=args.rcut)
    elif args.command == "purge":
        db.purge()
    return 0


if __name__ == "__main__":
    sys.exit(main())
