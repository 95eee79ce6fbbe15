"""MD cells of the EAM family: Langevin (BAOAB) dynamics of one large
jittered crystal through the program's `VelocityVerlet` on its device
neighbour list, with the family's analytic energy-and-forces pass
(`fast_efs="auto"`) in place of autograd.

The run is `md.py`'s: set-up loads the model, makes the lattice from
the seed, builds the integrator and runs `warm_chunks` chunks, the last
of which sizes the window, a whole number of chunks run by one
`VelocityVerlet.run`. A traced run profiles the window on the card
alone, with CUDA events around every analytic pass (the host range
`md.fast_efs`) and every list build, then `trace_chunks` more chunks
with the host's ops for the idle gaps.

`correct` compares as `md.py` does: the last chunk of the window run
again by the plain reference (`reference/<family>.py`) from the
program's state at its start, and the velocities drawn at the start.

Also recorded, where the program counts them: the analytic passes the
window ran (`fast_efs.pass_counts`, by the model's tag; a chunk of n
steps runs n + 2: its start, its steps and its end) and the descriptor
kernels it launched (`ops.fused.launch_counts`, none on this route).
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import sys
import time

import numpy as np

from .. import generate, lattice
from ..common import ROOT, Check, Context, Run
from ..reference import md as ref_md
from ..trace import Profiled, host_range, idle_gaps_of
from ..work import adp as work_adp
from ..work.peaks import bound_s
from .md import _list_sizes, _Probe, _sync


class _Passes:
    """CUDA events and the host range `md.fast_efs` around each call of
    the integrator's analytic pass inside the window (traced runs), and
    the sizes of each window build's lists within the angular cutoff."""

    def __init__(self, md, probe: _Probe, near_rcut: float):
        import torch
        self.events, self.near = [], []
        fast, build = md._fast_fn, probe._class.build

        def timed(features, params=None):
            if not probe.open:
                return fast(features, params)
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
            with host_range("md.fast_efs"):
                out = fast(features, params)
            end.record()
            self.events.append((begin, end))
            return out

        def sized(nl, positions, cell=None, etemperature=0.0):
            feats, diag = build(nl, positions, cell, etemperature)
            if probe.open:
                self.near.append(_list_sizes(feats, near_rcut)["pairs"])
            return feats, diag

        md._fast_fn = timed
        probe._class.build = sized


def _counters() -> dict:
    """The program's counts of analytic passes and descriptor launches,
    copied; {} of a program that keeps no such count."""
    out = {}
    for module, name in (("tensoralloy_tpu_torch.nn.eam.fast_efs",
                          "pass_counts"),
                         ("tensoralloy_tpu_torch.ops.fused",
                          "launch_counts")):
        counts = getattr(importlib.import_module(module), name, None)
        if counts is not None:
            out[name] = dict(counts)
    return out


def _delta(after: dict, before: dict) -> dict:
    return {name: {k: v - before[name].get(k, 0) for k, v in counts.items()}
            for name, counts in after.items()}


def run(ctx: Context) -> Run:
    import torch
    from tensoralloy_tpu_torch.atoms import Structure
    from tensoralloy_tpu_torch.dynamics import VelocityVerlet
    from tensoralloy_tpu_torch.io.model import load_model
    from tensoralloy_tpu_torch.precision import set_tf32
    cfg, tr, out = ctx.config, ctx.traffic, Run()
    ref = importlib.import_module(f"portbench.reference.{cfg['family']}")
    weights = str(ROOT / cfg["weights"])
    params = ref.params_from_npz(weights, cfg["element"])
    if ctx.control:
        set_tf32(True)
    model, _ = load_model(weights, device=ctx.device, dtype="medium")
    pos, cell = lattice.jittered_bcc(tr["reps"], tr["a"], tr["jitter"],
                                     ctx.seed)
    n_atoms = len(pos)
    structure = Structure.from_symbols([cfg["element"]] * n_atoms, pos, cell,
                                       pbc=[True] * 3)
    md_seed = generate.legacy_seed(ctx.seed)
    md = VelocityVerlet(model, structure, timestep=tr["timestep"],
                        skin=tr["skin"], chunk_size=tr["chunk_size"],
                        temperature=tr["temperature"], seed=md_seed,
                        target_temperature=tr["temperature"],
                        friction=tr["friction"], device_nl=True,
                        fast_efs="auto")
    v_start = md.velocities_vap[md.vap.local_to_vap].copy()
    probe = _Probe(md, ctx.trace, cfg["rcut"])
    passes = (_Passes(md, probe, params["mishinh"]["rc"]) if ctx.trace
              else None)
    chunk = tr["chunk_size"]
    try:
        for _ in range(tr["warm_chunks"]):
            t = time.perf_counter()
            md.run(chunk)
            _sync(ctx.device)
            last = time.perf_counter() - t
        n_chunks = max(2, int(round(ctx.seconds / last)))
        regrows = md.regrows
        probe.open = True
        _sync(ctx.device)
        before = _counters()
        with (Profiled() if ctx.trace else contextlib.nullcontext()) as prof:
            out.setup_end = time.perf_counter()
            history = md.run(n_chunks * chunk)
            _sync(ctx.device)
            out.window_s = time.perf_counter() - out.setup_end
        counted = _delta(_counters(), before)
        probe.open = False
        window_last = probe.accepted
        if ctx.trace:
            prof.window_s = out.window_s
            prof.idle_gaps = idle_gaps_of(
                lambda: md.run(tr["trace_chunks"] * chunk))
    finally:
        probe.close()
    steps = n_chunks * chunk
    out.trace = prof
    out.attempted = steps
    out.failed = chunk * int(np.sum(~np.isfinite(history["total"])))
    out.values["md_throughput"] = n_atoms * steps / out.window_s / 1e6
    out.values["steps"] = steps
    out.values["host_ms_per_step"] = 1e3 * probe.enqueue_s / steps
    if str(ctx.device).startswith("cuda"):
        out.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    _report(out, counted, (n_chunks + md.regrows - regrows) * (chunk + 2),
            model.tag)
    if ctx.trace:
        _work(out, probe, passes, n_atoms, steps, n_chunks)

    start, result = window_last
    rows = torch.as_tensor(md.vap.local_to_vap.astype(np.int64),
                           device=start[0].device)
    n_vap = int(md.model.n_atoms_vap)
    prog = {"vel": result[1][rows], "pe": float(result[3])}
    del md, model, probe, passes, history, result, window_last
    gc.collect()
    if str(ctx.device).startswith("cuda"):
        torch.cuda.empty_cache()
    t = time.perf_counter()
    out.checks = _compare(ctx, ref, params, start, rows, n_vap, prog, v_start,
                          md_seed)
    out.values["reference_s"] = time.perf_counter() - t
    return out


def _report(out: Run, counted: dict, expected: int, tag: str) -> None:
    """The window's analytic passes and descriptor launches into the
    record and to standard error, where the program counts them."""
    passes = counted.get("pass_counts")
    launches = counted.get("launch_counts")
    if passes is not None:
        out.values["pass_counts"] = passes
    if launches is not None:
        out.values["descriptor_launches"] = sum(launches.values())
    if passes is not None or launches is not None:
        print(f"md_eam: analytic passes {passes} in the window, "
              f"{expected} {tag} expected; descriptor kernel launches "
              f"{out.values.get('descriptor_launches')}", file=sys.stderr)


def _work(out: Run, probe: _Probe, passes: _Passes, n_atoms: int,
          steps: int, n_chunks: int) -> None:
    """Build and pass times from their events, and the frozen work of the
    window from the mean sizes of its lists."""
    import torch
    torch.cuda.synchronize()
    if probe.builds:
        out.values["nl_build_ms"] = float(np.mean(
            [b.elapsed_time(e) for b, e, _ in probe.builds]))
    if not probe.builds or not passes.events:
        return
    pairs = float(np.mean([float(s["pairs"][2]) for *_, s in probe.builds]))
    near = float(np.mean([float(real) for *_, real in passes.near]))
    force = work_adp.efs_pass(n_atoms, pairs, near, "force")
    energy = work_adp.efs_pass(n_atoms, pairs, near, "energy")
    out.values["adp_efs_ms"] = float(np.mean(
        [b.elapsed_time(e) for b, e in passes.events]))
    out.values["adp_efs_bound_ms"] = 1e3 * bound_s(*force)
    # useful work: one force evaluation a step, one energy a chunk end
    out.useful_flop = steps * force[1] + n_chunks * energy[1]


def _compare(ctx: Context, ref, params: dict, start, rows, n_vap: int,
             prog: dict, v_start: np.ndarray, md_seed: int) -> list:
    import torch
    cfg, tr = ctx.config, ctx.traffic
    pos0, vel0, cell0, gen_state, steps = start
    n = len(rows)
    device = pos0.device
    masses = np.full(n, cfg["mass_amu"])
    v_ref0 = ref_md.maxwell_boltzmann(masses, tr["temperature"], md_seed)
    potential = ref.Cell(params, cfg["rcut"], cell0,
                         margin=tr["reference_margin"])
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    _, vel, energy = ref_md.baoab_chunk(
        potential, pos0[rows], vel0[rows],
        torch.as_tensor(masses, dtype=pos0.dtype, device=device), steps,
        tr["timestep"], tr["temperature"], tr["friction"], gen, n_vap, rows)

    def rms(x):
        return torch.sqrt(torch.mean(torch.sum(x * x, dim=1)))
    limits = tr["limits"]
    return [
        Check("start_velocity_gap", float(np.max(np.abs(v_start - v_ref0))),
              limits["start_velocity_gap"]),
        Check("velocity_rms_gap", float(rms(prog["vel"] - vel) / rms(vel)),
              limits["velocity_rms_gap"]),
        Check("energy_gap_ev_per_atom", abs(prog["pe"] - float(energy)) / n,
              limits["energy_gap_ev_per_atom"]),
    ]
