"""MD cells: Langevin (BAOAB) dynamics of one large jittered crystal
through the program's `VelocityVerlet` on its device neighbour list,
for a model of any descriptor family the configuration names.

Set-up loads the model, makes the lattice from the seed, builds the
integrator and runs `warm_chunks` chunks, the last of which sizes the
window: a whole number of chunks that takes about `--seconds`, run by
one `VelocityVerlet.run` call that ends with its read-back. A traced
run profiles the window on the card alone, then `trace_chunks` more
chunks with the host's ops for the idle gaps.

`correct` compares the last chunk of the window with the plain
reference, which runs the same chunk again from the program's state at
its start (positions, velocities and the noise generator's state), with
its own neighbour list, descriptors, heads, forces and integrator; and
the velocities the program drew at the start with the reference's.
"""
from __future__ import annotations

import contextlib
import gc
import time

import numpy as np

from .. import generate, work
from ..common import LISTS, ROOT, Check, Context, Run
from ..reference import md as ref_md
from ..trace import Profiled, host_range, idle_gaps_of
from ..work import mlp as work_mlp
from ..work.peaks import bound_s


class _Probe:
    """Spans and state around the program's calls inside the window: the
    host time of each chunk's enqueue, each list build's CUDA events and
    the sizes of its lists (traced runs), and the state at the start of
    the last accepted chunk with the chunk's results."""

    def __init__(self, md, trace: bool, rcut: float):
        import torch
        from tensoralloy_tpu_torch.transform.device_nl import \
            DeviceNeighborList
        self.open, self.enqueue_s, self.builds = False, 0.0, []
        self.pending = self.accepted = None
        chunk, record = md._chunk, md._record
        ranges = host_range if trace else (
            lambda name: contextlib.nullcontext())

        def probed_chunk(feats, pos, vel, cell, n):
            start = (pos.clone(), vel.clone(), cell.clone(),
                     md._gen.get_state(), n)
            t = time.perf_counter()
            with ranges("md.chunk"):
                out = chunk(feats, pos, vel, cell, n)
            if self.open:
                self.enqueue_s += time.perf_counter() - t
            self.pending = (start, out)
            return out

        def probed_record(history, *args):
            with ranges("md.readback"):
                record(history, *args)
            self.accepted = self.pending

        md._chunk, md._record = probed_chunk, probed_record
        self._class, self._build = DeviceNeighborList, DeviceNeighborList.build
        if not trace:
            return

        def probed_build(nl, positions, cell=None, etemperature=0.0):
            if not self.open:
                return self._build(nl, positions, cell, etemperature)
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
            with ranges("md.nl_build"):
                feats, diag = self._build(nl, positions, cell, etemperature)
            end.record()
            self.builds.append((begin, end, _list_sizes(feats, rcut)))
            return feats, diag

        DeviceNeighborList.build = probed_build

    def close(self) -> None:
        self._class.build = self._build


def _list_sizes(feats: dict, rcut: float) -> dict:
    """{"pairs": (rows, width, real), "triples": ...} of a build's dense
    lists, each real count a device scalar: the pairs within `rcut` (the
    list holds the skin beyond it, whose terms are 0), the triples the
    list marks real."""
    import torch
    from tensoralloy_tpu_torch.ops.dense import decode_simg
    out = {}
    for name, prefix in LISTS.items():
        mask = feats.get(f"{prefix}_mask_d")
        if mask is None:
            continue
        if name != "pairs":
            out[name] = (mask.shape[0], mask.shape[1], (mask > 0).sum())
            continue
        pos, cell = feats["positions"], feats["cell"]
        j, simg = feats["pair_j_d"].long(), feats["pair_simg_d"]
        real = torch.zeros((), dtype=torch.int64, device=pos.device)
        for lo in range(0, mask.shape[0], 8192):
            hi = min(lo + 8192, mask.shape[0])
            shift = torch.stack(decode_simg(simg[lo:hi], pos.dtype), -1)
            vec = pos[j[lo:hi]] + shift @ cell - pos[lo:hi, None, :]
            within = torch.sum(vec * vec, dim=-1) < rcut * rcut
            real = real + (within & (mask[lo:hi] > 0)).sum()
        out[name] = (mask.shape[0], mask.shape[1], real)
    return out


def _sync(device) -> None:
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def run(ctx: Context) -> Run:
    import torch
    from tensoralloy_tpu_torch.atoms import Structure
    from tensoralloy_tpu_torch.dynamics import VelocityVerlet
    from tensoralloy_tpu_torch.io.model import load_model
    from tensoralloy_tpu_torch.precision import set_tf32
    cfg, tr, out = ctx.config, ctx.traffic, Run()
    if ctx.control:
        set_tf32(True)
    model, _ = load_model(str(ROOT / cfg["weights"]), device=ctx.device,
                          dtype="medium", backend="pallas")
    pos, cell = generate.jittered_fcc(tr["reps"], tr["a"], tr["jitter"],
                                      ctx.seed)
    n_atoms = len(pos)
    structure = Structure.from_symbols([cfg["element"]] * n_atoms, pos, cell,
                                       pbc=[True] * 3)
    md_seed = generate.legacy_seed(ctx.seed)
    md = VelocityVerlet(model, structure, timestep=tr["timestep"],
                        skin=tr["skin"], chunk_size=tr["chunk_size"],
                        temperature=tr["temperature"], seed=md_seed,
                        target_temperature=tr["temperature"],
                        friction=tr["friction"], device_nl=True)
    v_start = md.velocities_vap[md.vap.local_to_vap].copy()
    probe = _Probe(md, ctx.trace, cfg["rcut"])
    chunk = tr["chunk_size"]
    try:
        for _ in range(tr["warm_chunks"]):
            t = time.perf_counter()
            md.run(chunk)
            _sync(ctx.device)
            last = time.perf_counter() - t
        n_chunks = max(2, int(round(ctx.seconds / last)))
        probe.open = True
        _sync(ctx.device)
        with (Profiled() if ctx.trace else contextlib.nullcontext()) as prof:
            out.setup_end = time.perf_counter()
            history = md.run(n_chunks * chunk)
            _sync(ctx.device)
            out.window_s = time.perf_counter() - out.setup_end
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
    if str(ctx.device).startswith("cuda"):
        out.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    out.values["host_ms_per_step"] = 1e3 * probe.enqueue_s / steps
    if ctx.trace:
        _work(out, probe, cfg, n_atoms, steps, n_chunks)

    start, result = window_last
    rows = torch.as_tensor(md.vap.local_to_vap.astype(np.int64),
                           device=start[0].device)
    n_vap = int(md.model.n_atoms_vap)
    prog = {"vel": result[1][rows], "pe": float(result[3])}
    del md, model, probe, history, result, window_last
    gc.collect()
    if str(ctx.device).startswith("cuda"):
        torch.cuda.empty_cache()
    t = time.perf_counter()
    out.checks = _compare(ctx, start, rows, n_vap, prog, v_start, md_seed)
    out.values["reference_s"] = time.perf_counter() - t
    return out


def _work(out: Run, probe: _Probe, cfg: dict, n_atoms: int, steps: int,
          n_chunks: int) -> None:
    """Build times, and the frozen work of the window's kernel launches
    from the mean sizes of the window's lists."""
    import torch
    torch.cuda.synchronize()
    if not probe.builds:
        return
    out.values["nl_build_ms"] = float(np.mean(
        [b.elapsed_time(e) for b, e, _ in probe.builds]))
    lists = {name: tuple(float(np.mean([float(sizes[name][k])
                                         for *_, sizes in probe.builds]))
                         for k in range(3))
             for name in probe.builds[0][2]}
    counts = work.family(cfg)
    force = counts.launches(cfg, lists, "force")
    energy = counts.launches(cfg, lists, "energy")
    out.launch_bound_s = {k: bound_s(*v) for k, v in force.items()}
    sizes = [cfg["n_descriptors"]] + list(cfg["hidden_sizes"]) + [1]
    mlp_force = work_mlp.flop_per_atom(sizes, work_mlp.FORCE_EVALUATION)
    mlp_energy = work_mlp.flop_per_atom(sizes, work_mlp.ENERGY)
    # useful work: one force evaluation a step, one energy a chunk end
    out.useful_flop = (
        steps * (sum(f for _, f in force.values()) + n_atoms * mlp_force)
        + n_chunks * (sum(f for _, f in energy.values())
                      + n_atoms * mlp_energy))


def _compare(ctx: Context, start, rows, n_vap: int, prog: dict,
             v_start: np.ndarray, md_seed: int) -> list:
    import torch
    cfg, tr = ctx.config, ctx.traffic
    pos0, vel0, cell0, gen_state, steps = start
    n = len(rows)
    device = pos0.device
    masses = np.full(n, cfg["mass_amu"])
    v_ref0 = ref_md.maxwell_boltzmann(masses, tr["temperature"], md_seed)
    layers, xlo, xhi = ref_md.heads_from_npz(
        str(ROOT / cfg["weights"]), cfg["element"], torch.float32, device)
    potential = ref_md.Cell(cfg, layers, xlo, xhi, cell0,
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
