"""Ranks, meshes and the launcher (port of `tensoralloy_tpu/parallel/
mesh.py`).

The JAX package runs one program over a `jax.sharding.Mesh` of devices
and lets XLA insert the collectives. Here every rank is a process of a
`torch.distributed` group: a `Mesh` is that group along one named axis
as one rank sees it, and the sharded routes (the trainer, spatial EFS,
the NEB band, the committee) call the collectives of
`parallel.collectives` themselves.

Backends: gloo on the CPU; NCCL where each rank has a card of its own;
gloo on the CUDA tensors where ranks share a card (NCCL refuses two
ranks on one GPU). `launch` spawns a group in this process's place and
`initialize_distributed` joins one that a launcher such as
`python -m torch.distributed.run` started.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import queue as queue_mod
import sys
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .collectives import barrier, broadcast


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of one process group along one named axis, as this rank
    sees them (the counterpart of a 1-D `jax.sharding.Mesh`). A mesh
    without a group is this process alone: its collectives are the
    identity. A group of one rank runs them through its backend."""
    axis_name: str
    size: int
    rank: int
    device: torch.device
    group: Optional[object] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_name: self.size}

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def block(self, n: int) -> slice:
        """This rank's contiguous block of a leading axis of length `n`
        (the layout of `NamedSharding(P(axis))`)."""
        if n % self.size:
            raise ValueError(f"a leading axis of {n} does not split "
                             f"evenly over {self.size} ranks")
        m = n // self.size
        return slice(self.rank * m, (self.rank + 1) * m)


def group_size() -> int:
    """Ranks of the current default group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _rank_device() -> torch.device:
    return (torch.device("cuda", torch.cuda.current_device())
            if torch.cuda.is_available() else torch.device("cpu"))


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data"
              ) -> Mesh:
    """A mesh of `n_devices` ranks: None means the whole current group
    (this process alone when no group is initialised). A mesh spans the
    whole group or this rank alone."""
    world = group_size()
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"requested {n} devices but only {world} "
                         "available")
    if n == world and dist.is_initialized():
        return Mesh(axis_name, n, dist.get_rank(), _rank_device(),
                    dist.group.WORLD)
    if n == 1:
        return Mesh(axis_name, 1, 0, _rank_device())
    raise ValueError(f"requested {n} devices of a group of {world} "
                     "ranks: a mesh spans the whole group or one rank")


def shard_batch(batch: dict, mesh: Mesh, axis_name: str = "data") -> dict:
    """This rank's block of every leaf's leading axis (numpy arrays or
    tensors); scalars stay whole. The leading axis must split evenly."""
    def take(x):
        if np.ndim(x) == 0:
            return x
        return x[mesh.block(x.shape[0])]
    return {k: take(v) for k, v in batch.items()}


def replicate(tree, mesh: Mesh):
    """Rank 0's values of a tree of tensors on every rank."""
    return broadcast(tree, mesh, src=0)


@contextlib.contextmanager
def main_first(mesh: Mesh):
    """Rank 0 runs the block before the other ranks do (it writes the
    caches, database metadata and files that they then read)."""
    if not mesh.is_main:
        barrier(mesh)
    yield
    if mesh.is_main:
        barrier(mesh)


def pick_backend(device, n_ranks: int) -> str:
    """gloo on the CPU; NCCL when each of `n_ranks` ranks on this host
    has a card of its own; gloo on the CUDA tensors when ranks share a
    card (NCCL refuses two ranks on one GPU)."""
    if torch.device(device).type == "cpu":
        return "gloo"
    return "nccl" if n_ranks <= torch.cuda.device_count() else "gloo"


def _local_card(local_rank: int) -> None:
    torch.cuda.set_device(local_rank % torch.cuda.device_count())


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device="cuda"):
    """Join a group: over TCP at `coordinator_address` ("host:port"), else
    from the environment that `torch.distributed.run` sets (`RANK`,
    `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`, `LOCAL_RANK`,
    `LOCAL_WORLD_SIZE`). A CUDA rank takes card `LOCAL_RANK` modulo the
    cards. The backend is printed on stderr. -> (world_size, rank)."""
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None
               else os.environ.get("RANK", 0))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if torch.device(device).type == "cuda":
        _local_card(local_rank)
    backend = pick_backend(device, local_world)
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    # one write: the ranks share the stream
    sys.stderr.write(f"rank {rank} of {world}: backend {backend} on "
                     f"{device}\n")
    sys.stderr.flush()
    return dist.get_world_size(), dist.get_rank()


# ----------------------------------------------------------------------
def to_host(tree):
    """Tensors -> numpy arrays, through dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def _rank_main(fn, args, rank, n, store_path, backend, device, timeout,
               results):
    """One spawned rank: join the group over the file store, run
    `fn(*args)`, report (rank, error, result) on `results`."""
    try:
        os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                          WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n))
        # the ranks share this host: gloo on the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        if torch.device(device).type == "cuda":
            _local_card(rank)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, n), rank=rank,
            world_size=n, timeout=datetime.timedelta(seconds=timeout))
        try:
            out = to_host(fn(*args))
        finally:
            dist.destroy_process_group()
        results.put((rank, None, out))
    except BaseException:   # reported to the parent, which raises
        results.put((rank, traceback.format_exc(), None))


def launch(fn: Callable, n: int, *args, device="cuda",
           timeout: float = 600.0) -> List[object]:
    """Run `fn(*args)` in `n` spawned ranks of one group and return each
    rank's result (tensors as numpy arrays), in rank order.

    The ranks meet over a `FileStore` in a temporary directory (no TCP
    port to race for). `fn` must be importable by the spawned processes
    (a module-level function) and its arguments picklable. A CUDA rank r
    takes card r modulo the cards; a CPU rank one thread. The backend is
    `pick_backend(device, n)`, and is printed. A rank that
    raises, dies, or outlives `timeout` seconds fails the launch: every
    rank is then killed and RuntimeError or TimeoutError raised."""
    import multiprocessing as mp
    backend = pick_backend(device, n)
    print(f"launch: {n} ranks on {device}, backend {backend}", flush=True)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got: Dict[int, object] = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, args=(
            fn, args, r, n, os.path.join(tmp, "store"), backend,
            str(device), timeout, results)) for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(got) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"launch: {n - len(got)} of {n} ranks did not "
                        f"finish within {timeout:g} s")
                try:
                    rank, err, out = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in got]
                    if dead:
                        raise RuntimeError(
                            f"launch: rank {dead[0][0]} exited with code "
                            f"{dead[0][1]} without a result")
                    continue
                if err is not None:
                    raise RuntimeError(f"launch: rank {rank} failed:\n{err}")
                got[rank] = out
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
            results.close()
    return [got[r] for r in range(n)]
