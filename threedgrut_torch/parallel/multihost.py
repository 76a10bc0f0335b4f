"""Process start-up for the mesh, port of
threedgrut_tpu/parallel/multihost.py: joining the processes of a run into
one torch.distributed process group (`initialize`), the mesh over all of
them (`make_global_mesh`), each process's share of a step's views
(`my_view_indices`, `host_local_batch`), and `spawn`, which starts local
ranks in fresh processes (the train entry's --multichip without a launcher,
and the tests).

A process group is joined over tcp:// (a coordinator's address, the
loopback for local ranks). NCCL takes one rank per card; gloo also runs
several ranks on one card, or on the CPU.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import socket
import sys
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from threedgrut_torch.parallel import dp

# A collective that waits longer than this has lost a rank.
COLLECTIVE_TIMEOUT_S = 600.0


def free_port() -> int:
    """A free TCP port on the loopback."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_process_group(backend: str, address: str, world_size: int,
                       rank: int,
                       timeout_s: float = COLLECTIVE_TIMEOUT_S) -> None:
    """Join the default process group at tcp://`address` ("host:port")."""
    dist.init_process_group(
        backend, init_method=f"tcp://{address}", world_size=int(world_size),
        rank=int(rank), timeout=datetime.timedelta(seconds=timeout_s))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join this process to the run's process group (a no-op for one
    process, or where it has joined). Where a launcher set them, RANK,
    WORLD_SIZE and MASTER_ADDR/MASTER_PORT stand in for arguments not
    given. `backend` defaults to nccl where a card is present, else
    gloo."""
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None or num_processes <= 1 or dist.is_initialized():
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("initialize: a process group of "
                         f"{num_processes} needs the coordinator's address "
                         "and this process's id (or MASTER_ADDR and RANK)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init_process_group(backend, coordinator_address, num_processes,
                       process_id)


def make_global_mesh(tile: int = 1, model: int = 1) -> dp.Mesh:
    """The (data, tile, model) mesh over every process of the group (call
    after initialize()): data = world size / (tile x model)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % (tile * model):
        raise ValueError(f"a world of {world} processes does not divide "
                         f"into tile {tile} x model {model}")
    return dp.make_mesh(world // (tile * model), tile, model)


def my_view_indices(num_views: int, batch_size: int, step: int,
                    seed: int = 0, mesh: Optional[dp.Mesh] = None,
                    process_index: Optional[int] = None,
                    process_count: Optional[int] = None) -> List[int]:
    """This process's views of a step: every process computes the JAX
    package's global schedule (the same numbers) and takes its slice, by
    data row of `mesh` where given (the row's ranks share its views), else
    by process index as the JAX package does (one process per host)."""
    rng = np.random.default_rng(seed * 100003 + step // max(num_views, 1))
    perm = rng.permutation(num_views)
    rows = [int(perm[(step * batch_size + i) % num_views])
            for i in range(batch_size)]
    if mesh is not None:
        pid, nproc = mesh.axis("data")[::-1]
    else:
        if process_index is None:
            process_index = dist.get_rank() if dist.is_initialized() else 0
        if process_count is None:
            process_count = (dist.get_world_size() if dist.is_initialized()
                             else 1)
        pid, nproc = process_index, process_count
    per = batch_size // nproc
    return rows[pid * per:(pid + 1) * per]


class PoseView:
    """Another data row's view as a process that did not load it sees it:
    its pose and resolution (what the strategies' hooks read)."""

    def __init__(self, T_to_world, resolution):
        self.T_to_world = T_to_world
        self.resolution = resolution


def host_local_batch(mesh: dp.Mesh, local_views: Sequence, device="cpu"):
    """A step's B views from this process's own (its data row's one view):
    the local view in its row's place and, for the other rows, PoseViews
    whose poses are gathered over the data axis (on `device`: the CPU for
    gloo, the rank's card for NCCL). The result is what
    DPTrainer.train_step_batch takes."""
    D, d = mesh.axis("data")
    if len(local_views) != 1:
        raise ValueError(f"a data row renders one view a step, got "
                         f"{len(local_views)}")
    view = local_views[0]
    T = torch.as_tensor(np.asarray(view.T_to_world, np.float32),
                        device=device)
    (poses,) = dp.all_gather([T], mesh.groups["data"], D, d)
    poses = poses.cpu().numpy()
    return [view if i == d else PoseView(poses[i], view.resolution)
            for i in range(D)]


def rank_device(device, rank: int) -> torch.device:
    """A local rank's device: cuda:(rank % card count) for a card, else
    `device` itself."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % max(1, torch.cuda.device_count()))
    return dev


def _spawned(fn, rank, world, port, backend, threads, out_dir, args):
    if threads:
        torch.set_num_threads(threads)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    try:
        init_process_group(backend, f"127.0.0.1:{port}", world, rank)
        result = ("ok", fn(rank, *args))
    except BaseException:
        result = ("error", traceback.format_exc())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    path = os.path.join(out_dir, f"{rank}.pkl")
    with open(path + ".tmp", "wb") as fh:
        pickle.dump(result, fh)
    os.replace(path + ".tmp", path)
    sys.exit(0 if result[0] == "ok" else 1)


def spawn(fn: Callable, nprocs: int, args: Sequence = (),
          backend: str = "gloo", timeout: Optional[float] = None,
          threads: Optional[int] = None) -> list:
    """Run fn(rank, *args) in `nprocs` fresh processes joined into one
    process group over the loopback (a free port), with RANK, WORLD_SIZE,
    LOCAL_RANK and MASTER_ADDR/PORT set as a launcher sets them, torch on
    `threads` intra-op threads where given. `fn` must be importable (a
    module's function) and return something picklable. Returns each rank's
    return value in rank order; raises with the failing rank's traceback
    when one fails, and after `timeout` seconds; every worker has ended
    when it returns or raises."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    deadline = None if timeout is None else time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix="threedgrut_spawn_") as tmp:
        procs = [ctx.Process(target=_spawned, args=(
            fn, r, nprocs, port, backend, threads, tmp, tuple(args)))
            for r in range(nprocs)]
        for p in procs:
            p.start()
        try:
            while any(p.is_alive() for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0)]
                if failed:
                    break
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"spawn: {nprocs} ranks did not end "
                                       f"within {timeout} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"{r}.pkl")
            if not os.path.exists(path):
                results.append(("error", f"rank {r} ended with exit code "
                                         f"{p.exitcode} and no result"))
                continue
            with open(path, "rb") as fh:
                results.append(pickle.load(fh))
    errors = [(r, res[1]) for r, res in enumerate(results)
              if res[0] != "ok"]
    if errors:
        # The first rank that raised, not one stopped because it did.
        r, tb = next(((r, tb) for r, tb in errors if "Traceback" in tb),
                     errors[0])
        raise RuntimeError(f"spawn: rank {r} of {nprocs} failed:\n{tb}")
    return [res[1] for res in results]
