"""The device mesh over ``torch.distributed`` ranks.

Counterpart of ``stmgcn_tpu/parallel/mesh.py``. A logical mesh of three
axes ``(dp, region, branch)`` over the ranks of one job, one process per
rank:

- ``dp``: data parallelism (the batch split over ranks, the gradients
  summed once a step);
- ``region``: graph-node parallelism (each rank holds ``N / region``
  node rows; the dense graph convs all-gather the signal's rows, banded
  ones exchange halos with the ring neighbours);
- ``branch``: the M stacked graph branches split over ranks, the fusion
  sum one all-reduce.

Rank order is the JAX mesh's ``np.reshape(devices, (dp, region, branch))``:
rank ``r`` sits at ``np.unravel_index(r, (dp, region, branch))``, so rank
r holds the shard that device r holds in the JAX mesh. Each axis line
(the ranks that differ in that coordinate only) gets a process group of
its own, made on every rank in one fixed order; an axis of extent 1 has
none, and nothing is sent over it.

**The transport** is one rule (:func:`transport`): NCCL when every local
rank has a card of its own, gloo otherwise (CPU ranks, or several ranks
sharing one card, which NCCL refuses). :func:`init_distributed` prints the
choice. An NCCL failure is never retried over gloo.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["AXES", "Mesh", "build_mesh", "init_distributed", "launch_local", "mesh_from_config",
           "transport"]

#: the mesh axes, in rank order (the last varies fastest)
AXES = ("dp", "region", "branch")


def transport(device, local_world_size: int) -> str:
    """The backend of a job whose ranks run on ``device``'s type with
    ``local_world_size`` ranks on this host: ``"nccl"`` when each of them
    has a CUDA card of its own, ``"gloo"`` otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available() and (
            local_world_size <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def init_distributed(*, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None,
                     local_rank: Optional[int] = None, local_world_size: Optional[int] = None,
                     device=None, timeout: float = 600.0) -> torch.device:
    """Join a job of ranks and return this rank's device.

    Without arguments every value comes from the environment ``torchrun``
    sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``; ``init_method`` ``"env://"``);
    otherwise pass ``init_method`` (e.g. ``"tcp://localhost:29500"``),
    ``world_size`` and ``rank``. ``device`` is ``"cuda"`` (the default) or
    ``"cpu"``; the backend is :func:`transport`'s, never another. Under NCCL rank
    i of a host takes card ``i``; under gloo on CUDA the ranks share the
    cards round robin. Prints the transport and why, once per job (the
    lead, rank 0, to stderr). ``timeout`` bounds every collective, seconds.
    A job already joined returns its device unchanged."""
    dev = torch.device("cuda" if device is None else device)
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if world_size is None or rank is None:
        raise ValueError("init_distributed needs world_size and rank (or the RANK and "
                         "WORLD_SIZE a launcher such as torchrun sets)")
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK")
        local_rank = rank if local_rank is None else local_rank
    if local_world_size is None:
        local_world_size = _env_int("LOCAL_WORLD_SIZE") or world_size
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda'): no CUDA device is "
                               "available; pass device='cpu' for CPU ranks")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    chosen = transport(dev, local_world_size)
    if not dist.is_initialized():
        dist.init_process_group(chosen, init_method=init_method or "env://",
                                world_size=world_size, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
        if rank == 0:
            why = ("every local rank has a card of its own" if chosen == "nccl" else
                   "CPU ranks" if dev.type == "cpu" else
                   f"{local_world_size} local ranks share "
                   f"{torch.cuda.device_count()} card(s)")
            print(f"[mesh] {world_size} ranks, transport {chosen} ({why})",
                  file=sys.stderr, flush=True)
    return dev


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of a ``(dp, region, branch)`` mesh: the extents,
    this rank's coordinates, its axis lines' process groups (None for an
    axis of extent 1) and global ranks, the job's backend and this rank's
    device."""

    dp: int
    region: int
    branch: int
    rank: int
    coords: dict
    groups: dict
    lines: dict
    backend: str
    device: torch.device

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "region": self.region, "branch": self.branch}

    @property
    def world(self) -> int:
        return self.dp * self.region * self.branch

    @property
    def is_lead(self) -> bool:
        """Rank 0: the one that reads and writes checkpoints and prints."""
        return self.rank == 0

    def size(self, axis: str) -> int:
        return self.world if axis == "world" else self.shape[axis]

    def group(self, axis: str):
        """The process group of this rank's ``axis`` line (``"world"``: the
        default group); None when the axis has extent 1."""
        if axis == "world":
            return dist.group.WORLD if self.world > 1 else None
        return self.groups[axis]

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.dp}, region={self.region}, branch={self.branch}, "
                f"rank={self.rank}, coords={self.coords}, backend={self.backend!r})")


def build_mesh(dp: int = 1, region: int = 1, branch: int = 1, *, device=None) -> Mesh:
    """This rank's :class:`Mesh` over the joined job, whose world size must
    be ``dp * region * branch``; makes every axis line's process group on
    every rank (a collective call: all ranks call it together).
    ``device`` (this rank's) defaults to the current CUDA card, or the CPU
    without one."""
    extents = {"dp": dp, "region": region, "branch": branch}
    if any(e < 1 for e in extents.values()):
        raise ValueError(f"mesh extents must be positive, got {extents}")
    need = dp * region * branch
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(
            f"mesh dp={dp} region={region} branch={branch} needs {need} ranks, but this "
            f"job has {world}: launch {need} ranks (the CLI's --virtual-devices {need} "
            "or --distributed under torchrun) and call init_distributed in each")
    rank = dist.get_rank() if dist.is_initialized() else 0
    backend = dist.get_backend() if dist.is_initialized() else "none"
    grid = np.arange(need).reshape(dp, region, branch)
    coords = dict(zip(AXES, (int(c) for c in np.unravel_index(rank, grid.shape))))
    groups, lines = {}, {}
    for a, axis in enumerate(AXES):
        if grid.shape[a] == 1:
            groups[axis], lines[axis] = None, (rank,)
            continue
        # every line of this axis, in one order on every rank
        for line in np.moveaxis(grid, a, -1).reshape(-1, grid.shape[a]):
            ranks = tuple(int(r) for r in line)
            group = dist.new_group(list(ranks))
            if rank in ranks:
                groups[axis], lines[axis] = group, ranks
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    return Mesh(dp, region, branch, rank, coords, groups, lines, backend, torch.device(device))


#: meshes built in this process, by extents, device and job: a later
#: trainer of the same job reuses the process groups (every rank builds
#: the same meshes in the same order, so every rank reuses alike)
_MESHES: dict = {}


def mesh_from_config(mesh_cfg, *, device=None) -> Optional[Mesh]:
    """``MeshConfig -> Mesh``, or None for the one-device case; raises when
    the job's world size is not ``dp * region * branch``. A mesh of the
    same extents and device in the same job is built once."""
    if mesh_cfg.n_devices <= 1:
        return None
    key = (mesh_cfg.dp, mesh_cfg.region, mesh_cfg.branch,
           None if device is None else str(torch.device(device)),
           id(dist.group.WORLD) if dist.is_initialized() else None)
    if key not in _MESHES:
        _MESHES[key] = build_mesh(mesh_cfg.dp, mesh_cfg.region, mesh_cfg.branch,
                                  device=device)
    return _MESHES[key]


def launch_local(cmd, world: int, *, env: Optional[dict] = None, log_dir: Optional[str] = None,
                 timeout: Optional[float] = None, cwd: Optional[str] = None) -> tuple:
    """Run ``cmd`` as the ``world`` ranks of one local job, as ``torchrun``
    would: each process gets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` (localhost) and ``MASTER_PORT``
    (a free port) on top of ``env``; with ``log_dir`` its output goes to
    ``log_dir/rank<r>.log``, else it inherits this process's. Waits for
    all; the first rank to fail, or ``timeout`` seconds passing, stops the
    rest (killed). Returns ``(return codes, problem)``: ``problem`` None
    when every rank exited 0, else what went wrong."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs, logs = [], []
    for rank in range(world):
        rank_env = dict(os.environ, **(env or {}), RANK=str(rank), WORLD_SIZE=str(world),
                        LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                        MASTER_ADDR="localhost", MASTER_PORT=str(port))
        log = None if log_dir is None else open(os.path.join(log_dir, f"rank{rank}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(cmd, env=rank_env, cwd=cwd, stdout=log,
                                      stderr=None if log is None else subprocess.STDOUT))
    deadline = None if timeout is None else time.monotonic() + timeout
    problem = None
    try:
        while problem is None and any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                problem = f"rank(s) {bad} exited with {[procs[r].returncode for r in bad]}"
            elif deadline is not None and time.monotonic() > deadline:
                problem = f"the job outlived its {timeout:.0f} s"
            else:
                time.sleep(0.05)
        if problem is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                problem = f"rank(s) {bad} exited with {[procs[r].returncode for r in bad]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            if log is not None:
                log.close()
    return [p.returncode for p in procs], problem
