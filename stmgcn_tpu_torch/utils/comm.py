"""The port's one collective layer, with its communication accounting.

Counterpart of ``stmgcn_tpu/utils/comm.py``. The JAX package lets GSPMD
insert the collectives and counts them by parsing the compiled HLO; here
every collective of the port is one call of this module over a named mesh
axis (``"dp"``, ``"region"``, ``"branch"``, or ``"world"`` for every rank)
of a :class:`~stmgcn_tpu_torch.parallel.mesh.Mesh`, and no other module
calls ``torch.distributed``'s collectives. Each call adds to
:data:`STATS` one entry ``(kind, axis, bytes, calls)``, kinds named as the
HLO ops (``"all-reduce"``, ``"all-gather"``, ``"broadcast"``,
``"reduce-scatter"``, ``"collective-permute"`` for a ring exchange's
point-to-point sends), and counts
the same under ``what`` (the payload's name: ``"grads"``, ``"loss"``,
``"fusion"``, ...). Bytes follow the JAX rule: the op's *output* bytes
(an all-gather's output is the gathered tensor, ``calls x`` the input
times the group size), a proxy for wire volume, not a hardware counter.
The counts also go to the obs registry as the counters ``comm.bytes`` and
``comm.calls`` labelled ``kind`` and ``axis``.

:func:`collective_stats` reads the tallies; :func:`step_comm_report` runs
a function (one training step, say) and returns what it moved, where the
JAX function compiles it and parses the HLO. An axis of extent 1 moves
nothing and counts nothing, as XLA emits no collective over it.

Tensors go to the backend on their own device, except that NCCL takes
CUDA tensors only (a CPU tensor is then moved to the mesh's device and
back) and gloo sends and receives CPU tensors only (a CUDA tensor of a
ring exchange goes through the host).
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from stmgcn_tpu_torch.obs.registry import REGISTRY

__all__ = [
    "COLLECTIVES",
    "CommStats",
    "STATS",
    "all_gather",
    "all_reduce",
    "broadcast",
    "broadcast_bytes",
    "collective_stats",
    "reduce_scatter",
    "ring_exchange",
    "step_comm_report",
]

COLLECTIVES = ("all-reduce", "all-gather", "broadcast", "reduce-scatter", "collective-permute")


class CommStats:
    """Tallies of the collectives run, by ``(kind, axis)`` and by ``(kind,
    axis, what)``: ``{"calls": n, "bytes": n}`` each, and the largest
    single call by ``(kind, axis)`` (the halo wire model's per-call bound
    reads it; sums cannot give it back); thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ops: dict = collections.defaultdict(lambda: [0, 0])
        self._what: dict = collections.defaultdict(lambda: [0, 0])
        self._max: dict = {}
        #: open :meth:`window` tables, each the largest call since it opened
        self._windows: list = []

    def add(self, kind: str, axis: str, nbytes: int, what: str = "") -> None:
        if kind not in COLLECTIVES:
            raise ValueError(f"unknown collective {kind!r}; known: {COLLECTIVES}")
        with self._lock:
            for table, key in ((self._ops, (kind, axis)), (self._what, (kind, axis, what))):
                table[key][0] += 1
                table[key][1] += int(nbytes)
            for peak in [self._max] + self._windows:
                peak[(kind, axis)] = max(peak.get((kind, axis), 0), int(nbytes))
        labels = {"kind": kind, "axis": axis}
        REGISTRY.counter("comm.calls", labels).inc(1)
        REGISTRY.counter("comm.bytes", labels).inc(nbytes)

    def reset(self) -> None:
        with self._lock:
            self._ops.clear()
            self._what.clear()
            self._max.clear()

    @contextlib.contextmanager
    def window(self):
        """A ``{"kind/axis": bytes}`` table of the largest call of each
        kind and axis run while the block runs (filled when it ends)."""
        peak: dict = {}
        with self._lock:
            self._windows.append(peak)
        out: dict = {}
        try:
            yield out
        finally:
            with self._lock:  # by identity: two open windows may hold equal tables
                self._windows = [w for w in self._windows if w is not peak]
            out.update({f"{k}/{a}": b for (k, a), b in peak.items()})

    def snapshot(self) -> dict:
        """``{"ops": {"kind/axis": {"calls", "bytes"}}, "what": {"kind/axis/what":
        {...}}, "max_bytes": {"kind/axis": largest call}, "total_bytes": n,
        "calls": n}``."""
        with self._lock:
            ops = {f"{k}/{a}": {"calls": c, "bytes": b} for (k, a), (c, b) in self._ops.items()}
            what = {f"{k}/{a}/{w}": {"calls": c, "bytes": b}
                    for (k, a, w), (c, b) in self._what.items()}
            peak = {f"{k}/{a}": b for (k, a), b in self._max.items()}
        return {"ops": ops, "what": what, "max_bytes": peak,
                "total_bytes": sum(v["bytes"] for v in ops.values()),
                "calls": sum(v["calls"] for v in ops.values())}


#: the process's tallies
STATS = CommStats()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _on_backend(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` where the backend takes it: NCCL only CUDA tensors."""
    if mesh.backend == "nccl" and t.device.type != "cuda":
        return t.to(mesh.device)
    return t


def all_reduce(tensor: torch.Tensor, axis: str, mesh, *, what: str = "") -> torch.Tensor:
    """The sum of ``tensor`` over this rank's ``axis`` line, as a new
    tensor on ``tensor``'s device (``tensor`` itself is left as it is)."""
    group = mesh.group(axis)
    if group is None:
        return tensor
    buf = _on_backend(tensor, mesh)
    buf = buf.clone() if buf is tensor else buf
    buf = buf.contiguous()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    STATS.add("all-reduce", axis, _nbytes(buf), what)
    return buf.to(tensor.device)


def all_gather(tensor: torch.Tensor, axis: str, mesh, *, dim: int = 0,
               what: str = "") -> torch.Tensor:
    """The ``axis`` line's tensors (one shape on every rank) concatenated
    along ``dim`` in line order."""
    group = mesh.group(axis)
    if group is None:
        return tensor
    buf = _on_backend(tensor, mesh).contiguous()
    parts = [torch.empty_like(buf) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, buf, group=group)
    out = torch.cat(parts, dim=dim)
    STATS.add("all-gather", axis, _nbytes(out), what)
    return out.to(tensor.device)


def reduce_scatter(tensor: torch.Tensor, axis: str, mesh, *, dim: int = 0,
                   what: str = "") -> torch.Tensor:
    """This rank's block of the sum of ``tensor`` over its ``axis`` line:
    ``dim`` cut into ``size`` contiguous blocks in line order, the rank at
    line position ``i`` keeping block ``i`` (every rank passes the same
    shape; ``dim``'s extent a multiple of the line's size). Over NCCL one
    ``reduce_scatter_tensor`` (counted ``"reduce-scatter"``, its output's
    bytes, a ``1/size`` of an all-reduce's); gloo has no reduce-scatter,
    so there it is an all-reduce of the whole tensor and the block cut out
    (counted ``"all-reduce"``, the whole tensor's bytes)."""
    group = mesh.group(axis)
    if group is None:
        return tensor
    size, i = mesh.size(axis), mesh.coords[axis]
    dim = dim % tensor.dim()
    block = tensor.shape[dim] // size
    if block * size != tensor.shape[dim]:
        raise ValueError(f"reduce_scatter: dim {dim} of extent {tensor.shape[dim]} does not "
                         f"split over {size} ranks")
    if mesh.backend != "nccl":
        return all_reduce(tensor, axis, mesh, what=what).narrow(dim, i * block, block)
    lead = _on_backend(tensor, mesh).movedim(dim, 0).contiguous()
    out = torch.empty((block,) + tuple(lead.shape[1:]), dtype=lead.dtype, device=lead.device)
    dist.reduce_scatter_tensor(out, lead, op=dist.ReduceOp.SUM, group=group)
    STATS.add("reduce-scatter", axis, _nbytes(out), what)
    return out.movedim(0, dim).to(tensor.device)


def broadcast(tensor: Optional[torch.Tensor], mesh, *, shape=None, dtype=None, src: int = 0,
              axis: str = "world", what: str = "") -> torch.Tensor:
    """Global rank ``src``'s ``tensor`` on every rank of the ``axis`` line
    (``src`` must lie on it); the other ranks pass ``tensor=None`` with
    its ``shape`` and ``dtype``."""
    group = mesh.group(axis)
    if group is None:
        return tensor
    if mesh.rank == src:
        buf = _on_backend(tensor, mesh).contiguous()
        buf = buf.clone() if buf is tensor else buf
    else:
        dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
        buf = torch.empty(shape, dtype=dtype, device=dev)
    dist.broadcast(buf, src=src, group=group)
    STATS.add("broadcast", axis, _nbytes(buf), what)
    return buf


def broadcast_bytes(data: Optional[bytes], mesh, *, src: int = 0, what: str = "") -> bytes:
    """Rank ``src``'s ``data`` on every rank: its length (an int64), then
    its bytes; the other ranks pass None."""
    own = mesh.rank == src
    size = broadcast(torch.tensor([len(data)], dtype=torch.int64) if own else None, mesh,
                     shape=(1,), dtype=torch.int64, src=src, what=what)
    n = int(size.item())
    payload = torch.from_numpy(np.frombuffer(data, np.uint8).copy()) if own else None
    got = broadcast(payload, mesh, shape=(n,), dtype=torch.uint8, src=src, what=what)
    return data if own else got.cpu().numpy().tobytes()


def ring_exchange(send_prev: torch.Tensor, send_next: torch.Tensor, axis: str, mesh, *,
                  what: str = "") -> tuple:
    """A non-periodic ±1 exchange along this rank's ``axis`` line (the JAX
    ``ppermute`` pair of ``halo_exchange``): ``send_prev`` goes to the
    line's previous rank and ``send_next`` to its next one, all sends and
    receives posted at once (``batch_isend_irecv``). Returns ``(from_prev,
    from_next)``: the previous rank's ``send_next`` and the next rank's
    ``send_prev``, on ``send_prev``'s device, each None at the line's end
    that has no neighbour (and both None on an axis of extent 1). Counted
    as two ``collective-permute`` calls of the sent tensors' bytes on every
    rank of the line, as XLA gives every device each permute's output."""
    group = mesh.group(axis)
    if group is None:
        return None, None
    line, i = mesh.lines[axis], mesh.coords[axis]
    dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    sp, sn = (t.to(dev).contiguous() for t in (send_prev, send_next))
    ops, from_prev, from_next = [], None, None
    if i > 0:
        from_prev = torch.empty_like(sn)
        ops += [dist.P2POp(dist.isend, sp, line[i - 1], group),
                dist.P2POp(dist.irecv, from_prev, line[i - 1], group)]
    if i < len(line) - 1:
        from_next = torch.empty_like(sp)
        ops += [dist.P2POp(dist.isend, sn, line[i + 1], group),
                dist.P2POp(dist.irecv, from_next, line[i + 1], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    STATS.add("collective-permute", axis, _nbytes(sp), what)
    STATS.add("collective-permute", axis, _nbytes(sn), what)
    out = send_prev.device
    return (None if from_prev is None else from_prev.to(out),
            None if from_next is None else from_next.to(out))


def collective_stats() -> dict:
    """The process's tallies (:meth:`CommStats.snapshot`)."""
    return STATS.snapshot()


def _delta(after: dict, before: dict) -> dict:
    out = {}
    for key in ("ops", "what"):
        table = {}
        for name, v in after[key].items():
            b = before[key].get(name, {"calls": 0, "bytes": 0})
            if v["calls"] != b["calls"]:
                table[name] = {"calls": v["calls"] - b["calls"],
                               "bytes": v["bytes"] - b["bytes"]}
        out[key] = table
    out["total_bytes"] = sum(v["bytes"] for v in out["ops"].values())
    out["calls"] = sum(v["calls"] for v in out["ops"].values())
    return out


def step_comm_report(fn: Callable, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` and return what its collectives moved
    on this rank (:meth:`CommStats.snapshot` over the call alone, its
    ``max_bytes`` the largest call of each kind and axis in it), with
    ``fn``'s return value under ``"result"``."""
    before = STATS.snapshot()
    with STATS.window() as peak:
        result = fn(*args, **kwargs)
    report = _delta(STATS.snapshot(), before)
    report["max_bytes"] = peak
    report["result"] = result
    return report
