"""Captured programs: the port's counterpart of the JAX package's compiled
programs (``jax.jit(fn).lower(...).compile()``).

The JAX package never runs its main path eagerly: the serving engine
compiles one program per ladder rung, the fleet engine one per (class,
bucket), and training runs S optimizer steps as one jitted scan. Here a
:class:`CapturedProgram` plays that part with a CUDA graph:

- it owns its **static inputs**, packed in one buffer of 4-byte words
  (:class:`StaticInputs`: a history window, an index block, a mask, the
  optimizer's per-step scalars, ...), with a pinned staging copy on the
  host, so a call is one host->device copy, a replay and one readback;
- its first call **warms the body up** (a real, counted run on the
  filled inputs, on the pool's capture stream, which fills every lazy
  cache and builds every kernel library) and then **captures** it into a
  :class:`torch.cuda.CUDAGraph` in the memory pool of its
  :class:`GraphPool`, which every program of one engine generation, or of
  one trainer, shares; later calls **replay** it on the pool's stream;
- the pool's lock is held from the copy into the staging buffer to the
  enqueue of the output copy, so concurrent callers never mix their
  inputs, and no replay of another program of the pool runs between a
  replay and the copy of its output: a graph captured later into a shared
  pool may place its output in memory that an earlier graph uses as
  scratch when it replays (replays on the pool's one stream are serialized
  on the device anyway);
- replays do not run the kernels' Python wrappers, so the launch counts
  (:mod:`~stmgcn_tpu_torch.ops.counters`) are kept by hand: the capture
  records what the body launched on the capturing stream, counts nothing
  itself, and each replay adds that record; the warm-up counts what it
  really launches. A graphed run and an eager run report the same launches
  per forward and step;
- each capture is counted in :mod:`~stmgcn_tpu_torch.obs.graphmon`, and
  every upload's bytes too.

A failure to capture raises; there is no eager fallback. :class:`Program`
is the eager route over the same static buffers (``graphs=False``, the
counterpart of ``jax.disable_jit``, and every program on the CPU): the
body runs on each call.

A program may also read **device inputs**: static device tensors (a
streamed batch's ``x`` and ``y``) that a call fills by one
device-to-device copy, on the program's stream, from a batch that a
:class:`Prefetcher` placed ahead. The prefetcher copies on a stream of its
own from a ring of pinned staging buffers, so batch i+1's upload runs
while step i's kernels do; the consuming stream waits on the copy's event
(never the host), the copied tensor is marked used on that stream
(``record_stream``) so the caching allocator cannot hand its memory to a
later copy while the consumer still reads it, and a staging buffer is
rewritten only after its last copy has completed. The captured graph keeps
reading the same static tensors, and the eager route copies into the same
ones, so both see the same bits.

The bookkeeping (buffers, locks, counts) is kept apart from the CUDA graph
calls, which live in :class:`GraphPool` alone, so the CPU tests drive the
bookkeeping with a stand-in pool whose "replay" runs the body on the
static buffers.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from stmgcn_tpu_torch.obs import graphmon
from stmgcn_tpu_torch.obs import trace as obs_trace
from stmgcn_tpu_torch.ops import counters

__all__ = [
    "CapturedProgram",
    "DeviceOps",
    "GraphPool",
    "Placed",
    "Prefetcher",
    "Program",
    "StaticInputs",
    "resolve_graphs",
]

#: captures are serialized process-wide: one capture at a time records
#: launch counts (``counters.recording``)
_CAPTURE_LOCK = threading.Lock()

_NUMPY = {torch.float32: np.float32, torch.int32: np.int32}


def resolve_graphs(graphs: Optional[bool], device: torch.device) -> bool:
    """Whether a component on ``device`` captures its programs: ``None``
    means on for CUDA and off elsewhere; ``True`` off CUDA raises."""
    if graphs is None:
        return device.type == "cuda"
    if graphs and device.type != "cuda":
        raise ValueError(f"graphs=True captures CUDA graphs, but the device is {device}; "
                         "pass graphs=False (or None) to run eagerly")
    return bool(graphs)


class StaticInputs:
    """A program's inputs as named views into one device buffer of 4-byte
    words (float32 and int32 only), filled from numpy through one staging
    buffer on the host (pinned for CUDA; on the CPU the buffer itself).

    ``spec`` maps each name to ``(shape, dtype)``. :meth:`fill` writes
    each given array into the front of its view along the first axis and
    zeroes the rest (a request shorter than the rung is zero-padded); a
    name left out is all zeros."""

    def __init__(self, spec: Dict[str, Tuple[tuple, torch.dtype]], ops: "DeviceOps"):
        self._slices = {}
        start = 0
        for name, (shape, dtype) in spec.items():
            if dtype not in _NUMPY:
                raise ValueError(f"static input {name!r}: dtype must be float32 or int32, "
                                 f"got {dtype}")
            size = int(np.prod(shape, dtype=np.int64))
            self._slices[name] = (start, start + size, tuple(shape), dtype)
            start += size
        self.words = torch.zeros(max(start, 1), dtype=torch.int32, device=ops.device)
        self.nbytes = 4 * start
        self.staging = ops.staging(self.words)
        host_words = self.staging.numpy()
        self.views = {}
        self._host = {}
        for name, (a, b, shape, dtype) in self._slices.items():
            self.views[name] = self.words[a:b].view(dtype).view(shape)
            self._host[name] = host_words[a:b].view(_NUMPY[dtype]).reshape(shape)

    def fill(self, values: Dict[str, np.ndarray]) -> None:
        unknown = set(values) - set(self._host)
        if unknown:
            raise KeyError(f"no static inputs named {sorted(unknown)}")
        for name, host in self._host.items():
            value = values.get(name)
            if value is None:
                host[...] = 0
                continue
            value = np.asarray(value)
            if value.shape[1:] != host.shape[1:] or value.shape[0] > host.shape[0]:
                raise ValueError(f"static input {name!r} is {host.shape}, got {value.shape}")
            host[:value.shape[0]] = value
            host[value.shape[0]:] = 0


class DeviceOps:
    """Uploads and readbacks of programs on one device. CUDA: on one
    stream (the caller's current stream when made), from pinned staging,
    non-blocking, each ordered by an event; the CPU: plain copies."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.current_stream(self.device) if self.cuda else None

    def stream_context(self):
        return torch.cuda.stream(self.stream) if self.cuda else contextlib.nullcontext()

    def staging(self, words: torch.Tensor) -> torch.Tensor:
        if not self.cuda:
            return words
        return torch.zeros(words.shape, dtype=words.dtype, pin_memory=True)

    def upload(self, dst: torch.Tensor, src: torch.Tensor):
        """Copy the staging buffer in; returns the event after the copy
        (None on the CPU, where they are one buffer)."""
        if dst is src:
            return None
        with self.stream_context():
            dst.copy_(src, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        return done

    def download(self, out: torch.Tensor):
        """``(host copy of out, event after it or None)``."""
        if not self.cuda:
            return out.detach().clone(), None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        with self.stream_context():
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        return host, done


class Placed:
    """One batch's device tensors, by name, and the event after their copy
    (None on the CPU, where the copy is done when :meth:`Prefetcher.place`
    returns)."""

    __slots__ = ("tensors", "event", "nbytes")

    def __init__(self, tensors: Dict[str, torch.Tensor], event=None):
        self.tensors = tensors
        self.event = event
        self.nbytes = sum(t.numel() * t.element_size() for t in tensors.values())

    def ready(self, stream=None) -> Dict[str, torch.Tensor]:
        """The tensors, usable on ``stream`` (CUDA; default the current
        stream): the stream waits for the copy, and each tensor is marked
        used there, so its memory is not reused before that stream's work
        on it is done."""
        if self.event is not None:
            stream = stream if stream is not None else torch.cuda.current_stream()
            stream.wait_event(self.event)
            for t in self.tensors.values():
                t.record_stream(stream)
        return self.tensors


class Prefetcher:
    """Host->device copies of batches that can run ahead of the programs
    consuming them. CUDA: each :meth:`place` fills the next of ``depth``
    pinned staging buffers (after that buffer's previous copy has
    completed) and copies it, non-blocking, on the prefetcher's own copy
    stream into fresh device tensors, recording an event after the copy.
    The CPU: plain copies. Every placement's bytes count as one upload
    (:mod:`~stmgcn_tpu_torch.obs.graphmon`)."""

    def __init__(self, device: torch.device, depth: int):
        if depth < 1:
            raise ValueError(f"a prefetcher needs at least one staging buffer, got {depth}")
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        # per ring slot: {name: pinned host tensor}, and the event after its last copy
        self._staging: list = [{} for _ in range(depth)]
        self._copied: list = [None] * depth
        self._next = 0

    @property
    def depth(self) -> int:
        return len(self._staging)

    def place(self, arrays: Dict[str, np.ndarray]) -> Placed:
        """``arrays`` (name -> float32-convertible numpy) on the device."""
        arrays = {k: np.asarray(v, np.float32) for k, v in arrays.items()}
        if not self.cuda:
            placed = Placed({k: torch.tensor(v, device=self.device) for k, v in arrays.items()})
        else:
            slot = self._next
            self._next = (slot + 1) % self.depth
            if self._copied[slot] is not None:  # the DMA has left this buffer
                self._copied[slot].synchronize()
            host = self._staging[slot]
            for name, a in arrays.items():
                buf = host.get(name)
                if buf is None or tuple(buf.shape) != a.shape:
                    buf = host[name] = torch.empty(a.shape, dtype=torch.float32,
                                                   pin_memory=True)
                buf.numpy()[...] = a
            with torch.cuda.stream(self.stream):
                # allocated on the copy stream: the consumer's record_stream
                # keeps the block from a later copy until its work is done
                dev = {name: torch.empty(a.shape, dtype=torch.float32, device=self.device)
                       for name, a in arrays.items()}
                for name, t in dev.items():
                    t.copy_(host[name], non_blocking=True)
                done = torch.cuda.Event()
                done.record(self.stream)
            self._copied[slot] = done
            placed = Placed(dev, done)
        graphmon.record_upload(placed.nbytes)
        return placed


class GraphPool(DeviceOps):
    """One CUDA-graph memory pool, one capture stream and one replay
    stream (the caller's current stream when made), shared by the
    programs of one engine generation or one trainer. ``lock`` orders
    every call of its programs, from the upload to the enqueue of the
    output copy. ``reserved_bytes`` adds up the device memory reserved
    while its programs captured: what the pool holds."""

    def __init__(self, device: torch.device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph pool needs a CUDA device, got {device}")
        super().__init__(device)
        self.handle = torch.cuda.graph_pool_handle()
        self.capture_stream = torch.cuda.Stream(self.device)
        self.lock = threading.Lock()
        self.reserved_bytes = 0

    @staticmethod
    def capturing() -> bool:
        """Whether the calling thread's work goes into the open capture (its
        current stream is capturing; autograd's device thread runs a
        backward on the capture stream too)."""
        return torch.cuda.is_current_stream_capturing()

    def warmup(self, fn: Callable):
        """Run ``fn`` on the capture stream, ordered after and before the
        replay stream's work."""
        self.capture_stream.wait_stream(self.stream)
        with torch.cuda.stream(self.capture_stream):
            out = fn()
        self.stream.wait_stream(self.capture_stream)
        return out

    def capture(self, fn: Callable, generator: Optional[torch.Generator] = None):
        """``(graph, outputs)``: ``fn`` captured into this pool; the
        random state of ``generator`` registered with the graph, so each
        replay draws from its seed and offset at that time. The garbage
        collector runs before the capture and not during it."""
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        # a dead reference cycle that holds CUDA graphs or memory (a trainer,
        # an engine generation) must not be collected while the capture
        # runs: its destructors' CUDA calls invalidate the capture. So
        # collect them first, and keep the collector off until the end
        gc.collect()
        # a capture starts by emptying the allocator's cache: empty it
        # first, so what is reserved during the capture is the pool's
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(self.device)
        self.capture_stream.wait_stream(self.stream)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.handle, stream=self.capture_stream,
                                  capture_error_mode="thread_local"):
                out = fn()
        finally:
            if collecting:
                gc.enable()
        self.stream.wait_stream(self.capture_stream)
        self.reserved_bytes += max(0, torch.cuda.memory_reserved(self.device) - before)
        return graph, out

    def replay(self, graph) -> None:
        with torch.cuda.stream(self.stream):
            graph.replay()


class Program:
    """``body(views) -> tensor`` over :class:`StaticInputs` of ``spec``,
    run eagerly on every call (the eager route). ``program(values)`` fills
    the inputs from ``values`` (name -> numpy array), runs, and returns the
    output as a host tensor. ``device_spec`` (name -> ``(shape, dtype)``)
    adds static device tensors to the views, which ``program(values,
    placed)`` fills from a :class:`Placed` batch by a device-to-device copy
    on the program's stream; ``before_wait`` runs on the host after the
    program and its readback are enqueued, before the wait for them (a
    prefetcher's next upload, overlapping the program). ``lock``
    (default: the program's own) is held from the fill to the enqueue of
    the output copy. ``upload_span`` names
    the trace span (:mod:`~stmgcn_tpu_torch.obs.trace`) of each call's fill
    and upload, with its bytes, while tracing is on."""

    captured = False

    def __init__(self, body: Callable, spec: dict, ops: DeviceOps, *, name: str = "program",
                 lock: Optional[threading.Lock] = None, upload_span: Optional[str] = None,
                 device_spec: Optional[dict] = None):
        self.name = name
        self.upload_span = upload_span
        self.ops = ops
        self._body = body
        self.inputs = StaticInputs(spec, ops)
        self.device_inputs = {name: torch.zeros(shape, dtype=dtype, device=ops.device)
                              for name, (shape, dtype) in (device_spec or {}).items()}
        self.views = {**self.inputs.views, **self.device_inputs}
        self._lock = lock if lock is not None else threading.Lock()
        self._staged = None  # event after the last upload out of the staging buffer

    def _land(self, placed: Placed) -> None:
        """Copy a placed batch into the device inputs, on the program's
        stream, after its upload."""
        if set(placed.tensors) != set(self.device_inputs):
            raise KeyError(f"{self.name}: device inputs {sorted(self.device_inputs)}, "
                           f"got {sorted(placed.tensors)}")
        with self.ops.stream_context():
            for name, t in placed.ready(self.ops.stream).items():
                self.device_inputs[name].copy_(t)

    def __call__(self, values: Dict[str, np.ndarray], placed: Optional[Placed] = None,
                 before_wait: Optional[Callable[[], None]] = None) -> torch.Tensor:
        trc = obs_trace.active_tracer() if self.upload_span else None
        with self._lock:
            if self._staged is not None:  # the last copy has left the staging buffer
                self._staged.synchronize()
            t0 = time.perf_counter() if trc is not None else 0.0
            self.inputs.fill(values)
            self._staged = self.ops.upload(self.inputs.words, self.inputs.staging)
            graphmon.record_upload(self.inputs.nbytes)
            if trc is not None:
                trc.record_span(self.upload_span, t0, time.perf_counter(),
                                {"bytes": self.inputs.nbytes})
            if placed is not None:
                self._land(placed)
            elif self.device_inputs:
                raise ValueError(f"{self.name} reads device inputs: pass a placed batch")
            out = self._execute()
            host, done = self.ops.download(out)
        if before_wait is not None:  # host work while the device runs the program
            before_wait()
        if done is not None:
            done.synchronize()
        return host

    def _execute(self) -> torch.Tensor:
        with self.ops.stream_context():
            return self._body(self.views)


class CapturedProgram(Program):
    """A :class:`Program` captured on its first call: the body runs once
    for real as the warm-up, is captured into ``pool`` (a
    :class:`GraphPool`; the CPU tests pass a stand-in), and every later
    call replays it, under the pool's lock. The first call returns the
    warm-up's output.
    ``swap`` marks a capture made for a serving engine's new parameter
    generation (counted apart, :mod:`~stmgcn_tpu_torch.obs.graphmon`);
    ``generator`` is a random generator whose state the graph registers.

    ``deltas`` is the capture's record of launches (``{(wrapper, attr):
    n}``), which each replay adds to the counts; ``capture_ms`` the
    capture's host time."""

    captured = True

    def __init__(self, body: Callable, spec: dict, pool, *, name: str = "program",
                 swap: bool = False, generator: Optional[torch.Generator] = None,
                 upload_span: Optional[str] = None, device_spec: Optional[dict] = None):
        super().__init__(body, spec, pool, name=name, lock=pool.lock, upload_span=upload_span,
                         device_spec=device_spec)
        self.swap = swap
        self.generator = generator
        self.graph = None
        self.outputs = None
        self.deltas: dict = {}
        self.capture_ms: Optional[float] = None

    def _execute(self) -> torch.Tensor:
        if self.graph is None:
            return self._capture()
        self.ops.replay(self.graph)
        counters.add(self.deltas)
        return self.outputs

    def _capture(self) -> torch.Tensor:
        views = self.views
        with _CAPTURE_LOCK:
            out = self.ops.warmup(lambda: self._body(views))
            t0 = time.perf_counter()
            try:
                with counters.recording(self.ops.capturing) as record:
                    graph, self.outputs = self.ops.capture(lambda: self._body(views),
                                                           self.generator)
            except Exception as e:
                raise RuntimeError(f"capturing {self.name} failed: {e}") from e
            self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.deltas = dict(record)
        self.graph = graph
        graphmon.record_capture(self.capture_ms, swap=self.swap)
        return out
