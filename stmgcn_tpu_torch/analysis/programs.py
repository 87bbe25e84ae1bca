"""The contract registry: the port's step programs traced into aten graphs.

Counterpart of ``_trace_step_programs`` (``stmgcn_tpu/analysis/
jaxpr_check.py:174-330``). The JAX package traces its jitted step
functions into jaxprs; the port traces the bodies it actually captures into
CUDA graphs with ``make_fx(..., tracing_mode="fake")``, into one aten graph
per program with a dtype on every node. A fake trace runs no FLOPs and
launches nothing: each kernel operator (``torch.ops.stmgcn.*``, B1-B5)
takes its fake implementation and is one node.

The 13 programs keep the JAX names (:data:`PROGRAMS`), built from the
``smoke`` preset (:data:`CONTRACT_PRESET`, the JAX ``--preset`` default):

- ``train_step`` and ``train_step_checked``: ``Trainer._block_body`` on
  the streamed route, one step (a streamed program is one step), the
  second under ``checks="nan"``;
- ``train_superstep``: the materialized-windows route,
  ``train_series_superstep``: the window-free route, and
  ``train_series_superstep_health`` its health twin; ``train_fleet_superstep``:
  the same body over a fleet shape-class site of two members (the smoke
  city twice, as the JAX trace stacks two supports), each at
  :data:`BLOCK_STEPS` steps. The port's body unrolls its steps in Python,
  so (unlike JAX's scan) a block program's node count grows with S; each
  traced program records its S;
- ``eval_step``: ``train/step.py`` ``eval_step``;
- ``serve_bucket``: the serving engine's rung body (``serving/engine.py``
  :func:`~stmgcn_tpu_torch.serving.engine.rung_body`) at the mid-ladder
  rung, and ``serve_fleet_bucket`` the fleet engine's (``slots=True``, its
  dense class forward over a two-member stack);
- the ``_bf16`` twins of the four training programs at ``model.dtype =
  "bfloat16"`` (float32 master parameters), stochastic rounding off, as in
  JAX.

Each program's state is lifted into graph inputs, as the JAX programs take
``params`` and ``opt_state``: the parameters (with ``requires_grad``),
their ``.grad`` buffers, Adam's moments, the supports and the resident data
are fake copies swapped into the model, optimizer and site for the trace
(:func:`_swapped`), so the graph's placeholders carry the roles
(``param``, ``grad``, ``opt_state``, ``supports``, ...) that
:mod:`.dtype_flow` seeds its provenance chains with, and the real state is
never touched: tracing leaves every parameter, gradient and moment bit for
bit as it was. Every node carries the innermost source line of the port
that made it (``node.meta["stack_trace"]``, :class:`_SourceLines`): a
forward node the line that called it, a backward node the line of its
forward, so a finding on a node takes ``# stmgcn: ignore[rule]`` on that
line.

Routes (:func:`traced_programs`): ``"cpu"`` (the default, no GPU) builds
the trainers on the CPU and traces what the CPU runs: the float32 LSTM's
layered plain path, and the kernel route's operators where the CPU takes
them (bf16). ``"cuda"`` builds them on the card and traces what it
replays, the kernels as one node each; it raises where there is no card,
as every entry point does. Traces are cached per process, preset and
route.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["BLOCK_STEPS", "CONTRACT_PRESET", "PROGRAMS", "TracedProgram", "kernel_nodes",
           "traced_programs"]

#: the registered programs, in the JAX registry's order
PROGRAMS = ("serve_bucket", "train_step", "eval_step", "train_superstep",
            "train_series_superstep", "train_series_superstep_health",
            "train_fleet_superstep", "serve_fleet_bucket", "train_step_checked",
            "train_step_bf16", "train_superstep_bf16", "train_series_superstep_bf16",
            "train_fleet_superstep_bf16")
#: the preset the contract pass traces (the JAX CLI's default ``--preset``)
CONTRACT_PRESET = "smoke"
#: S of the traced block programs
BLOCK_STEPS = 2
#: members of the traced fleet class (the JAX trace's support stack)
FLEET_MEMBERS = 2

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ANALYSIS = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_PACKAGE)


@dataclasses.dataclass
class TracedProgram:
    """One traced program: its aten graph, one role label per placeholder
    and per output leaf, its steps (S of a block program, 1 otherwise)
    and tracing seconds."""

    name: str
    graph: object  # torch.fx.GraphModule
    in_labels: Tuple[str, ...]
    out_labels: Tuple[str, ...]
    steps: int
    seconds: float


def kernel_nodes(graph) -> Dict[str, int]:
    """The graph's nodes per kernel operator (``torch.ops.stmgcn.*``)."""
    counts: Dict[str, int] = {}
    for node in graph.graph.nodes:
        name = getattr(node.target, "name", None)
        if node.op == "call_function" and callable(name) and name().startswith("stmgcn::"):
            op = name().split("::", 1)[1].split(".")[0]
            counts[op] = counts.get(op, 0) + 1
    return counts


# -- source lines -----------------------------------------------------------------

def _port_line(frame) -> Optional[str]:
    """``"path:line"`` of the innermost frame in the port's package (the
    analysis passes' own frames left out), path relative to the repository."""
    while frame is not None:
        path = frame.f_code.co_filename
        if path.startswith(_PACKAGE) and not path.startswith(_ANALYSIS):
            return f"{os.path.relpath(path, _REPO)}:{frame.f_lineno}"
        frame = frame.f_back
    return None


def source_of(node) -> Tuple[Optional[str], int]:
    """``(path, line)`` a traced node was made at (``(None, 0)`` when no
    line of the port made it)."""
    trace = node.meta.get("stack_trace") or ""
    path, sep, line = trace.strip().rpartition(":")
    if not sep or not line.isdigit():
        return None, 0
    return path, int(line)


def _torch_function_mode():
    import torch
    from torch.overrides import TorchFunctionMode

    class SourceLines(TorchFunctionMode):
        """Marks the nodes a trace makes with the port's source line
        (``node.meta["stack_trace"]``, copied from fx's current meta): each
        torch call sets the line that made it, stamps it on the autograd
        nodes of its outputs, and each such autograd node sets it again
        while its backward runs, so a backward node names its forward's
        line; nodes of no stamped autograd node (gradient accumulation)
        keep the line that called ``backward``."""

        def __init__(self):
            super().__init__()
            import torch.fx.traceback as fx_traceback

            self._meta = fx_traceback.get_current_meta

        def _set(self, line: Optional[str]) -> None:
            meta = self._meta()
            if line is None:
                meta.pop("stack_trace", None)
            else:
                meta["stack_trace"] = line

        def __torch_function__(self, func, types, args=(), kwargs=None):
            line = _port_line(sys._getframe(1))
            if line is not None:
                self._set(line)
            out = func(*args, **(kwargs or {}))
            if line is not None and torch.is_grad_enabled():
                for t in (out if isinstance(out, (tuple, list)) else (out,)):
                    fn = getattr(t, "grad_fn", None) if isinstance(t, torch.Tensor) else None
                    if fn is not None and "stmgcn_line" not in fn.metadata:
                        fn.metadata["stmgcn_line"] = line
                        fn.register_prehook(lambda grads, line=line: self._set(line))
                        fn.register_hook(lambda grads_in, grads_out, line=line: self._set(None))
            return out

    return SourceLines()


# -- the trace ---------------------------------------------------------------------

@contextlib.contextmanager
def _swapped(model, params, grads, optimizer=None, moments=None):
    """``model``'s parameters replaced by ``params`` (each given its
    ``.grad`` from ``grads``) and ``optimizer``'s parameter and moment
    lists by them and ``moments`` ``(exp_avg, exp_avg_sq)``, while the
    block runs; the real ones are restored untouched."""
    owners = []
    for name, p in zip([n for n, _ in model.named_parameters()], params):
        module_name, _, attr = name.rpartition(".")
        module = model.get_submodule(module_name)
        owners.append((module, attr, module._parameters[attr]))
        module._parameters[attr] = p
    for p, g in zip(params, grads):
        p.grad = g
    saved = None
    if optimizer is not None:
        saved = optimizer.params, optimizer.exp_avg, optimizer.exp_avg_sq
        optimizer.params, optimizer.exp_avg, optimizer.exp_avg_sq = (
            list(params), list(moments[0]), list(moments[1]))
    try:
        yield
    finally:
        for module, attr, real in owners:
            module._parameters[attr] = real
        if saved is not None:
            optimizer.params, optimizer.exp_avg, optimizer.exp_avg_sq = saved


def _trace(run: Callable, inputs: List[Tuple[str, object]]) -> Tuple[object, tuple, tuple]:
    """``make_fx`` of ``run(tensors) -> [(label, tensor), ...]`` over the
    labelled real ``inputs``, fake: ``(graph, in_labels, out_labels)``."""
    import torch
    import torch.fx.traceback as fx_traceback
    from torch.fx.experimental.proxy_tensor import make_fx

    labels = tuple(label for label, _ in inputs)
    out_labels: List[str] = []

    def fn(tensors):
        with _torch_function_mode():
            outs = run(tensors)
        out_labels[:] = [label for label, _ in outs]
        return [t for _, t in outs]

    leaves = [t.detach().requires_grad_() if label == "param" else t for label, t in inputs]
    with fx_traceback.preserve_node_meta(), torch.random.fork_rng(devices=[]):
        graph = make_fx(fn, tracing_mode="fake")(leaves)
    return graph, labels, tuple(out_labels)


def _state_inputs(trainer) -> List[Tuple[str, object]]:
    opt = trainer.optimizer
    return ([("param", p) for p in opt.params] + [("grad", p.grad) for p in opt.params]
            + [("opt_state", m) for m in opt.exp_avg] + [("opt_state", v) for v in opt.exp_avg_sq])


def _state_outputs(n: int, tensors) -> List[Tuple[str, object]]:
    """The updated state, in the inputs' order (written in place)."""
    labels = ["param"] * n + ["grad"] * n + ["opt_state"] * (2 * n)
    return list(zip(labels, tensors[:4 * n]))


def _block_program(trainer, site, steps: int, health: bool, fleet: bool):
    """``(run, inputs)`` of ``trainer._block_body`` over ``site``: the
    state, the site's tensors and the program's static views as inputs."""
    import torch

    mode, b = "train", trainer.batch_size
    n = len(trainer.optimizer.params)
    route = trainer._route()
    data: List[Tuple[str, object]] = [("supports", site.supports)]
    views: List[Tuple[str, str, tuple, object]] = []
    if route == "stream":
        x_all, y_all = trainer.dataset.arrays(mode)
        views += [("x", "window", tuple(x_all[:b].shape), torch.float32),
                  ("y", "target", tuple(y_all[:b].shape), torch.float32)]
    else:
        views.append(("idx", "index", (steps, b), torch.int32))
        if route == "series":
            data += [("series", site.series), ("index", site.targets[mode]),
                     ("index", trainer.offsets)]
        else:
            x_all, y_all = trainer._resident_arrays(mode, ("city", 0))
            data += [("window", x_all), ("target", y_all)]
    views += [("mask", "mask", (steps, b), torch.float32),
              ("adam", "scalars", (steps, 2), torch.float32)]
    if fleet:
        data.append(("index", site.n_real))
        views.append(("slot", "index", (1,), torch.int32))
    device = trainer.device
    view_inputs = [(label, torch.zeros(shape, dtype=dtype, device=device))
                   for _, label, shape, dtype in views]
    inputs = _state_inputs(trainer) + data + view_inputs

    def run(tensors):
        state, rest = tensors[:4 * n], tensors[4 * n:]
        sup, rest = rest[0], rest[1:]
        fields = {"supports": sup}
        if route == "series":
            series, targets, offsets, rest = rest[0], rest[1], rest[2], rest[3:]
            fields.update(series=series, targets={mode: targets})
        elif route == "windows":
            fields["arrays"] = {mode: (rest[0], rest[1])}
            rest = rest[2:]
        if fleet:
            fields["n_real"], rest = rest[0], rest[1:]
        v = {name: t for (name, *_), t in zip(views, rest)}
        traced_site = dataclasses.replace(site, **fields)
        saved_offsets = trainer.offsets
        if route == "series":
            trainer.offsets = offsets
        try:
            with _swapped(trainer.model, state[:n], state[n:2 * n], trainer.optimizer,
                          (state[2 * n:3 * n], state[3 * n:])):
                out = trainer._block_body(traced_site, steps, mode, health)(v)
        finally:
            trainer.offsets = saved_offsets
        return [("stats" if health else "loss", out)] + _state_outputs(n, state)

    return run, inputs


def _fleet_site(trainer):
    """A fleet shape class of :data:`FLEET_MEMBERS` members over the
    trainer's one city (its supports stacked, every member's real-node
    count the whole city), as the fleet trainer builds one (``_Site`` of a
    class: stacked supports, ``(members,)`` int32 counts, the rung)."""
    import torch

    site = trainer._sites["city", 0]
    sup = site.supports
    n = sup.shape[-1]
    stack = torch.stack([sup] * FLEET_MEMBERS)
    n_real = torch.full((FLEET_MEMBERS,), n, dtype=torch.int32, device=trainer.device)
    return dataclasses.replace(site, supports=stack, n_real=n_real, rung=n)


def _eval_program(trainer):
    import torch

    from stmgcn_tpu_torch.train.step import eval_step

    b, n = trainer.batch_size, len(trainer.optimizer.params)
    x_all, y_all = trainer.dataset.arrays("train")
    device = trainer.device
    inputs = ([("param", p) for p in trainer.optimizer.params]
              + [("supports", trainer._sites["city", 0].supports),
                 ("window", torch.as_tensor(x_all[:b], device=device)),
                 ("target", torch.as_tensor(y_all[:b], device=device)),
                 ("mask", torch.ones(b, device=device))])

    def run(tensors):
        params, (sup, x, y, mask) = tensors[:n], tensors[n:]
        with _swapped(trainer.model, params, [None] * n):
            loss, pred = eval_step(trainer.model, sup, x, y, mask, trainer.loss)
        return [("loss", loss), ("prediction", pred)]

    return run, inputs


def _serve_program(trainer, bucket: int, fleet: bool):
    """The rung body (:func:`~stmgcn_tpu_torch.serving.engine.rung_body`)
    over the trainer's model at ``bucket`` rows: the engine's dense
    forward, or with ``fleet`` the fleet engine's dense class forward
    (``slots``) over a two-member class."""
    import torch

    from stmgcn_tpu_torch.serving.engine import _bucket_program, rung_body
    from stmgcn_tpu_torch.serving.fleet import _dense_forward

    ds, n = trainer.dataset, len(trainer.optimizer.params)
    device = trainer.device
    site = _fleet_site(trainer) if fleet else trainer._sites["city", 0]
    history = torch.zeros((bucket, ds.window.seq_len, ds.n_nodes, ds.n_feats), device=device)
    inputs = [("param", p) for p in trainer.optimizer.params] + [("supports", site.supports)]
    if fleet:
        inputs += [("index", site.n_real),
                   ("index", torch.zeros(bucket, dtype=torch.int32, device=device))]
    inputs.append(("history", history))

    def run(tensors):
        params, rest = tensors[:n], tensors[n:]
        models = {"dense": trainer.model}
        if fleet:
            sup, n_real, slots, hist = rest
            body = rung_body(_dense_forward(models, sup, n_real), slots=True)
            v = {"history": hist, "slots": slots}
        else:
            sup, hist = rest
            body = rung_body(functools.partial(_bucket_program(sup, device), trainer.model))
            v = {"history": hist}
        with _swapped(trainer.model, params, [None] * n):
            out = body(v)
        return [("prediction", out)]

    return run, inputs


def _trainers(preset_name: str, device):
    """``{(precision, route, checks): Trainer}`` over one dataset: the
    streamed, materialized and window-free routes at float32 and bf16
    compute, and the streamed route under ``checks="nan"``."""
    from stmgcn_tpu_torch.config import preset
    from stmgcn_tpu_torch.experiment import build_dataset, build_trainer

    base = preset(preset_name)
    dataset = build_dataset(base)
    out = {}
    for dtype in ("float32", "bfloat16"):
        for route in ("stream", "windows", "series"):
            for checks in ((None, "nan") if route == "stream" and dtype == "float32"
                           else (None,)):
                cfg = preset(preset_name)
                cfg.model.dtype = dtype
                cfg.train.precision = "bf16" if dtype == "bfloat16" else "fp32"
                cfg.train.sr_seed = None
                cfg.train.checks = checks
                cfg.train.data_placement = "stream" if route == "stream" else "resident"
                cfg.train.window_free = route == "series" if route != "stream" else None
                out[dtype, route, checks] = build_trainer(
                    cfg, device=device, graphs=False, verbose=False, dataset=dataset)
    return out


def _registry(preset_name: str, device) -> Dict[str, tuple]:
    """``{name: (run, inputs, steps)}`` of the 13 programs."""
    from stmgcn_tpu_torch.config import preset

    trainers = _trainers(preset_name, device)
    ladder = preset(preset_name).serving.buckets
    bucket = ladder[len(ladder) // 2]
    s = BLOCK_STEPS
    reg = {}
    for dtype, suffix in (("float32", ""), ("bfloat16", "_bf16")):
        stream = trainers[dtype, "stream", None]
        windows = trainers[dtype, "windows", None]
        series = trainers[dtype, "series", None]
        reg["train_step" + suffix] = _block_program(
            stream, stream._sites["city", 0], 1, False, False) + (1,)
        reg["train_superstep" + suffix] = _block_program(
            windows, windows._sites["city", 0], s, False, False) + (s,)
        reg["train_series_superstep" + suffix] = _block_program(
            series, series._sites["city", 0], s, False, False) + (s,)
        reg["train_fleet_superstep" + suffix] = _block_program(
            series, _fleet_site(series), s, False, True) + (s,)
        if not suffix:
            reg["train_series_superstep_health"] = _block_program(
                series, series._sites["city", 0], s, True, False) + (s,)
            checked = trainers["float32", "stream", "nan"]
            reg["train_step_checked"] = _block_program(
                checked, checked._sites["city", 0], 1, False, False) + (1,)
            reg["eval_step"] = _eval_program(stream) + (1,)
            reg["serve_bucket"] = _serve_program(stream, bucket, False) + (1,)
            reg["serve_fleet_bucket"] = _serve_program(stream, bucket, True) + (1,)
    return {name: reg[name] for name in PROGRAMS}


#: (preset, route) -> {name: TracedProgram}
_TRACE_CACHE: Dict[Tuple[str, str], Dict[str, TracedProgram]] = {}


def traced_programs(route: str = "cpu", preset_name: str = CONTRACT_PRESET
                    ) -> Dict[str, TracedProgram]:
    """Every registered program of ``preset_name`` traced on ``route``
    (``"cpu"`` or ``"cuda"``; the module docstring), cached per process.
    ``"cuda"`` raises without a card. Launches nothing and leaves every
    trainer's state as it was."""
    if route not in ("cpu", "cuda"):
        raise ValueError(f"route must be 'cpu' or 'cuda', got {route!r}")
    key = (preset_name, route)
    cached = _TRACE_CACHE.get(key)
    if cached is not None:
        return cached
    from stmgcn_tpu_torch.ops.layers import resolve_device

    device = resolve_device(route)
    traced = {}
    for name, (run, inputs, steps) in _registry(preset_name, device).items():
        t0 = time.perf_counter()
        graph, in_labels, out_labels = _trace(run, inputs)
        traced[name] = TracedProgram(name, graph, in_labels, out_labels, steps,
                                     time.perf_counter() - t0)
    _TRACE_CACHE[key] = traced
    return traced
