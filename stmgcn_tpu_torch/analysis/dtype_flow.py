"""Abstract dtype-dataflow interpretation over the traced step programs.

Counterpart of ``stmgcn_tpu/analysis/dtype_flow.py``: ONE walk per traced
aten graph (:mod:`.programs`) that tags every node with

- a **dtype lattice value** (operand dtypes in, output dtypes out, read off
  each node's fake value),
- a **provenance chain** (which program input, constant or cast site the
  value's dtype descends from, cast and promotion steps appended), and
- a **site role** from the JAX precision taxonomy: ``aten.mm``, ``bmm``,
  ``addmm`` and ``baddbmm`` are ``dot_general`` sites and their output
  dtype the ``dot_general_accum`` accumulator; ``sum``, ``mean``,
  ``_foreach_norm`` and ``linalg_vector_norm`` are ``reduce_sum``; ``max``,
  ``amax`` and ``topk`` are ``reduce_order``; ``sqrt`` and ``rsqrt`` are
  ``normalization``; ``_to_copy`` (and ``to``) with a dtype is a
  ``cast``. A kernel operator (``torch.ops.stmgcn.*``)
  takes its roles from its documented contract: its products' operand
  dtype (bf16 or float32 storage, bf16 in the LSTM's xla form) at
  ``dot_general``, a float32 sum at ``dot_general_accum``, and the
  backward kernels' float32 row sums (the LSTM bias gradient, B4's
  partials) at ``reduce_sum``. The port has no scan (its loops are
  unrolled) and no collective in a one-device program, so no
  ``scan_carry`` or ``psum`` site,

plus a per-program **dtype census** (bytes and FLOPs by dtype, the count
of dtype-changing casts, the node count, S and the nodes per kernel
operator) and the structured float64 events :mod:`.program_check`'s
``fp64-promotion`` rule formats, so the fp64 scan and the precision pass
share this one walk. Every site and event carries the port's source line
of its node (:func:`~stmgcn_tpu_torch.analysis.programs.source_of`).

:mod:`.precision_check` judges the resulting :class:`ProgramFlow` objects
against the declarative :class:`stmgcn_tpu_torch.config.PrecisionPolicy`;
this module only observes, it never emits findings.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["DtypeSite", "FLOAT_DTYPES", "ProgramFlow", "flow_program", "op_name",
           "program_flows"]

#: float dtype names the policy layer reasons about
FLOAT_DTYPES = ("float16", "bfloat16", "float32", "float64")

_DOT_OPS = frozenset({"mm", "bmm", "addmm", "baddbmm"})
_ACCUM_OPS = frozenset({"sum", "mean", "_foreach_norm", "linalg_vector_norm", "cumsum",
                        "prod", "cumprod"})
_ORDER_OPS = frozenset({"max", "amax", "min", "amin", "topk", "argmax", "argmin"})
_NORM_OPS = frozenset({"sqrt", "rsqrt", "_foreach_sqrt"})
_CAST_OPS = frozenset({"_to_copy", "to"})
_KERNEL_NS = "stmgcn"


def _dtype_name(dtype) -> Optional[str]:
    return None if dtype is None else str(dtype).replace("torch.", "")


def _tensors(val) -> list:
    """The tensors of a node's fake value (one, a sequence, or none)."""
    import torch

    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, (tuple, list)):
        return [t for t in val if isinstance(t, torch.Tensor)]
    return []


def _val_dtypes(node) -> Tuple[str, ...]:
    return tuple(_dtype_name(t.dtype) for t in _tensors(node.meta.get("val")))


def _nbytes(t) -> int:
    return int(t.numel()) * t.element_size()


def op_name(node) -> Tuple[str, str]:
    """``(namespace, name)`` of a call node's operator: ``("aten",
    "sum")``, ``("stmgcn", "fused_lstm_fwd")``, ``("", "getitem")``."""
    parts = str(node.target).split(".")
    if len(parts) >= 2 and parts[0] in ("aten", "prims", _KERNEL_NS):
        return parts[0], parts[1]
    return "", getattr(node.target, "__name__", str(node.target))


@dataclasses.dataclass(frozen=True)
class DtypeSite:
    """One role-classified dtype site in a walked program.

    ``index`` is the node's position among the graph's call nodes (stable
    for a trace, so a finding names the exact node), ``node`` its name.
    ``provenance`` is the dtype's descent chain, seed first:
    ``input:<label>[i]`` / ``const:<dtype>``, with ``cast:<src>-><dst>``
    and ``promote:<op>-><dtype>`` steps appended as the value flows.
    ``path``/``line``: the port's source line that made the node (None/0
    when none did)."""

    program: str
    index: int
    node: str
    op: str
    role: str
    dtype: str
    operand_dtypes: Tuple[str, ...]
    out_dtypes: Tuple[str, ...]
    provenance: Tuple[str, ...]
    detail: str = ""
    path: Optional[str] = None
    line: int = 0

    def describe(self) -> str:
        """The finding-message fragment naming this site exactly."""
        d = f" {self.detail}" if self.detail else ""
        return (f"{self.program}: node #{self.index} {self.node} ({self.op}){d} "
                f"[{self.role}] dtype {self.dtype}, provenance "
                f"{' -> '.join(self.provenance) or '?'}")


@dataclasses.dataclass
class ProgramFlow:
    """Everything one dtype walk learned about one traced program."""

    name: str
    sites: List[DtypeSite]
    #: {"bytes": {dtype: n}, "flops": {dtype: n}, "casts": n, "nodes": n,
    #: "steps": S, "kernels": {operator: n}}
    census: dict
    #: ordered float64 events for program_check's fp64-promotion messages:
    #: {"kind": "convert"|"out", "op": str, "node": str, "path": ..., "line": ...}
    fp64_events: List[dict]
    node_count: int
    in_labels: Tuple[str, ...]
    out_labels: Tuple[str, ...]
    in_dtypes: Tuple[Optional[str], ...]
    out_dtypes: Tuple[Optional[str], ...]


def _dot_flops(node, op: str) -> int:
    """2 x output size x contracted extent of one mm-family node."""
    a = node.args[1] if op in ("addmm", "baddbmm") else node.args[0]
    out = _tensors(node.meta.get("val"))
    lhs = _tensors(getattr(a, "meta", {}).get("val"))
    if not out or not lhs:
        return 0
    return 2 * int(out[0].numel()) * int(lhs[0].shape[-1])


def _kernel_roles(name: str, node) -> Tuple[Optional[str], int, bool]:
    """A kernel operator's contract: ``(operand dtype of its products,
    FLOPs, whether it has a float32 row sum)``."""
    vals = [getattr(a, "meta", {}).get("val") for a in node.args]
    if name in ("fused_lstm_fwd", "fused_lstm_bwd"):
        x_proj0, wh = vals[0], vals[1]
        form = node.args[4] if name == "fused_lstm_fwd" else node.args[9]
        operand = "bfloat16" if form in (1, 2) else "float32"
        lead, (R, T, four_h) = x_proj0.shape[:-3], x_proj0.shape[-3:]
        L, H = wh.shape[-3], four_h // 4
        flops = 2 * math.prod(lead) * R * T * four_h * (H + (L - 1) * 2 * H)
        return operand, flops * (2 if name == "fused_lstm_bwd" else 1), name == "fused_lstm_bwd"
    data, x = vals[0], vals[4]
    t = data.shape[-1]
    slots = math.prod(data.shape[:-2])  # stored blocks, padding slots included
    return _dtype_name(data.dtype), 2 * slots * t * t * int(x.shape[-1]), name == "spmm_stack_bwd"


def flow_program(name: str, graph, in_labels: Optional[Sequence[str]] = None,
                 out_labels: Optional[Sequence[str]] = None, steps: int = 1) -> ProgramFlow:
    """One walk over a traced aten graph (``torch.fx.GraphModule``).

    ``in_labels`` (one per placeholder, the registry's roles) seed the
    provenance chains; without them placeholders are labelled ``arg``.
    ``out_labels`` (one per output leaf) are recorded for the boundary
    checks (master parameter, loss dtype) but do not affect the walk."""
    from stmgcn_tpu_torch.analysis.programs import kernel_nodes, source_of

    nodes = list(graph.graph.nodes)
    placeholders = [n for n in nodes if n.op == "placeholder"]
    labels = list(in_labels) if in_labels is not None else ["arg"] * len(placeholders)
    if len(labels) != len(placeholders):
        raise ValueError(f"{name}: {len(labels)} in_labels for {len(placeholders)} inputs")

    sites: List[DtypeSite] = []
    fp64_events: List[dict] = []
    bytes_by: Dict[str, int] = {}
    flops_by: Dict[str, int] = {}
    casts = 0
    env: Dict[object, Tuple[str, ...]] = {}
    seen: Dict[str, int] = {}
    for node, label in zip(placeholders, labels):
        i = seen.get(label, 0)
        seen[label] = i + 1
        env[node] = (f"input:{label}[{i}]",)

    def prov(arg) -> Tuple[str, ...]:
        got = env.get(arg) if hasattr(arg, "op") else None
        if got is not None:
            return got
        dts = _val_dtypes(arg) if hasattr(arg, "meta") else ()
        return (f"const:{dts[0] if dts else '?'}",)

    def tensor_args(node) -> list:
        out = []
        for a in list(node.args) + list(node.kwargs.values()):
            for item in (a if isinstance(a, (tuple, list)) else (a,)):
                if hasattr(item, "meta") and _tensors(item.meta.get("val")):
                    out.append(item)
        return out

    index = 0
    for node in nodes:
        if node.op == "get_attr":
            dts = _val_dtypes(node)
            env[node] = (f"const:{dts[0] if dts else '?'}",)
            continue
        if node.op != "call_function":
            continue
        idx, index = index, index + 1
        ns, op = op_name(node)
        args = tensor_args(node)
        in_dts = tuple(d for a in args for d in _val_dtypes(a)[:1])
        out_dts = _val_dtypes(node)
        path, line = source_of(node)

        def site(role, dtype, chain, detail="", operands=in_dts):
            sites.append(DtypeSite(program=name, index=idx, node=node.name, op=f"{ns}.{op}",
                                   role=role, dtype=dtype or "?", operand_dtypes=operands,
                                   out_dtypes=out_dts, provenance=chain, detail=detail,
                                   path=path, line=line))

        for t in _tensors(node.meta.get("val")):
            dn = _dtype_name(t.dtype)
            bytes_by[dn] = bytes_by.get(dn, 0) + _nbytes(t)

        is_cast = op in _CAST_OPS and "dtype" in node.kwargs and bool(args)
        src = (_val_dtypes(args[0]) or (None,))[0] if is_cast else None
        dst = out_dts[0] if out_dts else None
        # the fp64 events: a cast to float64, then every float64 output
        if is_cast and dst == "float64" and src != "float64":
            fp64_events.append({"kind": "convert", "op": f"{ns}.{op}", "node": node.name,
                                "src": src, "path": path, "line": line})
        if "float64" in out_dts:
            fp64_events.append({"kind": "out", "op": f"{ns}.{op}", "node": node.name,
                                "path": path, "line": line})

        if is_cast and src != dst:
            casts += 1
            chain = prov(args[0]) + (f"cast:{src}->{dst}",)
            site("cast", dst, chain, operands=(src or "?",))
            env[node] = chain
            continue
        in_chains = [prov(a) for a in args]
        chain: Tuple[str, ...] = ()
        for a, c in zip(args, in_chains):
            if _val_dtypes(a)[:1] == (dst,):
                chain = c
                break
        if not chain:
            chain = in_chains[0] if in_chains else ()
            if dst in FLOAT_DTYPES:
                chain = chain + (f"promote:{op}->{dst}",)
        env[node] = chain

        first = in_chains[0] if in_chains else ()
        if ns == _KERNEL_NS:
            operand, flops, row_sum = _kernel_roles(op, node)
            site("dot_general", operand, first, "kernel products", operands=(operand, operand))
            site("dot_general_accum", "float32", first, "kernel accumulator")
            if row_sum:
                site("reduce_sum", "float32", first, "kernel row sum")
            flops_by[operand] = flops_by.get(operand, 0) + flops
        elif op in _DOT_OPS and any(d in FLOAT_DTYPES for d in in_dts):
            site("dot_general", in_dts[-1], first)
            site("dot_general_accum", dst, first, "accumulator")
            flops_by[dst] = flops_by.get(dst, 0) + _dot_flops(node, op)
        elif op in _ACCUM_OPS:
            for d in dict.fromkeys(out_dts):
                if d in FLOAT_DTYPES:
                    site("reduce_sum", d, first)
        elif op in _ORDER_OPS and dst in FLOAT_DTYPES:
            site("reduce_order", dst, first)
        elif op in _NORM_OPS and dst in FLOAT_DTYPES:
            site("normalization", dst, first)

    out_node = next(n for n in nodes if n.op == "output")
    outs = [a for a in (out_node.args[0] if isinstance(out_node.args[0], (tuple, list))
                        else (out_node.args[0],))]
    olabels = list(out_labels) if out_labels is not None else ["out"] * len(outs)
    if len(olabels) != len(outs):
        raise ValueError(f"{name}: {len(olabels)} out_labels for {len(outs)} outputs")
    count = sum(1 for n in nodes if n.op == "call_function")
    return ProgramFlow(
        name=name, sites=sites,
        census={"bytes": dict(sorted(bytes_by.items())), "flops": dict(sorted(flops_by.items())),
                "casts": casts, "nodes": count, "steps": steps,
                "kernels": dict(sorted(kernel_nodes(graph).items()))},
        fp64_events=fp64_events, node_count=count,
        in_labels=tuple(labels), out_labels=tuple(olabels),
        in_dtypes=tuple((_val_dtypes(n) or (None,))[0] for n in placeholders),
        out_dtypes=tuple((_val_dtypes(a) or (None,))[0] if hasattr(a, "meta") else None
                         for a in outs),
    )


#: (preset, route) -> {name: ProgramFlow}
_FLOW_CACHE: Dict[Tuple[str, str], Dict[str, ProgramFlow]] = {}


def program_flows(route: str = "cpu", preset_name: Optional[str] = None
                  ) -> Dict[str, ProgramFlow]:
    """One :class:`ProgramFlow` per registered program of ``route``.

    Cached per preset, route and process: the fp64-promotion scan
    (:mod:`.program_check`), the precision rules (:mod:`.precision_check`)
    and the lint gate's summary all consume this one walk, over the one
    trace (:func:`~stmgcn_tpu_torch.analysis.programs.traced_programs`)."""
    from stmgcn_tpu_torch.analysis.programs import CONTRACT_PRESET, traced_programs

    key = (preset_name or CONTRACT_PRESET, route)
    cached = _FLOW_CACHE.get(key)
    if cached is not None:
        return cached
    flows = {name: flow_program(name, p.graph, p.in_labels, p.out_labels, p.steps)
             for name, p in traced_programs(route, key[0]).items()}
    _FLOW_CACHE[key] = flows
    return flows
