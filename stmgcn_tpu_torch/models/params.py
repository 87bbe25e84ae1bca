"""Weight conversion between the JAX package's flax tree and the port, and
the master -> compute casts of mixed-precision training.

The JAX flagship stores its M branches in one of two layouts
(``stmgcn_tpu/models/params.py``):

- **vmapped**: one ``params/branches`` subtree whose leaves carry a
  leading ``(M, ...)`` axis;
- **looped**: subtrees ``params/branch_0 .. branch_{M-1}``.

The port's :class:`~stmgcn_tpu_torch.models.st_mgcn.STMGCN` always holds
the vmapped form (module ``branches`` with a leading ``M`` axis), so its
``state_dict`` keys are the flax paths joined with dots. The one change of
layout is the Dense layers: flax ``kernel`` is ``(in, out)``, the port's
``weight`` is ``nn.Linear``'s ``(out, in)``. Conversions are exact in both
directions (transposes and stacking only).

Checkpoints carry the optimizer too, as the optax chain state the JAX
trainer keeps (``stmgcn_tpu/train/step.py`` ``make_optimizer``): one
entry per chained part, keyed by its index — the clip and L2 parts with
empty states, Adam's ``{count, mu, nu}`` and, under the cosine schedule,
the schedule's ``{count}`` (the constant ``scale`` is empty).
:func:`to_optax_state` and :func:`from_optax_state` map Adam's moments
through the same converter as the parameters, so a Dense kernel's moments
are transposed with it.

On a branch mesh each rank holds a slice of the stacked branches:
:func:`from_jax_params` takes the rank's slice with ``branches=``, and a
checkpoint's tree is always the whole, mesh-free one (the trainer gathers
the slices before it converts).

Mixed precision (``stmgcn_tpu/models/params.py:56-131``):
:func:`compute_cast` casts a tree of float32 masters to the compute dtype,
round to nearest even, or stochastically rounded through
:func:`sr_cast_bf16`, whose noise is an argument, as the JAX function's is:
``jax.random``'s bits cannot be drawn in torch, so the port draws its own
from an explicit ``torch.Generator`` and a test hands both the same numpy
noise. :func:`leaf_dtype_census` counts a tree's leaves and bytes per dtype.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = [
    "OPTAX_PARTS",
    "compute_cast",
    "from_jax_params",
    "from_optax_state",
    "health_groups",
    "jax_layout",
    "leaf_dtype_census",
    "sr_cast_bf16",
    "to_jax_params",
    "to_optax_state",
]

_VMAPPED_KEY = "branches"


def _looped_key(m: int) -> str:
    """The looped layout's subtree of branch ``m``."""
    return f"branch_{m}"


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def from_jax_params(variables, m_graphs: int, branches: Optional[slice] = None) -> dict:
    """Flax ``{"params": ...}`` tree (numpy leaves, either layout) -> the
    port's ``state_dict`` (float32 CPU tensors). ``branches`` (a branch
    mesh rank's slice of the M stacked branches,
    ``MeshPlacement.branches``) keeps that slice of every stacked
    ``(M, ...)`` leaf."""
    params = dict(variables["params"])
    looped = [_looped_key(m) for m in range(m_graphs)]
    if _VMAPPED_KEY not in params:
        missing = [k for k in looped if k not in params]
        if missing:
            raise ValueError(
                f"neither a vmapped ({_VMAPPED_KEY!r}) nor a looped tree: "
                f"missing {missing}"
            )
        per_branch = [dict(_flatten(params.pop(k))) for k in looped]
        params[_VMAPPED_KEY] = {
            ".".join(path): np.stack([np.asarray(b[path]) for b in per_branch])
            for path in per_branch[0]
        }
    state = {}
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf, dtype=np.float32)
        if path[0] == _VMAPPED_KEY and arr.shape[:1] != (m_graphs,):
            raise ValueError(
                f"{'/'.join(path)}: branch axis is {arr.shape[:1]}, expected ({m_graphs},)"
            )
        if path[0] == _VMAPPED_KEY and branches is not None:
            arr = arr[branches]
        name = ".".join(path)
        if name.rsplit(".", 1)[-1] == "kernel":
            name = name[: -len("kernel")] + "weight"
            arr = np.swapaxes(arr, -1, -2)
        state[name] = torch.from_numpy(np.array(arr, dtype=np.float32))  # own, writable copy
    return state


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for name, value in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def to_jax_params(state_dict, m_graphs: int, *, layout: str = "vmapped") -> dict:
    """The port's ``state_dict`` -> flax ``{"params": ...}`` tree of numpy
    arrays, in the ``"vmapped"`` or ``"looped"`` layout."""
    if layout not in ("vmapped", "looped"):
        raise ValueError(f"layout must be 'vmapped' or 'looped', got {layout!r}")
    flat = {}
    for name, tensor in state_dict.items():
        arr = tensor.detach().cpu().numpy()
        if name.endswith(".weight"):
            name = name[: -len("weight")] + "kernel"
            arr = np.swapaxes(arr, -1, -2)
        flat[name] = np.ascontiguousarray(arr)
    if layout == "looped":
        prefix = _VMAPPED_KEY + "."
        for name in [n for n in flat if n.startswith(prefix)]:
            stacked = flat.pop(name)
            for m in range(m_graphs):
                flat[f"{_looped_key(m)}.{name[len(prefix):]}"] = stacked[m]
    return {"params": _nest(flat)}


def health_groups(names, m_graphs: int, *, layout: str = "vmapped") -> tuple:
    """The JAX health stats' layer groups over the port's parameters: the
    sorted top-level keys of the flax tree :func:`to_jax_params` builds in
    ``layout`` (``stmgcn_tpu/train/step.py`` ``health_group_names``), each
    with its members as ``(index into names, branch)`` pairs: ``branch`` is
    None for a whole parameter, or ``m`` for the slice ``[m]`` of a stacked
    branch parameter that the looped layout files under ``branch_m``.
    Returns ``((group, ((index, branch), ...)), ...)``."""
    if layout not in ("vmapped", "looped"):
        raise ValueError(f"layout must be 'vmapped' or 'looped', got {layout!r}")
    groups: dict = {}
    for i, name in enumerate(names):
        top = name.split(".", 1)[0]
        if layout == "looped" and top == _VMAPPED_KEY:
            for m in range(m_graphs):
                groups.setdefault(_looped_key(m), []).append((i, m))
        else:
            groups.setdefault(top, []).append((i, None))
    return tuple((g, tuple(groups[g])) for g in sorted(groups))


def jax_layout(support_mode: str, loop: Optional[bool] = None) -> str:
    """The branch layout the JAX package gives a model of this support
    mode: ``loop`` None derives it (looped, ``branch_m``, for sparse,
    tiled, banded and mixed supports; vmapped for dense ones); a bool
    says it (a model's ``loop_layout``: looped under an active region
    strategy at ``branch == 1``, vmapped for branch-stacked strips on a
    ``branch`` mesh; ``stmgcn_tpu/experiment.py`` ``build_model``), so a
    checkpoint's tree matches the JAX model the same config builds."""
    if loop is None:
        loop = support_mode != "dense"
    return "looped" if loop else "vmapped"


#: the parts ``make_optimizer`` may chain, in chain order
OPTAX_PARTS = ("clip", "l2", "adam", "scale", "schedule")


def _count(value: int) -> np.ndarray:
    return np.asarray(value, dtype=np.int32)


def to_optax_state(parts, count: int, mu: dict, nu: dict, m_graphs: int, *,
                   layout: str = "vmapped") -> dict:
    """The optax chain state as flax stores it: ``{"<i>": state of part
    i}`` over ``parts`` (names from :data:`OPTAX_PARTS`, in chain order),
    with Adam's ``mu``/``nu`` given as ``state_dict``-keyed moment
    tensors and ``count`` the optimizer steps taken."""
    tree = {}
    for i, part in enumerate(parts):
        if part == "adam":
            tree[str(i)] = {
                "count": _count(count),
                "mu": to_jax_params(mu, m_graphs, layout=layout),
                "nu": to_jax_params(nu, m_graphs, layout=layout),
            }
        elif part == "schedule":
            tree[str(i)] = {"count": _count(count)}
        elif part in OPTAX_PARTS:
            tree[str(i)] = {}
        else:
            raise ValueError(f"unknown optimizer part {part!r}")
    return tree


def from_optax_state(tree: dict, parts, m_graphs: int, branches: Optional[slice] = None):
    """``(count, mu, nu)`` from a stored optax chain state over ``parts``
    (``state_dict``-keyed float32 moments, either layout; ``branches`` as
    :func:`from_jax_params`'s); raises when the stored chain is not the one
    ``parts`` describes."""
    parts = tuple(parts)
    keys = sorted(tree, key=lambda k: (len(k), k))
    if keys != [str(i) for i in range(len(parts))]:
        raise ValueError(f"optimizer state has entries {keys}, the chain {tuple(parts)} "
                         f"needs {len(parts)}")
    adam = tree[str(parts.index("adam"))]
    for i, part in enumerate(parts):
        want = {"adam": {"count", "mu", "nu"}, "schedule": {"count"}}.get(part, set())
        if set(tree[str(i)]) != want:
            raise ValueError(f"optimizer state entry {i} ({part}) holds "
                             f"{sorted(tree[str(i)])}, expected {sorted(want)}")
    count = int(np.asarray(adam["count"]))
    if "schedule" in parts:
        if int(np.asarray(tree[str(parts.index("schedule"))]["count"])) != count:
            raise ValueError("optimizer state: the schedule's count differs from Adam's")
    return (count, from_jax_params(adam["mu"], m_graphs, branches),
            from_jax_params(adam["nu"], m_graphs, branches))


# -- mixed precision: the master -> compute casts ------------------------------

def leaf_dtype_census(tree) -> dict:
    """Per-dtype ``{"leaves": n, "bytes": n}`` of a (nested) dict of tensors
    or arrays, keyed by dtype name ("float32", "bfloat16", ...), as the JAX
    census."""
    census: dict = {}
    for _, leaf in _flatten(tree):
        leaf = torch.as_tensor(leaf)
        name = str(leaf.dtype).replace("torch.", "")
        entry = census.setdefault(name, {"leaves": 0, "bytes": 0})
        entry["leaves"] += 1
        entry["bytes"] += leaf.numel() * leaf.element_size()
    return census


def _round_to_bf16_stochastic(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """``f32 -> bf16`` by truncation after adding ``noise`` (``U[0, 2^16)``)
    to the raw bits: the JAX ``_round_to_bf16_stochastic``, in uint32
    arithmetic (wrapping mod 2^32) carried in int64."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    rounded = (bits + noise.to(torch.int64)) & 0xFFFF0000
    rounded = torch.where(rounded >= 1 << 31, rounded - (1 << 32), rounded)
    return rounded.to(torch.int32).view(torch.float32).to(torch.bfloat16)


class _SRCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, noise):
        return _round_to_bf16_stochastic(x, noise)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.float32), None


def sr_cast_bf16(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Stochastically rounded ``f32 -> bf16`` cast with a straight-through
    gradient (the cotangent comes back as float32). ``noise`` is an integer
    tensor of ``x``'s shape holding ``U[0, 2^16)`` draws; the same noise
    gives JAX's ``sr_cast_bf16`` bit for bit."""
    if noise.shape != x.shape:
        raise ValueError(f"noise {tuple(noise.shape)} must have x's shape {tuple(x.shape)}")
    return _SRCast.apply(x, noise)


def compute_cast(tree: dict, dtype, generator=None, *, m_graphs: Optional[int] = None,
                 branches: Optional[slice] = None) -> dict:
    """The float leaves of a flat dict of tensors cast to the compute
    ``dtype`` (others pass through): round to nearest even, or with
    ``generator`` (bf16 only) stochastically rounded through
    :func:`sr_cast_bf16`, one noise draw per leaf in the dict's order, on the
    generator's device. Gradients flow back to the masters in float32.
    ``branches`` (a branch mesh rank's slice of the ``m_graphs`` stacked
    branches, ``MeshPlacement.branches``): each stacked leaf (a
    ``state_dict`` key under ``branches.``) holds that slice, draws its
    noise at the whole stack's shape and keeps the slice's, so the rank
    rounds as one device does, bit for bit."""
    if generator is None:
        return {k: v.to(dtype) if v.is_floating_point() else v for k, v in tree.items()}
    if dtype != torch.bfloat16:
        raise ValueError(f"stochastic rounding is defined for bfloat16 only, got {dtype}")
    out = {}
    for k, v in tree.items():
        if v.is_floating_point():
            stacked = branches is not None and k.split(".", 1)[0] == _VMAPPED_KEY
            shape = (m_graphs,) + tuple(v.shape[1:]) if stacked else v.shape
            noise = torch.randint(0, 1 << 16, shape, generator=generator,
                                  device=generator.device, dtype=torch.int64)
            v = sr_cast_bf16(v, (noise[branches] if stacked else noise).to(v.device))
        out[k] = v
    return out
