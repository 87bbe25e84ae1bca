"""Weight conversion between the JAX package's flax tree and the port.

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
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_jax_params", "to_jax_params"]

_VMAPPED_KEY = "branches"


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def from_jax_params(variables, m_graphs: int) -> dict:
    """Flax ``{"params": ...}`` tree (numpy leaves, either layout) -> the
    port's ``state_dict`` (float32 CPU tensors)."""
    params = dict(variables["params"])
    looped = [f"branch_{m}" for m in range(m_graphs)]
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
                flat[f"branch_{m}.{name[len(prefix):]}"] = stacked[m]
    return {"params": _nest(flat)}
