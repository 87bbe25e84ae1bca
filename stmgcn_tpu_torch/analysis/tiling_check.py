"""``tile-plan``: tiled-support plan contracts from config alone
(``stmgcn_tpu/analysis/tiling_check.py``).

The tiled path (``ops/tiling.py``, ``model.tiled``) commits at config
time to a tile size and a condensation waste budget; what this pass
checks before any adjacency is built:

- **knob ranges**: ``tile_size >= 1`` and ``tile_waste_budget`` in
  ``(0, 1]``;
- **mode conflicts**: ``model.tiled`` with ``model.sparse``, or with a
  >1-device mesh;
- **node-padding waste**: each city's node count rounds up to the tile
  grid; when the padding rows alone pass ``tile_waste_budget``,
  ``build_supports`` is certain to raise;
- **the CUDA kernels' tiles**: the block-CSR kernels take tiles of 64 and
  128 only (``ops/spmm.py`` ``KERNEL_TILES``), so any other tile raises at
  the first tiled forward on the card. This takes the place of the JAX
  pass's VMEM estimate of the Pallas kernels; the kernels' shared memory
  is :mod:`~stmgcn_tpu_torch.analysis.kernel_check`'s.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple, Union

from stmgcn_tpu_torch.analysis._configs import finding, preset_configs
from stmgcn_tpu_torch.analysis.kernel_check import KERNEL_TILES
from stmgcn_tpu_torch.analysis.report import Finding

__all__ = ["check_tile_plan", "tile_plan_violations"]


def _ceil_to(n: int, t: int) -> int:
    return -(-n // t) * t


def tile_plan_violations(model_cfg, n_nodes: Union[int, Sequence[int]]) -> List[str]:
    """The violations of one model config's tiled plan at ``n_nodes`` (one
    count per city for a heterogeneous preset); empty when the config is
    not tiled or the plan is viable."""
    m = model_cfg
    msgs: List[str] = []
    if not getattr(m, "tiled", False):
        return msgs
    if m.sparse:
        msgs.append("model.tiled and model.sparse are mutually exclusive — the offline tile "
                    "plan replaces the banded/sparse layout")
    if m.tile_size < 1:
        msgs.append(f"model.tile_size must be >= 1, got {m.tile_size} — plan_tiling rejects it")
        return msgs
    if not 0.0 < m.tile_waste_budget <= 1.0:
        msgs.append(f"model.tile_waste_budget must be in (0, 1], got {m.tile_waste_budget} — "
                    "build_supports can never accept a plan under it")
        return msgs
    sizes = list(n_nodes) if isinstance(n_nodes, (list, tuple)) else [n_nodes]
    for city, n in enumerate(sizes):
        padded = _ceil_to(max(int(n), 1), m.tile_size)
        waste = 1.0 - n / padded
        if waste > m.tile_waste_budget:
            msgs.append(f"city {city}: N={n} pads to {padded} on the tile_size={m.tile_size} "
                        f"grid — {waste:.3f} of every stored block row is padding, already "
                        f"past tile_waste_budget={m.tile_waste_budget}; build_supports is "
                        "guaranteed to raise (shrink the tile or raise the budget)")
    if m.tile_size not in KERNEL_TILES:
        msgs.append(f"tile_size={m.tile_size}: the CUDA block-CSR kernels take tiles "
                    f"{KERNEL_TILES} only — the first tiled forward on the card raises; "
                    "plan at 64 or 128")
    return msgs


def _city_nodes(cfg) -> List[int]:
    d = cfg.data
    cols = d.cols
    if d.city_rows is not None:
        return [r * (cols if cols is not None else r) for r in d.city_rows]
    return [d.rows * (cols if cols is not None else d.rows)]


def check_tile_plan(configs: Optional[Iterable[Tuple[str, object]]] = None) -> List[Finding]:
    """Every config's tiled plan (a no-op for untiled ones; default: every
    preset)."""
    findings = []
    for name, cfg in configs if configs is not None else preset_configs():
        if not getattr(cfg.model, "tiled", False):
            continue
        msgs = tile_plan_violations(cfg.model, _city_nodes(cfg))
        if cfg.mesh.n_devices > 1:
            msgs.insert(0, f"model.tiled on a {cfg.mesh.n_devices}-device mesh — tiled plans "
                           "are single-device artifacts and route_supports rejects the "
                           "combination")
        findings += [finding("tile-plan", "tile-plan", name, f"{name}: {m}") for m in msgs]
    return findings
