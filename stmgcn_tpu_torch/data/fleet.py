"""Fleet shape-class planner: bucket cities by padded node count.

Copy of ``stmgcn_tpu/data/fleet.py``. The planner groups heterogeneous
cities into a bounded set of *shape classes*, each a node-count rung
``N_c`` every member is padded up to, so that one fleet training block
(training) or one bucket ladder (serving) covers every member city at one
shape. Rung selection reuses the serving ladder's covering rule
(:func:`stmgcn_tpu_torch.serving.bucketing.smallest_covering_bucket`):
greedy descending — the largest unassigned city opens a rung, and every
city whose node padding would waste at most ``max_pad_waste`` of the rung
joins it. Cities left over once ``max_classes`` rungs exist are returned
as ``unassigned`` and keep the per-city path.

Padded rows are inert in training and serving alike: supports are zero in
padded rows and columns, the contextual gate pools over a real-node count,
and the ``(B, N)`` loss mask zeroes padded regions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from stmgcn_tpu_torch.serving.bucketing import smallest_covering_bucket

__all__ = ["FleetPlan", "ShapeClass", "plan_shape_classes"]


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ShapeClass:
    """One compiled shape: cities padded to a shared ``(n_nodes, nnz)``."""

    #: rung node count every member is padded up to
    n_nodes: int
    #: member city indices, in dataset order
    cities: tuple
    #: members' real node counts, aligned with ``cities``
    city_n_nodes: tuple
    #: dense support entries at the rung (per graph view x hop) — the
    #: padded supports are materialized dense, so nnz == n_nodes**2
    nnz: int
    #: members' real support nnz (``None`` entries when not measured)
    city_nnz: tuple

    def pad_for(self, city: int) -> int:
        return self.n_nodes - self.city_n_nodes[self.cities.index(city)]

    @property
    def node_waste(self) -> float:
        """Worst member's padded-node fraction of the rung."""
        return max(1.0 - n / self.n_nodes for n in self.city_n_nodes)

    @property
    def nnz_waste(self) -> float:
        """Worst member's padded fraction of the rung's dense support."""
        known = [z for z in self.city_nnz if z is not None]
        if not known:
            return self.node_waste
        return max(1.0 - z / self.nnz for z in known)


@dataclasses.dataclass(frozen=True)
class FleetPlan:
    """Shape classes covering a city fleet (+ the cities that fit none)."""

    classes: tuple
    #: city indices that fit no class (per-city fallback path)
    unassigned: tuple

    @property
    def class_of(self) -> dict:
        return {c: i for i, cls in enumerate(self.classes) for c in cls.cities}

    @property
    def slot_of(self) -> dict:
        """city -> position inside its class's stacked support tensor."""
        return {c: s for cls in self.classes for s, c in enumerate(cls.cities)}

    def pad_for(self, city: int) -> Optional[int]:
        i = self.class_of.get(city)
        return None if i is None else self.classes[i].pad_for(city)

    @property
    def node_waste(self) -> float:
        return max((cls.node_waste for cls in self.classes), default=0.0)


def plan_shape_classes(
    city_n_nodes: Sequence[int],
    *,
    city_nnz: Optional[Sequence[int]] = None,
    max_classes: int = 8,
    max_pad_waste: float = 0.5,
    node_multiple: int = 1,
) -> FleetPlan:
    """Group cities into at most ``max_classes`` node-count rungs.

    Greedy descending: the largest not-yet-covered city opens a rung at
    its (``node_multiple``-rounded) node count; membership is then
    resolved through :func:`smallest_covering_bucket` over the final
    rung ladder, so a small city joins the tightest rung that wastes at
    most ``max_pad_waste`` of its nodes. Cities that no rung covers
    within the waste budget land in ``unassigned``.
    """
    if max_classes < 1:
        raise ValueError(f"max_classes must be >= 1, got {max_classes}")
    if not 0.0 <= max_pad_waste < 1.0:
        raise ValueError(f"max_pad_waste must be in [0, 1), got {max_pad_waste}")
    sizes = [int(n) for n in city_n_nodes]
    if any(n <= 0 for n in sizes):
        raise ValueError(f"city node counts must be positive, got {sizes}")
    nnzs = list(city_nnz) if city_nnz is not None else [None] * len(sizes)
    if len(nnzs) != len(sizes):
        raise ValueError("city_nnz must align with city_n_nodes")

    # Pass 1 — open rungs largest-first until every city is covered or
    # the class budget runs out. A rung covers city n when the pad
    # fraction (rung - n) / rung stays within budget.
    rungs: list = []
    uncovered = sorted(set(sizes), reverse=True)
    while uncovered and len(rungs) < max_classes:
        rung = _round_up(uncovered[0], node_multiple)
        rungs.append(rung)
        uncovered = [n for n in uncovered if rung - n > max_pad_waste * rung]
    ladder = sorted(rungs)

    # Pass 2 — final membership via the serving ladder's covering rule.
    members: dict = {r: [] for r in ladder}
    unassigned = []
    for city, n in enumerate(sizes):
        # the first pass-1 rung comes from the largest city, so the
        # ladder top always covers every n and this cannot raise
        rung = smallest_covering_bucket(n, ladder)
        if rung - n > max_pad_waste * rung:
            unassigned.append(city)
        else:
            members[rung].append(city)

    classes = tuple(
        ShapeClass(
            n_nodes=rung,
            cities=tuple(cs),
            city_n_nodes=tuple(sizes[c] for c in cs),
            nnz=rung * rung,
            city_nnz=tuple(nnzs[c] for c in cs),
        )
        for rung, cs in members.items()
        if cs
    )
    return FleetPlan(classes=classes, unassigned=tuple(unassigned))
