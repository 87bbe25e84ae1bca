"""``fleet-shape-class``: static fleet-planner math
(``stmgcn_tpu/analysis/fleet_check.py``).

The fleet path groups heterogeneous cities into shape classes
(``data/fleet.py`` ``plan_shape_classes``, deterministic in the cities'
sizes and the knobs), so this pass re-runs the planner on the config's
city sizes and flags a requested fleet that cannot hold: invalid knobs,
``fleet=True`` on a homogeneous dataset or on streamed data, cities no
class covers within the waste budget (they silently step one at a time),
and a class whose resident footprint (the members' series concatenated at
the rung, their int32 targets and the ``(members, M, K, rung, rung)``
dense support stack) exceeds the trainer's ``RESIDENT_CAP_BYTES`` floor.
As in the JAX pass, the planner sees the real sizes: on a region mesh the
trainer plans over sizes rounded up to a multiple of ``region``, which
this pass leaves out.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from stmgcn_tpu_torch.analysis._configs import finding, preset_configs, resident_budget
from stmgcn_tpu_torch.analysis.report import Finding

__all__ = ["check_fleet_shape_classes", "estimate_fleet_plan"]

#: demand channels and storage dtype (one float32 channel)
_CHANNELS, _ITEMSIZE = 1, 4


def _fleet_engaged(cfg) -> bool:
    t = cfg.train
    return t.fleet is True or (t.fleet is None and t.steps_per_superstep > 1)


def _city_sizes(cfg) -> Optional[list]:
    """Per-city node counts, or ``None`` for a homogeneous preset."""
    d = cfg.data
    if d.city_rows is None or max(1, d.n_cities) <= 1:
        return None
    nodes = [r * r for r in d.city_rows]
    if len(set(nodes)) <= 1 and not d.hetero:
        return None
    return nodes


def estimate_fleet_plan(cfg):
    """``(plan, class_bytes)``, each class's device-resident payload, or
    ``(None, None)`` for a homogeneous preset."""
    from stmgcn_tpu_torch.data.fleet import plan_shape_classes
    from stmgcn_tpu_torch.data.windowing import WindowSpec

    sizes = _city_sizes(cfg)
    if sizes is None:
        return None, None
    t, d, m = cfg.train, cfg.data, cfg.model
    plan = plan_shape_classes(sizes, max_classes=t.fleet_max_classes,
                              max_pad_waste=t.fleet_max_pad_waste)
    spec = WindowSpec(d.serial_len, d.daily_len, d.weekly_len, d.day_timesteps,
                      horizon=d.horizon)
    steps = list(d.city_timesteps) if d.city_timesteps is not None else [d.n_timesteps] * len(sizes)
    sup_entry = m.m_graphs * m.n_supports * _ITEMSIZE
    class_bytes = []
    for cls in plan.classes:
        rung = cls.n_nodes
        series = sum(steps[c] * rung * _CHANNELS * _ITEMSIZE for c in cls.cities)
        targets = sum(4 * max(0, spec.n_samples(steps[c])) for c in cls.cities)
        class_bytes.append(series + targets + len(cls.cities) * sup_entry * rung * rung)
    return plan, class_bytes


def check_fleet_shape_classes(configs: Optional[Iterable[Tuple[str, object]]] = None,
                              budget_bytes: Optional[int] = None) -> List[Finding]:
    """Every config's fleet plan (default: every preset)."""
    if budget_bytes is None:
        budget_bytes = resident_budget()
    findings = []

    def emit(name, message):
        findings.append(finding("fleet-shape-class", "fleet", name, message))

    for name, cfg in configs if configs is not None else preset_configs():
        t = cfg.train
        if not _fleet_engaged(cfg):
            continue
        explicit = t.fleet is True
        if t.fleet_max_classes < 1:
            emit(name, f"{name}: fleet_max_classes must be >= 1, got {t.fleet_max_classes} — "
                       "the planner rejects it at trainer construction")
            continue
        if not 0.0 <= t.fleet_max_pad_waste < 1.0:
            emit(name, f"{name}: fleet_max_pad_waste must be in [0, 1), got "
                       f"{t.fleet_max_pad_waste} — the planner rejects it at trainer "
                       "construction")
            continue
        sizes = _city_sizes(cfg)
        if sizes is None:
            if explicit:
                emit(name, f"{name}: fleet=True on a homogeneous dataset — there is nothing "
                           "to bucket and the trainer rejects the config; drop fleet or use "
                           "the plain superstep path")
            continue
        if explicit and t.data_placement == "stream":
            emit(name, f"{name}: fleet=True with data_placement='stream' — the fleet path "
                       "requires resident class series and the trainer rejects the "
                       "combination")
            continue
        plan, class_bytes = estimate_fleet_plan(cfg)
        if plan.unassigned:
            emit(name, f"{name}: {len(plan.unassigned)} of {len(sizes)} cities (indices "
                       f"{list(plan.unassigned)}) fit no shape class within "
                       f"fleet_max_classes={t.fleet_max_classes} / fleet_max_pad_waste="
                       f"{t.fleet_max_pad_waste} — they silently keep the per-step "
                       "fallback; raise the class budget or loosen the waste threshold")
        for cls, nbytes in zip(plan.classes, class_bytes):
            if nbytes > budget_bytes:
                degrade = ("the run OOMs at the first epoch" if t.data_placement == "resident"
                           else "placement degrades to streaming and the fleet path is "
                                "silently lost")
                emit(name, f"{name}: shape class N={cls.n_nodes} (cities {list(cls.cities)}) "
                           f"needs {nbytes:,} resident bytes but the per-core budget is "
                           f"{budget_bytes:,} — {degrade}; split the class or shrink the "
                           "series")
    return findings
