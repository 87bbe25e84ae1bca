"""``resident-memory``: static data-residency math
(``stmgcn_tpu/analysis/resident_check.py``).

Resident placement keeps the training data on the device for the whole
run, in one of two representations (``train/trainer.py``):

- **window-free** (the default): the normalized ``(T, N, C)`` series per
  city plus int32 target vectors and the offset table, one copy of every
  timestep;
- **materialized** windows (``window_free=False``): ``(S, seq_len, N, C)``
  sample arrays and their targets, a ~``seq_len``x copy.

:func:`estimate_resident_bytes` derives both from the config alone (one
float32 channel, as the synthetic data and the pipeline store it), the
arithmetic of ``DemandDataset.resident_nbytes`` / ``nbytes``, and
:func:`check_resident_memory` flags a requested ``data_placement=
"resident"`` whose representation cannot fit the trainer's
``RESIDENT_CAP_BYTES`` floor, or that asks for materialized windows on a
multi-device mesh. ``"auto"`` never errors: it streams by design. Unlike
the JAX pass, heterogeneous cities count as window-free here, as the
port's trainer serves them (the JAX pass assumes them materialized).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from stmgcn_tpu_torch.analysis._configs import finding, preset_configs, resident_budget
from stmgcn_tpu_torch.analysis.report import Finding

__all__ = ["check_resident_memory", "estimate_resident_bytes"]

#: demand channels and storage dtype (one float32 channel)
_CHANNELS, _ITEMSIZE = 1, 4


def estimate_resident_bytes(cfg) -> dict:
    """``{"series_bytes", "materialized_bytes", "ratio"}`` summed over the
    config's cities: the window-free payload (series, int32 targets,
    offset table) against the materialized ``(x, y)`` windows."""
    from stmgcn_tpu_torch.data.windowing import WindowSpec

    d = cfg.data
    spec = WindowSpec(d.serial_len, d.daily_len, d.weekly_len, d.day_timesteps,
                      horizon=d.horizon)
    n_cities = max(1, d.n_cities)
    cols = d.cols if d.cols is not None else d.rows
    nodes = ([r * r for r in d.city_rows] if d.city_rows is not None
             else [d.rows * cols] * n_cities)
    steps = list(d.city_timesteps) if d.city_timesteps is not None else [d.n_timesteps] * n_cities
    series = materialized = targets = 0
    for n, t in zip(nodes, steps):
        s = max(0, spec.n_samples(t))
        series += t * n * _CHANNELS * _ITEMSIZE
        targets += 4 * s
        materialized += s * (spec.seq_len + spec.horizon) * n * _CHANNELS * _ITEMSIZE
    series_total = series + targets + 4 * spec.seq_len
    return {"series_bytes": series_total, "materialized_bytes": materialized,
            "ratio": materialized / series_total if series_total else 0.0}


def check_resident_memory(configs: Optional[Iterable[Tuple[str, object]]] = None,
                          budget_bytes: Optional[int] = None) -> List[Finding]:
    """Requested residency against the budget (default: the trainer's
    ``RESIDENT_CAP_BYTES``), for every config (default: every preset)."""
    if budget_bytes is None:
        budget_bytes = resident_budget()
    findings = []
    for name, cfg in configs if configs is not None else preset_configs():
        if cfg.train.data_placement != "resident":
            continue  # "auto" streams when oversized; "stream" holds nothing
        if cfg.mesh.n_devices > 1 and cfg.train.window_free is False:
            findings.append(finding(
                "resident-memory", "resident", name,
                f"{name}: data_placement='resident' with a {cfg.mesh.n_devices}-device mesh "
                "and window_free=False — the trainer rejects mesh-resident materialized "
                "windows (residency composes only through the window-free gather); drop "
                "window_free=False or stream batches"))
            continue
        est = estimate_resident_bytes(cfg)
        window_free = cfg.train.window_free is not False
        resident = est["series_bytes"] if window_free else est["materialized_bytes"]
        kind = "window-free series" if window_free else "materialized windows"
        if resident > budget_bytes:
            hint = (" (the materialized windows are forced: window_free=False — the "
                    f"window-free series would be {est['series_bytes']:,} bytes)"
                    if not window_free and est["series_bytes"] <= budget_bytes else "")
            findings.append(finding(
                "resident-memory", "resident", name,
                f"{name}: resident data ({kind}) needs {resident:,} bytes but the per-core "
                f"budget is {budget_bytes:,} — the run OOMs at the first epoch{hint}; use "
                "data_placement='auto'/'stream' or shrink the series"))
    return findings
