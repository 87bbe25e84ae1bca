"""Typed configuration for the serving slice: data, model and serving.

The port's counterpart of ``stmgcn_tpu/config.py``, holding only what the
slice reads: :class:`DataConfig`, :class:`ModelConfig` and
:class:`ServingConfig`, grouped in an :class:`ExperimentConfig` that reads
the same JSON dicts as the JAX package's ``ExperimentConfig.from_dict``.
Sections the slice does not use (train, mesh, obs, ...) and fields of the
JAX model config that choose XLA schedules or other support
representations are ignored on read. ``n_nodes`` is derived from data,
never configured.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from stmgcn_tpu_torch.ops.graph import SupportConfig, support_count

__all__ = [
    "DTYPES",
    "DataConfig",
    "ExperimentConfig",
    "ModelConfig",
    "PRESETS",
    "ServingConfig",
    "preset",
]

#: storage dtypes by config name; the kernels of this slice take float32 only
DTYPES = ("float32",)


@dataclasses.dataclass
class DataConfig:
    """Data source + windowing. ``path=None`` generates synthetic data."""

    path: Optional[str] = None
    rows: int = 10
    cols: Optional[int] = None
    n_timesteps: int = 24 * 7 * 8
    n_cities: int = 1  # >1: samples from several same-shape cities, concatenated
    #: synthetic multi-city: give every city the first city's graph stack
    shared_graphs: bool = False
    hetero: bool = False
    city_rows: Optional[tuple] = None
    city_timesteps: Optional[tuple] = None
    dt: int = 1  # hours per timestep
    serial_len: int = 3
    daily_len: int = 1
    weekly_len: int = 1
    horizon: int = 1  # forecast steps per sample
    #: "minmax" | "std" | "none"
    normalize: str = "minmax"
    dates: Optional[tuple] = None  # (train_s, train_e, test_s, test_e) MMDD
    val_ratio: float = 0.2
    year: int = 2017
    train_frac: float = 0.7  # used when dates is None
    val_frac: float = 0.1
    seed: int = 0

    @property
    def day_timesteps(self) -> int:
        return 24 // self.dt

    @property
    def seq_len(self) -> int:
        return self.serial_len + self.daily_len + self.weekly_len


@dataclasses.dataclass
class ModelConfig:
    """Architecture of the dense flagship."""

    m_graphs: int = 3
    kernel_type: str = "chebyshev"
    K: int = 2
    bidirectional: bool = True
    lstm_hidden_dim: int = 64
    lstm_num_layers: int = 3
    gcn_hidden_dim: int = 64
    use_bias: bool = True
    shared_gate_fc: bool = True
    dtype: str = "float32"

    @property
    def n_supports(self) -> int:
        return support_count(self.kernel_type, self.K, self.bidirectional)

    @property
    def support_config(self) -> SupportConfig:
        return SupportConfig(self.kernel_type, self.K, self.bidirectional)


@dataclasses.dataclass
class ServingConfig:
    """Engine shape policy (:mod:`stmgcn_tpu_torch.serving.engine`).

    The engine keeps one callable per ``buckets`` rung and the
    micro-batcher coalesces concurrent requests into the smallest
    covering rung, waiting at most ``max_delay_ms`` for co-riders.
    ``violations()`` is the ladder's static contract.
    """

    #: ascending batch-size ladder. Keep 1 in the ladder so lone
    #: interactive requests never wait or pad.
    buckets: tuple = (1, 4, 16, 64)
    #: micro-batcher coalescing deadline (ms a request may wait for
    #: co-riders when the pending rows don't exactly fill a rung)
    max_delay_ms: float = 2.0
    #: largest coalesced batch the ladder must cover (its top rung)
    max_batch: int = 64
    #: per-rung worst-case padded-waste bound: a batch one row past rung
    #: ``p`` pads to the next rung ``b`` wasting ``(b - p - 1) / b``
    max_pad_waste: float = 0.75
    #: per-request SLO deadline (ms from submit to response); None
    #: disables admission control. Must exceed ``max_delay_ms``.
    deadline_ms: Optional[float] = None
    #: bounded-queue admission limit (pending ROWS); 0 = no bound. Must
    #: cover the top rung.
    queue_bound_rows: int = 0
    #: "reject" raises the typed Overloaded/DeadlineExceeded; "degrade"
    #: serves the shed request inline at ``degrade_rung``
    shed_policy: str = "reject"
    #: ladder rung used by the "degrade" policy; None = the smallest rung
    degrade_rung: Optional[int] = None

    def __post_init__(self):
        # json round-trips hand lists back
        self.buckets = tuple(int(b) for b in self.buckets)

    def violations(self) -> list:
        """Every way this config is unservable (empty list = valid)."""
        return self.ladder_violations() + self.slo_violations()

    def ladder_violations(self) -> list:
        v = []
        b = self.buckets
        if not b:
            return ["bucket ladder is empty"]
        if any(x < 1 for x in b):
            v.append(f"buckets must be >= 1, got {b}")
        if any(y <= x for x, y in zip(b, b[1:])):
            v.append(f"bucket ladder must be strictly increasing, got {b}")
        if self.max_batch < 1:
            v.append(f"max_batch must be >= 1, got {self.max_batch}")
        elif b[-1] < self.max_batch:
            v.append(
                f"ladder tops out at {b[-1]} but max_batch is "
                f"{self.max_batch} — batches above the top rung have no "
                "program"
            )
        if not 0.0 <= self.max_pad_waste < 1.0:
            v.append(
                f"max_pad_waste must be in [0, 1), got {self.max_pad_waste}"
            )
        else:
            prev = 0
            for cur in b:
                if cur <= prev:
                    continue  # ordering already flagged above
                waste = (cur - (prev + 1)) / cur
                if waste > self.max_pad_waste:
                    v.append(
                        f"bucket {cur}: worst-case pad waste {waste:.3f} "
                        f"(one row past rung {prev} pads {cur - prev - 1} of "
                        f"{cur} rows) exceeds max_pad_waste "
                        f"{self.max_pad_waste} — add an intermediate rung"
                    )
                prev = cur
        if self.max_delay_ms < 0:
            v.append(f"max_delay_ms must be >= 0, got {self.max_delay_ms}")
        return v

    def slo_violations(self) -> list:
        v = []
        b = self.buckets
        if self.deadline_ms is not None and self.deadline_ms <= self.max_delay_ms:
            v.append(
                f"deadline_ms {self.deadline_ms} must exceed max_delay_ms "
                f"{self.max_delay_ms} — a request may legitimately wait the "
                "full coalescing delay, so a tighter deadline sheds every "
                "coalesced request by construction"
            )
        if self.queue_bound_rows < 0:
            v.append(
                f"queue_bound_rows must be >= 0, got {self.queue_bound_rows}"
            )
        elif self.queue_bound_rows and b and self.queue_bound_rows < b[-1]:
            v.append(
                f"queue_bound_rows {self.queue_bound_rows} is below the top "
                f"rung {b[-1]} — a saturated dispatch could never fill"
            )
        if self.shed_policy not in ("reject", "degrade"):
            v.append(
                f"shed_policy must be 'reject' or 'degrade', got "
                f"{self.shed_policy!r}"
            )
        if self.degrade_rung is not None:
            if self.shed_policy != "degrade":
                v.append(
                    f"degrade_rung {self.degrade_rung} is set but shed_policy "
                    f"is {self.shed_policy!r} — the rung would never be used"
                )
            if self.degrade_rung not in b:
                v.append(
                    f"degrade_rung {self.degrade_rung} is not a ladder rung "
                    f"{b} — no program exists for it"
                )
        return v


def _known(cls, d: dict) -> dict:
    """The entries of a JSON section that ``cls`` has fields for."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclasses.dataclass
class ExperimentConfig:
    name: str = "default"
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    serving: ServingConfig = dataclasses.field(default_factory=ServingConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentConfig":
        """Read a JAX-package config dict (``ExperimentConfig.to_dict``)."""
        return cls(
            name=d.get("name", "default"),
            data=DataConfig(**_known(DataConfig, d.get("data", {}))),
            model=ModelConfig(**_known(ModelConfig, d.get("model", {}))),
            serving=ServingConfig(**_known(ServingConfig, d.get("serving", {}))),
        )


def _smoke() -> ExperimentConfig:
    """Single neighborhood-graph ChebGCN, 10x10 grid."""
    return ExperimentConfig(
        name="smoke",
        data=DataConfig(rows=10, n_timesteps=24 * 7 * 4),
        model=ModelConfig(m_graphs=1, lstm_hidden_dim=32, lstm_num_layers=1,
                          gcn_hidden_dim=32),
    )


def _default() -> ExperimentConfig:
    """Full ST-MGCN, 3 graphs + CGRNN."""
    return ExperimentConfig(name="default", data=DataConfig(rows=10))


PRESETS = {"smoke": _smoke, "default": _default}


def preset(name: str) -> ExperimentConfig:
    if name not in PRESETS:
        raise ValueError(f"preset must be one of {sorted(PRESETS)}, got {name!r}")
    return PRESETS[name]()
