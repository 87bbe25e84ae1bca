"""Typed configuration of the ported slices: data, model, training and
serving.

The port's counterpart of ``stmgcn_tpu/config.py``, holding what the port
reads: :class:`DataConfig`, :class:`ModelConfig`, :class:`TrainConfig`,
:class:`MeshConfig` and :class:`ServingConfig`, grouped in an
:class:`ExperimentConfig` that reads the same JSON dicts as the JAX
package's ``ExperimentConfig.from_dict``, and :class:`HealthConfig`, the
JAX ``health`` section, :class:`ObsConfig`, the JAX ``obs`` section
(tracing), and :class:`ContinualConfig` and :class:`FederationConfig`, the
JAX ``continual`` (the closed loop) and ``federation`` (the replica tier)
sections, copied with their ``violations()``. :class:`ModelConfig` reads the JAX LSTM fields: ``lstm_unroll``
(and ``remat``) are schedules that leave the numbers unchanged and change
nothing here; ``lstm_backend`` picks the bf16 form of the LSTM kernels
(``"xla"``, the default: float32 storage with bf16 products; ``"pallas"``:
bf16 storage), and ``lstm_fused_scan`` the bias rounding of the ``"xla"``
form at bf16 (rounded through bf16 on the layered schedule, the float32
masters on the fused one); at float32 neither changes a number.
:class:`PrecisionPolicy` is the JAX ``precision`` section (the lint's
per-role dtypes), read and checked by its ``violations()`` (the
``precision-policy`` lint rule). :class:`TrainConfig` copies every JAX
training field, the data placement ones (``prefetch``, ``data_placement``,
``window_free``) with the JAX trainer's checks. ``n_nodes`` is derived from
data, never configured.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from stmgcn_tpu_torch.ops.graph import SupportConfig, support_count

__all__ = [
    "ContinualConfig",
    "DTYPES",
    "PRECISIONS",
    "DataConfig",
    "ExperimentConfig",
    "FederationConfig",
    "HealthConfig",
    "LSTM_BACKENDS",
    "ModelConfig",
    "ObsConfig",
    "PRESETS",
    "PRECISION_FLOAT_DTYPES",
    "PRECISION_SITE_ROLES",
    "MeshConfig",
    "PrecisionPolicy",
    "REGION_STRATEGIES",
    "ServingConfig",
    "TrainConfig",
    "preset",
]

#: ``MeshConfig.region_strategy`` values (``stmgcn_tpu/experiment.py:208``)
REGION_STRATEGIES = ("gspmd", "banded", "auto")

#: model compute dtypes by config name (``ModelConfig.dtype``), as the JAX
#: package's ``DTYPES``; "float32" is the exact fp32 path (compute dtype
#: None), "bfloat16" runs bf16 products with fp32 accumulation
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: training step precisions (``TrainConfig.precision``): "bf16" trains f32
#: master parameters through the bf16 compute model (``train/step.py``)
PRECISIONS = ("fp32", "bf16")
#: ``ModelConfig.lstm_backend`` values, as the JAX ``StackedLSTM`` takes them
LSTM_BACKENDS = ("xla", "pallas")
#: ``TrainConfig.checks`` values: None (no sanitizer), then the JAX
#: ``CHECK_SETS`` names (``stmgcn_tpu/train/step.py``)
CHECKS = (None, "nan", "index", "float", "all")
#: the JAX package's bound on per-city drift sketch bins and retained
#: samples (``stmgcn_tpu/config.py`` ``OBS_RESERVOIR_BUDGET``)
OBS_RESERVOIR_BUDGET = 8192
#: the JAX package's bound on the span ring (``OBS_RING_BUDGET``)
OBS_RING_BUDGET = 65536
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
    #: per-city treatment (``HeteroCityDataset``: a normalizer and split per
    #: city) even when the cities share one shape; differing shapes imply it
    hetero: bool = False
    #: synthetic multi-city: each city's grid rows and series length (one
    #: value per city), in place of ``rows`` and ``n_timesteps``
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
    """Architecture of the flagship and its support representation."""

    m_graphs: int = 3
    kernel_type: str = "chebyshev"
    K: int = 2
    bidirectional: bool = True
    lstm_hidden_dim: int = 64
    lstm_num_layers: int = 3
    gcn_hidden_dim: int = 64
    use_bias: bool = True
    shared_gate_fc: bool = True
    #: block-CSR supports: one ``BlockSparseStack`` per branch (kernels B3/B4)
    sparse: bool = False
    #: the large-N path: an offline reorder + condense of all M x K supports
    #: into one ``TiledSupports`` plan (kernels B3/B4); excludes ``sparse``
    #: and a mesh of more than one device
    tiled: bool = False
    #: the plan's block size (the CUDA kernels take 64 or 128)
    tile_size: int = 128
    #: ``build_supports`` raises when more than this fraction of the plan's
    #: stored blocks would be all-zero padding
    tile_waste_budget: float = 0.75
    #: the JAX package's rematerialized LSTM scan, which trades memory for
    #: recompute and leaves results unchanged. Accepted and changes nothing
    #: here: the LSTM kernels already keep only h and c per step and layer
    #: and recompute the gates in the backward
    remat: bool = False
    #: the JAX LSTM scan's unroll factor (0 = the whole sequence): a
    #: schedule that leaves the numbers unchanged, and changes nothing here
    lstm_unroll: int = 1
    #: the JAX single-scan schedule. At bf16 under ``lstm_backend="xla"`` it
    #: picks the bias rounding: the layered schedule (False) rounds every
    #: bias through bf16 and each hoisted input-weight gradient once, the
    #: fused one (True) adds the float32 masters and rounds every step's
    #: input-weight gradient; at float32 it changes nothing
    lstm_fused_scan: bool = False
    #: the bf16 form of the LSTM kernels (:data:`LSTM_BACKENDS`): "xla", the
    #: JAX default, keeps x_proj0, the biases, the states and their
    #: residuals in float32 and rounds each product's operands to bf16;
    #: "pallas" stores them in bf16 as the JAX Pallas kernel does. At
    #: float32 both run the same kernels
    lstm_backend: str = "xla"
    #: compute dtype (:data:`DTYPES`): "bfloat16" serves and trains the
    #: model in bf16 over float32 master parameters
    dtype: str = "float32"

    def __post_init__(self):
        check_lstm(self.lstm_backend, self.lstm_fused_scan, self.lstm_unroll)

    @property
    def n_supports(self) -> int:
        return support_count(self.kernel_type, self.K, self.bidirectional)

    @property
    def support_config(self) -> SupportConfig:
        return SupportConfig(self.kernel_type, self.K, self.bidirectional)

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        """The model's compute dtype: None (the fp32 path) for "float32",
        as the JAX ``build_model`` passes it; raises on an unknown name."""
        if self.dtype not in DTYPES:
            raise ValueError(f"model.dtype must be one of {sorted(DTYPES)}, got {self.dtype!r}")
        return None if self.dtype == "float32" else DTYPES[self.dtype]


@dataclasses.dataclass
class TrainConfig:
    """Optimization recipe; every field of the JAX package's
    ``TrainConfig`` (``stmgcn_tpu/config.py:178-273``), defaults included,
    so a JAX config dict reads as it is.

    The port trains on one device or a ``dp x region x branch`` mesh
    (:class:`MeshConfig`). ``data_placement`` (``"auto"``,
    ``"resident"``, ``"stream"``), ``window_free`` and ``prefetch`` choose
    where batches come from (``train/trainer.py``), checked here with the
    JAX trainer's messages: ``prefetch >= 0``, a known placement, and
    ``window_free=True`` only on resident placement. ``fleet``,
    ``fleet_max_classes`` and ``fleet_max_pad_waste`` choose
    fleet shape-class training of heterogeneous cities; the trainer
    validates them as the JAX one does. The divergence guard's fields
    (``divergence_*``) are validated by the trainer when the guard is on, as
    the JAX trainer validates them. ``precision`` is one of :data:`PRECISIONS`
    and ``sr_seed`` needs ``precision="bf16"``, as the JAX trainer checks.
    """

    epochs: int = 100
    batch_size: int = 32
    lr: float = 2e-3
    weight_decay: float = 1e-4
    #: "none" (constant lr) | "cosine" (linear warmup, then cosine decay to
    #: lr * min_lr_fraction over the run), counted in optimizer steps
    lr_schedule: str = "none"
    warmup_epochs: float = 0.0
    min_lr_fraction: float = 0.0
    #: global-norm gradient clipping before the L2 term and Adam moments
    grad_clip_norm: Optional[float] = None
    loss: str = "mse"
    #: in-program sanitizers (:data:`CHECKS`, the JAX ``CHECK_SETS``):
    #: "nan", "index", "float" (nan plus a zero loss denominator) or "all";
    #: a flagged step raises ``CheckError`` after its block
    #: (``train/step.py``)
    checks: Optional[str] = None
    patience: int = 10
    top_k: int = 1
    shuffle: bool = False
    #: streamed batches placed ahead of the step consuming them
    prefetch: int = 1
    #: "auto" (resident when it fits the card's budget) | "resident" |
    #: "stream" (upload per batch)
    data_placement: str = "auto"
    #: None: the window-free series wherever resident; True requires it;
    #: False keeps materialized windows (the parity oracle)
    window_free: Optional[bool] = None
    #: optimizer steps per block, with one loss readback per block
    steps_per_superstep: int = 1
    #: fleet shape-class training of heterogeneous cities: None engages it
    #: when ``steps_per_superstep > 1``, True requires it, False never
    fleet: Optional[bool] = None
    fleet_max_classes: int = 8
    fleet_max_pad_waste: float = 0.5
    async_checkpoint: bool = True
    checkpoint_every_steps: int = 0
    divergence_guard: bool = False
    divergence_action: str = "skip"
    divergence_patience: int = 3
    divergence_lr_cut: Optional[float] = None
    #: "fp32" | "bf16": the training step's compute precision
    precision: str = "fp32"
    #: stochastic rounding of the master -> bf16 casts (bf16 only)
    sr_seed: Optional[int] = None
    seed: int = 0
    out_dir: str = "output"

    def __post_init__(self):
        check_placement(self.prefetch, self.data_placement, self.window_free,
                        where="train.")
        check_precision(self.precision, self.sr_seed, where="train.")
        if self.checks not in CHECKS:
            raise ValueError(f"train.checks={self.checks!r}: unknown check set; expected "
                             f"one of {CHECKS}")


@dataclasses.dataclass
class MeshConfig:
    """The device mesh (``stmgcn_tpu/config.py:276-312``, the same fields
    and checks): ``dp`` data parallelism (the batch split over ranks, one
    gradient all-reduce a step), ``branch`` graph-branch parallelism (the M
    stacked branches split over ranks, the fusion sum one all-reduce), and
    ``region`` graph-node parallelism (node rows split over ranks) with its
    ``region_strategy`` and ``halo`` budget. ``build_trainer`` trains a
    mesh of ``dp x region x branch`` ranks on ``torch.distributed``
    (:mod:`stmgcn_tpu_torch.parallel`)."""

    dp: int = 1
    region: int = 1
    #: the M stacked branches sharded over this axis (M % branch == 0)
    branch: int = 1
    #: how region-sharded graph convs communicate: "gspmd" (all-gather the
    #: signal's node axis), "banded" (halo exchange) or "auto" (per branch)
    region_strategy: str = "gspmd"
    #: halo budget of banded routing; None: the tightest
    halo: Optional[int] = None

    def __post_init__(self):
        # extent 0 would silently zero n_devices and skip the mesh entirely
        if min(self.dp, self.region, self.branch) < 1:
            raise ValueError(
                f"mesh extents must be >= 1, got dp={self.dp} "
                f"region={self.region} branch={self.branch}"
            )
        if self.region_strategy not in REGION_STRATEGIES:
            raise ValueError(f"mesh.region_strategy must be gspmd|banded|auto, got "
                             f"{self.region_strategy!r}")
        if self.halo is not None and (isinstance(self.halo, bool) or int(self.halo) != self.halo
                                      or self.halo < 0):
            raise ValueError(f"mesh.halo must be None or an int >= 0, got {self.halo!r}")

    @property
    def n_devices(self) -> int:
        return self.dp * self.region * self.branch


@dataclasses.dataclass
class HealthConfig:
    """Numeric health and drift telemetry (``stmgcn_tpu/config.py:521-602``,
    the same fields and defaults): on-device training health stats on a
    cadence (:mod:`stmgcn_tpu_torch.obs.health`), the training-time drift
    baseline in checkpoint meta and the serving engines' drift monitor
    (:mod:`stmgcn_tpu_torch.obs.drift`). ``violations()`` is the JAX
    section's contract; ``build_trainer`` raises on it. As in the JAX
    package, only ``violations()`` reads ``reservoir``."""

    #: compute on-device training health stats (grad norms, update ratio,
    #: nonfinite counts) and stream them to ``health.jsonl``
    enabled: bool = False
    #: compute and download health stats every k-th dispatch (a block of S
    #: steps, or a step); must be >= 1
    every_k: int = 1
    #: per-channel histogram bins of the drift sketches
    sketch_size: int = 64
    #: bounded sample window retained per drift sketch
    reservoir: int = 256
    #: compare live serving traffic against the training-time baseline
    drift: bool = False
    #: capture a training-time moment baseline into checkpoint meta
    baseline: bool = True
    #: health.jsonl destination; None = ``<out_dir>/health.jsonl``
    out: Optional[str] = None

    def violations(self) -> list:
        """Every way this config breaks the documented overhead budget
        (empty list = valid), in the JAX section's words."""
        v = []
        if self.sketch_size < 1:
            v.append(f"sketch_size must be >= 1, got {self.sketch_size} — "
                     "drift histograms need at least one bin")
        elif self.sketch_size > OBS_RESERVOIR_BUDGET:
            v.append(f"sketch_size {self.sketch_size} exceeds the documented budget "
                     f"{OBS_RESERVOIR_BUDGET} — finer drift bins past the budget buy no "
                     "sensitivity, only per-city memory")
        if self.reservoir < 0:
            v.append(f"reservoir must be >= 0, got {self.reservoir} — 0 disables sample "
                     "retention, negatives mean nothing")
        elif self.reservoir > OBS_RESERVOIR_BUDGET:
            v.append(f"reservoir {self.reservoir} exceeds the documented budget "
                     f"{OBS_RESERVOIR_BUDGET} — retained drift samples past the budget "
                     "are unbounded per-city memory")
        if self.drift and not self.baseline:
            v.append("drift gauges are enabled but baseline capture is off — without a "
                     "training-time baseline in checkpoint meta the z-score/PSI gauges "
                     "can never fire")
        if not self.enabled:
            return v
        if self.every_k < 1:
            v.append(f"every_k must be >= 1 when health is enabled, got {self.every_k} — a "
                     "non-positive cadence silently disables the telemetry this config "
                     "claims to provide")
        return v


@dataclasses.dataclass
class ObsConfig:
    """Tracing (:mod:`stmgcn_tpu_torch.obs.trace`), the JAX ``obs`` section
    (``stmgcn_tpu/config.py:463-516``, the same fields and defaults). Off by
    default, and free when off. ``violations()`` is the JAX section's
    overhead contract; ``from_dict`` raises on it."""

    #: record spans into the ring (``--trace-out`` turns it on)
    trace: bool = False
    #: JSONL export destination; None keeps the ring in the process
    trace_path: Optional[str] = None
    #: span ring capacity (oldest spans evicted when full), within
    #: :data:`OBS_RING_BUDGET`
    ring_capacity: int = 4096
    #: bounded sample window of the serving histograms, within
    #: :data:`OBS_RESERVOIR_BUDGET`
    reservoir: int = 1024

    def violations(self) -> list:
        """Every way this config breaks the documented overhead budget
        (empty list = valid), in the JAX section's words."""
        v = []
        if self.reservoir < 1:
            v.append(f"reservoir must be >= 1, got {self.reservoir} — histograms need a "
                     "positive sample bound")
        elif self.reservoir > OBS_RESERVOIR_BUDGET:
            v.append(f"reservoir {self.reservoir} exceeds the documented budget "
                     f"{OBS_RESERVOIR_BUDGET} — percentile windows past the budget buy no "
                     "accuracy, only memory")
        if not self.trace:
            return v
        if self.ring_capacity < 1:
            v.append(f"ring_capacity must be >= 1 when tracing, got {self.ring_capacity} — "
                     "an unbounded span buffer grows without limit in a long-lived process")
        elif self.ring_capacity > OBS_RING_BUDGET:
            v.append(f"ring_capacity {self.ring_capacity} exceeds the documented budget "
                     f"{OBS_RING_BUDGET} — export the trace and rotate instead of growing "
                     "the ring")
        return v


@dataclasses.dataclass
class ContinualConfig:
    """The closed loop (``stmgcn_tpu/config.py:603-765``, the same fields and
    defaults): the ingest ring (:mod:`stmgcn_tpu_torch.data.ring`), the
    fine-tune daemon (:mod:`stmgcn_tpu_torch.train.continual`) and the
    promotion gate (:mod:`stmgcn_tpu_torch.serving.promotion`). Off by
    default. ``violations()`` is the JAX section's contract: a ring over
    the resident budget, a cadence the measured fine-tune cannot sustain,
    missing or unordered gate bands, and a drift trigger with no baseline
    to fire against; ``from_dict`` raises on it."""

    #: run the continual-training daemon (the ring can be used alone)
    enabled: bool = False
    #: ring rows (timesteps) resident on the device per city
    ring_capacity: int = 1024
    #: how many steps behind the head a late row may arrive and still be
    #: placed; older is a typed reject. Must be < ring_capacity
    reorder_window: int = 4
    #: wall-clock retrain cadence in seconds; 0 = drift-triggered only
    cadence_s: float = 0.0
    #: retrain when any city's drift z_max gauge crosses this
    drift_z_max: float = 8.0
    #: retrain when any city's drift PSI gauge crosses this
    drift_psi: float = 0.5
    #: optimizer steps per fine-tune (one captured block)
    finetune_steps: int = 8
    #: microbatch of each fine-tune step
    finetune_batch: int = 8
    #: train on only the freshest K targets; 0 = the whole resident series
    finetune_window: int = 0
    #: consecutive daemon failures tolerated before it stays down
    max_restarts: int = 3
    #: initial retry backoff (doubles per failure, with jitter)
    backoff_s: float = 0.25
    #: backoff ceiling; must be >= backoff_s
    backoff_max_s: float = 4.0
    #: gate: reject a candidate whose fine-tune grad norm exceeded this
    promote_grad_norm_max: float = 1e3
    #: gate: reject a candidate whose update ratio exceeded this
    promote_update_ratio_max: float = 0.5
    #: gate: reject a candidate whose held-out loss exceeds the live
    #: generation's by more than this relative margin
    promote_eval_margin: float = 0.05
    #: measured fine-tune step time (ms) for the duty-cycle check; 0 = not
    #: measured (check skipped)
    superstep_ms: float = 0.0
    #: largest fraction of the cadence the fine-tune may occupy
    max_duty: float = 0.5

    def violations(self, *, row_bytes: Optional[int] = None,
                   budget_bytes: Optional[int] = None, health=None, data=None) -> list:
        """Every way this config breaks the closed-loop contract (empty list
        = valid), in the JAX section's words. Ring bounds always apply; the
        trigger, retry and gate checks once the loop is enabled.
        ``row_bytes``/``budget_bytes`` bring in a resident budget,
        ``health``/``data`` the sibling sections."""
        v = []
        if self.ring_capacity < 1:
            v.append(f"ring_capacity must be >= 1, got {self.ring_capacity} — an empty ring "
                     "can never hold a series")
        elif not 0 <= self.reorder_window < self.ring_capacity:
            v.append(f"reorder_window {self.reorder_window} must be in [0, ring_capacity="
                     f"{self.ring_capacity}) — a late row can only overwrite a slot that is "
                     "still resident")
        if row_bytes is not None and budget_bytes is not None:
            need = self.ring_capacity * row_bytes
            if need > budget_bytes:
                v.append(f"ring_capacity {self.ring_capacity} needs {need} resident bytes "
                         f"({row_bytes} B/row) — over the per-core resident budget "
                         f"{budget_bytes}")
        if data is not None and self.ring_capacity >= 1:
            from stmgcn_tpu_torch.data.windowing import WindowSpec

            spec = WindowSpec(data.serial_len, data.daily_len, data.weekly_len,
                              data.day_timesteps, horizon=data.horizon)
            need = spec.burn_in + spec.horizon
            if self.ring_capacity < need:
                v.append(f"ring_capacity {self.ring_capacity} cannot hold one training "
                         f"window — burn_in+horizon is {need} for this window spec, so the "
                         "fine-tune would never have a valid target")
        if not self.enabled:
            return v
        if self.cadence_s < 0:
            v.append(f"cadence_s must be >= 0, got {self.cadence_s}")
        if self.cadence_s == 0 and health is not None and not (health.drift
                                                               and health.baseline):
            v.append("cadence_s=0 makes drift gauges the only retrain trigger, but "
                     "health.drift/health.baseline are not both on — the daemon would never "
                     "fire")
        if self.drift_z_max <= 0 or self.drift_psi <= 0:
            v.append(f"drift thresholds must be positive, got z_max={self.drift_z_max}, "
                     f"psi={self.drift_psi} — a non-positive threshold retrains on every "
                     "poll")
        if self.finetune_steps < 1 or self.finetune_batch < 1:
            v.append(f"finetune_steps/finetune_batch must be >= 1, got "
                     f"{self.finetune_steps}/{self.finetune_batch}")
        if self.finetune_window < 0:
            v.append(f"finetune_window must be >= 0, got {self.finetune_window}")
        if self.max_restarts < 0:
            v.append(f"max_restarts must be >= 0, got {self.max_restarts}")
        if self.backoff_s <= 0 or self.backoff_max_s < self.backoff_s:
            v.append(f"retry backoff must satisfy 0 < backoff_s <= backoff_max_s, got "
                     f"{self.backoff_s}/{self.backoff_max_s}")
        if self.promote_grad_norm_max <= 0 or self.promote_update_ratio_max <= 0:
            v.append("promotion-gate bands must be positive, got grad_norm_max="
                     f"{self.promote_grad_norm_max}, update_ratio_max="
                     f"{self.promote_update_ratio_max} — a non-positive band rejects every "
                     "candidate")
        if self.promote_eval_margin < 0:
            v.append(f"promote_eval_margin must be >= 0, got {self.promote_eval_margin} — a "
                     "negative margin demands the candidate be strictly better than live to "
                     "even tie")
        if not 0 < self.max_duty <= 1:
            v.append(f"max_duty must be in (0, 1], got {self.max_duty}")
        elif self.cadence_s > 0 and self.superstep_ms > 0:
            duty = (self.finetune_steps * self.superstep_ms / 1e3) / self.cadence_s
            if duty > self.max_duty:
                v.append(f"fine-tune duty cycle {duty:.2f} exceeds max_duty {self.max_duty} "
                         f"— {self.finetune_steps} supersteps x {self.superstep_ms} ms every "
                         f"{self.cadence_s} s starves serving on a shared core")
        return v


@dataclasses.dataclass
class FederationConfig:
    """The replica tier (``stmgcn_tpu/config.py:766-900``, the same fields
    and defaults; :mod:`stmgcn_tpu_torch.serving.federation`). Off by
    default. ``violations()`` is the JAX section's contract: more replicas
    than cities, a hash ring with too few points for its imbalance bound, a
    tier budget below one replica's local bound, and a handover longer
    than a drain; ``from_dict`` raises on it."""

    #: run the federation router
    enabled: bool = False
    #: active engine replicas the ring shards cities across
    replicas: int = 3
    #: warm spares kept built and checkpoint-watching outside the ring
    spares: int = 0
    #: hash-ring points per replica (virtual nodes)
    vnodes: int = 64
    #: bound on the ring's relative per-replica load imbalance
    imbalance_max: float = 0.5
    #: tier-wide pending-row budget shared by every replica's admission
    #: controller; 0 = no global budget (local bounds only)
    global_queue_bound_rows: int = 0
    #: drain: seconds to wait for a replica's in-flight work to flush
    drain_timeout_s: float = 5.0
    #: re-shard: seconds moved cities may wait for their old owner
    handover_timeout_s: float = 2.0

    def violations(self, *, serving=None, n_cities=None) -> list:
        """Every way this config breaks the tier contract (empty list =
        valid), in the JAX section's words. Ring bounds always apply; the
        replica, budget and lifecycle checks once the tier is enabled.
        ``serving`` brings in the :class:`ServingConfig` for the budget
        check, ``n_cities`` the data's city count."""
        v = []
        if self.vnodes < 1:
            v.append(f"vnodes must be >= 1, got {self.vnodes}")
        if not 0.0 < self.imbalance_max <= 1.0:
            v.append(f"imbalance_max must be in (0, 1], got {self.imbalance_max}")
        elif self.vnodes >= 1 and self.replicas >= 1:
            # ring imbalance shrinks ~ 1/sqrt(total points)
            need = int(4.0 / (self.imbalance_max * self.imbalance_max))
            if self.replicas * self.vnodes < need:
                v.append(f"hash ring has {self.replicas * self.vnodes} points "
                         f"({self.replicas} replicas x {self.vnodes} vnodes) — fewer than "
                         f"the {need} needed to bound imbalance at {self.imbalance_max}; add "
                         "vnodes or relax the bound")
        if not self.enabled:
            return v
        if self.replicas < 1:
            v.append(f"replicas must be >= 1, got {self.replicas}")
        if self.spares < 0:
            v.append(f"spares must be >= 0, got {self.spares}")
        if n_cities is not None and self.replicas > n_cities:
            v.append(f"{self.replicas} replicas for {n_cities} cities — city->replica "
                     "sharding leaves at least one replica permanently idle; shrink the tier "
                     "or add cities")
        if self.global_queue_bound_rows < 0:
            v.append(f"global_queue_bound_rows must be >= 0, got "
                     f"{self.global_queue_bound_rows}")
        elif self.global_queue_bound_rows and serving is not None:
            local = int(serving.queue_bound_rows)
            if local and self.global_queue_bound_rows < local:
                v.append(f"global_queue_bound_rows {self.global_queue_bound_rows} is below "
                         f"the per-replica bound {local} — the tier budget would shed before "
                         "any single replica's queue could legally fill")
            top = serving.buckets[-1] if serving.buckets else 0
            if top and self.global_queue_bound_rows < top:
                v.append(f"global_queue_bound_rows {self.global_queue_bound_rows} is below "
                         f"the top ladder rung {top} — no saturated dispatch could ever be "
                         "admitted tier-wide")
        if self.drain_timeout_s <= 0 or self.handover_timeout_s <= 0:
            v.append(f"lifecycle timeouts must be positive, got drain="
                     f"{self.drain_timeout_s}, handover={self.handover_timeout_s}")
        elif self.handover_timeout_s > self.drain_timeout_s:
            v.append(f"handover_timeout_s {self.handover_timeout_s} exceeds drain_timeout_s "
                     f"{self.drain_timeout_s} — a re-shard handover flushes a subset of one "
                     "replica's in-flight work and can never be allowed longer than a full "
                     "drain")
        return v


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


#: float dtype names the precision policy can legislate over
PRECISION_FLOAT_DTYPES = ("float16", "bfloat16", "float32", "float64")

#: the site-role taxonomy of the JAX dtype-flow pass; ``role_dtypes`` keys
#: must come from here
PRECISION_SITE_ROLES = (
    "dot_general",        # matmul operand
    "dot_general_accum",  # matmul accumulator
    "reduce_sum",         # accumulating reduction
    "reduce_order",       # order statistic (max/min): never accumulates
    "scan_carry",         # loop-carried state
    "psum",               # cross-device gradient sync operand
    "normalization",      # variance/norm statistic
    "cast",               # explicit dtype boundary
    "loss",               # the loss output
    "optimizer_update",   # optimizer state outputs
    "master_param",       # parameter inputs/outputs
    "prediction",         # served prediction outputs
)


@dataclasses.dataclass
class PrecisionPolicy:
    """The JAX ``precision`` section (``stmgcn_tpu/config.py:903-1040``),
    the declarative mixed-precision contract, with its ``violations()``:
    the policy half of the ``precision-policy`` lint rule. The defaults:
    bf16 allowed at matmul operands and order statistics, float32 at every
    accumulation site, float32 master parameters, and only the
    float32 <-> bf16 boundary casts whitelisted. (The JAX dtype-flow pass
    that judges traced programs against it has no counterpart here.)"""

    #: role -> allowed compute dtype names at sites of that role
    role_dtypes: dict = dataclasses.field(default_factory=lambda: {
        "dot_general": ("float32", "bfloat16"),
        "dot_general_accum": ("float32",),
        "reduce_sum": ("float32",),
        "reduce_order": ("float32", "bfloat16"),
        "scan_carry": ("float32",),
        "psum": ("float32",),
        "normalization": ("float32",),
        "loss": ("float32",),
        "optimizer_update": ("float32",),
        "prediction": ("float32", "bfloat16"),
    })
    #: roles where a float dtype narrower than float32 is an error
    reduction_f32_roles: tuple = ("reduce_sum", "scan_carry", "psum", "dot_general_accum")
    #: dtype of the trained parameters and optimizer moments between steps
    master_param_dtype: str = "float32"
    #: ``(src, dst)`` float casts a program may contain
    cast_whitelist: tuple = (("float32", "bfloat16"), ("bfloat16", "float32"))

    def __post_init__(self):
        # JSON hands lists back; canonicalize to tuples
        self.role_dtypes = {k: tuple(v) for k, v in dict(self.role_dtypes).items()}
        self.reduction_f32_roles = tuple(self.reduction_f32_roles)
        self.cast_whitelist = tuple(tuple(p) for p in self.cast_whitelist)

    def allowed(self, role: str) -> Optional[tuple]:
        """Allowed dtype names for a role, None when the role is ungated."""
        if role == "master_param":
            return (self.master_param_dtype,)
        return self.role_dtypes.get(role)

    def violations(self) -> list:
        """Every way this policy contradicts itself (empty = valid), with
        the JAX texts."""
        v = []
        itemsize = {"float16": 2, "bfloat16": 2, "float32": 4, "float64": 8}
        if self.master_param_dtype not in PRECISION_FLOAT_DTYPES:
            v.append(f"master_param_dtype {self.master_param_dtype!r} is not a "
                     f"float dtype name {PRECISION_FLOAT_DTYPES}")
        elif itemsize[self.master_param_dtype] < 4:
            v.append(f"master_param_dtype {self.master_param_dtype!r} is "
                     "narrower than float32 — optimizer updates underflow in "
                     "sub-f32 master params; keep masters wide and cast for "
                     "compute instead")
        for role, allowed in self.role_dtypes.items():
            if role not in PRECISION_SITE_ROLES:
                v.append(f"role_dtypes names unknown role {role!r} — the site "
                         f"taxonomy is {PRECISION_SITE_ROLES}")
                continue
            if not allowed:
                v.append(f"role_dtypes[{role!r}] allows no dtype at all")
            for d in allowed:
                if d not in PRECISION_FLOAT_DTYPES:
                    v.append(f"role_dtypes[{role!r}] names unknown float dtype {d!r}")
        if not self.reduction_f32_roles:
            v.append("reduction_f32_roles is empty — with no mandatory-f32 "
                     "accumulation roles a bf16 accumulator certifies clean, "
                     "which defeats the policy's purpose")
        for role in self.reduction_f32_roles:
            if role not in PRECISION_SITE_ROLES:
                v.append(f"reduction_f32_roles names unknown role {role!r}")
                continue
            narrow = [d for d in self.role_dtypes.get(role, ()) if itemsize.get(d, 4) < 4]
            if narrow:
                v.append(f"role {role!r} is in reduction_f32_roles (mandatory "
                         f"f32) but role_dtypes allows {narrow} — the two "
                         "knobs contradict each other")
        for pair in self.cast_whitelist:
            if len(pair) != 2:
                v.append(f"cast_whitelist entry {pair!r} is not a (src, dst) pair")
                continue
            src, dst = pair
            bad = [d for d in (src, dst) if d not in PRECISION_FLOAT_DTYPES]
            if bad:
                v.append(f"cast_whitelist pair {pair!r} names unknown float dtype(s) {bad}")
                continue
            if src == dst:
                v.append(f"cast_whitelist pair {pair!r} casts a dtype to itself "
                         "— not a precision boundary")
            if dst == "float64":
                v.append(f"cast_whitelist pair {pair!r} whitelists a promotion "
                         "to float64, which the fp64-promotion rule bans "
                         "unconditionally (TPUs have no fp64 MXU path)")
        return v


def check_lstm(backend: str, fused_scan: bool, unroll: int) -> None:
    """The JAX ``StackedLSTM``'s checks (``stmgcn_tpu/ops/lstm.py:
    192-202``): a backend of :data:`LSTM_BACKENDS`, and no scan schedule
    knob under ``"pallas"``."""
    if backend not in LSTM_BACKENDS:
        raise ValueError(f"model.lstm_backend must be xla|pallas, got {backend!r}")
    if not isinstance(unroll, int) or unroll < 0:
        raise ValueError(f"model.lstm_unroll must be an int >= 0 (0 unrolls the whole "
                         f"sequence), got {unroll!r}")
    if backend == "pallas" and (fused_scan or unroll != 1):
        raise ValueError(
            "fused_scan/unroll are XLA scan schedule knobs and do not apply to "
            "backend='pallas' (the kernel has one schedule); remat is inherent to the "
            "kernel's recomputing backward")


#: the JAX trainer's text for ``window_free=True`` without resident data
WINDOW_FREE_NEEDS_RESIDENT = ("window_free=True requires resident data placement "
                              "(stream/mesh placements upload per batch)")


def check_placement(prefetch: int, data_placement: str, window_free: Optional[bool] = None,
                    where: str = "") -> None:
    """The JAX trainer's data-placement checks (``trainer.py:252-285,
    450-452``), for ``TrainConfig`` and the ``Trainer`` alike: ``prefetch
    >= 0``, a placement of ``auto|resident|stream``, and no
    ``window_free=True`` over explicitly streamed data (the trainer raises
    :data:`WINDOW_FREE_NEEDS_RESIDENT` too when "auto" streams). Without
    ``where`` the messages are the JAX texts; with it each starts
    ``{where}{field}={value!r}: ``."""
    def refuse(field, value, text):
        raise ValueError(f"{where}{field}={value!r}: {text}" if where else text)

    if prefetch < 0:
        refuse("prefetch", prefetch, "prefetch must be >= 0 (batches placed ahead)")
    if data_placement not in ("auto", "resident", "stream"):
        refuse("data_placement", data_placement,
               f"data_placement must be auto|resident|stream, got {data_placement!r}")
    if window_free and data_placement == "stream":
        refuse("window_free", window_free, WINDOW_FREE_NEEDS_RESIDENT)


def check_precision(precision: str, sr_seed: Optional[int], where: str = "") -> None:
    """The JAX trainer's checks (``trainer.py:231-237``): a precision of
    :data:`PRECISIONS` (fp16 is refused), and ``sr_seed`` only with bf16;
    ``where`` prefixes the field names in the message."""
    if precision not in PRECISIONS:
        raise ValueError(f"{where}precision={precision!r}: precision must be one of "
                         f"{PRECISIONS}")
    if sr_seed is not None and precision != "bf16":
        raise ValueError(f"{where}sr_seed={sr_seed!r}: sr_seed (stochastic rounding) "
                         "requires precision='bf16'")


def _known(cls, d: dict) -> dict:
    """The entries of a JSON section that ``cls`` has fields for."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclasses.dataclass
class ExperimentConfig:
    name: str = "default"
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    serving: ServingConfig = dataclasses.field(default_factory=ServingConfig)
    health: HealthConfig = dataclasses.field(default_factory=HealthConfig)
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)
    continual: ContinualConfig = dataclasses.field(default_factory=ContinualConfig)
    federation: FederationConfig = dataclasses.field(default_factory=FederationConfig)
    precision: PrecisionPolicy = dataclasses.field(default_factory=PrecisionPolicy)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentConfig":
        """Read a JAX-package config dict (``ExperimentConfig.to_dict``);
        raises on an ``obs``, ``continual`` or ``federation`` section that
        breaks its ``violations()`` (the continual one's cross-checks with
        ``health`` and ``data`` once the loop is enabled; the federation
        one's with ``serving`` and the city count)."""
        cfg = cls(
            name=d.get("name", "default"),
            data=DataConfig(**_known(DataConfig, d.get("data", {}))),
            model=ModelConfig(**_known(ModelConfig, d.get("model", {}))),
            train=TrainConfig(**d.get("train", {})),
            mesh=MeshConfig(**_known(MeshConfig, d.get("mesh", {}))),
            serving=ServingConfig(**_known(ServingConfig, d.get("serving", {}))),
            health=HealthConfig(**d.get("health", {})),
            obs=ObsConfig(**d.get("obs", {})),
            continual=ContinualConfig(**d.get("continual", {})),
            federation=FederationConfig(**d.get("federation", {})),
            precision=PrecisionPolicy(**d.get("precision", {})),
        )
        cont = cfg.continual
        for section, bad in (
                ("obs", cfg.obs.violations()),
                ("continual", cont.violations(health=cfg.health, data=cfg.data)
                 if cont.enabled else cont.violations()),
                ("federation", cfg.federation.violations(serving=cfg.serving,
                                                         n_cities=cfg.data.n_cities))):
            if bad:
                raise ValueError(f"{section} section: " + "; ".join(bad))
        return cfg


def _smoke() -> ExperimentConfig:
    """Single neighborhood-graph ChebGCN, 10x10 grid."""
    return ExperimentConfig(
        name="smoke",
        data=DataConfig(rows=10, n_timesteps=24 * 7 * 4),
        model=ModelConfig(m_graphs=1, lstm_hidden_dim=32, lstm_num_layers=1,
                          gcn_hidden_dim=32),
        train=TrainConfig(epochs=5, batch_size=32),
    )


def _default() -> ExperimentConfig:
    """Full ST-MGCN, 3 graphs + CGRNN."""
    return ExperimentConfig(name="default", data=DataConfig(rows=10))


def _multicity() -> ExperimentConfig:
    """BASELINE config 4: a heterogeneous city pair (12x12 over 4 weeks,
    10x10 over 3 weeks; per-city normalizers, splits and support stacks),
    on a data-parallel mesh of eight ranks: each takes an eighth of every
    batch (``build_trainer`` in each rank of a job of eight, e.g. the CLI's
    ``--virtual-devices 8``); ``cfg.mesh = MeshConfig()`` trains it on one
    device."""
    return ExperimentConfig(
        name="multicity",
        data=DataConfig(
            rows=12,
            n_cities=2,
            n_timesteps=24 * 7 * 4,
            city_rows=(12, 10),
            city_timesteps=(24 * 7 * 4, 24 * 7 * 3),
        ),
        train=TrainConfig(batch_size=64),
        mesh=MeshConfig(dp=8),
    )


def _longhorizon() -> ExperimentConfig:
    """BASELINE config 5: 24-step history + 24-step forecast (``remat`` is
    the JAX package's and changes nothing here)."""
    return ExperimentConfig(
        name="longhorizon",
        data=DataConfig(rows=10, serial_len=24, horizon=24, n_timesteps=24 * 7 * 6),
        model=ModelConfig(remat=True),
    )


def _scaled() -> ExperimentConfig:
    """BASELINE config 3 (``stmgcn_tpu/config.py:1101-1117``): a 50x50 grid,
    K=3, bf16, its node axis sharded over a region axis of eight ranks.
    N = 2,500 does not divide 8: the node axis carries 4 zero-padded rows
    (2,504 = 8 x 313; isolated nodes, out of the gate, the loss and the
    metrics). ``region_strategy="auto"`` puts the banded grid branch on the
    halo plan (Chebyshev K=3 bandwidth 150 <= the shard's 313 // 2 = 156)
    and the transport and similarity branches on the dense node-row
    plan."""
    return ExperimentConfig(
        name="scaled",
        data=DataConfig(rows=50, n_timesteps=24 * 7 * 4),
        model=ModelConfig(K=3, dtype="bfloat16"),
        train=TrainConfig(batch_size=16),
        mesh=MeshConfig(region=8, region_strategy="auto"),
    )


def _branchpar() -> ExperimentConfig:
    """Branch model parallelism (``stmgcn_tpu/config.py:1153-1167``): the
    flagship's M=3 stacked branches, their parameters and supports split
    over a ``branch`` axis of three ranks, composed with ``dp=2``: six
    ranks. The fusion sum is one all-reduce over ``branch``."""
    return ExperimentConfig(
        name="branchpar",
        data=DataConfig(rows=10, n_timesteps=24 * 7 * 4),
        train=TrainConfig(batch_size=16),
        mesh=MeshConfig(dp=2, branch=3),
    )


def _bandedbranch() -> ExperimentConfig:
    """The banded x branch composition (``stmgcn_tpu/config.py:1169-1192``)
    on a three-axis ``dp=2 x region=2 x branch=2`` mesh of eight ranks: an
    8x8 grid, M=2. ``region_strategy="auto"`` routes by the measured
    bandwidths: the grid's Chebyshev supports fit the halo budget (16), but
    the synthetic transport branch is a random graph no node order bands,
    so on the synthetic data the composition falls back to the dense
    region plan, as in JAX; on banded city pairs (every branch within the
    budget) each rank holds its branch's strips, branch-stacked at one
    common halo, and each branch group runs its own region ring."""
    return ExperimentConfig(
        name="bandedbranch",
        data=DataConfig(rows=8, n_timesteps=24 * 7 * 4),
        model=ModelConfig(m_graphs=2),
        train=TrainConfig(batch_size=16),
        mesh=MeshConfig(dp=2, region=2, branch=2, region_strategy="auto", halo=16),
    )


PRESETS = {"smoke": _smoke, "default": _default, "scaled": _scaled, "multicity": _multicity,
           "longhorizon": _longhorizon, "branchpar": _branchpar, "bandedbranch": _bandedbranch}


def preset(name: str) -> ExperimentConfig:
    if name not in PRESETS:
        raise ValueError(f"preset must be one of {sorted(PRESETS)}, got {name!r}")
    return PRESETS[name]()
