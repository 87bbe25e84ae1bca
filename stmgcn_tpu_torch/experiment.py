"""Experiment assembly: config -> data, supports, model, trainer.

Counterpart of ``stmgcn_tpu/experiment.py`` (``build_dataset``,
``build_supports``, ``build_model``, ``build_trainer``, ``run``) on one
device, with dense, block-sparse (``model.sparse``) or tiled
(``model.tiled``) supports, for homogeneous cities and for heterogeneous
ones (``HeteroCityDataset``: per-city shapes, normalizers and splits; one
support stack per city in a ``CitySupports``), which the trainer can group
into fleet shape classes (``train.fleet``), over resident or streamed data
(``train.data_placement``, ``window_free``, ``prefetch``), on one device or
on a ``dp x branch`` mesh of ranks (``build_trainer`` in every rank of a
``torch.distributed`` job, :mod:`stmgcn_tpu_torch.parallel`). The region
axis (node padding, banded and sharded-sparse supports) is not ported: a
config asking for it raises by name.
"""

from __future__ import annotations

from typing import Optional

import torch

from stmgcn_tpu_torch.config import ExperimentConfig, check_lstm
from stmgcn_tpu_torch.data.hetero import HeteroCityDataset
from stmgcn_tpu_torch.data.loader import load_npz
from stmgcn_tpu_torch.data.pipeline import DemandDataset
from stmgcn_tpu_torch.data.splits import date_splits, fraction_splits
from stmgcn_tpu_torch.data.synthetic import synthetic_dataset
from stmgcn_tpu_torch.data.windowing import WindowSpec
from stmgcn_tpu_torch.models.st_mgcn import STMGCN
from stmgcn_tpu_torch.ops.layers import resolve_device
from stmgcn_tpu_torch.ops.spmm import stack_from_dense
from stmgcn_tpu_torch.ops.tiling import plan_tiling
from stmgcn_tpu_torch.parallel.mesh import mesh_from_config
from stmgcn_tpu_torch.parallel.placement import REGION_NOT_PORTED, MeshPlacement
from stmgcn_tpu_torch.train.trainer import CitySupports, Trainer

__all__ = ["build_dataset", "build_model", "build_supports", "build_trainer", "run"]


def _split_for(d, window: WindowSpec, n_timesteps: int):
    """One split spec over a series of ``n_timesteps`` per the data config."""
    n_samples = window.n_samples(n_timesteps)
    if d.dates is not None:
        return date_splits(
            list(d.dates), burn_in=window.burn_in, day_timesteps=d.day_timesteps,
            val_ratio=d.val_ratio, year=d.year, n_samples=n_samples,
        )
    return fraction_splits(n_samples, train=d.train_frac, validate=d.val_frac)


def build_dataset(cfg: ExperimentConfig):
    """Load or synthesize demand data and window/split it per config: a
    :class:`DemandDataset` for same-shape cities, or a
    :class:`HeteroCityDataset` when city shapes differ (or ``data.hetero``
    forces per-city treatment), each city then with its own normalizer and
    split calendar."""
    d = cfg.data
    window = WindowSpec(
        d.serial_len, d.daily_len, d.weekly_len, d.day_timesteps, horizon=d.horizon
    )
    for name, per_city in (("city_rows", d.city_rows), ("city_timesteps", d.city_timesteps)):
        if per_city is not None and len(per_city) != d.n_cities:
            raise ValueError(
                f"data.{name} must list one value per city "
                f"(n_cities={d.n_cities}), got {per_city}"
            )
    if d.path is not None:
        paths = [p for p in d.path.split(",") if p]
        if d.n_cities > 1 and len(paths) != d.n_cities:
            raise ValueError(
                f"n_cities={d.n_cities} needs {d.n_cities} comma-separated "
                f"archives in data.path, got {len(paths)}"
            )
        cities = [load_npz(p, m_graphs=cfg.model.m_graphs) for p in paths]
    else:
        cities = [
            synthetic_dataset(
                rows=d.city_rows[c] if d.city_rows is not None else d.rows,
                cols=d.cols,
                n_timesteps=(
                    d.city_timesteps[c] if d.city_timesteps is not None else d.n_timesteps
                ),
                m_graphs=cfg.model.m_graphs, day_timesteps=d.day_timesteps,
                seed=d.seed + c,
            )
            for c in range(d.n_cities)
        ]
        if d.shared_graphs:
            if len({c.demand.shape[1] for c in cities}) > 1:
                raise ValueError(
                    "shared_graphs needs cities with one region count — "
                    "a graph stack cannot be shared across differing N"
                )
            for c in cities[1:]:
                c.adjs = cities[0].adjs
    if len(cities) > 1 and (d.hetero or len({c.demand.shape for c in cities}) > 1):
        splits = [_split_for(d, window, c.demand.shape[0]) for c in cities]
        return HeteroCityDataset(cities, window, splits, normalize=d.normalize)
    split = _split_for(d, window, cities[0].demand.shape[0])
    return DemandDataset(
        cities if len(cities) > 1 else cities[0], window, split, normalize=d.normalize
    )


def _check_health(cfg: ExperimentConfig) -> None:
    """The ``health`` section's contract (``HealthConfig.violations()``),
    and drift gauges asked for on a run that writes no baseline: the
    trainer puts ``health_baseline`` into checkpoint meta only with
    ``health.enabled``, so no engine could ever attach the monitor."""
    bad = cfg.health.violations()
    if cfg.health.drift and not cfg.health.enabled:
        bad.append("drift gauges are enabled but training health is off — the "
                   "training-time baseline is written only with health.enabled")
    if bad:
        raise ValueError("health: " + "; ".join(bad))


def _check_support_route(cfg: ExperimentConfig) -> None:
    """The JAX package's refusals of the tiled route."""
    if cfg.model.tiled and cfg.model.sparse:
        raise ValueError(
            "model.tiled and model.sparse are mutually exclusive — each is "
            "a complete support representation; pick one"
        )
    if cfg.model.tiled and cfg.mesh.n_devices > 1:
        raise ValueError(
            "model.tiled does not compose with a >1-device mesh — the "
            "reordered tile plan owns the whole node axis; use dense "
            "GSPMD or sharded sparse supports for multi-device configs"
        )


def build_supports(cfg: ExperimentConfig, dataset):
    """Supports from the dataset's graphs, built on the host.

    Dense mode: the ``(M, n_supports, N, N)`` float32 stack. Sparse mode: an
    M-tuple of :class:`~stmgcn_tpu_torch.ops.spmm.BlockSparseStack`, one per
    branch in the original node order. Tiled mode: one
    :class:`~stmgcn_tpu_torch.ops.tiling.TiledSupports` plan at
    ``model.tile_size``, refused when more than ``model.tile_waste_budget``
    of its stored blocks would be all-zero padding. When the cities carry
    differing graphs, a :class:`CitySupports` of one such form per city.
    """
    _check_support_route(cfg)

    def one(adjs):
        # N from the city's own adjacencies (heterogeneous cities differ)
        dense = cfg.model.support_config.build_all(adjs.values())
        if cfg.model.tiled:
            plan = plan_tiling(dense, tile=cfg.model.tile_size)
            stats = plan.tile_stats()
            stored = plan.m_graphs * plan.n_supports * plan.block_rows * plan.block_cols
            waste = 1.0 - stats["blocks_kept"] / max(stored, 1)
            if waste > cfg.model.tile_waste_budget:
                raise ValueError(
                    f"tiled condensation wastes {waste:.3f} of stored blocks "
                    f"on all-zero padding (> model.tile_waste_budget="
                    f"{cfg.model.tile_waste_budget}) — the graph's nonzeros "
                    "do not cluster under the reorder; use dense/sparse "
                    "supports, a smaller model.tile_size, or raise the budget"
                )
            return plan
        if cfg.model.sparse:
            return tuple(stack_from_dense(dense[m]) for m in range(dense.shape[0]))
        return dense

    if not dataset.shared_graphs:
        return CitySupports(one(adjs) for adjs in dataset.city_adjs)
    return one(dataset.adjs)


def build_model(cfg: ExperimentConfig, input_dim: int, *, device=None,
                generator: Optional[torch.Generator] = None, placement=None) -> STMGCN:
    """The flagship from config plus the one data-derived scalar (feature
    count), in the config's support mode (``model.sparse`` /
    ``model.tiled``; the parameters are the same in every mode), compute
    dtype (``model.dtype``) and bf16 LSTM form (``model.lstm_backend``,
    ``model.lstm_fused_scan``). ``device=None`` means the GPU. ``placement``
    (this rank's ``MeshPlacement``) rides on the model for the trainer; with
    ``branch > 1`` the model keeps the rank's branch slice and fuses over
    the mesh."""
    m = cfg.model
    _check_support_route(cfg)
    check_lstm(m.lstm_backend, m.lstm_fused_scan, m.lstm_unroll)
    return STMGCN(
        m_graphs=m.m_graphs,
        n_supports=m.n_supports,
        seq_len=cfg.data.seq_len,
        input_dim=input_dim,
        horizon=cfg.data.horizon,
        lstm_hidden_dim=m.lstm_hidden_dim,
        lstm_num_layers=m.lstm_num_layers,
        gcn_hidden_dim=m.gcn_hidden_dim,
        use_bias=m.use_bias,
        shared_gate_fc=m.shared_gate_fc,
        sparse=m.sparse,
        support_modes=("tiled",) * m.m_graphs if m.tiled else None,
        lstm_backend=m.lstm_backend,
        lstm_fused_scan=m.lstm_fused_scan,
        dtype=m.compute_dtype,
        device=device,
        generator=generator,
        placement=placement,
    )


def _check_mesh_route(cfg: ExperimentConfig) -> None:
    """What a mesh refuses before any rank is needed: the region axis, and
    the JAX package's refusals (``stmgcn_tpu/experiment.py:466-475``)."""
    if cfg.mesh.n_devices <= 1:
        return
    if cfg.mesh.region > 1:
        raise ValueError(f"mesh.region={cfg.mesh.region} (region_strategy="
                         f"{cfg.mesh.region_strategy!r}, halo={cfg.mesh.halo}): "
                         + REGION_NOT_PORTED)
    if cfg.model.lstm_backend == "pallas" and cfg.mesh.branch > 1:
        raise ValueError(
            "lstm_backend='pallas' does not compose with mesh.branch > 1 "
            "— use the xla backend for branch-parallel meshes")
    if cfg.model.sparse:
        raise ValueError("model.sparse on a mesh (sharded block-CSR strips) is not ported "
                         "yet (ROADMAP A11b); use dense supports on a mesh")


def build_trainer(cfg: ExperimentConfig, *, device=None, initial_state: Optional[dict] = None,
                  graphs: Optional[bool] = None, verbose: bool = True,
                  fault_plan=None, debug_nans: bool = False) -> Trainer:
    """The trainer for a single-device config in any of the three support
    modes, homogeneous or heterogeneous (with ``train.fleet`` and its
    knobs); weights drawn from ``cfg.train.seed`` unless ``initial_state``
    is given. Its checkpoints go to ``cfg.train.out_dir`` and carry the
    config and ``derived`` (``{"input_dim", "n_nodes"}``, ``n_nodes`` a
    per-city list for heterogeneous cities), so ``Forecaster.from_checkpoint``
    in either package rebuilds the model. ``device=None`` means the GPU,
    and raises without one; ``graphs`` as :class:`Trainer`'s. The divergence
    guard and the ``health`` section reach the trainer as the JAX
    ``build_trainer`` passes them (``stmgcn_tpu/experiment.py:411-422``,
    ``:518-527``); ``fault_plan`` (a
    :class:`~stmgcn_tpu_torch.resilience.FaultPlan`) threads deterministic
    faults through its loop, ``None`` being the no-op plan. A ``health``
    section that breaks its contract raises. ``train.checks`` reaches the
    trainer's sanitizers; ``debug_nans`` turns on its debug mode (the
    CLI's ``--debug-nans``).

    **A mesh** (``cfg.mesh`` of more than one device): every rank of a
    joined ``torch.distributed`` job of ``dp x branch`` ranks calls this
    with the same config; it builds the rank's mesh and placement
    (``mesh_from_config``: raises unless the job has exactly that many
    ranks), checks divisibility as the JAX ``build_trainer`` does, and
    builds the rank's slice of the model from the same seed. ``region >
    1``, block-CSR supports, and ``lstm_backend="pallas"`` with ``branch >
    1`` raise by name; so do the trainer's options that do not compose with
    a mesh yet. ``initial_state`` is the whole, mesh-free ``state_dict``."""
    _check_health(cfg)
    _check_support_route(cfg)
    _check_mesh_route(cfg)
    device = resolve_device(device)
    mesh = mesh_from_config(cfg.mesh, device=device)
    placement = MeshPlacement(mesh) if mesh is not None else None
    dataset = build_dataset(cfg)
    hetero = getattr(dataset, "heterogeneous", False)
    if placement is not None:
        for n_nodes in (dataset.city_n_nodes if hetero else [dataset.n_nodes]):
            placement.check_divisibility(cfg.train.batch_size, n_nodes,
                                         m_graphs=cfg.model.m_graphs)
    supports = build_supports(cfg, dataset)
    model = build_model(cfg, dataset.n_feats, device=device,
                        generator=torch.Generator().manual_seed(cfg.train.seed),
                        placement=placement)
    t = cfg.train
    return Trainer(
        model, dataset, supports, lr=t.lr, weight_decay=t.weight_decay,
        lr_schedule=t.lr_schedule, warmup_epochs=t.warmup_epochs,
        min_lr_fraction=t.min_lr_fraction, grad_clip_norm=t.grad_clip_norm, loss=t.loss,
        n_epochs=t.epochs, batch_size=t.batch_size, patience=t.patience, shuffle=t.shuffle,
        seed=t.seed, steps_per_superstep=t.steps_per_superstep, prefetch=t.prefetch,
        data_placement=t.data_placement, window_free=t.window_free, fleet=t.fleet,
        fleet_max_classes=t.fleet_max_classes, fleet_max_pad_waste=t.fleet_max_pad_waste,
        out_dir=t.out_dir,
        top_k=t.top_k, async_checkpoint=t.async_checkpoint,
        checkpoint_every_steps=t.checkpoint_every_steps,
        precision=t.precision, sr_seed=t.sr_seed,
        divergence_guard=t.divergence_guard, divergence_action=t.divergence_action,
        divergence_patience=t.divergence_patience, divergence_lr_cut=t.divergence_lr_cut,
        fault_plan=fault_plan, health=cfg.health.enabled,
        health_every_k=cfg.health.every_k, health_out=cfg.health.out,
        health_baseline=cfg.health.baseline, health_sketch_size=cfg.health.sketch_size,
        checks=t.checks, debug_nans=debug_nans,
        extra_meta={
            "config": cfg.to_dict(),
            # what a checkpoint consumer needs to rebuild the model without
            # the dataset (the JAX build_trainer's extra_meta)
            "derived": {
                "input_dim": dataset.n_feats,
                "n_nodes": dataset.city_n_nodes if hetero else dataset.n_nodes,
            },
        },
        initial_state=initial_state, device=device, graphs=graphs,
        verbose=verbose and (mesh is None or mesh.is_lead),
    )


def run(cfg: ExperimentConfig, *, device=None, verbose: bool = True) -> dict:
    """Train, then test on ``best.ckpt`` (the reference's ``Main.py:78-88``
    flow): ``{"history": ..., "results": ...}``."""
    trainer = build_trainer(cfg, device=device, verbose=verbose)
    history = trainer.train()
    return {"history": history, "results": trainer.test(modes=("train", "test"))}
