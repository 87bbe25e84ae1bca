"""Experiment assembly: config -> data, supports, model, trainer.

Counterpart of ``stmgcn_tpu/experiment.py`` (``build_dataset``,
``build_supports``, ``build_model``, ``build_trainer``, ``run``) for
homogeneous cities on one device, with dense, block-sparse
(``model.sparse``) or tiled (``model.tiled``) supports. Heterogeneous
cities, node padding for region meshes and meshes are not ported: configs
asking for them raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from stmgcn_tpu_torch.config import ExperimentConfig
from stmgcn_tpu_torch.data.loader import load_npz
from stmgcn_tpu_torch.data.pipeline import DemandDataset
from stmgcn_tpu_torch.data.splits import date_splits, fraction_splits
from stmgcn_tpu_torch.data.synthetic import synthetic_dataset
from stmgcn_tpu_torch.data.windowing import WindowSpec
from stmgcn_tpu_torch.models.st_mgcn import STMGCN
from stmgcn_tpu_torch.ops.layers import resolve_device
from stmgcn_tpu_torch.ops.spmm import stack_from_dense
from stmgcn_tpu_torch.ops.tiling import plan_tiling
from stmgcn_tpu_torch.train.trainer import Trainer

__all__ = ["build_dataset", "build_model", "build_supports", "build_trainer", "run"]


def build_dataset(cfg: ExperimentConfig) -> DemandDataset:
    """Load or synthesize demand data and window/split it per config."""
    d = cfg.data
    window = WindowSpec(
        d.serial_len, d.daily_len, d.weekly_len, d.day_timesteps, horizon=d.horizon
    )
    if d.hetero or d.city_rows is not None or d.city_timesteps is not None:
        raise ValueError("heterogeneous cities are not ported yet")
    if d.path is not None:
        paths = [p for p in d.path.split(",") if p]
        if len(paths) != d.n_cities:
            raise ValueError(
                f"n_cities={d.n_cities} needs {d.n_cities} comma-separated "
                f"archives in data.path, got {len(paths)}"
            )
        cities = [load_npz(p, m_graphs=cfg.model.m_graphs) for p in paths]
    else:
        cities = [
            synthetic_dataset(
                rows=d.rows, cols=d.cols, n_timesteps=d.n_timesteps,
                m_graphs=cfg.model.m_graphs, day_timesteps=d.day_timesteps,
                seed=d.seed + c,
            )
            for c in range(d.n_cities)
        ]
        if d.shared_graphs:
            for c in cities[1:]:
                c.adjs = cities[0].adjs
    n_samples = window.n_samples(cities[0].demand.shape[0])
    if d.dates is not None:
        split = date_splits(
            list(d.dates), burn_in=window.burn_in, day_timesteps=d.day_timesteps,
            val_ratio=d.val_ratio, year=d.year, n_samples=n_samples,
        )
    else:
        split = fraction_splits(n_samples, train=d.train_frac, validate=d.val_frac)
    return DemandDataset(
        cities if len(cities) > 1 else cities[0], window, split, normalize=d.normalize
    )


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


def build_supports(cfg: ExperimentConfig, dataset: DemandDataset):
    """Supports from the dataset's (shared) graphs, built on the host.

    Dense mode: the ``(M, n_supports, N, N)`` float32 stack (float64 on the
    way). Sparse mode: an M-tuple of
    :class:`~stmgcn_tpu_torch.ops.spmm.BlockSparseStack`, one per branch
    in the original node order. Tiled mode: one
    :class:`~stmgcn_tpu_torch.ops.tiling.TiledSupports` plan at
    ``model.tile_size``, refused when more than ``model.tile_waste_budget``
    of its stored blocks would be all-zero padding.
    """
    _check_support_route(cfg)
    if not dataset.shared_graphs:
        raise ValueError("per-city graph stacks are not ported yet")
    dense = cfg.model.support_config.build_all(dataset.adjs.values())
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


def build_model(cfg: ExperimentConfig, input_dim: int, *, device=None,
                generator: Optional[torch.Generator] = None) -> STMGCN:
    """The flagship from config plus the one data-derived scalar (feature
    count), in the config's support mode (``model.sparse`` /
    ``model.tiled``; the parameters are the same in every mode) and compute
    dtype (``model.dtype``). ``device=None`` means the GPU."""
    m = cfg.model
    _check_support_route(cfg)
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
        dtype=m.compute_dtype,
        device=device,
        generator=generator,
    )


def build_trainer(cfg: ExperimentConfig, *, device=None, initial_state: Optional[dict] = None,
                  verbose: bool = True) -> Trainer:
    """The trainer for a homogeneous, single-device config in any of the
    three support modes; weights drawn from ``cfg.train.seed`` unless
    ``initial_state`` is given. Its checkpoints go to ``cfg.train.out_dir``
    and carry the config and ``derived`` (``{"input_dim", "n_nodes"}``), so
    ``Forecaster.from_checkpoint`` in either package rebuilds the model.
    ``device=None`` means the GPU, and raises without one."""
    _check_support_route(cfg)
    if cfg.mesh.n_devices > 1:
        raise ValueError(
            f"mesh dp={cfg.mesh.dp} region={cfg.mesh.region} branch={cfg.mesh.branch}: "
            "the port trains on one device (multi-device is not ported yet)"
        )
    device = resolve_device(device)
    dataset = build_dataset(cfg)
    supports = build_supports(cfg, dataset)
    model = build_model(cfg, dataset.n_feats, device=device,
                        generator=torch.Generator().manual_seed(cfg.train.seed))
    t = cfg.train
    return Trainer(
        model, dataset, supports, lr=t.lr, weight_decay=t.weight_decay,
        lr_schedule=t.lr_schedule, warmup_epochs=t.warmup_epochs,
        min_lr_fraction=t.min_lr_fraction, grad_clip_norm=t.grad_clip_norm, loss=t.loss,
        n_epochs=t.epochs, batch_size=t.batch_size, patience=t.patience, shuffle=t.shuffle,
        seed=t.seed, steps_per_superstep=t.steps_per_superstep, out_dir=t.out_dir,
        top_k=t.top_k, async_checkpoint=t.async_checkpoint,
        checkpoint_every_steps=t.checkpoint_every_steps,
        precision=t.precision, sr_seed=t.sr_seed,
        extra_meta={
            "config": cfg.to_dict(),
            # what a checkpoint consumer needs to rebuild the model without
            # the dataset (the JAX build_trainer's extra_meta)
            "derived": {"input_dim": dataset.n_feats, "n_nodes": dataset.n_nodes},
        },
        initial_state=initial_state, device=device, verbose=verbose,
    )


def run(cfg: ExperimentConfig, *, device=None, verbose: bool = True) -> dict:
    """Train, then test on ``best.ckpt`` (the reference's ``Main.py:78-88``
    flow): ``{"history": ..., "results": ...}``."""
    trainer = build_trainer(cfg, device=device, verbose=verbose)
    history = trainer.train()
    return {"history": history, "results": trainer.test(modes=("train", "test"))}
