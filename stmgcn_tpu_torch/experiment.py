"""Experiment assembly: config -> data, supports, model, trainer.

Counterpart of ``stmgcn_tpu/experiment.py`` (``build_dataset``,
``build_supports``, ``build_model``, ``build_trainer``, ``run``) on one
device, with dense, block-sparse (``model.sparse``) or tiled
(``model.tiled``) supports, for homogeneous cities and for heterogeneous
ones (``HeteroCityDataset``: per-city shapes, normalizers and splits; one
support stack per city in a ``CitySupports``), which the trainer can group
into fleet shape classes (``train.fleet``), over resident or streamed data
(``train.data_placement``, ``window_free``, ``prefetch``), on one device or
on a ``dp x region x branch`` mesh of ranks (``build_trainer`` in every
rank of a ``torch.distributed`` job, :mod:`stmgcn_tpu_torch.parallel`).
On a region mesh that does not divide ``N`` the node axis is zero-padded
(:func:`node_pad_target`); an active ``mesh.region_strategy`` routes each
branch's supports to the halo plan or the dense node-row plan, block-CSR
supports on a mesh become row strips (:func:`route_supports`), and on a
``region x branch`` mesh every branch's strips stack into one operand the
branch axis cuts.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
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
from stmgcn_tpu_torch.parallel.banded import banded_decompose, bandwidth, branch_stack
from stmgcn_tpu_torch.parallel.mesh import mesh_from_config
from stmgcn_tpu_torch.parallel.placement import MeshPlacement
from stmgcn_tpu_torch.parallel.sparse import branch_stack_sparse, sharded_from_dense
from stmgcn_tpu_torch.train.trainer import CitySupports, Trainer

__all__ = ["build_dataset", "build_model", "build_supports", "build_trainer", "node_pad_target",
           "route_supports", "run"]


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


def node_pad_target(cfg: ExperimentConfig, n_nodes: int):
    """The padded node count of a region mesh that does not divide
    ``n_nodes`` (None when no padding is needed;
    ``stmgcn_tpu/experiment.py:114-128``).

    Supports are built at the true ``N`` and then zero-padded: padding the
    adjacency instead would change the Laplacian's spectrum (the ``2L/λmax
    - I`` rescale) and the model at real nodes. Padded rows are isolated:
    zero support rows and columns, zero inputs, left out of the gate's
    pooling (``STMGCN(n_real_nodes=)``) and out of the loss and the metrics
    by the ``(B, N)`` mask."""
    region = cfg.mesh.region
    if cfg.mesh.n_devices > 1 and region > 1 and n_nodes % region:
        return -(-n_nodes // region) * region
    return None


def _pad_support_nodes(dense, n_pad: int):
    """Zero-pad the trailing two (node) axes of a dense support stack."""
    dense = np.asarray(dense)
    extra = n_pad - dense.shape[-1]
    if extra <= 0:
        return dense
    widths = [(0, 0)] * (dense.ndim - 2) + [(0, extra), (0, extra)]
    return np.pad(dense, widths)


def _dense_supports(cfg: ExperimentConfig, adjs):
    """One city's dense support stack at its true ``N`` (from the
    adjacencies themselves), node-padded iff the mesh needs it: the one
    padding site every support representation derives from."""
    n_nodes = next(iter(adjs.values())).shape[0]
    dense = cfg.model.support_config.build_all(adjs.values())
    n_pad = node_pad_target(cfg, n_nodes)
    return _pad_support_nodes(dense, n_pad) if n_pad is not None else dense


def build_supports(cfg: ExperimentConfig, dataset):
    """Supports from the dataset's graphs, built on the host.

    Dense mode: the ``(M, n_supports, N, N)`` float32 stack. Sparse mode: an
    M-tuple of :class:`~stmgcn_tpu_torch.ops.spmm.BlockSparseStack`, one per
    branch in the original node order. Tiled mode: one
    :class:`~stmgcn_tpu_torch.ops.tiling.TiledSupports` plan at
    ``model.tile_size``, refused when more than ``model.tile_waste_budget``
    of its stored blocks would be all-zero padding. When the cities carry
    differing graphs, a :class:`CitySupports` of one such form per city. On
    a region mesh that does not divide ``N`` the node axes carry zero
    padding (:func:`node_pad_target`).
    """
    _check_support_route(cfg)

    def one(adjs):
        dense = _dense_supports(cfg, adjs)
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


def _strategy_active(cfg: ExperimentConfig) -> bool:
    """Whether the mesh's region strategy replaces the dense node-row plan
    (``stmgcn_tpu/experiment.py:206-216``)."""
    s = cfg.mesh.region_strategy
    if s not in ("gspmd", "banded", "auto"):
        raise ValueError(f"mesh.region_strategy must be gspmd|banded|auto, got {s!r}")
    return s != "gspmd" and cfg.mesh.region > 1 and not cfg.model.sparse


def route_supports(cfg: ExperimentConfig, dataset, supports=None):
    """Route each branch's supports per the mesh's region strategy
    (``stmgcn_tpu/experiment.py:219-341``). Returns ``(supports, modes)``:
    ``modes`` None when the dense node-row plan handles every branch
    (``region_strategy="gspmd"``, no region axis, or one device), else one
    mode per branch:

    - block-CSR supports on a mesh: ``("sparse",) * M``, each branch's
      row strips over ``region``
      (:class:`~stmgcn_tpu_torch.parallel.sparse.ShardedBlockSparse`, an
      M-tuple), or at ``branch > 1`` one branch-stacked form
      (:func:`~stmgcn_tpu_torch.parallel.sparse.branch_stack_sparse`);
    - an active strategy: a branch whose supports are banded enough (the
      largest bandwidth of its K supports within the halo budget,
      ``mesh.halo`` or ``n_local // 2``, at most ``n_local``) goes to the
      halo plan as :class:`~stmgcn_tpu_torch.parallel.banded.BandedSupports`
      strips at its own bandwidth, the rest stay dense (an M-tuple with a
      banded branch; the dense stack when every branch stays dense);
      ``region_strategy="banded"`` demands every branch qualify;
    - an active strategy at ``branch > 1``: every branch banded gives one
      branch-stacked ``BandedSupports`` at their common halo
      (:func:`~stmgcn_tpu_torch.parallel.banded.branch_stack`) and
      ``("banded",) * M``; a branch over the budget sends ``"auto"`` back
      to the all-dense plan (``modes`` None) and makes ``"banded"``
      raise.

    ``supports``: the dense (node-padded) stack :func:`build_supports`
    gives the config's data, when the caller has built it (the block-CSR
    strips are cut from it too)."""
    active = _strategy_active(cfg)
    if cfg.model.tiled:
        supports = build_supports(cfg, dataset) if supports is None else supports
        return supports, ("tiled",) * cfg.model.m_graphs
    if not dataset.shared_graphs and (
            (cfg.model.sparse and cfg.mesh.n_devices > 1) or active):
        raise ValueError(
            "per-city graphs currently compose with dense GSPMD or single-device sparse "
            "supports only — set data.shared_graphs=True, region_strategy='gspmd', or dense "
            "mode for multi-city mesh configs")
    if cfg.model.sparse and cfg.mesh.n_devices > 1:
        dense = _dense_supports(cfg, dataset.adjs) if supports is None else np.asarray(supports)
        modes = ("sparse",) * dense.shape[0]
        if cfg.mesh.branch > 1:  # one operand the branch axis cuts
            return branch_stack_sparse(dense, cfg.mesh.region), modes
        return tuple(sharded_from_dense(dense[m], cfg.mesh.region)
                     for m in range(dense.shape[0])), modes
    supports = build_supports(cfg, dataset) if supports is None else supports
    if not active:
        return supports, None
    region = cfg.mesh.region
    n = supports.shape[-1]  # node-padded when the mesh required it
    if n % region:
        raise ValueError(f"n_nodes {n} not divisible by region={region}")
    n_local = n // region
    budget = min(cfg.mesh.halo if cfg.mesh.halo is not None else n_local // 2, n_local)
    bws = [max(bandwidth(supports[m, k]) for k in range(supports.shape[1]))
           for m in range(supports.shape[0])]
    if cfg.mesh.branch > 1:
        over = [m for m, bw in enumerate(bws) if bw > budget]
        if over and cfg.mesh.region_strategy == "banded":
            raise ValueError(
                "mesh.branch > 1 with region_strategy='banded' needs every "
                f"branch banded, but branches {over} have support bandwidth "
                f"> halo budget {budget} (shard size {n_local}) — use "
                "'auto' (falls back to GSPMD), raise mesh.halo, or reorder "
                "nodes to reduce bandwidth")
        if over:  # "auto": the whole dense branch-parallel plan
            return supports, None
        stacked = branch_stack([np.asarray(supports[m]) for m in range(supports.shape[0])],
                               region, halo=max(bws))
        return stacked, ("banded",) * supports.shape[0]
    routed, modes = [], []
    for m in range(supports.shape[0]):
        bw = bws[m]
        if bw <= budget:
            routed.append(banded_decompose(np.asarray(supports[m]), region, halo=bw))
            modes.append("banded")
        elif cfg.mesh.region_strategy == "banded":
            raise ValueError(
                f"region_strategy='banded' but branch {m}'s supports have bandwidth {bw} > "
                f"halo budget {budget} (shard size {n_local}) — use 'auto' to keep "
                "non-banded branches on GSPMD, raise mesh.halo, or reorder nodes to reduce "
                "bandwidth")
        else:
            routed.append(supports[m])
            modes.append("dense")
    if "banded" not in modes:
        return supports, tuple(modes)
    return tuple(routed), tuple(modes)


def build_model(cfg: ExperimentConfig, input_dim: int, *, device=None,
                generator: Optional[torch.Generator] = None, placement=None,
                support_modes=None, n_real_nodes: Optional[int] = None) -> STMGCN:
    """The flagship from config plus the one data-derived scalar (feature
    count), in the config's support mode (``model.sparse`` /
    ``model.tiled``, or ``support_modes`` from :func:`route_supports`; the
    parameters are the same in every mode), compute dtype
    (``model.dtype``) and bf16 LSTM form (``model.lstm_backend``,
    ``model.lstm_fused_scan``). ``device=None`` means the GPU. ``placement``
    (this rank's ``MeshPlacement``) rides on the model for the trainer; with
    ``branch > 1`` the model keeps the rank's branch slice and fuses over
    the mesh, with ``region > 1`` its convs and gate take the rank's node
    rows. ``n_real_nodes``: the real node count of a node-padded model.
    Checkpoints take the JAX package's branch layout, a function of the
    config alone (``stmgcn_tpu/experiment.py`` ``build_model``): under an
    active region strategy at ``branch == 1`` the loop layout whatever each
    branch routed to; at ``branch > 1`` the stacked (vmapped) one, whose
    branch axis the mesh cuts (a block-CSR config there rebuilds without a
    mesh as a dense model, as JAX's does); otherwise by the support mode.
    """
    m = cfg.model
    _check_support_route(cfg)
    check_lstm(m.lstm_backend, m.lstm_fused_scan, m.lstm_unroll)
    if m.tiled and support_modes is None:
        support_modes = ("tiled",) * m.m_graphs
    if support_modes is not None and set(support_modes) == {"dense"}:
        support_modes = None  # every branch dense: the one batched dense form
    if cfg.mesh.branch > 1 and not m.tiled:
        loop_layout = False
    else:
        loop_layout = True if _strategy_active(cfg) else None
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
        n_real_nodes=n_real_nodes,
        sparse=m.sparse and support_modes is None and cfg.mesh.branch == 1,
        support_modes=support_modes,
        lstm_backend=m.lstm_backend,
        lstm_fused_scan=m.lstm_fused_scan,
        dtype=m.compute_dtype,
        device=device,
        generator=generator,
        placement=placement,
        loop_layout=loop_layout,
    )


def _check_mesh_route(cfg: ExperimentConfig) -> None:
    """What a mesh refuses before any rank is needed: the JAX package's
    refusals (``stmgcn_tpu/experiment.py:466-475``)."""
    if cfg.mesh.n_devices <= 1:
        return
    if cfg.model.lstm_backend == "pallas" and cfg.mesh.branch > 1:
        raise ValueError(
            "lstm_backend='pallas' does not compose with mesh.branch > 1 "
            "— use the xla backend for branch-parallel meshes")


def build_trainer(cfg: ExperimentConfig, *, device=None, initial_state: Optional[dict] = None,
                  graphs: Optional[bool] = None, verbose: bool = True,
                  fault_plan=None, debug_nans: bool = False, dataset=None,
                  supports=None) -> Trainer:
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
    joined ``torch.distributed`` job of ``dp x region x branch`` ranks
    calls this with the same config; it builds the rank's mesh and
    placement (``mesh_from_config``: raises unless the job has exactly that
    many ranks), node-pads and routes the supports (:func:`route_supports`),
    checks divisibility as the JAX ``build_trainer`` does, and builds the
    rank's slice of the model from the same seed. ``lstm_backend="pallas"``
    with ``branch > 1`` and ``model.tiled`` raise with the JAX messages;
    every trainer option composes with the mesh (``Trainer``, **Meshes**).
    ``initial_state`` is the whole, mesh-free ``state_dict``. ``dataset``
    replaces the config-built one (the same config, edited data:
    :func:`~stmgcn_tpu_torch.parallel.compose.banded_dataset` swaps in banded
    adjacencies before routing); ``supports`` the dense stack the caller
    built from it (:func:`route_supports`'), so several trainers of one
    city build it once."""
    _check_health(cfg)
    _check_support_route(cfg)
    _check_mesh_route(cfg)
    device = resolve_device(device)
    mesh = mesh_from_config(cfg.mesh, device=device)
    placement = MeshPlacement(mesh) if mesh is not None else None
    if dataset is None:
        dataset = build_dataset(cfg)
    hetero = getattr(dataset, "heterogeneous", False)
    # each city's node axis rounded up to the region extent (the JAX
    # build_trainer's per-city pads)
    true_nodes = dataset.city_n_nodes if hetero else [dataset.n_nodes]
    pads = [(node_pad_target(cfg, n) or n) - n for n in true_nodes]
    if placement is not None:
        for n_nodes, pad in zip(true_nodes, pads):
            placement.check_divisibility(cfg.train.batch_size, n_nodes + pad,
                                         m_graphs=cfg.model.m_graphs)
    supports, support_modes = route_supports(cfg, dataset, supports)
    model = build_model(cfg, dataset.n_feats, device=device,
                        generator=torch.Generator().manual_seed(cfg.train.seed),
                        placement=placement, support_modes=support_modes,
                        n_real_nodes=dataset.n_nodes if not hetero and pads[0] else None)
    t = cfg.train
    return Trainer(
        model, dataset, supports, node_pad=tuple(pads) if hetero else pads[0],
        lr=t.lr, weight_decay=t.weight_decay,
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
