"""Composed multi-device trainers: one shrunk trainer per mesh preset.

Counterpart of ``stmgcn_tpu/parallel/compose.py``, with the JAX shrinks
(``compose.py:80-135``): for each multi-device preset a small trainer
built through the real assembly path (``build_dataset`` ->
``build_supports`` -> ``build_model`` -> ``Trainer``) whose window-free
resident blocks engage on the preset's mesh, and its parity twin.

========== ================== =========================================
preset      mesh               composed program
========== ================== =========================================
multicity   dp=8               ``fleet_superstep`` (hetero city pair)
scaled      region=8 (auto)    ``series_superstep``, node rows sharded:
                               the grid branch banded, the others dense
branchpar   dp=2 x branch=3    ``series_superstep``, branch-sharded
bandedbranch dp=2 x region=2    ``series_superstep``, branch-stacked
            x branch=2          banded strips (injected banded adjs)
========== ================== =========================================

Every preset has a true single-device twin: the same config with the mesh
removed, the same initial parameters (the mesh model is the single-device
one split up, ``models/st_mgcn.py``; the port draws the same weights in
every branch layout, so unlike the JAX package the banded ``scaled`` and
``bandedbranch`` have one too). ``composed_trainer`` of a mesh preset runs
in every rank of a job of that many ranks (``init_distributed``); its twin
(``twin="single"``) on one process. ``bandedbranch``'s synthetic transport
graph cannot be banded, so, as the JAX ``composed_trainer`` does, its
composed trainer (and its twin) train on banded city adjacencies
(:func:`banded_dataset`) and the branch-stacked halo plan engages.
"""

from __future__ import annotations

__all__ = [
    "banded_dataset",
    "banded_meta",
    "COMPOSED_PRESETS",
    "composed_config",
    "composed_trainer",
    "parity_twin_kind",
]

#: every multi-device preset with a composed program (the JAX table's)
COMPOSED_PRESETS = ("multicity", "scaled", "branchpar", "bandedbranch")

#: twin kind per preset (the JAX ``_TWIN``, but the banded ``scaled`` and
#: ``bandedbranch`` have true single-device twins in the port)
_TWIN = {
    "multicity": "single",
    "scaled": "single",
    "branchpar": "single",
    "bandedbranch": "single",
}


def _band_adj(n: int, w: int, seed: int):
    """Symmetric adjacency with every edge within index distance ``w``
    (the JAX ``compose.py:68``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), np.float32)
    for d in range(1, w + 1):
        band = (rng.random(n - d) < 0.7).astype(np.float32)
        a += np.diag(band, d) + np.diag(band, -d)
    return a


def banded_dataset(cfg):
    """``cfg``'s dataset with banded city adjacencies in place of the
    synthetic graphs (bandwidths 1 and 2; the JAX ``composed_trainer``'s
    stand-in, ``compose.py:200-207``), so a ``bandedbranch`` config routes
    every branch to the halo plan."""
    from stmgcn_tpu_torch.experiment import build_dataset

    dataset = build_dataset(cfg)
    n = dataset.n_nodes
    dataset.adjs = {"g0": _band_adj(n, 1, 1), "g1": _band_adj(n, 2, 2)}
    return dataset


def _shrink_model(cfg) -> None:
    cfg.model.lstm_hidden_dim = 8
    cfg.model.lstm_num_layers = 1
    cfg.model.gcn_hidden_dim = 8
    cfg.model.dtype = "float32"


def composed_config(name: str):
    """The preset's shrunk config whose blocks engage on its mesh (the JAX
    shrinks): mesh axes kept; data and model shrunk; the window-free
    resident blocks opted into (``data_placement="resident"``,
    ``window_free=True``, ``steps_per_superstep=2``)."""
    from stmgcn_tpu_torch.config import preset

    if name not in COMPOSED_PRESETS:
        raise ValueError(
            f"no composed program for preset {name!r}; known: {COMPOSED_PRESETS}")
    cfg = preset(name)
    _shrink_model(cfg)
    cfg.train.epochs = 2
    cfg.train.steps_per_superstep = 2
    cfg.train.window_free = True
    cfg.train.data_placement = "resident"
    if name == "multicity":
        # hetero city pair, both cities in one fleet shape class (rows
        # 4/3 both rung-pad to 16 nodes); batch 16 = dp x 2
        cfg.data.rows = 4
        cfg.data.city_rows = (4, 3)
        cfg.data.n_timesteps = 24 * 7 * 2 + 40
        cfg.data.city_timesteps = (24 * 7 * 2 + 40, 24 * 7 * 2 + 30)
        cfg.train.batch_size = 16
    elif name == "scaled":
        # 32x2 grid, Chebyshev K=2: grid bandwidth K x cols = 4 <= n_local // 2
        # = 4 (the 50x50 K=3 original routes the same way at preset scale);
        # the random transport and similarity branches rightly stay dense:
        # the preset's mixed banded/dense plan
        cfg.data.rows, cfg.data.cols = 32, 2
        cfg.data.n_timesteps = 24 * 7 + 64
        cfg.model.K = 2
        cfg.train.batch_size = 4
    elif name == "branchpar":
        cfg.data.rows = 4
        cfg.data.n_timesteps = 24 * 7 + 64
        cfg.train.batch_size = 4
    else:  # bandedbranch
        cfg.data.rows = 4
        cfg.data.n_timesteps = 24 * 7 + 64
        cfg.train.batch_size = 4
        cfg.mesh.halo = 4
    return cfg


def banded_meta(trainer, cfg) -> dict:
    """The halo wire model's inputs for a trainer on a region mesh
    (``analysis/spmd_check.py``'s permute bound; the JAX
    ``compose.py:230-258``): the largest halo of its routed banded strips,
    and the per-shard batch, graph and feature extents from ``cfg``. Empty
    when no branch took the halo plan (a dense program has no permute
    bound)."""
    from stmgcn_tpu_torch.parallel.banded import BandedSupports

    sups = trainer.supports if isinstance(trainer.supports, tuple) else (trainer.supports,)
    banded = [s for s in sups if isinstance(s, BandedSupports)]
    if not banded:
        return {}
    f_cap = (cfg.data.serial_len + cfg.data.daily_len + cfg.data.weekly_len
             + 2 * cfg.model.lstm_hidden_dim + cfg.model.gcn_hidden_dim)
    return {"halo": max(s.halo for s in banded),
            "b_local": cfg.train.batch_size // cfg.mesh.dp,
            "m_local": max(1, cfg.model.m_graphs // cfg.mesh.branch),
            "f_cap": f_cap}


def parity_twin_kind(name: str) -> str:
    return _TWIN[name]


def composed_trainer(name: str, *, twin: str | None = None, out_dir: str | None = None,
                     epochs: int | None = None, device=None, initial_state=None,
                     verbose: bool = False):
    """The preset's composed trainer (``twin=None``, in every rank of its
    job) or its single-device twin (``twin="single"``); ``initial_state``
    (mesh-free) as ``build_trainer``'s. ``bandedbranch`` (and its twin)
    train on :func:`banded_dataset`. A composed ``scaled`` whose routing
    did not put a branch on the halo plan raises (the JAX check), and so
    does a composed ``bandedbranch`` whose supports are not branch-stacked
    strips."""
    from stmgcn_tpu_torch.config import MeshConfig
    from stmgcn_tpu_torch.experiment import build_trainer

    cfg = composed_config(name)
    if epochs is not None:
        cfg.train.epochs = epochs
    if out_dir is not None:
        cfg.train.out_dir = out_dir
    if twin == "single":
        cfg.mesh = MeshConfig()
    elif twin is not None:
        raise ValueError(f'twin must be None or "single", got {twin!r}')
    dataset = banded_dataset(cfg) if name == "bandedbranch" else None
    trainer = build_trainer(cfg, device=device, initial_state=initial_state, verbose=verbose,
                            dataset=dataset)
    if name == "scaled" and twin is None and "banded" not in trainer.model.support_modes:
        raise RuntimeError(f"composed {name!r}: routing did not engage the banded plan — the "
                           "shrink no longer matches the router's bandwidth budget")
    if name == "bandedbranch" and twin is None and not getattr(
            trainer.supports, "branch_stacked", False):
        raise RuntimeError(f"composed {name!r}: routing did not stack the banded strips")
    return trainer
