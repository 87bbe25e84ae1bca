"""Collective-shape contracts: static mesh and operand math.

A copy of ``stmgcn_tpu/analysis/collective_check.py``. A mesh training
step moves data through collectives whose operand shapes the config fixes:
the region halo exchange (:func:`~stmgcn_tpu_torch.utils.comm.
ring_exchange`, :mod:`stmgcn_tpu_torch.parallel.halo`) sends ``halo``
boundary rows a shard, the data-parallel gradient sync sums per-rank batch
slices, and branch parallelism all-reduces over equal branch shards. A
config whose extents do not divide its operands fails only at run time, on
the mesh, maybe hours in (``strip_decompose`` raises at decomposition
time, a ragged batch at placement). This pass re-derives the shapes from
the config alone (no data, no model) and flags the mismatches up front for
every preset whose mesh spans more than one device.

For the halo plan it estimates the grid (neighbourhood) branch's support
bandwidth a priori: a rows x cols rook grid in row-major order has
adjacency bandwidth ``cols``, and a K-hop kernel (``chebyshev`` /
``random_walk_diffusion`` of order K) reaches ``K * cols``; ``localpool``
is one hop. The transport and similarity branches' exact bandwidths depend
on the data, but their nonzero **counts** are config math
(:func:`expected_branch_nnz`), and a matrix of bandwidth ``b`` has at most
``n * (2b + 1)`` nonzeros under *any* node ordering, so
:func:`branch_bandwidth_floor` is a sound lower bound on the bandwidth any
reordering can reach. When ``region_strategy="banded"`` is *forced*
(``"auto"`` routes dense branches away at decomposition time), a floor
above the halo budget means strip decomposition must drop neighbours.

The halo checks hold for the banded plan only, as in the JAX pass
(``halo_active``): a ``model.sparse`` config on a region mesh takes the
block-CSR row strips (:mod:`stmgcn_tpu_torch.parallel.sparse`), which
gather node rows and exchange no halo, so it is left out.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from stmgcn_tpu_torch.analysis._configs import finding, preset_configs
from stmgcn_tpu_torch.analysis.report import Finding

__all__ = [
    "branch_bandwidth_floor",
    "check_collective_contracts",
    "expected_branch_nnz",
    "grid_bandwidth_estimate",
]

_K_HOP_KERNELS = ("chebyshev", "random_walk_diffusion")


def grid_bandwidth_estimate(kernel_type: str, K: int, cols: int) -> int:
    """A-priori support bandwidth of the rook-grid branch.

    Row-major rook adjacency has bandwidth ``cols`` (the vertical
    neighbor); a K-hop kernel's highest-order support reaches K such
    steps. ``localpool`` is the one-hop Kipf support.
    """
    hops = K if kernel_type in _K_HOP_KERNELS else 1
    return hops * cols


def expected_branch_nnz(kind: str, n: int) -> int:
    """Worst-case nonzero count of a data-dependent branch support.

    ``transport``: the synthetic generator draws directed Bernoulli edges
    at rate ``p = min(1, 10/n)`` and symmetrizes, so an (i, j) entry is
    present with probability ``<= 2p`` — worst case ``min(n*n, 20*n)``
    nonzeros. ``similarity``: the generator thresholds at the top decile
    of pairwise correlations, exactly ``ceil(0.1 * n*n)`` entries.
    """
    if kind == "transport":
        return min(n * n, 20 * n)
    if kind == "similarity":
        return -(-(n * n) // 10)
    raise ValueError(f"unknown data-dependent branch kind: {kind!r}")


def branch_bandwidth_floor(n: int, nnz: int) -> int:
    """Lower bound on achievable bandwidth for any ordering of an
    ``n x n`` support with ``nnz`` nonzeros.

    A matrix with bandwidth ``b`` has at most ``n * (2b + 1)`` nonzeros,
    so ``b >= (nnz/n - 1) / 2`` no matter how the decomposer permutes
    nodes — the a-priori bound the grid branch gets from geometry, the
    dense branches get from counting.
    """
    per_row = -(-nnz // n)  # ceil: the densest row is at least the mean
    return max(0, -(-(per_row - 1) // 2))


def _city_grids(cfg) -> List[Tuple[int, int]]:
    """Every city's (rows, cols) synthetic grid shape."""
    d = cfg.data
    if d.city_rows is not None:
        return [(r, r) for r in d.city_rows]
    cols = d.cols if d.cols is not None else d.rows
    return [(d.rows, cols)] * max(1, d.n_cities)


def check_collective_contracts(
    configs: Optional[Iterable[Tuple[str, object]]] = None,
) -> List[Finding]:
    """Validate collective operand shapes against mesh extents.

    ``configs`` is ``(name, ExperimentConfig)`` pairs; default is every
    preset. Pure config math.
    """
    configs = preset_configs() if configs is None else configs
    findings: List[Finding] = []

    def emit(name: str, message: str) -> None:
        findings.append(finding("collective-shape", "collective", name, message))

    for name, cfg in configs:
        mesh = cfg.mesh
        if mesh.n_devices <= 1:
            continue

        if mesh.dp > 1 and cfg.train.batch_size % mesh.dp:
            emit(
                name,
                f"{name}: batch_size {cfg.train.batch_size} is not "
                f"divisible by dp={mesh.dp} — the data-parallel gradient "
                "sum would see ragged per-rank batch shards",
            )

        if mesh.branch > 1 and cfg.model.m_graphs % mesh.branch:
            emit(
                name,
                f"{name}: m_graphs {cfg.model.m_graphs} is not divisible "
                f"by branch={mesh.branch} — the branch-fusion all-reduce "
                "needs equal branch shards on every rank",
            )

        halo_active = (
            mesh.region > 1
            and mesh.region_strategy in ("banded", "auto")
            and not cfg.model.sparse
        )
        if not halo_active:
            continue
        for rows, cols in _city_grids(cfg):
            n = rows * cols
            padded = -(-n // mesh.region) * mesh.region
            n_local = padded // mesh.region
            budget = min(
                mesh.halo if mesh.halo is not None else n_local // 2, n_local
            )
            if mesh.halo is not None and mesh.halo > n_local:
                emit(
                    name,
                    f"{name}: mesh.halo {mesh.halo} exceeds the shard size "
                    f"{n_local} ({padded} padded nodes / region="
                    f"{mesh.region}) — the halo ring exchange cannot "
                    "send more rows than the shard holds",
                )
            bw = grid_bandwidth_estimate(
                cfg.model.kernel_type, cfg.model.K, cols
            )
            if bw > n_local:
                emit(
                    name,
                    f"{name}: grid-branch support bandwidth ~{bw} "
                    f"({cfg.model.kernel_type} K={cfg.model.K} on a "
                    f"{rows}x{cols} grid) exceeds the shard size {n_local} "
                    "— no halo fits; shrink mesh.region or reorder nodes",
                )
            elif bw > budget and mesh.region_strategy == "banded":
                emit(
                    name,
                    f"{name}: region_strategy='banded' but the grid "
                    f"branch's support bandwidth ~{bw} exceeds the halo "
                    f"budget {budget} (shard size {n_local}) — "
                    "strip_decompose would drop boundary neighbors; use "
                    "'auto' or raise mesh.halo",
                )
            if mesh.region_strategy != "banded":
                continue
            # forced banded routes the data-dependent branches through
            # strip decomposition too — gate on their counting floor
            # (branch order: 0 grid, 1 transport, 2 similarity)
            present = []
            if cfg.model.m_graphs >= 2:
                present.append("transport")
            if cfg.model.m_graphs >= 3:
                present.append("similarity")
            for kind in present:
                floor = branch_bandwidth_floor(
                    n, expected_branch_nnz(kind, n)
                )
                if floor > budget:
                    emit(
                        name,
                        f"{name}: region_strategy='banded' but the {kind} "
                        f"branch's bandwidth floor {floor} (worst-case "
                        f"{expected_branch_nnz(kind, n)} nnz over {n} "
                        f"nodes; no ordering can do better) exceeds the "
                        f"halo budget {budget} — strip_decompose must "
                        "drop neighbors; use 'auto' or raise mesh.halo",
                    )
    return findings
