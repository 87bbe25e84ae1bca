"""Multi-device training on ``torch.distributed``: the mesh, placement,
the collective manifests, autograd across ranks and the composed presets.

Counterpart of ``stmgcn_tpu/parallel`` for the data (``dp``), node
(``region``) and branch (``branch``) axes and their composition. Each rank
is one process; every collective goes through
:mod:`stmgcn_tpu_torch.utils.comm`.

- :mod:`~stmgcn_tpu_torch.parallel.mesh`: ``init_distributed``,
  ``build_mesh``, ``mesh_from_config``, the transport rule;
- :mod:`~stmgcn_tpu_torch.parallel.placement`: ``MeshPlacement``, which
  slice of each array kind a rank holds, and the collective fragments;
- :mod:`~stmgcn_tpu_torch.parallel.manifest`: declared collective
  manifests and the check of one executed step against them;
- :mod:`~stmgcn_tpu_torch.parallel.collectives`: ``BranchFusion`` and the
  step's order-free gradient sync;
- :mod:`~stmgcn_tpu_torch.parallel.region`: the dense node-row plan
  (``region_dense_apply``) and the gate's pooled sum (``region_sum``);
- :mod:`~stmgcn_tpu_torch.parallel.halo`,
  :mod:`~stmgcn_tpu_torch.parallel.banded`: the ring halo exchange and the
  banded strips' product (per branch, or branch-stacked);
- :mod:`~stmgcn_tpu_torch.parallel.sparse`: block-CSR row strips and
  their product through kernels B3 and B4;
- :mod:`~stmgcn_tpu_torch.parallel.compose`: the composed ``multicity``,
  ``scaled``, ``branchpar`` and ``bandedbranch`` trainers and their
  single-device twins.

The names resolve lazily (``compose`` reaches the experiment stack).
"""

import importlib

_LAZY = {
    "BRANCH_FUSION": "stmgcn_tpu_torch.parallel.placement",
    "DP_GRAD_SYNC": "stmgcn_tpu_torch.parallel.placement",
    "GSPMD_REGION": "stmgcn_tpu_torch.parallel.placement",
    "HALO_EXCHANGE": "stmgcn_tpu_torch.parallel.placement",
    "MeshPlacement": "stmgcn_tpu_torch.parallel.placement",
    "BandedSupports": "stmgcn_tpu_torch.parallel.banded",
    "banded_decompose": "stmgcn_tpu_torch.parallel.banded",
    "bandwidth": "stmgcn_tpu_torch.parallel.banded",
    "branch_stack": "stmgcn_tpu_torch.parallel.banded",
    "ShardedBlockSparse": "stmgcn_tpu_torch.parallel.sparse",
    "branch_stack_sparse": "stmgcn_tpu_torch.parallel.sparse",
    "merge_branches": "stmgcn_tpu_torch.parallel.sparse",
    "sharded_from_dense": "stmgcn_tpu_torch.parallel.sparse",
    "sharded_spmm_apply": "stmgcn_tpu_torch.parallel.sparse",
    "sharded_banded_apply": "stmgcn_tpu_torch.parallel.banded",
    "strip_decompose": "stmgcn_tpu_torch.parallel.banded",
    "halo_exchange": "stmgcn_tpu_torch.parallel.halo",
    "region_dense_apply": "stmgcn_tpu_torch.parallel.region",
    "region_sum": "stmgcn_tpu_torch.parallel.region",
    "CollectiveDecl": "stmgcn_tpu_torch.parallel.manifest",
    "CollectiveManifest": "stmgcn_tpu_torch.parallel.manifest",
    "check_executed": "stmgcn_tpu_torch.parallel.manifest",
    "manifest_for_config": "stmgcn_tpu_torch.parallel.manifest",
    "Mesh": "stmgcn_tpu_torch.parallel.mesh",
    "build_mesh": "stmgcn_tpu_torch.parallel.mesh",
    "init_distributed": "stmgcn_tpu_torch.parallel.mesh",
    "mesh_from_config": "stmgcn_tpu_torch.parallel.mesh",
    "transport": "stmgcn_tpu_torch.parallel.mesh",
    "BranchFusion": "stmgcn_tpu_torch.parallel.collectives",
    "GradSync": "stmgcn_tpu_torch.parallel.collectives",
    "replica_sum": "stmgcn_tpu_torch.parallel.collectives",
    "COMPOSED_PRESETS": "stmgcn_tpu_torch.parallel.compose",
    "banded_dataset": "stmgcn_tpu_torch.parallel.compose",
    "banded_meta": "stmgcn_tpu_torch.parallel.compose",
    "composed_config": "stmgcn_tpu_torch.parallel.compose",
    "composed_trainer": "stmgcn_tpu_torch.parallel.compose",
    "parity_twin_kind": "stmgcn_tpu_torch.parallel.compose",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        value = getattr(importlib.import_module(_LAZY[name]), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
