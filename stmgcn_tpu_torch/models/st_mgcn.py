"""ST-MGCN: the multi-graph flagship model.

Counterpart of ``stmgcn_tpu/models/st_mgcn.py`` in its vmapped form: the M
graph branches are one :class:`Branch` whose parameters carry a leading
``M`` axis, run as one batched computation — so the shared LSTM of all M
branches is one kernel launch on the GPU, and so is each graph conv over a
tiled plan. Fusion sums the M branch outputs in float32, then a
``Dense(gcn_hidden -> horizon * input_dim)`` head gives the ``(B, N, C)``
next-step prediction, or ``(B, H, N, C)`` for ``horizon > 1``.

``dtype`` is the compute dtype (None or float32: the fp32 path;
``torch.bfloat16``: the JAX model at ``dtype=bfloat16``, over float32
parameters, its LSTM in the bf16 form ``lstm_backend`` names with the
rounding ``lstm_fused_scan`` picks, ``ops/lstm.py``): the branch outputs are summed in float32 and rounded to bf16,
the head sums in float32, and the prediction leaves in bf16, as the JAX
model's serve boundary. :func:`~stmgcn_tpu_torch.ops.layers.set_compute_dtype`
changes it on a built model.

The support representation is one mode for the whole model (``"dense"``,
``"sparse"`` or ``"tiled"``, from ``sparse=`` or a uniform
``support_modes=``), or per branch: ``support_modes`` of ``"banded"`` and
``"dense"`` (the region mesh's halo plan beside dense branches, JAX's
``("banded", "dense", "dense")``), whose graph convs run branch by branch
(:class:`~stmgcn_tpu_torch.ops.chebconv.MixedChebGraphConv`) while the
gate's Dense layers and the LSTM stay one batched computation, so the M
branches still share one LSTM launch. The parameters are the same in every
mode and layout, so weights trained on one representation serve on another
unchanged. The JAX package runs non-dense branches as a Python loop and
stores them as ``branch_0 .. branch_{M-1}``, except branch-stacked banded
strips or block-CSR strips on a ``branch`` mesh, which keep the stacked
(vmapped) layout;
:func:`~stmgcn_tpu_torch.models.params.from_jax_params` reads either
layout into this one, and ``loop_layout`` (derived from the support mode
when not given: looped for any non-dense mode) makes checkpoints write the
one the JAX package gives the same config.

**On a region mesh** (``placement`` with ``region > 1``) every node-indexed
array holds the rank's ``N / region`` rows: the graph convs and the gate
pooling take the mesh (``region_mesh``), the LSTM and the head run on the
rank's rows alone. The convs take a row strip of a dense stack, banded
strips (per branch, or branch-stacked on a ``region x branch`` mesh: each
branch group then runs its own region ring) or block-CSR strips
(:class:`~stmgcn_tpu_torch.parallel.sparse.ShardedBlockSparse`, one kernel
launch for the rank's branches). ``n_real_nodes`` is the real node count of a
node-padded model (the gate pools over it).

**On a mesh** (``placement``, a
:class:`~stmgcn_tpu_torch.parallel.placement.MeshPlacement`, the one the
trainer reads as ``model.placement``) with ``branch > 1`` each rank's :class:`Branch` holds
``M / branch`` of the stacked branches: the weights are drawn for all M
from the generator, as on one device, and the rank keeps its slice, so a
mesh model is the single-device one split up. Its supports are the rank's
slice too. The fusion is a float32 partial sum over the local branches,
then :class:`~stmgcn_tpu_torch.parallel.collectives.BranchFusion` (an
all-reduce over ``branch`` whose backward is the identity), then the cast;
the head runs on every branch rank. ``m_graphs`` stays M (checkpoints hold
all M branches, gathered); ``m_local`` is the rank's count.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from stmgcn_tpu_torch.models.cg_lstm import CGLSTM
from stmgcn_tpu_torch.ops.chebconv import LOOP_MODES, conv_cls, make_conv
from stmgcn_tpu_torch.ops.layers import Dense, resolve_device, set_compute_dtype
from stmgcn_tpu_torch.ops.spmm import BlockSparseStack
from stmgcn_tpu_torch.ops.tiling import TiledSupports
from stmgcn_tpu_torch.parallel.banded import BandedSupports
from stmgcn_tpu_torch.parallel.collectives import branch_fusion
from stmgcn_tpu_torch.parallel.sparse import ShardedBlockSparse

__all__ = ["Branch", "STMGCN"]


class Branch(nn.Module):
    """One graph view's encoder: CGLSTM -> graph conv on the LSTM state."""

    def __init__(self, n_supports: int, seq_len: int, input_dim: int,
                 lstm_hidden_dim: int, lstm_num_layers: int, gcn_hidden_dim: int, *,
                 use_bias: bool = True, shared_gate_fc: bool = True,
                 n_real_nodes: Optional[int] = None, support_mode: str = "dense",
                 lstm_backend: str = "xla", lstm_fused_scan: bool = False,
                 branches: Optional[int] = None, device=None, generator=None):
        super().__init__()
        kw = dict(branches=branches, device=device, generator=generator)
        self.cg_lstm = CGLSTM(n_supports, seq_len, input_dim, lstm_hidden_dim,
                              lstm_num_layers, use_bias=use_bias,
                              shared_gate_fc=shared_gate_fc,
                              n_real_nodes=n_real_nodes, support_mode=support_mode,
                              lstm_backend=lstm_backend, lstm_fused_scan=lstm_fused_scan,
                              **kw)
        self.gcn = make_conv(support_mode, n_supports, lstm_hidden_dim, gcn_hidden_dim,
                             use_bias=use_bias, **kw)

    def forward(self, supports, obs_seq: torch.Tensor,
                n_real: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.gcn(supports, self.cg_lstm(supports, obs_seq, n_real))


class STMGCN(nn.Module):
    """Multi-graph spatiotemporal model; ``(B, T, N, C) -> (B, N, C)``
    (``(B, H, N, C)`` with ``horizon > 1``).

    ``device=None`` means the GPU (and raises without one); weights are
    drawn from ``generator`` (default: a generator seeded 0).
    """

    def __init__(self, m_graphs: int, n_supports: int, seq_len: int, input_dim: int, *,
                 horizon: int = 1, lstm_hidden_dim: int = 64, lstm_num_layers: int = 3,
                 gcn_hidden_dim: int = 64, use_bias: bool = True,
                 shared_gate_fc: bool = True, n_real_nodes: Optional[int] = None,
                 sparse: bool = False, support_modes: Optional[Sequence[str]] = None,
                 lstm_backend: str = "xla", lstm_fused_scan: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 device=None, generator: Optional[torch.Generator] = None, placement=None,
                 loop_layout: Optional[bool] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.m_graphs = m_graphs
        self.n_supports = n_supports
        self.seq_len = seq_len
        self.input_dim = input_dim
        self.horizon = horizon
        #: each branch's support mode; ``support_mode`` is their one mode,
        #: or "mixed"
        self.support_modes = self._modes(m_graphs, sparse, support_modes)
        modes = set(self.support_modes)
        self.support_mode = self.support_modes[0] if len(modes) == 1 else "mixed"
        #: checkpoints write the JAX loop layout (``branch_m``); None: any
        #: non-dense mode does
        self.loop_layout = (self.support_mode != "dense" if loop_layout is None
                            else bool(loop_layout))
        per_branch = "banded" in modes
        self.branches = Branch(
            n_supports, seq_len, input_dim, lstm_hidden_dim, lstm_num_layers,
            gcn_hidden_dim, use_bias=use_bias, shared_gate_fc=shared_gate_fc,
            n_real_nodes=n_real_nodes,
            support_mode=self.support_modes if per_branch else self.support_mode,
            lstm_backend=lstm_backend, lstm_fused_scan=lstm_fused_scan, branches=m_graphs,
            device=device, generator=generator,
        )
        self.head = Dense(gcn_hidden_dim, horizon * input_dim, device=device,
                          generator=generator)
        #: this rank's mesh placement (None: one device)
        self.placement = placement
        mesh = getattr(placement, "mesh", None)
        #: the branch mesh the fusion all-reduces over (None: one device, or
        #: a mesh without a branch axis)
        self.mesh = mesh if mesh is not None and mesh.branch > 1 else None
        self.m_local = m_graphs
        #: the support modes of this rank's branches
        self.local_modes = self.support_modes
        if self.mesh is not None:
            self._keep_branches()
        #: the region mesh the node rows shard over (None: all rows here)
        self.region_mesh = mesh if mesh is not None and mesh.region > 1 else None
        if self.region_mesh is not None:
            if self.support_mode == "tiled":
                raise ValueError(
                    "model.tiled does not compose with a >1-device mesh — the reordered tile "
                    "plan owns the whole node axis; use dense GSPMD or sharded sparse supports "
                    "for multi-device configs")
            for module in self.modules():
                if hasattr(module, "region_mesh"):
                    module.region_mesh = self.region_mesh
        self.compute_dtype: Optional[torch.dtype] = None
        set_compute_dtype(self, dtype)

    def _keep_branches(self) -> None:
        """Keep this rank's ``M / branch`` stacked branches: every
        parameter of :attr:`branches` cut on its leading axis, and every
        module's branch count set to the local one."""
        keep = self.placement.branches(self.m_graphs)
        self.m_local = keep.stop - keep.start
        self.local_modes = self.support_modes[keep]
        for module in self.branches.modules():
            if getattr(module, "branches", None) is not None:
                module.branches = self.m_local
            if hasattr(module, "modes"):  # a per-branch conv keeps its branches' modes
                module.modes = module.modes[keep]
            for name, p in list(module.named_parameters(recurse=False)):
                setattr(module, name, nn.Parameter(p.detach()[keep].clone()))

    def branch_modes(self) -> tuple:
        """Each branch's support mode (the JAX ``STMGCN.branch_modes``)."""
        return self.support_modes

    @staticmethod
    def _modes(m_graphs, sparse, support_modes) -> tuple:
        """Each branch's support mode: one mode for all, or a mix of
        :data:`~stmgcn_tpu_torch.ops.chebconv.LOOP_MODES`."""
        if support_modes is None:
            return ("sparse" if sparse else "dense",) * m_graphs
        if sparse:
            raise ValueError("pass either sparse=True or support_modes, not both")
        modes = tuple(support_modes)
        if len(modes) != m_graphs:
            raise ValueError(f"support_modes needs {m_graphs} entries, got {len(modes)}")
        for mode in modes:
            conv_cls(mode)  # rejects unknown modes
        if len(set(modes)) > 1 and not set(modes) <= set(LOOP_MODES):
            raise ValueError(f"mixed per-branch support modes {modes}: only {LOOP_MODES} mix")
        return modes

    def check_supports(self, supports) -> None:
        """Raise unless ``supports`` is this model's form: a dense ``(M, K,
        N, N)`` tensor (or ``(B, M, K, N, N)``, one stack per batch row, as
        fleet serving gathers them), a
        :class:`~stmgcn_tpu_torch.ops.tiling.TiledSupports` plan of M
        branches x K supports, or M per-branch block-sparse groups (or one
        branch-stacked ``BlockSparseStack``, or on a mesh the rank's
        ``ShardedBlockSparse`` strip); banded branches take M per-branch
        forms or one branch-stacked ``BandedSupports``."""
        mode, want = self.support_mode, (self.m_local, self.n_supports)
        if mode in ("banded", "mixed"):
            self._check_per_branch(self._per_branch(supports))
            return
        if mode == "sparse" and isinstance(supports, ShardedBlockSparse):
            if (supports.branches, supports.n_supports) != want:
                raise ValueError(f"a ShardedBlockSparse strip of {supports.branches} branches x "
                                 f"{supports.n_supports} supports for a model of {want}")
            return
        if mode != "tiled" and isinstance(supports, TiledSupports):
            raise ValueError(
                f"a {mode} model got a TiledSupports plan: build the model with "
                "model.tiled=True to serve a plan (the weights load unchanged)")
        if mode == "dense":
            if not isinstance(supports, torch.Tensor) or supports.dim() not in (4, 5) or (
                    tuple(supports.shape[-4:-2]) != want):
                got = tuple(supports.shape) if hasattr(supports, "shape") else type(supports)
                raise ValueError(f"supports_stack must be ({want[0]}, {want[1]}, N, N), "
                                 f"got {got}")
        elif mode == "tiled":
            if not isinstance(supports, TiledSupports) or (
                    (supports.m_graphs, supports.n_supports) != want):
                raise ValueError(
                    f"a tiled model takes a TiledSupports plan of (M, K)={want}, got "
                    f"{type(supports).__name__}; a dense-built model serves a plan once "
                    "rebuilt with model.tiled=True (its weights load unchanged)")
        elif not isinstance(supports, BlockSparseStack) and len(supports) != self.m_local:
            raise ValueError(
                f"need {self.m_local} per-branch support groups, got {len(supports)}")

    @staticmethod
    def _per_branch(supports):
        """A branch-stacked ``BandedSupports`` as its per-branch strips."""
        if isinstance(supports, BandedSupports) and supports.branch_stacked:
            return tuple(supports.branch(m) for m in range(supports.strips.shape[0]))
        return supports

    def _check_per_branch(self, supports) -> None:
        """A per-branch model's supports: M forms, each its branch's mode."""
        if isinstance(supports, torch.Tensor) or not isinstance(supports, Sequence) or (
                len(supports) != self.m_local):
            got = len(supports) if isinstance(supports, Sequence) else type(supports).__name__
            raise ValueError(f"need {self.m_local} per-branch support groups "
                             f"{self.local_modes}, got {got}")
        for m, (mode, sup) in enumerate(zip(self.local_modes, supports)):
            ok = (isinstance(sup, BandedSupports) if mode == "banded" else
                  isinstance(sup, torch.Tensor) and sup.dim() == 3)
            if not ok:
                raise ValueError(f"branch {m} ({mode}) got {type(sup).__name__}"
                                 f"{tuple(sup.shape) if hasattr(sup, 'shape') else ''}")

    def forward(self, supports_stack, obs_seq: torch.Tensor,
                n_real: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``supports_stack`` in the model's support form (see
        :meth:`check_supports`); ``obs_seq`` ``(B, T, N, C)``; ``n_real``
        the real-node count of a node-padded fleet city (an int tensor,
        ``()`` for the batch or ``(B,)`` per row), which the gate pools
        over."""
        self.check_supports(supports_stack)
        supports_stack = self._per_branch(supports_stack)
        if isinstance(supports_stack, torch.Tensor) and supports_stack.dim() == 5:
            supports_stack = supports_stack.transpose(0, 1)  # (M, B, K, N, N)
        feats = self.branches(supports_stack, obs_seq, n_real)  # (M, B, N, gcn_hidden)
        # f32 fusion island; the prediction leaves in the compute dtype
        dtype = self.compute_dtype or torch.float32
        fused = feats.sum(dim=0, dtype=torch.float32)
        if self.mesh is not None:  # the other ranks' branches: one all-reduce
            fused = branch_fusion(fused, self.mesh)
        out = self.head(fused.to(dtype)).to(dtype)
        if self.horizon == 1:
            return out  # (B, N, C)
        batch, n_nodes = out.shape[:2]
        return out.reshape(batch, n_nodes, self.horizon, self.input_dim).transpose(1, 2)
