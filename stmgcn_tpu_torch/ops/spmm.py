"""Block-CSR sparse supports and their products: host structures, the
hand-written CUDA kernels and their plain PyTorch versions.

Counterpart of ``stmgcn_tpu/ops/spmm.py``. A support is stored as
**uniform block-CSR**: the ``(N_r, N_c)`` matrix cut into ``(tile, tile)``
blocks, only the blocks holding a nonzero kept, every block row padded to
the same number ``C`` of stored slots with zero blocks at block column 0,
so every operand has a static shape. Each row's nonzero blocks come first,
and ``nblk`` counts them, so the kernels skip the padding; ``row_order``,
derived from the counts on first use, lists the block rows by descending
count, the order the kernels' grid takes them in. The transposed structure
(``data_t``, ``idx_t``, ``nblk_t``, ``row_order_t``) is built beside it for
the backward pass. The
builders (:func:`from_dense`, :func:`stack_from_dense` and the scan and
assembly helpers) are numpy on the host, copied from the JAX package (its
optional C++ block scan is left out: the numpy scan gives the same map).

Three kernels in ``csrc/spmm_stack.cu`` carry the products:

- **B3** (:func:`spmm_stack`'s forward): ``out[k] = A_k @ x`` for all K
  supports, and for all M branches at once when the stack carries a
  leading branch axis — ``x`` is then shared ``(N_c, F)`` or per branch
  ``(M, N_c, F)``;
- **B4** (:func:`spmm_stack_bwd`, :func:`spmm_stack`'s backward):
  ``dx = sum_k A_k^T @ g_k`` over the pre-transposed blocks, summed over
  the branches too when ``x`` was shared; no atomics, bitwise repeatable;
- **B5** (:func:`spmm`): one support's ``A @ x``, whose backward is the
  same kernel on the transposed structure.

Each wrapper calls one PyTorch operator (``torch.ops.stmgcn.spmm_stack_fwd``,
``spmm_stack_bwd``, ``spmm``, registered here beside B1's and B2's), whose
implementation the dispatcher picks by where the tensors live: CUDA
tensors launch the kernel (or raise — no fallback), CPU tensors take the
plain version
(:func:`spmm_stack_reference`, :func:`spmm_stack_bwd_reference`,
:func:`spmm_reference`: a gather of the signal's row blocks by the index
lists and one batched tile contraction over every stored slot, padding
included). Each launch adds one to its wrapper's ``launches`` count (and
B3's to ``launches_shared`` when its signal is shared). Gradients flow to
``x`` only: the supports are offline constants and get no gradient, as in
the JAX package. A trace takes each operator's fake implementation (its
output's shape and dtype), one node a launch (``analysis/programs.py``).

**bf16.** The structures keep their float32 blocks; a bf16 compute path
takes :meth:`BlockSparseStack.astype` (made once per dtype and kept), as
the JAX conv casts the blocks to the signal's dtype. A product of bf16
blocks and a bf16 signal sums in float32 and returns float32 (the JAX
kernels' ``preferred_element_type``). The backward takes the cotangent in
the signal's dtype (:class:`BlockCSRApply` casts it) on both devices, as
the gradient leaves in it: on a bf16 compute path the cotangent reaches it
in float32 through the caller's cast back to bf16, holding values bf16
represents, so the cast is exact there and the product is what the JAX
kernel's ``jnp.dot(bf16 blocks, g)`` gives. A float32 cotangent that bf16
cannot represent is rounded to bf16 first, on the CPU as on the card
(the JAX kernel would read it unrounded). Blocks and signal (or cotangent)
of different dtypes, which the JAX package never pairs, raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from stmgcn_tpu_torch.ops import counters
from stmgcn_tpu_torch.ops._build import load_library, on_cuda

__all__ = [
    "BlockSparse",
    "BlockSparseStack",
    "KERNEL_ROLES",
    "KERNEL_TILES",
    "TILE",
    "from_dense",
    "heavy_first",
    "kernel_attributes",
    "kernel_library",
    "kernel_plan",
    "place_supports",
    "spmm",
    "spmm_dense_reference",
    "spmm_reference",
    "spmm_stack",
    "spmm_stack_bwd",
    "spmm_stack_bwd_reference",
    "spmm_stack_reference",
    "stack_from_dense",
]

TILE = 128
#: block sizes the CUDA kernels take (the plain versions take any)
KERNEL_TILES = (64, 128)
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "spmm_stack.cu"


def _ceil_to(n: int, t: int) -> int:
    return -(-n // t) * t


# -- host structures (numpy, offline) ----------------------------------------

def _scan_blocks(mat: np.ndarray, tile: int):
    """Dense (Nr, Nc) -> padded (R, C, tile, tile) block view + (R, C)
    nonzero map."""
    nr, nc = mat.shape
    r, c = _ceil_to(nr, tile) // tile, _ceil_to(nc, tile) // tile
    padded = np.zeros((r * tile, c * tile), dtype=np.float32)
    padded[:nr, :nc] = mat
    blocks = padded.reshape(r, tile, c, tile).transpose(0, 2, 1, 3)
    return blocks, np.any(blocks != 0.0, axis=(2, 3))


def _assemble_blocks(blocks, nonzero, c_max: int, tile: int):
    """Scanned blocks -> uniform block-CSR ``(data, idx, nblk)`` at an
    imposed width: each row's nonzero blocks first, ``nblk`` (R,) int32
    counting them (the slots from ``nblk`` on are zero blocks at index 0)."""
    r = blocks.shape[0]
    nblk = nonzero.sum(axis=1).astype(np.int32)
    need = max(int(nblk.max()), 1)
    if need > c_max:
        raise ValueError(f"row needs {need} block-columns > imposed c_max {c_max}")
    data = np.zeros((r, c_max, tile, tile), dtype=np.float32)
    idx = np.zeros((r, c_max), dtype=np.int32)
    for i in range(r):
        cols = np.flatnonzero(nonzero[i])
        data[i, : len(cols)] = blocks[i, cols]
        idx[i, : len(cols)] = cols
    return data, idx, nblk


def _to_blocks_rect(mat: np.ndarray, tile: int, c_max: Optional[int] = None):
    """Dense (Nr, Nc) -> uniform block-CSR (data, idx, nblk); optionally
    padded to an externally-imposed ``c_max`` (for uniform stacking)."""
    blocks, nonzero = _scan_blocks(mat, tile)
    if c_max is None:
        c_max = max(int(nonzero.sum(axis=1).max()), 1)
    return _assemble_blocks(blocks, nonzero, c_max, tile)


def heavy_first(nblk) -> torch.Tensor:
    """The block rows of the counts ``nblk`` (flattened) by descending
    count, ties in row order, int32: the order the kernels' grid takes them
    in, so the longest rows start first and the short ones fill the tail."""
    nblk = torch.as_tensor(nblk)
    return torch.argsort(nblk.reshape(-1), descending=True, stable=True).to(torch.int32)


class _RowOrder:
    """``row_order`` and ``row_order_t``: :func:`heavy_first` of ``nblk`` and
    ``nblk_t``, derived on first use and kept with the structure, so the
    order the kernels' grid takes always lists every row once; and
    :meth:`astype`, the structure with its blocks in another dtype."""

    def astype(self, dtype: torch.dtype):
        """This structure with ``data``/``data_t`` in ``dtype``, cast once
        per dtype and kept with it (the float32 blocks stay); the indices,
        counts and row orders are shared."""
        if self.data.dtype == dtype:
            return self
        casts = self.__dict__.setdefault("_casts", {})
        if dtype not in casts:
            cast = dataclasses.replace(self, data=self.data.to(dtype),
                                       data_t=self.data_t.to(dtype))
            cast.__dict__.update(row_order=self.row_order, row_order_t=self.row_order_t)
            casts[dtype] = cast
        return casts[dtype]

    @functools.cached_property
    def row_order(self) -> torch.Tensor:
        return heavy_first(self.nblk)

    @functools.cached_property
    def row_order_t(self) -> torch.Tensor:
        return heavy_first(self.nblk_t)


def _moved(obj, device):
    """A copy of a dataclass of tensors with every tensor field on ``device``."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj) if isinstance(getattr(obj, f.name), torch.Tensor)
    })


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@dataclasses.dataclass
class BlockSparse(_RowOrder):
    """One square support in uniform block-CSR, plus its transpose."""

    data: torch.Tensor  # (R, C, tile, tile) stored blocks (zero-padded rows)
    idx: torch.Tensor  # (R, C) int32 block-column indices
    nblk: torch.Tensor  # (R,) int32: the leading slots of each row that hold a nonzero
    data_t: torch.Tensor  # transpose structure, same layout
    idx_t: torch.Tensor
    nblk_t: torch.Tensor
    n: int  # original (unpadded) dimension
    tile: int

    @property
    def block_rows(self) -> int:
        return self.data.shape[0]

    @property
    def block_cols_per_row(self) -> int:
        return self.data.shape[1]

    @property
    def density(self) -> float:
        """Stored fraction of the dense padded matrix (1.0 = no savings)."""
        return self.block_cols_per_row / self.block_rows

    @property
    def nbytes(self) -> int:
        """Bytes of the blocks and indices (as the JAX package counts them;
        the counts add 4 bytes per block row)."""
        return _nbytes(self.data, self.idx, self.data_t, self.idx_t)

    def to(self, device) -> "BlockSparse":
        return _moved(self, device)


def from_dense(mat, tile: int = TILE) -> BlockSparse:
    """Build a :class:`BlockSparse` (and its transpose structure) on the host."""
    mat = np.asarray(mat, dtype=np.float32)
    if mat.ndim != 2 or mat.shape[0] != mat.shape[1]:
        raise ValueError(f"support must be square (N, N), got {mat.shape}")
    data, idx, nblk = _to_blocks_rect(mat, tile)
    data_t, idx_t, nblk_t = _to_blocks_rect(mat.T, tile)
    return BlockSparse(
        data=torch.from_numpy(data), idx=torch.from_numpy(idx), nblk=torch.from_numpy(nblk),
        data_t=torch.from_numpy(data_t), idx_t=torch.from_numpy(idx_t),
        nblk_t=torch.from_numpy(nblk_t), n=mat.shape[0], tile=tile,
    )


@dataclasses.dataclass
class BlockSparseStack(_RowOrder):
    """K same-shape supports in uniform block-CSR, plus transposes.

    ``data`` ``([M,] K, R, C, tile, tile)``, ``idx`` ``([M,] K, R, C)``,
    ``nblk`` ``([M,] K, R)`` the count of each row's leading nonzero slots,
    ``row_order`` ``(M*K*R,)`` the rows by descending count (derived,
    :func:`heavy_first`); the transpose structure mirrors it for the
    backward pass. The optional
    leading ``M`` axis holds one stack per graph branch at one common ``C``
    (a tiled plan's :meth:`~stmgcn_tpu_torch.ops.tiling.TiledSupports.as_stack`),
    so all branches run in one launch. ``n_rows``/``n_cols`` are the
    original (unpadded) dimensions.
    """

    data: torch.Tensor
    idx: torch.Tensor
    nblk: torch.Tensor
    data_t: torch.Tensor
    idx_t: torch.Tensor
    nblk_t: torch.Tensor
    n_rows: int
    n_cols: int
    tile: int

    @property
    def branches(self) -> Optional[int]:
        """The leading branch count ``M``, or None without that axis."""
        return self.data.shape[0] if self.data.dim() == 6 else None

    @property
    def n_supports(self) -> int:
        return self.data.shape[-5]

    @property
    def density(self) -> float:
        return self.data.shape[-3] / self.data_t.shape[-4]

    @property
    def nbytes(self) -> int:
        return _nbytes(self.data, self.idx, self.data_t, self.idx_t)

    def to(self, device) -> "BlockSparseStack":
        return _moved(self, device)


def stack_from_dense(mats, tile: int = TILE) -> BlockSparseStack:
    """Build a :class:`BlockSparseStack` from dense ``(K, Nr, Nc)`` supports.

    One ``c_max`` across the K supports (max row occupancy) keeps every
    kernel operand shape static.
    """
    mats = np.asarray(mats, dtype=np.float32)
    if mats.ndim != 3:
        raise ValueError(f"supports must be (K, Nr, Nc), got {mats.shape}")
    k = mats.shape[0]
    # one scan per support; c_max from the nonzero maps, assembly once
    fwd_scan = [_scan_blocks(mats[i], tile) for i in range(k)]
    bwd_scan = [_scan_blocks(np.ascontiguousarray(mats[i].T), tile) for i in range(k)]
    c_max = max(max(int(nz.sum(axis=1).max()), 1) for _, nz in fwd_scan)
    c_max_t = max(max(int(nz.sum(axis=1).max()), 1) for _, nz in bwd_scan)
    fwd = [_assemble_blocks(b, nz, c_max, tile) for b, nz in fwd_scan]
    bwd = [_assemble_blocks(b, nz, c_max_t, tile) for b, nz in bwd_scan]
    data, idx, nblk = (torch.from_numpy(np.stack(a)) for a in zip(*fwd))
    data_t, idx_t, nblk_t = (torch.from_numpy(np.stack(a)) for a in zip(*bwd))
    return BlockSparseStack(
        data=data, idx=idx, nblk=nblk, data_t=data_t, idx_t=idx_t, nblk_t=nblk_t,
        n_rows=mats.shape[1], n_cols=mats.shape[2], tile=tile,
    )


def place_supports(supports, device):
    """Any support form on ``device``, once: a dense stack (array or tensor)
    becomes a float32 tensor; block structures and tiled plans move their
    tensors (``.to``); sequences of them stay sequences."""
    if isinstance(supports, (list, tuple)):
        return tuple(place_supports(s, device) for s in supports)
    if isinstance(supports, torch.Tensor):
        return supports.to(device=device, dtype=torch.float32)
    if hasattr(supports, "to"):
        return supports.to(device)
    # host data, placed before any capture: a captured body's tensor `.to`
    # reaches this function only by name (through CitySupports.to)
    dense = np.asarray(supports, np.float32)  # stmgcn: ignore[host-sync-in-jit]
    return torch.as_tensor(dense, device=device)


# -- plain versions -------------------------------------------------------------

def _block_apply(data, idx, src, src_of, n_out):
    """``out[l, r*t + i, f] = sum_c sum_j data[l, r, c, i, j] *
    src[src_of[l], idx[l, r, c]*t + j, f]`` over a flat leading axis ``l``:
    ``data`` ``(L, R, C, t, t)``, ``idx`` ``(L, R, C)``, ``src`` ``(S, N_s,
    F)``, ``src_of`` ``(L,)``. Returns ``(L, n_out, F)``."""
    L, R, _, t, _ = data.shape
    n_src, F = src.shape[-2:]
    rs = -(-n_src // t)
    blocks = torch.nn.functional.pad(src, (0, 0, 0, rs * t - n_src)).reshape(-1, rs, t, F)
    gathered = blocks[src_of[:, None, None], idx.long()]  # (L, R, C, t, F)
    if data.dtype != torch.float32:  # bf16: exact products, float32 sums
        data, gathered = data.float(), gathered.float()
    out = torch.einsum("lrcij,lrcjf->lrif", data, gathered)
    return out.reshape(L, R * t, F)[:, :n_out]


def _check_dtypes(name, data, src, *, cotangent: bool) -> None:
    """Blocks and signal (or cotangent) as the JAX package pairs them: both
    float32 or both bfloat16; anything else raises."""
    if data.dtype == src.dtype and data.dtype in (torch.float32, torch.bfloat16):
        return
    raise TypeError(f"{name}: blocks {data.dtype} with a {src.dtype} "
                    f"{'cotangent' if cotangent else 'signal'} (both float32 or both "
                    "bfloat16)")


def _stack_plain(data, idx, x, n_rows: int) -> torch.Tensor:
    """B3's plain version over the structure's tensors: ``data`` ``([M,] K,
    R, C, t, t)``, ``idx`` ``([M,] K, R, C)``."""
    lead = tuple(idx.shape[:-2])
    L, K = math.prod(lead), lead[-1]
    data = data.reshape((L,) + tuple(data.shape[-4:]))
    idx = idx.reshape((L,) + tuple(idx.shape[-2:]))
    arange = torch.arange(L, device=x.device)
    src, src_of = (x[None], arange * 0) if x.dim() == 2 else (x, arange // K)
    out = _block_apply(data, idx, src, src_of, n_rows)
    return out.reshape(lead + out.shape[1:])


def _stack_bwd_plain(data_t, idx_t, g, n_cols: int, shared: bool) -> torch.Tensor:
    """B4's plain version over the transposed structure's tensors."""
    lead = tuple(idx_t.shape[:-2])
    L = math.prod(lead)
    data_t = data_t.reshape((L,) + tuple(data_t.shape[-4:]))
    idx_t = idx_t.reshape((L,) + tuple(idx_t.shape[-2:]))
    src = g.reshape((L,) + tuple(g.shape[-2:]))
    dx = _block_apply(data_t, idx_t, src, torch.arange(L, device=g.device), n_cols)
    if shared or len(lead) == 1:
        return dx.sum(dim=0)
    return dx.reshape(lead + dx.shape[1:]).sum(dim=1)


def _spmm_plain(data, idx, x, n: int) -> torch.Tensor:
    """B5's plain version over one structure's (or its transpose's) tensors."""
    return _block_apply(data[None], idx[None], x[None],
                        torch.zeros(1, dtype=torch.long, device=x.device), n)[0]


def spmm_stack_reference(bss: BlockSparseStack, x: torch.Tensor) -> torch.Tensor:
    """Plain version of B3: the gathered-tiles forward. ``x`` ``(N_c, F)``
    (shared by every support and branch) or ``(M, N_c, F)`` (per branch);
    returns ``([M,] K, n_rows, F)``."""
    _check_dtypes("spmm_stack", bss.data, x, cotangent=False)
    return _stack_plain(bss.data, bss.idx, x, bss.n_rows)


def spmm_stack_bwd_reference(bss: BlockSparseStack, g: torch.Tensor, *,
                             shared: bool) -> torch.Tensor:
    """Plain version of B4, the prepared backward: ``dx = sum_k A_k^T @
    g_k`` over the pre-transposed blocks (no scatter), summed over the
    branches too when ``x`` was ``shared``. ``g`` ``([M,] K, n_rows, F)``;
    returns ``(N_c, F)``, or ``(M, N_c, F)`` for a per-branch ``x``."""
    _check_dtypes("spmm_stack_bwd", bss.data_t, g, cotangent=True)
    return _stack_bwd_plain(bss.data_t, bss.idx_t, g, bss.n_cols, shared)


def spmm_reference(bs: BlockSparse, x: torch.Tensor, *, transpose: bool = False) -> torch.Tensor:
    """Plain version of B5: ``A @ x`` (``A^T @ x`` with ``transpose``) for
    ``x`` ``(N, F)``."""
    data, idx = (bs.data_t, bs.idx_t) if transpose else (bs.data, bs.idx)
    _check_dtypes("spmm", data, x, cotangent=transpose)
    return _spmm_plain(data, idx, x, bs.n)


def spmm_dense_reference(mat, x) -> torch.Tensor:
    """Dense matmul equivalent, for cross-checking the kernels."""
    return torch.as_tensor(mat) @ torch.as_tensor(x)


# -- the kernels ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def kernel_library():
    """The three built entry points ``(fwd, bwd, spmm)`` and the build
    record; built on first call."""
    lib, info = load_library([SOURCE], "spmm_stack")
    fns = (lib.stmgcn_spmm_stack_fwd, lib.stmgcn_spmm_stack_bwd, lib.stmgcn_spmm)
    for fn in fns:
        # data, idx, nblk, order, src, out, part; L, S, R, C, tile, F,
        # n_out_rows, n_src_rows, src_div; src_stride; vec; bf16; stream
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fns, info


def kernel_plan(tile: int, F: int, dtype=torch.float32) -> dict:
    """The plan a launch at ``(tile, F)`` and storage ``dtype`` takes, as
    the built library reports it: column tile, ring stages, dynamic shared
    memory (bytes) per CTA and the rows and columns one warp owns (builds it
    on first call)."""
    lib, _ = load_library([SOURCE], "spmm_stack")
    info = (ctypes.c_int * 5)()
    if lib.stmgcn_spmm_plan(tile, F, int(dtype == torch.bfloat16), info) != 0:
        raise ValueError(f"the CUDA kernel takes tile in {KERNEL_TILES}, got {tile}")
    return dict(zip(("column_tile", "stages", "smem_bytes", "warp_rows", "warp_cols"), info))


#: the kernels by role, as :func:`kernel_attributes` and the library take them
KERNEL_ROLES = ("spmm_stack_fwd_kernel", "spmm_stack_bwd_kernel", "spmm_kernel")


def kernel_attributes(role: int, tile: int, F: int, dtype=torch.float32) -> dict:
    """``cudaFuncGetAttributes`` of the instance of kernel ``role`` (an
    index of :data:`KERNEL_ROLES`) a launch at ``(tile, F)`` and storage
    ``dtype`` takes: registers, local (spilled) bytes per thread, max
    threads per block, static shared bytes (builds the library on first
    call; needs the card)."""
    lib, _ = load_library([SOURCE], "spmm_stack")
    info = (ctypes.c_int * 4)()
    err = lib.stmgcn_spmm_attrs(role, tile, F, int(dtype == torch.bfloat16), info)
    if err != 0:
        raise RuntimeError(f"{KERNEL_ROLES[role]} (tile {tile}, F {F}): "
                           f"cudaFuncGetAttributes failed with cudaError {err}")
    return dict(zip(("registers", "local_bytes", "max_threads", "static_smem"), info))


def _launch(name, role, data, idx, nblk, order, src, out, *, S, tile, n_src_rows, src_div=1,
            src_stride=0):
    """One kernel launch on the current stream: one CTA per block row of
    ``data`` ``(L, R, C, t, t)`` (``nblk`` ``(L, R)``), taken in ``order``
    (a permutation of the ``L * R`` flat rows), row ``l`` adding source
    ``l % S`` of output group ``l // S`` of ``out`` ``(L // S, n_out_rows,
    F)``. With ``S`` > 1 each source's partial goes to scratch (allocated
    here) and the kernel library sums them in order."""
    if tile not in KERNEL_TILES:
        raise ValueError(f"{name}: the CUDA kernel takes tile in {KERNEL_TILES}, got {tile}")
    R, C = idx.shape[-2:]
    L = idx.numel() // (R * C)
    F, n_out_rows = out.shape[-1], out.shape[-2]
    if F == 0 or n_out_rows == 0 or n_src_rows == 0:
        raise ValueError(f"{name}: empty product (F={F}, rows={n_out_rows}, {n_src_rows})")
    if nblk.numel() != L * R or order.numel() != L * R or out.numel() * S != L * n_out_rows * F:
        raise ValueError(f"{name}: counts {tuple(nblk.shape)} or output {tuple(out.shape)} "
                         f"do not match indices {tuple(idx.shape)} with {S} sources per output")
    if data.data_ptr() % 16:  # blocks are read 16 bytes at a time
        raise ValueError(f"{name}: the block data must start on a 16-byte boundary")
    # signal rows are copied 16 bytes at a time where each starts on a 16-byte boundary
    vec = int(F % (16 // src.element_size()) == 0 and src.data_ptr() % 16 == 0)
    part = (torch.empty((S,) + tuple(out.shape), device=out.device, dtype=torch.float32)
            if S > 1 else None)
    fn = kernel_library()[0][role]
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(data.data_ptr(), idx.data_ptr(), nblk.data_ptr(), order.data_ptr(),
                 src.data_ptr(), out.data_ptr(),
                 None if part is None else part.data_ptr(), L, S, R, C, tile, F, n_out_rows,
                 n_src_rows, src_div, src_stride, vec, int(data.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")


#: B3, B4 and B5 as PyTorch operators (``torch.ops.stmgcn.spmm_stack_fwd``,
#: ``spmm_stack_bwd``, ``spmm``) beside B1 and B2 (``ops/fused_lstm.py``):
#: the structure's tensors, the signal (or cotangent) and the structure's
#: sizes. The dispatcher takes the CPU implementation (the plain version)
#: for CPU tensors and the CUDA one (the launch) for CUDA tensors, and a
#: trace takes the fake one (the output's shape and dtype): one node a
#: launch, nothing run (``analysis/programs.py``)
_LIBRARY = torch.library.Library("stmgcn", "FRAGMENT")
_LIBRARY.define("spmm_stack_fwd(Tensor data, Tensor idx, Tensor nblk, Tensor order, Tensor x, "
                "int n_rows, int n_cols, int tile) -> Tensor")
_LIBRARY.define("spmm_stack_bwd(Tensor data_t, Tensor idx_t, Tensor nblk_t, Tensor order_t, "
                "Tensor g, int n_rows, int n_cols, int tile, bool shared) -> Tensor")
_LIBRARY.define("spmm(Tensor data, Tensor idx, Tensor nblk, Tensor order, Tensor x, int n, "
                "int tile) -> Tensor")


def _stack_fwd_cpu(data, idx, nblk, order, x, n_rows, n_cols, tile):
    return _stack_plain(data, idx, x, n_rows).contiguous()  # the launch's layout


def _stack_fwd_fake(data, idx, nblk, order, x, n_rows, n_cols, tile):
    return x.new_empty(tuple(idx.shape[:-2]) + (n_rows, x.shape[-1]), dtype=torch.float32)


def _stack_fwd_cuda(data, idx, nblk, order, x, n_rows, n_cols, tile):
    """B3's launch, counted in ``spmm_stack.launches`` (and
    ``launches_shared`` for a shared signal); no fallback."""
    if not on_cuda("spmm_stack", (data, x), (idx, nblk, order)):
        raise ValueError("spmm_stack: operands must all be on one CUDA device")
    lead = tuple(idx.shape[:-2])
    out = torch.empty(lead + (n_rows, x.shape[-1]), device=x.device, dtype=torch.float32)
    _launch("spmm_stack", 0, data, idx, nblk, order, x, out, S=1, tile=tile,
            n_src_rows=n_cols, src_div=lead[-1],
            src_stride=0 if x.dim() == 2 else n_cols * x.shape[-1])
    counters.bump(spmm_stack)
    if x.dim() == 2:
        counters.bump(spmm_stack, "launches_shared")
    return out


def _stack_bwd_cpu(data_t, idx_t, nblk_t, order_t, g, n_rows, n_cols, tile, shared):
    return _stack_bwd_plain(data_t, idx_t, g, n_cols, shared).contiguous()


def _stack_bwd_shape(idx_t, g, n_cols, shared) -> tuple:
    """B4's output shape and its output groups ``O`` (branches kept apart)."""
    lead = tuple(idx_t.shape[:-2])
    per_branch = len(lead) == 2 and not shared
    return ((lead[0],) if per_branch else ()) + (n_cols, g.shape[-1]), (
        lead[0] if per_branch else 1)


def _stack_bwd_fake(data_t, idx_t, nblk_t, order_t, g, n_rows, n_cols, tile, shared):
    return g.new_empty(_stack_bwd_shape(idx_t, g, n_cols, shared)[0], dtype=torch.float32)


def _stack_bwd_cuda(data_t, idx_t, nblk_t, order_t, g, n_rows, n_cols, tile, shared):
    """B4's launch, its partials summed over k (and branches) in order by
    the library's ``reduce_parts``, counted in ``spmm_stack_bwd.launches``;
    no fallback."""
    if not on_cuda("spmm_stack_bwd", (data_t, g), (idx_t, nblk_t, order_t)):
        raise ValueError("spmm_stack_bwd: operands must all be on one CUDA device")
    shape, O = _stack_bwd_shape(idx_t, g, n_cols, shared)
    L = math.prod(idx_t.shape[:-2])
    dx = torch.empty(shape, device=g.device, dtype=torch.float32)
    _launch("spmm_stack_bwd", 1, data_t, idx_t, nblk_t, order_t, g, dx, S=L // O,
            tile=tile, n_src_rows=n_rows, src_stride=n_rows * g.shape[-1])
    counters.bump(spmm_stack_bwd)
    return dx


def _spmm_cpu(data, idx, nblk, order, x, n, tile):
    return _spmm_plain(data, idx, x, n).contiguous()


def _spmm_fake(data, idx, nblk, order, x, n, tile):
    return x.new_empty((n, x.shape[-1]), dtype=torch.float32)


def _spmm_cuda(data, idx, nblk, order, x, n, tile):
    """B5's launch, counted in ``spmm.launches``; no fallback."""
    if not on_cuda("spmm", (data, x), (idx, nblk, order)):
        raise ValueError("spmm: operands must all be on one CUDA device")
    out = torch.empty((n, x.shape[-1]), device=x.device, dtype=torch.float32)
    _launch("spmm", 2, data, idx, nblk, order, x, out, S=1, tile=tile, n_src_rows=n)
    counters.bump(spmm)
    return out


for _name, _cpu, _cuda, _fake in (
        ("spmm_stack_fwd", _stack_fwd_cpu, _stack_fwd_cuda, _stack_fwd_fake),
        ("spmm_stack_bwd", _stack_bwd_cpu, _stack_bwd_cuda, _stack_bwd_fake),
        ("spmm", _spmm_cpu, _spmm_cuda, _spmm_fake)):
    _LIBRARY.impl(_name, _cpu, "CPU")
    _LIBRARY.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"stmgcn::{_name}", _fake, lib=_LIBRARY)


def stack_forward(bss: BlockSparseStack, x: torch.Tensor) -> torch.Tensor:
    """B3, or its plain version for CPU tensors: ``([M,] K, n_rows, F)``
    float32 from a shared ``(N_c, F)`` or per-branch ``(M, N_c, F)`` ``x``,
    in float32 or (blocks and signal) bfloat16; the operator
    ``torch.ops.stmgcn.spmm_stack_fwd``."""
    _check_dtypes("spmm_stack", bss.data, x, cotangent=False)
    on_cuda("spmm_stack", (bss.data, x), (bss.idx, bss.nblk, bss.row_order))
    return torch.ops.stmgcn.spmm_stack_fwd(bss.data, bss.idx, bss.nblk, bss.row_order, x,
                                           bss.n_rows, bss.n_cols, bss.tile)


def spmm_stack_bwd(bss: BlockSparseStack, g: torch.Tensor, *, shared: bool) -> torch.Tensor:
    """B4: ``dx = sum_k A_k^T @ g_k`` from :func:`spmm_stack`'s cotangent
    ``g`` ``([M,] K, n_rows, F)`` — ``(N_c, F)`` when ``x`` was ``shared``
    by the branches (or the stack has none), else ``(M, N_c, F)``; the
    operator ``torch.ops.stmgcn.spmm_stack_bwd``. CPU tensors take
    :func:`spmm_stack_bwd_reference`'s arithmetic. Each CTA sums one
    support's block row over its real slots into a partial, and the
    partials are added over k (and branches) in order, so the result is
    bitwise repeatable."""
    _check_dtypes("spmm_stack_bwd", bss.data_t, g, cotangent=True)
    on_cuda("spmm_stack_bwd", (bss.data_t, g), (bss.idx_t, bss.nblk_t, bss.row_order_t))
    return torch.ops.stmgcn.spmm_stack_bwd(bss.data_t, bss.idx_t, bss.nblk_t, bss.row_order_t,
                                           g, bss.n_rows, bss.n_cols, bss.tile, bool(shared))


def block_spmm(bs: BlockSparse, x: torch.Tensor, *, transpose: bool = False) -> torch.Tensor:
    """B5, or :func:`spmm_reference`'s arithmetic for CPU tensors: ``A @ x``
    (``A^T @ x`` with ``transpose``) for ``x`` ``(N, F)``; the operator
    ``torch.ops.stmgcn.spmm``."""
    data, idx, nblk, order = ((bs.data_t, bs.idx_t, bs.nblk_t, bs.row_order_t) if transpose
                              else (bs.data, bs.idx, bs.nblk, bs.row_order))
    _check_dtypes("spmm", data, x, cotangent=transpose)
    on_cuda("spmm", (data, x), (idx, nblk, order))
    return torch.ops.stmgcn.spmm(data, idx, nblk, order, x, bs.n, bs.tile)


# -- autograd ---------------------------------------------------------------------

class BlockCSRApply(torch.autograd.Function):
    """``forward(x)`` then, on ``.backward()``, ``backward(g)`` — two
    callables over a block structure that is a constant: the gradient goes
    to ``x`` only, in ``x``'s dtype, and only when ``x`` requires it; the
    cotangent is cast to ``x``'s dtype (the blocks') before the backward,
    so both devices take the same product. Every kernel route goes through
    here, so a kernel's history-free output never cuts the graph."""

    @staticmethod
    def forward(ctx, x, forward, backward):
        ctx.backward_fn, ctx.x_dtype = backward, x.dtype
        return forward(x)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        g = g.to(ctx.x_dtype).contiguous()
        return ctx.backward_fn(g).to(ctx.x_dtype), None, None


def spmm_stack(bss: BlockSparseStack, x: torch.Tensor) -> torch.Tensor:
    """``out[k] = A_k @ x`` for all K supports (and all M branches) in one
    launch of B3; the gradient is one launch of B4.

    ``x`` is ``(n_cols, F)``, shared by every support and branch, or ``(M,
    n_cols, F)`` with one signal per branch of a branch-stacked ``bss``,
    in the blocks' dtype (float32, or bfloat16 for :meth:`astype`'s
    structure); returns ``([M,] K, n_rows, F)`` in float32. Gradients flow to ``x``
    only (the supports are offline constants). CPU tensors take the plain
    versions through the same autograd path.
    """
    if x.dim() not in (2, 3) or (x.dim() == 3 and bss.branches != x.shape[0]):
        raise ValueError(f"x must be (N, M), got {tuple(x.shape)}")
    if x.shape[-2] != bss.n_cols:
        raise ValueError(f"x has {x.shape[-2]} rows, supports expect {bss.n_cols}")
    shared = x.dim() == 2
    return BlockCSRApply.apply(
        x.contiguous(), functools.partial(stack_forward, bss),
        functools.partial(spmm_stack_bwd, bss, shared=shared))


def spmm(bs: BlockSparse, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for one block-sparse support, ``x`` ``(N, F)``: one launch
    of B5, whose gradient ``A^T @ g`` is B5 again on the transposed blocks;
    float32 out (blocks and signal float32, or both bfloat16).

    .. warning:: Gradients flow only to ``x``. The support's blocks get no
       gradient by design (supports are offline constants built from the
       adjacency); trainable supports would need a ``dA = g @ x^T`` block
       gather first.
    """
    if x.dim() != 2:
        raise ValueError(f"x must be (N, M), got {tuple(x.shape)}")
    if x.shape[0] != bs.n:
        raise ValueError(f"x has {x.shape[0]} rows, support expects {bs.n}")
    return BlockCSRApply.apply(
        x.contiguous(), functools.partial(block_spmm, bs),
        functools.partial(block_spmm, bs, transpose=True))


#: kernel launches since the last reset (set to 0 to start a count);
#: ``launches_shared`` counts B3's launches on a signal shared by every
#: support and branch (a 2-D ``x``), the rest had one signal per branch
spmm_stack.launches = 0
spmm_stack.launches_shared = 0
spmm_stack_bwd.launches = 0
spmm.launches = 0
