"""Region-sharded banded supports and their product with a ring halo
exchange.

Counterpart of ``stmgcn_tpu/parallel/banded.py``. For banded graphs (grid
cities: every support nonzero within index distance ``w``), the dense
region plan all-gathers the whole node axis of the signal on every rank.
The halo plan is cheaper:

1. on the host, each shard keeps only its **strip** of every support: its
   ``n_local`` rows restricted to the ``n_local + 2w`` columns they can
   touch (:func:`strip_decompose`);
2. at apply time each rank exchanges just ``w`` boundary rows with its
   ring neighbours (:func:`~stmgcn_tpu_torch.parallel.halo.halo_exchange`)
   and contracts its strip locally (:func:`sharded_banded_apply`): ``O(w)``
   rows on the wire per rank instead of ``O(N)``.

The numpy functions (:func:`bandwidth`, :func:`strip_decompose`,
:func:`banded_decompose`, :func:`branch_stack`) are the port's own copies
of the JAX package's and give the same arrays. The strip product is an einsum, as in the JAX
package, where it runs outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stmgcn_tpu_torch.parallel.halo import halo_exchange

__all__ = ["BandedSupports", "banded_decompose", "bandwidth", "branch_stack",
           "sharded_banded_apply", "strip_decompose"]


@dataclasses.dataclass
class BandedSupports:
    """Supports in strip form, the banded counterpart of a dense ``(K, N,
    N)`` stack: ``strips`` ``(n_shards, K, n_local, n_local + 2*halo)``
    (:func:`strip_decompose`), ``halo`` and the global node count ``n``.
    A rank of a region mesh holds its one shard (``n_shards`` 1,
    :meth:`shard`); ``n`` stays the global count. The branch-stacked form
    (:func:`branch_stack`) leads with a graph axis, ``(M, n_shards, K,
    n_local, n_local + 2*halo)`` at one common halo; shape properties index
    from the end, so both forms answer."""

    strips: object  # numpy array or tensor
    halo: int
    n: int

    @property
    def n_supports(self) -> int:
        return self.strips.shape[-3]

    @property
    def n_local(self) -> int:
        return self.strips.shape[-2]

    @property
    def n_shards(self) -> int:
        return self.strips.shape[-4]

    @property
    def branch_stacked(self) -> bool:
        return self.strips.ndim == 5

    def shard(self, index: int) -> "BandedSupports":
        """Shard ``index``'s strip alone (what region rank ``index`` holds),
        of every branch of a branch-stacked form."""
        if self.branch_stacked:
            return BandedSupports(self.strips[:, index:index + 1], self.halo, self.n)
        return BandedSupports(self.strips[index:index + 1], self.halo, self.n)

    def branch(self, m) -> "BandedSupports":
        """Branch ``m`` of a branch-stacked form (an int: its one-branch
        strips; a slice: those branches, still stacked)."""
        if not self.branch_stacked:
            raise ValueError("a one-branch BandedSupports has no branch axis")
        return BandedSupports(self.strips[m], self.halo, self.n)

    def to(self, device) -> "BandedSupports":
        strips = torch.as_tensor(np.asarray(self.strips, np.float32)
                                 if not isinstance(self.strips, torch.Tensor) else self.strips)
        return BandedSupports(strips.to(device=device, dtype=torch.float32), self.halo, self.n)


def bandwidth(mat) -> int:
    """Largest ``|i - j|`` with a nonzero entry (0 for a diagonal or empty
    matrix)."""
    rows, cols = np.nonzero(np.asarray(mat))
    if rows.size == 0:
        return 0
    return int(np.abs(rows - cols).max())


def strip_decompose(supports, n_shards: int, halo: int) -> np.ndarray:
    """Split ``(K, N, N)`` supports into per-shard row strips:
    ``(n_shards, K, n_local, n_local + 2*halo)``, strip ``s`` holding rows
    ``[s*n_local, (s+1)*n_local)`` restricted to columns ``[s*n_local -
    halo, (s+1)*n_local + halo)``, zero-padded at the boundaries. Raises if
    a support's bandwidth exceeds ``halo`` (the exchange would drop
    neighbours), if ``halo`` exceeds the shard size, or if ``N`` does not
    divide into ``n_shards``."""
    supports = np.asarray(supports, dtype=np.float32)
    k, n, _ = supports.shape
    if n % n_shards:
        raise ValueError(f"N={n} not divisible by {n_shards} shards")
    n_local = n // n_shards
    if halo > n_local:
        raise ValueError(f"halo {halo} exceeds shard size {n_local}")
    for ki in range(k):
        bw = bandwidth(supports[ki])
        if bw > halo:
            raise ValueError(f"support {ki} has bandwidth {bw} > halo {halo}; boundary "
                             "neighbors would be dropped")
    padded = np.zeros((k, n, n + 2 * halo), dtype=np.float32)
    padded[:, :, halo:halo + n] = supports
    strips = np.empty((n_shards, k, n_local, n_local + 2 * halo), dtype=np.float32)
    for s in range(n_shards):
        lo = s * n_local
        strips[s] = padded[:, lo:lo + n_local, lo:lo + n_local + 2 * halo]
    return strips


def branch_stack(per_branch_supports, n_shards: int, halo: int | None = None) -> BandedSupports:
    """M branches' dense ``(K, N, N)`` supports as ONE branch-stacked
    :class:`BandedSupports` at their common halo (the largest bandwidth
    over the branches' supports unless ``halo`` is given;
    :func:`strip_decompose` still checks it): the form a ``branch`` mesh
    axis cuts, each branch group then running its own region ring. The
    narrower branches exchange a few more rows than they need."""
    mats = [np.asarray(s, dtype=np.float32) for s in per_branch_supports]
    if halo is None:
        halo = max(max(bandwidth(m[k]) for k in range(m.shape[0])) for m in mats)
    stacked = np.stack([strip_decompose(m, n_shards, halo) for m in mats])
    return BandedSupports(stacked, halo, mats[0].shape[1])


def banded_decompose(supports, n_shards: int, halo: int | None = None) -> BandedSupports:
    """``(K, N, N)`` dense supports -> :class:`BandedSupports`; ``halo``
    None takes the tightest, the largest bandwidth of the K supports."""
    supports = np.asarray(supports, dtype=np.float32)
    if halo is None:
        halo = max(bandwidth(supports[k]) for k in range(supports.shape[0]))
    return BandedSupports(strip_decompose(supports, n_shards, halo), halo, supports.shape[1])


def sharded_banded_apply(strip: torch.Tensor, x: torch.Tensor, halo: int, mesh,
                         axis: str = "region") -> torch.Tensor:
    """``out[k, b, i, f] = sum_j A_k[i, j] x[b, j, f]`` over this rank's
    node rows: ``strip`` ``(K, n_local, n_local + 2*halo)`` (the rank's
    shard of :func:`strip_decompose`), ``x`` ``(B, n_local, F)`` its node
    rows of the signal; returns ``(K, B, n_local, F)``, the product summed
    in float32 (a bf16 ``x`` against the float32 strip, as the JAX
    einsum promotes them). Every rank of the region line calls it
    together; ``mesh`` None is one device (zero halos)."""
    xp = x.transpose(0, 1)  # (n_local, B, F): node rows lead for the exchange
    if halo > 0:
        xp = halo_exchange(xp, halo, mesh, axis)
    return torch.einsum("knm,mbf->kbnf", strip.float(), xp.float())
