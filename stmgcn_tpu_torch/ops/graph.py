"""Offline graph-support construction for spectral / diffusion graph convolution.

Counterpart of the original ST-MGCN code's adjacency preprocessor
(``GCN.py:50-135``, ``Adj_Preprocessor``). This stage runs
once per graph on the host (numpy, float64 internally for eigen-stability) and
produces a dense stack of ``(n_supports, N, N)`` support matrices that are
then placed on device once — the same host-compute/one-upload split as the
reference (``Main.py:48-55``).

Supported kernel families (parity with ``GCN.py:65-92``):

- ``chebyshev``   — Defferrard NIPS'16. ``K+1`` supports: Chebyshev
  polynomials of the rescaled normalized Laplacian.
- ``localpool``   — Kipf ICLR'17. One support: ``I + D^-1/2 A D^-1/2``.
- ``random_walk_diffusion`` — Li ICLR'18 (DCRNN). Diffusion steps on the
  random-walk transition matrix. The reference declares ``2K+1`` supports in
  the model (``STMGCN.py:87-88``) but its preprocessor only emits the
  forward ``K+1`` series because the bidirectional branch is commented out
  (``GCN.py:82-90``) — so diffusion kernels crash the reference's support
  assert (``GCN.py:31``). Here the bidirectional series is implemented and is
  the default, making the declared count and the built count agree
  (documented deviation; ``bidirectional=False`` recovers the forward-only
  ``K+1`` series).

Deviations from the reference, on purpose:

- Isolated nodes (zero degree) produce ``inf`` in the reference's
  ``D^-1/2`` (``GCN.py:109``) and propagate NaN; here the inverse degree is
  zeroed, matching what the reference already does for random-walk
  normalization (``GCN.py:102``).
- ``torch.eig`` (``GCN.py:117``) becomes ``numpy.linalg.eigvalsh`` for
  symmetric Laplacians, general ``eigvals`` otherwise, and a matrix-free
  power iteration above ``POWER_ITERATION_THRESHOLD`` nodes so the scaled
  50x50-grid (N=2500) config never pays a dense O(N^3) eigendecomposition.
  The reference's fall-back to ``lambda_max = 2`` on non-convergence
  (``GCN.py:119-121``) is preserved.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "SupportConfig",
    "build_supports",
    "chebyshev_polynomials",
    "chebyshev_supports",
    "diffusion_supports",
    "localpool_supports",
    "max_eigenvalue",
    "normalized_laplacian",
    "random_walk_normalize",
    "rescale_laplacian",
    "support_count",
    "symmetric_normalize",
]

KERNEL_TYPES = ("chebyshev", "localpool", "random_walk_diffusion")

#: Above this node count, ``max_eigenvalue(method="auto")`` switches from a
#: dense eigendecomposition to power iteration.
POWER_ITERATION_THRESHOLD = 512


def _as_matrix(adj) -> np.ndarray:
    a = np.asarray(adj, dtype=np.float64)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"adjacency must be a square (N, N) matrix, got {a.shape}")
    return a


def symmetric_normalize(adj) -> np.ndarray:
    """``D^-1/2 A D^-1/2`` (reference: ``GCN.py:107-111``), zeroing isolated rows."""
    a = _as_matrix(adj)
    deg = a.sum(axis=1)
    with np.errstate(divide="ignore"):
        d_inv_sqrt = np.power(deg, -0.5)
    d_inv_sqrt[~np.isfinite(d_inv_sqrt)] = 0.0
    return (a * d_inv_sqrt[:, None]) * d_inv_sqrt[None, :]


def random_walk_normalize(adj) -> np.ndarray:
    """Row-stochastic ``D^-1 A`` (reference: ``GCN.py:99-105``)."""
    a = _as_matrix(adj)
    deg = a.sum(axis=1)
    with np.errstate(divide="ignore"):
        d_inv = np.power(deg, -1.0)
    d_inv[~np.isfinite(d_inv)] = 0.0
    return a * d_inv[:, None]


def normalized_laplacian(adj) -> np.ndarray:
    """``L = I - D^-1/2 A D^-1/2`` (reference: ``GCN.py:73``)."""
    a_norm = symmetric_normalize(adj)
    return np.eye(a_norm.shape[0]) - a_norm


def _power_iteration_lambda_max(mat: np.ndarray) -> float:
    """Largest-magnitude eigenvalue, matrix-free.

    Uses scipy's Lanczos/Arnoldi when available (robust to the
    nearly-degenerate top eigenpairs common in normalized Laplacians of dense
    graphs, where plain power iteration stalls); falls back to plain power
    iteration otherwise.
    """
    if mat.shape[0] > 2:  # ARPACK needs k < N-1; tiny systems go dense anyway
        try:
            from scipy.sparse.linalg import eigs, eigsh

            if np.allclose(mat, mat.T, atol=1e-10):
                return float(eigsh(mat, k=1, which="LA", return_eigenvectors=False)[0])
            return float(eigs(mat, k=1, which="LR", return_eigenvectors=False)[0].real)
        except ImportError:
            pass
    rng = np.random.default_rng(0)
    v = rng.standard_normal(mat.shape[0])
    v /= np.linalg.norm(v)
    lam = 0.0
    w = mat @ v
    for _ in range(5000):
        nw = np.linalg.norm(w)
        if nw == 0.0:
            return 0.0
        v = w / nw
        w = mat @ v
        lam_new = float(v @ w)
        if abs(lam_new - lam) < 1e-9 * max(1.0, abs(lam_new)):
            return lam_new
        lam = lam_new
    return lam


def max_eigenvalue(mat, fallback: float = 2.0, method: str = "auto") -> float:
    """Largest real eigenvalue of ``mat``; ``fallback`` on failure.

    Reference: ``GCN.py:113-121`` (``torch.eig`` real parts, ``lambda_max=2``
    on non-convergence). ``method``: ``"dense"``, ``"power"``, or ``"auto"``
    (power iteration above :data:`POWER_ITERATION_THRESHOLD` nodes).
    """
    m = _as_matrix(mat)
    if method not in ("auto", "dense", "power"):
        raise ValueError(f"unknown method {method!r}")
    if method == "auto":
        method = "power" if m.shape[0] > POWER_ITERATION_THRESHOLD else "dense"
    if m.shape[0] <= 2:
        # Power iteration cannot separate equal-magnitude opposite-sign
        # eigenvalues (e.g. [[0,1],[1,0]]); tiny systems are free to solve
        # densely.
        method = "dense"
    # Broad except on purpose: besides LinAlgError, scipy's ARPACK raises its
    # own no-convergence error type; all failure modes take the reference's
    # lambda_max=2 fallback path (GCN.py:119-121).
    try:
        if method == "power":
            return float(_power_iteration_lambda_max(m))
        if np.allclose(m, m.T, atol=1e-10):
            return float(np.linalg.eigvalsh(m).max())
        return float(np.linalg.eigvals(m).real.max())
    except Exception:
        return float(fallback)


def rescale_laplacian(lap, lambda_max: float | None = None) -> np.ndarray:
    """``2 L / lambda_max - I``, mapping the spectrum into ``[-1, 1]``.

    Reference: ``GCN.py:113-123``. If ``lambda_max`` is None it is computed
    via :func:`max_eigenvalue` (with the same ``lambda_max=2`` fallback).
    """
    lap = _as_matrix(lap)
    if lambda_max is None:
        lambda_max = max_eigenvalue(lap)
    return (2.0 / lambda_max) * lap - np.eye(lap.shape[0])


def chebyshev_polynomials(x, K: int) -> np.ndarray:
    """Stack ``[T_0, ..., T_K]`` of Chebyshev polynomials of ``x``.

    ``T_0 = I``, ``T_1 = x``, ``T_k = 2 x T_{k-1} - T_{k-2}`` — the same
    recursion (including the left-multiplication order) as ``GCN.py:125-135``.
    Returns ``(K+1, N, N)``.
    """
    x = _as_matrix(x)
    if K < 0:
        raise ValueError("K must be >= 0")
    n = x.shape[0]
    out = [np.eye(n)]
    if K >= 1:
        out.append(x)
    for k in range(2, K + 1):
        out.append(2.0 * (x @ out[k - 1]) - out[k - 2])
    return np.stack(out, axis=0)


def chebyshev_supports(adj, K: int, lambda_max: float | None = None) -> np.ndarray:
    """``(K+1, N, N)`` Chebyshev supports of the rescaled normalized Laplacian.

    Reference pipeline: ``GCN.py:66,73-75`` (symmetric normalize -> ``I - A``
    -> eigen-rescale -> Chebyshev recursion -> stack at ``GCN.py:95``).
    """
    lap = normalized_laplacian(adj)
    lap_rescaled = rescale_laplacian(lap, lambda_max=lambda_max)
    return chebyshev_polynomials(lap_rescaled, K)


def localpool_supports(adj) -> np.ndarray:
    """``(1, N, N)`` Kipf local-pooling support ``I + D^-1/2 A D^-1/2``.

    Reference: ``GCN.py:68-70``.
    """
    a_norm = symmetric_normalize(adj)
    return (np.eye(a_norm.shape[0]) + a_norm)[None]


def diffusion_supports(adj, K: int, bidirectional: bool = True) -> np.ndarray:
    """Random-walk diffusion supports (DCRNN).

    Forward series: Chebyshev-style recursion on ``P_fwd^T`` where
    ``P_fwd = D^-1 A`` (reference: ``GCN.py:80-81``). With
    ``bidirectional=True`` (default) the backward series on ``(D'^-1 A^T)^T``
    is appended, dropping its order-0 identity — yielding ``2K+1`` supports,
    the count the reference model declares (``STMGCN.py:88``) but never
    builds because its bidirectional branch is commented out
    (``GCN.py:82-90``).
    """
    a = _as_matrix(adj)
    fwd = chebyshev_polynomials(random_walk_normalize(a).T, K)
    if not bidirectional:
        return fwd
    bwd = chebyshev_polynomials(random_walk_normalize(a.T).T, K)
    return np.concatenate([fwd, bwd[1:]], axis=0)


def support_count(kernel_type: str, K: int, bidirectional: bool = True) -> int:
    """Number of supports a kernel config produces.

    Mirrors the reference's ``ST_MGCN.get_support_K`` (``STMGCN.py:80-91``)
    with the diffusion row made consistent with what is actually built (see
    :func:`diffusion_supports`).
    """
    if kernel_type == "localpool":
        if K != 1:
            raise ValueError("localpool requires K == 1")  # STMGCN.py:83
        return 1
    if kernel_type == "chebyshev":
        return K + 1
    if kernel_type == "random_walk_diffusion":
        return 2 * K + 1 if bidirectional else K + 1
    raise ValueError(f"kernel_type must be one of {KERNEL_TYPES}, got {kernel_type!r}")


def build_supports(
    adj,
    kernel_type: str = "chebyshev",
    K: int = 2,
    *,
    bidirectional: bool = True,
    lambda_max: float | None = None,
    dtype=np.float32,
) -> np.ndarray:
    """Dispatch to the requested support family; returns ``(n_supports, N, N)``.

    Parity with ``Adj_Preprocessor.process`` (``GCN.py:57-97``), with the
    output cast to the on-device dtype (default float32) after float64 host
    computation.
    """
    if kernel_type == "chebyshev":
        out = chebyshev_supports(adj, K, lambda_max=lambda_max)
    elif kernel_type == "localpool":
        # Strict where the reference is split: its preprocessor silently
        # coerces K -> 1 (GCN.py:54) while its model asserts K == 1
        # (STMGCN.py:83). One consistent rule here: reject early.
        if K != 1:
            raise ValueError("localpool requires K == 1")
        out = localpool_supports(adj)
    elif kernel_type == "random_walk_diffusion":
        out = diffusion_supports(adj, K, bidirectional=bidirectional)
    else:
        raise ValueError(f"kernel_type must be one of {KERNEL_TYPES}, got {kernel_type!r}")
    expected = support_count(kernel_type, K, bidirectional)
    assert out.shape[0] == expected, (out.shape, expected)
    return out.astype(dtype)


@dataclasses.dataclass(frozen=True)
class SupportConfig:
    """Static graph-kernel configuration (reference: ``Main.py:15`` dict).

    ``kernel_type`` in {chebyshev, localpool, random_walk_diffusion}; ``K`` is
    the max polynomial order / diffusion step count.
    """

    kernel_type: str = "chebyshev"
    K: int = 2
    bidirectional: bool = True

    def __post_init__(self):
        if self.kernel_type not in KERNEL_TYPES:
            raise ValueError(f"kernel_type must be one of {KERNEL_TYPES}, got {self.kernel_type!r}")
        if self.kernel_type == "localpool" and self.K != 1:
            raise ValueError("localpool requires K == 1")  # STMGCN.py:83
        if self.K < 0:
            raise ValueError("K must be >= 0")

    @property
    def n_supports(self) -> int:
        return support_count(self.kernel_type, self.K, self.bidirectional)

    def build(self, adj, *, lambda_max: float | None = None, dtype=np.float32) -> np.ndarray:
        return build_supports(
            adj,
            self.kernel_type,
            self.K,
            bidirectional=self.bidirectional,
            lambda_max=lambda_max,
            dtype=dtype,
        )

    def build_all(self, adjs: Sequence, *, dtype=np.float32) -> np.ndarray:
        """Build and stack supports for M graphs -> ``(M, n_supports, N, N)``.

        The reference keeps a Python list of per-graph supports
        (``Main.py:48-55``); stacking them lets the model vmap over the M
        branches instead of looping (``STMGCN.py:112-115``).
        """
        return np.stack([self.build(a, dtype=dtype) for a in adjs], axis=0)
