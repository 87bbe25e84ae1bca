#!/usr/bin/env python3
"""Reckoned bounds of the three block-CSR SpMM TPU kernels at the largeN point.

    python scripts/reckon_spmm_bounds.py

The kernels are ``_stack_fwd_kernel`` (B3), ``_stack_bwd_kernel`` (B4) and
``_spmm_kernel`` (B5) in ``stmgcn_tpu/ops/spmm.py``. The point is
``STMGCN_BENCH_MODE=largeN`` of ``bench.py``: one N=8192 city (64 x 128
grid, the three structured graphs of ``chip_smoke.metro_city``, the port's
copy of ``bench._largen_city``), Chebyshev K=2 (3
supports per graph), tile 128, batch 2, a 3+1+1-step window, LSTM and
graph-conv widths 4. Per branch, a forward calls B3 twice: the gate's
temporal conv on ``B * seq_len = 10`` columns and the graph conv on
``B * 4 = 8``; the backward calls B4 on the same shapes. B5 serves the
legacy per-support sparse path (``model.sparse``), one call per support.

Nothing here is measured. The block structure comes from sparsity
patterns, not values: ``T0 = I``, ``T1`` has the pattern of ``A + I`` and
``T2`` that of ``(A + I)^2``, diagonals counted as nonzero. The tiled plan
uses the JAX package's RCM order over the union of all nine patterns and
one common block-column count ``C`` (``plan_tiling``; the port's copy of
the order, ``stmgcn_tpu_torch.ops.tiling.rcm_permutation``); B5's per-support
structure is unpermuted (``spmm.from_dense``). Bounds count each input read
once and each output written once at float32, real columns only (the
kernels pad x to 128 columns), and operations on kept (nonzero) blocks,
against an H100 SXM's 3.35 TB/s and 67 TFLOP/s fp32 (NVIDIA data sheet).
The dense matrices are never built, so this runs in about 1 GB of host
memory.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PEAK_BYTES, PEAK_FLOPS = 3.35e12, 67e12
TILE, BATCH, SEQ_LEN, HIDDEN = 128, 2, 5, 4
#: the largeN city's grid rows (``bench.py``'s ``LARGEN_ROWS`` default)
LARGEN_ROWS = 64


def patterns(adj: sp.csr_matrix):
    """Boolean patterns of the Chebyshev K=2 supports of one graph."""
    n = adj.shape[0]
    eye = sp.identity(n, dtype=bool, format="csr")
    t1 = ((adj != 0) + eye).astype(bool)
    t2 = (t1 @ t1).astype(bool)
    return [eye, t1, t2]


def block_rows(pattern: sp.csr_matrix, perm=None):
    """Per block row, the sorted unique block columns holding a nonzero."""
    coo = pattern.tocoo()
    r, c = coo.row, coo.col
    if perm is not None:
        inv = np.argsort(perm)
        r, c = inv[r], inv[c]
    n_blocks = -(-pattern.shape[0] // TILE)
    keys = np.unique((r // TILE) * n_blocks + (c // TILE))
    return np.bincount(keys // n_blocks, minlength=n_blocks), len(keys)


def ms(n_bytes: float, flops: float):
    t_b, t_f = n_bytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    return max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


def main() -> None:
    from chip_smoke import metro_city
    from stmgcn_tpu_torch.ops.tiling import rcm_permutation

    data = metro_city(LARGEN_ROWS, 2 * LARGEN_ROWS, n_timesteps=24 * 7 + 14)
    adjs = [sp.csr_matrix(a != 0) for a in data.adjs.values()]
    del data
    n = adjs[0].shape[0]
    R = -(-n // TILE)
    pats = [patterns(a) for a in adjs]  # [m][k]
    union = sum((p for row in pats for p in row), sp.csr_matrix((n, n), dtype=bool))
    perm = rcm_permutation(union.toarray())
    tiled = [[block_rows(p, perm) for p in row] for row in pats]
    tiled_t = [[block_rows(p.T.tocsr(), perm) for p in row] for row in pats]
    C = max(int(counts.max()) for row in tiled for counts, _ in row)
    C_t = max(int(counts.max()) for row in tiled_t for counts, _ in row)
    K = len(pats[0])
    print(f"largeN: N={n}, tile {TILE}, R={R} block rows, M={len(pats)} graphs x K={K} "
          f"supports; tiled plan (RCM over the union) C={C}, C_t={C_t}")

    cols = {"gate conv": BATCH * SEQ_LEN, "graph conv": BATCH * HIDDEN}
    totals = {"B3": [0.0, 0.0], "B4": [0.0, 0.0], "B5": [0.0, 0.0]}
    for m, row in enumerate(tiled):
        kept = sum(k for _, k in row)
        kept_t = sum(k for _, k in tiled_t[m])
        for what, c in cols.items():
            fwd_bytes = 4 * (K * R * C * TILE * TILE + K * R * C + n * c + K * n * c)
            fwd_flops = 2 * kept * TILE * TILE * c
            bwd_bytes = 4 * (K * R * C_t * TILE * TILE + K * R * C_t + K * n * c + n * c)
            bwd_flops = 2 * kept_t * TILE * TILE * c
            for name, b, f in (("B3", fwd_bytes, fwd_flops), ("B4", bwd_bytes, bwd_flops)):
                t, by = ms(b, f)
                totals[name][0] += t
                totals[name][1] += 1
                print(f"{name} branch {m} {what} ({c} cols): {kept if name == 'B3' else kept_t} "
                      f"kept blocks, {b / 1e6:.2f} MB, {f / 1e9:.3f} GFLOP -> "
                      f"{t * 1e3:.2f} us ({by})")
        for k, p in enumerate(pats[m]):
            counts, kept_mk = block_rows(p)
            c_mk = int(counts.max())
            for what, c in cols.items():
                b = 4 * (R * c_mk * TILE * TILE + R * c_mk + 2 * n * c)
                f = 2 * kept_mk * TILE * TILE * c
                t, by = ms(b, f)
                totals["B5"][0] += t
                totals["B5"][1] += 1
                print(f"B5 branch {m} support {k} {what} ({c} cols): C={c_mk}, {kept_mk} kept "
                      f"blocks, {b / 1e6:.2f} MB -> {t * 1e3:.2f} us ({by})")
    for name, (t, calls) in totals.items():
        print(f"{name}: {int(calls)} calls per model {'backward' if name == 'B4' else 'forward'}, "
              f"bounds summing to {t * 1e3:.1f} us")


if __name__ == "__main__":
    main()
