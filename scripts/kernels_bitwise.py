#!/usr/bin/env python3
"""Hold two trees' fp32 kernels, and the bf16-storage forms of the LSTM
kernels, bitwise equal on the GPU.

    python3 scripts/kernels_bitwise.py dump OUT.pt      # from a tree's root
    python3 scripts/kernels_bitwise.py compare A.pt B.pt

``dump`` runs every fp32 kernel of the tree it is run from (its own
``stmgcn_tpu_torch``, built into that tree's ``build/kernels/``) on inputs
drawn from one seed on the card: B1 with residuals and B2 at the main
path's shape (M=3 x 16,384 rows, T=12, L=3, H=64) and at other widths and
depths, in float32 and in bfloat16 storage (the same draws rounded to
bf16), B3/B4 at tiles 64 and 128 on shared and per-branch signals of 10,
37, 128 and 256 columns, B5 and its transpose; and saves the outputs.
``compare`` exits 1 unless two dumps hold the same outputs bit for bit.
Run ``dump`` from two unpacked trees (``git archive``) in one call.
"""

import os
import sys


def dump(path: str) -> None:
    sys.path.insert(0, os.getcwd())
    import importlib

    import numpy as np
    import torch

    from stmgcn_tpu_torch.ops.fused_lstm import fused_lstm, fused_lstm_bwd
    from stmgcn_tpu_torch.ops.tiling import plan_tiling

    S = importlib.import_module("stmgcn_tpu_torch.ops.spmm")  # the package re-exports spmm()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    out = {}
    for M, R, T, L, H in ((3, 16384, 12, 3, 64), (2, 1000, 5, 1, 32), (2, 77, 5, 2, 128),
                          (2, 77, 5, 4, 256), (1, 500, 7, 4, 64)):
        s = H ** -0.5
        ops = (randn(M, R, T, 4 * H), (torch.rand(M, L, H, 4 * H, generator=g, device=dev) * 2 - 1) * s,
               (torch.rand(M, max(L - 1, 1), H, 4 * H, generator=g, device=dev) * 2 - 1) * s,
               (torch.rand(M, max(L - 1, 1), 4 * H, generator=g, device=dev) * 2 - 1) * s)
        cots = (randn(M, R, T, H), randn(M, L, R, H), randn(M, L, R, H))
        for name, dtype in (("lstm", torch.float32), ("lstm_bf16", torch.bfloat16)):
            o = tuple(t.to(dtype) for t in ops)
            res = fused_lstm(*o, with_residuals=True)
            grads = fused_lstm_bwd(*o, res[3], res[4], *(t.to(dtype) for t in cots))
            for i, t in enumerate(res + grads):
                out[f"{name}_{M}_{R}_{T}_{L}_{H}_{i}"] = t.cpu()
    rng = np.random.default_rng(0)
    n = 1000
    dense = np.zeros((2, 3, n, n), np.float32)
    for m in range(2):
        for k in range(3):
            rows = rng.integers(0, n, size=n * 6)
            cols = np.clip(rows + rng.integers(-60, 60, n * 6), 0, n - 1)
            dense[m, k, rows, cols] = rng.normal(size=n * 6)
    for tile in (64, 128):
        st = plan_tiling(dense, tile=tile).as_stack().to(dev)
        for F in (10, 37, 128, 256):
            for shared in (True, False):
                y = S.spmm_stack(st, randn(n, F) if shared else randn(2, n, F))
                out[f"b3_{tile}_{F}_{shared}"] = y.cpu()
                out[f"b4_{tile}_{F}_{shared}"] = S.spmm_stack_bwd(
                    st, randn(*y.shape), shared=shared).cpu()
        bs = S.from_dense(dense[0, 1], tile=tile).to(dev)
        x = randn(n, 128)
        out[f"b5_{tile}"] = S.block_spmm(bs, x).cpu()
        out[f"b5t_{tile}"] = S.block_spmm(bs, x, transpose=True).cpu()
    torch.save(out, path)
    print(f"{len(out)} kernel outputs saved to {path}")


def compare(a_path: str, b_path: str) -> int:
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    if a.keys() != b.keys():
        print(f"the dumps hold different outputs: {sorted(set(a) ^ set(b))}")
        return 1
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    print(f"{len(a) - len(bad)} of {len(a)} kernel outputs bitwise equal; differing: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["dump"] and len(sys.argv) == 3:
        dump(sys.argv[2])
    elif sys.argv[1:2] == ["compare"] and len(sys.argv) == 4:
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    else:
        sys.exit(__doc__)
