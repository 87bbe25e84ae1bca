"""Shape-bucket arithmetic: which rung's program serves a request batch.

The engine keeps one program per ladder rung; every request batch is
padded up to the smallest rung that covers it. Padded rows are zeros and
inert — the forward is row-independent, so padding never changes the
real rows' predictions beyond float summation order (pinned by
``tests/test_torch_serving.py``). The ladder itself is validated by
:meth:`stmgcn_tpu_torch.config.ServingConfig.violations`.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pad_to_bucket", "smallest_covering_bucket"]


def smallest_covering_bucket(n: int, buckets) -> int:
    """The smallest ladder rung holding ``n`` rows (ladder is sorted)."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(
        f"batch of {n} rows exceeds the largest bucket {buckets[-1]} — "
        "the caller must split oversized batches before bucketing"
    )


def pad_to_bucket(rows: np.ndarray, bucket: int) -> np.ndarray:
    """Zero-pad ``rows`` along axis 0 up to ``bucket``.

    An exact fit returns ``rows`` itself — the zero-copy fast path the
    micro-batcher relies on for bucket-sized batches.
    """
    n = rows.shape[0]
    if n == bucket:
        return rows
    if n > bucket:
        raise ValueError(f"{n} rows cannot fit bucket {bucket}")
    padded = np.zeros((bucket,) + rows.shape[1:], dtype=rows.dtype)
    padded[:n] = rows
    return padded
