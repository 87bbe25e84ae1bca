"""Preemption-safe training: fault injection, divergence rollback.

Copy of ``stmgcn_tpu/resilience/__init__.py`` (the modules are stdlib
only); the trainer, the continual loop, the serving engines, the
federation router and the checkpoint writer of this package consult these
plans at the JAX package's points.

Training on preemptible machines means workers die mid-epoch, disks
truncate files, and one bad batch can NaN the params hours in. This
package holds the pieces the trainer threads through its hot loop —
behind no-op defaults, so the production code paths are exactly the
tested paths:

- :class:`FaultPlan` / :class:`FaultSpec` (:mod:`.faults`) — a
  deterministic fault-injection harness: raise in the step, deliver
  SIGTERM, poison a batch's loss mask with NaN/Inf, drop a batch, or
  truncate/bit-flip a checkpoint write, each at a configured
  (epoch, step) index or write ordinal. Every resilience claim in the
  test suite is driven through it, not reproduced anecdotally.
- :class:`DivergenceGuard` (:mod:`.guard`) — non-finite-loss detection
  with rollback to an in-memory last-good snapshot, skip/defer of the
  offending batch, optional LR cut, and abort after N consecutive trips.
- :class:`Preempted` — raised at a safe step boundary after SIGTERM once
  the emergency checkpoint has landed; a ``BaseException`` so broad
  ``except Exception`` recovery code cannot swallow a shutdown request.
- :class:`ServeFaultPlan` / :class:`ServeFaultSpec` — the serving-side
  mirror: dispatch-addressed raise/slow/hang faults, batcher-thread
  death (:class:`BatcherKilled`), at-rest checkpoint corruption for
  the hot-swap watcher, and promotion-gate raises, so every
  shed/degrade/swap/promote path of the serving engine is exercised
  deterministically too.
- :class:`IngestFaultPlan` / :class:`IngestFaultSpec` — the live-feed
  mirror for the continual loop: a deterministic stream transformer
  (gap / out-of-order / duplicate / nonfinite / SIGTERM by source-row
  ordinal) applied before rows reach the device-resident ingest ring.
- :class:`FederationFaultPlan` / :class:`FederationFaultSpec` — the
  tier-level mirror for the serving federation: replica kill by scatter
  ordinal, hang-on-drain, thundering-herd city spikes, and at-rest
  candidate poisoning before the tier promotion gate, so the
  kill/re-shard/herd/rejection drills of ``serve-bench --federation``
  are deterministic too.

The verified-checkpoint side (CRC32 format v2, ``load_latest_verified``
recovery chain) lives in :mod:`stmgcn_tpu_torch.train.checkpoint`.
"""

from stmgcn_tpu_torch.resilience.faults import (
    BatcherKilled,
    FaultPlan,
    FaultSpec,
    FederationFaultPlan,
    FederationFaultSpec,
    IngestFaultPlan,
    IngestFaultSpec,
    InjectedFault,
    Preempted,
    ServeFaultPlan,
    ServeFaultSpec,
)
from stmgcn_tpu_torch.resilience.guard import DivergenceError, DivergenceGuard

__all__ = [
    "BatcherKilled",
    "DivergenceError",
    "DivergenceGuard",
    "FaultPlan",
    "FaultSpec",
    "FederationFaultPlan",
    "FederationFaultSpec",
    "IngestFaultPlan",
    "IngestFaultSpec",
    "InjectedFault",
    "Preempted",
    "ServeFaultPlan",
    "ServeFaultSpec",
]
