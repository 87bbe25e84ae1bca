"""Utilities: timing and profiling, FLOPs/MFU accounting, host-load
provenance, the bench lock and ``comm``, the collective layer of the
multi-device path with its byte counts (the JAX package's
``stmgcn_tpu.utils`` without its platform helpers)."""

from stmgcn_tpu_torch.utils.comm import collective_stats, step_comm_report
from stmgcn_tpu_torch.utils.flops import device_peak_flops, mfu, stmgcn_step_flops
from stmgcn_tpu_torch.utils.hostload import BenchLock, host_load_snapshot
from stmgcn_tpu_torch.utils.profiling import (
    StepTimer,
    fence,
    region_timesteps_per_sec,
    time_chained,
    trace,
)

__all__ = [
    "BenchLock",
    "StepTimer",
    "collective_stats",
    "device_peak_flops",
    "fence",
    "host_load_snapshot",
    "mfu",
    "region_timesteps_per_sec",
    "stmgcn_step_flops",
    "step_comm_report",
    "time_chained",
    "trace",
]
