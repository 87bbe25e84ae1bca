"""Utilities: timing and profiling, FLOPs/MFU accounting, host-load
provenance and the bench lock (the JAX package's ``stmgcn_tpu.utils``
without its platform helpers and ``comm``, the collective byte counts of
the multi-device path)."""

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
    "device_peak_flops",
    "fence",
    "host_load_snapshot",
    "mfu",
    "region_timesteps_per_sec",
    "stmgcn_step_flops",
    "time_chained",
    "trace",
]
