"""Observability: the process-wide metrics registry, the capture
telemetry (:mod:`~stmgcn_tpu_torch.obs.graphmon`), training health
(:mod:`~stmgcn_tpu_torch.obs.health`), serving drift
(:mod:`~stmgcn_tpu_torch.obs.drift`) and the file reports
(:mod:`~stmgcn_tpu_torch.obs.report`, :mod:`~stmgcn_tpu_torch.obs.cli`)."""
