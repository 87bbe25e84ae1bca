"""Observability: the process-wide metrics registry and the capture
telemetry (:mod:`~stmgcn_tpu_torch.obs.graphmon`)."""
