"""Observability: the process-wide metrics registry."""
