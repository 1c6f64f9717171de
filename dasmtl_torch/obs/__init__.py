"""Observability of the port: the metrics registry behind ``GET /metrics``."""
