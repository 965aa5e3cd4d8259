"""Tracing and metrics (a copy of ``repro.obs.trace`` / ``repro.obs.metrics``)."""
