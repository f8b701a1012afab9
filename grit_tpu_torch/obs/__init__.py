"""Observability of a port workload: the flight recorder, trace spans,
the metrics registry and the workload's metrics and debug server, log
correlation, the live progress tracker, the periodic sampler and the
phase profiler (counterparts of ``grit_tpu/obs``)."""
