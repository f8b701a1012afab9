"""Observability of a port workload: the flight recorder, trace spans,
the metrics registry and the workload's ``/metrics`` server, and log
correlation (counterparts of ``grit_tpu/obs``)."""
