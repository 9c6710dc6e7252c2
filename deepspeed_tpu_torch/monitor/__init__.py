"""Monitoring of the port (``deepspeed_tpu/monitor`` of the JAX package):
the experiment monitors (:mod:`.monitor`), the serving engine's span
tracer and histograms (:mod:`.trace`) and device-memory telemetry
(:mod:`.memwatch`)."""
