"""Idle device ms a request in gaps ended by an operation launched outside
every model call (the DDIM update and the request's edges), in the
flagship's batch-8 serving cell."""
from benchmark.harness.spans import outside_model_idle_ms as read  # noqa: F401
