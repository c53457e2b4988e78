"""Median host ms of one model call's dispatch (the program's `model.forward`
span, tracer on, no profiler), in the flagship's batch-8 serving cell."""
from benchmark.harness.spans import host_enqueue_ms as read  # noqa: F401
