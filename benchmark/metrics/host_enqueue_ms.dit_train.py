"""Median host ms of one DiT-XL train step's dispatch (the program's
`train.step` span, tracer on, no profiler)."""
from benchmark.harness.op_spans import host_enqueue_ms as read  # noqa: F401
