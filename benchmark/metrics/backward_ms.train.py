"""Device ms a train step launched while its backward ran (the program's
`train.backward` span)."""
from benchmark.harness.spans import backward_ms as read  # noqa: F401
