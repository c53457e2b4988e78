"""Device ms a DiT-XL train step launched while its backward ran (the
program's `train.backward` span): the remat recompute, the attention VJP and
the linear layers' gradients."""
from benchmark.harness.op_spans import backward_ms as read  # noqa: F401
