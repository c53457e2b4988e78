"""Device ms a DiT-XL train step's backward spent recomputing checkpointed
blocks (the program's `model.remat` spans inside `train.backward`)."""
from benchmark.harness.op_spans import recompute_ms as read  # noqa: F401
