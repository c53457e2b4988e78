"""Device ms a train step's backward spent recomputing checkpointed ResBlocks
(the program's `model.remat` spans inside `train.backward`)."""
from benchmark.harness.spans import recompute_ms as read  # noqa: F401
