"""Device operations launched a model call in the flagship's batch-8 serving
cell (host dispatch, `train.trainer` -> `core.sampling`)."""
from benchmark.harness.readers import launches_per_call as read  # noqa: F401
