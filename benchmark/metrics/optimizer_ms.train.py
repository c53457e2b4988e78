"""Device ms of `train.state`'s AdamW, gradient norm and EMA a train step."""
from benchmark.harness.readers import optimizer_ms_per_step as read  # noqa: F401
