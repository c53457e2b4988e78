"""Device ms of `train.state`'s AdamW, gradient norm and EMA a DiT-XL train
step (674 M parameters)."""
from benchmark.harness.readers import optimizer_ms_per_step as read  # noqa: F401
