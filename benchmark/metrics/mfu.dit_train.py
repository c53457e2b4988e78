"""The DiT-XL train step's share of the card's bf16 dense peak."""
from benchmark.harness.readers import mfu_train as read  # noqa: F401
