"""The whole model step's share of the card's bf16 dense peak, in the DisC-Diff
batch-8 serving cell."""
from benchmark.harness.readers import mfu_serve as read  # noqa: F401
