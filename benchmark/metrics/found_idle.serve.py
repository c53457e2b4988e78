"""% of model calls whose entry found the card with nothing queued (the
program's `model.found_idle` counter), in the flagship's batch-8 serving cell."""
from benchmark.harness.spans import found_idle as read  # noqa: F401
