"""Share of the traced window with no device operation running, in the
flagship's batch-8 serving cell."""
from benchmark.harness.readers import idle_share as read  # noqa: F401
