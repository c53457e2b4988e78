"""Share of the traced DiT-XL train window with no device operation running."""
from benchmark.harness.readers import idle_share as read  # noqa: F401
