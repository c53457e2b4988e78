"""Device ms a model call launched inside the stream encoders (the program's
`model.encoders` span), in the flagship's batch-8 serving cell."""
from benchmark.harness.spans import encoders_ms as read  # noqa: F401
