"""Device ms of the convolution family (cuDNN and its layout transposes) a
model call, in the DisC-Diff batch-8 serving cell."""
from benchmark.harness.readers import conv_ms_per_call as read  # noqa: F401
