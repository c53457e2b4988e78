"""Device ms of `models.layers`' GroupNorm32, SiLU, FiLM, adds, skip mean and
copies a model call, in the DisC-Diff batch-8 serving cell."""
from benchmark.harness.readers import norm_eltwise_ms_per_call as read  # noqa: F401
