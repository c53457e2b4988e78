"""Device ms of `models.layers`' GroupNorm32, SiLU, FiLM, adds, skip mean and
copies, forward and backward, a train step."""
from benchmark.harness.readers import norm_eltwise_ms_per_step as read  # noqa: F401
