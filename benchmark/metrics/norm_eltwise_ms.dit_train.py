"""Device ms of the DiT-XL train step's LayerNorms, adaLN modulate and gates,
GELU, residual adds and casts, forward, recompute and backward (the
elementwise / reduce, copy / layout and norm families). It also holds the
attention VJP's softmax, scaling and casts over its f32 scores."""
from benchmark.harness.readers import norm_eltwise_ms_per_step as read  # noqa: F401
