"""Device ms a DiT-XL train step launched inside the program's
`attention.backward` spans: the attention VJP's plain f32 recompute, its
products and its softmax work."""
from benchmark.harness.op_spans import attn_backward_ms as read  # noqa: F401
