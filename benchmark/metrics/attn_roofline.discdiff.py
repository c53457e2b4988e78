"""Share of its roofline the attention kernel (`ops.flash_attention`) reaches,
in the DisC-Diff batch-8 serving cell."""
from benchmark.harness.readers import attn_roofline as read  # noqa: F401
