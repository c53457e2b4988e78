"""The card's published peaks and the least time an attention call needs.

NVIDIA H100 SXM, dense, at its 700 W limit: 989 TFLOP/s in bf16 on the
tensor cores, 495 TFLOP/s in TF32, 3.35 TB/s of HBM. The attention bound is
that of ``chip_smoke.py attention_bound``: q, k, v and o moved once at the
memory rate, or 4·B·H·N·M·D operations at the tensor cores' rate (bf16's,
or three TF32 passes for f32), whichever is longer."""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12


def attention_bound_s(B: int, N: int, H: int, D: int, bf16: bool = True,
                      M: int | None = None) -> float:
    M = N if M is None else M
    elem = 2 if bf16 else 4
    t_bytes = 2 * B * (N + M) * H * D * elem / PEAK_BYTES_PER_S
    flops = 4 * B * H * N * M * D
    t_ops = flops / PEAK_BF16_FLOPS if bf16 else 3 * flops / PEAK_TF32_FLOPS
    return max(t_bytes, t_ops)


def forward_attention_bound_s(config: dict, batch: int) -> float:
    """The least time of one forward's attention calls, from the
    configuration's ``attention_calls`` ([N, heads, D, calls] rows)."""
    bf16 = bool(config["trainer"].get("bf16", True))
    return sum(calls * attention_bound_s(batch, N, H, D, bf16)
               for N, H, D, calls in config["attention_calls"])
