"""Kernel families by name: a frozen copy of the table of
``scripts/torch_serve_profile.py`` (fragments of a kernel's name -> its
family, first match wins), so that a change to the program cannot move the
yardstick."""
from __future__ import annotations

FAMILIES = (
    ("flash_attention", ("attn_fwd",)),
    ("group_norm", ("group_norm", "GroupNorm", "RowwiseMoments",
                    "ComputeFusedParams", "groupnorm")),
    ("convolution", ("conv", "xmma", "cutlass", "implicit", "sm90_",
                     "nchwToNhwc", "nhwcToNchw", "cudnn")),
    ("matmul", ("gemm", "Gemm", "sgemm", "cublas")),
    ("optimizer (foreach)", ("multi_tensor", "foreach", "Foreach")),
    ("copy / layout", ("copy", "Copy", "cat", "Cat", "memcpy", "Memcpy",
                       "memset", "Memset", "upsample", "Upsample")),
    ("elementwise / reduce", ("elementwise", "reduce", "Reduce", "silu",
                              "vectorized", "unrolled", "Softmax",
                              "softmax", "index", "Index")),
)

# the families of models.layers' GroupNorm32 / SiLU / FiLM / adds / skip
# mean / casts and layout copies
NORM_ELTWISE = ("group_norm", "elementwise / reduce", "copy / layout")


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"
