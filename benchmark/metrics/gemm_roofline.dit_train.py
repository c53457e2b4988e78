"""% of its roofline the linear layers of a DiT-XL train step reach: three
forwards' linear-layer FLOPs (the configuration's `gemm_flops_per_sample`,
the reference's `aten.mm` / `addmm` count, at the cell's batch) at the bf16
dense peak, over the device time a step of the kernels that compute them in
the forward, the remat recompute and the backward. The bound counts the
model's work, whatever runs it, so the recompute lowers the share.

The kernels are told from the card's kernel names here, not by the family
table (which files cuBLAS's `sm90_xmma_gemm_*` under convolution): a bf16
GEMM of cuBLAS (`*gemm*` or `nvjet_*`), and not cuDNN's implicit-GEMM
convolutions (the patch embedding's) nor the f32 products of the attention
VJP."""
from benchmark.harness.peaks import PEAK_BF16_FLOPS

GEMM = ("gemm", "nvjet")
CONVOLUTION = ("implicit", "fprop", "dgrad", "wgrad", "conv", "cudnn")
# f32 products: cuBLAS's `*_gemm_f32f32_*`, MAGMA's and the SIMT `sgemm`s
F32 = ("gemm_f32f32", "sgemm")


def is_linear_gemm(name: str) -> bool:
    """A bf16 GEMM kernel of cuBLAS that a linear layer launches."""
    return (any(k in name for k in GEMM)
            and not any(k in name for k in CONVOLUTION)
            and not any(k in name for k in F32))


def gemm_s(view) -> float:
    return sum(ns for name, ns in view.name_ns.items()
               if is_linear_gemm(name)) / 1e9


def read(view):
    s = gemm_s(view)
    flops = view.config.get("gemm_flops_per_sample")
    if not view.steps or not s or not flops:
        return None
    bound = 3 * flops * view.batch / PEAK_BF16_FLOPS * view.steps
    return 100.0 * bound / s
