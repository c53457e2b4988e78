"""What bounds the GroupNorm+SiLU kernels: per-kernel device time, ablations
and alternatives, timed on a CUDA card.

    python scripts/torch_norm_variants.py

Builds ``dsdiff_torch/ops/csrc/fused_norm.cu`` as the package does and,
beside it, variants made by editing a copy of that source (``VARIANTS``):
ablations that drop one part of the work (their outputs are wrong; only
their times count) and design alternatives. At the flagship's norm shapes
(bf16 and f32) it prints the device time of each of the two kernels
(``torch.profiler``, mean of 20 calls), then graph-times
(``chip_smoke.time_ms_graph``, inputs rotated through device memory) the
package, each variant, and the package with more blocks per SM, in two
turns, beside ``F.silu(F.group_norm(...))``. Exits non-zero without a CUDA
device, or when an edit no longer applies to the kernels' source.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chip_smoke import _norm_inputs, norm_bound, rotated, time_ms_graph  # noqa: E402
from dsdiff_torch.ops import _build  # noqa: E402
from dsdiff_torch.ops import fused_norm as fn  # noqa: E402

GROUPS = 32
SHAPES = [(4, 256, 96), (4, 128, 96), (4, 64, 192), (4, 8, 288),
          (16, 256, 96), (16, 128, 96)]
# name -> (edits of the source, whether the output is still right)
VARIANTS = {
    # partial statistics not computed: kernel 2 alone
    "no_stats": ([("  gn_partial_stats<T, VEC><<<grid, THREADS, smem1, st>>>(",
                   "  if (C < 0) gn_partial_stats<T, VEC><<<grid, THREADS, smem1, st>>>(")],
                 False),
    # kernel 2 without its apply loop: the partials' reduction alone
    "no_apply": ([("  const long long nv = (long long)(r1 - r0) * C / V;\n  // the chunk",
                   "  const long long nv = 0;\n  // the chunk")], False),
    # eight vectors in flight per thread instead of four, in one kernel
    "stats_unroll_8": ([("constexpr int STATS_UNROLL = 4;",
                         "constexpr int STATS_UNROLL = 8;")], True),
    "apply_unroll_8": ([("constexpr int APPLY_UNROLL = 4;",
                         "constexpr int APPLY_UNROLL = 8;")], True),
    # SiLU as y / (1 + expf(-y)), IEEE division and CUDA's expf
    "accurate_silu": ([("return __fdividef(y, 1.f + __expf(-y));",
                        "return y / (1.f + expf(-y));")], True),
    # programmatic dependent launch: kernel 2 is scheduled while kernel 1
    # runs and waits for it (griddepcontrol) before it reads the partials
    "pdl": ([("  const int tid = threadIdx.x, chunk = blockIdx.x, batch = blockIdx.y;\n"
              "  const int r0 = chunk * rows;\n",
              '  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");\n'
              "  const int tid = threadIdx.x, chunk = blockIdx.x, batch = blockIdx.y;\n"
              "  const int r0 = chunk * rows;\n"),
             ("  const double* pb = partials + (long long)batch * chunks * items;\n",
              "  const double* pb = partials + (long long)batch * chunks * items;\n"
              '  asm volatile("griddepcontrol.wait;" ::: "memory");\n'),
             ("  apply<<<grid, THREADS, smem2, st>>>(static_cast<const T*>(x), partials,\n"
              "                                      gamma, beta, static_cast<T*>(y), HW, C,\n"
              "                                      G, rows, eps);\n",
              "  cudaLaunchAttribute attr;\n"
              "  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;\n"
              "  attr.val.programmaticStreamSerializationAllowed = 1;\n"
              "  cudaLaunchConfig_t cfg = {};\n"
              "  cfg.gridDim = grid;\n"
              "  cfg.blockDim = dim3(THREADS);\n"
              "  cfg.dynamicSmemBytes = smem2;\n"
              "  cfg.stream = st;\n"
              "  cfg.attrs = &attr;\n"
              "  cfg.numAttrs = 1;\n"
              "  err = cudaLaunchKernelEx(&cfg, apply, static_cast<const T*>(x),\n"
              "                           static_cast<const double*>(partials), gamma,\n"
              "                           beta, static_cast<T*>(y), HW, C, G, rows, eps);\n"
              "  if (err != cudaSuccess) return err;\n")], True),
    # coefficients read one float at a time, with the channel wrap
    "scalar_coefficients": ([("        if (C % V == 0) {  // the vector's",
                              "        if (C < 0) {  // the vector's")], True),
}
BLOCKS_PER_SM = (3, 4)  # the package's kernels with more, smaller chunks


def build_variants() -> dict:
    """name -> the C entry of that variant's library; all built at once."""
    source = (_build.CSRC_DIR / "fused_norm.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (edits, _) in VARIANTS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: edit no longer applies: {old!r}")
            text = text.replace(old, new)
        src = out_dir / f"norm_{name}.cu"
        src.write_text(text)
        lib = src.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    entries = {"package": fn._library().dsdiff_group_norm_silu}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} did not build:\n{log}")
        entry = ctypes.CDLL(str(lib)).dsdiff_group_norm_silu
        entry.argtypes = entries["package"].argtypes
        entry.restype = ctypes.c_int
        entries[name] = entry
    return entries


def launcher(entry, blocks_per_sm: int = 2):
    """``fn.group_norm_silu`` with another library's C entry and about
    ``blocks_per_sm`` blocks per SM (no launch count)."""
    def run(x, scale, bias):
        B, H, W, C = x.shape
        HW, elem = H * W, x.element_size()
        vec = x.data_ptr() % 16 == 0 and HW * C * elem % 16 == 0
        sms = fn._SMS
        fn._SMS = sms * blocks_per_sm // 2  # chunking aims at 2 per SM
        try:
            rows, chunks = fn.chunking(B, HW, C, 16 // elem if vec else 1)
        finally:
            fn._SMS = sms
        partials = torch.empty(B * chunks * GROUPS * 2, dtype=torch.float64,
                               device=x.device)
        y = torch.empty_like(x)
        rc = entry(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                   partials.data_ptr(), y.data_ptr(), fn._DTYPES[x.dtype],
                   int(vec), x.device.index, B, HW, C, GROUPS, rows, chunks,
                   1e-5, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")
        return y
    return run


def kernel_us(run, x, scale, bias, calls: int = 20) -> str:
    """Device µs per call of each of the two kernels that ``run`` launches,
    as "stats/apply"."""
    run(x, scale, bias)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run(x, scale, bias)
        torch.cuda.synchronize()
    out = {"gn_partial_stats": 0.0, "gn_apply": 0.0}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        for name in out:
            if name in e.key:
                out[name] += us / calls
    return "/".join(f"{v:.2f}" for v in out.values())


def main() -> None:
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    entries = build_variants()
    runs = {name: launcher(e) for name, e in entries.items()}
    for k in BLOCKS_PER_SM:
        runs[f"package_{k}_per_sm"] = launcher(entries["package"], k)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            for B, H, C in SHAPES:
                x, scale, bias = _norm_inputs(gen, B, H, C, dtype)
                want = fn.group_norm_silu_plain(x, scale, bias, GROUPS).float()
                errs = {n: (run(x, scale, bias).float() - want).abs().max().item()
                        for n, run in runs.items()}
                split = {n: kernel_us(run, x, scale, bias)
                         for n, run in runs.items()}
                xs = rotated([x], x.numel() * x.element_size())
                times = {n: [] for n in runs}
                for n in list(runs) + list(runs)[::-1]:
                    times[n].append(time_ms_graph(
                        lambda x: runs[n](x, scale, bias), xs))
                w, b = scale.to(dtype), bias.to(dtype)
                lib = time_ms_graph(lambda x: F.silu(F.group_norm(
                    x.permute(0, 3, 1, 2), GROUPS, w, b, 1e-5)), xs)
                bound, _ = norm_bound(B, H, H, C, dtype)
                print(f"[{B},{H},{H},{C}] {str(dtype).split('.')[1]}: kernel "
                      f"us stats/apply (profiler) "
                      + ", ".join(f"{k} {v}" for k, v in split.items())
                      + f"; graph ms (two turns): "
                      + ", ".join(f"{n} {t[0]:.5f}/{t[1]:.5f}" for n, t in times.items())
                      + f"; F.silu(F.group_norm) {lib:.5f}; bound {bound:.5f}; "
                      + "max_abs_err " + ", ".join(
                          f"{n} {e:.3e}" + ("" if n not in VARIANTS or VARIANTS[n][1]
                                            else " (ablation)")
                          for n, e in errs.items()))
                del x, xs


if __name__ == "__main__":
    main()
