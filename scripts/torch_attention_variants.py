"""What bounds the attention kernel's two routes: ablations and alternatives,
timed on a CUDA card.

    python scripts/torch_attention_variants.py

Builds ``dsdiff_torch/ops/csrc/flash_attention.cu`` as the package does and,
beside it, variants made by editing a copy of that source (``VARIANTS``):
ablations that drop one part of the work (their outputs are wrong; only
their times count) and design alternatives. Each variant edits one route
(bf16 ``wgmma`` or f32 ``tf32x3``) and is graph-timed
(``chip_smoke.time_ms_graph``, inputs rotated through device memory) beside
the package's kernel and ``scaled_dot_product_attention`` at the flagship's
and the other families' attention shapes in that dtype, in turns: package, variants, variants
reversed, package. Every variant's largest error against the plain version
is printed. Then times the host side of one call at ``[4, 64, 6, 48]``: the
wrapper, its checks, the C entry with (bf16) and without (f32) the three
tensor-map encodes, and SDPA's call; each the least of five runs of 2000
calls. Exits non-zero without a CUDA device, or when an edit no longer
applies to the kernel's source.
"""
import ctypes
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from chip_smoke import rotated, time_ms_graph  # noqa: E402
from dsdiff_torch.ops import _build  # noqa: E402
from dsdiff_torch.ops import flash_attention as fa  # noqa: E402

SHAPES = [(4, 1024, 4, 48), (8, 1024, 4, 48), (16, 1024, 4, 48),
          (4, 256, 6, 48), (4, 64, 6, 48),
          # the disc_diff / palette U-Nets' and DiT-B's
          (4, 1024, 4, 192), (8, 1024, 4, 192), (4, 1024, 12, 64)]
BF16, F32 = torch.bfloat16, torch.float32
# name -> (edits of the source, whether the output is still right, dtype
# of the route it edits)
VARIANTS = {
    # the exponentials of P replaced by their arguments
    "no_exp": ([("exp2_ftz(fmaf(sc[4 * i + 2 * r], scale_log2",
                 "(fmaf(sc[4 * i + 2 * r], scale_log2"),
                ("exp2_ftz(fmaf(sc[4 * i + 2 * r + 1], scale_log2",
                 "(fmaf(sc[4 * i + 2 * r + 1], scale_log2")], False, BF16),
    "no_qk": ([("      wgmma_ss(sc, q_desc", "      if (D < 0) wgmma_ss(sc, q_desc")],
              False, BF16),
    "no_pv": ([("        wgmma_rs(acc[a], p[4 * kk]",
                "        if (D < 0) wgmma_rs(acc[a], p[4 * kk]")], False, BF16),
    # K/V tiles loaded once into the ring and reused: no refills, no waits
    "no_refill": ([("if (tid == 0 && j + STAGES < ntiles) {",
                    "if (tid == 0 && j + STAGES < ntiles && D < 0) {"),
                   ("mbar_wait(bar(s), (j / STAGES) & 1);", "mbar_wait(bar(s), 0);")],
                  False, BF16),
    # CUDA's exp2f (range handling around the same special-function op)
    "exp2f": ([("mt * scale_log2);\n      alpha[r] = exp2_ftz(",
                "mt * scale_log2);\n      alpha[r] = exp2f("),
               ("const float p0 = exp2_ftz(", "const float p0 = exp2f("),
               ("            exp2_ftz(fmaf(", "            exp2f(fmaf(")], True, BF16),
    # a four-stage ring at D <= 64: 74,752 B of shared memory, opted in above
    # 48 KB
    "stages_4": ([("constexpr int wg_stages(int na) { return na == 1 ? 2 : 1; }",
                   "constexpr int wg_stages(int na) { return na == 1 ? 4 : 1; }")],
                 True, BF16),
    # two stages above D=64 too: 121 KB at D=192, one block an SM
    "wide_stages_2": ([("constexpr int wg_stages(int na) { return na == 1 ? 2 : 1; }",
                        "constexpr int wg_stages(int na) { return 2; }")], True, BF16),
    # f32: one TF32 pass (hi * hi only), which prices the two extra passes;
    # its error shows why the route needs them
    "f32_one_pass": ([("  mma_tf32(d, a_lo, b0_hi, b1_hi);\n"
                       "  mma_tf32(d, a_hi, b0_lo, b1_lo);\n", "")], False, F32),
    # f32: the split through cvt.rna.tf32.f32 for hi and for lo
    "f32_cvt_rna": ([("  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;\n"
                      "  lo = __float_as_uint(x - __uint_as_float(hi));",
                      '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));\n'
                      '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) '
                      ': "f"(x - __uint_as_float(hi)));')], True, F32),
    # f32: K/V tiles loaded once into the ring and reused
    "f32_no_refill": ([("if (j + F_STAGES < ntiles) {",
                        "if (j + F_STAGES < ntiles && D < 0) {")], False, F32),
}


def build_variants() -> dict:
    """name -> the C entry of that variant's library; all built at once."""
    source = (_build.CSRC_DIR / "flash_attention.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (edits, _, _) in VARIANTS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: edit no longer applies: {old!r}")
            text = text.replace(old, new)
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        lib = src.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    entries = {"package": fa._library().dsdiff_flash_attention}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} did not build:\n{log}")
        regs = [line.split(":", 1)[1].strip() for line in log.splitlines()
                if "registers" in line][:1]
        print(f"[build] {name}: {regs}")
        fn = ctypes.CDLL(str(lib)).dsdiff_flash_attention
        fn.argtypes = entries["package"].argtypes
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def launcher(fn):
    """``fa._launch`` with another library's C entry (no launch count)."""
    def run(q, k, v):
        qs, ks, vs = fa._check(q, k, v)
        B, N, H, D = q.shape
        o = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                fa._DTYPES[q.dtype], q.device.index, B, H, N, k.shape[1], D,
                *qs[:3], *ks[:3], *vs[:3], N * H * D, H * D, D,
                math.log2(math.e) / math.sqrt(D),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")
        return o
    return run


def host_us(f, calls: int = 2000, runs: int = 5) -> float:
    """Least host time per call of ``f`` over ``runs`` runs."""
    best = math.inf
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            f()
        best = min(best, (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    return best * 1e6


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
    runs = {name: launcher(fn) for name, fn in entries.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (BF16, F32):
        names = ["package"] + [n for n, v in VARIANTS.items() if v[2] == dtype]
        for B, N, H, D in SHAPES:
            qkv = torch.randn(B, N, 3, H, D, generator=gen, device="cuda",
                              dtype=dtype)
            want = fa.reference_attention(*qkv.unbind(2)).float()
            errs = {n: (runs[n](*qkv.unbind(2)).float() - want).abs().max().item()
                    for n in names}
            qkvs = rotated([qkv], qkv.numel() * qkv.element_size())
            times = {n: [] for n in names}
            for n in names + names[::-1]:
                times[n].append(time_ms_graph(lambda x: runs[n](*x.unbind(2)),
                                              qkvs))
            sdpa_in = [tuple(t.transpose(1, 2).contiguous() for t in x.unbind(2))
                       for (x,) in qkvs]
            sdpa = time_ms_graph(F.scaled_dot_product_attention, sdpa_in)
            print(f"[{B},{N},{H},{D}] {str(dtype).split('.')[1]} graph ms (the "
                  f"two turns): "
                  + ", ".join(f"{n} {t[0]:.5f}/{t[1]:.5f}" for n, t in times.items())
                  + f"; sdpa {sdpa:.5f}; max_abs_err "
                  + ", ".join(f"{n} {e:.3e}" + ("" if n == "package" or VARIANTS[n][1]
                                                else " (ablation)")
                              for n, e in errs.items()))
            del qkvs, sdpa_in

    fn = entries["package"]
    stream = torch.cuda.current_stream().cuda_stream
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = torch.randn(4, 64, 3, 6, 48, device="cuda",
                              dtype=dtype).unbind(2)
        o = torch.empty(4, 64, 6, 48, device="cuda", dtype=dtype)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                fa._DTYPES[dtype], 0, 4, 6, 64, 64, 48, *q.stride()[:3],
                *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], 0.2, stream)
        print(f"[host] C entry, {dtype} [4,64,6,48]: "
              f"{host_us(lambda: fn(*args)):.2f} us per call")
    q, k, v = torch.randn(4, 64, 3, 6, 48, device="cuda",
                          dtype=torch.bfloat16).unbind(2)
    sq, sk, sv = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    print(f"[host] flash_attention bf16 [4,64,6,48]: "
          f"{host_us(lambda: fa.flash_attention(q, k, v)):.2f} us per call, "
          f"of which _check {host_us(lambda: fa._check(q, k, v)):.2f} us; "
          f"scaled_dot_product_attention "
          f"{host_us(lambda: F.scaled_dot_product_attention(sq, sk, sv)):.2f} us")


if __name__ == "__main__":
    main()
