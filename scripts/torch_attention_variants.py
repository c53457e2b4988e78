"""What bounds the attention kernel's two routes: ablations and alternatives,
timed on a CUDA card.

    python scripts/torch_attention_variants.py [--wide] [--baseline PATH]
    python scripts/torch_attention_variants.py --clock

Builds ``dsdiff_torch/ops/csrc/flash_attention.cu`` as the package does and,
beside it, variants made by editing a copy of that source (``VARIANTS``):
ablations that drop one part of the work (their outputs are wrong; only
their times count) and design alternatives. Each variant edits one route
(bf16 ``wgmma`` / ``wgmma_ws`` or f32 ``tf32x3``) at head dims up to 64,
above 64 or both. Every variant first runs once in a subprocess of its own
(``probe_all``): one that does not answer in ``PROBE_S`` seconds hangs and
is dropped with a message. The rest are graph-timed
(``chip_smoke.time_ms_graph``, inputs rotated through device memory) beside
the package's kernel and ``scaled_dot_product_attention`` at ``SHAPES`` in
that dtype, in turns: package, variants, variants reversed, package; every
variant's largest error against the plain version is printed. Then times
the host side of one call at ``[4, 64, 6, 48]``: the wrapper, its checks,
the C entry with (bf16) and without (f32) the three tensor-map encodes, and
SDPA's call; each the least of five runs of 2000 calls.

``--wide`` keeps the bf16 shapes above D = 64 and their variants only, and
skips the host timing; ``--f32`` the same for the f32 route above D = 64
(``attn_fwd_tf32x3_ws``: ``F32_SHAPES``, the ``ws32_*`` variants).
``--baseline PATH`` adds another version of the source (the parent
commit's, say) as the variant ``baseline``, timed at every shape.
``--clock`` builds the source with ``clock64()`` stamps (``CLOCK_EDITS``)
and prints the cycles of each phase of an ``attn_fwd_ws`` key tile, its
prologue and its epilogue; ``--clock --f32`` those of an
``attn_fwd_tf32x3_ws`` key tile and of its producer's split of an atom
(``F32_CLOCK_EDITS``, the kernel's ``FW_CLK`` hooks). Exits non-zero
without a CUDA device, or when an edit no longer applies to the kernel's
source.

    python scripts/torch_attention_variants.py --f32 [--baseline PATH]
    python scripts/torch_attention_variants.py --f32 --clock
"""
import argparse
import ctypes
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from chip_smoke import attention_bound, rotated, time_ms_graph  # noqa: E402
from dsdiff_torch.ops import _build  # noqa: E402
from dsdiff_torch.ops import flash_attention as fa  # noqa: E402

SHAPES = [(4, 1024, 4, 48), (8, 1024, 4, 48), (16, 1024, 4, 48),
          (4, 256, 6, 48), (4, 64, 6, 48), (4, 1024, 12, 64),
          # above D = 64: the disc_diff / palette U-Nets', the guidance
          # classifier's, DiT-XL's and D = 256
          (4, 1024, 4, 192), (8, 1024, 4, 192), (4, 1024, 4, 128),
          (4, 1024, 16, 72), (4, 1024, 4, 256)]
BF16, F32 = torch.bfloat16, torch.float32
# the f32 rows above D = 64 (PERF.md): disc_diff / palette, the KL-VAE's
# one head of 512, the guidance classifier, CLIP ViT-H/14's image tower,
# DiT-XL/8's and D = 256
F32_SHAPES = [(4, 1024, 4, 192), (8, 1024, 4, 192), (4, 1024, 1, 512),
              (8, 1024, 1, 512), (4, 1024, 4, 128), (4, 257, 16, 80),
              (4, 1024, 16, 72), (4, 1024, 4, 256)]
# --f32 times the ws32_* variants at these only (the package's kernel and
# --baseline at every F32_SHAPES row)
F32_ABLATION_SHAPES = [(8, 1024, 4, 192), (4, 1024, 1, 512), (8, 1024, 1, 512)]

# name -> (edits of the source as (old, new, times old occurs), whether the
# output is still right, dtype of the route it edits, head dims it runs at:
# "narrow" D <= 64 (attn_fwd_wgmma), "wide" D > 64 (attn_fwd_ws), "all")
VARIANTS = {
    # the exponentials of P replaced by their arguments
    "no_exp": ([("exp2_ftz(fmaf(sc[4 * i + 2 * r], scale_log2",
                 "(fmaf(sc[4 * i + 2 * r], scale_log2", 2),
                ("exp2_ftz(fmaf(sc[4 * i + 2 * r + 1], scale_log2",
                 "(fmaf(sc[4 * i + 2 * r + 1], scale_log2", 2)],
               False, BF16, "all"),
    "no_qk": ([("      wgmma_ss(sc, q_desc + step",
                "      if (D < 0) wgmma_ss(sc, q_desc + step", 1),
               ("  for (int kk = 0; kk < KSTEPS; ++kk) {\n    const uint64_t k_step",
                "  for (int kk = 0; kk < KSTEPS && KSTEPS < 0; ++kk) {\n"
                "    const uint64_t k_step", 1)],
              False, BF16, "all"),
    "no_pv": ([("        wgmma_rs(acc[a], p[4 * kk]",
                "        if (D < 0) wgmma_rs(acc[a], p[4 * kk]", 1),
               ("    wgmma_rs_wide<NA>(acc, a, v_desc + 128 * kk);",
                "    if (kk < 0) wgmma_rs_wide<NA>(acc, a, v_desc + 128 * kk);", 1)],
              False, BF16, "all"),
    # attn_fwd_wgmma: K/V tiles loaded once into the ring and reused, no
    # refills, no waits
    "no_refill": ([("if (tid == 0 && j + STAGES < ntiles) {",
                    "if (tid == 0 && j + STAGES < ntiles && D < 0) {", 1),
                   ("mbar_wait(bar(s), (j / STAGES) & 1);", "mbar_wait(bar(s), 0);", 1)],
                  False, BF16, "narrow"),
    # attn_fwd_wgmma: CUDA's exp2f (range handling around the same
    # special-function op)
    "exp2f": ([("mt * scale_log2);\n      alpha[r] = exp2_ftz(",
                "mt * scale_log2);\n      alpha[r] = exp2f(", 1),
               ("        const float p0 = exp2_ftz(", "        const float p0 = exp2f(", 1),
               ("            exp2_ftz(fmaf(", "            exp2f(fmaf(", 1)],
              True, BF16, "narrow"),
    # attn_fwd_wgmma: a four-stage ring at D <= 64: 74,752 B of shared
    # memory, opted in above 48 KB
    "stages_4": ([("constexpr int wg_stages(int na) { return na == 1 ? 2 : 1; }",
                   "constexpr int wg_stages(int na) { return na == 1 ? 4 : 1; }", 1)],
                 True, BF16, "narrow"),
    # above 64, attn_fwd_wgmma in place of attn_fwd_ws: one warpgroup a
    # 64-row Q tile, one K/V stage
    "wgmma_route": ([("return {true, na, na, D <= 80 ? 5 : 4 * na};",
                      "return {false, na, na, 4 * na};", 1),
                     ("  if constexpr (!LSE) {  // above 256, TMA layouts only\n",
                      "  if constexpr (!LSE) {  // above 256, TMA layouts only\n"
                      + "".join(f"    if (plan.na == {na}) return launch_wgmma_as<"
                                f"{na}, {4 * na}, {na}, true>(a, ob, B, H, N, M, "
                                f"D, os, scale_log2, st);\n" for na in (2, 3, 4)),
                      1)],
                    True, BF16, "wide"),
    # attn_fwd_ws: the two consumer warpgroups issue their products without
    # taking turns
    "ws_no_pingpong": ([("constexpr bool WS_PINGPONG = true;",
                         "constexpr bool WS_PINGPONG = false;", 1)], True, BF16, "wide"),
    # attn_fwd_ws: O rescaled whenever a row's max grows, not only past 2^8
    "ws_eager_rescale": ([("constexpr float WS_RESCALE_LOG2 = 8.f;",
                           "constexpr float WS_RESCALE_LOG2 = 0.f;", 1)],
                         True, BF16, "wide"),
    # attn_fwd_ws: no overlap of the softmax with PV inside a warpgroup
    # (S_j waited on together with PV of tile j - 1)
    "ws_no_overlap": ([("wgmma_wait<1>();  // S_j", "wgmma_wait<0>();  // S_j", 1)],
                      True, BF16, "wide"),
    # attn_fwd_ws: ring depth 1 and 3 (3 up to D = 192: 197,632 B there)
    "ws_stages_1": ([("constexpr int ws_stages(int na) { return 2; }",
                      "constexpr int ws_stages(int na) { return 1; }", 1)],
                    True, BF16, "wide"),
    "ws_stages_3": ([("constexpr int ws_stages(int na) { return 2; }",
                      "constexpr int ws_stages(int na) { return na <= 3 ? 3 : 2; }", 1)],
                    True, BF16, "wide"),
    # attn_fwd_ws diagnostics: K and V loaded once (the first STAGES tiles,
    # reused), so no load is waited on after the first; only warpgroup 0
    # issues products (warpgroup 1 idles through the same barriers)
    "ws_no_loads": ([("        if (j < ntiles) {\n          const int s = j % STAGES;",
                      "        if (j < ntiles && j < STAGES) {\n          const int s = j % STAGES;", 1),
                     ("        if (j > 0) {\n          const int i = j - 1",
                      "        if (j > 0 && j <= STAGES) {\n          const int i = j - 1", 1),
                     ("mbar_wait(k_full(s), (j / STAGES) & 1);", "mbar_wait(k_full(s), 0);", 1),
                     ("mbar_wait(v_full(sp), ((j - 1) / STAGES) & 1);",
                      "mbar_wait(v_full(sp), 0);", 1),
                     ("mbar_wait(v_full(sl), ((ntiles - 1) / STAGES) & 1);",
                      "mbar_wait(v_full(sl), 0);", 1)], False, BF16, "wide"),
    "ws_one_consumer": ([("ws_qk<NA, KSTEPS>(sc,", "if (wg == 0) ws_qk<NA, KSTEPS>(sc,", 2),
                         ("ws_pv<NA>(acc, p,", "if (wg == 0) ws_pv<NA>(acc, p,", 2)],
                        False, BF16, "wide"),
    # attn_fwd_ws: Q read from shared memory by every QK^T product at every
    # D, or held in registers up to D = 128 only
    "ws_q_smem": ([("constexpr bool ws_q_regs(int na) { return na <= 3; }",
                    "constexpr bool ws_q_regs(int na) { return false; }", 1)],
                  True, BF16, "wide"),
    "ws_q_regs_128": ([("constexpr bool ws_q_regs(int na) { return na <= 3; }",
                        "constexpr bool ws_q_regs(int na) { return na <= 2; }", 1)],
                      True, BF16, "wide"),
    # attn_fwd_ws: QK^T over 8 k-steps up to D = 80 too (the padding's 48
    # columns of zeros multiplied)
    "ws_ksteps_8": ([("return {true, na, na, D <= 80 ? 5 : 4 * na};",
                      "return {true, na, na, 4 * na};", 1)], True, BF16, "wide"),
    # attn_fwd_ws: O stored by the threads straight from the registers
    "ws_thread_stores": ([("      a.o_tma = plan.ws && D % 8 == 0;",
                           "      a.o_tma = 0;", 1)], True, BF16, "wide"),
    # attn_fwd_ws: PV as NA m64n64k16 products a k-step, one per atom of V
    "ws_pv_atoms": ([("""  const uint64_t v_desc = make_desc(v_tile, ATOM_BYTES, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3]};
    wgmma_rs_wide<NA>(acc, a, v_desc + 128 * kk);
  }""", """#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const uint64_t v_desc = make_desc(v_tile + a * ATOM_BYTES, ATOM_BYTES, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc[a], p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
               v_desc + 128 * kk);
  }""", 1)], True, BF16, "wide"),
    # f32: one TF32 pass (hi * hi only), which prices the two extra passes;
    # its error shows why the route needs them
    "f32_one_pass": ([("  mma_tf32(d, a_lo, b0_hi, b1_hi);\n"
                       "  mma_tf32(d, a_hi, b0_lo, b1_lo);\n", "", 1)], False, F32, "narrow"),
    # f32: the split through cvt.rna.tf32.f32 for hi and for lo
    "f32_cvt_rna": ([("  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;\n"
                      "  lo = __float_as_uint(x - __uint_as_float(hi));",
                      '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));\n'
                      '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) '
                      ': "f"(x - __uint_as_float(hi)));', 1)], True, F32, "narrow"),
    # f32: K/V tiles loaded once into the ring and reused
    "f32_no_refill": ([("if (j + F_STAGES < ntiles) {",
                        "if (j + F_STAGES < ntiles && D < 0) {", 1)], False, F32, "narrow"),
    # attn_fwd_tf32x3_ws (f32 above D = 64). Ablations: the loads (the
    # ring's first FW_STAGES atoms loaded once and split again and again),
    # QK^T's products, PV's products, the lo passes (one TF32 pass: S from
    # Q_hi K^T alone, PV from P_hi V^T alone)
    "ws32_no_loads": ([("        for (int n = 0; n < total; ++n) {\n"
                        "          const int s = n % STAGES, j = n / per_tile",
                        "        for (int n = 0; n < total && n < STAGES; ++n) {\n"
                        "          const int s = n % STAGES, j = n / per_tile", 1),
                       ("        mbar_wait(full(s), (i / STAGES) & 1);\n        FW_CLK_P(i, 0)",
                        "        mbar_wait(full(s), 0);\n        FW_CLK_P(i, 0)", 1)],
                      False, F32, "wide"),
    "ws32_no_qk": ([("        wgmma_tf32_ss<2 * KT>(sc, sl,",
                     "        if (D < 0) wgmma_tf32_ss<2 * KT>(sc, sl,", 1),
                    ("        wgmma_tf32_rs<KT>(sc, ql[kk],",
                     "        if (D < 0) wgmma_tf32_rs<KT>(sc, ql[kk],", 1)],
                   False, F32, "wide"),
    "ws32_no_pv": ([("          wgmma_tf32_rs<32>(acc[la], ",
                     "          if (D < 0) wgmma_tf32_rs<32>(acc[la], ", 3)],
                   False, F32, "wide"),
    "ws32_one_pass": ([("        wgmma_tf32_rs<KT>(sc, ql[kk],",
                        "        if (D < 0) wgmma_tf32_rs<KT>(sc, ql[kk],", 1),
                       ("    for (int i = 0; i < SR; ++i) p[i] = sc[i] + sl[i];",
                        "    for (int i = 0; i < SR; ++i) p[i] = sc[i];", 1),
                       ("          wgmma_tf32_rs<32>(acc[la], pl[kk], v_hi);\n"
                        "          wgmma_tf32_rs<32>(acc[la], ph[kk], v_lo);\n", "", 1)],
                      False, F32, "wide"),
    # the ring at its least depth: a consumer holds up to two atoms and
    # the split reads the next atom before it releases the one it splits
    "ws32_stages_4": ([("constexpr int FW_STAGES = 8;", "constexpr int FW_STAGES = 4;", 1)],
                      True, F32, "wide"),
    # PV design (b): mma.sync over the raw V atom and its lo, split once a
    # block; and the same with every consumer warp splitting the V values
    # it reads (as the mma.sync kernel before split every operand)
    "ws32_pv_mma_sync": ([("constexpr bool FW_PV_WGMMA = true, FW_V_SPLIT_ONCE = true;",
                           "constexpr bool FW_PV_WGMMA = false, FW_V_SPLIT_ONCE = true;", 1)],
                         True, F32, "wide"),
    "ws32_pv_mma_sync_warp_split": (
        [("constexpr bool FW_PV_WGMMA = true, FW_V_SPLIT_ONCE = true;",
          "constexpr bool FW_PV_WGMMA = false, FW_V_SPLIT_ONCE = false;", 1)],
        True, F32, "wide"),
    # above D = 256: both consumers compute every k-step of QK^T (the
    # scores twice) instead of each half and a sum through shared memory
    "ws32_dup_scores": ([("constexpr bool FW_SHARE_SCORES = true;",
                          "constexpr bool FW_SHARE_SCORES = false;", 1)], True, F32, "wide"),
}

# --clock: attn_fwd_ws with clock64() stamps of block (0, 0), its consumer
# warpgroups' first threads at each phase of every key tile j (slots: loop
# top, PV of tile j - 2 done, O rescaled and P_(j-1) packed, K_j landed,
# QK^T issued, V_(j-1) landed, PV issued, S_j done; the softmax runs to the
# next loop top) and the producer's K_j / V_(j-1) issues
CLOCK_PHASES = ("wait PV", "rescale+pack", "wait K", "issue QK", "wait V",
                "issue PV", "wait S", "softmax")
_CLK = "if (rec && (i) < 17) g_clock[wg][i][k] = clock64();"
CLOCK_EDITS = [
    ("namespace {\n", "namespace {\n__device__ long long g_clock[3][17][8];\n"
     f"#define CLK(i, k) {_CLK}\n", 1),
    ("    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;\n",
     "    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;\n"
     "    const bool rec = blockIdx.x == 0 && blockIdx.y == 0 && tid == 0;\n", 1),
    ("    mbar_wait(q_full, 0);\n", "    CLK(0, 0)\n    mbar_wait(q_full, 0);\n    CLK(0, 1)\n", 1),
    ("      wgmma_wait<0>();  // PV of tile j - 2\n",
     "      CLK(j, 0)\n      wgmma_wait<0>();  // PV of tile j - 2\n      CLK(j, 1)\n", 1),
    ("      ws_pack(sc, p);\n      mbar_wait(k_full(s), (j / STAGES) & 1);\n",
     "      ws_pack(sc, p);\n      CLK(j, 2)\n      mbar_wait(k_full(s), (j / STAGES) & 1);\n"
     "      CLK(j, 3)\n", 1),
    ("      ws_qk<NA, KSTEPS>(sc, qf, q_desc, make_desc(k_smem(s), 16, 1024));\n"
     "      wgmma_commit();\n",
     "      ws_qk<NA, KSTEPS>(sc, qf, q_desc, make_desc(k_smem(s), 16, 1024));\n"
     "      wgmma_commit();\n      CLK(j, 4)\n", 1),
    ("      mbar_wait(v_full(sp), ((j - 1) / STAGES) & 1);\n",
     "      mbar_wait(v_full(sp), ((j - 1) / STAGES) & 1);\n      CLK(j, 5)\n", 1),
    ("      ws_pv<NA>(acc, p, v_smem(sp));\n      wgmma_commit();\n",
     "      ws_pv<NA>(acc, p, v_smem(sp));\n      wgmma_commit();\n      CLK(j, 6)\n", 1),
    ("      wgmma_wait<1>();  // S_j; PV of tile j - 1 may still run\n",
     "      wgmma_wait<1>();  // S_j; PV of tile j - 1 may still run\n      CLK(j, 7)\n", 1),
    ("    const int sl = (ntiles - 1) % STAGES;\n",
     "    CLK(16, 0)\n    const int sl = (ntiles - 1) % STAGES;\n", 1),
    ('    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");\n'
     "    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;\n",
     '    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");\n'
     "    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;\n"
     "    if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) g_clock[wg][0][3] = clock64();\n", 1),
    ("    // warpgroup 1's first arrival on barrier 1 is matched here\n",
     "    CLK(16, 1)\n    // warpgroup 1's first arrival on barrier 1 is matched here\n", 1),
    ("      return;\n    }\n    __nv_bfloat16* ob",
     "      CLK(16, 2)\n      return;\n    }\n    __nv_bfloat16* ob", 1),
    ("          tma_load_tile(k_smem(s), &tk, k_full(s), 0, NA, h, j * TILE, b);\n",
     "          tma_load_tile(k_smem(s), &tk, k_full(s), 0, NA, h, j * TILE, b);\n"
     "          if (blockIdx.x == 0 && blockIdx.y == 0 && j < 17) g_clock[2][j][0] = clock64();\n", 1),
    ("          tma_load_tile(v_smem(s), &tv, v_full(s), 0, NA, h, i * TILE, b);\n",
     "          tma_load_tile(v_smem(s), &tv, v_full(s), 0, NA, h, i * TILE, b);\n"
     "          if (blockIdx.x == 0 && blockIdx.y == 0 && j < 17) g_clock[2][j][1] = clock64();\n", 1),
    ("extern \"C\" void dsdiff_flash_attention_bf16_plan(",
     "extern \"C\" int dsdiff_clock(void* dst) {\n"
     "  return (int)cudaMemcpyFromSymbol(dst, g_clock, sizeof(g_clock));\n}\n\n"
     "extern \"C\" void dsdiff_flash_attention_bf16_plan(", 1),
]
CLOCK_SHAPES = [(4, 1024, 4, 192), (8, 1024, 4, 192), (4, 1024, 4, 128)]

# --clock --f32: attn_fwd_tf32x3_ws's FW_CLK hooks defined, block (0, 0):
# consumer 0's thread 0 at each phase of key tile j (tile start, QK^T
# issued, QK^T done, scores summed (SPLIT: the other consumer's added),
# softmax done, PV issued, PV done) and the producer's first splitting
# thread at each atom i (landed, split and released, stores issued, fenced)
F32_CLOCK_PHASES = ("issue QK", "wait QK", "sum S", "softmax", "issue PV",
                    "wait PV", "to next tile")
F32_CLOCK_EDITS = [
    ("namespace {\n",
     "namespace {\n__device__ long long g_fw_clock[17][8];\n"
     "__device__ long long g_fw_prod[64][4];\n"
     "#define FW_CLK(j, k) if (blockIdx.x == 0 && blockIdx.y == 0 && "
     "threadIdx.x == 0 && (j) < 17) g_fw_clock[j][k] = clock64();\n"
     "#define FW_CLK_P(i, k) if (blockIdx.x == 0 && blockIdx.y == 0 && "
     "threadIdx.x == 2 * WG + 32 && (i) < 64) g_fw_prod[i][k] = clock64();\n", 1),
    ("extern \"C\" void dsdiff_flash_attention_bf16_plan(",
     "extern \"C\" int dsdiff_fw_clock(void* tiles, void* atoms) {\n"
     "  int e = (int)cudaMemcpyFromSymbol(tiles, g_fw_clock, sizeof(g_fw_clock));\n"
     "  return e ? e : (int)cudaMemcpyFromSymbol(atoms, g_fw_prod, sizeof(g_fw_prod));\n}\n\n"
     "extern \"C\" void dsdiff_flash_attention_bf16_plan(", 1),
]
F32_CLOCK_SHAPES = [(8, 1024, 4, 192), (4, 1024, 4, 128), (4, 1024, 4, 256),
                    (8, 1024, 1, 512)]


def f32_clock_breakdown(lib_fn, clock_fn) -> None:
    """Cycles of each phase of an attn_fwd_tf32x3_ws key tile (block
    (0, 0), consumer 0, the mean over tiles 2..14) and of the producer's
    split of an atom (landed to released) and wait for the next."""
    run = launcher(lib_fn)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tiles = (ctypes.c_longlong * (17 * 8))()
    atoms = (ctypes.c_longlong * (64 * 4))()
    for B, N, H, D in F32_CLOCK_SHAPES:
        qkv = torch.randn(B, N, 3, H, D, generator=gen, device="cuda",
                          dtype=F32)
        for _ in range(3):
            run(*qkv.unbind(2))
        torch.cuda.synchronize()
        if clock_fn(tiles, atoms):
            raise RuntimeError("cudaMemcpyFromSymbol failed")
        t = [[tiles[j * 8 + k] for k in range(8)] for j in range(17)]
        phases = []
        for k in range(7):
            d = [(t[j][k + 1] if k < 6 else t[j + 1][0]) - t[j][k]
                 for j in range(2, 15)]
            phases.append(sum(d) / len(d))
        plan = fa.f32_plan(B, N, H, D)
        print(f"[clock] [{B},{N},{H},{D}] f32 tf32x3_ws ({plan['key_rows']}-key "
              f"tiles, {plan['dk'] // 4} atoms, split {plan['split']}), consumer 0, "
              f"cycles a key tile: "
              + ", ".join(f"{n} {c:.0f}" for n, c in zip(F32_CLOCK_PHASES, phases))
              + f"; total {sum(phases):.0f}")
        a = [[atoms[i * 4 + k] for k in range(4)] for i in range(64)]
        mean = lambda x: sum(x) / len(x)  # noqa: E731
        span = range(8, 56)
        print(f"[clock]   producer's first splitting thread, cycles an atom "
              f"(atoms 8..55): loads and stores "
              f"{mean([a[i][2] - a[i][0] for i in span]):.0f}, fence "
              f"{mean([a[i][3] - a[i][2] for i in span]):.0f}, arrival "
              f"{mean([a[i][1] - a[i][3] for i in span]):.0f}; the next atom "
              f"landed {mean([a[i + 1][0] - a[i][1] for i in span]):.0f} "
              f"after (the wait for it)")
        del qkv


def clock_breakdown(lib_fn, clock_fn) -> None:
    """Cycles of each phase of an attn_fwd_ws key tile, block (0, 0): the
    mean over tiles 2..14 for each consumer warpgroup, and when warpgroup
    1 reaches each phase after warpgroup 0."""
    run = launcher(lib_fn)
    gen = torch.Generator(device="cuda").manual_seed(0)
    buf = (ctypes.c_longlong * (3 * 17 * 8))()
    for B, N, H, D in CLOCK_SHAPES:
        qkv = torch.randn(B, N, 3, H, D, generator=gen, device="cuda",
                          dtype=BF16)
        for _ in range(3):
            run(*qkv.unbind(2))
        torch.cuda.synchronize()
        if clock_fn(buf):
            raise RuntimeError("cudaMemcpyFromSymbol failed")
        t = [[[buf[(w * 17 + j) * 8 + k] for k in range(8)] for j in range(17)]
             for w in range(3)]
        for w in range(2):
            e = t[w]
            print(f"[clock] [{B},{N},{H},{D}] block (0, 0), warpgroup {w}: "
                  f"entry to Q landed {e[0][1] - e[0][3]}, tile 0 "
                  f"{e[1][0] - e[0][1]}, tiles 1..{N // 64 - 1} "
                  f"{e[16][0] - e[1][0]}, the last PV {e[16][1] - e[16][0]}, "
                  f"the epilogue {e[16][2] - e[16][1]} cycles")
        for w in range(2):
            phases = []
            for k in range(8):
                d = [(t[w][j][k + 1] if k < 7 else t[w][j + 1][0]) - t[w][j][k]
                     for j in range(2, 15)]
                phases.append(sum(d) / len(d))
            print(f"[clock]   warpgroup {w}, cycles a key tile: "
                  + ", ".join(f"{n} {c:.0f}" for n, c in zip(CLOCK_PHASES, phases))
                  + f"; total {sum(phases):.0f}")
        lag = [sum(t[1][j][k] - t[0][j][k] for j in range(2, 15)) / 13
               for k in range(8)]
        print("[clock]   warpgroup 1 after warpgroup 0: "
              + ", ".join(f"{n} {c:.0f}" for n, c in zip(CLOCK_PHASES, lag)))
        ahead = [t[0][j][3] - t[2][j][0] for j in range(2, 15)]
        print(f"[clock]   producer: K_j issued {sum(ahead) / len(ahead):.0f} "
              f"cycles before warpgroup 0 found it landed (mean, tiles 2..14)")
        del qkv


def _runs_at(name: str, D: int) -> bool:
    reach = VARIANTS[name][3]
    return reach == "all" or (reach == "wide") == (D > 64)


PROBE_S = 90  # a variant that gives no answer in this time hangs
BASELINE = [None]  # --baseline's source
_WIDE = ([], True, BF16, "wide")


def _variant_entry(name: str):
    """The C entry of ``name``'s built library (``package``: the
    package's)."""
    if name == "package":
        return fa._library().dsdiff_flash_attention
    fn = ctypes.CDLL(str(_build.BUILD_DIR / "variants" / f"{name}.so")
                     ).dsdiff_flash_attention
    fn.argtypes = fa._library().dsdiff_flash_attention.argtypes
    fn.restype = ctypes.c_int
    return fn


def _probe_shapes(name: str) -> list:
    # the --clock build is not in VARIANTS here: a D > 64 bf16 variant
    reach = "all" if name == "package" else VARIANTS.get(name, _WIDE)[3]
    dims = {"narrow": [48], "wide": [192, 256], "all": [48, 192, 256]}[reach]
    if name != "package" and VARIANTS.get(name, _WIDE)[2] == F32 and reach == "wide":
        dims = [192, 256, 512]
    return [(2, 1024, 2, D) for D in dims] + [(1, 200, 1, D) for D in dims]


def probe(name: str) -> None:
    """One call of ``name`` at each of its probe shapes, synchronised (run
    in a subprocess of its own, so that a variant that hangs is found)."""
    run = launcher(_variant_entry(name))
    dtype = (BF16 if name == "package" else VARIANTS.get(name, _WIDE)[2]) or BF16
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, N, H, D in _probe_shapes(name):
        qkv = torch.randn(B, N, 3, H, D, generator=gen, device="cuda",
                          dtype=dtype)
        run(*qkv.unbind(2))
        torch.cuda.synchronize()


def probe_all(names) -> list:
    """Probe every variant in ``names`` at once, each in a subprocess;
    returns those that answered (the others are printed and dropped)."""
    procs = {n: subprocess.Popen([sys.executable, __file__, "--probe", n],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for n in names}
    ok = []
    for n, proc in procs.items():
        try:
            out, _ = proc.communicate(timeout=PROBE_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            print(f"[probe] {n}: no answer in {PROBE_S} s (it hangs): dropped")
            continue
        if proc.returncode:
            print(f"[probe] {n}: failed, dropped: {out.strip()[-400:]}")
            continue
        ok.append(n)
    return ok


def build_variants() -> dict:
    """name -> the C entry of that variant's library; all built at once."""
    source = (_build.CSRC_DIR / "flash_attention.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (edits, _, _, _) in VARIANTS.items():
        text = BASELINE[0] if name == "baseline" else source
        for old, new, times in edits:
            if text.count(old) != times:
                raise SystemExit(f"variant {name}: edit no longer applies: {old!r}")
            text = text.replace(old, new)
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        lib = src.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fa._library()  # the package's, built beside them
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} did not build:\n{log}")
        regs = [line.split(":", 1)[1].strip() for line in log.splitlines()
                if "registers" in line and "ws" in line][:1]
        notes = sorted({line.split("(")[1].split(")")[0]
                        for line in log.splitlines() if "(C75" in line})
        print(f"[build] {name}: {regs}, ptxas notes {notes}")
    return {name: _variant_entry(name)
            for name in probe_all(["package", *procs])}


def launcher(fn):
    """``fa._launch`` with another library's C entry (no launch count)."""
    def run(q, k, v):
        qs, ks, vs = fa._check(q, k, v)
        B, N, H, D = q.shape
        o = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
        vec = fa._vec(q, k, v, (qs, ks, vs)) if q.dtype == BF16 else 0
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                fa._DTYPES[q.dtype], vec, q.device.index, B, H, N, k.shape[1], D,
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
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--wide", action="store_true",
                    help="only the bf16 shapes above D = 64 and the variants "
                         "that run there; no host timing")
    ap.add_argument("--f32", action="store_true",
                    help="only the f32 shapes above D = 64 (F32_SHAPES) and "
                         "the variants that run there; no host timing")
    ap.add_argument("--clock", action="store_true",
                    help="only attn_fwd_ws's cycles by phase (CLOCK_EDITS); "
                         "with --f32 attn_fwd_tf32x3_ws's (F32_CLOCK_EDITS)")
    ap.add_argument("--baseline", metavar="PATH",
                    help="also build PATH (another version of "
                         "flash_attention.cu, e.g. the parent commit's) as the "
                         "variant 'baseline' and time it at every shape")
    ap.add_argument("--probe", help=argparse.SUPPRESS)  # one variant, once
    args = ap.parse_args()
    if args.baseline:
        # no edits: the file itself; right at every shape of both dtypes
        VARIANTS["baseline"] = ([], True, None, "all")
        BASELINE[0] = Path(args.baseline).read_text()
    if args.probe:
        probe(args.probe)
        return
    clock_name = "ws32_clock" if args.f32 else "ws_clock"
    if args.clock:
        VARIANTS.clear()
        VARIANTS[clock_name] = ((F32_CLOCK_EDITS, True, F32, "wide") if args.f32
                                else (CLOCK_EDITS, True, BF16, "wide"))
    if args.wide or args.f32:
        keep = F32 if args.f32 else BF16
        for name in [n for n, v in VARIANTS.items()
                     if v[2] not in (keep, None) or v[3] == "narrow"]:
            del VARIANTS[name]
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    entries = build_variants()
    if "package" not in entries:
        raise SystemExit("the package's kernel did not answer its probe")
    if args.clock:
        lib = ctypes.CDLL(str(_build.BUILD_DIR / "variants" / f"{clock_name}.so"))
        if clock_name not in entries:
            raise SystemExit("the clocked kernel did not answer its probe")
        if args.f32:
            clock_fn = lib.dsdiff_fw_clock
            clock_fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            clock_fn.restype = ctypes.c_int
            f32_clock_breakdown(entries[clock_name], clock_fn)
        else:
            clock_fn = lib.dsdiff_clock
            clock_fn.argtypes, clock_fn.restype = [ctypes.c_void_p], ctypes.c_int
            clock_breakdown(entries[clock_name], clock_fn)
        return
    runs = {name: launcher(fn) for name, fn in entries.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (F32,) if args.f32 else (BF16,) if args.wide else (BF16, F32):
        for B, N, H, D in (F32_SHAPES if args.f32 else
                           [x for x in SHAPES if x[3] > 64 or not args.wide]):
            names = ["package"] + [n for n, v in VARIANTS.items()
                                   if v[2] in (dtype, None) and _runs_at(n, D)
                                   and n in runs]
            if args.f32 and (B, N, H, D) not in F32_ABLATION_SHAPES:
                names = [n for n in names if n in ("package", "baseline")]
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
            bound, by = attention_bound(B, N, H, D, dtype)
            kernel = (fa.bf16_plan(B, N, H, D)["kernel"] if dtype == BF16
                      else fa.f32_plan(B, N, H, D)["kernel"])
            print(f"[{B},{N},{H},{D}] {str(dtype).split('.')[1]} ({kernel}; "
                  f"bound {bound:.5f} ms by {by}) graph ms (the two turns): "
                  + ", ".join(f"{n} {t[0]:.5f}/{t[1]:.5f}" for n, t in times.items())
                  + f"; sdpa {sdpa:.5f}; max_abs_err "
                  + ", ".join(f"{n} {e:.3e}" + ("" if n == "package" or VARIANTS[n][1]
                                                else " (ablation)")
                              for n, e in errs.items()))
            del qkvs, sdpa_in

    if args.wide or args.f32:
        return
    fn = entries["package"]
    stream = torch.cuda.current_stream().cuda_stream
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = torch.randn(4, 64, 3, 6, 48, device="cuda",
                              dtype=dtype).unbind(2)
        o = torch.empty(4, 64, 6, 48, device="cuda", dtype=dtype)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                fa._DTYPES[dtype], 0, 0, 4, 6, 64, 64, 48, *q.stride()[:3],
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
