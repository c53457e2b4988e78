// Flash attention forward for Hopper (sm_90a): o = softmax(q k^T / sqrt(D)) v.
//
// Replaces the JAX package's Pallas TPU kernel ops/flash_attention.py:80
// flash_attention (body _attn_kernel :48-76): non-causal attention with an f32
// online softmax (running max and sum) so the [N, M] score matrix never
// reaches device memory.
//
// Layout: q [B, N, H, D], k and v [B, M, H, D], each read through its own
// strides (the last dimension contiguous), so q, k and v may be the strided
// thirds of the attention block's qkv projection and nothing is copied or
// transposed. The output is written [B, N, H, D] in the input type.
//
// Two routes, chosen by dtype in the C entry at the bottom, and within each
// a kernel by head dim and layout (bf16_plan, f32_plan):
//
// bf16: tensor cores through wgmma, K/V tiles through TMA. Two kernels, the
// C entry's bf16_plan picking one by D: attn_fwd_ws for 64 < D <= 256,
// attn_fwd_wgmma for D <= 64 and D > 256. Above D = 64 both read q, k and v
// through TMA only: the C entry refuses a layout no tensor map describes,
// and the Python wrapper hands it a contiguous copy of such q, k and v
// instead (rows padded to a multiple of 8 elements; no shipped model makes
// one).
//
// attn_fwd_ws (64 < D <= 256): one block keeps the tensor
// cores busy by itself.
// - 384 threads: warpgroups 0 and 1 consume, each owning 64 rows of a
//   128-row Q tile and both reading every K/V tile, so a K/V byte brought
//   into shared memory serves twice the Q rows it served in attn_fwd_wgmma;
//   warpgroup 2 produces: one thread issues every TMA load, and the
//   warpgroup gives its registers to the consumers (setmaxnreg 24 / 240:
//   O takes 32 * NA f32 registers a consumer thread, 96 at D=192, 128 at
//   256, beside S's 32, P's 16 in bf16 and, up to D=192, Q's 16 * NA).
// - Q is loaded once as NA boxes of 128 rows (16 KB an atom; each consumer's
//   64 rows are 8 KB into it). Up to D=192 each consumer then holds its
//   rows as the A fragments of QK^T (ldmatrix from the swizzled tile) and
//   QK^T reads only K from shared memory: with both operands there, an
//   m64n64k16 product reads 4 KB for 32 cycles of tensor work, the SM's
//   whole shared-memory bandwidth.
// - K and V have rings of their own, ws_stages(NA) = 2 stages each, with a
//   full mbarrier (TMA's bytes) and an empty one (an arrival from each of
//   the 8 consumer warps) a stage. The producer loads K_0, then K_(j+1)
//   ahead of V_j, each as soon as its stage is released, so the loads of
//   tiles j+1 and j+2 overlap the products of tile j. Shared memory: Q + 2 K
//   + 2 V tiles = 6 * NA atoms: 97 KB at D <= 128, 145 KB at 192, 193 KB at
//   256 (under 232,448 B, one block an SM).
// - Softmax under the tensor cores: a consumer issues S_j = Q K_j^T and
//   O += P_(j-1) V_(j-1) as two wgmma groups, waits for the first only
//   (wait_group 1), releases K_j and runs tile j's online softmax in place
//   on S (f32) while PV runs; the next iteration waits for PV, releases
//   V_(j-1), rescales O and packs P_j to bf16. Nothing PV reads is written
//   while it runs (ptxas would serialise the products, C7513), and the
//   wait for PV sits behind the loop's back edge: within one block ptxas
//   hoists it above the softmax to interleave the rescale and the pack.
// - The two consumers take turns to issue their products (WS_PINGPONG,
//   named barriers 1 and 2), so that one's softmax runs under the other's
//   products.
// - PV is one m64n(64 NA)k16 product a k-step, over every atom of V (the
//   descriptor's leading byte offset steps the atoms), QK^T 4 * NA
//   m64n64k16 products, or 5 up to D=80 (DiT-XL's 72: 8 would multiply 48
//   columns of zeros).
// - The running max moves only when a row of the warp would pass it by more
//   than 2^8 (WS_RESCALE_LOG2): P stays below 256, and O is rescaled on
//   the few tiles where the max jumps, not on every tile.
// - Grid (ceil(N/128), B*H), no persistent scheduler: at [8,1024,4,192]
//   256 blocks fill 1.94 waves of 132 SMs (the last 124/132 full), at
//   [4,1024,4,192] and [4,1024,4,128] 128 blocks fill one.
// - scripts/torch_attention_variants.py times each of these choices
//   against its alternative (--wide), and --clock prints the cycles of
//   each phase of a key tile.
// - Epilogue: O / l in bf16 into the warpgroup's half of the Q tile (free by
//   then) in the swizzled layout, then TMA stores of whole rows (the
//   threads' own 4-byte stores, 16 bytes a row and sector, took 14-19 % of
//   a block's cycles at D=192); for D % 8 != 0 no tensor map describes o
//   and the threads store it as attn_fwd_wgmma does.
// - The products' fragments and the masking of keys past M are
//   attn_fwd_wgmma's (below), per consumer warpgroup.
//
// attn_fwd_wgmma (D <= 64 and D > 256):
// - One warpgroup (128 threads) per 64-row Q tile; grid (ceil(N/64), B*H).
// - One TMA tensor map per operand per launch, over the view's own shape and
//   strides as a 4-D tensor (D, H, rows, B), box (64, 1, 64, 1), 128-byte
//   swizzle. A box is one swizzle atom: 64 head columns, 128 bytes a row, the
//   widest box that swizzle takes. A tile of 64 rows is NA = ceil(D/64) atoms
//   (1 up to D=64, 3 at D=192, 4 at 256), one box each, 8 KB apart in shared
//   memory. TMA's out-of-bounds fill pads the columns past D with zeros in
//   shared memory only, so the swizzled layout that wgmma reads is the same
//   for every D. Ragged N and M tails get the same zero fill.
// - K and V tiles of 64 keys go through a ring, each stage with an mbarrier
//   that TMA completes; thread 0 refills a stage as soon as the warpgroup is
//   done with it. At D <= 64 the ring has two stages, so the load of tile j+1
//   overlaps the products of tile j, and shared memory stays at 41 KB: up to
//   five blocks share an SM (scripts/torch_attention_variants.py times a
//   4-stage ring). Above 256 it has one stage: the tiles of NA = 6 or 8
//   atoms leave room for one block an SM.
// - S = Q K^T: wgmma m64n64k16, A = Q and B = K from shared memory, both
//   K-major (D contiguous), KSTEPS k-steps of 16 columns (3 at D=48, 12 at
//   192; above 64, 4 * NA, the padding columns being zeros), f32 accumulate;
//   a k-step moves the descriptors 32 bytes inside an atom, 8 KB to the next.
// - Online softmax in registers: scores pre-scaled by log2(e)/sqrt(D) and
//   exponentiated with ex2.approx.ftz; a row lives in the 4 lanes of a quad,
//   so row max and sum take two shuffles. Keys past M get -inf.
// - O += P V: wgmma m64n64k16 with P as the register A operand (the S
//   accumulator's fragment is, pair by pair, the A fragment of the next
//   product, so P is packed to bf16 in place) and V from shared memory as an
//   MN-major B operand (D contiguous, transpose bit set), one m64n64 product
//   per atom of V into its own 32 accumulators: O costs 32 * NA registers a
//   thread (128 at D=256).
// - Epilogue: O / l in f32, rounded to bf16, stored to the strided o; rows
//   past N and columns past D are not stored.
// - Above D=256 (the VAE's single 512-wide head): O's 32 * NA registers would
//   pass the 255 a thread may hold, so a block owns NV = NA / 2 atoms of O's
//   columns, one grid dimension (z) over the two column slices. Each block
//   computes the full-D scores (Q and K tiles of NA atoms, 6 up to D=384, 8
//   up to 512) and multiplies P by its own slice of V only: the QK^T work
//   and the Q/K reads are done twice, which at one head costs the second
//   block's QK^T (half the operations of the call). Shared memory is one
//   stage of Q (NA atoms), K (NA) and V (NV): 160 KB + 1 KB at D=512, one
//   block an SM. Atoms of Q and K wholly past D (D=264 in 6 atoms) are never
//   loaded by TMA: the block zeroes them once, so their k-steps add nothing.
// - Up to D = 64, layouts a TMA tensor map cannot describe (a base not
//   16-byte aligned, or a batch, row or head stride that is not a multiple
//   of 8 elements: the head stride of 72 bytes at D=36 in DSUNet's
//   cross-attention fusion, the thirds of a fused qkv at such a D) take the
//   same kernel with its tiles loaded by the threads instead (template
//   TMA = false, NA = 1 only): every thread copies VEC elements at a time
//   (8 or 4 bytes by cp.async, 2 bytes through a register where nothing
//   wider is aligned) into the same 128-byte swizzled atoms TMA would write
//   (16-byte chunk c of row r lands at chunk c ^ (r % 8)), zeros past D and
//   past the ragged row tail. The ring, its stages and the products are
//   those of the TMA route; a stage is waited on with cp.async.wait_group,
//   a proxy fence and a block barrier instead of its mbarrier. The Python
//   wrapper picks VEC (0 = TMA) from the bases, the strides and D.
// It takes: D <= 512; up to D = 64 any strides with a contiguous last
// dimension, above it the layouts a TMA map describes.
// P enters the second product in bf16, as in jax.nn.dot_product_attention
// (probabilities cast to the value dtype).
//
// f32: three TF32 passes on the tensor cores. A single TF32 pass keeps ~11
// bits (an error of ~1e-3 at unit scale), so each operand is split,
// a = hi + lo, and a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b (lo lo, below
// 2^-22 relative, dropped), in both products: S = Q K^T and O += P V, P in
// f32. The C entry's f32_plan picks one of two kernels by D.
//
// attn_fwd_tf32x3_ws (64 < D <= 512, layouts a TMA map describes: 16-byte
// aligned bases, batch, row and head strides multiples of 4 floats; the C
// entry refuses others, the wrapper copies them as it does for bf16): wgmma
// .tf32, warp specialised, each K/V element split once a block.
// - 384 threads: warpgroups 0 and 1 consume; warpgroup 2 produces (warp 0's
//   first thread issues every TMA load, warps 1..3 split each atom once it
//   lands); setmaxnreg 72 / 216. Up to D = 256 consumer w owns Q rows
//   64w..64w+63 of a 128-row Q tile, so each K/V byte brought into shared
//   memory serves 128 rows; above 256 (SPLIT) O for 64 rows would take 256
//   registers a thread, so both own the same 64 rows, consumer w the O
//   columns and QK^T k-steps of the 32-column atoms a % 2 == w, and the two
//   add their partial scores through shared memory (no block or warpgroup
//   computes a score twice).
// - Tiles as 32-float (128-byte swizzle) atoms: Q by TMA once (NA atoms of
//   its rows), K and V through one ring of FW_STAGES = 8 atoms in the
//   order K_j's atoms, V_j's, K_(j+1)'s, with full (TMA), ready (the 96
//   splitting threads) and empty (one arrival a consumer warp)
//   mbarriers a stage. The TMA warp issues each load as soon as its slot is
//   free, so the loads run up to 8 atoms ahead of the consumers.
// - The split: the tensor cores read an f32 word as TF32 by dropping its
//   low 13 bits, so a raw atom as TMA wrote it serves as the hi operand and
//   lo = x - trunc(x) is exact in f32. A K atom's lo is written beside it
//   (the stage's second half), so [K; K_lo] is one B operand of 2 KT rows.
//   A V atom is transposed in place into V^T (keys contiguous: .tf32 wgmma
//   reads only K-major B operands, and V is MN-major for PV), each 8-key
//   step in the order S's accumulator hands P's A fragment its keys (0, 2,
//   4, 6, 1, 3, 5, 7), its lo beside it. The split works on 4 KB pieces (32
//   rows), an atom's loads before its stores; a consumer's Q lo and P lo
//   are split in its registers (Q's an atom at a time from shared memory,
//   which holds no Q lo).
// - Per key tile (KT = 64 keys up to D = 192; 32 above, where O's 128
//   registers a thread leave room for the scores of 32 keys only), a
//   consumer issues, an atom at a time, S += [Q_hi K^T | Q_hi K_lo^T] (ss,
//   m64n(2KT)k8 x 4 k-steps) then S += Q_lo K^T (rs, m64n(KT)k8), releasing
//   the previous atom once its products are done; S = the two halves' sum
//   (+ the other consumer's, SPLIT), keys past M -inf, an f32 online
//   softmax in log2 units (scale after the product, ex2.approx.ftz); then
//   O += P_lo V^T + P_hi V_lo^T + P_hi V^T (rs, m64n32k8 an atom of O's
//   columns, KT / 8 k-steps). A consumer holds at most two atoms, and both
//   see every atom in the ring's order (SPLIT: each releases the other's
//   unread): one that waited on its own only could wait on a slot's next
//   round before the current one completed, where the parity test passes.
// - Shared memory (Q + score exchange + 8 stages of raw and split atoms +
//   1 KB to align; 232,448 B a block): D <= 96: 48 + 0 + 128 KB; <= 128:
//   64 + 128 KB; <= 192: 96 + 128 KB (230,400 B); <= 256: 128 + 64 KB
//   (32-key atoms); <= 384: 96 + 32 + 64 KB; <= 512: 128 + 32 + 64 KB
//   (230,400 B). One block an SM.
// - FW_PV_WGMMA false puts PV on mma.sync over the raw V atom and its
//   element-wise lo (design (b); no transpose), FW_V_SPLIT_ONCE false has
//   every consumer warp split the V values it reads instead;
//   scripts/torch_attention_variants.py --f32 times both, the duplicated
//   scores above 256 (FW_SHARE_SCORES false) and the ablations, and
//   --f32 --clock prints the cycles of each phase (the FW_CLK hooks).
//
// attn_fwd_tf32x3 (D <= 64, every layout), mma.sync m16n8k8:
// - 4 warps (128 threads) per 64-row Q tile, one 16-row slab per warp; grid
//   (ceil(N/64), B*H). D is padded to a multiple of 8 (48 stays 48): DK =
//   ceil(D/8) k-steps of QK^T and n-tiles of PV.
// - hi = a rounded to TF32 (as cvt.rna.tf32.f32 rounds), lo = a - hi, both
//   split in registers after a load of raw f32 from shared memory, so
//   shared memory holds one f32 copy of each tile.
// - Q is pre-scaled by log2(e)/sqrt(D) before its split and held in
//   registers, split, for the whole run; the online softmax runs in f32
//   with ex2.approx.ftz, as the bf16 route.
// - S's accumulator is P's A fragment up to a permutation of the 8 keys of
//   each step, which PV's sum over keys does not see (see the kernel).
// - K/V tiles of 64 keys go through a 2-stage ring filled by cp.async: 16-byte
//   copies where the bases are 16-byte aligned and D and the strides are
//   multiples of 4 floats (the model's qkv thirds), else 4-byte copies; rows
//   padded to 8*DK + 4 floats keep fragment loads free of bank conflicts.
//   Shared memory: 5 tiles of 64 x (8*DK + 4) floats, 66,560 B at D=48.
//
// Bound on an H100 SXM at 700 W (989 TFLOP/s bf16, 495 TF32, 3.35 TB/s),
// batch 16, per call at the flagship's three shapes (FLOPs = 4*B*H*N*M*D;
// bytes = q, k, v and o read or written once):
//   bf16: [16, 1024, 4, 48]  12.9 GFLOP  25.2 MB  ~13 us   bound by operations
//         [16,  256, 6, 48]  1.21 GFLOP   9.4 MB  ~2.8 us  bound by bytes
//         [16,   64, 6, 48]  0.08 GFLOP   2.4 MB  ~0.7 us  bound by bytes
// The bf16 route runs both products on the tensor cores and reads each K/V
// tile once per Q tile through TMA; D=48 costs the tensor cores 3 k-steps of
// 16 in QK^T but a full n64 in PV. At D=48 a score costs the tensor cores
// ~190 FLOPs but the softmax ~5 CUDA-core instructions (max, fma, ex2, sum,
// half a pack), so the softmax's instruction issue, not the tensor cores,
// bounds this route: each of those is kept to one instruction, and enough
// blocks share an SM to hide the products' latency.
// f32: an f32-accurate product costs this card at least three TF32 passes,
// so the bound is max(3 * FLOPs / 495e12, bytes / 3.35e12), not FLOPs at the
// 67 TFLOP/s of the CUDA cores: [16, 1024, 4, 48] ~78 us (operations),
// [16, 256, 6, 48] ~7.3 us (operations), [16, 64, 6, 48] ~1.4 us (bytes);
// above D = 64 [8, 1024, 4, 192] ~156 us and [8, 1024, 1, 512] ~104 us
// (operations). On mma.sync every operand element costs three CUDA-core
// instructions to split once per warp that reads it, so the split and the
// softmax, not the tensor cores, bound attn_fwd_tf32x3. attn_fwd_tf32x3_ws
// splits each K/V element once a block, but that split (three warps, an
// atom's loads, then its stores) still paces the ring: it takes longer an
// atom than the consumers' products (PERF.md, --f32 --clock).
//
// Backward, bf16 and D <= 128 (every trained head of the shipped models
// below DisC-Diff's): attn_bwd_dq, then attn_bwd_dkdv. The JAX package has
// no backward kernel (ops/flash_attention.py:141 _fa_bwd differentiates the
// plain XLA math); these compute that math's VJP, the f32 one, with the
// scores kept on chip and every product on the tensor cores:
// - The gradient path's forward (the LSE template variant of the kernels
//   above, dsdiff_flash_attention_lse) also writes each row's log-sum-exp
//   in log2 units, so P = 2^(S log2(e)/sqrt(D) - LSE) is formed tile by tile
//   with no pass over a row. The serving launch keeps its instantiation.
// - attn_bwd_dq owns 128 query rows a block (Q and dO loaded once) and walks
//   the K/V tiles twice: first delta = rowsum(P dP) with dP = dO V^T, which
//   is the f32 math's value (a delta from the bf16 O cancels where dP is
//   nearly constant along a row), written for attn_bwd_dkdv; then
//   dQ = scale * sum_j dS_j K_j with dS = P (dP - delta), in f32 registers.
//   No atomics: dq is a sum in a fixed order, the same bits on every call.
// - attn_bwd_dkdv owns 128 key rows a block (K and V loaded once) and walks
//   the Q/dO tiles with their LSE and delta: S^T = K Q^T, dP^T = V dO^T,
//   dV += P^T dO and dK += scale * dS^T Q in f32 registers.
// - Both: 384 threads, two consumer warpgroups of 64 rows and a producer
//   warpgroup whose one thread issues every TMA load (a ring of 3 stages of
//   two 64-row tiles, full and empty mbarriers; the LSE and delta of a
//   column tile by bulk copy), setmaxnreg 24 / 240. S and dP are m64n64k16
//   wgmma with both operands in shared memory (128-byte swizzled atoms,
//   k-steps of 16 over D padded to 16: 5 at DiT-XL's 72, not the forward's
//   8); the outputs are m64n(D)k16 with the bf16 A operand in registers and
//   the tile MN-major, n = 72 at D = 72.
// - Precision: q, k, v and dO are bf16, so S and dP are exact products with
//   f32 sums. P and dS are f32 values; each enters its product as a bf16
//   high part and a bf16 low part (hi = bf16(x), lo = bf16(x - hi), |x - hi
//   - lo| <= 2^-17 |x|), two passes against the exact bf16 tile, as the f32
//   forward's tf32x3 keeps its products f32-accurate. A single bf16 P or dS
//   would be a lower precision than the configuration states.
// - The wrapper hands TMA-describable q, k, v, dO (D a multiple of 8,
//   16-byte aligned bases, strides multiples of 8 elements: the qkv thirds
//   at D = 72 and 48 as they are); others, such as a head of 36 whose
//   72-byte stride no map describes, as copies padded to a multiple of 8.
// Bound: the five products are 5 * 2 * B*H*N*M*D FLOPs (0.387 TFLOP at
// [32, 1024, 16, 72]: 0.39 ms at 989 TFLOP/s bf16); the kernels issue 12
// bf16 passes of 2 * B*H*N*M*D' (D' the padded reduction or n): S and dP
// twice in attn_bwd_dq and once in attn_bwd_dkdv, and two split passes of
// each output product, ~2.3 times the bound's operations.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, n, h;
};

// a bf16 operand [B, rows, H, D] as the thread-loaded route reads it
struct Operand {
  const __nv_bfloat16* p;
  Strides s;
};

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int WG = 128;                      // one warpgroup
constexpr int TILE = 64;                     // Q rows, and keys per K/V tile
constexpr int ATOM_BYTES = TILE * 64 * 2;    // 64 rows of one 128-byte atom
// K/V ring depth for a tile NA atoms wide
__host__ __device__ constexpr int wg_stages(int na) { return na == 1 ? 2 : 1; }
// Q tile (NA atoms) + the ring's K (NA) and V (NV) tiles, + 1024 to align the
// base
__host__ __device__ constexpr int wg_smem_bytes(int na, int nv) {
  return (na + wg_stages(na) * (na + nv)) * ATOM_BYTES + 1024;
}
static_assert(wg_smem_bytes(8, 4) <= 232448, "D=512 tiles above the block limit");

// Raise `kernel`'s dynamic shared memory cap to `smem` bytes where that is
// above the default 48 KB, once per device (it costs microseconds of host
// time a call); bit d of `done` records device d. Setting it twice from two
// threads is harmless.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, uint64_t& done) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) done |= bit;
  return err;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one (64 x 64) box at (d, h, row, b) of a 4-D map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int h, int row,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(row),
      "r"(b)
      : "memory");
}

// `atoms` atoms of a tile's rows [row, row + 64) from column col0 on: atom a
// holds columns col0 + 64a .. col0 + 64a + 63
__device__ __forceinline__ void tma_load_tile(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int col0,
                                              int atoms, int h, int row,
                                              int b) {
  for (int a = 0; a < atoms; ++a)
    tma_load(dst + a * ATOM_BYTES, map, bar, col0 + 64 * a, h, row, b);
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units; tiles are 1024-aligned, so
// the base offset field stays 0.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from moving register reads or writes across a wgmma
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define ACC32                                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define REGS32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}, "

// d (+)= A B, m64n64k16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC32
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, m64n64k16, A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : ACC32
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d (+)= A B, m64n64k16, A in registers, B K-major in shared memory
__device__ __forceinline__ void wgmma_rs_kmajor(float (&d)[32], uint32_t a0,
                                                uint32_t a1, uint32_t a2,
                                                uint32_t a3, uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : ACC32
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}

#undef ACC32
#undef REGS32

// 2^x as one special-function-unit op (exp2f adds range handling around
// it); results below 2^-126 flush to 0, far below a bf16 P's resolution
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// returns once at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows [row0, row0 + 64) of operand x at (b, h), columns [col0, col0 + 64 *
// atoms), into `atoms` 128-byte swizzled atoms at dst, the layout a TMA box
// with 128-byte swizzle writes: element (r, c) of an atom at byte r * 128 +
// ((c / 8) ^ (r % 8)) * 16 + (c % 8) * 2 (the tile 1024-aligned). Zeros past
// `rows` and past D. VEC elements a copy, VEC dividing D, the strides and
// the base's alignment in elements, so no copy straddles D or a 16-byte
// chunk: 4 and 2 by cp.async (8 and 4 bytes; a source size of 0 writes
// zeros), 1 through a register.
template <int VEC>
__device__ __forceinline__ void ld_tile_vec(uint32_t dst,
                                            const __nv_bfloat16* base,
                                            long long sn, int row0, int rows,
                                            int col0, int atoms, int D) {
  const int per_row = 64 * atoms / VEC;  // copies a tile row
  for (int idx = threadIdx.x; idx < TILE * per_row; idx += WG) {
    const int r = idx / per_row, c = VEC * (idx % per_row);
    const int cc = c % 64;
    const uint32_t addr = dst + (c / 64) * ATOM_BYTES + r * 128 +
                          (((cc / 8) ^ (r % 8)) << 4) + (cc % 8) * 2;
    const bool ok = row0 + r < rows && col0 + c < D;
    const __nv_bfloat16* src = ok ? base + (row0 + r) * sn + col0 + c : base;
    if constexpr (VEC == 4) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(addr),
                   "l"(src), "r"(ok ? 8 : 0)
                   : "memory");
    } else if constexpr (VEC == 2) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(addr),
                   "l"(src), "r"(ok ? 4 : 0)
                   : "memory");
    } else {
      unsigned short val = 0;
      if (ok) val = __ldg(reinterpret_cast<const unsigned short*>(src));
      asm volatile("st.shared.u16 [%0], %1;" ::"r"(addr), "h"(val) : "memory");
    }
  }
}

// ld_tile_vec for the launch's VEC (uniform over the grid)
__device__ __forceinline__ void ld_tile(uint32_t dst, const Operand& x,
                                        int vec, int b, int h, int row0,
                                        int rows, int col0, int atoms, int D) {
  const __nv_bfloat16* base = x.p + b * x.s.b + h * x.s.h;
  if (vec == 4)
    ld_tile_vec<4>(dst, base, x.s.n, row0, rows, col0, atoms, D);
  else if (vec == 2)
    ld_tile_vec<2>(dst, base, x.s.n, row0, rows, col0, atoms, D);
  else
    ld_tile_vec<1>(dst, base, x.s.n, row0, rows, col0, atoms, D);
}

// Accumulator fragment of wgmma m64nN (f32), thread t of the warpgroup:
// warp w = t / 32 owns rows 16w..16w+15; with g = (t % 32) / 4 and
// c = 2 * (t % 4), element 4i + 2r + e is (row 16w + g + 8r, col 8i + c + e).
// NA: 128-byte atoms a Q or K tile row spans; NV: atoms of O's columns this
// block owns (NA, or NA / 2 above D=256, blockIdx.z picking the slice);
// KSTEPS: k-steps of QK^T. TMA: tiles through the tensor maps tq, tk, tv;
// otherwise loaded by the threads from xq, xk, xv, `vec` elements a copy.
template <int NA, int NV, int KSTEPS, bool TMA, bool LSE>
__global__ void __launch_bounds__(WG)
attn_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, Operand xq,
               Operand xk, Operand xv, int vec,
               __nv_bfloat16* __restrict__ o, int H, int N, int M, int D,
               Strides ost, float scale_log2, float* __restrict__ lse,
               int npad) {
  constexpr int STAGES = wg_stages(NA);
  constexpr int TILE_BYTES = NA * ATOM_BYTES;
  constexpr int V_BYTES = NV * ATOM_BYTES;
  static_assert(KSTEPS <= 4 * NA, "k-steps past the tile");
  static_assert(NV == NA || 2 * NV == NA, "O's columns in one or two slices");
  static_assert(!LSE || NV == NA, "the row LSE from a block that owns all of O");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[STAGES + 1];  // K/V stages, then Q

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_smem = base;
  const auto k_smem = [&](int s) { return base + (1 + s) * TILE_BYTES; };
  const auto v_smem = [&](int s) {
    return base + (1 + STAGES) * TILE_BYTES + s * V_BYTES;
  };
  const uint32_t bar0 = smem_u32(bars);
  const auto bar = [&](int s) { return bar0 + 8u * s; };
  const uint32_t q_bar = bar(STAGES);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int n0 = blockIdx.x * TILE;
  const int ntiles = (M + TILE - 1) / TILE;
  // this block's first column of O (and of V); the atoms of Q/K and of V
  // that hold columns below D, the only ones TMA loads
  const int col0 = 64 * NV * blockIdx.z;
  const int qk_atoms = min(NA, (D + 63) / 64);
  const int v_atoms = min(NV, (D - col0 + 63) / 64);
  const uint32_t qk_bytes = qk_atoms * ATOM_BYTES;
  const uint32_t kv_bytes = qk_bytes + v_atoms * ATOM_BYTES;

  if (NA > 4 && qk_atoms < NA) {  // zero the Q and K atoms past D once: k-steps read them
    const uint4 zero = make_uint4(0, 0, 0, 0);
    constexpr int CHUNKS = ATOM_BYTES / 16;
    for (int t = 0; t <= STAGES; ++t) {
      const uint32_t tile = t == 0 ? q_smem : k_smem(t - 1);
      for (int i = tid; i < (NA - qk_atoms) * CHUNKS; i += WG)
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(
                         tile + qk_bytes + 16 * i),
                     "r"(zero.x), "r"(zero.y), "r"(zero.z), "r"(zero.w)
                     : "memory");
    }
    // make the generic-proxy stores visible to wgmma's async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  if constexpr (TMA) {
    if (tid == 0) {
      for (int s = 0; s <= STAGES; ++s) mbar_init(bar(s), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      mbar_expect_tx(q_bar, qk_bytes);
      tma_load_tile(q_smem, &tq, q_bar, 0, qk_atoms, h, n0, b);
      for (int s = 0; s < STAGES && s < ntiles; ++s) {
        mbar_expect_tx(bar(s), kv_bytes);
        tma_load_tile(k_smem(s), &tk, bar(s), 0, qk_atoms, h, s * TILE, b);
        tma_load_tile(v_smem(s), &tv, bar(s), col0, v_atoms, h, s * TILE, b);
      }
    }
  } else {
    // group s: K/V tile s (group 0 also Q); waited on in the loop
    ld_tile(q_smem, xq, vec, b, h, n0, N, 0, qk_atoms, D);
    for (int s = 0; s < STAGES; ++s) {
      if (s < ntiles) {
        ld_tile(k_smem(s), xk, vec, b, h, s * TILE, M, 0, qk_atoms, D);
        ld_tile(v_smem(s), xv, vec, b, h, s * TILE, M, col0, v_atoms, D);
      }
      cp_async_commit();
    }
  }

  float acc[NV][32], sc[32];  // acc[a]: O's columns col0+64a..col0+64a+63
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = 0.f;
#pragma unroll
    for (int a = 0; a < NV; ++a) acc[a][i] = 0.f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  const int c = 2 * (lane % 4);

  // Q and K: 8-row groups 1024 bytes apart (SBO); a k-step of 16 columns
  // moves the start 32 bytes inside the 128-byte swizzle atom, and every
  // fourth one to the next atom (8 KB on, 512 in the descriptor's 16-byte
  // units). V: the contraction runs over its rows, so a k-step of 16 keys
  // moves 2048 bytes; each product covers one atom's 64 columns, so the LBO
  // is never stepped.
  const uint64_t q_desc = make_desc(q_smem, 16, 1024);
  if constexpr (TMA) mbar_wait(q_bar, 0);

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % STAGES;
    if constexpr (TMA) {
      mbar_wait(bar(s), (j / STAGES) & 1);
    } else {
      cp_async_wait<STAGES - 1>();  // groups 0..j have landed
      // this thread's generic-proxy writes, visible to wgmma's async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
    }

    const uint64_t k_desc = make_desc(k_smem(s), 16, 1024);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int step = 512 * (kk / 4) + 2 * (kk % 4);
      wgmma_ss(sc, q_desc + step, k_desc + step, kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    if ((j + 1) * TILE > M) {  // ragged last tile: keys past M get -inf
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (j * TILE + 8 * i + c + e >= M)
            sc[4 * i + e] = sc[4 * i + 2 + e] = -INFINITY;
    }

    // online softmax: every row's first tile holds key 0, so m_run is
    // finite from the first tile on and alpha = exp2(-inf) = 0 there
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mt = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        mt = fmaxf(mt, fmaxf(sc[4 * i + 2 * r], sc[4 * i + 2 * r + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m_run[r], mt * scale_log2);
      alpha[r] = exp2_ftz(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
    uint32_t p[16];  // P in bf16, A fragments: p[4kk..4kk+3] for keys 16kk..
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = exp2_ftz(fmaf(sc[4 * i + 2 * r], scale_log2, -m_run[r]));
        const float p1 =
            exp2_ftz(fmaf(sc[4 * i + 2 * r + 1], scale_log2, -m_run[r]));
        l_run[r] += p0 + p1;
        p[2 * i + r] = pack_bf16(p0, p1);
#pragma unroll
        for (int a = 0; a < NV; ++a) {
          acc[a][4 * i + 2 * r] *= alpha[r];
          acc[a][4 * i + 2 * r + 1] *= alpha[r];
        }
      }
    }

#pragma unroll
    for (int a = 0; a < NV; ++a) fence_regs(acc[a]);
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < NV; ++a) {
      const uint64_t v_desc =
          make_desc(v_smem(s) + a * ATOM_BYTES, ATOM_BYTES, 1024);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc[a], p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                 p[4 * kk + 3], v_desc + 128 * kk);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int a = 0; a < NV; ++a) fence_regs(acc[a]);

    __syncthreads();  // every warp is done with stage s: refill it
    const int row = (j + STAGES) * TILE;
    if constexpr (TMA) {
      if (tid == 0 && j + STAGES < ntiles) {
        mbar_expect_tx(bar(s), kv_bytes);
        tma_load_tile(k_smem(s), &tk, bar(s), 0, qk_atoms, h, row, b);
        tma_load_tile(v_smem(s), &tv, bar(s), col0, v_atoms, h, row, b);
      }
    } else {
      if (j + STAGES < ntiles) {
        ld_tile(k_smem(s), xk, vec, b, h, row, M, 0, qk_atoms, D);
        ld_tile(v_smem(s), xv, vec, b, h, row, M, col0, v_atoms, D);
      }
      cp_async_commit();  // group j + STAGES (empty past the last tile)
    }
  }

  __nv_bfloat16* ob = o + b * ost.b + h * ost.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv_l = 1.f / l;
    const int row = n0 + 16 * warp + lane / 4 + 8 * r;
    if (LSE && lane % 4 == 0 && row < npad)
      lse[static_cast<long long>(blockIdx.y) * npad + row] =
          row < N ? m_run[r] + log2f(l) : INFINITY;
    if (row >= N) continue;
    __nv_bfloat16* orow = ob + row * ost.n;
#pragma unroll
    for (int a = 0; a < NV; ++a)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = col0 + 64 * a + 8 * i + c;
        const float v0 = acc[a][4 * i + 2 * r] * inv_l;
        const float v1 = acc[a][4 * i + 2 * r + 1] * inv_l;
        if (D % 2 == 0) {  // col even and < D: col + 1 < D, 4-byte aligned
          if (col < D)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < D) orow[col] = __float2bfloat16(v0);
          if (col + 1 < D) orow[col + 1] = __float2bfloat16(v1);
        }
      }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// [B, rows, H, D] bf16 with element strides s -> 4-D map (D, H, rows, B),
// box (64, 1, box_rows, 1), 128-byte swizzle, zero fill out of bounds
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int B,
                int rows, int H, int D, Strides s, int box_rows = TILE) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)rows,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s.h * 2, (cuuint64_t)s.n * 2,
                                 (cuuint64_t)s.b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// the bf16 route's inputs: tensor maps (TMA) or operands and vec (loaded by
// the threads)
struct WgmmaArgs {
  CUtensorMap tq, tk, tv;
  Operand q, k, v;
  int vec;
  // attn_fwd_ws: o's map (contiguous [B, N, H, D], box (64, 1, 64, 1)) where
  // D % 8 == 0 makes its strides 16-byte multiples, else o_tma = 0
  CUtensorMap to;
  int o_tma;
};

template <int NA, int KSTEPS, int NV, bool TMA, bool LSE = false>
int launch_wgmma_as(const WgmmaArgs& a, __nv_bfloat16* o, int B, int H,
                    int N, int M, int D, Strides os, float scale_log2,
                    cudaStream_t st, float* lse = nullptr, int npad = 0) {
  constexpr int smem = wg_smem_bytes(NA, NV);
  const auto kernel = attn_fwd_wgmma<NA, NV, KSTEPS, TMA, LSE>;
  static uint64_t opted_in = 0;
  const cudaError_t err = allow_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + TILE - 1) / TILE, B * H, NA / NV);
  kernel<<<grid, WG, smem, st>>>(a.tq, a.tk, a.tv, a.q, a.k, a.v, a.vec, o, H,
                                 N, M, D, os, scale_log2, lse, npad);
  return static_cast<int>(cudaGetLastError());
}

// D <= 64: the TMA instantiation where vec is 0, else the threads' loads
template <int NA, int KSTEPS, int NV = NA, bool LSE = false>
int launch_wgmma(const WgmmaArgs& a, __nv_bfloat16* o, int B, int H, int N,
                 int M, int D, Strides os, float scale_log2, cudaStream_t st,
                 float* lse = nullptr, int npad = 0) {
  if (a.vec == 0)
    return launch_wgmma_as<NA, KSTEPS, NV, true, LSE>(a, o, B, H, N, M, D, os,
                                                      scale_log2, st, lse, npad);
  return launch_wgmma_as<NA, KSTEPS, NV, false, LSE>(a, o, B, H, N, M, D, os,
                                                     scale_log2, st, lse, npad);
}

// ---------------------------------------------------------------------------
// bf16, 64 < D <= 256: warp-specialised (attn_fwd_ws)
// ---------------------------------------------------------------------------

constexpr int WS_CONSUMERS = 2;                    // warpgroups, 64 Q rows each
constexpr int WS_ROWS = WS_CONSUMERS * TILE;       // Q rows a block
constexpr int WS_THREADS = (WS_CONSUMERS + 1) * WG;  // + the producer's
// K and V ring depth (each ring has its own stages) for a tile NA atoms wide
__host__ __device__ constexpr int ws_stages(int na) { return 2; }
// Q (WS_ROWS rows of NA atoms) + the rings' K and V tiles, + 1024 to align
__host__ __device__ constexpr int ws_smem_bytes(int na) {
  return (WS_CONSUMERS + 2 * ws_stages(na)) * na * ATOM_BYTES + 1024;
}
static_assert(ws_smem_bytes(4) <= 232448, "D=256 tiles above the block limit");
// whether the two consumer warpgroups take turns to issue their products
// (named barriers 1 and 2), so that one's softmax runs under the other's
constexpr bool WS_PINGPONG = true;

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// whether a consumer holds its 64 rows of Q in registers (the A fragments
// of QK^T, 16 registers an atom: 48 at D=192) rather than reading them
// from shared memory at every product: an m64n64k16 product with both
// operands in shared memory reads 4 KB for 32 cycles of tensor work, the
// SM's whole shared-memory bandwidth. At D=256 O's 128 registers leave no
// room for Q's 64.
__host__ __device__ constexpr bool ws_q_regs(int na) { return na <= 3; }

// Q's A fragments for k-step kk from the 128-byte-swizzled Q tile (atoms
// 16 KB apart, this warpgroup's 64 rows at q_rows): ldmatrix.x4, lane l
// giving row 8 (l / 8 % 2) + l % 8 of the warp's 16 and 16-byte chunk
// 2 (kk % 4) + l / 16 of atom kk / 4, returns a0..a3 as wgmma reads them
__device__ __forceinline__ void ws_q_frag(uint32_t q_rows, int warp, int lane,
                                          int kk, uint32_t (&f)[4]) {
  const int row = 16 * warp + 8 * (lane / 8 % 2) + lane % 8;
  const int chunk = 2 * (kk % 4) + lane / 16;
  const uint32_t addr = q_rows + (kk / 4) * (WS_CONSUMERS * ATOM_BYTES) +
                        row * 128 + ((chunk ^ (row % 8)) << 4);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
      : "r"(addr)
      : "memory");
}

// S = Q K^T for one warpgroup's 64 rows, K's atoms 64 rows (8 KB) apart, a
// k-step of 16 columns 32 bytes inside an atom; Q from the registers qf
// where ws_q_regs(NA), else from shared memory at q_desc (atoms 16 KB
// apart)
template <int NA, int KSTEPS>
__device__ __forceinline__ void ws_qk(
    float (&sc)[32], const uint32_t (&qf)[ws_q_regs(NA) ? KSTEPS : 1][4],
    uint64_t q_desc, uint64_t k_desc) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const uint64_t k_step = k_desc + 512 * (kk / 4) + 2 * (kk % 4);
    if constexpr (ws_q_regs(NA))
      wgmma_rs_kmajor(sc, qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3], k_step,
                      kk);
    else
      wgmma_ss(sc, q_desc + 1024 * (kk / 4) + 2 * (kk % 4), k_step, kk);
  }
}

// d += A B, m64n(64 NA)k16: A in registers, B MN-major in shared memory
// with its 64-column atoms ATOM_BYTES apart (the descriptor's leading byte
// offset), d the NA atoms' accumulators in a row (the fragment of column
// 64a + x is acc[a]'s of column x)
template <int NA>
__device__ __forceinline__ void wgmma_rs_wide(float (&d)[NA][32],
                                              const uint32_t (&a)[4],
                                              uint64_t b);
#define ACC_ATOM(a)                                                         \
  "+f"(d[a][0]), "+f"(d[a][1]), "+f"(d[a][2]), "+f"(d[a][3]),              \
      "+f"(d[a][4]), "+f"(d[a][5]), "+f"(d[a][6]), "+f"(d[a][7]),          \
      "+f"(d[a][8]), "+f"(d[a][9]), "+f"(d[a][10]), "+f"(d[a][11]),        \
      "+f"(d[a][12]), "+f"(d[a][13]), "+f"(d[a][14]), "+f"(d[a][15]),      \
      "+f"(d[a][16]), "+f"(d[a][17]), "+f"(d[a][18]), "+f"(d[a][19]),      \
      "+f"(d[a][20]), "+f"(d[a][21]), "+f"(d[a][22]), "+f"(d[a][23]),      \
      "+f"(d[a][24]), "+f"(d[a][25]), "+f"(d[a][26]), "+f"(d[a][27]),      \
      "+f"(d[a][28]), "+f"(d[a][29]), "+f"(d[a][30]), "+f"(d[a][31])
template <>
__device__ __forceinline__ void wgmma_rs_wide<2>(float (&d)[2][32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC_ATOM(0), ACC_ATOM(1)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_wide<3>(float (&d)[3][32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : ACC_ATOM(0), ACC_ATOM(1), ACC_ATOM(2)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_wide<4>(float (&d)[4][32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : ACC_ATOM(0), ACC_ATOM(1), ACC_ATOM(2), ACC_ATOM(3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef ACC_ATOM

// O += P V: one m64n(64 NA)k16 product a k-step of 16 keys over every atom
// of V (MN-major), P the register A operand
template <int NA>
__device__ __forceinline__ void ws_pv(float (&acc)[NA][32],
                                      const uint32_t (&p)[16],
                                      uint32_t v_tile) {
  const uint64_t v_desc = make_desc(v_tile, ATOM_BYTES, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3]};
    wgmma_rs_wide<NA>(acc, a, v_desc + 128 * kk);
  }
}

// The running max moves only when a row of the warp would pass it by more
// than this (log2 units): until then P = 2^(s - m_run) stays below 2^8,
// which bf16 and the f32 sums hold with the same relative precision, and O
// and the row sums need no rescale (softmax is the same for any max
// subtracted)
constexpr float WS_RESCALE_LOG2 = 8.f;

// Key tile j's scores into P, in place and in f32, by the online softmax:
// keys past M get -inf; where a row of the warp passes its running max by
// more than WS_RESCALE_LOG2 (always on the first tile), every row of the
// warp takes its new max, the row sums are rescaled and alpha is the factor
// O must be rescaled by before tile j's product is added to it; returns
// whether that happened (the same in every lane). P is packed to bf16
// (ws_pack) only once no product is in flight: a register written while PV
// still reads the other P buffer makes ptxas serialise the wgmma pipeline
// (C7513).
__device__ __forceinline__ bool ws_softmax(float (&sc)[32], int j, int M,
                                           int c, float scale_log2,
                                           float (&m_run)[2],
                                           float (&l_run)[2],
                                           float (&alpha)[2]) {
  if ((j + 1) * TILE > M) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (j * TILE + 8 * i + c + e >= M)
          sc[4 * i + e] = sc[4 * i + 2 + e] = -INFINITY;
  }
  float mt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mt[r] = -INFINITY;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      mt[r] = fmaxf(mt[r], fmaxf(sc[4 * i + 2 * r], sc[4 * i + 2 * r + 1]));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
    mt[r] *= scale_log2;
  }
  const bool rescale =
      __any_sync(0xffffffffu, mt[0] > m_run[0] + WS_RESCALE_LOG2 ||
                                  mt[1] > m_run[1] + WS_RESCALE_LOG2);
  if (rescale) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], mt[r]);
      alpha[r] = exp2_ftz(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float p0 = exp2_ftz(fmaf(sc[4 * i + 2 * r], scale_log2, -m_run[r]));
      const float p1 =
          exp2_ftz(fmaf(sc[4 * i + 2 * r + 1], scale_log2, -m_run[r]));
      l_run[r] += p0 + p1;
      sc[4 * i + 2 * r] = p0;
      sc[4 * i + 2 * r + 1] = p1;
    }
  return rescale;
}

// O's rows r = 0 (g) and 1 (g + 8) times alpha[r]
template <int NA>
__device__ __forceinline__ void ws_rescale(float (&acc)[NA][32],
                                           const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int a = 0; a < NA; ++a) acc[a][i] *= alpha[(i / 2) % 2];
}

// P (in sc) to bf16 A fragments: p[4kk..4kk+3] for keys 16kk..16kk+15
__device__ __forceinline__ void ws_pack(const float (&sc)[32],
                                        uint32_t (&p)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
}

// Warp-specialised block of WS_THREADS: warpgroups 0 and 1 consume (rows
// 64w..64w+63 of the 128-row Q tile each, sharing every K/V tile), warpgroup
// 2 produces (one thread issues every TMA load). K and V have rings of their
// own, each stage with a full mbarrier (TMA's bytes) and an empty one (one
// arrival per consumer warp). A consumer issues S_j = Q K_j^T and
// O += P_(j-1) V_(j-1) together, waits for S_j only and runs tile j's
// softmax in place on S while the tensor cores finish PV; the next
// iteration waits for PV, rescales O and packs P_j.
template <int NA, int KSTEPS, bool LSE>
__global__ void __launch_bounds__(WS_THREADS, 1)
attn_fwd_ws(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap to, int o_tma,
            __nv_bfloat16* __restrict__ o, int H, int N, int M, int D,
            Strides ost, float scale_log2, float* __restrict__ lse,
            int npad) {
  constexpr int STAGES = ws_stages(NA);
  constexpr int KV_BYTES = NA * ATOM_BYTES;  // a K or V tile; Q is two
  static_assert(4 * NA - 4 < KSTEPS && KSTEPS <= 4 * NA,
                "k-steps reach into the last atom");
  extern __shared__ uint8_t smem_raw[];
  // Q, then per stage of each ring a full and an empty barrier
  __shared__ __align__(8) uint64_t bars[1 + 4 * STAGES];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_smem = base;
  const auto k_smem = [&](int s) {
    return base + (WS_CONSUMERS + s) * KV_BYTES;
  };
  const auto v_smem = [&](int s) {
    return base + (WS_CONSUMERS + STAGES + s) * KV_BYTES;
  };
  const uint32_t q_full = smem_u32(bars);
  const auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  const auto v_full = [&](int s) { return q_full + 8u * (1 + STAGES + s); };
  const auto k_empty = [&](int s) {
    return q_full + 8u * (1 + 2 * STAGES + s);
  };
  const auto v_empty = [&](int s) {
    return q_full + 8u * (1 + 3 * STAGES + s);
  };

  const int wg = threadIdx.x / WG;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int n0 = blockIdx.x * WS_ROWS;
  const int ntiles = (M + TILE - 1) / TILE;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 4 * WS_CONSUMERS);
      mbar_init(v_empty(s), 4 * WS_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == WS_CONSUMERS) {
    // producer: K_0, then K_(j+1) ahead of V_j; a stage is refilled once
    // every consumer warp has released it (the first round passes at once)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == WS_CONSUMERS * WG) {
      mbar_expect_tx(q_full, WS_CONSUMERS * KV_BYTES);
      for (int a = 0; a < NA; ++a)  // one 128-row box an atom
        tma_load(q_smem + a * WS_CONSUMERS * ATOM_BYTES, &tq, q_full, 64 * a,
                 h, n0, b);
      for (int j = 0; j <= ntiles; ++j) {
        if (j < ntiles) {
          const int s = j % STAGES;
          mbar_wait(k_empty(s), ((j / STAGES) & 1) ^ 1);
          mbar_expect_tx(k_full(s), KV_BYTES);
          tma_load_tile(k_smem(s), &tk, k_full(s), 0, NA, h, j * TILE, b);
        }
        if (j > 0) {
          const int i = j - 1, s = i % STAGES;
          mbar_wait(v_empty(s), ((i / STAGES) & 1) ^ 1);
          mbar_expect_tx(v_full(s), KV_BYTES);
          tma_load_tile(v_smem(s), &tv, v_full(s), 0, NA, h, i * TILE, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int c = 2 * (lane % 4);
    // with WS_PINGPONG, warpgroup w issues its products after bar.sync on
    // barrier 1 + w and hands the turn over by arriving on the other's
    const auto turn_wait = [&] {
      if constexpr (WS_PINGPONG) named_sync(1 + wg, WS_CONSUMERS * WG);
    };
    const auto turn_pass = [&] {
      if constexpr (WS_PINGPONG) named_arrive(2 - wg, WS_CONSUMERS * WG);
    };
    if (WS_PINGPONG && wg == 1) named_arrive(1, WS_CONSUMERS * WG);

    float acc[NA][32], sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = 0.f;
#pragma unroll
      for (int a = 0; a < NA; ++a) acc[a][i] = 0.f;
    }
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
    float alpha[2];
    bool rescale;    // whether O takes alpha before the next PV
    uint32_t p[16];  // P in bf16, the A operand of PV
    // this warpgroup's 64 rows: 8 KB into each 16 KB atom of the Q tile
    const uint64_t q_desc = make_desc(q_smem + wg * ATOM_BYTES, 16, 1024);
    mbar_wait(q_full, 0);
    uint32_t qf[ws_q_regs(NA) ? KSTEPS : 1][4];
    if constexpr (ws_q_regs(NA)) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        ws_q_frag(q_smem + wg * ATOM_BYTES, warp, lane, kk, qf[kk]);
    }

    // tile 0: S only
    mbar_wait(k_full(0), 0);
    turn_wait();
    fence_regs(sc);
    wgmma_fence();
    ws_qk<NA, KSTEPS>(sc, qf, q_desc, make_desc(k_smem(0), 16, 1024));
    wgmma_commit();
    turn_pass();
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(k_empty(0));
    rescale = ws_softmax(sc, 0, M, c, scale_log2, m_run, l_run, alpha);

    // Tile j's softmax runs at the end of an iteration, under PV of tile
    // j - 1; the wait for that PV, the rescale of O and the pack of P_j open
    // the next iteration. The loop's back edge keeps ptxas from hoisting
    // the wait into the softmax, as it does within one block to interleave
    // the rescale and the pack with it.
#pragma unroll 1
    for (int j = 1; j < ntiles; ++j) {
      const int s = j % STAGES, sp = (j - 1) % STAGES;
      wgmma_wait<0>();  // PV of tile j - 2
      fence_regs(p);
#pragma unroll
      for (int a = 0; a < NA; ++a) fence_regs(acc[a]);
      if (j > 1 && lane == 0) mbar_arrive(v_empty((j - 2) % STAGES));
      if (rescale) ws_rescale<NA>(acc, alpha);
      ws_pack(sc, p);
      mbar_wait(k_full(s), (j / STAGES) & 1);
      turn_wait();
      fence_regs(sc);
      fence_regs(p);
#pragma unroll
      for (int a = 0; a < NA; ++a) fence_regs(acc[a]);
      wgmma_fence();
      ws_qk<NA, KSTEPS>(sc, qf, q_desc, make_desc(k_smem(s), 16, 1024));
      wgmma_commit();
      mbar_wait(v_full(sp), ((j - 1) / STAGES) & 1);
      ws_pv<NA>(acc, p, v_smem(sp));
      wgmma_commit();
      turn_pass();
      wgmma_wait<1>();  // S_j; PV of tile j - 1 may still run
      fence_regs(sc);
      if (lane == 0) mbar_arrive(k_empty(s));
      rescale = ws_softmax(sc, j, M, c, scale_log2, m_run, l_run, alpha);
    }

    // the last tile's PV (V of tile ntiles - 2 released: with one stage the
    // producer waits for it to load the last V)
    const int sl = (ntiles - 1) % STAGES;
    wgmma_wait<0>();
    fence_regs(p);
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_regs(acc[a]);
    if (ntiles > 1 && lane == 0) mbar_arrive(v_empty((ntiles - 2) % STAGES));
    if (rescale) ws_rescale<NA>(acc, alpha);
    ws_pack(sc, p);
    mbar_wait(v_full(sl), ((ntiles - 1) / STAGES) & 1);
    turn_wait();
    fence_regs(p);
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_regs(acc[a]);
    wgmma_fence();
    ws_pv<NA>(acc, p, v_smem(sl));
    wgmma_commit();
    turn_pass();
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_regs(acc[a]);
    // warpgroup 1's first arrival on barrier 1 is matched here
    if (WS_PINGPONG && wg == 0) named_sync(1, WS_CONSUMERS * WG);

    float inv_l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv_l[r] = 1.f / l;
      const int row = n0 + TILE * wg + 16 * warp + lane / 4 + 8 * r;
      if (LSE && lane % 4 == 0 && row < npad)
        lse[static_cast<long long>(blockIdx.y) * npad + row] =
          row < N ? m_run[r] + log2f(l) : INFINITY;
    }
    if (o_tma) {
      // O through shared memory and TMA stores of whole 128-byte rows (the
      // threads' own stores write 16 bytes a row and sector): this
      // warpgroup's 64 rows as NA swizzled atoms in its half of the Q tile,
      // which nothing reads any more
      const uint32_t o_tile = q_smem + wg * ATOM_BYTES;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + lane / 4 + 8 * r;
#pragma unroll
        for (int a = 0; a < NA; ++a)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const uint32_t v = pack_bf16(acc[a][4 * i + 2 * r] * inv_l[r],
                                         acc[a][4 * i + 2 * r + 1] * inv_l[r]);
            asm volatile("st.shared.b32 [%0], %1;" ::"r"(
                             o_tile + a * WS_CONSUMERS * ATOM_BYTES + row * 128 +
                             ((i ^ (row % 8)) << 4) + 2 * c),
                         "r"(v)
                         : "memory");
          }
      }
      // the threads' generic-proxy stores, visible to TMA's async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync(3 + wg, WG);
      const int row0 = n0 + TILE * wg;
      if (tid == 0 && row0 < N) {
        for (int a = 0; a < NA; ++a)
          asm volatile(
              "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
              "[%0, {%2, %3, %4, %5}], [%1];" ::"l"(
                  reinterpret_cast<uint64_t>(&to)),
              "r"(o_tile + a * WS_CONSUMERS * ATOM_BYTES), "r"(64 * a), "r"(h),
              "r"(row0), "r"(b)
              : "memory");
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        // shared memory must outlive the copies' reads of it
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
      return;
    }
    __nv_bfloat16* ob = o + b * ost.b + h * ost.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = n0 + TILE * wg + 16 * warp + lane / 4 + 8 * r;
      if (row >= N) continue;
      __nv_bfloat16* orow = ob + row * ost.n;
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = 64 * a + 8 * i + c;
          const float v0 = acc[a][4 * i + 2 * r] * inv_l[r];
          const float v1 = acc[a][4 * i + 2 * r + 1] * inv_l[r];
          if (D % 2 == 0) {  // col even and < D: col + 1 < D, 4-byte aligned
            if (col < D)
              *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                  __floats2bfloat162_rn(v0, v1);
          } else {
            if (col < D) orow[col] = __float2bfloat16(v0);
            if (col + 1 < D) orow[col + 1] = __float2bfloat16(v1);
          }
        }
    }
  }
}

template <int NA, int KSTEPS, bool LSE = false>
int launch_ws(const WgmmaArgs& a, __nv_bfloat16* o, int B, int H, int N,
              int M, int D, Strides os, float scale_log2, cudaStream_t st,
              float* lse = nullptr, int npad = 0) {
  constexpr int smem = ws_smem_bytes(NA);
  const auto kernel = attn_fwd_ws<NA, KSTEPS, LSE>;
  static uint64_t opted_in = 0;
  const cudaError_t err = allow_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + WS_ROWS - 1) / WS_ROWS, B * H);
  kernel<<<grid, WS_THREADS, smem, st>>>(a.tq, a.tk, a.tv, a.to, a.o_tma, o,
                                         H, N, M, D, os, scale_log2, lse,
                                         npad);
  return static_cast<int>(cudaGetLastError());
}

// Which bf16 kernel takes D, and its tiles: `ws` attn_fwd_ws (64 < D <=
// 256), else attn_fwd_wgmma; NA atoms a Q/K row, NV atoms of O a block,
// KSTEPS k-steps of QK^T
struct Bf16Plan {
  bool ws;
  int na, nv, ksteps;
};

Bf16Plan bf16_plan(int D) {
  if (D <= 64) return {false, 1, 1, (D + 15) / 16};
  if (D <= 256) {
    const int na = (D + 63) / 64;
    // up to D=80 (DiT-XL's 72): QK^T over 5 k-steps, not 8
    return {true, na, na, D <= 80 ? 5 : 4 * na};
  }
  // above 256: two blocks a Q tile, each owning half of O's columns
  if (D <= 384) return {false, 6, 3, 24};
  return {false, 8, 4, 32};
}

// ---------------------------------------------------------------------------
// f32: three TF32 passes on the tensor cores, mma.sync m16n8k8 (D <= 64)
// ---------------------------------------------------------------------------

constexpr int F_WARPS = 4;  // one 16-row slab of the 64-row Q tile per warp
constexpr int F_THREADS = 32 * F_WARPS;
constexpr int F_STAGES = 2;  // K/V ring depth
// Row stride of a tile in shared memory, in floats, for a head dimension
// padded to 8 * DK: 8 * DK + 4 is 4 modulo 8, so the 8 rows x 4 columns of a
// K or Q fragment load, and the 4 row pairs x 8 columns of a V fragment
// load, fall on 32 distinct banks.
__host__ __device__ constexpr int f_ld(int dk) { return 8 * dk + 4; }
__host__ __device__ constexpr int f_tile_floats(int dk) {
  return TILE * f_ld(dk);
}
// Q tile + the ring's K and V tiles
__host__ __device__ constexpr int f_smem_bytes(int dk) {
  return (1 + 2 * F_STAGES) * f_tile_floats(dk) * 4;
}
static_assert(f_smem_bytes(8) <= 232448, "D=64 tiles above the block limit");

// x = hi + lo: hi is x rounded to TF32's 10 mantissa bits (to nearest,
// ties away from zero, as cvt.rna.tf32.f32 rounds, here in two integer
// instructions); lo = x - hi is exact in f32 and enters the tensor cores as
// raw f32 bits, whose low 13 bits they ignore, so what they multiply is
// within 2^-21 of x
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b, m16n8k8, TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b to f32 accuracy (3xTF32): the two small cross terms first, then
// hi * hi; lo * lo (below 2^-22 relative) is dropped
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           uint32_t b0_hi, uint32_t b1_hi,
                                           uint32_t b0_lo, uint32_t b1_lo) {
  mma_tf32(d, a_lo, b0_hi, b1_hi);
  mma_tf32(d, a_hi, b0_lo, b1_lo);
  mma_tf32(d, a_hi, b0_hi, b1_hi);
}

// global -> shared copies that skip the registers; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// Rows [r0, r0 + TILE) of a [rows, D] slab (row stride sn floats) into a
// [TILE][f_ld(DK)] tile at dst, zeros past the ragged row tail and in the
// padding columns D..8*DK-1. VEC: 16-byte copies (the base is 16-byte
// aligned and sn and D are multiples of 4); otherwise 4-byte copies.
template <int DK, bool VEC>
__device__ __forceinline__ void load_tile_f32(uint32_t dst,
                                              const float* __restrict__ base,
                                              long long sn, int r0, int rows,
                                              int D) {
  constexpr int LD = f_ld(DK);
  constexpr int W = VEC ? 4 : 1;       // floats per copy
  constexpr int PER_ROW = 8 * DK / W;  // copies per tile row
  for (int idx = threadIdx.x; idx < TILE * PER_ROW; idx += F_THREADS) {
    const int r = idx / PER_ROW, c = W * (idx % PER_ROW);
    const bool ok = r0 + r < rows && c < D;
    const float* src = ok ? base + (r0 + r) * sn + c : base;
    if constexpr (VEC)
      cp_async16(dst + 4 * (r * LD + c), src, ok ? 16 : 0);
    else
      cp_async4(dst + 4 * (r * LD + c), src, ok ? 4 : 0);
  }
}

// Q's A fragment of k-step kk (rows g and g + 8 of the warp's slab at qr,
// row stride LD), pre-scaled and split
template <int LD>
__device__ __forceinline__ void q_frag_tf32(const float* qr, int kk,
                                            float scale, uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
  split_tf32(qr[8 * kk] * scale, hi[0], lo[0]);
  split_tf32(qr[8 * LD + 8 * kk] * scale, hi[1], lo[1]);
  split_tf32(qr[8 * kk + 4] * scale, hi[2], lo[2]);
  split_tf32(qr[8 * LD + 8 * kk + 4] * scale, hi[3], lo[3]);
}

// Key tile j's scores sc into P: keys past M (the ragged last tile) get
// -inf, then the online softmax in log2 units moves the running max and
// row sums and rescales the DV accumulator n-tiles. Rows g (r = 0) and
// g + 8 (r = 1) live in the 4 lanes of a quad. Every row's first tile
// holds key 0, so m_run is finite from the first tile on and
// alpha = exp2(-inf) = 0.
template <int DV>
__device__ __forceinline__ void softmax_tile(float (&sc)[8][4], int j, int M,
                                             int t, float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&acc)[DV][4]) {
  if ((j + 1) * TILE > M) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (j * TILE + 8 * n + 2 * t + e >= M)
          sc[n][e] = sc[n][2 + e] = -INFINITY;
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mt = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      mt = fmaxf(mt, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m_run[r], mt);
    alpha[r] = exp2_ftz(m_run[r] - m_new);
    m_run[r] = m_new;
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[n][e] = exp2_ftz(sc[n][e] - m_run[e / 2]);
      l_run[e / 2] += sc[n][e];
    }
#pragma unroll
  for (int dn = 0; dn < DV; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] *= alpha[e / 2];
}

// acc += P V over DV n-tiles of the V tile at vt (row stride LD), P in f32
// split like the other operands
template <int DV, int LD>
__device__ __forceinline__ void pv_tf32x3(float (&acc)[DV][4],
                                          const float (&sc)[8][4],
                                          const float* vt, int g, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    uint32_t ph[4], pl[4];
    split_tf32(sc[n][0], ph[0], pl[0]);  // (g, key 2t)    as a0 (g, t)
    split_tf32(sc[n][2], ph[1], pl[1]);  // (g+8, key 2t)  as a1 (g+8, t)
    split_tf32(sc[n][1], ph[2], pl[2]);  // (g, key 2t+1)  as a2 (g, t+4)
    split_tf32(sc[n][3], ph[3], pl[3]);  // (g+8, key 2t+1) as a3
    const float* vr = vt + (8 * n + 2 * t) * LD + g;  // V[key 8n+2t][d g]
#pragma unroll
    for (int dn = 0; dn < DV; ++dn) {
      uint32_t b0h, b0l, b1h, b1l;
      split_tf32(vr[8 * dn], b0h, b0l);       // key 2t   as b0 (t, g)
      split_tf32(vr[LD + 8 * dn], b1h, b1l);  // key 2t+1 as b1 (t+4, g)
      mma_3xtf32(acc[dn], ph, pl, b0h, b1h, b0l, b1l);
    }
  }
}

// O's rows row0 and row0 + 8 where below N, columns [0, 8 DV) below D,
// each over its row sum
template <int DV>
__device__ __forceinline__ void store_o_f32(const float (&acc)[DV][4],
                                            const float (&l_run)[2],
                                            float* ob, long long sn, int row0,
                                            int N, int D, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv_l = 1.f / l;
    const int row = row0 + 8 * r;
    if (row >= N) continue;
    float* orow = ob + row * sn;
#pragma unroll
    for (int dn = 0; dn < DV; ++dn) {
      const int col = 8 * dn + 2 * t;
      const float v0 = acc[dn][2 * r] * inv_l;
      const float v1 = acc[dn][2 * r + 1] * inv_l;
      if (D % 2 == 0) {  // col even and < D: col + 1 < D, 8-byte aligned
        if (col < D) *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
      } else {
        if (col < D) orow[col] = v0;
        if (col + 1 < D) orow[col + 1] = v1;
      }
    }
  }
}

// Fragments of mma m16n8k8 (TF32), lane = 4g + t:
//   A (16 x 8, row-major): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8, k by n):     b0 (t, g), b1 (t+4, g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// S's accumulator holds keys 2t and 2t+1 where P's A fragment wants keys t
// and t+4. PV sums over keys, so each 8-key step takes its keys in the
// order (2t <-> t, 2t+1 <-> t+4) in both operands: c0, c2, c1, c3 are P's
// a0..a3 as they stand, and the B fragment reads V's rows 2t and 2t+1.
template <int DK, bool VEC>
__global__ void __launch_bounds__(F_THREADS)
attn_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int H,
                int N, int M, int D, Strides qs, Strides kst, Strides vst,
                Strides ost, float scale_log2) {
  static_assert(DK <= 8, "D <= 64: Q's split fragments in registers");
  constexpr int LD = f_ld(DK);
  constexpr int TF = f_tile_floats(DK);
  extern __shared__ __align__(16) float fsm[];
  const float* q_t = fsm;
  const auto k_t = [&](int s) { return fsm + (1 + s) * TF; };
  const auto v_t = [&](int s) { return fsm + (1 + F_STAGES + s) * TF; };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int n0 = blockIdx.x * TILE;
  const int ntiles = (M + TILE - 1) / TILE;
  const float* kb = k + b * kst.b + h * kst.h;
  const float* vb = v + b * vst.b + h * vst.h;

  load_tile_f32<DK, VEC>(smem_u32(q_t), q + b * qs.b + h * qs.h, qs.n, n0, N,
                         D);
  for (int s = 0; s < F_STAGES; ++s) {
    if (s < ntiles) {
      load_tile_f32<DK, VEC>(smem_u32(k_t(s)), kb, kst.n, s * TILE, M, D);
      load_tile_f32<DK, VEC>(smem_u32(v_t(s)), vb, vst.n, s * TILE, M, D);
    }
    cp_async_commit();  // group s: K/V tile s (group 0 also Q)
  }

  float acc[DK][4];
#pragma unroll
  for (int dn = 0; dn < DK; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  cp_async_wait<F_STAGES - 1>();  // group 0 (Q, K/V tile 0) has landed
  __syncthreads();
  const float* qr = q_t + (16 * warp + g) * LD + t;
  uint32_t qh[DK][4], ql[DK][4];  // held in registers for the whole run
#pragma unroll
  for (int kk = 0; kk < DK; ++kk)
    q_frag_tf32<LD>(qr, kk, scale_log2, qh[kk], ql[kk]);

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % F_STAGES;
    if (j > 0) {
      cp_async_wait<F_STAGES - 1>();  // groups 0..j have landed
      __syncthreads();
    }
    const float* kt = k_t(s);
    const float* vt = v_t(s);

    // S = (Q scale_log2) K^T for 64 keys: 8 n-tiles of 8 keys, DK k-steps
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float* kr = kt + (8 * n + g) * LD + t;  // K[key 8n+g][d t]
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        uint32_t b0h, b0l, b1h, b1l;
        split_tf32(kr[8 * kk], b0h, b0l);
        split_tf32(kr[8 * kk + 4], b1h, b1l);
        mma_3xtf32(sc[n], qh[kk], ql[kk], b0h, b1h, b0l, b1l);
      }
    }

    softmax_tile<DK>(sc, j, M, t, m_run, l_run, acc);
    pv_tf32x3<DK, LD>(acc, sc, vt, g, t);

    __syncthreads();  // every warp is done with stage s: refill it
    if (j + F_STAGES < ntiles) {
      load_tile_f32<DK, VEC>(smem_u32(kt), kb, kst.n, (j + F_STAGES) * TILE,
                             M, D);
      load_tile_f32<DK, VEC>(smem_u32(vt), vb, vst.n, (j + F_STAGES) * TILE,
                             M, D);
    }
    cp_async_commit();  // group j + F_STAGES (empty past the last tile)
  }

  store_o_f32<DK>(acc, l_run, o + b * ost.b + h * ost.h, ost.n,
                  n0 + 16 * warp + g, N, D, t);
}

template <int DK, bool VEC>
int launch_tf32x3(const float* q, const float* k, const float* v, float* o,
                  int B, int H, int N, int M, int D, Strides qs, Strides ks,
                  Strides vs, Strides os, float scale_log2, cudaStream_t st) {
  constexpr int smem = f_smem_bytes(DK);
  const auto kernel = attn_fwd_tf32x3<DK, VEC>;
  static uint64_t opted_in = 0;
  const cudaError_t err = allow_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + TILE - 1) / TILE, B * H);
  kernel<<<grid, F_THREADS, smem, st>>>(q, k, v, o, H, N, M, D, qs, ks, vs,
                                        os, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32, 64 < D <= 512: three TF32 passes on wgmma, warp
// specialised (attn_fwd_tf32x3_ws; design, bound and budget in the header)
// ---------------------------------------------------------------------------

constexpr int FW_THREADS = 3 * WG;  // two consumer warpgroups and a producer
constexpr int FW_STAGES = 8;        // atoms the ring holds
// setmaxnreg: the producer's (TMA and the split pass) and each consumer's;
// (72 + 2 * 216) * 128 = 64,512 registers, as a launch of 384 threads at
// 168 registers holds them (the SM's 65,536 less 1,024)
constexpr int FW_PRODUCER_REGS = 72, FW_CONSUMER_REGS = 216;
static_assert((FW_PRODUCER_REGS + 2 * FW_CONSUMER_REGS) * WG <= 64512,
              "registers past a 384-thread launch's");
// above D = 256 (SPLIT) each consumer computes its half of QK^T's k-steps
// and the two add their partial scores through shared memory; false: each
// computes every k-step (the scores twice; scripts/torch_attention_variants.py
// times it)
constexpr bool FW_SHARE_SCORES = true;
// PV on wgmma with V^T and V^T's lo written once a block by the producer
// (true), or on mma.sync over the raw V tile and its lo (false); with
// FW_V_SPLIT_ONCE false the mma.sync form splits V's fragments in every
// consumer warp instead (scripts/torch_attention_variants.py --f32 times
// each against the others)
constexpr bool FW_PV_WGMMA = true, FW_V_SPLIT_ONCE = true;
// clock64() stamps for scripts/torch_attention_variants.py --clock
#ifndef FW_CLK
#define FW_CLK(j, k)   // consumer 0's thread 0, key tile j, phase k
#define FW_CLK_P(i, k) // the producer's thread 0, ring atom i, phase k
#endif

// the producer's threads that split the atoms (its warps 1..3; warp 0
// issues the loads)
constexpr int FW_SPLITTERS = 3 * 32;

// Q rows a block: two consumer warpgroups of 64, or 64 (SPLIT: both on the
// same rows, each owning half of O's columns)
__host__ __device__ constexpr int fw_q_rows(bool split) {
  return split ? TILE : 2 * TILE;
}
// one atom: kt rows of 32 floats (128 bytes, one swizzle row), a TMA box
__host__ __device__ constexpr int fw_atom_bytes(int kt) { return kt * 128; }
// SPLIT: each consumer's partial scores, two tiles deep
__host__ __device__ constexpr int fw_xbuf_bytes(int kt, bool split) {
  return split ? 2 * 2 * TILE * kt * 4 : 0;
}
// Q (na atoms of its rows), the score exchange, the ring (a stage: the raw
// atom and its split half), + 1024 to align the base
__host__ __device__ constexpr int fw_smem_bytes(int na, int kt, bool split) {
  return fw_q_rows(split) * na * 128 + fw_xbuf_bytes(kt, split) +
         FW_STAGES * 2 * fw_atom_bytes(kt) + 1024;
}
// the ring's mbarriers (Q's, then full, ready and empty a stage) ride in
// static shared memory beside the dynamic tiles
constexpr int FW_BAR_BYTES = 8 * (1 + 3 * FW_STAGES);
static_assert(fw_smem_bytes(6, 64, false) + FW_BAR_BYTES <= 232448,
              "D=192 tiles above the block limit");
static_assert(fw_smem_bytes(8, 32, false) + FW_BAR_BYTES <= 232448,
              "D=256 tiles above the block limit");
static_assert(fw_smem_bytes(16, 32, true) + FW_BAR_BYTES <= 232448,
              "D=512 tiles above the block limit");

// x - trunc_tf32(x), exact in f32: the part of x the tensor cores drop
// when they read x as TF32 (its low 13 mantissa bits)
__device__ __forceinline__ float tf32_lo(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);
}
__device__ __forceinline__ float4 ld_shared_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_shared_f4(uint32_t addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}
__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void st_shared_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}
__device__ __forceinline__ void fence_regs(float (&r)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// (d0, d1, d2, d3) += a b, mma.sync m16n8k8, TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32_4(float& d0, float& d1, float& d2,
                                           float& d3, const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B, m64nNk8, TF32 in, f32 accumulate: A and B K-major in shared
// memory (ss; d0 the accumulator's columns 0..N/2-1, d1 the rest), or A in
// registers (rs; fragment of a k-step: a0 (g, t), a1 (g + 8, t), a2
// (g, t + 4), a3 (g + 8, t + 4) of the warp's 16 rows). The tensor cores
// read each f32 word as TF32 by dropping its low 13 bits.
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d0)[N / 4],
                                              float (&d1)[N / 4], uint64_t a,
                                              uint64_t b);
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t b);

#define FW_ACC8(d, o)                                                  \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),             \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define FW_ACC16(d) FW_ACC8(d, 0), FW_ACC8(d, 8)
#define FW_ACC32(d) FW_ACC16(d), FW_ACC8(d, 16), FW_ACC8(d, 24)

template <>
__device__ __forceinline__ void wgmma_tf32_ss<64>(float (&d0)[16],
                                                  float (&d1)[16],
                                                  uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1;\n}\n"
      : FW_ACC16(d0), FW_ACC16(d1)
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tf32_ss<128>(float (&d0)[32],
                                                  float (&d1)[32],
                                                  uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1;\n}\n"
      : FW_ACC32(d0), FW_ACC32(d1)
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tf32_rs<32>(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : FW_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : FW_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef FW_ACC32
#undef FW_ACC16
#undef FW_ACC8

// Warp-specialised block of FW_THREADS over QR = fw_q_rows(SPLIT) Q rows:
// warpgroups 0 and 1 consume, warpgroup 2 produces. Q and K are read from
// shared memory as NA atoms of 32 columns (128-byte swizzle, atom a holding
// columns 32a..32a+31), K and V stream through one ring of FW_STAGES atoms
// in the order K_j's atoms, V_j's atoms, K_(j+1)'s, ... (only atoms that
// hold columns below D). A stage holds a raw atom as TMA wrote it and its
// split half: for K the atom's lo = k - trunc(k) element for element, so
// that [K; K_lo] is one 2*KT-row B operand; for V the atom transposed in
// place into V^T (32 rows of O's columns, keys contiguous: the K-major B
// operand PV needs, each 8-key step in the order 0, 2, 4, 6, 1, 3, 5, 7 that
// S's accumulator gives P's A fragment) and its lo beside it. Barriers a
// stage: full (TMA's bytes), ready (the 96 splitting threads)
// and empty (one arrival a consumer warp: both consumers see every atom in
// order, SPLIT's releasing the other's atoms unread).
// Per key tile of KT keys a consumer computes
//   S = Q K^T:  [Q_hi K^T | Q_hi K_lo^T] (ss, N = 2 KT) + Q_lo K^T (rs)
//   O += P V:   P_lo V^T + P_hi V_lo^T + P_hi V^T (rs, N = 32 an atom)
// with the hi operands the raw words (the tensor cores truncate them), Q_lo
// split from shared memory into registers an atom at a time and P_lo from
// the scores. Not SPLIT: consumer w owns rows 64w..64w+63 and every column.
// SPLIT: both own rows 0..63; consumer w owns O's atoms a % 2 == w and
// QK^T's k-steps in the same atoms, and the two add their partial S
// through shared memory (each the same sum, so both take the same softmax).
template <int NA, int KT, bool SPLIT>
__global__ void __launch_bounds__(FW_THREADS, 1)
attn_fwd_tf32x3_ws(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   float* __restrict__ o, int H, int N, int M, int D,
                   Strides ost, float scale_log2) {
  constexpr int QR = fw_q_rows(SPLIT);
  constexpr int NVA = SPLIT ? NA / 2 : NA;  // O's atoms a consumer owns
  constexpr int ATOM = fw_atom_bytes(KT);
  constexpr int STAGES = FW_STAGES;
  constexpr int SR = KT / 2;  // S / P registers a thread after the sum
  constexpr bool SHARE = SPLIT && FW_SHARE_SCORES;
  static_assert(KT == 32 || KT == 64, "key tiles of 32 or 64");
  static_assert(!SPLIT || NA % 2 == 0, "O's atoms in two halves");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * STAGES];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_smem = base;  // atom a at q_smem + a * QR * 128
  const uint32_t x_smem = base + QR * NA * 128;
  const uint32_t ring = x_smem + fw_xbuf_bytes(KT, SPLIT);
  const auto slot = [&](int s) { return ring + s * 2 * ATOM; };
  const uint32_t q_full = smem_u32(bars);
  const auto full = [&](int s) { return q_full + 8u * (1 + s); };
  const auto ready = [&](int s) { return q_full + 8u * (1 + STAGES + s); };
  const auto empty = [&](int s) {
    return q_full + 8u * (1 + 2 * STAGES + s);
  };

  const int wg = threadIdx.x / WG;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int n0 = blockIdx.x * QR;
  const int ntiles = (M + KT - 1) / KT;
  const int nl = min(NA, (D + 31) / 32);  // atoms holding columns below D
  const int per_tile = 2 * nl;            // ring atoms a key tile

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(ready(s), FW_SPLITTERS);
      mbar_init(empty(s), 4 * 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: warp 0's first thread issues every TMA load as soon as the
    // atom's slot is free; warps 1..3 split each atom once it lands
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(FW_PRODUCER_REGS)
                 : "memory");
    const int pt = threadIdx.x - 2 * WG, lane = pt % 32, pw = pt / 32;
    const int total = per_tile * ntiles;
    if (pw == 0) {
      if (lane == 0) {
        mbar_expect_tx(q_full, nl * QR * 128);
        for (int a = 0; a < nl; ++a)  // one QR-row box an atom
          tma_load(q_smem + a * QR * 128, &tq, q_full, 32 * a, h, n0, b);
        for (int n = 0; n < total; ++n) {
          const int s = n % STAGES, j = n / per_tile, r = n % per_tile;
          // the slot's last atom released (the first round passes at once)
          mbar_wait(empty(s), ((n / STAGES) & 1) ^ 1);
          mbar_expect_tx(full(s), ATOM);
          tma_load(slot(s), r < nl ? &tk : &tv, full(s), 32 * (r % nl), h,
                   j * KT, b);
        }
      }
      return;
    }
    // The split works on 4 KB pieces (32 rows), one or two an atom, all of
    // an atom's loads before its stores (24 registers of data a thread at
    // 64-key tiles: the producer's 72 hold them; at 56 they spilled, and a
    // load of the next atom ahead of the stores slowed 32-key tiles by 1-2
    // %). K: 256 16-byte chunks a piece, three a thread; V: 8 chunks of 32
    // keys a piece, three a warp.
    constexpr int PIECES = KT / 32, PER = 3;
    const int xt = pt - 32, vw = pw - 1;  // splitting thread, warp
    // key u of an 8-key step sits at position 4 (u % 2) + u / 2 in V^T
    const int u = lane % 8;
    const int p = (lane & ~7) + 4 * (u % 2) + u / 2;
    const auto is_k = [&](int i) { return i % per_tile < nl; };
    // which splits an atom takes: K's lo; V's transpose and lo (PV on
    // wgmma) or V's lo (mma.sync), or none (its warps split V themselves)
    const auto kind = [&](int i) {
      return is_k(i) || (!FW_PV_WGMMA && FW_V_SPLIT_ONCE) ? 1
             : FW_PV_WGMMA                                ? 2
                                                          : 0;
    };
    const auto load = [&](int k, float4(&x)[PER]) {
      const int i = k / PIECES, hh = k % PIECES, s = i % STAGES;
      const uint32_t raw = slot(s) + hh * 4096;
      if (hh == 0) {
        mbar_wait(full(s), (i / STAGES) & 1);
        FW_CLK_P(i, 0)
      }
      if (kind(i) == 1) {
#pragma unroll
        for (int m = 0; m < PER; ++m)
          if (xt + FW_SPLITTERS * m < 256)
            x[m] = ld_shared_f4(raw + 16 * (xt + FW_SPLITTERS * m));
      } else if (kind(i) == 2) {
#pragma unroll
        for (int m = 0; m < PER; ++m) {
          const int c = vw + 3 * m;
          if (c < 8) x[m] = ld_shared_f4(raw + lane * 128 + ((c ^ (lane % 8)) << 4));
        }
      }
    };
    const auto store = [&](int k, const float4(&x)[PER]) {
      const int i = k / PIECES, hh = k % PIECES, s = i % STAGES;
      const uint32_t raw = slot(s) + hh * 4096, lo = raw + ATOM;
      if (kind(i) == 1) {
        // lo beside the raw atom, 16 bytes for 16 bytes (same swizzle)
#pragma unroll
        for (int m = 0; m < PER; ++m)
          if (xt + FW_SPLITTERS * m < 256)
            st_shared_f4(lo + 16 * (xt + FW_SPLITTERS * m),
                         make_float4(tf32_lo(x[m].x), tf32_lo(x[m].y),
                                     tf32_lo(x[m].z), tf32_lo(x[m].w)));
      } else if (kind(i) == 2) {
        // V: [32 keys x 32 columns] -> V^T [32 columns x 32 keys] in place
        // (the piece's 4 KB), V^T's lo beside it. Lane l read key l, warp
        // w's step m the 16-byte chunk c: every warp's reads and writes
        // fall on 32 distinct banks. All reads land before any write.
        named_sync(3, FW_SPLITTERS);
#pragma unroll
        for (int m = 0; m < PER; ++m) {
          const int c = vw + 3 * m;
          if (c >= 8) continue;
          const float e4[4] = {x[m].x, x[m].y, x[m].z, x[m].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = 4 * c + e;
            const uint32_t off =
                d * 128 + (((p / 4) ^ (d % 8)) << 4) + (p % 4) * 4;
            st_shared_f32(raw + off, e4[e]);
            st_shared_f32(lo + off, tf32_lo(e4[e]));
          }
        }
      }
      if (hh == PIECES - 1) {
        FW_CLK_P(i, 2)
        // the threads' generic-proxy writes, visible to wgmma's async proxy
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        FW_CLK_P(i, 3)
        mbar_arrive(ready(s));
        FW_CLK_P(i, 1)
      }
    };
    float4 x[PIECES][PER];
#pragma unroll 1
    for (int i = 0; i < total; ++i) {  // an atom's loads before its stores
#pragma unroll
      for (int hh = 0; hh < PIECES; ++hh) load(i * PIECES + hh, x[hh]);
#pragma unroll
      for (int hh = 0; hh < PIECES; ++hh) store(i * PIECES + hh, x[hh]);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(FW_CONSUMER_REGS)
               : "memory");
  const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = SPLIT ? 0 : TILE * wg;  // this warpgroup's first Q row
  // Q's lo fragments: rows 16 warp + g and + 8 of this warpgroup's, column
  // t of a 16-byte chunk (the swizzle XORs the chunk with the row % 8 = g)
  const uint32_t q_frag = q_smem + (row0 + 16 * warp + g) * 128 + 4 * t;
  // ring atom i, which this warpgroup does not read: seen, then released
  const auto pass = [&](int i) {
    const int s = i % STAGES;
    mbar_wait(ready(s), (i / STAGES) & 1);
    if (lane == 0) mbar_arrive(empty(s));
  };

  // O's atom la (SPLIT: 2 la + wg): its 32 columns
  float acc[NVA][16];
#pragma unroll
  for (int la = 0; la < NVA; ++la)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[la][i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  mbar_wait(q_full, 0);

#pragma unroll 1
  for (int j = 0; j < ntiles; ++j) {
    // S = Q K^T, an atom (4 k-steps) at a time: sc Q_hi K^T + Q_lo K^T,
    // sl Q_hi K_lo^T. SPLIT: consumer w multiplies the atoms a % 2 == w
    // (so the two run side by side down the ring) and releases the other's
    // unread; each sees every atom in the ring's order: one that waited on
    // its own atoms only could wait on a slot's next round before the
    // current one completed, where the parity test passes at once
    FW_CLK(j, 0)
    float sc[SR], sl[SR];
#pragma unroll
    for (int i = 0; i < SR; ++i) sc[i] = sl[i] = 0.f;
    int prev = -1;  // the stage of the last atom whose products are issued
#pragma unroll 1
    for (int a = 0; a < nl; ++a) {
      const int i = per_tile * j + a, s = i % STAGES;
      if (SHARE && a % 2 != wg) {
        pass(i);
        continue;
      }
      const uint32_t q_atom = q_smem + a * QR * 128 + row0 * 128;
      const uint32_t k_atom = slot(s);
      mbar_wait(ready(s), (i / STAGES) & 1);
      fence_regs(sc);
      fence_regs(sl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_tf32_ss<2 * KT>(sc, sl, make_desc(q_atom + 32 * kk, 16, 1024),
                              make_desc(k_atom + 32 * kk, 16, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // the last atom's products (and Q_lo's reads) done
      if (prev >= 0 && lane == 0) mbar_arrive(empty(prev));
      uint32_t ql[4][4];
      const uint32_t qf = q_frag + a * QR * 128;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t c0 = ((2 * kk) ^ g) << 4, c1 = ((2 * kk + 1) ^ g) << 4;
        ql[kk][0] = __float_as_uint(tf32_lo(ld_shared_f32(qf + c0)));
        ql[kk][1] = __float_as_uint(tf32_lo(ld_shared_f32(qf + 1024 + c0)));
        ql[kk][2] = __float_as_uint(tf32_lo(ld_shared_f32(qf + c1)));
        ql[kk][3] = __float_as_uint(tf32_lo(ld_shared_f32(qf + 1024 + c1)));
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_tf32_rs<KT>(sc, ql[kk], make_desc(k_atom + 32 * kk, 16, 1024));
      wgmma_commit();
      prev = s;
    }
    FW_CLK(j, 1)
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(sl);
    FW_CLK(j, 2)
    if (prev >= 0 && lane == 0) mbar_arrive(empty(prev));

    float p[SR];  // the scores, then P: element 4i + 2r + e is (row g + 8r,
                  // key 8i + 2t + e) of the warp's 16 rows
#pragma unroll
    for (int i = 0; i < SR; ++i) p[i] = sc[i] + sl[i];
    if constexpr (SHARE) {
      // add the other consumer's partial scores: each writes its own, both
      // read the other's (a + b == b + a: the two sums are the same bits)
      const uint32_t part = TILE * KT * 4;
      const uint32_t mine = x_smem + ((j & 1) * 2 + wg) * part;
      const uint32_t theirs = x_smem + ((j & 1) * 2 + 1 - wg) * part;
#pragma unroll
      for (int i = 0; i < SR; ++i) st_shared_f32(mine + (i * WG + tid) * 4, p[i]);
      named_sync(4, 2 * WG);
#pragma unroll
      for (int i = 0; i < SR; ++i)
        p[i] += ld_shared_f32(theirs + (i * WG + tid) * 4);
    }
    FW_CLK(j, 3)
    if ((j + 1) * KT > M) {  // ragged last tile: keys past M get -inf
#pragma unroll
      for (int i = 0; i < KT / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (j * KT + 8 * i + 2 * t + e >= M)
            p[4 * i + e] = p[4 * i + 2 + e] = -INFINITY;
    }
    // online softmax in log2 units: every row's first tile holds key 0, so
    // m_run is finite from the first tile on and alpha = exp2(-inf) = 0
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mt = -INFINITY;
#pragma unroll
      for (int i = 0; i < KT / 8; ++i)
        mt = fmaxf(mt, fmaxf(p[4 * i + 2 * r], p[4 * i + 2 * r + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m_run[r], scale_log2 * mt);
      alpha[r] = exp2_ftz(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int r = (i / 2) % 2;
      p[i] = exp2_ftz(fmaf(p[i], scale_log2, -m_run[r]));
      l_run[r] += p[i];
    }
#pragma unroll
    for (int la = 0; la < NVA; ++la)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[la][i] *= alpha[(i / 2) % 2];
    // P's A fragment of k-step kk: keys 2t and 2t + 1 of the step as its
    // k = t and t + 4 (V^T holds the keys in that order)
    uint32_t ph[KT / 8][4], pl[KT / 8][4];
#pragma unroll
    for (int kk = 0; kk < KT / 8; ++kk) {
      const int idx[4] = {4 * kk, 4 * kk + 2, 4 * kk + 1, 4 * kk + 3};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ph[kk][e] = __float_as_uint(p[idx[e]]);
        pl[kk][e] = __float_as_uint(tf32_lo(p[idx[e]]));
      }
    }

    FW_CLK(j, 4)
    // O += P V, one atom of O's columns at a time (SPLIT: consumer w's are
    // the atoms a % 2 == w)
    prev = -1;
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      constexpr int STEP = SPLIT ? 2 : 1;
      const int la = a / STEP;
      if (a < nl && SPLIT && a % 2 != wg) {
        pass(per_tile * j + nl + a);
      } else if (a < nl && !FW_PV_WGMMA) {
        // mma.sync over the raw atom [KT keys x 32 columns] and its lo: B
        // fragment b0 (k = t, n = g), b1 (k = t + 4, n = g) of key step kk
        // and n-tile nt is V[8 kk + 2t (+1)][8 nt + g], P's keys' order
        const int i = per_tile * j + nl + a, s = i % STAGES;
        const uint32_t vr = slot(s);
        mbar_wait(ready(s), (i / STAGES) & 1);
#pragma unroll
        for (int kk = 0; kk < KT / 8; ++kk)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int r = 8 * kk + 2 * t, c = 8 * nt + g;
            const uint32_t o0 = r * 128 + (((c / 4) ^ (r % 8)) << 4) + (c % 4) * 4;
            const uint32_t o1 =
                (r + 1) * 128 + (((c / 4) ^ ((r + 1) % 8)) << 4) + (c % 4) * 4;
            const float v0 = ld_shared_f32(vr + o0), v1 = ld_shared_f32(vr + o1);
            const float l0 = FW_V_SPLIT_ONCE ? ld_shared_f32(vr + ATOM + o0) : tf32_lo(v0);
            const float l1 = FW_V_SPLIT_ONCE ? ld_shared_f32(vr + ATOM + o1) : tf32_lo(v1);
            float(&d)[16] = acc[la];
            mma_tf32_4(d[4 * nt], d[4 * nt + 1], d[4 * nt + 2], d[4 * nt + 3],
                       pl[kk], __float_as_uint(v0), __float_as_uint(v1));
            mma_tf32_4(d[4 * nt], d[4 * nt + 1], d[4 * nt + 2], d[4 * nt + 3],
                       ph[kk], __float_as_uint(l0), __float_as_uint(l1));
            mma_tf32_4(d[4 * nt], d[4 * nt + 1], d[4 * nt + 2], d[4 * nt + 3],
                       ph[kk], __float_as_uint(v0), __float_as_uint(v1));
          }
        if (lane == 0) mbar_arrive(empty(s));  // its values are in registers
      } else if (a < nl) {
        const int i = per_tile * j + nl + a, s = i % STAGES;
        const uint32_t vt = slot(s);
        mbar_wait(ready(s), (i / STAGES) & 1);
        fence_regs(acc[la]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KT / 8; ++kk) {
          const uint32_t off = (kk / 4) * 4096 + (kk % 4) * 32;
          const uint64_t v_hi = make_desc(vt + off, 16, 1024);
          const uint64_t v_lo = make_desc(vt + ATOM + off, 16, 1024);
          wgmma_tf32_rs<32>(acc[la], pl[kk], v_hi);
          wgmma_tf32_rs<32>(acc[la], ph[kk], v_lo);
          wgmma_tf32_rs<32>(acc[la], ph[kk], v_hi);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the last atom's products done
        if (prev >= 0 && lane == 0) mbar_arrive(empty(prev));
        prev = s;
      }
    }
    FW_CLK(j, 5)
    wgmma_wait<0>();
#pragma unroll
    for (int la = 0; la < NVA; ++la) fence_regs(acc[la]);
    if (prev >= 0 && lane == 0) mbar_arrive(empty(prev));
    FW_CLK(j, 6)
  }

  float* ob = o + b * ost.b + h * ost.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv_l = 1.f / l;
    const int row = n0 + row0 + 16 * warp + g + 8 * r;
    if (row >= N) continue;
    float* orow = ob + row * ost.n;
#pragma unroll
    for (int la = 0; la < NVA; ++la)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 32 * (SPLIT ? 2 * la + wg : la) + 8 * i + 2 * t;
        const float v0 = acc[la][4 * i + 2 * r] * inv_l;
        const float v1 = acc[la][4 * i + 2 * r + 1] * inv_l;
        if (D % 2 == 0) {  // col even and < D: col + 1 < D, 8-byte aligned
          if (col < D) *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
        } else {
          if (col < D) orow[col] = v0;
          if (col + 1 < D) orow[col + 1] = v1;
        }
      }
  }
}

// [B, rows, H, D] f32 with element strides s -> 4-D map (D, H, rows, B),
// box (32, 1, box_rows, 1): one 128-byte swizzle atom of box_rows rows
CUresult encode_f32(EncodeTiled fn, CUtensorMap* map, const void* ptr, int B,
                    int rows, int H, int D, Strides s, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)rows,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s.h * 4, (cuuint64_t)s.n * 4,
                                 (cuuint64_t)s.b * 4};
  const cuuint32_t box[4] = {32, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int NA, int KT, bool SPLIT>
int launch_tf32x3_ws(const void* q, const void* k, const void* v, float* o,
                     int B, int H, int N, int M, int D, Strides qs,
                     Strides ks, Strides vs, Strides os, float scale_log2,
                     cudaStream_t st) {
  constexpr int smem = fw_smem_bytes(NA, KT, SPLIT);
  const auto kernel = attn_fwd_tf32x3_ws<NA, KT, SPLIT>;
  static uint64_t opted_in = 0;
  const cudaError_t err = allow_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  CUtensorMap tq, tk, tv;
  CUresult res = encode_f32(fn, &tq, q, B, N, H, D, qs, fw_q_rows(SPLIT));
  if (res == CUDA_SUCCESS) res = encode_f32(fn, &tk, k, B, M, H, D, ks, KT);
  if (res == CUDA_SUCCESS) res = encode_f32(fn, &tv, v, B, M, H, D, vs, KT);
  if (res != CUDA_SUCCESS) return -(1000 + static_cast<int>(res));
  const dim3 grid((N + fw_q_rows(SPLIT) - 1) / fw_q_rows(SPLIT), B * H);
  kernel<<<grid, FW_THREADS, smem, st>>>(tq, tk, tv, o, H, N, M, D, os,
                                         scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// D <= 64: attn_fwd_tf32x3 with DK = ceil(D / 8) k-steps of QK^T and
// n-tiles of PV
template <bool VEC>
int launch_f32_narrow(const float* q, const float* k, const float* v,
                      float* o, int B, int H, int N, int M, int D, Strides qs,
                      Strides ks, Strides vs, Strides os, float scale_log2,
                      cudaStream_t st) {
#define F32_CASE(DK)                                                        \
  case DK:                                                                  \
    return launch_tf32x3<DK, VEC>(q, k, v, o, B, H, N, M, D, qs, ks, vs, os, \
                                  scale_log2, st);
  switch ((D + 7) / 8) {
    F32_CASE(1)
    F32_CASE(2)
    F32_CASE(3)
    F32_CASE(4)
    F32_CASE(5)
    F32_CASE(6)
    F32_CASE(7)
    default:
      F32_CASE(8)
  }
#undef F32_CASE
}

// Which f32 kernel takes D, and its tiles: `ws` attn_fwd_tf32x3_ws (above
// 64), else attn_fwd_tf32x3; dk: D padded, in k-steps of 8 (the ws kernel's
// atoms are dk / 4); kt: keys a tile; split: the ws kernel's two consumers
// on one 64-row Q tile
struct F32Plan {
  bool ws;
  int dk, kt;
  bool split;
};

F32Plan f32_plan(int D) {
  if (D <= 64) return {false, (D + 7) / 8, TILE, false};
  if (D <= 96) return {true, 12, 64, false};
  if (D <= 128) return {true, 16, 64, false};
  if (D <= 192) return {true, 24, 64, false};
  if (D <= 256) return {true, 32, 32, false};  // O's 128 registers: 32-key S
  return {true, D <= 384 ? 48 : 64, 32, true};
}

// 16-byte copies and TMA maps need a 16-byte aligned base and batch, row
// and head strides that are multiples of 4 floats
bool rows_aligned16(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 4 == 0 &&
         s.n % 4 == 0 && s.h % 4 == 0;
}

int launch_f32(const float* q, const float* k, const float* v, float* o,
               int B, int H, int N, int M, int D, Strides qs, Strides ks,
               Strides vs, Strides os, float scale_log2, cudaStream_t st) {
  const bool tma = rows_aligned16(q, qs) && rows_aligned16(k, ks) &&
                   rows_aligned16(v, vs);
  const F32Plan p = f32_plan(D);
  if (!p.ws) {
    if (tma && D % 4 == 0)
      return launch_f32_narrow<true>(q, k, v, o, B, H, N, M, D, qs, ks, vs, os,
                                     scale_log2, st);
    return launch_f32_narrow<false>(q, k, v, o, B, H, N, M, D, qs, ks, vs, os,
                                    scale_log2, st);
  }
  if (!tma) return static_cast<int>(cudaErrorInvalidValue);
  switch (p.dk) {
#define WS_CASE(DK, NA, KT, SPLIT)                                          \
  case DK:                                                                  \
    return launch_tf32x3_ws<NA, KT, SPLIT>(q, k, v, o, B, H, N, M, D, qs, ks, \
                                           vs, os, scale_log2, st);
    WS_CASE(12, 3, 64, false)
    WS_CASE(16, 4, 64, false)
    WS_CASE(24, 6, 64, false)
    WS_CASE(32, 8, 32, false)
    WS_CASE(48, 12, 32, true)
    default:
      WS_CASE(64, 16, 32, true)
#undef WS_CASE
  }
}

// ---------------------------------------------------------------------------
// bf16 backward, D <= 128: attn_bwd_dq, then attn_bwd_dkdv
// ---------------------------------------------------------------------------

constexpr int BW_CONSUMERS = 2;                      // warpgroups, 64 rows each
constexpr int BW_ROWS = BW_CONSUMERS * TILE;         // a block's rows
constexpr int BW_THREADS = (BW_CONSUMERS + 1) * WG;  // + the producer's
constexpr int BW_STAGES = 3;                         // column tiles in flight
constexpr int BW_STATS_BYTES = 2 * TILE * 4;         // a column tile's LSE, delta
// two row operands (BW_ROWS rows) and BW_STAGES stages of two column tiles
// (TILE rows), `nat` 128-byte atoms a row; the stages' statistics; 1024 to
// align the base
__host__ __device__ constexpr int bw_smem_bytes(int nat) {
  return 2 * nat * BW_CONSUMERS * ATOM_BYTES +
         BW_STAGES * (2 * nat * ATOM_BYTES + BW_STATS_BYTES) + 1024;
}
static_assert(bw_smem_bytes(2) <= 232448, "D=128 tiles above the block limit");

// D (a multiple of 8, the wrapper pads) -> k-steps of 16 of S and dP, and
// the n of the output products (72 stays 72: DiT-XL's heads)
struct BwPlan {
  int ksteps, nout;
};
BwPlan bw_plan(int D) {
  if (D <= 32) return {2, 32};
  if (D <= 48) return {3, 48};
  if (D <= 64) return {4, 64};
  if (D <= 72) return {5, 72};
  if (D <= 80) return {5, 80};
  if (D <= 96) return {6, 96};
  return {8, 128};
}

// d += A B, m64n<N>k16: A the bf16 register fragment a[0..3], B MN-major in
// shared memory (64-column atoms ATOM_BYTES apart, the descriptor's LBO)
template <int N>
__device__ __forceinline__ void bw_mma_rs(float (&d)[N / 2], const uint32_t* a,
                                          uint64_t b);
#define BW_F4(o) "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3])
template <>
__device__ __forceinline__ void bw_mma_rs<32>(float (&d)[16],
                                              const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : BW_F4(0), BW_F4(4), BW_F4(8), BW_F4(12)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void bw_mma_rs<48>(float (&d)[24],
                                              const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : BW_F4(0), BW_F4(4), BW_F4(8), BW_F4(12), BW_F4(16), BW_F4(20)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void bw_mma_rs<64>(float (&d)[32],
                                              const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : BW_F4(0), BW_F4(4), BW_F4(8), BW_F4(12), BW_F4(16), BW_F4(20), BW_F4(24), BW_F4(28)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void bw_mma_rs<72>(float (&d)[36],
                                              const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35"
      "}, {%36, %37, %38, %39}, %40, p, 1, 1, 1;\n}\n"
      : BW_F4(0), BW_F4(4), BW_F4(8), BW_F4(12), BW_F4(16), BW_F4(20), BW_F4(24), BW_F4(28), BW_F4(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void bw_mma_rs<80>(float (&d)[40],
                                              const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : BW_F4(0), BW_F4(4), BW_F4(8), BW_F4(12), BW_F4(16), BW_F4(20), BW_F4(24), BW_F4(28), BW_F4(32), BW_F4(36)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void bw_mma_rs<96>(float (&d)[48],
                                              const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : BW_F4(0), BW_F4(4), BW_F4(8), BW_F4(12), BW_F4(16), BW_F4(20), BW_F4(24), BW_F4(28), BW_F4(32), BW_F4(36), BW_F4(40), BW_F4(44)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void bw_mma_rs<128>(float (&d)[64],
                                              const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : BW_F4(0), BW_F4(4), BW_F4(8), BW_F4(12), BW_F4(16), BW_F4(20), BW_F4(24), BW_F4(28), BW_F4(32), BW_F4(36), BW_F4(40), BW_F4(44), BW_F4(48), BW_F4(52), BW_F4(56), BW_F4(60)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef BW_F4

template <int N>
__device__ __forceinline__ void bw_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void bw_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// x0, x1 as two bf16 pairs, hi = bf16(x) and lo = bf16(x - hi): hi + lo is
// x to 2^-17 of |x|, and a product of each with an exact bf16 partner,
// summed in f32, is the f32 product to that precision
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

// `bytes` (a multiple of 16) from global src to shared dst, completing on
// the mbarrier's transaction count
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// One backward kernel's inputs. Row operands a1, a2 (boxes of BW_ROWS rows)
// are loaded once a block, column operands b1, b2 (boxes of TILE rows) a
// tile at a time: attn_bwd_dq (a1, a2, b1, b2) = (Q, dO, K, V), rows the
// N queries; attn_bwd_dkdv (K, V, Q, dO), rows the M keys. All four are
// [B, rows, H, D] bf16 with D a multiple of 8 and TMA-describable strides.
struct BwArgs {
  CUtensorMap a1, a2, b1, b2;
  const float* lse;     // [B * H, npad], log2 units (dsdiff_flash_attention_lse)
  float* delta;         // [B * H, npad]: written by attn_bwd_dq, read by dkdv
  __nv_bfloat16* out1;  // dq, or dk: contiguous [B, rows, H, D]
  __nv_bfloat16* out2;  // dv (attn_bwd_dkdv)
  int H, rows, cols, D, npad;
  float scale_log2, scale;
};

// The block's 2 x 64 rows against every column tile. Per tile, each consumer
// warpgroup forms S = A1 B1^T and dP = A2 B2^T (wgmma, both operands in
// shared memory, f32 accumulators: S^T and dP^T in attn_bwd_dkdv), then in
// registers P = 2^(S scale_log2 - LSE) and dS = P (dP - delta) in f32, the
// statistics per row (dq) or per column (dkdv), and adds dS B1 (and, dkdv,
// P B2) into its f32 output accumulators, each f32 operand as a bf16 hi and
// lo pass against the exact bf16 tile (B1, B2 read MN-major). attn_bwd_dq
// walks the columns twice: first delta = rowsum(P dP), written for dkdv,
// then dQ.
template <bool DQ, int KSTEPS, int NOUT>
__device__ __forceinline__ void bw_body(const BwArgs& a) {
  constexpr int NAT = (KSTEPS + 3) / 4;             // atoms a row
  constexpr int ROW_BYTES = NAT * BW_CONSUMERS * ATOM_BYTES;
  constexpr int COL_BYTES = NAT * ATOM_BYTES;       // one column tile
  constexpr int STAGE_BYTES = 2 * COL_BYTES;
  static_assert(NOUT <= 64 * NAT && NOUT > 64 * NAT - 64, "n past the atoms");
  extern __shared__ uint8_t smem_raw[];
  // the row operands, then per stage a full and an empty barrier
  __shared__ __align__(8) uint64_t bars[1 + 2 * BW_STAGES];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t row1 = base, row2 = base + ROW_BYTES;
  const auto col1 = [&](int s) { return base + 2 * ROW_BYTES + s * STAGE_BYTES; };
  const auto col2 = [&](int s) { return col1(s) + COL_BYTES; };
  const auto stats = [&](int s) {
    return base + 2 * ROW_BYTES + BW_STAGES * STAGE_BYTES + s * BW_STATS_BYTES;
  };
  const uint32_t row_full = smem_u32(bars);
  const auto full = [&](int s) { return row_full + 8u * (1 + s); };
  const auto empty = [&](int s) { return row_full + 8u * (1 + BW_STAGES + s); };

  const int wg = threadIdx.x / WG;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int r0 = blockIdx.x * BW_ROWS;
  const int ncol = (a.cols + TILE - 1) / TILE;
  const int total = (DQ ? 2 : 1) * ncol;  // dq: the delta walk, then dQ's

  if (threadIdx.x == 0) {
    mbar_init(row_full, 1);
    for (int s = 0; s < BW_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * BW_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == BW_CONSUMERS) {
    // producer: the row operands, then each column tile as soon as its
    // stage is released (the first round passes at once)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == BW_CONSUMERS * WG) {
      mbar_expect_tx(row_full, 2 * ROW_BYTES);
      for (int at = 0; at < NAT; ++at) {
        const uint32_t off = at * BW_CONSUMERS * ATOM_BYTES;
        tma_load(row1 + off, &a.a1, row_full, 64 * at, h, r0, b);
        tma_load(row2 + off, &a.a2, row_full, 64 * at, h, r0, b);
      }
      for (int it = 0; it < total; ++it) {
        const int s = it % BW_STAGES, j = it % ncol;
        mbar_wait(empty(s), ((it / BW_STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), STAGE_BYTES + (DQ ? 0 : BW_STATS_BYTES));
        tma_load_tile(col1(s), &a.b1, full(s), 0, NAT, h, j * TILE, b);
        tma_load_tile(col2(s), &a.b2, full(s), 0, NAT, h, j * TILE, b);
        if constexpr (!DQ) {
          const long long off = static_cast<long long>(bh) * a.npad + j * TILE;
          bulk_load(stats(s), a.lse + off, TILE * 4, full(s));
          bulk_load(stats(s) + TILE * 4, a.delta + off, TILE * 4, full(s));
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
  const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
  const int c = 2 * (lane % 4);
  // this warpgroup's 64 rows: 8 KB into each 16 KB atom of a row operand
  const uint64_t a1 = make_desc(row1 + wg * ATOM_BYTES, 16, 1024);
  const uint64_t a2 = make_desc(row2 + wg * ATOM_BYTES, 16, 1024);
  int row[2];
  float lse_r[2], dl[2] = {0.f, 0.f};  // dq: the rows' LSE and delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = r0 + TILE * wg + 16 * warp + lane / 4 + 8 * r;
    if constexpr (DQ)
      lse_r[r] = row[r] < a.rows
                     ? a.lse[static_cast<long long>(bh) * a.npad + row[r]]
                     : INFINITY;
  }
  float o1[NOUT / 2], o2[DQ ? 1 : NOUT / 2], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < NOUT / 2; ++i) {
    o1[i] = 0.f;
    if constexpr (!DQ) o2[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
  mbar_wait(row_full, 0);

#pragma unroll 1
  for (int it = 0; it < total; ++it) {
    const int s = it % BW_STAGES;
    mbar_wait(full(s), (it / BW_STAGES) & 1);
    // S (or S^T) and dP (or dP^T): k-steps of 16 columns, 32 bytes inside
    // an atom; the row operands' atoms 16 KB apart, the tiles' 8 KB
    const uint64_t b1 = make_desc(col1(s), 16, 1024);
    const uint64_t b2 = make_desc(col2(s), 16, 1024);
    bw_fence(sc);
    bw_fence(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma_ss(sc, a1 + 1024 * (kk / 4) + 2 * (kk % 4),
               b1 + 512 * (kk / 4) + 2 * (kk % 4), kk);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma_ss(dp, a2 + 1024 * (kk / 4) + 2 * (kk % 4),
               b2 + 512 * (kk / 4) + 2 * (kk % 4), kk);
    wgmma_commit();
    wgmma_wait<0>();
    bw_fence(sc);
    bw_fence(dp);

    if (DQ && it < ncol) {
      // the delta walk: this thread's share of rowsum(P dP)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = i % 2;
        const float p0 = exp2_ftz(fmaf(sc[2 * i], a.scale_log2, -lse_r[r]));
        const float p1 = exp2_ftz(fmaf(sc[2 * i + 1], a.scale_log2, -lse_r[r]));
        dl[r] = fmaf(p1, dp[2 * i + 1], fmaf(p0, dp[2 * i], dl[r]));
      }
      if (lane == 0) mbar_arrive(empty(s));
      if (it == ncol - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 1);
          dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 2);
          if (lane % 4 == 0 && row[r] < a.npad)
            a.delta[static_cast<long long>(bh) * a.npad + row[r]] = dl[r];
        }
      }
      continue;
    }

    // P and dS = P (dP - delta) in f32, each split into bf16 hi and lo A
    // fragments (the accumulator's pairs: p[4kk..4kk+3] the columns of k-step
    // kk of the next products)
    uint32_t dsh[16], dsl[16], ph[DQ ? 1 : 16], pl[DQ ? 1 : 16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = i % 2;
      float l0, l1, d0, d1;
      if constexpr (DQ) {
        l0 = l1 = lse_r[r];
        d0 = d1 = dl[r];
      } else {  // the columns' statistics: columns 8 (i / 2) + c, + 1
        const uint32_t at = stats(s) + 4 * (8 * (i / 2) + c);
        const float2 lv = ld_shared_f2(at), dv = ld_shared_f2(at + TILE * 4);
        l0 = lv.x, l1 = lv.y, d0 = dv.x, d1 = dv.y;
      }
      const float p0 = exp2_ftz(fmaf(sc[2 * i], a.scale_log2, -l0));
      const float p1 = exp2_ftz(fmaf(sc[2 * i + 1], a.scale_log2, -l1));
      if constexpr (!DQ) split_bf16(p0, p1, ph[i], pl[i]);
      split_bf16(p0 * (dp[2 * i] - d0), p1 * (dp[2 * i + 1] - d1), dsh[i],
                 dsl[i]);
    }

    // out1 += dS B1, out2 += P B2: B MN-major, a k-step of 16 tile rows 2 KB
    const uint64_t t1 = make_desc(col1(s), ATOM_BYTES, 1024);
    bw_fence(o1);
    bw_fence(dsh);
    bw_fence(dsl);
    if constexpr (!DQ) {
      bw_fence(o2);
      bw_fence(ph);
      bw_fence(pl);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      bw_mma_rs<NOUT>(o1, dsl + 4 * kk, t1 + 128 * kk);
      bw_mma_rs<NOUT>(o1, dsh + 4 * kk, t1 + 128 * kk);
    }
    if constexpr (!DQ) {
      const uint64_t t2 = make_desc(col2(s), ATOM_BYTES, 1024);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        bw_mma_rs<NOUT>(o2, pl + 4 * kk, t2 + 128 * kk);
        bw_mma_rs<NOUT>(o2, ph + 4 * kk, t2 + 128 * kk);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    bw_fence(o1);
    if constexpr (!DQ) bw_fence(o2);
    if (lane == 0) mbar_arrive(empty(s));
  }

  // out1 * scale (dq, dk) and out2 (dv) in bf16; rows past `rows` and
  // columns past D are not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= a.rows) continue;
    const long long at =
        (static_cast<long long>(b) * a.rows + row[r]) * a.H * a.D + h * a.D;
#pragma unroll
    for (int i = 0; i < NOUT / 8; ++i) {
      const int col = 8 * i + c;
      if (col >= a.D) continue;
      *reinterpret_cast<__nv_bfloat162*>(a.out1 + at + col) =
          __floats2bfloat162_rn(o1[4 * i + 2 * r] * a.scale,
                                o1[4 * i + 2 * r + 1] * a.scale);
      if constexpr (!DQ)
        *reinterpret_cast<__nv_bfloat162*>(a.out2 + at + col) =
            __floats2bfloat162_rn(o2[4 * i + 2 * r], o2[4 * i + 2 * r + 1]);
    }
  }
}

template <int KSTEPS, int NOUT>
__global__ void __launch_bounds__(BW_THREADS, 1)
attn_bwd_dq(const __grid_constant__ BwArgs a) {
  bw_body<true, KSTEPS, NOUT>(a);
}

template <int KSTEPS, int NOUT>
__global__ void __launch_bounds__(BW_THREADS, 1)
attn_bwd_dkdv(const __grid_constant__ BwArgs a) {
  bw_body<false, KSTEPS, NOUT>(a);
}

// attn_bwd_dq (delta and dq) then attn_bwd_dkdv, each where asked for
template <int KSTEPS, int NOUT>
int launch_bwd(const BwArgs& dq, const BwArgs& dkdv, int B, int H, int N,
               int M, bool run_dq, bool run_dkdv, cudaStream_t st) {
  constexpr int smem = bw_smem_bytes((KSTEPS + 3) / 4);
  static uint64_t opted_dq = 0, opted_dkdv = 0;
  const auto k_dq = attn_bwd_dq<KSTEPS, NOUT>;
  const auto k_dkdv = attn_bwd_dkdv<KSTEPS, NOUT>;
  cudaError_t err = allow_smem(k_dq, smem, opted_dq);
  if (err == cudaSuccess) err = allow_smem(k_dkdv, smem, opted_dkdv);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (run_dq) {
    k_dq<<<dim3((N + BW_ROWS - 1) / BW_ROWS, B * H), BW_THREADS, smem, st>>>(dq);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (run_dkdv) {
    k_dkdv<<<dim3((M + BW_ROWS - 1) / BW_ROWS, B * H), BW_THREADS, smem, st>>>(
        dkdv);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

// The bf16 launch for `plan`; LSE: the gradient path's variant, which also
// writes each row's log-sum-exp (D <= 128 only)
template <bool LSE>
int launch_bf16(const WgmmaArgs& a, const Bf16Plan& plan, __nv_bfloat16* ob,
                int B, int H, int N, int M, int D, Strides os, float scale_log2,
                cudaStream_t st, float* lse, int npad) {
  if (plan.ws) {
    if (plan.ksteps == 5)
      return launch_ws<2, 5, LSE>(a, ob, B, H, N, M, D, os, scale_log2, st, lse, npad);
    if (plan.na == 2)
      return launch_ws<2, 8, LSE>(a, ob, B, H, N, M, D, os, scale_log2, st, lse, npad);
    if constexpr (!LSE) {
      if (plan.na == 3) return launch_ws<3, 12>(a, ob, B, H, N, M, D, os, scale_log2, st);
      return launch_ws<4, 16>(a, ob, B, H, N, M, D, os, scale_log2, st);
    }
  }
  switch (plan.ksteps) {  // D <= 64: k-steps of QK^T
    case 1: return launch_wgmma<1, 1, 1, LSE>(a, ob, B, H, N, M, D, os, scale_log2, st, lse, npad);
    case 2: return launch_wgmma<1, 2, 1, LSE>(a, ob, B, H, N, M, D, os, scale_log2, st, lse, npad);
    case 3: return launch_wgmma<1, 3, 1, LSE>(a, ob, B, H, N, M, D, os, scale_log2, st, lse, npad);
    case 4: return launch_wgmma<1, 4, 1, LSE>(a, ob, B, H, N, M, D, os, scale_log2, st, lse, npad);
  }
  if constexpr (!LSE) {  // above 256, TMA layouts only
    if (plan.na == 6)
      return launch_wgmma_as<6, 24, 3, true>(a, ob, B, H, N, M, D, os, scale_log2, st);
    return launch_wgmma_as<8, 32, 4, true>(a, ob, B, H, N, M, D, os, scale_log2, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// lse: null, or (bf16, D <= 128) the [B * H, npad] row log-sum-exp to write
int launch(const void* q, const void* k, const void* v, void* o, int is_bf16,
           int vec, int B, int H, int N, int M, int D, Strides qs, Strides ks,
           Strides vs, Strides os, float scale_log2, cudaStream_t st,
           float* lse, int npad) {
  if (lse != nullptr && (!is_bf16 || D > 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) {
    // above D = 64 the kernels read q, k and v through TMA only
    if (D > 64 && vec != 0) return static_cast<int>(cudaErrorInvalidValue);
    using bf16 = __nv_bfloat16;
    WgmmaArgs a = {};  // tensor maps left zero when the threads load
    a.q = Operand{static_cast<const bf16*>(q), qs};
    a.k = Operand{static_cast<const bf16*>(k), ks};
    a.v = Operand{static_cast<const bf16*>(v), vs};
    a.vec = vec;
    const Bf16Plan plan = bf16_plan(D);
    if (vec == 0) {
      const EncodeTiled fn = encode_tiled();
      if (fn == nullptr) return -1;
      CUresult res =
          encode(fn, &a.tq, q, B, N, H, D, qs, plan.ws ? WS_ROWS : TILE);
      if (res == CUDA_SUCCESS) res = encode(fn, &a.tk, k, B, M, H, D, ks);
      if (res == CUDA_SUCCESS) res = encode(fn, &a.tv, v, B, M, H, D, vs);
      a.o_tma = plan.ws && D % 8 == 0;
      if (res == CUDA_SUCCESS && a.o_tma)
        res = encode(fn, &a.to, o, B, N, H, D, os);
      if (res != CUDA_SUCCESS) return -(1000 + static_cast<int>(res));
    }
    bf16* ob = static_cast<bf16*>(o);
    if (lse != nullptr)
      return launch_bf16<true>(a, plan, ob, B, H, N, M, D, os, scale_log2, st,
                               lse, npad);
    return launch_bf16<false>(a, plan, ob, B, H, N, M, D, os, scale_log2, st,
                              nullptr, 0);
  }
  return launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), static_cast<float*>(o), B, H,
                    N, M, D, qs, ks, vs, os, scale_log2, st);
}

}  // namespace

// Launches on `device` and its `stream` (switching the calling thread's
// current device for the launch only when it differs) and returns
// cudaGetLastError() (0 on success), or -1 when the driver has no
// cuTensorMapEncodeTiled, or -(1000 + CUresult) when a tensor map cannot be
// encoded. The caller checks shapes: 1 <= D <= 512, N >= 1, M >= 1,
// B*H <= 65535. bf16 `vec`: 0 reads q, k, v through TMA (bases 16-byte
// aligned, b, n, h strides multiples of 8 elements); up to D = 64, 4, 2 or
// 1 has the threads load them that many elements a copy (vec divides D, the
// strides and each base's alignment in elements). Above D = 64 a vec other
// than 0, and for f32 (which ignores vec) q, k, v whose bases are not
// 16-byte aligned or whose b, n, h strides are not multiples of 4 floats,
// return cudaErrorInvalidValue: no kernel reads them there.
extern "C" int dsdiff_flash_attention(
    const void* q, const void* k, const void* v, void* o, int is_bf16,
    int vec, int device, int B, int H, int N, int M, int D, long long q_sb,
    long long q_sn, long long q_sh, long long k_sb, long long k_sn,
    long long k_sh, long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh, float scale_log2,
    void* stream) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = launch(q, k, v, o, is_bf16, vec, B, H, N, M, D,
                        Strides{q_sb, q_sn, q_sh}, Strides{k_sb, k_sn, k_sh},
                        Strides{v_sb, v_sn, v_sh}, Strides{o_sb, o_sn, o_sh},
                        scale_log2, static_cast<cudaStream_t>(stream), nullptr,
                        0);
  if (current != device) cudaSetDevice(current);
  return rc;
}

// dsdiff_flash_attention's gradient-path launch (bf16, D <= 128): the same
// output, and each row's log-sum-exp of the scaled scores in log2 units,
// lse[(b * H + h) * npad + n] = log2(sum_m 2^(s_nm * scale_log2)), for n < N,
// and +inf for N <= n < npad (npad = N rounded up to 64), which the backward
// reads as rows whose probabilities are 0.
extern "C" int dsdiff_flash_attention_lse(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int npad, int vec, int device, int B, int H, int N, int M, int D,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn,
    long long v_sh, long long o_sb, long long o_sn, long long o_sh,
    float scale_log2, void* stream) {
  // on autograd's device thread (a remat recompute) as the backward entry
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = launch(q, k, v, o, 1, vec, B, H, N, M, D,
                        Strides{q_sb, q_sn, q_sh}, Strides{k_sb, k_sn, k_sh},
                        Strides{v_sb, v_sn, v_sh}, Strides{o_sb, o_sn, o_sh},
                        scale_log2, static_cast<cudaStream_t>(stream), lse,
                        npad);
  if (current != device) cudaSetDevice(current);
  return rc;
}

// The bf16 launch dsdiff_flash_attention makes for (B, H, N, D), into
// out[8]: kernel (0 attn_fwd_wgmma, 1 attn_fwd_ws), Q rows a block, K/V ring
// stages, threads a block, dynamic shared memory bytes, grid x, y, z.
extern "C" void dsdiff_flash_attention_bf16_plan(int B, int H, int N, int D,
                                                 int* out) {
  const Bf16Plan p = bf16_plan(D);
  const int rows = p.ws ? WS_ROWS : TILE;
  out[0] = p.ws;
  out[1] = rows;
  out[2] = p.ws ? ws_stages(p.na) : wg_stages(p.na);
  out[3] = p.ws ? WS_THREADS : WG;
  out[4] = p.ws ? ws_smem_bytes(p.na) : wg_smem_bytes(p.na, p.nv);
  out[5] = (N + rows - 1) / rows;
  out[6] = B * H;
  out[7] = p.na / p.nv;
}

// The f32 launch dsdiff_flash_attention makes for (B, H, N, D), into
// out[9]: kernel (0 attn_fwd_tf32x3, 1 attn_fwd_tf32x3_ws), Q rows a block,
// keys a tile, ring stages, threads a block, dynamic shared memory bytes,
// grid x, y, z.
extern "C" void dsdiff_flash_attention_f32_plan(int B, int H, int N, int D,
                                                int* out) {
  const F32Plan p = f32_plan(D);
  const int rows = p.ws ? fw_q_rows(p.split) : TILE;
  out[0] = p.ws;
  out[1] = rows;
  out[2] = p.kt;
  out[3] = p.ws ? FW_STAGES : F_STAGES;
  out[4] = p.ws ? FW_THREADS : F_THREADS;
  out[5] = p.ws ? fw_smem_bytes(p.dk / 4, p.kt, p.split) : f_smem_bytes(p.dk);
  out[6] = (N + rows - 1) / rows;
  out[7] = B * H;
  out[8] = 1;
}

// The backward of dsdiff_flash_attention_lse's call (bf16, D <= 128, a
// multiple of 8; q, k, v and dout [B, N|M, H, D] with 16-byte aligned
// bases and b, n, h strides multiples of 8 elements, the wrapper's copies
// where they are not): attn_bwd_dq where run_dq (delta into `delta`, then
// dq), then attn_bwd_dkdv where run_dkdv (it reads delta: run_dq must have
// run for dk). dq [B, N, H, D], dk and dv [B, M, H, D] contiguous, in bf16;
// lse and delta [B * H, npad]. Returns as dsdiff_flash_attention.
extern "C" int dsdiff_flash_attention_backward(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int npad,
    int device, int B, int H, int N, int M, int D, long long q_sb,
    long long q_sn, long long q_sh, long long k_sb, long long k_sn,
    long long k_sh, long long v_sb, long long v_sn, long long v_sh,
    long long g_sb, long long g_sn, long long g_sh, float scale_log2,
    float scale, int run_dq, int run_dkdv, void* stream) {
  if (D > 128 || D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  // autograd's device thread may not have made the context current yet
  // (cuTensorMapEncodeTiled then fails with CUDA_ERROR_INVALID_CONTEXT):
  // cudaSetDevice does, also where the device is already the current one
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  using bf16 = __nv_bfloat16;
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh},
      vs{v_sb, v_sn, v_sh}, gs{g_sb, g_sn, g_sh};
  BwArgs a_dq = {}, a_kv = {};
  CUresult res = CUDA_SUCCESS;
  if (run_dq) {
    res = encode(fn, &a_dq.a1, q, B, N, H, D, qs, BW_ROWS);
    if (res == CUDA_SUCCESS) res = encode(fn, &a_dq.a2, dout, B, N, H, D, gs, BW_ROWS);
    if (res == CUDA_SUCCESS) res = encode(fn, &a_dq.b1, k, B, M, H, D, ks);
    if (res == CUDA_SUCCESS) res = encode(fn, &a_dq.b2, v, B, M, H, D, vs);
    a_dq.out1 = static_cast<bf16*>(dq);
    a_dq.rows = N, a_dq.cols = M;
  }
  if (run_dkdv && res == CUDA_SUCCESS) {
    res = encode(fn, &a_kv.a1, k, B, M, H, D, ks, BW_ROWS);
    if (res == CUDA_SUCCESS) res = encode(fn, &a_kv.a2, v, B, M, H, D, vs, BW_ROWS);
    if (res == CUDA_SUCCESS) res = encode(fn, &a_kv.b1, q, B, N, H, D, qs);
    if (res == CUDA_SUCCESS) res = encode(fn, &a_kv.b2, dout, B, N, H, D, gs);
    a_kv.out1 = static_cast<bf16*>(dk);
    a_kv.out2 = static_cast<bf16*>(dv);
    a_kv.rows = M, a_kv.cols = N;
  }
  if (res != CUDA_SUCCESS) {
    if (current != device) cudaSetDevice(current);
    return -(1000 + static_cast<int>(res));
  }
  BwArgs* const both[2] = {&a_dq, &a_kv};
  for (BwArgs* a : both) {
    a->lse = lse, a->delta = delta;
    a->H = H, a->D = D, a->npad = npad;
    a->scale_log2 = scale_log2, a->scale = scale;
  }
  const BwPlan p = bw_plan(D);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (p.nout) {
#define BW_CASE(KS, NO)                                                     \
  case NO:                                                                  \
    rc = launch_bwd<KS, NO>(a_dq, a_kv, B, H, N, M, run_dq, run_dkdv, st);  \
    break;
    BW_CASE(2, 32)
    BW_CASE(3, 48)
    BW_CASE(4, 64)
    BW_CASE(5, 72)
    BW_CASE(5, 80)
    BW_CASE(6, 96)
    default:
      BW_CASE(8, 128)
#undef BW_CASE
  }
  if (current != device) cudaSetDevice(current);
  return rc;
}

// The launches dsdiff_flash_attention_backward makes for (B, H, N, M, D),
// D as the caller has it (padded to a multiple of 8 here), into out[10]:
// k-steps of S and dP, the output products' n, column-tile stages, threads
// a block, dynamic shared memory bytes, attn_bwd_dq's grid x, y,
// attn_bwd_dkdv's grid x, y, and npad.
extern "C" void dsdiff_flash_attention_bwd_plan(int B, int H, int N, int M,
                                                int D, int* out) {
  const BwPlan p = bw_plan((D + 7) / 8 * 8);
  out[0] = p.ksteps;
  out[1] = p.nout;
  out[2] = BW_STAGES;
  out[3] = BW_THREADS;
  out[4] = bw_smem_bytes((p.ksteps + 3) / 4);
  out[5] = (N + BW_ROWS - 1) / BW_ROWS;
  out[6] = B * H;
  out[7] = (M + BW_ROWS - 1) / BW_ROWS;
  out[8] = B * H;
  out[9] = (N + TILE - 1) / TILE * TILE;
}
