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
// Two routes, chosen by dtype in the C entry at the bottom:
//
// bf16: tensor cores through wgmma, K/V tiles through TMA (attn_fwd_wgmma).
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
//   4-stage ring). Above 64 it has one stage: the tiles grow with NA (73 KB
//   at D=192, 97 KB at 256), and the blocks that share an SM (three at 192,
//   two at 256) hide each other's loads; two stages would leave one block.
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
// - Layouts a TMA tensor map cannot describe (a base not 16-byte aligned, or
//   a batch, row or head stride that is not a multiple of 8 elements: the
//   head stride of 72 bytes at D=36 in DSUNet's cross-attention fusion, the
//   thirds of a fused qkv at such a D) take the same kernel with its tiles
//   loaded by the threads instead (template TMA = false): every thread
//   copies VEC elements at a time (8 or 4 bytes by cp.async, 2 bytes through
//   a register where nothing wider is aligned) into the same 128-byte
//   swizzled atoms TMA would write (16-byte chunk c of row r lands at chunk
//   c ^ (r % 8)), zeros past D and past the ragged row tail. The ring, its
//   stages and the products are those of the TMA route; a stage is waited
//   on with cp.async.wait_group, a proxy fence and a block barrier instead
//   of its mbarrier. The Python wrapper picks VEC (0 = TMA) from the bases,
//   the strides and D; nothing is copied or padded outside the kernel.
// It takes: D <= 512 and any strides with a contiguous last dimension.
// P enters the second product in bf16, as in jax.nn.dot_product_attention
// (probabilities cast to the value dtype).
//
// f32: three TF32 passes on the tensor cores (attn_fwd_tf32x3), mma.sync:
// - 4 warps (128 threads) per 64-row Q tile, one 16-row slab per warp; grid
//   (ceil(N/64), B*H). D is padded to a multiple of 8 (48 stays 48): DK =
//   ceil(D/8) k-steps of QK^T and n-tiles of PV.
// - A single TF32 pass keeps ~11 bits (an error of ~1e-3 at unit scale), so
//   each operand is split, a = hi + lo with hi = a rounded to TF32 (as
//   cvt.rna.tf32.f32 rounds) and lo = a - hi, and a b ~ lo_a hi_b + hi_a lo_b
//   + hi_a hi_b (small terms first), in both products: S = Q K^T and
//   O += P V, P in f32.
//   Operands are split in registers after a load of raw f32 from shared
//   memory, so shared memory holds one f32 copy of each tile.
// - mma.sync m16n8k8 rather than wgmma: .tf32 wgmma reads only K-major
//   operands from shared memory, and V is MN-major for PV; a B operand read
//   from shared memory would also need its lo half stored beside it.
// - Q is pre-scaled by log2(e)/sqrt(D) before its split; the online softmax
//   runs in f32 with ex2.approx.ftz, as the bf16 route.
// - S's accumulator is P's A fragment up to a permutation of the 8 keys of
//   each step, which PV's sum over keys does not see (see the kernel).
// - K/V tiles of 64 keys go through a 2-stage ring filled by cp.async: 16-byte
//   copies where the bases are 16-byte aligned and D and the strides are
//   multiples of 4 floats (the model's qkv thirds), else 4-byte copies; rows
//   padded to 8*DK + 4 floats keep fragment loads free of bank conflicts.
//   Shared memory: 5 tiles of 64 x (8*DK + 4) floats, 66,560 B at D=48.
// - Above D=64 the same design would not fit: Q's split fragments alone
//   would take 8 * DK registers a thread and five tiles 250,880 B at D=192,
//   above the 232,448 B a block may have. There DK is rounded up to 12, 16,
//   24 or 32 (fewer instantiations; the padding columns are zeros), Q stays
//   in shared memory and each k-step's fragment is loaded and split once per
//   K/V tile (the loop runs k-steps outside, the 8 key n-tiles inside), and
//   the ring has one stage: three tiles, 150,528 B at D=192, 199,680 B at 256.
// - Above D=256 (attn_fwd_tf32x3_wide) a Q tile and a K tile no longer fit
//   beside each other (132,096 B each at D=512). DK is rounded up to 48 or 64;
//   Q stays in shared memory, K is streamed in chunks of 64 columns (one
//   17,408 B buffer, filled, waited on and consumed 8 k-steps at a time), and
//   as on the bf16 route a block owns half of O's columns (DV = DK / 2 PV
//   n-tiles, grid z over the two halves) and holds only that half of each V
//   tile: 132,096 + 17,408 + 66,560 = 216,064 B at D=512 (166,912 B at 384).
//   Both blocks of a Q tile compute the full scores; the copies are not
//   overlapped with the products (a simple kernel first).
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
// [16, 256, 6, 48] ~7.3 us (operations), [16, 64, 6, 48] ~1.4 us (bytes).
// mma.sync reaches well under the wgmma rate, and each operand element costs
// three CUDA-core instructions to split (once per warp that reads it), so
// the split and the softmax, not the tensor cores, are expected to bound it.
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
template <int NA, int NV, int KSTEPS, bool TMA>
__global__ void __launch_bounds__(WG)
attn_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, Operand xq,
               Operand xk, Operand xv, int vec,
               __nv_bfloat16* __restrict__ o, int H, int N, int M, int D,
               Strides ost, float scale_log2) {
  constexpr int STAGES = wg_stages(NA);
  constexpr int TILE_BYTES = NA * ATOM_BYTES;
  constexpr int V_BYTES = NV * ATOM_BYTES;
  static_assert(KSTEPS <= 4 * NA, "k-steps past the tile");
  static_assert(NV == NA || 2 * NV == NA, "O's columns in one or two slices");
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
// box (64, 1, 64, 1), 128-byte swizzle, zero fill out of bounds
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int B,
                int rows, int H, int D, Strides s) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)rows,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s.h * 2, (cuuint64_t)s.n * 2,
                                 (cuuint64_t)s.b * 2};
  const cuuint32_t box[4] = {64, 1, TILE, 1};
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
};

template <int NA, int KSTEPS, int NV, bool TMA>
int launch_wgmma_as(const WgmmaArgs& a, __nv_bfloat16* o, int B, int H,
                    int N, int M, int D, Strides os, float scale_log2,
                    cudaStream_t st) {
  constexpr int smem = wg_smem_bytes(NA, NV);
  const auto kernel = attn_fwd_wgmma<NA, NV, KSTEPS, TMA>;
  static uint64_t opted_in = 0;
  const cudaError_t err = allow_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + TILE - 1) / TILE, B * H, NA / NV);
  kernel<<<grid, WG, smem, st>>>(a.tq, a.tk, a.tv, a.q, a.k, a.v, a.vec, o, H,
                                 N, M, D, os, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int NA, int KSTEPS, int NV = NA>
int launch_wgmma(const WgmmaArgs& a, __nv_bfloat16* o, int B, int H, int N,
                 int M, int D, Strides os, float scale_log2, cudaStream_t st) {
  if (a.vec == 0)
    return launch_wgmma_as<NA, KSTEPS, NV, true>(a, o, B, H, N, M, D, os,
                                                 scale_log2, st);
  return launch_wgmma_as<NA, KSTEPS, NV, false>(a, o, B, H, N, M, D, os,
                                                scale_log2, st);
}

// ---------------------------------------------------------------------------
// f32: three TF32 passes on the tensor cores (mma.sync m16n8k8)
// ---------------------------------------------------------------------------

constexpr int F_WARPS = 4;  // one 16-row slab of the 64-row Q tile per warp
constexpr int F_THREADS = 32 * F_WARPS;
// K/V ring depth; DK <= 8 also holds Q's split fragments in registers
__host__ __device__ constexpr int f_stages(int dk) { return dk <= 8 ? 2 : 1; }
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
  return (1 + 2 * f_stages(dk)) * f_tile_floats(dk) * 4;
}
static_assert(f_smem_bytes(32) <= 232448, "D=256 tiles above the block limit");

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

// O's rows row0 and row0 + 8 where below N, columns col0 + [0, 8 DV) below
// D, each over its row sum
template <int DV>
__device__ __forceinline__ void store_o_f32(const float (&acc)[DV][4],
                                            const float (&l_run)[2],
                                            float* ob, long long sn, int row0,
                                            int N, int col0, int D, int t) {
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
      const int col = col0 + 8 * dn + 2 * t;
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
  constexpr int LD = f_ld(DK);
  constexpr int TF = f_tile_floats(DK);
  constexpr int F_STAGES = f_stages(DK);
  constexpr bool Q_IN_REGS = DK <= 8;
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
  // held in registers for the whole run where DK <= 8
  uint32_t qh[Q_IN_REGS ? DK : 1][4], ql[Q_IN_REGS ? DK : 1][4];
  if constexpr (Q_IN_REGS) {
#pragma unroll
    for (int kk = 0; kk < DK; ++kk)
      q_frag_tf32<LD>(qr, kk, scale_log2, qh[kk], ql[kk]);
  }

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
    if constexpr (Q_IN_REGS) {
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
    } else {
      for (int kk = 0; kk < DK; ++kk) {
        uint32_t ah[4], al[4];
        q_frag_tf32<LD>(qr, kk, scale_log2, ah, al);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float* kr = kt + (8 * n + g) * LD + 8 * kk + t;
          uint32_t b0h, b0l, b1h, b1l;
          split_tf32(kr[0], b0h, b0l);
          split_tf32(kr[4], b1h, b1l);
          mma_3xtf32(sc[n], ah, al, b0h, b1h, b0l, b1l);
        }
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
                  n0 + 16 * warp + g, N, 0, D, t);
}

// Above D=256: Q (DK k-steps) in shared memory, K in chunks of KC_STEPS
// k-steps, half of V's columns; grid z picks the half of O a block owns.
constexpr int KC_STEPS = 8;  // 64 columns of K a chunk
__host__ __device__ constexpr int f_wide_smem_bytes(int dk) {
  return (f_tile_floats(dk) + f_tile_floats(KC_STEPS) + f_tile_floats(dk / 2)) *
         4;
}
static_assert(f_wide_smem_bytes(64) <= 232448, "D=512 tiles above the block limit");

template <int DK, bool VEC>
__global__ void __launch_bounds__(F_THREADS)
attn_fwd_tf32x3_wide(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int H,
                     int N, int M, int D, Strides qs, Strides kst, Strides vst,
                     Strides ost, float scale_log2) {
  constexpr int DV = DK / 2;  // PV n-tiles: this block's half of O's columns
  constexpr int LDQ = f_ld(DK), LDK = f_ld(KC_STEPS), LDV = f_ld(DV);
  extern __shared__ __align__(16) float fsm[];
  float* q_t = fsm;
  float* k_t = q_t + f_tile_floats(DK);
  float* v_t = k_t + f_tile_floats(KC_STEPS);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int n0 = blockIdx.x * TILE;
  const int ntiles = (M + TILE - 1) / TILE;
  const int col0 = 8 * DV * blockIdx.z;  // this block's first column of O
  const int chunks = (D + 8 * KC_STEPS - 1) / (8 * KC_STEPS);  // of K, below D
  const float* kb = k + b * kst.b + h * kst.h;
  const float* vb = v + b * vst.b + h * vst.h + col0;

  load_tile_f32<DK, VEC>(smem_u32(q_t), q + b * qs.b + h * qs.h, qs.n, n0, N,
                         D);  // waited on with the first K chunk

  float acc[DV][4];
#pragma unroll
  for (int dn = 0; dn < DV; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  const float* qr = q_t + (16 * warp + g) * LDQ + t;

  for (int j = 0; j < ntiles; ++j) {
    // this block's half of V's tile, waited on with the first K chunk
    load_tile_f32<DV, VEC>(smem_u32(v_t), vb, vst.n, j * TILE, M, D - col0);

    // S = (Q scale_log2) K^T for 64 keys, K a chunk of 64 columns at a time
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
    for (int ch = 0; ch < chunks; ++ch) {
      const int c0 = 8 * KC_STEPS * ch;
      load_tile_f32<KC_STEPS, VEC>(smem_u32(k_t), kb + c0, kst.n, j * TILE, M,
                                   D - c0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll 2
      for (int kc = 0; kc < KC_STEPS; ++kc) {
        const int kk = KC_STEPS * ch + kc;  // k-step of the whole row
        uint32_t ah[4], al[4];
        q_frag_tf32<LDQ>(qr, kk, scale_log2, ah, al);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float* kr = k_t + (8 * n + g) * LDK + 8 * kc + t;
          uint32_t b0h, b0l, b1h, b1l;
          split_tf32(kr[0], b0h, b0l);
          split_tf32(kr[4], b1h, b1l);
          mma_3xtf32(sc[n], ah, al, b0h, b1h, b0l, b1l);
        }
      }
      __syncthreads();  // every warp is done with the chunk: refill it
    }

    softmax_tile<DV>(sc, j, M, t, m_run, l_run, acc);
    pv_tf32x3<DV, LDV>(acc, sc, v_t, g, t);  // this block's columns
    __syncthreads();  // every warp is done with V's tile: refill it
  }

  store_o_f32<DV>(acc, l_run, o + b * ost.b + h * ost.h, ost.n,
                  n0 + 16 * warp + g, N, col0, D, t);
}

template <int DK, bool VEC>
int launch_tf32x3_wide(const float* q, const float* k, const float* v,
                       float* o, int B, int H, int N, int M, int D, Strides qs,
                       Strides ks, Strides vs, Strides os, float scale_log2,
                       cudaStream_t st) {
  constexpr int smem = f_wide_smem_bytes(DK);
  const auto kernel = attn_fwd_tf32x3_wide<DK, VEC>;
  static uint64_t opted_in = 0;
  const cudaError_t err = allow_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + TILE - 1) / TILE, B * H, 2);
  kernel<<<grid, F_THREADS, smem, st>>>(q, k, v, o, H, N, M, D, qs, ks, vs,
                                        os, scale_log2);
  return static_cast<int>(cudaGetLastError());
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

template <bool VEC>
int launch_f32(const float* q, const float* k, const float* v, float* o,
               int B, int H, int N, int M, int D, Strides qs, Strides ks,
               Strides vs, Strides os, float scale_log2, cudaStream_t st) {
#define F32_CASE(DK)                                                        \
  case DK:                                                                  \
    return launch_tf32x3<DK, VEC>(q, k, v, o, B, H, N, M, D, qs, ks, vs, os, \
                                  scale_log2, st);
  switch ((D + 7) / 8) {  // k-steps of QK^T, n-tiles of PV
    F32_CASE(1)
    F32_CASE(2)
    F32_CASE(3)
    F32_CASE(4)
    F32_CASE(5)
    F32_CASE(6)
    F32_CASE(7)
    F32_CASE(8)
  }
  // above D=64, DK rounded up to 12, 16, 24 or 32
#define F32_UP_TO(DK)                                                       \
  if (D <= 8 * DK)                                                          \
    return launch_tf32x3<DK, VEC>(q, k, v, o, B, H, N, M, D, qs, ks, vs, os, \
                                  scale_log2, st);
  F32_UP_TO(12)
  F32_UP_TO(16)
  F32_UP_TO(24)
  F32_UP_TO(32)
  // above D=256, DK rounded up to 48 or 64, O's columns in two halves
  if (D <= 384)
    return launch_tf32x3_wide<48, VEC>(q, k, v, o, B, H, N, M, D, qs, ks, vs,
                                       os, scale_log2, st);
  return launch_tf32x3_wide<64, VEC>(q, k, v, o, B, H, N, M, D, qs, ks, vs, os,
                                     scale_log2, st);
#undef F32_UP_TO
#undef F32_CASE
}

// 16-byte copies need a 16-byte aligned base and batch, row and head
// strides that are multiples of 4 floats
bool rows_aligned16(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 4 == 0 &&
         s.n % 4 == 0 && s.h % 4 == 0;
}

int launch(const void* q, const void* k, const void* v, void* o, int is_bf16,
           int vec, int B, int H, int N, int M, int D, Strides qs, Strides ks,
           Strides vs, Strides os, float scale_log2, cudaStream_t st) {
  if (is_bf16) {
    using bf16 = __nv_bfloat16;
    WgmmaArgs a = {};  // tensor maps left zero when the threads load
    a.q = Operand{static_cast<const bf16*>(q), qs};
    a.k = Operand{static_cast<const bf16*>(k), ks};
    a.v = Operand{static_cast<const bf16*>(v), vs};
    a.vec = vec;
    if (vec == 0) {
      const EncodeTiled fn = encode_tiled();
      if (fn == nullptr) return -1;
      CUresult res = encode(fn, &a.tq, q, B, N, H, D, qs);
      if (res == CUDA_SUCCESS) res = encode(fn, &a.tk, k, B, M, H, D, ks);
      if (res == CUDA_SUCCESS) res = encode(fn, &a.tv, v, B, M, H, D, vs);
      if (res != CUDA_SUCCESS) return -(1000 + static_cast<int>(res));
    }
    bf16* ob = static_cast<bf16*>(o);
    switch ((D + 15) / 16) {  // k-steps of QK^T; above 64, one atom more
      case 1: return launch_wgmma<1, 1>(a, ob, B, H, N, M, D, os, scale_log2, st);
      case 2: return launch_wgmma<1, 2>(a, ob, B, H, N, M, D, os, scale_log2, st);
      case 3: return launch_wgmma<1, 3>(a, ob, B, H, N, M, D, os, scale_log2, st);
      case 4: return launch_wgmma<1, 4>(a, ob, B, H, N, M, D, os, scale_log2, st);
    }
    if (D <= 128) return launch_wgmma<2, 8>(a, ob, B, H, N, M, D, os, scale_log2, st);
    if (D <= 192) return launch_wgmma<3, 12>(a, ob, B, H, N, M, D, os, scale_log2, st);
    if (D <= 256) return launch_wgmma<4, 16>(a, ob, B, H, N, M, D, os, scale_log2, st);
    // above 256: two blocks a Q tile, each owning half of O's columns
    if (D <= 384) return launch_wgmma<6, 24, 3>(a, ob, B, H, N, M, D, os, scale_log2, st);
    return launch_wgmma<8, 32, 4>(a, ob, B, H, N, M, D, os, scale_log2, st);
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  if (D % 4 == 0 && rows_aligned16(q, qs) && rows_aligned16(k, ks) &&
      rows_aligned16(v, vs))
    return launch_f32<true>(qf, kf, vf, of, B, H, N, M, D, qs, ks, vs, os,
                            scale_log2, st);
  return launch_f32<false>(qf, kf, vf, of, B, H, N, M, D, qs, ks, vs, os,
                           scale_log2, st);
}

}  // namespace

// Launches on `device` and its `stream` (switching the calling thread's
// current device for the launch only when it differs) and returns
// cudaGetLastError() (0 on success), or -1 when the driver has no
// cuTensorMapEncodeTiled, or -(1000 + CUresult) when a tensor map cannot be
// encoded. The caller checks shapes: 1 <= D <= 512, N >= 1, M >= 1,
// B*H <= 65535. bf16 `vec`: 0 reads q, k, v through TMA (bases 16-byte
// aligned, b, n, h strides multiples of 8 elements); 4, 2 or 1 has the
// threads load them that many elements a copy (vec divides D, the strides
// and each base's alignment in elements). f32 ignores it.
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
                        scale_log2, static_cast<cudaStream_t>(stream));
  if (current != device) cudaSetDevice(current);
  return rc;
}
