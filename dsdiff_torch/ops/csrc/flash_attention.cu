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
//   swizzle. The box is 64 wide whatever D is: TMA's out-of-bounds fill pads
//   D < 64 with zeros in shared memory only, so every tile row is 128 bytes
//   and the swizzled layout that wgmma reads is the same for every D. Ragged
//   N and M tails get the same zero fill.
// - K and V tiles of 64 keys go through a ring of two stages, each with an
//   mbarrier that TMA completes; thread 0 refills a stage as soon as the
//   warpgroup is done with it, so the load of tile j+1 overlaps the products
//   of tile j. Two stages keep shared memory at 41 KB, so up to five blocks
//   share an SM (scripts/torch_attention_variants.py times a 4-stage ring).
// - S = Q K^T: wgmma m64n64k16, A = Q and B = K from shared memory, both
//   K-major (D contiguous), ceil(D/16) k-steps (3 at D=48), f32 accumulate.
// - Online softmax in registers: scores pre-scaled by log2(e)/sqrt(D) and
//   exponentiated with ex2.approx.ftz; a row lives in the 4 lanes of a quad,
//   so row max and sum take two shuffles. Keys past M get -inf.
// - O += P V: wgmma m64n64k16 with P as the register A operand (the S
//   accumulator's fragment is, pair by pair, the A fragment of the next
//   product, so P is packed to bf16 in place) and V from shared memory as an
//   MN-major B operand (D contiguous, transpose bit set).
// - Epilogue: O / l in f32, rounded to bf16, stored to the strided o; rows
//   past N and columns past D are not stored.
// It takes: D <= 64, 16-byte aligned bases, and batch, row and head strides
// that are multiples of 8 elements (TMA's 16-byte stride rule); the Python
// wrapper checks this. P enters the second product in bf16, as in
// jax.nn.dot_product_attention (probabilities cast to the value dtype).
//
// f32: the scalar kernel (attn_fwd_scalar), CUDA-core FMAs:
// - one thread block per (b*h, 64-row Q tile), 256 threads; four threads per
//   query row, each on every fourth key of a tile, with its own running max,
//   sum and accumulator, merged with warp shuffles at the end;
// - K and V tiles of 64 rows staged in shared memory, the head dimension
//   padded to 64 there and in registers; a row stride of 68 floats keeps the
//   four key groups' float4 reads on distinct banks.
//
// Bound on an H100 SXM at 700 W (989 TFLOP/s bf16, 3.35 TB/s), batch 16, per
// call at the flagship's three shapes (FLOPs = 4*B*H*N*M*D; bytes = q, k, v
// and o read or written once):
//   [16, 1024, 4, 48]  12.9 GFLOP  25.2 MB  ~13 us   bound by operations
//   [16,  256, 6, 48]  1.21 GFLOP   9.4 MB  ~2.8 us  bound by bytes
//   [16,   64, 6, 48]  0.08 GFLOP   2.4 MB  ~0.7 us  bound by bytes
// The bf16 route runs both products on the tensor cores and reads each K/V
// tile once per Q tile through TMA; D=48 costs the tensor cores 3 k-steps of
// 16 in QK^T but a full n64 in PV. At D=48 a score costs the tensor cores
// ~190 FLOPs but the softmax ~5 CUDA-core instructions (max, fma, ex2, sum,
// half a pack), so the softmax's instruction issue, not the tensor cores,
// bounds this route: each of those is kept to one instruction, and enough
// blocks share an SM to hide the products' latency. The f32 route (67
// TFLOP/s CUDA cores) cannot come near its bound at N=1024; no f32 tensor
// reaches it on the bf16 main path.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, n, h;
};

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int WG = 128;                      // one warpgroup
constexpr int TILE = 64;                     // Q rows, and keys per K/V tile
constexpr int TILE_BYTES = TILE * 64 * 2;    // 64 rows of 128 bytes
constexpr int STAGES = 2;                    // K/V ring depth
constexpr int SMEM_BYTES = (1 + 2 * STAGES) * TILE_BYTES + 1024;  // + align
static_assert(SMEM_BYTES <= 48 * 1024, "above 48 KB needs an opt-in");

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

// one (64 x 64) box at (d=0, h, row, b) of a 4-D map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int h, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(h), "r"(row),
      "r"(b)
      : "memory");
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

// Accumulator fragment of wgmma m64nN (f32), thread t of the warpgroup:
// warp w = t / 32 owns rows 16w..16w+15; with g = (t % 32) / 4 and
// c = 2 * (t % 4), element 4i + 2r + e is (row 16w + g + 8r, col 8i + c + e).
template <int KSTEPS>
__global__ void __launch_bounds__(WG)
attn_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ o, int H, int N, int M, int D,
               Strides ost, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[STAGES + 1];  // K/V stages, then Q

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_smem = base;
  const auto k_smem = [&](int s) { return base + (1 + s) * TILE_BYTES; };
  const auto v_smem = [&](int s) {
    return base + (1 + STAGES + s) * TILE_BYTES;
  };
  const uint32_t bar0 = smem_u32(bars);
  const auto bar = [&](int s) { return bar0 + 8u * s; };
  const uint32_t q_bar = bar(STAGES);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int n0 = blockIdx.x * TILE;
  const int ntiles = (M + TILE - 1) / TILE;

  if (tid == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(bar(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, TILE_BYTES);
    tma_load(q_smem, &tq, q_bar, h, n0, b);
    for (int s = 0; s < STAGES && s < ntiles; ++s) {
      mbar_expect_tx(bar(s), 2 * TILE_BYTES);
      tma_load(k_smem(s), &tk, bar(s), h, s * TILE, b);
      tma_load(v_smem(s), &tv, bar(s), h, s * TILE, b);
    }
  }

  float acc[32], sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = sc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  const int c = 2 * (lane % 4);

  // Q and K: 8-row groups 1024 bytes apart (SBO); a k-step of 16 columns
  // moves the start 32 bytes inside the 128-byte swizzle atom. V: the
  // contraction runs over its rows, so a k-step of 16 keys moves 2048 bytes;
  // the 64 columns are one atom wide, so the LBO is never stepped.
  const uint64_t q_desc = make_desc(q_smem, 16, 1024);
  mbar_wait(q_bar, 0);

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % STAGES;
    mbar_wait(bar(s), (j / STAGES) & 1);

    const uint64_t k_desc = make_desc(k_smem(s), 16, 1024);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma_ss(sc, q_desc + 2 * kk, k_desc + 2 * kk, kk);
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
        acc[4 * i + 2 * r] *= alpha[r];
        acc[4 * i + 2 * r + 1] *= alpha[r];
      }
    }

    const uint64_t v_desc = make_desc(v_smem(s), 8192, 1024);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
               v_desc + 128 * kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);

    __syncthreads();  // every warp is done with stage s: refill it
    if (tid == 0 && j + STAGES < ntiles) {
      mbar_expect_tx(bar(s), 2 * TILE_BYTES);
      tma_load(k_smem(s), &tk, bar(s), h, (j + STAGES) * TILE, b);
      tma_load(v_smem(s), &tv, bar(s), h, (j + STAGES) * TILE, b);
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
    for (int i = 0; i < 8; ++i) {
      const int col = 8 * i + c;
      const float v0 = acc[4 * i + 2 * r] * inv_l;
      const float v1 = acc[4 * i + 2 * r + 1] * inv_l;
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

template <int KSTEPS>
int launch_wgmma(const CUtensorMap& tq, const CUtensorMap& tk,
                 const CUtensorMap& tv, __nv_bfloat16* o, int B, int H, int N,
                 int M, int D, Strides os, float scale_log2, cudaStream_t st) {
  const dim3 grid((N + TILE - 1) / TILE, B * H);
  attn_fwd_wgmma<KSTEPS><<<grid, WG, SMEM_BYTES, st>>>(tq, tk, tv, o, H, N, M,
                                                       D, os, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: scalar CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int BQ = 64;               // query rows per block
constexpr int BK = 64;               // key rows per shared-memory tile
constexpr int DP = 64;               // head dimension padded to this
constexpr int SPLIT = 4;             // threads per query row
constexpr int THREADS = BQ * SPLIT;  // 256
constexpr int KPT = BK / SPLIT;      // keys of a tile per thread
constexpr int LD = DP + 4;           // shared-memory row stride in floats

// rows [r0, r0 + BK) of a [rows, D] slab with row stride sn -> dst[BK][LD],
// zero past the ragged row tail and past D.
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ base,
                                          long long sn, int r0, int rows,
                                          int D) {
  for (int idx = threadIdx.x; idx < BK * DP; idx += THREADS) {
    const int r = idx / DP, d = idx % DP;
    float val = 0.f;
    if (r0 + r < rows && d < D) val = base[(long long)(r0 + r) * sn + d];
    dst[r * LD + d] = val;
  }
}

__global__ void __launch_bounds__(THREADS)
attn_fwd_scalar(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int H,
                int N, int M, int D, Strides qs, Strides kst, Strides vst,
                Strides ost, float scale_log2) {
  __shared__ __align__(16) float k_tile[BK * LD];
  __shared__ __align__(16) float v_tile[BK * LD];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int n0 = blockIdx.x * BQ;
  const int row = threadIdx.x / SPLIT;
  const int g = threadIdx.x % SPLIT;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * kst.b + h * kst.h;
  const float* vb = v + b * vst.b + h * vst.h;

  // the Q tile goes through shared memory so its loads are coalesced
  load_tile(k_tile, qb, qs.n, n0, N, D);
  __syncthreads();
  float qr[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) qr[d] = k_tile[row * LD + d] * scale_log2;
  __syncthreads();

  float acc[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) acc[d] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;

  for (int m0 = 0; m0 < M; m0 += BK) {
    load_tile(k_tile, kb, kst.n, m0, M, D);
    load_tile(v_tile, vb, vst.n, m0, M, D);
    __syncthreads();

    float s[KPT];
    float m_tile = -INFINITY;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int j = i * SPLIT + g;
      const float4* kr = reinterpret_cast<const float4*>(k_tile + j * LD);
      float dot = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DP / 4; ++d4) {
        const float4 kv = kr[d4];
        dot = fmaf(qr[4 * d4 + 0], kv.x, dot);
        dot = fmaf(qr[4 * d4 + 1], kv.y, dot);
        dot = fmaf(qr[4 * d4 + 2], kv.z, dot);
        dot = fmaf(qr[4 * d4 + 3], kv.w, dot);
      }
      s[i] = (m0 + j < M) ? dot : -INFINITY;
      m_tile = fmaxf(m_tile, s[i]);
    }

    // online softmax; m_base keeps exp2f's argument finite while a thread
    // has seen no valid key yet
    const float m_new = fmaxf(m_run, m_tile);
    const float m_base = (m_new == -INFINITY) ? 0.f : m_new;
    const float alpha = exp2f(m_run - m_base);
    l_run *= alpha;
#pragma unroll
    for (int d = 0; d < DP; ++d) acc[d] *= alpha;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int j = i * SPLIT + g;
      const float p = exp2f(s[i] - m_base);
      l_run += p;
      const float4* vr = reinterpret_cast<const float4*>(v_tile + j * LD);
#pragma unroll
      for (int d4 = 0; d4 < DP / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
      }
    }
    m_run = m_new;
    __syncthreads();
  }

  // merge the SPLIT partials of a row: its threads are adjacent lanes of
  // one warp
#pragma unroll
  for (int off = 1; off < SPLIT; off <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m_run, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l_run, off);
    const float m_new = fmaxf(m_run, m_o);
    const float m_base = (m_new == -INFINITY) ? 0.f : m_new;
    const float a = exp2f(m_run - m_base);
    const float a_o = exp2f(m_o - m_base);
    l_run = l_run * a + l_o * a_o;
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      const float acc_o = __shfl_xor_sync(0xffffffffu, acc[d], off);
      acc[d] = acc[d] * a + acc_o * a_o;
    }
    m_run = m_new;
  }

  // stage the normalised tile in shared memory, then store it coalesced
  if (g == 0) {
    const float inv_l = 1.f / l_run;
#pragma unroll
    for (int d = 0; d < DP; ++d) k_tile[row * LD + d] = acc[d] * inv_l;
  }
  __syncthreads();
  float* ob = o + b * ost.b + h * ost.h;
  for (int idx = threadIdx.x; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    if (n0 + r < N) ob[(long long)(n0 + r) * ost.n + d] = k_tile[r * LD + d];
  }
}

int launch(const void* q, const void* k, const void* v, void* o, int is_bf16,
           int B, int H, int N, int M, int D, Strides qs, Strides ks,
           Strides vs, Strides os, float scale_log2, cudaStream_t st) {
  if (is_bf16) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return -1;
    CUtensorMap tq, tk, tv;
    CUresult res = encode(fn, &tq, q, B, N, H, D, qs);
    if (res == CUDA_SUCCESS) res = encode(fn, &tk, k, B, M, H, D, ks);
    if (res == CUDA_SUCCESS) res = encode(fn, &tv, v, B, M, H, D, vs);
    if (res != CUDA_SUCCESS) return -(1000 + static_cast<int>(res));
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(o);
    switch ((D + 15) / 16) {  // k-steps of QK^T
      case 1: return launch_wgmma<1>(tq, tk, tv, ob, B, H, N, M, D, os, scale_log2, st);
      case 2: return launch_wgmma<2>(tq, tk, tv, ob, B, H, N, M, D, os, scale_log2, st);
      case 3: return launch_wgmma<3>(tq, tk, tv, ob, B, H, N, M, D, os, scale_log2, st);
      default: return launch_wgmma<4>(tq, tk, tv, ob, B, H, N, M, D, os, scale_log2, st);
    }
  }
  const dim3 grid((N + BQ - 1) / BQ, B * H);
  attn_fwd_scalar<<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, N, M, D, qs, ks,
      vs, os, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `device` and its `stream` (switching the calling thread's
// current device for the launch only when it differs) and returns
// cudaGetLastError() (0 on success), or -1 when the driver has no
// cuTensorMapEncodeTiled, or -(1000 + CUresult) when a tensor map cannot be
// encoded. The caller checks shapes and, for bf16, alignment: 1 <= D <= 64,
// N >= 1, M >= 1, B*H <= 65535; bf16 bases 16-byte aligned and b, n, h
// strides multiples of 8 elements.
extern "C" int dsdiff_flash_attention(
    const void* q, const void* k, const void* v, void* o, int is_bf16,
    int device, int B, int H, int N, int M, int D, long long q_sb,
    long long q_sn, long long q_sh, long long k_sb, long long k_sn,
    long long k_sh, long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh, float scale_log2,
    void* stream) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = launch(q, k, v, o, is_bf16, B, H, N, M, D,
                        Strides{q_sb, q_sn, q_sh}, Strides{k_sb, k_sn, k_sh},
                        Strides{v_sb, v_sn, v_sh}, Strides{o_sb, o_sn, o_sh},
                        scale_log2, static_cast<cudaStream_t>(stream));
  if (current != device) cudaSetDevice(current);
  return rc;
}
