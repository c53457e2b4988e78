// Flash attention forward for Hopper (sm_90a): o = softmax(q k^T / sqrt(D)) v.
//
// Replaces the JAX package's Pallas TPU kernel ops/flash_attention.py:79
// flash_attention (body _attn_kernel :48-76): non-causal attention with an f32
// online softmax (running max and sum) so the [N, M] score matrix never
// reaches device memory.
//
// Layout: q [B, N, H, D], k and v [B, M, H, D], each read through its own
// strides (the last dimension contiguous), so q, k and v may be the strided
// thirds of the attention block's qkv projection and no transpose is needed.
// The output is written [B, N, H, D] in the input type (f32 or bf16).
//
// Design (simple and correct first; mma.sync / wgmma / TMA come later):
// - one thread block per (b*h, 64-row Q tile), 256 threads;
// - four threads per query row; each takes every fourth key of a tile, keeps
//   its own running max, sum and f32 accumulator, and the four partials of a
//   row are merged with warp shuffles at the end;
// - K and V tiles of 64 rows are staged in shared memory as f32, with the head
//   dimension padded to 64 there and in registers (D=48 is never padded in
//   device memory); a row stride of 68 floats keeps the four key groups'
//   float4 reads on distinct banks;
// - scores are pre-scaled by log2(e)/sqrt(D) and exponentiated with exp2f;
// - ragged N and M tails are masked (scores of missing keys are -inf).
//
// Bound on an H100 SXM at 700 W (989 TFLOP/s bf16, 3.35 TB/s), batch 16, per
// call at the flagship's three shapes (FLOPs = 4*B*H*N*M*D; bytes = q, k, v
// and o read or written once):
//   [16, 1024, 4, 48]  12.9 GFLOP  25.2 MB  ~13 us   bound by operations
//   [16,  256, 6, 48]  1.21 GFLOP   9.4 MB  ~2.8 us  bound by bytes
//   [16,   64, 6, 48]  0.08 GFLOP   2.4 MB  ~0.7 us  bound by bytes
// This kernel does its products on the f32 CUDA cores (67 TFLOP/s), so at
// N=1024 it cannot come near the tensor-core bound; PERF.md keeps its times.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;               // query rows per block
constexpr int BK = 64;               // key rows per shared-memory tile
constexpr int DP = 64;               // head dimension padded to this
constexpr int SPLIT = 4;             // threads per query row
constexpr int THREADS = BQ * SPLIT;  // 256
constexpr int KPT = BK / SPLIT;      // keys of a tile per thread
constexpr int LD = DP + 4;           // shared-memory row stride in floats

struct Strides {
  long long b, n, h;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows [r0, r0 + BK) of a [rows, D] slab with row stride sn -> dst[BK][LD]
// as f32, zero past the ragged row tail and past D.
template <typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ base,
                                          long long sn, int r0, int rows,
                                          int D) {
  for (int idx = threadIdx.x; idx < BK * DP; idx += THREADS) {
    const int r = idx / DP, d = idx % DP;
    float val = 0.f;
    if (r0 + r < rows && d < D) val = to_float(base[(long long)(r0 + r) * sn + d]);
    dst[r * LD + d] = val;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o, int H, int N,
                int M, int D, Strides qs, Strides kst, Strides vst,
                Strides ost, float scale_log2) {
  __shared__ __align__(16) float k_tile[BK * LD];
  __shared__ __align__(16) float v_tile[BK * LD];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int n0 = blockIdx.x * BQ;
  const int row = threadIdx.x / SPLIT;
  const int g = threadIdx.x % SPLIT;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * kst.b + h * kst.h;
  const T* vb = v + b * vst.b + h * vst.h;

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
  T* ob = o + b * ost.b + h * ost.h;
  for (int idx = threadIdx.x; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    if (n0 + r < N) store(ob + (long long)(n0 + r) * ost.n + d, k_tile[r * LD + d]);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller checks shapes: 1 <= D <= 64, N >= 1, M >= 1, B*H <= 65535.
extern "C" int dsdiff_flash_attention(
    const void* q, const void* k, const void* v, void* o, int is_bf16, int B,
    int H, int N, int M, int D, long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh, long long v_sb,
    long long v_sn, long long v_sh, long long o_sb, long long o_sn,
    long long o_sh, float scale_log2, void* stream) {
  const dim3 grid((N + BQ - 1) / BQ, B * H);
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh},
      vs{v_sb, v_sn, v_sh}, os{o_sb, o_sn, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    attn_fwd_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        H, N, M, D, qs, ks, vs, os, scale_log2);
  } else {
    attn_fwd_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), H, N, M, D, qs,
        ks, vs, os, scale_log2);
  }
  return static_cast<int>(cudaGetLastError());
}
