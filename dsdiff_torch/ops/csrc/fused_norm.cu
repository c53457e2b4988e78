// Fused GroupNorm + SiLU for Hopper (sm_90a): y = SiLU(GroupNorm(x) *
// (1 + scale) + shift), the whole function, statistics included, or
// y = SiLU(GroupNorm(x)) where there is no FiLM. One C entry,
// dsdiff_group_norm_film_silu, serves two callers:
//   - without the FiLM, on a channels-last map at eps 1e-5, it replaces the
//     JAX package's Pallas TPU kernel ops/fused_norm.py:54 group_norm_silu:
//     its group statistics (XLA ops, :64-71) and its apply pass (body
//     _affine_silu_kernel :47-51). With mean and E[x^2] per (batch, group),
//     var = E[x^2] - mean^2, a = gamma * rsqrt(var + eps) and b = beta -
//     mean * a per (batch, channel), y = SiLU(x * a + b);
//   - with it, it is the port's ResBlock norm site (models/layers.py
//     GroupNorm32.silu; the JAX package runs GroupNorm32, the FiLM and SiLU
//     as XLA ops, its models/layers.py:165-188), added because that chain
//     of eager ops (an f32 up-cast, moments, apply, a bf16 down-cast, the
//     FiLM's mul and add, SiLU) was the largest share of the serving
//     forward's device time. The FiLM's per-(batch, channel) scale s and
//     shift t fold into the same a and b: a = gamma * rsqrt(var + eps) *
//     (1 + s), b = (beta - mean * gamma * rsqrt(var + eps)) * (1 + s) + t;
//     y is rounded once.
// It takes the map in either memory format the model hands it:
//   - channels last, x [B, H*W, C]: two kernels (group_norm_partial_stats,
//     group_norm_silu_apply), the apply given s and t where there is a FiLM;
//   - NCHW, x [B, C, H*W]: a (batch, group) is one contiguous run of
//     C/G * H*W elements, cut into chunks of `len` elements (a multiple of
//     8, so every chunk starts 16-byte aligned). Where the run is one chunk
//     (the small maps), one launch: group_norm_film_silu_nchw sums the run,
//     forms a and b and applies, reading the run twice (the second time
//     from L1/L2). Elsewhere two: group_norm_nchw_partial_stats writes one
//     f64 (sum, sum of squares) per chunk, then group_norm_film_silu_nchw
//     reduces its run's chunks in a fixed order and applies to its chunk.
//     A 16-byte vector lies in one channel (H*W is a multiple of the vector
//     width), so each takes one (a, b) pair from shared memory.
//
// Channels last: x and y [B, H*W, C], contiguous, f32 or bf16 (y has x's
// type); gamma and beta [C] f32. Both kernels run on grid (chunks, B): block
// (i, b) owns spatial rows [i * rows, (i + 1) * rows) of batch row b, the
// last chunk ragged. The wrapper picks rows (a multiple of 8, so every
// chunk starts 16-byte aligned) and chunks: about two blocks per SM over
// the batch, fewer where a chunk would give a thread under two vectors.
//
// 1. group_norm_partial_stats: each thread reads 16-byte vectors (8 bf16
//    or 4 f32; one element where the row is not 16-byte aligned) of its
//    chunk with a step of TP vectors, TP a multiple of C / gcd(C, vector),
//    so its vector's channels stay the same on every step: it keeps one f32
//    sum and sum of squares per vector slot in registers (C / G is 3, 6 or
//    9 on the flagship, so a vector straddles groups). The block folds its
//    threads' slots into channels, then groups, in shared memory in f64,
//    and writes [B, chunks, G, 2] f64 partials (sum, sum of squares) to a
//    scratch tensor from the wrapper.
// 2. group_norm_silu_apply: each block first reduces its batch row's
//    partials (a few KB, in L2) in f64, forms mean, var, a and b (the FiLM
//    folded in where there is one) for the row's C channels in shared
//    memory, then runs the 16-byte apply loop over its chunk (coefficients
//    read as float4 where C is a multiple of the vector width; SiLU through
//    ex2 and rcp, which the bf16 apply needs to keep up with the memory).
// Every sum is taken in a fixed order and there are no float atomics, so
// two calls on one input give bitwise-equal output. The sums are f64 from
// the threads' f32 partials up, so E[x^2] - mean^2 keeps its digits where
// |mean| >> std better than the f32 formula it computes.
//
// Bound on an H100 SXM at 700 W (3.35 TB/s), both forms: bytes. x read
// once and y written once: [4, 256, 256, 96] bf16 moves 100.7 MB, ~0.030
// ms; the arithmetic (about 9 FLOPs and one exp per element) is two orders of
// magnitude under the f32 CUDA-core rate. Kernel 2 reads x again: from L2
// where x fits it (50 MB), from device memory where it does not
// ([4, 256, 256, 96] bf16 is 50.3 MB, every batch-16 256^2 row more), so
// there at most about 2/3 of the bound (three passes over x-sized data
// against two) can be reached. Every kernel's name holds "group_norm", so
// that a profile sorts its time under GroupNorm.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int STATS_UNROLL = 4;  // vectors in flight per thread, kernel 1
constexpr int APPLY_UNROLL = 4;  // and kernel 2
constexpr int NCHW_UNROLL = 4;   // and both NCHW kernels
constexpr int WARPS = THREADS / 32;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// y * sigmoid(y) in two special-function ops (ex2, rcp); within a few ulps
// of y / (1 + expf(-y)) for |y| below ~80, and 0 (its limit) below that
__device__ __forceinline__ float silu(float y) {
  return __fdividef(y, 1.f + __expf(-y));
}

// what one load moves: a 16-byte vector, or one element
template <typename T, bool VEC>
using Raw = std::conditional_t<VEC, uint4, T>;
template <typename T, bool VEC>
__host__ __device__ constexpr int width() {
  return VEC ? Vec<T>::N : 1;
}

// Kernel 1. P = C / gcd(C, V) vectors hold a whole number of rows' worth
// of channels; threads [0, TP), TP a multiple of P, load; the rest idle.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
group_norm_partial_stats(const T* __restrict__ x, double* __restrict__ partials,
                 int HW, int C, int G, int rows, int P, int TP) {
  using R = Raw<T, VEC>;
  constexpr int V = width<T, VEC>();
  extern __shared__ double2 stat_smem[];
  double2* red = stat_smem;  // [P * V]: per element of a period of channels
  float2* part = reinterpret_cast<float2*>(stat_smem + P * V);  // [TP * V]

  const int tid = threadIdx.x, chunk = blockIdx.x, batch = blockIdx.y;
  const int r0 = chunk * rows;
  const int r1 = min(HW, r0 + rows);
  const R* xc =
      reinterpret_cast<const R*>(x + ((long long)batch * HW + r0) * C);
  const long long nv = (long long)(r1 - r0) * C / V;

  float s[V], q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = q[j] = 0.f;
  if (tid < TP) {
    for (long long k = tid; k < nv; k += (long long)STATS_UNROLL * TP) {
      R raw[STATS_UNROLL];
#pragma unroll
      for (int u = 0; u < STATS_UNROLL; ++u)
        if (k + u * TP < nv) raw[u] = xc[k + u * TP];
#pragma unroll
      for (int u = 0; u < STATS_UNROLL; ++u) {
        if (k + u * TP >= nv) break;
        const T* in = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float f = to_float(in[j]);
          s[j] += f;
          q[j] = fmaf(f, f, q[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) part[tid * V + j] = make_float2(s[j], q[j]);
  }
  __syncthreads();

  // element u of a period is channel u % C (P * V is a multiple of C, and a
  // chunk starts at a row); threads i = u / V + m P hold it in slot u % V
  for (int u = tid; u < P * V; u += THREADS) {
    double su = 0.0, qu = 0.0;
    for (int i = u / V; i < TP; i += P) {
      const float2 pv = part[i * V + u % V];
      su += pv.x;
      qu += pv.y;
    }
    red[u] = make_double2(su, qu);
  }
  __syncthreads();

  const int cpg = C / G, reps = P * V / C;
  double2* out = reinterpret_cast<double2*>(partials) +
                 ((long long)batch * gridDim.x + chunk) * G;
  for (int grp = tid; grp < G; grp += THREADS) {
    double sg = 0.0, qg = 0.0;
    for (int rep = 0; rep < reps; ++rep)
      for (int c = grp * cpg; c < (grp + 1) * cpg; ++c) {
        sg += red[rep * C + c].x;
        qg += red[rep * C + c].y;
      }
    out[grp] = make_double2(sg, qg);
  }
}

// Kernel 2. RP = max(1, THREADS / (2G)) threads share each of the 2G
// (group, statistic) sums over the row's chunks.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
group_norm_silu_apply(const T* __restrict__ x,
                      const double* __restrict__ partials,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta,
                      const T* __restrict__ scale, const T* __restrict__ shift,
                      int film_stride, T* __restrict__ y, int HW, int C,
                      int G, int rows, float eps) {
  using R = Raw<T, VEC>;
  constexpr int V = width<T, VEC>();
  const int items = 2 * G, RP = max(1, THREADS / items);
  extern __shared__ double apply_smem[];
  double* red = apply_smem;  // [items * RP], then the row's sums in [items]
  // a[C] and b[C], 16-byte aligned (items is even) for float4 reads where
  // C is a multiple of the vector width
  float* sa = reinterpret_cast<float*>(apply_smem + items * RP);
  float* sb = sa + C;

  const int tid = threadIdx.x, chunk = blockIdx.x, batch = blockIdx.y;
  const int chunks = gridDim.x;
  const double* pb = partials + (long long)batch * chunks * items;
  for (int it = tid; it < items * RP; it += THREADS) {
    const int item = it % items, p = it / items;
    double acc = 0.0;
    int ch = p;
    for (; ch + 7 * RP < chunks; ch += 8 * RP) {  // 8 loads in flight
      double v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = pb[(ch + i * RP) * items + item];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc += v[i];
    }
    for (; ch < chunks; ch += RP) acc += pb[ch * items + item];
    red[it] = acc;
  }
  __syncthreads();
  for (int item = tid; item < items; item += THREADS) {
    double acc = red[item];
    for (int p = 1; p < RP; ++p) acc += red[p * items + item];
    red[item] = acc;  // only this thread reads red[item + p * items]
  }
  __syncthreads();
  const int cpg = C / G;
  const double n = (double)HW * cpg;
  for (int c = tid; c < C; c += THREADS) {
    const int grp = c / cpg;
    const double mean = red[2 * grp] / n;
    const double var = red[2 * grp + 1] / n - mean * mean;
    float a = (float)(1.0 / sqrt(var + (double)eps)) * gamma[c];
    float b = beta[c] - (float)mean * a;
    if (scale != nullptr) {  // the FiLM of this batch row
      const long long f = (long long)batch * film_stride + c;
      const float s1 = 1.f + to_float(scale[f]);
      a *= s1;
      b = fmaf(b, s1, to_float(shift[f]));
    }
    sa[c] = a;
    sb[c] = b;
  }
  __syncthreads();

  const int r0 = chunk * rows;
  const int r1 = min(HW, r0 + rows);
  const long long offset = ((long long)batch * HW + r0) * C;
  const R* xc = reinterpret_cast<const R*>(x + offset);
  R* yc = reinterpret_cast<R*>(y + offset);
  const long long nv = (long long)(r1 - r0) * C / V;
  // the chunk starts at channel 0; THREADS vectors on, the channel moves by
  // step (mod C)
  const int step = (int)(((long long)THREADS * V) % C);
  int c = (int)(((long long)tid * V) % C);
  for (long long k = tid; k < nv; k += (long long)APPLY_UNROLL * THREADS) {
    R raw[APPLY_UNROLL];
    int cs[APPLY_UNROLL];
#pragma unroll
    for (int u = 0; u < APPLY_UNROLL; ++u) {
      cs[u] = c;
      c += step;
      if (c >= C) c -= C;
      if (k + u * THREADS < nv) raw[u] = xc[k + u * THREADS];
    }
#pragma unroll
    for (int u = 0; u < APPLY_UNROLL; ++u) {
      if (k + u * THREADS >= nv) break;
      const T* in = reinterpret_cast<const T*>(&raw[u]);
      R res;
      T* outv = reinterpret_cast<T*>(&res);
      int cc = cs[u];
      if constexpr (VEC) {
        if (C % V == 0) {  // the vector's channels are cc .. cc + V - 1
#pragma unroll
          for (int j = 0; j < V; j += 4) {
            const float4 a4 = *reinterpret_cast<const float4*>(sa + cc + j);
            const float4 b4 = *reinterpret_cast<const float4*>(sb + cc + j);
            outv[j] = from_float<T>(silu(fmaf(to_float(in[j]), a4.x, b4.x)));
            outv[j + 1] =
                from_float<T>(silu(fmaf(to_float(in[j + 1]), a4.y, b4.y)));
            outv[j + 2] =
                from_float<T>(silu(fmaf(to_float(in[j + 2]), a4.z, b4.z)));
            outv[j + 3] =
                from_float<T>(silu(fmaf(to_float(in[j + 3]), a4.w, b4.w)));
          }
          yc[k + u * THREADS] = res;
          continue;
        }
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        outv[j] = from_float<T>(silu(fmaf(to_float(in[j]), sa[cc], sb[cc])));
        cc = (cc + 1 == C) ? 0 : cc + 1;
      }
      yc[k + u * THREADS] = res;
    }
  }
}

// ---- NCHW: x and y [B, C, H*W]; grid (chunks, B * G), block (i, bg)
// owns elements [i * len, (i + 1) * len) of run bg = batch * G + group.

// this thread's f32 sum and sum of squares over the n elements at p (n a
// multiple of the vector width): one slot per vector element, so no sum
// waits on the one before it, folded in a fixed order at the end
template <typename T, bool VEC>
__device__ __forceinline__ float2 thread_sums(const T* __restrict__ p,
                                              long long n) {
  using R = Raw<T, VEC>;
  constexpr int V = width<T, VEC>();
  const R* pv = reinterpret_cast<const R*>(p);
  const long long nv = n / V;
  float s[V], q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = q[j] = 0.f;
  for (long long k = threadIdx.x; k < nv;
       k += (long long)NCHW_UNROLL * THREADS) {
    R raw[NCHW_UNROLL];
#pragma unroll
    for (int u = 0; u < NCHW_UNROLL; ++u)
      if (k + u * THREADS < nv) raw[u] = pv[k + u * THREADS];
#pragma unroll
    for (int u = 0; u < NCHW_UNROLL; ++u) {
      if (k + u * THREADS >= nv) break;
      const T* in = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_float(in[j]);
        s[j] += f;
        q[j] = fmaf(f, f, q[j]);
      }
    }
  }
#pragma unroll
  for (int j = 1; j < V; ++j) {
    s[0] += s[j];
    q[0] += q[j];
  }
  return make_float2(s[0], q[0]);
}

// the block's sum of every thread's (s, q) in f64, in a fixed order: a
// warp's butterfly, then the warps in order; every thread gets it
__device__ __forceinline__ double2 block_sum(double s, double q,
                                             double2* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    q += __shfl_xor_sync(0xffffffffu, q, o);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = make_double2(s, q);
  __syncthreads();
  double2 t = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    t.x += red[w].x;
    t.y += red[w].y;
  }
  return t;
}

// kernel 1 of two: one f64 (sum, sum of squares) per chunk of each run
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
group_norm_nchw_partial_stats(const T* __restrict__ x,
                              double2* __restrict__ partials, int run,
                              int len) {
  __shared__ double2 red[WARPS];
  const long long s0 = (long long)blockIdx.x * len;
  const float2 p = thread_sums<T, VEC>(x + (long long)blockIdx.y * run + s0,
                                       min((long long)len, run - s0));
  const double2 t = block_sum(p.x, p.y, red);
  if (threadIdx.x == 0)
    partials[(long long)blockIdx.y * gridDim.x + blockIdx.x] = t;
}

// the apply, and with one chunk a run (gridDim.x == 1) the statistics too:
// the group's a and b for its C / G channels in shared memory, in f64 from
// the sums, then y = SiLU(x * a + b) over the block's chunk
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
group_norm_film_silu_nchw(const T* __restrict__ x,
                          const double2* __restrict__ partials,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta,
                          const T* __restrict__ scale,
                          const T* __restrict__ shift, int film_stride,
                          T* __restrict__ y, int C, int G, int HW, int len,
                          float eps) {
  using R = Raw<T, VEC>;
  constexpr int V = width<T, VEC>();
  __shared__ double2 red[WARPS];
  extern __shared__ float coef[];  // a[C / G], then b[C / G]
  const int chunks = gridDim.x, bg = blockIdx.y, cpg = C / G;
  const int batch = bg / G, c0 = (bg % G) * cpg;
  const int run = cpg * HW;
  const T* xr = x + (long long)bg * run;

  double2 t;
  if (chunks == 1) {
    const float2 p = thread_sums<T, VEC>(xr, run);
    t = block_sum(p.x, p.y, red);
  } else {  // warp 0 reduces the run's chunks: lane-strided, then butterfly
    if (threadIdx.x < 32) {
      double s = 0.0, q = 0.0;
      for (int i = threadIdx.x; i < chunks; i += 32) {
        const double2 v = partials[(long long)bg * chunks + i];
        s += v.x;
        q += v.y;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        q += __shfl_xor_sync(0xffffffffu, q, o);
      }
      if (threadIdx.x == 0) red[0] = make_double2(s, q);
    }
    __syncthreads();
    t = red[0];
  }
  const double mean = t.x / run;
  const double var = fmax(t.y / run - mean * mean, 0.0);
  const double inv = 1.0 / sqrt(var + (double)eps);
  for (int j = threadIdx.x; j < cpg; j += THREADS) {
    const int c = c0 + j;
    const double ga = inv * gamma[c];
    double a = ga, b = beta[c] - mean * ga;
    if (scale != nullptr) {
      const long long f = (long long)batch * film_stride + c;
      const double s1 = 1.0 + (double)to_float(scale[f]);
      a *= s1;
      b = b * s1 + (double)to_float(shift[f]);
    }
    coef[j] = (float)a;
    coef[cpg + j] = (float)b;
  }
  __syncthreads();

  const int s0 = blockIdx.x * len;
  const int nv = min(len, run - s0) / V;
  const R* xc = reinterpret_cast<const R*>(xr + s0);
  R* yc = reinterpret_cast<R*>(y + (long long)bg * run + s0);
  for (int k = threadIdx.x; k < nv; k += NCHW_UNROLL * THREADS) {
    R raw[NCHW_UNROLL];
#pragma unroll
    for (int u = 0; u < NCHW_UNROLL; ++u)
      if (k + u * THREADS < nv) raw[u] = xc[k + u * THREADS];
#pragma unroll
    for (int u = 0; u < NCHW_UNROLL; ++u) {
      const int kv = k + u * THREADS;
      if (kv >= nv) break;
      // the vector's channel (all V elements: H*W is a multiple of V)
      const int j = (unsigned)(s0 + kv * V) / (unsigned)HW;
      const float a = coef[j], b = coef[cpg + j];
      const T* in = reinterpret_cast<const T*>(&raw[u]);
      R res;
      T* outv = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int e = 0; e < V; ++e)
        outv[e] = from_float<T>(silu(fmaf(to_float(in[e]), a, b)));
      yc[kv] = res;
    }
  }
}

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// channels last: both kernels; scale and shift null for no FiLM
template <typename T, bool VEC>
cudaError_t launch(const void* x, const float* gamma, const float* beta,
                   const void* scale, const void* shift, int film_stride,
                   double* partials, void* y, int B, int HW, int C, int G,
                   int rows, int chunks, float eps, cudaStream_t st) {
  constexpr int V = width<T, VEC>();
  const int P = C / gcd(C, V);
  if (P > THREADS) return cudaErrorInvalidValue;
  const int TP = THREADS / P * P;
  const dim3 grid(chunks, B);
  const size_t smem1 = (size_t)P * V * sizeof(double2) +
                       (size_t)TP * V * sizeof(float2);
  group_norm_partial_stats<T, VEC><<<grid, THREADS, smem1, st>>>(
      static_cast<const T*>(x), partials, HW, C, G, rows, P, TP);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int items = 2 * G;
  const int rp = THREADS / items > 1 ? THREADS / items : 1;
  const size_t smem2 = (size_t)items * rp * sizeof(double) +
                       2 * (size_t)C * sizeof(float);
  auto apply = group_norm_silu_apply<T, VEC>;
  if (smem2 > 48 * 1024) {
    err = cudaFuncSetAttribute(
        apply, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
    if (err != cudaSuccess) return err;
  }
  apply<<<grid, THREADS, smem2, st>>>(
      static_cast<const T*>(x), partials, gamma, beta,
      static_cast<const T*>(scale), static_cast<const T*>(shift), film_stride,
      static_cast<T*>(y), HW, C, G, rows, eps);
  return cudaGetLastError();
}

// NCHW: the statistics kernel where a run has more than one chunk, then
// the apply
template <typename T, bool VEC>
cudaError_t launch_nchw(const void* x, const float* gamma, const float* beta,
                        const void* scale, const void* shift, int film_stride,
                        double* partials, void* y, int B, int HW, int C,
                        int G, int len, int chunks, float eps,
                        cudaStream_t st) {
  const dim3 grid(chunks, B * G);
  const int run = C / G * HW;
  auto* sums = reinterpret_cast<double2*>(partials);
  if (chunks > 1) {
    group_norm_nchw_partial_stats<T, VEC><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(x), sums, run, len);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const size_t smem = 2 * (size_t)(C / G) * sizeof(float);
  group_norm_film_silu_nchw<T, VEC><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(x), sums, gamma, beta,
      static_cast<const T*>(scale), static_cast<const T*>(shift), film_stride,
      static_cast<T*>(y), C, G, HW, len, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool vec, bool channels_last, const void* x,
                     const float* gamma, const float* beta, const void* scale,
                     const void* shift, int film_stride, double* partials,
                     void* y, int B, int HW, int C, int G, int chunk,
                     int chunks, float eps, cudaStream_t st) {
  if (channels_last)
    return (vec ? launch<T, true> : launch<T, false>)(
        x, gamma, beta, scale, shift, film_stride, partials, y, B, HW, C, G,
        chunk, chunks, eps, st);
  return (vec ? launch_nchw<T, true> : launch_nchw<T, false>)(
      x, gamma, beta, scale, shift, film_stride, partials, y, B, HW, C, G,
      chunk, chunks, eps, st);
}

// runs `dispatch` on `device` (switching the calling thread's current
// device for the launches only when it differs); cudaGetLastError() or 0
int on_device(int device, int is_bf16, bool vec, bool channels_last,
              const void* x, const void* gamma, const void* beta,
              const void* scale, const void* shift, int film_stride,
              void* partials, void* y, int B, int HW, int C, int G, int chunk,
              int chunks, float eps, void* stream) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto run = is_bf16 ? dispatch<__nv_bfloat16> : dispatch<float>;
  err = run(vec, channels_last, x, static_cast<const float*>(gamma),
            static_cast<const float*>(beta), scale, shift, film_stride,
            static_cast<double*>(partials), y, B, HW, C, G, chunk, chunks,
            eps, static_cast<cudaStream_t>(stream));
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

}  // namespace

// SiLU(GroupNorm(x) * (1 + scale) + shift), or SiLU(GroupNorm(x)) where
// scale and shift are null; launches on `device` and its `stream` and
// returns cudaGetLastError() (0 on success). scale and shift have x's
// type, element (b, c) at b * film_stride + c. gamma and beta contiguous
// f32 [C], G divides C. channels_last: x and y contiguous [B, HW, C],
// 1 <= B <= 65535, partials f64 [B, chunks, G, 2], `chunk` the rows (a
// multiple of 8), chunks = ceil(HW / rows); `vec` only where x and y start
// 16-byte aligned and HW*C*elem is a multiple of 16, and C / gcd(C, vector
// width) <= 256 (else, and for C > 256 without `vec`,
// cudaErrorInvalidValue); the shared memory of the apply,
// 8*2G*max(1, 256/(2G)) + 8C bytes, at most 227 KB. Otherwise (NCHW) x
// and y contiguous [B, C, HW], 1 <= B * G <= 65535, C / G * HW < 2^31,
// `chunk` the elements of a chunk (a multiple of 8), chunks = ceil(C / G *
// HW / chunk), partials f64 [B * G, chunks, 2] (unused where chunks is 1);
// `vec` only where x and y start 16-byte aligned and HW is a multiple of
// the vector width; 8 * C / G bytes of shared memory, at most 48 KB.
extern "C" int dsdiff_group_norm_film_silu(
    const void* x, const void* gamma, const void* beta, const void* scale,
    const void* shift, int film_stride, void* partials, void* y, int is_bf16,
    int vec, int channels_last, int device, int B, int HW, int C, int G,
    int chunk, int chunks, float eps, void* stream) {
  return on_device(device, is_bf16, vec, channels_last, x, gamma, beta,
                   scale, shift, film_stride, partials, y, B, HW, C, G, chunk,
                   chunks, eps, stream);
}
