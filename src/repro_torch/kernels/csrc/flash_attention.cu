// Flash attention forward (ROADMAP B.6), hand-written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_kernel.py : flash_attention (_flash_kernel).
// out[b, i, h, :] = softmax_j(q_i . k_j / sqrt(d)) v_j over the admissible
// keys j < T with i - j >= 0 (causal) and i - j < window (window > 0); the
// float32 online-softmax state (m, l, acc) of each query row never leaves
// the block.  q, k, v, out are [B, S|T, H, d|dv] with free strides on the
// first three dims (the wrapper passes them), float32 or bfloat16, d and dv
// up to 128, dv != d allowed.
//
// What bounds it on this card: operations.  At the serving shape
// (B 4, S 2048, H 16, d 64, causal) the two products are ~34 GFLOP against
// 67 MB of q, k, v, out: 989 TFLOP/s of bf16 tensor cores give a 0.035 ms
// bound, HBM a 0.02 ms one.  This first kernel is the simple one: plain fp32
// FMAs from shared memory (67 TFLOP/s peak), no tensor cores, no TMA.
// What the design does about it: one block per (64-row query tile, b·h),
// 256 threads, each owning a 4 x 4 patch of the 64 x 64 score tile and
// 4 x (dv/16) outputs, so every step of the inner products is two float4
// shared-memory loads for 16 FMAs (Q and K are staged transposed and
// padded; P is written back transposed for the same reason).  KV tiles
// wholly above the diagonal or wholly outside the window are never visited
// (the Pallas kernel visits and masks them); the ragged edges (S, T not
// multiples of 64) are masked in the kernel, with zero-filled tiles.
// Masked scores are excluded by a flag, never by a sentinel value, so a row
// whose tile is wholly masked adds 0 to l (exp(sentinel - sentinel) = 1
// would otherwise poison it), and the output is acc / max(l, 1e-30).
// Heaviest query tiles (last, under a causal mask) are scheduled first.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per KV tile
constexpr int kThreads = 256;
constexpr int kLd = kBQ + 4;  // row of a transposed tile: float4-aligned, skewed banks
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, S, T, d, dv;
  long long sqb, sqs, sqh, skb, sks, skh, svb, svs, svh;
  int causal, window;
  float scale;
};

template <typename T, int DVT>  // DVT: dv rounded up to 64 or 128
__global__ void __launch_bounds__(kThreads) flash_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int d = p.d, dv = p.dv;
  float* Qt = smem;              // [d][kLd]    Q tile, transposed
  float* Kt = Qt + d * kLd;      // [d][kLd]    K tile, transposed
  float* Vs = Kt + d * kLd;      // [kBK][DVT]  V tile, zero past dv
  float* Pt = Vs + kBK * DVT;    // [kBK][kLd]  probabilities, transposed

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int b = blockIdx.y / p.H, h = blockIdx.y - b * p.H;
  const T* qg = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* kg = static_cast<const T*>(p.k) + b * p.skb + h * p.skh;
  const T* vg = static_cast<const T*>(p.v) + b * p.svb + h * p.svh;

  for (int e = tid; e < kBQ * d; e += kThreads) {
    const int r = e / d, c = e - r * d, i = q0 + r;
    Qt[c * kLd + r] = i < p.S ? to_f(qg[(long long)i * p.sqs + c]) : 0.f;
  }

  // admissible keys of this tile's rows: [kv_lo, kv_hi)
  int kv_lo = 0, kv_hi = p.T;
  if (p.causal) kv_hi = min(kv_hi, min(q0 + kBQ, p.S));
  if (p.window > 0) kv_lo = max(0, q0 - p.window + 1);

  constexpr int NO = DVT / 16;  // outputs per row per thread
  float m[4], l[4], acc[4][NO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int o = 0; o < NO; ++o) acc[i][o] = 0.f;
  }

  for (int k0 = (kv_lo / kBK) * kBK; k0 < kv_hi; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed; Qt is visible
    for (int e = tid; e < kBK * d; e += kThreads) {
      const int r = e / d, c = e - r * d, j = k0 + r;
      Kt[c * kLd + r] = j < p.T ? to_f(kg[(long long)j * p.sks + c]) : 0.f;
    }
    for (int e = tid; e < kBK * DVT; e += kThreads) {
      const int r = e / DVT, c = e - r * DVT, j = k0 + r;
      Vs[e] = (j < p.T && c < dv) ? to_f(vg[(long long)j * p.svs + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + c * kLd + ty * 4);
      const float4 k4 = *reinterpret_cast<const float4*>(Kt + c * kLd + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, kv[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      bool ok[4];
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j, diff = row - col;
        ok[j] = col < p.T && (!p.causal || diff >= 0) && (p.window <= 0 || diff < p.window);
        s[i][j] *= p.scale;
        if (ok[j]) mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);  // 1 while the row has seen no key
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pij = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += pij;
        Pt[(tx * 4 + j) * kLd + ty * 4 + i] = pij;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int o = 0; o < NO; ++o) acc[i][o] *= corr;
    }
    __syncthreads();

    for (int t = 0; t < kBK; ++t) {
      const float4 pp = *reinterpret_cast<const float4*>(Pt + t * kLd + ty * 4);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int g = 0; g < DVT / 64; ++g) {
        const float4 v4 = *reinterpret_cast<const float4*>(Vs + t * DVT + g * 64 + tx * 4);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][g * 4 + j] = fmaf(pv[i], vv[j], acc[i][g * 4 + j]);
      }
    }
  }

  T* og = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = og + (((long long)b * p.S + row) * p.H + h) * dv;
#pragma unroll
    for (int g = 0; g < DVT / 64; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = g * 64 + tx * 4 + j;
        if (c < dv) orow[c] = from_f<T>(acc[i][g * 4 + j] / den);
      }
  }
}

template <typename T, int DVT>
cudaError_t launch(const Params& p, cudaStream_t s) {
  auto kernel = flash_kernel<T, DVT>;
  const size_t smem = ((size_t)2 * p.d * kLd + (size_t)kBK * DVT + (size_t)kBK * kLd) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + kBQ - 1) / kBQ, p.B * p.H);
  kernel<<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q: [B, S, H, d], k: [B, T, H, d], v: [B, T, H, dv] with the given strides
// (in elements; the last dim contiguous); out: contiguous [B, S, H, dv].
// is_bf16 selects __nv_bfloat16 over float for all four.
REPRO_API int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                     int B, int H, int S, int T, int d, int dv,
                                     long long sqb, long long sqs, long long sqh,
                                     long long skb, long long sks, long long skh,
                                     long long svb, long long svs, long long svh,
                                     int causal, int window, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || T <= 0) return 0;
  if (d < 1 || d > 128 || dv < 1 || dv > 128 || window < 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, out, B, H, S, T, d, dv, sqb, sqs, sqh, skb, sks, skh, svb, svs, svh,
           causal, window, 1.0f / sqrtf((float)d)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)(dv <= 64 ? launch<__nv_bfloat16, 64>(p, s) : launch<__nv_bfloat16, 128>(p, s));
  return (int)(dv <= 64 ? launch<float, 64>(p, s) : launch<float, 128>(p, s));
}
