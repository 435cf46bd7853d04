// Flash attention forward (ROADMAP B.6), hand-written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_kernel.py : flash_attention (_flash_kernel).
// out[b, i, h, :] = softmax_j(q_i . k_j / sqrt(d)) v_j over the admissible
// keys j < T with i - j >= 0 (causal) and i - j < window (window > 0); the
// float32 online-softmax state (m, l, acc) of each query row never leaves
// the block.  q, k, v, out are [B, S|T, H, d|dv] with free strides on the
// first three dims (the wrapper passes them); out is contiguous.  Under
// training each row's log-sum-exp is written too (float32 [B, H, S], from
// the epilogue's m and l): the residual flash_attention_bwd.cu recomputes
// the probabilities from.  Serving passes no lse and writes none.
//
// What bounds it on this card: operations.  At the serving shape
// (B 4, S 2048, H 16, d 64, causal) the two products are ~34 GFLOP against
// 67 MB of q, k, v, out: 989 TFLOP/s of bf16 tensor cores give a 0.035 ms
// bound, HBM a 0.02 ms one.
//
// Two kernels, chosen by dtype:
//
// bfloat16 (the serving path) — tensor cores with asynchronous staging.
//   * One block per (128-row query tile, b·h): two warpgroups of 64 query
//     rows each; the grid walks the heaviest query tiles (last, under a
//     causal mask) of every b·h first.  At d <= 128 and dv <= 64 a block
//     fits in 128 registers a thread, and two blocks share an SM.
//   * Q, K and V tiles (64 keys) are copied by TMA through 4-D tensor maps
//     over the strided [B, T, H, d] views, in 64-element boxes with the 128B
//     swizzle that wgmma reads; ragged S and T ends are zero-filled by the
//     copy.  K/V tiles go into a 2-stage ring: each stage has an mbarrier
//     that the copy completes, and tile j + 1 is in flight while tile j is
//     computed.
//   * S = Q·Kᵀ: wgmma m64n64k16 with Q and K read from shared memory (both
//     K-major), float32 accumulators in registers; d/16 k-steps (12 at
//     d = 192, where Q takes 48 KB and each K stage 24 KB: 132 KB a block
//     at dv = 128, one block per SM).
//   * Online softmax on the accumulator fragment (exp2 with a log2(e)-scaled
//     score): each thread holds 2 rows x 16 keys; row max by quad shuffles,
//     the row sum kept per thread and summed over the quad once at the end.
//     Masks are applied only on edge tiles (diagonal, window edge, ragged
//     T: a second instantiation of the softmax, so interior tiles carry no
//     mask code), and a masked score is excluded by a flag, never by a
//     sentinel, so a row with no admissible key sums to 0 and gets zeros;
//     the output is acc / max(l, 1e-30).  Tiles wholly above the diagonal or outside the
//     window are skipped per warpgroup.
//   * O += P·V: wgmma m64nDVk16 with P as the A operand from registers (the
//     S fragment of 16 keys is an A fragment) and V as the B operand read
//     MN-major from shared memory, so V is never transposed.  P keeps
//     float32 accuracy: P_hi = bf16(P) and P_lo = bf16(P - P_hi) go through
//     two wgmmas into the same float32 accumulator (ROADMAP C.8); P_hi +
//     P_lo holds about 16 of P's 24 significant bits.
//   * Each warp marks a stage done once its products on it have landed; the
//     last of the block's 8 warps refills it, so neither warpgroup waits for
//     the other.
//   * Epilogue: bf16 rows staged in shared memory, stored as 16-byte
//     vectors, one contiguous row of out per 8 or 16 threads.
//   d: a multiple of 8 up to 192; dv: a multiple of 8 up to 128 (dv != d
//   allowed).  The tensor maps read the columns past d and dv as zeros up
//   to the tile widths (64, 128, 192), which leaves Q·Kᵀ unchanged and
//   zeroes the output columns that are never stored; the wrapper zero-pads
//   other head dims to the next multiple of 8 and passes the unpadded d for
//   the 1/sqrt(d) scale.  Base pointers and the strides of dims of extent
//   > 1 multiples of 16 bytes (the tensor map's rule).  The wrapper raises
//   on anything else.
//
// float32 — plain fp32 FMAs from shared memory:
//   its 1e-5 tolerance rules out bf16 and TF32 tensor cores, and float32
//   never reaches it on the serving path.  One block per (64-row query tile,
//   b·h), 256 threads, each owning a 4 x 4 patch of the 64 x 64 score tile
//   and 4 x (dv/16) outputs; Q and K are staged transposed (d <= 192: 104 KB
//   at d = 192), P is written back transposed; the same skipping, masking
//   and flag rules as above.

#include <cuda.h>
#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;             // query rows per warpgroup
constexpr int kWarpgroups = 2;
constexpr int kTQ = kWgRows * kWarpgroups;  // query rows per block
constexpr int kTK = 64;                 // keys per K/V tile
constexpr int kTcThreads = 128 * kWarpgroups;
constexpr int kStages = 2;  // K/V ring: tile j + 1 is in flight while tile j is computed

struct TcParams {
  CUtensorMap tq, tk, tv;
  __nv_bfloat16* o;
  float* lse;  // [B, H, S] or null
  int H, S, T, dv;
  int causal, window;
  float scale_log2;  // log2(e) / sqrt(d), d unpadded
};

// DP: d rounded up to 64, 128 or 192; DVP: dv rounded up to 64 or 128 (the
// shared-memory tile widths).  With d <= 128 and dv <= 64 the kernel fits
// 128 registers and 80 KB, so two blocks (four warpgroups) share an SM and
// hide each other's softmax latency.
template <int DP, int DVP>
__global__ void __launch_bounds__(kTcThreads, DVP == 64 && DP <= 128 ? 2 : 1)
    flash_tc_kernel(const __grid_constant__ TcParams p) {
  constexpr int kQBytes = kTQ * DP * 2, kKBytes = kTK * DP * 2, kVBytes = kTK * DVP * 2;
  constexpr int kNo = DVP / 2;  // output accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the 128B swizzle pattern repeats every 8 rows
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = smem;                          // [DP/64][kTQ][64] bf16
  uint8_t* sk = sq + kQBytes;                  // [kStages][DP/64][kTK][64]
  uint8_t* sv = sk + kStages * kKBytes;        // [kStages][DVP/64][kTK][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sv + kStages * kVBytes);  // q, full[kStages]
  int* released = reinterpret_cast<int*>(bars + 1 + kStages);  // [kStages]: warps done with the stage

  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTQ;  // heaviest (last) query tiles first
  const int b = blockIdx.x / p.H, h = blockIdx.x - b * p.H;

  int kv_lo = 0, kv_hi = p.T;
  if (p.causal) kv_hi = min(kv_hi, min(q0 + kTQ, p.S));
  if (p.window > 0) kv_lo = max(0, q0 - p.window + 1);
  const int t_lo = kv_lo / kTK;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi + kTK - 1) / kTK - t_lo : 0;

  const uint32_t bar_q = smem_u32(bars);
  auto bar_full = [&](int s) { return smem_u32(bars + 1 + s); };
  auto issue_kv = [&](int j) {  // tile j of this block into stage j % kStages
    const int s = j % kStages, k0 = (t_lo + j) * kTK;
    mbar_expect_tx(bar_full(s), kKBytes + kVBytes);
#pragma unroll
    for (int c = 0; c < DP / kBox; ++c)
      tma_load(smem_u32(sk + s * kKBytes + c * kTK * 128), &p.tk, bar_full(s), c * kBox, h, k0, b);
#pragma unroll
    for (int c = 0; c < DVP / kBox; ++c)
      tma_load(smem_u32(sv + s * kVBytes + c * kTK * 128), &p.tv, bar_full(s), c * kBox, h, k0, b);
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(bar_full(s), 1), released[s] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(bar_q, kQBytes);
#pragma unroll
    for (int c = 0; c < DP / kBox; ++c)
#pragma unroll
      for (int w = 0; w < kWarpgroups; ++w)
        tma_load(smem_u32(sq + c * kTQ * 128 + w * kWgRows * 128), &p.tq, bar_q, c * kBox, h,
                 q0 + w * kWgRows, b);
    for (int j = 0; j < min(n_tiles, kStages); ++j) issue_kv(j);
  }

  // this thread's two rows (g and g + 8 of its warp's 16) in the block
  const int r_lo = q0 + wg * kWgRows + warp * 16 + (lane >> 2), r_hi = r_lo + 8;
  const int wg_r0 = q0 + wg * kWgRows, wg_r1 = wg_r0 + kWgRows - 1;
  const int col = 2 * (lane & 3);  // first of the thread's two columns in each 8-key block
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};  // m: -1e30 while the row has seen no key
  float o[kNo];
#pragma unroll
  for (int i = 0; i < kNo; ++i) o[i] = 0.f;

  if (n_tiles > 0) mbar_wait(bar_q, 0);
  const uint32_t q_base = smem_u32(sq + wg * kWgRows * 128);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages, k0 = (t_lo + j) * kTK;
    mbar_wait(bar_full(s), (j / kStages) & 1);
    const bool skip = wg_r0 >= p.S || (p.causal && k0 > wg_r1) ||
                      (p.window > 0 && wg_r0 - (k0 + kTK - 1) >= p.window);
    if (!skip) {  // warpgroup-uniform
      const uint32_t k_base = smem_u32(sk + s * kKBytes), v_base = smem_u32(sv + s * kVBytes);
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 of the 64 elements of a swizzled row
        wgmma_ss_n64(sc, smem_desc(q_base + (kk / 4) * kTQ * 128 + off, 16, 1024),
                     smem_desc(k_base + (kk / 4) * kTK * 128 + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      const bool edge = k0 + kTK > p.T || (p.causal && k0 + kTK - 1 > wg_r0) ||
                        (p.window > 0 && wg_r1 - k0 >= p.window);
      // sc[4n + e]: row (e < 2 ? r_lo : r_hi), key k0 + 8n + col + (e & 1).
      // Two instantiations, so that only edge tiles carry the mask's code.
      float corr[2];
      auto softmax = [&](auto masked) {
        constexpr bool kMasked = decltype(masked)::value;
        auto admissible = [&](int i) {
          const int r = (i & 2) ? r_hi : r_lo, c = k0 + 8 * (i >> 2) + col + (i & 1);
          const int diff = r - c;
          return c < p.T && (!p.causal || diff >= 0) && (p.window <= 0 || diff < p.window);
        };
        float mt[2] = {-1e30f, -1e30f};  // row max of the raw scores
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (!kMasked || admissible(i)) mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], sc[i]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mt[e] = fmaxf(mt[e], __shfl_xor_sync(0xffffffffu, mt[e], 1));
          mt[e] = fmaxf(mt[e], __shfl_xor_sync(0xffffffffu, mt[e], 2));
          const float m_new = fmaxf(m[e], mt[e]);
          corr[e] = ex2((m[e] - m_new) * p.scale_log2);  // 1 while the row has seen no key
          m[e] = m_new;
          l[e] *= corr[e];
        }
        // p = 2^((s - m) log2(e) / sqrt(d)), the scale folded into one FFMA
        const float ms[2] = {m[0] * p.scale_log2, m[1] * p.scale_log2};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int e = (i >> 1) & 1;
          sc[i] = (!kMasked || admissible(i)) ? ex2(fmaf(sc[i], p.scale_log2, -ms[e])) : 0.f;
          l[e] += sc[i];
        }
      };
      if (edge)
        softmax(std::true_type{});
      else
        softmax(std::false_type{});
#pragma unroll
      for (int i = 0; i < kNo; ++i) o[i] *= corr[(i >> 1) & 1];

      // P as A fragments, 16 keys per k-step: {rows lo, hi} x {keys 0-7, 8-15};
      // P_hi = bf16(P), P_lo = bf16(P - P_hi)
      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
          p_hi[kk][r] = bf16x2(x0, x1);
          const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&p_hi[kk][r]);
          p_lo[kk][r] = bf16x2(x0 - __low2float(h), x1 - __high2float(h));
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // 16 keys = two 8-row swizzle atoms of V; the dv halves are kTK rows apart
        const uint64_t dvd = smem_desc(v_base + kk * 16 * 128, kTK * 128, 1024);
        wgmma_rs<DVP>(o, p_hi[kk], dvd);
        wgmma_rs<DVP>(o, p_lo[kk], dvd);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }
    // this warp is done with tile j (its products waited, or skipped); the
    // last of the block's warps to be done refills the stage, and no
    // warpgroup waits for the other
    __syncwarp();
    if (lane == 0 &&
        atomicAdd(released + s, 1) == 4 * kWarpgroups * (j / kStages + 1) - 1 &&
        j + kStages < n_tiles)
      issue_kv(j + kStages);
  }

  // epilogue: out = o / max(l, 1e-30) in bf16, staged through shared memory
  float den[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float t = l[e];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    den[e] = fmaxf(t, 1e-30f);
    // the row's log-sum-exp of the scaled scores, natural log (the
    // backward's residual): m is a raw score, l sums 2^((s - m) scale_log2)
    const int i = e ? r_hi : r_lo;
    if (p.lse != nullptr && (lane & 3) == 0 && i < p.S)
      p.lse[((long long)b * p.H + h) * p.S + i] =
          t > 0.f ? m[e] * (p.scale_log2 / kLog2e) + logf(t) : -INFINITY;
  }
  constexpr int kLdo = DVP + 8;  // staged row, elements: 16-byte aligned, skewed banks
  __nv_bfloat16* so = reinterpret_cast<__nv_bfloat16*>(smem);
  __syncthreads();  // no warpgroup reads the tiles any more
#pragma unroll
  for (int i = 0; i < kNo; i += 2) {
    const int e = (i >> 1) & 1;
    const int row = wg * kWgRows + warp * 16 + (lane >> 2) + 8 * e;
    const int c = 8 * (i >> 2) + col;
    *reinterpret_cast<uint32_t*>(so + row * kLdo + c) = bf16x2(o[i] / den[e], o[i + 1] / den[e]);
  }
  __syncthreads();
  const int chunks = p.dv / 8;  // 16-byte chunks per output row
  for (int idx = tid; idx < kTQ * chunks; idx += kTcThreads) {
    const int row = idx / chunks, ch = idx - row * chunks, i = q0 + row;
    if (i >= p.S) continue;
    *reinterpret_cast<uint4*>(p.o + (((long long)b * p.S + i) * p.H + h) * p.dv + ch * 8) =
        *reinterpret_cast<const uint4*>(so + row * kLdo + ch * 8);
  }
}

template <int DP, int DVP>
cudaError_t launch_tc(const TcParams& p, int B, cudaStream_t s) {
  auto kernel = flash_tc_kernel<DP, DVP>;
  const size_t smem = 1024 + (size_t)kTQ * DP * 2 + (size_t)kStages * kTK * (DP + DVP) * 2 +
                      (1 + kStages) * sizeof(uint64_t) + kStages * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * p.H, (p.S + kTQ - 1) / kTQ);
  kernel<<<grid, kTcThreads, smem, s>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: plain FMAs
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per KV tile
constexpr int kThreads = 256;
constexpr int kLd = kBQ + 4;  // row of a transposed tile: float4-aligned, skewed banks
constexpr float kNegInf = -1e30f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;  // [B, H, S] or null
  int B, H, S, T, d, dv;
  long long sqb, sqs, sqh, skb, sks, skh, svb, svs, svh;
  int causal, window;
  float scale;
};

template <int DVT>  // DVT: dv rounded up to 64 or 128
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
  const float* qg = p.q + b * p.sqb + h * p.sqh;
  const float* kg = p.k + b * p.skb + h * p.skh;
  const float* vg = p.v + b * p.svb + h * p.svh;

  for (int e = tid; e < kBQ * d; e += kThreads) {
    const int r = e / d, c = e - r * d, i = q0 + r;
    Qt[c * kLd + r] = i < p.S ? qg[(long long)i * p.sqs + c] : 0.f;
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
      Kt[c * kLd + r] = j < p.T ? kg[(long long)j * p.sks + c] : 0.f;
    }
    for (int e = tid; e < kBK * DVT; e += kThreads) {
      const int r = e / DVT, c = e - r * DVT, j = k0 + r;
      Vs[e] = (j < p.T && c < dv) ? vg[(long long)j * p.svs + c] : 0.f;
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if (p.lse != nullptr && tx == 0)  // m is in scaled units here
      p.lse[((long long)b * p.H + h) * p.S + row] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
    float* orow = p.o + (((long long)b * p.S + row) * p.H + h) * dv;
#pragma unroll
    for (int g = 0; g < DVT / 64; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = g * 64 + tx * 4 + j;
        if (c < dv) orow[c] = acc[i][g * 4 + j] / den;
      }
  }
}

template <int DVT>
cudaError_t launch(const Params& p, cudaStream_t s) {
  auto kernel = flash_kernel<DVT>;
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
// lse: null, or float32 [B, H, S] that receives each row's log-sum-exp of the
// scaled scores (natural log; -inf for a row with no admissible key), the
// residual the backward recomputes the probabilities from.  Scores are scaled by 1/sqrt(scale_d): scale_d is d before the wrapper's
// zero padding (padding leaves q·k unchanged).  is_bf16 selects the
// tensor-core kernel (__nv_bfloat16) over the float32 one.
REPRO_API int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                     void* lse, int B, int H, int S, int T, int d, int dv, int scale_d,
                                     long long sqb, long long sqs, long long sqh,
                                     long long skb, long long sks, long long skh,
                                     long long svb, long long svs, long long svh,
                                     int causal, int window, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || T <= 0) return 0;
  if (d < 1 || d > 192 || dv < 1 || dv > 128 || scale_d < 1 || scale_d > d || window < 0 ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    // the tensor maps read past d (dv) as zeros up to the tile widths; the
    // epilogue stores 16-byte chunks of dv
    if (d % 8 || dv % 8) return (int)cudaErrorInvalidValue;
    TcParams p;
    if (!make_map(&p.tq, q, d, H, S, B, sqb, sqs, sqh) ||
        !make_map(&p.tk, k, d, H, T, B, skb, sks, skh) ||
        !make_map(&p.tv, v, dv, H, T, B, svb, svs, svh))
      return (int)cudaErrorInvalidValue;
    p.o = static_cast<__nv_bfloat16*>(out);
    p.lse = static_cast<float*>(lse);
    p.H = H, p.S = S, p.T = T, p.dv = dv, p.causal = causal, p.window = window;
    p.scale_log2 = kLog2e / sqrtf((float)scale_d);
    if (d <= 64) return (int)(dv <= 64 ? launch_tc<64, 64>(p, B, s) : launch_tc<64, 128>(p, B, s));
    if (d <= 128) return (int)(dv <= 64 ? launch_tc<128, 64>(p, B, s) : launch_tc<128, 128>(p, B, s));
    return (int)(dv <= 64 ? launch_tc<192, 64>(p, B, s) : launch_tc<192, 128>(p, B, s));
  }
  Params p{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
           static_cast<float*>(out), static_cast<float*>(lse), B, H, S, T, d, dv, sqb, sqs, sqh,
           skb, sks, skh, svb, svs, svh, causal, window, 1.0f / sqrtf((float)scale_d)};
  return (int)(dv <= 64 ? launch<64>(p, s) : launch<128>(p, s));
}
