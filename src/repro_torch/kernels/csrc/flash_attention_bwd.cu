// Flash attention backward (ROADMAP B.6, backward), hand-written for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/flash_kernel.py : flash_attention's backward,
// which the Pallas kernel does not have: the reference trains through XLA
// attention (src/repro/models/layers.py : _sdpa_flash, differentiated by
// jax.grad with the block scores recomputed under jax.checkpoint).  This is
// that autodiff written as kernels, after FA2's split: given the
// forward's output O and each row's log-sum-exp L (flash_attention.cu writes
// it under training), and dO,
//   P = exp(q·kᵀ/sqrt(d) - L)        (recomputed, never stored)
//   dV = Pᵀ·dO,   dP = dO·Vᵀ,   dS = P ∘ (dP - Δ),   Δ = rowsum(dO ∘ O)
//   dQ = dS·K/sqrt(d),   dK = dSᵀ·Q/sqrt(d)
// over the admissible pairs (j < T, i - j >= 0 when causal, i - j < window
// when window > 0), the forward's mask.  Three passes:
//   * prep: Δ per query row in float32, and L·log2(e) (+inf past S and on a
//     row with no admissible key, so that its P is exp2(-inf) = 0); both
//     into [B·H, S rounded up to 64] scratch;
//   * dK/dV: one block per (b·h, 64-key tile) walks the query tiles its keys
//     admit (from the diagonal down when causal, within the window) and
//     writes its rows of dK and dV once;
//   * dQ: one block per (b·h, 64-query tile) walks the admitted key tiles
//     and writes its rows of dQ once.
// Every gradient element is summed by one thread in a fixed order: no
// atomics, so two calls on the same inputs give the same bits.
//
// What bounds it on this card: operations.  At the training shape (B 8,
// S 2048, H 16, d 64, causal) the five products are ~172 GFLOP against
// ~235 MB of q, k, v, dO in and dq, dk, dv out: 0.174 ms at 989 TFLOP/s of
// bf16 tensor cores, 0.070 ms of HBM.  The split recomputes the scores and
// dP in the dQ pass (7 products, not 5) to keep the sums free of atomics.
//
// bfloat16 — wgmma with tiles copied by TMA (hopper.cuh, the forward's
// helpers).  One warpgroup (128 threads) a block, 64 rows of its own:
//   * Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (dK/dV pass) or S = Q·Kᵀ and dP = dO·Vᵀ
//     (dQ pass): m64n64k16, A and B K-major from shared memory;
//   * P and dS rounded to bf16 once (as FA2 does) and fed from registers as
//     the A operand of dV += Pᵀ·dO, dK += dSᵀ·Q, dQ += dS·K, with the B
//     tile read MN-major (never transposed), one m64n64 product per 64
//     columns;
//   * the walked tiles (Q, dO, and their L, Δ by bulk copy; or K, V) come
//     through a 2-stage ring of mbarrier-completed copies: tile j + 1 is in
//     flight while tile j is computed;
//   * masks only on edge tiles (diagonal, window edge, keys past T), by a
//     flag: a key past T — zero-filled by the copy — gets P = 0, adds
//     nothing to dQ, and its dK/dV rows are not stored;
//   * registers: at d = 64, dv = 64 one block keeps dK and dV (2 x 32
//     accumulators a thread) beside Sᵀ, dPᵀ and the fragments.  Wider head
//     dims (up to MLA's d 192 / dv 128: 96 + 64 accumulators) split the
//     pass in two launches, one for dK and one for dV, each recomputing Sᵀ;
//   * epilogue: rows staged in shared memory as bf16, stored as 16-byte
//     vectors.
//   d, dv: multiples of 8 up to 192 / 128 (the wrapper pads others, and
//   passes the unpadded d for the scale); q, k, v strided views whose base
//   and strides are multiples of 16 bytes; out and dout contiguous.
//
// float32 — plain FMAs from shared memory (its 1e-5 tolerance rules out bf16
// and TF32 tensor cores), in the manner of the forward's float32 kernel:
// 256 threads a block, 64 x 64 score tiles of which each thread owns a 4 x 4
// patch; tiles staged transposed with an odd row length, so that both the
// row and the column walks of the products are conflict-light.

#include <cuda.h>
#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;

constexpr int kRows = 64;  // rows of every tile (= kTile, the tensor maps' box)
constexpr int kWg = 128;   // one warpgroup
constexpr int kStages = 2;
constexpr int kBoth = 0, kOnlyDK = 1, kOnlyDV = 2;  // what a dK/dV block accumulates

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// prep: Δ and L·log2(e), padded to s_pad rows
// ---------------------------------------------------------------------------

// One warp per (b·h, row < s_pad).  o and dout: contiguous [B, S, H, dv].
template <typename T>
__global__ void __launch_bounds__(256) bwd_prep_kernel(const T* o, const T* dout, const float* lse,
                                                       float* lse2, float* delta, int H, int S,
                                                       int s_pad, int dv) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long bh = w / s_pad;
  const int i = (int)(w - bh * s_pad);
  float acc = 0.f, l2 = INFINITY;
  if (i < S) {
    const long long b = bh / H, h = bh - b * H;
    const long long r = ((b * S + i) * H + h) * dv;
    for (int c = lane; c < dv; c += 32) acc = fmaf(to_f(o[r + c]), to_f(dout[r + c]), acc);
    const float x = lse[bh * S + i];
    l2 = x == -INFINITY ? INFINITY : x * kLog2e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    delta[w] = acc;
    lse2[w] = l2;
  }
}

template <typename T>
cudaError_t launch_prep(const T* o, const T* dout, const float* lse, float* lse2, float* delta, int B,
                        int H, int S, int s_pad, int dv, cudaStream_t s) {
  const long long warps = (long long)B * H * s_pad;  // a multiple of 64: whole blocks of 8 warps
  bwd_prep_kernel<T><<<(unsigned)(warps / 8), 256, 0, s>>>(o, dout, lse, lse2, delta, H, S, s_pad, dv);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA
// ---------------------------------------------------------------------------

struct TcParams {
  CUtensorMap tq, tk, tv, tdo;
  const float* lse2;   // [B·H, s_pad]
  const float* delta;  // [B·H, s_pad]
  __nv_bfloat16 *dq, *dk, *dv;  // contiguous [B, S|T, H, dw|dvw]
  int H, S, T, s_pad, dw, dvw;
  int causal, window;
  float scale_log2;  // log2(e) / sqrt(d), d unpadded
  float scale;       // 1 / sqrt(d)
};

// Stage a warpgroup's [64 x N] float accumulators (chunks of 64 columns, the
// m64n64 fragment layout) in shared memory as bf16 scaled by `mul`, then
// store rows r0 + row < n_rows of the [.., width] output at `dst` (row
// stride ld elements) as 16-byte vectors.
template <int NC>
__device__ __forceinline__ void store_rows(float (&acc)[NC][32], float mul, __nv_bfloat16* stage,
                                           __nv_bfloat16* dst, long long ld, int r0, int n_rows,
                                           int width) {
  constexpr int kLd = NC * 64 + 8;  // staged row, elements: 16-byte aligned, skewed banks
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, col = 2 * (lane & 3);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = warp * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
      *reinterpret_cast<uint32_t*>(stage + row * kLd + c * 64 + 8 * (i >> 2) + col) =
          bf16x2(acc[c][i] * mul, acc[c][i + 1] * mul);
    }
  __syncthreads();
  const int chunks = width / 8;
  for (int idx = tid; idx < kRows * chunks; idx += kWg) {
    const int row = idx / chunks, ch = idx - row * chunks;
    if (r0 + row < n_rows)
      *reinterpret_cast<uint4*>(dst + (r0 + row) * ld + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + row * kLd + ch * 8);
  }
}

template <int NC>
__device__ __forceinline__ void zero(float (&acc)[NC][32]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
}

template <int NC>
__device__ __forceinline__ void fence_all(float (&acc)[NC][32]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
}

// dK/dV pass.  DP, DVP: d, dv rounded up to the tile widths (64, 128, 192 /
// 64, 128).  MODE: kBoth, or one of the two halves of a split pass.
template <int DP, int DVP, int MODE>
__global__ void __launch_bounds__(kWg, 1) dkdv_tc_kernel(const __grid_constant__ TcParams p) {
  constexpr bool kDK = MODE != kOnlyDV, kDV = MODE != kOnlyDK;
  constexpr int kKB = kRows * DP * 2, kVB = kRows * DVP * 2;  // a 64-row tile of width DP / DVP
  constexpr int kLB = kRows * 4;                              // a tile of L or Δ
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the 128B swizzle pattern repeats every 8 rows
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sk = smem;                        // [DP/64][64][64] bf16: this block's keys
  uint8_t* sv = sk + kKB;                    // [DVP/64][64][64]: their values (dK's dPᵀ only)
  uint8_t* sq = sv + (kDK ? kVB : 0);        // [kStages][DP/64][64][64]: the walked query tiles
  uint8_t* sdo = sq + kStages * kKB;         // [kStages][DVP/64][64][64]: their dO
  float* sl = reinterpret_cast<float*>(sdo + kStages * kVB);  // [kStages][64]: their L·log2(e)
  float* sd = sl + kStages * kRows;                           // [kStages][64]: their Δ
  uint64_t* bars = reinterpret_cast<uint64_t*>(sd + kStages * kRows);  // kv, full[kStages]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int k0 = blockIdx.y * kRows;  // the first key tiles walk the most query tiles, and run first
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi = p.window > 0 ? min(p.S, k0 + kRows - 1 + p.window) : p.S;
  const int t_lo = q_lo / kRows;
  const int n_tiles = q_hi > q_lo ? (q_hi + kRows - 1) / kRows - t_lo : 0;

  const uint32_t bar_kv = smem_u32(bars);
  auto bar_full = [&](int s) { return smem_u32(bars + 1 + s); };
  auto issue = [&](int j) {  // query tile j of this block into stage j % kStages
    const int s = j % kStages, q0 = (t_lo + j) * kRows;
    mbar_expect_tx(bar_full(s), kKB + kVB + (kDK ? 2 : 1) * kLB);
#pragma unroll
    for (int c = 0; c < DP / kBox; ++c)
      tma_load(smem_u32(sq + s * kKB + c * kRows * 128), &p.tq, bar_full(s), c * kBox, h, q0, b);
#pragma unroll
    for (int c = 0; c < DVP / kBox; ++c)
      tma_load(smem_u32(sdo + s * kVB + c * kRows * 128), &p.tdo, bar_full(s), c * kBox, h, q0, b);
    const long long off = (long long)bh * p.s_pad + q0;
    bulk_load(smem_u32(sl + s * kRows), p.lse2 + off, kLB, bar_full(s));
    if (kDK) bulk_load(smem_u32(sd + s * kRows), p.delta + off, kLB, bar_full(s));
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(bar_full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(bar_kv, kKB + (kDK ? kVB : 0));
#pragma unroll
    for (int c = 0; c < DP / kBox; ++c)
      tma_load(smem_u32(sk + c * kRows * 128), &p.tk, bar_kv, c * kBox, h, k0, b);
    if (kDK) {
#pragma unroll
      for (int c = 0; c < DVP / kBox; ++c)
        tma_load(smem_u32(sv + c * kRows * 128), &p.tv, bar_kv, c * kBox, h, k0, b);
    }
    for (int j = 0; j < min(n_tiles, kStages); ++j) issue(j);
  }

  // this thread's two key rows of the tile: r and r + 8
  const int r = warp * 16 + (lane >> 2);
  const int col = 2 * (lane & 3);  // first of the thread's two columns in each 8-query block
  float dk[kDK ? DP / 64 : 1][32], dv[kDV ? DVP / 64 : 1][32];
  zero(dk);
  zero(dv);
  if (n_tiles > 0) mbar_wait(bar_kv, 0);
  const uint32_t k_base = smem_u32(sk), v_base = smem_u32(sv);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages, q0 = (t_lo + j) * kRows;
    mbar_wait(bar_full(s), (j / kStages) & 1);
    const uint32_t q_base = smem_u32(sq + s * kKB), do_base = smem_u32(sdo + s * kVB);
    const float* ls = sl + s * kRows;
    const float* dl = sd + s * kRows;
    float st[32], dpt[32];  // Sᵀ and dPᵀ: rows keys, columns queries
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk / 4) * kRows * 128 + (kk % 4) * 32;  // 16 of a swizzled row's 64
      wgmma_ss_n64(st, smem_desc(k_base + off, 16, 1024), smem_desc(q_base + off, 16, 1024), kk > 0);
    }
    if constexpr (kDK) {
#pragma unroll
      for (int kk = 0; kk < DVP / 16; ++kk) {
        const uint32_t off = (kk / 4) * kRows * 128 + (kk % 4) * 32;
        wgmma_ss_n64(dpt, smem_desc(v_base + off, 16, 1024), smem_desc(do_base + off, 16, 1024), kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    if constexpr (kDK) fence_regs(dpt);

    // st[4n + e]: key k0 + r + 8 (e >> 1), query q0 + 8n + col + (e & 1).
    // P = 2^(s·scale·log2(e) - L·log2(e)); dS = P (dP - Δ), into dpt.  Two
    // instantiations, so that only edge tiles carry the mask's code.
    const bool edge = k0 + kRows > p.T || (p.causal && q0 < k0 + kRows - 1) ||
                      (p.window > 0 && q0 + kRows - 1 - k0 >= p.window);
    auto probs = [&](auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qc = 8 * (i >> 2) + col + (i & 1);
        bool ok = true;
        if (kMasked) {
          const int key = k0 + r + 8 * ((i >> 1) & 1), diff = q0 + qc - key;
          ok = key < p.T && (!p.causal || diff >= 0) && (p.window <= 0 || diff < p.window);
        }
        const float pr = ok ? ex2(fmaf(st[i], p.scale_log2, -ls[qc])) : 0.f;
        if constexpr (kDK) dpt[i] = pr * (dpt[i] - dl[qc]);
        st[i] = pr;
      }
    };
    if (edge)
      probs(std::true_type{});
    else
      probs(std::false_type{});

    // A fragments, 16 queries per k-step: {keys r, r + 8} x {queries 0-7, 8-15}
    uint32_t pf[4][4], sf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        if constexpr (kDV) pf[kk][x] = bf16x2(st[8 * kk + 2 * x], st[8 * kk + 2 * x + 1]);
        if constexpr (kDK) sf[kk][x] = bf16x2(dpt[8 * kk + 2 * x], dpt[8 * kk + 2 * x + 1]);
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // 16 queries = two 8-row swizzle atoms of the dO / Q tile
      if constexpr (kDV) {
#pragma unroll
        for (int c = 0; c < DVP / 64; ++c)
          wgmma_rs_n64(dv[c], pf[kk], smem_desc(do_base + c * kRows * 128 + kk * 16 * 128, kRows * 128, 1024));
      }
      if constexpr (kDK) {
#pragma unroll
        for (int c = 0; c < DP / 64; ++c)
          wgmma_rs_n64(dk[c], sf[kk], smem_desc(q_base + c * kRows * 128 + kk * 16 * 128, kRows * 128, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(dk);
    fence_all(dv);
    __syncthreads();  // every warp is done with stage s: refill it
    if (tid == 0 && j + kStages < n_tiles) issue(j + kStages);
  }

  // epilogue: dK (scaled) and dV rows of this key tile, keys < T
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem);
  const long long row0 = ((long long)b * p.T) * p.H + h;  // (b, key 0, h)
  if constexpr (kDK) {
    store_rows(dk, p.scale, stage, p.dk + row0 * p.dw, (long long)p.H * p.dw, k0, p.T, p.dw);
    __syncthreads();
  }
  if constexpr (kDV) store_rows(dv, 1.f, stage, p.dv + row0 * p.dvw, (long long)p.H * p.dvw, k0, p.T, p.dvw);
}

// dQ pass: one block per (b·h, 64-query tile), heaviest (last, under a
// causal mask) first.
template <int DP, int DVP>
__global__ void __launch_bounds__(kWg, 1) dq_tc_kernel(const __grid_constant__ TcParams p) {
  constexpr int kKB = kRows * DP * 2, kVB = kRows * DVP * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = smem;                // [DP/64][64][64]: this block's queries
  uint8_t* sdo = sq + kKB;           // [DVP/64][64][64]: their dO
  uint8_t* sk = sdo + kVB;           // [kStages][DP/64][64][64]: the walked key tiles
  uint8_t* sv = sk + kStages * kKB;  // [kStages][DVP/64][64][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sv + kStages * kVB);  // q, full[kStages]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  int kv_lo = 0, kv_hi = p.T;
  if (p.causal) kv_hi = min(kv_hi, min(q0 + kRows, p.S));
  if (p.window > 0) kv_lo = max(0, q0 - p.window + 1);
  const int t_lo = kv_lo / kRows;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi + kRows - 1) / kRows - t_lo : 0;

  const uint32_t bar_q = smem_u32(bars);
  auto bar_full = [&](int s) { return smem_u32(bars + 1 + s); };
  auto issue = [&](int j) {
    const int s = j % kStages, k0 = (t_lo + j) * kRows;
    mbar_expect_tx(bar_full(s), kKB + kVB);
#pragma unroll
    for (int c = 0; c < DP / kBox; ++c)
      tma_load(smem_u32(sk + s * kKB + c * kRows * 128), &p.tk, bar_full(s), c * kBox, h, k0, b);
#pragma unroll
    for (int c = 0; c < DVP / kBox; ++c)
      tma_load(smem_u32(sv + s * kVB + c * kRows * 128), &p.tv, bar_full(s), c * kBox, h, k0, b);
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(bar_full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(bar_q, kKB + kVB);
#pragma unroll
    for (int c = 0; c < DP / kBox; ++c)
      tma_load(smem_u32(sq + c * kRows * 128), &p.tq, bar_q, c * kBox, h, q0, b);
#pragma unroll
    for (int c = 0; c < DVP / kBox; ++c)
      tma_load(smem_u32(sdo + c * kRows * 128), &p.tdo, bar_q, c * kBox, h, q0, b);
    for (int j = 0; j < min(n_tiles, kStages); ++j) issue(j);
  }

  // this thread's two query rows: q0 + r and q0 + r + 8
  const int r = warp * 16 + (lane >> 2);
  const int col = 2 * (lane & 3);
  const long long off = (long long)bh * p.s_pad + q0 + r;
  const float ls[2] = {p.lse2[off], p.lse2[off + 8]}, dl[2] = {p.delta[off], p.delta[off + 8]};
  float dq[DP / 64][32];
  zero(dq);
  if (n_tiles > 0) mbar_wait(bar_q, 0);
  const uint32_t q_base = smem_u32(sq), do_base = smem_u32(sdo);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages, k0 = (t_lo + j) * kRows;
    mbar_wait(bar_full(s), (j / kStages) & 1);
    const uint32_t k_base = smem_u32(sk + s * kKB), v_base = smem_u32(sv + s * kVB);
    float sc[32], dp[32];  // S and dP: rows queries, columns keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t o = (kk / 4) * kRows * 128 + (kk % 4) * 32;
      wgmma_ss_n64(sc, smem_desc(q_base + o, 16, 1024), smem_desc(k_base + o, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DVP / 16; ++kk) {
      const uint32_t o = (kk / 4) * kRows * 128 + (kk % 4) * 32;
      wgmma_ss_n64(dp, smem_desc(do_base + o, 16, 1024), smem_desc(v_base + o, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // sc[4n + e]: query q0 + r + 8 (e >> 1), key k0 + 8n + col + (e & 1)
    const bool edge = k0 + kRows > p.T || (p.causal && k0 + kRows - 1 > q0) ||
                      (p.window > 0 && q0 + kRows - 1 - k0 >= p.window);
    auto grads = [&](auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int e = (i >> 1) & 1;
        bool ok = true;
        if (kMasked) {
          const int key = k0 + 8 * (i >> 2) + col + (i & 1), diff = q0 + r + 8 * e - key;
          ok = key < p.T && (!p.causal || diff >= 0) && (p.window <= 0 || diff < p.window);
        }
        const float pr = ok ? ex2(fmaf(sc[i], p.scale_log2, -ls[e])) : 0.f;
        dp[i] = pr * (dp[i] - dl[e]);
      }
    };
    if (edge)
      grads(std::true_type{});
    else
      grads(std::false_type{});

    uint32_t sf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) sf[kk][x] = bf16x2(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < DP / 64; ++c)
        wgmma_rs_n64(dq[c], sf[kk], smem_desc(k_base + c * kRows * 128 + kk * 16 * 128, kRows * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(dq);
    __syncthreads();
    if (tid == 0 && j + kStages < n_tiles) issue(j + kStages);
  }

  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem);
  store_rows(dq, p.scale, stage, p.dq + (((long long)b * p.S) * p.H + h) * p.dw, (long long)p.H * p.dw,
             q0, p.S, p.dw);
}

size_t dkdv_smem(int dp, int dvp, int mode) {
  const bool dk_ = mode != kOnlyDV;
  return 1024 + (size_t)kRows * 2 * (dp + (dk_ ? dvp : 0) + kStages * (dp + dvp)) +
         (size_t)kStages * 2 * kRows * 4 + (1 + kStages) * sizeof(uint64_t);
}

size_t dq_smem(int dp, int dvp) {
  return 1024 + (size_t)kRows * 2 * (1 + kStages) * (dp + dvp) + (1 + kStages) * sizeof(uint64_t);
}

template <int DP, int DVP, int MODE>
cudaError_t launch_dkdv(const TcParams& p, int B, cudaStream_t s) {
  auto kernel = dkdv_tc_kernel<DP, DVP, MODE>;
  const size_t smem = dkdv_smem(DP, DVP, MODE);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * p.H, (p.T + kRows - 1) / kRows), kWg, smem, s>>>(p);
  return cudaGetLastError();
}

template <int DP, int DVP>
cudaError_t launch_tc(const TcParams& p, int B, cudaStream_t s) {
  cudaError_t err;
  if constexpr (DP == 64 && DVP == 64) {
    err = launch_dkdv<DP, DVP, kBoth>(p, B, s);
  } else {  // dK and dV accumulators together would not fit the registers
    err = launch_dkdv<DP, DVP, kOnlyDK>(p, B, s);
    if (err == cudaSuccess) err = launch_dkdv<DP, DVP, kOnlyDV>(p, B, s);
  }
  if (err != cudaSuccess) return err;
  auto kernel = dq_tc_kernel<DP, DVP>;
  const size_t smem = dq_smem(DP, DVP);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * p.H, (p.S + kRows - 1) / kRows), kWg, smem, s>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: plain FMAs
// ---------------------------------------------------------------------------

constexpr int kF = 64;         // rows of a tile
constexpr int kFThreads = 256;
constexpr int kLdT = kF + 1;   // row of a transposed tile: odd length

struct F32Params {
  const float *q, *k, *v, *dout, *lse2, *delta;
  float *gq, *gk, *gv;  // dq, dk, dv: contiguous
  int H, S, T, s_pad, d, dv;
  long long sqb, sqs, sqh, skb, sks, skh, svb, svs, svh;  // dout: contiguous [B, S, H, dv]
  int causal, window;
  float scale_log2, scale;
};

// rows [r0, r0 + 64) of a [.., width] operand into tile[c][row] (rows past
// n_rows and columns past width, up to `cols`, read as zeros)
__device__ __forceinline__ void load_t(float* tile, const float* g, long long rs, int r0, int n_rows,
                                       int width, int cols) {
  for (int e = threadIdx.x; e < kF * cols; e += kFThreads) {
    const int row = e / cols, c = e - row * cols, i = r0 + row;
    tile[c * kLdT + row] = (i < n_rows && c < width) ? g[(long long)i * rs + c] : 0.f;
  }
}

__device__ __forceinline__ bool admit(const F32Params& p, int i, int j) {
  const int diff = i - j;
  return j < p.T && (!p.causal || diff >= 0) && (p.window <= 0 || diff < p.window);
}

// dK/dV pass: one block per (64-key tile, b·h).  DT, DVT: d, dv rounded up
// to 64, 128 or 192 / 64 or 128.
template <int DT, int DVT>
__global__ void __launch_bounds__(kFThreads) dkdv_f32_kernel(F32Params p) {
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                // [DT][kLdT]  keys, transposed
  float* Vt = Kt + DT * kLdT;      // [DVT][kLdT]
  float* Qt = Vt + DVT * kLdT;     // [DT][kLdT]  the walked queries
  float* Dt = Qt + DT * kLdT;      // [DVT][kLdT] their dO
  float* Ps = Dt + DVT * kLdT;     // [64 queries][kLdT] P[key][query] at query * kLdT + key
  float* Ss = Ps + kF * kLdT;      // [64][kLdT] dS, likewise
  float* sl = Ss + kF * kLdT;      // [64] L·log2(e)
  float* sd = sl + kF;             // [64] Δ

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * kF;
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const float* qg = p.q + b * p.sqb + h * p.sqh;
  const float* dog = p.dout + ((long long)b * p.S * p.H + h) * p.dv;
  load_t(Kt, p.k + b * p.skb + h * p.skh, p.sks, k0, p.T, p.d, DT);
  load_t(Vt, p.v + b * p.svb + h * p.svh, p.svs, k0, p.T, p.dv, DVT);

  const int q_lo = p.causal ? k0 : 0;
  const int q_hi = p.window > 0 ? min(p.S, k0 + kF - 1 + p.window) : p.S;
  constexpr int NK = DT / 16, NV = DVT / 16;
  float ak[4][NK], av[4][NV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < NK; ++c) ak[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) av[i][c] = 0.f;
  }

  for (int q0 = (q_lo / kF) * kF; q0 < q_hi; q0 += kF) {
    __syncthreads();  // the previous tile is consumed
    load_t(Qt, qg, p.sqs, q0, p.S, p.d, DT);
    load_t(Dt, dog, (long long)p.H * p.dv, q0, p.S, p.dv, DVT);
    if (tid < kF) {
      sl[tid] = p.lse2[(long long)bh * p.s_pad + q0 + tid];
      sd[tid] = p.delta[(long long)bh * p.s_pad + q0 + tid];
    }
    __syncthreads();

    float st[4][4], dpt[4][4];  // rows keys ty*4 + i, columns queries tx*4 + j
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
    for (int c = 0; c < p.d; ++c) {
      float a[4], x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Kt[c * kLdT + ty * 4 + i], x[i] = Qt[c * kLdT + tx * 4 + i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = fmaf(a[i], x[j], st[i][j]);
    }
    for (int c = 0; c < p.dv; ++c) {
      float a[4], x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Vt[c * kLdT + ty * 4 + i], x[i] = Dt[c * kLdT + tx * 4 + i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dpt[i][j] = fmaf(a[i], x[j], dpt[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kr = ty * 4 + i, qc = tx * 4 + j;
        const float pr = admit(p, q0 + qc, k0 + kr) ? exp2f(fmaf(st[i][j], p.scale_log2, -sl[qc])) : 0.f;
        Ps[qc * kLdT + kr] = pr;
        Ss[qc * kLdT + kr] = pr * (dpt[i][j] - sd[qc]);
      }
    __syncthreads();

    for (int qq = 0; qq < kF; ++qq) {
      float pv[4], sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[qq * kLdT + ty * 4 + i], sv[i] = Ss[qq * kLdT + ty * 4 + i];
#pragma unroll
      for (int g = 0; g < DVT / 64; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x = Dt[(g * 64 + tx * 4 + j) * kLdT + qq];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i][g * 4 + j] = fmaf(pv[i], x, av[i][g * 4 + j]);
        }
#pragma unroll
      for (int g = 0; g < DT / 64; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x = Qt[(g * 64 + tx * 4 + j) * kLdT + qq];
#pragma unroll
          for (int i = 0; i < 4; ++i) ak[i][g * 4 + j] = fmaf(sv[i], x, ak[i][g * 4 + j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= p.T) continue;
    const long long row = ((long long)b * p.T + key) * p.H + h;
#pragma unroll
    for (int g = 0; g < DT / 64; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = g * 64 + tx * 4 + j;
        if (c < p.d) p.gk[row * p.d + c] = ak[i][g * 4 + j] * p.scale;
      }
#pragma unroll
    for (int g = 0; g < DVT / 64; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = g * 64 + tx * 4 + j;
        if (c < p.dv) p.gv[row * p.dv + c] = av[i][g * 4 + j];
      }
  }
}

// dQ pass: one block per (64-query tile, b·h), heaviest first.
template <int DT>
__global__ void __launch_bounds__(kFThreads) dq_f32_kernel(F32Params p) {
  extern __shared__ __align__(16) float smem[];
  const int dv = p.dv;
  float* Qt = smem;               // [DT][kLdT]
  float* Dt = Qt + DT * kLdT;     // [dv][kLdT]
  float* Kt = Dt + dv * kLdT;     // [DT][kLdT]  the walked keys
  float* Vt = Kt + DT * kLdT;     // [dv][kLdT]
  float* Ss = Vt + dv * kLdT;     // [64 keys][kLdT] dS[query][key] at key * kLdT + query

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kF;
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const float* kg = p.k + b * p.skb + h * p.skh;
  const float* vg = p.v + b * p.svb + h * p.svh;
  load_t(Qt, p.q + b * p.sqb + h * p.sqh, p.sqs, q0, p.S, p.d, DT);
  load_t(Dt, p.dout + ((long long)b * p.S * p.H + h) * dv, (long long)p.H * dv, q0, p.S, dv, dv);
  float ls[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ls[i] = p.lse2[(long long)bh * p.s_pad + q0 + ty * 4 + i];
    dl[i] = p.delta[(long long)bh * p.s_pad + q0 + ty * 4 + i];
  }

  int kv_lo = 0, kv_hi = p.T;
  if (p.causal) kv_hi = min(kv_hi, min(q0 + kF, p.S));
  if (p.window > 0) kv_lo = max(0, q0 - p.window + 1);
  constexpr int NQ = DT / 16;
  float aq[4][NQ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NQ; ++c) aq[i][c] = 0.f;

  for (int k0 = (kv_lo / kF) * kF; k0 < kv_hi; k0 += kF) {
    __syncthreads();
    load_t(Kt, kg, p.sks, k0, p.T, p.d, DT);
    load_t(Vt, vg, p.svs, k0, p.T, dv, dv);
    __syncthreads();

    float sc[4][4], dp[4][4];  // rows queries ty*4 + i, columns keys tx*4 + j
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < p.d; ++c) {
      float a[4], x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qt[c * kLdT + ty * 4 + i], x[i] = Kt[c * kLdT + tx * 4 + i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], x[j], sc[i][j]);
    }
    for (int c = 0; c < dv; ++c) {
      float a[4], x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Dt[c * kLdT + ty * 4 + i], x[i] = Vt[c * kLdT + tx * 4 + i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(a[i], x[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = ty * 4 + i, kc = tx * 4 + j;
        const float pr = admit(p, q0 + qr, k0 + kc) ? exp2f(fmaf(sc[i][j], p.scale_log2, -ls[i])) : 0.f;
        Ss[kc * kLdT + qr] = pr * (dp[i][j] - dl[i]);
      }
    __syncthreads();

    for (int kk = 0; kk < kF; ++kk) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = Ss[kk * kLdT + ty * 4 + i];
#pragma unroll
      for (int g = 0; g < DT / 64; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x = Kt[(g * 64 + tx * 4 + j) * kLdT + kk];
#pragma unroll
          for (int i = 0; i < 4; ++i) aq[i][g * 4 + j] = fmaf(sv[i], x, aq[i][g * 4 + j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr >= p.S) continue;
    const long long row = ((long long)b * p.S + qr) * p.H + h;
#pragma unroll
    for (int g = 0; g < DT / 64; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = g * 64 + tx * 4 + j;
        if (c < p.d) p.gq[row * p.d + c] = aq[i][g * 4 + j] * p.scale;
      }
  }
}

template <int DT, int DVT>
cudaError_t launch_f32(const F32Params& p, int B, cudaStream_t s) {
  auto dkdv = dkdv_f32_kernel<DT, DVT>;
  size_t smem = ((size_t)(2 * DT + 2 * DVT + 2 * kF) * kLdT + 2 * kF) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((p.T + kF - 1) / kF, B * p.H), kFThreads, smem, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto dq = dq_f32_kernel<DT>;
  smem = (size_t)(2 * DT + 2 * p.dv + kF) * kLdT * sizeof(float);
  err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dq<<<dim3((p.S + kF - 1) / kF, B * p.H), kFThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int DT>
cudaError_t launch_f32_dv(const F32Params& p, int B, cudaStream_t s) {
  return p.dv <= 64 ? launch_f32<DT, 64>(p, B, s) : launch_f32<DT, 128>(p, B, s);
}

}  // namespace

// Gradients of flash_attention_launch's output.  q: [B, S, H, d], k: [B, T,
// H, d], v: [B, T, H, dv] with the given element strides (the last dim
// contiguous); out, dout: contiguous [B, S, H, dv], the forward's output and
// its gradient; lse: float32 [B, H, S], the forward's log-sum-exp.
// lse2, delta: float32 scratch of B·H·s_pad each, s_pad = S rounded up to 64.
// dq, dk, dv: contiguous outputs [B, S|T, H, d|dv].  Scores are scaled by
// 1/sqrt(scale_d), as in the forward.  is_bf16 selects the tensor-core
// kernels (__nv_bfloat16) over the float32 ones.  One stream, no atomics.
REPRO_API int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* out,
                                         const void* dout, const void* lse, void* lse2, void* delta,
                                         void* dq, void* dk, void* dv, int B, int H, int S, int T,
                                         int d, int dvw, int scale_d, long long sqb, long long sqs,
                                         long long sqh, long long skb, long long sks, long long skh,
                                         long long svb, long long svs, long long svh, int causal,
                                         int window, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || T <= 0) return 0;
  if (d < 1 || d > 192 || dvw < 1 || dvw > 128 || scale_d < 1 || scale_d > d || window < 0 ||
      (long long)B * H > 65535 || (T + kRows - 1) / kRows > 65535 || (S + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int s_pad = (S + kRows - 1) / kRows * kRows;
  float* l2 = static_cast<float*>(lse2);
  float* dl = static_cast<float*>(delta);
  cudaError_t err;
  if (is_bf16) {
    if (d % 8 || dvw % 8) return (int)cudaErrorInvalidValue;
    err = launch_prep(static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(dout),
                      static_cast<const float*>(lse), l2, dl, B, H, S, s_pad, dvw, s);
    if (err != cudaSuccess) return (int)err;
    TcParams p;
    const long long sdb = (long long)S * H * dvw, sds = (long long)H * dvw;
    if (!make_map(&p.tq, q, d, H, S, B, sqb, sqs, sqh) || !make_map(&p.tk, k, d, H, T, B, skb, sks, skh) ||
        !make_map(&p.tv, v, dvw, H, T, B, svb, svs, svh) ||
        !make_map(&p.tdo, dout, dvw, H, S, B, sdb, sds, dvw))
      return (int)cudaErrorInvalidValue;
    p.lse2 = l2, p.delta = dl;
    p.dq = static_cast<__nv_bfloat16*>(dq), p.dk = static_cast<__nv_bfloat16*>(dk);
    p.dv = static_cast<__nv_bfloat16*>(dv);
    p.H = H, p.S = S, p.T = T, p.s_pad = s_pad, p.dw = d, p.dvw = dvw;
    p.causal = causal, p.window = window;
    p.scale = 1.0f / sqrtf((float)scale_d);
    p.scale_log2 = kLog2e * p.scale;
    if (d <= 64) return (int)(dvw <= 64 ? launch_tc<64, 64>(p, B, s) : launch_tc<64, 128>(p, B, s));
    if (d <= 128) return (int)(dvw <= 64 ? launch_tc<128, 64>(p, B, s) : launch_tc<128, 128>(p, B, s));
    return (int)(dvw <= 64 ? launch_tc<192, 64>(p, B, s) : launch_tc<192, 128>(p, B, s));
  }
  err = launch_prep(static_cast<const float*>(out), static_cast<const float*>(dout),
                    static_cast<const float*>(lse), l2, dl, B, H, S, s_pad, dvw, s);
  if (err != cudaSuccess) return (int)err;
  F32Params p{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
              static_cast<const float*>(dout), l2, dl, static_cast<float*>(dq), static_cast<float*>(dk),
              static_cast<float*>(dv), H, S, T, s_pad, d, dvw, sqb, sqs, sqh, skb, sks, skh, svb, svs,
              svh, causal, window, 0.f, 1.0f / sqrtf((float)scale_d)};
  p.scale_log2 = kLog2e * p.scale;
  if (d <= 64) return (int)launch_f32_dv<64>(p, B, s);
  if (d <= 128) return (int)launch_f32_dv<128>(p, B, s);
  return (int)launch_f32_dv<192>(p, B, s);
}
