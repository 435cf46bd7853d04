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
// bound, HBM a 0.02 ms one.  P's split into hi and lo (below) makes three
// products a tile, not two: a floor of ~0.052 ms.
//
// Two kernels, chosen by dtype:
//
// bfloat16 (the serving and training path) — FA3's shape, on wgmma and TMA.
//   * Persistent: one block per SM, 384 threads — a producer warpgroup and
//     two consumer warpgroups of 64 query rows each — walks work items of
//     (128-row query tile, b·h), heaviest (last, under a causal mask) first,
//     block k taking items k, 2G-1-k, 2G+k, ... of G blocks.  The producer
//     lowers its register budget to 40 and the consumers raise theirs to 232
//     (setmaxnreg), though ptxas still fits them in the launch's 168.
//   * One producer thread copies each item's Q into one of two Q buffers,
//     then its K/V tiles of 64 keys, by TMA through 4-D tensor maps over the
//     strided [B, T, H, d] views, in 64-element boxes with the 128B swizzle
//     that wgmma reads; ragged S and T ends are zero-filled by the copy.  The
//     K/V tiles go round a 4-stage ring (3 at d 192 / dv 128): each stage has
//     a "full" mbarrier that its copy completes and an "empty" one that each
//     of the 8 consumer warps arrives on once its products on the stage have
//     landed; the producer refills a stage when all 8 have, so the next
//     item's Q and first tiles are in flight while an item ends.
//   * Each consumer pipelines its products across the softmax: it issues
//     S_j = Q·K_jᵀ and then O += P_{j-1}·V_{j-1}, runs the softmax of S_j
//     once that group has landed (wgmma.wait_group 1) while P_{j-1}·V_{j-1}
//     still runs, and rescales O after both (wait_group 0).
//   * The two consumers ping-pong on two named barriers: each issues its
//     products only in its turn and passes the turn on at once, so that one
//     warpgroup's products run while the other's softmax does.
//   * S: K read from shared memory (K-major), Q's A fragments from
//     registers (ldmatrix once an item) at d <= 128 / dv 64, else from shared
//     memory too; float32 accumulators in registers; d/16 k-steps (12 at
//     d = 192).
//   * Online softmax on the accumulator fragment (exp2 with a log2(e)-scaled
//     score): each thread holds 2 rows x KT/4 keys; row max by quad
//     shuffles, the row sum kept per thread and summed over the quad once at
//     the end.  Masks are applied only on edge tiles (diagonal, window edge,
//     ragged T: a second instantiation of the softmax, so interior tiles
//     carry no mask code), and a masked score is excluded by a flag, never
//     by a sentinel, so a row with no admissible key sums to 0 and gets
//     zeros; the output is acc / max(l, 1e-30).  A tile wholly above a
//     consumer's diagonal or outside its window is skipped by it: it keeps
//     the turn (so that the two consumers' turns pair up) and releases the
//     stage.
//   * O += P·V: wgmma m64nDVk16 with P as the A operand from registers (the
//     S fragment of 16 keys is an A fragment) and V as the B operand read
//     MN-major from shared memory, so V is never transposed.  P keeps
//     float32 accuracy: P_hi = bf16(P) and P_lo = bf16(P - P_hi) go through
//     two wgmmas into the same float32 accumulator (ROADMAP C.8); P_hi +
//     P_lo holds about 16 of P's 24 significant bits.
//   * Epilogue, per consumer: its bf16 rows staged in its own rows of the
//     item's Q buffer (swizzled, conflict-free), stored as 16-byte vectors,
//     one contiguous row of out per 8 or 16 threads; then the Q buffer is
//     released to the producer.
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
// bfloat16: warp-specialised wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;                 // query rows per consumer warpgroup
constexpr int kTQ = 2 * kWgRows;            // query rows per work item
constexpr int kConsumers = 2 * 128;         // two consumer warpgroups
constexpr int kTcThreads = 128 + kConsumers;  // and the producer warpgroup
// setmaxnreg budgets: 128 x 40 + 256 x 232 = 64,512 of the SM's 65,536
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kTurnBar = 1;      // named barriers 1, 2: consumer 0's and 1's turn to issue
constexpr int kEpilogueBar = 3;  // named barriers 3, 4: one consumer's epilogue
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use

struct TcParams {
  CUtensorMap tq, tk, tv;
  __nv_bfloat16* o;
  float* lse;  // [B, H, S] or null
  int H, S, T, dv;
  int causal, window;
  float scale_log2;  // log2(e) / sqrt(d), d unpadded
  int bh;            // B·H
  int n_items;       // bh · ceil(S / kTQ) work items, heaviest query tiles first
};

// Dynamic shared memory of a block: 1024-byte alignment slack, two Q
// buffers, the ring, and the mbarriers q_full[2], q_empty[2], full[stages],
// empty[stages].
constexpr int tc_smem(int q_bytes, int stage_bytes, int stages) {
  return 1024 + 2 * q_bytes + stages * stage_bytes + (4 + 2 * stages) * 8;
}

// The tile widths of one instantiation.  DP: d rounded up to 64, 128 or 192;
// DVP: dv rounded up to 64 or 128 (the shared-memory tile widths); KT: keys
// per K/V tile.  A consumer holds S, P's hi and lo fragments (KT/2 registers
// each) and O (DVP/2) at once.  ptxas compiles the consumers within the
// launch's 168 registers a thread (3 warps on each SM sub-partition), not the
// 232 that setmaxnreg grants them, so 128-key tiles spill and serialise their
// wgmmas: every width takes 64 keys.
template <int DP, int DVP>
struct TcTile {
  static constexpr int kKT = 64;
  static constexpr int kQBytes = kTQ * DP * 2, kKBytes = kKT * DP * 2, kVBytes = kKT * DVP * 2;
  // 4 stages, 3 where they do not fit (d 192 / dv 128)
  static constexpr int kStages = tc_smem(kQBytes, kKBytes + kVBytes, 4) <= kSmemLimit ? 4 : 3;
  static constexpr int kSmem = tc_smem(kQBytes, kKBytes + kVBytes, kStages);
  // Q's A fragments held in registers (DP/16 x 4), so that S = Q·Kᵀ reads
  // only K from shared memory, where the registers allow (dv <= 64, d <= 128)
  static constexpr bool kQInRegs = DVP == 64 && DP <= 128;
  static_assert(kSmem <= kSmemLimit, "flash_tc_kernel: shared memory past a block's 227 KB");
};

// Work item w: query tile n_q - 1 - w / (B·H) of head w % (B·H), so that
// the heaviest query tiles (last, under a causal mask) come first.
struct Item {
  int b, h, q0, t_lo, n_tiles;
};

template <int KT>
__device__ __forceinline__ Item work_item(const TcParams& p, int w) {
  const int n_q = (p.S + kTQ - 1) / kTQ;
  Item it;
  const int bh = w % p.bh;
  it.b = bh / p.H, it.h = bh - it.b * p.H;
  it.q0 = (n_q - 1 - w / p.bh) * kTQ;
  int kv_lo = 0, kv_hi = p.T;
  if (p.causal) kv_hi = min(kv_hi, min(it.q0 + kTQ, p.S));
  if (p.window > 0) kv_lo = max(0, it.q0 - p.window + 1);
  it.t_lo = kv_lo / KT;
  it.n_tiles = kv_hi > kv_lo ? (kv_hi + KT - 1) / KT - it.t_lo : 0;
  return it;
}

// Block k of G takes, in round r, item r·G + k (r even) or r·G + G-1-k (r
// odd): a snake over the heaviest-first order, which evens out the blocks'
// sums of causal work.  k and G are read afresh each time (volatile), so
// that no register holds them across the rounds: at d 192 / dv 128 the
// consumers have none to spare.
__device__ __forceinline__ int grid_blocks() {
  int g;
  asm volatile("mov.u32 %0, %%nctaid.x;\n" : "=r"(g));
  return g;
}
__device__ __forceinline__ int round_item(int r) {
  int k;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(k));
  const int g = grid_blocks();
  return r * g + ((r & 1) ? g - 1 - k : k);
}

template <int DP, int DVP>
__global__ void __launch_bounds__(kTcThreads, 1) flash_tc_kernel(const __grid_constant__ TcParams p) {
  using Tile = TcTile<DP, DVP>;
  constexpr int KT = Tile::kKT, kStages = Tile::kStages;
  constexpr int kQBytes = Tile::kQBytes, kKBytes = Tile::kKBytes, kVBytes = Tile::kVBytes;
  constexpr int kNs = KT / 2;   // score accumulators per thread
  constexpr int kNo = DVP / 2;  // output accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the 128B swizzle pattern repeats every 8 rows
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = smem;                        // [2][DP/64][kTQ][64] bf16
  uint8_t* sk = sq + 2 * kQBytes;            // [kStages][DP/64][KT][64]
  uint8_t* sv = sk + kStages * kKBytes;      // [kStages][DVP/64][KT][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sv + kStages * kVBytes);

  // the warpgroup, read through a shuffle so that ptxas knows it is the same
  // across a warp: the roles' branches never diverge inside one
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid >> 7, 0), lane = tid & 31;
  auto bar_q = [&](int qb) { return smem_u32(bars + qb); };            // Q buffer qb has landed
  auto bar_q_empty = [&](int qb) { return smem_u32(bars + 2 + qb); };  // ... and may be refilled
  auto bar_full = [&](int s) { return smem_u32(bars + 4 + s); };
  auto bar_empty = [&](int s) { return smem_u32(bars + 4 + kStages + s); };

  if (tid == 0) {
    for (int qb = 0; qb < 2; ++qb) mbar_init(bar_q(qb), 1), mbar_init(bar_q_empty(qb), kConsumers / 32);
    for (int s = 0; s < kStages; ++s) mbar_init(bar_full(s), 1), mbar_init(bar_empty(s), kConsumers / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread copies each item's Q into the free Q buffer, then
    // its K/V tiles round the ring, as far ahead as the consumers free them
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      int g = 0;  // K/V tiles issued by this block
      for (int r = 0, i = 0; r * grid_blocks() < p.n_items; ++r) {
        const int w = round_item(r);
        if (w >= p.n_items) continue;
        const Item it = work_item<KT>(p, w);
        const int qb = i & 1;
        if (i >= 2) mbar_wait(bar_q_empty(qb), ((i >> 1) - 1) & 1);  // item i - 2 is done with it
        ++i;
        mbar_expect_tx(bar_q(qb), kQBytes);
#pragma unroll 1
        for (int c = 0; c < DP / kBox; ++c)
#pragma unroll 1
          for (int rr = 0; rr < kTQ / kTile; ++rr)
            tma_load(smem_u32(sq + qb * kQBytes + (c * kTQ + rr * kTile) * 128), &p.tq, bar_q(qb), c * kBox,
                     it.h, it.q0 + rr * kTile, it.b);
        for (int j = 0; j < it.n_tiles; ++j, ++g) {
          const int s = g % kStages, k0 = (it.t_lo + j) * KT;
          if (g >= kStages) mbar_wait(bar_empty(s), (g / kStages - 1) & 1);  // both consumers done with it
          mbar_expect_tx(bar_full(s), kKBytes + kVBytes);
#pragma unroll 1
          for (int c = 0; c < DP / kBox; ++c)
#pragma unroll 1
            for (int rr = 0; rr < KT / kTile; ++rr)
              tma_load(smem_u32(sk + s * kKBytes + (c * KT + rr * kTile) * 128), &p.tk, bar_full(s), c * kBox,
                       it.h, k0 + rr * kTile, it.b);
#pragma unroll 1
          for (int c = 0; c < DVP / kBox; ++c)
#pragma unroll 1
            for (int rr = 0; rr < KT / kTile; ++rr)
              tma_load(smem_u32(sv + s * kVBytes + (c * KT + rr * kTile) * 128), &p.tv, bar_full(s), c * kBox,
                       it.h, k0 + rr * kTile, it.b);
        }
      }
    }
  } else {
    // consumers: 64 query rows of each item each
    setmaxnreg_inc<kConsumerRegs>();
    const int cwg = wg - 1, wtid = tid & 127, warp = __shfl_sync(0xffffffffu, (tid >> 5) & 3, 0);
    const int col = 2 * (lane & 3);  // first of the thread's two columns in each 8-key block
    const int row_lo = warp * 16 + (lane >> 2);  // this thread's rows in its warpgroup: row_lo, + 8
    float m[2], l[2], sc[kNs], o[kNo];
    // P of the tile whose P·V product is issued next, as A fragments of 16
    // keys each: {rows lo, hi} x {keys 0-7, 8-15}; P_hi = bf16(P), P_lo =
    // bf16(P - P_hi)
    uint32_t p_hi[KT / 16][4], p_lo[KT / 16][4];
    uint32_t qa[Tile::kQInRegs ? DP / 16 : 1][4];  // Q's A fragments, 16 columns each
    uint32_t q_base;        // this warpgroup's rows of the item's Q buffer
    int r_lo, r_hi, wg_r0, wg_r1;  // rows of the item, in the sequence

    auto issue_s = [&](int s) {  // S = Q·K_sᵀ into sc
      const uint32_t k_base = smem_u32(sk + s * kKBytes);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 of the 64 elements of a swizzled row
        const uint64_t kd = smem_desc(k_base + (kk / 4) * KT * 128 + off, 16, 1024);
        if constexpr (Tile::kQInRegs)
          wgmma_rs_kmajor_n64(sc, qa[kk], kd, kk > 0);
        else
          wgmma_ss<KT>(sc, smem_desc(q_base + (kk / 4) * kTQ * 128 + off, 16, 1024), kd, kk > 0);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int s) {  // O += P·V_s
      const uint32_t v_base = smem_u32(sv + s * kVBytes);
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        // 16 keys = two 8-row swizzle atoms of V; the dv halves are KT rows apart
        const uint64_t dvd = smem_desc(v_base + kk * 16 * 128, KT * 128, 1024);
        wgmma_rs<DVP>(o, p_hi[kk], dvd);
        wgmma_rs<DVP>(o, p_lo[kk], dvd);
      }
      wgmma_commit();
    };
    // online softmax of the landed S of the tile at key k0: sc becomes P
    // (unnormalised), m and l move on, corr rescales O
    auto softmax = [&](int k0, float (&corr)[2]) {
      const bool edge = k0 + KT > p.T || (p.causal && k0 + KT - 1 > wg_r0) ||
                        (p.window > 0 && wg_r1 - k0 >= p.window);
      // sc[4n + e]: row (e < 2 ? r_lo : r_hi), key k0 + 8n + col + (e & 1).
      // Two instantiations, so that only edge tiles carry the mask's code.
      auto body = [&](auto masked) {
        constexpr bool kMasked = decltype(masked)::value;
        // each of the thread's two rows admits the keys [lo, hi); tested
        // without branches, so that a warp never splits over a mask
        // (both relative to the thread's first key, k0 + col, so that each
        // test compares a constant)
        int lo[2], hi[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = e ? r_hi : r_lo;
          lo[e] = (p.window > 0 ? r - p.window + 1 : 0) - k0 - col;
          hi[e] = (p.causal ? min(p.T, r + 1) : p.T) - k0 - col;  // past T: the copy's zero fill
        }
        auto admissible = [&](int i) {
          const int e = (i >> 1) & 1, c = 8 * (i >> 2) + (i & 1);
          return (c >= lo[e]) & (c < hi[e]);
        };
        float mt[2] = {-1e30f, -1e30f};  // row max of the raw scores
#pragma unroll
        for (int i = 0; i < kNs; ++i)
          mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], !kMasked || admissible(i) ? sc[i] : -1e30f);
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
        for (int i = 0; i < kNs; ++i) {
          const int e = (i >> 1) & 1;
          const float x = ex2(fmaf(sc[i], p.scale_log2, -ms[e]));  // inf or 0 where masked
          sc[i] = !kMasked || admissible(i) ? x : 0.f;
          l[e] += sc[i];
        }
      };
      if (edge)
        body(std::true_type{});
      else
        body(std::false_type{});
    };
    auto to_fragments = [&] {  // P_hi, P_lo from sc
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
          p_hi[kk][r] = bf16x2(x0, x1);
          const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&p_hi[kk][r]);
          p_lo[kk][r] = bf16x2(x0 - __low2float(hi), x1 - __high2float(hi));
        }
    };
    // this warp is done with a barrier's buffer: its products on it (or its
    // epilogue's reads of it) have landed
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // ping-pong: consumer 0 takes the first turn; each turn issues S_j and
    // P_{j-1}·V_{j-1} and passes the turn on.  Consumer 1 passes once more
    // at the start and consumer 0 takes that pass at the end, so that both
    // barriers are left balanced.
    auto turn_wait = [&] { bar_sync(kTurnBar + cwg, kConsumers); };
    auto turn_pass = [&] { bar_arrive(kTurnBar + (cwg ^ 1), kConsumers); };
    if (cwg == 1) turn_pass();

    int g = 0;  // K/V tiles consumed by this block
    for (int r = 0, i = 0; r * grid_blocks() < p.n_items; ++r) {
      const int w = round_item(r);
      if (w >= p.n_items) continue;
      const Item it = work_item<KT>(p, w);
      const int qb = i & 1;
      wg_r0 = it.q0 + cwg * kWgRows, wg_r1 = wg_r0 + kWgRows - 1;
      r_lo = wg_r0 + row_lo, r_hi = r_lo + 8;
      q_base = smem_u32(sq + qb * kQBytes + cwg * kWgRows * 128);
      m[0] = m[1] = -1e30f;  // -1e30 while the row has seen no key
      l[0] = l[1] = 0.f;
#pragma unroll
      for (int k = 0; k < kNo; ++k) o[k] = 0.f;
      mbar_wait(bar_q(qb), (i >> 1) & 1);
      ++i;
      if constexpr (Tile::kQInRegs) {
        // lane L addresses row (L & 7) + 8·((L >> 3) & 1) of its warp's 16,
        // columns 8·(L >> 4) of each 16: the four quarters of a k-step
        const int row = cwg * kWgRows + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const int c = kk * 16 + (lane >> 4) * 8;
          ldmatrix_x4(qa[kk], smem_u32(sq + qb * kQBytes + (c / 64) * kTQ * 128 + row * 128 +
                                       ((((c % 64) >> 3) ^ (row & 7)) << 4)));
        }
      }

      if (it.n_tiles > 0) {
        // tiles [a, b] of the item hold the keys this warpgroup's rows admit;
        // on the others (wholly above its diagonal or outside its window) it
        // only takes its turn and releases the stage, in the tiles' order,
        // once the stage is full (so that its arrival cannot count towards
        // the stage's previous use, which the other warpgroup may still read)
        const int rows_end = min(wg_r1, p.S - 1);
        const int kv_lo = p.window > 0 ? max(0, wg_r0 - p.window + 1) : 0;
        const int kv_hi = p.causal ? min(p.T, rows_end + 1) : p.T;
        int a = kv_lo / KT - it.t_lo, b = min((kv_hi - 1) / KT - it.t_lo, it.n_tiles - 1);
        if (rows_end < wg_r0 || kv_hi <= kv_lo) a = it.n_tiles, b = it.n_tiles - 1;  // no key at all
        auto idle_turn = [&](int j) {
          if (j < it.n_tiles) mbar_wait(bar_full((g + j) % kStages), ((g + j) / kStages) & 1);
          turn_wait();
          turn_pass();
          if (j < it.n_tiles) release(bar_empty((g + j) % kStages));
        };
        for (int j = 0; j < a; ++j) idle_turn(j);
        if (a <= b) {
          float corr[2];
          mbar_wait(bar_full((g + a) % kStages), ((g + a) / kStages) & 1);
          turn_wait();
          wgmma_fence();
          issue_s((g + a) % kStages);
          turn_pass();
          wgmma_wait<0>();
          fence_regs(sc);
          softmax((it.t_lo + a) * KT, corr);  // O is still 0: no rescale
          to_fragments();
          for (int j = a + 1; j <= b; ++j) {
            const int s = (g + j) % kStages, prev = (g + j - 1) % kStages;
            mbar_wait(bar_full(s), ((g + j) / kStages) & 1);
            turn_wait();
            wgmma_fence();
            issue_s(s);
            issue_pv(prev);
            turn_pass();
            wgmma_wait<1>();  // S_j has landed; P_{j-1}·V_{j-1} runs on
            fence_regs(sc);
            softmax((it.t_lo + j) * KT, corr);
            wgmma_wait<0>();  // P_{j-1}·V_{j-1} has landed: O and the fragments are free
            fence_regs(o);
#pragma unroll
            for (int kk = 0; kk < KT / 16; ++kk) fence_regs(p_hi[kk]), fence_regs(p_lo[kk]);
            release(bar_empty(prev));
#pragma unroll
            for (int k = 0; k < kNo; ++k) o[k] *= corr[(k >> 1) & 1];
            to_fragments();
          }
          const int last = (g + b) % kStages;
          turn_wait();
          wgmma_fence();
          issue_pv(last);
          turn_pass();
          wgmma_wait<0>();
          fence_regs(o);
          release(bar_empty(last));
        } else {
          idle_turn(it.n_tiles);  // the turn that would issue the last P·V
        }
        for (int j = b + 1; j < it.n_tiles; ++j) idle_turn(j);
        g += it.n_tiles;
      }

      // epilogue: out = o / max(l, 1e-30) in bf16, staged through this
      // warpgroup's rows of the item's Q buffer (its own S products on them
      // have landed, and the other warpgroup reads other rows)
      float inv[2];  // 1 / max(l, 1e-30)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float t = l[e];
        t += __shfl_xor_sync(0xffffffffu, t, 1);
        t += __shfl_xor_sync(0xffffffffu, t, 2);
        inv[e] = 1.f / fmaxf(t, 1e-30f);
        // the row's log-sum-exp of the scaled scores, natural log (the
        // backward's residual): m is a raw score, l sums 2^((s - m) scale_log2)
        const int row = e ? r_hi : r_lo;
        if (p.lse != nullptr && (lane & 3) == 0 && row < p.S)
          p.lse[((long long)it.b * p.H + it.h) * p.S + row] =
              t > 0.f ? m[e] * (p.scale_log2 / kLog2e) + logf(t) : -INFINITY;
      }
      // the staged rows keep Q's layout: 64-column chunks kTQ rows apart, the
      // 16-byte units of a row swizzled by the row's low 3 bits; at dv > d
      // the columns go in passes of DP
      constexpr int kPassCols = DP < DVP ? DP : DVP;
      uint8_t* so = sq + qb * kQBytes + cwg * kWgRows * 128;
#pragma unroll
      for (int c0 = 0; c0 < DVP; c0 += kPassCols) {
        if (c0 > 0) bar_sync(kEpilogueBar + cwg, 128);  // the last pass's rows are read
#pragma unroll
        for (int k = 0; k < kNo; k += 2) {
          const int e = (k >> 1) & 1, row = row_lo + 8 * e, c = 8 * (k >> 2) + col - c0;
          if (c < 0 || c >= kPassCols) continue;  // resolved at compile time
          *reinterpret_cast<uint32_t*>(so + (c / 64) * kTQ * 128 + row * 128 +
                                       ((((c % 64) >> 3) ^ (row & 7)) << 4) + (c % 8) * 2) =
              bf16x2(o[k] * inv[e], o[k + 1] * inv[e]);
        }
        bar_sync(kEpilogueBar + cwg, 128);
        const int units = min(kPassCols, p.dv - c0) / 8;  // 16-byte units per row in this pass
        for (int idx = wtid; idx < kWgRows * units; idx += 128) {
          const int row = idx / units, u = idx - row * units, qi = wg_r0 + row;
          if (qi >= p.S || units <= 0) continue;
          *reinterpret_cast<uint4*>(p.o + (((long long)it.b * p.S + qi) * p.H + it.h) * p.dv + c0 + u * 8) =
              *reinterpret_cast<const uint4*>(so + (u / 8) * kTQ * 128 + row * 128 + (((u % 8) ^ (row & 7)) << 4));
        }
      }
      release(bar_q_empty(qb));
    }
    if (cwg == 0) turn_wait();
  }
}

template <int DP, int DVP>
cudaError_t launch_tc(TcParams& p, int B, cudaStream_t s) {
  auto kernel = flash_tc_kernel<DP, DVP>;
  constexpr int smem = TcTile<DP, DVP>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // persistent: one block per SM walks the work items
  p.bh = B * p.H;
  p.n_items = p.bh * ((p.S + kTQ - 1) / kTQ);
  const dim3 grid(min(p.n_items, sm_count()));
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
