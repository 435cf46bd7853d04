// The §6.3 row filter, hand-written for Hopper (sm_90a): ROADMAP B.1, B.2,
// B.4 and B.5, one templated body (`Op` picks what a launch writes).
//
// Replaces: src/repro/kernels/filter_kernel.py : four Pallas kernels,
//   * filter_table_counts (_table_counts_kernel, B.1): candidate rows
//     host-gathered as int32[n, lanes]; per-table counts, 'sum' or 'any',
//     and per-key counts;
//   * gather_filter_table_counts (_gather_counts_kernel, B.2): the candidate
//     rows read in place from the device-resident superkey store at int32
//     offsets, only its first `lanes` words, which is the serving tier's
//     lane-prefix degrade; 'sum' counts only;
//   * filter_match (_match_kernel, B.4): the int8[n, q] match matrix, every
//     byte 0 or 1;
//   * filter_count (_count_kernel, B.5): int32[q] per-query counts of rows
//     that pass (an all-zero query counts every row).
// Per (row i, query j): (q_j & ~r_i) == 0 on every probed lane, AND
// elig[i, j] (when given), AND j < n_queries, AND seg[i] >= 0 (B.1, B.2).
// 'sum' counts every such pair into counts[seg[i]]; 'any' counts each row
// with at least one; B.1 and B.5 count each pair into key_counts[j]; B.4
// writes it as out[i, j].  Only B.4 writes the n x q matrix.
//
// What bounds it on this card: bytes.  B.1/B.2: mostly the n x q int8
// eligibility stream (256 MB at n = 2^20, q = 256); then the rows (B.1: 16..64
// B each; B.2: one 32-byte sector per gathered row, its offset) and the table
// ids.  B.4: the n x q output (256 MB at the same shape).  B.5: the rows
// alone (16 MB at 128 bits).  The tests are a few integer operations per live
// (row, query) pair, but a warp instruction tests 32 threads' queries at
// once, so the kernel is in practice bound by instruction issue (PERF.md).
//
// What the design does about it:
//   * Eligibility first (B.1, B.2).  Each thread owns 8 consecutive queries
//     of a 256-query tile for the whole launch (grid.y walks the tiles) and
//     reads their 8 elig bytes of a row as one 8-byte load, so a warp reads a
//     row's 256 bytes coalesced; the nonzero bytes give an 8-bit alive mask,
//     and ineligible pairs cost no test.  Rows whose elig is not 8-byte
//     aligned (q not a multiple of 8) are read as two aligned words and
//     shifted.  A warp issues the elig loads of 4 rows before it tests any.
//   * Queries held per thread.  The owned queries' words sit in registers:
//     the superkey itself at 128 and 256 bits, its fold onto 4 words at 512
//     (`Fold`).  They are tested 4 words at a time against the row's (one
//     16-byte shared-memory broadcast per row), stopping when the alive mask
//     is 0.  A warp tests 4 rows at a time; without elig their first tests
//     have no branch, so the compiler interleaves them.
//   * Folds at 512 bits.  When a chunk lands, each thread folds the row it
//     copied into the row's 4 spare words.  The fold test rules out almost
//     every pair; the pairs left take the full test against the query's 16
//     lanes in shared memory, one query alive anywhere in the warp at a time
//     (all-zero queries, which every row holds, skip it).  16 lanes of 8
//     queries in registers would not fit, and 8 lanes plus the rest in shared
//     memory took the slow path for most rows.
//   * Rows in flight.  A block takes chunks of 256 candidate rows: each
//     thread copies one row's lanes into shared memory with 16-byte
//     cp.async (4-byte copies when the probed lanes or the row width are not
//     a multiple of 4 words: B.2 over a 1-, 2-, 3-, 5-... lane prefix) and
//     its table id with a 4-byte one, double-buffered, so the
//     next chunk's copies are in flight while this chunk is tested.  Host
//     rows are contiguous, so a warp's copies are coalesced; B.2 gathers, and
//     loads its row offsets one chunk further ahead.  (TMA cannot gather
//     scattered rows.)
//   * Small q (tens of keys per discover): a row needs only ceil(q / 8)
//     threads, so a warp packs 32 / G rows (G the power of two >= that), and
//     no lane idles.
//   * Table counts (B.1, B.2): hits per thread by __popc, per row by
//     __reduce_add_sync (or a butterfly within the G threads), one
//     shared-memory atomicAdd per row into the block's int32[n_tables]
//     histogram, flushed to the global counts once per block.  'any' over one
//     tile adds 1 per row with a hit; over several tiles (q > 256, whose tiles
//     run in different blocks) each block marks its rows' hits in a byte per
//     row, and a second small kernel scatters the marked rows into the table
//     counts.
//   * Key counts (B.1, B.5): each thread counts its owned queries' hits in
//     registers, a byte per query in two words (a row's 8-bit hit mask is
//     spread to bytes by two multiplies), so the 64-register bound that keeps
//     4 blocks per SM at 128 bits holds.  Every 7 chunks, before a byte can
//     overflow, the bytes go to a per-block int32[256] shared histogram,
//     which is added to key_counts once per block: one global atomic per
//     (block, query), not one per hit, and no ballot or shared atomic per
//     (warp, query).
//   * The match matrix (B.4): a row's 8-bit hit mask is spread to 8 bytes of
//     0/1 the same way.  When q % 8 == 0 (the headline shape) they are one
//     aligned 8-byte store, and a warp writes a row's 256 bytes coalesced.
//     Otherwise, when one tile holds every query (q <= 256: every launch of
//     the main path, 18-30 keys), a warp's 32 rows are one contiguous span of
//     the output: the warp stages 16 of them at a time (all 32 when q <= 32)
//     in its 4 KB of shared memory and writes the span, which starts 16-byte
//     aligned for any q, as 16-byte streaming stores.  Over several tiles a
//     thread writes its bytes of a row in place.  Offsets are 64-bit: n * q
//     may pass 2^31.
//   B.4 and B.5 were kernels of their own, one thread per output byte and one
//   row per thread (75 and 109 lines); here they are two Ops, ~60 lines.
//   Integer atomics commute: every count is bit-identical from run to run.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;   // candidate rows per block step, one copied per thread
constexpr int kQpt = 8;       // queries per thread
constexpr int kTile = 256;    // queries per tile: 32 threads x 8
constexpr int kUnroll = 4;    // rows a warp tests at a time (their elig loads in flight)
constexpr int kStageBytes = 16 * kTile;  // B.4: a warp's staged rows, 16 x 256 queries

// what a launch computes
enum Op {
  kGather,  // B.2: gathered rows, 'sum' table counts
  kSum,     // B.1: 'sum' table counts and key counts
  kAny,     // B.1: 'any' table counts and key counts
  kKeys,    // B.5: key counts of every row (no elig, no table ids)
  kMatch,     // B.4, q % 8 == 0: the match matrix (no elig, no table ids)
  kMatchOdd,  // B.4, q % 8 != 0
};

struct Args {
  const uint32_t* rows_sk;  // B.2: the store [N, row_stride]; else the rows [n, row_stride]
  int row_stride, lanes;
  const int32_t* rows;      // B.2: int32[n] offsets into the store
  const uint32_t* query;
  int n_queries;
  const int8_t* elig;
  long long elig_stride;
  const int32_t* seg;
  long long n;
  int n_tables;
  int32_t* counts;
  int32_t* key_counts;  // B.1, B.5: int32[>= n_queries]
  uint8_t* row_hit;     // 'any' over several tiles: uint8[n], zeroed
  bool vec16;           // rows copied in 16-byte groups
  int8_t* out;          // B.4: int8[n, n_queries]
  bool staged;          // B.4, q % 8 != 0, one tile: rows go out through shared memory
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prev() {  // all but the newest group landed
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// bit k of an 8-bit mask as byte k (0 or 1): bytes 0-3 in x, 4-7 in y
__device__ __forceinline__ uint2 mask_bytes(uint32_t m) {
  return make_uint2(((m & 0xfu) * 0x00204081u) & 0x01010101u,
                    (((m >> 4) & 0xfu) * 0x00204081u) & 0x01010101u);
}

// Query words in registers: the superkey (4 or 8 words), or at 512 bits
// its fold onto 4 words, word l the OR of lanes l, l + 4, l + 8, l + 12 (a
// query can be contained in a row only if its fold is contained in the
// row's).  At 512 bits the full queries sit in shared memory, 20 words each,
// so a warp's 16-byte reads at one query index fall on distinct banks.
template <int LANES>
struct Fold {
  static constexpr int kReg = LANES == 16 ? 4 : LANES;
  static constexpr bool kFull = LANES > kReg;  // the registers hold a fold
  static constexpr int kQPitch = kFull ? LANES + 4 : 0;
};

// Blocks per SM: 4 for the counts at 128 bits (64 registers; shared memory
// allows 4 at the table cap); 2 at 256 bits (64 registers of query words),
// at 512 (60 KB of shared memory) and for the match matrix (64 registers
// would spill)
template <int LANES, bool HAS_ELIG, bool ALIGNED, int OP>
__global__ void __launch_bounds__(kThreads, LANES == 4 && OP < kMatch ? 4 : 2) counts_kernel(Args a) {
  constexpr bool GATHER = OP == kGather, ANY = OP == kAny;
  constexpr bool MATCH = OP == kMatch || OP == kMatchOdd, ODD = OP == kMatchOdd;
  constexpr bool TABLES = OP == kGather || OP == kSum || OP == kAny;  // reads table ids
  constexpr bool KEYS = OP == kSum || OP == kAny || OP == kKeys;
  constexpr int kReg = Fold<LANES>::kReg, kQPitch = Fold<LANES>::kQPitch;
  constexpr bool kFull = Fold<LANES>::kFull;
  constexpr int kPitch = LANES + 4;  // words per staged row, its fold last: 16-byte aligned, skewed banks
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_rows = smem;                                 // [2][kChunk][kPitch]
  uint32_t* s_q = s_rows + 2 * kChunk * kPitch;            // [kQpt][32][kQPitch]
  uint8_t* s_out = reinterpret_cast<uint8_t*>(s_q + kTile * kQPitch);  // B.4: [kWarps][kStageBytes]
  int* s_seg = reinterpret_cast<int*>(s_out + (MATCH && a.staged ? kWarps * kStageBytes : 0));
  int* s_counts = s_seg + (TABLES ? 2 * kChunk : 0);       // s_seg: [2][kChunk]; this: [n_tables]
  int* s_keys = s_counts + (TABLES ? a.n_tables : 0);      // [kTile] (B.1, B.5)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lanes = a.lanes;
  const int q0 = blockIdx.y * kTile, qn = min(kTile, a.n_queries - q0);
  int G = 1, lg = 0;  // threads per row
  while (G * kQpt < qn) G <<= 1, ++lg;
  const int t = lane & (G - 1), slot = lane >> lg, R = 32 >> lg;
  const int jb = t * kQpt;  // this thread's first query in the tile
  const int nvalid = max(0, min(kQpt, qn - jb));
  const uint32_t valid = (1u << nvalid) - 1u;

  uint32_t qf[kQpt][kReg] = {};  // the owned queries (their folds at 512 bits)
#pragma unroll
  for (int k = 0; k < kQpt; ++k)
#pragma unroll
    for (int l = 0; l < LANES; ++l)
      if (k < nvalid && l < lanes) qf[k][l % kReg] |= __ldg(a.query + (size_t)(q0 + jb + k) * lanes + l);
  uint32_t zero_q = 0u;  // owned all-zero queries: every row holds them, no full test needed
#pragma unroll
  for (int k = 0; k < kQpt; ++k)
    if (kFull && !(qf[k][0] | qf[k][1] | qf[k][2] | qf[k][3])) zero_q |= 1u << k;
  for (int e = tid; e < (kFull ? LANES * kTile : 0); e += kThreads) {  // query j = 8 t + k at [k][t]
    const int j = e / LANES, l = e % LANES;
    s_q[((j % kQpt) * 32 + j / kQpt) * kQPitch + l] =
        (j < qn && l < lanes) ? a.query[(size_t)(q0 + j) * lanes + l] : 0u;
  }
  if (TABLES)
    for (int i = tid; i < a.n_tables; i += kThreads) s_counts[i] = 0;
  if (KEYS)
    for (int j = tid; j < kTile; j += kThreads) s_keys[j] = 0;

  // B.1, B.5: hits of the owned queries since the last flush, a byte each
  // (queries 0-3 in kb[0], 4-7 in kb[1]).  A thread tests G <= 32 rows of a
  // chunk (one per step s < G), so a byte gains at most 32 a chunk however
  // many rows hit (every row, for an all-zero query), and 7 chunks stay
  // below 256 (7 x 32 = 224)
  constexpr int kFlushChunks = 7;
  uint32_t kb[2] = {0u, 0u};
  auto flush_keys = [&]() {
#pragma unroll
    for (int k = 0; k < kQpt; ++k) {
      const int v = (int)((kb[k >> 2] >> (8 * (k & 3))) & 0xffu);
      if (v) atomicAdd(s_keys + jb + k, v);
    }
    kb[0] = kb[1] = 0u;
  };

  // B.4: a warp writes its rows out W at a time: 16 rows, or all 32 when a
  // step of kUnroll rows per thread covers them (G <= 4, q <= 32);
  // W x q <= kStageBytes.  The windows start at multiples of 16 rows.
  const int W = max(16, min(G, kUnroll) * R);
  auto put = [&](uint32_t al, int lr, long long i) {  // row i < n, the warp's row lr
    const uint2 b = mask_bytes(al);
    if (!ODD) {  // q % 8 == 0: this thread's 8 bytes are one aligned 8-byte word
      if (nvalid) *reinterpret_cast<uint2*>(a.out + i * a.n_queries + q0 + jb) = b;
      return;
    }
    uint8_t* p = a.staged ? s_out + warp * kStageBytes + (lr & (W - 1)) * a.n_queries + jb
                          : reinterpret_cast<uint8_t*>(a.out) + i * a.n_queries + q0 + jb;
#pragma unroll
    for (int k = 0; k < kQpt; ++k)
      if (k < nvalid) p[k] = (uint8_t)((k < 4 ? b.x : b.y) >> (8 * (k & 3)));
  };
  auto flush_out = [&](long long row0) {  // rows [row0, row0 + W): one span, 16-byte aligned
    __syncwarp();
    const long long rows = min((long long)W, a.n - row0);
    if (rows > 0) {
      const int bytes = (int)rows * a.n_queries;
      const uint8_t* src = s_out + warp * kStageBytes;
      int8_t* dst = a.out + row0 * a.n_queries;
      for (int v = lane; v < bytes >> 4; v += 32)
        __stcs(reinterpret_cast<int4*>(dst) + v, reinterpret_cast<const int4*>(src)[v]);
      for (int b = (bytes & ~15) + lane; b < bytes; b += 32) dst[b] = (int8_t)src[b];
    }
    __syncwarp();
  };

  const long long n_chunks = (a.n + kChunk - 1) / kChunk;
  auto row_of = [&](long long c) -> int {  // B.2: the store row of this thread's candidate
    const long long i = c * kChunk + tid;
    return (GATHER && c < n_chunks && i < a.n) ? __ldg(a.rows + i) : 0;
  };
  auto stage = [&](long long c, int buf, int r) {  // copy chunk c into buffer buf
    const long long i = c * kChunk + tid;
    if (c < n_chunks && i < a.n) {
      const uint32_t* src = a.rows_sk + (size_t)(GATHER ? (long long)r : i) * a.row_stride;
      uint32_t* dst = s_rows + (buf * kChunk + tid) * kPitch;
      if (a.vec16) {
#pragma unroll
        for (int c4 = 0; c4 < LANES / 4; ++c4)
          if (c4 * 4 < lanes) cp_async16(dst + c4 * 4, src + c4 * 4);
      } else {
#pragma unroll
        for (int l = 0; l < LANES; ++l)
          if (l < lanes) cp_async4(dst + l, src + l);
      }
      if (TABLES) cp_async4(s_seg + buf * kChunk + tid, a.seg + i);
    } else if (TABLES) {
      s_seg[buf * kChunk + tid] = -1;
    }
    cp_async_commit();
  };
  // this thread's 8 elig bytes of row i: raw aligned words, loaded before
  // they are used; rows that are not 8-byte aligned take a second word
  auto elig_load = [&](long long i, uint64_t& lo, uint64_t& hi) {
    const int8_t* e = a.elig + i * a.elig_stride + q0 + jb;
    if (ALIGNED) {
      lo = __ldg(reinterpret_cast<const unsigned long long*>(e));
      return;
    }
    const int sh = (int)(reinterpret_cast<uintptr_t>(e) & 7);
    const unsigned long long* wp = reinterpret_cast<const unsigned long long*>(e - sh);
    lo = __ldg(wp);
    if (sh && 8 - sh < nvalid) hi = __ldg(wp + 1);  // only when it holds one of this thread's queries
  };
  auto elig_bits = [&](long long i, uint64_t lo, uint64_t hi) -> uint32_t {
    if (!ALIGNED) {
      const int sh = (int)((reinterpret_cast<uintptr_t>(a.elig) + i * a.elig_stride + q0 + jb) & 7);
      if (sh) lo = (lo >> (8 * sh)) | (hi << (64 - 8 * sh));
    }
    return repro::nonzero_bytes(lo);
  };

  long long c = blockIdx.x;
  stage(c, 0, row_of(c));
  int r_next = row_of(c + gridDim.x);
  for (int it = 0; c < n_chunks; c += gridDim.x, ++it) {
    const int buf = it & 1;
    stage(c + gridDim.x, buf ^ 1, r_next);
    r_next = row_of(c + 2 * (long long)gridDim.x);
    cp_async_wait_prev();
    if (kFull) {  // fold this thread's own row of chunk c into its spare words
      uint32_t* own = s_rows + (buf * kChunk + tid) * kPitch;
      uint32_t f[4] = {};
#pragma unroll
      for (int l = 0; l < LANES; ++l)
        if (l < lanes) f[l & 3] |= own[l];
      *reinterpret_cast<uint4*>(own + LANES) = make_uint4(f[0], f[1], f[2], f[3]);
    }
    __syncthreads();  // chunk c (and its folds) is in shared memory

    const int* segs = s_seg + buf * kChunk;
    const uint32_t* rws = s_rows + buf * kChunk * kPitch;
    const int n_in = (int)min((long long)kChunk, a.n - c * kChunk);  // real rows of chunk c
    // a row counts when it is real and, with table ids, not padding
    auto live = [&](int r) { return TABLES ? segs[r] >= 0 : r < n_in; };
    // each warp: its 32 rows, R at a time; the elig loads of kUnroll rows
    // are all issued before any of them is tested
    for (int s0 = 0; s0 < G; s0 += kUnroll) {
      uint64_t e_lo[kUnroll], e_hi[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = warp * 32 + (s0 + u) * R + slot;
        e_lo[u] = e_hi[u] = 0;
        if (HAS_ELIG && s0 + u < G && valid && live(r)) elig_load(c * kChunk + r, e_lo[u], e_hi[u]);
      }
      uint32_t al[kUnroll];
      int sg[kUnroll];  // table ids (0 without them); -1: past n, padding, or a step past G
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = warp * 32 + (s0 + u) * R + slot;
        sg[u] = s0 + u < G && live(r) ? (TABLES ? segs[r] : 0) : -1;
        al[u] = sg[u] >= 0 ? valid : 0u;
        if (HAS_ELIG && al[u]) al[u] &= elig_bits(c * kChunk + r, e_lo[u], e_hi[u]);
      }
      // row u of the step; without elig, steps past G test row s0 again, with
      // nothing alive (with elig their test stops before it reads the row)
      auto row_words = [&](int u) {
        return rws + (warp * 32 + (HAS_ELIG || s0 + u < G ? s0 + u : s0) * R + slot) * kPitch;
      };
      // the words in registers, 4 at a time, stopping when nothing is alive
      auto test = [&](int u) {
        const uint32_t* rp = row_words(u) + (kFull ? LANES : 0);
#pragma unroll
        for (int l4 = 0; l4 < kReg / 4; ++l4) {
          if ((HAS_ELIG || l4 > 0) && al[u] == 0u) break;
          const uint4 w = *reinterpret_cast<const uint4*>(rp + 4 * l4);
          const uint32_t nw[4] = {~w.x, ~w.y, ~w.z, ~w.w};
#pragma unroll
          for (int k = 0; k < kQpt; ++k) {
            const uint32_t miss = (qf[k][4 * l4] & nw[0]) | (qf[k][4 * l4 + 1] & nw[1]) |
                                  (qf[k][4 * l4 + 2] & nw[2]) | (qf[k][4 * l4 + 3] & nw[3]);
            if (miss) al[u] &= ~(1u << k);
          }
        }
      };
      // 512 bits: every lane, for the pairs that passed the fold, one query
      // alive in the warp at a time (warp-collective)
      auto full_test = [&](int u) {
        const uint32_t* rp = row_words(u);
        for (uint32_t any = __reduce_or_sync(0xffffffffu, al[u] & ~zero_q); any; any &= any - 1) {
          const int k = __ffs(any) - 1;
          if (!((al[u] & ~zero_q) >> k & 1u)) continue;
          const uint32_t* qs = s_q + (k * 32 + t) * kQPitch;
#pragma unroll
          for (int l4 = 0; l4 < LANES / 4; ++l4) {
            if (4 * l4 >= lanes) break;
            const uint4 w = *reinterpret_cast<const uint4*>(rp + 4 * l4);
            const uint4 qw = *reinterpret_cast<const uint4*>(qs + 4 * l4);
            if ((qw.x & ~w.x) | (qw.y & ~w.y) | (qw.z & ~w.z) | (qw.w & ~w.w)) {
              al[u] &= ~(1u << k);
              break;
            }
          }
        }
      };
      auto emit = [&](int u) {  // row u's outputs (warp-collective)
        const int r = warp * 32 + (s0 + u) * R + slot;
        if (MATCH && sg[u] >= 0) put(al[u], (s0 + u) * R + slot, c * kChunk + r);
        if (KEYS) {  // one byte per owned query
          const uint2 b = mask_bytes(al[u]);
          kb[0] += b.x;
          kb[1] += b.y;
        }
        if (TABLES) {
          int hits = __popc(al[u]);
          if (G == 32) {
            hits = (int)__reduce_add_sync(0xffffffffu, (unsigned)hits);
          } else {
            for (int off = G >> 1; off > 0; off >>= 1) hits += __shfl_xor_sync(0xffffffffu, hits, off);
          }
          if (t == 0 && hits > 0) {
            if (ANY && a.row_hit != nullptr)
              a.row_hit[c * kChunk + r] = 1;  // the other tiles' blocks may mark it too
            else if (sg[u] < a.n_tables)
              atomicAdd(s_counts + sg[u], ANY ? 1 : hits);
          }
        }
      };
      if (HAS_ELIG) {  // the test branches on elig anyway: each row in turn
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          test(u);
          if (kFull) full_test(u);
          emit(u);
        }
      } else {  // every live row takes the first test, without a branch: the rows interleave
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) test(u);
        if (kFull) {
          uint32_t step_any = 0u;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) step_any |= al[u] & ~zero_q;
          if (__any_sync(0xffffffffu, step_any != 0u))
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) full_test(u);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) emit(u);
      }
      if (ODD && a.staged) {  // W more of the warp's rows are staged: write them out
        const int done = min(s0 + kUnroll, G) * R;
        if (done % W == 0) flush_out(c * kChunk + warp * 32 + done - W);
      }
    }
    if (KEYS && it % kFlushChunks == kFlushChunks - 1) flush_keys();
    __syncthreads();  // buffer buf is free for the chunk after next
  }
  if (KEYS) flush_keys();
  __syncthreads();
  if (TABLES)
    for (int i = tid; i < a.n_tables; i += kThreads) {
      const int v = s_counts[i];
      if (v) atomicAdd(a.counts + i, v);
    }
  if (KEYS)
    for (int j = tid; j < qn; j += kThreads) {
      const int v = s_keys[j];
      if (v) atomicAdd(a.key_counts + q0 + j, v);
    }
}

// 'any' over several query tiles: counts[seg[i]] += 1 for each marked row
__global__ void __launch_bounds__(kThreads)
marked_rows_to_tables(const uint8_t* __restrict__ row_hit, const int32_t* __restrict__ seg,
                      long long n, int n_tables, int32_t* __restrict__ counts) {
  extern __shared__ int s_hist[];  // [n_tables]
  for (int i = threadIdx.x; i < n_tables; i += kThreads) s_hist[i] = 0;
  __syncthreads();
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    if (row_hit[i]) {
      const int s = seg[i];
      if (s >= 0 && s < n_tables) atomicAdd(s_hist + s, 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_tables; i += kThreads) {
    const int v = s_hist[i];
    if (v) atomicAdd(counts + i, v);
  }
}

template <int LANES, bool HAS_ELIG, bool ALIGNED, int OP>
cudaError_t launch(const Args& a, cudaStream_t s) {
  constexpr bool TABLES = OP == kGather || OP == kSum || OP == kAny;
  constexpr bool KEYS = OP == kSum || OP == kAny || OP == kKeys;
  auto kernel = counts_kernel<LANES, HAS_ELIG, ALIGNED, OP>;
  const int tiles = (a.n_queries + kTile - 1) / kTile;
  if (tiles > 65535) return cudaErrorInvalidValue;  // grid.y walks the query tiles
  Args b = a;
  b.staged = OP == kMatchOdd && tiles == 1;
  if (OP != kAny || tiles == 1) b.row_hit = nullptr;  // one tile sees every query of a row
  const size_t smem = (size_t)2 * kChunk * (LANES + 4) * sizeof(uint32_t) +
                      (size_t)kTile * Fold<LANES>::kQPitch * sizeof(uint32_t) +
                      (b.staged ? (size_t)kWarps * kStageBytes : 0) +
                      (size_t)((TABLES ? 2 * kChunk + a.n_tables : 0) + (KEYS ? kTile : 0)) * sizeof(int);
  // per instantiation, the shared memory granted so far and the occupancy
  // at the last size asked: these host calls would add microseconds to
  // every launch, where the main path's launches take tens
  static size_t granted = 0, occ_smem = 0;
  static int per_sm = 0;
  cudaError_t err;
  if (smem > granted) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    granted = smem;
  }
  if (smem != occ_smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    occ_smem = smem;
  }
  const long long chunks = (a.n + kChunk - 1) / kChunk;
  long long cap = (long long)(per_sm < 1 ? 1 : per_sm) * repro::sm_count() / tiles;
  if (cap < 1) cap = 1;
  const dim3 grid((unsigned)(chunks < cap ? chunks : cap), tiles);
  kernel<<<grid, kThreads, smem, s>>>(b);
  err = cudaGetLastError();
  if (err != cudaSuccess || b.row_hit == nullptr) return err;
  const long long blocks = (a.n + kThreads - 1) / kThreads;
  const long long cap2 = 4LL * repro::sm_count();
  marked_rows_to_tables<<<(int)(blocks < cap2 ? blocks : cap2), kThreads,
                          (size_t)a.n_tables * sizeof(int), s>>>(b.row_hit, a.seg, a.n,
                                                                 a.n_tables, a.counts);
  return cudaGetLastError();
}

template <int LANES, int OP>
cudaError_t dispatch_elig(const Args& a, cudaStream_t s) {
  if constexpr (OP == kKeys || OP == kMatch || OP == kMatchOdd) {
    return launch<LANES, false, true, OP>(a, s);
  } else {
    if (a.elig == nullptr) return launch<LANES, false, true, OP>(a, s);
    const bool aligned = (reinterpret_cast<uintptr_t>(a.elig) & 7) == 0 && a.elig_stride % 8 == 0;
    return aligned ? launch<LANES, true, true, OP>(a, s) : launch<LANES, true, false, OP>(a, s);
  }
}

template <int OP>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  if (a.lanes <= 4) return dispatch_elig<4, OP>(a, s);
  if (a.lanes <= 8) return dispatch_elig<8, OP>(a, s);
  return dispatch_elig<16, OP>(a, s);
}

// host-gathered rows int32[n, row_stride] and queries int32[>= n_queries, lanes]
Args rows_args(const void* rows_sk, int row_stride, int lanes, const void* query, int n_queries,
               long long n) {
  Args a{};
  a.rows_sk = static_cast<const uint32_t*>(rows_sk);
  a.row_stride = row_stride;
  a.lanes = lanes;
  a.query = static_cast<const uint32_t*>(query);
  a.n_queries = n_queries;
  a.n = n;
  a.vec16 = lanes % 4 == 0 && row_stride % 4 == 0 && (reinterpret_cast<uintptr_t>(rows_sk) & 15) == 0;
  return a;
}

}  // namespace

// B.1. rows_sk: int32[n, row_stride] rows, lanes <= row_stride; query:
// int32[>= n_queries, lanes]; elig: int8[n, elig_stride] or NULL; seg:
// int32[n]; counts: int32[n_tables] and key_counts: int32[>= n_queries],
// zeroed by the caller — the kernel adds into them; row_hit: uint8[n],
// zeroed, needed in 'any' mode (used when n_queries > 256).
REPRO_API int filter_counts_launch(const void* rows_sk, int row_stride, int lanes, const void* query,
                                   int n_queries, const void* elig, long long elig_stride,
                                   const void* seg, long long n, int n_tables, void* counts,
                                   void* key_counts, int any_mode, void* row_hit, void* stream) {
  if (n <= 0 || n_queries <= 0 || n_tables <= 0) return 0;
  if (lanes < 1 || lanes > repro::kMaxLanes || lanes > row_stride || key_counts == nullptr ||
      (any_mode && row_hit == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a = rows_args(rows_sk, row_stride, lanes, query, n_queries, n);
  a.elig = static_cast<const int8_t*>(elig);
  a.elig_stride = elig_stride;
  a.seg = static_cast<const int32_t*>(seg);
  a.n_tables = n_tables;
  a.counts = static_cast<int32_t*>(counts);
  a.key_counts = static_cast<int32_t*>(key_counts);
  a.row_hit = static_cast<uint8_t*>(row_hit);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(any_mode ? dispatch<kAny>(a, s) : dispatch<kSum>(a, s));
}

// B.2. store: int32[N, row_stride]; rows: int32[n] offsets into it; query:
// int32[>= n_queries, lanes] with 1 <= lanes <= row_stride (a lane prefix
// of the store); elig: int8[n, elig_stride] or NULL; seg: int32[n];
// counts: int32[n_tables], zeroed by the caller — the kernel adds into it.
// Rows are copied in 16-byte groups when lanes and row_stride are
// multiples of 4 and the store is 16-byte aligned, else word by word.
REPRO_API int gather_counts_launch(const void* store, int row_stride, int lanes, const void* rows,
                                   const void* query, int n_queries, const void* elig,
                                   long long elig_stride, const void* seg, long long n,
                                   int n_tables, void* counts, void* stream) {
  if (n <= 0 || n_queries <= 0 || n_tables <= 0) return 0;
  if (lanes < 1 || lanes > repro::kMaxLanes || lanes > row_stride) return (int)cudaErrorInvalidValue;
  Args a = rows_args(store, row_stride, lanes, query, n_queries, n);
  a.rows = static_cast<const int32_t*>(rows);
  a.elig = static_cast<const int8_t*>(elig);
  a.elig_stride = elig_stride;
  a.seg = static_cast<const int32_t*>(seg);
  a.n_tables = n_tables;
  a.counts = static_cast<int32_t*>(counts);
  return (int)dispatch<kGather>(a, static_cast<cudaStream_t>(stream));
}

// B.4. rows_sk: int32[n, lanes]; query: int32[n_queries, lanes]; out:
// int8[n, n_queries], 16-byte aligned; every byte is written, 0 or 1.
REPRO_API int filter_match_launch(const void* rows_sk, int lanes, const void* query,
                                  int n_queries, long long n, void* out, void* stream) {
  if (n <= 0 || n_queries <= 0) return 0;
  if (lanes < 1 || lanes > repro::kMaxLanes || (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  Args a = rows_args(rows_sk, lanes, lanes, query, n_queries, n);
  a.out = static_cast<int8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(n_queries % 8 ? dispatch<kMatchOdd>(a, s) : dispatch<kMatch>(a, s));
}

// B.5. rows_sk: int32[n, lanes]; query: int32[n_queries, lanes]; counts:
// int32[n_queries], zeroed by the caller — the kernel adds into it.
REPRO_API int filter_count_launch(const void* rows_sk, int lanes, const void* query,
                                  int n_queries, long long n, void* counts, void* stream) {
  if (n <= 0 || n_queries <= 0) return 0;
  if (lanes < 1 || lanes > repro::kMaxLanes) return (int)cudaErrorInvalidValue;
  Args a = rows_args(rows_sk, lanes, lanes, query, n_queries, n);
  a.key_counts = static_cast<int32_t*>(counts);
  return (int)dispatch<kKeys>(a, static_cast<cudaStream_t>(stream));
}
