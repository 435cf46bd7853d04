// Fused §6.3 row filter + per-table counts, hand-written for Hopper (sm_90a):
// ROADMAP B.1 and B.2, one templated body.
//
// Replaces: src/repro/kernels/filter_kernel.py : filter_table_counts
// (_table_counts_kernel, B.1: candidate rows host-gathered as int32[n, lanes];
// per-table counts, 'sum' or 'any', and per-key counts) and
// gather_filter_table_counts (_gather_counts_kernel, B.2: the candidate rows
// read in place from the device-resident superkey store at int32 offsets,
// only its first `lanes` words, which is the serving tier's lane-prefix
// degrade; 'sum' counts only).
// Per (row i, query j): (q_j & ~r_i) == 0 on every probed lane, AND
// elig[i, j] (when given), AND j < n_queries, AND seg[i] >= 0.  'sum' counts
// every such pair into counts[seg[i]]; 'any' counts each row with at least
// one; B.1 also counts each pair into key_counts[j].  The n x q match matrix
// never exists.
//
// What bounds it on this card: bytes, mostly the n x q int8 eligibility
// stream (256 MB at n = 2^20, q = 256); then the rows (B.1: 16..64 B each;
// B.2: one 32-byte sector per gathered row, its offset) and the table ids.
// The tests are a few integer operations per live (row, query) pair, but a
// warp instruction tests 32 threads' queries at once, so the kernel is in
// practice bound by instruction issue (PERF.md).
//
// What the design does about it:
//   * Eligibility first.  Each thread owns 8 consecutive queries of a
//     256-query tile for the whole launch (grid.y walks the tiles) and reads
//     their 8 elig bytes of a row as one 8-byte load, so a warp reads a row's
//     256 bytes coalesced; the nonzero bytes give an 8-bit alive mask, and
//     ineligible pairs cost no test.  Rows whose elig is not 8-byte aligned
//     (q not a multiple of 8) are read as two aligned words and shifted.  A
//     warp issues the elig loads of 4 rows before it tests any of them.
//   * Queries held per thread.  The owned queries' first 4 lanes (128 bits)
//     or 8 lanes (256 and 512 bits) sit in registers and are tested 4 lanes
//     at a time against the row's words (one 16-byte shared-memory broadcast
//     per row), stopping when the alive mask is 0.  At 512 bits, lanes 8-15
//     sit in shared memory, 12 words per query, and are read as 16-byte
//     vectors (conflict-free across the warp) only for pairs still alive,
//     walking the queries alive anywhere in the warp.
//   * Rows in flight.  A block takes chunks of 256 candidate rows: each
//     thread copies one row's lanes into shared memory with 16-byte
//     cp.async (4-byte copies for B.1 rows whose width is not a multiple of
//     4 words) and its table id with a 4-byte one, double-buffered, so the
//     next chunk's copies are in flight while this chunk is tested.  B.1's
//     rows are contiguous, so a warp's copies are coalesced; B.2 gathers, and
//     loads its row offsets one chunk further ahead.  (TMA cannot gather
//     scattered rows.)
//   * Small q (tens of keys per discover): a row needs only ceil(q / 8)
//     threads, so a warp packs 32 / G rows (G the power of two >= that), and
//     no lane idles.
//   * Table counts: hits per thread by __popc, per row by __reduce_add_sync
//     (or a butterfly within the G threads), one shared-memory atomicAdd per
//     row into the block's int32[n_tables] histogram, flushed to the global
//     counts once per block.  'any' over one tile adds 1 per row with a hit;
//     over several tiles (q > 256, whose tiles run in different blocks) each
//     block marks its rows' hits in a byte per row, and a second small
//     kernel scatters the marked rows into the table counts.
//   * Key counts (B.1): each thread counts its owned queries' hits in
//     registers, a byte per query in two words (a row's 8-bit hit mask is
//     spread to bytes by two multiplies; a row without a hit costs a branch),
//     so the 64-register bound that keeps 4 blocks per SM at 128 bits holds.
//     Every 7 chunks, before a byte can overflow, the bytes go to a
//     per-block int32[256] shared histogram, which is added to key_counts
//     once per block: one global atomic per (block, query), not one per
//     hit, where 256 queries' hits would contend for 256 addresses.
//   Integer atomics commute: every count is bit-identical from run to run.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;   // candidate rows per block step, one copied per thread
constexpr int kQpt = 8;       // queries per thread
constexpr int kTile = 256;    // queries per tile: 32 threads x 8
constexpr int kUnroll = 4;    // rows whose elig loads a warp keeps in flight

struct Args {
  const uint32_t* rows_sk;  // GATHER: the store [N, row_stride]; else the rows [n, row_stride]
  int row_stride, lanes;
  const int32_t* rows;      // GATHER: int32[n] offsets into the store
  const uint32_t* query;
  int n_queries;
  const int8_t* elig;
  long long elig_stride;
  const int32_t* seg;
  long long n;
  int n_tables;
  int32_t* counts;
  int32_t* key_counts;  // B.1: int32[>= n_queries]
  uint8_t* row_hit;     // 'any' over several tiles: uint8[n], zeroed
  bool vec16;           // rows copied in 16-byte groups
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

// Lanes of the owned queries held in registers (4 or 8); the rest (lanes
// 8-15 at 512 bits) sit in shared memory, 12 words per query: a warp's
// 16-byte reads at one query index are 48 bytes apart, on distinct banks.
template <int LANES>
struct Split {
  static constexpr int kReg = LANES < 8 ? LANES : 8;
  static constexpr int kTail = LANES - kReg;
  static constexpr int kTailPitch = kTail ? kTail + 4 : 0;
};

// 4 blocks per SM at 128 bits (64 registers; shared memory allows 4 at the
// table cap), 2 at 256 and 512 bits (their query lanes take 64 registers)
template <int LANES, bool HAS_ELIG, bool ALIGNED, bool GATHER, bool ANY>
__global__ void __launch_bounds__(kThreads, LANES == 4 ? 4 : 2) counts_kernel(Args a) {
  constexpr bool KEYS = !GATHER;
  constexpr int kReg = Split<LANES>::kReg, kTail = Split<LANES>::kTail;
  constexpr int kTailPitch = Split<LANES>::kTailPitch;
  constexpr int kPitch = LANES + 4;  // words per staged row: 16-byte aligned, skewed banks
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_rows = smem;                                 // [2][kChunk][kPitch]
  uint32_t* s_q = s_rows + 2 * kChunk * kPitch;            // [kQpt][32][kTailPitch]
  int* s_seg = reinterpret_cast<int*>(s_q + kTile * kTailPitch);  // [2][kChunk]
  int* s_counts = s_seg + 2 * kChunk;                      // [n_tables]
  int* s_keys = s_counts + a.n_tables;                     // [kTile] (B.1)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lanes = a.lanes;
  const int q0 = blockIdx.y * kTile, qn = min(kTile, a.n_queries - q0);
  int G = 1, lg = 0;  // threads per row
  while (G * kQpt < qn) G <<= 1, ++lg;
  const int t = lane & (G - 1), slot = lane >> lg, R = 32 >> lg;
  const int jb = t * kQpt;  // this thread's first query in the tile
  const int nvalid = max(0, min(kQpt, qn - jb));
  const uint32_t valid = (1u << nvalid) - 1u;

  uint32_t qr[kQpt][kReg];
#pragma unroll
  for (int k = 0; k < kQpt; ++k)
#pragma unroll
    for (int l = 0; l < kReg; ++l)
      qr[k][l] = (k < nvalid && l < lanes) ? __ldg(a.query + (size_t)(q0 + jb + k) * lanes + l) : 0u;
  for (int e = tid; e < kTail * kTile; e += kThreads) {  // query j = 8 t + k at [k][t]
    const int j = e / (kTail ? kTail : 1), l = kReg + e % (kTail ? kTail : 1);
    s_q[((j % kQpt) * 32 + j / kQpt) * kTailPitch + l - kReg] =
        (j < qn && l < lanes) ? a.query[(size_t)(q0 + j) * lanes + l] : 0u;
  }
  for (int i = tid; i < a.n_tables; i += kThreads) s_counts[i] = 0;
  if (KEYS)
    for (int j = tid; j < kTile; j += kThreads) s_keys[j] = 0;

  // B.1: hits of the owned queries since the last flush, a byte each
  // (queries 0-3 in kb[0], 4-7 in kb[1]); a thread tests at most 32 rows a
  // chunk, so 7 chunks stay below 256
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
      if (GATHER || a.vec16) {
#pragma unroll
        for (int c4 = 0; c4 < LANES / 4; ++c4)
          if (c4 * 4 < lanes) cp_async16(dst + c4 * 4, src + c4 * 4);
      } else {
#pragma unroll
        for (int l = 0; l < LANES; ++l)
          if (l < lanes) cp_async4(dst + l, src + l);
      }
      cp_async4(s_seg + buf * kChunk + tid, a.seg + i);
    } else {
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
    __syncthreads();  // chunk c is in shared memory

    const int* segs = s_seg + buf * kChunk;
    const uint32_t* rws = s_rows + buf * kChunk * kPitch;
    // each warp: its 32 rows, R at a time; the elig loads of kUnroll rows
    // are all issued before any of them is tested
    for (int s0 = 0; s0 < G; s0 += kUnroll) {
      uint64_t e_lo[kUnroll], e_hi[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = warp * 32 + (s0 + u) * R + slot;
        e_lo[u] = e_hi[u] = 0;
        if (HAS_ELIG && s0 + u < G && valid && segs[r] >= 0) elig_load(c * kChunk + r, e_lo[u], e_hi[u]);
      }
      uint32_t alive[kUnroll];
      int sg[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = warp * 32 + (s0 + u) * R + slot;
        sg[u] = s0 + u < G ? segs[r] : -1;
        alive[u] = sg[u] >= 0 ? valid : 0u;
        if (HAS_ELIG && alive[u]) alive[u] &= elig_bits(c * kChunk + r, e_lo[u], e_hi[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = warp * 32 + (s0 + u) * R + slot;
        uint32_t al = alive[u];
        const uint32_t* rp = rws + r * kPitch;
#pragma unroll
        for (int l4 = 0; l4 < kReg / 4; ++l4) {  // lanes in registers, 4 at a time
          if (al == 0u) break;
          const uint4 w = *reinterpret_cast<const uint4*>(rp + 4 * l4);
          const uint32_t nw[4] = {~w.x, ~w.y, ~w.z, ~w.w};
#pragma unroll
          for (int k = 0; k < kQpt; ++k) {
            const uint32_t miss = (qr[k][4 * l4] & nw[0]) | (qr[k][4 * l4 + 1] & nw[1]) |
                                  (qr[k][4 * l4 + 2] & nw[2]) | (qr[k][4 * l4 + 3] & nw[3]);
            if (miss) al &= ~(1u << k);
          }
        }
        if (kTail > 0) {  // the other lanes, for the queries still alive anywhere in the warp
          for (uint32_t any = __reduce_or_sync(0xffffffffu, al); any; any &= any - 1) {
            const int k = __ffs(any) - 1;
            if (!((al >> k) & 1u)) continue;
            const uint32_t* qs = s_q + (k * 32 + t) * kTailPitch;
#pragma unroll
            for (int l4 = 0; l4 < kTail / 4; ++l4) {
              if (kReg + 4 * l4 >= lanes) break;
              const uint4 w = *reinterpret_cast<const uint4*>(rp + kReg + 4 * l4);
              const uint4 qw = *reinterpret_cast<const uint4*>(qs + 4 * l4);
              if ((qw.x & ~w.x) | (qw.y & ~w.y) | (qw.z & ~w.z) | (qw.w & ~w.w)) {
                al &= ~(1u << k);
                break;
              }
            }
          }
        }
        if (KEYS && al) {  // spread each nibble's 4 bits to 4 bytes and add
          kb[0] += ((al & 0xfu) * 0x00204081u) & 0x01010101u;
          kb[1] += ((al >> 4) * 0x00204081u) & 0x01010101u;
        }
        int hits = __popc(al);
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
    }
    if (KEYS && it % kFlushChunks == kFlushChunks - 1) flush_keys();
    __syncthreads();  // buffer buf is free for the chunk after next
  }
  if (KEYS) flush_keys();
  __syncthreads();
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

template <int LANES, bool HAS_ELIG, bool ALIGNED, bool GATHER, bool ANY>
cudaError_t launch(const Args& a, cudaStream_t s) {
  auto kernel = counts_kernel<LANES, HAS_ELIG, ALIGNED, GATHER, ANY>;
  const size_t smem = (size_t)2 * kChunk * (LANES + 4) * sizeof(uint32_t) +
                      (size_t)kTile * Split<LANES>::kTailPitch * sizeof(uint32_t) +
                      (size_t)(2 * kChunk + a.n_tables + (GATHER ? 0 : kTile)) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (a.n_queries + kTile - 1) / kTile;
  const long long chunks = (a.n + kChunk - 1) / kChunk;
  long long cap = (long long)(per_sm < 1 ? 1 : per_sm) * repro::sm_count() / tiles;
  if (cap < 1) cap = 1;
  const dim3 grid((unsigned)(chunks < cap ? chunks : cap), tiles);
  Args b = a;
  if (!ANY || tiles == 1) b.row_hit = nullptr;  // one tile sees every query of a row
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

template <int LANES, bool GATHER, bool ANY>
cudaError_t dispatch_elig(const Args& a, cudaStream_t s) {
  if (a.elig == nullptr) return launch<LANES, false, true, GATHER, ANY>(a, s);
  const bool aligned = (reinterpret_cast<uintptr_t>(a.elig) & 7) == 0 && a.elig_stride % 8 == 0;
  return aligned ? launch<LANES, true, true, GATHER, ANY>(a, s)
                 : launch<LANES, true, false, GATHER, ANY>(a, s);
}

template <bool GATHER, bool ANY>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  if (a.lanes <= 4) return dispatch_elig<4, GATHER, ANY>(a, s);
  if (a.lanes <= 8) return dispatch_elig<8, GATHER, ANY>(a, s);
  return dispatch_elig<16, GATHER, ANY>(a, s);
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
  const bool vec16 = lanes % 4 == 0 && row_stride % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(rows_sk) & 15) == 0;
  Args a{static_cast<const uint32_t*>(rows_sk), row_stride, lanes, nullptr,
         static_cast<const uint32_t*>(query), n_queries, static_cast<const int8_t*>(elig),
         elig_stride, static_cast<const int32_t*>(seg), n, n_tables, static_cast<int32_t*>(counts),
         static_cast<int32_t*>(key_counts), static_cast<uint8_t*>(row_hit), vec16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(any_mode ? dispatch<false, true>(a, s) : dispatch<false, false>(a, s));
}

// B.2. store: int32[N, row_stride] (16-byte aligned, row_stride a multiple
// of 4); rows: int32[n] offsets into it; query: int32[>= n_queries, lanes]
// with lanes in {4, 8, 12, 16}, lanes <= row_stride; elig: int8[n,
// elig_stride] or NULL; seg: int32[n]; counts: int32[n_tables], zeroed by
// the caller — the kernel adds into it.
REPRO_API int gather_counts_launch(const void* store, int row_stride, int lanes, const void* rows,
                                   const void* query, int n_queries, const void* elig,
                                   long long elig_stride, const void* seg, long long n,
                                   int n_tables, void* counts, void* stream) {
  if (n <= 0 || n_queries <= 0 || n_tables <= 0) return 0;
  if (lanes < 4 || lanes > repro::kMaxLanes || lanes % 4 || row_stride % 4 || lanes > row_stride ||
      (reinterpret_cast<uintptr_t>(store) & 15))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const uint32_t*>(store), row_stride, lanes, static_cast<const int32_t*>(rows),
         static_cast<const uint32_t*>(query), n_queries, static_cast<const int8_t*>(elig),
         elig_stride, static_cast<const int32_t*>(seg), n, n_tables, static_cast<int32_t*>(counts),
         nullptr, nullptr, true};
  return (int)dispatch<true, false>(a, static_cast<cudaStream_t>(stream));
}
