// Gather-fused §6.3 filter + per-table counts (ROADMAP B.2), hand-written for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/filter_kernel.py : gather_filter_table_counts
// (_gather_counts_kernel).  counts[seg[i]] += #{ j < n_queries :
// elig[i, j] && (query[j, l] & ~store[rows[i], l]) == 0 for l < lanes } for
// every candidate row i with seg[i] >= 0; the candidate rows are read in
// place from the device-resident superkey store, only its first `lanes`
// words (lanes < store width is the serving tier's lane-prefix degrade).
// The n x q match matrix never exists.
//
// What bounds it on this card: bytes, mostly the n x q int8 eligibility
// stream (256 MB at n = 2^20, q = 256); then one 32-byte sector per
// gathered row, its offset and its table id.  The tests are a few integer
// operations per live (row, query) pair.
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
//     thread gathers one row's lanes into shared memory with 16-byte
//     cp.async (and its table id with a 4-byte one), double-buffered, so the
//     next chunk's gathers are in flight while this chunk is tested; the row
//     offsets are loaded one chunk further ahead.  (TMA cannot gather
//     scattered rows.)
//   * Small q (tens of keys per discover): a row needs only ceil(q / 8)
//     threads, so a warp packs 32 / G rows (G the power of two >= that), and
//     no lane idles.
//   * Counts: hits per thread by __popc, per row by __reduce_add_sync (or a
//     butterfly within the G threads), one shared-memory atomicAdd per row
//     into the block's int32[n_tables] histogram, flushed to the global
//     counts once per block.  Integer atomics commute: the counts are
//     bit-identical from run to run.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;   // candidate rows per block step, one gathered per thread
constexpr int kQpt = 8;       // queries per thread
constexpr int kTile = 256;    // queries per tile: 32 threads x 8
constexpr int kUnroll = 4;    // rows whose elig loads a warp keeps in flight

struct Args {
  const uint32_t* store;
  int row_stride, lanes;
  const int32_t* rows;
  const uint32_t* query;
  int n_queries;
  const int8_t* elig;
  long long elig_stride;
  const int32_t* seg;
  long long n;
  int n_tables;
  int32_t* counts;
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

// bit k set iff byte k of w is nonzero
__device__ __forceinline__ uint32_t nonzero_bytes(uint64_t w) {
  w |= w >> 4;
  w |= w >> 2;
  w |= w >> 1;
  w &= 0x0101010101010101ull;
  return (uint32_t)((w * 0x0102040810204080ull) >> 56);
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
template <int LANES, bool HAS_ELIG, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, LANES == 4 ? 4 : 2) gather_counts_kernel(Args a) {
  constexpr int kReg = Split<LANES>::kReg, kTail = Split<LANES>::kTail;
  constexpr int kTailPitch = Split<LANES>::kTailPitch;
  constexpr int kPitch = LANES + 4;  // words per staged row: 16-byte aligned, skewed banks
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_rows = smem;                                 // [2][kChunk][kPitch]
  uint32_t* s_q = s_rows + 2 * kChunk * kPitch;            // [kQpt][32][kTailPitch]
  int* s_seg = reinterpret_cast<int*>(s_q + kTile * kTailPitch);  // [2][kChunk]
  int* s_counts = s_seg + 2 * kChunk;                      // [n_tables]

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

  const long long n_chunks = (a.n + kChunk - 1) / kChunk;
  auto row_of = [&](long long c) -> int {
    const long long i = c * kChunk + tid;
    return (c < n_chunks && i < a.n) ? __ldg(a.rows + i) : 0;
  };
  auto stage = [&](long long c, int buf, int r) {  // gather chunk c into buffer buf
    const long long i = c * kChunk + tid;
    if (c < n_chunks && i < a.n) {
      const uint32_t* src = a.store + (size_t)r * a.row_stride;
      uint32_t* dst = s_rows + (buf * kChunk + tid) * kPitch;
#pragma unroll
      for (int c4 = 0; c4 < LANES / 4; ++c4)
        if (c4 * 4 < lanes) cp_async16(dst + c4 * 4, src + c4 * 4);
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
    return nonzero_bytes(lo);
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
        int hits = __popc(al);
        if (G == 32) {
          hits = (int)__reduce_add_sync(0xffffffffu, (unsigned)hits);
        } else {
          for (int off = G >> 1; off > 0; off >>= 1) hits += __shfl_xor_sync(0xffffffffu, hits, off);
        }
        if (t == 0 && hits > 0 && sg[u] < a.n_tables) atomicAdd(s_counts + sg[u], hits);
      }
    }
    __syncthreads();  // buffer buf is free for the chunk after next
  }
  __syncthreads();
  for (int i = tid; i < a.n_tables; i += kThreads) {
    const int v = s_counts[i];
    if (v) atomicAdd(a.counts + i, v);
  }
}

template <int LANES, bool HAS_ELIG, bool ALIGNED>
cudaError_t launch(const Args& a, cudaStream_t s) {
  auto kernel = gather_counts_kernel<LANES, HAS_ELIG, ALIGNED>;
  const size_t smem = (size_t)2 * kChunk * (LANES + 4) * sizeof(uint32_t) +
                      (size_t)kTile * Split<LANES>::kTailPitch * sizeof(uint32_t) +
                      (size_t)(2 * kChunk + a.n_tables) * sizeof(int);
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
  kernel<<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int LANES>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  if (a.elig == nullptr) return launch<LANES, false, true>(a, s);
  const bool aligned = (reinterpret_cast<uintptr_t>(a.elig) & 7) == 0 && a.elig_stride % 8 == 0;
  return aligned ? launch<LANES, true, true>(a, s) : launch<LANES, true, false>(a, s);
}

}  // namespace

// store: int32[N, row_stride] (16-byte aligned, row_stride a multiple of 4);
// rows: int32[n] offsets into it; query: int32[>= n_queries, lanes] with
// lanes in {4, 8, 12, 16}, lanes <= row_stride; elig: int8[n, elig_stride]
// or NULL; seg: int32[n]; counts: int32[n_tables], zeroed by the caller —
// the kernel adds into it.
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
         elig_stride, static_cast<const int32_t*>(seg), n, n_tables, static_cast<int32_t*>(counts)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes <= 4) return (int)dispatch<4>(a, s);
  if (lanes <= 8) return (int)dispatch<8>(a, s);
  return (int)dispatch<16>(a, s);
}
