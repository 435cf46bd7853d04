// Fused §6.3 row filter + per-table counts (ROADMAP B.1), hand-written for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/filter_kernel.py : filter_table_counts
// (_table_counts_kernel).  Candidate-row superkeys come host-gathered as
// int32[n, lanes]; outputs per-table counts ('sum': eligible (row, key)
// hits, or 'any': rows with >= 1 hit) and per-key counts.  (The gather
// variant, B.2, has its own kernel: gather_counts.cu.)
//
// Per (row i, query j): (q_j & ~r_i) == 0 on every probed lane, AND elig[i,j]
// (when given), AND j < n_queries, AND seg[i] >= 0.  The n x q match matrix
// never exists in device memory.
//
// What bounds it on this card: bytes.  Per candidate row it reads one
// superkey (16..64 B), its int32 table id and its q elig bytes; the elig matrix
// dominates at q = 256.  The subsumption tests are a few integer ops per
// (row, query) pair and mostly stop at the first lane.
// What the design does about it: one WARP per row, its 32 threads striding
// over the queries, so the elig row is read as coalesced 32-byte runs and
// the row's lanes as one broadcast load; the query tile (256 queries) sits in
// shared memory transposed [lane][query], so a warp reads 32 consecutive
// words (no bank conflicts); the per-row hit count is a warp-shuffle sum;
// rows accumulate into a shared-memory int32[n_tables] histogram
// (<= 32 KB at the 8192-table cap) with shared atomics, and each block adds
// its nonzero entries to the global counts once at the end.  Integer atomics
// commute, so the counts are bit-identical from run to run.  'any' mode sees
// every query tile of a row before the row's 0/1 is scattered.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerChunk = 64;  // rows a block carries across all query tiles
constexpr int kQueryTile = 256;    // queries staged in shared memory at a time

template <int MAXL, bool HAS_ELIG, bool ANY>
__global__ void __launch_bounds__(kThreads)
filter_counts_kernel(const uint32_t* __restrict__ rows_sk, int row_stride, int lanes,
                     const uint32_t* __restrict__ query, int n_queries,
                     const int8_t* __restrict__ elig, int elig_stride,
                     const int32_t* __restrict__ seg, long long n, int n_tables,
                     int32_t* __restrict__ counts, int32_t* __restrict__ key_counts) {
  extern __shared__ int smem[];
  int* s_counts = smem;                   // [n_tables]
  int* s_row = s_counts + n_tables;       // [kRowsPerChunk]
  uint32_t* s_q = reinterpret_cast<uint32_t*>(s_row + kRowsPerChunk);  // [lanes][kQueryTile]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int t = tid; t < n_tables; t += kThreads) s_counts[t] = 0;
  const int n_tiles = (n_queries + kQueryTile - 1) / kQueryTile;
  bool staged = false;  // with one tile, it is staged once for all chunks

  for (long long base = (long long)blockIdx.x * kRowsPerChunk; base < n;
       base += (long long)gridDim.x * kRowsPerChunk) {
    for (int r = tid; r < kRowsPerChunk; r += kThreads) s_row[r] = 0;
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int q0 = tile * kQueryTile;
      const int qn = min(kQueryTile, n_queries - q0);
      if (n_tiles > 1 || !staged) {
        __syncthreads();  // the previous tile is consumed
        for (int e = tid; e < qn * lanes; e += kThreads) {
          const int j = e / lanes, l = e - j * lanes;
          s_q[l * kQueryTile + j] = query[(size_t)(q0 + j) * lanes + l];
        }
        staged = true;
      }
      __syncthreads();  // tile and row accumulators are visible

      for (int r = warp; r < kRowsPerChunk; r += kWarps) {
        const long long i = base + r;
        if (i >= n) break;  // warp-uniform
        if (seg[i] < 0) continue;  // padding rows count nothing
        const uint32_t* rp = rows_sk + (size_t)i * row_stride;
        uint32_t rr[MAXL];
#pragma unroll
        for (int l = 0; l < MAXL; ++l) rr[l] = (l < lanes) ? __ldg(rp + l) : 0u;
        const int8_t* er = HAS_ELIG ? elig + (size_t)i * elig_stride + q0 : nullptr;
        int hits = 0;
        for (int jj = lane; jj < qn; jj += 32) {
          bool ok = !HAS_ELIG || er[jj] != 0;
#pragma unroll
          for (int l = 0; l < MAXL; ++l)
            if (l < lanes) ok = ok && ((s_q[l * kQueryTile + jj] & ~rr[l]) == 0u);
          if (ok) {
            ++hits;
            if (key_counts != nullptr) atomicAdd(key_counts + q0 + jj, 1);
          }
        }
        hits = repro::warp_sum(hits);
        if (lane == 0 && hits) s_row[r] = ANY ? 1 : s_row[r] + hits;
      }
    }
    __syncthreads();  // every tile of this chunk is counted
    for (int r = tid; r < kRowsPerChunk; r += kThreads) {
      const long long i = base + r;
      if (i < n && s_row[r]) {
        const int s = seg[i];
        if (s >= 0 && s < n_tables) atomicAdd(s_counts + s, s_row[r]);
      }
    }
  }
  __syncthreads();
  for (int t = tid; t < n_tables; t += kThreads) {
    const int v = s_counts[t];
    if (v) atomicAdd(counts + t, v);
  }
}

struct Args {
  const uint32_t* rows_sk;
  int row_stride, lanes;
  const uint32_t* query;
  int n_queries;
  const int8_t* elig;
  int elig_stride;
  const int32_t* seg;
  long long n;
  int n_tables;
  int32_t* counts;
  int32_t* key_counts;
};

template <int MAXL, bool HAS_ELIG, bool ANY>
cudaError_t launch(const Args& a, cudaStream_t s) {
  auto kernel = filter_counts_kernel<MAXL, HAS_ELIG, ANY>;
  const size_t smem = (size_t)(a.n_tables + kRowsPerChunk) * sizeof(int) +
                      (size_t)a.lanes * kQueryTile * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  const long long chunks = (a.n + kRowsPerChunk - 1) / kRowsPerChunk;
  const long long cap = (long long)per_sm * repro::sm_count();
  const int grid = (int)(chunks < cap ? chunks : cap);
  kernel<<<grid, kThreads, smem, s>>>(a.rows_sk, a.row_stride, a.lanes, a.query,
                                      a.n_queries, a.elig, a.elig_stride, a.seg, a.n,
                                      a.n_tables, a.counts, a.key_counts);
  return cudaGetLastError();
}

template <int MAXL>
cudaError_t dispatch(const Args& a, bool any_mode, cudaStream_t s) {
  if (a.elig != nullptr)
    return any_mode ? launch<MAXL, true, true>(a, s) : launch<MAXL, true, false>(a, s);
  return any_mode ? launch<MAXL, false, true>(a, s) : launch<MAXL, false, false>(a, s);
}

}  // namespace

// rows_sk: int32[n, row_stride] rows; query: int32[>= n_queries, lanes];
// elig: int8[n, elig_stride] or NULL; seg: int32[n]; counts: int32[n_tables] and key_counts: int32[n_queries]
// (or NULL) must be zeroed by the caller — the kernel adds into them.
REPRO_API int filter_counts_launch(const void* rows_sk, int row_stride, int lanes,
                                   const void* query, int n_queries, const void* elig, int elig_stride, const void* seg,
                                   long long n, int n_tables, void* counts, void* key_counts,
                                   int any_mode, void* stream) {
  if (n <= 0 || n_queries <= 0 || n_tables <= 0) return 0;
  if (lanes < 1 || lanes > repro::kMaxLanes || lanes > row_stride)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const uint32_t*>(rows_sk), row_stride, lanes,
         static_cast<const uint32_t*>(query), n_queries, static_cast<const int8_t*>(elig), elig_stride, static_cast<const int32_t*>(seg), n,
         n_tables, static_cast<int32_t*>(counts), static_cast<int32_t*>(key_counts)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (lanes <= 4)
    err = dispatch<4>(a, any_mode != 0, s);
  else if (lanes <= 8)
    err = dispatch<8>(a, any_mode != 0, s);
  else
    err = dispatch<16>(a, any_mode != 0, s);
  return (int)err;
}
