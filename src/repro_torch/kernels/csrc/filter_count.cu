// §6.3 per-query filter count (ROADMAP B.5), hand-written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/filter_kernel.py : filter_count (_count_kernel).
// counts[j] = #{ rows i : (q_j & ~r_i) == 0 on every lane }, int32[q].  There
// is no padding (the kernel masks its ragged edges), so the reference
// wrapper's zero-query correction has nothing to correct: an all-zero query
// counts every row, as the reference returns.
//
// What bounds it on this card: bytes.  Each row superkey (16..64 B) is read
// once; the queries (a few KB) and the q int32 counts are noise beside it.
// The subsumption tests are a few integer ops per (row, query, lane).
// What the design does about it: the grid walks row chunks (x) and query
// tiles of 256 (y).  A block stages its query tile in shared memory
// transposed [lane][query]; each warp takes 32 consecutive rows, one per
// thread (a coalesced read of 32 whole superkeys, kept inverted in
// registers), and for each query reads the query's lanes as one shared-
// memory broadcast.  The warp's hits for a query are one ballot + popc,
// added to a shared-memory int32 counter by one thread; each block adds its
// nonzero counters to the global counts once, at the end.  No global atomic
// per hit.  Integer adds commute: the counts are bit-identical run to run.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQueryTile = 256;

template <int MAXL>
__global__ void __launch_bounds__(kThreads)
filter_count_kernel(const uint32_t* __restrict__ rows_sk, int lanes,
                    const uint32_t* __restrict__ query, int n_queries, long long n,
                    int32_t* __restrict__ counts) {
  __shared__ uint32_t s_q[MAXL * kQueryTile];  // [lane][query]
  __shared__ int s_cnt[kQueryTile];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.y * kQueryTile;
  const int qn = min(kQueryTile, n_queries - q0);
  for (int e = tid; e < qn * lanes; e += kThreads) {
    const int j = e / lanes, l = e - j * lanes;
    s_q[l * kQueryTile + j] = query[(size_t)(q0 + j) * lanes + l];
  }
  for (int j = tid; j < kQueryTile; j += kThreads) s_cnt[j] = 0;
  __syncthreads();

  for (long long base = ((long long)blockIdx.x * kWarps + warp) * 32; base < n;
       base += (long long)gridDim.x * kWarps * 32) {
    const long long i = base + lane;
    const bool real = i < n;
    uint32_t nr[MAXL];  // inverted row lanes
#pragma unroll
    for (int l = 0; l < MAXL; ++l)
      nr[l] = (real && l < lanes) ? ~__ldg(rows_sk + (size_t)i * lanes + l) : 0u;
    for (int j = 0; j < qn; ++j) {
      bool ok = real;
#pragma unroll
      for (int l = 0; l < MAXL; ++l)
        if (l < lanes) ok = ok && ((s_q[l * kQueryTile + j] & nr[l]) == 0u);
      const unsigned hits = __ballot_sync(0xffffffffu, ok);
      if (lane == 0 && hits) atomicAdd(s_cnt + j, __popc(hits));
    }
  }
  __syncthreads();
  for (int j = tid; j < qn; j += kThreads) {
    const int v = s_cnt[j];
    if (v) atomicAdd(counts + q0 + j, v);
  }
}

template <int MAXL>
cudaError_t launch(const uint32_t* rows, int lanes, const uint32_t* query, int n_queries,
                   long long n, int32_t* counts, cudaStream_t s) {
  auto kernel = filter_count_kernel<MAXL>;
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  const int q_tiles = (n_queries + kQueryTile - 1) / kQueryTile;
  const long long chunks = (n + kThreads - 1) / kThreads;
  long long cap = (long long)per_sm * repro::sm_count() / q_tiles;
  if (cap < 1) cap = 1;
  const dim3 grid((unsigned)(chunks < cap ? chunks : cap), q_tiles);
  kernel<<<grid, kThreads, 0, s>>>(rows, lanes, query, n_queries, n, counts);
  return cudaGetLastError();
}

}  // namespace

// rows_sk: int32[n, lanes]; query: int32[n_queries, lanes]; counts:
// int32[n_queries], zeroed by the caller — the kernel adds into it.
REPRO_API int filter_count_launch(const void* rows_sk, int lanes, const void* query,
                                  int n_queries, long long n, void* counts, void* stream) {
  if (n <= 0 || n_queries <= 0) return 0;
  if (lanes < 1 || lanes > repro::kMaxLanes || n_queries > 65535 * kQueryTile)
    return (int)cudaErrorInvalidValue;
  const uint32_t* r = static_cast<const uint32_t*>(rows_sk);
  const uint32_t* q = static_cast<const uint32_t*>(query);
  int32_t* c = static_cast<int32_t*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (lanes <= 4)
    err = launch<4>(r, lanes, q, n_queries, n, c, s);
  else if (lanes <= 8)
    err = launch<8>(r, lanes, q, n_queries, n, c, s);
  else
    err = launch<16>(r, lanes, q, n_queries, n, c, s);
  return (int)err;
}
