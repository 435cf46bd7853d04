// §6.3 subsumption match matrix (ROADMAP B.4), hand-written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/filter_kernel.py : filter_match (_match_kernel).
// out[i, j] = 1 iff (q_j & ~r_i) == 0 on every lane, as int8[n, q] — the
// composed 'pallas' backend's matrix, and the target the group launch of
// discover_many demotes to above the 8192-table cap.
//
// What bounds it on this card: bytes.  The n x q int8 output is written once
// and dominates (q = 256 bytes per row against one 16..64-byte row read).
// What the design does about it: one thread per (row, query) element over a
// flat grid-stride index, so consecutive threads write consecutive bytes of
// one output row (coalesced stores) and share that row's lanes (one
// broadcast load per warp); the queries, a few KB, stay in L1/L2.  The
// element index is split with 32-bit division when n*q < 2^31.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int MAXL, typename Index>
__global__ void __launch_bounds__(kThreads)
filter_match_kernel(const uint32_t* __restrict__ rows_sk, int lanes,
                    const uint32_t* __restrict__ query, int n_queries, Index total,
                    int8_t* __restrict__ out) {
  const Index q = (Index)n_queries;
  for (Index e = (Index)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (Index)gridDim.x * kThreads) {
    const Index i = e / q;
    const Index j = e - i * q;
    const uint32_t* rp = rows_sk + (size_t)i * lanes;
    const uint32_t* qp = query + (size_t)j * lanes;
    bool ok = true;
#pragma unroll
    for (int l = 0; l < MAXL; ++l)
      if (l < lanes) ok = ok && ((__ldg(qp + l) & ~__ldg(rp + l)) == 0u);
    out[e] = ok ? 1 : 0;
  }
}

template <int MAXL>
void launch(const uint32_t* rows, int lanes, const uint32_t* query, int n_queries,
            long long total, int8_t* out, cudaStream_t s) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  const long long cap = (long long)repro::sm_count() * 16;
  const int grid = (int)(blocks < cap ? blocks : cap);
  if (total < (1ll << 31))
    filter_match_kernel<MAXL, unsigned int>
        <<<grid, kThreads, 0, s>>>(rows, lanes, query, n_queries, (unsigned int)total, out);
  else
    filter_match_kernel<MAXL, unsigned long long><<<grid, kThreads, 0, s>>>(
        rows, lanes, query, n_queries, (unsigned long long)total, out);
}

}  // namespace

// rows_sk: int32[n, lanes]; query: int32[n_queries, lanes]; out: int8[n, n_queries].
REPRO_API int filter_match_launch(const void* rows_sk, int lanes, const void* query,
                                  int n_queries, long long n, void* out, void* stream) {
  if (n <= 0 || n_queries <= 0) return 0;
  if (lanes < 1 || lanes > repro::kMaxLanes) return (int)cudaErrorInvalidValue;
  const uint32_t* r = static_cast<const uint32_t*>(rows_sk);
  const uint32_t* q = static_cast<const uint32_t*>(query);
  int8_t* o = static_cast<int8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = n * (long long)n_queries;
  if (lanes <= 4)
    launch<4>(r, lanes, q, n_queries, total, o, s);
  else if (lanes <= 8)
    launch<8>(r, lanes, q, n_queries, total, o, s);
  else
    launch<16>(r, lanes, q, n_queries, total, o, s);
  return (int)cudaGetLastError();
}
