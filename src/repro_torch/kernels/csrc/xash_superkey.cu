// XASH + superkey per row (ROADMAP B.3), hand-written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/xash_kernel.py : xash_superkey
//           (_superkey_kernel and _cell_bits), and stands in for the XLA
//           core/xash.py : xash / superkey on the port's build and query path.
// Computes what repro_torch/core/xash.py computes (its plain version): per
// cell, the 37-char occurrence counts and 1-based position sums; the
// n_char_bits present chars with the smallest count*64+rank; for each a
// location bit x = ceil(sum*c / (count*len)) rotated left by the length;
// plus a length bit; cells OR-ed into the row's 32-bit lanes.  Unlike the
// Pallas kernel it honours the use_location / use_rotation / use_length
// ablation flags.
//
// What bounds it on this card: integer and shared-memory instructions, not
// bytes.  A cell is max_len (48) bytes read once and a row writes 16..64
// bytes, but each cell costs one branchy pass over its characters plus
// n_char_bits scans of its present characters.
// What the design does about it: one thread per row (no cross-thread
// reduction at all); the per-char counters live in shared memory laid out
// [char][thread] so a warp's accesses hit 32 distinct banks; counters are
// zeroed lazily at a char's first occurrence (a 64-bit presence mask), and
// the selection scans only the set bits of that mask, never all 37 chars;
// the lanes stay in registers (the lane count is a template parameter).
// The encoded values are read as uint8 directly, not widened to int32.

#include "common.cuh"

#include <cstring>

namespace {

constexpr int kAlphabet = 37;
constexpr int kBlock = 128;
constexpr int kBig = 1 << 24;

struct Params {
  int rank[kAlphabet];
  int n_cols, max_len, lanes, c, region, lseg, n_char_bits;
  int use_location, use_rotation, use_length;
};

template <int MAXL>
__device__ __forceinline__ void set_bit(uint32_t (&acc)[MAXL], int b) {
  const int word = b >> 5;
  const uint32_t mask = 1u << (b & 31);
#pragma unroll
  for (int l = 0; l < MAXL; ++l) acc[l] |= (word == l) ? mask : 0u;
}

template <int MAXL>
__global__ void __launch_bounds__(kBlock)
xash_superkey_kernel(const uint8_t* __restrict__ enc, int32_t* __restrict__ out,
                     long long n, Params p) {
  __shared__ int s_cnt[kAlphabet * kBlock];
  __shared__ int s_sum[kAlphabet * kBlock];
  __shared__ int s_rank[kAlphabet];
  const int t = threadIdx.x;
  if (t < kAlphabet) s_rank[t] = p.rank[t];
  __syncthreads();

  for (long long row = (long long)blockIdx.x * kBlock + t; row < n;
       row += (long long)gridDim.x * kBlock) {
    uint32_t acc[MAXL];
#pragma unroll
    for (int l = 0; l < MAXL; ++l) acc[l] = 0u;
    const uint8_t* cell = enc + (size_t)row * p.n_cols * p.max_len;
    for (int col = 0; col < p.n_cols; ++col, cell += p.max_len) {
      uint64_t present = 0;
      int lv = 0;
      for (int pos = 0; pos < p.max_len; ++pos) {
        const int code = cell[pos];
        if (code == 0) continue;
        ++lv;
        if (code > kAlphabet) continue;  // outside the alphabet: length only
        const int a = code - 1;
        const uint64_t bit = 1ull << a;
        if (!(present & bit)) {
          present |= bit;
          s_cnt[a * kBlock + t] = 0;
          s_sum[a * kBlock + t] = 0;
        }
        s_cnt[a * kBlock + t] += 1;
        s_sum[a * kBlock + t] += pos + 1;
      }
      if (lv == 0) continue;  // an empty value sets nothing

      uint64_t avail = present;
      for (int pick = 0; pick < p.n_char_bits && avail; ++pick) {
        // smallest count*64+rank among the chars not chosen yet; ascending
        // char order with a strict '<' keeps the lowest id on a tie
        int best = kBig, bid = 0;
        for (uint64_t m = avail; m; m &= m - 1) {
          const int a = __ffsll((long long)m) - 1;
          const int score = s_cnt[a * kBlock + t] * 64 + s_rank[a];
          if (score < best) {
            best = score;
            bid = a;
          }
        }
        avail &= ~(1ull << bid);
        int x = 1;
        if (p.use_location) {
          // ceil(sum*c / (count*len)) for positive operands
          const int num = s_sum[bid * kBlock + t] * p.c;
          const int den = s_cnt[bid * kBlock + t] * lv;
          x = (num + den - 1) / den;
          x = min(max(x, 1), p.c);
        }
        int q = bid * p.c + (x - 1);
        if (p.use_rotation) q = ((q - lv) % p.region + p.region) % p.region;
        set_bit<MAXL>(acc, p.lseg + q);
      }
      if (p.use_length) set_bit<MAXL>(acc, lv % p.lseg);
    }
    int32_t* o = out + (size_t)row * p.lanes;
#pragma unroll
    for (int l = 0; l < MAXL; ++l)
      if (l < p.lanes) o[l] = (int32_t)acc[l];
  }
}

}  // namespace

// enc: uint8[n, n_cols, max_len] on the device; out: int32[n, lanes];
// rank_host: int32[37] in host memory (copied into the launch parameters).
REPRO_API int xash_superkey_launch(const void* enc, void* out, const void* rank_host,
                                   long long n, int n_cols, int max_len, int lanes,
                                   int c, int region, int lseg, int n_char_bits,
                                   int use_location, int use_rotation, int use_length,
                                   void* stream) {
  if (n <= 0) return 0;
  if (lanes < 1 || lanes > repro::kMaxLanes || n_char_bits > kAlphabet || max_len > 1024)
    return (int)cudaErrorInvalidValue;
  Params p;
  std::memcpy(p.rank, rank_host, sizeof(p.rank));
  p.n_cols = n_cols;
  p.max_len = max_len;
  p.lanes = lanes;
  p.c = c;
  p.region = region;
  p.lseg = lseg;
  p.n_char_bits = n_char_bits;
  p.use_location = use_location;
  p.use_rotation = use_rotation;
  p.use_length = use_length;
  const long long blocks = (n + kBlock - 1) / kBlock;
  const int grid = (int)(blocks < (long long)repro::sm_count() * 8 ? blocks
                                                                  : (long long)repro::sm_count() * 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* e = static_cast<const uint8_t*>(enc);
  int32_t* o = static_cast<int32_t*>(out);
  if (lanes <= 4)
    xash_superkey_kernel<4><<<grid, kBlock, 0, s>>>(e, o, n, p);
  else if (lanes <= 8)
    xash_superkey_kernel<8><<<grid, kBlock, 0, s>>>(e, o, n, p);
  else
    xash_superkey_kernel<16><<<grid, kBlock, 0, s>>>(e, o, n, p);
  return (int)cudaGetLastError();
}
