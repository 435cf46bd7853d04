// XASH + superkey per row (ROADMAP B.3), hand-written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/xash_kernel.py : xash_superkey
//           (_superkey_kernel and _cell_bits), and stands in for the XLA
//           core/xash.py : xash / superkey on the port's build and query path.
// Computes what repro_torch/core/xash.py computes (its plain version): per
// cell, the 37-char occurrence counts and 1-based position sums; the
// n_char_bits present chars with the smallest count*64+rank (lowest id first
// on a tie); for each a location bit x = ceil(sum*c / (count*len)), clamped
// to [1, c], rotated left by the length; plus a length bit; cells OR-ed into
// the row's 32-bit lanes.  A code above 37 adds to the length only; an empty
// cell sets nothing.  Unlike the Pallas kernel it honours the use_location /
// use_rotation / use_length ablation flags.
//
// What bounds it on this card: instructions, not bytes.  A cell is max_len
// (48) bytes read once and a row writes 16..64 bytes (0.080 ms for 2^22
// values at 128 bits), but every character costs a read-modify-write of its
// counter and every present character a step of the selection; a warp runs
// each loop as often as its longest cell needs.
// What the design does about it (the fast path: cells of 16..64 bytes,
// 16-byte aligned, n_char_bits <= 5, which is every session's layout: 48
// bytes, 5/4/3 char bits at 128/256/512 bits under the default n_unique):
//   * A cell is three 16-byte vector loads (a byte at a time took 48 load
//     instructions); a warp's loads cover whole 128-byte lines between them,
//     so every byte fetched is used.  The next cell's loads are issued as soon
//     as this cell is counted, so they fly during its selection.
//   * Counting walks the cell's nonzero 32-bit words only (the padding costs
//     one compare a word), each byte's character predicated, with static
//     positions; the length is a popcount of the nonzero bytes.
//   * One packed 32-bit counter per (char, thread) in shared memory, laid out
//     [char][thread] so a warp's accesses hit 32 distinct banks: the count,
//     the char's rank and id, and the position sum in one word (148 bytes a
//     thread), so a character is one read-modify-write, and the words of two
//     chars compare as their selection keys.
//   * One pass over the present characters reads each word once, resets it
//     for the next cell, and keeps the n_char_bits smallest sorted in
//     registers (a min/max insertion chain); the chosen words carry their
//     counts and sums, so the bits need no further reads.  The location bit
//     is found by comparisons, not a division.
//   * The lanes stay in registers (the lane count is a template parameter).
//     A launch of a few rows (a query's keys) gets one block of as many warps
//     as it has rows, not a grid sized for millions.
// The general path (other widths and alignments, more char bits) keeps a
// count and a 20-bit position sum per counter word and scans the present
// characters once per pick.

#include "common.cuh"

#include <cstring>

namespace {

constexpr int kAlphabet = 37;
constexpr int kBlock = 256;    // threads per block (fewer for small launches)
constexpr int kMaxPick = 5;    // n_char_bits selected in registers (the fast path)
constexpr int kFastLen = 64;   // longest cell of the fast path
constexpr int kMaxLen = 1024;  // longest cell: the general path's counter fields hold it

struct Params {
  int rank[kAlphabet];
  int n_cols, max_len, lanes, c, region, lseg, n_char_bits;
  int use_location, use_rotation, use_length;
  bool vec_out;  // out is 16-byte aligned
};

template <int MAXL>
__device__ __forceinline__ void set_bit(uint32_t (&acc)[MAXL], int b) {
  const int word = b >> 5;
  const uint32_t mask = 1u << (b & 31);
#pragma unroll
  for (int l = 0; l < MAXL; ++l) acc[l] |= (word == l) ? mask : 0u;
}

// v mod m for the small v of a cell length (a loop beats a division there)
__device__ __forceinline__ int mod_small(int v, int m) {
  while (v >= m) v -= m;
  return v;
}

// global bit of char a chosen in a cell of length lv (lv_rot = lv mod region)
__device__ __forceinline__ int char_bit(int a, int count, int sum, int lv, int lv_rot,
                                        const Params& p) {
  int x = 1;
  if (p.use_location) {
    // x = min(ceil(sum*c / (count*len)), c) = 1 + #{k in [1, c) : sum*c > k*count*len}
    const int num = sum * p.c, den = count * lv;
#pragma unroll 1
    for (int k = 1, kd = den; k < p.c; ++k, kd += den) x += num > kd;
  }
  int q = a * p.c + (x - 1);
  if (p.use_rotation) {
    q -= lv_rot;
    if (q < 0) q += p.region;
  }
  return p.lseg + q;
}

// ---------------------------------------------------------------------------
// The fast path: cells of 16..64 bytes, 16-byte aligned, n_char_bits <= 5.
// ---------------------------------------------------------------------------

// One thread's counters, one word per char at a * stride of its column:
// count in bits 24..30, rank in 18..23, char in 12..17, position sum in
// 0..11 (count <= 64, sum <= 64 * 65 / 2 = 2,080).  Compared as integers,
// the words of two chars order as count*64+rank, then char: the selection
// key, with the sum carried along.  Row 37 takes the bytes that are not
// characters (padding, codes above 37), so counting needs no branch.
constexpr int kCounterWords = 1;  // shared words per (char, thread)
struct PackedCounters {
  uint32_t* s;
  int stride;
  __device__ __forceinline__ void init(int a, int rank) { s[a * stride] = rank << 18 | a << 12; }
  __device__ __forceinline__ void add(int a, int pos) { s[a * stride] += (1u << 24) + pos; }
  // the char's word, and its counter reset for the next cell
  __device__ __forceinline__ uint32_t take(int a) {
    const uint32_t v = s[a * stride];
    s[a * stride] = v & 0x00fff000u;
    return v;
  }
};  // PackedCounters

// 16 bytes at a 16-byte aligned address, in one load
__device__ __forceinline__ uint4 load16(const uint8_t* src) {
  return __ldg(reinterpret_cast<const uint4*>(src));
}

// the row's lanes: 16-byte stores when the lane count is the template's
template <int MAXL>
__device__ __forceinline__ void store_lanes(int32_t* o, const uint32_t (&acc)[MAXL], const Params& p) {
  const int lanes = p.lanes;
  if (lanes == MAXL && p.vec_out) {
#pragma unroll
    for (int l = 0; l < MAXL; l += 4)
      *reinterpret_cast<uint4*>(o + l) = make_uint4(acc[l], acc[l + 1], acc[l + 2], acc[l + 3]);
    return;
  }
#pragma unroll
  for (int l = 0; l < MAXL; ++l)
    if (l < lanes) o[l] = (int32_t)acc[l];
}

template <int MAXL>
__global__ void __launch_bounds__(kBlock)
xash_fast_kernel(const uint8_t* __restrict__ enc, int32_t* __restrict__ out, long long n, Params p) {
  extern __shared__ uint32_t s_cnt[];  // [kCounterWords * 38][blockDim.x]
  const int t = threadIdx.x, nt = blockDim.x;
  PackedCounters cnt{s_cnt + t, nt};
  for (int a = 0; a < kAlphabet; ++a) cnt.init(a, p.rank[a]);  // own column: no barrier

  const int chunks = p.max_len / 16;
  const long long row_bytes = (long long)p.n_cols * p.max_len;
  const long long step = (long long)gridDim.x * nt;
  auto load_cell = [&](const uint8_t* cell, uint4 (&w)[kFastLen / 16]) {
#pragma unroll
    for (int k = 0; k < kFastLen / 16; ++k) w[k] = k < chunks ? load16(cell + 16 * k) : make_uint4(0, 0, 0, 0);
  };
  uint4 w[kFastLen / 16];
  long long row = (long long)blockIdx.x * nt + t;
  if (row < n && p.n_cols > 0) load_cell(enc + row * row_bytes, w);

  for (; row < n; row += step) {
    uint32_t acc[MAXL];
#pragma unroll
    for (int l = 0; l < MAXL; ++l) acc[l] = 0u;
    for (int col = 0; col < p.n_cols; ++col) {
      // count: the nonzero words of the cell; a byte that is no character
      // goes to row 37, which nothing reads
      uint64_t present = 0;
      int lv = 0;
#pragma unroll
      for (int i = 0; i < kFastLen / 4; ++i) {
        const uint4& c4 = w[i / 4];
        const uint32_t word = i % 4 == 0 ? c4.x : i % 4 == 1 ? c4.y : i % 4 == 2 ? c4.z : c4.w;
        if (word == 0u) continue;
        lv += __popc((((word & 0x7f7f7f7fu) + 0x7f7f7f7fu) | word) & 0x80808080u);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int a = (int)min(((word >> (8 * j)) & 0xffu) - 1u, (uint32_t)kAlphabet);
          present |= 1ull << a;
          cnt.add(a, 4 * i + j + 1);
        }
      }
      present &= (1ull << kAlphabet) - 1;
      // the next cell's loads fly while this one is selected
      if (col + 1 < p.n_cols)
        load_cell(enc + row * row_bytes + (long long)(col + 1) * p.max_len, w);
      else if (row + step < n)
        load_cell(enc + (row + step) * row_bytes, w);
      if (lv == 0) continue;  // an empty value sets nothing

      // the n_char_bits smallest words, ascending; counters reset on the way
      uint32_t best[kMaxPick];
#pragma unroll
      for (int i = 0; i < kMaxPick; ++i) best[i] = 0xffffffffu;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        for (uint32_t m = (uint32_t)(present >> (32 * half)); m; m &= m - 1) {
          uint32_t v = cnt.take(32 * half + __ffs(m) - 1);
#pragma unroll
          for (int i = 0; i < kMaxPick; ++i) {
            const uint32_t lo = min(v, best[i]);
            v = max(v, best[i]);
            best[i] = lo;
          }
        }
      }
      const int lv_rot = mod_small(lv, p.region);
#pragma unroll
      for (int i = 0; i < kMaxPick; ++i)
        if (i < p.n_char_bits && best[i] != 0xffffffffu)
          set_bit<MAXL>(acc, char_bit((int)(best[i] >> 12 & 63u), (int)(best[i] >> 24),
                                      (int)(best[i] & 0xfffu), lv, lv_rot, p));
      if (p.use_length) set_bit<MAXL>(acc, mod_small(lv, p.lseg));
    }
    store_lanes<MAXL>(out + row * p.lanes, acc, p);
  }
}

// ---------------------------------------------------------------------------
// The general path: any max_len up to 1024, any alignment, any n_char_bits.
// ---------------------------------------------------------------------------

// count in bits 20..30, position sum in 0..19 (count <= 1024, sum <= 1024 *
// 1025 / 2 = 524,800 < 2^20)
constexpr int kWideSumBits = 20;

// 16 bytes of a cell from byte k0 on: one vector load, or (unaligned
// layouts) byte loads, zero past max_len
__device__ __forceinline__ void load_chunk(const uint8_t* cell, int k0, int max_len, bool vec,
                                           uint64_t& lo, uint64_t& hi) {
  if (vec) {
    const ulonglong2 v = __ldg(reinterpret_cast<const ulonglong2*>(cell + k0));
    lo = v.x;
    hi = v.y;
    return;
  }
  lo = hi = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint64_t b = k0 + i < max_len ? (uint64_t)__ldg(cell + k0 + i) : 0ull;
    if (i < 8)
      lo |= b << (8 * i);
    else
      hi |= b << (8 * (i - 8));
  }
}

template <int MAXL>
__global__ void __launch_bounds__(kBlock)
xash_general_kernel(const uint8_t* __restrict__ enc, int32_t* __restrict__ out, long long n,
                    Params p, bool vec) {
  extern __shared__ uint32_t s_cnt[];  // [37][blockDim.x]
  __shared__ int s_rank[kAlphabet];
  const int t = threadIdx.x, nt = blockDim.x;
  for (int a = t; a < kAlphabet; a += nt) s_rank[a] = p.rank[a];
  uint32_t* cnt = s_cnt + t;
  for (int a = 0; a < kAlphabet; ++a) cnt[a * nt] = 0;  // own column
  __syncthreads();

  const int max_len = p.max_len;
  const long long row_bytes = (long long)p.n_cols * max_len;
  for (long long row = (long long)blockIdx.x * nt + t; row < n; row += (long long)gridDim.x * nt) {
    uint32_t acc[MAXL];
#pragma unroll
    for (int l = 0; l < MAXL; ++l) acc[l] = 0u;
    const uint8_t* cell = enc + row * row_bytes;
    for (int col = 0; col < p.n_cols; ++col, cell += max_len) {
      uint64_t present = 0;
      int lv = 0;
      for (int k0 = 0; k0 < max_len; k0 += 16) {
        uint64_t lo, hi;
        load_chunk(cell, k0, max_len, vec, lo, hi);
        uint32_t m = repro::nonzero_bytes(lo) | (repro::nonzero_bytes(hi) << 8);
        lv += __popc(m);
        for (; m; m &= m - 1) {
          const int b = __ffs(m) - 1;
          const int code = (int)(((b < 8 ? lo : hi) >> (8 * (b & 7))) & 0xffu);
          if (code > kAlphabet) continue;  // outside the alphabet: length only
          present |= 1ull << (code - 1);
          cnt[(code - 1) * nt] += (1u << kWideSumBits) + k0 + b + 1;
        }
      }
      if (lv == 0) continue;  // an empty value sets nothing

      // one scan per pick: the smallest (count*64+rank)<<6|char not chosen yet
      const int lv_rot = mod_small(lv, p.region);
      uint64_t avail = present;
      for (int pick = 0; pick < p.n_char_bits && avail; ++pick) {
        uint32_t best = 0xffffffffu;
        for (uint64_t m = avail; m; m &= m - 1) {
          const int a = __ffsll((long long)m) - 1;
          best = min(best, (uint32_t)((((cnt[a * nt] >> kWideSumBits) << 6) + s_rank[a]) << 6 | a));
        }
        const int a = (int)(best & 63u);
        avail &= ~(1ull << a);
        const uint32_t v = cnt[a * nt];
        set_bit<MAXL>(acc, char_bit(a, (int)(v >> kWideSumBits),
                                    (int)(v & ((1u << kWideSumBits) - 1)), lv, lv_rot, p));
      }
      for (uint64_t m = present; m; m &= m - 1) cnt[(__ffsll((long long)m) - 1) * nt] = 0;
      if (p.use_length) set_bit<MAXL>(acc, mod_small(lv, p.lseg));
    }
    store_lanes<MAXL>(out + row * p.lanes, acc, p);
  }
}

// a small launch (a query's keys) gets one block of as many warps as rows;
// a large one a persistent grid of as many blocks as fit on the card; words:
// shared words per thread
template <typename Kernel, typename... A>
cudaError_t launch(Kernel kernel, int words, long long n, cudaStream_t s, A... args) {
  const int threads = n >= kBlock ? kBlock : (int)((n + 31) / 32 * 32);
  const size_t smem = (size_t)words * threads * sizeof(uint32_t);
  const size_t smem_max = (size_t)words * kBlock * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_max);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, smem_max);
  if (err != cudaSuccess) return err;
  const long long blocks = (n + threads - 1) / threads;
  const long long cap = (long long)(per_sm < 1 ? 1 : per_sm) * repro::sm_count();
  kernel<<<(int)(blocks < cap ? blocks : cap), threads, smem, s>>>(args...);
  return cudaGetLastError();
}

template <int MAXL>
cudaError_t dispatch(const uint8_t* enc, int32_t* out, long long n, const Params& p, cudaStream_t s) {
  const bool vec = p.max_len % 16 == 0 && (reinterpret_cast<uintptr_t>(enc) & 15) == 0;
  if (vec && p.max_len > 0 && p.max_len <= kFastLen && p.n_char_bits <= kMaxPick)
    return launch(xash_fast_kernel<MAXL>, kCounterWords * (kAlphabet + 1), n, s, enc, out, n, p);
  return launch(xash_general_kernel<MAXL>, kAlphabet, n, s, enc, out, n, p, vec);
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
  if (lanes < 1 || lanes > repro::kMaxLanes || n_char_bits > kAlphabet || max_len > kMaxLen ||
      max_len < 0 || n_cols < 0)
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
  p.vec_out = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* e = static_cast<const uint8_t*>(enc);
  int32_t* o = static_cast<int32_t*>(out);
  if (lanes <= 4) return (int)dispatch<4>(e, o, n, p, s);
  if (lanes <= 8) return (int)dispatch<8>(e, o, n, p, s);
  return (int)dispatch<16>(e, o, n, p, s);
}
