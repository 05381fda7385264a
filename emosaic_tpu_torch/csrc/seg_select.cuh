// The per-segment selection shared by K4 (`seg_topcap.cu`), K9
// (`coarse_topcap.cu`) and K10 (`l1_topcap.cu`): one thread takes one
// (row, segment), the 128 int32 values of that segment in shared memory,
// and writes the segment's `cap` least keys (value << 32) | col,
// ascending, the lowest col first among equal values.
//
// Contract of the callers (ops/distance.py `seg_topcap`, `l1_topcap`):
// within a segment the cols grow with the position, so (value, position)
// order is the (value, col) order, and the positions past the segment's
// `nvalid` (the library's padding rows) are a suffix of the segment; they
// count as `big` (_TL_BIG = 2^30 for K4 and K9, INT_MAX for K10). A
// segment's cols come from a table (`TableCols`: K4, K9) or run on from
// the segment's first col (`RunCols`: K10).
//
// Design. A thread keeps a sorted list of CAPL (a power of two >= cap, at
// most 32) u32 keys (value << 7) | position in registers and inserts
// every position branch-free: slot j becomes max(l[j-1], min(l[j], x)),
// two IMNMX a slot, all slots independent. A compare-and-branch per
// position ("insert only when it beats the worst") would make the 32
// lanes of a warp, each on its own segment, diverge at nearly every
// position (at cap 16 some lane inserts at position 128 with probability
// 0.99), so the branch-free form is the cheaper one: 2 * CAPL + 4
// instructions a position, and no warp-wide step at all. (A threshold
// pass that inserts only the keys below the largest of CAPL group minima,
// about 42 of 128 at cap 16, measured no faster: 3.90 ms against 3.89-3.98
// on the flagship stripe, PERF.md.) The u32 key needs values below 2^24
// (every coarse distance: projected row sums are below 2^24); padding
// positions take the key (2^24 << 7) | position, above every such value.
// A segment with a larger (or negative) value, or a cap above 32, takes
// the exact rank path instead: each position counts the int64 keys below
// its own and, when that rank is below cap, writes itself to that slot.
// It is 64 times the work and runs only off the main paths (tests, and
// stripes whose values pass 2^24).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace seg_select {

constexpr int SEG = 128;        // positions per segment
constexpr int ROW_WORDS = 132;  // a segment's stride in shared memory: 33
                                // 16-byte units, so the 8 threads of a
                                // 16-byte load phase hit distinct banks
constexpr unsigned VAL_LIMIT = 1u << 24;
constexpr unsigned BIG_KEY = VAL_LIMIT << 7;

template <int N>
__device__ __forceinline__ void insert(unsigned (&l)[N], unsigned x) {
#pragma unroll
  for (int j = N - 1; j > 0; --j) l[j] = max(l[j - 1], min(l[j], x));
  l[0] = min(l[0], x);
}

// The positions of segment s whose col is below real_l: all 128 unless
// the last one is padding, then a binary search (cols grow with position).
__device__ __forceinline__ int valid_positions(const int* __restrict__ cols_seg,
                                               long long real_l) {
  if ((long long)__ldg(cols_seg + SEG - 1) < real_l) return SEG;
  int lo = 0, hi = SEG - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long long)__ldg(cols_seg + mid) < real_l) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// A segment's cols read from a table in device memory.
struct TableCols {
  const int* p;
  __device__ __forceinline__ int operator()(int pos) const { return __ldg(p + pos); }
};

// A segment whose cols are c0, c0 + 1, ... (a contiguous run of rows).
struct RunCols {
  long long c0;
  __device__ __forceinline__ int operator()(int pos) const { return (int)(c0 + pos); }
};

__device__ __forceinline__ unsigned long long out_key(int value, int col) {
  return ((unsigned long long)(unsigned)value << 32) | (unsigned)col;
}

// The exact general path: ranks of the int64 keys (value << 7) | position.
template <class Cols>
__device__ __noinline__ int select_rank(const int* v, int nvalid, int cap, int big,
                                        Cols cols, unsigned long long* __restrict__ out) {
  int worst = 0;
  for (int p = 0; p < SEG; ++p) {
    const int vp = p < nvalid ? v[p] : big;
    const long long kp = ((long long)vp << 7) | p;
    int rank = 0;
    for (int q = 0; q < SEG; ++q) {
      const int vq = q < nvalid ? v[q] : big;
      rank += (((long long)vq << 7) | q) < kp;
    }
    if (rank < cap) {
      out[rank] = out_key(vp, cols(p));
      if (rank == cap - 1) worst = vp;
    }
  }
  return worst;
}

// Select one segment: v = its 128 values in shared memory (16-byte
// aligned), nvalid the positions that are not padding (`valid_positions`
// for a table of cols), cols the segment's cols, out = its `cap` output
// slots.
// Returns the value of the cap-th key (the worst kept). CAPL = 0 takes the
// rank path for every segment (cap > 32).
template <int CAPL, class Cols>
__device__ __forceinline__ int select_segment(const int* v, int nvalid, int cap, int big,
                                              Cols cols, unsigned long long* __restrict__ out) {
  if constexpr (CAPL == 0) {
    return select_rank(v, nvalid, cap, big, cols, out);
  } else {
    unsigned l[CAPL];
#pragma unroll
    for (int j = 0; j < CAPL; ++j) l[j] = 0xFFFFFFFFu;
    unsigned seen = 0;  // OR of the valid values: all below 2^24 iff < 2^24
    const int4* v4 = reinterpret_cast<const int4*>(v);
#pragma unroll 4
    for (int k4 = 0; k4 < SEG / 4; ++k4) {
      const int4 q = v4[k4];
      const unsigned x[4] = {(unsigned)q.x, (unsigned)q.y, (unsigned)q.z, (unsigned)q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned p = (unsigned)(4 * k4 + i);
        const bool ok = (int)p < nvalid;
        seen |= ok ? x[i] : 0u;
        insert(l, ok ? (x[i] << 7) | p : BIG_KEY | p);
      }
    }
    if (seen >= VAL_LIMIT) return select_rank(v, nvalid, cap, big, cols, out);
    int worst = 0;
#pragma unroll
    for (int j = 0; j < CAPL; ++j) {
      if (j < cap) {
        const unsigned key = l[j];
        const int value = (key >> 7) == VAL_LIMIT ? big : (int)(key >> 7);
        out[j] = out_key(value, cols((int)(key & (SEG - 1))));
        if (j == cap - 1) worst = value;
      }
    }
    return worst;
  }
}

// The u32 list's length for a cap: the least power of two >= cap, or 0
// (the rank path) above 32.
inline int list_len(int cap) {
  if (cap > 32) return 0;
  int n = 1;
  while (n < cap) n <<= 1;
  return n;
}

}  // namespace seg_select
