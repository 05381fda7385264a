// K13: every row of the no-repeat route's [B, L] int32 distance matrix
// sorted on the card, ascending by (distance, column): the full sorted
// candidate list of each block, in the order `np.argsort(kind="stable")`
// gives (ties go to the lower library row).
//
// Replaces host code, not a TPU kernel: the exact-full route's stable
// `np.argsort` of the matrix copied to the host, its `take_along_axis` and
// the int32 casts (`render/norepeat.py`; the JAX package still sorts on the
// host, `emosaic_tpu/render/norepeat.py:121-123`).
//
// Keys. Entry (dist, col) of a row becomes the key (dist << bits_c) | col,
// bits_c = bitlen(L - 1). Keys are unique, and their order is the (distance,
// column) order. The caller's launch plan (ops/distance.py `_k13_plan`)
// takes u32 keys where bitlen(dmax) + bits_c <= 32 (dmax = 255 D, the
// largest distance of D-byte rows) and u64 keys otherwise. The columns
// start in ascending order and every pass below is stable, so a least
// significant digit radix sort over the distance bits alone (digits of at
// most 8 bits from bit bits_c up, `passes` of `width` bits) leaves the keys
// in exact order. Output: the u32 keys themselves (4 bytes an entry, split
// on the host), or, for u64 keys, the distances and the columns as two
// int32 [B, L] arrays.
//
// What bounds it on an H100: the matrix read once and the output written
// once. At the `service_m16` cell's [4096, 8192] with u32 keys, 268 MB over
// 3.35 TB/s = 0.080 ms. The design keeps every pass on chip: one block of
// 512 threads takes a row, loads its int32 stripe with 16-byte loads,
// builds the keys in shared memory, sorts them there and writes the result
// with 16-byte stores, so device memory sees each byte once.
//
// - `digit_sort`, the pass: each of the 16 warps takes a contiguous
//   segment of the keys, 32 at a time; `__match_any_sync` groups the lanes
//   of one digit, and the warp's running count of that digit plus the lanes
//   below in the group gives each key its rank in the warp (kept as u16).
//   An exclusive scan of the (digit, warp) counts, digit-major, gives each
//   (digit, warp) its first place; each key goes to that place plus its
//   rank. Stable: a warp ranks its keys in order, and warps take segments
//   in order. Keys ping-pong between two shared buffers.
// - `row_sort_kernel`: a row a block, wholly in shared memory (2 buffers of
//   keys, the ranks and the counts: 86 KB at the cell's 8192 u32 keys, two
//   blocks an SM).
// - Rows too long for one block's shared memory (u32 keys past ~21k
//   entries, u64 past ~12k): chunks of `chunk` keys merged through device
//   memory, pass by pass. `chunk_count_kernel` counts each chunk's digits,
//   `chunk_scan_kernel` scans a row's counts digit-major over the chunks
//   (each (digit, chunk)'s first place in the row), and
//   `chunk_scatter_kernel` sorts a chunk by the digit with `digit_sort` and
//   writes each key to its chunk's first place of its digit plus its place
//   among the chunk's keys of that digit: runs of consecutive addresses.
//   Scratch: two [B, L] key buffers and the counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_WIDTH = 8;  // bits of a digit, at most
constexpr int MAX_BINS = 1 << MAX_WIDTH;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may opt in to
constexpr long long GRID_Y_MAX = 65535;

struct Plan {
  long long rows, n;  // the matrix's shape
  int bits_c;         // column bits: key = dist << bits_c | col
  int passes, width;  // digits of `width` bits from bit bits_c up
  int chunk;          // 0: a row a block; else keys a chunk of the long-row path
};

__device__ __forceinline__ int min_i(int a, int b) { return a < b ? a : b; }

template <typename KT>
__device__ __forceinline__ KT make_key(int dist, long long col, int bits_c) {
  return (static_cast<KT>(static_cast<unsigned>(dist)) << bits_c) | static_cast<KT>(col);
}

template <typename KT>
__device__ __forceinline__ unsigned digit_of(KT key, int shift, unsigned mask) {
  return static_cast<unsigned>(key >> shift) & mask;
}

// Words before the first 16-byte boundary at p (4-byte aligned), at most n.
__device__ __forceinline__ int head_words(const void* p, int n) {
  return min_i(n, static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) >> 2));
}

// s[i] = the key of src[i], column col0 + i, for i < n: 16-byte loads from
// the first aligned word on.
template <typename KT>
__device__ void load_keys(const int* __restrict__ src, int n, long long col0, int bits_c,
                          KT* s) {
  const int head = head_words(src, n);
  for (int i = threadIdx.x; i < head; i += THREADS) s[i] = make_key<KT>(src[i], col0 + i, bits_c);
  const int body = (n - head) >> 2;
  const int4* v = reinterpret_cast<const int4*>(src + head);
  for (int j = threadIdx.x; j < body; j += THREADS) {
    const int4 q = v[j];
    const int i = head + 4 * j;
    s[i] = make_key<KT>(q.x, col0 + i, bits_c);
    s[i + 1] = make_key<KT>(q.y, col0 + i + 1, bits_c);
    s[i + 2] = make_key<KT>(q.z, col0 + i + 2, bits_c);
    s[i + 3] = make_key<KT>(q.w, col0 + i + 3, bits_c);
  }
  for (int i = head + 4 * body + threadIdx.x; i < n; i += THREADS)
    s[i] = make_key<KT>(src[i], col0 + i, bits_c);
}

// dst[i] = f(i) for i < n: 16-byte stores from the first aligned word on.
template <typename F>
__device__ void store_row(int* __restrict__ dst, int n, const F& f) {
  const int head = head_words(dst, n);
  for (int i = threadIdx.x; i < head; i += THREADS) dst[i] = f(i);
  const int body = (n - head) >> 2;
  int4* v = reinterpret_cast<int4*>(dst + head);
  for (int j = threadIdx.x; j < body; j += THREADS) {
    const int i = head + 4 * j;
    v[j] = make_int4(f(i), f(i + 1), f(i + 2), f(i + 3));
  }
  for (int i = head + 4 * body + threadIdx.x; i < n; i += THREADS) dst[i] = f(i);
}

template <typename KT>
struct KeyBits {  // a u32 key's bits
  const KT* s;
  __device__ int operator()(int i) const { return static_cast<int>(static_cast<unsigned>(s[i])); }
};

template <typename KT>
struct DistOf {
  const KT* s;
  int bits_c;
  __device__ int operator()(int i) const { return static_cast<int>(s[i] >> bits_c); }
};

template <typename KT>
struct ColOf {
  const KT* s;
  KT mask;
  __device__ int operator()(int i) const { return static_cast<int>(s[i] & mask); }
};

// In-place exclusive prefix sum of arr[0, m) by the whole block; `wsum`
// holds WARPS words of shared memory. Ends with a barrier.
__device__ void block_scan(unsigned* arr, long long m, unsigned* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned carry = 0;
  for (long long base = 0; base < m; base += THREADS) {
    const long long i = base + threadIdx.x;
    const unsigned v = i < m ? arr[i] : 0u;
    unsigned x = v;  // inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      unsigned s = lane < WARPS ? wsum[lane] : 0u;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(FULL, s, o);
        if (lane >= o) s += y;
      }
      if (lane < WARPS) wsum[lane] = s;  // inclusive over the warps
    }
    __syncthreads();
    if (i < m) arr[i] = carry + (warp ? wsum[warp - 1] : 0u) + x - v;
    carry += wsum[WARPS - 1];
    __syncthreads();  // wsum is written again by the next tile
  }
}

// One stable pass: src[0, n) into dst ordered by the digit (key >> shift)
// & (bins - 1), all in shared memory. `rank` holds n u16, `hist` bins x
// WARPS words, `wsum` WARPS words. On return hist[d * WARPS] is digit d's
// first place in dst. Starts and ends with a barrier.
template <typename KT>
__device__ void digit_sort(const KT* src, KT* dst, uint16_t* rank, unsigned* hist,
                           unsigned* wsum, int n, int shift, int bins) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned mask = bins - 1;
  for (int i = threadIdx.x; i < bins * WARPS; i += THREADS) hist[i] = 0;
  __syncthreads();
  const int seg = (n + WARPS - 1) / WARPS;  // a warp's keys: [warp * seg, +seg)
  const int lo = warp * seg;
  const int hi = min_i(lo + seg, n);
  const unsigned below = (1u << lane) - 1;
  for (int base = lo; base < hi; base += 32) {  // the same trips for every lane
    const int pos = base + lane;
    const bool ok = pos < hi;
    const unsigned d = ok ? digit_of(src[pos], shift, mask) : static_cast<unsigned>(bins);
    const unsigned peers = __match_any_sync(FULL, d);
    unsigned* h = &hist[(ok ? d : 0u) * WARPS + warp];
    const unsigned before = ok ? *h : 0u;
    if (ok) rank[pos] = static_cast<uint16_t>(before + __popc(peers & below));
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) *h = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  block_scan(hist, static_cast<long long>(bins) * WARPS, wsum);
  for (int pos = threadIdx.x; pos < n; pos += THREADS) {
    const KT key = src[pos];
    dst[hist[digit_of(key, shift, mask) * WARPS + pos / seg] + rank[pos]] = key;
  }
  __syncthreads();
}

// Shared memory of a block sorting `cap` keys at once (cap a multiple of
// 8): two key buffers, the ranks, the counts, the scan's warp sums.
__host__ __device__ inline long long smem_bytes(long long cap, int key_bytes, int width) {
  return 2 * cap * key_bytes + 2 * cap + 4LL * WARPS * ((1LL << width) + 1);
}

template <typename KT>
struct Carve {
  KT *a, *b;
  uint16_t* rank;
  unsigned *hist, *wsum;
  __device__ Carve(unsigned char* smem, int cap, int width) {
    a = reinterpret_cast<KT*>(smem);
    b = a + cap;
    rank = reinterpret_cast<uint16_t*>(b + cap);
    hist = reinterpret_cast<unsigned*>(rank + cap);
    wsum = hist + (WARPS << width);
  }
};

// A row a block: OUT 1 writes the u32 keys' bits to out0, OUT 2 the
// distances to out0 and the columns to out1.
template <typename KT, int OUT>
__global__ void __launch_bounds__(THREADS, 2)
    row_sort_kernel(const int* __restrict__ dist, int* __restrict__ out0,
                    int* __restrict__ out1, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = static_cast<int>(p.n);
  Carve<KT> c(smem, (n + 7) & ~7, p.width);
  const long long off = static_cast<long long>(blockIdx.x) * p.n;
  load_keys<KT>(dist + off, n, 0, p.bits_c, c.a);
  KT* a = c.a;
  KT* b = c.b;
  for (int q = 0; q < p.passes; ++q) {
    digit_sort<KT>(a, b, c.rank, c.hist, c.wsum, n, p.bits_c + q * p.width, 1 << p.width);
    KT* t = a;
    a = b;
    b = t;
  }
  if constexpr (OUT == 1) {
    store_row(out0 + off, n, KeyBits<KT>{a});
  } else {
    store_row(out0 + off, n, DistOf<KT>{a, p.bits_c});
    store_row(out1 + off, n, ColOf<KT>{a, (static_cast<KT>(1) << p.bits_c) - 1});
  }
}

// The long-row path's first step of a pass: counts[(row * bins + d) * nch
// + c] = the keys of digit d in chunk c of the row. FIRST: src is the
// int32 matrix, else the previous pass's keys.
template <typename KT, bool FIRST>
__global__ void __launch_bounds__(THREADS)
    chunk_count_kernel(const void* __restrict__ src, unsigned* __restrict__ counts, Plan p,
                       int shift) {
  __shared__ unsigned h[MAX_BINS];
  const int bins = 1 << p.width;
  const unsigned mask = bins - 1;
  const long long row = blockIdx.x;
  const int c = blockIdx.y, nch = gridDim.y;
  const long long c0 = static_cast<long long>(c) * p.chunk;
  const int n = static_cast<int>(p.n - c0 < p.chunk ? p.n - c0 : p.chunk);
  for (int i = threadIdx.x; i < bins; i += THREADS) h[i] = 0;
  __syncthreads();
  const long long off = row * p.n + c0;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    KT key;
    if constexpr (FIRST)
      key = make_key<KT>(static_cast<const int*>(src)[off + i], c0 + i, p.bits_c);
    else
      key = static_cast<const KT*>(src)[off + i];
    atomicAdd(&h[digit_of(key, shift, mask)], 1u);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < bins; d += THREADS) counts[(row * bins + d) * nch + c] = h[d];
}

// Each row's counts (m = bins x nch words) scanned in place: each (digit,
// chunk)'s first place in the row.
__global__ void __launch_bounds__(THREADS) chunk_scan_kernel(unsigned* counts, long long m) {
  __shared__ unsigned wsum[WARPS];
  block_scan(counts + blockIdx.x * m, m, wsum);
}

// The long-row path's pass: chunk c of a row sorted by the digit in shared
// memory, each key written to its place in the row. OUT 0 writes keys to
// dst (the next pass's source), 1 the u32 keys' bits, 2 the distances to
// dst and the columns to dst1.
template <typename KT, bool FIRST, int OUT>
__global__ void __launch_bounds__(THREADS)
    chunk_scatter_kernel(const void* __restrict__ src, void* __restrict__ dst,
                         int* __restrict__ dst1, const unsigned* __restrict__ offs, Plan p,
                         int shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bins = 1 << p.width;
  const unsigned mask = bins - 1;
  Carve<KT> s(smem, p.chunk, p.width);
  const long long row = blockIdx.x;
  const int c = blockIdx.y, nch = gridDim.y;
  const long long c0 = static_cast<long long>(c) * p.chunk;
  const int n = static_cast<int>(p.n - c0 < p.chunk ? p.n - c0 : p.chunk);
  const long long base = row * p.n;
  if constexpr (FIRST) {
    load_keys<KT>(static_cast<const int*>(src) + base + c0, n, c0, p.bits_c, s.a);
  } else {
    const KT* k = static_cast<const KT*>(src) + base + c0;
    for (int i = threadIdx.x; i < n; i += THREADS) s.a[i] = k[i];
  }
  digit_sort<KT>(s.a, s.b, s.rank, s.hist, s.wsum, n, shift, bins);
  const unsigned* first = offs + row * bins * nch + c;  // first[d * nch]
  const KT cmask = (static_cast<KT>(1) << p.bits_c) - 1;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const KT key = s.b[i];
    const unsigned d = digit_of(key, shift, mask);
    const long long at = base + first[static_cast<long long>(d) * nch] + (i - s.hist[d * WARPS]);
    if constexpr (OUT == 0) {
      static_cast<KT*>(dst)[at] = key;
    } else if constexpr (OUT == 1) {
      static_cast<int*>(dst)[at] = static_cast<int>(static_cast<unsigned>(key));
    } else {
      static_cast<int*>(dst)[at] = static_cast<int>(key >> p.bits_c);
      dst1[at] = static_cast<int>(key & cmask);
    }
  }
}

bool plan_ok(const Plan& p, int key_bytes, int smem, const void* out1, const void* work) {
  if (p.rows < 1 || p.rows > 2147483647LL || p.n < 1) return false;
  if (key_bytes != 4 && key_bytes != 8) return false;
  if (p.width < 1 || p.width > MAX_WIDTH || p.passes < 1) return false;
  if (p.bits_c < 0 || p.bits_c > 31 || (1LL << p.bits_c) < p.n) return false;
  if (p.bits_c + (p.passes - 1) * p.width >= 8 * key_bytes) return false;
  if ((key_bytes == 8) != (out1 != nullptr)) return false;
  if (smem > SMEM_MAX) return false;
  if (p.chunk == 0) return smem == smem_bytes((p.n + 7) & ~7LL, key_bytes, p.width);
  return p.chunk % 8 == 0 && p.chunk <= 65535 && work != nullptr &&
         (p.n + p.chunk - 1) / p.chunk <= GRID_Y_MAX &&
         smem == smem_bytes(p.chunk, key_bytes, p.width);
}

template <typename KT, int OUT>
cudaError_t run_rows(const Plan& p, const int* dist, int* out0, int* out1, int smem,
                     cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(row_sort_kernel<KT, OUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  row_sort_kernel<KT, OUT><<<static_cast<unsigned>(p.rows), THREADS, smem, st>>>(dist, out0,
                                                                                 out1, p);
  return cudaGetLastError();
}

template <typename KT, bool FIRST, int OUT>
cudaError_t scatter(const Plan& p, dim3 grid, const void* src, void* dst, int* dst1,
                    const unsigned* offs, int shift, int smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(chunk_scatter_kernel<KT, FIRST, OUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  chunk_scatter_kernel<KT, FIRST, OUT><<<grid, THREADS, smem, st>>>(src, dst, dst1, offs, p,
                                                                    shift);
  return cudaGetLastError();
}

// The long-row path: per pass, count, scan, scatter; keys ping-pong
// between the two scratch buffers, and the last pass writes the output.
template <typename KT, int LAST>
cudaError_t run_chunks(const Plan& p, const int* dist, int* out0, int* out1, void* work,
                       int smem, cudaStream_t st) {
  const long long nch = (p.n + p.chunk - 1) / p.chunk;
  const dim3 grid(static_cast<unsigned>(p.rows), static_cast<unsigned>(nch));
  KT* buf[2] = {static_cast<KT*>(work), static_cast<KT*>(work) + p.rows * p.n};
  unsigned* counts = reinterpret_cast<unsigned*>(buf[1] + p.rows * p.n);
  const long long m = (1LL << p.width) * nch;
  const void* src = dist;
  cudaError_t err;
  for (int q = 0; q < p.passes; ++q) {
    const int shift = p.bits_c + q * p.width;
    const bool first = q == 0, last = q == p.passes - 1;
    if (first)
      chunk_count_kernel<KT, true><<<grid, THREADS, 0, st>>>(src, counts, p, shift);
    else
      chunk_count_kernel<KT, false><<<grid, THREADS, 0, st>>>(src, counts, p, shift);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    chunk_scan_kernel<<<static_cast<unsigned>(p.rows), THREADS, 0, st>>>(counts, m);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    void* dst = last ? static_cast<void*>(out0) : static_cast<void*>(buf[q & 1]);
    if (first && last)
      err = scatter<KT, true, LAST>(p, grid, src, dst, out1, counts, shift, smem, st);
    else if (first)
      err = scatter<KT, true, 0>(p, grid, src, dst, nullptr, counts, shift, smem, st);
    else if (last)
      err = scatter<KT, false, LAST>(p, grid, src, dst, out1, counts, shift, smem, st);
    else
      err = scatter<KT, false, 0>(p, grid, src, dst, nullptr, counts, shift, smem, st);
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// dist [rows, n] int32, contiguous, every entry in [0, dmax] for the dmax
// the plan was made for; out0 [rows, n] int32: the u32 keys' bits
// (key_bytes 4) or the distances (8); out1 [rows, n] int32: the columns
// (key_bytes 8), else null; work: the long-row path's scratch (chunk > 0:
// two [rows, n] key buffers, then rows x 2^width x nch u32 counts), else
// unused. `key_bytes`, `bits_c`, `passes`, `width`, `chunk` and `smem` are
// the launch plan (ops/distance.py `_k13_plan`), refused when they do not
// fit this kernel. Launches are asynchronous on `stream`. Returns the
// CUDA error code (0 on success).
int emosaic_row_sort(int device, const void* dist, void* out0, void* out1, void* work,
                     long long rows, long long n, int key_bytes, int bits_c, int passes,
                     int width, int chunk, int smem, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Plan p{rows, n, bits_c, passes, width, chunk};
  if (!plan_ok(p, key_bytes, smem, out1, work)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* d = static_cast<const int*>(dist);
  int* o0 = static_cast<int*>(out0);
  int* o1 = static_cast<int*>(out1);
  if (key_bytes == 4)
    err = chunk ? run_chunks<unsigned, 1>(p, d, o0, o1, work, smem, st)
                : run_rows<unsigned, 1>(p, d, o0, o1, smem, st);
  else
    err = chunk ? run_chunks<unsigned long long, 2>(p, d, o0, o1, work, smem, st)
                : run_rows<unsigned long long, 2>(p, d, o0, o1, smem, st);
  return (int)err;
}

const char* emosaic_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
