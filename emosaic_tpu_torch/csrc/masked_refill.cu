// K12: the no-repeat assignment's masked refill in one call on the card.
// For each of M query blocks, the k least (distance, row) pairs over the
// library rows that the engine's `used` mask leaves, ascending, the
// lowest row first among equal distances, padded with (INT_MAX, 0) where
// fewer than k rows remain: the contract of the C++ engine's host masked
// scan (`masked_topk`, csrc/emosaic_native.cpp) and of
// `make_numpy_refill` (render/greedy.py). Distances are exact int32 L1
// sums of u8 byte pairs.
//
// Replaces, for calls of at most `_K12_MAX_M` blocks (ops/refill.py),
// the chain a refill call ran on the card: the host's list of unused rows
// and its upload, an `index_select` of those rows (113 MB mid-render at
// 65534 x 3072), K10's stripe at one query row in a 128-row tile, and the
// packed-key `torch.topk`, each step waiting on the host. No TPU kernel:
// the JAX package computes the refill with XLA (`_refill_topk_jit`,
// emosaic_tpu/ops/distance.py).
//
// What bounds it on an H100: at a few blocks a call, the bytes of the
// unused rows over the memory rate (3 KB a row at D = 3072, 0.034 ms for
// 37k rows at 3.35 TB/s); the byte pairs over the VABSDIFF4 rate pass
// that at about 17 blocks. The design reads each unused row once a call
// (a row of up to 4096 bytes stays in registers while every block is
// scored against it), never a used one, and keeps the selection on chip. One
// C call, on the caller's stream: the staged ids and mask up, a memset of
// the histograms, two launches and the answer down.
//
// - `masked_dist_kernel`: each block walks tiles of 256 library rows. A
//   lane reads one mask byte, ballots name the unused rows, and the
//   block lists them in shared memory; its 8 warps take the list's pairs
//   in turn (the rows are scored where they lie: no gather), so the
//   warps of a tile share its work evenly. Each lane loads up to 8
//   16-byte vectors of both rows, strided by the warp so that its loads are
//   512 contiguous bytes, as streaming loads, once for all the call's
//   blocks where that holds the row (D <= 4096; a longer row is read
//   again each pass), then sums the byte pairs against each query
//   block's same vectors (3 KB a block, read through L1) with VABSDIFF4,
//   four blocks a pass, and a shuffle sum gives each (block, row). Used
//   rows are never read: their entries get INT_MAX. The distances, [M, ld]
//   int32 (256 KB a block), stay in the 50 MB L2 for the second launch.
//   Each distance also counts into its block's histogram of the top 11
//   bits of the distance's range (`bits`), 2048 bins in device memory.
// - `masked_select_kernel`: one block of 1024 threads a query block. The
//   histogram names the bin b0 of the k-th least distance. Where the bins
//   up to b0 hold at most CAND_MAX entries (the usual case: a few hundred
//   at k = 256), one pass over the distances gathers their (distance << 32
//   | row) keys into shared memory (a warp's lanes take their places with
//   one atomic), and a bitonic sort orders them; the first k are the
//   answer. Otherwise (tie storms, libraries of one colour) a radix select
//   goes on in 11-bit digits below b0 (a histogram in shared memory a
//   digit; the lanes of a warp that hit one bin add once) to the k-th
//   least distance d*, one ordered pass (a block-wide scan a chunk of 4096
//   entries) places every entry below d* and the first entries equal to d*
//   in row order, as many as k needs, and the sort orders those.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int DIST_THREADS = 256;  // 8 warps
constexpr int WARPS = DIST_THREADS / 32;
constexpr int TILE = 32 * WARPS;   // library rows a block takes at once
constexpr int BLOCKS_PER_SM = 4;   // the distance pass's grid, at most
constexpr int U = 8;               // 16-byte vectors of a row a lane loads a chunk
constexpr int QB = 4;              // query blocks a pass sums
constexpr int SEL_THREADS = 1024;
constexpr int DIGIT = 11;
constexpr int BINS = 1 << DIGIT;   // two a selecting thread
constexpr int MAX_K = 2048;
constexpr int CAND_MAX = 4096;     // keys the shared-memory sort takes
constexpr int GATHER = 4;          // 16-byte loads in flight a selecting thread
static_assert(BINS == 2 * SEL_THREADS, "two bins a thread");
static_assert(MAX_K <= CAND_MAX, "the sort holds k keys");

// sum_i |a_i - b_i| over the four bytes, plus c: one VABSDIFF4.ACC
__device__ __forceinline__ unsigned sad4(unsigned a, unsigned b, unsigned c) {
  unsigned d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ unsigned sad16(const uint4& a, const uint4& b, unsigned c) {
  c = sad4(a.x, b.x, c);
  c = sad4(a.y, b.y, c);
  c = sad4(a.z, b.z, c);
  return sad4(a.w, b.w, c);
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// the chunk of two rows that starts at vector c: a lane's U vectors,
// strided by the warp (512 contiguous bytes a load), streamed (a row is
// read once)
__device__ __forceinline__ void load_rows(const uint4* p0, const uint4* p1, int c, int nv,
                                          uint4 (&v0)[U], uint4 (&v1)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = c + 32 * u;
    if (j < nv) {
      v0[u] = __ldcs(p0 + j);
      v1[u] = __ldcs(p1 + j);
    }
  }
}

struct Args {
  long long l, ld;  // library rows; the stride of a query's distances
  int m, nv, k;     // query blocks; 16-byte vectors a row; entries a query
  int bits;         // every distance is below 2^bits
};

// the first digit's shift: the top DIGIT bits of the distances' range
__device__ __forceinline__ int shift0(const Args& a) { return max(a.bits - DIGIT, 0); }

__global__ void __launch_bounds__(DIST_THREADS)
    masked_dist_kernel(const uint4* __restrict__ blocks, const uint4* __restrict__ lib,
                       const long long* __restrict__ ids,
                       const unsigned char* __restrict__ used, int* __restrict__ dist,
                       unsigned* __restrict__ hist, const Args a) {
  __shared__ int rows[TILE];  // the tile's unused rows, in order
  __shared__ int counts[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sh = shift0(a);
  const long long ntiles = (a.l + TILE - 1) / TILE;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    // a warp a group of 32 rows: the mask, INT_MAX for the used rows, and
    // the unused rows' places in the tile's list
    const long long r = tile * TILE + warp * 32 + lane;
    const bool in = r < a.l;
    const bool skip = in && used[r] != 0;
    if (skip)
      for (int q = 0; q < a.m; ++q) dist[q * a.ld + r] = INT_MAX;
    const unsigned bal = __ballot_sync(FULL, in && !skip);
    if (lane == 0) counts[warp] = __popc(bal);
    __syncthreads();
    int before = 0, n = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      before += w < warp ? counts[w] : 0;
      n += counts[w];
    }
    if (bal >> lane & 1u)
      rows[before + __popc(bal & ((1u << lane) - 1u))] = warp * 32 + lane;
    __syncthreads();
    // the warps take the list's pairs in turn, so each scores its share
    // of the tile's unused rows (a group's own count varies far more)
    for (int p = 2 * warp; p < n; p += 2 * WARPS) {
      // the same row twice at an odd end; the second sum is then not written
      const bool two = p + 1 < n;
      const long long r0 = tile * TILE + rows[p];
      const long long r1 = tile * TILE + rows[two ? p + 1 : p];
      const uint4* p0 = lib + r0 * a.nv;
      const uint4* p1 = lib + r1 * a.nv;
      // a lane's share of both rows, U vectors a chunk; where one chunk
      // holds the whole row (D <= 32 * U * 16 = 4096 bytes) it is loaded
      // once, before the query loop, and every block is scored against
      // it from registers; a longer row is streamed again each pass
      uint4 v0[U], v1[U];
      const bool resident = a.nv <= 32 * U;
      if (resident) load_rows(p0, p1, lane, a.nv, v0, v1);
      for (int q0 = 0; q0 < a.m; q0 += QB) {
        const int nq = min(QB, a.m - q0);
        const uint4* qp[QB];
#pragma unroll
        for (int i = 0; i < QB; ++i) qp[i] = blocks + ids[q0 + min(i, nq - 1)] * a.nv;
        unsigned s0[QB], s1[QB];
#pragma unroll
        for (int i = 0; i < QB; ++i) s0[i] = s1[i] = 0u;
        for (int c = lane; c < a.nv; c += 32 * U) {
          if (!resident) load_rows(p0, p1, c, a.nv, v0, v1);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int j = c + 32 * u;
            if (j < a.nv) {
#pragma unroll
              for (int i = 0; i < QB; ++i) {
                if (i < nq) {
                  const uint4 w = __ldg(qp[i] + j);
                  s0[i] = sad16(v0[u], w, s0[i]);
                  s1[i] = sad16(v1[u], w, s1[i]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < QB; ++i) {
          if (i < nq) {
            const unsigned t0 = warp_sum(s0[i]), t1 = warp_sum(s1[i]);
            if (lane == 0) {
              const long long q = q0 + i;
              dist[q * a.ld + r0] = (int)t0;
              atomicAdd(&hist[q * BINS + (t0 >> sh)], 1u);
              if (two) {
                dist[q * a.ld + r1] = (int)t1;
                atomicAdd(&hist[q * BINS + (t1 >> sh)], 1u);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the list is read before the next tile's
  }
}

// The exclusive prefix sum of v over the block, and the block's total;
// `tmp` holds 32 words of shared memory. Every thread calls it.
__device__ __forceinline__ unsigned block_scan(unsigned v, unsigned* tmp, unsigned& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) tmp[w] = x;
  __syncthreads();
  if (w == 0) {
    unsigned t = lane < SEL_THREADS / 32 ? tmp[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(FULL, t, o);
      if (lane >= o) t += y;
    }
    tmp[lane] = t;
  }
  __syncthreads();
  const unsigned before = (w ? tmp[w - 1] : 0u) + x - v;
  total = tmp[SEL_THREADS / 32 - 1];
  __syncthreads();  // tmp is free again
  return before;
}

// hist[bin] += 1 for each lane with `on`; lanes of a warp that hit one
// bin add once. Every lane of the warp calls it.
__device__ __forceinline__ void hist_add(unsigned* hist, unsigned bin, bool on) {
  const unsigned act = __ballot_sync(FULL, on);
  if (on) {
    const unsigned peers = __match_any_sync(act, bin);
    if ((int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
  }
}

// The bin of `hist` (two a thread) that holds the entry of 1-based rank
// `rank`, and the entries in the bins before it, into *bin and *below.
// Every thread calls it; the caller syncs before reading.
__device__ __forceinline__ void find_bin(const unsigned* hist, unsigned rank, unsigned* tmp,
                                         unsigned* bin, unsigned* below, unsigned& total) {
  const int tid = threadIdx.x;
  const unsigned h0 = hist[2 * tid], h1 = hist[2 * tid + 1];
  const unsigned before = block_scan(h0 + h1, tmp, total);
  const unsigned want = min(rank, total);  // rank 0 or past the total: no bin
  if (before < want && want <= before + h0) {
    *bin = 2 * tid;
    *below = before;
  } else if (before + h0 < want && want <= before + h0 + h1) {
    *bin = 2 * tid + 1;
    *below = before + h0;
  }
}

// keys[0, n) ascending, padded with ~0 to the next power of two
__device__ void sort_keys(unsigned long long* keys, int n) {
  const int tid = threadIdx.x;
  int kp = 1;
  while (kp < n) kp <<= 1;
  for (int i = n + tid; i < kp; i += SEL_THREADS) keys[i] = ~0ull;
  __syncthreads();
  for (int size = 2; size <= kp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < kp / 2; t += SEL_THREADS) {
        const int i = 2 * t - (t & (stride - 1)), j = i + stride;
        const unsigned long long x = keys[i], y = keys[j];
        if ((x > y) == ((i & size) == 0)) {
          keys[i] = y;
          keys[j] = x;
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ unsigned long long key_of(int d, long long row) {
  return ((unsigned long long)(unsigned)d << 32) | (unsigned long long)row;
}

__global__ void __launch_bounds__(SEL_THREADS)
    masked_select_kernel(const int* __restrict__ dist, const unsigned* __restrict__ ghist,
                         const Args a, int* __restrict__ out) {
  __shared__ unsigned hist[BINS];
  __shared__ unsigned long long keys[CAND_MAX];
  __shared__ unsigned tmp[32];
  __shared__ unsigned s_bin, s_below, s_n;
  const int tid = threadIdx.x, lane = tid & 31;
  const int q = blockIdx.x;
  const int4* dq = reinterpret_cast<const int4*>(dist + q * a.ld);
  const long long n4 = a.ld / 4;
  int* od = out + (long long)q * a.k;
  int* orow = out + ((long long)a.m + q) * a.k;

  // the first digit, from the distance pass's histogram
  for (int i = tid; i < BINS; i += SEL_THREADS) hist[i] = ghist[(long long)q * BINS + i];
  __syncthreads();
  unsigned total;
  find_bin(hist, (unsigned)a.k, tmp, &s_bin, &s_below, total);
  const int keff = (int)min((unsigned)a.k, total);
  __syncthreads();
  if (keff > 0) {
    int shift = shift0(a);
    unsigned prefix = s_bin, below_all = s_below;
    unsigned rank = (unsigned)keff - below_all;  // entries of bin prefix to take
    const bool fits = below_all + hist[prefix] <= CAND_MAX;
    __syncthreads();  // every thread has read the histogram
    if (fits) {
      // every entry of the bins up to b0 into shared memory, then sort
      if (tid == 0) s_n = 0u;
      __syncthreads();
      for (long long v0 = 0; v0 < n4; v0 += GATHER * SEL_THREADS) {
        int4 e[GATHER];  // GATHER loads in flight a thread
#pragma unroll
        for (int g = 0; g < GATHER; ++g) {
          const long long v = v0 + g * SEL_THREADS + tid;
          e[g] = v < n4 ? dq[v] : make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
        }
#pragma unroll
        for (int g = 0; g < GATHER; ++g) {
          const long long v = v0 + g * SEL_THREADS + tid;
          const int ds[4] = {e[g].x, e[g].y, e[g].z, e[g].w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const unsigned d = (unsigned)ds[c];
            const bool on =
                4 * v + c < a.l && d != (unsigned)INT_MAX && (d >> shift) <= prefix;
            const unsigned bal = __ballot_sync(FULL, on);
            if (bal == 0u) continue;  // uniform
            const int lead = __ffs(bal) - 1;
            unsigned pos = 0u;
            if (lane == lead) pos = atomicAdd(&s_n, __popc(bal));
            pos = __shfl_sync(FULL, pos, lead);
            if (on) keys[pos + __popc(bal & ((1u << lane) - 1u))] = key_of(ds[c], 4 * v + c);
          }
        }
      }
      __syncthreads();
      sort_keys(keys, (int)s_n);
    } else {
      // the remaining digits below b0, then the ordered placement
      while (shift > 0) {
        const int w = min(DIGIT, shift);
        shift -= w;
        for (int i = tid; i < BINS; i += SEL_THREADS) hist[i] = 0u;
        __syncthreads();
        for (long long v0 = 0; v0 < n4; v0 += SEL_THREADS) {
          const long long v = v0 + tid;
          int4 e = make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
          if (v < n4) e = dq[v];
          const int ds[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const unsigned d = (unsigned)ds[c];
            const bool on = 4 * v + c < a.l && d != (unsigned)INT_MAX &&
                            (d >> (shift + w)) == prefix;
            hist_add(hist, (d >> shift) & (BINS - 1), on);
          }
        }
        __syncthreads();
        find_bin(hist, rank, tmp, &s_bin, &s_below, total);
        __syncthreads();
        prefix = (prefix << w) | s_bin;
        rank -= s_below;
        below_all += s_below;
        __syncthreads();
      }
      // d* = prefix: place the entries below it and the first `rank`
      // equal to it, each group in row order: [0, below_all) and
      // [below_all, keff)
      const unsigned dstar = prefix;
      unsigned lt_base = 0u, eq_base = 0u;
      for (long long v0 = 0; v0 < n4; v0 += SEL_THREADS) {
        const long long v = v0 + tid;
        int4 e = make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
        if (v < n4) e = dq[v];
        const int ds[4] = {e.x, e.y, e.z, e.w};
        unsigned lt = 0u, eq = 0u;  // 4 bits each: which of the four
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const unsigned d = (unsigned)ds[c];
          const bool valid = 4 * v + c < a.l && d != (unsigned)INT_MAX;
          lt |= (unsigned)(valid && d < dstar) << c;
          eq |= (unsigned)(valid && d == dstar) << c;
        }
        // a chunk holds at most 4096 of each: both counts in one scan
        const unsigned before = block_scan((__popc(lt) << 16) | __popc(eq), tmp, total);
        unsigned pl = lt_base + (before >> 16), pe = eq_base + (before & 0xffffu);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (lt >> c & 1u) keys[pl++] = key_of(ds[c], 4 * v + c);
          if (eq >> c & 1u) {
            if (pe < rank) keys[below_all + pe] = key_of(ds[c], 4 * v + c);
            ++pe;
          }
        }
        lt_base += total >> 16;
        eq_base += total & 0xffffu;
        if (lt_base == below_all && eq_base >= rank) break;  // uniform: from the scan
      }
      __syncthreads();
      sort_keys(keys, keff);
    }
  }
  for (int i = tid; i < a.k; i += SEL_THREADS) {
    const bool have = i < keff;
    od[i] = have ? (int)(keys[i] >> 32) : INT_MAX;
    orow[i] = have ? (int)(keys[i] & 0xffffffffu) : 0;
  }
}

// The launch plan the caller made (ops/refill.py `_k12_plan`) against
// this kernel: whole rows of 16-byte vectors whose largest sum fits
// `bits` bits under INT_MAX, the distances' stride whole 16-byte vectors,
// k within the selection, and the distance pass's grid.
bool plan_ok(int device, long long m, long long l, long long ld, int nv, int k, int bits,
             int grid) {
  if (m < 1 || m > INT_MAX || l < 1 || l > INT_MAX - 3 || ld != (l + 3) / 4 * 4 || nv < 1 ||
      k < 1 || k > MAX_K || bits < 1 || bits > 31 || (255LL * 16 * nv) >> bits != 0)
    return false;
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return false;
  const long long groups = (l + 31) / 32;
  return grid == min((groups + WARPS - 1) / WARPS, (long long)sms * BLOCKS_PER_SM);
}

}  // namespace

extern "C" {

// blocks [B, nv*16] u8 and lib [L, nv*16] u8, zero-padded to whole
// 16-byte vectors, contiguous and 16-byte aligned; ids [m] int64 (rows of
// blocks); used [L] u8 (nonzero: excluded); hist [m, 2048] u32 and dist
// [m, ld] int32 scratch, 16-byte aligned; out [2, m, k] int32: dists, then
// rows. `ld`, `bits` and `grid` are the launch plan (ops/refill.py
// `_k12_plan`), refused when they do not match this kernel. Where
// `up_bytes` > 0, the call first copies that many bytes from the
// page-locked host buffer `up_src` to `up_dst` on the card (the caller's
// staged ids and mask); where `down` is not null, it copies out to that
// page-locked host buffer last. Copies and launches are asynchronous on
// `stream`. Returns the CUDA error code (0 on success).
int emosaic_masked_refill(int device, const void* blocks, const void* lib, const void* ids,
                          const void* used, void* hist, void* dist, void* out, long long m,
                          long long l, long long ld, int nv, int k, int bits, int grid,
                          const void* up_src, void* up_dst, long long up_bytes, void* down,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!plan_ok(device, m, l, ld, nv, k, bits, grid) || up_bytes < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Args a{l, ld, (int)m, nv, k, bits};
  if (up_bytes > 0) {
    err = cudaMemcpyAsync(up_dst, up_src, (size_t)up_bytes, cudaMemcpyHostToDevice, st);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaMemsetAsync(hist, 0, (size_t)m * BINS * sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  masked_dist_kernel<<<grid, DIST_THREADS, 0, st>>>(
      (const uint4*)blocks, (const uint4*)lib, (const long long*)ids,
      (const unsigned char*)used, (int*)dist, (unsigned*)hist, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  masked_select_kernel<<<(int)m, SEL_THREADS, 0, st>>>((const int*)dist, (const unsigned*)hist,
                                                      a, (int*)out);
  err = cudaGetLastError();
  if (err != cudaSuccess || down == nullptr) return (int)err;
  return (int)cudaMemcpyAsync(down, out, (size_t)2 * m * k * sizeof(int),
                              cudaMemcpyDeviceToHost, st);
}

const char* emosaic_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
