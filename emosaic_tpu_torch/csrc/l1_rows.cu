// K3: exact L1 distance of each query block to its own candidate library rows.
//
// Replaces the TPU kernel `_l1_rows_kernel` (emosaic_tpu/ops/distance.py),
// the shortlist rescore of the adaptive certified top-k scorer, and the lab's
// flat-library `_l1_rows_kernel2` (tools/tpu_r19_flatdma.py):
// dist[i, j] = sum_d |blocks[i, d] - lib[min(cand[i, j], L - 1), d]|.
//
// What bounds it on an H100: bytes. Each (query, candidate) pair needs one
// whole library row chosen by index, and each byte costs one byte absolute
// difference (`__vsadu4`: four per instruction into a u32). At the flagship
// no-repeat shape (16384 queries x 1024 candidates x 3072 bytes) fetching a
// row per pair moves 51.5 GB through a 50 MB L2 from a 201 MB library; yet
// neighbouring queries list mostly the same rows. Two paths, chosen by the
// caller from the shapes (ops/distance.py `_k3_plan`):
//
// - Grouped (rows of >= 512 bytes): one block takes a group of G queries
//   (G a power of two, their rows in shared memory: 16 at D = 3072), G
//   consecutive ones in an order that puts queries with the same least
//   candidate row next to each other (a min-hash of the list, computed on
//   the card by three small kernels of this launch: lists that share most
//   rows often share their least one, while a photo's neighbouring blocks
//   are consecutive anyway only where their lists are alike), and
//   gathers their (row, entry) pairs, up to 16384 per pass, then orders them
//   by row on the card with CUB's block radix sort. Each warp walks the runs
//   of equal rows that start in its share of the sorted list and fetches
//   each distinct row once, 16 bytes a lane, a chunk of up to 4 KB at a
//   time, scoring it against up to 8 listing entries at once (the query rows
//   read from shared memory); a reduce-scatter across the warp leaves one
//   entry's sum on every fourth lane, which writes out[q, j]. Any candidate
//   order, repeats and a ragged last group are the same case.
// - Per query (narrower rows, where the library of a fast mode sits in L2):
//   one block per query (its list split over blockIdx.y when B alone cannot
//   fill the card); each warp takes candidates in turn, its lanes read the
//   row with 16-byte loads and fold with shuffles; a row narrower than a
//   warp's 32 x 16 bytes splits the warp into groups of G lanes (a power of
//   two), one candidate per group, so small D keeps every lane busy.
//
// Rows are zero-padded by the caller to whole 16-byte vectors (|0 - 0| adds
// nothing), indices are clamped to [0, L - 1] here, and row offsets are
// 64-bit, so a library past 4 GiB needs no banking. Every sum is below
// 255 * 65536 < 2^31.
//
// Left out from the TPU kernel, each because Hopper does not need it:
// - SMEM candidate chunking: each block reads its own indices from memory.
// - The 1024-lane row padding: rows are padded to 16 bytes only.
// - The bank predication: 64-bit row offsets reach every byte of the library.
// - Precision.HIGHEST: the sums are integer adds, with no matrix unit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

namespace {

// sum_i |a_i - b_i| over four bytes, plus c: one VABSDIFF4.ACC (in PTX, so
// the sums chain through the accumulator instead of separate adds)
__device__ __forceinline__ unsigned sad4(unsigned a, unsigned b, unsigned c) {
  unsigned d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// acc + the L1 distance of two 16-byte vectors
__device__ __forceinline__ unsigned sad16(uint4 a, uint4 c, unsigned acc) {
  return sad4(a.w, c.w, sad4(a.z, c.z, sad4(a.y, c.y, sad4(a.x, c.x, acc))));
}

// ---------------------------------------------------------------------------
// per-query path
// ---------------------------------------------------------------------------

constexpr int NT = 256;  // threads per block: 8 warps
constexpr int NW = NT / 32;

__global__ void __launch_bounds__(NT)
    l1_rows_kernel(const uint4* __restrict__ q, const int32_t* __restrict__ cand,
                   const uint4* __restrict__ lib, int32_t* __restrict__ out,
                   int m, long long l, int nvec, int group_log2) {
  extern __shared__ uint4 sq[];
  const long long i = blockIdx.x;
  const uint4* qrow = q + (size_t)i * nvec;
  for (int t = threadIdx.x; t < nvec; t += NT) sq[t] = qrow[t];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = 1 << group_log2;      // lanes per candidate
  const int per_warp = 32 >> group_log2;  // candidates a warp takes at once
  const int sub = lane >> group_log2;  // this lane's candidate in the warp
  const int gl = lane & (g - 1);       // this lane's place in its group
  const int stride = gridDim.y * NW * per_warp;
  const int32_t* crow = cand + (size_t)i * m;
  int32_t* orow = out + (size_t)i * m;
  // `base` is the same for the whole warp, so every lane reaches the shuffles
  for (int base = (blockIdx.y * NW + warp) * per_warp; base < m; base += stride) {
    const int j = base + sub;
    unsigned acc = 0u;
    if (j < m) {
      long long r = crow[j];
      r = r < 0 ? 0 : (r >= l ? l - 1 : r);
      const uint4* row = lib + (size_t)r * nvec;
#pragma unroll 2
      for (int t = gl; t < nvec; t += g) acc = sad16(sq[t], __ldg(row + t), acc);
    }
    for (int off = g >> 1; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (gl == 0 && j < m) orow[j] = (int32_t)acc;
  }
}

// ---------------------------------------------------------------------------
// grouped path
// ---------------------------------------------------------------------------

constexpr int GT = 512;             // threads per block: 16 warps
constexpr int GW = GT / 32;
constexpr int IPT = 32;             // entries per thread per sort
constexpr int NE = GT * IPT;        // entries per pass: 16384
constexpr int SORT_BYTES = 96 * 1024;  // the sort and the sorted lists
                                       // (ops/distance.py `_K3_SORT_BYTES`)
constexpr int NB = 8;               // entries scored against one fetch
constexpr int RV = 8;               // 16-byte vectors per lane per chunk
constexpr int GROUP_MAX = 64;       // queries per group
constexpr int NBK = 65536;          // buckets of the query order
                                    // (ops/distance.py `_K3_BUCKETS`)

using RowSort = cub::BlockRadixSort<unsigned, GT, IPT, unsigned short>;
struct Lists {
  unsigned row[NE];          // sorted rows
  unsigned short entry[NE];  // their entries: (query in group << mc_log2) | j
};
union SortSmem {
  typename RowSort::TempStorage sort;
  Lists lists;
};
static_assert(sizeof(SortSmem) <= SORT_BYTES, "K3's sort outgrows its room");

// Sum v[k] over the warp for k < 8: afterwards lane L with L % 4 == 0 holds
// the total of entry (L >> 2) & 7. Nine shuffles instead of forty.
__device__ __forceinline__ unsigned reduce_scatter8(unsigned (&v)[NB],
                                                    int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  unsigned w[4], x[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned send = b4 ? v[i] : v[i + 4];
    const unsigned keep = b4 ? v[i + 4] : v[i];
    w[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const unsigned send = b3 ? w[i] : w[i + 2];
    const unsigned keep = b3 ? w[i + 2] : w[i];
    x[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  unsigned y = (b2 ? x[1] : x[0]) +
               __shfl_xor_sync(0xffffffffu, b2 ? x[0] : x[1], 4);
  y += __shfl_xor_sync(0xffffffffu, y, 2);
  y += __shfl_xor_sync(0xffffffffu, y, 1);
  return y;
}

// The query order of the grouped path: queries whose lists share rows
// should share a group. Two lists that overlap much often have the same
// least row (a min-hash), so the queries are ordered by the bucket of their
// least candidate row: one warp per query finds it and counts its bucket,
// one block turns the counts into offsets, and every query takes a slot in
// its bucket. The order inside a bucket is whatever the atomics give; the
// distances do not depend on it.
__global__ void query_buckets(const int32_t* __restrict__ cand,
                              int* __restrict__ bucket, int* __restrict__ count,
                              long long b, int m, long long l) {
  const long long qi = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (qi >= b) return;  // the whole warp: qi is the same for its lanes
  const int32_t* c = cand + (size_t)qi * m;
  unsigned lo = 0xffffffffu;
  for (int j = lane; j < m; j += 32) {
    const long long r = c[j];
    lo = min(lo, (unsigned)(r < 0 ? 0 : (r >= l ? l - 1 : r)));
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  if (lane == 0) {
    const int k = (int)((unsigned long long)lo * NBK / (unsigned long long)l);
    bucket[qi] = k;
    atomicAdd(&count[k], 1);
  }
}

__global__ void __launch_bounds__(1024) scan_buckets(int* __restrict__ count) {
  using Scan = cub::BlockScan<int, 1024>;
  __shared__ typename Scan::TempStorage tmp;
  constexpr int PER = NBK / 1024;
  int v[PER], o[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) v[i] = count[threadIdx.x * PER + i];
  Scan(tmp).ExclusiveSum(v, o);
#pragma unroll
  for (int i = 0; i < PER; ++i) count[threadIdx.x * PER + i] = o[i];
}

__global__ void scatter_queries(const int* __restrict__ bucket,
                                int* __restrict__ offset, int* __restrict__ perm,
                                long long b) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < b) perm[atomicAdd(&offset[bucket[i]], 1)] = (int)i;
}

__global__ void __launch_bounds__(GT, 1)
    l1_rows_grouped(const uint4* __restrict__ q,
                    const int32_t* __restrict__ cand,
                    const uint4* __restrict__ lib, int32_t* __restrict__ out,
                    const int* __restrict__ perm, long long b, int m,
                    long long l, int nvec, int group, int mc_log2,
                    int key_bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long gq[GROUP_MAX];  // this group's queries, in perm order
  SortSmem& ss = *reinterpret_cast<SortSmem*>(smem);
  const uint4* sq = reinterpret_cast<const uint4*>(smem + SORT_BYTES);
  const long long q0 = (long long)blockIdx.x * group;
  const int nq = (int)min((long long)group, b - q0);
  if (threadIdx.x < nq) gq[threadIdx.x] = perm[q0 + threadIdx.x];
  __syncthreads();
  {
    uint4* dst = reinterpret_cast<uint4*>(smem + SORT_BYTES);
    for (int t = threadIdx.x; t < nq * nvec; t += GT) {
      const int qi = t / nvec;
      dst[t] = q[(size_t)gq[qi] * nvec + (t - qi * nvec)];
    }
  }
  const int mc = 1 << mc_log2;
  const unsigned pad = key_bits >= 32 ? 0xffffffffu : (1u << key_bits) - 1u;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int j0 = 0; j0 < m; j0 += mc) {
    const int nj = min(mc, m - j0);
    // this thread's entries e = threadIdx.x * IPT + i (blocked); entries
    // with no candidate take `pad`, above every row, and sort last
    unsigned keys[IPT];
    unsigned short vals[IPT];
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      const int e = threadIdx.x * IPT + i;
      const int qq = e >> mc_log2, jj = e & (mc - 1);
      unsigned key = pad;
      if (qq < nq && jj < nj) {
        long long r = cand[(size_t)gq[qq] * m + j0 + jj];
        key = (unsigned)(r < 0 ? 0 : (r >= l ? l - 1 : r));
      }
      keys[i] = key;
      vals[i] = (unsigned short)e;
    }
    __syncthreads();  // the last pass's lists (and the query rows) are ready
    RowSort(ss.sort).SortBlockedToStriped(keys, vals, 0, key_bits);
    __syncthreads();  // the sort's storage becomes the lists
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      ss.lists.row[threadIdx.x + GT * i] = keys[i];
      ss.lists.entry[threadIdx.x + GT * i] = vals[i];
    }
    __syncthreads();

    // warp w scores the runs that start in its share of the n entries
    const int n = nq * nj;
    const int s_begin = (int)((long long)n * warp / GW);
    const int s_end = (int)((long long)n * (warp + 1) / GW);
    for (int base = s_begin; base < s_end; base += 32) {
      const int p = base + lane;
      const bool start =
          p < s_end && (p == 0 || ss.lists.row[p] != ss.lists.row[p - 1]);
      unsigned starts = __ballot_sync(0xffffffffu, start);
      while (starts) {
        const int s = base + __ffs(starts) - 1;
        starts &= starts - 1;
        const unsigned row = ss.lists.row[s];
        int e = s + 1;  // the run's end: the next entry with another row
        for (;;) {
          const int p2 = e + lane;
          const unsigned d =
              __ballot_sync(0xffffffffu, p2 >= n || ss.lists.row[p2] != row);
          if (d) {
            e += __ffs(d) - 1;
            break;
          }
          e += 32;
        }
        const uint4* lrow = lib + (size_t)row * nvec;
        for (int b0 = s; b0 < e; b0 += NB) {
          const int nb = min(NB, e - b0);
          int qoff[NB];
#pragma unroll
          for (int k = 0; k < NB; ++k)
            qoff[k] = k < nb ? (ss.lists.entry[b0 + k] >> mc_log2) * nvec : 0;
          unsigned acc[NB];
#pragma unroll
          for (int k = 0; k < NB; ++k) acc[k] = 0u;
          for (int c0 = 0; c0 < nvec; c0 += 32 * RV) {
            uint4 v[RV];
#pragma unroll
            for (int i = 0; i < RV; ++i) {
              const int t = c0 + lane + 32 * i;
              v[i] = t < nvec ? __ldg(lrow + t) : make_uint4(0, 0, 0, 0);
            }
#pragma unroll
            for (int k = 0; k < NB; ++k) {
              if (k < nb) {
#pragma unroll
                for (int i = 0; i < RV; ++i) {
                  const int t = c0 + lane + 32 * i;
                  if (t < nvec) acc[k] = sad16(sq[qoff[k] + t], v[i], acc[k]);
                }
              }
            }
          }
          const unsigned sum = reduce_scatter8(acc, lane);
          const int k = (lane >> 2) & 7;
          if ((lane & 3) == 0 && k < nb) {
            const int ent = ss.lists.entry[b0 + k];
            out[(size_t)gq[ent >> mc_log2] * m + j0 + (ent & (mc - 1))] =
                (int32_t)sum;
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// blocks [b, nvec*16] u8 and lib [l, nvec*16] u8, both zero-padded on the
// feature axis to whole 16-byte vectors and 16-byte aligned; cand [b, m]
// i32 (clamped to [0, l-1] here); out [b, m] i32. `group` > 0 takes the
// grouped path with that many queries per block (a power of two) and
// 2^mc_log2 candidate positions per pass (group << mc_log2 <= 16384) and
// `scratch` int32 [65536 + 2 b] for the query order; `group` = 0 the
// per-query path, whose candidates are split across blockIdx.y until the
// grid reaches `target_blocks`. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a group that does not fit.
int emosaic_l1_rows(int device, const void* blocks, const void* cand,
                    const void* lib, void* out, void* scratch, long long b,
                    int m, long long l, int nvec, int group, int mc_log2,
                    int target_blocks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (b <= 0 || m <= 0 || l <= 0 || nvec <= 0) return (int)cudaErrorInvalidValue;
  if (group > 0) {
    const size_t smem = SORT_BYTES + (size_t)group * nvec * 16;
    if ((group & (group - 1)) != 0 || group > GROUP_MAX || mc_log2 < 0 ||
        mc_log2 > 14 || ((long long)group << mc_log2) > NE ||
        smem + sizeof(long long) * GROUP_MAX > 227 * 1024 ||
        b >= (1LL << 31) || scratch == nullptr)
      return (int)cudaErrorInvalidValue;
    int key_bits = 1;
    while (key_bits < 32 && (1LL << key_bits) <= l) ++key_bits;  // pad >= l
    err = cudaFuncSetAttribute(l1_rows_grouped,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    int* count = (int*)scratch;
    int* bucket = count + NBK;
    int* perm = bucket + b;
    err = cudaMemsetAsync(count, 0, NBK * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
    query_buckets<<<(unsigned)((b * 32 + 255) / 256), 256, 0, s>>>(
        (const int32_t*)cand, bucket, count, b, m, l);
    scan_buckets<<<1, 1024, 0, s>>>(count);
    scatter_queries<<<(unsigned)((b + 255) / 256), 256, 0, s>>>(bucket, count,
                                                                perm, b);
    const long long blocks_x = (b + group - 1) / group;
    l1_rows_grouped<<<(unsigned)blocks_x, GT, smem, s>>>(
        (const uint4*)blocks, (const int32_t*)cand, (const uint4*)lib,
        (int32_t*)out, perm, b, m, l, nvec, group, mc_log2, key_bits);
    return (int)cudaGetLastError();
  }
  int group_log2 = 0;
  while ((1 << group_log2) < nvec && group_log2 < 5) ++group_log2;
  const int per_block = NW * (32 >> group_log2);
  long long ysplit = (target_blocks + b - 1) / b;
  const long long ymax = (m + per_block - 1) / per_block;
  ysplit = ysplit < 1 ? 1 : (ysplit > ymax ? ymax : ysplit);
  ysplit = ysplit > 65535 ? 65535 : ysplit;
  const size_t smem = (size_t)nvec * 16;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(l1_rows_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  l1_rows_kernel<<<dim3((unsigned)b, (unsigned)ysplit), NT, smem, s>>>(
      (const uint4*)blocks, (const int32_t*)cand, (const uint4*)lib,
      (int32_t*)out, m, l, nvec, group_log2);
  return (int)cudaGetLastError();
}

const char* emosaic_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
