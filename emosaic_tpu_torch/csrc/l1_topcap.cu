// K10: exact u8 L1 distances of query rows against library rows on the
// CUDA cores, with two entry points that share one distance core:
//
// - `emosaic_l1_stripe`: the dense stripe dist[i, j] = sum_d |x[i,d] -
//   t[j,d]| as int32 [rows, L];
// - `emosaic_l1_topcap`: the two-level top-k's stage 1, fused: for each
//   contiguous 128-row segment s of the library, the `cap` least keys
//   (dist << 32) | col, col = col0 + 128 s + position, ascending, the
//   lowest col first among equal distances, as int64 [rows, nseg, cap].
//   No [rows, L] stripe reaches device memory. Positions whose col is at
//   least `valid_end` (past the library or the caller's real_l) are
//   padding and keep the key (INT_MAX << 32) | col.
//
// Replaces, on the card, `torch.cdist(p=1)` in f32 under `l1_block`
// (ops/distance.py) and, in the two-level scorer and the mesh's stripe
// top-k, the [rows, L] int64 key stripe and its `torch.topk` per
// segment. The JAX package computes the same functions with XLA, not a
// Pallas kernel: the fused stripe `_stripe_score_env`
// (emosaic_tpu/ops/distance.py) under `_l1_topk_stripes_jit` and
// `_l1_topk_twolevel_jit`, whose `lax.top_k` per segment is the
// selection `_seg8_kernel` (tools/tpu_r14_seg8.py) does on the TPU.
//
// What bounds it on an H100: the CUDA cores' byte absolute differences,
// as for K1 (`l1_argmin.cu`): exact L1 on u8 has no tensor-core form at a
// useful cost, and one `vabsdiff4.add` sums four byte pairs into a u32 at
// 64 lanes an SM a clock. The stripe's int32 writes are 4 bytes per pair,
// a small fraction of that time once D passes a few dozen bytes; the
// top-cap writes 8 * cap bytes per 128 pairs. The design:
// - The distance core is K1's staged core: a block of 256 threads takes
//   a tile of 128 query rows x 128 library rows, each thread an 8 x 8
//   micro-tile of u32 sums in registers, fed by 16-byte shared-memory
//   loads (16 loads for 256 VABSDIFF4). Rows are zero-padded by the
//   caller to whole 16-byte vectors (|0 - 0| adds nothing); the K-loop
//   stages 16 words of the query and the library tile a step by
//   `cp.async` into a two-stage ring, the next step's copy overlapping
//   this one's sums; tiles are padded by four words a row so the eight
//   rows a quarter-warp reads sit in distinct banks.
// - Blocks walk the (query tile, library tile) grid in groups of QG
//   query tiles, library tile by library tile within a group, so the
//   tiles that blocks in flight read stay in the 50 MB L2: each library
//   tile comes from device memory once per group, each query tile once.
// - The stripe entry writes each sum from registers (a warp stores two
//   runs of 16 consecutive ints, whole 32-byte sectors).
// - The top-cap entry writes the tile's sums to shared memory as int32
//   [128, 132] (over the ring, which is done with), and one thread per
//   query row selects that row's segment with the routine K4 and K9 use
//   (`seg_select.cuh`): a branch-free sorted list of u32 keys for caps up
//   to 32 while every distance is below 2^24 (every u8 row of at most
//   65793 bytes), the exact rank path otherwise. The selection costs about
//   2 * cap + 4 integer instructions a position; at D = 3072 the
//   distances cost 768 VABSDIFF4 a position.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "seg_select.cuh"

namespace {

using namespace seg_select;

constexpr int NT = 256;             // threads per block
constexpr int T = 128;              // query rows and library rows per tile
constexpr int KW = 16;              // words per K step
constexpr int LD = KW + 4;          // padded row stride of a staged tile
constexpr int QG = 8;               // query tiles per group of the block order
constexpr int RING_WORDS = 2 * 2 * T * LD;   // [stage][query, library][T][LD]
constexpr int DIST_WORDS = T * ROW_WORDS;
constexpr int TOPCAP_SMEM = 4 * (RING_WORDS > DIST_WORDS ? RING_WORDS : DIST_WORDS);
static_assert(T == SEG, "a library tile is one segment");
static_assert(4 * RING_WORDS <= 48 * 1024, "the stripe's ring is static shared memory");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; bytes past `src_bytes` are zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// sum_i |a_i - b_i| over the four bytes, plus c: one VABSDIFF4.ACC (PTX,
// as in K1: `acc += __vsadu4(a, b)` compiles to separate adds)
__device__ __forceinline__ unsigned sad4(unsigned a, unsigned b, unsigned c) {
  unsigned d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The tile of block `bid`: groups of QG query tiles, library-tile-major
// inside a group (the last group may hold fewer query tiles).
__device__ __forceinline__ void tile_of(long long bid, long long ntq, long long ntl,
                                        long long& qt, long long& lt) {
  const long long per_group = (long long)QG * ntl;
  const long long g = bid / per_group;
  const long long r = bid - g * per_group;
  const long long gq = min((long long)QG, ntq - g * QG);
  lt = r / gq;
  qt = g * QG + r % gq;
}

// Stage words [d0, d0 + KW) of rows [r0, r0 + T) of x [n, dw] (dw a
// multiple of 4) into dst [T][LD]; zeros past the rows and the words.
__device__ __forceinline__ void stage_tile(uint32_t* dst, const uint32_t* __restrict__ x,
                                           long long r0, long long n, int dw, int d0) {
  constexpr int CPR = KW / 4;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < T * CPR; c += NT) {
    const int r = c / CPR, k = 4 * (c % CPR);
    const long long g = r0 + r;
    const bool ok = g < n && d0 + k < dw;
    cp_async16(dst + r * LD + k, ok ? x + g * dw + d0 + k : x, ok ? 16 : 0);
  }
}

// The distance core: acc[i][j] = L1(query q0 + ty + 16 i, library row
// t0 + tx + 16 j) for this thread's (ty, tx); rows past nq or nt sum
// zero-filled words. Ends with every thread past its last shared read.
__device__ __forceinline__ void tile_sums(uint32_t* ring, const uint32_t* __restrict__ q,
                                          long long nq, const uint32_t* __restrict__ t,
                                          long long nt, int dw, long long q0, long long t0,
                                          unsigned (&acc)[8][8]) {
  const int tx = threadIdx.x & 15;  // library rows tx + 16 j
  const int ty = threadIdx.x >> 4;  // queries ty + 16 i
  const int nd = (dw + KW - 1) / KW;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0u;
  stage_tile(ring, q, q0, nq, dw, 0);
  stage_tile(ring + T * LD, t, t0, nt, dw, 0);
  cp_async_commit();
  for (int st = 0; st < nd; ++st) {
    const int s = st & 1;
    if (st + 1 < nd) {
      uint32_t* nxt = ring + (s ^ 1) * 2 * T * LD;
      stage_tile(nxt, q, q0, nq, dw, (st + 1) * KW);
      stage_tile(nxt + T * LD, t, t0, nt, dw, (st + 1) * KW);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t* sq = ring + s * 2 * T * LD;
    const uint32_t* sl = sq + T * LD;
#pragma unroll
    for (int k = 0; k < KW; k += 4) {
      uint4 a[8], c[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const uint4*>(sq + (ty + 16 * i) * LD + k);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        c[j] = *reinterpret_cast<const uint4*>(sl + (tx + 16 * j) * LD + k);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          unsigned v = sad4(a[i].x, c[j].x, acc[i][j]);
          v = sad4(a[i].y, c[j].y, v);
          v = sad4(a[i].z, c[j].z, v);
          acc[i][j] = sad4(a[i].w, c[j].w, v);
        }
    }
    __syncthreads();  // the stage is refilled next round, or reused by the caller
  }
}

__global__ void __launch_bounds__(NT)
    l1_stripe_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ t,
                     int* __restrict__ out, long long rows, long long l, int dw,
                     long long ntq, long long ntl) {
  __shared__ __align__(16) uint32_t ring[RING_WORDS];
  long long qt, lt;
  tile_of(blockIdx.x, ntq, ntl, qt, lt);
  unsigned acc[8][8];
  tile_sums(ring, q, rows, t, l, dw, qt * T, lt * T, acc);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = qt * T + ty + 16 * i;
    if (r < rows) {
      int* row = out + r * l;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long c = lt * T + tx + 16 * j;
        if (c < l) row[c] = (int)acc[i][j];
      }
    }
  }
}

template <int CAPL>
__global__ void __launch_bounds__(NT)
    l1_topcap_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ t,
                     unsigned long long* __restrict__ out, long long rows, long long l,
                     int dw, long long ntq, long long ntl, int cap, long long col0,
                     long long valid_end, int big) {
  extern __shared__ uint4 smem4[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem4);
  long long qt, lt;
  tile_of(blockIdx.x, ntq, ntl, qt, lt);
  unsigned acc[8][8];
  tile_sums(ring, q, rows, t, l, dw, qt * T, lt * T, acc);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  int* dist = reinterpret_cast<int*>(smem4);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dist[(ty + 16 * i) * ROW_WORDS + tx + 16 * j] = (int)acc[i][j];
  __syncthreads();
  const long long r = qt * T + threadIdx.x;
  if (threadIdx.x < T && r < rows) {
    const long long c0 = col0 + lt * SEG;
    const int nvalid = (int)max(0LL, min((long long)SEG, valid_end - c0));
    select_segment<CAPL>(dist + threadIdx.x * ROW_WORDS, nvalid, cap, big, RunCols{c0},
                         out + (r * ntl + lt) * cap);
  }
}

template <int CAPL>
cudaError_t launch_topcap(const uint32_t* q, const uint32_t* t, unsigned long long* out,
                          long long rows, long long l, int dw, long long ntq, long long ntl,
                          int cap, long long col0, long long valid_end, int big,
                          cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      l1_topcap_kernel<CAPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, TOPCAP_SMEM);
  if (err != cudaSuccess) return err;
  l1_topcap_kernel<CAPL><<<(unsigned)(ntq * ntl), NT, TOPCAP_SMEM, stream>>>(
      q, t, out, rows, l, dw, ntq, ntl, cap, col0, valid_end, big);
  return cudaGetLastError();
}

// The launch plan the caller made (ops/distance.py `_k10_plan`) against
// this kernel's tiles: dw a positive multiple of 4, ntq and ntl whole
// tiles, at most INT_MAX blocks.
bool plan_ok(long long rows, long long l, int dw, long long ntq, long long blocks) {
  if (rows < 1 || l < 1 || dw < 4 || dw % 4 || ntq != (rows + T - 1) / T) return false;
  const long long ntl = (l + T - 1) / T;
  return blocks == ntq * ntl && blocks <= INT_MAX;
}

}  // namespace

extern "C" {

// q [rows, dw*4] u8 and t [l, dw*4] u8, zero-padded on the feature axis to
// whole 16-byte vectors (dw a multiple of 4), contiguous and 16-byte
// aligned; out [rows, l] int32. `ntq` and `blocks` are the launch plan
// (ops/distance.py `_k10_plan`), refused when they do not match this
// kernel's tiles. Returns the CUDA error code (0 on success).
int emosaic_l1_stripe(int device, const void* q, const void* t, void* out, long long rows,
                      long long l, int dw, long long ntq, long long blocks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!plan_ok(rows, l, dw, ntq, blocks)) return (int)cudaErrorInvalidValue;
  l1_stripe_kernel<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)q, (const uint32_t*)t, (int*)out, rows, l, dw, ntq, blocks / ntq);
  return (int)cudaGetLastError();
}

// q, t as for `emosaic_l1_stripe`; out [rows, nseg, cap] int64, nseg =
// ceil(l / 128); 1 <= cap <= 128. The col of library row j is col0 + j;
// positions whose col is at least valid_end are padding, valued `big`.
// col0 + nseg * 128 must fit an int. `smem_bytes` is the plan's shared
// memory a block. Returns the CUDA error code (0 on success).
int emosaic_l1_topcap(int device, const void* q, const void* t, void* out, long long rows,
                      long long l, int dw, long long ntq, long long blocks, int cap,
                      long long col0, long long valid_end, int big, int smem_bytes,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!plan_ok(rows, l, dw, ntq, blocks) || smem_bytes != TOPCAP_SMEM || cap < 1 ||
      cap > SEG || col0 < 0 || col0 + (blocks / ntq) * SEG > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const auto* qq = (const uint32_t*)q;
  const auto* tt = (const uint32_t*)t;
  auto* o = (unsigned long long*)out;
  const long long ntl = blocks / ntq;
  cudaStream_t st = (cudaStream_t)stream;
  switch (list_len(cap)) {
    case 1: err = launch_topcap<1>(qq, tt, o, rows, l, dw, ntq, ntl, cap, col0, valid_end, big, st); break;
    case 2: err = launch_topcap<2>(qq, tt, o, rows, l, dw, ntq, ntl, cap, col0, valid_end, big, st); break;
    case 4: err = launch_topcap<4>(qq, tt, o, rows, l, dw, ntq, ntl, cap, col0, valid_end, big, st); break;
    case 8: err = launch_topcap<8>(qq, tt, o, rows, l, dw, ntq, ntl, cap, col0, valid_end, big, st); break;
    case 16: err = launch_topcap<16>(qq, tt, o, rows, l, dw, ntq, ntl, cap, col0, valid_end, big, st); break;
    case 32: err = launch_topcap<32>(qq, tt, o, rows, l, dw, ntq, ntl, cap, col0, valid_end, big, st); break;
    default: err = launch_topcap<0>(qq, tt, o, rows, l, dw, ntq, ntl, cap, col0, valid_end, big, st); break;
  }
  return (int)err;
}

const char* emosaic_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
