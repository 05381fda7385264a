// K1: exact L1 nearest library row per query block, lowest row on ties.
//
// Replaces the TPU kernel `_l1_kernel` (emosaic_tpu/ops/distance.py), which
// walks a sequential (block-tile, lib-tile, d-chunk) grid with an int32
// [256, 512] VMEM accumulator and folds a running (min, row) with strict `<`.
//
// What bounds it on an H100: the CUDA cores' byte absolute differences. L1
// on u8 has no tensor-core form at a useful cost, so every query x library
// x byte costs one absolute difference; one `vabsdiff4.add` (SASS
// `VABSDIFF4.ACC`) sums four of them into a running u32 at (by the
// published integer rate) 64 lanes per SM per clock. The feature
// axis is zero-padded by the caller to whole 4-byte words (|0 - 0| adds
// nothing). The design keeps that pipe fed:
//
// - Register path (D <= 64, every mode <= 4 and the repeat main path's
//   D = 48): each lane holds RQ = 8 queries' whole rows in registers, and
//   the 8 warps of a block share those 256 queries and split each library
//   tile's rows between them. A library row is read once per warp as a
//   broadcast shared-memory load of up to four words, which feeds 8 x 4
//   SADs, and the per-(query, row) distance is final at once. Inside a
//   256-row tile it folds as a u32 key (distance << 8) | tile row, two rows
//   per three-way minimum (a distance here is below 2^14); at the end of
//   the tile the key's distance replaces the lane's running (u32 distance,
//   row) on a strict `<`.
// - Staged path (D > 64, rows padded to 16 bytes): the query and library
//   tiles are staged in 16-word (64-byte) steps; each thread owns an 8 x 8
//   micro-tile of (query, row) sums and reads both operands as 16-byte
//   vectors (16 loads feed 256 SADs); rows are padded by four words so the
//   eight library rows a quarter-warp reads sit in distinct banks.
// - Both paths stage the library through `cp.async` into a two-stage ring:
//   the copy of the next step overlaps the work on this one. The TPU's
//   sequential j / d grid is this in-block loop.
//
// Every lane folds its rows in ascending order (the staged path row by
// row, the register path tile by tile) and takes a row only on a strict
// `<`, so the lowest row wins ties inside a lane. The lanes, warps
// and library splits (blockIdx.y, used when B alone cannot fill the card)
// then fold with a packed (uint64(dist) << 32) | row key, by shuffles,
// shared memory and one atomicMin per query: the minimum key is the least
// distance and, among equal distances, the lowest row, whatever order the
// blocks finish in. Distances reach 65800 * 255 > 2^24, so they are never
// packed with the row into 32 bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned long long NO_KEY = ~0ull;
constexpr int NT = 256;  // threads per block, both paths
constexpr int NW = NT / 32;

// register path
constexpr int RQ = 8;            // queries per lane
constexpr int R_TQ = 32 * RQ;    // queries per block (shared by its 8 warps)
constexpr int R_TL = 256;        // library rows per stage
constexpr int R_MAX_DW = 16;     // widest row (4-byte words) it takes
static_assert(R_TL <= 256 && R_MAX_DW * 4 * 255 < (1 << 24),
              "the register path's tile keys pack (distance << 8) | tile row");

// staged path
constexpr int S_T = 128;         // queries and library rows per tile
constexpr int S_KW = 16;         // words per step
constexpr int S_LD = S_KW + 4;   // padded row stride of a staged tile

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; bytes past `src_bytes` are zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// sum_i |a_i - b_i| over the four bytes, plus c: one VABSDIFF4.ACC. Written
// in PTX because `acc += __vsadu4(a, b)` lets the compiler sum the SADs with
// separate three-input adds, which take issue slots from the SADs.
__device__ __forceinline__ unsigned sad4(unsigned a, unsigned b, unsigned c) {
  unsigned d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ unsigned long long pack(unsigned dist, int row) {
  return ((unsigned long long)dist << 32) | (unsigned)row;
}

__global__ void init_keys(unsigned long long* keys, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) keys[i] = NO_KEY;
}

// ---------------------------------------------------------------------------
// register path
// ---------------------------------------------------------------------------

// Stage library rows [r0, r0 + R_TL) (a contiguous run of R_TL * DW words)
// into `dst`; words past the library are zero (never read: the row loop
// stops at the library's end).
template <int DW>
__device__ __forceinline__ void stage_rows(uint32_t* dst,
                                           const uint32_t* __restrict__ lib,
                                           int r0, int l) {
  constexpr int CHUNKS = R_TL * DW / 4;  // 16-byte chunks per stage
  const long long base = (long long)r0 * DW;         // words
  const long long end = (long long)l * DW;           // words in the library
  for (int c = threadIdx.x; c < CHUNKS; c += NT) {
    const long long w = base + 4LL * c;
    const long long left = end - w;
    const int bytes = left >= 4 ? 16 : (left > 0 ? (int)left * 4 : 0);
    cp_async16(dst + 4 * c, bytes > 0 ? lib + w : lib, bytes);
  }
}

template <int DW>
__device__ __forceinline__ void load_row(uint32_t (&w)[DW],
                                         const uint32_t* src) {
  if constexpr (DW % 4 == 0) {
#pragma unroll
    for (int k = 0; k < DW; k += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + k);
      w[k] = v.x, w[k + 1] = v.y, w[k + 2] = v.z, w[k + 3] = v.w;
    }
  } else if constexpr (DW % 2 == 0) {
#pragma unroll
    for (int k = 0; k < DW; k += 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(src + k);
      w[k] = v.x, w[k + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < DW; ++k) w[k] = src[k];
  }
}

template <int DW>
__global__ void __launch_bounds__(NT)
    l1_argmin_reg(const uint32_t* __restrict__ q,
                  const uint32_t* __restrict__ lib,
                  unsigned long long* __restrict__ keys, int b, int l,
                  int tiles_per_split) {
  constexpr int STAGE_WORDS = R_TL * DW;
  constexpr int FOLD_BYTES = NW * R_TQ * 8;
  constexpr int RING_BYTES = 2 * STAGE_WORDS * 4;
  constexpr int SMEM = RING_BYTES > FOLD_BYTES ? RING_BYTES : FOLD_BYTES;
  __shared__ __align__(16) unsigned char smem[SMEM];
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * R_TQ;
  const int ntiles = (l + R_TL - 1) / R_TL;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(ntiles, t_begin + tiles_per_split);

  if (t_begin < t_end) stage_rows<DW>(ring, lib, t_begin * R_TL, l);
  cp_async_commit();

  // this lane's queries q0 + lane + 32 i, whole rows in registers
  uint32_t qv[RQ][DW];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int g = q0 + lane + 32 * i;
#pragma unroll
    for (int k = 0; k < DW; ++k)
      qv[i][k] = g < b ? __ldg(q + (size_t)g * DW + k) : 0u;
  }
  unsigned bd[RQ];
  int br[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) bd[i] = 0xffffffffu, br[i] = -1;

  for (int t = t_begin; t < t_end; ++t) {
    const int s = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      stage_rows<DW>(ring + (s ^ 1) * STAGE_WORDS, lib, (t + 1) * R_TL, l);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t* tile = ring + s * STAGE_WORDS;
    const int rows = min(R_TL, l - t * R_TL);
    // Inside a tile each query keeps one u32 key, (distance << 8) | tile
    // row: here a distance is at most 64 * 255 < 2^14 and a tile has 256
    // rows, so the least key is the least distance at the lowest row. Rows
    // go two at a time (r and r + 8, warp-uniform), so each query's keys
    // fold with one three-way minimum; a lone last row counts twice.
    unsigned tk[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i) tk[i] = 0xffffffffu;
    for (int r = warp; r < rows; r += 2 * NW) {
      const int r1 = r + NW < rows ? r + NW : r;
      uint32_t w0[DW], w1[DW];
      load_row<DW>(w0, tile + r * DW);
      load_row<DW>(w1, tile + r1 * DW);
      unsigned a0[RQ], a1[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a0[i] = 0u, a1[i] = 0u;
#pragma unroll
      for (int k = 0; k < DW; ++k)
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          a0[i] = sad4(qv[i][k], w0[k], a0[i]);
          a1[i] = sad4(qv[i][k], w1[k], a1[i]);
        }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        tk[i] = min(tk[i], min((a0[i] << 8) | r, (a1[i] << 8) | r1));
    }
    // the tile's best replaces the running one only when strictly nearer:
    // every earlier tile's rows are lower
    const int l0 = t * R_TL;
#pragma unroll
    for (int i = 0; i < RQ; ++i)
      if (tk[i] != 0xffffffffu && (tk[i] >> 8) < bd[i])
        bd[i] = tk[i] >> 8, br[i] = l0 + (int)(tk[i] & 0xffu);
    __syncthreads();  // the stage is refilled next round
  }

  // fold the 8 warps' candidates of each query, then across splits
  unsigned long long* fold = reinterpret_cast<unsigned long long*>(smem);
#pragma unroll
  for (int i = 0; i < RQ; ++i)
    fold[warp * R_TQ + lane + 32 * i] = br[i] < 0 ? NO_KEY : pack(bd[i], br[i]);
  __syncthreads();
  for (int j = threadIdx.x; j < R_TQ; j += NT) {
    unsigned long long best = NO_KEY;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const unsigned long long k = fold[w * R_TQ + j];
      best = k < best ? k : best;
    }
    const int g = q0 + j;
    if (g < b && best != NO_KEY) atomicMin(&keys[g], best);
  }
}

// ---------------------------------------------------------------------------
// staged path
// ---------------------------------------------------------------------------

// Stage words [d0, d0 + S_KW) of rows [r0, r0 + S_T) of x [n, dw] (dw a
// multiple of 4) into dst [S_T][S_LD]; zeros past the rows and the words.
__device__ __forceinline__ void stage_tile(uint32_t* dst,
                                           const uint32_t* __restrict__ x,
                                           int r0, int n, int dw, int d0) {
  constexpr int CPR = S_KW / 4;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < S_T * CPR; c += NT) {
    const int r = c / CPR, k = 4 * (c % CPR);
    const int g = r0 + r;
    const bool ok = g < n && d0 + k < dw;
    cp_async16(dst + r * S_LD + k, ok ? x + (size_t)g * dw + d0 + k : x,
               ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(NT)
    l1_argmin_staged(const uint32_t* __restrict__ q,
                     const uint32_t* __restrict__ lib,
                     unsigned long long* __restrict__ keys, int b, int l,
                     int dw, int tiles_per_split) {
  // [stage][query tile, library tile][S_T][S_LD] words: 40 KB
  __shared__ __align__(16) uint32_t ring[2][2][S_T * S_LD];
  const int tx = threadIdx.x & 15;  // library rows tx + 16 j
  const int ty = threadIdx.x >> 4;  // queries ty + 16 i
  const int q0 = blockIdx.x * S_T;
  const int ntiles = (l + S_T - 1) / S_T;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(ntiles, t_begin + tiles_per_split);
  const int nd = (dw + S_KW - 1) / S_KW;
  const long long steps = (long long)max(0, t_end - t_begin) * nd;

  if (steps > 0) {
    stage_tile(ring[0][0], q, q0, b, dw, 0);
    stage_tile(ring[0][1], lib, t_begin * S_T, l, dw, 0);
  }
  cp_async_commit();

  unsigned bd[8];
  int br[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) bd[i] = 0xffffffffu, br[i] = -1;
  unsigned acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0u;

  for (long long st = 0; st < steps; ++st) {
    const int s = (int)(st & 1);
    if (st + 1 < steps) {
      const int t1 = t_begin + (int)((st + 1) / nd);
      const int d1 = (int)((st + 1) % nd) * S_KW;
      stage_tile(ring[s ^ 1][0], q, q0, b, dw, d1);
      stage_tile(ring[s ^ 1][1], lib, t1 * S_T, l, dw, d1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t* sq = ring[s][0];
    const uint32_t* sl = ring[s][1];
#pragma unroll
    for (int k = 0; k < S_KW; k += 4) {
      uint4 a[8], c[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const uint4*>(sq + (ty + 16 * i) * S_LD + k);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        c[j] = *reinterpret_cast<const uint4*>(sl + (tx + 16 * j) * S_LD + k);
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
    __syncthreads();  // the stage is refilled next round
    if ((st + 1) % nd == 0) {  // the tile's last step: fold and reset
      const int l0 = (t_begin + (int)(st / nd)) * S_T;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int row = l0 + tx + 16 * j;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (row < l && acc[i][j] < bd[i]) bd[i] = acc[i][j], br[i] = row;
          acc[i][j] = 0u;
        }
      }
    }
  }
  // the 16 lanes that share ty (and so the same 8 queries) sit in one
  // half-warp: fold them with xor shuffles, then one atomic per query
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    unsigned long long best = br[i] < 0 ? NO_KEY : pack(bd[i], br[i]);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, best, off);
      best = o < best ? o : best;
    }
    const int g = q0 + ty + 16 * i;
    if (tx == 0 && g < b && best != NO_KEY) atomicMin(&keys[g], best);
  }
}

__global__ void unpack_keys(const unsigned long long* __restrict__ keys,
                            int32_t* __restrict__ dist,
                            int32_t* __restrict__ row, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) {
    const unsigned long long k = keys[i];
    dist[i] = (int32_t)(k >> 32);
    row[i] = (int32_t)(k & 0xffffffffu);
  }
}

template <int DW>
void launch_reg(dim3 grid, cudaStream_t s, const uint32_t* q,
                const uint32_t* lib, unsigned long long* keys, int b, int l,
                int per) {
  l1_argmin_reg<DW><<<grid, NT, 0, s>>>(q, lib, keys, b, l, per);
}

// A peak-rate probe of the pipe K1 runs on: 8 independent VABSDIFF4.ACC
// chains per thread, `iters` x 16 rounds; the caller times it.
__global__ void __launch_bounds__(NT) vsad_rate(unsigned* out, int iters) {
  unsigned x[8], y[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    x[i] = threadIdx.x * 0x01010101u + i, y[i] = blockIdx.x * 0x9e3779b9u + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = sad4(x[i], y[i], x[i]);
  }
  unsigned s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) s ^= x[i];
  if (s == 0x12345678u) out[0] = s;  // keeps the chains live
}

}  // namespace

extern "C" {

// blocks [b, dw*4] u8 and lib [l, dw*4] u8, both zero-padded on the feature
// axis to whole 4-byte words (to whole 16-byte vectors when dw > 16) and
// 16-byte aligned; keys [b] u64 scratch; dist, row [b] i32 out. The grid is
// the caller's (ops/distance.py `_k1_plan`): `nsplit` library splits of
// `tiles_per_split` tiles (256 rows on the register path, dw <= 16; 128 on
// the staged path). Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a split that does not cover the library.
int emosaic_l1_argmin(int device, const void* blocks, const void* lib,
                      void* keys, void* dist, void* row, int b, int l, int dw,
                      int nsplit, int tiles_per_split, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const bool reg = dw <= R_MAX_DW;
  const int tq = reg ? R_TQ : S_T;
  const int tl = reg ? R_TL : S_T;
  const long long ntiles = (l + (long long)tl - 1) / tl;
  if (b <= 0 || l <= 0 || dw <= 0 || nsplit < 1 || nsplit > 65535 ||
      tiles_per_split < 1 || (long long)nsplit * tiles_per_split < ntiles ||
      (long long)(nsplit - 1) * tiles_per_split >= ntiles ||
      (!reg && dw % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((b + tq - 1) / tq), (unsigned)nsplit);
  const auto* q = (const uint32_t*)blocks;
  const auto* t = (const uint32_t*)lib;
  auto* k = (unsigned long long*)keys;
  const int lin = (int)((b + 255) / 256);
  init_keys<<<lin, 256, 0, s>>>(k, b);
  switch (reg ? dw : 0) {
    case 1: launch_reg<1>(grid, s, q, t, k, b, l, tiles_per_split); break;
    case 2: launch_reg<2>(grid, s, q, t, k, b, l, tiles_per_split); break;
    case 3: launch_reg<3>(grid, s, q, t, k, b, l, tiles_per_split); break;
    case 4: launch_reg<4>(grid, s, q, t, k, b, l, tiles_per_split); break;
    case 5: launch_reg<5>(grid, s, q, t, k, b, l, tiles_per_split); break;
    case 6: launch_reg<6>(grid, s, q, t, k, b, l, tiles_per_split); break;
    case 7: launch_reg<7>(grid, s, q, t, k, b, l, tiles_per_split); break;
    case 8: launch_reg<8>(grid, s, q, t, k, b, l, tiles_per_split); break;
    case 9: launch_reg<9>(grid, s, q, t, k, b, l, tiles_per_split); break;
    case 10: launch_reg<10>(grid, s, q, t, k, b, l, tiles_per_split); break;
    case 11: launch_reg<11>(grid, s, q, t, k, b, l, tiles_per_split); break;
    case 12: launch_reg<12>(grid, s, q, t, k, b, l, tiles_per_split); break;
    case 13: launch_reg<13>(grid, s, q, t, k, b, l, tiles_per_split); break;
    case 14: launch_reg<14>(grid, s, q, t, k, b, l, tiles_per_split); break;
    case 15: launch_reg<15>(grid, s, q, t, k, b, l, tiles_per_split); break;
    case 16: launch_reg<16>(grid, s, q, t, k, b, l, tiles_per_split); break;
    default:
      l1_argmin_staged<<<grid, NT, 0, s>>>(q, t, k, b, l, dw, tiles_per_split);
  }
  unpack_keys<<<lin, 256, 0, s>>>(k, (int32_t*)dist, (int32_t*)row, b);
  return (int)cudaGetLastError();
}

// Launch the VABSDIFF4 rate probe: `blocks` blocks of 256 threads, each
// thread 8 chains x 16 x `iters` SADs (4 byte pairs each). out: 1 u32.
int emosaic_vsad_rate(int device, void* out, int blocks, int iters,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  vsad_rate<<<blocks, NT, 0, (cudaStream_t)stream>>>((unsigned*)out, iters);
  return (int)cudaGetLastError();
}

const char* emosaic_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
