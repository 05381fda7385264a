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
// useful cost (the only exact bilinear form, the 255-level thermometer
// code, takes 255 int8 MACs a byte pair), and one `vabsdiff4.add` sums
// four byte pairs into a u32 at 64 lanes an SM a clock. The stripe's
// int32 writes are 4 bytes per pair, a small fraction of that time once D
// passes a few dozen bytes; the top-cap writes 8 * cap bytes per 128
// pairs. The design keeps that pipe busy and gives it nothing else to do:
//
// - A persistent grid: one block an SM walks the (query tile, library
//   tile) pairs, 128 x 128 each, by a static stride, in groups of QG query
//   tiles, library tile by library tile within a group, so the tiles that
//   blocks in flight read stay in the 50 MB L2.
// - Warp specialisation: one producer thread issues every copy, as 2-D
//   TMA boxes of 128 rows x 32 words (128 bytes) with the 128-byte
//   swizzle, two boxes of each operand per 64-word stage of a ring; each
//   completes on the stage's `full` mbarrier with its byte count, and the
//   consumer warps release a stage on its `empty` mbarrier. The producer
//   runs ahead across tiles, so the next tile's stages land while the
//   consumers finish this one. There is no block-wide barrier after the
//   set-up. (One 1-D bulk copy per row chunk, 256 a stage, kept the
//   consumers waiting on the copies: 79-80% of the VABSDIFF4 ceiling
//   against 90-92% with boxes, PERF.md. `setmaxnreg` would move registers
//   from the producer to the consumers, but they come from the block's own
//   pool, and one producer warp frees too few to matter: at 288 threads
//   every thread already has up to 224 registers.)
// - Two consumer warpgroups, each 64 query rows x 128 library rows of the
//   tile: a thread an 8 x 8 micro-tile of u32 sums in registers, fed by
//   16-byte shared-memory loads (16 loads for 256 VABSDIFF4). Rows are
//   zero-padded by the caller to whole 16-byte vectors (|0 - 0| adds
//   nothing); the last stage of a row may be short, and the consumers sum
//   only the words it holds (the TMA zero-fills the rest of a box, and
//   rows past the query or library end, whose sums are never written or
//   selected). The swizzle stores 16-byte unit c of a box row r at unit
//   c ^ (r & 7), so the eight rows a quarter-warp reads sit in distinct
//   banks.
// - The stripe entry writes each sum from registers (a warp stores two
//   runs of 16 consecutive ints, whole 32-byte sectors), while the ring
//   already holds the next tile.
// - The top-cap entry writes each warpgroup's sums to its half of an int32
//   [128, 132] buffer apart from the ring, and the warpgroup's 128 threads
//   select its 64 rows, two threads a row (`select_segment_pair`,
//   `seg_select.cuh`: each half of the positions into a sorted u32 list,
//   merged by shuffles; the exact rank path past 2^24 or above cap 32).
//   The warpgroups sync only among themselves (named barriers), so one
//   selects while the other sums and the producer fills the ring.

#include <climits>
#include <cuda.h>  // CUtensorMap and cuTensorMapEncodeTiled's types
#include <cuda_runtime.h>
#include <stdint.h>

#include "seg_select.cuh"

namespace {

using namespace seg_select;

constexpr int NC = 256;             // consumer threads: two warpgroups
constexpr int NT = NC + 32;         // and one producer warp
constexpr int T = 128;              // query rows and library rows per tile
constexpr int QROWS = T / 2;        // query rows of a warpgroup
constexpr int BOX_W = 32;           // words of a box row: 128 bytes, the swizzle's span
constexpr int BOX_BYTES = T * BOX_W * 4;
constexpr int KW = 64;              // words of a row per stage
constexpr int BOXES = KW / BOX_W;   // boxes of each operand per stage
constexpr int STAGE_BYTES = 2 * BOXES * BOX_BYTES;  // [query, library][box][T][128 B]
constexpr int QG = 8;               // query tiles per group of the tile order
constexpr int STRIPE_STAGES = 3;
constexpr int TOPCAP_STAGES = 2;
constexpr int ALIGN = 1024;         // the swizzle repeats every 8 rows of 128 bytes
constexpr int BAR_BYTES = 128;      // the full and empty mbarriers
constexpr int DIST_BYTES = 4 * T * ROW_WORDS;
constexpr int STRIPE_SMEM = ALIGN + STRIPE_STAGES * STAGE_BYTES + BAR_BYTES;
constexpr int TOPCAP_SMEM = ALIGN + TOPCAP_STAGES * STAGE_BYTES + DIST_BYTES + BAR_BYTES;
constexpr int MAX_TILES = 1 << 30;  // tiles a launch (int tile indices)
static_assert(T == SEG, "a library tile is one segment");
static_assert(KW % BOX_W == 0, "a stage holds whole boxes");
static_assert(2 * (STRIPE_STAGES > TOPCAP_STAGES ? STRIPE_STAGES : TOPCAP_STAGES) * 8 <= BAR_BYTES,
              "the barriers fit their bytes");
static_assert(STRIPE_SMEM <= 232448 && TOPCAP_SMEM <= 232448, "227 KB a block");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the barrier's phase `parity` has completed. A stage fills or
// drains within microseconds; a wait past 20 s is a broken pipeline, and
// traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned long long since = 0;
  for (unsigned tries = 1;; ++tries) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if ((tries & 1023) == 0) {
      const unsigned long long now = global_ns();
      if (since == 0) since = now;
      else if (now - since > 20000000000ull) __trap();
    }
  }
}

// One box, rows [row, row + 128) x words [col, col + 32) of the tensor
// `map` describes, global -> shared by the TMA unit with the 128-byte
// swizzle, completing on `bar`'s transaction count. Rows and words past
// the tensor's end arrive as zeros.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int col, int row,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

// a barrier of one consumer warpgroup's 128 threads (ids 1 and 2)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// sum_i |a_i - b_i| over the four bytes, plus c: one VABSDIFF4.ACC (PTX,
// as in K1: `acc += __vsadu4(a, b)` compiles to separate adds)
__device__ __forceinline__ unsigned sad4(unsigned a, unsigned b, unsigned c) {
  unsigned d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

struct Args {
  long long rows, l;
  int dw, ntq, ntl, tiles;
};

// Tile w: groups of QG query tiles, library-tile-major inside a group (the
// last group may hold fewer query tiles).
__device__ __forceinline__ void tile_of(int w, int ntq, int ntl, int& qt, int& lt) {
  const int per_group = QG * ntl;
  const int g = w / per_group;
  const int r = w - g * per_group;
  const int gq = min(QG, ntq - g * QG);
  lt = r / gq;
  qt = g * QG + r % gq;
}

// The producer (one thread): every box of every tile of this block, in
// order, each stage refilled once the consumers have released it. A stage
// takes the boxes that hold words of the rows; a short last one is
// zero-filled past the row.
template <int STAGES>
__device__ __forceinline__ void produce(const Args& a, const CUtensorMap* tmq,
                                        const CUtensorMap* tmt, unsigned char* ring,
                                        uint64_t* full, uint64_t* empty) {
  int s = 0;
  unsigned ph = 0;
  for (int w = blockIdx.x; w < a.tiles; w += gridDim.x) {
    int qt, lt;
    tile_of(w, a.ntq, a.ntl, qt, lt);
    for (int d0 = 0; d0 < a.dw; d0 += KW) {
      const int nb = min(BOXES, (a.dw - d0 + BOX_W - 1) / BOX_W);
      mbar_wait(&empty[s], ph ^ 1u);
      mbar_expect_tx(&full[s], 2u * nb * BOX_BYTES);
      unsigned char* st = ring + s * STAGE_BYTES;
      for (int b = 0; b < nb; ++b) {
        tma_box(st + b * BOX_BYTES, tmq, d0 + b * BOX_W, qt * T, &full[s]);
        tma_box(st + (BOXES + b) * BOX_BYTES, tmt, d0 + b * BOX_W, lt * T, &full[s]);
      }
      if (++s == STAGES) s = 0, ph ^= 1u;
    }
  }
}

// One consumer thread's sums of one tile: acc[i][j] = L1(query row
// 64 wg + ty + 8 i, library row tx + 16 j) of the tile, stage by stage as
// they fill; each warp releases each stage after its last read. A box row
// is 128 bytes, its 16-byte unit c stored at unit c ^ (row & 7); row & 7
// is ty for every query row of the thread and tx & 7 for every library
// row, so the eight rows a quarter-warp reads sit in distinct banks.
template <int STAGES>
__device__ __forceinline__ void tile_sums(const Args& a, const unsigned char* ring,
                                          uint64_t* full, uint64_t* empty, int& s,
                                          unsigned& ph, unsigned (&acc)[8][8]) {
  const int wg = threadIdx.x >> 7;
  const int ty = (threadIdx.x >> 4) & 7;
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0u;
  for (int d0 = 0; d0 < a.dw; d0 += KW) {
    const int nk = min(KW, a.dw - d0);
    mbar_wait(&full[s], ph);
    const unsigned char* sq = ring + s * STAGE_BYTES + (QROWS * wg + ty) * 128;
    const unsigned char* sl = ring + s * STAGE_BYTES + BOXES * BOX_BYTES + tx * 128;
#pragma unroll 4
    for (int k = 0; k < nk; k += 4) {
      const int box = (k / BOX_W) * BOX_BYTES, c = (k % BOX_W) >> 2;
      const unsigned char* pa = sq + box + ((c ^ ty) << 4);
      const unsigned char* pc = sl + box + ((c ^ (tx & 7)) << 4);
      uint4 av[8], cv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = *reinterpret_cast<const uint4*>(pa + i * 8 * 128);
#pragma unroll
      for (int j = 0; j < 8; ++j) cv[j] = *reinterpret_cast<const uint4*>(pc + j * 16 * 128);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          unsigned v = sad4(av[i].x, cv[j].x, acc[i][j]);
          v = sad4(av[i].y, cv[j].y, v);
          v = sad4(av[i].z, cv[j].z, v);
          acc[i][j] = sad4(av[i].w, cv[j].w, v);
        }
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);
    if (++s == STAGES) s = 0, ph ^= 1u;
  }
}

// The shared memory both entries share: the ring at the first 1024-byte
// boundary, then (the top-cap's) sums, then the barriers, initialised by
// one thread before the roles split.
template <int STAGES, int EXTRA>
__device__ __forceinline__ unsigned char* carve(unsigned char* smem, uint64_t*& full,
                                                uint64_t*& empty) {
  unsigned char* ring = smem + ((ALIGN - (smem_u32(smem) & (ALIGN - 1))) & (ALIGN - 1));
  full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES + EXTRA);
  empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);           // the producer's arrive.expect_tx
      mbar_init(&empty[s], NC / 32);    // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return ring;
}

__global__ void __launch_bounds__(NT, 1)
    l1_stripe_kernel(const __grid_constant__ CUtensorMap tmq,
                     const __grid_constant__ CUtensorMap tmt, const Args a,
                     int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t *full, *empty;
  unsigned char* ring = carve<STRIPE_STAGES, 0>(smem, full, empty);
  if (threadIdx.x >= NC) {
    if (threadIdx.x == NC) produce<STRIPE_STAGES>(a, &tmq, &tmt, ring, full, empty);
  } else {
    const int wg = threadIdx.x >> 7, ty = (threadIdx.x >> 4) & 7, tx = threadIdx.x & 15;
    int s = 0;
    unsigned ph = 0;
    for (int w = blockIdx.x; w < a.tiles; w += gridDim.x) {
      int qt, lt;
      tile_of(w, a.ntq, a.ntl, qt, lt);
      unsigned acc[8][8];
      tile_sums<STRIPE_STAGES>(a, ring, full, empty, s, ph, acc);
      const long long r0 = (long long)qt * T + QROWS * wg + ty, c0 = (long long)lt * T + tx;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long r = r0 + 8 * i;
        if (r < a.rows) {
          int* row = out + r * a.l;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const long long c = c0 + 16 * j;
            if (c < a.l) row[c] = (int)acc[i][j];
          }
        }
      }
    }
  }
}

template <int CAPL>
__global__ void __launch_bounds__(NT, 1)
    l1_topcap_kernel(const __grid_constant__ CUtensorMap tmq,
                     const __grid_constant__ CUtensorMap tmt, const Args a,
                     unsigned long long* __restrict__ out, int cap, long long col0,
                     long long valid_end, int big) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t *full, *empty;
  unsigned char* ring = carve<TOPCAP_STAGES, DIST_BYTES>(smem, full, empty);
  int* dist = reinterpret_cast<int*>(ring + TOPCAP_STAGES * STAGE_BYTES);
  if (threadIdx.x >= NC) {
    if (threadIdx.x == NC) produce<TOPCAP_STAGES>(a, &tmq, &tmt, ring, full, empty);
  } else {
    const int wg = threadIdx.x >> 7, ty = (threadIdx.x >> 4) & 7, tx = threadIdx.x & 15;
    int* half = dist + QROWS * wg * ROW_WORDS;  // this warpgroup's rows
    const int row = (threadIdx.x & 127) >> 1, h = threadIdx.x & 1;  // selection pair
    int s = 0;
    unsigned ph = 0;
    for (int w = blockIdx.x; w < a.tiles; w += gridDim.x) {
      int qt, lt;
      tile_of(w, a.ntq, a.ntl, qt, lt);
      unsigned acc[8][8];
      tile_sums<TOPCAP_STAGES>(a, ring, full, empty, s, ph, acc);
      warpgroup_sync(wg);  // the last tile's selection has read its sums
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) half[(ty + 8 * i) * ROW_WORDS + tx + 16 * j] = (int)acc[i][j];
      warpgroup_sync(wg);
      const long long r = (long long)qt * T + QROWS * wg + row;
      const long long c0 = col0 + (long long)lt * SEG;
      const int nvalid = (int)max(0LL, min((long long)SEG, valid_end - c0));
      select_segment_pair<CAPL>(half + row * ROW_WORDS, h, nvalid, cap, big, RunCols{c0},
                                out + (r * a.ntl + lt) * cap, r < a.rows);
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime (no link against
// libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of x [n, dw] u32 (16-byte aligned rows): boxes of 128
// rows x 32 words, the 128-byte swizzle, zeros past the ends.
bool tensor_map(CUtensorMap* map, const void* x, long long n, int dw) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)dw, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)dw * 4};
  const cuuint32_t box[2] = {BOX_W, T};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, const_cast<void*>(x), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The launch plan the caller made (ops/distance.py `_k10_plan`) against
// this kernel: rows and l within the TMA's int coordinates, dw a positive
// multiple of 4, ntq and tiles whole tiles (at most MAX_TILES), one block
// an SM or one a tile, whichever is fewer.
bool plan_ok(int device, long long rows, long long l, int dw, long long ntq, long long tiles,
             long long grid) {
  if (rows < 1 || l < 1 || rows > INT_MAX || l > INT_MAX || dw < 4 || dw % 4 ||
      ntq != (rows + T - 1) / T)
    return false;
  const long long ntl = (l + T - 1) / T;
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return false;
  return tiles == ntq * ntl && tiles <= MAX_TILES && grid == min((long long)sms, tiles);
}

// The launch's arguments and the two tensor maps; false when a map cannot
// be made.
bool prepare(const void* q, const void* t, long long rows, long long l, int dw, long long ntq,
             long long tiles, Args& a, CUtensorMap& tmq, CUtensorMap& tmt) {
  a = Args{rows, l, dw, (int)ntq, (int)(tiles / ntq), (int)tiles};
  return tensor_map(&tmq, q, rows, dw) && tensor_map(&tmt, t, l, dw);
}

template <int CAPL>
cudaError_t launch_topcap(const CUtensorMap& tmq, const CUtensorMap& tmt, const Args& a,
                          unsigned long long* out, int grid, int cap, long long col0,
                          long long valid_end, int big, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      l1_topcap_kernel<CAPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, TOPCAP_SMEM);
  if (err != cudaSuccess) return err;
  l1_topcap_kernel<CAPL><<<grid, NT, TOPCAP_SMEM, stream>>>(tmq, tmt, a, out, cap, col0,
                                                            valid_end, big);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [rows, dw*4] u8 and t [l, dw*4] u8, zero-padded on the feature axis to
// whole 16-byte vectors (dw a multiple of 4), contiguous and 16-byte
// aligned; out [rows, l] int32. `ntq`, `tiles`, `grid` and `smem_bytes`
// are the launch plan (ops/distance.py `_k10_plan`, `_K10_STRIPE_SMEM`),
// refused when they do not match this kernel. Returns the CUDA error code
// (0 on success).
int emosaic_l1_stripe(int device, const void* q, const void* t, void* out, long long rows,
                      long long l, int dw, long long ntq, long long tiles, int grid,
                      int smem_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a;
  CUtensorMap tmq, tmt;
  if (!plan_ok(device, rows, l, dw, ntq, tiles, grid) || smem_bytes != STRIPE_SMEM ||
      !prepare(q, t, rows, l, dw, ntq, tiles, a, tmq, tmt))
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(l1_stripe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             STRIPE_SMEM);
  if (err != cudaSuccess) return (int)err;
  l1_stripe_kernel<<<grid, NT, STRIPE_SMEM, (cudaStream_t)stream>>>(tmq, tmt, a, (int*)out);
  return (int)cudaGetLastError();
}

// q, t as for `emosaic_l1_stripe`; out [rows, nseg, cap] int64, nseg =
// ceil(l / 128); 1 <= cap <= 128. The col of library row j is col0 + j;
// positions whose col is at least valid_end are padding, valued `big`.
// col0 + nseg * 128 must fit an int. `smem_bytes` is the plan's
// `_K10_TOPCAP_SMEM`. Returns the CUDA error code (0 on success).
int emosaic_l1_topcap(int device, const void* q, const void* t, void* out, long long rows,
                      long long l, int dw, long long ntq, long long tiles, int grid, int cap,
                      long long col0, long long valid_end, int big, int smem_bytes,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a;
  CUtensorMap tmq, tmt;
  if (!plan_ok(device, rows, l, dw, ntq, tiles, grid) || smem_bytes != TOPCAP_SMEM ||
      cap < 1 || cap > SEG || col0 < 0 || col0 + (tiles / ntq) * SEG > INT_MAX ||
      !prepare(q, t, rows, l, dw, ntq, tiles, a, tmq, tmt))
    return (int)cudaErrorInvalidValue;
  auto* o = (unsigned long long*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (list_len(cap)) {
    case 1: err = launch_topcap<1>(tmq, tmt, a, o, grid, cap, col0, valid_end, big, st); break;
    case 2: err = launch_topcap<2>(tmq, tmt, a, o, grid, cap, col0, valid_end, big, st); break;
    case 4: err = launch_topcap<4>(tmq, tmt, a, o, grid, cap, col0, valid_end, big, st); break;
    case 8: err = launch_topcap<8>(tmq, tmt, a, o, grid, cap, col0, valid_end, big, st); break;
    case 16: err = launch_topcap<16>(tmq, tmt, a, o, grid, cap, col0, valid_end, big, st); break;
    case 32: err = launch_topcap<32>(tmq, tmt, a, o, grid, cap, col0, valid_end, big, st); break;
    default: err = launch_topcap<0>(tmq, tmt, a, o, grid, cap, col0, valid_end, big, st); break;
  }
  return (int)err;
}

const char* emosaic_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
