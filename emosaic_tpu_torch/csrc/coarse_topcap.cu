// K9: the adaptive scorer's coarse pass, fused: coarse L1 distances of
// projected query rows against the projected library, and per segment the
// `cap` least keys, without the [rows, lp] distance stripe.
//
// Replaces, on the card, the stripe + selection of the coarse pass
// (`_ad_coarse`, ops/distance.py): `l1_block` (torch.cdist(p=1)) writing
// an int32 [rows, lp] stripe, then K4 selecting from it. The JAX package
// computes the same thing inside one jitted `per_chunk`
// (`_ad_coarse_core_jit`, emosaic_tpu/ops/distance.py), the stripe and
// `lax.top_k` fused by XLA; the TPU selection it stands beside is
// `_seg8_kernel` (tools/tpu_r14_seg8.py). Output: keys [rows, nseg*cap]
// int64, per segment its `cap` least (distance << 32) | col ascending, the
// lowest col first among equal distances, padding positions (col >=
// real_l) at `big`; and s_min [rows] int32, the least over segments of
// the cap-th kept distance (atomicMin into a buffer the caller fills with
// INT_MAX).
//
// Inputs, in the layouts this kernel reads (made by `_ad_coarse_lib` and
// the wrapper): the projected library lib [nseg, dout, 128] f32, segment
// by segment coordinate-major (position k of segment s is library row
// cols[s*128 + k]); the projected query rows transposed, xt [dout, rpad]
// f32 (rpad a multiple of 128, zero past rows). Projected values are
// integers (sums of g u8 cells), so the f32 arithmetic is exact in any
// order: a term is at most 32 * 255 and a row sum at most 255 * 49152 <
// 2^24.
//
// What bounds it on an H100: two pipes. Every (row, position, coordinate)
// costs an FADD for the difference and an FADD of its |.| into the sum, at
// 128 FP32 lanes an SM (6.16 ms at the flagship shape); every (row,
// position) costs the selection integer min/max (VIMNMX), which run at
// about half that rate (the `vimnmx_rate` probe below), and whose time
// measured on the card adds to the FADDs' more than it hides under it
// (PERF.md). The keys it writes
// take a twentieth of the time. (The packed 16-bit `vabsdiff2.add` would
// do two pairs an instruction, but sm_90a has no such instruction: ptxas
// expands it into byte permutes, absolute values and adds, PERF.md.) The
// design:
//
// - A persistent grid: one block an SM (or one an item, when there are
//   fewer) walks the items, each a (query tile of 128 rows, segment of 128
//   positions) pair, by a static stride, in groups of QG query tiles,
//   segment by segment within a group, so the query tiles in flight stay
//   in L2 across segments.
// - Two teams of 256 threads (two warpgroups each) take the block's items
//   in turn, team 0 the even ones and team 1 the odd ones, and run free of
//   each other, so one team's selection runs beside the other's FADDs.
//   (Passing a token so that the teams' distance phases strictly alternate
//   measured slower at the main paths' shapes, PERF.md.)
// - Each team has its own ring of stages with full/empty mbarriers, fed by
//   TMA boxes (128 rows or positions x KT coordinates of each operand,
//   from a 2-D map of xt and a 3-D map of lib that zero-fill past dout and
//   past the ends) that the team's first thread issues: a stage's refill
//   as soon as the team's eight warps have released it, running ahead
//   across the team's items, so an item's first stages land while the
//   team selects the one before. (A producer warp of its own would make 17
//   warps, five on one scheduler, and cap every thread at 96 registers:
//   too few for the micro-tile. At 16 warps each has 128.)
// - A thread holds an 8 x 8 micro-tile of f32 sums in registers (rows
//   4a..4a+3 and 64+4a..64+4a+3, positions 4b..4b+3 and 64+4b..64+4b+3),
//   fed by four 16-byte shared-memory loads a coordinate for 128 FADDs;
//   each warp releases a stage after its last read. No block barrier after
//   set-up.
// - After an item's distances each warp writes its int32 sums to the
//   team's [128, 132] buffer and selects the 16 rows it summed whole (rows
//   8w..8w+7 and 64+8w..64+8w+7 of warp w of the team), two threads a row,
//   eight keys at a time (`select_pair`, below: 14 min/max a key at cap 16
//   instead of the 31 of `seg_select.cuh`'s insertion), writing the keys
//   and one atomicMin of s_min a row. No team barrier: a warp reads only
//   the rows it wrote.
// - Every mbarrier wait traps after 20 s, so a broken pipeline fails the
//   launch instead of hanging the card.

#include <climits>
#include <cuda.h>  // CUtensorMap and cuTensorMapEncodeTiled's types
#include <cuda_runtime.h>
#include <stdint.h>

#include "seg_select.cuh"

namespace {

using namespace seg_select;

constexpr int TEAM = 256;            // threads of a team
constexpr int NT = 2 * TEAM;         // two teams: 16 warps, 128 registers each
constexpr int TQ = 128;              // query rows of an item
constexpr int KT = 16;               // coordinates of a stage
constexpr int BOX_BYTES = KT * TQ * 4;  // one operand's box: [KT][128] f32
constexpr int STAGE_BYTES = 2 * BOX_BYTES;  // [query, library][KT][128]
constexpr int STAGES = 2;            // of each team's ring
constexpr int QG = 8;                // query tiles per group of the item order
constexpr int ALIGN = 128;           // a TMA destination without swizzle
constexpr int DIST_BYTES = 4 * TQ * ROW_WORDS;  // a team's int32 sums
constexpr int BAR_BYTES = 64;        // the teams' full and empty mbarriers
constexpr int SMEM_BYTES = ALIGN + 2 * (STAGES * STAGE_BYTES + DIST_BYTES) + BAR_BYTES;
constexpr int TEAM_WARPS = TEAM / 32;
static_assert(TQ == SEG, "an item is a query tile against one segment");
static_assert(2 * 2 * STAGES * 8 <= BAR_BYTES, "the barriers fit their bytes");
static_assert(SMEM_BYTES <= 232448, "227 KB a block");
static_assert(TEAM * 64 == TQ * SEG, "the micro-tiles cover an item");
static_assert(TEAM == 2 * TQ, "two threads select each row");

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

// Box [row, row + 128) x [c, c + KT) of xt (2-D: rows inner, coordinates
// outer) into dst by the TMA unit, completing on `bar`'s transaction count.
__device__ __forceinline__ void tma_query(void* dst, const CUtensorMap* map, int row, int c,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(row), "r"(c),
      "r"(smem_u32(bar))
      : "memory");
}

// Box [0, 128) x [c, c + KT) of segment s of lib (3-D: positions,
// coordinates, segments), the same way. Coordinates past dout arrive as
// zeros in both maps, and |0 - 0| adds nothing.
__device__ __forceinline__ void tma_library(void* dst, const CUtensorMap* map, int c, int s,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(c), "r"(s),
      "r"(smem_u32(bar))
      : "memory");
}

struct Args {
  long long rows, real_l, items;
  int dout, nk, nseg, ntq, cap, big;
};

// Item w: groups of QG query tiles, segment-major inside a group (the
// last group may hold fewer query tiles).
__device__ __forceinline__ void item_of(long long w, const Args& a, int& qt, int& s) {
  const long long per_group = (long long)QG * a.nseg;
  const long long g = w / per_group;
  const long long r = w - g * per_group;
  const int gq = (int)min((long long)QG, a.ntq - g * QG);
  s = (int)(r / gq);
  qt = (int)(g * QG + r % gq);
}

// Step g of a team's sequence (its i-th item, the block's item team + 2i,
// step k = g - i * nk) into its ring slot g % STAGES: both operands' boxes,
// completing on the slot's full barrier. Issued by the team's first
// thread.
__device__ __forceinline__ void load_step(const Args& a, const CUtensorMap* tmq,
                                          const CUtensorMap* tml, unsigned char* ring,
                                          uint64_t* full, int team, long long g) {
  const long long i = g / a.nk;
  const int k = (int)(g - i * a.nk);
  int qt, s;
  item_of(blockIdx.x + (team + 2 * i) * gridDim.x, a, qt, s);
  const int st = (int)(g % STAGES);
  mbar_expect_tx(&full[st], STAGE_BYTES);
  unsigned char* dst = ring + st * STAGE_BYTES;
  tma_query(dst, tmq, qt * TQ, k * KT, &full[st]);
  tma_library(dst + BOX_BYTES, tml, k * KT, s, &full[st]);
}

// One thread's sums of its team's next item, whose first step is the
// team's step g (advanced past the item): acc[i][m] = L1(query row ri,
// position pm), ri = 4a + i (i < 4) or 60 + 4a + i, pm = 4b + m (m < 4)
// or 60 + 4b + m. A stage's last step may be short: the thread sums whole
// pairs of coordinates, the one past dout a zero. After each step the
// team's first thread waits for the team's warps to release the slot and
// refills it with the team's step g + STAGES, if any (of `steps`).
__device__ __forceinline__ void item_sums(const Args& a, const CUtensorMap* tmq,
                                          const CUtensorMap* tml, unsigned char* ring,
                                          uint64_t* full, uint64_t* empty, int team, int qa,
                                          int pb, long long& g, long long steps,
                                          float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int m = 0; m < 8; ++m) acc[i][m] = 0.f;
  for (int k = 0; k < a.nk; ++k, ++g) {
    const int st = (int)(g % STAGES);
    const unsigned ph = (unsigned)((g / STAGES) & 1);
    mbar_wait(&full[st], ph);
    const float* q = reinterpret_cast<const float*>(ring + st * STAGE_BYTES) + 4 * qa;
    const float* t = reinterpret_cast<const float*>(ring + st * STAGE_BYTES + BOX_BYTES) + 4 * pb;
    const int kc = min(KT, a.dout - k * KT);
#pragma unroll 2
    for (int c = 0; c < kc; c += 2) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const float* qc = q + (c + cc) * TQ;
        const float* tc = t + (c + cc) * SEG;
        const float4 q0 = *reinterpret_cast<const float4*>(qc);
        const float4 q1 = *reinterpret_cast<const float4*>(qc + 64);
        const float4 t0 = *reinterpret_cast<const float4*>(tc);
        const float4 t1 = *reinterpret_cast<const float4*>(tc + 64);
        const float qv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
        const float tv[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int m = 0; m < 8; ++m) acc[i][m] += fabsf(qv[i] - tv[m]);
      }
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[st]);
    if (threadIdx.x % TEAM == 0 && g + STAGES < steps) {
      mbar_wait(&empty[st], ph);
      load_step(a, tmq, tml, ring, full, team, g + STAGES);
    }
    __syncwarp();  // the first warp goes on whole, not its first thread apart
  }
}

// The selection, two threads a row (lanes 2m and 2m + 1 of a warp; half
// h = lane & 1 takes positions [64 h, 64 h + 64)). `seg_select.cuh` inserts
// each key into a sorted list of CAPL u32 keys (value << 7) | position,
// 2 * CAPL - 1 integer min/max a key; here a thread takes its keys eight at
// a time: it sorts the eight (19 compare-exchanges), keeps the CAPL least
// of the list and the eight as min(l[j], b[CAPL - 1 - j]) (a bitonic
// sequence), and sorts that (log2(CAPL) rounds of CAPL / 2
// compare-exchanges): at cap 16, 14 min/max a key instead of 31. The
// integer min/max run at about half the FADD rate, so they bound the
// selection. The pair then merges its two lists the same way by
// shuffles. Keys carry the position, so they are distinct and the result
// is exactly `select_segment`'s. The buffer holds 2^24 at padding positions,
// so their keys are `seg_select.cuh`'s BIG_KEY | position, and a warp whose
// rows hold a real value past 2^24 (or a cap above 32) takes the exact rank
// path, as there.
__device__ __forceinline__ void cas(unsigned& a, unsigned& b) {
  const unsigned lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// Sort 8 keys ascending (an optimal 19-comparator network).
__device__ __forceinline__ void sort8(unsigned (&b)[8]) {
  cas(b[0], b[2]), cas(b[1], b[3]), cas(b[4], b[6]), cas(b[5], b[7]);
  cas(b[0], b[4]), cas(b[1], b[5]), cas(b[2], b[6]), cas(b[3], b[7]);
  cas(b[0], b[1]), cas(b[2], b[3]), cas(b[4], b[5]), cas(b[6], b[7]);
  cas(b[2], b[4]), cas(b[3], b[5]);
  cas(b[1], b[4]), cas(b[3], b[6]);
  cas(b[1], b[2]), cas(b[3], b[4]), cas(b[5], b[6]);
}

// Sort a bitonic sequence of CAPL keys ascending.
template <int CAPL>
__device__ __forceinline__ void bitonic(unsigned (&m)[CAPL]) {
#pragma unroll
  for (int s = CAPL / 2; s > 0; s >>= 1)
#pragma unroll
    for (int j = 0; j < CAPL; ++j)
      if ((j & s) == 0) cas(m[j], m[j + s]);
}

// Select one segment with the pair: v = its 128 values in shared memory
// (2^24 at the padding positions, those from nvalid on), `wide` when some
// real value reached 2^24, out = its `cap` output slots, written only when
// `write` (the pair's two lanes pass the same flags and must both call
// this). Returns, to both, the value of the cap-th key (the worst kept).
template <int CAPL, class Cols>
__device__ __forceinline__ int select_pair(const int* v, int h, int nvalid, bool wide, int cap,
                                           int big, Cols cols,
                                           unsigned long long* __restrict__ out, bool write) {
  const unsigned pair = 3u << ((threadIdx.x & 31) & 30);
  if (CAPL == 0 || wide) {
    const int worst = write ? select_rank_half(v, h, nvalid, cap, big, cols, out) : -1;
    return max(worst, __shfl_xor_sync(pair, worst, 1));
  }
  if constexpr (CAPL > 0) {
    unsigned l[CAPL];
#pragma unroll
    for (int j = 0; j < CAPL; ++j) l[j] = 0xFFFFFFFFu;
    const int4* v4 = reinterpret_cast<const int4*>(v);
#pragma unroll 1
    for (int m = 0; m < HALF / 8; ++m) {
      // half 1 starts four 16-byte units further on: with a row stride of
      // 33 units, the 8 lanes of a load phase (4 pairs) hit distinct banks
      unsigned b[8];
#pragma unroll
      for (int u2 = 0; u2 < 2; ++u2) {
        const int k4 = h * (HALF / 4) + ((2 * m + u2 + 4 * h) & (HALF / 4 - 1));
        const int4 q = v4[k4];
        const unsigned x[4] = {(unsigned)q.x, (unsigned)q.y, (unsigned)q.z, (unsigned)q.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) b[4 * u2 + i] = (x[i] << 7) | (unsigned)(4 * k4 + i);
      }
      sort8(b);
#pragma unroll
      for (int j = 0; j < CAPL; ++j)
        if (CAPL - 1 - j < 8) l[j] = min(l[j], b[CAPL - 1 - j]);
      bitonic(l);
    }
#pragma unroll
    for (int j = 0; j < CAPL; ++j) l[j] = min(l[j], __shfl_xor_sync(pair, l[CAPL - 1 - j], 1));
    bitonic(l);
    int worst = 0;
#pragma unroll
    for (int j = 0; j < CAPL; ++j) {
      if (j < cap) {
        const unsigned key = l[j];
        const int value = (key >> 7) == VAL_LIMIT ? big : (int)(key >> 7);
        if (write && (j & 1) == h) out[j] = out_key(value, cols((int)(key & (SEG - 1))));
        if (j == cap - 1) worst = value;
      }
    }
    return worst;
  }
  return 0;
}

template <int CAPL>
__global__ void __launch_bounds__(NT, 1)
    coarse_topcap_kernel(const __grid_constant__ CUtensorMap tmq,
                         const __grid_constant__ CUtensorMap tml, const Args a,
                         const int* __restrict__ cols, unsigned long long* __restrict__ out,
                         int* __restrict__ s_min) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int team = threadIdx.x / TEAM, u = threadIdx.x % TEAM;
  unsigned char* base = smem + ((ALIGN - (smem_u32(smem) & (ALIGN - 1))) & (ALIGN - 1));
  unsigned char* ring = base + team * STAGES * STAGE_BYTES;
  int* sums = reinterpret_cast<int*>(base + 2 * STAGES * STAGE_BYTES + team * DIST_BYTES);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(base + 2 * (STAGES * STAGE_BYTES + DIST_BYTES)) + 2 * STAGES * team;
  uint64_t* empty = full + STAGES;
  // the block's items, and the steps of this team's (the even or odd ones)
  const long long nb = (a.items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const long long steps = (nb - team + 1) / 2 * a.nk;
  if (u == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);            // the first thread's arrive.expect_tx
      mbar_init(&empty[st], TEAM_WARPS);  // one arrive per warp of the team
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (long long g = 0; g < STAGES && g < steps; ++g) load_step(a, &tmq, &tml, ring, full, team, g);
  }
  __syncthreads();
  const int qa = u >> 4, pb = u & 15;  // the micro-tile's rows and positions
  // the selection's row and half: warp w of the team sums rows 8w..8w+7
  // and 64+8w..64+8w+7 of an item whole, and selects them itself
  const int w8 = 8 * (u >> 5), i16 = (u & 31) >> 1, h = u & 1;
  const int row = i16 < 8 ? w8 + i16 : 64 + w8 + i16 - 8;
  long long g = 0;                         // the team's next step
  for (long long j = team; j < nb; j += 2) {
    const long long w = blockIdx.x + j * gridDim.x;
    int qt, s;
    item_of(w, a, qt, s);
    float acc[8][8];
    item_sums(a, &tmq, &tml, ring, full, empty, team, qa, pb, g, steps, acc);
    const int* cols_seg = cols + (long long)s * SEG;
    const int nvalid = valid_positions(cols_seg, a.real_l);
    bool wide = false;  // a real value past the u32 keys' 2^24
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      int v[8];  // padding positions hold VAL_LIMIT
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const bool real = 4 * pb + (m & 3) + 64 * (m >> 2) < nvalid;
        v[m] = real ? (int)acc[i][m] : (int)VAL_LIMIT;
        wide |= real && v[m] >= (int)VAL_LIMIT;
      }
      int* r = sums + (4 * qa + (i & 3) + 64 * (i >> 2)) * ROW_WORDS + 4 * pb;
      *reinterpret_cast<int4*>(r) = make_int4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<int4*>(r + 64) = make_int4(v[4], v[5], v[6], v[7]);
    }
    wide = __any_sync(0xFFFFFFFFu, wide);  // and the warp's rows are whole
    const long long r = (long long)qt * TQ + row;
    const int worst = select_pair<CAPL>(sums + row * ROW_WORDS, h, nvalid, wide, a.cap, a.big,
                                        TableCols{cols_seg}, out + (r * a.nseg + s) * a.cap,
                                        r < a.rows);
    if (h == 0 && r < a.rows) atomicMin(s_min + r, worst);
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

// The tensor map of an f32 array of `rank` dims (innermost first, 16-byte
// aligned strides), boxes of 128 x KT (x 1), no swizzle, zeros past the
// ends.
bool tensor_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                const cuuint64_t* strides) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint32_t box[3] = {TQ, KT, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int CAPL>
cudaError_t launch(const CUtensorMap& tmq, const CUtensorMap& tml, const Args& a,
                   const int* cols, unsigned long long* out, int* s_min, int grid,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      coarse_topcap_kernel<CAPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  coarse_topcap_kernel<CAPL><<<grid, NT, SMEM_BYTES, stream>>>(tmq, tml, a, cols, out, s_min);
  return cudaGetLastError();
}

// The FP32 rate of K9's inner step: 16 independent chains a thread, each
// step d = a - y, a += |d| (an FADD and an FADD with |.|).
__global__ void __launch_bounds__(256) fadd_rate_kernel(float* out, float y0, float y1,
                                                        int iters) {
  float a[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = (float)(threadIdx.x + i);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 16; ++i) a[i] += fabsf(a[i] - y0);
#pragma unroll
    for (int i = 0; i < 16; ++i) a[i] += fabsf(a[i] - y1);
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s += a[i];
  if (s == -1.f) out[0] = s;  // never true; keeps the chains live
}

// The packed 16-bit probe: one `vabsdiff2.u32.u32.u32.add` a step, two
// (row, position, coordinate) pairs of u16 halves summed into a u32, 16
// independent chains a thread. Whether it is one SASS instruction, and at
// what rate, decided whether K9 takes packed u16 operands.
__global__ void __launch_bounds__(256) vabsdiff2_rate_kernel(unsigned* out, unsigned y0,
                                                             unsigned y1, int iters) {
  unsigned a[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = threadIdx.x * 0x10001u + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      asm("vabsdiff2.u32.u32.u32.add %0, %0, %1, %0;" : "+r"(a[i]) : "r"(y0));
#pragma unroll
    for (int i = 0; i < 16; ++i)
      asm("vabsdiff2.u32.u32.u32.add %0, %0, %1, %0;" : "+r"(a[i]) : "r"(y1));
  }
  unsigned s = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) s += a[i];
  if (s == 1u) out[0] = s;  // (almost) never true; keeps the chains live
}

// The selection's integer min/max rate: 4 sorted lists of 4 keys a
// thread, each step inserting a new key x = l[3] ^ y into each list
// branch-free as the selection does (7 VIMNMX and one LOP3 a list).
__global__ void __launch_bounds__(256) vimnmx_rate_kernel(unsigned* out, unsigned y0,
                                                          unsigned y1, int iters) {
  unsigned l[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) l[i][j] = threadIdx.x * 16u + 4 * i + j;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const unsigned y = (s & 1) ? y1 : y0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned x = l[i][3] ^ y;
#pragma unroll
        for (int j = 3; j > 0; --j) l[i][j] = max(l[i][j - 1], min(l[i][j], x));
        l[i][0] = min(l[i][0], x);
      }
    }
  }
  unsigned t = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) t += l[i][j];
  if (t == 1u) out[0] = t;  // (almost) never true; keeps the lists live
}

}  // namespace

extern "C" {

// xt [dout, rpad] f32, lib [nseg, dout, 128] f32, cols [nseg*128] int32
// (growing within each segment), all contiguous and 16-byte aligned; out
// [rows, nseg*cap] int64; s_min [rows] int32 filled with INT_MAX. rpad is
// a multiple of 128 and at least rows; 1 <= cap <= 128. `items`, `grid`,
// `steps` and `smem_bytes` are the launch plan (ops/distance.py
// `_k9_plan`): one item per (query tile, segment), one block an SM or one
// an item, whichever is fewer, ceil(dout / 16) steps an item; a plan that
// does not match this kernel is refused. Returns the CUDA error code (0 on
// success).
int emosaic_coarse_topcap(int device, const void* xt, const void* lib, const void* cols,
                          void* out, void* s_min, long long rows, long long rpad, int dout,
                          int nseg, int cap, long long real_l, int big, long long items,
                          int grid, int steps, int smem_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (smem_bytes != SMEM_BYTES || rows < 0 || rpad % TQ || rpad < rows || rpad > INT_MAX ||
      dout < 1 || nseg < 1 || cap < 1 || cap > SEG || items != rpad / TQ * nseg ||
      grid != (int)min((long long)sms, items) || steps != (dout + KT - 1) / KT)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tmq, tml;
  const cuuint64_t qdims[2] = {(cuuint64_t)rpad, (cuuint64_t)dout};
  const cuuint64_t qstrides[1] = {(cuuint64_t)rpad * 4};
  const cuuint64_t ldims[3] = {(cuuint64_t)SEG, (cuuint64_t)dout, (cuuint64_t)nseg};
  const cuuint64_t lstrides[2] = {(cuuint64_t)SEG * 4, (cuuint64_t)dout * SEG * 4};
  if (!tensor_map(&tmq, xt, 2, qdims, qstrides) || !tensor_map(&tml, lib, 3, ldims, lstrides))
    return (int)cudaErrorInvalidValue;
  const Args a{rows, real_l, items, dout, steps, nseg, (int)(rpad / TQ), cap, big};
  const int* c = (const int*)cols;
  auto* o = (unsigned long long*)out;
  int* sm = (int*)s_min;
  cudaStream_t st = (cudaStream_t)stream;
  switch (list_len(cap)) {
    case 1: err = launch<1>(tmq, tml, a, c, o, sm, grid, st); break;
    case 2: err = launch<2>(tmq, tml, a, c, o, sm, grid, st); break;
    case 4: err = launch<4>(tmq, tml, a, c, o, sm, grid, st); break;
    case 8: err = launch<8>(tmq, tml, a, c, o, sm, grid, st); break;
    case 16: err = launch<16>(tmq, tml, a, c, o, sm, grid, st); break;
    case 32: err = launch<32>(tmq, tml, a, c, o, sm, grid, st); break;
    default: err = launch<0>(tmq, tml, a, c, o, sm, grid, st); break;
  }
  return (int)err;
}

// Launch the FP32-rate probe: `blocks` x 256 threads, `iters` steps of 32
// (row, position) pairs a thread. Returns the CUDA error code.
int emosaic_fadd_rate(int device, void* out, int blocks, int iters, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  fadd_rate_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>((float*)out, 1.f, 2.f, iters);
  return (int)cudaGetLastError();
}

// Launch the packed 16-bit probe: `blocks` x 256 threads, `iters` steps of
// 32 instructions (64 pairs) a thread. Returns the CUDA error code.
int emosaic_vabsdiff2_rate(int device, void* out, int blocks, int iters, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  vabsdiff2_rate_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>((unsigned*)out, 0x00050003u,
                                                                  0x00020007u, iters);
  return (int)cudaGetLastError();
}

// Launch the integer min/max probe: `blocks` x 256 threads, `iters` steps of
// 112 VIMNMX a thread. Returns the CUDA error code.
int emosaic_vimnmx_rate(int device, void* out, int blocks, int iters, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  vimnmx_rate_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>((unsigned*)out, 0x5bd1e995u,
                                                               0x27d4eb2fu, iters);
  return (int)cudaGetLastError();
}

const char* emosaic_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
