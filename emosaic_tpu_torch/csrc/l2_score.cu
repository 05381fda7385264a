// K11: exact squared L2 distances of u8 query rows against u8 library
// rows on the tensor cores, with two entry points that share one product
// core:
//
// - `emosaic_l2_argmin`: per query row, the least squared distance and the
//   lowest library row among equal ones, folded as a u64 key
//   (dist2 << 32) | row by atomicMin into a [rows] array the caller presets
//   to ~0;
// - `emosaic_l2_topcap`: the two-level top-k's stage 1 under squared L2:
//   for each contiguous segment of `seg` library rows (128, 256, 512 or
//   1024), the `cap` least keys ((dist2 - bias) << 32) | col, col = col0 +
//   seg * s + position, ascending, the lowest col first among equal
//   distances, as int64 [rows, nseg, cap]. Positions at or past `vlim`
//   (the library's end or the caller's real_l) are padding and keep the key
//   (INT_MAX << 32) | col. `bias` is 0, or 2^31 where dist2 may pass 2^31
//   (rows wider than 33024 bytes), so the high word keeps the order as a
//   signed int.
//
// Neither writes the [rows, L] score stripe. They replace, on the card,
// the f32 `torch.matmul` stripes of the port's L2 matchers with their
// argmin and their packed-key `torch.topk` (ops/distance.py `l2_argmin`,
// `_l2_prefilter`). The JAX package computes the same functions with
// XLA, not a Pallas kernel: `_l2_argmin_jit` (a bf16 product with f32
// accumulation, then an argmin) and `_mxu_prefilter_jit` (the same
// product, then `jax.lax.approx_min_k`), emosaic_tpu/ops/distance.py.
//
// Arithmetic, exact: dist2 = |x|^2 + |t|^2 - 2 x.t. The dot runs on the
// tensor cores as `mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32`,
// exact while 255^2 * D < 2^31 (D <= 33025, every mode up to 64). Rows
// are zero-padded by the caller to a multiple of 32 bytes (zeros change no
// dot). Past 33024 bytes (mode 128) the depth splits in two halves: the
// first half's s32 sums are offset by -2^31 before the second half
// accumulates onto them, so neither half overflows, and dot = acc + 2^31.
// dist2 <= 255^2 * D < 2^32 for D <= 66051, so the epilogue's u32
// arithmetic, modulo 2^32, gives dist2 exactly either way. The norms come
// from the caller, as u32 (their low 32 bits).
//
// What bounds it on an H100, and the design. Both entries stream library
// tiles through a 3-stage `cp.async` ring of 32-byte slices (one k-step),
// read the fragments with `ldmatrix`, and keep 64 s32 sums a thread
// (sixteen warps, a 64 x 32 or 32 x 64 warp tile; at most 128 registers,
// so the 16 warps fit an SM). At small D (mode 4, 48 bytes) the product
// is two k-steps and the epilogue and selection set the pace; at large D
// (the flagship, 3072 bytes) the product does.
//
// - The argmin, for rows of at most 128 padded bytes, folds one packed key
//   a score: v = 8 (|t|^2 - 2 x.t) + lcol = colterm - 16 x.t (one IMAD;
//   the column term |t|^2 * 8 + lcol comes from shared memory, lcol is the
//   score's index among the thread's 8 columns of the tile) and a signed
//   min; |x|^2 is constant along the row and is added after the min. After
//   each 256-row library tile a thread keeps, per row, the tile of its
//   least v (a strictly less compare of v | 7, so an earlier tile keeps
//   equal distances). Wider rows compute dist2 and keep (dist2, col) with a
//   strictly less compare in ascending column order: where the product
//   sets the pace, this plain compare is the faster of the two. A block
//   takes a 128-row query tile and a run of library tiles; the ring runs
//   on across tiles, so the next tile's slices land during this tile's
//   epilogue. The quad of threads
//   that share a row folds their keys by shuffles, and one atomicMin a row
//   and warp column folds the block's key into the output.
// - The top-cap gives a block one (query tile, segment) item, BM x seg =
//   32768 scores: the whole segment in one pass of the product. The sums
//   become dist2 in a u32 [BM, seg + 8] tile in shared memory (over the
//   ring), and a warp selects a row: each lane takes the least (dist2,
//   position) of its group of seg / 32 positions (16-byte loads, four
//   independent chains); the cap least of the 32 group minima (each
//   minimum's rank among them, by shuffles) are the groups that can hold
//   the segment's cap least keys (any key of another group has cap smaller
//   keys ahead of it), and their cap-th, tau, bounds them; the positions of
//   those groups at or below tau are gathered and each is placed by its
//   rank among them (by shuffles while they fit a warp). Most scores cost a
//   store, a load and a compare; no position is inserted into a sorted
//   list. A cap above 32 takes every position as a candidate and ranks it
//   among the whole segment (seg^2 compares a row: the prefilter's plan
//   takes it only at 128-row segments, where k_pre is a large share of the
//   library, and to keep a segment whole). For rows of at most 64 bytes (modes 2 to 5; dist2 < 2^22) the
//   epilogue stores the u32 key (dist2 << 10) | position itself (still one
//   IMAD and one add a score), so the group minima are one min a value and
//   every rank takes one 32-bit shuffle a step; wider rows keep dist2 and
//   64-bit keys.

#include <climits>
#include <type_traits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 16;        // warps a block
constexpr int NT = 32 * NW;
constexpr int KC = 32;        // bytes of a row in one stage (one k-step)
constexpr int ROWB = 48;      // a staged row's stride: 32 bytes + 16, so the
                              // eight rows of an ldmatrix hit distinct banks
constexpr int STAGES = 3;
constexpr int ARG_BM = 128;   // the argmin's query tile
constexpr int ARG_BN = 256;   // the argmin's library tile
constexpr int TN_SLOTS = 4;   // the argmin's ring of per-tile |t|^2 rows
// A tile's |t|^2 row lands in its slot with the tile's first k-step, up to
// STAGES - 1 steps ahead of the compute; at one k-step a tile (32-byte
// rows) that is STAGES - 1 tiles ahead, so a slot is reused only after the
// epilogue that reads it when the ring is shorter than the slots.
static_assert(STAGES - 1 < TN_SLOTS, "a |t|^2 slot would be overwritten before its epilogue");
constexpr int TILE_SCORES = 32768;  // BM x seg of a top-cap item
// The argmin's packed key for rows of at most this many padded bytes (it
// would fit an int up to 4128: 8 * 255^2 * dp + 7 < 2^31 - 1); wider rows
// keep (dist2, col). On an H100 the packed key is the faster at 64 and 96
// bytes, the plain compare from 384 up, and they tie at 192.
constexpr int PACKED_MAX_DP = 128;
static_assert(8ll * 255 * 255 * PACKED_MAX_DP + 7 < INT_MAX, "the packed argmin key");
constexpr int SPLIT_MIN_DP = 33056;   // 255^2 * dp >= 2^31 from here
constexpr int MAX_DP = 66080;         // rows of at most 66051 bytes
constexpr unsigned PAD = 0xFFFFFFFFu; // a padding position's dist2 (above
                                      // every real one, < 2^32 - 1)
constexpr unsigned FULL = 0xFFFFFFFFu;
// Rows of at most 64 bytes: dist2 <= 255^2 * 64 < 2^22 - 1, so the top-cap
// tile holds the u32 key (dist2 << 10) | position, and padding positions
// (2^22 - 1) << 10 | position, above every real key.
constexpr int PACKED_TOP_MAX_DP = 64;
constexpr unsigned PACKED_PAD = 0xFFFFFC00u;

// A tile of BM query rows x BN library rows over sixteen warps, each WM
// m16 tiles x WN n8 tiles: 64 sums a thread.
template <int BM, int BN>
struct Cfg {
  static constexpr int WARPS_M = BM <= 64 ? BM / 32 : (BM == 128 ? 2 : 4);
  static constexpr int WARPS_N = NW / WARPS_M;
  static constexpr int WM = BM / (16 * WARPS_M);
  static constexpr int WN = BN / (8 * WARPS_N);
  static constexpr int STAGE = (BM + BN) * ROWB;
  static constexpr int RING = STAGES * STAGE;
  static_assert(WM * WN * 4 == 64 && WN % 2 == 0, "tile shape");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes into shared memory; the bytes past `bytes` (0..16) are zeros.
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 16-byte matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and lane L receives bytes 4 (L % 4)..+3 of row L / 4 of each.
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One stage: k-slice [k0, k0 + 32) of query rows q0.. (BM of them) and of
// library rows c0.. (BN), rows past `rows` / `l` zero-filled.
template <int BM, int BN>
__device__ __forceinline__ void load_stage(uint8_t* st, const uint8_t* __restrict__ x,
                                           long long q0, long long rows,
                                           const uint8_t* __restrict__ t, long long c0,
                                           long long l, int dp, int k0) {
  constexpr int CH = 2 * (BM + BN);
  for (int c = threadIdx.x; c < CH; c += NT) {
    const int r = c >> 1, h = c & 1;
    const uint8_t* src;
    bool ok;
    if (r < BM) {
      const long long g = q0 + r;
      ok = g < rows;
      src = x + (ok ? g : 0) * dp;
    } else {
      const long long g = c0 + (r - BM);
      ok = g < l;
      src = t + (ok ? g : 0) * dp;
    }
    cp16(st + r * ROWB + 16 * h, src + k0 + 16 * h, ok ? 16 : 0);
  }
}

// The sums of one stage into acc: warp (wm, wn) owns rows wm * WM * 16..
// and cols wn * WN * 8.. of the tile.
template <int BM, int BN>
__device__ __forceinline__ void mma_stage(int (&acc)[Cfg<BM, BN>::WM][Cfg<BM, BN>::WN][4],
                                          const uint8_t* st, int wm, int wn, int lane) {
  using C = Cfg<BM, BN>;
  const int mi = lane >> 3, ri = lane & 7;
  unsigned a[C::WM][4];
#pragma unroll
  for (int mt = 0; mt < C::WM; ++mt)
    ldsm4(a[mt], st + ((wm * C::WM + mt) * 16 + (mi & 1) * 8 + ri) * ROWB + (mi >> 1) * 16);
#pragma unroll
  for (int np = 0; np < C::WN / 2; ++np) {
    unsigned b[4];
    ldsm4(b, st + (BM + (wn * C::WN + 2 * np + (mi >> 1)) * 8 + ri) * ROWB + (mi & 1) * 16);
#pragma unroll
    for (int mt = 0; mt < C::WM; ++mt) {
      mma(acc[mt][2 * np], a[mt], b[0], b[1]);
      mma(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
    }
  }
}

template <int BM, int BN>
__device__ __forceinline__ void zero(int (&acc)[Cfg<BM, BN>::WM][Cfg<BM, BN>::WN][4]) {
#pragma unroll
  for (int mt = 0; mt < Cfg<BM, BN>::WM; ++mt)
#pragma unroll
    for (int nt = 0; nt < Cfg<BM, BN>::WN; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
}

// The depth split past SPLIT_MIN_DP: offset the first half's sums by -2^31.
template <int BM, int BN>
__device__ __forceinline__ void offset(int (&acc)[Cfg<BM, BN>::WM][Cfg<BM, BN>::WN][4]) {
#pragma unroll
  for (int mt = 0; mt < Cfg<BM, BN>::WM; ++mt)
#pragma unroll
    for (int nt = 0; nt < Cfg<BM, BN>::WN; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = (int)((unsigned)acc[mt][nt][i] + 0x80000000u);
}

__device__ __forceinline__ unsigned long long key64(unsigned v, unsigned p) {
  return ((unsigned long long)v << 32) | p;
}

__device__ __forceinline__ int split_step(int dp) {
  return dp >= SPLIT_MIN_DP ? dp / KC / 2 : -1;
}

// ---------------------------------------------------------------------------
// The argmin
// ---------------------------------------------------------------------------

constexpr int ARG_SMEM = Cfg<ARG_BM, ARG_BN>::RING + TN_SLOTS * ARG_BN * 4 + ARG_BM * 4;

// Block b takes query tile b % nqt and library tiles [tps * (b / nqt), ...),
// so the blocks in flight read the same library tiles.
template <bool WIDE>
__global__ void __launch_bounds__(NT, 1)
    l2_argmin_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ t,
                     const unsigned* __restrict__ xn, const unsigned* __restrict__ tn,
                     unsigned long long* __restrict__ out, long long rows, long long l, int dp,
                     int nqt, long long tps) {
  using C = Cfg<ARG_BM, ARG_BN>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* ring = smem;
  unsigned* tn_s = reinterpret_cast<unsigned*>(smem + C::RING);
  unsigned* xn_s = tn_s + TN_SLOTS * ARG_BN;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  const int g = lane >> 2, tq = lane & 3;
  const long long q0 = (long long)(blockIdx.x % nqt) * ARG_BM;
  const long long ntl = (l + ARG_BN - 1) / ARG_BN;
  const long long tile0 = (long long)(blockIdx.x / nqt) * tps;
  const int ntile = (int)min(tps, ntl - tile0);
  const int nk = dp / KC, half = split_step(dp);
  const int steps = ntile * nk;

  for (int r = threadIdx.x; r < ARG_BM; r += NT) xn_s[r] = q0 + r < rows ? xn[q0 + r] : 0u;

  // step s: k-slice s % nk of library tile tile0 + s / nk; a tile's first
  // step also brings its |t|^2 row into slot (s / nk) % TN_SLOTS
  auto load = [&](int s) {
    const int tl = s / nk, kc = s % nk;
    const long long c0 = (tile0 + tl) * ARG_BN;
    load_stage<ARG_BM, ARG_BN>(ring + (s % STAGES) * C::STAGE, x, q0, rows, t, c0, l, dp,
                               kc * KC);
    if (kc == 0 && threadIdx.x < ARG_BN / 4) {
      const long long gc = c0 + 4 * threadIdx.x;
      const long long n = l - gc;
      cp16(tn_s + (tl % TN_SLOTS) * ARG_BN + 4 * threadIdx.x, tn + (n > 0 ? gc : 0),
           n >= 4 ? 16 : (n > 0 ? 4 * (int)n : 0));
    }
  };

  int acc[C::WM][C::WN][4];
  // per row of the thread (mt, h): the packed path's running least v and
  // its tile, or the wide path's (dist2, col)
  int best[C::WM][2];
  int where[C::WM][2];
#pragma unroll
  for (int mt = 0; mt < C::WM; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best[mt][h] = WIDE ? (int)PAD : INT_MAX;
      where[mt][h] = -1;
    }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s);
    commit();
  }
  for (int s = 0; s < steps; ++s) {
    wait_groups<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < steps) load(s + STAGES - 1);
    commit();
    const int tl = s / nk, kc = s % nk;
    if (kc == 0) zero<ARG_BM, ARG_BN>(acc);
    if (kc == half) offset<ARG_BM, ARG_BN>(acc);
    mma_stage<ARG_BM, ARG_BN>(acc, ring + (s % STAGES) * C::STAGE, wm, wn, lane);
    if (kc != nk - 1) continue;

    // the epilogue of tile tl
    const unsigned* tnt = tn_s + (tl % TN_SLOTS) * ARG_BN;
    const long long c0 = (tile0 + tl) * ARG_BN;
    int m[C::WM][2];
#pragma unroll
    for (int mt = 0; mt < C::WM; ++mt) m[mt][0] = m[mt][1] = INT_MAX;
#pragma unroll
    for (int nt = 0; nt < C::WN; ++nt) {
      const int cl = (wn * C::WN + nt) * 8 + 2 * tq;
      const uint2 tt = *reinterpret_cast<const uint2*>(tnt + cl);
      const bool ok0 = c0 + cl < l, ok1 = c0 + cl + 1 < l;
      if constexpr (!WIDE) {
        // padding columns read zeros, so v = colterm: INT_MAX never wins
        const unsigned ct0 = ok0 ? tt.x * 8u + 2 * nt : (unsigned)INT_MAX;
        const unsigned ct1 = ok1 ? tt.y * 8u + 2 * nt + 1 : (unsigned)INT_MAX;
#pragma unroll
        for (int mt = 0; mt < C::WM; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int v0 = (int)(ct0 - 16u * (unsigned)acc[mt][nt][2 * h]);
            const int v1 = (int)(ct1 - 16u * (unsigned)acc[mt][nt][2 * h + 1]);
            m[mt][h] = min(m[mt][h], min(v0, v1));
          }
      } else {
        const int col = (int)(c0 + cl);
#pragma unroll
        for (int mt = 0; mt < C::WM; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const unsigned xr = xn_s[(wm * C::WM + mt) * 16 + g + 8 * h];
            const unsigned d0 = xr + tt.x - 2u * (unsigned)acc[mt][nt][2 * h];
            const unsigned d1 = xr + tt.y - 2u * (unsigned)acc[mt][nt][2 * h + 1];
            if (ok0 && d0 < (unsigned)best[mt][h]) {
              best[mt][h] = (int)d0;
              where[mt][h] = col;
            }
            if (ok1 && d1 < (unsigned)best[mt][h]) {
              best[mt][h] = (int)d1;
              where[mt][h] = col + 1;
            }
          }
      }
    }
    if constexpr (!WIDE) {
#pragma unroll
      for (int mt = 0; mt < C::WM; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if ((m[mt][h] | 7) < best[mt][h]) {
            best[mt][h] = m[mt][h];
            where[mt][h] = tl;
          }
    }
  }
  wait_groups<0>();

#pragma unroll
  for (int mt = 0; mt < C::WM; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (wm * C::WM + mt) * 16 + g + 8 * h;
      unsigned long long key = ~0ull;
      if (where[mt][h] >= 0) {
        unsigned dist;
        long long col;
        if constexpr (!WIDE) {
          const int v = best[mt][h], lc = v & 7;
          dist = (unsigned)((v >> 3) + (int)xn_s[r]);
          col = (tile0 + where[mt][h]) * ARG_BN + (wn * C::WN + (lc >> 1)) * 8 + 2 * tq + (lc & 1);
        } else {
          dist = (unsigned)best[mt][h];
          col = where[mt][h];
        }
        key = ((unsigned long long)dist << 32) | (unsigned long long)col;
      }
      key = min(key, __shfl_xor_sync(FULL, key, 1));
      key = min(key, __shfl_xor_sync(FULL, key, 2));
      if (tq == 0 && q0 + r < rows) atomicMin(out + q0 + r, key);
    }
}

// ---------------------------------------------------------------------------
// The top-cap
// ---------------------------------------------------------------------------

template <int SEG>
struct Top {
  static constexpr int BM = TILE_SCORES / SEG;
  using C = Cfg<BM, SEG>;
  static constexpr int DROW = SEG + 8;  // u32 words a row of the dist2 tile:
                                        // the 8-byte stores of a half-warp
                                        // (4 rows) hit distinct banks
  static constexpr int DTILE = BM * DROW * 4;
  static constexpr int MAIN = C::RING > DTILE ? C::RING : DTILE;
  static constexpr int SMEM = MAIN + (BM + SEG) * 4 + NW * SEG * 2;
  static constexpr int VPG = SEG / 32;  // positions of a lane's group
  static constexpr int GPI = 32 / VPG;  // groups a warp gathers at once
  static constexpr int QG = 8;          // query tiles of an item group
};

// The output key of a tile value: ((dist2 - bias) << 32) | col, or
// (INT_MAX << 32) | col for padding.
template <bool PACKED>
__device__ __forceinline__ unsigned long long out_key(unsigned v, long long col,
                                                      unsigned bias) {
  const bool pad = PACKED ? v >= PACKED_PAD : v == PAD;
  const unsigned hi = pad ? (unsigned)INT_MAX : (PACKED ? v >> 10 : v) - bias;
  return ((unsigned long long)hi << 32) | (unsigned long long)(unsigned)col;
}

// Item w: groups of QG query tiles, segment by segment within a group (the
// last group may be narrower), so the blocks in flight share segments and
// a few query tiles stay in L2.
template <int SEG, bool PACKED>
__global__ void __launch_bounds__(NT, 1)
    l2_topcap_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ t,
                     const unsigned* __restrict__ xn, const unsigned* __restrict__ tn,
                     unsigned long long* __restrict__ out, long long rows, long long l, int dp,
                     int nqt, int nseg, int cap, long long col0, long long vlim,
                     unsigned bias) {
  using K = Top<SEG>;
  using C = typename K::C;
  constexpr int BM = K::BM;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* ring = smem;
  unsigned* dt = reinterpret_cast<unsigned*>(smem);  // after the product, over the ring
  unsigned* xn_s = reinterpret_cast<unsigned*>(smem + K::MAIN);
  unsigned* tn_s = xn_s + BM;
  uint16_t* cb = reinterpret_cast<uint16_t*>(tn_s + SEG);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  const int g = lane >> 2, tq = lane & 3;
  const int w = blockIdx.x;
  const int grp = w / (K::QG * nseg), rem = w % (K::QG * nseg);
  const int gq = min(K::QG, nqt - grp * K::QG);
  const int qt = grp * K::QG + rem % gq, s = rem / gq;
  const long long q0 = (long long)qt * BM, c0 = (long long)s * SEG;

  for (int r = threadIdx.x; r < BM; r += NT) xn_s[r] = q0 + r < rows ? xn[q0 + r] : 0u;
  for (int c = threadIdx.x; c < SEG; c += NT) tn_s[c] = c0 + c < l ? tn[c0 + c] : 0u;

  // the product of the whole item (its first barrier publishes xn_s, tn_s)
  int acc[C::WM][C::WN][4];
  zero<BM, SEG>(acc);
  const int nk = dp / KC, half = split_step(dp);
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < nk) load_stage<BM, SEG>(ring + k * C::STAGE, x, q0, rows, t, c0, l, dp, k * KC);
    commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    wait_groups<STAGES - 2>();
    __syncthreads();
    const int nx = kc + STAGES - 1;
    if (nx < nk) load_stage<BM, SEG>(ring + (nx % STAGES) * C::STAGE, x, q0, rows, t, c0, l, dp,
                                     nx * KC);
    commit();
    if (kc == half) offset<BM, SEG>(acc);
    mma_stage<BM, SEG>(acc, ring + (kc % STAGES) * C::STAGE, wm, wn, lane);
  }
  wait_groups<0>();
  __syncthreads();  // every warp is done with the ring: dt may overwrite it

  // the tile: dist2, or with PACKED the u32 key (dist2 << 10) | position
  // (padding: PAD, or PACKED_PAD | position)
#pragma unroll
  for (int nt = 0; nt < C::WN; ++nt) {
    const int cl = (wn * C::WN + nt) * 8 + 2 * tq;
    const bool ok0 = c0 + cl < vlim, ok1 = c0 + cl + 1 < vlim;
    // PACKED: (|x|^2 + |t|^2 - 2 x.t) * 1024 + cl = IMAD(x.t, -2048, ct) + xr
    const unsigned sh = PACKED ? 10 : 0;
    const unsigned ct0 = (tn_s[cl] << sh) + (PACKED ? cl : 0);
    const unsigned ct1 = (tn_s[cl + 1] << sh) + (PACKED ? cl + 1 : 0);
    const unsigned pad0 = PACKED ? PACKED_PAD | cl : PAD;
    const unsigned pad1 = PACKED ? PACKED_PAD | (cl + 1) : PAD;
#pragma unroll
    for (int mt = 0; mt < C::WM; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (wm * C::WM + mt) * 16 + g + 8 * h;
        const unsigned xr = xn_s[r] << sh;
        const unsigned d0 = xr + ct0 - (2u << sh) * (unsigned)acc[mt][nt][2 * h];
        const unsigned d1 = xr + ct1 - (2u << sh) * (unsigned)acc[mt][nt][2 * h + 1];
        *reinterpret_cast<uint2*>(dt + r * K::DROW + cl) =
            make_uint2(ok0 ? d0 : pad0, ok1 ? d1 : pad1);
      }
  }
  __syncthreads();

  // the selection, a warp a row; a key orders (dist2, position): the u32
  // tile value with PACKED, else key64(dist2, position)
  using Key = typename std::conditional<PACKED, unsigned, unsigned long long>::type;
  auto key_at = [&](const unsigned* v, unsigned p) -> Key {
    if constexpr (PACKED) return v[p];
    else return key64(v[p], p);
  };
  uint16_t* cbw = cb + warp * SEG;
  const int sl = lane / K::VPG, vi = lane % K::VPG;
  for (int r = warp; r < BM; r += NW) {
    if (q0 + r >= rows) break;
    const unsigned* v = dt + r * K::DROW;
    // this lane's group: positions 128 j + 4 lane + e; its least key, over
    // four chains (one an e), merged
    Key gk;
    if constexpr (PACKED) {
      unsigned m4[4] = {FULL, FULL, FULL, FULL};
#pragma unroll
      for (int j = 0; j < SEG / 128; ++j) {
        const uint4 q = *reinterpret_cast<const uint4*>(v + 128 * j + 4 * lane);
        m4[0] = min(m4[0], q.x);
        m4[1] = min(m4[1], q.y);
        m4[2] = min(m4[2], q.z);
        m4[3] = min(m4[3], q.w);
      }
      gk = min(min(m4[0], m4[1]), min(m4[2], m4[3]));
    } else {
      unsigned cv[4];
      int cp[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        cv[e] = PAD;
        cp[e] = 4 * lane + e;
      }
#pragma unroll
      for (int j = 0; j < SEG / 128; ++j) {
        const uint4 q = *reinterpret_cast<const uint4*>(v + 128 * j + 4 * lane);
        const unsigned e4[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (e4[e] < cv[e]) {
            cv[e] = e4[e];
            cp[e] = 128 * j + 4 * lane + e;
          }
      }
      gk = key64(cv[0], cp[0]);
#pragma unroll
      for (int e = 1; e < 4; ++e) gk = min(gk, key64(cv[e], cp[e]));
    }
    // each group minimum's rank among the 32 (the keys are distinct): the
    // cap least are the chosen groups, and tau is the cap-th; a cap above
    // 32 chooses every group, and tau lies above every key
    Key tk = (Key)~0ull;
    unsigned mm = FULL;
    if (cap <= 32) {
      int rank = 0;
#pragma unroll
      for (int m = 0; m < 32; ++m) rank += __shfl_sync(FULL, gk, m) < gk;
      tk = __shfl_sync(FULL, gk, __ffs(__ballot_sync(FULL, rank == cap - 1)) - 1);
      mm = __ballot_sync(FULL, rank < cap);
    }
    // the chosen groups' positions at or below tau, GPI groups at a time
    int n = 0;
    for (int it = 0; it < min(cap, 32); it += K::GPI) {
      unsigned mk = mm;
      for (int k = 0; k < sl; ++k) mk &= mk - 1;
#pragma unroll
      for (int k = 0; k < K::GPI; ++k) mm &= mm - 1;
      bool cand = false;
      unsigned p = 0;
      if (mk) {
        p = 128 * (vi >> 2) + 4 * (__ffs(mk) - 1) + (vi & 3);
        cand = key_at(v, p) <= tk;
      }
      const unsigned bal = __ballot_sync(FULL, cand);
      if (cand) cbw[n + __popc(bal & ((1u << lane) - 1))] = (uint16_t)p;
      n += __popc(bal);
    }
    __syncwarp();
    // each candidate's rank among them (n >= cap: the chosen minima), by
    // shuffles while they fit the warp
    unsigned long long* o = out + ((q0 + r) * nseg + s) * cap;
    if (n <= 32) {
      const unsigned p = lane < n ? cbw[lane] : 0u;
      const Key ck = lane < n ? key_at(v, p) : (Key)~0ull;
      int rk = 0;
      for (int e = 0; e < n; ++e) rk += __shfl_sync(FULL, ck, e) < ck;
      if (lane < n && rk < cap) o[rk] = out_key<PACKED>(v[p], col0 + c0 + p, bias);
    } else {
      for (int c = lane; c < n; c += 32) {
        const unsigned p = cbw[c];
        const Key ck = key_at(v, p);
        int rk = 0;
        for (int e = 0; e < n; ++e) rk += key_at(v, cbw[e]) < ck;
        if (rk < cap) o[rk] = out_key<PACKED>(v[p], col0 + c0 + p, bias);
      }
    }
    __syncwarp();
  }
}

template <int SEG>
cudaError_t launch_topcap(const uint8_t* x, const uint8_t* t, const unsigned* xn,
                          const unsigned* tn, unsigned long long* out, long long rows, long long l,
                          int dp, int nqt, int nseg, int cap, long long col0, long long vlim,
                          unsigned bias, long long items, cudaStream_t stream) {
  auto kern = dp <= PACKED_TOP_MAX_DP ? l2_topcap_kernel<SEG, true> : l2_topcap_kernel<SEG, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Top<SEG>::SMEM);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)items, NT, Top<SEG>::SMEM, stream>>>(x, t, xn, tn, out, rows, l, dp, nqt,
                                                        nseg, cap, col0, vlim, bias);
  return cudaGetLastError();
}

int topcap_smem(int seg) {
  switch (seg) {
    case 128: return Top<128>::SMEM;
    case 256: return Top<256>::SMEM;
    case 512: return Top<512>::SMEM;
    case 1024: return Top<1024>::SMEM;
    default: return -1;
  }
}

bool depth_ok(int dp) { return dp >= KC && dp % KC == 0 && dp <= MAX_DP; }

}  // namespace

extern "C" {

// x [rows, dp] u8 and t [l, dp] u8, zero-padded on the feature axis to a
// multiple of 32 bytes, contiguous and 16-byte aligned; xn [rows] and tn
// [l] their squared norms as u32 (low 32 bits), 16-byte aligned; out
// [rows] u64, preset to ~0 by the caller. `nqt`, `nsplit`, `tps` (library
// tiles a block) and `smem_bytes` are the launch plan (ops/distance.py
// `_k11_argmin_plan`, `_K11_ARG_SMEM`), refused when they do not match
// this kernel. Returns the CUDA error code (0 on success).
int emosaic_l2_argmin(int device, const void* x, const void* t, const void* xn, const void* tn,
                      void* out, long long rows, long long l, int dp, long long nqt,
                      long long nsplit, long long tps, int smem_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long ntl = (l + ARG_BN - 1) / ARG_BN;
  if (rows < 1 || l < 1 || l > INT_MAX || !depth_ok(dp) ||
      nqt != (rows + ARG_BM - 1) / ARG_BM || tps < 1 || nsplit != (ntl + tps - 1) / tps ||
      nqt * nsplit > INT_MAX || smem_bytes != ARG_SMEM)
    return (int)cudaErrorInvalidValue;
  auto kern = dp > PACKED_MAX_DP ? l2_argmin_kernel<true> : l2_argmin_kernel<false>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, ARG_SMEM);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)(nqt * nsplit), NT, ARG_SMEM, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (const uint8_t*)t, (const unsigned*)xn, (const unsigned*)tn,
      (unsigned long long*)out, rows, l, dp, (int)nqt, tps);
  return (int)cudaGetLastError();
}

// x, t, xn, tn as for `emosaic_l2_argmin`; out [rows, nseg, cap] int64,
// nseg = ceil(l / seg), seg one of 128, 256, 512, 1024, 1 <= cap <= seg.
// The col of library row j is col0 + j; positions j >= vlim (0 <= vlim <=
// l) are padding. bias is 2^31 for dp >= 33056, else 0. `nqt` (query tiles
// of 32768 / seg rows), `items` (nqt * nseg) and `smem_bytes` are the plan
// (`_k11_topcap_launch`, `_k11_topcap_smem`). Returns the CUDA error code.
int emosaic_l2_topcap(int device, const void* x, const void* t, const void* xn, const void* tn,
                      void* out, long long rows, long long l, int dp, int seg, int cap,
                      long long col0, long long vlim, long long bias, long long nqt,
                      long long items, int smem_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int smem = topcap_smem(seg);
  if (smem < 0 || rows < 1 || l < 1 || !depth_ok(dp) || cap < 1 || cap > seg)
    return (int)cudaErrorInvalidValue;
  const long long bm = TILE_SCORES / seg, nseg = (l + seg - 1) / seg;
  if (nqt != (rows + bm - 1) / bm || items != nqt * nseg || items > INT_MAX ||
      smem_bytes != smem || col0 < 0 || col0 + nseg * seg > INT_MAX || vlim < 0 || vlim > l ||
      bias != (dp >= SPLIT_MIN_DP ? (1ll << 31) : 0))
    return (int)cudaErrorInvalidValue;
  const auto* xq = (const uint8_t*)x;
  const auto* tq = (const uint8_t*)t;
  const auto* xnq = (const unsigned*)xn;
  const auto* tnq = (const unsigned*)tn;
  auto* o = (unsigned long long*)out;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned b = (unsigned)bias;
  switch (seg) {
    case 128:
      err = launch_topcap<128>(xq, tq, xnq, tnq, o, rows, l, dp, (int)nqt, (int)nseg, cap, col0,
                               vlim, b, items, st);
      break;
    case 256:
      err = launch_topcap<256>(xq, tq, xnq, tnq, o, rows, l, dp, (int)nqt, (int)nseg, cap, col0,
                               vlim, b, items, st);
      break;
    case 512:
      err = launch_topcap<512>(xq, tq, xnq, tnq, o, rows, l, dp, (int)nqt, (int)nseg, cap, col0,
                               vlim, b, items, st);
      break;
    default:
      err = launch_topcap<1024>(xq, tq, xnq, tnq, o, rows, l, dp, (int)nqt, (int)nseg, cap, col0,
                                vlim, b, items, st);
      break;
  }
  return (int)err;
}

const char* emosaic_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
