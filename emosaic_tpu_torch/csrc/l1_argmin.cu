// K1: exact L1 nearest library row per query block, lowest row on ties.
//
// Replaces the TPU kernel `_l1_kernel` (emosaic_tpu/ops/distance.py), which
// walks a sequential (block-tile, lib-tile, d-chunk) grid with an int32
// [256, 512] VMEM accumulator and folds a running (min, row) with strict `<`.
//
// What bounds it on an H100: integer ALU throughput. L1 has no tensor-core
// form, so every query x library x byte costs one absolute difference. The
// design packs four bytes per `__vsadu4` (per-byte |a - b| summed into one
// u32), with D zero-padded to a multiple of 4 on both operands by the caller
// (|0 - 0| adds nothing). Each thread owns a 4 x 4 micro-tile of
// (query, library row) sums in registers, so every shared-memory word it
// reads feeds four SADs; the rows of the staged tiles are padded by one word
// so the 16 library rows a half-warp reads sit in 16 distinct banks.
//
// The TPU's sequential j/d grid becomes a loop over library tiles inside the
// block. Blocks run in no order, so when B alone cannot fill the SMs the
// library is split across blockIdx.y and the splits fold with atomicMin on a
// packed (uint64(dist) << 32) | row key: the minimum of those keys is the
// lowest distance and, among equal distances, the lowest row, whatever order
// the blocks finish in. Every partial sum is below 49152 * 255 < 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;   // queries per block
constexpr int TL = 64;   // library rows per inner tile
constexpr int KW = 16;   // 4-byte words of the feature axis staged per step
constexpr int NT = 256;  // threads: 16 x 16, each a 4 x 4 micro-tile
constexpr unsigned long long NO_KEY = ~0ull;

__global__ void init_keys(unsigned long long* keys, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) keys[i] = NO_KEY;
}

__device__ __forceinline__ void stage(uint32_t (*dst)[KW + 1],
                                      const uint32_t* __restrict__ src,
                                      int r0, int rows, int dw, int d0,
                                      int kw) {
  for (int i = threadIdx.x; i < 64 * KW; i += NT) {
    const int r = i / KW, k = i % KW;
    const int g = r0 + r;
    dst[r][k] = (g < rows && k < kw) ? src[(size_t)g * dw + d0 + k] : 0u;
  }
}

__global__ void __launch_bounds__(NT)
    l1_argmin_kernel(const uint32_t* __restrict__ q,
                     const uint32_t* __restrict__ lib,
                     unsigned long long* __restrict__ keys, int b, int l,
                     int dw, int tiles_per_split) {
  __shared__ uint32_t sq[TQ][KW + 1];
  __shared__ uint32_t sl[TL][KW + 1];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * TQ;
  const int ntiles = (l + TL - 1) / TL;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(ntiles, t_begin + tiles_per_split);
  // with the whole feature axis in one step, the query tile stays resident
  const bool q_resident = dw <= KW;
  if (q_resident) stage(sq, q, q0, b, dw, 0, dw);

  unsigned long long best[4] = {NO_KEY, NO_KEY, NO_KEY, NO_KEY};
  for (int t = t_begin; t < t_end; ++t) {
    const int l0 = t * TL;
    uint32_t acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0u;
    for (int d0 = 0; d0 < dw; d0 += KW) {
      const int kw = min(KW, dw - d0);
      if (!q_resident) stage(sq, q, q0, b, dw, d0, kw);
      stage(sl, lib, l0, l, dw, d0, kw);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kw; ++k) {
        uint32_t a[4], c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sq[ty + 16 * i][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = sl[tx + 16 * j][k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += __vsadu4(a[i], c[j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = l0 + tx + 16 * j;
      if (row < l) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const unsigned long long key =
              ((unsigned long long)acc[i][j] << 32) | (unsigned)row;
          best[i] = key < best[i] ? key : best[i];
        }
      }
    }
  }
  // the 16 lanes that share ty (and so the same 4 queries) sit in one
  // half-warp: fold them with xor shuffles, then one atomic per query
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, best[i], off);
      best[i] = o < best[i] ? o : best[i];
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int g = q0 + ty + 16 * i;
      if (g < b && best[i] != NO_KEY) atomicMin(&keys[g], best[i]);
    }
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

}  // namespace

extern "C" {

// blocks [b, dw*4] u8 and lib [l, dw*4] u8, both zero-padded on the feature
// axis to whole 4-byte words; keys [b] u64 scratch; dist, row [b] i32 out.
// `target_blocks` is how many blocks fill the card; the library is split
// across blockIdx.y until the grid reaches it. Returns cudaGetLastError().
int emosaic_l1_argmin(int device, const void* blocks, const void* lib,
                      void* keys, void* dist, void* row, int b, int l, int dw,
                      int target_blocks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int qtiles = (b + TQ - 1) / TQ;
  const int ntiles = (l + TL - 1) / TL;
  int nsplit = (target_blocks + qtiles - 1) / qtiles;
  nsplit = nsplit < 1 ? 1 : (nsplit > ntiles ? ntiles : nsplit);
  nsplit = nsplit > 65535 ? 65535 : nsplit;
  const int per = (ntiles + nsplit - 1) / nsplit;
  nsplit = (ntiles + per - 1) / per;
  const int lin = (int)((b + 255) / 256);
  init_keys<<<lin, 256, 0, s>>>((unsigned long long*)keys, b);
  l1_argmin_kernel<<<dim3(qtiles, nsplit), NT, 0, s>>>(
      (const uint32_t*)blocks, (const uint32_t*)lib, (unsigned long long*)keys,
      b, l, dw, per);
  unpack_keys<<<lin, 256, 0, s>>>((const unsigned long long*)keys,
                                  (int32_t*)dist, (int32_t*)row, b);
  return (int)cudaGetLastError();
}

const char* emosaic_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
