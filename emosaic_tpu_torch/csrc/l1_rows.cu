// K3: exact L1 distance of each query block to its own candidate library rows.
//
// Replaces the TPU kernel `_l1_rows_kernel` (emosaic_tpu/ops/distance.py),
// the shortlist rescore of the adaptive certified top-k scorer:
// dist[i, j] = sum_d |blocks[i, d] - lib[min(cand[i, j], L - 1), d]|.
//
// What bounds it on an H100: bytes. Every (query, candidate) pair reads one
// whole library row chosen by index, and each byte costs one byte absolute
// difference, so the time is set by the rows it gathers, from L2 where the
// candidates of nearby queries repeat and from device memory otherwise. The
// design: one block per query (the candidate list split over blockIdx.y when
// B alone cannot fill the card); the query row sits in shared memory; each
// warp takes candidates in turn and its lanes read the candidate row with
// 16-byte coalesced loads, sum four bytes per `__vsadu4` as K1 does, and fold
// with warp shuffles. A row narrower than a warp's 32 x 16 bytes splits the
// warp into groups of G lanes (a power of two), one candidate per group, so
// small D keeps every lane busy. Rows are zero-padded by the caller to whole
// 16-byte vectors (|0 - 0| adds nothing), and row offsets are 64-bit, so a
// library past 4 GiB needs no banking. Every sum is below 255 * 49152 < 2^31.
//
// Left out from the TPU kernel, each because Hopper does not need it:
// - SMEM candidate chunking: each block reads its own indices from memory.
// - The 1024-lane row padding: rows are padded to 16 bytes only.
// - The bank predication: 64-bit row offsets reach every byte of the library.
// - Precision.HIGHEST: the sums are integer adds, with no matrix unit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
      for (int t = gl; t < nvec; t += g) {
        const uint4 a = sq[t];
        const uint4 c = __ldg(row + t);
        acc += __vsadu4(a.x, c.x) + __vsadu4(a.y, c.y) + __vsadu4(a.z, c.z) +
               __vsadu4(a.w, c.w);
      }
    }
    for (int off = g >> 1; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (gl == 0 && j < m) orow[j] = (int32_t)acc;
  }
}

}  // namespace

extern "C" {

// blocks [b, nvec*16] u8 and lib [l, nvec*16] u8, both zero-padded on the
// feature axis to whole 16-byte vectors and 16-byte aligned; cand [b, m]
// i32 (clamped to [0, l-1] here); out [b, m] i32. `target_blocks` is how
// many blocks fill the card: the candidates of a query are split across
// blockIdx.y until the grid reaches it. Returns cudaGetLastError().
int emosaic_l1_rows(int device, const void* blocks, const void* cand,
                    const void* lib, void* out, long long b, int m, long long l,
                    int nvec, int target_blocks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
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
