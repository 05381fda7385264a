// K4: the per-segment top-cap of a segment-major distance stripe.
//
// Replaces the TPU kernel `_seg8_kernel` (tools/tpu_r14_seg8.py), the
// segment selection of the adaptive scorer's coarse pass: the int32 stripe
// dist [r, nseg*128] is segment-major (position s*128 + k holds library row
// cols[s*128 + k]); each segment keeps its `cap` least (value, col) pairs,
// ascending, the lowest col first among equal values, written as packed
// keys (value << 32) | col into out [r, nseg*cap] int64. Positions whose
// col is at least real_l count as the value `big`. It is the function of
// `seg_topk` and of the lab probe; the coarse pass itself now runs K9
// (`coarse_topcap.cu`), which selects with the same routine
// (`seg_select.cuh`) straight from the distances it computes.
//
// What bounds it on an H100: bytes. It reads the stripe once (512 bytes a
// segment) and writes cap * 8 bytes a segment of keys; the cols stay in
// L2. The selection (`seg_select.cuh`) costs 2 * CAPL + 4 integer
// instructions a position (36 at cap 16) on the ALU pipe, which runs at
// 64 lanes an SM a clock: 2.3 ms of that pipe on the flagship stripe,
// above the stripe's 1.6 ms of bytes, so it is that pipe and the wait
// for each block's copy, not the bytes alone, that set the pace. The
// design:
// - One thread per (row, segment). The (row, segment) pairs of the stripe
//   are contiguous 512-byte chunks (pair w = row * nseg + s starts at
//   w * 128), so a block of 128 threads takes 128 consecutive chunks, one
//   contiguous 64 KB run of the stripe.
// - The run is staged into shared memory by `cp.async` (16 bytes a copy,
//   consecutive threads on consecutive addresses), each chunk at a stride
//   of 132 words so that the 16-byte reads of one chunk per thread fall in
//   distinct banks. 66 KB a block: three blocks share an SM, so one block's
//   copy overlaps the others' selection. (A persistent block per SM with a
//   two-stage ring, 192 chunks a stage, measured 5.14-5.21 ms on the
//   flagship stripe against this design's 3.89-3.98: six warps an SM
//   select too slowly; the selection, not the copy, sets the pace.)
// - Offsets are 64-bit: a stripe past 4 GiB is one call.
//
// The earlier design (one warp per segment, `cap` rounds of two
// `redux.sync` minima) was bound by those rounds' latency, at 12.6% of
// the byte bound on the flagship stripe.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "seg_select.cuh"

namespace {

using namespace seg_select;

constexpr int NT = 128;  // threads per block = (row, segment) chunks per block
constexpr int SMEM_BYTES = NT * ROW_WORDS * 4;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

template <int CAPL>
__global__ void __launch_bounds__(NT)
    seg_topcap_kernel(const int* __restrict__ dist, const int* __restrict__ cols,
                      unsigned long long* __restrict__ out, long long nchunks,
                      int nseg, int cap, long long real_l, int big) {
  extern __shared__ int4 smem4[];
  int* sv = reinterpret_cast<int*>(smem4);
  const long long w0 = (long long)blockIdx.x * NT;
  const int nc = (int)min((long long)NT, nchunks - w0);
  const int4* src = reinterpret_cast<const int4*>(dist + w0 * SEG);
  for (int i = threadIdx.x; i < nc * (SEG / 4); i += NT)
    cp_async16(sv + (i >> 5) * ROW_WORDS + (i & 31) * 4, src + i);
  asm volatile("cp.async.commit_group;\n" ::);
  const int t = threadIdx.x;
  const long long w = w0 + t;
  const int* cols_seg = cols + (long long)(w % nseg) * SEG;
  const int nvalid = t < nc ? valid_positions(cols_seg, real_l) : 0;
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  if (t < nc)
    select_segment<CAPL>(sv + t * ROW_WORDS, nvalid, cap, big, TableCols{cols_seg},
                         out + w * cap);
}

template <int CAPL>
cudaError_t launch(const int* dist, const int* cols, unsigned long long* out,
                   long long nchunks, int nseg, int cap, long long real_l, int big,
                   long long blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      seg_topcap_kernel<CAPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  seg_topcap_kernel<CAPL><<<(unsigned)blocks, NT, SMEM_BYTES, stream>>>(
      dist, cols, out, nchunks, nseg, cap, real_l, big);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dist [rows, nseg*128] int32 and cols [nseg*128] int32, both contiguous
// and 16-byte aligned, cols growing within each segment; out
// [rows, nseg*cap] int64. 1 <= cap <= 128 (checked by the caller).
// `blocks` and `smem_bytes` are the launch plan (ops/distance.py
// `_k4_plan`); a plan that does not match this kernel is refused.
// Returns the CUDA error code (0 on success).
int emosaic_seg_topcap(int device, const void* dist, const void* cols, void* out,
                       long long rows, int nseg, int cap, long long real_l, int big,
                       long long blocks, int smem_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long nchunks = rows * (long long)nseg;
  if (nchunks == 0) return 0;
  if (smem_bytes != SMEM_BYTES || blocks != (nchunks + NT - 1) / NT || blocks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int* d = (const int*)dist;
  const int* c = (const int*)cols;
  auto* o = (unsigned long long*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (list_len(cap)) {
    case 1: err = launch<1>(d, c, o, nchunks, nseg, cap, real_l, big, blocks, st); break;
    case 2: err = launch<2>(d, c, o, nchunks, nseg, cap, real_l, big, blocks, st); break;
    case 4: err = launch<4>(d, c, o, nchunks, nseg, cap, real_l, big, blocks, st); break;
    case 8: err = launch<8>(d, c, o, nchunks, nseg, cap, real_l, big, blocks, st); break;
    case 16: err = launch<16>(d, c, o, nchunks, nseg, cap, real_l, big, blocks, st); break;
    case 32: err = launch<32>(d, c, o, nchunks, nseg, cap, real_l, big, blocks, st); break;
    default: err = launch<0>(d, c, o, nchunks, nseg, cap, real_l, big, blocks, st); break;
  }
  return (int)err;
}

const char* emosaic_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
