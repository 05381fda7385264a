// K2: the mosaic band composite, a fused gather and layout of tile rows.
//
// Replaces the TPU kernels `_dma_kernel` and `_tr_kernel`
// (emosaic_tpu/ops/composite.py). Both write the band
// [nby * ts, nbx * ts * 3] u8 from signed items [nby, nbx] i32 and the
// augmented stack [2T + 1, ts, ts * 3] u8 (originals, mirrored copies, one
// black row): +i -> row i - 1, -i -> row T + i - 1, clipped to [0, 2T - 1],
// and 0 -> the black row 2T.
//
// What bounds it on an H100: device-memory bandwidth. Every output byte is
// one byte read from a gathered tile row and one byte written, so the least
// time is 2 * band bytes / 3.35 TB/s. The design gives each thread one
// 16-byte piece of an output row: neighbouring threads write neighbouring
// pieces, so stores coalesce, and each tile row (ts * 3 contiguous bytes) is
// read in whole 16-byte pieces. Where ts * 3 is not a multiple of 16 the
// same walk copies single bytes. All byte offsets are 64-bit: at T = 100k and
// ts = 128 the stack is 9.8 GB, and the TPU path's 4 GiB limit does not
// exist here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void compose_kernel(const int32_t* __restrict__ items,
                               const V* __restrict__ aug, V* __restrict__ out,
                               long long t, int nby, int nbx, int ts,
                               int seg) {
  // seg = ts * 3 / sizeof(V): the pieces of one tile row
  const long long h = (long long)nby * ts;
  const int row_pieces = nbx * seg;
  for (long long y = blockIdx.y; y < h; y += gridDim.y) {
    const long long by = y / ts;
    const int r = (int)(y - by * ts);
    V* dst = out + y * row_pieces;
    const int32_t* it_row = items + by * nbx;
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < row_pieces;
         j += gridDim.x * blockDim.x) {
      const int bx = j / seg;
      const int w = j - bx * seg;
      const long long it = it_row[bx];
      long long src_row;
      if (it == 0) {
        src_row = 2 * t;
      } else {
        src_row = it > 0 ? it - 1 : t - it - 1;
        src_row = src_row < 0 ? 0 : (src_row > 2 * t - 1 ? 2 * t - 1 : src_row);
      }
      dst[j] = aug[(src_row * ts + r) * seg + w];
    }
  }
}

}  // namespace

extern "C" {

// items [nby, nbx] i32, aug [2t + 1, ts, ts * 3] u8, out [nby * ts,
// nbx * ts * 3] u8. vec16 != 0 copies 16-byte pieces (ts * 3 % 16 == 0 and
// 16-byte aligned pointers, checked by the caller). Returns
// cudaGetLastError().
int emosaic_compose(int device, const void* items, const void* aug, void* out,
                    long long t, int nby, int nbx, int ts, int vec16,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int s3 = ts * 3;
  const int seg = vec16 ? s3 / 16 : s3;
  const long long h = (long long)nby * ts;
  const int row_pieces = nbx * seg;
  const int threads = 256;
  int gx = (row_pieces + threads - 1) / threads;
  gx = gx > 64 ? 64 : gx;
  const long long gy = h > 65535 ? 65535 : h;
  dim3 grid(gx, (unsigned)gy);
  if (vec16) {
    compose_kernel<uint4><<<grid, threads, 0, s>>>(
        (const int32_t*)items, (const uint4*)aug, (uint4*)out, t, nby, nbx, ts,
        seg);
  } else {
    compose_kernel<uint8_t><<<grid, threads, 0, s>>>(
        (const int32_t*)items, (const uint8_t*)aug, (uint8_t*)out, t, nby, nbx,
        ts, seg);
  }
  return (int)cudaGetLastError();
}

const char* emosaic_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
