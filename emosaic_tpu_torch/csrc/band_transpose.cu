// K8: the band relayout of gathered tiles.
//
// Replaces the TPU lab kernel `tr_kernel`
// (tools/tpu_bench_composite_variants.py), the kernel half of its "v3d"
// composite: the tile gather is XLA outside the kernel (here
// `index_select`), and the kernel lays the gathered tiles
// sel [nby * nbx, ts, w] u8 out as the band [nby * ts, nbx * w] u8 (w =
// ts * 3 bytes of a tile row): band row by * ts + r is tile row r of tiles
// (by, 0), ..., (by, nbx - 1), side by side.
//
// What bounds it on an H100: device-memory bandwidth, the gathered tiles
// read once and the band written once. The TPU kernel moves (CH, 8 rows,
// 96 bytes) slabs through VMEM; here each thread copies pieces straight
// through, as K2 does: neighbouring threads write neighbouring pieces of a
// band row, so stores coalesce, and each tile row is read in whole pieces.
// The piece is 16 bytes where w and both pointers allow it, else 8, 4 or 1.
// Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void band_transpose_kernel(const V* __restrict__ sel,
                                      V* __restrict__ out, int nby, int nbx,
                                      int ts, int seg) {
  // seg: the pieces of one tile row
  const long long h = (long long)nby * ts;
  const long long row_pieces = (long long)nbx * seg;
  const long long tile_pieces = (long long)ts * seg;
  for (long long y = blockIdx.y; y < h; y += gridDim.y) {
    const long long by = y / ts;
    const long long r = y - by * ts;
    V* dst = out + y * row_pieces;
    const V* src = sel + by * nbx * tile_pieces + r * seg;
    for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         j < row_pieces; j += (long long)gridDim.x * blockDim.x) {
      const long long bx = j / seg;
      dst[j] = src[bx * tile_pieces + (j - bx * seg)];
    }
  }
}

template <typename V>
void launch(const void* sel, void* out, int nby, int nbx, int ts, int w,
            cudaStream_t s) {
  const int seg = w / (int)sizeof(V);
  const long long h = (long long)nby * ts;
  const long long row_pieces = (long long)nbx * seg;
  const int threads = 256;
  long long gx = (row_pieces + threads - 1) / threads;
  gx = gx > 64 ? 64 : gx;
  const long long gy = h > 65535 ? 65535 : h;
  dim3 grid((unsigned)gx, (unsigned)gy);
  band_transpose_kernel<V><<<grid, threads, 0, s>>>(
      (const V*)sel, (V*)out, nby, nbx, ts, seg);
}

}  // namespace

extern "C" {

// sel [nby * nbx, ts, w] u8, out [nby * ts, nbx * w] u8, both contiguous.
// Returns cudaGetLastError().
int emosaic_band_transpose(int device, const void* sel, void* out, int nby,
                           int nbx, int ts, int w, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t align = (uintptr_t)sel | (uintptr_t)out;
  if (w % 16 == 0 && align % 16 == 0) {
    launch<uint4>(sel, out, nby, nbx, ts, w, s);
  } else if (w % 8 == 0 && align % 8 == 0) {
    launch<uint2>(sel, out, nby, nbx, ts, w, s);
  } else if (w % 4 == 0 && align % 4 == 0) {
    launch<uint32_t>(sel, out, nby, nbx, ts, w, s);
  } else {
    launch<uint8_t>(sel, out, nby, nbx, ts, w, s);
  }
  return (int)cudaGetLastError();
}

const char* emosaic_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
