// K4: the per-segment top-cap of the adaptive scorer's coarse pass.
//
// Replaces the TPU kernel `_seg8_kernel` (tools/tpu_r14_seg8.py), the
// segment selection of the coarse pass (`_ad_coarse`, ops/distance.py):
// the int32 stripe dist [r, nseg*128] is segment-major (position s*128 + k
// holds library row cols[s*128 + k]); each segment keeps its `cap` least
// (value, position) pairs, ascending, the lowest position first among equal
// values, written as packed keys (value << 32) | cols[position] into
// out [r, nseg*cap] int64. Positions whose col is at least real_l (the
// library's padding rows) count as the value `big`. Within a segment the
// caller's cols grow with the position, so the key order is the
// (value, lowest row) order of the plain version `_seg_topcap_ref`.
//
// What bounds it on an H100: bytes, in principle. It reads the stripe once
// (4 bytes a position) and writes cap/128 of that as keys; the cols row is
// the same for every stripe row and stays in L2. The design is the simple
// one: one warp per (row, segment), four positions per lane from one
// 16-byte load, and `cap` rounds of selection. A round takes each lane's
// least remaining (value, position), finds the warp's least value with
// one `redux.sync` min and the lowest position holding it with a second,
// and the lane that owns the position writes its key and drops it. So the
// instruction count grows with cap (two warp reductions and a 4-way local
// minimum a round), and the kernel is instruction-bound rather than at the
// byte bound; a later PR can keep a sorted cap-list per lane instead.
// Offsets are 64-bit: r * nseg * 512 bytes passes 4 GiB at a 2M-row library.
//
// Left out from the TPU kernel, each because Hopper does not need it:
// - The [32, 128]-segment grid blocks and the padding of nseg to 128: a
//   warp takes one segment, so any nseg works.
// - The 2*cap separate [TB, TS] output refs: the keys go out packed, as the
//   plain version's torch.topk on packed keys gives them.
// - Masking the extracted lane with I32_MAX: a lane keeps a bit per
//   position still in play, so a genuine I32_MAX value is never confused
//   with an extracted one.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block: 8 warps
constexpr int NW = NT / 32;
constexpr unsigned NONE = 0xFFFFFFFFu;

__global__ void __launch_bounds__(NT)
    seg_topcap_kernel(const int4* __restrict__ dist, const int4* __restrict__ cols,
                      unsigned long long* __restrict__ out, long long nwarps,
                      int nseg, int cap, long long real_l, int big) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * NW;
  // `w` is the same for the whole warp, so every lane reaches the reductions
  for (long long w = (long long)blockIdx.x * NW + (threadIdx.x >> 5); w < nwarps;
       w += stride) {
    const int s = (int)(w % nseg);  // w = row * nseg + s
    const int4 dv = dist[w * 32 + lane];
    const int4 cv = cols[(long long)s * 32 + lane];
    int v[4] = {dv.x, dv.y, dv.z, dv.w};
    const int c[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c[i] >= real_l) v[i] = big;
    unsigned left = 0xFu;  // this lane's positions still in play
    unsigned long long* orow = out + w * cap;
    for (int j = 0; j < cap; ++j) {
      int lv = INT_MAX;
      unsigned lp = NONE;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (((left >> i) & 1u) && (lp == NONE || v[i] < lv)) {
          lv = v[i];
          lp = (unsigned)(lane * 4 + i);
        }
      const int wv = __reduce_min_sync(0xffffffffu, lv);
      const unsigned wp = __reduce_min_sync(0xffffffffu, lv == wv ? lp : NONE);
      if ((wp >> 2) == (unsigned)lane) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if ((wp & 3u) == (unsigned)i) {
            left &= ~(1u << i);
            orow[j] = ((unsigned long long)(unsigned)wv << 32) | (unsigned)c[i];
          }
      }
    }
  }
}

}  // namespace

extern "C" {

// dist [rows, nseg*128] int32 and cols [nseg*128] int32, both contiguous
// and 16-byte aligned; out [rows, nseg*cap] int64. 1 <= cap <= 128 (checked
// by the caller). `target_blocks` is how many blocks fill the card; the
// warps stride over the (row, segment) pairs. Returns cudaGetLastError().
int emosaic_seg_topcap(int device, const void* dist, const void* cols, void* out,
                       long long rows, int nseg, int cap, long long real_l, int big,
                       int target_blocks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long nwarps = rows * (long long)nseg;
  long long blocks = (nwarps + NW - 1) / NW;
  if (blocks > target_blocks) blocks = target_blocks;
  if (blocks < 1) blocks = 1;
  seg_topcap_kernel<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
      (const int4*)dist, (const int4*)cols, (unsigned long long*)out, nwarps, nseg,
      cap, real_l, big);
  return (int)cudaGetLastError();
}

const char* emosaic_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
