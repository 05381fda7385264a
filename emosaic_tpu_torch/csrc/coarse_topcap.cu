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
// integers (sums of g u8 cells), so the f32 arithmetic is exact: a term
// is at most 32 * 255 and a row sum at most 255 * 49152 < 2^24.
//
// What bounds it on an H100: the FP32 lanes. Every (row, position,
// coordinate) costs an FADD for the difference and an FADD of its |.|
// into the sum, at 128 lanes an SM a clock; the keys it writes take a
// twentieth of that time. The design:
// - A block takes a tile of 128 query rows against one segment (128
//   positions); 128 threads, each a 16 x 8 micro-tile of sums in registers
//   (16 rows, positions 4p..4p+3 and 64+4p..64+4p+3), fed by six 16-byte
//   shared-memory loads per coordinate for 256 FADDs.
// - A K-loop over dout in steps of 32 coordinates (dout runs from 6 to
//   1536; a whole segment at 1536 would not fit in shared memory), each
//   step's query and library tiles staged by `cp.async` into a two-stage
//   ring (contiguous 512-byte rows in both layouts), the next step's copy
//   overlapping this one's sums.
// - The sums go to shared memory as int32 [128, 132] (over the ring,
//   which is done with), and each thread selects one row's segment with
//   the routine K4 uses (`seg_select.cuh`), writing its keys and one
//   atomicMin of s_min.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "seg_select.cuh"

namespace {

using namespace seg_select;

constexpr int NT = 128;  // threads per block
constexpr int TQ = 128;  // query rows per block
constexpr int KT = 32;   // coordinates per K step
constexpr int RQ = 16;   // rows per thread
constexpr int RP = 8;    // positions per thread
constexpr int RING_FLOATS = 2 * KT * (TQ + SEG);
constexpr int DIST_WORDS = TQ * ROW_WORDS;
constexpr int SMEM_BYTES = 4 * (RING_FLOATS > DIST_WORDS ? RING_FLOATS : DIST_WORDS);
static_assert(NT * RQ * RP == TQ * SEG, "the micro-tiles cover the block's tile");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// Stage K step `k` into ring slot `buf`: rows c0..c0+kc of the query tile
// and of the segment's library tile, 32 16-byte copies a row each.
__device__ __forceinline__ void stage(float* ring, int buf, int k, int dout,
                                      const float* __restrict__ xq, long long rpad,
                                      const float* __restrict__ ls) {
  const int c0 = k * KT;
  const int kc = min(KT, dout - c0);
  float* q = ring + buf * KT * (TQ + SEG);
  float* t = q + KT * TQ;
  for (int i = threadIdx.x; i < kc * 32; i += NT) {
    const int c = i >> 5, j = (i & 31) * 4;
    cp_async16(q + c * TQ + j, xq + (long long)(c0 + c) * rpad + j);
    cp_async16(t + c * SEG + j, ls + (long long)(c0 + c) * SEG + j);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int CAPL>
__global__ void __launch_bounds__(NT, 2)
    coarse_topcap_kernel(const float* __restrict__ xt, const float* __restrict__ lib,
                         const int* __restrict__ cols, unsigned long long* __restrict__ out,
                         int* __restrict__ s_min, long long rows, long long rpad, int dout,
                         int nseg, int cap, long long real_l, int big) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int s = (int)(blockIdx.x % nseg);
  const long long qt = blockIdx.x / nseg;
  const float* xq = xt + qt * TQ;
  const float* ls = lib + (long long)s * dout * SEG;
  const int* cols_seg = cols + (long long)s * SEG;
  const int tid = threadIdx.x, pg = tid & 15, qg = tid >> 4;
  const int nk = (dout + KT - 1) / KT;

  stage(ring, 0, 0, dout, xq, rpad, ls);
  const int nvalid = valid_positions(cols_seg, real_l);
  float acc[RQ][RP];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RP; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < nk; ++k) {
    if (k + 1 < nk) {
      stage(ring, (k + 1) & 1, k + 1, dout, xq, rpad, ls);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const float* q = ring + (k & 1) * KT * (TQ + SEG);
    const float* t = q + KT * TQ;
    const int kc = min(KT, dout - k * KT);
#pragma unroll 2
    for (int c = 0; c < kc; ++c) {
      const float4 ta = *reinterpret_cast<const float4*>(t + c * SEG + pg * 4);
      const float4 tb = *reinterpret_cast<const float4*>(t + c * SEG + 64 + pg * 4);
      const float tv[RP] = {ta.x, ta.y, ta.z, ta.w, tb.x, tb.y, tb.z, tb.w};
      float qv[RQ];
#pragma unroll
      for (int i4 = 0; i4 < RQ / 4; ++i4) {
        const float4 v = *reinterpret_cast<const float4*>(q + c * TQ + qg * RQ + i4 * 4);
        qv[i4 * 4] = v.x, qv[i4 * 4 + 1] = v.y, qv[i4 * 4 + 2] = v.z, qv[i4 * 4 + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RP; ++j) acc[i][j] += fabsf(qv[i] - tv[j]);
    }
    __syncthreads();  // the slot is refilled next step; the last one is reused below
  }

  int* dist = reinterpret_cast<int*>(smem4);
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    int* row = dist + (qg * RQ + i) * ROW_WORDS;
    *reinterpret_cast<int4*>(row + pg * 4) =
        make_int4(__float2int_rn(acc[i][0]), __float2int_rn(acc[i][1]),
                  __float2int_rn(acc[i][2]), __float2int_rn(acc[i][3]));
    *reinterpret_cast<int4*>(row + 64 + pg * 4) =
        make_int4(__float2int_rn(acc[i][4]), __float2int_rn(acc[i][5]),
                  __float2int_rn(acc[i][6]), __float2int_rn(acc[i][7]));
  }
  __syncthreads();
  const long long r = qt * TQ + tid;
  if (r < rows) {
    const int worst = select_segment<CAPL>(dist + tid * ROW_WORDS, nvalid, cap, big,
                                           TableCols{cols_seg}, out + (r * nseg + s) * cap);
    atomicMin(s_min + r, worst);
  }
}

template <int CAPL>
cudaError_t launch(const float* xt, const float* lib, const int* cols,
                   unsigned long long* out, int* s_min, long long rows, long long rpad,
                   int dout, int nseg, int cap, long long real_l, int big, long long blocks,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      coarse_topcap_kernel<CAPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  coarse_topcap_kernel<CAPL><<<(unsigned)blocks, NT, SMEM_BYTES, stream>>>(
      xt, lib, cols, out, s_min, rows, rpad, dout, nseg, cap, real_l, big);
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

}  // namespace

extern "C" {

// xt [dout, rpad] f32, lib [nseg, dout, 128] f32, cols [nseg*128] int32
// (growing within each segment), all contiguous and 16-byte aligned; out
// [rows, nseg*cap] int64; s_min [rows] int32 filled with INT_MAX. rpad is
// a multiple of 128 and at least rows; 1 <= cap <= 128. `blocks` and
// `smem_bytes` are the launch plan (ops/distance.py `_k9_plan`); a plan
// that does not match this kernel is refused. Returns the CUDA error code
// (0 on success).
int emosaic_coarse_topcap(int device, const void* xt, const void* lib, const void* cols,
                          void* out, void* s_min, long long rows, long long rpad, int dout,
                          int nseg, int cap, long long real_l, int big, long long blocks,
                          int smem_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  if (smem_bytes != SMEM_BYTES || rpad % TQ || rpad < rows || blocks != rpad / TQ * nseg ||
      blocks > INT_MAX || dout < 1)
    return (int)cudaErrorInvalidValue;
  const float* x = (const float*)xt;
  const float* l = (const float*)lib;
  const int* c = (const int*)cols;
  auto* o = (unsigned long long*)out;
  int* sm = (int*)s_min;
  cudaStream_t st = (cudaStream_t)stream;
  switch (list_len(cap)) {
    case 1: err = launch<1>(x, l, c, o, sm, rows, rpad, dout, nseg, cap, real_l, big, blocks, st); break;
    case 2: err = launch<2>(x, l, c, o, sm, rows, rpad, dout, nseg, cap, real_l, big, blocks, st); break;
    case 4: err = launch<4>(x, l, c, o, sm, rows, rpad, dout, nseg, cap, real_l, big, blocks, st); break;
    case 8: err = launch<8>(x, l, c, o, sm, rows, rpad, dout, nseg, cap, real_l, big, blocks, st); break;
    case 16: err = launch<16>(x, l, c, o, sm, rows, rpad, dout, nseg, cap, real_l, big, blocks, st); break;
    case 32: err = launch<32>(x, l, c, o, sm, rows, rpad, dout, nseg, cap, real_l, big, blocks, st); break;
    default: err = launch<0>(x, l, c, o, sm, rows, rpad, dout, nseg, cap, real_l, big, blocks, st); break;
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

const char* emosaic_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
