// K5: the write floor of the copy engine, a band filled with one byte.
//
// Replaces the TPU lab kernel `_floor_write_kernel`
// (tools/tpu_r3_experiments.py), which fills the BASELINE band
// [32 * 32, 4096 * 96] u8 (402.65 MB) with `seed[0, 0]` of an [8, 128] u8
// operand, staged once in VMEM scratch, with no gather: the least time a
// band write takes. As there, the byte is read from device memory, never
// taken as a host constant, and each block fills a buffer once (32 KB of
// shared memory) and writes its share of the band from it, here with bulk
// stores (`cp.async.bulk.global.shared::cta`, the TMA unit) in one bulk
// group: the engine that K6 and K7 read through. The last n % 16 bytes
// (bulk stores take 16-byte multiples) are plain stores.
//
// What bounds it on an H100: device-memory write bandwidth, n bytes over
// 3.35 TB/s. Offsets are 64-bit: one call writes past 4 GiB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBuf = 32768;  // bytes of the staged buffer, one bulk store

__global__ void __launch_bounds__(kThreads)
    floor_write_kernel(const uint8_t* __restrict__ seed,
                       uint8_t* __restrict__ out, long long n) {
  __shared__ __align__(128) uint4 buf[kBuf / 16];
  const uint32_t b = seed[0];
  const uint32_t w = b * 0x01010101u;
  for (int i = threadIdx.x; i < kBuf / 16; i += blockDim.x) {
    buf[i] = make_uint4(w, w, w, w);
  }
  // the generic-proxy stores above must be visible to the bulk copies
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  const long long body = n & ~15LL;
  const long long nchunks = (body + kBuf - 1) / kBuf;
  if (threadIdx.x == 0) {
    const uint32_t src = static_cast<uint32_t>(__cvta_generic_to_shared(buf));
    for (long long c = blockIdx.x; c < nchunks; c += gridDim.x) {
      const long long off = c * kBuf;
      const long long left = body - off;
      const uint32_t len = (uint32_t)(left < kBuf ? left : kBuf);
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
              out + off),
          "r"(src), "r"(len)
          : "memory");
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // the buffer must outlive the copies that read it
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
  if (blockIdx.x == 0 && threadIdx.x < n - body) out[body + threadIdx.x] = (uint8_t)b;
}

}  // namespace

extern "C" {

// seed: device pointer to the byte to write (seed[0, 0]); out: n bytes,
// 16-byte aligned (checked by the caller). Returns cudaGetLastError().
int emosaic_floor_write(int device, const void* seed, void* out, long long n,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long nchunks = ((n & ~15LL) + kBuf - 1) / kBuf;
  long long grid = nchunks < 4LL * sms ? nchunks : 4LL * sms;
  grid = grid < 1 ? 1 : grid;
  floor_write_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)seed, (uint8_t*)out, n);
  return (int)cudaGetLastError();
}

const char* emosaic_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
