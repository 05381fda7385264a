// K6 and K7: the mosaic band composite through the copy engine.
//
// Replace the TPU lab kernels `_dma_kernel_unrolled`
// (tools/tpu_r3_experiments2.py) and `_mk_sb_kernel` (K6, one stage), and
// `_mk_db_kernel` (K7, two stages) of tools/tpu_r3_experiments3.py. They
// write the band of K2 (csrc/compose.cu), [nby * ts, nbx * ts * 3] u8, from
// signed items [nby, nbx] i32 and the augmented stack [2T + 1, ts, ts * 3]
// u8: +i -> row i - 1, -i -> row T + i - 1, clipped to [0, 2T - 1], and
// 0 -> the black row 2T.
//
// The TPU kernels stage ch = 128 or 256 tiles per grid step with one async
// copy each, completed on DMA semaphores. Here the copies are bulk copies
// (`cp.async.bulk`, the TMA unit) into shared memory, completed on an
// `mbarrier` armed with the bytes it expects. A block owns a run of `run`
// tiles of one block-row: lane 0 of warp 0 issues one 1-D bulk copy per
// tile (a whole tile is ts * ts * 3 contiguous bytes of the stack), after
// the warp has loaded the run's items in parallel; then all threads write
// the [ts, run * ts * 3] segment of the band with coalesced 16-byte (8-byte
// where ts * 3 % 16 != 0) stores. A TPU chunk of 128 tiles is 512 KB of
// VMEM; a block has at most 227 KB of shared memory, so `run` is tiles per
// stage that fit (the wrapper checks it), not ch.
//
// K6 (`emosaic_compose_bulk`) launches one block per run. K7
// (`emosaic_compose_bulk2`) is a two-stage ring: each block is persistent
// and walks its own runs q = blockIdx.x, + gridDim.x, ...; it issues run
// n + 1 into the other stage before it writes run n, with one mbarrier per
// stage and phase parity. The TPU version prefetches the next grid step and
// relies on its grid running in order; CUDA blocks run in no order, so the
// ring never crosses blocks.
//
// What bounds them on an H100: device-memory bandwidth, as K2: the tiles
// the items reach are read once and the band is written once. Bulk copies
// need 16-byte aligned addresses and sizes, so the domain is the TPU
// kernels' own, ts % 8 == 0 (then a tile is a multiple of 192 bytes). All
// byte offsets are 64-bit: a 9.8 GB stack (T = 100k, ts = 128) is read past
// 4 GiB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// bytes before the first stage: the mbarriers, and 128-byte alignment
constexpr int kHeader = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// spin until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// global -> shared bulk copy of `bytes` (16-byte multiple), completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ long long src_row(long long it, long long t) {
  if (it == 0) return 2 * t;
  long long row = it > 0 ? it - 1 : t - it - 1;
  return row < 0 ? 0 : (row > 2 * t - 1 ? 2 * t - 1 : row);
}

struct Run {
  long long by;  // block-row
  int bx0;       // first block column
  int n;         // tiles in the run (the last run of a row may be short)
};

__device__ __forceinline__ Run run_of(long long q, int nbx, int run) {
  const int nrx = (nbx + run - 1) / run;
  Run r;
  r.by = q / nrx;
  r.bx0 = (int)(q - r.by * nrx) * run;
  r.n = min(run, nbx - r.bx0);
  return r;
}

// Warp 0: load the run's items in parallel, arm `bar` with the run's bytes,
// and let lane 0 issue one bulk copy per tile into `dst`.
__device__ void issue_run(const int32_t* __restrict__ items,
                          const uint8_t* __restrict__ aug, long long t, int nbx,
                          int run, uint32_t tile, long long q, uint8_t* dst,
                          uint64_t* bar) {
  const int lane = threadIdx.x & 31;
  const Run r = run_of(q, nbx, run);
  const int32_t* it = items + r.by * nbx + r.bx0;
  if (lane == 0) mbar_expect_tx(bar, (uint32_t)r.n * tile);
  for (int j0 = 0; j0 < r.n; j0 += 32) {
    const int j = j0 + lane;
    const long long row = j < r.n ? src_row(it[j], t) : 0;
    const int m = min(32, r.n - j0);
    for (int k = 0; k < m; ++k) {
      const long long rk = __shfl_sync(0xffffffffu, row, k);
      if (lane == 0) {
        bulk_load(dst + (size_t)(j0 + k) * tile, aug + rk * tile, tile, bar);
      }
    }
  }
}

// All threads: write the run's [ts, n * s3] segment of the band from the
// staged tiles [n, ts, s3], in V-sized pieces along each band row.
template <typename V>
__device__ void write_run(const uint8_t* src, uint8_t* __restrict__ out,
                          const Run& r, int nbx, int ts) {
  const int s3 = ts * 3;
  const int pv = s3 / (int)sizeof(V);  // pieces of one tile row
  const int per_row = r.n * pv;
  const int total = ts * per_row;
  const long long row_bytes = (long long)nbx * s3;
  const V* s = reinterpret_cast<const V*>(src);
  uint8_t* base = out + r.by * ts * row_bytes + (long long)r.bx0 * s3;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int y = idx / per_row;
    const int p = idx - y * per_row;
    const int j = p / pv;
    const int w = p - j * pv;
    reinterpret_cast<V*>(base + y * row_bytes)[p] = s[(j * ts + y) * pv + w];
  }
}

template <int STAGES, typename V>
__global__ void __launch_bounds__(kThreads)
    compose_bulk_kernel(const int32_t* __restrict__ items,
                        const uint8_t* __restrict__ aug,
                        uint8_t* __restrict__ out, long long t, int nby,
                        int nbx, int ts, int run) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const uint32_t tile = (uint32_t)ts * ts * 3;
  const size_t stage_bytes = (size_t)run * tile;
  uint8_t* stage[2] = {smem + kHeader, smem + kHeader + stage_bytes};
  const long long nruns = (long long)nby * ((nbx + run - 1) / run);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const bool issuer = threadIdx.x < 32;
  long long q = blockIdx.x;
  if (issuer && q < nruns) {
    issue_run(items, aug, t, nbx, run, tile, q, stage[0], &bars[0]);
  }
  for (int i = 0; q < nruns; ++i, q += gridDim.x) {
    const long long next = q + gridDim.x;
    const int s = STAGES == 2 ? (i & 1) : 0;
    if (STAGES == 2 && issuer && next < nruns) {
      // the other stage was last read in iteration i - 1, which ended in
      // a __syncthreads
      issue_run(items, aug, t, nbx, run, tile, next, stage[s ^ 1],
                &bars[s ^ 1]);
    }
    mbar_wait(&bars[s], STAGES == 2 ? ((i >> 1) & 1) : (i & 1));
    write_run<V>(stage[s], out, run_of(q, nbx, run), nbx, ts);
    __syncthreads();
    if (STAGES == 1 && issuer && next < nruns) {
      issue_run(items, aug, t, nbx, run, tile, next, stage[0], &bars[0]);
    }
  }
}

template <int STAGES>
int launch(int device, const void* items, const void* aug, void* out,
           long long t, int nby, int nbx, int ts, int run, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int s3 = ts * 3;
  const size_t smem = kHeader + (size_t)STAGES * run * ts * s3;
  void (*kern)(const int32_t*, const uint8_t*, uint8_t*, long long, int, int,
               int, int) = s3 % 16 == 0 ? compose_bulk_kernel<STAGES, uint4>
                                        : compose_bulk_kernel<STAGES, uint2>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long nruns = (long long)nby * ((nbx + run - 1) / run);
  long long grid = nruns;
  if (STAGES == 2) {  // persistent: as many blocks as fit on the card at once
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid = nruns < (long long)per_sm * sms ? nruns : (long long)per_sm * sms;
  }
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kern<<<(unsigned)grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)items, (const uint8_t*)aug, (uint8_t*)out, t, nby, nbx,
      ts, run);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// items [nby, nbx] i32, aug [2t + 1, ts, ts * 3] u8, out [nby * ts,
// nbx * ts * 3] u8, with ts % 8 == 0, 16-byte aligned aug and out, and
// kHeader + run * ts * ts * 3 (twice that for K7) bytes of shared memory at
// most 227 KB (checked by the caller). Return cudaGetLastError().
int emosaic_compose_bulk(int device, const void* items, const void* aug,
                         void* out, long long t, int nby, int nbx, int ts,
                         int run, void* stream) {
  return launch<1>(device, items, aug, out, t, nby, nbx, ts, run, stream);
}

int emosaic_compose_bulk2(int device, const void* items, const void* aug,
                          void* out, long long t, int nby, int nbx, int ts,
                          int run, void* stream) {
  return launch<2>(device, items, aug, out, t, nby, nbx, ts, run, stream);
}

const char* emosaic_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
