// HBM copy kernels of the bandwidth probe (tpu_operator_torch/workloads/membw.py).
//
// K1 tiled_copy_f32 replaces tpu_operator/workloads/membw.py::make_copy_fn
// (the Pallas `kernel` at membw.py:86, an identity copy one (block_rows,
// 16384) f32 tile per grid step through VMEM).
// K2 bulk_copy replaces membw.py::make_dma_copy_fn (the Pallas `kernel` at
// membw.py:116: the whole buffer moved HBM->HBM as n_chunks DMAs, all in
// flight, no VMEM staging).
//
// Bound on an H100: bytes. A copy of N bytes reads N and writes N, so the
// least time is 2N over the memory rate (3.35 TB/s on the SXM part); there
// is no arithmetic to hide.
//
// K1's design: a grid over 16 KB tiles (a quarter of one 16384-wide f32
// row), one block each; 256 threads stage the tile in shared memory with
// 16-byte loads (float4) and store it back with 16-byte stores. Neighbouring
// threads touch neighbouring 16-byte words, so every warp access is fully
// coalesced. Only whole tiles are taken: the caller checks the shape.
//
// K2's design: the Hopper counterpart of the DMA engines is the bulk copy
// (cp.async.bulk): one thread asks for a contiguous piece to be moved
// global->shared, completion lands on an mbarrier, and the same thread then
// issues the shared->global bulk store (commit_group / wait_group). The
// buffer is cut into n_chunks chunks as on the TPU, and each chunk's
// pieces are dealt to the blocks that serve it; each block keeps a ring of
// pieces in flight. The grid is sized to one wave of resident blocks, so
// all chunks stream at once; a thread spends no registers or instructions
// on addresses, the copy engine does that.
//
// The plan bulk_copy runs: 16 KB pieces, a ring of 8 (128 KB, one block
// per SM), a stage refilled once all but 2 stores have read it (so up to
// 2 stores and 6 loads in flight), and each chunk's pieces interleaved
// over its blocks, which sweep the chunk front to back together. It was
// the fastest of ten plans of piece size, ring depth, stores in flight and
// order timed on the H100 beside Tensor.copy_ (PERF.md): faster than the
// first plan (16 KB x 4, one store in flight, one contiguous range per
// block), but still a few percent behind copy_, which no plan reached.
// What holds the rest back is not measured.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int TILE_F4 = 1024;  // float4 per K1 tile: 16 KB
constexpr int K1_THREADS = 256;

__global__ void __launch_bounds__(K1_THREADS)
tiled_copy_kernel(const float4* __restrict__ src, float4* __restrict__ dst) {
  __shared__ float4 tile[TILE_F4];
  const long long base = (long long)blockIdx.x * TILE_F4;
#pragma unroll
  for (int i = 0; i < TILE_F4 / K1_THREADS; ++i) {
    const int idx = i * K1_THREADS + threadIdx.x;
    tile[idx] = src[base + idx];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TILE_F4 / K1_THREADS; ++i) {
    const int idx = i * K1_THREADS + threadIdx.x;
    dst[base + idx] = tile[idx];
  }
}

// K2's plan (see the header).
constexpr int PIECE = 16384;  // bytes per bulk transfer
constexpr int STAGES = 8;     // pieces in a block's ring: 128 KB
constexpr int LAG = 2;        // stores still reading when a stage is refilled
constexpr int RING_BYTES = STAGES * PIECE;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t mbar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mbar), "r"(parity)
        : "memory");
  }
}

// One thread per block drives the copy engine over every gridDim.x-th
// piece of chunk blockIdx.y, starting at piece blockIdx.x. A ring of
// STAGES pieces: piece p's store is issued once its load lands; the stage
// of piece p - LAG is refilled with piece p - LAG + STAGES once its store
// has finished reading, so up to LAG stores and STAGES - LAG loads are in
// flight.
__global__ void bulk_copy_kernel(const char* __restrict__ src, char* __restrict__ dst,
                                 long long chunk_bytes) {
  extern __shared__ __align__(128) unsigned char ring[];  // RING_BYTES
  __shared__ __align__(8) uint64_t full[STAGES];
  if (threadIdx.x != 0) return;

  const long long pieces = chunk_bytes / PIECE, g = gridDim.x, b = blockIdx.x;
  const long long n = b < pieces ? (pieces - b + g - 1) / g : 0;
  const long long first = blockIdx.y * chunk_bytes + b * PIECE, step = g * PIECE;

  for (int s = 0; s < STAGES; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&full[s]))
                 : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  auto load = [&](long long p) {
    const int s = (int)(p % STAGES);
    const uint32_t mbar = smem_u32(&full[s]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mbar),
                 "r"(PIECE)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(ring + s * PIECE)),
        "l"(src + first + p * step), "r"(PIECE), "r"(mbar)
        : "memory");
  };

  for (long long p = 0; p < STAGES && p < n; ++p) load(p);
  for (long long p = 0; p < n; ++p) {
    const int s = (int)(p % STAGES);
    mbar_wait(smem_u32(&full[s]), (uint32_t)((p / STAGES) & 1));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                     dst + first + p * step),
                 "r"(smem_u32(ring + s * PIECE)), "r"(PIECE)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    const long long r = p - LAG;  // the piece whose stage is refilled now
    if (r >= 0 && r + STAGES < n) {
      asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(LAG) : "memory");
      load(r + STAGES);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

constexpr int MAX_DEVICES = 64;

// Blocks of bulk_copy_kernel resident at once on the current device (one
// wave), with its RING_BYTES of dynamic shared memory allowed there; both
// set up once per device.
cudaError_t bulk_copy_wave(long long* wave) {
  static std::atomic<long long> waves[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  *wave = waves[dev].load();
  if (*wave > 0) return cudaSuccess;
  int sms = 0, per_sm = 0;
  if ((err = cudaFuncSetAttribute(bulk_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  RING_BYTES)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bulk_copy_kernel, 32,
                                                           RING_BYTES)) != cudaSuccess)
    return err;
  *wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  waves[dev].store(*wave);
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Copy n_elems f32 (a multiple of one 16 KB tile) from src to dst.
int tiled_copy_f32(const void* src, void* dst, long long n_elems, void* stream) {
  if (n_elems <= 0 || n_elems % (TILE_F4 * 4)) return cudaErrorInvalidValue;
  const long long tiles = n_elems / (TILE_F4 * 4);
  tiled_copy_kernel<<<(unsigned)tiles, K1_THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float4*>(src), static_cast<float4*>(dst));
  return (int)cudaGetLastError();
}

// Copy nbytes from src to dst as n_chunks chunks of bulk copies by K2's
// plan. The grid is one wave of resident blocks split evenly over the
// chunks (gridDim.y indexes the chunk).
int bulk_copy(const void* src, void* dst, long long nbytes, int n_chunks, void* stream) {
  if (n_chunks <= 0 || nbytes <= 0 || nbytes % ((long long)n_chunks * PIECE))
    return cudaErrorInvalidValue;
  long long wave = 0;
  const cudaError_t err = bulk_copy_wave(&wave);
  if (err != cudaSuccess) return (int)err;
  const long long chunk_bytes = nbytes / n_chunks, pieces = chunk_bytes / PIECE;
  long long cols = wave / n_chunks;
  if (cols < 1) cols = 1;
  if (cols > pieces) cols = pieces;
  dim3 grid((unsigned)cols, (unsigned)n_chunks);
  bulk_copy_kernel<<<grid, 32, RING_BYTES, (cudaStream_t)stream>>>(
      static_cast<const char*>(src), static_cast<char*>(dst), chunk_bytes);
  return (int)cudaGetLastError();
}

}  // extern "C"
