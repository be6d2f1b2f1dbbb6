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
// (cp.async.bulk): one thread asks for a contiguous 16 KB piece to be moved
// global->shared, completion lands on an mbarrier, and the same thread then
// issues the shared->global bulk store (commit_group / wait_group). The
// buffer is cut into n_chunks chunks as on the TPU (gridDim.y), each chunk
// into one contiguous range per block (gridDim.x), and each block keeps a
// ring of STAGES pieces in flight. The grid is sized to one wave of
// resident blocks, so all chunks stream at once; a thread spends no
// registers or instructions on addresses, the copy engine does that.

#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int PIECE = 16384;  // bytes per bulk transfer
constexpr int STAGES = 4;     // pieces in flight per block

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

__global__ void bulk_copy_kernel(const char* __restrict__ src,
                                 char* __restrict__ dst,
                                 long long chunk_bytes) {
  extern __shared__ __align__(128) unsigned char ring[];  // STAGES * PIECE
  __shared__ __align__(8) uint64_t full[STAGES];
  if (threadIdx.x != 0) return;  // one thread drives the copy engine

  const long long pieces = chunk_bytes / PIECE;
  const long long first = pieces * blockIdx.x / gridDim.x;
  const long long n = pieces * (blockIdx.x + 1) / gridDim.x - first;
  const long long base = (long long)blockIdx.y * chunk_bytes + first * PIECE;

  for (int s = 0; s < STAGES; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&full[s]))
                 : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  auto load = [&](long long p, int s) {
    const uint32_t mbar = smem_u32(&full[s]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mbar),
                 "r"(PIECE)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(ring + s * PIECE)),
        "l"(src + base + p * PIECE), "r"(PIECE), "r"(mbar)
        : "memory");
  };

  for (int s = 0; s < STAGES && s < n; ++s) load(s, s);
  for (long long p = 0; p < n; ++p) {
    const int s = (int)(p % STAGES);
    mbar_wait(smem_u32(&full[s]), (uint32_t)((p / STAGES) & 1));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                     dst + base + p * PIECE),
                 "r"(smem_u32(ring + s * PIECE)), "r"(PIECE)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // refill the stage the previous piece's store has finished reading
    if (p >= 1 && p - 1 + STAGES < n) {
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(p - 1 + STAGES, (int)((p - 1) % STAGES));
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

// Copy nbytes from src to dst as n_chunks chunks of bulk copies.
int bulk_copy(const void* src, void* dst, long long nbytes, int n_chunks, void* stream) {
  if (n_chunks <= 0 || nbytes <= 0 || nbytes % ((long long)n_chunks * PIECE))
    return cudaErrorInvalidValue;
  const int smem = STAGES * PIECE;
  cudaError_t err = cudaFuncSetAttribute(
      bulk_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bulk_copy_kernel, 32, smem);
  if (err != cudaSuccess) return (int)err;
  const long long chunk_bytes = nbytes / n_chunks;
  long long per_chunk = (long long)sms * (per_sm > 0 ? per_sm : 1) / n_chunks;
  if (per_chunk < 1) per_chunk = 1;
  if (per_chunk > chunk_bytes / PIECE) per_chunk = chunk_bytes / PIECE;
  dim3 grid((unsigned)per_chunk, (unsigned)n_chunks);
  bulk_copy_kernel<<<grid, 32, smem, (cudaStream_t)stream>>>(
      static_cast<const char*>(src), static_cast<char*>(dst), chunk_bytes);
  return (int)cudaGetLastError();
}

}  // extern "C"
