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
// coalesced. Only whole tiles are taken: the caller checks the shape. Up
// to eight such blocks share an SM, each in its own phase, so loads and
// stores of different tiles are in flight together.
//
// K1's Hopper redesign, tried and kept beside it as tiled_copy_tma_f32
// (on no path; chip_smoke.py times it next to K1): the tiles moved by TMA.
// A tensor map over the (rows, 16384) f32 buffer cuts it into 16 KB tiles
// of 16 rows x 256 columns; a persistent grid of one wave walks them, block
// b taking tiles b, b + grid, ..., so all blocks sweep the buffer front to
// back together; one thread per block drives a ring of 8 stages, a TMA
// tile load landing on the stage's mbarrier and a TMA tensor store writing
// it back, a stage refilled once all but 2 stores have read it
// (cp.async.bulk.wait_group.read; the thread that stores a stage refills
// it, so that is its "empty" signal). On the H100 it took 1.466-1.494 ms
// a 2 GiB copy against K1's 1.419-1.440 in the same calls, and no plan
// tried closed the gap: 4 stages, 4 stores in flight, 32-row tiles, L2
// evict-first hints, or the block's threads storing each landed tile
// (PERF.md). Like K2, which moves 1-D pieces the same way
// (1.455-1.485), it stays 3-5% behind K1 and Tensor.copy_: what a ring
// driven by one thread per SM lacks against many short blocks is not
// measured.
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

#include <atomic>

#include "tma.cuh"

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

// K1's tried Hopper design (see the header).
constexpr int LANES = 16384;           // f32 columns of the probe buffer
constexpr int TMA_COPY_BOX_COLS = 256;  // a tile: 256 f32 (1 KB) of each row,
constexpr int TMA_COPY_BOX_ROWS = 16;   // 16 rows, 16 KB
constexpr int TMA_COPY_TILE = TMA_COPY_BOX_COLS * TMA_COPY_BOX_ROWS * 4;
constexpr int TMA_COPY_STAGES = 8;      // tiles in a block's ring: 128 KB
constexpr int TMA_COPY_LAG = 2;         // stores still reading when a stage is refilled
constexpr int TMA_COPY_SMEM = TMA_COPY_STAGES * TMA_COPY_TILE + 128;  // + slack to align to 128 B

__global__ void tiled_copy_tma_kernel(const __grid_constant__ CUtensorMap src,
                                      const __grid_constant__ CUtensorMap dst, int col_tiles,
                                      long long n_tiles) {
  extern __shared__ unsigned char tma_raw[];  // TMA_COPY_SMEM
  __shared__ __align__(8) uint64_t full[TMA_COPY_STAGES];
  if (threadIdx.x != 0) return;
  const uint32_t ring = (smem_u32(tma_raw) + 127) & ~127u;

  const long long g = gridDim.x, b = blockIdx.x;
  const long long n = b < n_tiles ? (n_tiles - b + g - 1) / g : 0;
  for (int s = 0; s < TMA_COPY_STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  // (column, row) of this block's p-th tile
  auto coords = [&](long long p, int& col, int& row) {
    const long long t = b + p * g;
    col = (int)(t % col_tiles) * TMA_COPY_BOX_COLS;
    row = (int)(t / col_tiles) * TMA_COPY_BOX_ROWS;
  };
  auto load = [&](long long p) {
    const int s = (int)(p % TMA_COPY_STAGES);
    const uint32_t bar = smem_u32(&full[s]);
    int col, row;
    coords(p, col, row);
    mbar_expect_tx(bar, TMA_COPY_TILE);  // the whole box, zero fill included
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(ring + s * TMA_COPY_TILE),
        "l"(reinterpret_cast<uint64_t>(&src)), "r"(col), "r"(row), "r"(bar)
        : "memory");
  };
  auto store = [&](long long p) {
    const int s = (int)(p % TMA_COPY_STAGES);
    int col, row;
    coords(p, col, row);
    asm volatile(
        "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
            reinterpret_cast<uint64_t>(&dst)),
        "r"(col), "r"(row), "r"(ring + s * TMA_COPY_TILE)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  };

  for (long long p = 0; p < TMA_COPY_STAGES && p < n; ++p) load(p);
  for (long long p = 0; p < n; ++p) {
    mbar_wait(smem_u32(&full[p % TMA_COPY_STAGES]), (uint32_t)((p / TMA_COPY_STAGES) & 1));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    store(p);
    const long long r = p - TMA_COPY_LAG;  // the tile whose stage is refilled now
    if (r >= 0 && r + TMA_COPY_STAGES < n) {
      asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(TMA_COPY_LAG) : "memory");
      load(r + TMA_COPY_STAGES);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A tensor map over a contiguous (rows, LANES) f32 array in the tried
// design's tiles, no swizzle; a partial last row-block loads as zeros and
// stores cut at the buffer's edge.
bool tma_copy_map(CUtensorMap* map, const void* ptr, long long rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)LANES, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)LANES * 4};
  const cuuint32_t box[2] = {TMA_COPY_BOX_COLS, TMA_COPY_BOX_ROWS};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// K2's plan (see the header).
constexpr int PIECE = 16384;  // bytes per bulk transfer
constexpr int STAGES = 8;     // pieces in a block's ring: 128 KB
constexpr int LAG = 2;        // stores still reading when a stage is refilled
constexpr int RING_BYTES = STAGES * PIECE;

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

  for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  auto load = [&](long long p) {
    const int s = (int)(p % STAGES);
    const uint32_t mbar = smem_u32(&full[s]);
    mbar_expect_tx(mbar, PIECE);
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

// Blocks of KERNEL (32 threads, SMEM bytes of dynamic shared memory)
// resident at once on the current device (one wave), with its shared
// memory allowed there; both set up once per kernel and device.
template <typename Kernel>
cudaError_t one_wave(Kernel kernel, int smem, std::atomic<long long> (&waves)[MAX_DEVICES],
                     long long* wave) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  *wave = waves[dev].load();
  if (*wave > 0) return cudaSuccess;
  int sms = 0, per_sm = 0;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32, smem)) !=
          cudaSuccess)
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

// Copy n_elems f32, whole rows of LANES, from src to dst by K1's tried
// Hopper design: a grid of one wave, each block walking every grid-th tile.
int tiled_copy_tma_f32(const void* src, void* dst, long long n_elems, void* stream) {
  if (n_elems <= 0 || n_elems % LANES) return cudaErrorInvalidValue;
  static std::atomic<long long> waves[MAX_DEVICES];
  long long wave = 0;
  const cudaError_t err = one_wave(tiled_copy_tma_kernel, TMA_COPY_SMEM, waves, &wave);
  if (err != cudaSuccess) return (int)err;
  const long long rows = n_elems / LANES;
  CUtensorMap maps[2];
  if (!tma_copy_map(&maps[0], src, rows) || !tma_copy_map(&maps[1], dst, rows))
    return cudaErrorInvalidValue;
  const int col_tiles = LANES / TMA_COPY_BOX_COLS;
  const long long n_tiles = (rows + TMA_COPY_BOX_ROWS - 1) / TMA_COPY_BOX_ROWS * col_tiles;
  const long long grid = wave < n_tiles ? wave : n_tiles;
  tiled_copy_tma_kernel<<<(unsigned)grid, 32, TMA_COPY_SMEM, (cudaStream_t)stream>>>(
      maps[0], maps[1], col_tiles, n_tiles);
  return (int)cudaGetLastError();
}

// Copy nbytes from src to dst as n_chunks chunks of bulk copies by K2's
// plan. The grid is one wave of resident blocks split evenly over the
// chunks (gridDim.y indexes the chunk).
int bulk_copy(const void* src, void* dst, long long nbytes, int n_chunks, void* stream) {
  if (n_chunks <= 0 || nbytes <= 0 || nbytes % ((long long)n_chunks * PIECE))
    return cudaErrorInvalidValue;
  static std::atomic<long long> waves[MAX_DEVICES];
  long long wave = 0;
  const cudaError_t err = one_wave(bulk_copy_kernel, RING_BYTES, waves, &wave);
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
