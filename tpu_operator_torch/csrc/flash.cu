// Flash-attention forward (tpu_operator_torch/workloads/flashattn.py).
//
// K3 flash_fwd_bf16 replaces tpu_operator/workloads/flashattn.py::
// make_flash_fn, variant "full" (the Pallas `kernel` at flashattn.py:112):
// attention over (H, S, 128) bf16 on a grid of (head, q-block), the Q block
// resident, K/V streamed, s = q.k^T/sqrt(D) in f32, running max m and
// denominator l in f32, p cast to bf16 for p.v accumulated in f32, causal
// loop stopped at diag_stop(i) with only the diagonal tail masked, output
// acc/l in bf16.
//
// Bound on an H100: operations. At the probe's shape (8 x 8192 x 128,
// causal) the two products are ~1.4e11 FLOPs against 67 MB of inputs and
// output, some 2000 FLOPs a byte, far above the ~295 at which bf16 tensor
// cores rather than memory set the pace.
//
// Design: one block per (q-block, head) with block_q/16 warps; each warp
// owns 16 query rows. A warp keeps its Q rows in registers as mma.sync A
// fragments for the whole kernel, and its f32 accumulator (16 x 128), m
// and l in registers. K and V stream through shared memory in 64-key
// sub-tiles (rows padded to 136 bf16 so the fragment reads hit 32 distinct
// banks). Both products run on tensor cores as mma.sync m16n8k16 bf16 with
// f32 accumulation; the S accumulator's layout is the PV A-fragment's
// layout, so p goes from registers to the second product without shared
// memory. The logical tiling is the caller's (block_q, block_k), as on the
// TPU: a causal q-block processes k-blocks [0, diag_stop(i)), the first
// n_full = i*block_q/block_k without a mask and the rest masked, so the
// FLOPs performed are exactly causal_flops(seq, H, D, block_q, block_k).
// Heavier causal q-blocks are scheduled first. The online-softmax update
// runs per 64-key sub-tile; the result is the same function up to the
// order of f32 sums and where p is rounded to bf16.
// Not yet done here: cp.async/TMA double buffering and wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;        // head_dim; the wrapper refuses anything else
constexpr int KT = 64;        // keys per shared-memory sub-tile
constexpr int LDS = D + 8;    // padded shared row, in bf16 elements
constexpr int MAX_WARPS = 8;  // block_q <= 128

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 from rows r and r+1 of the same column, packed low|high.
__device__ __forceinline__ uint32_t ld_col_pair(const __nv_bfloat16* p) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
  return (uint32_t)u[0] | ((uint32_t)u[LDS] << 16);
}

// One online-softmax + PV step of one warp against one 64-key sub-tile.
// Fragment rows: r = 0 is the warp's row g = lane/4, r = 1 is row g + 8.
template <bool MASKED>
__device__ __forceinline__ void attend(const uint32_t (&qa)[D / 16][4],
                                       const __nv_bfloat16* __restrict__ Ks,
                                       const __nv_bfloat16* __restrict__ Vs,
                                       float (&acc)[D / 8][4], float (&m)[2],
                                       float (&l)[2], float scale_log2, int qrow,
                                       int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float s[KT / 8][4];
#pragma unroll
  for (int nt = 0; nt < KT / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) {
      const __nv_bfloat16* kp = Ks + (nt * 8 + g) * LDS + kk * 16 + 2 * t;
      mma16816(s[nt], qa[kk], ld_u32(kp), ld_u32(kp + 8));
    }
  }

  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = s[nt][e] * scale_log2;
      if (MASKED) {
        const int qpos = qrow + (e >> 1) * 8;
        const int kpos = k0 + nt * 8 + 2 * t + (e & 1);
        if (kpos > qpos) v = -INFINITY;
      }
      s[nt][e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // a row with every key so far masked keeps m = -inf; use 0 as its
    // reference so exp2 sees -inf - 0 and gives 0, never NaN
    const float ref = mx[r] == -INFINITY ? 0.f : mx[r];
    alpha[r] = exp2f(m[r] - ref);
    m[r] = mx[r];
    mx[r] = ref;
  }
  float lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[nt][e] - mx[e >> 1]);
      s[nt][e] = p;
      lsum[e >> 1] += p;
    }
  }
  l[0] = l[0] * alpha[0] + lsum[0];
  l[1] = l[1] * alpha[1] + lsum[1];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    acc[nt][0] *= alpha[0];
    acc[nt][1] *= alpha[0];
    acc[nt][2] *= alpha[1];
    acc[nt][3] *= alpha[1];
  }
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    const uint32_t pa[4] = {
        pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const __nv_bfloat16* vp = Vs + (kk * 16 + 2 * t) * LDS + nt * 8 + g;
      mma16816(acc[nt], pa, ld_col_pair(vp), ld_col_pair(vp + 8 * LDS));
    }
  }
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 int seq, int block_q, int block_k, int causal, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 Ks[KT * LDS];
  __shared__ __align__(16) __nv_bfloat16 Vs[KT * LDS];

  const int i = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const size_t head = (size_t)blockIdx.y * seq * D;
  q += head;
  k += head;
  v += head;
  o += head;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qrow = i * block_q + warp * 16 + g;

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p0 = q + (size_t)qrow * D + kk * 16 + 2 * t;
    const __nv_bfloat16* p1 = p0 + 8 * D;
    qa[kk][0] = ld_u32(p0);
    qa[kk][1] = ld_u32(p1);
    qa[kk][2] = ld_u32(p0 + 8);
    qa[kk][3] = ld_u32(p1 + 8);
  }
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // diag_stop(i) and n_full, in k-blocks, as the TPU kernel computes them
  const int hi = causal ? ((i + 1) * block_q + block_k - 1) / block_k : seq / block_k;
  const int n_full = causal ? (i * block_q) / block_k : hi;
  const int sub = block_k / KT;

  auto load_tile = [&](int k0) {
    __syncthreads();  // the previous sub-tile is fully consumed
    for (int idx = threadIdx.x; idx < KT * D / 8; idx += blockDim.x) {
      const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(&Ks[r * LDS + c]) =
          *reinterpret_cast<const uint4*>(&k[(size_t)(k0 + r) * D + c]);
      *reinterpret_cast<uint4*>(&Vs[r * LDS + c]) =
          *reinterpret_cast<const uint4*>(&v[(size_t)(k0 + r) * D + c]);
    }
    __syncthreads();
  };

  for (int kt = 0; kt < n_full * sub; ++kt) {  // below the diagonal: no mask
    load_tile(kt * KT);
    attend<false>(qa, Ks, Vs, acc, m, l, scale_log2, qrow, kt * KT, lane);
  }
  for (int kt = n_full * sub; kt < hi * sub; ++kt) {  // the diagonal tail
    load_tile(kt * KT);
    attend<true>(qa, Ks, Vs, acc, m, l, scale_log2, qrow, kt * KT, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / l[r];
  }
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    __nv_bfloat16* out = o + (size_t)qrow * D + nt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(out) = pack_bf16(acc[nt][0] * l[0], acc[nt][1] * l[0]);
    *reinterpret_cast<uint32_t*>(out + 8 * D) =
        pack_bf16(acc[nt][2] * l[1], acc[nt][3] * l[1]);
  }
}

}  // namespace

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                              int heads, int seq, int block_q, int block_k, int causal,
                              void* stream) {
  if (heads <= 0 || seq <= 0 || block_q <= 0 || block_q % 16 || block_q > MAX_WARPS * 16 ||
      block_k <= 0 || block_k % KT || seq % block_q || seq % block_k)
    return cudaErrorInvalidValue;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  dim3 grid(seq / block_q, heads);
  flash_fwd_kernel<<<grid, (block_q / 16) * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), seq, block_q,
      block_k, causal, scale_log2);
  return (int)cudaGetLastError();
}
