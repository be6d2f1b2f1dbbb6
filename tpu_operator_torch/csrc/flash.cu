// Flash-attention forward and its attribution instruments
// (tpu_operator_torch/workloads/flashattn.py), one kernel per variant of
// tpu_operator/workloads/flashattn.py::make_flash_fn.
//
// K3 flash_fwd_bf16 replaces variant "full" (the Pallas `kernel` at
// flashattn.py:112): attention over (H, S, 128) bf16 on a grid of (head,
// q-block), the Q block resident, K/V streamed, s = q.k^T/sqrt(D) in f32,
// running max m and denominator l in f32, p cast to bf16 for p.v
// accumulated in f32, causal loop stopped at diag_stop(i) with only the
// diagonal tail masked, output acc/l in bf16.
// K4 flash_fwd_pipelined replaces variant "pipelined" (flashattn.py:209):
// the same function, with the scores of the next sub-tile issued before
// the softmax and PV of the current one over the unmasked range, then a
// drain, then the masked tail as K3 runs it.
// K5 flash_fwd_bf16exp replaces variant "bf16exp" (flashattn.py:153): as
// K3, but p = exp(bf16(s - m_new)) rounded to bf16, with the difference in
// natural-log units, l summing that bf16 p, and the same p into PV.
// K6a flash_softmax_stub replaces variant "softmax_stub" (flashattn.py:192):
// for every k-block j < hi, unmasked, acc += bf16((q.k^T*scale)*0.001).v;
// output bf16(acc), no m, no l, no division.
// K6b flash_qk_only replaces variant "qk_only" (flashattn.py:181): for every
// k-block j < hi, unmasked, acc += (q.k^T*scale)[:, :128], the scores of
// the block's first 128 keys; output bf16(acc). V is never read.
//
// Bound on an H100: operations. At the probe's shape (8 x 8192 x 128,
// causal) the two products are ~1.4e11 FLOPs against 67 MB of inputs and
// output, some 2000 FLOPs a byte, far above the ~295 at which bf16 tensor
// cores rather than memory set the pace. The instruments are bound the
// same way: K6a does both products over the causal tiling (1.4e11 FLOPs),
// K6b half of them.
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
//
// K3, K5, K6a and K6b are one kernel template (flash_fwd_kernel) with a
// different step per sub-tile. K3 works in the log2 domain (s*scale*log2e,
// exp2f); K5 rounds s*scale - m in natural-log units, as the reference
// does, and only then takes exp as exp2f(x*log2e). The stubs run every
// sub-tile of [0, hi) unmasked; K6b stages only K and adds the scores of
// sub-tiles 0 and 1 of each k-block into accumulator n-tiles 0-7 and 8-15
// (the same fragment layout), while the score products of the block's
// other sub-tiles still run (mma16816 is asm volatile).
// K4 is a kernel of its own because its loop differs: K_{j+1} and V_j are
// resident together, so it keeps two stages of K and V in dynamic shared
// memory (4 x 64 x 136 x 2 B = 69,632 B, above the 48 KB of static shared
// memory) and two S fragment sets; its loads stay K3's synchronous 16-byte
// stores, so full - pipelined isolates the reordering. Per element its
// arithmetic is K3's, through the same device functions, so its output is
// K3's bit for bit.
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
constexpr float LOG2E = 1.4426950408889634f;
constexpr float STUB_SCALE = 0.001f;  // softmax_stub's p = bf16((s*scale)*0.001)
constexpr int PIPE_SMEM = 4 * KT * LDS * 2;  // K4: two stages of K and V, bytes

enum class Step { kFull, kBf16Exp, kStub, kQkOnly };

// asm volatile: the compiler keeps every product, including the score
// products whose result qk_only discards (sub-tiles past the first 128 keys
// of a k-block); without it they would be dead code and K6b would time
// less QK^T work than it claims.
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

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 from rows r and r+1 of the same column, packed low|high.
__device__ __forceinline__ uint32_t ld_col_pair(const __nv_bfloat16* p) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
  return (uint32_t)u[0] | ((uint32_t)u[LDS] << 16);
}

// s = q.k^T (raw dot products, f32) of one warp's 16 rows against one
// 64-key sub-tile. Fragment rows: r = 0 is the warp's row g = lane/4,
// r = 1 is row g + 8; column 2t + (e & 1) of n-tile nt.
__device__ __forceinline__ void scores(const uint32_t (&qa)[D / 16][4],
                                       const __nv_bfloat16* __restrict__ Ks,
                                       float (&s)[KT / 8][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
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
}

// acc += bf16(p) . V for one sub-tile; p is in the S fragment's layout,
// which is the A fragment's.
__device__ __forceinline__ void pv(const float (&p)[KT / 8][4],
                                   const __nv_bfloat16* __restrict__ Vs,
                                   float (&acc)[D / 8][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    const uint32_t pa[4] = {
        pack_bf16(p[2 * kk][0], p[2 * kk][1]), pack_bf16(p[2 * kk][2], p[2 * kk][3]),
        pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
        pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const __nv_bfloat16* vp = Vs + (kk * 16 + 2 * t) * LDS + nt * 8 + g;
      mma16816(acc[nt], pa, ld_col_pair(vp), ld_col_pair(vp + 8 * LDS));
    }
  }
}

// One online-softmax + PV step of one warp against one 64-key sub-tile
// whose scores are in s. BF16EXP false (K3, K4): scale is scale*log2e and
// m lives in the log2 domain. BF16EXP true (K5): scale is 1/sqrt(D), m is
// in natural-log units, p = bf16(exp(bf16(s - m_new))) and l sums that p.
template <bool BF16EXP, bool MASKED>
__device__ __forceinline__ void softmax_pv(float (&s)[KT / 8][4],
                                           const __nv_bfloat16* __restrict__ Vs,
                                           float (&acc)[D / 8][4], float (&m)[2],
                                           float (&l)[2], float scale, int qrow, int k0,
                                           int lane) {
  const int t = lane & 3;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // K5 keeps the product rounded, as the reference's s = dot*scale is
      float v = BF16EXP ? __fmul_rn(s[nt][e], scale) : s[nt][e] * scale;
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
    alpha[r] = BF16EXP ? exp2f((m[r] - ref) * LOG2E) : exp2f(m[r] - ref);
    m[r] = mx[r];
    mx[r] = ref;
  }
  float lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = BF16EXP ? round_bf16(exp2f(round_bf16(s[nt][e] - mx[e >> 1]) * LOG2E))
                              : exp2f(s[nt][e] - mx[e >> 1]);
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
  pv(s, Vs, acc, lane);
}

// A warp's 16 query rows into registers as mma A fragments.
__device__ __forceinline__ void load_q(const __nv_bfloat16* __restrict__ q, int qrow,
                                       uint32_t (&qa)[D / 16][4], int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p0 = q + (size_t)qrow * D + kk * 16 + 2 * t;
    const __nv_bfloat16* p1 = p0 + 8 * D;
    qa[kk][0] = ld_u32(p0);
    qa[kk][1] = ld_u32(p1);
    qa[kk][2] = ld_u32(p0 + 8);
    qa[kk][3] = ld_u32(p1 + 8);
  }
}

// 64 rows of K (and of V, unless qk_only) from device memory into the
// padded shared tiles, 16 bytes a thread; barriers on both sides so the
// previous sub-tile is fully consumed and this one fully written.
template <bool WITH_V = true>
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ k,
                                      const __nv_bfloat16* __restrict__ v,
                                      __nv_bfloat16* Ks, __nv_bfloat16* Vs, int k0) {
  __syncthreads();
  for (int idx = threadIdx.x; idx < KT * D / 8; idx += blockDim.x) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(&Ks[r * LDS + c]) =
        *reinterpret_cast<const uint4*>(&k[(size_t)(k0 + r) * D + c]);
    if (WITH_V)
      *reinterpret_cast<uint4*>(&Vs[r * LDS + c]) =
          *reinterpret_cast<const uint4*>(&v[(size_t)(k0 + r) * D + c]);
  }
  __syncthreads();
}

// o = bf16(acc * inv) for a warp's 16 rows; inv = 1/l summed over the
// quad, or 1 for the stubs.
__device__ __forceinline__ void store_out(__nv_bfloat16* __restrict__ o, int qrow,
                                          const float (&acc)[D / 8][4], const float (&inv)[2],
                                          int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    __nv_bfloat16* out = o + (size_t)qrow * D + nt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(out) = pack_bf16(acc[nt][0] * inv[0], acc[nt][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(out + 8 * D) =
        pack_bf16(acc[nt][2] * inv[1], acc[nt][3] * inv[1]);
  }
}

__device__ __forceinline__ void finish_l(float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / l[r];
  }
}

// K3, K5, K6a, K6b. scale: scale*log2e for kFull, 1/sqrt(D) otherwise.
template <Step STEP>
__global__ void __launch_bounds__(MAX_WARPS * 32)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 int seq, int block_q, int block_k, int causal, float scale) {
  constexpr bool QK = STEP == Step::kQkOnly;
  __shared__ __align__(16) __nv_bfloat16 Ks[KT * LDS];
  __shared__ __align__(16) __nv_bfloat16 Vs[QK ? 8 : KT * LDS];

  const int i = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const size_t head = (size_t)blockIdx.y * seq * D;
  q += head;
  k += head;
  if (!QK) v += head;
  o += head;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qrow = i * block_q + warp * 16 + (lane >> 2);

  uint32_t qa[D / 16][4];
  load_q(q, qrow, qa, lane);
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float s[KT / 8][4];

  // diag_stop(i) and n_full, in k-blocks, as the TPU kernel computes them
  const int hi = causal ? ((i + 1) * block_q + block_k - 1) / block_k : seq / block_k;
  const int n_full = causal ? (i * block_q) / block_k : hi;
  const int sub = block_k / KT;

  if constexpr (STEP == Step::kStub || QK) {
    // the instruments: every sub-tile of [0, hi) with no mask, no m, no l
    for (int kt = 0; kt < hi * sub; ++kt) {
      stage<!QK>(k, v, Ks, Vs, kt * KT);
      scores(qa, Ks, s, lane);
      if constexpr (QK) {
        const int part = kt % sub;  // 0, 1: the block's first 128 keys
        if (part == 0) {
#pragma unroll
          for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nt][e] += __fmul_rn(s[nt][e], scale);
        } else if (part == 1) {
#pragma unroll
          for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[KT / 8 + nt][e] += __fmul_rn(s[nt][e], scale);
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = (s[nt][e] * scale) * STUB_SCALE;
        pv(s, Vs, acc, lane);
      }
    }
    const float one[2] = {1.f, 1.f};
    store_out(o, qrow, acc, one, lane);
  } else {
    constexpr bool E16 = STEP == Step::kBf16Exp;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int kt = 0; kt < n_full * sub; ++kt) {  // below the diagonal: no mask
      stage(k, v, Ks, Vs, kt * KT);
      scores(qa, Ks, s, lane);
      softmax_pv<E16, false>(s, Vs, acc, m, l, scale, qrow, kt * KT, lane);
    }
    for (int kt = n_full * sub; kt < hi * sub; ++kt) {  // the diagonal tail
      stage(k, v, Ks, Vs, kt * KT);
      scores(qa, Ks, s, lane);
      softmax_pv<E16, true>(s, Vs, acc, m, l, scale, qrow, kt * KT, lane);
    }
    finish_l(l);
    store_out(o, qrow, acc, l, lane);
  }
}

// K4: K3 with the scores of sub-tile j+1 issued before the softmax and PV
// of sub-tile j over the unmasked range; two stages (buffers 0 and 1, by
// the sub-tile's parity) of K and V in dynamic shared memory, two S sets.
__global__ void __launch_bounds__(MAX_WARPS * 32)
flash_fwd_pipelined_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                           int seq, int block_q, int block_k, int causal, float scale_log2) {
  extern __shared__ uint4 smem_raw[];  // 16-byte aligned
  __nv_bfloat16* const smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* const Ks0 = smem;
  __nv_bfloat16* const Vs0 = smem + KT * LDS;
  __nv_bfloat16* const Ks1 = smem + 2 * KT * LDS;
  __nv_bfloat16* const Vs1 = smem + 3 * KT * LDS;

  const int i = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const size_t head = (size_t)blockIdx.y * seq * D;
  q += head;
  k += head;
  v += head;
  o += head;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qrow = i * block_q + warp * 16 + (lane >> 2);

  uint32_t qa[D / 16][4];
  load_q(q, qrow, qa, lane);
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float sa[KT / 8][4], sb[KT / 8][4];  // S of the even and the odd sub-tile

  const int hi = causal ? ((i + 1) * block_q + block_k - 1) / block_k : seq / block_k;
  const int n_full = causal ? (i * block_q) / block_k : hi;
  const int sub = block_k / KT;
  const int nf = n_full * sub;  // unmasked sub-tiles

  if (nf > 0) {
    stage(k, v, Ks0, Vs0, 0);
    scores(qa, Ks0, sa, lane);
  }
  for (int kt = 0; kt < nf; kt += 2) {
    // sa holds S of sub-tile kt (buffer 0); issue kt+1's scores first
    if (kt + 1 < nf) {
      stage(k, v, Ks1, Vs1, (kt + 1) * KT);
      scores(qa, Ks1, sb, lane);
    }
    softmax_pv<false, false>(sa, Vs0, acc, m, l, scale_log2, qrow, kt * KT, lane);
    if (kt + 1 >= nf) break;  // drained
    if (kt + 2 < nf) {
      stage(k, v, Ks0, Vs0, (kt + 2) * KT);
      scores(qa, Ks0, sa, lane);
    }
    softmax_pv<false, false>(sb, Vs1, acc, m, l, scale_log2, qrow, (kt + 1) * KT, lane);
  }
  for (int kt = nf; kt < hi * sub; ++kt) {  // the diagonal tail, not pipelined
    stage(k, v, Ks0, Vs0, kt * KT);
    scores(qa, Ks0, sa, lane);
    softmax_pv<false, true>(sa, Vs0, acc, m, l, scale_log2, qrow, kt * KT, lane);
  }
  finish_l(l);
  store_out(o, qrow, acc, l, lane);
}

bool bad_shape(int heads, int seq, int block_q, int block_k) {
  return heads <= 0 || seq <= 0 || block_q <= 0 || block_q % 16 ||
         block_q > MAX_WARPS * 16 || block_k <= 0 || block_k % KT || seq % block_q ||
         seq % block_k;
}

const float SCALE = (float)(1.0 / sqrt((double)D));  // the reference's f32 scale
const float SCALE_LOG2 = LOG2E / sqrtf((float)D);     // K3's and K4's

template <Step STEP>
int launch(const void* q, const void* k, const void* v, void* o, int heads, int seq,
           int block_q, int block_k, int causal, void* stream) {
  if (bad_shape(heads, seq, block_q, block_k) || (STEP == Step::kQkOnly && block_k < D))
    return cudaErrorInvalidValue;
  dim3 grid(seq / block_q, heads);
  flash_fwd_kernel<STEP><<<grid, (block_q / 16) * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), seq, block_q,
      block_k, causal, STEP == Step::kFull ? SCALE_LOG2 : SCALE);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                              int heads, int seq, int block_q, int block_k, int causal,
                              void* stream) {
  return launch<Step::kFull>(q, k, v, o, heads, seq, block_q, block_k, causal, stream);
}

extern "C" int flash_fwd_bf16exp(const void* q, const void* k, const void* v, void* o,
                                 int heads, int seq, int block_q, int block_k, int causal,
                                 void* stream) {
  return launch<Step::kBf16Exp>(q, k, v, o, heads, seq, block_q, block_k, causal, stream);
}

extern "C" int flash_softmax_stub(const void* q, const void* k, const void* v, void* o,
                                  int heads, int seq, int block_q, int block_k, int causal,
                                  void* stream) {
  return launch<Step::kStub>(q, k, v, o, heads, seq, block_q, block_k, causal, stream);
}

extern "C" int flash_qk_only(const void* q, const void* k, void* o, int heads, int seq,
                             int block_q, int block_k, int causal, void* stream) {
  return launch<Step::kQkOnly>(q, k, nullptr, o, heads, seq, block_q, block_k, causal,
                               stream);
}

extern "C" int flash_fwd_pipelined(const void* q, const void* k, const void* v, void* o,
                                   int heads, int seq, int block_q, int block_k, int causal,
                                   void* stream) {
  if (bad_shape(heads, seq, block_q, block_k)) return cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_pipelined_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PIPE_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(seq / block_q, heads);
  flash_fwd_pipelined_kernel<<<grid, (block_q / 16) * 32, PIPE_SMEM, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), seq, block_q,
      block_k, causal, SCALE_LOG2);
  return (int)cudaGetLastError();
}
