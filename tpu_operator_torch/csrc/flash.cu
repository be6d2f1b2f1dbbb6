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
// K4 flash_fwd_pipelined replaces variant "pipelined" (flashattn.py:209,
// pipe_body): the same function, with the scores of the next sub-tile
// issued before the softmax and PV of the current one over the unmasked
// range, then a drain, then the masked tail as K3 runs it.
// K5 flash_fwd_bf16exp replaces variant "bf16exp" (flashattn.py:153): as
// K3, but p = exp(bf16(s - m_new)) rounded to bf16, with the difference in
// natural-log units (s = q.k^T*scale rounded as the reference's product is,
// then exp taken as exp2f(x*log2e)), l summing that bf16 p, and the same p
// into PV.
// K6a flash_softmax_stub replaces variant "softmax_stub" (flashattn.py:192):
// for every k-block j < hi, unmasked, acc += bf16((q.k^T*scale)*0.001).v;
// output bf16(acc), no m, no l, no division.
// K6b flash_qk_only replaces variant "qk_only" (flashattn.py:181): for every
// k-block j < hi, unmasked, acc += (q.k^T*scale)[:, :128], the scores of
// the block's first 128 keys; output bf16(acc). V is never read.
//
// K7, the structural-variant instrument (tpu_operator_torch/workloads/
// fa_experiment.py), replaces the three modes of build() in
// scripts/fa_experiment.py (pallas_call at :133), all causal:
// K7a flash_fwd_paired replaces "paired" (:90-108): K3's function with
// sub-tiles paired over the unmasked range, so it equals K3.
// K7b flash_fwd_bf16s replaces "bf16s" (scores_b/soft_b, :52-67): the
// scores rounded to bf16 once, s_b = bf16(s*scale); m = max(m, rowmax s_b)
// kept in f32, natural-log units; p = exp(s_b - bf16(m)) in bf16; l sums p
// in f32; the masked tail is bf16 -inf. Its softmax runs on packed
// __nv_bfloat162 pairs (the S fragment's (e0, e1) and (e2, e3) are
// adjacent columns of rows g and g+8): __hmax2 for the row max, __hsub2
// and h2exp for p, and the packed p is the PV A fragment as it stands.
// K7c flash_fwd_paired16 replaces "paired16" (:69-89): K7b's softmax in
// K7a's pairing, so it equals K7b.
//
// Bound on an H100: operations. At the probe's shape (8 x 8192 x 128,
// causal) the two products are ~1.4e11 FLOPs against 67 MB of inputs and
// output, some 2000 FLOPs a byte, far above the ~295 at which bf16 tensor
// cores rather than memory set the pace: 0.139 ms at 989 TFLOPS. The
// instruments are bound the same way: K6a does both products over the
// causal tiling (1.4e11 FLOPs), K6b half of them.
//
// The Hopper kernel (flash_fwd_wgmma_kernel<STEP, BODY, STAGES>), eight
// instances: K3 <kFull, kOne, 2>, K5 <kBf16Exp, kOne, 2>, K7b <kBf16S,
// kOne, 2>, K7c <kBf16S, kPair, 4>, K7a <kFull, kPair, K7A_STAGES>, K4
// <kFull, kPipe, 3>, and the attribution stubs K6a <kStub, kOne, 2> and K6b
// <kQkOnly, kOne, 2>. STEP is the softmax, BODY the loop over the unmasked
// range. What bound the first K3 (a synchronous design, since deleted) was
// its staging and its products: every 64-key sub-tile was staged by 16-byte
// loads between two block barriers with no product running, at one
// 256-thread block per SM, and both products ran on the m16n8k16 warp-level
// MMA, which cannot reach the tensor cores' rate. Every other kernel is
// K3's function, K3's with another softmax, or K3's minus a phase, so they
// lost the same way (on an H100, 4.4-5.6x the time of PyTorch's
// scaled_dot_product_attention against K3's 1.46x) and take K3's design:
// - Host: a rank-3 tensor map per Q, K, V over (heads, seq, 128) bf16 with
//   64 x 64 x 1 boxes (one box row is 128 B) and 128-byte swizzle, D = 128
//   taking two boxes; cuTensorMapEncodeTiled is reached through the runtime
//   (cudaGetDriverEntryPoint*), so the library needs no -lcuda. The maps
//   are encoded on every call and passed as __grid_constant__ parameters.
//   Each instance has its own shared-memory attribute, set once per device.
// - Any seq: a box is addressed (column, row in its head, head), so one
//   that reaches past a head's last row is filled with zeros (OOB fill
//   NONE) and never reads the next head's rows. The mbarrier still counts
//   the whole box, fill included: a transaction count of the in-range
//   bytes alone never completes (checked on the H100 at seq 72, 100, 200
//   and 520, where a wrong count would hang the phase that runs them).
//   Zero keys are exact for causal attention, where every key past seq lies
//   above a real row's diagonal and is masked; a non-causal run masks keys
//   past seq - 1 in its last k-block. Rows past seq are computed on zeros
//   and never stored.
// - One block per (q-block, head) with one consumer warpgroup per 64 query
//   rows (block_q 128: two; 64: one). Thread 0 loads the block's Q once
//   and keeps K/V in a ring of STAGES stages of 64 keys, each behind a
//   "full" mbarrier (expect_tx); the stage of sub-tile j is refilled with
//   j+STAGES once every warp has arrived on its "empty" mbarrier, after
//   j's PV, so later sub-tiles load while j is computed. The kOne
//   instances have two stages: at 1 KB + 2 x 32 KB + 32 KB = 97 KB of
//   shared memory and at most 128 registers two 256-thread blocks share an
//   SM, so one block's warpgroups run their products while the other's run
//   the softmax; a third stage leaves room for one block and measured
//   slower on the H100.
// - S = Q.K^T: eight wgmma m64n64k16 over D, Q and the K stage both
//   K-major from shared memory by descriptor (SBO 1024 B, a k16 step 32 B
//   inside the swizzled row, the fifth step in the second box). PV: four
//   wgmma m64n128k16 over the sub-tile's keys, p from registers as the A
//   fragment, the V stage MN-major (the transpose bit; LBO 8 KB to the
//   second box of D, SBO 1024 B to the next 8 keys).
// - A warp's slice of a wgmma m64nN f32 accumulator is the m16n8 C
//   layout (rows g and g+8, columns 2t and 2t+1 of each 8-column tile)
//   repeated over N/8, and its p pairs are PV's register A fragment as they
//   stand. Each instance's softmax works in it (softmax_step): kFull
//   online_softmax<false> (log2 domain, scale*log2e, the masked-row guard);
//   kBf16Exp online_softmax<true> (the reference's s*scale, p =
//   bf16(exp(bf16(s - m_new))) already bf16, so packing it is exact);
//   kBf16S scores_b then softmax_b, whose packed p pairs are the A fragment
//   as they stand; kStub p = (s*scale)*0.001, no m, no l. No generic-proxy
//   write reaches the shared memory that TMA and wgmma use, so no proxy
//   fence is needed.
// - The logical tiling is the caller's (block_q, block_k) as on the TPU,
//   over ceil(seq/block_q) q-blocks and ceil(seq/block_k) k-blocks: a
//   causal q-block processes k-blocks [0, diag_stop(i)), cut at the last
//   k-block, the first n_full = i*block_q/block_k without a mask and the
//   rest masked, so the FLOPs performed are exactly causal_flops(seq, H, D,
//   block_q, block_k); heavier causal q-blocks are scheduled first. The
//   ring runs over the sub-tiles of every range with one counter, so its
//   stage and parity carry over from one loop into the next.
// - kOne, K3's body, per sub-tile: S, wait, softmax, PV, wait. PV is
//   waited for at the end: a wgmma chain in flight whose accumulators
//   another instruction defines is serialized by ptxas (C7515), so every
//   register a chain in flight reads or writes is final before
//   wgmma.fence, with fence_regs after each wait. Every body runs the
//   masked tail (and what its own loop leaves) on this one.
// - kPair, K7c's and K7a's body (the reference's body2), over the
//   unmasked range two sub-tiles kt, kt+1 at a time with two S accumulator
//   sets: S_a issued and committed, S_b issued (behind a wgmma.fence of its
//   own) and committed, wgmma.wait_group 1 so S_a has landed, softmax_a
//   while S_b runs on the tensor cores, PV_a, wait_group 0 (S_b and PV_a),
//   softmax_b, PV_b, wait. A pair holds two stages and its second S set
//   (K7c: 156 registers a thread against K3's 126) leaves one block an SM,
//   so its ring has more stages (K7c four, 161 KB). Then an odd leftover
//   sub-tile and the masked tail run K3's body: the reference's body1 and
//   tail. K7c rounds each S set to bf16 as its softmax starts (lazy
//   rounding); the reference rounds both before either softmax, the same
//   values in another order of issue.
// - kPipe, K4's body (the reference's pipe_body), over the unmasked range
//   one sub-tile at a time with the next S carried across iterations: S(kt)
//   has landed; S(kt+1) is issued into the other S set and runs on the
//   tensor cores while kt's softmax does; then PV(kt); wait_group 0 lands
//   both. Register arrays cannot be indexed at run time, so the loop is
//   unrolled by two with the sets alternating. The last unmasked sub-tile
//   (the drain, its S landed already) and the masked tail run K3's body.
//   Like K7c it holds two S sets (183 registers), so one block an SM. Its
//   ring keeps kt+1 resident while PV(kt) runs and has kt+2 loading by
//   then, which takes three stages (129 KB): with two, the load of kt+2
//   starts only once PV(kt) lands and S(kt+2) waits on it (K3/K4 0.74 on
//   the H100); three measured faster than four (1.076 against 1.041).
// - The stubs, K6a and K6b, are K3's structure minus one phase each (K6a
//   the softmax, K6b also PV and V), so the breakdown's differences read
//   that phase on K3 itself: the same kOne body, ring depth, warpgroups,
//   order of q-blocks and release protocol. Neither takes a faster body or
//   a deeper ring of its own. Both run every sub-tile of [0, hi) unmasked,
//   as the reference's stubs do (n_unmasked = n_tiles; the masked step is
//   never instantiated), and store acc with no division. K6b's ring carries
//   K alone: a stage is one 16 KB tile, its "full" barrier expects one
//   tile's bytes, no V map is encoded and no PV issued. Once sub-tile kt's
//   S has landed, part kt % (block_k/64) 0 adds s*scale into acc's n-tiles
//   0-7 and part 1 into 8-15 (the block's first 128 keys); the products of
//   parts 2 and up still run and are waited for before their stage is
//   released, then discarded. acc is never a wgmma accumulator there. Zero
//   keys past seq add exact zeros: K6a's p is bf16(0*scale*0.001) = 0
//   against a zero V row, K6b adds scores of 0.
// Instances of one STEP do, per element, the same arithmetic in the same
// k16 steps in the same order, so K4 and K7a equal K3 and K7c equals K7b
// bit for bit.
// Not done yet: warp specialisation (a producer warp, setmaxnreg), the next
// S product overlapped with the current softmax in K3 itself (K4's body at
// two blocks an SM), persistent blocks, clusters and multicast. In the kOne
// instances the softmax still runs between the two products with the
// tensor cores idle, hidden only by a second block on the SM.

#include <cuda_bf16.h>
#include <math.h>

#include <atomic>

#include "tma.cuh"

namespace {

constexpr int D = 128;        // head_dim; the wrapper refuses anything else
constexpr int KT = 64;        // keys per shared-memory sub-tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float STUB_SCALE = 0.001f;  // softmax_stub's p = bf16((s*scale)*0.001)

enum class Step { kFull, kBf16Exp, kStub, kQkOnly, kBf16S };

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// The masked path's test: key kpos is hidden from fragment row qrow + r*8
// when it lies above the row's diagonal or past seq (a partial last
// k-block's zeros). diag_off is a kernel parameter: 0 for a causal run,
// NO_DIAGONAL for a non-causal one, whose keys only seq bounds. For a row
// of seq the bound at seq adds nothing to the causal mask; rows past seq
// are never stored. Taking the offset and seq from the kernel's parameters
// keeps both out of registers and gives the compiler no causal branch to
// duplicate the masked path on (either costs K3 its second block an SM or
// a few percent on the H100).
constexpr int NO_DIAGONAL = 1 << 30;
__device__ __forceinline__ bool hidden(int kpos, int qrow, int r, int diag_off, int seq) {
  return kpos > qrow + r * 8 + diag_off || kpos >= seq;
}

// The k-blocks q-block i processes, [0, hi), and how many of them run
// unmasked, n_full: causal, through diag_stop(i) as the TPU kernel computes
// it, cut at the last k-block, the blocks below the diagonal of the
// q-block's first row unmasked; otherwise every k-block, with a partial
// last one masked.
struct KRange {
  int hi, n_full;
};
__device__ __forceinline__ KRange k_range(int i, int seq, int block_q, int block_k, int causal) {
  const int n_k = cdiv(seq, block_k);
  if (!causal) return {n_k, seq / block_k};
  return {min(cdiv((i + 1) * block_q, block_k), n_k), (i * block_q) / block_k};
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}

__device__ __forceinline__ __nv_bfloat162 bf16x2(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One online-softmax step of one warp's 16 rows against one 64-key sub-tile
// whose scores are in s: s becomes p, m and l move on, acc is rescaled.
// BF16EXP false (K3, K4, K7a): scale is scale*log2e and m lives in the
// log2 domain. BF16EXP true (K5): scale is 1/sqrt(D), m is in natural-log
// units, p = bf16(exp(bf16(s - m_new))) and l sums that p. s and acc are
// a warp's slices of wgmma m64nN accumulators, in the m16n8 C layout.
// MASKED hides the keys hidden() names.
template <bool BF16EXP, bool MASKED>
__device__ __forceinline__ void online_softmax(float (&s)[KT / 8][4], float (&acc)[D / 8][4],
                                               float (&m)[2], float (&l)[2], float scale,
                                               int qrow, int k0, int lane, int diag_off,
                                               int seq) {
  const int t = lane & 3;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // K5 keeps the product rounded, as the reference's s = dot*scale is
      float v = BF16EXP ? __fmul_rn(s[nt][e], scale) : s[nt][e] * scale;
      if (MASKED && hidden(k0 + nt * 8 + 2 * t + (e & 1), qrow, e >> 1, diag_off, seq))
        v = -INFINITY;
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
}

// K7b's and K7c's scores_b on packed bf16 pairs: sb[nt][r] = bf16(s*scale) of row
// g + 8r, columns 2t and 2t+1 of n-tile nt, with bf16 -inf where MASKED
// hides a key.
template <bool MASKED>
__device__ __forceinline__ void scores_b(const float (&s)[KT / 8][4], uint32_t (&sb)[KT / 8][2],
                                         float scale, int qrow, int k0, int lane, int diag_off,
                                         int seq) {
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < KT / 8; ++nt) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // the product kept rounded, as the reference's s*scale is
      v[e] = __fmul_rn(s[nt][e], scale);
      if (MASKED && hidden(k0 + nt * 8 + 2 * t + (e & 1), qrow, e >> 1, diag_off, seq))
        v[e] = -INFINITY;
    }
    sb[nt][0] = bits(__floats2bfloat162_rn(v[0], v[1]));
    sb[nt][1] = bits(__floats2bfloat162_rn(v[2], v[3]));
  }
}

// The softmax of the reference's soft_b (K7b, K7c) on the packed scores sb: m_new = max(m,
// rowmax s_b) in f32, natural-log units; alpha = exp(m - m_new) in f32;
// sb becomes p = exp(s_b - bf16(m_new)) in bf16; l = alpha*l + sum_f32 p;
// acc is rescaled by alpha. The packed p is the PV A fragment as it stands.
__device__ __forceinline__ void softmax_b(uint32_t (&sb)[KT / 8][2], float (&acc)[D / 8][4],
                                          float (&m)[2], float (&l)[2]) {
  float alpha[2];
  __nv_bfloat162 ref2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat162 mx2 = bf16x2(sb[0][r]);
#pragma unroll
    for (int nt = 1; nt < KT / 8; ++nt) mx2 = __hmax2(mx2, bf16x2(sb[nt][r]));
    float mx = fmaxf(__low2float(mx2), __high2float(mx2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(m[r], mx);  // a max of bf16 values: bf16(m_new) is exact
    // a row with every key so far masked keeps m = -inf; use 0 as its
    // reference so exp sees -inf - 0 and gives 0, never NaN
    const float ref = mx == -INFINITY ? 0.f : mx;
    alpha[r] = exp2f((m[r] - ref) * LOG2E);
    m[r] = mx;
    ref2[r] = __float2bfloat162_rn(ref);
  }
  float lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const __nv_bfloat162 p = h2exp(__hsub2(bf16x2(sb[nt][r]), ref2[r]));
      sb[nt][r] = bits(p);
      lsum[r] += __low2float(p) + __high2float(p);
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
}

// o = bf16(acc * inv) for a warp's 16 rows, each only if it is a row of
// seq (rows qrow and qrow + 8 may straddle it); inv = 1/l summed over the
// quad, or 1 for the stubs.
__device__ __forceinline__ void store_out(__nv_bfloat16* __restrict__ o, int qrow, int seq,
                                          const float (&acc)[D / 8][4], const float (&inv)[2],
                                          int lane) {
  const int t = lane & 3;
  const bool in0 = qrow < seq, in1 = qrow + 8 < seq;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    __nv_bfloat16* out = o + (size_t)qrow * D + nt * 8 + 2 * t;
    if (in0)
      *reinterpret_cast<uint32_t*>(out) = pack_bf16(acc[nt][0] * inv[0], acc[nt][1] * inv[0]);
    if (in1)
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

// ---------------------------------------------------------------------------
// The Hopper kernel (every flash kernel): a TMA ring of K/V sub-tiles and
// both products on wgmma.

// The loop over the unmasked range: one sub-tile a trip (K3, K5, K6a, K6b,
// K7b), two with two S sets (K7a, K7c), or one with the next S carried
// across trips (K4).
enum class Body { kOne, kPair, kPipe };

constexpr int K3_STAGES = 2;                 // stages in the kOne instances' ring
constexpr int K7C_STAGES = 4;                // K7c's: a pair holds two at once
constexpr int K7A_STAGES = 4;                // K7a's: four measured faster than three
constexpr int K4_STAGES = 3;                 // K4's: kt+1 resident under PV(kt), kt+2 loading
constexpr int BOX_COLS = 64;                 // a TMA box: 64 bf16 = one 128-byte swizzled row
constexpr int HALF_BYTES = KT * BOX_COLS * 2;  // one 64 x 64 box: 8 KB
constexpr int TILE_BYTES = 2 * HALF_BYTES;   // 64 rows x D: two boxes, 16 KB
constexpr int ATOM_BYTES = 1024;             // 8 rows x 128 B: the 128-byte swizzle atom
constexpr int MAX_WG = 2;                    // consumer warpgroups: block_q 128

// The tiles a stage of STEP's ring holds: K and V, or K alone (K6b).
__host__ __device__ constexpr int stage_tiles(Step step) {
  return step == Step::kQkOnly ? 1 : 2;
}

// One 64-row x 64-column box at (col, row, head) of a (heads, seq, D)
// tensor map into shared memory, 128-byte swizzled, rows past seq filled
// with zeros; completion lands on bar.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, int col, int row,
                                        int head, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (128B
// swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma wait: each register passes through an empty asm.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(r[i][e])::"memory");
}

#define F4(a, i) "+f"(a[i][0]), "+f"(a[i][1]), "+f"(a[i][2]), "+f"(a[i][3])

// s = Q.K^T over one k16 step, or s += it when accumulate: m64n64k16 for
// one warpgroup, Q (A) and the K stage (B) both K-major in shared memory.
__device__ __forceinline__ void wgmma_qk(float (&s)[KT / 8][4], uint64_t qd, uint64_t kd,
                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : F4(s, 0), F4(s, 1), F4(s, 2), F4(s, 3), F4(s, 4), F4(s, 5), F4(s, 6), F4(s, 7)
      : "l"(qd), "l"(kd), "r"(accumulate));
}

// acc += P.V over one k16 step (16 keys): m64n128k16 for one warpgroup, P
// from registers (a warp's m16n8k16 A fragment), the V stage
// from shared memory. V rows are keys with D contiguous, so B is MN-major:
// the transpose bit.
__device__ __forceinline__ void wgmma_pv(float (&acc)[D / 8][4], const uint32_t (&pa)[4],
                                         uint64_t vd) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F4(acc, 0), F4(acc, 1), F4(acc, 2), F4(acc, 3), F4(acc, 4), F4(acc, 5), F4(acc, 6),
        F4(acc, 7), F4(acc, 8), F4(acc, 9), F4(acc, 10), F4(acc, 11), F4(acc, 12),
        F4(acc, 13), F4(acc, 14), F4(acc, 15)
      : "r"(pa[0]), "r"(pa[1]), "r"(pa[2]), "r"(pa[3]), "l"(vd), "r"(1));
}

#undef F4

// S = Q.K^T of one warpgroup's 64 rows against one staged 64-key sub-tile:
// eight k16 steps over D. A step moves 32 B inside a 128-byte swizzled row,
// and the fifth crosses into the second 64-column box.
__device__ __forceinline__ void qk_wgmma(float (&s)[KT / 8][4], uint32_t q_tile, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * HALF_BYTES + (kk % 4) * 32;
    wgmma_qk(s, smem_desc(q_tile + off, 16, ATOM_BYTES), smem_desc(k_tile + off, 16, ATOM_BYTES),
             kk > 0);
  }
}

// p's bf16 A fragments for the four k16 steps of a sub-tile, in the S
// fragment's layout, all made before the products start.
__device__ __forceinline__ void pack_p(const float (&p)[KT / 8][4], uint32_t (&pa)[KT / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    pa[kk][0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[kk][1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[kk][2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
}

// acc += bf16(p).V for one sub-tile: four k16 steps of 16 keys, each 16
// rows (2048 B) further into the V stage. LBO is the step to the second
// 64-column box of D, SBO the step to the next 8 keys.
__device__ __forceinline__ void pv_wgmma(const uint32_t (&pa)[KT / 16][4], uint32_t v_tile,
                                         float (&acc)[D / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
    wgmma_pv(acc, pa[kk], smem_desc(v_tile + kk * 16 * 128, HALF_BYTES, ATOM_BYTES));
}

// The Hopper kernel's softmax of one sub-tile: m and l move on, acc is
// rescaled, and s (the sub-tile's raw dot products) becomes p. kFull (K3):
// online_softmax in the log2 domain, p left in s in f32. kBf16Exp (K5):
// online_softmax on the reference's s*scale, p left in s already rounded
// to bf16. kBf16S (K7b, K7c): scores_b, rounded as the softmax starts (lazy
// rounding), then softmax_b, whose packed p pairs are written to pa, the
// PV A fragments, as they stand. kStub (K6a): no softmax, p = (s*scale) *
// 0.001 multiplied in that order, m and l untouched; MASKED is never set.
template <Step STEP, bool MASKED>
__device__ __forceinline__ void softmax_step(float (&s)[KT / 8][4], uint32_t (&pa)[KT / 16][4],
                                             float (&acc)[D / 8][4], float (&m)[2],
                                             float (&l)[2], float scale, int qrow, int k0,
                                             int lane, int diag_off, int seq) {
  if constexpr (STEP == Step::kBf16S) {
    uint32_t sb[KT / 8][2];
    scores_b<MASKED>(s, sb, scale, qrow, k0, lane, diag_off, seq);
    softmax_b(sb, acc, m, l);
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      pa[kk][0] = sb[2 * kk][0];
      pa[kk][1] = sb[2 * kk][1];
      pa[kk][2] = sb[2 * kk + 1][0];
      pa[kk][3] = sb[2 * kk + 1][1];
    }
  } else if constexpr (STEP == Step::kStub) {
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = (s[nt][e] * scale) * STUB_SCALE;
  } else {
    online_softmax<STEP == Step::kBf16Exp, MASKED>(s, acc, m, l, scale, qrow, k0, lane, diag_off,
                                                   seq);
  }
}

// K6b's step in place of softmax and PV: the scores of a k-block's first
// 128 keys, s*scale of part 0 (its keys 0-63) added into acc's n-tiles 0-7
// and of part 1 into n-tiles 8-15; a later part's are discarded.
static_assert(D == 2 * KT, "K6b's two parts fill acc's columns");
__device__ __forceinline__ void add_scores(const float (&s)[KT / 8][4], float (&acc)[D / 8][4],
                                           int part, float scale) {
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
}

// p's A fragments after softmax_step: K3's and K5's p packed from s (K5's
// exactly, it is bf16 already); K7b's and K7c's are in pa. Packing once after the
// masked/unmasked branch, not in each, keeps K3 at 126 registers (138
// otherwise, which leaves one block an SM).
template <Step STEP>
__device__ __forceinline__ void pack_step(const float (&s)[KT / 8][4],
                                          uint32_t (&pa)[KT / 16][4]) {
  if constexpr (STEP != Step::kBf16S) pack_p(s, pa);
}

// K3 <kFull, kOne, K3_STAGES>, K5 <kBf16Exp, kOne, K3_STAGES>, K7b
// <kBf16S, kOne, K3_STAGES>, K7c <kBf16S, kPair, K7C_STAGES>, K7a <kFull,
// kPair, K7A_STAGES>, K4 <kFull, kPipe, K4_STAGES>, and the stubs K6a
// <kStub, kOne, K3_STAGES> and K6b <kQkOnly, kOne, K3_STAGES>. Dynamic
// shared memory, 1024-aligned: STAGES K tiles, STAGES V tiles (none in
// K6b), then Q (one 16 KB tile per warpgroup). Thread 0 drives the ring:
// it loads Q and the first STAGES sub-tiles, and refills the stage of
// sub-tile j with j+STAGES once every warp has arrived on that stage's
// "empty" barrier (release(j)). A warp arrives once its PV of j (K6b: its
// S of j) has been waited for and its next S is issued (kOne: has landed).
// kPair (K7a, K7c) runs the unmasked range two sub-tiles a body with two S
// accumulator sets: S_a and S_b are issued, S_b runs on the tensor cores
// while softmax_a runs, then PV_a, then softmax_b and PV_b. kPipe (K4)
// runs it one sub-tile a trip, S of the next on the tensor cores while
// this one's softmax runs, then its PV.
template <Step STEP, Body BODY, int STAGES>
__global__ void __launch_bounds__(MAX_WG * 128, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                       int seq, int block_q, int block_k, int diag_off, float scale) {
  constexpr bool STUB = STEP == Step::kStub || STEP == Step::kQkOnly;
  extern __shared__ uint4 smem_raw[];  // aligned to 1024 below
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], qbar;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + ATOM_BYTES - 1) & ~(uint32_t)(ATOM_BYTES - 1);
  const uint32_t k_tiles = base, v_tiles = base + STAGES * TILE_BYTES;
  const uint32_t q_tiles = base + stage_tiles(STEP) * STAGES * TILE_BYTES;

  const int i = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int head = blockIdx.y;
  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qrow = i * block_q + warp * 16 + (lane >> 2);

  const KRange range = k_range(i, seq, block_q, block_k, diag_off == 0);
  const int sub = block_k / KT;
  // the stubs run every sub-tile of [0, hi) unmasked
  const int n_tiles = range.hi * sub, n_unmasked = STUB ? n_tiles : range.n_full * sub;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), blockDim.x >> 5);
    }
    mbar_init(smem_u32(&qbar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load_kv = [&](int kt) {  // thread 0 only
    const int s = kt % STAGES;
    const uint32_t bar = smem_u32(&full[s]);
    mbar_expect_tx(bar, stage_tiles(STEP) * TILE_BYTES);
    for (int h = 0; h < 2; ++h) {
      tma_box(k_tiles + s * TILE_BYTES + h * HALF_BYTES, &kmap, h * BOX_COLS, kt * KT, head, bar);
      if constexpr (STEP != Step::kQkOnly)
        tma_box(v_tiles + s * TILE_BYTES + h * HALF_BYTES, &vmap, h * BOX_COLS, kt * KT, head,
                bar);
    }
  };
  // this warp is done with sub-tile j's stage; thread 0 refills it with
  // j+STAGES once every warp is
  auto release = [&](int j) {
    const int st = j % STAGES;
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[st]));
    if (threadIdx.x == 0 && j + STAGES < n_tiles) {
      mbar_wait(smem_u32(&empty[st]), (j / STAGES) & 1);
      load_kv(j + STAGES);
    }
    __syncwarp();
  };
  if (threadIdx.x == 0) {
    const uint32_t bar = smem_u32(&qbar);
    mbar_expect_tx(bar, block_q * D * 2);  // whole boxes, zero fill included
    for (int r = 0; r < block_q / 64; ++r)
      for (int h = 0; h < 2; ++h)
        tma_box(q_tiles + r * TILE_BYTES + h * HALF_BYTES, &qmap, h * BOX_COLS,
                i * block_q + r * 64, head, bar);
    for (int kt = 0; kt < STAGES && kt < n_tiles; ++kt) load_kv(kt);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[KT / 8][4];
  uint32_t pa[KT / 16][4];
  const uint32_t q_tile = q_tiles + wg * TILE_BYTES;
  // dst = S of sub-tile j, landed (K3's body, K4's prologue)
  auto scores_landed = [&](float (&dst)[KT / 8][4], int j) {
    const int st = j % STAGES;
    mbar_wait(smem_u32(&full[st]), (j / STAGES) & 1);
    wgmma_fence();
    qk_wgmma(dst, q_tile, k_tiles + st * TILE_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dst);
  };
  mbar_wait(smem_u32(&qbar), 0);

  int kt = 0;
  if constexpr (BODY == Body::kPair) {
    float s2[KT / 8][4];  // S of the pair's second sub-tile
    for (; kt + 1 < n_unmasked; kt += 2) {  // below the diagonal, two at a time
      const int sta = kt % STAGES, stb = (kt + 1) % STAGES;
      mbar_wait(smem_u32(&full[sta]), (kt / STAGES) & 1);
      wgmma_fence();
      qk_wgmma(s, q_tile, k_tiles + sta * TILE_BYTES);
      wgmma_commit();
      // kt-1's PV was waited for at the end of the last body; with two
      // stages its stage is the one kt+1 loads into
      if (kt > 0) release(kt - 1);
      mbar_wait(smem_u32(&full[stb]), ((kt + 1) / STAGES) & 1);
      // s2's registers may have moved since the first fence: without this
      // one ptxas injects a warpgroup.arrive here (C7519)
      wgmma_fence();
      qk_wgmma(s2, q_tile, k_tiles + stb * TILE_BYTES);
      wgmma_commit();
      wgmma_wait<1>();  // S_a has landed; S_b runs on while softmax_a does
      fence_regs(s);
      softmax_step<STEP, false>(s, pa, acc, m, l, scale, qrow, kt * KT, lane, diag_off, seq);
      pack_step<STEP>(s, pa);
      fence_regs(acc);
      wgmma_fence();
      pv_wgmma(pa, v_tiles + sta * TILE_BYTES, acc);
      wgmma_commit();
      wgmma_wait<0>();  // S_b and PV_a
      fence_regs(s2);
      fence_regs(acc);
      release(kt);
      softmax_step<STEP, false>(s2, pa, acc, m, l, scale, qrow, (kt + 1) * KT, lane,
                                diag_off, seq);
      pack_step<STEP>(s2, pa);
      fence_regs(acc);
      wgmma_fence();
      pv_wgmma(pa, v_tiles + stb * TILE_BYTES, acc);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
  } else if constexpr (BODY == Body::kPipe) {
    float s2[KT / 8][4];  // the other S set: S(j+1) while j's softmax runs
    // One sub-tile j of the unmasked range: S(j) has landed in cur. S(j+1)
    // is issued into nxt and runs on the tensor cores while j's softmax
    // does, then PV(j); one wait lands both. Nothing writes nxt while it
    // is in flight, and acc is final before PV's fence (no C7515).
    auto pipe_step = [&](float (&cur)[KT / 8][4], float (&nxt)[KT / 8][4], int j) {
      const int st = j % STAGES, nx = (j + 1) % STAGES;
      // j-1's PV landed at the end of the last step; with two stages its
      // stage is the one j+1 loads into
      if (j > 0) release(j - 1);
      mbar_wait(smem_u32(&full[nx]), ((j + 1) / STAGES) & 1);
      wgmma_fence();
      qk_wgmma(nxt, q_tile, k_tiles + nx * TILE_BYTES);
      wgmma_commit();
      softmax_step<STEP, false>(cur, pa, acc, m, l, scale, qrow, j * KT, lane, diag_off, seq);
      pack_step<STEP>(cur, pa);
      fence_regs(acc);
      wgmma_fence();
      pv_wgmma(pa, v_tiles + st * TILE_BYTES, acc);
      wgmma_commit();
      wgmma_wait<0>();  // S(j+1) and PV(j)
      fence_regs(nxt);
      fence_regs(acc);
    };
    if (n_unmasked > 0) scores_landed(s, 0);  // the prologue
    // unrolled by two, the sets alternating: S(kt) is in s on every entry
    for (; kt + 1 < n_unmasked; kt += 2) {
      pipe_step(s, s2, kt);
      if (kt + 2 == n_unmasked) {  // S(kt+1), the drain's, landed in s2
#pragma unroll
        for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = s2[nt][e];
        ++kt;
        break;
      }
      pipe_step(s2, s, kt + 1);
    }
  }
  // K3's body: every sub-tile of the kOne instances; K7c's odd leftover,
  // K4's drain (kt = n_unmasked - 1, its S in s already) and the masked
  // tail, the ring counter kt carrying on from the body above
  for (; kt < n_tiles; ++kt) {
    const int st = kt % STAGES;
    if (BODY != Body::kPipe || kt + 1 != n_unmasked) scores_landed(s, kt);
    if (kt > 0) release(kt - 1);
    if constexpr (STEP == Step::kQkOnly) {
      // S has landed (every part's, kept or discarded) before its stage is
      // released in the next trip; acc is written only here, after the wait
      add_scores(s, acc, kt % sub, scale);
    } else {
      if constexpr (STUB)  // every sub-tile unmasked
        softmax_step<STEP, false>(s, pa, acc, m, l, scale, qrow, kt * KT, lane, diag_off, seq);
      else if (kt < n_unmasked)  // below the diagonal: no mask
        softmax_step<STEP, false>(s, pa, acc, m, l, scale, qrow, kt * KT, lane, diag_off, seq);
      else  // the diagonal tail
        softmax_step<STEP, true>(s, pa, acc, m, l, scale, qrow, kt * KT, lane, diag_off, seq);
      pack_step<STEP>(s, pa);
      // the rescaled acc and p's fragments are final before the products
      // start: a register an instruction defines inside the wgmma chain
      // would make ptxas serialize it
      fence_regs(acc);
      wgmma_fence();
      pv_wgmma(pa, v_tiles + st * TILE_BYTES, acc);
      wgmma_commit();
      // PV is waited for here and not behind the next S: ptxas serializes a
      // wgmma chain whose accumulators another instruction defines while it
      // is in flight, which the next S's would be
      wgmma_wait<0>();
      fence_regs(acc);
    }
  }
  if constexpr (STUB) {  // no l: acc as it stands
    const float one[2] = {1.f, 1.f};
    store_out(o + (size_t)head * seq * D, qrow, seq, acc, one, lane);
  } else {
    finish_l(l);
    store_out(o + (size_t)head * seq * D, qrow, seq, acc, l, lane);
  }
}

// block_q whole warpgroups (64 or 128), block_k a multiple of 64, any
// seq: the last q-block and k-block may be partial.
bool bad_shape(int heads, int seq, int block_q, int block_k) {
  return heads <= 0 || seq <= 0 || block_q <= 0 || block_q % 64 || block_q > MAX_WG * 64 ||
         block_k <= 0 || block_k % KT;
}

const float SCALE = (float)(1.0 / sqrt((double)D));  // the reference's f32 scale
const float SCALE_LOG2 = LOG2E / sqrtf((float)D);     // K3's, K4's and K7a's


// A tensor map over a contiguous (heads, seq, D) bf16 array: 64 x 64 x 1
// boxes (one box row is 128 B), 128-byte swizzle, as the wgmma descriptors
// read it. A box is addressed within one head, so rows past seq are filled
// with zeros (FLOAT_OOB_FILL_NONE), never read from the next head.
bool tile_map(CUtensorMap* map, const void* ptr, int heads, int seq) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)seq, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)seq * D * 2};
  const cuuint32_t box[3] = {BOX_COLS, KT, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The Hopper kernel's dynamic shared memory: 1 KB alignment slack, a K
// and a V tile per stage (K alone in K6b), a Q tile per warpgroup.
constexpr int wgmma_smem(Step step, int stages, int warpgroups) {
  return ATOM_BYTES + stage_tiles(step) * stages * TILE_BYTES + warpgroups * TILE_BYTES;
}

// An instance's dynamic shared memory allowed on the current device, once
// per instance and device (a function attribute belongs to one function
// in the device's context).
template <Step STEP, Body BODY, int STAGES>
cudaError_t allow_wgmma_smem() {
  static std::atomic<bool> done[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<STEP, BODY, STAGES>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wgmma_smem(STEP, STAGES, MAX_WG));
  if (err == cudaSuccess) done[dev].store(true);
  return err;
}

// Every flash kernel: bad_shape's tiling, any seq; K6b also block_k >= D,
// so a k-block's first two parts are its first 128 keys, and no V (v is
// null, and cuTensorMapEncodeTiled fails on a null address). No fallback:
// a map that cannot be encoded or a refused launch is an error the caller
// raises.
template <Step STEP, Body BODY, int STAGES>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int heads, int seq,
                 int block_q, int block_k, int causal, float scale, void* stream) {
  if (bad_shape(heads, seq, block_q, block_k) || (STEP == Step::kQkOnly && block_k < D))
    return cudaErrorInvalidValue;
  CUtensorMap maps[3] = {};
  if (!tile_map(&maps[0], q, heads, seq) || !tile_map(&maps[1], k, heads, seq) ||
      (stage_tiles(STEP) == 2 && !tile_map(&maps[2], v, heads, seq)))
    return cudaErrorInvalidValue;
  const cudaError_t attr = allow_wgmma_smem<STEP, BODY, STAGES>();
  if (attr != cudaSuccess) return (int)attr;
  const int smem = wgmma_smem(STEP, STAGES, block_q / 64);
  dim3 grid(cdiv(seq, block_q), heads);
  flash_fwd_wgmma_kernel<STEP, BODY, STAGES><<<grid, block_q * 2, smem, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), seq, block_q, block_k,
      causal ? 0 : NO_DIAGONAL, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                              int heads, int seq, int block_q, int block_k, int causal,
                              void* stream) {
  return launch_wgmma<Step::kFull, Body::kOne, K3_STAGES>(q, k, v, o, heads, seq, block_q, block_k,
                                                    causal, SCALE_LOG2, stream);
}

extern "C" int flash_fwd_bf16exp(const void* q, const void* k, const void* v, void* o,
                                 int heads, int seq, int block_q, int block_k, int causal,
                                 void* stream) {
  return launch_wgmma<Step::kBf16Exp, Body::kOne, K3_STAGES>(q, k, v, o, heads, seq, block_q, block_k,
                                                       causal, SCALE, stream);
}

extern "C" int flash_softmax_stub(const void* q, const void* k, const void* v, void* o,
                                  int heads, int seq, int block_q, int block_k, int causal,
                                  void* stream) {
  return launch_wgmma<Step::kStub, Body::kOne, K3_STAGES>(q, k, v, o, heads, seq, block_q,
                                                          block_k, causal, SCALE, stream);
}

extern "C" int flash_qk_only(const void* q, const void* k, void* o, int heads, int seq,
                             int block_q, int block_k, int causal, void* stream) {
  return launch_wgmma<Step::kQkOnly, Body::kOne, K3_STAGES>(q, k, nullptr, o, heads, seq, block_q,
                                                            block_k, causal, SCALE, stream);
}

extern "C" int flash_fwd_bf16s(const void* q, const void* k, const void* v, void* o,
                               int heads, int seq, int block_q, int block_k, int causal,
                               void* stream) {
  return launch_wgmma<Step::kBf16S, Body::kOne, K3_STAGES>(q, k, v, o, heads, seq, block_q, block_k,
                                                        causal, SCALE, stream);
}

extern "C" int flash_fwd_pipelined(const void* q, const void* k, const void* v, void* o,
                                   int heads, int seq, int block_q, int block_k, int causal,
                                   void* stream) {
  return launch_wgmma<Step::kFull, Body::kPipe, K4_STAGES>(q, k, v, o, heads, seq, block_q, block_k,
                                                        causal, SCALE_LOG2, stream);
}

extern "C" int flash_fwd_paired(const void* q, const void* k, const void* v, void* o,
                                int heads, int seq, int block_q, int block_k, int causal,
                                void* stream) {
  return launch_wgmma<Step::kFull, Body::kPair, K7A_STAGES>(q, k, v, o, heads, seq, block_q,
                                                            block_k, causal, SCALE_LOG2, stream);
}

extern "C" int flash_fwd_paired16(const void* q, const void* k, const void* v, void* o,
                                  int heads, int seq, int block_q, int block_k, int causal,
                                  void* stream) {
  return launch_wgmma<Step::kBf16S, Body::kPair, K7C_STAGES>(q, k, v, o, heads, seq, block_q, block_k,
                                                     causal, SCALE, stream);
}
