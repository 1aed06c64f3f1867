// JT-fwd and JT-bwd: one pre-norm cross-attention layer of the Jacobian
// transformer (models/transformer.py), forward and backward, per tile of
// points.
//
// Replaces no TPU kernel: the JAX module (neural_jacobian_field_tpu/models/
// transformer.py) is left to XLA. Added because PyTorch runs the layer as
// ~25 kernels a layer whose [N, 512] q, scores, softmax and attention output
// (and their gradients) go through device memory as strided copies and
// float32 passes: ~40 ms of a 58 ms stage-2 step at N = 458,752. For each
// point, with x its float32 residual [64], K, V the [A, 512] keys and values
// (A <= 8, the same for every point: they come from the index embedding),
// bf16 matmul operands with float32 accumulation:
//   a1  = bf16(LN1(x))                       (statistics float32, E[x^2] -
//                                             mean^2 clamped at 0, eps 1e-6)
//   q_h = bf16(a1 Wq_h^T)                    h < 8 heads of 64
//   s_h = bf16(bf16(q_h K_h^T) * scale)      float32 softmax over the A keys
//   p_h = bf16(softmax(s_h)),  o_h = bf16(p_h V_h)
//   x1  = x + bf16(o Wout^T + b_out)
//   a2  = bf16(LN2(x1)),  g = bf16(gelu(bf16(a2 W1^T + b1)))  (exact erf)
//   y   = x1 + bf16(g W2^T + b2)
// the rounding points of the per-op module, so the two track each other.
//
// What bounds it on the H100: compute, at a few percent of it. A point
// costs 163,840 operations forward (~0.49 MFLOP forward and backward)
// against 512 bytes of float32 residual in and out. At 458,752 points a
// layer's bound is ~0.08 ms forward and ~0.15 ms backward, by operations.
// The design:
//   - One block per SM, persistent, 4 warpgroups walking their own tiles of
//     64 points. The layer's weights (W_q, W_out, fc1, fc2, and K, V padded
//     to 16 keys a head: 176 KB of bf16) come into shared memory once per
//     block by TMA, in the 128-byte swizzle; every product reads them there,
//     K-major (the forward's) or MN-major (the backward's products through
//     W^T): one copy serves both directions.
//   - Activations stay in registers: each product is wgmma with A from
//     registers; an accumulator, rounded and packed to bf16x2, is the next
//     product's A fragment. A head's q [64, 64], scores [64, 16], softmax
//     and output [64, 64] never leave the warpgroup; the 8 heads' outputs
//     accumulate into one to_out accumulator. Nothing [N, 512] is written.
//     The chain is a serial run of small products, so the tensor cores wait
//     on each one's latency: the warpgroups of a block hide it for each
//     other (2 -> 4 took JT-fwd from 0.49 to 0.34 ms at 458,752 points).
//   - The training forward also saves what the backward would otherwise
//     recompute: x1 (float32) and each head's bf16 p and scores (384 bytes a
//     point). The backward (JT-grad, the gradient chain) so
//     runs no attention forward: from x it takes LN1's statistics and a1,
//     from x1 the MLP half again, then the gradient chain to dx in float32,
//     each head's softmax again from its saved scores (float32, as the
//     forward's). Weight gradients: per point the chain writes bf16 operands
//     (a1, a2, g as A; dscore, bf16(dx1), bf16(dh), bf16(dy) as G; the saved
//     p is R's A) to a scratch [slots, n, 64] with streaming stores, and a
//     split-K wgmma pass computes A^T G over points with a fixed order: M =
//     a1^T dscore [64, 8 x 8], R = p^T bf16(dx1) [8 x 8, 64], a2^T dh
//     and g^T dy. The caller forms from M and R the gradients of W_q and K
//     (dW_q,h = K_h^T M_h^T, dK_h = M_h^T W_q,h) and of W_out and V (dW_out,h
//     = R_h^T V_h, dV_h = R_h W_out,h): the [N, 512] dq and attention output
//     are never formed. The bias and LayerNorm gradients are column sums in
//     registers and shuffles, added per warp in shared memory in tile order
//     (no barrier), then over the block's warps and over the blocks, in
//     order. No atomics: the same bits on every call.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tma.cuh"

namespace {
namespace jt {

constexpr int kPts = 64;                  // points per warpgroup tile
constexpr int kFwdWgs = 4;                // JT-fwd's warpgroups a block (128 registers)
constexpr int kBwdWgs = 4;                // the gradient chain's (128 registers)
constexpr int kBox = 64 * 128;            // a TMA box: 64 rows x 128 bytes
// Rows of the packed weights (bf16 [kRows, 64], ops/kernels/attn_layer.py
// `pack_weights`): W_q [512 = 8 x 64 out, 64 in] at 0, W_out's 8 column
// blocks [64 out, 64 in of head h] at 512 + 64 h, fc1 [64 hidden (zero
// padded), 64 in] at 1024, fc2 [64 out, 64 hidden] at 1088, K and V [8 heads
// x 16 key rows, 64] at 1152 and 1280: a head's products run over 16 keys,
// the rows past its keys zero and their scores -inf.
constexpr int kRowWq = 0, kRowWo = 512, kRowW1 = 1024, kRowW2 = 1088, kRowK = 1152,
              kRowV = 1280, kRows = 1408;
constexpr int kWBytes = kRows * 128;
// float32 [7, 64]: b_out, b1, b2 (bf16 values), LN1 scale, bias, LN2 scale, bias
constexpr int kBiasFloats = 7 * 64;
enum { kBOut = 0, kB1 = 64, kB2 = 128, kLn1W = 192, kLn1B = 256, kLn2W = 320, kLn2B = 384 };
constexpr int kMaxKeys = 8;
// Bf16 slots of 64 columns a point, [slots, n_pad, 64]: what the training
// forward saves (Saved: p and the scores) and the backward's scratch (Slots:
// the weight gradients' operands). p, the scores and dscore take one slot
// each: 8 heads x 8 keys, head h's at columns 8 h.
struct Saved {
  enum { P = 0, S = 1, N = 2 };
};
struct Slots {
  enum { A1 = 0, A2 = 1, G = 2, Ds = 3, Datt = 4, Dh = 5, Df = 6, N = 7 };
};
// The weight-gradient pass: M [64, 64], R [64, 64], a2^T dh, g^T dy.
constexpr int kJobs = 4;
constexpr int kWTotal = kJobs * 64 * 64;
constexpr int kDwStages = 6;
constexpr int kDwStageBytes = 2 * kBox;   // A: 1 box, G: 1 box
constexpr int kSmemMax = 232448;

__host__ __device__ constexpr size_t fwd_smem_bytes() {
  return 1024 + static_cast<size_t>(kWBytes) + 4 * kBiasFloats + 16;
}
// the chain's column sums: each warp's own [7, 64] float32
__host__ __device__ constexpr size_t chain_smem_bytes() {
  return fwd_smem_bytes() + 4 * static_cast<size_t>(4 * kBwdWgs) * kBiasFloats;
}
__host__ __device__ constexpr size_t dw_smem_bytes() {
  return 1024 + static_cast<size_t>(kDwStages) * kDwStageBytes + 16 * kDwStages;
}

// ------------------------------------------------------------- fragments

__device__ __forceinline__ float bfr(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// Accumulator layout of an m64nN product (N = 8 J): element (j, hr, e) is
// row r0 + 8 hr, column 8 j + 2 q + e, acc[4 j + 2 hr + e]; packed to bf16x2
// it is half e of word 2 j + hr, and words [4 c, 4 c + 4) are the A fragment
// of k-chunk c of the next product.
template <int J>
__device__ __forceinline__ void pack(const float (&acc)[4 * J], uint32_t (&w)[2 * J]) {
#pragma unroll
  for (int i = 0; i < 2 * J; ++i) w[i] = pack2(acc[2 * i], acc[2 * i + 1]);
}

// D[64 x 16] (+)= A[64 x 16] B[16 x 16], A from registers.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n16_rs(float (&d)[8], uint32_t a0, uint32_t a1,
                                                uint32_t a2, uint32_t a3, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d), "n"(kTransB));
}

// acc (+)= A [64, 64] (registers) x B [64, 64] from a 64-row swizzled box:
// kMN 0 reads the box K-major (B[k][n] = box[n][k]: a k16 step moves 32 bytes
// inside the swizzle atom), kMN 1 MN-major (B[k][n] = box[k][n]: a k16 step
// is 16 rows, 2,048 bytes).
template <int kMN>
__device__ __forceinline__ void mm64(float (&acc)[32], uint32_t (&a)[16], const uint8_t* box,
                                     bool accumulate) {
  using namespace njf_hopper;
  const uint64_t db = desc_sw128(box);
  fence_acc(acc);
  fence_regs(a);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < 4; ++c)
    wgmma_m64n64_rs<kMN>(acc, a[4 * c], a[4 * c + 1], a[4 * c + 2], a[4 * c + 3],
                         db + (kMN ? 128 * c : 2 * c), (accumulate || c > 0) ? 1 : 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  fence_regs(a);
}

// acc = A [64, 64] (registers) x box^T: box [16 keys, 64] read K-major.
__device__ __forceinline__ void mm16(float (&acc)[8], uint32_t (&a)[16], const uint8_t* box) {
  using namespace njf_hopper;
  const uint64_t db = desc_sw128(box);
  fence_acc(acc);
  fence_regs(a);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < 4; ++c)
    wgmma_m64n16_rs<0>(acc, a[4 * c], a[4 * c + 1], a[4 * c + 2], a[4 * c + 3], db + 2 * c,
                       c > 0 ? 1 : 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  fence_regs(a);
}

// acc = A [64, 16 keys] (registers) x box: box [16 keys, 64] read MN-major.
__device__ __forceinline__ void mm_keys(float (&acc)[32], uint32_t (&a)[4], const uint8_t* box) {
  using namespace njf_hopper;
  fence_acc(acc);
  fence_regs(a);
  wgmma_fence();
  wgmma_m64n64_rs<1>(acc, a[0], a[1], a[2], a[3], desc_sw128(box), 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  fence_regs(a);
}

// ------------------------------------------------------------ row helpers

// The thread's 32 elements (accumulator layout) of rows row0, row0 + 8 of a
// float32 [n, 64] array; zeros past n.
__device__ __forceinline__ void load_f32(float (&v)[32], const float* base, int row0, int n,
                                         int q) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    const float* p = base + static_cast<size_t>(row < n ? row : 0) * 64 + 2 * q;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 t = row < n ? *reinterpret_cast<const float2*>(p + 8 * j) : make_float2(0.f, 0.f);
      v[4 * j + 2 * hr] = t.x;
      v[4 * j + 2 * hr + 1] = t.y;
    }
  }
}

__device__ __forceinline__ void store_f32(float* base, const float (&v)[32], int row0, int n,
                                          int q) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    if (row >= n) continue;
    float* p = base + static_cast<size_t>(row) * 64 + 2 * q;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(p + 8 * j) = make_float2(v[4 * j + 2 * hr], v[4 * j + 2 * hr + 1]);
  }
}

// 4 x 4 transpose of 32-bit words among the 4 lanes of a row group (lane q
// = lane & 3): lane q gives v[c] and gets back lane c's v[q].
__device__ __forceinline__ void transpose4(uint32_t (&v)[4], int q) {
#pragma unroll
  for (int bit = 1; bit <= 2; bit <<= 1) {
    const bool hi = q & bit;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int lo = bit == 1 ? 2 * k : k;
      const uint32_t got = __shfl_xor_sync(0xffffffffu, hi ? v[lo] : v[lo + bit], bit);
      if (hi)
        v[lo] = got;
      else
        v[lo + bit] = got;
    }
  }
}

// The backward's scratch: bf16 [slots, n_pad, 64] as words; every row below
// n_pad is written (zeros past n), so the weight-gradient pass reads whole
// tiles.
struct Scratch {
  uint32_t* base;
  int n, n_pad;

  __device__ __forceinline__ uint32_t* row(int slot, int r) const {
    return base + (static_cast<size_t>(slot) * n_pad + r) * 32;
  }
};

// The thread's 16 words (64 bf16 columns, accumulator layout) to slot
// `slot` of rows row0, row0 + 8. The four lanes of a row group trade words
// so that each stores 16 contiguous bytes (a warp: 64 of each of 8 rows);
// streaming stores, as the scratch is read once, by the next kernel.
__device__ __forceinline__ void store_slot(const Scratch& sc, int slot, const uint32_t (&v)[16],
                                           int row0, int q) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    const bool live = row < sc.n;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      uint32_t w[4] = {v[8 * t + hr], v[8 * t + 2 + hr], v[8 * t + 4 + hr], v[8 * t + 6 + hr]};
      transpose4(w, q);
      __stcs(reinterpret_cast<uint4*>(sc.row(slot, row) + 4 * (4 * t + q)),
             live ? make_uint4(w[0], w[1], w[2], w[3]) : make_uint4(0u, 0u, 0u, 0u));
    }
  }
}

// Head h's first 8 key columns (a word a row) at columns 8 h of slot `slot`.
__device__ __forceinline__ void store_keys(const Scratch& sc, int slot, int h,
                                           const uint32_t (&v)[4], int row0, int q) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    __stcs(sc.row(slot, row) + 4 * h + q, row < sc.n ? v[hr] : 0u);
  }
}

// The sum of the four lanes of a row group, the same in each.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Row statistics of a LayerNorm, float32: mean, rsqrt(var + 1e-6) with var =
// E[x^2] - mean^2 clamped at 0 (clamped: whether the clamp held).
struct RowStats {
  float mean[2], rstd[2];
  bool clamped[2];
};

__device__ __forceinline__ RowStats row_stats(const float (&v)[32]) {
  RowStats st;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = v[4 * j + 2 * hr + e];
        s = __fadd_rn(s, x);
        ss = __fadd_rn(ss, __fmul_rn(x, x));
      }
    const float mean = quad_sum(s) * (1.f / 64.f);
    const float var = __fsub_rn(quad_sum(ss) * (1.f / 64.f), __fmul_rn(mean, mean));
    st.mean[hr] = mean;
    st.clamped[hr] = var < 0.f;
    st.rstd[hr] = rsqrtf(__fadd_rn(fmaxf(var, 0.f), 1e-6f));
  }
  return st;
}

// (x - mean) * rstd, element i of the accumulator layout
__device__ __forceinline__ float xhat(const float (&v)[32], const RowStats& st, int i) {
  const int hr = (i >> 1) & 1;
  return __fmul_rn(__fsub_rn(v[i], st.mean[hr]), st.rstd[hr]);
}

// bf16((x - mean) * (rstd * w) + b), packed
__device__ __forceinline__ void layer_norm(const float (&v)[32], const RowStats& st,
                                           const float* w, const float* b, int q,
                                           uint32_t (&out)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * q + e;
        y[e] = __fadd_rn(__fmul_rn(__fsub_rn(v[4 * j + 2 * hr + e], st.mean[hr]),
                                   __fmul_rn(st.rstd[hr], w[c])),
                         b[c]);
      }
      out[2 * j + hr] = pack2(y[0], y[1]);
    }
}

// da [64 columns] of the LayerNorm's output -> dx += its input gradient:
// rstd (w da - mean(w da) - xhat mean(w da xhat)), the last term dropped
// where the variance's clamp held.
__device__ __forceinline__ void layer_norm_bwd(const float (&da)[32], const float (&v)[32],
                                               const RowStats& st, const float* w, int q,
                                               float (&dx)[32]) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * hr + e;
        const float g = __fmul_rn(da[i], w[8 * j + 2 * q + e]);
        s1 = __fadd_rn(s1, g);
        s2 = __fadd_rn(s2, __fmul_rn(g, xhat(v, st, i)));
      }
    const float m1 = quad_sum(s1) * (1.f / 64.f);
    const float m2 = st.clamped[hr] ? 0.f : quad_sum(s2) * (1.f / 64.f);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * hr + e;
        const float g = __fmul_rn(da[i], w[8 * j + 2 * q + e]);
        const float t = __fsub_rn(__fsub_rn(g, m1), __fmul_rn(xhat(v, st, i), m2));
        dx[i] = __fadd_rn(dx[i], __fmul_rn(st.rstd[hr], t));
      }
  }
}

__device__ __forceinline__ float gelu(float x) {
  return __fmul_rn(__fmul_rn(x, 0.5f), __fadd_rn(1.f, erff(__fmul_rn(x, 0.70710678118654752f))));
}

__device__ __forceinline__ float gelu_grad(float x) {
  const float cdf = __fmul_rn(0.5f, __fadd_rn(1.f, erff(__fmul_rn(x, 0.70710678118654752f))));
  const float pdf = __fmul_rn(0.39894228040143268f, expf(__fmul_rn(__fmul_rn(x, x), -0.5f)));
  return __fadd_rn(cdf, __fmul_rn(x, pdf));
}

// A head's scores: acc [64, 16] -> bf16(bf16(acc) * scale), -inf at keys >=
// `keys`, packed (4 words); p = float32 softmax over the keys.
__device__ __forceinline__ void scores(const float (&acc)[8], int keys, float scale, int q,
                                       uint32_t (&sw)[4]) {
  float s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = 8 * (i >> 2) + 2 * q + (i & 1);
    s[i] = key < keys ? bfr(bfr(acc[i]) * scale) : -INFINITY;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) sw[i] = pack2(s[2 * i], s[2 * i + 1]);
}

__device__ __forceinline__ void softmax(const uint32_t (&sw)[4], float (&p)[8]) {
  float s[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = unpack2(sw[i]);
    s[2 * i] = t.x;
    s[2 * i + 1] = t.y;
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i0 = 2 * hr, i1 = 2 * hr + 1, i2 = 4 + 2 * hr, i3 = 5 + 2 * hr;
    const float m = quad_max(fmaxf(fmaxf(s[i0], s[i1]), fmaxf(s[i2], s[i3])));
    const float e0 = expf(s[i0] - m), e1 = expf(s[i1] - m), e2 = expf(s[i2] - m),
                e3 = expf(s[i3] - m);
    const float sum = quad_sum(__fadd_rn(__fadd_rn(__fadd_rn(e0, e1), e2), e3));
    p[i0] = e0 / sum;
    p[i1] = e1 / sum;
    p[i2] = e2 / sum;
    p[i3] = e3 / sum;
  }
}

template <int H>
__device__ __forceinline__ void halve(const float (&v)[2 * H], float (&o)[H], bool hi, int m) {
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = hi ? v[k] : v[k + H];
    const float keep = hi ? v[k + H] : v[k];
    o[k] = keep + __shfl_xor_sync(0xffffffffu, send, m);
  }
}

// dst[col] += the column sums over the warp's 16 points of the 64 columns
// held in the accumulator layout (get(i), i = 4 j + 2 hr + e), in a fixed
// order: the thread's two rows, then a butterfly over the 8 lanes of equal
// q that leaves each lane two columns, added by that lane into the warp's
// own sums (no other warp writes them: no barrier).
template <typename Get>
__device__ __forceinline__ void col_sums(Get get, float* dst) {
  constexpr int V = 16;
  const int lane = threadIdx.x & 31;
  const int q = lane & 3;
  float o1[V / 2], o2[V / 4], o3[V / 8];
  auto col = [&](int c) {  // column 8 (c >> 1) + 2 q + (c & 1): rows r0 and r0 + 8
    return get(4 * (c >> 1) + (c & 1)) + get(4 * (c >> 1) + 2 + (c & 1));
  };
  const bool hi = lane & 16;
#pragma unroll
  for (int k = 0; k < V / 2; ++k) {
    const float lo_c = col(k), hi_c = col(k + V / 2);
    o1[k] = (hi ? hi_c : lo_c) + __shfl_xor_sync(0xffffffffu, hi ? lo_c : hi_c, 16);
  }
  halve<V / 4>(o1, o2, lane & 8, 8);
  halve<V / 8>(o2, o3, lane & 4, 4);
  const int cbase = ((lane >> 2) & 1) * (V / 8) + ((lane >> 3) & 1) * (V / 4) +
                    ((lane >> 4) & 1) * (V / 2);
#pragma unroll
  for (int k = 0; k < V / 8; ++k) {
    const int c = cbase + k;
    dst[8 * (c >> 1) + 2 * q + (c & 1)] += o3[k];
  }
}

// The block's weights (TMA, one barrier) and biases into shared memory.
__device__ __forceinline__ void load_weights(const CUtensorMap* mw, uint8_t* smem, float* bias,
                                             const float* src, uint64_t* bar) {
  using namespace njf_hopper;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  for (int i = threadIdx.x; i < kBiasFloats; i += blockDim.x) bias[i] = src[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, kWBytes);
    for (int b = 0; b < kRows / 64; ++b) tma_load_2d(smem + b * kBox, mw, bar, 0, 64 * b);
  }
  mbar_wait(bar, 0);
}

struct Args {
  const float* x;      // [n, 64] the layer's input
  const float* dy;     // [n, 64] the gradient of its output (backward)
  const float* bias;   // [7, 64]
  float* out;          // forward: y; backward: dx [n, 64]
  float* x1;           // [n, 64] x + the attention's output (the training forward's, saved)
  uint32_t* saved;     // bf16 [Saved::N, n_pad, 64] as words: p and the scores
  uint32_t* scratch;   // backward: bf16 [Slots::N, n_pad, 64], as words
  float* bpart;        // backward: [grid, 7 x 64] each block's sums
  int n, n_tiles, keys;
  float scale;
};

// Head h's saved scores (4 words: the key rows past 8 are -inf).
__device__ __forceinline__ void load_scores(const Scratch& sv, int h, int row0, int q,
                                            uint32_t (&hs)[4]) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    hs[hr] = *(sv.row(Saved::S, row0 + 8 * hr) + 4 * h + q);
    hs[2 + hr] = 0xff80ff80u;  // bf16 -inf, -inf
  }
}

// A head's scores against its keys and their softmax: q_h = bf16(a1 W_q,h^T),
// the packed scores (hs) and the float32 softmax (p).
__device__ __forceinline__ void head_softmax(const Args& a, const uint8_t* w, uint32_t (&a1)[16],
                                             int h, int q, uint32_t (&hs)[4], float (&p)[8]) {
  float acc[32], s[8];
  uint32_t qw[16];
  mm64<0>(acc, a1, w + (kRowWq + 64 * h) * 128, false);
  pack<8>(acc, qw);
  mm16(s, qw, w + (kRowK + 16 * h) * 128);
  scores(s, a.keys, a.scale, q, hs);
  softmax(hs, p);
}

// The forward of the tile's attention half: x1 = x + bf16(o W_out^T + b_out)
// in v; with kSave, each head's p and scores written to `sv`.
template <bool kSave>
__device__ __forceinline__ void attention_fwd(const Args& a, const uint8_t* w, const float* bias,
                                              float (&v)[32], const Scratch& sv, int row0, int q) {
  uint32_t a1[16];
  const RowStats st1 = row_stats(v);
  layer_norm(v, st1, bias + kLn1W, bias + kLn1B, q, a1);
  float att[32];
#pragma unroll
  for (int h = 0; h < 8; ++h) {
    float acc[32], p[8];
    uint32_t qw[16], pw[4], hs[4];
    head_softmax(a, w, a1, h, q, hs, p);
#pragma unroll
    for (int i = 0; i < 4; ++i) pw[i] = pack2(p[2 * i], p[2 * i + 1]);
    if constexpr (kSave) {
      store_keys(sv, Saved::P, h, pw, row0, q);
      store_keys(sv, Saved::S, h, hs, row0, q);
    }
    mm_keys(acc, pw, w + (kRowV + 16 * h) * 128);
    pack<8>(acc, qw);
    mm64<0>(att, qw, w + (kRowWo + 64 * h) * 128, h > 0);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = 8 * (i >> 2) + 2 * q + (i & 1);
    v[i] = __fadd_rn(v[i], bfr(att[i] + bias[kBOut + c]));
  }
}

// hidden = bf16(a2 W1^T + b1) (hw, packed) and g = bf16(gelu(hidden)) (gw)
__device__ __forceinline__ void mlp_hidden(const uint8_t* w, const float* bias, uint32_t (&a2)[16],
                                           uint32_t (&hw)[16], uint32_t (&gw)[16], int q) {
  float acc[32];
  mm64<0>(acc, a2, w + kRowW1 * 128, false);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int c = 8 * (i >> 1) + 2 * q;
    const float h0 = bfr(acc[2 * i] + bias[kB1 + c]), h1 = bfr(acc[2 * i + 1] + bias[kB1 + c + 1]);
    hw[i] = pack2(h0, h1);
    gw[i] = pack2(gelu(h0), gelu(h1));
  }
}

// kSave (the training forward): x1 and each head's p and scores saved for
// the backward, which so recomputes no attention.
template <bool kSave>
__global__ void __launch_bounds__(128 * kFwdWgs, 1)
    jt_fwd_kernel(const __grid_constant__ CUtensorMap mw, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* bias = reinterpret_cast<float*>(smem + kWBytes);
  uint64_t* bar = reinterpret_cast<uint64_t*>(bias + kBiasFloats);
  load_weights(&mw, smem, bias, a.bias, bar);
  const int cw = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) & 3;
  const int lane = threadIdx.x & 31;
  const int q = lane & 3;
  const int r0 = 16 * warp + (lane >> 2);
  const Scratch sv = {a.saved, a.n, kPts * a.n_tiles};
  for (int tile = kFwdWgs * blockIdx.x + cw; tile < a.n_tiles; tile += kFwdWgs * gridDim.x) {
    const int row0 = tile * kPts + r0;
    float v[32];
    load_f32(v, a.x, row0, a.n, q);
    attention_fwd<kSave>(a, smem, bias, v, sv, row0, q);
    if constexpr (kSave) store_f32(a.x1, v, row0, a.n, q);
    uint32_t a2[16], hw[16], gw[16];
    const RowStats st = row_stats(v);
    layer_norm(v, st, bias + kLn2W, bias + kLn2B, q, a2);
    mlp_hidden(smem, bias, a2, hw, gw, q);
    float acc[32];
    mm64<0>(acc, gw, smem + kRowW2 * 128, false);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i >> 2) + 2 * q + (i & 1);
      v[i] = __fadd_rn(v[i], bfr(acc[i] + bias[kB2 + c]));
    }
    store_f32(a.out, v, row0, a.n, q);
  }
}

__global__ void __launch_bounds__(128 * kBwdWgs, 1)
    jt_grad_kernel(const __grid_constant__ CUtensorMap mw, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* bias = reinterpret_cast<float*>(smem + kWBytes);
  uint64_t* bar = reinterpret_cast<uint64_t*>(bias + kBiasFloats);
  float* dsum = reinterpret_cast<float*>(bar + 2) + (threadIdx.x / 32) * kBiasFloats;
  load_weights(&mw, smem, bias, a.bias, bar);
  const int cw = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) & 3;
  const int lane = threadIdx.x & 31;
  const int q = lane & 3;
  const int r0 = 16 * warp + (lane >> 2);
  const Scratch sc = {a.scratch, a.n, kPts * a.n_tiles};
  const Scratch sv = {a.saved, a.n, kPts * a.n_tiles};
  for (int i = lane; i < kBiasFloats; i += 32) dsum[i] = 0.f;
  __syncwarp();
  auto sums = [&](int slot, auto get) { col_sums(get, dsum + slot); };
  const uint8_t* w = smem;
  for (int tile = kBwdWgs * blockIdx.x + cw; tile < a.n_tiles; tile += kBwdWgs * gridDim.x) {
    const int row0 = tile * kPts + r0;
    // ---- LN1's statistics and a1 from x; then the MLP half's forward again
    // from the saved x1 (in v)
    float v[32];
    load_f32(v, a.x, row0, a.n, q);
    const RowStats st1 = row_stats(v);
    {
      uint32_t a1[16];
      layer_norm(v, st1, bias + kLn1W, bias + kLn1B, q, a1);
      store_slot(sc, Slots::A1, a1, row0, q);
    }
    load_f32(v, a.x1, row0, a.n, q);
    uint32_t a2[16], hw[16], gw[16];
    const RowStats st2 = row_stats(v);
    layer_norm(v, st2, bias + kLn2W, bias + kLn2B, q, a2);
    store_slot(sc, Slots::A2, a2, row0, q);
    mlp_hidden(w, bias, a2, hw, gw, q);
    store_slot(sc, Slots::G, gw, row0, q);
    // ---- fc2, fc1: dh = (bf16(dy) W2) * gelu'(hidden); da2 = bf16(dh) W1
    float d[32], acc[32];
    uint32_t u[16];
    load_f32(d, a.dy, row0, a.n, q);
    pack<8>(d, u);
    store_slot(sc, Slots::Df, u, row0, q);
    sums(kB2, [&](int i) { return d[i]; });
    mm64<1>(acc, u, w + kRowW2 * 128, false);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float2 hv = unpack2(hw[i]);
      acc[2 * i] *= gelu_grad(hv.x);
      acc[2 * i + 1] *= gelu_grad(hv.y);
    }
    sums(kB1, [&](int i) { return acc[i]; });
    pack<8>(acc, u);
    store_slot(sc, Slots::Dh, u, row0, q);
    mm64<1>(acc, u, w + kRowW1 * 128, false);
    // ---- LN2: dx1 = dy + LN2'(da2) in d
    sums(kLn2W, [&](int i) { return acc[i] * xhat(v, st2, i); });
    sums(kLn2B, [&](int i) { return acc[i]; });
    layer_norm_bwd(acc, v, st2, bias + kLn2W, q, d);
    sums(kBOut, [&](int i) { return d[i]; });
    uint32_t datt[16];
    pack<8>(d, datt);
    store_slot(sc, Slots::Datt, datt, row0, q);
    // ---- the heads, each's softmax again from its saved scores: dO_h =
    // bf16(dx1) W_out,h; dP = bf16(dO_h) V_h^T; the softmax's backward;
    // dq_h = bf16(dscore) K_h; da1 += bf16(dq_h) W_q,h
    float da1[32];
    uint32_t hs[4];
    load_scores(sv, 0, row0, q, hs);
#pragma unroll
    for (int h = 0; h < 8; ++h) {
      float dp[8], p[8];
      uint32_t dsw[4];
      softmax(hs, p);
      if (h < 7) load_scores(sv, h + 1, row0, q, hs);  // the next head's, ahead
      mm64<1>(acc, datt, w + (kRowWo + 64 * h) * 128, false);
      pack<8>(acc, u);
      mm16(dp, u, w + (kRowV + 16 * h) * 128);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i0 = 2 * hr, i1 = 2 * hr + 1, i2 = 4 + 2 * hr, i3 = 5 + 2 * hr;
        const float dot = quad_sum(__fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(p[i0], dp[i0]), __fmul_rn(p[i1], dp[i1])),
                      __fmul_rn(p[i2], dp[i2])),
            __fmul_rn(p[i3], dp[i3])));
        dp[i0] = __fmul_rn(__fmul_rn(p[i0], __fsub_rn(dp[i0], dot)), a.scale);
        dp[i1] = __fmul_rn(__fmul_rn(p[i1], __fsub_rn(dp[i1], dot)), a.scale);
        dp[i2] = __fmul_rn(__fmul_rn(p[i2], __fsub_rn(dp[i2], dot)), a.scale);
        dp[i3] = __fmul_rn(__fmul_rn(p[i3], __fsub_rn(dp[i3], dot)), a.scale);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) dsw[i] = pack2(dp[2 * i], dp[2 * i + 1]);
      store_keys(sc, Slots::Ds, h, dsw, row0, q);
      mm_keys(acc, dsw, w + (kRowK + 16 * h) * 128);
      pack<8>(acc, u);
      mm64<1>(da1, u, w + (kRowWq + 64 * h) * 128, h > 0);
    }
    // ---- LN1: dx = dx1 + LN1'(da1)
    load_f32(v, a.x, row0, a.n, q);
    sums(kLn1W, [&](int i) { return da1[i] * xhat(v, st1, i); });
    sums(kLn1B, [&](int i) { return da1[i]; });
    layer_norm_bwd(da1, v, st1, bias + kLn1W, q, d);
    store_f32(a.out, d, row0, a.n, q);
  }
  __syncthreads();  // the block's warp sums, added in warp order
  const float* sums_all = reinterpret_cast<const float*>(bar + 2);
  for (int i = threadIdx.x; i < kBiasFloats; i += blockDim.x) {
    float acc = 0.f;
    for (int wp = 0; wp < 4 * kBwdWgs; ++wp) acc += sums_all[wp * kBiasFloats + i];
    a.bpart[static_cast<size_t>(blockIdx.x) * kBiasFloats + i] = acc;
  }
}

// The weight-gradient pass: job j computes dW [64, 64] = A^T G over points,
// A slot a_slot of the scratch (a_map 0) or of what the forward saved (1),
// G the scratch's slot g_slot, at `out` floats into each split's partial:
// M = a1^T dscore [64, 8 x 8], R = p^T bf16(dx1) [8 x 8, 64], fc1's a2^T dh
// [64 in, 64 hidden] and fc2's g^T dy [64 hidden, 64 out].
struct Job {
  int a_map, a_slot, g_slot, out;
};

__constant__ Job kJobTable[kJobs] = {
    {0, Slots::A1, Slots::Ds, 0},
    {1, Saved::P, Slots::Datt, 4096},
    {0, Slots::A2, Slots::Dh, 8192},
    {0, Slots::G, Slots::Df, 12288},
};

// The consumer warpgroup: acc = dW [64, 64] over the block's tiles; A and G
// read MN-major (the 64 points are the contraction).
__device__ void dw_consume(const uint8_t* smem, uint64_t* full, uint64_t* empty, int steps,
                           float* out) {
  using namespace njf_hopper;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int k = 0; k < steps; ++k) {
    const int s = k % kDwStages;
    mbar_wait(&full[s], (k / kDwStages) & 1);
    const uint8_t* st = smem + s * kDwStageBytes;
    const uint64_t da = desc_sw128(st), dg = desc_sw128(st + kBox);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n64<1, 1>(acc, da + 128 * kk, dg + 128 * kk);
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();
    fence_acc(acc);
    if (k > 0 && lane == 0) mbar_arrive(&empty[(k - 1) % kDwStages]);
  }
  wgmma_wait<0>();
  fence_acc(acc);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float* row = out + static_cast<size_t>(16 * warp + (lane >> 2) + 8 * hr) * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j + 2 * (lane & 3)) =
          make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
  }
}

// Grid: jobs x splits. Block (job, s) sums its job's dW over the 64-point
// tiles [s per, min((s + 1) per, n_tiles)) into part[s] (float32 [splits,
// kWTotal]); no two blocks write the same float. Warpgroup 0 loads by TMA,
// warpgroup 1 multiplies.
__global__ void __launch_bounds__(256, 1)
    jt_dw_kernel(const __grid_constant__ CUtensorMap ms, const __grid_constant__ CUtensorMap mv,
                 float* part, int n_tiles, int splits, int per) {
  using namespace njf_hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kDwStages * kDwStageBytes);
  uint64_t* empty = full + kDwStages;
  const Job jb = kJobTable[blockIdx.x / splits];
  const int s = blockIdx.x % splits;
  const int t0 = s * per;
  const int steps = max(0, min(n_tiles, t0 + per) - t0);
  const int n_pad = 64 * n_tiles;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kDwStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    for (int k = 0; k < steps; ++k) {
      const int i = k % kDwStages;
      if (k >= kDwStages) mbar_wait(&empty[i], ((k / kDwStages) - 1) & 1);
      uint8_t* st = smem + i * kDwStageBytes;
      const int row = (t0 + k) * 64;
      mbar_expect_tx(&full[i], kDwStageBytes);
      tma_load_2d(st, jb.a_map ? &mv : &ms, &full[i], 0, jb.a_slot * n_pad + row);
      tma_load_2d(st + kBox, &ms, &full[i], 0, jb.g_slot * n_pad + row);
    }
    return;
  }
  setmaxnreg_inc<232>();
  dw_consume(smem, full, empty, steps, part + static_cast<size_t>(s) * kWTotal + jb.out);
}

// out[e] = sum over s, in order, of wpart[s][e] (e < kWTotal), then of
// bpart[b][e - kWTotal] over the blocks b in order.
__global__ void jt_reduce_kernel(const float* __restrict__ wpart, int splits,
                                 const float* __restrict__ bpart, int n_bpart,
                                 float* __restrict__ out) {
  const int total = kWTotal + kBiasFloats;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += gridDim.x * blockDim.x) {
    float s = 0.f;
    if (e < kWTotal) {
      for (int i = 0; i < splits; ++i) s += wpart[static_cast<size_t>(i) * kWTotal + e];
    } else {
      for (int i = 0; i < n_bpart; ++i)
        s += bpart[static_cast<size_t>(i) * kBiasFloats + e - kWTotal];
    }
    out[e] = s;
  }
}

// [rows, cols] row-major bf16 as a map with boxes of 64 rows and 64 columns
bool encode_rows(CUtensorMap* map, const void* base, long long rows, int cols) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {2ull * cols};
  const uint32_t box[2] = {64u, 64u};
  return njf_hopper::encode_map(map, base, 2, dims, strides, box);
}

template <typename K>
int allow_smem(K kernel, bool& done) {  // once per kernel
  if (done) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  done = err == cudaSuccess;
  return static_cast<int>(err);
}

bool prepare(CUtensorMap* mw, Args& a, const void* x, const void* w, const void* b, void* out,
             int n, int keys, float scale, int grid) {
  if (n <= 0 || keys < 1 || keys > kMaxKeys || grid <= 0) return false;
  a.x = static_cast<const float*>(x);
  a.bias = static_cast<const float*>(b);
  a.out = static_cast<float*>(out);
  a.n = n;
  a.n_tiles = (n + kPts - 1) / kPts;
  a.keys = keys;
  a.scale = scale;
  return encode_rows(mw, w, kRows, 64);
}

}  // namespace jt
}  // namespace

// JT-fwd: x [n, 64] float32 -> y [n, 64] float32. w: the packed weights
// (bf16 [1408, 64]), b: the biases (float32 [7, 64]); keys in 1..8, scale
// the scores' factor; grid: blocks (at most one per SM is resident). The
// training forward (x1 not null) also writes x1 [n, 64] float32 and saved,
// bf16 [2, n_pad, 64] (p, then the scores; n_pad = n rounded up to 64),
// which JT-bwd reads.
extern "C" int njf_jt_fwd(const void* x, const void* w, const void* b, void* y, void* x1,
                          void* saved, int n, int keys, float scale, int grid, void* stream) {
  using namespace jt;
  CUtensorMap mw;
  Args a = {};
  if (!prepare(&mw, a, x, w, b, y, n, keys, scale, grid) || (x1 == nullptr) != (saved == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  a.x1 = static_cast<float*>(x1);
  a.saved = static_cast<uint32_t*>(saved);
  static bool attr[2] = {false, false};
  const int train = x1 != nullptr;
  auto kernel = train ? jt_fwd_kernel<true> : jt_fwd_kernel<false>;
  const int err = allow_smem(kernel, attr[train]);
  if (err != 0) return err;
  kernel<<<grid, 128 * kFwdWgs, fwd_smem_bytes(), static_cast<cudaStream_t>(stream)>>>(mw, a);
  return static_cast<int>(cudaGetLastError());
}

// JT-bwd: x, dy [n, 64] float32 and what the training forward saved (x1,
// saved) -> dx [n, 64] float32, and out [16,384 + 448] float32: M [64, 64],
// R [64, 64], fc1's a2^T dh [64, 64], fc2's g^T dy [64, 64], then the bias
// and LayerNorm gradients [7, 64] in the biases' order. Scratch: bf16 [7,
// n_pad, 64]; wpart [splits, 16,384] and bpart [grid, 448] float32.
extern "C" int njf_jt_bwd(const void* x, const void* x1, const void* saved, const void* dy,
                          const void* w, const void* b, void* dx, void* scratch, void* wpart,
                          void* bpart, void* out, int n, int keys, float scale, int grid,
                          int splits, void* stream) {
  using namespace jt;
  CUtensorMap mw, ms, mv;
  Args a = {};
  const long long n_pad = kPts * ((n + kPts - 1) / kPts);
  if (!prepare(&mw, a, x, w, b, dx, n, keys, scale, grid) || splits <= 0 ||
      !encode_rows(&ms, scratch, Slots::N * n_pad, 64) ||
      !encode_rows(&mv, saved, Saved::N * n_pad, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  a.x1 = static_cast<float*>(const_cast<void*>(x1));
  a.saved = static_cast<uint32_t*>(const_cast<void*>(saved));
  a.dy = static_cast<const float*>(dy);
  a.scratch = static_cast<uint32_t*>(scratch);
  a.bpart = static_cast<float*>(bpart);
  static bool chain_attr = false, dw_attr = false;
  int err = allow_smem(jt_grad_kernel, chain_attr);
  if (err == 0) err = allow_smem(jt_dw_kernel, dw_attr);
  if (err != 0) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  jt_grad_kernel<<<grid, 128 * kBwdWgs, chain_smem_bytes(), s>>>(mw, a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int tiles = a.n_tiles;
  const int sp = splits < tiles ? splits : tiles;
  const int per = (tiles + sp - 1) / sp;
  jt_dw_kernel<<<kJobs * sp, 256, dw_smem_bytes(), s>>>(ms, mv, static_cast<float*>(wpart),
                                                         tiles, sp, per);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int total = kWTotal + kBiasFloats;
  jt_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(static_cast<const float*>(wpart), sp,
                                                       static_cast<const float*>(bpart), grid,
                                                       static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
