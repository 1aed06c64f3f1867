// K1-bwd-upsample on Hopper: the backward of the encoder's bilinear
// upsampling (half-pixel centres, align_corners=False) as a fixed-order
// gather, in place of upsample_bilinear2d_backward's atomic adds.
//
// It replaces no Pallas site. JAX upsamples with jax.image.resize "linear"
// (neural_jacobian_field_tpu/models/encoder_resnet.py:289) and leaves the
// backward to XLA's autodiff, which repeats bit for bit on the CPU and the
// TPU. The port's step must repeat too (ops/deterministic.py), and PyTorch's
// CUDA backward adds with atomics. Its plain version builds the corner table
// of every output pixel (ops/kernels/upsample_bwd._upsample_corners) and
// scatters it with row_scatter_plain:
//   gx[b, t, :] = sum over output pixels p in row-major order, then corners
//                 q in order (y0x0, y0x1, y1x0, y1x1) with texel(p, q) == t,
//                 of rw(p, q) * g[b, p, :]
// with rw the product of the two axis weights rounded to g's type, the
// products and the sums in float32 from 0, rounded once to g's type. Every
// table entry counts: zero weights and the duplicate corners of the clamped
// last row and column too, so NaN and Inf travel as in the plain version.
// This kernel computes the same sums in the same order, bit for bit.
//
// What bounds it on the H100, and what the design does about it: bytes, g
// read once and gx written once (86 MB at the flagship's 7 x 240x320 x 64
// bf16 onto 120x160: 0.026 ms at 3.35 TB/s). The stencil is known in
// closed form, so nothing is sorted and no table is read: each thread owns
// one input texel and 16 or 32 bytes of its channels (a 64-channel bf16
// texel fills 4 or 8 lanes), works out from the source-coordinate formula
// the contiguous ranges of output rows and columns whose corners land on
// its texel, and walks them in the plain version's order, g read through
// L1 (a block holds a 2D tile of texels, which share rows and columns).
// Below the last row and column one corner of each visited pixel lands on
// the texel, so those texels skip the corner tests. Each 16-byte vector of
// g still feeds four texels' threads, which is what holds the kernel above
// its bound: the index work per vector at 2x, the L2 traffic of the four
// reads at 8x (staging rows in shared memory or giving a thread 2 x 2
// texels did not help on an H100).
//
// The source coordinate of output index o is, as PyTorch computes the table
// in float32 with a Python-float scale (rounded to float32):
//   src = max((o + 0.5) * float(in / out) - 0.5, 0),  i0 = floor(src),
//   i1 = min(i0 + 1, in - 1),  w1 = src - i0,  w0 = 1 - w1
// each operation rounded on its own (no fused multiply-add). i0 does not
// decrease with o, so the outputs whose corners reach texel t are those with
// i0 in {t - 1, t}: one contiguous range, found from a float guess and
// corrected with the exact formula.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float round_w(float w, float) { return w; }
__device__ __forceinline__ float round_w(float w, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(w));
}

struct Axis {
  int i0, i1;
  float w0, w1;
};

// the source corners and weights of output index o (in: input length)
__device__ __forceinline__ Axis axis_at(int o, float scale, int in) {
  float src = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(o), 0.5f), scale), 0.5f);
  src = fmaxf(src, 0.f);
  Axis a;
  a.i0 = static_cast<int>(src);
  a.i1 = min(a.i0 + 1, in - 1);
  a.w1 = __fsub_rn(src, static_cast<float>(a.i0));
  a.w0 = __fsub_rn(1.f, a.w1);
  return a;
}

__device__ __forceinline__ int lower_corner(int o, float scale) {
  return static_cast<int>(
      fmaxf(__fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(o), 0.5f), scale), 0.5f), 0.f));
}

// the first output index o in [0, out] with lower_corner(o) >= t (out when
// none): a float guess, then exact steps (lower_corner does not decrease)
__device__ __forceinline__ int first_at_least(int t, float scale, int out) {
  if (t <= 0) return 0;
  int o = static_cast<int>(ceilf((static_cast<float>(t) + 0.5f) / scale - 0.5f));
  o = max(0, min(o, out));
  while (o > 0 && lower_corner(o - 1, scale) >= t) --o;
  while (o < out && lower_corner(o, scale) < t) ++o;
  return o;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float from_float(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_float(float v, __nv_bfloat16) {
  return __float2bfloat16(v);
}

// N values of T at p as float: 16-byte loads where N fills them, else one
// by one
template <typename T, int N>
__device__ __forceinline__ void load_n(const T* p, float (&f)[N]) {
  constexpr int E = 16 / sizeof(T);
  if constexpr (N % E == 0) {
#pragma unroll
    for (int k = 0; k < N / E; ++k) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + k);
      const T* h = reinterpret_cast<const T*>(&q);
#pragma unroll
      for (int i = 0; i < E; ++i) f[k * E + i] = to_float(h[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_float(p[i]);
  }
}

// N floats rounded to T (to nearest even for bf16) and stored at p
template <typename T, int N>
__device__ __forceinline__ void store_n(T* p, const float (&a)[N]) {
  constexpr int E = 16 / sizeof(T);
  if constexpr (N % E == 0) {
#pragma unroll
    for (int k = 0; k < N / E; ++k) {
      uint4 q;
      T* h = reinterpret_cast<T*>(&q);
#pragma unroll
      for (int i = 0; i < E; ++i) h[i] = from_float(a[k * E + i], T());
      reinterpret_cast<uint4*>(p)[k] = q;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = from_float(a[i], T());
  }
}

// block (bx, by, b): texels [by ty, by ty + ty) x [bx tx, bx tx + tx) of
// image b; thread j of the tile's tx ty c / N is texel j / (c / N), channels
// N (j % (c / N)) onwards (a texel's on neighbouring lanes).
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    upsample_bwd_kernel(const T* __restrict__ g, T* __restrict__ gx, int hi, int wi, int ho,
                        int wo, int c, float sy, float sx, int tx, int ty) {
  const int vecs = c / N, b = blockIdx.z;
  const T* gb = g + static_cast<size_t>(b) * ho * wo * c;
  for (int j = threadIdx.x; j < tx * ty * vecs; j += kThreads) {
    const int texel = j / vecs, v = j - texel * vecs;
    const int iy = blockIdx.y * ty + texel / tx, ix = blockIdx.x * tx + texel % tx;
    if (iy >= hi || ix >= wi) continue;
    const int y0 = first_at_least(iy - 1, sy, ho), y1 = first_at_least(iy + 1, sy, ho);
    const int x0 = first_at_least(ix - 1, sx, wo), x1 = first_at_least(ix + 1, sx, wo);
    // below the last row and column, one corner of each output row and
    // column in range lands on the texel: the lower one where i0 is the
    // texel, else the upper one (i0 the texel before); only the last, where
    // i1 is clamped onto i0, can take two
    const bool interior = iy < hi - 1 && ix < wi - 1;
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
    for (int oy = y0; oy < y1; ++oy) {
      const Axis ay = axis_at(oy, sy, hi);
      const T* grow = gb + static_cast<size_t>(oy) * wo * c + v * N;
      if (interior) {
        const float wy = ay.i0 == iy ? ay.w0 : ay.w1;
        for (int ox = x0; ox < x1; ++ox) {
          const Axis ax = axis_at(ox, sx, wi);
          const float w = round_w(__fmul_rn(wy, ax.i0 == ix ? ax.w0 : ax.w1), T());
          float f[N];
          load_n<T, N>(grow + static_cast<size_t>(ox) * c, f);
#pragma unroll
          for (int i = 0; i < N; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(w, f[i]));
        }
        continue;
      }
      for (int ox = x0; ox < x1; ++ox) {
        const Axis ax = axis_at(ox, sx, wi);
        float f[N];
        load_n<T, N>(grow + static_cast<size_t>(ox) * c, f);
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // the table's corner order
          if ((q >> 1 ? ay.i1 : ay.i0) != iy || (q & 1 ? ax.i1 : ax.i0) != ix) continue;
          const float w = round_w(__fmul_rn(q >> 1 ? ay.w1 : ay.w0, q & 1 ? ax.w1 : ax.w0), T());
#pragma unroll
          for (int i = 0; i < N; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(w, f[i]));
        }
      }
    }
    store_n<T, N>(gx + ((static_cast<size_t>(b) * hi + iy) * wi + ix) * c + v * N, acc);
  }
}

template <typename T, int N>
int launch(const T* g, T* gx, int b, int hi, int wi, int ho, int wo, int c, cudaStream_t s) {
  // a tile of kThreads N / c texels (a power of two; one texel where its
  // channels fill the block), as wide as tall or twice as wide
  const int vecs = c / N;
  int tx = 1, ty = 1;
  while (tx * ty * 2 * vecs <= kThreads) (tx <= ty ? tx : ty) *= 2;
  const float sy = static_cast<float>(static_cast<double>(hi) / ho);
  const float sx = static_cast<float>(static_cast<double>(wi) / wo);
  const dim3 grid((wi + tx - 1) / tx, (hi + ty - 1) / ty, b);
  upsample_bwd_kernel<T, N><<<grid, kThreads, 0, s>>>(g, gx, hi, wi, ho, wo, c, sy, sx, tx, ty);
  return static_cast<int>(cudaGetLastError());
}

// 32 bytes of channels a thread where the stencil is at most 2x in both
// axes, else 16 (on an H100, 32 were faster at the 2x shapes and slower at
// 4x and 8x, whose larger tiles outgrow L1), one value where 16 bytes do
// not divide the channels
template <typename T>
int upsample_bwd(const void* g, void* gx, int b, int hi, int wi, int ho, int wo, int c,
                 cudaStream_t s) {
  constexpr int E = 16 / sizeof(T);
  const auto* gg = static_cast<const T*>(g);
  auto* out = static_cast<T*>(gx);
  if (c % (2 * E) == 0 && ho <= 2 * hi && wo <= 2 * wi)
    return launch<T, 2 * E>(gg, out, b, hi, wi, ho, wo, c, s);
  if (c % E == 0) return launch<T, E>(gg, out, b, hi, wi, ho, wo, c, s);
  return launch<T, 1>(gg, out, b, hi, wi, ho, wo, c, s);
}

}  // namespace

// g [b, ho, wo, c] (bf16 when is_f32 == 0, else float32), NHWC, contiguous,
// 16-byte aligned -> gx [b, hi, wi, c] in g's type: the backward of the
// bilinear resize [b, hi, wi, c] -> [b, ho, wo, c] with half-pixel centres.
extern "C" int njf_upsample_bwd(const void* g, void* gx, int b, int hi, int wi, int ho, int wo,
                                int c, int is_f32, void* stream) {
  if (b <= 0 || hi <= 0 || wi <= 0 || ho <= 0 || wo <= 0 || c <= 0 || b > 65535 || hi > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return is_f32 ? upsample_bwd<float>(g, gx, b, hi, wi, ho, wo, c, s)
                : upsample_bwd<__nv_bfloat16>(g, gx, b, hi, wi, ho, wo, c, s);
}
