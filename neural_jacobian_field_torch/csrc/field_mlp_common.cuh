// Shared by the K7 kernels (field_mlp.cu, field_mlp_bwd.cu).
//
// Packed weights (bf16, all row-major [in, out]):
//   W_in [k_in, dh] (rows >= d_in zero), then per block W0 [dh, dh], W1 [dh, dh],
//   then W_out [dh, 16 * ceil(d_out / 16)] (columns >= d_out zero).
// Latent projection (projection mode only, bf16): W_z [n_lin_z, d_latent, dh],
//   slice i being lin_z_i's kernel [d_latent, dh].
// Packed biases (float32 holding bf16-rounded values):
//   b_in [dh], b_z [n_lin_z * dh], per block b0 [dh], b1 [dh], b_out [d_out pad].
//
// The trunk's latent injection enters block i < n_lin_z as
//   x = bf16(x + bf16(t_i + b_z[i]))
// with t_i either read (tz mode: t = lin_z(z) precomputed, bf16 [N, n_lin_z
// * dh]) or computed in the kernel (projection mode: t_i = sum over the
// latent levels z_l [N, C_l] of z_l @ W_z[i][rows of level l], float32).

#pragma once

#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace njf_k7 {

using namespace nvcuda;

constexpr int kWarps = 4;
constexpr int kRows = 16;              // points per warp
constexpr int kTile = kWarps * kRows;  // points per block step
constexpr int kMaxLevels = 3;

using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// The latent in projection mode: up to three levels [N, width] (bf16, or
// float32 where bit l of f32_mask is set), their widths multiples of 16 and
// summing to d_latent. grad[l] receives dz_l in the level's own dtype.
struct ZLevels {
  const void* ptr[kMaxLevels];
  void* grad[kMaxLevels];
  int width[kMaxLevels];
  int n_levels;
  int f32_mask;
};

// round to bf16 and back: every layer output of the trunk is a bf16 value
__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float relu(float v) { return fmaxf(v, 0.f); }

// Copy a [rows, cols] bf16 matrix (cols % 8 == 0) from global memory into the
// shared staging buffer with leading dimension ld, 16 bytes per thread-step.
__device__ __forceinline__ void stage_matrix(__nv_bfloat16* __restrict__ dst,
                                             const __nv_bfloat16* __restrict__ src,
                                             int rows, int cols, int ld) {
  const int vec_per_row = cols / 8;
  const int total = rows * vec_per_row;
  for (int v = threadIdx.x; v < total; v += blockDim.x) {
    const int r = v / vec_per_row;
    const int c = (v - r * vec_per_row) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * cols + c);
  }
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  __align__(16) __nv_bfloat16 h[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) h[t] = __float2bfloat16(v[t]);
  return *reinterpret_cast<const uint4*>(h);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(dst) = pack8(v);
}

// One warp copies rows [row0, row0 + rows) x columns [c0, c0 + cw) of latent
// level l into dst (bf16, leading dimension ld), rounding a float32 level to
// bf16 and writing zeros for rows at or past n. cw % 8 == 0.
__device__ __forceinline__ void load_level_rows(__nv_bfloat16* dst, int ld, const ZLevels& z,
                                                int l, int c0, int cw, int row0, int rows,
                                                int n, int lane) {
  const int w = z.width[l];
  const bool f32 = (z.f32_mask >> l) & 1;
  const int vpr = cw / 8;
  for (int v = lane; v < rows * vpr; v += 32) {
    const int r = v / vpr;
    const int c = (v - r * vpr) * 8;
    const int row = row0 + r;
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (row < n) {
      const size_t off = static_cast<size_t>(row) * w + c0 + c;
      if (f32) {
        const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(z.ptr[l]) + off);
        const float4 a = p[0], b = p[1];
        const float f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        q = pack8(f);
      } else {
        q = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(z.ptr[l]) + off);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = q;
  }
}

// acc[j] += A[16, k] (row-major, lda) x B[k, 16 j] for j < nj (nj <= NJ). B is
// row-major [k][ldb], or with kBt the transpose of a row-major [16 NJ][ldb]
// matrix.
template <int NJ, bool kBt>
__device__ __forceinline__ void warp_mm_acc(FragAcc (&acc)[NJ], const __nv_bfloat16* a, int lda,
                                            const __nv_bfloat16* b, int ldb, int k,
                                            int nj = NJ) {
  using BLayout = typename std::conditional<kBt, wmma::col_major, wmma::row_major>::type;
  for (int kk = 0; kk < k; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + kk, lda);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j >= nj) break;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> fb;
      if (kBt)
        wmma::load_matrix_sync(fb, b + (j * 16) * ldb + kk, ldb);
      else
        wmma::load_matrix_sync(fb, b + kk * ldb + j * 16, ldb);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

template <int NJ, bool kBt>
__device__ __forceinline__ void warp_mm(FragAcc (&acc)[NJ], const __nv_bfloat16* a, int lda,
                                        const __nv_bfloat16* b, int ldb, int k) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[j], 0.f);
  warp_mm_acc<NJ, kBt>(acc, a, lda, b, ldb, k);
}

}  // namespace njf_k7
