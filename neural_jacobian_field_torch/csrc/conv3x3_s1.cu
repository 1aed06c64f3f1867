// K9-fwd on Hopper: stride-1 3x3 same-pad NHWC convolution as an implicit GEMM.
//
// Replaces neural_jacobian_field_tpu/ops/pallas/conv_suite.py::_s1_fwd
// (body _s1_fwd_kernel): y[b, i, j, :] = sum_{dy, dx, c} x[b, i+dy-1, j+dx-1, c]
// * w[dy, dx, c, :], zero outside the image. The weights arrive as one
// [9C, Cout] matrix in tap-major order (row = (dy*3 + dx)*C + c), exactly the
// TPU kernel's assembled contraction; the [rows, 9C] operand is never built in
// device memory: each block gathers its 64x32 slice of it straight from x.
//
// What bounds it on the H100: at the encoder's shapes (layer1 120x160x64,
// layer2 60x80x128, layer3 30x40x256, bf16) a conv is 0.3-1.4 GFLOP over
// 2.5-9 MB, so it sits near the ridge of the roofline and, at batch 1, is
// mostly bound by how many blocks are in flight (layer3 has only 76 output
// tiles for 132 SMs). The design answers with tensor cores (bf16 WMMA
// 16x16x16, f32 accumulation) and 16-byte vector gathers of the implicit
// operand; cp.async/TMA pipelining and wgmma are left to later work.
//
// bf16 in, f32 accumulate, bf16 out. Any B, H, W, C, Cout: a scalar gather path
// serves C or Cout that are not multiples of 8. The same kernel computes K9's
// input gradient (dgrad): the wrapper hands it the cotangent and the rotated,
// transposed weights, as conv_suite.py::_conv_s1_b does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "conv3x3_gather.cuh"

using namespace nvcuda;
using njf_k9::load_x_elem;
using njf_k9::load_x_vec;

namespace {

constexpr int kBM = 64;   // output pixels per block
constexpr int kBN = 64;   // output channels per block
constexpr int kBK = 32;   // reduction slice per step
constexpr int kLDA = kBK + 8;
constexpr int kLDB = kBN + 8;
constexpr int kLDC = kBN + 4;
constexpr int kThreads = 128;  // 4 warps, 2x2 over the 64x64 tile

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    conv3x3_s1_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      __nv_bfloat16* __restrict__ y, int B, int H, int W, int C,
                      int Cout) {
  __shared__ __align__(128) __nv_bfloat16 sa[kBM * kLDA];
  __shared__ __align__(128) __nv_bfloat16 sb[kBK * kLDB];
  __shared__ __align__(128) float sc[kBM * kLDC];

  const int M = B * H * W;
  const int K = 9 * C;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    if (kVec) {
      // A: 64 rows x 4 vectors of 8 channels; a vector never straddles a tap
      // because C % 8 == 0.
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int v = tid + it * kThreads;
        const int r = v >> 2;
        const int kv = (v & 3) * 8;
        *reinterpret_cast<uint4*>(&sa[r * kLDA + kv]) =
            load_x_vec(x, m0 + r, k0 + kv, M, K, H, W, C);
      }
      // B: 32 rows x 8 vectors of 8 output channels.
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int v = tid + it * kThreads;
        const int kr = v >> 3;
        const int nv = (v & 7) * 8;
        const int k = k0 + kr;
        const int n = n0 + nv;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (k < K && n < Cout)
          val = *reinterpret_cast<const uint4*>(
              w + static_cast<size_t>(k) * Cout + n);
        *reinterpret_cast<uint4*>(&sb[kr * kLDB + nv]) = val;
      }
    } else {
      for (int e = tid; e < kBM * kBK; e += kThreads) {
        const int r = e / kBK;
        const int kk = e - r * kBK;
        sa[r * kLDA + kk] = load_x_elem(x, m0 + r, k0 + kk, M, K, H, W, C);
      }
      for (int e = tid; e < kBK * kBN; e += kThreads) {
        const int kr = e / kBN;
        const int nn = e - kr * kBN;
        const int k = k0 + kr;
        const int n = n0 + nn;
        sb[kr * kLDB + nn] = (k < K && n < Cout)
                                 ? w[static_cast<size_t>(k) * Cout + n]
                                 : __float2bfloat16(0.f);
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
          fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
          fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &sa[(wm + i * 16) * kLDA + kk], kLDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &sb[kk * kLDB + wn + j * 16], kLDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&sc[(wm + i * 16) * kLDC + wn + j * 16],
                              acc[i][j], kLDC, wmma::mem_row_major);
  __syncthreads();

  if (kVec) {
    for (int v = tid; v < kBM * kBN / 8; v += kThreads) {
      const int r = v / (kBN / 8);
      const int nv = (v - r * (kBN / 8)) * 8;
      const int m = m0 + r;
      const int n = n0 + nv;
      if (m >= M || n >= Cout) continue;
      __align__(16) __nv_bfloat16 out[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) out[t] = __float2bfloat16(sc[r * kLDC + nv + t]);
      *reinterpret_cast<uint4*>(y + static_cast<size_t>(m) * Cout + n) =
          *reinterpret_cast<const uint4*>(out);
    }
  } else {
    for (int e = tid; e < kBM * kBN; e += kThreads) {
      const int r = e / kBN;
      const int nn = e - r * kBN;
      const int m = m0 + r;
      const int n = n0 + nn;
      if (m < M && n < Cout)
        y[static_cast<size_t>(m) * Cout + n] = __float2bfloat16(sc[r * kLDC + nn]);
    }
  }
}

}  // namespace

extern "C" int njf_conv3x3_s1_fwd(const void* x, const void* w, void* y, int B,
                                  int H, int W, int C, int Cout,
                                  void* stream) {
  const long long M = static_cast<long long>(B) * H * W;
  if (M <= 0 || C <= 0 || Cout <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM),
                  static_cast<unsigned>((Cout + kBN - 1) / kBN));
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  if (C % 8 == 0 && Cout % 8 == 0)
    conv3x3_s1_kernel<true><<<grid, kThreads, 0, s>>>(xb, wb, yb, B, H, W, C, Cout);
  else
    conv3x3_s1_kernel<false><<<grid, kThreads, 0, s>>>(xb, wb, yb, B, H, W, C, Cout);
  return static_cast<int>(cudaGetLastError());
}
