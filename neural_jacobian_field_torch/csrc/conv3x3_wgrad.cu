// K9-wgrad on Hopper: the weight gradient of the stride-1 3x3 same-pad NHWC
// convolution, dW [9C, Cout] = A^T g, where A [B*H*W, 9C] is the implicit
// tap-major operand of K9-fwd and g [B*H*W, Cout] the output cotangent.
//
// Replaces neural_jacobian_field_tpu/ops/pallas/conv_suite.py::_s1_wgrad (body
// _s1_wgrad_kernel), which adds each row block's assembled-input^T x g into one
// float32 [9C, Cout] output carried across the TPU's sequential grid. Hopper
// blocks run in no order, so the reduction over the B*H*W rows (134,400 at
// layer1 with batch 7) is split: block (i, j, s) computes the 64x64 tile (i, j)
// of dW over the s-th slice of rows into its own float32 partial, and a second
// pass sums the partials in slice order. No atomics: the result is the same
// from run to run.
//
// What bounds it on the H100: at the encoder's training shapes (batch 7:
// layer1 134,400 x 576 x 64, layer2 33,600 x 1152 x 128, layer3 8,400 x 2304
// x 256) a wgrad is 10-20 GFLOP over ~20 MB of inputs, tensor-core work once
// enough blocks are in flight. dW has only 9 to 144 output tiles, far fewer
// than the 132 SMs need, so the row split is chosen by the wrapper to give
// about four blocks per SM. The MMAs are bf16 WMMA 16x16x16 with float32
// accumulation; the A operand is gathered straight from x with 16-byte loads
// (never built in device memory) and read back as a column-major fragment.
// cp.async/TMA pipelining and wgmma are later work.
//
// Any B, H, W, C, Cout: a scalar gather path serves C or Cout that are not
// multiples of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "conv3x3_gather.cuh"

using namespace nvcuda;
using njf_k9::load_x_elem;
using njf_k9::load_x_vec;

namespace {

constexpr int kTM = 64;  // dW rows (tap x input channel) per block
constexpr int kTN = 64;  // dW columns (output channel) per block
constexpr int kTK = 32;  // pixels per step
constexpr int kLdA = kTM + 8;
constexpr int kLdG = kTN + 8;
constexpr int kLdC = kTN + 4;
constexpr int kThreads = 128;  // 4 warps, 2x2 over the 64x64 tile

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    conv3x3_wgrad_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ g,
                         float* __restrict__ partial, int B, int H, int W, int C,
                         int Cout, int rows_per_split) {
  // sa[p][k]: pixel p of the step, operand column k of the tile (A, row-major),
  // read as the column-major 64 x 32 block of A^T; sg[p][n]: g, row-major.
  __shared__ __align__(128) __nv_bfloat16 sa[kTK * kLdA];
  __shared__ __align__(128) __nv_bfloat16 sg[kTK * kLdG];
  __shared__ __align__(128) float sc[kTM * kLdC];

  const int M = B * H * W;
  const int K = 9 * C;
  const int k0 = blockIdx.x * kTM;
  const int n0 = blockIdx.y * kTN;
  const int m_begin = blockIdx.z * rows_per_split;
  const int m_end = min(M, m_begin + rows_per_split);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wk = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int m0 = m_begin; m0 < m_end; m0 += kTK) {
    if (kVec) {
      // 32 pixels x 8 vectors of 8 columns, for A and for g
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int v = tid + it * kThreads;
        const int p = v >> 3;
        const int cv = (v & 7) * 8;
        const int m = m0 + p;
        const bool in = m < m_end;
        *reinterpret_cast<uint4*>(&sa[p * kLdA + cv]) =
            in ? load_x_vec(x, m, k0 + cv, M, K, H, W, C) : make_uint4(0u, 0u, 0u, 0u);
        uint4 gv = make_uint4(0u, 0u, 0u, 0u);
        if (in && n0 + cv < Cout)
          gv = *reinterpret_cast<const uint4*>(g + static_cast<size_t>(m) * Cout + n0 + cv);
        *reinterpret_cast<uint4*>(&sg[p * kLdG + cv]) = gv;
      }
    } else {
      for (int e = tid; e < kTK * kTM; e += kThreads) {
        const int p = e / kTM;
        const int kk = e - p * kTM;
        const int m = m0 + p;
        sa[p * kLdA + kk] = m < m_end ? load_x_elem(x, m, k0 + kk, M, K, H, W, C)
                                      : __float2bfloat16(0.f);
      }
      for (int e = tid; e < kTK * kTN; e += kThreads) {
        const int p = e / kTN;
        const int nn = e - p * kTN;
        const int m = m0 + p;
        const int n = n0 + nn;
        sg[p * kLdG + nn] = (m < m_end && n < Cout) ? g[static_cast<size_t>(m) * Cout + n]
                                                    : __float2bfloat16(0.f);
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kTK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &sa[kk * kLdA + wk + i * 16], kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &sg[kk * kLdG + wn + j * 16], kLdG);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&sc[(wk + i * 16) * kLdC + wn + j * 16], acc[i][j], kLdC,
                              wmma::mem_row_major);
  __syncthreads();

  float* out = partial + static_cast<size_t>(blockIdx.z) * K * Cout;
  for (int e = tid; e < kTM * kTN; e += kThreads) {
    const int r = e / kTN;
    const int nn = e - r * kTN;
    const int k = k0 + r;
    const int n = n0 + nn;
    if (k < K && n < Cout) out[static_cast<size_t>(k) * Cout + n] = sc[r * kLdC + nn];
  }
}

// dW[e] = sum over the splits of partial[s][e], in split order.
__global__ void sum_splits_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                                  long long n, int splits) {
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += partial[sp * n + e];
    dw[e] = s;
  }
}

}  // namespace

// x [B, H, W, C] and g [B, H, W, Cout] bf16; partial [splits, 9C, Cout] and
// dw [9C, Cout] float32. Rows are cut into `splits` slices of rows_per_split
// (a multiple of 32) pixels; splits * rows_per_split >= B*H*W.
extern "C" int njf_conv3x3_s1_wgrad(const void* x, const void* g, void* partial, void* dw,
                                    int B, int H, int W, int C, int Cout, int splits,
                                    int rows_per_split, void* stream) {
  const long long M = static_cast<long long>(B) * H * W;
  if (M <= 0 || C <= 0 || Cout <= 0 || splits <= 0 || rows_per_split <= 0 ||
      rows_per_split % kTK != 0 || static_cast<long long>(splits) * rows_per_split < M)
    return static_cast<int>(cudaErrorInvalidValue);
  const int K = 9 * C;
  const dim3 grid(static_cast<unsigned>((K + kTM - 1) / kTM),
                  static_cast<unsigned>((Cout + kTN - 1) / kTN),
                  static_cast<unsigned>(splits));
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  auto* pp = static_cast<float*>(partial);
  if (C % 8 == 0 && Cout % 8 == 0)
    conv3x3_wgrad_kernel<true><<<grid, kThreads, 0, s>>>(xb, gb, pp, B, H, W, C, Cout,
                                                          rows_per_split);
  else
    conv3x3_wgrad_kernel<false><<<grid, kThreads, 0, s>>>(xb, gb, pp, B, H, W, C, Cout,
                                                           rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(K) * Cout;
  long long blocks = (n + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  sum_splits_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      pp, static_cast<float*>(dw), n, splits);
  return static_cast<int>(cudaGetLastError());
}
