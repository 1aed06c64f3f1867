// Shared by the legacy K9 kernels (conv3x3_s1.cu, conv3x3_wgrad.cu): reads of
// the implicit [B*H*W, 9C] operand of a stride-1 3x3 same-pad NHWC
// convolution. Row m is output pixel (b, y, x); column k = (dy*3 + dx)*C + c
// is input channel c of tap (dy, dx), i.e. x[b, y+dy-1, x+dx-1, c], zero
// outside the image and outside [0, M) x [0, K). The TMA kernels take the
// same operand as boxes of x and need none of this.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace njf_k9 {

// Offset of element (m, k) in x, or -1 where the operand is zero.
__device__ __forceinline__ long long implicit_offset(int m, int k, int M, int K,
                                                     int H, int W, int C) {
  if (m >= M || k >= K) return -1;
  const int tap = k / C;
  const int c = k - tap * C;
  const int dy = tap / 3;
  const int dx = tap - dy * 3;
  const int hw = H * W;
  const int b = m / hw;
  const int rem = m - b * hw;
  const int yy = rem / W;
  const int xx = rem - yy * W;
  const int iy = yy + dy - 1;
  const int ix = xx + dx - 1;
  if (iy < 0 || iy >= H || ix < 0 || ix >= W) return -1;
  return ((static_cast<long long>(b) * H + iy) * W + ix) * C + c;
}

__device__ __forceinline__ __nv_bfloat16 load_x_elem(
    const __nv_bfloat16* __restrict__ x, int m, int k, int M, int K, int H,
    int W, int C) {
  const long long off = implicit_offset(m, k, M, K, H, W, C);
  return off < 0 ? __float2bfloat16(0.f) : x[off];
}

}  // namespace njf_k9
