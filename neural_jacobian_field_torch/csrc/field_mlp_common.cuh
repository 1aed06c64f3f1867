// Shared by the K7-tz kernels (field_mlp_tz.cu, field_mlp_tz_bwd.cu).
//
// Packed weights (bf16, all row-major [in, out]):
//   W_in [k_in, dh] (rows >= d_in zero), then per block W0 [dh, dh], W1 [dh, dh],
//   then W_out [dh, 16 * ceil(d_out / 16)] (columns >= d_out zero).
// Packed biases (float32 holding bf16-rounded values):
//   b_in [dh], b_z [n_lin_z * dh], per block b0 [dh], b1 [dh], b_out [d_out pad].

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace njf_k7 {

// round to bf16 and back: every layer output of the trunk is a bf16 value
__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

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

}  // namespace njf_k7
