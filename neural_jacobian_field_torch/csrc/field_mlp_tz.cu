// K7-tz-fwd on Hopper: the whole ResnetFC trunk per tile of points, with the
// latent injection precomputed (tz mode).
//
// Replaces neural_jacobian_field_tpu/ops/pallas/field_mlp_train.py::_k7tz_fwd
// (body _make_fwd_kernel(tz_mode=True) / _forward_tile). For each point:
//   x   = bf16(x_pe @ W_in + b_in)
//   tzb = bf16(tz + b_z)                                  (n_lin_z * DH wide)
//   for block i: if i < n_lin_z: x = bf16(x + tzb[:, i*DH:(i+1)*DH])
//                net = bf16(relu(x) @ W0_i + b0_i)
//                x   = bf16(x + bf16(relu(net) @ W1_i + b1_i))
//   out = relu(x) @ W_out + b_out                          (float32)
// bf16 matmul operands, f32 accumulation, and every layer output cast to bf16,
// as in the TPU kernel, so the numbers track the JAX trunk.
//
// What bounds it on the H100: compute. At the flagship trunk (d_in 63, DH 128,
// 5 blocks) a point costs ~0.35 MFLOP against ~0.9 KB of input and output, so
// a 2048-ray x 256-sample chunk is ~180 GFLOP per trunk: tensor-core work. The
// activations never leave the SM: each warp owns 16 points and keeps their
// residual stream and matmul operand in shared memory across all 12 layers.
// The weights are ~345 KB in bf16 (ten 128x128 block matrices alone are
// 320 KB), more than a block's 227 KB of shared memory, so they are STREAMED
// layer by layer: one [K, DH] matrix at a time is staged in shared memory and
// shared by the block's 4 warps (64 points), and the next layer's matrix
// replaces it (the whole set stays hot in the 50 MB L2). The MMAs are bf16
// WMMA 16x16x16; wgmma, TMA and double-buffered weight staging are later work.
//
// Padding: d_in (63) is padded to a multiple of 16 inside the kernel (the
// packed W_in carries zero rows, the point tile zero columns), and d_out
// (1, 16 or 24) to 16 or 32 output columns (the packed W_out carries zero
// columns; only the first d_out are stored). Rows past N are computed on zeros
// and never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "field_mlp_common.cuh"

using namespace nvcuda;
using njf_k7::bf;
using njf_k7::stage_matrix;

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 16;
constexpr int kTile = kWarps * kRowsPerWarp;

struct TrunkArgs {
  const __nv_bfloat16* tz;   // [N, n_lin_z * DH]
  const __nv_bfloat16* x;    // [N, d_in]
  const __nv_bfloat16* w;    // packed weights, see njf_field_mlp_tz_fwd
  const float* b;            // packed biases (bf16-rounded values)
  float* out;                // [N, d_out]
  int n;
  int d_in;
  int k_in;                  // d_in rounded up to 16
  int n_blocks;
  int n_lin_z;
  int d_out;
};

template <int DH>
__device__ __forceinline__ void warp_matmul(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[DH / 16],
    const __nv_bfloat16* a, int lda, const __nv_bfloat16* wbuf, int ldw, int k) {
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int kk = 0; kk < k; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + kk, lda);
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, wbuf + kk * ldw + j * 16, ldw);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

template <int DH, int NO>
__global__ void __launch_bounds__(kWarps * 32)
    field_mlp_tz_kernel(TrunkArgs args) {
  constexpr int kLdW = DH + 8;  // staged weight rows (bf16)
  constexpr int kNOut = NO * 16;
  constexpr int kLdWOut = kNOut + 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];

  const int lds = (args.k_in > DH ? args.k_in : DH) + 8;  // operand rows (bf16)
  const int w_rows = args.k_in > DH ? args.k_in : DH;
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* per_warp_base =
      smem_raw + ((static_cast<size_t>(w_rows) * kLdW * 2 + 127) / 128) * 128;
  const size_t warp_bytes =
      ((static_cast<size_t>(kRowsPerWarp) * (kLdW + lds) * 2 + 127) / 128) * 128 +
      kRowsPerWarp * 16 * sizeof(float);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  unsigned char* mine = per_warp_base + warp * warp_bytes;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(mine);  // residual [16][kLdW]
  __nv_bfloat16* as = xs + kRowsPerWarp * kLdW;                // operand [16][lds]
  float* stage = reinterpret_cast<float*>(
      mine + ((static_cast<size_t>(kRowsPerWarp) * (kLdW + lds) * 2 + 127) / 128) * 128);

  const int row0 = blockIdx.x * kTile + warp * kRowsPerWarp;
  const int tz_w = args.n_lin_z * DH;

  // point tile of x_pe -> operand buffer, zero-padded to k_in columns
  for (int e = lane; e < kRowsPerWarp * args.k_in; e += 32) {
    const int r = e / args.k_in;
    const int k = e - r * args.k_in;
    const int row = row0 + r;
    as[r * lds + k] = (row < args.n && k < args.d_in)
                          ? args.x[static_cast<size_t>(row) * args.d_in + k]
                          : __float2bfloat16(0.f);
  }

  const __nv_bfloat16* w_ptr = args.w;
  const float* b_ptr = args.b;
  const float* b_z = args.b + DH;  // after b_in

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[DH / 16];

  // ---- lin_in (+ the first injection)
  stage_matrix(wbuf, w_ptr, args.k_in, DH, kLdW);
  __syncthreads();
  warp_matmul<DH>(acc, as, lds, wbuf, kLdW, args.k_in);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) {
    wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int e = lane * 8 + t;
      const int r = e / 16;
      const int col = j * 16 + (e % 16);
      const int row = row0 + r;
      float v = bf(stage[e] + b_ptr[col]);
      if (args.n_lin_z > 0) {
        const float tzv =
            row < args.n ? __bfloat162float(args.tz[static_cast<size_t>(row) * tz_w + col])
                         : 0.f;
        v = bf(v + bf(tzv + b_z[col]));
      }
      xs[r * kLdW + col] = __float2bfloat16(v);
      as[r * lds + col] = __float2bfloat16(fmaxf(v, 0.f));
    }
    __syncwarp();
  }
  w_ptr += static_cast<size_t>(args.k_in) * DH;
  b_ptr += DH + tz_w;

  // ---- residual blocks
  for (int blk = 0; blk < args.n_blocks; ++blk) {
    const float* b0 = b_ptr;
    const float* b1 = b_ptr + DH;
    // fc_0: net = bf16(relu(x) @ W0 + b0); operand <- relu(net)
    __syncthreads();
    stage_matrix(wbuf, w_ptr, DH, DH, kLdW);
    __syncthreads();
    warp_matmul<DH>(acc, as, lds, wbuf, kLdW, DH);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int e = lane * 8 + t;
        const int r = e / 16;
        const int col = j * 16 + (e % 16);
        const float net = bf(stage[e] + b0[col]);
        as[r * lds + col] = __float2bfloat16(fmaxf(net, 0.f));
      }
      __syncwarp();
    }
    w_ptr += static_cast<size_t>(DH) * DH;

    // fc_1: x = bf16(x + bf16(relu(net) @ W1 + b1)) [+ next injection];
    // operand <- relu(x)
    __syncthreads();
    stage_matrix(wbuf, w_ptr, DH, DH, kLdW);
    __syncthreads();
    warp_matmul<DH>(acc, as, lds, wbuf, kLdW, DH);
    __syncwarp();
    const bool inject = blk + 1 < args.n_lin_z;
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int e = lane * 8 + t;
        const int r = e / 16;
        const int col = j * 16 + (e % 16);
        const int row = row0 + r;
        const float dx = bf(stage[e] + b1[col]);
        float v = bf(__bfloat162float(xs[r * kLdW + col]) + dx);
        if (inject) {
          const int zc = (blk + 1) * DH + col;
          const float tzv =
              row < args.n
                  ? __bfloat162float(args.tz[static_cast<size_t>(row) * tz_w + zc])
                  : 0.f;
          v = bf(v + bf(tzv + b_z[zc]));
        }
        xs[r * kLdW + col] = __float2bfloat16(v);
        as[r * lds + col] = __float2bfloat16(fmaxf(v, 0.f));
      }
      __syncwarp();
    }
    w_ptr += static_cast<size_t>(DH) * DH;
    b_ptr += 2 * DH;
  }

  // ---- lin_out: out = relu(x) @ W_out + b_out (float32, first d_out columns)
  __syncthreads();
  stage_matrix(wbuf, w_ptr, DH, kNOut, kLdWOut);
  __syncthreads();
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_out[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) wmma::fill_fragment(acc_out[j], 0.f);
  for (int kk = 0; kk < DH; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, as + kk, lds);
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, wbuf + kk * kLdWOut + j * 16, kLdWOut);
      wmma::mma_sync(acc_out[j], fa, fb, acc_out[j]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    wmma::store_matrix_sync(stage, acc_out[j], 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int e = lane * 8 + t;
      const int r = e / 16;
      const int col = j * 16 + (e % 16);
      const int row = row0 + r;
      if (row < args.n && col < args.d_out)
        args.out[static_cast<size_t>(row) * args.d_out + col] = stage[e] + b_ptr[col];
    }
    __syncwarp();
  }
}

size_t smem_bytes(int k_in, int dh) {
  const int w_rows = k_in > dh ? k_in : dh;
  const int lds = w_rows + 8;
  const size_t wbuf = ((static_cast<size_t>(w_rows) * (dh + 8) * 2 + 127) / 128) * 128;
  const size_t warp_bytes =
      ((static_cast<size_t>(kRowsPerWarp) * ((dh + 8) + lds) * 2 + 127) / 128) * 128 +
      kRowsPerWarp * 16 * sizeof(float);
  return wbuf + kWarps * warp_bytes;
}

template <int DH, int NO>
int launch(const TrunkArgs& args, cudaStream_t s) {
  const size_t smem = smem_bytes(args.k_in, DH);
  const cudaError_t err = cudaFuncSetAttribute(
      field_mlp_tz_kernel<DH, NO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((args.n + kTile - 1) / kTile);
  field_mlp_tz_kernel<DH, NO><<<blocks, kWarps * 32, smem, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dh(const TrunkArgs& args, cudaStream_t s) {
  if (args.d_out <= 16) return launch<DH, 1>(args, s);
  if (args.d_out <= 32) return launch<DH, 2>(args, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Packed weights (bf16, all row-major [in, out]):
//   W_in [k_in, dh] (rows >= d_in zero), then per block W0 [dh, dh], W1 [dh, dh],
//   then W_out [dh, 16 * ceil(d_out / 16)] (columns >= d_out zero).
// Packed biases (float32 holding bf16-rounded values):
//   b_in [dh], b_z [n_lin_z * dh], per block b0 [dh], b1 [dh], b_out [d_out pad].
// dh in {32, 64, 128}; d_out <= 32; d_in <= 128; n_lin_z <= n_blocks.
extern "C" int njf_field_mlp_tz_fwd(const void* tz, const void* x, const void* w,
                                    const void* b, void* out, int n, int d_in,
                                    int dh, int n_blocks, int n_lin_z, int d_out,
                                    void* stream) {
  if (n <= 0 || d_in <= 0 || d_in > 128 || d_out <= 0 || n_blocks < 0 ||
      n_lin_z < 0 || n_lin_z > n_blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  TrunkArgs args;
  args.tz = static_cast<const __nv_bfloat16*>(tz);
  args.x = static_cast<const __nv_bfloat16*>(x);
  args.w = static_cast<const __nv_bfloat16*>(w);
  args.b = static_cast<const float*>(b);
  args.out = static_cast<float*>(out);
  args.n = n;
  args.d_in = d_in;
  args.k_in = (d_in + 15) / 16 * 16;
  args.n_blocks = n_blocks;
  args.n_lin_z = n_lin_z;
  args.d_out = d_out;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return launch_dh<32>(args, s);
    case 64: return launch_dh<64>(args, s);
    case 128: return launch_dh<128>(args, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
