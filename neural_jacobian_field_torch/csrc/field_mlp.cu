// K7-fwd and K7-tz-fwd on Hopper: the whole ResnetFC trunk per tile of
// points, with the latent projection computed in the kernel (projection mode,
// K7-fwd) or read precomputed (tz mode, K7-tz-fwd).
//
// Replaces neural_jacobian_field_tpu/ops/pallas/field_mlp_train.py::_k7_fwd
// and ::_k7tz_fwd (body _make_fwd_kernel / _forward_tile). For each point:
//   x   = bf16(x_pe @ W_in + b_in)
//   for block i: if i < n_lin_z: x = bf16(x + bf16(t_i + b_z[i]))
//                net = bf16(relu(x) @ W0_i + b0_i)
//                x   = bf16(x + bf16(relu(net) @ W1_i + b1_i))
//   out = relu(x) @ W_out + b_out                          (float32)
// with t_i = sum_l z_l @ W_z[i][rows of level l] in float32 (projection mode:
// the latent arrives as up to three levels, bf16 or float32, each rounded to
// bf16 as it is loaded), or t_i the bf16 slice i of a precomputed tz (tz
// mode). bf16 matmul operands, f32 accumulation, and every layer output cast
// to bf16, as in the TPU kernel, so the numbers track the JAX trunk.
//
// What bounds it on the H100: compute. At the flagship trunk (d_in 63, DH 128,
// 5 blocks, latent 512 = 128 + 128 + 256) a point costs ~0.35 MFLOP in the
// trunk and ~0.39 MFLOP in the projection against ~1.9 KB of input and
// output. The activations never leave the SM: each warp owns 16 points and
// keeps their residual stream and matmul operand in shared memory across all
// layers. The weights (~345 KB of trunk, 384 KB of W_z in bf16) exceed a
// block's 227 KB of shared memory, so they are STREAMED: one [K, DH] matrix
// at a time is staged in shared memory and shared by the block's 4 warps (64
// points), and the next replaces it (the whole set stays hot in the 50 MB
// L2). The projection of slice i runs just before block i's injection: W_z[i]
// streams in K-chunks of up to 128 latent rows while each warp stages the
// same columns of its 16 points' latent into its operand buffer (free at that
// moment), so the projection needs no shared memory of its own and its f32
// sum stays in the MMA accumulators. The MMAs are bf16 WMMA 16x16x16; wgmma,
// TMA and double-buffered staging are later work.
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
using njf_k7::FragAcc;
using njf_k7::kRows;
using njf_k7::kTile;
using njf_k7::kWarps;
using njf_k7::relu;
using njf_k7::stage_matrix;
using njf_k7::ZLevels;

namespace {

struct TrunkArgs {
  const __nv_bfloat16* tz;   // tz mode: [N, n_lin_z * DH]
  ZLevels z;                 // projection mode: the latent levels
  const __nv_bfloat16* x;    // [N, d_in]
  const __nv_bfloat16* w;    // packed weights (field_mlp_common.cuh)
  const __nv_bfloat16* wz;   // projection mode: W_z [n_lin_z, d_latent, DH]
  const float* b;            // packed biases (bf16-rounded values)
  float* out;                // [N, d_out]
  int n;
  int d_in;
  int k_in;                  // d_in rounded up to 16
  int n_blocks;
  int n_lin_z;
  int d_out;
  int d_latent;
};

// the warp's 16 x DH float32 tile in acc, one fragment at a time through the
// warp's stage: fn(j, t, e, r, col) per element (e = stage index, r = row in
// the warp, col = column), with __syncwarp around each fragment
template <int NJ, typename Fn>
__device__ __forceinline__ void epilogue(FragAcc (&acc)[NJ], float* stage, int lane, Fn fn) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int e = lane * 8 + t;
      fn(e, e / 16, j * 16 + (e % 16));
    }
    __syncwarp();
  }
}

template <int DH, int NO, bool kProj>
__global__ void __launch_bounds__(kWarps * 32)
    field_mlp_fwd_kernel(TrunkArgs args) {
  constexpr int NJ = DH / 16;
  constexpr int kLdW = DH + 8;  // staged weight rows (bf16)
  constexpr int kNOut = NO * 16;
  constexpr int kLdWOut = kNOut + 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];

  const int w_rows = args.k_in > DH ? args.k_in : DH;
  const int lds = w_rows + 8;  // operand rows (bf16)
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* per_warp_base =
      smem_raw + ((static_cast<size_t>(w_rows) * kLdW * 2 + 127) / 128) * 128;
  const size_t warp_bytes =
      ((static_cast<size_t>(kRows) * (kLdW + lds) * 2 + 127) / 128) * 128 +
      kRows * 16 * sizeof(float);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  unsigned char* mine = per_warp_base + warp * warp_bytes;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(mine);  // residual [16][kLdW]
  __nv_bfloat16* as = xs + kRows * kLdW;                       // operand [16][lds]
  float* stage = reinterpret_cast<float*>(
      mine + ((static_cast<size_t>(kRows) * (kLdW + lds) * 2 + 127) / 128) * 128);

  const int row0 = blockIdx.x * kTile + warp * kRows;
  const int tz_w = args.n_lin_z * DH;

  // point tile of x_pe -> operand buffer, zero-padded to k_in columns
  for (int e = lane; e < kRows * args.k_in; e += 32) {
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

  FragAcc acc[NJ];

  // ---- lin_in
  stage_matrix(wbuf, w_ptr, args.k_in, DH, kLdW);
  __syncthreads();
  njf_k7::warp_mm<NJ, false>(acc, as, lds, wbuf, kLdW, args.k_in);
  __syncwarp();
  epilogue(acc, stage, lane, [&](int e, int r, int col) {
    const float v = bf(stage[e] + b_ptr[col]);
    xs[r * kLdW + col] = __float2bfloat16(v);
    as[r * lds + col] = __float2bfloat16(relu(v));
  });
  w_ptr += static_cast<size_t>(args.k_in) * DH;
  b_ptr += DH + tz_w;

  // ---- residual blocks
  for (int blk = 0; blk < args.n_blocks; ++blk) {
    if (blk < args.n_lin_z) {
      // the injection x = bf16(x + bf16(t + b_z)); operand <- relu(x)
      if constexpr (kProj) {
        // t = z @ W_z[blk], the latent staged through the operand buffer
#pragma unroll
        for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[j], 0.f);
        const __nv_bfloat16* wz = args.wz + static_cast<size_t>(blk) * args.d_latent * DH;
        for (int l = 0; l < args.z.n_levels; ++l) {
          for (int c0 = 0; c0 < args.z.width[l]; c0 += w_rows) {
            const int cw = min(w_rows, args.z.width[l] - c0);
            __syncthreads();  // every warp is done with wbuf
            stage_matrix(wbuf, wz, cw, DH, kLdW);
            njf_k7::load_level_rows(as, lds, args.z, l, c0, cw, row0, kRows, args.n, lane);
            __syncthreads();
            njf_k7::warp_mm_acc<NJ, false>(acc, as, lds, wbuf, kLdW, cw);
            wz += static_cast<size_t>(cw) * DH;
          }
        }
        __syncwarp();
        epilogue(acc, stage, lane, [&](int e, int r, int col) {
          const float v = bf(__bfloat162float(xs[r * kLdW + col]) +
                             bf(stage[e] + b_z[blk * DH + col]));
          xs[r * kLdW + col] = __float2bfloat16(v);
          as[r * lds + col] = __float2bfloat16(relu(v));
        });
      } else {
        for (int e = lane; e < kRows * DH; e += 32) {
          const int r = e / DH;
          const int col = e - r * DH;
          const int row = row0 + r;
          const int zc = blk * DH + col;
          const float tzv =
              row < args.n ? __bfloat162float(args.tz[static_cast<size_t>(row) * tz_w + zc])
                           : 0.f;
          const float v = bf(__bfloat162float(xs[r * kLdW + col]) + bf(tzv + b_z[zc]));
          xs[r * kLdW + col] = __float2bfloat16(v);
          as[r * lds + col] = __float2bfloat16(relu(v));
        }
        __syncwarp();
      }
    }
    const float* b0 = b_ptr;
    const float* b1 = b_ptr + DH;
    // fc_0: net = bf16(relu(x) @ W0 + b0); operand <- relu(net)
    __syncthreads();
    stage_matrix(wbuf, w_ptr, DH, DH, kLdW);
    __syncthreads();
    njf_k7::warp_mm<NJ, false>(acc, as, lds, wbuf, kLdW, DH);
    __syncwarp();
    epilogue(acc, stage, lane, [&](int e, int r, int col) {
      as[r * lds + col] = __float2bfloat16(relu(bf(stage[e] + b0[col])));
    });
    w_ptr += static_cast<size_t>(DH) * DH;

    // fc_1: x = bf16(x + bf16(relu(net) @ W1 + b1)); operand <- relu(x)
    __syncthreads();
    stage_matrix(wbuf, w_ptr, DH, DH, kLdW);
    __syncthreads();
    njf_k7::warp_mm<NJ, false>(acc, as, lds, wbuf, kLdW, DH);
    __syncwarp();
    epilogue(acc, stage, lane, [&](int e, int r, int col) {
      const float v = bf(__bfloat162float(xs[r * kLdW + col]) + bf(stage[e] + b1[col]));
      xs[r * kLdW + col] = __float2bfloat16(v);
      as[r * lds + col] = __float2bfloat16(relu(v));
    });
    w_ptr += static_cast<size_t>(DH) * DH;
    b_ptr += 2 * DH;
  }

  // ---- lin_out: out = relu(x) @ W_out + b_out (float32, first d_out columns)
  __syncthreads();
  stage_matrix(wbuf, w_ptr, DH, kNOut, kLdWOut);
  __syncthreads();
  FragAcc acc_out[NO];
  njf_k7::warp_mm<NO, false>(acc_out, as, lds, wbuf, kLdWOut, DH);
  __syncwarp();
  epilogue(acc_out, stage, lane, [&](int e, int r, int col) {
    const int row = row0 + r;
    if (row < args.n && col < args.d_out)
      args.out[static_cast<size_t>(row) * args.d_out + col] = stage[e] + b_ptr[col];
  });
}

size_t smem_bytes(int k_in, int dh) {
  const int w_rows = k_in > dh ? k_in : dh;
  const int lds = w_rows + 8;
  const size_t wbuf = ((static_cast<size_t>(w_rows) * (dh + 8) * 2 + 127) / 128) * 128;
  const size_t warp_bytes =
      ((static_cast<size_t>(kRows) * ((dh + 8) + lds) * 2 + 127) / 128) * 128 +
      kRows * 16 * sizeof(float);
  return wbuf + kWarps * warp_bytes;
}

template <int DH, int NO, bool kProj>
int launch(const TrunkArgs& args, cudaStream_t s) {
  const size_t smem = smem_bytes(args.k_in, DH);
  const cudaError_t err = cudaFuncSetAttribute(
      field_mlp_fwd_kernel<DH, NO, kProj>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((args.n + kTile - 1) / kTile);
  field_mlp_fwd_kernel<DH, NO, kProj><<<blocks, kWarps * 32, smem, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <bool kProj>
int launch_mode(const TrunkArgs& args, int dh, cudaStream_t s) {
  const bool wide = args.d_out > 16;
  switch (dh) {
    case 32: return wide ? launch<32, 2, kProj>(args, s) : launch<32, 1, kProj>(args, s);
    case 64: return wide ? launch<64, 2, kProj>(args, s) : launch<64, 1, kProj>(args, s);
    case 128: return wide ? launch<128, 2, kProj>(args, s) : launch<128, 1, kProj>(args, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool valid_trunk(int n, int d_in, int dh, int n_blocks, int n_lin_z, int d_out) {
  return n > 0 && d_in > 0 && d_in <= 128 && d_out > 0 && d_out <= 32 && n_blocks >= 0 &&
         n_lin_z >= 0 && n_lin_z <= n_blocks && (dh == 32 || dh == 64 || dh == 128);
}

TrunkArgs trunk_args(const void* x, const void* w, const void* b, void* out, int n, int d_in,
                     int n_blocks, int n_lin_z, int d_out) {
  TrunkArgs args = {};
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
  return args;
}

}  // namespace

// tz mode (K7-tz-fwd). Packed weights and biases as field_mlp_common.cuh says;
// tz [n, n_lin_z * dh] bf16, x [n, d_in] bf16 -> out [n, d_out] float32.
// dh in {32, 64, 128}; d_out <= 32; d_in <= 128; n_lin_z <= n_blocks.
extern "C" int njf_field_mlp_tz_fwd(const void* tz, const void* x, const void* w,
                                    const void* b, void* out, int n, int d_in,
                                    int dh, int n_blocks, int n_lin_z, int d_out,
                                    void* stream) {
  if (!valid_trunk(n, d_in, dh, n_blocks, n_lin_z, d_out))
    return static_cast<int>(cudaErrorInvalidValue);
  TrunkArgs args = trunk_args(x, w, b, out, n, d_in, n_blocks, n_lin_z, d_out);
  args.tz = static_cast<const __nv_bfloat16*>(tz);
  return launch_mode<false>(args, dh, static_cast<cudaStream_t>(stream));
}

// Projection mode (K7-fwd): the latent is n_levels (1..3) arrays z_l [n, c_l]
// (bit l of f32_mask: float32, else bf16; c_l % 16 == 0), W_z [n_lin_z,
// sum c_l, dh] bf16; otherwise as njf_field_mlp_tz_fwd.
extern "C" int njf_field_mlp_fwd(const void* z0, const void* z1, const void* z2, int c0,
                                 int c1, int c2, int n_levels, int f32_mask, const void* x,
                                 const void* w, const void* wz, const void* b, void* out,
                                 int n, int d_in, int dh, int n_blocks, int n_lin_z,
                                 int d_out, void* stream) {
  const int widths[3] = {c0, c1, c2};
  const void* ptrs[3] = {z0, z1, z2};
  if (!valid_trunk(n, d_in, dh, n_blocks, n_lin_z, d_out) || n_levels < 1 || n_levels > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  TrunkArgs args = trunk_args(x, w, b, out, n, d_in, n_blocks, n_lin_z, d_out);
  args.wz = static_cast<const __nv_bfloat16*>(wz);
  args.z.n_levels = n_levels;
  args.z.f32_mask = f32_mask;
  for (int l = 0; l < n_levels; ++l) {
    if (widths[l] <= 0 || widths[l] % 16) return static_cast<int>(cudaErrorInvalidValue);
    args.z.ptr[l] = ptrs[l];
    args.z.width[l] = widths[l];
    args.d_latent += widths[l];
  }
  return launch_mode<true>(args, dh, static_cast<cudaStream_t>(stream));
}
