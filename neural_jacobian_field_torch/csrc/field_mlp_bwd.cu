// K7-bwd and K7-tz-bwd on Hopper: the backward of the ResnetFC trunk,
// recomputing each tile's forward, with the latent projection computed in the
// kernel (projection mode, K7-bwd) or read precomputed (tz mode, K7-tz-bwd).
//
// Replaces neural_jacobian_field_tpu/ops/pallas/field_mlp_train.py::_k7_bwd
// and ::_k7tz_bwd (body _make_bwd_kernel). Per point, with the forward of
// field_mlp.cu recomputed (bf16 layer outputs, so the ReLU masks are the
// forward's):
//   dW_out += relu(x_L)^T g,  db_out += sum g,  dx = (g W_out^T) * [x_L > 0]
//   for block i, last to first:
//     dW1 += relu(net)^T bf16(dx),    db1 += sum dx
//     dnet = (bf16(dx) W1^T) * [net > 0]
//     dW0 += relu(x_i)^T bf16(dnet),  db0 += sum dnet
//     dx  += (bf16(dnet) W0^T) * [x_i > 0];  dt_i = dx, db_z[i] += sum dx
//   dW_in += x_pe^T bf16(dx),  db_in += sum dx
// and in projection mode, with dt = [dt_0 .. dt_{n_lin_z-1}]:
//   dz_l = bf16(dt) W_z[rows of level l]^T  (float32 sum, stored in z_l's dtype)
//   dW_z[i][rows of level l] = bf16(z_l)^T bf16(dt_i)
// g arrives in bf16; matmul operands are bf16 with float32 accumulation; dx,
// dnet and every dW/db stay float32; x gets no gradient (sample positions are
// gradient-stopped upstream), as in the TPU kernel. The ReLU masks are real
// comparisons (the TPU kernel's clip(v * 1e30, 0, 1) is a Mosaic workaround).
//
// What bounds it on the H100, and what the design does about it:
//  - Compute: a point costs ~1.1 MFLOP in tz mode (the forward again, the
//    net recompute, the dx chain and the weight gradients) and ~2.2 MFLOP in
//    projection mode (plus the projection in the recompute, dz and dW_z),
//    bf16 WMMA 16x16x16 on the tensor cores.
//  - Shared memory: the TPU kernel holds the tile's activations and all 12
//    layers of float32 dW (~0.7 MB at d_hidden 128, ~1.5 MB with W_z) in
//    VMEM. A Hopper block has 227 KB. Here a block of 4 warps owns a tile of
//    64 points; the residual stream at each block's input (the only
//    activation the backward cannot cheaply recompute) goes to a global
//    scratch, written by the recompute and read back once (it mostly stays
//    in the 50 MB L2); net is recomputed from it. dx lives in registers (64
//    per thread at d_hidden 128). Shared memory holds one staged weight
//    matrix (streamed layer by layer, as in the forward) and three [64,
//    d_hidden] bf16 operand tiles: ~100 KB, two blocks per SM. The projection
//    in the recompute stages its latent chunks through the gradient operand
//    tile, unused until the backward starts.
//  - The weight-gradient reduction over N points: blocks run in no order, so
//    each of the `grid` persistent blocks adds its tiles' A^T G products into
//    its own float32 copy of the trunk's dW in global memory (WMMA
//    accumulators loaded from and stored back to it: a read-modify-write of
//    ~0.7 MB per tile), and each warp its column sums into its own copy of db;
//    a second kernel sums the copies in block order. No atomics: the result
//    is the same from run to run.
//  - dW_z (384 KB of float32 per 128-row level slice) would double that
//    read-modify-write, so it is not accumulated per tile. The trunk kernel
//    writes dt (bf16, [N, n_lin_z * d_hidden]) and computes dz at the end of
//    each tile from its rows, still in L2; a split-K kernel then computes
//    dW_z = z^T dt: each block owns a 64 x d_hidden tile of one slice over one
//    range of points, keeps it in MMA accumulators and writes it once, and an
//    ordered sum over the ranges finishes it. No atomics either.
// wgmma, TMA and double-buffered weight staging are later work.

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
using njf_k7::store8;
using njf_k7::warp_mm;
using njf_k7::warp_mm_acc;
using njf_k7::ZLevels;

namespace {

struct BwdArgs {
  const __nv_bfloat16* tz;  // tz mode: [N, n_lin_z * DH]
  ZLevels z;                // projection mode: the latent levels and their dz
  const __nv_bfloat16* x;   // [N, d_in]
  const __nv_bfloat16* g;   // [N, d_out]
  const __nv_bfloat16* w;   // packed weights (field_mlp_common.cuh)
  const __nv_bfloat16* wz;  // projection mode: W_z [n_lin_z, d_latent, DH]
  const float* b;           // packed biases
  __nv_bfloat16* stash;     // [n_tiles * 64, n_blocks, DH] block inputs
  __nv_bfloat16* dtz;       // [N, n_lin_z * DH]: dtz (tz mode) or dt (projection)
  float* wpart;             // [grid, w_total] per-block dW (zeroed)
  float* bpart;             // [grid * kWarps, b_total] per-warp db (zeroed)
  int n;
  int d_in;
  int k_in;
  int n_blocks;
  int n_lin_z;
  int d_out;
  int d_latent;
  int n_tiles;
  int w_total;
  int b_total;
};

// part[rows_k, cols_n] (row-major, float32, global) += A^T G over the block's
// 64 points: A [64, rows_k] (lda), G [64, cols_n] (ldg), both bf16 in shared
// memory. Each 16x16 tile of part is owned by one warp.
__device__ __forceinline__ void accumulate_dw(float* part, const __nv_bfloat16* A, int lda,
                                              int rows_k, const __nv_bfloat16* G, int ldg,
                                              int cols_n, int warp) {
  const int fc = cols_n / 16;
  const int n_frag = (rows_k / 16) * fc;
  for (int f = warp; f < n_frag; f += kWarps) {
    const int i = f / fc;
    const int j = f - i * fc;
    float* dst = part + static_cast<size_t>(i * 16) * cols_n + j * 16;
    FragAcc c;
    wmma::load_matrix_sync(c, dst, cols_n, wmma::mem_row_major);
#pragma unroll
    for (int p = 0; p < kTile; p += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, A + p * lda + i * 16, lda);
      wmma::load_matrix_sync(fb, G + p * ldg + j * 16, ldg);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(dst, c, cols_n, wmma::mem_row_major);
  }
}

// Epilogue mapping of a 16x16 fragment stored row-major to the warp's stage:
// lane l reads elements l*8 .. l*8+7, i.e. row l/2, columns (l%2)*8 .. +7.
// Sum over the warp's 16 rows of one such column (the 16 lanes of equal
// parity), in a fixed order.
__device__ __forceinline__ float rows_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// dst[col + t] += column sums of v over the warp's rows (lanes 0 and 1 write)
__device__ __forceinline__ void add_col_sums(float* dst, const float (&v)[8], int col,
                                             int lane) {
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const float s = rows_sum(v[t]);
    if (lane < 2) dst[col + t] += s;
  }
}

// the warp's 16 rows [row0, row0 + 16) of a bf16 [*, DH] slice (row stride
// ld) copied from global into dst (leading dimension ldd); zeros past n
template <int DH>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int ldd,
                                          const __nv_bfloat16* src, int ld, int row0, int n,
                                          int lane) {
  for (int v = lane; v < kRows * (DH / 8); v += 32) {
    const int r = v / (DH / 8);
    const int c = (v - r * (DH / 8)) * 8;
    const int row = row0 + r;
    *reinterpret_cast<uint4*>(dst + r * ldd + c) =
        row < n ? *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row) * ld + c)
                : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int DH, int NO, bool kProj>
__global__ void __launch_bounds__(kWarps * 32, 2) field_mlp_bwd_kernel(BwdArgs a) {
  constexpr int NJ = DH / 16;
  constexpr int kLd = DH + 8;          // operand tiles and staged weights
  constexpr int kNOut = NO * 16;
  constexpr int kLdOut = kNOut + 8;    // staged W_out
  extern __shared__ __align__(128) unsigned char smem[];

  const int ldx = a.k_in + 8;
  const int w_rows = a.k_in > DH ? a.k_in : DH;
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xpe = wbuf + (static_cast<size_t>(w_rows) * kLd * 2 + 127) / 128 * 64;
  __nv_bfloat16* opx = xpe + kTile * ldx;  // x (residual), then relu(block input)
  __nv_bfloat16* opa = opx + kTile * kLd;  // relu(net), or relu(x)
  __nv_bfloat16* opg = opa + kTile * kLd;  // bf16 gradients: g, dx, dnet, dt
  float* stage_all = reinterpret_cast<float*>(opg + kTile * kLd);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wr = warp * kRows;        // the warp's first row in the tile
  const int lr = wr + (lane >> 1);    // the lane's row in the tile (epilogue)
  const int lc = (lane & 1) * 8;      // its first column within a fragment
  float* stage = stage_all + warp * 256;
  const int nb = a.n_blocks;
  const int tz_w = a.n_lin_z * DH;
  const size_t blk_w = static_cast<size_t>(DH) * DH;
  const size_t w_in_sz = static_cast<size_t>(a.k_in) * DH;
  const size_t w_out_off = w_in_sz + 2 * nb * blk_w;
  const int b_out_off = DH + tz_w + 2 * nb * DH;
  float* wpart = a.wpart + static_cast<size_t>(blockIdx.x) * a.w_total;
  float* bpart = a.bpart + (static_cast<size_t>(blockIdx.x) * kWarps + warp) * a.b_total;

  FragAcc acc[NJ];
  float dx[NJ][8];

  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int t0 = tile * kTile;
    const int grow = t0 + lr;  // the lane's global row (epilogue)
    __syncthreads();           // the previous tile is done with every buffer

    // ---------------------------------------------------- forward recompute
    for (int e = lane; e < kRows * a.k_in; e += 32) {
      const int r = e / a.k_in;
      const int k = e - r * a.k_in;
      const int row = t0 + wr + r;
      xpe[(wr + r) * ldx + k] = (row < a.n && k < a.d_in)
                                    ? a.x[static_cast<size_t>(row) * a.d_in + k]
                                    : __float2bfloat16(0.f);
    }
    stage_matrix(wbuf, a.w, a.k_in, DH, kLd);
    __syncthreads();
    warp_mm<NJ, false>(acc, xpe + wr * ldx, ldx, wbuf, kLd, a.k_in);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      const int col = j * 16 + lc;
      float v[8], r[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        v[t] = bf(stage[lane * 8 + t] + a.b[col + t]);
        r[t] = relu(v[t]);
      }
      store8(opx + lr * kLd + col, v);
      store8(opa + lr * kLd + col, r);
      __syncwarp();
    }

    for (int blk = 0; blk < nb; ++blk) {
      const __nv_bfloat16* w0 = a.w + w_in_sz + 2 * blk * blk_w;
      const float* b0 = a.b + DH + tz_w + 2 * blk * DH;
      if (blk < a.n_lin_z) {
        // the injection x = bf16(x + bf16(t + b_z)); opa <- relu(x)
        if constexpr (kProj) {
          // t = z @ W_z[blk], the latent staged through opg
#pragma unroll
          for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[j], 0.f);
          const __nv_bfloat16* wz = a.wz + static_cast<size_t>(blk) * a.d_latent * DH;
          for (int l = 0; l < a.z.n_levels; ++l) {
            for (int c0 = 0; c0 < a.z.width[l]; c0 += DH) {
              const int cw = min(DH, a.z.width[l] - c0);
              __syncthreads();  // every warp is done with wbuf
              stage_matrix(wbuf, wz, cw, DH, kLd);
              njf_k7::load_level_rows(opg + wr * kLd, kLd, a.z, l, c0, cw, t0 + wr, kRows,
                                      a.n, lane);
              __syncthreads();
              warp_mm_acc<NJ, false>(acc, opg + wr * kLd, kLd, wbuf, kLd, cw);
              wz += static_cast<size_t>(cw) * DH;
            }
          }
          __syncwarp();
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if constexpr (kProj) {
            wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
            __syncwarp();
          }
          const int col = j * 16 + lc;
          float v[8], r[8];
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const int zc = blk * DH + col + t;
            float tv;
            if constexpr (kProj) {
              tv = stage[lane * 8 + t];
            } else {
              tv = grow < a.n ? __bfloat162float(a.tz[static_cast<size_t>(grow) * tz_w + zc])
                              : 0.f;
            }
            v[t] = bf(__bfloat162float(opx[lr * kLd + col + t]) + bf(tv + a.b[DH + zc]));
            r[t] = relu(v[t]);
          }
          store8(opx + lr * kLd + col, v);
          store8(opa + lr * kLd + col, r);
          __syncwarp();
        }
      }
      // stash the block input (own rows)
      for (int v = lane; v < kRows * (DH / 8); v += 32) {
        const int r = v / (DH / 8);
        const int c = (v - r * (DH / 8)) * 8;
        *reinterpret_cast<uint4*>(a.stash + (static_cast<size_t>(t0 + wr + r) * nb + blk) * DH +
                                  c) = *reinterpret_cast<const uint4*>(opx + (wr + r) * kLd + c);
      }
      // net = bf16(relu(x) W0 + b0); opa <- relu(net)
      __syncthreads();
      stage_matrix(wbuf, w0, DH, DH, kLd);
      __syncthreads();
      warp_mm<NJ, false>(acc, opa + wr * kLd, kLd, wbuf, kLd, DH);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
        __syncwarp();
        const int col = j * 16 + lc;
        float r[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) r[t] = relu(bf(stage[lane * 8 + t] + b0[col + t]));
        store8(opa + lr * kLd + col, r);
        __syncwarp();
      }
      // x = bf16(x + bf16(relu(net) W1 + b1)); opa <- relu(x)
      __syncthreads();
      stage_matrix(wbuf, w0 + blk_w, DH, DH, kLd);
      __syncthreads();
      warp_mm<NJ, false>(acc, opa + wr * kLd, kLd, wbuf, kLd, DH);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
        __syncwarp();
        const int col = j * 16 + lc;
        float v[8], r[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float d = bf(stage[lane * 8 + t] + b0[DH + col + t]);
          v[t] = bf(__bfloat162float(opx[lr * kLd + col + t]) + d);
          r[t] = relu(v[t]);
        }
        store8(opx + lr * kLd + col, v);
        store8(opa + lr * kLd + col, r);
        __syncwarp();
      }
    }
    // opx = x_L, opa = relu(x_L)

    // ------------------------------------------------------- lin_out backward
    for (int e = lane; e < kRows * kNOut; e += 32) {
      const int r = e / kNOut;
      const int c = e - r * kNOut;
      const int row = t0 + wr + r;
      opg[(wr + r) * kLd + c] = (row < a.n && c < a.d_out)
                                    ? a.g[static_cast<size_t>(row) * a.d_out + c]
                                    : __float2bfloat16(0.f);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = j * 16 + lc;
      float v[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) v[t] = __bfloat162float(opg[lr * kLd + col + t]);
      add_col_sums(bpart + b_out_off, v, col, lane);
    }
    __syncthreads();  // the last matmul is done with wbuf; opa, opg complete
    stage_matrix(wbuf, a.w + w_out_off, DH, kNOut, kLdOut);
    accumulate_dw(wpart + w_out_off, opa, kLd, DH, opg, kLd, kNOut, warp);
    __syncthreads();
    warp_mm<NJ, true>(acc, opg + wr * kLd, kLd, wbuf, kLdOut, kNOut);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      const int col = j * 16 + lc;
#pragma unroll
      for (int t = 0; t < 8; ++t)
        dx[j][t] = __bfloat162float(opx[lr * kLd + col + t]) > 0.f ? stage[lane * 8 + t] : 0.f;
      __syncwarp();
    }

    // ------------------------------------------------ residual blocks backward
    for (int blk = nb - 1; blk >= 0; --blk) {
      const __nv_bfloat16* w0 = a.w + w_in_sz + 2 * blk * blk_w;
      const size_t w0_off = w_in_sz + 2 * blk * blk_w;
      const int b0_off = DH + tz_w + 2 * blk * DH;
      __syncthreads();  // every warp is done with opx, opa, opg and wbuf
      // opx <- relu(x_i), the block's input from the stash (own rows)
      for (int v = lane; v < kRows * (DH / 8); v += 32) {
        const int r = v / (DH / 8);
        const int c = (v - r * (DH / 8)) * 8;
        const uint4 q = *reinterpret_cast<const uint4*>(
            a.stash + (static_cast<size_t>(t0 + wr + r) * nb + blk) * DH + c);
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&q);
        float f[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) f[t] = relu(__bfloat162float(h[t]));
        store8(opx + (wr + r) * kLd + c, f);
      }
      stage_matrix(wbuf, w0, DH, DH, kLd);
      __syncthreads();
      // recompute net; opa <- relu(net); opg <- bf16(dx); db1 += sum dx
      warp_mm<NJ, false>(acc, opx + wr * kLd, kLd, wbuf, kLd, DH);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
        __syncwarp();
        const int col = j * 16 + lc;
        float r[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) r[t] = relu(bf(stage[lane * 8 + t] + a.b[b0_off + col + t]));
        store8(opa + lr * kLd + col, r);
        store8(opg + lr * kLd + col, dx[j]);
        add_col_sums(bpart + b0_off + DH, dx[j], col, lane);
        __syncwarp();
      }
      __syncthreads();  // opa, opg complete; the net matmul is done with wbuf
      stage_matrix(wbuf, w0 + blk_w, DH, DH, kLd);
      __syncthreads();
      // dnet (held in acc) = bf16(dx) W1^T; dW1 += relu(net)^T bf16(dx)
      warp_mm<NJ, true>(acc, opg + wr * kLd, kLd, wbuf, kLd, DH);
      accumulate_dw(wpart + w0_off + blk_w, opa, kLd, DH, opg, kLd, DH, warp);
      __syncthreads();  // every warp is done reading opg for dW1
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
        __syncwarp();
        const int col = j * 16 + lc;
        float dn[8];
#pragma unroll
        for (int t = 0; t < 8; ++t)
          dn[t] = __bfloat162float(opa[lr * kLd + col + t]) > 0.f ? stage[lane * 8 + t] : 0.f;
        store8(opg + lr * kLd + col, dn);
        add_col_sums(bpart + b0_off, dn, col, lane);
        __syncwarp();
      }
      __syncthreads();  // opg = bf16(dnet) complete; done with W1
      stage_matrix(wbuf, w0, DH, DH, kLd);
      __syncthreads();
      // dx += (bf16(dnet) W0^T) * [x_i > 0]; dW0 += relu(x_i)^T bf16(dnet)
      warp_mm<NJ, true>(acc, opg + wr * kLd, kLd, wbuf, kLd, DH);
      accumulate_dw(wpart + w0_off, opx, kLd, DH, opg, kLd, DH, warp);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
        __syncwarp();
        const int col = j * 16 + lc;
#pragma unroll
        for (int t = 0; t < 8; ++t)
          if (__bfloat162float(opx[lr * kLd + col + t]) > 0.f) dx[j][t] += stage[lane * 8 + t];
        if (blk < a.n_lin_z) {
          if (grow < a.n) store8(a.dtz + static_cast<size_t>(grow) * tz_w + blk * DH + col, dx[j]);
          add_col_sums(bpart + DH + blk * DH, dx[j], col, lane);
        }
        __syncwarp();
      }
    }

    // -------------------------------------------------------- lin_in backward
    __syncthreads();  // every warp is done reading opg for dW0
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = j * 16 + lc;
      store8(opg + lr * kLd + col, dx[j]);
      add_col_sums(bpart, dx[j], col, lane);
    }
    __syncthreads();
    accumulate_dw(wpart, xpe, ldx, a.k_in, opg, kLd, DH, warp);

    // ------------------------------------- projection mode: dz from this tile
    if constexpr (kProj) {
      int lat0 = 0;  // the level's first row of W_z
      for (int l = 0; l < a.z.n_levels; ++l) {
        const int width = a.z.width[l];
        const bool f32 = (a.z.f32_mask >> l) & 1;
        for (int c0 = 0; c0 < width; c0 += DH) {
          const int cw = min(DH, width - c0);
#pragma unroll
          for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[j], 0.f);
          for (int i = 0; i < a.n_lin_z; ++i) {
            __syncthreads();  // every warp is done with wbuf and opg
            stage_matrix(wbuf, a.wz + (static_cast<size_t>(i) * a.d_latent + lat0 + c0) * DH,
                         cw, DH, kLd);
            load_rows<DH>(opg + wr * kLd, kLd, a.dtz + i * DH, tz_w, t0 + wr, a.n, lane);
            __syncthreads();
            // dz[:, c0 .. c0 + cw] += bf16(dt_i) W_z[i][rows]^T
            warp_mm_acc<NJ, true>(acc, opg + wr * kLd, kLd, wbuf, kLd, DH, cw / 16);
          }
          __syncwarp();
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            if (j * 16 >= cw) break;
            wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
            __syncwarp();
            if (grow < a.n) {
              const size_t off = static_cast<size_t>(grow) * width + c0 + j * 16 + lc;
              float v[8];
#pragma unroll
              for (int t = 0; t < 8; ++t) v[t] = stage[lane * 8 + t];
              if (f32) {
                float4* p = reinterpret_cast<float4*>(static_cast<float*>(a.z.grad[l]) + off);
                p[0] = make_float4(v[0], v[1], v[2], v[3]);
                p[1] = make_float4(v[4], v[5], v[6], v[7]);
              } else {
                store8(static_cast<__nv_bfloat16*>(a.z.grad[l]) + off, v);
              }
            }
            __syncwarp();
          }
        }
        lat0 += width;
      }
    }
  }
}

// out[e] = sum over blocks of wpart[b][e] (e < w_total), then the biases:
// sum over blocks and warps of bpart[bw][e], each in index order.
__global__ void reduce_partials_kernel(const float* __restrict__ wpart,
                                       const float* __restrict__ bpart,
                                       float* __restrict__ out, int w_total, int b_total,
                                       int grid) {
  const int total = w_total + b_total;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    float s = 0.f;
    if (e < w_total) {
      for (int b = 0; b < grid; ++b) s += wpart[static_cast<size_t>(b) * w_total + e];
    } else {
      const int eb = e - w_total;
      for (int b = 0; b < grid * kWarps; ++b) s += bpart[static_cast<size_t>(b) * b_total + eb];
    }
    out[e] = s;
  }
}

// dW_z partials: grid (ceil(d_latent / 64), n_lin_z, splits). Block (kt, i,
// s): rows [64 kt, 64 kt + 64) of W_z[i] (warp w: 16 of them, within one
// level), over points [s * chunk, min(n, (s + 1) * chunk)):
//   part[s][i][k][h] = sum_p bf16(z[p, k]) dt[p, i * DH + h]
template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
    field_mlp_dwz_kernel(ZLevels z, const __nv_bfloat16* __restrict__ dt,
                         float* __restrict__ part, int n, int n_lin_z, int d_latent,
                         int chunk) {
  constexpr int NJ = DH / 16;
  constexpr int kLd = DH + 8;
  constexpr int kLdA = 16 + 8;
  __shared__ __align__(128) __nv_bfloat16 gs[kTile * kLd];          // dt_i rows
  __shared__ __align__(128) __nv_bfloat16 zs[kWarps][kTile * kLdA];  // z columns
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.y;
  const int s = blockIdx.z;
  const int k = blockIdx.x * 64 + warp * 16;  // the warp's first latent row
  int l = 0, kl = k;
  while (l < z.n_levels && kl >= z.width[l]) kl -= z.width[l++];
  const bool active = k < d_latent;
  const int p_begin = s * chunk;
  const int p_end = min(n, p_begin + chunk);
  const int tz_w = n_lin_z * DH;

  FragAcc acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int p0 = p_begin; p0 < p_end; p0 += kTile) {
    __syncthreads();  // every warp is done with gs
    for (int v = threadIdx.x; v < kTile * (DH / 8); v += blockDim.x) {
      const int r = v / (DH / 8);
      const int c = (v - r * (DH / 8)) * 8;
      const int row = p0 + r;
      *reinterpret_cast<uint4*>(gs + r * kLd + c) =
          row < p_end ? *reinterpret_cast<const uint4*>(dt + static_cast<size_t>(row) * tz_w +
                                                        i * DH + c)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
    if (active) njf_k7::load_level_rows(zs[warp], kLdA, z, l, kl, 16, p0, kTile, p_end, lane);
    __syncthreads();
    if (active) {
#pragma unroll
      for (int pp = 0; pp < kTile; pp += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa;
        wmma::load_matrix_sync(fa, zs[warp] + pp * kLdA, kLdA);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, gs + pp * kLd + j * 16, kLd);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
  }
  if (!active) return;
  float* dst = part + ((static_cast<size_t>(s) * n_lin_z + i) * d_latent + k) * DH;
#pragma unroll
  for (int j = 0; j < NJ; ++j) wmma::store_matrix_sync(dst + j * 16, acc[j], DH, wmma::mem_row_major);
}

// out[e] = sum over s, in order, of part[s][e]
__global__ void reduce_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                     int total, int splits) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += part[static_cast<size_t>(s) * total + e];
    out[e] = acc;
  }
}

size_t smem_bytes(int k_in, int dh) {
  const int w_rows = k_in > dh ? k_in : dh;
  const size_t wbuf = (static_cast<size_t>(w_rows) * (dh + 8) * 2 + 127) / 128 * 128;
  return wbuf + static_cast<size_t>(kTile) * (k_in + 8) * 2 +
         3 * static_cast<size_t>(kTile) * (dh + 8) * 2 + kWarps * 256 * sizeof(float);
}

template <int DH, int NO, bool kProj>
int launch(const BwdArgs& args, int grid, cudaStream_t s) {
  const size_t smem = smem_bytes(args.k_in, DH);
  cudaError_t err = cudaFuncSetAttribute(field_mlp_bwd_kernel<DH, NO, kProj>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  field_mlp_bwd_kernel<DH, NO, kProj><<<grid, kWarps * 32, smem, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <bool kProj>
int launch_mode(const BwdArgs& args, int dh, int grid, cudaStream_t s) {
  const bool wide = args.d_out > 16;
  switch (dh) {
    case 32: return wide ? launch<32, 2, kProj>(args, grid, s) : launch<32, 1, kProj>(args, grid, s);
    case 64: return wide ? launch<64, 2, kProj>(args, grid, s) : launch<64, 1, kProj>(args, grid, s);
    case 128:
      return wide ? launch<128, 2, kProj>(args, grid, s) : launch<128, 1, kProj>(args, grid, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int reduce(const BwdArgs& args, void* out, int grid, cudaStream_t s) {
  const int total = args.w_total + args.b_total;
  int blocks = (total + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  reduce_partials_kernel<<<blocks, 256, 0, s>>>(args.wpart, args.bpart, static_cast<float*>(out),
                                                args.w_total, args.b_total, grid);
  return static_cast<int>(cudaGetLastError());
}

bool valid_trunk(int n, int d_in, int dh, int n_blocks, int n_lin_z, int d_out, int grid) {
  const int n_tiles = (n + kTile - 1) / kTile;
  return n > 0 && d_in > 0 && d_in <= 128 && d_out > 0 && d_out <= 32 && n_blocks >= 0 &&
         n_lin_z >= 0 && n_lin_z <= n_blocks && grid > 0 && grid <= n_tiles &&
         (dh == 32 || dh == 64 || dh == 128);
}

BwdArgs bwd_args(const void* x, const void* g, const void* w, const void* b, void* stash,
                 void* dtz, void* wpart, void* bpart, int n, int d_in, int dh, int n_blocks,
                 int n_lin_z, int d_out) {
  BwdArgs args = {};
  args.x = static_cast<const __nv_bfloat16*>(x);
  args.g = static_cast<const __nv_bfloat16*>(g);
  args.w = static_cast<const __nv_bfloat16*>(w);
  args.b = static_cast<const float*>(b);
  args.stash = static_cast<__nv_bfloat16*>(stash);
  args.dtz = static_cast<__nv_bfloat16*>(dtz);
  args.wpart = static_cast<float*>(wpart);
  args.bpart = static_cast<float*>(bpart);
  args.n = n;
  args.d_in = d_in;
  args.k_in = (d_in + 15) / 16 * 16;
  args.n_blocks = n_blocks;
  args.n_lin_z = n_lin_z;
  args.d_out = d_out;
  args.n_tiles = (n + kTile - 1) / kTile;
  const int n_out = (d_out + 15) / 16 * 16;
  args.w_total = args.k_in * dh + 2 * n_blocks * dh * dh + dh * n_out;
  args.b_total = dh * (1 + n_lin_z + 2 * n_blocks) + n_out;
  return args;
}

}  // namespace

// tz mode (K7-tz-bwd). Inputs as njf_field_mlp_tz_fwd, plus g [n, d_out]
// bf16. Scratch: stash [ceil(n/64)*64, n_blocks, dh] bf16; wpart [grid,
// w_total] and bpart [grid*4, b_total] float32, zeroed by the caller.
// Outputs: dtz [n, n_lin_z*dh] bf16; out [w_total + b_total] float32 = dW and
// db in the packed layouts (w_total = k_in*dh + 2*n_blocks*dh*dh + dh*n_out,
// b_total = dh*(1 + n_lin_z + 2*n_blocks) + n_out, n_out = 16*ceil(d_out/16)).
// 1 <= grid <= ceil(n/64).
extern "C" int njf_field_mlp_tz_bwd(const void* tz, const void* x, const void* g,
                                    const void* w, const void* b, void* stash, void* dtz,
                                    void* wpart, void* bpart, void* out, int n, int d_in,
                                    int dh, int n_blocks, int n_lin_z, int d_out, int grid,
                                    void* stream) {
  if (!valid_trunk(n, d_in, dh, n_blocks, n_lin_z, d_out, grid))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs args = bwd_args(x, g, w, b, stash, dtz, wpart, bpart, n, d_in, dh, n_blocks,
                          n_lin_z, d_out);
  args.tz = static_cast<const __nv_bfloat16*>(tz);
  auto s = static_cast<cudaStream_t>(stream);
  const int err = launch_mode<false>(args, dh, grid, s);
  return err != 0 ? err : reduce(args, out, grid, s);
}

// Projection mode (K7-bwd). The latent as njf_field_mlp_fwd takes it, and dz0..2
// [n, c_l] in the levels' dtypes; W_z [n_lin_z, d_latent, dh] bf16. dtz is
// scratch for dt [n, n_lin_z*dh] bf16; dwz_part scratch [splits, n_lin_z,
// d_latent, dh] float32 (splits >= 1, each of the n points in one of
// ceil(n / chunk) = splits ranges of chunk points). Outputs: out as
// njf_field_mlp_tz_bwd; dwz [n_lin_z, d_latent, dh] float32.
extern "C" int njf_field_mlp_bwd(const void* z0, const void* z1, const void* z2, void* dz0,
                                 void* dz1, void* dz2, int c0, int c1, int c2, int n_levels,
                                 int f32_mask, const void* x, const void* g, const void* w,
                                 const void* wz, const void* b, void* stash, void* dtz,
                                 void* wpart, void* bpart, void* out, void* dwz_part,
                                 void* dwz, int n, int d_in, int dh, int n_blocks,
                                 int n_lin_z, int d_out, int grid, int splits, void* stream) {
  const int widths[3] = {c0, c1, c2};
  const void* ptrs[3] = {z0, z1, z2};
  void* grads[3] = {dz0, dz1, dz2};
  if (!valid_trunk(n, d_in, dh, n_blocks, n_lin_z, d_out, grid) || n_levels < 1 ||
      n_levels > 3 || splits < 1 || splits > n)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs args = bwd_args(x, g, w, b, stash, dtz, wpart, bpart, n, d_in, dh, n_blocks,
                          n_lin_z, d_out);
  args.wz = static_cast<const __nv_bfloat16*>(wz);
  args.z.n_levels = n_levels;
  args.z.f32_mask = f32_mask;
  for (int l = 0; l < n_levels; ++l) {
    if (widths[l] <= 0 || widths[l] % 16) return static_cast<int>(cudaErrorInvalidValue);
    args.z.ptr[l] = ptrs[l];
    args.z.grad[l] = grads[l];
    args.z.width[l] = widths[l];
    args.d_latent += widths[l];
  }
  auto s = static_cast<cudaStream_t>(stream);
  int err = launch_mode<true>(args, dh, grid, s);
  if (err == 0) err = reduce(args, out, grid, s);
  if (err != 0 || n_lin_z == 0) return err;
  const int chunk = (n + splits - 1) / splits;
  const dim3 dgrid((args.d_latent + 63) / 64, n_lin_z, splits);
  const int total = n_lin_z * args.d_latent * dh;
  float* dst = splits == 1 ? static_cast<float*>(dwz) : static_cast<float*>(dwz_part);
  switch (dh) {
    case 32: field_mlp_dwz_kernel<32><<<dgrid, kWarps * 32, 0, s>>>(
        args.z, args.dtz, dst, n, n_lin_z, args.d_latent, chunk); break;
    case 64: field_mlp_dwz_kernel<64><<<dgrid, kWarps * 32, 0, s>>>(
        args.z, args.dtz, dst, n, n_lin_z, args.d_latent, chunk); break;
    default: field_mlp_dwz_kernel<128><<<dgrid, kWarps * 32, 0, s>>>(
        args.z, args.dtz, dst, n, n_lin_z, args.d_latent, chunk); break;
  }
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || splits == 1) return err;
  int blocks = (total + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  reduce_splits_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(dwz_part),
                                              static_cast<float*>(dwz), total, splits);
  return static_cast<int>(cudaGetLastError());
}
