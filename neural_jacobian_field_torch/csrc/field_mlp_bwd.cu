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
// What bounds it on the H100: compute. A point costs ~1.0 MFLOP in tz mode
// (the forward again, the dx chain and the weight gradients; the legacy
// kernel also recomputes net) and ~2.2 MFLOP in projection mode (plus the
// projection in the recompute, dz and dW_z).
// The TPU kernel keeps the tile's activations and all 12 layers of float32
// dW (~0.7 MB at d_hidden 128, ~1.5 MB with W_z) in VMEM across its
// sequential grid; an H100 block has 227 KB of shared memory and runs in no
// order with the others. Two kernels:
//
// The wgmma path (d_hidden 128, d_in <= 64, latent widths multiples of 64,
// at most 7 blocks; the flagship's every shape), chosen by
// field_mlp.bwd_plan, in two passes
// over chunks of points (each chunk's sums added to the last in chunk
// order), both deterministic:
//  1. The gradient chain, persistent and warp-specialised like the forward
//     (field_mlp.cu): one block per SM over tiles of 128 points, a producer
//     thread keeping a 3-stage ring of 64 KB TMA stages full, two consumer
//     warpgroups of 64 points each running the whole chain with register-A
//     wgmma.m64n128k16 (the accumulator, rounded and packed to bf16x2, is
//     the next product's A fragment). The forward recompute is the forward
//     kernel's (forward packing, x_pe padded to 64 columns, the projection
//     from TMA boxes of the latent). The dx chain reads each weight tile K-
//     major, which IS W^T as B: the tile the forward reads MN-major, no
//     transposed copy. dx stays float32 in registers. The chain writes the
//     weight gradients' operands to a bf16 scratch [n, slots x 128] (A:
//     relu(x_i), relu(x_L), relu(net_i); G: bf16(dnet_i), bf16(dx) where it
//     is not dt) and dt itself, the four lanes of a row group trading words
//     so that each store is 16 contiguous bytes, while the next wgmma runs.
//     The ReLU masks [x_i > 0] = [relu(x_i) > 0] and [net_i > 0] of every
//     block stay in registers from the recompute to the backward, as bits
//     (a stack of 4 words per block: at most 7 blocks). The bias
//     gradients are column sums of the float32 dx / dnet (and of g), reduced
//     in registers and shuffles, added per consumer in shared memory in tile
//     order and written once per consumer. Projection mode computes dz_l =
//     bf16(dt) W_z[rows of level l]^T at the end of each tile, 64 latent
//     columns at a time from the dt the thread just wrote.
//  2. The weight gradients, one split-K kernel for every layer: dW = A^T G
//     over points (lin_in: x_pe and dx_0; fc_0 / fc_1 of each block; lin_out:
//     relu(x_L) and g; projection mode: each lin_z kernel, bf16(z_l) and dt_i,
//     128 latent rows a job). Block (job, split) streams 64-point tiles of A
//     and G by TMA through a 6-stage ring and reads both MN-major (the
//     transpose bit: the points are the contraction), two consumer
//     warpgroups of 64 rows each, the 64 x 128 float32 sum in registers over
//     the whole split, written once. A third kernel adds the splits in order
//     (and the consumers' bias sums), then the chunks in order.
//  Operand traffic at the flagship's shapes: ~4.9 KB written (19 bf16 rows
//  of 256 B) and ~5.9 KB read per point, against ~22 KB of the legacy
//  path's per-tile read-modify-write of dW partials; the second pass is
//  bound by it (HBM), the chain by its serial wgmma / epilogue chain.
//
// The legacy path (other shapes: d_hidden 32 or 64, d_in > 64, latent levels
// not multiples of 64, more blocks), counted apart in the backward wrappers'
// `legacy_launches`: a block of 4 warps owns a tile of 64 points; the
// residual stream at each block's input goes to a global scratch, written by
// the recompute and read back once; net is recomputed from it. dx lives in
// registers. Shared memory holds one staged weight matrix and three [64,
// d_hidden] bf16 operand tiles; bf16 WMMA 16x16x16. Each of the persistent
// blocks adds its tiles' A^T G products into its own float32 copy of the
// trunk's dW in global memory (a read-modify-write of ~0.7 MB per tile), and
// each warp its column sums into its own copy of db; a second kernel sums
// the copies in block order. dW_z is not accumulated per tile: the trunk
// kernel writes dt and computes dz at the end of each tile; a split-K kernel
// computes dW_z = z^T dt, summed over the splits in order.
// No atomics on either path: the result is the same from run to run.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "field_mlp_common.cuh"
#include "hopper_tma.cuh"

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

// ------------------------------------------------------------ the wgmma path

namespace {
namespace wgb {

constexpr int kDH = 128;
constexpr int kPts = 64;                   // points per consumer warpgroup
constexpr int kConsumers = 2;
constexpr int kTile = kPts * kConsumers;   // points per chain tile
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 3;
constexpr int kBox = 64 * 128;             // a TMA box: 64 rows x 128 bytes
constexpr int kWBytes = 4 * kBox;          // a [128, 128] bf16 weight matrix
constexpr int kInBytes = 2 * kBox;         // one consumer's input tiles of a step
constexpr int kStageBytes = kWBytes + kConsumers * kInBytes;
constexpr int kHalf = 2 * kBox;            // 64 columns of a 128-row weight matrix
constexpr int kInRows = 64;                // x_pe and g padded to 64 columns
constexpr int kOutCols = 64;               // W_out's columns the kernels read
constexpr int kSmemMax = 232448;
constexpr int kDwStages = 6;
constexpr int kDwStageBytes = 4 * kBox;    // A: 2 boxes, G: 2 boxes
constexpr int kMaxJobs = 64;
constexpr int kStageFloats = 4 * 128;      // a column-sum stage: 4 warps x 128
constexpr int kMaskBlocks = 7;             // blocks whose ReLU masks the chain holds

// The forward packing's biases (field_mlp._pack_fwd): b_in, b_z, per block
// b0 and b1, b_out padded to 64.
__host__ __device__ inline int fwd_bias_floats(int n_blocks, int n_lin_z) {
  return kDH * (1 + n_lin_z + 2 * n_blocks) + kOutCols;
}

// The chain's bias gradients: db_in [128], per block db0 [128] and db1
// [128], db_out [64] (the lin_z biases' are db_in's and the db1 of the block
// before: the same sums).
__host__ __device__ inline int db_floats(int n_blocks) {
  return kDH * (1 + 2 * n_blocks) + kOutCols;
}

// The chain's dynamic shared memory: alignment slack, the ring, the forward
// biases, each consumer's bias-gradient sums and two column-sum stages, the
// barriers (field_mlp.bwd_plan computes the same).
size_t chain_smem_bytes(int n_blocks, int n_lin_z) {
  return 1024 + static_cast<size_t>(kStages) * kStageBytes +
         4 * static_cast<size_t>(fwd_bias_floats(n_blocks, n_lin_z)) +
         4 * static_cast<size_t>(kConsumers) * (db_floats(n_blocks) + 2 * kStageFloats) +
         16 * kStages;
}

size_t dw_smem_bytes() {
  return 1024 + static_cast<size_t>(kDwStages) * kDwStageBytes + 16 * kDwStages;
}

// The scratch slots ([n, n_slots * 128] bf16) that the chain writes and the
// weight-gradient pass reads (field_mlp.bwd_slots says the same):
//   A operands: relu(x_i) (block i's input after the injection) at i,
//     relu(x_L) at n_blocks, relu(net_i) at n_blocks + 1 + i;
//   G operands: bf16(dnet_i) at 2 n_blocks + 1 + i; bf16 of the gradient
//     entering block i's backward at 3 n_blocks + 1 + i - max(n_lin_z - 1, 0),
//     unless it is dt_{i + 1} (i + 1 < n_lin_z), which the chain writes to dt
//     anyway; the gradient at lin_in's output likewise is dt_0, or, without
//     injection, the last slot.
__device__ __forceinline__ int slot_an(int nb, int i) { return nb + 1 + i; }
__device__ __forceinline__ int slot_dnet(int nb, int i) { return 2 * nb + 1 + i; }
__device__ __forceinline__ int slot_dxe(int nb, int nlz, int i) {
  return 3 * nb + 1 + i - (nlz > 1 ? nlz - 1 : 0);
}
int n_slots(int nb, int nlz) { return 4 * nb + 1 - (nlz > 1 ? nlz - 1 : 0) + (nlz == 0 ? 1 : 0); }

// Rows of the forward packing: W_in at 0 (64 rows), block b's W0 at 64 + 256 b
// and W1 128 rows on, W_out after the blocks, lin_z_i's kernel [d_lat, 128]
// at w_out + 128 + i d_lat.
__device__ __forceinline__ int w_out_row(int n_blocks) { return kInRows + 2 * kDH * n_blocks; }

// -- register fragments (as field_mlp.cu's forward kernel reads them)

__device__ __forceinline__ float bfr(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// byte cb of row r of a 128-byte-swizzled box (1,024-byte aligned)
__device__ __forceinline__ const uint8_t* sw(const uint8_t* box, int r, int cb) {
  return box + r * 128 + ((((cb >> 4) ^ (r & 7)) << 4) | (cb & 15));
}

__device__ __forceinline__ uint32_t ld_b2(const uint8_t* box, int r, int cb) {
  return *reinterpret_cast<const uint32_t*>(sw(box, r, cb));
}

__device__ __forceinline__ uint32_t ld_f2(const uint8_t* box, int r, int cb) {
  const float2 v = *reinterpret_cast<const float2*>(sw(box, r, cb));
  return pack2(v.x, v.y);
}

// The A fragments of the four k16 chunks of 64 bf16 columns (one box):
// thread rows r0, r0 + 8, columns 16 kk + 2 q (+ 1, + 8, + 9). Element (j,
// hr, e) of the accumulator layout (row r0 + 8 hr, column 8 j + 2 q + e) is
// half e of word 2 j + hr: the A fragment of k-chunk c is words [4 c, 4 c + 4).
__device__ __forceinline__ void frags_bf16(uint32_t (&a)[16], const uint8_t* box, int r0, int q) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int cb = 32 * kk + 4 * q;
    a[4 * kk + 0] = ld_b2(box, r0, cb);
    a[4 * kk + 1] = ld_b2(box, r0 + 8, cb);
    a[4 * kk + 2] = ld_b2(box, r0, cb + 16);
    a[4 * kk + 3] = ld_b2(box, r0 + 8, cb + 16);
  }
}

// The same for 64 float32 columns in two 32-column boxes, rounded to bf16.
__device__ __forceinline__ void frags_f32(uint32_t (&a)[16], const uint8_t* boxes, int r0, int q) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint8_t* box = boxes + (kk / 2) * kBox;
    const int cb = 64 * (kk % 2) + 8 * q;
    a[4 * kk + 0] = ld_f2(box, r0, cb);
    a[4 * kk + 1] = ld_f2(box, r0 + 8, cb);
    a[4 * kk + 2] = ld_f2(box, r0, cb + 32);
    a[4 * kk + 3] = ld_f2(box, r0 + 8, cb + 32);
  }
}

// acc (+)= A [64, 16 KC] (registers) x W [16 KC, 128], W the stage's weight
// tiles read MN-major (the forward's direction); `during` runs while the
// wgmma are in flight (it may read, not write, a)
template <int KC, typename During>
__device__ __forceinline__ void mma_fwd(float (&acc)[64], uint32_t (&a)[4 * KC],
                                        const uint8_t* w, bool accumulate, During during) {
  using namespace njf_hopper;
  const uint64_t db = desc_sw128_mn(w, KC * 16 * 128);
  fence_acc(acc);
  fence_regs(a);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < KC; ++c)
    wgmma_m64n128_rs(acc, a[4 * c], a[4 * c + 1], a[4 * c + 2], a[4 * c + 3], db + 128 * c,
                     (accumulate || c > 0) ? 1 : 0);
  wgmma_commit();
  during();
  wgmma_wait<0>();
  fence_acc(acc);
  fence_regs(a);
}

// acc = A [64, 16 KC] (registers) x W^T: the stage's weight tiles (rows =
// the layer's inputs, N of them; columns = its outputs, the contraction, in
// 64-column halves `half` bytes apart) read K-major. A k16 step moves 32
// bytes inside the swizzle atom; k 64 starts the second half. `during`
// runs while the wgmma are in flight (it may read, not write, a).
template <int KC, int N, typename During>
__device__ __forceinline__ void mma_t(float (&acc)[N / 2], uint32_t (&a)[4 * KC], const uint8_t* w,
                                      int half, bool accumulate, During during) {
  using namespace njf_hopper;
  const uint64_t db = desc_sw128(w);
  fence_acc(acc);
  fence_regs(a);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    const uint64_t dc = db + (((c / 4) * half + 32 * (c % 4)) >> 4);
    const int scale = (accumulate || c > 0) ? 1 : 0;
    if constexpr (N == 128)
      wgmma_m64n128_rs<0>(acc, a[4 * c], a[4 * c + 1], a[4 * c + 2], a[4 * c + 3], dc, scale);
    else
      wgmma_m64n64_rs<0>(acc, a[4 * c], a[4 * c + 1], a[4 * c + 2], a[4 * c + 3], dc, scale);
  }
  wgmma_commit();
  during();
  wgmma_wait<0>();
  fence_acc(acc);
  fence_regs(a);
}

// 4 x 4 transpose of 32-bit words among the 4 lanes of a row group (lane q
// = lane & 3): lane q gives v[c] and gets back lane c's v[q], in two
// exchanges with the lanes q ^ 1 and q ^ 2.
__device__ __forceinline__ void transpose4(uint32_t (&v)[4], int q) {
#pragma unroll
  for (int bit = 1; bit <= 2; bit <<= 1) {
    const bool hi = q & bit;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int lo = bit == 1 ? 2 * k : k;  // the position with the bit clear
      const uint32_t got = __shfl_xor_sync(0xffffffffu, hi ? v[lo] : v[lo + bit], bit);
      if (hi)
        v[lo] = got;
      else
        v[lo + bit] = got;
    }
  }
}

// The thread's 2 NJ words (accumulator layout: word 2 j + hr holds row
// row0 + 8 hr, columns 8 j + 2 q, + 1) stored to a row-major bf16 [n, ld
// words] array at word column c0, rows past n skipped. The four lanes of a
// row group trade words so that each writes 16 contiguous bytes: a warp's
// store covers 64 contiguous bytes of 8 rows, not 16.
template <int NJ>
__device__ __forceinline__ void store_rows(uint32_t* base, int ld, int c0,
                                           const uint32_t (&v)[2 * NJ], int row0, int n, int q) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
#pragma unroll
    for (int t = 0; t < NJ / 4; ++t) {
      uint32_t w[4] = {v[8 * t + hr], v[8 * t + 2 + hr], v[8 * t + 4 + hr], v[8 * t + 6 + hr]};
      transpose4(w, q);  // w[c]: columns 8 (4 t + q) + 2 c, + 1
      if (row < n)
        *reinterpret_cast<uint4*>(base + static_cast<size_t>(row) * ld + c0 + 4 * (4 * t + q)) =
            make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  __syncwarp();  // projection mode's dz reads dt back across the warp's lanes
}

// The thread's 32 words (accumulator layout) of a row-major [n, ld words]
// bf16 array at word column c0; zero for rows past n.
__device__ __forceinline__ void load_words(uint32_t (&v)[32], const uint32_t* base, int ld, int c0,
                                           int row0, int n, int q) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    const uint32_t* p = base + static_cast<size_t>(row < n ? row : 0) * ld + c0 + q;
#pragma unroll
    for (int j = 0; j < 16; ++j) v[2 * j + hr] = row < n ? p[4 * j] : 0u;
  }
}

// The ReLU masks of the chain: bit e (word e / 32) set where element e of
// the thread's accumulator layout is > 0, from its relu value packed as
// bf16x2 (relu gives +0 or -0 where the value is not > 0).
__device__ __forceinline__ void mask_bits(const uint32_t (&v)[32], uint32_t& lo, uint32_t& hi) {
  lo = hi = 0u;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const uint32_t b = ((v[k] & 0x7fffu) != 0u) | (((v[k] >> 16) & 0x7fffu) != 0u) << 1;
    if (k < 16)
      lo |= b << (2 * k);
    else
      hi |= b << (2 * (k - 16));
  }
}

// acc[e] where mask bit e is set, else 0
__device__ __forceinline__ void apply_mask(float (&acc)[64], uint32_t lo, uint32_t hi) {
#pragma unroll
  for (int e = 0; e < 64; ++e)
    if (!(((e < 32 ? lo : hi) >> (e & 31)) & 1u)) acc[e] = 0.f;
}

// o[k] = this lane's half of v plus the partner lane's (lane ^ m) other half
template <int H>
__device__ __forceinline__ void halve(const float (&v)[2 * H], float (&o)[H], bool hi, int m) {
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = hi ? v[k] : v[k + H];
    const float keep = hi ? v[k + H] : v[k];
    o[k] = keep + __shfl_xor_sync(0xffffffffu, send, m);
  }
}

// dst[col] += the column sums over the consumer's 64 points of the 8 NJ
// columns held in the accumulator layout (get(j, hr, e)), in a fixed order:
// the thread's two rows, then a butterfly over the 8 lanes of equal q that
// leaves each lane 2 NJ / 8 of the columns, then the four warps' sums through
// `stage`, added by the thread that owns the column. One named barrier per
// call: the caller alternates two stages.
template <int NJ, typename Get>
__device__ __forceinline__ void col_sums(Get get, float* stage, float* dst, int bar_id) {
  constexpr int V = 2 * NJ;
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int q = lane & 3;
  float o1[V / 2], o2[V / 4], o3[V / 8];
  // column c = 2 j + e: rows r0 and r0 + 8 summed, the first halving fused
  auto col = [&](int c) { return get(c >> 1, 0, c & 1) + get(c >> 1, 1, c & 1); };
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
    stage[warp * 128 + 8 * (c >> 1) + 2 * q + (c & 1)] = o3[k];
  }
  njf_hopper::named_bar(bar_id, 128);
  const int t = threadIdx.x & 127;
  if (t < 8 * NJ) dst[t] += ((stage[t] + stage[128 + t]) + stage[256 + t]) + stage[384 + t];
}

struct ChainArgs {
  const float* bias;  // the forward packing's biases
  uint32_t* scratch;  // [n, n_slots * 128] bf16, as words
  uint32_t* dt;       // [n, n_lin_z * 128] bf16 (dtz, or projection mode's dt)
  float* dbpart;      // [gridDim.x * 2, db_floats]: each consumer's sums
  void* dz[3];        // projection mode: dz_l [n, width_l] in the level's dtype
  int n, n_blocks, n_lin_z, n_tiles, n_slots;
  int n_levels, f32_mask, d_lat;
  int width[3];
};

// The producer: one thread walks the consumers' steps and keeps the ring
// full. Per tile: the forward recompute (as field_mlp.cu: W_in + x_pe; per
// block [the projection's K-chunks], W0 [+ tz slice], W1), then lin_out's
// backward (W_out's 64 columns + g), per block from the last W1, W0, and in
// projection mode dz's steps (per 64 latent rows and slice, W_z's rows).
template <bool kProj>
__device__ void produce(const CUtensorMap* mw, const CUtensorMap* mx, const CUtensorMap* mz0,
                        const CUtensorMap* mz1, const CUtensorMap* mz2, const CUtensorMap* mg,
                        const ChainArgs& a, uint8_t* smem, uint64_t* full, uint64_t* empty) {
  using namespace njf_hopper;
  uint32_t it = 0;
  uint8_t* st = nullptr;
  uint64_t* bar = nullptr;
  auto begin = [&](uint32_t bytes) {
    const int s = it % kStages;
    if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
    st = smem + s * kStageBytes;
    bar = &full[s];
    mbar_expect_tx(bar, bytes);
    ++it;
  };
  // [rows, 64 x halves] of the weights from row0: columns 0-63, then 64-127
  // rows * 128 bytes on
  auto weights = [&](int row0, int rows, int halves) {
    for (int h = 0; h < halves; ++h)
      for (int rc = 0; rc < rows / 64; ++rc)
        tma_load_2d(st + h * rows * 128 + rc * kBox, mw, bar, 64 * h, row0 + 64 * rc);
  };
  const int w_out = w_out_row(a.n_blocks);
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int p0 = tile * kTile;
    begin(2 * kBox + kConsumers * kBox);
    weights(0, kInRows, 2);
    for (int c = 0; c < kConsumers; ++c)
      tma_load_2d(st + kWBytes + c * kInBytes, mx, bar, 0, p0 + c * kPts);
    for (int blk = 0; blk < a.n_blocks; ++blk) {
      const bool inject = blk < a.n_lin_z;
      if constexpr (kProj) {
        if (inject) {
          int off = 0;
          for (int l = 0; l < a.n_levels; ++l) {
            const bool f32 = (a.f32_mask >> l) & 1;
            const CUtensorMap* mz = l == 0 ? mz0 : (l == 1 ? mz1 : mz2);
            for (int c0 = 0; c0 < a.width[l]; c0 += 64) {
              begin(2 * kBox + kConsumers * (f32 ? 2 : 1) * kBox);
              weights(w_out + kDH + blk * a.d_lat + off + c0, 64, 2);
              for (int c = 0; c < kConsumers; ++c) {
                uint8_t* in = st + kWBytes + c * kInBytes;
                tma_load_2d(in, mz, bar, c0, p0 + c * kPts);
                if (f32) tma_load_2d(in + kBox, mz, bar, c0 + 32, p0 + c * kPts);
              }
            }
            off += a.width[l];
          }
        }
      }
      const bool tz = !kProj && inject;
      begin(kWBytes + (tz ? kConsumers * 2 * kBox : 0));
      weights(kInRows + 2 * kDH * blk, kDH, 2);
      if (tz)
        for (int c = 0; c < kConsumers; ++c)
          for (int h = 0; h < 2; ++h)
            tma_load_2d(st + kWBytes + c * kInBytes + h * kBox, mz0, bar, blk * kDH + 64 * h,
                        p0 + c * kPts);
      begin(kWBytes);
      weights(kInRows + 2 * kDH * blk + kDH, kDH, 2);
    }
    begin(2 * kBox + kConsumers * kBox);
    weights(w_out, kDH, 1);
    for (int c = 0; c < kConsumers; ++c)
      tma_load_2d(st + kWBytes + c * kInBytes, mg, bar, 0, p0 + c * kPts);
    for (int blk = a.n_blocks - 1; blk >= 0; --blk) {
      begin(kWBytes);
      weights(kInRows + 2 * kDH * blk + kDH, kDH, 2);
      begin(kWBytes);
      weights(kInRows + 2 * kDH * blk, kDH, 2);
    }
    if constexpr (kProj) {
      if (a.n_lin_z > 0) {
        int off = 0;
        for (int l = 0; l < a.n_levels; ++l) {
          for (int c0 = 0; c0 < a.width[l]; c0 += 64)
            for (int i = 0; i < a.n_lin_z; ++i) {
              begin(2 * kBox);
              weights(w_out + kDH + i * a.d_lat + off + c0, 64, 2);
            }
          off += a.width[l];
        }
      }
    }
  }
}

template <bool kProj>
__device__ void consume(const ChainArgs& a, const uint8_t* smem, const float* bias, float* db_all,
                        float* stage_all, uint64_t* full, uint64_t* empty) {
  using namespace njf_hopper;
  const int cw = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) & 3;
  const int lane = threadIdx.x & 31;
  const int t = threadIdx.x & 127;
  const int q = lane & 3;
  const int r0 = 16 * warp + (lane >> 2);  // rows r0 and r0 + 8 of the 64
  const int nb = a.n_blocks, nlz = a.n_lin_z;
  const int ldw = a.n_slots * 64, ldt = nlz * 64;  // words per row
  const int bar_id = 1 + cw;
  const int n_db = db_floats(nb);
  float* db = db_all + cw * n_db;
  float* stages = stage_all + cw * 2 * kStageFloats;
  int sbuf = 0;
  auto stage = [&]() {
    float* s = stages + sbuf * kStageFloats;
    sbuf ^= 1;
    return s;
  };
  for (int e = t; e < n_db; e += 128) db[e] = 0.f;  // thread t owns the columns = t mod 128

  uint32_t it = 0;
  const uint8_t* st = nullptr;
  auto acquire = [&]() {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    st = smem + s * kStageBytes;
  };
  auto release = [&]() {
    if (lane == 0) mbar_arrive(&empty[it % kStages]);
    ++it;
  };
  const float* b_z = bias + kDH;
  const float* b_blk = bias + kDH * (1 + nlz);

  float acc[64];
  uint32_t x[32], av[32];  // x and the next A operand, bf16x2, accumulator layout

  // x = bf16(x + bf16(t + b)), av = relu(x), t from tz (bf16 pairs) or acc
  auto inject = [&](const float* b, const uint8_t* tz) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(b + 8 * j + 2 * q);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float2 tv;
        if (tz != nullptr)
          tv = unpack2(ld_b2(tz + (j / 8) * kBox, r0 + 8 * hr, 16 * (j % 8) + 4 * q));
        else
          tv = make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
        const float2 xv = unpack2(x[2 * j + hr]);
        const float v0 = bfr(xv.x + bfr(tv.x + bb.x)), v1 = bfr(xv.y + bfr(tv.y + bb.y));
        x[2 * j + hr] = pack2(v0, v1);
        av[2 * j + hr] = pack2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      }
    }
  };
  auto nothing = []() {};

  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int p0 = tile * kTile + cw * kPts;
    const int prow = p0 + r0;  // the thread's first row
    // The ReLU masks [x_i > 0] and [net_i > 0] of each block, 64 bits each,
    // a stack in registers: block i's four words pushed in the forward, popped
    // in the backward (last block first); constant indices only.
    uint32_t masks[4 * kMaskBlocks] = {};
    auto push = [&](uint32_t x_lo, uint32_t x_hi, uint32_t n_lo, uint32_t n_hi) {
#pragma unroll
      for (int k = 4 * kMaskBlocks - 1; k >= 4; --k) masks[k] = masks[k - 4];
      masks[0] = x_lo;
      masks[1] = x_hi;
      masks[2] = n_lo;
      masks[3] = n_hi;
    };
    auto pop = [&]() {
#pragma unroll
      for (int k = 0; k < 4 * kMaskBlocks - 4; ++k) masks[k] = masks[k + 4];
    };
    // ---- the forward recompute, writing relu(x_i), relu(net_i), relu(x_L)
    {
      uint32_t f[16];
      acquire();
      frags_bf16(f, st + kWBytes + cw * kInBytes, r0, q);
      mma_fwd<4>(acc, f, st, false, nothing);
      release();
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * q);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float v0 = bfr(acc[4 * j + 2 * hr] + bb.x);
          const float v1 = bfr(acc[4 * j + 2 * hr + 1] + bb.y);
          x[2 * j + hr] = pack2(v0, v1);
          av[2 * j + hr] = pack2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        }
      }
    }
    for (int blk = 0; blk < nb; ++blk) {
      const bool inj = blk < nlz;
      if constexpr (kProj) {
        if (inj) {  // t = sum over the latent's 64-column chunks, in order
          bool first = true;
          for (int l = 0; l < a.n_levels; ++l) {
            const bool f32 = (a.f32_mask >> l) & 1;
            for (int c0 = 0; c0 < a.width[l]; c0 += 64) {
              uint32_t f[16];
              acquire();
              if (f32)
                frags_f32(f, st + kWBytes + cw * kInBytes, r0, q);
              else
                frags_bf16(f, st + kWBytes + cw * kInBytes, r0, q);
              mma_fwd<4>(acc, f, st, !first, nothing);
              release();
              first = false;
            }
          }
          inject(b_z + blk * kDH, nullptr);
        }
      }
      // net = bf16(relu(x) @ W0 + b0); av = relu(net)
      uint32_t x_lo, x_hi, n_lo, n_hi;
      acquire();
      if (!kProj && inj) inject(b_z + blk * kDH, st + kWBytes + cw * kInBytes);
      mask_bits(av, x_lo, x_hi);
      mma_fwd<8>(acc, av, st, false, [&]() {  // relu(x_i)
        store_rows<16>(a.scratch, ldw, blk * 64, av, prow, a.n, q);
      });
      release();
      const float* b0 = b_blk + 2 * kDH * blk;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(b0 + 8 * j + 2 * q);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          av[2 * j + hr] = pack2(fmaxf(bfr(acc[4 * j + 2 * hr] + bb.x), 0.f),
                                 fmaxf(bfr(acc[4 * j + 2 * hr + 1] + bb.y), 0.f));
      }
      mask_bits(av, n_lo, n_hi);
      push(x_lo, x_hi, n_lo, n_hi);
      // x = bf16(x + bf16(relu(net) @ W1 + b1)); av = relu(x)
      acquire();
      mma_fwd<8>(acc, av, st, false, [&]() {  // relu(net_i)
        store_rows<16>(a.scratch, ldw, slot_an(nb, blk) * 64, av, prow, a.n, q);
      });
      release();
      const float* b1 = b0 + kDH;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(b1 + 8 * j + 2 * q);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float2 xv = unpack2(x[2 * j + hr]);
          const float v0 = bfr(xv.x + bfr(acc[4 * j + 2 * hr] + bb.x));
          const float v1 = bfr(xv.y + bfr(acc[4 * j + 2 * hr + 1] + bb.y));
          x[2 * j + hr] = pack2(v0, v1);
          av[2 * j + hr] = pack2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        }
      }
    }

    // ---- lin_out: db_out = sum g; dx = (g W_out^T) * [x_L > 0]
    float dx[64];
    {
      uint32_t gf[16], l_lo, l_hi;
      acquire();
      frags_bf16(gf, st + kWBytes + cw * kInBytes, r0, q);
      col_sums<8>(
          [&](int j, int hr, int e) {
            const float2 v = unpack2(gf[2 * j + hr]);
            return e ? v.y : v.x;
          },
          stage(), db + kDH * (1 + 2 * nb), bar_id);
      mask_bits(av, l_lo, l_hi);
      mma_t<4, 128>(acc, gf, st, kHalf, false, [&]() {  // relu(x_L)
        store_rows<16>(a.scratch, ldw, nb * 64, av, prow, a.n, q);
      });
      release();
      apply_mask(acc, l_lo, l_hi);
#pragma unroll
      for (int e = 0; e < 64; ++e) dx[e] = acc[e];
    }

    // ---- the residual blocks, last to first. The gradient entering block
    // blk's backward is dt_{blk + 1} while that block is injected; it goes to
    // dt there, else to its scratch slot.
    for (int blk = nb - 1; blk >= 0; --blk) {
      uint32_t g[32];
      float* db0 = db + kDH * (1 + 2 * blk);
      const uint32_t x_lo = masks[0], x_hi = masks[1], n_lo = masks[2], n_hi = masks[3];
      pop();
#pragma unroll
      for (int k = 0; k < 32; ++k) g[k] = pack2(dx[2 * k], dx[2 * k + 1]);
      // dnet = (bf16(dx) W1^T) * [net > 0]; while the wgmma run, bf16(dx) is
      // stored and db1 = sum dx taken
      acquire();
      mma_t<8, 128>(acc, g, st, kHalf, false, [&]() {
        if (blk + 1 < nlz)
          store_rows<16>(a.dt, ldt, (blk + 1) * 64, g, prow, a.n, q);
        else
          store_rows<16>(a.scratch, ldw, slot_dxe(nb, nlz, blk) * 64, g, prow, a.n, q);
        col_sums<16>([&](int j, int hr, int e) { return dx[4 * j + 2 * hr + e]; }, stage(),
                     db0 + kDH, bar_id);
      });
      release();
      apply_mask(acc, n_lo, n_hi);
      col_sums<16>([&](int j, int hr, int e) { return acc[4 * j + 2 * hr + e]; }, stage(), db0,
                   bar_id);  // db0
#pragma unroll
      for (int k = 0; k < 32; ++k) g[k] = pack2(acc[2 * k], acc[2 * k + 1]);
      // dx += (bf16(dnet) W0^T) * [x_i > 0]
      acquire();
      mma_t<8, 128>(acc, g, st, kHalf, false, [&]() {
        store_rows<16>(a.scratch, ldw, slot_dnet(nb, blk) * 64, g, prow, a.n, q);
      });
      release();
#pragma unroll
      for (int e = 0; e < 64; ++e)
        if (((e < 32 ? x_lo : x_hi) >> (e & 31)) & 1u) dx[e] += acc[e];
    }
    // ---- lin_in's gradient: dt_0 (or, without injection, its slot); db_in
    {
      uint32_t g[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) g[k] = pack2(dx[2 * k], dx[2 * k + 1]);
      if (nlz > 0)
        store_rows<16>(a.dt, ldt, 0, g, prow, a.n, q);
      else
        store_rows<16>(a.scratch, ldw, slot_dxe(nb, 0, nb) * 64, g, prow, a.n, q);
      col_sums<16>([&](int j, int hr, int e) { return dx[4 * j + 2 * hr + e]; }, stage(), db,
                   bar_id);
    }

    // ---- projection mode: dz_l = bf16(dt) W_z[rows of level l]^T, per 64
    // latent columns, the slices summed in order in float32
    if constexpr (kProj) {
      if (nlz > 0) {
        for (int l = 0; l < a.n_levels; ++l) {
          const bool f32 = (a.f32_mask >> l) & 1;
          const int wl = a.width[l];
          for (int c0 = 0; c0 < wl; c0 += 64) {
            float o[32];
            for (int i = 0; i < nlz; ++i) {
              uint32_t g[32];
              load_words(g, a.dt, ldt, i * 64, prow, a.n, q);
              acquire();
              mma_t<8, 64>(o, g, st, kBox, i > 0, nothing);
              release();
            }
            if (f32) {  // 32 contiguous bytes per row group and column block
#pragma unroll
              for (int hr = 0; hr < 2; ++hr) {
                const int row = prow + 8 * hr;
                if (row >= a.n) continue;
                float* dst =
                    static_cast<float*>(a.dz[l]) + static_cast<size_t>(row) * wl + c0 + 2 * q;
#pragma unroll
                for (int j = 0; j < 8; ++j)
                  *reinterpret_cast<float2*>(dst + 8 * j) =
                      make_float2(o[4 * j + 2 * hr], o[4 * j + 2 * hr + 1]);
              }
            } else {
              uint32_t w[16];
#pragma unroll
              for (int k = 0; k < 16; ++k) w[k] = pack2(o[2 * k], o[2 * k + 1]);
              store_rows<8>(static_cast<uint32_t*>(a.dz[l]), wl / 2, c0 / 2, w, prow, a.n, q);
            }
          }
        }
      }
    }
  }
  // each consumer's bias-gradient sums, written by the threads that own them
  float* out = a.dbpart + (static_cast<size_t>(blockIdx.x) * kConsumers + cw) * n_db;
  for (int e = t; e < n_db; e += 128) out[e] = db[e];
}

template <bool kProj>
__global__ void __launch_bounds__(kThreads, 1)
    field_mlp_bwd_chain_kernel(const __grid_constant__ CUtensorMap mw,
                               const __grid_constant__ CUtensorMap mx,
                               const __grid_constant__ CUtensorMap mz0,
                               const __grid_constant__ CUtensorMap mz1,
                               const __grid_constant__ CUtensorMap mz2,
                               const __grid_constant__ CUtensorMap mg,
                               const __grid_constant__ ChainArgs a) {
  using namespace njf_hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* bias = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  const int nbias = fwd_bias_floats(a.n_blocks, a.n_lin_z);
  float* db = bias + nbias;
  float* stages = db + kConsumers * db_floats(a.n_blocks);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kConsumers * 2 * kStageFloats);
  uint64_t* empty = full + kStages;
  for (int i = threadIdx.x; i < nbias; i += kThreads) bias[i] = a.bias[i];
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0)
      produce<kProj>(&mw, &mx, &mz0, &mz1, &mz2, &mg, a, smem, full, empty);
  } else {
    setmaxnreg_inc<232>();
    consume<kProj>(a, smem, bias, db, stages, full, empty);
  }
}

// One job of the weight-gradient pass: dW [64 a_halves, 64 g_halves] = A^T G
// over points, A = 64 a_halves columns of map a_map from column a_col, G the
// same of map g_map; written at `out` (floats) of each split's partial,
// row-major.
struct Job {
  int a_map, a_col, a_halves, g_map, g_col, g_halves, out, pad;
};

// The pass's maps: 0 the scratch, 1 dt, 2 x_pe (padded), 3 g (padded), 4-6
// the latent levels in bf16 (projection mode).
constexpr int kDwMaps = 7;

struct DwParams {
  CUtensorMap maps[kDwMaps];
  Job jobs[kMaxJobs];
};

// Consumer cw (< a_halves) of a job: acc[h] = rows 64 cw .. + 64 of dW,
// columns 64 h .. + 64, over the block's tiles of 64 points; A read MN-major
// (the transpose bit: the 64 points are the contraction), G likewise. A
// tile's four k16 steps move 2,048 bytes each; one wgmma group stays in
// flight while the next tile is waited for.
template <int NH>
__device__ void dw_consume(const uint8_t* smem, uint64_t* full, uint64_t* empty, int steps,
                           float* out, int ld) {
  using namespace njf_hopper;
  const int cw = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  float acc[NH][32];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  for (int k = 0; k < steps; ++k) {
    const int s = k % kDwStages;
    mbar_wait(&full[s], (k / kDwStages) & 1);
    const uint8_t* st = smem + s * kDwStageBytes;
    const uint64_t da = desc_sw128(st + cw * kBox);
#pragma unroll
    for (int h = 0; h < NH; ++h) fence_acc(acc[h]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < NH; ++h)
        wgmma_m64n64<1, 1>(acc[h], da + 128 * kk, desc_sw128(st + (2 + h) * kBox) + 128 * kk);
    wgmma_commit();
#pragma unroll
    for (int h = 0; h < NH; ++h) fence_acc(acc[h]);
    wgmma_wait<1>();
#pragma unroll
    for (int h = 0; h < NH; ++h) fence_acc(acc[h]);
    if (k > 0 && lane == 0) mbar_arrive(&empty[(k - 1) % kDwStages]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < NH; ++h) fence_acc(acc[h]);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float* row = out + static_cast<size_t>(64 * cw + 16 * warp + (lane >> 2) + 8 * hr) * ld;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(row + 64 * h + 8 * j + 2 * (lane & 3)) =
            make_float2(acc[h][4 * j + 2 * hr], acc[h][4 * j + 2 * hr + 1]);
  }
}

// Grid: jobs x splits. Block (job, s) sums its job's dW over the 64-point
// tiles [s per, min((s + 1) per, n_tiles)) into part[s] (float32 [splits,
// w_total]); no two blocks write the same float.
__global__ void __launch_bounds__(kThreads, 1)
    field_mlp_dw_kernel(const __grid_constant__ DwParams p, float* part, int w_total,
                        int n_tiles, int splits, int per) {
  using namespace njf_hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kDwStages * kDwStageBytes);
  uint64_t* empty = full + kDwStages;
  const Job jb = p.jobs[blockIdx.x / splits];
  const int s = blockIdx.x % splits;
  const int t0 = s * per;
  const int steps = max(0, min(n_tiles, t0 + per) - t0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kDwStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * jb.a_halves);  // lane 0 of each active consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    const uint32_t bytes = (jb.a_halves + jb.g_halves) * kBox;
    for (int k = 0; k < steps; ++k) {
      const int i = k % kDwStages;
      if (k >= kDwStages) mbar_wait(&empty[i], ((k / kDwStages) - 1) & 1);
      uint8_t* st = smem + i * kDwStageBytes;
      const int row = (t0 + k) * 64;
      mbar_expect_tx(&full[i], bytes);
      for (int h = 0; h < jb.a_halves; ++h)
        tma_load_2d(st + h * kBox, &p.maps[jb.a_map], &full[i], jb.a_col + 64 * h, row);
      for (int h = 0; h < jb.g_halves; ++h)
        tma_load_2d(st + (2 + h) * kBox, &p.maps[jb.g_map], &full[i], jb.g_col + 64 * h, row);
    }
    return;
  }
  setmaxnreg_inc<232>();
  if (threadIdx.x / 128 - 1 >= jb.a_halves) return;
  float* out = part + static_cast<size_t>(s) * w_total + jb.out;
  if (jb.g_halves == 2)
    dw_consume<2>(smem, full, empty, steps, out, 128);
  else
    dw_consume<1>(smem, full, empty, steps, out, 64);
}

// out[e] (+)= sum over s, in order, of wpart[s][e] (e < w_total), then of
// bpart[b][e - w_total]; `first` starts the sums, later chunks add to them.
__global__ void reduce_bwd_kernel(const float* __restrict__ wpart, int splits, int w_total,
                                  const float* __restrict__ bpart, int n_bpart, int b_total,
                                  float* __restrict__ out, int first) {
  const int total = w_total + b_total;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += gridDim.x * blockDim.x) {
    float s = 0.f;
    if (e < w_total) {
      for (int i = 0; i < splits; ++i) s += wpart[static_cast<size_t>(i) * w_total + e];
    } else {
      for (int i = 0; i < n_bpart; ++i) s += bpart[static_cast<size_t>(i) * b_total + e - w_total];
    }
    out[e] = first ? s : out[e] + s;
  }
}

// [rows, cols] row-major (bf16, or float32) as a map with boxes of 64 rows
// and 128 bytes
bool encode_rows(CUtensorMap* map, const void* base, long long rows, int cols, bool f32) {
  const uint64_t es = f32 ? 4 : 2;
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {es * cols};
  const uint32_t box[2] = {static_cast<uint32_t>(128 / es), 64u};
  return njf_hopper::encode_map(map, base, 2, dims, strides, box,
                                f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
}

template <typename K>
int allow_smem(K kernel, bool& done) {  // once per kernel
  if (done) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  done = err == cudaSuccess;
  return static_cast<int>(err);
}

const char* at(const void* p, long long bytes) { return static_cast<const char*>(p) + bytes; }

// Both passes and the ordered sums over the points [0, n), chunk by chunk.
int run(bool proj, const void* const lat[3], const void* const zb[3], void* const dz[3],
        const int widths[3], int n_levels, int f32_mask, const void* x, const void* g,
        const void* w, const void* b, void* scratch, void* dt, const Job* jobs, int n_jobs,
        int w_total, float* wpart, float* bpart, float* out, int n, int nb, int nlz, int chunk,
        int grid, int smem, int splits, int dw_smem, cudaStream_t stream) {
  const int d_lat = proj ? widths[0] + widths[1] + widths[2] : 0;
  if (n <= 0 || nb < 0 || nb > kMaskBlocks || nlz < 0 || nlz > nb || chunk <= 0 || chunk % kTile ||
      grid <= 0 ||
      splits <= 0 || n_jobs <= 0 || n_jobs > kMaxJobs ||
      static_cast<size_t>(smem) != chain_smem_bytes(nb, nlz) || smem > kSmemMax ||
      static_cast<size_t>(dw_smem) != dw_smem_bytes())
    return static_cast<int>(cudaErrorInvalidValue);
  for (int j = 0; j < n_jobs; ++j) {
    const Job& jb = jobs[j];
    if (jb.a_halves < 1 || jb.a_halves > 2 || jb.g_halves < 1 || jb.g_halves > 2 || jb.a_map < 0 ||
        jb.a_map >= kDwMaps || jb.g_map < 0 || jb.g_map >= kDwMaps || jb.out < 0 ||
        jb.out + 64 * jb.a_halves * 64 * jb.g_halves > w_total)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool chain_attr[2] = {false, false}, dw_attr = false;
  int err = proj ? allow_smem(field_mlp_bwd_chain_kernel<true>, chain_attr[1])
                 : allow_smem(field_mlp_bwd_chain_kernel<false>, chain_attr[0]);
  if (err == 0) err = allow_smem(field_mlp_dw_kernel, dw_attr);
  if (err != 0) return err;
  const int slots = n_slots(nb, nlz);
  const long long w_rows = kInRows + 2LL * kDH * nb + kDH + static_cast<long long>(nlz) * d_lat;
  const int db_total = db_floats(nb);
  DwParams p;
  for (int j = 0; j < n_jobs; ++j) p.jobs[j] = jobs[j];
  CUtensorMap mw, mx, mg, mz[3];
  if (!encode_rows(&mw, w, w_rows, kDH, false)) return static_cast<int>(cudaErrorInvalidValue);
  for (int c0 = 0; c0 < n; c0 += chunk) {
    const int nc = min(chunk, n - c0);
    const int tiles = (nc + kTile - 1) / kTile, tiles64 = (nc + 63) / 64;
    const int grid_c = min(grid, tiles), splits_c = min(splits, tiles64);
    const int per = (tiles64 + splits_c - 1) / splits_c;
    const long long c = c0;
    ChainArgs a = {};
    a.bias = static_cast<const float*>(b);
    a.scratch = static_cast<uint32_t*>(scratch);
    a.dt = nlz > 0 ? reinterpret_cast<uint32_t*>(const_cast<char*>(at(dt, c * nlz * kDH * 2)))
                   : nullptr;
    a.dbpart = bpart;
    a.n = nc;
    a.n_blocks = nb;
    a.n_lin_z = nlz;
    a.n_tiles = tiles;
    a.n_slots = slots;
    a.n_levels = proj ? n_levels : 0;
    a.f32_mask = f32_mask;
    a.d_lat = d_lat;
    bool ok = encode_rows(&mx, at(x, c * kInRows * 2), nc, kInRows, false) &&
              encode_rows(&mg, at(g, c * kOutCols * 2), nc, kOutCols, false) &&
              encode_rows(&p.maps[0], scratch, nc, slots * kDH, false);
    p.maps[2] = mx;
    p.maps[3] = mg;
    if (nlz > 0)
      ok = ok && encode_rows(&p.maps[1], a.dt, nc, nlz * kDH, false);
    else
      p.maps[1] = p.maps[0];  // never read
    for (int l = 0; l < 3; ++l) {
      mz[l] = mx;  // never read where unset
      p.maps[4 + l] = mx;
    }
    if (proj) {
      for (int l = 0; l < n_levels; ++l) {
        const bool f32 = (f32_mask >> l) & 1;
        const long long row_bytes = static_cast<long long>(widths[l]) * (f32 ? 4 : 2);
        a.width[l] = widths[l];
        a.dz[l] = const_cast<char*>(at(dz[l], c * row_bytes));
        ok = ok && encode_rows(&mz[l], at(lat[l], c * row_bytes), nc, widths[l], f32) &&
             encode_rows(&p.maps[4 + l], at(zb[l], c * widths[l] * 2), nc, widths[l], false);
      }
    } else if (nlz > 0) {
      ok = ok && encode_rows(&mz[0], at(lat[0], c * nlz * kDH * 2), nc, nlz * kDH, false);
    }
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    if (proj)
      field_mlp_bwd_chain_kernel<true><<<grid_c, kThreads, smem, stream>>>(mw, mx, mz[0], mz[1],
                                                                           mz[2], mg, a);
    else
      field_mlp_bwd_chain_kernel<false><<<grid_c, kThreads, smem, stream>>>(mw, mx, mz[0], mz[1],
                                                                            mz[2], mg, a);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    field_mlp_dw_kernel<<<n_jobs * splits_c, kThreads, dw_smem, stream>>>(p, wpart, w_total,
                                                                        tiles64, splits_c, per);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    const int total = w_total + db_total;
    reduce_bwd_kernel<<<min((total + 255) / 256, 132 * 8), 256, 0, stream>>>(
        wpart, splits_c, w_total, bpart, kConsumers * grid_c, db_total, out, c0 == 0);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace wgb
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

// The wgmma path (K7-tz-bwd with proj 0, K7-bwd with proj 1), planned by
// field_mlp.bwd_plan. Inputs: x [n, 64] and g [n, 64] bf16 (x_pe and the
// upstream gradient, zero-padded), w / b the forward packing
// (field_mlp._pack_fwd); tz mode: lat[0] = tz [n, n_lin_z * 128] bf16;
// projection mode: the latent levels lat[l] [n, c_l] (bit l of f32_mask:
// float32, else bf16; c_l % 64 == 0), zb[l] the same in bf16 (lat[l] itself
// for a bf16 level), dz[l] [n, c_l] in the level's dtype (output). Scratch:
// [min(n, chunk), n_slots * 128] bf16; wpart [splits, w_total] and bpart
// [2 grid, db_floats] float32. dt [n, n_lin_z * 128] bf16 (output: dtz, or
// projection mode's dt). `jobs` (host memory, n_jobs x 8 ints) the weight
// gradients' table; out [w_total + db_floats] float32: every job's dW, then
// the bias gradients (the chain's layout).
extern "C" int njf_field_mlp_bwd_wg(int proj, const void* lat0, const void* lat1,
                                    const void* lat2, const void* zb0, const void* zb1,
                                    const void* zb2, void* dz0, void* dz1, void* dz2, int c0,
                                    int c1, int c2, int n_levels, int f32_mask, const void* x,
                                    const void* g, const void* w, const void* b, void* scratch,
                                    void* dt, const void* jobs, int n_jobs, int w_total,
                                    void* wpart, void* bpart, void* out, int n, int n_blocks,
                                    int n_lin_z, int chunk, int grid, int smem, int splits,
                                    int dw_smem, void* stream) {
  const void* const lat[3] = {lat0, lat1, lat2};
  const void* const zb[3] = {zb0, zb1, zb2};
  void* const dz[3] = {dz0, dz1, dz2};
  int widths[3] = {0, 0, 0};
  if (proj) {
    if (n_levels < 1 || n_levels > 3) return static_cast<int>(cudaErrorInvalidValue);
    const int cs[3] = {c0, c1, c2};
    for (int l = 0; l < n_levels; ++l) {
      if (cs[l] <= 0 || cs[l] % 64) return static_cast<int>(cudaErrorInvalidValue);
      widths[l] = cs[l];
    }
  }
  return wgb::run(proj != 0, lat, zb, dz, widths, n_levels, f32_mask, x, g, w, b, scratch, dt,
                  static_cast<const wgb::Job*>(jobs), n_jobs, w_total,
                  static_cast<float*>(wpart), static_cast<float*>(bpart),
                  static_cast<float*>(out), n, n_blocks, n_lin_z, chunk, grid, smem, splits,
                  dw_smem, static_cast<cudaStream_t>(stream));
}
