// K7-tz-bwd on Hopper: the backward of the ResnetFC trunk with a precomputed
// latent injection (tz mode), recomputing each tile's forward.
//
// Replaces neural_jacobian_field_tpu/ops/pallas/field_mlp_train.py::_k7tz_bwd
// (body _make_bwd_kernel(tz_mode=True)). Per point, with the forward of
// field_mlp_tz.cu recomputed (bf16 layer outputs, so the ReLU masks are the
// forward's):
//   dW_out += relu(x_L)^T g,  db_out += sum g,  dx = (g W_out^T) * [x_L > 0]
//   for block i, last to first:
//     dW1 += relu(net)^T bf16(dx),    db1 += sum dx
//     dnet = (bf16(dx) W1^T) * [net > 0]
//     dW0 += relu(x_i)^T bf16(dnet),  db0 += sum dnet
//     dx  += (bf16(dnet) W0^T) * [x_i > 0];  dtz[:, i] = dx, db_z[i] += sum dx
//   dW_in += x_pe^T bf16(dx),  db_in += sum dx
// g arrives in bf16; matmul operands are bf16 with float32 accumulation; dx,
// dnet and every dW/db stay float32; x gets no gradient (sample positions are
// gradient-stopped upstream), as in the TPU kernel. The ReLU masks are real
// comparisons (the TPU kernel's clip(v * 1e30, 0, 1) is a Mosaic workaround).
//
// What bounds it on the H100, and what the design does about it:
//  - Compute: a point costs ~1.1 MFLOP (the forward again, the net recompute,
//    the dx chain and the weight gradients: ~40 matmuls of [*, 128] x [128,
//    128]), bf16 WMMA 16x16x16 on the tensor cores.
//  - Shared memory: the TPU kernel holds the tile's activations and all 12
//    layers of float32 dW (~0.7 MB at d_hidden 128) in VMEM. A Hopper block
//    has 227 KB. Here a block of 4 warps owns a tile of 64 points; the
//    residual stream at each block's input (the only activation the backward
//    cannot cheaply recompute) goes to a global scratch, written by the
//    recompute and read back once (it mostly stays in the 50 MB L2); net is
//    recomputed from it. dx lives in registers (64 per thread at d_hidden
//    128). Shared memory holds one staged weight matrix (streamed layer by
//    layer, as in the forward) and three [64, d_hidden] bf16 operand tiles:
//    ~100 KB, two blocks per SM.
//  - The weight-gradient reduction over N points: blocks run in no order, so
//    each of the `grid` persistent blocks adds its tiles' A^T G products into
//    its own float32 copy of dW in global memory (WMMA accumulators loaded
//    from and stored back to it: a read-modify-write of ~0.7 MB per tile),
//    and each warp its column sums into its own copy of db; a second kernel
//    sums the copies in block order. No atomics: the result is the same from
//    run to run.
// wgmma, TMA and double-buffered weight staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "field_mlp_common.cuh"

using namespace nvcuda;
using njf_k7::bf;
using njf_k7::stage_matrix;

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 16;               // points per warp
constexpr int kTile = kWarps * kRows;   // points per block step

using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct BwdArgs {
  const __nv_bfloat16* tz;  // [N, n_lin_z * DH]
  const __nv_bfloat16* x;   // [N, d_in]
  const __nv_bfloat16* g;   // [N, d_out]
  const __nv_bfloat16* w;   // packed weights (field_mlp_common.cuh)
  const float* b;           // packed biases
  __nv_bfloat16* stash;     // [n_tiles * 64, n_blocks, DH] block inputs
  __nv_bfloat16* dtz;       // [N, n_lin_z * DH]
  float* wpart;             // [grid, w_total] per-block dW (zeroed)
  float* bpart;             // [grid * kWarps, b_total] per-warp db (zeroed)
  int n;
  int d_in;
  int k_in;
  int n_blocks;
  int n_lin_z;
  int d_out;
  int n_tiles;
  int w_total;
  int b_total;
};

// acc[j] = A[16, k] (row-major, lda) x B[k, 16 NJ]. B is row-major [k][ldb],
// or with kBt the transpose of a row-major [16 NJ][ldb] matrix.
template <int NJ, bool kBt>
__device__ __forceinline__ void warp_mm(FragAcc (&acc)[NJ], const __nv_bfloat16* a,
                                        int lda, const __nv_bfloat16* b, int ldb, int k) {
  using BLayout = typename std::conditional<kBt, wmma::col_major, wmma::row_major>::type;
#pragma unroll
  for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int kk = 0; kk < k; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + kk, lda);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> fb;
      if (kBt)
        wmma::load_matrix_sync(fb, b + (j * 16) * ldb + kk, ldb);
      else
        wmma::load_matrix_sync(fb, b + kk * ldb + j * 16, ldb);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

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

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  __align__(16) __nv_bfloat16 h[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) h[t] = __float2bfloat16(v[t]);
  return *reinterpret_cast<const uint4*>(h);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(dst) = pack8(v);
}

__device__ __forceinline__ float relu(float v) { return fmaxf(v, 0.f); }

template <int DH, int NO>
__global__ void __launch_bounds__(kWarps * 32, 2) field_mlp_tz_bwd_kernel(BwdArgs a) {
  constexpr int NJ = DH / 16;
  constexpr int kLd = DH + 8;          // operand tiles and staged weights
  constexpr int kNOut = NO * 16;
  constexpr int kLdOut = kNOut + 8;    // staged W_out
  extern __shared__ __align__(128) unsigned char smem[];

  const int ldx = a.k_in + 8;
  const int w_rows = a.k_in > DH ? a.k_in : DH;
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xpe = wbuf + (static_cast<size_t>(w_rows) * kLd * 2 + 127) / 128 * 64;
  __nv_bfloat16* opx = xpe + kTile * ldx;  // relu(block input), or x_L
  __nv_bfloat16* opa = opx + kTile * kLd;  // relu(net), or relu(x)
  __nv_bfloat16* opg = opa + kTile * kLd;  // bf16 gradients: g, dx, dnet
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
        if (a.n_lin_z > 0) {
          const float tzv = grow < a.n
              ? __bfloat162float(a.tz[static_cast<size_t>(grow) * tz_w + col + t]) : 0.f;
          v[t] = bf(v[t] + bf(tzv + a.b[DH + col + t]));
        }
        r[t] = relu(v[t]);
      }
      store8(opx + lr * kLd + col, v);
      store8(opa + lr * kLd + col, r);
      if (nb > 0) store8(a.stash + (static_cast<size_t>(grow) * nb) * DH + col, v);
      __syncwarp();
    }

    for (int blk = 0; blk < nb; ++blk) {
      const __nv_bfloat16* w0 = a.w + w_in_sz + 2 * blk * blk_w;
      const float* b0 = a.b + DH + tz_w + 2 * blk * DH;
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
      // x = bf16(x + bf16(relu(net) W1 + b1)) [+ the next injection]
      __syncthreads();
      stage_matrix(wbuf, w0 + blk_w, DH, DH, kLd);
      __syncthreads();
      warp_mm<NJ, false>(acc, opa + wr * kLd, kLd, wbuf, kLd, DH);
      __syncwarp();
      const bool inject = blk + 1 < a.n_lin_z;
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
          if (inject) {
            const int zc = (blk + 1) * DH + col + t;
            const float tzv = grow < a.n
                ? __bfloat162float(a.tz[static_cast<size_t>(grow) * tz_w + zc]) : 0.f;
            v[t] = bf(v[t] + bf(tzv + a.b[DH + zc]));
          }
          r[t] = relu(v[t]);
        }
        store8(opx + lr * kLd + col, v);
        store8(opa + lr * kLd + col, r);
        if (blk + 1 < nb)
          store8(a.stash + (static_cast<size_t>(grow) * nb + blk + 1) * DH + col, v);
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

size_t smem_bytes(int k_in, int dh) {
  const int w_rows = k_in > dh ? k_in : dh;
  const size_t wbuf = (static_cast<size_t>(w_rows) * (dh + 8) * 2 + 127) / 128 * 128;
  return wbuf + static_cast<size_t>(kTile) * (k_in + 8) * 2 +
         3 * static_cast<size_t>(kTile) * (dh + 8) * 2 + kWarps * 256 * sizeof(float);
}

template <int DH, int NO>
int launch(const BwdArgs& args, int grid, cudaStream_t s) {
  const size_t smem = smem_bytes(args.k_in, DH);
  cudaError_t err = cudaFuncSetAttribute(field_mlp_tz_bwd_kernel<DH, NO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  field_mlp_tz_bwd_kernel<DH, NO><<<grid, kWarps * 32, smem, s>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return 0;
}

template <int DH>
int launch_dh(const BwdArgs& args, int grid, cudaStream_t s) {
  if (args.d_out <= 16) return launch<DH, 1>(args, grid, s);
  if (args.d_out <= 32) return launch<DH, 2>(args, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Inputs as njf_field_mlp_tz_fwd, plus g [n, d_out] bf16. Scratch: stash
// [ceil(n/64)*64, n_blocks, dh] bf16; wpart [grid, w_total] and bpart
// [grid*4, b_total] float32, zeroed by the caller. Outputs: dtz [n, n_lin_z*dh]
// bf16; out [w_total + b_total] float32 = dW and db in the packed layouts
// (w_total = k_in*dh + 2*n_blocks*dh*dh + dh*n_out, b_total = dh*(1 +
// n_lin_z + 2*n_blocks) + n_out, n_out = 16*ceil(d_out/16)).
// 1 <= grid <= ceil(n/64).
extern "C" int njf_field_mlp_tz_bwd(const void* tz, const void* x, const void* g,
                                    const void* w, const void* b, void* stash, void* dtz,
                                    void* wpart, void* bpart, void* out, int n, int d_in,
                                    int dh, int n_blocks, int n_lin_z, int d_out, int grid,
                                    void* stream) {
  const int n_tiles = (n + kTile - 1) / kTile;
  if (n <= 0 || d_in <= 0 || d_in > 128 || d_out <= 0 || d_out > 32 || n_blocks < 0 ||
      n_lin_z < 0 || n_lin_z > n_blocks || grid <= 0 || grid > n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs args;
  args.tz = static_cast<const __nv_bfloat16*>(tz);
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
  args.n_tiles = n_tiles;
  const int n_out = (d_out + 15) / 16 * 16;
  args.w_total = args.k_in * dh + 2 * n_blocks * dh * dh + dh * n_out;
  args.b_total = dh * (1 + n_lin_z + 2 * n_blocks) + n_out;
  auto s = static_cast<cudaStream_t>(stream);
  int err;
  switch (dh) {
    case 32: err = launch_dh<32>(args, grid, s); break;
    case 64: err = launch_dh<64>(args, grid, s); break;
    case 128: err = launch_dh<128>(args, grid, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  const int total = args.w_total + args.b_total;
  int blocks = (total + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  reduce_partials_kernel<<<blocks, 256, 0, s>>>(args.wpart, args.bpart,
                                                static_cast<float*>(out), args.w_total,
                                                args.b_total, grid);
  return static_cast<int>(cudaGetLastError());
}
