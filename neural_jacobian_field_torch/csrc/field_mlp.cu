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
// output, so the chain has to keep the tensor cores fed. Two kernels:
//
// The wgmma path (DH 128, d_in <= 64, latent widths multiples of 64; the
// flagship's every shape): a persistent, warp-specialised kernel, one block
// per SM walking over tiles of 128 points.
//   - Warpgroup 0 is the producer: one thread issues TMA loads into a ring of
//     kStages 64 KB stages (full / empty mbarrier pairs; the ring's phase
//     runs on across tiles). A stage holds one step's weights (at most a
//     [128, 128] matrix, 32 KB) and each consumer's input tiles for that
//     step (16 KB each). Warpgroups 1 and 2 are the consumers; each owns 64
//     of the tile's points and runs the whole chain on them. The chain is
//     serial per point, so the two interleave: while one rounds its
//     accumulators (bias, bf16, relu), the other's wgmma runs.
//   - Activations stay in registers. A layer is wgmma.m64n128k16 with A from
//     registers: the f32 accumulator (64 per thread) goes through the
//     epilogue and is packed to bf16x2, and the accumulator fragment of the
//     n8 blocks 2c, 2c + 1 IS the A fragment of k-chunk c, so the packed
//     registers feed the next layer as they are. The residual x stays in
//     registers as bf16 (32 per thread). Shared memory holds only weights
//     and input tiles.
//   - Weights come from a forward-only packing (ops/kernels/field_mlp.py,
//     `_pack_fwd`): one [rows, 128] bf16 matrix of W_in (padded to 64
//     rows), W0 / W1 of each block, W_out (padded to 128 columns; the kernel
//     reads 64) and, in projection mode, the lin_z kernels [d_latent, 128]
//     slice by slice. They are read row-major [in, out] as TMA boxes of 64
//     rows x 64 columns with the 128-byte swizzle, MN-major for wgmma (the
//     transpose bit): no transposed copy. Each tile of 128 points reads
//     352 KB of trunk weights (2.75 KB per point against ~0.35 MFLOP), and
//     384 KB more of W_z in projection mode, from L2.
//   - W_out: padded to 64 zero columns (wgmma.m64n64k16; the 128-byte
//     swizzle wants a 64-element inner box); only the first d_out columns
//     are stored, as float32, rows past N never.
//   - Inputs: x_pe arrives padded to [N, 64] bf16 (the wrapper's copy: 126-
//     byte rows cannot be a TMA map) and is read from its swizzled tile into
//     A fragments. tz mode: slice i of tz [N, n_lin_z * 128] comes with the
//     weights of block i's fc_0 (two 64-column boxes per consumer) and is
//     read straight into the accumulator layout. Projection mode: t_i =
//     sum_l z_l @ W_z[i][rows of level l] is computed slice by slice just
//     before block i, in 64-row K-chunks: each step brings W_z[i]'s chunk
//     and the matching 64 latent columns of each consumer's points (a bf16
//     level as one box, the float32 coarse level as two 32-column boxes,
//     rounded to bf16 as it is read into A fragments). Each point's latent
//     is so read once per slice, 3 x 1.5 KB from L2: the alternative, all
//     three slices in one pass over z, needs 192 accumulator registers a
//     thread, or 96 KB of shared memory for the latent tile.
//   - No reduction crosses points: no atomics, identical bits on every call.
//
// The legacy path (other widths: DH 32 or 64, latent levels not multiples
// of 64, d_in > 64), chosen by shape in field_mlp.fwd_plan and counted
// apart: each warp owns 16 points and keeps their residual stream and
// matmul operand in shared memory across all layers; one [K, DH] weight
// matrix at a time is staged in shared memory and shared by the block's 4
// warps (64 points); bf16 WMMA 16x16x16. The projection of slice i runs just
// before block i's injection: W_z[i] streams in K-chunks of up to 128 latent
// rows while each warp stages the same columns of its 16 points' latent
// into its operand buffer. d_in (63) is padded to a multiple of 16 inside
// the kernel and d_out (1, 16 or 24) to 16 or 32 output columns.

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


// ------------------------------------------------------------ the wgmma path

namespace wg {

constexpr int kDH = 128;
constexpr int kPts = 64;                       // points per consumer warpgroup
constexpr int kConsumers = 2;
constexpr int kTile = kPts * kConsumers;       // points per tile
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 3;
constexpr int kBox = 64 * 128;                 // a TMA box: 64 rows x 128 bytes
constexpr int kWBytes = 4 * kBox;              // a [128, 128] bf16 weight matrix
constexpr int kInBytes = 2 * kBox;             // one consumer's input tiles of a step
constexpr int kStageBytes = kWBytes + kConsumers * kInBytes;
constexpr int kInRows = 64;                    // x_pe padded to 64 columns
constexpr int kOutCols = 64;                   // W_out padded to 64 columns
constexpr int kSmemMax = 232448;

// The packed forward biases (float32, bf16 values): b_in [128], b_z
// [n_lin_z * 128], per block b0 [128], b1 [128], b_out [64].
int bias_floats(int n_blocks, int n_lin_z) { return kDH * (1 + n_lin_z + 2 * n_blocks) + kOutCols; }

// Dynamic shared memory: 1,024 bytes of alignment slack, the ring, the
// biases, the barriers (field_mlp.fwd_plan computes the same).
size_t smem_bytes(int n_blocks, int n_lin_z) {
  return 1024 + static_cast<size_t>(kStages) * kStageBytes +
         4 * static_cast<size_t>(bias_floats(n_blocks, n_lin_z)) + 16 * kStages;
}

struct Args {
  const float* bias;
  float* out;
  int n, n_blocks, n_lin_z, d_out, n_tiles;
  int n_levels, f32_mask, d_lat;
  int width[3];
};

// Rows of the packed forward weights: W_in at 0 (64 rows), block b's W0 at
// 64 + 256 b and W1 128 rows on, W_out (128 rows) after the blocks, then
// lin_z_i's kernel [d_lat, 128] at w_out + 128 + i d_lat.
__device__ __forceinline__ int w_out_row(int n_blocks) { return kInRows + 2 * kDH * n_blocks; }

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
// thread rows r0, r0 + 8, columns 16 kk + 2 q (+ 1, + 8, + 9).
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

// acc (+)= A [64, 16 KC] (registers) x W [16 KC, 128] (the stage's weight
// tiles: columns 0-63 then, 16 KC * 128 bytes on, columns 64-127)
template <int KC>
__device__ __forceinline__ void mma128(float (&acc)[64], uint32_t (&a)[4 * KC], const uint8_t* w,
                                       bool accumulate) {
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
  wgmma_wait<0>();
  fence_acc(acc);
  fence_regs(a);
}

__device__ __forceinline__ void mma64(float (&acc)[32], uint32_t (&a)[32], const uint8_t* w) {
  using namespace njf_hopper;
  const uint64_t db = desc_sw128(w);
  fence_acc(acc);
  fence_regs(a);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < 8; ++c)
    wgmma_m64n64_rs(acc, a[4 * c], a[4 * c + 1], a[4 * c + 2], a[4 * c + 3], db + 128 * c,
                    c > 0 ? 1 : 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  fence_regs(a);
}

// The producer: one thread walks the same steps as the consumers and keeps
// the ring full. Per tile: lin_in (W_in + x_pe), per block [the projection's
// K-chunks (W_z chunk + latent columns)], fc_0 (W0 [+ tz slice]), fc_1 (W1),
// then lin_out (W_out).
template <bool kProj>
__device__ void produce(const CUtensorMap* mw, const CUtensorMap* mx, const CUtensorMap* mz0,
                        const CUtensorMap* mz1, const CUtensorMap* mz2, const Args& a,
                        uint8_t* smem, uint64_t* full, uint64_t* empty) {
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
  // [rows, 128 or 64] of the weights from row0: columns 0-63 then 64-127
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
    begin(2 * kBox);
    weights(w_out, kDH, 1);
  }
}

template <bool kProj>
__device__ void consume(const Args& a, const uint8_t* smem, const float* bias, uint64_t* full,
                        uint64_t* empty) {
  using namespace njf_hopper;
  const int cw = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) & 3;
  const int lane = threadIdx.x & 31;
  const int q = lane & 3;
  const int r0 = 16 * warp + (lane >> 2);  // rows r0 and r0 + 8 of the 64
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
  const float* b_blk = bias + kDH * (1 + a.n_lin_z);
  const float* b_out = b_blk + 2 * kDH * a.n_blocks;

  float acc[64];
  uint32_t x[32], av[32];  // x and the next A operand, bf16x2 in the accumulator layout
  // element (j, hr, e): row r0 + 8 hr, column 8 j + 2 q + e; acc[4 j + 2 hr + e],
  // x / av [2 j + hr] (the A fragment of k-chunk c is [4 c, 4 c + 4))

  // x = bf16(x + bf16(t + b)), av = relu(x), t from tz (bf16 pairs) or acc
  auto inject = [&](const float* b, const uint8_t* tz) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(b + 8 * j + 2 * q);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float2 t;
        if (tz != nullptr)
          t = unpack2(ld_b2(tz + (j / 8) * kBox, r0 + 8 * hr, 16 * (j % 8) + 4 * q));
        else
          t = make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
        const float2 xv = unpack2(x[2 * j + hr]);
        const float v0 = bfr(xv.x + bfr(t.x + bb.x)), v1 = bfr(xv.y + bfr(t.y + bb.y));
        x[2 * j + hr] = pack2(v0, v1);
        av[2 * j + hr] = pack2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      }
    }
  };

  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int p0 = tile * kTile + cw * kPts;
    // lin_in: x = bf16(x_pe @ W_in + b_in)
    {
      uint32_t f[16];
      acquire();
      frags_bf16(f, st + kWBytes + cw * kInBytes, r0, q);
      mma128<4>(acc, f, st, false);
      release();
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * q);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float v0 = bfr(acc[4 * j + 2 * hr] + bb.x), v1 = bfr(acc[4 * j + 2 * hr + 1] + bb.y);
          x[2 * j + hr] = pack2(v0, v1);
          av[2 * j + hr] = pack2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        }
      }
    }
    for (int blk = 0; blk < a.n_blocks; ++blk) {
      const bool inj = blk < a.n_lin_z;
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
              mma128<4>(acc, f, st, !first);
              release();
              first = false;
            }
          }
          inject(b_z + blk * kDH, nullptr);
        }
      }
      // fc_0: net = bf16(relu(x) @ W0 + b0); av = relu(net)
      acquire();
      if (!kProj && inj) inject(b_z + blk * kDH, st + kWBytes + cw * kInBytes);
      mma128<8>(acc, av, st, false);
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
      // fc_1: x = bf16(x + bf16(relu(net) @ W1 + b1)); av = relu(x)
      acquire();
      mma128<8>(acc, av, st, false);
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
    // lin_out: out = relu(x) @ W_out + b_out, float32, the first d_out columns
    float o[32];
    acquire();
    mma64(o, av, st);
    release();
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = p0 + r0 + 8 * hr;
      if (row >= a.n) continue;
      float* dst = a.out + static_cast<size_t>(row) * a.d_out;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * q + e;
          if (col < a.d_out) dst[col] = o[4 * j + 2 * hr + e] + b_out[col];
        }
    }
  }
}

template <bool kProj>
__global__ void __launch_bounds__(kThreads, 1)
    field_mlp_wg_kernel(const __grid_constant__ CUtensorMap mw,
                        const __grid_constant__ CUtensorMap mx,
                        const __grid_constant__ CUtensorMap mz0,
                        const __grid_constant__ CUtensorMap mz1,
                        const __grid_constant__ CUtensorMap mz2, const Args a) {
  using namespace njf_hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* bias = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  const int nb = kDH * (1 + a.n_lin_z + 2 * a.n_blocks) + kOutCols;
  uint64_t* full = reinterpret_cast<uint64_t*>(bias + nb);
  uint64_t* empty = full + kStages;
  for (int i = threadIdx.x; i < nb; i += kThreads) bias[i] = a.bias[i];
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
    if (threadIdx.x == 0) produce<kProj>(&mw, &mx, &mz0, &mz1, &mz2, a, smem, full, empty);
  } else {
    setmaxnreg_inc<232>();
    consume<kProj>(a, smem, bias, full, empty);
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

template <bool kProj>
int launch(const CUtensorMap (&maps)[5], const Args& a, int grid, int smem, cudaStream_t s) {
  auto kernel = field_mlp_wg_kernel<kProj>;
  static bool attr_set = false;  // per instantiation
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  kernel<<<grid, kThreads, smem, s>>>(maps[0], maps[1], maps[2], maps[3], maps[4], a);
  return static_cast<int>(cudaGetLastError());
}

// Checks shared by both modes; fills the maps of the weights and x_pe.
bool prepare(CUtensorMap (&maps)[5], Args& a, const void* x, const void* w, const void* b,
             void* out, int n, int n_blocks, int n_lin_z, int d_out, int grid, int smem) {
  if (n <= 0 || n_blocks < 0 || n_lin_z < 0 || n_lin_z > n_blocks || d_out <= 0 ||
      d_out > kOutCols || grid <= 0 || smem > kSmemMax ||
      static_cast<size_t>(smem) != smem_bytes(n_blocks, n_lin_z))
    return false;
  a.bias = static_cast<const float*>(b);
  a.out = static_cast<float*>(out);
  a.n = n;
  a.n_blocks = n_blocks;
  a.n_lin_z = n_lin_z;
  a.d_out = d_out;
  a.n_tiles = (n + kTile - 1) / kTile;
  const long long w_rows = kInRows + 2LL * kDH * n_blocks + kDH +
                           static_cast<long long>(n_lin_z) * a.d_lat;
  return encode_rows(&maps[0], w, w_rows, kDH, false) &&
         encode_rows(&maps[1], x, n, kInRows, false);
}

}  // namespace wg

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

// The wgmma path (K7-tz-fwd), planned by field_mlp.fwd_plan: tz [n, n_lin_z
// * 128] bf16, x [n, 64] bf16 (x_pe zero-padded), w / b the forward packing
// (field_mlp._pack_fwd), out [n, d_out] float32 (d_out <= 64); grid and smem
// from the plan (smem is checked against the kernel's own layout).
extern "C" int njf_field_mlp_tz_fwd_wg(const void* tz, const void* x, const void* w,
                                       const void* b, void* out, int n, int n_blocks,
                                       int n_lin_z, int d_out, int grid, int smem,
                                       void* stream) {
  CUtensorMap maps[5];
  wg::Args a = {};
  if (!wg::prepare(maps, a, x, w, b, out, n, n_blocks, n_lin_z, d_out, grid, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_lin_z > 0) {
    if (!wg::encode_rows(&maps[2], tz, n, n_lin_z * wg::kDH, false))
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    maps[2] = maps[1];  // never read
  }
  maps[3] = maps[4] = maps[2];
  return wg::launch<false>(maps, a, grid, smem, static_cast<cudaStream_t>(stream));
}

// The wgmma path (K7-fwd): the latent levels z_l [n, c_l] (bit l of
// f32_mask: float32, else bf16; c_l % 64 == 0), lin_z's kernels at the end
// of w; otherwise as njf_field_mlp_tz_fwd_wg.
extern "C" int njf_field_mlp_fwd_wg(const void* z0, const void* z1, const void* z2, int c0,
                                    int c1, int c2, int n_levels, int f32_mask, const void* x,
                                    const void* w, const void* b, void* out, int n,
                                    int n_blocks, int n_lin_z, int d_out, int grid, int smem,
                                    void* stream) {
  const int widths[3] = {c0, c1, c2};
  const void* ptrs[3] = {z0, z1, z2};
  if (n_levels < 1 || n_levels > 3) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[5];
  wg::Args a = {};
  a.n_levels = n_levels;
  a.f32_mask = f32_mask;
  for (int l = 0; l < n_levels; ++l) {
    if (widths[l] <= 0 || widths[l] % 64) return static_cast<int>(cudaErrorInvalidValue);
    a.width[l] = widths[l];
    a.d_lat += widths[l];
  }
  if (!wg::prepare(maps, a, x, w, b, out, n, n_blocks, n_lin_z, d_out, grid, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < 3; ++l) {
    if (l >= n_levels) {
      maps[2 + l] = maps[1];  // never read
    } else if (!wg::encode_rows(&maps[2 + l], ptrs[l], n, widths[l], (f32_mask >> l) & 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return wg::launch<true>(maps, a, grid, smem, static_cast<cudaStream_t>(stream));
}
