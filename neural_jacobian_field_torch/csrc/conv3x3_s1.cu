// K9-fwd on Hopper: stride-1 3x3 same-pad NHWC convolution as an implicit GEMM.
//
// Replaces neural_jacobian_field_tpu/ops/pallas/conv_suite.py::_s1_fwd
// (body _s1_fwd_kernel): y[b, i, j, :] = sum_{dy, dx, c} x[b, i+dy-1, j+dx-1, c]
// * w[dy, dx, c, :], zero outside the image: y[M, Cout] = A[M, 9C] W[9C, Cout]
// with A the TPU kernel's assembled tap-major operand (column (dy*3 + dx)*C +
// c). A is never built in device memory. The weights arrive as they are, the
// HWIO [3, 3, C, Cout] tensor (the TPU kernel's [9C, Cout] matrix): no copy.
//
// The same kernel computes K9's input gradient (dgrad, kDgrad): the
// cotangent convolved with the rotated weights, as conv_suite.py::_conv_s1_b
// does, read straight from the forward's w: tap t of the rotated kernel is
// tap 8 - t of w, and its [out, in] matrix is w's [in, out] one, so the same
// weight tile lands K-major instead of MN-major.
// K10 (njf_conv3x3_s1_fwd_stats) replaces conv_suite.py::_s1_fwd_stats: the
// same kernel with the kStats flag also returns the per-channel sum and sum
// of squares of the output over (B, H, W), taken from the float32
// accumulator before the bf16 downcast. y is written by the same code from
// the same accumulators, so it is bit-identical to K9-fwd's.
//
// What bounds it on the H100: at the encoder's shapes (layer1 120x160x64,
// layer2 60x80x128, layer3 30x40x256, bf16) every conv is 1.42 GFLOP per
// image over 2.5-9 MB: tensor-core work once the operands are fed (ops-bound
// at batch 7, 0.240 ms for 24 convs at 989 TFLOP/s), and at batch 1 bound by
// how few blocks there are and by each call's fixed cost. The design:
//   - a block owns a th x tw patch of output pixels (th * tw = 64 CW, one
//     64-row slab per consumer warpgroup, CW = 1 or 2; tw = 8 or 16)
//     and 64 output channels; the K loop is ceil(C / 64) channel chunks x
//     the 3 tap columns dx, one ring stage each;
//   - a stage's A tile is ONE TMA box of x, (64 channels, tw, th + 2, 1) at
//     (c0, x0 + dx - 1, y0 - 1, b): the patch shifted by dx with one halo
//     row above and below. The hardware zero-fills what lies outside the
//     image, negative coordinates included, which is exactly the same-pad
//     halo. It lands 128-byte swizzled and K-major, tw rows per patch row,
//     so the A operand of tap (dy, dx) is the same tile from row dy * tw on:
//     a descriptor 1,024-byte aligned (tw is a multiple of 8), no copy. x
//     passes through L2 3 (th + 2) / th times per chunk instead of 9;
//   - the three weight tiles of the stage (taps (0, dx), (1, dx), (2, dx))
//     are boxes of w seen as (Cout, C, 9): (64 out, 64 in, 1) for the
//     forward, read by wgmma MN-major (the transpose bit), or (64 in, 64
//     out, 1) at tap 8 - t for the dgrad, read K-major; zero beyond C and
//     Cout either way;
//   - a ring of stages with a full / empty mbarrier pair each: warpgroup 0
//     (one thread) issues the TMA loads up to the ring's depth ahead;
//     the CW consumer warpgroups each run 3 taps x 4 k16 slices of
//     wgmma.m64n64k16 per stage on their 64 rows, float32 accumulators in
//     registers, and free a stage as soon as the wgmma group that read it
//     has retired;
//   - the epilogue rounds each accumulator to bf16 once and stores the rows
//     that lie inside the image (a patch may hang over the right or bottom
//     edge; those rows read real neighbours and are not zero, so they are
//     left out of the store and of K10's sums).
// The patch (th, tw) is chosen per shape by conv_suite.conv_plan and passed
// in: 128 pixels where that still gives five blocks per SM, else 64 (two
// blocks per SM either way). No K split: the smallest main-path grid
// (layer3 at batch 1, 80 blocks of 12 stages) spends less device time per
// conv than the call's fixed host cost. Wider output tiles (128 channels)
// measured no faster at the encoder's shapes.
//
// What bounds it, measured on an H100 (chip_smoke.py): with one box per
// tap, x went through L2 nine times and a batch-7 conv's blocks pulled
// 160-240 MB out of L2 at 4.6-6.7 TB/s, about the L2's rate (230-280
// TFLOP/s); the shifted halo boxes cut x's share of that traffic ~2.5x,
// and the weight tiles, re-read by every block, are now about half of it.
//
// K10's sums: each thread adds its two rows per column, a shuffle butterfly
// adds the 8 row groups of a warp, and shared memory adds the 8 warps in
// order; one [tiles, Cout] partial row pair goes out, and a second kernel
// adds the rows in tile order. No atomics: two calls give identical bits.
//
// Shapes the TMA path cannot take (C or Cout not a multiple of 8: TMA needs
// 16-byte strides) go to the legacy kernel, chosen by shape (bn == 0 in the
// plan), never after an error: bf16 WMMA 16x16x16 with scalar gathers of
// the implicit operand.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "conv3x3_gather.cuh"
#include "hopper_tma.cuh"

using namespace nvcuda;
using njf_k9::load_x_elem;

namespace {

// ------------------------------------------------------- the TMA + wgmma path

constexpr int kWTile = 64 * 128;  // 64 x 64 bf16 of the weights
constexpr int kMaxTw = 16;        // widest patch: the halo rows fit the A tile

// CW consumer warpgroups, 64 output pixels each (th * tw = 64 CW), and 64
// output channels per block; warpgroup 0 is the producer. A stage: the
// halo'd A box ((th + 2) tw rows of 64 bf16) and the 3 taps' weight tiles.
// The patch width is a template parameter (TW = 8 or 16): with a run-time
// width in the shifted descriptors ptxas serializes the wgmmas (C7515).
template <int CW>
struct FwdCfg {
  static constexpr int kRows = 64 * CW;
  static constexpr int kThreads = 128 * (CW + 1);
  static constexpr int kABytes = (kRows + 2 * kMaxTw) * 128;
  static constexpr int kStages = 2;
  static constexpr int kStage = kABytes + 3 * kWTile;
  static constexpr int kSmem = kStages * kStage + 2 * kStages * 8 + 1024;
};

template <int CW, int TW, bool kDgrad, bool kStats>
__global__ void __launch_bounds__(FwdCfg<CW>::kThreads, 2)
    conv3x3_tma_kernel(const __grid_constant__ CUtensorMap mx,
                       const __grid_constant__ CUtensorMap mw, __nv_bfloat16* __restrict__ y,
                       float* __restrict__ part1, float* __restrict__ part2, int H, int W,
                       int C, int Cout, int tiles_y, int tiles_x) {
  using namespace njf_hopper;
  using Cfg = FwdCfg<CW>;
  constexpr int kABytes = Cfg::kABytes;
  constexpr int tw = TW, th = Cfg::kRows / TW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Cfg::kStages * Cfg::kStage);
  uint64_t* empty = full + Cfg::kStages;

  const int mt = blockIdx.x;  // (b, ty, tx), tx fastest
  const int tx = mt % tiles_x;
  const int ty = (mt / tiles_x) % tiles_y;
  const int b = mt / (tiles_x * tiles_y);
  const int x0 = tx * tw, y0 = ty * th, n0 = blockIdx.y * 64;
  const int nsteps = 3 * ((C + 63) / 64);  // (chunk, dx), dx fastest
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Cfg::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * CW);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread keeps the ring full
    if (threadIdx.x == 0) {
      constexpr uint32_t kBytes = (th + 2) * tw * 128 + 3 * kWTile;
      for (int k = 0; k < nsteps; ++k) {
        const int s = k % Cfg::kStages;
        if (k >= Cfg::kStages) mbar_wait(&empty[s], ((k / Cfg::kStages) - 1) & 1);
        const int c0 = (k / 3) * 64, dx = k % 3;
        uint8_t* st = smem + s * Cfg::kStage;
        mbar_expect_tx(&full[s], kBytes);
        tma_load_4d(st, &mx, &full[s], c0, x0 + dx - 1, y0 - 1, b);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int tap = dy * 3 + dx;
          uint8_t* wtile = st + kABytes + dy * kWTile;
          if constexpr (kDgrad)  // rows: 64 outputs, K-major over 64 inputs
            tma_load_3d(wtile, &mw, &full[s], c0, n0, 8 - tap);
          else  // rows: 64 inputs, MN-major over 64 outputs
            tma_load_3d(wtile, &mw, &full[s], n0, c0, tap);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw (0 .. CW - 1) owns rows [64 cw, 64 cw + 64)
  const int cw = wg - 1;
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (int k = 0; k < nsteps; ++k) {
    const int s = k % Cfg::kStages;
    mbar_wait(&full[s], (k / Cfg::kStages) & 1);
    const uint8_t* st = smem + s * Cfg::kStage;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      // tap (dy, dx): the halo'd tile from row dy * tw on
      const uint64_t da = desc_sw128(st + (cw * 64 + dy * tw) * 128);
      const uint64_t db = desc_sw128(st + kABytes + dy * kWTile);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // a k16 slice: +32 B inside a K-major row, +2,048 B (16 rows) MN-major
        if constexpr (kDgrad)
          wgmma_m64n64<0, 0>(acc, da + 2 * kk, db + 2 * kk);
        else
          wgmma_m64n64<0, 1>(acc, da + 2 * kk, db + 128 * kk);
      }
    }
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();  // the previous step's group has retired: free its stage
    fence_acc(acc);
    if (k > 0 && lane == 0) mbar_arrive(&empty[(k - 1) % Cfg::kStages]);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // accumulator layout of wgmma m64n64: thread (warp, lane) holds rows
  // 16 warp + lane / 4 (+ 8 for hr = 1) and, per 8-column group j, columns
  // 8 j + 2 (lane % 4) + {0, 1}: acc[4 j + 2 hr + e]
  bool ok[2];
  size_t base[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = cw * 64 + warp * 16 + (lane >> 2) + 8 * hr;
    const int py = y0 + r / tw, px = x0 + r % tw;
    ok[hr] = py < H && px < W;
    base[hr] = ((static_cast<size_t>(b) * H + py) * W + px) * Cout;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + j * 8 + (lane & 3) * 2;
    if (col >= Cout) continue;  // Cout % 8 == 0: col + 1 < Cout too
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      if (ok[hr])
        *reinterpret_cast<__nv_bfloat162*>(y + base[hr] + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
  }

  if constexpr (kStats) {
    __shared__ float red[2][4 * CW][64];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v0 = ok[0] ? acc[4 * j + e] : 0.f;
        const float v1 = ok[1] ? acc[4 * j + 2 + e] : 0.f;
        float s = v0 + v1;
        float q = v0 * v0 + v1 * v1;
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {  // the 8 row groups of the warp
          s += __shfl_xor_sync(0xffffffffu, s, o);
          q += __shfl_xor_sync(0xffffffffu, q, o);
        }
        if (lane < 4) {
          red[0][cw * 4 + warp][j * 8 + lane * 2 + e] = s;
          red[1][cw * 4 + warp][j * 8 + lane * 2 + e] = q;
        }
      }
    // the consumer warpgroups only (barrier 0 counts the producer too)
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * CW) : "memory");
    const int t = threadIdx.x - 128;
    if (t < 128) {
      const int which = t / 64, col = t % 64, n = n0 + col;
      if (n < Cout) {
        float a = 0.f;
#pragma unroll
        for (int wp = 0; wp < 4 * CW; ++wp) a += red[which][wp][col];  // warps in order
        (which ? part2 : part1)[static_cast<size_t>(mt) * Cout + n] = a;
      }
    }
  }
}

// w [3, 3, Cw, Cout_w] (HWIO) as the 3-D map (Cout_w, Cw, 9) with a (64, 64,
// 1) box: for the forward (Cw = C, Cout_w = Cout) 64 inputs x 64 outputs, for
// the dgrad (Cw = Cout, Cout_w = C) 64 outputs x 64 inputs.
template <int CW, int TW, bool kDgrad, bool kStats>
cudaError_t launch_tma(const void* x, const void* w, void* y, float* part1, float* part2, int B,
                       int H, int W, int C, int Cout, cudaStream_t s) {
  CUtensorMap mx, mw;
  using Cfg = FwdCfg<CW>;
  constexpr int tw = TW, th = Cfg::kRows / TW;
  if (!njf_hopper::encode_nhwc(&mx, x, B, H, W, C, th + 2, tw)) return cudaErrorInvalidValue;
  const int cw = kDgrad ? Cout : C, coutw = kDgrad ? C : Cout;
  const uint64_t wdims[3] = {static_cast<uint64_t>(coutw), static_cast<uint64_t>(cw), 9u};
  const uint64_t wstrides[2] = {2ull * coutw, 2ull * coutw * cw};
  const uint32_t wbox[3] = {64u, 64u, 1u};
  if (!njf_hopper::encode_map(&mw, w, 3, wdims, wstrides, wbox)) return cudaErrorInvalidValue;
  const int tiles_y = (H + th - 1) / th, tiles_x = (W + tw - 1) / tw;
  const long long m_tiles = static_cast<long long>(B) * tiles_y * tiles_x;
  const int n_tiles = (Cout + 63) / 64;
  if (m_tiles > 0x7fffffffLL || n_tiles > 65535) return cudaErrorInvalidValue;
  auto kernel = conv3x3_tma_kernel<CW, TW, kDgrad, kStats>;
  static bool attr_set = false;  // per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  kernel<<<dim3(static_cast<unsigned>(m_tiles), n_tiles), Cfg::kThreads, Cfg::kSmem, s>>>(
      mx, mw, static_cast<__nv_bfloat16*>(y), part1, part2, H, W, C, Cout, tiles_y, tiles_x);
  return cudaGetLastError();
}

// ------------------------------------------------------------ the legacy path

constexpr int kBM = 64;   // output pixels per block
constexpr int kBN = 64;   // output channels per block
constexpr int kBK = 32;   // reduction slice per step
constexpr int kLDA = kBK + 8;
constexpr int kLDB = kBN + 8;
constexpr int kLDC = kBN + 4;
constexpr int kThreads = 128;  // 4 warps, 2x2 over the 64x64 tile

// Any C, Cout: scalar gathers, WMMA 16x16x16. w HWIO: [3, 3, C, Cout], or
// for the dgrad the forward's [3, 3, Cout, C], read rotated.
template <bool kStats>
__global__ void __launch_bounds__(kThreads)
    conv3x3_legacy_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w,
                          __nv_bfloat16* __restrict__ y, float* __restrict__ part1,
                          float* __restrict__ part2, int B, int H, int W, int C, int Cout,
                          bool dgrad) {
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
      __nv_bfloat16 v = __float2bfloat16(0.f);
      if (k < K && n < Cout) {
        const int tap = k / C, c = k - (k / C) * C;
        v = dgrad ? w[(static_cast<size_t>(8 - tap) * Cout + n) * C + c]
                  : w[static_cast<size_t>(k) * Cout + n];
      }
      sb[kr * kLDB + nn] = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &sa[(wm + i * 16) * kLDA + kk], kLDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &sb[kk * kLDB + wn + j * 16], kLDB);
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
      wmma::store_matrix_sync(&sc[(wm + i * 16) * kLDC + wn + j * 16], acc[i][j], kLDC,
                              wmma::mem_row_major);
  __syncthreads();

  for (int e = tid; e < kBM * kBN; e += kThreads) {
    const int r = e / kBN;
    const int nn = e - r * kBN;
    const int m = m0 + r;
    const int n = n0 + nn;
    if (m < M && n < Cout) y[static_cast<size_t>(m) * Cout + n] = __float2bfloat16(sc[r * kLDC + nn]);
  }

  if constexpr (kStats) {
    // thread t sums column t % 64 over rows [32 h, 32 h + 32), h = t / 64,
    // in row order; the two halves are then added in half order
    __shared__ float red[2][2][kBN];
    const int col = tid % kBN;
    const int half = tid / kBN;
    const int rows = min(kBM / 2, M - m0 - half * (kBM / 2));
    float a1 = 0.f, a2 = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float v = sc[(half * (kBM / 2) + r) * kLDC + col];
      a1 += v;
      a2 += v * v;
    }
    red[half][0][col] = a1;
    red[half][1][col] = a2;
    __syncthreads();
    const int n = n0 + col;
    if (n < Cout) {
      float* part = half == 0 ? part1 : part2;
      part[static_cast<size_t>(blockIdx.x) * Cout + n] = red[0][half][col] + red[1][half][col];
    }
  }
}

template <bool kStats>
cudaError_t launch_legacy(const void* x, const void* w, void* y, float* part1, float* part2,
                          int B, int H, int W, int C, int Cout, bool dgrad, cudaStream_t s) {
  const long long M = static_cast<long long>(B) * H * W;
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM),
                  static_cast<unsigned>((Cout + kBN - 1) / kBN));
  conv3x3_legacy_kernel<kStats><<<grid, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), part1, part2, B, H, W, C, Cout, dgrad);
  return cudaGetLastError();
}

// s[n] = sum over the tiles of part[t][n]: thread (col, j) of a 32 x 32
// block sums the j-th contiguous range of tile rows in order, then thread
// (col, 0) adds the 32 range sums in order. The same bits on every call.
constexpr int kSumCols = 32;
constexpr int kSumRanges = 32;

__global__ void __launch_bounds__(kSumCols * kSumRanges)
    stats_sum_kernel(const float* __restrict__ part1, const float* __restrict__ part2,
                     float* __restrict__ s1, float* __restrict__ s2, int nblk, int Cout) {
  __shared__ float acc[2][kSumRanges][kSumCols];
  const int col = threadIdx.x;
  const int j = threadIdx.y;
  const int n = blockIdx.x * kSumCols + col;
  const int per = (nblk + kSumRanges - 1) / kSumRanges;
  const int lo = j * per;
  const int hi = min(nblk, lo + per);
  float a1 = 0.f, a2 = 0.f;
  if (n < Cout) {
#pragma unroll 4
    for (int b = lo; b < hi; ++b) {
      a1 += part1[static_cast<size_t>(b) * Cout + n];
      a2 += part2[static_cast<size_t>(b) * Cout + n];
    }
  }
  acc[0][j][col] = a1;
  acc[1][j][col] = a2;
  __syncthreads();
  if (j == 0 && n < Cout) {
    float t1 = 0.f, t2 = 0.f;
    for (int r = 0; r < kSumRanges; ++r) {
      t1 += acc[0][r][col];
      t2 += acc[1][r][col];
    }
    s1[n] = t1;
    s2[n] = t2;
  }
}

// One conv by the plan: bn 64 takes the TMA path with a th x tw patch of
// 64 or 128 pixels (tw 8 or 16), bn 0 the legacy kernel (th, tw unused).
template <bool kStats, bool kDgrad>
cudaError_t launch_tma_plan(const void* x, const void* w, void* y, float* part1, float* part2,
                            int B, int H, int W, int C, int Cout, int th, int tw, int bn,
                            cudaStream_t s) {
#define NJF_TMA_CASE(CW_, TW_)                                                              \
  if (bn == 64 && th * tw == 64 * CW_ && tw == TW_)                                          \
    return launch_tma<CW_, TW_, kDgrad, kStats>(x, w, y, part1, part2, B, H, W, C, Cout, s);
  NJF_TMA_CASE(1, 8)
  NJF_TMA_CASE(1, 16)
  NJF_TMA_CASE(2, 8)
  NJF_TMA_CASE(2, 16)
#undef NJF_TMA_CASE
  return cudaErrorInvalidValue;
}

template <bool kStats>
cudaError_t launch_conv(const void* x, const void* w, void* y, float* part1, float* part2,
                        int B, int H, int W, int C, int Cout, int th, int tw, int bn, bool dgrad,
                        cudaStream_t s) {
  if (bn == 0) return launch_legacy<kStats>(x, w, y, part1, part2, B, H, W, C, Cout, dgrad, s);
  if (C % 8 != 0 || Cout % 8 != 0) return cudaErrorInvalidValue;
  if (!dgrad)
    return launch_tma_plan<kStats, false>(x, w, y, part1, part2, B, H, W, C, Cout, th, tw, bn, s);
  if constexpr (!kStats)
    return launch_tma_plan<false, true>(x, w, y, part1, part2, B, H, W, C, Cout, th, tw, bn, s);
  return cudaErrorInvalidValue;
}

// Row blocks the plan gives: the TMA path's patches, or the legacy kernel's
// 64-pixel blocks.
long long plan_tiles(int B, int H, int W, int th, int tw, int bn) {
  if (bn == 0) return (static_cast<long long>(B) * H * W + kBM - 1) / kBM;
  return static_cast<long long>(B) * ((H + th - 1) / th) * ((W + tw - 1) / tw);
}

}  // namespace

// x [B, H, W, C] bf16 and y [B, H, W, Cout] bf16; w the bf16 HWIO kernel
// [3, 3, C, Cout], or with dgrad != 0 the forward's [3, 3, Cout, C] (x is
// then the cotangent and y the input gradient); (th, tw, bn) from
// conv_suite.conv_plan.
extern "C" int njf_conv3x3_s1_fwd(const void* x, const void* w, void* y, int B, int H, int W,
                                  int C, int Cout, int th, int tw, int bn, int dgrad,
                                  void* stream) {
  const long long M = static_cast<long long>(B) * H * W;
  if (M <= 0 || C <= 0 || Cout <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_conv<false>(x, w, y, nullptr, nullptr, B, H, W, C, Cout, th,
                                             tw, bn, dgrad != 0,
                                             static_cast<cudaStream_t>(stream)));
}

// K10: y as njf_conv3x3_s1_fwd (forward weights), plus s1 [Cout] = sum of y
// and s2 [Cout] = sum of y^2 over (B, H, W), float32, from the accumulator.
// partial: float32 [2, nblk, Cout] scratch, nblk the plan's row blocks
// (checked).
extern "C" int njf_conv3x3_s1_fwd_stats(const void* x, const void* w, void* y, void* partial,
                                        void* s1, void* s2, int B, int H, int W, int C,
                                        int Cout, int th, int tw, int bn, int nblk,
                                        void* stream) {
  const long long M = static_cast<long long>(B) * H * W;
  if (M <= 0 || C <= 0 || Cout <= 0 || nblk != plan_tiles(B, H, W, th, tw, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* part1 = static_cast<float*>(partial);
  auto* part2 = part1 + static_cast<size_t>(nblk) * Cout;
  cudaError_t err =
      launch_conv<true>(x, w, y, part1, part2, B, H, W, C, Cout, th, tw, bn, false, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_sum_kernel<<<(Cout + kSumCols - 1) / kSumCols, dim3(kSumCols, kSumRanges), 0, s>>>(
      part1, part2, static_cast<float*>(s1), static_cast<float*>(s2), nblk, Cout);
  return static_cast<int>(cudaGetLastError());
}
