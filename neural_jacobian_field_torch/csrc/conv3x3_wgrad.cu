// K9-wgrad on Hopper: the weight gradient of the stride-1 3x3 same-pad NHWC
// convolution, dW [9C, Cout] = A^T g, where A [B*H*W, 9C] is the implicit
// tap-major operand of K9-fwd and g [B*H*W, Cout] the output cotangent.
//
// Replaces neural_jacobian_field_tpu/ops/pallas/conv_suite.py::_s1_wgrad (body
// _s1_wgrad_kernel), which adds each row block's assembled-input^T x g into one
// float32 [9C, Cout] output carried across the TPU's sequential grid. Hopper
// blocks run in no order, so the reduction over the pixels is split: block
// (k tile, n tile, s) sums over the s-th slice of pixel patches into its own
// float32 partial, and a second pass adds the partials in slice order. No
// atomics: the result is the same from run to run.
//
// What bounds it on the H100: at the encoder's training shapes (batch 7:
// layer1 134,400 x 576 x 64, layer2 33,600 x 1152 x 128, layer3 8,400 x 2304
// x 256) a wgrad is 9.9 GFLOP over ~20 MB of inputs: tensor-core work, 0.240
// ms for the 24 convs at 989 TFLOP/s, once the operands are fed. The design:
//   - a block owns one tap column dx (three taps), one 64-channel chunk and
//     64 * NH output channels: a 192 x 64 NH tile of dW, so each 64-pixel
//     step loads one x box and NH g boxes for 3 NH wgmmas of 64 x 64 x 64;
//   - a step's operands are TMA boxes over a th x tw patch of pixels (8 x 8,
//     4 x 16 or 2 x 32): g at the patch itself, x at the patch shifted by
//     dx - 1 with one halo row above and below, (th + 2) tw rows, so tap
//     (dy, dx)'s operand is that tile from row dy * tw on (1,024-byte
//     aligned: tw is a multiple of 8); the hardware zero-fills outside the
//     image, so a halo tap reads zeros and a patch row hanging over the edge
//     has g = 0 and adds nothing;
//   - in wgmma terms A is the x tile read MN-major (channels as M, pixels as
//     the contraction) and B the g tile read MN-major (output channels as N):
//     bf16 wgmma takes both transpose bits, so no tile is transposed;
//   - the ring: warpgroup 0 (one thread) issues the TMA loads; warpgroups
//     1-3 (tap rows dy = 0, 1, 2) issue wgmma with float32 accumulators in
//     registers and free a stage when the group that read it retires;
//   - the plan (conv_suite.wgrad_plan) picks the patch, NH and the number
//     of pixel slices so that the grid is about one wave of 132 SMs: fewer
//     and larger partials than a row split at four blocks per SM.
// Measured on an H100 (chip_smoke.py): with one x box per tap the x and g
// boxes streamed through L2 at ~6 TB/s at batch 7, about the L2's rate, for
// 300-370 TFLOP/s; one halo'd x box per step cuts the bytes ~1.8x (0.71 to
// 0.65 ms for the 24 convs of a batch-7 train step).
//
// Shapes the TMA path cannot take (C or Cout not a multiple of 8) go to the
// legacy kernel, chosen by shape (nh == 0), never after an error: WMMA with
// scalar gathers, split over rows.

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

constexpr int kPix = 64;              // pixels per step (th * tw)
constexpr int kTile = kPix * 128;     // a g box: 64 pixels x 64 bf16
constexpr int kMaxTw = 32;            // widest patch: the halo rows fit the x tile
constexpr int kXTile = (kPix + 2 * kMaxTw) * 128;
constexpr int kWgThreads = 512;       // producer warpgroup + 3 consumer warpgroups

template <int NH>
struct WgCfg {
  static constexpr int kStages = NH == 1 ? 8 : 6;
  static constexpr int kStage = kXTile + NH * kTile;
  static constexpr int kSmem = kStages * kStage + 2 * kStages * 8 + 1024;
};

template <int NH>
__global__ void __launch_bounds__(kWgThreads, 1)
    wgrad_tma_kernel(const __grid_constant__ CUtensorMap mx,
                     const __grid_constant__ CUtensorMap mg, float* __restrict__ partial, int H,
                     int W, int C, int Cout, int th, int tw, int tiles_y, int tiles_x,
                     int p_tiles, int per) {
  using namespace njf_hopper;
  using Cfg = WgCfg<NH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Cfg::kStages * Cfg::kStage);
  uint64_t* empty = full + Cfg::kStages;

  const int chunks = (C + 63) / 64;
  const int dx = blockIdx.x / chunks;
  const int c0 = (blockIdx.x - dx * chunks) * 64;
  const int n0 = blockIdx.y * 64 * NH;
  const int t_begin = blockIdx.z * per;
  const int nsteps = max(0, min(p_tiles, t_begin + per) - t_begin);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Cfg::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 12);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    if (threadIdx.x == 0) {
      const uint32_t bytes = (th + 2) * tw * 128 + NH * kTile;
      for (int k = 0; k < nsteps; ++k) {
        const int s = k % Cfg::kStages;
        if (k >= Cfg::kStages) mbar_wait(&empty[s], ((k / Cfg::kStages) - 1) & 1);
        const int t = t_begin + k;  // patch (b, ty, tx), tx fastest
        const int tx = t % tiles_x;
        const int ty = (t / tiles_x) % tiles_y;
        const int b = t / (tiles_x * tiles_y);
        const int x0 = tx * tw, y0 = ty * th;
        uint8_t* st = smem + s * Cfg::kStage;
        mbar_expect_tx(&full[s], bytes);
        tma_load_4d(st, &mx, &full[s], c0, x0 + dx - 1, y0 - 1, b);
#pragma unroll
        for (int h = 0; h < NH; ++h)
          tma_load_4d(st + kXTile + h * kTile, &mg, &full[s], n0 + 64 * h, x0, y0, b);
      }
    }
    return;
  }

  // consumers: warpgroup cw is tap (dy = cw, dx)
  const int cw = wg - 1;
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  float acc[NH][32];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;

  for (int k = 0; k < nsteps; ++k) {
    const int s = k % Cfg::kStages;
    mbar_wait(&full[s], (k / Cfg::kStages) & 1);
    const uint8_t* st = smem + s * Cfg::kStage;
    const uint64_t da = desc_sw128(st + cw * tw * 128);  // rows from dy * tw
#pragma unroll
    for (int h = 0; h < NH; ++h) fence_acc(acc[h]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kPix / 16; ++kk)
#pragma unroll
      for (int h = 0; h < NH; ++h)  // +2,048 B: the next 16 pixels
        wgmma_m64n64<1, 1>(acc[h], da + 128 * kk, desc_sw128(st + kXTile + h * kTile) + 128 * kk);
    wgmma_commit();
#pragma unroll
    for (int h = 0; h < NH; ++h) fence_acc(acc[h]);
    wgmma_wait<1>();
#pragma unroll
    for (int h = 0; h < NH; ++h) fence_acc(acc[h]);
    if (k > 0 && lane == 0) mbar_arrive(&empty[(k - 1) % Cfg::kStages]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < NH; ++h) fence_acc(acc[h]);

  // rows: channel c0 + 16 warp + lane / 4 (+ 8) of tap (cw, dx); columns as
  // in the forward's epilogue
  const size_t K = 9 * static_cast<size_t>(C);
  float* out = partial + static_cast<size_t>(blockIdx.z) * K * Cout;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int c = c0 + warp * 16 + (lane >> 2) + 8 * hr;
    if (c >= C) continue;
    float* row = out + (static_cast<size_t>(cw * 3 + dx) * C + c) * Cout;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + 64 * h + j * 8 + (lane & 3) * 2;
        if (n < Cout)  // Cout % 8 == 0: n + 1 < Cout too
          *reinterpret_cast<float2*>(row + n) =
              make_float2(acc[h][4 * j + 2 * hr], acc[h][4 * j + 2 * hr + 1]);
      }
  }
}

template <int NH>
cudaError_t launch_tma(const void* x, const void* g, float* partial, int B, int H, int W, int C,
                       int Cout, int th, int tw, int splits, int per, cudaStream_t s) {
  CUtensorMap mx, mg;
  if (th <= 0 || tw <= 0 || th * tw != kPix || tw % 8 != 0 || tw > kMaxTw ||
      !njf_hopper::encode_nhwc(&mx, x, B, H, W, C, th + 2, tw) ||
      !njf_hopper::encode_nhwc(&mg, g, B, H, W, Cout, th, tw))
    return cudaErrorInvalidValue;
  const int tiles_y = (H + th - 1) / th, tiles_x = (W + tw - 1) / tw;
  const long long p_tiles = static_cast<long long>(B) * tiles_y * tiles_x;
  if (p_tiles > 0x7fffffffLL || static_cast<long long>(splits) * per < p_tiles)
    return cudaErrorInvalidValue;
  const int k_tiles = 3 * ((C + 63) / 64);
  const int n_tiles = (Cout + 64 * NH - 1) / (64 * NH);
  if (n_tiles > 65535 || splits > 65535) return cudaErrorInvalidValue;
  auto kernel = wgrad_tma_kernel<NH>;
  static bool attr_set = false;  // per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WgCfg<NH>::kSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  kernel<<<dim3(k_tiles, n_tiles, splits), kWgThreads, WgCfg<NH>::kSmem, s>>>(
      mx, mg, partial, H, W, C, Cout, th, tw, tiles_y, tiles_x, static_cast<int>(p_tiles), per);
  return cudaGetLastError();
}

// ------------------------------------------------------------ the legacy path

constexpr int kTM = 64;  // dW rows (tap x input channel) per block
constexpr int kTN = 64;  // dW columns (output channel) per block
constexpr int kTK = 32;  // pixels per step
constexpr int kLdA = kTM + 8;
constexpr int kLdG = kTN + 8;
constexpr int kLdC = kTN + 4;
constexpr int kThreads = 128;  // 4 warps, 2x2 over the 64x64 tile

// Any C, Cout: scalar gathers, WMMA 16x16x16, rows split into slices.
__global__ void __launch_bounds__(kThreads)
    wgrad_legacy_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                        float* __restrict__ partial, int B, int H, int W, int C, int Cout,
                        int rows_per_split) {
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
    for (int e = tid; e < kTK * kTM; e += kThreads) {
      const int p = e / kTM;
      const int kk = e - p * kTM;
      const int m = m0 + p;
      sa[p * kLdA + kk] =
          m < m_end ? load_x_elem(x, m, k0 + kk, M, K, H, W, C) : __float2bfloat16(0.f);
    }
    for (int e = tid; e < kTK * kTN; e += kThreads) {
      const int p = e / kTN;
      const int nn = e - p * kTN;
      const int m = m0 + p;
      const int n = n0 + nn;
      sg[p * kLdG + nn] = (m < m_end && n < Cout) ? g[static_cast<size_t>(m) * Cout + n]
                                                  : __float2bfloat16(0.f);
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

cudaError_t launch_legacy(const void* x, const void* g, float* partial, int B, int H, int W,
                          int C, int Cout, int splits, int rows_per_split, cudaStream_t s) {
  const long long M = static_cast<long long>(B) * H * W;
  if (rows_per_split % kTK != 0 || static_cast<long long>(splits) * rows_per_split < M)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((9 * C + kTM - 1) / kTM),
                  static_cast<unsigned>((Cout + kTN - 1) / kTN), static_cast<unsigned>(splits));
  wgrad_legacy_kernel<<<grid, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                static_cast<const __nv_bfloat16*>(g), partial, B,
                                                H, W, C, Cout, rows_per_split);
  return cudaGetLastError();
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
// dw [9C, Cout] float32. The plan (conv_suite.wgrad_plan): nh 1 or 2 takes
// the TMA path with th x tw = 64-pixel patches (tw 8, 16 or 32), `per`
// patches per slice;
// nh 0 the legacy kernel, `per` rows (a multiple of 32) per slice.
extern "C" int njf_conv3x3_s1_wgrad(const void* x, const void* g, void* partial, void* dw,
                                    int B, int H, int W, int C, int Cout, int th, int tw,
                                    int nh, int splits, int per, void* stream) {
  const long long M = static_cast<long long>(B) * H * W;
  if (M <= 0 || C <= 0 || Cout <= 0 || splits <= 0 || per <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* pp = static_cast<float*>(partial);
  cudaError_t err;
  if (nh == 0)
    err = launch_legacy(x, g, pp, B, H, W, C, Cout, splits, per, s);
  else if (C % 8 != 0 || Cout % 8 != 0)
    err = cudaErrorInvalidValue;
  else if (nh == 1)
    err = launch_tma<1>(x, g, pp, B, H, W, C, Cout, th, tw, splits, per, s);
  else if (nh == 2)
    err = launch_tma<2>(x, g, pp, B, H, W, C, Cout, th, tw, splits, per, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = 9LL * C * Cout;
  long long blocks = (n + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  sum_splits_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(pp, static_cast<float*>(dw), n,
                                                                   splits);
  return static_cast<int>(cudaGetLastError());
}
