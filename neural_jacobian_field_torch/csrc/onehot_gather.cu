// K1 on Hopper: bilinear sampling of the coarse pyramid level (K1-fwd) and
// the scatter of its gradient back onto the map (K1-bwd).
//
// Replaces neural_jacobian_field_tpu/ops/pallas/onehot_gather.py::
// onehot_gather_fwd_pallas (body _fwd_kernel) and onehot_scatter_bwd_pallas
// (body _bwd_kernel). The TPU kernels build a [points, K] one-hot matrix in
// VMEM whose row holds the four bilinear corner weights, rounded to the map's
// dtype, and run out = onehot @ F and gF = onehot^T @ g on the MXU: a Mosaic
// workaround for row gathers. Here the function itself is computed:
//   out[b, p, :] = sum over corners q in order (y0x0, y0x1, y1x0, y1x1) of
//                  rw[b, p, q] * F[b, idx[b, p, q], :]
//   gF[b, k, :]  = sum over (p, q) with idx[b, p, q] == k of rw[b, p, q] * g[b, p, :]
// where rw is the weight rounded to the map's dtype; products and sums are
// float32 (a bf16 x bf16 product is exact in float32), with no fused
// multiply-add, so the forward equals its plain version bit for bit.
//
// What bounds them on the H100, and what the design does about it:
//  - K1-fwd moves bytes: the map (614 KB per image in bf16 at 30x40x256)
//    stays in the 50 MB L2 while every point reads four 512-byte texel rows
//    of it and writes one float32 row of 1 KB. At the train shapes (7 x
//    65,536 points) the output alone is 470 MB. One thread handles 8
//    channels of one point (16-byte loads of each corner, two 16-byte
//    stores), so a warp covers one point's 256 channels with coalesced rows.
//  - K1-bwd scatters ~65,536 x 4 contributions per image onto 1,200 texels;
//    along the epipolar lines some texels take thousands. Float atomics would
//    make the sum's order, and so its bits, change from run to run. Instead a
//    block owns one image, a 32-channel slice and a contiguous range of
//    points, and keeps that slice of the whole map in shared memory (1,200 x
//    32 float32 = 150 KB). Its 16 warps walk the same points in order; warp w
//    applies the corners whose texel k has k % 16 == w, lane l channel l of
//    the slice, so every shared-memory element has one writer and takes its
//    contributions in point and corner order. The block stages 256 points at
//    a time in shared memory (their corner ids, rounded weights and gradient
//    slice, loaded coalesced); each warp compacts the corners it owns into a
//    list, in order, with a ballot, and walks only that list.
//    Each block writes its partial map, and a second kernel sums the partials
//    of the point ranges in range order. The result repeats bit for bit. K is
//    limited by shared memory (1,240 texels; a 480x640 image's layer3 has
//    1,200); the bound of the scatter is the
//    258 MB it reads and writes, but the shared-memory read-modify-write
//    chains make it latency bound at one block per SM: a later PR's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// the corner weight as the TPU kernel's one-hot row holds it: in T
__device__ __forceinline__ float round_w(float w, float) { return w; }
__device__ __forceinline__ float round_w(float w, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(w));
}

// V consecutive values of T at p (16-byte aligned when V > 1), as float
template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&f)[V]) {
  if constexpr (V == 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&q);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(h[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = __bfloat162float(p[i]);
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&f)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      f[i] = q.x, f[i + 1] = q.y, f[i + 2] = q.z, f[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = p[i];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(256)
    onehot_gather_fwd_kernel(const T* __restrict__ flat, const long long* __restrict__ idx,
                             const float* __restrict__ w4, float* __restrict__ out, int n,
                             int k, int c, long long total) {
  const int groups = c / V;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const long long pt = t / groups;  // b * n + p
    const int ch = static_cast<int>(t - pt * groups) * V;
    const T* fb = flat + (pt / n) * k * static_cast<long long>(c) + ch;
    float acc[V];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long kk = idx[pt * 4 + q];
      const float w = round_w(w4[pt * 4 + q], T());
      float f[V];
      load_vec<V>(fb + kk * c, f);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float prod = __fmul_rn(w, f[i]);
        acc[i] = q == 0 ? prod : __fadd_rn(acc[i], prod);
      }
    }
    float* o = out + pt * c + ch;
    if constexpr (V % 4 == 0) {
#pragma unroll
      for (int i = 0; i < V; i += 4)
        *reinterpret_cast<float4*>(o + i) = make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) o[i] = acc[i];
    }
  }
}

constexpr int kBwdWarps = 16;   // texel owners: k % kBwdWarps
constexpr int kSlice = 32;      // channels of a block (one per lane)
constexpr int kStagePts = 256;  // points staged at a time

size_t bwd_smem_bytes(int k) {
  return static_cast<size_t>(k) * kSlice * sizeof(float) +
         kStagePts * (4 * (sizeof(int) + sizeof(float)) + kSlice * sizeof(float)) +
         kBwdWarps * kStagePts * 4 * sizeof(unsigned short);
}

// grid (B, ceil(C / 32), S): block (b, slice, s) scatters points
// [s * chunk, min(n, (s + 1) * chunk)) of image b onto channels
// [32 slice, 32 slice + 32) of its partial map part[b][s] ([K, C] float32).
template <typename T>
__global__ void __launch_bounds__(kBwdWarps * 32)
    onehot_scatter_bwd_kernel(const T* __restrict__ g, const long long* __restrict__ idx,
                              const float* __restrict__ w4, float* __restrict__ part, int n,
                              int k, int c, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // disjoint regions of shared memory
  float* __restrict__ map = reinterpret_cast<float*>(smem_raw);  // [k][kSlice]
  int* __restrict__ sidx = reinterpret_cast<int*>(map + static_cast<size_t>(k) * kSlice);
  float* __restrict__ sw = reinterpret_cast<float*>(sidx + kStagePts * 4);  // rounded weights
  float* __restrict__ sg = sw + kStagePts * 4;  // [kStagePts][kSlice]
  // each warp's own corners of the staged points, in point and corner order
  unsigned short* __restrict__ list =
      reinterpret_cast<unsigned short*>(sg + kStagePts * kSlice) +
      (threadIdx.x >> 5) * kStagePts * 4;
  const int b = blockIdx.x;
  const int s = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int e = threadIdx.x; e < k * kSlice; e += blockDim.x) map[e] = 0.f;
  const long long base = static_cast<long long>(b) * n;
  const int p_begin = s * chunk;
  const int p_end = min(n, p_begin + chunk);
  for (int p0 = p_begin; p0 < p_end; p0 += kStagePts) {
    const int cnt = min(kStagePts, p_end - p0);
    __syncthreads();  // the previous batch of corners is consumed
    for (int e = threadIdx.x; e < cnt * 4; e += blockDim.x) {
      sidx[e] = static_cast<int>(idx[(base + p0) * 4 + e]);
      sw[e] = round_w(w4[(base + p0) * 4 + e], T());
    }
    for (int e = threadIdx.x; e < cnt * kSlice; e += blockDim.x) {
      const int cc = blockIdx.y * kSlice + e % kSlice;
      sg[e] = cc < c ? to_f(g[(base + p0 + e / kSlice) * c + cc]) : 0.f;
    }
    __syncthreads();
    int owned = 0;
    for (int e0 = 0; e0 < cnt * 4; e0 += 32) {
      const int e = e0 + lane;
      const bool mine = e < cnt * 4 && sidx[e] % kBwdWarps == warp;
      const unsigned m = __ballot_sync(0xffffffffu, mine);
      if (mine) list[owned + __popc(m & ((1u << lane) - 1u))] = static_cast<unsigned short>(e);
      owned += __popc(m);
    }
    __syncwarp();
    // a run of corners on one texel (consecutive samples of a ray) is summed
    // in a register and stored once: the same additions in the same order
    int cur = -1;
    float acc = 0.f;
#pragma unroll 4
    for (int i = 0; i < owned; ++i) {
      const int e = list[i];  // the same for the whole warp
      const int kk = sidx[e];
      const float prod = __fmul_rn(sw[e], sg[(e >> 2) * kSlice + lane]);
      if (kk != cur) {
        if (cur >= 0) map[cur * kSlice + lane] = acc;
        cur = kk;
        acc = map[kk * kSlice + lane];
      }
      acc = __fadd_rn(acc, prod);
    }
    if (cur >= 0) map[cur * kSlice + lane] = acc;
  }
  __syncthreads();
  float* dst = part + (static_cast<size_t>(b) * gridDim.z + s) * k * static_cast<size_t>(c);
  for (int e = threadIdx.x; e < k * kSlice; e += blockDim.x) {
    const int kk = e / kSlice;
    const int cc = blockIdx.y * kSlice + e % kSlice;
    if (cc < c) dst[static_cast<size_t>(kk) * c + cc] = map[e];
  }
}

// out[b][e] = sum over s, in order, of part[b][s][e] (e < k * c)
__global__ void reduce_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    int b_count, int s_count, long long kc) {
  const long long total = static_cast<long long>(b_count) * kc;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const long long b = t / kc;
    const long long e = t - b * kc;
    const float* p = part + b * s_count * kc + e;
    float acc = 0.f;
    for (int s = 0; s < s_count; ++s) acc = __fadd_rn(acc, p[s * kc]);
    out[t] = acc;
  }
}

unsigned grid_for(long long work, int threads) {
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  return static_cast<unsigned>(blocks > 0 ? blocks : 1);
}

template <typename T>
int gather_fwd(const void* flat, const void* idx, const void* w4, void* out, int b, int k,
               int c, int n, cudaStream_t s) {
  const auto* f = static_cast<const T*>(flat);
  const auto* ix = static_cast<const long long*>(idx);
  const auto* w = static_cast<const float*>(w4);
  auto* o = static_cast<float*>(out);
  const long long pts = static_cast<long long>(b) * n;
  constexpr int kVec = sizeof(T) == 2 ? 8 : 4;
  if (c % kVec == 0) {
    const long long total = pts * (c / kVec);
    onehot_gather_fwd_kernel<T, kVec><<<grid_for(total, 256), 256, 0, s>>>(f, ix, w, o, n, k, c,
                                                                          total);
  } else {
    const long long total = pts * c;
    onehot_gather_fwd_kernel<T, 1><<<grid_for(total, 256), 256, 0, s>>>(f, ix, w, o, n, k, c,
                                                                       total);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int scatter_bwd(const void* g, const void* idx, const void* w4, void* part, void* out, int b,
                int k, int c, int n, int splits, cudaStream_t s) {
  const size_t smem = bwd_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(onehot_scatter_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunk = (n + splits - 1) / splits;
  const dim3 grid(b, (c + kSlice - 1) / kSlice, splits);
  float* dst = splits == 1 ? static_cast<float*>(out) : static_cast<float*>(part);
  onehot_scatter_bwd_kernel<T><<<grid, kBwdWarps * 32, smem, s>>>(
      static_cast<const T*>(g), static_cast<const long long*>(idx),
      static_cast<const float*>(w4), dst, n, k, c, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long kc = static_cast<long long>(k) * c;
  reduce_parts_kernel<<<grid_for(b * kc, 256), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), b, splits, kc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// flat [b, k, c] (bf16 when is_f32 == 0, else float32), idx [b, n, 4] int64
// corner ids in [0, k), w4 [b, n, 4] float32 corner weights -> out [b, n, c]
// float32. 16-byte aligned, contiguous.
extern "C" int njf_onehot_gather_fwd(const void* flat, const void* idx, const void* w4,
                                     void* out, int b, int k, int c, int n, int is_f32,
                                     void* stream) {
  if (b <= 0 || k <= 0 || c <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return is_f32 ? gather_fwd<float>(flat, idx, w4, out, b, k, c, n, s)
                : gather_fwd<__nv_bfloat16>(flat, idx, w4, out, b, k, c, n, s);
}

// g [b, n, c] (bf16 when is_f32 == 0, else float32), idx / w4 as above ->
// out [b, k, c] float32. part: scratch [b, splits, k, c] float32 (unused when
// splits == 1). k <= 1240; 1 <= splits <= n.
extern "C" int njf_onehot_scatter_bwd(const void* g, const void* idx, const void* w4, void* part,
                                      void* out, int b, int k, int c, int n, int splits,
                                      int is_f32, void* stream) {
  if (b <= 0 || k <= 0 || k > 1240 || c <= 0 || n <= 0 || splits <= 0 || splits > n)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return is_f32 ? scatter_bwd<float>(g, idx, w4, part, out, b, k, c, n, splits, s)
                : scatter_bwd<__nv_bfloat16>(g, idx, w4, part, out, b, k, c, n, splits, s);
}
