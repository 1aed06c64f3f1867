// K6-fwd on Hopper: 2x2 patch packing of a feature level for row gathers.
//
// Replaces neural_jacobian_field_tpu/ops/pallas/pack2x2.py::_pack_fwd_pallas
// (body _fwd_kernel): [B, H, W, C] -> [B, H*W, 4C], where packed row (y, x) is
// [F(y, x), F(y, x+1), F(y+1, x), F(y+1, x+1)] and the +1 neighbours are
// clamped to the last row and column (the border texel is replicated).
//
// What bounds it on the H100: pure data movement, one read of the level
// (four times, mostly from L2) and one write of four times its size, so it is
// bound by device-memory write bandwidth. The design is a grid-stride copy in
// which each thread moves whole 16-byte vectors of a texel when the texel's
// width allows it (the host picks the widest unit that divides the texel), so
// consecutive threads write consecutive 16-byte chunks of the packed row.
// Any W and C: there is no shape gate.
//
// K6-bwd, in the same file, replaces pack2x2.py::_pack_bwd_pallas (body
// _bwd_kernel): the transposed fold. Texel (y, x) collects the four packed
// slots that copied it: its own slot 0; slot 1 of (y, x-1); slot 2 of (y-1, x);
// slot 3 of (y-1, x-1); plus, on the last column and row, the slots that
// replicated the border texel onto itself. The sums are taken in the TPU
// kernel's order, one rounding per addition in the data's type, so a float32
// or bf16 result is bit-exact against its plain version. It reads the packed
// gradient (four times the level) once, mostly from L2, and writes the level:
// bound by device-memory bandwidth, so each thread folds a 16-byte vector of
// channels where C allows it. Any W and C.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// I is the index type: 32-bit when the packed map has fewer than 2^31 units
// (every level of the model), which keeps the index arithmetic cheap.
template <typename T, typename I>
__global__ void pack2x2_kernel(const T* __restrict__ src, T* __restrict__ dst,
                               I H, I W, I CV, I total) {
  const I stride = static_cast<I>(gridDim.x) * blockDim.x;
  for (I i = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const I c = i % CV;
    I t = i / CV;
    const I q = t & 3;
    t >>= 2;
    const I xx = t % W;
    t /= W;
    const I yy = t % H;
    const I b = t / H;
    const I sy = min(yy + (q >> 1), H - 1);
    const I sx = min(xx + (q & 1), W - 1);
    dst[i] = src[((b * H + sy) * W + sx) * CV + c];
  }
}

template <typename T>
int launch(const void* src, void* dst, int B, int H, int W, long long row_bytes,
           cudaStream_t s) {
  const int cv = static_cast<int>(row_bytes / static_cast<long long>(sizeof(T)));
  const unsigned long long total =
      static_cast<unsigned long long>(B) * H * W * 4ull * cv;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  unsigned long long blocks = (total + threads - 1) / threads;
  if (blocks > 132ull * 64ull) blocks = 132ull * 64ull;
  const auto* sp = static_cast<const T*>(src);
  auto* dp = static_cast<T*>(dst);
  if (total < (1ull << 31))
    pack2x2_kernel<T, unsigned><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        sp, dp, H, W, cv, static_cast<unsigned>(total));
  else
    pack2x2_kernel<T, unsigned long long>
        <<<static_cast<unsigned>(blocks), threads, 0, s>>>(sp, dp, H, W, cv, total);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- K6-bwd

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// one addition rounded to T, as the TPU kernel's elementwise ops round
template <typename T>
__device__ __forceinline__ float add_r(float a, float b) {
  return to_f(from_f<T>(a + b));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// d[b, y, x, c0:c0+V] from the packed gradient g [B, H*W, 4C]: every thread
// folds V consecutive channels of one texel.
template <typename T, int V>
__global__ void pack2x2_bwd_kernel(const T* __restrict__ g, T* __restrict__ d, int H,
                                   int W, int C, long long total) {
  const int cv = C / V;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c0 = static_cast<int>(i % cv) * V;
    long long t = i / cv;
    const int xx = static_cast<int>(t % W);
    t /= W;
    const int yy = static_cast<int>(t % H);
    const long long b = t / H;
    // slot q of packed row (y, x), channels c0..c0+V-1
    auto slot = [&](int y, int x, int q) {
      return *reinterpret_cast<const Vec<T, V>*>(
          g + ((b * H + y) * W + x) * 4ll * C + static_cast<long long>(q) * C + c0);
    };
    // _bwd_kernel's unshift along x of slot q of row y, at column xx:
    // v[xx-1] (none at xx = 0), plus v[xx] itself on the last column
    auto unshift = [&](int y, int q, float (&u)[V]) {
      if (xx >= 1) {
        const Vec<T, V> left = slot(y, xx - 1, q);
#pragma unroll
        for (int k = 0; k < V; ++k) u[k] = to_f(left.v[k]);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) u[k] = 0.f;
      }
      if (xx == W - 1) {
        const Vec<T, V> self = slot(y, xx, q);
#pragma unroll
        for (int k = 0; k < V; ++k) u[k] = add_r<T>(u[k], to_f(self.v[k]));
      }
    };
    float acc[V], u[V];
    const Vec<T, V> own = slot(yy, xx, 0);
    unshift(yy, 1, u);
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = add_r<T>(to_f(own.v[k]), u[k]);
    if (yy >= 1) {  // slots 2 and 3 of the row above
      const Vec<T, V> above = slot(yy - 1, xx, 2);
      unshift(yy - 1, 3, u);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = add_r<T>(acc[k], add_r<T>(to_f(above.v[k]), u[k]));
    }
    if (yy == H - 1) {  // the last row replicated onto itself
      const Vec<T, V> dup = slot(yy, xx, 2);
      unshift(yy, 3, u);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = add_r<T>(acc[k], add_r<T>(to_f(dup.v[k]), u[k]));
    }
    Vec<T, V> out;
#pragma unroll
    for (int k = 0; k < V; ++k) out.v[k] = from_f<T>(acc[k]);
    *reinterpret_cast<Vec<T, V>*>(d + i * V) = out;
  }
}

template <typename T, int V>
int launch_bwd(const void* g, void* d, int B, int H, int W, int C, cudaStream_t s) {
  const long long total = static_cast<long long>(B) * H * W * (C / V);
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132ll * 64ll) blocks = 132ll * 64ll;
  pack2x2_bwd_kernel<T, V><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
      static_cast<const T*>(g), static_cast<T*>(d), H, W, C, total);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_t(const void* g, void* d, int B, int H, int W, int C, cudaStream_t s) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  const uintptr_t align = reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(d);
  if (C % kV == 0 && align % 16 == 0) return launch_bwd<T, kV>(g, d, B, H, W, C, s);
  return launch_bwd<T, 1>(g, d, B, H, W, C, s);
}

}  // namespace

// g [B, H*W, 4C] -> d [B, H, W, C]; dtype 0 = float32, 1 = bfloat16.
extern "C" int njf_pack2x2_bwd(const void* g, void* d, int B, int H, int W, int C,
                               int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd_t<float>(g, d, B, H, W, C, s);
  if (dtype == 1) return launch_bwd_t<__nv_bfloat16>(g, d, B, H, W, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// row_bytes = C * element size: the packing is type-agnostic, so the texel is
// moved in the widest unit (16, 8, 4, 2 or 1 bytes) that divides it and the
// pointers' alignment.
extern "C" int njf_pack2x2_fwd(const void* src, void* dst, int B, int H, int W,
                               long long row_bytes, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || row_bytes <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) |
                          reinterpret_cast<uintptr_t>(dst) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0) return launch<uint4>(src, dst, B, H, W, row_bytes, s);
  if (align % 8 == 0) return launch<uint2>(src, dst, B, H, W, row_bytes, s);
  if (align % 4 == 0) return launch<uint32_t>(src, dst, B, H, W, row_bytes, s);
  if (align % 2 == 0) return launch<uint16_t>(src, dst, B, H, W, row_bytes, s);
  return launch<uint8_t>(src, dst, B, H, W, row_bytes, s);
}
