// K1-bwd-small on Hopper: a row gather's backward for images whose entries
// and map fit one thread block, summed in shared memory in a fixed order.
//
// It replaces no Pallas site. JAX's interlevel loss takes its per-ray rows
// with a one-hot compare and reduce (outer_measure,
// neural_jacobian_field_tpu/ops/losses.py:20-51), whose backward XLA's
// autodiff sums in a fixed order. The port takes them with a row gather
// (ops/deterministic.gather_rows) and needs a backward that repeats bit for
// bit too; torch.gather's CUDA backward (scatter_add_) adds with atomics.
// It is row_scatter_plain with one entry a point and unit weights:
//   out[b, r, :] = sum over p in order with idx[b, p] == r of g[b, p, :]
// in float32 from 0, rounded once to g's type; a row no entry reaches is 0.
// ops/kernels/onehot_gather.small_plan admits a shape by its entries, map
// and shared memory; every other shape goes to the counting-sort scatter
// (njf_row_scatter), which is built for hundreds of thousands of entries.
//
// What bounds it on the H100, and what the design does about it: bytes, g
// and the ids read once and out written once (the interlevel loss: 1,792
// rays of 512 float32 entries and int64 ids onto 257 rows, 12.7 MB, 3.8 us
// at 3.35 TB/s), but the counting sort's five launches and scratch in HBM
// cost far more at these sizes. Here one block sorts one image in shared
// memory, in one launch with no scratch: it loads the ids, counts the
// entries per row with integer shared atomics (exact in any order), takes
// an exclusive block scan of the counts, places the entries stably (one
// warp walks them in order, 32 at a time, each ranked within its row by
// __match_any_sync), then sums each row's entries in entry order: a thread
// per row for one-wide rows, else a warp per (row, 32 channels). No
// floating-point atomics, so it repeats bit for bit, and it equals the plain
// version bit for bit. Any ids in [0, k) are taken; nothing assumes them
// sorted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxEntries = 4096;  // entries per image (16-bit positions in the list)
constexpr int kMaxSmem = 48 * 1024;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// one block per image b; dynamic shared memory: ids [n] int32, ends [k]
// int32 (counts, then first positions, then, after the placing, each row's
// end), list [n] uint16 (the entries sorted by row, stable)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    small_scatter_kernel(const T* __restrict__ g, const long long* __restrict__ idx,
                         T* __restrict__ out, int n, int k, int c) {
  extern __shared__ int smem[];
  __shared__ int warp_sums[kWarps];
  int* ids = smem;
  int* ends = ids + n;
  unsigned short* list = reinterpret_cast<unsigned short*>(ends + k);
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long* ib = idx + static_cast<size_t>(b) * n;
  for (int r = tid; r < k; r += kThreads) ends[r] = 0;
  __syncthreads();
  for (int e = tid; e < n; e += kThreads) {
    // an id outside [0, k) (torch.gather refuses them on the forward) is
    // dropped, never written through
    const long long id = ib[e];
    const int r = id >= 0 && id < k ? static_cast<int>(id) : -1;
    ids[e] = r;
    if (r >= 0) atomicAdd(ends + r, 1);
  }
  __syncthreads();
  // exclusive scan: thread tid owns rows [r0, r1), a contiguous run
  const int per = (k + kThreads - 1) / kThreads;
  const int r0 = min(k, tid * per), r1 = min(k, r0 + per);
  int own = 0;
  for (int r = r0; r < r1; ++r) own += ends[r];
  int incl = own;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += v;
    }
    if (lane < kWarps) warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  int run = (warp ? warp_sums[warp - 1] : 0) + incl - own;
  for (int r = r0; r < r1; ++r) {
    const int cnt = ends[r];
    ends[r] = run;
    run += cnt;
  }
  __syncthreads();
  // place, in entry order: entry e goes to its row's cursor plus its rank
  // among the step's entries of that row; the group's lowest lane advances
  // the cursor, which ends at the row's end
  if (warp == 0) {
    for (int base = 0; base < n; base += 32) {
      const int e = base + lane;
      const int r = e < n ? ids[e] : -1;
      const unsigned group = __match_any_sync(0xffffffffu, r);
      const int slot = r >= 0 ? ends[r] + __popc(group & ((1u << lane) - 1u)) : 0;
      __syncwarp();
      if (r >= 0 && lane == __ffs(group) - 1) ends[r] += __popc(group);
      __syncwarp();
      if (r >= 0) list[slot] = static_cast<unsigned short>(e);
    }
  }
  __syncthreads();
  const T* gb = g + static_cast<size_t>(b) * n * c;
  T* ob = out + static_cast<size_t>(b) * k * c;
  if (c == 1) {
    for (int r = tid; r < k; r += kThreads) {
      const int j1 = ends[r];
      float acc = 0.f;
      for (int j = r ? ends[r - 1] : 0; j < j1; ++j)
        acc = __fadd_rn(acc, to_float(gb[list[j]]));
      put(ob + r, acc);
    }
    return;
  }
  const int slabs = (c + 31) / 32;
  for (int item = warp; item < k * slabs; item += kWarps) {
    const int r = item / slabs, ch = (item - r * slabs) * 32 + lane;
    const int j1 = ends[r];
    float acc = 0.f;
    if (ch < c) {
      for (int j = r ? ends[r - 1] : 0; j < j1; ++j)
        acc = __fadd_rn(acc, to_float(gb[static_cast<size_t>(list[j]) * c + ch]));
      put(ob + static_cast<size_t>(r) * c + ch, acc);
    }
  }
}

}  // namespace

// g [b, n, c] (bf16 when is_f32 == 0, else float32), idx [b, n] int64 row
// ids in [0, k) -> out [b, k, c] in g's type. smem: the dynamic shared
// memory, 4 n + 4 k + 2 n bytes rounded up to 16 (onehot_gather.small_plan);
// n <= 4096.
extern "C" int njf_small_scatter(const void* g, const void* idx, void* out, int b, int k, int c,
                                 int n, int smem, int is_f32, void* stream) {
  if (b <= 0 || k <= 0 || c <= 0 || n <= 0 || n > kMaxEntries || smem > kMaxSmem ||
      static_cast<long long>(smem) < 6LL * n + 4LL * k)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_f32)
    small_scatter_kernel<float><<<b, kThreads, smem, s>>>(
        static_cast<const float*>(g), static_cast<const long long*>(idx),
        static_cast<float*>(out), n, k, c);
  else
    small_scatter_kernel<__nv_bfloat16><<<b, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const long long*>(idx),
        static_cast<__nv_bfloat16*>(out), n, k, c);
  return static_cast<int>(cudaGetLastError());
}
