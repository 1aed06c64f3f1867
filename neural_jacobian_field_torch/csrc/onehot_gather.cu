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
//    along the epipolar lines some texels take thousands. Its bound is the
//    266 MB it must read and write (g 235 MB in bf16, idx, w4, gF), 0.079
//    ms. Float atomics would make the sum's order, and so its bits, change
//    from run to run; a map kept in shared memory caps K and serialises a
//    hot texel's contributions. Instead the corner entries are sorted by
//    texel (a stable integer counting sort), and warps sum fixed-length
//    pieces of the sorted list, so a hot texel spreads over many warps and
//    every warp does the same work; g is read row by row as 16-byte loads,
//    about once from HBM when one image's g fits in L2 (33.5 MB of bf16 at
//    the train shapes), and the 4 corners' reads of a row hit L2. Partial
//    rows of texels cut by piece boundaries are added in piece order by a
//    last pass. The stages are described below, at the kernels.
//
// The same function, generalised, is the fixed-order backward of the port's
// other gathers (K1-bwd-rows: njf_row_scatter,
// ops/kernels/onehot_gather.row_scatter): Q entries per point (Q = 1: a row
// gather, whose gradient rows arrive already weighted; Q = 4: bilinear
// corners), rows of any width, the weights optional (unit: the row is added
// as it is), one table of ids per image or one for all. It replaces
// torch.gather's backward (scatter_add_, whose CUDA sums are atomic and
// change their order from run to run) in the pyramid's packed-row gathers,
// the epipolar knots and the concat layout's bilinear lookups: so a train
// step repeats bit for bit, as the JAX step does on the CPU or the TPU.
// Its output is in g's type (a bf16 gather's gradient is bf16: the float32
// sums are rounded once, as they are written). Its shapes are not K1-bwd's:
// 7 x 65,536 rows of 512 bf16 onto 240x320 = 76,800 texels at the exact
// mode's fine level (1 GB to move, 0.306 ms at 3.35 TB/s, most of it g
// read once and out written once), or 7 x 16,384 knots onto the same map,
// where four texels in five take no entry and their zero rows are most of
// the bytes. A texel-granular sort over the whole map (K1-bwd's) spends
// its time in a scan of 76,800 texels per image and in a merge pass over
// every texel; here the sort is by blocks of texels and each block's rows
// are finished on chip, in three launches (the stages at the kernels below).
// Two small uses have kernels of their own, built for their shapes: the
// interlevel loss's per-ray rows (csrc/small_scatter.cu, where
// onehot_gather.small_plan admits the shape) and the encoder's bilinear
// upsampling (csrc/upsample_bwd.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// ---------------------------------------------------------------- K1-bwd
//
// Three stages on the current stream, planned by onehot_gather.bwd_plan:
//  (a) bucket: per image, a stable counting sort of the 4 n entries
//      (entry id 4 p + corner, int32) by texel, into CSR order: integer
//      histograms per tile of entries (bucket_count), the exclusive scan over
//      (texel, tile) (bucket_scan), and stable in-tile ranks by
//      __match_any_sync and a running count per texel (bucket_place). A
//      texel's entries keep their (point, corner) order.
//  (b) segment sums: each image's CSR list is cut into pieces of `piece`
//      entries; one warp walks a piece, lane l holding channels 8l..8l+7 of
//      the running float32 sum (one 16-byte bf16 load per lane and entry at
//      C = 256), products and sums in list order. A texel that lies inside
//      one piece writes its gF row; the texel open at a piece's start (one
//      that began in an earlier piece) or at its end writes a partial row
//      into the piece's slot 0 or 1. Pieces are walked image by image, and
//      the plan makes them short enough (64 entries at the train shapes)
//      that one image has more warps than the card holds at once: the warps
//      in flight read about one image's g, which stays in L2 while its four
//      corners read it (with 512-entry pieces five images were in flight,
//      and g was read from HBM about four times: 0.62 against 0.21 ms of
//      this stage's device time on an H100 SXM at 700 W).
//  (c) merge: a texel cut by piece boundaries is the sum of its partials in
//      piece order (slot 1 of its first piece, then slot 0 of each later
//      one); a texel no point touches is a row of zeros.
// No floating-point atomics and no order that depends on timing: the result
// repeats bit for bit. Integer shared-memory (or, for large K, global)
// counters add in any order to the same counts. K is limited only by int32
// entry ids and offsets.

constexpr int kSlabCh = 256;  // channels of a warp: 8 per lane
constexpr int kUnroll = 8;    // g rows in flight per warp
constexpr int kPlaceWarps = 4;
constexpr int kPlaceBatch = 8;  // steps of 32 entries whose texel ids load at once
constexpr int kMergeBatch = 4;  // partial rows in flight per warp in the merge

// (a1) cnt[b][t][k] = entries of tile t (entries [t * tile, (t + 1) * tile))
// on texel k. kSmem: counted in shared memory, then written; else counted
// straight into cnt (zeroed beforehand).
template <bool kSmem>
__global__ void __launch_bounds__(256)
    bucket_count_kernel(const long long* __restrict__ idx, int* __restrict__ cnt, int e_total,
                        int k, int tile, int tiles) {
  extern __shared__ int hist_smem[];
  const int t = blockIdx.x, b = blockIdx.y;
  int* col = cnt + (static_cast<size_t>(b) * tiles + t) * k;
  int* h = kSmem ? hist_smem : col;
  if (kSmem) {
    for (int i = threadIdx.x; i < k; i += blockDim.x) h[i] = 0;
    __syncthreads();
  }
  const long long* ib = idx + static_cast<size_t>(b) * e_total;
  const int e1 = min(e_total, (t + 1) * tile);
  for (int e = t * tile + threadIdx.x; e < e1; e += blockDim.x)
    atomicAdd(h + static_cast<int>(ib[e]), 1);
  if (kSmem) {
    __syncthreads();
    for (int i = threadIdx.x; i < k; i += blockDim.x) col[i] = h[i];
  }
}

// (a2) per image (one block): rowptr[b][kk] = entries on texels < kk, and
// cnt[b][t][kk] := rowptr[b][kk] + entries of tiles < t on texel kk (the
// first CSR position of tile t's entries on kk); rowptr[b][k] = e_total.
__global__ void __launch_bounds__(1024)
    bucket_scan_kernel(int* __restrict__ cnt, int* __restrict__ rowptr, int k, int tiles,
                       int e_total) {
  __shared__ int warp_sums[32];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* cb = cnt + static_cast<size_t>(b) * tiles * k;
  int* rp = rowptr + static_cast<size_t>(b) * (k + 1);
  int carry = 0;
  for (int k0 = 0; k0 < k; k0 += blockDim.x) {
    const int kk = k0 + threadIdx.x;
    int tot = 0;
    if (kk < k)
      for (int t = 0; t < tiles; ++t) tot += cb[static_cast<size_t>(t) * k + kk];
    int incl = tot;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int s = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, s, off);
        if (lane >= off) s += v;
      }
      warp_sums[lane] = s;  // inclusive over warps
    }
    __syncthreads();
    const int excl = carry + (warp ? warp_sums[warp - 1] : 0) + incl - tot;
    if (kk < k) {
      rp[kk] = excl;
      int run = excl;
      for (int t = 0; t < tiles; ++t) {
        int* p = cb + static_cast<size_t>(t) * k + kk;
        const int c = *p;
        *p = run;
        run += c;
      }
    }
    carry += warp_sums[(blockDim.x >> 5) - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) rp[k] = e_total;
}

// (a3) one warp per tile walks its entries in order, 32 at a time: equal
// texels in the step are grouped by __match_any_sync, each entry's slot is
// its texel's running position plus its rank in the group, and the group's
// lowest lane advances the position. ent[b][slot] = entry id. The texel ids
// of kPlaceBatch steps are loaded at once, so a warp waits on one load per
// batch, not per step.
template <bool kSmem>
__global__ void __launch_bounds__(kPlaceWarps * 32)
    bucket_place_kernel(const long long* __restrict__ idx, int* __restrict__ cnt,
                        int* __restrict__ ent, int e_total, int k, int tile, int tiles) {
  extern __shared__ int cur_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * kPlaceWarps + warp, b = blockIdx.y;
  if (t >= tiles) return;  // warp-level synchronisation only below
  int* col = cnt + (static_cast<size_t>(b) * tiles + t) * k;
  int* cur = kSmem ? cur_smem + static_cast<size_t>(warp) * k : col;
  if (kSmem)
    for (int i = lane; i < k; i += 32) cur[i] = col[i];
  __syncwarp();
  const long long* ib = idx + static_cast<size_t>(b) * e_total;
  int* eb = ent + static_cast<size_t>(b) * e_total;
  const int e1 = min(e_total, (t + 1) * tile);
  for (int base = t * tile; base < e1; base += 32 * kPlaceBatch) {
    int keys[kPlaceBatch];
#pragma unroll
    for (int u = 0; u < kPlaceBatch; ++u) {
      const int e = base + 32 * u + lane;
      keys[u] = e < e1 ? static_cast<int>(ib[e]) : k;  // k: past the tile
    }
#pragma unroll
    for (int u = 0; u < kPlaceBatch; ++u) {
      const int kk = keys[u];
      const unsigned group = __match_any_sync(0xffffffffu, kk);
      const int slot = kk < k ? cur[kk] + __popc(group & ((1u << lane) - 1u)) : 0;
      __syncwarp();
      if (kk < k && lane == __ffs(group) - 1) cur[kk] += __popc(group);
      __syncwarp();
      if (kk < k) eb[slot] = base + 32 * u + lane;
    }
  }
}

// 8 channels of a row of g from channel ch, kept as loaded (16 bytes of
// bf16, 32 of float32) and read as float; zeros past c. vec: c % 8 == 0.
template <typename T>
struct Row8;

template <>
struct Row8<__nv_bfloat16> {
  uint4 q;
  template <bool kVec>
  __device__ __forceinline__ void load(const __nv_bfloat16* row, int ch, int c) {
    if (kVec) {
      q = ch < c ? *reinterpret_cast<const uint4*>(row + ch) : make_uint4(0, 0, 0, 0);
    } else {
      __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&q);
#pragma unroll
      for (int i = 0; i < 8; ++i) h[i] = ch + i < c ? row[ch + i] : __float2bfloat16(0.f);
    }
  }
  __device__ __forceinline__ float get(int i) const {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&q)[i]);
  }
};

template <>
struct Row8<float> {
  float4 lo, hi;
  template <bool kVec>
  __device__ __forceinline__ void load(const float* row, int ch, int c) {
    if (kVec) {
      const bool in = ch < c;
      lo = in ? *reinterpret_cast<const float4*>(row + ch) : make_float4(0.f, 0.f, 0.f, 0.f);
      hi = in ? *reinterpret_cast<const float4*>(row + ch + 4) : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      float f[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = ch + i < c ? row[ch + i] : 0.f;
      lo = make_float4(f[0], f[1], f[2], f[3]);
      hi = make_float4(f[4], f[5], f[6], f[7]);
    }
  }
  __device__ __forceinline__ float get(int i) const {
    const float4& v = i < 4 ? lo : hi;
    const int j = i & 3;
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
};

template <bool kVec>
__device__ __forceinline__ void store_row8(float* row, int ch, int c, const float (&a)[8]) {
  if (kVec) {
    if (ch < c) {
      *reinterpret_cast<float4*>(row + ch) = make_float4(a[0], a[1], a[2], a[3]);
      *reinterpret_cast<float4*>(row + ch + 4) = make_float4(a[4], a[5], a[6], a[7]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (ch + i < c) row[ch + i] = a[i];
  }
}

// the same row rounded to bf16 (to nearest even, as a tensor's cast rounds)
template <bool kVec>
__device__ __forceinline__ void store_row8(__nv_bfloat16* row, int ch, int c,
                                           const float (&a)[8]) {
  if (kVec) {
    if (ch < c) {
      uint4 q;
      __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&q);
#pragma unroll
      for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16(a[i]);
      *reinterpret_cast<uint4*>(row + ch) = q;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (ch + i < c) row[ch + i] = __float2bfloat16(a[i]);
  }
}

// (b) warp gw = ((b * chunks) + piece) * slabs + slab walks CSR entries
// [piece * len, min(4 n, (piece + 1) * len)) of image b on channels
// [256 slab, 256 slab + 256). part[b][piece][slot][c] and the rows inside
// one piece, out, are float32. Entry e adds row e / 4 of g times its
// weight w4[e].
template <typename T, bool kVec>
__global__ void __launch_bounds__(128)
    segment_sum_kernel(const T* __restrict__ g, const float* __restrict__ w4,
                       const int* __restrict__ rowptr, const int* __restrict__ ent,
                       float* __restrict__ part, float* __restrict__ out, int b_count, int n,
                       int k, int c, int len, int chunks, int slabs) {
  const int lane = threadIdx.x & 31;
  const long long gw = static_cast<long long>(blockIdx.x) * 4 + (threadIdx.x >> 5);
  if (gw >= static_cast<long long>(b_count) * chunks * slabs) return;
  const int b = static_cast<int>(gw / (static_cast<long long>(chunks) * slabs));
  const int r = static_cast<int>(gw - static_cast<long long>(b) * chunks * slabs);
  const int piece = r / slabs, slab = r - piece * slabs;
  const int e_total = 4 * n;
  const int i0 = piece * len, i1 = min(e_total, i0 + len);
  const int* rp = rowptr + static_cast<size_t>(b) * (k + 1);
  const int* eb = ent + static_cast<size_t>(b) * e_total;
  const float* wb = w4 + static_cast<size_t>(b) * e_total;
  const T* gb = g + static_cast<size_t>(b) * n * c;
  const int ch = slab * kSlabCh + 8 * lane;
  // the texel of entry i0: the last kk with rp[kk] <= i0 (it is not empty)
  int lo = 0, hi = k - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (rp[mid] <= i0)
      lo = mid;
    else
      hi = mid - 1;
  }
  int kk = lo, bound = rp[kk + 1];
  float acc[8] = {};
  bool fresh = true;  // acc holds no term of texel kk yet
  auto flush = [&]() {
    if (rp[kk] < i0)
      store_row8<kVec>(part + (static_cast<size_t>(b) * chunks + piece) * 2 * c, ch, c, acc);
    else if (rp[kk + 1] > i1)
      store_row8<kVec>(part + ((static_cast<size_t>(b) * chunks + piece) * 2 + 1) * c, ch, c,
                       acc);
    else
      store_row8<kVec>(out + (static_cast<size_t>(b) * k + kk) * c, ch, c, acc);
  };
  // the entry ids of the next 32 positions load while this step's rows do
  int next_e = i0 + lane < i1 ? eb[i0 + lane] : 0;
  for (int base = i0; base < i1; base += 32) {
    const int cnt = min(32, i1 - base);
    const int my_e = next_e;
    if (base + 32 < i1) next_e = base + 32 + lane < i1 ? eb[base + 32 + lane] : 0;
    const float my_w = lane < cnt ? round_w(wb[my_e], T()) : 0.f;
    for (int j0 = 0; j0 < cnt; j0 += kUnroll) {
      Row8<T> rows[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = __shfl_sync(0xffffffffu, my_e, j0 + u);
        if (j0 + u < cnt) rows[u].template load<kVec>(gb + static_cast<size_t>(e / 4) * c, ch, c);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j0 + u >= cnt) break;
        const float wv = __shfl_sync(0xffffffffu, my_w, j0 + u);
        const int ii = base + j0 + u;
        while (ii == bound) {  // texel kk ends before entry ii
          if (!fresh) flush();
          fresh = true;
          ++kk;
          bound = rp[kk + 1];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float prod = __fmul_rn(wv, rows[u].get(i));
          acc[i] = fresh ? prod : __fadd_rn(acc[i], prod);
        }
        fresh = false;
      }
    }
  }
  if (!fresh) flush();
}

// (c) one warp per (image, texel): zeros for an untouched texel, the sum of
// its partials in piece order for a texel cut by piece boundaries, nothing
// (the segment pass wrote it) for a texel inside one piece.
template <bool kVec>
__global__ void __launch_bounds__(256)
    merge_parts_kernel(const int* __restrict__ rowptr, const float* __restrict__ part,
                       float* __restrict__ out, int b_count, int k, int c, int len,
                       int chunks) {
  const int lane = threadIdx.x & 31;
  const long long gw = static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (gw >= static_cast<long long>(b_count) * k) return;
  const int b = static_cast<int>(gw / k), kk = static_cast<int>(gw - static_cast<long long>(b) * k);
  const int s = rowptr[static_cast<size_t>(b) * (k + 1) + kk];
  const int e = rowptr[static_cast<size_t>(b) * (k + 1) + kk + 1];
  float* dst = out + static_cast<size_t>(gw) * c;
  if (s == e) {
    for (int i = lane; i < c; i += 32) dst[i] = 0.f;
    return;
  }
  const int first = s / len, last = (e - 1) / len;
  if (first == last) return;
  const float* pb = part + static_cast<size_t>(b) * chunks * 2 * c;
  for (int ch = 8 * lane; ch < c; ch += 8 * 32) {
    Row8<float> row;
    row.load<kVec>(pb + (static_cast<size_t>(first) * 2 + 1) * c, ch, c);
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = row.get(i);
    for (int p0 = first + 1; p0 <= last; p0 += kMergeBatch) {  // slot 0 of later pieces
      Row8<float> rows[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u)
        if (p0 + u <= last) rows[u].load<kVec>(pb + static_cast<size_t>(p0 + u) * 2 * c, ch, c);
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        if (p0 + u > last) break;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = __fadd_rn(acc[i], rows[u].get(i));
      }
    }
    store_row8<kVec>(dst, ch, c, acc);
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
int scatter_bwd(const void* g, const void* idx, const void* w4, void* iscratch, void* part,
                void* out, int b, int k, int c, int n, int tile, int tiles, int len,
                bool smem_hist, cudaStream_t s) {
  const int e_total = 4 * n;
  int* cnt = static_cast<int*>(iscratch);  // [b][tiles][k]
  int* rowptr = cnt + static_cast<size_t>(b) * tiles * k;  // [b][k + 1]
  int* ent = rowptr + static_cast<size_t>(b) * (k + 1);     // [b][4 n]
  const auto* ix = static_cast<const long long*>(idx);
  const dim3 tgrid(tiles, b);
  if (smem_hist) {
    bucket_count_kernel<true><<<tgrid, 256, k * sizeof(int), s>>>(ix, cnt, e_total, k, tile, tiles);
  } else {
    cudaMemsetAsync(cnt, 0, static_cast<size_t>(b) * tiles * k * sizeof(int), s);
    bucket_count_kernel<false><<<tgrid, 256, 0, s>>>(ix, cnt, e_total, k, tile, tiles);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bucket_scan_kernel<<<b, 1024, 0, s>>>(cnt, rowptr, k, tiles, e_total);
  const dim3 pgrid((tiles + kPlaceWarps - 1) / kPlaceWarps, b);
  if (smem_hist) {
    const size_t smem = static_cast<size_t>(kPlaceWarps) * k * sizeof(int);
    err = cudaFuncSetAttribute(bucket_place_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    bucket_place_kernel<true><<<pgrid, kPlaceWarps * 32, smem, s>>>(ix, cnt, ent, e_total, k, tile,
                                                                    tiles);
  } else {
    bucket_place_kernel<false><<<pgrid, kPlaceWarps * 32, 0, s>>>(ix, cnt, ent, e_total, k, tile,
                                                                 tiles);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (e_total + len - 1) / len, slabs = (c + kSlabCh - 1) / kSlabCh;
  const long long warps = static_cast<long long>(b) * chunks * slabs;
  const unsigned sblocks = static_cast<unsigned>((warps + 3) / 4);
  const auto* gg = static_cast<const T*>(g);
  const auto* w = static_cast<const float*>(w4);
  auto* pp = static_cast<float*>(part);
  auto* o = static_cast<float*>(out);
  if (c % 8 == 0)
    segment_sum_kernel<T, true><<<sblocks, 128, 0, s>>>(
        gg, w, rowptr, ent, pp, o, b, n, k, c, len, chunks, slabs);
  else
    segment_sum_kernel<T, false><<<sblocks, 128, 0, s>>>(
        gg, w, rowptr, ent, pp, o, b, n, k, c, len, chunks, slabs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned mblocks = static_cast<unsigned>((static_cast<long long>(b) * k + 7) / 8);
  if (c % 8 == 0)
    merge_parts_kernel<true><<<mblocks, 256, 0, s>>>(rowptr, pp, o, b, k, c, len, chunks);
  else
    merge_parts_kernel<false><<<mblocks, 256, 0, s>>>(rowptr, pp, o, b, k, c, len, chunks);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------- K1-bwd-rows
//
// Three launches on the current stream, planned by onehot_gather.rows_plan.
// The texels are cut into blocks of tb = 2^log_tb consecutive rows (tb in
// [8, 1024]; the plan makes the blocks small enough that the images and
// slabs give every SM several thread blocks), and a table's E = Q n entries
// into tiles of `te`.
//  (a) rows_bucket: a thread block per (tile, table) sorts the tile's
//      entries by texel block, stably, in shared memory: each warp counts a
//      contiguous eighth of the tile (32 entries a step, grouped by
//      __match_any_sync), the counts' prefix over the warps and an
//      exclusive scan over the blocks give every (warp, block) its first
//      position, and the same walk places each entry id (and, beside it,
//      its texel's place in the block) at its position in the tile's list.
//      tstart[table][blk][tile] = where block blk's entries begin in that
//      list (one column per tile; row nblk: the tile's end). Nothing is
//      scanned across tiles or images. The plan makes the tiles small (256
//      entries at least) where a call has fewer than one per SM.
//  (b) rows_sort: a thread block per (texel block, table) scans tstart's
//      row of its block over the tiles (its list is the tiles' runs in tile
//      order: entry order) and sorts that list by texel, stably, as (a)
//      sorts a tile (per-warp counts over tb texels, prefix, place). The
//      same row's sum is the number of the table's entries in lower blocks,
//      so each block writes its sorted ids to their own contiguous range of
//      `sorted`, the table's ids sorted by block, then texel, with no scan
//      across blocks; each texel's first position goes to `tex`. A warp
//      walks its share in chunks of 8 x 32 entries loaded together (a hot
//      block's share is longer than one chunk).
//  (c) rows_sum: a thread block per (texel block, image, slab of 256
//      channels): it loads its texels' starts and nothing else, and its
//      warps take items of `item_texels` texels from a shared counter and
//      walk their entries in sorted order, eight g rows in flight (16-byte
//      loads; the next 32 ids load while a chunk's rows do), each texel's
//      sum from 0 in entry order, and write the slab of every row of the
//      item once, zero rows included, as they close. A texel with more than
//      `piece` entries is cut into P <= 32 pieces of max(piece, ceil(cnt /
//      32)) entries, each summed from 0 by one warp: the block's first 64
//      pieces (whole texels) are the first items of the queue, the longest
//      walks first; the partial rows meet in shared memory, and the warp
//      that sums a texel's last piece adds them from 0 in piece order and
//      writes the row. A block with more pieces sums the rest texel by
//      texel after the queue. The cut depends only on the count, never on
//      timing. A slab a block: a texel that takes thousands of entries
//      (along an epipolar line) is summed by as many blocks as its row has
//      slabs. In a dense call on few thread blocks (the exact mid level,
//      the lookups, whose hot rows would hold one SM) the plan deals each
//      (texel block, image, slab) to `splits` thread blocks, which share
//      its items and pieces in turn; their partial rows meet in global
//      scratch instead, added in the same order.
// So the result is, per texel, the plain version's sum (from 0, in entry
// order) where cnt <= piece, bit for bit, and the pieces' order above it.
// Integer counters only; no floating-point atomics; the shared item counter
// decides which warp sums an item, never how.

constexpr int kRowsThreads = 256;
constexpr int kRowsWarps = kRowsThreads / 32;  // also the most pieces of a texel

// exclusive prefix of `own` over the block's threads in thread order;
// *total: the sum over all. Every thread must call it (it synchronises).
__device__ __forceinline__ int block_exclusive_scan(int own, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = own;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kRowsWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < kRowsWarps; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += v;
    }
    if (lane < kRowsWarps) warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  const int excl = (warp ? warp_sums[warp - 1] : 0) + incl - own;
  *total = warp_sums[kRowsWarps - 1];
  __syncthreads();  // warp_sums free again
  return excl;
}

// (a) blockIdx.x: tile t, blockIdx.y: table; it also zeroes gdone[ndone],
// the counts of rows_sum's dealt pieces. Dynamic shared memory:
// unsigned short cw[kRowsWarps][nblk], counts, then positions (te <= 32768).
// list: each entry's id; lrow, beside it: its texel's place in its block.
// An id outside [0, k) is placed nowhere (torch.gather refuses it).
__global__ void __launch_bounds__(kRowsThreads)
    rows_bucket_kernel(const long long* __restrict__ idx, int* __restrict__ list,
                       unsigned short* __restrict__ lrow, int* __restrict__ tstart,
                       int* __restrict__ gdone, int ndone, int e_total, int k, int log_tb,
                       int nblk, int te, int nt) {
  extern __shared__ unsigned short rows_cw[];
  __shared__ int warp_sums[kRowsWarps];
  const int t = blockIdx.x, tbl = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the dealt sums' piece counts start at zero (ndone 0: none)
  for (int i = (tbl * nt + t) * kRowsThreads + threadIdx.x; i < ndone;
       i += nt * gridDim.y * kRowsThreads)
    gdone[i] = 0;
  for (int i = threadIdx.x; i < kRowsWarps * nblk; i += kRowsThreads) rows_cw[i] = 0;
  __syncthreads();
  const long long* ib = idx + static_cast<size_t>(tbl) * e_total;
  const int per = te / kRowsWarps;
  const int e0 = min(e_total, t * te + warp * per), e1 = min(e_total, e0 + per);
  unsigned short* mine = rows_cw + warp * nblk;
  auto block_of = [&](int e) -> int {  // -1: past the warp's range, or no texel
    if (e >= e1) return -1;
    const long long id = ib[e];
    return id >= 0 && id < k ? static_cast<int>(id >> log_tb) : -1;
  };
  for (int base = e0; base < e1; base += 32) {
    const int blk = block_of(base + lane);
    const unsigned grp = __match_any_sync(0xffffffffu, blk);
    if (blk >= 0 && lane == __ffs(grp) - 1) mine[blk] += __popc(grp);
    __syncwarp();
  }
  __syncthreads();
  // thread i owns blocks [i * span, (i + 1) * span)
  const int span = (nblk + kRowsThreads - 1) / kRowsThreads;
  const int b0 = min(nblk, static_cast<int>(threadIdx.x) * span), b1 = min(nblk, b0 + span);
  int own = 0;
  for (int blk = b0; blk < b1; ++blk)
    for (int w = 0; w < kRowsWarps; ++w) own += rows_cw[w * nblk + blk];
  int total;
  int start = block_exclusive_scan(own, warp_sums, &total);
  int* col = tstart + static_cast<size_t>(tbl) * (nblk + 1) * nt + t;
  for (int blk = b0; blk < b1; ++blk) {
    col[static_cast<size_t>(blk) * nt] = start;
    for (int w = 0; w < kRowsWarps; ++w) {
      const int cnt = rows_cw[w * nblk + blk];
      rows_cw[w * nblk + blk] = static_cast<unsigned short>(start);
      start += cnt;
    }
  }
  if (threadIdx.x == 0) col[static_cast<size_t>(nblk) * nt] = total;
  __syncthreads();
  const size_t lt = static_cast<size_t>(tbl) * e_total + static_cast<size_t>(t) * te;
  for (int base = e0; base < e1; base += 32) {
    const int blk = block_of(base + lane);
    const unsigned grp = __match_any_sync(0xffffffffu, blk);
    if (blk >= 0) {
      const size_t at = lt + mine[blk] + __popc(grp & ((1u << lane) - 1u));
      list[at] = base + lane;
      lrow[at] = static_cast<unsigned short>(ib[base + lane] & ((1 << log_tb) - 1));
    }
    __syncwarp();
    if (blk >= 0 && lane == __ffs(grp) - 1) mine[blk] += __popc(grp);
    __syncwarp();
  }
}

// acc += the products of sorted positions [i0, i1) in order (8 channels
// from ch; one warp): `pos_id(p)` is the entry id at sorted position p,
// `before(ii, acc)` runs before position ii is added (the caller closes
// texels there). Entry e is row e / Q of gb, times its weight wb[e] (kW).
// The ids of the next 32 positions load while this step's rows do; kUnroll
// g rows are in flight, float32 rows too (a hot texel's walk is bound by
// latency, not by registers).
template <typename T, bool kVec, int Q, bool kW, typename PosId, typename Before>
__device__ __forceinline__ void walk_rows(const T* gb, const float* wb, int c, int ch, int i0,
                                          int i1, PosId pos_id, Before before, float (&acc)[8]) {
  const int lane = threadIdx.x & 31;
  int next_e = i0 + lane < i1 ? pos_id(i0 + lane) : 0;
  for (int base = i0; base < i1; base += 32) {
    const int cnt = min(32, i1 - base);
    const int my_e = next_e;
    if (base + 32 < i1) next_e = base + 32 + lane < i1 ? pos_id(base + 32 + lane) : 0;
    const float my_w = kW && lane < cnt ? round_w(wb[my_e], T()) : 0.f;
    for (int j0 = 0; j0 < cnt; j0 += kUnroll) {
      Row8<T> rows[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = __shfl_sync(0xffffffffu, my_e, (j0 + u) & 31);
        if (j0 + u < cnt) rows[u].template load<kVec>(gb + static_cast<size_t>(e / Q) * c, ch, c);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j0 + u >= cnt) break;
        const float wv = kW ? __shfl_sync(0xffffffffu, my_w, j0 + u) : 1.f;
        before(base + j0 + u, acc);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc[i] = __fadd_rn(acc[i], kW ? __fmul_rn(wv, rows[u].get(i)) : rows[u].get(i));
      }
    }
  }
}

// the same for 64-bit values (fields packed in one value add without carry)
__device__ __forceinline__ long long block_exclusive_scan64(long long own, long long* warp_sums,
                                                            long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long incl = own;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    long long s = lane < kRowsWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < kRowsWarps; off <<= 1) {
      const long long v = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += v;
    }
    if (lane < kRowsWarps) warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  const long long excl = (warp ? warp_sums[warp - 1] : 0) + incl - own;
  *total = warp_sums[kRowsWarps - 1];
  __syncthreads();  // warp_sums free again
  return excl;
}

// block blk's runs in the tiles' lists (tstart's row, [nblk + 1][nt] from
// col): pre[t] = the block's list position where tile t's run begins
// (pre[nt] = m, its entries), sbase[t] = that run's slot in the table's
// list; returns the entries of the blocks before blk (the sum of col[t]:
// each tile's entries of lower blocks), where the block's sorted list
// begins. Every thread must call it (it synchronises).
__device__ __forceinline__ int block_runs(const int* col, int nt, int te, int* pre, int* sbase,
                                          long long* warp_sums) {
  const int span = (nt + kRowsThreads - 1) / kRowsThreads;
  const int t0 = min(nt, static_cast<int>(threadIdx.x) * span), t1 = min(nt, t0 + span);
  long long own = 0;  // (entries before the block) << 32 | the block's entries
  for (int t = t0; t < t1; ++t) own += (static_cast<long long>(col[t]) << 32) + col[nt + t] - col[t];
  long long total;
  int run = static_cast<int>(block_exclusive_scan64(own, warp_sums, &total));
  for (int t = t0; t < t1; ++t) {
    pre[t] = run;
    sbase[t] = t * te + col[t];
    run += col[nt + t] - col[t];
  }
  if (threadIdx.x == 0) pre[nt] = static_cast<int>(total);
  return static_cast<int>(total >> 32);
}

// the table-list slot of the block's list position p < pre[nt]: the last
// tile whose run begins at or before p (it is not empty)
__device__ __forceinline__ int slot_of(const int* pre, const int* sbase, int nt, int p) {
  int lo = 0, hi = nt - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pre[mid] <= p)
      lo = mid;
    else
      hi = mid - 1;
  }
  return sbase[lo] + p - pre[lo];
}

// (b) blockIdx.x: texel block blk, blockIdx.y: table. Sorts the block's
// list by texel, stably: warp w counts the positions [w * per, (w + 1) *
// per) in order, the counts' prefix over warps and texels gives each (warp,
// texel) its first sorted position, the same walk (from registers, where
// the warp's share is at most kSortSteps steps of 32) writes each entry id
// to sorted[table] at base + its sorted position, base = the entries of
// the table's lower blocks: the table's ids sorted by block, then texel.
// tex[table][blk][r] = base + texel r's first sorted position (r = tb: the
// block's end). Dynamic shared memory, int: pre[nt + 1], sbase[nt],
// cw[kRowsWarps][tb].
constexpr int kSortSteps = 8;

__global__ void __launch_bounds__(kRowsThreads)
    rows_sort_kernel(const int* __restrict__ list, const unsigned short* __restrict__ lrow,
                     const int* __restrict__ tstart, int* __restrict__ sorted,
                     int* __restrict__ tex, int e_total, int log_tb, int nblk, int te, int nt) {
  extern __shared__ int sort_smem[];
  __shared__ long long warp_sums[kRowsWarps];
  const int tb = 1 << log_tb;
  int* pre = sort_smem;
  int* sbase = pre + nt + 1;
  int* cw = sbase + nt;
  const int blk = blockIdx.x, tbl = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* lb = list + static_cast<size_t>(tbl) * e_total;
  const unsigned short* rb = lrow + static_cast<size_t>(tbl) * e_total;
  int* sb = sorted + static_cast<size_t>(tbl) * e_total;
  const int base = block_runs(tstart + (static_cast<size_t>(tbl) * (nblk + 1) + blk) * nt, nt, te,
                              pre, sbase, warp_sums);
  for (int i = threadIdx.x; i < kRowsWarps * tb; i += kRowsThreads) cw[i] = 0;
  __syncthreads();
  const int m = pre[nt];
  const int per = (m + kRowsWarps - 1) / kRowsWarps;
  const int p0 = min(m, warp * per), p1 = min(m, p0 + per);
  int* mine = cw + warp * tb;
  // the walk in chunks of kSortSteps steps of 32, each chunk's ids and
  // rows loaded together into registers; a warp's share of one chunk
  // (held) stays there for the place pass
  const bool held = p1 - p0 <= 32 * kSortSteps;
  int held_e[kSortSteps], held_r[kSortSteps];
  auto entry = [&](int p, int& e, int& r) {  // entry id and texel (-1: none) of position p
    e = 0, r = -1;
    if (p < p1) {
      const int slot = slot_of(pre, sbase, nt, p);
      e = lb[slot], r = rb[slot];
    }
  };
  auto load_chunk = [&](int c0) {
#pragma unroll
    for (int u = 0; u < kSortSteps; ++u) entry(c0 + 32 * u + lane, held_e[u], held_r[u]);
  };
  auto count = [&](int r) {
    const unsigned grp = __match_any_sync(0xffffffffu, r);
    if (r >= 0 && lane == __ffs(grp) - 1) mine[r] += __popc(grp);
    __syncwarp();
  };
  for (int c0 = p0; c0 < p1; c0 += 32 * kSortSteps) {
    load_chunk(c0);
#pragma unroll
    for (int u = 0; u < kSortSteps; ++u) {
      if (c0 + 32 * u >= p1) break;
      count(held_r[u]);
    }
  }
  __syncthreads();
  {  // thread i owns texels [i * span, (i + 1) * span)
    int* tg = tex + (static_cast<size_t>(tbl) * nblk + blk) * (tb + 1);
    const int span = (tb + kRowsThreads - 1) / kRowsThreads;
    const int r0 = min(tb, static_cast<int>(threadIdx.x) * span), r1 = min(tb, r0 + span);
    int own = 0;
    for (int r = r0; r < r1; ++r)
      for (int v = 0; v < kRowsWarps; ++v) own += cw[v * tb + r];
    int total;
    int start = base + block_exclusive_scan(own, reinterpret_cast<int*>(warp_sums), &total);
    for (int r = r0; r < r1; ++r) {
      tg[r] = start;
      for (int v = 0; v < kRowsWarps; ++v) {
        const int cnt = cw[v * tb + r];
        cw[v * tb + r] = start;
        start += cnt;
      }
    }
    if (threadIdx.x == 0) tg[tb] = base + total;
  }
  __syncthreads();
  auto place = [&](int e, int r) {
    const unsigned grp = __match_any_sync(0xffffffffu, r);
    if (r >= 0) sb[mine[r] + __popc(grp & ((1u << lane) - 1u))] = e;
    __syncwarp();
    if (r >= 0 && lane == __ffs(grp) - 1) mine[r] += __popc(grp);
    __syncwarp();
  };
  for (int c0 = p0; c0 < p1; c0 += 32 * kSortSteps) {
    if (!held) load_chunk(c0);
#pragma unroll
    for (int u = 0; u < kSortSteps; ++u) {
      if (c0 + 32 * u >= p1) break;
      place(held_e[u], held_r[u]);
    }
  }
}

constexpr int kRowsPieces = 32;  // a split texel's most pieces
constexpr int kRowsQueued = 64;  // pieces the queue takes (partial rows in shared memory)

// the entries of each piece of a texel with cnt > piece entries
__device__ __forceinline__ int piece_len(int cnt, int piece) {
  return max(piece, (cnt + kRowsPieces - 1) / kRowsPieces);
}

// the pieces of a texel with cnt entries: 0 where it is not split
__device__ __forceinline__ int pieces_of(int cnt, int piece) {
  if (cnt <= piece) return 0;
  const int len = piece_len(cnt, piece);
  return (cnt + len - 1) / len;
}

// (c) blockIdx.x: texel block blk = blockIdx.x / splits and its share s =
// blockIdx.x % splits, blockIdx.y: image b (its table: b, or 0 when
// shared), blockIdx.z: the slab of 256 channels. Dynamic shared memory,
// int: ts[tb + 1] (each texel's first position in the table's sorted
// list), done[tb] (a split texel's pieces summed so far), pstart[tb + 1]
// (the block's pieces before each texel); float: part[kRowsQueued][kSlabCh]
// (piece sums). splits > 1 (a small call, planned in advance): the block's
// items are dealt to its `splits` thread blocks in turn, every piece among
// them; a piece's sum goes to gpart at slot (ts[r] >> h) + v, 2^h the
// largest power of two at most piece / 2, unique in the table (a split
// texel has cnt > piece entries and at most ceil(cnt / piece) pieces, and
// the next split texel starts at least cnt later), its count to gdone
// (zeroed by rows_bucket),
// and the warp that sums a texel's last piece adds them as in shared
// memory. Either way the sums and their order are the same.
template <typename T, bool kVec, int Q, bool kW>
__global__ void __launch_bounds__(kRowsThreads)
    rows_sum_kernel(const T* __restrict__ g, const float* __restrict__ w,
                    const int* __restrict__ sorted, const int* __restrict__ tex,
                    T* __restrict__ out, float* gpart, int* gdone, int n, int k, int c,
                    int log_tb, int nblk, int piece, int item_texels, int shared, int splits) {
  extern __shared__ int rows_smem[];
  __shared__ int warp_sums[kRowsWarps];
  __shared__ int next_item, first_round;
  const int tb = 1 << log_tb;
  int* ts = rows_smem;
  int* done = ts + tb + 1;
  int* pstart = done + tb;
  float* part = reinterpret_cast<float*>(pstart + tb + 1);
  const int blk = blockIdx.x / splits, share = blockIdx.x % splits;
  const int b = blockIdx.y, tbl = shared ? 0 : b, slab = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e_total = Q * n;
  const int texels = min(tb, k - blk * tb);
  const int* tg = tex + (static_cast<size_t>(tbl) * nblk + blk) * (tb + 1);
  for (int i = threadIdx.x; i <= tb; i += kRowsThreads) ts[i] = tg[i];
  for (int i = threadIdx.x; i < tb; i += kRowsThreads) done[i] = 0;
  if (threadIdx.x == 0) next_item = 0, first_round = texels;
  __syncthreads();
  {  // the split texels' pieces in texel order; with one thread block a
     // block, the queue takes those of the texels before first_round (at
     // most kRowsQueued, whole texels); thread i owns texels [i * span, ...)
    const int span = (tb + kRowsThreads - 1) / kRowsThreads;
    const int r0 = min(texels, static_cast<int>(threadIdx.x) * span), r1 = min(texels, r0 + span);
    int own = 0;
    for (int r = r0; r < r1; ++r) own += pieces_of(ts[r + 1] - ts[r], piece);
    int total;
    int at = block_exclusive_scan(own, warp_sums, &total);
    for (int r = r0; r < r1; ++r) {
      const int pieces = pieces_of(ts[r + 1] - ts[r], piece);
      pstart[r] = at;
      if (splits == 1 && pieces && at + pieces > kRowsQueued) atomicMin(&first_round, r);
      at += pieces;
    }
    if (threadIdx.x == 0) pstart[texels] = total;
  }
  __syncthreads();
  const int queued = pstart[first_round];
  const int* sb = sorted + static_cast<size_t>(tbl) * e_total;
  const T* gb = g + static_cast<size_t>(b) * n * c;
  const float* wb = kW ? w + static_cast<size_t>(tbl) * e_total : nullptr;
  T* ob = out + (static_cast<size_t>(b) * k + static_cast<size_t>(blk) * tb) * c;
  const int ch = slab * kSlabCh + 8 * lane;
  const bool dealt = splits > 1;
  const size_t image_slab = static_cast<size_t>(b) * gridDim.z + slab;
  const int h = 30 - __clz(piece);  // floor(log2(piece)) - 1
  float* pr = dealt ? gpart + image_slab * ((e_total >> h) + kRowsPieces) * kSlabCh : part;
  int* dn = dealt ? gdone + image_slab * k + static_cast<size_t>(blk) * tb : done;
  auto pos_id = [&](int q) -> int { return sb[q]; };
  auto split = [&](int r) { return ts[r + 1] - ts[r] > piece; };
  // piece v of texel r into pr[i], then, by the warp that sums its last
  // piece, the texel's row: its pieces added from 0 in order
  auto sum_piece = [&](int i, int r, int v, int first_piece) {
    const int cnt = ts[r + 1] - ts[r], len = piece_len(cnt, piece);
    const int i0 = ts[r] + v * len;
    float acc[8] = {};
    walk_rows<T, kVec, Q, kW>(gb, wb, c, ch, i0, min(ts[r + 1], i0 + len), pos_id,
                              [](int, float(&)[8]) {}, acc);
#pragma unroll
    for (int u = 0; u < 8; ++u) pr[i * kSlabCh + 8 * lane + u] = acc[u];
    __syncwarp();
    if (dealt)
      __threadfence();
    else
      __threadfence_block();
    int last = 0;
    if (lane == 0) last = atomicAdd(dn + r, 1) == pieces_of(cnt, piece) - 1;
    if (__shfl_sync(0xffffffffu, last, 0)) {
      if (dealt)
        __threadfence();
      else
        __threadfence_block();
      float tot[8] = {};
      for (int q = 0; q < pieces_of(cnt, piece); ++q) {
        const float* src = pr + (first_piece + q) * kSlabCh + 8 * lane;
#pragma unroll
        for (int u = 0; u < 8; ++u) tot[u] = __fadd_rn(tot[u], dealt ? __ldcg(src + u) : src[u]);
      }
      store_row8<kVec>(ob + static_cast<size_t>(r) * c, ch, c, tot);
    }
  };
  // one queue, taken from a shared counter (item j of the block is this
  // thread block's when j % splits == share): the queued pieces (the
  // longest walks, first), then the items: texels [j * item_texels, ...);
  // a run of texels that are not split is walked in one pass, each row
  // written as its texel closes (a texel with no entry: zeros)
  const int items = queued + (texels + item_texels - 1) / item_texels;
  for (;;) {
    int j = 0;
    if (lane == 0) j = share + splits * atomicAdd(&next_item, 1);
    j = __shfl_sync(0xffffffffu, j, 0);
    if (j >= items) break;
    if (j < queued) {
      int lo = 0, hi = texels - 1;  // the texel of piece j: the last r with pstart[r] <= j
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (pstart[mid] <= j)
          lo = mid;
        else
          hi = mid - 1;
      }
      const int v = j - pstart[lo];
      if (dealt)
        sum_piece((ts[lo] >> h) + v, lo, v, ts[lo] >> h);
      else
        sum_piece(j, lo, v, pstart[lo]);
      continue;
    }
    j -= queued;
    const int r_end = min(texels, (j + 1) * item_texels);
    for (int ra = j * item_texels; ra < r_end;) {
      if (split(ra)) {
        ++ra;
        continue;
      }
      int rb = ra + 1;
      while (rb < r_end && !split(rb)) ++rb;
      int kk = ra, bound = ts[ra + 1];
      float acc[8] = {};
      auto close = [&](int ii, float(&a)[8]) {
        while (ii == bound) {  // texel kk ends before position ii
          store_row8<kVec>(ob + static_cast<size_t>(kk) * c, ch, c, a);
#pragma unroll
          for (int u = 0; u < 8; ++u) a[u] = 0.f;
          ++kk;
          bound = ts[kk + 1];
        }
      };
      walk_rows<T, kVec, Q, kW>(gb, wb, c, ch, ts[ra], ts[rb], pos_id, close, acc);
      for (; kk < rb; ++kk) {
        store_row8<kVec>(ob + static_cast<size_t>(kk) * c, ch, c, acc);
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[u] = 0.f;
      }
      ra = rb;
    }
  }
  // split texels past the queue's pieces (one thread block a block, with
  // more than kRowsQueued), texel by texel: warp w sums its pieces w, w + 8, ...
  for (int r = first_round; r < texels; ++r) {
    const int pieces = pieces_of(ts[r + 1] - ts[r], piece);
    if (!pieces) continue;
    __syncthreads();  // part is free
    for (int v = warp; v < pieces; v += kRowsWarps) sum_piece(v, r, v, 0);
  }
}

template <typename T, int Q, bool kW>
int rows_scatter(const void* g, const void* idx, const void* w, void* iscratch, void* part,
                 void* out, int b, int k, int c, int n, int log_tb, int te, int piece,
                 int item_texels, int splits, bool shared, cudaStream_t s) {
  const int e_total = Q * n, tables = shared ? 1 : b;
  const int tb = 1 << log_tb, nblk = (k + tb - 1) / tb, nt = (e_total + te - 1) / te;
  const int slabs = (c + kSlabCh - 1) / kSlabCh;
  const size_t tab = static_cast<size_t>(tables);
  int* list = static_cast<int*>(iscratch);              // [tables][E]
  int* tstart = list + tab * e_total;                   // [tables][nblk + 1][nt]
  int* sorted = tstart + tab * (nblk + 1) * nt;         // [tables][E]
  int* tex = sorted + tab * e_total;                    // [tables][nblk][tb + 1]
  auto* lrow = reinterpret_cast<unsigned short*>(tex + tab * nblk * (tb + 1));  // [tables][E]
  int* gdone = tex + tab * nblk * (tb + 1) + (tab * e_total + 1) / 2;  // [b][slabs][k], dealt
  const auto* ix = static_cast<const long long*>(idx);
  const int ndone = splits > 1 ? b * slabs * k : 0;
  const size_t bsmem = sizeof(unsigned short) * kRowsWarps * nblk;
  cudaError_t err = cudaFuncSetAttribute(
      rows_bucket_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bsmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rows_bucket_kernel<<<dim3(nt, tables), kRowsThreads, bsmem, s>>>(
      ix, list, lrow, tstart, gdone, ndone, e_total, k, log_tb, nblk, te, nt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t osmem = sizeof(int) * (2 * static_cast<size_t>(nt) + 1 + kRowsWarps * tb);
  err = cudaFuncSetAttribute(rows_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(osmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rows_sort_kernel<<<dim3(nblk, tables), kRowsThreads, osmem, s>>>(list, lrow, tstart, sorted,
                                                                   tex, e_total, log_tb, nblk, te,
                                                                   nt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // dealt blocks keep their pieces' sums in gpart, not in shared memory
  const size_t ssmem =
      sizeof(int) * (3 * tb + 2) + (splits > 1 ? 0 : sizeof(float) * kRowsQueued * kSlabCh);
  const auto* gg = static_cast<const T*>(g);
  const auto* ww = static_cast<const float*>(w);
  auto* o = static_cast<T*>(out);
  auto* gp = static_cast<float*>(part);
  const dim3 grid(nblk * splits, b, slabs);
  const int sh = shared ? 1 : 0;
#define NJF_ROWS_SUM(VEC)                                                                      \
  err = cudaFuncSetAttribute(rows_sum_kernel<T, VEC, Q, kW>,                                   \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,                      \
                             static_cast<int>(ssmem));                                         \
  if (err != cudaSuccess) return static_cast<int>(err);                                        \
  rows_sum_kernel<T, VEC, Q, kW><<<grid, kRowsThreads, ssmem, s>>>(                            \
      gg, ww, sorted, tex, o, gp, gdone, n, k, c, log_tb, nblk, piece, item_texels, sh, splits)
  if (c % 8 == 0) {
    NJF_ROWS_SUM(true);
  } else {
    NJF_ROWS_SUM(false);
  }
#undef NJF_ROWS_SUM
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

// g [b, n, c] (bf16 when is_f32 == 0, else float32), idx [b, n, 4] int64
// corner ids in [0, k), w4 [b, n, 4] float32 -> out [b, k, c] float32, by
// onehot_gather.bwd_plan's stages: bucket tiles of `tile` entries (`tiles`
// per image, tiles * tile >= 4n), pieces of `len` entries; smem_hist != 0:
// the bucket's counters in shared memory (k <= 12288). iscratch: int32
// [b * tiles * k + b * (k + 1) + b * 4n]; part: float32 [b, ceil(4n / len),
// 2, c]. 4n <= 2^30.
extern "C" int njf_onehot_scatter_bwd(const void* g, const void* idx, const void* w4,
                                      void* iscratch, void* part, void* out, int b, int k, int c,
                                      int n, int tile, int tiles, int len, int smem_hist,
                                      int is_f32, void* stream) {
  if (b <= 0 || k <= 0 || c <= 0 || n <= 0 || n > (1 << 28) || tile <= 0 || tiles <= 0 ||
      static_cast<long long>(tile) * tiles < 4LL * n ||
      static_cast<long long>(tile) * tiles > (1LL << 31) - 1 || len <= 0 ||
      (smem_hist && k > 12288))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return is_f32 ? scatter_bwd<float>(g, idx, w4, iscratch, part, out, b, k, c, n, tile, tiles,
                                     len, smem_hist != 0, s)
                : scatter_bwd<__nv_bfloat16>(g, idx, w4, iscratch, part, out, b, k, c, n, tile,
                                             tiles, len, smem_hist != 0, s);
}

// K1-bwd-rows: g [b, n, c] (bf16 when is_f32 == 0, else float32), idx
// [b, n, q] int64 ids in [0, k), w [b, n, q] float32 when has_w != 0 (else
// null: unit weights) -> out [b, k, c] in g's type: out[b, kk] = the sum
// over entries (p, j) with idx[b, p, j] == kk, in entry order from 0, of
// w[b, p, j] * g[b, p] (the weight rounded to g's type; float32 sums,
// rounded once), a row with more than `piece` entries summed in pieces as
// rows_sum_kernel says. shared != 0: idx and w are [1, n, q], one table for
// every image. The plan (onehot_gather.rows_plan): texel blocks of
// 2^log_tb rows (3 <= log_tb <= 10, at most 8192 blocks), tiles of te
// entries (a multiple of 256, at most 32768; at most 2048 tiles), items of
// item_texels texels, each block dealt to `splits` thread blocks (1 ... 64;
// above 1, piece >= 2). iscratch: int32 [t (2 q n + (nblk + 1) tiles +
// nblk (2^log_tb + 1) + ceil(q n / 2)) + (splits > 1 ? b slabs k : 0)], t =
// 1 when shared, else b, slabs = ceil(c / 256); part (splits > 1, else
// null): float32 [b, slabs, (q n >> h) + 32, 256], h = floor(log2(piece)) -
// 1. q n <= 2^26, b <= 65535, b slabs k < 2^31, c <= 65535 * 256.
extern "C" int njf_row_scatter(const void* g, const void* idx, const void* w, void* iscratch,
                               void* part, void* out, int b, int k, int c, int n, int q,
                               int log_tb, int te, int piece, int item_texels, int splits,
                               int is_f32, int has_w, int shared, void* stream) {
  if (b <= 0 || b > 65535 || k <= 0 || c <= 0 || c > 65535 * kSlabCh || n <= 0 ||
      (q != 1 && q != 4) ||
      static_cast<long long>(q) * n > (1LL << 26) || log_tb < 3 || log_tb > 10 ||
      (k + (1 << log_tb) - 1) >> log_tb > 8192 || te <= 0 || te % 256 != 0 || te > 32768 ||
      (static_cast<long long>(q) * n + te - 1) / te > 2048 || piece <= 0 || item_texels <= 0 ||
      splits < 1 || splits > 64 ||
      (splits > 1 &&
       (part == nullptr || piece < 2 ||
        static_cast<long long>(b) * ((c + kSlabCh - 1) / kSlabCh) * k >= (1LL << 31))) ||
      (has_w && w == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const bool one = shared != 0;
#define NJF_ROW_SCATTER(T, Q, W) \
  return rows_scatter<T, Q, W>(g, idx, w, iscratch, part, out, b, k, c, n, log_tb, te, piece, \
                               item_texels, splits, one, s)
  if (is_f32) {
    if (q == 1) {
      if (has_w) NJF_ROW_SCATTER(float, 1, true);
      NJF_ROW_SCATTER(float, 1, false);
    }
    if (has_w) NJF_ROW_SCATTER(float, 4, true);
    NJF_ROW_SCATTER(float, 4, false);
  }
  if (q == 1) {
    if (has_w) NJF_ROW_SCATTER(__nv_bfloat16, 1, true);
    NJF_ROW_SCATTER(__nv_bfloat16, 1, false);
  }
  if (has_w) NJF_ROW_SCATTER(__nv_bfloat16, 4, true);
  NJF_ROW_SCATTER(__nv_bfloat16, 4, false);
#undef NJF_ROW_SCATTER
}
