// K5 on Hopper: inverse-CDF (PDF) resampling of ray bins.
//
// Replaces neural_jacobian_field_tpu/ops/pallas/pdf_resample.py::fused_sample_pdf
// (body _make_kernel). Per ray: weights + histogram padding, the eps pad that
// keeps empty rays finite, normalisation, the inclusive CDF (clipped at 1,
// with a leading 0), searchsorted-right of each query u, and linear
// interpolation of the bin edges inside the found bin.
//
// The TPU kernel's workarounds are gone: the CDF is a warp scan (not a
// triangular matmul), the search is a binary search (not a compare-and-reduce
// over all S+1 edges), and the lookups are direct shared-memory reads (not
// one-hot contractions).
//
// What bounds it on the H100: bins, weights, u in and out, about 4 x 257
// floats per ray, 8.4 MB per 2048-ray chunk: 2.5 us of HBM time, so a chunk
// is bound by latency, the launch and one wave of dependent steps. One warp
// per ray, every lane busy: lane l holds per = min(8, ceil(S / 32))
// consecutive padded weights of a segment of 32 x per bins in registers.
//  - the normaliser: each lane sums its weights in order, a fixed xor
//    butterfly adds the 32 lane sums (every lane gets the same bits), the
//    segments are added in order;
//  - pdf_i = ((w_i + padding) + per_bin) / w_sum, elementwise;
//  - the inclusive CDF: each lane's running sums of its pdf values, a 5-step
//    shuffle-up scan of the 32 lane totals, the lane's exclusive prefix
//    (plus the earlier segments' total) added back, clamped at 1.
// So a ray takes about 2 x 8 + 10 dependent steps, not 2 x 256 on one lane.
// The CDF and the edges go to shared memory for the binary searches, which
// spread the Q queries over the lanes. No atomics, no fused multiply-add:
// every rounding is placed, and the result repeats bit for bit.
//
// Tolerance: a scan sums in another order than jnp.cumsum's left to right
// (and jnp.sum's pairwise normaliser), so CDFs differ by ~1e-7 per step. The
// interpolation divides that by the bin's pdf: in low-weight bins a sample
// moves by up to ~1e-4. A query within rounding of a CDF value (a bin tie)
// may land in the adjacent bin; the output then moves by at most one bin
// width.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kPerMax = 8;  // weights a lane holds: segments of at most 256 bins

// lane's per weights of a segment from `first`, plus histogram_padding; 0
// past its share or past S. vec: S % 4 == 0 and per % 4 == 0 (16-byte rows)
__device__ __forceinline__ void load_weights(const float* __restrict__ w, int first, int per,
                                             int S, float hp, bool vec, float (&v)[kPerMax]) {
#pragma unroll
  for (int j = 0; j < kPerMax; j += 4) {
    const int i = first + j;
    if (vec && j < per && i + 3 < S) {
      const float4 q = *reinterpret_cast<const float4*>(w + i);
      v[j] = __fadd_rn(q.x, hp), v[j + 1] = __fadd_rn(q.y, hp);
      v[j + 2] = __fadd_rn(q.z, hp), v[j + 3] = __fadd_rn(q.w, hp);
    } else {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        v[j + jj] = j + jj < per && i + jj < S ? __fadd_rn(w[i + jj], hp) : 0.f;
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    pdf_resample_kernel(const float* __restrict__ bins, const float* __restrict__ weights,
                        const float* __restrict__ u, float* __restrict__ out, int n_rays, int S,
                        int Q, int per, float histogram_padding, float eps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ray = blockIdx.x * kWarps + warp;
  if (ray >= n_rays) return;  // only warp-level synchronisation below

  float* cdf = smem + static_cast<size_t>(warp) * 2 * (S + 1);
  float* edges = cdf + (S + 1);
  const float* w_ray = weights + static_cast<size_t>(ray) * S;
  const float* b_ray = bins + static_cast<size_t>(ray) * (S + 1);
  for (int i = lane; i <= S; i += 32) edges[i] = b_ray[i];

  const int seg = 32 * per;
  const bool one_seg = S <= seg;
  const bool vec = S % 4 == 0 && per % 4 == 0;
  float v[kPerMax];
  if (one_seg) load_weights(w_ray, lane * per, per, S, histogram_padding, vec, v);

  // the normaliser: lane sums in order, the butterfly, segments in order
  float w_sum = 0.f;
  for (int s0 = 0; s0 < S; s0 += seg) {
    if (!one_seg) load_weights(w_ray, s0 + lane * per, per, S, histogram_padding, vec, v);
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < kPerMax; ++j) part = __fadd_rn(part, v[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
    w_sum = __fadd_rn(w_sum, part);
  }
  const float padding = fmaxf(eps - w_sum, 0.f);
  const float per_bin = __fdiv_rn(padding, static_cast<float>(S));
  w_sum = __fadd_rn(w_sum, padding);

  // the inclusive CDF, segment by segment
  float carry = 0.f;
  for (int s0 = 0; s0 < S; s0 += seg) {
    if (!one_seg) load_weights(w_ray, s0 + lane * per, per, S, histogram_padding, vec, v);
    const int first = s0 + lane * per;
    float run = 0.f;
#pragma unroll
    for (int j = 0; j < kPerMax; ++j) {
      if (j < per && first + j < S)
        run = __fadd_rn(run, __fdiv_rn(__fadd_rn(v[j], per_bin), w_sum));
      v[j] = run;  // the lane's inclusive partial sums
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl = __fadd_rn(incl, t);
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    const float base = __fadd_rn(carry, excl);
#pragma unroll
    for (int j = 0; j < kPerMax; ++j)
      if (j < per && first + j < S) cdf[first + j + 1] = fminf(__fadd_rn(base, v[j]), 1.f);
    carry = __fadd_rn(carry, __shfl_sync(0xffffffffu, incl, 31));
  }
  if (lane == 0) cdf[0] = 0.f;
  __syncwarp();

  const float* u_ray = u + static_cast<size_t>(ray) * Q;
  float* o_ray = out + static_cast<size_t>(ray) * Q;
  for (int q = lane; q < Q; q += 32) {
    const float uq = u_ray[q];
    // number of CDF entries <= uq (searchsorted side="right"); the CDF is
    // non-decreasing, so a binary search gives the compare-and-count's answer
    int lo = 0, hi = S + 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cdf[mid] <= uq)
        lo = mid + 1;
      else
        hi = mid;
    }
    const int below = max(lo - 1, 0);
    const int above = min(lo, S);
    const float c0 = cdf[below];
    const float c1 = cdf[above];
    const float e0 = edges[below];
    const float e1 = edges[above];
    const float denom = __fsub_rn(c1, c0);
    float t = denom > 0.f ? __fdiv_rn(__fsub_rn(uq, c0), denom) : 0.f;
    t = fminf(fmaxf(t, 0.f), 1.f);
    o_ray[q] = __fadd_rn(e0, __fmul_rn(t, __fsub_rn(e1, e0)));
  }
}

}  // namespace

// bins [n_rays, S+1], weights [n_rays, S], u [n_rays, Q] -> out [n_rays, Q],
// all float32, contiguous and 16-byte aligned.
extern "C" int njf_pdf_resample(const void* bins, const void* weights, const void* u, void* out,
                                int n_rays, int S, int Q, float histogram_padding, float eps,
                                void* stream) {
  if (n_rays <= 0 || S <= 0 || Q <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kWarps) * 2 * (S + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pdf_resample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int per = S >= 32 * kPerMax ? kPerMax : (S + 31) / 32;
  const unsigned blocks = static_cast<unsigned>((n_rays + kWarps - 1) / kWarps);
  pdf_resample_kernel<<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bins), static_cast<const float*>(weights),
      static_cast<const float*>(u), static_cast<float*>(out), n_rays, S, Q, per,
      histogram_padding, eps);
  return static_cast<int>(cudaGetLastError());
}
