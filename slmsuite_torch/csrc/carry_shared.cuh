// Device helpers shared by the carry-step kernels of wgs_carry.cu (the WGS
// column round trip) and mraf_carry.cu (the MRAF forward and mix passes):
// the scalar-buffer lanes, the WGS weight correction, the stats partials of
// one element, and the fixed-order block reduction of those partials.
//
// The stats partials of a column kernel go to partials[block * 8 + k]:
// [overlap, err_sum, err_sq, |w|^2, err_max, u_max, -err_min, -u_min]. The
// error moments accumulate in float64: std_err is formed from
// E[e^2] - E[e]^2, which cancels most of its digits near convergence. The
// overlap and |w|^2 keep float32 sums, as in the plain versions. The second
// pass, stats_reduce (wgs_carry.cu, launched through launch_stats_reduce),
// folds them into sums[0:4] (float64 storage) and maxs[0:4].

#pragma once

#include <cuda_runtime.h>

#include "fft_shared.cuh"

namespace slm {

constexpr float kNegFill = -3.0e38f;

__device__ __forceinline__ bool is_nan(float x) { return x != x; }
__device__ __forceinline__ bool is_inf(float x) {
  return fabsf(x) == __int_as_float(0x7f800000);
}
__device__ __forceinline__ bool is_finite(float x) {
  return fabsf(x) < __int_as_float(0x7f800000);
}

// Lane layout of the device scalar buffer (ops/fft.py SCALAR_KEYS).
enum Scalar {
  kPost = 0,        // 1/sqrt(HW), times the amplitude when it is a scalar
  kInvPrevNorm,     // 1 / previous iteration's weight norm
  kApplyUpdate,     // 0/1: the WGS update is active (iteration > 0)
  kUseTheta,        // 0/1: Kim takes the current farfield direction
  kExponent,        // feedback_exponent
  kFactor,          // feedback_factor
  kInvFnorm,        // 1 / sqrt(Parseval feedback power)
  kInvTsum,         // 1 / sum(target^2)
  kInvFsum,         // 1 / Parseval feedback power
  kMrafFactor,      // MRAF noise-region factor k
  kZeroFactor,      // MRAF zero-region weight step zf
  kNumScalars
};

// Rules: 0 = leonardo/kim, 1 = wu, 2 = tanh (pallas_fft._weight_correction).
__device__ __forceinline__ float weight_correction(float f, float t, float p,
                                                   float factor,
                                                   float inv_fnorm, int rule) {
  float c;
  if (rule == 0) {
    const bool on = t != 0.f;
    c = f / (on ? t : 1.f);
    if (!(on && c > 0.f && is_finite(c))) c = 1.f;
    c = expf(-p * logf(c));
  } else if (rule == 1) {
    c = expf(p * (t - p * f * inv_fnorm));
  } else {
    c = 1.f + factor * tanhf(p * (t - p * f * inv_fnorm));
  }
  return is_inf(c) ? 1.f : c;
}

// The lanes a column kernel reads, loaded once per thread.
struct StepScalars {
  float post, inv_prev, p, factor, inv_fnorm, inv_tsum, inv_fsum, mraf_k,
      zero_f;
  bool apply_update, use_theta;
};

__device__ __forceinline__ StepScalars load_scalars(
    const float* __restrict__ scal) {
  StepScalars s;
  s.post = scal[kPost];
  s.inv_prev = scal[kInvPrevNorm];
  s.apply_update = scal[kApplyUpdate] > 0.f;
  s.use_theta = scal[kUseTheta] > 0.f;
  s.p = scal[kExponent];
  s.factor = scal[kFactor];
  s.inv_fnorm = scal[kInvFnorm];
  s.inv_tsum = scal[kInvTsum];
  s.inv_fsum = scal[kInvFsum];
  s.mraf_k = scal[kMrafFactor];
  s.zero_f = scal[kZeroFactor];
  return s;
}

// The updated weight of one element: w * c with nan -> 1e-4, scaled by the
// previous norm once the update is on (the weights before that).
__device__ __forceinline__ float updated_weight(float f, float t, float w,
                                                const StepScalars& s,
                                                int rule) {
  float uw = w * weight_correction(f, t, s.p, s.factor, s.inv_fnorm, rule);
  if (is_nan(uw)) uw = 1e-4f;
  return s.apply_update ? uw * s.inv_prev : w;
}

// One element's stats partials: facc[0] += overlap, dacc += the error
// moments, macc = the maxes of err, u, -err, -u over the stats mask.
__device__ __forceinline__ void stats_accumulate(float f, float t, float m,
                                                 float inv_tsum, float inv_fsum,
                                                 float facc[2], double dacc[2],
                                                 float macc[4]) {
  const float fsq = f * f;
  const float tsq = t * t;
  const float err_full = tsq * inv_tsum - fsq * inv_fsum;
  const double err = err_full * m;
  facc[0] += t * f;
  dacc[0] += err;
  dacc[1] += err * err;
  if (m > 0.f) {
    const float u = fsq / tsq;
    macc[0] = fmaxf(macc[0], err_full);
    macc[1] = fmaxf(macc[1], u);
    macc[2] = fmaxf(macc[2], -err_full);
    macc[3] = fmaxf(macc[3], -u);
  }
}

// Block reduction of the stats partials in a fixed order (no atomics, so
// the result is the same from run to run): two float32 sums f (overlap,
// |w|^2), the two float64 error moments d (err_sum, err_sq) and four
// float32 maxes m. Thread 0 gets the totals.
__device__ __forceinline__ void block_reduce(float f[2], double d[2],
                                             float m[4]) {
  __shared__ float red_f[kThreads / 32][2];
  __shared__ double red_d[kThreads / 32][2];
  __shared__ float red_m[kThreads / 32][4];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    for (int k = 0; k < 2; ++k) {
      f[k] += __shfl_down_sync(0xffffffffu, f[k], off);
      d[k] += __shfl_down_sync(0xffffffffu, d[k], off);
    }
    for (int k = 0; k < 4; ++k)
      m[k] = fmaxf(m[k], __shfl_down_sync(0xffffffffu, m[k], off));
  }
  if (lane == 0) {
    for (int k = 0; k < 2; ++k) {
      red_f[warp][k] = f[k];
      red_d[warp][k] = d[k];
    }
    for (int k = 0; k < 4; ++k) red_m[warp][k] = m[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      for (int k = 0; k < 2; ++k) {
        f[k] += red_f[w][k];
        d[k] += red_d[w][k];
      }
      for (int k = 0; k < 4; ++k) m[k] = fmaxf(m[k], red_m[w][k]);
    }
  }
}

// Block-reduce the partials and write this block's row of `partials`.
__device__ __forceinline__ void write_partials(float facc[2], double dacc[2],
                                               float macc[4],
                                               double* __restrict__ partials) {
  block_reduce(facc, dacc, macc);
  if (threadIdx.x == 0) {
    double* out = partials + blockIdx.x * 8;
    out[0] = facc[0];
    out[1] = dacc[0];
    out[2] = dacc[1];
    out[3] = facc[1];
    for (int k = 0; k < 4; ++k) out[4 + k] = macc[k];
  }
}

// Launches stats_reduce (defined in wgs_carry.cu) on `stream`.
cudaError_t launch_stats_reduce(const double* partials, int n_blocks,
                                double* sums, float* maxs, cudaStream_t stream);

}  // namespace slm
