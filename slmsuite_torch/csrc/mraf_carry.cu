// Carry-mode MRAF kernels for Hopper (sm_90a).
//
// MRAF mixes the NORMALIZED updated weights in the signal region with the
// free farfield in the noise region, so the mix needs the exact norm of
// this iteration's weights: the one reduction between the forward and the
// inverse column pass. The WGS column round trip is therefore split in
// two, as on the TPU (pallas_fft.mraf_carry_step_pallas):
//
//   cols_mraf_fwd      forward column FFT, F = post * B written as (fr, fi),
//                      the unnormalized weight update uw and the stats
//                      partials with sum uw^2; stats_reduce (wgs_carry.cu)
//                      folds them in a fixed order into the device sums;
//   cols_mraf_mix_inv  1/sqrt(sums[3]) read from the device sums (no host
//                      round trip), the region mix, Kim's phasor select,
//                      the zero-region weight update, the inverse column FFT;
//
// then rows_normfwd (wgs_carry.cu). Semantics: the plain PyTorch versions
// `_cols_mraf_fwd` and `_cols_mraf_mix_inv` in slmsuite_torch/ops/fft.py.
//
// What bounds them on the H100: memory traffic. At 2048^2 one f32 plane is
// 16.8 MB. cols_mraf_fwd with stats reads gr, gi, w, t, mask and writes
// fr, fi, uw: 8 planes, 40 us at 3.35 TB/s. cols_mraf_mix_inv reads fr,
// fi, uw, mcode and writes hr, hi (6 planes, 30 us); Kim adds the phasor
// pair in and out and the zero weights their pair in and out (14 planes,
// 70 us). One column FFT each is ~0.12 GFLOP, 2 us at the f32 peak. The
// simple design keeps the column tile in shared memory and touches device
// memory once per operand, as the WGS column kernel does; the scaled
// complex farfield (not |F| and arg F) crosses between the two kernels, so
// the mix runs without a transcendental.
//
// Launchers take raw pointers, sizes, flags and a stream, and return
// cudaGetLastError(). They allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "carry_shared.cuh"

namespace slm {

// Region codes of the mix plane (engine._augment_fused_consts).
constexpr float kSignal = 1.f;
constexpr float kNoise = 2.f;

// #10, K1 <- pallas_fft._cols_mraf_fwd2_kernel (mraf_carry_step_pallas,
// pallas_call at :1796). One block per tile of `tc` adjacent columns:
// forward column FFT, (fr, fi) = post * B, uw = the rule's update of w
// (updated_weight), the stats partials and sum uw^2 (carry_shared.cuh).
__global__ void __launch_bounds__(kThreads)
cols_mraf_fwd_kernel(const float* __restrict__ gr, const float* __restrict__ gi,
                     const float* __restrict__ w, const float* __restrict__ t,
                     const float* __restrict__ mask, float* __restrict__ fr_out,
                     float* __restrict__ fi_out, float* __restrict__ uw_out,
                     const float* __restrict__ scal,
                     double* __restrict__ partials, int H, int W, int log2H,
                     int tc, int log2tc, const float2* __restrict__ tw_fwd,
                     int rule, int stats_on) {
  extern __shared__ float2 sbuf[];  // tc columns of length H, back to back
  const int c0 = blockIdx.x * tc;
  load_col_tile(sbuf, gr, gi, H, W, tc, log2tc);
  fft_lines(sbuf, H, log2H, tc, tw_fwd);

  const StepScalars s = load_scalars(scal);
  float facc[2] = {0.f, 0.f};    // overlap, sum uw^2
  double dacc[2] = {0.0, 0.0};   // err_sum, err_sq
  float macc[4] = {kNegFill, kNegFill, kNegFill, kNegFill};
  for (int idx = threadIdx.x; idx < tc * H; idx += blockDim.x) {
    const int j = idx & (tc - 1);
    const int r = idx >> log2tc;
    const size_t g = (size_t)r * W + c0 + j;
    const float2 B = sbuf[j * H + r];
    const float fr = B.x * s.post;
    const float fi = B.y * s.post;
    const float f = sqrtf(fr * fr + fi * fi);
    const float tv = t[g];
    const float uw = updated_weight(f, tv, w[g], s, rule);
    fr_out[g] = fr;
    fi_out[g] = fi;
    uw_out[g] = uw;
    facc[1] += uw * uw;
    if (stats_on)
      stats_accumulate(f, tv, mask[g], s.inv_tsum, s.inv_fsum, facc, dacc, macc);
  }
  write_partials(facc, dacc, macc, partials);
}

// #10, K2 <- pallas_fft._cols_mraf_mix_inv_kernel (pallas_call at :1837),
// with the norm sync (:1810) folded in: every thread reads sums[3]. One
// block per tile of `tc` adjacent columns. e = F/|F| (zero -> (1, 0)), or
// Kim's stored phasor while use_theta is off (then stored back); the mix
// uw/||uw|| * e in the signal region, k * F in the noise region, 0 in the
// zero region, or with `zero` the updated zero weight zw - zf * |F| * F
// (written back too); then the inverse column FFT.
__global__ void __launch_bounds__(kThreads)
cols_mraf_mix_inv_kernel(
    const float* __restrict__ fr_in, const float* __restrict__ fi_in,
    const float* __restrict__ uw, const float* __restrict__ mcode,
    const float* __restrict__ pffr, const float* __restrict__ pffi,
    const float* __restrict__ zwr, const float* __restrict__ zwi,
    float* __restrict__ hr, float* __restrict__ hi,
    float* __restrict__ pffr_out, float* __restrict__ pffi_out,
    float* __restrict__ zwr_out, float* __restrict__ zwi_out,
    const float* __restrict__ scal, const double* __restrict__ sums, int H,
    int W, int log2H, int tc, int log2tc, const float2* __restrict__ tw_inv,
    int kim, int zero) {
  extern __shared__ float2 sbuf[];
  const int c0 = blockIdx.x * tc;
  const StepScalars s = load_scalars(scal);
  const float inv_norm = 1.f / sqrtf((float)sums[3]);
  for (int idx = threadIdx.x; idx < tc * H; idx += blockDim.x) {
    const int j = idx & (tc - 1);
    const int r = idx >> log2tc;
    const size_t g = (size_t)r * W + c0 + j;
    const float fr = fr_in[g];
    const float fi = fi_in[g];
    const float f2 = fr * fr + fi * fi;
    float er = 1.f, ei = 0.f;
    if (f2 > 0.f) {
      const float ib = rsqrtf(f2);
      er = fr * ib;
      ei = fi * ib;
    }
    if (kim) {
      if (!s.use_theta) {
        er = pffr[g];
        ei = pffi[g];
      }
      pffr_out[g] = er;
      pffi_out[g] = ei;
    }
    const float mc = mcode[g];
    float re = 0.f, im = 0.f;
    if (mc == kSignal) {
      const float wn = uw[g] * inv_norm;
      re = wn * er;
      im = wn * ei;
    } else if (mc == kNoise) {
      re = s.mraf_k * fr;
      im = s.mraf_k * fi;
    }
    if (zero) {
      float zr = zwr[g], zi = zwi[g];
      if (mc == 0.f) {
        const float step = s.zero_f * sqrtf(f2);
        zr -= step * fr;
        zi -= step * fi;
        re = zr;
        im = zi;
      }
      zwr_out[g] = zr;
      zwi_out[g] = zi;
    }
    sbuf[j * H + r] = make_float2(re, im);
  }
  __syncthreads();
  fft_lines(sbuf, H, log2H, tc, tw_inv);
  store_col_tile(sbuf, hr, hi, H, W, tc, log2tc);
}

}  // namespace slm

using namespace slm;

extern "C" {

int slm_cols_mraf_fwd(const float* gr, const float* gi, const float* w,
                      const float* t, const float* mask, float* fr, float* fi,
                      float* uw, const float* scal, double* partials,
                      double* sums, float* maxs, int H, int W, int tc,
                      const float2* tw_fwd, int rule, int stats_on,
                      cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = cols_setup(cols_mraf_fwd_kernel, H, W, tc, &smem);
  if (err != cudaSuccess) return (int)err;
  const int n_blocks = W / tc;
  cols_mraf_fwd_kernel<<<n_blocks, kThreads, smem, stream>>>(
      gr, gi, w, t, mask, fr, fi, uw, scal, partials, H, W, ilog2(H), tc,
      ilog2(tc), tw_fwd, rule, stats_on);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_stats_reduce(partials, n_blocks, sums, maxs, stream);
}

int slm_cols_mraf_mix_inv(const float* fr, const float* fi, const float* uw,
                          const float* mcode, const float* pffr,
                          const float* pffi, const float* zwr,
                          const float* zwi, float* hr, float* hi,
                          float* pffr_out, float* pffi_out, float* zwr_out,
                          float* zwi_out, const float* scal,
                          const double* sums, int H, int W, int tc,
                          const float2* tw_inv, int kim, int zero,
                          cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = cols_setup(cols_mraf_mix_inv_kernel, H, W, tc, &smem);
  if (err != cudaSuccess) return (int)err;
  cols_mraf_mix_inv_kernel<<<W / tc, kThreads, smem, stream>>>(
      fr, fi, uw, mcode, pffr, pffi, zwr, zwi, hr, hi, pffr_out, pffi_out,
      zwr_out, zwi_out, scal, sums, H, W, ilog2(H), tc, ilog2(tc), tw_inv,
      kim, zero);
  return (int)cudaGetLastError();
}

}  // extern "C"
