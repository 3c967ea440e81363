// Carry-mode WGS loop kernels for Hopper (sm_90a).
//
// The loop carries the rows-transformed field pair (gr, gi) = FFT_rows of
// amp * e^{i psi}, in natural order. One iteration is two kernels, as on
// the TPU: the cols round trip (forward column FFT, WGS epilogue, inverse
// column FFT) and the rows round trip (inverse row FFT, amplitude
// replacement, forward row FFT). Entry and exit convert psi to and from
// the carry. Semantics: the plain PyTorch versions in
// slmsuite_torch/ops/fft.py (`_wgs_carry_entry`, `_wgs_carry_step`,
// `_wgs_carry_exit`).
//
// What bounds them on the H100: memory traffic. At 2048^2 one f32 plane
// is 16 MiB; a Kim step with stats reads gr, gi, w, t, mask, pffr, pffi
// and writes hr, hi, w', pffr', pffi' in the cols kernel, then reads
// hr, hi and writes gr', gi' in the rows kernel: 16 plane crossings, about
// 270 MB, or ~80 us at 3.35 TB/s. The FFT arithmetic (5 N log2 N flops
// per axis pass, four passes) is ~1 GFLOP per step, well under the f32
// peak. The simple design keeps every intermediate (the farfield, the
// constrained field, the nearfield) in shared memory, so each kernel
// touches device memory once per operand; the column kernel stages a tile
// of `tc` adjacent columns so that each row segment it loads is 4 * tc
// contiguous bytes. Fully coalesced column access is later work.
//
// Launchers take raw pointers, sizes, flags and a stream, and return
// cudaGetLastError(). They allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "carry_shared.cuh"

namespace slm {

// #1 <- pallas_fft.wgs_carry_entry_pallas (_rows_phase_kernel,
// _rows_phase_amp_kernel). One block per row: z = amp * e^{i psi} with a
// fully range-reduced sincosf (psi is unbounded on warm starts), then the
// forward row FFT.
__global__ void __launch_bounds__(kThreads)
carry_entry_kernel(const float* __restrict__ psi, const float* __restrict__ amp,
                   float* __restrict__ gr, float* __restrict__ gi, int W,
                   int log2W, const float2* __restrict__ tw) {
  extern __shared__ float2 sbuf[];
  const size_t base = (size_t)blockIdx.x * W;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    float s, c;
    sincosf(psi[base + i], &s, &c);
    const float a = amp ? amp[base + i] : 1.f;
    sbuf[i] = make_float2(a * c, a * s);
  }
  __syncthreads();
  fft_lines(sbuf, W, log2W, 1, tw);
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    gr[base + i] = sbuf[i].x;
    gi[base + i] = sbuf[i].y;
  }
}

// #2 <- pallas_fft.wgs_carry_step_pallas kernel B
// (_cols_wgs_roundtrip_kernel(phasor=True) with _wgs_epilogue,
// _weight_correction, _acc_tiles). One block per tile of `tc` adjacent
// columns: forward column FFT, f = post * |F|, the rule's correction,
// w' = w * c (nan -> 1e-4) scaled by 1/prev-norm once the update is on,
// the unit phasor F/|F| (zero -> (1, 0)) with the Kim select against the
// stored phasor, the constrained field w' * phasor, the stats partials
// (carry_shared.cuh), then the inverse column FFT.
__global__ void __launch_bounds__(kThreads)
cols_wgs_roundtrip_kernel(
    const float* __restrict__ gr, const float* __restrict__ gi,
    const float* __restrict__ w, const float* __restrict__ t,
    const float* __restrict__ mask, const float* __restrict__ pffr,
    const float* __restrict__ pffi, float* __restrict__ hr,
    float* __restrict__ hi, float* __restrict__ wout,
    float* __restrict__ pffr_out, float* __restrict__ pffi_out,
    const float* __restrict__ scal, double* __restrict__ partials, int H, int W,
    int log2H, int tc, int log2tc, const float2* __restrict__ tw_fwd,
    const float2* __restrict__ tw_inv, int rule, int kim, int stats_on) {
  extern __shared__ float2 sbuf[];  // tc columns of length H, back to back
  const int c0 = blockIdx.x * tc;
  const int total = tc * H;
  load_col_tile(sbuf, gr, gi, H, W, tc, log2tc);
  fft_lines(sbuf, H, log2H, tc, tw_fwd);

  const StepScalars s = load_scalars(scal);
  float facc[2] = {0.f, 0.f};    // overlap, |w'|^2
  double dacc[2] = {0.0, 0.0};   // err_sum, err_sq
  float macc[4] = {kNegFill, kNegFill, kNegFill, kNegFill};
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int j = idx & (tc - 1);
    const int r = idx >> log2tc;
    const size_t g = (size_t)r * W + c0 + j;
    const float2 F = sbuf[j * H + r];
    const float f2 = F.x * F.x + F.y * F.y;
    const float f = sqrtf(f2) * s.post;
    const float tv = t[g];
    const float wo = updated_weight(f, tv, w[g], s, rule);
    wout[g] = wo;

    float er = 1.f, ei = 0.f;
    if (f2 > 0.f) {
      const float ib = rsqrtf(f2);
      er = F.x * ib;
      ei = F.y * ib;
    }
    if (kim) {
      if (!s.use_theta) {
        er = pffr[g];
        ei = pffi[g];
      }
      pffr_out[g] = er;
      pffi_out[g] = ei;
    }
    sbuf[j * H + r] = make_float2(wo * er, wo * ei);

    facc[1] += wo * wo;
    if (stats_on)
      stats_accumulate(f, tv, mask[g], s.inv_tsum, s.inv_fsum, facc, dacc, macc);
  }
  __syncthreads();
  fft_lines(sbuf, H, log2H, tc, tw_inv);
  store_col_tile(sbuf, hr, hi, H, W, tc, log2tc);
  write_partials(facc, dacc, macc, partials);
}

// Second pass of #2: one block folds the (n_blocks, 8) partials into
// sums[0:4] (float64 storage; the overlap and |w'|^2 summed in float32,
// the error moments in float64) and maxs[0:4] (float32), in a fixed order.
__global__ void __launch_bounds__(kThreads)
stats_reduce_kernel(const double* __restrict__ partials, int n_blocks,
                    double* __restrict__ sums, float* __restrict__ maxs) {
  float facc[2] = {0.f, 0.f};
  double dacc[2] = {0.0, 0.0};
  float macc[4] = {kNegFill, kNegFill, kNegFill, kNegFill};
  for (int b = threadIdx.x; b < n_blocks; b += blockDim.x) {
    const double* in = partials + b * 8;
    facc[0] += (float)in[0];
    dacc[0] += in[1];
    dacc[1] += in[2];
    facc[1] += (float)in[3];
    for (int k = 0; k < 4; ++k) macc[k] = fmaxf(macc[k], (float)in[4 + k]);
  }
  block_reduce(facc, dacc, macc);
  if (threadIdx.x == 0) {
    sums[0] = facc[0];
    sums[1] = dacc[0];
    sums[2] = dacc[1];
    sums[3] = facc[1];
    for (int k = 0; k < 4; ++k) maxs[k] = macc[k];
  }
}

// #3 <- pallas_fft.wgs_carry_step_pallas kernel A (_rows_normfwd_kernel,
// _rows_normfwd_amp_kernel). One block per row: inverse row FFT -> Z,
// Z/|Z| or amp * Z/|Z| (zero -> 1 or amp, real), forward row FFT.
__global__ void __launch_bounds__(kThreads)
rows_normfwd_kernel(const float* __restrict__ hr, const float* __restrict__ hi,
                    const float* __restrict__ amp, float* __restrict__ gr,
                    float* __restrict__ gi, int W, int log2W,
                    const float2* __restrict__ tw_fwd,
                    const float2* __restrict__ tw_inv) {
  extern __shared__ float2 sbuf[];
  const size_t base = (size_t)blockIdx.x * W;
  for (int i = threadIdx.x; i < W; i += blockDim.x)
    sbuf[i] = make_float2(hr[base + i], hi[base + i]);
  __syncthreads();
  fft_lines(sbuf, W, log2W, 1, tw_inv);
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    const float2 z = sbuf[i];
    const float a = amp ? amp[base + i] : 1.f;
    const float mag2 = z.x * z.x + z.y * z.y;
    if (mag2 > 0.f) {
      const float inv = a * rsqrtf(mag2);
      sbuf[i] = make_float2(z.x * inv, z.y * inv);
    } else {
      sbuf[i] = make_float2(a, 0.f);
    }
  }
  __syncthreads();
  fft_lines(sbuf, W, log2W, 1, tw_fwd);
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    gr[base + i] = sbuf[i].x;
    gi[base + i] = sbuf[i].y;
  }
}

// #4 <- pallas_fft.wgs_carry_exit_pallas (_rows_phase_extract_kernel).
// One block per row: inverse row FFT, then atan2f.
__global__ void __launch_bounds__(kThreads)
carry_exit_kernel(const float* __restrict__ gr, const float* __restrict__ gi,
                  float* __restrict__ psi, int W, int log2W,
                  const float2* __restrict__ tw_inv) {
  extern __shared__ float2 sbuf[];
  const size_t base = (size_t)blockIdx.x * W;
  for (int i = threadIdx.x; i < W; i += blockDim.x)
    sbuf[i] = make_float2(gr[base + i], gi[base + i]);
  __syncthreads();
  fft_lines(sbuf, W, log2W, 1, tw_inv);
  for (int i = threadIdx.x; i < W; i += blockDim.x)
    psi[base + i] = atan2f(sbuf[i].y, sbuf[i].x);
}

cudaError_t launch_stats_reduce(const double* partials, int n_blocks,
                                double* sums, float* maxs, cudaStream_t stream) {
  stats_reduce_kernel<<<1, kThreads, 0, stream>>>(partials, n_blocks, sums,
                                                  maxs);
  return cudaGetLastError();
}

}  // namespace slm

using namespace slm;

extern "C" {

int slm_carry_entry(const float* psi, const float* amp, float* gr, float* gi,
                    int H, int W, const float2* tw, cudaStream_t stream) {
  carry_entry_kernel<<<H, kThreads, W * sizeof(float2), stream>>>(
      psi, amp, gr, gi, W, ilog2(W), tw);
  return (int)cudaGetLastError();
}

int slm_cols_wgs_roundtrip(const float* gr, const float* gi, const float* w,
                           const float* t, const float* mask,
                           const float* pffr, const float* pffi, float* hr,
                           float* hi, float* wout, float* pffr_out,
                           float* pffi_out, const float* scal,
                           double* partials, double* sums, float* maxs,
                           int H, int W,
                           int tc, const float2* tw_fwd, const float2* tw_inv,
                           int rule, int kim, int stats_on,
                           cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = cols_setup(cols_wgs_roundtrip_kernel, H, W, tc, &smem);
  if (err != cudaSuccess) return (int)err;
  const int n_blocks = W / tc;
  cols_wgs_roundtrip_kernel<<<n_blocks, kThreads, smem, stream>>>(
      gr, gi, w, t, mask, pffr, pffi, hr, hi, wout, pffr_out, pffi_out, scal,
      partials, H, W, ilog2(H), tc, ilog2(tc), tw_fwd, tw_inv, rule, kim,
      stats_on);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_stats_reduce(partials, n_blocks, sums, maxs, stream);
}

int slm_rows_normfwd(const float* hr, const float* hi, const float* amp,
                     float* gr, float* gi, int H, int W, const float2* tw_fwd,
                     const float2* tw_inv, cudaStream_t stream) {
  rows_normfwd_kernel<<<H, kThreads, W * sizeof(float2), stream>>>(
      hr, hi, amp, gr, gi, W, ilog2(W), tw_fwd, tw_inv);
  return (int)cudaGetLastError();
}

int slm_carry_exit(const float* gr, const float* gi, float* psi, int H, int W,
                   const float2* tw_inv, cudaStream_t stream) {
  carry_exit_kernel<<<H, kThreads, W * sizeof(float2), stream>>>(
      gr, gi, psi, W, ilog2(W), tw_inv);
  return (int)cudaGetLastError();
}

}  // extern "C"
