// Natural-order FFT kernels of the GS engine's natural (non-fused) path,
// for Hopper (sm_90a).
//
// One natural step is a forward 2D FFT to (|F|, arg F), the farfield
// constraint in PyTorch, and an inverse 2D FFT back to psi. Where the
// farfield is the SLM plane, the forward half is carry_entry (wgs_carry.cu)
// then cols_fwd_polar, and the backward half cols_wexp_inv then carry_exit
// (wgs_carry.cu). On a padded canvas or with a propagation kernel, it is
// rows_fft then cols_fwd_polar, and cols_wexp_inv then rows_fft; fft2 and
// ifft2 outside the loop are rows_fft and cols_fft. Semantics: the
// plain PyTorch versions `_rows_fft`, `_cols_fft`, `_cols_fwd_polar` and
// `_cols_wexp_inv` in slmsuite_torch/ops/fft.py.
//
// What bounds them on the H100: memory traffic. Each kernel reads two f32
// planes and writes two (at 2048^2, 4 x 16.8 MB = 67 MB, 20 us at
// 3.35 TB/s); its FFT arithmetic, 5 N log2 N flops per line, is ~0.23
// GFLOP, 3.5 us at the 67 TFLOP/s f32 peak. So the design touches device
// memory once per operand: a row kernel holds one row in shared memory,
// a column kernel a tile of `tc` adjacent columns (64 KiB), so that each
// row segment it loads is 4 * tc contiguous bytes, as in wgs_carry.cu.
// The polar output, the ortho scale and the constraint synthesis
// w * e^{i phi} live in the kernels' prologues and epilogues, so no
// complex farfield plane exists in device memory in the full-fuse
// geometry.
//
// Launchers take raw pointers, sizes, scales and a stream, and return
// cudaGetLastError(). They allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_shared.cuh"

namespace slm {

// #5 (rows half) <- pallas_fft._fft_rows / _rows_kernel (used by
// fft2_scrambled_pallas, ifft2_scrambled_pallas). One block per row:
// forward or inverse FFT by the twiddle table, times `scale`.
__global__ void __launch_bounds__(kThreads)
rows_fft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi, int W,
                int log2W, const float2* __restrict__ tw, float scale) {
  extern __shared__ float2 sbuf[];
  const size_t base = (size_t)blockIdx.x * W;
  for (int i = threadIdx.x; i < W; i += blockDim.x)
    sbuf[i] = make_float2(xr[base + i], xi[base + i]);
  __syncthreads();
  fft_lines(sbuf, W, log2W, 1, tw);
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    yr[base + i] = sbuf[i].x * scale;
    yi[base + i] = sbuf[i].y * scale;
  }
}

// #5 (cols half) <- pallas_fft._fft_cols / _cols_kernel. One block per
// tile of `tc` columns: forward or inverse column FFT, times `scale`.
__global__ void __launch_bounds__(kThreads)
cols_fft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi, int H, int W,
                int log2H, int tc, int log2tc, const float2* __restrict__ tw,
                float scale) {
  extern __shared__ float2 sbuf[];
  load_col_tile(sbuf, xr, xi, H, W, tc, log2tc);
  fft_lines(sbuf, H, log2H, tc, tw);
  const int c0 = blockIdx.x * tc;
  for (int idx = threadIdx.x; idx < tc * H; idx += blockDim.x) {
    const int j = idx & (tc - 1);
    const int r = idx >> log2tc;
    const size_t g = (size_t)r * W + c0 + j;
    const float2 v = sbuf[j * H + r];
    yr[g] = v.x * scale;
    yi[g] = v.y * scale;
  }
}

// #5 polar and #6 (cols half) <- pallas_fft._cols_kernel(polar_out=True)
// (fft2_scrambled_polar_pallas; fft2_scrambled_polar_from_phase's last
// pallas_call). One block per tile of `tc` columns: forward column FFT,
// then |F| * scale and atan2f(im, re) (0 where F = 0, as torch.atan2).
__global__ void __launch_bounds__(kThreads)
cols_fwd_polar_kernel(const float* __restrict__ xr,
                      const float* __restrict__ xi, float* __restrict__ amp,
                      float* __restrict__ theta, int H, int W, int log2H,
                      int tc, int log2tc, const float2* __restrict__ tw,
                      float scale) {
  extern __shared__ float2 sbuf[];
  load_col_tile(sbuf, xr, xi, H, W, tc, log2tc);
  fft_lines(sbuf, H, log2H, tc, tw);
  const int c0 = blockIdx.x * tc;
  for (int idx = threadIdx.x; idx < tc * H; idx += blockDim.x) {
    const int j = idx & (tc - 1);
    const int r = idx >> log2tc;
    const size_t g = (size_t)r * W + c0 + j;
    const float2 F = sbuf[j * H + r];
    amp[g] = sqrtf(F.x * F.x + F.y * F.y) * scale;
    theta[g] = atan2f(F.y, F.x);
  }
}

// #11 (cols half) <- pallas_fft.wexp_ifft2_scrambled_phase
// (_cols_wexp_inv_kernel). One block per tile of `tc` columns: the
// constraint w * e^{i phi} (full-range sincosf) synthesised in shared
// memory, then the unnormalized inverse column FFT. carry_exit_kernel
// (wgs_carry.cu) finishes arg ifft2 with the inverse rows and atan2f;
// rows_fft_kernel (inverse, ortho scale) finishes the complex ifft2 of
// pallas_fft.wexp_ifft2_scrambled (#12) on the padded canvas.
__global__ void __launch_bounds__(kThreads)
cols_wexp_inv_kernel(const float* __restrict__ w, const float* __restrict__ phi,
                     float* __restrict__ yr, float* __restrict__ yi, int H,
                     int W, int log2H, int tc, int log2tc,
                     const float2* __restrict__ tw_inv) {
  extern __shared__ float2 sbuf[];
  const int c0 = blockIdx.x * tc;
  for (int idx = threadIdx.x; idx < tc * H; idx += blockDim.x) {
    const int j = idx & (tc - 1);
    const int r = idx >> log2tc;
    const size_t g = (size_t)r * W + c0 + j;
    float s, c;
    sincosf(phi[g], &s, &c);
    const float wv = w[g];
    sbuf[j * H + r] = make_float2(wv * c, wv * s);
  }
  __syncthreads();
  fft_lines(sbuf, H, log2H, tc, tw_inv);
  store_col_tile(sbuf, yr, yi, H, W, tc, log2tc);
}

}  // namespace slm

using namespace slm;

extern "C" {

int slm_rows_fft(const float* xr, const float* xi, float* yr, float* yi, int H,
                 int W, const float2* tw, float scale, cudaStream_t stream) {
  rows_fft_kernel<<<H, kThreads, W * sizeof(float2), stream>>>(
      xr, xi, yr, yi, W, ilog2(W), tw, scale);
  return (int)cudaGetLastError();
}

int slm_cols_fft(const float* xr, const float* xi, float* yr, float* yi, int H,
                 int W, int tc, const float2* tw, float scale,
                 cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = cols_setup(cols_fft_kernel, H, W, tc, &smem);
  if (err != cudaSuccess) return (int)err;
  cols_fft_kernel<<<W / tc, kThreads, smem, stream>>>(
      xr, xi, yr, yi, H, W, ilog2(H), tc, ilog2(tc), tw, scale);
  return (int)cudaGetLastError();
}

int slm_cols_fwd_polar(const float* xr, const float* xi, float* amp,
                       float* theta, int H, int W, int tc, const float2* tw,
                       float scale, cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = cols_setup(cols_fwd_polar_kernel, H, W, tc, &smem);
  if (err != cudaSuccess) return (int)err;
  cols_fwd_polar_kernel<<<W / tc, kThreads, smem, stream>>>(
      xr, xi, amp, theta, H, W, ilog2(H), tc, ilog2(tc), tw, scale);
  return (int)cudaGetLastError();
}

int slm_cols_wexp_inv(const float* w, const float* phi, float* yr, float* yi,
                      int H, int W, int tc, const float2* tw_inv,
                      cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = cols_setup(cols_wexp_inv_kernel, H, W, tc, &smem);
  if (err != cudaSuccess) return (int)err;
  cols_wexp_inv_kernel<<<W / tc, kThreads, smem, stream>>>(
      w, phi, yr, yi, H, W, ilog2(H), tc, ilog2(tc), tw_inv);
  return (int)cudaGetLastError();
}

}  // extern "C"
