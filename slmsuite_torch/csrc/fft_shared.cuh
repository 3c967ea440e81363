// Shared-memory FFT used by every kernel of wgs_carry.cu, natural_fft.cu and
// mraf_carry.cu, and the column kernels' tile load, store and launch setup.
//
// Replaces `_fft_core` in slmsuite_tpu/ops/pallas_fft.py: a four-step DFT
// written as block-complex matrix products for the TPU's matrix unit. On
// Hopper a line of up to 4096 complex f32 (32 KB) fits in shared memory,
// so the transform is a plain radix-2 Cooley-Tukey in natural order: a
// bit-reversal permutation, then log2(n) decimation-in-time stages, each
// followed by a block barrier. Unnormalized in both directions, like the
// TPU kernels.
//
// The twiddle table is built once per (n, direction) on the host in
// float64 and stored as f32: tw[k] = exp(sign * 2 pi i k / n), k < n/2,
// sign = -1 forward, +1 inverse.

#pragma once

#include <cuda_runtime.h>

namespace slm {

constexpr int kThreads = 256;

// In-place FFT of `lines` complex lines of length n held back to back in
// shared memory (line j at buf[j * n]). n is a power of two, n = 1 << log2n.
// Every thread of the block must call it; it ends with a barrier.
__device__ __forceinline__ void fft_lines(float2* buf, int n, int log2n,
                                          int lines,
                                          const float2* __restrict__ tw) {
  const int total = lines * n;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int i = idx & (n - 1);
    const int r = __brev(i) >> (32 - log2n);
    if (i < r) {
      float2* a = buf + (idx - i);
      const float2 t = a[i];
      a[i] = a[r];
      a[r] = t;
    }
  }
  __syncthreads();

  const int half = n >> 1;
  const int half_total = lines * half;
  for (int s = 0; s < log2n; ++s) {
    const int m = 1 << s;                 // half the butterfly span
    const int tw_shift = log2n - 1 - s;   // twiddle stride n / (2m)
    for (int b = threadIdx.x; b < half_total; b += blockDim.x) {
      const int line = b >> (log2n - 1);
      const int q = b & (half - 1);
      const int k = q & (m - 1);
      const int i0 = ((q >> s) << (s + 1)) + k;
      float2* a = buf + line * n;
      const float2 w = __ldg(&tw[k << tw_shift]);
      const float2 x0 = a[i0];
      const float2 x1 = a[i0 + m];
      const float2 t = make_float2(x1.x * w.x - x1.y * w.y,
                                   x1.x * w.y + x1.y * w.x);
      a[i0] = make_float2(x0.x + t.x, x0.y + t.y);
      a[i0 + m] = make_float2(x0.x - t.x, x0.y - t.y);
    }
    __syncthreads();
  }
}

// Load tile `blockIdx.x` of `tc` adjacent columns of the (H, W) pair into
// buf (column j of the tile at buf[j * H]). Element idx of the tile is
// column j = idx % tc, row r = idx / tc, so a warp reads whole row
// segments. Ends with a barrier.
__device__ __forceinline__ void load_col_tile(float2* buf,
                                              const float* __restrict__ xr,
                                              const float* __restrict__ xi,
                                              int H, int W, int tc,
                                              int log2tc) {
  const int c0 = blockIdx.x * tc;
  for (int idx = threadIdx.x; idx < tc * H; idx += blockDim.x) {
    const int j = idx & (tc - 1);
    const int r = idx >> log2tc;
    const size_t g = (size_t)r * W + c0 + j;
    buf[j * H + r] = make_float2(xr[g], xi[g]);
  }
  __syncthreads();
}

// Store the tile back as a pair, in the layout of load_col_tile.
__device__ __forceinline__ void store_col_tile(const float2* buf,
                                               float* __restrict__ yr,
                                               float* __restrict__ yi, int H,
                                               int W, int tc, int log2tc) {
  const int c0 = blockIdx.x * tc;
  for (int idx = threadIdx.x; idx < tc * H; idx += blockDim.x) {
    const int j = idx & (tc - 1);
    const int r = idx >> log2tc;
    const size_t g = (size_t)r * W + c0 + j;
    const float2 v = buf[j * H + r];
    yr[g] = v.x;
    yi[g] = v.y;
  }
}

// log2 of a power of two (host side, for the launchers).
inline int ilog2(int n) {
  int k = 0;
  while ((1 << k) < n) ++k;
  return k;
}

// The column kernels' grid (W / tc blocks) and dynamic shared memory
// (tc * H complex values, above the 48 KB default at H >= 2048).
template <typename Kernel>
cudaError_t cols_setup(Kernel kernel, int H, int W, int tc, size_t* smem) {
  if (tc <= 0 || (tc & (tc - 1)) || W % tc) return cudaErrorInvalidValue;
  *smem = (size_t)tc * H * sizeof(float2);
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

}  // namespace slm
