// Compressed (grid-free) spot transforms for Hopper (sm_90a).
//
// The farfield is a length-N complex vector of spot amplitudes, the
// nearfield a length-P vector of SLM pixels, and the kernel between them
//   K[n, p] = exp(i Phi[n, p]),  Phi[n, p] = sum_d c[d, n] B[d, p],
// with c the (D, N) per-spot Zernike coefficients and B the (D, P) Zernike
// basis on the SLM grid. Semantics: the plain PyTorch versions in
// slmsuite_torch/ops/compressed.py (`_farfield_to_nearfield`,
// `_nearfield_to_farfield`, `_fused_iteration`, `_fused_iteration_cached`).
// They replace slmsuite_tpu/ops/pallas_compressed.py:
//   f2n               <- farfield_to_nearfield (:128, _f2n_kernel :61)
//   n2f               <- nearfield_to_farfield (:415, _n2f_kernel :92)
//   fused_iter        <- fused_iteration (:350, _fused_iter_kernel :199)
//   fused_iter_cached <- fused_iteration_cached (:289,
//                        _fused_iter_cached_kernel :241)
//
// What bounds them on the H100. A (spot, pixel) pair costs one sincos,
// D FMAs of phase and four FMAs per direction; at 256 spots on a 1024^2
// SLM that is 2.7e8 pairs, ~1.5e10 f32 operations when a sincos counts as
// 40, or ~0.2 ms at 67 TFLOP/s, while the bytes (the basis and the two
// fields) move in ~6 us. So f2n, n2f and fused_iter are bound by
// arithmetic. fused_iter_cached reads the (N, P) cos/sin cache instead,
// 2.15 GB at that size, and is bound by bytes at ~0.64 ms.
//
// Design. Phases reach hundreds of radians, so the sincos is libdevice's
// sincosf with its full range reduction (not __sincosf, and none of the
// TPU's minimax polynomials). Blocks take chunks of kBlockPixels pixels in
// parallel and walk them in sub-chunks of 32, one pixel per lane; each
// block writes its (N,) partial sums, and spot_reduce sums them over the
// blocks in a fixed order. No atomics: a run is repeatable bit for bit.
//
// n2f, fused_iter and fused_iter_cached are one kernel, `roundtrip_kernel`.
// Its first half has lanes on pixels and warp w on spots w, w + 8, ...: it
// forms the cos/sin of each (spot, pixel) pair (sincosf, or a coalesced
// read of the cache) and, for the round trips, the nearfield of the
// sub-chunk, which the amplitude replacement needs over all N spots. Its
// second half reduces the replaced field (for n2f, the given nearfield)
// back onto the spots. The choice: keep the sub-chunk's (N, 32) cos/sin in
// shared memory between the halves (66 KiB at N = 256), so each pair costs
// one sincos or one read of the cache, and let each thread own whole spots
// in the second half, summing its 32 pixels from its row into registers,
// with no shuffle (rows are XOR-swizzled, so neither half has a bank
// conflict and no padding costs an SM its third block). When N is too large
// to keep (`keep` false), the second half recomputes the sincos, or reads
// the cache again, with lanes on pixels and a fixed shuffle butterfly per
// spot.
//
// Launchers take raw pointers, sizes and a stream, allocate nothing, and
// return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace slm_cmp {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 16;             // Zernike terms the kernels take
constexpr int kSub = 32;              // pixels per sub-chunk: one per lane
constexpr int kBlockPixels = 1024;    // pixels per block of the reductions
constexpr int kSpotChunk = 512;       // spots staged at once by f2n
constexpr size_t kKeepLimit = 160 * 1024;  // shared bytes for the kept cos/sin

// Phase of spot n at the pixel whose basis values are b (coefficients
// staged as coef[d * N + n]).
__device__ __forceinline__ float spot_phase(const float* coef, int N, int n,
                                            const float (&b)[kMaxD], int D) {
  float phase = 0.f;
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) {
    if (d >= D) break;
    phase = fmaf(coef[d * N + n], b[d], phase);
  }
  return phase;
}

__device__ __forceinline__ void load_basis(const float* __restrict__ basis, int P,
                                           int D, int p, float (&b)[kMaxD]) {
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) b[d] = (d < D && p < P) ? basis[(size_t)d * P + p] : 0.f;
}

// Fixed-order sum over the 32 lanes; lane 0 holds the result.
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// Fixed-order sum over the block (kThreads threads); returns it to all.
__device__ float2 block_sum2(float2 v) {
  __shared__ float2 red[kThreads];
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      red[threadIdx.x].x += red[threadIdx.x + s].x;
      red[threadIdx.x].y += red[threadIdx.x + s].y;
    }
    __syncthreads();
  }
  const float2 out = red[0];
  __syncthreads();
  return out;
}

// amp * nf / |nf| (ops/compressed.py `_amp_replace`): a zero field becomes
// unit real, padded pixels (valid false) give 0; amp null is the scalar case.
__device__ __forceinline__ float2 amp_replace(float re, float im, const float* amp,
                                              int p, bool valid) {
  const float a = valid ? (amp ? amp[p] : 1.f) : 0.f;
  const float mag2 = re * re + im * im;
  if (mag2 > 0.f) {
    const float inv = a * rsqrtf(mag2);
    return make_float2(re * inv, im * inv);
  }
  return make_float2(a, 0.f);
}

// #14 f2n: one thread per pixel, spots staged in shared memory in chunks.
__global__ void __launch_bounds__(kThreads)
f2n_kernel(const float* __restrict__ ffr, const float* __restrict__ ffi,
           const float* __restrict__ coeffs, const float* __restrict__ basis,
           int P, int N, int D, float scale, float* __restrict__ nfr,
           float* __restrict__ nfi) {
  extern __shared__ float smem[];  // coef[D][kSpotChunk], fr, fi
  float* coef = smem;
  float* fr = coef + D * kSpotChunk;
  float* fi = fr + kSpotChunk;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  float b[kMaxD];
  load_basis(basis, P, D, p, b);
  float re = 0.f, im = 0.f;
  for (int s0 = 0; s0 < N; s0 += kSpotChunk) {
    const int ns = min(kSpotChunk, N - s0);
    __syncthreads();
    for (int i = threadIdx.x; i < ns; i += kThreads) {
      for (int d = 0; d < D; ++d) coef[d * kSpotChunk + i] = coeffs[(size_t)d * N + s0 + i];
      fr[i] = ffr[s0 + i];
      fi[i] = ffi[s0 + i];
    }
    __syncthreads();
    for (int n = 0; n < ns; ++n) {
      float s, c;
      sincosf(spot_phase(coef, kSpotChunk, n, b, D), &s, &c);
      re = fmaf(fr[n], c, fmaf(-fi[n], s, re));
      im = fmaf(fr[n], s, fmaf(fi[n], c, im));
    }
  }
  if (p < P) {
    nfr[p] = re * scale;
    nfi[p] = im * scale;
  }
}

// #15 n2f (kExpand false), #16 fused_iter and #17 fused_iter_cached
// (kExpand true): per block of kBlockPixels pixels, the (N,) partial sums
// of e^{-i Phi} times the given nearfield (n2f) or times amp nf/|nf| of the
// nearfield nf expanded from the farfield (the round trips). kCached reads
// cos/sin from the (n_tiles, N8, T) cache; kKeep keeps the sub-chunk's cos/sin
// in shared memory between the halves.
template <bool kCached, bool kKeep, bool kExpand>
__global__ void __launch_bounds__(kThreads)
roundtrip_kernel(const float* __restrict__ ffr, const float* __restrict__ ffi,
                 const float* __restrict__ nfr, const float* __restrict__ nfi,
                 const float* __restrict__ coeffs, const float* __restrict__ basis,
                 const float* __restrict__ kc, const float* __restrict__ ks, int N8,
                 int T, const float* __restrict__ amp, int P, int N, int D,
                 float* __restrict__ partials) {
  // cs[N][kSub] (kKeep), u[kSub] as (re, im) pairs, then the floats
  // part[2][kWarps][kSub], acc_re[N], acc_im[N], fr[N], fi[N] (kExpand),
  // coef[D][N] (recompute).
  extern __shared__ float4 smem4[];
  float2* cs = reinterpret_cast<float2*>(smem4);
  float2* u = cs + (kKeep ? (size_t)N * kSub : 0);
  float* part = reinterpret_cast<float*>(u + kSub);
  float* acc_re = part + 2 * kWarps * kSub;
  float* acc_im = acc_re + N;
  float* fr = acc_im + N;
  float* fi = fr + (kExpand ? N : 0);
  float* coef = fi + (kExpand ? N : 0);
  for (int i = threadIdx.x; i < N; i += kThreads) {
    acc_re[i] = acc_im[i] = 0.f;
    if (kExpand) {
      fr[i] = ffr[i];
      fi[i] = ffi[i];
    }
  }
  if (!kCached)
    for (int i = threadIdx.x; i < D * N; i += kThreads) coef[i] = coeffs[i];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p0 = blockIdx.x * kBlockPixels;
  for (int base = p0; base < min(P, p0 + kBlockPixels); base += kSub) {
    const int p = base + lane;
    // The cache covers whole tiles, so its pad pixels (p >= P) are readable.
    const size_t cache_off = kCached ? ((size_t)(p / T) * N8) * T + (p % T) : 0;
    float b[kMaxD];
    if (!kCached) load_basis(basis, P, D, p, b);

    // First half: the warp's spots at this lane's pixel (unrolled so that
    // 16 cache loads per warp are in flight at once).
    if (kExpand || kKeep) {
      float nre = 0.f, nim = 0.f;
#pragma unroll 8
      for (int n = warp; n < N; n += kWarps) {
        float s, c;
        if (kCached) {
          c = kc[cache_off + (size_t)n * T];
          s = ks[cache_off + (size_t)n * T];
        } else {
          sincosf(spot_phase(coef, N, n, b, D), &s, &c);
        }
        if (kKeep) cs[n * kSub + (lane ^ (n & (kSub - 1)))] = make_float2(c, s);
        if (kExpand) {
          nre = fmaf(fr[n], c, fmaf(-fi[n], s, nre));
          nim = fmaf(fr[n], s, fmaf(fi[n], c, nim));
        }
      }
      if (kExpand) {
        part[warp * kSub + lane] = nre;
        part[(kWarps + warp) * kSub + lane] = nim;
      }
    }
    __syncthreads();
    if (warp == 0) {
      if (kExpand) {
        float re = 0.f, im = 0.f;
        for (int w = 0; w < kWarps; ++w) {
          re += part[w * kSub + lane];
          im += part[(kWarps + w) * kSub + lane];
        }
        u[lane] = amp_replace(re, im, amp, p, p < P);
      } else {
        u[lane] = p < P ? make_float2(nfr[p], nfi[p]) : make_float2(0.f, 0.f);
      }
    }
    __syncthreads();

    // Second half: the field of the sub-chunk back onto the spots.
    if (kKeep) {
      for (int n = threadIdx.x; n < N; n += kThreads) {
        const float2* row = cs + n * kSub;
        const int swizzle = n & (kSub - 1);
        float re = 0.f, im = 0.f;
#pragma unroll 8
        for (int q = 0; q < kSub; ++q) {
          const float2 k = row[q ^ swizzle], v = u[q];
          re = fmaf(k.x, v.x, fmaf(k.y, v.y, re));
          im = fmaf(k.x, v.y, fmaf(-k.y, v.x, im));
        }
        acc_re[n] += re;
        acc_im[n] += im;
      }
    } else {
      const float2 v = u[lane];
      for (int n = warp; n < N; n += kWarps) {
        float s, c;
        if (kCached) {
          c = kc[cache_off + (size_t)n * T];
          s = ks[cache_off + (size_t)n * T];
        } else {
          sincosf(spot_phase(coef, N, n, b, D), &s, &c);
        }
        float re = fmaf(c, v.x, s * v.y), im = fmaf(c, v.y, -s * v.x);
        warp_sum2(re, im);
        if (lane == 0) {
          acc_re[n] += re;
          acc_im[n] += im;
        }
      }
    }
    __syncthreads();  // cs, part and u are rewritten by the next sub-chunk
  }
  for (int n = threadIdx.x; n < N; n += kThreads) {
    partials[(size_t)blockIdx.x * N + n] = acc_re[n];
    partials[((size_t)gridDim.x + blockIdx.x) * N + n] = acc_im[n];
  }
}

// Second pass: one block per spot sums the blocks' partials in a fixed
// order, times `scale`.
__global__ void __launch_bounds__(kThreads)
spot_reduce_kernel(const float* __restrict__ partials, int n_blocks, int N,
                   float scale, float* __restrict__ out_re,
                   float* __restrict__ out_im) {
  const int n = blockIdx.x;
  float2 v = make_float2(0.f, 0.f);
  for (int b = threadIdx.x; b < n_blocks; b += kThreads) {
    v.x += partials[(size_t)b * N + n];
    v.y += partials[((size_t)n_blocks + b) * N + n];
  }
  v = block_sum2(v);
  if (threadIdx.x == 0) {
    out_re[n] = v.x * scale;
    out_im[n] = v.y * scale;
  }
}

// n2f's last pass: divide the (N,) farfield by its norm (one block).
__global__ void __launch_bounds__(kThreads)
unit_norm_kernel(float* __restrict__ re, float* __restrict__ im, int N) {
  float2 v = make_float2(0.f, 0.f);
  for (int n = threadIdx.x; n < N; n += kThreads) v.x += re[n] * re[n] + im[n] * im[n];
  v = block_sum2(v);
  const float inv = 1.f / sqrtf(v.x);
  for (int n = threadIdx.x; n < N; n += kThreads) {
    re[n] *= inv;
    im[n] *= inv;
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

int n_blocks_of(int P) { return (P + kBlockPixels - 1) / kBlockPixels; }

cudaError_t finish(const float* partials, int n_blocks, int N, float scale,
                   float* out_re, float* out_im, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  spot_reduce_kernel<<<N, kThreads, 0, stream>>>(partials, n_blocks, N, scale,
                                                 out_re, out_im);
  return cudaGetLastError();
}

// Launches roundtrip_kernel (keeping the cos/sin when it fits) and the
// fixed-order spot_reduce that finishes it, scaled by `scale`.
template <bool kCached, bool kExpand>
cudaError_t launch_roundtrip(const float* ffr, const float* ffi, const float* nfr,
                             const float* nfi, const float* coeffs, const float* basis,
                             const float* kc, const float* ks, int N8, int T,
                             const float* amp, int P, int N, int D, float scale,
                             float* partials, float* out_re, float* out_im,
                             cudaStream_t stream) {
  const size_t fixed = (size_t)kSub * sizeof(float2) +
                       (size_t)(2 * kWarps * kSub + 2 * N + (kExpand ? 2 * N : 0) +
                                (kCached ? 0 : D * N)) * sizeof(float);
  const size_t kept = fixed + (size_t)N * kSub * sizeof(float2);
  const bool keep = kept <= kKeepLimit;
  const size_t smem = keep ? kept : fixed;
  auto kernel = keep ? roundtrip_kernel<kCached, true, kExpand>
                     : roundtrip_kernel<kCached, false, kExpand>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_blocks = n_blocks_of(P);
  kernel<<<n_blocks, kThreads, smem, stream>>>(ffr, ffi, nfr, nfi, coeffs, basis, kc, ks,
                                               N8, T, amp, P, N, D, partials);
  return finish(partials, n_blocks, N, scale, out_re, out_im, stream);
}

}  // namespace slm_cmp

using namespace slm_cmp;

extern "C" {

int slm_cmp_f2n(const float* ffr, const float* ffi, const float* coeffs,
                const float* basis, int P, int N, int D, float scale, float* nfr,
                float* nfi, cudaStream_t stream) {
  const size_t smem = (size_t)(D + 2) * kSpotChunk * sizeof(float);
  f2n_kernel<<<(P + kThreads - 1) / kThreads, kThreads, smem, stream>>>(
      ffr, ffi, coeffs, basis, P, N, D, scale, nfr, nfi);
  return (int)cudaGetLastError();
}

int slm_cmp_n2f(const float* nfr, const float* nfi, const float* coeffs,
                const float* basis, int P, int N, int D, float scale,
                float* partials, float* out_re, float* out_im,
                cudaStream_t stream) {
  cudaError_t err = launch_roundtrip<false, false>(
      nullptr, nullptr, nfr, nfi, coeffs, basis, nullptr, nullptr, 0, 1, nullptr, P, N, D,
      scale, partials, out_re, out_im, stream);
  if (err != cudaSuccess) return (int)err;
  unit_norm_kernel<<<1, kThreads, 0, stream>>>(out_re, out_im, N);
  return (int)cudaGetLastError();
}

int slm_cmp_fused(const float* ffr, const float* ffi, const float* coeffs,
                  const float* basis, const float* amp, int P, int N, int D,
                  float* partials, float* out_re, float* out_im,
                  cudaStream_t stream) {
  return (int)launch_roundtrip<false, true>(ffr, ffi, nullptr, nullptr, coeffs, basis,
                                            nullptr, nullptr, 0, 1, amp, P, N, D, 1.f,
                                            partials, out_re, out_im, stream);
}

int slm_cmp_fused_cached(const float* ffr, const float* ffi, const float* kc,
                         const float* ks, int N8, int T, const float* amp, int P,
                         int N, float* partials, float* out_re, float* out_im,
                         cudaStream_t stream) {
  return (int)launch_roundtrip<true, true>(ffr, ffi, nullptr, nullptr, nullptr, nullptr,
                                           kc, ks, N8, T, amp, P, N, 0, 1.f, partials,
                                           out_re, out_im, stream);
}

int slm_cmp_block_pixels() { return kBlockPixels; }

}  // extern "C"
