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
// SLM that is 2.7e8 pairs, while the bytes (the basis and the two fields)
// move in ~6 us. So f2n, n2f and fused_iter are bound by the rate at
// which the SMs dispatch those instructions: fused_iter's bound in
// PERF.md, 0.18 ms, counts the sincos as 24 f32 operations.
// fused_iter_cached reads the (N, P) cos/sin cache instead, 2.15 GB at
// that size, and is bound by bytes at ~0.64 ms.
//
// The sincos. Phases reach hundreds of radians, and libdevice's sincosf
// costs ~40-70 instructions a pair with its range reduction. The kernels
// take the TPU kernel's route (pallas_fft._sincos_reduced): sincos_reduced
// rounds k = x / 2 pi to the nearest integer, forms y = x - k 2 pi by a
// three-term Cody-Waite split in three fmaf, folds y back into [-pi, pi]
// where rounding picked k off by one, and takes __sincosf (two SFU
// operations) on [-pi, pi]; the TPU's minimax pair on the FMA pipe in its
// place made fused_iter 1.36 times slower. Against float64 sin and cos of
// the same f32 phase the reduction is within 4.1e-7 up to |x| = 1e5
// (ops/cuda_compressed.py sincos_reduced_model, tests/test_torch_compressed.py)
// and __sincosf within 2^-21.41 on [-pi, pi] (CUDA's documented bound):
// ~8e-7 in all. Beyond kReducedLimit = 1e5, where the split stops being
// exact (k * k2PiA needs |k| < 2^16), libdevice's sincosf runs inline. On
// the H100, fused_iter at config 5 is within 2.9e-7 of the plain version
// in float64 (max |diff| / max |float64|; the plain f32 version 3.6e-7), and
// with phases up to 1e6 within 1.9e-7 (chip_smoke.py phase_compressed_parity).
//
// Design. Blocks take chunks of kBlockPixels pixels in parallel; each
// block writes its (N,) partial sums, and spot_reduce sums them over the
// blocks in a fixed order. No atomics: a run is repeatable bit for bit.
//
// fused_iter, for N <= kWarpSpots (256), is fused_spots_kernel: lanes on
// spots, a spot's farfield and sums and a chunk's cos/sin in registers,
// the nearfield of a pixel summed over the lanes by shuffles (its note
// below). Its range check is one warp vote a chunk (sincos_reduced_lanes),
// so the chunk's 32 pairs a lane carry no branch. 0.37 ms at config 5, 50%
// of the row bound; the first structure below with the same sincos took
// 0.75 ms, and with libdevice's sincosf 0.78 (PERF.md, section 6).
//
// n2f, fused_iter_cached and fused_iter beyond 256 spots are
// `roundtrip_kernel`. Its first half has lanes on pixels and warp w on
// spots w, w + 8, ...: it forms the cos/sin of each (spot, pixel) pair
// (sincos_reduced, or a coalesced read of the cache) and, for the round
// trips, the nearfield of the sub-chunk of 32 pixels, which the amplitude
// replacement needs over all N spots. Its second half reduces the replaced
// field (for n2f, the given nearfield) back onto the spots. It keeps the
// sub-chunk's (N, 32) cos/sin in shared memory between the halves (66 KiB
// at N = 256), so each pair costs one sincos or one read of the cache, and
// lets each thread own whole spots in the second half, summing its 32
// pixels from its row into registers, with no shuffle (rows are
// XOR-swizzled, so neither half has a bank conflict). When N is too large
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

// The period reduction of sincos_reduced (ops/cuda_compressed.py
// `sincos_reduced_model` holds the same constants, and
// tests/test_torch_compressed.py reads them from here): 2 pi split in three
// f32 terms, the first with 8 significant bits, so that k * k2PiA is exact
// for |k| < 2^16 and each fmaf below rounds once.
constexpr float kInv2Pi = 0.15915493667125702f;
constexpr float k2PiA = 6.28125f;
constexpr float k2PiB = 0.0019353071693331003f;
constexpr float k2PiC = 1.0253376273028358e-11f;
constexpr float kPiF = 3.1415927410125732f;
constexpr float k2PiF = 6.2831854820251465f;
// |phase| above which sincos_reduced takes libdevice's sincosf.
constexpr float kReducedLimit = 1e5f;

// (sin, cos) of a phase in +-kReducedLimit: k = rint(x / 2 pi), y = x -
// k 2 pi by three fmaf (Cody-Waite), y folded back into [-pi, pi] where
// rounding picked k off by one, then __sincosf (the SFU) on [-pi, pi].
__device__ __forceinline__ void sincos_near(float x, float* s, float* c) {
  const float k = rintf(x * kInv2Pi);
  float y = fmaf(-k, k2PiA, x);
  y = fmaf(-k, k2PiB, y);
  y = fmaf(-k, k2PiC, y);
  if (fabsf(y) > kPiF) y -= copysignf(k2PiF, y);
  __sincosf(y, s, c);
}

// (sin, cos) of any phase: sincos_near, and beyond kReducedLimit
// libdevice's sincosf inline.
__device__ __forceinline__ void sincos_reduced(float x, float* s, float* c) {
  if (fabsf(x) > kReducedLimit) sincosf(x, s, c);
  else sincos_near(x, s, c);
}

// sincos_reduced of K phases a lane holds, with one warp vote on the range:
// where no lane holds a phase beyond kReducedLimit (the rule), the K pairs
// are formed without a branch, so that their latencies overlap. Every lane
// of the warp calls it.
template <int K>
__device__ __forceinline__ void sincos_reduced_lanes(const float (&x)[K], float (&s)[K],
                                                     float (&c)[K]) {
  float m = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) m = fmaxf(m, fabsf(x[k]));
  if (__any_sync(0xffffffffu, m > kReducedLimit)) {
#pragma unroll
    for (int k = 0; k < K; ++k) sincos_reduced(x[k], &s[k], &c[k]);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) sincos_near(x[k], &s[k], &c[k]);
  }
}

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
      sincos_reduced(spot_phase(coef, kSpotChunk, n, b, D), &s, &c);
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
          sincos_reduced(spot_phase(coef, N, n, b, D), &s, &c);
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
          sincos_reduced(spot_phase(coef, N, n, b, D), &s, &c);
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

// #16 fused_iter with lanes on spots, for N <= kWarpSpots: each warp takes
// chunks of kChunk pixels of the block on its own, every lane kLaneSpots
// spots (lane + 32 j); the spots' farfield and accumulators stay in
// registers, and so do the chunk's cos/sin between the halves. The basis
// of the block's pixels and the coefficients are staged once in shared
// memory as float4 groups of four terms (zero-padded), read as broadcasts
// (basis) and conflict-free rows (coefficients). The nearfield of a pixel
// is the sum over the warp's lanes: a butterfly that halves the chunk at
// offsets 16 and 8 and sums at 4, 2 and 1, after which lane l holds pixel
// 2 (l >> 4 & 1) + (l >> 3 & 1); its amp nf/|nf| goes back to every lane by
// shuffles. No block barrier inside the loop; the warps' sums are added in
// a fixed order at the end. 128 registers and sincosf's 32-byte stack
// frame, no spill: two blocks an SM. Spots past N have a zero farfield and
// coefficients and add nothing.
constexpr int kLaneSpots = 8;
constexpr int kWarpSpots = 32 * kLaneSpots;
constexpr int kChunk = 4;

__global__ void __launch_bounds__(kThreads)
fused_spots_kernel(const float* __restrict__ ffr, const float* __restrict__ ffi,
                   const float* __restrict__ coeffs, const float* __restrict__ basis,
                   const float* __restrict__ amp, int P, int N, int D,
                   float* __restrict__ partials) {
  // bs[kBlockPixels][dq], cf[kWarpSpots][dq]; after the loop, the warps'
  // sums red[kWarps][kWarpSpots] as (re, im) over bs.
  extern __shared__ float4 smem4[];
  const int dq = (D + 3) >> 2;
  float4* bs = smem4;
  float4* cf = bs + (size_t)kBlockPixels * dq;
  const int p0 = blockIdx.x * kBlockPixels;
  const int np = min(kBlockPixels, P - p0);
  for (int i = threadIdx.x; i < kBlockPixels * dq; i += kThreads) {
    const int p = i / dq, q = i - p * dq;
    float t[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int d = 4 * q + k;
      t[k] = (d < D && p < np) ? basis[(size_t)d * P + p0 + p] : 0.f;
    }
    bs[i] = make_float4(t[0], t[1], t[2], t[3]);
  }
  for (int i = threadIdx.x; i < kWarpSpots * dq; i += kThreads) {
    const int n = i / dq, q = i - n * dq;
    float t[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int d = 4 * q + k;
      t[k] = (d < D && n < N) ? coeffs[(size_t)d * N + n] : 0.f;
    }
    cf[i] = make_float4(t[0], t[1], t[2], t[3]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float fr[kLaneSpots], fi[kLaneSpots], acc_re[kLaneSpots], acc_im[kLaneSpots];
#pragma unroll
  for (int j = 0; j < kLaneSpots; ++j) {
    const int n = lane + 32 * j;
    fr[j] = n < N ? ffr[n] : 0.f;
    fi[j] = n < N ? ffi[n] : 0.f;
    acc_re[j] = acc_im[j] = 0.f;
  }
  const int mine = ((lane >> 4) & 1) * 2 + ((lane >> 3) & 1);
  constexpr int kPairs = kLaneSpots * kChunk;  // pair (j, c) at j * kChunk + c
  for (int c0 = warp * kChunk; c0 < np; c0 += kWarps * kChunk) {
    float ph[kPairs];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) ph[i] = 0.f;
    for (int q = 0; q < dq; ++q) {
      float4 b[kChunk], a[kLaneSpots];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) b[c] = bs[(c0 + c) * dq + q];
#pragma unroll
      for (int j = 0; j < kLaneSpots; ++j) a[j] = cf[(lane + 32 * j) * dq + q];
#pragma unroll
      for (int j = 0; j < kLaneSpots; ++j)
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          float v = fmaf(a[j].x, b[c].x, ph[j * kChunk + c]);
          v = fmaf(a[j].y, b[c].y, v);
          v = fmaf(a[j].z, b[c].z, v);
          ph[j * kChunk + c] = fmaf(a[j].w, b[c].w, v);
        }
    }
    float sn[kPairs], cs[kPairs];
    sincos_reduced_lanes(ph, sn, cs);
    float re[kChunk], im[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) re[c] = im[c] = 0.f;
#pragma unroll
    for (int j = 0; j < kLaneSpots; ++j)
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int i = j * kChunk + c;
        re[c] = fmaf(fr[j], cs[i], fmaf(-fi[j], sn[i], re[c]));
        im[c] = fmaf(fr[j], sn[i], fmaf(fi[j], cs[i], im[c]));
      }
    // The sum over the lanes (see above): lane ends with pixel `mine`.
    const bool up16 = lane & 16, up8 = lane & 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float sr = up16 ? re[i] : re[i + 2], si = up16 ? im[i] : im[i + 2];
      re[i] = (up16 ? re[i + 2] : re[i]) + __shfl_xor_sync(0xffffffffu, sr, 16);
      im[i] = (up16 ? im[i + 2] : im[i]) + __shfl_xor_sync(0xffffffffu, si, 16);
    }
    {
      const float sr = up8 ? re[0] : re[1], si = up8 ? im[0] : im[1];
      re[0] = (up8 ? re[1] : re[0]) + __shfl_xor_sync(0xffffffffu, sr, 8);
      im[0] = (up8 ? im[1] : im[0]) + __shfl_xor_sync(0xffffffffu, si, 8);
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
      re[0] += __shfl_xor_sync(0xffffffffu, re[0], o);
      im[0] += __shfl_xor_sync(0xffffffffu, im[0], o);
    }
    const int p = p0 + c0 + mine;
    const float2 um = amp_replace(re[0], im[0], amp, p, p < P);
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int src = (c >> 1) * 16 + (c & 1) * 8;
      const float ur = __shfl_sync(0xffffffffu, um.x, src);
      const float ui = __shfl_sync(0xffffffffu, um.y, src);
#pragma unroll
      for (int j = 0; j < kLaneSpots; ++j) {
        const int i = j * kChunk + c;
        acc_re[j] = fmaf(cs[i], ur, fmaf(sn[i], ui, acc_re[j]));
        acc_im[j] = fmaf(cs[i], ui, fmaf(-sn[i], ur, acc_im[j]));
      }
    }
  }
  __syncthreads();  // red overwrites bs
  float2* red = reinterpret_cast<float2*>(smem4);
#pragma unroll
  for (int j = 0; j < kLaneSpots; ++j)
    red[warp * kWarpSpots + lane + 32 * j] = make_float2(acc_re[j], acc_im[j]);
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += kThreads) {
    float2 v = make_float2(0.f, 0.f);
    for (int w = 0; w < kWarps; ++w) {
      v.x += red[w * kWarpSpots + n].x;
      v.y += red[w * kWarpSpots + n].y;
    }
    partials[(size_t)blockIdx.x * N + n] = v.x;
    partials[((size_t)gridDim.x + blockIdx.x) * N + n] = v.y;
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

// fused_iter: fused_spots_kernel where N <= kWarpSpots, else roundtrip_kernel.
cudaError_t launch_fused(const float* ffr, const float* ffi, const float* coeffs,
                         const float* basis, const float* amp, int P, int N, int D,
                         float* partials, float* out_re, float* out_im, cudaStream_t stream) {
  if (N > kWarpSpots)
    return launch_roundtrip<false, true>(ffr, ffi, nullptr, nullptr, coeffs, basis, nullptr,
                                         nullptr, 0, 1, amp, P, N, D, 1.f, partials, out_re,
                                         out_im, stream);
  const size_t smem = (size_t)(kBlockPixels + kWarpSpots) * ((D + 3) / 4) * sizeof(float4);
  cudaError_t err = set_smem(fused_spots_kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_blocks = n_blocks_of(P);
  fused_spots_kernel<<<n_blocks, kThreads, smem, stream>>>(ffr, ffi, coeffs, basis, amp, P, N,
                                                           D, partials);
  return finish(partials, n_blocks, N, 1.f, out_re, out_im, stream);
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
  return (int)launch_fused(ffr, ffi, coeffs, basis, amp, P, N, D, partials, out_re, out_im,
                           stream);
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
