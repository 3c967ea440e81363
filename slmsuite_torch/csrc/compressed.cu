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
// which the SMs dispatch those instructions: their bounds in PERF.md
// (0.15 ms for f2n and n2f, 0.18 for fused_iter) count the sincos as 24
// f32 operations. fused_iter_cached reads the (N, P) cos/sin cache
// instead, 2.15 GB at that size, and is bound by bytes at ~0.64 ms.
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
// f2n, n2f and fused_spots_kernel check the range once a chunk by a warp
// vote (sincos_reduced_lanes, sincos_reduced_each), so the chunk's pairs
// carry no branch and their latencies overlap; lanes on tail pixels and
// pad spots take part with phase 0 and a zero weight (in the wide kernels
// with a clamped column's terms and a zero weight, or sums left unused).
//
// Design. Lanes hold what a pair reads most: n2f and fused_iter (up to
// kWarpSpots = 256 spots) put lanes on spots, with the spots' sums (and
// for D <= 4 their coefficients) in registers and the block's pixels'
// basis staged once in shared memory as float4 groups of four terms, read
// as broadcasts. n2f sums over pixels, so its loop needs no shuffle and no
// barrier; fused_iter sums a pixel's nearfield over the lanes by shuffles
// (its note below). f2n sums over spots, so its lanes sit on pixels, four
// a thread, and each broadcast of a spot's coefficients and farfield
// feeds four independent sums. Blocks take chunks of kBlockPixels pixels
// in parallel (n2f also groups of kWarpSpots spots: any N runs); each
// writes its (N,) partial sums, and spot_reduce sums them over the blocks
// in a fixed order. No atomics: a run is repeatable bit for bit.
//
// fused_iter beyond kWarpSpots spots runs as two launches, f2n with the
// amplitude replacement, then n2f unnormalized (the wrapper composes
// them): each pair then costs two sincos, but both kernels keep their
// spots or pixels in registers and any N runs.
//
// Any number of Zernike terms. Up to kWideTerms (16) terms, f2n and n2f are
// instantiated per term count (terms_of) and keep the basis of their pixels
// or spots in registers or staged whole. Past it they take the wide kernels
// (their note below): the operand a thread reuses (f2n: its pixels' basis;
// n2f, lanes on spots: its spots' coefficients) in registers, the other
// staged through a cp.async ring and read as broadcasts, instantiated per
// term count up to 44 and, beyond, one kernel with the group count at run
// time, up to slm_cmp_max_terms() = 7,248 terms (the phase enters a sincos,
// so the terms cannot be split across launches). fused_spots_kernel stages
// its block's basis and coefficients for any term count up to kFusedGroups
// float4 groups (44 terms); past it fused_iter runs as f2n then n2f, as it
// does past kWarpSpots spots. fused_iter_cached reads the cache, whose
// build (a matrix product in PyTorch) takes any term count.
//
// fused_iter_cached is `roundtrip_kernel`. Its first half has lanes on
// pixels and warp w on spots w, w + 8, ...: it reads the cos/sin of each
// (spot, pixel) pair from the cache (coalesced) and forms the nearfield of
// the sub-chunk of 32 pixels, which the amplitude replacement needs over
// all N spots. Its second half reduces the replaced field back onto the
// spots. It keeps the sub-chunk's (N, 32) cos/sin in shared memory between
// the halves (66 KiB at N = 256), so each pair costs one read of the
// cache, and lets each thread own whole spots in the second half, summing
// its 32 pixels from its row into registers, with no shuffle (rows are
// XOR-swizzled, so neither half has a bank conflict). When N is too large
// to keep (`keep` false), the second half reads the cache again, with
// lanes on pixels and a fixed shuffle butterfly per spot. It holds every
// spot's farfield and sums in shared memory, which bounds N (the wrapper
// checks).
//
// Launchers take raw pointers, sizes and a stream, allocate nothing, and
// return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

// The build compiles this source twice (ops/cuda_fft.py `_UNITS`): the
// second object (SLM_UNIT_MIXED=1) holds the wide kernels past kWideSplit
// terms alone, the first everything else, so that the two halves of the
// wide kernels' instantiations compile in parallel.
#ifndef SLM_UNIT_MIXED
#define SLM_UNIT_MIXED 0
#endif

namespace slm_cmp {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWideTerms = 16;        // past this many terms f2n and n2f run wide
constexpr int kSub = 32;              // pixels per sub-chunk: one per lane
constexpr int kBlockPixels = 1024;    // pixels per block of the reductions
constexpr int kSpotChunk = 512;       // spots staged at once by f2n
constexpr size_t kKeepLimit = 160 * 1024;  // shared bytes for the kept cos/sin
constexpr int kLaneSpots = 8;         // spots a lane (lanes on spots)
constexpr int kWarpSpots = 32 * kLaneSpots;
constexpr int kChunk = 4;             // pixels a warp of fused_iter takes at once
constexpr int kN2fChunk = 2;          // pixels a warp of n2f takes at once
constexpr int kPixelSpots = 8;        // spots f2n takes at once
constexpr int kThreadPixels = 4;      // pixels an f2n thread sums
constexpr size_t kSmemLimit = 227 * 1024;  // shared bytes a block may take
constexpr size_t kWideSmem = 64 * 1024;    // the wide kernels' ring past kWideMax terms
// float4 groups of terms fused_spots_kernel stages (basis and coefficients).
constexpr int kFusedGroups =
    (int)(kSmemLimit / ((kBlockPixels + kWarpSpots) * sizeof(float4)));

// The period reduction of sincos_reduced (ops/cuda_compressed.py
// `sincos_reduced_model` holds the same constants, and
// tests/test_torch_compressed.py reads them from here): 1 / 2 pi; 2 pi split
// in three f32 terms, the first with 8 significant bits, so that k * k2PiA
// is exact for |k| < 2^16 and each fmaf below rounds once; pi and 2 pi as
// f32; and 1.5 2^23, whose sum with any |t| < 2^22 has the unit 1 as its
// last place.
constexpr float kInv2Pi = 0.15915493667125702f;
constexpr float k2PiA = 6.28125f;
constexpr float k2PiB = 0.0019353071693331003f;
constexpr float k2PiC = 1.0253376273028358e-11f;
constexpr float kPiF = 3.1415927410125732f;
constexpr float k2PiF = 6.2831854820251465f;
constexpr float kRoundShift = 12582912.0f;
// |phase| above which sincos_reduced takes libdevice's sincosf.
constexpr float kReducedLimit = 1e5f;

// (sin, cos) of a phase in +-kReducedLimit: k = rint(x kInv2Pi), the f32
// product rounded to the nearest integer (ties to even) by adding and
// subtracting kRoundShift, which gives rintf's k and so its bits, on the
// f32 pipe where rintf issues on the quarter-rate one beside __sincosf's two
// operations; y = x - k 2 pi by three fmaf (Cody-Waite), folded back into
// [-pi, pi] where the product's rounding picked the farther k (within ~1e-3
// of a half period; y lies up to ~4e-3 past +-pi there, and __sincosf,
// bounded on [-pi, pi], is less accurate: PERF.md, section 6); then
// __sincosf (the SFU) on y.
__device__ __forceinline__ void sincos_near(float x, float* s, float* c) {
  const float k = __fadd_rn(__fadd_rn(__fmul_rn(x, kInv2Pi), kRoundShift), -kRoundShift);
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

// The same vote, handing each pair to f(k, sin, cos) as it is formed (so
// that the caller need not hold the K pairs at once).
template <int K, typename F>
__device__ __forceinline__ void sincos_reduced_each(const float (&x)[K], F&& f) {
  float m = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) m = fmaxf(m, fabsf(x[k]));
  if (__any_sync(0xffffffffu, m > kReducedLimit)) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float s, c;
      sincos_reduced(x[k], &s, &c);
      f(k, s, c);
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float s, c;
      sincos_near(x[k], &s, &c);
      f(k, s, c);
    }
  }
}

// Terms 4q .. 4q + 3 of column i of a (D, n) row-major array as a float4:
// zero past D and past n (tail pixels of the basis, pad spots of the
// coefficients).
__device__ __forceinline__ float4 terms4(const float* __restrict__ x, int n, int D, int i,
                                         int q) {
  float t[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int d = 4 * q + k;
    t[k] = (d < D && i < n) ? x[(size_t)d * n + i] : 0.f;
  }
  return make_float4(t[0], t[1], t[2], t[3]);
}

// acc + a . b over the first T (1 to 4) of a float4's terms, one fmaf a term.
template <int T>
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  if (T > 1) acc = fmaf(a.y, b.y, acc);
  if (T > 2) acc = fmaf(a.z, b.z, acc);
  if (T > 3) acc = fmaf(a.w, b.w, acc);
  return acc;
}

// The kernels' term count for D terms: D itself up to 4 (one float4 group,
// its products formed for those terms only), else D rounded up to whole
// groups of four: DQ groups, each product over kPerGroup terms of a group.
constexpr int terms_of(int D) { return D <= 4 ? D : 4 * ((D + 3) / 4); }
template <int DT>
struct Terms {
  static constexpr int DQ = (DT + 3) / 4;
  static constexpr int kPerGroup = DT < 4 ? DT : 4;
};

// Fixed-order sum over the 32 lanes; lane 0 holds the result.
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

#if !SLM_UNIT_MIXED
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
#endif  // !SLM_UNIT_MIXED

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

// #14 f2n: lanes on pixels, kThreadPixels a thread (p, p + 256, ...), the
// basis of each in registers as DQ float4 groups. The spots are staged in
// shared memory kSpotChunk at a time (coefficients as float4 groups, the
// farfield as (re, im); zero past N, so any N runs) and read as broadcasts,
// kPixelSpots at once: each broadcast feeds kThreadPixels independent sums.
// The phase is formed over the DT terms (terms_of) alone. The output is
// written once, scaled by `scale`, or (replace) its amplitude replacement
// amp nf/|nf|. At D = 3, 80 registers and sincosf's stack frame, no spill:
// three blocks an SM.
template <int DT>
__global__ void __launch_bounds__(kThreads)
f2n_kernel(const float* __restrict__ ffr, const float* __restrict__ ffi,
           const float* __restrict__ coeffs, const float* __restrict__ basis,
           const float* __restrict__ amp, int P, int N, int D, float scale, int replace,
           float* __restrict__ nfr, float* __restrict__ nfi) {
  constexpr int DQ = Terms<DT>::DQ, kT = Terms<DT>::kPerGroup;
  constexpr int PIX = kThreadPixels, SPOTS = kPixelSpots;
  extern __shared__ float4 smem4[];  // cf[kSpotChunk][DQ], ff[kSpotChunk]
  float4* cf = smem4;
  float2* ff = reinterpret_cast<float2*>(cf + kSpotChunk * DQ);
  const int pb = blockIdx.x * kThreads * PIX + threadIdx.x;
  float4 b[PIX][DQ];
#pragma unroll
  for (int c = 0; c < PIX; ++c)
#pragma unroll
    for (int q = 0; q < DQ; ++q) b[c][q] = terms4(basis, P, D, pb + kThreads * c, q);
  float re[PIX], im[PIX];
#pragma unroll
  for (int c = 0; c < PIX; ++c) re[c] = im[c] = 0.f;
  constexpr int kPairs = SPOTS * PIX;  // pair (j, c) at j * PIX + c
  for (int s0 = 0; s0 < N; s0 += kSpotChunk) {
    const int ns = min(kSpotChunk, N - s0);
    const int staged = (ns + SPOTS - 1) / SPOTS * SPOTS;
    __syncthreads();  // the previous chunk is read
    for (int i = threadIdx.x; i < staged; i += kThreads) {
#pragma unroll
      for (int q = 0; q < DQ; ++q) cf[i * DQ + q] = terms4(coeffs, N, D, s0 + i, q);
      ff[i] = i < ns ? make_float2(ffr[s0 + i], ffi[s0 + i]) : make_float2(0.f, 0.f);
    }
    __syncthreads();
    for (int n = 0; n < staged; n += SPOTS) {
      float ph[kPairs];
#pragma unroll
      for (int i = 0; i < kPairs; ++i) ph[i] = 0.f;
      float2 f[SPOTS];
#pragma unroll
      for (int j = 0; j < SPOTS; ++j) {
        f[j] = ff[n + j];
#pragma unroll
        for (int q = 0; q < DQ; ++q) {
          const float4 a = cf[(n + j) * DQ + q];
#pragma unroll
          for (int c = 0; c < PIX; ++c) ph[j * PIX + c] = dot4<kT>(a, b[c][q], ph[j * PIX + c]);
        }
      }
      sincos_reduced_each(ph, [&](int i, float s, float co) {
        const int j = i / PIX, c = i % PIX;
        re[c] = fmaf(f[j].x, co, fmaf(-f[j].y, s, re[c]));
        im[c] = fmaf(f[j].x, s, fmaf(f[j].y, co, im[c]));
      });
    }
  }
#pragma unroll
  for (int c = 0; c < PIX; ++c) {
    const int p = pb + kThreads * c;
    if (p < P) {
      const float2 o = replace ? amp_replace(re[c], im[c], amp, p, true)
                               : make_float2(re[c] * scale, im[c] * scale);
      nfr[p] = o.x;
      nfi[p] = o.y;
    }
  }
}

// #15 n2f: lanes on spots. Block (x, y) takes pixels x kBlockPixels ..
// and spots y kWarpSpots ..: each lane kLaneSpots spots (lane + 32 j),
// whose sums stay in registers (and, for DQ = 1, their coefficients; for
// more terms the coefficients are staged as conflict-free float4 rows
// cf[q][spot]). The block's basis and nearfield are staged once and read
// as broadcasts; each warp takes chunks of kN2fChunk pixels on its own,
// with no shuffle and no barrier in the loop, and forms the phase over the
// DT terms (terms_of) alone. Tail pixels have a zero basis and nearfield,
// pad spots zero coefficients: both add nothing that is kept. At D = 3, 80
// registers and sincosf's stack frame, no spill: three blocks an SM.
template <int DT>
__global__ void __launch_bounds__(kThreads, 3)
n2f_kernel(const float* __restrict__ nfr, const float* __restrict__ nfi,
           const float* __restrict__ coeffs, const float* __restrict__ basis, int P, int N,
           int D, float* __restrict__ partials) {
  constexpr int DQ = Terms<DT>::DQ, kT = Terms<DT>::kPerGroup, CHUNK = kN2fChunk;
  // bs[kBlockPixels][DQ], nf[kBlockPixels], cf[DQ][kWarpSpots] (DQ > 1);
  // after the loop the warps' sums red[kWarps][kWarpSpots] over bs.
  extern __shared__ float4 smem4[];
  float4* bs = smem4;
  float2* nf = reinterpret_cast<float2*>(bs + kBlockPixels * DQ);
  float4* cf = reinterpret_cast<float4*>(nf + kBlockPixels);
  const int p0 = blockIdx.x * kBlockPixels;
  const int np = min(kBlockPixels, P - p0);
  const int n0 = blockIdx.y * kWarpSpots;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kBlockPixels * DQ; i += kThreads) {
    const int p = i / DQ, q = i - p * DQ;
    bs[i] = p < np ? terms4(basis + p0, P, D, p, q) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = threadIdx.x; i < kBlockPixels; i += kThreads)
    nf[i] = i < np ? make_float2(nfr[p0 + i], nfi[p0 + i]) : make_float2(0.f, 0.f);
  float4 a[kLaneSpots];
  if constexpr (DQ == 1) {
#pragma unroll
    for (int j = 0; j < kLaneSpots; ++j) a[j] = terms4(coeffs, N, D, n0 + lane + 32 * j, 0);
  } else {
    for (int i = threadIdx.x; i < DQ * kWarpSpots; i += kThreads) {
      const int q = i / kWarpSpots, n = i - q * kWarpSpots;
      cf[i] = terms4(coeffs, N, D, n0 + n, q);
    }
  }
  __syncthreads();

  float acc_re[kLaneSpots], acc_im[kLaneSpots];
#pragma unroll
  for (int j = 0; j < kLaneSpots; ++j) acc_re[j] = acc_im[j] = 0.f;
  constexpr int kPairs = kLaneSpots * CHUNK;  // pair (j, c) at j * CHUNK + c
  for (int c0 = warp * CHUNK; c0 < np; c0 += kWarps * CHUNK) {
    float ph[kPairs];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) ph[i] = 0.f;
#pragma unroll
    for (int q = 0; q < DQ; ++q) {
      float4 bq[CHUNK];
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) bq[c] = bs[(c0 + c) * DQ + q];
#pragma unroll
      for (int j = 0; j < kLaneSpots; ++j) {
        float4 aj;
        if constexpr (DQ == 1) aj = a[j];
        else aj = cf[q * kWarpSpots + lane + 32 * j];
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) ph[j * CHUNK + c] = dot4<kT>(aj, bq[c], ph[j * CHUNK + c]);
      }
    }
    float2 v[CHUNK];
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) v[c] = nf[c0 + c];
    sincos_reduced_each(ph, [&](int i, float s, float co) {
      const int j = i / CHUNK, c = i % CHUNK;
      acc_re[j] = fmaf(co, v[c].x, fmaf(s, v[c].y, acc_re[j]));
      acc_im[j] = fmaf(co, v[c].y, fmaf(-s, v[c].x, acc_im[j]));
    });
  }
  // The warps' sums in a fixed order: red[kWarps][kWarpSpots] over bs.
  __syncthreads();
  float2* red = reinterpret_cast<float2*>(smem4);
#pragma unroll
  for (int j = 0; j < kLaneSpots; ++j)
    red[warp * kWarpSpots + lane + 32 * j] = make_float2(acc_re[j], acc_im[j]);
  __syncthreads();
  for (int n = threadIdx.x; n < min(kWarpSpots, N - n0); n += kThreads) {
    float2 v = make_float2(0.f, 0.f);
    for (int w = 0; w < kWarps; ++w) {
      v.x += red[w * kWarpSpots + n].x;
      v.y += red[w * kWarpSpots + n].y;
    }
    partials[(size_t)blockIdx.x * N + n0 + n] = v.x;
    partials[((size_t)gridDim.x + blockIdx.x) * N + n0 + n] = v.y;
  }
}

// ---------------------------------------------------------------------------
// #14 and #15 past kWideTerms terms: f2n_wide_kernel and n2f_wide_kernel.
//
// Past 16 terms a pair's phase (D fmaf) is most of its work, beside one
// sincos and four fmaf. So each kernel keeps the operand that a thread
// reuses in registers, reads the other as a shared-memory broadcast, and
// loads nothing from global memory in its pair loop. f2n keeps lanes on
// pixels, Wide<D>::R a thread, with their basis in registers, and
// broadcasts the spots' coefficients and farfield; n2f keeps lanes on
// spots, R a lane, with their coefficients in registers, and broadcasts
// the pixels' basis and nearfield (no shuffle: a lane sums its own spots
// over the pixels). Each broadcast of a float4 group feeds R pairs, so a
// pair costs G / R shared loads beside its D fmaf. What they broadcast is
// staged kWideItems at a time (f2n: spots; n2f: pixels of its block)
// through a ring of two buffers by cp.async (`copy4`): the copy of the next
// buffer overlaps the pairs of this one, one barrier a buffer.
//
// Instantiated per term count from 17 to kWideMax = 44 (float4 groups G =
// 5 .. 11, those fused_spots_kernel stages), so that the group loop is
// unrolled and the last group forms its products over the D - 4 (G - 1)
// terms it holds alone (dot4<T>); R = 2 up to 8 groups and 1 beyond, so
// that two blocks of kThreads fit an SM (128 registers a thread); a thread
// forms K = 16 pairs before one sincos vote. Past kWideMax terms the same
// kernels run with D = 0: the group count at run time and the thread's
// operand read from global memory a group at a time (coalesced; tail pixels
// and pad spots clamped, their sums unused; the next group loaded before
// this one's products), the ring of two buffers of at most kWideSmem, else
// one (slm_cmp_max_terms(): eight items of 7,248 terms fill a block's shared
// memory), and K = 32 pairs wherever a buffer holds 16 items, so that each
// group loaded from global memory feeds 32 pairs.
//
// n2f's grid is pixel blocks (kBlockPixels, the partials' blocks) x spot
// groups. A block's warps take `groups` (a power of two) columns of 32 R
// spots and split the block's pixels `kWarps / groups` ways; their sums
// go into the partials in a fixed order, as n2f_kernel's do.

constexpr int kWideMax = 4 * kFusedGroups;  // terms of the last compile-time instantiation
constexpr int kWideSplit = 30;              // the second object's instantiations start past it
constexpr int kWideItems = 256;             // items a buffer stages (D > 0)

template <int D, int K_ = 16>
struct Wide {
  static constexpr int G = (D + 3) / 4;                // float4 groups (D = 0: at run time)
  static constexpr int T = D - 4 * (G - 1);            // terms of the last group
  static constexpr int R = D == 0 || G <= 8 ? 2 : 1;   // f2n: pixels a thread; n2f: spots a lane
  // Pairs a thread forms before one sincos vote: 16, and at the group count
  // at run time 32 where a buffer holds 16 items, so that each group of the
  // thread's operand, loaded from global memory, feeds twice the pairs.
  static constexpr int K = K_;
  static constexpr int J = K / R;                      // f2n: spots a step; n2f: pixels a step
};

// One 4-byte copy from global to shared memory, asynchronous on the card
// (cp.async; copy_wait completes the thread's copies), zero where !valid
// (then nothing is read). The host stand-in copies at once.
__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 4 : 0));
#else
  *dst = valid ? *src : 0.f;
#endif
}

__device__ __forceinline__ void copy_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// Stages items i0 .. i0 + items - 1 of the (D, stride) row-major array x
// (coefficients or basis) as float4 groups dst[q * items + i] (terms 4q ..
// 4q + 3, zero past D), then the (re, im) pairs of the same items as
// float2 after them; items at or past `end` are zero. Four neighbouring
// threads copy one item's four terms of a group, so a warp's copies read
// four 32-byte segments and land on 32 consecutive words.
__device__ __forceinline__ void stage_items(const float* __restrict__ x,
                                            const float* __restrict__ re,
                                            const float* __restrict__ im, int stride, int end,
                                            int D, int dq, int i0, int items, float* dst) {
  for (int q = 0; q < dq; ++q)
    for (int t = threadIdx.x; t < 4 * items; t += kThreads) {
      const int i = i0 + (t >> 2), d = 4 * q + (t & 3);
      copy4(dst + ((size_t)q * items << 2) + t,
            x + (size_t)min(d, D - 1) * stride + min(i, end - 1), d < D && i < end);
    }
  float* pairs = dst + ((size_t)dq * items << 2);
  for (int t = threadIdx.x; t < 2 * items; t += kThreads) {
    const int i = i0 + (t >> 1);
    copy4(pairs + t, ((t & 1) ? im : re) + min(i, end - 1), i < end);
  }
  copy_commit();
}

// The float4 group q of column i of a (D, stride) row-major array, read
// from global memory (terms past D zero).
template <int D>
__device__ __forceinline__ float4 column_group(const float* __restrict__ x, int stride, int i,
                                               int d_run, int q) {
  const int Dt = D ? D : d_run;
  float t[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int d = 4 * q + k;
    t[k] = d < Dt ? x[(size_t)d * stride + i] : 0.f;
  }
  return make_float4(t[0], t[1], t[2], t[3]);
}

// acc + a . b over a group's terms: all four, or the last group's T.
template <int D>
__device__ __forceinline__ float dot_group(float4 a, float4 b, float acc, bool last) {
  return last ? dot4<Wide<D>::T>(a, b, acc) : dot4<4>(a, b, acc);
}

// The thread's operand (f2n: its pixels' basis; n2f: its spots' coefficients)
// in registers, R columns of the (D, stride) array, loaded once.
template <int D, bool kHeld = (D > 0)>
struct Held {
  float4 v[Wide<D>::R][Wide<D>::G];
  __device__ __forceinline__ Held(const float* __restrict__ x, int stride,
                                  const int (&col)[Wide<D>::R], int) {
#pragma unroll
    for (int r = 0; r < Wide<D>::R; ++r)
#pragma unroll
      for (int q = 0; q < Wide<D>::G; ++q) v[r][q] = column_group<D>(x, stride, col[r], D, q);
  }
  __device__ __forceinline__ float4 group(int r, int q) const { return v[r][q]; }
};

// Past kWideMax terms: the operand read a group at a time from global memory.
template <int D>
struct Held<D, false> {
  const float* x;
  int stride, d_run, col[Wide<D>::R];
  __device__ __forceinline__ Held(const float* __restrict__ x_, int stride_,
                                  const int (&col_)[Wide<D>::R], int d_run_)
      : x(x_), stride(stride_), d_run(d_run_) {
#pragma unroll
    for (int r = 0; r < Wide<D>::R; ++r) col[r] = col_[r];
  }
  __device__ __forceinline__ float4 group(int r, int q) const {
    return column_group<0>(x, stride, col[r], d_run, q);
  }
};

// f2n past kWideTerms terms. Block b takes pixels b kThreads R .. (thread t
// pixels t, t + kThreads, ...); spots are staged kWideItems (`items`) at a
// time and taken J at a time, each step's J x R pairs formed before one
// sincos vote. The output is written once, scaled by `scale`, or (replace)
// its amplitude replacement amp nf/|nf|.
template <int D, int K>
__global__ void __launch_bounds__(kThreads, 2)
f2n_wide_kernel(const float* __restrict__ ffr, const float* __restrict__ ffi,
                const float* __restrict__ coeffs, const float* __restrict__ basis,
                const float* __restrict__ amp, int P, int N, int d_run, int items_run,
                int ring_run, float scale, int replace, float* __restrict__ nfr,
                float* __restrict__ nfi) {
  using W = Wide<D, K>;
  constexpr int R = W::R, J = W::J;
  const int Dt = D ? D : d_run, dq = D ? W::G : (d_run + 3) >> 2;
  const int items = D ? kWideItems : items_run, ring = D ? 2 : ring_run;
  extern __shared__ float4 smem4[];  // ring x (cf[dq][items], ff[items])
  float* const buf0 = reinterpret_cast<float*>(smem4);
  float* const buf1 = buf0 + (size_t)items * (4 * dq + 2);
  const int pb = blockIdx.x * kThreads * R + threadIdx.x;
  int col[R];
#pragma unroll
  for (int c = 0; c < R; ++c) col[c] = min(pb + kThreads * c, P - 1);
  const Held<D> b(basis, P, col, d_run);
  float re[R], im[R];
#pragma unroll
  for (int c = 0; c < R; ++c) re[c] = im[c] = 0.f;
  const int n_bufs = (N + items - 1) / items;
  stage_items(coeffs, ffr, ffi, N, N, Dt, dq, 0, items, buf0);
  for (int k = 0; k < n_bufs; ++k) {
    copy_wait();
    __syncthreads();  // buffer k is staged; the other one is read
    const float* cur = ring == 2 && (k & 1) ? buf1 : buf0;
    if (ring == 2 && k + 1 < n_bufs)
      stage_items(coeffs, ffr, ffi, N, N, Dt, dq, (k + 1) * items, items, (k & 1) ? buf0 : buf1);
    const float4* cf = reinterpret_cast<const float4*>(cur);
    const float2* ff = reinterpret_cast<const float2*>(cur + ((size_t)dq * items << 2));
    const int staged = min(items, (N - k * items + J - 1) / J * J);
    for (int n = 0; n < staged; n += J) {
      float ph[W::K];  // pair (j, c) at j R + c
#pragma unroll
      for (int i = 0; i < W::K; ++i) ph[i] = 0.f;
      float4 bq[R];
#pragma unroll
      for (int c = 0; c < R; ++c) bq[c] = b.group(c, 0);
#pragma unroll
      for (int q = 0; q < dq; ++q) {
        float4 next[R];  // group q + 1, loaded before group q's products
#pragma unroll
        for (int c = 0; c < R; ++c) next[c] = b.group(c, q + 1 < dq ? q + 1 : q);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float4 a = cf[(size_t)q * items + n + j];
#pragma unroll
          for (int c = 0; c < R; ++c)
            ph[j * R + c] = dot_group<D>(a, bq[c], ph[j * R + c], D && q + 1 == W::G);
        }
#pragma unroll
        for (int c = 0; c < R; ++c) bq[c] = next[c];
      }
      sincos_reduced_each(ph, [&](int i, float s, float co) {
        const int j = i / R, c = i % R;
        const float2 f = ff[n + j];
        re[c] = fmaf(f.x, co, fmaf(-f.y, s, re[c]));
        im[c] = fmaf(f.x, s, fmaf(f.y, co, im[c]));
      });
    }
    if (ring == 1 && k + 1 < n_bufs) {
      __syncthreads();  // the one buffer is read
      stage_items(coeffs, ffr, ffi, N, N, Dt, dq, (k + 1) * items, items, buf0);
    }
  }
#pragma unroll
  for (int c = 0; c < R; ++c) {
    const int p = pb + kThreads * c;
    if (p < P) {
      const float2 o = replace ? amp_replace(re[c], im[c], amp, p, true)
                               : make_float2(re[c] * scale, im[c] * scale);
      nfr[p] = o.x;
      nfi[p] = o.y;
    }
  }
}

// n2f past kWideTerms terms. Block (x, y) takes pixels x kBlockPixels ..
// and spots y 32 R groups ..; warp w takes the spot column w % groups (lane
// l spots l + 32 j) and every (kWarps / groups)-th step of J pixels of each
// staged buffer, from step w / groups. Its sums stay in registers; after
// the loop the warps' sums of a spot are added in a fixed order into the
// block's partials (pad spots' sums are dropped).
template <int D, int K>
__global__ void __launch_bounds__(kThreads, 2)
n2f_wide_kernel(const float* __restrict__ nfr, const float* __restrict__ nfi,
                const float* __restrict__ coeffs, const float* __restrict__ basis, int P, int N,
                int d_run, int items_run, int ring_run, int groups,
                float* __restrict__ partials) {
  using W = Wide<D, K>;
  constexpr int R = W::R, J = W::J, kColumn = 32 * R;
  const int Dt = D ? D : d_run, dq = D ? W::G : (d_run + 3) >> 2;
  const int items = D ? kWideItems : items_run, ring = D ? 2 : ring_run;
  // ring x (bs[dq][items], nf[items]); after the loop red[kWarps][kColumn].
  extern __shared__ float4 smem4[];
  float* const buf0 = reinterpret_cast<float*>(smem4);
  float* const buf1 = buf0 + (size_t)items * (4 * dq + 2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int column = warp & (groups - 1), part = warp / groups, parts = kWarps / groups;
  const int n0 = blockIdx.y * kColumn * groups + column * kColumn + lane;
  int col[R];
#pragma unroll
  for (int j = 0; j < R; ++j) col[j] = min(n0 + 32 * j, N - 1);
  const Held<D> a(coeffs, N, col, d_run);
  float acc_re[R], acc_im[R];
#pragma unroll
  for (int j = 0; j < R; ++j) acc_re[j] = acc_im[j] = 0.f;
  const int p0 = blockIdx.x * kBlockPixels, end = min(P, p0 + kBlockPixels);
  const int n_bufs = (end - p0 + items - 1) / items;
  stage_items(basis, nfr, nfi, P, end, Dt, dq, p0, items, buf0);
  for (int k = 0; k < n_bufs; ++k) {
    copy_wait();
    __syncthreads();  // buffer k is staged; the other one is read
    const float* cur = ring == 2 && (k & 1) ? buf1 : buf0;
    if (ring == 2 && k + 1 < n_bufs)
      stage_items(basis, nfr, nfi, P, end, Dt, dq, p0 + (k + 1) * items, items,
                  (k & 1) ? buf0 : buf1);
    const float4* bs = reinterpret_cast<const float4*>(cur);
    const float2* nf = reinterpret_cast<const float2*>(cur + ((size_t)dq * items << 2));
    const int staged = min(items, (end - p0 - k * items + J - 1) / J * J);
    for (int c0 = part * J; c0 < staged; c0 += parts * J) {
      float ph[W::K];  // pair (c, j) at c R + j
#pragma unroll
      for (int i = 0; i < W::K; ++i) ph[i] = 0.f;
      float4 aq[R];
#pragma unroll
      for (int j = 0; j < R; ++j) aq[j] = a.group(j, 0);
#pragma unroll
      for (int q = 0; q < dq; ++q) {
        float4 next[R];  // group q + 1, loaded before group q's products
#pragma unroll
        for (int j = 0; j < R; ++j) next[j] = a.group(j, q + 1 < dq ? q + 1 : q);
#pragma unroll
        for (int c = 0; c < J; ++c) {
          const float4 bc = bs[(size_t)q * items + c0 + c];
#pragma unroll
          for (int j = 0; j < R; ++j)
            ph[c * R + j] = dot_group<D>(aq[j], bc, ph[c * R + j], D && q + 1 == W::G);
        }
#pragma unroll
        for (int j = 0; j < R; ++j) aq[j] = next[j];
      }
      sincos_reduced_each(ph, [&](int i, float s, float co) {
        const int c = i / R, j = i % R;
        const float2 v = nf[c0 + c];
        acc_re[j] = fmaf(co, v.x, fmaf(s, v.y, acc_re[j]));
        acc_im[j] = fmaf(co, v.y, fmaf(-s, v.x, acc_im[j]));
      });
    }
    if (ring == 1 && k + 1 < n_bufs) {
      __syncthreads();  // the one buffer is read
      stage_items(basis, nfr, nfi, P, end, Dt, dq, p0 + (k + 1) * items, items, buf0);
    }
  }
  __syncthreads();  // red overwrites the ring
  float2* red = reinterpret_cast<float2*>(smem4);
#pragma unroll
  for (int j = 0; j < R; ++j)
    red[warp * kColumn + lane + 32 * j] = make_float2(acc_re[j], acc_im[j]);
  __syncthreads();
  for (int i = threadIdx.x; i < kColumn * groups; i += kThreads) {
    const int n = blockIdx.y * kColumn * groups + i;
    if (n >= N) break;
    const int c = i / kColumn, r = i - c * kColumn;
    float2 v = make_float2(0.f, 0.f);
    for (int h = 0; h < parts; ++h) {
      v.x += red[(h * groups + c) * kColumn + r].x;
      v.y += red[(h * groups + c) * kColumn + r].y;
    }
    partials[(size_t)blockIdx.x * N + n] = v.x;
    partials[((size_t)gridDim.x + blockIdx.x) * N + n] = v.y;
  }
}

#if !SLM_UNIT_MIXED

// #17 fused_iter_cached: per block of kBlockPixels pixels, the (N,)
// partial sums of e^{-i Phi} times amp nf/|nf| of the nearfield nf
// expanded from the farfield, cos/sin read from the (n_tiles, N8, T)
// cache; kKeep keeps the sub-chunk's cos/sin in shared memory between the
// halves.
template <bool kKeep>
__global__ void __launch_bounds__(kThreads)
roundtrip_kernel(const float* __restrict__ ffr, const float* __restrict__ ffi,
                 const float* __restrict__ kc, const float* __restrict__ ks, int N8,
                 int T, const float* __restrict__ amp, int P, int N,
                 float* __restrict__ partials) {
  // cs[N][kSub] (kKeep), u[kSub] as (re, im) pairs, then the floats
  // part[2][kWarps][kSub], acc_re[N], acc_im[N], fr[N], fi[N].
  extern __shared__ float4 smem4[];
  float2* cs = reinterpret_cast<float2*>(smem4);
  float2* u = cs + (kKeep ? (size_t)N * kSub : 0);
  float* part = reinterpret_cast<float*>(u + kSub);
  float* acc_re = part + 2 * kWarps * kSub;
  float* acc_im = acc_re + N;
  float* fr = acc_im + N;
  float* fi = fr + N;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    acc_re[i] = acc_im[i] = 0.f;
    fr[i] = ffr[i];
    fi[i] = ffi[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p0 = blockIdx.x * kBlockPixels;
  for (int base = p0; base < min(P, p0 + kBlockPixels); base += kSub) {
    const int p = base + lane;
    // The cache covers whole tiles, so its pad pixels (p >= P) are readable.
    const size_t cache_off = ((size_t)(p / T) * N8) * T + (p % T);

    // First half: the warp's spots at this lane's pixel (unrolled so that
    // 16 cache loads per warp are in flight at once).
    float nre = 0.f, nim = 0.f;
#pragma unroll 8
    for (int n = warp; n < N; n += kWarps) {
      const float c = kc[cache_off + (size_t)n * T], s = ks[cache_off + (size_t)n * T];
      if (kKeep) cs[n * kSub + (lane ^ (n & (kSub - 1)))] = make_float2(c, s);
      nre = fmaf(fr[n], c, fmaf(-fi[n], s, nre));
      nim = fmaf(fr[n], s, fmaf(fi[n], c, nim));
    }
    part[warp * kSub + lane] = nre;
    part[(kWarps + warp) * kSub + lane] = nim;
    __syncthreads();
    if (warp == 0) {
      float re = 0.f, im = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        re += part[w * kSub + lane];
        im += part[(kWarps + w) * kSub + lane];
      }
      u[lane] = amp_replace(re, im, amp, p, p < P);
    }
    __syncthreads();

    // Second half: the replaced field of the sub-chunk back onto the spots.
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
        const float c = kc[cache_off + (size_t)n * T], s = ks[cache_off + (size_t)n * T];
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

#endif  // !SLM_UNIT_MIXED

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

inline int n_blocks_of(int P) { return (P + kBlockPixels - 1) / kBlockPixels; }

#if !SLM_UNIT_MIXED
cudaError_t finish(const float* partials, int n_blocks, int N, float scale,
                   float* out_re, float* out_im, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  spot_reduce_kernel<<<N, kThreads, 0, stream>>>(partials, n_blocks, N, scale,
                                                 out_re, out_im);
  return cudaGetLastError();
}
#endif  // !SLM_UNIT_MIXED

// f.template wide<D>() for D up to kWideMax, else f.template wide<0>().
template <int DT, typename F>
cudaError_t wide_terms(int D, const F& f) {
  if constexpr (DT > kWideMax) return f.template wide<0>();
  else return D == DT ? f.template wide<DT>() : wide_terms<DT + 1>(D, f);
}

// Calls f.template run<DT>() for D's term count (terms_of), or past
// kWideTerms terms f.template wide<D>() (wide_terms).
template <typename F>
cudaError_t with_terms(int D, const F& f) {
  if (D > kWideTerms) return wide_terms<kWideTerms + 1>(D, f);
  switch (terms_of(D)) {
    case 1: return f.template run<1>();
    case 2: return f.template run<2>();
    case 3: return f.template run<3>();
    case 4: return f.template run<4>();
    case 8: return f.template run<8>();
    case 12: return f.template run<12>();
    case 16: return f.template run<16>();
  }
  return cudaErrorInvalidValue;
}

// The staging of the wide kernels at D terms: items a buffer, buffers (the
// ring), and the block's shared bytes (at least `least`, n2f's sums after
// the loop). At D <= kWideMax kWideItems in two buffers; past it, as many
// items (at most kWideItems; a multiple of 16, or of 8 below 16) as two
// buffers hold within kWideSmem, else as many as one buffer holds within
// kSmemLimit; none (items 0) where eight do not fit.
struct WideRing {
  int items, ring;
  size_t bytes;
};
inline int wide_items(size_t bytes, size_t per_item) {
  const size_t n = bytes / per_item;
  return (int)(n >= kWideItems ? kWideItems : n >= 16 ? n / 16 * 16 : n / 8 * 8);
}
inline WideRing wide_ring(int D, size_t least) {
  const size_t per_item = (size_t)((D + 3) / 4) * sizeof(float4) + sizeof(float2);
  int items = kWideItems, ring = 2;
  if (D > kWideMax) {
    items = wide_items(kWideSmem / 2, per_item);
    if (items < 8) {
      ring = 1;
      items = wide_items(kSmemLimit, per_item);
    }
    if (items < 8) return {0, 0, 0};
  }
  const size_t bytes = ring * items * per_item;
  return {items, ring, bytes > least ? bytes : least};
}

// Spot columns of 32 `column`-spot lanes a block of n2f_wide_kernel takes:
// the least power of two that covers N, at most kWarps.
inline int wide_groups(int N, int column) {
  int groups = 1;
  while (groups < kWarps && groups * column < N) groups *= 2;
  return groups;
}

struct F2nLaunch {
  const float *ffr, *ffi, *coeffs, *basis, *amp;
  int P, N, D;
  float scale;
  int replace;
  float *nfr, *nfi;
  cudaStream_t stream;

  template <int DT>
  cudaError_t run() const {
    const size_t smem = (size_t)kSpotChunk * (Terms<DT>::DQ * sizeof(float4) + sizeof(float2));
    cudaError_t err = set_smem(f2n_kernel<DT>, smem);
    if (err != cudaSuccess) return err;
    const int per_block = kThreads * kThreadPixels;
    f2n_kernel<DT><<<(P + per_block - 1) / per_block, kThreads, smem, stream>>>(
        ffr, ffi, coeffs, basis, amp, P, N, D, scale, replace, nfr, nfi);
    return cudaGetLastError();
  }

  template <int DT>
  cudaError_t wide() const;  // below

  template <int DT, int K>
  cudaError_t launch(const WideRing& w) const {
    cudaError_t err = set_smem(f2n_wide_kernel<DT, K>, w.bytes);
    if (err != cudaSuccess) return err;
    const int per_block = kThreads * Wide<DT>::R;
    f2n_wide_kernel<DT, K><<<(P + per_block - 1) / per_block, kThreads, w.bytes, stream>>>(
        ffr, ffi, coeffs, basis, amp, P, N, D, w.items, w.ring, scale, replace, nfr, nfi);
    return cudaGetLastError();
  }
};

struct N2fLaunch {
  const float *nfr, *nfi, *coeffs, *basis;
  int P, N, D;
  float* partials;
  cudaStream_t stream;

  template <int DT>
  cudaError_t run() const {
    constexpr int DQ = Terms<DT>::DQ;
    const size_t smem = (size_t)kBlockPixels * (DQ * sizeof(float4) + sizeof(float2)) +
                        (DQ > 1 ? (size_t)DQ * kWarpSpots * sizeof(float4) : 0);
    cudaError_t err = set_smem(n2f_kernel<DT>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(n_blocks_of(P), (N + kWarpSpots - 1) / kWarpSpots);
    n2f_kernel<DT><<<grid, kThreads, smem, stream>>>(nfr, nfi, coeffs, basis, P, N, D, partials);
    return cudaGetLastError();
  }

  template <int DT>
  cudaError_t wide() const;  // below

  template <int DT, int K>
  cudaError_t launch(const WideRing& w) const {
    constexpr int kColumn = 32 * Wide<DT>::R;
    cudaError_t err = set_smem(n2f_wide_kernel<DT, K>, w.bytes);
    if (err != cudaSuccess) return err;
    const int groups = wide_groups(N, kColumn);
    const dim3 grid(n_blocks_of(P), (N + kColumn * groups - 1) / (kColumn * groups));
    n2f_wide_kernel<DT, K><<<grid, kThreads, w.bytes, stream>>>(nfr, nfi, coeffs, basis, P, N, D,
                                                                w.items, w.ring, groups, partials);
    return cudaGetLastError();
  }
};

// The wide launches at DT terms (0: the group count at run time, K = 32
// where a buffer holds 16 items). Defined out of the classes (not inline),
// so that each object instantiates those of its own half alone.
template <int DT>
cudaError_t F2nLaunch::wide() const {
  const WideRing w = wide_ring(DT ? DT : D, 0);
  if (!w.items) return cudaErrorInvalidValue;
  if constexpr (DT == 0)
    if (w.items % 16 == 0) return launch<0, 32>(w);
  return launch<DT, 16>(w);
}

template <int DT>
cudaError_t N2fLaunch::wide() const {
  constexpr int kColumn = 32 * Wide<DT>::R;
  const WideRing w = wide_ring(DT ? DT : D, kWarps * kColumn * sizeof(float2));
  if (!w.items) return cudaErrorInvalidValue;
  if constexpr (DT == 0)
    if (w.items % 16 == 0) return launch<0, 32>(w);
  return launch<DT, 16>(w);
}

// The term counts past kWideSplit, whose wide launches the second object
// instantiates and the first only declares.
#define SLM_CMP_WIDE_SECOND(X) \
  X(31) X(32) X(33) X(34) X(35) X(36) X(37) X(38) X(39) X(40) X(41) X(42) X(43) X(44)
static_assert(kWideSplit == 30 && kWideMax == 44, "SLM_CMP_WIDE_SECOND lists the second half");
#if SLM_UNIT_MIXED
#define SLM_CMP_WIDE(DT)                                     \
  template cudaError_t F2nLaunch::wide<DT>() const; \
  template cudaError_t N2fLaunch::wide<DT>() const;
#else
#define SLM_CMP_WIDE(DT)                                            \
  extern template cudaError_t F2nLaunch::wide<DT>() const; \
  extern template cudaError_t N2fLaunch::wide<DT>() const;
#endif
SLM_CMP_WIDE_SECOND(SLM_CMP_WIDE)
#undef SLM_CMP_WIDE

#if !SLM_UNIT_MIXED
// fused_iter_cached: roundtrip_kernel (keeping the cos/sin when it fits)
// and the fixed-order spot_reduce that finishes it.
cudaError_t launch_cached(const float* ffr, const float* ffi, const float* kc, const float* ks,
                          int N8, int T, const float* amp, int P, int N, float* partials,
                          float* out_re, float* out_im, cudaStream_t stream) {
  const size_t fixed =
      (size_t)kSub * sizeof(float2) + (size_t)(2 * kWarps * kSub + 4 * N) * sizeof(float);
  const size_t kept = fixed + (size_t)N * kSub * sizeof(float2);
  const bool keep = kept <= kKeepLimit;
  const size_t smem = keep ? kept : fixed;
  auto kernel = keep ? roundtrip_kernel<true> : roundtrip_kernel<false>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_blocks = n_blocks_of(P);
  kernel<<<n_blocks, kThreads, smem, stream>>>(ffr, ffi, kc, ks, N8, T, amp, P, N, partials);
  return finish(partials, n_blocks, N, 1.f, out_re, out_im, stream);
}

// fused_iter up to kWarpSpots spots and 4 kFusedGroups terms:
// fused_spots_kernel and spot_reduce. Beyond, the wrapper runs the round
// trip as f2n with the amplitude replacement, then n2f unnormalized.
cudaError_t launch_fused(const float* ffr, const float* ffi, const float* coeffs,
                         const float* basis, const float* amp, int P, int N, int D,
                         float* partials, float* out_re, float* out_im, cudaStream_t stream) {
  if (N > kWarpSpots || (D + 3) / 4 > kFusedGroups) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(kBlockPixels + kWarpSpots) * ((D + 3) / 4) * sizeof(float4);
  cudaError_t err = set_smem(fused_spots_kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_blocks = n_blocks_of(P);
  fused_spots_kernel<<<n_blocks, kThreads, smem, stream>>>(ffr, ffi, coeffs, basis, amp, P, N,
                                                           D, partials);
  return finish(partials, n_blocks, N, 1.f, out_re, out_im, stream);
}

#endif  // !SLM_UNIT_MIXED

}  // namespace slm_cmp

#if !SLM_UNIT_MIXED

using namespace slm_cmp;

extern "C" {

// f2n: the nearfield times `scale`, or (replace != 0) its amplitude
// replacement amp nf/|nf| (amp null: unit amplitude).
int slm_cmp_f2n(const float* ffr, const float* ffi, const float* coeffs,
                const float* basis, const float* amp, int P, int N, int D, float scale,
                int replace, float* nfr, float* nfi, cudaStream_t stream) {
  return (int)with_terms(D, F2nLaunch{ffr, ffi, coeffs, basis, amp, P, N, D, scale, replace,
                                      nfr, nfi, stream});
}

// n2f: the (N,) farfield sum times `scale`, divided by its norm where
// `normalize` != 0.
int slm_cmp_n2f(const float* nfr, const float* nfi, const float* coeffs,
                const float* basis, int P, int N, int D, float scale, int normalize,
                float* partials, float* out_re, float* out_im, cudaStream_t stream) {
  cudaError_t err =
      with_terms(D, N2fLaunch{nfr, nfi, coeffs, basis, P, N, D, partials, stream});
  if (err != cudaSuccess) return (int)err;
  err = finish(partials, n_blocks_of(P), N, scale, out_re, out_im, stream);
  if (err != cudaSuccess || !normalize) return (int)err;
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
  return (int)launch_cached(ffr, ffi, kc, ks, N8, T, amp, P, N, partials, out_re, out_im,
                            stream);
}

int slm_cmp_block_pixels() { return kBlockPixels; }

int slm_cmp_fused_spots() { return kWarpSpots; }

int slm_cmp_fused_terms() { return 4 * kFusedGroups; }

int slm_cmp_wide_terms() { return kWideTerms; }

// The most Zernike terms f2n and n2f take: the wide kernels' one buffer of
// eight items (f2n: spots; n2f: pixels) within a block's shared memory.
int slm_cmp_max_terms() {
  return 4 * (int)((kSmemLimit / kPixelSpots - kWarps * sizeof(float2)) / sizeof(float4));
}

}  // extern "C"

#endif  // !SLM_UNIT_MIXED
