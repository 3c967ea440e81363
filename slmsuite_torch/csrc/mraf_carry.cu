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
// scaled complex farfield (not |F| and arg F) crosses between the two
// kernels, so the mix runs without a transcendental.
//
// Both are column kernels on the register-resident line_fft
// (fft_shared.cuh), with cols_fft's tile (natural_fft.cu): one cluster of
// G blocks per tile of tc = cols_tile adjacent columns, lanes across the
// tile so that each row segment loaded or stored is a whole 32-byte
// sector, and G = 2 at 4096 points (cols_cluster). Thread (s, c) holds the
// rows s + q H / E of its column in registers; every per-point plane is
// read and written at the same offsets (col_offset), and the epilogue of
// the forward kernel and the prologue of the mix run on those registers.
// The per-point offsets are 32-bit (col_offset<LINE, unsigned>): with
// 64-bit ones the mix spilled 528-560 bytes at 2048 and 4096 points and
// took 0.068 ms at 2048^2, with 32-bit ones it spills nothing at any
// length and takes 0.058 (Kim with zero weights 0.109 against 0.129);
// the forward kernel gains 3-5% at 2048^2 and 4096^2 and loses 6% at
// 1024^2. Making kim and zero template parameters instead cut the mix's
// spill less and gained less (0.117 ms with Kim and zero weights). At
// 2048^2, device time: cols_mraf_fwd 0.088 ms, 46% of its bound;
// cols_mraf_mix_inv 0.058, 52% (with Kim and zero weights 0.109, 65%).
// The first version staged the tile in shared memory for a radix-2
// transform there, with 4 columns a tile at 2048 points and 2 at 4096: 0.312
// and 0.238 ms. PERF.md, section 6, has the measurements.
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
// pallas_call at :1796). The forward column line_fft of the tile, then per
// register point (s + q H / E, col): (fr, fi) = post * F, uw = the rule's
// update of w at f = |post * F| (updated_weight), the three planes stored,
// sum uw^2 and, while stats are on, the stats (carry_shared.cuh) summed by
// each thread over its points in q order; then block_reduce and
// stats_reduce fold them in a fixed order, so the sums repeat bit for bit.
// One transform, so nothing writes the exchange buffer after it and no
// second barrier is needed. 64 registers from 128 points up (53 at 64 and
// 512), with 192-256 bytes of spill loads; the mix kernel below, 64 or
// fewer and no spill.
template <int LINE, int G>
__device__ __forceinline__ void cols_mraf_fwd_tile(
    const float* __restrict__ gr, const float* __restrict__ gi, const float* __restrict__ w,
    const float* __restrict__ t, const float* __restrict__ mask, float* __restrict__ fr_out,
    float* __restrict__ fi_out, float* __restrict__ uw_out, const float* __restrict__ scal,
    double* __restrict__ partials, const float2* __restrict__ tw_fwd, int rule, int stats_on,
    int W, int tc, int log2tc, int m) {
  constexpr int E = line_points(LINE);
  extern __shared__ float2 sbuf[];
  const Line<LINE> ln{m};
  float2 v[E];
  const ColPlace p = col_tile_start<LINE, G>(v, gr, gi, W, tc, log2tc, ln);
  line_fft<LINE, false, G>(v, sbuf + p.c, tc, p.s, tw_fwd, ln);

  const StepScalars sc = load_scalars(scal);
  float facc[2] = {0.f, 0.f};    // overlap, sum uw^2
  double dacc[2] = {0.0, 0.0};   // err_sum, err_sq
  float macc[4] = {kNegFill, kNegFill, kNegFill, kNegFill};
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const unsigned g = col_offset<LINE, unsigned>(ln, q, W, p.col, p.s);
    const float fr = v[q].x * sc.post;
    const float fi = v[q].y * sc.post;
    const float f = sqrtf(fr * fr + fi * fi);
    const float tv = t[g];
    const float uw = updated_weight(f, tv, w[g], sc, rule);
    fr_out[g] = fr;
    fi_out[g] = fi;
    uw_out[g] = uw;
    facc[1] += uw * uw;
    if (stats_on)
      stats_accumulate(f, tv, mask[g], sc.inv_tsum, sc.inv_fsum, facc, dacc, macc);
  }
  write_partials<line_mixed(LINE)>(facc, dacc, macc, partials);
}

template <int LINE>
__global__ void __launch_bounds__(cols_max_threads(LINE))
cols_mraf_fwd_kernel(const float* __restrict__ gr, const float* __restrict__ gi,
                     const float* __restrict__ w, const float* __restrict__ t,
                     const float* __restrict__ mask, float* __restrict__ fr_out,
                     float* __restrict__ fi_out, float* __restrict__ uw_out,
                     const float* __restrict__ scal, double* __restrict__ partials,
                     const float2* __restrict__ tw_fwd, int rule, int stats_on, int W, int tc,
                     int log2tc, int m) {
  cols_mraf_fwd_tile<LINE, 1>(gr, gi, w, t, mask, fr_out, fi_out, uw_out, scal, partials,
                              tw_fwd, rule, stats_on, W, tc, log2tc, m);
}

template <int LINE, int G>
__global__ void __cluster_dims__(G, 1, 1) __launch_bounds__(cols_max_threads(LINE))
cols_mraf_fwd_cluster_kernel(const float* __restrict__ gr, const float* __restrict__ gi,
                             const float* __restrict__ w, const float* __restrict__ t,
                             const float* __restrict__ mask, float* __restrict__ fr_out,
                             float* __restrict__ fi_out, float* __restrict__ uw_out,
                             const float* __restrict__ scal, double* __restrict__ partials,
                             const float2* __restrict__ tw_fwd, int rule, int stats_on, int W,
                             int tc, int log2tc, int m) {
  cols_mraf_fwd_tile<LINE, G>(gr, gi, w, t, mask, fr_out, fi_out, uw_out, scal, partials,
                              tw_fwd, rule, stats_on, W, tc, log2tc, m);
}

// #10, K2 <- pallas_fft._cols_mraf_mix_inv_kernel (pallas_call at :1837),
// with the norm sync (:1810) folded in: every thread reads sums[3]. The
// start works as col_tile_start_wexp does: the farfield pair (fr, fi) is
// loaded into the registers first, then the mix is formed there point by
// point, reading each point's other planes (uw where the region is the
// signal, mcode, Kim's stored phasor while use_theta is off, the zero
// weights) at the same offsets: e = F/|F| (zero -> (1, 0)), or Kim's
// stored phasor while use_theta is off (then stored back); uw/||uw|| * e
// in the signal region, k * F in the noise region, 0 in the zero region,
// or with `zero` the updated zero weight zw - zf * |F| * F (written back
// too). Loading every plane of all E points first, as the wexp start does
// for two, would not fit 64 registers. With G = 2 the cluster's barrier
// ends the start: the inverse's first exchange writes the other block's
// buffer. Then the inverse column line_fft and the store.
template <int LINE, int G>
__device__ __forceinline__ void cols_mraf_mix_inv_tile(
    const float* __restrict__ fr_in, const float* __restrict__ fi_in,
    const float* __restrict__ uw, const float* __restrict__ mcode,
    const float* __restrict__ pffr, const float* __restrict__ pffi,
    const float* __restrict__ zwr, const float* __restrict__ zwi, float* __restrict__ hr,
    float* __restrict__ hi, float* __restrict__ pffr_out, float* __restrict__ pffi_out,
    float* __restrict__ zwr_out, float* __restrict__ zwi_out, const float* __restrict__ scal,
    const double* __restrict__ sums, const float2* __restrict__ tw_inv, int kim, int zero,
    int W, int tc, int log2tc, int m) {
  constexpr int E = line_points(LINE);
  extern __shared__ float2 sbuf[];
  const Line<LINE> ln{m};
  float2 v[E];
  const ColPlace p = col_place<G>(tc, log2tc);
  load_col_regs(v, fr_in, fi_in, W, p.col, p.s, ln);
  const StepScalars sc = load_scalars(scal);
  const float inv_norm = 1.f / sqrtf((float)sums[3]);
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const unsigned g = col_offset<LINE, unsigned>(ln, q, W, p.col, p.s);
    const float2 F = v[q];
    const float f2 = F.x * F.x + F.y * F.y;
    float er = 1.f, ei = 0.f;
    if (f2 > 0.f) {
      const float ib = rsqrtf(f2);
      er = F.x * ib;
      ei = F.y * ib;
    }
    if (kim) {
      if (!sc.use_theta) {
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
      re = sc.mraf_k * F.x;
      im = sc.mraf_k * F.y;
    }
    if (zero) {
      float zr = zwr[g], zi = zwi[g];
      if (mc == 0.f) {
        const float step = sc.zero_f * sqrtf(f2);
        zr -= step * F.x;
        zi -= step * F.y;
        re = zr;
        im = zi;
      }
      zwr_out[g] = zr;
      zwi_out[g] = zi;
    }
    v[q] = make_float2(re, im);
  }
  if (G > 1) cooperative_groups::this_cluster().sync();
  line_fft<LINE, true, G>(v, sbuf + p.c, tc, p.s, tw_inv, ln);
  store_col_regs(v, hr, hi, W, p.col, p.s, 1.f, ln);
}

template <int LINE>
__global__ void __launch_bounds__(cols_max_threads(LINE))
cols_mraf_mix_inv_kernel(
    const float* __restrict__ fr_in, const float* __restrict__ fi_in,
    const float* __restrict__ uw, const float* __restrict__ mcode,
    const float* __restrict__ pffr, const float* __restrict__ pffi,
    const float* __restrict__ zwr, const float* __restrict__ zwi, float* __restrict__ hr,
    float* __restrict__ hi, float* __restrict__ pffr_out, float* __restrict__ pffi_out,
    float* __restrict__ zwr_out, float* __restrict__ zwi_out, const float* __restrict__ scal,
    const double* __restrict__ sums, const float2* __restrict__ tw_inv, int kim, int zero,
    int W, int tc, int log2tc, int m) {
  cols_mraf_mix_inv_tile<LINE, 1>(fr_in, fi_in, uw, mcode, pffr, pffi, zwr, zwi, hr, hi,
                                  pffr_out, pffi_out, zwr_out, zwi_out, scal, sums, tw_inv,
                                  kim, zero, W, tc, log2tc, m);
}

template <int LINE, int G>
__global__ void __cluster_dims__(G, 1, 1) __launch_bounds__(cols_max_threads(LINE))
cols_mraf_mix_inv_cluster_kernel(
    const float* __restrict__ fr_in, const float* __restrict__ fi_in,
    const float* __restrict__ uw, const float* __restrict__ mcode,
    const float* __restrict__ pffr, const float* __restrict__ pffi,
    const float* __restrict__ zwr, const float* __restrict__ zwi, float* __restrict__ hr,
    float* __restrict__ hi, float* __restrict__ pffr_out, float* __restrict__ pffi_out,
    float* __restrict__ zwr_out, float* __restrict__ zwi_out, const float* __restrict__ scal,
    const double* __restrict__ sums, const float2* __restrict__ tw_inv, int kim, int zero,
    int W, int tc, int log2tc, int m) {
  cols_mraf_mix_inv_tile<LINE, G>(fr_in, fi_in, uw, mcode, pffr, pffi, zwr, zwi, hr, hi,
                                  pffr_out, pffi_out, zwr_out, zwi_out, scal, sums, tw_inv,
                                  kim, zero, W, tc, log2tc, m);
}

// Launches of one instantiation of each (launch_cols; the cluster
// instantiation where cols_cluster says more than one block). cols_mraf_fwd
// then launches stats_reduce on its n_blocks rows of partials, which must
// be the grid's (cols_blocks).
template <int LINE>
int launch_cols_mraf_fwd(const float* gr, const float* gi, const float* w, const float* t,
                         const float* mask, float* fr, float* fi, float* uw, const float* scal,
                         double* partials, double* sums, float* maxs, int W, int m,
                         int n_blocks, const float2* tw_fwd, int rule, int stats_on,
                         cudaStream_t stream) {
  constexpr int G = cols_cluster(LINE);
  if (n_blocks <= 0 || n_blocks != cols_blocks(kColsMrafFwd, m << line_log2(LINE), W))
    return (int)cudaErrorInvalidValue;
  auto kernel = [] {
    if constexpr (G > 1) return cols_mraf_fwd_cluster_kernel<LINE, G>;
    else return cols_mraf_fwd_kernel<LINE>;
  }();
  const int err = launch_cols<kColsMrafFwd, LINE>(kernel, W, m, stream, gr, gi, w, t, mask, fr,
                                                   fi, uw, scal, partials, tw_fwd, rule,
                                                   stats_on);
  if (err != (int)cudaSuccess) return err;
  return (int)launch_stats_reduce(partials, n_blocks, sums, maxs, stream);
}

template <int LINE>
int launch_cols_mraf_mix_inv(const float* fr, const float* fi, const float* uw,
                             const float* mcode, const float* pffr, const float* pffi,
                             const float* zwr, const float* zwi, float* hr, float* hi,
                             float* pffr_out, float* pffi_out, float* zwr_out, float* zwi_out,
                             const float* scal, const double* sums, int W, int m,
                             const float2* tw_inv, int kim, int zero, cudaStream_t stream) {
  constexpr int G = cols_cluster(LINE);
  auto kernel = [] {
    if constexpr (G > 1) return cols_mraf_mix_inv_cluster_kernel<LINE, G>;
    else return cols_mraf_mix_inv_kernel<LINE>;
  }();
  return launch_cols<kColsMrafMixInv, LINE>(kernel, W, m, stream, fr, fi, uw, mcode, pffr, pffi,
                                            zwr, zwi, hr, hi, pffr_out, pffi_out, zwr_out,
                                            zwi_out, scal, sums, tw_inv, kim, zero);
}

}  // namespace slm

using namespace slm;

extern "C" {

// n_blocks: the rows of `partials`, slm_cols_blocks(kColsMrafFwd, H, W).
int SLM_ENTRY(slm_cols_mraf_fwd)(const float* gr, const float* gi, const float* w,
                      const float* t, const float* mask, float* fr, float* fi,
                      float* uw, const float* scal, double* partials,
                      double* sums, float* maxs, int H, int W, int n_blocks,
                      const float2* tw_fwd, int rule, int stats_on,
                      cudaStream_t stream) {
  int m = 0;
  switch (line_code(H, &m)) {
    SLM_LEN_CASES(launch_cols_mraf_fwd, gr, gi, w, t, mask, fr, fi, uw, scal, partials, sums,
                  maxs, W, m, n_blocks, tw_fwd, rule, stats_on, stream)
  }
  return (int)cudaErrorInvalidValue;
}

int SLM_ENTRY(slm_cols_mraf_mix_inv)(const float* fr, const float* fi, const float* uw,
                          const float* mcode, const float* pffr,
                          const float* pffi, const float* zwr,
                          const float* zwi, float* hr, float* hi,
                          float* pffr_out, float* pffi_out, float* zwr_out,
                          float* zwi_out, const float* scal,
                          const double* sums, int H, int W,
                          const float2* tw_inv, int kim, int zero,
                          cudaStream_t stream) {
  int m = 0;
  switch (line_code(H, &m)) {
    SLM_LEN_CASES(launch_cols_mraf_mix_inv, fr, fi, uw, mcode, pffr, pffi, zwr, zwi, hr, hi,
                  pffr_out, pffi_out, zwr_out, zwi_out, scal, sums, W, m, tw_inv, kim, zero,
                  stream)
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
