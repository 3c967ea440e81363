// Carry-mode WGS loop kernels for Hopper (sm_90a).
//
// The loop carries the rows-transformed field pair (gr, gi) = FFT_rows of
// amp * e^{i psi}, in natural order. One iteration is two kernels, as on
// the TPU: the cols round trip (forward column FFT, WGS epilogue, inverse
// column FFT) and the rows round trip (inverse row FFT, amplitude
// replacement, forward row FFT). Entry and exit convert psi to and from
// the carry. Semantics: the plain PyTorch versions in
// slmsuite_torch/ops/fft.py (`_wgs_carry_entry`, `_wgs_carry_step`,
// `_wgs_carry_exit`). cols_wgs_fwd is the column pass of the psi -> psi
// forward half `wgs_fused_forward` (plain version: `_cols_wgs_fwd`).
//
// What bounds them on the H100: memory traffic. At 2048^2 one f32 plane
// is 16 MiB; a Kim step with stats reads gr, gi, w, t, mask, pffr, pffi
// and writes hr, hi, w', pffr', pffi' in the cols kernel, then reads
// hr, hi and writes gr', gi' in the rows kernel: 16 plane crossings, about
// 270 MB, or ~80 us at 3.35 TB/s. The FFT arithmetic (5 N log2 N flops
// per axis pass, four passes) is ~1 GFLOP per step, well under the f32
// peak. Each kernel touches device memory once per operand: no
// intermediate (the farfield, the constrained field, the nearfield)
// leaves the chip. The two step kernels, cols_wgs_roundtrip and
// rows_normfwd, hold their lines in registers and transform them twice
// with the register-resident line_fft (fft_shared.cuh), the epilogue
// between the transforms on the same registers; the column kernel has
// lanes across a tile of 8 adjacent columns, so each row segment it
// loads or stores is a whole 32-byte sector (cols_tile). The entry and
// exit kernels are row kernels on line_fft too, their prologue and
// epilogue on the registers, and so is cols_wgs_fwd, the column pass of
// the forward half: one transform and the epilogue.
//
// Launchers take raw pointers, sizes, flags and a stream, and return
// cudaGetLastError(). They allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "carry_shared.cuh"

namespace slm {

// #1 <- pallas_fft.wgs_carry_entry_pallas (_rows_phase_kernel,
// _rows_phase_amp_kernel): z = e^{i psi}, or amp * e^{i psi} with an
// amplitude plane (a scalar amplitude folds into the column kernel's post
// scale, not into this kernel), then the forward row FFT, unnormalized.
//
// Bound on the H100 by bytes: psi read, gr and gi written (an amplitude
// plane: read too), 15 (20) us at 2048^2. The rows are rows_fft's
// (natural_fft.cu, row_place): thread s loads psi, and the amplitude at the
// same indices, at its points s + q W / E straight into registers (4-byte
// loads, a warp's 128 contiguous bytes an instruction), forms the phasor
// there and hands it to the forward line_fft; the store goes from the same
// registers. sincosf keeps libdevice's full range reduction (Payne-Hanek
// beyond |psi| = 105615): psi is unbounded on warm starts and on a phase a
// user gives, so neither __sincosf nor a Cody-Waite-only reduction will do.
// Inlined, it costs nothing where it is not taken: 64 registers from 1024
// points up, no spill (a 32-byte stack frame at 64 and 512), four blocks
// an SM, 72% of the bound at 2048^2 (0.021 ms; the first version, one row
// a block staged in shared memory for a radix-2 FFT, 0.101). Moving the far
// branch into a call of its own cost 26%; capping the registers for three
// blocks an SM, 6%. PERF.md, section 6, has the measurements.
//
// A stack of B phase planes runs in one launch, as B H rows against one
// shared amplitude plane (the multiplane engine's planes share their
// nearfield amplitude): a row's amplitude is that of its row in the plane,
// at the row's offset masked by amp_mask = H W - 1 where H W is a power of
// two (all ones for one plane), else (WRAP) modulo amp_mask + 1 = H W; a
// thread's points lie in one row.
template <int LINE, bool WRAP>
__global__ void __launch_bounds__(rows_max_threads(LINE))
carry_entry_kernel(const float* __restrict__ psi, const float* __restrict__ amp,
                   float* __restrict__ gr, float* __restrict__ gi,
                   const float2* __restrict__ tw, size_t amp_mask, int m) {
  constexpr int E = line_points(LINE);
  extern __shared__ float2 sbuf[];
  const Line<LINE> ln{m};
  const int T = ln.threads();
  const RowPlace p = row_place(sbuf, ln);
  float2 v[E];
  const size_t a = WRAP ? p.base % (amp_mask + 1) : p.base & amp_mask;
  // Every load first (psi in .x, the amplitude in .y), then the phasors.
#pragma unroll
  for (int q = 0; q < E; ++q)
    v[q] = make_float2(psi[p.base + q * T], amp ? amp[a + q * T] : 1.f);
#pragma unroll
  for (int q = 0; q < E; ++q) {
    float s, c;
    sincosf(v[q].x, &s, &c);
    v[q] = make_float2(v[q].y * c, v[q].y * s);
  }
  line_fft<LINE, false>(v, p.buf, 1, p.s, tw, ln);
  store_row_regs(v, gr, gi, p.base, 1.f, ln);
}

// #2 <- pallas_fft.wgs_carry_step_pallas kernel B
// (_cols_wgs_roundtrip_kernel(phasor=True) with _wgs_epilogue,
// _weight_correction, _acc_tiles). One cluster of G blocks per tile of
// tc = cols_tile adjacent columns, cols_fft's tile (natural_fft.cu): forward
// column line_fft, then per register point at its global index
// (s + q H / E, col) f = post * |F|, the rule's correction, w' = w * c
// (nan -> 1e-4) scaled by 1/prev-norm once the update is on, the unit
// phasor F/|F| (zero -> (1, 0)) with the Kim select against the stored
// phasor, the constrained field w' * phasor back into the same registers
// and the stats (carry_shared.cuh; each block writes its own row of
// partials), then the inverse column line_fft and the store. Nothing
// crosses device memory between the two transforms.
//
// Bound on the H100 by bytes: with Kim it reads gr, gi, w, t, mask and,
// while use_theta is off, the stored phasor pair, and writes five planes:
// 60 us at 2048^2 (50 with use_theta on). The blocks are cols_fft's: one of
// 1024 threads up to 2048 points, which beats a cluster of two blocks of
// 512 there, and two of a cluster at 4096 (cols_cluster). The barrier
// between the transforms is the cluster's when G = 2: the inverse's first
// exchange writes the other block's buffer, which that block may still be
// reading. Each thread sums the stats of its E points in q order, then
// block_reduce and stats_reduce fold them in a fixed order, so the result
// repeats bit for bit. The partials are written before the inverse
// transform, so that the accumulators (two of them float64) are not live
// through it: at 2048 points 1024 threads leave 64 registers a thread.
// The alternatives measured against this design are in PERF.md, section 6.
template <int LINE, int G>
__device__ __forceinline__ void cols_wgs_roundtrip_tile(
    const float* __restrict__ gr, const float* __restrict__ gi,
    const float* __restrict__ w, const float* __restrict__ t,
    const float* __restrict__ mask, const float* __restrict__ pffr,
    const float* __restrict__ pffi, float* __restrict__ hr,
    float* __restrict__ hi, float* __restrict__ wout,
    float* __restrict__ pffr_out, float* __restrict__ pffi_out,
    const float* __restrict__ scal, double* __restrict__ partials, int W, int tc,
    int log2tc, const float2* __restrict__ tw_fwd, const float2* __restrict__ tw_inv,
    int rule, int kim, int stats_on, int m) {
  constexpr int E = line_points(LINE);
  extern __shared__ float2 sbuf[];
  const Line<LINE> ln{m};
  const int T = ln.threads();
  float2 v[E];
  const ColPlace p = col_tile_start<LINE, G>(v, gr, gi, W, tc, log2tc, ln);
  const int s = p.s;
  const size_t col = p.col;
  line_fft<LINE, false, G>(v, sbuf + p.c, tc, s, tw_fwd, ln);

  const StepScalars sc = load_scalars(scal);
  float facc[2] = {0.f, 0.f};    // overlap, |w'|^2
  double dacc[2] = {0.0, 0.0};   // err_sum, err_sq
  float macc[4] = {kNegFill, kNegFill, kNegFill, kNegFill};
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const size_t g = (size_t)(s + q * T) * W + col;
    const float2 F = v[q];
    const float f2 = F.x * F.x + F.y * F.y;
    const float f = sqrtf(f2) * sc.post;
    const float tv = t[g];
    const float wo = updated_weight(f, tv, w[g], sc, rule);
    wout[g] = wo;

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
    v[q] = make_float2(wo * er, wo * ei);

    facc[1] += wo * wo;
    if (stats_on)
      stats_accumulate(f, tv, mask[g], sc.inv_tsum, sc.inv_fsum, facc, dacc, macc);
  }
  // The stats leave before the inverse transform, so that their
  // accumulators are not live through it.
  write_partials<line_mixed(LINE)>(facc, dacc, macc, partials);
  line_barrier<G == 1>();
  line_fft<LINE, true, G>(v, sbuf + p.c, tc, s, tw_inv, ln);
  store_col_regs(v, hr, hi, W, col, s, 1.f, ln);
}

// The launch bound of cols_wgs_roundtrip: its launch's threads (a mixed
// line: any block up to 1024).
constexpr int roundtrip_threads(int line) {
  return line_mixed(line) ? 1024 : launch_shape(kColsWgsRoundtrip, line).threads;
}

template <int LINE>
__global__ void __launch_bounds__(roundtrip_threads(LINE))
cols_wgs_roundtrip_kernel(
    const float* __restrict__ gr, const float* __restrict__ gi, const float* __restrict__ w,
    const float* __restrict__ t, const float* __restrict__ mask,
    const float* __restrict__ pffr, const float* __restrict__ pffi, float* __restrict__ hr,
    float* __restrict__ hi, float* __restrict__ wout, float* __restrict__ pffr_out,
    float* __restrict__ pffi_out, const float* __restrict__ scal,
    double* __restrict__ partials, int W, int tc, int log2tc,
    const float2* __restrict__ tw_fwd, const float2* __restrict__ tw_inv, int rule, int kim,
    int stats_on, int m) {
  cols_wgs_roundtrip_tile<LINE, 1>(gr, gi, w, t, mask, pffr, pffi, hr, hi, wout, pffr_out,
                                   pffi_out, scal, partials, W, tc, log2tc, tw_fwd, tw_inv,
                                   rule, kim, stats_on, m);
}

template <int LINE, int G>
__global__ void __cluster_dims__(G, 1, 1) __launch_bounds__(roundtrip_threads(LINE))
cols_wgs_roundtrip_cluster_kernel(
    const float* __restrict__ gr, const float* __restrict__ gi, const float* __restrict__ w,
    const float* __restrict__ t, const float* __restrict__ mask,
    const float* __restrict__ pffr, const float* __restrict__ pffi, float* __restrict__ hr,
    float* __restrict__ hi, float* __restrict__ wout, float* __restrict__ pffr_out,
    float* __restrict__ pffi_out, const float* __restrict__ scal,
    double* __restrict__ partials, int W, int tc, int log2tc,
    const float2* __restrict__ tw_fwd, const float2* __restrict__ tw_inv, int rule, int kim,
    int stats_on, int m) {
  cols_wgs_roundtrip_tile<LINE, G>(gr, gi, w, t, mask, pffr, pffi, hr, hi, wout, pffr_out,
                                   pffi_out, scal, partials, W, tc, log2tc, tw_fwd, tw_inv,
                                   rule, kim, stats_on, m);
}

// #7 <- pallas_fft.wgs_fused_forward_pallas (the column pass,
// _cols_wgs_kernel with the angle-plane epilogue). The forward half of a
// psi -> psi WGS step: carry_entry gives the rows pass, this kernel the
// column pass and the epilogue; the inverse transform is ifft2_phase's.
// A column kernel on line_fft with cols_mraf_fwd's tile and launch
// (launch_cols; one cluster of G blocks per tile of cols_tile adjacent
// columns, G = 2 at 4096 points): the forward column line_fft, then per
// register point (s + q H / E, col), at 32-bit offsets (col_offset): f =
// post * |F|, the updated weight, the phase of F (atan2f on re + 0, so that
// a zero point, which the transform may hold as -0, gives 0 as
// store_col_polar does), Kim's select between it and the stored ANGLE plane
// (stored back as an angle), the constrained farfield w' * (cos, sin)(phase)
// and the stats partials (carry_shared.cuh; float64 error moments). Where
// the phase is F's own, (cos, sin) is F/|F| (a zero point (1, 0)); the
// stored angle goes through sincosf with its full range reduction.
//
// Bound on the H100 by bytes: with Kim and stats it reads gr, gi, w, t,
// mask and the angle store and writes re, im, w' and the store: ten planes,
// 50 us at 2048^2 (45 with use_theta on, the store not read). One
// transform, so no barrier follows it.
template <int LINE, int G>
__device__ __forceinline__ void cols_wgs_fwd_tile(
    const float* __restrict__ gr, const float* __restrict__ gi, const float* __restrict__ w,
    const float* __restrict__ t, const float* __restrict__ mask,
    const float* __restrict__ pff, float* __restrict__ re, float* __restrict__ im,
    float* __restrict__ wout, float* __restrict__ pff_out, const float* __restrict__ scal,
    double* __restrict__ partials, const float2* __restrict__ tw_fwd, int rule, int kim,
    int stats_on, int W, int tc, int log2tc, int m) {
  constexpr int E = line_points(LINE);
  extern __shared__ float2 sbuf[];
  const Line<LINE> ln{m};
  float2 v[E];
  const ColPlace p = col_tile_start<LINE, G>(v, gr, gi, W, tc, log2tc, ln);
  line_fft<LINE, false, G>(v, sbuf + p.c, tc, p.s, tw_fwd, ln);

  const StepScalars sc = load_scalars(scal);
  float facc[2] = {0.f, 0.f};    // overlap, |w'|^2
  double dacc[2] = {0.0, 0.0};   // err_sum, err_sq
  float macc[4] = {kNegFill, kNegFill, kNegFill, kNegFill};
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const unsigned g = col_offset<LINE, unsigned>(ln, q, W, p.col, p.s);
    const float2 F = v[q];
    const float f2 = F.x * F.x + F.y * F.y;
    const float f = sqrtf(f2) * sc.post;
    const float tv = t[g];
    const float wo = updated_weight(f, tv, w[g], sc, rule);
    wout[g] = wo;

    float er = 1.f, ei = 0.f;
    if (f2 > 0.f) {
      const float ib = rsqrtf(f2);
      er = F.x * ib;
      ei = F.y * ib;
    }
    if (kim) {
      if (sc.use_theta) {
        pff_out[g] = atan2f(F.y, F.x + 0.f);
      } else {
        const float phase = pff[g];
        pff_out[g] = phase;
        sincosf(phase, &ei, &er);
      }
    }
    re[g] = wo * er;
    im[g] = wo * ei;

    facc[1] += wo * wo;
    if (stats_on)
      stats_accumulate(f, tv, mask[g], sc.inv_tsum, sc.inv_fsum, facc, dacc, macc);
  }
  write_partials<line_mixed(LINE)>(facc, dacc, macc, partials);
}

template <int LINE>
__global__ void __launch_bounds__(cols_max_threads(LINE))
cols_wgs_fwd_kernel(const float* __restrict__ gr, const float* __restrict__ gi,
                    const float* __restrict__ w, const float* __restrict__ t,
                    const float* __restrict__ mask, const float* __restrict__ pff,
                    float* __restrict__ re, float* __restrict__ im, float* __restrict__ wout,
                    float* __restrict__ pff_out, const float* __restrict__ scal,
                    double* __restrict__ partials, const float2* __restrict__ tw_fwd, int rule,
                    int kim, int stats_on, int W, int tc, int log2tc, int m) {
  cols_wgs_fwd_tile<LINE, 1>(gr, gi, w, t, mask, pff, re, im, wout, pff_out, scal, partials,
                             tw_fwd, rule, kim, stats_on, W, tc, log2tc, m);
}

template <int LINE, int G>
__global__ void __cluster_dims__(G, 1, 1) __launch_bounds__(cols_max_threads(LINE))
cols_wgs_fwd_cluster_kernel(const float* __restrict__ gr, const float* __restrict__ gi,
                            const float* __restrict__ w, const float* __restrict__ t,
                            const float* __restrict__ mask, const float* __restrict__ pff,
                            float* __restrict__ re, float* __restrict__ im,
                            float* __restrict__ wout, float* __restrict__ pff_out,
                            const float* __restrict__ scal, double* __restrict__ partials,
                            const float2* __restrict__ tw_fwd, int rule, int kim,
                            int stats_on, int W, int tc, int log2tc, int m) {
  cols_wgs_fwd_tile<LINE, G>(gr, gi, w, t, mask, pff, re, im, wout, pff_out, scal, partials,
                             tw_fwd, rule, kim, stats_on, W, tc, log2tc, m);
}

#if !SLM_UNIT_MIXED
// Second pass of #2 and of cols_wgs_fwd: one block folds the (n_blocks, 8)
// partials into sums[0:4] (float64 storage; the overlap and |w'|^2 summed
// in float32, the error moments in float64) and maxs[0:4] (float32), in a
// fixed order.
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
#endif

// #3 <- pallas_fft.wgs_carry_step_pallas kernel A (_rows_normfwd_kernel,
// _rows_normfwd_amp_kernel): inverse row FFT -> Z, Z/|Z| or amp * Z/|Z|
// (zero -> 1 or amp, real), forward row FFT.
//
// Bound on the H100 by bytes: two planes read and two written (an
// amplitude plane: three read), 20 (25) us at 2048^2. The rows are
// rows_fft's (natural_fft.cu, row_place): the inverse line_fft stays
// unnormalized (Z/|Z| does not see the scale), the amplitude replacement
// runs on the registers (the amplitude plane read at the same indices),
// and the forward line_fft and the store follow from the same registers.
// The block barrier between the transforms is required: the forward's
// first exchange writes the buffer that the inverse's last exchange may
// still be read from.
template <int LINE>
__global__ void __launch_bounds__(rows_max_threads(LINE))
rows_normfwd_kernel(const float* __restrict__ hr, const float* __restrict__ hi,
                    const float* __restrict__ amp, float* __restrict__ gr,
                    float* __restrict__ gi, const float2* __restrict__ tw_fwd,
                    const float2* __restrict__ tw_inv, int m) {
  constexpr int E = line_points(LINE);
  extern __shared__ float2 sbuf[];
  const Line<LINE> ln{m};
  const int T = ln.threads();
  const RowPlace p = row_place(sbuf, ln);
  float2 v[E];
  load_row_regs(v, hr, hi, p.base, ln);
  line_fft<LINE, true>(v, p.buf, 1, p.s, tw_inv, ln);
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const float2 z = v[q];
    const float a = amp ? amp[p.base + q * T] : 1.f;
    const float mag2 = z.x * z.x + z.y * z.y;
    if (mag2 > 0.f) {
      const float inv = a * rsqrtf(mag2);
      v[q] = make_float2(z.x * inv, z.y * inv);
    } else {
      v[q] = make_float2(a, 0.f);
    }
  }
  __syncthreads();
  line_fft<LINE, false>(v, p.buf, 1, p.s, tw_fwd, ln);
  store_row_regs(v, gr, gi, p.base, 1.f, ln);
}

// #4 <- pallas_fft.wgs_carry_exit_pallas (_rows_phase_extract_kernel):
// the inverse row FFT of the carry, then psi = atan2f(Im, Re) (0 where the
// point is 0, as torch.atan2).
//
// Bound on the H100 by bytes: gr and gi read, psi written, 15 us at
// 2048^2. The rows are rows_fft's (row_place): load_row_regs, the inverse
// line_fft left unnormalized (atan2 does not see the scale), atan2f on the
// registers, and one plane stored at the same indices. 64 registers at
// 2048 and 4096 points (80 at 1024), no spill: 58% of the bound at 2048^2
// (0.026 ms; the first version 0.104), 76% at 4096^2. PERF.md, section 6.
template <int LINE>
__global__ void __launch_bounds__(rows_max_threads(LINE))
carry_exit_kernel(const float* __restrict__ gr, const float* __restrict__ gi,
                  float* __restrict__ psi, const float2* __restrict__ tw_inv, int m) {
  constexpr int E = line_points(LINE);
  extern __shared__ float2 sbuf[];
  const Line<LINE> ln{m};
  const int T = ln.threads();
  const RowPlace p = row_place(sbuf, ln);
  float2 v[E];
  load_row_regs(v, gr, gi, p.base, ln);
  line_fft<LINE, true>(v, p.buf, 1, p.s, tw_inv, ln);
#pragma unroll
  for (int q = 0; q < E; ++q) psi[p.base + q * T] = atan2f(v[q].y, v[q].x);
}

#if !SLM_UNIT_MIXED
cudaError_t launch_stats_reduce(const double* partials, int n_blocks,
                                double* sums, float* maxs, cudaStream_t stream) {
  stats_reduce_kernel<<<1, kThreads, 0, stream>>>(partials, n_blocks, sums,
                                                  maxs);
  return cudaGetLastError();
}
#endif

// Launch of one instantiation of cols_wgs_roundtrip, and of stats_reduce
// on its n_blocks rows of partials (which must be the grid's). The dynamic
// shared memory is above the 48 KB default from H = 1024 on: the attribute
// is the instantiation's own.
template <int LINE>
int launch_cols_wgs_roundtrip(const float* gr, const float* gi, const float* w,
                              const float* t, const float* mask, const float* pffr,
                              const float* pffi, float* hr, float* hi, float* wout,
                              float* pffr_out, float* pffi_out, const float* scal,
                              double* partials, double* sums, float* maxs, int W, int m,
                              int n_blocks, const float2* tw_fwd, const float2* tw_inv,
                              int rule, int kim, int stats_on, cudaStream_t stream) {
  constexpr int G = cols_cluster(LINE);
  const int n = m << line_log2(LINE);
  const LaunchShape shape = line_launch(kColsWgsRoundtrip, n, W);
  if (n_blocks <= 0 || n_blocks != cols_blocks(kColsWgsRoundtrip, n, W) ||
      shape.threads > roundtrip_threads(LINE) || shape.smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  auto kernel = [] {
    if constexpr (G > 1) return cols_wgs_roundtrip_cluster_kernel<LINE, G>;
    else return cols_wgs_roundtrip_kernel<LINE>;
  }();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shape.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_blocks, shape.threads, shape.smem, stream>>>(
      gr, gi, w, t, mask, pffr, pffi, hr, hi, wout, pffr_out, pffi_out, scal, partials, W,
      shape.lines, ilog2(shape.lines), tw_fwd, tw_inv, rule, kim, stats_on, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_stats_reduce(partials, n_blocks, sums, maxs, stream);
}

// Launch of one instantiation of cols_wgs_fwd (launch_cols; the cluster
// instantiation where cols_cluster says more than one block), then
// stats_reduce on its n_blocks rows of partials, which must be the grid's
// (cols_blocks).
template <int LINE>
int launch_cols_wgs_fwd(const float* gr, const float* gi, const float* w, const float* t,
                        const float* mask, const float* pff, float* re, float* im,
                        float* wout, float* pff_out, const float* scal, double* partials,
                        double* sums, float* maxs, int W, int m, int n_blocks,
                        const float2* tw_fwd, int rule, int kim, int stats_on,
                        cudaStream_t stream) {
  constexpr int G = cols_cluster(LINE);
  if (n_blocks <= 0 || n_blocks != cols_blocks(kColsWgsFwd, m << line_log2(LINE), W))
    return (int)cudaErrorInvalidValue;
  auto kernel = [] {
    if constexpr (G > 1) return cols_wgs_fwd_cluster_kernel<LINE, G>;
    else return cols_wgs_fwd_kernel<LINE>;
  }();
  const int err = launch_cols<kColsWgsFwd, LINE>(kernel, W, m, stream, gr, gi, w, t, mask, pff,
                                                  re, im, wout, pff_out, scal, partials,
                                                  tw_fwd, rule, kim, stats_on);
  if (err != (int)cudaSuccess) return err;
  return (int)launch_stats_reduce(partials, n_blocks, sums, maxs, stream);
}

// Launches of one instantiation of the row kernels (launch_rows).
template <int LINE>
int launch_rows_normfwd(const float* hr, const float* hi, const float* amp, float* gr,
                        float* gi, int H, int m, const float2* tw_fwd, const float2* tw_inv,
                        cudaStream_t stream) {
  return launch_rows<kRowsNormfwd, LINE>(rows_normfwd_kernel<LINE>, H, m, stream, hr, hi, amp,
                                         gr, gi, tw_fwd, tw_inv);
}

// carry_entry over `planes` stacked (H, W) phase planes: planes H rows;
// the WRAP instantiation for a stack of planes whose H W is not a power of
// two.
template <int LINE>
int launch_carry_entry(const float* psi, const float* amp, float* gr, float* gi, int planes,
                       int H, int m, const float2* tw, cudaStream_t stream) {
  const size_t plane = (size_t)H * (size_t)(m << line_log2(LINE));
  if (planes > 1 && (plane & (plane - 1)))
    return launch_rows<kCarryEntry, LINE>(carry_entry_kernel<LINE, true>, planes * H, m, stream,
                                          psi, amp, gr, gi, tw, plane - 1);
  return launch_rows<kCarryEntry, LINE>(carry_entry_kernel<LINE, false>, planes * H, m, stream,
                                        psi, amp, gr, gi, tw, planes > 1 ? plane - 1 : ~(size_t)0);
}

template <int LINE>
int launch_carry_exit(const float* gr, const float* gi, float* psi, int H, int m,
                      const float2* tw_inv, cudaStream_t stream) {
  return launch_rows<kCarryExit, LINE>(carry_exit_kernel<LINE>, H, m, stream, gr, gi, psi,
                                       tw_inv);
}

}  // namespace slm

using namespace slm;

extern "C" {

int SLM_ENTRY(slm_carry_entry)(const float* psi, const float* amp, float* gr, float* gi, int planes,
                    int H, int W, const float2* tw, cudaStream_t stream) {
  if (planes < 1) return (int)cudaErrorInvalidValue;
  int m = 0;
  switch (line_code(W, &m)) {
    SLM_LEN_CASES(launch_carry_entry, psi, amp, gr, gi, planes, H, m, tw, stream)
  }
  return (int)cudaErrorInvalidValue;
}

int SLM_ENTRY(slm_cols_wgs_roundtrip)(const float* gr, const float* gi, const float* w,
                           const float* t, const float* mask,
                           const float* pffr, const float* pffi, float* hr,
                           float* hi, float* wout, float* pffr_out,
                           float* pffi_out, const float* scal,
                           double* partials, double* sums, float* maxs,
                           int H, int W, int n_blocks, const float2* tw_fwd,
                           const float2* tw_inv, int rule, int kim, int stats_on,
                           cudaStream_t stream) {
  int m = 0;
  switch (line_code(H, &m)) {
    SLM_LEN_CASES(launch_cols_wgs_roundtrip, gr, gi, w, t, mask, pffr, pffi, hr, hi, wout,
                  pffr_out, pffi_out, scal, partials, sums, maxs, W, m, n_blocks, tw_fwd,
                  tw_inv, rule, kim, stats_on, stream)
  }
  return (int)cudaErrorInvalidValue;
}

// n_blocks: the rows of `partials`, slm_cols_blocks(kColsWgsFwd, H, W).
int SLM_ENTRY(slm_cols_wgs_fwd)(const float* gr, const float* gi, const float* w,
                     const float* t, const float* mask, const float* pff,
                     float* re, float* im, float* wout, float* pff_out,
                     const float* scal, double* partials, double* sums,
                     float* maxs, int H, int W, int n_blocks, const float2* tw_fwd,
                     int rule, int kim, int stats_on, cudaStream_t stream) {
  int m = 0;
  switch (line_code(H, &m)) {
    SLM_LEN_CASES(launch_cols_wgs_fwd, gr, gi, w, t, mask, pff, re, im, wout, pff_out, scal,
                  partials, sums, maxs, W, m, n_blocks, tw_fwd, rule, kim, stats_on, stream)
  }
  return (int)cudaErrorInvalidValue;
}

int SLM_ENTRY(slm_rows_normfwd)(const float* hr, const float* hi, const float* amp,
                     float* gr, float* gi, int H, int W, const float2* tw_fwd,
                     const float2* tw_inv, cudaStream_t stream) {
  int m = 0;
  switch (line_code(W, &m)) {
    SLM_LEN_CASES(launch_rows_normfwd, hr, hi, amp, gr, gi, H, m, tw_fwd, tw_inv, stream)
  }
  return (int)cudaErrorInvalidValue;
}

int SLM_ENTRY(slm_carry_exit)(const float* gr, const float* gi, float* psi, int H, int W,
                   const float2* tw_inv, cudaStream_t stream) {
  int m = 0;
  switch (line_code(W, &m)) {
    SLM_LEN_CASES(launch_carry_exit, gr, gi, psi, H, m, tw_inv, stream)
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
