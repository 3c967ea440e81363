// Natural-order FFT kernels of the GS engine's natural (non-fused) path,
// for Hopper (sm_90a).
//
// The three column kernels and rows_fft also take a stack of B (H, W)
// planes in one launch, as the reference's vmap over the multiplane
// engine's planes gives its Pallas calls a grid axis: rows_fft sees B H
// rows, and a column kernel's grid has the planes along y (launch_cols_planes),
// each block moving its base pointers once to its plane (plane_offset).
//
// One natural step is a forward 2D FFT to (|F|, arg F), the farfield
// constraint in PyTorch, and an inverse 2D FFT back to psi. Where the
// farfield is the SLM plane, the forward half is carry_entry (wgs_carry.cu,
// a row kernel on line_fft) then cols_fwd_polar, and the backward half
// cols_wexp_inv then carry_exit (wgs_carry.cu, likewise). On a padded
// canvas or with a propagation kernel, it is
// rows_fft then cols_fwd_polar, and cols_wexp_inv then rows_fft; fft2 and
// ifft2 outside the loop are rows_fft and cols_fft. Semantics: the
// plain PyTorch versions `_rows_fft`, `_cols_fft`, `_cols_fwd_polar` and
// `_cols_wexp_inv` in slmsuite_torch/ops/fft.py.
//
// What bounds them on the H100: memory traffic. Each kernel reads two f32
// planes and writes two (at 2048^2, 4 x 16.8 MB = 67 MB, 20 us at
// 3.35 TB/s); its FFT arithmetic, 5 N log2 N flops per line, is ~0.23
// GFLOP, 3.5 us at the 67 TFLOP/s f32 peak. So the design touches device
// memory once per operand. All four hold their lines in registers and run
// line_fft (fft_shared.cuh): rows_fft a row per W / E threads, the three
// column kernels a tile of tc = cols_tile adjacent columns with lanes
// across the tile, so that each row segment they load or store is a whole
// 32-byte sector (at 4096 points on a cluster of two blocks). See the notes
// above them.
// The polar output, the ortho scale and the constraint synthesis
// w * e^{i phi} live in the kernels' prologues and epilogues, on the
// registers, so no complex farfield plane exists in device memory in the
// full-fuse geometry.
//
// Launchers take raw pointers, sizes, scales and a stream, and return
// cudaGetLastError(). They allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_shared.cuh"

namespace slm {

// #5 (rows half) <- pallas_fft._fft_rows (slmsuite_tpu/ops/pallas_fft.py:373,
// _rows_kernel; used by fft2_scrambled_pallas, ifft2_scrambled_pallas):
// forward or unnormalized inverse FFT of every row, times `scale`.
//
// Bound on the H100 by bytes: two planes read, two written, 5 log2 W flops
// a point against 16 bytes. The first version (one row a block in shared
// memory, a radix-2 transform there: 12 barriers and 13 shared-memory round trips a row at
// 2048, a global twiddle load a butterfly) ran at 18% of that bound. Here
// a row never rests in shared memory: thread s of the row's W / E threads
// loads the points s + q W / E straight into registers (a warp reads 128
// contiguous bytes an instruction, 2 E loads in flight a thread), line_fft
// transforms them with one or two exchanges, and the thread stores the
// same indices from registers, scaled. A block of 256 threads holds
// 256 E / W rows, and three blocks fit an SM at W = 1024 and 2048 (70-74
// registers a thread; more blocks at the other lengths), so one block's loads and
// stores overlap the others' butterflies. The loads are 4-byte ones: the
// layout s + q W / E gives a thread no two adjacent points, so a 16-byte
// load would have to stage the row in shared memory first, and rows staged
// there (by cp.async.bulk and an mbarrier) were slower, 0.035 against
// 0.033 ms at 2048^2 by CUDA events. Nothing here needs more than the
// planes' 4-byte alignment.
template <int LINE, bool INV>
__global__ void __launch_bounds__(rows_max_threads(LINE))
rows_fft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi,
                const float2* __restrict__ tw, float scale, int m) {
  extern __shared__ float2 sbuf[];
  const Line<LINE> ln{m};
  const RowPlace p = row_place(sbuf, ln);
  float2 v[line_points(LINE)];
  load_row_regs(v, xr, xi, p.base, ln);
  line_fft<LINE, INV>(v, p.buf, 1, p.s, tw, ln);
  store_row_regs(v, yr, yi, p.base, scale, ln);
}

// #5 (cols half) <- pallas_fft._fft_cols (slmsuite_tpu/ops/pallas_fft.py:385,
// _cols_kernel): forward or unnormalized inverse FFT of every column, times
// `scale`. One cluster of G blocks per tile of tc = cols_tile adjacent
// columns, tc * H / E threads in all.
//
// Bound on the H100 by bytes, as rows_fft_kernel, and in practice by the
// width of a row segment: at 2048^2 this kernel takes 0.13 ms with 8-byte
// segments (tc = 2), 0.09 with 16, 0.04 with 32 (a whole sector) and no
// less with 64. The first version staged the tile in shared memory column
// by column (a 4-way bank conflict at tc = 4), ran a radix-2 FFT on it and
// read it back for the store, with 4 columns at H = 2048 and 2 at 4096: 9%
// of the bound. Here lanes run across the tile's columns, then down the
// rows: thread (s, c) loads rows s + q H / E of column c straight into
// registers, so a warp's load instruction touches 32 / tc row segments of
// 4 tc bytes, and the first butterfly needs no staging. The exchange
// buffer interleaves the columns (slot stride tc), so lanes stay adjacent
// in shared memory too, and line_pad keeps the first pass's writes off
// each other's banks. The store goes from registers, scaled. tc = 8 fills
// the sectors (cols_tile); the registers of one SM
// hold 16 K points, 8 columns of 2048 in one block of 1024 threads. At
// 4096 points a block holds 4 columns, so two blocks of a cluster take
// every line's threads in turn (G = 2; line_fft's first exchange goes
// through distributed shared memory): 0.18 ms against 0.32 for one block
// with tc = 4. At 2048 the cluster loses to one block (0.046 against 0.041 ms).
// tc reaches the kernel as an argument: as a constant of the instantiation
// the 2048-point kernel spilled 108 bytes under its 64 registers and took
// 0.052 ms against 0.039.
// The cluster's size is the kernel's attribute: given at the launch
// instead, the same code took 0.21 ms.
template <int LINE, bool INV, int G>
__device__ __forceinline__ void cols_fft_tile(const float* __restrict__ xr,
                                              const float* __restrict__ xi,
                                              float* __restrict__ yr,
                                              float* __restrict__ yi,
                                              const float2* __restrict__ tw, float scale,
                                              int W, int tc, int log2tc, int m) {
  extern __shared__ float2 sbuf[];
  const Line<LINE> ln{m};
  const size_t plane = plane_offset(W, ln);
  xr += plane, xi += plane, yr += plane, yi += plane;
  float2 v[line_points(LINE)];
  const ColPlace p = col_tile_start<LINE, G>(v, xr, xi, W, tc, log2tc, ln);
  line_fft<LINE, INV, G>(v, sbuf + p.c, tc, p.s, tw, ln);
  store_col_regs(v, yr, yi, W, p.col, p.s, scale, ln);
}

template <int LINE, bool INV>
__global__ void __launch_bounds__(cols_max_threads(LINE))
cols_fft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi,
                const float2* __restrict__ tw, float scale, int W, int tc, int log2tc, int m) {
  cols_fft_tile<LINE, INV, 1>(xr, xi, yr, yi, tw, scale, W, tc, log2tc, m);
}

template <int LINE, bool INV, int G>
__global__ void __cluster_dims__(G, 1, 1) __launch_bounds__(cols_max_threads(LINE))
cols_fft_cluster_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                        float* __restrict__ yr, float* __restrict__ yi,
                        const float2* __restrict__ tw, float scale, int W, int tc,
                        int log2tc, int m) {
  cols_fft_tile<LINE, INV, G>(xr, xi, yr, yi, tw, scale, W, tc, log2tc, m);
}

// #5 polar and #6 (cols half) <- pallas_fft._cols_kernel(polar_out=True)
// (slmsuite_tpu/ops/pallas_fft.py:332; fft2_scrambled_polar_pallas :406,
// and fft2_scrambled_polar_from_phase's last pallas_call, :559): the
// forward FFT of every column, then |F| * scale and atan2f(Im F, Re F) (0
// where F = 0, as torch.atan2). The complex farfield never reaches device
// memory.
//
// Bound on the H100 by bytes, as cols_fft_kernel: two planes read, two
// written, 20 us at 2048^2. The tile, the cluster at 4096 points and the
// transform are cols_fft's (col_tile_start, line_fft); the epilogue runs
// on the registers, thread (s, c) holding rows s + q H / E of its column,
// and stores the two planes at load_col_regs' offsets (store_col_polar).
// 64 registers at 2048 and 4096 points, no spill: 0.040 ms at 2048^2, 50%
// of the bound and within 3% of cols_fft (45% at 4096^2); the first
// version, the tile staged in shared memory for a radix-2 FFT, took 0.22 ms, 9%.
// PERF.md, section 6, has the measurements.
template <int LINE, int G>
__device__ __forceinline__ void cols_fwd_polar_tile(const float* __restrict__ xr,
                                                    const float* __restrict__ xi,
                                                    float* __restrict__ amp,
                                                    float* __restrict__ theta,
                                                    const float2* __restrict__ tw, float scale,
                                                    int W, int tc, int log2tc, int m) {
  extern __shared__ float2 sbuf[];
  const Line<LINE> ln{m};
  const size_t plane = plane_offset(W, ln);
  xr += plane, xi += plane, amp += plane, theta += plane;
  float2 v[line_points(LINE)];
  const ColPlace p = col_tile_start<LINE, G>(v, xr, xi, W, tc, log2tc, ln);
  line_fft<LINE, false, G>(v, sbuf + p.c, tc, p.s, tw, ln);
  store_col_polar(v, amp, theta, W, p.col, p.s, scale, ln);
}

template <int LINE>
__global__ void __launch_bounds__(cols_max_threads(LINE))
cols_fwd_polar_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                      float* __restrict__ amp, float* __restrict__ theta,
                      const float2* __restrict__ tw, float scale, int W, int tc, int log2tc,
                      int m) {
  cols_fwd_polar_tile<LINE, 1>(xr, xi, amp, theta, tw, scale, W, tc, log2tc, m);
}

template <int LINE, int G>
__global__ void __cluster_dims__(G, 1, 1) __launch_bounds__(cols_max_threads(LINE))
cols_fwd_polar_cluster_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                              float* __restrict__ amp, float* __restrict__ theta,
                              const float2* __restrict__ tw, float scale, int W, int tc,
                              int log2tc, int m) {
  cols_fwd_polar_tile<LINE, G>(xr, xi, amp, theta, tw, scale, W, tc, log2tc, m);
}

// #11 (cols half) <- pallas_fft._cols_wexp_inv_kernel
// (slmsuite_tpu/ops/pallas_fft.py:1885; wexp_ifft2_scrambled_phase :1902,
// wexp_ifft2_scrambled :1943): the constraint w * e^{i phi}, then the
// unnormalized inverse FFT of every column. carry_exit_kernel
// (wgs_carry.cu) finishes arg ifft2 with the inverse rows and atan2f;
// rows_fft_kernel (inverse, ortho scale) finishes the complex ifft2 of
// wexp_ifft2_scrambled (#12) on the padded canvas.
//
// Bound on the H100 by bytes: w and phi read, the pair written, 20 us at
// 2048^2. The tile, the cluster and the transform are cols_fft's; the
// start (col_tile_start_wexp) loads w and phi at load_col_regs' offsets
// and forms the phasors on the registers with an inline, fully
// range-reduced sincosf (carry_entry_kernel's note in wgs_carry.cu has why
// inline), before the cluster's barrier. 64 registers at 2048 and 4096
// points, no spill (a 32-byte stack frame for sincosf's Payne-Hanek array
// at 64 and 512 points only): 0.042 ms at 2048^2, 48% of the bound (44% at
// 4096^2); the first version, the constraint synthesised into a
// shared-memory tile for a radix-2 FFT, took 0.25 ms, 8%.
template <int LINE, int G>
__device__ __forceinline__ void cols_wexp_inv_tile(const float* __restrict__ w,
                                                   const float* __restrict__ phi,
                                                   float* __restrict__ yr,
                                                   float* __restrict__ yi,
                                                   const float2* __restrict__ tw_inv, int W,
                                                   int tc, int log2tc, int m) {
  extern __shared__ float2 sbuf[];
  const Line<LINE> ln{m};
  const size_t plane = plane_offset(W, ln);
  w += plane, phi += plane, yr += plane, yi += plane;
  float2 v[line_points(LINE)];
  const ColPlace p = col_tile_start_wexp<LINE, G>(v, w, phi, W, tc, log2tc, ln);
  line_fft<LINE, true, G>(v, sbuf + p.c, tc, p.s, tw_inv, ln);
  store_col_regs(v, yr, yi, W, p.col, p.s, 1.f, ln);
}

template <int LINE>
__global__ void __launch_bounds__(cols_max_threads(LINE))
cols_wexp_inv_kernel(const float* __restrict__ w, const float* __restrict__ phi,
                     float* __restrict__ yr, float* __restrict__ yi,
                     const float2* __restrict__ tw_inv, int W, int tc, int log2tc, int m) {
  cols_wexp_inv_tile<LINE, 1>(w, phi, yr, yi, tw_inv, W, tc, log2tc, m);
}

template <int LINE, int G>
__global__ void __cluster_dims__(G, 1, 1) __launch_bounds__(cols_max_threads(LINE))
cols_wexp_inv_cluster_kernel(const float* __restrict__ w, const float* __restrict__ phi,
                             float* __restrict__ yr, float* __restrict__ yi,
                             const float2* __restrict__ tw_inv, int W, int tc, int log2tc,
                             int m) {
  cols_wexp_inv_tile<LINE, G>(w, phi, yr, yi, tw_inv, W, tc, log2tc, m);
}

// Launch of one instantiation of rows_fft_kernel (launch_rows).
template <int LINE, bool INV>
int launch_rows_fft(const float* xr, const float* xi, float* yr, float* yi, int H, int m,
                    const float2* tw, float scale, cudaStream_t stream) {
  return launch_rows<kRowsFft, LINE>(rows_fft_kernel<LINE, INV>, H, m, stream, xr, xi, yr, yi,
                                     tw, scale);
}

// Launches of one instantiation of the column kernels (launch_cols): the
// cluster instantiation where cols_cluster says more than one block.
template <int LINE, bool INV>
int launch_cols_fft(const float* xr, const float* xi, float* yr, float* yi, int W,
                    int planes, int m, const float2* tw, float scale, cudaStream_t stream) {
  constexpr int G = cols_cluster(LINE);
  auto kernel = [] {
    if constexpr (G > 1) return cols_fft_cluster_kernel<LINE, INV, G>;
    else return cols_fft_kernel<LINE, INV>;
  }();
  return launch_cols_planes<kColsFft, LINE>(kernel, W, planes, m, stream, xr, xi, yr, yi, tw,
                                            scale);
}

template <int LINE>
int launch_cols_fwd_polar(const float* xr, const float* xi, float* amp, float* theta, int W,
                          int planes, int m, const float2* tw, float scale,
                          cudaStream_t stream) {
  constexpr int G = cols_cluster(LINE);
  auto kernel = [] {
    if constexpr (G > 1) return cols_fwd_polar_cluster_kernel<LINE, G>;
    else return cols_fwd_polar_kernel<LINE>;
  }();
  return launch_cols_planes<kColsFwdPolar, LINE>(kernel, W, planes, m, stream, xr, xi, amp,
                                                 theta, tw, scale);
}

template <int LINE>
int launch_cols_wexp_inv(const float* w, const float* phi, float* yr, float* yi, int W,
                         int planes, int m, const float2* tw_inv, cudaStream_t stream) {
  constexpr int G = cols_cluster(LINE);
  auto kernel = [] {
    if constexpr (G > 1) return cols_wexp_inv_cluster_kernel<LINE, G>;
    else return cols_wexp_inv_kernel<LINE>;
  }();
  return launch_cols_planes<kColsWexpInv, LINE>(kernel, W, planes, m, stream, w, phi, yr, yi,
                                                tw_inv);
}

}  // namespace slm

using namespace slm;

extern "C" {

int SLM_ENTRY(slm_rows_fft)(const float* xr, const float* xi, float* yr, float* yi, int H,
                 int W, int inverse, const float2* tw, float scale,
                 cudaStream_t stream) {
  int m = 0;
  switch (line_code(W, &m) * 2 + (inverse != 0)) {
    SLM_LINE_CASES(launch_rows_fft, xr, xi, yr, yi, H, m, tw, scale, stream)
  }
  return (int)cudaErrorInvalidValue;
}

// The column launchers take `planes` stacked (H, W) planes (1: one plane).
int SLM_ENTRY(slm_cols_fft)(const float* xr, const float* xi, float* yr, float* yi, int planes,
                 int H, int W, int inverse, const float2* tw, float scale,
                 cudaStream_t stream) {
  int m = 0;
  switch (line_code(H, &m) * 2 + (inverse != 0)) {
    SLM_LINE_CASES(launch_cols_fft, xr, xi, yr, yi, W, planes, m, tw, scale, stream)
  }
  return (int)cudaErrorInvalidValue;
}

#if !SLM_UNIT_MIXED
// out[0..4) = the LaunchShape (lines, cluster, threads, smem) of `kernel`
// (a LineKernel: rows_fft, cols_fft, rows_normfwd, cols_wgs_roundtrip,
// carry_entry, carry_exit, cols_fwd_polar, cols_wexp_inv, cols_mraf_fwd,
// cols_mraf_mix_inv, cols_wgs_fwd) on lines of n points, a multiple of 8
// in [64, 8192], where the plane's other side is `other` (0: a multiple of
// every tile; line_launch).
int slm_fft_launch_shape(int kernel, int n, int other, int* out) {
  if (other < 0 || other % 8) return (int)cudaErrorInvalidValue;
  const LaunchShape shape = line_launch(kernel, n, other);
  if (shape.lines == 0) return (int)cudaErrorInvalidValue;
  out[0] = shape.lines;
  out[1] = shape.cluster;
  out[2] = shape.threads;
  out[3] = shape.smem;
  return 0;
}

// Blocks of a launch of the column kernel `kernel` (a LineKernel) on an
// (H, W) pair, that is the rows of the stats partials of cols_wgs_roundtrip,
// cols_mraf_fwd and cols_wgs_fwd (cols_blocks); -1 for a pair or a kernel it
// does not take.
int slm_cols_blocks(int kernel, int H, int W) { return cols_blocks(kernel, H, W); }
#endif

int SLM_ENTRY(slm_cols_fwd_polar)(const float* xr, const float* xi, float* amp, float* theta,
                       int planes, int H, int W, const float2* tw, float scale,
                       cudaStream_t stream) {
  int m = 0;
  switch (line_code(H, &m)) {
    SLM_LEN_CASES(launch_cols_fwd_polar, xr, xi, amp, theta, W, planes, m, tw, scale, stream)
  }
  return (int)cudaErrorInvalidValue;
}

int SLM_ENTRY(slm_cols_wexp_inv)(const float* w, const float* phi, float* yr, float* yi, int planes,
                      int H, int W, const float2* tw_inv, cudaStream_t stream) {
  int m = 0;
  switch (line_code(H, &m)) {
    SLM_LEN_CASES(launch_cols_wexp_inv, w, phi, yr, yi, W, planes, m, tw_inv, stream)
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
