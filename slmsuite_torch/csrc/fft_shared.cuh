// The FFT of the kernels of wgs_carry.cu, natural_fft.cu and mraf_carry.cu:
// the register-resident line_fft, with the row and column places, loads and
// stores, tile widths, launch shapes and launchers of the kernels on it
// (rows_fft, cols_fft, cols_fwd_polar, cols_wexp_inv, rows_normfwd,
// cols_wgs_roundtrip, carry_entry, carry_exit, cols_mraf_fwd,
// cols_mraf_mix_inv, cols_wgs_fwd).
//
// Replaces `_fft_core` in slmsuite_tpu/ops/pallas_fft.py: a four-step DFT
// written as block-complex matrix products for the TPU's matrix unit. On
// Hopper a line of up to 4096 complex f32 fits in the registers of the
// threads that hold it: the transform is radix-8/16 passes in registers
// with self-sorting exchanges through shared memory, unnormalized in both
// directions, like the TPU kernels.
//
// The twiddle table is built once per (n, direction) on the host in
// float64 and stored as f32: tw[k] = exp(sign * 2 pi i k / n), k < n/2,
// sign = -1 forward, +1 inverse.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace slm {

constexpr int kThreads = 256;

// ----------------------------------------------------------------------
// The register-resident line FFT (rows_fft_kernel, cols_fft_kernel,
// cols_fwd_polar_kernel and cols_wexp_inv_kernel of natural_fft.cu;
// rows_normfwd_kernel, cols_wgs_roundtrip_kernel, carry_entry_kernel,
// carry_exit_kernel and cols_wgs_fwd_kernel of wgs_carry.cu;
// cols_mraf_fwd_kernel and cols_mraf_mix_inv_kernel of mraf_carry.cu).
//
// A radix-2 transform staged in shared memory would cross it log2(n) + 1
// times with a barrier each and read a twiddle from global memory per
// butterfly (the port's first design, PERF.md section 6). line_fft keeps
// the line in registers: a thread holds E = 8 or 16 points and does radix-8 or
// radix-16 butterflies on them with the rotations inside the radix as
// constants; the line crosses shared memory only between passes, in a
// self-sorting (Stockham) exchange, so there is no bit-reversal pass.
// Plan per length (fft_plan in ops/cuda_fft.py; ops/cuda_fft.py's
// line_fft_model follows this code pass by pass on the CPU):
//   64 = 8*8, 128 = 8*16, 256 = 16*16, 512 = 8*8*8, 1024 = 8*8*16,
//   2048 = 8*16*16, 4096 = 16*16*16, 8192 = 8*8*8*16
// that is two to four passes, one to three exchanges. A line takes n / E
// threads. Thread s holds, before the first pass
// and after the last, the points s + q * (n / E), q < E, in v[q]: a caller
// loads them straight from global memory and an epilogue finds its output
// in the same registers. A pass of radix R with p = the product of the
// radices before it gives butterfly i (i < n / R; thread s runs the
// E / R butterflies i = s + b * n / E) the inputs i + r * n / R, rotates
// input r by tw^(r k n / (p R)), k = i mod p, and writes output r to
// (i - k) R + k + r p. The rotations between passes come from the
// float64-built f32 table tw[m] = exp(-+ 2 pi i m / n), m < n / 2: a
// butterfly reads w = tw^(k n / (p R)) and w^4 and forms the other powers
// by at most three products, 2 n / R loads a line and pass, not n / 2 a
// stage. (A load for each of the R - 1 powers cost rows_fft a fifth of its
// time at 2048^2 on the H100, lanes of a warp reading up to 32 lines of the
// table; staging the table in shared memory changed nothing, its banks
// conflict the same way.)
//
// Lines that are not a power of two (mixed lines): n = P m, P = 8 where n
// has three or five factors of 2, else P = 16, the points a thread holds
// (any other side that is a multiple of 8 in [64, 8192]; ops/cuda_fft.py's
// line_split). A four-step split: the line's m threads are m interleaved
// P-point lines (thread s holds the points s + q m, q < P, of line s: one
// radix-P butterfly in registers, no exchange), then output k1 of line s
// is rotated by w_n^(s k1) (two table reads a thread, the other powers by
// products) into point s of the m-point line k1, and the m-point DFTs run
// as Stockham passes between the two halves of the line's buffer in
// shared memory (m_part; one barrier a pass): the power of two of m in
// passes of radix 4, 8 or 16, then its odd part, its 3s in pairs as 9 and
// a 3 with a 5 as 15 (1080 = 8 * 9 * 15, 1152 = 16 * 8 * 9, 1920 = 16 * 8
// * 15, 6144 = 16 * 16 * 8 * 3). Radices up to 16 are butterflies in
// registers with their rotations as constants (m_pass: ceil(P / r)
// butterflies a thread, one at a time, one table read a butterfly, two
// from radix 8 on, the other powers by products); a prime of 11 or more
// is a direct sum (m_pass_direct). The passes' radices, strides, counts
// and the multipliers that divide without a division (m_div) are the
// host's (cuda_fft.m_pass_table), read from after the line's table of
// twiddles; the branch on the radix is uniform across the block. Point j
// of the m-point line k1 sits in slot j (P + 1) + k1, so that a thread's P
// writes fall on distinct banks across a warp and the line's output x = k1
// + P k2 sits in slot x + x / P, where the last read finds it. Two plans
// in all (P = 8, 16), one block a line group (no cluster). The first
// design of the mixed lines (P = 8, one pass a prime factor of m, 2
// included, each output a direct sum with a table read a term) reached 9%
// of the bound at 1152x1920; a single buffer, each thread holding all its
// butterflies of a pass across the barrier, spilled 1 KB a thread at P =
// 16 under the 64 registers of a block of 1024.
//
// A line may be shared by a cluster of G blocks (G = 1: one block). The
// line's T = n / E threads go to the blocks in groups of 8: block g holds
// the threads s with (s / 8) mod G = g (line_thread gives s). A block's
// exchange buffer holds the points that its own threads read; whoever
// computes a point writes it there, through distributed shared memory
// where it is another block's, and the barriers of such an exchange are
// the cluster's. After a pass with p a multiple of 8 G a thread's outputs
// (i - k) R + k + r p all go to readers s' = k mod 8 G = s mod 8 G, its
// own block: that exchange is local, with the block's barriers. So 4096 =
// 16 * 16 * 16 on two blocks crosses blocks once, 8192 = 8 * 8 * 8 * 16
// on four blocks twice. The column kernels take G = 2 at 4096 and G = 4 at
// 8192, where one block's registers hold fewer than 8 columns.
//
// Shared memory: point m of a line sits in slot line_pad(m) = m + m / 16;
// the slot stride `ms` and the line's base are the caller's (rows: a line
// is contiguous, ms = 1; columns: the tile's columns interleave, ms = tc,
// so that lanes run across the columns as they do in global memory). The
// padding spreads the first pass's stride-8 and stride-16 writes over the
// banks.
// ----------------------------------------------------------------------

// A line's plan code (template parameter LINE of the kernels): log2 of the
// line's power-of-two part P, plus kMixed for a mixed line. A power-of-two
// line's code is its log2 (P = n); a mixed line's kMixed + 3 or kMixed + 4
// (P = 8 or 16, n = P m with m given to the kernel at run time).
constexpr int kMixed = 16;
__host__ __device__ constexpr int line_log2(int line) { return line & (kMixed - 1); }
__host__ __device__ constexpr bool line_mixed(int line) { return line >= kMixed; }

__host__ __device__ constexpr int line_passes(int line) {
  return line_log2(line) <= 4 ? 1 : line_log2(line) <= 8 ? 2 : line_log2(line) <= 12 ? 3 : 4;
}
// Radix of pass `pass` of the power-of-two part: 8 first, 16 for what is
// left (a mixed line's P-point lines: one radix-P pass).
__host__ __device__ constexpr int line_radix(int line, int pass) {
  return pass < 4 * line_passes(line) - line_log2(line) ? 8 : 16;
}
// Points a thread holds: the plan's largest radix.
__host__ __device__ constexpr int line_points(int line) {
  return line_radix(line, line_passes(line) - 1);
}
// Threads of a line of the power-of-two part (a mixed line has m times
// as many: one each).
__host__ __device__ constexpr int line_threads(int line) {
  return (1 << line_log2(line)) / line_points(line);
}
// Slots of one power-of-two line in the exchange buffer.
__host__ __device__ constexpr int line_pitch(int line) {
  return (1 << line_log2(line)) + (1 << line_log2(line)) / 16;
}
__device__ __forceinline__ int line_pad(int m) { return m + (m >> 4); }

// A line of the plan `LINE`: its factor m (n = P m; 1 unless mixed), and
// what follows from it. For a power-of-two line every member is a constant.
template <int LINE>
struct Line {
  int m;
  __host__ __device__ __forceinline__ int threads() const {
    return line_mixed(LINE) ? m * line_threads(LINE) : line_threads(LINE);
  }
  __host__ __device__ __forceinline__ int len() const {
    return line_mixed(LINE) ? m << line_log2(LINE) : 1 << line_log2(LINE);
  }
  // Slots of the line's exchange buffer (a mixed line: two halves of m
  // rows of P + 1, m_part's buffers).
  __host__ __device__ __forceinline__ int pitch() const {
    return line_mixed(LINE) ? 2 * (len() + m) : len() + len() / 16;
  }
};

// a * (+-i): -i forward, +i inverse.
template <bool INV>
__device__ __forceinline__ float2 mul_i(float2 a) {
  return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

// a * (c -+ i s): the root of unity (c, s) = (cos, sin), conjugated forward.
template <bool INV>
__device__ __forceinline__ float2 rot(float2 a, float c, float s) {
  const float t = INV ? s : -s;
  return make_float2(a.x * c - a.y * t, a.x * t + a.y * c);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Radix-4 butterfly in natural order.
template <bool INV>
__device__ __forceinline__ void fft4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 s02 = cadd(a0, a2), d02 = csub(a0, a2), s13 = cadd(a1, a3);
  const float2 d13 = mul_i<INV>(csub(a1, a3));
  a0 = cadd(s02, s13);
  a1 = cadd(d02, d13);
  a2 = csub(s02, s13);
  a3 = csub(d02, d13);
}

constexpr float kCos8th = 0.92387953251128674f;   // cos(pi / 8)
constexpr float kSin8th = 0.38268343236508977f;   // sin(pi / 8)
constexpr float kSqrtHalf = 0.70710678118654752f;

// Radix-R butterfly (R = 8 or 16) on u[0..R), in place, natural order out.
// R = 4 * N2: input n1 + 4 n2; N2-point transforms over n2, rotations by
// the R-th roots w^(n1 k2), radix-4 transforms over n1; output k2 + N2 k1
// ends in a[4 k2 + k1] and is put in order by renaming registers.
template <int R, bool INV>
__device__ __forceinline__ void radix(float2 (&u)[R]) {
  static_assert(R == 8 || R == 16, "radix 8 or 16");
  constexpr int N2 = R / 4;
  float2 a[R];
#pragma unroll
  for (int j = 0; j < R; ++j) a[j] = u[j];
  if constexpr (R == 8) {
#pragma unroll
    for (int n1 = 0; n1 < 4; ++n1) {
      const float2 t = a[n1];
      a[n1] = cadd(t, a[n1 + 4]);
      a[n1 + 4] = csub(t, a[n1 + 4]);
    }
    a[5] = rot<INV>(a[5], kSqrtHalf, kSqrtHalf);
    a[6] = mul_i<INV>(a[6]);
    a[7] = rot<INV>(a[7], -kSqrtHalf, kSqrtHalf);
  } else {
#pragma unroll
    for (int n1 = 0; n1 < 4; ++n1)
      fft4<INV>(a[n1], a[n1 + 4], a[n1 + 8], a[n1 + 12]);
    a[5] = rot<INV>(a[5], kCos8th, kSin8th);
    a[6] = rot<INV>(a[6], kSqrtHalf, kSqrtHalf);
    a[7] = rot<INV>(a[7], kSin8th, kCos8th);
    a[9] = rot<INV>(a[9], kSqrtHalf, kSqrtHalf);
    a[10] = mul_i<INV>(a[10]);
    a[11] = rot<INV>(a[11], -kSqrtHalf, kSqrtHalf);
    a[13] = rot<INV>(a[13], kSin8th, kCos8th);
    a[14] = rot<INV>(a[14], -kSqrtHalf, kSqrtHalf);
    a[15] = rot<INV>(a[15], -kCos8th, -kSin8th);
  }
#pragma unroll
  for (int k2 = 0; k2 < N2; ++k2)
    fft4<INV>(a[4 * k2], a[4 * k2 + 1], a[4 * k2 + 2], a[4 * k2 + 3]);
#pragma unroll
  for (int k = 0; k < R; ++k) u[k] = a[4 * (k % N2) + k / N2];
}

// Store v at the address that `at` has in the shared memory of block
// `rank` of the cluster.
__device__ __forceinline__ void store_cluster(float2* at, int rank, float2 v) {
  const unsigned local = (unsigned)__cvta_generic_to_shared(at);
  unsigned remote;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};" ::"r"(remote), "f"(v.x), "f"(v.y)
               : "memory");
}

// The barrier of an exchange: the block's where every point stays in its
// block, else the cluster's.
template <bool LOCAL>
__device__ __forceinline__ void line_barrier() {
  if (LOCAL) __syncthreads();
  else cooperative_groups::this_cluster().sync();
}

// Thread s of a line that is thread t of the line in block `rank` of G:
// the blocks take the line's threads in groups of 8 in turn.
template <int G>
__device__ __forceinline__ int line_thread(int t, int rank) {
  return (t >> 3) * (8 * G) + rank * 8 + (t & 7);
}

// One pass of line_fft: radix R, LOG2P = log2 of the product of the
// radices before it. A pass that is not the last ends with the exchange
// (write, barrier, read); a pass that is not the first has a barrier
// before its writes, so that every thread has read the exchange before.
template <int LINE, bool INV, int PASS, int LOG2P, int G = 1>
__device__ __forceinline__ void line_pass(float2 (&v)[line_points(LINE)], float2* line,
                                          int ms, int s,
                                          const float2* __restrict__ tw) {
  constexpr int N = 1 << line_log2(LINE), E = line_points(LINE), T = N / E;
  constexpr int R = line_radix(LINE, PASS), B = E / R, P = 1 << LOG2P;
  constexpr int LOG2R = R == 8 ? 3 : 4;
  constexpr bool LAST = PASS == line_passes(LINE) - 1;
  // Whether this pass's outputs all go to the block that computes them.
  constexpr bool LOCAL = G == 1 || P % (8 * G) == 0;
  if (PASS > 0 && !LAST) line_barrier<LOCAL>();
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int i = s + b * T;
    const int k = i & (P - 1);
    float2 u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) u[r] = v[b + r * B];
    if (PASS > 0) {
      // w^r, r < R, of w = tw^(k n / (p R)) from two table reads (both
      // below n / 2): w, w^2, w^3 and w^4, w^8, w^12 by products, and
      // w^(4a + b) = w^(4a) w^b.
      constexpr int TS = N / (P * R);
      float2 lo[4], hi[R / 4];
      lo[1] = __ldg(&tw[k * TS]);
      lo[2] = cmul(lo[1], lo[1]);
      lo[3] = cmul(lo[2], lo[1]);
      hi[1] = __ldg(&tw[4 * k * TS]);
      if constexpr (R == 16) {
        hi[2] = cmul(hi[1], hi[1]);
        hi[3] = cmul(hi[2], hi[1]);
      }
#pragma unroll
      for (int r = 1; r < R; ++r)
        u[r] = cmul(u[r], r < 4 ? lo[r] : r % 4 == 0 ? hi[r / 4] : cmul(hi[r / 4], lo[r % 4]));
    }
    radix<R, INV>(u);
    if (LAST) {
#pragma unroll
      for (int r = 0; r < R; ++r) v[b + r * B] = u[r];
    } else {
      const int j = ((i - k) << LOG2R) + k;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // Thread x mod T reads point x next, as the (x / T)-th of its
        // points; `reader` is its index among its block's threads.
        const int x = j + r * P;
        const int reader = ((x & (T - 1)) / (8 * G)) * 8 + (x & 7);
        float2* at = &line[line_pad(G == 1 ? x : (x / T) * (T / G) + reader) * ms];
        if (LOCAL) *at = u[r];
        else store_cluster(at, (x >> 3) & (G - 1), u[r]);
      }
    }
  }
  if (!LAST) {
    line_barrier<LOCAL>();
    const int t = G == 1 ? s : (s / (8 * G)) * 8 + (s & 7);
#pragma unroll
    for (int q = 0; q < E; ++q) v[q] = line[line_pad(q * (T / G) + t) * ms];
  }
}

// The passes of a power-of-two line, from pass PASS on.
template <int LINE, bool INV, int G, int PASS = 0, int LOG2P = 0>
__device__ __forceinline__ void line_passes_from(float2 (&v)[line_points(LINE)], float2* line,
                                                 int ms, int s,
                                                 const float2* __restrict__ tw) {
  if constexpr (PASS < line_passes(LINE)) {
    constexpr int R = line_radix(LINE, PASS);
    line_pass<LINE, INV, PASS, LOG2P, G>(v, line, ms, s, tw);
    line_passes_from<LINE, INV, G, PASS + 1, LOG2P + (R == 8 ? 3 : 4)>(
        v, line, ms, s, tw);
  }
}

// ----------------------------------------------------------------------
// The m-point part of a mixed line (n = P m, P = 1 << L = 8 or 16; see the
// note at the top). The line's m threads s < m; point j of the m-point
// line k1 in slot j (P + 1) + k1 of the buffer (slot stride ms).
// ----------------------------------------------------------------------

// A mixed line's pass table (cuda_fft.m_pass_table), after the n / 2
// twiddles of n: the number of passes, then kPlanStride ints a pass.
constexpr int kPlanStride = 8;
struct MPass {
  int r;            // radix
  int p;            // product of the radices before it
  int mr;           // m / r
  int tws;          // n / (p r): the table's stride for w_(p r)
  int nb;           // n / r: butterflies of the line
  unsigned div_p;   // multipliers of p and p r (m_div)
  unsigned div_pr;
};

__device__ __forceinline__ MPass m_pass_at(const int* __restrict__ plan, int pass) {
  const int* q = plan + 1 + pass * kPlanStride;
  return {__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3), __ldg(q + 4),
          (unsigned)__ldg(q + 5), (unsigned)__ldg(q + 6)};
}

// x / d for the x and d below 2^12 of a mixed line's passes, from d's
// multiplier ceil(2^24 / d) (exact while x (ceil(2^24 / d) d - 2^24) <
// 2^24): a multiply-high, no division on a point's path.
__device__ __forceinline__ int m_div(int x, unsigned magic) {
  return (int)__umulhi((unsigned)x << 8, magic);
}

// u[t] times w^t, 0 < t < R, each power formed just before its product,
// so that no table of powers is live: from R = 8 on from w and w4 = w^4
// read from the table, w^(4a + b) = (w^4)^a w^b as line_pass forms them;
// else by products, w^2 = w w, w^3 = w^2 w, w^4 = w^2 w^2, w^5 = w^4 w,
// w^6 = w^3 w^3.
template <int R>
__device__ __forceinline__ void m_rotate(float2 (&u)[R], float2 w, float2 w4) {
  const float2 w2 = cmul(w, w);
  u[1] = cmul(u[1], w);
  u[2] = cmul(u[2], w2);
  if constexpr (R > 3) {
    const float2 w3 = cmul(w2, w);
    u[3] = cmul(u[3], w3);
    if constexpr (R >= 8) {
      float2 hi = w4;
#pragma unroll
      for (int a = 1; 4 * a < R; ++a) {
        if (a == 2) hi = cmul(w4, w4);
        if (a == 3) hi = cmul(hi, w4);
        u[4 * a] = cmul(u[4 * a], hi);
        if (4 * a + 1 < R) u[4 * a + 1] = cmul(u[4 * a + 1], cmul(hi, w));
        if (4 * a + 2 < R) u[4 * a + 2] = cmul(u[4 * a + 2], cmul(hi, w2));
        if (4 * a + 3 < R) u[4 * a + 3] = cmul(u[4 * a + 3], cmul(hi, w3));
      }
    } else if constexpr (R > 4) {
      const float2 w4p = cmul(w2, w2);
      u[4] = cmul(u[4], w4p);
      if constexpr (R > 5) {
        u[5] = cmul(u[5], cmul(w4p, w));
        u[6] = cmul(u[6], cmul(w3, w3));
      }
    }
  }
}

// cos and sin of 2 pi j / R for the odd radices R = 3, 5, 7, 9, 15 and
// 0 <= j <= R / 2 (j = 0 where R is not a prime: u k = 0 mod R).
__host__ __device__ constexpr float odd_cos(int R, int j) {
  return j == 0 ? 1.f
         : R == 3 ? (-0.500000000f)
         : R == 5 ? (j == 1 ? 0.309016994f : -0.809016994f)
         : R == 7 ? (j == 1 ? 0.623489802f : j == 2 ? -0.222520934f : -0.900968868f)
         : R == 9 ? (j == 1 ? 0.766044443f : j == 2 ? 0.173648178f : j == 3 ? -0.500000000f :
                     -0.939692621f)
         : (j == 1 ? 0.913545458f : j == 2 ? 0.669130606f : j == 3 ? 0.309016994f :
            j == 4 ? -0.104528463f : j == 5 ? -0.500000000f : j == 6 ? -0.809016994f :
            -0.978147601f);
}
__host__ __device__ constexpr float odd_sin(int R, int j) {
  return j == 0 ? 0.f
         : R == 3 ? (0.866025404f)
         : R == 5 ? (j == 1 ? 0.951056516f : 0.587785252f)
         : R == 7 ? (j == 1 ? 0.781831482f : j == 2 ? 0.974927912f : 0.433883739f)
         : R == 9 ? (j == 1 ? 0.642787610f : j == 2 ? 0.984807753f : j == 3 ? 0.866025404f :
                     0.342020143f)
         : (j == 1 ? 0.406736643f : j == 2 ? 0.743144825f : j == 3 ? 0.951056516f :
            j == 4 ? 0.994521895f : j == 5 ? 0.866025404f : j == 6 ? 0.587785252f :
            0.207911691f);
}

// Radix-R butterfly (R = 3, 5, 7, 9, 15) on a[0..R), in place, natural
// order out: s_u = a_u + a_(R-u), d_u = a_u - a_(R-u), then outputs k and
// R - k as re +- (-+i) im, re = a_0 + sum_u s_u cos(2 pi u k / R), im =
// sum_u d_u sin(2 pi u k / R), the cosines and sines constants.
template <int R, bool INV>
__device__ __forceinline__ void odd_radix(float2 (&a)[R]) {
  constexpr int H = R / 2;
  float2 s[H + 1], d[H + 1];
#pragma unroll
  for (int u = 1; u <= H; ++u) {
    s[u] = cadd(a[u], a[R - u]);
    d[u] = csub(a[u], a[R - u]);
  }
  const float2 a0 = a[0];
#pragma unroll
  for (int u = 1; u <= H; ++u) a[0] = cadd(a[0], s[u]);
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    float2 re = a0, im = make_float2(0.f, 0.f);
#pragma unroll
    for (int u = 1; u <= H; ++u) {
      const int j = u * k % R;
      const float c = odd_cos(R, j <= H ? j : R - j);
      const float sn = j <= H ? odd_sin(R, j) : -odd_sin(R, R - j);
      re = make_float2(re.x + s[u].x * c, re.y + s[u].y * c);
      im = make_float2(im.x + d[u].x * sn, im.y + d[u].y * sn);
    }
    const float2 t = mul_i<INV>(im);
    a[k] = cadd(re, t);
    a[R - k] = csub(re, t);
  }
}

// The butterfly of radix R in natural order (3, 4, 5, 7, 8, 9, 15, 16).
template <int R, bool INV>
__device__ __forceinline__ void m_butterfly(float2 (&u)[R]) {
  if constexpr (R == 4) fft4<INV>(u[0], u[1], u[2], u[3]);
  else if constexpr (R == 8 || R == 16) radix<R, INV>(u);
  else odd_radix<R, INV>(u);
}

// One butterfly pass of radix R over the m-point lines, from the buffer
// `src` into `dst`: butterfly b = s + c m, c < ceil(P / R), of the line's
// n / R takes the line k1 = b mod P, i = b / P < m / R, k = i mod p, the
// inputs i + t m / R rotated by w_(p R)^(t k) (w from the table, w^4 too at
// 8 and 16), and writes output t to (i - k) R + k + t p. The barrier before
// it makes the last pass's writes visible and ends its reads of `dst`.
template <int L, bool INV, int R>
__device__ __forceinline__ void m_pass(const float2* src, float2* dst, int ms, int s, int m,
                                       const float2* __restrict__ tw, const MPass& mp) {
  constexpr int P = 1 << L, NB = (P + R - 1) / R;
  __syncthreads();
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    const int b = s + c * m;
    if (b < mp.nb) {
      const int k1 = b & (P - 1), i = b >> L;
      const int jj = m_div(i, mp.div_p), k = i - jj * mp.p;
      float2 u[R];
#pragma unroll
      for (int t = 0; t < R; ++t) u[t] = src[((i + t * mp.mr) * (P + 1) + k1) * ms];
      if (mp.p > 1)
        m_rotate<R>(u, __ldg(&tw[k * mp.tws]),
                    R >= 8 ? __ldg(&tw[4 * k * mp.tws]) : make_float2(0.f, 0.f));
      m_butterfly<R, INV>(u);
      const int at = (jj * mp.p * R + k) * (P + 1) + k1;
#pragma unroll
      for (int t = 0; t < R; ++t) dst[(at + t * mp.p * (P + 1)) * ms] = u[t];
    }
  }
}

// Entry `at` < n of the rotations exp(-+ 2 pi i at / n) from the table of
// n / 2 entries.
__device__ __forceinline__ float2 tw_full(const float2* __restrict__ tw, int at, int half) {
  if (at < half) return __ldg(&tw[at]);
  const float2 w = __ldg(&tw[at - half]);
  return make_float2(-w.x, -w.y);
}

// One direct pass of a prime r of 11 or more, output-driven, from `src`
// into `dst`: thread s computes the points x = s + q m, q < P, output o = x
// / P of the line k1 = x mod P (slot o (P + 1) + k1 = x + x / P), as sum_j
// x[i + j m / r] w_(p r)^(j (o mod p r)), i = (o / (p r)) p + o mod p, the
// exponent stepped mod p r and each rotation read from the table.
template <int L, bool INV>
__device__ __forceinline__ void m_pass_direct(const float2* src, float2* dst, int ms, int s,
                                              int m, const float2* __restrict__ tw,
                                              const MPass& mp) {
  constexpr int P = 1 << L;
  const int half = (m << L) >> 1, pr = mp.p * mp.r, stride = mp.mr * (P + 1) * ms;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int x = s + q * m, o = x >> L;
    const int q1 = m_div(o, mp.div_pr), e0 = o - q1 * pr;
    const int i = q1 * mp.p + e0 - m_div(e0, mp.div_p) * mp.p;
    const float2* in = src + (i * (P + 1) + (x & (P - 1))) * ms;
    float2 a = in[0];
    for (int j = 1, e = e0; j < mp.r; ++j) {
      a = cadd(a, cmul(in[j * stride], tw_full(tw, e * mp.tws, half)));
      e += e0;
      if (e >= pr) e -= pr;
    }
    dst[(x + (x >> L)) * ms] = a;
  }
}

// The m-point part of a mixed line, after the P-point butterflies: v[k1]
// of thread s, times w_n^(s k1) (m_rotate: w = tw[s], w^4 = tw[4 s], both
// below n / 2), into point s of the m-point line k1, the passes of the
// table after the twiddles, each from one half of the buffer into the
// other (n + m slots each), and the line's points s + q m back into v
// (line_fft's layout). A thread holds one butterfly at a time and v
// nothing between the rotation and the last read, so that the passes fit
// the registers of a block of 1024 threads; one barrier a pass.
template <int LINE, bool INV>
__device__ __forceinline__ void m_part(float2 (&v)[line_points(LINE)], float2* line, int ms,
                                       int s, const float2* __restrict__ tw, int m) {
  constexpr int L = line_log2(LINE), P = 1 << L;
  const int n = m << L;
  m_rotate<P>(v, __ldg(&tw[s]), __ldg(&tw[4 * s]));
#pragma unroll
  for (int k1 = 0; k1 < P; ++k1) line[(s * (P + 1) + k1) * ms] = v[k1];
  float2* src = line;
  float2* dst = line + (n + m) * ms;
  const int* plan = reinterpret_cast<const int*>(tw + n / 2);
  const int passes = __ldg(plan);
  for (int pass = 0; pass < passes; ++pass) {
    const MPass mp = m_pass_at(plan, pass);
    switch (mp.r) {
      case 3: m_pass<L, INV, 3>(src, dst, ms, s, m, tw, mp); break;
      case 4: m_pass<L, INV, 4>(src, dst, ms, s, m, tw, mp); break;
      case 5: m_pass<L, INV, 5>(src, dst, ms, s, m, tw, mp); break;
      case 7: m_pass<L, INV, 7>(src, dst, ms, s, m, tw, mp); break;
      case 9: m_pass<L, INV, 9>(src, dst, ms, s, m, tw, mp); break;
      case 15: m_pass<L, INV, 15>(src, dst, ms, s, m, tw, mp); break;
      case 8:
        if constexpr (P == 16) m_pass<L, INV, 8>(src, dst, ms, s, m, tw, mp);
        break;
      case 16:
        if constexpr (P == 16) m_pass<L, INV, 16>(src, dst, ms, s, m, tw, mp);
        break;
      default: m_pass_direct<L, INV>(src, dst, ms, s, m, tw, mp);
    }
    float2* t = src;
    src = dst;
    dst = t;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int x = s + q * m;
    v[q] = src[(x + (x >> L)) * ms];
  }
}

// FFT (INV: unnormalized inverse FFT) of a line of the plan LINE held by
// ln.threads() threads in registers: thread s brings the points s + q *
// ln.threads() in v[q] and leaves with the transform's points of the same
// indices. `line` is the line's exchange buffer in shared memory (slot
// stride ms, ln.pitch() slots), `tw` the table of the direction (of n =
// ln.len() points); with G > 1 blocks to a line, s comes from line_thread
// and `line` is the block's own buffer (ln.pitch() / G slots).
// Every thread of the block, and every block of the cluster, must call it: it
// has barriers (one to three exchanges; a mixed line one a pass over m
// and one before its last read). Threads may still be reading the
// buffer when others return: a caller that writes it again (a second
// transform, another line) puts a barrier in between.
template <int LINE, bool INV, int G = 1>
__device__ __forceinline__ void line_fft(float2 (&v)[line_points(LINE)], float2* line,
                                         int ms, int s, const float2* __restrict__ tw,
                                         Line<LINE> ln) {
  if constexpr (!line_mixed(LINE)) {
    line_passes_from<LINE, INV, G>(v, line, ms, s, tw);
  } else {
    // The P-point lines: one radix-P butterfly on the thread's registers.
    static_assert(G == 1 && line_threads(LINE) == 1,
                  "a mixed line: P-point lines of one thread, one block");
    radix<line_points(LINE), INV>(v);
    m_part<LINE, INV>(v, line, ms, s, tw, ln.m);
  }
}

// Offset in the (H, W) plane of point q of thread s of column `col`: row
// s + q H / E, line_fft's layout. The column loads and stores below take
// their offsets from it. Offset may be a 32-bit `unsigned` (a plane the
// kernels take has at most 8192^2 = 2^26 points): the MRAF kernels read and
// write up to 14 planes a point, and with 64-bit offsets the mix spilled
// (mraf_carry.cu).
template <int LINE, typename Offset = size_t>
__device__ __forceinline__ Offset col_offset(Line<LINE> ln, int q, int W, size_t col, int s) {
  return (Offset)(s + q * ln.threads()) * (Offset)W + (Offset)col;
}

// Thread (s, column c of the tile) loads its points of line_fft's layout
// from the (H, W) pair into registers.
template <int LINE>
__device__ __forceinline__ void load_col_regs(float2 (&v)[line_points(LINE)],
                                              const float* __restrict__ xr,
                                              const float* __restrict__ xi, int W,
                                              size_t col, int s, Line<LINE> ln) {
#pragma unroll
  for (int q = 0; q < line_points(LINE); ++q) {
    const size_t g = col_offset(ln, q, W, col, s);
    v[q] = make_float2(xr[g], xi[g]);
  }
}

// Store the registers back as a pair, times `scale`, in the layout of
// load_col_regs.
template <int LINE>
__device__ __forceinline__ void store_col_regs(const float2 (&v)[line_points(LINE)],
                                               float* __restrict__ yr,
                                               float* __restrict__ yi, int W,
                                               size_t col, int s, float scale, Line<LINE> ln) {
#pragma unroll
  for (int q = 0; q < line_points(LINE); ++q) {
    const size_t g = col_offset(ln, q, W, col, s);
    yr[g] = v[q].x * scale;
    yi[g] = v[q].y * scale;
  }
}

// Store the registers in polar form, (scale * |v|, arg v), in the layout
// of load_col_regs. A point that is 0 gives arg 0: the transform of zeros
// may hold -0 (a zero times a negative twiddle), and atan2f(+-0, -0) is
// +-pi, so the real part goes in as re + 0, which is +0 there and re
// elsewhere.
template <int LINE>
__device__ __forceinline__ void store_col_polar(const float2 (&v)[line_points(LINE)],
                                                float* __restrict__ amp,
                                                float* __restrict__ theta, int W,
                                                size_t col, int s, float scale, Line<LINE> ln) {
#pragma unroll
  for (int q = 0; q < line_points(LINE); ++q) {
    const size_t g = col_offset(ln, q, W, col, s);
    amp[g] = sqrtf(v[q].x * v[q].x + v[q].y * v[q].y) * scale;
    theta[g] = atan2f(v[q].y, v[q].x + 0.f);
  }
}

// A thread's place in a tile of tc adjacent columns taken by a cluster of
// G blocks: c, its column in the tile (lanes run across the tile), col, that
// column in the (H, W) pair, and s, its thread of the line (line_thread).
struct ColPlace {
  int c, s;
  size_t col;
};

template <int G>
__device__ __forceinline__ ColPlace col_place(int tc, int log2tc) {
  int rank = 0;
  if (G > 1) rank = cooperative_groups::this_cluster().block_rank();
  ColPlace p;
  p.c = threadIdx.x & (tc - 1);
  p.s = line_thread<G>(threadIdx.x >> log2tc, rank);
  p.col = (size_t)(blockIdx.x / G) * tc + p.c;
  return p;
}

// The start of a column-tile kernel: the thread's place, and its points of
// line_fft's layout loaded into v. With G > 1 every block of the cluster
// has started before any writes another's memory.
template <int LINE, int G>
__device__ __forceinline__ ColPlace col_tile_start(float2 (&v)[line_points(LINE)],
                                                       const float* __restrict__ xr,
                                                       const float* __restrict__ xi, int W,
                                                       int tc, int log2tc, Line<LINE> ln) {
  const ColPlace p = col_place<G>(tc, log2tc);
  load_col_regs<LINE>(v, xr, xi, W, p.col, p.s, ln);
  if (G > 1) cooperative_groups::this_cluster().sync();
  return p;
}

// The same start where the tile's points are the constraint w * e^{i phi}:
// every load first (phi in .x, w in .y, at load_col_regs' offsets), then
// the phasors point by point. sincosf keeps libdevice's full range
// reduction: phi is any phase a caller gives, not only one in +-pi.
template <int LINE, int G>
__device__ __forceinline__ ColPlace col_tile_start_wexp(float2 (&v)[line_points(LINE)],
                                                            const float* __restrict__ w,
                                                            const float* __restrict__ phi,
                                                            int W, int tc, int log2tc,
                                                            Line<LINE> ln) {
  const ColPlace p = col_place<G>(tc, log2tc);
  load_col_regs<LINE>(v, phi, w, W, p.col, p.s, ln);
#pragma unroll
  for (int q = 0; q < line_points(LINE); ++q) {
    float sn, cs;
    sincosf(v[q].x, &sn, &cs);
    v[q] = make_float2(v[q].y * cs, v[q].y * sn);
  }
  if (G > 1) cooperative_groups::this_cluster().sync();
  return p;
}

// A thread's place among the rows of a row kernel: a block holds
// blockDim.x / T lines of n points (T = ln.threads()), thread s of a line
// has the points s + q T at base + q T, and buf is its line's exchange
// buffer.
struct RowPlace {
  int s;
  size_t base;
  float2* buf;
};

template <int LINE>
__device__ __forceinline__ RowPlace row_place(float2* sbuf, Line<LINE> ln) {
  const int T = ln.threads();
  const int line = threadIdx.x / T;
  RowPlace p;
  p.s = threadIdx.x - line * T;
  p.base = ((size_t)blockIdx.x * (blockDim.x / T) + line) * ln.len() + p.s;
  p.buf = sbuf + line * ln.pitch();
  return p;
}

// Load and store a row thread's points (row_place) as a pair, the store
// times `scale`.
template <int LINE>
__device__ __forceinline__ void load_row_regs(float2 (&v)[line_points(LINE)],
                                              const float* __restrict__ xr,
                                              const float* __restrict__ xi, size_t base,
                                              Line<LINE> ln) {
#pragma unroll
  for (int q = 0; q < line_points(LINE); ++q) {
    const size_t g = base + q * ln.threads();
    v[q] = make_float2(xr[g], xi[g]);
  }
}

template <int LINE>
__device__ __forceinline__ void store_row_regs(const float2 (&v)[line_points(LINE)],
                                               float* __restrict__ yr,
                                               float* __restrict__ yi, size_t base,
                                               float scale, Line<LINE> ln) {
#pragma unroll
  for (int q = 0; q < line_points(LINE); ++q) {
    const size_t g = base + q * ln.threads();
    yr[g] = v[q].x * scale;
    yi[g] = v[q].y * scale;
  }
}

// Most threads a block of a row kernel on line_fft may have (its launch
// bound): kThreads up to 4096 points, one 8192-point line of 512 threads,
// and a mixed line's up to 1023 (8184 = 8 * 1023).
__host__ __device__ constexpr int rows_max_threads(int line) {
  return line_mixed(line) ? 1024 : line <= 12 ? kThreads : 512;
}
// Most threads a block of a column kernel on line_fft may have (its
// register budget).
__host__ __device__ constexpr int cols_max_threads(int line) {
  return line_mixed(line) || line >= 11 ? 1024 : 512;
}
// Columns of a tile of the column kernels on line_fft: 8, a whole 32-byte
// sector a row segment, and more for short columns, up to a warp's 32, to
// fill a block of 512 threads.
__host__ __device__ constexpr int cols_tile(int log2n) {
  const int fill = 512 / line_threads(log2n);
  return fill < 8 ? 8 : fill > 32 ? 32 : fill;
}
// Blocks that share a tile of a column kernel: as many as 8 columns'
// threads need at 1024 a block (the _cluster_kernel instantiations): two at
// 4096 points, four at 8192, else one. cols_wgs_roundtrip's note in
// wgs_carry.cu has the alternatives measured for it. A mixed line takes one.
__host__ __device__ constexpr int cols_cluster(int line) {
  return line_mixed(line) || 8 * line_threads(line) <= 1024 ? 1
                                                            : 8 * line_threads(line) / 1024;
}

// The kernels on line_fft whose launch shapes slm_fft_launch_shape reports,
// in the order of cuda_fft.LINE_KERNELS (tests/test_torch_fft_plan.py reads
// this enum and holds the two to each other).
enum LineKernel {
  kRowsFft = 0, kColsFft, kRowsNormfwd, kColsWgsRoundtrip, kCarryEntry, kCarryExit,
  kColsFwdPolar, kColsWexpInv, kColsMrafFwd, kColsMrafMixInv, kColsWgsFwd, kNumLineKernels
};

// Whether `kernel` is a column kernel (a tile of columns, launch_cols).
constexpr bool cols_kernel(int kernel) {
  return kernel == kColsFft || kernel == kColsWgsRoundtrip || kernel == kColsFwdPolar ||
         kernel == kColsWexpInv || kernel == kColsMrafFwd || kernel == kColsMrafMixInv ||
         kernel == kColsWgsFwd;
}

// What a launch of one of them on lines of 1 << log2n points is made with
// where the plane's other side is a multiple of its rows or tile.
struct LaunchShape {
  int lines;    // rows a block; columns a tile
  int cluster;  // blocks that share a tile
  int threads;  // a block
  int smem;     // bytes of dynamic shared memory a block: its padded lines
};
constexpr LaunchShape launch_shape(int kernel, int log2n) {
  const bool cols = cols_kernel(kernel);
  const int lines =
      cols ? cols_tile(log2n) : (kThreads > line_threads(log2n) ? kThreads : line_threads(log2n)) /
                                    line_threads(log2n);
  const int cluster = cols ? cols_cluster(log2n) : 1;
  return {lines, cluster, lines * line_threads(log2n) / cluster,
          lines * line_pitch(log2n) / cluster * (int)sizeof(float2)};
}

// log2 of a power of two (host side, for the launchers).
inline int ilog2(int n) {
  int k = 0;
  while ((1 << k) < n) ++k;
  return k;
}

// The plan code of a line of n points (a power of two: log2 n; any other
// length: kMixed + log2 P, n = P m, P = 8 where n has three or five
// factors of 2, else 16; cuda_fft.line_split), with m in *m; -1 for a
// length the kernels do not take (a multiple of 8 in [64, 8192]).
inline int line_code(int n, int* m) {
  if (n < 64 || n > 8192 || n % 8) return -1;
  if (n & (n - 1)) {
    int twos = 0;
    while (!((n >> twos) & 1)) ++twos;
    const int log2p = twos == 3 || twos == 5 ? 3 : 4;
    *m = n >> log2p;
    return kMixed + log2p;
  }
  *m = 1;
  return ilog2(n);
}

// The launch of `kernel` on lines of n points where the plane's other side
// (rows_fft: the rows of every plane of a stack) is `other` (0: a
// multiple of every tile): the power-of-two lines' launch_shape, with the
// rows a block or the tile narrowed to the largest power of two that
// divides `other` (at least 8: the sides are multiples of 8); a mixed
// line's (m threads a line), its rows a block (up to 8) as many as fill 128
// threads (small blocks: more of them an SM, so that one block's barriers
// overlap another's loads) and its tile (up to 32, 8 beyond 64 threads a
// line) as many as
// fill 512 threads, or 1024 for a tile of 8, and 227 KB of shared memory
// (two halves of n + m slots a line), one block a tile, with fewer where
// one line's threads fill more. lines 0: no launch.
inline LaunchShape line_launch(int kernel, int n, int other) {
  int m = 0;
  const int code = line_code(n, &m);
  if (code < 0 || kernel < 0 || kernel >= kNumLineKernels) return {0, 0, 0, 0};
  const bool cols = cols_kernel(kernel);
  LaunchShape shape{};
  if (!line_mixed(code)) {
    shape = launch_shape(kernel, code);
  } else {
    const int T = m * line_threads(code);
    int lines = cols ? 32 : 8;
    while (lines > 1 && (lines * T > (!cols ? 128 : lines <= 8 ? 1024 : 512) ||
                         lines * 2 * (n + m) * (int)sizeof(float2) > 227 * 1024))
      lines /= 2;
    shape = {lines, 1, 0, 0};
  }
  const int low = other ? other & -other : shape.lines;
  if (shape.lines > low) shape.lines = low;
  const int T = m * line_threads(code);
  shape.threads = shape.lines * T / shape.cluster;
  const int pitch = line_mixed(code) ? 2 * (n + m) : n + n / 16;
  shape.smem = shape.lines * pitch / shape.cluster * (int)sizeof(float2);
  return shape;
}

// Blocks of a launch of the column kernel `kernel` over W columns of n
// points (W / tc tiles of its cluster's blocks), which is the rows of stats
// partials a kernel with stats writes; -1 where it takes no such launch.
inline int cols_blocks(int kernel, int n, int W) {
  const LaunchShape shape = line_launch(kernel, n, W);
  if (!cols_kernel(kernel) || shape.lines == 0 || W % shape.lines) return -1;
  return W / shape.lines * shape.cluster;
}

// Each source of the line kernels builds as two objects that nvcc compiles
// in parallel (cuda_fft.build): the power-of-two plans, and with
// SLM_UNIT_MIXED=1 the two mixed plans (P = 8, 16) alone. A launcher's switch instantiates
// the unit's plan codes; its extern "C" entry is `name` in the first unit
// and `name_mixed` in the second (SLM_ENTRY), and the wrappers call the
// one of the line's length (cuda_fft._entry). Code that instantiates no
// plan (launch shapes, stats_reduce) is the first unit's only.
#ifndef SLM_UNIT_MIXED
#define SLM_UNIT_MIXED 0
#endif

// The cases of a launcher's switch on 2 * line_code(n) + inverse: one
// instantiation per plan code of the unit (power-of-two lengths 64..8192;
// the mixed lengths' two) and direction.
#define SLM_LINE_CASE(fn, line, ...)                      \
  case 2 * (line): return fn<line, false>(__VA_ARGS__);   \
  case 2 * (line) + 1: return fn<line, true>(__VA_ARGS__);
// The same on the plan code alone: one instantiation per plan code.
#define SLM_LEN_CASE(fn, line, ...) case line: return fn<line>(__VA_ARGS__);
#if SLM_UNIT_MIXED
#define SLM_ENTRY(name) name##_mixed
#define SLM_LINE_CASES(fn, ...) \
  SLM_LINE_CASE(fn, kMixed + 3, __VA_ARGS__) SLM_LINE_CASE(fn, kMixed + 4, __VA_ARGS__)
#define SLM_LEN_CASES(fn, ...) \
  SLM_LEN_CASE(fn, kMixed + 3, __VA_ARGS__) SLM_LEN_CASE(fn, kMixed + 4, __VA_ARGS__)
#else
#define SLM_ENTRY(name) name
#define SLM_LINE_CASES(fn, ...)                                          \
  SLM_LINE_CASE(fn, 6, __VA_ARGS__) SLM_LINE_CASE(fn, 7, __VA_ARGS__)    \
  SLM_LINE_CASE(fn, 8, __VA_ARGS__) SLM_LINE_CASE(fn, 9, __VA_ARGS__)    \
  SLM_LINE_CASE(fn, 10, __VA_ARGS__) SLM_LINE_CASE(fn, 11, __VA_ARGS__)  \
  SLM_LINE_CASE(fn, 12, __VA_ARGS__) SLM_LINE_CASE(fn, 13, __VA_ARGS__)
#define SLM_LEN_CASES(fn, ...)                                         \
  SLM_LEN_CASE(fn, 6, __VA_ARGS__) SLM_LEN_CASE(fn, 7, __VA_ARGS__)    \
  SLM_LEN_CASE(fn, 8, __VA_ARGS__) SLM_LEN_CASE(fn, 9, __VA_ARGS__)    \
  SLM_LEN_CASE(fn, 10, __VA_ARGS__) SLM_LEN_CASE(fn, 11, __VA_ARGS__)  \
  SLM_LEN_CASE(fn, 12, __VA_ARGS__) SLM_LEN_CASE(fn, 13, __VA_ARGS__)
#endif

// Set the instantiation's dynamic shared memory limit where a launch needs
// more than the 48 KB that needs no attribute.
template <typename... Params>
cudaError_t allow_smem(void (*kernel)(Params...), int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Launch of a row kernel on line_fft (`kind`, a LineKernel that is not a
// column kernel; `kernel` its instantiation for lines of the plan LINE and
// factor m) over H rows: H / lines blocks of line_launch's shape. The
// kernel takes m after `args`.
template <int KIND, int LINE, typename... Params, typename... Args>
int launch_rows(void (*kernel)(Params...), int H, int m, cudaStream_t stream, Args... args) {
  static_assert(!cols_kernel(KIND), "row kernel launch");
  const LaunchShape shape = line_launch(KIND, m << line_log2(LINE), H);
  if (shape.lines == 0 || H % shape.lines || shape.threads > rows_max_threads(LINE))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, shape.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<H / shape.lines, shape.threads, shape.smem, stream>>>(args..., m);
  return (int)cudaGetLastError();
}

// Launch of a column kernel on line_fft (`kind`, a LineKernel that is a
// column kernel; `kernel` its instantiation for lines of the plan LINE, the
// _cluster_kernel one where cols_cluster says more than one block) over W
// columns of `planes` stacked (H, W) planes, H = m << log2 P: W / tc tiles
// of line_launch's shape, each a cluster of G blocks, along x, and the
// planes along y (a kernel that takes a stack offsets its planes by
// plane_offset). The kernel takes (W, tc, log2tc, m) after `args`. The
// dynamic shared memory is above the 48 KB default from H = 1024 on: the
// attribute is the instantiation's own. cols_wgs_roundtrip keeps its own
// launcher (wgs_carry.cu): with its parameters in this order ptxas spilled
// 704 bytes at 2048 points, not 664, and the kernel took 0.146 ms, not
// 0.136.
template <int KIND, int LINE, typename... Params, typename... Args>
int launch_cols_planes(void (*kernel)(Params...), int W, int planes, int m, cudaStream_t stream,
                       Args... args) {
  static_assert(cols_kernel(KIND), "column kernel launch");
  const LaunchShape shape = line_launch(KIND, m << line_log2(LINE), W);
  if (shape.lines == 0 || W % shape.lines || shape.threads > cols_max_threads(LINE) ||
      shape.smem > 227 * 1024 || planes < 1 || planes > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shape.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(W / shape.lines * shape.cluster, planes);
  kernel<<<grid, shape.threads, shape.smem, stream>>>(args..., W, shape.lines,
                                                      ilog2(shape.lines), m);
  return (int)cudaGetLastError();
}

// The same over one plane (gridDim.y = 1).
template <int KIND, int LINE, typename... Params, typename... Args>
int launch_cols(void (*kernel)(Params...), int W, int m, cudaStream_t stream, Args... args) {
  return launch_cols_planes<KIND, LINE>(kernel, W, 1, m, stream, args...);
}

// Offset of plane blockIdx.y of a stack of (H, W) planes, H = ln.len(),
// for the column kernels that take a stack (launch_cols_planes). Each base
// pointer moves once by it, so the per-point offsets (col_offset) stay
// within one plane, where a 32-bit offset still holds.
template <int LINE>
__device__ __forceinline__ size_t plane_offset(int W, Line<LINE> ln) {
  return (size_t)blockIdx.y * ((size_t)W * ln.len());
}

}  // namespace slm
