#!/usr/bin/env python3
"""
Smoke run of the PyTorch / CUDA port (``slmsuite_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``
(``--parent DIR`` adds the A/B of the compressed kernels against the port
unpacked at ``DIR``, e.g. ``git archive <parent> slmsuite_torch``;
``--line-ab DIR`` runs only the builds and the A/B of the eleven line
kernels against that port's at 2048^2 and 4096^2, bit for bit, and on
five planes of mixed lines, each held to X0's limits, then X2's fused,
N1 and CG paths through either tree's kernels; ``--compressed-ab DIR``
runs only the builds and the A/B of the wide ``f2n`` and ``n2f``, past 16
Zernike terms, against that port's at 17, 21, 28, 44 and 48 terms on
config 5's plane and spots and at Z1's 97 spots at 21 terms, with each
tree's registers, spills and SASS opcode counts). It needs one
CUDA card and ``nvcc``; it fails (exit code != 0, no result line) when
there is no card or the port is missing. In order:

1. device check; 2. environment (torch, CUDA, nvcc, card, power limit);
3. build of the CUDA kernels from ``slmsuite_torch/csrc`` (one ``nvcc``
   per source, in parallel);
4. each kernel against its plain PyTorch version on the card: the carry
   kernels at 2048^2 and 256x512 for every fusable rule, scalar and array
   amplitude, stats on and off, ``carry_entry`` and ``carry_exit`` there
   also at |psi| up to 1e6, and all four (``cols_wgs_roundtrip`` and
   ``rows_normfwd`` WGS-Kim, stats on; scalar and array amplitude) at
   every shape of the ``rows_fft`` checks; ``rows_fft`` and ``cols_fft`` at every
   power-of-two side from 64 to 4096, at 64x4096, 4096x64 and 256x512,
   forward and inverse, and ``cols_fwd_polar`` and ``cols_wexp_inv`` there
   with one column all zero and the phase in +-pi and in +-1e6; the
   composed natural-path dispatchers at 2048^2 and 256x512, and the canvas
   transforms on a 2048^2 canvas holding a 1024^2 window; the two MRAF kernels at 2048^2,
   64^2, 4096^2 and 256x512, with one column of the carry all zero, for
   Leonardo and Kim, zero weights on and off, stats on and off, scalar and
   array amplitude, and the composed ``ifft2_phase``,
   ``wgs_fused_step`` and ``mraf_fused_step``; the four compressed
   kernels at BASELINE config 5's shapes (P = 1024^2, N = 256, D = 3) and
   at P = 3000, N = 17, D = 4, there also with phases up to 1e6 (past 1e5
   the kernels' sincos takes libdevice's sincosf), scalar and array
   amplitude, ``f2n`` and ``n2f`` also at 300, 600 and 12,000 spots (D =
   3) and 4,096 (D = 16), ``fused_iter`` at 9,000 spots (D = 3, past
   ``fused_spots_kernel``'s 256 spots: one launch each of ``f2n`` and
   ``n2f``), ``f2n``, ``n2f`` and ``fused_iter`` and their plain f32
   versions against the plain versions in float64, and the compressed
   dispatchers on config 5's hologram; ``cols_wgs_fwd`` and the composed
   ``wgs_fused_forward`` at 2048^2, 256x512, 64^2 and 4096^2 for every
   rule, Kim on and off, stats on and off, scalar and array amplitude,
   with one all-zero column; the five kernels that take a (B, H, W) stack
   (``carry_entry`` with a shared amplitude plane and with a scalar,
   ``cols_fwd_polar``, ``cols_wexp_inv``, ``cols_fft``, ``rows_fft``) at 8 x
   1024^2, 3 x 64^2, 3 x 256x512, 2 x 4096^2 and 3 x 2048x128: one launch
   for the stack, bit for bit B one-plane launches, and against the plain
   version (with the compiler's registers, stack and spills of each
   instantiation of the four column and entry kernels and ``rows_fft``);
   X0, each of the eleven line kernels against its plain version on 14
   planes that take each of the sides 96, 792, 1080, 1152, 1272, 1536,
   1792, 1920, 4160, 6144 and 8192 as a row side and as a column side
   (rows_fft and cols_fft both ways; the step kernels WGS-Kim with stats,
   the MRAF mix with Kim and zero weights; an output normalized near a
   zero of the field held against float64 where the plain f32 version is
   itself further off, ``conditioned``), and the five stack kernels on a
   4 x 1080x1920 stack;
   Z0, the four compressed kernels past 16 Zernike terms (D = 17, 21 and
   28, at 100 and 600 spots: the wide ``f2n`` and ``n2f``, and
   ``fused_iter`` on ``fused_spots_kernel`` and past 256 spots as ``f2n``
   then ``n2f``), scalar and array amplitude, against their plain
   versions, then a ``CompressedSpotHologram`` of 15,000 spots on a 64^2
   SLM with the cache on: past ``fused_iter_cached``'s 14,272 spots it
   runs the recomputing loop (``fused_iter`` as ``f2n`` and ``n2f``);
5. the paths, each driven with the launch counts set to 0 just before it:
   - the fused slice: ``SpotHologram.make_rectangular_array((2048, 2048),
     32x32, pitch 30, "knm")``, WGS-Kim, 50 iterations;
   - N1, the natural full-fuse geometry: the same array, WGS-Nogrette with
     ``computational_spot`` feedback and both stat groups, 50 iterations;
   - N2, BASELINE config 1 at 2x padding: a 10x10 array at pitch 60 on a
     2048^2 farfield over a 1024^2 SLM, GS then WGS-Kim, 50 iterations
     each;
   - M1, BASELINE config 3 through ``Hologram``: the 2048^2 ring target of
     ``image_mraf``, WGS-Leonardo with ``mraf_factor`` 0.5 (the MRAF carry
     loop), 50 iterations; M2, the same with WGS-Kim and ``zero_factor``
     0.1; M3, the same with GS (the natural MRAF step);
   - C1, BASELINE config 5 through ``CompressedSpotHologram`` on a 1024^2
     ``SimulatedSLM``: 16x16 3D spots, WGS-Kim, 30 iterations on the
     cached loop; C2, the same with the cache off (the recomputing loop);
     C3, C1 with a quarter of ``spot_amp`` nan (per-spot MRAF,
     ``mraf_factor`` 0.5);
   - Q1, the psi -> psi WGS step in two halves: the fused slice's array,
     20 iterations of WGS-Kim, each ``wgs_fused_forward`` then
     ``ifft2_phase``, against the same loop on the plain versions and
     against ``wgs_fused_step`` iterated;
   - S0-S2, BASELINE config 4 (``camera_loop_wgs``: a 512^2 SimulatedSLM
     and a 512^2 SimulatedCamera, Fourier calibrated analytically, a
     1024^2 hologram): the calibration checked by projecting a 5x5 grid
     and finding its spots in the camera frame; S0, ``sim_measure_spots``
     against ``set_phase`` -> ``get_image`` -> ``take``; S1, config 4's
     four spots, 5 computational iterations then 30 with
     ``feedback="experimental_spot"``; S2, a 10x10 grid at 24-pixel pitch
     on the same rig; the engine loop of each run under the profiler to
     count host transfers (none allowed);
   - H1-H3, the stepwise host loop (callbacks, host feedback and stats):
     H1, S2's rig with the camera given seeded dark and read noise and
     averaging 4 (the device measurement does not model it), 5 engine
     iterations then 20 host iterations with ``experimental_spot``
     feedback and both spot stat groups; H2, the fused slice's hologram
     through ``optimize(maxiter=50, callback=...)``, the callback recording
     the efficiency and stopping at iteration 30 (logged against the
     engine's own 30 iterations); H3, C3's hologram (64 nan ``spot_amp``),
     20 host iterations of WGS-Kim with ``zero_factor`` 0.1, then 10 with
     ``external_spot`` feedback on the amplitudes the first computed. Each
     with exact launches per host iteration and against the plain versions
     (H1 on what users read, H2 final efficiency and uniformity within
     1e-3, H3 normalized amp_ff and weights within 2e-3), then ms per host
     iteration through the kernels and the plain versions, interleaved,
     and the host transfers per iteration under the profiler (logged);
   - P1-P4, the batched multiplane slice at 8 planes (or frames) of
     1024^2: P1, ``parallel_models.multiplane_batched(8, N=1024)``,
     WGS-Kim, 50 iterations of ``run_batched_gs`` (one launch of each of
     ``carry_entry``, ``cols_fwd_polar``, ``cols_wexp_inv`` and
     ``rows_fft`` an iteration for all planes), then ms an iteration at B =
     1, 2, 4 and 8, kernels and plain in turns; P2, the same with MRAF
     (``cols_fft`` in place of ``cols_wexp_inv``); P3, a
     ``MultiplaneHologram`` of 8 ``Hologram`` children (4x4 spot arrays
     shifted per plane, a lens kernel at each of 8 depths), WGS-Kim, 30
     iterations through ``optimize`` (the batched engine), then 5 with a
     callback (the host meta loop: exact launches per iteration per
     child); P4, ``optimize_batch`` of examples/batched_holography.py's 8
     frames, WGS-Kim, 20 iterations, identical to 8 separate ``optimize``
     calls; each loop's host transfers (none allowed in the batched
     loops), every iteration's per-plane efficiency and uniformity against
     the plain versions within 1e-3;
   - Z1, the Zernike wavefront calibration on the 1024^2 rig of
     ``engine_models.zernike_calibration_rig`` (a 1024^2 SLM and camera,
     the analytic Fourier calibration, focus, astigmatism and spherical
     injected into the simulated source): ``wavefront_calibrate(method=
     "zernike")`` at 100 points asked, 21 Zernike terms, a 7-point sweep
     in [-1.5, 1.5] and 2 iterations of ``experimental_spot`` WGS-Kim,
     once through the kernels and once through the plain versions (numpy's
     global generator seeded before each): the mean correction of each
     injected term agrees within 0.1 rad, the mean spot area falls in both;
     wall time, ms of one tick (3 GS iterations on the compressed host
     loop, the phase fetched) and of one camera frame and their host
     transfers,
     launches and peak memory;
     Z2, a clone of Z1's calibrated rig (``simulate()``; ``save`` or
     ``save_calibration`` then ``load`` give the same ``kxyslm_to_ijcam``
     within 1e-9 px; without h5py, the dictionary ``save`` writes crosses
     through ``load``'s reader), on which a ``CompressedSpotHologram`` of a 10x10 grid
     in ``"ij"`` runs 10 WGS-Kim iterations with ``experimental_spot``
     feedback, then ``refine_offset()``: measured uniformity and efficiency
     within 2e-3 and the shifts within 0.05 px, kernels against plain;
     peak memory and host transfers a camera iteration;
   - Z3, a ``CompressedSpotHologram`` of a 32x32 array in the Zernike basis
     ANSI 0-20 on config 5's 1024^2 ``SimulatedSLM`` (config 5's tilt and
     focus rows, the other terms seeded in +-1.5 rad): 1,024 spots leave
     the cos/sin cache off by the port's own rule, so each of its 20
     WGS-Kim iterations (``computational_spot`` feedback and stats) runs one
     wide ``f2n`` (amplitude replacement) and one wide ``n2f`` (exact
     launches, also counted as wide); final efficiency, uniformity,
     normalized amp_ff and weights within 2e-3 of the plain run; then ms an
     iteration through the kernels and the plain versions (and the
     parent's kernels with ``--parent``); run last, after W3, so that its
     plain runs' many small launches stay out of every profiler window;
   - G1-G3, gradient phase retrieval (``method="CG"``, Adam) through the
     kernels forward and backward: G1, the fused slice's array through
     ``SpotHologram`` (lr 0.1, 50 iterations; ``rows_fft`` and ``cols_fft``
     2 each an iteration); G2, config 5's ``CompressedSpotHologram`` (lr
     0.3, 30 iterations; ``n2f`` and ``f2n`` 1 each); G3, P3's
     ``MultiplaneHologram`` (lr 0.2, 20 iterations; 8 x (2 + 2)). Each
     with exact launches in the loop and after it, against torch's own
     autograd through the plain versions on the card (the first gradient
     within 1e-4 of the largest, the loss at every iteration within 1e-3
     relative, the final efficiency and uniformity within 1e-3, G2's spot
     amplitudes within 2e-3), one host transfer an iteration (the loss),
     ms an iteration interleaved and peak device memory;
   - G4, each of the 25 optimizers the port added to those five (optax's
     names: adabelief ... yogi, ``scale_by_learning_rate`` and
     ``scale_by_rprop``) on G1's path for 10 iterations, with the
     ``optimizer_kwargs`` of ``g4_kwargs`` (printed): exact launches, the
     efficiency risen from the initial phase's (fallen for
     ``scale_by_rprop``, which optax applies uphill), final efficiency and
     uniformity within 1e-3 of torch's autograd through the plain
     versions, ms an iteration interleaved;
   - N0, the native host helpers (``slmsuite_torch/native``) built with
     the host's C compiler: ``phase2gray`` (float64 to uint8 and 12-bit
     uint16, float32 to uint8) at 1920x1152 and 4160x2464, the PLM
     electrode map and bitpack at the p67 PLM's mirror count, each bit for
     bit against its numpy path with host ms of both (the CPU model
     printed), and G1's final phase written through
     ``SimulatedSLM.set_phase``; any count of the numpy route fails it;
   - X1 and X2, planes of the sides the line kernels take since they
     take every multiple of 8 in [64, 8192]: X1, the fused slice's 32x32
     array (pitch 120) on 8192^2, ``get_padded_shape`` of a 4160x2464 SLM
     (the padded step: ``rows_fft`` 2, ``cols_fwd_polar`` and
     ``cols_wexp_inv`` 1 an iteration), 50 iterations, then ms an
     iteration and peak memory; X2, a 1920x1152 SLM at
     ``padding_order=0``, a 1152x1920 plane: WGS-Kim on the fused loop,
     N1's natural step, M1's MRAF carry on the ring cut to it, CG (20
     iterations, as G1) and a 4-plane batched multiplane stack, then a
     96x128 WGS-Kim hologram on the card against the same run on the CPU
     port (efficiency and uniformity within 1e-3, the phase's 99th
     percentile within 2e-3);
   each through the kernels (loop launches checked, launches after the
   loop counted apart; the kernels line reports both together) and
   through the plain versions (final efficiency and uniformity within
   1e-3; C1-C3: normalized amp_ff and weights within 2e-3, every launch
   of the call counted);
6. the 64^2 goldens ``wgs_kim_iter``, ``gs``, ``wgs_nogrette``,
   ``gs_padded``, ``spots_kim``, ``gs_mraf`` and ``wgs_leonardo_mraf_zero``
   replayed through the kernels;
7. timing with CUDA events: each kernel, its plain version and, where one
   PyTorch call computes the same function, that call, at 2048^2; the
   eleven kernels on the line FFT, ``cols_wgs_roundtrip``, ``rows_normfwd``
   and ``carry_entry`` (both also with an amplitude plane), ``carry_exit``,
   ``cols_wgs_fwd``, ``cols_mraf_fwd`` and ``cols_mraf_mix_inv`` (also with
   Kim and zero weights), ``rows_fft``, ``cols_fft``, ``cols_fwd_polar`` and
   ``cols_wexp_inv``, with the composed ``mraf_fused_step`` and
   ``mraf_carry_step``, at
   1024^2, 2048^2 and 4096^2 by CUDA events and by the device's own time
   under ``torch.profiler`` (their launches are about as short as the
   host's enqueue; the kernels line reports the device time and says so in
   ``timer``), with the composed ``fft2``/``ifft2`` (against
   ``torch.fft.fft2``/``ifft2``),
   ``ifft2_phase`` (with ``torch.fft.ifft2``), ``wexp_ifft2``,
   ``fft2_polar_from_phase`` and ``wexp_ifft2_phase`` beside them; the
   composed ``wgs_fused_forward`` and ``wgs_fused_step`` against their
   plain versions; each compressed
   kernel and its plain version at config 5 (with ``--parent DIR``, the
   root of a parent commit's unpacked port, each also against the
   parent's in the same process, and ``fused_iter``'s route past 256 spots
   against the parent's at 300 to 8,000 spots), and again at 21 Zernike
   terms on config 5's plane and spot count, and Z3's loop (above),
   the cos/sin cache build, and ms/iteration of the C1 and C2 loops; the
   eleven line kernels at 1152x1920 and 8192^2 with their plain versions,
   ``torch.fft`` (rows and columns) and bounds, device time from one
   profiler session a shape (``phase_mixed_timing``), and at 1152x1920
   ``fft2``, ``ifft2``, ``wexp_ifft2`` and ``ifft2_phase`` against
   ``torch.fft.fft2``/``ifft2``; the
   five stack kernels and the multiplane step's compositions
   (``fft2_polar_from_phase``, ``wexp_ifft2``, ``ifft2``) on 8 planes in
   one launch, per plane, beside one plane, the plain version and the
   library call (``torch.fft.ifft``/``ifft2``), at 1024^2 and 2048^2; and
   ms/iteration of ``spot_array_wgs(2048)`` (WGS-Kim,
   fused), ``spot_array_wgs(2048, method="WGS-Nogrette")`` (natural), the
   N2 GS loop and ``image_mraf(2048)`` (WGS-Leonardo, the MRAF carry loop;
   GS, the natural MRAF step), through the kernels and through the plain
   versions; ms/iteration of the S1 and S2 camera loops likewise;
8. ``torch.profiler`` breakdowns of the fused, the natural (WGS-Nogrette),
   the N2 GS, the ``image_mraf(2048)`` (WGS-Leonardo, the MRAF carry loop),
   M2's (WGS-Kim with zero weights), M3's (GS, the natural MRAF step), the
   C1, the C2, the S2, the P1 and the G1 loops: device
   time, device busy share, device launches per iteration (S2 also:
   the share of ``sim_measure_spots``); then X2, X1, X0 and the line
   kernels' times at 1152x1920 and 8192^2 (described under 4, 5 and 7),
   after every phase whose counts read the profiler; then D0-D3, the mesh
   engines on four shards of the one card (``[cuda:0] * 4``), each against
   the same work without a mesh, in turns: D0, ``distributed_fft2`` and
   ``distributed_ifft2`` at 8192^2 (``rows_fft`` twice a shard) against
   the ``fft2``/``ifft2`` kernels, and ``dryrun_multichip(4)``; D1, an
   8192^2 ``Hologram`` (a 32x32 spot grid), WGS-Kim, computational stats,
   rows over four, 20 iterations (``carry_entry``, ``rows_fft`` twice and
   ``carry_exit`` a shard and iteration) against the fused carry loop; D2,
   P1's 8 x 1024^2 over a data axis of four (one launch of each stack
   kernel a shard and iteration), P3's hologram through
   ``optimize(mesh=...)`` and P4's ``optimize_batch`` over four (bit for
   bit the meshless batch); D3, config 5 with its pixels over four
   (``fused_iter`` a shard and iteration) against the recomputing C2 loop.
   Each with its launches a shard, ms an iteration of mesh and meshless
   loops, peak memory, and the largest differences of psi, weights and
   stats within ``tests/test_parallel.py``'s bounds.
9. last (W1's ~5,100 frames of pageable copies leave the profiler
   missing some small copies and memsets, which the counts above rely
   on), the rig's other calibrations:
   W1, the superpixel wavefront calibration (``wavefront_calibrate()``,
   the default method) on Z1's rig as it is: 64-pixel superpixels (16 x
   16), 8 phase steps, one calibration point, the camera exposed first
   by ``autoexposure`` on the reference superpixel's spot, then
   ``wavefront_calibration_superpixel_process(apply=True)`` at its
   default smoothing; once through the kernels and once through the
   plain versions (numpy's global generator seeded before each): in each
   the corrected spot's peak above 1.1 times the uncorrected one, the two
   processed phases within 0.1 rad RMS (weighted by the measured
   amplitude, modulo a constant), the amplitudes within 2e-2; wall
   seconds, frames, ms a frame, seconds in fits and in processing,
   launches, host transfers a frame, peak memory, and the residual
   wavefront against the injected one (recorded, not gated); then the
   single-shot fringe fit (``phase_steps=1``, ``test_index``) at three
   schedule columns, the two routes' phases within 0.1 rad;
   W2, on W1's rigs: a spot hologram on the device measurement path
   optimized before and after the correction changes (its device
   constants rebuilt; the device measurement against the host image path
   each time, as S0), and ``fit_source_amplitude(force=True)`` of each
   route's measured amplitude, its centre within 1 px of the simulated
   source's;
   W3, on fresh 1024^2 rigs through both routes: ``settle_calibrate``
   (data within one count per window pixel), ``pixel_calibrate`` with its
   processing (data within 1e-3 of its largest), ``autoexposure`` (the
   same exposure within two counts at the set point), ``autofocus`` with
   the SLM on the injected focus (z within 0.01), and a
   ``write_calibration``/``read_calibration`` round trip (through pickles
   of the same names where h5py is missing);

It prints the per-kernel JSON line (``rows_fft`` and ``cols_fft`` with
their W1 launches under ``superpixel``; each kernel of D0-D3 with
``mesh``: its launches a shard on each; each line kernel with ``mixed``:
X0's largest relative error, its X1 and X2 launches and its times at
1152x1920 and 8192^2), the ``nvidia-smi``
name/power-limit line, and last ``{"ok": true, "device": {...}}``. Longer logs go to
``chiprun_out/`` (``chip_smoke.log`` keeps every line printed;
``fft_launch.log`` the launch shapes of the kernels on the line FFT, as
their launchers report them, and the compiler's registers, stack and
spills for each instantiation).
"""

import contextlib
import importlib.util
import json
import os
import platform
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

#: Acceptance tolerances, kernel against plain version on the card.
CARRY_RTOL = 1e-4          # carry and transformed planes: max |diff| / max |plain|
WEIGHT_ATOL, WEIGHT_RTOL = 1e-4, 1e-3   # weights, phasors, sums, maxs
F32_EPS = 2.0**-24          # f32 unit round-off (phasor_turn)
THETA_ATOL = 1e-3          # arg F, where |F| > 1e-3 max |F|
PSI_P99 = 2e-3             # psi: 99th percentile of the wrapped difference
PSI_MAX_ATOL = 1e-4        # psi: largest wrapped difference, no point near 0
SLICE_ATOL = 1e-3          # final efficiency / uniformity, kernel vs plain
GOLDEN_STATS_ATOL, GOLDEN_STATS_RTOL, GOLDEN_PHASE_ATOL = 1e-4, 1e-3, 5e-3
GOLDENS = ("wgs_kim_iter", "gs", "wgs_nogrette", "gs_padded", "spots_kim", "gs_mraf",
           "wgs_leonardo_mraf_zero")

#: Kernel name -> (source, the TPU kernel it replaces, the path whose
#: launches the kernels line reports).
KERNELS = {
    "carry_entry": ("wgs_carry.cu", "slmsuite_tpu/ops/pallas_fft.py:1184", "fused"),
    "cols_wgs_roundtrip": ("wgs_carry.cu", "slmsuite_tpu/ops/pallas_fft.py:797", "fused"),
    "rows_normfwd": ("wgs_carry.cu", "slmsuite_tpu/ops/pallas_fft.py:835", "fused"),
    "carry_exit": ("wgs_carry.cu", "slmsuite_tpu/ops/pallas_fft.py:1216", "fused"),
    "cols_wgs_fwd": ("wgs_carry.cu", "slmsuite_tpu/ops/pallas_fft.py:906", "Q1"),
    "rows_fft": ("natural_fft.cu", "slmsuite_tpu/ops/pallas_fft.py:373", "N2"),
    "cols_fft": ("natural_fft.cu", "slmsuite_tpu/ops/pallas_fft.py:385", "N2"),
    "cols_fwd_polar": ("natural_fft.cu", "slmsuite_tpu/ops/pallas_fft.py:559", "N1"),
    "cols_wexp_inv": ("natural_fft.cu", "slmsuite_tpu/ops/pallas_fft.py:1885", "N1"),
    "cols_mraf_fwd": ("mraf_carry.cu", "slmsuite_tpu/ops/pallas_fft.py:1619", "M1"),
    "cols_mraf_mix_inv": ("mraf_carry.cu", "slmsuite_tpu/ops/pallas_fft.py:1664", "M1"),
    "f2n": ("compressed.cu", "slmsuite_tpu/ops/pallas_compressed.py:128", "C2"),
    "n2f": ("compressed.cu", "slmsuite_tpu/ops/pallas_compressed.py:415", "C1"),
    "fused_iter": ("compressed.cu", "slmsuite_tpu/ops/pallas_compressed.py:350", "C2"),
    "fused_iter_cached": ("compressed.cu", "slmsuite_tpu/ops/pallas_compressed.py:289", "C1"),
}
RULES = ("kim", "leonardo", "wu", "tanh")
#: How the profiler names the port's kernels (the ``__global__`` functions
#: of slmsuite_torch/csrc).
PORT_KERNEL_NAMES = (
    "carry_entry_kernel", "carry_exit_kernel", "cols_fft_kernel", "cols_fft_cluster_kernel",
    "cols_fwd_polar_kernel", "cols_fwd_polar_cluster_kernel", "cols_mraf_fwd_kernel",
    "cols_mraf_fwd_cluster_kernel", "cols_mraf_mix_inv_kernel",
    "cols_mraf_mix_inv_cluster_kernel", "cols_wexp_inv_kernel", "cols_wexp_inv_cluster_kernel",
    "cols_wgs_fwd_kernel", "cols_wgs_fwd_cluster_kernel", "cols_wgs_roundtrip_kernel",
    "cols_wgs_roundtrip_cluster_kernel", "f2n_kernel", "fused_spots_kernel", "n2f_kernel",
    "roundtrip_kernel", "rows_fft_kernel", "rows_normfwd_kernel", "spot_reduce_kernel",
    "stats_reduce_kernel", "unit_norm_kernel",
)
#: Q1: iterations of the two-halves WGS-Kim loop; per-iteration efficiency
#: and uniformity, kernels against plain and against wgs_fused_step.
Q1_ITERS = 20
#: Q1's final planes, kernels against the other route: psi (99th percentile
#: of the wrapped difference), weights over their maximum, and Kim's angle
#: store on the spots.
Q1_PSI_P99, Q1_WEIGHT_ATOL, Q1_STORE_ATOL = PSI_P99, WEIGHT_RTOL, THETA_ATOL
#: BASELINE config 4 (bench.py config_4): warm-up and camera iterations.
CONFIG4_WARM, CONFIG4_ITERS = 5, 30
#: S2's spots: a 10x10 grid at 24-pixel pitch centred on the camera's centre.
S2_SIDE, S2_PITCH = 10, 24
#: H1: camera-loop iterations, frames averaged, the noise's seed.
H1_ITERS, H1_AVERAGING, H1_NOISE_SEED = 20, 4, 11
#: G1-G3, gradient phase retrieval (CG, Adam): iterations and learning
#: rates (the fused slice's array, config 5, P3's multiplane hologram).
G1_ITERS, G1_LR = 50, 0.1
G2_ITERS, G2_LR = 30, 0.3
G3_ITERS, G3_LR = 20, 0.2
#: CG, kernels against torch's own autograd through the plain versions on
#: the card: the first iteration's gradient (max |diff| over the largest
#: gradient) and the loss at every iteration (relative). Adam's first steps
#: act on each gradient's sign, so psi itself is not compared.
CG_GRAD_RTOL, CG_LOSS_RTOL = 1e-4, 1e-3
#: H2: iterations asked for, and the iteration at which the callback stops.
H2_MAXITER, H2_STOP = 50, 30
#: H3: the zero_factor MRAF host loop's iterations, then external_spot's.
H3_MRAF_ITERS, H3_EXTERNAL_ITERS = 20, 10
#: Host iterations of each host-loop timing and transfer count.
HOST_TIMING_ITERS = 10
#: The camera loops, kernels against plain: measured uniformity and
#: efficiency after the loop, and the spot weights over their maximum. The
#: display quantization and the camera's integer counts make the loop
#: discontinuous in psi, so it is held on what users read.
CAMERA_STAT_ATOL, CAMERA_WEIGHT_ATOL = 2e-3, 1e-2
#: Shapes of the MRAF parity phase; the first is the main path's. The MRAF
#: kernels' launches differ with the column length (line_fft's plan, the
#: tile, the cluster of two at 4096 points).
MRAF_SHAPES = ((2048, 2048), (64, 64), (4096, 4096), (256, 512))

#: Shapes of the parity checks of the natural path's kernels (rows_fft,
#: cols_fft, cols_fwd_polar, cols_wexp_inv): every power-of-two side the
#: kernels take, the two extreme rectangles and 256x512.
FFT_SHAPES = tuple((n, n) for n in (64, 128, 256, 512, 1024, 2048, 4096)) + (
    (256, 512), (64, 4096), (4096, 64))
#: Sizes at which the kernels on the line FFT are timed; the kernels line
#: reports the second (the main paths' plane).
FFT_TIMED_SIDES = (1024, 2048, 4096)

#: The H100 SXM's published peaks (NVIDIA data sheet, at 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

#: Compressed kernels against their plain versions: max |diff| / max
#: |plain|. The kernels form each phase by an fma chain, the plain versions
#: by a matrix product (an f32 ulp of a ~500 rad phase is ~3e-5 rad), and
#: the sums run in another order; the largest measured on an H100 is 1.2e-6.
CMP_RTOL = 1e-4
#: Compressed paths, kernels against plain: amp_ff and weights, each
#: divided by its max, as bench.py's attest_compressed_parity holds them.
CMP_PATH_ATOL = 2e-3
#: BASELINE config 5 (bench.py config_5): 16x16 spots on a 1024^2 SLM, 30
#: WGS-Kim iterations.
CONFIG5_RES, CONFIG5_SIDE, CONFIG5_ITERS = 1024, 16, 30
#: f32 operations counted for one sincos in the compressed kernels' bound:
#: a three-term Cody-Waite reduction (3 FMAs, a multiply and a round) and two
#: degree-4 polynomials (8 FMAs), an FMA counted as 2. The kernels' own
#: sincos (csrc/compressed.cu) runs the same reduction and two SFU
#: operations; the count stays, so that the yardstick does not move.
SINCOS_FLOPS = 24
#: Z0: the Zernike term counts, past the earlier kernels' 16, at which the
#: compressed kernels are held against their plain versions, and the (P, N)
#: of each: within fused_spots_kernel's 256 spots and past them.
Z0_TERMS = (17, 21, 28)
Z0_SHAPES = ((65536, 100), (16384, 600))
#: Z0: spots past fused_iter_cached's 14,272 on a Z0_SIDE^2 SLM, the cache
#: on, and the iterations of their WGS-Kim run.
Z0_SPOTS, Z0_SIDE, Z0_ITERS = 15000, 64, 3
#: Z1: the Zernike wavefront calibration on the rig of
#: engine_models.zernike_calibration_rig at Z1_SIDE^2: the points asked
#: (the JAX package's default), the Zernike terms (ANSI 0-20, through the
#: 5th radial order), the perturbation sweep and the weight iterations.
Z1_SIDE, Z1_POINTS, Z1_TERMS, Z1_WEIGHT_ITERS = 1024, 100, 21, 2
Z1_SWEEP = np.linspace(-1.5, 1.5, 7)
#: Z1, kernels against plain: the mean correction of each injected term
#: (rad), a fifth of the sweep's step.
Z1_CORRECTION_ATOL = 0.1
#: Z1: calls of the tick and of the camera frame timed (medians).
Z1_TIMING_CALLS = 5
#: Z2: the clone's 10x10 grid (camera pixels, the 0th order between its
#: points), its WGS-Kim camera iterations, and kernels against plain:
#: kxyslm_to_ijcam across save and load (px), refine_offset's shifts (px).
Z2_SIDE, Z2_PITCH, Z2_ITERS = 10, 60, 10
Z2_AFFINE_ATOL, Z2_SHIFT_ATOL = 1e-9, 0.05
#: The compressed kernels also timed at the Zernike calibration's term count.
ZERNIKE_TIMING_TERMS = 21
#: W1: the superpixel wavefront calibration on Z1's rig (1024^2): the
#: superpixel size (16 x 16 superpixels), the phase steps and the one
#: calibration point (camera pixels, (+300, -150) from the 0th order), as
#: examples/wavefront_calibration.py runs it; the camera exposed first so
#: that the reference superpixel's spot peaks at W1_EXPOSURE_FRACTION of
#: the range in its window (two superpixels in phase reach 4 times that).
W1_SUPERPIXEL, W1_STEPS = 64, 8
W1_POINT = np.array([[812.0], [362.0]])
W1_EXPOSURE_FRACTION = 0.2
#: W1, each route: the corrected spot's peak over the uncorrected one (the
#: bar of tests/hardware/test_cameraslm.py's superpixel smoke test).
W1_PEAK_GAIN = 1.1
#: W1, kernels against plain: the processed phases (RMS rad, weighted by
#: the measured amplitude, modulo a global constant), the measured
#: amplitudes (over their max), and the single-shot fringe phases of
#: W1_TEST_COLUMNS (rad).
W1_PHASE_RMS, W1_AMP_ATOL, W1_FRINGE_ATOL = 0.1, 2e-2, 0.1
W1_TEST_COLUMNS = (10, 100, 200)
#: W2: the spot hologram of the pin (camera pixels around the 0th order),
#: its shape and camera iterations, and its exposure over that of W1's peak
#: check (each of 4 spots holds a 16th of one spot's peak intensity: at 8
#: times the exposure they peak near half of the checked spot, unsaturated);
#: fit_source_amplitude's centre (px).
W2_SPOTS = np.array([[420.0, 600.0, 512.0, 470.0], [430.0, 450.0, 600.0, 560.0]])
W2_SHAPE, W2_ITERS, W2_EXPOSURE_GAIN, W2_CENTER_ATOL = (2048, 2048), 3, 8.0, 1.0
#: W3, kernels against plain: the pixel calibration's data (relative to its
#: largest), autoexposure (relative: two counts at the set point of half
#: the range), autofocus's z.
W3_PIXEL_RTOL, W3_EXPOSURE_RTOL, W3_FOCUS_ATOL = 1e-3, 2 / 128, 0.01


def log(*args):
    """Print a line, and keep it in ``chiprun_out/chip_smoke.log`` (which
    :meth:`main` empties first)."""
    print(*args, flush=True)
    with open(OUT / "chip_smoke.log", "a") as out:
        print(*args, file=out)


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("No CUDA device: chip_smoke.py needs a GPU.")
    return torch.device("cuda")


def nvidia_smi_line():
    done = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return done.stdout.strip().splitlines()[0]


def phase_environment():
    from slmsuite_torch.ops import cuda_fft

    nvcc = subprocess.run(
        [cuda_fft._nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    log(f"nvcc: {nvcc}")
    log(f"device: {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    log(f"nvidia-smi: {nvidia_smi_line()}")


def phase_build():
    from slmsuite_torch.ops import cuda_fft

    path, seconds, build_log = cuda_fft.build()
    cuda_fft._lib()
    log(f"build: {path.relative_to(ROOT)} in {seconds:.1f} s")
    if not build_log:
        return  # already built: the log of that build stays
    OUT.mkdir(exist_ok=True)
    (OUT / "ptxas.log").write_text(build_log)
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def spot_target(H, W, n=12, seed=5):
    rng = np.random.default_rng(seed)
    t = np.zeros((H, W), np.float32)
    t[rng.integers(0, H, n), rng.integers(0, W, n)] = 1.0
    return t / np.sqrt((t**2).sum())


def step_inputs(shape, amp_kind, rule, stats_on, device, seed=0):
    """Inputs of one carry step at ``shape`` (numpy seeded, then on the card)."""
    from slmsuite_torch.ops import fft

    H, W = shape
    rng = np.random.default_rng(seed)
    psi = rng.uniform(-4 * np.pi, 4 * np.pi, shape).astype(np.float32)
    target = spot_target(H, W)
    pff = rng.uniform(-np.pi, np.pi, shape).astype(np.float32)
    amp_plane = (0.5 + rng.uniform(0, 1, shape)).astype(np.float32)
    amp = 1.0 / np.sqrt(H * W) if amp_kind == "scalar" else amp_plane

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    post = 1.0 / np.sqrt(H * W) * (amp if amp_kind == "scalar" else 1.0)
    scal = fft.pack_scalars(dict(
        post=post, inv_prev_norm=0.7, apply_update=1.0,
        use_theta=float(stats_on), feedback_exponent=0.8, feedback_factor=0.2,
        inv_fnorm=1.3, inv_tsum=1.0 / float((target**2).sum()), inv_fsum=0.9,
        mraf_factor=0.4, zero_factor=0.3,
    ), device)
    kim = rule == "kim"
    # MRAF regions: signal at the spots, noise or zero at random elsewhere.
    mcode = np.where(target > 0, 1.0, np.where(rng.uniform(size=shape) < 0.5, 2.0, 0.0))
    return dict(
        psi=dev(psi), amp=amp if amp_kind == "scalar" else dev(amp),
        weights=dev(target), target=dev(target), mcode=dev(mcode.astype(np.float32)),
        zw=dev((1e-3 * rng.standard_normal((2, *shape))).astype(np.float32)),
        mask=dev((target != 0).astype(np.float32)) if stats_on else None,
        phase_ff=(dev(np.cos(pff)), dev(np.sin(pff))) if kim else None,
        scal=scal, rule=rule, kim=kim, stats_on=stats_on,
    )


def rel_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def max_abs(got, ref):
    return float((got - ref).abs().max())


def check_close(name, got, ref, atol, rtol):
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} values off, max |diff| {float(err.max()):.3e}"
        )
    return float(err.max())


def phasor_turn(amp_ff):
    """The turn that f32 round-off gives the unit phasor F/|F| of a column
    FFT of length H: an error of 2^-24 log2(H) rms|F| in F (the FFT's
    normwise error bound, rms over the column) over |F|. Negligible where
    |F| is near its rms; it grows only near a zero of F."""
    rms = amp_ff.square().mean(dim=0, keepdim=True).sqrt()
    return F32_EPS * np.log2(amp_ff.shape[0]) * rms / amp_ff


def check_phasor(name, got, ref, amp_ff):
    """Kim's unit phasor pair against the plain version's at every point:
    within WEIGHT_ATOL + WEIGHT_RTOL |ref| + phasor_turn, and of modulus 1
    within 1e-5. Returns the worst difference and the worst ratio of a
    difference to its bound."""
    turn = phasor_turn(amp_ff)
    worst, ratio = 0.0, 0.0
    for g, r in zip(got, ref):
        err = (g - r).abs()
        bound = WEIGHT_ATOL + WEIGHT_RTOL * r.abs() + turn
        bad = err > bound
        if bool(bad.any()):
            raise AssertionError(f"{name}: {int(bad.sum())} values off, max |diff| "
                                 f"{float(err.max()):.3e}, max |diff| / bound "
                                 f"{float((err / bound).max()):.3e}")
        worst, ratio = max(worst, float(err.max())), max(ratio, float((err / bound).max()))
    unit = float(((got[0] ** 2 + got[1] ** 2) - 1).abs().max())
    assert unit < 1e-5, f"{name}: |phasor| off 1 by {unit:.3e}"
    return f"max |diff| {worst:.3e}, max |diff| / bound {ratio:.3e}"


def psi_p99(got, ref):
    diff = torch.remainder(got - ref + np.pi, 2 * np.pi) - np.pi
    return float(torch.quantile(diff.abs().flatten().double(), 0.99))


def phase_parity(device):
    """Every carry kernel against its plain version; returns the 2048^2
    errors."""
    from slmsuite_torch.ops import cuda_fft, fft

    worst = dict.fromkeys(("carry_entry", "cols_wgs_roundtrip", "rows_normfwd",
                           "carry_exit"), 0.0)
    lines = []

    def carry(shape, amp_kind, psi_max=None):
        """carry_entry, then carry_exit on the plain version's carry, each
        against its plain version; psi uniform in +-psi_max where given
        (past 105615 sincosf takes its Payne-Hanek reduction). Returns the
        plain carry."""
        x = step_inputs(shape, amp_kind, "kim", True, device)
        psi = x["psi"]
        if psi_max is not None:
            rng = np.random.default_rng(9)
            psi = torch.from_numpy(
                rng.uniform(-psi_max, psi_max, shape).astype(np.float32)).to(device)
        tag = f"{shape} {amp_kind}" + (f" |psi| <= {psi_max:.0e}" if psi_max else "")
        gr, gi = cuda_fft.carry_entry(psi, x["amp"])
        pr, pi_ = fft._wgs_carry_entry(psi, x["amp"])
        e = max(rel_err(gr, pr), rel_err(gi, pi_))
        assert e <= CARRY_RTOL, f"carry_entry {tag}: {e:.3e}"
        lines.append(f"carry_entry {tag}: rel {e:.3e}")
        wrapped = wrapped_abs(cuda_fft.carry_exit(pr, pi_), fft._wgs_carry_exit(pr, pi_))
        p99 = float(torch.quantile(wrapped.flatten().double(), 0.99))
        # The exit's inverse gives back W amp e^{i psi}, with amp > 0 at
        # every point: no point is near 0, so the largest error is held
        # too, not only a percentile.
        top = float(wrapped.max())
        assert p99 < PSI_P99 and top <= PSI_MAX_ATOL, (
            f"carry_exit {tag}: p99 {p99:.3e}, max {top:.3e}")
        lines.append(f"carry_exit {tag}: p99 {p99:.3e}, max {top:.3e}")
        if psi_max is not None:
            far["carry_entry"] = max(far["carry_entry"], e)
            far["carry_exit"] = max(far["carry_exit"], p99)
        elif shape == (2048, 2048):
            worst["carry_entry"] = max(worst["carry_entry"], max_abs(gr, pr), max_abs(gi, pi_))
            worst["carry_exit"] = max(worst["carry_exit"], top)
        return pr, pi_

    far = dict(carry_entry=0.0, carry_exit=0.0)  # rel, p99 at |psi| <= 1e6

    def step(shape, amp_kind, rule, stats_on, pr, pi_):
        """cols_wgs_roundtrip, then rows_normfwd on the plain version's
        output, each against its plain version."""
        x = step_inputs(shape, amp_kind, rule, stats_on, device)
        args = (pr, pi_, x["weights"], x["target"], x["mask"], x["phase_ff"], x["scal"])
        kw = dict(rule=rule, kim=x["kim"], stats_on=stats_on)
        got = cuda_fft.cols_wgs_roundtrip(*args, **kw)
        ref = fft._cols_wgs_roundtrip(*args, **kw)
        tag = f"cols {shape} {amp_kind} {rule} stats={stats_on}"
        e = max(rel_err(got[0], ref[0]), rel_err(got[1], ref[1]))
        assert e <= CARRY_RTOL, f"{tag}/h: {e:.3e}"
        ew = check_close(tag + "/w", got[2], ref[2], WEIGHT_ATOL, WEIGHT_RTOL)
        if x["kim"]:
            amp_ff = torch.fft.fft(torch.complex(pr, pi_), dim=0).abs()
            lines.append(f"{tag}/pff: " + check_phasor(tag + "/pff", got[3], ref[3], amp_ff))
        es = check_close(tag + "/sums", got[4], ref[4], WEIGHT_ATOL, WEIGHT_RTOL)
        em = check_close(tag + "/maxs", got[5], ref[5], WEIGHT_ATOL, WEIGHT_RTOL)
        lines.append(f"{tag}: h rel {e:.3e} w {ew:.3e} sums {es:.3e} maxs {em:.3e}")
        if shape == (2048, 2048):
            worst["cols_wgs_roundtrip"] = max(
                worst["cols_wgs_roundtrip"], max_abs(got[0], ref[0]),
                max_abs(got[1], ref[1]), ew,
            )

        hr, hi = ref[0], ref[1]
        rk = cuda_fft.rows_normfwd(hr, hi, x["amp"])
        rp = fft._rows_normfwd(hr, hi, x["amp"])
        e = max(rel_err(rk[0], rp[0]), rel_err(rk[1], rp[1]))
        assert e <= CARRY_RTOL, f"rows {shape} {amp_kind} {rule}: {e:.3e}"
        lines.append(f"rows {shape} {amp_kind} {rule}: rel {e:.3e}")
        if shape == (2048, 2048):
            worst["rows_normfwd"] = max(worst["rows_normfwd"], max_abs(rk[0], rp[0]),
                                        max_abs(rk[1], rp[1]))

    for shape in ((2048, 2048), (256, 512)):
        for amp_kind in ("scalar", "array"):
            pr, pi_ = carry(shape, amp_kind)
            for rule in RULES:
                for stats_on in (True, False):
                    step(shape, amp_kind, rule, stats_on, pr, pi_)
            carry(shape, amp_kind, psi_max=1e6)
    # The line kernels' launches differ with the side (line_fft's plan, the
    # rows a block, the tile, the cluster at 4096): every side from 64 to
    # 4096 and the rectangles both ways.
    for shape in FFT_SHAPES:
        for amp_kind in ("scalar", "array"):
            step(shape, amp_kind, "kim", True, *carry(shape, amp_kind))
    torch.cuda.synchronize()
    OUT.mkdir(exist_ok=True)
    (OUT / "parity.log").write_text("\n".join(lines) + "\n")
    log(f"parity: {len(lines)} checks passed; 2048^2 max |diff| "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f"; |psi| <= 1e6: carry_entry rel {far['carry_entry']:.3e}, carry_exit p99 "
        f"{far['carry_exit']:.3e}")
    return worst


def phase_mraf_parity(device):
    """The two MRAF kernels and the MRAF/WGS compositions against their
    plain versions, the kernels with one all-zero column of the carry (F =
    0 there, and the phasor (1, 0)); returns the kernels' max |diff| at the
    first shape."""
    from slmsuite_torch.ops import cuda_fft, fft

    worst = dict.fromkeys(("cols_mraf_fwd", "cols_mraf_mix_inv"), 0.0)
    lines = []
    for shape in MRAF_SHAPES:
        for amp_kind in ("scalar", "array"):
            for rule in ("leonardo", "kim"):
                for stats_on in (True, False):
                    x = step_inputs(shape, amp_kind, rule, stats_on, device)
                    gr, gi = fft._wgs_carry_entry(x["psi"], x["amp"])
                    gr[:, 1], gi[:, 1] = 0.0, 0.0
                    fwd = (gr, gi, x["weights"] * 1.3, x["target"], x["mask"], x["scal"])
                    got = cuda_fft.cols_mraf_fwd(*fwd, rule=rule, stats_on=stats_on)
                    ref = fft._cols_mraf_fwd(*fwd, rule=rule, stats_on=stats_on)
                    tag = f"cols_mraf_fwd {shape} {amp_kind} {rule} stats={stats_on}"
                    e = max(rel_err(got[0], ref[0]), rel_err(got[1], ref[1]))
                    assert e <= CARRY_RTOL, f"{tag}/F: {e:.3e}"
                    assert float(got[0][:, 1].abs().max()) == 0.0, f"{tag}: zero column"
                    assert float(got[1][:, 1].abs().max()) == 0.0, f"{tag}: zero column"
                    ew = check_close(tag + "/uw", got[2], ref[2], WEIGHT_ATOL, WEIGHT_RTOL)
                    es = check_close(tag + "/sums", got[3], ref[3], WEIGHT_ATOL, WEIGHT_RTOL)
                    em = check_close(tag + "/maxs", got[4], ref[4], WEIGHT_ATOL, WEIGHT_RTOL)
                    lines.append(f"{tag}: F rel {e:.3e} uw {ew:.3e} sums {es:.3e} maxs {em:.3e}")
                    if shape == MRAF_SHAPES[0]:
                        worst["cols_mraf_fwd"] = max(worst["cols_mraf_fwd"], ew,
                                                     max_abs(got[0], ref[0]),
                                                     max_abs(got[1], ref[1]))
                    for zero in (True, False):
                        mix = (ref[0], ref[1], ref[2], x["mcode"], x["phase_ff"],
                               x["zw"] if zero else None, ref[3], x["scal"])
                        kw = dict(kim=x["kim"], zero=zero)
                        got_m = cuda_fft.cols_mraf_mix_inv(*mix, **kw)
                        ref_m = fft._cols_mraf_mix_inv(*mix, **kw)
                        tag_m = f"cols_mraf_mix_inv {shape} {amp_kind} {rule} zero={zero}"
                        e = max(rel_err(got_m[0], ref_m[0]), rel_err(got_m[1], ref_m[1]))
                        assert e <= CARRY_RTOL, f"{tag_m}/h: {e:.3e}"
                        if x["kim"] and stats_on:  # use_theta on: F/|F|, (1, 0) at F = 0
                            unit = (got_m[2][0][:, 1] == 1.0) & (got_m[2][1][:, 1] == 0.0)
                            assert bool(unit.all()), f"{tag_m}: zero column phasor"
                        pairs = list(zip(got_m[2], ref_m[2])) if x["kim"] else []
                        pairs += list(zip(got_m[3], ref_m[3])) if zero else []
                        ez = max([check_close(tag_m + "/pff, zw", g, r, WEIGHT_ATOL,
                                              WEIGHT_RTOL) for g, r in pairs] or [0.0])
                        lines.append(f"{tag_m} (after stats={stats_on}): h rel {e:.3e} "
                                     f"pff, zw {ez:.3e}")
                        if shape == MRAF_SHAPES[0]:
                            worst["cols_mraf_mix_inv"] = max(
                                worst["cols_mraf_mix_inv"], ez,
                                max_abs(got_m[0], ref_m[0]), max_abs(got_m[1], ref_m[1]))
            # The compositions: ifft2_phase, and the psi -> psi steps with
            # Kim's angle store.
            x = step_inputs(shape, amp_kind, "kim", True, device)
            xr, xi = random_pair(shape, device)
            e = psi_p99(fft.ifft2_phase(xr, xi), fft._ifft2_phase(xr, xi))
            assert e < PSI_P99, f"ifft2_phase {shape}: p99 {e:.3e}"
            lines.append(f"ifft2_phase {shape}: p99 {e:.3e}")
            angle = torch.atan2(x["phase_ff"][1], x["phase_ff"][0])
            args = (x["psi"], x["amp"], x["weights"] * 1.3, angle, x["target"], x["mask"])
            for name, extra in (("wgs_fused_step", ()), ("mraf_fused_step", (x["mcode"],))):
                kw = dict(rule="kim", kim=True, stats_on=True)
                got = getattr(fft, name)(*args, *extra, x["scal"], **kw)
                ref = getattr(fft, "_" + name)(*args, *extra, x["scal"], **kw)
                tag = f"{name} {shape} {amp_kind} kim"
                e = psi_p99(got[0], ref[0])
                assert e < PSI_P99, f"{tag} psi: p99 {e:.3e}"
                ew = check_close(tag + "/w", got[1], ref[1], WEIGHT_ATOL, WEIGHT_RTOL)
                amp_ff = fft._fft2_polar_from_phase(x["psi"], x["amp"])[0]
                et = theta_err(got[2], ref[2], amp_ff)
                assert et < THETA_ATOL, f"{tag} phase_ff: {et:.3e}"
                es = check_close(tag + "/sums", got[3], ref[3], WEIGHT_ATOL, WEIGHT_RTOL)
                lines.append(f"{tag}: psi p99 {e:.3e} w {ew:.3e} phase_ff {et:.3e} "
                             f"sums {es:.3e}")
    torch.cuda.synchronize()
    OUT.mkdir(exist_ok=True)
    (OUT / "parity_mraf.log").write_text("\n".join(lines) + "\n")
    log(f"MRAF parity: {len(lines)} checks passed; {MRAF_SHAPES[0]} max |diff| "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return worst


def wrapped_abs(a, b):
    return (torch.remainder(a - b + np.pi, 2 * np.pi) - np.pi).abs()


def theta_err(got, ref, amp):
    """Largest wrapped |arg difference| where |F| > 1e-3 max |F|."""
    on = amp > 1e-3 * amp.max()
    return float(wrapped_abs(got, ref)[on].max())


def theta_yardstick(device, lines, seeds=range(3, 8)):
    """What THETA_ATOL is held against: ``cols_fwd_polar``'s arg F and its
    plain version's (cuFFT), each against a float64 column FFT of the same
    2048^2 input, on several seeded inputs; and the kernel against the
    plain version with no |F| mask, where the angle of a round-off-sized
    value is arbitrary."""
    from slmsuite_torch.ops import cuda_fft, fft

    worst = dict(kernel=0.0, plain=0.0, kernel_vs_plain=0.0, unmasked=0.0)
    for seed in seeds:
        xr, xi = random_pair((2048, 2048), device, seed)
        _, th_k = cuda_fft.cols_fwd_polar(xr, xi, 1.0)
        amp_p, th_p = fft._cols_fwd_polar(xr, xi, 1.0)
        truth = torch.fft.fft(torch.complex(xr.double(), xi.double()), dim=-2)
        amp_t, th_t = truth.abs(), torch.angle(truth)
        errs = dict(kernel=theta_err(th_k.double(), th_t, amp_t),
                    plain=theta_err(th_p.double(), th_t, amp_t),
                    kernel_vs_plain=theta_err(th_k, th_p, amp_p),
                    unmasked=float(wrapped_abs(th_k, th_p).max()))
        lines.append(f"arg F yardstick seed {seed}: " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items()))
        worst = {k: max(worst[k], errs[k]) for k in worst}
    log(f"arg F yardstick, cols_fwd_polar 2048^2, seeds {seeds.start}-{seeds.stop - 1}, "
        f"where |F| > 1e-3 max |F|: kernel vs float64 {worst['kernel']:.3e}, plain vs "
        f"float64 {worst['plain']:.3e}, kernel vs plain {worst['kernel_vs_plain']:.3e} "
        f"(limit {THETA_ATOL}); kernel vs plain unmasked {worst['unmasked']:.3e} rad")
    assert worst["kernel"] < THETA_ATOL and worst["plain"] < THETA_ATOL, worst


def random_pair(shape, device, seed=3):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
                 for _ in range(2))


def phase_natural_parity(device):
    """The natural-path kernels and the composed dispatchers against their
    plain versions; returns the kernels' 2048^2 max |diff|."""
    from slmsuite_torch.ops import cuda_fft, fft, propagation

    worst = dict.fromkeys(("rows_fft", "cols_fft", "cols_fwd_polar", "cols_wexp_inv"), 0.0)
    lines = []

    def planes(tag, got, ref, kernel=None):
        e = max(rel_err(g, r) for g, r in zip(got, ref))
        assert e <= CARRY_RTOL, f"{tag}: rel {e:.3e}"
        lines.append(f"{tag}: rel {e:.3e}")
        if kernel and tag.startswith(f"{kernel} (2048, 2048)"):
            worst[kernel] = max(worst[kernel], *(max_abs(g, r) for g, r in zip(got, ref)))

    def polar(tag, got, ref, kernel=None):
        planes(tag + " |F|", got[:1], ref[:1], kernel)
        e = theta_err(got[1], ref[1], ref[0])
        assert e < THETA_ATOL, f"{tag} arg F: {e:.3e}"
        lines.append(f"{tag} arg F: max {e:.3e}")
        if kernel and tag.startswith(f"{kernel} (2048, 2048)"):
            worst[kernel] = max(worst[kernel], e)

    def phase(tag, got, ref):
        e = psi_p99(got, ref)
        assert e < PSI_P99, f"{tag}: p99 {e:.3e}"
        lines.append(f"{tag}: p99 {e:.3e}")

    rng = np.random.default_rng(5)
    for shape in FFT_SHAPES:
        xr, xi = random_pair(shape, device)
        for inverse in (False, True):
            for name in ("rows_fft", "cols_fft"):
                planes(f"{name} {shape} inverse={inverse}",
                       getattr(cuda_fft, name)(xr, xi, inverse=inverse, scale=0.5),
                       getattr(fft, "_" + name)(xr, xi, inverse=inverse, scale=0.5), name)
        # The column kernels with an epilogue, on a pair with one column
        # all zero (|F| = 0 and arg F = 0 there), the phase in +-pi and in
        # +-1e6 (past 105615 sincosf takes its Payne-Hanek reduction).
        xr[:, 1], xi[:, 1] = 0.0, 0.0
        got = cuda_fft.cols_fwd_polar(xr, xi, 0.25)
        polar(f"cols_fwd_polar {shape}", got, fft._cols_fwd_polar(xr, xi, 0.25),
              "cols_fwd_polar")
        zero = max(float(x[:, 1].abs().max()) for x in got)
        assert zero == 0.0, f"cols_fwd_polar {shape}: {zero} on the zero column"
        w = xr.abs()
        for phase_max in (np.pi, 1e6):
            phi = torch.from_numpy(
                rng.uniform(-phase_max, phase_max, shape).astype(np.float32)).to(device)
            got = cuda_fft.cols_wexp_inv(w, phi)
            planes(f"cols_wexp_inv {shape} phase +-{phase_max:g}", got,
                   fft._cols_wexp_inv(w, phi), "cols_wexp_inv")
            zero = max(float(x[:, 1].abs().max()) for x in got)
            assert zero == 0.0, f"cols_wexp_inv {shape}: {zero} on the zero column"
        del xr, xi, w, phi, got
    fft_checks = len(lines)
    for shape in ((2048, 2048), (256, 512)):
        xr, xi = random_pair(shape, device)
        w = xr.abs()
        for amp_kind in ("scalar", "array"):
            x = step_inputs(shape, amp_kind, "kim", True, device)
            polar(f"fft2_polar_from_phase {shape} {amp_kind}",
                  fft.fft2_polar_from_phase(x["psi"], x["amp"]),
                  fft._fft2_polar_from_phase(x["psi"], x["amp"]))
        amp_ff, theta = fft._fft2_polar_from_phase(x["psi"], x["amp"])
        phase(f"wexp_ifft2_phase {shape}", fft.wexp_ifft2_phase(w, theta),
              fft._wexp_ifft2_phase(w, theta))
        planes(f"wexp_ifft2 {shape}", fft.wexp_ifft2(w, theta), fft._wexp_ifft2(w, theta))

    # A 2048^2 canvas holding a 1024^2 window, as in the padded loop.
    rng = np.random.default_rng(4)
    window = torch.from_numpy(rng.uniform(-np.pi, np.pi, (1024, 1024)).astype(np.float32))
    for amp_kind in ("scalar", "array"):
        amp = (1.0 / 1024 if amp_kind == "scalar" else
               torch.from_numpy(rng.uniform(0.5, 1, (1024, 1024)).astype(np.float32)).to(device))
        nr, ni = propagation.build_folded_nearfield(window.to(device), amp, (2048, 2048))
        tag = f"canvas 2048^2 / 1024^2 {amp_kind}"
        planes(f"fft2 {tag}", fft.fft2(nr, ni), fft._fft2(nr, ni))
        polar(f"fft2_polar {tag}", fft.fft2_polar(nr, ni), fft._fft2_polar(nr, ni))
        fr, fi = fft._fft2(nr, ni)
        planes(f"ifft2 {tag}", fft.ifft2(fr, fi), fft._ifft2(fr, fi))
        amp_c, theta_c = fft._fft2_polar(nr, ni)
        planes(f"wexp_ifft2 {tag}", fft.wexp_ifft2(amp_c, theta_c),
               fft._wexp_ifft2(amp_c, theta_c))
    theta_yardstick(device, lines)
    torch.cuda.synchronize()
    OUT.mkdir(exist_ok=True)
    (OUT / "parity_natural.log").write_text("\n".join(lines) + "\n")
    log(f"natural parity: {len(lines)} checks passed ({fft_checks} of rows_fft, cols_fft, "
        f"cols_fwd_polar and cols_wexp_inv at {len(FFT_SHAPES)} shapes); 2048^2 max |diff| "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return worst


def cuda_ms(fn, n=20, warmup=3):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


class NoDeviceEvents(RuntimeError):
    """``torch.profiler`` recorded no device event."""


def device_spans(fn, n):
    """Durations in us of the device events (kernels, copies, memsets)
    of ``n`` calls of ``fn`` under ``torch.profiler``: the events whose
    midpoint lies in a ``record_function`` range around the calls and a
    synchronize, with one call before the range and one after it. A window
    may lose one device event at its edge (at 4096^2 every window lost
    exactly one): the calls outside the range take that loss."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        with record_function("device_spans window"):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    window = [e.time_range for e in events
              if e.name == "device_spans window" and e.device_type == DeviceType.CPU]
    if not window:
        return []
    lo, hi = window[0].start, window[0].end
    return [e.time_range.elapsed_us() for e in events
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and lo <= (e.time_range.start + e.time_range.end) / 2 <= hi]


def device_ms(fn, n=20):
    """Device milliseconds per call of ``fn``: the device events' own
    durations under ``torch.profiler`` (:meth:`device_spans`), summed,
    over ``n`` calls. Unlike :meth:`cuda_ms` it leaves out the gaps in
    which the device waits for the host, which at 1024^2 are longer than
    the kernels. The profiler now and then records only part of a window's
    events, which reads short: a window counts only where it holds ``n``
    times the events of one call. Raises :class:`NoDeviceEvents` where
    three tries give no such window."""
    fn()
    for _ in range(3):
        one = device_spans(fn, 1)
        spans = device_spans(fn, n)
        if one and len(spans) == len(one) * n:
            return sum(spans) / 1e3 / n
        log(f"  device_ms: {len(spans)} device events for {n} calls of {len(one)}; again")
    raise NoDeviceEvents("torch.profiler recorded no whole window of device events in three "
                         "tries")


def bound(shape, planes_moved, line_ffts):
    """``(bound_ms, bound_by)`` of an (n, n) kernel: the larger of the
    bytes moved (each input plane read once, each output written once)
    over the HBM rate and the FFT flops (5 n log2 n per line, n lines per
    pass, ``line_ffts`` passes) over the f32 peak."""
    H, W = shape
    assert H == W, shape
    return bound_lines(shape, planes_moved, H, line_ffts)


def interleaved(name, kernel, plain, library=None, bound_of=None, size="2048^2",
                timer=cuda_ms):
    """Time ``kernel`` and ``plain`` in turns (plain, kernel, kernel,
    plain) and ``library`` once between them, with ``timer``
    (:meth:`cuda_ms`, or :meth:`device_ms` for launches so short that the
    host's enqueue sets the pace of CUDA events); log and return
    ``{kernel, plain, library, bound, bound_by}`` in ms and ``timer``,
    ``"events"`` or ``"device"``: which of the two every time of the entry
    is. Where the profiler gives :meth:`device_ms` nothing, all of them are
    taken again with CUDA events."""
    try:
        p1 = timer(plain)
        k1 = timer(kernel)
        lib = timer(library) if library is not None else None
        k2 = timer(kernel)
        p2 = timer(plain)
    except NoDeviceEvents as err:
        log(f"  {name} {size}: {err}; CUDA events instead")
        return interleaved(name, kernel, plain, library, bound_of, size)
    timed_by = "device" if timer is device_ms else "events"
    bound_ms, bound_by = bound_of if bound_of is not None else (None, None)
    log(f"time {name} {size} ({timed_by}): kernel {k1:.4f} {k2:.4f} ms, plain {p1:.4f} "
        f"{p2:.4f} ms" + (f", library {lib:.4f} ms" if lib is not None else "")
        + (f", bound {bound_ms:.4f} ms ({bound_by})" if bound_ms is not None else ""))
    return dict(kernel=(k1 + k2) / 2, plain=(p1 + p2) / 2, library=lib,
                bound=bound_ms, bound_by=bound_by, timer=timed_by)


def phase_fft_timing(device):
    """The natural path's kernels at each of FFT_TIMED_SIDES, each with
    its plain version and its bound, by CUDA events and by the device's own
    time (:meth:`device_ms`): ``rows_fft`` and ``cols_fft`` with their
    library call (``torch.fft.fft`` along the same axis), and beside
    ``cols_fft`` the two column kernels that move the same four planes,
    ``cols_fwd_polar`` and ``cols_wexp_inv`` (no library call); then the
    composed transforms' device time. Returns the four kernels' 2048^2
    device times for the kernels line."""
    from slmsuite_torch.ops import cuda_fft, fft

    t = {}
    for side in FFT_TIMED_SIDES:
        shape, size = (side, side), f"{side}^2"
        xr, xi = random_pair(shape, device)
        z = torch.complex(xr, xi)
        w, phi = xr.abs(), xi * np.pi
        timed = {
            "rows_fft": (lambda: cuda_fft.rows_fft(xr, xi, inverse=False),
                         lambda: fft._rows_fft(xr, xi, inverse=False),
                         lambda: torch.fft.fft(z, dim=-1), bound(shape, 4, 1)),
            "cols_fft": (lambda: cuda_fft.cols_fft(xr, xi, inverse=False),
                         lambda: fft._cols_fft(xr, xi, inverse=False),
                         lambda: torch.fft.fft(z, dim=0), bound(shape, 4, 1)),
            "cols_fwd_polar": (lambda: cuda_fft.cols_fwd_polar(xr, xi, 1.0),
                               lambda: fft._cols_fwd_polar(xr, xi, 1.0), None,
                               bound(shape, 4, 1)),
            "cols_wexp_inv": (lambda: cuda_fft.cols_wexp_inv(w, phi),
                              lambda: fft._cols_wexp_inv(w, phi), None, bound(shape, 4, 1)),
        }
        for name, (kernel, plain, library, bound_of) in timed.items():
            interleaved(name, kernel, plain, library, bound_of, size)
            # The device's own time: these launches are shorter than the
            # host takes to enqueue them.
            by_device = interleaved(name, kernel, plain, library, bound_of, size,
                                    timer=device_ms)
            log(f"  {name} {size}: {by_device['bound'] / by_device['kernel']:.3f} of its "
                f"bound" + (f", {by_device['kernel'] / by_device['library']:.3f} of its "
                            "library call" if library is not None else "")
                + f" ({by_device['timer']})")
            if side == 2048:
                t[name] = by_device
        # The composed transforms (two launches each) against torch.fft.
        interleaved("fft2 (rows_fft + cols_fft)", lambda: cuda_fft.fft2(xr, xi),
                    lambda: fft._fft2(xr, xi), library=lambda: torch.fft.fft2(z, norm="ortho"),
                    bound_of=bound(shape, 8, 2), size=size, timer=device_ms)
        interleaved("ifft2 (cols_fft + rows_fft)", lambda: cuda_fft.ifft2(xr, xi),
                    lambda: fft._ifft2(xr, xi), library=lambda: torch.fft.ifft2(z, norm="ortho"),
                    bound_of=bound(shape, 8, 2), size=size, timer=device_ms)
        interleaved("ifft2_phase (cols_fft + carry_exit)",
                    lambda: cuda_fft.ifft2_phase(xr, xi), lambda: fft._ifft2_phase(xr, xi),
                    library=lambda: torch.fft.ifft2(z, norm="ortho"),
                    bound_of=bound(shape, 3, 2), size=size, timer=device_ms)
        # The padded loop's backward half: w and phi in, the pair out.
        interleaved("wexp_ifft2 (cols_wexp_inv + rows_fft)",
                    lambda: cuda_fft.wexp_ifft2(w, phi), lambda: fft._wexp_ifft2(w, phi),
                    bound_of=bound(shape, 4, 2), size=size, timer=device_ms)
        # The natural step's two halves where the farfield is the SLM plane.
        interleaved("fft2_polar_from_phase (carry_entry + cols_fwd_polar)",
                    lambda: cuda_fft.fft2_polar_from_phase(phi, 1.0),
                    lambda: fft._fft2_polar_from_phase(phi, 1.0),
                    bound_of=bound(shape, 3, 2), size=size, timer=device_ms)
        interleaved("wexp_ifft2_phase (cols_wexp_inv + carry_exit)",
                    lambda: cuda_fft.wexp_ifft2_phase(w, phi),
                    lambda: fft._wexp_ifft2_phase(w, phi),
                    bound_of=bound(shape, 3, 2), size=size, timer=device_ms)
        del xr, xi, z, w, phi, timed
    log(f"  [{nvidia_smi_line()}]")

    return t


def write_launch_log():
    """``fft_launch.log``: the launch shapes of the kernels on the line FFT
    as their launchers report them, and the compiler's line (registers,
    stack, spills) for each of their instantiations."""
    from slmsuite_torch.ops import cuda_fft

    lines = []
    for kernel in cuda_fft.LINE_KERNELS:
        for n in (64, 128, 256, 512, 1024, 2048, 4096, 8192) + X0_SIDES[:-1]:
            lines_a_block, blocks, threads, smem = cuda_fft.fft_launch_shape(kernel, n)
            what = "columns a tile" if kernel.startswith("cols") else "rows a block"
            lines.append(f"{kernel} n={n}: plan {cuda_fft.fft_plan(n)}, {lines_a_block} "
                         f"{what}, {blocks} block(s) a tile, {threads} threads and {smem} "
                         "bytes of shared memory a block")
    ptxas = (OUT / "ptxas.log").read_text().splitlines() if (OUT / "ptxas.log").exists() else []
    names = ("rows_fft_kernel", "cols_fft_", "rows_normfwd_kernel", "cols_wgs_roundtrip_",
             "carry_entry_kernel", "carry_exit_kernel", "cols_fwd_polar_", "cols_wexp_inv_",
             "cols_mraf_fwd_", "cols_mraf_mix_inv_", "cols_wgs_fwd_")
    for k, line in enumerate(ptxas):
        if "Compiling entry function" in line and any(name in line for name in names):
            lines.append(" ".join(x.strip() for x in ptxas[k:k + 4]))
    (OUT / "fft_launch.log").write_text("\n".join(lines) + "\n")


def phase_carry_timing(device):
    """``cols_wgs_roundtrip`` (WGS-Kim, stats on, scalar amp),
    ``rows_normfwd`` and ``carry_entry`` (scalar amp, and an amplitude
    plane), ``carry_exit``, ``cols_wgs_fwd`` (WGS-Kim, stats on), the MRAF
    kernels at M1's variant
    (``cols_mraf_fwd``: WGS-Leonardo, stats on; ``cols_mraf_mix_inv``: no
    Kim, no zero weights) with the mix's largest (Kim with the stored
    phasor read, zero weights), and the MRAF step compositions
    (``mraf_fused_step``, WGS-Kim with stats; ``mraf_carry_step``, M1's)
    at each of FFT_TIMED_SIDES, each with its plain version and its bound,
    by CUDA events and by the device's own time (:meth:`device_ms`). None
    has a library call. Returns the kernels' 2048^2 device times for the
    kernels line."""
    from slmsuite_torch.ops import cuda_fft, fft

    t = {}
    kw = dict(rule="kim", kim=True, stats_on=True)
    for side in FFT_TIMED_SIDES:
        shape, size = (side, side), f"{side}^2"
        x = step_inputs(shape, "scalar", "kim", True, device)
        gr, gi = fft._wgs_carry_entry(x["psi"], x["amp"])
        amp = random_pair(shape, device)[0].abs() + 0.5
        cols = (gr, gi, x["weights"], x["target"], x["mask"], x["phase_ff"], x["scal"])
        m = step_inputs(shape, "scalar", "leonardo", True, device)
        fwd = (gr, gi, m["weights"], m["target"], m["mask"], m["scal"])
        fr, fi, uw, sums, _ = fft._cols_mraf_fwd(*fwd, rule="leonardo", stats_on=True)
        mix = (fr, fi, uw, m["mcode"], None, None, sums, m["scal"])
        # use_theta off (no stats): Kim's stored phasor is read.
        k = step_inputs(shape, "scalar", "kim", False, device)
        mix_kim = (fr, fi, uw, m["mcode"], k["phase_ff"], m["zw"], sums, k["scal"])
        angle = torch.atan2(x["phase_ff"][1], x["phase_ff"][0])
        fused = (x["psi"], x["amp"], x["weights"], angle, x["target"], x["mask"], m["mcode"],
                 x["scal"])
        step = (gr, gi, m["amp"], m["weights"], None, m["target"], m["mask"], m["mcode"], None,
                m["scal"])
        step_kw = dict(rule="leonardo", kim=False, stats_on=True, zero=False)
        fwd_kim = (gr, gi, x["weights"], x["target"], x["mask"], angle, x["scal"])
        timed = {
            # gr, gi, w, t and mask read, hr, hi, w' and the phasor pair
            # written: ten planes (use_theta is on with stats, so the stored
            # phasor is not read).
            "cols_wgs_roundtrip": (lambda: cuda_fft.cols_wgs_roundtrip(*cols, **kw),
                                   lambda: fft._cols_wgs_roundtrip(*cols, **kw),
                                   bound(shape, 10, 2)),
            "rows_normfwd": (lambda: cuda_fft.rows_normfwd(gr, gi, x["amp"]),
                             lambda: fft._rows_normfwd(gr, gi, x["amp"]), bound(shape, 4, 2)),
            "rows_normfwd (amplitude plane)": (lambda: cuda_fft.rows_normfwd(gr, gi, amp),
                                               lambda: fft._rows_normfwd(gr, gi, amp),
                                               bound(shape, 5, 2)),
            # psi read, the pair written (an amplitude plane read too).
            "carry_entry": (lambda: cuda_fft.carry_entry(x["psi"], x["amp"]),
                            lambda: fft._wgs_carry_entry(x["psi"], x["amp"]),
                            bound(shape, 3, 1)),
            "carry_entry (amplitude plane)": (lambda: cuda_fft.carry_entry(x["psi"], amp),
                                              lambda: fft._wgs_carry_entry(x["psi"], amp),
                                              bound(shape, 4, 1)),
            # The pair read, psi written.
            "carry_exit": (lambda: cuda_fft.carry_exit(gr, gi),
                           lambda: fft._wgs_carry_exit(gr, gi), bound(shape, 3, 1)),
            # Row 7: gr, gi, w, t and mask read (use_theta is on, so the
            # angle store is not read), re, im, w' and the store written.
            "cols_wgs_fwd": (lambda: cuda_fft.cols_wgs_fwd(*fwd_kim, **kw),
                             lambda: fft._cols_wgs_fwd(*fwd_kim, **kw), bound(shape, 9, 1)),
            # gr, gi, w, t and mask read, fr, fi and uw written.
            "cols_mraf_fwd": (
                lambda: cuda_fft.cols_mraf_fwd(*fwd, rule="leonardo", stats_on=True),
                lambda: fft._cols_mraf_fwd(*fwd, rule="leonardo", stats_on=True),
                bound(shape, 8, 1)),
            # fr, fi, uw and mcode read, hr and hi written.
            "cols_mraf_mix_inv": (
                lambda: cuda_fft.cols_mraf_mix_inv(*mix, kim=False, zero=False),
                lambda: fft._cols_mraf_mix_inv(*mix, kim=False, zero=False),
                bound(shape, 6, 1)),
            # And the stored phasor pair and the zero weights read and written.
            "cols_mraf_mix_inv (Kim, zero weights)": (
                lambda: cuda_fft.cols_mraf_mix_inv(*mix_kim, kim=True, zero=True),
                lambda: fft._cols_mraf_mix_inv(*mix_kim, kim=True, zero=True),
                bound(shape, 14, 1)),
            # Row 9: psi, w, the angle store, t, mask and mcode read, psi, w
            # and the store written.
            "mraf_fused_step (carry_entry + cols_mraf_fwd + cols_mraf_mix_inv + carry_exit)": (
                lambda: cuda_fft.mraf_fused_step(*fused, rule="kim", kim=True, stats_on=True),
                lambda: fft._mraf_fused_step(*fused, rule="kim", kim=True, stats_on=True),
                bound(shape, 9, 4)),
            # Row 10 at M1's variant: gr, gi, w, t, mask and mcode read, the
            # carry and uw written.
            "mraf_carry_step (cols_mraf_fwd + cols_mraf_mix_inv + rows_normfwd)": (
                lambda: cuda_fft.mraf_carry_step(*step, **step_kw),
                lambda: fft._mraf_carry_step(*step, **step_kw), bound(shape, 9, 4)),
        }
        for name, (kernel, plain, bound_of) in timed.items():
            interleaved(name, kernel, plain, bound_of=bound_of, size=size)
            by_device = interleaved(name, kernel, plain, bound_of=bound_of, size=size,
                                    timer=device_ms)
            log(f"  {name} {size}: {by_device['bound'] / by_device['kernel']:.3f} of its "
                f"bound ({by_device['timer']})")
            if side == 2048 and name in KERNELS:
                t[name] = by_device
        del x, gr, gi, amp, cols, m, fwd, fr, fi, uw, sums, mix, k, mix_kim, angle, fused
        del step, fwd_kim, timed
    log(f"  [{nvidia_smi_line()}]")
    return t


def phase_kernel_timing(device):
    """Each kernel and its plain version at 2048^2 (carry kernels:
    WGS-Kim, scalar amp, stats on), and the library calls; the kernels on
    the line FFT at each of FFT_TIMED_SIDES too (:meth:`phase_carry_timing`,
    :meth:`phase_fft_timing`)."""
    from slmsuite_torch.ops import cuda_fft, fft

    shape = (2048, 2048)
    x = step_inputs(shape, "scalar", "kim", True, device)
    angle = torch.atan2(x["phase_ff"][1], x["phase_ff"][0])
    t = phase_carry_timing(device)
    t.update(phase_fft_timing(device))
    write_launch_log()

    # The compositions: the forward half and the psi -> psi WGS step
    # (WGS-Kim, stats on); the MRAF ones are phase_carry_timing's.
    args = (x["psi"], x["amp"], x["weights"], angle, x["target"], x["mask"])
    kw = dict(rule="kim", kim=True, stats_on=True)
    interleaved("wgs_fused_forward (carry_entry + cols_wgs_fwd)",
                lambda: cuda_fft.wgs_fused_forward(*args, x["scal"], **kw),
                lambda: fft._wgs_fused_forward(*args, x["scal"], **kw),
                bound_of=bound(shape, 9, 2), timer=device_ms)
    interleaved("wgs_fused_step (carry_entry + cols_wgs_roundtrip + carry_exit)",
                lambda: cuda_fft.wgs_fused_step(*args, x["scal"], **kw),
                lambda: fft._wgs_fused_step(*args, x["scal"], **kw), bound_of=bound(shape, 8, 4))
    return t


#: The dispatchers that the plain runs swap for their plain versions.
DISPATCHERS = ("wgs_carry_entry", "wgs_carry_step", "wgs_carry_exit", "mraf_carry_step",
               "fft2", "ifft2", "ifft2_phase", "fft2_polar", "fft2_polar_from_phase",
               "wexp_ifft2", "wexp_ifft2_phase")


@contextlib.contextmanager
def plain_versions(module, names):
    """Route ``module``'s dispatchers ``names`` to their plain PyTorch
    versions (``_`` + name) for the duration."""
    saved = {name: getattr(module, name) for name in names}
    for name in names:
        setattr(module, name, getattr(module, "_" + name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def plain_step_functions():
    """The engine's and the propagation's transforms, plain."""
    from slmsuite_torch.ops import fft

    return plain_versions(fft, DISPATCHERS)


def spot_array(device, array_shape, array_pitch, slm_shape=None, seed=0,
               shape=(2048, 2048)):
    """SpotHologram.make_rectangular_array on a ``shape`` farfield (over a
    ``slm_shape`` SLM where given, else unpadded), from a seeded phase."""
    from slmsuite_torch.holography.algorithms import SpotHologram

    kwargs = {} if slm_shape is None else dict(slm_shape=slm_shape)
    holo = SpotHologram.make_rectangular_array(
        shape, array_shape=array_shape, array_pitch=array_pitch, basis="knm",
        device=device, **kwargs,
    )
    rng = np.random.default_rng(seed)
    holo.reset_phase(custom_phase=rng.uniform(-np.pi, np.pi, holo.slm_shape))
    return holo


def image_hologram(device, shape=(2048, 2048)):
    """``Hologram`` on the ``image_mraf`` ring target (nan noise region),
    cut to ``shape`` from the square of its larger side, from a seeded
    phase."""
    from slmsuite_torch.holography.algorithms import Hologram
    from slmsuite_torch.models.engine_models import image_mraf_target

    H, W = shape
    side = max(H, W)
    target = image_mraf_target(side)[(side - H) // 2:(side + H) // 2,
                                     (side - W) // 2:(side + W) // 2]
    holo = Hologram(target=np.ascontiguousarray(target), device=device)
    rng = np.random.default_rng(0)
    holo.reset_phase(custom_phase=rng.uniform(-np.pi, np.pi, shape))
    return holo


def launches_split_at_populate(holo):
    """Set the launch counts to 0 and have ``holo`` note them when its
    ``_populate_results`` starts, which is where an ``optimize`` call's
    loop ends. Returns a function giving ``(loop launches, launches after
    the loop)``."""
    from slmsuite_torch.ops import cuda_fft

    populate = holo._populate_results
    at_populate = {}

    def counted_populate():
        at_populate.update(cuda_fft.LAUNCHES)
        populate()

    def split():
        after = {k: v - at_populate[k] for k, v in cuda_fft.LAUNCHES.items()
                 if v - at_populate[k]}
        return {k: v for k, v in at_populate.items() if v}, after

    holo._populate_results = counted_populate
    cuda_fft.reset_launch_counts()
    return split


def drive(make, optimize):
    """Run ``optimize(holo)`` on a fresh ``make()`` with the launch counts
    set to 0 just before it. Returns ``(holo, final computational
    efficiency and uniformity, loop launches, launches after the loop)``:
    the counts are read when ``_populate_results`` starts."""
    holo = make()
    split = launches_split_at_populate(holo)
    optimize(holo)
    torch.cuda.synchronize()
    loop, after = split()
    stats = holo.stats["stats"]["computational"]
    return holo, {k: float(stats[k][-1]) for k in ("efficiency", "uniformity")}, loop, after


def run_path(label, make, optimize, expect):
    """One path through the kernels (loop launches must equal ``expect``)
    and through the plain versions (no launch; final efficiency and
    uniformity within SLICE_ATOL). Returns the path's launches, in the
    loop and after it."""
    from slmsuite_torch.ops import cuda_fft

    start = time.perf_counter()
    holo, kernel_stats, loop, after = drive(make, optimize)
    seconds = time.perf_counter() - start
    log(f"{label} (kernels): {kernel_stats} in {seconds:.2f} s; loop launches {loop}; "
        f"after the loop {after}")
    assert loop == expect, (label, loop, expect)
    phase = holo.get_phase()
    assert phase.shape == tuple(holo.slm_shape) and np.isfinite(phase).all()
    for key, value in kernel_stats.items():
        assert np.isfinite(value) and 0 < value <= 1, (label, key, value)
    with plain_step_functions():
        _, plain_stats, plain_loop, plain_after = drive(make, optimize)
    assert not plain_loop and not plain_after, (plain_loop, plain_after)
    log(f"{label} (plain):   {plain_stats}")
    for key in kernel_stats:
        diff = abs(kernel_stats[key] - plain_stats[key])
        assert diff <= SLICE_ATOL, f"{label} {key}: kernel vs plain differ by {diff:.3e}"
    return {k: loop.get(k, 0) + after.get(k, 0) for k in {*loop, *after}}


def phase_paths(device):
    """The fused slice, N1 and N2; returns each path's loop launches."""
    n = 50
    fused = run_path(
        "fused slice WGS-Kim 2048^2",
        lambda: spot_array(device, (32, 32), (30, 30)),
        lambda h: h.optimize(method="WGS-Kim", maxiter=n, stat_groups=["computational"],
                             verbose=False),
        dict(carry_entry=1, cols_wgs_roundtrip=n, rows_normfwd=n, carry_exit=1),
    )
    n1 = run_path(
        "N1 WGS-Nogrette computational_spot 2048^2",
        lambda: spot_array(device, (32, 32), (30, 30)),
        lambda h: h.optimize(method="WGS-Nogrette", maxiter=n, feedback="computational_spot",
                             stat_groups=["computational", "computational_spot"],
                             verbose=False),
        dict(carry_entry=n, cols_fwd_polar=n, cols_wexp_inv=n, carry_exit=n),
    )
    n2 = {}
    for method in ("GS", "WGS-Kim"):
        n2[method] = run_path(
            f"N2 {method} 2048^2 canvas / 1024^2 SLM",
            lambda: spot_array(device, (10, 10), (60, 60), slm_shape=(1024, 1024)),
            lambda h, m=method: h.optimize(method=m, maxiter=n,
                                           stat_groups=["computational"], verbose=False),
            dict(rows_fft=2 * n, cols_fwd_polar=n, cols_wexp_inv=n),
        )
    mraf = dict(carry_entry=1, cols_mraf_fwd=n, cols_mraf_mix_inv=n, rows_normfwd=n,
                carry_exit=1)
    m1 = run_path(
        "M1 MRAF WGS-Leonardo image 2048^2",
        lambda: image_hologram(device),
        lambda h: h.optimize(method="WGS-Leonardo", maxiter=n, mraf_factor=0.5,
                             stat_groups=["computational"], verbose=False),
        mraf,
    )
    run_path(
        "M2 MRAF WGS-Kim zero_factor image 2048^2",
        lambda: image_hologram(device),
        lambda h: h.optimize(method="WGS-Kim", maxiter=n, mraf_factor=0.5, zero_factor=0.1,
                             stat_groups=["computational"], verbose=False),
        mraf,
    )
    m3 = run_path(
        "M3 MRAF GS image 2048^2",
        lambda: image_hologram(device),
        lambda h: h.optimize(method="GS", maxiter=n, mraf_factor=0.5,
                             stat_groups=["computational"], verbose=False),
        dict(carry_entry=n, cols_fwd_polar=n, cols_fft=n, carry_exit=n),
    )
    return {"fused": fused, "N1": n1, "N2": n2["GS"], "M1": m1, "M3": m3}


def phase_golden():
    """The 64^2 goldens replayed through the kernels on the card."""
    from slmsuite_torch.holography.algorithms import Hologram, SpotHologram
    from slmsuite_torch.ops import cuda_fft

    golden_dir = ROOT / "tests" / "holography" / "golden"
    spec = importlib.util.spec_from_file_location("golden_configs", golden_dir / "configs.py")
    configs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(configs)
    for name in GOLDENS:
        golden = np.load(golden_dir / f"ref_{name}.npz")
        cuda_fft.reset_launch_counts()
        stats, phase = configs.run_config(name, Hologram, SpotHologram)
        launched = sum(cuda_fft.LAUNCHES.values())
        assert launched > 0, f"golden {name} launched no kernel"
        for key in configs.STAT_KEYS:
            np.testing.assert_allclose(stats[key], golden[key], atol=GOLDEN_STATS_ATOL,
                                       rtol=GOLDEN_STATS_RTOL, err_msg=f"{name}/{key}")
        dp = phase - golden["phase"]
        dp = np.mod(dp - dp.flat[0] + np.pi, 2 * np.pi) - np.pi
        assert np.abs(dp).max() < GOLDEN_PHASE_ATOL, (name, np.abs(dp).max())
        std_diff = np.abs(stats["std_err"] - golden["std_err"]).max()
        log(f"golden {name}: stats and phase within tolerance (phase max "
            f"{np.abs(dp).max():.2e} rad, std_err max |diff| {std_diff:.2e}, "
            f"{launched} kernel launches)")


def engine_loop(holo, method, **flags):
    """The engine inputs of ``holo`` for ``method`` (and ``flags``, as
    ``optimize`` takes them) with computational stats, and a function that
    runs ``n`` iterations from them."""
    from slmsuite_torch.ops import engine

    holo._update_flags(method, False, None, ["computational"], **flags)
    config = holo._build_config()
    consts = holo._build_consts(config)
    state = holo._build_state(config)
    return lambda n: engine.run_gs(config, state, consts, n)


def loop_ms(run, n):
    """Milliseconds per iteration of ``run(n)`` (CUDA events, after a
    two-iteration warm-up)."""
    run(2)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run(n)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def phase_model_timing(device, n=50):
    """ms/iteration of the fused, the natural and the MRAF loops at
    2048^2, through the kernels and through the plain versions, in turns."""
    from slmsuite_torch.models.engine_models import image_mraf, spot_array_wgs

    loops = {
        "spot_array_wgs(2048) WGS-Kim fused": spot_array_wgs(N=2048, device=device).run,
        "spot_array_wgs(2048) WGS-Nogrette natural": spot_array_wgs(
            N=2048, method="WGS-Nogrette", device=device).run,
        "N2 GS 2048^2 canvas / 1024^2 SLM": engine_loop(
            spot_array(device, (10, 10), (60, 60), slm_shape=(1024, 1024)), "GS"),
        "image_mraf(2048) WGS-Leonardo MRAF carry": image_mraf(N=2048, device=device).run,
        "image_mraf(2048) GS natural MRAF": image_mraf(N=2048, method="GS",
                                                       device=device).run,
    }

    out = {}
    for label, run in loops.items():
        with plain_step_functions():
            p1 = loop_ms(run, n)
        k1 = loop_ms(run, n)
        k2 = loop_ms(run, n)
        with plain_step_functions():
            p2 = loop_ms(run, n)
        out[label] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"{label} run({n}): kernels {k1:.4f} {k2:.4f} ms/iter, "
            f"plain {p1:.4f} {p2:.4f} ms/iter  [{nvidia_smi_line()}]")
    return out


def _union_ms(spans):
    """Total length in ms of the union of ``(start, end)`` spans in us."""
    spans = sorted(spans)
    total, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            total, lo, hi = total + hi - lo, a, b
        else:
            hi = max(hi, b)
    return (total + hi - lo) / 1e3


def phase_profile(device, label, run, n=50):
    """Device-time breakdown of ``run(n)`` under ``torch.profiler``. Only
    device events (kernels, copies, memsets) are counted, never the
    host-side operator rows that enclose them. The busy share is the
    union of device spans over the host wall time of the run, both under
    the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run(5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    events = [
        e for e in prof.events()
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    ]
    assert events, "torch.profiler recorded no device events"
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    device_ms = sum(b - a for a, b in spans) / 1e3
    busy_ms = _union_ms(spans)
    log(f"profile {label} run({n}) [{nvidia_smi_line()}]: "
        f"wall {wall_ms:.3f} ms ({wall_ms / n:.4f} ms/iter), device time "
        f"{device_ms:.3f} ms, device busy {busy_ms:.3f} ms (busy share "
        f"{busy_ms / wall_ms:.3f}), {len(events)} device events "
        f"({len(events) / n:.2f} per iteration)")
    per_name = {}
    for e in events:
        us, count = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    groups = {"the port's kernels": [0.0, 0], "PyTorch glue kernels": [0.0, 0],
              "copies and memsets": [0.0, 0]}
    for name, (us, count) in per_name.items():
        if name.startswith(("Memcpy", "Memset")):
            key = "copies and memsets"
        elif any(kernel in name for kernel in PORT_KERNEL_NAMES):
            key = "the port's kernels"
        else:
            key = "PyTorch glue kernels"
        groups[key][0] += us
        groups[key][1] += count
    log("  " + "; ".join(f"{key} {us / 1e3:.3f} ms in {count} events"
                         for key, (us, count) in groups.items()))
    for name, (us, count) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:15]:
        log(f"  {us / 1e3:9.3f} ms  {count:5d}  {name[:100]}")


# ----------------------------------------------------------------------
# The compressed slice: BASELINE config 5.
# ----------------------------------------------------------------------


@contextlib.contextmanager
def env_var(name, value):
    """``os.environ[name] = value`` for the duration (None: unchanged)."""
    saved = os.environ.get(name)
    if value is not None:
        os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


#: The compressed dispatchers that the plain runs swap for their plain versions.
CMP_DISPATCHERS = ("farfield_to_nearfield", "nearfield_to_farfield", "fused_iteration",
                   "fused_iteration_cached")


def plain_compressed():
    """The compressed engine's transforms, plain."""
    from slmsuite_torch.ops import compressed

    return plain_versions(compressed, CMP_DISPATCHERS)


def config5_hologram(device, spot_amp=None):
    """BASELINE config 5 as bench.py builds it: a 1024^2 SimulatedSLM (8 um
    pitch, 0.78 um), 16x16 spots at kx, ky in [-8e-3, 8e-3] with focus
    uniform in [-2e-6, 2e-6] (default_rng(0)), in the kxy basis (Zernike
    2, 1, 4); from a seeded phase."""
    from slmsuite_torch.hardware.slms.simulated import SimulatedSLM
    from slmsuite_torch.holography.algorithms import CompressedSpotHologram

    slm = SimulatedSLM(resolution=(CONFIG5_RES, CONFIG5_RES), pitch_um=(8, 8), wav_um=0.78)
    rng = np.random.default_rng(0)
    edge = np.linspace(-8e-3, 8e-3, CONFIG5_SIDE)
    kx, ky = np.meshgrid(edge, edge)
    spots = np.vstack([kx.ravel(), ky.ravel(), rng.uniform(-2e-6, 2e-6, kx.size)])
    holo = CompressedSpotHologram(spots, basis="kxy", spot_amp=spot_amp, cameraslm=slm,
                                  device=device)
    holo.reset_phase(np.random.default_rng(1).uniform(-np.pi, np.pi, slm.shape))
    return holo


def compressed_inputs(device, D, P, N, seed=0, basis=None, coeffs=None):
    """Seeded farfield (N,), nearfield (P,) and amplitude (P,) pairs on the
    card, with a random basis and coefficients unless given."""
    rng = np.random.default_rng(seed)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)

    return dict(
        basis=dev(rng.normal(size=(D, P)) * 2) if basis is None else basis,
        coeffs=dev(rng.normal(size=(D, N)) * 5) if coeffs is None else coeffs,
        ffr=dev(rng.normal(size=N)), ffi=dev(rng.normal(size=N)),
        nfr=dev(rng.normal(size=P)), nfi=dev(rng.normal(size=P)),
        amp=dev(0.5 + rng.uniform(0, 1, P)),
    )


def config5_inputs(device):
    """Config 5's basis and coefficients (from its hologram), seeded
    fields, and the cos/sin cache."""
    from slmsuite_torch.ops import compressed

    holo = config5_hologram(device)
    consts = holo._compressed_consts()
    (D, N), P = consts["coeffs"].shape, consts["basis"].shape[1]
    x = compressed_inputs(device, D, P, N, basis=consts["basis"], coeffs=consts["coeffs"])
    x["kc"], x["ks"] = compressed.build_kernel_cache(x["coeffs"], x["basis"])
    return holo, consts, x


def compressed_calls(x, amp, names=("f2n", "n2f", "fused_iter", "fused_iter_cached")):
    """``{kernel: (kernel call, plain call)}`` on inputs ``x`` for ``names``."""
    from slmsuite_torch.ops import compressed as C
    from slmsuite_torch.ops import cuda_compressed as K

    N, P = x["coeffs"].shape[1], x["basis"].shape[1]
    ff, nf, cb = (x["ffr"], x["ffi"]), (x["nfr"], x["nfi"]), (x["coeffs"], x["basis"])
    cache = (x.get("kc"), x.get("ks"), amp, N, P)
    calls = {
        "f2n": (lambda: K.f2n(*ff, *cb), lambda: C._farfield_to_nearfield(*ff, *cb)),
        "n2f": (lambda: K.n2f(*nf, *cb), lambda: C._nearfield_to_farfield(*nf, *cb)),
        "fused_iter": (lambda: K.fused_iter(*ff, *cb, amp),
                       lambda: C._fused_iteration(*ff, *cb, amp)),
        "fused_iter_cached": (lambda: K.fused_iter_cached(*ff, *cache),
                              lambda: C._fused_iteration_cached(*ff, *cache)),
    }
    return {name: calls[name] for name in names}


def wide_phase_inputs(device, D=4, P=3000, N=17, top=1e6, seed=4):
    """Compressed inputs whose phases reach ``|phase|`` = ``top``: the basis in
    multiples of 1/4 within [-2, 2], the spots' coefficients in multiples of
    1/4 up to scales spaced geometrically from 1 to top / (2 D), the first
    spot's all at that scale and the first pixel's basis all 2 (there the
    phase is ``top``). Every product and partial sum is then a multiple of
    1/16 below 2^20, so the phase is exact in f32 whatever the order of its
    sum: kernel and plain version differ in the sincos alone, past
    REDUCED_LIMIT (1e5) too."""
    rng = np.random.default_rng(seed)
    basis = rng.integers(-8, 9, size=(D, P)) / 4
    scale = np.geomspace(top / (2 * D), 1, N)
    coeffs = np.round(rng.uniform(-1, 1, (D, N)) * scale * 4) / 4
    coeffs[:, 0], basis[:, 0] = scale[0], 2.0
    assert np.abs(coeffs.T @ basis).max() == top < 2**20
    dev = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    x = compressed_inputs(device, D, P, N, seed=seed, basis=dev(basis), coeffs=dev(coeffs))
    x["phase_max"] = float(np.abs(coeffs.T @ basis).max())
    return x


def float64_errors(kernel, plain, args):
    """``kernel(*args)`` and ``plain(*args)`` (the plain f32 version)
    against ``plain`` run in float64 on the card: max |diff| / max
    |float64| of each."""
    ref = plain(*(a.double() if torch.is_tensor(a) else a for a in args))
    scale = max(float(ref[0].abs().max()), float(ref[1].abs().max()))

    def err(got):
        return max(float((got[k].double() - ref[k]).abs().max()) for k in (0, 1)) / scale

    return err(kernel(*args)), err(plain(*args))


def check_float64(tag, amp_kind, x, amp, lines, names=("f2n", "n2f", "fused_iter")):
    """:meth:`float64_errors` of the kernels ``names`` (those that recompute
    their sincos), logged and held to CMP_RTOL."""
    from slmsuite_torch.ops import compressed as C
    from slmsuite_torch.ops import cuda_compressed as K

    cb = (x["coeffs"], x["basis"])
    calls = {
        "f2n": (K.f2n, C._farfield_to_nearfield, (x["ffr"], x["ffi"], *cb)),
        "n2f": (K.n2f, C._nearfield_to_farfield, (x["nfr"], x["nfi"], *cb)),
        "fused_iter": (K.fused_iter, C._fused_iteration, (x["ffr"], x["ffi"], *cb, amp)),
    }
    for name in names:
        if amp_kind == "array" and name in ("f2n", "n2f"):
            continue  # these take no amplitude
        kernel, plain, args = calls[name]
        e_kernel, e_plain = float64_errors(kernel, plain, args)
        line = (f"{name} {tag} {amp_kind} against float64: kernel {e_kernel:.3e}, plain f32 "
                f"{e_plain:.3e} (max |diff| / max |float64|)")
        log(line)
        lines.append(line)
        assert e_kernel <= CMP_RTOL, (name, tag, amp_kind, e_kernel)


#: f2n and n2f past the spot groups of n2f's grid and past the shared
#: memory of the earlier n2f (11,417 spots at D = 3, 3,171 at D = 16):
#: (D, P, N).
SPOT_COUNT_SHAPES = ((3, 65536, 300), (3, 65536, 600), (3, 65536, 12000), (16, 16384, 4096))
#: fused_iter past fused_spots_kernel's 256 spots, and past the 8,155 spots
#: (at D = 3) that the earlier roundtrip route held: f2n with the amplitude
#: replacement, then n2f unnormalized, on config 5's plane.
TWO_LAUNCH_SPOTS = 9000


def phase_two_launch_fused(device, basis, lines):
    """``fused_iter`` at TWO_LAUNCH_SPOTS spots on ``basis`` (D = 3):
    exactly one launch each of f2n and n2f and none of fused_iter, within
    CMP_RTOL of ``_fused_iteration`` (scalar and array amplitude) and of
    float64."""
    from slmsuite_torch.ops import compressed as C
    from slmsuite_torch.ops import cuda_compressed as K

    D, P = basis.shape
    x = compressed_inputs(device, D, P, TWO_LAUNCH_SPOTS, seed=9, basis=basis)
    x["coeffs"] = x["coeffs"] * 0.1  # config 5's phases: tens of radians
    args = (x["ffr"], x["ffi"], x["coeffs"], x["basis"])
    for amp_kind in ("scalar", "array"):
        amp = 1.0 if amp_kind == "scalar" else x["amp"]
        K.reset_launch_counts()
        got = K.fused_iter(*args, amp)
        torch.cuda.synchronize()
        launched = {k: v for k, v in K.LAUNCHES.items() if v}
        assert launched == dict(f2n=1, n2f=1), launched
        e = max(rel_err(a, b) for a, b in zip(got, C._fused_iteration(*args, amp)))
        line = f"fused_iter (f2n + n2f) N {TWO_LAUNCH_SPOTS}, P {P}, D {D} {amp_kind}: rel {e:.3e}"
        log(line)
        lines.append(line)
        assert e <= CMP_RTOL, line
        check_float64(f"N {TWO_LAUNCH_SPOTS}, P {P}, D {D}", amp_kind, x, amp, lines,
                      names=("fused_iter",))


def phase_compressed_parity(device):
    """The four compressed kernels against their plain versions at config
    5's shapes, at an unaligned shape (P = 3000, N = 17, D = 4) and there
    with phases up to 1e6 (past REDUCED_LIMIT the kernels' sincos takes
    libdevice's sincosf), past 256 spots (300 and 600) and with nine
    Zernike terms, with scalar and array amplitude; ``f2n`` and ``n2f`` at
    SPOT_COUNT_SHAPES; ``fused_iter`` as two launches at TWO_LAUNCH_SPOTS
    (:meth:`phase_two_launch_fused`); ``f2n``, ``n2f`` and ``fused_iter``
    and their plain f32 versions against the plain versions in float64;
    the dispatchers through config 5's hologram consts. Returns the
    kernels' max |diff| at config 5."""
    from slmsuite_torch.ops import compressed as C
    from slmsuite_torch.ops import cuda_compressed as K

    worst = dict.fromkeys(("f2n", "n2f", "fused_iter", "fused_iter_cached"), 0.0)
    lines = []
    holo, consts, x5 = config5_inputs(device)
    xu = compressed_inputs(device, 4, 3000, 17)
    xw = wide_phase_inputs(device)
    assert xw["phase_max"] == 1e6 > K.REDUCED_LIMIT, xw["phase_max"]
    # fused_iter past its lanes-on-spots kernel's 256 spots (f2n + n2f),
    # fused_iter_cached keeping, then rereading, the cos/sin, and nine
    # Zernike terms.
    x300, x600 = compressed_inputs(device, 5, 4096, 300), compressed_inputs(device, 2, 8192, 600)
    x9 = compressed_inputs(device, 9, 5000, 100)
    for x in (xu, xw, x300, x600, x9):
        x["kc"], x["ks"] = C.build_kernel_cache(x["coeffs"], x["basis"])
    for tag, x in (("config 5 (P 1024^2, N 256, D 3)", x5), ("P 3000, N 17, D 4", xu),
                   (f"P 3000, N 17, D 4, |phase| to {xw['phase_max']:.3g}", xw),
                   ("P 4096, N 300, D 5", x300), ("P 8192, N 600, D 2", x600),
                   ("P 5000, N 100, D 9", x9)):
        for amp_kind in ("scalar", "array"):
            amp = 1.0 if amp_kind == "scalar" else x["amp"]
            for name, (kernel, plain) in compressed_calls(x, amp).items():
                if amp_kind == "array" and name in ("f2n", "n2f"):
                    continue  # these take no amplitude
                got, ref = kernel(), plain()
                e = max(rel_err(got[0], ref[0]), rel_err(got[1], ref[1]))
                assert e <= CMP_RTOL, f"{name} {tag} {amp_kind}: rel {e:.3e}"
                lines.append(f"{name} {tag} {amp_kind}: rel {e:.3e}")
                if x is x5:
                    worst[name] = max(worst[name], max_abs(got[0], ref[0]),
                                      max_abs(got[1], ref[1]))
            check_float64(tag, amp_kind, x, amp, lines)
    # f2n and n2f at spot counts across n2f's spot groups and past the
    # earlier kernels' shared memory.
    for D, P, N in SPOT_COUNT_SHAPES:
        x = compressed_inputs(device, D, P, N, seed=N)
        tag = f"P {P}, N {N}, D {D}"
        for name, (kernel, plain) in compressed_calls(x, 1.0, names=("f2n", "n2f")).items():
            got, ref = kernel(), plain()
            assert got[0].shape == ref[0].shape == ((P,) if name == "f2n" else (N,))
            e = max(rel_err(got[0], ref[0]), rel_err(got[1], ref[1]))
            assert e <= CMP_RTOL, f"{name} {tag}: rel {e:.3e}"
            lines.append(f"{name} {tag}: rel {e:.3e}")
        check_float64(tag, "scalar", x, 1.0, lines, names=("f2n", "n2f"))
        del x
    phase_two_launch_fused(device, x5["basis"], lines)
    # The dispatchers on the hologram's own consts and phase.
    psi = type(holo)._psi.device(holo, device).reshape(-1)
    nf = C.nearfield(psi, consts["amp"])
    cb = (consts["coeffs"], consts["basis"])
    got, ref = C.nearfield_to_farfield(*nf, *cb), C._nearfield_to_farfield(*nf, *cb)
    e = max(rel_err(got[0], ref[0]), rel_err(got[1], ref[1]))
    assert e <= CMP_RTOL, f"nearfield_to_farfield (config 5 hologram): rel {e:.3e}"
    lines.append(f"nearfield_to_farfield (config 5 hologram): rel {e:.3e}")
    got, ref = C.farfield_to_nearfield(*ref, *cb), C._farfield_to_nearfield(*ref, *cb)
    e = max(rel_err(got[0], ref[0]), rel_err(got[1], ref[1]))
    assert e <= CMP_RTOL, f"farfield_to_nearfield (config 5 hologram): rel {e:.3e}"
    lines.append(f"farfield_to_nearfield (config 5 hologram): rel {e:.3e}")
    torch.cuda.synchronize()
    OUT.mkdir(exist_ok=True)
    (OUT / "parity_compressed.log").write_text("\n".join(lines) + "\n")
    log(f"compressed parity: {len(lines)} checks passed; config 5 max |diff| "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return worst


def drive_compressed(make, optimize):
    """Run ``optimize(holo)`` on a fresh ``make()`` with the launch counts
    set to 0 just before it. Returns ``(holo, launches, amp_ff / max,
    weights / max, seconds)``."""
    from slmsuite_torch.ops import cuda_compressed, cuda_fft

    holo = make()
    cuda_compressed.reset_launch_counts()
    cuda_fft.reset_launch_counts()
    start = time.perf_counter()
    optimize(holo)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    assert not any(cuda_fft.LAUNCHES.values()), cuda_fft.LAUNCHES
    launched = {k: v for k, v in cuda_compressed.LAUNCHES.items() if v}
    amp, weights = np.asarray(holo.amp_ff), np.asarray(holo.weights)
    return holo, launched, amp / amp.max(), weights / weights.max(), seconds


def run_compressed_path(label, make, optimize, expect, cache_mb=None):
    """One compressed path through the kernels (launches must equal
    ``expect``) and through the plain versions (no launch; normalized
    amp_ff and weights within CMP_PATH_ATOL). Returns the launches."""
    with env_var("SLMSUITE_TORCH_COMPRESSED_CACHE_MB", cache_mb):
        holo, launched, amp, weights, seconds = drive_compressed(make, optimize)
        cv = float(np.std(holo.amp_ff) / np.mean(holo.amp_ff))
        log(f"{label} (kernels): {seconds:.2f} s, launches {launched}, amp_ff cv {cv:.4f}")
        assert launched == expect, (label, launched, expect)
        phase = holo.get_phase()
        assert phase.shape == tuple(holo.slm_shape) and np.isfinite(phase).all()
        assert np.isfinite(amp).all() and np.isfinite(weights).all()
        assert holo.iter == CONFIG5_ITERS, holo.iter
        with plain_compressed():
            _, plain_launched, plain_amp, plain_weights, plain_s = drive_compressed(
                make, optimize)
    assert not plain_launched, plain_launched
    e_amp = float(np.abs(amp - plain_amp).max())
    e_w = float(np.abs(weights - plain_weights).max())
    log(f"{label} (plain):   {plain_s:.2f} s; normalized amp_ff max |diff| {e_amp:.3e}, "
        f"weights {e_w:.3e}")
    assert e_amp < CMP_PATH_ATOL and e_w < CMP_PATH_ATOL, (label, e_amp, e_w)
    return launched


def phase_compressed_paths(device):
    """C1 (config 5, the cached loop), C2 (the cache off: the recomputing
    loop) and C3 (C1 with per-spot MRAF); returns C1's and C2's launches."""
    n = CONFIG5_ITERS

    def wgs_kim(holo, **kw):
        holo.optimize("WGS-Kim", maxiter=n, verbose=False, **kw)

    c1 = run_compressed_path("C1 config 5 WGS-Kim cached", lambda: config5_hologram(device),
                             wgs_kim, dict(fused_iter_cached=n, n2f=1))
    c2 = run_compressed_path("C2 config 5 WGS-Kim recompute", lambda: config5_hologram(device),
                             wgs_kim, dict(fused_iter=n, n2f=2, f2n=1), cache_mb="0")
    n_spots = CONFIG5_SIDE**2
    spot_amp = np.ones(n_spots)
    spot_amp[np.random.default_rng(2).permutation(n_spots)[:n_spots // 4]] = np.nan
    run_compressed_path("C3 config 5 per-spot MRAF WGS-Kim cached",
                        lambda: config5_hologram(device, spot_amp=spot_amp),
                        lambda h: wgs_kim(h, mraf_factor=0.5),
                        dict(fused_iter_cached=n, n2f=1))
    return {"C1": c1, "C2": c2}


# ----------------------------------------------------------------------
# Z0-Z2: the compressed kernels past 16 Zernike terms and past the cached
# kernel's spots, the Zernike wavefront calibration and a clone of its rig.
# ----------------------------------------------------------------------


def zernike_fused_route(D, N):
    """Whether ``fused_iter`` at D terms and N spots runs as ``f2n`` then
    ``n2f`` (past fused_spots_kernel's spots or the terms it stages)."""
    from slmsuite_torch.ops import cuda_compressed as K

    lib = K._lib()
    return N > lib.slm_cmp_fused_spots() or D > lib.slm_cmp_fused_terms()


def phase_zernike_parity(device):
    """Z0: the four compressed kernels at Z0_TERMS and Z0_SHAPES, scalar and
    array amplitude, against their plain versions within CMP_RTOL, each
    call's launches exact; then Z0_SPOTS spots on a Z0_SIDE^2 SLM with the
    cache on, which run the recomputing loop."""
    from slmsuite_torch.hardware.slms.simulated import SimulatedSLM
    from slmsuite_torch.holography.algorithms import CompressedSpotHologram
    from slmsuite_torch.ops import compressed as C
    from slmsuite_torch.ops import cuda_compressed as K

    lines = []
    for D in Z0_TERMS:
        for P, N in Z0_SHAPES:
            x = compressed_inputs(device, D, P, N, seed=D + N)
            x["kc"], x["ks"] = C.build_kernel_cache(x["coeffs"], x["basis"])
            two = zernike_fused_route(D, N)
            tag = f"P {P}, N {N}, D {D}"
            for amp_kind in ("scalar", "array"):
                amp = 1.0 if amp_kind == "scalar" else x["amp"]
                for name, (kernel, plain) in compressed_calls(x, amp).items():
                    if amp_kind == "array" and name in ("f2n", "n2f"):
                        continue  # these take no amplitude
                    K.reset_launch_counts()
                    got = kernel()
                    launched = {k: v for k, v in K.LAUNCHES.items() if v}
                    expect = dict(f2n=1, n2f=1) if name == "fused_iter" and two else {name: 1}
                    assert launched == expect, (name, tag, launched)
                    ref = plain()
                    e = max(rel_err(got[0], ref[0]), rel_err(got[1], ref[1]))
                    assert e <= CMP_RTOL, f"Z0 {name} {tag} {amp_kind}: rel {e:.3e}"
                    route = " (f2n + n2f)" if name == "fused_iter" and two else ""
                    lines.append(f"Z0 {name}{route} {tag} {amp_kind}: rel {e:.3e}")
            del x
    with env_var("SLMSUITE_TORCH_COMPRESSED_CACHE_MB", "4096"):
        rng = np.random.default_rng(9)
        holo = CompressedSpotHologram(rng.uniform(-2e-2, 2e-2, (2, Z0_SPOTS)),
                                      cameraslm=SimulatedSLM((Z0_SIDE, Z0_SIDE)), device=device)
        fits = C.kernel_cache_bytes(Z0_SPOTS, Z0_SIDE**2) <= 4096e6
        assert fits and not holo._kernel_cache_enabled(), "the cache rule took the cache"
        holo.reset_phase(rng.uniform(-np.pi, np.pi, (Z0_SIDE, Z0_SIDE)))
        K.reset_launch_counts()
        holo.optimize("WGS-Kim", maxiter=Z0_ITERS, verbose=False)
        torch.cuda.synchronize()
    launched = {k: v for k, v in K.LAUNCHES.items() if v}
    assert launched == dict(f2n=Z0_ITERS + 1, n2f=Z0_ITERS + 2), launched
    assert np.isfinite(np.asarray(holo.amp_ff)).all() and holo.iter == Z0_ITERS
    lines.append(f"Z0 {Z0_SPOTS} spots on {Z0_SIDE}^2, cache on: {Z0_ITERS} WGS-Kim "
                 f"iterations on the recomputing loop, launches {launched}")
    OUT.mkdir(exist_ok=True)
    (OUT / "parity_zernike.log").write_text("\n".join(lines) + "\n")
    log(f"Z0: {len(lines) - 1} kernel checks passed at D = {Z0_TERMS}; " + lines[-1])


def z1_rig(device):
    from slmsuite_torch.models.engine_models import zernike_calibration_rig

    return zernike_calibration_rig(slm_side=Z1_SIDE, cam_side=Z1_SIDE, device=device)


def z1_timing(fs, cal, device):
    """Median ms of one tick of the calibration (new coefficients, 3 GS
    iterations on the compressed host loop, the phase fetched) and of
    one camera frame, on ``fs`` at its calibration ``cal``, and the host
    transfers of each under the profiler (a mean over Z1_TIMING_CALLS)."""
    from slmsuite_torch.holography.algorithms import CompressedSpotHologram

    points = np.array(cal["corrected_spots"])
    holo = CompressedSpotHologram(points, basis=np.array(cal["zernike_indices"]),
                                  cameraslm=fs, device=device)
    # The calibration's ticks follow its weight equalization, whose camera
    # feedback stays in the flags: their GS runs the compressed host loop.
    holo.flags["feedback"] = "experimental_spot"

    def tick():
        holo.spot_zernike = points.copy()
        holo.optimize("GS", maxiter=3, verbose=0)
        return holo.get_phase()

    def median_ms(fn):
        fn()
        readings = []
        for _ in range(Z1_TIMING_CALLS):
            torch.cuda.synchronize()
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            readings.append((time.perf_counter() - start) * 1e3)
        return float(np.median(readings))

    def per_call_copies(fn):
        copies, _ = host_transfers(lambda n: [fn() for _ in range(n)], Z1_TIMING_CALLS)
        return len(copies) / Z1_TIMING_CALLS

    tick_ms, tick_copies = median_ms(tick), per_call_copies(tick)
    fs.slm.set_phase(tick(), settle=True, phase_correct=False)
    frame = fs.cam.get_image
    return tick_ms, median_ms(frame), tick_copies, per_call_copies(frame)


def z1_run(device):
    """Z1 once: the calibration on a fresh rig with the launch counts set to
    0 and numpy's global generator seeded just before it. Returns ``(rig,
    calibration, launches, seconds, peak bytes, (tick ms, frame ms, host
    transfers a tick, a frame))``."""
    from slmsuite_torch.ops import cuda_compressed, cuda_fft

    fs = z1_rig(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_compressed.reset_launch_counts()
    cuda_fft.reset_launch_counts()
    np.random.seed(0)
    start = time.perf_counter()
    cal = fs.wavefront_calibrate(method="zernike", calibration_points=Z1_POINTS,
                                 zernike_indices=Z1_TERMS, perturbation=Z1_SWEEP,
                                 optimize_weights=Z1_WEIGHT_ITERS, plot=-1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = {k: v for counts in (cuda_compressed.LAUNCHES, cuda_fft.LAUNCHES)
                for k, v in counts.items() if v}
    peak = torch.cuda.max_memory_allocated()
    return fs, cal, launches, seconds, peak, z1_timing(fs, cal, device)


def injected_corrections(cal):
    """The mean correction (corrected - initial, over the spots) of each
    term the rig injected, by ANSI index."""
    from slmsuite_torch.models.engine_models import ZERNIKE_RIG_ABERRATION

    indices = list(np.asarray(cal["zernike_indices"]))
    delta = np.asarray(cal["corrected_spots"]) - np.asarray(cal["initial_points"])
    return {int(k): float(np.mean(delta[indices.index(k)])) for k in ZERNIKE_RIG_ABERRATION[0]}


def phase_zernike_calibration(device):
    """Z1 through the kernels (each compressed kernel of the path launched)
    and through the plain versions (no launch); the mean correction of each
    injected term within Z1_CORRECTION_ATOL, the mean spot area falling in
    both. Returns ``(calibrated rig, launches)``."""
    from slmsuite_torch.models.engine_models import ZERNIKE_RIG_ABERRATION

    runs = {}
    for label in ("kernels", "plain"):
        if label == "kernels":
            runs[label] = z1_run(device)
        else:
            with plain_compressed(), plain_step_functions():
                runs[label] = z1_run(device)
        fs, cal, launches, seconds, peak, (tick_ms, frame_ms, tick_copies,
                                           frame_copies) = runs[label]
        areas = [float(np.mean(m)) for m in cal["metric_stats"]]
        n_points = np.asarray(cal["corrected_spots"]).shape[1]
        log(f"Z1 Zernike calibration ({label}): {n_points} points, "
            f"{len(cal['zernike_indices'])} terms, {seconds:.2f} s; tick {tick_ms:.2f} ms, "
            f"camera frame {frame_ms:.2f} ms; host transfers a tick {tick_copies:.2f}, a "
            f"frame {frame_copies:.2f}; launches {launches}; peak device memory "
            f"{peak / 2**30:.3f} GiB; mean spot area first {areas[0]:.6g} last "
            f"{areas[-1]:.6g}; injected {dict(zip(*ZERNIKE_RIG_ABERRATION))}, mean "
            f"corrections {injected_corrections(cal)}  [{nvidia_smi_line()}]")
        assert areas[-1] < areas[0], (label, areas[0], areas[-1])
        assert np.isfinite(np.asarray(cal["corrected_spots"])).all(), label
    kernel_launches = runs["kernels"][2]
    for name in ("f2n", "n2f", "fused_iter_cached", "rows_fft", "cols_fft"):
        assert kernel_launches.get(name, 0) > 0, f"Z1 launched no {name}: {kernel_launches}"
    assert not runs["plain"][2], runs["plain"][2]
    got, ref = injected_corrections(runs["kernels"][1]), injected_corrections(runs["plain"][1])
    for index in got:
        diff = abs(got[index] - ref[index])
        assert diff <= Z1_CORRECTION_ATOL, f"Z1 Z_{index}: kernels vs plain differ by {diff:.3f}"
    log(f"Z1 kernels vs plain: injected terms' mean corrections differ by at most "
        f"{max(abs(got[i] - ref[i]) for i in got):.4f} rad (limit {Z1_CORRECTION_ATOL})")
    return runs["kernels"][0], kernel_launches


def z2_spots():
    edge = (np.arange(Z2_SIDE) - (Z2_SIDE - 1) / 2) * Z2_PITCH + Z1_SIDE / 2
    xs, ys = np.meshgrid(edge, edge)
    return np.vstack((xs.ravel(), ys.ravel()))


def z2_run(fs, device):
    """On a clone of ``fs``: the 10x10 hologram's camera loop, then
    refine_offset; then the host transfers of 3 more camera iterations
    under the profiler. Returns ``(measured stats, shifts, launches,
    seconds, peak bytes, host transfers an iteration)``."""
    from slmsuite_torch.holography.algorithms import CompressedSpotHologram
    from slmsuite_torch.ops import cuda_compressed, cuda_fft

    clone = fs.simulate()
    np.random.seed(1)
    holo = CompressedSpotHologram(z2_spots(), basis="ij", cameraslm=clone, device=device)
    cuda_compressed.reset_launch_counts()
    cuda_fft.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    holo.optimize("WGS-Kim", feedback="experimental_spot", maxiter=Z2_ITERS, verbose=False,
                  stat_groups=["experimental_spot"])
    shifts = holo.refine_offset()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for counts in (cuda_compressed.LAUNCHES, cuda_fft.LAUNCHES)
                for k, v in counts.items() if v}
    recorded = holo.stats["stats"]["experimental_spot"]
    stats = {key: float(recorded[key][-1]) for key in ("uniformity", "efficiency")}
    copies, _ = host_transfers(lambda n: holo.optimize(
        "WGS-Kim", feedback="experimental_spot", maxiter=n, verbose=False), 3)
    return stats, shifts, launches, seconds, peak, len(copies) / 3


def phase_zernike_clone(device, fs):
    """Z2 on Z1's calibrated rig ``fs``: its clone's Fourier calibration
    survives ``save``/``load`` and ``save_calibration``/``load`` within
    Z2_AFFINE_ATOL; the clone's 10x10 camera loop and refine_offset through
    the kernels and the plain versions agree on what users read."""
    from slmsuite_torch.hardware.cameraslms import FourierSLM

    clone = fs.simulate()
    ij = z2_spots()
    kxy = clone.ijcam_to_kxyslm(ij)
    if importlib.util.find_spec("h5py") is None:
        log("Z2: h5py is not installed here, so no HDF5 file is written: the clone crosses "
            "as the dictionary that save() writes and load() reads (FourierSLM._from_pickle; "
            "tests/test_torch_wavefront.py holds the files on the CPU)")
        crossed = [("pickle()/load", FourierSLM._from_pickle(clone.pickle(), device))]
    else:
        with tempfile.TemporaryDirectory(dir=OUT) as tmp:
            loaded = FourierSLM.load(clone.save(tmp), device=device)
            cal_path = clone.save_calibration("fourier", path=tmp)
            bare = FourierSLM.load(cal_path, device=device)
            assert not bare.calibrations
            bare.load_calibration("fourier", cal_path)
        crossed = [("save/load", loaded), ("save_calibration/load", bare)]
    for label, other in crossed:
        d = float(np.abs(other.kxyslm_to_ijcam(kxy) - clone.kxyslm_to_ijcam(kxy)).max())
        log(f"Z2 clone {label}: kxyslm_to_ijcam max |diff| {d:.3e} px "
            f"(limit {Z2_AFFINE_ATOL})")
        assert d <= Z2_AFFINE_ATOL, (label, d)
    assert "wavefront_zernike" in crossed[0][1].calibrations
    del crossed, clone
    stats, shifts, launches, seconds, peak, copies = z2_run(fs, device)
    log(f"Z2 clone, 10x10 grid, {Z2_ITERS} WGS-Kim camera iterations and refine_offset "
        f"(kernels): {seconds:.2f} s, uniformity {stats['uniformity']:.6f} efficiency "
        f"{stats['efficiency']:.6f}, mean shift {np.round(np.mean(shifts, axis=1), 4)} px; "
        f"launches {launches}; peak device memory {peak / 2**30:.3f} GiB; host transfers "
        f"a camera iteration {copies:.2f}")
    for name in ("f2n", "n2f", "rows_fft", "cols_fft"):
        assert launches.get(name, 0) > 0, f"Z2 launched no {name}: {launches}"
    with plain_compressed(), plain_step_functions():
        plain_stats, plain_shifts, plain_launches, plain_s, plain_peak, plain_copies = z2_run(
            fs, device)
    assert not plain_launches, plain_launches
    d_shift = float(np.abs(shifts - plain_shifts).max())
    log(f"Z2 (plain): {plain_s:.2f} s, uniformity {plain_stats['uniformity']:.6f} efficiency "
        f"{plain_stats['efficiency']:.6f}; shifts max |diff| {d_shift:.4f} px; peak device "
        f"memory {plain_peak / 2**30:.3f} GiB; host transfers a camera iteration "
        f"{plain_copies:.2f}")
    for key in ("uniformity", "efficiency"):
        diff = abs(stats[key] - plain_stats[key])
        assert diff <= CAMERA_STAT_ATOL, f"Z2 {key}: kernels vs plain differ by {diff:.3e}"
    assert d_shift <= Z2_SHIFT_ATOL, d_shift


def counted_frames(cam):
    """Count the camera's hardware frames: returns a one-item list that
    each frame adds one to."""
    count = [0]
    frame = cam._get_image_hw

    def counted(*args, **kwargs):
        count[0] += 1
        return frame(*args, **kwargs)

    cam._get_image_hw = counted
    return count


@contextlib.contextmanager
def timed_fits(seconds):
    """Add the time spent in ``scipy.optimize.curve_fit`` (the calibration's
    fits and ``analysis.image_fit``'s) to ``seconds[0]``."""
    import scipy.optimize

    from slmsuite_torch.holography import analysis

    fit = scipy.optimize.curve_fit

    def timed(*args, **kwargs):
        start = time.perf_counter()
        try:
            return fit(*args, **kwargs)
        finally:
            seconds[0] += time.perf_counter() - start

    scipy.optimize.curve_fit = analysis.curve_fit = timed
    try:
        yield
    finally:
        scipy.optimize.curve_fit = analysis.curve_fit = fit


def w1_expose(fs):
    """Expose W1's camera for the interference: the reference superpixel
    alone (the SLM's central one, the default) blazed to W1_POINT, the rest
    of the SLM to the 0th order, and ``autoexposure`` on the interference
    window at W1_EXPOSURE_FRACTION. Returns the exposure."""
    from slmsuite_torch.hardware.cameraslms import _blaze_offset
    from slmsuite_torch.holography.toolbox import imprint

    centre = fs.slm.shape[0] // W1_SUPERPIXEL // 2
    pattern = np.zeros(fs.slm.shape)
    imprint(pattern, np.array([centre, 1, centre, 1]) * W1_SUPERPIXEL, _blaze_offset, fs.slm,
            vector=fs.ijcam_to_kxyslm(W1_POINT))
    fs.slm.set_phase(pattern, settle=True)
    window = int(fs.wavefront_calibration_superpixel_window(W1_SUPERPIXEL).max())
    return fs.cam.autoexposure(set_fraction=W1_EXPOSURE_FRACTION, verbose=False,
                               window=(W1_POINT[0, 0], window, W1_POINT[1, 0], window))


def spot_peak_gain(fs):
    """The JAX smoke test's measure: the exposure halved until the
    corrected spot (all of the SLM to the 0th order) peaks below 0.9 of the
    range; ``(peak with the correction, peak without)``."""
    def peak():
        fs.slm.set_phase(None, settle=False)
        return float(fs.cam.get_image().astype(float).max())

    while peak() >= 0.9 * fs.cam.bitresolution:
        fs.cam.set_exposure(fs.cam.get_exposure() / 2)
    after = peak()
    correction = fs.slm.source.pop("phase")
    before = peak()
    fs.slm.source["phase"] = correction
    return after, before


def weighted_phase_rms(got, ref, weight):
    """The RMS of the circular difference of two phases weighted by
    ``weight``, its weighted circular mean (a global constant) removed."""
    d = np.angle(np.exp(1j * (np.asarray(got, np.float64) - np.asarray(ref, np.float64))))
    piston = np.angle(np.sum(weight * np.exp(1j * d)))
    residual = np.angle(np.exp(1j * (d - piston)))
    return float(np.sqrt(np.sum(weight * residual**2) / np.sum(weight)))


def w1_run(device):
    """W1 once on a fresh Z1 rig: the exposure, then
    ``wavefront_calibrate()`` (the superpixel method) and
    ``wavefront_calibration_superpixel_process(apply=True)`` with the
    launch counts set to 0 and numpy's global generator seeded just before,
    then the peak gain, the host transfers of a frame and the single-shot
    fringe fits of W1_TEST_COLUMNS. Returns the rig (at W1's exposure) and
    a dict of what was measured."""
    from slmsuite_torch.ops import cuda_fft

    fs = z1_rig(device)
    exposure = w1_expose(fs)
    frames = counted_frames(fs.cam)
    fit_s = [0.0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_fft.reset_launch_counts()
    np.random.seed(0)
    start = time.perf_counter()
    with timed_fits(fit_s):
        raw = fs.wavefront_calibrate(calibration_points=W1_POINT, superpixel_size=W1_SUPERPIXEL,
                                     phase_steps=W1_STEPS, plot=-1)
        torch.cuda.synchronize()
        calibrate_s = time.perf_counter() - start
        n_frames, calibrate_fit_s = frames[0], fit_s[0]
        start = time.perf_counter()
        processed = fs.wavefront_calibration_superpixel_process(apply=True)
        torch.cuda.synchronize()
        process_s = time.perf_counter() - start
    launches = {k: v for k, v in cuda_fft.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated()
    copies, _ = host_transfers(lambda n: [fs.cam.get_image() for _ in range(n)], 5)
    after, before = spot_peak_gain(fs)
    peak_exposure = fs.cam.get_exposure()
    injected = np.asarray(fs.slm.source["phase_sim"], np.float64)
    residual = weighted_phase_rms(processed["phase"], -injected, processed["amplitude"])
    fs.cam.set_exposure(exposure)
    fringes = []
    for column in W1_TEST_COLUMNS:
        np.random.seed(0)
        result = fs.wavefront_calibrate_superpixel(
            calibration_points=W1_POINT, superpixel_size=W1_SUPERPIXEL, phase_steps=1,
            test_index=column, plot=-1)
        fringes.append((float(result["phase"][0]), float(result["r2_fit"][0])))
    return fs, {
        "raw": raw, "processed": processed, "exposure": exposure, "frames": n_frames,
        "calibrate_s": calibrate_s, "fit_s": calibrate_fit_s, "process_s": process_s,
        "launches": launches, "peak_bytes": peak, "copies_a_frame": len(copies) / 5,
        "peak_after": after, "peak_before": before, "peak_exposure": peak_exposure,
        "residual_rms": residual,
        "fringes": fringes,
    }


def phase_superpixel(device):
    """W1 through the kernels and through the plain versions: in each the
    corrected peak exceeds W1_PEAK_GAIN times the uncorrected one; the two
    processed phases agree within W1_PHASE_RMS, the amplitudes within
    W1_AMP_ATOL, the single-shot fringe phases within W1_FRINGE_ATOL.
    Returns ``({label: calibrated rig}, {label: W1 result})``."""
    rigs, runs = {}, {}
    for label in ("kernels", "plain"):
        if label == "kernels":
            rigs[label], runs[label] = w1_run(device)
        else:
            with plain_step_functions():
                rigs[label], runs[label] = w1_run(device)
        w = runs[label]
        r2 = np.asarray(w["raw"]["r2_fit"])
        log(f"W1 superpixel calibration ({label}): {W1_SUPERPIXEL}-pixel superpixels "
            f"({'x'.join(str(v) for v in w['raw']['slm_supershape'])}), {W1_STEPS} phase steps, "
            f"exposure {w['exposure']:.6g}; {w['calibrate_s']:.2f} s, {w['frames']} frames, "
            f"{1e3 * w['calibrate_s'] / w['frames']:.2f} ms a frame, fits {w['fit_s']:.2f} s, "
            f"processing {w['process_s']:.3f} s; launches {w['launches']}; host transfers a "
            f"frame {w['copies_a_frame']:.2f}; peak device memory "
            f"{w['peak_bytes'] / 2**30:.3f} GiB; fits with r2 > 0.9: "
            f"{int(np.sum(r2 > 0.9))} of {int(np.sum(np.isfinite(r2)))}; spot peak "
            f"{w['peak_after']:.0f} corrected against {w['peak_before']:.0f} "
            f"({w['peak_after'] / max(w['peak_before'], 1):.3f}x); residual wavefront "
            f"{w['residual_rms']:.4f} rad RMS (recorded, not gated); single-shot fringes "
            f"(phase, r2) at columns {W1_TEST_COLUMNS}: "
            f"{[(round(p, 4), round(r, 4)) for p, r in w['fringes']]}  [{nvidia_smi_line()}]")
        assert w["peak_after"] > W1_PEAK_GAIN * w["peak_before"], (label, w["peak_after"],
                                                                   w["peak_before"])
        assert np.isfinite(w["processed"]["phase"]).all(), label
    for name in ("rows_fft", "cols_fft"):
        assert runs["kernels"]["launches"].get(name, 0) > 0, runs["kernels"]["launches"]
    assert not runs["plain"]["launches"], runs["plain"]["launches"]
    got, ref = runs["kernels"]["processed"], runs["plain"]["processed"]
    d_phase = weighted_phase_rms(got["phase"], ref["phase"], got["amplitude"])
    d_amp = float(np.abs(got["amplitude"] - ref["amplitude"]).max())
    d_fringe = max(abs(float(np.angle(np.exp(1j * (a[0] - b[0])))))
                   for a, b in zip(runs["kernels"]["fringes"], runs["plain"]["fringes"]))
    log(f"W1 kernels vs plain: processed phase {d_phase:.5f} rad RMS (limit {W1_PHASE_RMS}), "
        f"amplitude max |diff| {d_amp:.3e} (limit {W1_AMP_ATOL}), single-shot fringe phases "
        f"max |diff| {d_fringe:.5f} rad (limit {W1_FRINGE_ATOL})")
    assert d_phase <= W1_PHASE_RMS and d_amp <= W1_AMP_ATOL, (d_phase, d_amp)
    assert d_fringe <= W1_FRINGE_ATOL, d_fringe
    return rigs, runs


def w2_check(holo, label):
    """S0's check on ``holo``: the device measurement (one rows_fft and one
    cols_fft) against set_phase -> get_image -> take, within one count per
    window pixel. Returns the spot powers."""
    from slmsuite_torch.holography import analysis
    from slmsuite_torch.ops import cuda_fft

    holo._midloop_cleaning()
    cuda_fft.reset_launch_counts()
    fast, _ = holo._sim_spot_powers()
    torch.cuda.synchronize()
    assert cuda_fft.LAUNCHES["rows_fft"] == 1 and cuda_fft.LAUNCHES["cols_fft"] == 1, label
    holo.measure("ij")
    host = analysis.take(np.square(np.asarray(holo.img_ij, np.float64)), holo.spot_ij,
                         holo.spot_integration_width_ij, centered=True, integrate=True)
    pixels = holo.spot_integration_width_ij ** 2
    d = float(np.abs(fast - host).max())
    log(f"W2 {label}: spot powers {np.round(host).tolist()} counts, device vs host max |diff| "
        f"{d:.1f} (limit {pixels})")
    assert host.min() > 0 and d <= pixels, (label, d)
    return host


def phase_rig_state(device, rigs, runs):
    """W2 on W1's calibrated rigs: the pin (at W2_EXPOSURE_GAIN times the
    exposure of W1's peak check, where no spot saturates: a spot hologram on the device
    measurement path, optimized before and after the correction changes,
    the device measurement against the host image path each time, the
    cached constants rebuilt), then ``fit_source_amplitude(force=True)``
    on each route's measured amplitude, its centre within W2_CENTER_ATOL of
    the simulated source's."""
    from slmsuite_torch.holography import analysis
    from slmsuite_torch.holography.algorithms import SpotHologram

    fs = rigs["kernels"]
    fs.cam.set_exposure(W2_EXPOSURE_GAIN * runs["kernels"]["peak_exposure"])
    correction = fs.slm.source.pop("phase")
    np.random.seed(2)
    holo = SpotHologram(W2_SHAPE, W2_SPOTS, basis="ij", cameraslm=fs, device=device)
    holo.optimize("WGS-Kim", feedback="experimental_spot", maxiter=W2_ITERS, verbose=False)
    consts = holo._sim_engine_inputs()[0]
    uncorrected = w2_check(holo, "before the correction")
    fs.slm.source["phase"] = correction
    holo.optimize("WGS-Kim", feedback="experimental_spot", maxiter=W2_ITERS, verbose=False)
    assert holo._sim_engine_inputs()[0] is not consts, "the device constants were not rebuilt"
    corrected = w2_check(holo, "after the correction")
    log(f"W2 pin: total spot power {uncorrected.sum():.0f} before the correction, "
        f"{corrected.sum():.0f} after it")

    amp_sim = np.asarray(fs.slm.source["amplitude_sim"], np.float64)
    truth = np.ravel(analysis.image_positions(np.square(amp_sim))) + np.flip(fs.slm.shape) / 2
    centres = {}
    for label, rig in rigs.items():
        rig.slm.fit_source_amplitude(force=True)
        centres[label] = np.asarray(rig.slm.source["amplitude_center_pix"], np.float64)
    d = max(float(np.abs(c - truth).max()) for c in centres.values())
    d_routes = float(np.abs(centres["kernels"] - centres["plain"]).max())
    log(f"W2 fit_source_amplitude of W1's measured amplitude: centre {centres['kernels']} "
        f"(kernels), {centres['plain']} (plain), simulated source {truth}; max |diff| {d:.3f} "
        f"px, kernels vs plain {d_routes:.3e} px (limit {W2_CENTER_ATOL}); radius "
        f"{float(rigs['kernels'].slm.source['amplitude_radius']):.4f}")
    assert d <= W2_CENTER_ATOL and d_routes <= W2_CENTER_ATOL, (d, d_routes)


@contextlib.contextmanager
def h5_stand_in():
    """Without h5py the calibration files cannot be HDF5: ``save_h5`` and
    ``load_h5`` of the rig module write and read pickles of the same names
    for the duration (logged). With h5py, nothing changes."""
    if importlib.util.find_spec("h5py") is not None:
        yield
        return
    import pickle

    from slmsuite_torch.hardware import cameraslms

    saved = cameraslms.save_h5, cameraslms.load_h5

    def save(path, data, mode="w"):
        with open(path, "wb") as handle:
            pickle.dump(data, handle)

    def load(path):
        with open(path, "rb") as handle:
            return pickle.load(handle)

    cameraslms.save_h5, cameraslms.load_h5 = save, load
    log("W3: h5py is not installed here: write_calibration/read_calibration write and read "
        "pickles of the same names (tests/test_torch_rig_calibrations.py holds the HDF5 files "
        "on the CPU)")
    try:
        yield
    finally:
        cameraslms.save_h5, cameraslms.load_h5 = saved


def w3_run(device):
    """W3 once on a fresh Z1 rig: each calibration with the launch counts
    set to 0 just before it; returns a dict of their results, seconds,
    frames and launches."""
    from slmsuite_torch.holography import toolbox
    from slmsuite_torch.misc.files import latest_path
    from slmsuite_torch.ops import cuda_fft

    fs = z1_rig(device)
    frames = counted_frames(fs.cam)
    out = {}

    def timed(name, call):
        cuda_fft.reset_launch_counts()
        frames[0] = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = call()
        torch.cuda.synchronize()
        out[name] = {"result": result, "seconds": time.perf_counter() - start,
                     "frames": frames[0],
                     "launches": {k: v for k, v in cuda_fft.LAUNCHES.items() if v}}
        return result

    settle = timed("settle", lambda: fs.settle_calibrate(
        times=np.linspace(0.001, 0.02, 6), settle_time_s=0.01))
    out["settle"]["size"] = int(16 * toolbox.convert_radius(
        fs.slm.get_spot_radius_kxy(), to_units="ij", hardware=fs))
    out["settle"]["data"] = np.squeeze(np.asarray(settle["data"], np.float64))
    pixel = timed("pixel", lambda: fs.pixel_calibrate(levels=4, periods=[16, 32], orders=1))
    fs.pixel_calibration_process()
    out["pixel"]["data"] = np.asarray(pixel["data"], np.float64)
    out["pixel"]["phase"] = np.asarray(pixel["phase_fit"]["phase"])
    fs.slm.set_phase(None, settle=True)
    timed("autoexposure", lambda: fs.cam.autoexposure(set_fraction=0.4, tol=0.03, verbose=False))
    timed("autofocus", lambda: fs.cam.autofocus(fs.slm, range_z=2))
    with tempfile.TemporaryDirectory(dir=OUT) as tmp, h5_stand_in():
        with warnings_caught() as caught:
            fs.write_calibration("pixel", tmp, None)
            path = latest_path(tmp, fs.name_calibration("pixel"), extension="h5")
            stored = fs.calibrations.pop("pixel")
            fs.read_calibration("pixel", path)
        assert any("write_calibration is deprecated" in m for m in caught), caught
        assert any("read_calibration is deprecated" in m for m in caught), caught
        np.testing.assert_array_equal(fs.calibrations["pixel"]["data"], stored["data"])
    return out


@contextlib.contextmanager
def warnings_caught():
    """The messages of the warnings raised in the block (a list)."""
    import warnings

    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        messages = []
        yield messages
        messages.extend(str(w.message) for w in record)


def phase_rig_calibrations(device):
    """W3 through the kernels and through the plain versions: the settle
    data within one count per window pixel, the pixel data within
    W3_PIXEL_RTOL of its largest, the exposures within W3_EXPOSURE_RTOL,
    autofocus's z within W3_FOCUS_ATOL; the write/read round trip in each.
    Returns the kernels' W3."""
    runs = {}
    for label in ("kernels", "plain"):
        if label == "kernels":
            runs[label] = w3_run(device)
        else:
            with plain_step_functions():
                runs[label] = w3_run(device)
        w = runs[label]
        log(f"W3 ({label}): " + "; ".join(
            f"{name} {w[name]['seconds']:.3f} s, {w[name]['frames']} frames, launches "
            f"{w[name]['launches']}" for name in ("settle", "pixel", "autoexposure",
                                                   "autofocus"))
            + f"; settle time {w['settle']['result']['settle_time']:.5f} s, exposure "
            f"{w['autoexposure']['result']:.6g}, autofocus z {w['autofocus']['result']:.5f}, "
            f"pixel phase response {np.round(w['pixel']['phase'], 4).tolist()}  "
            f"[{nvidia_smi_line()}]")
    got, ref = runs["kernels"], runs["plain"]
    for name in ("settle", "pixel", "autoexposure", "autofocus"):
        assert got[name]["launches"].get("rows_fft", 0) > 0, (name, got[name]["launches"])
        assert not ref[name]["launches"], (name, ref[name]["launches"])
    d_settle = float(np.abs(got["settle"]["data"] - ref["settle"]["data"]).max())
    d_pixel = float(np.abs(got["pixel"]["data"] - ref["pixel"]["data"]).max()
                    / np.abs(ref["pixel"]["data"]).max())
    d_exposure = abs(got["autoexposure"]["result"] / ref["autoexposure"]["result"] - 1)
    d_focus = abs(got["autofocus"]["result"] - ref["autofocus"]["result"])
    log(f"W3 kernels vs plain: settle data max |diff| {d_settle:.1f} counts (limit "
        f"{got['settle']['size'] ** 2}: one a window pixel), pixel data {d_pixel:.3e} of its "
        f"largest (limit {W3_PIXEL_RTOL}), exposure {d_exposure:.3e} relative (limit "
        f"{W3_EXPOSURE_RTOL:.4f}), autofocus z {d_focus:.5f} (limit {W3_FOCUS_ATOL})")
    assert d_settle <= got["settle"]["size"] ** 2 and d_pixel <= W3_PIXEL_RTOL, (d_settle,
                                                                                d_pixel)
    assert d_exposure <= W3_EXPOSURE_RTOL and d_focus <= W3_FOCUS_ATOL, (d_exposure, d_focus)
    return got


def compressed_bound(name, D, N, P, n8):
    """``(bound_ms, bound_by)`` of a compressed kernel: bytes (each input
    read once, each output written once) over the HBM rate against f32
    operations over the f32 peak. A (spot, pixel) pair costs 2 D for its
    phase, SINCOS_FLOPS for its sincos and 8 per direction (four FMAs);
    fused_iter_cached reads the sincos from the cache instead."""
    pairs = N * P
    fields = 2 * N * 4 * (2 if name.startswith("fused") else 1)
    if name == "fused_iter_cached":
        n_tiles = -(-P // 8192)
        nbytes = 2 * n8 * n_tiles * 8192 * 4 + P * 4 + fields
        flops = pairs * 16
    else:
        nbytes = (D * P + D * N) * 4 + fields + (2 * P * 4 if name in ("f2n", "n2f") else P * 4)
        flops = pairs * (2 * D + SINCOS_FLOPS + (16 if name == "fused_iter" else 8))
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flop_ms = flops / F32_FLOP_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= flop_ms else (flop_ms, "operations")


def parent_port(root, module="slmsuite_torch.ops.cuda_compressed"):
    """The ``module`` (``cuda_compressed``, or ``cuda_fft``) of the port
    unpacked at ``root`` (a parent commit's ``slmsuite_torch``, for an
    A/B): its package imported in place of this tree's, then this tree's
    put back in ``sys.modules``.
    The parent's modules keep their own references, so its wrappers check,
    bind, build (into ``root/build/``) and launch its own library, and count
    in its own ``LAUNCHES``."""
    import importlib

    def ours(name):
        return name == "slmsuite_torch" or name.startswith("slmsuite_torch.")

    saved = {k: sys.modules.pop(k) for k in list(sys.modules) if ours(k)}
    sys.path.insert(0, str(root))
    try:
        return importlib.import_module(module)
    finally:
        sys.path.remove(str(root))
        for k in [k for k in sys.modules if ours(k)]:
            del sys.modules[k]
        sys.modules.update(saved)


def ab_medians(label, calls, rounds=2):
    """CUDA events of ``calls = {"this": fn, "parent": fn}`` in turns parent,
    this, this, parent, ``rounds`` times; logs the readings and returns the
    medians ``(this, parent)`` in ms."""
    readings = {"this": [], "parent": []}
    for _ in range(rounds):
        for who in ("parent", "this", "this", "parent"):
            readings[who].append(cuda_ms(calls[who]))
    medians = float(np.median(readings["this"])), float(np.median(readings["parent"]))
    log(f"A/B {label} (events), this tree against the parent's, one process: this "
        + " ".join(f"{v:.4f}" for v in readings["this"]) + " ms, parent "
        + " ".join(f"{v:.4f}" for v in readings["parent"])
        + f" ms; medians {medians[0]:.4f} / {medians[1]:.4f} ms  [{nvidia_smi_line()}]")
    return medians


def compressed_ab(x, parent):
    """This tree's four compressed kernels against the parent's (``parent``,
    from :meth:`parent_port`) on config 5's inputs ``x`` (array amplitude),
    both through their wrappers: the outputs within CMP_RTOL of each other,
    then :meth:`ab_medians`."""
    from slmsuite_torch.ops import cuda_compressed as K

    N, P = x["coeffs"].shape[1], x["basis"].shape[1]
    ff, nf, cb = (x["ffr"], x["ffi"]), (x["nfr"], x["nfi"]), (x["coeffs"], x["basis"])
    for name in ("f2n", "n2f", "fused_iter", "fused_iter_cached"):
        def call(mod, name=name):
            if name == "f2n":
                return lambda: mod.f2n(*ff, *cb)
            if name == "n2f":
                return lambda: mod.n2f(*nf, *cb)
            if name == "fused_iter":
                return lambda: mod.fused_iter(*ff, *cb, x["amp"])
            return lambda: mod.fused_iter_cached(*ff, x["kc"], x["ks"], x["amp"], N, P)

        calls = {"this": call(K), "parent": call(parent)}
        e = max(rel_err(a, b) for a, b in zip(calls["this"](), calls["parent"]()))
        assert e <= CMP_RTOL, (name, e)
        log(f"A/B {name} config 5: outputs within rel {e:.2e}")
        ab_medians(f"{name} config 5", calls)


#: Spot counts of the A/B of fused_iter's two routes past fused_spots_kernel's
#: 256 spots on config 5's plane: this tree's f2n + n2f against the parent's
#: roundtrip_kernel (keeping the cos/sin up to 640 spots, recomputing them
#: beyond; its shared memory holds 8,155 spots at D = 3).
FUSED_ROUTE_SPOTS = (300, 600, 4096, 8000)


def fused_route_ab(consts, device, parent):
    """fused_iter at FUSED_ROUTE_SPOTS on config 5's basis, the spots'
    coefficients drawn uniformly within the range of config 5's for each
    term (array amplitude): this tree (f2n with the amplitude replacement,
    then n2f) against the parent's (roundtrip_kernel), outputs within
    CMP_RTOL, then :meth:`ab_medians`."""
    from slmsuite_torch.ops import cuda_compressed as K

    basis, coeffs = consts["basis"], consts["coeffs"]
    lo, hi = coeffs.min(dim=1, keepdim=True).values, coeffs.max(dim=1, keepdim=True).values
    gen = torch.Generator(device=device).manual_seed(11)
    for N in FUSED_ROUTE_SPOTS:
        c = lo + (hi - lo) * torch.rand((coeffs.shape[0], N), generator=gen, device=device)
        x = compressed_inputs(device, coeffs.shape[0], basis.shape[1], N, seed=N, basis=basis,
                              coeffs=c.contiguous())
        args = (x["ffr"], x["ffi"], x["coeffs"], basis, x["amp"])
        calls = {"this": lambda: K.fused_iter(*args), "parent": lambda: parent.fused_iter(*args)}
        e = max(rel_err(a, b) for a, b in zip(calls["this"](), calls["parent"]()))
        assert e <= CMP_RTOL, (N, e)
        log(f"A/B fused_iter route N {N}: outputs within rel {e:.2e}")
        ab_medians(f"fused_iter N {N}, P {basis.shape[1]}, D {basis.shape[0]} "
                   "(f2n + n2f / roundtrip_kernel)", calls)


def phase_compressed_timing(device, parent=None):
    """Each compressed kernel and its plain version at config 5 (array amp,
    as config 5 runs), and at ZERNIKE_TIMING_TERMS terms on config 5's
    plane and spots (:meth:`wide_inputs`; the entry's ``"zernike"``);
    with ``parent``, a parent commit's ``cuda_compressed`` (:meth:`parent_port`),
    each also against the parent's (:meth:`compressed_ab`) and
    fused_iter's two routes past 256 spots (:meth:`fused_route_ab`); the
    cache build, and ms/iteration of the C1 (cached) and C2 (recompute)
    loops through the kernels and the plain versions."""
    from slmsuite_torch.ops import compressed as C

    holo, consts, x = config5_inputs(device)
    (D, N), P, n8 = x["coeffs"].shape, x["basis"].shape[1], x["kc"].shape[1]
    t = {}
    for name, (kernel, plain) in compressed_calls(x, x["amp"]).items():
        t[name] = interleaved(name, kernel, plain, bound_of=compressed_bound(name, D, N, P, n8),
                              size="config 5 (P 1024^2, N 256, D 3)")
    xz = wide_inputs(device, x, ZERNIKE_TIMING_TERMS, cache=True)
    Dz = xz["coeffs"].shape[0]
    for name, (kernel, plain) in compressed_calls(xz, xz["amp"]).items():
        t[name]["zernike"] = interleaved(
            name, kernel, plain, bound_of=compressed_bound(name, Dz, N, P, n8),
            size=f"config 5's plane and spots at D {Dz} (P 1024^2, N 256)")
    del xz
    if parent is not None:
        compressed_ab(x, parent)
        fused_route_ab(consts, device, parent)
    build_ms = cuda_ms(lambda: C.build_kernel_cache(x["coeffs"], x["basis"]), n=3, warmup=1)
    log(f"cache build config 5: {build_ms:.3f} ms, {C.kernel_cache_bytes(N, P)} bytes "
        f"({tuple(x['kc'].shape)} x 2 f32)")
    del x

    def loop(cache):
        holo._update_flags("WGS-Kim", False, "computational_spot", [])
        config = holo._compressed_config(kernel_cache=cache)
        consts = holo._compressed_consts(kernel_cache=cache)
        state = holo._compressed_state()
        return lambda n: C.run_compressed_gs(config, state, consts, n)

    loops = {"C1 config 5 WGS-Kim cached": loop(True),
             "C2 config 5 WGS-Kim recompute": loop(False)}
    for label, run in loops.items():
        with plain_compressed():
            p1 = loop_ms(run, CONFIG5_ITERS)
        k1 = loop_ms(run, CONFIG5_ITERS)
        k2 = loop_ms(run, CONFIG5_ITERS)
        with plain_compressed():
            p2 = loop_ms(run, CONFIG5_ITERS)
        log(f"{label} run({CONFIG5_ITERS}): kernels {k1:.4f} {k2:.4f} ms/iter, "
            f"plain {p1:.4f} {p2:.4f} ms/iter  [{nvidia_smi_line()}]")
    return t, loops


# ----------------------------------------------------------------------
# The wide compressed kernels (past 16 Zernike terms): their A/B against
# a parent's port (--compressed-ab), and Z3.
# ----------------------------------------------------------------------

#: Term counts of the wide kernels' A/B: five, six, seven and eleven float4
#: groups (compile-time instantiations, the last one spot a lane in n2f)
#: and 48, past them (the group count at run time).
WIDE_AB_TERMS = (17, 21, 28, 44, 48)
#: Z1's spot count (its 97 points) at its 21 terms, also in the A/B.
WIDE_AB_Z1_SPOTS = 97
#: Z3: a Z3_SIDE x Z3_SIDE spot array at Z3_TERMS Zernike terms on config
#: 5's SLM, WGS-Kim iterations of its run and of each timing.
Z3_SIDE, Z3_TERMS, Z3_ITERS, Z3_TIMING_ITERS = 32, 21, 20, 5


def template_args(mangled):
    """``"21, 16"`` of a mangled template argument list ``Li21ELi16E``."""
    import re

    return ", ".join(re.findall(r"Li(\d+)E", mangled))


def wide_ptxas(build_log, names=("f2n_wide_kernel", "n2f_wide_kernel")):
    """``{instantiation: (registers, spill store bytes, spill load bytes)}``
    of the kernels ``names`` in an nvcc ``-Xptxas -v`` log (``<D, K>``:
    the term count, 0 at run time, and the pairs a vote; ``*`` a kernel
    that is no template)."""
    import re

    lines = build_log.splitlines()
    out = {}
    for k, line in enumerate(lines):
        entry = re.search(r"Compiling entry function '(_Z\w+)'", line)
        if not entry or not any(n in entry.group(1) for n in names):
            continue
        name = next(n for n in names if n in entry.group(1))
        args = re.search(re.escape(name) + r"I((?:Li\d+E)+)E", entry.group(1))
        info = " ".join(lines[k + 1:k + 4])
        regs = re.search(r"Used (\d+) registers", info)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", info)
        out[f"{name}<{template_args(args.group(1)) if args else '*'}>"] = (
            int(regs.group(1)) if regs else None,
            *(int(v) for v in (spill.groups() if spill else (-1, -1))))
    return out


def sass_counts(lib_path, names=("f2n_wide_kernel", "n2f_wide_kernel"),
                opcodes=("FFMA", "FMUL", "FADD", "FRND", "MUFU", "LDS", "LDG", "LDGSTS", "SHFL",
                         "BAR", "F2I", "I2F")):
    """Static counts of ``opcodes`` in the SASS of each function of the
    library ``lib_path`` whose name holds one of ``names`` (cuobjdump
    -sass), with the function's instruction count as ``"all"``; None where
    the toolkit has no cuobjdump."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True).stdout
    out, current = {}, None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = next((n for n in names if n in head.group(1)), None)
            args = re.search(r"I((?:Li\d+E)+)E", head.group(1))
            current = (f"{name}<{template_args(args.group(1)) if args else '*'}>" if name
                       else None)
            if current:
                out[current] = dict.fromkeys(("all",) + opcodes, 0)
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if current and op:
            out[current]["all"] += 1
            base = op.group(1)
            if base in out[current]:
                out[current][base] += 1
    return out


def wide_inputs(device, x5, D, n_spots=None, cache=False):
    """Config 5's plane at D Zernike terms (ANSI 0, 1, ...: the basis on
    config 5's SLM), the first ``n_spots`` of its spots (all 256 by
    default) with their tilt and focus coefficients (``x5``'s rows, ANSI 2,
    1, 4), the other terms uniform in +-1.5 rad (Z1's sweep) and piston 0;
    seeded fields, and the cos/sin cache where ``cache``."""
    from slmsuite_torch.hardware.slms.simulated import SimulatedSLM
    from slmsuite_torch.ops import compressed as C

    slm = SimulatedSLM(resolution=(CONFIG5_RES, CONFIG5_RES), pitch_um=(8, 8), wav_um=0.78)
    basis = torch.from_numpy(C.build_zernike_basis(np.arange(D), slm)).to(device)
    c5 = x5["coeffs"].cpu().numpy()[:, :n_spots]
    coeffs = np.random.default_rng(D).uniform(-1.5, 1.5, (D, c5.shape[1])).astype(np.float32)
    coeffs[0] = 0.0
    coeffs[[2, 1, 4]] = c5
    x = compressed_inputs(device, D, basis.shape[1], c5.shape[1], seed=D, basis=basis,
                          coeffs=torch.from_numpy(coeffs).to(device))
    if cache:
        x["kc"], x["ks"] = C.build_kernel_cache(x["coeffs"], x["basis"])
    return x


def sincos_phases(n=65536, seed=7):
    """``(x, sets)``: ``n`` f32 phases, the first half within 1e-3 of a
    half period (k + 1/2) 2 pi, |k| < 15,000, the second uniform within
    +-REDUCED_LIMIT; ``sets`` their masks: near a half with x - k 2 pi
    within [-pi, pi], past +-pi (where k, the f32 product x kInv2Pi
    rounded, is the farther integer: the reduction folds these), and
    uniform (as tests/test_torch_cuda.py's test_compressed_sincos_past_pi
    draws them)."""
    from slmsuite_torch.ops import cuda_compressed as K

    rng = np.random.default_rng(seed)
    half = n // 2
    k = rng.integers(-15_000, 15_000, half)
    near = (2 * np.pi * (k + 0.5 + rng.uniform(-1e-3, 1e-3, half))).astype(np.float32)
    uniform = rng.uniform(-K.REDUCED_LIMIT, K.REDUCED_LIMIT, n - half).astype(np.float32)
    x = np.concatenate([near, uniform])
    x64 = x.astype(np.float64)
    past = np.abs(x64 - np.round(x * np.float32(K.INV_2PI)).astype(np.float64) * 2 * np.pi) > np.pi
    first = np.arange(n) < half
    return x, {"near a half, |y| <= pi": first & ~past, "past pi": past,
               "uniform": ~first}


def sincos_errors(module, device, D, x):
    """|error| against float64 of the kernels' sincos on the f32 phases
    ``x`` (a power of 4 of them), as ``module``'s f2n forms it at D terms:
    one spot of farfield 1, the phase the first basis row (the other terms
    zero, so it is exact), the output times P^1/2 (exact)."""
    P = x.size
    basis, coeffs = np.zeros((D, P), np.float32), np.zeros((D, 1), np.float32)
    basis[0], coeffs[0] = x, 1.0
    dev = lambda a: torch.from_numpy(a).to(device)
    nfr, nfi = module.f2n(dev(np.ones(1, np.float32)), dev(np.zeros(1, np.float32)),
                          dev(coeffs), dev(basis))
    c, s = (t.double().cpu().numpy() * P**0.5 for t in (nfr, nfi))
    x64 = x.astype(np.float64)
    return np.maximum(np.abs(c - np.cos(x64)), np.abs(s - np.sin(x64)))


def compressed_wide_ab(device, parent_root):
    """The wide f2n and n2f of this tree against the parent's (the port
    unpacked at ``parent_root``), in one process: both builds timed, each
    tree's registers and spills of every wide instantiation (ptxas) and,
    where the toolkit has cuobjdump, their SASS opcode counts; then at
    WIDE_AB_TERMS on config 5's plane and spots, and at Z1's 97 spots at 21
    terms, each kernel's outputs within CMP_RTOL of the parent's and of the
    plain version, and their times in turns parent, this, this, parent,
    twice (:meth:`ab_medians`: medians of four), beside the bound; before
    them each tree's sincos against float64 on :meth:`sincos_phases`
    (:meth:`sincos_errors`, through f2n at 1 and 17 terms). Writes
    ``compressed_ab.json``."""
    from slmsuite_torch.ops import compressed as C
    from slmsuite_torch.ops import cuda_compressed as K
    from slmsuite_torch.ops import cuda_fft

    parent = parent_port(parent_root)
    parent_lib, seconds, parent_log = parent.cuda_fft.build()
    parent._lib()
    log(f"build: parent's library in {seconds:.1f} s (this tree's: the build line above)")
    ptxas = {"this": wide_ptxas((OUT / "ptxas.log").read_text()),
             "parent": wide_ptxas(parent_log)}
    for who, kernels in ptxas.items():
        for tag, (regs, stores, loads) in kernels.items():
            log(f"  ptxas {who} {tag}: {regs} registers, spill stores {stores} B, "
                f"loads {loads} B")
    sass = {"this": sass_counts(cuda_fft.build()[0]), "parent": sass_counts(parent_lib)}
    for who, kernels in sass.items():
        for tag, counts in (kernels or {}).items():
            log(f"  SASS {who} {tag}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    x, sets = sincos_phases()
    sincos = {}
    for D in (1, 17):  # f2n_kernel, f2n_wide_kernel
        errors = {who: sincos_errors(mod, device, D, x) for who, mod in (("this", K),
                                                                         ("parent", parent))}
        for name, mask in sets.items():
            worst = {who: float(e[mask].max()) for who, e in errors.items()}
            sincos[f"D {D}, {name}"] = worst
            log(f"sincos D {D}, {name} ({int(mask.sum())} phases), max |error| against "
                f"float64: this {worst['this']:.3e}, parent {worst['parent']:.3e}")
    del x
    _, _, x5 = config5_inputs(device)
    shapes = [(D, None) for D in WIDE_AB_TERMS] + [(21, WIDE_AB_Z1_SPOTS)]
    rows = []
    for D, n_spots in shapes:
        x = wide_inputs(device, x5, D, n_spots)
        N, P = x["coeffs"].shape[1], x["basis"].shape[1]
        ff, nf, cb = (x["ffr"], x["ffi"]), (x["nfr"], x["nfi"]), (x["coeffs"], x["basis"])
        cases = {
            "f2n": (lambda m: (lambda: m.f2n(*ff, *cb)),
                    lambda: C._farfield_to_nearfield(*ff, *cb)),
            "n2f": (lambda m: (lambda: m.n2f(*nf, *cb)),
                    lambda: C._nearfield_to_farfield(*nf, *cb)),
        }
        for name, (call, plain) in cases.items():
            calls = {"this": call(K), "parent": call(parent)}
            K.reset_launch_counts()
            got = calls["this"]()
            assert K.WIDE_LAUNCHES[name] == 1, (name, D, K.WIDE_LAUNCHES)
            ref = plain()
            e_parent = max(rel_err(a, b) for a, b in zip(got, calls["parent"]()))
            e_plain = max(rel_err(a, b) for a, b in zip(got, ref))
            assert e_parent <= CMP_RTOL and e_plain <= CMP_RTOL, (name, D, N, e_parent, e_plain)
            tag = f"{name} D {D}, N {N}, P {P}"
            this_ms, parent_ms = ab_medians(tag, calls)
            bound_ms, bound_by = compressed_bound(name, D, N, P, 0)
            log(f"A/B {tag}: this {this_ms:.4f} ms, parent {parent_ms:.4f} ms "
                f"({parent_ms / this_ms:.3f}x); {bound_ms / this_ms:.3f} of the bound "
                f"({bound_ms * 1e3:.1f} us, {bound_by}), parent {bound_ms / parent_ms:.3f}; "
                f"outputs within rel {e_parent:.2e} of the parent's, {e_plain:.2e} of plain")
            rows.append({"kernel": name, "D": D, "N": N, "P": P, "ms": this_ms,
                         "parent_ms": parent_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                         "rel_parent": e_parent, "rel_plain": e_plain})
        del x
        torch.cuda.empty_cache()
    card = nvidia_smi_line()
    (OUT / "compressed_ab.json").write_text(json.dumps(
        {"card": card, "rows": rows, "ptxas": ptxas, "sass": sass, "sincos": sincos}, indent=1))
    log(f"  [{card}]")


def z3_hologram(device):
    """Z3's hologram: a Z3_SIDE^2 array of spots on config 5's 1024^2
    SimulatedSLM in the Zernike basis ANSI 0 .. Z3_TERMS - 1: the tilt and
    focus rows (ANSI 2, 1, 4) of config 5's kxy spots (kx, ky in [-8e-3,
    8e-3], focus uniform in [-2e-6, 2e-6], default_rng(0)), the other terms
    uniform in +-1.5 rad (default_rng(Z3_TERMS)), piston 0; from a seeded
    phase."""
    import warnings

    from slmsuite_torch.hardware.slms.simulated import SimulatedSLM
    from slmsuite_torch.holography import toolbox
    from slmsuite_torch.holography.algorithms import CompressedSpotHologram

    slm = SimulatedSLM(resolution=(CONFIG5_RES, CONFIG5_RES), pitch_um=(8, 8), wav_um=0.78)
    edge = np.linspace(-8e-3, 8e-3, Z3_SIDE)
    kx, ky = np.meshgrid(edge, edge)
    kxy = np.vstack([kx.ravel(), ky.ravel(),
                     np.random.default_rng(0).uniform(-2e-6, 2e-6, kx.size)])
    spots = np.random.default_rng(Z3_TERMS).uniform(-1.5, 1.5, (Z3_TERMS, kx.size))
    spots[0] = 0.0
    spots[[2, 1, 4]] = toolbox.convert_vector(kxy, "kxy", "zernike", hardware=slm)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # piston in the basis
        holo = CompressedSpotHologram(spots, basis=np.arange(Z3_TERMS), cameraslm=slm,
                                      device=device)
    holo.reset_phase(np.random.default_rng(1).uniform(-np.pi, np.pi, slm.shape))
    return holo


def z3_drive(device):
    """Z3 once through whatever the dispatchers take: a fresh hologram,
    the launch counts set to 0 just before its Z3_ITERS iterations of
    WGS-Kim with computational_spot feedback and stats. Returns ``(launches,
    wide launches, final efficiency, uniformity, amp_ff / max, weights /
    max, seconds)``."""
    from slmsuite_torch.ops import cuda_compressed, cuda_fft

    holo = z3_hologram(device)
    assert not holo._kernel_cache_enabled(), "Z3's cache rule took the cache"
    cuda_compressed.reset_launch_counts()
    cuda_fft.reset_launch_counts()
    start = time.perf_counter()
    holo.optimize("WGS-Kim", maxiter=Z3_ITERS, feedback="computational_spot",
                  stat_groups=["computational_spot"], verbose=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    assert not any(cuda_fft.LAUNCHES.values()), cuda_fft.LAUNCHES
    assert holo.iter == Z3_ITERS, holo.iter
    launched = {k: v for k, v in cuda_compressed.LAUNCHES.items() if v}
    wide = {k: v for k, v in cuda_compressed.WIDE_LAUNCHES.items() if v}
    stats = holo.stats["stats"]["computational_spot"]
    amp, weights = np.asarray(holo.amp_ff), np.asarray(holo.weights)
    assert np.isfinite(amp).all() and np.isfinite(weights).all()
    return (launched, wide, float(stats["efficiency"][-1]), float(stats["uniformity"][-1]),
            amp / amp.max(), weights / weights.max(), seconds)


def z3_kernel_checks(device, consts):
    """The wide f2n (scaled, and the amplitude replacement with an
    amplitude plane) and n2f (normalized, and the unnormalized sum) at the
    main path's shapes: on Z3's own basis and coefficients (``consts``: P
    1024^2, N Z3_SIDE^2, D Z3_TERMS) and at ZERNIKE_TIMING_TERMS terms on
    config 5's plane with its 256 spots and with Z1's 97 (:meth:`wide_inputs`),
    seeded fields. The wide launch counts are set to 0 just before each
    call and must read one wide launch of it; each output is held to its
    plain version within CMP_RTOL (the replacement as X0 holds the carry
    kernels', :meth:`conditioned`: where the plain f32 version is itself
    further than that from float64, near a zero of the sum, against float64
    within twice its error), and the scaled f2n and n2f against float64
    (:meth:`check_float64`). Writes ``parity_z3.log``."""
    from slmsuite_torch.ops import compressed as C
    from slmsuite_torch.ops import cuda_compressed as K

    (D, N), P = consts["coeffs"].shape, consts["basis"].shape[1]
    cases = {f"Z3 P {P}, N {N}, D {D}": compressed_inputs(
        device, D, P, N, seed=N + D, basis=consts["basis"], coeffs=consts["coeffs"])}
    _, _, x5 = config5_inputs(device)
    for n_spots in (None, WIDE_AB_Z1_SPOTS):
        x = wide_inputs(device, x5, ZERNIKE_TIMING_TERMS, n_spots)
        Dx, Nx = x["coeffs"].shape
        cases[f"config 5's plane P {x['basis'].shape[1]}, N {Nx}, D {Dx}"] = x
    del x5
    lines = []
    for tag, x in cases.items():
        ff, nf, cb = (x["ffr"], x["ffi"]), (x["nfr"], x["nfi"]), (x["coeffs"], x["basis"])
        calls = {
            "f2n": (lambda: K.f2n(*ff, *cb), lambda: C._farfield_to_nearfield(*ff, *cb)),
            "f2n replace": (lambda: K.f2n(*ff, *cb, amp=x["amp"]),
                            lambda: C._farfield_to_nearfield(*ff, *cb, amp=x["amp"])),
            "n2f": (lambda: K.n2f(*nf, *cb), lambda: C._nearfield_to_farfield(*nf, *cb)),
            "n2f unnormalized": (lambda: K.n2f(*nf, *cb, normalize=False),
                                 lambda: C._nearfield_to_farfield(*nf, *cb, normalize=False)),
        }
        for name, (kernel, plain) in calls.items():
            K.reset_launch_counts()
            got = kernel()
            wide = {k: v for k, v in K.WIDE_LAUNCHES.items() if v}
            assert wide == {name.split()[0]: 1}, (tag, name, wide)
            if name == "f2n replace":
                conditioned(f"{tag} {name}", got, plain(), lambda: C._farfield_to_nearfield(
                    *(t.double() for t in (*ff, *cb)), amp=x["amp"].double()), lines)
                continue
            e = max(rel_err(a, b) for a, b in zip(got, plain()))
            assert e <= CMP_RTOL, f"{tag} {name}: rel {e:.3e}"
            lines.append(f"{tag} {name}: rel {e:.3e}")
        check_float64(tag, "scalar", x, 1.0, lines, names=("f2n", "n2f"))
        torch.cuda.empty_cache()
    OUT.mkdir(exist_ok=True)
    (OUT / "parity_z3.log").write_text("\n".join(lines) + "\n")
    log(f"Z3 kernel checks: {len(lines)} passed, each call one wide launch (parity_z3.log)")
    for line in lines:
        log(f"  {line}")


def phase_z3(device, parent=None):
    """Z3 through the kernels (with the cache off by the port's own rule,
    each iteration one wide f2n with the amplitude replacement and one wide
    n2f: exact launches) and through the plain versions (final efficiency
    and uniformity, normalized amp_ff and weights within CMP_PATH_ATOL);
    each wide kernel held to its plain version and to float64 at Z3's
    shapes and at config 5's (:meth:`z3_kernel_checks`); then ms an
    iteration of its engine loop through the kernels and the plain versions
    in turns plain, kernels, kernels, plain, and, with ``parent``
    (:meth:`parent_port`'s module), through the parent's kernels in turns
    parent, this, this, parent. Returns the launches."""
    from slmsuite_torch.ops import compressed as C
    from slmsuite_torch.ops import cuda_compressed as K

    n = Z3_ITERS
    expect = dict(f2n=n + 1, n2f=n + 2)  # entry n2f; f2n + n2f an iteration; exit f2n; finalize n2f
    launched, wide, eff, uni, amp, weights, seconds = z3_drive(device)
    log(f"Z3 {Z3_SIDE}x{Z3_SIDE} spots, {Z3_TERMS} terms, {CONFIG5_RES}^2 (kernels): "
        f"{seconds:.2f} s, launches {launched}, wide {wide}, efficiency {eff:.6f}, "
        f"uniformity {uni:.6f}")
    assert launched == expect and wide == expect, (launched, wide, expect)
    with plain_compressed():
        p_launched, _, p_eff, p_uni, p_amp, p_weights, p_seconds = z3_drive(device)
    assert not p_launched, p_launched
    errors = {"efficiency": abs(eff - p_eff), "uniformity": abs(uni - p_uni),
              "amp_ff": float(np.abs(amp - p_amp).max()),
              "weights": float(np.abs(weights - p_weights).max())}
    log(f"Z3 (plain): {p_seconds:.2f} s, efficiency {p_eff:.6f}, uniformity {p_uni:.6f}; "
        "kernels against plain: " + ", ".join(f"{k} {v:.3e}" for k, v in errors.items()))
    assert max(errors.values()) < CMP_PATH_ATOL, errors

    holo = z3_hologram(device)
    holo._update_flags("WGS-Kim", False, "computational_spot", [])
    config = holo._compressed_config(kernel_cache=False)
    consts = holo._compressed_consts(kernel_cache=False)
    state = holo._compressed_state()
    z3_kernel_checks(device, consts)

    def run(k):
        return C.run_compressed_gs(config, state, consts, k)

    with plain_compressed():
        p1 = loop_ms(run, Z3_TIMING_ITERS)
    k1, k2 = loop_ms(run, Z3_TIMING_ITERS), loop_ms(run, Z3_TIMING_ITERS)
    with plain_compressed():
        p2 = loop_ms(run, Z3_TIMING_ITERS)
    log(f"Z3 run({Z3_TIMING_ITERS}): kernels {k1:.4f} {k2:.4f} ms/iter, plain {p1:.4f} "
        f"{p2:.4f} ms/iter  [{nvidia_smi_line()}]")
    if parent is not None:
        names = ("f2n", "n2f", "fused_iter")
        ours = {name: getattr(K, name) for name in names}

        @contextlib.contextmanager
        def parents():
            for name in names:
                setattr(K, name, getattr(parent, name))
            try:
                yield
            finally:
                for name, fn in ours.items():
                    setattr(K, name, fn)

        readings = {"this": [], "parent": []}
        for _ in range(2):
            for who in ("parent", "this", "this", "parent"):
                with parents() if who == "parent" else contextlib.nullcontext():
                    readings[who].append(loop_ms(run, Z3_TIMING_ITERS))
        medians = {who: float(np.median(r)) for who, r in readings.items()}
        log(f"A/B Z3 run({Z3_TIMING_ITERS}), ms/iter, this tree's kernels against the "
            "parent's, one process: this " + " ".join(f"{v:.4f}" for v in readings["this"])
            + ", parent " + " ".join(f"{v:.4f}" for v in readings["parent"])
            + f"; medians {medians['this']:.4f} / {medians['parent']:.4f}  "
            f"[{nvidia_smi_line()}]")
    return launched


# ----------------------------------------------------------------------
# The forward half of the psi -> psi WGS step: cols_wgs_fwd, and Q1.
# ----------------------------------------------------------------------


#: Shapes of the parity checks of cols_wgs_fwd: the main path's first, then
#: the line FFT's shortest and longest columns (4096 points on a cluster of
#: two blocks) and a rectangle.
FWD_SHAPES = ((2048, 2048), (256, 512), (64, 64), (4096, 4096))


def phase_fwd_parity(device):
    """``cols_wgs_fwd`` against its plain version at FWD_SHAPES for every
    rule, Kim on and off, stats on and off (stats off also selects the
    stored angle), scalar and array amplitude, with one all-zero column of
    the carry, and the composed ``wgs_fused_forward``; returns the kernel's
    2048^2 max |diff|. On the zero column F = 0 and its phase is 0 (the
    constrained field w' + 0i): the plain version's arg of a zero that the
    FFT may hold as -0 is +-pi there, so that column is held to the
    convention and the rest of the plane to the plain version."""
    from slmsuite_torch.ops import cuda_fft, fft

    worst = {"cols_wgs_fwd": 0.0}
    lines = []

    def compare(tag, got, ref, amp_ff, kim, cols=slice(None)):
        e = max(rel_err(got[k][:, cols], ref[k][:, cols]) for k in (0, 1))
        assert e <= CARRY_RTOL, f"{tag}/re, im: {e:.3e}"
        ew = check_close(tag + "/w", got[2], ref[2], WEIGHT_ATOL, WEIGHT_RTOL)
        et = 0.0
        if kim:
            et = theta_err(got[3], ref[3], amp_ff)
            assert et < THETA_ATOL, f"{tag}/phase_ff: {et:.3e}"
        else:
            assert got[3] is None, tag
        assert got[4].dtype == torch.float64, tag
        es = check_close(tag + "/sums", got[4], ref[4], WEIGHT_ATOL, WEIGHT_RTOL)
        em = check_close(tag + "/maxs", got[5], ref[5], WEIGHT_ATOL, WEIGHT_RTOL)
        lines.append(f"{tag}: re, im rel {e:.3e} w {ew:.3e} phase_ff {et:.3e} "
                     f"sums {es:.3e} maxs {em:.3e}")
        return max(max_abs(got[0][:, cols], ref[0][:, cols]),
                   max_abs(got[1][:, cols], ref[1][:, cols]), ew)

    for shape in FWD_SHAPES:
        off_zero = torch.arange(shape[1], device=device) != 1
        for amp_kind in ("scalar", "array"):
            for stats_on in (True, False):
                x = step_inputs(shape, amp_kind, "kim", stats_on, device)
                angle = torch.atan2(x["phase_ff"][1], x["phase_ff"][0])
                gr, gi = fft._wgs_carry_entry(x["psi"], x["amp"])
                gr[:, 1], gi[:, 1] = 0.0, 0.0
                amp_ff = fft._fft2_polar_from_phase(x["psi"], x["amp"])[0]
                amp_ff[:, 1] = 0.0
                for rule in RULES:
                    for kim in (True, False):
                        kw = dict(rule=rule, kim=kim, stats_on=stats_on)
                        pff = angle if kim else None
                        args = (gr, gi, x["weights"] * 1.3, x["target"], x["mask"], pff,
                                x["scal"])
                        tag = (f"cols_wgs_fwd {shape} {amp_kind} {rule} kim={kim} "
                               f"stats={stats_on}")
                        got = cuda_fft.cols_wgs_fwd(*args, **kw)
                        own_phase = not (kim and not stats_on)
                        err = compare(tag, got, fft._cols_wgs_fwd(*args, **kw), amp_ff, kim,
                                      off_zero if own_phase else slice(None))
                        if own_phase:  # F = 0: the phase is 0, the field w' + 0i
                            assert torch.equal(got[0][:, 1], got[2][:, 1]), tag
                            assert float(got[1][:, 1].abs().max()) == 0.0, tag
                            if kim:
                                assert float(got[3][:, 1].abs().max()) == 0.0, tag
                        if kim and not stats_on:
                            assert torch.equal(got[3], angle), tag  # The stored angle.
                        if not stats_on:
                            assert got[4][:3].tolist() == [0.0, 0.0, 0.0], tag
                            assert bool((got[5] == -3.0e38).all()), tag
                        if shape == FWD_SHAPES[0]:
                            worst["cols_wgs_fwd"] = max(worst["cols_wgs_fwd"], err)
                        whole = (x["psi"], x["amp"], x["weights"] * 1.3, pff, x["target"],
                                 x["mask"], x["scal"])
                        compare("wgs_fused_forward" + tag[12:],
                                fft.wgs_fused_forward(*whole, **kw),
                                fft._wgs_fused_forward(*whole, **kw),
                                fft._fft2_polar_from_phase(x["psi"], x["amp"])[0], kim)
        del x, gr, gi, amp_ff, angle, got
    torch.cuda.synchronize()
    OUT.mkdir(exist_ok=True)
    (OUT / "parity_fwd.log").write_text("\n".join(lines) + "\n")
    log(f"forward-half parity: {len(lines)} checks passed; 2048^2 max |diff| "
        f"cols_wgs_fwd {worst['cols_wgs_fwd']:.3e}")
    return worst


def two_halves_loop(holo, n, mode):
    """``n`` iterations of WGS-Kim with computational stats from
    ``holo``'s planes, the step scalars, the deferred norm and Kim's
    decision formed as the fused step forms them. ``mode="halves"``: each
    iteration is ``wgs_fused_forward`` then ``ifft2_phase``;
    ``mode="step"``: ``wgs_fused_step``. Returns ``(state, stats (n, 2,
    4))``."""
    from slmsuite_torch.ops import engine, fft

    holo._update_flags("WGS-Kim", False, None, ["computational"])
    config = holo._build_config()
    consts = engine._augment_fused_consts(config, holo._build_consts(config))
    state = engine._provision_fused(config, holo._build_state(config))
    kw = dict(rule="kim", kim=True, stats_on=True)
    rows = []
    for _ in range(n):
        args = (state.psi, consts["amp"], state.weights, state.phase_ff, consts["target"],
                consts["_stat_mask_f32"], engine._carry_scalars(state, consts))
        if mode == "halves":
            re, im, weights, pff, sums, maxs = fft.wgs_fused_forward(*args, **kw)
            psi = fft.ifft2_phase(re, im)
        else:
            psi, weights, pff, sums, maxs = fft.wgs_fused_step(*args, **kw)
        state, stats = engine._carry_finish(config, state, consts, psi, weights, pff,
                                            state.zero_weights, sums, maxs)
        rows.append(stats)
    return engine._finalize_fused(config, state), torch.stack(rows)


def phase_q1(device):
    """Q1: the two-halves loop through the kernels (exact launch counts),
    through the plain versions, and ``wgs_fused_step`` iterated; returns
    the kernels' launches."""
    from slmsuite_torch.ops import cuda_fft, fft

    n = Q1_ITERS

    def make():
        return spot_array(device, (32, 32), (30, 30))

    def counted(mode):
        holo = make()
        cuda_fft.reset_launch_counts()
        start = time.perf_counter()
        out = two_halves_loop(holo, n, mode)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        return out, {k: v for k, v in cuda_fft.LAUNCHES.items() if v}, seconds

    (state, stats), launches, seconds = counted("halves")
    expect = dict(carry_entry=n, cols_wgs_fwd=n, cols_fft=n, carry_exit=n)
    log(f"Q1 two halves WGS-Kim 2048^2 (kernels): efficiency {float(stats[-1, 0, 0]):.6f} "
        f"uniformity {float(stats[-1, 0, 1]):.6f} in {seconds:.2f} s; launches {launches}")
    assert launches == expect, (launches, expect)
    assert bool(torch.isfinite(state.psi).all()) and state.psi.shape == (2048, 2048)
    assert bool(torch.isfinite(stats).all()) and 0 < float(stats[-1, 0, 0]) <= 1

    with plain_versions(fft, ("wgs_fused_forward", "ifft2_phase")):
        (p_state, p_stats), p_launches, _ = counted("halves")
    assert not p_launches, p_launches
    (s_state, s_stats), s_launches, _ = counted("step")
    assert s_launches == dict(carry_entry=n, cols_wgs_roundtrip=n, carry_exit=n), s_launches

    # Kim's store is compared on the spots, where the loop reads it: off
    # them it holds the angle of a near-zero field, which is arbitrary.
    spots = state.weights > 0
    for label, other, other_stats in (("plain", p_state, p_stats),
                                      ("wgs_fused_step", s_state, s_stats)):
        d_stats = float((stats[:, 0, :2] - other_stats[:, 0, :2]).abs().max())
        d_fixed = float((stats[:, 1, 1] - other_stats[:, 1, 1]).abs().max())
        d_psi = psi_p99(state.psi, other.psi)
        d_w = float((state.weights - other.weights).abs().max() / other.weights.max())
        d_store = float(wrapped_abs(state.phase_ff, other.phase_ff)[spots].max())
        log(f"Q1 kernels vs {label}: efficiency, uniformity max |diff| over {n} iterations "
            f"{d_stats:.3e}; psi p99 {d_psi:.3e} rad; weights / max {d_w:.3e}; Kim store on "
            f"the spots {d_store:.3e} rad")
        assert d_stats <= SLICE_ATOL, (label, d_stats)
        assert d_fixed == 0, (label, "fixed_phase history differs")
        assert d_psi < Q1_PSI_P99 and d_w < Q1_WEIGHT_ATOL and d_store < Q1_STORE_ATOL, label
    return launches


# ----------------------------------------------------------------------
# The simulated camera in the loop: BASELINE config 4.
# ----------------------------------------------------------------------


def s2_spots():
    edge = (np.arange(S2_SIDE) - (S2_SIDE - 1) / 2) * S2_PITCH + 256.0
    xs, ys = np.meshgrid(edge, edge)
    return np.vstack((xs.ravel(), ys.ravel()))


def config4(device, spots=None):
    """BASELINE config 4's rig and hologram (``spots`` None: its four
    spots), the initial phase from seed 0."""
    from slmsuite_torch.models.engine_models import camera_loop_wgs

    return camera_loop_wgs(spot_ij=spots, seed=0, device=device)


def measured(holo):
    """The camera's spot statistics of ``holo``'s current phase, and the
    spot weights over their maximum."""
    stats = {}
    holo._midloop_cleaning()
    holo._populate_stats(stats, ["experimental_spot"])
    weights = np.asarray(holo.weights)[holo.spot_knm_rounded[1], holo.spot_knm_rounded[0]]
    return stats["experimental_spot"], weights / weights.max()


def phase_calibration_check(device):
    """The analytic Fourier calibration, checked on the card without
    OpenCV: the projected 5x5 grid's spots lie where the calibration puts
    them in the camera frame (brightest pixel within 2 of each window's
    centre)."""
    from slmsuite_torch.holography import analysis
    from slmsuite_torch.models.engine_models import camera_loop_rig

    fs = camera_loop_rig(device=device)
    fs.fourier_calibrate_analytic(fs.cam.M, fs.cam.b)
    np.random.seed(0)  # fourier_grid_project draws its initial phase.
    holo = fs.fourier_grid_project(array_shape=5, array_pitch=16, verbose=False)
    exposure = 1.0
    for _ in range(24):
        fs.cam.set_exposure(exposure)
        img = fs.cam.get_image()
        if img.max() < fs.cam.bitresolution - 1:
            break
        exposure /= 2  # Saturated: a plateau has no brightest pixel.
    centers = fs.kxyslm_to_ijcam(holo.spot_kxy_rounded)
    width = 15
    windows = analysis.take(img, centers, width, centered=True, integrate=False)
    peaks = np.array([np.unravel_index(np.argmax(w), w.shape) for w in windows])
    offset = np.abs(peaks - width // 2).max()
    log(f"Fourier calibration (analytic), 5x5 grid projected: {len(windows)} spots, "
        f"brightest pixel at most {offset} px from its window's centre (limit 2), peak "
        f"{int(windows.max())} counts at exposure {exposure}")
    assert len(windows) == 23 and offset <= 2 and windows.max() > 20, (offset, windows.max())


def phase_s0(device):
    """S0: the device measurement against the host image path on config 4,
    on the seeded phase (exposure raised so the speckle has counts) and on
    the phase after the warm-up."""
    from slmsuite_torch.holography import analysis
    from slmsuite_torch.ops import cuda_fft

    fs, holo = config4(device)
    pixels = holo.spot_integration_width_ij ** 2
    for label, exposure in (("seeded phase", 200.0), ("after the warm-up", 1.0)):
        if exposure == 1.0:
            holo.optimize("WGS-Kim", maxiter=CONFIG4_WARM, verbose=False)
        fs.cam.set_exposure(exposure)
        holo._midloop_cleaning()
        cuda_fft.reset_launch_counts()
        fast, fast_total = holo._sim_spot_powers()
        assert cuda_fft.LAUNCHES["rows_fft"] == 1 and cuda_fft.LAUNCHES["cols_fft"] == 1
        holo.measure("ij")
        pwr_img = np.square(np.asarray(holo.img_ij, np.float64))
        host = analysis.take(pwr_img, holo.spot_ij, holo.spot_integration_width_ij,
                             centered=True, integrate=True)
        d_spots = float(np.abs(fast - host).max())
        d_total = abs(fast_total - float(pwr_img.sum()))
        log(f"S0 {label}, exposure {exposure}: spot powers {np.round(host).tolist()} counts, "
            f"device vs host max |diff| {d_spots:.1f} (limit {pixels}: one count per window "
            f"pixel), total {pwr_img.sum():.0f} |diff| {d_total:.1f}")
        assert host.min() > 0 and d_spots <= pixels and d_total <= pwr_img.size, label


def drive_camera(device, spots):
    """Config 4 on ``spots``: the warm-up, then the camera loop with the
    launch counts set to 0 just before it. Returns ``(holo, measured
    after the warm-up, measured after the loop, loop launches, launches
    after the loop, seconds of the camera loop)``."""
    _, holo = config4(device, spots)
    holo.optimize("WGS-Kim", maxiter=CONFIG4_WARM, verbose=False)
    warm = measured(holo)
    split = launches_split_at_populate(holo)
    start = time.perf_counter()
    holo.optimize("WGS-Kim", maxiter=CONFIG4_ITERS, verbose=False,
                  feedback="experimental_spot", stat_groups=["experimental_spot"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    loop, after = split()
    return holo, warm, measured(holo), loop, after, seconds


def run_camera_path(label, device, spots):
    """One camera path through the kernels (exact loop launches) and
    through the plain versions (no launch); measured uniformity and
    efficiency after the loop and the spot weights agree within the
    camera limits, and the loop ends no less uniform than the warm-up."""
    n = CONFIG4_ITERS
    holo, warm, final, loop, after, seconds = drive_camera(device, spots)
    log(f"{label} (kernels): after the warm-up uniformity {warm[0]['uniformity']:.6f} "
        f"efficiency {warm[0]['efficiency']:.6f}; after {n} camera iterations uniformity "
        f"{final[0]['uniformity']:.6f} efficiency {final[0]['efficiency']:.6f} in "
        f"{seconds:.2f} s; loop launches {loop}; after the loop {after}")
    # Per iteration: the padded forward (rows_fft, cols_fwd_polar) and
    # backward (cols_wexp_inv, rows_fft) transforms, and the camera's
    # canvas transform (rows_fft, cols_fft).
    expect = dict(rows_fft=3 * n, cols_fwd_polar=n, cols_wexp_inv=n, cols_fft=n)
    assert loop == expect, (label, loop, expect)
    assert holo._build_config().feedback == "experimental_spot_sim"
    recorded = holo.stats["stats"]["experimental_spot"]["uniformity"]
    assert len(recorded) == CONFIG4_WARM + n and np.isfinite(recorded[CONFIG4_WARM:]).all()
    phase = holo.get_phase()
    assert phase.shape == (512, 512) and np.isfinite(phase).all()
    # No worse than the warm-up, to the camera's resolution: spot powers
    # are sums of integer counts (S1's four start exactly equal).
    assert final[0]["uniformity"] >= warm[0]["uniformity"] - CAMERA_STAT_ATOL, (
        label, warm[0], final[0])
    with plain_step_functions():
        _, _, plain_final, plain_loop, plain_after, _ = drive_camera(device, spots)
    assert not plain_loop and not plain_after, (plain_loop, plain_after)
    d_w = float(np.abs(final[1] - plain_final[1]).max())
    log(f"{label} (plain):   uniformity {plain_final[0]['uniformity']:.6f} efficiency "
        f"{plain_final[0]['efficiency']:.6f}; spot weights / max |diff| {d_w:.3e}")
    for key in ("uniformity", "efficiency"):
        diff = abs(final[0][key] - plain_final[0][key])
        assert diff <= CAMERA_STAT_ATOL, f"{label} {key}: kernel vs plain differ by {diff:.3e}"
    assert d_w <= CAMERA_WEIGHT_ATOL, (label, d_w)
    return {k: loop.get(k, 0) + after.get(k, 0) for k in {*loop, *after}}


def camera_engine_loop(holo):
    """The engine inputs of the camera loop of ``holo``, and a function
    that runs ``n`` iterations from them."""
    from slmsuite_torch.ops import engine

    holo._update_flags("WGS-Kim", False, "experimental_spot", ["experimental_spot"])
    config = holo._build_config()
    consts = holo._build_consts(config)
    state = holo._build_state(config)
    return lambda n: engine.run_gs(config, state, consts, n)


def host_transfers(run, n):
    """Host-to-device and device-to-host copies among the device events
    of ``run(n)`` under ``torch.profiler``. The profiler keeps only some
    pageable copies, and now and then a window of no device event at all:
    such a window is profiled again, at most twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        run(2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(n)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if names:
            break
    assert names, "torch.profiler recorded no device events in three windows"
    return [name for name in names if "HtoD" in name or "DtoH" in name], len(names)


def host_syncs(run, n):
    """The times ``run(n)`` made the host wait on the card, as torch's sync
    debug mode reports them: every copy between host and card that is not
    ``non_blocking`` (a pageable upload, ``.item()``, ``.cpu()``) and every
    other synchronizing call. Counted on the host, so none is lost; the
    profiler's memcpy records (:func:`host_transfers`) are a lower bound,
    since it keeps only some pageable copies."""
    import warnings

    run(2)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run(n)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchronizing CUDA operation" in str(w.message) for w in caught)


def phase_camera(device):
    """The calibration check, S0, S1 and S2; then, for S1 and S2, the
    engine loop alone: host transfers (none allowed), ms/iteration through
    the kernels and the plain versions, and ``sim_measure_spots`` alone.
    Returns the S2 engine loop for the profile."""
    from slmsuite_torch.ops import engine

    phase_calibration_check(device)
    phase_s0(device)
    run_camera_path("S1 config 4 WGS-Kim, 4 spots, camera feedback", device, None)
    run_camera_path("S2 config 4 rig WGS-Kim, 10x10 spots, camera feedback", device,
                    s2_spots())
    loops = {}
    for label, spots in (("S1 config 4, 4 spots", None), ("S2 config 4 rig, 10x10 spots",
                                                           s2_spots())):
        _, holo = config4(device, spots)
        holo.optimize("WGS-Kim", maxiter=CONFIG4_WARM, verbose=False)
        run = loops[label] = camera_engine_loop(holo)
        copies, events = host_transfers(run, CONFIG4_ITERS)
        log(f"{label}: {len(copies)} host transfers among {events} device events of "
            f"run({CONFIG4_ITERS})")
        assert not copies, (label, copies[:5])
        with plain_step_functions():
            p1 = loop_ms(run, CONFIG4_ITERS)
        k1 = loop_ms(run, CONFIG4_ITERS)
        k2 = loop_ms(run, CONFIG4_ITERS)
        with plain_step_functions():
            p2 = loop_ms(run, CONFIG4_ITERS)
        consts, statics = holo._sim_engine_inputs()
        consts = {**consts, "sim_scale": holo._sim_scale()}
        psi = type(holo)._psi.device(holo, device)
        sim_k = cuda_ms(lambda: engine.sim_measure_spots(psi, consts, **statics))
        with plain_step_functions():
            sim_p = cuda_ms(lambda: engine.sim_measure_spots(psi, consts, **statics))
        log(f"{label} run({CONFIG4_ITERS}): kernels {k1:.4f} {k2:.4f} ms/iter, plain "
            f"{p1:.4f} {p2:.4f} ms/iter; sim_measure_spots alone {sim_k:.4f} ms "
            f"({sim_k / ((k1 + k2) / 2):.3f} of the iteration), on the plain transform "
            f"{sim_p:.4f} ms  [{nvidia_smi_line()}]")
    return loops["S2 config 4 rig, 10x10 spots"]


# ----------------------------------------------------------------------
# The stepwise host loop: H1-H3.
# ----------------------------------------------------------------------


def launches_split_at(holo, at="_populate_results"):
    """As :meth:`launches_split_at_populate`, for both counters: set
    ``cuda_fft``'s and ``cuda_compressed``'s launch counts to 0 and note
    them when ``holo``'s method ``at`` starts (``_populate_results``, or the
    compressed engine's ``_finalize_scan_fused``: where an ``optimize``
    call's loop ends). Returns a function giving ``(loop launches, launches
    after the loop)`` over both."""
    from slmsuite_torch.ops import cuda_compressed, cuda_fft

    def counts():
        return {**cuda_fft.LAUNCHES, **cuda_compressed.LAUNCHES}

    method = getattr(holo, at)
    at_start = {}

    def counted(*args, **kwargs):
        at_start.update(counts())
        return method(*args, **kwargs)

    def split():
        now = counts()
        after = {k: v - at_start[k] for k, v in now.items() if v - at_start[k]}
        return {k: v for k, v in at_start.items() if v}, after

    setattr(holo, at, counted)
    cuda_fft.reset_launch_counts()
    cuda_compressed.reset_launch_counts()
    return split


def wall_ms(run, n):
    """Wall milliseconds per iteration of ``run(n)`` after one warm-up
    iteration, the card synchronized at both ends (a host-paced loop
    waits on the card every iteration)."""
    run(1)
    torch.cuda.synchronize()
    start = time.perf_counter()
    run(n)
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3 / n


def host_loop_timing(label, run, n):
    """ms per host iteration of ``run(n)`` through the kernels and the
    plain versions, interleaved (plain, kernels, kernels, plain), and the
    host transfers per iteration under the profiler (logged: the loop is
    host-paced by design)."""
    with plain_step_functions(), plain_compressed():
        p1 = wall_ms(run, n)
    k1, k2 = wall_ms(run, n), wall_ms(run, n)
    with plain_step_functions(), plain_compressed():
        p2 = wall_ms(run, n)
    copies, events = host_transfers(run, n)
    log(f"{label}: kernels {k1:.3f} {k2:.3f} ms per host iteration, plain {p1:.3f} "
        f"{p2:.3f}; {len(copies) / n:.2f} host transfers per iteration ({len(copies)} "
        f"among {events} device events of {n} iterations)  [{nvidia_smi_line()}]")
    return {"kernels_ms": (k1, k2), "plain_ms": (p1, p2), "transfers": len(copies) / n}


def camera_noise(seed):
    """H1's camera noise: dark counts (Poisson) and read noise (Gaussian,
    positive mean), from one generator made from ``seed``."""
    rng = np.random.default_rng(seed)
    return {"dark": lambda x: rng.poisson(0.005 * x),
            "read": lambda x: rng.normal(0.004 * x, 0.001 * x)}


def h1_rig(device):
    """H1: config 4's rig with S2's 10x10 spots, the camera given dark and
    read noise and averaging; the device measurement does not model it."""
    fs, holo = config4(device, s2_spots())
    fs.cam.noise = camera_noise(H1_NOISE_SEED)
    fs.cam.averaging = H1_AVERAGING
    assert holo._sim_engine_inputs() is None
    return fs, holo


def h1_optimize(holo, n):
    holo.optimize("WGS-Kim", maxiter=n, verbose=False, feedback="experimental_spot",
                  stat_groups=["computational_spot", "experimental_spot"])


def drive_h1(device):
    """H1 once: the warm-up on the engine, then the host loop with the
    launch counts split at ``_populate_results``. Returns ``(holo, measured
    after the warm-up, measured after the loop, loop launches, launches
    after it, seconds of the loop)``."""
    _, holo = h1_rig(device)
    holo.optimize("WGS-Kim", maxiter=CONFIG4_WARM, verbose=False)
    warm = measured(holo)
    split = launches_split_at(holo)
    start = time.perf_counter()
    h1_optimize(holo, H1_ITERS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    loop, after = split()
    return holo, warm, measured(holo), loop, after, seconds


def phase_h1(device):
    """H1 through the kernels (exact launches per host iteration) and
    through the plain versions, from the same seed and noise draws; held
    on what users read (PERF.md section 2)."""
    n, a = H1_ITERS, H1_AVERAGING
    label = "H1 config 4 rig, noise and averaging, 10x10 spots, host loop"
    holo, warm, final, loop, after, seconds = drive_h1(device)
    # Per host iteration: the padded forward fft2, one camera frame of
    # `averaging` captures (one canvas fft2 each), the backward
    # wexp_ifft2_phase.
    expect = dict(rows_fft=(1 + a) * n, cols_fft=(1 + a) * n, cols_wexp_inv=n, carry_exit=n)
    log(f"{label} (kernels): after the warm-up uniformity {warm[0]['uniformity']:.6f} "
        f"efficiency {warm[0]['efficiency']:.6f}; after {n} host iterations uniformity "
        f"{final[0]['uniformity']:.6f} efficiency {final[0]['efficiency']:.6f} in "
        f"{seconds:.2f} s; loop launches {loop}; after the loop {after}")
    assert loop == expect, (label, loop, expect)
    assert holo._build_config().feedback == "external_spot"
    recorded = holo.stats["stats"]["experimental_spot"]["uniformity"]
    assert len(recorded) == CONFIG4_WARM + n and np.isfinite(recorded[CONFIG4_WARM:]).all()
    assert np.isfinite(holo.get_phase()).all()
    assert final[0]["uniformity"] >= warm[0]["uniformity"] - CAMERA_STAT_ATOL, (warm, final)
    with plain_step_functions():
        _, _, plain_final, plain_loop, plain_after, _ = drive_h1(device)
    assert not plain_loop and not plain_after, (plain_loop, plain_after)
    d_w = float(np.abs(final[1] - plain_final[1]).max())
    log(f"{label} (plain):   uniformity {plain_final[0]['uniformity']:.6f} efficiency "
        f"{plain_final[0]['efficiency']:.6f}; spot weights / max |diff| {d_w:.3e}")
    for key in ("uniformity", "efficiency"):
        diff = abs(final[0][key] - plain_final[0][key])
        assert diff <= CAMERA_STAT_ATOL, f"{label} {key}: kernel vs plain differ by {diff:.3e}"
    assert d_w <= CAMERA_WEIGHT_ATOL, (label, d_w)
    host_loop_timing("H1 host loop", lambda k: h1_optimize(holo, k), HOST_TIMING_ITERS)
    return {k: v / n for k, v in loop.items()}


def h2_optimize(holo, maxiter, stop, seen):
    def callback(h):
        series = h.stats["stats"].get("computational", {}).get("efficiency", [])
        seen.append(series[-1] if series else float("nan"))
        return stop is not None and h.iter == stop

    holo.optimize("WGS-Kim", maxiter=maxiter, verbose=False, stat_groups=["computational"],
                  callback=callback)


def drive_h2(device):
    holo = spot_array(device, (32, 32), (30, 30))
    split = launches_split_at(holo)
    seen = []
    h2_optimize(holo, H2_MAXITER, H2_STOP, seen)
    torch.cuda.synchronize()
    loop, after = split()
    stats = holo.stats["stats"]["computational"]
    return holo, {k: float(stats[k][-1]) for k in ("efficiency", "uniformity")}, loop, after, seen


def phase_h2(device):
    """H2: the fused path's hologram through ``SpotHologram.optimize`` with
    a callback that records the efficiency and stops at iteration 30."""
    n = H2_STOP
    label = "H2 2048^2 32x32 spots WGS-Kim, callback stops at 30, host loop"
    holo, kernel_stats, loop, after, seen = drive_h2(device)
    log(f"{label} (kernels): {kernel_stats}; callback saw {len(seen)} calls; loop "
        f"launches {loop}; after the loop {after}")
    assert holo.iter == n and len(holo.stats["stats"]["computational"]["efficiency"]) == n
    assert len(seen) == n + 1 and np.isfinite(seen[1:]).all()
    # Per host iteration: fft2 forward, wexp_ifft2_phase backward; the
    # stopping iteration runs the forward only.
    expect = dict(rows_fft=n + 1, cols_fft=n + 1, cols_wexp_inv=n, carry_exit=n)
    assert loop == expect, (label, loop, expect)
    with plain_step_functions():
        _, plain_stats, plain_loop, plain_after, _ = drive_h2(device)
    assert not plain_loop and not plain_after, (plain_loop, plain_after)
    log(f"{label} (plain):   {plain_stats}")
    for key in kernel_stats:
        diff = abs(kernel_stats[key] - plain_stats[key])
        assert diff <= SLICE_ATOL, f"{label} {key}: kernel vs plain differ by {diff:.3e}"
    engine = spot_array(device, (32, 32), (30, 30))
    engine.optimize("WGS-Kim", maxiter=n, verbose=False, stat_groups=["computational"])
    engine_stats = engine.stats["stats"]["computational"]
    log(f"H2 against the device engine's own {n} iterations: "
        + ", ".join(f"{k} |diff| {abs(kernel_stats[k] - float(engine_stats[k][-1])):.3e}"
                    for k in kernel_stats))
    host_loop_timing("H2 host loop", lambda k: h2_optimize(holo, k, None, []),
                     HOST_TIMING_ITERS)
    # Per complete iteration: the stopped one's forward aside.
    stopped = dict(rows_fft=1, cols_fft=1)
    return {k: (v - stopped.get(k, 0)) / n for k, v in loop.items()}


def h3_hologram(device):
    """H3: config 5 with C3's 64 nan ``spot_amp``."""
    n_spots = CONFIG5_SIDE**2
    spot_amp = np.ones(n_spots)
    spot_amp[np.random.default_rng(2).permutation(n_spots)[:n_spots // 4]] = np.nan
    return config5_hologram(device, spot_amp=spot_amp)


def h3_mraf(holo, n):
    holo.optimize("WGS-Kim", maxiter=n, verbose=False, zero_factor=0.1,
                  stat_groups=["computational_spot"])


def h3_external(holo, n):
    holo.optimize("WGS-Kim", maxiter=n, verbose=False, feedback="external_spot",
                  stat_groups=["computational_spot", "external_spot"])


def drive_h3(device):
    """H3 once: the zero_factor MRAF host loop, then the external_spot host
    loop on the amplitudes the first computed. Returns ``(holo, launches
    of each loop and after it, amp_ff / max, weights / max)``."""
    holo = h3_hologram(device)
    launches = []
    for run, n in ((h3_mraf, H3_MRAF_ITERS), (h3_external, H3_EXTERNAL_ITERS)):
        split = launches_split_at(holo)
        run(holo, n)
        torch.cuda.synchronize()
        launches.append(split())
        del holo._populate_results  # The class's again.
        holo.external_spot_amp = np.array(holo.amp_ff)
    amp, weights = np.asarray(holo.amp_ff), np.asarray(holo.weights)
    return holo, launches, amp / amp.max(), weights / weights.max()


def phase_h3(device):
    """H3: config 5's compressed MRAF host loop (zero_factor) and its
    external_spot loop, through the kernels (exact launches) and the plain
    versions (normalized amp_ff and weights within 2e-3)."""
    label = "H3 config 5 compressed host loop"
    holo, launches, amp, weights = drive_h3(device)
    for (loop, after), n, what in zip(launches, (H3_MRAF_ITERS, H3_EXTERNAL_ITERS),
                                      ("zero_factor MRAF", "external_spot")):
        log(f"{label}, {what} (kernels): {n} iterations; loop launches {loop}; after the "
            f"loop {after}")
        assert loop == dict(n2f=n, f2n=n), (what, loop)
        assert after == dict(n2f=1), (what, after)
    assert holo.iter == H3_MRAF_ITERS + H3_EXTERNAL_ITERS
    assert np.isfinite(holo.get_phase()).all() and np.isfinite(amp).all()
    assert holo._zero_weights_c is not None
    with plain_step_functions(), plain_compressed():
        _, plain_launches, plain_amp, plain_weights = drive_h3(device)
    assert not any(loop or after for loop, after in plain_launches), plain_launches
    e_amp = float(np.abs(amp - plain_amp).max())
    e_w = float(np.abs(weights - plain_weights).max())
    log(f"{label} (plain): normalized amp_ff max |diff| {e_amp:.3e}, weights {e_w:.3e}")
    assert e_amp < CMP_PATH_ATOL and e_w < CMP_PATH_ATOL, (label, e_amp, e_w)
    host_loop_timing("H3 host loop, external_spot", lambda k: h3_external(holo, k),
                     HOST_TIMING_ITERS)
    return {k: v / H3_MRAF_ITERS for k, v in launches[0][0].items()}


def phase_host_loop(device):
    """H1, H2 and H3; returns each path's kernel launches per host
    iteration."""
    per_iteration = {"H1": phase_h1(device), "H2": phase_h2(device), "H3": phase_h3(device)}
    for path, counts in per_iteration.items():
        assert counts and all(v > 0 for v in counts.values()), (path, counts)
        log(f"{path} launches per host iteration: {counts}")
    return per_iteration


# ----------------------------------------------------------------------
# The batched multiplane slice: the kernels' plane dimension and P1-P4.
# ----------------------------------------------------------------------

#: Stacks (B, H, W) of the batched kernel checks: P1's 8 planes of 1024^2
#: first, then the shortest columns, a rectangle, the clustered 4096-point
#: columns and long rows.
STACK_SHAPES = ((8, 1024, 1024), (3, 64, 64), (3, 256, 512), (2, 4096, 4096), (3, 2048, 128))
#: The kernels that take a (B, H, W) stack in one launch.
STACK_KERNELS = ("carry_entry", "cols_fwd_polar", "cols_wexp_inv", "cols_fft", "rows_fft")
#: P1-P4 at the full width of bench.py's bench_batch_scaling: 8 planes (or
#: frames) of 1024^2. P1 and P2 run 50 iterations, P3 30 batched then 5 on
#: the host meta loop, P4 20.
MP_PLANES, MP_SIDE, MP_ITERS = 8, 1024, 50
P3_ITERS, P3_HOST_ITERS, P4_ITERS = 30, 5, 20
#: Plane counts of P1's ms an iteration, and the iterations each reading runs.
MP_TIMING_PLANES, MP_TIMING_ITERS = (1, 2, 4, 8), 20
#: The side of the kernel table's times, at which the batched kernels are
#: timed too (beside P1's).
TABLE_SIDE = 2048


def stack_inputs(shape, device, seed=0):
    rng = np.random.default_rng(seed)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)

    return dict(xr=dev(rng.standard_normal(shape)), xi=dev(rng.standard_normal(shape)),
                psi=dev(rng.uniform(-4 * np.pi, 4 * np.pi, shape)),
                w=dev(rng.uniform(0, 1, shape)), phi=dev(rng.uniform(-np.pi, np.pi, shape)),
                amp=dev(0.5 + rng.uniform(0, 1, shape[1:])))


def stack_calls(x):
    """Name -> (the kernel on the stacks, the kernel on plane b, the plain
    version on the stacks)."""
    from slmsuite_torch.ops import cuda_fft, fft

    xr, xi, psi, w, phi, amp = (x[k] for k in ("xr", "xi", "psi", "w", "phi", "amp"))
    return {
        "carry_entry (amplitude plane)": (
            lambda: cuda_fft.carry_entry(psi, amp), lambda b: cuda_fft.carry_entry(psi[b], amp),
            lambda: fft._wgs_carry_entry(psi, amp)),
        "carry_entry": (
            lambda: cuda_fft.carry_entry(psi, 0.5), lambda b: cuda_fft.carry_entry(psi[b], 0.5),
            lambda: fft._wgs_carry_entry(psi, 0.5)),
        "cols_fwd_polar": (
            lambda: cuda_fft.cols_fwd_polar(xr, xi, 0.25),
            lambda b: cuda_fft.cols_fwd_polar(xr[b], xi[b], 0.25),
            lambda: fft._cols_fwd_polar(xr, xi, 0.25)),
        "cols_wexp_inv": (
            lambda: cuda_fft.cols_wexp_inv(w, phi),
            lambda b: cuda_fft.cols_wexp_inv(w[b], phi[b]),
            lambda: fft._cols_wexp_inv(w, phi)),
        "cols_fft": (
            lambda: cuda_fft.cols_fft(xr, xi, inverse=True, scale=0.5),
            lambda b: cuda_fft.cols_fft(xr[b], xi[b], inverse=True, scale=0.5),
            lambda: fft._cols_fft(xr, xi, inverse=True, scale=0.5)),
        "rows_fft": (
            lambda: cuda_fft.rows_fft(xr, xi, inverse=False, scale=0.5),
            lambda b: cuda_fft.rows_fft(xr[b], xi[b], inverse=False, scale=0.5),
            lambda: fft._rows_fft(xr, xi, inverse=False, scale=0.5)),
    }


def phase_batched_parity(device):
    """Each kernel that takes a (B, H, W) stack, at STACK_SHAPES: one launch
    for the stack, equal bit for bit to B launches on its planes, and
    within CARRY_RTOL of the plain version on the stack (``arg F``: within
    THETA_ATOL where ``|F| > 1e-3 max |F|``). Returns the largest |diff|
    against the plain version at P1's stack, by kernel."""
    from slmsuite_torch.ops import cuda_fft

    worst, lines = {}, []
    for shape in STACK_SHAPES:
        for name, (batched, single, plain) in stack_calls(stack_inputs(shape, device)).items():
            kernel = name.split()[0]
            cuda_fft.reset_launch_counts()
            got = batched()
            torch.cuda.synchronize()
            launched = {k: v for k, v in cuda_fft.LAUNCHES.items() if v}
            assert launched == {kernel: 1}, (name, shape, launched)
            planes = [single(b) for b in range(shape[0])]
            for g, parts in zip(got, zip(*planes)):
                assert g.shape == shape and torch.equal(g, torch.stack(parts)), (name, shape)
            ref = plain()
            if kernel == "cols_fwd_polar":
                e = rel_err(got[0], ref[0])
                on = ref[0] > 1e-3 * ref[0].amax(dim=(-2, -1), keepdim=True)
                et = float(wrapped_abs(got[1], ref[1])[on].max())
                assert e <= CARRY_RTOL and et < THETA_ATOL, (name, shape, e, et)
                diff = max(max_abs(got[0], ref[0]), et)
                lines.append(f"{name} {shape}: {shape[0]} planes in one launch, equal to "
                             f"{shape[0]} launches; |F| rel {e:.3e}, arg F max {et:.3e}")
            else:
                e = max(rel_err(g, r) for g, r in zip(got, ref))
                assert e <= CARRY_RTOL, (name, shape, e)
                diff = max(max_abs(g, r) for g, r in zip(got, ref))
                lines.append(f"{name} {shape}: {shape[0]} planes in one launch, equal to "
                             f"{shape[0]} launches; rel {e:.3e}")
            if shape == STACK_SHAPES[0]:
                worst[name] = diff
            del got, planes, ref
    torch.cuda.synchronize()
    (OUT / "parity_batched.log").write_text("\n".join(lines) + "\n")
    log(f"batched parity: {len(lines)} checks passed (each stack one launch, bit for bit "
        f"its planes' launches); {STACK_SHAPES[0]} max |diff| against plain "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return worst


def kernel_registers(names=("carry_entry_kernel", "cols_fwd_polar_", "cols_wexp_inv_",
                            "cols_fft_", "rows_fft_kernel")):
    """Registers, stack frame and spills of each instantiation of the
    kernels ``names``, from the build's ``ptxas.log`` (-Xptxas -v)."""
    import re

    path = OUT / "ptxas.log"
    if not path.exists():
        return []
    ptxas = path.read_text().splitlines()
    out = []
    for k, line in enumerate(ptxas):
        entry = re.search(r"Compiling entry function '(_Z\w+)'", line)
        if not entry or not any(n in entry.group(1) for n in names):
            continue
        info = " ".join(ptxas[k + 1:k + 4])
        regs = re.search(r"Used (\d+) registers", info)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                          r"spill loads", info)
        name = re.search(r"slm\d+(\w+?_kernel)", entry.group(1)).group(1)
        args = re.search(r"IL[ij](\d+)E(?:Lb([01]))?", entry.group(1))
        tag = f"{name}<{args.group(1)}" + (f", {args.group(2)}>" if args.group(2) else ">")
        out.append(f"{tag}: {regs.group(1) if regs else '?'} registers, "
                   + (f"{frame.group(1)} B stack, {frame.group(2)}/{frame.group(3)} B spill "
                      "stores/loads" if frame else "no frame line"))
    return out


def launch_ms(fn, n=20):
    """``(ms, timer)`` of the one kernel launch that ``fn`` makes: the
    median of the device's own durations of ``n`` calls' launches under the
    profiler (a window may lose events at its edges, which a median does
    not feel), or CUDA events where the profiler gives fewer than ``n / 2``
    of them (logged)."""
    fn()
    spans = device_spans(fn, n)
    if not n // 2 <= len(spans) <= n:
        log(f"  launch_ms: {len(spans)} device events for {n} launches; CUDA events instead")
        return cuda_ms(fn), "events"
    return float(np.median(spans)) / 1e3, "device"


def phase_batched_timing(device, B=MP_PLANES):
    """Each kernel that takes a stack on B planes in one launch, per plane,
    beside the same kernel on one plane (:meth:`launch_ms`, in turns), the
    plain version on the stack and, where one PyTorch call computes the
    same function, that call on the stack and on one plane; then the
    multiplane step's compositions likewise (:meth:`device_or_events`). At
    1024^2 (P1's planes) and 2048^2 (the kernel table's). Returns the
    readings."""
    from slmsuite_torch.ops import cuda_fft, fft

    out = {}
    for side in (MP_SIDE, TABLE_SIDE):
        shape = (side, side)
        x = stack_inputs((B, side, side), device)
        xr, xi, psi, w, phi = (x[k] for k in ("xr", "xi", "psi", "w", "phi"))
        z = torch.complex(xr, xi)
        zw = torch.complex(w * torch.cos(phi), w * torch.sin(phi))
        # name -> (on the stack, on one plane, plain on the stack, library on
        # the stack, library on one plane, planes moved, line FFT passes).
        timed = {
            "carry_entry": (lambda: cuda_fft.carry_entry(psi, 1.0),
                            lambda: cuda_fft.carry_entry(psi[0], 1.0),
                            lambda: fft._wgs_carry_entry(psi, 1.0), None, None, 3, 1),
            "cols_fwd_polar": (lambda: cuda_fft.cols_fwd_polar(xr, xi, 1.0),
                               lambda: cuda_fft.cols_fwd_polar(xr[0], xi[0], 1.0),
                               lambda: fft._cols_fwd_polar(xr, xi, 1.0), None, None, 4, 1),
            "cols_wexp_inv": (lambda: cuda_fft.cols_wexp_inv(w, phi),
                              lambda: cuda_fft.cols_wexp_inv(w[0], phi[0]),
                              lambda: fft._cols_wexp_inv(w, phi), None, None, 4, 1),
            "cols_fft": (lambda: cuda_fft.cols_fft(xr, xi, inverse=True),
                         lambda: cuda_fft.cols_fft(xr[0], xi[0], inverse=True),
                         lambda: fft._cols_fft(xr, xi, inverse=True),
                         lambda: torch.fft.ifft(z, dim=-2, norm="forward"),
                         lambda: torch.fft.ifft(z[0], dim=-2, norm="forward"), 4, 1),
            "rows_fft": (lambda: cuda_fft.rows_fft(xr, xi, inverse=True),
                         lambda: cuda_fft.rows_fft(xr[0], xi[0], inverse=True),
                         lambda: fft._rows_fft(xr, xi, inverse=True),
                         lambda: torch.fft.ifft(z, dim=-1, norm="forward"),
                         lambda: torch.fft.ifft(z[0], dim=-1, norm="forward"), 4, 1),
            # Row 6, the forward: psi read, |F| and arg F written.
            "fft2_polar_from_phase (carry_entry + cols_fwd_polar)": (
                lambda: cuda_fft.fft2_polar_from_phase(psi, 1.0),
                lambda: cuda_fft.fft2_polar_from_phase(psi[0], 1.0),
                lambda: fft._fft2_polar_from_phase(psi, 1.0), None, None, 3, 2),
            # Row 12, the backward: w and phi read, the pair written; the
            # library call is ifft2 of the complex plane w e^{i phi}.
            "wexp_ifft2 (cols_wexp_inv + rows_fft)": (
                lambda: cuda_fft.wexp_ifft2(w, phi), lambda: cuda_fft.wexp_ifft2(w[0], phi[0]),
                lambda: fft._wexp_ifft2(w, phi), lambda: torch.fft.ifft2(zw, norm="ortho"),
                lambda: torch.fft.ifft2(zw[0], norm="ortho"), 4, 2),
            # Row 5, the MRAF backward: the pair read and written.
            "ifft2 (cols_fft + rows_fft)": (
                lambda: cuda_fft.ifft2(xr, xi), lambda: cuda_fft.ifft2(xr[0], xi[0]),
                lambda: fft._ifft2(xr, xi), lambda: torch.fft.ifft2(z, norm="ortho"),
                lambda: torch.fft.ifft2(z[0], norm="ortho"), 4, 2),
        }
        for name, (kernel, one, plain, library, library_one, planes, passes) in timed.items():
            timer = launch_ms if name in STACK_KERNELS else device_or_events
            (k1, how), (o1, how1) = timer(kernel), timer(one)
            plain_ms, how_plain = device_or_events(plain)
            lib = lib1 = how_lib = None
            if library is not None:
                (lib, how_lib), (lib1, _) = device_or_events(library), device_or_events(library_one)
            (k2, _), (o2, _) = timer(kernel), timer(one)
            bound_ms, bound_by = bound(shape, planes, passes)
            per, one_ms = (k1 + k2) / 2 / B, (o1 + o2) / 2
            log(f"  {name} {side}^2: per plane at B = {B} {per:.4f} ms ({k1 / B:.4f}, "
                f"{k2 / B:.4f}; {bound_ms / per:.3f} of its bound, {bound_ms:.4f} ms by "
                f"{bound_by}), one plane {one_ms:.4f} ms ({o1:.4f}, {o2:.4f}); plain per "
                f"plane {plain_ms / B:.4f}"
                + (f"; library per plane {lib / B:.4f}, one plane {lib1:.4f}"
                   if library is not None else "") + f" (timers: {how}, {how1}; plain "
                f"{how_plain}" + (f"; library {how_lib}" if library is not None else "") + ")")
            out[(name, side)] = dict(per_plane=per, one_plane=one_ms, plain=plain_ms / B,
                                     library=None if lib is None else lib / B,
                                     library_one=lib1, bound=bound_ms)
        del x, xr, xi, psi, w, phi, z, zw, timed
    log(f"  [{nvidia_smi_line()}]")
    return out


def device_or_events(fn):
    """``(ms, timer)``: :meth:`device_ms` of ``fn``, or :meth:`cuda_ms`
    where the profiler gives no whole window (logged)."""
    try:
        return device_ms(fn), "device"
    except NoDeviceEvents as err:
        log(f"  {err}; CUDA events instead")
        return cuda_ms(fn), "events"


def frame_target(shape, t, n_spots=5, seed=0):
    """examples/batched_holography.py's frame ``t``: a spot array rotating
    with the frame index (a tweezer movie)."""
    rng = np.random.default_rng(seed)
    radii = rng.uniform(0.15, 0.35, n_spots) * shape[0]
    phases = rng.uniform(0, 2 * np.pi, n_spots)
    target = np.zeros(shape, np.float32)
    for r, p0 in zip(radii, phases):
        target[int(shape[0] / 2 + r * np.sin(p0 + 0.15 * t)),
               int(shape[1] / 2 + r * np.cos(p0 + 0.15 * t))] = 1.0
    return target / np.sqrt((target**2).sum())


def counted(fn):
    """``fn()`` with the launch counts set to 0 just before it; returns
    ``(result, launches, seconds)``."""
    from slmsuite_torch.ops import cuda_fft

    cuda_fft.reset_launch_counts()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in cuda_fft.LAUNCHES.items() if v}, time.perf_counter() - start


def phase_p1_p2(device):
    """P1 (WGS-Kim) and P2 (WGS-Kim, MRAF) through ``run_batched_gs`` on
    ``multiplane_batched(8, N=1024)``: exact launches, every iteration's
    per-plane efficiency and uniformity against the plain versions on the
    card, no host transfer in the loop; then P1's ms an iteration at B = 1,
    2, 4, 8, kernels and plain in turns. Returns P1's launches and run."""
    from slmsuite_torch.models.parallel_models import multiplane_batched

    n = MP_ITERS
    result = {}
    size = f"{MP_PLANES} x {MP_SIDE}^2"
    for label, mraf in ((f"P1 multiplane {size} WGS-Kim", False),
                        (f"P2 multiplane {size} WGS-Kim MRAF", True)):
        torch.cuda.reset_peak_memory_stats()
        run = multiplane_batched(MP_PLANES, N=MP_SIDE, mraf=mraf, device=device)
        (psi, _, stats, _, fixed), launches, seconds = counted(lambda: run(None, n))
        log(f"{label}: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        backward = dict(cols_fft=n) if mraf else dict(cols_wexp_inv=n)
        expect = dict(carry_entry=n, cols_fwd_polar=n, rows_fft=n, **backward)
        log(f"{label} (kernels): final efficiency {stats[-1, :, 0].tolist()}, uniformity "
            f"{stats[-1, :, 1].tolist()}, Kim fixed {fixed.tolist()} in {seconds:.2f} s; "
            f"launches {launches}")
        assert launches == expect, (label, launches, expect)
        assert psi.shape == (MP_SIDE, MP_SIDE) and bool(torch.isfinite(psi).all())
        assert bool(torch.isfinite(stats).all()) and bool((stats[-1, :, 0] > 0).all())
        with plain_step_functions():
            (_, _, plain, _, _), plain_launches, _ = counted(lambda: run(None, n))
        assert not plain_launches, plain_launches
        d = float((stats[:, :, :2] - plain[:, :, :2]).abs().max())
        log(f"{label} (plain): per-plane efficiency and uniformity max |diff| over {n} "
            f"iterations {d:.3e}")
        assert d <= SLICE_ATOL, (label, d)
        copies, events = host_transfers(lambda k: run(None, k), 5)
        log(f"{label}: {len(copies)} host transfers among {events} device events of run(5)")
        assert not copies, (label, copies[:5])
        result[label[:2]] = (launches, run)
    per_plane = {}
    for B in MP_TIMING_PLANES:
        run = multiplane_batched(B, N=MP_SIDE, device=device)
        loop = lambda k, run=run: run(None, k)  # noqa: E731
        with plain_step_functions():
            p1 = loop_ms(loop, MP_TIMING_ITERS)
        k1, k2 = loop_ms(loop, MP_TIMING_ITERS), loop_ms(loop, MP_TIMING_ITERS)
        with plain_step_functions():
            p2 = loop_ms(loop, MP_TIMING_ITERS)
        per_plane[B] = (k1 + k2) / 2 / B
        log(f"P1 B = {B} run({MP_TIMING_ITERS}): kernels {k1:.4f} {k2:.4f} ms/iter "
            f"({per_plane[B]:.4f} a plane), plain {p1:.4f} {p2:.4f} ms/iter "
            f"({(p1 + p2) / 2 / B:.4f} a plane)  [{nvidia_smi_line()}]")
    return result


def p3_hologram(device, seed=0):
    """P3: a MultiplaneHologram of 8 Hologram children on a 1024^2 SLM, each
    a 4x4 spot array at pitch 48 shifted 6 pixels a plane
    (tests/test_parallel.py's), behind a lens kernel pi d r^2 at its depth
    d = (b - 3.5) / 2 (r = 1 at the SLM's edge)."""
    from slmsuite_torch.holography.algorithms import Hologram, MultiplaneHologram

    N = MP_SIDE
    r = (np.arange(N) - N / 2) / (N / 2)
    r2 = (r[None, :] ** 2 + r[:, None] ** 2).astype(np.float32)
    children = []
    for b in range(MP_PLANES):
        target = np.zeros((N, N), np.float32)
        idx = ((np.arange(4) - 1.5) * 48 + N / 2 + 6 * b).astype(int)
        xs, ys = np.meshgrid(idx, idx)
        target[ys.ravel(), xs.ravel()] = 1.0
        kernel = np.float32(np.pi * (b - 3.5) / 2) * r2
        children.append(Hologram(target, slm_shape=(N, N), propagation_kernel=kernel,
                                 device=device))
    holo = MultiplaneHologram(children)
    holo.reset_phase(np.random.default_rng(seed).uniform(-np.pi, np.pi, (N, N)))
    return holo


def child_stats(holograms):
    """Final computational efficiency and uniformity of each hologram."""
    return np.array([[h.stats["stats"]["computational"][k][-1]
                      for k in ("efficiency", "uniformity")] for h in holograms])


def drive_p3(device):
    """P3 once: 30 batched iterations through ``optimize``, then 5 on the
    host meta loop (a callback). Returns ``(holo, per-child stats after
    each, launches (loop, after) of each)``."""
    holo = p3_hologram(device)
    out, launches = [], []
    for maxiter, callback in ((P3_ITERS, None), (P3_HOST_ITERS, lambda h: False)):
        split = launches_split_at_populate(holo)
        holo.optimize("WGS-Kim", maxiter=maxiter, verbose=False, callback=callback,
                      stat_groups=["computational"])
        torch.cuda.synchronize()
        launches.append(split())
        del holo._populate_results  # The class's again.
        out.append(child_stats(holo.holograms))
    return holo, out, launches


def phase_p3(device):
    """P3 through the kernels (exact launches of the batched run and of
    each host meta iteration) and the plain versions (per-child efficiency
    and uniformity within SLICE_ATOL); the batched loop's host transfers
    (none allowed) and ms an iteration; the meta loop's ms a host
    iteration. Returns the launches of the batched run."""
    from slmsuite_torch.parallel.multiplane import run_batched_gs

    label = f"P3 MultiplaneHologram {MP_PLANES} x {MP_SIDE}^2, lens kernels, WGS-Kim"
    start = time.perf_counter()
    holo, stats, launches = drive_p3(device)
    seconds = time.perf_counter() - start
    n, m, B = P3_ITERS, P3_HOST_ITERS, MP_PLANES
    (loop, after), (host_loop, host_after) = launches
    log(f"{label} (kernels) in {seconds:.2f} s: after {n} batched iterations efficiency "
        f"{stats[0][:, 0].tolist()}, uniformity {stats[0][:, 1].tolist()}; loop launches "
        f"{loop}, after {after}; {m} host meta iterations: loop launches {host_loop}, after "
        f"{host_after}")
    assert loop == dict(carry_entry=n, cols_fwd_polar=n, cols_wexp_inv=n, rows_fft=n), loop
    assert after == dict(rows_fft=1, cols_fft=1), after
    # Each child each host iteration: fft2 forward, wexp_ifft2 backward.
    assert host_loop == dict(rows_fft=2 * B * m, cols_fft=B * m, cols_wexp_inv=B * m), host_loop
    assert host_after == dict(rows_fft=1, cols_fft=1), host_after
    assert holo.iter == n + m and np.isfinite(holo.get_phase()).all()
    with plain_step_functions():
        _, plain, plain_launches = drive_p3(device)
    assert not any(a or b for a, b in plain_launches), plain_launches
    for what, got, ref in zip(("batched", "host meta loop"), stats, plain):
        d = float(np.abs(got - ref).max())
        log(f"{label} (plain), {what}: per-child efficiency and uniformity max |diff| {d:.3e}")
        assert d <= SLICE_ATOL, (label, what, d)

    fresh = p3_hologram(device)
    fresh._update_flags("WGS-Kim", False, None, ["computational"])
    config, psi, weights, consts, pff, fixed = fresh._batched_inputs()

    def batched(k):
        return run_batched_gs(config, psi, weights, consts, k, phase_ff=pff, fixed=fixed)

    copies, events = host_transfers(batched, 5)
    log(f"P3 batched loop: {len(copies)} host transfers among {events} device events of "
        "run(5)")
    assert not copies, copies[:5]
    with plain_step_functions():
        p1 = loop_ms(batched, MP_TIMING_ITERS)
    k1, k2 = loop_ms(batched, MP_TIMING_ITERS), loop_ms(batched, MP_TIMING_ITERS)
    with plain_step_functions():
        p2 = loop_ms(batched, MP_TIMING_ITERS)
    log(f"P3 batched run({MP_TIMING_ITERS}): kernels {k1:.4f} {k2:.4f} ms/iter, plain "
        f"{p1:.4f} {p2:.4f} ms/iter  [{nvidia_smi_line()}]")
    host_loop_timing("P3 host meta loop", lambda k: holo.optimize(
        "WGS-Kim", maxiter=k, verbose=False, callback=lambda h: False,
        stat_groups=["computational"]), m)
    return loop


def p4_frames(device):
    """P4: examples/batched_holography.py's 8 frames at 1024^2, each a
    Hologram warm-started from one seeded phase."""
    from slmsuite_torch.holography.algorithms import Hologram

    shape = (MP_SIDE, MP_SIDE)
    phase0 = np.random.default_rng(1).uniform(-np.pi, np.pi, shape).astype(np.float32)
    frames = []
    for t in range(MP_PLANES):
        h = Hologram(frame_target(shape, t), slm_shape=shape, device=device)
        h.reset_phase(phase0)
        frames.append(h)
    return frames


def drive_p4(device):
    from slmsuite_torch.holography.algorithms import optimize_batch

    frames = p4_frames(device)
    split = launches_split_at_populate(frames[0])
    start = time.perf_counter()
    optimize_batch(frames, "WGS-Kim", maxiter=P4_ITERS, verbose=False,
                   stat_groups=["computational"])
    torch.cuda.synchronize()
    return frames, split(), time.perf_counter() - start


def phase_p4(device):
    """P4: ``optimize_batch`` of 8 frames against 8 separate ``optimize``
    calls on the card (identical phase, weights and stats), with exact
    launches (each frame on the fused carry loop), and against the plain
    versions (per-frame efficiency and uniformity within SLICE_ATOL).
    Returns the loop's launches."""
    label = f"P4 optimize_batch {MP_PLANES} frames x {MP_SIDE}^2 WGS-Kim"
    n, K = P4_ITERS, MP_PLANES
    frames, (loop, after), seconds = drive_p4(device)
    stats = child_stats(frames)
    log(f"{label} (kernels) in {seconds:.2f} s: efficiency {stats[:, 0].tolist()}, "
        f"uniformity {stats[:, 1].tolist()}; loop launches {loop}, after {after}")
    assert loop == dict(carry_entry=K, cols_wgs_roundtrip=K * n, rows_normfwd=K * n,
                        carry_exit=K), loop
    assert after == dict(rows_fft=K, cols_fft=K), after
    solo = p4_frames(device)
    start = time.perf_counter()
    for h in solo:
        h.optimize("WGS-Kim", maxiter=n, verbose=False, stat_groups=["computational"])
    torch.cuda.synchronize()
    solo_seconds = time.perf_counter() - start
    for b, (h, s) in enumerate(zip(frames, solo)):
        assert np.array_equal(h.get_phase(), s.get_phase()), b
        assert np.array_equal(np.asarray(h.weights), np.asarray(s.weights)), b
        assert h.stats["stats"] == s.stats["stats"] and h.iter == s.iter == n, b
    log(f"{label}: phase, weights and stats of every frame identical to {K} separate "
        f"optimize calls ({seconds:.3f} s against {solo_seconds:.3f} s, first calls)")
    with plain_step_functions():
        plain_frames, (plain_loop, plain_after), _ = drive_p4(device)
    assert not plain_loop and not plain_after, (plain_loop, plain_after)
    d = float(np.abs(stats - child_stats(plain_frames)).max())
    log(f"{label} (plain): per-frame efficiency and uniformity max |diff| {d:.3e}")
    assert d <= SLICE_ATOL, (label, d)
    return loop


def phase_multiplane(device):
    """P1-P4; returns P1's and P2's launches, and P1's run for the profile."""
    p12 = phase_p1_p2(device)
    phase_p3(device)
    phase_p4(device)
    return {path: launches for path, (launches, _) in p12.items()}, p12["P1"][1]


# ----------------------------------------------------------------------
# Gradient phase retrieval: G1-G3.
# ----------------------------------------------------------------------


@contextlib.contextmanager
def plain_gradients():
    """Every transform plain, and gradient phase retrieval differentiated
    by torch's own autograd through the plain versions (``grad.fft2`` and
    ``grad.compressed_farfield`` swapped for their plain compositions): no
    kernel launches."""
    from slmsuite_torch.ops import compressed, fft, grad

    saved = grad.fft2, grad.compressed_farfield
    grad.fft2 = fft._fft2
    grad.compressed_farfield = lambda re, im, coeffs, basis: compressed._unit(
        *compressed._nearfield_to_farfield_raw(re, im, coeffs, basis))
    try:
        with plain_step_functions(), plain_compressed():
            yield
    finally:
        grad.fft2, grad.compressed_farfield = saved


def cg_gradient(holo):
    """The gradient of ``holo``'s CG loss at its current phase."""
    psi, loss_from_psi = holo._cg_objective()
    leaf = psi.detach().clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(loss_from_psi(leaf), leaf)
    return grad


def cg_optimize(holo, n, lr, callback=None, optimizer="adam", kwargs=None):
    """``n`` CG iterations of ``optimizer`` (Adam at learning rate ``lr``
    unless ``kwargs`` are given)."""
    kwargs = {"learning_rate": lr} if kwargs is None else kwargs
    holo.optimize("CG", maxiter=n, verbose=False, optimizer=optimizer, optimizer_kwargs=kwargs,
                  callback=callback)


def cg_final(holo):
    """What users read after a CG run: the spot amplitudes over their
    maximum (a compressed hologram), else the final efficiency and
    uniformity of the hologram or of each child of a multiplane one."""
    from slmsuite_torch.holography.algorithms import CompressedSpotHologram
    from slmsuite_torch.ops.stats import calculate_stats_numpy

    if isinstance(holo, CompressedSpotHologram):
        amp = np.asarray(holo.amp_ff)
        return amp / amp.max()
    holos = getattr(holo, "holograms", [holo])
    out = []
    for h in holos:
        if h is not holo:
            h._populate_results()
        stats = calculate_stats_numpy(np.asarray(h.amp_ff), np.asarray(h.target),
                                      efficiency_compensation=False)
        out.append([stats["efficiency"], stats["uniformity"]])
    return np.array(out)


def drive_cg(make, n, lr, **optimizer):
    """``n`` CG iterations on a fresh ``make()`` with both launch counts
    set to 0 just before (``optimizer``: :meth:`cg_optimize`'s). Returns
    ``(holo, losses, loop launches, launches after the loop, seconds)``."""
    holo = make()
    losses = []
    split = launches_split_at(holo)
    start = time.perf_counter()
    cg_optimize(holo, n, lr, lambda h: losses.append(h.flags["loss_result"]) and False,
                **optimizer)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    loop, after = split()
    del holo._populate_results  # The class's again.
    return holo, np.array(losses), loop, after, seconds


def run_cg_path(label, make, n, lr, loop_expect, after_expect, final_atol):
    """One CG path: through the kernels (exact launches in the loop and
    after it, peak device memory) and through torch's own autograd of the
    plain versions (no launch): the first iteration's gradient within
    CG_GRAD_RTOL of the largest, the loss at every iteration within
    CG_LOSS_RTOL, what users read within ``final_atol``; then the host
    syncs an iteration (one: the loss; :func:`host_syncs`, with the
    profiler's records no more than them) and ms an iteration, plain,
    kernels, kernels, plain. Returns ``(launches, the timed run)``."""
    torch.cuda.reset_peak_memory_stats()
    holo, losses, loop, after, seconds = drive_cg(make, n, lr)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{label} (kernels): loss {losses[0]:.6e} -> {losses[-1]:.6e} in {seconds:.2f} s; "
        f"loop launches {loop}, after the loop {after}; peak device memory {peak:.3f} GiB")
    assert loop == loop_expect, (label, loop, loop_expect)
    assert after == after_expect, (label, after, after_expect)
    assert holo.iter == n == len(losses) and np.isfinite(losses).all(), (label, holo.iter)
    assert np.isfinite(holo.get_phase()).all()
    final = cg_final(holo)
    grad = cg_gradient(make())
    with plain_gradients():
        plain_grad = cg_gradient(make())
        torch.cuda.reset_peak_memory_stats()
        plain, plain_losses, plain_loop, plain_after, plain_s = drive_cg(make, n, lr)
        plain_peak = torch.cuda.max_memory_allocated() / 2**30
        plain_final = cg_final(plain)
    assert not plain_loop and not plain_after, (plain_loop, plain_after)
    e_grad = float((grad - plain_grad).abs().max() / plain_grad.abs().max())
    e_loss = float(np.max(np.abs(losses - plain_losses) / np.abs(plain_losses)))
    e_final = float(np.abs(final - plain_final).max())
    log(f"{label} (plain autograd): {plain_s:.2f} s, peak device memory {plain_peak:.3f} GiB; "
        f"first gradient max |diff| / max {e_grad:.3e}, loss max relative diff {e_loss:.3e}, "
        f"final max |diff| {e_final:.3e} (kernels {final.ravel()[:4].tolist()}, plain "
        f"{plain_final.ravel()[:4].tolist()})")
    assert e_grad <= CG_GRAD_RTOL and e_loss <= CG_LOSS_RTOL, (label, e_grad, e_loss)
    assert e_final <= final_atol, (label, e_final)

    def run(k):
        cg_optimize(holo, k, lr)

    base, _ = host_transfers(run, 0)
    copies, events = host_transfers(run, HOST_TIMING_ITERS)
    sync_base, syncs = host_syncs(run, 0), host_syncs(run, HOST_TIMING_ITERS)
    per_iter = (syncs - sync_base) / HOST_TIMING_ITERS
    log(f"{label}: {per_iter:.2f} host syncs an iteration ({syncs} in {HOST_TIMING_ITERS} "
        f"iterations, {sync_base} in a call of none); the profiler kept {len(copies)} host "
        f"transfers among {events} device events of {HOST_TIMING_ITERS} iterations, "
        f"{len(base)} of a call of none")
    assert per_iter == 1, (label, per_iter)
    # Every transfer the profiler kept made the host wait: none is non_blocking.
    assert len(copies) <= syncs and len(base) <= sync_base, (label, copies, base)
    with plain_gradients():
        p1 = wall_ms(run, n)
    k1, k2 = wall_ms(run, n), wall_ms(run, n)
    with plain_gradients():
        p2 = wall_ms(run, n)
    log(f"{label} optimize(maxiter={n}): kernels {k1:.3f} {k2:.3f} ms an iteration, plain "
        f"autograd {p1:.3f} {p2:.3f}  [{nvidia_smi_line()}]")
    return {k: loop.get(k, 0) + after.get(k, 0) for k in {*loop, *after}}, run, holo


def phase_cg(device):
    """G1-G3, gradient phase retrieval (CG, Adam) through the kernels in
    both directions: G1, the fused slice's 2048^2 array through
    SpotHologram; G2, config 5 through CompressedSpotHologram; G3, P3's
    MultiplaneHologram. Returns each path's launches, G1's run and G1's
    final phase."""
    n1, n2, n3 = G1_ITERS, G2_ITERS, G3_ITERS
    fft2 = dict(rows_fft=1, cols_fft=1)
    g1, g1_run, g1_holo = run_cg_path(
        "G1 SpotHologram 2048^2 32x32 CG", lambda: g1_hologram(device),
        n1, G1_LR, dict(rows_fft=2 * n1, cols_fft=2 * n1), fft2, SLICE_ATOL)
    g2, _, _ = run_cg_path(
        "G2 config 5 CompressedSpotHologram CG", lambda: config5_hologram(device), n2, G2_LR,
        dict(n2f=n2, f2n=n2), dict(n2f=1), CMP_PATH_ATOL)
    B = MP_PLANES
    g3, _, _ = run_cg_path(
        f"G3 MultiplaneHologram {B} x {MP_SIDE}^2 CG", lambda: p3_hologram(device), n3, G3_LR,
        dict(rows_fft=2 * B * n3, cols_fft=2 * B * n3), fft2, SLICE_ATOL)
    return {"G1": g1, "G2": g2, "G3": g3}, g1_run, g1_holo.get_phase()


def g1_hologram(device):
    """G1's hologram: the fused slice's 2048^2 farfield, a 32x32 array."""
    return spot_array(device, (32, 32), (30, 30))


#: G4: the optimizers the port added to Adam, Adam-W, SGD, RMSprop and
#: Adagrad, each on G1's path for G4_ITERS iterations.
G4_RULES = (
    "adabelief", "adadelta", "adafactor", "adamax", "adamaxw", "adan", "amsgrad", "fromage",
    "lamb", "lars", "lion", "nadam", "nadamw", "noisy_sgd", "novograd", "optimistic_adam",
    "optimistic_adam_v2", "optimistic_gradient_descent", "radam", "rprop", "sign_sgd", "sm3",
    "yogi", "scale_by_learning_rate", "scale_by_rprop",
)
G4_ITERS = 10
#: optax's scale_by_rprop adds its steps (optax's rprop is it with the sign
#: flipped): CG with it climbs the loss, and the efficiency falls.
G4_UPHILL = ("scale_by_rprop",)


def g4_kwargs(name, s, side):
    """The ``optimizer_kwargs`` of each G4 rule, chosen so that G4_ITERS
    iterations raise G1's efficiency. On a ``side``^2 plane the per-pixel
    gradients of the unit-power loss are tiny (``s``, their rms at the
    initial phase, is near 1e-13 at 2048^2), so each epsilon that sits
    beside a gradient or its square is set to 1e-3 of ``s`` (or its
    square), and a rule that steps by the gradient itself (or, SM3, by
    it over its fixed 1e-8 epsilon's root) takes a learning rate over
    ``s``. Rules that act on signs, norms or ratios (Lion, signSGD,
    Rprop, LAMB, LARS, Fromage, Adafactor) keep their defaults but the
    rate; NovoGrad divides by the plane's norm, ``s * side``; RAdam
    rectifies only past ro 5, which at b2 0.9 it reaches by step 6; Yogi's
    first moment starts at 1e-6 everywhere, a common phase that b1 0
    drops. Fromage steps along the raw gradient scaled to psi's norm and
    shrinks psi by ``1 - 1/sqrt(1 + lr**2)``: at 2048^2 on an H100 no
    rate in 0.005-0.4 raised the efficiency by more than 5% in 10
    iterations (0.1 the most), so it is held to a rise only."""
    e = 1e-3 * s
    return {
        "adabelief": dict(learning_rate=0.05, eps=e, eps_root=0.0),
        "adadelta": dict(learning_rate=30.0 / s, eps=e * e),
        "adafactor": dict(learning_rate=0.05),
        "adamax": dict(learning_rate=0.05, eps=e),
        "adamaxw": dict(learning_rate=0.05, eps=e),
        "adan": dict(learning_rate=0.05, eps=e, eps_root=0.0),
        "amsgrad": dict(learning_rate=0.05, eps=e),
        "fromage": dict(learning_rate=0.1),
        "lamb": dict(learning_rate=0.05, eps=e),
        "lars": dict(learning_rate=0.05, trust_coefficient=1.0),
        "lion": dict(learning_rate=0.05),
        "nadam": dict(learning_rate=0.05, eps=e),
        "nadamw": dict(learning_rate=0.05, eps=e),
        "noisy_sgd": dict(learning_rate=0.1 / s, eta=(0.1 * s) ** 2, key=0),
        "novograd": dict(learning_rate=0.05 * side, eps=e * side),
        "optimistic_adam": dict(learning_rate=0.05, eps=e),
        "optimistic_adam_v2": dict(learning_rate=0.05, eps=e),
        "optimistic_gradient_descent": dict(learning_rate=0.1 / s),
        "radam": dict(learning_rate=0.3, b2=0.9, eps=e),
        "rprop": dict(learning_rate=0.03),
        "sign_sgd": dict(learning_rate=0.05),
        "sm3": dict(learning_rate=3e-5 / s),
        "yogi": dict(learning_rate=1.6e-3 / s, b1=0.0),
        "scale_by_learning_rate": dict(learning_rate=0.1 / s),
        "scale_by_rprop": dict(learning_rate=0.01),
    }[name]


def phase_g4(device, make=None, n=G4_ITERS):
    """G4: each optimizer the port added, on G1's path (the 2048^2 32x32
    array through SpotHologram, CG) through the kernels and through torch's
    autograd of the plain versions on the card (:func:`cg_rule_run`): exact
    launches (rows_fft and cols_fft 2n in the loop, one each after it), one
    host sync an iteration, the efficiency risen from the initial phase's
    (fallen for G4_UPHILL), final efficiency and uniformity within
    SLICE_ATOL of the plain run's, and ms an iteration. Returns the
    launches over all rules."""
    make = make or (lambda: g1_hologram(device))
    start = time.perf_counter()
    s, side, initial = cg_start(make, "G4")
    total = {}
    for name in G4_RULES:
        counts, _, _ = cg_rule_run(
            f"G4 {name}", make, n, name, g4_kwargs(name, s, side),
            dict(rows_fft=2 * n, cols_fft=2 * n), dict(rows_fft=1, cols_fft=1), SLICE_ATOL,
            initial, rise=name not in G4_UPHILL)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    log(f"G4: {len(G4_RULES)} rules in {time.perf_counter() - start:.1f} s; launches {total}  "
        f"[{nvidia_smi_line()}]")
    return total


def cg_start(make, label):
    """The rms of the first gradient of ``make()``'s CG loss, its side, and
    its initial efficiency and uniformity (after a step of rate 0)."""
    holo = make()
    s = float(cg_gradient(holo).pow(2).mean().sqrt())
    cg_optimize(holo, 1, None, optimizer="sgd", kwargs={"learning_rate": 0.0})
    initial = cg_final(holo)[0]
    log(f"{label}: first gradient rms {s:.4e}; initial efficiency {initial[0]:.6f}, "
        f"uniformity {initial[1]:.6f}")
    return s, holo.shape[0], initial


def cg_rule_run(label, make, n, name, kwargs, loop_expect, after_expect, atol, initial=None,
                rise=True, timed=True):
    """One CG run of the optimizer or building block ``name`` (G4, G5):
    through the kernels (exact launches in the loop and after it) and
    through torch's autograd of the plain versions (none); what users read
    within ``atol`` of plain; where ``initial`` is given, the efficiency
    risen from it (fallen when not ``rise``); one host sync an iteration;
    if ``timed``, ms an iteration, plain, kernels, kernels, plain. Returns
    ``(launches, ms through the kernels, ms plain)``, no times if not
    ``timed``."""
    opt = dict(optimizer=name, kwargs=kwargs)
    holo, losses, loop, after, _ = drive_cg(make, n, None, **opt)
    assert loop == loop_expect, (label, loop)
    assert after == after_expect, (label, after)
    assert holo.iter == n == len(losses) and np.isfinite(losses).all(), (label, losses)
    final = cg_final(holo)
    with plain_gradients():
        plain, plain_losses, plain_loop, plain_after, _ = drive_cg(make, n, None, **opt)
        plain_final = cg_final(plain)
    assert not plain_loop and not plain_after, (label, plain_loop, plain_after)
    e_final = float(np.abs(final - plain_final).max())
    e_loss = float(np.max(np.abs(losses - plain_losses) / np.abs(plain_losses)))
    assert e_final <= atol, (label, final, plain_final)
    if initial is not None:
        assert (final[0][0] > initial[0]) == rise, (label, initial, final)

    def run(k, holo=holo, opt=opt):
        cg_optimize(holo, k, None, **opt)

    syncs = (host_syncs(run, HOST_TIMING_ITERS) - host_syncs(run, 0)) / HOST_TIMING_ITERS
    assert syncs == 1, (label, syncs)
    kernel_ms = plain_ms = ()
    times = ""
    if timed:
        with plain_gradients():
            p1 = wall_ms(run, n)
        kernel_ms = wall_ms(run, n), wall_ms(run, n)
        with plain_gradients():
            plain_ms = p1, wall_ms(run, n)
        times = (f"; kernels {kernel_ms[0]:.3f} {kernel_ms[1]:.3f} ms an iteration, plain "
                 f"autograd {plain_ms[0]:.3f} {plain_ms[1]:.3f}")
    log(f"{label}: {final.ravel()[:2].tolist()} (plain {plain_final.ravel()[:2].tolist()}); "
        f"final max |diff| {e_final:.3e}, loss max relative diff {e_loss:.3e}; {syncs:.2f} host "
        f"syncs an iteration{times}")
    counts = {k: loop.get(k, 0) + after.get(k, 0) for k in {*loop, *after}}
    return counts, kernel_ms, plain_ms


# ----------------------------------------------------------------------
# G5: optax's building blocks (ops/optim.py) on G1's and G2's paths.
# ----------------------------------------------------------------------

#: G5: the 52 building blocks that CG steps (optax's gradient
#: transformations without a learning rate), each on G1's path for G4_ITERS
#: iterations, and the 7 that CG cannot step (they raise the reference's
#: class at its stage).
G5_BLOCKS = (
    "adaptive_grad_clip", "add_decayed_weights", "add_noise", "apply_every",
    "apply_if_finite", "centralize", "clip", "clip_by_block_rms", "clip_by_global_norm",
    "conditionally_mask", "conditionally_transform", "ema", "flatten", "freeze", "identity",
    "keep_params_nonnegative", "masked", "multi_transform", "named_chain",
    "normalize_by_update_norm", "partition", "scale", "scale_by_adadelta", "scale_by_adam",
    "scale_by_adamax", "scale_by_adan", "scale_by_amsgrad", "scale_by_belief",
    "scale_by_distance_over_gradients", "scale_by_lbfgs", "scale_by_lion",
    "scale_by_novograd", "scale_by_optimistic_gradient", "scale_by_param_block_norm",
    "scale_by_param_block_rms", "scale_by_radam", "scale_by_rms", "scale_by_rss",
    "scale_by_schedule", "scale_by_sign", "scale_by_sm3", "scale_by_stddev",
    "scale_by_trust_ratio", "scale_by_yogi", "selective_transform", "set_to_zero",
    "snapshot", "stateless", "stateless_with_tree_map", "trace", "with_extra_args_support",
    "zero_nans",
)
#: Extra G5 runs: an ``inject_hyperparams`` transform as an inner one.
G5_EXTRA = {"masked_injected": "masked"}
#: The runs that must raise G1's efficiency: every combinator given a
#: descending inner rule, and the leaves given a descending step.
G5_RISE = ("apply_if_finite", "conditionally_mask", "conditionally_transform", "flatten",
           "masked", "masked_injected", "multi_transform", "partition", "selective_transform",
           "stateless", "stateless_with_tree_map", "with_extra_args_support", "scale",
           "scale_by_schedule", "normalize_by_update_norm")
#: The blocks whose result depends on psi's rank, also on G2's path (the
#: flat pixel vector of config 5).
G5_RANKED = ("adaptive_grad_clip", "centralize", "clip_by_block_rms", "flatten",
             "scale_by_param_block_norm", "scale_by_param_block_rms", "scale_by_sm3")
#: The G5 runs timed (ms an iteration, plain, kernels, kernels, plain): a
#: leaf of each kind, the heaviest rules and a combinator of each kind.
G5_TIMED = ("scale", "scale_by_adam", "scale_by_lbfgs", "scale_by_distance_over_gradients",
            "clip_by_global_norm", "zero_nans", "apply_if_finite", "flatten", "partition",
            "masked_injected")
#: The blocks CG cannot step: the stage that raises and the class.
G5_FAILING = {
    "chain": ("build", ValueError), "inject_hyperparams": ("init", AttributeError),
    "inject_stateful_hyperparams": ("init", AttributeError),
    "lookahead": ("update", AttributeError),
    "scale_by_backtracking_linesearch": ("update", TypeError),
    "scale_by_polyak": ("update", TypeError), "scale_by_zoom_linesearch": ("update", TypeError),
}


def g5_kwargs(name, s, side):
    """The ``optimizer_kwargs`` of each G5 run on a plane of ``side**2``
    values whose first gradient has rms ``s``, as :func:`g4_kwargs` scales
    G4's. A combinator's inner rule is Adam at rate 0.05, epsilon 1e-3 of
    ``s``, built from the port's ``ops.optim``; a leaf that steps by a unit
    ratio (the Adam family, RMS, RSS, SM3, the standard deviation) takes an
    epsilon of 20 ``s`` (or its square), so it climbs about 0.05 rad a
    step; the trust ratio a coefficient of 0.03; the scales a step of
    -0.1 / ``s`` (descending); the clips thresholds of order ``s``; DoG an
    epsilon of 1e4 ``s`` (optax's update divides by ``sqrt(update + eps)``,
    nan below ``-eps``). Sign and Lion step by 1 rad."""
    from slmsuite_torch.ops import optim

    e, big = 1e-3 * s, 20 * s
    inner = optim.adam(0.05, eps=e)
    descend = -0.1 / s
    return {
        "adaptive_grad_clip": dict(clipping=0.2 * s),
        "add_decayed_weights": dict(weight_decay=0.01),
        "add_noise": dict(eta=(0.1 * s) ** 2, gamma=0.55, key=0),
        "apply_every": dict(k=3),
        "apply_if_finite": dict(inner=inner, max_consecutive_errors=2),
        "centralize": dict(),
        "clip": dict(max_delta=s),
        "clip_by_block_rms": dict(threshold=0.5 * s),
        "clip_by_global_norm": dict(max_norm=0.5 * s * side),
        "conditionally_mask": dict(inner=inner, should_transform_fn=lambda step: step % 2 == 0),
        "conditionally_transform": dict(inner=inner, should_transform_fn=lambda step: step < 100),
        "ema": dict(decay=0.9),
        "flatten": dict(inner=optim.adafactor(0.05)),
        "freeze": dict(mask=True),
        "identity": dict(),
        "keep_params_nonnegative": dict(),
        "masked": dict(inner=inner, mask=lambda u: u.ndim >= 1),
        "masked_injected": dict(inner=optim.inject_hyperparams(optim.adam)(
            learning_rate=0.05, eps=e), mask=True),
        "multi_transform": dict(transforms={"a": inner, "b": optim.sgd(descend)},
                                param_labels="a"),
        "named_chain": dict(),
        "normalize_by_update_norm": dict(scale_factor=-0.05 * side, eps=e * side),
        "partition": dict(transforms={"a": inner}, param_labels=lambda p: "a"),
        "scale": dict(step_size=descend),
        "scale_by_adadelta": dict(eps=e * e),
        "scale_by_adam": dict(eps=big),
        "scale_by_adamax": dict(eps=big),
        "scale_by_adan": dict(eps=big),
        "scale_by_amsgrad": dict(eps=big),
        "scale_by_belief": dict(eps=big, eps_root=0.0),
        "scale_by_distance_over_gradients": dict(eps=1e4 * s),
        "scale_by_lbfgs": dict(scale_init_precond=False),
        "scale_by_lion": dict(),
        "scale_by_novograd": dict(eps=e * side),
        "scale_by_optimistic_gradient": dict(alpha=0.5, beta=2.0),
        "scale_by_param_block_norm": dict(),
        "scale_by_param_block_rms": dict(),
        "scale_by_radam": dict(b2=0.9, eps=big),
        "scale_by_rms": dict(eps=big * big),
        "scale_by_rss": dict(initial_accumulator_value=big * big, eps=e * e),
        "scale_by_schedule": dict(step_size_fn=lambda count: descend),
        "scale_by_sign": dict(),
        "scale_by_sm3": dict(eps=big * big),
        "scale_by_stddev": dict(eps=big * big),
        "scale_by_trust_ratio": dict(trust_coefficient=0.03),
        "scale_by_yogi": dict(b1=0.0, eps=big, initial_accumulator_value=big * big),
        "selective_transform": dict(optimizer=inner, freeze_mask=False),
        "set_to_zero": dict(),
        "snapshot": dict(measure_name="sq", measure=lambda u: (u * u).sum()),
        "stateless": dict(f=lambda u, p: descend * u),
        "stateless_with_tree_map": dict(f=lambda u, p: descend * u),
        "trace": dict(decay=0.9),
        "with_extra_args_support": dict(tx=inner),
        "zero_nans": dict(),
    }[name]


def g5_failing_kwargs(name):
    from slmsuite_torch.ops import optim

    return {
        "chain": {}, "inject_hyperparams": dict(inner_factory=optim.adam),
        "inject_stateful_hyperparams": dict(inner_factory=optim.adam),
        "lookahead": dict(fast_optimizer=optim.sgd(0.1), sync_period=2, slow_step_size=0.5),
        "scale_by_backtracking_linesearch": dict(max_backtracking_steps=5),
        "scale_by_polyak": {}, "scale_by_zoom_linesearch": dict(max_linesearch_steps=5),
    }[name]


def phase_g5(device, make=None, make2=None, n=G4_ITERS):
    """G5: optax's building blocks. Each of the 52 that CG steps on G1's
    path (the 2048^2 32x32 array through SpotHologram), and an
    ``inject_hyperparams`` Adam inside ``masked``: exact launches (rows_fft
    and cols_fft 2n in the loop, one each after it), one host sync an
    iteration, the final efficiency and uniformity within SLICE_ATOL of
    torch's autograd of the plain versions on the card, a rise in
    efficiency for every combinator of a descending rule (G5_RISE), and ms
    an iteration of the runs named in G5_TIMED. The rank-dependent blocks also on G2's path (config 5's
    flat vector: n2f and f2n n in the loop, n2f once after it; within
    CMP_PATH_ATOL). The 7 that CG cannot step raise the reference's class on
    the card. Returns the launches over all runs."""
    import warnings

    from slmsuite_torch.ops import optim

    make = make or (lambda: g1_hologram(device))
    make2 = make2 or (lambda: config5_hologram(device))
    start = time.perf_counter()
    s, side, initial = cg_start(make, "G5")
    total, kernel_ms, plain_ms = {}, [], []
    fft_loop, fft_after = dict(rows_fft=2 * n, cols_fft=2 * n), dict(rows_fft=1, cols_fft=1)
    for run_name in (*G5_BLOCKS, *G5_EXTRA):
        name = G5_EXTRA.get(run_name, run_name)
        kwargs = g5_kwargs(run_name, s, side)
        counts, k, p = cg_rule_run(f"G5 {run_name}", make, n, name, kwargs, fft_loop,
                                   fft_after, SLICE_ATOL,
                                   initial if run_name in G5_RISE else None,
                                   timed=run_name in G5_TIMED)
        kernel_ms += k
        plain_ms += p
        for key, v in counts.items():
            total[key] = total.get(key, 0) + v
    g1_s = time.perf_counter() - start
    grad2 = cg_gradient(make2())
    s2, side2 = float(grad2.pow(2).mean().sqrt()), int(round(grad2.numel() ** 0.5))
    del grad2
    cmp_ms = []  # Kernels, plain, for each timed run on G2.
    for name in G5_RANKED:
        counts, k, p = cg_rule_run(f"G5 G2 {name}", make2, n, name, g5_kwargs(name, s2, side2),
                                   dict(n2f=n, f2n=n), dict(n2f=1), CMP_PATH_ATOL,
                                   timed=name in G5_TIMED)
        cmp_ms += [t for pair in zip(k, p) for t in pair]
        for key, v in counts.items():
            total[key] = total.get(key, 0) + v
    psi = torch.zeros(8, 8, device=device)
    for name, (stage, error) in G5_FAILING.items():
        at = "build"
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                opt = optim.get_optimizer(name, g5_failing_kwargs(name))
            at = "init"
            state = opt.init(psi)
            at = "update"
            opt.update(torch.ones_like(psi), state, psi)
        except error:
            assert at == stage, (name, at, stage)
        else:
            raise AssertionError(f"G5 {name} ran")
    log(f"G5: {len(G5_BLOCKS) + len(G5_EXTRA)} runs on G1 in {g1_s:.1f} s; those timed "
        f"(G5_TIMED), kernels {min(kernel_ms):.3f}-{max(kernel_ms):.3f} ms an iteration, plain "
        f"autograd {min(plain_ms):.3f}-{max(plain_ms):.3f}; {len(G5_RANKED)} on G2, those "
        f"timed {min(cmp_ms[0::2]):.3f}-{max(cmp_ms[0::2]):.3f} ms, plain autograd "
        f"{min(cmp_ms[1::2]):.3f}-{max(cmp_ms[1::2]):.3f}; the {len(G5_FAILING)} that CG cannot "
        f"step raise their class; "
        f"{time.perf_counter() - start:.1f} s in all; launches {total}  [{nvidia_smi_line()}]")
    return total


# ----------------------------------------------------------------------
# N0: the native host helpers (slmsuite_torch/native) on the card's host.
# ----------------------------------------------------------------------

#: N0's SLM planes: a 1920x1152 SLM and X1's 4160x2464 one, as (H, W).
N0_SHAPES = ((1152, 1920), (2464, 4160))
#: N0's PLM model (texas_instruments.yaml) and the timed repeats.
N0_PLM, N0_REPEATS = "p67", 5


def cpu_model():
    """The host CPU's model name (/proc/cpuinfo); where a virtual machine
    reports it "unknown", its vendor, family, model number and clock."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as info:
            for line in info:
                if not line.strip():
                    break
                key, _, value = line.partition(":")
                fields[key.strip()] = value.strip()
    except OSError:
        return platform.processor() or platform.machine()
    name = fields.get("model name", "unknown")
    if name.lower() != "unknown":
        return name
    return (f"{fields.get('vendor_id', '?')} family {fields.get('cpu family', '?')} model "
            f"{fields.get('model', '?')} (model name not reported), "
            f"{fields.get('cpu MHz', '?')} MHz")


def host_ms(fn, n=N0_REPEATS):
    """Median host milliseconds of ``fn()`` over ``n`` calls after one."""
    fn()
    times = []
    for _ in range(n):
        start = time.perf_counter()
        fn()
        times.append((time.perf_counter() - start) * 1e3)
    return float(np.median(times))


@contextlib.contextmanager
def numpy_phase2gray():
    """The SLM write path with its native conversion refused: the numpy
    passes of ``SLM._phase2gray`` (not counted in ``native.ROUTES``)."""
    from slmsuite_torch.hardware.slms import slm

    saved = slm.phase2gray_native
    slm.phase2gray_native = lambda *args: False
    try:
        yield
    finally:
        slm.phase2gray_native = saved


def f32_phase2gray_numpy(phase, bitresolution):
    """The float32 kernel's arithmetic in numpy (the product in float32,
    rounded half to even, less one, wrapped): its numpy path, the SLM's
    passes being float64 as its phase is."""
    factor = np.float32(-np.float32(bitresolution) / np.float32(2 * np.pi))
    codes = np.rint(phase * factor).astype(np.int64) - 1
    return (codes & (bitresolution - 1)).astype(np.uint8)


def phase_native(g1_phase):
    """N0: the native helpers built from the repository's C sources on the
    card's host, each held bit for bit against its numpy path (phase2gray
    float64 to uint8 and to 12-bit uint16, float32 to uint8 at N0_SHAPES;
    the PLM electrode map and bitpack at N0_PLM's mirror count), host ms
    native against numpy, then G1's final phase written through
    SimulatedSLM.set_phase. Fails on a failed build or any count of the
    numpy route in native.ROUTES."""
    from slmsuite_torch import native
    from slmsuite_torch.hardware.slms.simulated import SimulatedSLM
    from slmsuite_torch.hardware.slms.texasinstruments import PLM, PLM_MODELS

    start = time.perf_counter()
    earlier = sorted(native._LIBS)
    libs = [native.build(stem) for stem in ("phase2gray", "plm_pack")]
    log(f"N0: {', '.join(str(p.relative_to(ROOT)) for p in libs)} ready in "
        f"{time.perf_counter() - start:.2f} s (built from slmsuite_torch/native/*.c at first "
        f"use; {earlier or 'none'} loaded earlier in this run); host CPU: {cpu_model()} "
        f"({os.cpu_count()} cores)")
    native.reset_routes()
    for H, W in N0_SHAPES:
        phase = np.random.default_rng(H).uniform(-4 * np.pi, 4 * np.pi, (H, W))
        for label, bitdepth, dtype in (("f64->u8", 8, np.float64), ("f64->u16", 12, np.float64),
                                       ("f32->u8", 8, np.float32)):
            x = np.ascontiguousarray(phase, dtype=dtype)
            slm = SimulatedSLM((W, H), bitdepth=bitdepth)
            out = np.empty((H, W), slm.dtype)
            assert native.phase2gray_native(x, out, 2**bitdepth), (label, H, W)
            if dtype == np.float64:
                with numpy_phase2gray():
                    ref = slm._phase2gray(x)

                    def numpy_route(slm=slm, x=x):
                        slm._phase2gray(x)

                    t_numpy = host_ms(numpy_route)
            else:
                ref = f32_phase2gray_numpy(x, 2**bitdepth)
                t_numpy = host_ms(lambda x=x, b=2**bitdepth: f32_phase2gray_numpy(x, b))
            assert np.array_equal(out, ref), (label, H, W, int((out != ref).sum()))
            t_native = host_ms(lambda x=x, out=out, b=2**bitdepth:
                               native.phase2gray_native(x, out, b))
            log(f"N0 phase2gray {label} {H}x{W}: bit-exact; host {t_native:.3f} ms native, "
                f"{t_numpy:.3f} ms numpy")

    plm = object.__new__(PLM)
    plm.model = PLM_MODELS[N0_PLM]
    plm._init_quantize_lut(0.633, 0.633)
    h, w = plm.model["shape"]
    display = np.random.default_rng(6).integers(0, 256, (h, w)).astype(np.uint8)
    packed = plm._pack_frame(display)
    ref = plm._electrode_map(plm._gray_to_code[display])
    assert np.array_equal(packed, ref), int((packed != ref).sum())
    t_native = host_ms(lambda: plm._pack_frame(display))
    t_numpy = host_ms(lambda: plm._electrode_map(plm._gray_to_code[display]))
    log(f"N0 plm_electrode_map {N0_PLM} {h}x{w} -> {2 * h}x{2 * w}: bit-exact; host "
        f"{t_native:.3f} ms native, {t_numpy:.3f} ms numpy")
    maps = np.random.default_rng(7).integers(0, 2, (8, 2 * h, 2 * w)).astype(np.uint8)
    shifts = np.arange(8, dtype=np.uint8)[:, None, None]

    def numpy_pack():
        return np.bitwise_or.reduce(np.left_shift(maps & 1, shifts), axis=0)

    packed = PLM.bitpack(list(maps))[0]
    assert np.array_equal(packed, numpy_pack())
    t_native = host_ms(lambda: PLM.bitpack(list(maps)))
    t_numpy = host_ms(numpy_pack)
    log(f"N0 plm_bitpack8 8 x {2 * h}x{2 * w}: bit-exact; host {t_native:.3f} ms native "
        f"(PLM.bitpack), {t_numpy:.3f} ms numpy")

    slm = SimulatedSLM(g1_phase.shape[::-1])
    before = dict(native.ROUTES["phase2gray"])
    slm.set_phase(g1_phase, settle=False)
    with numpy_phase2gray():
        ref = slm._phase2gray(slm.phase)
    assert np.array_equal(slm.display, ref)
    assert native.ROUTES["phase2gray"]["native"] > before["native"], native.ROUTES
    assert all(counts["numpy"] == 0 for counts in native.ROUTES.values()), native.ROUTES
    log(f"N0: G1's final phase written through SimulatedSLM.set_phase natively; routes "
        f"{json.dumps(native.ROUTES)}; {time.perf_counter() - start:.1f} s  "
        f"[{nvidia_smi_line()}]")


# ----------------------------------------------------------------------
# X0-X2: planes whose sides are multiples of 8 but not powers of two (the
# line FFT's mixed lines, n = P m, P = 8 or 16), and the 8192-point line.
# ----------------------------------------------------------------------

#: X0's planes: every side of X0_SIDES as a row side and as a column side.
X0_SIDES = (96, 792, 1080, 1152, 1272, 1536, 1792, 1920, 4160, 6144, 8192)
X0_PLANES = ((96, 128), (128, 96), (792, 1272), (1272, 792), (1080, 1920), (1920, 1080),
             (1152, 1536), (1536, 1152), (1152, 1920), (1792, 4160), (4160, 1792),
             (6144, 1152), (1152, 6144), (8192, 8192))
#: X0's stack for the kernels that take one.
X0_STACK = (4, 1080, 1920)
#: X1: the padded shape of a 4160x2464 SLM (a 10-megapixel 4K LCoS) at
#: padding_order=1, and the SLM's (H, W).
X1_SLM, X1_SHAPE, X1_ITERS, X1_PITCH = (2464, 4160), (8192, 8192), 50, 120
#: X2: a 1920x1152 SLM at padding_order=0; its iterations (CG: X2_CG_ITERS)
#: and the batched stack's planes.
X2_SHAPE, X2_ITERS, X2_CG_ITERS, X2_PLANES = (1152, 1920), 50, 20, 4
X2_ARRAY, X2_PITCH = (16, 16), (40, 40)
#: X2's small plane, against the CPU port (ROADMAP.md F7's 96x128).
X2_SMALL, X2_SMALL_ITERS = (96, 128), 20
#: The shapes of the mixed-side timings (PERF.md section 6).
MIXED_TIMED = ((1152, 1920), (8192, 8192))


def device_pair(shape, device, seed):
    """A standard normal pair drawn on the card (seeded torch generator):
    the large planes' inputs, without a host round trip."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=device) for _ in range(2))


def mixed_inputs(shape, device, seed=0):
    """One carry step's inputs at ``shape`` on the card: step_inputs'
    quantities (psi in +-4 pi, a 12-spot target, Kim's phasor, an amplitude
    plane, MRAF regions, zero weights) drawn by a seeded torch generator."""
    from slmsuite_torch.ops import fft

    H, W = shape
    gen = torch.Generator(device=device).manual_seed(seed)

    def uniform(lo, hi, size=shape):
        return lo + (hi - lo) * torch.rand(size, generator=gen, device=device)

    target = torch.from_numpy(spot_target(H, W, seed=seed + 5)).to(device)
    pff = uniform(-np.pi, np.pi)
    mcode = torch.where(target > 0, 1.0, torch.where(uniform(0, 1) < 0.5, 2.0, 0.0))
    scal = fft.pack_scalars(dict(
        post=1.0 / np.sqrt(H * W), inv_prev_norm=0.7, apply_update=1.0, use_theta=1.0,
        feedback_exponent=0.8, feedback_factor=0.2, inv_fnorm=1.3,
        inv_tsum=1.0 / float((target**2).sum()), inv_fsum=0.9, mraf_factor=0.4,
        zero_factor=0.3,
    ), device)
    return dict(psi=uniform(-4 * np.pi, 4 * np.pi), amp=uniform(0.5, 1.5), target=target,
                weights=target * 1.3, mask=(target != 0).float(), mcode=mcode.contiguous(),
                phase_ff=(torch.cos(pff), torch.sin(pff)), angle=pff,
                zw=1e-3 * torch.randn((2, *shape), generator=gen, device=device), scal=scal)


def conditioned(tag, got, ref, plain64, lines):
    """A carry kernel's pair against its plain version within CARRY_RTOL;
    where the plain f32 version itself is further than that from the same
    function in float64 (an amplitude replacement or a phasor near a zero of
    the field), the kernel's pair against float64 within twice the plain
    f32 version's own error. Returns the error against the f32 version."""
    e = max(rel_err(g, r) for g, r in zip(got, ref))
    if e <= CARRY_RTOL:
        lines.append(f"{tag}: rel {e:.3e}")
        return e
    ref64 = plain64()
    ek = max(rel_err(g.double(), r) for g, r in zip(got, ref64))
    ep = max(rel_err(g.double(), r) for g, r in zip(ref, ref64))
    assert ek <= max(CARRY_RTOL, 2 * ep), f"{tag}: rel {e:.3e}, float64 {ek:.3e} / {ep:.3e}"
    lines.append(f"{tag}: rel {e:.3e}; against float64 kernel {ek:.3e}, plain f32 {ep:.3e}")
    return e


def as_double(*xs):
    return tuple(None if x is None else tuple(y.double() for y in x) if isinstance(x, tuple)
                 else x.double() if torch.is_tensor(x) else x for x in xs)


def mixed_plane_checks(shape, device, keep, lines):
    """Each of the eleven line kernels against its plain version on one
    (H, W) plane, X0's checks and limits: rows_fft and cols_fft forward and
    inverse, carry_entry (scalar and amplitude plane) and carry_exit,
    cols_fwd_polar (one column zero) and cols_wexp_inv, the WGS-Kim step
    kernels with stats (conditioned where the plain f32 step is off),
    cols_mraf_fwd, cols_mraf_mix_inv (Kim, zero weights) and cols_wgs_fwd.
    ``keep(name, e)`` takes each kernel's error, ``lines`` the log."""
    from slmsuite_torch.ops import cuda_fft, fft

    xr, xi = device_pair(shape, device, seed=shape[0] + shape[1])
    for inverse in (False, True):
        for name in ("rows_fft", "cols_fft"):
            got = getattr(cuda_fft, name)(xr, xi, inverse=inverse, scale=0.5)
            ref = getattr(fft, "_" + name)(xr, xi, inverse=inverse, scale=0.5)
            e = max(rel_err(g, r) for g, r in zip(got, ref))
            assert e <= CARRY_RTOL, f"{name} {shape} inverse={inverse}: {e:.3e}"
            lines.append(f"{name} {shape} inverse={inverse}: rel {e:.3e}")
            keep(name, e)
    x = mixed_inputs(shape, device)
    for amp in (1.0 / np.sqrt(shape[0] * shape[1]), x["amp"]):
        gr, gi = cuda_fft.carry_entry(x["psi"], amp)
        pr, pi_ = fft._wgs_carry_entry(x["psi"], amp)
        e = max(rel_err(gr, pr), rel_err(gi, pi_))
        assert e <= CARRY_RTOL, f"carry_entry {shape}: {e:.3e}"
        keep("carry_entry", e)
    wrapped = wrapped_abs(cuda_fft.carry_exit(pr, pi_), fft._wgs_carry_exit(pr, pi_))
    p99 = float(torch.quantile(wrapped.flatten()[::7].double(), 0.99))
    top = float(wrapped.max())
    assert p99 < PSI_P99 and top <= PSI_MAX_ATOL, f"carry_exit {shape}: {p99:.3e} {top:.3e}"
    lines.append(f"carry_entry {shape}: rel {e:.3e}; carry_exit p99 {p99:.3e} max {top:.3e}")
    keep("carry_exit", top)
    # The column kernels with an epilogue, one column of the pair zero.
    xr[:, 1], xi[:, 1] = 0.0, 0.0
    got = cuda_fft.cols_fwd_polar(xr, xi, 0.25)
    ref = fft._cols_fwd_polar(xr, xi, 0.25)
    e, et = rel_err(got[0], ref[0]), theta_err(got[1], ref[1], ref[0])
    assert e <= CARRY_RTOL and et < THETA_ATOL, f"cols_fwd_polar {shape}: {e:.3e} {et:.3e}"
    assert max(float(g[:, 1].abs().max()) for g in got) == 0.0, f"polar {shape} zero column"
    keep("cols_fwd_polar", e)
    w, phi = xr.abs(), xi * np.pi
    got, ref = cuda_fft.cols_wexp_inv(w, phi), fft._cols_wexp_inv(w, phi)
    e2 = max(rel_err(g, r) for g, r in zip(got, ref))
    assert e2 <= CARRY_RTOL, f"cols_wexp_inv {shape}: {e2:.3e}"
    keep("cols_wexp_inv", e2)
    lines.append(f"cols_fwd_polar {shape}: |F| rel {e:.3e} arg F {et:.3e}; "
                 f"cols_wexp_inv rel {e2:.3e}")
    del xr, xi, w, phi, got, ref
    # The step kernels: WGS-Kim with stats, the amplitude plane.
    kw = dict(rule="kim", kim=True, stats_on=True)
    args = (pr, pi_, x["weights"], x["target"], x["mask"], x["phase_ff"], x["scal"])
    got = cuda_fft.cols_wgs_roundtrip(*args, **kw)
    ref = fft._cols_wgs_roundtrip(*args, **kw)
    tag = f"cols_wgs_roundtrip {shape}"
    keep("cols_wgs_roundtrip", conditioned(
        tag + "/h", got[:2], ref[:2], lambda: fft._cols_wgs_roundtrip(
            *as_double(*args[:-1]), args[-1], **kw)[:2], lines))
    check_close(tag + "/w", got[2], ref[2], WEIGHT_ATOL, WEIGHT_RTOL)
    amp_ff = torch.fft.fft(torch.complex(pr, pi_), dim=0).abs()
    lines.append(f"{tag}/pff: " + check_phasor(tag + "/pff", got[3], ref[3], amp_ff))
    check_close(tag + "/sums", got[4], ref[4], WEIGHT_ATOL, WEIGHT_RTOL)
    check_close(tag + "/maxs", got[5], ref[5], WEIGHT_ATOL, WEIGHT_RTOL)
    hr, hi = ref[0], ref[1]
    keep("rows_normfwd", conditioned(
        f"rows_normfwd {shape}", cuda_fft.rows_normfwd(hr, hi, x["amp"]),
        fft._rows_normfwd(hr, hi, x["amp"]),
        lambda: fft._rows_normfwd(*as_double(hr, hi, x["amp"])), lines))
    del got, ref, hr, hi, amp_ff
    fwd = (pr, pi_, x["weights"], x["target"], x["mask"], x["scal"])
    got = cuda_fft.cols_mraf_fwd(*fwd, rule="kim", stats_on=True)
    ref = fft._cols_mraf_fwd(*fwd, rule="kim", stats_on=True)
    tag = f"cols_mraf_fwd {shape}"
    e = max(rel_err(got[0], ref[0]), rel_err(got[1], ref[1]))
    assert e <= CARRY_RTOL, f"{tag}/F: {e:.3e}"
    ew = check_close(tag + "/uw", got[2], ref[2], WEIGHT_ATOL, WEIGHT_RTOL)
    check_close(tag + "/sums", got[3], ref[3], WEIGHT_ATOL, WEIGHT_RTOL)
    check_close(tag + "/maxs", got[4], ref[4], WEIGHT_ATOL, WEIGHT_RTOL)
    lines.append(f"{tag}: F rel {e:.3e} uw {ew:.3e}")
    keep("cols_mraf_fwd", e)
    mix = (ref[0], ref[1], ref[2], x["mcode"], x["phase_ff"], x["zw"], ref[3], x["scal"])
    got_m = cuda_fft.cols_mraf_mix_inv(*mix, kim=True, zero=True)
    ref_m = fft._cols_mraf_mix_inv(*mix, kim=True, zero=True)
    tag = f"cols_mraf_mix_inv {shape}"
    keep("cols_mraf_mix_inv", conditioned(
        tag + "/h", got_m[:2], ref_m[:2], lambda: fft._cols_mraf_mix_inv(
            *as_double(*mix[:6]), mix[6], mix[7], kim=True, zero=True)[:2], lines))
    for g, r in (*zip(got_m[2], ref_m[2]), *zip(got_m[3], ref_m[3])):
        check_close(tag + "/pff, zw", g, r, WEIGHT_ATOL, WEIGHT_RTOL)
    del got, ref, got_m, ref_m, mix
    fwd_kim = (pr, pi_, x["weights"], x["target"], x["mask"], x["angle"], x["scal"])
    got = cuda_fft.cols_wgs_fwd(*fwd_kim, **kw)
    ref = fft._cols_wgs_fwd(*fwd_kim, **kw)
    tag = f"cols_wgs_fwd {shape}"
    e = max(rel_err(got[0], ref[0]), rel_err(got[1], ref[1]))
    assert e <= CARRY_RTOL, f"{tag}/re, im: {e:.3e}"
    check_close(tag + "/w", got[2], ref[2], WEIGHT_ATOL, WEIGHT_RTOL)
    et = theta_err(got[3], ref[3], fft._fft2_polar_from_phase(x["psi"], x["amp"])[0])
    assert et < THETA_ATOL, f"{tag}/phase_ff: {et:.3e}"
    check_close(tag + "/sums", got[4], ref[4], WEIGHT_ATOL, WEIGHT_RTOL)
    check_close(tag + "/maxs", got[5], ref[5], WEIGHT_ATOL, WEIGHT_RTOL)
    lines.append(f"{tag}: re, im rel {e:.3e} phase_ff {et:.3e}")
    keep("cols_wgs_fwd", e)
    del x, pr, pi_, got, ref, fwd, fwd_kim, args
    torch.cuda.synchronize()


def phase_mixed_parity(device):
    """X0: each of the eleven line kernels against its plain version on
    X0_PLANES (each of X0_SIDES as a row side and as a column side;
    mixed_plane_checks), then the five kernels that take a stack on
    X0_STACK (one launch; bit for bit the planes' own launches; against the
    plain version). Returns each kernel's largest relative error."""
    from slmsuite_torch.ops import cuda_fft, fft

    worst = dict.fromkeys(cuda_fft.LINE_KERNELS, 0.0)
    lines = []

    def keep(name, e):
        worst[name] = max(worst[name], e)

    start = time.perf_counter()
    for shape in X0_PLANES:
        mixed_plane_checks(shape, device, keep, lines)
    # The stack: one launch, bit for bit its planes' launches, the plain
    # version on the stack.
    B = X0_STACK[0]
    xr, xi = device_pair(X0_STACK, device, seed=7)
    s = dict(xr=xr, xi=xi, psi=xr * 4, w=xr.abs(), phi=xi * np.pi, amp=xi[0].abs() + 0.5)
    for name, (batched, single, plain) in stack_calls(s).items():
        cuda_fft.reset_launch_counts()
        got = batched()
        kernel = name.split()[0]
        assert cuda_fft.LAUNCHES[kernel] == 1, (name, cuda_fft.LAUNCHES)
        for b in range(B):
            assert all(torch.equal(g[b], p) for g, p in zip(got, single(b))), (name, b)
        ref = plain()
        if kernel == "cols_fwd_polar":
            e = rel_err(got[0], ref[0])
            assert theta_err(got[1], ref[1], ref[0]) < THETA_ATOL, name
        else:
            e = max(rel_err(g, r) for g, r in zip(got, ref))
        assert e <= CARRY_RTOL, f"{name} stack {X0_STACK}: {e:.3e}"
        lines.append(f"{name} stack {X0_STACK}: one launch, {B} planes bit for bit, rel {e:.3e}")
    del xr, xi, s, got, ref
    torch.cuda.synchronize()
    (OUT / "parity_mixed.log").write_text("\n".join(lines) + "\n")
    log(f"X0 mixed sides: {len(lines)} checks passed on {len(X0_PLANES)} planes and the "
        f"{X0_STACK} stack in {time.perf_counter() - start:.1f} s; largest relative error "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    return worst


def mixed_multiplane(device, shape, B, seed=0):
    """``run(k)``: the batched multiplane engine on B planes of ``shape``,
    as parallel_models.multiplane_batched builds it (one spot a plane, a
    constant kernel a plane), WGS-Kim."""
    from slmsuite_torch.ops.propagation import fold_phase
    from slmsuite_torch.parallel.multiplane import (
        BatchedGSConfig,
        make_multiplane_consts,
        run_batched_gs,
    )

    H, W = shape
    targets = np.zeros((B, H, W), np.float32)
    for b in range(B):
        targets[b, H // 4 + 7 * b, W // 3 + 11 * b] = 1.0
    kernels = np.stack([np.full(shape, 0.05 * b, np.float32) for b in range(B)])
    config = BatchedGSConfig(method="WGS-Kim", shape=shape, slm_shape=shape, n_planes=B)
    consts = make_multiplane_consts(targets, kernels, np.full(B, 1 / np.sqrt(B), np.float32),
                                    1.0 / np.sqrt(H * W), device=device)
    rng = np.random.default_rng(seed)
    psi0 = torch.as_tensor(fold_phase(rng.uniform(-np.pi, np.pi, shape).astype(np.float32),
                                      shape), device=device)
    weights0 = torch.as_tensor(targets, device=device)
    return lambda k: run_batched_gs(config, psi0, weights0, consts, k)


def phase_mixed_paths(device):
    """X2 and X1, each path driven with the launch counts set to 0 just
    before it and read just after. X2, a 1920x1152 SLM at padding_order=0
    (a 1152x1920 plane): the fused loop, N1's natural step, M1's MRAF
    carry, G1's CG and an X2_PLANES-plane batched multiplane stack, each
    against the plain versions; and the 96x128 hologram ROADMAP.md's F7
    names against the CPU port. X1, the headline path at full width on
    get_padded_shape of a 4160x2464 SLM: a 32x32 SpotHologram array,
    WGS-Kim, X1_ITERS iterations (the padded natural step), against the
    plain versions, then ms an iteration and peak memory. Returns each
    path's launches."""
    from slmsuite_torch.holography.algorithms import Hologram

    out = {}
    n = X2_ITERS
    size = f"{X2_SHAPE[0]}x{X2_SHAPE[1]}"
    out["X2 fused"] = run_path(
        f"X2 fused WGS-Kim {size}",
        lambda: spot_array(device, X2_ARRAY, X2_PITCH, shape=X2_SHAPE),
        lambda h: h.optimize(method="WGS-Kim", maxiter=n, stat_groups=["computational"],
                             verbose=False),
        dict(carry_entry=1, cols_wgs_roundtrip=n, rows_normfwd=n, carry_exit=1))
    out["X2 N1"] = run_path(
        f"X2 N1 WGS-Nogrette computational_spot {size}",
        lambda: spot_array(device, X2_ARRAY, X2_PITCH, shape=X2_SHAPE),
        lambda h: h.optimize(method="WGS-Nogrette", maxiter=n, feedback="computational_spot",
                             stat_groups=["computational", "computational_spot"],
                             verbose=False),
        dict(carry_entry=n, cols_fwd_polar=n, cols_wexp_inv=n, carry_exit=n))
    out["X2 M1"] = run_path(
        f"X2 M1 MRAF WGS-Leonardo image {size}",
        lambda: image_hologram(device, X2_SHAPE),
        lambda h: h.optimize(method="WGS-Leonardo", maxiter=n, mraf_factor=0.5,
                             stat_groups=["computational"], verbose=False),
        dict(carry_entry=1, cols_mraf_fwd=n, cols_mraf_mix_inv=n, rows_normfwd=n,
             carry_exit=1))
    c = X2_CG_ITERS
    out["X2 G1"], _, _ = run_cg_path(
        f"X2 G1 SpotHologram {size} CG",
        lambda: spot_array(device, X2_ARRAY, X2_PITCH, shape=X2_SHAPE), c, G1_LR,
        dict(rows_fft=2 * c, cols_fft=2 * c), dict(rows_fft=1, cols_fft=1), SLICE_ATOL)
    B = X2_PLANES
    run = mixed_multiplane(device, X2_SHAPE, B)
    (psi, _, stats, _, _), launches, seconds = counted(lambda: run(n))
    expect = dict(carry_entry=n, cols_fwd_polar=n, cols_wexp_inv=n, rows_fft=n)
    log(f"X2 multiplane {B} x {size} WGS-Kim (kernels): final efficiency "
        f"{stats[-1, :, 0].tolist()} in {seconds:.2f} s; launches {launches}")
    assert launches == expect, (launches, expect)
    assert psi.shape == X2_SHAPE and bool(torch.isfinite(stats).all())
    with plain_step_functions():
        (_, _, plain, _, _), plain_launches, _ = counted(lambda: run(n))
    assert not plain_launches, plain_launches
    d = float((stats[:, :, :2] - plain[:, :, :2]).abs().max())
    log(f"X2 multiplane {B} x {size} (plain): per-plane efficiency and uniformity max |diff| "
        f"over {n} iterations {d:.3e}")
    assert d <= SLICE_ATOL, d
    out["X2 multiplane"] = launches
    # ROADMAP.md F7's plane: the card's run against the CPU port's.
    m = X2_SMALL_ITERS
    finals = []
    for where in (device, torch.device("cpu")):
        holo = spot_array(where, (4, 4), (12, 12), shape=X2_SMALL)
        split = launches_split_at_populate(holo)
        holo.optimize(method="WGS-Kim", maxiter=m, stat_groups=["computational"],
                      verbose=False)
        loop, _ = split()
        if where.type == "cuda":
            assert loop == dict(carry_entry=1, cols_wgs_roundtrip=m, rows_normfwd=m,
                                carry_exit=1), loop
            out["X2 96x128"] = loop
        stats = holo.stats["stats"]["computational"]
        finals.append((np.array([stats["efficiency"][-1], stats["uniformity"][-1]]),
                       np.asarray(holo.get_phase())))
    (card, card_phase), (cpu, cpu_phase) = finals
    d = float(np.abs(card - cpu).max())
    p99 = float(np.percentile(np.abs(np.angle(np.exp(1j * (card_phase - cpu_phase)))), 99))
    log(f"X2 {X2_SMALL} WGS-Kim {m} iterations, card against the CPU port: efficiency and "
        f"uniformity max |diff| {d:.3e}, phase p99 {p99:.3e}")
    assert d <= SLICE_ATOL and p99 < PSI_P99, (d, p99)
    padded = Hologram.get_padded_shape(X1_SLM)
    assert tuple(padded) == X1_SHAPE, padded
    n = X1_ITERS
    torch.cuda.reset_peak_memory_stats()
    out["X1"] = run_path(
        f"X1 SpotHologram {X1_SHAPE} canvas / {X1_SLM} SLM 32x32 WGS-Kim",
        lambda: spot_array(device, (32, 32), (X1_PITCH, X1_PITCH), slm_shape=X1_SLM,
                           shape=X1_SHAPE),
        lambda h: h.optimize(method="WGS-Kim", maxiter=n, stat_groups=["computational"],
                             verbose=False),
        dict(rows_fft=2 * n, cols_fwd_polar=n, cols_wexp_inv=n))
    peak = torch.cuda.max_memory_allocated() / 2**30
    holo = spot_array(device, (32, 32), (X1_PITCH, X1_PITCH), slm_shape=X1_SLM, shape=X1_SHAPE)
    run = lambda k: holo.optimize(method="WGS-Kim", maxiter=k,  # noqa: E731
                                  stat_groups=["computational"], verbose=False)
    with plain_step_functions():
        p1 = wall_ms(run, 10)
    k1 = wall_ms(run, 10)
    log(f"X1 {X1_SHAPE}: kernels {k1:.3f} ms an iteration, plain {p1:.3f}; peak device memory "
        f"{peak:.3f} GiB  [{nvidia_smi_line()}]")
    del holo, run
    return out


def bound_lines(shape, planes_moved, n, line_ffts):
    """``(bound_ms, bound_by)`` of a kernel on the lines of length ``n``
    of an (H, W) plane: the bytes moved (each input plane read once, each
    output written once) over the HBM rate against 5 n log2 n flops a line
    (the FFT's least count, whatever the radices) over the f32 peak."""
    H, W = shape
    byte_ms = planes_moved * 4 * H * W / HBM_BYTES_PER_S * 1e3
    flop_ms = line_ffts * 5 * H * W * np.log2(n) / F32_FLOP_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= flop_ms else (flop_ms, "operations")


def device_ms_many(calls, n=10):
    """Device milliseconds per call of each of ``calls`` (name -> fn) from
    one ``torch.profiler`` session: a window of one call and one of ``n``
    for each, the device events whose midpoints lie in the window summed.
    A name whose window of ``n`` does not hold ``n`` times the events of
    one call (the profiler lost some) is timed by CUDA events instead.
    Returns name -> (ms, "device" or "events")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for name, fn in calls.items():
            for k in (1, n):
                with record_function(f"{name} x{k}"):
                    for _ in range(k):
                        fn()
                    torch.cuda.synchronize()
    events = prof.events()
    spans = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.endswith((" x1", f" x{n}")):
            spans[e.name] = (e.time_range.start, e.time_range.end, [])
    for e in events:
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        mid = (e.time_range.start + e.time_range.end) / 2
        for lo, hi, found in spans.values():
            if lo <= mid <= hi:
                found.append(e.time_range.elapsed_us())
    out = {}
    for name, fn in calls.items():
        one, many = spans.get(f"{name} x1"), spans.get(f"{name} x{n}")
        if one and many and one[2] and len(many[2]) == n * len(one[2]):
            out[name] = (sum(many[2]) / 1e3 / n, "device")
        else:
            out[name] = (cuda_ms(fn, n=n), "events")
    return out


def line_kernel_calls(shape, device, module):
    """name -> (call of each of the eleven line kernels of ``module`` (a
    ``cuda_fft``) at ``shape``, its plain version, the library call or
    None, (planes moved, line length, line FFTs)): the variants of
    phase_carry_timing (WGS-Kim with stats, scalar amplitude; MRAF at M1's
    Leonardo, the mix without Kim or zero weights)."""
    from slmsuite_torch.ops import fft

    H, W = shape
    x = mixed_inputs(shape, device)
    amp = 1.0 / np.sqrt(H * W)
    gr, gi = fft._wgs_carry_entry(x["psi"], amp)
    z = torch.complex(gr, gi)
    kw = dict(rule="kim", kim=True, stats_on=True)
    cols = (gr, gi, x["weights"], x["target"], x["mask"], x["phase_ff"], x["scal"])
    fwd = (gr, gi, x["weights"], x["target"], x["mask"], x["scal"])
    fr, fi, uw, sums, _ = fft._cols_mraf_fwd(*fwd, rule="leonardo", stats_on=True)
    mix = (fr, fi, uw, x["mcode"], None, None, sums, x["scal"])
    fwd_kim = (gr, gi, x["weights"], x["target"], x["mask"], x["angle"], x["scal"])
    w, phi = gr.abs(), gi
    K = module
    return {
        "rows_fft": (lambda: K.rows_fft(gr, gi, inverse=False),
                     lambda: fft._rows_fft(gr, gi, inverse=False),
                     lambda: torch.fft.fft(z, dim=-1), (4, W, 1)),
        "cols_fft": (lambda: K.cols_fft(gr, gi, inverse=False),
                     lambda: fft._cols_fft(gr, gi, inverse=False),
                     lambda: torch.fft.fft(z, dim=0), (4, H, 1)),
        "rows_normfwd": (lambda: K.rows_normfwd(gr, gi, amp),
                         lambda: fft._rows_normfwd(gr, gi, amp), None, (4, W, 2)),
        "cols_wgs_roundtrip": (lambda: K.cols_wgs_roundtrip(*cols, **kw),
                               lambda: fft._cols_wgs_roundtrip(*cols, **kw), None, (10, H, 2)),
        "carry_entry": (lambda: K.carry_entry(x["psi"], amp),
                        lambda: fft._wgs_carry_entry(x["psi"], amp), None, (3, W, 1)),
        "carry_exit": (lambda: K.carry_exit(gr, gi), lambda: fft._wgs_carry_exit(gr, gi),
                       None, (3, W, 1)),
        "cols_fwd_polar": (lambda: K.cols_fwd_polar(gr, gi, 1.0),
                           lambda: fft._cols_fwd_polar(gr, gi, 1.0), None, (4, H, 1)),
        "cols_wexp_inv": (lambda: K.cols_wexp_inv(w, phi), lambda: fft._cols_wexp_inv(w, phi),
                          None, (4, H, 1)),
        "cols_mraf_fwd": (lambda: K.cols_mraf_fwd(*fwd, rule="leonardo", stats_on=True),
                          lambda: fft._cols_mraf_fwd(*fwd, rule="leonardo", stats_on=True),
                          None, (8, H, 1)),
        "cols_mraf_mix_inv": (lambda: K.cols_mraf_mix_inv(*mix, kim=False, zero=False),
                              lambda: fft._cols_mraf_mix_inv(*mix, kim=False, zero=False),
                              None, (6, H, 1)),
        "cols_wgs_fwd": (lambda: K.cols_wgs_fwd(*fwd_kim, **kw),
                         lambda: fft._cols_wgs_fwd(*fwd_kim, **kw), None, (9, H, 1)),
    }


def phase_mixed_timing(device):
    """The eleven line kernels at MIXED_TIMED (1152x1920: mixed lines both
    ways; 8192^2: the four-pass line, columns on a cluster of four): device
    time of the kernel, its plain version and the library call (torch.fft
    along the same axis, for rows_fft and cols_fft), and the bound, from one
    profiler session a shape. Returns name -> {size: entry}."""
    from slmsuite_torch.ops import cuda_fft

    t = {}
    for shape in MIXED_TIMED:
        size = f"{shape[0]}x{shape[1]}"
        calls = line_kernel_calls(shape, device, cuda_fft)
        flat = {}
        for name, (kernel, plain, library, _) in calls.items():
            flat[name], flat[name + " plain"] = kernel, plain
            if library is not None:
                flat[name + " library"] = library
        ms = device_ms_many(flat)
        for name, (_, _, library, (planes, n, ffts)) in calls.items():
            bound_ms, bound_by = bound_lines(shape, planes, n, ffts)
            entry = dict(ms=ms[name][0], plain_ms=ms[name + " plain"][0],
                         library_ms=ms[name + " library"][0] if library else None,
                         bound_ms=bound_ms, bound_by=bound_by, timer=ms[name][1])
            t.setdefault(name, {})[size] = entry
            log(f"time {name} {size} ({entry['timer']}): kernel {entry['ms']:.4f} ms, plain "
                f"{entry['plain_ms']:.4f} ms"
                + (f", torch.fft {entry['library_ms']:.4f} ms" if library else "")
                + f", bound {bound_ms:.4f} ms ({bound_by}): {bound_ms / entry['ms']:.3f} of it")
        del calls, flat
        if shape == X2_SHAPE:
            mixed_composition_timing(shape, device)
    log(f"  [{nvidia_smi_line()}]")
    return t


def mixed_composition_timing(shape, device):
    """The compositions of the line kernels that one PyTorch call computes
    too, at ``shape`` (X2's plane), device time in turns with their plain
    versions and torch.fft.fft2 / ifft2 (ortho) of the complex plane:
    fft2 (rows_fft + cols_fft), ifft2 (cols_fft + rows_fft), wexp_ifft2
    (cols_wexp_inv + rows_fft) and ifft2_phase (cols_fft + carry_exit,
    torch.fft without the atan2). Bounds as phase_fft_timing's: the planes
    both launches move for fft2 and ifft2, the ends for the other two."""
    from slmsuite_torch.ops import cuda_fft, fft

    size = f"{shape[0]}x{shape[1]}"
    xr, xi = random_pair(shape, device)
    z = torch.complex(xr, xi)
    w, phi = xr.abs(), xi * np.pi
    zw = torch.polar(w, phi)
    n = max(shape)
    for name, kernel, plain, library, planes in (
            ("fft2 (rows_fft + cols_fft)", lambda: cuda_fft.fft2(xr, xi),
             lambda: fft._fft2(xr, xi), lambda: torch.fft.fft2(z, norm="ortho"), 8),
            ("ifft2 (cols_fft + rows_fft)", lambda: cuda_fft.ifft2(xr, xi),
             lambda: fft._ifft2(xr, xi), lambda: torch.fft.ifft2(z, norm="ortho"), 8),
            ("wexp_ifft2 (cols_wexp_inv + rows_fft)", lambda: cuda_fft.wexp_ifft2(w, phi),
             lambda: fft._wexp_ifft2(w, phi), lambda: torch.fft.ifft2(zw, norm="ortho"), 4),
            ("ifft2_phase (cols_fft + carry_exit)", lambda: cuda_fft.ifft2_phase(xr, xi),
             lambda: fft._ifft2_phase(xr, xi), lambda: torch.fft.ifft2(z, norm="ortho"), 3)):
        entry = interleaved(name, kernel, plain, library, bound_lines(shape, planes, n, 2), size,
                            timer=device_ms)
        log(f"  {name} {size}: {entry['bound'] / entry['kernel']:.3f} of its bound, "
            f"{entry['kernel'] / entry['library']:.3f} of torch.fft ({entry['timer']})")
    del xr, xi, z, w, phi, zw


#: The planes of the line kernels' A/B against the parent's: two of
#: power-of-two lines (outputs bit for bit the parent's), and five of mixed
#: lines, real panels at padding_order=0 among them (outputs held to X0's
#: limits against the plain versions: the order of the sums changed).
LINE_AB_POW2 = ((2048, 2048), (4096, 4096))
LINE_AB_MIXED = ((1152, 1920), (1080, 1920), (792, 1272), (1792, 4160), (6144, 1152))


@contextlib.contextmanager
def line_kernels_of(module):
    """This tree's dispatchers and compositions routed to the eleven line
    kernels' wrappers of ``module`` (a parent's ``cuda_fft``), for as long
    as the block runs: the compositions and the dispatchers look the
    wrappers up in this tree's ``cuda_fft`` at each call."""
    from slmsuite_torch.ops import cuda_fft

    saved = {name: getattr(cuda_fft, name) for name in cuda_fft.LINE_KERNELS}
    try:
        for name in cuda_fft.LINE_KERNELS:
            setattr(cuda_fft, name, getattr(module, name))
        yield
    finally:
        for name, fn in saved.items():
            setattr(cuda_fft, name, fn)


#: Iterations a call of X2's A/B device-time reading (x2_ab).
X2_AB_DEVICE_ITERS = 10


def x2_ab(device, parent):
    """X2's fused WGS-Kim, N1 (WGS-Nogrette, computational_spot) and G1 (CG)
    on the 1152x1920 plane through this tree's line kernels and through the
    parent's (``parent``, its ``cuda_fft``), in one process: wall ms an
    iteration in turns parent, this, this, parent, twice (medians of four;
    the loops are host-paced), then the device's ms an iteration (every
    device event of X2_AB_DEVICE_ITERS iterations under the profiler,
    :meth:`device_ms`) of each."""
    paths = {
        "X2 fused WGS-Kim": (lambda h, k: h.optimize(method="WGS-Kim", maxiter=k,
                                                     stat_groups=["computational"],
                                                     verbose=False), X2_ITERS),
        "X2 N1 WGS-Nogrette": (lambda h, k: h.optimize(
            method="WGS-Nogrette", maxiter=k, feedback="computational_spot",
            stat_groups=["computational", "computational_spot"], verbose=False), X2_ITERS),
        "X2 G1 CG": (lambda h, k: cg_optimize(h, k, G1_LR), X2_CG_ITERS),
    }
    for label, (optimize, n) in paths.items():
        holo = spot_array(device, X2_ARRAY, X2_PITCH, shape=X2_SHAPE)
        run = lambda k: optimize(holo, k)  # noqa: E731

        def kernels_of(who):
            return line_kernels_of(parent) if who == "parent" else contextlib.nullcontext()

        wall = {"this": [], "parent": []}
        for _ in range(2):
            for who in ("parent", "this", "this", "parent"):
                with kernels_of(who):
                    wall[who].append(wall_ms(run, n))
        busy = {}
        for who in ("parent", "this"):
            with kernels_of(who):
                try:
                    busy[who] = device_ms(lambda: run(X2_AB_DEVICE_ITERS), n=2) / X2_AB_DEVICE_ITERS
                except NoDeviceEvents:
                    busy[who] = float("nan")
        this, par = float(np.median(wall["this"])), float(np.median(wall["parent"]))
        log(f"A/B {label} {X2_SHAPE[0]}x{X2_SHAPE[1]}, {n} iterations, wall ms an iteration: "
            f"this " + " ".join(f"{v:.3f}" for v in wall["this"]) + ", parent "
            + " ".join(f"{v:.3f}" for v in wall["parent"])
            + f"; medians {this:.3f} / {par:.3f} = {this / par:.4f}; device ms an iteration "
            f"{busy['this']:.4f} / {busy['parent']:.4f} = {busy['this'] / busy['parent']:.4f}")
        del holo, run


def line_ab(device, parent_root):
    """The eleven line kernels of this tree against the parent's (the port
    unpacked at ``parent_root``), in one process: both builds timed; on
    LINE_AB_POW2 the outputs bit for bit the parent's, on LINE_AB_MIXED held
    to X0's limits against the plain versions (mixed_plane_checks); device
    time in turns parent, this, this, parent, twice (medians of four), from
    one profiler session a plane and round (a kernel whose window the
    profiler cut is timed there by CUDA events, which the median leaves
    out); then X2's paths (x2_ab)."""
    from slmsuite_torch.ops import cuda_fft

    parent = parent_port(parent_root, "slmsuite_torch.ops.cuda_fft")
    _, seconds, _ = parent.build()
    parent._lib()
    log(f"build: parent's library in {seconds:.1f} s (this tree's: the build line above)")
    for shape in LINE_AB_POW2 + LINE_AB_MIXED:
        size = f"{shape[0]}x{shape[1]}"
        this_calls = line_kernel_calls(shape, device, cuda_fft)
        parent_calls = line_kernel_calls(shape, device, parent)
        readings = {name: {"this": [], "parent": []} for name in this_calls}
        if shape in LINE_AB_POW2:
            for name in this_calls:
                a, b = this_calls[name][0](), parent_calls[name][0]()
                a = a if isinstance(a, tuple) else (a,)
                b = b if isinstance(b, tuple) else (b,)
                same = all(torch.equal(u, v) for u, v in zip(a, b) if torch.is_tensor(u))
                log(f"A/B {name} {size}: outputs {'bit for bit' if same else 'differ'}")
                assert same, f"{name} {size}: the power-of-two outputs differ from the parent's"
        else:
            worst, lines = {}, []
            mixed_plane_checks(shape, device,
                               lambda name, e: worst.__setitem__(name, max(worst.get(name, 0), e)),
                               lines)
            log(f"A/B {size}: every line kernel within X0's limits of its plain version; "
                "largest relative error " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
        for _ in range(2):
            for who in ("parent", "this", "this", "parent"):
                source = this_calls if who == "this" else parent_calls
                ms = device_ms_many({name: call[0] for name, call in source.items()})
                for name, reading in ms.items():
                    readings[name][who].append(reading)

        def median(r):
            # A reading that fell back to CUDA events reads the host's
            # enqueue: the median is the device readings' where there are any.
            device = [v for v, timer in r if timer == "device"]
            return float(np.median(device or [v for v, _ in r]))

        def shown(r):
            return " ".join(f"{v:.4f}{'' if timer == 'device' else 'e'}" for v, timer in r)

        for name, r in readings.items():
            this, par = median(r["this"]), median(r["parent"])
            planes, n, ffts = this_calls[name][3]
            bound_ms, _ = bound_lines(shape, planes, n, ffts)
            log(f"A/B {name} {size} (device; e: CUDA events, left out of the median): this "
                + shown(r["this"]) + " ms, parent " + shown(r["parent"])
                + f" ms; medians {this:.4f} / {par:.4f} = {this / par:.4f}; "
                f"{bound_ms / this:.3f} of the bound, parent {bound_ms / par:.3f}")
        del this_calls, parent_calls
        torch.cuda.empty_cache()
    x2_ab(device, parent)
    log(f"  [{nvidia_smi_line()}]")


# ----------------------------------------------------------------------
# The mesh engines on one card: D0-D3.
# ----------------------------------------------------------------------

#: Shards of D0-D3, all on the one card (``[cuda:0] * 4``).
MESH_SHARDS = 4
#: D0's distributed FFT and D1's plane: the largest side the kernels take.
D0_SIDE, D1_SIDE, D1_ITERS = 8192, 8192, 20
#: D1's target: spot_array_target's 32x32 grid at N // 70.
D1_SPOTS, D1_SPACING_DIV = 32, 70
#: D2's iterations of the batched model and of P3's hologram, and D3's.
D2_ITERS, D3_ITERS = 20, CONFIG5_ITERS
#: Mesh against meshless, tests/test_parallel.py's bounds: the plane's
#: wrapped psi and efficiency; the multiplane's psi and stats; the
#: compressed wrapped psi, amp_ff and uniformity. The plane's psi is held
#: at its largest over the pixels whose last nearfield amplitude is above
#: MESH_PLANE_NEARFIELD of the largest (99.98% of D1's pixels; every row
#: and column has them): its angle is ill-conditioned where that field
#: nearly vanishes. On an H100 at 8192^2 after 20 iterations, the meshless
#: kernels and their plain versions differ there by up to 3.0e-4, and by
#: 3.0e-3 above 1e-3 of the largest, so a tighter mask would test f32
#: rounding, not the mesh: above 1e-3 the mesh is held to that difference,
#: measured in the same phase. The weights' bounds, which tests/test_parallel.py
#: does not set, are about ten and seventy times the H100's readings (8.7e-7
#: of the largest weight on the plane, 1.5e-8 on the compressed spots).
MESH_PLANE_PSI, MESH_PLANE_EFF, MESH_PLANE_NEARFIELD = 5e-4, 1e-4, 1e-2
MESH_PLANE_WEIGHTS = 1e-5
MESH_MP_PSI, MESH_MP_STATS = 5e-4, 1e-3
MESH_CMP_PSI, MESH_CMP_AMP, MESH_CMP_UNIFORMITY, MESH_CMP_WEIGHTS = 1e-3, 1e-5, 1e-4, 1e-6


def mesh_of(device, axis):
    from slmsuite_torch.parallel.mesh import make_mesh

    return make_mesh(axis_names=(axis,), devices=[device] * MESH_SHARDS)


def counted_all(fn):
    """``fn()`` with both launch counters set to 0 just before it; returns
    ``(result, launches, seconds)``."""
    from slmsuite_torch.ops import cuda_compressed, cuda_fft

    cuda_fft.reset_launch_counts()
    cuda_compressed.reset_launch_counts()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    launches = {k: v for m in (cuda_fft, cuda_compressed) for k, v in m.LAUNCHES.items() if v}
    return out, launches, time.perf_counter() - start


def per_shard(launches):
    """Launches a shard (every shard launches each kernel once a step)."""
    return {k: v // MESH_SHARDS if v % MESH_SHARDS == 0 else v / MESH_SHARDS
            for k, v in launches.items()}


def peak_gib(fn):
    """``(fn(), peak device memory in GiB during it)``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2**30


def mesh_turns(label, mesh_run, single_run, n):
    """ms an iteration of ``mesh_run(n)`` and ``single_run(n)`` by
    :meth:`loop_ms`, in turns: mesh, meshless, meshless, mesh."""
    m1 = loop_ms(mesh_run, n)
    s1, s2 = loop_ms(single_run, n), loop_ms(single_run, n)
    m2 = loop_ms(mesh_run, n)
    log(f"{label} run({n}): mesh {m1:.4f} {m2:.4f} ms/iter, meshless {s1:.4f} {s2:.4f} "
        f"ms/iter  [{nvidia_smi_line()}]")
    return (m1 + m2) / 2, (s1 + s2) / 2


def wrapped_max(a, b, where=None):
    """Largest wrapped difference of two phase tensors (over the pixels
    ``where`` is true, when given)."""
    d = (torch.remainder(a.float() - b.float() + np.pi, 2 * np.pi) - np.pi).abs()
    return float((d if where is None else d[where]).max())


def phase_d0(device):
    """D0: ``distributed_fft2`` and ``distributed_ifft2`` at 8192^2 on four
    shards (``rows_fft`` twice a shard) against the one-device ``fft2`` and
    ``ifft2`` kernels, ms of each in turns (and of the shards' transform
    alone, without the API's split and gather), peak memory; then
    ``dryrun_multichip(4)`` on ``[cuda:0] * 4``. Returns the launches a
    shard."""
    from slmsuite_torch.models.parallel_models import dryrun_multichip
    from slmsuite_torch.ops import fft
    from slmsuite_torch.ops import collectives as C
    from slmsuite_torch.parallel.fft2d import (
        distributed_fft2,
        distributed_ifft2,
        fft2_shards,
    )

    label = f"D0 distributed fft2 {D0_SIDE}^2 over {MESH_SHARDS} shards"
    mesh = mesh_of(device, "space")
    gen = torch.Generator(device=device).manual_seed(0)
    shape = (D0_SIDE, D0_SIDE)
    xr = torch.randn(shape, device=device, generator=gen)
    xi = torch.randn(shape, device=device, generator=gen)
    x = torch.complex(xr, xi)
    (y, launches, _), mesh_peak = peak_gib(lambda: counted_all(lambda: distributed_fft2(x, mesh)))
    assert launches == {"rows_fft": 2 * MESH_SHARDS}, launches
    (ref, single_launches, _), single_peak = peak_gib(lambda: counted_all(lambda: fft.fft2(xr, xi)))
    assert single_launches == {"rows_fft": 1, "cols_fft": 1}, single_launches
    scale = float(torch.maximum(ref[0].abs().max(), ref[1].abs().max()))
    err = max(float((y.real - ref[0]).abs().max()), float((y.imag - ref[1]).abs().max())) / scale
    back, inv_launches, _ = counted_all(lambda: distributed_ifft2(y, mesh))
    assert inv_launches == {"rows_fft": 2 * MESH_SHARDS}, inv_launches
    ref_back = fft.ifft2(*ref)
    err_inv = max(float((back.real - ref_back[0]).abs().max()),
                  float((back.imag - ref_back[1]).abs().max())) / float(xr.abs().max())
    log(f"{label}: fft2 max |mesh - fft2 kernels| / max {err:.3e}, ifft2 {err_inv:.3e}; "
        f"launches a shard {per_shard(launches)}; peak device memory mesh {mesh_peak:.3f} GiB, "
        f"one device {single_peak:.3f} GiB")
    assert err <= CARRY_RTOL and err_inv <= CARRY_RTOL, (err, err_inv)
    del y, back, ref_back
    devices = mesh.axis_devices("space")
    re, im = C.split(xr, devices), C.split(xi, devices)
    calls = {"api": lambda: distributed_fft2(x, mesh),
             "shards": lambda: fft2_shards(re, im, inverse=False),
             "single": lambda: fft.fft2(xr, xi)}
    times = {name: [] for name in calls}
    for name in ("api", "shards", "single", "single", "shards", "api"):
        times[name].append(cuda_ms(calls[name], n=5, warmup=1))
    log(f"{label} ms a call: distributed_fft2 {times['api']}, the shards' transform "
        f"{times['shards']}, fft2 kernels on one device {times['single']}  "
        f"[{nvidia_smi_line()}]")
    del x, xr, xi, re, im, ref
    errors, dry_launches, seconds = counted_all(
        lambda: dryrun_multichip(MESH_SHARDS, devices=[device] * MESH_SHARDS))
    log(f"D0 dryrun_multichip({MESH_SHARDS}) on [{device}] * {MESH_SHARDS} in {seconds:.2f} s: "
        f"{errors}; launches {dry_launches}")
    return per_shard(launches)


def d1_hologram(device):
    """D1: a full-plane 8192^2 Hologram of spot_array_target's 32x32 grid,
    from a seeded phase."""
    from slmsuite_torch.holography.algorithms import Hologram
    from slmsuite_torch.models.engine_models import spot_array_target

    target = spot_array_target(D1_SIDE, D1_SPOTS, D1_SPACING_DIV)
    holo = Hologram(target, device=device)
    rng = np.random.default_rng(0)
    holo.reset_phase(custom_phase=rng.uniform(-np.pi, np.pi, target.shape).astype(np.float32))
    return holo


def phase_d1(device):
    """D1: the 8192^2 plane through ``Hologram.optimize(mesh=...)``, rows
    over four shards, WGS-Kim with computational stats, against the same
    hologram without a mesh (the fused carry loop): exact launches a shard,
    psi (beside the meshless kernels against their plain versions), weights
    and stats, peak memory, and ms an iteration of the two engine loops in
    turns. Returns the launches a shard."""
    from slmsuite_torch.ops import engine
    from slmsuite_torch.parallel.plane import run_sharded_plane_gs

    label = f"D1 Hologram {D1_SIDE}^2 WGS-Kim, rows over {MESH_SHARDS} shards"
    n = D1_ITERS
    mesh = mesh_of(device, "rows")
    runs = {}
    last = {}
    for name, m in (("mesh", mesh), ("single", None)):
        holo = d1_hologram(device)
        split = launches_split_at_populate(holo)
        if m is None:
            # The last backward's weights and phase store, as the loop leaves
            # them (_populate_results replaces the phase store).
            counted_populate = holo._populate_results

            def keep_last(holo=holo, populate=counted_populate):
                last["weights"] = type(holo).weights.device(holo, device)
                last["phase_ff"] = type(holo)._phase_ff_folded.device(holo, device)
                populate()

            holo._populate_results = keep_last
        _, peak = peak_gib(lambda: holo.optimize("WGS-Kim", maxiter=n, verbose=False, mesh=m,
                                                 stat_groups=["computational"]))
        loop, after = split()
        del holo._populate_results
        stats = np.stack([holo.stats["stats"]["computational"][k]
                          for k in ("efficiency", "uniformity", "pkpk_err", "std_err")], -1)
        runs[name] = (holo, loop, after, peak, stats)
        log(f"{label} ({name}): final efficiency {stats[-1, 0]:.6f}, uniformity "
            f"{stats[-1, 1]:.6f}; loop launches {loop}, after {after}; peak device memory "
            f"{peak:.3f} GiB")
    holo, loop, after, _, stats = runs["mesh"]
    single, _, _, _, single_stats = runs["single"]
    S = MESH_SHARDS
    assert loop == dict(carry_entry=n * S, rows_fft=2 * n * S, carry_exit=n * S), loop
    assert after == dict(rows_fft=1, cols_fft=1), after
    # psi is the angle of the last backward's nearfield, ill-conditioned
    # where that field vanishes: held where its amplitude is above
    # MESH_PLANE_NEARFIELD of its largest (and logged above 1e-3 of it).
    nearfield = torch.fft.ifft2(torch.polar(last["weights"], last["phase_ff"])).abs()
    lit = nearfield > MESH_PLANE_NEARFIELD * nearfield.max()
    dim_lit = nearfield > 1e-3 * nearfield.max()
    psi, psi_single = (type(h)._psi.device(h, device) for h in (holo, single))
    psi_max = wrapped_max(psi, psi_single)
    psi_lit = wrapped_max(psi, psi_single, lit)
    psi_dim_lit = wrapped_max(psi, psi_single, dim_lit)
    # The meshless kernels against their plain versions, the f32 floor at
    # this size: the mesh is held no further from the kernels above 1e-3.
    plain = d1_hologram(device)
    with plain_step_functions():
        plain.optimize("WGS-Kim", maxiter=n, verbose=False, stat_groups=["computational"])
    psi_plain = type(plain)._psi.device(plain, device)
    plain_lit = wrapped_max(psi_plain, psi_single, lit)
    plain_dim_lit = wrapped_max(psi_plain, psi_single, dim_lit)
    del plain, psi_plain
    w = type(holo).weights.device(holo, device)
    w_single = type(single).weights.device(single, device)
    w_err = float((w - w_single).abs().max() / w_single.abs().max())
    d_stats = np.abs(stats - single_stats).max(axis=0)
    log(f"{label}: mesh against meshless: psi wrapped max {psi_lit:.3e} over the "
        f"{int(lit.sum())} of {lit.numel()} pixels whose nearfield amplitude is above "
        f"{MESH_PLANE_NEARFIELD:g} of its largest ({psi_dim_lit:.3e} over the "
        f"{int(dim_lit.sum())} above 1e-3, {psi_max:.3e} over all), weights max |diff| / "
        f"max {w_err:.3e}, stats max |diff| [efficiency, uniformity, pkpk_err, std_err] "
        f"{d_stats.tolist()}; the meshless kernels against their plain versions: psi "
        f"wrapped max {plain_lit:.3e} above {MESH_PLANE_NEARFIELD:g}, {plain_dim_lit:.3e} "
        f"above 1e-3")
    assert psi_lit <= MESH_PLANE_PSI and d_stats[0] <= MESH_PLANE_EFF, (psi_lit, d_stats)
    assert psi_dim_lit <= plain_dim_lit, (psi_dim_lit, plain_dim_lit)
    assert w_err <= MESH_PLANE_WEIGHTS, w_err
    del runs, holo, single, w, w_single, psi, psi_single, nearfield, lit, dim_lit, last

    fresh = d1_hologram(device)
    fresh._update_flags("WGS-Kim", False, None, ["computational"])
    config = fresh._build_config()
    consts = fresh._build_consts(config)
    state = fresh._build_state(config)
    mesh_turns(label, lambda k: run_sharded_plane_gs(config, state, consts, mesh, k, "rows"),
               lambda k: engine.run_gs(config, state, consts, k), n)
    return per_shard(loop)


def phase_d2(device):
    """D2: P1's 8 x 1024^2 through ``run_batched_gs(mesh=...)`` over a data
    axis of four, P3's ``MultiplaneHologram`` through ``optimize(mesh=...)``
    and P4's ``optimize_batch`` of 8 frames over four, each against its
    meshless run (launches a shard, psi, weights and stats; P4 bit for
    bit), peak memory, and ms an iteration of P1's loop in turns. Returns
    the launches a shard of P1's loop."""
    from slmsuite_torch.holography.algorithms import optimize_batch
    from slmsuite_torch.models.parallel_models import multiplane_batched

    n, S = D2_ITERS, MESH_SHARDS
    mesh = mesh_of(device, "data")
    label = f"D2 multiplane {MP_PLANES} x {MP_SIDE}^2 WGS-Kim, planes over {S} shards"
    run = multiplane_batched(MP_PLANES, N=MP_SIDE, device=device)
    ((psi, weights, stats, _, fixed), launches, seconds), peak = peak_gib(
        lambda: counted_all(lambda: run(mesh, n)))
    (ref_psi, ref_w, ref_stats, _, ref_fixed), single_peak = peak_gib(lambda: run(None, n))
    assert launches == dict(carry_entry=n * S, cols_fwd_polar=n * S, cols_wexp_inv=n * S,
                            rows_fft=n * S), launches
    psi_max = wrapped_max(psi, ref_psi)
    w_err = float((weights - ref_w).abs().max() / ref_w.abs().max())
    d_stats = float((stats[..., :4] - ref_stats[..., :4]).abs().max())
    log(f"{label}: launches a shard {per_shard(launches)} in {seconds:.2f} s; against "
        f"meshless: psi wrapped max {psi_max:.3e}, weights {w_err:.3e}, stats max |diff| "
        f"{d_stats:.3e}, Kim flags equal {bool(torch.equal(fixed, ref_fixed))}; peak device "
        f"memory mesh {peak:.3f} GiB, one device {single_peak:.3f} GiB")
    assert psi_max <= MESH_MP_PSI and d_stats <= MESH_MP_STATS, (psi_max, d_stats)
    mesh_turns(label, lambda k: run(mesh, k), lambda k: run(None, k), n)

    holos = {}
    for name, m in (("mesh", mesh), ("single", None)):
        holo = p3_hologram(device)
        split = launches_split_at_populate(holo)
        holo.optimize("WGS-Kim", maxiter=P3_ITERS, verbose=False, mesh=m,
                      stat_groups=["computational"])
        holos[name] = (holo, *split(), child_stats(holo.holograms))
        del holo._populate_results
    (holo, loop, _, st), (single, _, _, single_st) = holos["mesh"], holos["single"]
    m = P3_ITERS
    assert loop == dict(carry_entry=m * S, cols_fwd_polar=m * S, cols_wexp_inv=m * S,
                        rows_fft=m * S), loop
    p3_max = wrapped_max(type(holo)._psi.device(holo, device),
                         type(single)._psi.device(single, device))
    d3 = float(np.abs(st - single_st).max())
    log(f"D2 P3 MultiplaneHologram.optimize(mesh=...): loop launches a shard {per_shard(loop)}; "
        f"against meshless: psi wrapped max {p3_max:.3e}, per-child efficiency and uniformity "
        f"max |diff| {d3:.3e}")
    assert p3_max <= MESH_MP_PSI and d3 <= MESH_MP_STATS, (p3_max, d3)
    del holos, holo, single

    frames = {}
    for name, m in (("mesh", mesh), ("single", None)):
        fs = p4_frames(device)
        _, batch_launches, seconds = counted_all(lambda: optimize_batch(
            fs, "WGS-Kim", maxiter=P4_ITERS, verbose=False, stat_groups=["computational"],
            mesh=m))
        frames[name] = (fs, batch_launches, seconds)
    (fs, batch_launches, seconds), (solo, solo_launches, solo_seconds) = (
        frames["mesh"], frames["single"])
    for b, (h, s) in enumerate(zip(fs, solo)):
        assert np.array_equal(h.get_phase(), s.get_phase()), b
        assert h.stats["stats"] == s.stats["stats"], b
    assert batch_launches == solo_launches, (batch_launches, solo_launches)
    log(f"D2 P4 optimize_batch {MP_PLANES} frames over {S} shards: phases and stats identical "
        f"to the meshless batch; launches {batch_launches} ({per_shard(batch_launches)} a "
        f"shard); {seconds:.3f} s against {solo_seconds:.3f} s")
    return per_shard(launches)


def phase_d3(device):
    """D3: config 5 through ``CompressedSpotHologram.optimize(mesh=...)``,
    pixels over four shards, against the recomputing C2 loop on one device
    (the cache is off under a mesh): launches a shard, amp_ff, weights,
    uniformity and psi, peak memory, and ms an iteration of the two engine
    loops in turns. Returns the launches a shard."""
    from slmsuite_torch.ops import compressed
    from slmsuite_torch.parallel.compressed import (
        run_sharded_compressed_gs,
        shard_compressed_consts,
    )

    n, S = D3_ITERS, MESH_SHARDS
    label = f"D3 config 5 WGS-Kim {n} iterations, pixels over {S} shards"
    mesh = mesh_of(device, "pixels")
    runs = {}
    with env_var("SLMSUITE_TORCH_COMPRESSED_CACHE_MB", "0"):
        for name, m in (("mesh", mesh), ("single", None)):
            holo = config5_hologram(device)
            # The loop ends where the hologram adopts its final state.
            split = launches_split_at(holo, "_finalize_scan_fused")
            start = time.perf_counter()
            _, peak = peak_gib(lambda: holo.optimize(
                "WGS-Kim", maxiter=n, verbose=False, mesh=m, stat_groups=["computational_spot"]))
            seconds = time.perf_counter() - start
            loop, after = split()
            del holo._finalize_scan_fused
            assert not holo._kernel_cache_enabled()
            runs[name] = (holo, loop, after)
            log(f"{label} ({name}): loop launches {loop}, after {after} in {seconds:.2f} s; "
                f"peak device memory {peak:.3f} GiB")
    (holo, loop, after), (single, single_loop, single_after) = runs["mesh"], runs["single"]
    # Each shard: n2f at entry, fused_iter an iteration, f2n at exit; then
    # the hologram's n2f of the gathered phase (the final farfield).
    assert loop == dict(n2f=S, fused_iter=n * S, f2n=S), loop
    assert single_loop == dict(n2f=1, fused_iter=n, f2n=1), single_loop
    assert after == single_after == dict(n2f=1), (after, single_after)
    amp_err = float(np.abs(holo.amp_ff - single.amp_ff).max())
    w_err = float(np.abs(np.asarray(holo.weights) - np.asarray(single.weights)).max())
    u = [np.asarray(h.stats["stats"]["computational_spot"]["uniformity"]) for h in (holo, single)]
    u_err = float(np.abs(u[0] - u[1]).max())
    psi_max = wrapped_max(type(holo)._psi.device(holo, device),
                          type(single)._psi.device(single, device))
    log(f"{label}: against the recomputing loop: amp_ff max |diff| {amp_err:.3e}, weights "
        f"{w_err:.3e}, uniformity {u_err:.3e}, psi wrapped max {psi_max:.3e}")
    assert amp_err <= MESH_CMP_AMP and u_err <= MESH_CMP_UNIFORMITY, (amp_err, u_err)
    assert w_err <= MESH_CMP_WEIGHTS and psi_max <= MESH_CMP_PSI, (w_err, psi_max)

    fresh = config5_hologram(device)
    fresh._update_flags("WGS-Kim", False, None, ["computational_spot"])
    with env_var("SLMSUITE_TORCH_COMPRESSED_CACHE_MB", "0"):
        config = fresh._compressed_config(kernel_cache=False)
        consts = fresh._compressed_consts(kernel_cache=False)
    state = fresh._compressed_state()
    shards = shard_compressed_consts(consts, mesh)
    mesh_turns(label, lambda k: run_sharded_compressed_gs(config, state, shards, mesh, k),
               lambda k: compressed.run_compressed_gs(config, state, consts, k), n)
    return per_shard(loop)


def phase_mesh(device):
    """D0-D3, the mesh engines on four shards of the one card. Returns the
    launches a shard of each path."""
    return {"D0": phase_d0(device), "D1": phase_d1(device), "D2": phase_d2(device),
            "D3": phase_d3(device)}


# ----------------------------------------------------------------------
# X3: planes whose sides the kernels do not take run the plain tier on the
# card (PLAIN_ON_DEVICE counts each dispatch), against the CPU.
# ----------------------------------------------------------------------

#: X3's planes: a Santec SLM-100's 1050x1440 panel at padding_order=0
#: (WGS-Kim), and 100x128 (GS).
X3_RUNS = (((1050, 1440), "WGS-Kim", 20), ((100, 128), "GS", 20))
#: Iterations before X3's timed ones (the FFT plans of the odd sides).
X3_WARMUP = 5
#: X3 and E1-E8, the card against the CPU or kernels against plain: what
#: users read (PERF.md section 2).
STAT_ATOL, COMPRESSED_STAT_ATOL = 1e-3, 2e-3


def x3_run(shape, method, n, device):
    """A 10x10 spot array on the SLM's own plane (padding_order=0) from a
    seeded phase, X3_WARMUP iterations, then ``n`` timed: ``(efficiency,
    uniformity, seconds of the n)``."""
    from slmsuite_torch.holography.algorithms import SpotHologram

    holo = SpotHologram.make_rectangular_array(
        shape, array_shape=(10, 10), array_pitch=(shape[0] // 14, shape[1] // 14),
        basis="knm", device=device)
    holo.reset_phase(custom_phase=np.random.default_rng(3).uniform(-np.pi, np.pi, shape))
    holo.optimize(method, maxiter=X3_WARMUP, verbose=False, stat_groups=["computational"])
    if device.type == "cuda":
        torch.cuda.synchronize()
    start = time.perf_counter()
    holo.optimize(method, maxiter=n, verbose=False, stat_groups=["computational"])
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    stats = holo.stats["stats"]["computational"]
    return float(stats["efficiency"][-1]), float(stats["uniformity"][-1]), seconds


def phase_plain_tier(device):
    """X3: each plane through the plain tier on the card (no kernel launch,
    PLAIN_ON_DEVICE > 0), its efficiency and uniformity within STAT_ATOL of
    the same run on the CPU, and its ms an iteration."""
    from slmsuite_torch.ops import cuda_compressed, cuda_fft, fft

    out = {}
    for shape, method, n in X3_RUNS:
        label = f"{shape[0]}x{shape[1]} {method}"
        fft.reset_plain_count()
        (eff, uni, seconds), launches, _ = counted_all(lambda: x3_run(shape, method, n, device))
        plain_dispatches = fft.PLAIN_ON_DEVICE
        assert not launches, f"X3 {label}: kernels launched {launches}"
        assert plain_dispatches > 0, f"X3 {label}: no dispatch took the plain tier"
        ceff, cuni, cpu_seconds = x3_run(shape, method, n, torch.device("cpu"))
        log(f"X3 {label}: card efficiency {eff:.6f} uniformity {uni:.6f}, cpu {ceff:.6f} "
            f"{cuni:.6f}; {plain_dispatches} plain dispatches, 0 launches; "
            f"{1e3 * seconds / n:.3f} ms an iteration on the card ({1e3 * cpu_seconds / n:.3f} "
            f"on the CPU) [{nvidia_smi_line()}]")
        assert abs(eff - ceff) <= STAT_ATOL and abs(uni - cuni) <= STAT_ATOL, label
        out[label] = dict(ms_per_iteration=1e3 * seconds / n, plain_dispatches=plain_dispatches)
    fft.reset_plain_count()
    cuda_fft.reset_launch_counts()
    cuda_compressed.reset_launch_counts()
    return out


# ----------------------------------------------------------------------
# E1-E8: the examples, through the kernels and through the plain versions.
# ----------------------------------------------------------------------


@contextlib.contextmanager
def plain_everything():
    """Every dispatcher the examples reach plain (``plain_gradients``, and
    the mesh engines' row transforms and pixel-slab overlaps): no kernel
    launches."""
    from slmsuite_torch.ops import compressed, fft

    saved = compressed.nearfield_overlap
    compressed.nearfield_overlap = lambda re, im, coeffs, basis: \
        compressed._nearfield_to_farfield(re, im, coeffs, basis, normalize=False)
    try:
        with plain_gradients(), plain_versions(fft, ("rows_fft",)):
            yield
    finally:
        compressed.nearfield_overlap = saved


#: label -> (example module, keyword arguments). The defaults are the
#: reference examples' sizes; E2b is the headline 2048^2 width and E1 the
#: nine patterns on a 1920x1152 SLM.
EXAMPLES = {
    "E1 structured_light 1920x1152": ("structured_light", dict(resolution=(1920, 1152))),
    "E2 computational_holography 512^2": ("computational_holography", {}),
    "E2b computational_holography 2048^2": ("computational_holography",
                                            dict(shape=(2048, 2048))),
    "E3 batched_holography": ("batched_holography", {}),
    "E4 zernike_holography": ("zernike_holography", {}),
    "E5 experimental_holography": ("experimental_holography", {}),
    "E6 multichip_scaling": ("multichip_scaling", {}),
    "E7 wavefront_calibration": ("wavefront_calibration", {}),
    "E8 multipoint_calibration": ("multipoint_calibration", {}),
}

#: What each example prints, kernels against plain: (absolute, relative)
#: tolerance by key; efficiencies and uniformities at STAT_ATOL, the
#: compressed and camera-measured ones at COMPRESSED_STAT_ATOL. The
#: computational example's MRAF ring is uniform and centred, so its noise
#: region has no unique optimum: runs that differ in rounding alone end up
#: to 1e-2 apart in signal efficiency after its 30 iterations (0.5882
#: through the kernels, 0.5785 plain, at 512^2 on an H100), where its spot
#: array agrees to 2e-7; ``mraf_efficiency`` is held at MRAF_RING_ATOL.
MRAF_RING_ATOL = 2e-2
EXAMPLE_TOL = {
    "mraf_efficiency": (MRAF_RING_ATOL, 0),
    "lattice_efficiency": (COMPRESSED_STAT_ATOL, 0), "lattice_uniformity": (COMPRESSED_STAT_ATOL, 0),
    "compressed_uniformity": (COMPRESSED_STAT_ATOL, 0),
    "measured_uniformity": (COMPRESSED_STAT_ATOL, 0),
    "lattice_cv": (COMPRESSED_STAT_ATOL, 0), "custom_cv": (COMPRESSED_STAT_ATOL, 0),
    "cg_loss": (1e-9, 0.1), "placement_error_px": (1.0, 0),
    "peak_before": (0, 0.05), "peak_after": (0, 0.05), "strehl_gain": (0, 0.1),
    "term_2": (0.05, 0), "term_3": (0.05, 0), "term_4": (0.05, 0),
    "patterns": (0, 0), "phase_min": (0, 0), "phase_max": (0, 0),
}


def example_agrees(key, got, ref):
    atol, rtol = EXAMPLE_TOL.get(key, (STAT_ATOL, 0))
    return abs(got - ref) <= atol + rtol * abs(ref)


def phase_examples(device):
    """E1-E8: each example (``remote_hardware`` drives the wire protocol,
    not the device, and runs in the tests) called in this process with
    ``device`` and no plots, once through the kernels and once through the
    plain versions; what it returns held between the two (EXAMPLE_TOL);
    its launches, seconds and peak memory logged. Returns the launches of
    each run through the kernels."""
    import importlib

    from slmsuite_torch.ops import fft

    def seeded(module, kwargs):
        # The examples draw their initial phases from numpy's global
        # generator: both runs start from the same draws.
        np.random.seed(0)
        return module.main(device=device, plots=False, **kwargs)

    launches_by_example, failures = {}, []
    state = np.random.get_state()
    for label, (module_name, kwargs) in EXAMPLES.items():
        module = importlib.import_module(f"slmsuite_torch.examples.{module_name}")
        fft.reset_plain_count()
        (got, launches, seconds), peak = peak_gib(
            lambda: counted_all(lambda: seeded(module, kwargs)))
        plain_dispatches = fft.PLAIN_ON_DEVICE
        with plain_everything():
            (ref, plain_launches, plain_seconds), plain_peak = peak_gib(
                lambda: counted_all(lambda: seeded(module, kwargs)))
        assert not plain_launches, f"{label}: the plain run launched {plain_launches}"
        bad = [k for k in got if isinstance(got[k], float) and not example_agrees(k, got[k], ref[k])]
        failures += [f"{label} {k}: kernels {got[k]} plain {ref[k]}" for k in bad]
        log(f"{label}: kernels {json.dumps(got)} in {seconds:.2f} s, peak {peak:.3f} GiB, "
            f"launches {launches}, plain-tier dispatches {plain_dispatches}; plain "
            f"{json.dumps(ref)} in {plain_seconds:.2f} s, peak {plain_peak:.3f} GiB"
            + (f"; DISAGREE {bad}" if bad else ""))
        launches_by_example[label.split()[0]] = launches
    log(f"  [{nvidia_smi_line()}]")
    np.random.set_state(state)
    fft.reset_plain_count()
    assert not failures, failures
    return launches_by_example


# ----------------------------------------------------------------------
# M1-M2: the memory helpers and misc.profile on the card.
# ----------------------------------------------------------------------


def phase_memory(device):
    """M1: ``suggest_memory_strategy`` from the card's own budget, and the
    ``set_``/``get_mempool_limit`` round trip."""
    from slmsuite_torch.holography.algorithms import Hologram

    total = torch.cuda.mem_get_info(device)[1]
    assert Hologram.get_mempool_limit(0) == total
    for shape in ((2048, 2048), (8192, 8192), (32768, 32768)):
        advice = Hologram.suggest_memory_strategy(shape)
        log(f"M1 suggest_memory_strategy{shape}: {advice}")
        assert advice["budget"] is None and advice["max_side"] > 8192
    Hologram.set_mempool_limit(0, fraction=0.5)
    try:
        half = Hologram.get_mempool_limit(0)
        assert half == int(total * 0.5), (half, total)
        assert Hologram.suggest_memory_strategy((1, 1))["max_side"] < \
            Hologram._memory_constrained_side(total)
    finally:
        Hologram.set_mempool_limit(0, fraction=1.0)
    assert Hologram.get_mempool_limit(0) == total
    log(f"M1 mempool limit: {total} bytes, {half} at fraction 0.5, restored "
        f"[{nvidia_smi_line()}]")


def phase_profile_helpers(device):
    """M2: ``misc.profile`` on the fused WGS-Kim carry step at 2048^2:
    ``time_scan`` (ms an iteration, CUDA events) and ``bytes_accessed``,
    whose declared bytes for ``cols_wgs_roundtrip`` and ``rows_normfwd``,
    over HBM_BYTES_PER_S, are set beside the bound of the kernels line
    (``bound``: ten and four planes)."""
    from slmsuite_torch.misc import profile
    from slmsuite_torch.models.engine_models import spot_array_wgs
    from slmsuite_torch.ops import engine, fft

    model = spot_array_wgs(N=2048, device=device)
    consts = engine._augment_fused_consts(model.config, model.consts)
    state = engine._provision_fused(model.config, model.init_state())
    state = state._replace(psi=fft.wgs_carry_entry(state.psi, consts["amp"]),
                           phase_ff=fft.wgs_phasor_entry(state.phase_ff))
    step = model.step
    times = profile.time_scan(lambda s: step(s, consts)[0], state, n_iterations=50, repeats=3)
    total, detail = profile.bytes_accessed(lambda: step(state, consts))
    shape = (2048, 2048)
    out = {}
    for name, planes in (("cols_wgs_roundtrip", 10), ("rows_normfwd", 4)):
        declared_ms = detail[name] / HBM_BYTES_PER_S * 1e3
        table_ms = bound(shape, planes, 2)[0]
        out[name] = dict(declared_bytes=detail[name], declared_ms=declared_ms,
                         bound_ms=table_ms, planes=detail[name] / (4 * 2048 * 2048))
        log(f"M2 {name}: declared {detail[name]} bytes = {out[name]['planes']:.2f} planes, "
            f"{declared_ms:.4f} ms at 3.35 TB/s; the kernels line's bound {table_ms:.4f} ms "
            f"({planes} planes)")
    log(f"M2 fused step 2048^2: time_scan {', '.join(f'{t:.4f}' for t in times)} ms an "
        f"iteration; bytes_accessed {total} ({json.dumps(detail)}) [{nvidia_smi_line()}]")
    return out


def main():
    from slmsuite_torch.models.engine_models import image_mraf, spot_array_wgs

    parent = line_ab_parent = wide_ab_parent = None
    if sys.argv[1:2] == ["--parent"] and len(sys.argv) == 3:
        parent = Path(sys.argv[2]).resolve()
        assert (parent / "slmsuite_torch").is_dir(), f"no port under {parent}"
    elif sys.argv[1:2] == ["--line-ab"] and len(sys.argv) == 3:
        line_ab_parent = Path(sys.argv[2]).resolve()
        assert (line_ab_parent / "slmsuite_torch").is_dir(), f"no port under {line_ab_parent}"
    elif sys.argv[1:2] == ["--compressed-ab"] and len(sys.argv) == 3:
        wide_ab_parent = Path(sys.argv[2]).resolve()
        assert (wide_ab_parent / "slmsuite_torch").is_dir(), f"no port under {wide_ab_parent}"
    elif len(sys.argv) > 1:
        raise SystemExit("usage: python3 chip_smoke.py [--parent DIR | --line-ab DIR | "
                         "--compressed-ab DIR]")

    from slmsuite_torch.ops import fft

    device = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.log").write_text("")
    phase_environment()
    phase_build()
    if line_ab_parent is not None:
        # Only the A/B of the line kernels against the parent's, no smoke.
        line_ab(device, line_ab_parent)
        return
    if wide_ab_parent is not None:
        # Only the A/B of the wide compressed kernels against the parent's.
        compressed_wide_ab(device, wide_ab_parent)
        return
    fft.reset_plain_count()
    errors = phase_parity(device)
    errors.update(phase_natural_parity(device))
    errors.update(phase_mraf_parity(device))
    errors.update(phase_compressed_parity(device))
    phase_zernike_parity(device)
    errors.update(phase_fwd_parity(device))
    phase_batched_parity(device)
    for line in kernel_registers():
        log(f"  ptxas: {line}")
    paths = phase_paths(device)
    paths.update(phase_compressed_paths(device))
    z1_rig_calibrated, z1_launches = phase_zernike_calibration(device)
    phase_zernike_clone(device, z1_rig_calibrated)
    del z1_rig_calibrated
    paths["Q1"] = phase_q1(device)
    s2_loop = phase_camera(device)
    phase_host_loop(device)
    mp_launches, p1_run = phase_multiplane(device)
    cg_launches, g1_run, g1_phase = phase_cg(device)
    phase_native(g1_phase)
    phase_golden()
    times = phase_kernel_timing(device)
    batched_times = phase_batched_timing(device)
    parent = parent_port(parent) if parent is not None else None
    compressed_times, compressed_loops = phase_compressed_timing(device, parent=parent)
    times.update(compressed_times)
    phase_model_timing(device)
    phase_profile(device, "spot_array_wgs(2048) WGS-Kim fused",
                  spot_array_wgs(N=2048, device=device).run)
    phase_profile(device, "spot_array_wgs(2048) WGS-Nogrette natural",
                  spot_array_wgs(N=2048, method="WGS-Nogrette", device=device).run)
    phase_profile(device, "N2 GS 2048^2 canvas / 1024^2 SLM", engine_loop(
        spot_array(device, (10, 10), (60, 60), slm_shape=(1024, 1024)), "GS"))
    phase_profile(device, "image_mraf(2048) WGS-Leonardo MRAF carry",
                  image_mraf(N=2048, device=device).run)
    phase_profile(device, "M2 MRAF WGS-Kim zero_factor image 2048^2", engine_loop(
        image_hologram(device), "WGS-Kim", mraf_factor=0.5, zero_factor=0.1))
    phase_profile(device, "image_mraf(2048) GS natural MRAF",
                  image_mraf(N=2048, method="GS", device=device).run)
    phase_profile(device, "C1 config 5 WGS-Kim cached", compressed_loops[
        "C1 config 5 WGS-Kim cached"], n=CONFIG5_ITERS)
    phase_profile(device, "C2 config 5 WGS-Kim recompute", compressed_loops[
        "C2 config 5 WGS-Kim recompute"], n=CONFIG5_ITERS)
    phase_profile(device, "S2 config 4 rig, 10x10 spots, camera feedback", s2_loop,
                  n=CONFIG4_ITERS)
    phase_profile(device, f"P1 multiplane {MP_PLANES} x {MP_SIDE}^2 WGS-Kim batched",
                  lambda k: p1_run(None, k), n=MP_TIMING_ITERS)
    phase_profile(device, "G1 SpotHologram 2048^2 32x32 CG", g1_run, n=G1_ITERS)
    # The sides that are not powers of two, and 8192^2, after every phase
    # whose counts read the profiler (X2's CG first among them).
    mixed_paths = phase_mixed_paths(device)
    mixed_errors = phase_mixed_parity(device)
    mixed_times = phase_mixed_timing(device)
    # The mesh engines (D0-D3) after the profiler's phases and before W1.
    mesh_launches = phase_mesh(device)
    # Every path above took the kernels: no dispatch took the plain tier.
    assert fft.PLAIN_ON_DEVICE == 0, f"{fft.PLAIN_ON_DEVICE} plain-tier dispatches"
    plain_tier = phase_plain_tier(device)
    example_launches = phase_examples(device)
    phase_memory(device)
    phase_profile_helpers(device)
    # The rig's calibrations come last: after W1's ~5,100 frames (three 4 MB
    # pageable copies each) the profiler's CUPTI records miss some small
    # copies and memsets, which the transfer counts and device-event
    # windows of the phases above rely on.
    w1_rigs, w1_runs = phase_superpixel(device)
    phase_rig_state(device, w1_rigs, w1_runs)
    w1_launches = w1_runs["kernels"]["launches"]
    del w1_rigs, w1_runs
    phase_rig_calibrations(device)
    assert fft.PLAIN_ON_DEVICE == 0, f"{fft.PLAIN_ON_DEVICE} plain-tier dispatches in W1-W3"
    # Z3 reads no profiler window, and runs after every phase that does.
    z3_launches = phase_z3(device, parent=parent)
    del parent
    # G4 and G5 (every optimizer and building block on G1's path, some
    # 80 runs of a few hundred small launches each) read no profiler
    # window, and run after every phase that does.
    cg_launches["G4"] = phase_g4(device)
    cg_launches["G5"] = phase_g5(device)
    log(f"X3 plain tier: {json.dumps(plain_tier)}")

    kernels = []
    for name, (source, replaces, path) in KERNELS.items():
        launches = paths[path].get(name, 0)
        assert launches > 0, f"{name} was not launched on the {path} path"
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"slmsuite_torch/csrc/{source}",
            "replaces": replaces, "path": path, "launches": launches,
            "max_abs_err": errors[name], "ms": t["kernel"], "plain_ms": t["plain"],
            "bound_ms": t["bound"], "bound_us": t["bound"] * 1e3, "bound_by": t["bound_by"],
            "library_ms": t["library"], "timer": t["timer"],
        })
        if name in STACK_KERNELS:
            # The batched multiplane step's launches (P1, or P2 for cols_fft)
            # and the kernel's time a plane on P1's stack.
            mp_path = "P1" if name in mp_launches["P1"] else "P2"
            b = batched_times[(name, MP_SIDE)]
            kernels[-1]["planes"] = {
                "path": mp_path, "launches": mp_launches[mp_path][name], "planes": MP_PLANES,
                "side": MP_SIDE, "ms_per_plane": b["per_plane"], "ms_one_plane": b["one_plane"],
            }
        if "zernike" in t:
            # The Zernike calibration's launches (Z1), and the kernel's time
            # at ZERNIKE_TIMING_TERMS terms on config 5's plane and spots.
            z = t["zernike"]
            kernels[-1]["zernike"] = {
                "path": "Z1", "launches": z1_launches.get(name, 0), "terms": Z1_TERMS,
                "z3_launches": z3_launches.get(name, 0),
                "timed_terms": ZERNIKE_TIMING_TERMS, "ms": z["kernel"], "plain_ms": z["plain"],
                "bound_ms": z["bound"], "bound_by": z["bound_by"], "timer": z["timer"],
            }
        if name in ("rows_fft", "cols_fft"):
            # The superpixel wavefront calibration's launches (W1): one of
            # each a camera frame.
            kernels[-1]["superpixel"] = {"path": "W1", "launches": w1_launches[name]}
        if name in mixed_times:
            # Planes whose sides are not powers of two, and 8192^2: X0's
            # largest relative error against the plain version, the
            # launches on X1 and X2's paths, and the times at MIXED_TIMED.
            kernels[-1]["mixed"] = {
                "x0_max_rel": mixed_errors[name],
                "launches": {p: c[name] for p, c in mixed_paths.items() if c.get(name)},
                **mixed_times[name],
            }
        if any(name in counts for counts in mesh_launches.values()):
            # The launches a shard of the mesh engines' paths (D0-D3).
            kernels[-1]["mesh"] = {
                "shards": MESH_SHARDS,
                "launches_per_shard": {p: c[name] for p, c in mesh_launches.items()
                                       if c.get(name)},
            }
        if any(name in counts for counts in example_launches.values()):
            # The launches of each example run through the kernels (E1-E8).
            kernels[-1]["examples"] = {e: counts[name] for e, counts in example_launches.items()
                                       if counts.get(name)}
        if any(name in counts for counts in cg_launches.values()):
            # The launches of gradient phase retrieval, forward and backward.
            kernels[-1]["cg"] = {g: counts.get(name, 0) for g, counts in cg_launches.items()}
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
