"""The plain reference of the ``compressed`` driver: weighted
Gerchberg-Saxton with Kim's phase fixing on a grid-free farfield of N
spots, each with its own Zernike coefficients, in plain PyTorch, written
from the published algorithm and upstream slmsuite's conventions.

- The SLM grid: pixel centres at ``(W - 1) linspace(-1/2, 1/2, W)`` times
  ``pitch / wavelength`` (and so in y).
- The illumination (``slm["source"]``, optional): a centred Gaussian
  ``exp(-(x^2 / wx^2 + y^2 / wy^2) / 2)``, ``wx`` = ``w_frac`` of the width
  (and so ``wy``), the SLM's measured source amplitude. Its intensity's
  moments, in pixels from the image's centre ``(W - 1) / 2``, give the
  source's centre ``c`` (plus ``W / 2``) and radius, the mean over x and y
  of ``pitch sqrt(2 var)``; the grid is moved by ``(i0 - c) pitch``, ``i0``
  the pixel where the grid is nearest 0 (the first, where two are), so
  that it is centred on the source. Without a source the amplitude is
  uniform and the radius a quarter of the smaller side.
- The Zernike disk: the grid scaled by ``s = 1 / (2 radius)``.
- The basis: the ANSI Zernike polynomials ``R_n^|m|(rho)`` times
  ``cos(m theta)`` (m > 0) or ``sin(|m| theta)`` (m < 0), unnormalised
  (peak 1), over the whole SLM (no pupil mask).
- kxy to Zernike: tilt ``2 pi kxy / s``, focus ``z (2 pi / s)**2 / (8 pi)``,
  ``s`` the disk scaling.
- The transforms: ``ff[n] = sum_p exp(-i Phi[n, p]) nf[p] / sqrt(P)``,
  normalised to unit power, and ``nf[p] = sum_n ff[n] exp(i Phi[n, p])``,
  ``Phi = c^T B``; the nearfield keeps its phase at the illumination's
  amplitude.
- WGS-Kim: from the second iteration the weights take
  ``w (|ff| / T) ** -p`` and are normalised; the farfield phase is the
  current one until ``fix_phase_iteration`` iterations have run, then held.
- The stats of the last iteration (``computational_spot``): the overlap
  efficiency ``(sum T |ff|)**2 / (sum T**2 sum |ff|**2)`` and
  ``1 - (max - min) / (max + min)`` of ``|ff|**2 / T**2``.

The kernel ``exp(i Phi)`` is formed once, in blocks of spots, and held
(two float32 matrices of N x P); every transform is then a product with it.
"""

import math

import numpy as np
import torch

from holobench.reference.precision import rounder

#: Spots whose phases are formed at a time.
SPOT_BLOCK = 64


def ansi_to_nm(j):
    """ANSI index -> radial order n and azimuthal frequency m."""
    n = int(math.floor((math.sqrt(8 * j + 1) - 1) / 2))
    return n, 2 * j - n * (n + 2)


def zernike(j, x, y):
    """The unnormalised ANSI Zernike polynomial ``j`` at ``(x, y)``."""
    n, m = ansi_to_nm(j)
    rho, theta = torch.sqrt(x * x + y * y), torch.atan2(y, x)
    radial = torch.zeros_like(rho)
    for k in range((n - abs(m)) // 2 + 1):
        c = ((-1) ** k * math.factorial(n - k)
             / (math.factorial(k) * math.factorial((n + abs(m)) // 2 - k)
                * math.factorial((n - abs(m)) // 2 - k)))
        radial = radial + c * rho ** (n - 2 * k)
    if m > 0:
        return radial * torch.cos(m * theta)
    if m < 0:
        return radial * torch.sin(-m * theta)
    return radial


def geometry(slm):
    """``(x, y, amp, s)``: the SLM's grid (float64 numpy, H x W, in
    wavelengths, centred on the source), its nearfield amplitude (H x W,
    or None where uniform) and the Zernike disk's scaling."""
    h, w = slm["shape"]
    px, py = (p / slm["wav_um"] for p in slm["pitch_um"])
    xs = px * (w - 1) * np.linspace(-0.5, 0.5, w)
    ys = py * (h - 1) * np.linspace(-0.5, 0.5, h)
    source = slm.get("source")
    if source is None:
        x, y = np.meshgrid(xs, ys)
        return x, y, None, 1.0 / (2 * 0.25 * min(w * px, h * py))
    if source["function"] != "gaussian2d":
        raise ValueError(f"no reference for the source {source['function']!r}")
    wx, wy = source["w_frac"] * w * px, source["w_frac"] * h * py
    x, y = np.meshgrid(xs, ys)
    amp = np.exp(-0.5 * (x * x / (wx * wx) + y * y / (wy * wy)))
    power = np.square(amp) / np.sum(np.square(amp))
    i = np.arange(w) - (w - 1) / 2
    j = np.arange(h) - (h - 1) / 2
    cx, cy = np.sum(power * i[None, :]), np.sum(power * j[:, None])
    vx = np.sum(power * np.square(i[None, :] - cx))
    vy = np.sum(power * np.square(j[:, None] - cy))
    radius = np.mean([px * np.sqrt(2 * vx), py * np.sqrt(2 * vy)])
    i0, j0 = np.argmin(np.abs(xs)), np.argmin(np.abs(ys))
    x = x + (i0 - (cx + w / 2)) * px
    y = y + (j0 - (cy + h / 2)) * py
    return x, y, amp, 1.0 / (2 * radius)


def basis(indices, x, y, s, device):
    """The (D, H*W) float32 basis on the grid ``x, y`` scaled by ``s``,
    formed in float64."""
    x = torch.as_tensor(x * s, dtype=torch.float64, device=device)
    y = torch.as_tensor(y * s, dtype=torch.float64, device=device)
    return torch.stack([zernike(int(j), x, y).reshape(-1) for j in indices]).to(torch.float32)


def kxy_to_zernike(kxy, s):
    """(3, N) normalised tilt and focal power -> (3, N) Zernike tilt and
    focus coefficients (radians), on the disk scaled by ``s``."""
    kxy = np.asarray(kxy, float)
    zs = 2 * np.pi / s
    return np.vstack([kxy[:2] * zs, kxy[2:3] * zs * zs / (8 * np.pi)])


def unit(z):
    return z / torch.linalg.vector_norm(z)


def run(inputs, precision="float32"):
    """WGS-Kim on ``inputs``: ``slm`` (``shape`` [H, W], ``pitch_um``
    [x, y], ``wav_um``, optional ``source``), ``indices`` (the D ANSI
    indices), ``coefficients`` ((D, N) with the tilt and focus rows, ANSI
    2, 1 and 4, given in kxy: normalised kx, ky and focal power), ``phase0`` (the SLM's initial phase, a float32
    tensor on the device to run on), ``iterations``, ``feedback_exponent``
    and ``fix_phase_iteration``. ``precision`` ``tf32`` rounds the operands
    of the phase product ``c^T B`` as a tensor core would. Returns ``phase``
    (plus pi), ``spot_amp`` (the final unit farfield's amplitudes),
    ``weights``, ``efficiency`` and ``uniformity``."""
    r = rounder(precision)
    phase0 = inputs["phase0"].to(torch.float32)
    device = phase0.device
    slm = inputs["slm"]
    indices = [int(j) for j in inputs["indices"]]
    coeffs = np.array(inputs["coefficients"], float)
    rows = {j: i for i, j in enumerate(indices)}
    tilt = [rows[2], rows[1], rows[4]] if 4 in rows else [rows[2], rows[1]]
    x, y, amp, scale = geometry(slm)
    coeffs[tilt] = kxy_to_zernike(coeffs[tilt], scale)[: len(tilt)]
    c = r(torch.as_tensor(coeffs, dtype=torch.float32, device=device))
    b = r(basis(indices, x, y, scale, device))
    amp = (torch.ones(x.size, dtype=torch.float32, device=device) if amp is None
           else torch.as_tensor(amp.reshape(-1), dtype=torch.float32, device=device))
    n, npx = c.shape[1], b.shape[1]

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        kc = torch.empty((n, npx), dtype=torch.float32, device=device)
        ks = torch.empty_like(kc)
        for s in range(0, n, SPOT_BLOCK):
            phi = c[:, s:s + SPOT_BLOCK].T @ b
            kc[s:s + SPOT_BLOCK] = torch.cos(phi)
            ks[s:s + SPOT_BLOCK] = torch.sin(phi)
            del phi

        def to_far(nr, ni):
            return unit(torch.complex(kc @ nr + ks @ ni, kc @ ni - ks @ nr) / math.sqrt(npx))

        def to_near(ff):
            return torch.complex(ff.real @ kc - ff.imag @ ks, ff.real @ ks + ff.imag @ kc)

        target = unit(torch.full((n,), 1.0 / math.sqrt(n), dtype=torch.float32, device=device))
        p = float(inputs["feedback_exponent"])
        fix_at = int(inputs["fix_phase_iteration"])
        psi0 = phase0.reshape(-1)
        ff = to_far(amp * torch.cos(psi0), amp * torch.sin(psi0))
        weights = target.clone()
        fixed, streak, phase_ff, stats = False, 0, None, None
        for k in range(int(inputs["iterations"])):
            ff = unit(ff)
            amp_ff = ff.abs()
            u = torch.square(amp_ff) / torch.square(target)
            stats = (torch.square((target * amp_ff).sum())
                     / (torch.square(amp_ff).sum() * torch.square(target).sum()),
                     1 - (u.max() - u.min()) / (u.max() + u.min()))
            if k > 0:
                weights = unit(weights * torch.pow(amp_ff / target, -p))
            if not fixed:
                streak += 1
                if k >= fix_at - 1 and streak >= fix_at and k > 0:
                    fixed = True
                phase_ff = torch.angle(ff)
            constrained = torch.polar(weights, phase_ff)
            near = amp * torch.sgn(to_near(constrained))
            ff = to_far(near.real, near.imag)
        phase = torch.angle(to_near(constrained))
        final = to_far(amp * torch.cos(phase), amp * torch.sin(phase)).abs()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {
        "phase": (phase + math.pi).reshape(tuple(phase0.shape)),
        "spot_amp": final,
        "weights": weights,
        "efficiency": float(stats[0]),
        "uniformity": float(stats[1]),
    }
