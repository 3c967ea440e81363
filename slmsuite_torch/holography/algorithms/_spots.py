r"""
:class:`SpotHologram`: DFT-based optical focus arrays (port of the
``SpotHologram`` part of :mod:`slmsuite_tpu.holography.algorithms._spots`).

This slice covers spots given in the computational ``"knm"`` basis
without hardware, on padded or unpadded farfields, optimized with
``computational`` or spot-integrated ``computational_spot`` feedback on
the device engine. The ``"kxy"``/``"ij"`` bases and camera feedback need
a ``cameraslm`` (ROADMAP.md queue 1, item 9); spot null regions are not
ported yet (item 6).
"""

import numpy as np
import torch

from slmsuite_torch.holography.algorithms._feedback import FeedbackHologram
from slmsuite_torch.holography.algorithms._hologram import Hologram
from slmsuite_torch.holography.toolbox import REAL_TYPES, format_2vectors
from slmsuite_torch.ops import engine as _engine


class SpotHologram(FeedbackHologram):
    """
    N spots at ``"knm"`` (computational pixel) positions, with per-spot
    amplitude targets.
    """

    def __init__(
        self,
        shape,
        spot_vectors,
        basis="knm",
        spot_amp=None,
        cameraslm=None,
        null_vectors=None,
        null_radius=None,
        null_region=None,
        null_region_radius_frac=None,
        **kwargs,
    ):
        """
        Initialize a spot hologram from ``(2, N)`` spot vectors in the
        ``"knm"`` basis.
        """
        if basis not in (None, "knm") or cameraslm is not None:
            raise NotImplementedError(
                "Spot bases other than 'knm' need a cameraslm "
                "(ROADMAP.md queue 1, item 9)."
            )
        if any(v is not None for v in (null_vectors, null_radius, null_region,
                                        null_region_radius_frac)):
            raise NotImplementedError(
                "Spot null regions are not ported yet (ROADMAP.md queue 1, item 6)."
            )
        vectors = format_2vectors(spot_vectors)
        N = vectors.shape[1]

        if spot_amp is not None:
            self.spot_amp = np.ravel(spot_amp)
            if len(self.spot_amp) != N:
                raise ValueError("spot_amp must have the same length as the spots.")
        else:
            self.spot_amp = np.full(N, 1.0 / np.sqrt(N))
        self.external_spot_amp = np.copy(self.spot_amp)

        self.spot_knm = vectors
        self.spot_kxy = None
        self.spot_ij = None
        self.null_knm = None
        self.null_radius_knm = None
        self.null_region_knm = None

        # Integration width: 10x the psf clipped to [3, spot spacing / 1.5]
        # and made odd, which is 3 without hardware (psf 0).
        self.spot_integration_width_knm = 3
        self.spot_integration_width_ij = None

        if (
            np.any(self.spot_knm[0] < 0)
            or np.any(self.spot_knm[1] < 0)
            or np.any(self.spot_knm[0] >= shape[1])
            or np.any(self.spot_knm[1] >= shape[0])
        ):
            raise ValueError(
                f"Spots outside SLM computational space bounds!\n"
                f"Spots:\n{self.spot_knm}\nBounds: {shape}"
            )

        super().__init__(shape, target_ij=None, cameraslm=None, **kwargs)
        self.set_target(reset_weights=True)

    def __len__(self):
        """Number of spots."""
        return self.spot_knm.shape[1]

    @staticmethod
    def make_rectangular_array(
        shape,
        array_shape,
        array_pitch,
        array_center=None,
        basis="knm",
        orientation_check=False,
        **kwargs,
    ):
        """
        A rectangular array of ``array_shape`` spots at ``array_pitch``
        spacing about ``array_center`` (the zeroth order by default).
        ``orientation_check`` removes the last two spots.
        """
        if basis not in (None, "knm"):
            raise NotImplementedError(
                "Spot bases other than 'knm' need a cameraslm "
                "(ROADMAP.md queue 1, item 9)."
            )
        if isinstance(array_shape, REAL_TYPES):
            array_shape = (int(array_shape), int(array_shape))
        if isinstance(array_pitch, REAL_TYPES):
            array_pitch = (array_pitch, array_pitch)
        if array_center is None:
            array_center = (shape[1] / 2.0, shape[0] / 2.0)

        x_edge, y_edge = (
            (np.arange(array_shape[a]) - (array_shape[a] - 1) / 2.0) * array_pitch[a]
            + array_center[a]
            for a in (0, 1)
        )

        x_grid, y_grid = np.meshgrid(x_edge, y_edge)
        x_list, y_list = x_grid.ravel(), y_grid.ravel()

        if orientation_check and len(x_list) > 2:
            x_list = x_list[:-2]
            y_list = y_list[:-2]

        return SpotHologram(
            shape, np.vstack((x_list, y_list)), basis=basis, spot_amp=None, **kwargs
        )

    def _set_target_spots(self, reset_weights=False):
        """Scatter the spot amplitudes into the target plane."""
        self.spot_knm_rounded = np.rint(self.spot_knm).astype(int)
        self.spot_kxy_rounded = None
        self.spot_ij_rounded = None

        if self.target is None:
            self.target = np.zeros(self.shape, dtype=self.dtype)
        self.target.fill(0)
        self.target[self.spot_knm_rounded[1, :], self.spot_knm_rounded[0, :]] = self.spot_amp
        self.target /= Hologram._norm(self.target)

        if reset_weights:
            self.reset_weights()

    def set_target(self, new_target=None, reset_weights=False):
        """Update the target from the current :attr:`spot_knm` positions."""
        del new_target  # The target is derived from the spot positions.
        self._set_target_spots(reset_weights=reset_weights)

    # ------------------------------------------------------------------
    # Engine hooks: spot feedback inside the loop.
    # ------------------------------------------------------------------

    @property
    def _spot_single_px(self):
        return tuple(self.shape) == tuple(self.slm_shape)

    def _engine_feedback(self):
        feedback = self.flags.get("feedback", "computational")
        if feedback in ("computational", "computational_spot"):
            return feedback
        raise NotImplementedError(
            f"Feedback '{feedback}' needs the stepwise host loop "
            "(ROADMAP.md queue 1, items 6 and 9)."
        )

    def _device_stat_groups(self):
        return tuple(
            g for g in self.flags.get("stat_groups", [])
            if g in ("computational", "computational_spot")
        )

    def _extend_consts(self, consts, config):
        if not (config.feedback == "computational_spot"
                or "computational_spot" in config.stat_groups):
            return
        # Gather maps: stats use the raw (floored) spot positions, weight
        # updates the rounded spot pixels.
        flat_idx, _ = _engine.spot_gather_indices(
            np.floor(self.spot_knm).astype(int),
            self.spot_integration_width_knm, self.shape,
        )
        weight_flat_idx, center_idx = _engine.spot_gather_indices(
            self.spot_knm_rounded, self.spot_integration_width_knm, self.shape
        )

        def index(x):
            return torch.as_tensor(x, dtype=torch.int64, device=self.device)

        consts["spot_flat_idx"] = index(flat_idx)
        consts["spot_weight_flat_idx"] = index(weight_flat_idx)
        consts["spot_center_idx"] = index(center_idx)
        consts["spot_amp"] = torch.as_tensor(
            np.asarray(self.spot_amp, np.float32), device=self.device
        )
