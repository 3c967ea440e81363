"""
Statistics bookkeeping for holograms (port of the stats-recording part of
:mod:`slmsuite_tpu.holography.algorithms._stats`).

The engine computes the per-iteration metrics on the device inside its
loop (:mod:`slmsuite_torch.ops.engine`), and :meth:`_record_scan_stats`
folds them into the reference's stats dictionary,
``holo.stats["stats"][group][metric]``; the stepwise host loop records each
iteration with :meth:`_update_stats`. HDF5 save/load imports its helpers
when called. The plots (:meth:`plot_nearfield`, :meth:`plot_farfield`,
:meth:`plot_stats`) import matplotlib when called, and every tensor reaches
it through :meth:`slmsuite_torch.misc.host.as_numpy`; the farfield's blur is OpenCV's, in torch
(:mod:`slmsuite_torch.holography.analysis._cv`).
"""

import numpy as np

from slmsuite_torch.misc.host import as_numpy
from slmsuite_torch.ops.stats import STAT_KEYS, calculate_stats_numpy


class _HologramStats:
    """Mixin providing stats management for :class:`Hologram` and subclasses."""

    @staticmethod
    def _calculate_stats(
        feedback_amp,
        target_amp,
        efficiency_compensation=True,
        total=None,
        raw=False,
    ):
        """Host-side stats dict (see :meth:`ops.stats.calculate_stats_numpy`)."""
        return calculate_stats_numpy(
            feedback_amp,
            target_amp,
            efficiency_compensation=efficiency_compensation,
            total=total,
            raw=raw,
        )

    def _stats_pending_groups(self):
        """Stat groups that must be computed host-side (experimental data)."""
        return [
            group
            for group in self.flags.get("stat_groups", [])
            if "experimental" in group or "external" in group
        ]

    def _record_scan_stats(self, stats_array, start_iter):
        """
        Fold a stats array of shape ``(n_iter, n_groups + 1, 4)`` (from
        :meth:`ops.engine.run_gs`) into the stats dictionary.
        """
        stats_array = np.asarray(stats_array)
        groups = list(self.flags.get("stat_groups", []))

        for offset in range(stats_array.shape[0]):
            iteration = start_iter + offset
            stats = {}
            for g, group in enumerate(groups):
                row = stats_array[offset, g, :]
                if np.all(np.isnan(row)):
                    continue  # host-side group; filled elsewhere
                stats[group] = dict(zip(STAT_KEYS, (float(v) for v in row)))

            # The internal row tracks the fixed_phase flag history.
            self.flags["fixed_phase"] = bool(stats_array[offset, -1, 1])
            self._update_stats_dictionary(stats, iteration=iteration)

        # After the run the flag reflects the final state.
        if stats_array.shape[0]:
            self.flags["fixed_phase"] = bool(self._final_fixed_phase)

    def _update_stats(self, stat_groups=()):
        """Compute and record the stats of the current iteration (the
        stepwise host loop)."""
        stats = {}
        self._populate_stats(stats, stat_groups)
        self._update_stats_dictionary(stats)

    def _populate_stats(self, stats, stat_groups):
        """Fill ``stats`` with the groups this class computes."""
        if "computational" in stat_groups:
            stats["computational"] = self._calculate_stats(
                self.get_amp_ff(),
                np.asarray(self.target),
                efficiency_compensation=False,
                raw=bool(self.flags.get("raw_stats")),
            )

    def _update_stats_dictionary(self, stats, iteration=None):
        """
        Merge one iteration's ``{group: {stat: value}}`` into :attr:`stats`,
        padding all lists with nan so every series has equal length.
        """
        if iteration is None:
            iteration = self.iter

        M = len(self.stats["method"])
        if iteration + 1 - M > 0:
            self.stats["method"].extend([""] * (iteration + 1 - M))
            M = iteration + 1
        self.stats["method"][iteration] = self.flags.get("method", "")

        flaglist = set(self.flags.keys()) | set(self.stats["flags"].keys())
        for flag in flaglist:
            series = self.stats["flags"].setdefault(flag, [np.nan] * M)
            if iteration + 1 - len(series) > 0:
                series.extend([np.nan] * (iteration + 1 - len(series)))
            if flag in self.flags:
                value = self.flags[flag]
                if not np.isscalar(value) and value is not None:
                    value = np.nan if not isinstance(value, (bool, int, float, str)) else value
                series[iteration] = value

        grouplist = set(stats.keys()) | set(self.stats["stats"].keys())
        if grouplist:
            statlists = [set(stats[group].keys()) for group in stats]
            if self.stats["stats"]:
                first = next(iter(self.stats["stats"]))
                statlists.append(set(self.stats["stats"][first].keys()))
            statlist = set.union(*statlists) if statlists else set()

            for group in grouplist:
                record = self.stats["stats"].setdefault(group, {})
                for stat in statlist:
                    series = record.setdefault(stat, [np.nan] * M)
                    if iteration + 1 - len(series) > 0:
                        series.extend([np.nan] * (iteration + 1 - len(series)))
                    if group in stats and stat in stats[group]:
                        series[iteration] = stats[group][stat]

        if self.flags.get("raw_stats"):
            raw = self.stats.setdefault("raw_farfield", [])
            if iteration + 1 - len(raw) > 0:
                raw.extend([np.nan] * (iteration + 1 - len(raw)))
            raw[iteration] = np.asarray(self.get_farfield())

    # ------------------------------------------------------------------
    # Persistence (HDF5; helpers imported on use).
    # ------------------------------------------------------------------

    def save_stats(self, file_path, include_state=True):
        """Save the stats dictionary (and optionally the current hologram
        state) to an HDF5 file."""
        from slmsuite_torch.misc.files import save_h5

        data = {"stats": _listdict_to_h5(self.stats)}
        if include_state:
            to_save = {}
            for attr in ["phase", "amp", "target", "weights", "phase_ff", "amp_ff"]:
                value = getattr(self, attr, None)
                if value is not None:
                    to_save[attr] = np.asarray(value)
            to_save["iter"] = self.iter
            data["state"] = to_save
        save_h5(file_path, data)

    def load_stats(self, file_path, include_state=True):
        """Load stats (and optionally state) saved by :meth:`save_stats`."""
        from slmsuite_torch.misc.files import load_h5

        data = load_h5(file_path)
        self.stats = _h5_to_listdict(data["stats"])
        if include_state and "state" in data:
            state = data["state"]
            for attr in ["phase", "amp", "target", "weights", "phase_ff", "amp_ff"]:
                if attr in state:
                    setattr(self, attr, np.asarray(state[attr]))
            if "iter" in state:
                self.iter = int(state["iter"])

    def plot_nearfield(self, source=None, title="", padded=False, figsize=(8, 4), cbar=False):
        """Plot the nearfield amplitude and phase of the hologram (or of
        a given complex ``source`` array). ``padded`` shows the full
        computational :attr:`shape` (the SLM region padded with zeros)
        instead of the bare :attr:`slm_shape` — ref ``_stats.py:340-422``."""
        import matplotlib.pyplot as plt

        from slmsuite_torch.holography import toolbox

        fig, axs = plt.subplots(1, 2, figsize=figsize)

        if source is None:
            amp = as_numpy(self.get_amp())
            phase_plot = as_numpy(self.phase)
        else:
            source = as_numpy(source)
            amp = np.abs(source)
            phase_plot = np.angle(source)
        if amp.ndim == 0:
            amp = np.full(self.slm_shape, amp)

        shown_shape = tuple(self.shape) if padded else tuple(self.slm_shape)
        if amp.shape != shown_shape:
            amp = toolbox.pad(amp, shown_shape)
        vmax = float(np.nanmax(amp)) or 1.0
        im0 = axs[0].imshow(amp, vmin=0, vmax=vmax)
        axs[0].set_title("Nearfield amplitude")
        phase_shown = np.mod(phase_plot, 2 * np.pi)
        if phase_shown.shape != shown_shape:
            phase_shown = toolbox.pad(phase_shown, shown_shape)
        im1 = axs[1].imshow(
            phase_shown,
            cmap="twilight",
            vmin=0,
            vmax=2 * np.pi,
            interpolation="none",
        )
        axs[1].set_title("Nearfield phase")
        for i, ax in enumerate(axs):
            ax.set_xlabel("SLM $x$ [pix]")
            if i == 0:
                ax.set_ylabel("SLM $y$ [pix]")
        if cbar:
            fig.colorbar(im0, ax=axs[0])
            fig.colorbar(im1, ax=axs[1])
        if title:
            fig.suptitle(title)
        plt.show()
        return fig

    @staticmethod
    def _compute_limits(source, epsilon=0, limit_padding=0.1):
        """Smallest rectangular ``[(xmin, xmax), (ymin, ymax)]`` region
        (plus padding) covering the above-``epsilon``, non-nan pixels of
        ``source``. Parity: ref ``_stats.py:313-338``."""
        source = as_numpy(source)
        lit = (np.nan_to_num(source, nan=-np.inf) > epsilon)
        limits = []
        for axis in (0, 1):
            if not lit.any():
                limits.append((0, source.shape[1 - axis] - 1))
                continue
            hit = np.flatnonzero(lit.any(axis=axis))
            lo, hi = int(hit[0]), int(hit[-1])
            pad = int((hi - lo) * limit_padding) + 1
            limits.append((
                int(np.clip(lo - pad, 0, source.shape[1 - axis] - 1)),
                int(np.clip(hi + pad + 1, 0, source.shape[1 - axis] - 1)),
            ))
        return limits

    def plot_farfield(self, source=None, title="", limits=None, units="knm",
                      limit_padding=0.1, figsize=(8, 4), cbar=False, axs=None):
        """
        Plot an overview (left) and zoom (right) of the farfield.

        Parameters
        ----------
        source : array_like OR None
            ``shape``-sized farfield data; defaults to :attr:`amp_ff`
            (computing it if absent). If ``"phase"`` is a substring of
            ``title`` the data is rendered mod :math:`2\\pi` on the
            ``twilight`` wheel.
        title : str
            Plot title ("phase" substring switches to phase rendering).
        limits : ((float, float), (float, float)) OR None
            ``knm`` zoom bounds; autocomputed from the target (or the
            source) support when ``None``.
        units : str
            Axis units — any entry of
            :attr:`~slmsuite_torch.holography.toolbox.BLAZE_UNITS` except
            the camera units (their rotation has no axis-aligned extent).
            Extents are rebased through
            :meth:`~slmsuite_torch.holography.toolbox.convert_vector`;
            device-dependent units need :attr:`cameraslm`.
        limit_padding : float
            Fractional padding of autocomputed ``limits``.
        figsize : tuple
            Figure size when ``axs`` is not given.
        cbar : bool
            Add a colorbar to the zoom plot.
        axs : (matplotlib.axes.Axes, matplotlib.axes.Axes) OR None
            Axes to draw into; a new figure is created (and shown) when
            ``None``.

        Returns
        -------
        ((int, int), (int, int))
            The ``limits`` used (autocomputed ones as ints).

        Parity: ref ``_stats.py:424-727`` (unit rebasing, camera/SLM
        field-of-view overlays, zoom box).
        """
        import matplotlib.pyplot as plt
        import torch

        from slmsuite_torch.holography import toolbox
        from slmsuite_torch.holography.analysis import _cv

        if source is None:
            source = self.get_amp_ff()
            if source is None or as_numpy(source).ndim == 1:
                source = self.get_farfield()
            if limits is None and self.target is not None:
                target = as_numpy(self.target)
                if target.ndim == 2:
                    limits = self._compute_limits(
                        target, limit_padding=limit_padding
                    )
            if not title:
                title = "Farfield Amplitude"

        isphase = "phase" in title.lower()
        npsource = as_numpy(source)
        npsource = (
            np.mod(npsource, 2 * np.pi) if isphase else np.abs(npsource)
        ).astype(float)

        if units not in toolbox.BLAZE_UNITS:
            raise ValueError(
                f"'{units}' is not recognized as a valid blaze unit."
            )
        if units in toolbox.CAMERA_UNITS:
            raise ValueError(
                f"'{units}' is not a valid unit for plot_farfield() "
                "because of the potential associated rotation."
            )

        if limits is None:
            limits = self._compute_limits(
                npsource, limit_padding=limit_padding
            )
        limits = [
            np.clip(np.asarray(lim, dtype=int), 0, npsource.shape[1 - a] - 1)
            for a, lim in enumerate(limits)
        ]
        for lim in limits:
            if lim[1] - lim[0] == 0:
                raise ValueError("Clipped limit has zero length.")

        if axs is None:
            fig, axs = plt.subplots(1, 2, figsize=figsize)
            _show = True
        else:
            fig = axs[0].get_figure()
            _show = False

        if title:
            title += ": "
        cmap = "twilight" if isphase else None

        # Full view, blurred so single lit pixels survive screen-resolution
        # downsampling of a large farfield.
        b = 2 * int(max(npsource.shape) / 400) + 1
        blurred = _cv.gaussian_blur(
            torch.as_tensor(np.nan_to_num(npsource), dtype=torch.float64), b
        ).numpy()
        full = axs[0].imshow(
            blurred, vmin=0, vmax=np.nanmax(npsource), cmap=cmap,
            interpolation="none" if isphase else "gaussian",
        )
        axs[0].set_title(title + "Full")

        # Zoom view with knm-pixel extents (so the rebase below can map
        # them into the requested units).
        zoom_data = np.nan_to_num(
            npsource[limits[1][0]:limits[1][1], limits[0][0]:limits[0][1]]
        )
        b_zoom = 2 * int((limits[0][1] - limits[0][0]) / 200) + 1
        zoom = axs[1].imshow(
            zoom_data, vmin=0, vmax=np.nanmax(zoom_data) or 1,
            extent=[limits[0][0], limits[0][1], limits[1][1], limits[1][0]],
            interpolation="none" if (b_zoom < 2 or isphase) else "gaussian",
            cmap=cmap,
        )
        axs[1].set_title(title + "Zoom", color="r")
        for spine in axs[1].spines.values():
            spine.set_color("r")
            spine.set_linewidth(1.5)

        # Rebase both images' extents from knm into the requested units.
        # Every non-knm blaze unit needs hardware (pitch/wavelength);
        # without a cameraslm fall back to knm like the reference does
        # for bare Holograms (ref _stats.py:567-571), but loudly.
        hardware = getattr(self, "cameraslm", None)
        if hardware is None and units != "knm":
            import warnings

            warnings.warn(
                f"plot_farfield: units='{units}' needs a cameraslm for the "
                "unit conversion; falling back to 'knm'."
            )
            units = "knm"

        def rebase(img):
            if units == "knm":
                return
            ext = img.get_extent()
            lo = toolbox.convert_vector(
                [ext[0], ext[3]], from_units="knm", to_units=units,
                hardware=hardware, shape=npsource.shape,
            ).ravel()
            hi = toolbox.convert_vector(
                [ext[1], ext[2]], from_units="knm", to_units=units,
                hardware=hardware, shape=npsource.shape,
            ).ravel()
            img.set_extent([lo[0], hi[0], hi[1], lo[1]])

        rebase(full)
        rebase(zoom)

        for i, ax in enumerate(axs):
            ax.set_xlabel(toolbox.BLAZE_LABELS[units][0])
            if i == 0:
                ax.set_ylabel(toolbox.BLAZE_LABELS[units][1])
            ax.set_facecolor("#FFEEEE")
            # knm can display a non-square computational grid 1:1;
            # physical units keep square aspect.
            ax.set_aspect(
                npsource.shape[1] / npsource.shape[0] if units == "knm" else 1
            )

        # Camera field of view (FeedbackHologram and subclasses), with a
        # green knm-space outline when the camera extends past it.
        cam_points = getattr(self, "_cam_points", None)
        if cam_points is not None:
            cam_points = np.array(as_numpy(cam_points), dtype=float, copy=True)
            cam_points[0] *= npsource.shape[1] / self.shape[1]
            cam_points[1] *= npsource.shape[0] / self.shape[0]

            cam_outside = (
                (cam_points[:2, :4] < 0).any()
                or (cam_points[0, :4] >= npsource.shape[1]).any()
                or (cam_points[1, :4] >= npsource.shape[0]).any()
            )
            extent = full.get_extent()
            if cam_outside:
                pix_width = (extent[1] - extent[0]) / npsource.shape[1]
                axs[0].add_patch(plt.Rectangle(
                    (extent[0] - pix_width / 2, extent[2] - pix_width / 2),
                    extent[1] - extent[0], extent[3] - extent[2],
                    ec="g", fc="none",
                ))
                axs[0].annotate(
                    "SLM FoV", (np.mean(extent[:2]), np.max(extent[2:])),
                    c="g", size="small", ha="center", va="top",
                )

            if units != "knm":
                cam_points = toolbox.convert_vector(
                    cam_points[:2], from_units="knm", to_units=units,
                    hardware=hardware, shape=npsource.shape,
                )
            axs[0].plot(cam_points[0], cam_points[1], c="y")
            axs[0].annotate(
                "Camera FoV",
                (np.mean(cam_points[0, :4]), np.max(cam_points[1, :4])),
                c="y", size="small", ha="center", va="top",
            )

            # Widen the full view to include an out-of-grid camera.
            dx = (np.ptp(cam_points[0]) / 10) if cam_outside else 0
            dy = (np.ptp(cam_points[1]) / 10) if cam_outside else 0
            axs[0].set_xlim(
                min(extent[0], np.min(cam_points[0]) - dx),
                max(extent[1], np.max(cam_points[0]) + dx),
            )
            axs[0].set_ylim(
                max(extent[2], np.max(cam_points[1]) + dy),
                min(extent[3], np.min(cam_points[1]) - dy),
            )

        # Red zoom-region box on the full view.
        extent = zoom.get_extent()
        pix_width = (extent[1] - extent[0]) / (limits[0][1] - limits[0][0])
        axs[0].add_patch(plt.Rectangle(
            (float(extent[0] - pix_width / 2), float(extent[2] - pix_width / 2)),
            float(extent[1] - extent[0]), float(extent[3] - extent[2]),
            ec="r", fc="none",
        ))
        axs[0].annotate(
            "Zoom", (np.mean(extent[:2]), np.min(extent[2:])),
            c="r", size="small", ha="center", va="bottom",
        )

        if cbar:
            from mpl_toolkits.axes_grid1 import make_axes_locatable

            cax = make_axes_locatable(axs[1]).append_axes(
                "right", size="5%", pad=0.05
            )
            fig.colorbar(zoom, cax=cax, orientation="vertical")

        if _show:
            try:
                plt.tight_layout()
            except Exception:
                pass
            plt.show()
        return [tuple(int(v) for v in lim) for lim in limits]

    def plot_stats(self, stats_dict=None, stat_groups=[], ylim=None, show=False):
        """
        Plot per-iteration convergence statistics on a log scale:
        inefficiency (:math:`1-` efficiency), nonuniformity
        (:math:`1-` uniformity), ``pkpk_err`` and ``std_err`` for each
        stat group, with the ``fixed_phase`` flag history shaded behind
        the curves (WGS-Kim's phase-fixing window is the usual knee in
        these curves — the shading explains it).

        Parameters
        ----------
        stats_dict : dict OR None
            Stats tree to plot; defaults to :attr:`stats`.
        stat_groups : list of str OR None
            Groups to plot; empty/None plots all present.
        ylim : (float, float) OR None
            Explicit y limits.
        show : bool
            Whether to call ``plt.show()``.

        Returns
        -------
        matplotlib.axes.Axes

        Parity: ref ``_stats.py:729-830`` (log metrics, marker/color
        legends, fixed_phase shading).
        """
        import matplotlib.pyplot as plt

        if stats_dict is None:
            stats_dict = self.stats

        _, ax = plt.subplots(1, 1, figsize=(6, 4))

        stats = ["efficiency", "uniformity", "pkpk_err", "std_err"]
        markers = ["o", "o", "s", "D"]
        legend_names = ["inefficiency", "nonuniformity", "pkpk_err", "std_err"]
        niter = np.arange(len(stats_dict["method"]))
        groups = (
            [str(g) for g in stat_groups]
            if stat_groups
            else list(stats_dict["stats"].keys())
        )

        group_lines = []
        for g, group in enumerate(groups):
            record = stats_dict["stats"][group]
            color = f"C{g}"
            for i, stat in enumerate(stats):
                if stat not in record:
                    continue
                y = np.asarray(record[stat], dtype=float)
                if i < 2:
                    y = 1 - y  # Log-plot the *deficit* of the unit metrics.
                ax.scatter(
                    niter[: len(y)], y, marker=markers[i], ec=color,
                    fc="none" if i >= 1 else color,
                )
                ax.plot(niter[: len(y)], y, c=color, lw=0.5)
            group_lines.append(ax.plot([], [], c=color)[0])

        # Marker-style legend entries (black = any group).
        key_handles = [
            ax.scatter([], [], marker=m, ec="k", fc="none" if i >= 1 else "k")
            for i, m in enumerate(markers)
        ]

        ax.set_xlabel("Iteration")
        ax.set_ylabel("Relative Metrics")
        ax.set_title(type(self).__name__ + " Statistics")
        ax.set_yscale("log")
        ax.grid(True)
        try:
            plt.tight_layout()
        except Exception:
            pass  # All-nan series can break autoscaling; keep going.
        if ylim is not None:
            ax.set_ylim(ylim)

        # Shade the iterations where the phase was fixed (flag history).
        fixed = stats_dict.get("flags", {}).get("fixed_phase", [])
        fixed = np.asarray(
            [bool(v) and v == v for v in fixed], dtype=bool
        )  # nan-safe truthiness
        if fixed.any():
            # Dilate by one so single-iteration windows still render.
            edges = (
                np.concatenate((fixed, fixed[-1:]))
                | np.concatenate((fixed[:1], fixed))
            )
            span = np.arange(len(fixed) + 1) - 0.5
            yl = ax.get_ylim()
            poly = ax.fill_between(
                span, yl[0], yl[1], where=edges, alpha=0.1, color="b",
                zorder=-np.inf,
            )
            ax.set_ylim(yl)
            key_handles.append(poly)
            legend_names.append("fixed_phase")

        ax.legend(
            group_lines + key_handles, groups + legend_names, loc="lower left"
        )
        ax.set_xlim(-0.75, len(stats_dict["method"]) - 0.25)

        if show:
            plt.show()
        return ax


def _listdict_to_h5(tree):
    """Convert a stats tree with None/ragged values into h5-safe data."""
    if isinstance(tree, dict):
        return {str(k): _listdict_to_h5(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        try:
            arr = np.asarray([np.nan if v is None else v for v in tree])
            if arr.dtype == object:
                arr = np.asarray([str(v) for v in tree])
            return arr
        except (TypeError, ValueError):
            return np.asarray([str(v) for v in tree])
    if tree is None:
        return np.nan
    return tree


def _h5_to_listdict(tree):
    """Inverse of :meth:`_listdict_to_h5` (arrays back to lists)."""
    if isinstance(tree, dict):
        return {k: _h5_to_listdict(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.ndim == 1:
        return list(tree)
    return tree
