"""
Statistics bookkeeping for holograms (port of the stats-recording part of
:mod:`slmsuite_tpu.holography.algorithms._stats`).

The per-iteration metrics are computed on the device inside the loop
(:mod:`slmsuite_torch.ops.engine`) and folded here into the reference's
stats dictionary, ``holo.stats["stats"][group][metric]``. HDF5 save/load
imports its helpers when called.
"""

import numpy as np

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
