"""Episode recorders: capture per-step trajectories and export them as CSVs.

Counterpart of ``uav_bs_ctrl_tpu/envs/recorder.py``: the same per-episode
files, ``path_ubs.csv``, ``pos_gts.csv`` and ``others.csv``, in the layout
pandas' ``DataFrame.to_csv`` gives them there (a three-row header for the
UBS path's column levels, the GT rows named ``GT-m``, the float32 and float64
values in their shortest round-trip form, ``""`` for an empty frame), written
with the ``csv`` module, so a pandas reader gets the same frames. The JAX
package also draws ``trajectories.png`` with matplotlib; the port draws no
figure (the GPU machine has neither pandas nor matplotlib).
"""

import csv
import os
import os.path as osp

import numpy as np


def format_column(values):
    """The strings pandas writes for a column of ``values``: numpy's shortest
    round-trip form at the column's dtype (float32 stays float32), NaN as the
    empty string."""
    arr = np.asarray(values)
    out = arr.astype(str)
    if arr.dtype.kind == "f":
        out[np.isnan(arr)] = ""
    return out.tolist()


def write_frame_csv(path, index, columns, header_rows, index_name=None):
    """Write a frame as ``DataFrame.to_csv`` does: ``columns`` a list of value
    lists, ``header_rows`` one list of labels per column level (each led by
    that level's name, or ``""``), ``index`` the row labels. Under a header
    of more than one level a named index gets a row of its own."""
    cells = [format_column(c) for c in columns]
    labels = index if index and isinstance(index[0], str) else format_column(index)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerows(header_rows)
        if index_name is not None:
            writer.writerow([index_name] + [""] * len(columns))
        for i, label in enumerate(labels):
            writer.writerow([label] + [c[i] for c in cells])


def export_episode_csvs(save_dir, path_ubs, pos_gts, **series):
    """Write an episode's trajectory CSVs in the reference's layout."""
    ep_len = path_ubs.shape[0]
    n_ubs = path_ubs.shape[1] if path_ubs.ndim == 3 else 1
    flat = np.asarray(path_ubs).reshape(ep_len, -1)
    ubs = [f"UBS-{i}" for i in range(n_ubs) for _ in "xy"]
    write_frame_csv(osp.join(save_dir, "path_ubs.csv"), list(range(ep_len)),
                    [flat[:, j] for j in range(flat.shape[1])],
                    [[""] + ubs, [""] + ["position"] * len(ubs), [""] + ["x", "y"] * n_ubs])

    pos_gts = np.asarray(pos_gts)
    write_frame_csv(osp.join(save_dir, "pos_gts.csv"),
                    [f"GT-{m}" for m in range(pos_gts.shape[0])],
                    [pos_gts[:, 0], pos_gts[:, 1]], [["", "x", "y"]])

    n_rows = len(next(iter(series.values()))) if series else 0
    write_frame_csv(osp.join(save_dir, "others.csv"), list(range(n_rows)),
                    [np.asarray(v) for v in series.values()], [[""] + list(series)])


class MultiUbsRecorder:
    """Captures multi-UBS episode trajectories."""

    def __init__(self, env):
        self.env = env
        self.film = dict(pos_ubs=None, reward=None, fair_idx=None)

    def __getattr__(self, item):
        return getattr(self.env, item)

    def reload(self):
        self.film = dict(pos_ubs=[self.pos_ubs.copy()], reward=[], fair_idx=[])

    def click(self, **kwargs):
        for k, v in kwargs.items():
            assert k in self.film and isinstance(self.film[k], list)
            self.film[k].append(v)

    def replay(self, annotate=True, show_img=False, save_dir=None):
        """Write the episode's CSVs into ``save_dir`` (the JAX recorder's
        arguments; no figure is drawn)."""
        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)
            export_episode_csvs(save_dir, np.stack(self.film["pos_ubs"]), pos_gts=self.pos_gts)


class SingleUbsRecorder:
    """Captures single-UBS episodes (trajectory, fairness and reward)."""

    KEYS = ("pos_ubs", "global_utility", "reward", "total_throughput",
            "fair_idx", "velocity", "rate_per_gt")

    def __init__(self, env):
        self.env = env
        self.film = {k: [] for k in self.KEYS}

    def __getattr__(self, item):
        return getattr(self.env, item)

    def reload(self):
        self.film = {k: [] for k in self.KEYS}
        self.film["pos_ubs"] = [self.pos_ubs.copy()]

    def click(self, **kwargs):
        for k, v in kwargs.items():
            assert k in self.film and isinstance(self.film[k], list)
            self.film[k].append(v)

    def replay(self, annotate=True, show_img=False, save_dir=None):
        """Write the episode's CSVs (with its fairness and reward series) into
        ``save_dir``; no figure is drawn."""
        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)
            export_episode_csvs(save_dir, np.stack(self.film["pos_ubs"]), pos_gts=self.pos_gts,
                                fair_idx=np.array(self.film["fair_idx"]),
                                reward=np.array(self.film["reward"]))
