"""Epoch-buffered tabular logger (counterpart of ``uav_bs_ctrl_tpu/utils/logx.py``).

Same output as the JAX package's: a tab-separated ``progress.txt`` with the
same column-naming rules (``Average``/``Std``/``Max``/``Min`` prefixes), header
line and ``str()`` formatting of the values, an aligned stdout table, and a
``config.json`` snapshot, so the JAX package's ``utils/plot.py`` and
``benchmarks/plot_parity.py`` read a port run as they are.

Several ranks (a ``torch.distributed`` process group): rank 0 alone makes
the output directory and writes ``progress.txt``, ``config.json`` and stdout,
as the JAX logger gates on its process index (``utils/logx.py:88-142``), and
the epoch statistics cover every rank's samples
(``parallel.dist.dist_statistics_scalar``); every rank logs the same keys.
"""

import atexit
import json
import os
import os.path as osp
import sys
import tempfile
import time

import numpy as np

from uav_bs_ctrl_tpu_torch.utils.serialization import convert_json

# SGR foreground codes (ANSI): +10 selects the background variant.
_ANSI_FG = dict(gray=30, red=31, green=32, yellow=33, blue=34, magenta=35,
                cyan=36, white=37, crimson=38)


def colorize(text, color, bold=False, highlight=False):
    codes = [str(_ANSI_FG[color] + (10 if highlight else 0))]
    if bold:
        codes.append('1')
    return f"\x1b[{';'.join(codes)}m{text}\x1b[0m"


def _process_group():
    """``torch.distributed`` when a process group is initialized, else None.
    It is read only when loaded already (no group exists before), so that
    the logger, and ``run_fast`` with it, import without torch."""
    dist = sys.modules.get("torch.distributed")
    return dist if dist is not None and dist.is_available() and dist.is_initialized() else None


def proc_id() -> int:
    """This process's rank (0 without a process group)."""
    dist = _process_group()
    return 0 if dist is None else dist.get_rank()


def _multihost() -> bool:
    dist = _process_group()
    return dist is not None and dist.get_world_size() > 1


def statistics_scalar(x, with_min_and_max=False):
    """Mean/std (and optional min/max) of scalar samples, in float32 on one
    rank; across the ranks of the process group on several."""
    if proc_id() != 0 or _multihost():
        from uav_bs_ctrl_tpu_torch.parallel.dist import dist_statistics_scalar
        return dist_statistics_scalar(x, with_min_and_max=with_min_and_max)
    x = np.array(x, dtype=np.float32)
    mean = x.mean() if x.size else 0.0
    std = np.sqrt(np.mean((x - mean) ** 2)) if x.size else 0.0
    if with_min_and_max:
        mn = x.min() if x.size else np.inf
        mx = x.max() if x.size else -np.inf
        return mean, std, mn, mx
    return mean, std


class Logger:
    """Writes diagnostics to stdout and a TSV ``progress.txt``."""

    def __init__(self, output_dir=None, output_fname='progress.txt', exp_name=None,
                 append=False):
        """``append=True`` continues an existing ``progress.txt`` instead of
        truncating it (a resumed run); the header line is written only to a
        fresh file, and ``run_fast`` logs the same columns every epoch. A rank
        other than 0 opens nothing (``output_dir`` None)."""
        self._skip_header = False
        self.output_dir = self.output_file = None
        if proc_id() == 0:
            self.output_dir = output_dir or osp.join(tempfile.gettempdir(), "experiments",
                                                     str(int(time.time())))
            if osp.exists(self.output_dir):
                print("Warning: Log dir %s already exists! Storing info there anyway."
                      % self.output_dir)
            else:
                os.makedirs(self.output_dir)
            fpath = osp.join(self.output_dir, output_fname)
            mode = 'a' if append and osp.exists(fpath) and os.path.getsize(fpath) else 'w'
            self._skip_header = (mode == 'a')
            self.output_file = open(fpath, mode)
            atexit.register(self.output_file.close)
            print(colorize("Logging data to %s" % self.output_file.name, 'green', bold=True))
        self.first_row = True
        self.log_headers = []
        self.log_current_row = {}
        self.exp_name = exp_name

    def log(self, msg, color='green'):
        if proc_id() == 0:
            print(colorize(msg, color, bold=True))

    def log_tabular(self, key, val):
        if self.first_row:
            self.log_headers.append(key)
        elif key not in self.log_headers:
            raise KeyError(f"Trying to introduce a new key {key} that you didn't include "
                           "in the first iteration")
        if key in self.log_current_row:
            raise KeyError(f"You already set {key} this iteration. Maybe you forgot to "
                           "call dump_tabular()")
        self.log_current_row[key] = val

    def save_config(self, config):
        """Snapshot the experiment config as JSON (read back by evaluation)."""
        if proc_id() != 0:
            return
        config_json = convert_json(config)
        if self.exp_name is not None:
            config_json['exp_name'] = self.exp_name
        output = json.dumps(config_json, separators=(',', ':\t'), indent=4, sort_keys=True)
        print(colorize('Saving config:\n', color='cyan', bold=True))
        print(output)
        with open(osp.join(self.output_dir, "config.json"), 'w') as out:
            out.write(output)

    def dump_tabular(self):
        """Flush the current row: a boxed stdout table and one TSV line
        (tab-joined ``str()`` of the raw values; the header only on a fresh
        file's first row); rank 0 alone prints and writes."""
        if proc_id() == 0:
            self._write_row()
        self.log_current_row.clear()
        self.first_row = False

    def _write_row(self):
        row = [self.log_current_row.get(key, "") for key in self.log_headers]
        width = max([15, *map(len, self.log_headers)])
        rule = "-" * (width + 22)
        lines = [rule]
        for key, val in zip(self.log_headers, row):
            shown = f"{val:8.3g}" if hasattr(val, "__float__") else val
            lines.append(f"| {key:>{width}} | {shown:>15} |")
        lines.append(rule)
        print("\n".join(lines), flush=True)
        if self.first_row and not self._skip_header:
            self.output_file.write("\t".join(self.log_headers) + "\n")
        self.output_file.write("\t".join(str(v) for v in row) + "\n")
        self.output_file.flush()


class EpochLogger(Logger):
    """Adds per-epoch mean/std/min/max accumulation via ``store()``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.epoch_dict = dict()

    def store(self, **kwargs):
        for k, v in kwargs.items():
            self.epoch_dict.setdefault(k, []).append(v)

    def log_tabular(self, key, val=None, with_min_and_max=False, average_only=False):
        if val is not None:
            super().log_tabular(key, val)
        else:
            stats = self.get_stats(key, with_min_and_max)
            super().log_tabular(key if average_only else 'Average' + key, stats[0])
            if not average_only:
                super().log_tabular('Std' + key, stats[1])
            if with_min_and_max:
                super().log_tabular('Max' + key, stats[3])
                super().log_tabular('Min' + key, stats[2])
        self.epoch_dict[key] = []

    def get_stats(self, key, with_min_and_max=False):
        v = self.epoch_dict[key]
        vals = (np.concatenate(v) if isinstance(v[0], np.ndarray) and len(v[0].shape) > 0
                else v)
        return statistics_scalar(vals, with_min_and_max=with_min_and_max)
