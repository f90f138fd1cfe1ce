"""Run-directory layout (counterpart of ``uav_bs_ctrl_tpu/utils/run_utils.py``:
``setup_logger_kwargs`` only; ``ExperimentGrid`` and ``call_experiment`` are
still to be ported, ROADMAP.md Queue 1)."""

import os.path as osp
import time

from uav_bs_ctrl_tpu_torch.utils.user_config import DEFAULT_DATA_DIR, FORCE_DATESTAMP


def setup_logger_kwargs(exp_name, seed=None, data_dir=None, datestamp=False):
    """Logger kwargs for ``<data_dir>/<exp_name>/<exp_name>_s<seed>`` (with
    ``datestamp``, date-stamped names), ``data_dir`` defaulting to
    :data:`DEFAULT_DATA_DIR`."""
    datestamp = datestamp or FORCE_DATESTAMP
    ymd_time = time.strftime("%Y-%m-%d_") if datestamp else ''
    relpath = ''.join([ymd_time, exp_name])

    if seed is not None:
        if datestamp:
            hms_time = time.strftime("%Y-%m-%d_%H-%M-%S")
            subfolder = ''.join([hms_time, '-', exp_name, '_s', str(seed)])
        else:
            subfolder = ''.join([exp_name, '_s', str(seed)])
        relpath = osp.join(relpath, subfolder)

    data_dir = data_dir or DEFAULT_DATA_DIR
    return dict(output_dir=osp.join(data_dir, relpath), exp_name=exp_name)
