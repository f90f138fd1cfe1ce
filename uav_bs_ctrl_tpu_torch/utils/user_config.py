"""Defaults for where runs write (counterpart of ``uav_bs_ctrl_tpu/utils/user_config.py``)."""

import os.path as osp

# Where port runs are saved by default: <repo root>/data_torch. The JAX
# package's runs live in <repo root>/data; a port run never writes there, so a
# fresh port logger cannot truncate a committed run's progress.txt.
DEFAULT_DATA_DIR = osp.join(
    osp.abspath(osp.dirname(osp.dirname(osp.dirname(__file__)))), 'data_torch')

# Whether to insert a date and time stamp into save-dir names.
FORCE_DATESTAMP = False

# Whether ExperimentGrid auto-generates shorthand key names.
DEFAULT_SHORTHAND = True

# Seconds to pause before launching a grid (0 disables).
WAIT_BEFORE_LAUNCH = 0
