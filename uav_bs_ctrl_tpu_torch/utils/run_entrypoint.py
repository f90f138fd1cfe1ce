"""Subprocess entry point of ``utils/run_utils.py:call_experiment``: decode
and run a pickled experiment thunk (counterpart of
``uav_bs_ctrl_tpu/utils/run_entrypoint.py``).

The thunk is a ``functools.partial`` of a module-level function, pickled with
``pickle`` (zlib, then base64); the repo root is put on ``sys.path`` first, so
that unpickling can import the ``uav_bs_ctrl_tpu_torch`` modules it names.
"""

import base64
import os
import pickle
import sys
import zlib

BASE_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, BASE_DIR)

if __name__ == '__main__':
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument('encoded_thunk')
    args = parser.parse_args()
    thunk = pickle.loads(zlib.decompress(base64.b64decode(args.encoded_thunk)))
    thunk()
