"""Run-directory layout and the experiment grid harness (counterpart of
``uav_bs_ctrl_tpu/utils/run_utils.py``; parity surface: reference
``utils/run_utils.py``).

- ``setup_logger_kwargs`` gives ``<data_dir>/<exp_name>/<exp_name>_s<seed>``,
  ``data_dir`` defaulting to ``data_torch/``.
- ``ExperimentGrid``: colon-nested keys (``'train_kwargs:lr'`` -> nested
  dicts), shorthand names from the first three letters of each colon part,
  the value-in-name rules (booleans as bare flags), cartesian variants; the
  JAX package's variant names and nesting.
- ``call_experiment`` runs each variant in a FRESH subprocess
  (``run_entrypoint.py``) for state isolation. The JAX package pickles a
  closure with cloudpickle; the port pickles ``functools.partial(thunk,
  **kwargs)`` with ``pickle`` in the same zlib + base64 framing (the GPU
  machine has no cloudpickle).

``num_cpu`` is accepted for the reference's signature and ignored beyond 1.
"""

import base64
import functools
import json
import os
import os.path as osp
import pickle
import string
import subprocess
import sys
import time
import zlib
from subprocess import CalledProcessError
from textwrap import dedent

import numpy as np

from uav_bs_ctrl_tpu_torch.utils.logx import colorize
from uav_bs_ctrl_tpu_torch.utils.serialization import convert_json
from uav_bs_ctrl_tpu_torch.utils.user_config import (DEFAULT_DATA_DIR, DEFAULT_SHORTHAND,
                                                     FORCE_DATESTAMP, WAIT_BEFORE_LAUNCH)

DIV_LINE_WIDTH = 80


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


def call_experiment(exp_name, thunk, seed=0, num_cpu=1, data_dir=None,
                    datestamp=False, **kwargs):
    """Run ``thunk(**kwargs)`` in a fresh subprocess (state isolation).
    ``thunk`` and every value in ``kwargs`` must pickle: module-level
    functions and classes (``algos/*/run.py:train``, the envs) do."""
    kwargs['seed'] = seed

    print(colorize('Running experiment:\n', color='cyan', bold=True))
    print(exp_name + '\n')
    print(colorize('with kwargs:\n', color='cyan', bold=True))
    kwargs_json = convert_json(kwargs)
    print(json.dumps(kwargs_json, separators=(',', ':\t'), indent=4, sort_keys=True))
    print('\n')

    if 'logger_kwargs' not in kwargs:
        kwargs['logger_kwargs'] = setup_logger_kwargs(exp_name, seed, data_dir, datestamp)
    else:
        print('Note: Call experiment is not handling logger_kwargs.\n')

    # A partial of a module-level thunk pickles by reference, so plain pickle
    # does what cloudpickle does for the JAX package's closure.
    pickled_thunk = pickle.dumps(functools.partial(thunk, **kwargs))
    encoded_thunk = base64.b64encode(zlib.compress(pickled_thunk)).decode('utf-8')

    entrypoint = osp.join(osp.abspath(osp.dirname(__file__)), 'run_entrypoint.py')
    cmd = [sys.executable or 'python', entrypoint, encoded_thunk]
    try:
        subprocess.check_call(cmd, env=os.environ)
    except CalledProcessError:
        err_msg = '\n' * 3 + '=' * DIV_LINE_WIDTH + '\n' + dedent("""
            There appears to have been an error in your experiment.
            Check the traceback above to see what actually went wrong.
            """) + '=' * DIV_LINE_WIDTH + '\n' * 3
        print(err_msg)
        raise

    logger_kwargs = kwargs['logger_kwargs']
    print(f"Results are saved to {logger_kwargs['output_dir']}.")


def all_bools(vals):
    return all(isinstance(v, bool) for v in vals)


def valid_str(v):
    """Convert a value (or list) to a filesystem-safe lowercase string."""
    if hasattr(v, '__name__'):
        return valid_str(v.__name__)
    if isinstance(v, (tuple, list)):
        return '-'.join(valid_str(x) for x in v)
    str_v = str(v).lower()
    valid_chars = "-_%s%s" % (string.ascii_letters, string.digits)
    return ''.join(c if c in valid_chars else '-' for c in str_v)


class ExperimentGrid:
    """Cartesian-product hyperparameter grids with auto-named variants."""

    def __init__(self, name=''):
        self.keys = []
        self.vals = []
        self.shs = []
        self.in_names = []
        self.name(name)

    def name(self, _name):
        assert isinstance(_name, str), "Name has to be a string."
        self._name = _name

    def print(self):
        print('=' * DIV_LINE_WIDTH)
        msg = 'ExperimentGrid [%s] runs over parameters:\n' % self._name
        print(colorize(msg, color='green', bold=True))
        for k, v, sh in zip(self.keys, self.vals, self.shs):
            print('', colorize(k.ljust(40), color='cyan', bold=True),
                  '[' + sh + ']' if sh is not None else '', '\n')
            for val in v:
                print('\t' + str(convert_json(val)))
            print()
        nvars_total = int(np.prod([len(v) for v in self.vals]))
        if 'seed' in self.keys:
            num_seeds = len(self.vals[self.keys.index('seed')])
            nvars_seedless = int(nvars_total / num_seeds)
        else:
            nvars_seedless = nvars_total
        print(' Variants, counting seeds: '.ljust(40), nvars_total)
        print(' Variants, not counting seeds: '.ljust(40), nvars_seedless)
        print()
        print('=' * DIV_LINE_WIDTH)

    def _default_shorthand(self, key):
        valid_chars = "%s%s" % (string.ascii_letters, string.digits)

        def shear(x):
            return ''.join(z for z in x[:3] if z in valid_chars)

        return '-'.join(shear(x) for x in key.split(':'))

    def add(self, key, vals, shorthand=None, in_name=False):
        assert isinstance(key, str), "Key must be a string."
        assert shorthand is None or isinstance(shorthand, str), "Shorthand must be a string."
        if not isinstance(vals, list):
            vals = [vals]
        if DEFAULT_SHORTHAND and shorthand is None:
            shorthand = self._default_shorthand(key)
        self.keys.append(key)
        self.vals.append(vals)
        self.shs.append(shorthand)
        self.in_names.append(in_name)

    @staticmethod
    def _lookup(variant, key):
        """Fetch ``key`` from a variant dict, descending colon-nested levels.

        Accepts both flat (``{'a:b': v}``) and nested (``{'a': {'b': v}}``)
        variants — ``variant_name`` is called on nested ones by ``run`` and on
        either by user code.
        """
        node, rest = variant, key
        while rest not in node:
            head, _, rest = rest.partition(':')
            node = node[head]
        return node[rest]

    def variant_name(self, variant):
        """Name a variant from its non-default parameters (seed excluded).

        Naming rules (shared with the reference so run dirs line up for the
        downstream plot/collect/eval tooling): a grid axis contributes a part
        iff it has >1 value or was added with ``in_name``; all-bool axes
        contribute their label as a bare flag only when True; other axes
        contribute ``<label><value>``.
        """
        parts = [self._name] if self._name else []
        for key, vals, sh, in_name in zip(self.keys, self.vals, self.shs,
                                          self.in_names):
            if key == 'seed' or (len(vals) == 1 and not in_name):
                continue
            label = valid_str(sh) if sh is not None else valid_str(key)
            value = self._lookup(variant, key)
            if all_bools(vals):
                if value:
                    parts.append(label)
            else:
                parts.append(label + valid_str(value))
        return '_'.join(parts) if parts else ''

    @staticmethod
    def _nest(flat):
        """Expand colon-separated keys into nested dicts (``'a:b': v`` ->
        ``{'a': {'b': v}}``), rejecting paths that collide."""
        nested = {}
        for key, val in flat.items():
            *path, leaf = key.split(':')
            node = nested
            for part in path:
                node = node.setdefault(part, {})
                if not isinstance(node, dict):
                    raise ValueError(
                        f"grid key {key!r} collides with a scalar at {part!r}")
            if leaf in node:
                raise ValueError(f"grid key {key!r} assigned more than once")
            node[leaf] = val
        return nested

    def variants(self):
        """All grid configs as dicts; colon keys become nested dicts.

        ``itertools.product`` iterates the first axis slowest, matching the
        run order users see in the printed variant list.
        """
        import itertools
        return [self._nest(dict(zip(self.keys, combo)))
                for combo in itertools.product(*self.vals)]

    def run(self, thunk, num_cpu=1, data_dir=None, datestamp=False,
            fail_fast=True):
        """Launch every variant serially, each in a fresh subprocess.

        ``fail_fast=False`` records crashed variants and keeps going instead
        of aborting the whole grid (the reference aborts on the first
        ``CalledProcessError``; see SURVEY.md §5 failure-detection notes) and
        reports the failures at the end.
        """
        self.print()
        variants = self.variants()
        var_names = sorted({self.variant_name(var) for var in variants})
        line = '=' * DIV_LINE_WIDTH
        preparing = colorize('Preparing to run the following experiments...',
                             color='green', bold=True)
        print(f"\n{preparing}\n\n" + '\n'.join(var_names) + f"\n\n{line}")

        if WAIT_BEFORE_LAUNCH > 0:
            time.sleep(WAIT_BEFORE_LAUNCH)

        failures = []
        for var in variants:
            exp_name = self.variant_name(var)
            if isinstance(thunk, str):
                thunk_ = var[thunk]
                del var[thunk]
            else:
                thunk_ = thunk
            try:
                call_experiment(exp_name, thunk_, num_cpu=num_cpu,
                                data_dir=data_dir, datestamp=datestamp, **var)
            except CalledProcessError:
                if fail_fast:
                    raise
                failures.append(exp_name)
                print(colorize(f"Variant {exp_name} FAILED; continuing.",
                               color='red', bold=True))
        if failures:
            print(colorize("Failed variants:\n  " + "\n  ".join(failures),
                           color='red', bold=True))
        return failures


def test_eg():
    eg = ExperimentGrid()
    eg.add('test:a', [1, 2, 3], 'ta', True)
    eg.add('test:b', [1, 2, 3])
    eg.add('some', [4, 5])
    eg.add('why', [True, False])
    eg.add('huh', 5)
    eg.add('no', 6, in_name=True)
    return eg.variants()
