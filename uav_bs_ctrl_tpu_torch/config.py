"""Configuration (counterpart of ``algos/madrqn/config.py`` and
``algos/common.py:check_args_sanity``).

``DEFAULT_CONFIG`` holds the JAX package's defaults for the keys the port
reads, serving and training; a run's saved ``config.json`` args are laid over
them. JAX backend names are accepted: ``gat_backend='pallas'`` maps to the
``flash_gat`` kernel (inference only, as in JAX), every other GATv2 backend
to the projection-fused kernels, and either step backend of one-round TarMAC
to the fused step. Both observation encoders ('gnn', 'mlp') and every comm
protocol (or none) at any number of rounds are served and trained, at
``compute_dtype`` float32 or bfloat16 and under every ``bptt_encoder``
schedule (``per_step``, ``hoisted``, ``merged``);
:func:`check_training_args` adds the JAX package's rule that training needs a
differentiable GATv2 backend.
"""

import random
from types import SimpleNamespace

import numpy as np
import torch

from uav_bs_ctrl_tpu_torch.device import resolve_device
from uav_bs_ctrl_tpu_torch.models.comm import COMM_PROTOCOLS

DEFAULT_CONFIG = {
    'device': 'cuda',
    'o': 'mlp',            # observation encoder ('mlp' | 'gnn')
    'c': None,             # comm protocol (models/comm.py), or None for a GRU only
    'share_reward': False,
    'hidden_size': 64,
    'n_layers': 1,         # MLP encoder depth (o='mlp')
    'n_heads': 4,
    'msg_size': 64,
    'key_size': 16,
    'n_rounds': 1,
    'embed_dim': 32,       # QMixer embedding dim
    'gat_backend': 'dense',
    'comm_backend': 'dense',
    'step_backend': 'xla',
    'compute_dtype': 'float32',
    'matmul_precision': None,  # None|'default'|'high'|'highest': torch's f32 matmul switches
    'bptt_encoder': 'per_step',
    'dueling': False,
    # training
    'lr': 5e-4,
    'gamma': 0.99,
    'polyak': 0.995,
    'batch_size': 32,
    'replay_size': int(5e3),
    'decay_steps': int(5e4),
    'max_seq_len': None,   # None -> episode_limit
    'steps_per_epoch': 4000,
    'epochs': 50,
    'update_after': 2000,
    'num_test_episodes': 5,
    'save_freq': 10,
    'anneal_lr': True,
    'norm_r': True,        # kept for config parity; unwired (SURVEY.md quirk 1)
    'double_q': False,
    'mixer': False,
}

GAT_BACKENDS = ('dense', 'pallas', 'pallas_fused', 'pallas_fused_mxu', 'graph_parallel')
COMPUTE_DTYPES = ('float32', 'bfloat16')
BPTT_SCHEDULES = ('per_step', 'hoisted', 'merged')


def make_args(saved_args: dict, device=None) -> SimpleNamespace:
    """Defaults overlaid with a run's saved args, on the caller's ``device``
    (None: ``cuda``). The ``device`` a run stored is never read: committed
    runs store ``"cpu"`` or ``"tpu"``, and a run must not leave the card
    because of where it was trained."""
    config = dict(DEFAULT_CONFIG)
    config.update(saved_args)
    config['device'] = device
    return check_args_sanity(SimpleNamespace(**config))


def check_args_sanity(args):
    """Resolve ``args.device`` (raises when CUDA is asked for and absent),
    force a shared reward under QMIX, and reject what the port does not run."""
    args.device = resolve_device(args.device)
    if getattr(args, 'mixer', False) and not getattr(args, 'share_reward', False):
        args.share_reward = True        # QMIX mixes one scalar team reward
    if args.o not in ('gnn', 'mlp'):
        raise ValueError(f"o must be 'gnn' or 'mlp', got {args.o!r}")
    if args.c is not None and args.c not in COMM_PROTOCOLS:
        raise KeyError(f"Unsupported communication scheme {args.c!r}; one of "
                       f"{COMM_PROTOCOLS} or None")
    check_matmul_precision(args)
    # bptt_unroll (JAX core.py:87) is accepted and ignored: eager BPTT has no unroll.
    if int(args.n_rounds) < 1:
        raise ValueError(f"n_rounds must be >= 1, got {args.n_rounds}")
    if args.gat_backend not in GAT_BACKENDS:
        raise ValueError(f"gat_backend must be one of {GAT_BACKENDS}, got {args.gat_backend!r}")
    if args.comm_backend not in ('dense', 'graph_parallel'):
        raise ValueError(f"comm_backend must be 'dense' or 'graph_parallel', "
                         f"got {args.comm_backend!r}")
    if args.step_backend not in ('xla', 'pallas'):
        raise ValueError(f"step_backend must be 'xla' or 'pallas', got {args.step_backend!r}")
    if args.step_backend == 'pallas' and (args.c != 'tarmac' or args.n_rounds != 1):
        raise ValueError("step_backend='pallas' requires c='tarmac' and n_rounds=1 (the "
                         "fused recurrent-step kernel covers the TarMAC+GRU+head step only)")
    if args.step_backend == 'pallas' and args.comm_backend != 'dense':
        raise ValueError("step_backend='pallas' and comm_backend='graph_parallel' are mutually "
                         "exclusive (the fused step kernel is single-device; shard the batch "
                         "axis instead)")
    check_compute(args)
    return args


def check_matmul_precision(args):
    """JAX's ``matmul_precision`` check, then :func:`set_matmul_precision`."""
    mm_prec = getattr(args, 'matmul_precision', None)
    if mm_prec not in (None, 'default', 'high', 'highest'):
        raise ValueError(f"matmul_precision must be None|'default'|'high'|'highest', "
                         f"got {mm_prec!r}")
    set_matmul_precision(mm_prec)


def check_compute(args):
    """JAX's checks of the compute dtype (``algos/common.py:37-40``, a
    ``ValueError``) and of the BPTT schedule (``algos/core.py:80-82``, an
    ``AssertionError``)."""
    compute_dtype = getattr(args, 'compute_dtype', 'float32')
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', "
                         f"got {compute_dtype!r}")
    bptt_encoder = getattr(args, 'bptt_encoder', 'per_step')
    if bptt_encoder not in BPTT_SCHEDULES:
        raise AssertionError(bptt_encoder)


def set_matmul_precision(mm_prec):
    """Map ``matmul_precision`` onto the process as JAX's ``check_args_sanity``
    does onto ``jax_default_matmul_precision``: 'highest' turns TF32 off (true
    f32 products), 'high' lets torch use TF32; None and 'default' leave the
    process as it is."""
    if mm_prec == 'highest':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision('highest')
    elif mm_prec == 'high':
        torch.set_float32_matmul_precision('high')


def check_training_args(args):
    """What the trainer and learner take beyond :func:`check_args_sanity`: a
    differentiable GATv2 backend (the JAX package's rule). The DRQN config
    has no ``gat_backend``: its agent has one GATv2 path."""
    if getattr(args, 'gat_backend', None) == 'pallas':
        raise ValueError(
            "gat_backend='pallas' (unfused flash_gat) is inference/benchmark only — it has "
            "no custom VJP.  Use 'pallas_fused' or 'pallas_fused_mxu' for training, or call "
            "models.encoders.gatv2(..., backend='pallas') directly.")
    return args


def set_rand_seed(seed: int) -> np.random.RandomState:
    """Seed Python's ``random`` (as JAX's ``algos/common.py:set_rand_seed``)
    and return the host loop's NumPy stream, ``np.random.RandomState(seed)``.
    The classic drivers thread it through the host envs, ``act`` and the
    replay sample, which draw from it in the JAX package's order; JAX draws
    the same numbers from ``np.random`` after ``np.random.seed(seed)``."""
    random.seed(seed)
    return np.random.RandomState(seed)
