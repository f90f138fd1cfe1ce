"""Configuration (counterpart of ``algos/madrqn/config.py`` and
``algos/common.py:check_args_sanity``).

``DEFAULT_CONFIG`` holds the JAX package's defaults for the keys the port
reads, serving and training; a run's saved ``config.json`` args are laid over
them. JAX backend names are accepted: ``gat_backend='pallas'`` maps to the
``flash_gat`` kernel (inference only, as in JAX), every other GATv2 backend
to the projection-fused kernels, and either step backend of one-round TarMAC
to the fused step. Serving takes every comm protocol (or none) at any number
of rounds; training (:func:`check_training_args`) takes one-round TarMAC.
"""

from types import SimpleNamespace

from uav_bs_ctrl_tpu_torch.device import resolve_device
from uav_bs_ctrl_tpu_torch.models.comm import COMM_PROTOCOLS

DEFAULT_CONFIG = {
    'device': 'cuda',
    'o': 'mlp',            # observation encoder ('mlp' | 'gnn')
    'c': None,             # comm protocol (models/comm.py), or None for a GRU only
    'share_reward': False,
    'hidden_size': 64,
    'n_heads': 4,
    'msg_size': 64,
    'key_size': 16,
    'n_rounds': 1,
    'embed_dim': 32,       # QMixer embedding dim
    'gat_backend': 'dense',
    'comm_backend': 'dense',
    'step_backend': 'xla',
    'compute_dtype': 'float32',
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
    'update_after': 2000,
    'anneal_lr': True,
    'double_q': False,
    'mixer': False,
}

GAT_BACKENDS = ('dense', 'pallas', 'pallas_fused', 'pallas_fused_mxu', 'graph_parallel')


def make_args(saved_args: dict, device=None) -> SimpleNamespace:
    """Defaults overlaid with a run's saved args; ``device`` wins when given."""
    config = dict(DEFAULT_CONFIG)
    config.update(saved_args)
    if device is not None:
        config['device'] = device
    return check_args_sanity(SimpleNamespace(**config))


def check_args_sanity(args):
    """Resolve ``args.device`` (raises when CUDA is asked for and absent),
    force a shared reward under QMIX, and reject what the port does not run."""
    args.device = resolve_device(args.device)
    if getattr(args, 'mixer', False) and not getattr(args, 'share_reward', False):
        args.share_reward = True        # QMIX mixes one scalar team reward
    if args.o != 'gnn':
        raise NotImplementedError(
            f"o={args.o!r}: the port runs the GNN observation encoder only; the MLP "
            "encoder and RnnAgent are still to be ported (ROADMAP.md Queue 1)")
    if args.c is not None and args.c not in COMM_PROTOCOLS:
        raise KeyError(f"Unsupported communication scheme {args.c!r}; one of "
                       f"{COMM_PROTOCOLS} or None")
    mm_prec = getattr(args, 'matmul_precision', None)
    if mm_prec not in (None, 'default', 'high', 'highest'):
        raise ValueError(f"matmul_precision must be None|'default'|'high'|'highest', "
                         f"got {mm_prec!r}")
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
    if args.compute_dtype != 'float32':
        raise NotImplementedError(f"compute_dtype={args.compute_dtype!r}: the port runs "
                                  "float32 only; bf16 compute is still to be ported "
                                  "(ROADMAP.md Queue 1)")
    if getattr(args, 'bptt_encoder', 'per_step') != 'per_step':
        raise NotImplementedError(f"bptt_encoder={args.bptt_encoder!r}: the port runs the "
                                  "'per_step' schedule only; 'hoisted' and 'merged' are "
                                  "still to be ported (ROADMAP.md Queue 1)")
    return args


def check_training_args(args):
    """What the trainer and learner take beyond :func:`check_args_sanity`:
    a differentiable GATv2 backend (the JAX package's rule) and, for now,
    one-round TarMAC."""
    if args.gat_backend == 'pallas':
        raise ValueError(
            "gat_backend='pallas' (unfused flash_gat) is inference/benchmark only — it has "
            "no custom VJP.  Use 'pallas_fused' or 'pallas_fused_mxu' for training, or call "
            "models.encoders.gatv2(..., backend='pallas') directly.")
    if args.c != 'tarmac' or args.n_rounds != 1:
        raise NotImplementedError(
            f"the port trains the GNN agent with one-round TarMAC only; got c={args.c!r}, "
            f"n_rounds={args.n_rounds} (ROADMAP.md Queue 1)")
    return args
