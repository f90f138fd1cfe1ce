"""Serving configuration (counterpart of ``algos/madrqn/config.py``).

``DEFAULT_CONFIG`` holds the defaults the serving slice reads; a run's saved
``config.json`` args are laid over them. JAX backend names are accepted: every
GATv2 backend maps to the fused kernel and every step backend to the fused
step, except ``gat_backend='pallas'`` (the unfused ``flash_gat`` kernel, not yet
ported).
"""

from types import SimpleNamespace

from uav_bs_ctrl_tpu_torch.device import resolve_device

DEFAULT_CONFIG = {
    'device': 'cuda',
    'o': 'mlp',            # observation encoder ('mlp' | 'gnn')
    'c': None,             # comm protocol; the port has 'tarmac' only
    'hidden_size': 64,
    'n_heads': 4,
    'msg_size': 64,
    'key_size': 16,
    'n_rounds': 1,
    'gat_backend': 'dense',
    'comm_backend': 'dense',
    'step_backend': 'xla',
    'compute_dtype': 'float32',
    'dueling': False,
}

GAT_BACKENDS = ('dense', 'pallas_fused', 'pallas_fused_mxu', 'graph_parallel')


def make_args(saved_args: dict, device=None) -> SimpleNamespace:
    """Defaults overlaid with a run's saved args; ``device`` wins when given."""
    config = dict(DEFAULT_CONFIG)
    config.update(saved_args)
    if device is not None:
        config['device'] = device
    return check_args_sanity(SimpleNamespace(**config))


def check_args_sanity(args):
    """Resolve ``args.device`` (raises when CUDA is asked for and absent) and
    reject what the port does not serve."""
    args.device = resolve_device(args.device)
    if args.o != 'gnn' or args.c != 'tarmac' or args.n_rounds != 1:
        raise NotImplementedError(
            f"the port serves the GNN agent with one-round TarMAC only; got "
            f"o={args.o!r}, c={args.c!r}, n_rounds={args.n_rounds} (ROADMAP.md Queue 1)")
    if args.gat_backend == 'pallas':
        raise NotImplementedError(
            "gat_backend='pallas' (the unfused flash_gat kernel) is still to be "
            "ported (ROADMAP.md Queue 2, kernel #1)")
    if args.gat_backend not in GAT_BACKENDS:
        raise ValueError(f"gat_backend must be one of {GAT_BACKENDS + ('pallas',)}, "
                         f"got {args.gat_backend!r}")
    if args.comm_backend not in ('dense', 'graph_parallel'):
        raise ValueError(f"comm_backend must be 'dense' or 'graph_parallel', "
                         f"got {args.comm_backend!r}")
    if args.step_backend not in ('xla', 'pallas'):
        raise ValueError(f"step_backend must be 'xla' or 'pallas', got {args.step_backend!r}")
    if args.compute_dtype != 'float32':
        raise NotImplementedError(f"compute_dtype={args.compute_dtype!r}: the port "
                                  "serves float32 only")
    return args
