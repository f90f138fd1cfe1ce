"""Default DRQN configuration (counterpart of ``algos/drqn/config.py``).

JAX's ``DEFAULT_CONFIG`` with ``device='cuda'``, plus the keys JAX's
``RecurrentQLearner`` and ``RnnAgent`` read through ``getattr`` with a
default, set to that default: no double-Q, mixer, dueling head or shared
reward, and the ``per_step`` BPTT schedule.
"""

from uav_bs_ctrl_tpu_torch.config import check_compute, check_matmul_precision
from uav_bs_ctrl_tpu_torch.device import resolve_device

DEFAULT_CONFIG = {

    'device': 'cuda',
    'cuda_deterministic': False,

    'agent': 'rnn',        # Agent type ('rnn' | 'gnn')

    # Model parameters
    'hidden_size': 256,
    'n_layers': 2,
    'n_heads': 4,
    'compute_dtype': 'float32',
    'matmul_precision': None,    # None|'default'|'high'|'highest': torch's f32 matmul switches

    # Basic training hyperparameters
    'lr': 5e-4,
    'gamma': 0.99,
    'polyak': 0.999,
    'batch_size': 32,
    'replay_size': int(5e4),
    'decay_steps': int(2e5),
    'max_seq_len': 10,

    'steps_per_epoch': 10000,
    'epochs': 50,
    'update_after': 5000,
    'num_test_episodes': 5,
    'save_freq': 10,

    # Optimization techniques
    'anneal_lr': True,

    # JAX core.py / agents.py getattr defaults
    'double_q': False,
    'mixer': False,
    'dueling': False,
    'share_reward': False,
    'bptt_encoder': 'per_step',
}


def check_args(args):
    """Resolve ``args.device`` (raises when CUDA is asked for and absent) and
    reject what the port does not run: JAX's ``check_args_sanity`` on the
    DRQN keys."""
    args.device = resolve_device(args.device)
    if args.agent not in ('rnn', 'gnn'):
        raise ValueError(f"agent must be 'rnn' or 'gnn', got {args.agent!r}")
    check_matmul_precision(args)
    check_compute(args)
    return args
