"""Environments: the on-device env batched over worlds (``torch_env``,
``torch_env_subs``), its NumPy map layouts, and the host NumPy envs of the
classic drivers, registered by class name as the JAX package's
``envs/__init__.py`` (without its pandas import, which the JAX package pulls
in through its recorder)."""

REGISTRY = {}

from uav_bs_ctrl_tpu_torch.envs.mubs_cov import MultiUbsCoverageEnv  # noqa: E402
from uav_bs_ctrl_tpu_torch.envs.subs_cov import SingleUbsCoverageEnv  # noqa: E402

REGISTRY["SingleUbsCoverageEnv"] = SingleUbsCoverageEnv
REGISTRY["MultiUbsCoverageEnv"] = MultiUbsCoverageEnv
