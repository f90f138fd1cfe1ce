"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Real TPU hardware (single chip under the driver) is exercised by ``bench.py``;
unit tests validate numerics and multi-chip sharding on host CPU devices.

Note: some pytest plugins (jaxtyping) import jax before this conftest runs,
so setting ``JAX_PLATFORMS`` in the environment is not enough — we must also
update the live jax config.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card and nvcc; skips where there is none")
