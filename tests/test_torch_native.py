"""The port's C++ env core (``uav_bs_ctrl_tpu_torch/native``).

- The port's ``MultiUbsCoverageEnv`` with the core against the same env on its
  NumPy scheduler, on ``debug``, ``4ubs`` and ``8ubs`` (JAX's
  ``tests/test_native.py``): schedules exactly equal; rates, rewards and
  state within 1e-6.
- The port's env with its core against the JAX package's env with the JAX
  core, from the same ``RandomState`` seed: the same checks.
- The library is built from the repo's source into the port's gitignored
  ``native/_build/``, never the JAX package's committed ``libuavbs.so``; a
  second build reuses the hashed file, and a changed flag builds another.
- With no C++ compiler the env runs NumPy, warns once with the reason and
  records ``scheduler == 'numpy'``.
- ``python -m uav_bs_ctrl_tpu_torch.native.build`` builds it.
"""

import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from uav_bs_ctrl_tpu.envs.mubs_cov import MultiUbsCoverageEnv as JaxMubs
from uav_bs_ctrl_tpu_torch.envs.mubs_cov import MultiUbsCoverageEnv
from uav_bs_ctrl_tpu_torch.native import build, env_core

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-6
MAPS = [("debug", 10), ("4ubs", 10), ("8ubs", 6)]


def _episode(env, steps, acts):
    """Reset, move the UBSs onto GTs spread over the map (from a random layout
    most UBSs start out of every GT's range, and the scheduler would have
    nothing to do), then ``steps`` steps of ``acts``' random actions; every
    step's (sched, rates, reward, state)."""
    env.reset()
    env.pos_ubs = env.pos_gts[np.linspace(0, env.n_gts - 1, env.n_ubs).astype(int)] + 10.0
    out = []
    for _ in range(steps):
        _, state, rew, _, _ = env.step(acts.randint(env.n_actions, size=env.n_agents))
        out.append((env.sched.copy(), env.rate_per_gt.copy(), env.rate_per_ubs.copy(),
                    np.asarray(rew).copy(), state.copy()))
    return out


def _assert_same_episode(got, want):
    for t, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g[0], w[0], err_msg=f"sched @t={t}")
        for name, a, b in zip(("rate_gt", "rate_ubs", "reward", "state"), g[1:], w[1:]):
            np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                       rtol=RTOL, atol=0, err_msg=f"{name} @t={t}")
    assert len(got) == len(want)


@pytest.mark.parametrize("map_id,steps", MAPS)
def test_native_core_matches_the_numpy_scheduler(map_id, steps):
    native = MultiUbsCoverageEnv(map_id, record=False, use_native=True,
                                 rng=np.random.RandomState(123))
    plain = MultiUbsCoverageEnv(map_id, record=False, use_native=False,
                                rng=np.random.RandomState(123))
    assert (native.scheduler, plain.scheduler) == ("native", "numpy")
    calls = env_core.calls
    got = _episode(native, steps, np.random.RandomState(5))
    assert env_core.calls - calls == steps + 1          # the reset's service pass, each step
    _assert_same_episode(got, _episode(plain, steps, np.random.RandomState(5)))
    served = [int(s[0].sum()) for s in got]                # links a step
    assert max(served) >= min(native.n_ubs, native.n_gts), served


@pytest.mark.parametrize("map_id,steps", MAPS)
def test_native_env_matches_jax_native_env(map_id, steps):
    np.random.seed(123)
    jax_env = JaxMubs(map_id=map_id, record=False, use_native=True)
    assert jax_env._native is not None, "the JAX package's C++ core did not load"
    env = MultiUbsCoverageEnv(map_id, record=False, use_native=True,
                              rng=np.random.RandomState(123))
    assert env.scheduler == "native"
    got = _episode(env, steps, np.random.RandomState(9))
    _assert_same_episode(got, _episode(jax_env, steps, np.random.RandomState(9)))


def test_core_is_the_ports_own_build():
    assert env_core.available(), env_core.error()
    path = Path(env_core.load()._name).resolve()
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libuavbs-") and path.suffix == ".so"
    assert "uav_bs_ctrl_tpu_torch" in path.parts
    ignored = subprocess.run(["git", "check-ignore", "-q", str(path)], cwd=ROOT)
    assert ignored.returncode == 0, f"{path} is not gitignored"


def test_second_build_reuses_the_hashed_library(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    first = build.build()
    stamp = first.stat().st_mtime_ns
    again = build.build()
    assert again == first and again.stat().st_mtime_ns == stamp
    assert sorted(p.name for p in (tmp_path / "_build").iterdir()) == [first.name]
    monkeypatch.setattr(build, "CXX_FLAGS", build.CXX_FLAGS + ["-DUAVBS_OTHER_FLAGS"])
    other = build.build()
    assert other != first and other.exists() and first.exists()


def test_build_raises_with_the_compilers_error(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(build, "SOURCE", bad)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="failed .* on bad.cpp") as err:
        build.build()
    assert "error" in str(err.value)
    assert not list((tmp_path / "_build").glob("*.so"))


def test_no_compiler_falls_back_to_numpy_with_one_warning(monkeypatch):
    for name, value in (("_LIB", None), ("_ERROR", None), ("_TRIED", False),
                        ("_WARNED", False)):
        monkeypatch.setattr(env_core, name, value)
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", "")
    with pytest.warns(RuntimeWarning, match="NumPy scheduler instead.*no C\\+\\+ compiler"):
        env = MultiUbsCoverageEnv("debug", record=False, rng=np.random.RandomState(0))
    assert env.scheduler == "numpy"
    assert not env_core.available() and "no C++ compiler" in env_core.error()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = MultiUbsCoverageEnv("debug", record=False, rng=np.random.RandomState(0))
    assert again.scheduler == "numpy"
    env.reset()
    env.step(np.zeros(env.n_agents, dtype=int))
    with pytest.raises(RuntimeError, match="unavailable"):
        env_core.schedule_and_rate(env.d_u2g, np.ones_like(env.d_u2g, np.float64),
                                   env.d_u2g <= env.r_cov, env.prior_gts, env.n_rbs,
                                   env.r_cov, env.p_tx, env.bw * env.n0)


def test_cxx_names_the_compiler(monkeypatch):
    monkeypatch.setenv("CXX", "g++")
    assert Path(build.find_cxx()).name == "g++"
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        build.find_cxx()


def test_build_runs_as_a_module():
    out = subprocess.run([sys.executable, "-m", "uav_bs_ctrl_tpu_torch.native.build"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
