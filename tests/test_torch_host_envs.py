"""The port's host NumPy envs, recorders and wrappers against the JAX package's.

- ``MultiUbsCoverageEnv`` on ``debug``, ``4ubs`` and ``r400`` and
  ``SingleUbsCoverageEnv`` on exp1's 2 x 5 and 4 x 5: a whole episode of
  random actions from the same seed (the port's ``RandomState(seed)``
  against JAX's ``np.random.seed(seed)``), every obs, state, reward and info
  exactly equal. Both are the same NumPy code, so no tie rule is needed.
  The JAX env runs its NumPy scheduler and, with ``use_native``, its C++ core
  where that library is built (else it falls back to NumPy itself); so does
  the port's, with its own build of the core (``tests/test_torch_native.py``).
- The maps' and ``set_position``'s ``rng`` draws equal ``np.random``'s.
- The recorders' CSVs, byte for byte, and as pandas reads them back.
- The wrappers' obs dicts and env info for ``o='mlp'``, ``o='gnn'`` with and
  without ``adj``, and the exp1 ``rnn``/``gnn`` agents; the host flat
  observation equals the fused trainer's ``flatten_obs`` of the same state.
- ``ZFilter`` on the same stream.
"""

from types import SimpleNamespace as SN

import numpy as np
import pandas as pd
import pytest
import torch

from uav_bs_ctrl_tpu.algos.drqn.wrappers import make_env as jax_make_drqn_env
from uav_bs_ctrl_tpu.algos.madrqn.wrappers import make_env as jax_make_env
from uav_bs_ctrl_tpu.envs.maps import MAPS as JAX_MAPS
from uav_bs_ctrl_tpu.envs.mubs_cov import MultiUbsCoverageEnv as JaxMubs
from uav_bs_ctrl_tpu.envs.subs_cov import SingleUbsCoverageEnv as JaxSubs
from uav_bs_ctrl_tpu.utils.reward_normalizer import ZFilter as JaxZFilter
from uav_bs_ctrl_tpu_torch.algos import collect, collect_subs
from uav_bs_ctrl_tpu_torch.algos.drqn.wrappers import make_env as make_drqn_env
from uav_bs_ctrl_tpu_torch.algos.madrqn.wrappers import make_env
from uav_bs_ctrl_tpu_torch.envs import REGISTRY, torch_env, torch_env_subs
from uav_bs_ctrl_tpu_torch.envs.maps import MAPS
from uav_bs_ctrl_tpu_torch.envs.mubs_cov import MultiUbsCoverageEnv
from uav_bs_ctrl_tpu_torch.envs.subs_cov import SingleUbsCoverageEnv
from uav_bs_ctrl_tpu_torch.utils.reward_normalizer import ZFilter

EXP1_ENVS = {"2x5": dict(n_grps=2, gts_per_grp=5), "4x5": dict(n_grps=4, gts_per_grp=5)}


def _equal(a, b, what, rtol=None):
    """Equality of two values of the envs' outputs (dicts, lists, arrays,
    scalars): exact, with the same types and dtypes; with ``rtol``, the values
    within it and the types free (the JAX env's C++ core returns float64 rates
    where its NumPy scheduler returns float32)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _equal(a[k], b[k], f"{what}[{k}]", rtol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]", rtol)
    elif rtol is not None:
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=rtol, atol=1e-12, err_msg=what)
    else:
        assert type(a) is type(b), f"{what}: {type(a)} against {type(b)}"
        np.testing.assert_array_equal(a, b, err_msg=what)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, what


def test_registry_names_both_envs():
    assert REGISTRY == {"SingleUbsCoverageEnv": SingleUbsCoverageEnv,
                        "MultiUbsCoverageEnv": MultiUbsCoverageEnv}


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("map_id", ["debug", "4ubs", "r400"])
def test_multi_ubs_episode_matches_jax(map_id, use_native):
    """Exact against JAX's NumPy scheduler; against its C++ core (where built)
    within the 1e-6 that ``tests/test_native.py`` holds that core to, the
    schedules exactly equal."""
    np.random.seed(7)
    jax_env = JaxMubs(map_id, use_native=use_native)
    env = MultiUbsCoverageEnv(map_id, use_native=use_native, rng=np.random.RandomState(7))
    rtol = 1e-6 if jax_env._native is not None else None
    _equal(env.reset(), jax_env.reset(), "reset", rtol)
    acts = np.random.RandomState(11)
    done = False
    while not done:
        a = acts.randint(env.n_actions, size=env.n_agents)
        got, want = env.step(a), jax_env.step(a)
        _equal(got, want, f"step {env.t}", rtol)
        for name in ("sched", "adj", "mask_collision", "prior_gts"):
            _equal(getattr(env, name), getattr(jax_env, name), name)
        _equal(env.rate_per_ubs, jax_env.rate_per_ubs, "rate_per_ubs", rtol)
        done = got[3]
    assert env.t == env.episode_limit
    # Both streams stand at the same draw.
    assert env.rng.random() == np.random.random()


@pytest.mark.parametrize("shape", sorted(EXP1_ENVS))
def test_single_ubs_episode_matches_jax(shape):
    np.random.seed(3)
    jax_env = JaxSubs(**EXP1_ENVS[shape])
    env = SingleUbsCoverageEnv(**EXP1_ENVS[shape], rng=np.random.RandomState(3))
    for episode in range(2):
        _equal(env.reset(), jax_env.reset(), f"reset {episode}")
        done = False
        while not done:
            a = int(np.random.randint(env.n_actions))   # the shared stream, after the layout
            env.rng.randint(env.n_actions)              # the port's, kept in step
            got, want = env.step(a), jax_env.step(a)
            _equal(got, want, f"episode {episode} step {env.t}")
            done = got[2]
        assert env.t == 200
        _equal(env.recorder.film, jax_env.recorder.film, "film")


@pytest.mark.parametrize("map_id", sorted(MAPS))
def test_map_layouts_from_an_rng_match_jax(map_id):
    rng = np.random.RandomState(5)
    np.random.seed(5)
    for _ in range(3):
        _equal(MAPS[map_id].set_positions(rng), JAX_MAPS[map_id].set_positions(), map_id)
    # Without an rng the port's maps still draw from np.random, as before.
    np.random.seed(6)
    want = JAX_MAPS[map_id].set_positions()
    np.random.seed(6)
    _equal(MAPS[map_id].set_positions(), want, map_id)


def test_set_position_from_an_rng_matches_np_random():
    params = torch_env_subs.make_params(n_grps=4, gts_per_grp=5)
    np.random.seed(9)
    want = [torch_env_subs.set_position(params) for _ in range(3)]
    rng = np.random.RandomState(9)
    _equal([torch_env_subs.set_position(params, rng) for _ in range(3)], want, "set_position")


def _csvs(save_dir):
    return {name: (save_dir / name).read_text()
            for name in ("path_ubs.csv", "pos_gts.csv", "others.csv")}


@pytest.mark.parametrize("env_name", ["4ubs", "debug", "exp1"])
def test_recorder_csvs_match_jax_byte_for_byte(tmp_path, env_name):
    """An episode of each recorder; the JAX recorder writes its CSVs with
    pandas (and a figure), the port's with the ``csv`` module."""
    np.random.seed(1)
    if env_name == "exp1":
        jax_env = JaxSubs(n_grps=2, gts_per_grp=5, episode_limit=12)
        env = SingleUbsCoverageEnv(n_grps=2, gts_per_grp=5, episode_limit=12,
                                   rng=np.random.RandomState(1))
        n_agents = None
    else:
        jax_env, env = JaxMubs(env_name), MultiUbsCoverageEnv(env_name,
                                                             rng=np.random.RandomState(1))
        n_agents = env.n_agents
    env.reset(), jax_env.reset()
    acts = np.random.RandomState(2)
    for _ in range(env.episode_limit):
        a = acts.randint(env.n_actions, size=n_agents)
        env.step(a), jax_env.step(a)
    env.replay(save_dir=str(tmp_path / "port"))
    jax_env.replay(save_dir=str(tmp_path / "jax"))
    got, want = _csvs(tmp_path / "port"), _csvs(tmp_path / "jax")
    assert got == want
    assert not (tmp_path / "port" / "trajectories.png").exists()
    path = pd.read_csv(tmp_path / "port" / "path_ubs.csv", header=[0, 1, 2], index_col=0)
    assert path.shape == (env.episode_limit + 1, 2 * (n_agents or 1))
    pd.testing.assert_frame_equal(
        path, pd.read_csv(tmp_path / "jax" / "path_ubs.csv", header=[0, 1, 2], index_col=0))
    for name in ("pos_gts.csv", "others.csv"):
        if env_name != "exp1" and name == "others.csv":
            assert got[name] == '""\n'                   # an empty frame
            continue
        pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "port" / name, index_col=0),
                                      pd.read_csv(tmp_path / "jax" / name, index_col=0))


WRAPPER_ARGS = {
    "mlp": dict(o="mlp", c=None, share_reward=False, norm_r=True),
    "mlp_tarmac": dict(o="mlp", c="tarmac", share_reward=True, norm_r=True),
    "gnn": dict(o="gnn", c=None, share_reward=False, norm_r=False),
    "gnn_tarmac": dict(o="gnn", c="tarmac", share_reward=False, norm_r=True),
}


@pytest.mark.parametrize("map_id", ["debug", "r400"])
@pytest.mark.parametrize("kind", sorted(WRAPPER_ARGS))
def test_madrqn_wrapper_obs_match_jax(map_id, kind):
    args = SN(**WRAPPER_ARGS[kind])
    np.random.seed(4)
    jax_env = jax_make_env(lambda: JaxMubs(map_id, record=False), args)
    env = make_env(lambda: MultiUbsCoverageEnv(map_id, record=False,
                                               rng=np.random.RandomState(4)), args)
    assert env.get_env_info() == jax_env.get_env_info()
    got, want = env.reset(), jax_env.reset()
    _equal(got, want, "reset")
    assert ("adj" in got[0]) == (args.c is not None)
    for t in range(5):
        a = [t % env.n_actions] * env.n_agents
        _equal(env.step(a), jax_env.step(a), f"step {t}")


@pytest.mark.parametrize("shape", sorted(EXP1_ENVS))
@pytest.mark.parametrize("agent", ["rnn", "gnn"])
def test_drqn_wrapper_obs_match_jax(agent, shape):
    args = SN(agent=agent)
    np.random.seed(8)
    jax_env = jax_make_drqn_env(lambda: JaxSubs(**EXP1_ENVS[shape], record=False), args)
    env = make_drqn_env(lambda: SingleUbsCoverageEnv(**EXP1_ENVS[shape], record=False,
                                                     rng=np.random.RandomState(8)), args)
    assert env.get_env_info() == jax_env.get_env_info()
    _equal(env.reset(), jax_env.reset(), "reset")
    for t in range(5):
        _equal(env.step(t % env.n_actions), jax_env.step(t % env.n_actions), f"step {t}")


@pytest.mark.parametrize("map_id", ["debug", "4ubs", "r400"])
def test_host_flat_obs_equals_the_fused_trainers_flatten_obs(map_id):
    """A run trained by either path serves on the other: the host
    ``FlattenedObservation`` (gym's sorted keys agent, gt, ubs) and the
    fused trainer's ``flatten_obs`` give the same vector on the same state."""
    env = make_env(lambda: MultiUbsCoverageEnv(map_id, record=False,
                                               rng=np.random.RandomState(2)),
                   SN(o="mlp", c="tarmac", share_reward=False, norm_r=False))
    obs, _ = env.reset()
    for t in range(3):
        obs, *_ = env.step([(t + i) % env.n_actions for i in range(env.n_agents)])
    base = env.unwrapped
    params = torch_env.make_params(map_id)
    state = torch_env.reset_from_positions(
        params, torch.from_numpy(base.pos_ubs[None].astype(np.float32)),
        torch.from_numpy(base.pos_gts[None].astype(np.float32)),
        torch.from_numpy(np.argsort(base.avg_rate_per_gt, kind="stable")[None]))
    # Carry the host env's service statistics over, then read the obs.
    state = state._replace(
        rate_per_gt=torch.from_numpy(base.rate_per_gt[None]),
        avg_rate_per_gt=torch.from_numpy(base.avg_rate_per_gt[None].astype(np.float32)))
    flat = collect.flatten_obs(torch_env.get_obs(params, state))
    np.testing.assert_allclose(flat["agent"][0].numpy(), obs["agent"], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(flat["adj"][0].numpy(), obs["adj"])


def test_host_flat_obs_equals_collect_subs_flatten_obs():
    env = make_drqn_env(lambda: SingleUbsCoverageEnv(n_grps=4, gts_per_grp=5, record=False,
                                                     rng=np.random.RandomState(3)),
                        SN(agent="rnn"))
    genv = make_drqn_env(lambda: SingleUbsCoverageEnv(n_grps=4, gts_per_grp=5, record=False,
                                                      rng=np.random.RandomState(3)),
                         SN(agent="gnn"))
    for obs, gobs in [(env.reset(), genv.reset())] + [
            (env.step(a)[0], genv.step(a)[0]) for a in (1, 2, 3)]:
        graph = {k: torch.from_numpy(v[None]) for k, v in gobs.items()}
        np.testing.assert_array_equal(collect_subs.flatten_obs(graph)["agent"][0].numpy(),
                                      obs["agent"])


def test_zfilter_matches_jax():
    rng = np.random.default_rng(0)
    port, jax_filter = ZFilter((1, 4), clip=10), JaxZFilter((1, 4), clip=10)
    for _ in range(20):
        x = rng.normal(size=(1, 4)).astype(np.float32) * 5
        np.testing.assert_array_equal(port(x), jax_filter(x))
    np.testing.assert_array_equal(port.rs.std, jax_filter.rs.std)
