"""Recurrent Q-learning core: the scan-BPTT double-Q update (counterpart of
``algos/core.py``).

One update, as the JAX package's jitted ``_update_fn``:

- policy unroll of the agent over T+1 steps from the stored h[0], target
  unroll over the T next observations from the stored h[1], under
  ``torch.no_grad()``, on one of JAX's three schedules (``bptt_encoder``):
  ``per_step`` calls the agent a step at a time; ``hoisted`` encodes every
  step's observation in one batched call per net (the GATv2 kernel #2 then
  runs once per relation for each net, and its backward #3 once per relation)
  and loops over the recurrent ``step`` only; ``merged`` runs policy and
  target in one loop of T+1 steps (the target on obs[t+1] for t < T);
- Q of the taken actions; the next value from the target net at the policy's
  detached argmax (double-Q) or the target's max; QMIX mixes per-agent Q with
  the states at t (policy) and t+1 (target);
- MSE against ``r + gamma (1 - done) V_next``;
- value clip of the **net** gradients to [-1, 1], mixer gradients unclipped
  (the reference clips ``policy_net.parameters()`` only);
- AdamW with betas (0.9, 0.999), eps 1e-8, weight decay 0.01 at
  ``lr * lr_scale``; ``torch.optim.AdamW`` computes optax's ``adamw`` update
  (decoupled decay on the old params, eps added to sqrt(v_hat)), which
  ``tests/test_torch_train.py`` holds against optax;
- Polyak averaging of net and mixer targets.

Mixed precision (``compute_dtype='bfloat16'``, JAX ``core.py:68-76``): the
master params, the mixer, the loss, AdamW and Polyak stay float32. An update
casts the policy's and the target's floating params to bf16 once (a
differentiable cast, so the gradients reach the f32 masters through it), and
the observations and the stored h once; the unrolls run in bf16 with a bf16
h carry, and the Q stacks come back to f32 once. :func:`apply_net` (JAX's
``_apply_net``) runs one forward at the compute dtype for ``act``, the
collection and the test episodes, and returns q and h' in f32.

With ``use_kernels`` (the default) every GATv2 and recurrent step goes through
the kernels' autograd Functions, forward and backward (their bf16
instantiations at bf16); ``False`` takes the unfused module path, the
reference the kernel path is held against.

Each step of both unrolls gets its own key, as JAX's ``_loss_fn`` splits one
a step: when the agent reads one (DiscreteComm's Gumbel noise; the agent's
``noise_shape``), an update draws the noise of every step of both unrolls on
the learner's device from the learner's own generator, seeded with its seed,
and an agent that reads no key leaves the generator untouched. ``backward``
and ``update_on_batch`` also take that noise, so that two paths (or the two
packages) can be given the same draws; every schedule reads the same noise
at the same step.

:meth:`load_checkpoint` resumes a JAX checkpoint as the JAX package's does:
params, mixer, LR scale and the AdamW state. The optax chain's
``ScaleByAdamState(count, mu, nu)`` comes out of the numpy-only unpickler's
stubs (``utils/checkpoint.py:find_state``); ``mu``/``nu`` follow the params'
key mapping into ``exp_avg``/``exp_avg_sq`` and ``count`` becomes every
parameter's ``step``. :meth:`save_checkpoint` writes the same file the other
way round, so either package resumes it.

:func:`parallel.mesh.distribute_learner` shards the update over a device mesh
through ``self.sharding`` (None on one rank): ``backward`` takes this rank's
dp rows of the global batch, :meth:`draw_noise` draws the global batch's
noise and keeps the same rows, the dp group averages the raw gradients and
the metrics before the clip, and AdamW, the clip and Polyak run on the
rank's mp shards (``sharding.masters``), all-gathered into the modules after
the step; :meth:`save_checkpoint` gathers the AdamW moments and rank 0
alone writes the file.

The classic host loop (``algos/madrqn/run.py``, ``algos/drqn/run.py``) acts
with :meth:`init_hidden` and :meth:`act` on one host world, as JAX's
``core.py:121-154``: the observation has no world axis, so :meth:`act` adds
W = 1 for the agent and its kernels and strips it again. Its draws (the
epsilon coin, then the random actions) and :meth:`update`'s replay sample
come from the NumPy stream it is given, the one ``config.set_rand_seed``
returns, in JAX's order; DiscreteComm's Gumbel noise comes from the
learner's generator, where JAX splits its own key.
"""

import copy

import numpy as np
import torch
from torch import nn

from uav_bs_ctrl_tpu_torch.algos.buffer import SequenceReplayBuffer, tree_map
from uav_bs_ctrl_tpu_torch.config import check_training_args
from uav_bs_ctrl_tpu_torch.models.modules import gumbel_draw
from uav_bs_ctrl_tpu_torch.utils import checkpoint as ckpt_io
from uav_bs_ctrl_tpu_torch.utils.convert import learner_params_from_jax, learner_params_to_jax

CLIP_VALUE = 1.0
BETAS, ADAM_EPS, WEIGHT_DECAY = (0.9, 0.999), 1e-8, 0.01
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cast_floating(tree, dtype):
    """The floating leaves of a dict of tensors cast to ``dtype``; masks and
    indices pass through (JAX ``cast_floating``)."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in tree.items()}


def cast_params(net, dtype):
    """``{name: param}`` of ``net`` at ``dtype``, by a differentiable cast."""
    return {name: p.to(dtype) for name, p in net.named_parameters()}


class _Nets(nn.Module):
    """Calls ``fn(**nets)``, so that ``torch.func.functional_call`` can put
    other params into several nets for the span of one call."""

    def __init__(self, fn, nets):
        super().__init__()
        self.fn = fn
        self.nets = nn.ModuleDict(nets)

    def forward(self):
        return self.fn(**self.nets)


def with_params(fn, nets, params):
    """``fn(**nets)`` with each net's parameters replaced by ``params[name]``
    (``{param name: tensor}``), or as they are where that is None."""
    swap = {f"nets.{name}.{k}": v for name, p in params.items() if p is not None
            for k, v in p.items()}
    if not swap:
        return fn(**nets)
    return torch.func.functional_call(_Nets(fn, nets), swap, ())


def apply_net(net, obs, h, use_kernels=True, key=None, dtype=torch.float32):
    """One forward of ``net`` at ``dtype`` (JAX ``_apply_net``): at bf16 on
    bf16 copies of its params, obs and h; q and h' are returned in f32."""
    if dtype == torch.float32:
        return net(obs, h, use_kernels, key)
    q, h2 = with_params(lambda net: net(cast_floating(obs, dtype), h.to(dtype), use_kernels,
                                        key), {"net": net}, {"net": cast_params(net, dtype)})
    return q.float(), h2.float()


class RecurrentQLearner:
    """Shared core for the recurrent Q-learners (MADRQN with mixer/double-Q)."""

    def __init__(self, env_info, args, agent, mixer=None, seed=0):
        check_training_args(args)
        self.device = args.device
        self.n_agents = env_info.get("n_agents", 1)
        self.n_actions = env_info["n_actions"]
        self.noise_generator = torch.Generator(device=self.device).manual_seed(seed)
        self.max_seq_len = (args.max_seq_len if args.max_seq_len is not None
                            else env_info["episode_limit"])
        self.gamma = args.gamma
        self.polyak = args.polyak
        self.batch_size = args.batch_size
        self.double_q = bool(args.double_q)
        self.share_reward = bool(args.share_reward)
        self.compute_dtype = COMPUTE_DTYPES[getattr(args, "compute_dtype", "float32")]
        self.bptt_encoder = getattr(args, "bptt_encoder", "per_step")

        self.net = agent.to(self.device)
        self.mixer = None if mixer is None else mixer.to(self.device)
        self.target_net = copy.deepcopy(self.net).requires_grad_(False)
        self.target_mixer = (None if mixer is None
                             else copy.deepcopy(self.mixer).requires_grad_(False))

        self.buffer = SequenceReplayBuffer(args.replay_size, self.max_seq_len)
        self.lr = args.lr
        self.anneal_lr = bool(args.anneal_lr)
        self.lr_scale = 1.0
        self._epoch = 0
        self.optimizer = self._make_optimizer()
        self._update_lr = np.float32(self.lr)   # the last update's, as optax's state holds it
        self.sharding = None                    # parallel.mesh.LearnerSharding

    def _make_optimizer(self, params=None):
        return torch.optim.AdamW(self.parameters() if params is None else params, lr=self.lr,
                                 betas=BETAS, eps=ADAM_EPS, weight_decay=WEIGHT_DECAY)

    def parameters(self):
        """Net then mixer parameters: what AdamW updates."""
        mixer = [] if self.mixer is None else list(self.mixer.parameters())
        return list(self.net.parameters()) + mixer

    def target_parameters(self):
        mixer = [] if self.target_mixer is None else list(self.target_mixer.parameters())
        return list(self.target_net.parameters()) + mixer

    # ------------------------------------------------------------------ #
    # Acting (the classic host loop)

    def init_hidden(self, batch_size=1):
        """Zero hidden states: ``[n_agents, hidden]`` for one world (JAX's shape)."""
        h = np.zeros((self.n_agents * batch_size, self.net.hidden), dtype=np.float32)
        return h.reshape(batch_size, self.n_agents, -1).squeeze(0) if batch_size == 1 else h

    @torch.no_grad()
    def act(self, obs, h, eps_thres, rng=None):
        """Joint epsilon-greedy actions of one host world (reference quirk 3):
        ``(actions list, h' [n_agents, hidden])``. The greedy actions and h'
        come from the policy on ``obs``/``h`` (no world axis); then one coin
        ``rng.random()`` (``rng`` default ``np.random``, as JAX) keeps them
        when above ``eps_thres``, else ``rng.randint`` draws every agent's."""
        rng = np.random if rng is None else rng
        obs = {k: torch.tensor(np.asarray(v))[None].to(self.device) for k, v in obs.items()}
        h = torch.tensor(np.asarray(h, np.float32))[None].to(self.device)
        shape = self.net.noise_shape((1,), self.n_agents)
        key = None if shape is None else gumbel_draw(shape, self.noise_generator, self.device)
        q, h2 = self._act_q(obs, h, key)
        greedy, h2 = q[0].argmax(-1).cpu().numpy(), h2[0].cpu().numpy()
        if rng.random() > eps_thres:
            acts = greedy
        else:
            acts = rng.randint(self.n_actions, size=(self.n_agents,))
        return acts.tolist(), h2

    def _act_q(self, obs, h, key):
        """The policy's ``(Q, h')`` on one step of W = 1 worlds, through the kernels."""
        return self._apply_net(obs, h, True, key)

    def _apply_net(self, obs, h, use_kernels=True, key=None):
        """The policy's ``(q, h')`` at the compute dtype, in f32 (JAX
        ``_apply_net``): what ``act``, the collection and the test episodes run."""
        return apply_net(self.net, obs, h, use_kernels, key, self.compute_dtype)

    # ------------------------------------------------------------------ #
    # Experience

    def cache(self, obs, h, state, act, rew, next_obs, next_h, next_state, done, bad_mask):
        """Push one host transition (the classic host-loop path)."""
        rew = np.asarray(rew, dtype=np.float32).reshape(-1)
        if self.share_reward:
            rew = rew.mean(keepdims=True)
        transition = dict(
            obs=obs, h=np.asarray(h, np.float32),
            act=np.asarray(act, np.int32).reshape(-1), rew=rew,
            done=np.float32((1 - bad_mask) * done),
            next_obs=next_obs, next_h=np.asarray((1 - done) * next_h, np.float32))
        if state is not None:
            transition["state"] = np.asarray(state, np.float32)
            transition["next_state"] = np.asarray(next_state, np.float32)
        self.buffer.push(transition)

    # ------------------------------------------------------------------ #
    # Update

    # The three BPTT schedules (JAX ``core.py:194-283``): each returns the
    # policy's Q [B, T+1, A, n_act] and the target's [B, T, A, n_act], and
    # feeds step t of each unroll the noise of step t. The policy's step T
    # feeds only the detached double-Q argmax, so it is detached: autograd
    # runs T backward steps, not T+1.

    @staticmethod
    def _step_obs(obs, t):
        return {k: v[:, t] for k, v in obs.items()}

    @staticmethod
    def _stack_pol(qs):
        return torch.stack(qs[:-1] + [qs[-1].detach()], 1)

    def _per_step(self, pol, targ, obs, h0, h_targ0, use_kernels, noise):
        T = self.max_seq_len

        def unroll(net, h, t0, n_steps, steps_noise):
            qs = []
            for i in range(n_steps):
                key = None if steps_noise is None else steps_noise[i]
                q, h = net(self._step_obs(obs, t0 + i), h, use_kernels, key)
                qs.append(q)
            return qs

        q_pol = self._stack_pol(unroll(pol, h0, 0, T + 1, noise["pol"]))
        with torch.no_grad():
            return q_pol, torch.stack(unroll(targ, h_targ0, 1, T, noise["targ"]), 1)

    def _hoisted(self, pol, targ, obs, h0, h_targ0, use_kernels, noise):
        """One ``encode`` of every step per net ([B, T+1] and [B, T] lead
        dims through the encoder), then a loop over ``step`` only."""
        T = self.max_seq_len
        adj = obs.get("adj")

        def unroll(net, x, h, t0, steps_noise):
            qs = []
            for i in range(x.shape[1]):
                key = None if steps_noise is None else steps_noise[i]
                q, h = net.step(x[:, i], None if adj is None else adj[:, t0 + i], h,
                                use_kernels, key)
                qs.append(q)
            return qs

        q_pol = self._stack_pol(unroll(pol, pol.encode(obs, use_kernels), h0, 0, noise["pol"]))
        with torch.no_grad():
            x_targ = targ.encode({k: v[:, 1:] for k, v in obs.items()}, use_kernels)
            return q_pol, torch.stack(unroll(targ, x_targ, h_targ0, 1, noise["targ"]), 1)

    def _merged(self, pol, targ, obs, h0, h_targ0, use_kernels, noise):
        """Policy and target in one loop of T+1 steps: at step t the policy
        reads obs[t] and, for t < T, the target obs[t+1]. JAX merges them to
        halve its scan's sequential steps; eager PyTorch makes the same
        launches as ``per_step`` here, and the schedule exists so that a
        configuration naming it trains. Its outputs and noise are the
        two-loop schedule's."""
        T = self.max_seq_len
        q_pol, q_targ = [], []
        h, h_targ = h0, h_targ0
        for t in range(T + 1):
            key = None if noise["pol"] is None else noise["pol"][t]
            q, h = pol(self._step_obs(obs, t), h, use_kernels, key)
            q_pol.append(q)
            if t < T:
                key = None if noise["targ"] is None else noise["targ"][t]
                with torch.no_grad():
                    q, h_targ = targ(self._step_obs(obs, t + 1), h_targ, use_kernels, key)
                q_targ.append(q)
        return self._stack_pol(q_pol), torch.stack(q_targ, 1)

    def draw_noise(self, batch):
        """The per-step noise of one update on ``batch``: ``{"pol": [T+1, ...],
        "targ": [T, ...]}`` drawn from the learner's generator, or None (and
        nothing drawn) when the agent reads no key. A sharded learner draws
        the global batch's noise and keeps its own rows."""
        b, _, a = batch["h"].shape[:3]
        lo, hi = 0, b
        if self.sharding is not None:
            lo, hi, b = self.sharding.rows(b)
        shape = self.net.noise_shape((b,), a)
        if shape is None:
            return None
        T = self.max_seq_len
        return {name: gumbel_draw((n,) + shape, self.noise_generator, self.device)[:, lo:hi]
                for name, n in (("pol", T + 1), ("targ", T))}

    def _loss(self, batch, use_kernels, noise):
        """``(loss, qvals)`` for a batch-major batch (leaves [B, T(+1), ...])."""
        cdt = self.compute_dtype
        obs = cast_floating(batch["obs"], cdt)
        h0, h_targ0 = batch["h"][:, 0].to(cdt), batch["h"][:, 1].to(cdt)
        noise = {"pol": None, "targ": None} if noise is None else noise
        unrolls = {"per_step": self._per_step, "hoisted": self._hoisted,
                   "merged": self._merged}[self.bptt_encoder]

        def run(pol, targ):
            return unrolls(pol, targ, obs, h0, h_targ0, use_kernels, noise)

        params = {"pol": None, "targ": None}
        if cdt != torch.float32:            # cast once per update (JAX core.py:190-192)
            params["pol"] = cast_params(self.net, cdt)
            with torch.no_grad():
                params["targ"] = cast_params(self.target_net, cdt)
        q_pol, target_out = with_params(run, {"pol": self.net, "targ": self.target_net},
                                        params)
        # The Q stacks come back to the masters' dtype (f32) once.
        master = self.parameters()[0].dtype
        q_pol, target_out = q_pol.to(master), target_out.to(master)    # [B, T+1|T, A, n_act]
        T = self.max_seq_len
        acts = batch["act"].long()[..., None]                          # [B, T, A, 1]
        qvals = q_pol[:, :T].gather(-1, acts)[..., 0]                  # [B, T, A]
        if self.double_q:
            next_acts = q_pol[:, 1:].detach().argmax(-1, keepdim=True)
            next_vals = target_out.gather(-1, next_acts)[..., 0]
        else:
            next_vals = target_out.amax(-1)
        if self.mixer is not None:
            states = batch["state"]
            qvals = self.mixer(qvals, states[:, :T])                   # [B, T, 1]
            with torch.no_grad():
                next_vals = self.target_mixer(next_vals, states[:, 1:])
        target_q = batch["rew"] + self.gamma * (1.0 - batch["done"][..., None]) * next_vals
        loss = torch.mean(torch.square(qvals - target_q.broadcast_to(qvals.shape)))
        return loss, qvals

    def update_on_batch(self, batch, use_kernels=True, noise=None):
        """One update from a batch on the device; returns ``{LossQ, QVals}`` as
        0-d tensors (no host sync). The clipped gradients stay in ``.grad``.
        ``noise`` is :meth:`draw_noise`'s, drawn here when not given."""
        metrics = self.backward(batch, use_kernels, noise)
        self.apply_grads()
        return metrics

    def backward(self, batch, use_kernels=True, noise=None):
        """The loss and its raw gradients in ``.grad`` (no clip, no step); a
        sharded learner's are the dp means (``batch`` holds this rank's rows)."""
        if noise is None:
            noise = self.draw_noise(batch)
        for p in self.parameters():       # the optimizer's may be a sharding's masters
            p.grad = None
        loss, qvals = self._loss(batch, use_kernels, noise)
        loss.backward()
        metrics = dict(LossQ=loss.detach(), QVals=qvals.detach().mean())
        return metrics if self.sharding is None else self.sharding.reduce(metrics)

    def apply_grads(self):
        """Clip the net's ``.grad`` to [-1, 1], step AdamW at ``lr * lr_scale``
        and Polyak-average the targets (a sharded learner: its shards, then
        gathered into the modules)."""
        for p in self.parameters():       # optax updates (and decays) every leaf
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        params, targets = self.parameters(), self.target_parameters()
        n_net = len(list(self.net.parameters()))
        if self.sharding is not None:
            self.sharding.take_grads()
            params, targets = self.sharding.masters, self.sharding.target_masters
        torch.nn.utils.clip_grad_value_(params[:n_net], CLIP_VALUE)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr * self.lr_scale
        self.optimizer.step()
        self._update_lr = np.float32(self.lr) * np.float32(self.lr_scale)  # f32, as JAX
        with torch.no_grad():
            for t, p in zip(targets, params):
                t.mul_(self.polyak).add_(p, alpha=1.0 - self.polyak)
        if self.sharding is not None:
            self.sharding.gather()

    def update(self, rng=None):
        """One update from a host-buffer sample (without replacement, drawn
        from ``rng``, default ``np.random`` as JAX)."""
        if len(self.buffer) < self.batch_size:
            raise RuntimeError("insufficient samples for an update")
        batch = tree_map(lambda x: torch.as_tensor(x, device=self.device),
                         self.buffer.sample(self.batch_size, rng))
        return {k: float(v) for k, v in self.update_on_batch(batch).items()}

    def step_lr_scheduler(self):
        """Epoch-stepped LambdaLR: scale = max(0.4, 1 - epoch/100)."""
        self._epoch += 1
        if self.anneal_lr:
            self.lr_scale = max(0.4, 1.0 - self._epoch / 100)

    # ------------------------------------------------------------------ #
    # State

    def _unsharded(self, what):
        """Raise for ``what`` on a learner whose state is split over mp (a dp
        sharding keeps the module params as AdamW's)."""
        if self.sharding is not None and any(self.sharding.sliced):
            raise RuntimeError(f"{what} on a learner sharded over mp: its params and "
                               "AdamW state are shards (save_checkpoint gathers them)")

    def state_dict(self) -> dict:
        """A deep copy of everything an update reads and writes."""
        self._unsharded("state_dict")
        modules = dict(net=self.net, target_net=self.target_net)
        if self.mixer is not None:
            modules.update(mixer=self.mixer, target_mixer=self.target_mixer)
        state = {k: m.state_dict() for k, m in modules.items()}
        state.update(optimizer=self.optimizer.state_dict(), lr_scale=self.lr_scale,
                     epoch=self._epoch, update_lr=self._update_lr,
                     noise_generator=self.noise_generator.get_state())
        return copy.deepcopy(state)

    def load_state_dict(self, state: dict):
        self._unsharded("load_state_dict")
        state = copy.deepcopy(state)
        for name in ("net", "target_net", "mixer", "target_mixer"):
            if name in state:
                getattr(self, name).load_state_dict(state[name])
        self.optimizer.load_state_dict(state["optimizer"])
        self.lr_scale, self._epoch = state["lr_scale"], state["epoch"]
        self._update_lr = state["update_lr"]
        self.noise_generator.set_state(state["noise_generator"])

    def load_params(self, tree):
        """Net (and mixer) from a JAX learner tree ``{"net": ..., "mixer": ...}``;
        targets become copies and AdamW starts afresh (as optax's ``init``).
        A learner sharded over mp loads before ``distribute_learner``."""
        self._unsharded("load_params")
        loaded = learner_params_from_jax(tree, self.net, self.mixer)
        self.net.load_state_dict(loaded["net"])
        self.target_net.load_state_dict(loaded["net"])
        if self.mixer is not None:
            self.mixer.load_state_dict(loaded["mixer"])
            self.target_mixer.load_state_dict(loaded["mixer"])
        self.optimizer = self._make_optimizer()
        self._update_lr = np.float32(self.lr)

    def load_adam_state(self, count, mu, nu):
        """AdamW's state from optax's ``ScaleByAdamState``: ``mu``/``nu`` trees
        ``{"net": ...[, "mixer": ...]}`` carried by the params' key mapping,
        ``count`` as every parameter's step."""
        moments = [learner_params_from_jax(tree, self.net, self.mixer) for tree in (mu, nu)]
        step = torch.tensor(float(count), dtype=torch.float32)
        for group, params in self._by_group(lambda p: p).items():
            for name, p in params.items():
                self.optimizer.state[p] = {
                    "step": step.clone(),
                    "exp_avg": moments[0][group][name].to(p.device),
                    "exp_avg_sq": moments[1][group][name].to(p.device)}

    def _by_group(self, leaf):
        """``{"net": {name: leaf(p)}[, "mixer": ...]}`` over the parameters."""
        groups = {"net": self.net, "mixer": self.mixer}
        return {group: {name: leaf(p) for name, p in module.named_parameters()}
                for group, module in groups.items() if module is not None}

    def adam_state(self):
        """optax's ``inject_hyperparams(adamw)`` state from AdamW's, the inverse
        of :meth:`load_adam_state`: one ``count`` (int32) in both places, ``mu``
        and ``nu`` trees keyed as the params, the hyperparams as float32 0-d
        arrays with the learning rate of the last update (optax writes it into
        its state at each update; a fresh or loaded state holds its own)."""
        state = (self.optimizer.state if self.sharding is None
                 else self.sharding.full_adam_state(self.optimizer))
        steps = {float(state[p]["step"]) if p in state else 0.0 for p in self.parameters()}
        if len(steps) != 1:
            raise ValueError(f"AdamW's parameters are at different steps {sorted(steps)}; "
                             "optax keeps one count")
        count = np.int32(steps.pop())
        moment = lambda key: learner_params_to_jax(self._by_group(
            lambda p: state[p][key] if p in state else torch.zeros_like(p)))
        group = self.optimizer.param_groups[0]
        (b1, b2), f32 = group["betas"], lambda x: np.asarray(x, np.float32)
        hyperparams = dict(b1=f32(b1), b2=f32(b2), eps=f32(group["eps"]), eps_root=f32(0.0),
                           learning_rate=f32(self._update_lr),
                           weight_decay=f32(group["weight_decay"]))
        adam = ckpt_io.ScaleByAdamState(count, moment("exp_avg"), moment("exp_avg_sq"))
        return ckpt_io.InjectStatefulHyperparamsState(
            count, hyperparams, {}, (adam, ckpt_io.EmptyState(), ckpt_io.EmptyState()))

    def save_checkpoint(self, path, stamp):
        """The JAX ``save_checkpoint``: ``stamp`` (``epoch``, ``t``), net,
        mixer, optax's AdamW state and, with ``anneal_lr``, the LR scheduler's
        ``{epoch, lr_scale}``, as numpy leaves in the JAX layout. On a
        sharded learner every rank calls it (the moments are gathered) and
        rank 0 alone writes."""
        params = learner_params_to_jax(self._by_group(lambda p: p))
        checkpoint = dict(stamp)
        checkpoint["model_state_dict"] = params["net"]
        checkpoint["optimizer_state_dict"] = self.adam_state()
        if self.mixer is not None:
            checkpoint["mixer_state_dict"] = params["mixer"]
        if self.anneal_lr:
            checkpoint["lr_scheduler_state_dict"] = dict(epoch=self._epoch,
                                                         lr_scale=self.lr_scale)
        if self.sharding is not None and self.sharding.rank != 0:
            return
        ckpt_io.save(path, checkpoint)
        print(f"Save checkpoint to {path}.")

    def load_checkpoint(self, path):
        """The JAX ``load_checkpoint``: net, mixer, AdamW state, LR scale;
        returns the ``{epoch, t}`` stamp."""
        ckpt = ckpt_io.load(path)
        tree = {"net": ckpt["model_state_dict"]}
        if self.mixer is not None:
            tree["mixer"] = ckpt["mixer_state_dict"]
        self.load_params(tree)
        adam = ckpt_io.find_state(ckpt["optimizer_state_dict"], "ScaleByAdamState")
        self.load_adam_state(*adam.args)
        inject = ckpt_io.find_state(ckpt["optimizer_state_dict"],
                                    "InjectStatefulHyperparamsState")
        self._update_lr = np.float32(inject.args[1]["learning_rate"])
        if self.anneal_lr and "lr_scheduler_state_dict" in ckpt:
            self._epoch = int(ckpt["lr_scheduler_state_dict"]["epoch"])
            self.lr_scale = float(ckpt["lr_scheduler_state_dict"]["lr_scale"])
        print(f"Load checkpoint from {path}.")
        return dict(epoch=int(ckpt["epoch"]), t=int(ckpt["t"]))
