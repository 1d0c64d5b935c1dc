"""The port's RL library (``ray_tpu_torch.rl``) on the CPU: the twelve cases
of ``tests/test_rl.py`` on a module-scoped cluster of the port's own
(``ray_tpu_torch.init(num_cpus=4)``, learners on ``"cpu"``, gangs on gloo;
the four learning tests keep the reference's ``slow`` mark), and parity
with the JAX package on the same seeded numpy inputs:

* every ``apply_*`` at batch 2, including 84x84x4 frames (uint8 and
  float), where XLA's SAME padding is asymmetric (conv 2 pads (1, 2));
  f32, within 1e-5 of the largest reference value;
* one and three updates of PPO, DQN (MLP, and the CNN at 84x84x4, with a
  target sync after update 2) and IMPALA from ``params_from_jax`` params,
  against the JAX update builders (``PPO._make_update`` and
  ``DQN._make_update`` on a stand-in carrying what they read): each
  update's stats within 1e-4 relative, params within 5% of ``lr``
  absolute. Adam moves each weight by about ``lr`` a step, so a sign or
  scale error shows at 100% and more; a weight whose gradient is near
  Adam's eps (1e-8) takes a step ``lr * g / (|g| + eps)`` that f32
  summation order moves by a few percent of ``lr`` (2.3% seen in the
  CNN's third update, whose q_mean then differs by 2.7e-5 relative);
* V-trace targets against the JAX ``vtrace`` within 1e-6;
* the port's ``_EnvRunner`` against the JAX ``_EnvRunner``, both in this
  process, with the same params and seed: actions, observations, rewards
  and dones equal, log-probabilities and values within 1e-6.
"""

import os
import subprocess
import sys
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.rl import dqn as jdqn
from ray_tpu.rl import env_runner as jrunner
from ray_tpu.rl import impala as jimpala
from ray_tpu.rl import models as jm
from ray_tpu.rl import ppo as jppo
from ray_tpu_torch.rl import PPO, PPOConfig
from ray_tpu_torch.rl import dqn as tdqn
from ray_tpu_torch.rl import env_runner as trunner
from ray_tpu_torch.rl import impala as timpala
from ray_tpu_torch.rl import models as tm
from ray_tpu_torch.rl import utils as tutils
from ray_tpu_torch.util.reaper import find_runtime_pids

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent

APPLY_REL = 1e-5
STATS_RTOL, PARAMS_LR_FRACTION = 1e-4, 0.05
VTRACE_TOL = 1e-6
RUNNER_TOL = 1e-6


@pytest.fixture(scope="module")
def cluster():
    # one torch thread in each of the cluster's processes, as in this one
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        rt.init(num_cpus=4)
        try:
            yield
        finally:
            rt.shutdown()
    deadline = time.monotonic() + 10
    while find_runtime_pids(spawner_pid=os.getpid()) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert find_runtime_pids(spawner_pid=os.getpid()) == []


# ---------------------------------------------------------------------------
# the reference's cases


def test_gae_matches_closed_form():
    """GAE on a 1-env, no-done rollout vs the textbook recursion."""
    T = 5
    rollout = {
        "rewards": np.ones((T, 1), np.float32),
        "values": np.zeros((T, 1), np.float32),
        "dones": np.zeros((T, 1), np.bool_),
        "last_values": np.zeros((1,), np.float32),
    }
    gamma, lam = 0.9, 0.8
    adv, ret = PPO._gae(rollout, gamma, lam)
    expected = np.zeros(T)
    last = 0.0
    for t in reversed(range(T)):
        last = 1.0 + gamma * lam * last
        expected[t] = last
    np.testing.assert_allclose(adv[:, 0], expected, rtol=1e-6)
    np.testing.assert_allclose(ret, adv)  # values are zero


def test_gae_resets_at_done():
    rollout = {
        "rewards": np.ones((3, 1), np.float32),
        "values": np.zeros((3, 1), np.float32),
        "dones": np.array([[False], [True], [False]]),
        "last_values": np.full((1,), 10.0, np.float32),
    }
    adv, _ = PPO._gae(rollout, gamma=1.0, lam=1.0)
    assert adv[1, 0] == 1.0  # episode boundary: no bootstrap through done
    assert adv[2, 0] == 11.0  # bootstraps from last_values


@pytest.mark.slow
def test_ppo_learns_cartpole(cluster):
    """Learning test: mean episode return must clearly improve within a
    small budget (reference rllib learning-test pattern)."""
    algo = PPOConfig(
        num_env_runners=2,
        num_envs_per_runner=4,
        rollout_fragment_length=128,
        minibatch_size=256,
        seed=1,
        learner_platform="cpu",
    ).build()
    try:
        first = algo.train()["episode_return_mean"]
        last = first
        for _ in range(14):
            last = algo.train()["episode_return_mean"]
            if last >= 60.0:
                break
        assert last >= 60.0 or last >= 2.5 * max(first, 15.0), (first, last)
    finally:
        algo.stop()


def test_ppo_state_roundtrip(cluster):
    algo = PPOConfig(num_env_runners=1, num_envs_per_runner=2,
                     rollout_fragment_length=32, seed=2, learner_platform="cpu").build()
    try:
        algo.train()
        state = algo.get_state()
        obs = np.zeros(4, np.float32)
        action_before = algo.compute_single_action(obs)

        algo2 = PPOConfig(num_env_runners=1, num_envs_per_runner=2,
                          rollout_fragment_length=32, seed=3, learner_platform="cpu").build()
        try:
            algo2.set_state(state)
            assert algo2.iteration == algo.iteration
            assert algo2.compute_single_action(obs) == action_before
        finally:
            algo2.stop()
    finally:
        algo.stop()


def test_learner_group_matches_single_process(cluster):
    """A 2-process LearnerGroup update (batch sharded over the gang,
    gradients averaged over it) must equal a single-process update on the
    whole batch (reference learner_group.py:81 DDP equivalence)."""
    from ray_tpu_torch.rl.learner_group import LearnerGroup

    def init_fn(device):
        import torch

        w = torch.randn((4, 1), generator=torch.Generator().manual_seed(0))
        return (w.to(device), torch.zeros((4, 1), device=device))

    def update_builder():
        import torch

        def update(state, batch, mean_grads):
            w, m = state
            w = w.detach().requires_grad_()
            loss = ((batch["x"] @ w - batch["y"]) ** 2).mean()
            (g,) = torch.autograd.grad(loss, w)
            mean_grads([g])
            m = 0.9 * m + g
            w = (w - 0.1 * m).detach()
            return (w, m), {"loss": loss.detach()}

        return update

    rng = np.random.default_rng(3)
    batch = {
        "x": rng.standard_normal((16, 4)).astype(np.float32),
        "y": rng.standard_normal((16, 1)).astype(np.float32),
    }

    group = LearnerGroup(
        num_learners=2, init_fn=init_fn, update_builder=update_builder, platform="cpu"
    )
    try:
        stats2 = [group.update(batch) for _ in range(3)]
        w2 = group.get_state()[0]
    finally:
        group.shutdown()

    single = LearnerGroup(
        num_learners=1, init_fn=init_fn, update_builder=update_builder, platform="cpu"
    )
    try:
        stats1 = [single.update(batch) for _ in range(3)]
        w1 = single.get_state()[0]
    finally:
        single.shutdown()

    for s1, s2 in zip(stats1, stats2):
        assert abs(s1["loss"] - s2["loss"]) < 1e-5, (s1, s2)
    np.testing.assert_allclose(np.asarray(w1), np.asarray(w2), rtol=1e-5)


@pytest.mark.slow
def test_impala_learns_cartpole(cluster):
    """IMPALA learning test (reference rllib learning-test pattern):
    async V-trace updates must clearly improve the mean return."""
    from ray_tpu_torch.rl import IMPALAConfig

    algo = IMPALAConfig(
        num_env_runners=2,
        num_envs_per_runner=4,
        rollout_fragment_length=128,
        lr=1e-3,
        seed=1,
        learner_platform="cpu",
    ).build()
    try:
        first = algo.train()["episode_return_mean"]
        last = first
        for _ in range(30):
            last = algo.train()["episode_return_mean"]
            if last >= 60.0:
                break
        assert last >= 60.0 or last >= 2.5 * max(first, 15.0), (first, last)
    finally:
        algo.stop()


def test_impala_state_roundtrip(cluster):
    from ray_tpu_torch.rl import IMPALAConfig

    algo = IMPALAConfig(
        num_env_runners=1, num_envs_per_runner=2, rollout_fragment_length=32,
        seed=2, learner_platform="cpu",
    ).build()
    try:
        algo.train()
        state = algo.get_state()
        obs = np.zeros(4, np.float32)
        before = algo.compute_single_action(obs)
        algo2 = IMPALAConfig(
            num_env_runners=1, num_envs_per_runner=2,
            rollout_fragment_length=32, seed=3, learner_platform="cpu",
        ).build()
        try:
            algo2.set_state(state)
            assert algo2.compute_single_action(obs) == before
        finally:
            algo2.stop()
    finally:
        algo.stop()


def test_impala_with_learner_gang(cluster):
    """IMPALA over a 2-process LearnerGroup: the V-trace update ships to
    the gang (batch sharded over envs, gradients averaged) and training
    still progresses + round-trips state."""
    from ray_tpu_torch.rl import IMPALAConfig

    algo = IMPALAConfig(
        num_env_runners=1,
        num_envs_per_runner=4,  # divisible by the gang size
        rollout_fragment_length=32,
        rollouts_per_iteration=2,
        num_learners=2,
        seed=5,
        learner_platform="cpu",
    ).build()
    try:
        out = algo.train()
        assert out["num_env_steps_trained"] > 0
        assert "loss" in out
        obs = np.zeros(4, np.float32)
        state = algo.get_state()
        before = algo.compute_single_action(obs)
        algo.set_state(state)
        assert algo.compute_single_action(obs) == before
    finally:
        algo.stop()


def test_replay_buffer_wraps_and_samples():
    from ray_tpu_torch.rl import ReplayBuffer

    buf = ReplayBuffer(100, seed=0)
    for start in range(0, 250, 50):
        buf.add_batch({
            "x": np.arange(start, start + 50, dtype=np.int64),
            "y": np.ones((50, 2), np.float32),
        })
    assert len(buf) == 100
    s = buf.sample(32)
    assert s["x"].shape == (32,) and s["y"].shape == (32, 2)
    # after wrapping, only the newest 100 values remain
    assert s["x"].min() >= 150


@pytest.mark.slow
def test_dqn_learns_cartpole(cluster):
    """DQN learning test (reference rllib learning-test pattern):
    double-Q + replay must clearly improve the mean return."""
    from ray_tpu_torch.rl import DQNConfig

    algo = DQNConfig(
        num_env_runners=1,
        num_envs_per_runner=4,
        rollout_fragment_length=64,
        lr=1e-3,
        train_batch_size=64,
        updates_per_iteration=48,
        learning_starts=256,
        target_update_freq=100,
        epsilon_decay_steps=4000,
        seed=7,
        learner_platform="cpu",
    ).build()
    try:
        first = algo.train()["episode_return_mean"]
        last = first
        for _ in range(40):
            out = algo.train()
            last = out["episode_return_mean"]
            if last >= 60.0:
                break
        assert last >= 60.0 or last >= 2.5 * max(first, 15.0), (first, last)
    finally:
        algo.stop()


def test_dqn_state_roundtrip(cluster):
    from ray_tpu_torch.rl import DQNConfig

    algo = DQNConfig(
        num_env_runners=1, num_envs_per_runner=2,
        rollout_fragment_length=16, learning_starts=16,
        updates_per_iteration=4, seed=9, learner_platform="cpu",
    ).build()
    try:
        algo.train()
        state = algo.get_state()
        obs = np.zeros(4, np.float32)
        before = algo.compute_single_action(obs)
        algo2 = DQNConfig(
            num_env_runners=1, num_envs_per_runner=2,
            rollout_fragment_length=16, seed=10, learner_platform="cpu",
        ).build()
        try:
            algo2.set_state(state)
            assert algo2.compute_single_action(obs) == before
            assert algo2.gradient_steps == algo.gradient_steps
        finally:
            algo2.stop()
    finally:
        algo.stop()


@pytest.mark.slow
def test_dqn_cnn_on_image_env(cluster):
    """The image-obs path end to end: CNN Q-network + custom image env
    resolved by module path on the runner workers (Atari stand-in)."""
    from ray_tpu_torch.rl import DQNConfig

    algo = DQNConfig(
        env="ray_tpu_torch.rl.test_envs:TinyImageEnv",
        model="cnn_q",
        num_env_runners=1,
        num_envs_per_runner=2,
        rollout_fragment_length=32,
        learning_starts=128,
        train_batch_size=32,
        updates_per_iteration=24,
        lr=2e-3,
        epsilon_decay_steps=1500,
        target_update_freq=50,
        seed=3,
        learner_platform="cpu",
    ).build()
    try:
        first = algo.train()["episode_return_mean"]
        last = first
        for _ in range(50):
            out = algo.train()
            last = out["episode_return_mean"]
            if last >= 12.5:  # optimal 16, random ~8
                break
        assert last >= 12.5, (first, last)
        obs = np.zeros((8, 8, 3), np.uint8)
        a = algo.compute_single_action(obs)
        assert a in (0, 1)
    finally:
        algo.stop()


# ---------------------------------------------------------------------------
# the port against the JAX package


def test_import_needs_no_gymnasium():
    """The card's machine has no ``gymnasium``: the package imports without
    it (the runners import it where they make an env)."""
    code = ("import sys; sys.modules['gymnasium'] = None; import ray_tpu_torch.rl; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok"]


@pytest.mark.parametrize("config", ["PPOConfig", "DQNConfig", "IMPALAConfig"])
def test_learner_defaults_to_the_card(config):
    """Without ``learner_platform`` a learner goes on ``cuda``: with no card
    the build raises (before any runner starts) and never falls back to
    the CPU."""
    import ray_tpu_torch.rl as trl

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default builds there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(trl, config)().build()


@pytest.mark.parametrize("algo", ["ppo", "impala"])
def test_single_learner_evaluates_on_its_params(algo, monkeypatch):
    """One learner in process: ``compute_single_action`` runs the policy on
    the learner's own tensors (on the card when the learner is there),
    never on a numpy snapshot moved to the CPU."""
    seen = []
    policy = tutils.apply_mlp_policy
    monkeypatch.setattr(tutils, "apply_mlp_policy",
                        lambda p, o: (seen.append(tm.tree_leaves(p)), policy(p, o))[1])
    if algo == "ppo":
        params = tm.init_mlp_policy(torch.Generator().manual_seed(0), 4, 2, (8, 8))
        learner = types.SimpleNamespace(params=params)
        act = PPO.compute_single_action
    else:
        init_state, _ = timpala._make_vtrace_update(timpala.IMPALAConfig(hidden=(8, 8)), 4, 2)
        learner = types.SimpleNamespace(_group=None, _state=init_state(torch.device("cpu")))
        params = learner._state[0]
        act = timpala.IMPALA.compute_single_action
    assert act(learner, np.zeros(4, np.float32)) in (0, 1)
    assert len(seen) == 1
    assert all(a is b for a, b in zip(seen[0], tm.tree_leaves(params), strict=True))


def _frames(shape, dtype, seed):
    rs = np.random.RandomState(seed)
    if dtype == "uint8":
        return rs.randint(0, 256, size=shape).astype(np.uint8)
    return rs.rand(*shape).astype(np.float32)


#: case -> (JAX init, its args, apply name, obs shape, obs dtype)
APPLY_CASES = {
    "mlp_policy": (jm.init_mlp_policy, (4, 2), "apply_mlp_policy", (2, 4), "float32"),
    "mlp_q": (jm.init_mlp_q, (4, 2), "apply_mlp_q", (2, 4), "float32"),
    "cnn_q-8x8x3-uint8": (jm.init_cnn, ((8, 8, 3), 2), "apply_cnn_q", (2, 8, 8, 3), "uint8"),
    "cnn_q-84x84x4-uint8": (jm.init_cnn, ((84, 84, 4), 6), "apply_cnn_q", (2, 84, 84, 4),
                            "uint8"),
    "cnn_q-84x84x4-float": (jm.init_cnn, ((84, 84, 4), 6), "apply_cnn_q", (2, 84, 84, 4),
                            "float32"),
    "cnn_policy-84x84x4-uint8": (jm.init_cnn, ((84, 84, 4), 6), "apply_cnn_policy",
                                 (2, 84, 84, 4), "uint8"),
    "cnn_policy-84x84x4-float": (jm.init_cnn, ((84, 84, 4), 6), "apply_cnn_policy",
                                 (2, 84, 84, 4), "float32"),
}


def test_same_padding_is_xlas():
    """At 84x84 the three convs pad (2, 2), (1, 2) and (1, 1), as XLA's SAME."""
    assert [tm.same_padding(n, k, s) for n, (_c, k, s) in zip((84, 21, 11), tm.DEFAULT_CONV)] \
        == [(2, 2), (1, 2), (1, 1)]


@pytest.mark.parametrize("case", list(APPLY_CASES))
def test_apply_matches_jax(case):
    init, args, name, shape, dtype = APPLY_CASES[case]
    kw = {"heads": ("pi", "vf")} if name == "apply_cnn_policy" else {}
    jparams = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0), *args, **kw))
    obs = _frames(shape, dtype, seed=1)
    ref = getattr(jm, name)(jparams, jnp.asarray(obs))
    got = getattr(tm, name)(tm.params_from_jax(jparams), torch.from_numpy(obs))
    refs = ref if isinstance(ref, tuple) else (ref,)
    gots = got if isinstance(got, tuple) else (got,)
    for g, r in zip(gots, refs, strict=True):
        r = np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=APPLY_REL * np.abs(r).max())


def _closure(fn, name):
    """A name a nested function closes over (the JAX builders keep their
    helpers inside)."""
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def test_vtrace_matches_jax():
    cfg = jimpala.IMPALAConfig(gamma=0.97, vtrace_clip_rho=1.0, vtrace_clip_c=0.9)
    _, update = jimpala._make_vtrace_update(cfg, 4, 2)
    jvtrace = _closure(_closure(update, "loss_fn"), "vtrace")
    rs = np.random.RandomState(4)
    B, T = 4, 16
    arrays = (rs.randn(B, T).astype(np.float32),  # values
              rs.randn(B, T).astype(np.float32),  # rewards
              (rs.rand(B, T) < 0.1).astype(np.float32),  # dones
              np.exp(0.5 * rs.randn(B, T)).astype(np.float32),  # rhos
              rs.randn(B).astype(np.float32))  # bootstrap
    ref = jvtrace(*(jnp.asarray(a) for a in arrays))
    got = timpala.vtrace(*(torch.from_numpy(a) for a in arrays), gamma=cfg.gamma,
                         clip_rho=cfg.vtrace_clip_rho, clip_c=cfg.vtrace_clip_c)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=VTRACE_TOL, atol=VTRACE_TOL)


def _ppo_batch(rs, n):
    return {"obs": rs.randn(n, 4).astype(np.float32),
            "actions": rs.randint(0, 2, size=n).astype(np.int64),
            "logp_old": (np.log(0.5) + 0.1 * rs.randn(n)).astype(np.float32),
            "advantages": rs.randn(n).astype(np.float32),
            "returns": rs.randn(n).astype(np.float32)}


def _dqn_batch(rs, n, obs_shape):
    obs = (lambda: rs.randint(0, 256, size=(n, *obs_shape)).astype(np.uint8)) \
        if len(obs_shape) == 3 else (lambda: rs.randn(n, *obs_shape).astype(np.float32))
    return {"obs": obs(), "actions": rs.randint(0, 6 if len(obs_shape) == 3 else 2,
                                                size=n).astype(np.int64),
            "rewards": rs.randn(n).astype(np.float32), "next_obs": obs(),
            "dones": rs.rand(n) < 0.2}


def _impala_batch(rs, b, t):
    return {"obs": rs.randn(b, t, 4).astype(np.float32),
            "actions": rs.randint(0, 2, size=(b, t)).astype(np.int32),
            "behavior_logp": (np.log(0.5) + 0.1 * rs.randn(b, t)).astype(np.float32),
            "rewards": rs.rand(b, t).astype(np.float32),
            "dones": (rs.rand(b, t) < 0.1).astype(np.float32),
            "bootstrap": rs.randn(b).astype(np.float32)}


def _run_ppo(steps):
    cfg = PPOConfig(lr=3e-4)
    jparams = jm.init_mlp_policy(jax.random.PRNGKey(0), 4, 2, cfg.hidden)
    stand_in = types.SimpleNamespace(config=cfg, optimizer=optax.adam(cfg.lr))
    jupdate = jax.jit(jppo.PPO._make_update(stand_in))
    opt_state = stand_in.optimizer.init(jparams)
    tparams = tutils.on_device(tm.params_from_jax(jparams), "cpu")
    topt = tutils.adam(tparams, cfg.lr)
    tupdate = PPO._make_update(types.SimpleNamespace(config=cfg))
    rs = np.random.RandomState(7)
    out = []
    for _ in range(steps):
        b = _ppo_batch(rs, 64)
        jparams, opt_state, jstats = jupdate(jparams, opt_state, {k: jnp.asarray(v)
                                                                  for k, v in b.items()})
        tstats = tupdate(tparams, topt, {k: torch.from_numpy(v) for k, v in b.items()})
        out.append((jstats, tstats, jparams, tparams))
    return out, cfg.lr


def _run_dqn(steps, model):
    obs_shape = (84, 84, 4) if model == "cnn_q" else (4,)
    num_actions = 6 if model == "cnn_q" else 2
    cfg = tdqn.DQNConfig(model=model, lr=1e-3, target_update_freq=2, learner_platform="cpu")
    key = jax.random.PRNGKey(0)
    jparams = (jm.init_cnn(key, obs_shape, num_actions) if model == "cnn_q"
               else jm.init_mlp_q(key, 4, num_actions, cfg.hidden))
    stand_in = types.SimpleNamespace(config=cfg, optimizer=optax.adam(cfg.lr))
    stand_in._apply = types.MethodType(jdqn.DQN._apply, stand_in)
    jupdate = jax.jit(jdqn.DQN._make_update(stand_in))
    opt_state = stand_in.optimizer.init(jparams)
    jtarget = jparams
    # the port's learner as DQN.learn drives it (target sync included)
    params = tutils.on_device(tm.params_from_jax(jparams), "cpu")
    learner = types.SimpleNamespace(config=cfg, device=torch.device("cpu"), params=params,
                                    target_params=tutils.clone_params(params),
                                    optimizer=tutils.adam(params, cfg.lr), gradient_steps=0)
    learner._apply = types.MethodType(tdqn.DQN._apply, learner)
    learner._update = tdqn.DQN._make_update(learner)
    rs = np.random.RandomState(8)
    out = []
    for step in range(1, steps + 1):
        b = _dqn_batch(rs, 8, obs_shape)
        jparams, opt_state, jstats = jupdate(jparams, jtarget, opt_state,
                                             {k: jnp.asarray(v) for k, v in b.items()})
        if step % cfg.target_update_freq == 0:
            jtarget = jax.tree_util.tree_map(lambda x: x, jparams)
        tstats = tdqn.DQN.learn(learner, b)
        out.append((jstats, tstats, jparams, learner.params))
    return out, cfg.lr


def _run_impala(steps):
    cfg = timpala.IMPALAConfig(lr=5e-4, learner_platform="cpu")
    jinit, jupdate = jimpala._make_vtrace_update(
        jimpala.IMPALAConfig(lr=cfg.lr), 4, 2)
    jstate = jinit()
    jupdate = jax.jit(jupdate)
    tinit, tupdate = timpala._make_vtrace_update(cfg, 4, 2)
    tstate = tinit(torch.device("cpu"))
    tutils.load_state_(tstate[0], jax.tree_util.tree_map(np.asarray, jstate[0]))
    rs = np.random.RandomState(9)
    out = []
    for _ in range(steps):
        b = _impala_batch(rs, 4, 8)
        jstate, jstats = jupdate(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tstats = tupdate(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        out.append((jstats, tstats, jstate[0], tstate[0]))
    return out, cfg.lr


UPDATE_RUNS = {
    "ppo": _run_ppo,
    "dqn-mlp": lambda steps: _run_dqn(steps, "mlp_q"),
    "dqn-cnn-84x84x4": lambda steps: _run_dqn(steps, "cnn_q"),
    "impala": _run_impala,
}


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("algo", list(UPDATE_RUNS))
def test_update_matches_jax(algo, steps):
    """Each update's stats, and the params after the last, against the JAX
    update on the same params and batches (DQN's target synced after
    update 2: an aliased target would read the online params at update 2)."""
    out, lr = UPDATE_RUNS[algo](steps)
    for i, (jstats, tstats, _, _) in enumerate(out):
        assert sorted(jstats) == sorted(tstats)
        for k in jstats:
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]), rtol=STATS_RTOL,
                                       err_msg=f"update {i + 1}: {k}")
    _, _, jparams, tparams = out[-1]
    # both trees flattened by JAX's rule (dict keys sorted)
    for j, t in zip(jax.tree_util.tree_leaves(jparams),
                    jax.tree_util.tree_leaves(tm.to_host(tparams)), strict=True):
        np.testing.assert_allclose(t, np.asarray(j), rtol=0, atol=PARAMS_LR_FRACTION * lr)


def _runner_pair(env_j, env_t, seed):
    return (jrunner._EnvRunner(env_j, 4, seed), trunner._EnvRunner(env_t, 4, seed))


def test_env_runner_sample_matches_jax():
    """32 steps x 4 envs of CartPole-v1 through ``sample`` with the same
    params and seed."""
    params = jax.tree_util.tree_map(np.asarray, jm.init_mlp_policy(jax.random.PRNGKey(2), 4, 2))
    jr, tr = _runner_pair("CartPole-v1", "CartPole-v1", seed=11)
    try:
        ref, got = jr.sample(params, 32), tr.sample(params, 32)
    finally:
        jr.close()
        tr.close()
    for k in ("obs", "actions", "rewards", "dones"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in ("logp", "values", "last_values"):
        np.testing.assert_allclose(got[k], ref[k], rtol=RUNNER_TOL, atol=RUNNER_TOL, err_msg=k)
    assert got["episode_returns"] == ref["episode_returns"]


@pytest.mark.parametrize("model", ["mlp_q", "cnn_q"])
def test_env_runner_transitions_match_jax(model):
    """32 epsilon-greedy steps x 4 envs through ``sample_transitions``
    (CartPole-v1 with the MLP Q-net, ``TinyImageEnv`` with the CNN), the
    same params and seed."""
    if model == "cnn_q":
        envs = ("ray_tpu.rl.test_envs:TinyImageEnv", "ray_tpu_torch.rl.test_envs:TinyImageEnv")
        params = jm.init_cnn(jax.random.PRNGKey(3), (8, 8, 3), 2)
    else:
        envs = ("CartPole-v1", "CartPole-v1")
        params = jm.init_mlp_q(jax.random.PRNGKey(3), 4, 2)
    params = jax.tree_util.tree_map(np.asarray, params)
    jr, tr = _runner_pair(*envs, seed=12)
    try:
        ref = jr.sample_transitions(params, 32, 0.3, model)
        got = tr.sample_transitions(params, 32, 0.3, model)
    finally:
        jr.close()
        tr.close()
    assert sorted(got) == sorted(ref)
    for k in ("obs", "actions", "rewards", "next_obs", "dones"):
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["episode_returns"] == ref["episode_returns"]
