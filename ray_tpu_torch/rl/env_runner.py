"""EnvRunner: rollout-collection actors (port of ``ray_tpu.rl.env_runner``).

CPU actors step gymnasium vector envs with the current policy and return
episode batches; learning happens elsewhere (a learner on the card). The
policy runs here on the CPU with torch capped at one thread, on the numpy
params snapshot the learner sends (``models.to_host``). Sampling stays in
numpy with the reference's generator, so a runner given the same params
and seed takes the same actions as the JAX package's. ``gymnasium`` is
imported only where an env is made."""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

import ray_tpu_torch


def resolve_env_class(env_name: str):
    """``"module.path:EnvClass"`` → the class (importable on any worker
    by module path — the fake-env CI strategy)."""
    import importlib

    mod_name, attr = env_name.split(":", 1)
    return getattr(importlib.import_module(mod_name), attr)


def make_vector_env(env_name: str, num_envs: int, env_config=None):
    """Vector env in SAME_STEP autoreset mode: a done step returns the
    NEW episode's reset obs and the next step is a real transition.
    gymnasium>=1.0 defaults to NEXT_STEP, whose reset step IGNORES the
    action and pays reward 0 — recorded naively (as the rollout loops
    here do), that trains Q/V toward cross-episode garbage."""
    import gymnasium as gym
    from gymnasium.vector import AutoresetMode

    if ":" in env_name:
        cls = resolve_env_class(env_name)
        cfg = env_config or {}
        return gym.vector.SyncVectorEnv(
            [(lambda: cls(**cfg)) for _ in range(num_envs)],
            autoreset_mode=AutoresetMode.SAME_STEP,
        )
    # vectorization_mode="sync" forces the generic SyncVectorEnv — the
    # per-env custom vector classes (e.g. CartPoleVectorEnv) reject
    # vector_kwargs and pin their own autoreset behavior
    return gym.make_vec(
        env_name,
        num_envs=num_envs,
        vectorization_mode="sync",
        vector_kwargs={"autoreset_mode": AutoresetMode.SAME_STEP},
        **(env_config or {}),
    )


def _cpu_params(params):
    """The learner's numpy snapshot as CPU tensors (copies: an array from
    the object store is read-only)."""
    import torch

    from ray_tpu_torch.rl.models import tree_map

    return tree_map(lambda a: torch.from_numpy(np.array(a)), params)


class _EnvRunner:
    """One rollout actor: a gymnasium vector env + the policy on the CPU.

    Defined undecorated so cloudpickle exports by module reference."""

    def __init__(self, env_name: str, num_envs: int, seed: int, env_config=None):
        import torch

        # Rollout actors are CPU workers (reference: EnvRunners are
        # CPU-only; learners own the accelerator), one core each
        torch.set_num_threads(1)
        self._envs = make_vector_env(env_name, num_envs, env_config)
        self._num_envs = num_envs
        self._obs, _ = self._envs.reset(seed=seed)
        self._rng = np.random.default_rng(seed)
        self._episode_returns = np.zeros(num_envs)
        self._finished_returns: List[float] = []

    def sample(self, params, num_steps: int) -> Dict[str, Any]:
        """Collect ``num_steps`` vector steps with the given policy params.

        Returns time-major arrays [T, N, ...] plus bootstrap values and
        episode-return stats (the learner computes GAE)."""
        import torch

        from ray_tpu_torch.rl.models import apply_mlp_policy

        params = _cpu_params(params)

        def apply(obs):
            logits, value = apply_mlp_policy(params, torch.as_tensor(obs, dtype=torch.float32))
            return logits.numpy(), value.numpy()

        obs_buf, act_buf, rew_buf, done_buf, logp_buf, val_buf = [], [], [], [], [], []
        for _ in range(num_steps):
            logits, value = apply(self._obs)
            # sample actions from the categorical (gumbel trick, numpy rng)
            z = self._rng.gumbel(size=logits.shape)
            actions = np.argmax(logits + z, axis=-1)
            logp = logits - _logsumexp(logits)
            act_logp = np.take_along_axis(logp, actions[:, None], axis=1)[:, 0]

            next_obs, rewards, terminated, truncated, _ = self._envs.step(actions)
            dones = np.logical_or(terminated, truncated)

            obs_buf.append(self._obs)
            act_buf.append(actions)
            rew_buf.append(rewards)
            done_buf.append(dones)
            logp_buf.append(act_logp)
            val_buf.append(value)

            self._episode_returns += rewards
            for i, d in enumerate(dones):
                if d:
                    self._finished_returns.append(float(self._episode_returns[i]))
                    self._episode_returns[i] = 0.0
            self._obs = next_obs

        _, last_value = apply(self._obs)
        finished, self._finished_returns = self._finished_returns, []
        return {
            "obs": np.asarray(obs_buf, np.float32),
            "actions": np.asarray(act_buf, np.int64),
            "rewards": np.asarray(rew_buf, np.float32),
            "dones": np.asarray(done_buf, np.bool_),
            "logp": np.asarray(logp_buf, np.float32),
            "values": np.asarray(val_buf, np.float32),
            "last_values": np.asarray(last_value, np.float32),
            "episode_returns": finished,
        }

    def sample_transitions(
        self, params, num_steps: int, epsilon: float, model: str = "mlp_q"
    ) -> Dict[str, Any]:
        """Off-policy collection (DQN): epsilon-greedy over Q-values,
        returns flat (s, a, r, s', done) transition arrays plus episode
        stats. ``model``: "mlp_q" | "cnn_q"."""
        import torch

        from ray_tpu_torch.rl.models import apply_cnn_q, apply_mlp_q

        apply_q = apply_cnn_q if model == "cnn_q" else apply_mlp_q
        params = _cpu_params(params)
        obs_buf, act_buf, rew_buf, next_buf, done_buf = [], [], [], [], []
        for _ in range(num_steps):
            obs = torch.as_tensor(self._obs)
            # JAX's default types: a float64 obs computes in float32
            q = apply_q(params, obs.float() if obs.is_floating_point() else obs).numpy()
            greedy = np.argmax(q, axis=-1)
            explore = self._rng.random(self._num_envs) < epsilon
            random_a = self._rng.integers(0, q.shape[-1], self._num_envs)
            actions = np.where(explore, random_a, greedy)

            next_obs, rewards, terminated, truncated, infos = self._envs.step(actions)
            dones = np.logical_or(terminated, truncated)
            # SAME_STEP autoreset returns the NEW episode's reset obs on
            # done steps; the stored transition must end at the true
            # final obs (a truncated episode bootstraps from it)
            stored_next = next_obs
            final = infos.get("final_obs", infos.get("final_observation"))
            if final is not None and dones.any():
                stored_next = np.array(next_obs)
                for i in np.nonzero(dones)[0]:
                    if final[i] is not None:
                        stored_next[i] = final[i]
            obs_buf.append(self._obs)
            act_buf.append(actions)
            rew_buf.append(rewards)
            # bootstrap cuts only on TERMINATION — a truncated episode's
            # final state still has value (standard DQN detail)
            done_buf.append(terminated)
            next_buf.append(stored_next)

            self._episode_returns += rewards
            for i, d in enumerate(dones):
                if d:
                    self._finished_returns.append(float(self._episode_returns[i]))
                    self._episode_returns[i] = 0.0
            self._obs = next_obs

        finished, self._finished_returns = self._finished_returns, []
        flat = lambda a: np.asarray(a).reshape(-1, *np.asarray(a).shape[2:])
        return {
            "obs": flat(obs_buf),
            "actions": flat(act_buf).astype(np.int64),
            "rewards": flat(rew_buf).astype(np.float32),
            "next_obs": flat(next_buf),
            "dones": flat(done_buf).astype(np.bool_),
            "episode_returns": finished,
        }

    def close(self) -> bool:
        self._envs.close()
        return True


def _logsumexp(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    return m + np.log(np.exp(x - m).sum(axis=-1, keepdims=True))


EnvRunner = ray_tpu_torch.remote(_EnvRunner)
