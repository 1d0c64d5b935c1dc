"""PPO: the flagship RL algorithm (port of ``ray_tpu.rl.ppo``).

Reference: ``rllib/algorithms/ppo/ppo.py:374,400`` — training_step =
parallel sampling on EnvRunner actors → GAE → clipped-surrogate SGD on
a Learner.

The learner is one update over each minibatch on the learner's device
(the card unless ``learner_platform`` names the CPU), with
``torch.optim.Adam`` at optax ``adam``'s defaults; EnvRunner actors sample
on the CPU from a numpy snapshot of the params. GAE, the advantage
normalisation and the minibatch permutation are the reference's numpy
code. The Algorithm implements the Tune trainable surface (``train()``
returns a metrics dict, ``get_state``/``set_state``)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch.rl.models import apply_mlp_policy, init_mlp_policy, to_host


@dataclass
class PPOConfig:
    """Reference ``PPOConfig`` (algorithm_config builder) as a dataclass."""

    env: str = "CartPole-v1"
    env_config: Optional[Dict[str, Any]] = None
    num_env_runners: int = 2
    num_envs_per_runner: int = 4
    rollout_fragment_length: int = 64  # steps per env per iteration
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coeff: float = 0.01
    vf_coeff: float = 0.5
    lr: float = 3e-4
    num_epochs: int = 4
    minibatch_size: int = 256
    hidden: tuple = (64, 64)
    seed: int = 0
    #: the learner's device: the card unless this names another ("cpu")
    learner_platform: Optional[str] = None
    runner_resources: Dict[str, float] = field(default_factory=lambda: {"CPU": 0.5})

    def build(self) -> "PPO":
        return PPO(self)


class PPO:
    """EnvRunner gang + a torch learner (reference Algorithm)."""

    def __init__(self, config: PPOConfig):
        from ray_tpu_torch.models.llama import resolve_device
        from ray_tpu_torch.rl.utils import adam, make_runners, on_device, probe_env_spec

        self.config = config
        self.device = resolve_device(config.learner_platform)
        obs_dim, num_actions = probe_env_spec(config.env, config.env_config)

        gen = torch.Generator().manual_seed(config.seed)
        self.params = on_device(init_mlp_policy(gen, obs_dim, num_actions, config.hidden),
                                self.device)
        self.optimizer = adam(self.params, config.lr)
        self.iteration = 0
        self._update = self._make_update()

        self.runners = make_runners(config)
        self._recent_returns: List[float] = []

    # -- learner ---------------------------------------------------------
    def _make_update(self):
        """``update(params, optimizer, batch) -> stats``: one Adam step on
        the minibatch's loss, in place; the stats are the loss terms at the
        params before the step (0-d tensors)."""
        cfg = self.config

        def loss_fn(params, batch):
            logits, values = apply_mlp_policy(params, batch["obs"])
            logp_all = F.log_softmax(logits, dim=-1)
            logp = logp_all.gather(1, batch["actions"].long()[:, None])[:, 0]
            ratio = torch.exp(logp - batch["logp_old"])
            adv = batch["advantages"]
            surr = torch.minimum(
                ratio * adv,
                torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv,
            )
            pi_loss = -surr.mean()
            vf_loss = ((values - batch["returns"]) ** 2).mean()
            entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
            total = pi_loss + cfg.vf_coeff * vf_loss - cfg.entropy_coeff * entropy
            return total, (pi_loss, vf_loss, entropy)

        def update(params, optimizer, batch):
            optimizer.zero_grad(set_to_none=True)
            total, (pi_loss, vf_loss, entropy) = loss_fn(params, batch)
            total.backward()
            optimizer.step()
            return {
                "loss": total.detach(),
                "pi_loss": pi_loss.detach(),
                "vf_loss": vf_loss.detach(),
                "entropy": entropy.detach(),
            }

        return update

    @staticmethod
    def _gae(rollout, gamma: float, lam: float):
        """Generalized advantage estimation over [T, N] arrays."""
        rewards = rollout["rewards"]
        values = rollout["values"]
        dones = rollout["dones"].astype(np.float32)
        T = rewards.shape[0]
        adv = np.zeros_like(rewards)
        last = np.zeros_like(rollout["last_values"])
        next_value = rollout["last_values"]
        for t in reversed(range(T)):
            nonterminal = 1.0 - dones[t]
            delta = rewards[t] + gamma * next_value * nonterminal - values[t]
            last = delta + gamma * lam * nonterminal * last
            adv[t] = last
            next_value = values[t]
        returns = adv + values
        return adv, returns

    @staticmethod
    def _batches(obs, actions, logp_old, advs, rets, cfg, iteration: int):
        """The iteration's minibatches as numpy dicts: advantages normalised
        over the whole rollout, ``cfg.num_epochs`` permutations from
        ``default_rng(cfg.seed + iteration)``."""
        advs = (advs - advs.mean()) / (advs.std() + 1e-8)
        n = len(obs)
        rng = np.random.default_rng(cfg.seed + iteration)
        for _ in range(cfg.num_epochs):
            perm = rng.permutation(n)
            for start in range(0, n, cfg.minibatch_size):
                idx = perm[start : start + cfg.minibatch_size]
                yield {
                    "obs": obs[idx],
                    "actions": actions[idx],
                    "logp_old": logp_old[idx],
                    "advantages": advs[idx],
                    "returns": rets[idx],
                }

    # -- Tune trainable surface -----------------------------------------
    def train(self) -> Dict[str, Any]:
        """One training iteration (reference ``Algorithm.train``)."""
        cfg = self.config
        t0 = time.perf_counter()
        host_params = to_host(self.params)
        rollouts = ray_tpu_torch.get(
            [
                r.sample.remote(host_params, cfg.rollout_fragment_length)
                for r in self.runners
            ],
            timeout=600,
        )
        sample_time = time.perf_counter() - t0

        obs, actions, logp_old, advs, rets = [], [], [], [], []
        for ro in rollouts:
            adv, ret = self._gae(ro, cfg.gamma, cfg.gae_lambda)
            obs.append(ro["obs"].reshape(-1, ro["obs"].shape[-1]))
            actions.append(ro["actions"].reshape(-1))
            logp_old.append(ro["logp"].reshape(-1))
            advs.append(adv.reshape(-1))
            rets.append(ret.reshape(-1))
            self._recent_returns.extend(ro["episode_returns"])
        obs = np.concatenate(obs)
        n = len(obs)
        stats: Dict[str, Any] = {}
        for batch in self._batches(obs, np.concatenate(actions), np.concatenate(logp_old),
                                   np.concatenate(advs), np.concatenate(rets), cfg,
                                   self.iteration):
            batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
            stats = self._update(self.params, self.optimizer, batch)
        self.iteration += 1
        self._recent_returns = self._recent_returns[-100:]
        mean_return = (
            float(np.mean(self._recent_returns)) if self._recent_returns else 0.0
        )
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": mean_return,
            "num_env_steps_sampled": n,
            "sample_time_s": round(sample_time, 3),
            **{k: float(v) for k, v in stats.items()},
        }

    def get_state(self) -> Dict[str, Any]:
        from ray_tpu_torch.rl.utils import state_to_host

        return {
            "params": to_host(self.params),
            "opt_state": state_to_host(self.optimizer),
            "iteration": self.iteration,
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        from ray_tpu_torch.rl.utils import load_state_

        load_state_(self.params, state["params"])
        load_state_(self.optimizer, state["opt_state"])
        self.iteration = state["iteration"]

    def compute_single_action(self, obs) -> int:
        """Greedy action for evaluation."""
        from ray_tpu_torch.rl.utils import greedy_action

        return greedy_action(self.params, obs)

    def stop(self) -> None:
        for r in self.runners:
            try:
                ray_tpu_torch.get(r.close.remote(), timeout=10)
                ray_tpu_torch.kill(r)
            except Exception:
                pass
