"""DQN: value-based learning with a replay buffer (port of ``ray_tpu.rl.dqn``).

Reference: ``rllib/algorithms/dqn/`` (DQNConfig/DQN, double-Q +
target network + replay). The learner is one double-DQN Huber TD update
over each replay minibatch on the learner's device (the card unless
``learner_platform`` names the CPU); EnvRunner actors collect
epsilon-greedy transitions on the CPU; the target network is a clone of
the online params, refreshed every ``target_update_freq`` gradient steps.
``model="cnn_q"`` runs the conv torso for image observations (models.py)
— the Atari path.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch.rl.models import to_host
from ray_tpu_torch.rl.replay import ReplayBuffer


@dataclass
class DQNConfig:
    """Reference ``DQNConfig`` as a dataclass."""

    env: str = "CartPole-v1"
    env_config: Optional[Dict[str, Any]] = None
    num_env_runners: int = 1
    num_envs_per_runner: int = 4
    rollout_fragment_length: int = 32  # steps per env per iteration
    model: str = "mlp_q"  # "mlp_q" | "cnn_q"
    hidden: tuple = (128, 128)
    gamma: float = 0.99
    lr: float = 1e-3
    buffer_capacity: int = 50_000
    learning_starts: int = 500  # transitions before updates begin
    train_batch_size: int = 64
    updates_per_iteration: int = 32
    target_update_freq: int = 200  # gradient steps between target syncs
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_decay_steps: int = 5_000  # env steps to anneal over
    double_q: bool = True
    seed: int = 0
    #: the learner's device: the card unless this names another ("cpu")
    learner_platform: Optional[str] = None
    runner_resources: Dict[str, float] = field(default_factory=lambda: {"CPU": 0.5})

    def build(self) -> "DQN":
        return DQN(self)


class DQN:
    """EnvRunner gang + a double-DQN torch learner (reference Algorithm)."""

    def __init__(self, config: DQNConfig):
        from ray_tpu_torch.rl.models import init_cnn, init_mlp_q
        from ray_tpu_torch.models.llama import resolve_device
        from ray_tpu_torch.rl.utils import (
            adam, clone_params, make_runners, on_device, probe_env_space)

        self.config = config
        self.device = resolve_device(config.learner_platform)
        obs_shape, num_actions = probe_env_space(config.env, config.env_config)
        self._num_actions = num_actions

        gen = torch.Generator().manual_seed(config.seed)
        if config.model == "cnn_q":
            params = init_cnn(gen, obs_shape, num_actions, heads=("q",))
        else:
            obs_dim = int(np.prod(obs_shape))
            params = init_mlp_q(gen, obs_dim, num_actions, config.hidden)
        self.params = on_device(params, self.device)
        self.target_params = clone_params(self.params)
        self.optimizer = adam(self.params, config.lr)
        self.iteration = 0
        self.env_steps = 0
        self.gradient_steps = 0
        self._update = self._make_update()

        self.buffer = ReplayBuffer(config.buffer_capacity, seed=config.seed)
        self.runners = make_runners(config)
        self._recent_returns: List[float] = []

    def _apply(self):
        from ray_tpu_torch.rl.models import apply_cnn_q, apply_mlp_q

        return apply_cnn_q if self.config.model == "cnn_q" else apply_mlp_q

    # -- learner ---------------------------------------------------------
    def _make_update(self):
        """``update(params, target_params, optimizer, batch) -> stats``: one
        Adam step on the minibatch's TD loss, in place; the stats are read
        at the params before the step (0-d tensors)."""
        cfg = self.config
        apply_q = self._apply()

        def loss_fn(params, target_params, batch):
            q = apply_q(params, batch["obs"])
            q_taken = q.gather(1, batch["actions"].long()[:, None])[:, 0]
            with torch.no_grad():  # the TD target takes no gradient
                q_next_target = apply_q(target_params, batch["next_obs"])
                if cfg.double_q:
                    # double-DQN: online net picks, target net evaluates
                    next_a = apply_q(params, batch["next_obs"]).argmax(dim=-1)
                    next_q = q_next_target.gather(1, next_a[:, None])[:, 0]
                else:
                    next_q = q_next_target.max(dim=-1).values
                not_done = 1.0 - batch["dones"].float()
                target = batch["rewards"] + cfg.gamma * not_done * next_q
            td = q_taken - target
            loss = F.huber_loss(q_taken, target, delta=1.0)
            return loss, (td.abs().mean(), q_taken.mean())

        def update(params, target_params, optimizer, batch):
            optimizer.zero_grad(set_to_none=True)
            loss, (td_abs, q_mean) = loss_fn(params, target_params, batch)
            loss.backward()
            optimizer.step()
            return {
                "loss": loss.detach(),
                "td_error_abs": td_abs.detach(),
                "q_mean": q_mean.detach(),
            }

        return update

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self.env_steps / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final - cfg.epsilon_initial)

    def learn(self, batch_np: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One gradient step on a replay minibatch, and the target sync
        every ``target_update_freq`` of them."""
        from ray_tpu_torch.rl.utils import clone_params

        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch_np.items()}
        stats = self._update(self.params, self.target_params, self.optimizer, batch)
        self.gradient_steps += 1
        if self.gradient_steps % self.config.target_update_freq == 0:
            self.target_params = clone_params(self.params)
        return stats

    # -- Tune trainable surface -----------------------------------------
    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        eps = self._epsilon()
        host_params = to_host(self.params)
        rollouts = ray_tpu_torch.get(
            [
                r.sample_transitions.remote(
                    host_params, cfg.rollout_fragment_length, eps, cfg.model
                )
                for r in self.runners
            ],
            timeout=600,
        )
        sample_time = time.perf_counter() - t0
        for ro in rollouts:
            self._recent_returns.extend(ro.pop("episode_returns"))
            self.env_steps += len(ro["obs"])
            self.buffer.add_batch(ro)

        stats: Dict[str, Any] = {}
        if len(self.buffer) >= max(cfg.learning_starts, cfg.train_batch_size):
            for _ in range(cfg.updates_per_iteration):
                stats = self.learn(self.buffer.sample(cfg.train_batch_size))
        self.iteration += 1
        self._recent_returns = self._recent_returns[-100:]
        mean_return = (
            float(np.mean(self._recent_returns)) if self._recent_returns else 0.0
        )
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": mean_return,
            "num_env_steps_sampled": self.env_steps,
            "num_gradient_steps": self.gradient_steps,
            "epsilon": round(eps, 4),
            "buffer_size": len(self.buffer),
            "sample_time_s": round(sample_time, 3),
            **{k: float(v) for k, v in stats.items()},
        }

    # -- state / eval ----------------------------------------------------
    def get_state(self) -> Dict[str, Any]:
        from ray_tpu_torch.rl.utils import state_to_host

        return {
            "params": to_host(self.params),
            "target_params": to_host(self.target_params),
            "opt_state": state_to_host(self.optimizer),
            "iteration": self.iteration,
            "env_steps": self.env_steps,
            "gradient_steps": self.gradient_steps,
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        from ray_tpu_torch.rl.utils import load_state_

        load_state_(self.params, state["params"])
        load_state_(self.target_params, state["target_params"])
        load_state_(self.optimizer, state["opt_state"])
        self.iteration = state["iteration"]
        self.env_steps = state["env_steps"]
        self.gradient_steps = state["gradient_steps"]

    def compute_single_action(self, obs) -> int:
        with torch.no_grad():
            obs = torch.as_tensor(np.asarray(obs), device=self.device)[None]
            q = self._apply()(self.params, obs)
        return int(np.argmax(q[0].cpu().numpy()))

    def stop(self) -> None:
        for r in self.runners:
            try:
                ray_tpu_torch.get(r.close.remote(), timeout=10)
                ray_tpu_torch.kill(r)
            except Exception:
                pass
