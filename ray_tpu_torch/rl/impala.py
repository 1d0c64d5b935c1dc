"""IMPALA: asynchronous sampling with V-trace off-policy correction (port
of ``ray_tpu.rl.impala``).

Reference: ``rllib/algorithms/impala/impala.py:143`` — EnvRunners sample
CONTINUOUSLY with slightly-stale weights; rollouts stream to the learner
as they arrive (no synchronous barrier like PPO); V-trace corrects for
the policy lag. Here the aggregation is the ready-set drain each
``train()`` pass and the learner is a V-trace update on the learner's
device (the card unless ``learner_platform`` names the CPU) — run
locally, or across a ``LearnerGroup`` gang (batch sharded over learners,
gradients averaged) when ``num_learners > 1``.
"""

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
class IMPALAConfig:
    env: str = "CartPole-v1"
    env_config: Optional[Dict[str, Any]] = None
    num_env_runners: int = 2
    num_envs_per_runner: int = 4
    rollout_fragment_length: int = 64
    gamma: float = 0.99
    vtrace_clip_rho: float = 1.0
    vtrace_clip_c: float = 1.0
    entropy_coeff: float = 0.01
    vf_coeff: float = 0.5
    lr: float = 5e-4
    hidden: tuple = (64, 64)
    seed: int = 0
    #: rollout fragments consumed (= learner updates) per train() call
    rollouts_per_iteration: int = 8
    #: learner gang size; >1 runs the update over a LearnerGroup (gloo on
    #: the CPU in tests, nccl over cards in production)
    num_learners: int = 1
    #: the learner's device: the card unless this names another ("cpu");
    #: the reference's default is "cpu"
    learner_platform: Optional[str] = None
    #: how long a collective of the learner gang may wait before it fails
    #: (``LearnerGroup(timeout_s=)``); None keeps torch's default
    learner_timeout_s: Optional[float] = None
    runner_resources: Dict[str, float] = field(default_factory=lambda: {"CPU": 0.5})

    def build(self) -> "IMPALA":
        return IMPALA(self)


def vtrace(values, rewards, dones, rhos, bootstrap, *, gamma: float, clip_rho: float,
           clip_c: float):
    """V-trace targets (IMPALA paper eq. 1) by a reversed loop over time.
    Shapes [B, T]; bootstrap [B]. Returns ``(vs, pg_adv)``, both detached
    (the reference's ``stop_gradient``s)."""
    values, rhos, bootstrap = values.detach(), rhos.detach(), bootstrap.detach()
    rho = torch.clamp(rhos, max=clip_rho)
    c = torch.clamp(rhos, max=clip_c)
    nonterminal = 1.0 - dones
    next_values = torch.cat([values[:, 1:], bootstrap[:, None]], dim=1)
    deltas = rho * (rewards + gamma * next_values * nonterminal - values)
    acc = torch.zeros_like(bootstrap)
    out = []
    for t in reversed(range(values.shape[1])):
        acc = deltas[:, t] + gamma * nonterminal[:, t] * c[:, t] * acc
        out.append(acc)
    vs = values + torch.stack(out[::-1], dim=1)
    next_vs = torch.cat([vs[:, 1:], bootstrap[:, None]], dim=1)
    pg_adv = rho * (rewards + gamma * next_vs * nonterminal - values)
    return vs, pg_adv


def _no_reduce(tensors) -> None:
    """A learner alone: its gradients are the gang's."""


def _make_vtrace_update(cfg: IMPALAConfig, obs_dim: int, num_actions: int):
    """Builds ``(init_state, update)``. ``init_state(device) -> (params,
    optimizer)``, the same values for a seed on every device;
    ``update(state, batch, mean_grads=_no_reduce) -> (state, stats)`` takes
    batch-major ``[B, T, ...]`` tensors (a gang shards envs, not time) and
    calls ``mean_grads`` on the gradients between the backward and the
    Adam step (a ``LearnerGroup`` passes its gang mean)."""

    def loss_fn(params, batch):
        B, T = batch["actions"].shape
        flat_obs = batch["obs"].reshape(B * T, -1)
        logits, values = apply_mlp_policy(params, flat_obs)
        logits = logits.reshape(B, T, -1)
        values = values.reshape(B, T)
        logp_all = F.log_softmax(logits, dim=-1)
        logp = logp_all.gather(-1, batch["actions"].long()[..., None])[..., 0]
        rhos = torch.exp(logp - batch["behavior_logp"])
        vs, pg_adv = vtrace(
            values, batch["rewards"], batch["dones"].float(), rhos, batch["bootstrap"],
            gamma=cfg.gamma, clip_rho=cfg.vtrace_clip_rho, clip_c=cfg.vtrace_clip_c,
        )
        pi_loss = -(logp * pg_adv).mean()
        vf_loss = ((values - vs) ** 2).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
        total = pi_loss + cfg.vf_coeff * vf_loss - cfg.entropy_coeff * entropy
        return total, (pi_loss, vf_loss, entropy)

    def update(state, batch, mean_grads=_no_reduce):
        params, optimizer = state
        optimizer.zero_grad(set_to_none=True)
        total, (pi_loss, vf_loss, entropy) = loss_fn(params, batch)
        total.backward()
        mean_grads([p.grad for g in optimizer.param_groups for p in g["params"]])
        optimizer.step()
        return state, {
            "loss": total.detach(),
            "pi_loss": pi_loss.detach(),
            "vf_loss": vf_loss.detach(),
            "entropy": entropy.detach(),
        }

    def init_state(device):
        from ray_tpu_torch.rl.utils import adam, on_device

        gen = torch.Generator().manual_seed(cfg.seed)
        params = on_device(init_mlp_policy(gen, obs_dim, num_actions, cfg.hidden), device)
        return (params, adam(params, cfg.lr))

    return init_state, update


class IMPALA:
    """Async sample → V-trace learn loop (Tune-trainable surface)."""

    def __init__(self, config: IMPALAConfig):
        from ray_tpu_torch.models.llama import resolve_device
        from ray_tpu_torch.rl.utils import make_runners, probe_env_spec

        self.config = config
        obs_dim, num_actions = probe_env_spec(config.env, config.env_config)

        init_state, update = _make_vtrace_update(config, obs_dim, num_actions)
        self._group = None
        if config.num_learners > 1:
            from ray_tpu_torch.rl.learner_group import LearnerGroup

            self._group = LearnerGroup(
                num_learners=config.num_learners,
                init_fn=init_state,
                update_builder=lambda: update,
                platform=config.learner_platform,
                timeout_s=config.learner_timeout_s,
            )
            self._state = None
        else:
            self.device = resolve_device(config.learner_platform)
            self._state = init_state(self.device)
            self._update = update
        self.iteration = 0
        self._recent_returns: List[float] = []

        self.runners = make_runners(config)
        #: runner index -> in-flight sample ref (the ASYNC loop: runners
        #: never wait for the learner)
        self._inflight: Dict[int, Any] = {}

    # -- weights ---------------------------------------------------------
    def _params(self):
        """A numpy snapshot of the params (the weight broadcast)."""
        if self._group is not None:
            return self._group.get_params()
        return to_host(self._state[0])

    def _dispatch(self, i: int, params) -> None:
        self._inflight[i] = self.runners[i].sample.remote(
            params, self.config.rollout_fragment_length
        )

    def learn(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One V-trace update on a batch-major batch, on the gang or here."""
        if self._group is not None:
            return self._group.update(batch)
        tbatch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        self._state, stats = self._update(self._state, tbatch)
        return {k: float(v) for k, v in stats.items()}

    # -- one training iteration -----------------------------------------
    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        params = self._params()
        for i in range(len(self.runners)):
            if i not in self._inflight:
                self._dispatch(i, params)

        stats: Dict[str, float] = {}
        steps = 0
        consumed = 0
        # consume a budget of fragments, one learner update each; the
        # runners stay busy throughout (async: a fragment is re-dispatched
        # the moment it's consumed, with the freshest weights)
        while consumed < cfg.rollouts_per_iteration:
            refs = list(self._inflight.values())
            ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=300)
            if not ready:
                # a hung EnvRunner must surface, not spin this loop forever
                raise ray_tpu_torch.GetTimeoutError(
                    "no rollout completed within 300s (hung env runner?)"
                )
            ready_set = {r.binary() for r in ready}
            more, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=0)
            ready_set |= {r.binary() for r in more}
            for i, ref in list(self._inflight.items()):
                if ref.binary() not in ready_set:
                    continue
                rollout = ray_tpu_torch.get(ref, timeout=300)
                del self._inflight[i]
                batch = self._to_batch(rollout)
                steps += batch["actions"].size
                stats = self.learn(batch)
                params = self._params()
                self._recent_returns.extend(rollout["episode_returns"])
                consumed += 1
                # IMPALA weight broadcast: staleness = one fragment
                self._dispatch(i, params)

        self.iteration += 1
        self._recent_returns = self._recent_returns[-100:]
        mean_return = (
            float(np.mean(self._recent_returns)) if self._recent_returns else 0.0
        )
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": mean_return,
            "num_env_steps_trained": steps,
            "iter_time_s": round(time.perf_counter() - t0, 3),
            **stats,
        }

    @staticmethod
    def _to_batch(rollout) -> Dict[str, np.ndarray]:
        """[T, N, ...] rollout → batch-major [N, T, ...] arrays (a gang
        shards on envs, never mid-trajectory)."""
        return {
            "obs": np.moveaxis(rollout["obs"], 0, 1).astype(np.float32),
            "actions": np.moveaxis(rollout["actions"], 0, 1).astype(np.int32),
            "behavior_logp": np.moveaxis(rollout["logp"], 0, 1).astype(np.float32),
            "rewards": np.moveaxis(rollout["rewards"], 0, 1).astype(np.float32),
            "dones": np.moveaxis(rollout["dones"], 0, 1).astype(np.float32),
            "bootstrap": rollout["last_values"].astype(np.float32),
        }

    # -- Tune/state surface ---------------------------------------------
    def get_state(self) -> Dict[str, Any]:
        from ray_tpu_torch.rl.utils import state_to_host

        state = self._group.get_state() if self._group is not None else state_to_host(self._state)
        return {"state": state, "iteration": self.iteration}

    def set_state(self, state: Dict[str, Any]) -> None:
        from ray_tpu_torch.rl.utils import load_state_

        if self._group is not None:
            self._group.set_state(state["state"])
        else:
            load_state_(self._state, state["state"])
        self.iteration = state["iteration"]

    def compute_single_action(self, obs) -> int:
        from ray_tpu_torch.rl.utils import greedy_action

        # one learner: the live params, on the learner's device
        return greedy_action(self._state[0] if self._group is None else self._group.get_params(),
                             obs)

    def stop(self) -> None:
        for r in self.runners:
            try:
                ray_tpu_torch.get(r.close.remote(), timeout=10)
                ray_tpu_torch.kill(r)
            except Exception:
                pass
        if self._group is not None:
            self._group.shutdown()
