"""Shared algorithm plumbing (PPO + IMPALA + DQN; port of ``ray_tpu.rl.utils``).

Reference: the pieces ``rllib/algorithms/algorithm.py`` provides to every
algorithm — env-space probing, the EnvRunnerGroup construction, greedy
evaluation actions — and the learners' param and optimizer state."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.rl.env_runner import EnvRunner
from ray_tpu_torch.rl.models import apply_mlp_policy, tree_leaves, tree_map


def _make_probe_env(env: str, env_config: Optional[Dict[str, Any]]):
    if ":" in env:
        from ray_tpu_torch.rl.env_runner import resolve_env_class

        return resolve_env_class(env)(**(env_config or {}))
    import gymnasium as gym

    return gym.make(env, **(env_config or {}))


def probe_env_spec(env: str, env_config: Optional[Dict[str, Any]]) -> Tuple[int, int]:
    """(obs_dim, num_actions) from one throwaway env instance."""
    shape, num_actions = probe_env_space(env, env_config)
    return int(np.prod(shape)), num_actions


def probe_env_space(env: str, env_config: Optional[Dict[str, Any]]) -> Tuple[tuple, int]:
    """(obs_shape, num_actions) — shape preserved for image obs (CNN)."""
    probe = _make_probe_env(env, env_config)
    shape = tuple(probe.observation_space.shape)
    num_actions = int(probe.action_space.n)
    probe.close()
    return shape, num_actions


def make_runners(config) -> List[Any]:
    """The EnvRunner gang from any config carrying env/num_env_runners/
    num_envs_per_runner/seed/env_config/runner_resources."""
    return [
        EnvRunner.options(
            num_cpus=config.runner_resources.get("CPU", 0.5),
            resources={
                k: v for k, v in config.runner_resources.items() if k != "CPU"
            }
            or None,
        ).remote(
            config.env,
            config.num_envs_per_runner,
            config.seed + 1000 * i,
            config.env_config,
        )
        for i in range(config.num_env_runners)
    ]


def on_device(params, device):
    """A copy of a param tree on ``device``, as leaves that require grad
    (drawn on the CPU first, so a seed gives the same values whichever
    device learns)."""
    return tree_map(lambda t: t.detach().to(device, copy=True).requires_grad_(), params)


def clone_params(params):
    """A copy that shares no storage with ``params``: JAX's target-network
    copy ``tree_map(lambda x: x, params)`` is safe only because JAX arrays
    are immutable, and an alias would follow every in-place optimizer step."""
    return tree_map(lambda t: t.detach().clone(), params)


def adam(params, lr: float):
    """``torch.optim.Adam`` over a param tree, at optax ``adam``'s defaults
    (b1 0.9, b2 0.999, eps 1e-8 added outside the square root)."""
    return torch.optim.Adam(tree_leaves(params), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def state_to_host(tree):
    """A tree of tensors and optimizers as numpy: a tensor as its array, an
    optimizer as its ``state_dict()`` with arrays in place of tensors."""
    def host(v):
        if isinstance(v, torch.optim.Optimizer):
            return state_to_host(v.state_dict())
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy().copy()
        return v

    return tree_map(host, tree)


def load_state_(tree, host) -> None:
    """``state_to_host``'s inverse, in place: each tensor of ``tree`` takes
    its array, each optimizer its state dict."""
    if isinstance(tree, torch.optim.Optimizer):
        tree.load_state_dict(tree_map(
            lambda v: torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray) else v, host))
    elif isinstance(tree, torch.Tensor):
        with torch.no_grad():
            tree.copy_(torch.from_numpy(np.array(host)))
    elif isinstance(tree, dict):
        for k in tree:
            load_state_(tree[k], host[k])
    else:
        for t, h in zip(tree, host, strict=True):
            load_state_(t, h)


def greedy_action(params, obs) -> int:
    """Deterministic evaluation action: the policy on the params' device
    (a numpy snapshot runs on the CPU)."""
    params = tree_map(
        lambda a: a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a)), params)
    device = tree_leaves(params)[0].device
    with torch.no_grad():
        logits, _ = apply_mlp_policy(
            params, torch.as_tensor(np.asarray(obs, np.float32), device=device)[None]
        )
    return int(np.argmax(logits[0].cpu().numpy()))
