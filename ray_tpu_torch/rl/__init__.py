"""ray_tpu_torch.rl — reinforcement learning: EnvRunner actors + torch
learners (port of ``ray_tpu.rl``).

Reference: ``rllib/`` new API stack (Algorithm / EnvRunnerGroup /
LearnerGroup). Learners run on the card unless their config names the
CPU (``learner_platform="cpu"``; ``LearnerGroup(platform="cpu")``), env
runners on the CPU. Importing this package needs no ``gymnasium``: the
runners import it where they make an env."""

from ray_tpu_torch.rl.dqn import DQN, DQNConfig
from ray_tpu_torch.rl.env_runner import EnvRunner
from ray_tpu_torch.rl.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rl.learner_group import LearnerGroup
from ray_tpu_torch.rl.models import (
    apply_cnn_policy,
    apply_cnn_q,
    apply_mlp_policy,
    apply_mlp_q,
    init_cnn,
    init_mlp_policy,
    init_mlp_q,
)
from ray_tpu_torch.rl.ppo import PPO, PPOConfig
from ray_tpu_torch.rl.replay import ReplayBuffer

__all__ = [
    "DQN",
    "DQNConfig",
    "EnvRunner",
    "IMPALA",
    "IMPALAConfig",
    "LearnerGroup",
    "PPO",
    "PPOConfig",
    "ReplayBuffer",
    "apply_cnn_policy",
    "apply_cnn_q",
    "apply_mlp_policy",
    "apply_mlp_q",
    "init_cnn",
    "init_mlp_policy",
    "init_mlp_q",
]
