"""Tiny deterministic test environments (CI stand-ins for Atari).

Reference test model: rllib's fake/random envs under ``rllib/env/tests``
— learning tests need an env whose optimal policy is discoverable in
seconds on CPU, with the same observation modality as the real target.
Use as ``env="ray_tpu_torch.rl.test_envs:TinyImageEnv"`` (the module:class
form resolves on any worker by import path).
"""

from __future__ import annotations

import numpy as np

try:
    import gymnasium as gym
    from gymnasium import spaces
except ImportError:  # pragma: no cover
    gym = None


class TinyImageEnv(gym.Env if gym else object):
    """An 8x8x3 uint8 image shows a target pixel in the left or right
    half; the agent must press 0 (left) or 1 (right). Reward +1 for the
    correct side, episode length 16 — optimal return 16, random ~8.
    The smallest env that genuinely requires READING the image."""

    metadata = {"render_modes": []}

    def __init__(self, size: int = 8, episode_len: int = 16, seed: int = 0):
        self.size = size
        self.episode_len = episode_len
        self.observation_space = spaces.Box(
            low=0, high=255, shape=(size, size, 3), dtype=np.uint8
        )
        self.action_space = spaces.Discrete(2)
        self._rng = np.random.default_rng(seed)
        self._t = 0
        self._side = 0

    def _obs(self) -> np.ndarray:
        img = np.zeros((self.size, self.size, 3), np.uint8)
        row = int(self._rng.integers(0, self.size))
        half = self.size // 2
        col = int(self._rng.integers(0, half))
        if self._side == 1:
            col += half
        img[row, col] = 255
        return img

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        self._side = int(self._rng.integers(0, 2))
        return self._obs(), {}

    def step(self, action):
        reward = 1.0 if int(action) == self._side else 0.0
        self._t += 1
        self._side = int(self._rng.integers(0, 2))
        terminated = False
        truncated = self._t >= self.episode_len
        return self._obs(), reward, terminated, truncated, {}
