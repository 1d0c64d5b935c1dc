"""Replay buffer for off-policy learning.

Reference: ``rllib/utils/replay_buffers/`` (EpisodeReplayBuffer used by
DQN/SAC). A flat circular numpy transition store — uniform sampling;
arrays preallocate on first add so image observations don't pay a
per-transition object overhead.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ReplayBuffer:
    def __init__(self, capacity: int, seed: Optional[int] = None):
        self.capacity = int(capacity)
        self._rng = np.random.default_rng(seed)
        self._storage: Dict[str, np.ndarray] = {}
        self._idx = 0
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        """Append a batch of transitions (leading dim = batch)."""
        n = len(next(iter(batch.values())))
        if not self._storage:
            for k, v in batch.items():
                v = np.asarray(v)
                self._storage[k] = np.zeros(
                    (self.capacity, *v.shape[1:]), dtype=v.dtype
                )
        for start in range(0, n, self.capacity):
            chunk = {k: np.asarray(v)[start : start + self.capacity] for k, v in batch.items()}
            m = len(next(iter(chunk.values())))
            end = self._idx + m
            for k, v in chunk.items():
                if end <= self.capacity:
                    self._storage[k][self._idx : end] = v
                else:
                    split = self.capacity - self._idx
                    self._storage[k][self._idx :] = v[:split]
                    self._storage[k][: end - self.capacity] = v[split:]
            self._idx = end % self.capacity
            self._size = min(self.capacity, self._size + m)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, size=batch_size)
        return {k: v[idx] for k, v in self._storage.items()}
