"""Checkpoints: directory handles + top-K retention.

Reference: ``python/ray/train/_checkpoint.py`` (Checkpoint = directory on
a filesystem), ``train/_internal/checkpoint_manager.py`` (top-K by score)
and ``train/_internal/storage.py`` (StorageContext path resolution).
Local/NFS/GCS-fuse paths only — no pyarrow.fs dependency; TPU pods mount
shared storage, which is the same assumption orbax makes.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional


class Checkpoint:
    """A directory handle (reference ``ray.train.Checkpoint``)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    # -- constructors ----------------------------------------------------
    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        """Convenience for small states (tests, Tune trials)."""
        d = tempfile.mkdtemp(prefix="ray_tpu_ckpt_")
        with open(os.path.join(d, "_dict_checkpoint.pkl"), "wb") as f:
            pickle.dump(data, f)
        return cls(d)

    # -- accessors -------------------------------------------------------
    def to_directory(self, path: Optional[str] = None) -> str:
        if path is None:
            return self.path
        os.makedirs(path, exist_ok=True)
        shutil.copytree(self.path, path, dirs_exist_ok=True)
        return path

    @contextmanager
    def as_directory(self):
        yield self.path

    def to_dict(self) -> Dict[str, Any]:
        with open(os.path.join(self.path, "_dict_checkpoint.pkl"), "rb") as f:
            return pickle.load(f)

    def __reduce__(self):
        return (Checkpoint, (self.path,))

    def __repr__(self) -> str:
        return f"Checkpoint({self.path})"


class CheckpointManager:
    """Registers reported checkpoints under ``{run_dir}/checkpoint_N`` and
    enforces ``num_to_keep`` (best-by-score or most-recent)."""

    def __init__(self, run_dir: str, num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None, score_order: str = "max"):
        self.run_dir = run_dir
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self._index = 0
        #: list of (path, metrics)
        self.registered: List[tuple] = []
        os.makedirs(run_dir, exist_ok=True)

    def register(self, checkpoint: Checkpoint, metrics: Dict[str, Any]) -> Checkpoint:
        """Move a worker-produced checkpoint into the run dir."""
        dest = os.path.join(self.run_dir, f"checkpoint_{self._index:06d}")
        self._index += 1
        src = os.path.abspath(checkpoint.path)
        if src != dest:
            staging_root = os.path.join(os.path.abspath(self.run_dir), "_staged")
            if src.startswith(staging_root + os.sep) and not os.path.exists(dest):
                # Session-staged copies are transport-only and already live
                # on the run_dir filesystem — a rename beats a second full
                # copy of a multi-GB checkpoint.
                shutil.move(src, dest)
            else:
                shutil.copytree(src, dest, dirs_exist_ok=True)
        final = Checkpoint(dest)
        self.registered.append((dest, dict(metrics)))
        self._write_manifest()
        self._enforce_retention()
        return final

    def latest(self) -> Optional[Checkpoint]:
        if not self.registered:
            return None
        return Checkpoint(self.registered[-1][0])

    def best(self) -> Optional[Checkpoint]:
        if not self.registered:
            return None
        if not self.score_attribute:
            return self.latest()
        scored = [r for r in self.registered if self.score_attribute in r[1]]
        if not scored:
            return self.latest()
        key = lambda r: r[1][self.score_attribute]  # noqa: E731
        pick = max(scored, key=key) if self.score_order == "max" else min(scored, key=key)
        return Checkpoint(pick[0])

    def _enforce_retention(self) -> None:
        if self.num_to_keep is None:
            return
        while len(self.registered) > self.num_to_keep:
            # Never delete the best checkpoint when scoring is configured.
            best = self.best()
            for i, (path, _) in enumerate(self.registered):
                if best is None or path != best.path:
                    victim = self.registered.pop(i)
                    shutil.rmtree(victim[0], ignore_errors=True)
                    break
            else:
                break
        self._write_manifest()

    def _write_manifest(self) -> None:
        manifest = {
            "updated_at": time.time(),
            "checkpoints": [
                {"path": p, "metrics": m} for p, m in self.registered
            ],
        }
        with open(os.path.join(self.run_dir, "checkpoints.json"), "w") as f:
            json.dump(manifest, f, indent=1)

    @classmethod
    def restore(cls, run_dir: str, **kwargs) -> "CheckpointManager":
        """Resume retention state from a previous run's manifest."""
        mgr = cls(run_dir, **kwargs)
        manifest_path = os.path.join(run_dir, "checkpoints.json")
        if os.path.exists(manifest_path):
            with open(manifest_path) as f:
                manifest = json.load(f)
            mgr.registered = [
                (c["path"], c["metrics"])
                for c in manifest.get("checkpoints", [])
                if os.path.isdir(c["path"])
            ]
            if mgr.registered:
                last = os.path.basename(mgr.registered[-1][0])
                try:
                    mgr._index = int(last.split("_")[-1]) + 1
                except ValueError:
                    mgr._index = len(mgr.registered)
        return mgr
