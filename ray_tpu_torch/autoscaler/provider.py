"""Node providers: how the autoscaler actually gets machines.

Reference: ``python/ray/autoscaler/node_provider.py`` (the ABC cloud
integrations implement) and ``_private/fake_multi_node/node_provider.py:236``
— a provider that launches "nodes" as LOCAL PROCESSES so the scaling
logic is testable with no cloud. Here the fake provider spawns real node
daemons (``cluster_backend.spawn_node``) against the live controller, so
scaled-up capacity genuinely schedules work."""

from __future__ import annotations

import threading
import time
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.config import NodeTypeConfig


class NodeProvider(ABC):
    """Launch/terminate nodes of configured types."""

    @abstractmethod
    def create_node(self, node_type: NodeTypeConfig) -> List[str]:
        """Launch ONE node of ``node_type`` (all its hosts, atomically
        for slices); returns provider node ids (one per host)."""

    @abstractmethod
    def terminate_node(self, provider_id: str) -> None: ...

    @abstractmethod
    def non_terminated_nodes(self) -> List[Dict[str, Any]]:
        """[{id, node_type, launched_at, node_id_hex?}] for live nodes."""


class FakeMultiNodeProvider(NodeProvider):
    """Nodes are local node-daemon processes joined to the controller —
    the load-bearing test double (everything above it is the real
    autoscaler against real scheduling)."""

    def __init__(self, controller_addr: str):
        self._controller_addr = controller_addr
        self._nodes: Dict[str, Dict[str, Any]] = {}
        self._seq = 0
        self._lock = threading.Lock()

    def create_node(self, node_type: NodeTypeConfig) -> List[str]:
        from ray_tpu_torch.core.cluster_backend import spawn_node

        with self._lock:
            self._seq += 1
            group = f"{node_type.name}-{self._seq}"
        ids = []
        for h in range(max(1, node_type.hosts)):
            proc = spawn_node(
                self._controller_addr,
                num_cpus=node_type.resources.get("CPU"),
                resources={
                    k: v for k, v in node_type.resources.items() if k != "CPU"
                },
                labels={"autoscaler-node-type": node_type.name},
            )
            with self._lock:
                pid = f"fake-{group}-h{h}"
                self._nodes[pid] = {
                    "id": pid,
                    # all hosts of one launch share a group: the slice is
                    # the unit of accounting AND termination
                    "group": group,
                    "node_type": node_type.name,
                    # wall clock: consumed by the autoscaler's boot-grace
                # check, which also uses time.time() — a monotonic stamp
                # compared against wall time would make every boot look
                # ancient and void the booting-supply credit
                "launched_at": time.time(),
                    "proc": proc,
                    "node_id_hex": getattr(proc, "node_id_hex", None),
                }
                ids.append(pid)
        return ids

    def terminate_node(self, provider_id: str) -> None:
        with self._lock:
            rec = self._nodes.pop(provider_id, None)
        if rec is None:
            return
        # SIGINT first: scale-down is an INTENTIONAL termination, not a
        # preemption — letting the SIGTERM drain protocol run would
        # self-report DRAINING, which the autoscaler counts as unmet
        # demand and replaces (terminate → replace → idle → terminate
        # oscillation). Same teardown-vs-drain split as Cluster.shutdown.
        import os
        import signal

        try:
            os.kill(rec["proc"].pid, signal.SIGINT)
        except OSError:
            pass
        # escalating group reap (util/reaper.py): the daemon AND its
        # workers go down, bounded, even if SIGTERM is ignored
        from ray_tpu_torch.util.reaper import reap_process

        reap_process(rec["proc"], group=True)

    def non_terminated_nodes(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [
                {k: v for k, v in rec.items() if k != "proc"}
                for rec in self._nodes.values()
            ]

    def shutdown(self) -> None:
        for pid in [r["id"] for r in self.non_terminated_nodes()]:
            self.terminate_node(pid)
