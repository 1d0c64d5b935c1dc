"""StandardAutoscaler: the demand → node-type reconciler.

Reference: ``python/ray/autoscaler/_private/autoscaler.py`` (the update
loop) + ``resource_demand_scheduler.py`` (first-fit bin-packing of
pending resource shapes onto node types). Each pass:

1. snapshot demand from the controller (parked lease shapes, PENDING
   actors, PENDING placement-group bundles) + node utilization,
2. subtract what the LIVE cluster's spare capacity can absorb,
3. first-fit-decreasing pack the remainder onto node types (a TPU slice
   type contributes hosts x resources per launch) and launch,
4. terminate provider nodes idle past ``idle_timeout_s``.

TPU-aware: slices launch/terminate atomically — utilization is judged
per provider NODE (all hosts of a slice idle before any terminate).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.config import AutoscalerConfig, NodeTypeConfig
from ray_tpu_torch.autoscaler.provider import NodeProvider

logger = logging.getLogger(__name__)


def _fits(shape: Dict[str, float], capacity: Dict[str, float]) -> bool:
    return all(capacity.get(k, 0.0) >= v for k, v in shape.items() if v > 0)


def _subtract(capacity: Dict[str, float], shape: Dict[str, float]) -> None:
    for k, v in shape.items():
        if v > 0:
            capacity[k] = capacity.get(k, 0.0) - v


class StandardAutoscaler:
    def __init__(self, provider: NodeProvider, config: AutoscalerConfig, *, backend=None):
        self._provider = provider
        self._config = config
        self._backend = backend  # CoreWorker-ish (controller RPC access)
        self._idle_since: Dict[str, float] = {}  # provider node id -> ts
        self._stop = threading.Event()
        self._kick = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_stats: Dict[str, Any] = {}

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="autoscaler"
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._kick.set()  # unblock the interval wait
        if self._thread is not None:
            self._thread.join(timeout=5)

    def kick(self) -> None:
        """Run a reconcile pass NOW instead of at the next interval tick.

        Demand-side controllers (e.g. the serve controller raising a
        replica target on TTFT budget burn) call this so the node
        reconciler's share of autoscaler lag is one pass, not up to a
        full ``update_interval_s``."""
        self._kick.set()

    def stats(self) -> Dict[str, Any]:
        """Summary of the most recent reconcile pass (empty before the
        first): wall timestamp, pass duration, demand/unmet shape
        counts, launches by node type, and idle terminations."""
        return dict(self._last_stats)

    def _loop(self) -> None:
        while True:
            self._kick.wait(self._config.update_interval_s)
            self._kick.clear()
            if self._stop.is_set():
                return
            try:
                self.update()
            except Exception:  # noqa: BLE001 — keep reconciling
                logger.exception("autoscaler update failed")

    # -- one reconcile pass ---------------------------------------------
    def _demand(self) -> Dict[str, Any]:
        backend = self._backend
        if backend is None:
            from ray_tpu_torch.core.api import _global_worker

            backend = _global_worker().backend
        return backend.io.run(
            backend.controller.call("autoscaler_demand", timeout=10), timeout=15
        )

    def update(self) -> None:
        pass_t0 = time.monotonic()
        snap = self._demand()
        shapes: List[Dict[str, float]] = (
            list(snap["pending_tasks"])
            + list(snap["pending_actors"])
            + list(snap["pending_bundles"])
        )
        # Preemption-aware replacement: a DRAINING node's workload must
        # land somewhere else BEFORE the kill — count each draining
        # node's full capacity as demand so the replacement launches the
        # moment the warning arrives, not after the node dies and its
        # work re-queues (arXiv:2605.25645: replacement lead time
        # dominates effective goodput on spot slices).
        draining = [
            n for n in snap["nodes"] if n["alive"] and n.get("state") == "DRAINING"
        ]
        shapes.extend(dict(n["total"]) for n in draining)
        provider_nodes = self._provider.non_terminated_nodes()
        # SLICES are the unit: group host records by launch group
        groups: Dict[str, List[Dict[str, Any]]] = {}
        for r in provider_nodes:
            groups.setdefault(r.get("group", r["id"]), []).append(r)

        # 2. live spare capacity absorbs demand first (per-node fitting).
        # Draining nodes contribute NO spare capacity: nothing new may be
        # packed onto a node that is about to disappear.
        spare: List[Dict[str, float]] = [
            dict(n["available"])
            for n in snap["nodes"]
            if n["alive"] and n.get("state") != "DRAINING"
        ]
        unmet: List[Dict[str, float]] = []
        for shape in sorted(shapes, key=lambda s: -sum(s.values())):
            placed = False
            for cap in spare:
                if _fits(shape, cap):
                    _subtract(cap, shape)
                    placed = True
                    break
            if not placed:
                unmet.append(shape)

        # 3. pack unmet demand onto node types; launch. Counting is per
        # SLICE (launch group), not per host — max_workers bounds slices.
        # Groups whose every host is draining don't count against the
        # caps: their replacement must be launchable NOW, not after the
        # preempted slice finally dies and frees its slot.
        draining_ids = {n["node_id"] for n in draining}
        launches: List[NodeTypeConfig] = []
        counts: Dict[str, int] = {}
        active_groups = 0
        for grp in groups.values():
            if all(r.get("node_id_hex") in draining_ids for r in grp):
                continue
            active_groups += 1
            counts[grp[0]["node_type"]] = counts.get(grp[0]["node_type"], 0) + 1
        # Booting supply credit (reference resource_demand_scheduler's
        # "upcoming nodes"): provider nodes not yet in the controller
        # snapshot are capacity in flight — without seeding them here,
        # every reconcile pass during a node's boot re-launches for the
        # SAME unmet demand until the max_workers caps bite. Only nodes
        # that NEVER joined count (a snapshot row — alive or dead —
        # means joined; dead ones are losses, not boot-pending), and
        # the credit expires after boot_grace_s so a hung launch stops
        # suppressing replacements.
        known_ids = {n["node_id"] for n in snap["nodes"]}
        types_by_name = {t.name: t for t in self._config.node_types}
        now_wall = time.time()
        virtual: List[Dict[str, float]] = []
        for rec in provider_nodes:
            nid = rec.get("node_id_hex")
            if nid is not None and nid in known_ids:
                continue
            launched = rec.get("launched_at")
            if launched is not None and now_wall - launched > self._config.boot_grace_s:
                continue  # boot presumed failed
            nt = types_by_name.get(rec.get("node_type"))
            if nt is not None:
                virtual.append(dict(nt.resources))
        for shape in unmet:
            placed = False
            for cap in virtual:
                if _fits(shape, cap):
                    _subtract(cap, shape)
                    placed = True
                    break
            if placed:
                continue
            nt = self._pick_type(shape, counts, active_groups + len(launches))
            if nt is None:
                logger.warning("demand %s unschedulable on any node type", shape)
                continue
            counts[nt.name] = counts.get(nt.name, 0) + 1
            launches.append(nt)
            for _h in range(max(1, nt.hosts)):
                cap = dict(nt.resources)
                virtual.append(cap)
            # place this shape on the fresh capacity
            for cap in virtual:
                if _fits(shape, cap):
                    _subtract(cap, shape)
                    break
        for nt in launches:
            logger.info("scaling up: launching %s (%d host(s))", nt.name, nt.hosts)
            self._provider.create_node(nt)

        # 4. terminate idle slices (never below min_workers). A slice is
        # idle only when EVERY host is idle — half-terminating a TPU
        # slice would leave a meaningless remnant.
        now = time.monotonic()
        node_rows = {n["node_id"]: n for n in snap["nodes"]}
        min_by_type = {t.name: t.min_workers for t in self._config.node_types}
        terminated = 0
        for gid, members in groups.items():
            busy = bool(shapes)
            for rec in members:
                row = node_rows.get(rec.get("node_id_hex"))
                if row is None or not row["alive"]:
                    busy = True  # still joining (or lost): don't judge idle
                    break
                if any(
                    row["available"].get(k, 0.0) < v
                    for k, v in row["total"].items()
                ):
                    busy = True
                    break
            if busy:
                self._idle_since.pop(gid, None)
                continue
            first_idle = self._idle_since.setdefault(gid, now)
            if now - first_idle < self._config.idle_timeout_s:
                continue
            ntype = members[0]["node_type"]
            if counts.get(ntype, 0) <= min_by_type.get(ntype, 0):
                continue
            logger.info("scaling down: terminating idle slice %s", gid)
            counts[ntype] = counts.get(ntype, 1) - 1
            self._idle_since.pop(gid, None)
            terminated += 1
            for rec in members:
                self._provider.terminate_node(rec["id"])

        launched_by_type: Dict[str, int] = {}
        for nt in launches:
            launched_by_type[nt.name] = launched_by_type.get(nt.name, 0) + 1
        self._last_stats = {
            "ts": time.time(),
            "pass_duration_s": round(time.monotonic() - pass_t0, 6),
            "demand_shapes": len(shapes),
            "unmet_shapes": len(unmet),
            "launches": launched_by_type,
            "terminated_slices": terminated,
        }

    def _pick_type(
        self, shape: Dict[str, float], counts: Dict[str, int], total_slices: int
    ) -> Optional[NodeTypeConfig]:
        if total_slices >= self._config.max_workers:
            return None
        best: Optional[NodeTypeConfig] = None
        for nt in self._config.node_types:
            if counts.get(nt.name, 0) >= nt.max_workers:
                continue
            if not _fits(shape, nt.resources):
                continue
            # smallest type that fits (first-fit-decreasing flavor)
            if best is None or sum(nt.resources.values()) < sum(best.resources.values()):
                best = nt
        return best
