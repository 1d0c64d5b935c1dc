"""The port's autoscaler on the port's own cluster, on the CPU: the 3 cases
of ``tests/test_autoscaler.py`` (demand-driven scale-up on the fake
provider, idle scale-down, the atomic two-host launch) and a GPU node
launched for a pending ``num_gpus=1`` task.

One module-scoped cluster (a 1-CPU head with no GPU: ``{"GPU": 0}`` turns
off detection, as on a machine with a card) serves every test; each test
builds its own ``StandardAutoscaler`` against the shared provider, and an
autouse fixture reaps the nodes a test leaves behind and waits until the
controller sees only the head.
"""

import os
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.autoscaler import (
    AutoscalerConfig,
    FakeMultiNodeProvider,
    NodeTypeConfig,
    StandardAutoscaler,
)
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util.reaper import find_runtime_pids, pid_alive


@pytest.fixture(scope="module")
def small_cluster():
    from ray_tpu_torch.core.config import GLOBAL_CONFIG

    # an autoscaled node's boot can outlast the default 30 s infeasible
    # patience on a loaded host; raised before Cluster() so every spawned
    # process gets it too
    old_patience = GLOBAL_CONFIG.infeasible_fail_after_s
    GLOBAL_CONFIG.infeasible_fail_after_s = 90.0
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        cluster = Cluster(head_resources={"GPU": 0}, num_cpus=1)
        controller = f"127.0.0.1:{cluster.controller_port}"
        rt.init(address=cluster.address)
        provider = FakeMultiNodeProvider(controller)
        try:
            yield cluster, provider
        finally:
            GLOBAL_CONFIG.infeasible_fail_after_s = old_patience
            try:
                provider.shutdown()
            finally:
                rt.shutdown()
                cluster.shutdown()
    deadline = time.monotonic() + 10
    while find_runtime_pids(controller_addr=controller) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert find_runtime_pids(controller_addr=controller) == []


@pytest.fixture(autouse=True)
def _reap_leftover_nodes(small_cluster):
    _cluster, provider = small_cluster
    yield
    for rec in provider.non_terminated_nodes():
        provider.terminate_node(rec["id"])
    _wait(lambda: sum(1 for n in rt.nodes() if n["Alive"]) == 1, timeout=60,
          msg="leftover autoscaled nodes should leave the cluster")


def _wait(pred, timeout=60, msg=""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.25)
    raise AssertionError(f"timed out: {msg}")


def test_scale_up_schedule_and_idle_terminate(small_cluster):
    """Infeasible-now work launches a fake node, the work schedules on it,
    and the node terminates once idle past the timeout."""
    _cluster, provider = small_cluster
    autoscaler = StandardAutoscaler(
        provider,
        AutoscalerConfig(node_types=[NodeTypeConfig("worker", {"CPU": 4}, max_workers=2)],
                         idle_timeout_s=2.0, update_interval_s=0.3),
    )
    autoscaler.start()
    try:

        @rt.remote(num_cpus=4)
        class Big:
            def ping(self):
                return "pong"

        a = Big.remote()  # the head has 1 CPU
        assert rt.get(a.ping.remote(), timeout=90) == "pong"
        assert len(provider.non_terminated_nodes()) >= 1
        del a
        _wait(lambda: len(provider.non_terminated_nodes()) == 0, timeout=60,
              msg="idle node should terminate")
    finally:
        autoscaler.stop()


def test_task_demand_scales_up(small_cluster):
    """Parked lease requests (queued tasks) also count as demand."""
    _cluster, provider = small_cluster
    autoscaler = StandardAutoscaler(
        provider,
        AutoscalerConfig(node_types=[NodeTypeConfig("worker", {"CPU": 4}, max_workers=1)],
                         idle_timeout_s=30.0, update_interval_s=0.3),
    )
    autoscaler.start()
    try:

        @rt.remote(num_cpus=3)
        def heavy():
            return 42

        assert rt.get(heavy.remote(), timeout=90) == 42
        assert len(provider.non_terminated_nodes()) == 1
    finally:
        autoscaler.stop()


def test_tpu_slice_launches_atomically(small_cluster):
    """A slice node type (hosts=2) launches both hosts in one scaling
    decision."""
    _cluster, provider = small_cluster
    autoscaler = StandardAutoscaler(
        provider,
        AutoscalerConfig(
            node_types=[NodeTypeConfig("v5e-slice", {"CPU": 1, "FAKETPU": 4},
                                       max_workers=1, hosts=2)],
            idle_timeout_s=60.0, update_interval_s=0.3),
    )
    autoscaler.start()
    try:

        @rt.remote(num_cpus=0, resources={"FAKETPU": 4})
        def on_slice():
            return "ok"

        assert rt.get(on_slice.remote(), timeout=120) == "ok"
        _wait(lambda: len(provider.non_terminated_nodes()) == 2, timeout=30,
              msg=f"atomic slice launch: {provider.non_terminated_nodes()}")
        assert len(provider.non_terminated_nodes()) == 2
        _wait(lambda: sum(1 for n in rt.nodes() if n["Alive"]) >= 3, timeout=60,
              msg="both slice hosts join the cluster")
    finally:
        autoscaler.stop()


def test_gpu_node_for_a_gpu_task(small_cluster):
    """A pending ``num_gpus=1`` task on the GPU-less head launches one node
    of type ``{"CPU": 1, "GPU": 1}``; its daemon owns GPU id 0, so the task
    runs under ``CUDA_VISIBLE_DEVICES="0"``. Once idle the node is
    terminated, and its daemon and the task's worker are gone."""
    _cluster, provider = small_cluster
    autoscaler = StandardAutoscaler(
        provider,
        AutoscalerConfig(node_types=[NodeTypeConfig("gpu", {"CPU": 1, "GPU": 1}, max_workers=1)],
                         idle_timeout_s=2.0, update_interval_s=0.3),
    )
    autoscaler.start()
    try:

        @rt.remote(num_gpus=1)
        def on_gpu():
            return os.environ.get("CUDA_VISIBLE_DEVICES"), os.getpid()

        visible, worker_pid = rt.get(on_gpu.remote(), timeout=90)
        assert visible == "0"
        nodes = provider.non_terminated_nodes()
        assert [n["node_type"] for n in nodes] == ["gpu"]
        daemon_pid = provider._nodes[nodes[0]["id"]]["proc"].pid
        _wait(lambda: not provider.non_terminated_nodes(), timeout=60,
              msg="the idle GPU node should terminate")
        _wait(lambda: not pid_alive(daemon_pid) and not pid_alive(worker_pid), timeout=30,
              msg="the node's daemon and worker should be gone")
    finally:
        autoscaler.stop()
