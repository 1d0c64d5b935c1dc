"""The port's serve layer end to end on the port's runtime, on the CPU: ports
of the cases of ``tests/test_serve.py`` that drive deployments, routing,
replica replacement, batching, streaming and the HTTP proxy, plus a GPU
lease through a deployment's ``ray_actor_options``.

One module-scoped cluster of the port's own processes; the box has no GPU,
so the head node declares ``{"GPU": 1}`` and the daemon hands that id out
as it would a real card's. Every test deletes its deployment in a
``finally``, so a failure does not leave replicas behind for the next, and
teardown checks with the port's reaper that no process survives.
"""

import json
import socket
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.serve.controller import CONTROLLER_NAME, get_or_create_controller
from ray_tpu_torch.util import state
from ray_tpu_torch.util.reaper import find_runtime_pids


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(head_resources={"GPU": 1}, num_cpus=4)
    controller = f"127.0.0.1:{c.controller_port}"
    try:
        rt.init(address=c.address)
        yield c
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
            c.shutdown()
    deadline = time.monotonic() + 10
    while find_runtime_pids(controller_addr=controller) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert find_runtime_pids(controller_addr=controller) == []


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _proxy():
    """The process's HTTP proxy (a per-process singleton: the first call
    picks the port)."""
    return serve.start_http(get_or_create_controller(), port=_free_port())


def _actor_env(handle, var="CUDA_VISIBLE_DEVICES"):
    """``var`` in the environment an actor's process was spawned with."""
    aid = handle._actor_id.hex()
    pid = next(a["pid"] for a in state.list_actors() if a["actor_id"] == aid)
    with open(f"/proc/{pid}/environ", "rb") as f:
        env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0") if b"=" in kv)
    val = env.get(var.encode())
    return None if val is None else val.decode()


def test_deploy_and_call(cluster):
    @serve.deployment(num_replicas=2, ray_actor_options={"num_cpus": 0.25})
    class Adder:
        def __init__(self, bias):
            self.bias = bias

        def __call__(self, x):
            return x + self.bias

        def bias_value(self):
            return self.bias

    try:
        handle = serve.run(Adder.bind(10))
        assert rt.get(handle.remote(5), timeout=60) == 15
        assert rt.get(handle.method("bias_value")(), timeout=30) == 10
        assert serve.status()["Adder"]["replicas"] == 2
    finally:
        serve.delete("Adder")


def test_requests_spread_across_replicas(cluster):
    @serve.deployment(num_replicas=2, ray_actor_options={"num_cpus": 0.25})
    class WhoAmI:
        def __call__(self, _):
            import os

            return os.getpid()

    try:
        handle = serve.run(WhoAmI.bind())
        pids = set(rt.get([handle.remote(None) for _ in range(20)], timeout=120))
        assert len(pids) == 2  # pow-2 routing reaches both replicas
    finally:
        serve.delete("WhoAmI")


def test_replica_failure_recovery(cluster):
    @serve.deployment(num_replicas=2, ray_actor_options={"num_cpus": 0.25})
    class Flaky:
        def __call__(self, x):
            return x

    try:
        handle = serve.run(Flaky.bind())
        replicas = rt.get(handle._controller.get_replicas.remote("Flaky"), timeout=30)
        rt.kill(replicas[0])
        st = rt.get(
            handle._controller.wait_status.remote(
                "Flaky", min_replicas=2, quiescent=True, timeout_s=120
            ),
            timeout=150,
        )
        assert st and st["replicas"] == 2, st
        # routing is at-most-once: a dispatch racing the death can land on
        # the dead actor, so allow a couple of retries
        result = None
        for _ in range(3):
            try:
                result = rt.get(handle.remote(7), timeout=60)
                break
            except rt.RayTpuError:
                time.sleep(1.0)
        assert result == 7
    finally:
        serve.delete("Flaky")


def test_http_proxy(cluster):
    @serve.deployment(ray_actor_options={"num_cpus": 0.25}, route_prefix="/sq")
    class Square:
        def __call__(self, x):
            return x * x

    try:
        serve.run(Square.bind())
        proxy = _proxy()
        req = urllib.request.Request(
            f"http://127.0.0.1:{proxy.port}/sq",
            data=json.dumps(7).encode(),
            headers={"Content-Type": "application/json"},
        )
        resp = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert resp["result"] == 49
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{proxy.port}/nope", timeout=30)
        assert e.value.code == 404
    finally:
        serve.delete("Square")


def test_dynamic_batching(cluster):
    """@serve.batch: concurrent requests coalesce into one replica call
    with a list argument."""

    @serve.deployment(max_concurrent_queries=16)
    class Batcher:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.2)
        async def handle(self, items):
            self.batch_sizes.append(len(items))
            return [i * 10 for i in items]

        async def __call__(self, x):
            return await self.handle(x)

        async def sizes(self):
            return self.batch_sizes

    try:
        handle = serve.run(Batcher.bind(), name="batcher")
        refs = [handle.remote(i) for i in range(8)]
        assert sorted(rt.get(refs, timeout=60)) == [i * 10 for i in range(8)]
        sizes = rt.get(handle.method("sizes")(), timeout=30)
        assert max(sizes) >= 4, sizes
        assert sum(sizes) == 8, sizes
    finally:
        serve.delete("Batcher")


def test_streaming_deployment_handle(cluster):
    @serve.deployment(num_replicas=1, ray_actor_options={"num_cpus": 0.25})
    class Tokens:
        def __call__(self, prompt):
            for i, word in enumerate(str(prompt).split()):
                yield {"index": i, "token": word}

    try:
        handle = serve.run(Tokens.bind(), name="tokens")
        out = list(handle.stream("the quick brown fox"))
        assert [o["token"] for o in out] == ["the", "quick", "brown", "fox"]
        assert [o["index"] for o in out] == [0, 1, 2, 3]
    finally:
        serve.delete("Tokens")


def test_streaming_http_sse(cluster):
    """``Accept: text/event-stream`` gets one ``data:`` event per item."""

    @serve.deployment(num_replicas=1, route_prefix="/sse",
                      ray_actor_options={"num_cpus": 0.25})
    class SSE:
        def __call__(self, body):
            for i in range(3):
                yield {"n": i}

    try:
        serve.run(SSE.bind(), name="sse")
        proxy = _proxy()
        req = urllib.request.Request(
            f"http://127.0.0.1:{proxy.port}/sse",
            data=b"{}",
            headers={"Accept": "text/event-stream", "Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.headers["Content-Type"].startswith("text/event-stream")
            raw = resp.read().decode()
        events = [json.loads(line[len("data: "):]) for line in raw.splitlines()
                  if line.startswith("data: ")]
        assert events == [{"n": 0}, {"n": 1}, {"n": 2}], raw
    finally:
        serve.delete("SSE")


def test_dispatch_retry_on_replica_death(cluster):
    """``handle.call()`` re-chooses when its dispatch races a replica kill."""

    @serve.deployment(num_replicas=2, ray_actor_options={"num_cpus": 0.25})
    class Sturdy:
        def __call__(self, x):
            return x * 2

    try:
        handle = serve.run(Sturdy.bind(), name="sturdy")
        assert handle.call(4, _timeout=60) == 8
        replicas = rt.get(handle._controller.get_replicas.remote("Sturdy"), timeout=30)
        rt.kill(replicas[0])
        for i in range(10):
            assert handle.call(i, _timeout=60) == i * 2
    finally:
        serve.delete("Sturdy")


def test_gpu_replica_gets_its_device_and_the_controller_none(cluster):
    """A ``num_gpus=1`` replica sees GPU 0, the serve controller (a CPU
    actor) sees no GPU, and the GPU goes back to the pool with the
    deployment."""

    @serve.deployment(ray_actor_options={"num_cpus": 0.25, "num_gpus": 1})
    class OnGpu:
        def __call__(self, _):
            import os

            return os.environ.get("CUDA_VISIBLE_DEVICES")

    try:
        handle = serve.run(OnGpu.bind(), name="on_gpu")
        assert rt.get(handle.remote(None), timeout=60) == "0"
        assert rt.available_resources().get("GPU", 0) == 0
        (replica,) = rt.get(handle._controller.get_replicas.remote("OnGpu"), timeout=30)
        assert _actor_env(replica) == "0"
        assert _actor_env(rt.get_actor(CONTROLLER_NAME)) == ""
    finally:
        serve.delete("OnGpu")
    deadline = time.monotonic() + 30
    while rt.available_resources().get("GPU", 0) != 1 and time.monotonic() < deadline:
        time.sleep(0.1)
    assert rt.available_resources().get("GPU", 0) == 1


def test_rolling_update_on_one_gpu_waits_for_the_lease(cluster):
    """Whole GPUs only, so a roll cannot surge onto the one GPU: the new
    version's replica stays pending while the old one serves, the
    controller frees the old one after its stuck-roll grace (30 s), and the
    new one then takes the GPU."""

    @serve.deployment(version="v1", ray_actor_options={"num_cpus": 0.25, "num_gpus": 1})
    class OneGpu:
        def __init__(self, tag):
            self.tag = tag

        def __call__(self, _):
            return self.tag

    try:
        handle = serve.run(OneGpu.bind("v1"), name="one_gpu")
        assert handle.call(0, _timeout=60) == "v1"
        t0 = time.monotonic()
        serve.run(OneGpu.options(version="v2").bind("v2"), name="one_gpu")
        assert handle.call(0, _timeout=60) == "v1"  # the old replica still serves
        st = rt.get(handle._controller.wait_status.remote(
            "OneGpu", min_replicas=1, quiescent=True, version="v2", timeout_s=120), timeout=150)
        waited = time.monotonic() - t0
        assert st and st["replicas"] == 1, st
        assert waited >= 30, waited  # no eviction before the grace
        assert handle.call(0, _timeout=60) == "v2"
    finally:
        serve.delete("OneGpu")
