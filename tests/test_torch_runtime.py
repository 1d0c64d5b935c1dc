"""The port's runtime end to end on the CPU: tasks, actors, a streaming
generator, the node daemon's GPU pool and node events, on one
module-scoped cluster of the port's own processes.

The box has no GPU, so the head node is given ``{"GPU": 1}`` explicitly;
the daemon then hands that id out as it would a real card's
(``CUDA_VISIBLE_DEVICES``). The JAX suite's leak guard matches only the
reference's entry points, so teardown checks with the port's own reaper
that no process of this cluster survives.
"""

import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._host import SHM_PREFIX
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core.object_store import segment_name
from ray_tpu_torch.util.reaper import find_runtime_pids

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(head_resources={"GPU": 1}, num_cpus=4)
    controller = f"127.0.0.1:{c.controller_port}"
    try:
        rt.init(address=c.address)
        yield c
    finally:
        rt.shutdown()
        c.shutdown()
    deadline = time.monotonic() + 10
    while find_runtime_pids(controller_addr=controller) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert find_runtime_pids(controller_addr=controller) == []


@rt.remote
def _device_env(poison_cuda=False):
    """The worker's pid and CUDA visibility; with ``poison_cuda`` the
    process's torch keeps a device count of none, as after a failed
    ``torch.cuda.init()`` under ``CUDA_VISIBLE_DEVICES=""``, which must bar
    it from a GPU lease."""
    if poison_cuda:
        import torch

        torch.cuda._is_compiled = lambda: True
        torch._C._cuda_getDeviceCount = lambda: 0
    return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")


def _wait_leases_returned(timeout=10.0):
    """Until every lease went back to the daemon (the owner keeps an idle
    lease for ``lease_linger_s``), so the next lease pops a pooled worker."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        total, avail = rt.cluster_resources(), rt.available_resources()
        if all(avail.get(k, 0) == v for k, v in total.items()):
            return
        time.sleep(0.05)
    raise AssertionError(f"leases still held: {rt.available_resources()}")


def _pid_gone(pid, timeout=10.0):
    """The process exited (or is a zombie) within ``timeout``."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().split()[2] == "Z":
                    return True
        except OSError:
            return True
        time.sleep(0.05)
    return False


def test_task_actor_and_object(cluster):
    @rt.remote
    def add(x, y):
        return x + y

    @rt.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def inc(self, k=1):
            self.n += k
            return self.n

    ref = rt.put(list(range(5)))
    assert rt.get(add.remote(rt.get(ref), [5])) == [0, 1, 2, 3, 4, 5]
    c = Counter.remote(10)
    assert rt.get([c.inc.remote() for _ in range(3)]) == [11, 12, 13]
    rt.kill(c)


def test_host_files_stay_apart_from_the_reference(cluster):
    """The cluster's files lie under this process's TMPDIR and its shared
    memory carries the port's own prefix, so the reference runtime's sweeps
    and pool accounting (``/dev/shm/rt-pool-*``, ``/tmp/ray_tpu``) never
    see them."""
    assert cluster.session_dir.startswith(os.path.join(tempfile.gettempdir(), ""))
    assert SHM_PREFIX != "rt-" and not SHM_PREFIX.startswith("rt-")
    ref = rt.put(np.arange(1 << 18, dtype=np.int64))  # 2 MiB: held in shm
    name = segment_name(ref.id())
    assert name == SHM_PREFIX + ref.hex()
    assert os.path.exists(os.path.join("/dev/shm", name))
    np.testing.assert_array_equal(rt.get(ref), np.arange(1 << 18, dtype=np.int64))


def test_streaming_generator_consumed_before_completion(cluster):
    """Items are consumable while the task runs (port of
    ``test_streaming.py::test_streaming_consumes_before_completion``)."""

    @rt.remote(num_returns="streaming")
    def slow():
        for i in range(4):
            time.sleep(0.5)
            yield i

    t0 = time.time()
    it = iter(slow.remote())
    first = rt.get(next(it), timeout=60)
    t_first = time.time() - t0
    rest = [rt.get(r, timeout=60) for r in it]
    t_all = time.time() - t0
    assert first == 0 and rest == [1, 2, 3]
    assert t_first < t_all - 1.0, (t_first, t_all)


def test_stream_abandoned_by_gc_under_the_streams_lock(cluster):
    """A generator dropped into a reference cycle is finalised by whatever
    collection runs next, on whatever thread runs it, and its ``__del__``
    abandons its stream under the owner's streams lock. A collection that
    runs while that thread already holds the lock (an allocation inside
    ``create_stream`` or ``_on_stream_item``) must not deadlock it."""
    import gc

    from ray_tpu_torch.core import api

    @rt.remote(num_returns="streaming")
    def endless():
        i = 0
        while True:
            time.sleep(0.05)
            yield i
            i += 1

    backend = api._global_worker().backend
    gen = endless.remote()
    tid = gen._task_id
    assert rt.get(next(iter(gen)), timeout=60) == 0
    cycle = [gen]
    cycle.append(cycle)
    del gen, cycle
    lock = backend._streams_lock
    with lock:
        assert lock.acquire(timeout=1), "the streams lock is not re-entrant"
        lock.release()
        gc.collect()  # finalises the generator here, under the lock
        assert tid not in backend._streams
    with lock:
        assert tid not in backend._streams


def _worker_pids(cluster):
    return set(find_runtime_pids(("ray_tpu_torch.core.worker_main",),
                                 controller_addr=f"127.0.0.1:{cluster.controller_port}"))


def test_gpu_lease_promotes_a_pooled_worker(cluster):
    """A CPU task sees no GPU; a num_gpus=1 task then lands on a worker
    taken from the pool (one that was already running, not a cold start),
    promoted to GPU 0, which is retired after its lease and the GPU handed
    back. The pool may hold more idle workers than the CPU task's (an
    owner's spare lease returns its worker after the task's), and it hands
    out the one returned last, so the GPU task need not land on the CPU
    task's worker."""
    cpu_pid, cpu_env = rt.get(_device_env.remote())
    assert cpu_env == ""
    _wait_leases_returned()
    pooled = _worker_pids(cluster)  # no lease is held: all idle or actors
    assert cpu_pid in pooled
    gpu_pid, gpu_env = rt.get(_device_env.options(num_gpus=1).remote())
    assert gpu_env == "0" and gpu_pid in pooled
    _wait_leases_returned()  # the GPU is back in the pool
    assert _pid_gone(gpu_pid)  # GPU-bound: retired, not pooled
    assert rt.get(_device_env.remote())[1] == ""


def test_gpu_lease_refused_by_a_worker_with_cuda_initialised(cluster):
    poisoned_pid, _ = rt.get(_device_env.remote(poison_cuda=True))
    _wait_leases_returned()
    gpu_pid, gpu_env = rt.get(_device_env.options(num_gpus=1).remote())
    assert gpu_env == "0" and gpu_pid != poisoned_pid
    assert _pid_gone(poisoned_pid)  # refused the promotion: retired
    _wait_leases_returned()


def test_added_node_reaches_node_event_listener(cluster):
    from ray_tpu_torch.core import api

    events = []
    backend = api._global_worker().backend
    backend.add_node_event_listener(events.append)
    try:
        node = cluster.add_node(num_cpus=1, resources={"extra": 1})
        deadline = time.monotonic() + 30
        while not any(e.get("alive") for e in events) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert any(e.get("alive") for e in events), events

        @rt.remote(resources={"extra": 1})
        def where():
            return rt.get_runtime_context().get_node_id()

        assert rt.get(where.remote(), timeout=60) != rt.get_runtime_context().get_node_id()
        cluster.remove_node(node)
    finally:
        backend.remove_node_event_listener(events.append)


def test_import_loads_neither_torch_nor_jax():
    """Neither the package nor its serve layer (whose LLM deployment is
    reached lazily) loads torch or jax, or anything of ``ray_tpu``."""
    code = ("import sys, ray_tpu_torch, ray_tpu_torch.serve; "
            "print('torch' in sys.modules, 'jax' in sys.modules, 'ray_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False", "False"]


def test_stream_timing_separates_bursts():
    """``chip_smoke.py``'s stream timing: tokens of one chunk share an
    arrival time, so their zero gaps are counted apart, and TPOT (first to
    last token over the tokens after it) is what the coalescing leaves
    unbiased."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    # stream 0: bursts of 1, 3 and 1 tokens 60 ms apart; stream 1: 2 tokens
    # 80 ms apart, one at a time
    arrivals = [[0.0, 0.06, 0.06, 0.06, 0.12], [1.0, 1.08]]
    t = cs.stream_timing(arrivals)
    assert t["itl_s"]["n"] == 5 and t["itl_s"]["p50"] == pytest.approx(0.06)
    assert t["itl_gaps_in_bursts_share"] == pytest.approx(2 / 5)
    assert t["bursts"] == 5
    assert t["itl_between_bursts_s"]["n"] == 3
    assert t["itl_between_bursts_s"]["p50"] == pytest.approx(0.06)
    # TPOT 0.12 s / 4 for stream 0, 0.08 s for stream 1
    assert t["tpot_s"]["n"] == 2 and t["tpot_s"]["max"] == pytest.approx(0.08)
    assert t["tpot_s"]["p50"] == pytest.approx((0.03 + 0.08) / 2)
    steps = [(70.0, 0, 8), (50.0, 0, 4), (52.0, 0, 4), (140.0, 512, 3)]
    b = cs.step_breakdown(steps)
    assert b["with_prefill"] == {"n": 1, "p50": 140.0}
    assert b["decode_only"]["n"] == 3
    assert b["decode_only_by_batch"] == {4: {"n": 2, "p50": 51.0}, 8: {"n": 1, "p50": 70.0}}


class _Unpicklable:
    def __reduce__(self):
        raise RuntimeError("refuses to pickle")


@rt.remote
class _Echo:
    def echo(self, x):
        return x


def test_failed_actor_call_leaves_no_hole_in_the_callers_order(cluster):
    """An actor call whose arguments fail to serialize (or whose submission a
    signal cuts there: ``SystemExit`` from a SIGTERM handler) is never sent,
    so it takes no turn in the caller's order; the next call from the same
    handle runs. A stopped job's trainer waited out its 10 s shutdown hook
    on such a hole."""
    actor = _Echo.remote()
    assert rt.get(actor.echo.remote(1), timeout=60) == 1
    with pytest.raises(Exception, match="refuses to pickle"):
        actor.echo.remote(_Unpicklable())
    assert rt.get(actor.echo.remote(2), timeout=20) == 2
    rt.kill(actor)
