"""The port's ecosystem shims on the port's own cluster, on the CPU: the 3
cases of ``tests/test_util_shims.py`` (``ActorPool``, ``util.queue.Queue``
and the ``util.multiprocessing`` ``Pool``), on one module-scoped cluster
with one torch thread in each of its processes."""

import os
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.multiprocessing import Pool
from ray_tpu_torch.util.queue import Empty, Queue
from ray_tpu_torch.util.reaper import find_runtime_pids


@pytest.fixture(scope="module")
def cluster():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        rt.init(num_cpus=4)
        try:
            yield
        finally:
            rt.shutdown()
    deadline = time.monotonic() + 10
    while find_runtime_pids(spawner_pid=os.getpid()) and time.monotonic() < deadline:
        time.sleep(0.1)


def test_actor_pool_ordered_and_unordered(cluster):
    @rt.remote(num_cpus=0.5)
    class W:
        def work(self, x):
            import time

            time.sleep(0.01 * (x % 3))
            return x * 2

    pool = ActorPool([W.remote() for _ in range(2)])
    assert list(pool.map(lambda a, v: a.work.remote(v), range(8))) == [v * 2 for v in range(8)]
    out = sorted(pool.map_unordered(lambda a, v: a.work.remote(v), range(8)))
    assert out == [v * 2 for v in range(8)]


def test_queue_fifo_across_workers(cluster):
    q = Queue(maxsize=4)
    q.put("a")
    q.put("b")
    assert q.qsize() == 2
    assert q.get(timeout=10) == "a"

    @rt.remote(num_cpus=0.5)
    def producer(q):
        for i in range(3):
            q.put(i)
        return True

    assert rt.get(producer.remote(q), timeout=60)
    assert [q.get(timeout=10) for _ in range(4)] == ["b", 0, 1, 2]
    with pytest.raises(Empty):
        q.get_nowait()
    q.shutdown()


def test_multiprocessing_pool(cluster):
    def square(x):
        return x * x

    with Pool(2, ray_remote_args={"num_cpus": 0.5}) as p:
        assert p.map(square, range(10)) == [x * x for x in range(10)]
        assert sorted(p.imap_unordered(square, range(5))) == [0, 1, 4, 9, 16]
        assert p.apply_async(square, (7,)).get(timeout=60) == 49
        assert p.starmap(lambda a, b: a + b, [(1, 2), (3, 4)]) == [3, 7]
