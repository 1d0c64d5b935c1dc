"""The port's ``ray_tpu_torch.data`` on the port's own cluster, on the CPU:
ports of the ``tests/test_data.py`` cases the trainer's ingest path
reaches, and ``iter_device_batches`` against the JAX package's on the same
host batches (the same order and values, and the same double-buffer
order: batch N+1's copy is issued before batch N is yielded)."""

import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
import ray_tpu_torch.data as rd
from ray_tpu.data import iterator as jit_
from ray_tpu_torch.data import iterator as tit

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cluster():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        rt.init(num_cpus=4)
        try:
            yield
        finally:
            rt.shutdown()


def test_range_count_take(cluster):
    ds = rd.range(1000)
    assert ds.count() == 1000
    assert ds.take(5) == [0, 1, 2, 3, 4]
    assert ds.schema() == {"value": "int64"}


def test_iter_batches_sizes(cluster):
    ds = rd.range(1000)
    sizes = [len(b["value"]) for b in ds.iter_batches(batch_size=300)]
    assert sizes == [300, 300, 300, 100]
    sizes = [len(b["value"]) for b in ds.iter_batches(batch_size=300, drop_last=True)]
    assert sizes == [300, 300, 300]


def test_limit_and_split(cluster):
    ds = rd.range(100)
    assert sorted(ds.limit(30).take_all()) == list(range(30))
    parts = ds.split(3)
    all_vals = sorted(v for p in parts for v in p.take_all())
    assert all_vals == list(range(100))
    assert abs(parts[0].count() - parts[1].count()) <= 67


def test_streaming_split_disjoint_and_complete(cluster):
    ds = rd.range(500)
    seen = []
    for s in ds.streaming_split(3):
        for b in s.iter_batches(batch_size=None):
            seen.extend(b["value"].tolist())
    assert sorted(seen) == list(range(500))
    assert len(seen) == len(set(seen))  # disjoint


def test_streaming_split_reiterable(cluster):
    splits = rd.range(300, block_size=50).streaming_split(2)
    for epoch in range(2):
        seen = []
        for s in splits:
            for b in s.iter_batches(batch_size=None):
                seen.extend(b["value"].tolist())
        assert sorted(seen) == list(range(300)), f"epoch {epoch}"


def test_streaming_split_equal(cluster):
    splits = rd.range(1000, block_size=300).streaming_split(4, equal=True)
    counts = [sum(len(b["value"]) for b in s.iter_batches(batch_size=None)) for s in splits]
    assert counts == [250, 250, 250, 250]


def test_trainer_ingests_dataset(cluster, tmp_path):
    """TorchTrainer + streaming_split: each rank consumes its disjoint shard
    via train.get_dataset_shard, here through ``iter_device_batches`` onto
    the CPU."""
    from ray_tpu_torch import train
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchBackendConfig, TorchTrainer

    def train_fn(config):
        ctx = train.get_context()
        shard = train.get_dataset_shard("train")
        assert shard is not None
        total = count = 0
        for batch in shard.iter_device_batches(batch_size=64, sharding="cpu"):
            assert isinstance(batch["value"], torch.Tensor)
            total += int(batch["value"].sum())
            count += len(batch["value"])
        train.report({"total": total, "count": count, "rank": ctx.get_world_rank()})

    ds = rd.range(1000, block_size=100)  # 10 blocks -> 5 per rank
    trainer = TorchTrainer(
        train_fn,
        train_loop_config={},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        backend_config=TorchBackendConfig(distributed=False, platform="cpu"),
        run_config=RunConfig(name="data-ingest", storage_path=str(tmp_path)),
        datasets={"train": ds},
    )
    result = trainer.fit()
    assert result.metrics["count"] == 500
    assert result.metrics_history


def test_early_abandonment_stops_prefetch(cluster):
    before = threading.active_count()
    for _ in range(5):
        ds = rd.range(10000, block_size=100)
        assert ds.take(3) == [0, 1, 2]
    time.sleep(1.0)  # let producer threads observe the stop flag
    after = threading.active_count()
    assert after - before < 5, (before, after)


# -- iter_device_batches against the JAX package ----------------------------


def host_batches(n=5, rows=3):
    rs = np.random.RandomState(0)
    return [{"tokens": rs.randint(0, 256, size=(rows, 8)), "w": rs.randn(rows).astype(np.float32)}
            for _ in range(n)]


def test_iter_device_batches_matches_jax():
    batches = host_batches()

    def split(b):
        return {"x": b["tokens"][:, :-1], "y": b["tokens"][:, 1:], "w": b["w"]}

    ours = list(tit.iter_device_batches(iter(batches), sharding="cpu", transform=split))
    ref = list(jit_.iter_device_batches(iter(batches), transform=split))
    assert len(ours) == len(ref) == len(batches)
    for a, b, host in zip(ours, ref, batches):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].device.type == "cpu"
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
            # the host dtype (JAX without x64 narrows int64 to int32)
            assert a[k].numpy().dtype == split(host)[k].dtype


def test_iter_device_batches_double_buffer_order():
    """Batch N+1's copy is issued before batch N reaches the caller, as in
    the JAX package."""

    def run(impl, **kw):
        log = []

        def transform(b):
            log.append(("put", int(b["i"][0])))
            return b

        for b in impl(iter([{"i": np.array([i])} for i in range(4)]), transform=transform, **kw):
            log.append(("yield", int(np.asarray(b["i"])[0])))
        return log

    ours = run(tit.iter_device_batches, sharding="cpu")
    assert ours == run(jit_.iter_device_batches)
    assert ours[:3] == [("put", 0), ("put", 1), ("yield", 0)]


def test_iter_device_batches_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(tit.iter_device_batches(iter(host_batches(1))))
