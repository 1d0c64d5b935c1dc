"""The port's ``TorchTrainer`` on the port's own cluster, on the CPU:
ports of the seven non-slow cases of ``tests/test_train.py`` and the three
cases of ``tests/test_train_distributed.py``, and a tiny Llama trained by a
2-worker gang under fsdp rules against the single-process step.

Workers are CPU actors (``ScalingConfig(use_gpu=False)``) and their process
group runs on gloo (``TorchBackendConfig(platform="cpu")``); on the card the
defaults give each worker a GPU and an nccl group. The cluster is made once
for the module, with one torch thread in each of its processes.

The Llama gang's losses are held to the single-process step on the same
global batches within rtol 2e-4, the JAX package's bound for a sharded
step against the unsharded one (``test_sharding_rules.py``).
"""

import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
import ray_tpu_torch.data as rd
from ray_tpu_torch import train
from ray_tpu_torch.parallel.mesh import MeshSpec
from ray_tpu_torch.train import (
    Checkpoint,
    CheckpointManager,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    TorchBackendConfig,
    TorchTrainer,
    TrainingFailedError,
)
from ray_tpu_torch.util.reaper import find_runtime_pids

torch.set_num_threads(1)


def cpu_workers(n):
    return ScalingConfig(num_workers=n, use_gpu=False)


@pytest.fixture(scope="module")
def cluster():
    import os

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


def _dp_train_fn(config):
    """Linear regression, data-parallel over the object store."""
    from ray_tpu_torch.parallel.collectives import CollectiveGroup

    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    group = (
        CollectiveGroup(f"train-{ctx.get_experiment_name()}", world, rank)
        if world > 1
        else None
    )
    rng = np.random.RandomState(100 + rank)
    w_true = np.array([2.0, -3.0])
    w = np.zeros(2)
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        state = ckpt.to_dict()
        w, start = state["w"], state["step"]
    for step in range(start, config["steps"]):
        X = rng.randn(32, 2)
        y = X @ w_true
        grad = -2 * X.T @ (y - X @ w) / 32
        if group is not None:
            grad = group.allreduce(grad, op="mean")
        w = w - 0.2 * grad
        loss = float(((y - X @ w) ** 2).mean())
        out_ckpt = None
        if rank == 0 and (step + 1) % 5 == 0:
            out_ckpt = Checkpoint.from_dict({"w": w, "step": step + 1})
        if config.get("crash_at") is not None and step == config["crash_at"] and ckpt is None:
            raise RuntimeError("injected worker failure")
        train.report({"loss": loss, "step": step}, checkpoint=out_ckpt)


# -- test_train.py ----------------------------------------------------------


def test_failure_restart_resumes_from_checkpoint(cluster, tmp_path):
    trainer = TorchTrainer(
        _dp_train_fn,
        train_loop_config={"steps": 10, "crash_at": 7},
        scaling_config=cpu_workers(1),
        backend_config=TorchBackendConfig(platform="cpu"),
        run_config=RunConfig(
            name="ft",
            storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=1),
        ),
    )
    result = trainer.fit()
    # crashed at step 7 on attempt 1 (checkpoint was at step 5), resumed
    # from step 5 and ran to completion
    assert result.metrics["step"] == 9
    assert result.checkpoint.to_dict()["step"] == 10


def test_failure_exhausts_max_failures(cluster, tmp_path):
    def always_crash(config):
        raise ValueError("boom")

    trainer = TorchTrainer(
        always_crash,
        train_loop_config={},
        scaling_config=cpu_workers(1),
        backend_config=TorchBackendConfig(platform="cpu"),
        run_config=RunConfig(name="crash", storage_path=str(tmp_path)),
    )
    with pytest.raises(TrainingFailedError, match="boom"):
        trainer.fit()


def test_checkpoint_manager_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "run"), num_to_keep=2,
                            score_attribute="acc", score_order="max")
    for i, acc in enumerate([0.1, 0.9, 0.3, 0.2]):
        mgr.register(Checkpoint.from_dict({"i": i}), {"acc": acc})
    assert len(mgr.registered) == 2
    assert mgr.best().to_dict()["i"] == 1
    assert mgr.latest().to_dict()["i"] == 3


def test_checkpoint_manager_restore(tmp_path):
    run = str(tmp_path / "run")
    mgr = CheckpointManager(run)
    mgr.register(Checkpoint.from_dict({"step": 1}), {"loss": 1.0})
    mgr2 = CheckpointManager.restore(run)
    assert mgr2.latest().to_dict()["step"] == 1
    mgr2.register(Checkpoint.from_dict({"step": 2}), {"loss": 0.5})
    assert mgr2.latest().to_dict()["step"] == 2


def test_mesh_and_sharding_rules_session_plumbing():
    """TorchBackendConfig.mesh_spec/sharding → context metadata →
    train.get_mesh()/get_sharding_rules(), after the rendezvous (a world-1
    gloo group here, which the backend's setup_fn would have joined)."""
    from dataclasses import asdict

    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import FSDP, mesh_axis_sizes
    from ray_tpu_torch.train.session import TrainContext, _end_session, _start_session

    ctx = TrainContext(
        metadata={"mesh_spec": asdict(MeshSpec(fsdp=-1)), "sharding_rules": "fsdp"}
    )
    _start_session(ctx)
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:0", world_size=1, rank=0)
    try:
        mesh = train.get_mesh()
        assert mesh is not None and mesh.device_type == "cpu"  # the group's device
        assert mesh_axis_sizes(mesh)[FSDP] == dist.get_world_size()  # -1 resolved
        rules = train.get_sharding_rules()
        assert rules["embed"] == FSDP and rules["batch"] is not None
        ctx.metadata.pop("mesh_spec")
        assert train.get_mesh() is None
        ctx.metadata["sharding_rules"] = "zigzag"
        with pytest.raises(ValueError, match="zigzag"):
            train.get_sharding_rules()
    finally:
        dist.destroy_process_group()
        _end_session()


def test_trainer_threads_mesh_spec_into_contexts(cluster, tmp_path):
    """The trainer delivers the SAME plan to every rank."""

    def loop(config=None):
        ctx = train.get_context()
        spec = ctx.metadata.get("mesh_spec")
        train.report(
            {
                "rank": ctx.get_world_rank(),
                "spec_fsdp": spec["fsdp"] if spec else None,
                "rules": ctx.metadata.get("sharding_rules"),
            }
        )

    trainer = TorchTrainer(
        loop,
        scaling_config=cpu_workers(2),
        backend_config=TorchBackendConfig(
            distributed=False, platform="cpu",
            mesh_spec=MeshSpec(fsdp=-1), sharding="fsdp",
        ),
        run_config=RunConfig(name="mesh-plumb", storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    assert result.metrics["spec_fsdp"] == -1
    assert result.metrics["rules"] == "fsdp"


def test_scaling_config_topology_bundles():
    """A worker holds one GPU by default (``use_gpu``), or only a CPU; a
    TPU pod-slice topology has no meaning on GPUs and raises."""
    sc = ScalingConfig(num_workers=2)
    assert sc.resolved_num_workers() == 2
    assert sc.bundles() == [{"CPU": 1.0, "GPU": 1.0}] * 2
    assert sc.pg_strategy() == "PACK"
    assert cpu_workers(3).bundles() == [{"CPU": 1.0}] * 3
    with pytest.raises(ValueError, match="TPU pod slice"):
        ScalingConfig(topology="v4-32").bundles()


# -- test_train_distributed.py ----------------------------------------------


def _dist_fn(config):
    """Runs in each worker AFTER init_process_group (setup_fn)."""
    import torch.distributed as dist

    ctx = train.get_context()
    world = ctx.get_world_size()
    assert dist.get_world_size() == world, (dist.get_world_size(), world)
    assert dist.get_rank() == ctx.get_world_rank()
    # a real cross-process collective: all_gather each rank's value
    out = [torch.zeros(1, dtype=torch.int32) for _ in range(world)]
    dist.all_gather(out, torch.tensor([ctx.get_world_rank()], dtype=torch.int32))
    assert sorted(int(v) for v in out) == list(range(world))
    train.report({"procs": dist.get_world_size(), "backend": dist.get_backend(),
                  "rank": ctx.get_world_rank()})


def test_two_process_torch_distributed(cluster, tmp_path):
    trainer = TorchTrainer(
        _dist_fn,
        train_loop_config={},
        scaling_config=cpu_workers(2),
        backend_config=TorchBackendConfig(platform="cpu"),
        run_config=RunConfig(name="dist-torch", storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    assert result.metrics["procs"] == 2
    assert result.metrics["backend"] == "gloo"


def _dist_ckpt_fn(config):
    import torch.distributed as dist

    ctx = train.get_context()
    assert dist.get_world_size() == ctx.get_world_size()
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        start = ckpt.to_dict()["step"]
    for step in range(start, 4):
        if step == 2 and train.get_checkpoint() is None:
            raise RuntimeError("boom at step 2 (first attempt)")
        dist.barrier()  # the group works after the restart too
        train.report(
            {"step": step, "procs": dist.get_world_size()},
            checkpoint=Checkpoint.from_dict({"step": step + 1})
            if ctx.get_world_rank() == 0
            else None,
        )


def test_distributed_worker_failure_restarts_gang(cluster, tmp_path):
    """The gang dies mid-training: it restarts from the last checkpoint and
    the process group re-initialises cleanly (a fresh rendezvous)."""
    trainer = TorchTrainer(
        _dist_ckpt_fn,
        train_loop_config={},
        scaling_config=cpu_workers(2),
        backend_config=TorchBackendConfig(platform="cpu"),
        run_config=RunConfig(
            name="dist-restart",
            storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=1),
        ),
    )
    result = trainer.fit()
    assert result.metrics["step"] == 3  # completed all steps post-restart
    assert result.metrics["procs"] == 2


def _slice_mesh_fn():
    from ray_tpu_torch.parallel.mesh import DATA, FSDP, mesh_axis_sizes, slice_topology_mesh

    one = mesh_axis_sizes(slice_topology_mesh(2, MeshSpec(fsdp=-1)))
    both = mesh_axis_sizes(slice_topology_mesh(1, MeshSpec(fsdp=-1)))
    train.report({"two_slices": [one[DATA], one[FSDP]], "one_slice": [both[DATA], both[FSDP]]})


def test_slice_topology_mesh(cluster, tmp_path):
    """Multi-slice mesh over the gang: the data axis spans slices, the
    rest stays inside a slice."""
    trainer = TorchTrainer(
        _slice_mesh_fn,
        scaling_config=cpu_workers(2),
        backend_config=TorchBackendConfig(platform="cpu"),
        run_config=RunConfig(name="slice-mesh", storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    assert result.metrics["two_slices"] == [2, 1]  # one data rank per slice
    assert result.metrics["one_slice"] == [1, 2]


# -- a tiny Llama through the trainer ----------------------------------------


def test_two_worker_llama_fsdp_matches_single_process(cluster, tmp_path):
    """A 2-worker gloo gang trains tiny Llama under fsdp rules with
    selective remat on its dataset shards, dies before step 3 on its first
    attempt and resumes from the step-2 checkpoint (model and optimizer
    state): the resumed losses equal the uninterrupted single-process step
    on the same global batches (rank 0's rows, then rank 1's)."""
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.tools.train_llama import llama_train_loop

    steps, local, seq = 5, 2, 16
    rows = np.random.RandomState(7).randint(0, 256, size=(steps * 2 * local, seq + 1))
    ds = rd.from_numpy(rows, block_size=local)  # rank r takes blocks r, r+2, ...
    trainer = TorchTrainer(
        llama_train_loop,
        train_loop_config={"model": {"preset": "tiny"}, "seed": 0, "lr": 1e-3,
                           "remat": "selective", "batch_size": local,
                           "checkpoint_every": 2, "fail_at_step": 3},
        scaling_config=cpu_workers(2),
        backend_config=TorchBackendConfig(platform="cpu", mesh_spec=MeshSpec(fsdp=-1),
                                          sharding="fsdp"),
        run_config=RunConfig(name="llama-fsdp", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1)),
        datasets={"train": ds},
    )
    result = trainer.fit()
    history = [m for m in result.metrics_history if "loss" in m]
    # the history is the last attempt's: it resumed at the step-2 checkpoint
    assert [m["step"] for m in history] == [2, 3, 4]
    assert result.checkpoint.to_dict()["step"] == 4
    done = result.metrics
    assert done["backend"] == "gloo" and done["world_size"] == 2 and done["steps_run"] == 3
    assert done["mesh"]["fsdp"] == 2

    cfg = tl.LlamaConfig.tiny()
    model = tl.init_params(cfg, 0, device="cpu")
    state = (model, tl.adamw(1e-3)(model.parameters()))
    step = tl.make_train_step(cfg)
    ref = []
    for i in range(steps):
        batch = torch.from_numpy(rows[2 * local * i: 2 * local * (i + 1)])
        state, loss = step(state, {"tokens": batch[:, :-1], "targets": batch[:, 1:]})
        ref.append(float(loss))
    np.testing.assert_allclose([m["loss"] for m in history], ref[2:], rtol=2e-4)
    # the first attempt's losses come through the checkpoint it resumed from
    np.testing.assert_allclose(result.checkpoint.to_dict()["losses"], ref[:4], rtol=2e-4)
