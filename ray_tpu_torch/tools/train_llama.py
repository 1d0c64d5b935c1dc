"""A Llama training loop for ``TorchTrainer``: the path a user of the
trainer takes, as the JAX package's README sets it out.

``TorchTrainer(llama_train_loop, train_loop_config={...},
backend_config=TorchBackendConfig(mesh_spec=MeshSpec(fsdp=-1),
sharding="fsdp"), datasets={"train": ds})``: each worker takes the gang's
mesh and rules (``train.get_mesh()``, ``train.get_sharding_rules()``),
builds the model on it (``init_sharded``), resumes from the trainer's
checkpoint when there is one, and runs the rule-constrained step
(``make_train_step(mesh=, rules=, remat=)``) on the batches of its dataset
shard (``get_dataset_shard("train").iter_device_batches``, a DTensor per
batch). ``ds`` holds one row of ``seq + 1`` tokens per sequence (column
``value``); a row's first ``seq`` tokens are the inputs, its last ``seq``
the targets.

Config keys: ``model`` (``LlamaConfig`` fields, with ``preset``
``"tiny"`` or ``"llama2_7b"`` and ``dtype`` named as a string), ``seed``,
``lr``, ``remat``, ``batch_size`` (rows per rank per step),
``checkpoint_every`` (steps; rank 0 attaches ``host_state`` and the
losses so far to that step's report), ``fail_at_step`` (the worker raises before that step when it did not
resume from a checkpoint: the failure a gang restart recovers from) and
``profile_step`` (on the card, rank 0 runs that step under
``torch.profiler`` and adds its device time, NCCL's kernels apart from the
rest, to the step's report as ``profile``).

Each step reports ``step``, ``loss`` and ``step_ms`` (host clock, after a
device synchronise on the card); the last report carries the run's losses
(``losses``, those before a resumed checkpoint included, and
``final_loss``: a Tune sweep over the trainer ranks trials by what
``fit()`` returns, which is this report), this run's ``step_ms_each``,
and what the worker saw: its
devices, its process group's backend and world size, the flash kernels'
launches by route during its steps, and its peak device memory.

As a program, the loop is a job to submit: ``python -m
ray_tpu_torch.tools.train_llama --config JSON --rows FILE.npy`` joins the
cluster named by ``RAY_TPU_ADDRESS`` (what a job's supervisor gives its
entrypoint), fits a ``TorchTrainer`` of one worker on ``--rows`` (a ``.npy``
array of token rows) and prints one JSON line for itself (its pid and
``CUDA_VISIBLE_DEVICES``), then one per report of the worker. The worker
leases a GPU and joins an nccl group, or with ``--platform cpu`` holds a CPU
and joins a gloo group. SIGTERM (a stopped job) ends the fit through
``SystemExit``, so the trainer shuts its gang down and the worker's GPU goes
back to the cluster before the program exits.
"""

from __future__ import annotations

import os
import sys
import time


def _config(model: dict):
    import torch

    from ray_tpu_torch.models import llama as L

    fields = dict(model)
    preset = fields.pop("preset", "tiny")
    if "dtype" in fields:
        fields["dtype"] = getattr(torch, fields["dtype"])
    return getattr(L.LlamaConfig, preset)(**fields)


def llama_train_loop(config: dict) -> None:
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.models import llama as L
    from ray_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    cfg = _config(config["model"])
    mesh, rules = train.get_mesh(), train.get_sharding_rules()
    rank = train.get_context().get_world_rank()
    model, opt = L.init_sharded(cfg, mesh, rules, config["seed"], L.adamw(config["lr"]))
    start, losses = 0, []
    resumed = train.get_checkpoint()
    if resumed is not None:
        saved = resumed.to_dict()
        L.load_host_state(model, opt, saved["state"])
        start, losses = saved["step"], saved["losses"]
    step = L.make_train_step(cfg, remat=config["remat"], mesh=mesh, rules=rules)
    on_card = mesh.device_type == "cuda"
    every = config.get("checkpoint_every")
    batches = train.get_dataset_shard("train").iter_device_batches(
        batch_size=config["batch_size"], sharding=(mesh, L.batch_sharding(mesh, rules)),
        transform=lambda b: {"tokens": b["value"][:, :-1], "targets": b["value"][:, 1:]})
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()  # this worker's steps start here
    state = (model, opt)
    n, step_ms_each = 0, []
    for i, batch in enumerate(batches):
        if i < start:  # consumed before the checkpoint this run resumed from
            continue
        if i == config.get("fail_at_step") and resumed is None:
            raise RuntimeError(f"injected worker failure before step {i}")
        profiler = None
        if on_card and rank == 0 and i == config.get("profile_step"):
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            profiler = torch.profiler.profile(activities=acts)
            torch.cuda.synchronize()
            profiler.__enter__()
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        loss = float(loss)  # waits for the step
        if on_card:
            torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
        n += 1
        losses.append(loss)
        step_ms_each.append(step_ms)
        metrics = {"step": i, "loss": loss, "step_ms": step_ms}
        if profiler is not None:
            profiler.__exit__(None, None, None)
            metrics["profile"] = device_split(profiler, step_ms)
        checkpoint = None
        if every and (i + 1) % every == 0:
            host = L.host_state(model, opt)  # a collective: every rank gathers
            if rank == 0:
                checkpoint = train.Checkpoint.from_dict(
                    {"state": host, "step": i + 1, "losses": list(losses)})
        train.report(metrics, checkpoint=checkpoint)
    train.report({
        "done": True, "steps_run": n, "rank": rank,
        "losses": list(losses), "final_loss": losses[-1] if losses else None,
        "step_ms_each": step_ms_each,
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "device_count": torch.cuda.device_count() if on_card else 0,
        "device_name": torch.cuda.get_device_name(0) if on_card else None,
        "backend": dist.get_backend(), "world_size": dist.get_world_size(),
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "launches": {fn.__name__: fn.launches for fn in A.KERNELS},
        "launches_by_route": {fn.__name__: dict(fn.route_launches) for fn in A.KERNELS},
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated() if on_card else None,
    })


def device_split(prof, wall_ms: float) -> dict:
    """A profiled step's device time (ms): NCCL's kernels, the rest, and
    their sum against the step's wall time (``tools/profile_train_step.py``
    counts kernels the same way). NCCL's kernels run on their own stream
    and may overlap the rest."""
    from ray_tpu_torch.tools.profile_train_step import _device_us

    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and _device_us(e) > 0
               and not getattr(e, "is_user_annotation", False) and "#" not in e.key]
    nccl = sum(_device_us(e) for e in kernels if "nccl" in e.key.lower()) / 1e3
    rest = sum(_device_us(e) for e in kernels if "nccl" not in e.key.lower()) / 1e3
    top = sorted(kernels, key=_device_us, reverse=True)[:8]
    return {"wall_ms": wall_ms, "nccl_ms": nccl, "compute_ms": rest, "device_ms": nccl + rest,
            "top": [{"kernel": e.key[:80], "ms": _device_us(e) / 1e3, "calls": e.count}
                    for e in top]}


def main(argv=None) -> int:
    import argparse
    import json
    import signal

    p = argparse.ArgumentParser(prog="python -m ray_tpu_torch.tools.train_llama")
    p.add_argument("--config", required=True, help="llama_train_loop's config, as JSON")
    p.add_argument("--rows", required=True, help=".npy array of token rows (seq + 1 each)")
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--name", default="train_llama")
    p.add_argument("--storage", default=None, help="the run's storage path")
    args = p.parse_args(argv)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(128 + signal.SIGTERM))

    import numpy as np

    import ray_tpu_torch as rt
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.parallel.mesh import MeshSpec
    # by its module's name, so the worker imports it (run with -m, this
    # file is __main__)
    from ray_tpu_torch.tools.train_llama import llama_train_loop as loop
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchBackendConfig, TorchTrainer

    config = json.loads(args.config)
    on_cpu = args.platform == "cpu"
    print(json.dumps({"entrypoint": {
        "pid": os.getpid(), "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}}),
        flush=True)
    rt.init()
    try:
        trainer = TorchTrainer(
            loop, train_loop_config=config,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=not on_cpu),
            backend_config=TorchBackendConfig(platform="cpu" if on_cpu else None,
                                              mesh_spec=MeshSpec(fsdp=-1), sharding="fsdp"),
            run_config=RunConfig(name=args.name, storage_path=args.storage),
            datasets={"train": rd.from_numpy(np.load(args.rows),
                                             block_size=config["batch_size"])})
        for metrics in trainer.fit().metrics_history:
            print(json.dumps(metrics, default=str), flush=True)
    finally:
        rt.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
