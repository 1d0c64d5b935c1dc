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
losses so far to that step's report) and ``fail_at_step`` (the worker raises before that step when it did not
resume from a checkpoint: the failure a gang restart recovers from).

Each step reports ``step``, ``loss`` and ``step_ms`` (host clock, after a
device synchronise on the card); the last report also carries what the
worker saw: its devices, its process group's backend and world size, the
flash kernels' launches by route during its steps, and its peak device
memory.
"""

from __future__ import annotations

import os
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
    n = 0
    for i, batch in enumerate(batches):
        if i < start:  # consumed before the checkpoint this run resumed from
            continue
        if i == config.get("fail_at_step") and resumed is None:
            raise RuntimeError(f"injected worker failure before step {i}")
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        loss = float(loss)  # waits for the step
        if on_card:
            torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
        n += 1
        losses.append(loss)
        metrics = {"step": i, "loss": loss, "step_ms": step_ms}
        checkpoint = None
        if every and (i + 1) % every == 0:
            host = L.host_state(model, opt)  # a collective: every rank gathers
            if rank == 0:
                checkpoint = train.Checkpoint.from_dict(
                    {"state": host, "step": i + 1, "losses": list(losses)})
        train.report(metrics, checkpoint=checkpoint)
    train.report({
        "done": True, "steps_run": n, "rank": rank,
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "device_count": torch.cuda.device_count() if on_card else 0,
        "device_name": torch.cuda.get_device_name(0) if on_card else None,
        "backend": dist.get_backend(), "world_size": dist.get_world_size(),
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "launches": {fn.__name__: fn.launches for fn in A.KERNELS},
        "launches_by_route": {fn.__name__: dict(fn.route_launches) for fn in A.KERNELS},
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated() if on_card else None,
    })
