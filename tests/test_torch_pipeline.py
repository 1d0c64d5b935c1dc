"""The port's GPipe schedule (``ray_tpu_torch.parallel.pipeline``) on one
gloo group of 4 CPU processes over ``MeshSpec(stage=4)``, against the JAX
package's ``pipeline_apply`` on ``cpu_mesh_devices(8)[:4]`` in the test
process: the four cases of ``tests/test_pipeline.py``, and the stage axis
of one that the card runs.

The group is started once a test run (a module-scoped fixture whose
readings the xdist workers share through a lock file): the file runs
itself as each rank (``python tests/test_torch_pipeline.py --worker ...``),
runs every case and writes its readings; rank 0's come back here. Each
rank holds the full inputs as plain tensors (``shard_map_compat`` places
the stacked params over ``stage``).

Bounds (f32): outputs and the stacked gradients 1e-5 absolute against
the JAX pipeline (the JAX test holds its pipeline to the sequential
program at 1e-5, and the Llama blocks at 1e-4); the Llama blocks'
pipelined forward against the port's own layer loop 1e-6. On a stage axis of one
the pipeline runs each microbatch through the stage as the loop does,
with the same kernels on the same shapes, so it must equal the loop.
"""

import os
import pickle
import socket
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
LLAMA = dict(vocab_size=64, dim=32, n_layers=4, n_heads=4, n_kv_heads=4, mlp_hidden=64,
             max_seq_len=16)
JAX_TOL, LOOP_TOL = 1e-5, 1e-6


def _mlp_stage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def _llama_stage(cfg, cos, sin):
    from ray_tpu_torch.models import llama as tl

    def stage_fn(layer_params, x):
        p = types.SimpleNamespace(**layer_params)
        x = tl._attention_block(cfg, p, x, cos, sin)
        x, _aux = tl._mlp_block(cfg, p, x)
        return x

    return stage_fn


def _tensors(tree):
    from torch.utils._pytree import tree_map

    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _llama_readings(mesh, data) -> dict:
    """The Llama blocks, one layer per stage, 2 microbatches of 2: the
    pipeline and the port's own layer loop."""
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.parallel.pipeline import pipeline_apply, stack_stage_params

    cfg = tl.LlamaConfig(**LLAMA, attention_impl="xla")
    cos, sin = tl.rope_tables(cfg, 16)
    stage_fn = _llama_stage(cfg, cos, sin)
    layers = _tensors(data["llama_layers"])
    x = torch.from_numpy(data["llama_x"])
    out = pipeline_apply(mesh, stage_fn, stack_stage_params(layers), x.reshape(2, 2, 16, 32))
    loop = x
    for p in layers:
        loop = stage_fn(p, loop)
    return {"out": out.reshape(4, 16, 32).numpy(), "loop": loop.numpy()}


def _worker(rank: int, port: int, inputs: str, out: str) -> None:
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from ray_tpu_torch.parallel.pipeline import pipeline_apply, stack_stage_params

    torch.set_num_threads(1)
    with open(inputs, "rb") as f:
        data = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=WORLD)
    mesh = make_mesh(MeshSpec(stage=4), "cpu")
    readings = {}
    for case in ("sequential", "single"):
        stacked = stack_stage_params(_tensors(data[case]["stages"]))
        readings[case] = pipeline_apply(mesh, _mlp_stage, stacked,
                                        torch.from_numpy(data[case]["x"])).numpy()
    stacked = stack_stage_params(_tensors(data["grad"]["stages"]))
    for t in stacked.values():
        t.requires_grad_()
    y = pipeline_apply(mesh, _mlp_stage, stacked, torch.from_numpy(data["grad"]["x"]))
    (y ** 2).mean().backward()
    readings["grad"] = {k: t.grad.numpy() for k, t in stacked.items()}
    readings["llama"] = _llama_readings(mesh, data)
    dist.destroy_process_group()
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(readings, f)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The JAX test's inputs, as numpy."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl

    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    data = {
        "sequential": {
            "stages": [{"w": jax.random.normal(k, (16, 16)) * 0.5, "b": jnp.ones((16,)) * 0.01}
                       for k in keys],
            "x": jax.random.normal(jax.random.PRNGKey(1), (6, 8, 16)),  # [M, mb, d]
        },
        "single": {
            "stages": [{"w": jnp.eye(4) * (i + 1), "b": jnp.zeros(4)} for i in range(4)],
            "x": jnp.ones((1, 2, 4)),
        },
        "grad": {
            "stages": [{"w": jax.random.normal(jax.random.PRNGKey(i), (8, 8)) * 0.3,
                        "b": jnp.zeros((8,))} for i in range(4)],
            "x": jax.random.normal(jax.random.PRNGKey(9), (4, 4, 8)),
        },
    }
    cfg = jl.LlamaConfig(**LLAMA, attention_impl="xla")
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0, 64, jnp.int32)
    data["llama_layers"] = params["layers"]
    data["llama_x"] = params["embed"][tokens]  # [4, 16, 32]
    data = jax.tree_util.tree_map(np.asarray, data)
    path = tmp_path_factory.mktemp("pipeline") / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return str(path), data


def _once_per_run(request, tmp_path_factory, name: str, run) -> dict:
    """The readings ``run(out)`` writes to ``out``, made once per test run:
    under xdist the workers share the file of the first worker to take the
    lock (the inputs are seeded, so each worker's group would read the
    same), so one group of processes runs on the box, not one per worker."""
    import fcntl

    if hasattr(request.config, "workerinput"):
        root = tmp_path_factory.getbasetemp().parent
    else:
        root = tmp_path_factory.mktemp(name)
    out = root / f"{name}-readings.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            run(out)
    with open(out, "rb") as f:
        return pickle.load(f)


def _run_group(inputs_path: str, out: Path) -> None:
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, __file__, "--worker", str(r), str(port),
                               inputs_path, str(out)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    assert codes == [0] * WORLD, "\n".join(logs)[-4000:]


@pytest.fixture(scope="module")
def readings(request, inputs, tmp_path_factory):
    return _once_per_run(request, tmp_path_factory, "pipeline4",
                         lambda out: _run_group(inputs[0], out))


@pytest.fixture(scope="module")
def stage4_mesh():
    from ray_tpu.parallel.mesh import MeshSpec, cpu_mesh_devices, make_mesh

    return make_mesh(MeshSpec(stage=4), cpu_mesh_devices(8)[:4])


def _jax_pipeline(mesh, stages, x, stage_fn=None):
    import jax.numpy as jnp

    from ray_tpu.parallel.pipeline import pipeline_apply, stack_stage_params

    def mlp(params, x):
        return jnp.tanh(x @ params["w"] + params["b"])

    stacked = stack_stage_params([{k: jnp.asarray(v) for k, v in s.items()} for s in stages])
    return pipeline_apply(mesh, stage_fn or mlp, stacked, jnp.asarray(x))


def test_pipeline_matches_sequential(inputs, readings, stage4_mesh):
    """4-stage pipeline over 6 microbatches == the JAX pipeline (and so the
    sequential composition)."""
    case = inputs[1]["sequential"]
    ref = _jax_pipeline(stage4_mesh, case["stages"], case["x"])
    np.testing.assert_allclose(readings["sequential"], np.asarray(ref), atol=JAX_TOL, rtol=0)


def test_pipeline_single_microbatch(inputs, readings, stage4_mesh):
    case = inputs[1]["single"]
    ref = _jax_pipeline(stage4_mesh, case["stages"], case["x"])
    np.testing.assert_allclose(readings["single"], np.asarray(ref), atol=JAX_TOL, rtol=0)


def test_pipeline_differentiable(inputs, readings, stage4_mesh):
    """The stacked params' gradients of ``(out ** 2).mean()`` (every rank
    runs the backward's shifts) against ``jax.grad`` of the JAX pipeline."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.parallel.pipeline import pipeline_apply, stack_stage_params

    case = inputs[1]["grad"]
    stacked = stack_stage_params([{k: jnp.asarray(v) for k, v in s.items()}
                                  for s in case["stages"]])
    x = jnp.asarray(case["x"])

    def mlp(params, x):
        return jnp.tanh(x @ params["w"] + params["b"])

    def loss(p):
        return (pipeline_apply(stage4_mesh, mlp, p, x) ** 2).mean()

    ref = jax.jit(jax.grad(loss))(stacked)
    assert sorted(readings["grad"]) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(readings["grad"][k], np.asarray(ref[k]), atol=JAX_TOL, rtol=0,
                                   err_msg=k)


def test_pipeline_llama_blocks(inputs, readings, stage4_mesh):
    """Llama blocks as pipeline stages (one layer per stage, batch 4 as 2
    microbatches of 2): the port's pipelined forward against its own layer
    loop and against the JAX pipeline."""
    from ray_tpu.models import llama as jl

    cfg = jl.LlamaConfig(**LLAMA, attention_impl="xla")
    cos, sin = jl.rope_tables(cfg, 16)

    def stage_fn(layer_params, x):
        x = jl._attention_block(cfg, layer_params, x, cos, sin)
        x, _aux = jl._mlp_block(cfg, layer_params, x)
        return x

    data = inputs[1]
    ref = _jax_pipeline(stage4_mesh, data["llama_layers"], data["llama_x"].reshape(2, 2, 16, 32),
                        stage_fn).reshape(4, 16, 32)
    got = readings["llama"]
    np.testing.assert_allclose(got["out"], got["loop"], atol=LOOP_TOL, rtol=0)
    np.testing.assert_allclose(got["out"], np.asarray(ref), atol=JAX_TOL, rtol=0)


def test_pipeline_stage_axis_one(inputs):
    """A stage axis of one (a world-1 gloo group here; the card's nccl world
    1 in ``chip_smoke.py``) runs the whole schedule, each shift a copy on
    the one rank: all four Llama layers in the one stage, 2 microbatches.
    The forward equals the layer loop on each microbatch,
    and the gradients equal the loop's summed over the microbatches."""
    import torch.distributed as dist

    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from ray_tpu_torch.parallel.pipeline import pipeline_apply, stack_stage_params

    torch.set_num_threads(1)
    data = inputs[1]
    cfg = tl.LlamaConfig(**LLAMA, attention_impl="xla")
    cos, sin = tl.rope_tables(cfg, 16)
    layer_fn = _llama_stage(cfg, cos, sin)
    layers = _tensors(data["llama_layers"])

    def stage_fn(p, x):
        for lp in p["layers"]:
            x = layer_fn(lp, x)
        return x

    started = not dist.is_initialized()
    try:
        mesh = make_mesh(MeshSpec(), "cpu")
        stacked = stack_stage_params([{"layers": layers}])
        leaves = [t.requires_grad_() for lp in stacked["layers"] for t in lp.values()]
        micro = torch.tensor(data["llama_x"]).reshape(2, 2, 16, 32)
        out = pipeline_apply(mesh, stage_fn, stacked, micro)
        out.sum().backward()
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    ref_layers = [{k: v.clone().requires_grad_() for k, v in lp.items()} for lp in layers]
    ref = torch.stack([stage_fn({"layers": ref_layers}, m) for m in micro])
    ref.sum().backward()
    assert torch.equal(out.detach(), ref.detach())
    ref_grads = [t.grad for lp in ref_layers for t in lp.values()]
    for g, r in zip((t.grad[0] for t in leaves), ref_grads, strict=True):
        torch.testing.assert_close(g, r, atol=LOOP_TOL, rtol=0)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
