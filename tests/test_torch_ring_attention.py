"""The port's sequence-parallel attention (``ray_tpu_torch.ops.ring_attention``)
and the Llama with ``attention_impl="ring"|"ulysses"``, on one gloo group of
8 CPU processes, against the JAX package's functions run on
``cpu_mesh_devices(8)`` in the test process: a port of
``tests/test_ring_attention.py``'s cases.

The group is started once a test run (a module-scoped fixture whose
readings the xdist workers share): the file runs itself
as each rank (``python tests/test_torch_ring_attention.py --worker ...``),
builds the ``seq8`` mesh (``MeshSpec(seq=8)``) and the
``data2-seq2-tensor2`` mesh, runs every case on both and writes its
readings; rank 0's come back here. Each rank holds the full inputs: plain
tensors (read as replicated by ``shard_map_compat``), or in the
``*-dtensor`` cases DTensors placed as the ring's spec places them (batch
over data, heads over tensor, sequence over seq). The model under the rule
table with a sharded sequence runs in ``test_torch_sharded_step.py`` (a
3-axis mesh stalls DTensor's sharding propagation for minutes).

Bounds: attention outputs and the q/k/v gradients of ``(out ** 2).mean()``
1e-5 absolute (f32; the JAX test holds both to the dense oracle at 2e-5
and 3e-5); the Llama forward's logits 1e-4 absolute (the JAX test's bound
against the dense forward); the ring train step's losses rtol 2e-4 (the
bound of the sharded-step tests).
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
WORLD = 8
MESHES = {"seq8": {"seq": 8}, "mixed": {"data": 2, "seq": 2, "tensor": 2}}
#: case -> (impl, mesh, inputs, keyword arguments)
ATTN_CASES = {
    "ring-causal": ("ring", "seq8", "qkv", {"causal": True}),
    "ring-noncausal": ("ring", "seq8", "qkv", {"causal": False}),
    "ring-mixed": ("ring", "mixed", "qkv", {"causal": True}),
    "ring-mixed-dtensor": ("ring", "mixed", "qkv", {"causal": True}),
    "ring-gqa": ("ring", "seq8", "gqa_ring", {"causal": True, "kv_repeat": 4}),
    "ulysses-causal": ("ulysses", "seq8", "qkv", {"causal": True, "impl": "xla"}),
    "ulysses-noncausal": ("ulysses", "seq8", "qkv", {"causal": False, "impl": "xla"}),
    "ulysses-mixed-dtensor": ("ulysses", "mixed", "qkv", {"causal": True, "impl": "xla"}),
    "ulysses-gqa": ("ulysses", "seq8", "gqa_uly", {"causal": True, "impl": "xla"}),
}
LLAMA_BASE = dict(vocab_size=128, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, mlp_hidden=64,
                  max_seq_len=32)
#: the train step's impls, each on the mixed mesh without rules
TRAIN_IMPLS = ("ring", "ulysses")
STEPS, LR = 2, 1e-3


def _sharded_fn(impl):
    from ray_tpu_torch.ops.ring_attention import ring_attention_sharded, ulysses_attention_sharded

    return {"ring": ring_attention_sharded, "ulysses": ulysses_attention_sharded}[impl]


def _worker(rank: int, port: int, inputs: str, out: str) -> None:
    import torch.distributed as dist

    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.parallel import mesh as tmesh
    from ray_tpu_torch.parallel import sharding as tsh

    torch.set_num_threads(1)
    with open(inputs, "rb") as f:
        data = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=WORLD)
    meshes = {k: tmesh.make_mesh(tmesh.MeshSpec(**v), "cpu") for k, v in MESHES.items()}
    readings = {}
    for case, (impl, mesh, key, kw) in ATTN_CASES.items():
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in data[key])
        args = (q, k, v)
        if case.endswith("-dtensor"):
            from torch.distributed.tensor import DTensor, Replicate

            pmesh = tmesh.placement_mesh(meshes[mesh])
            placed = tsh.spec_placements(meshes[mesh], tsh.PartitionSpec(
                (tmesh.DATA, tmesh.FSDP), tmesh.TENSOR, tmesh.SEQUENCE, None))
            args = tuple(DTensor.from_local(t, pmesh, [Replicate()] * pmesh.ndim)
                         .redistribute(pmesh, placed) for t in args)
        o = _sharded_fn(impl)(*args, meshes[mesh], **kw)
        if case.endswith("-dtensor"):
            assert isinstance(o, DTensor) and tuple(o.placements) == tuple(placed)
            o = o.full_tensor()
        (o ** 2).mean().backward()
        readings[case] = {"out": o.detach().numpy(),
                          "grads": [t.grad.numpy() for t in (q, k, v)]}
    q, k, v = (torch.from_numpy(a) for a in data["indivisible"])
    try:
        _sharded_fn("ulysses")(q, k, v, meshes["seq8"], impl="xla")
        readings["indivisible"] = None
    except ValueError as e:
        readings["indivisible"] = str(e)

    toks = torch.from_numpy(data["llama_tokens"])
    for impl in ("ring", "ulysses"):
        cfg = tl.LlamaConfig(**LLAMA_BASE, attention_impl=impl)
        model = tl.init_params(cfg, 0, device="cpu")
        model.load_state_dict(tl.params_from_jax(data["llama_params"]))
        with torch.no_grad():
            readings[f"forward-{impl}"] = tl.forward(cfg, model, toks,
                                                     mesh=meshes["mixed"]).numpy()

    batch = {k: torch.from_numpy(v) for k, v in data["train_batch"].items()}
    for impl in TRAIN_IMPLS:
        cfg = tl.LlamaConfig.tiny(attention_impl=impl)
        model = tl.init_params(cfg, 0, device="cpu")
        model.load_state_dict(tl.params_from_jax(data["train_params"]))
        state = (model, tl.adamw(LR)(model.parameters()))
        step = tl.make_train_step(cfg, remat="selective", mesh=meshes["mixed"])
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, batch)
            losses.append(float(loss))
        readings[f"train-{impl}"] = losses
    dist.destroy_process_group()
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(readings, f)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _qkv(b, h, hkv, s, d, seed):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, n, s, d).astype(np.float32) for n in (h, hkv, hkv))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    import jax

    from ray_tpu.models import llama as jl

    jparams = jl.init_params(jl.LlamaConfig(**LLAMA_BASE, attention_impl="xla"),
                             jax.random.PRNGKey(0))
    tparams = jl.init_params(jl.LlamaConfig.tiny(), jax.random.PRNGKey(0))
    toks = np.random.RandomState(5).randint(0, 256, size=(4, 17)).astype(np.int64)
    data = {
        "qkv": _qkv(2, 8, 8, 64, 16, seed=0),
        "gqa_ring": _qkv(2, 8, 2, 64, 16, seed=3),
        "gqa_uly": _qkv(2, 16, 8, 64, 16, seed=4),
        "indivisible": _qkv(2, 4, 4, 64, 16, seed=0),
        "llama_params": jax.tree_util.tree_map(np.asarray, jparams),
        "llama_tokens": np.random.RandomState(1).randint(0, 128, size=(2, 32)).astype(np.int64),
        "train_params": jax.tree_util.tree_map(np.asarray, tparams),
        "train_batch": {"tokens": toks[:, :-1], "targets": toks[:, 1:]},
    }
    path = tmp_path_factory.mktemp("ring") / "inputs.pkl"
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
            logs.append(p.communicate(timeout=150)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    assert codes == [0] * WORLD, "\n".join(logs)[-4000:]


@pytest.fixture(scope="module")
def readings(request, inputs, tmp_path_factory):
    return _once_per_run(request, tmp_path_factory, "ring8",
                         lambda out: _run_group(inputs[0], out))


@pytest.fixture(scope="module")
def jax_meshes():
    from ray_tpu.parallel.mesh import MeshSpec, cpu_mesh_devices, make_mesh

    return {k: make_mesh(MeshSpec(**v), cpu_mesh_devices(8)) for k, v in MESHES.items()}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_matches_jax(case, inputs, readings, jax_meshes):
    """Output and q/k/v gradients of ``(out ** 2).mean()`` against the JAX
    function on the same mesh shape and inputs."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.ops.ring_attention import ring_attention_sharded, ulysses_attention_sharded

    impl, mesh, key, kw = ATTN_CASES[case]
    fn = {"ring": ring_attention_sharded, "ulysses": ulysses_attention_sharded}[impl]
    q, k, v = (jnp.asarray(a) for a in inputs[1][key])

    def loss(q, k, v):
        o = fn(q, k, v, jax_meshes[mesh], **kw)
        return (o ** 2).mean(), o

    (_, ref), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    got = readings[case]
    np.testing.assert_allclose(got["out"], np.asarray(ref), atol=1e-5)
    for name, g, r in zip("qkv", got["grads"], grads):
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-5, err_msg=name)


def test_ulysses_rejects_indivisible_heads(readings):
    assert readings["indivisible"] is not None and "divisible" in readings["indivisible"]


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_llama_forward_seq_parallel_matches_jax(impl, inputs, readings, jax_meshes):
    """The Llama forward with sequence-parallel attention over the
    data2-seq2-tensor2 mesh (mesh, no rules) against JAX's."""
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl

    cfg = jl.LlamaConfig(**LLAMA_BASE, attention_impl=impl)
    ref = jl.forward(cfg, inputs[1]["llama_params"], jnp.asarray(inputs[1]["llama_tokens"]),
                     mesh=jax_meshes["mixed"])
    np.testing.assert_allclose(readings[f"forward-{impl}"], np.asarray(ref), atol=1e-4)


def test_llama_seq_parallel_requires_mesh():
    from ray_tpu_torch.models import llama as tl

    torch.set_num_threads(1)
    cfg = tl.LlamaConfig.tiny(attention_impl="ring")
    model = tl.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="sequence-parallel"):
        tl.forward(cfg, model, torch.zeros((1, 16), dtype=torch.long))


@pytest.mark.parametrize("impl", TRAIN_IMPLS)
def test_llama_train_step_seq_parallel_matches_jax(impl, inputs, readings, jax_meshes):
    """2 steps of the port's step on the data2-seq2-tensor2 mesh (mesh, no
    rules), under selective remat, so the backward recomputes the
    rotations and all-to-alls, against the JAX ring step on the same mesh."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import llama as jl

    cfg = jl.LlamaConfig.tiny(attention_impl="ring")
    opt = optax.adamw(LR)
    params = jax.tree_util.tree_map(jnp.asarray, inputs[1]["train_params"])
    state = (params, opt.init(params))
    step = jl.make_train_step(cfg, opt, mesh=jax_meshes["mixed"], donate=False)
    batch = {k: jnp.asarray(v, jnp.int32) for k, v in inputs[1]["train_batch"].items()}
    ref = []
    for _ in range(STEPS):
        state, loss = step(state, batch)
        ref.append(float(loss))
    losses = readings[f"train-{impl}"]
    np.testing.assert_allclose(losses, ref, rtol=2e-4)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
