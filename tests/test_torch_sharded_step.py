"""The port's rule-constrained training step (``make_train_step(mesh=,
rules=, remat="selective")``) on gloo groups of CPU processes, against the
port's unsharded step and the JAX package's unsharded step on the same
params and batch.

Groups: 2 processes as ``data=2`` under ddp, ``fsdp=2`` under fsdp,
``tensor=2`` under tp, and ``seq=2`` under tp with ring and with Ulysses
attention (the sequence sharded over ``seq``); 4 processes as ``(data=2,
tensor=2)`` under tp, where DTensor nests the batch over two mesh dims, as
``tensor=4`` under tp, where the tiny config's 2 KV heads are fewer than
the tensor ranks (K/V are gathered and repeated to the 4 q heads), and as
``(data=2, expert=2)`` under tp on the tiny MoE config with capacity
factor 0.5, so that tokens drop and routing each rank's tokens apart (its
own capacity, its own arrival order) would show. Each group is started
once (a module-scoped fixture): the file runs itself as each rank
(``python tests/test_torch_sharded_step.py --worker ...``), loads the
JAX-initialised tiny Llama of each case's config (``params_from_jax``),
shards it, runs 3 steps per case and writes its readings; rank 0's
readings come back here (one group of each size a test run: the xdist
workers share its readings). The unsharded references run each case's config
with its attention impl dropped (ring and Ulysses compute the same
function as flash attention).

Bounds: losses rtol 2e-4, the bound of the JAX package's own sharded-step
test (``test_sharding_rules.py``). The first step's gradients, gathered,
1e-5 by relative norm per leaf against both unsharded steps (f32, the same
products summed in another order). The gathered params after 3 steps rtol
2e-4 with one AdamW step's size (the learning rate) absolute: AdamW
divides by sqrt(v), so an entry whose gradient is within rounding of zero
takes an update of up to the learning rate whose sign the summation order
decides (3.4e-4 measured on the CPU in one entry of ``w_gate``, between the
port's and the JAX unsharded steps as between the sharded and unsharded
ones). AdamW is blind to a gradient's scale, so the gradients are what
holds the reductions to the right sums.
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
STEPS, LR = 3, 1e-3
MOE = (("moe_experts", 4), ("moe_capacity_factor", 0.5))
#: (case id, world size, mesh axes, rules table, LlamaConfig.tiny overrides)
CASES = (
    ("data2-ddp", 2, {"data": 2}, "ddp", ()),
    ("fsdp2-fsdp", 2, {"fsdp": 2}, "fsdp", ()),
    ("tensor2-tp", 2, {"tensor": 2}, "tp", ()),
    ("seq2-tp-ring", 2, {"seq": 2}, "tp", (("attention_impl", "ring"),)),
    ("seq2-tp-ulysses", 2, {"seq": 2}, "tp", (("attention_impl", "ulysses"),)),
    ("data2-tensor2-tp", 4, {"data": 2, "tensor": 2}, "tp", ()),
    ("tensor4-tp", 4, {"tensor": 4}, "tp", ()),
    ("data2-expert2-tp-moe", 4, {"data": 2, "expert": 2}, "tp", MOE),
)


def _params_key(overrides) -> tuple:
    """The config overrides that change the params and the function: all
    but the attention impl."""
    return tuple(kv for kv in overrides if kv[0] != "attention_impl")


def _worker(rank: int, world: int, port: int, inputs: str, out: str) -> None:
    """One rank: every case of its world size, 3 selective-remat steps each."""
    import torch.distributed as dist

    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.parallel import mesh as tmesh
    from ray_tpu_torch.parallel import sharding as tsh

    torch.set_num_threads(1)
    with open(inputs, "rb") as f:
        data = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    batch = {k: torch.from_numpy(v) for k, v in data["batch"].items()}
    readings = {}
    for case, size, axes, table, overrides in CASES:
        if size != world:
            continue
        cfg = tl.LlamaConfig.tiny(**dict(overrides))
        mesh = tmesh.make_mesh(tmesh.MeshSpec(**axes), "cpu")
        rules = getattr(tsh, f"{table}_rules")()
        model = tl.init_params(cfg, 0, device="cpu")
        model.load_state_dict(tl.params_from_jax(data["params"][_params_key(overrides)]))
        tl.shard_model(cfg, model, mesh, rules)
        state = (model, tl.adamw(LR)(model.parameters()))
        loss = tl.next_token_loss(cfg, model, batch["tokens"], batch["targets"],
                                  remat="selective", mesh=mesh, rules=rules)
        names = [n.replace(".", "/") for n, _ in model.named_parameters()]
        grads = tsh.constrain_tree(
            dict(zip(names, torch.autograd.grad(loss, list(model.parameters())))), mesh,
            tl.partition_rules(cfg, rules))
        step = tl.make_train_step(cfg, remat="selective", mesh=mesh, rules=rules)
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, batch)
            losses.append(float(loss))
        readings[case] = {
            "losses": losses,
            "placements": {n: [str(p) for p in v.placements]
                           for n, v in model.named_parameters()},
            "placement_axes": list(tmesh.placement_mesh(mesh).mesh_dim_names),
            "params": {n: v.detach().full_tensor().numpy() for n, v in model.named_parameters()},
            "grads": {n.replace("/", "."): g.full_tensor().numpy() for n, g in grads.items()},
        }
        if table == "fsdp":
            placed = tsh.shard_params_fsdp(
                mesh, {"w1": np.zeros((512, 64), np.float32), "tiny": np.zeros((4,), np.float32)},
                min_size=1024)
            readings[case]["shard_params_fsdp"] = {k: [str(p) for p in v]
                                                   for k, v in placed.items()}
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
    """The JAX-initialised tiny params (numpy) of each case's config, and one
    seeded batch."""
    import jax

    from ray_tpu.models import llama as jl

    params = {}
    for key in {_params_key(c[4]) for c in CASES}:
        tree = jl.init_params(jl.LlamaConfig.tiny(**dict(key)), jax.random.PRNGKey(0))
        params[key] = jax.tree_util.tree_map(np.asarray, tree)
    toks = np.random.RandomState(1).randint(0, 256, size=(4, 17)).astype(np.int64)
    data = {"params": params, "batch": {"tokens": toks[:, :-1], "targets": toks[:, 1:]}}
    path = tmp_path_factory.mktemp("sharded_step") / "inputs.pkl"
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


def _run_group(world: int, inputs_path: str, out: Path) -> None:
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, __file__, "--worker", str(r), str(world), str(port),
                               inputs_path, str(out)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
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
    assert codes == [0] * world, "\n".join(logs)[-4000:]


@pytest.fixture(scope="module")
def world2(request, inputs, tmp_path_factory):
    return _once_per_run(request, tmp_path_factory, "world2",
                         lambda out: _run_group(2, inputs[0], out))


@pytest.fixture(scope="module")
def world4(request, inputs, tmp_path_factory):
    return _once_per_run(request, tmp_path_factory, "world4",
                         lambda out: _run_group(4, inputs[0], out))


@pytest.fixture
def readings(request):
    """The readings of the group the test's case runs in (each group is
    started only by a test process that runs one of its cases)."""
    callspec = getattr(request.node, "callspec", None)
    case = callspec.params["case"] if callspec else "fsdp2-fsdp"
    world = {c[0]: c[1] for c in CASES}[case]
    return request.getfixturevalue(f"world{world}")


@pytest.fixture(scope="module")
def reference_runs(inputs):
    """3 steps of the port's unsharded step and of the JAX step, per config
    (computed once each, on first use)."""
    cache: dict = {}

    def get(key):
        if key not in cache:
            cache[key] = _references(inputs[1], key)
        return cache[key]

    return get


@pytest.fixture
def references(request, reference_runs):
    """The unsharded references of the test's case's config."""
    callspec = getattr(request.node, "callspec", None)
    case = callspec.params["case"] if callspec else "fsdp2-fsdp"
    return reference_runs(_params_key({c[0]: c[4] for c in CASES}[case]))


def _references(data, key) -> dict:
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import llama as jl
    from ray_tpu_torch.models import llama as tl

    cfg = tl.LlamaConfig.tiny(**dict(key))
    model = tl.init_params(cfg, 0, device="cpu")
    model.load_state_dict(tl.params_from_jax(data["params"][key]))
    state = (model, tl.adamw(LR)(model.parameters()))
    step = tl.make_train_step(cfg)
    batch = {k: torch.from_numpy(v) for k, v in data["batch"].items()}
    tl.next_token_loss(cfg, model, batch["tokens"], batch["targets"]).backward()
    port_grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    port_losses = []
    for _ in range(STEPS):
        state, loss = step(state, batch)
        port_losses.append(float(loss))
    jcfg = jl.LlamaConfig.tiny(**dict(key))
    opt = optax.adamw(LR)
    jparams = jax.tree_util.tree_map(jnp.asarray, data["params"][key])
    jstate = (jparams, opt.init(jparams))
    jstep = jl.make_train_step(jcfg, opt, donate=False)
    jbatch = {k: jnp.asarray(v, jnp.int32) for k, v in data["batch"].items()}
    jgrads = jax.grad(lambda p: jl.next_token_loss(jcfg, p, jbatch["tokens"],
                                                  jbatch["targets"]))(jparams)
    jax_losses = []
    for _ in range(STEPS):
        jstate, loss = jstep(jstate, jbatch)
        jax_losses.append(float(loss))
    return {
        "port_losses": port_losses, "jax_losses": jax_losses,
        "port_grads": port_grads, "jax_grads": _flat(jgrads),
        "port_params": {n: p.detach().numpy() for n, p in model.named_parameters()},
        "jax_params": _flat(jstate[0]),
    }


def _flat(tree) -> dict:
    """A JAX Llama tree by the port's parameter names, as numpy."""
    out = {"embed": tree["embed"], "final_norm": tree["final_norm"], "lm_head": tree["lm_head"]}
    for i, layer in enumerate(tree["layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return {k: np.asarray(v) for k, v in out.items()}


CASE_IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("case", CASE_IDS)
def test_sharded_step_losses_match_unsharded(case, readings, references):
    losses = readings[case]["losses"]
    np.testing.assert_allclose(losses, references["port_losses"], rtol=2e-4)
    np.testing.assert_allclose(losses, references["jax_losses"], rtol=2e-4)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("case", CASE_IDS)
def test_sharded_grads_match_unsharded(case, readings, references):
    grads = readings[case]["grads"]
    assert sorted(grads) == sorted(references["port_grads"])
    for name, g in grads.items():
        for ref in (references["port_grads"], references["jax_grads"]):
            err = np.linalg.norm(g - ref[name]) / np.linalg.norm(ref[name])
            assert err < 1e-5, (name, err)


@pytest.mark.parametrize("case", CASE_IDS)
def test_sharded_step_params_match_unsharded(case, readings, references):
    params = readings[case]["params"]
    assert sorted(params) == sorted(references["port_params"])
    for name, value in params.items():
        for ref in (references["port_params"], references["jax_params"]):
            np.testing.assert_allclose(value, ref[name], rtol=2e-4, atol=LR, err_msg=name)


@pytest.mark.parametrize("case", CASE_IDS)
def test_param_placements_follow_the_jax_rule(case, readings):
    """Each param's DTensor placements are its JAX spec on the mesh's axes
    of size > 1: ``Shard(d)`` where the spec names the axis at dim d."""
    import jax

    from ray_tpu.models import llama as jl
    from ray_tpu.parallel import sharding as jsh

    table = {c[0]: c[3] for c in CASES}[case]
    jcfg = jl.LlamaConfig.tiny(**dict(_params_key({c[0]: c[4] for c in CASES}[case])))
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    specs = jsh.match_partition_rules(
        jl.partition_rules(jcfg, getattr(jsh, f"{table}_rules")()), jparams)
    paths = jsh.tree_path_names(specs)
    leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    axes = readings[case]["placement_axes"]
    got = readings[case]["placements"]
    assert sorted(got) == sorted(p.replace("/", ".") for p in paths)
    for path, spec in zip(paths, leaves):
        dims = {}
        for d, entry in enumerate(spec):
            for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
                dims[a] = d
        want = [f"S({dims[a]})" if a in dims else "R" for a in axes]
        assert got[path.replace("/", ".")] == want, path


def test_shard_params_fsdp(readings):
    """A ``fsdp=2`` mesh: the largest divisible dim of a big leaf shards,
    a leaf under ``min_size`` replicates."""
    placed = readings["fsdp2-fsdp"]["shard_params_fsdp"]
    assert placed == {"w1": ["S(0)"], "tiny": ["R"]}


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _rank, _world, _port = (int(a) for a in sys.argv[2:5])
    _worker(_rank, _world, _port, sys.argv[5], sys.argv[6])
