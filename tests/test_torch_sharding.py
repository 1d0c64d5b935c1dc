"""The port's sharding rules and selective remat (``ray_tpu_torch.parallel``,
``ray_tpu_torch.models.llama``) against the JAX package, on the CPU, in one
process.

Ports of ``test_sharding_rules.py``'s rule-matching and remat cases and of
``test_parallel.py``'s spec and table cases, plus cross-checks: every
param's mesh axes per dim equal the JAX ``match_partition_rules`` spec for
the same path under each table, and the selective-remat forward and
gradients equal the JAX ones on the same weights (``params_from_jax``).

Tolerances: logits 1e-4 absolute and loss 1e-5 relative, as
``test_torch_llama.py`` holds the unconstrained model (f32, another
summation order in every matmul and softmax); each gradient leaf 1e-5 by
relative norm (the same f32 arithmetic; ~1e-7 measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from ray_tpu.models import llama as jl
from ray_tpu.parallel import sharding as jsh
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import sharding as tsh
from ray_tpu_torch.parallel.sharding import PartitionSpec as P

torch.set_num_threads(1)

TABLES = ("ddp", "fsdp", "tp")


def rules_of(mod, name):
    return getattr(mod, f"{name}_rules")()


@pytest.fixture(scope="module")
def jparams():
    return jl.init_params(jl.LlamaConfig.tiny(), jax.random.PRNGKey(0))


def torch_model(jparams):
    model = tl.init_params(tl.LlamaConfig.tiny(), 0, device="cpu")
    model.load_state_dict(tl.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    return model


def tokens(shape, vocab, seed):
    return np.random.RandomState(seed).randint(0, vocab, size=shape).astype(np.int32)


# -- match_partition_rules units (test_sharding_rules.py) -------------------


def test_match_rules_scalar_skip_and_match():
    tree = {
        "layers": [{"wq": np.zeros((4, 8)), "count": np.zeros(())}],
        "one": np.zeros((1,)),
    }
    specs = tsh.match_partition_rules([(r"wq$", P("fsdp", "tensor"))], tree)
    assert specs["layers"][0]["wq"] == P("fsdp", "tensor")
    # scalar and single-element leaves never consult the rules
    assert specs["layers"][0]["count"] == P()
    assert specs["one"] == P()
    ref = jsh.match_partition_rules([(r"wq$", JP("fsdp", "tensor"))], tree)
    assert tuple(ref["layers"][0]["wq"]) == tuple(specs["layers"][0]["wq"])


def test_match_rules_no_rule_found_raises():
    with pytest.raises(ValueError, match="no partition rule"):
        tsh.match_partition_rules([(r"wq$", P())], {"wz": np.zeros((4, 4))})


def test_match_rules_override_precedence_first_wins():
    tree = {"a": {"wq": np.zeros((4, 8))}, "b": {"wq": np.zeros((4, 8))}}
    specs = tsh.match_partition_rules(
        [(r"a/wq$", P("tensor", None)), (r"wq$", P("fsdp", None))], tree
    )
    assert specs["a"]["wq"] == P("tensor", None)
    assert specs["b"]["wq"] == P("fsdp", None)
    specs = tsh.match_partition_rules(
        [(r"wq$", P("fsdp", None)), (r"a/wq$", P("tensor", None))], tree
    )
    assert specs["a"]["wq"] == P("fsdp", None)


def test_match_rules_rank_reduced_leaf_replicates():
    tree = {"v_row": {"wq": np.zeros((8,))}, "full": {"wq": np.zeros((8, 4))}}
    specs = tsh.match_partition_rules([(r"wq$", P("fsdp", "tensor"))], tree)
    assert specs["v_row"]["wq"] == P()
    assert specs["full"]["wq"] == P("fsdp", "tensor")


def test_llama_rules_cover_params_grads_and_opt_state():
    """One regex table covers the module's params, its grads and the AdamW
    state named after them (``optimizer_state``; the scalar ``step`` is
    skipped), and the mirrored leaves land on the param's spec."""
    cfg = tl.LlamaConfig.tiny()
    model = tl.init_params(cfg, 0, device="cpu")
    opt = tl.adamw(1e-3)(model.parameters())
    toks = torch.from_numpy(tokens((2, 16), cfg.vocab_size, seed=3))
    tl.make_train_step(cfg)((model, opt), {"tokens": toks, "targets": toks})
    prules = tl.partition_rules(cfg, tsh.tp_rules())
    specs_p = tsh.match_partition_rules(prules, model)  # raises on any gap
    grads = {n.replace(".", "/"): p.grad for n, p in model.named_parameters()}
    assert tsh.match_partition_rules(prules, grads) == specs_p
    state = tsh.optimizer_state(model, opt)
    assert set(state) == {"step", "exp_avg", "exp_avg_sq"}
    specs_o = tsh.match_partition_rules(prules, state)
    names = tsh.tree_path_names(specs_o)
    leaves = tsh.tree_leaves(specs_o)
    wq_specs = {n: s for n, s in zip(names, leaves) if n.endswith("wq")}
    assert sorted(wq_specs) == sorted(f"{k}/layers/{i}/wq" for k in state
                                      for i in range(cfg.n_layers))
    for name, spec in wq_specs.items():
        want = P() if name.startswith("step/") else specs_p["layers/0/wq"]
        assert spec == want, name


# -- rule tables and per-param specs against the JAX package ---------------


def test_mesh_spec_resolve():
    spec = tmesh.MeshSpec(fsdp=-1, tensor=2).resolve(8)
    assert spec.fsdp == 4 and spec.tensor == 2
    with pytest.raises(ValueError):
        tmesh.MeshSpec(fsdp=3).resolve(8)
    with pytest.raises(ValueError):
        tmesh.MeshSpec(fsdp=-1, tensor=-1).resolve(8)


def test_rules_tables():
    assert tsh.ddp_rules()["embed"] is None
    assert tsh.fsdp_rules()["embed"] == tmesh.FSDP
    assert tsh.tp_rules()["mlp"] == tmesh.TENSOR
    for name in TABLES:
        assert rules_of(tsh, name).rules == rules_of(jsh, name).rules
    assert tmesh.AXIS_ORDER == ("stage", "data", "fsdp", "expert", "seq", "tensor")


@pytest.mark.parametrize("table", TABLES)
def test_param_specs_match_jax(table, jparams):
    """Every param's mesh axes per dim equal the JAX spec for its path."""
    jcfg, tcfg = jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()
    ref = jsh.match_partition_rules(jl.partition_rules(jcfg, rules_of(jsh, table)), jparams)
    ref = dict(zip(jsh.tree_path_names(ref),
                   jax.tree_util.tree_leaves(ref, is_leaf=lambda x: isinstance(x, JP))))
    ours = tsh.match_partition_rules(tl.partition_rules(tcfg, rules_of(tsh, table)),
                                     torch_model(jparams))
    assert sorted(ours) == sorted(ref)
    for path, spec in ours.items():
        assert tuple(spec) == tuple(ref[path]), path
    # logical axes, one per dim, as the JAX tree's
    assert tl.logical_axes(tcfg) == jl.logical_axes(jcfg)


# -- selective remat --------------------------------------------------------


def test_selective_remat_matches_no_remat():
    cfg = tl.LlamaConfig.tiny()
    model = tl.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(tokens((2, 16), cfg.vocab_size, seed=2))
    l0 = tl.next_token_loss(cfg, model, toks, toks, remat=False)
    l1 = tl.next_token_loss(cfg, model, toks, toks, remat="selective")
    np.testing.assert_allclose(l0.item(), l1.item(), rtol=1e-5)


def test_remat_rejects_unknown_mode():
    cfg = tl.LlamaConfig.tiny()
    model = tl.init_params(cfg, 0, device="cpu")
    toks = torch.zeros((1, 16), dtype=torch.long)
    with pytest.raises(ValueError, match="remat"):
        tl.next_token_loss(cfg, model, toks, toks, remat="bogus")


def test_selective_remat_matches_jax(jparams):
    """Logits, loss and every gradient under ``remat="selective"`` equal
    the JAX forward and ``value_and_grad`` under its selective policy."""
    jcfg, tcfg = jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()
    toks = tokens((2, 33), jcfg.vocab_size, seed=4)
    x, y = toks[:, :-1], toks[:, 1:]
    jlogits = jl.forward(jcfg, jparams, jnp.asarray(x), remat="selective")
    jloss, jgrads = jax.value_and_grad(
        lambda p: jl.next_token_loss(jcfg, p, jnp.asarray(x), jnp.asarray(y), remat="selective")
    )(jparams)
    model = torch_model(jparams)
    logits = tl.forward(tcfg, model, torch.from_numpy(x), remat="selective")
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=1e-4)
    loss = tl.next_token_loss(tcfg, model, torch.from_numpy(x), torch.from_numpy(y),
                              remat="selective")
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    grads = dict(model.named_parameters())
    ref = {"embed": jgrads["embed"], "final_norm": jgrads["final_norm"],
           "lm_head": jgrads["lm_head"]}
    for i, layer in enumerate(jgrads["layers"]):
        ref.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    for name, g in ref.items():
        g = np.asarray(g)
        err = np.linalg.norm(grads[name].grad.numpy() - g) / np.linalg.norm(g)
        assert err < 1e-5, (name, err)


@pytest.mark.parametrize("remat,fwd_per_layer", [(False, 1), ("selective", 1), ("full", 2)])
def test_flash_calls_per_remat_mode(remat, fwd_per_layer, monkeypatch):
    """Selective remat saves the flash output: the forward kernel runs once
    a layer, as without remat, and twice under full remat (the recompute);
    the backward kernels run once a layer in every mode."""
    cfg = tl.LlamaConfig.tiny()
    model = tl.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(tokens((2, 16), cfg.vocab_size, seed=5))
    calls = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    for name in calls:
        fn = getattr(tattn, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(tattn, name, counted)
    tl.next_token_loss(cfg, model, toks, toks, remat=remat).backward()
    assert calls == {"flash_fwd": fwd_per_layer * cfg.n_layers,
                     "flash_bwd_dq": cfg.n_layers, "flash_bwd_dkv": cfg.n_layers}


# -- a world-1 mesh in this process ----------------------------------------


@pytest.fixture
def world_one_mesh():
    import torch.distributed as dist

    assert not dist.is_initialized()
    mesh = tmesh.make_mesh(tmesh.MeshSpec(fsdp=-1), "cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_make_mesh_starts_a_world_one_group(world_one_mesh):
    """Without a process group ``make_mesh`` starts a world-1 one (as JAX's
    needs no rendezvous); the mesh has all six axes in ``AXIS_ORDER``. The
    sharded step on it equals the plain step, and a model that was not
    sharded is refused by name."""
    mesh = world_one_mesh
    assert mesh.mesh_dim_names == tmesh.AXIS_ORDER and tuple(mesh.shape) == (1,) * 6
    assert tmesh.mesh_axis_sizes(mesh)["fsdp"] == 1
    cfg = tl.LlamaConfig.tiny()
    rules = tsh.fsdp_rules()
    toks = torch.from_numpy(tokens((2, 17), cfg.vocab_size, seed=6))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    sharded = tl.init_sharded(cfg, mesh, rules, 0, tl.adamw(1e-3))
    plain_model = tl.init_params(cfg, 0, device="cpu")
    plain = (plain_model, tl.adamw(1e-3)(plain_model.parameters()))
    step = tl.make_train_step(cfg, remat="selective", mesh=mesh, rules=rules)
    _, loss = step(sharded, batch)
    _, ref = tl.make_train_step(cfg)(plain, batch)
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-6)
    # param_shardings (from logical_axes) places each param as its
    # partition rule does, under every table
    for table in TABLES:
        r = rules_of(tsh, table)
        tree = tl.param_shardings(cfg, mesh, r)
        flat = {"embed": tree["embed"], "final_norm": tree["final_norm"],
                "lm_head": tree["lm_head"]}
        for i, layer in enumerate(tree["layers"]):
            flat.update({f"layers/{i}/{k}": v for k, v in layer.items()})
        specs = tsh.match_partition_rules(tl.partition_rules(cfg, r), plain_model)
        assert flat == {p: tsh.spec_placements(mesh, s) for p, s in specs.items()}, table
    with pytest.raises(ValueError, match="init_sharded"):
        fresh = tl.init_params(cfg, 0, device="cpu")
        step((fresh, tl.adamw(1e-3)(fresh.parameters())), batch)


def test_placement_mesh_follows_a_rebuilt_group():
    """A mesh rebuilt over a new process group compares equal to the old
    one (DeviceMesh equality ignores the group), yet gets its own cut:
    DTensors placed on it live on the new group, not the destroyed one."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    old = tmesh.make_mesh(tmesh.MeshSpec(fsdp=-1), "cpu")
    old_cut = tmesh.placement_mesh(old)
    assert tmesh.placement_mesh(old) is old_cut  # kept, not cut again
    dist.destroy_process_group()
    new = tmesh.make_mesh(tmesh.MeshSpec(fsdp=-1), "cpu")
    try:
        assert new == old
        cut = tmesh.placement_mesh(new)
        assert cut is not old_cut and cut.mesh_dim_names == (tmesh.AXIS_ORDER[-1],)
        x = tsh.place(torch.arange(6.0), new, tsh.spec_placements(new, (None,)))
        assert x.device_mesh is cut
        np.testing.assert_array_equal(x.full_tensor().numpy(), np.arange(6.0))
    finally:
        dist.destroy_process_group()
