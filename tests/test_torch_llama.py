"""The port's Llama training half (``ray_tpu_torch.models.llama``) against
``ray_tpu.models.llama`` on the CPU, on ``LlamaConfig.tiny()`` in f32.

The JAX model's own initial params are carried across with
``params_from_jax``, so both sides compute the same function on the same
weights; tokens come from a seeded numpy RandomState.

Tolerances and why: logits 1e-4 absolute and loss 1e-5 (f32, another
summation order in every matmul and softmax; ~1e-6 measured); gradients
1e-5 absolute (entries of magnitude <= 0.1); the 3-step AdamW losses 1e-5
relative and the params after them 1e-4 absolute (same update rule, but an
Adam step divides by sqrt(v), which magnifies f32 gradient differences of
parameters whose gradient is near zero; ~2e-6 relative measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cfgs():
    return jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()


@pytest.fixture(scope="module")
def jparams(cfgs):
    return jl.init_params(cfgs[0], jax.random.PRNGKey(0))


def torch_model(cfg, jparams):
    model = tl.init_params(cfg, 0, device="cpu")
    model.load_state_dict(tl.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    return model


def tokens(shape, vocab, seed):
    return np.random.RandomState(seed).randint(0, vocab, size=shape).astype(np.int32)


def flat_jax(tree):
    out = {"embed": tree["embed"], "final_norm": tree["final_norm"], "lm_head": tree["lm_head"]}
    for i, layer in enumerate(tree["layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return out


def test_param_names_and_shapes_follow_jax_tree(cfgs, jparams):
    model = tl.init_params(cfgs[1], 0, device="cpu")
    ours = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    theirs = {k: tuple(v.shape) for k, v in flat_jax(jparams).items()}
    assert ours == theirs
    assert ours["layers.0.wq"] == (64, 4, 16) and ours["layers.0.wo"] == (4, 16, 64)


def test_params_from_jax_carries_bf16_bits():
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.bfloat16)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.bfloat16)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(1))
    sd = tl.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    model = tl.init_params(tcfg, 0, device="cpu")
    model.load_state_dict(sd)
    for name, leaf in flat_jax(jp).items():
        ours = model.state_dict()[name]
        assert ours.dtype == torch.bfloat16
        np.testing.assert_array_equal(ours.float().numpy(), np.asarray(leaf, np.float32))


def test_init_params_deterministic_per_seed(cfgs):
    cfg = cfgs[1]
    a = tl.init_params(cfg, 0, device="cpu").state_dict()
    b = tl.init_params(cfg, 0, device="cpu").state_dict()
    c = tl.init_params(cfg, 1, device="cpu").state_dict()
    for name in a:
        torch.testing.assert_close(a[name], b[name], rtol=0, atol=0)
    assert not torch.equal(a["layers.0.wq"], c["layers.0.wq"])
    # the JAX distributions: normal / sqrt(fan_in), norms at 1
    assert torch.all(a["layers.1.mlp_norm"] == 1) and torch.all(a["final_norm"] == 1)
    assert abs(float(a["layers.0.w_down"].std()) * np.sqrt(cfg.mlp_hidden) - 1) < 0.05
    assert abs(float(a["lm_head"].std()) * np.sqrt(cfg.dim) - 1) < 0.05


def test_forward_shape_and_dtype(cfgs):
    cfg = cfgs[1]
    model = tl.init_params(cfg, 0, device="cpu")
    logits = tl.forward(cfg, model, torch.zeros((2, 16), dtype=torch.long))
    assert logits.shape == (2, 16, cfg.vocab_size)
    assert logits.dtype == torch.float32


def test_param_count_matches(cfgs):
    cfg = cfgs[1]
    model = tl.init_params(cfg, 0, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == tl.param_count(cfg)
    assert tl.param_count(cfg) == jl.param_count(cfgs[0])
    big_t, big_j = tl.LlamaConfig.llama2_7b(n_layers=4), jl.LlamaConfig.llama2_7b(n_layers=4)
    assert tl.param_count(big_t) == jl.param_count(big_j)


@pytest.mark.parametrize("impl", ["xla", "auto"])
def test_logits_match_jax(cfgs, jparams, impl):
    jcfg, tcfg = cfgs
    tcfg = tl.LlamaConfig.tiny(attention_impl=impl)
    toks = tokens((2, 32), jcfg.vocab_size, seed=1)
    ref = jl.forward(jcfg, jparams, jnp.asarray(toks))
    out = tl.forward(tcfg, torch_model(tcfg, jparams), torch.from_numpy(toks))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-4)


def test_loss_and_grads_match_jax(cfgs, jparams):
    jcfg, tcfg = cfgs
    toks = tokens((2, 33), jcfg.vocab_size, seed=2)
    x, y = toks[:, :-1], toks[:, 1:]
    jloss, jgrads = jax.value_and_grad(
        lambda p: jl.next_token_loss(jcfg, p, jnp.asarray(x), jnp.asarray(y))
    )(jparams)
    model = torch_model(tcfg, jparams)
    loss = tl.next_token_loss(tcfg, model, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    grads = dict(model.named_parameters())
    for name, g in flat_jax(jgrads).items():
        np.testing.assert_allclose(grads[name].grad.numpy(), np.asarray(g), atol=1e-5,
                                   err_msg=name)


def test_adamw_three_steps_match_optax(cfgs, jparams):
    jcfg, tcfg = cfgs
    toks = tokens((2, 17), jcfg.vocab_size, seed=3)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    opt = optax.adamw(1e-3)
    jstep = jl.make_train_step(jcfg, opt, donate=False)
    jstate = (jparams, opt.init(jparams))
    model = torch_model(tcfg, jparams)
    tstate = (model, tl.adamw(1e-3)(model.parameters()))
    tstep = tl.make_train_step(tcfg)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(3):
        jstate, jloss = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tloss = tstep(tstate, tbatch)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    sd = model.state_dict()
    for name, p in flat_jax(jstate[0]).items():
        np.testing.assert_allclose(sd[name].numpy(), np.asarray(p), atol=1e-4, err_msg=name)


def test_adamw_defaults_are_optax_defaults():
    opt = tl.adamw(1e-3)([torch.nn.Parameter(torch.zeros(2))])
    group = opt.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert group["weight_decay"] == 1e-4


def test_causality(cfgs):
    """Future tokens must not affect earlier logits."""
    cfg = cfgs[1]
    model = tl.init_params(cfg, 0, device="cpu")
    t1 = torch.from_numpy(tokens((1, 16), cfg.vocab_size, seed=4))
    t2 = t1.clone()
    t2[0, -1] = (t1[0, -1] + 1) % cfg.vocab_size
    l1 = tl.forward(cfg, model, t1)
    l2 = tl.forward(cfg, model, t2)
    torch.testing.assert_close(l1[0, :-1], l2[0, :-1], rtol=0, atol=1e-5)


def test_overfit_tiny_batch(cfgs):
    """Loss drops on a fixed batch — the model learns."""
    cfg = cfgs[1]
    model = tl.init_params(cfg, 0, device="cpu")
    state = (model, torch.optim.Adam(model.parameters(), lr=1e-2))
    step = tl.make_train_step(cfg)
    toks = torch.from_numpy(tokens((4, 16), cfg.vocab_size, seed=5))
    batch = {"tokens": toks, "targets": toks}
    first = None
    for _ in range(30):
        state, loss = step(state, batch)
        if first is None:
            first = float(loss)
    assert float(loss) < first * 0.5, (first, float(loss))


def test_remat_matches(cfgs):
    cfg = cfgs[1]
    toks = torch.from_numpy(tokens((2, 16), cfg.vocab_size, seed=6))
    losses, grads = [], []
    for remat in (False, True):
        model = tl.init_params(cfg, 0, device="cpu")
        loss = tl.next_token_loss(cfg, model, toks, toks, remat=remat)
        loss.backward()
        losses.append(float(loss))
        grads.append([p.grad for p in model.parameters()])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_model_rms_norm_and_interleaved_rope_match_jax(cfgs):
    """The model's own rms_norm (weight after the cast) and its interleaved
    even/odd RoPE, as distinct from ops.layers'."""
    jcfg, tcfg = cfgs
    rng = np.random.RandomState(7)
    x = rng.randn(2, 8, 64).astype(np.float32)
    w = rng.randn(64).astype(np.float32)
    np.testing.assert_allclose(
        tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)), rtol=1e-6, atol=1e-6)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    ref_b = jl.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), 1e-5)
    np.testing.assert_array_equal(tl.rms_norm(xb, wb, 1e-5).float().numpy(),
                                  np.asarray(ref_b, np.float32))

    jcos, jsin = jl.rope_tables(jcfg, 12, offset=3)
    tcos, tsin = tl.rope_tables(tcfg, 12, offset=3)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=1e-6)
    q = rng.randn(2, 12, 4, 16).astype(np.float32)
    np.testing.assert_allclose(tl.apply_rope(torch.from_numpy(q), tcos, tsin).numpy(),
                               np.asarray(jl.apply_rope(jnp.asarray(q), jcos, jsin)), atol=1e-6)


@pytest.mark.parametrize("case", ["selective", "mesh", "ring", "ulysses", "moe"])
def test_unported_options_raise(case):
    cfg = tl.LlamaConfig.tiny()
    if case == "selective":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tl.make_train_step(cfg, remat="selective")
    elif case == "mesh":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tl.make_train_step(cfg, mesh=object())
    elif case in ("ring", "ulysses"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tl.make_train_step(tl.LlamaConfig.tiny(attention_impl=case))
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tl.init_params(tl.LlamaConfig.tiny(moe_experts=4), 0, device="cpu")


def test_entry_runs_tiny_forward_on_cpu():
    fn, (params, toks) = tl.entry(device="cpu")
    out = fn(params, toks)
    assert out.shape == (2, 128, 256) and bool(torch.isfinite(out).all())


def test_entry_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.entry()


@pytest.mark.cuda
def test_cuda_train_step_runs_through_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, PyTorch/CUDA port)")
    cfg = tl.LlamaConfig.tiny()
    model = tl.init_params(cfg, 0)
    state = (model, tl.adamw(1e-3)(model.parameters()))
    toks = torch.from_numpy(tokens((2, 64), cfg.vocab_size, seed=8)).cuda()
    tattn.reset_launch_counts()
    state, loss = tl.make_train_step(cfg)(state, {"tokens": toks, "targets": toks})
    assert np.isfinite(float(loss))
    assert [fn.launches for fn in tattn.KERNELS] == [cfg.n_layers] * 3
