"""The port's MoE FFN (``ray_tpu_torch.ops.moe``) and the MoE Llama against
``ray_tpu.ops.moe`` / ``ray_tpu.models.llama`` on the CPU, in f32: a port of
``tests/test_moe.py``'s cases, each held to the JAX package on the same
numpy-seeded inputs and converted params.

Tolerances and why: ``moe_ffn``'s output, aux loss and dropped fraction,
and the gradients of ``out.sum()``, 1e-5 absolute (f32, the same products
summed in another order; entries of magnitude <= 5). The MoE Llama's loss
(aux included) and gradients 1e-5 absolute and its params after one AdamW
step 1e-4 absolute, the bounds ``test_torch_llama.py`` holds the dense
step to. Random inputs have no ties in the top-k, so both sides route
alike. The expert-sharded cases run in ``test_torch_sharded_step.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.ops import moe as jmoe
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import moe as tmoe

torch.set_num_threads(1)

NAMES = ("router", "w_gate", "w_up", "w_down")


def _params(dim, hidden, experts, seed):
    rs = np.random.RandomState(seed)
    drawn = {
        "router": rs.randn(dim, experts) / np.sqrt(dim),
        "w_gate": rs.randn(experts, dim, hidden) / np.sqrt(dim),
        "w_up": rs.randn(experts, dim, hidden) / np.sqrt(dim),
        "w_down": rs.randn(experts, hidden, dim) / np.sqrt(hidden),
    }
    return {k: v.astype(np.float32) for k, v in drawn.items()}


def _both(params, x, **kw):
    """(JAX out, aux, grads of out.sum()), (the port's), on the same inputs."""

    def jfn(p, x):
        out, aux = jmoe.moe_ffn(p, x, **kw)
        return out.sum(), (out, aux)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    (_, (jout, jaux)), jgrads = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    tout, taux = tmoe.moe_ffn(tp, tx, **kw)
    tout.sum().backward()
    return (jout, jaux, jgrads), (tout, taux, ({k: t.grad for k, t in tp.items()}, tx.grad))


@pytest.mark.parametrize("capacity_factor", [8.0, 0.5], ids=["uncapped", "capped"])
def test_moe_matches_jax(capacity_factor):
    params = _params(16, 32, 4, seed=0)
    x = np.random.RandomState(1).randn(2, 8, 16).astype(np.float32)
    (jout, jaux, (jg, jgx)), (tout, taux, (tg, tgx)) = _both(
        params, x, top_k=2, capacity_factor=capacity_factor)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), atol=1e-5)
    for key in ("aux_loss", "dropped_fraction"):
        np.testing.assert_allclose(taux[key].item(), float(jaux[key]), atol=1e-5, err_msg=key)
    assert float(taux["dropped_fraction"]) == float(jaux["dropped_fraction"])
    if capacity_factor == 8.0:
        assert float(taux["dropped_fraction"]) == 0.0 and float(taux["aux_loss"]) > 0.0
    else:
        assert float(taux["dropped_fraction"]) > 0.0
    for k in NAMES:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), atol=1e-5, err_msg=k)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), atol=1e-5)


def test_moe_capacity_drops_overflow():
    """Every token forced to expert 0: capacity ceil(1 * 16 / 2 * 0.5) = 4
    of 16 kept, the last tokens (slots by arrival order) pass through as 0."""
    params = _params(8, 16, 2, seed=0)
    params["router"] = np.zeros((8, 2), np.float32)
    params["router"][:, 0] = 10.0
    x = np.abs(np.random.RandomState(1).randn(1, 16, 8).astype(np.float32)) + 0.1
    (jout, jaux, _), (tout, taux, _) = _both(params, x, top_k=1, capacity_factor=0.5)
    assert abs(float(taux["dropped_fraction"]) - 0.75) < 1e-6
    np.testing.assert_allclose(tout[0, -1].detach().numpy(), np.zeros(8), atol=1e-6)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), atol=1e-5)
    assert float(taux["dropped_fraction"]) == float(jaux["dropped_fraction"])


def test_init_moe_params_shapes_and_router_f32():
    g = torch.Generator().manual_seed(0)
    p = tmoe.init_moe_params(g, dim=16, hidden=32, num_experts=4, dtype=torch.bfloat16)
    assert {k: (tuple(v.shape), v.dtype) for k, v in p.items()} == {
        "router": ((16, 4), torch.float32), "w_gate": ((4, 16, 32), torch.bfloat16),
        "w_up": ((4, 16, 32), torch.bfloat16), "w_down": ((4, 32, 16), torch.bfloat16)}
    assert tmoe.moe_logical_axes() == jmoe.moe_logical_axes()


def _flat(tree):
    out = {"embed": tree["embed"], "final_norm": tree["final_norm"], "lm_head": tree["lm_head"]}
    for i, layer in enumerate(tree["layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return out


def test_llama_moe_loss_grads_and_step_match_jax():
    """The tiny MoE Llama: ``next_token_loss`` (aux included) and its
    gradients, then the params after one AdamW step, against JAX's."""
    jcfg = jl.LlamaConfig.tiny(moe_experts=4)
    tcfg = tl.LlamaConfig.tiny(moe_experts=4)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    model = tl.init_params(tcfg, 0, device="cpu")
    assert model.layers[0].router.dtype == torch.float32
    model.load_state_dict(tl.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    toks = np.random.RandomState(2).randint(0, 256, size=(2, 17)).astype(np.int32)
    x, y = toks[:, :-1], toks[:, 1:]
    jloss, jgrads = jax.value_and_grad(
        lambda p: jl.next_token_loss(jcfg, p, jnp.asarray(x), jnp.asarray(y)))(jparams)
    loss = tl.next_token_loss(tcfg, model, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    grads = dict(model.named_parameters())
    for name, g in _flat(jgrads).items():
        np.testing.assert_allclose(grads[name].grad.numpy(), np.asarray(g), atol=1e-5,
                                   err_msg=name)

    opt = optax.adamw(1e-3)
    jstep = jl.make_train_step(jcfg, opt, donate=False)
    (jnew, _), jl1 = jstep((jparams, opt.init(jparams)),
                           {"tokens": jnp.asarray(x), "targets": jnp.asarray(y)})
    model.zero_grad(set_to_none=True)
    state = (model, tl.adamw(1e-3)(model.parameters()))
    _, tl1 = tl.make_train_step(tcfg)(state, {"tokens": torch.from_numpy(x),
                                              "targets": torch.from_numpy(y)})
    np.testing.assert_allclose(float(tl1), float(jl1), atol=1e-5)
    sd = model.state_dict()
    for name, p in _flat(jnew).items():
        np.testing.assert_allclose(sd[name].numpy(), np.asarray(p), atol=1e-4, err_msg=name)
