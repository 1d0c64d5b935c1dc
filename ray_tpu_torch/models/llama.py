"""Llama-family decoder LM, training half (port of ``ray_tpu.models.llama``).

* one ``nn.Module`` (``Llama``) whose parameter names and shapes follow
  the JAX param tree (``embed``, ``layers.{i}.wq`` ..., ``final_norm``,
  ``lm_head``; ``wq`` is ``[dim, n_heads, head_dim]``, ``wo`` is
  ``[n_heads, head_dim, dim]``), so a JAX tree loads with no transposes
  (``params_from_jax``); projections stay einsums over that layout;
* attention is ``ray_tpu_torch.ops.flash_attention`` (the hand-written
  CUDA kernels on the card), GQA mapped in-kernel;
* matmuls in the param dtype, logits and loss in f32;
* single device. Selective remat, MoE, sequence-parallel attention and
  sharding are not ported yet and raise ``NotImplementedError``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops.attention import flash_attention


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    mlp_hidden: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.float32
    #: attention impl: "auto" | "pallas" | "xla" (see ``flash_attention``);
    #: "ring" | "ulysses" are not ported yet
    attention_impl: str = "auto"
    #: >0 makes every MLP a MoE FFN (not ported yet)
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_coeff: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def llama2_7b(**overrides) -> "LlamaConfig":
        base = dict(
            vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
            n_kv_heads=32, mlp_hidden=11008, max_seq_len=4096,
            dtype=torch.bfloat16,
        )
        base.update(overrides)
        return LlamaConfig(**base)

    @staticmethod
    def tiny(**overrides) -> "LlamaConfig":
        """CI-sized config (unit tests)."""
        base = dict(
            vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            mlp_hidden=128, max_seq_len=64,
        )
        base.update(overrides)
        return LlamaConfig(**base)


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when CUDA is
    asked for and there is no card (never falls back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
    return dev


def _check_ported(cfg: LlamaConfig, remat=False, mesh=None, rules=None) -> None:
    if cfg.moe_experts > 0:
        raise NotImplementedError("MoE FFNs are not ported yet (ROADMAP Queue A: MoE)")
    if cfg.attention_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention_impl={cfg.attention_impl!r} is not ported yet "
            "(ROADMAP Queue A: sequence parallelism)"
        )
    if mesh is not None or rules is not None:
        raise NotImplementedError(
            "mesh/rules sharding is not ported yet (ROADMAP Queue A: multi-device)"
        )
    if remat == "selective":
        raise NotImplementedError(
            "remat='selective' is not ported yet (ROADMAP Queue A: selective remat)"
        )
    if remat not in (False, None, True, "full"):
        raise ValueError(f"remat must be False, True, 'full', or 'selective'; got {remat!r}")


# ---------------------------------------------------------------------------
# params


def _layer_shapes(cfg: LlamaConfig) -> Dict[str, Tuple[int, ...]]:
    hd = cfg.head_dim
    shapes = {
        "attn_norm": (cfg.dim,),
        "wq": (cfg.dim, cfg.n_heads, hd),
        "wk": (cfg.dim, cfg.n_kv_heads, hd),
        "wv": (cfg.dim, cfg.n_kv_heads, hd),
        "wo": (cfg.n_heads, hd, cfg.dim),
        "mlp_norm": (cfg.dim,),
    }
    if cfg.moe_experts > 0:
        shapes.update(
            {
                "router": (cfg.dim, cfg.moe_experts),
                "w_gate": (cfg.moe_experts, cfg.dim, cfg.mlp_hidden),
                "w_up": (cfg.moe_experts, cfg.dim, cfg.mlp_hidden),
                "w_down": (cfg.moe_experts, cfg.mlp_hidden, cfg.dim),
            }
        )
    else:
        shapes.update(
            {
                "w_gate": (cfg.dim, cfg.mlp_hidden),
                "w_up": (cfg.dim, cfg.mlp_hidden),
                "w_down": (cfg.mlp_hidden, cfg.dim),
            }
        )
    return shapes


def param_count(cfg: LlamaConfig) -> int:
    shapes = list(_layer_shapes(cfg).values())
    per_layer = sum(math.prod(s) for s in shapes)
    return (
        cfg.vocab_size * cfg.dim * 2  # embed + lm_head
        + per_layer * cfg.n_layers
        + cfg.dim
    )


def _param(shape, cfg: LlamaConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.dtype, device=device))


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        for name, shape in _layer_shapes(cfg).items():
            setattr(self, name, _param(shape, cfg, device))


class Llama(nn.Module):
    """The parameters, named as the JAX tree; ``forward`` is the module
    function below."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.embed = _param((cfg.vocab_size, cfg.dim), cfg, device)
        self.layers = nn.ModuleList(LlamaLayer(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = _param((cfg.dim,), cfg, device)
        self.lm_head = _param((cfg.dim, cfg.vocab_size), cfg, device)

    def forward(self, tokens, *, remat=False):
        return forward(self.cfg, self, tokens, remat=remat)


@torch.no_grad()
def init_params(cfg: LlamaConfig, seed=0, *, device=None) -> Llama:
    """Random weights: normal / sqrt(fan_in) drawn in f32 and cast to
    ``cfg.dtype``, norms at 1 (the JAX distributions; not its bits).

    ``seed`` is an int or a ``torch.Generator``; an int seeds a generator on
    the target device, so a seed gives the same weights on every call on
    that device."""
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator(dev).manual_seed(seed)
    model = Llama(cfg, device=dev)

    def dense(p, fan_in):
        draw = torch.randn(p.shape, generator=gen, dtype=torch.float32, device=gen.device)
        p.copy_(draw / math.sqrt(fan_in))

    dense(model.embed, cfg.dim)
    for layer in model.layers:
        for name, shape in _layer_shapes(cfg).items():
            p = getattr(layer, name)
            if name.endswith("norm"):
                p.fill_(1.0)
            else:
                dense(p, shape[0] if len(shape) == 2 else cfg.dim)
    model.final_norm.fill_(1.0)
    dense(model.lm_head, cfg.dim)
    return model


def _to_torch(leaf) -> torch.Tensor:
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":  # numpy has no bf16: carry the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """A JAX Llama param tree (numpy leaves, or anything ``np.asarray``
    takes) → a ``Llama`` state dict. Same names, same shapes: no transposes."""
    sd = {"embed": _to_torch(tree["embed"])}
    for i, layer in enumerate(tree["layers"]):
        for name, leaf in layer.items():
            sd[f"layers.{i}.{name}"] = _to_torch(leaf)
    sd["final_norm"] = _to_torch(tree["final_norm"])
    sd["lm_head"] = _to_torch(tree["lm_head"])
    return sd


# ---------------------------------------------------------------------------
# forward


def rms_norm(x, weight, eps: float):
    """The model's own RMSNorm: the weight multiplies AFTER the cast back
    (unlike ``ops.layers.rms_norm``, which casts the weight to f32)."""
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * inv).to(x.dtype) * weight


def rope_tables(cfg: LlamaConfig, seq_len: int, offset: int = 0, *, device=None):
    hd = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                                      device=device) / hd))
    pos = torch.arange(offset, offset + seq_len, dtype=torch.float32, device=device)
    ang = torch.outer(pos, inv_freq)  # [S, hd/2]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: [B, S, H, hd] — rotate interleaved pairs (even, odd)."""
    x1, x2 = x[..., ::2], x[..., 1::2]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    out1 = x1 * c - x2 * s
    out2 = x2 * c + x1 * s
    return torch.stack([out1, out2], dim=-1).reshape(x.shape).to(x.dtype)


def _attention_block(cfg: LlamaConfig, p, x, cos, sin):
    h = rms_norm(x, p.attn_norm, cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, p.wq)
    k = torch.einsum("bsd,dhk->bshk", h, p.wk)
    v = torch.einsum("bsd,dhk->bshk", h, p.wv)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    # [B, S, H, hd] → [B, H, S, hd]; K/V stay at n_kv_heads (GQA in-kernel)
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=True, impl=cfg.attention_impl)
    o = o.transpose(1, 2)
    return x + torch.einsum("bshk,hkd->bsd", o.to(x.dtype), p.wo)


def _mlp_block(cfg: LlamaConfig, p, x):
    h = rms_norm(x, p.mlp_norm, cfg.norm_eps)
    gate = torch.einsum("bsd,dm->bsm", h, p.w_gate)
    up = torch.einsum("bsd,dm->bsm", h, p.w_up)
    return x + torch.einsum("bsm,md->bsd", F.silu(gate) * up, p.w_down)


def _block(cfg: LlamaConfig, cos, sin, x, p):
    return _mlp_block(cfg, p, _attention_block(cfg, p, x, cos, sin))


def forward(cfg: LlamaConfig, params: Llama, tokens, *, remat=False, mesh=None, rules=None):
    """tokens [B, S] int → logits [B, S, vocab] (f32).

    ``remat``: False, or True/"full" (every layer recomputed in the
    backward, ``torch.utils.checkpoint``)."""
    _check_ported(cfg, remat, mesh, rules)
    B, S = tokens.shape
    x = params.embed[tokens]
    cos, sin = rope_tables(cfg, S, device=x.device)
    block = functools.partial(_block, cfg, cos, sin)
    for p in params.layers:
        x = checkpoint(block, x, p, use_reentrant=False) if remat else block(x, p)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return torch.einsum("bsd,dv->bsv", x, params.lm_head).float()


def next_token_loss(cfg: LlamaConfig, params: Llama, tokens, targets, *, remat=False,
                    mesh=None, rules=None):
    """Mean next-token NLL (f32 log-softmax over the vocabulary); the MoE
    aux term of the JAX loss is 0 for the dense FFN, the only one ported."""
    logits = forward(cfg, params, tokens, remat=remat, mesh=mesh, rules=rules)
    return F.cross_entropy(logits.reshape(-1, cfg.vocab_size), targets.reshape(-1).long())


# ---------------------------------------------------------------------------
# training step (single device)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4):
    """``optax.adamw``'s defaults as a ``torch.optim.AdamW`` factory (torch's
    own default decay is 1e-2): ``adamw(1e-3)(model.parameters())``."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


def make_train_step(cfg: LlamaConfig, *, remat=False, mesh=None, rules=None):
    """Returns ``step((model, opt), batch) → ((model, opt), loss)``, where
    ``opt`` is a ``torch.optim`` optimizer over the model's parameters
    (e.g. ``adamw(1e-3)(model.parameters())``; the JAX step takes the optax
    transformation instead, and its state the optax state). Parameters
    and optimizer state update in place, the port's analogue of the JAX
    step's donation."""
    _check_ported(cfg, remat, mesh, rules)

    def step(state, batch):
        model, opt = state
        opt.zero_grad(set_to_none=True)
        loss = next_token_loss(cfg, model, batch["tokens"], batch["targets"], remat=remat)
        loss.backward()
        opt.step()
        return (model, opt), loss.detach()

    return step


def entry(device=None):
    """The tiny forward at seq 128 (as ``__graft_entry__.entry``): returns
    ``(fn, (params, tokens))``."""
    cfg = LlamaConfig.tiny(max_seq_len=128)
    params = init_params(cfg, 0, device=device)
    tokens = torch.zeros((2, 128), dtype=torch.long, device=params.embed.device)

    def fn(params, tokens):
        return forward(cfg, params, tokens)

    return fn, (params, tokens)
