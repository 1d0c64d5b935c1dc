"""Llama-family decoder LM (port of ``ray_tpu.models.llama``): the training
step and the paged-KV serving steps.

* one ``nn.Module`` (``Llama``) whose parameter names and shapes follow
  the JAX param tree (``embed``, ``layers.{i}.wq`` ..., ``final_norm``,
  ``lm_head``; ``wq`` is ``[dim, n_heads, head_dim]``, ``wo`` is
  ``[n_heads, head_dim, dim]``), so a JAX tree loads with no transposes
  (``params_from_jax``); projections stay einsums over that layout;
* attention is ``ray_tpu_torch.ops.flash_attention`` (the hand-written
  CUDA kernels on the card), GQA mapped in-kernel;
* matmuls in the param dtype, logits and loss in f32;
* the paged-KV prefill, verify and decode steps the inference engine runs
  (plain torch ops over a block-paged cache updated in place);
* every parameter has *logical* axis names (``logical_axes``); with a
  ``DeviceMesh`` and a ``ShardingRules`` table
  (``ray_tpu_torch.parallel``) the params become DTensors
  (``init_sharded``) and ``forward``/``make_train_step`` pin activations,
  grads and optimizer state to the table, as the JAX step pins them;
* ``remat="selective"`` saves the matmul outputs and the flash output and
  recomputes the elementwise tail (the JAX ``_remat_policy``);
* ``moe_experts > 0`` makes every FFN a MoE FFN (``ops.moe``; the experts
  split over the ``expert`` mesh axis under the rules), and
  ``attention_impl="ring"|"ulysses"`` runs sequence-parallel attention
  over the mesh's ``seq`` axis (``ops.ring_attention``; pass the mesh,
  with or without rules).

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
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.moe import MOE_PARAMS, moe_ffn, moe_ffn_sharded, moe_logical_axes
from ray_tpu_torch.ops.ring_attention import ring_attention_sharded, ulysses_attention_sharded
from ray_tpu_torch.parallel.mesh import TENSOR, mesh_axis_sizes, placement_mesh
from ray_tpu_torch.parallel.sharding import (
    constrain,
    constrain_tree,
    match_partition_rules,
    optimizer_state,
    spec_placements,
    tree_leaves,
    tree_path_names,
)


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
    #: attention impl: "auto" | "pallas" | "xla" (see ``flash_attention``) or
    #: "ring" | "ulysses" (sequence-parallel over the mesh's seq axis:
    #: pass the mesh to ``forward``/``make_train_step``)
    attention_impl: str = "auto"
    #: >0 turns every MLP block into a MoE FFN with this many experts
    #: (expert dim shards over the ``expert`` mesh axis; see ops/moe.py)
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


def _param(shape, cfg: LlamaConfig, device, dtype=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype or cfg.dtype, device=device))


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        for name, shape in _layer_shapes(cfg).items():
            # routing logits are precision-sensitive: the router stays f32
            dtype = torch.float32 if name == "router" else None
            setattr(self, name, _param(shape, cfg, device, dtype))


class Llama(nn.Module):
    """The parameters, named as the JAX tree; ``forward`` is the module
    function below."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
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
    ``cfg.dtype``, norms at 1 (the JAX distributions; not its bits). MoE:
    the router stays f32, the stacked expert weights ``(E, fan_in,
    fan_out)`` scale by ``shape[-2]``.

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
            elif cfg.moe_experts > 0 and name in MOE_PARAMS:
                dense(p, shape[-2] if name != "router" else shape[0])
            else:
                dense(p, shape[0] if len(shape) == 2 else cfg.dim)
    model.final_norm.fill_(1.0)
    dense(model.lm_head, cfg.dim)
    return model


def logical_axes(cfg: LlamaConfig) -> Dict[str, Any]:
    """Tree (same structure as the JAX params) of logical-axis-name tuples."""
    layer = {
        "attn_norm": (None,),
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
        "mlp_norm": (None,),
    }
    if cfg.moe_experts > 0:
        layer.update(moe_logical_axes())
    else:
        layer.update({
            "w_gate": ("embed", "mlp"),
            "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed"),
        })
    return {
        "embed": ("vocab", "embed"),
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
        "final_norm": (None,),
        "lm_head": ("embed", "vocab"),
    }


def partition_rules(cfg: LlamaConfig, rules) -> list:
    """Ordered ``(regex, PartitionSpec)`` pairs covering every llama param —
    the regex-rule source of truth ``match_partition_rules`` applies to
    params, grads, AND optimizer state (``optimizer_state`` names each
    leaf after its param, so the same path suffixes match; scalar leaves
    like AdamW's ``step`` are skipped by the matcher). Specs derive from
    the ``ShardingRules`` table. Overrides go in FRONT (first
    ``re.search`` hit wins)."""
    sp = rules.spec
    out = [
        # factored second-moment stats (adafactor v_row/v_col) are
        # rank-reduced mirrors named after their param: pinned replicated
        # by name, in front of the param rules
        (r"(^|/)v_(row|col)(/|$)", sp((None,))),
        (r"(^|/)embed$", sp(("vocab", "embed"))),
        (r"(attn_norm|mlp_norm|final_norm)$", sp((None,))),
        (r"wq$", sp(("embed", "heads", "head_dim"))),
        (r"(wk|wv)$", sp(("embed", "kv_heads", "head_dim"))),
        (r"wo$", sp(("heads", "head_dim", "embed"))),
        (r"lm_head$", sp(("embed", "vocab"))),
    ]
    if cfg.moe_experts > 0:
        return out + [
            (r"router$", sp((None, None))),
            (r"(w_gate|w_up)$", sp(("expert", "embed", "mlp"))),
            (r"w_down$", sp(("expert", "mlp", "embed"))),
        ]
    return out + [
        (r"(w_gate|w_up)$", sp(("embed", "mlp"))),
        (r"w_down$", sp(("mlp", "embed"))),
    ]


def param_shardings(cfg: LlamaConfig, mesh, rules) -> Dict[str, Any]:
    """Tree (same structure as ``logical_axes``) of DTensor placements."""
    la = logical_axes(cfg)

    def pl(axes):
        return spec_placements(mesh, rules.spec(axes))

    return {
        "embed": pl(la["embed"]),
        "layers": [{k: pl(v) for k, v in layer.items()} for layer in la["layers"]],
        "final_norm": pl(la["final_norm"]),
        "lm_head": pl(la["lm_head"]),
    }


def batch_sharding(mesh, rules) -> list:
    """Placements of a ``[batch, seq]`` token batch."""
    return spec_placements(mesh, rules.spec(("batch", "seq")))


@torch.no_grad()
def shard_model(cfg: LlamaConfig, model: "Llama", mesh, rules) -> "Llama":
    """Turn ``model``'s params, in place, into DTensors placed by the rule
    table (each param's ``partition_rules`` spec, which is its
    ``param_shardings`` entry). Every rank must hold the same full values
    (same seed, or the same loaded state): each keeps its own shard and
    nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    specs = match_partition_rules(partition_rules(cfg, rules), model)
    for path, spec in specs.items():
        owner, _, leaf = path.replace("/", ".").rpartition(".")
        mod = model.get_submodule(owner)
        full = getattr(mod, leaf)
        dt = distribute_tensor(full.detach(), placement_mesh(mesh),
                               spec_placements(mesh, spec), src_data_rank=None)
        setattr(mod, leaf, nn.Parameter(dt, requires_grad=full.requires_grad))
    return model


def init_sharded(cfg: LlamaConfig, mesh, rules, seed=0, optimizer=None):
    """Params (and the optimizer over them) straight onto the mesh:
    ``init_params(cfg, seed)`` on the mesh's device type, every param a
    DTensor placed by the rule table. The same seed gives the same values
    whatever the mesh (the unsharded init's draws, each rank keeping its
    shard). ``optimizer`` is a factory over the params, such as
    ``adamw(1e-3)``; its state (created at the first step, like each
    param) is pinned to the same table by the step."""
    model = shard_model(cfg, init_params(cfg, seed, device=mesh.device_type), mesh, rules)
    if optimizer is None:
        return model
    return model, optimizer(model.parameters())


def _to_torch(leaf) -> torch.Tensor:
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":  # numpy has no bf16: carry the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """A JAX Llama param tree (numpy leaves, or anything ``np.asarray``
    takes) → a ``Llama`` state dict. Same names, same shapes (the MoE
    ``router`` and stacked ``w_gate``/``w_up``/``w_down`` too): no transposes."""
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


def _replicated_like(x, t):
    """``t`` (the same full value on every rank) as an operand of ``x``: a
    replicated DTensor on ``x``'s mesh when ``x`` is a DTensor."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return t
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


SEQ_PARALLEL = ("ring", "ulysses")


def _attention(cfg: LlamaConfig, q, k, v, mesh, kv_repeat: int):
    """Causal attention on ``[B, S, H, hd]`` q/k/v (K/V at ``H // kv_repeat``
    heads). Ring/Ulysses run sequence-parallel over ``mesh``
    (``shard_map_compat``: DTensors, or plain full tensors). Flash on
    DTensors (batch and heads sharded independently, sequence whole) runs
    the kernel on each rank's local shard and comes back with q's
    placements; each rank's GQA groups must be whole."""
    from torch.distributed.tensor import DTensor

    if cfg.attention_impl in SEQ_PARALLEL:
        if mesh is None:
            raise ValueError(
                f"attention_impl={cfg.attention_impl!r} is sequence-parallel: "
                "pass the mesh to forward()/make_train_step()"
            )
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if cfg.attention_impl == "ring":
            o = ring_attention_sharded(qt, kt, vt, mesh, causal=True, kv_repeat=kv_repeat)
        else:
            o = ulysses_attention_sharded(qt, kt, vt, mesh, causal=True)
        return o.transpose(1, 2)

    def attend(q, k, v):
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            causal=True, impl=cfg.attention_impl)
        return o.transpose(1, 2)

    if not isinstance(q, DTensor):
        return attend(q, k, v)
    for t in (q, k, v):
        if any(p.is_shard(1) for p in t.placements):
            raise ValueError("flash attention needs the whole sequence on each rank "
                             "(with act_seq sharded, use attention_impl='ring' or 'ulysses')")
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    if ql.shape[2] % kl.shape[2] or kl.shape[2] * q.shape[2] != ql.shape[2] * k.shape[2]:
        raise ValueError(
            f"local heads {ql.shape[2]} (q) and {kl.shape[2]} (kv) split a GQA group of "
            f"{q.shape[2]} // {k.shape[2]}: shard heads and kv heads alike")
    return DTensor.from_local(attend(ql, kl, vl), q.device_mesh, q.placements, run_check=False)


def _repeat_heads(x, rep: int):
    """``[B, S, Hk, hd]`` -> ``[B, S, Hk * rep, hd]``, each kv head repeated
    ``rep`` times in place (``jnp.repeat``); expand + reshape, which DTensor
    shards through."""
    B, S, hk, hd = x.shape
    return x[:, :, :, None, :].expand(B, S, hk, rep, hd).reshape(B, S, hk * rep, hd)


def _attention_block(cfg: LlamaConfig, p, x, cos, sin, mesh=None, rules=None):
    h = rms_norm(x, p.attn_norm, cfg.norm_eps)
    rep = cfg.n_heads // cfg.n_kv_heads
    wk, wv, kv_axis = p.wk, p.wv, "act_kv_heads"
    tensor = mesh_axis_sizes(mesh)[TENSOR] if mesh is not None else 1
    pre_repeat = rep > 1 and cfg.n_kv_heads % tensor != 0
    if pre_repeat:
        # too few KV heads for the tensor axis: K/V's heads are gathered
        # (the params keep their rule's placements) and repeated to
        # n_heads, so each rank's GQA groups are whole (the reference's
        # sequence-parallel pre-repeat, here for every impl)
        wk, wv = (constrain(w, mesh, rules, ("embed", None, "head_dim")) for w in (wk, wv))
        kv_axis = "act_heads"
    q = torch.einsum("bsd,dhk->bshk", h, p.wq)
    k = torch.einsum("bsd,dhk->bshk", h, wk)
    v = torch.einsum("bsd,dhk->bshk", h, wv)
    if pre_repeat:
        k, v = _repeat_heads(k, rep), _repeat_heads(v, rep)
    # attention ENTRY pin: q/k/v leave the projection in the head-sharded
    # layout the attention runs on
    q = constrain(q, mesh, rules, ("act_batch", "act_seq", "act_heads", None))
    k = constrain(k, mesh, rules, ("act_batch", "act_seq", kv_axis, None))
    v = constrain(v, mesh, rules, ("act_batch", "act_seq", kv_axis, None))
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    # K/V stay at n_kv_heads unless pre-repeated (GQA in-kernel)
    o = _attention(cfg, q, k, v, mesh, 1 if pre_repeat else rep)
    # attention EXIT pin; the flash output is what selective remat saves
    o = constrain(o, mesh, rules, ("act_batch", "act_seq", "act_heads", None))
    out = x + torch.einsum("bshk,hkd->bsd", o.to(x.dtype), p.wo)
    return constrain(out, mesh, rules, ("act_batch", "act_seq", "act_embed"))


def _mlp_block(cfg: LlamaConfig, p, x, mesh=None, rules=None):
    """Dense or MoE FFN. Returns ``(x, aux_loss)``; the dense FFN's aux is
    None (the JAX block's 0.0)."""
    h = rms_norm(x, p.mlp_norm, cfg.norm_eps)
    if cfg.moe_experts > 0:
        # entry/exit pins bracket the expert compute, so the MoE FFN keeps
        # the dense branch's replicated-residual contract; under the rules
        # the tokens are routed whole (the JAX function's global routing)
        h = constrain(h, mesh, rules, ("act_batch", "act_seq", "act_embed"))
        params = {k: getattr(p, k) for k in MOE_PARAMS}
        kw = dict(top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor)
        if rules is None:
            out, aux = moe_ffn(params, h, **kw)
        else:
            out, aux = moe_ffn_sharded(params, h, mesh, **kw)
        out = constrain(x + out, mesh, rules, ("act_batch", "act_seq", "act_embed"))
        return out, aux["aux_loss"]
    gate = torch.einsum("bsd,dm->bsm", h, p.w_gate)
    up = torch.einsum("bsd,dm->bsm", h, p.w_up)
    # Megatron split: the hidden activation shards over tensor, the
    # down-projection's output all-reduces back to the replicated stream
    gate = constrain(gate, mesh, rules, ("act_batch", "act_seq", "act_mlp"))
    up = constrain(up, mesh, rules, ("act_batch", "act_seq", "act_mlp"))
    out = x + torch.einsum("bsm,md->bsd", F.silu(gate) * up, p.w_down)
    return constrain(out, mesh, rules, ("act_batch", "act_seq", "act_embed")), None


def _block(cfg: LlamaConfig, cos, sin, mesh, rules, x, p):
    # remat-boundary pin: the carry is the tensor saved at every
    # checkpoint boundary
    x = constrain(x, mesh, rules, ("act_batch", "act_seq", "act_embed"))
    x = _attention_block(cfg, p, x, cos, sin, mesh, rules)
    return _mlp_block(cfg, p, x, mesh, rules)


def _save_dots_and_flash(ctx, op, *args, **kwargs):
    """The JAX selective policy (``dots_with_no_batch_dims_saveable`` +
    ``save_only_these_names("flash_attn_out")``) as a per-op policy: the
    projections' products (einsum lowers a dot with no batch dims to
    ``bmm`` with batch 1, or ``mm``) and the flash forward's outputs are
    saved; norms, RoPE, SiLU, casts and residual adds are recomputed."""
    if op is torch.ops.aten.mm.default or op is torch.ops.ray_tpu_torch.flash_attention_fwd.default:
        return CheckpointPolicy.MUST_SAVE
    if op is torch.ops.aten.bmm.default and args[0].shape[0] == 1:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _selective_context():
    return create_selective_checkpoint_contexts(_save_dots_and_flash)


def _remat_policy(remat):
    """``remat``: False (no checkpointing), True/"full" (recompute every
    layer in the backward), or "selective" (save matmul outputs and the
    flash-attention output, recompute only the cheap elementwise tail).
    Returns ``(context_fn or None, do_remat)``."""
    if remat in (False, None):
        return None, False
    if remat is True or remat == "full":
        return None, True
    if remat == "selective":
        return _selective_context, True
    raise ValueError(f"remat must be False, True, 'full', or 'selective'; got {remat!r}")


def forward(cfg: LlamaConfig, params: Llama, tokens, *, remat=False, mesh=None, rules=None,
            return_aux: bool = False):
    """tokens [B, S] int → logits [B, S, vocab] (f32).

    ``mesh`` is required for the sequence-parallel attention impls
    ("ring"/"ulysses"), which run over its ``seq`` axis; without ``rules``
    the rest of the model runs on plain tensors (the full values on every
    rank), and for the other impls a mesh alone is ignored. With ``rules``
    (a ``ShardingRules``) AND a mesh, every intermediate is pinned to the
    table (DTensors throughout; the params must be DTensors, see
    ``init_sharded``). ``remat``: False | True/"full" | "selective"
    (``torch.utils.checkpoint`` per layer; see ``_remat_policy``). With
    ``return_aux`` also returns the summed MoE load-balance loss."""
    context_fn, do_remat = _remat_policy(remat)
    if mesh is None or rules is None:
        rules = None
        if cfg.attention_impl not in SEQ_PARALLEL:
            mesh = None
    B, S = tokens.shape
    # the lookup reads a replicated table: the all-gather of a sharded
    # table is voluntary (ZeRO-3: params materialize for compute)
    emb = constrain(params.embed, mesh, rules, (None, None))
    tokens = constrain(tokens, mesh, rules, ("act_batch", "act_seq"))
    x = F.embedding(tokens, emb)
    x = constrain(x, mesh, rules, ("act_batch", "act_seq", "act_embed"))
    cos, sin = (_replicated_like(x, t) for t in rope_tables(cfg, S, device=x.device))
    block = functools.partial(_block, cfg, cos, sin, mesh, rules)
    aux = None
    for p in params.layers:
        if not do_remat:
            x, layer_aux = block(x, p)
        elif context_fn is None:
            x, layer_aux = checkpoint(block, x, p, use_reentrant=False)
        else:
            x, layer_aux = checkpoint(block, x, p, use_reentrant=False, context_fn=context_fn)
        if layer_aux is not None:
            aux = layer_aux if aux is None else aux + layer_aux
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x, params.lm_head).float()
    logits = constrain(logits, mesh, rules, ("act_batch", "act_seq", "act_vocab"))
    if not return_aux:
        return logits
    if aux is None:
        aux = _replicated_like(x, torch.zeros((), dtype=torch.float32, device=x.device))
    return logits, aux


def next_token_loss(cfg: LlamaConfig, params: Llama, tokens, targets, *, remat=False,
                    mesh=None, rules=None):
    """Mean next-token NLL (f32 log-softmax over the vocabulary) plus
    ``moe_aux_loss_coeff`` times the summed MoE aux loss (the dense FFN's
    is 0, and adding it is skipped). Sharded, the loss is a replicated
    scalar DTensor."""
    logits, aux = forward(cfg, params, tokens, remat=remat, mesh=mesh, rules=rules,
                          return_aux=True)
    if mesh is None or rules is None:
        loss = F.cross_entropy(logits.reshape(-1, cfg.vocab_size), targets.reshape(-1).long())
    else:
        targets = constrain(targets, mesh, rules, ("act_batch", "act_seq"))
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None].long())
        loss = constrain(nll.mean(), mesh, rules, ())
    if cfg.moe_experts > 0:
        loss = loss + cfg.moe_aux_loss_coeff * aux
    return loss


# ---------------------------------------------------------------------------
# training step


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4):
    """``optax.adamw``'s defaults as a ``torch.optim.AdamW`` factory (torch's
    own default decay is 1e-2): ``adamw(1e-3)(model.parameters())``."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


def _check_placed(tree, mesh, prules, what: str, want: dict) -> None:
    """Every leaf of ``tree`` is a DTensor on ``mesh`` with the placements
    its partition rule gives (scalars, which the rules skip, excepted).
    ``want`` caches the placements by path and shape across calls."""
    from torch.distributed.tensor import DTensor

    names, leaves = tree_path_names(tree), tree_leaves(tree)
    missing = [(n, x) for n, x in zip(names, leaves) if (n, tuple(x.shape)) not in want]
    if missing:
        specs = tree_leaves(match_partition_rules(prules, dict(missing)))
        for (name, leaf), spec in zip(missing, specs):
            want[name, tuple(leaf.shape)] = tuple(spec_placements(mesh, spec))
    for name, leaf in zip(names, leaves):
        if leaf.dim() == 0 or leaf.numel() == 1:
            continue
        placed = want[name, tuple(leaf.shape)]
        if not isinstance(leaf, DTensor) or tuple(leaf.placements) != placed:
            got = tuple(leaf.placements) if isinstance(leaf, DTensor) else "a plain tensor"
            raise ValueError(f"{what} {name!r} is {got}, its rule places it {placed} "
                             "(build the model with init_sharded)")


def make_train_step(cfg: LlamaConfig, *, remat=False, mesh=None, rules=None):
    """Returns ``step((model, opt), batch) → ((model, opt), loss)``, where
    ``opt`` is a ``torch.optim`` optimizer over the model's parameters
    (e.g. ``adamw(1e-3)(model.parameters())``; the JAX step takes the optax
    transformation instead, and its state the optax state). Parameters
    and optimizer state update in place, the port's analogue of the JAX
    step's donation.

    With ``rules`` (a ``ShardingRules``) and ``mesh``, the unified
    named-sharding path engages: params (DTensors from ``init_sharded``),
    grads and optimizer state are all held to the one spec table
    (``partition_rules`` + ``match_partition_rules``) and the forward pins
    its intermediates. The grads leave the backward with the placements
    DTensor's rules give them (partial sums over the batch axes), and
    pinning them to the params' placements is the gradient all-reduce or
    reduce-scatter. Without ``rules``, ``mesh`` serves only the
    sequence-parallel attention impls (as in the JAX step). ``remat``:
    False | True/"full" | "selective"."""
    _remat_policy(remat)
    if mesh is None or rules is None:

        def step(state, batch):
            model, opt = state
            opt.zero_grad(set_to_none=True)
            loss = next_token_loss(cfg, model, batch["tokens"], batch["targets"], remat=remat,
                                   mesh=mesh)
            loss.backward()
            opt.step()
            return (model, opt), loss.detach()

        return step

    prules = partition_rules(cfg, rules)
    placed: dict = {}  # (path, shape) -> placements, for _check_placed

    def sharded_step(state, batch):
        model, opt = state
        _check_placed(model, mesh, prules, "param", placed)
        names = [n.replace(".", "/") for n, _ in model.named_parameters()]
        params = list(model.parameters())
        loss = next_token_loss(cfg, model, batch["tokens"], batch["targets"], remat=remat,
                               mesh=mesh, rules=rules)
        grads = constrain_tree(dict(zip(names, torch.autograd.grad(loss, params))), mesh, prules)
        for p, g in zip(params, grads.values()):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)
        _check_placed(optimizer_state(model, opt), mesh, prules, "optimizer state", placed)
        return (model, opt), loss.detach().full_tensor()

    return sharded_step


def host_state(model: Llama, opt) -> Dict[str, Dict[str, Any]]:
    """A checkpoint of ``model`` and its optimizer as full host tensors:
    ``{"params": {path: tensor}, "optimizer": {state_key: {path: tensor}}}``
    (paths as ``optimizer_state`` names them). DTensors are gathered, so
    every rank of the mesh calls it."""
    from torch.distributed.tensor import DTensor

    def host(t):
        if isinstance(t, DTensor):
            t = t.full_tensor()
        return t.detach().cpu().clone()

    return {
        "params": {n.replace(".", "/"): host(p) for n, p in model.named_parameters()},
        "optimizer": {key: {path: host(t) for path, t in by_path.items()}
                      for key, by_path in optimizer_state(model, opt).items()},
    }


@torch.no_grad()
def load_host_state(model: Llama, opt, state: Dict[str, Dict[str, Any]]) -> None:
    """Load ``host_state``'s checkpoint into ``model`` and ``opt`` in place,
    each tensor placed as the param it belongs to (every rank keeps its
    shard of the full host value)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    params = {n.replace(".", "/"): p for n, p in model.named_parameters()}

    def like(p, value):
        value = value.to(device=p.device, dtype=p.dtype)
        if isinstance(p, DTensor):
            return distribute_tensor(value, p.device_mesh, p.placements, src_data_rank=None)
        return value

    for path, value in state["params"].items():
        params[path].copy_(like(params[path], value))
    for key, by_path in state["optimizer"].items():
        for path, value in by_path.items():
            p = params[path]
            # a scalar (AdamW's ``step``) stays a plain tensor, as AdamW makes it
            opt.state[p][key] = value.clone() if value.dim() == 0 else like(p, value)


# ---------------------------------------------------------------------------
# paged-KV autoregressive decode (inference engine path)
#
# The reference's layout: one K and one V tensor of shape
#   [n_layers, num_blocks, block_size, n_kv_heads, head_dim]
# shared by every request; token position p of a request lives at
# (blocks[p // block_size], p % block_size) in every layer. K/V stay at
# n_kv_heads and queries are grouped [n_kv, rep] at score time. Block id 0
# is the NULL block: padding positions write into it and masked reads
# from it never reach the softmax, so every step has static shapes.
#
# The steps update the cache IN PLACE (``index_put_``), the port's
# counterpart of the JAX step's donation, and run under
# ``torch.inference_mode`` (entered per call: the mode is thread-local and
# the engine calls them from its step thread). Indices are ``torch.long``
# on the cache's device. Attention is plain torch ops over the gathered
# blocks, as the JAX steps compute it outside any Pallas kernel.


@torch.inference_mode()
def init_paged_kv_cache(cfg: LlamaConfig, num_blocks: int, block_size: int, dtype=None, *,
                        device=None) -> Dict[str, torch.Tensor]:
    """Paged KV cache (zeros; block 0 reserved as null) on ``device``."""
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    dt = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def paged_cache_from_jax(cache) -> Dict[str, torch.Tensor]:
    """A JAX paged cache dict (numpy leaves, or anything ``np.asarray``
    takes) → torch tensors on the CPU, bf16 bits carried as they are."""
    return {"k": _to_torch(cache["k"]), "v": _to_torch(cache["v"])}


@torch.inference_mode()
def copy_paged_blocks(cache, src, dst) -> None:
    """Duplicate whole cache blocks (prefix-cache COW): ``src``/``dst`` are
    [P] block ids; every layer's K/V rows at ``dst`` become copies of
    ``src``. All sources are read (the right-hand side is a copy) before
    any destination is written. Padding pairs point both ids at block 0."""
    for name in ("k", "v"):
        cache[name][:, dst] = cache[name][:, src]


@torch.inference_mode()
def gather_paged_blocks(cache, blocks) -> torch.Tensor:
    """Whole cache blocks, stacked ``[2, n_layers, P, block_size, n_kv,
    head_dim]`` (K at index 0, V at 1); ``blocks`` is [P] ids padded with 0."""
    return torch.stack([cache["k"][:, blocks], cache["v"][:, blocks]])


@torch.inference_mode()
def scatter_paged_blocks(cache, blocks, kv) -> None:
    """Write blocks in the ``gather_paged_blocks`` layout into the cache.
    Padding entries point at block 0: duplicate writes land trash on trash."""
    cache["k"][:, blocks] = kv[0].to(cache["k"].dtype)
    cache["v"][:, blocks] = kv[1].to(cache["v"].dtype)


def _rope_at(cfg: LlamaConfig, positions):
    """cos/sin tables at arbitrary int positions: [N] -> ([N, hd/2] x2)."""
    hd = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                                      device=positions.device) / hd))
    ang = positions.float()[:, None] * inv_freq[None, :]
    return torch.cos(ang), torch.sin(ang)


def _apply_rope_flat(x, cos, sin):
    """x: [N, H, hd] with per-row position tables [N, hd/2]."""
    x1, x2 = x[..., ::2], x[..., 1::2]
    c = cos[:, None, :]
    s = sin[:, None, :]
    out1 = x1 * c - x2 * s
    out2 = x2 * c + x1 * s
    return torch.stack([out1, out2], dim=-1).reshape(x.shape).to(x.dtype)


def _scatter_kv(cache, layer: int, blk, off, k, v) -> None:
    """Write per-token K/V into their cache slots. blk/off: [N] long,
    k/v: [N, n_kv, hd]. Padding rows target the null block."""
    cache["k"][layer].index_put_((blk, off), k.to(cache["k"].dtype))
    cache["v"][layer].index_put_((blk, off), v.to(cache["v"].dtype))


def _paged_layers(cfg: LlamaConfig, params: Llama, cache, tokens, tables, pos, blk, mask):
    """The layer stack shared by the three steps, on B sequences of C
    positions each. tokens/pos/blk: [B, C]; tables: [B, M]; mask:
    [B, C, M*bs] (key visible to query). Writes every position's K/V
    (slot ``(blk, pos % bs)``), then gathers each sequence's blocks —
    AFTER the scatter, so a window attends to itself. Returns the final
    normed hidden states [B, C, D]."""
    B, C = tokens.shape
    M = tables.shape[1]
    bs = cache["k"].shape[2]
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    rep = cfg.n_heads // kv
    scale = 1.0 / math.sqrt(hd)
    flat_pos, flat_blk = pos.reshape(B * C), blk.reshape(B * C)
    off = flat_pos % bs
    cos, sin = _rope_at(cfg, flat_pos)
    # the score dtype of the JAX einsum: the promotion of q's and the cache's
    ct = torch.promote_types(params.embed.dtype, cache["k"].dtype)

    x = params.embed[tokens]  # [B, C, D]
    for layer, p in enumerate(params.layers):
        h = rms_norm(x, p.attn_norm, cfg.norm_eps)
        q = torch.einsum("bcd,dhk->bchk", h, p.wq)
        k = torch.einsum("bcd,dhk->bchk", h, p.wk)
        v = torch.einsum("bcd,dhk->bchk", h, p.wv)
        q = _apply_rope_flat(q.reshape(B * C, cfg.n_heads, hd), cos, sin)
        k = _apply_rope_flat(k.reshape(B * C, kv, hd), cos, sin)
        _scatter_kv(cache, layer, flat_blk, off, k, v.reshape(B * C, kv, hd))
        ks = cache["k"][layer][tables].reshape(B, M * bs, kv, hd)
        vs = cache["v"][layer][tables].reshape(B, M * bs, kv, hd)
        qg = q.reshape(B, C, kv, rep, hd)
        # scores rounded to the operands' dtype, then f32 (as the reference)
        s = torch.einsum("bcgrh,bsgh->bcgrs", qg.to(ct), ks.to(ct)).float() * scale
        s = s.masked_fill(~mask[:, :, None, None, :], -1e30)
        pattn = torch.softmax(s, dim=-1)
        o = torch.einsum("bcgrs,bsgh->bcgrh", pattn.to(vs.dtype), vs)
        o = o.reshape(B, C, cfg.n_heads, hd)
        x = x + torch.einsum("bchk,hkd->bcd", o.to(x.dtype), p.wo)
        hm = rms_norm(x, p.mlp_norm, cfg.norm_eps)
        gate = torch.einsum("bcd,dm->bcm", hm, p.w_gate)
        up = torch.einsum("bcd,dm->bcm", hm, p.w_up)
        x = x + torch.einsum("bcm,md->bcd", F.silu(gate) * up, p.w_down)
    return rms_norm(x, params.final_norm, cfg.norm_eps)


def _check_paged(cfg: LlamaConfig) -> None:
    if cfg.moe_experts > 0:
        raise NotImplementedError(
            "paged decode does not support MoE FFNs yet (ROADMAP Queue A: MoE)"
        )


@torch.inference_mode()
def paged_prefill_step(cfg: LlamaConfig, params: Llama, cache, tokens, block_table,
                       ctx_len: int, true_len: int):
    """One prefill chunk for ONE request, fixed shapes.

    tokens: [C] (right-padded chunk), block_table: [M] (padded with 0 =
    null), ``ctx_len``: tokens ALREADY cached (chunked prefill: > 0 from
    the second chunk on), ``true_len``: valid tokens in this chunk. Writes
    the chunk's K/V into ``cache`` in place, attends causally over cached
    context + chunk, and returns ``logits [vocab]`` (f32) of the chunk's
    last valid token."""
    _check_paged(cfg)
    C = tokens.shape[0]
    M = block_table.shape[0]
    bs = cache["k"].shape[2]
    idx = torch.arange(C, device=tokens.device)
    pos = ctx_len + idx  # global positions of the chunk's tokens
    valid = idx < true_len
    blk = torch.where(valid, block_table[torch.clamp(pos // bs, max=M - 1)], 0)
    # key j (global position) visible to chunk query i iff j <= ctx_len+i
    key_pos = torch.arange(M * bs, device=tokens.device)
    mask = key_pos[None, :] <= pos[:, None]  # [C, M*bs]
    x = _paged_layers(cfg, params, cache, tokens[None], block_table[None], pos[None],
                      blk[None], mask[None])
    last = max(true_len - 1, 0)
    return torch.einsum("d,dv->v", x[0, last], params.lm_head).float()


@torch.inference_mode()
def paged_verify_step(cfg: LlamaConfig, params: Llama, cache, tokens, block_tables, ctx_lens,
                      true_lens):
    """Speculative verification for a BATCH of slots, fixed shapes.

    tokens: [B, C] (right-padded windows ``[last_committed, d_1..d_k]``),
    block_tables: [B, M], ctx_lens: [B] tokens already cached per slot,
    true_lens: [B] valid window lengths (0 for padding slots: every
    position masks invalid, writes land on the null block). Writes K/V in
    place and returns ``logits [B, C, vocab]`` (f32) for EVERY window
    position. Rejected tail positions leave stale K/V behind, never read:
    every mask stops at the committed context."""
    _check_paged(cfg)
    B, C = tokens.shape
    M = block_tables.shape[1]
    bs = cache["k"].shape[2]
    idx = torch.arange(C, device=tokens.device)
    pos = ctx_lens[:, None] + idx[None, :]  # [B, C] global positions
    valid = idx[None, :] < true_lens[:, None]
    brange = torch.arange(B, device=tokens.device)
    blk = torch.where(valid, block_tables[brange[:, None], torch.clamp(pos // bs, max=M - 1)], 0)
    key_pos = torch.arange(M * bs, device=tokens.device)
    mask = key_pos[None, None, :] <= pos[:, :, None]  # [B, C, M*bs]
    x = _paged_layers(cfg, params, cache, tokens, block_tables, pos, blk, mask)
    return torch.einsum("bcd,dv->bcv", x, params.lm_head).float()


@torch.inference_mode()
def paged_decode_step(cfg: LlamaConfig, params: Llama, cache, tokens, positions, block_tables,
                      ctx_lens):
    """One decode step for a BATCH of slots, fixed shapes.

    tokens: [B] (this step's input token per slot), positions: [B] (its
    global position), block_tables: [B, M], ctx_lens: [B] (visible context
    INCLUDING this token = positions+1 for active slots; padding slots
    carry ctx_len=1 and null blocks so the softmax stays finite). Writes
    K/V in place and returns ``logits [B, vocab]`` (f32)."""
    _check_paged(cfg)
    B, M = block_tables.shape
    bs = cache["k"].shape[2]
    brange = torch.arange(B, device=tokens.device)
    blk = block_tables[brange, torch.clamp(positions // bs, max=M - 1)]
    key_pos = torch.arange(M * bs, device=tokens.device)
    mask = key_pos[None, :] < ctx_lens[:, None]  # [B, M*bs]
    x = _paged_layers(cfg, params, cache, tokens[:, None], block_tables, positions[:, None],
                      blk[:, None], mask[:, None])
    return torch.einsum("bd,dv->bv", x[:, 0], params.lm_head).float()


def entry(device=None):
    """The tiny forward at seq 128 (as ``__graft_entry__.entry``): returns
    ``(fn, (params, tokens))``."""
    cfg = LlamaConfig.tiny(max_seq_len=128)
    params = init_params(cfg, 0, device=device)
    tokens = torch.zeros((2, 128), dtype=torch.long, device=params.embed.device)

    def fn(params, tokens):
        return forward(cfg, params, tokens)

    return fn, (params, tokens)
