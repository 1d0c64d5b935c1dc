"""RL models: MLP policy/value networks, MLP and CNN Q-networks (port of
``ray_tpu.rl.models``).

Params are plain trees (dicts and lists of tensors) with the JAX package's
names and shapes, so a JAX tree converts with ``params_from_jax`` and no
transposes: dense weights are ``[fan_in, fan_out]`` and conv kernels stay
HWIO ``[k, k, in, out]``, permuted to torch's OIHW where they are applied.
Images are NHWC, as in the JAX package; the conv stack runs in NCHW and
permutes back before the flatten, so the dense layer sees the features in
JAX's (h, w, c) order. ``init_*`` draw from an explicit
``torch.Generator`` on its own device (not JAX's threefry bits). The same
functions serve rollout actors (CPU) and learners (the card)."""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_leaves, tree_map  # noqa: F401 (the package's tree helpers)


def params_from_jax(tree):
    """A JAX param tree (numpy leaves, or anything ``np.asarray`` takes) →
    the same tree of CPU tensors: same names, same shapes."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def to_host(tree):
    """A numpy snapshot of a param tree: what is sent to rollout actors,
    which may hold no card, and what the next optimizer step cannot change."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device) * scale


def _zeros(gen: torch.Generator, n: int) -> torch.Tensor:
    return torch.zeros((n,), device=gen.device)


def _linear(x, layer):
    """``x @ w + b``, both operands in their promoted type (JAX's rule for a
    product of mixed dtypes)."""
    dt = torch.promote_types(x.dtype, layer["w"].dtype)
    return x.to(dt) @ layer["w"].to(dt) + layer["b"].to(dt)


def init_mlp_policy(
    gen: torch.Generator,
    obs_dim: int,
    num_actions: int,
    hidden: Sequence[int] = (64, 64),
) -> Dict[str, Any]:
    """Shared torso + policy logits head + value head."""
    params: Dict[str, Any] = {"layers": [], "pi": None, "vf": None}
    sizes = [obs_dim, *hidden]
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        params["layers"].append(
            {"w": _normal(gen, (fan_in, fan_out), math.sqrt(2.0 / fan_in)),
             "b": _zeros(gen, fan_out)}
        )
    last = sizes[-1]
    params["pi"] = {"w": _normal(gen, (last, num_actions), 0.01), "b": _zeros(gen, num_actions)}
    params["vf"] = {"w": _normal(gen, (last, 1), 1.0), "b": _zeros(gen, 1)}
    return params


def apply_mlp_policy(params: Dict[str, Any], obs: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """obs [B, obs_dim] → (logits [B, A], value [B])."""
    x = obs
    for layer in params["layers"]:
        x = torch.tanh(_linear(x, layer))
    return _linear(x, params["pi"]), _linear(x, params["vf"])[..., 0]


# ---------------------------------------------------------------------------
# Q-networks (DQN) — MLP for vector obs, CNN for image obs


def init_mlp_q(
    gen: torch.Generator,
    obs_dim: int,
    num_actions: int,
    hidden: Sequence[int] = (128, 128),
) -> Dict[str, Any]:
    """MLP Q-network: obs -> Q(s, a) per action."""
    params: Dict[str, Any] = {"layers": [], "q": None}
    sizes = [obs_dim, *hidden]
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        params["layers"].append(
            {"w": _normal(gen, (fan_in, fan_out), math.sqrt(2.0 / fan_in)),
             "b": _zeros(gen, fan_out)}
        )
    params["q"] = {"w": _normal(gen, (sizes[-1], num_actions), 0.01),
                   "b": _zeros(gen, num_actions)}
    return params


def apply_mlp_q(params: Dict[str, Any], obs: torch.Tensor) -> torch.Tensor:
    """obs [B, obs_dim] -> q-values [B, A]."""
    x = obs.reshape(obs.shape[0], -1)
    for layer in params["layers"]:
        x = F.relu(_linear(x, layer))
    return _linear(x, params["q"])


#: Atari-style conv stack (reference rllib CNN defaults): NHWC input.
DEFAULT_CONV = ((16, 8, 4), (32, 4, 2), (32, 3, 1))  # (channels, kernel, stride)


def init_cnn(
    gen: torch.Generator,
    obs_shape: Sequence[int],  # (H, W, C)
    num_actions: int,
    *,
    conv: Sequence[Tuple[int, int, int]] = DEFAULT_CONV,
    dense: int = 256,
    heads: Sequence[str] = ("q",),
) -> Dict[str, Any]:
    """Conv torso + dense + one linear head per name in ``heads`` ("q" for
    DQN, "pi"+"vf" for actor-critic on images)."""
    if tuple(conv) != DEFAULT_CONV:
        raise ValueError(
            "custom conv stacks need their own apply fn: the module-level "
            "apply_cnn_* assume DEFAULT_CONV's strides"
        )
    h, w, c = obs_shape
    params: Dict[str, Any] = {"conv": [], "dense": None}
    in_ch = c
    for out_ch, k, s in conv:
        params["conv"].append(
            {"w": _normal(gen, (k, k, in_ch, out_ch), math.sqrt(2.0 / (k * k * in_ch))),
             "b": _zeros(gen, out_ch)}
        )
        h = -(-h // s)  # ceil division (SAME padding)
        w = -(-w // s)
        in_ch = out_ch
    flat = h * w * in_ch
    params["dense"] = {"w": _normal(gen, (flat, dense), math.sqrt(2.0 / flat)),
                       "b": _zeros(gen, dense)}
    for head in heads:
        out = 1 if head == "vf" else num_actions
        params[head] = {"w": _normal(gen, (dense, out), 0.01), "b": _zeros(gen, out)}
    return params


def same_padding(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's ``padding="SAME"`` for one spatial dim of size ``n``: the output
    has ``ceil(n / s)`` positions, and an odd total pads one more at the
    end (at 84 with k=4, s=2: (1, 2)), which ``nn.Conv2d``'s symmetric
    padding cannot express."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _cnn_torso(params: Dict[str, Any], obs: torch.Tensor) -> torch.Tensor:
    x = obs.permute(0, 3, 1, 2)  # NHWC -> NCHW
    for layer, (_ch, k, stride) in zip(params["conv"], DEFAULT_CONV):
        dt = torch.promote_types(x.dtype, layer["w"].dtype)
        (hlo, hhi), (wlo, whi) = (same_padding(n, k, stride) for n in x.shape[2:])
        x = F.pad(x.to(dt), (wlo, whi, hlo, hhi))
        x = F.conv2d(x, layer["w"].to(dt).permute(3, 2, 0, 1), layer["b"].to(dt), stride=stride)
        x = F.relu(x)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # JAX's (h, w, c) flatten
    return F.relu(_linear(x, params["dense"]))


def _image_input(obs: torch.Tensor) -> torch.Tensor:
    """uint8 frames scale to [0, 1] in f32; float input is used as is."""
    return obs.float() / 255.0 if obs.dtype == torch.uint8 else obs


def apply_cnn_q(params: Dict[str, Any], obs: torch.Tensor) -> torch.Tensor:
    """obs [B, H, W, C] (float or uint8) -> q-values [B, A]."""
    return _linear(_cnn_torso(params, _image_input(obs)), params["q"])


def apply_cnn_policy(params: Dict[str, Any], obs: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """obs [B, H, W, C] -> (logits [B, A], value [B]) — the image-obs
    actor-critic head pair (PPO/IMPALA on pixels)."""
    x = _cnn_torso(params, _image_input(obs))
    return _linear(x, params["pi"]), _linear(x, params["vf"])[:, 0]
