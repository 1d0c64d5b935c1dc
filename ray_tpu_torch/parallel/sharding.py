"""Logical-axis sharding rules → DTensor placements (port of
``ray_tpu.parallel.sharding``).

Models annotate tensors with *logical* axis names ("batch", "embed",
"mlp", ...) and a ``ShardingRules`` table maps logical names to mesh axes,
so swapping a rules table re-parallelizes the whole model. The JAX package
turns a spec into a ``NamedSharding`` and pins it with
``with_sharding_constraint``; the port turns it into one DTensor placement
per mesh dimension and pins it with ``redistribute`` (or
``distribute_tensor`` for a plain tensor).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

from ray_tpu_torch.parallel.mesh import (
    DATA,
    EXPERT,
    FSDP,
    SEQUENCE,
    TENSOR,
    mesh_axis_sizes,
    placement_mesh,
)

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Mesh axes per tensor dim (``None``, an axis name, or a tuple of axis
    names), as ``jax.sharding.PartitionSpec``: ``PartitionSpec("fsdp",
    None)``. Dims past its length are unsharded."""

    def __new__(cls, *entries: MeshAxes):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclass
class ShardingRules:
    """logical axis name -> mesh axis (or tuple of mesh axes, or None)."""

    rules: Dict[str, MeshAxes] = field(default_factory=dict)

    def __getitem__(self, logical: str) -> MeshAxes:
        return self.rules.get(logical)

    def spec(self, logical_axes: Sequence[Optional[str]]) -> PartitionSpec:
        """PartitionSpec for a tensor annotated with logical axis names.
        Trailing ``None`` entries are stripped, as the JAX table does."""
        entries = [self.rules.get(a) if a else None for a in logical_axes]
        while entries and entries[-1] is None:
            entries.pop()
        return PartitionSpec(*entries)

    def with_overrides(self, **updates: MeshAxes) -> "ShardingRules":
        merged = dict(self.rules)
        merged.update(updates)
        return ShardingRules(merged)


# Canonical rule tables ---------------------------------------------------

def ddp_rules() -> ShardingRules:
    """Pure data parallel: batch over (data, fsdp); params replicated."""
    return ShardingRules(
        {
            "batch": (DATA, FSDP),
            "seq": None,
            "embed": None,
            "mlp": None,
            "heads": None,
            "kv_heads": None,
            "head_dim": None,
            "vocab": None,
            "expert": None,
            # activation axes (``act_*``): how INTERMEDIATE tensors shard,
            # distinct from the parameter axes above
            "act_batch": (DATA, FSDP),
            "act_seq": None,
            "act_embed": None,
            "act_heads": None,
            "act_kv_heads": None,
            "act_mlp": None,
            "act_vocab": None,
        }
    )


def fsdp_rules() -> ShardingRules:
    """ZeRO-3 equivalent: params sharded on fsdp over their embed dim;
    batch over (data, fsdp); activations batch-sharded only."""
    return ShardingRules(
        {
            "batch": (DATA, FSDP),
            "seq": None,
            "embed": FSDP,
            "mlp": None,
            "heads": None,
            "kv_heads": None,
            "head_dim": None,
            "vocab": None,
            "expert": None,
            "act_batch": (DATA, FSDP),
            "act_seq": None,
            "act_embed": None,
            "act_heads": None,
            "act_kv_heads": None,
            "act_mlp": None,
            "act_vocab": None,
        }
    )


def tp_rules() -> ShardingRules:
    """Megatron-style tensor parallel: mlp/heads/vocab over tensor;
    params' embed dim over fsdp; batch over (data, fsdp); sequence over
    seq (ring attention). Activations: heads/mlp-hidden/vocab shard over
    tensor (the Megatron split), the residual stream stays replicated
    across tensor ranks, sequence rides the seq axis."""
    return ShardingRules(
        {
            "batch": (DATA, FSDP),
            "seq": SEQUENCE,
            "embed": FSDP,
            "mlp": TENSOR,
            "heads": TENSOR,
            "kv_heads": TENSOR,
            "head_dim": None,
            "vocab": TENSOR,
            "expert": EXPERT,
            "act_batch": (DATA, FSDP),
            "act_seq": SEQUENCE,
            "act_embed": None,
            "act_heads": TENSOR,
            "act_kv_heads": TENSOR,
            "act_mlp": TENSOR,
            "act_vocab": TENSOR,
        }
    )


def spec_placements(mesh, spec: Sequence[MeshAxes]) -> list:
    """One DTensor placement per dim of ``placement_mesh(mesh)`` for a
    PartitionSpec: ``Shard(d)`` where the spec names that mesh axis for
    tensor dim ``d``, else ``Replicate()`` (an axis of size 1 shards
    nothing). A dim over several mesh axes must name them in the mesh's
    order (major to minor), which is the order DTensor nests them in."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    dim_of: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: dim {d} names {axes} out of the mesh's order {names}")
        for a in axes:
            if a in dim_of:
                raise ValueError(f"spec {spec} names mesh axis {a!r} twice")
            dim_of[a] = d
    placed = placement_mesh(mesh).mesh_dim_names
    return [Shard(dim_of[n]) if n in dim_of else Replicate() for n in placed]


def logical_to_sharding(mesh, rules: ShardingRules, logical_axes: Sequence[Optional[str]]):
    """DTensor placements (one per mesh dim) for a logically annotated tensor."""
    return spec_placements(mesh, rules.spec(logical_axes))


# Regex partition rules ----------------------------------------------------
#
# The named-sharding source of truth for whole trees: an ordered list of
# ``(regex, PartitionSpec)`` pairs matched against each leaf's '/'-joined
# path. A tree is a nested dict/list/tuple of tensors; an ``nn.Module``
# counts as the dict of its parameters by name, with ``.`` written as ``/``
# (``layers/3/wq``, the JAX path). Optimizer state (``optimizer_state``)
# names each leaf after its param (``exp_avg/layers/3/wq``), so ``wq$``
# matches it too; scalar leaves like AdamW's ``step`` are skipped.


def _items(tree: Any):
    """(key, child) pairs of a tree node, or None for a leaf."""
    from torch import nn

    if isinstance(tree, nn.Module):
        return [(name.replace(".", "/"), p) for name, p in tree.named_parameters()]
    if isinstance(tree, Mapping):
        return list(tree.items())
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return list(enumerate(tree))
    return None


def _map(fn: Callable[[str, Any], Any], tree: Any, path: str, sep: str):
    from torch import nn

    items = _items(tree)
    if items is None:
        return fn(path, tree)
    out = [(k, _map(fn, v, f"{path}{sep}{k}" if path else str(k), sep)) for k, v in items]
    if isinstance(tree, (nn.Module, Mapping)):
        return dict(out)
    return type(tree)(v for _, v in out)


def named_tree_map(fn: Callable[[str, Any], Any], tree: Any, sep: str = "/") -> Any:
    """``tree_map`` where ``fn(path_name, leaf)`` also sees the leaf's
    '/'-joined key path. A module maps to a dict keyed by parameter path."""
    return _map(fn, tree, "", sep)


def tree_path_names(tree: Any, sep: str = "/") -> List[str]:
    """'/'-joined key path for every leaf, in tree order."""
    names: List[str] = []
    _map(lambda name, leaf: names.append(name), tree, "", sep)
    return names


def tree_leaves(tree: Any) -> list:
    """Every leaf, in the order of ``tree_path_names``."""
    leaves: list = []
    _map(lambda name, leaf: leaves.append(leaf), tree, "", "/")
    return leaves


def optimizer_state(model, optimizer) -> Dict[str, Dict[str, Any]]:
    """A ``torch.optim`` optimizer's state as a tree named after the
    params: ``{state_key: {param_path: tensor}}`` (paths as the module's
    tree), so partition rules written for the params match it."""
    names = {id(p): name.replace(".", "/") for name, p in model.named_parameters()}
    out: Dict[str, Dict[str, Any]] = {}
    for p, state in optimizer.state.items():
        for key, value in state.items():
            out.setdefault(key, {})[names[id(p)]] = value
    return out


def match_partition_rules(rules, tree: Any):
    """Tree of ``PartitionSpec`` for ``tree`` from ordered regex rules.

    ``rules``: sequence of ``(pattern, PartitionSpec)``; the FIRST
    ``re.search`` hit wins, so overrides go in front. Scalar leaves
    (0-d or single-element) are never partitioned — they map to
    ``PartitionSpec()`` without consulting the rules. A non-scalar leaf
    with no matching rule raises: silent replication is how shardings
    drift apart across the step. A matched spec LONGER than the leaf's
    rank means the leaf is a rank-reduced mirror of the param the rule was
    written for, and it replicates instead of raising."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    def get_spec(name: str, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 0 or math.prod(shape) == 1:
            return PartitionSpec()
        for pat, spec in compiled:
            if pat.search(name) is not None:
                if len(spec) > len(shape):
                    return PartitionSpec()
                return spec
        raise ValueError(f"no partition rule matched leaf {name!r} {shape}")

    return named_tree_map(get_spec, tree)


def place(x: Any, mesh, placements):
    """``x`` as a DTensor on ``placement_mesh(mesh)`` with ``placements``
    (from ``spec_placements``): a DTensor is redistributed
    (returned as it is when already placed so), a plain tensor holding the
    full value on every rank is distributed without communication."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    placements = tuple(placements)
    mesh = placement_mesh(mesh)
    if isinstance(x, DTensor):
        if tuple(x.placements) == placements and x.device_mesh == mesh:
            return x
        return x.redistribute(mesh, placements)
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def constrain(x: Any, mesh, rules: ShardingRules, logical_axes: Sequence[Optional[str]]):
    """Pin ``x`` to the placements its logical axes get from the rule table
    (JAX: ``with_sharding_constraint``). A ``None`` mesh or rules is a
    no-op — single-device reference paths stay constraint-free."""
    if mesh is None or rules is None:
        return x
    return place(x, mesh, logical_to_sharding(mesh, rules, logical_axes))


def constrain_tree(tree: Any, mesh, rules) -> Any:
    """Pin a whole tree (params/grads/optimizer state) to its matched specs.

    ``rules``: ordered ``(regex, PartitionSpec)`` pairs (see
    ``match_partition_rules``). No-op when mesh or rules is None."""
    if mesh is None or rules is None:
        return tree
    specs = tree_leaves(match_partition_rules(rules, tree))
    it = iter(specs)
    return named_tree_map(lambda name, x: place(x, mesh, spec_placements(mesh, next(it))), tree)


def shard_params_fsdp(mesh, params, min_size: int = 2**14):
    """Heuristic parameter sharding when no logical annotations exist:
    shard each tensor's largest divisible dim over the fsdp axis
    (cf. reference FSDP wrap policy ``train/torch/train_loop_utils.py:33-35``).
    Returns a tree of DTensor placements."""
    fsdp_size = mesh_axis_sizes(mesh).get(FSDP, 1)

    def spec_for(x) -> PartitionSpec:
        if fsdp_size <= 1 or math.prod(x.shape) < min_size:
            return PartitionSpec()
        dims = list(x.shape)
        order = sorted(range(len(dims)), key=lambda i: -dims[i])
        for i in order:
            if dims[i] % fsdp_size == 0:
                parts: List[MeshAxes] = [None] * len(dims)
                parts[i] = FSDP
                return PartitionSpec(*parts)
        return PartitionSpec()

    return named_tree_map(lambda name, x: spec_placements(mesh, spec_for(x)), params)
