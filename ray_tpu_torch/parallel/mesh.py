"""Device meshes with canonical parallelism axes (port of ``ray_tpu.parallel.mesh``).

The framework's standard mesh axes (every library component speaks these
names):

  * ``data``  — pure data parallelism (gradient all-reduce)
  * ``fsdp``  — data parallelism with parameter sharding (ZeRO-3
                equivalent; DTensor shards params over this axis)
  * ``tensor``— tensor/model parallelism (matmul-sharded, all-reduce on
                activations)
  * ``seq``   — sequence/context parallelism (ring attention, Ulysses)
  * ``expert``— MoE expert parallelism (all-to-all dispatch)
  * ``stage`` — pipeline stages

The JAX package builds a ``jax.sharding.Mesh`` and lets XLA insert the
collectives; the port builds a ``torch.distributed`` ``DeviceMesh`` over the
process group and DTensor inserts them. One process drives one device, so
the mesh spans the group's ranks. Axis order puts the fastest-varying
(most-communicating) axes last, and DTensor shards one tensor dim over
several mesh dims in mesh-dim order, which is the JAX spec's major-to-minor
order for the same axes.
"""

from __future__ import annotations

import math
import socket
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

DATA = "data"
FSDP = "fsdp"
TENSOR = "tensor"
SEQUENCE = "seq"
EXPERT = "expert"
STAGE = "stage"

# canonical order: slower-varying first; tensor last → nearest neighbors
AXIS_ORDER = (STAGE, DATA, FSDP, EXPERT, SEQUENCE, TENSOR)


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape: axis name -> size (missing axes = 1).

    ``MeshSpec(fsdp=8, tensor=4)`` on 32 devices; ``auto`` axes (-1) are
    inferred from the device count.
    """

    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    expert: int = 1
    stage: int = 1

    def axis_sizes(self) -> Dict[str, int]:
        return {
            STAGE: self.stage,
            DATA: self.data,
            FSDP: self.fsdp,
            EXPERT: self.expert,
            SEQUENCE: self.seq,
            TENSOR: self.tensor,
        }

    @property
    def num_devices(self) -> int:
        n = 1
        for v in self.axis_sizes().values():
            n *= abs(v)
        return n

    def resolve(self, device_count: int) -> "MeshSpec":
        """Infer a single -1 axis from the device count."""
        sizes = self.axis_sizes()
        unknown = [k for k, v in sizes.items() if v == -1]
        if len(unknown) > 1:
            raise ValueError("at most one mesh axis may be -1")
        known = math.prod(v for v in sizes.values() if v != -1)
        if unknown:
            if device_count % known:
                raise ValueError(
                    f"cannot infer {unknown[0]}: {device_count} devices not "
                    f"divisible by {known}"
                )
            sizes[unknown[0]] = device_count // known
        total = math.prod(sizes.values())
        if total != device_count:
            raise ValueError(
                f"mesh {sizes} needs {total} devices, have {device_count}"
            )
        return MeshSpec(
            data=sizes[DATA],
            fsdp=sizes[FSDP],
            tensor=sizes[TENSOR],
            seq=sizes[SEQUENCE],
            expert=sizes[EXPERT],
            stage=sizes[STAGE],
        )

    def active_axes(self) -> Tuple[str, ...]:
        return tuple(k for k in AXIS_ORDER if self.axis_sizes()[k] > 1)


def _free_local_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_device_type(devices=None) -> str:
    """The device type a mesh lives on: ``devices`` when the caller names
    one (``"cpu"``, ``"cuda"``), else that of the running process group
    (``gloo`` → ``"cpu"``, ``nccl`` → ``"cuda"``), else ``"cuda"``."""
    import torch.distributed as dist

    if devices is not None:
        return str(devices).split(":")[0]
    if dist.is_initialized() and dist.get_backend() == "gloo":
        return "cpu"
    return "cuda"


def _ensure_process_group(device_type: str) -> None:
    """JAX's ``make_mesh`` needs no rendezvous; a DeviceMesh needs a process
    group. Without one, start a world-1 group on a free local port (gloo on
    the CPU, nccl on the card)."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass devices='cpu' for a CPU mesh")
    backend = "gloo" if device_type == "cpu" else "nccl"
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{_free_local_port()}", world_size=1, rank=0
    )


def make_mesh(spec: MeshSpec, devices: Optional[str] = None):
    """Build a ``DeviceMesh`` with ALL canonical axes in ``AXIS_ORDER``
    (size-1 axes included, so sharding rules can always name them), over
    every rank of the process group. ``devices`` names the device type
    (``"cpu"`` or ``"cuda"``; see ``mesh_device_type``); ``-1`` axes
    resolve against the group's world size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device_type = mesh_device_type(devices)
    _ensure_process_group(device_type)
    spec = spec.resolve(dist.get_world_size())
    sizes = spec.axis_sizes()
    shape = tuple(sizes[a] for a in AXIS_ORDER)
    return init_device_mesh(device_type, shape, mesh_dim_names=AXIS_ORDER)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a mesh made by ``make_mesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


_PLACEMENT_ATTR = "_ray_tpu_torch_placement_mesh"


def placement_mesh(mesh):
    """The mesh DTensors are placed on: ``mesh`` cut to its axes of size
    > 1, in ``AXIS_ORDER`` (one size-1 axis when every axis is 1). A
    size-1 axis shards nothing, and DTensor's sharding propagation costs
    grow with the number of mesh dims: over all six, the first op of the
    tiny Llama's step had not finished after 25 s on the CPU. A mesh with
    no axis names is returned as it is.

    Kept on the mesh object: every ``constrain`` asks for it, and cutting
    a DeviceMesh builds a new one each time (0.58 ms on the CPU, 60% of
    the tiny sharded step's host time before it was kept). Not keyed on
    the mesh's value: DeviceMesh equality ignores the process group, so a
    mesh rebuilt equal over a new group would get a cut of the old one."""
    cut = getattr(mesh, _PLACEMENT_ATTR, None)
    if cut is None:
        cut = _cut_to_sharding_axes(mesh)
        setattr(mesh, _PLACEMENT_ATTR, cut)
    return cut


def _cut_to_sharding_axes(mesh):
    names = mesh.mesh_dim_names
    if names is None:
        return mesh
    active = tuple(n for n, size in zip(names, mesh.shape) if size > 1) or (names[-1],)
    return mesh if active == tuple(names) else mesh[active]


def slice_topology_mesh(num_slices: int, per_slice_spec: MeshSpec, devices=None):
    """Multi-slice mesh: ``data`` axis spans slices, everything else stays
    inside a slice (one slice per group of ``world_size / num_slices``
    consecutive ranks; the jax multi-slice recipe)."""
    import torch.distributed as dist

    _ensure_process_group(mesh_device_type(devices))
    per = dist.get_world_size() // num_slices
    spec = per_slice_spec.resolve(per)
    merged = MeshSpec(
        data=spec.data * num_slices,
        fsdp=spec.fsdp,
        tensor=spec.tensor,
        seq=spec.seq,
        expert=spec.expert,
        stage=spec.stage,
    )
    return make_mesh(merged, devices)


def shard_map_compat(f, *, mesh, in_specs, out_specs):
    """``shard_map`` for the port: returns ``fn(*args)``, which places each
    argument by its ``in_specs`` entry (a ``PartitionSpec`` over ``mesh``'s
    axis names), calls ``f`` on the local shards as
    ``f(*local_args, groups={axis name: process group})`` and places each of
    ``f``'s local outputs by its ``out_specs`` entry (one spec for one
    output, a tuple of specs for several).

    An argument is a DTensor (redistributed to its spec) or a plain tensor
    holding the full value on every rank (read as replicated). When every
    argument is plain the outputs come back as plain full tensors, else as
    DTensors. ``redistribute`` and ``from_local``/``to_local`` are
    differentiable, so gradients flow through; the collectives ``f`` issues
    on ``groups`` are its own (the JAX function binds axis names instead)."""
    from torch.distributed.tensor import DTensor, Replicate

    from ray_tpu_torch.parallel.sharding import PartitionSpec, spec_placements

    def fn(*args):
        pmesh = placement_mesh(mesh)
        plain = not any(isinstance(a, DTensor) for a in args)
        local = []
        for a, spec in zip(args, in_specs, strict=True):
            if not isinstance(a, DTensor):
                a = DTensor.from_local(a, pmesh, [Replicate()] * pmesh.ndim, run_check=False)
            local.append(a.redistribute(pmesh, spec_placements(mesh, spec)).to_local())
        groups = {name: mesh.get_group(name) for name in mesh.mesh_dim_names}
        outs = f(*local, groups=groups)
        single = isinstance(out_specs, PartitionSpec)
        placed = []
        for o, spec in zip((outs,) if single else outs, (out_specs,) if single else out_specs,
                           strict=True):
            o = DTensor.from_local(o, pmesh, spec_placements(mesh, spec), run_check=False)
            placed.append(o.full_tensor() if plain else o)
        return placed[0] if single else tuple(placed)

    return fn
