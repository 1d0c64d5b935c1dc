"""The port's copies of pure-Python modules of ``ray_tpu`` stay copies.

The port may not import ``ray_tpu``, so it carries its own copies of the
modules its engine and runtime need. Each copy is held here to its
original, statement by statement (top-level statements, and each member of
a class): both files are parsed, docstrings dropped and ``ray_tpu`` module
names mapped to ``ray_tpu_torch`` (in imports, names, and module paths
inside strings such as ``-m ray_tpu.core.worker_main``), and every
statement the two share must be identical. The statements that differ, and those
that exist on one side only, are listed below with the reason. A change to
an original that is not carried into its copy (or the reverse) fails here.
"""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

#: module -> (statements allowed to differ, only in the original, only in
#: the copy). A statement is named by its def/class/assigned name (a class
#: member as ``Class.member``), or by its normalised source for imports and
#: other statements.
_SAME = ((), (), ())

# The runtime's host files: the reference writes under fixed /tmp/ray_tpu
# paths and names its shared-memory segments rt-*, and counts and sweeps
# what it finds there as its own (the pool debt in object_store, the orphan
# sweep in node_daemon). The port roots its files at the process's TMPDIR
# and prefixes its segments and semaphores with its own SHM_PREFIX (both
# from ray_tpu_torch/_host.py), so the two runtimes on one host never count
# or unlink each other's. The statements that name those paths differ, and
# each of these modules imports the constants.
def _host(*names):
    return f"from ray_tpu_torch._host import {', '.join(names)}"


COPIES = {
    "inference/kv_cache": _SAME,
    "inference/scheduler": _SAME,
    "core/deadline": _SAME,
    "observability/metrics": _SAME,
    "observability/slo": _SAME,
    # the draft model runs on the port's runner
    "inference/speculative": (
        ("DraftModelProposer.__init__", "DraftModelProposer.propose"),
        ("from typing import Dict, List, Optional, Sequence",),
        ("from typing import Dict, List, Sequence", "import numpy as np",
         "from ray_tpu_torch.inference.model_runner import PagedModelRunner"),
    ),
    # --- the runtime: whole copies, module names rewritten only ---
    "__init__": _SAME,
    "_version": _SAME,
    # host paths (_host above)
    "cluster_utils": (("Cluster.__init__",), (), (_host("TMP_ROOT"),)),
    "accelerators/base": _SAME,
    # the registry holds the GPU manager where the reference holds the TPU
    # one (accelerators/tpu.py is not copied: it probes GCE metadata and
    # TPU pod topology, which mean nothing on a GPU host)
    "accelerators/__init__": (
        ("_MANAGERS", "__all__"),
        ("from ray_tpu_torch.accelerators.tpu import TPUAcceleratorManager, "
         "pod_type_chips_per_host, pod_type_num_chips, pod_type_num_hosts, "
         "set_metadata_fetcher, slice_head_resource_name",),
        ("from ray_tpu_torch.accelerators.gpu import GPUAcceleratorManager",),
    ),
    "core/__init__": _SAME,
    # an actor call takes its turn in the caller's order only once its
    # arguments are serialized (ROADMAP "Inconsistencies")
    "core/actor": (("ActorHandle._submit_method",), (), ()),
    "core/api": (("Worker.submit_from_template",), (), ()),
    # host paths (_host above)
    "core/cluster_backend": (
        ("ClusterBackend.start_cluster", "spawn_node"), (), (_host("TMP_ROOT"),)),
    "core/config": _SAME,
    "core/controller": _SAME,
    "core/controller_main": _SAME,
    # a pooled worker promoted to a GPU undoes the daemon's
    # CUDA_VISIBLE_DEVICES="" pin (not JAX_PLATFORMS=cpu), and refuses
    # (returns False) when CUDA already initialised in the process
    # ... and the streams lock is re-entrant: the reference's plain Lock
    # deadlocks when a collection, run while a thread holds it, finalises
    # a dropped generator whose __del__ abandons its stream on that thread
    # (test_torch_runtime.py::test_stream_abandoned_by_gc_under_the_streams_lock)
    # ... and shutdown lets lingering lease pumps return their leases before
    # it closes the clients: the reference cancels them, and a lease whose
    # return is cut off stays held, with its GPU, after the driver has gone
    # (test_torch_job.py::test_job_reaches_the_gpu_only_through_a_lease)
    "core/core_worker": (("CoreWorker.__init__", "CoreWorker.shutdown",
                          "CoreWorker.w_set_accelerator_env"), (), ()),
    "core/exceptions": _SAME,
    "core/execution": _SAME,
    "core/function_manager": _SAME,
    "core/head_main": _SAME,
    "core/ids": _SAME,
    "core/local_backend": _SAME,
    # the device pool hands out GPU ids where the reference hands out TPU
    # chips: detection keys on "GPU" (__init__), GPU-less workers get
    # CUDA_VISIBLE_DEVICES="" and GPU workers GPUAcceleratorManager's
    # isolation_env (_spawn_worker), promotion (_try_lease, which also
    # retires a worker that refuses it), retirement of a GPU-bound pooled
    # worker (_release_lease), dedicated GPU actors (d_start_actor) and
    # their release (_release_actor_resources). The maintenance-event probe
    # (start, _preemption_probe_loop) read GCE metadata through
    # accelerators/tpu.py, which the port does not copy; SIGTERM drain stays.
    # The default session dir (__init__) and the pool and channel sweeps
    # (_sweep_recycle_pool, _sweep_orphan_pools) are host paths (_host above).
    "core/node_daemon": (
        ("NodeDaemon.__init__", "NodeDaemon._release_actor_resources",
         "NodeDaemon._release_lease", "NodeDaemon._spawn_worker",
         "NodeDaemon._sweep_orphan_pools", "NodeDaemon._sweep_recycle_pool",
         "NodeDaemon._try_lease", "NodeDaemon.d_start_actor", "NodeDaemon.start"),
        ("Lease.tpu_chips", "WorkerProc.tpu_chips", "NodeDaemon._allocate_tpu_chips",
         "NodeDaemon._free_tpu_chips", "NodeDaemon._preemption_probe_loop"),
        ("Lease.gpus", "WorkerProc.gpus", "NodeDaemon._allocate_gpus",
         "NodeDaemon._free_gpus", _host("SHM_PREFIX", "TMP_ROOT")),
    ),
    "core/node_main": _SAME,
    # segment and pool names, the pool debt's glob and the spill dir are
    # host paths (_host above)
    "core/object_store": (
        ("ShmStore.__init__", "ShmStore._pool_receive_segment_locked",
         "ShmStore._recycle_pool_debt", "StoreClient.recycle", "segment_name"),
        (), (_host("SHM_PREFIX", "TMP_ROOT"),)),
    "core/ownership": _SAME,
    "core/pull_manager": _SAME,
    "core/refs": _SAME,
    "core/remote_function": _SAME,
    # the GPU resource name beside TPU
    "core/resources": ((), (), ("GPU",)),
    "core/rpc": _SAME,
    "core/runtime_context": _SAME,
    "core/scheduling_policies": _SAME,
    # a torch.Tensor at any depth goes as its host bytes and comes back a
    # CPU tensor, with its requires_grad and as an nn.Parameter where it was
    # one (serialize's reducer), where the reference turns only a top-level
    # jax.Array into numpy
    "core/serialization": (
        ("serialize",), (), ("_rebuild_tensor", "_reduce_tensor", "import sys")),
    "core/streaming": _SAME,
    # a compiled graph's loop and __ray_ready__ take their caller's turn
    # (the reference's skip it, and the actor then never runs another call
    # from a handle that called it before)
    "core/task_executor": (("TaskExecutor._handle_actor_task",), (), ()),
    # num_gpus adds to the GPU request as num_tpus adds to TPU
    "core/task_spec": (
        ("TaskOptions.resource_request",), (), ("TaskOptions.num_gpus",)),
    "core/transport_retry": _SAME,
    "core/wal": _SAME,
    "core/worker_main": _SAME,
    "dag/__init__": _SAME,
    "dag/channel": _SAME,
    "dag/collective": _SAME,
    # channel names (_host above)
    "dag/compiled": (("CompiledDAG._compile",), (), (_host("SHM_PREFIX"),)),
    "dag/node": _SAME,
    "observability/__init__": _SAME,
    # the watchdog's dump file (_host above)
    "observability/event_stats": (
        ("LoopMonitor._dump_path", "LoopMonitor._write_dump_file"), (),
        (_host("TMP_ROOT"),)),
    "observability/rpc_metrics": _SAME,
    "observability/timeline": _SAME,
    "observability/tracing": _SAME,
    # cpu_mesh_devices (XLA's virtual CPU devices) is not ported: a gloo
    # group of processes takes their place
    "parallel/__init__": (
        ("__all__",),
        ("from ray_tpu_torch.parallel.mesh import MeshSpec, DATA, FSDP, TENSOR, "
         "SEQUENCE, EXPERT, STAGE, cpu_mesh_devices, make_mesh",),
        ("from ray_tpu_torch.parallel.mesh import MeshSpec, DATA, FSDP, TENSOR, "
         "SEQUENCE, EXPERT, STAGE, make_mesh",),
    ),
    "parallel/collectives": _SAME,
    "rl/__init__": _SAME,
    "rl/replay": _SAME,
    "rl/test_envs": _SAME,
    "runtime_env/__init__": _SAME,
    # the package cache (_host above)
    "runtime_env/packaging": (("_CACHE_ROOT",), (), (_host("TMP_ROOT"),)),
    "util/__init__": _SAME,
    "util/actor_pool": _SAME,
    "util/chaos": _SAME,
    "util/crc": _SAME,
    # TPU pod-slice gangs need the pod math of accelerators/tpu.py
    "util/placement_group": ((), ("tpu_slice_placement_group",), ()),
    # RUNTIME_ENTRYPOINTS name the port's entry points (a module-path
    # rewrite, which the normaliser maps)
    "util/reaper": _SAME,
    "util/scheduling_strategies": _SAME,
    "util/state": _SAME,
    # --- the serve layer and the KV data plane its router imports ---
    "inference/kv_transfer": _SAME,
    "serve/__init__": _SAME,
    "serve/batching": _SAME,
    "serve/config": _SAME,
    # a status wait first waits for a control-loop pass begun after the
    # call (the loop counts its passes), so a replica that died just
    # before the call is counted dead, not routed (ROADMAP "Inconsistencies")
    "serve/controller": (
        ("_ServeController.__init__", "_ServeController._control_loop",
         "_ServeController.wait_status"),
        (),
        (),
    ),
    # the door's debug_stats carries its per-request first-byte times (the
    # samples of its windowed p99), and a shed record
    # of the harness the door's Retry-After: what a driver outside the
    # door's process reads to split a client's TTFT and to check each shed
    "serve/ingress": (("HttpIngress.debug_stats",), (), ()),
    "serve/loadgen": (("run_trace",), (), ()),
    "serve/multiplex": _SAME,
    "serve/proxy": _SAME,
    "serve/replica": _SAME,
    "serve/router": _SAME,
    # --- data/ and train/: the trainer's ingest and gang (iterator.py and
    # train/backend.py are rewrites) ---
    "data/__init__": _SAME,
    "data/block": _SAME,
    "data/dataset": _SAME,
    "data/datasink": _SAME,
    "data/executor": _SAME,
    "data/grouped": _SAME,
    "data/read_api": _SAME,
    "data/shuffle": _SAME,
    # renamed (RENAMED below): the JaxBackend/JaxBackendConfig exports, and
    # their names in __all__
    "train/__init__": (("__all__",), (), ()),
    "train/checkpoint": _SAME,
    # use_tpu and topology (TPU pod slices, whose host and chip counts came
    # from accelerators/tpu.py) become use_gpu: one GPU a worker, the
    # default, and a topology raises
    "train/config": (
        ("ScalingConfig.bundles", "ScalingConfig.resolved_num_workers",
         "ScalingConfig.worker_resources"),
        ("ScalingConfig._chips_per_host", "ScalingConfig.use_tpu"),
        ("ScalingConfig.use_gpu", "_topology_error"),
    ),
    "train/session": _SAME,
    # renamed (RENAMED below); a run's default name names the trainer
    "train/trainer": (("TorchTrainer._run_dir",), (), ()),
    # the rendezvous address is the loopback the runtime serves on: the
    # reference probes a public address (a UDP connect to 8.8.8.8) to learn
    # its routed interface, and the port opens no socket towards another host
    "train/worker_group": (("_node_ip_address",), (), ()),
    # --- the libraries above the runtime: Tune, Jobs, the autoscaler, the
    # CLI and two util shims (a TorchTrainer is a trainable as a JaxTrainer
    # is: the Tuner reads its _train_config and run_config) ---
    "tune/__init__": _SAME,
    "tune/loggers": _SAME,
    "tune/schedulers": _SAME,
    "tune/search": _SAME,
    "tune/trial": _SAME,
    "tune/tuner": _SAME,
    "job/__init__": _SAME,
    "job/manager": _SAME,
    "job/sdk": _SAME,
    "job/server": _SAME,
    # a job's log file is a host path (_host above): the reference's sits
    # in /tmp/ray_tpu_jobs
    "job/supervisor": (("_JobSupervisor.__init__",), (), (_host("TMP_ROOT"),)),
    "autoscaler/__init__": _SAME,
    "autoscaler/autoscaler": _SAME,
    "autoscaler/config": _SAME,
    # spawn_node and the reaper are the port's (module names rewritten)
    "autoscaler/provider": _SAME,
    "util/multiprocessing": _SAME,
    "util/queue": _SAME,
    # The CLI keeps its PID files and default session dir under the port's
    # TMP_ROOT (_PID_DIR, cmd_start), not /tmp/ray_tpu, so neither CLI's
    # `stop` reads the other's PIDs; and `stop` signals a recorded PID only
    # while its command line runs a `ray_tpu_torch.core.` entry point
    # (cmd_stop): the reference's b"ray_tpu" is a substring of every
    # command line of the JAX package's daemons too. cmd_start's messages
    # and main's prog name the port's command (there is no console entry
    # point: `python -m ray_tpu_torch.scripts`).
    "scripts": (("_PID_DIR", "cmd_start", "cmd_stop", "main"), (), (_host("TMP_ROOT"),)),
}

#: module -> (names the port gives the reference's, statements that carry a
#: renamed name). The reference is read with the names mapped, so every
#: other statement is still held as above; the renamed ones are listed.
#: JaxTrainer and JaxBackendConfig become Ray's torch names.
_TRAIN_NAMES = {"JaxTrainer": "TorchTrainer", "JaxBackendConfig": "TorchBackendConfig",
                "JaxBackend": "TorchBackend"}
RENAMED = {
    "train/__init__": (_TRAIN_NAMES, (
        "from ray_tpu_torch.train.backend import Backend, BackendConfig, TorchBackend, "
        "TorchBackendConfig",
        "from ray_tpu_torch.train.trainer import TorchTrainer, Result, TrainingFailedError")),
    "train/trainer": (_TRAIN_NAMES, (
        "TorchTrainer", "TorchTrainer.__init__",
        "from ray_tpu_torch.train.backend import Backend, BackendConfig, TorchBackendConfig")),
}


_MODULE_PATH = re.compile(r"\bray_tpu(?=\.)")


class _Normalise(ast.NodeTransformer):
    """Drops docstrings and maps ``ray_tpu`` module names to the port's, and
    the names in ``renames`` (old -> new) to the port's names."""

    def __init__(self, renames=None):
        self.renames = renames or {}

    @staticmethod
    def _port(name):
        if name == "ray_tpu" or (name or "").startswith("ray_tpu."):
            return "ray_tpu_torch" + name[len("ray_tpu"):]
        return name

    def _strip_doc(self, node):
        body = node.body
        if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
        return node

    def visit_FunctionDef(self, node):
        return self._strip_doc(self.generic_visit(node))

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        node.name = self.renames.get(node.name, node.name)
        return self.visit_FunctionDef(node)

    def visit_Name(self, node):
        if node.id == "ray_tpu":
            node.id = "ray_tpu_torch"
        node.id = self.renames.get(node.id, node.id)
        return node

    def visit_alias(self, node):
        node.name = self.renames.get(node.name, node.name)
        return node

    def visit_Constant(self, node):
        # module paths in strings (``-m ray_tpu.core.worker_main``, logger
        # names, ``f"ray_tpu.{name}"``); a name already ported is left alone
        if isinstance(node.value, str):
            node.value = _MODULE_PATH.sub("ray_tpu_torch", node.value)
        return node

    def visit_ImportFrom(self, node):
        node.module = self._port(node.module)
        return self.generic_visit(node)

    def visit_Import(self, node):
        for a in node.names:
            a.name = self._port(a.name)
        return node


def _key(node):
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return node.name
    if isinstance(node, ast.Assign) and len(node.targets) == 1 \
            and isinstance(node.targets[0], ast.Name):
        return node.targets[0].id
    if isinstance(node, (ast.AnnAssign, ast.AugAssign)) and isinstance(node.target, ast.Name):
        return node.target.id
    return ast.unparse(node)


def _statements(path, renames=None):
    """Top-level statements by key; a class counts as its header (bases,
    decorators, keywords) under its name plus each member as
    ``Class.member``, so a difference is named down to the method."""
    norm = _Normalise(renames)
    tree = norm._strip_doc(norm.visit(ast.parse(path.read_text())))
    out = {}

    def put(key, node):
        assert key not in out, f"{path}: two statements named {key!r}"
        out[key] = ast.dump(node)

    for node in tree.body:
        key = _key(node)
        if isinstance(node, ast.ClassDef):
            for member in node.body:
                put(f"{key}.{_key(member)}", member)
            node.body = []
        put(key, node)
    return out


@pytest.mark.parametrize("module", sorted(COPIES))
def test_copy_matches_original(module):
    changed, only_ref, only_port = COPIES[module]
    renames, renamed = RENAMED.get(module, ({}, ()))
    ref = _statements(ROOT / "ray_tpu" / f"{module}.py", renames)
    # the original's statements keyed as the port names them: a renamed
    # class's members are then held member by member
    as_is = {}
    for key, dump in _statements(ROOT / "ray_tpu" / f"{module}.py").items():
        head, dot, member = key.partition(".")
        as_is[renames.get(head, head) + dot + member] = dump
    assert sorted(k for k in ref if as_is.get(k) != ref[k]) == sorted(renamed)
    port = _statements(ROOT / "ray_tpu_torch" / f"{module}.py")
    assert sorted(set(ref) - set(port)) == sorted(only_ref)
    assert sorted(set(port) - set(ref)) == sorted(only_port)
    differ = sorted(k for k in set(ref) & set(port) if ref[k] != port[k])
    assert differ == sorted(changed)


#: the port's own rewrites of reference modules, held by their own tests
#: (against the JAX package on the same inputs), not statement by
#: statement: whole directories, and single modules
_PORTED = ("inference/", "models/", "ops/")
_PORTED_MODULES = ("parallel/mesh", "parallel/sharding", "parallel/pipeline", "data/iterator",
                   "train/backend", "rl/models", "rl/env_runner", "rl/utils",
                   "rl/ppo", "rl/dqn", "rl/impala", "rl/learner_group")


def test_every_copy_is_held():
    """Every module of the port with a namesake in ``ray_tpu`` is either a
    copy listed above or one of the port's rewrites."""
    port = ROOT / "ray_tpu_torch"
    twins = sorted(
        str(p.relative_to(port).with_suffix(""))
        for p in port.rglob("*.py")
        if (ROOT / "ray_tpu" / p.relative_to(port)).exists()
    )
    unheld = [m for m in twins
              if m not in COPIES and not m.startswith(_PORTED) and m not in _PORTED_MODULES]
    assert unheld == []
