"""The port's copies of pure-Python modules of ``ray_tpu`` stay copies.

The port may not import ``ray_tpu``, so it carries its own copies of the
modules its engine needs. Each copy is held here to its original, top-level
statement by statement: both files are parsed, docstrings dropped and
``ray_tpu`` module names mapped to ``ray_tpu_torch``, and every statement
the two share must be identical. The statements that differ, and those
that exist on one side only, are listed below with the reason. A change to
an original that is not carried into its copy (or the reverse) fails here.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

#: module -> (statements allowed to differ, only in the original, only in
#: the copy). A statement is named by its def/class/assigned name, or by
#: its normalised source for imports and other statements.
COPIES = {
    "inference/kv_cache": ((), (), ()),
    "inference/scheduler": ((), (), ()),
    "core/deadline": ((), (), ()),
    "observability/metrics": ((), (), ()),
    # only the four metrics the engine registers (None: the copy keeps a
    # part of the original, and everything it keeps is identical)
    "observability/rpc_metrics": (
        (), None, ("from ray_tpu_torch.observability.metrics import Counter, Gauge",)),
    # the draft model runs on the port's runner
    "inference/speculative": (
        ("DraftModelProposer",),
        ("from typing import Dict, List, Optional, Sequence",),
        ("from typing import Dict, List, Sequence", "import numpy as np",
         "from ray_tpu_torch.inference.model_runner import PagedModelRunner"),
    ),
    "observability/slo": ((), (), ()),
    # the span ids come from a local random_bytes (os.urandom) in place of
    # ray_tpu.core.ids
    "observability/tracing": (("_new_span_id", "_new_trace_id"), (), ("random_bytes",)),
    # only the in-process part: the cluster export through the controller
    # waits for the runtime
    "observability/timeline": (
        ("record_event", "dump_timeline"),
        ("import uuid", "_total_recorded", "_exporter_uid", "_EVENTS_KV_PREFIX",
         "_export_count", "_export_chunk", "_collect_remote_events",
         "export_events_to_kv", "start_export_thread"),
        (),
    ),
    # only the replica fault plan and what it reads (None: the killers and
    # the RPC, pull, KV-tier and controller plans wait for the runtime)
    "util/chaos": ((), None, ()),
    # only the stream item types (None: the runtime's streaming generators)
    "core/streaming": ((), None, ()),
}


class _Normalise(ast.NodeTransformer):
    """Drops docstrings and maps ``ray_tpu`` module names to the port's."""

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
    visit_ClassDef = visit_FunctionDef

    def visit_ImportFrom(self, node):
        node.module = self._port(node.module)
        return node

    def visit_Import(self, node):
        for a in node.names:
            a.name = self._port(a.name)
        return node


def _statements(path):
    norm = _Normalise()
    tree = norm._strip_doc(norm.visit(ast.parse(path.read_text())))
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            key = node.name
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            key = node.targets[0].id
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            key = node.target.id
        else:
            key = ast.unparse(node)
        assert key not in out, f"{path}: two top-level statements named {key!r}"
        out[key] = ast.dump(node)
    return out


@pytest.mark.parametrize("module", sorted(COPIES))
def test_copy_matches_original(module):
    changed, only_ref, only_port = COPIES[module]
    ref = _statements(ROOT / "ray_tpu" / f"{module}.py")
    port = _statements(ROOT / "ray_tpu_torch" / f"{module}.py")
    if only_ref is not None:
        assert sorted(set(ref) - set(port)) == sorted(only_ref)
    assert sorted(set(port) - set(ref)) == sorted(only_port)
    differ = sorted(k for k in set(ref) & set(port) if ref[k] != port[k])
    assert differ == sorted(changed)
