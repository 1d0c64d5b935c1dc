"""Run one of the reference's behaviour suites against the port.

``load(globals(), "dag", edits=...)`` reads ``tests/test_dag.py``, applies
the port file's ``edits`` (each an ``(old, new, why)`` triple whose ``old``
must occur exactly once in the reference), renames the package
(``ray_tpu`` as a whole word becomes ``ray_tpu_torch``), rewrites the
asserts as pytest does for a test module, and executes the result in the
port file's namespace. The cases are then the reference's, statement for
statement, apart from the edits the port file lists at its top. ``drop``
removes cases a port test already holds (``"name"`` or ``"Class.name"``),
so that no case runs twice.

Before the suite runs, the namespace gets the port's versions of the
reference's shared fixtures (``tests/conftest.py``): ``ray_start_local``,
``ray_start_regular`` and ``shutdown_only`` start and stop
``ray_tpu_torch``, and two autouse guards fail a test or a module that
leaves a process of the port's runtime behind. conftest's own guard sees
only the reference's entry points, so without these a leak of the port
would pass unseen. A fixture the suite defines itself replaces these.
``one_thread=True`` adds a module-scoped guard that gives every process
the suite's clusters spawn one OpenMP thread (``OMP_NUM_THREADS=1``), so
CPU replicas beside the xdist workers do not each take every core.

``wait_for_node_resource`` is conftest's helper of that name on the
port's runtime (conftest's polls the reference's ``nodes()``): a suite
that imports it from conftest gets this one through an edit.
"""

from __future__ import annotations

import ast
import linecache
import os
import re
import time
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent

#: grace for the asynchronous exit of a cluster's processes after shutdown
LEAK_GRACE_S = 10.0

_RENAME = re.compile(r"\bray_tpu\b")


def load(namespace: dict, suite: str, *, edits=(), drop=(), one_thread=False) -> None:
    from _pytest.assertion.rewrite import rewrite_asserts

    src = (TESTS / f"test_{suite}.py").read_text()
    for old, new, why in edits:
        n = src.count(old)
        if n != 1:
            raise AssertionError(
                f"edit for test_{suite}.py ({why}) matches {n} times, not once: {old!r}"
            )
        src = src.replace(old, new)
    src = _RENAME.sub("ray_tpu_torch", src)
    # the tracebacks show the text that ran, not the reference file's
    filename = str(TESTS / f"test_{suite}.py") + " [ray_tpu_torch]"
    lines = src.splitlines(keepends=True)
    linecache.cache[filename] = (len(src), None, lines, filename)
    tree = ast.parse(src, filename)
    rewrite_asserts(tree, src.encode(), filename)
    code = compile(tree, filename, "exec", dont_inherit=True)
    namespace.update(_shared_fixtures())
    if one_thread:
        namespace["_port_one_thread"] = _one_thread_fixture()
    exec(code, namespace)
    for name in drop:
        owner, _, attr = name.rpartition(".")
        if owner:
            delattr(namespace[owner], attr)
        else:
            del namespace[attr]


def wait_for_node_resource(name, *, exclude=(), timeout=20.0):
    """Block until an alive node of the port's cluster carries resource
    ``name`` (and is not in ``exclude``); returns its node id."""
    import ray_tpu_torch

    deadline = time.time() + timeout
    while time.time() < deadline:
        for n in ray_tpu_torch.nodes():
            if (
                n.get("Alive")
                and name in (n.get("Resources") or {})
                and n.get("node_id") not in exclude
            ):
                return n["node_id"]
        time.sleep(0.05)
    raise TimeoutError(f"no alive node with resource {name!r} within {timeout}s")


def _one_thread_fixture():
    @pytest.fixture(scope="module", autouse=True)
    def _port_one_thread():
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("OMP_NUM_THREADS", "1")
            yield

    return _port_one_thread


def _port_pids():
    from ray_tpu_torch.util.reaper import find_runtime_pids

    return set(find_runtime_pids(spawner_pid=os.getpid()))


def _leaked(before) -> list:
    from ray_tpu_torch.util.reaper import pid_alive

    deadline = time.monotonic() + LEAK_GRACE_S
    live = [p for p in _port_pids() - before if pid_alive(p)]
    while live and time.monotonic() < deadline:
        time.sleep(0.2)
        live = [p for p in live if pid_alive(p)]
    return live


def _fail_leak(leaked, what: str) -> None:
    from ray_tpu_torch.util.reaper import reap_all

    details = []
    for pid in leaked:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                details.append(f"pid {pid}: " + f.read().replace(b"\x00", b" ").decode(errors="replace"))
        except OSError:
            details.append(f"pid {pid}: ?")
    reap_all(leaked)  # spare the rest of the suite
    pytest.fail(f"{what} leaked the port's runtime processes (reaped):\n  " + "\n  ".join(details), pytrace=False)


def _shared_fixtures() -> dict:
    import ray_tpu_torch

    @pytest.fixture
    def ray_start_local():
        ray_tpu_torch.init(local_mode=True)
        yield
        ray_tpu_torch.shutdown()

    @pytest.fixture
    def ray_start_regular():
        ray_tpu_torch.init(num_cpus=4)
        yield
        ray_tpu_torch.shutdown()

    @pytest.fixture
    def shutdown_only():
        yield
        ray_tpu_torch.shutdown()

    @pytest.fixture(autouse=True)
    def _port_leak_guard():
        """conftest's ``_runtime_leak_guard`` for the port: a test that ends
        with no cluster up leaves none of the port's processes behind."""
        before = _port_pids()
        yield
        if ray_tpu_torch.is_initialized():
            return  # a module-scoped cluster: checked when it ends
        leaked = _leaked(before)
        if leaked:
            _fail_leak(leaked, "test")

    @pytest.fixture(scope="module", autouse=True)
    def _port_module_leak_guard():
        """After the module's own fixtures have ended (set up first, so torn
        down last), none of the processes its clusters started survive."""
        before = _port_pids()
        yield
        leaked = _leaked(before)
        if leaked:
            _fail_leak(leaked, "module")

    return {
        "ray_start_local": ray_start_local,
        "ray_start_regular": ray_start_regular,
        "shutdown_only": shutdown_only,
        "_port_leak_guard": _port_leak_guard,
        "_port_module_leak_guard": _port_module_leak_guard,
    }
