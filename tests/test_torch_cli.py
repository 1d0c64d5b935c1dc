"""The port's operator CLI, ``python -m ray_tpu_torch.scripts``: the case of
``tests/test_cli.py`` (start a head and a node, status, list, stop), and
that the port's CLI and the JAX package's never stop each other's daemons.

Each test runs the CLI with a ``TMPDIR`` of its own, so its PID files
(``_host.TMP_ROOT``) are its own and a ``stop`` in one test (or one xdist
worker) never meets the daemons of another.
"""

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from ray_tpu_torch.util.reaper import find_runtime_pids, pid_alive, reap_all, reap_process

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def env(tmp_path):
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    return dict(os.environ, PYTHONPATH=str(ROOT), TMPDIR=str(tmp), OMP_NUM_THREADS="1")


def _cli(env, *args, timeout=120):
    return subprocess.run([sys.executable, "-m", "ray_tpu_torch.scripts", *args],
                          capture_output=True, text=True, env=env, timeout=timeout)


def _wait_gone(pids, controller, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not any(pid_alive(p) for p in pids) and not find_runtime_pids(controller_addr=controller):
            return True
        time.sleep(0.1)
    return False


def test_cli_start_status_list_stop(env, tmp_path):
    out = _cli(env, "start", "--head", "--num-cpus", "2", "--session-dir", str(tmp_path / "sess"))
    assert out.returncode == 0, out.stderr
    addr = re.search(r"address: (\S+)", out.stdout).group(1)
    head_pid = int(re.search(r"pid (\d+)", out.stdout).group(1))
    node_pid = None
    try:
        out2 = _cli(env, "start", "--address", addr, "--num-cpus", "1")
        assert out2.returncode == 0, out2.stderr
        node_pid = int(re.search(r"pid (\d+)", out2.stdout).group(1))
        time.sleep(2)

        st = _cli(env, "status", "--address", addr)
        assert st.returncode == 0, st.stderr
        assert "cluster: 2 node(s)" in st.stdout
        assert "CPU" in st.stdout

        ls = _cli(env, "list", "nodes", "--address", addr)
        assert ls.returncode == 0, ls.stderr
        assert len(json.loads(ls.stdout)) == 2
    finally:
        stop = _cli(env, "stop")
        assert "stopped" in stop.stdout
        # a node daemon SIGTERMed after its head is gone may not exit (the
        # JAX package's runtime behaves alike): reap what stop left
        controller = ":".join(addr.split(":")[:2])
        daemons = [p for p in (head_pid, node_pid) if p is not None]
        if not _wait_gone(daemons, controller, timeout=10.0):
            reap_all(find_runtime_pids(controller_addr=controller) + daemons)


def test_cli_stops_only_its_own_daemons(env, tmp_path):
    """The port's CLI records its PIDs under the port's ``TMP_ROOT`` (never
    in the JAX CLI's ``/tmp/ray_tpu``, which that CLI's ``stop`` reads), and
    its ``stop`` signals a recorded PID only while its command line runs a
    ``ray_tpu_torch.core.`` entry point: a JAX-package head whose PID sits
    in the port's PID directory survives the port's ``stop``."""
    import ray_tpu.scripts as jax_cli

    out = _cli(env, "start", "--head", "--num-cpus", "1", "--session-dir", str(tmp_path / "sess"))
    assert out.returncode == 0, out.stderr
    head_pid = int(re.search(r"pid (\d+)", out.stdout).group(1))
    addr = re.search(r"address: (\S+)", out.stdout).group(1)
    pid_dir = Path(env["TMPDIR"]) / "ray_tpu_torch"
    jax_head = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu.core.head_main", "--session-dir",
         str(tmp_path / "jax_sess"), "--num-cpus", "1"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=dict(env, TMPDIR=str(tmp_path)), start_new_session=True)
    try:
        assert json.loads(jax_head.stdout.readline())["controller_port"]
        assert (pid_dir / f"head-{head_pid}.pid").read_text() == str(head_pid)
        jax_dir = Path(jax_cli._PID_DIR)
        jax_recorded = {p.read_text().strip() for p in jax_dir.glob("*.pid")} \
            if jax_dir.is_dir() else set()
        assert str(head_pid) not in jax_recorded  # the JAX CLI's stop cannot find it
        # a JAX daemon's PID in the port's PID directory
        (pid_dir / f"head-{jax_head.pid}.pid").write_text(str(jax_head.pid))

        stop = _cli(env, "stop")
        assert "stopped 1 daemon(s)" in stop.stdout, stop.stdout
        controller = ":".join(addr.split(":")[:2])
        assert _wait_gone([head_pid], controller)
        time.sleep(0.5)
        assert jax_head.poll() is None, "the port's stop killed the JAX package's head"
        assert not list(pid_dir.glob("*.pid"))
    finally:
        reap_process(jax_head, group=True)
