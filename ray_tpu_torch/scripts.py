"""Operator CLI: ``python -m ray_tpu_torch.scripts <command>``.

Reference: ``python/ray/scripts/scripts.py`` (``ray start/stop/status/
list/timeline/memory``). Commands:

  start --head [--num-cpus N] [--resources JSON] [--port P]
      Start a head (controller + daemon) in the background; prints the
      address workers and drivers connect to.
  start --address HOST:PORT [--num-cpus N]
      Start a worker-node daemon joined to an existing head.
  stop
      Stop every ray_tpu_torch daemon this CLI started under this TMPDIR
      (PID files under ``_host.TMP_ROOT``; a PID is signalled only while
      its command line still runs one of the port's ``ray_tpu_torch.core``
      entry points, so the JAX package's daemons are never touched).
  status --address HOST:PORT
      Cluster resources + node table.
  list (nodes|actors|tasks|objects|pgs) --address HOST:PORT
      State API listings (``ray list ...``).
"""

from __future__ import annotations

import argparse
import json
import os
import select
import signal
import subprocess
import sys
import time

from ray_tpu_torch._host import TMP_ROOT

_PID_DIR = TMP_ROOT


def _pid_file(kind: str, pid: int) -> str:
    return os.path.join(_PID_DIR, f"{kind}-{pid}.pid")


def _record_pid(kind: str, pid: int) -> None:
    os.makedirs(_PID_DIR, exist_ok=True)
    with open(_pid_file(kind, pid), "w") as f:
        f.write(str(pid))


def _read_ready_line(proc, what: str, log_path: str, timeout: float = 30.0) -> dict:
    """Read a daemon's one-line JSON readiness handshake with a timeout.
    stdout carries exactly that one line; stderr goes to ``log_path``
    (a pipe would eventually fill and block a chatty daemon), which is
    tail-quoted when the daemon dies before becoming ready."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            tail = ""
            try:
                with open(log_path) as f:
                    lines = f.read().strip().splitlines()
                    tail = lines[-1] if lines else ""
            except OSError:
                pass
            raise SystemExit(
                f"{what} exited (code {proc.returncode}) before becoming "
                f"ready{': ' + tail if tail else ''} (log: {log_path})"
            )
        r, _, _ = select.select([proc.stdout], [], [], 0.2)
        if r:
            line = proc.stdout.readline().strip()
            if line:
                try:
                    return json.loads(line)
                except json.JSONDecodeError:
                    continue  # stray log line on stdout
    proc.terminate()
    raise SystemExit(f"{what} did not become ready within {timeout:.0f}s")


def _daemon_log(kind: str) -> str:
    os.makedirs(_PID_DIR, exist_ok=True)
    return os.path.join(_PID_DIR, f"{kind}-{os.getpid()}-{int(time.time())}.log")


def _connect(address: str):
    """Driver-less controller client for status/list commands."""
    import ray_tpu_torch

    ray_tpu_torch.init(address=address, namespace="cli")
    from ray_tpu_torch.core.api import _global_worker

    return _global_worker().backend


def cmd_start(args) -> int:
    if args.head:
        cmd = [
            sys.executable, "-m", "ray_tpu_torch.core.head_main",
            "--session-dir", args.session_dir
            or f"{TMP_ROOT}/session_cli_{os.getpid()}",
        ]
        if args.num_cpus is not None:
            cmd += ["--num-cpus", str(args.num_cpus)]
        if args.resources:
            cmd += ["--resources", args.resources]
        log_path = _daemon_log("head")
        with open(log_path, "ab") as logf:
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=logf, text=True
            )
        info = _read_ready_line(proc, "head", log_path)
        _record_pid("head", proc.pid)
        # full driver address is host:controller_port:daemon_port
        addr = f"127.0.0.1:{info['controller_port']}:{info['daemon_port']}"
        print(f"ray_tpu_torch head started (pid {proc.pid})")
        print(f"  address: {addr}")
        print(f"  connect: ray_tpu_torch.init(address={addr!r})")
        print(f"  add a node: python -m ray_tpu_torch.scripts start --address {addr}")
        return 0
    if not args.address:
        print("start needs --head or --address HOST:PORT", file=sys.stderr)
        return 2
    parts = args.address.split(":")
    controller = ":".join(parts[:2])  # node daemons join the controller
    cmd = [
        sys.executable, "-m", "ray_tpu_torch.core.node_main",
        "--controller", controller,
    ]
    if args.num_cpus is not None:
        cmd += ["--num-cpus", str(args.num_cpus)]
    if args.resources:
        cmd += ["--resources", args.resources]
    log_path = _daemon_log("node")
    with open(log_path, "ab") as logf:
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=logf, text=True
        )
    info = _read_ready_line(proc, "node daemon", log_path)
    _record_pid("node", proc.pid)
    print(
        f"ray_tpu_torch node daemon started (pid {proc.pid}, "
        f"node {info.get('node_id', '?')[:12]}) -> {args.address}"
    )
    return 0


def cmd_stop(args) -> int:
    stopped = 0
    if os.path.isdir(_PID_DIR):
        for name in os.listdir(_PID_DIR):
            if not name.endswith(".pid"):
                continue
            path = os.path.join(_PID_DIR, name)
            try:
                with open(path) as f:
                    pid = int(f.read().strip())
                # never kill a reused PID: verify it is still one of the
                # port's daemons (reference CLI checks cmdline the same way);
                # "ray_tpu" alone would match the JAX package's daemons too
                with open(f"/proc/{pid}/cmdline", "rb") as c:
                    cmdline = c.read().replace(b"\0", b" ")
                if b"ray_tpu_torch.core." in cmdline:
                    os.kill(pid, signal.SIGTERM)
                    stopped += 1
            except (OSError, ValueError):
                pass
            try:
                os.remove(path)
            except OSError:
                pass
    print(f"stopped {stopped} daemon(s)")
    return 0


def cmd_status(args) -> int:
    core = _connect(args.address)
    total = core.cluster_resources()
    avail = core.available_resources()
    nodes = core.nodes()
    print(f"cluster: {len(nodes)} node(s)")
    for n in nodes:
        state = "ALIVE" if n["Alive"] else "DEAD"
        print(f"  {n['NodeID'][:12]} {state} {n['host']}:{n['port']} {n['Resources']}")
    print("resources:")
    for k in sorted(total):
        print(f"  {k}: {avail.get(k, 0):g}/{total[k]:g} available")
    return 0


def cmd_list(args) -> int:
    _connect(args.address)
    from ray_tpu_torch.util import state

    fetch = {
        "nodes": state.list_nodes,
        "actors": state.list_actors,
        "tasks": state.list_tasks,
        "objects": state.list_objects,
        "pgs": state.list_placement_groups,
    }[args.what]
    rows = fetch()
    print(json.dumps(rows, indent=1, default=repr))
    print(f"({len(rows)} {args.what})", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ray_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("start", help="start a head or worker-node daemon")
    sp.add_argument("--head", action="store_true")
    sp.add_argument("--address", help="head address for worker nodes")
    sp.add_argument("--num-cpus", type=float, default=None)
    sp.add_argument("--resources", help="JSON resource dict")
    sp.add_argument("--session-dir")
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("stop", help="stop daemons started by this CLI")
    sp.set_defaults(fn=cmd_stop)

    sp = sub.add_parser("status", help="cluster nodes + resources")
    sp.add_argument("--address", required=True)
    sp.set_defaults(fn=cmd_status)

    sp = sub.add_parser("list", help="state API listings")
    sp.add_argument("what", choices=["nodes", "actors", "tasks", "objects", "pgs"])
    sp.add_argument("--address", required=True)
    sp.set_defaults(fn=cmd_list)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
