"""``tests/test_stream_resume_tier.py`` against the port: a SIGKILL
mid-decode resumed by tier fault-in, through a two-replica
``kv_tier=True`` deployment (loaded and renamed by
``tests/_torch_suites.py``). Its armed-tier-chaos case stays ``slow``, as
in the reference. ``test_torch_disagg.py`` keeps its own tier E2E, which
holds the port's copy of the same path on a cluster shared with the
disaggregated deployment; this file runs the reference's case statement
for statement.

Statements that differ from the reference, and why:

* the import gate asks for torch where the reference asks for JAX, and
  ``import jax`` is gone: the port's engine needs torch, not JAX;
* the ``params`` fixture builds the port's ``init_params(cfg, 0,
  device="cpu")``: the port's params come from an integer seed on a
  named device, not from a JAX key;
* the cluster fixture binds the deployment with ``device="cpu"``: a port
  replica serves on ``cuda`` unless told otherwise.

The cluster's processes run with one OpenMP thread (``one_thread``).
"""

from _torch_suites import load

EDITS = (
    (
        'pytest.importorskip("jax")\n\nimport jax  # noqa: E402\n',
        'pytest.importorskip("torch")\n',
        "the port's engine needs torch, not JAX",
    ),
    (
        "return init_params(cfg, jax.random.PRNGKey(0))",
        'return init_params(cfg, 0, device="cpu")',
        "the port's params come from an integer seed on a named device",
    ),
    (
        "handle = serve.run(dep.bind())",
        'handle = serve.run(dep.bind(device="cpu"))',
        "a port replica serves on cuda unless told otherwise",
    ),
)

load(globals(), "stream_resume_tier", edits=EDITS, one_thread=True)


def test_wait_status_counts_a_death_before_the_call(tier_cluster):
    """The port's own case: a replica SIGKILLed just before
    ``wait_status(min_replicas=2)`` is counted dead and replaced before the
    wait returns, not reported as routed until the controller's next pass
    (the race the reference's case above meets when the resumed streams
    end within a pass of the kill)."""
    import os
    import signal

    before = ray_tpu_torch.get(_controller().status.remote(), timeout=60)["llmtier"]
    victim = _replicas()[0]
    os.kill(_replica_call(victim, "testing_device_info")["pid"], signal.SIGKILL)
    st = ray_tpu_torch.get(
        _controller().wait_status.remote("llmtier", min_replicas=2, timeout_s=120),
        timeout=150,
    )
    assert st["replicas"] == 2, st
    assert st["restarts"]["death"] == before["restarts"]["death"] + 1, (before, st)
    assert victim.actor_id not in {r.actor_id for r in _replicas()}
