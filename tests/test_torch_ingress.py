"""``tests/test_ingress.py``, all 7 cases, against the port's HTTP/SSE
front door (loaded and renamed by ``tests/_torch_suites.py``).

Statements that differ from the reference, and why:

* the import gate asks for torch where the reference asks for JAX, and
  ``import jax`` is gone: the port's engine needs torch, not JAX;
* the ``params`` fixture builds the port's ``init_params(cfg, 0,
  device="cpu")``: the port's params come from an integer seed on a
  named device (``cuda`` unless told otherwise), not from a JAX key.
  A replica seeded with 0 builds the same params, which is what the
  byte-exact gate compares against;
* ``_run_llm_and_ingress`` binds the LLM deployment with
  ``device="cpu"``: a port replica serves on ``cuda`` unless told
  otherwise.

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

load(globals(), "ingress", edits=EDITS, one_thread=True)
