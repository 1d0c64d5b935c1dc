"""``tests/test_ingress_chaos.py``, both cases, against the port's front
door under a seeded replica kill and an ingress replica restart (loaded
and renamed by ``tests/_torch_suites.py``).

Statements that differ from the reference, and why:

* the import gate asks for torch where the reference asks for JAX, and
  ``import jax`` is gone: the port's engine needs torch, not JAX;
* the ``params`` fixture builds the port's ``init_params(cfg, 0,
  device="cpu")``: the port's params come from an integer seed on a
  named device, not from a JAX key;
* ``_run_llm_and_ingress`` binds the LLM deployment with
  ``device="cpu"``: a port replica serves on ``cuda`` unless told
  otherwise.

``from conftest import _chaos_repro_line`` stays as it is: conftest's
line reads the ``RAY_TPU_testing_*`` environment the case exports, and
the port's processes read the plan from the same variables.

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

load(globals(), "ingress_chaos", edits=EDITS, one_thread=True)
