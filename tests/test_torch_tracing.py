"""``tests/test_tracing.py``, all 9 cases, against the port's tracing and
timeline (loaded and renamed by ``tests/_torch_suites.py``).

Statements that differ from the reference, and why:

* ``test_e2e_llm_serve_and_nested_chain_traces`` needs torch where the
  reference needs JAX, and binds its LLM deployment with
  ``device="cpu"``: the port's replica serves on ``cuda`` unless told
  otherwise, and this box has no card.
"""

from _torch_suites import load

EDITS = (
    (
        """    pytest.importorskip("jax")
    from ray_tpu import serve""",
        """    pytest.importorskip("torch")
    from ray_tpu import serve""",
        "the port's engine needs torch, not JAX",
    ),
    (
        "handle = serve.run(dep.bind())",
        'handle = serve.run(dep.bind(device="cpu"))',
        "the port's replica serves on cuda unless told otherwise",
    ),
)

load(globals(), "tracing", edits=EDITS)
