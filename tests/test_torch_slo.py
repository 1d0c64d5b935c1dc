"""``tests/test_slo.py``, all 7 cases, against the port's SLO accounting
(loaded and renamed by ``tests/_torch_suites.py``).

Statements that differ from the reference, and why:

* ``test_engine_ledger_books_and_stage_breakdown`` needs torch where the
  reference needs JAX, and builds its params with the port's
  ``init_params(cfg, 0, device="cpu")``: the port's params come from an
  integer seed on a named device (``cuda`` unless told otherwise), not
  from a JAX key.
"""

from _torch_suites import load

EDITS = (
    (
        'jax = pytest.importorskip("jax")',
        'pytest.importorskip("torch")',
        "the port's engine needs torch, not JAX",
    ),
    (
        "params = init_params(cfg, jax.random.PRNGKey(0))",
        'params = init_params(cfg, 0, device="cpu")',
        "the port's params come from an integer seed on a named device",
    ),
)

load(globals(), "slo", edits=EDITS)
