"""``tests/test_dag.py``, all 12 cases, against the port's ``dag/`` on the
port's own cluster (loaded and renamed by ``tests/_torch_suites.py``), and
two cases of the port's own: an actor called before a graph is compiled
on it still answers after the teardown, and a ``__ray_ready__`` call
between two plain calls keeps the caller's order.

Statements that differ from the reference, and why:

* ``Stage.load`` makes a torch tensor where the reference makes a JAX
  array: the port's actors hold torch tensors.
* ``Stage.reduce`` holds the value by identity (``arr is self.loaded``)
  where the reference arms JAX's device-to-host transfer guard: torch has
  no such guard, and identity is what passing by reference means.
"""

import ray_tpu_torch
from _torch_suites import load

EDITS = (
    (
        """            import jax.numpy as jnp

            return jnp.asarray(np.asarray(x, np.float32)) * 2
""",
        """            import torch

            self.loaded = torch.as_tensor(np.asarray(x, np.float32)) * 2
            return self.loaded
""",
        "the actor holds a torch tensor, not a JAX array",
    ),
    (
        """            import jax

            with jax.transfer_guard_device_to_host("disallow"):
                doubled = arr + 1
""",
        """            assert arr is self.loaded
            doubled = arr + 1
""",
        "passing by reference is identity; torch has no transfer guard",
    ),
)

load(globals(), "dag", edits=EDITS)  # defines the suite's Echo, InputNode and cluster


def test_actor_called_before_compile_answers_after_teardown(cluster):
    """An actor that ran a plain call before a graph was compiled on it
    answers plain calls after the teardown, and takes a second graph.
    The compiled loop is a call of the handle like any other: it takes the
    caller's turn, or the calls after it wait on a turn that never comes."""
    a = Echo.remote()
    assert ray_tpu_torch.get(a.double.remote(1), timeout=30) == 2
    for k in (2, 3):
        with InputNode() as inp:
            dag = a.double.bind(inp)
        compiled = dag.experimental_compile()
        try:
            assert compiled.execute(k).get(timeout=30) == 2 * k
        finally:
            compiled.teardown()
        assert ray_tpu_torch.get(a.double.remote(7), timeout=30) == 14


def test_ready_call_keeps_the_callers_order(cluster):
    """``__ray_ready__`` between two plain calls of a handle takes its turn
    too: the call after it runs."""
    a = Echo.remote()
    assert ray_tpu_torch.get(a.double.remote(1), timeout=30) == 2
    assert ray_tpu_torch.get(a.__ray_ready__(), timeout=30) is True
    assert ray_tpu_torch.get(a.double.remote(2), timeout=30) == 4
